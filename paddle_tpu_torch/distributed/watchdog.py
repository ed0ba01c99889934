"""Watchdog: a background thread that scans liveness probes and flags the
ones in flight for too long (port of the heartbeat half of
paddle_tpu/distributed/watchdog.py ``CommTaskManager``).

A probe is an ``age_fn`` that returns how many seconds the probed work
has been in flight, or None while it is idle.  When a scan finds the age
past the probe's timeout it warns, counts the excursion in
``timeouts`` and calls the probe's ``on_timeout`` from the watchdog
thread; the probe fires once an excursion and re-arms once it reports
healthy again.  The serving engine registers its step heartbeat here
(``ContinuousBatchingEngine(step_timeout_s=...)``): a step that runs past
the timeout is flagged as wedged, and the engine rebuilds its pools and
replays the survivors when the step returns.

The class keeps the JAX package's name and method names, so the
comm-task half (``begin``, ``end``, ``comm_guard`` over eager
collectives) can join it with the port of ``distributed/``.  Each scan
feeds the JAX package's four ``comm_*`` series in the monitor registry
(no comm task is registered yet, so ``comm_tasks_in_flight`` and
``comm_oldest_task_age_seconds`` read 0); the attribute ``timeouts``
counts this manager's excursions beside the process-wide
``comm_timeouts_total``.  The abort flag is not ported: a timeout warns
and never ends the process.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

from .. import monitor

# the watchdog's series: a scraper can tell a dead watchdog from a quiet
# one (the heartbeat timestamp), see the tasks in flight and the oldest
# one's age, and count the timeouts fired over the process's life
_tasks_in_flight = monitor.gauge(
    "comm_tasks_in_flight", "host collectives currently registered")
_oldest_task_age = monitor.gauge(
    "comm_oldest_task_age_seconds", "age of the oldest in-flight task")
_heartbeat_ts = monitor.gauge(
    "comm_watchdog_heartbeat_timestamp_seconds",
    "unix time of the watchdog's last scan")
_timeouts_total = monitor.counter(
    "comm_timeouts_total", "collectives flagged as timed out")

__all__ = ["CommTaskManager"]


class CommTaskManager:
    """Background scanner over registered liveness probes (one process-wide
    instance, :meth:`instance`)."""

    _instance: Optional["CommTaskManager"] = None
    _instance_lock = threading.Lock()

    def __init__(self, scan_interval: float = 1.0):
        self._lock = threading.Lock()
        self._seq = 0
        self._scan_interval = scan_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # handle -> (name, age_fn, timeout, on_timeout); a handle in
        # _hb_flagged has fired for its current excursion
        self._heartbeats: Dict[int, tuple] = {}
        self._hb_flagged: set = set()
        #: excursions flagged over the manager's life
        self.timeouts = 0

    @classmethod
    def instance(cls) -> "CommTaskManager":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = CommTaskManager()
            return cls._instance

    def start(self) -> None:
        """Start the scan thread (a daemon); a no-op while it runs."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._scan_loop,
                                            name="comm-watchdog",
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Stop the scan thread (registered probes stay registered)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self._scan_interval)
            self._thread = None

    def register_heartbeat(self, name: str,
                           age_fn: Callable[[], Optional[float]],
                           timeout: float,
                           on_timeout: Optional[Callable[[], None]] = None
                           ) -> int:
        """Register a liveness probe: ``age_fn() -> seconds`` the probed
        work has been in flight (None: idle, never flagged).  When a scan
        finds the age past ``timeout`` it warns, counts ``timeouts`` and
        calls ``on_timeout()`` (if given) from the scanning thread, once
        an excursion.  Returns the handle for
        :meth:`unregister_heartbeat`."""
        with self._lock:
            self._seq += 1
            hid = self._seq
            self._heartbeats[hid] = (name, age_fn, float(timeout),
                                     on_timeout)
        return hid

    def unregister_heartbeat(self, hid: int) -> None:
        with self._lock:
            self._heartbeats.pop(hid, None)
            self._hb_flagged.discard(hid)

    def heartbeat_names(self) -> List[str]:
        """Names of every registered probe: a stopped component must
        leave none behind, or it would be flagged as a corpse."""
        with self._lock:
            return [name for name, _, _, _ in self._heartbeats.values()]

    def _scan_loop(self) -> None:
        while not self._stop.wait(self._scan_interval):
            self.scan_once()

    def scan_once(self) -> None:
        """One scan pass (the loop's body), public so tests can scan
        deterministically: flag each probe whose age is past its
        timeout, once an excursion, and re-arm each healthy one.  A
        probe or a reaction that raises is skipped: it must not stop the
        scan."""
        with self._lock:
            beats = list(self._heartbeats.items())
        _tasks_in_flight.set(0)
        _oldest_task_age.set(0.0)
        fired = []
        for hid, (name, age_fn, timeout, on_timeout) in beats:
            try:
                age = age_fn()
            except Exception:  # noqa: BLE001 — a probe must not kill it
                continue
            if age is not None and age > timeout:
                with self._lock:
                    fire = hid not in self._hb_flagged \
                        and hid in self._heartbeats
                    if fire:
                        self._hb_flagged.add(hid)
                if fire:
                    fired.append((name, timeout, age))
                    if on_timeout is not None:
                        try:
                            on_timeout()
                        except Exception:  # noqa: BLE001 — nor a reactor
                            pass
            else:
                with self._lock:
                    self._hb_flagged.discard(hid)
        _heartbeat_ts.set(time.time())
        for name, timeout, age in fired:
            self._on_timeout(name, timeout, age)

    def _on_timeout(self, name: str, timeout: float, age: float) -> None:
        with self._lock:
            self.timeouts += 1
        _timeouts_total.inc()
        warnings.warn(
            f"[comm-watchdog] '{name}' on thread "
            f"{threading.current_thread().name} exceeded {timeout:.3f}s "
            f"(in flight for {age:.3f}s)")
