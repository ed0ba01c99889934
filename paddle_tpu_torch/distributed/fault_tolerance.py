"""Cooperative preemption (the port of ``PreemptionHandler`` from
``paddle_tpu/distributed/fault_tolerance.py``).

A scheduler that preempts a job sends SIGTERM first.  The handler sets a
flag the job checks between steps and runs the callbacks registered with
:meth:`PreemptionHandler.on_preemption` (``GenerationServer.
attach_preemption`` registers its drain there).  ``ELASTIC_EXIT_CODE`` is
the exit code an elastic launcher relaunches on.  The checkpoint helpers
of the JAX module (``save_checkpoint``, ``run_with_resume``) are not
ported yet.
"""
from __future__ import annotations

import signal
import threading
import warnings
from typing import Callable, List

from .. import monitor

#: the exit code an elastic launcher relaunches on (the JAX package's
#: ``fleet.elastic.manager.ELASTIC_EXIT_CODE``)
ELASTIC_EXIT_CODE = 101

_preemptions_total = monitor.counter(
    "preemptions_total", "preemption signals received")
_cb_errors_total = monitor.counter(
    "preemption_callback_errors_total",
    "preemption callbacks that raised (a failed drain or checkpoint "
    "hook must be visible)")

__all__ = ["ELASTIC_EXIT_CODE", "PreemptionHandler"]


class PreemptionHandler:
    """Installs handlers for ``signals`` (SIGTERM by default) that set a
    flag checked between steps and run the registered callbacks, each
    once a signal.  ``signals=()`` installs nothing: a test delivers the
    notice by calling ``_on_signal`` itself."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._event = threading.Event()
        self._callbacks: List[Callable[[], None]] = []
        self._prev = {}
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame):
        self._event.set()
        _preemptions_total.inc()
        for cb in self._callbacks:
            try:
                cb()
            except Exception as e:  # noqa: BLE001 — one bad callback must
                # not starve the others, and must not vanish either
                _cb_errors_total.inc()
                name = getattr(cb, "__qualname__",
                               getattr(cb, "__name__", repr(cb)))
                warnings.warn(
                    f"preemption callback {name} raised {e!r}; "
                    "continuing with remaining callbacks")

    def on_preemption(self, cb: Callable[[], None]) -> None:
        self._callbacks.append(cb)

    def preempted(self) -> bool:
        return self._event.is_set()

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False
