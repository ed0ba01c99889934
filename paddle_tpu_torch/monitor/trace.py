"""Request-level tracing and the engine step timeline (a copy of
paddle_tpu/monitor/trace.py).

The metrics registry answers "how is serving doing on average"; this
module answers "where did this request's time go" (queue wait, each
prefill chunk, every decode or verify step it rode, a preemption, a
survivor replay) and "what did the engine do each step" (batch
composition by class, chunk tokens, speculative economics, dispatch
wall time).

Design constraints, as in the JAX package:

  * **off by default, about free when off**: every record call starts
    with a plain attribute read (``tracer.enabled``); outside a capture
    window the serving hot path pays one predictable branch a probe;
  * **bounded**: per-request timelines cap their event count, the request
    table caps its size (oldest evicted), and the engine-step ring is a
    fixed ``deque``; overflow counts in ``trace_dropped_events_total``
    instead of growing;
  * **one clock**: timestamps are ``time.perf_counter_ns()``, the clock
    the host recorder stamps ``HostEvent``s with, so
    ``export_chrome_trace`` merges span events onto the request and step
    tracks without skew arithmetic;
  * **stdlib only**.

Usage::

    from paddle_tpu_torch import monitor
    monitor.start_capture()            # opens the window
    ... serve traffic ...
    monitor.stop_capture()
    payload = monitor.export_chrome_trace("trace.json")  # Perfetto/chrome
    monitor.request_timeline("req-abc")  # one request's event list
"""
from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from .registry import counter, gauge

__all__ = [
    "Tracer", "get_tracer", "start_capture", "stop_capture",
    "request_timeline", "export_chrome_trace", "validate_chrome_trace",
]

# capture telemetry, materialized at import so the series exist in
# monitor.snapshot() before the first window
_captures_total = counter(
    "trace_captures_total", "capture windows opened via start_capture()")
_events_total = counter(
    "trace_events_total", "request/step trace events recorded inside "
    "capture windows")
_dropped_total = counter(
    "trace_dropped_events_total", "trace events dropped by the bounded "
    "buffers (per-request event cap, request-table cap)")
_active_g = gauge(
    "trace_capture_active", "1 while a trace capture window is open")
_captures_total.inc(0)
_events_total.inc(0)
_dropped_total.inc(0)
_active_g.set(0)

#: event kinds that tie a request's lifecycle to an engine-step track
#: entry, exported as chrome flow events (request track -> step track)
_FLOW_KINDS = frozenset({"prefill_chunk", "decode_step", "verify_step"})


class _Timeline:
    """One request's bounded event list: (ts_ns, kind, detail)."""

    __slots__ = ("request_id", "events", "dropped")

    def __init__(self, request_id: str):
        self.request_id = request_id
        self.events: List[Tuple[int, str, Optional[dict]]] = []
        self.dropped = 0

    def to_dict(self) -> dict:
        return {
            "request_id": self.request_id,
            "dropped_events": self.dropped,
            "events": [
                {"ts_ns": ts, "kind": kind, **({} if not d else d)}
                for ts, kind, d in self.events],
        }


class Tracer:
    """The process-wide trace buffer: per-request timelines + the
    engine-step ring.  All mutation is behind one small lock; the
    disabled fast path is a single attribute read."""

    def __init__(self):
        self.enabled = False              # the hot-path gate (plain read)
        self._lock = threading.Lock()
        self._requests: "OrderedDict[str, _Timeline]" = OrderedDict()
        self._steps: deque = deque(maxlen=2048)
        self._max_requests = 256
        self._max_events_per_request = 512
        self._host_events: List = []
        self._rec_enabled_here = False
        self._started_ns = 0
        self._stopped_ns = 0

    # ------------------------------------------------------------- window
    @staticmethod
    def now_ns() -> int:
        return time.perf_counter_ns()

    def start_capture(self, max_requests: int = 256,
                      max_events_per_request: int = 512,
                      max_steps: int = 2048,
                      host_events: bool = True) -> None:
        """Open a capture window (drops any previous buffer).  With
        ``host_events`` the host recorder is enabled for the window too:
        ``monitor.span`` probes (engine/prefill, engine/decode_step,
        engine/ragged_step, engine/recovery) then land on the exported
        timeline next to the request and step tracks.  A recorder that
        is already enabled is left alone (its events are not taken)."""
        from ..profiler.record import get_recorder
        with self._lock:
            if self.enabled:
                # a re-entrant start keeps the open window rather than
                # clobber _rec_enabled_here: losing that flag would leave
                # the host recorder enabled (and unbounded) forever
                return
            self._requests = OrderedDict()
            self._steps = deque(maxlen=int(max_steps))
            self._max_requests = int(max_requests)
            self._max_events_per_request = int(max_events_per_request)
            self._host_events = []
            self._started_ns = self.now_ns()
            self._stopped_ns = 0
            rec = get_recorder()
            self._rec_enabled_here = host_events and not rec.enabled
            if self._rec_enabled_here:
                rec.collect()            # drop stale pre-window events
                rec.enable(True)
            self.enabled = True
        _captures_total.inc()
        _active_g.set(1)

    def stop_capture(self) -> None:
        """Close the window.  The buffer stays readable (export /
        timeline queries) until the next ``start_capture``."""
        from ..profiler.record import get_recorder
        with self._lock:
            if not self.enabled:
                return
            self.enabled = False
            self._stopped_ns = self.now_ns()
            if self._rec_enabled_here:
                rec = get_recorder()
                self._host_events = rec.collect()
                rec.enable(False)
                self._rec_enabled_here = False
        _active_g.set(0)

    # ------------------------------------------------------------- record
    def request_event(self, request_id: Optional[str], kind: str,
                      **detail) -> None:
        """Append one event to a request's timeline (no-op outside a
        capture window or for id-less requests)."""
        if not self.enabled or request_id is None:
            return
        ts = self.now_ns()
        with self._lock:
            tl = self._requests.get(request_id)
            if tl is None:
                if len(self._requests) >= self._max_requests:
                    self._requests.popitem(last=False)
                    _dropped_total.inc()
                tl = self._requests[request_id] = _Timeline(request_id)
            if len(tl.events) >= self._max_events_per_request:
                tl.dropped += 1
                _dropped_total.inc()
                return
            tl.events.append((ts, kind, detail or None))
        _events_total.inc()

    def step_record(self, kind: str, index: int, start_ns: int,
                    end_ns: int, **data) -> None:
        """Append one engine-step record to the bounded ring."""
        if not self.enabled:
            return
        with self._lock:
            self._steps.append((kind, int(index), int(start_ns),
                                int(end_ns), data or None))
        _events_total.inc()

    # -------------------------------------------------------------- query
    def request_timeline(self, request_id: str) -> Optional[dict]:
        with self._lock:
            tl = self._requests.get(request_id)
            return None if tl is None else tl.to_dict()

    def request_ids(self) -> List[str]:
        with self._lock:
            return list(self._requests)

    def step_records(self) -> List[dict]:
        with self._lock:
            steps = list(self._steps)
        return [{"kind": k, "index": i, "start_ns": s, "end_ns": e,
                 **({} if not d else d)} for k, i, s, e, d in steps]

    # ------------------------------------------------------------- export
    def to_chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON: the engine-step track (pid 1),
        one track per request (pid 2, flow-linked to the step track at
        every chunk/decode/verify participation), and the window's
        profiler ``HostEvent`` spans (pid 3) — all on one clock."""
        with self._lock:
            steps = list(self._steps)
            timelines = list(self._requests.values())
            host = list(self._host_events)
        ev: List[dict] = []

        def meta(pid, name):
            ev.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "ts": 0.0, "args": {"name": name}})

        meta(1, "engine steps")
        meta(2, "requests")
        meta(3, "host spans")
        for kind, idx, s_ns, e_ns, data in steps:
            ev.append({
                "name": kind, "ph": "X", "cat": "engine", "pid": 1,
                "tid": 0, "ts": s_ns / 1e3,
                "dur": max(0, e_ns - s_ns) / 1e3,
                "args": {"step": idx, **(data or {})}})
        flow_id = 1
        for tid, tl in enumerate(timelines, start=1):
            if not tl.events:
                continue
            first_ts = tl.events[0][0]
            last_ts = tl.events[-1][0]
            name = f"request {tl.request_id}"
            ev.append({"name": name, "ph": "B", "cat": "request",
                       "pid": 2, "tid": tid, "ts": first_ts / 1e3,
                       "args": {"request_id": tl.request_id}})
            for ts, kind, detail in tl.events:
                ev.append({"name": kind, "ph": "i", "s": "t",
                           "cat": "request", "pid": 2, "tid": tid,
                           "ts": ts / 1e3, "args": detail or {}})
                if kind in _FLOW_KINDS:
                    # flow: request lifecycle -> the engine-step track
                    ev.append({"name": "engine-step", "ph": "s",
                               "cat": "flow", "id": flow_id, "pid": 2,
                               "tid": tid, "ts": ts / 1e3})
                    ev.append({"name": "engine-step", "ph": "f",
                               "bp": "e", "cat": "flow", "id": flow_id,
                               "pid": 1, "tid": 0, "ts": ts / 1e3})
                    flow_id += 1
            ev.append({"name": name, "ph": "E", "cat": "request",
                       "pid": 2, "tid": tid, "ts": last_ts / 1e3})
        for e in host:
            ev.append({"name": e.name, "ph": "X", "cat": "host",
                       "pid": 3, "tid": e.tid % (1 << 31),
                       "ts": e.start_ns / 1e3,
                       "dur": max(0, e.end_ns - e.start_ns) / 1e3})
        # stable ts sort: equal-ts events keep insertion order, so each
        # request's B precedes its instants precedes its E
        ev.sort(key=lambda e: e["ts"])
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {
                    "generator": "paddle_tpu_torch.monitor.trace",
                    "capture_start_ns": self._started_ns,
                    "capture_stop_ns": self._stopped_ns}}


def validate_chrome_trace(payload) -> List[str]:
    """Best-effort trace-event-schema check: JSON-ability, required keys
    per event,
    non-decreasing ``ts``, and matched B/E pairs per (pid, tid) stack.
    Returns a list of problems (empty = valid)."""
    problems: List[str] = []
    try:
        payload = json.loads(json.dumps(payload))
    except (TypeError, ValueError) as e:
        return [f"not JSON-serializable: {e}"]
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts = None
    stacks: Dict[Tuple[int, int], List[str]] = {}
    for i, e in enumerate(events):
        for key in ("ph", "ts", "pid", "tid"):
            if key not in e:
                problems.append(f"event {i} missing {key!r}: {e}")
                break
        else:
            if "name" not in e and e["ph"] not in ("s", "t", "f"):
                problems.append(f"event {i} missing 'name': {e}")
            ts = e["ts"]
            if last_ts is not None and ts < last_ts:
                problems.append(
                    f"event {i} ts {ts} < previous {last_ts} — "
                    "timestamps must be non-decreasing")
            last_ts = ts
            key = (e["pid"], e["tid"])
            if e["ph"] == "B":
                stacks.setdefault(key, []).append(e.get("name", ""))
            elif e["ph"] == "E":
                stack = stacks.get(key)
                if not stack:
                    problems.append(
                        f"event {i}: E with no open B on track {key}")
                else:
                    stack.pop()
            elif e["ph"] == "X" and "dur" not in e:
                problems.append(f"event {i}: X event missing 'dur'")
    for key, stack in stacks.items():
        if stack:
            problems.append(f"unclosed B event(s) {stack} on track {key}")
    return problems


_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def start_capture(**kwargs) -> None:
    _tracer.start_capture(**kwargs)


def stop_capture() -> None:
    _tracer.stop_capture()


def request_timeline(request_id: str) -> Optional[dict]:
    return _tracer.request_timeline(request_id)


def export_chrome_trace(path: Optional[str] = None) -> dict:
    """The capture buffer as chrome-trace JSON; optionally written to
    ``path`` (load it in Perfetto / chrome://tracing)."""
    payload = _tracer.to_chrome_trace()
    if path:
        with open(path, "w") as f:
            json.dump(payload, f)
    return payload
