"""Host event recording: ``RecordEvent`` spans and the process-wide
recorder (the Python half of paddle_tpu/profiler/record.py).

The recorder keeps (name, thread, start, end) events on
``time.perf_counter_ns()`` while it is enabled and drops pushes while it
is not.  ``monitor.span`` and the tracer's capture window push here, so
host spans land on the exported chrome trace beside the request and step
tracks.  The JAX package's native C++ recorder is not ported: this one
is the Python recorder, which the JAX package falls back to when no
toolchain is available.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import List, NamedTuple

__all__ = ["HostEvent", "get_recorder", "RecordEvent", "record_function"]


class HostEvent(NamedTuple):
    name: str
    tid: int
    start_ns: int
    end_ns: int


class _PyRecorder:
    """Thread-safe event list (one lock a push)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[HostEvent] = []
        self.enabled = False

    def enable(self, on: bool) -> None:
        self.enabled = on

    def now_ns(self) -> int:
        return time.perf_counter_ns()

    def push(self, name: str, start_ns: int, end_ns: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._events.append(
                HostEvent(name, threading.get_ident(), start_ns, end_ns))

    def collect(self) -> List[HostEvent]:
        """Every event pushed since the last collect (the list empties)."""
        with self._lock:
            out, self._events = self._events, []
        return out


_recorder = _PyRecorder()


def get_recorder() -> _PyRecorder:
    """The process-wide host recorder."""
    return _recorder


class RecordEvent:
    """User span: ``with RecordEvent("io"): ...``.  Records only while the
    recorder is enabled (a profiler window or a trace capture)."""

    def __init__(self, name: str, event_type: str = "UserDefined"):
        self.name = name
        self.event_type = event_type
        self._start = None

    def begin(self):
        self._start = _recorder.now_ns()

    def end(self):
        if self._start is None:
            return
        _recorder.push(self.name, self._start, _recorder.now_ns())
        self._start = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with RecordEvent(self.name, self.event_type):
                return func(*args, **kwargs)
        return wrapper


def record_function(name: str) -> RecordEvent:
    return RecordEvent(name)
