"""Span tracing bridging the metrics registry and the profiler's host
recorder (a copy of paddle_tpu/monitor/span.py).

A ``span`` times a block once and fans the measurement out to both
consumers: a Histogram observation (always, metrics are unconditional)
and a profiler ``HostEvent`` (only while the recorder is enabled, by a
trace capture window or a profiler: the push is a no-op otherwise, as
``RecordEvent``'s in profiler/record.py).
"""
from __future__ import annotations

import functools
import time
from typing import Optional

from ..profiler.record import get_recorder
from .registry import Histogram

__all__ = ["span"]


class span:
    """``with span("engine/decode_step", histogram=h):``

    Times the block; observes elapsed seconds into ``histogram`` (with
    the given labels) and records a host event named ``name`` for the
    profiler timeline.  Usable as a decorator.  ``elapsed`` holds the
    measured seconds after exit.
    """

    __slots__ = ("name", "histogram", "labels", "elapsed",
                 "_t0", "_start_ns")

    def __init__(self, name: str, histogram: Optional[Histogram] = None,
                 **labels):
        self.name = name
        self.histogram = histogram
        self.labels = labels
        self.elapsed: Optional[float] = None
        self._t0 = None
        self._start_ns = None

    def __enter__(self):
        rec = get_recorder()
        if rec.enabled:
            self._start_ns = rec.now_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.histogram is not None:
            self.histogram.observe(self.elapsed, **self.labels)
        if self._start_ns is not None:
            rec = get_recorder()
            rec.push(self.name, self._start_ns, rec.now_ns())
            self._start_ns = None
        return False

    def __call__(self, fn):
        """Decorator form.  Each call times through a fresh inner span
        (name, histogram and labels resolved once, here) and the
        measurement is copied back to this instance's ``elapsed``, so a
        test can read the decorator it holds.  Per-call inner spans keep
        re-entrant and concurrent calls from clobbering each other's
        timers."""
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            inner = span(self.name, self.histogram, **self.labels)
            try:
                with inner:
                    return fn(*args, **kwargs)
            finally:
                self.elapsed = inner.elapsed
        return wrapper
