"""Process-wide metrics registry: Counter / Gauge / Histogram (a copy of
paddle_tpu/monitor/registry.py, which the port may not import).

Design constraints, as in the JAX package:
  * zero dependencies: stdlib only;
  * thread-safe: the serving engine observes from its scheduler thread
    while callers read from theirs;
  * histograms use fixed log-scale buckets, so merging or diffing
    snapshots across runs never has to re-bucket.

Exposition is dual: ``snapshot()`` (a JSON-able dict) and
``prometheus_text()`` (text exposition format 0.0.4).  The port's
registry is its own: a process that imports both packages keeps two.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "get_registry",
    "counter", "gauge", "histogram", "snapshot", "prometheus_text",
    "dump", "dump_on_exit", "DEFAULT_LATENCY_BUCKETS", "BYTES_BUCKETS",
]

# ~1us .. ~34s in powers of two: latency from a single dispatch to a
# wedged collective, 26 buckets
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    2.0 ** e for e in range(-20, 6))
# 1B .. ~1GiB in powers of four: collective payload sizes
BYTES_BUCKETS: Tuple[float, ...] = tuple(4.0 ** e for e in range(16))


def _check_labels(label_names: Tuple[str, ...], labels: Dict[str, str]
                  ) -> Tuple[str, ...]:
    if set(labels) != set(label_names):
        raise ValueError(
            f"expected labels {list(label_names)}, got {list(labels)}")
    return tuple(str(labels[k]) for k in label_names)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        return _check_labels(self.label_names, labels)

    def labeled_series(self) -> List[Tuple[Dict[str, str], object]]:
        with self._lock:
            items = list(self._series.items())
        return [(dict(zip(self.label_names, k)), v) for k, v in items]


class Counter(_Metric):
    """Monotone count; ``inc`` only (reference: prometheus counter)."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """Point-in-time value; set/inc/dec."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, nbuckets: int):
        self.counts = [0] * nbuckets     # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram; ``le`` buckets are upper-inclusive like
    the prometheus exposition they serialize to."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, label_names)
        bk = tuple(sorted(buckets or DEFAULT_LATENCY_BUCKETS))
        if not bk:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bk

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        value = float(value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _HistSeries(len(self.buckets))
            # first bucket with bound >= value (bisect is overkill for
            # ~26 fixed buckets and this stays allocation-free)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    s.counts[i] += 1
                    break
            s.sum += value
            s.count += 1

    def time(self, **labels):
        """``with hist.time(...):`` — observe the block's wall seconds."""
        from .span import span
        return span(self.name, histogram=self, **labels)

    # -- introspection (tests / snapshot) ------------------------------
    def cumulative_counts(self, **labels) -> List[int]:
        """Cumulative per-``le``-bucket counts; last entry is +Inf."""
        with self._lock:
            s = self._series.get(self._key(labels))
            if s is None:
                return [0] * (len(self.buckets) + 1)
            out, acc = [], 0
            for c in s.counts:
                acc += c
                out.append(acc)
            out.append(s.count)          # +Inf == total observations
            return out

    def sum_count(self, **labels) -> Tuple[float, int]:
        with self._lock:
            s = self._series.get(self._key(labels))
            return (s.sum, s.count) if s is not None else (0.0, 0)


class MetricRegistry:
    """Name -> metric; get-or-create with type/label consistency checks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, label_names, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, label_names, **kwargs)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) or m.label_names != tuple(label_names):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {list(m.label_names)}")
        buckets = kwargs.get("buckets")
        if buckets is not None and tuple(sorted(buckets)) != m.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{m.buckets}")
        return m

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, label_names,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def reset(self) -> None:
        """Drop every metric (tests)."""
        with self._lock:
            self._metrics.clear()

    # -- exposition ----------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able dump of every series."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = {}
        for m in metrics:
            series = []
            for labels, _ in m.labeled_series():
                if isinstance(m, Histogram):
                    s, c = m.sum_count(**labels)
                    series.append({
                        "labels": labels, "sum": s, "count": c,
                        "buckets": dict(zip(
                            [_fmt(b) for b in m.buckets] + ["+Inf"],
                            m.cumulative_counts(**labels)))})
                else:
                    series.append({"labels": labels,
                                   "value": m.value(**labels)})
            out[m.name] = {"type": m.kind, "help": m.help,
                           "series": series}
        return out

    def prometheus_text(self) -> str:
        """Text exposition format 0.0.4."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_esc_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for labels, _ in m.labeled_series():
                if isinstance(m, Histogram):
                    cum = m.cumulative_counts(**labels)
                    for b, c in zip(list(m.buckets) + [None], cum):
                        le = "+Inf" if b is None else _fmt(b)
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_lbl(labels, le=le)} {c}")
                    s, c = m.sum_count(**labels)
                    lines.append(f"{m.name}_sum{_lbl(labels)} {_fmt(s)}")
                    lines.append(f"{m.name}_count{_lbl(labels)} {c}")
                else:
                    lines.append(
                        f"{m.name}{_lbl(labels)} {_fmt(m.value(**labels))}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"                  # a diverged gauge must still scrape
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _lbl(labels: Dict[str, str], **extra) -> str:
    items = {**labels, **extra}
    if not items:
        return ""
    body = ",".join(f'{k}="{_esc_label(str(v))}"'
                    for k, v in items.items())
    return "{" + body + "}"


_global_registry = MetricRegistry()


def get_registry() -> MetricRegistry:
    return _global_registry


def counter(name: str, help: str = "",
            label_names: Sequence[str] = ()) -> Counter:
    return _global_registry.counter(name, help, label_names)


def gauge(name: str, help: str = "",
          label_names: Sequence[str] = ()) -> Gauge:
    return _global_registry.gauge(name, help, label_names)


def histogram(name: str, help: str = "", label_names: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _global_registry.histogram(name, help, label_names, buckets)


def snapshot() -> dict:
    return _global_registry.snapshot()


def prometheus_text() -> str:
    return _global_registry.prometheus_text()


# ------------------------------------------------------------ exit dump
def _default_dump_path() -> str:
    return os.path.join(os.getcwd(), "monitor_snapshots.jsonl")


def dump(path: Optional[str] = None) -> str:
    """Append one JSON line with the current snapshot (default path:
    ``monitor_snapshots.jsonl`` in the working directory)."""
    path = path or _default_dump_path()
    rec = {"ts": round(time.time(), 1),
           "iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "pid": os.getpid(),
           "snapshot": snapshot()}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return path


_dump_registered = threading.Lock()
_dump_paths: List[str] = []


def dump_on_exit(path: Optional[str] = None) -> str:
    """Archive the final snapshot at interpreter exit (idempotent per
    path); returns the path that will be written."""
    import atexit
    path = path or _default_dump_path()
    with _dump_registered:
        if path not in _dump_paths:
            if not _dump_paths:
                atexit.register(_dump_all)
            _dump_paths.append(path)
    return path


def _dump_all() -> None:
    for p in list(_dump_paths):
        try:
            dump(p)
        except Exception:
            pass
