"""paddle_tpu_torch.monitor — runtime telemetry (the port of
``paddle_tpu.monitor``).

A process-wide metrics registry (Counter / Gauge / Histogram with fixed
log-scale buckets; thread-safe, stdlib only) plus span tracing that feeds
the host recorder, and the request tracer.  Instrumented subsystems:

  * ``inference.continuous`` — queue depth, batch occupancy, decode-step
    and prefill latency, TTFT, generated tokens, the prefix cache,
    failure isolation, speculation, recovery, quantized serving,
    dispatches by mode and the overload controls;
  * ``inference.scheduler`` — per-class queue wait, TTFT and TPOT
    histograms and the admission, preemption and shed counters;
  * ``distributed.watchdog`` — the scan's heartbeat, tasks in flight and
    timeouts.

The series keep the JAX package's names and help texts.  This registry
is the port's own: a process that imports both packages keeps two.  The
JAX package's compile hooks (XLA recompile counters) have no counterpart
here.

Usage::

    from paddle_tpu_torch import monitor
    h = monitor.histogram("my_latency_seconds", "...", ("stage",))
    with monitor.span("stage/io", histogram=h, stage="io"):
        ...
    print(monitor.prometheus_text())     # or monitor.snapshot()
    monitor.dump_on_exit()               # archive at interpreter exit
"""
from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricRegistry, get_registry,
    counter, gauge, histogram, snapshot, prometheus_text,
    dump, dump_on_exit, DEFAULT_LATENCY_BUCKETS, BYTES_BUCKETS,
)
from .span import span  # noqa: F401
from .trace import (  # noqa: F401
    Tracer, get_tracer, start_capture, stop_capture, request_timeline,
    export_chrome_trace, validate_chrome_trace,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "get_registry",
    "counter", "gauge", "histogram", "snapshot", "prometheus_text",
    "dump", "dump_on_exit", "span",
    "DEFAULT_LATENCY_BUCKETS", "BYTES_BUCKETS",
    "Tracer", "get_tracer", "start_capture", "stop_capture",
    "request_timeline", "export_chrome_trace", "validate_chrome_trace",
]
