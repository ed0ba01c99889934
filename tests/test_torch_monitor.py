"""The port's monitor (``paddle_tpu_torch.monitor``: registry, span,
tracer) and host recorder (``paddle_tpu_torch.profiler.record``) against
the JAX package's (``paddle_tpu/monitor``, ``paddle_tpu/profiler``).

The same scripted operations go through both: fresh registries must give
equal ``snapshot()`` and line-for-line equal ``prometheus_text()``, the
tracers equal chrome traces (events, phases, order) on a scripted clock,
and both schema checks must pass the port's trace.  The engine's own
trace comes last: a capture window over the port's engine on the tiny
model gives a valid chrome trace with every lifecycle event."""
import importlib
import json
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)

import paddle_tpu as paddle
from paddle_tpu import monitor as jmon
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.monitor import registry as jreg
from paddle_tpu.monitor import trace as jtrace
from paddle_tpu.profiler import record as jrecord
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.monitor import registry as treg
from paddle_tpu_torch.monitor import trace as ttrace

# the span modules (each package's ``monitor.span`` is the class)
jspan_mod = importlib.import_module("paddle_tpu.monitor.span")
tspan_mod = importlib.import_module("paddle_tpu_torch.monitor.span")

SIDES = {"jax": (jreg, jspan_mod, jtrace, jmon),
         "port": (treg, tspan_mod, ttrace, tmon)}


def script_registry(reg):
    """One scripted set of operations on a fresh registry."""
    c = reg.counter("reqs_total", "requests served")
    c.inc()
    c.inc(2.5)
    lc = reg.counter("routes_total", "by route", ("route", "code"))
    lc.inc(route="/generate", code="200")
    lc.inc(3, route="/generate", code="429")
    lc.inc(route='/we"ird\\path\n', code="500")
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.dec(2)
    g.inc(0.25)
    reg.gauge("diverged", "a NaN gauge still scrapes").set(float("nan"))
    reg.gauge("big", "").set(1e16)
    reg.gauge("neg_inf", "minus infinity").set(float("-inf"))
    h = reg.histogram("lat_seconds", "latency\nwith a newline")
    for v in (1e-7, 3e-6, 0.001, 0.25, 0.25, 2.0, 40.0, 100.0):
        h.observe(v)
    hb = reg.histogram("bytes", "payload", ("kind",),
                       buckets=jreg.BYTES_BUCKETS)
    for v, k in ((1, "a"), (4, "a"), (5, "b"), (1e9, "b"), (2e9, "a")):
        hb.observe(v, kind=k)
    occ = reg.histogram("occupancy", "fraction",
                        buckets=tuple(i / 8 for i in range(1, 9)))
    for v in (0.125, 0.5, 0.51, 1.0):
        occ.observe(v)
    reg.counter("zero_total", "materialized, never incremented").inc(0)
    return reg


def test_buckets_equal():
    assert treg.DEFAULT_LATENCY_BUCKETS == jreg.DEFAULT_LATENCY_BUCKETS
    assert treg.BYTES_BUCKETS == jreg.BYTES_BUCKETS


def test_snapshot_and_prometheus_text_equal():
    j = script_registry(jreg.MetricRegistry())
    t = script_registry(treg.MetricRegistry())
    # NaN never equals itself: compare the JSON text of the snapshots
    assert json.dumps(t.snapshot(), sort_keys=True) \
        == json.dumps(j.snapshot(), sort_keys=True)
    jt, tt = j.prometheus_text().splitlines(), t.prometheus_text().splitlines()
    assert len(tt) == len(jt) > 60
    for a, b in zip(tt, jt):
        assert a == b


def test_introspection_equal():
    j = script_registry(jreg.MetricRegistry())
    t = script_registry(treg.MetricRegistry())
    for name, labels in (("lat_seconds", {}), ("bytes", {"kind": "a"}),
                         ("bytes", {"kind": "b"}), ("bytes", {"kind": "z"}),
                         ("occupancy", {})):
        assert t.get(name).cumulative_counts(**labels) \
            == j.get(name).cumulative_counts(**labels)
        assert t.get(name).sum_count(**labels) \
            == j.get(name).sum_count(**labels)
    assert t.get("routes_total").value(route="/generate", code="429") \
        == j.get("routes_total").value(route="/generate", code="429") == 3
    assert t.get("missing") is None and j.get("missing") is None


@pytest.mark.parametrize("op", [
    "counter_as_gauge", "other_labels", "other_buckets", "negative_inc",
    "wrong_labels", "observe_wrong_labels"])
def test_registry_errors_equal(op):
    """Both registries refuse the same misuse with the same message."""
    def run(reg_mod):
        reg = reg_mod.MetricRegistry()
        reg.counter("c_total", "", ("a",))
        reg.histogram("h", "", buckets=(1.0, 2.0))
        try:
            if op == "counter_as_gauge":
                reg.gauge("c_total", "", ("a",))
            elif op == "other_labels":
                reg.counter("c_total", "", ("b",))
            elif op == "other_buckets":
                reg.histogram("h", "", buckets=(1.0, 3.0))
            elif op == "negative_inc":
                reg.get("c_total").inc(-1, a="x")
            elif op == "wrong_labels":
                reg.get("c_total").inc(b="x")
            else:
                reg.get("h").observe(1.0, a="x")
        except ValueError as e:
            return str(e)
        return None

    got = run(treg)
    assert got is not None and got == run(jreg)


def test_concurrent_updates_lose_nothing():
    """Threads (more than cores, a short switch interval) updating one
    registry and one tracer: every count, sum and event arrives."""
    import sys
    import threading
    reg = treg.MetricRegistry()
    tr = ttrace.Tracer()
    tr.start_capture(max_requests=64, max_events_per_request=4096,
                     host_events=False)
    n_threads, n = 32, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(n):
                reg.counter("c_total", "", ("k",)).inc(k=str(i % 4))
                reg.gauge("g", "").inc()
                reg.histogram("h", "").observe(0.001)
                tr.request_event(f"r{i % 8}", "tick")
                tr.step_record("decode", i, 1, 2)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        tr.stop_capture()
    total = n_threads * n
    assert sum(reg.get("c_total").value(k=str(k)) for k in range(4)) \
        == total
    assert reg.get("g").value() == total
    assert reg.get("h").sum_count()[1] == total
    assert reg.get("h").cumulative_counts()[-1] == total
    assert sum(len(tr.request_timeline(f"r{i}")["events"])
               for i in range(8)) == total
    assert len(tr.step_records()) == 2048       # the ring's bound


def test_get_or_create_returns_the_same_metric():
    for mod in (jreg, treg):
        reg = mod.MetricRegistry()
        a = reg.histogram("h", "x", ("k",), buckets=(2.0, 1.0))
        assert reg.histogram("h", "x", ("k",)) is a
        assert reg.histogram("h", "x", ("k",), buckets=(1.0, 2.0)) is a
        reg.reset()
        assert reg.get("h") is None


def test_dump_lines_equal_with_timestamps_masked(tmp_path, monkeypatch):
    """``dump`` appends one JSON line a call; with ts, iso and pid masked
    the port's line equals JAX's for the same registry content."""
    lines = {}
    for side, (reg_mod, *_rest) in SIDES.items():
        monkeypatch.setattr(reg_mod, "_global_registry",
                            script_registry(reg_mod.MetricRegistry()))
        path = tmp_path / f"{side}.jsonl"
        assert reg_mod.dump(str(path)) == str(path)
        reg_mod.dump(str(path))
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        assert len(recs) == 2
        for r in recs:
            assert set(r) == {"ts", "iso", "pid", "snapshot"}
            r.update(ts=0, iso="", pid=0)
        lines[side] = recs
    assert lines["port"] == lines["jax"]


class _Clock:
    """A scripted ``time`` stand-in: perf_counter advances 1.5 ms a
    read."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.0015
        return self.t


def test_span_observes_equal_histograms(monkeypatch):
    """A span (block, decorator, ``Histogram.time``) observes the same
    seconds into both registries on the same clock, and ``elapsed``
    reads them back."""
    snaps = {}
    for side, (reg_mod, span_mod, _tr, _mon) in SIDES.items():
        monkeypatch.setattr(span_mod, "time", _Clock())
        reg = reg_mod.MetricRegistry()
        h = reg.histogram("stage_seconds", "a stage", ("stage",))
        with span_mod.span("stage/io", histogram=h, stage="io") as sp:
            pass
        assert sp.elapsed == pytest.approx(0.0015)
        deco = span_mod.span("stage/fn", histogram=h, stage="fn")

        @deco
        def f(x):
            return x + 1

        assert f(1) == 2 and f(2) == 3
        assert deco.elapsed == pytest.approx(0.0015)
        with h.time(stage="timed"):
            pass
        with span_mod.span("no/histogram"):
            pass
        snaps[side] = reg.snapshot()
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"]["stage_seconds"]["series"][1]["sum"] \
        == pytest.approx(0.003)


def test_span_pushes_host_events_only_while_recording():
    """With the recorder enabled a span pushes one host event of its name
    in both packages; disabled, none."""
    names = {}
    for side, (_reg, span_mod, _tr, _mon), rec in (
            ("jax", SIDES["jax"], jrecord.get_recorder()),
            ("port", SIDES["port"], tprof.get_recorder())):
        prior = rec.enabled
        rec.enable(False)
        try:
            rec.collect()
            with span_mod.span("off/span"):
                pass
            rec.enable(True)
            with span_mod.span("engine/decode_step"):
                pass
            with (jrecord if side == "jax" else tprof).RecordEvent("user"):
                pass
            evs = rec.collect()
        finally:
            rec.enable(prior)
        names[side] = [e.name for e in evs]
        for e in evs:
            assert e.end_ns >= e.start_ns > 0
    assert names["port"] == names["jax"] == ["engine/decode_step", "user"]


def test_record_function_decorator():
    rec = tprof.get_recorder()
    rec.collect()

    @tprof.record_function("wrapped")
    def g():
        return 5

    assert g() == 5 and rec.collect() == []      # not recording
    rec.enable(True)
    try:
        assert g() == 5
        evs = rec.collect()
    finally:
        rec.enable(False)
    assert [e.name for e in evs] == ["wrapped"]


def _script_tracer(tracer_cls):
    """One scripted trace on a fresh tracer with a 1 us a read clock:
    bounded buffers (2 requests, 4 events a request, 3 steps), flows,
    an id-less event, a window that closes and ignores later events."""
    clock = iter(range(10_000, 10_000_000, 1000))
    tr = tracer_cls()
    tr.now_ns = lambda: next(clock)
    tr.request_event("a", "enqueue", cls="batch")      # window shut
    tr.start_capture(max_requests=2, max_events_per_request=4,
                     max_steps=3, host_events=False)
    tr.request_event("a", "enqueue", cls="batch", prompt_tokens=12)
    tr.request_event("a", "admitted", seq_id=0)
    s0 = tr.now_ns()
    tr.request_event("a", "prefill_chunk", tokens=8, pos=0)
    tr.step_record("prefill_chunk", 0, s0, tr.now_ns(), request="a")
    tr.request_event(None, "brownout", level=1)
    tr.request_event("b", "enqueue", cls="interactive")
    for step in range(4):
        s = tr.now_ns()
        tr.request_event("a", "decode_step", step=step)   # cap: dropped
        tr.request_event("b", "verify_step", step=step, accept=2)
        tr.step_record("decode", step, s, tr.now_ns(), batch=2,
                       classes={"batch": 1, "interactive": 1})
    tr.request_event("c", "enqueue")                   # evicts "a"
    tr.request_event("c", "retire", ok=True)
    tr.start_capture()                                 # re-entrant: kept
    tr.stop_capture()
    tr.request_event("c", "late")                      # window shut
    tr.step_record("decode", 9, 1, 2)
    return tr


def _dropped(trace_mod):
    return trace_mod._dropped_total.value()


def test_tracer_matches_jax():
    before = {k: _dropped(m) for k, m in (("jax", jtrace),
                                          ("port", ttrace))}
    jt = _script_tracer(jtrace.Tracer)
    tt = _script_tracer(ttrace.Tracer)
    # the same drops counted by each package's own series
    assert _dropped(ttrace) - before["port"] \
        == _dropped(jtrace) - before["jax"] > 0
    assert tt.request_ids() == jt.request_ids() == ["b", "c"]
    for rid in ("a", "b", "c"):
        assert tt.request_timeline(rid) == jt.request_timeline(rid)
    assert tt.step_records() == jt.step_records()
    assert len(tt.step_records()) == 3
    jc, tc = jt.to_chrome_trace(), tt.to_chrome_trace()
    assert tc["traceEvents"] == jc["traceEvents"]
    # flows: "b"'s three verify steps ("a" was evicted, "b"'s fourth
    # event dropped)
    assert [e["ph"] for e in tc["traceEvents"]].count("s") == 3
    assert tc["otherData"]["generator"] == "paddle_tpu_torch.monitor.trace"
    assert {k: v for k, v in tc["otherData"].items() if k != "generator"} \
        == {k: v for k, v in jc["otherData"].items() if k != "generator"}
    assert ttrace.validate_chrome_trace(tc) == []
    assert jtrace.validate_chrome_trace(tc) == []


@pytest.mark.parametrize("broken", ["unsorted", "unclosed", "stray_end",
                                    "no_dur", "missing_key", "not_json",
                                    "no_events"])
def test_validate_chrome_trace_equal(broken):
    good = _script_tracer(ttrace.Tracer).to_chrome_trace()
    ev = [dict(e) for e in good["traceEvents"]]
    if broken == "unsorted":
        ev[3]["ts"], ev[5]["ts"] = ev[5]["ts"], ev[3]["ts"]
    elif broken == "unclosed":
        ev = [e for e in ev if e["ph"] != "E"]
    elif broken == "stray_end":
        ev = [e for e in ev if e["ph"] != "B"]
    elif broken == "no_dur":
        next(e for e in ev if e["ph"] == "X").pop("dur")
    elif broken == "missing_key":
        ev[4].pop("tid")
    payload = {"traceEvents": ev}
    if broken == "not_json":
        payload["otherData"] = {"x": object()}
    elif broken == "no_events":
        payload = {"events": ev}
    got = ttrace.validate_chrome_trace(payload)
    assert got and got == jtrace.validate_chrome_trace(payload)


def test_capture_window_merges_host_spans():
    """``start_capture`` enables the host recorder for its window, so a
    span inside lands on the trace's host track (pid 3); the window
    leaves the recorder as it found it, and the capture series count."""
    tr = ttrace.Tracer()
    rec = tprof.get_recorder()
    assert not rec.enabled
    opened = ttrace._captures_total.value()
    tr.start_capture()
    assert rec.enabled
    assert tmon.get_registry().get("trace_capture_active").value() == 1
    tr.request_event("r", "enqueue")
    with tmon.span("engine/prefill"):
        time.sleep(0.001)
    tr.request_event("r", "retire", ok=True)
    tr.stop_capture()
    assert not rec.enabled
    assert tmon.get_registry().get("trace_capture_active").value() == 0
    assert ttrace._captures_total.value() == opened + 1
    payload = tr.to_chrome_trace()
    host = [e for e in payload["traceEvents"]
            if e["pid"] == 3 and e["ph"] == "X"]
    assert [e["name"] for e in host] == ["engine/prefill"]
    assert host[0]["dur"] >= 1000.0
    assert tmon.validate_chrome_trace(payload) == []


def test_module_functions_drive_the_process_tracer(tmp_path):
    tmon.start_capture(host_events=False)
    assert tmon.get_tracer().enabled
    tmon.get_tracer().request_event("req-x", "enqueue")
    tmon.stop_capture()
    assert tmon.request_timeline("req-x")["events"][0]["kind"] == "enqueue"
    path = tmp_path / "trace.json"
    payload = tmon.export_chrome_trace(str(path))
    assert json.loads(path.read_text()) == payload
    assert sorted(tmon.__all__) == sorted(
        n for n in jmon.__all__ if n != "install_compile_hooks")


# ------------------------------------------------------ the engine's trace
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2,
            num_key_value_heads=2, max_position_embeddings=128)


@pytest.fixture(scope="module")
def tm():
    paddle.seed(0)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
def test_engine_trace_window(tm, unified):
    """A capture window over the port's engine: every request's timeline
    runs enqueue, admitted, its prefill chunks, first_token, a step a
    token, retire; the step track holds the chunks and decode steps; the
    chrome trace passes both schema checks; and the engine's spans land
    on the host track."""
    rng = np.random.default_rng(3)
    tmon.start_capture()
    try:
        with ContinuousBatchingEngine(tm, total_pages=64, page_size=8,
                                      max_batch=2, prefill_chunk_tokens=8,
                                      unified_step=unified,
                                      device="cpu") as eng:
            with eng._cond:
                reqs = [eng.submit(rng.integers(0, 64, (12,)),
                                   max_new_tokens=4) for _ in range(3)]
            for r in reqs:
                r.result(timeout=60)
    finally:
        tmon.stop_capture()
    for r in reqs:
        kinds = [e["kind"] for e in
                 tmon.request_timeline(r.request_id)["events"]]
        assert kinds[:2] == ["enqueue", "admitted"]
        assert kinds.count("prefill_chunk") == 2
        assert kinds[kinds.index("first_token") - 1] == "prefill_chunk"
        assert kinds.count("decode_step") == 4 and kinds[-1] == "retire"
    steps = tmon.get_tracer().step_records()
    assert {s["kind"] for s in steps} == {"prefill_chunk", "decode"}
    payload = tmon.export_chrome_trace()
    assert tmon.validate_chrome_trace(payload) == []
    assert jtrace.validate_chrome_trace(payload) == []
    host = {e["name"] for e in payload["traceEvents"]
            if e["pid"] == 3 and e["ph"] == "X"}
    assert host == ({"engine/ragged_step"} if unified
                    else {"engine/prefill", "engine/decode_step"})
