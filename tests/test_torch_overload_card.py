"""The overload controls, the result cache and the tracer in the engine on
the card: a batch row paused by the TPOT trigger gives the CPU's stream
and the stream of the run without the budget, a scripted deadline shed
and a scripted brownout ladder decide as on the CPU, ``result_for``
reports as on the CPU, and a capture window over the engine's CUDA-graph
steps gives a valid chrome trace.  These need a CUDA device; elsewhere
they skip.  Run them on the card with

    python -m pytest --noconftest tests/test_torch_overload_card.py

The CPU twins are in ``tests/test_torch_overload.py`` and
``tests/test_torch_monitor.py``."""
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import monitor
from paddle_tpu_torch.inference.continuous import (ContinuousBatchingEngine,
                                                   EngineSaturated)
from paddle_tpu_torch.inference.scheduler import PriorityClass
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.testing import faults

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=512)


@pytest.fixture(scope="module")
def models():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode")
    cpu = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=7)
    gpu = LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear()


def _prompts():
    rng = np.random.default_rng(12)
    return (rng.integers(0, 512, 130).astype(np.int32),
            rng.integers(0, 512, 9).astype(np.int32))


def _classes(tpot=None, deadline=None):
    return (PriorityClass("interactive", rank=0, weight=8,
                          tpot_budget_s=tpot),
            PriorityClass("standard", rank=1, weight=4),
            PriorityClass("batch", rank=2, weight=1, preemptible=True,
                          deadline_s=deadline))


def _engine(model, dev, **kw):
    return ContinuousBatchingEngine(model, total_pages=64, page_size=16,
                                    device=dev, **kw)


def _pace(delay):
    return faults.installed(faults.FaultPlan(
        [{"site": "decode_step", "kind": "delay", "delay_s": delay}]))


def _wait(cond, timeout=60.0):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError("timed out")
        time.sleep(0.001)


def _preemptions():
    return monitor.get_registry().get("decode_preemptions_total").value()


def _tpot(model, dev, unified, budget):
    long_p, short_p = _prompts()
    before = _preemptions()
    with _pace(0.02), _engine(model, dev, max_batch=2,
                              scheduler_classes=_classes(tpot=budget),
                              default_class="standard",
                              tpot_preempt_cooldown_s=0.0,
                              unified_step=unified) as eng:
        rb = eng.submit(long_p, max_new_tokens=24, priority="batch")
        _wait(lambda: len(rb.generated) >= 2)
        ri = eng.submit(short_p, max_new_tokens=8, priority="interactive")
        ri.result(timeout=120)
        return rb.result(timeout=120).tolist(), _preemptions() - before


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
def test_tpot_parked_row_card_equals_cpu(models, unified):
    cpu, gpu = models
    card, n_card = _tpot(gpu, "cuda", unified, 1e-4)
    host, n_host = _tpot(cpu, "cpu", unified, 1e-4)
    alone, n_alone = _tpot(gpu, "cuda", unified, None)
    assert card == host == alone
    assert n_card >= 1 and n_host >= 1 and n_alone == 0


def _decide(eng, order, prompt):
    out, reqs = [], []
    for cls in order:
        try:
            reqs.append(eng.submit(prompt, max_new_tokens=2, priority=cls))
            out.append("admitted")
        except EngineSaturated as e:
            assert e.priority_class == cls and 1 <= e.retry_after_s <= 30
            out.append("shed")
    return out, reqs


def _shed(model, dev):
    long_p, short_p = _prompts()
    with _pace(0.02), _engine(model, dev, max_batch=1,
                              scheduler_classes=_classes(deadline=1e-9),
                              default_class="standard") as eng:
        eng.submit(short_p, max_new_tokens=3).result(timeout=120)
        r1 = eng.submit(long_p, max_new_tokens=12, priority="batch")
        _wait(lambda: len(r1.generated) >= 1)
        out, reqs = _decide(eng, ("batch", "batch", "standard",
                                  "interactive", "batch"), short_p)
        for r in reqs + [r1]:
            r.result(timeout=120)
        return out


def test_deadline_shed_card_equals_cpu(models):
    cpu, gpu = models
    want = ["admitted", "shed", "admitted", "admitted", "shed"]
    assert _shed(gpu, "cuda") == _shed(cpu, "cpu") == want


def _ladder(model, dev):
    _long, short_p = _prompts()
    with _pace(0.03), _engine(model, dev, max_batch=1, max_queue=8,
                              brownout_thresholds=(0.25, 0.5, 0.75, 0.95),
                              brownout_patience=2) as eng:
        rungs, set_rung = [], eng._set_brownout_locked

        def record(level, pressure):
            if level != eng._brownout:
                rungs.append(level)
            set_rung(level, pressure)

        eng._set_brownout_locked = record
        with eng._cond:
            reqs = [eng.submit(short_p, max_new_tokens=4,
                               priority="interactive") for _ in range(5)]
        _wait(lambda: eng.scheduler_info()["brownout_level"] == 2)
        out, more = _decide(eng, ("batch", "standard", "interactive"),
                            short_p)
        for r in reqs + more:
            r.result(timeout=120)
        _wait(lambda: eng.scheduler_info()["brownout_level"] == 0)
        return rungs, out


def test_brownout_ladder_card_equals_cpu(models):
    cpu, gpu = models
    card = _ladder(gpu, "cuda")
    assert card == _ladder(cpu, "cpu")
    assert card == ([1, 2, 1, 0], ["shed", "shed", "admitted"])


def _results(model, dev):
    long_p, short_p = _prompts()
    with _pace(0.02), _engine(model, dev, max_batch=1,
                              result_cache_size=2) as eng:
        a = eng.submit(long_p, max_new_tokens=6, request_id="a")
        _wait(lambda: len(a.generated) >= 1)
        b = eng.submit(short_p, max_new_tokens=3, request_id="b")
        c = eng.submit(short_p, max_new_tokens=3, request_id="c")
        pending = eng.result_for("b")
        c.cancel()
        _wait(lambda: (eng.result_for("c") or {}).get("status") == "error")
        cancelled = eng.result_for("c")
        a.result(timeout=120)
        b.result(timeout=120)
        return pending, cancelled, eng.result_for("a"), \
            eng.result_for("b"), eng.result_for("c")


def test_result_for_card_equals_cpu(models):
    cpu, gpu = models
    card = _results(gpu, "cuda")
    assert card == _results(cpu, "cpu")
    pending, cancelled, a, b, c = card
    assert pending["status"] == "pending"
    assert cancelled["error_type"] == "RequestCancelled"
    assert a["status"] == b["status"] == "done" and c is None


def test_trace_window_over_graphed_steps(models):
    _cpu, gpu = models
    rng = np.random.default_rng(3)
    with _engine(gpu, "cuda", max_batch=2, prefill_chunk_tokens=32) as eng:
        warm = [eng.submit(rng.integers(0, 512, (40,)), max_new_tokens=4)
                for _ in range(3)]
        for r in warm:
            r.result(timeout=120)
        captured = eng.captures
        monitor.start_capture()
        try:
            reqs = [eng.submit(rng.integers(0, 512, (40,)),
                               max_new_tokens=4) for _ in range(3)]
            for r in reqs:
                r.result(timeout=120)
        finally:
            monitor.stop_capture()
        assert eng.replays > 0
    payload = monitor.export_chrome_trace()
    assert monitor.validate_chrome_trace(payload) == []
    for r in reqs:
        kinds = [e["kind"] for e in
                 monitor.request_timeline(r.request_id)["events"]]
        assert kinds[0] == "enqueue" and kinds[-1] == "retire"
        assert kinds.count("prefill_chunk") == 2
        assert kinds.count("decode_step") == 4
    spans = {e["name"] for e in payload["traceEvents"]
             if e["pid"] == 3 and e["ph"] == "X"}
    assert spans == {"engine/ragged_step"}
    assert eng.captures >= captured
