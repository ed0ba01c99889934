"""Preemption in the engine on the card: a ``batch``-class request paused
by an ``interactive`` arrival, mid-prefill or mid-decode, resumes where
it stopped, and its stream through the engine's CUDA graphs equals the
CPU's preempted stream and the card's unpreempted one, greedy and
sampled, through the unified step and the legacy composition.  These
need a CUDA device; elsewhere they skip.  Run them on the card with

    python -m pytest --noconftest tests/test_torch_engine_lifecycle_card.py

The CPU twin of each case is ``tests/test_torch_engine_lifecycle.py``."""
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.testing import faults

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=512)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear()


def _models():
    cpu = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=7)
    gpu = LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def _wait(cond, timeout=60.0):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError("timed out")
        time.sleep(0.001)


def _run(model, device, unified, sampled, mid_decode, preempt):
    """The batch request's stream and the batch class's counters, in an
    engine of one slot with every chunk (or decode step) paced."""
    rng = np.random.default_rng(11)
    long_p = rng.integers(0, 512, 130).astype(np.int32)
    short_p = rng.integers(0, 512, 9).astype(np.int32)
    site = "decode_step" if mid_decode else "prefill_chunk"
    plan = faults.FaultPlan([{"site": site, "kind": "delay",
                              "delay_s": 0.02}])
    with faults.installed(plan), ContinuousBatchingEngine(
            model, total_pages=64, page_size=16, max_batch=1,
            prefill_chunk_tokens=None if mid_decode else 32,
            unified_step=unified, device=device) as eng:
        rb = eng.submit(long_p, max_new_tokens=24, do_sample=sampled,
                        temperature=0.8, seed=5, priority="batch")
        if preempt:
            _wait((lambda: len(rb.generated) >= 4) if mid_decode
                  else (lambda: rb.prefill_pos > 0))
            ri = eng.submit(short_p, max_new_tokens=8,
                            priority="interactive")
            ri.result(timeout=120)
        got = rb.result(timeout=120).tolist()
        if preempt:
            assert ri.finished_at < rb.finished_at
        _wait(lambda: eng.cache.free_pages == eng.cache.total_pages)
        assert eng._reserved_pages == eng._pad_pages
        if device == "cuda":
            assert eng.replays
        return got, eng.scheduler_info()["counts"]["batch"]


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("unified", [True, False],
                         ids=["unified", "legacy"])
@pytest.mark.parametrize("mid_decode", [False, True],
                         ids=["prefill", "decode"])
def test_preempted_stream_equals_cpu_and_unpreempted(dev, mid_decode,
                                                     unified, sampled):
    cpu, gpu = _models()
    card, counts = _run(gpu, "cuda", unified, sampled, mid_decode, True)
    host, _ = _run(cpu, "cpu", unified, sampled, mid_decode, True)
    alone, _ = _run(gpu, "cuda", unified, sampled, mid_decode, False)
    assert counts["preempted"] == counts["resumed"] == 1
    assert card == host == alone
