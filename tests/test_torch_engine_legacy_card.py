"""The engine's legacy composition (``unified_step=False``) on the card:
its decode, prefill and chunk-prefill steps as CUDA graphs
(``GraphedPagedDecoder``) against the same engine on the eager
``PagedDecoder`` on the card, and its decode-step bisection under a
fault plan.  These need a CUDA device; elsewhere they skip.  Run them on
the card with

    python -m pytest --noconftest tests/test_torch_engine_legacy_card.py

Graphed and eager run the same kernels in the same order on the same
inputs, so their ids are held bit for bit."""
import contextlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import continuous
from paddle_tpu_torch.inference.paged import PagedDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.testing import faults

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=256)
ENGINE = dict(total_pages=64, page_size=16, max_batch=4)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


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


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, n).astype(np.int32) for n in (7, 30, 75)]


def _serve(model, chunk, eager=False, plan=None):
    """Three requests (the last one sampled) admitted together through a
    legacy engine on the card: their streams, the engine's counters and
    the keys of its graphs."""
    decoder = continuous.GraphedPagedDecoder
    if eager:
        continuous.GraphedPagedDecoder = PagedDecoder
    try:
        with (faults.installed(faults.FaultPlan(plan)) if plan
              else contextlib.nullcontext()), \
                continuous.ContinuousBatchingEngine(
                    model, prefill_chunk_tokens=chunk, unified_step=False,
                    device="cuda", **ENGINE) as eng:
            with eng._cond:
                reqs = [eng.submit(p, max_new_tokens=10, do_sample=i == 2,
                                   temperature=0.9, seed=3)
                        for i, p in enumerate(_prompts())]
            outs = []
            for r in reqs:
                try:
                    outs.append(r.result(timeout=300).tolist())
                except faults.FaultError:
                    outs.append(None)
            assert eng.cache.free_pages == ENGINE["total_pages"]
            assert eng._reserved_pages == 1
            keys = set(getattr(eng._decoder, "_graphs", ()))
            return outs, eng, keys
    finally:
        continuous.GraphedPagedDecoder = decoder


@pytest.mark.parametrize("chunk", [None, 16], ids=["unchunked", "chunked"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_graphed_legacy_engine_equals_eager(dev, dt, chunk):
    model = LlamaForCausalLM(LlamaConfig(**CFG), device=dev,
                             dtype=DTYPES[dt], seed=3)
    graphed, eng, keys = _serve(model, chunk)
    eager, eager_eng, _ = _serve(model, chunk, eager=True)
    assert graphed == eager
    assert eng.captures == len(keys) > 0 and eng.replays > 0
    assert eng.dispatches["ragged"] == 0
    assert eng.dispatches == eager_eng.dispatches


def test_bisection_captures_only_new_buckets(dev):
    """A sticky decode fault on the middle request: the clean run's graphs
    cover the bucket of 4; the faulted run's bisection steps halves of 2
    and 1, the only buckets it captures anew, and ejects exactly the
    poisoned request; the others' streams equal the clean run's."""
    model = LlamaForCausalLM(LlamaConfig(**CFG), device=dev,
                             dtype=torch.float32, seed=3)
    clean, _eng, clean_keys = _serve(model, None)
    outs, eng, keys = _serve(model, None, plan=[{"site": "decode_step",
                                                 "seq_id": 1}])
    assert outs == [clean[0], None, clean[2]]
    assert eng.quarantined == 1 and eng.decode_retries == 5
    # each key captured once; the bisection's new keys are decode steps of
    # 1 or 2 rows, which the clean run's batch of 3 (a bucket of 4) never
    # took
    assert eng.captures == len(keys)
    new = keys - clean_keys
    assert new and all(k[0] == "decode" and k[2] in (1, 2) for k in new)
    assert not any(k[0] == "decode" and k[2] in (1, 2) for k in clean_keys)
