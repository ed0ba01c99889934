"""Port parity: quantized serving (int8 weights, int8 KV pages) of
paddle_tpu_torch's engine against the JAX package's engine on the same
weights and requests (CPU, f32).  Greedy streams must be identical token
for token — unchunked, chunked and with a prefix-cache hit — in both
weight modes, and one w8a8 prefill's logits must agree closely."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.paged import JittedPagedDecoder
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.ops.pallas.paged_attention import PagedKVCache as JaxCache
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.inference.paged import PagedDecoder
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.ops.paged_attention import PagedKVCache

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(total_pages=64, page_size=8, max_batch=4, kv_quant="int8")
CASES = [(q, c) for q in ("w8", "w8a8") for c in (None, 8)]
IDS = [f"{q}-{'chunked' if c else 'unchunked'}" for q, c in CASES]


@pytest.fixture(scope="module")
def models():
    paddle.seed(1)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


def _prompts():
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n in (5, 12, 20)]
    # shares the last prompt's first two 8-token pages
    sharer = np.concatenate([prompts[2][:16],
                             rng.integers(0, 64, (5,))]).astype(np.int32)
    return prompts, sharer


def _serve(engine):
    """Three concurrent greedy requests, then one sharing the last
    prompt's cached prefix.  Returns the streams and the sharer's
    prefix-hit length."""
    prompts, sharer = _prompts()
    reqs = [engine.submit(p, max_new_tokens=6) for p in prompts]
    outs = [r.result(timeout=300).tolist() for r in reqs]
    hit = engine.submit(sharer, max_new_tokens=5)
    outs.append(hit.result(timeout=300).tolist())
    return outs, hit.prefix_tokens


@pytest.mark.parametrize("quant,chunk", CASES, ids=IDS)
def test_quantized_greedy_streams_match_jax_engine(models, quant, chunk):
    jm, tm = models
    with JaxEngine(jm, quantize=quant, prefill_chunk_tokens=chunk,
                   **ENGINE) as eng:
        want, want_hit = _serve(eng)
    with ContinuousBatchingEngine(tm, quantize=quant,
                                  prefill_chunk_tokens=chunk, device="cpu",
                                  **ENGINE) as eng:
        got, got_hit = _serve(eng)
        assert eng.cache.k_pages[0].dtype == torch.int8
        assert eng.cache.free_pages == ENGINE["total_pages"]
    assert got_hit == want_hit == 16
    assert got == want
    # the hooks are armed only inside a step
    assert all(m._serving_quant is None for m in tm.modules()
               if hasattr(m, "_serving_quant"))


def test_w8a8_prefill_logits_match_jax(models):
    jm, tm = models
    ids = np.random.default_rng(3).integers(0, 64, (1, 13)).astype(np.int32)
    jc = JaxCache.from_model(jm, total_pages=8, page_size=8,
                             kv_dtype="int8")
    want = JittedPagedDecoder(jm, quantize="w8a8").prefill(jc, [0], ids)
    tc = PagedKVCache.from_model(tm, total_pages=8, page_size=8,
                                 kv_dtype="int8")
    got = PagedDecoder(tm, quantize="w8a8").prefill(tc, [0], ids)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-5
    # the int8 pages and their scales hold what JAX's hold
    np.testing.assert_array_equal(tc.k_pages[1].numpy(),
                                  np.asarray(jc.k_pages[1]))
    np.testing.assert_allclose(tc.v_scales[1].numpy(),
                               np.asarray(jc.v_scales[1]), rtol=1e-6)


def test_unknown_modes_raise_as_in_jax(models):
    jm, tm = models
    with pytest.raises(ValueError, match="quantize must be one of"):
        PagedDecoder(tm, quantize="w4")
    with pytest.raises(ValueError, match="quantize must be one of"):
        JittedPagedDecoder(jm, quantize="w4")
    with pytest.raises(ValueError, match="kv_quant must be None or 'int8'"):
        ContinuousBatchingEngine(tm, kv_quant="fp8", device="cpu")
    with pytest.raises(ValueError, match="kv_quant must be None or 'int8'"):
        JaxEngine(jm, kv_quant="fp8")
