"""Port parity: ``PagedGenerator`` against the JAX package's on the CPU
(greedy through ``multi_step`` chunks, eos, sampled on the host, pool
pressure, int8 KV and w8a8), against the port's dense ``generate``; the
paged decoder's failure contract; and no fallback to the CPU.  The same
numpy weights in both packages; tokens must be equal."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.paged import PagedGenerator as JaxGenerator
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch.inference import PagedGenerator, paged
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import paged_attention as tpa

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)


@pytest.fixture(scope="module")
def models():
    paddle.seed(4)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


# ------------------------------------------------ the failure contract
def test_a_failed_step_changes_no_page_and_rolls_back(models):
    """A step that fails before its body (here in the upload), or in the
    body before the first write (a token past the vocabulary), leaves
    every page bit-equal and the lengths where it found them; the same
    step then runs."""
    td = paged.PagedDecoder(models[1])
    tc = tpa.PagedKVCache(2, 2, 8, total_pages=48, page_size=4,
                          device="cpu")
    ids = np.random.default_rng(4).integers(0, 64, (3, 6)).astype(np.int32)
    td.prefill(tc, [0, 1, 2], ids)
    pools = [t.clone() for t in tc.k_pages + tc.v_pages]
    pos = np.full(3, 6, np.int32)
    real = paged._Staging.upload

    def broken(_st):
        raise RuntimeError("injected: the upload failed")

    paged._Staging.upload = broken
    try:
        with pytest.raises(RuntimeError, match="injected"):
            td.step(tc, [0, 1, 2], ids[:, :1], pos)
        with pytest.raises(RuntimeError, match="injected"):
            td.multi_step(tc, [0, 1, 2], ids[:, 0], pos, 3)
        with pytest.raises(RuntimeError, match="injected"):
            td.verify(tc, [0, 1, 2], ids[:, :3], pos)
    finally:
        paged._Staging.upload = real
    with pytest.raises(IndexError):
        td.step(tc, [0, 1, 2], np.array([[1], [64], [2]], np.int32), pos)
    assert [tc.length(s) for s in range(3)] == [6, 6, 6]
    for before, after in zip(pools, tc.k_pages + tc.v_pages):
        assert torch.equal(before, after)
    out = td.step(tc, [0, 1, 2], ids[:, :1], pos)
    assert out.shape == (3, 64)


# ------------------------------------------------------ PagedGenerator
def _gen_ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape).astype(
        np.int32)


GEN_CASES = {
    "greedy": (dict(), dict(max_new_tokens=12), (2, 7)),
    "int8kv-greedy": (dict(kv_dtype="int8"), dict(max_new_tokens=9),
                      (2, 7)),
    "w8a8-greedy": (dict(quantize="w8a8"), dict(max_new_tokens=9), (2, 7)),
    "sampled": (dict(), dict(max_new_tokens=6, do_sample=True, seed=7,
                             temperature=0.9), (2, 5)),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generator_matches_jax_generator(models, case):
    """``PagedGenerator`` against JAX's: greedy (one ``multi_step`` chunk
    rounded up to a power of two and cut), with int8 KV and w8a8, and
    sampled (one step a token, drawn on the host): equal tokens, every
    page free after."""
    jm, tm = models
    kw, gen_kw, shape = GEN_CASES[case]
    ids = _gen_ids(5, shape)
    want = JaxGenerator(jm, total_pages=64, page_size=8, **kw).generate(
        ids, **gen_kw)
    gen = PagedGenerator(tm, total_pages=64, page_size=8, device="cpu",
                         **kw)
    got = gen.generate(ids, **gen_kw)
    np.testing.assert_array_equal(got, want)
    assert gen.cache.free_pages == gen.cache.total_pages
    assert gen.last_prefill_seconds > 0 and gen.last_decode_seconds > 0
    assert (gen._decoder.captures, gen._decoder.replays) == (0, 0)


def test_generator_eos_matches_jax_generator(models):
    """An eos that row 0 reaches at its third token: the stepwise width
    contract and everything after a row's eos set to eos, as in JAX."""
    jm, tm = models
    ids = _gen_ids(6, (2, 7))
    probe = JaxGenerator(jm, total_pages=64, page_size=8).generate(
        ids, max_new_tokens=8)
    eos = int(probe[0, 9])
    want = JaxGenerator(jm, total_pages=64, page_size=8).generate(
        ids, max_new_tokens=8, eos_token_id=eos)
    got = PagedGenerator(tm, total_pages=64, page_size=8,
                         device="cpu").generate(ids, max_new_tokens=8,
                                                eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 9:] == eos).all()


def test_generator_under_pool_pressure_matches_jax(models):
    """12 pages of 4 tokens cannot hold a 64-token chunk: the chunk's
    reservation fails with nothing left reserved and one step a token
    goes on to the eos, as in JAX; every page free after."""
    jm, tm = models
    ids = _gen_ids(3, (1, 6))
    probe = JaxGenerator(jm, total_pages=128, page_size=4).generate(
        ids, max_new_tokens=90)
    eos = int(probe[0, 6 + 20])
    want = JaxGenerator(jm, total_pages=12, page_size=4).generate(
        ids, max_new_tokens=90, eos_token_id=eos)
    gen = PagedGenerator(tm, total_pages=12, page_size=4, device="cpu")
    got = gen.generate(ids, max_new_tokens=90, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] < 6 + 90
    assert gen.cache.free_pages == 12
    assert any(k[0] == "decode" for k in gen._decoder._staging)


def test_only_pages_exhausted_hands_over_to_steps(models, monkeypatch):
    """The per-token continuation takes over on :class:`PagesExhausted`
    whatever its text, with JAX's tokens; any other error of a chunk,
    even one whose text says "out of pages", propagates."""
    jm, tm = models
    ids = _gen_ids(5, (2, 7))
    want = JaxGenerator(jm, total_pages=64, page_size=4).generate(
        ids, max_new_tokens=12)
    gen = PagedGenerator(tm, total_pages=64, page_size=4, device="cpu")

    def exhausted(*a, **kw):
        raise tpa.PagesExhausted("the pool ran dry")

    monkeypatch.setattr(gen._decoder, "multi_step", exhausted)
    np.testing.assert_array_equal(gen.generate(ids, max_new_tokens=12),
                                  want)
    assert gen.cache.free_pages == 64

    def other(*a, **kw):
        raise RuntimeError("out of pages, but not the pool's")

    monkeypatch.setattr(gen._decoder, "multi_step", other)
    with pytest.raises(RuntimeError, match="not the pool's"):
        gen.generate(ids, max_new_tokens=12)
    assert gen.cache.free_pages == 64


def test_generator_matches_dense_generate(models):
    """The port's ``PagedGenerator`` and its dense KV-cache ``generate``
    give the same greedy tokens (JAX's
    ``test_paged_generation_matches_dense``)."""
    _jm, tm = models
    ids = _gen_ids(8, (3, 9))
    dense = tm.generate(torch.from_numpy(ids.astype(np.int64)),
                        max_new_tokens=8).numpy()
    got = PagedGenerator(tm, total_pages=64, page_size=8,
                         device="cpu").generate(ids, max_new_tokens=8)
    np.testing.assert_array_equal(got, dense)


def test_generator_has_no_fallback(models):
    """``device="cuda"`` (the default) raises where there is no card, and
    a model that lives elsewhere than ``device`` raises: nothing falls
    back to the CPU."""
    _jm, tm = models
    with pytest.raises(RuntimeError, match="is_available"):
        PagedGenerator(tm)
    elsewhere = LlamaForCausalLM(LlamaConfig(**TINY), device="meta",
                                 seed=None)
    with pytest.raises(ValueError, match="lives on"):
        PagedGenerator(elsewhere, device="cpu")
