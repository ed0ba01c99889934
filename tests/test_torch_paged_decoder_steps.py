"""Port parity: the rest of the paged decoder — the cache's eager write,
the eager oracle (``EagerPagedContext``), ``step``, ``verify``,
``multi_step`` and ``batch_context_prefill`` — against the JAX package
on the CPU: the same numpy weights and inputs through
``JittedPagedDecoder`` / ``_PagedContext`` and their port counterparts,
in f32, with int8 KV pages and with w8a8 weights.  Ids and accept counts
must be equal, f32 logits within 1e-5.  ``PagedGenerator`` and the
failure contract are in ``tests/test_torch_paged_generator.py``; the
graphs need a card (``tests/test_torch_paged_generator_card.py``)."""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework.tape import no_grad as jax_no_grad
from paddle_tpu.framework.tensor import wrap_array
from paddle_tpu.inference.paged import JittedPagedDecoder
from paddle_tpu.inference.paged import _PagedContext
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.inference import paged
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.ops import paged_attention as tpa

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
LAYERS, KVH, D = 2, 2, 8
# (quantize, kv_dtype): f32, int8 KV pages, w8a8 weights
MODES = [(None, None), (None, "int8"), ("w8a8", None)]
MODE_IDS = ["f32", "int8kv", "w8a8"]


@pytest.fixture(scope="module")
def models():
    paddle.seed(4)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


@pytest.fixture(scope="module")
def decoders(models):
    """One JAX and one port decoder a quantize mode, shared by the tests
    (JAX compiles each program once)."""
    jm, tm = models
    made = {}

    def get(quant):
        if quant not in made:
            made[quant] = (JittedPagedDecoder(jm, quantize=quant),
                           paged.PagedDecoder(tm, quantize=quant))
        return made[quant]
    return get


def _caches(kv=None, total=48, page=4):
    return (jpa.PagedKVCache(LAYERS, KVH, D, total_pages=total,
                             page_size=page, kv_dtype=kv),
            tpa.PagedKVCache(LAYERS, KVH, D, total_pages=total,
                             page_size=page, kv_dtype=kv, device="cpu"))


def _pools(cache):
    """Every pool of a JAX or port cache, as numpy arrays."""
    return [np.asarray(t) for t in list(cache.k_pages) + list(cache.v_pages)
            + list(cache.k_scales) + list(cache.v_scales)]


def _same_pools(jc, tc, exact=False):
    """The two caches' pools: bit-equal, or f32 values within rounding
    (int8 codes always equal)."""
    for w, g in zip(_pools(jc), _pools(tc)):
        if exact or g.dtype == np.int8:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def _prefilled(decoders, quant, kv, lens=(7, 13, 5), seed=0):
    """Both caches holding three prompts (one ragged step at context 0);
    returns the decoders, the caches and each row's greedy next token."""
    jd, td = decoders(quant)
    jc, tc = _caches(kv)
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 64, n).astype(np.int32) for n in lens]
    want, _ = jd.ragged_step(jc, [0, 1, 2], rows, [0, 0, 0])
    got, _ = td.ragged_step(tc, [0, 1, 2], rows, [0, 0, 0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    return jd, td, jc, tc, want.argmax(-1).astype(np.int32)


# --------------------------------------------------------- the eager write
@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_write_batch_matches_jax(kv):
    """``write_batch`` (and ``write``) append a step's K/V at the
    allocator's targets, one scatter a pool, quantized on the way in for
    int8 pages: every pool bit-equal to the JAX cache's, over pools that
    already hold data; the last layer's write advances the lengths."""
    rng = np.random.default_rng(1)
    jc, tc = _caches(kv)
    store = np.int8 if kv else np.float32
    for jp, tp in zip([jc.k_pages, jc.v_pages], [tc.k_pages, tc.v_pages]):
        for layer in range(LAYERS):
            a = (rng.standard_normal(tp[layer].shape) * 40).astype(store)
            jp[layer] = jnp.asarray(a)
            tp[layer].copy_(torch.from_numpy(a))
    for sid, n in enumerate((3, 6, 1)):
        for c in (jc, tc):
            c.allocate(sid, n + 4)
            c.advance([sid], n)
    k, v = (rng.standard_normal((3, 2, KVH, D)).astype(np.float32)
            for _ in range(2))
    for layer in range(LAYERS):
        jc.write_batch(layer, [0, 1, 2], jnp.asarray(k), jnp.asarray(v))
        tc.write_batch(layer, [0, 1, 2], torch.from_numpy(k),
                       torch.from_numpy(v))
        want = [3, 6, 1] if layer < LAYERS - 1 else [5, 8, 3]
        assert [tc.length(s) for s in range(3)] == want
    for layer in range(LAYERS):
        jc.write(layer, 1, jnp.asarray(k[0]), jnp.asarray(v[0]))
        tc.write(layer, 1, torch.from_numpy(k[0]), torch.from_numpy(v[0]))
    assert [tc.length(s) for s in range(3)] == \
        [jc.length(s) for s in range(3)] == [5, 10, 3]
    _same_pools(jc, tc, exact=True)


# ---------------------------------------------------------- the eager oracle
def _eager_decode(model, cache, ids, ctx_cls, to_ids, logits_of):
    """Prefill ``ids`` through the eager context, then one greedy decode
    token; returns both steps' last logits."""
    b, s = ids.shape
    for sid in range(b):
        cache.allocate(sid, s)
    pre = logits_of(model, to_ids(ids), 0, ctx_cls(cache, range(b), True))
    nxt = pre.argmax(-1).astype(np.int32)[:, None]
    for sid in range(b):
        cache.allocate(sid, 1)
    dec = logits_of(model, to_ids(nxt), s, ctx_cls(cache, range(b), False))
    return pre, dec, nxt


def _jax_logits(model, ids, pos, ctx):
    with jax_no_grad():
        hidden = model.model(ids, pos, paged_ctx=ctx)
        return np.asarray(model._logits_of(hidden)._data[:, -1], np.float32)


@torch.no_grad()
def _port_logits(model, ids, pos, ctx):
    hidden = model.model(ids, pos, paged_ctx=ctx)
    return model._logits_of(hidden)[:, -1].float().numpy()


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
def test_eager_context_matches_jax_and_the_step(models, decoders, kv):
    """``EagerPagedContext`` against JAX's ``_PagedContext``: prefill and
    decode logits within 2e-5, pools alike; and ``PagedDecoder.step``'s
    device body agrees with the oracle (the JAX package's own
    eager-vs-jitted check)."""
    jm, tm = models
    ids = np.random.default_rng(2).integers(0, 64, (2, 7)).astype(np.int32)
    jc, tc = _caches(kv)
    j_pre, j_dec, _ = _eager_decode(
        jm, jc, ids, _PagedContext, lambda a: wrap_array(jnp.asarray(a)),
        _jax_logits)
    t_pre, t_dec, nxt = _eager_decode(
        tm, tc, ids, paged.EagerPagedContext,
        lambda a: torch.from_numpy(a.astype(np.int64)), _port_logits)
    np.testing.assert_allclose(t_pre, j_pre, atol=2e-5)
    np.testing.assert_allclose(t_dec, j_dec, atol=2e-5)
    assert [tc.length(s) for s in (0, 1)] == [8, 8]
    _same_pools(jc, tc)
    # the decode step's device body against the oracle
    _jc2, tc2 = _caches(kv)
    td = decoders(None)[1]
    td.prefill(tc2, [0, 1], ids)
    got = td.step(tc2, [0, 1], nxt, np.full(2, 7, np.int32))
    np.testing.assert_allclose(got, t_dec, atol=2e-5)


# ------------------------------------------------------------------ step
@pytest.mark.parametrize("quant,kv", MODES, ids=MODE_IDS)
def test_step_matches_jitted_decoder(decoders, quant, kv):
    """``step``: logits within rtol 1e-5 of ``JittedPagedDecoder.step``,
    greedy and drawn ids equal (the draw's counters from the host), the
    pools alike after three steps."""
    jd, td, jc, tc, nxt = _prefilled(decoders, quant, kv)
    seqs, pos = [0, 1, 2], np.array([7, 13, 5], np.int32)
    want = jd.step(jc, seqs, nxt[:, None], pos)
    got = td.step(tc, seqs, nxt[:, None], pos)
    assert got.shape == (3, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    greedy = (np.zeros(3, np.uint32), pos + 1, np.ones(3, np.float32),
              np.zeros(3, bool))
    tok = want.argmax(-1).astype(np.int32)[:, None]
    want = jd.step(jc, seqs, tok, pos + 1, sampling=greedy)
    got = td.step(tc, seqs, tok, pos + 1, sampling=greedy)
    np.testing.assert_array_equal(got, want)
    draw = (np.array([11, 12, 13], np.uint32), pos + 2,
            np.array([0.8, 1.0, 1.3], np.float32),
            np.array([True, False, True]))
    want = jd.step(jc, seqs, want[:, None], pos + 2, sampling=draw)
    got = td.step(tc, seqs, got[:, None], pos + 2, sampling=draw)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert [tc.length(s) for s in seqs] == [jc.length(s) for s in seqs]
    _same_pools(jc, tc)


# ---------------------------------------------------------------- verify
def _drafts(td, tc, seqs, first, n):
    """The model's own greedy continuation of ``first`` for ``n``
    tokens, on a copy of the cache."""
    cache = copy.deepcopy(tc)
    pos = np.asarray([cache.length(s) for s in seqs], np.int32)
    return td.multi_step(cache, seqs, first, pos, n)


@pytest.mark.parametrize("quant,kv", MODES, ids=MODE_IDS)
def test_verify_matches_jitted_and_full_span_ragged(decoders, quant, kv):
    """``verify``: accept counts and bonus ids (greedy and drawn at
    pos + accept + 1, computed on the device) equal to
    ``JittedPagedDecoder.verify`` and to the port's ragged step over the
    same blocks as full-span verify rows; the logits escape hatch
    within 1e-5."""
    jd, td, jc, tc, nxt = _prefilled(decoders, quant, kv)
    seqs, pos = [0, 1, 2], np.array([7, 13, 5], np.int32)
    cont = _drafts(td, tc, seqs, nxt, 3)
    block = np.concatenate([nxt[:, None], cont], axis=1)
    block[1, 2] = (block[1, 2] + 1) % 64      # row 1 accepts 1 draft
    block[2, 1] = (block[2, 1] + 1) % 64      # row 2 accepts none
    snap = copy.deepcopy(tc)
    draw = (np.array([5, 6, 7], np.uint32),
            np.array([0.9, 1.0, 1.1], np.float32),
            np.array([True, False, True]))
    for sampling in (None, draw[:2] + (np.zeros(3, bool),), draw):
        for c in (jc, tc, snap):
            for s, p in zip(seqs, pos):
                c.truncate(s, int(p))
        w_out, w_acc = jd.verify(jc, seqs, block, pos, sampling=sampling)
        g_out, g_acc = td.verify(tc, seqs, block, pos, sampling=sampling)
        r_out, r_acc = td.ragged_step(snap, seqs, list(block), list(pos),
                                      n_drafts=[3, 3, 3], sampling=sampling)
        assert g_acc.tolist() == w_acc.tolist() == r_acc.tolist() \
            == [3, 1, 0]
        if sampling is None:
            np.testing.assert_allclose(g_out, w_out, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(r_out, g_out, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(g_out, w_out)
            np.testing.assert_array_equal(r_out, g_out)
        # every block position was written; the caller truncates
        assert [tc.length(s) for s in seqs] == (pos + 4).tolist()


# ------------------------------------------------------------ multi_step
@pytest.mark.parametrize("quant,kv", MODES, ids=MODE_IDS)
def test_multi_step_matches_jitted_decoder(decoders, quant, kv):
    """``multi_step`` with N not a power of two: the tokens equal
    ``JittedPagedDecoder.multi_step``'s, and the pools alike; its plan
    goes up and its tokens come back in one copy each."""
    jd, td, jc, tc, nxt = _prefilled(decoders, quant, kv)
    seqs, pos = [0, 1, 2], np.array([7, 13, 5], np.int32)
    want = jd.multi_step(jc, seqs, nxt, pos, 5)
    downloads = []
    real = paged._Staging.download
    paged._Staging.download = lambda st: downloads.append(1) or real(st)
    try:
        got = td.multi_step(tc, seqs, nxt, pos, 5)
    finally:
        paged._Staging.download = real
    assert got.shape == (3, 5) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert downloads == [1]
    assert ("multi", "greedy", 3, 8, 8) in td._staging
    assert [tc.length(s) for s in seqs] == (pos + 5).tolist()
    _same_pools(jc, tc)
    # a second run of 7 steps shares the bucket of 8
    keys = set(td._staging)
    want = jd.multi_step(jc, seqs, want[:, -1].copy(), pos + 5, 7)
    got = td.multi_step(tc, seqs, got[:, -1].copy(), pos + 5, 7)
    np.testing.assert_array_equal(got, want)
    assert set(td._staging) == keys


def test_multi_step_exhaustion_leaves_nothing_reserved(decoders):
    """A run whose pages the pool cannot hold raises "out of pages"
    (``PagesExhausted``), with the lengths and the free pages as
    before, as in JAX."""
    jd, td = decoders(None)
    ids = np.arange(10, dtype=np.int32).reshape(2, 5)
    for dec, cache in zip((jd, td), _caches(total=6)):
        dec.prefill(cache, [0, 1], ids)
        with pytest.raises(RuntimeError, match="out of pages") as err:
            dec.multi_step(cache, [0, 1], np.array([1, 2], np.int32),
                           np.array([5, 5], np.int32), 8)
        assert cache.free_pages == 2
        assert [cache.length(s) for s in (0, 1)] == [5, 5]
    assert isinstance(err.value, tpa.PagesExhausted)


# ------------------------------------------------- batch_context_prefill
@pytest.mark.parametrize("quant,kv", MODES, ids=MODE_IDS)
def test_batch_context_prefill_matches_jitted_decoder(decoders, quant, kv):
    """Three rows at contexts 13, 0 and 5 (a fresh prefill among them),
    the batch bucketed to 4: logits within 1e-5, greedy and drawn ids
    equal to JAX's, through the prefix step's bucket."""
    jd, td, jc, tc, _nxt = _prefilled(decoders, quant, kv, lens=(7, 13, 5))
    rng = np.random.default_rng(3)
    seqs, ks = [1, 9, 2], [13, 0, 5]
    for sampling in (None, (np.array([3, 4, 5], np.uint32),
                            np.array([20, 6, 11], np.int32),
                            np.ones(3, np.float32),
                            np.array([True, False, True]))):
        rows = [rng.integers(0, 64, n).astype(np.int32) for n in (6, 3, 5)]
        for c in (jc, tc):
            for s, k in zip(seqs, ks):
                c.truncate(s, k)
        want = jd.batch_context_prefill(jc, seqs, rows, ks,
                                        sampling=sampling)
        got = td.batch_context_prefill(tc, seqs, rows, ks,
                                       sampling=sampling)
        if sampling is None:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)
        assert [tc.length(s) for s in seqs] == [19, 3, 10]
    assert {k[:4] for k in td._staging if k[0] == "prefix"} == \
        {("prefix", False, 4, 8), ("prefix", "draw", 4, 8)}
    _same_pools(jc, tc)
