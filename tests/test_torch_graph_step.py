"""Port parity: the serving steps split into host planning and device
bodies — the pieces a CUDA graph captures — against the JAX package on
the CPU: the fixed-length KV write against ``_TracedPagedContext``'s
write (which drops the pads), the all-rows sampling tail against JAX's
``fused_sample``, the ragged step's device-side accept counts and draw
counters against ``JittedPagedDecoder.ragged_step``, and
``min_table_pages`` against the JAX engine.  The graphs themselves need
a card (``tests/test_torch_cuda_kernels.py -k graph``)."""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.paged import JittedPagedDecoder
from paddle_tpu.inference.paged import _TracedPagedContext
from paddle_tpu.inference.paged import fused_sample as jax_fused_sample
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.inference import paged
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.ops import paged_attention as tpa

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
KVH, D, PAGE, TOTAL = 2, 8, 4, 12


@pytest.fixture(scope="module")
def models():
    paddle.seed(4)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


def _caches(total=48, page=4, kv=None):
    jc = jpa.PagedKVCache(2, 2, 8, total_pages=total, page_size=page,
                          kv_dtype=kv)
    tc = tpa.PagedKVCache(2, 2, 8, total_pages=total, page_size=page,
                          kv_dtype=kv, device="cpu")
    return jc, tc


# ------------------------------------------------ the fixed-length write
# (rows, span bucket, real spans): a right-padded prompt bucket, and a
# ragged bucket whose last row is a pad row
WRITES = {"prefill": (2, 4, [3, 3]), "ragged": (4, 4, [1, 4, 2, 0])}


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("layout", sorted(WRITES))
def test_fixed_length_write_matches_jax_dropped_pads(layout, kv):
    """Every bucket position writes, pads aimed at the first real target
    with its value: the pools come out bit-equal to the JAX write, which
    drops the pads (aimed past the pool), over pools already holding
    data."""
    rows, span, spans = WRITES[layout]
    rng = np.random.default_rng(5)
    slots = rng.permutation(TOTAL * PAGE)[:sum(spans)]
    plans, jpg, jsl, at = [], [], [], 0
    for n in spans:
        t = slots[at:at + n]
        at += n
        if n:
            plans.append((t // PAGE, t % PAGE))
        jpg += list(t // PAGE) + [TOTAL] * (span - n)
        jsl += list(t % PAGE) + [0] * (span - n)
    x = rng.standard_normal((2, rows, span, KVH, D)).astype(np.float32)
    h = {k: np.zeros(rows * span, np.int64) for k in ("pg", "sl", "src")}
    paged._plan_writes(h, plans, span)

    store = np.int8 if kv else np.float32
    pools = [(rng.standard_normal((KVH, TOTAL, PAGE, D)) * 40).astype(store)
             for _ in range(2)]
    scales = [rng.random((KVH, TOTAL, PAGE, 1)).astype(np.float32)
              for _ in range(2)] if kv else []
    jctx = _TracedPagedContext(
        [jnp.asarray(pools[0])], [jnp.asarray(pools[1])],
        jnp.asarray(np.asarray(jpg, np.int32)),
        jnp.asarray(np.asarray(jsl, np.int32)),
        k_scales=[jnp.asarray(scales[0])] if kv else None,
        v_scales=[jnp.asarray(scales[1])] if kv else None)
    flat = x.reshape(2, rows * span, KVH, D).transpose(0, 2, 1, 3)
    jctx._scatter(0, jnp.asarray(flat[0]), jnp.asarray(flat[1]))

    cache = tpa.PagedKVCache(1, KVH, D, total_pages=TOTAL, page_size=PAGE,
                             kv_dtype=kv, device="cpu")
    cache.k_pages[0].copy_(torch.from_numpy(pools[0]))
    cache.v_pages[0].copy_(torch.from_numpy(pools[1]))
    if kv:
        cache.k_scales[0].copy_(torch.from_numpy(scales[0]))
        cache.v_scales[0].copy_(torch.from_numpy(scales[1]))
    ctx = paged.PagedContext(cache, "ragged", *(torch.from_numpy(h[k])
                                                for k in ("pg", "sl", "src")))
    ctx._write(0, torch.from_numpy(x[0]), cache.k_pages, cache.k_scales)
    ctx._write(0, torch.from_numpy(x[1]), cache.v_pages, cache.v_scales)
    got = [cache.k_pages[0], cache.v_pages[0]]
    want = [jctx.k_pages[0], jctx.v_pages[0]]
    if kv:
        got += [cache.k_scales[0], cache.v_scales[0]]
        want += [jctx.k_scales[0], jctx.v_scales[0]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the write's length is the bucket's whatever the spans
    assert h["pg"].size == rows * span


# ------------------------------------------------------ the sampling tail
@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_all_rows_fused_sample_bit_equal_to_jax(form):
    """Every row draws and ``flags`` selects on the device, from host
    arrays or from tensors alike, bit-equal to JAX's ``fused_sample``;
    the tail kind follows the host flags."""
    rng = np.random.default_rng(6)
    logits = (2 * rng.standard_normal((6, 300))).astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, 6, dtype=np.uint64).astype(np.uint32)
    ctrs = rng.integers(0, 4096, 6).astype(np.int32)
    temps = np.array([0.7, 1.0, 1.3, 1e-9, 2.0, 0.9], np.float32)
    flags = np.array([1, 0, 1, 1, 0, 0], bool)
    want = np.asarray(jax_fused_sample(
        *(jnp.asarray(a) for a in (logits, seeds, ctrs, temps, flags))))
    args = (seeds, ctrs, temps, flags)
    if form == "tensor":
        args = (torch.from_numpy(seeds.astype(np.int64)),
                torch.from_numpy(ctrs), torch.from_numpy(temps),
                torch.from_numpy(flags))
    got = paged.fused_sample(torch.from_numpy(logits), *args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert [paged._tail_kind(f) for f in (None, flags, ~np.ones(3, bool))] \
        == [False, "draw", "greedy"]


# ------------------------------------------------------ the ragged step
def _greedy_continuation(dec, cache, sid, first, n):
    """``n`` greedy tokens of ``sid`` after feeding ``first``, on copies
    of the decoder's cache (the caller's cache does not move)."""
    cache = copy.deepcopy(cache)
    out, tok = [], first
    for _ in range(n):
        ids, _acc = dec.ragged_step(cache, [sid], [[tok]],
                                    [cache.length(sid)],
                                    sampling=(np.zeros(1, np.uint32),
                                              np.ones(1, np.float32),
                                              np.zeros(1, bool)))
        tok = int(ids[0])
        out.append(tok)
    return out


def test_ragged_steps_match_jitted_decoder(models):
    """Prompt chunks at context 0, then a decode / chunk / verify mix with
    sampled and greedy rows, then a logits step: ids and accept counts
    equal ``JittedPagedDecoder.ragged_step``'s (logits within f32
    rounding), with the accept counts and draw counters computed on the
    device."""
    jm, tm = models
    jc, tc = _caches()
    jd, td = JittedPagedDecoder(jm), paged.PagedDecoder(tm)
    rng = np.random.default_rng(7)
    p = [rng.integers(0, 64, n).astype(np.int32) for n in (7, 20, 5)]

    def both(*args, **kw):
        want = jd.ragged_step(jc, *args, **kw)
        got = td.ragged_step(tc, *args, **kw)
        return want, got

    greedy3 = (np.zeros(3, np.uint32), np.ones(3, np.float32),
               np.zeros(3, bool))
    (w_ids, w_acc), (g_ids, g_acc) = both(
        [0, 1, 2], [p[0], p[1][:12], p[2]], [0, 0, 0], sampling=greedy3)
    np.testing.assert_array_equal(g_ids, w_ids)
    np.testing.assert_array_equal(g_acc, w_acc)
    # the verify row's drafts: the first two the model's own greedy
    # continuation, the third not
    cont = _greedy_continuation(td, tc, 2, int(g_ids[2]), 3)
    drafts = cont[:2] + [(cont[2] + 1) % 64]
    sampling = (np.array([11, 12, 13], np.uint32),
                np.array([0.8, 1.0, 1.2], np.float32),
                np.array([True, False, True]))
    (w_ids, w_acc), (g_ids, g_acc) = both(
        [0, 1, 2], [[int(g_ids[0])], p[1][12:], [int(g_ids[2])] + drafts],
        [7, 12, 5], n_drafts=[0, 0, 3], sampling=sampling)
    np.testing.assert_array_equal(g_acc, w_acc)
    assert g_acc.tolist() == [0, 0, 2]
    np.testing.assert_array_equal(g_ids, w_ids)
    # the verify row rolls back to its accepted length, as the caller does
    for c in (jc, tc):
        c.truncate(2, 5 + 1 + 2)
    (w_lg, w_acc), (g_lg, g_acc) = both(
        [0, 1, 2], [[int(g_ids[0])], [int(g_ids[1])], [int(g_ids[2])]],
        [8, 20, 8])
    np.testing.assert_array_equal(g_acc, w_acc)
    np.testing.assert_allclose(g_lg, w_lg, rtol=1e-5, atol=1e-5)


def test_static_buffers_stay_across_a_bucket(models):
    """Two steps of one bucket fill the same staging buffers in place."""
    _jm, tm = models
    _jc, tc = _caches()
    dec = paged.PagedDecoder(tm)
    dec.prefill(tc, [0], np.arange(6, dtype=np.int32)[None])
    greedy = (np.zeros(1, np.uint32), np.ones(1, np.float32),
              np.zeros(1, bool))
    ptrs = []
    for tok in (3, 9):
        dec.ragged_step(tc, [0], [[tok]], [tc.length(0)], sampling=greedy)
        key = ("ragged", "greedy", 1, 1, 2)
        inp, out = dec._staging[key]
        ptrs.append((inp._dev.data_ptr(), out._dev.data_ptr(),
                     inp.host["ids"].ctypes.data))
    assert ptrs[0] == ptrs[1]
    assert sorted(k[0] for k in dec._staging) == ["prefill", "ragged"]


# ------------------------------------------------------ min_table_pages
def _mixed_trace(engine):
    rng = np.random.default_rng(8)
    reqs = [engine.submit(rng.integers(0, 64, n).astype(np.int32),
                          max_new_tokens=6, do_sample=i == 1,
                          temperature=0.9, seed=30 + i)
            for i, n in enumerate((3, 19, 41))]
    return [r.result(timeout=300).tolist() for r in reqs]


@pytest.mark.parametrize("chunk", [None, 8], ids=["unchunked", "chunked"])
def test_min_table_pages_pins_one_width(models, chunk):
    """A mixed-length trace (3 to 47 tokens, pages of 4) runs at one
    table width under ``min_table_pages=32``, and the greedy and sampled
    streams equal the JAX engine's at the same floor."""
    jm, tm = models
    kw = dict(total_pages=64, page_size=4, max_batch=4,
              prefill_chunk_tokens=chunk, min_table_pages=32)
    with JaxEngine(jm, **kw) as eng:
        want = _mixed_trace(eng)
    with ContinuousBatchingEngine(tm, device="cpu", **kw) as eng:
        got = _mixed_trace(eng)
        keys = list(eng._decoder._staging)
        assert (eng.captures, eng.replays) == (0, 0)
    assert got == want
    widths = {k[4] for k in keys if k[0] in ("ragged", "prefix")}
    assert widths == {32}
    assert {k[0] for k in keys} == ({"ragged"} if chunk
                                    else {"prefill", "ragged"})


# ------------------------------------------------------ reset_pools
def test_reset_pools_zeroes_in_place(models):
    """``reset_pools`` keeps the pools' addresses (a captured graph stays
    valid), zeroes them, bumps ``generation``, drops the prefix index;
    a step after it equals the same step on a fresh cache."""
    _jm, tm = models
    dec = paged.PagedDecoder(tm)
    ids = np.arange(9, dtype=np.int32)[None]
    for kv in (None, "int8"):
        _jc, tc = _caches(kv=kv)
        pools = tc.k_pages + tc.v_pages + tc.k_scales + tc.v_scales
        ptrs = [t.data_ptr() for t in pools]
        dec.prefill(tc, [0], ids)
        tc.register_prefix(0, ids[0])
        tc.free(0)
        gen = tc.generation
        tc.reset_pools()
        assert [t.data_ptr() for t in pools] == ptrs
        assert all(not t.any() for t in pools)
        assert tc.generation == gen + 1 and tc.cached_prefix_pages == 0
        got = dec.prefill(tc, [1], ids)
        want = dec.prefill(_caches(kv=kv)[1], [1], ids)
        np.testing.assert_array_equal(got, want)


def test_graphed_decoder_needs_a_card(models):
    _jm, tm = models
    with pytest.raises(ValueError, match="card"):
        paged.GraphedPagedDecoder(tm)
    names = {fn.__name__ for fn in paged._counted_wrappers()}
    assert {"paged_attention_cuda", "flash_attention_cuda",
            "rms_norm_triton", "apply_rope_triton", "dynamic_act_quant_cuda",
            "weight_only_matmul_cuda", "w8a8_matmul_cuda"} <= names
