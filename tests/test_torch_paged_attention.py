"""Port parity: paged attention and the paged KV cache of
paddle_tpu_torch against the JAX package — the Pallas kernel in
interpret mode, the ``_*_xla`` oracles, and ``PagedKVCache``'s
bookkeeping driven through the same operation scripts."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa

KVH, QH, D, PAGE, TOTAL = 2, 4, 16, 4, 24


def _pools(seed=0):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((KVH, TOTAL, PAGE, D)).astype(np.float32)
    v = rng.standard_normal((KVH, TOTAL, PAGE, D)).astype(np.float32)
    tables = rng.permutation(TOTAL)[:3 * 5].reshape(3, 5).astype(np.int32)
    return k, v, tables


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# f32 attention over <= 20 columns; the interpret kernel's online
# softmax sums in another order
ATOL = 1e-4


def test_decode_matches_pallas_and_xla():
    k, v, tab = _pools()
    q = np.random.default_rng(1).standard_normal((3, QH, D)).astype(
        np.float32)
    lens = np.array([1, 9, 20], np.int32)
    got = tpa.paged_attention(*_t(q, k, v, lens, tab)).numpy()
    scale = 1.0 / np.sqrt(D)
    for want in (jpa.paged_attention(*_j(q, k, v, lens, tab),
                                     interpret=True),
                 jpa._decode_xla(*_j(q, k, v, lens, tab), scale)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_multi_matches_pallas_and_xla():
    k, v, tab = _pools(1)
    q = np.random.default_rng(2).standard_normal((3, 4, QH, D)).astype(
        np.float32)
    lens = np.array([4, 11, 20], np.int32)
    got = tpa.paged_attention_multi(*_t(q, k, v, lens, tab)).numpy()
    scale = 1.0 / np.sqrt(D)
    for want in (jpa.paged_attention_multi(*_j(q, k, v, lens, tab),
                                           interpret=True),
                 jpa._multi_xla(*_j(q, k, v, lens, tab), scale)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_ragged_matches_pallas_and_xla():
    k, v, tab = _pools(2)
    q = np.random.default_rng(3).standard_normal((3, 4, QH, D)).astype(
        np.float32)
    lens = np.array([1, 9, 20], np.int32)
    q_lens = np.array([1, 3, 4], np.int32)
    got = tpa.paged_attention_ragged(*_t(q, k, v, lens, q_lens,
                                         tab)).numpy()
    scale = 1.0 / np.sqrt(D)
    for want in (jpa.paged_attention_ragged(*_j(q, k, v, lens, q_lens, tab),
                                            interpret=True),
                 jpa._ragged_xla(*_j(q, k, v, lens, q_lens, tab), scale)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_full_span_rows_equal_verify_and_max_q_1_equals_decode():
    k, v, tab = _pools(3)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 4, QH, D)).astype(np.float32)
    lens = np.array([5, 12, 20], np.int32)
    full = np.full(3, 4, np.int32)
    ragged = tpa.paged_attention_ragged(*_t(q, k, v, lens, full, tab))
    verify = tpa.paged_attention_multi(*_t(q, k, v, lens, tab))
    assert torch.equal(ragged, verify)
    q1 = q[:, :1]
    ones = np.ones(3, np.int32)
    ragged1 = tpa.paged_attention_ragged(*_t(q1, k, v, lens, ones, tab))
    decode = tpa.paged_attention(*_t(q1[:, 0], k, v, lens, tab))
    assert torch.equal(ragged1[:, 0], decode)


def test_cuda_wrapper_refuses_cpu_tensors():
    k, v, tab = _pools()
    q = np.zeros((3, 1, QH, D), np.float32)
    lens = np.ones(3, np.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_cuda(*_t(q, k, v, lens, lens, tab))


def test_scatter_pages_writes_in_place():
    pool = torch.zeros(KVH, 6, PAGE, D)
    vals = torch.randn(KVH, 3, D)
    pages = torch.tensor([5, 0, 5])
    slots = torch.tensor([1, 3, 2])
    tpa._scatter_pages(pool, pages, slots, vals)
    want = np.asarray(jpa._scatter_pages(jnp.zeros((KVH, 6, PAGE, D)),
                                         jnp.asarray(pages.numpy()),
                                         jnp.asarray(slots.numpy()),
                                         jnp.asarray(vals.numpy())))
    np.testing.assert_array_equal(pool.numpy(), want)


# ------------------------------------------------------ cache bookkeeping
P = np.arange(11, dtype=np.int32)
OLD = np.arange(5, dtype=np.int32)
NEW = np.arange(40, 45, dtype=np.int32)

# Operation scripts (the scenarios of tests/test_prefix_cache.py and
# tests/test_paged_attention.py).  Each step is (method, args); the
# observed values after every step must agree between the two caches.
SCRIPTS = {
    "aligned_hits": (8, 4, [
        ("allocate", (0, 11)), ("advance", ([0], 11)),
        ("register_prefix", (0, P)), ("probe_prefix", (P,)),
        ("probe_prefix", (np.array([0, 1, 2, 3, 4, 5, 63, 62, 61],
                                   np.int32),)),
        ("probe_prefix", (np.arange(50, 61, dtype=np.int32),)),
        ("probe_prefix", (P[:8],))]),
    "refcounts": (8, 4, [
        ("allocate", (0, 9)), ("advance", ([0], 9)),
        ("register_prefix", (0, P[:8])), ("free", (0,)),
        ("acquire_prefix", (1, P[:9])), ("acquire_prefix", (2, P[:9])),
        ("free", (1,)), ("free", (2,))]),
    "lru_eviction": (4, 4, [
        ("allocate", (0, 5)), ("advance", ([0], 5)),
        ("register_prefix", (0, OLD)), ("free", (0,)),
        ("allocate", (1, 5)), ("advance", ([1], 5)),
        ("register_prefix", (1, NEW)), ("free", (1,)),
        ("acquire_prefix", (9, NEW)), ("free", (9,)),
        ("allocate", (3, 12)), ("probe_prefix", (OLD,)),
        ("probe_prefix", (NEW,)), ("free", (3,))]),
    "pinned_survive_exhaustion": (3, 4, [
        ("allocate", (0, 5)), ("advance", ([0], 5)),
        ("register_prefix", (0, OLD)), ("acquire_prefix", (1, OLD)),
        ("allocate", (2, 4)), ("allocate", (3, 4)),
        ("probe_prefix", (OLD,)), ("length", (1,))]),
    "atomic_rollback": (6, 4, [
        ("allocate", (0, 2)), ("allocate", (1, 4)),
        ("allocate_batch_atomic", ([0, 1], [6, 5])),
        ("allocate_batch_atomic", ([0, 1], [12, 20])),
        ("truncate", (0, 1)), ("length", (0,)),
        ("plan_write", ([1], 3)), ("page_table", ([0, 1, 7],)),
        ("page_table", ([1], 4))]),
    "reset_pools": (8, 4, [
        ("allocate", (0, 9)), ("advance", ([0], 9)),
        ("register_prefix", (0, P[:9])), ("free", (0,)),
        ("reset_pools", ()), ("probe_prefix", (P[:9],))]),
}


def _state(cache):
    return {
        "free_pages": cache.free_pages,
        "pinned": cache.pinned_pages,
        "cached": cache.cached_prefix_pages,
        "evictions": cache.prefix_evictions,
        "generation": cache.generation,
        "free_list": sorted(cache._free),
        "tables": {k: list(v) for k, v in cache._seq_pages.items()},
        "lens": dict(cache._seq_len),
    }


def _run(cache, steps):
    trace = []
    for method, args in steps:
        try:
            out = getattr(cache, method)(*args)
            if isinstance(out, tuple):
                out = [np.asarray(o).tolist() for o in out]
        except RuntimeError as e:
            out = ("raised", "out of pages" in str(e))
        trace.append((method, out, _state(cache)))
    return trace


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_cache_bookkeeping_matches_jax(name):
    total, page, steps = SCRIPTS[name]
    jc = jpa.PagedKVCache(1, 2, 8, total_pages=total, page_size=page)
    tc = tpa.PagedKVCache(1, 2, 8, total_pages=total, page_size=page,
                          device="cpu")
    assert _run(tc, steps) == _run(jc, steps)


def test_exhaustion_raises_pages_exhausted():
    c = tpa.PagedKVCache(1, 2, 8, total_pages=2, page_size=4, device="cpu")
    c.allocate(0, 8)
    with pytest.raises(tpa.PagesExhausted):
        c.allocate(1, 1)
    assert issubclass(tpa.PagesExhausted, RuntimeError)


# ------------------------------------------------------------ int8 mode
def _int8_pools(seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, (KVH, TOTAL, PAGE, D)).astype(np.int8)
    v = rng.integers(-127, 128, (KVH, TOTAL, PAGE, D)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, (KVH, TOTAL, PAGE, 1)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, (KVH, TOTAL, PAGE, 1)).astype(np.float32)
    tables = rng.permutation(TOTAL)[:3 * 5].reshape(3, 5).astype(np.int32)
    return k, v, ks, vs, tables


def _close_int8(got, want):
    # f32 attention over dequantized values; the interpret kernel's
    # online softmax sums in another order
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["decode", "multi", "ragged"])
def test_int8_pages_match_pallas_and_xla(mode):
    k, v, ks, vs, tab = _int8_pools(10)
    rng = np.random.default_rng(11)
    scale = 1.0 / np.sqrt(D)
    if mode == "decode":
        q = rng.standard_normal((3, QH, D)).astype(np.float32)
        lens = np.array([1, 9, 20], np.int32)
        args = (q, k, v, lens, tab)
        got = tpa.paged_attention(*_t(*args), k_scales=torch.from_numpy(ks),
                                  v_scales=torch.from_numpy(vs)).numpy()
        wants = (jpa.paged_attention(*_j(*args), interpret=True,
                                     k_scales=jnp.asarray(ks),
                                     v_scales=jnp.asarray(vs)),
                 jpa._decode_xla(*_j(*args), scale, k_scales=jnp.asarray(ks),
                                 v_scales=jnp.asarray(vs)))
    elif mode == "multi":
        q = rng.standard_normal((3, 4, QH, D)).astype(np.float32)
        lens = np.array([4, 11, 20], np.int32)
        args = (q, k, v, lens, tab)
        got = tpa.paged_attention_multi(
            *_t(*args), k_scales=torch.from_numpy(ks),
            v_scales=torch.from_numpy(vs)).numpy()
        wants = (jpa.paged_attention_multi(*_j(*args), interpret=True,
                                           k_scales=jnp.asarray(ks),
                                           v_scales=jnp.asarray(vs)),
                 jpa._multi_xla(*_j(*args), scale, k_scales=jnp.asarray(ks),
                                v_scales=jnp.asarray(vs)))
    else:
        q = rng.standard_normal((3, 4, QH, D)).astype(np.float32)
        lens = np.array([1, 9, 20], np.int32)
        q_lens = np.array([1, 3, 4], np.int32)
        args = (q, k, v, lens, q_lens, tab)
        got = tpa.paged_attention_ragged(
            *_t(*args), k_scales=torch.from_numpy(ks),
            v_scales=torch.from_numpy(vs)).numpy()
        wants = (jpa.paged_attention_ragged(*_j(*args), interpret=True,
                                            k_scales=jnp.asarray(ks),
                                            v_scales=jnp.asarray(vs)),
                 jpa._ragged_xla(*_j(*args), scale, k_scales=jnp.asarray(ks),
                                 v_scales=jnp.asarray(vs)))
    for want in wants:
        _close_int8(got, want)


def test_int8_full_span_rows_equal_verify_and_max_q_1_equals_decode():
    k, v, ks, vs, tab = _int8_pools(12)
    sc = dict(k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    q = np.random.default_rng(13).standard_normal((3, 4, QH, D)).astype(
        np.float32)
    lens = np.array([5, 12, 20], np.int32)
    full = np.full(3, 4, np.int32)
    ragged = tpa.paged_attention_ragged(*_t(q, k, v, lens, full, tab), **sc)
    verify = tpa.paged_attention_multi(*_t(q, k, v, lens, tab), **sc)
    assert torch.equal(ragged, verify)
    ones = np.ones(3, np.int32)
    ragged1 = tpa.paged_attention_ragged(*_t(q[:, :1], k, v, lens, ones,
                                             tab), **sc)
    decode = tpa.paged_attention(*_t(q[:, 0], k, v, lens, tab), **sc)
    assert torch.equal(ragged1[:, 0], decode)


def test_int8_cache_pools_bytes_and_reset():
    c = tpa.PagedKVCache(2, KVH, D, total_pages=8, page_size=PAGE,
                         kv_dtype="int8", device="cpu")
    base = tpa.PagedKVCache(2, KVH, D, total_pages=8, page_size=PAGE,
                            device="cpu")
    jc = jpa.PagedKVCache(2, KVH, D, total_pages=8, page_size=PAGE,
                          kv_dtype="int8")
    assert c.kv_quant and c.k_pages[0].dtype == torch.int8
    assert c.k_scales[0].shape == (KVH, 8, PAGE, 1)
    assert c.k_scales[0].dtype == torch.float32
    assert (c.kv_pool_bytes, c.kv_scale_bytes) == (jc.kv_pool_bytes,
                                                   jc.kv_scale_bytes)
    # int8 pages hold a quarter of the f32 pages' bytes
    assert c.kv_pool_bytes * 4 == base.kv_pool_bytes
    assert base.kv_scale_bytes == 0
    c.k_scales[1].fill_(3.0)
    gen = c.generation
    c.reset_pools()
    assert c.generation == gen + 1
    assert float(c.k_scales[1].abs().max()) == 0.0
    assert c.k_pages[0].dtype == torch.int8
    with pytest.raises(ValueError, match="kv_dtype"):
        tpa.PagedKVCache(1, KVH, D, kv_dtype="fp4", device="cpu")
