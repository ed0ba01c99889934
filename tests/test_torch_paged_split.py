"""Port parity: the split-KV algebra of the paged-attention kernels.

``_split_plain`` is the plain twin of what the CUDA kernels compute: each
context split's partial softmax state (m, l, acc), merged split by split
as the combine kernel merges them.  It is held here against the JAX
package's XLA oracles (``_ragged_xla``, ``_decode_xla``, ``_multi_xla``)
and its Pallas kernel in interpret mode, on the same seeded numpy
inputs, at splits that see no column, rows shorter than one split, a
last split cut short, rows with len == 0 and bucket-pad queries; and
``plan_splits``, the split planner, is checked as a pure function of
shapes."""
import functools
import inspect

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops import paged_attention as tpa

KVH, D, PAGE, TOTAL, WIDTH = 2, 16, 4, 24, 5     # 20 columns a row
MAX_Q = 4
# row 0: len 0 (a batch pad row); row 1 shorter than one split of 4; row
# 3 fills the table, so a split of 8 ends cut short at 20
LENS = np.array([0, 3, 9, 20], np.int32)
Q_LENS = np.array([1, 2, 3, 4], np.int32)
HEADS = {"mha": 2, "gqa": 4}                     # q heads over 2 kv heads
SPLITS = (4, 8, 12, 24)
# f32: the splits sum exp and p @ v in another order than the oracles;
# bf16: p is rounded to bf16 unnormalized per split here, normalized
# once in the XLA oracle and per page in the Pallas kernel, so the
# outputs may differ by a few bf16 ulps of the largest value
TOL = {"f32": 1e-5, "bf16": 2e-2}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(mode, heads, pages, seed=0):
    rng = np.random.default_rng(seed)
    qh = HEADS[heads]
    if pages == "int8":
        k = rng.integers(-127, 128, (KVH, TOTAL, PAGE, D)).astype(np.int8)
        v = rng.integers(-127, 128, (KVH, TOTAL, PAGE, D)).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, (KVH, TOTAL, PAGE, 1)).astype(
            np.float32)
        vs = rng.uniform(0.01, 0.1, (KVH, TOTAL, PAGE, 1)).astype(
            np.float32)
    else:
        k = rng.standard_normal((KVH, TOTAL, PAGE, D)).astype(np.float32)
        v = rng.standard_normal((KVH, TOTAL, PAGE, D)).astype(np.float32)
        ks = vs = None
    tables = rng.permutation(TOTAL)[:4 * WIDTH].reshape(4, WIDTH).astype(
        np.int32)
    max_q = 1 if mode == "decode" else MAX_Q
    q = rng.standard_normal((4, max_q, qh, D)).astype(np.float32)
    lens = LENS.copy()
    if mode == "decode":
        q_lens = np.ones(4, np.int32)
    elif mode == "multi":
        q_lens = np.full(4, MAX_Q, np.int32)
        lens = np.maximum(lens, MAX_Q)     # a verify block is in the pages
    else:
        q_lens = Q_LENS.copy()
    return q, k, v, ks, vs, lens, q_lens, tables


@functools.lru_cache(maxsize=None)
def _jax_refs(mode, dt, heads, pages):
    """The XLA oracle's and the interpret-mode Pallas kernel's outputs,
    (b, max_q, q_heads, d) f32."""
    q, k, v, ks, vs, lens, q_lens, tab = _inputs(mode, heads, pages)
    jdt = DTYPES[dt][1]
    jq = jnp.asarray(q, jdt)
    jk, jv = (jnp.asarray(x) if pages == "int8" else jnp.asarray(x, jdt)
              for x in (k, v))
    sc = {} if ks is None else dict(k_scales=jnp.asarray(ks),
                                    v_scales=jnp.asarray(vs))
    args = (jk, jv, jnp.asarray(lens))
    tabj = jnp.asarray(tab)
    scale = 1.0 / np.sqrt(D)
    if mode == "decode":
        outs = (jpa._decode_xla(jq[:, 0], *args, tabj, scale, **sc),
                jpa.paged_attention(jq[:, 0], *args, tabj, interpret=True,
                                    **sc))
        outs = [o[:, None] for o in outs]
    elif mode == "multi":
        outs = (jpa._multi_xla(jq, *args, tabj, scale, **sc),
                jpa.paged_attention_multi(jq, *args, tabj, interpret=True,
                                          **sc))
    else:
        ql = jnp.asarray(q_lens)
        outs = (jpa._ragged_xla(jq, *args, ql, tabj, scale, **sc),
                jpa.paged_attention_ragged(jq, *args, ql, tabj,
                                           interpret=True, **sc))
    return tuple(np.asarray(jnp.asarray(o, jnp.float32)) for o in outs)


def _split_twin(mode, dt, heads, pages, split):
    q, k, v, ks, vs, lens, q_lens, tab = _inputs(mode, heads, pages)
    tdt = DTYPES[dt][0]
    tq = torch.from_numpy(q).to(tdt)
    tk, tv = (torch.from_numpy(x) if pages == "int8"
              else torch.from_numpy(x).to(tdt) for x in (k, v))
    sc = {} if ks is None else dict(k_scales=torch.from_numpy(ks),
                                    v_scales=torch.from_numpy(vs))
    out = tpa._split_plain(tq, tk, tv, torch.from_numpy(lens),
                           torch.from_numpy(q_lens), torch.from_numpy(tab),
                           1.0 / np.sqrt(D), split, **sc)
    real = ((np.arange(q.shape[1])[None] < q_lens[:, None])
            & (lens[:, None] > 0))[:, :, None, None]
    return out.float().numpy(), real


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("pages", ["native", "int8"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["ragged", "decode", "multi"])
def test_split_merge_matches_xla_and_pallas(mode, dt, pages, heads, split):
    """The split twin against both JAX references at real positions
    (tolerance ``TOL`` times max(1, max |ref|)); pad queries and len == 0
    rows exactly 0, as the kernels write them."""
    got, real = _split_twin(mode, dt, heads, pages, split)
    assert np.all(got[~np.broadcast_to(real, got.shape)] == 0.0)
    for want in _jax_refs(mode, dt, heads, pages):
        tol = TOL[dt] * max(1.0, float(np.abs(want * real).max()))
        np.testing.assert_allclose(got * real, want * real, rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_split_merge_is_independent_of_the_split_in_f32_order(dt):
    """Every split of one input gives the ragged plain twin's values at
    real positions: f32 within 1e-6 (only the summation order moves), bf16
    within the bf16 tolerance (p rounds per split)."""
    q, k, v, _ks, _vs, lens, q_lens, tab = _inputs("ragged", "gqa",
                                                   "native", seed=3)
    tdt = DTYPES[dt][0]
    args = [torch.from_numpy(x) for x in (q, k, v)]
    args = [a.to(tdt) for a in args]
    meta = [torch.from_numpy(x) for x in (lens, q_lens, tab)]
    want = tpa._ragged_plain(*args, *meta, 1.0 / np.sqrt(D)).float()
    real = ((torch.arange(MAX_Q)[None] < meta[1][:, None])
            & (meta[0][:, None] > 0))[:, :, None, None]
    tol = 1e-6 if dt == "f32" else TOL["bf16"]
    for split in (PAGE, 2 * PAGE, 3 * PAGE, WIDTH * PAGE, 8 * PAGE):
        got = tpa._split_plain(*args, *meta, 1.0 / np.sqrt(D),
                               split).float()
        assert float(((got - want) * real).abs().max()) <= tol
        assert float((got * ~real).abs().max()) == 0.0


# (batch, max_q, q_heads, kv_heads, head_dim, table_width, page_size,
# sm_count): decode b8 and b1, GQA, long tables, a chunk bucket, verify
# spans, odd page sizes
PLAN_SHAPES = [
    (8, 1, 32, 32, 128, 128, 16, 132), (8, 1, 32, 32, 128, 256, 16, 132),
    (1, 1, 32, 32, 128, 256, 16, 132), (1, 1, 32, 8, 128, 4096, 16, 132),
    (8, 256, 32, 32, 128, 128, 16, 132), (4, 5, 32, 32, 128, 128, 16, 132),
    (8, 64, 32, 32, 128, 64, 16, 132), (8, 63, 32, 32, 128, 64, 16, 132),
    (16, 8, 8, 2, 64, 64, 16, 132), (3, 4, 4, 2, 16, 5, 4, 2),
    (2, 1, 4, 4, 64, 7, 3, 132), (8, 1, 32, 32, 128, 2048, 16, 132),
    (1, 1, 32, 32, 128, 8192, 16, 132), (256, 1, 32, 32, 128, 64, 16, 132),
    (1, 1, 8, 8, 64, 9000, 1, 132),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_splits_is_a_function_of_shapes(shape):
    """Splits are page multiples that cover the table's columns with no
    split wholly past them; no split exceeds ``MAX_SPLIT_PAGES``; a
    decode call of few rows splits into ``SPLIT_TOKENS``-column pieces, a
    grid of ``BLOCKS_PER_SM`` blocks an SM no further, and a chunk bucket
    not at all; the planner takes no lengths and gives the same plan
    every time."""
    b, max_q, qh, kvh, d, width, page, sms = shape
    assert not {"lengths", "q_lens", "lens"} & set(
        inspect.signature(tpa.plan_splits).parameters)
    for dtype in (torch.float32, torch.bfloat16):
        rows = tpa.block_rows(dtype, max_q * (qh // kvh))
        split, n = tpa.plan_splits(b, max_q, qh, kvh, d, width, page, rows,
                                   sms)
        assert (split, n) == tpa.plan_splits(b, max_q, qh, kvh, d, width,
                                             page, rows, sms)
        ctx = width * page
        assert split % page == 0
        assert split <= tpa.MAX_SPLIT_PAGES * page
        assert n >= 1 and n * split >= ctx and (n - 1) * split < ctx
        least = -(-width // tpa.MAX_SPLIT_PAGES)
        if max_q >= tpa.CHUNK_QUERIES:      # a chunk bucket: one split
            assert n <= least
        else:     # splits only while the grid is short of blocks
            blocks = b * kvh * -(-max_q * (qh // kvh) // rows)
            assert n <= max(-(-tpa.BLOCKS_PER_SM * sms // blocks), least)
        if max_q * (qh // kvh) < 16 and b * kvh * 8 <= sms:
            assert split == -(-tpa.SPLIT_TOKENS // page) * page


@pytest.mark.parametrize("dtype,rows,want", [
    (torch.bfloat16, 1, 1), (torch.bfloat16, 2, 4), (torch.bfloat16, 4, 4),
    (torch.bfloat16, 5, 16), (torch.bfloat16, 15, 16),
    (torch.bfloat16, 16, 64), (torch.bfloat16, 256, 64),
    (torch.float32, 1, 16), (torch.float32, 256, 16)])
def test_block_rows_follow_dtype_and_rows(dtype, rows, want):
    """bf16 blocks of 16 or more rows take the tensor-core kernel (64
    rows a block), fewer the CUDA-core kernel of 1, 4 or 16 rows; f32
    always the 16-row CUDA-core kernel."""
    assert tpa.block_rows(dtype, rows) == want
