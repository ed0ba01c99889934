"""Port parity: FlashMask attention of paddle_tpu_torch against the JAX
package on the same numpy inputs.  The plain forward and backward (what
the port's CUDA kernels compute on the card) against the Pallas kernels
in interpret mode, fully masked rows included; the skip table bit for
bit against ``_skip_table``; ``F.flashmask_attention`` and its autograd
gradients against JAX's ``F.flashmask_attention`` and ``jax.grad`` on the
CPU (the dense path), with GQA, sq != sk and a length off the tiles."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.ops.pallas.flashmask_attention as JFM
from paddle_tpu.nn.functional.attention import _flashmask_attention
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flashmask_attention as TFM
from paddle_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE


def _intervals(kind, b, hm, sq, sk, seed=1):
    """(b, hm, sk, ncol) int32 intervals of one kind, from a numpy seed."""
    rng = np.random.default_rng(seed)
    j = np.arange(sk)
    shape = (b, hm, sk)

    def full(x):
        return np.broadcast_to(x, shape)

    if kind == "1col":       # column j masks rows from j + 8..64 on
        cols = [np.minimum(j + rng.integers(8, 64, shape), sq)]
    elif kind == "2col":     # random bands [start, end)
        start = rng.integers(0, sq, shape)
        cols = [start, start + rng.integers(0, sq - start + 1)]
    elif kind == "4col":     # rows [j - 64, j + 16) see column j
        cols = [full(np.minimum(j + 16, sq)), full(sq), full(0),
                full(np.maximum(j - 64, 0))]
    elif kind == "masked_rows":   # rows [40, 90) masked by every column
        cols = [full(40), full(90)]
    elif kind == "window":   # a sliding window of 64 (Mistral's form)
        cols = [full(np.minimum(j + 64, sq)), full(sq)]
    else:
        raise ValueError(kind)
    return np.stack(cols, -1).astype(np.int32)


def _dense_keep(idx, h, sq, causal):
    """numpy KEEP mask (b, h, sq, sk) of the intervals, as the JAX dense
    path builds it."""
    rows = np.arange(sq)[:, None]
    se = np.repeat(idx, h // idx.shape[1], axis=1)[:, :, None]  # b,h,1,sk,c
    ncol = idx.shape[-1]
    masked = (rows >= se[..., 0]) & (rows < (sq if ncol == 1
                                             else se[..., 1]))
    if ncol == 4:
        masked |= (rows >= se[..., 2]) & (rows < se[..., 3])
    if causal:
        masked |= rows < np.arange(idx.shape[2])[None, :]
    return ~masked


def _qkv(b, h, kvh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, k, v, do


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# name: (b, h, hm, s, d, kind, causal); the Pallas kernels have no GQA
PALLAS_CASES = {
    "1col": (1, 2, 1, 256, 64, "1col", False),
    "1col_causal": (1, 2, 1, 256, 64, "1col", True),
    "2col_causal": (1, 2, 1, 256, 64, "2col", True),
    "4col": (1, 2, 1, 256, 64, "4col", False),
    "masked_rows": (1, 2, 1, 256, 64, "masked_rows", False),
    "mask_heads_2_of_4": (1, 4, 2, 256, 64, "2col", True),
}
BACKWARD_CASES = ("1col_causal", "4col", "masked_rows", "mask_heads_2_of_4")


def _pallas_inputs(name):
    b, h, hm, s, d, kind, causal = PALLAS_CASES[name]
    q, k, v, do = _qkv(b, h, h, s, s, d)
    return q, k, v, do, _intervals(kind, b, hm, s, s), causal


@pytest.mark.parametrize("name", sorted(PALLAS_CASES))
def test_plain_forward_matches_pallas_interpret(name):
    q, k, v, _, idx, causal = _pallas_inputs(name)
    out, lse = TFM.flashmask_attention_plain(*_t(q, k, v, idx), causal)
    jout, jlse = JFM.flashmask_attention_forward(
        *(jnp.asarray(a) for a in (q, k, v, idx)), causal, block_q=128,
        block_kv=128, interpret=True)
    _close(out, jout, 1e-5)
    _close(lse, jlse, 1e-5)
    # 48-column blocks carry the online softmax across blocks, through
    # blocks that mask a row whole
    out48, lse48 = TFM.flashmask_attention_plain(*_t(q, k, v, idx), causal,
                                                 block_kv=48)
    _close(out48, jout, 1e-5)
    _close(lse48, jlse, 1e-5)
    dead = ~_dense_keep(idx, q.shape[1], q.shape[2], causal).any(-1)
    if name == "masked_rows":
        assert dead.sum() == 2 * 50
    # fully masked rows: zeros and lse DEFAULT_MASK_VALUE, as Pallas
    assert np.abs(out.numpy()[dead]).max(initial=0.0) == 0.0
    assert (lse.numpy()[dead] == np.float32(DEFAULT_MASK_VALUE)).all()
    assert (np.asarray(jlse)[dead] == lse.numpy()[dead]).all()


@pytest.mark.parametrize("name", BACKWARD_CASES)
def test_plain_backward_matches_pallas_interpret(name):
    q, k, v, do, idx, causal = _pallas_inputs(name)
    out, lse = TFM.flashmask_attention_plain(*_t(q, k, v, idx), causal)
    got = TFM.flashmask_attention_backward(
        *_t(q, k, v), out, lse, *_t(do, idx), causal)
    want = JFM.flashmask_attention_backward(
        *(jnp.asarray(a) for a in (q, k, v, out.numpy(), lse.numpy(), do,
                                   idx)),
        causal, block_q=128, block_kv=128, interpret=True)
    small = TFM.flashmask_attention_backward_plain(
        *_t(q, k, v), out, lse, *_t(do, idx), causal, block_kv=48)
    for g, g48, w in zip(got, small, want):
        assert torch.isfinite(g).all()
        _close(g, w, 1e-4)
        _close(g48, w, 1e-4)
    if name == "masked_rows":
        assert float(got[0][:, :, 40:90].abs().max()) == 0.0


# (kind, hm, causal): 1-, 2- and 4-column masks at s 200, GQA 4 over 2
DS_BF16_CASES = [("1col", 1, True), ("2col", 2, False), ("4col", 2, True)]


def _dq_bf16_ds(q, k, v, out, lse, do, idx, causal):
    """dq of the plain backward with dS rounded to bf16 before dQ += dS K,
    as the bf16 tensor-core dQ kernel takes it (the JAX kernel takes that
    product in f32).  Layout (b, h, s, d), GQA through kv head h / group."""
    h, sq, d = q.shape[1], q.shape[2], q.shape[3]
    kf, vf = TFM._repeat_kv(k, v, h)
    rows = torch.arange(sq)[:, None]
    cols = torch.arange(k.shape[2])[None, :]
    keep = TFM._keep(TFM._heads(idx, h), rows, cols, idx.shape[-1], causal)
    scale = d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, kf) * scale
    p = torch.exp(torch.where(keep, s - lse[..., None], -np.inf))
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    delta = (out * do).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bhkd->bhqd", ds, kf)


@pytest.mark.parametrize("kind,hm,causal", DS_BF16_CASES)
def test_bf16_ds_in_dq_stays_near_pallas_dq(kind, hm, causal):
    """The size of the bf16 dQ kernel's one divergence: rounding dS to
    bf16 before dQ += dS K moves dq by well under relative L2 1e-2 from
    the Pallas ``_bwd_dq_kernel`` (interpret mode; K/V repeated to the q
    heads, as the Pallas kernels take no GQA), and by more than the f32
    plain backward, which holds 1e-4."""
    b, h, kvh, s, d = 1, 4, 2, 200, 64
    q, k, v, do = _qkv(b, h, kvh, s, s, d, seed=3)
    idx = _intervals(kind, b, hm, s, s, seed=4)
    out, lse = TFM.flashmask_attention_plain(*_t(q, k, v, idx), causal)
    want = JFM.flashmask_attention_backward(
        *(jnp.asarray(a) for a in (q, np.repeat(k, h // kvh, 1),
                                   np.repeat(v, h // kvh, 1), out.numpy(),
                                   lse.numpy(), do, idx)),
        causal, block_q=128, block_kv=128, interpret=True)[0]
    want = torch.from_numpy(np.array(want))
    got = _dq_bf16_ds(*_t(q, k, v), out, lse, *_t(do, idx), causal)
    exact = TFM.flashmask_attention_backward_plain(
        *_t(q, k, v), out, lse, *_t(do, idx), causal)[0]
    rel = float((got - want).norm() / want.norm())
    rel_exact = float((exact - want).norm() / want.norm())
    assert torch.isfinite(got).all()
    assert rel <= 1e-2
    assert rel_exact < 1e-5 < rel


# name: (b, h, kvh, hm, sq, sk, d, kind, causal); every row keeps a
# column, since the JAX dense path differs from the kernels on a fully
# masked row (the mean of v there, not zeros)
DENSE_CASES = {
    "gqa_4_over_2": (1, 4, 2, 1, 128, 128, 64, "1col", True),
    "sq192_sk256": (1, 2, 2, 2, 192, 256, 64, "4col", False),
    "s200_ragged": (2, 2, 1, 1, 200, 200, 64, "4col", True),
    "gqa_mask_per_head": (2, 4, 1, 4, 200, 200, 64, "1col", False),
}


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_functional_and_grads_match_jax_dense(name):
    b, h, kvh, hm, sq, sk, d, kind, causal = DENSE_CASES[name]
    q, k, v, w = (np.swapaxes(a, 1, 2) for a in _qkv(b, h, kvh, sq, sk, d))
    idx = _intervals(kind, b, hm, sq, sk)
    assert _dense_keep(idx, h, sq, causal).any(-1).all()
    jout = JF.flashmask_attention(*(paddle.to_tensor(a)
                                    for a in (q, k, v, idx)),
                                  causal=causal)

    def jloss(q_, k_, v_):
        return jnp.sum(_flashmask_attention.raw_fn(q_, k_, v_,
                                                   jnp.asarray(idx), causal)
                       * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = TF.flashmask_attention(tq, tk, tv, torch.from_numpy(idx),
                                 causal=causal)
    _close(out.detach(), jout._data, 1e-5)
    (out * torch.from_numpy(np.ascontiguousarray(w))).sum().backward()
    for g, want_g in zip((tq.grad, tk.grad, tv.grad), want):
        _close(g, want_g, 1e-4)
    assert tk.grad.shape == (b, sk, kvh, d)


SKIP_CASES = [  # (kind, hm, sq, sk, causal)
    ("1col", 1, 256, 256, False), ("1col", 2, 384, 384, True),
    ("2col", 2, 200, 328, True), ("4col", 1, 512, 512, False),
    ("4col", 2, 300, 300, True), ("window", 1, 512, 512, True)]


@pytest.mark.parametrize("kind,hm,sq,sk,causal", SKIP_CASES)
def test_skip_table_bit_equal_to_jax(kind, hm, sq, sk, causal):
    h, b = 4, 2
    idx = _intervals(kind, b, hm, sq, sk)
    q, k, v, _ = _qkv(b, h, h, sq, sk, 8)
    *_, want, _ = JFM._prep(*(jnp.asarray(a) for a in (q, k, v, idx)), 128,
                            128, causal)
    got = TFM.flashmask_skip_table(torch.from_numpy(idx), sq, causal, 128,
                                   128)
    assert got.dtype == torch.int32
    assert got.shape == (b, hm, -(-sq // 128), -(-sk // 128))
    np.testing.assert_array_equal(got.repeat_interleave(h // hm, 1).numpy(),
                                  np.asarray(want))


def test_skip_table_skips_a_sliding_window():
    """A window of 64 over 512 tokens: at the kernels' 64 x 64 tiles most
    tiles are masked whole, and no skipped tile holds a kept pair."""
    s = 512
    idx = _intervals("window", 1, 1, s, s)
    skip = TFM.flashmask_skip_table(torch.from_numpy(idx), s, True)
    assert skip.shape == (1, 1, s // TFM.BLOCK, s // TFM.BLOCK)
    assert float(skip.float().mean()) >= 0.75
    keep = _dense_keep(idx, 1, s, True)[0, 0]
    tiles = keep.reshape(s // 64, 64, s // 64, 64).any((1, 3))
    assert not (tiles & skip[0, 0].numpy().astype(bool)).any()


def test_fully_masked_rows_through_the_functional():
    """Rows every column masks come back as zeros (the Pallas kernels'
    rule, not the dense path's mean of v), with zero dq and finite
    gradients."""
    q, k, v, w = (np.swapaxes(a, 1, 2) for a in _qkv(1, 2, 2, 128, 128, 16))
    idx = _intervals("masked_rows", 1, 1, 128, 128)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = TF.flashmask_attention(tq, tk, tv, torch.from_numpy(idx))
    assert float(out.detach()[:, 40:90].abs().max()) == 0.0
    (out * torch.from_numpy(np.ascontiguousarray(w))).sum().backward()
    assert all(torch.isfinite(g).all() for g in (tq.grad, tk.grad, tv.grad))
    assert float(tq.grad[:, 40:90].abs().max()) == 0.0


def test_functional_return_convention_and_no_grad_path():
    q, k, v, _ = (torch.from_numpy(np.swapaxes(a, 1, 2).copy())
                  for a in _qkv(1, 2, 2, 64, 64, 16))
    idx = torch.from_numpy(_intervals("1col", 1, 1, 64, 64))
    with torch.no_grad():
        plain = TF.flashmask_attention(q, k, v, idx, causal=True)
    assert plain.grad_fn is None
    out, lse = TF.flashmask_attention(q, k, v, idx, causal=True,
                                      return_softmax_lse=True)
    assert lse is None
    out3 = TF.flashmask_attention(q, k, v, idx, causal=True,
                                  return_seed_offset=True)
    assert len(out3) == 3 and out3[1] is None and out3[2] is None
    diff = TF.flashmask_attention(q.requires_grad_(), k, v, idx,
                                  causal=True, dropout=0.5, window_size=8)
    assert diff.grad_fn is not None
    torch.testing.assert_close(diff.detach(), plain, rtol=0, atol=0)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


@pytest.mark.parametrize("shape,match", [
    ((1, 1, 32, 3), "1, 2 or 4"),           # ncol 3
    ((1, 3, 32, 1), "mask heads"),          # 3 mask heads over 4
])
def test_invalid_intervals_raise(shape, match):
    q = torch.zeros(1, 4, 32, 16)
    k = v = torch.zeros(1, 4, 32, 16)
    se = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        TFM.flashmask_attention_forward(q, k, v, se)
    with pytest.raises(ValueError, match=match):
        TF.flashmask_attention(*(t.transpose(1, 2) for t in (q, k, v)), se)


def test_kv_heads_must_divide_and_cuda_wrappers_refuse_cpu():
    q = torch.zeros(1, 4, 32, 64)
    k = v = torch.zeros(1, 3, 32, 64)
    se = torch.zeros(1, 1, 32, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv heads"):
        TFM.flashmask_attention_forward(q, k, v, se)
    # a wrapper launches its kernel or raises: no fallback to the plain
    # version for tensors off the card
    k = v = torch.zeros(1, 4, 32, 64)
    with pytest.raises(ValueError, match="CUDA"):
        TFM.flashmask_fwd_cuda(q, k, v, se)
    lse = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="CUDA"):
        TFM.flashmask_bwd_dq_cuda(q, k, v, q, lse, lse, se, q.clone())
    assert TFM.flashmask_fwd_cuda.launches == 0
