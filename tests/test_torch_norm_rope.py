"""Port parity: RMSNorm and RoPE of paddle_tpu_torch against the JAX
package — its XLA forms and its Pallas kernels in interpret mode — on the
same numpy inputs.  On the CPU the port runs its plain versions, the
arithmetic its Triton kernels repeat on the card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas.fused_norm_rope import (fused_rope_pallas,
                                                   rms_norm_pallas,
                                                   rms_norm_xla)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import fused_norm_rope as tnr


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(4, 7, 64), (3, 96)])
def test_rms_norm_f32_matches_xla_and_pallas(shape):
    x = _np(shape, 0)
    w = 1.0 + 0.1 * _np(shape[-1:], 1)
    got = tnr.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    want_xla = np.asarray(rms_norm_xla(jnp.asarray(x), jnp.asarray(w),
                                       1e-6))
    want_pallas = np.asarray(rms_norm_pallas(jnp.asarray(x), jnp.asarray(w),
                                             1e-6, interpret=True))
    # f32: the two sides differ only in the rsqrt's last bit
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=0, atol=1e-5)


def test_rms_norm_bf16_rounds_like_rms_norm_xla():
    """bf16: the port casts the normalized row before the weight, as
    ``rms_norm_xla`` does (the form the JAX serving step runs); the
    Pallas kernel multiplies in f32 first and may differ by a bf16 ulp."""
    x = _np((6, 128), 2)
    w = 1.0 + 0.1 * _np((128,), 3)
    got = tnr.rms_norm(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(w).bfloat16(), 1e-5).float().numpy()
    want = np.asarray(rms_norm_xla(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(w, jnp.bfloat16),
                                   1e-5).astype(jnp.float32))
    pallas = np.asarray(rms_norm_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-5,
        interpret=True).astype(jnp.float32))
    # one bf16 ulp (2^-8 relative) of values up to ~4
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=2e-2)


def _rope_inputs(b=3, s=5, h=4, kvh=2, d=16, max_pos=64):
    q = _np((b, s, h, d), 4)
    k = _np((b, s, kvh, d), 5)
    cos, sin = tllama._rope_tables(d, max_pos, 10000.0)
    return q, k, cos.numpy(), sin.numpy()


def test_rope_per_row_offsets_match_jax():
    q, k, cos, sin = _rope_inputs()
    pos = np.array([0, 7, 30], np.int32)
    got_q, got_k = tnr.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(cos),
                                  torch.from_numpy(sin),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(-sin))
    want_q, want_k = jllama.apply_rope(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(cos), jnp.asarray(sin),
                                       pos)
    # f32 rotations of O(1) values
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q._data),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k._data),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("offset", [0, 9])
def test_rope_shared_offset_matches_jax_and_pallas(offset):
    q, k, cos, sin = _rope_inputs()
    s = q.shape[1]
    tq, tk = tllama.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(cos), torch.from_numpy(sin),
                               offset, torch.from_numpy(-sin))
    jq, jk = jllama.apply_rope(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(cos), jnp.asarray(sin), offset)
    pq, pk = fused_rope_pallas(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(cos[offset:offset + s]),
                               jnp.asarray(sin[offset:offset + s]),
                               interpret=True)
    for got, want in ((tq, jq._data), (tk, jk._data), (tq, pq), (tk, pk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_rope_shared_offset_past_table_raises():
    q, k, cos, sin = _rope_inputs(max_pos=8)
    with pytest.raises(ValueError, match="exceeds the table"):
        tllama.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(cos), torch.from_numpy(sin), 4,
                          torch.from_numpy(-sin))


def test_rope_pad_positions_clamp_like_jax_gather():
    """A per-row window running past the table clamps at its last row
    (the ragged step's pad queries), as JAX's gather does."""
    q, k, cos, sin = _rope_inputs(max_pos=8)
    pos = np.array([0, 5, 6], np.int32)
    got_q, _ = tnr.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(cos), torch.from_numpy(sin),
                              torch.from_numpy(pos), torch.from_numpy(-sin))
    idx = np.minimum(pos[:, None] + np.arange(q.shape[1]), 7)
    c = jnp.asarray(cos)[idx][:, :, None, :]
    si = jnp.asarray(sin)[idx][:, :, None, :]
    half = q.shape[-1] // 2
    want = np.concatenate([q[..., :half] * c - q[..., half:] * si,
                           q[..., half:] * c + q[..., :half] * si], -1)
    np.testing.assert_allclose(got_q.numpy(), want, rtol=0, atol=1e-5)


# ------------------------------------------------------------- gradients
def test_rms_norm_grads_match_jax_pallas(monkeypatch):
    """dx and dw of the port's ``_RMSNorm`` against ``jax.grad`` of
    ``rms_norm_fused`` (Pallas forward in interpret mode, ``_rms_bwd``)."""
    import jax
    from paddle_tpu.ops.pallas import fused_norm_rope as fnr
    monkeypatch.setattr(fnr, "_INTERPRET", True)
    x = _np((2, 5, 64), 7)
    w = 1.0 + 0.1 * _np((64,), 8)
    gout = _np((2, 5, 64), 9)

    def loss(x_, w_):
        return jnp.sum(fnr.rms_norm_fused(x_, w_, 1e-5) * gout)

    want_dx, want_dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    (tnr.rms_norm(tx, tw, 1e-5) * torch.from_numpy(gout)).sum().backward()
    # f32, two summation orders over 64 columns and 10 rows
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw),
                               rtol=1e-5, atol=1e-5)


def test_rope_grads_and_table_cotangents_match_jax_pallas(monkeypatch):
    """dq, dk and the cos/sin cotangents of the port's ``_Rope`` (shared
    offset 0: a zero position vector over the full tables) against
    ``jax.grad`` of ``fused_rope_fused`` over the sliced window, with the
    Pallas kernel in interpret mode."""
    import jax
    from paddle_tpu.ops.pallas import fused_norm_rope as fnr
    monkeypatch.setattr(fnr, "_INTERPRET", True)
    q, k, cos, sin = _rope_inputs(b=2, s=6, h=4, kvh=2, d=16, max_pos=16)
    gq, gk = _np(q.shape, 10), _np(k.shape, 11)
    s = q.shape[1]

    def loss(q_, k_, c_, s_):
        oq, ok = fnr.fused_rope_fused(q_, k_, c_, s_)
        return jnp.sum(oq * gq) + jnp.sum(ok * gk)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(cos[:s]),
        jnp.asarray(sin[:s]))
    tq, tk, tc, ts = (torch.from_numpy(np.array(t)).requires_grad_()
                      for t in (q, k, cos, sin))
    pos = torch.zeros(2, dtype=torch.int32)
    oq, ok = tnr.apply_rope(tq, tk, tc, ts, pos, neg_sin=-ts.detach())
    ((oq * torch.from_numpy(gq)).sum()
     + (ok * torch.from_numpy(gk)).sum()).backward()
    for got, w in ((tq.grad, want[0]), (tk.grad, want[1]),
                   (tc.grad[:s], want[2]), (ts.grad[:s], want[3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # rows past the window get no cotangent
    assert float(tc.grad[s:].abs().max()) == 0.0
    assert float(ts.grad[s:].abs().max()) == 0.0


def test_rope_backward_is_the_forward_with_negated_sin():
    """Frozen tables: the backward is one more forward launch with -sin,
    and it needs no table cotangent."""
    q, k, cos, sin = _rope_inputs()
    pos = torch.tensor([0, 3, 9], dtype=torch.int32)
    tq = torch.from_numpy(q).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    c, sn = torch.from_numpy(cos), torch.from_numpy(sin)
    oq, ok = tnr.apply_rope(tq, tk, c, sn, pos, neg_sin=-sn)
    gq, gk = torch.from_numpy(_np(q.shape, 12)), \
        torch.from_numpy(_np(k.shape, 13))
    torch.autograd.backward((oq, ok), (gq, gk))
    want_q, want_k = tnr.apply_rope_plain(gq, gk, c, -sn, pos)
    np.testing.assert_allclose(tq.grad.numpy(), want_q.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tk.grad.numpy(), want_k.numpy(), rtol=0,
                               atol=1e-6)
