"""Port parity: the flash-attention backward of paddle_tpu_torch against
the JAX package's Pallas backward kernels in interpret mode and its XLA
``_bwd_blockwise``, on the same numpy inputs.  On the CPU the port runs
``_bwd_blockwise``, the function its CUDA dK/dV and dQ kernels compute
on the card."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa

CASES = {
    # name: (b, h, kvh, sq, sk, d, causal)
    "gqa_causal": (1, 4, 2, 40, 40, 16, True),
    "causal_sq_lt_sk": (1, 2, 1, 24, 70, 16, True),
    "causal_sq_gt_sk": (1, 2, 2, 50, 30, 16, True),
    "ragged_full_gqa": (2, 4, 1, 33, 45, 8, False),
}


def _inputs(b, h, kvh, sq, sk, d, causal, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, sk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    out, lse = jfa._fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, scale)
    return q, k, v, np.array(out), np.array(lse), do, scale


def _close(got, want):
    # f32 over two different summation orders: 1e-5 of the largest value
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_blockwise_matches_pallas_interpret_and_xla(name):
    b, h, kvh, sq, sk, d, causal = CASES[name]
    q, k, v, out, lse, do, scale = _inputs(*CASES[name])
    got = tfa.flash_attention_backward(
        *(torch.from_numpy(t) for t in (q, k, v, out, lse, do)),
        causal=causal, scale=scale)
    jargs = [jnp.asarray(t) for t in (q, k, v, out, lse, do)]
    pallas = jfa.flash_attention_backward(*jargs, causal, scale,
                                          block_q=128, block_kv=128,
                                          interpret=True)
    xla = jfa._bwd_blockwise(*jargs, causal, scale)
    _close(got, pallas)
    _close(got, xla)
    # small kv blocks walk the same arithmetic in pieces
    small = tfa._bwd_blockwise(
        *(torch.from_numpy(t) for t in (q, k, v, out, lse, do)), causal,
        scale, block_kv=16)
    _close(small, xla)


def test_fully_masked_rows_get_zero_gradients():
    """sq > sk under the causal mask: the first sq - sk rows see no
    column; their dq is exactly 0 and nothing is NaN."""
    q, k, v, out, lse, do, scale = _inputs(*CASES["causal_sq_gt_sk"])
    dq, dk, dv = tfa.flash_attention_backward(
        *(torch.from_numpy(t) for t in (q, k, v, out, lse, do)),
        causal=True, scale=scale)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all() \
        and torch.isfinite(dv).all()
    assert float(dq[:, :, :20].abs().max()) == 0.0


@pytest.mark.parametrize("causal", [True, False])
def test_bshd_autograd_matches_jax_grad(causal):
    """``flash_attention_bshd`` under autograd against ``jax.grad`` of the
    JAX package's differentiable ``flash_attention_bshd``."""
    rng = np.random.default_rng(5)
    b, s, h, kvh, d = 2, 24, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention_bshd(q_, k_, v_, causal=causal)
                       * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(t)
                                                for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention_bshd(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    _close((tq.grad, tk.grad, tv.grad), want)
    assert tk.grad.shape == (b, s, kvh, d)


def test_bshd_without_grad_is_the_serving_launch():
    """Under no_grad the bshd entry returns a plain tensor (no autograd
    node), equal to the differentiable path's forward."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 10, 2, 8))
                                .astype(np.float32)) for _ in range(3))
    with torch.no_grad():
        plain = tfa.flash_attention_bshd(q, k, v, causal=True)
    assert plain.grad_fn is None
    diff = tfa.flash_attention_bshd(q.requires_grad_(), k, v, causal=True)
    assert diff.grad_fn is not None
    np.testing.assert_allclose(diff.detach().numpy(), plain.numpy(),
                               rtol=0, atol=1e-6)


def test_functional_flash_attention_is_the_bshd_path():
    from paddle_tpu_torch.nn import functional as TF
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 12, 4, 8))
                                .astype(np.float32)) for _ in range(3))
    out, extra = TF.flash_attention(q, k, v, causal=True)
    assert extra is None
    torch.testing.assert_close(out, tfa.flash_attention_bshd(q, k, v, True),
                               rtol=0, atol=0)
