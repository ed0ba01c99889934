"""Port parity: flash-attention forward of paddle_tpu_torch against the
JAX package's Pallas kernel in interpret mode and its XLA references, on
the same numpy inputs.  On the CPU the port runs its plain version, the
function its CUDA kernel computes on the card."""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as tfa


def _qkv(b, h, kvh, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, kvh, sk, d)).astype(np.float32),
            rng.standard_normal((b, kvh, sk, d)).astype(np.float32))


CASES = {
    # name: (b, h, kvh, sq, sk, d, causal)
    "causal": (1, 2, 2, 128, 128, 32, True),
    "causal_sq_lt_sk": (1, 2, 2, 40, 100, 32, True),
    "padded_lengths": (2, 2, 2, 70, 100, 32, False),
    "gqa_causal": (1, 4, 2, 96, 96, 32, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_pallas_interpret(name):
    b, h, kvh, sq, sk, d, causal = CASES[name]
    q, k, v = _qkv(b, h, kvh, sq, sk, d)
    out, lse = tfa.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    jout, jlse = jfa.flash_attention_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=1.0 / np.sqrt(d), interpret=True)
    # f32 softmax attention: summation order differs (one pass vs
    # online over 128-column tiles)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_and_bshd_match_jax(causal):
    q, k, v = _qkv(2, 4, 2, 24, 24, 16, seed=1)
    got = tfa.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal)
    want = jfa.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    qs, ks, vs = (np.ascontiguousarray(t.transpose(0, 2, 1, 3))
                  for t in (q, k, v))
    got = tfa.flash_attention_bshd(torch.from_numpy(qs), torch.from_numpy(ks),
                                   torch.from_numpy(vs), causal=causal)
    want = jfa.flash_attention_bshd(jnp.asarray(qs), jnp.asarray(ks),
                                    jnp.asarray(vs), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version: a CPU tensor is
    an error there, not a fallback."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 2, 8, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, k, v)
