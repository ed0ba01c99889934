"""The multi-block gating kernel's algebra, in its plain PyTorch twin
(``topk_gating_chunked_plain``): every round's choice of a token at once,
per-chunk (round, expert) counts, exclusive prefixes over the chunks and
the totals of earlier rounds as each slot's base.  Held bit for bit on
the routing against the port's plain routing and the JAX package's
oracle ``_topk_routing`` and Pallas kernel (interpret mode) at several
chunk sizes, with and without underflowed gates; f32 on the CPU, inputs
from numpy seeds."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

from paddle_tpu.incubate.distributed.models.moe import gate as jax_gate
from paddle_tpu.ops.pallas.moe_gating import topk_gating_pallas
from paddle_tpu_torch.incubate.distributed.models.moe import moe_capacity
from paddle_tpu_torch.ops import moe_gating as mg

CHUNKS = (1, 7, 32, mg.CHUNK_TOKENS)
CASES = [(T, E, k) for T in (8, 37, 4096) for E in (4, 8, 32)
         for k in (1, 2, 3)]


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _oracle(logits, k, C, norm):
    return jax_gate._topk_routing(jax.nn.softmax(logits, -1), k, C, norm)


def _logits(T, E, seed, underflow):
    x = np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32) * 1.4
    if underflow:
        # every gate but one or two underflows to 0: later rounds pick
        # the first expert again, its unmasked gate as the weight
        x[:] = 0.0
        x[:, E // 2] = 200.0
        x[1::2, E - 1] = 200.0
    return x


def _raw_of_plain(x, k, C):
    """The kernel's raw contract built from the port's plain routing."""
    eidx, pos, keep, w, _ = mg.topk_gating_plain(x, k, C, False)
    E = x.shape[1]
    return (eidx, pos, keep.to(torch.int32), w,
            torch.bincount(eidx[0].long(), minlength=E).to(torch.int32),
            torch.softmax(x, -1).sum(0))


@pytest.mark.parametrize("underflow", [False, True],
                         ids=["random", "underflowed"])
@pytest.mark.parametrize("T,E,k", CASES,
                         ids=[f"T{T}-E{E}-k{k}" for T, E, k in CASES])
def test_chunked_routing_bit_equal_to_plain_and_oracle(T, E, k, underflow):
    x = _logits(T, E, seed=T + E + k, underflow=underflow)
    tx = torch.from_numpy(x)
    # a tight capacity (drops) and the eval capacity factor 2.4
    for C in (max(1, T * k // (2 * E)), moe_capacity(k, T, E, 2.4)):
        want_raw = _raw_of_plain(tx, k, C)
        want = _oracle(jnp.asarray(x), k, C, True)
        for chunk in CHUNKS:
            raw = mg.topk_gating_chunked_plain(tx, k, C, chunk)
            for name, a, b in zip(("eidx", "pos", "keep", "w", "fill"),
                                  raw[:5], want_raw[:5]):
                assert torch.equal(a, b), (name, chunk, C)
            # the gate mass: f32 sums of T gates in another order
            torch.testing.assert_close(raw[5], want_raw[5], rtol=1e-5,
                                       atol=1e-6)
            got = mg._epilogue(tx, raw, True)
            for name, a, b in zip(("eidx", "pos", "keep"), got[:3],
                                  want[:3]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{name} {chunk}")
            np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(float(got[4]), float(want[4]),
                                       rtol=1e-5)


@pytest.mark.parametrize("T,E,k,underflow", [
    (37, 8, 2, False), (4096, 8, 2, False), (4096, 32, 3, False),
    (4096, 8, 3, True)], ids=["T37-E8-k2", "T4096-E8-k2", "T4096-E32-k3",
                              "T4096-E8-k3-underflowed"])
def test_chunked_routing_matches_pallas_interpret(T, E, k, underflow):
    x = _logits(T, E, seed=11, underflow=underflow)
    C = moe_capacity(k, T, E, 1.2)
    want = topk_gating_pallas(jnp.asarray(x), k, C, True, interpret=True)
    got = mg._epilogue(torch.from_numpy(x),
                       mg.topk_gating_chunked_plain(torch.from_numpy(x), k,
                                                    C), True)
    for name, a, b in zip(("eidx", "pos", "keep"), got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=1e-5)


def test_gating_plan_by_tokens():
    assert mg.gating_plan(1) == ("topk_gating_warp_kernel", 32)
    assert mg.gating_plan(32) == ("topk_gating_warp_kernel", 32)
    assert mg.gating_plan(33) == ("topk_gating_chunk_kernel", 256)
    assert mg.gating_grid(8, 8, 2) == 1
