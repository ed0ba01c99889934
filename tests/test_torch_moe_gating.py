"""Port parity of the top-k MoE gating: the port's plain routing (the
gating kernel's plain version, which the CPU runs) against the JAX
package's oracle ``_topk_routing`` and its Pallas kernel in interpret
mode, the dispatch rule of ``_moe_topk_routing``, and the autograd
Function's logit gradients against ``jax.grad`` of the oracle; f32 on
the CPU, inputs from numpy seeds."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.distributed.models.moe import gate as jax_gate
from paddle_tpu.ops.pallas.moe_gating import topk_gating_pallas
from paddle_tpu_torch.incubate.distributed.models.moe import gate as port_gate
from paddle_tpu_torch.ops import moe_gating as mg

# the JAX package's Pallas gating cases (tests/test_moe.py)
SHAPES = [(100, 8, 2, 16, True), (256, 4, 1, 32, False),
          (37, 16, 2, 5, True), (512, 64, 2, 24, True),
          (1000, 32, 3, 40, True)]


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _oracle(logits, k, C, norm):
    """The JAX oracle on the softmax of ``logits``, compiled once per
    shape (eager dispatch of its ops costs seconds per call)."""
    return jax_gate._topk_routing(jax.nn.softmax(logits, -1), k, C, norm)


def _logits(T, E, seed=0):
    return np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32)


def _assert_routing(got, want, w_atol=1e-6, aux_rtol=1e-6):
    """eidx, pos and keep identical; w within ``w_atol`` (the gates are
    f32 softmaxes of the same logits, a few ulps apart); l_aux within
    ``aux_rtol`` relative."""
    for name, g, w in zip(("eidx", "pos", "keep"), got[:3], want[:3]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_allclose(np.asarray(got[3]), np.asarray(want[3]),
                               rtol=0, atol=w_atol)
    np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=aux_rtol)


def _port(out):
    return [t.numpy() if t.dim() else float(t) for t in out]


@pytest.mark.parametrize("T,E,k,C,norm", SHAPES,
                         ids=[f"T{s[0]}-E{s[1]}-k{s[2]}-C{s[3]}"
                              for s in SHAPES])
def test_plain_routing_matches_oracle(T, E, k, C, norm):
    x = _logits(T, E)
    want = _oracle(jnp.asarray(x), k, C, norm)
    got = _port(mg.topk_gating_plain(torch.from_numpy(x), k, C, norm))
    assert got[0].dtype == np.int32 and got[2].dtype == bool
    _assert_routing(got, want)
    # the gate's entry point takes the same plain routing on the CPU
    _assert_routing(_port(port_gate._moe_topk_routing(torch.from_numpy(x),
                                                      k, C, norm)), want)


@pytest.mark.parametrize("T,E,k,C,norm", [SHAPES[0], SHAPES[2]],
                         ids=["T100-E8-k2-C16", "T37-E16-k2-C5"])
def test_plain_routing_matches_pallas_interpret(T, E, k, C, norm):
    x = _logits(T, E, seed=1)
    want = topk_gating_pallas(jnp.asarray(x), k, C, norm, interpret=True)
    got = _port(mg.topk_gating_plain(torch.from_numpy(x), k, C, norm))
    _assert_routing(got, want, aux_rtol=1e-5)


def test_underflowed_gates_pick_the_first_expert_again():
    """A row whose non-top gates underflow to 0: the second round picks
    the first expert with the chosen one multiplied by 0, not masked to
    -inf, so expert 0 is chosen again (or twice), as the oracle does."""
    x = np.zeros((4, 4), np.float32)
    x[:, 2] = 200.0          # every other gate underflows in f32
    x[1, 0] = 200.0          # a tie: the first index wins round 0
    want = _oracle(jnp.asarray(x), 2, 4, True)
    got = _port(mg.topk_gating_plain(torch.from_numpy(x), 2, 4, True))
    _assert_routing(got, want)
    assert got[0][:, 0].tolist() == [2, 0] and got[0][:, 1].tolist() == [0, 2]


@pytest.mark.parametrize("C", [8, 3], ids=["roomy", "drops"])
def test_random_keep_matches_oracle(C):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 4)).astype(np.float32)
    u = rng.uniform(size=32).astype(np.float32)
    want = jax_gate._moe_topk_routing.raw_fn(jnp.asarray(x), 2, C, True,
                                             random_keep=jnp.asarray(u))
    got = _port(port_gate._moe_topk_routing(
        torch.from_numpy(x), 2, C, True, random_keep=torch.from_numpy(u)))
    _assert_routing(got, want)


def test_dispatch_rule(monkeypatch):
    """f32 logits without random keep go to the kernel's entry point;
    bf16 logits and random keep stay on the oracle, as in the JAX
    package."""
    calls = []
    real = port_gate.topk_gating

    def spy(*args):
        calls.append(args[0].dtype)
        return real(*args)

    monkeypatch.setattr(port_gate, "topk_gating", spy)
    x = torch.from_numpy(_logits(16, 4, seed=5))
    port_gate._moe_topk_routing(x, 2, 8, True)
    assert calls == [torch.float32]
    u = torch.rand(16, generator=torch.Generator().manual_seed(0))
    port_gate._moe_topk_routing(x, 2, 8, True, random_keep=u)
    xb = x.to(torch.bfloat16)
    got = port_gate._moe_topk_routing(xb, 2, 8, True)
    assert calls == [torch.float32]
    want = mg.topk_routing_plain(torch.softmax(xb, -1), 2, 8, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3].dtype == torch.bfloat16 and got[0].shape == (2, 16)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        mg.topk_gating_cuda(torch.zeros(4, 8), 2, 4)


@pytest.mark.parametrize("k,C,norm", [(2, 16, True), (2, 5, True),
                                      (1, 32, False), (3, 40, True)],
                         ids=["k2", "k2-drops", "k1-raw", "k3"])
def test_autograd_grad_matches_jax(k, C, norm):
    """d/dlogits of sum(w * cw) + c * l_aux: the routing held fixed, the
    gradient flows through the softmax into the weights and the balance
    loss, as ``jax.grad`` of the oracle computes it."""
    rng = np.random.default_rng(3)
    T, E = 64, 8
    x = rng.standard_normal((T, E)).astype(np.float32)
    cw = rng.standard_normal((k, T)).astype(np.float32)
    c_aux = np.float32(1.7)

    def jax_grad(use_w, use_aux):
        def loss(lg):
            _, _, _, w, l_aux = jax_gate._topk_routing(
                jax.nn.softmax(lg, -1), k, C, norm)
            return use_w * jnp.sum(w * cw) + use_aux * c_aux * l_aux
        return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))

    # both cotangents, the weights alone (l_aux unused), the loss alone
    for use_w, use_aux in ((1, 1), (1, 0), (0, 1)):
        lg = torch.from_numpy(x).requires_grad_()
        _, _, _, w, l_aux = mg.topk_gating(lg, k, C, norm)
        outs = [o for o, use in (((w * torch.from_numpy(cw)).sum(), use_w),
                                 (float(c_aux) * l_aux, use_aux)) if use]
        (g,) = torch.autograd.grad(sum(outs), lg)
        np.testing.assert_allclose(g.numpy(), jax_grad(use_w, use_aux),
                                   rtol=0, atol=1e-6)


def test_dense_capacity_gating_matches_oracle():
    x = _logits(24, 4, seed=6)
    want = jax_gate._moe_gating.raw_fn(jnp.asarray(x), 2, 7, True)
    got = port_gate._moe_gating(torch.from_numpy(x), 2, 7, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("T,E,k,f,want", [(4096, 8, 2, 2.4, 2458),
                                          (8, 8, 2, 2.4, 5),
                                          (37, 8, 2, 1.2, 12),
                                          (3, 64, 1, 1.2, 1),
                                          (10, 2, 2, 4.0, 10)])
def test_moe_capacity_matches_jax(T, E, k, f, want):
    assert port_gate.moe_capacity(k, T, E, f) == want \
        == jax_gate.moe_capacity(k, T, E, f)


@pytest.mark.parametrize("T,E,k,C,norm", [SHAPES[0], SHAPES[1]],
                         ids=["T100-E8-k2-C16", "T256-E4-k1-C32"])
def test_kernel_epilogue_matches_pallas_wrapper(T, E, k, C, norm):
    """The card path's epilogue (weights normalized, l_aux from the round-0
    fill and the gate mass) on the kernel's raw contract, here built from
    the plain routing, against the Pallas wrapper in interpret mode."""
    x = torch.from_numpy(_logits(T, E, seed=8))
    eidx, pos, keep, w, _ = mg.topk_gating_plain(x, k, C, False)
    gates = torch.softmax(x, -1)
    raw = (eidx, pos, keep.to(torch.int32), w,
           torch.bincount(eidx[0].long(), minlength=E).to(torch.int32),
           gates.sum(0))
    got = _port(mg._epilogue(x, raw, norm))
    want = topk_gating_pallas(jnp.asarray(x.numpy()), k, C, norm,
                              interpret=True)
    _assert_routing(got, want, aux_rtol=1e-5)
