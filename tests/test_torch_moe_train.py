"""Port parity of sparse-MoE training: ``LlamaMoeForCausalLM`` through
the port's ``TrainStep`` (cross entropy plus the weighted balance loss,
as the JAX package's ``tests/test_llama_moe.py`` trains it) against the
JAX ``TrainStep`` on the same weights and batch, in f32 on the CPU.

- Naive gate (the routing the gating kernel takes on the card): three
  losses within relative 2e-5, and every parameter after them within
  relative L2 1e-4 (Adam's step size makes entries whose gradients sum
  to near zero move either way at that rounding, see test_torch_train).
- GShard: the random second-choice keep is fed the same uniforms on
  both sides (each gate instance's ``_random_keep`` patched to return
  one fixed array a layer; the JAX step bakes the array it traced).
- The balance loss reaches the gates' gradients; recompute gives the
  losses of the plain path (JAX ``test_recompute_parity``)."""
import functools

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as joptim
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import LlamaMoeConfig as JaxMoeConfig
from paddle_tpu.models import LlamaMoeForCausalLM as JaxMoeLM
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.convert import (moe_params_from_numpy,
                                             moe_params_to_numpy)
from paddle_tpu_torch.models.llama_moe import LlamaMoeConfig
from paddle_tpu_torch.nn import functional as TF

CFG = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=2,
           max_position_embeddings=64, num_experts=4, moe_top_k=2)
B, S, STEPS = 4, 16, 3


def _data(seed=0):
    ids = np.random.default_rng(seed).integers(0, 128, (B, S + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


def _jax_loss(outputs, labels):
    logits, aux = outputs
    return JF.cross_entropy(logits.reshape([-1, 128]),
                            labels.reshape([-1])) + aux


def _port_loss(outputs, labels):
    logits, aux = outputs
    return TF.cross_entropy(logits.reshape(-1, 128),
                            labels.reshape(-1)) + aux


def _uniforms(layer):
    return np.random.default_rng(100 + layer).random(B * S).astype(
        np.float32)


def _models(gate_type, seed, recompute=False):
    kw = dict(CFG, gate_type=gate_type, use_recompute=recompute)
    paddle.seed(seed)
    jm = JaxMoeLM(JaxMoeConfig(**kw))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = moe_params_from_numpy(LlamaMoeConfig(**kw), arrays, device="cpu")
    if gate_type == "gshard":
        for i, (jl, tl) in enumerate(zip(jm.model.layers, tm.model.layers)):
            u = _uniforms(i)
            jl.moe.gate._random_keep = \
                lambda n, u=u: paddle.to_tensor(u)._data
            tl.moe.gate._random_keep = \
                lambda n, device, u=u: torch.from_numpy(u).to(device)
    return jm, tm


def _train_port(tm):
    step = TrainStep(tm, _port_loss, toptim.AdamW(
        learning_rate=1e-3, parameters=tm.parameters()))
    ids, lab = (torch.from_numpy(a).long() for a in _data())
    return [float(step(ids, lab)) for _ in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_run(gate_type):
    """The JAX step's losses and final parameters (computed once a gate
    type: each JAX TrainStep compiles the whole step)."""
    jm, _tm = _models(gate_type, seed=2)
    step = JaxTrainStep(jm, _jax_loss, joptim.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    ids, lab = (paddle.to_tensor(a) for a in _data())
    losses = [float(np.asarray(step(ids, lab)._data)) for _ in range(STEPS)]
    step.sync()
    return losses, {n: np.asarray(p._data, np.float32)
                    for n, p in jm.named_parameters()}


@pytest.mark.parametrize("gate_type", ["naive", "gshard"])
def test_train_step_follows_jax(gate_type):
    want, want_params = _jax_run(gate_type)
    _jm, tm = _models(gate_type, seed=2)
    got = _train_port(tm)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert got[-1] < got[0]
    params = moe_params_to_numpy(tm)
    assert sorted(params) == sorted(want_params)
    for name, w in want_params.items():
        rel = np.linalg.norm(params[name] - w) / np.linalg.norm(w)
        assert rel <= 1e-4, f"{name}: relative L2 {rel:.3e}"


def test_gshard_keep_reaches_the_routing():
    """The fed uniforms decide the second choice: keeping none of them
    routes differently from keeping all."""
    _jm, tm = _models("gshard", seed=2)
    ids = torch.from_numpy(_data()[0]).long()
    outs = []
    for u in (0.0, 1.0):
        for layer in tm.model.layers:
            layer.moe.gate._random_keep = \
                lambda n, device, u=u: torch.full((n,), u, device=device)
        with torch.no_grad():
            outs.append(tm(ids)[0])
    assert not torch.equal(*outs)


def test_aux_loss_reaches_gate_grads():
    jm, tm = _models("gshard", seed=1)
    ids = _data(seed=1)[0]
    _jl, jaux = jm(paddle.to_tensor(ids))
    _logits, aux = tm(torch.from_numpy(ids).long())
    assert float(aux.detach()) > 0.0
    np.testing.assert_allclose(float(aux.detach()),
                               float(np.asarray(jaux._data)),
                               rtol=1e-5)
    aux.backward()
    gates = [p for n, p in tm.named_parameters()
             if ".gate." in n and p.grad is not None]
    assert len(gates) == CFG["num_hidden_layers"]
    assert all(float(p.grad.abs().max()) > 0 for p in gates)


def test_recompute_parity():
    """Recomputed attention and experts (the gate outside the
    checkpoints): the losses of the plain path, which are JAX's."""
    want, _params = _jax_run("naive")
    runs = [_train_port(_models("naive", seed=2, recompute=r)[1])
            for r in (False, True)]
    np.testing.assert_allclose(runs[1], runs[0], rtol=2e-5)
    np.testing.assert_allclose(runs[1], want, rtol=2e-5)
