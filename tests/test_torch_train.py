"""Port parity: paddle_tpu_torch's training path (LLaMA forward and
backward through the ops' autograd Functions, ``TrainStep``, the
optimizers, a schedule, clipping, accumulation) against the JAX
package's ``TrainStep`` on the same weights and batches, on the CPU.

f32 cases: losses within relative 1e-5; after 5 steps each parameter
tensor within relative L2 1e-4 (||port - jax|| / ||jax||).  The two
frameworks' gradients agree to ~5e-7 of their largest entry (they sum in
different orders); SGD moves parameters by lr * g, so its parameters
are also held entry by entry (1e-4 of the largest).  Adam divides by
sqrt(v): an entry whose gradient sums to near zero, at the level of
that rounding, takes a step of order lr in either direction, so Adam's
parameters are held as tensors, not entry by entry."""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as joptim
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.convert import (params_from_numpy,
                                             params_to_numpy)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as TF

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
BATCH, SEQ, STEPS = 2, 32, 5


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, (BATCH, SEQ)).astype(np.int32),
             rng.integers(0, 128, (BATCH, SEQ)).astype(np.int32))
            for _ in range(n)]


def _jax_loss(logits, labels):
    return JF.cross_entropy(logits.reshape([-1, 128]).astype("float32"),
                            labels.reshape([-1]))


def _port_loss(logits, labels):
    return TF.cross_entropy(logits.reshape(-1, 128).float(),
                            labels.reshape(-1))


def _models(seed=0, bf16=False):
    paddle.seed(seed)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu",
                           dtype=torch.bfloat16 if bf16 else None)
    if bf16:
        import jax.numpy as jnp
        for p in jm.parameters():
            p._data = p._data.astype(jnp.bfloat16)
    return jm, tm


# optimizer factories: (jax module, port module) -> (opt, scheduler)
def _sgd(mod, params, nn):
    return mod.SGD(learning_rate=0.5, parameters=params), None


def _adamw(mod, params, nn):
    return mod.AdamW(learning_rate=1e-3, weight_decay=0.1,
                     parameters=params), None


def _adamw_clip(mod, params, nn):
    return mod.AdamW(learning_rate=1e-3, parameters=params,
                     grad_clip=nn.ClipGradByGlobalNorm(0.5)), None


def _adam_amsgrad_l2(mod, params, nn):
    return mod.Adam(learning_rate=1e-3, parameters=params, amsgrad=True,
                    weight_decay=0.01), None


def _warmup(mod, params, nn):
    sched = mod.lr.LinearWarmup(
        mod.lr.CosineAnnealingDecay(2e-3, T_max=4), warmup_steps=2,
        start_lr=0.0, end_lr=2e-3)
    return mod.AdamW(learning_rate=sched, parameters=params), sched


OPTS = {"sgd": _sgd, "adamw": _adamw, "adamw_clip": _adamw_clip,
        "adam_amsgrad_l2": _adam_amsgrad_l2, "warmup_cosine": _warmup}


def _run(make, accumulate=1, avg=True, seed=0):
    jm, tm = _models(seed)
    jopt, jsched = make(joptim, jm.parameters(), jnn)
    topt, tsched = make(toptim, tm.parameters(), tnn)
    jstep = JaxTrainStep(jm, _jax_loss, jopt, accumulate_steps=accumulate,
                         accumulate_avg=avg)
    tstep = TrainStep(tm, _port_loss, topt, accumulate_steps=accumulate,
                      accumulate_avg=avg)
    jl, tl = [], []
    for ids, labels in _batches():
        jl.append(float(np.asarray(jstep(paddle.to_tensor(ids),
                                         paddle.to_tensor(labels))._data)))
        tl.append(float(tstep(torch.from_numpy(ids).long(),
                              torch.from_numpy(labels).long())))
        for s in (jsched, tsched):
            if s is not None:
                s.step()
    jstep.sync()
    return jm, tm, np.array(jl), np.array(tl)


def _params_close(jm, tm, limit, entrywise=False):
    """Every parameter tensor within relative L2 ``limit`` of the JAX
    one; with ``entrywise``, every entry within ``limit`` x its tensor's
    largest entry too."""
    want = {n: np.asarray(p._data, np.float32)
            for n, p in jm.named_parameters()}
    got = params_to_numpy(tm)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        rel = np.linalg.norm(got[name] - w) / np.linalg.norm(w)
        assert rel <= limit, f"{name}: relative L2 {rel:.3e} > {limit}"
        if entrywise:
            np.testing.assert_allclose(got[name], w, rtol=0,
                                       atol=limit * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_losses_and_params_follow_jax_train_step(name):
    jm, tm, jl, tl = _run(OPTS[name])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _params_close(jm, tm, 1e-4, entrywise=name == "sgd")


@pytest.mark.parametrize("opt,avg", [("sgd", True), ("sgd", False),
                                     ("adamw", True)])
def test_accumulate_steps_2_follow_jax(opt, avg):
    """k = 2 over 5 calls: two applied updates of the mean (or the sum)
    of two micro-batches' gradients.  SGD sees the mean/sum difference
    directly; Adam is nearly blind to a gradient's scale."""
    jm, tm, jl, tl = _run(OPTS[opt], accumulate=2, avg=avg)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _params_close(jm, tm, 1e-4, entrywise=opt == "sgd")


def test_bf16_multi_precision_follows_jax():
    """bf16 parameters with f32 masters and moments.  The two frameworks
    round the bf16 forward and its gradients at different places (matmul
    accumulation, the RMSNorm cast): losses are held to relative 1e-3
    (observed 6e-5).  Each Adam step moves an entry by up to lr = 1e-3,
    5% of a 0.02 weight, and where bf16 gradients differ in their last
    bits Adam's normalization turns that into a different step, so each
    parameter tensor is held to relative L2 2e-2 (observed 6e-3)."""
    jm, tm = _models(1, bf16=True)
    jopt = joptim.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                        multi_precision=True)
    topt = toptim.AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                        multi_precision=True)
    jstep = JaxTrainStep(jm, _jax_loss, jopt)
    tstep = TrainStep(tm, _port_loss, topt)
    jl, tl = [], []
    for ids, labels in _batches(3, seed=1):
        jl.append(float(np.asarray(jstep(paddle.to_tensor(ids),
                                         paddle.to_tensor(labels))._data)))
        tl.append(float(tstep(torch.from_numpy(ids).long(),
                              torch.from_numpy(labels).long())))
    jstep.sync()
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for p in tm.parameters():
        assert p.dtype == torch.bfloat16
        assert topt._master_weights[id(p)].dtype == torch.float32
        assert topt._accumulators["moment1"][id(p)].dtype == torch.float32
    _params_close(jm, tm, 2e-2)
    # the parameter is its master rounded to bf16
    p = tm.model.norm.weight
    torch.testing.assert_close(p, topt._master_weights[id(p)].bfloat16(),
                               rtol=0, atol=0)


def test_run_steps_equals_single_calls():
    batches = [(torch.from_numpy(i).long(), torch.from_numpy(l).long())
               for i, l in _batches(3)]
    runs = []
    for fused in (False, True):
        _jm, tm = _models(2)
        sched = toptim.lr.LinearLR(0.01, total_steps=3)
        step = TrainStep(tm, _port_loss, toptim.AdamW(
            learning_rate=sched, parameters=tm.parameters()))
        if fused:
            losses = step.run_steps(batches)
        else:
            losses = []
            for ids, labels in batches:
                losses.append(step(ids, labels))
                sched.step()
            losses = torch.stack(losses)
        runs.append((losses, params_to_numpy(tm)))
    assert runs[0][0].shape == (3,)
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    for name in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][name], runs[1][1][name])


def test_frozen_params_and_step_counter():
    _jm, tm = _models(3)
    tm.model.embed_tokens.weight.requires_grad_(False)
    before = tm.model.embed_tokens.weight.detach().clone()
    opt = toptim.SGD(learning_rate=0.1, parameters=tm.parameters())
    step = TrainStep(tm, _port_loss, opt, accumulate_steps=2)
    for ids, labels in _batches(3):
        loss = step(torch.from_numpy(ids).long(),
                    torch.from_numpy(labels).long())
        assert loss.dtype == torch.float32 and loss.dim() == 0
    # three calls with k = 2 apply one update
    assert opt._global_step == 1
    assert torch.equal(tm.model.embed_tokens.weight, before)


def test_forward_with_labels_and_recompute():
    """``forward(ids, labels)`` is (loss, logits) with the mean cross
    entropy over labels other than -100, and ``use_recompute`` gives the
    same gradients as keeping the activations."""
    ids, labels = _batches(1)[0]
    labels = labels.copy()
    labels[0, :5] = -100
    grads = []
    for recompute in (False, True):
        cfg = LlamaConfig(**TINY, use_recompute=recompute)
        tm = LlamaForCausalLM(cfg, device="cpu", seed=4)
        loss, logits = tm(torch.from_numpy(ids).long(),
                          torch.from_numpy(labels).long())
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 128), torch.from_numpy(labels).reshape(-1)
            .long(), ignore_index=-100)
        torch.testing.assert_close(loss, want)
        loss.backward()
        grads.append([p.grad.clone() for p in tm.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_eager_optimizer_step_equals_train_step():
    """``loss.backward(); opt.step(); opt.clear_grad()`` is the same
    update as ``TrainStep``, and ``state_dict``/``set_state_dict`` carry
    the optimizer across a fresh instance mid-run."""
    batches = [(torch.from_numpy(i).long(), torch.from_numpy(l).long())
               for i, l in _batches(4)]
    _jm, eager = _models(5)
    _jm, stepped = _models(5)
    opt_e = toptim.AdamW(learning_rate=1e-3, parameters=eager.parameters(),
                         grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    opt_s = toptim.AdamW(learning_rate=1e-3,
                         parameters=stepped.parameters(),
                         grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    step = TrainStep(stepped, _port_loss, opt_s)
    for n, (ids, labels) in enumerate(batches):
        if n == 2:   # restart the eager optimizer from its state dict
            state = opt_e.state_dict()
            opt_e = toptim.AdamW(learning_rate=1e-3,
                                 parameters=eager.parameters(),
                                 grad_clip=tnn.ClipGradByGlobalNorm(1.0))
            opt_e.set_state_dict(state)
            assert opt_e._global_step == 2
        _port_loss(eager(ids), labels).backward()
        opt_e.step()
        opt_e.clear_grad()
        step(ids, labels)
    for a, b in zip(eager.parameters(), stepped.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((6, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (6, 5, 1))
    labels[0, :3] = -100
    want = np.asarray(JF.cross_entropy(paddle.to_tensor(logits),
                                       paddle.to_tensor(labels),
                                       reduction=reduction)._data)
    got = TF.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), reduction=reduction)
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape),
                               rtol=1e-6, atol=1e-6)
