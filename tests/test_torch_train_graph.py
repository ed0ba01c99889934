"""Port parity for what the graphed training step rests on, on the CPU:
every optimizer's update rule, with the learning rate and the step
number as device tensors, against the JAX optimizer's
``_functional_update_fn``; every schedule's ``get_lr`` and
``traced_lr`` against JAX's; ``set_lr``, ``_lr_factor`` and the state
dict; and the port's ``TrainStep.run_steps`` (the rate and step number
computed on the device from a counter) against JAX's fused
``run_steps``.  The CUDA graphs themselves need a card
(``tests/test_torch_train_graph_card.py``).

Tolerances: f32 parameters, masters and state within relative 1e-5
(absolute 1e-6) of JAX's after 3 steps — the two compute ``pow``,
norms and fused multiply-adds with their own roundings; bf16 parameters
(under ``multi_precision``) within one bf16 ulp, their f32 masters as
f32.  A traced rate equals ``np.float32(get_lr())`` bit for bit (the
port computes it in f64, in ``get_lr``'s order) and JAX's traced f32
rate within relative 1e-6; ``get_lr`` equals JAX's exactly (the same
Python arithmetic)."""
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as joptim
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.convert import (params_from_numpy,
                                             params_to_numpy)
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.nn import functional as TF

SHAPES = [(4, 3), (5,), (2, 3, 2)]


# optimizer cases: name -> (factory(module) -> (class, kwargs), steps)
def _case(cls, steps=(1, 2, 3), **kw):
    return (lambda mod: (getattr(mod, cls), {
        k: v(mod) if callable(v) else v for k, v in kw.items()}), steps)


OPTIMIZERS = {
    "sgd": _case("SGD", learning_rate=0.1, weight_decay=0.01),
    "sgd_l1": _case("SGD", learning_rate=0.1,
                    weight_decay=lambda m: m.L1Decay(0.01)),
    "momentum": _case("Momentum", learning_rate=0.05, momentum=0.9,
                      weight_decay=lambda m: m.L2Decay(0.01)),
    "momentum_nesterov": _case("Momentum", learning_rate=0.05,
                               momentum=0.9, use_nesterov=True),
    "adam": _case("Adam", learning_rate=0.01),
    "adam_amsgrad": _case("Adam", learning_rate=0.01, amsgrad=True),
    "adamw": _case("AdamW", learning_rate=0.01, weight_decay=0.1,
                   apply_decay_param_fun=lambda m: lambda n: n == ""),
    "adamax": _case("Adamax", learning_rate=0.01, weight_decay=0.001),
    "adagrad": _case("Adagrad", learning_rate=0.1,
                     initial_accumulator_value=0.1),
    "adadelta": _case("Adadelta", learning_rate=1.0),
    "rmsprop": _case("RMSProp", learning_rate=0.01, momentum=0.5),
    "rmsprop_centered": _case("RMSProp", learning_rate=0.01, centered=True),
    "lamb": _case("Lamb", learning_rate=0.01, lamb_weight_decay=0.01),
    "asgd": _case("ASGD", learning_rate=0.1),
    "rprop": _case("Rprop", learning_rate=0.01),
    "nadam": _case("NAdam", learning_rate=0.01),
    "radam": _case("RAdam", learning_rate=0.01),
    "radam_rectified": _case("RAdam", steps=(10, 11, 12),
                             learning_rate=0.01),
}


def _to_np(t):
    """A copy (JAX may alias a numpy array that torch updates in place)."""
    return t.detach().float().cpu().numpy().copy()


@pytest.mark.parametrize("dtype", ["f32", "bf16_mp"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_rule_matches_jax(name, dtype):
    make, steps = OPTIMIZERS[name]
    bf16 = dtype == "bf16_mp"
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 else \
        (torch.float32, jnp.float32)
    rng = np.random.default_rng(0)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in steps]
    params = [torch.nn.Parameter(torch.tensor(a, dtype=tdt))
              for a in init]
    cls, kw = make(toptim)
    opt = cls(parameters=params, multi_precision=bf16, **kw)
    opt._ensure_state(params)
    # JAX runs its pure update from the port's initial state
    jcls, jkw = make(joptim)
    jopt = jcls(parameters=[], **jkw)
    jopt._state_slots = opt._state_slots
    # a torch parameter has no name: the decay rules see ''
    update = jopt._functional_update_fn(
        [types.SimpleNamespace(name="") for _ in params])
    arrays = [jnp.asarray(a, jdt) for a in init]
    def state_dtype(t):
        return jnp.float32 if t.dtype == torch.float32 else jdt

    states = {s: [jnp.asarray(_to_np(opt._accumulators[s][id(p)]),
                              state_dtype(opt._accumulators[s][id(p)]))
                  for p in params] for s in opt._state_slots}
    masters = [None if id(p) not in opt._master_weights else
               jnp.asarray(_to_np(opt._master_weights[id(p)]))
               for p in params]
    lr = opt.get_lr()
    for step, gs in zip(steps, grads):
        opt._apply_update(params, [torch.from_numpy(g).to(tdt) for g in gs],
                          torch.tensor(lr, dtype=torch.float32),
                          torch.tensor(step, dtype=torch.int32))
        arrays, states, masters = update(
            jnp.asarray(lr, jnp.float32), jnp.asarray(step, jnp.int32),
            arrays, [jnp.asarray(g, jdt) for g in gs], states, masters)
    for i, p in enumerate(params):
        want = np.asarray(arrays[i], np.float32)
        if bf16:
            np.testing.assert_allclose(_to_np(p), want, rtol=2 ** -7,
                                       atol=1e-6, err_msg=str(i))
            np.testing.assert_allclose(_to_np(opt._master_weights[id(p)]),
                                       np.asarray(masters[i]), rtol=1e-5,
                                       atol=1e-6, err_msg=str(i))
        else:
            np.testing.assert_allclose(_to_np(p), want, rtol=1e-5,
                                       atol=1e-6, err_msg=str(i))
        for s in opt._state_slots:
            np.testing.assert_allclose(
                _to_np(opt._accumulators[s][id(p)]),
                np.asarray(states[s][i], np.float32), rtol=1e-5, atol=1e-6,
                err_msg=f"{i}.{s}")


# schedule cases: name -> factory(lr module) -> schedule
SCHEDULES = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                  learning_rate=0.5),
    "piecewise": lambda m: m.PiecewiseDecay([5, 12, 30], [0.1, 0.05, 0.01,
                                                          0.001]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.1, gamma=0.07),
    "inverse_time": lambda m: m.InverseTimeDecay(0.1, gamma=0.3),
    "polynomial": lambda m: m.PolynomialDecay(0.1, decay_steps=25,
                                              power=1.7),
    "polynomial_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=9, end_lr=0.002, power=0.5, cycle=True),
    "warmup_float": lambda m: m.LinearWarmup(0.07, warmup_steps=7,
                                             start_lr=0.001, end_lr=0.07),
    "warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.2, T_max=23, eta_min=0.01),
        warmup_steps=6, start_lr=0.0, end_lr=0.2),
    "warmup_restarts": lambda m: m.LinearWarmup(
        m.CosineAnnealingWarmRestarts(0.2, T_0=5), warmup_steps=3,
        start_lr=0.0, end_lr=0.2),
    "exponential": lambda m: m.ExponentialDecay(0.1, gamma=0.93),
    "multistep": lambda m: m.MultiStepDecay(0.1, milestones=[30, 4, 17],
                                            gamma=0.3),
    "step": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.6),
    "lambda": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "multiplicative": lambda m: m.MultiplicativeDecay(0.1,
                                                      lambda e: 0.97),
    "cosine": lambda m: m.CosineAnnealingDecay(0.1, T_max=17,
                                               eta_min=0.001),
    "cosine_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=4, T_mult=2, eta_min=0.001),
    "reduce_on_plateau": lambda m: m.ReduceOnPlateau(0.1, patience=2),
    "one_cycle": lambda m: m.OneCycleLR(0.1, total_steps=35),
    "one_cycle_linear": lambda m: m.OneCycleLR(0.1, total_steps=35,
                                               anneal_strategy="linear"),
    "cyclic": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=6,
                                   mode="triangular2"),
    "cyclic_exp": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=5,
                                       step_size_down=3, mode="exp_range",
                                       exp_gamma=0.97),
    "linear_lr": lambda m: m.LinearLR(0.1, total_steps=13,
                                      start_factor=0.25),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    """Steps 0-40: ``get_lr`` equals JAX's; ``traced_lr`` exists where
    JAX's does, equals ``np.float32(get_lr())`` bit for bit and JAX's
    traced f32 rate within relative 1e-6."""
    port, ref = SCHEDULES[name](toptim.lr), SCHEDULES[name](joptim.lr)
    traced, jtraced = port.traced_lr(), ref.traced_lr()
    assert (traced is None) == (jtraced is None)
    metrics = np.random.default_rng(1).standard_normal(41)
    for step in range(41):
        assert port.last_epoch == ref.last_epoch
        assert port() == ref(), step
        if traced is not None:
            got = traced(torch.tensor(step))
            assert got.dtype == torch.float32 and got.dim() == 0
            assert float(got) == float(np.float32(port())), step
            want = float(jtraced(jnp.asarray(step, jnp.int32)))
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       atol=1e-9, err_msg=str(step))
        if name == "reduce_on_plateau":
            port.step(metrics[step])
            ref.step(metrics[step])
        else:
            port.step()
            ref.step()


def test_set_lr_factor_and_state_dict_match_jax():
    """``set_lr``, ``_lr_factor`` (in ``get_lr`` and the state dict, only
    when it is not 1) and a schedule's state, as the JAX package keeps
    them; ``set_lr`` refuses a schedule."""
    p = torch.nn.Parameter(torch.zeros(3))
    for mod, params in ((toptim, [p]), (joptim, [])):
        opt = mod.Momentum(learning_rate=0.1, parameters=params)
        assert "lr_factor" not in opt.state_dict()
        opt.set_lr(0.25)
        opt._lr_factor = 0.5
        assert opt.get_lr() == 0.125
        assert opt.state_dict()["lr_factor"] == 0.5
        opt.set_lr_scheduler(mod.lr.StepDecay(0.2, step_size=2))
        with pytest.raises(RuntimeError):
            opt.set_lr(0.1)
        for _ in range(3):
            opt._learning_rate.step()
        assert opt.get_lr() == pytest.approx(0.2 * 0.1 * 0.5, rel=1e-12)
        assert opt._traced_schedule() is not None
        sd = opt.state_dict()
        assert sd["LR_Scheduler"]["last_epoch"] == 3
        fresh = mod.Momentum(learning_rate=mod.lr.StepDecay(0.2, 2),
                             parameters=params)
        fresh.set_state_dict(sd)
        assert fresh._lr_factor == 0.5
        assert fresh.get_lr() == opt.get_lr()
        assert fresh._learning_rate.last_epoch == 3


def test_set_state_dict_writes_state_in_place():
    """A loaded state is copied into the tensors a captured graph holds:
    moments and masters keep their identity and take the new values."""
    params = [torch.nn.Parameter(torch.randn(4, 3).bfloat16()),
              torch.nn.Parameter(torch.randn(5))]
    opt = toptim.AdamW(learning_rate=1e-3, parameters=params,
                       multi_precision=True)
    opt._ensure_state(params)
    before = {k: v for k, v in opt.state_dict().items()
              if isinstance(v, torch.Tensor)}
    assert len(before) == 5      # two moments each, one master
    src = toptim.AdamW(learning_rate=1e-3, parameters=params,
                       multi_precision=True)
    src._ensure_state(params)
    for t in src.state_dict().values():
        if isinstance(t, torch.Tensor):
            t.uniform_()
    src._global_step = 7
    opt.set_state_dict(src.state_dict())
    after = opt.state_dict()
    assert opt._global_step == 7
    for key, t in before.items():
        assert after[key] is t, key
        assert torch.equal(t, src.state_dict()[key]), key


TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=32)


def _jax_loss(logits, labels):
    return JF.cross_entropy(logits.reshape([-1, 64]).astype("float32"),
                            labels.reshape([-1]))


def _port_loss(logits, labels):
    return TF.cross_entropy(logits.reshape(-1, 64).float(),
                            labels.reshape(-1))


def _warmup_cosine(mod, params):
    sched = mod.lr.LinearWarmup(mod.lr.CosineAnnealingDecay(2e-3, T_max=5),
                                warmup_steps=2, start_lr=0.0, end_lr=2e-3)
    return mod.AdamW(learning_rate=sched, parameters=params), sched


@pytest.mark.parametrize("accumulate", [1, 2])
def test_run_steps_follows_jax_fused_run_steps(accumulate):
    """Two ``run_steps`` calls of 3 micro steps under LinearWarmup(Cosine
    AnnealingDecay), the port's rate and step computed on the device from
    a counter, JAX's inside its ``lax.scan`` (with k = 2 the first call
    ends half way through an accumulation): losses within relative 1e-5,
    every parameter tensor within relative L2 1e-4 (test_torch_train.py
    says why), and the micro step, optimizer step and schedule counters
    equal after each call."""
    paddle.seed(6)
    jm = JaxLM(JaxConfig(**TINY))
    tm = params_from_numpy(LlamaConfig(**TINY), {
        n: np.asarray(p._data) for n, p in jm.named_parameters()},
        device="cpu")
    jopt, jsched = _warmup_cosine(joptim, jm.parameters())
    topt, tsched = _warmup_cosine(toptim, tm.parameters())
    jstep = JaxTrainStep(jm, _jax_loss, jopt, accumulate_steps=accumulate)
    tstep = TrainStep(tm, _port_loss, topt, accumulate_steps=accumulate)
    assert jstep.fused_supported and tstep.fused_supported
    rng = np.random.default_rng(6)
    for _call in range(2):
        batches = [(rng.integers(0, 64, (2, 16)), rng.integers(0, 64, (2, 16)))
                   for _ in range(3)]
        jl = jstep.run_steps([(paddle.to_tensor(i.astype(np.int32)),
                               paddle.to_tensor(l.astype(np.int32)))
                              for i, l in batches])
        tl = tstep.run_steps([(torch.from_numpy(i), torch.from_numpy(l))
                              for i, l in batches])
        assert tl.shape == (3,) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl._data),
                                   rtol=1e-5)
        assert tstep._micro_step == jstep._micro_step
        assert topt._global_step == jopt._global_step
        assert tsched.last_epoch == jsched.last_epoch
        assert tsched.lr.last_epoch == jsched.lr.last_epoch
        assert topt.get_lr() == jopt.get_lr()
    assert topt._global_step == 6 // accumulate
    jstep.sync()
    got = params_to_numpy(tm)
    for name, p in jm.named_parameters():
        want = np.asarray(p._data, np.float32)
        rel = np.linalg.norm(got[name] - want) / np.linalg.norm(want)
        assert rel <= 1e-4, f"{name}: relative L2 {rel:.3e}"


RATES = {
    "constant": lambda m: 1e-3,
    "linear_lr": lambda m: m.lr.LinearLR(1e-3, total_steps=4),
    "lambda_power": lambda m: m.lr.LambdaDecay(1e-3, lambda e: 0.9 ** e),
    "lambda_branch": lambda m: m.lr.LambdaDecay(
        1e-3, lambda e: 1.0 if e < 2 else 0.5),
    "multiplicative": lambda m: m.lr.MultiplicativeDecay(1e-3,
                                                         lambda e: 0.9),
    "cyclic": lambda m: m.lr.CyclicLR(1e-4, 1e-3, step_size_up=2),
}


@pytest.mark.parametrize("rate", sorted(RATES))
def test_fused_supported_follows_jax(rate):
    """``fused_supported`` (the rate computed on the device) is JAX's
    choice for each kind of rate: a float or a traceable schedule, not a
    stateful one or a lambda that branches on its step.  Either way
    ``run_steps`` equals single calls (each followed by the schedule's
    step) bit for bit, and leaves the same counters."""
    paddle.seed(7)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    jstep = JaxTrainStep(jm, _jax_loss, joptim.SGD(
        learning_rate=RATES[rate](joptim), parameters=jm.parameters()))
    rng = np.random.default_rng(7)
    batches = [tuple(torch.from_numpy(rng.integers(0, 64, (2, 8)))
                     for _ in range(2)) for _ in range(3)]
    runs = []
    for fused in (True, False):
        tm = params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")
        opt = toptim.Momentum(learning_rate=RATES[rate](toptim),
                              parameters=tm.parameters())
        step = TrainStep(tm, _port_loss, opt, accumulate_steps=2)
        assert step.fused_supported == jstep.fused_supported
        if fused:
            losses = step.run_steps(batches)
        else:
            losses = []
            for ids, labels in batches:
                losses.append(step(ids, labels))
                if step._sched() is not None:
                    step._sched().step()
            losses = torch.stack(losses)
        sched = step._sched()
        runs.append((losses, params_to_numpy(tm), opt._global_step,
                     step._micro_step, opt.get_lr(),
                     None if sched is None else sched.last_epoch))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    for name in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][name], runs[1][1][name])
    assert runs[0][2:] == runs[1][2:]
    assert runs[0][2:4] == (1, 3)
