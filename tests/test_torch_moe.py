"""Port parity of the MoE model family: ``MoELayer`` (ragged and dense
paths, stacked and listed experts), ``LlamaMoeForCausalLM``'s logits and
balance loss, and greedy and sampled ``generate`` (MoE and dense) against
the JAX package on the same weights, in f32 on the CPU; plus the weight
bridge and the gate-loss divergence of the cache path."""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.incubate.distributed.models.moe import (
    ExpertFFN as JaxExpertFFN, MoELayer as JaxMoELayer,
    NaiveGate as JaxNaiveGate)
from paddle_tpu.models import LlamaMoeConfig as JaxMoeConfig
from paddle_tpu.models import LlamaMoeForCausalLM as JaxMoeLM
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch.incubate.distributed.models.moe import (
    ExpertFFN, MoELayer, NaiveGate)
from paddle_tpu_torch.models.convert import (
    moe_params_from_numpy, moe_params_to_numpy, params_from_numpy)
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_moe import (LlamaMoeConfig,
                                               LlamaMoeForCausalLM)
from paddle_tpu_torch.nn import Linear

D = 16
SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=64)
MOE = dict(SMALL, num_experts=4, moe_top_k=2)
# every model test uses one prompt shape, so the JAX package's per-shape
# compilations are shared across the file
PROMPT = np.random.default_rng(0).integers(0, 128, (2, 6)).astype(np.int32)


def _arrays(layer):
    return {n: np.asarray(p._data) for n, p in layer.named_parameters()}


def _load(module, arrays):
    """JAX-package parameters into a port module of the same names,
    Linear weights transposed ([in, out] there, [out, in] here)."""
    linear = {f"{n}.weight" for n, m in module.named_modules()
              if isinstance(m, Linear)}
    module.load_state_dict({n: torch.from_numpy(np.array(
        a.T if n in linear else a)) for n, a in arrays.items()})
    return module


def _close(got, want, tol=1e-5):
    """f32 of the same function summed in other orders: within ``tol``
    of the largest magnitude."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale)


def _tokens(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class _JaxExpert(jnn.Layer):
    def __init__(self, hidden=32):
        super().__init__()
        self.fc1 = jnn.Linear(D, hidden)
        self.fc2 = jnn.Linear(hidden, D)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.gelu(self.fc1(x)))


class _PortExpert(torch.nn.Module):
    def __init__(self, hidden=32):
        super().__init__()
        self.fc1 = Linear(D, hidden, bias=True)
        self.fc2 = Linear(hidden, D, bias=True)

    def forward(self, x):
        # paddle's gelu defaults to the exact erf form
        return self.fc2(torch.nn.functional.gelu(self.fc1(x)))


class _JaxDenseGate(JaxNaiveGate):
    def forward(self, x):        # an override: the dense combine path
        return super().forward(x)


class _PortDenseGate(NaiveGate):
    def forward(self, x):
        return super().forward(x)


def _moe_pair(gate, act="swiglu", train=False, experts="stacked"):
    """A JAX MoELayer and its port carrying the same weights."""
    if experts == "stacked":
        jx = JaxExpertFFN(4, D, 32, activation=act)
        px = ExpertFFN(4, D, 32, activation=act)
    else:
        jx = [_JaxExpert() for _ in range(4)]
        px = [_PortExpert() for _ in range(4)]
    if gate == "dense":
        jl = JaxMoELayer(D, jx, gate=_JaxDenseGate(D, 4, 1))
        pl = MoELayer(D, px, gate=_PortDenseGate(D, 4, 1))
    else:
        cfg = {"type": gate, "top_k": 1 if gate == "switch" else 2}
        jl, pl = JaxMoELayer(D, jx, gate=cfg), MoELayer(D, px, gate=cfg)
    _load(pl, _arrays(jl))
    for layer in (jl, pl):
        layer.train() if train else layer.eval()
    return jl, pl


@pytest.mark.parametrize("gate,act,train,experts", [
    ("naive", "swiglu", True, "stacked"),
    ("gshard", "swiglu", False, "stacked"),
    ("switch", "gelu", False, "stacked"),
    ("gshard", "relu", False, "stacked"),
    ("dense", "swiglu", True, "stacked"),
    ("gshard", None, False, "list"),
], ids=["naive-train", "gshard-eval", "switch-eval-gelu",
        "gshard-eval-relu", "dense-custom-gate", "list-of-experts"])
def test_moe_layer_matches_jax(gate, act, train, experts):
    paddle.seed(11)
    torch.manual_seed(11)
    jl, pl = _moe_pair(gate, act, train, experts)
    x = _tokens(1, (2, 24, D))
    want = np.asarray(jl(paddle.to_tensor(x))._data)
    with torch.no_grad():
        got = pl(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 24, D)
    _close(got, want)
    if jl.l_aux is None:
        assert pl.l_aux is None
    else:
        np.testing.assert_allclose(float(pl.l_aux),
                                   float(np.asarray(jl.l_aux._data)),
                                   rtol=1e-5)


@pytest.mark.parametrize("recompute", [0, 1], ids=["plain", "recompute"])
def test_moe_layer_grads_match_jax(recompute):
    """y.sum() + l_aux through the ragged path: the input's and the
    gate's gradients (the gating Function's backward) and the experts'."""
    paddle.seed(12)
    jl, pl = _moe_pair("gshard")
    pl.recompute_interval = recompute
    x = _tokens(2, (2, 24, D))
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    (jl(jx).sum() + jl.l_aux).backward()
    px = torch.from_numpy(x).requires_grad_()
    pl.train()                     # recompute applies in training only;
    pl.gate.eval()                 # the gate stays on eval's capacity
    (pl(px).sum() + pl.l_aux).backward()
    _close(px.grad.numpy(), np.asarray(jx.grad._data))
    _close(pl.gate.gate_weight.grad.numpy(),
           np.asarray(jl.gate.gate_weight.grad._data))
    _close(pl.experts.w1.grad.numpy(), np.asarray(jl.experts.w1.grad._data))


def _moe_models(gate_type="gshard", seed=3):
    kw = dict(MOE, gate_type=gate_type,
              moe_top_k=1 if gate_type == "switch" else 2)
    paddle.seed(seed)
    jm = JaxMoeLM(JaxMoeConfig(**kw))
    tm = moe_params_from_numpy(LlamaMoeConfig(**kw), _arrays(jm),
                               device="cpu")
    return jm, tm


@pytest.mark.parametrize("gate_type,train", [("gshard", False),
                                             ("naive", True),
                                             ("switch", False)],
                         ids=["gshard-eval", "naive-train", "switch-eval"])
def test_forward_logits_and_aux_match_jax(gate_type, train):
    jm, tm = _moe_models(gate_type)
    for m in (jm, tm):
        m.train() if train else m.eval()
    jl, ja = jm(paddle.to_tensor(PROMPT))
    with torch.no_grad():
        tl, ta = tm(torch.from_numpy(PROMPT).long())
    _close(tl.numpy(), np.asarray(jl._data))
    np.testing.assert_allclose(float(ta), float(np.asarray(ja._data)),
                               rtol=1e-5)


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "top_k"])
def test_moe_generate_matches_jax(sample):
    jm, tm = _moe_models()
    jm.eval()
    tm.eval()
    kw = dict(max_new_tokens=3, do_sample=sample, top_k=5 if sample else None,
              temperature=0.8 if sample else 1.0, seed=4)
    want = np.asarray(jm.generate(paddle.to_tensor(PROMPT), **kw)._data)
    got = tm.generate(torch.from_numpy(PROMPT), **kw)
    assert got.shape == (2, 9) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the cache path leaves no gate loss (the JAX model leaves one per
    # layer, which leaks into its next aux_loss())
    assert all(layer.moe.gate.loss is None for layer in tm.model.layers)
    assert all(layer.moe.gate.loss is not None for layer in jm.model.layers)


def test_dense_generate_matches_jax():
    paddle.seed(5)
    jm = JaxLM(JaxConfig(**SMALL))
    tm = params_from_numpy(LlamaConfig(**SMALL), _arrays(jm), device="cpu")
    want = np.asarray(jm.generate(paddle.to_tensor(PROMPT),
                                  max_new_tokens=3)._data)
    got = tm.generate(torch.from_numpy(PROMPT).long(), max_new_tokens=3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_stops_on_eos():
    jm, tm = _moe_models(seed=6)
    tm.eval()
    first = tm.generate(torch.from_numpy(PROMPT), max_new_tokens=1)[:, -1]
    eos = int(first[0])
    out = tm.generate(torch.from_numpy(PROMPT), max_new_tokens=5,
                      eos_token_id=eos)
    assert int(out[0, 6]) == eos and (out[0, 6:] == eos).all()


def test_bridge_round_trip_and_gate_dtype():
    jm, _ = _moe_models(seed=7)
    arrays = _arrays(jm)
    tm = moe_params_from_numpy(LlamaMoeConfig(**MOE), arrays, device="cpu")
    back = moe_params_to_numpy(tm)
    assert sorted(back) == sorted(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    # only Linear weights are transposed
    np.testing.assert_array_equal(
        tm.model.layers[0].self_attn.q_proj.weight.detach().numpy(),
        arrays["model.layers.0.self_attn.q_proj.weight"].T)
    assert tuple(tm.model.layers[1].moe.gate.gate_weight.shape) == (64, 4)
    assert tuple(tm.model.layers[1].moe.experts.w1.shape) == (4, 64, 128)
    bf = moe_params_from_numpy(LlamaMoeConfig(**MOE), arrays, device="cpu",
                               dtype=torch.bfloat16, gate_dtype=torch.float32)
    gate = bf.model.layers[0].moe.gate
    assert gate.gate_weight.dtype == torch.float32
    assert bf.model.layers[0].moe.experts.w1.dtype == torch.bfloat16
    x = torch.zeros(3, 64, dtype=torch.bfloat16)
    assert gate.gate_logits(x).dtype == torch.float32
    with pytest.raises(KeyError):
        moe_params_from_numpy(LlamaMoeConfig(**MOE),
                              dict(arrays, extra=np.zeros(1)), device="cpu")
    missing = dict(arrays)
    del missing["model.layers.1.moe.gate.gate_weight"]
    with pytest.raises(KeyError):
        moe_params_from_numpy(LlamaMoeConfig(**MOE), missing, device="cpu")


def test_seeded_init_draws_the_jax_distributions():
    cfg = LlamaMoeConfig(**dict(MOE, intermediate_size=512))
    a = LlamaMoeForCausalLM(cfg, device="cpu", seed=5)
    b = LlamaMoeForCausalLM(cfg, device="cpu", seed=5)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    ex = a.model.layers[0].moe.experts
    # XavierNormal over [E, d, 2h]: fan_in d * 2h, fan_out E * 2h
    want = (2.0 / ((4 + 64) * 1024)) ** 0.5
    assert abs(float(ex.w1.detach().std()) / want - 1) < 0.02
    assert not ex.b1.any() and not ex.b2.any()
    gw = a.model.layers[0].moe.gate.gate_weight
    assert abs(float(gw.detach().std()) / (2.0 / 68) ** 0.5 - 1) < 0.15
    assert abs(float(a.lm_head.weight.detach().std()) - 0.02) < 0.002


def test_config_defaults_and_cuda_entry_point(monkeypatch):
    assert LlamaMoeConfig(gate_type="switch").moe_top_k == 1
    assert LlamaMoeConfig().moe_top_k == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaMoeForCausalLM(LlamaMoeConfig(**MOE))
