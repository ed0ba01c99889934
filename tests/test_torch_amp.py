"""Port parity of automatic mixed precision (``paddle_tpu_torch/amp``)
against the JAX package's ``paddle_tpu.amp`` on the CPU.

- Output types: the tiny LLaMA's and LLaMA-MoE's forwards under
  ``auto_cast`` O1 and O2 give, at every op name the JAX package
  dispatches, the types the JAX ops give.  The JAX side is recorded by a
  post-op hook on its dispatch point; the port has no dispatch point, so
  its ops are recorded where its modules compute them (forward hooks on
  its layers, wrappers of the functions the models call).  ``cast`` (the
  amp hook's own casts) and ``reshape`` (a view: torch keeps its input's
  type, and the JAX O2 reshape cast of the MoE tokens shows in
  ``moe_ragged_dispatch``) are the two names not compared.
- ``TrainStep(amp_level="O1")``: three losses of an f32 tiny LLaMA
  within relative 1e-2 of JAX's (the two round the bf16 products and
  sums at different places; observed 1e-4..1e-3).
- ``decorate`` O2, and ``GradScaler`` step for step beside the JAX one.
"""
import collections
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as joptim
from paddle_tpu import amp as jamp
from paddle_tpu.framework import dispatch as jdispatch
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import LlamaMoeConfig as JaxMoeConfig
from paddle_tpu.models import LlamaMoeForCausalLM as JaxMoeLM
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.incubate.distributed.models.moe import ExpertFFN
from paddle_tpu_torch.incubate.distributed.models.moe import gate as tgate
from paddle_tpu_torch.incubate.distributed.models.moe import \
    moe_layer as tmoe_layer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import (moe_params_from_numpy,
                                             params_from_numpy)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaDecoderLayer,
                                           LlamaForCausalLM)
from paddle_tpu_torch.models.llama_moe import (LlamaMoeConfig,
                                               LlamaMoeDecoderLayer,
                                               LlamaMoeModel)
from paddle_tpu_torch.nn import functional as TF

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
MOE = dict(TINY, num_experts=4, moe_top_k=2)
IDS = np.random.default_rng(0).integers(0, 128, (2, 8)).astype(np.int32)
SKIP = {"cast", "reshape"}


def _name(dtype):
    return str(dtype).replace("torch.", "")


def _models(kind, gate_type="gshard", seed=0):
    paddle.seed(seed)
    if kind == "dense":
        jm = JaxLM(JaxConfig(**TINY))
    else:
        jm = JaxMoeLM(JaxMoeConfig(**MOE, gate_type=gate_type))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    if kind == "dense":
        tm = params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")
    else:
        tm = moe_params_from_numpy(
            LlamaMoeConfig(**MOE, gate_type=gate_type), arrays,
            device="cpu")
    return jm, tm


def _jax_types(jm, level):
    rec = collections.defaultdict(set)

    def hook(name, res):
        for leaf in jax.tree_util.tree_leaves(
                res, is_leaf=lambda x: hasattr(x, "_data")):
            rec[name].add(str(leaf.dtype))

    jdispatch.add_post_op_hook(hook)
    try:
        with jamp.auto_cast(level=level, dtype="bfloat16"):
            jm(paddle.to_tensor(IDS))
    finally:
        jdispatch.remove_post_op_hook(hook)
    return {k: v for k, v in rec.items() if k not in SKIP}


@contextlib.contextmanager
def _port_recorder(tm, monkeypatch):
    """Record the port's op outputs under the JAX op names."""
    rec = collections.defaultdict(set)

    def put(name, *outs):
        for o in outs:
            rec[name].add(_name(o.dtype))

    def wrap(module, attr, name):
        fn = getattr(module, attr)

        def recorded(*a, **kw):
            out = fn(*a, **kw)
            put(name, *(out if isinstance(out, tuple) else (out,)))
            return out
        monkeypatch.setattr(module, attr, recorded)

    wrap(tllama, "apply_rope", "fused_rope")
    wrap(tllama, "flash_attention_bshd", "flash_attention")
    wrap(tgate, "_moe_topk_routing", "moe_topk_routing")
    wrap(tgate.NaiveGate, "gate_logits", "matmul")
    wrap(tmoe_layer, "_ragged_dispatch", "moe_ragged_dispatch")
    wrap(tmoe_layer, "_ragged_combine", "moe_ragged_combine")
    # the layers' balance losses summed: one add a layer after the first
    wrap(LlamaMoeModel, "aux_loss", "add")
    silu = torch.nn.functional.silu
    monkeypatch.setattr(tllama, "F", types.SimpleNamespace(
        **dict(vars(torch.nn.functional),
               silu=lambda x: (lambda y: (put("silu", y), y)[1])(silu(x)))))
    hooks = []
    by_type = {tnn.Embedding: "embedding_", tnn.RMSNorm: "rms_norm_f",
               tnn.Linear: "linear", ExpertFFN: "expert_ffn"}
    for name, m in tm.named_modules():
        for cls, op in by_type.items():
            if isinstance(m, cls):
                hooks.append(m.register_forward_hook(
                    lambda _m, _i, out, op=op: put(op, out)))
        if isinstance(m, (LlamaDecoderLayer, LlamaMoeDecoderLayer)):
            # the residual adds: the first feeds the second norm, the
            # second is the layer's output
            hooks.append(m.register_forward_hook(
                lambda _m, _i, out: put("add", out)))
            hooks.append(m.post_attention_layernorm.register_forward_pre_hook(
                lambda _m, inp: put("add", inp[0])))
        if name.endswith("mlp.down_proj"):
            hooks.append(m.register_forward_pre_hook(
                lambda _m, inp: put("multiply", inp[0])))
    try:
        yield rec
    finally:
        for h in hooks:
            h.remove()


@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_op_output_types_follow_jax(kind, level, monkeypatch):
    jm, tm = _models(kind)
    want = _jax_types(jm, level)
    with _port_recorder(tm, monkeypatch) as rec:
        with amp.auto_cast(level=level, dtype="bfloat16"):
            out = tm(torch.from_numpy(IDS).long())
    if kind == "moe":
        rec["multiply"].add(_name(out[1].dtype))     # aux * weight
    got = {k: v for k, v in rec.items()}
    assert got == want


def test_o1_gate_logits_take_the_oracle():
    """Under O1 the gate's ``matmul`` is white-listed: bf16 logits, which
    route on the oracle, not the gating kernel's path."""
    _jm, tm = _models("moe", gate_type="naive")
    seen = []
    real = tgate.topk_gating

    def spy(logits, *a):
        seen.append(logits.dtype)
        return real(logits, *a)

    tgate.topk_gating = spy
    try:
        tm(torch.from_numpy(IDS).long())
        assert seen == [torch.float32] * 2
        seen.clear()
        with amp.auto_cast(level="O1"):
            tm(torch.from_numpy(IDS).long())
        assert seen == []
    finally:
        tgate.topk_gating = real


def test_custom_lists_and_o0():
    x = torch.randn(3, 4)
    w = torch.randn(5, 4)
    lin = tnn.Linear(4, 5)
    lin.weight.data.copy_(w)
    with amp.auto_cast(level="O1"):
        assert lin(x).dtype == torch.bfloat16
    with amp.auto_cast(level="O1", custom_black_list={"linear"}):
        assert lin(x).dtype == torch.float32
    with amp.auto_cast(level="O0"):
        assert lin(x).dtype == torch.float32
    with amp.auto_cast(enable=False):
        assert lin(x).dtype == torch.float32
    with amp.amp_guard(level="O1", dtype="float16"):
        assert lin(x).dtype == torch.float16
    assert lin(x).dtype == torch.float32
    with pytest.raises(ValueError):
        amp.auto_cast(level="O3")


def _jax_loss(logits, labels):
    return JF.cross_entropy(logits.reshape([-1, 128]).astype("float32"),
                            labels.reshape([-1]))


def _port_loss(logits, labels):
    return TF.cross_entropy(logits.reshape(-1, 128).float(),
                            labels.reshape(-1))


def test_o1_train_step_follows_jax():
    jm, tm = _models("dense", seed=1)
    jstep = JaxTrainStep(jm, _jax_loss, joptim.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()), amp_level="O1")
    tstep = TrainStep(tm, _port_loss, toptim.AdamW(
        learning_rate=1e-3, parameters=tm.parameters()), amp_level="O1",
        amp_dtype="bfloat16")
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 128, (2, 32)).astype(np.int32)
    lab = rng.integers(0, 128, (2, 32)).astype(np.int32)
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(np.asarray(jstep(paddle.to_tensor(ids),
                                         paddle.to_tensor(lab))._data)))
        tl.append(float(tstep(torch.from_numpy(ids).long(),
                              torch.from_numpy(lab).long())))
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    assert tl[-1] < tl[0]
    # parameters and their gradients stay f32; the state is restored
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert amp._state.enabled is False


def test_o1_recompute_runs_under_the_forward_state():
    """A checkpointed layer's recomputation (on the backward's thread)
    runs under the forward's amp state: the same loss and gradients as
    without recompute."""
    grads = []
    for remat in (False, True):
        _jm, tm = _models("dense", seed=2)
        tm.config.use_recompute = remat
        with amp.auto_cast(level="O1"):
            logits = tm(torch.from_numpy(IDS).long())
        _port_loss(logits, torch.from_numpy(IDS).long()).backward()
        grads.append([p.grad.clone() for p in tm.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decorate_o2():
    """JAX ``test_o2_decorate``: the Linear's weights in bf16, f32
    masters, a bf16 output under O2; and a decorated f32 LLaMA holding
    bf16-exact weights trains as the same LLaMA built in bf16, bit for
    bit (the RoPE tables stay f32 in both)."""
    net = tnn.Linear(4, 4)
    torch.nn.init.normal_(net.weight)
    opt = toptim.Adam(learning_rate=0.01, parameters=net.parameters())
    net2, opt2 = amp.decorate(net, opt, level="O2", dtype="bfloat16")
    assert net2 is net and opt2 is opt and opt._multi_precision
    assert net.weight.dtype == torch.bfloat16
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        assert net(torch.randn(2, 4)).dtype == torch.bfloat16
    jnet = jnn.Linear(4, 4)
    jopt = joptim.Adam(learning_rate=0.01, parameters=jnet.parameters())
    jnet, jopt = jamp.decorate(jnet, jopt, level="O2", dtype="bfloat16")
    assert "bfloat16" in str(jnet.weight.dtype) and jopt._multi_precision

    cfg = LlamaConfig(**TINY)
    bf = LlamaForCausalLM(cfg, device="cpu", dtype=torch.bfloat16, seed=3)
    f32 = LlamaForCausalLM(cfg, device="cpu", seed=None)
    f32.load_state_dict({k: v.float() for k, v in bf.state_dict().items()})
    opt32 = toptim.AdamW(learning_rate=1e-3, parameters=f32.parameters())
    f32, opt32 = amp.decorate(f32, opt32, level="O2")
    for a, b in zip(f32.parameters(), bf.parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert f32.model.rope_cos.dtype == torch.float32
    steps = [TrainStep(bf, _port_loss, toptim.AdamW(
        learning_rate=1e-3, parameters=bf.parameters(),
        multi_precision=True)), TrainStep(f32, _port_loss, opt32)]
    ids = torch.from_numpy(IDS).long()
    losses = [[float(s(ids, ids)) for _ in range(3)] for s in steps]
    assert losses[0] == losses[1]


def test_grad_scaler_follows_jax():
    """The JAX tests' cases (scale and unscale; a skip on inf with
    backoff), then the scale's path over 7 steps with an inf injected at
    steps 2 and 5 (incr_every_n_steps=2), beside the JAX scaler on the
    same gradients: the same scales, the same skipped steps, parameters
    within 1e-6; and state_dict / load_state_dict."""
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal(3).astype(np.float32)
    xs = rng.standard_normal((7, 3)).astype(np.float32)
    jw = paddle.to_tensor(w0.copy(), stop_gradient=False)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    jopt = joptim.SGD(learning_rate=0.1, parameters=[jw])
    topt = toptim.SGD(learning_rate=0.1, parameters=[tw])
    kw = dict(init_loss_scaling=128.0, incr_every_n_steps=2)
    js, ts = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    jscales, tscales = [], []
    for i, x in enumerate(xs):
        big = 1e38 if i in (2, 5) else 1.0
        jl = (jw * paddle.to_tensor(x * big)).sum()
        tl = (tw * torch.from_numpy(x * big)).sum()
        scaled = ts.scale(tl)
        if i == 0:
            assert float(scaled.detach()) == 128.0 * float(tl.detach())
        js.scale(jl).backward()
        scaled.backward()
        js.step(jopt)
        ts.step(topt)
        js.update()
        ts.update()
        jopt.clear_grad()
        topt.clear_grad()
        jscales.append(js.state_dict()["scale"])
        tscales.append(ts.state_dict()["scale"])
    assert tscales == jscales
    assert tscales[2] < tscales[1]                   # backoff on the inf
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw._data),
                               rtol=0, atol=1e-6)
    sd = ts.state_dict()
    assert sd == js.state_dict()
    again = amp.GradScaler()
    again.load_state_dict(sd)
    assert again.state_dict()["scale"] == sd["scale"]
    assert again.state_dict()["incr_count"] == sd["incr_count"]
    # disabled: pass-through
    off = amp.GradScaler(enable=False)
    loss = torch.tensor(3.0)
    assert off.scale(loss) is loss and not off.is_enable()
    assert amp.is_bfloat16_supported() and amp.is_float16_supported()
