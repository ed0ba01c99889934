"""Port parity of the rest of the vision model zoo
(``paddle_tpu_torch/vision/models/small_nets.py``, ``mobilenets.py``,
``inception.py``, the bridge ``models.convert.vision_params_*``) and of
the layers it added (``ReLU6``, ``Hardswish``, ``Hardsigmoid``,
``Swish``, ``LayerList``, grouped and depthwise ``Conv2D``) against the
JAX package on the CPU, f32, inputs and weights from numpy seeds.

- Eval forwards of each family with the same weights at its smallest
  legal input and a small ``scale`` / ``num_classes``: logits within
  relative L2 1e-5 (observed 1.5e-7 to 1.7e-6).  The JAX side runs as
  one XLA program a model (``_jax_program``, compiled at XLA's lowest
  optimization level) instead of one compile an op and shape.
  DenseNet's whole forward cost 18 s of JAX compiles, so its
  ``_DenseLayer`` and transition are held against JAX and the whole
  port densenet121 only for its output shape.
- Train mode (batch statistics, dropout p set to 0 on both sides):
  LeNet and mobilenet_v2(scale=0.25) through one ``Momentum`` step
  against JAX's ``TrainStep``: the loss within relative 1e-5, every
  parameter within relative L2 3e-4 (JAX's batch statistics, below,
  move its gradients: observed 1.1e-4 on one mobilenet_v2 bias) plus
  1e-6 an element (the rounding noise of a gradient that is 0), and
  the port's update over all parameters at least as close as JAX's to
  the port's f64 update (or within 1e-5 of it); b16 at 32 x 32 leaves
  mobilenet_v2's last maps 1 x 1, so each batch norm there sees 16
  values a channel (fewer turn rounding into sign flips, as in the
  ResNet tests).  GoogLeNet's three train-mode outputs.  A train-mode
  forward is held within 1e-4, and to be at least as close as JAX's to
  the port's f64 forward (``_train_forward_close``: JAX's f32 batch
  statistics round more; observed 6e-5 from JAX, 2.7e-5 from f64).
- ``relu6`` / ``hardswish`` / ``hardsigmoid`` / ``swish`` on a grid
  through -3, 0, 3 and 6: within 1e-6 absolute, and the gradients off
  the kinks; at the kinks relu6's and hardswish's equal JAX's.
- Under ``auto_cast`` O1 each op name the JAX package dispatches in a
  mobilenet_v3_small forward gives the types the JAX op gives.
"""
import collections
import contextlib
from unittest import mock

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
from paddle_tpu.framework.tape import no_grad
from paddle_tpu.framework.tensor import wrap_array
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.vision import models as jmodels
from paddle_tpu.vision.models import mobilenets as jmobilenets
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.convert import (_load, vision_params_from_numpy,
                                             vision_params_to_numpy)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.vision import models as tmodels
from paddle_tpu_torch.vision.models import mobilenets as tmobilenets

SKIP = {"cast", "reshape"}


@contextlib.contextmanager
def numpy_init(seed):
    """The JAX initializers' draws taken from a seeded CPU generator in
    f32: the same laws, without compiling ``jax.random`` for every
    parameter shape (about 0.45 s a shape on the CPU).  The draws are
    torch's (3x numpy's speed at f32 here: vgg11's classifier holds 119 M
    weights)."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(torch.empty(tuple(shape)).uniform_(
            float(minval), float(maxval), generator=gen).numpy(), dtype)

    def normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(torch.randn(tuple(shape),
                                       generator=gen).numpy(), dtype)

    with mock.patch.object(jax.random, "uniform", uniform), \
            mock.patch.object(jax.random, "normal", normal):
        yield


def _arrays(jm):
    out = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    out.update({n: np.asarray(b._data) for n, b in jm.named_buffers()})
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pair(arch, seed=0, **kw):
    with numpy_init(seed):
        jm = getattr(jmodels, arch)(**kw)
    return jm, vision_params_from_numpy(_arrays(jm), arch, device="cpu",
                                        **kw)


# XLA's CPU compiler at its lowest optimization level: a zoo model's
# forward compiles about 3x faster (googlenet: 0.9 s against 3.1 s), and
# the logits are unchanged within the tolerances below
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def _jax_program(jm, x):
    """``jm``'s forward on ``x`` as one XLA program (its parameters and
    buffers passed in, its batch-norm running statistics left as they
    are, as a compiled JAX step leaves them): the output's arrays, a
    tuple of them for several outputs."""
    tensors = [t for _, t in jm.named_parameters()] \
        + [t for _, t in jm.named_buffers()]

    def run(arrays, xa):
        saved = [t._data for t in tensors]
        try:
            for t, a in zip(tensors, arrays):
                t._data = a
            with no_grad():
                out = jm(wrap_array(xa))
        finally:
            for t, a in zip(tensors, saved):
                t._data = a
        return tuple(o._data for o in out) if isinstance(out, tuple) \
            else out._data

    arrays = [t._data for t in tensors]
    xa = jnp.asarray(x)
    return jax.jit(run).lower(arrays, xa).compile(
        compiler_options=FAST)(arrays, xa)


def _jax_forward(jm, x):
    return np.asarray(_jax_program(jm, x))


FAMILIES = [  # (factory, kwargs, input shape)
    ("LeNet", {}, (2, 1, 28, 28)),
    ("alexnet", dict(num_classes=10), (2, 3, 64, 64)),
    ("vgg11", dict(num_classes=10, batch_norm=True), (2, 3, 32, 32)),
    ("squeezenet1_1", dict(num_classes=10), (2, 3, 64, 64)),
    ("mobilenet_v1", dict(scale=0.25, num_classes=10), (2, 3, 32, 32)),
    ("mobilenet_v2", dict(scale=0.25, num_classes=10), (2, 3, 32, 32)),
    ("mobilenet_v3_small", dict(scale=0.5, num_classes=10),
     (2, 3, 32, 32)),
    ("shufflenet_v2_x0_25", dict(num_classes=10), (2, 3, 32, 32)),
    ("inception_v3", dict(num_classes=10), (2, 3, 75, 75)),
]


@pytest.mark.parametrize("arch,kw,shape", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_eval_forward_matches_jax(arch, kw, shape):
    jm, tm = _pair(arch, **kw)
    jm.eval()
    tm.eval()
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = _jax_forward(jm, x)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (shape[0], kw.get("num_classes", 10))
    assert _rel(got, want) <= 1e-5


def test_dense_layer_and_transition_match_jax():
    """DenseNet's blocks against JAX (eval and train mode), and the whole
    port densenet121's output shape."""
    with numpy_init(1):
        jm = jnn.Sequential(
            jmobilenets._DenseLayer(16, 8, 4),
            jmobilenets._DenseLayer(24, 8, 4),
            jnn.BatchNorm2D(32), jnn.ReLU(),
            jnn.Conv2D(32, 16, 1, bias_attr=False), jnn.AvgPool2D(2, 2))
    with torch.device("cpu"):
        tm = tnn.Sequential(
            tmobilenets._DenseLayer(16, 8, 4),
            tmobilenets._DenseLayer(24, 8, 4), tnn.BatchNorm2D(32),
            tnn.ReLU(), tnn.Conv2D(32, 16, 1, bias_attr=False),
            tnn.AvgPool2D(2, 2))
    _load(tm, _arrays(jm))
    x = np.random.default_rng(2).standard_normal(
        (4, 16, 8, 8)).astype(np.float32)
    for train in (True, False):
        jm.train() if train else jm.eval()
        tm.train(train)
        want = np.asarray(jm(paddle.to_tensor(x))._data)
        got = tm(torch.from_numpy(x)).detach().numpy()
        assert got.shape == (4, 16, 4, 4)
        assert _rel(got, want) <= 1e-5
    net = tmodels.densenet121(num_classes=7, device="cpu", seed=0).eval()
    with torch.no_grad():
        out = net(torch.randn(1, 3, 32, 32))
    assert out.shape == (1, 7) and torch.isfinite(out).all()
    assert len([m for m in net.modules()
                if isinstance(m, tmobilenets._DenseLayer)]) == 58


def _train_forward_close(jm, tm, x, arch, kw):
    """A train-mode forward (batch statistics) of the port within
    relative L2 1e-4 of the JAX program's, and at least as close as the
    JAX program's to the port's forward in f64: the JAX package's f32
    batch statistics round more (its compiled and eager forwards differ
    by 2.8e-5 at mobilenet_v2(scale=0.25) b16 x 32 x 32, which lies 6e-5
    from f64 where the port lies 2.7e-5)."""
    want = _jax_program(jm, x)
    wide = vision_params_from_numpy(_arrays(jm), arch, device="cpu",
                                    **kw).double()
    _no_dropout(wide)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        ref = wide(torch.from_numpy(x).double())
    if isinstance(got, torch.Tensor):
        got, want, ref = (got,), (want,), (ref,)
    assert len(got) == len(want) == len(ref)
    for g, w, r in zip(got, want, ref):
        g, w, r = g.numpy(), np.asarray(w), r.numpy()
        assert _rel(g, w) <= 1e-4
        assert _rel(g, r) <= max(_rel(w, r), 1e-5)
    return got


def _no_dropout(*models):
    for model in models:
        for m in model.sublayers() if hasattr(model, "sublayers") \
                else model.modules():
            if type(m).__name__ == "Dropout":
                m.p = 0.0


@pytest.mark.parametrize("arch,kw,shape", [
    ("LeNet", {}, (16, 1, 28, 28)),
    ("mobilenet_v2", dict(scale=0.25, num_classes=10), (16, 3, 32, 32))],
    ids=["LeNet", "mobilenet_v2"])
def test_train_forward_and_momentum_step_match_jax(arch, kw, shape):
    jm, tm = _pair(arch, **kw)
    _no_dropout(jm, tm)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.integers(0, 10, shape[0]).astype(np.int64)
    _train_forward_close(jm, tm, x, arch, kw)
    # the forward moved the port's running statistics (the JAX program
    # leaves them): put them back, so the steps start level
    start = _arrays(jm)
    _load(tm, start)
    wide = vision_params_from_numpy(start, arch, device="cpu",
                                    **kw).double()
    _no_dropout(wide)
    opt = dict(learning_rate=0.05, momentum=0.9, weight_decay=4e-5)
    jce, tce = jnn.CrossEntropyLoss(), tnn.CrossEntropyLoss()
    jstep = JaxTrainStep(jm, lambda o, t: jce(o, t), joptim.Momentum(
        parameters=jm.parameters(), **opt))
    tstep, wstep = (TrainStep(m, lambda o, t: tce(o, t), toptim.Momentum(
        parameters=m.parameters(), **opt)) for m in (tm, wide))
    jl = float(np.asarray(jstep(paddle.to_tensor(x),
                                paddle.to_tensor(y))._data))
    tl = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
    wstep(torch.from_numpy(x).double(), torch.from_numpy(y))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    jstep.sync()
    want, got = _arrays(jm), vision_params_to_numpy(tm)
    ref = vision_params_to_numpy(wide)
    names = [n for n, _p in jm.named_parameters()]
    for n in names:
        # 1e-6 an element: a batch-norm bias whose true gradient is 0 (a
        # bias that a linear layer and the next batch norm cancel) moves
        # by rounding noise alone
        assert np.linalg.norm(got[n] - want[n]) <= 3e-4 * np.linalg.norm(
            want[n]) + 1e-6 * np.sqrt(want[n].size), n
    # the port's update is at least as close as JAX's to the f64 one (or
    # within f32 rounding of it: 1e-5)
    moved = {k: np.concatenate([(d[n] - start[n]).ravel() for n in names])
             for k, d in (("port", got), ("jax", want), ("f64", ref))}
    assert _rel(moved["port"], moved["f64"]) <= max(
        _rel(moved["jax"], moved["f64"]), 1e-5)


def test_googlenet_eval_and_train_outputs_match_jax():
    """The eval forward (one output), then the three train-mode outputs
    (``out``, ``aux1``, ``aux2``) with dropout at 0 on both sides."""
    jm, tm = _pair("googlenet", num_classes=10)
    x = np.random.default_rng(4).standard_normal(
        (4, 3, 64, 64)).astype(np.float32)
    jm.eval()
    tm.eval()
    want = _jax_forward(jm, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 10)
    assert _rel(got, want) <= 1e-5
    jm.train()
    tm.train()
    _no_dropout(jm, tm)
    got = _train_forward_close(jm, tm, x, "googlenet",
                               dict(num_classes=10))
    assert len(got) == 3 and all(g.shape == (4, 10) for g in got)


def test_channel_shuffle_matches_jax():
    x = np.arange(2 * 12 * 3 * 2, dtype=np.float32).reshape(2, 12, 3, 2)
    for groups in (2, 3, 4):
        want = np.asarray(jmobilenets._channel_shuffle(
            paddle.to_tensor(x), groups)._data)
        got = tmobilenets._channel_shuffle(torch.from_numpy(x), groups)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["relu6", "hardswish", "hardsigmoid",
                                  "swish"])
def test_activations_on_a_grid_match_jax(name):
    """The functionals and their layers on a grid through -3, 0, 3 and 6
    (and values between), and the gradients off the kinks."""
    grid = np.concatenate([np.linspace(-8, 8, 161, dtype=np.float32),
                           np.float32([-3, 0, 3, 6, -3.0001, 2.9999])])
    want = np.asarray(getattr(JF, name)(paddle.to_tensor(grid))._data)
    t = torch.from_numpy(grid).requires_grad_()
    got = getattr(TF, name)(t)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-6)
    layer = {"relu6": tnn.ReLU6, "hardswish": tnn.Hardswish,
             "hardsigmoid": tnn.Hardsigmoid, "swish": tnn.Swish}[name]()
    np.testing.assert_array_equal(layer(t).detach().numpy(),
                                  got.detach().numpy())
    kinks = np.isin(grid, np.float32([-3, 0, 3, 6]))
    (gt,) = torch.autograd.grad(got.sum(), t)
    gj = np.asarray(jax.grad(lambda a: getattr(JF, name)(
        paddle.to_tensor(a))._data.sum())(jnp.asarray(grid)))
    np.testing.assert_allclose(gt.numpy()[~kinks], gj[~kinks], rtol=0,
                               atol=1e-6)
    if name in ("relu6", "hardswish"):
        # jax.nn.relu6's gradient at 0 and 6 is 0; torch's relu6 agrees
        np.testing.assert_array_equal(gt.numpy()[kinks], gj[kinks])


def test_hardsigmoid_is_the_clip_form():
    """``clip(x / 6 + 0.5, 0, 1)``, not a multiply by 0.1666667: the two
    round differently."""
    x = torch.linspace(-3, 3, 1001)
    np.testing.assert_array_equal(
        TF.hardsigmoid(x).numpy(),
        torch.clamp(x / 6.0 + 0.5, 0.0, 1.0).numpy())
    assert not torch.equal(TF.hardsigmoid(x),
                           torch.clamp(x * 0.1666667 + 0.5, 0.0, 1.0))


def _jax_types(jm, x):
    rec = collections.defaultdict(set)

    def hook(name, res):
        for leaf in jax.tree_util.tree_leaves(
                res, is_leaf=lambda v: hasattr(v, "_data")):
            rec[name].add(str(leaf.dtype))

    jdispatch.add_post_op_hook(hook)
    try:
        with jamp.auto_cast(level="O1", dtype="bfloat16"):
            _jax_program(jm, x)
    finally:
        jdispatch.remove_post_op_hook(hook)
    return {k: v for k, v in rec.items() if k not in SKIP}


def _port_types(monkeypatch, model, x):
    """The port's op outputs under the JAX op names: forward hooks on the
    layers, wrappers of the functions they call."""
    rec = collections.defaultdict(set)

    def put(name, out):
        rec[name].add(str(out.dtype).replace("torch.", ""))

    for attr, name in (("_batch_mean", "mean"), ("_batch_var", "var"),
                       ("_unbiased", "multiply"), ("add", "add"),
                       ("multiply", "multiply"), ("flatten", "flatten_"),
                       ("hardswish", "hardswish"), ("relu", "relu"),
                       ("hardsigmoid", "hardsigmoid")):
        fn = getattr(TF, attr)

        def recorded(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            put(_name, out)
            return out
        monkeypatch.setattr(TF, attr, recorded)
    by_type = {tnn.Conv2D: "conv2d", tnn.BatchNorm2D: "batch_norm_f",
               tnn.AdaptiveAvgPool2D: "adaptive_avg_pool2d_",
               tnn.Linear: "linear", tnn.Dropout: "dropout_"}
    hooks = [m.register_forward_hook(
        lambda _m, _i, out, op=op: put(op, out))
        for m in model.modules() for cls, op in by_type.items()
        if isinstance(m, cls)]
    try:
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            model(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    return dict(rec)


def test_amp_o1_op_output_types_follow_jax(monkeypatch):
    """mobilenet_v3_small in training (batch statistics, the SE block's
    ``multiply``, ``hardsigmoid``, the residual ``add``, dropout)."""
    jm, tm = _pair("mobilenet_v3_small", scale=0.5, num_classes=10)
    x = np.random.default_rng(5).standard_normal(
        (4, 3, 32, 32)).astype(np.float32)
    want = _jax_types(jm, x)
    got = _port_types(monkeypatch, tm, x)
    assert got == want
    assert want["conv2d"] == {"bfloat16"} and \
        want["hardsigmoid"] == {"bfloat16"} and \
        want["batch_norm_f"] == {"float32"}


def test_bridge_round_trip_exports_and_layer_list():
    assert set(tmodels.__all__) == {
        n for n in dir(jmodels) if not n.startswith("_")
        and callable(getattr(jmodels, n))}
    jm, tm = _pair("mobilenet_v3_large", scale=0.35, num_classes=5)
    arrays = _arrays(jm)
    back = vision_params_to_numpy(tm)
    assert back.keys() == arrays.keys()
    for n, a in arrays.items():
        np.testing.assert_array_equal(back[n], a, err_msg=n)
    with pytest.raises(KeyError):
        vision_params_from_numpy(dict(arrays, extra=np.zeros(1)),
                                 "mobilenet_v3_large", device="cpu",
                                 scale=0.35, num_classes=5)
    # depthwise convolutions: one input channel a group
    dw = [m for m in tm.modules() if isinstance(m, tnn.Conv2D)
          and m.groups > 1]
    assert dw and all(m.groups == m.in_channels == m.out_channels
                      and m.weight.shape[1] == 1 for m in dw)
    # every factory builds, seeded weights finite, dropouts on the
    # model's generator
    for name in ("squeezenet1_0", "shufflenet_v2_swish"):
        net = getattr(tmodels, name)(num_classes=3, device="cpu", seed=7)
        assert all(torch.isfinite(p).all() for p in net.parameters())
        drops = [m for m in net.modules() if isinstance(m, tnn.Dropout)]
        assert all(m.generator is net.generator for m in drops)
    layers = tnn.LayerList([tnn.ReLU(), tnn.ReLU6()])
    layers.append(tnn.Hardswish())
    layers.insert(0, tnn.Swish())
    del layers[1]
    assert [type(m).__name__ for m in layers] == ["Swish", "ReLU6",
                                                  "Hardswish"]
    assert [n for n, _ in layers.named_children()] == ["0", "1", "2"]
    assert isinstance(layers[1:], tnn.LayerList) and len(layers[1:]) == 2
