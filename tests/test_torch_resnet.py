"""Port parity of the ResNets (``paddle_tpu_torch/vision/models/
resnet.py``, the bridge ``models.convert.vision_params_*``) and of the
graphed step's batch-norm buffers against the JAX package on the CPU,
f32, inputs from numpy seeds.

- Forwards with the same weights: resnet50 in eval mode (the running
  statistics) at b2 x 3 x 32 x 32, logits within relative L2 1e-5
  (observed 8e-7); resnet18 in train mode (batch statistics) at b4 x 3 x
  64 x 64, within 1e-5 (observed 3e-6), with the running ``_mean`` /
  ``_variance`` of every batch norm after 3 forwards within 1e-5 of
  JAX's eager ones, then in eval mode on those statistics within 1e-5.  A batch norm over a handful of values (b2 at 32 x
  32 leaves 1 x 1 maps in the last stage: two values a channel) turns
  rounding into sign flips, so train-mode forwards are compared where
  each channel sees at least 16 values.
- A 3-step ``TrainStep`` (Momentum 1e-3, momentum 0.9, weight decay
  5e-4, b16 x 32 x 32, three batches) against JAX's ``TrainStep``:
  losses within relative 1e-5 (observed 2.2e-6), every parameter within
  relative L2 1e-4 (observed 8e-6; the last stage's 1 x 1 maps give each
  batch norm there 16 values a channel: at b8 the differences grow to
  1e-3 in three steps, at b2 to sign flips).  JAX's compiled step leaves
  the running statistics as they were (its ``batch_norm`` skips the
  update under a tracer); the port's graphed and eager steps update them
  (ROADMAP queue 3): they moved, and equal ``EagerTrainStep``'s bit for
  bit.
- Under ``auto_cast`` O1 and O2 (O2 with ``decorate`` on both, which
  leaves the port's batch-norm buffers in f32) each op name the JAX
  package dispatches gives the types the JAX op gives (``cast`` and
  ``reshape`` not compared).
- ``ceil_mode``: the JAX package's ``_pool`` takes it and never uses it,
  and the port follows (ROADMAP queue 3): the output shapes of
  ``ceil_mode=True`` are those of ``False``.
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
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.jit import EagerTrainStep, TrainStep
from paddle_tpu_torch.models.convert import (vision_params_from_numpy,
                                             vision_params_to_numpy)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.vision import models as tmodels

SKIP = {"cast", "reshape"}


def _arrays(jm):
    out = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    out.update({n: np.asarray(b._data) for n, b in jm.named_buffers()})
    return out


@contextlib.contextmanager
def numpy_init(seed):
    """The JAX initializers' draws taken from a numpy generator: the same
    laws, without compiling ``jax.random`` for every parameter shape
    (about 0.45 s a shape on the CPU)."""
    rng = np.random.default_rng(seed)

    def uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, shape), dtype)

    def normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape), dtype)

    with mock.patch.object(jax.random, "uniform", uniform), \
            mock.patch.object(jax.random, "normal", normal):
        yield


def _pair(arch, seed=0, **kw):
    with numpy_init(seed):
        jm = getattr(jmodels, arch)(num_classes=10, **kw)
    tm = vision_params_from_numpy(_arrays(jm), arch, device="cpu",
                                  num_classes=10, **kw)
    return jm, tm


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_eval_forward_matches_jax():
    """resnet50 here; resnet18's eval forward is held after its train
    forwards below."""
    arch = "resnet50"
    jm, tm = _pair(arch)
    jm.eval()
    tm.eval()
    x = np.random.default_rng(0).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jm(paddle.to_tensor(x))._data)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 10)
    assert _rel(got, want) <= 1e-5


def test_train_forward_and_running_stats_match_jax_eager():
    jm, tm = _pair("resnet18")
    rng = np.random.default_rng(1)
    for _ in range(3):
        x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
        want = np.asarray(jm(paddle.to_tensor(x))._data)
        got = tm(torch.from_numpy(x)).detach().numpy()
        assert _rel(got, want) <= 1e-5
    jstate, tstate = _arrays(jm), vision_params_to_numpy(tm)
    stats = [n for n in jstate if n.endswith(("_mean", "_variance"))]
    assert len(stats) == 2 * 20
    for n in stats:
        assert _rel(tstate[n], jstate[n]) <= 1e-5, n
    # eval mode normalizes by those statistics
    jm.eval()
    tm.eval()
    x = x[:2]
    want = np.asarray(jm(paddle.to_tensor(x))._data)
    assert _rel(tm(torch.from_numpy(x)).detach().numpy(), want) <= 1e-5


def test_bridge_round_trip_and_names():
    jm, tm = _pair("resnet18")
    arrays = _arrays(jm)
    back = vision_params_to_numpy(tm)
    assert back.keys() == arrays.keys()
    for n, a in arrays.items():
        np.testing.assert_array_equal(back[n], a, err_msg=n)
    with pytest.raises(KeyError):
        vision_params_from_numpy(dict(arrays, extra=np.zeros(1)),
                                 "resnet18", device="cpu", num_classes=10)


def test_momentum_train_step_matches_jax_and_updates_stats():
    jm, tm = _pair("resnet18")
    _, twin = _pair("resnet18")
    init = _arrays(jm)
    kw = dict(learning_rate=1e-3, momentum=0.9, weight_decay=5e-4)
    jce, tce = jnn.CrossEntropyLoss(), tnn.CrossEntropyLoss()
    jstep = JaxTrainStep(jm, lambda o, y: jce(o, y), joptim.Momentum(
        parameters=jm.parameters(), **kw))
    tstep = TrainStep(tm, lambda o, y: tce(o, y), toptim.Momentum(
        parameters=tm.parameters(), **kw))
    estep = EagerTrainStep(twin, lambda o, y: tce(o, y), toptim.Momentum(
        parameters=twin.parameters(), **kw))
    rng = np.random.default_rng(2)
    for _ in range(3):
        x = rng.standard_normal((16, 3, 32, 32)).astype(np.float32)
        y = rng.integers(0, 10, 16).astype(np.int64)
        jl = float(np.asarray(jstep(paddle.to_tensor(x),
                                    paddle.to_tensor(y))._data))
        tl = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
        el = float(estep(torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(tl - jl) <= 1e-5 * abs(jl)
        assert tl == el
    jstep.sync()
    want, got = _arrays(jm), vision_params_to_numpy(tm)
    for n, _p in jm.named_parameters():
        assert _rel(got[n], want[n]) <= 1e-4, n
    eager = vision_params_to_numpy(twin)
    stats = [n for n in init if n.endswith(("_mean", "_variance"))]
    for n in stats:
        np.testing.assert_array_equal(want[n], init[n], err_msg=n)
        assert not np.array_equal(got[n], init[n]), n
        np.testing.assert_array_equal(got[n], eager[n], err_msg=n)


def _jax_types(jm, level, x):
    rec = collections.defaultdict(set)

    def hook(name, res):
        for leaf in jax.tree_util.tree_leaves(
                res, is_leaf=lambda v: hasattr(v, "_data")):
            rec[name].add(str(leaf.dtype))

    jdispatch.add_post_op_hook(hook)
    try:
        with jamp.auto_cast(level=level, dtype="bfloat16"):
            jm(paddle.to_tensor(x))
    finally:
        jdispatch.remove_post_op_hook(hook)
    return {k: v for k, v in rec.items() if k not in SKIP}


def port_recorder(monkeypatch, model):
    """The port's op outputs under the JAX op names: forward hooks on the
    layers, wrappers of the functions they call.  Returns the record and
    the hooks to remove."""
    rec = collections.defaultdict(set)

    def put(name, *outs):
        for o in outs:
            if isinstance(o, tuple):
                put(name, *o)
            else:
                rec[name].add(str(o.dtype).replace("torch.", ""))

    def wrap(module, attr, name):
        fn = getattr(module, attr)

        def recorded(*a, **kw):
            out = fn(*a, **kw)
            put(name, out)
            return out
        monkeypatch.setattr(module, attr, recorded)

    for attr, name in (("_batch_mean", "mean"), ("_batch_var", "var"),
                       ("_unbiased", "multiply"), ("add", "add"),
                       ("flatten", "flatten_")):
        wrap(TF, attr, name)
    by_type = {tnn.Conv2D: "conv2d", tnn.BatchNorm2D: "batch_norm_f",
               tnn.ReLU: "relu", tnn.MaxPool2D: "max_pool2d",
               tnn.AdaptiveAvgPool2D: "adaptive_avg_pool2d_",
               tnn.Linear: "linear", tnn.LSTM: "rnn_LSTM",
               tnn.Flatten: "flatten_"}
    hooks = []
    for m in model.modules():
        for cls, op in by_type.items():
            if isinstance(m, cls):
                hooks.append(m.register_forward_hook(
                    lambda _m, _i, out, op=op: put(op, out)))
    return rec, hooks


def _blocks(nn, resnet, **kw):
    """Every op of a ResNet's forward in a few layers: the stem, a basic
    block, a bottleneck with its downsampling branch, the pool, flatten
    and the classifier."""
    down = nn.Sequential(nn.Conv2D(8, 16, 1, stride=2, bias_attr=False,
                                   **kw), nn.BatchNorm2D(16, **kw))
    return nn.Sequential(
        nn.Conv2D(3, 8, 7, stride=2, padding=3, bias_attr=False, **kw),
        nn.BatchNorm2D(8, **kw), nn.ReLU(), nn.MaxPool2D(3, 2, 1),
        resnet.BasicBlock(8, 8, **kw),
        resnet.BottleneckBlock(8, 4, stride=2, downsample=down, **kw),
        nn.AdaptiveAvgPool2D((1, 1)), nn.Flatten(),
        nn.Linear(16, 10, **({"bias": True} if kw else {})))


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_op_output_types_follow_jax(level, monkeypatch):
    """On the blocks of a ResNet (``_blocks``); the op names are those of
    a whole resnet18."""
    from paddle_tpu.vision.models import resnet as jresnet
    from paddle_tpu_torch.nn.layer.layers import init_weights
    from paddle_tpu_torch.vision.models import resnet as tresnet
    with numpy_init(0):
        jm = _blocks(jnn, jresnet)
    tm = _blocks(tnn, tresnet, device="cpu")
    init_weights(tm, 0)
    if level == "O2":
        jamp.decorate(jm, level="O2", dtype="bfloat16")
        amp.decorate(tm, level="O2", dtype="bfloat16")
        assert {b.dtype for b in tm.buffers()} == {torch.float32}
    x = np.random.default_rng(3).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    want = _jax_types(jm, level, x)
    rec, hooks = port_recorder(monkeypatch, tm)
    try:
        with amp.auto_cast(level=level, dtype="bfloat16"):
            tm(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    assert dict(rec) == want
    if level == "O1":
        # conv2d runs in bf16, its batch variance too (``var`` is on
        # neither list), and every batch norm's output in f32
        assert want["conv2d"] == {"bfloat16"} and want["var"] == \
            {"bfloat16"} and want["batch_norm_f"] == {"float32"}


def test_ceil_mode_is_ignored_as_in_jax():
    x = np.random.default_rng(4).standard_normal(
        (1, 2, 8, 9)).astype(np.float32)
    for kw in (dict(kernel_size=3, stride=2), dict(kernel_size=2,
                                                   stride=2, padding=1)):
        want = JF.max_pool2d(paddle.to_tensor(x), ceil_mode=True, **kw)
        got = tnn.MaxPool2D(ceil_mode=True, **kw)(torch.from_numpy(x))
        plain = TF.max_pool2d(torch.from_numpy(x), ceil_mode=False, **kw)
        assert tuple(got.shape) == tuple(want.shape) == tuple(plain.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want._data))
    # torch's own ceil_mode would give a fourth row and column here
    assert torch.nn.functional.max_pool2d(
        torch.from_numpy(x), 3, 2, ceil_mode=True).shape == (1, 2, 4, 4)


def test_builders_and_exports():
    from paddle_tpu.vision.models import resnet as jresnet
    # the ResNet names of the JAX package's exports (the rest of the zoo
    # is held by tests/test_torch_vision_zoo.py)
    assert {n for n in dir(jmodels) if not n.startswith("_")
            and getattr(jmodels, n) is getattr(jresnet, n, None)} \
        <= set(tmodels.__all__)
    m = tmodels.resnext50_32x4d(num_classes=0, with_pool=False,
                                device="cpu", seed=3)
    assert m.layer1[0].conv2.groups == 32 and not hasattr(m, "fc")
    wide = tmodels.wide_resnet50_2(num_classes=10, device="cpu", seed=None)
    assert wide.layer1[0].conv2.weight.shape[0] == 128
    seeded = tmodels.resnet18(num_classes=10, device="cpu", seed=5)
    for name, t in seeded.named_parameters():
        assert torch.isfinite(t).all(), name
