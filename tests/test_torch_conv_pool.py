"""Port parity of the convolution, pooling, batch norm, relu and flatten
ops and layers (``paddle_tpu_torch/nn/functional``, ``nn/layer/
conv_pool.py``, ``nn/layer/norm.py``, ``nn/layer/layers.py``) against the
JAX package's on the CPU, f32, inputs from numpy seeds.

- conv2d (and conv1d) over stride, padding (int, pairs, 2n ints, SAME,
  VALID), dilation and groups: output within 1e-5 absolute (observed
  <= 2e-6, outputs of order 10), the input and weight gradients of a
  random cotangent within 1e-5 of their largest entry (observed <= 3e-7
  relative).
- max_pool2d k3 s2 p1 on ReLU'd small integers, where most windows tie:
  output and input gradient equal exactly (both pick the first maximum of
  a window in row-major order).
- avg_pool2d (exclusive or not, symmetric, SAME and uneven padding) and
  adaptive_avg_pool2d over sizes that divide the input and sizes that do
  not: within 1e-6 absolute (observed <= 2e-7).
- BatchNorm2D: three training forwards then eval, outputs within 1e-5,
  the running ``_mean`` / ``_variance`` after each within 1e-6 (observed
  <= 1.2e-7), and the gradients of input, weight and bias within 1e-5 of
  their largest entry.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

CONV_CASES = {
    "s1_p1": dict(stride=1, padding=1),
    "s2_pairs": dict(stride=2, padding=(1, 2)),
    "s2_same": dict(stride=2, padding="SAME"),
    "valid": dict(stride=1, padding="VALID"),
    "uneven_2n": dict(stride=1, padding=[1, 0, 2, 1]),
    "dilation2": dict(dilation=2, padding=2),
    "groups2_s2": dict(groups=2, padding=1, stride=2),
    "depthwise": dict(groups=4, padding=1),
}


def _jt(a, grad=False):
    return paddle.to_tensor(a, stop_gradient=not grad)


def _tt(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _close_to_max(got, want, rel, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_value_and_grads_match_jax(case):
    kw = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    groups = kw.get("groups", 1)
    x = rng.standard_normal((2, 4, 9, 10)).astype(np.float32)
    w = rng.standard_normal((8, 4 // groups, 3, 3)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    jx, jw, jb = _jt(x, True), _jt(w, True), _jt(b, True)
    jo = JF.conv2d(jx, jw, jb, **kw)
    g = rng.standard_normal(jo.shape).astype(np.float32)
    (jo * _jt(g)).sum().backward()
    tx, tw, tb = _tt(x, True), _tt(w, True), _tt(b, True)
    to = TF.conv2d(tx, tw, tb, **kw)
    (to * _tt(g)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo._data),
                               rtol=0, atol=1e-5)
    for got, want, name in ((tx, jx, "x"), (tw, jw, "weight"),
                            (tb, jb, "bias")):
        _close_to_max(got.grad.numpy(), np.asarray(want.grad._data), 1e-5,
                      name)


@pytest.mark.parametrize("padding", [1, "SAME", (2, 1)])
def test_conv1d_and_conv_layers_match_jax(padding):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 11)).astype(np.float32)
    w = rng.standard_normal((5, 3, 3)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    jo = JF.conv1d(_jt(x), _jt(w), _jt(b), stride=2, padding=padding)
    to = TF.conv1d(_tt(x), _tt(w), _tt(b), stride=2, padding=padding)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo._data), rtol=0,
                               atol=1e-5)
    # the layers: same arguments, the bridge's weights, bias_attr=False
    paddle.seed(1)
    jl = jnn.Conv2D(3, 6, 3, stride=2, padding=padding, bias_attr=False)
    tl = tnn.Conv2D(3, 6, 3, stride=2, padding=padding, bias_attr=False)
    assert tl.bias is None and jl.bias is None
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(jl.weight._data)))
    x2 = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(tl(_tt(x2)).detach().numpy(),
                               np.asarray(jl(_jt(x2))._data), rtol=0,
                               atol=1e-5)


def test_conv_init_follows_jax_law():
    """The JAX package's KaimingUniform at slope sqrt(5) over fan_in =
    in / groups * kh * kw is U(-1/sqrt(fan_in), 1/sqrt(fan_in)), and its
    bias is drawn from the same range: the port's draws fill that range
    and have its spread."""
    torch.manual_seed(0)
    layer = tnn.Conv2D(16, 32, 3, groups=2)
    bound = 1 / np.sqrt(8 * 9)
    w = layer.weight.detach().numpy()
    b = layer.bias.detach().numpy()
    assert w.shape == (32, 8, 3, 3)
    assert np.abs(w).max() <= bound and np.abs(b).max() <= bound
    assert np.abs(w).max() > 0.95 * bound
    assert abs(w.std() - bound / np.sqrt(3)) < 0.05 * bound


def test_max_pool_ties_pick_the_same_element():
    rng = np.random.default_rng(0)
    x = np.maximum(rng.integers(-2, 3, (2, 3, 9, 9)), 0).astype(np.float32)
    jx, tx = _jt(x, True), _tt(x, True)
    jo = JF.max_pool2d(jx, 3, 2, 1)
    g = rng.standard_normal(jo.shape).astype(np.float32)
    (jo * _jt(g)).sum().backward()
    to = tnn.MaxPool2D(3, 2, 1)(tx)
    (to * _tt(g)).sum().backward()
    np.testing.assert_array_equal(to.detach().numpy(), np.asarray(jo._data))
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  np.asarray(jx.grad._data))


@pytest.mark.parametrize("padding", [0, 1, "SAME", [0, 1, 1, 0]],
                         ids=["p0", "p1", "same", "uneven"])
@pytest.mark.parametrize("exclusive", [True, False],
                         ids=["exclusive", "inclusive"])
def test_avg_pool2d_matches_jax(padding, exclusive):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 9, 8)).astype(np.float32)
    jo = JF.avg_pool2d(_jt(x), 3, 2, padding, exclusive=exclusive)
    to = tnn.AvgPool2D(3, 2, padding, exclusive=exclusive)(_tt(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo._data), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("out", [(1, 1), (2, 2), (3, 3), (5, 3)],
                         ids=["1x1", "2x2_divides", "3x3", "5x3"])
def test_adaptive_avg_pool2d_matches_jax(out):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 8, 6)).astype(np.float32)
    jx, tx = _jt(x, True), _tt(x, True)
    jo = JF.adaptive_avg_pool2d(jx, out)
    to = tnn.AdaptiveAvgPool2D(out)(tx)
    assert tuple(to.shape) == (2, 3) + out
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo._data),
                               rtol=0, atol=1e-6)
    jo.sum().backward()
    to.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._data),
                               rtol=0, atol=1e-6)


def test_batch_norm_train_eval_and_running_stats():
    rng = np.random.default_rng(4)
    paddle.seed(0)
    jb = jnn.BatchNorm2D(4)
    tb = tnn.BatchNorm2D(4)
    w = rng.standard_normal(4).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    jb.weight.set_value(w)
    jb.bias.set_value(b)
    with torch.no_grad():
        tb.weight.copy_(torch.from_numpy(w))
        tb.bias.copy_(torch.from_numpy(b))
    for _ in range(3):
        x = (rng.standard_normal((3, 4, 5, 5)) * 2 + 1).astype(np.float32)
        jx, tx = _jt(x, True), _tt(x, True)
        jo, to = jb(jx), tb(tx)
        np.testing.assert_allclose(to.detach().numpy(),
                                   np.asarray(jo._data), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tb._mean.numpy(),
                                   np.asarray(jb._mean._data), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(tb._variance.numpy(),
                                   np.asarray(jb._variance._data), rtol=0,
                                   atol=1e-6)
    g = rng.standard_normal(x.shape).astype(np.float32)
    (jo * _jt(g)).sum().backward()
    (to * _tt(g)).sum().backward()
    for got, want, name in ((tx.grad, jx.grad, "x"),
                            (tb.weight.grad, jb.weight.grad, "weight"),
                            (tb.bias.grad, jb.bias.grad, "bias")):
        _close_to_max(got.numpy(), np.asarray(want._data), 1e-5, name)
    jb.eval()
    tb.eval()
    np.testing.assert_allclose(tb(_tt(x)).detach().numpy(),
                               np.asarray(jb(_jt(x))._data), rtol=0,
                               atol=1e-5)


def test_relu_flatten_sequential():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(TF.relu(_tt(x)).numpy(),
                                  np.asarray(JF.relu(_jt(x))._data))
    from paddle_tpu.tensor.manipulation import flatten as jflatten
    for start, stop in ((1, -1), (0, 2), (2, 3)):
        np.testing.assert_array_equal(
            TF.flatten(_tt(x), start, stop).numpy(),
            np.asarray(jflatten(_jt(x), start, stop)._data))
        assert tnn.Flatten(start, stop)(_tt(x)).shape == \
            tuple(jnn.Flatten(start, stop)(_jt(x)).shape)
    seq = tnn.Sequential(tnn.ReLU(), ("flat", tnn.Flatten()), tnn.ReLU())
    assert [n for n, _ in seq.named_children()] == ["0", "flat", "2"]
    sliced = seq[1:]
    assert [n for n, _ in sliced.named_children()] == ["0", "1"]
    assert isinstance(seq[1], tnn.Flatten) and len(seq) == 3
    assert seq(_tt(x)).shape == (2, 60)
