"""Port parity of ``LBFGS`` (``paddle_tpu_torch/optimizer``) against the
JAX package's on the CPU: the JAX suite's quadratic
(``test_submodule_surfaces.py`` ``test_lbfgs_converges``), five steps of
a small linear regression with and without the strong-Wolfe search,
with gradient clipping and coupled L2 decay (parameters within 1e-5 of
JAX's after every step: both run the same f32 recursion, summed in other
orders), and a line search that runs out of its 10 tries, where both
move the parameters by the step size halved once more than the last one
evaluated."""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as joptim
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim


def _pair(values):
    """One parameter vector in each package, from the same values."""
    w = paddle.create_parameter([len(values)])
    w.set_value(paddle.to_tensor(np.asarray(values, np.float32)))
    return w, torch.nn.Parameter(torch.tensor(values, dtype=torch.float32))


def _quad_closures(jw, tw, jopt, topt, target):
    jt = paddle.to_tensor(np.asarray(target, np.float32))
    tt = torch.tensor(target, dtype=torch.float32)

    def jclosure():
        jopt.clear_grad()
        loss = ((jw - jt) ** 2).sum()
        loss.backward()
        return loss

    def tclosure():
        topt.clear_grad()
        loss = ((tw - tt) ** 2).sum()
        loss.backward()
        return loss

    return jclosure, tclosure


def test_quadratic_converges_as_jax():
    jw, tw = _pair([3.0, -2.0])
    kw = dict(learning_rate=0.5, max_iter=30, line_search_fn="strong_wolfe")
    jopt = joptim.LBFGS(parameters=[jw], **kw)
    topt = toptim.LBFGS(parameters=[tw], **kw)
    jc, tc = _quad_closures(jw, tw, jopt, topt, [1.0, 2.0])
    jopt.step(jc)
    topt.step(tc)
    np.testing.assert_allclose(tw.detach().numpy(), [1.0, 2.0], atol=1e-4)
    np.testing.assert_allclose(tw.detach().numpy(), jw.numpy(), atol=1e-6)
    assert topt.max_eval == 30 * 5 // 4
    assert len(topt._s) == len(jopt._s)


@pytest.mark.parametrize("search,lr", [(None, 1.0), ("strong_wolfe", 0.3)],
                         ids=["fixed_step", "strong_wolfe"])
def test_linear_regression_follows_jax(search, lr):
    """The clip (norm 4) is active in the first iterations.  Both cases
    converge: where clipped curvature pairs make L-BFGS diverge (a
    smaller fixed step, a tighter clip), both packages diverge and their
    f32 roundings grow with the iterates, so such a run compares
    nothing."""
    paddle.seed(0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 3)).astype(np.float32)
    y = (x @ np.array([[1.5], [-2.0], [0.5]], np.float32) + 0.3
         + 0.1 * rng.standard_normal((16, 1))).astype(np.float32)
    jlin, tlin = jnn.Linear(3, 1), tnn.Linear(3, 1, bias=True)
    with torch.no_grad():
        tlin.weight.copy_(torch.tensor(np.asarray(jlin.weight._data).T))
        tlin.bias.copy_(torch.tensor(np.asarray(jlin.bias._data)))
    kw = dict(learning_rate=lr, max_iter=4, history_size=3,
              line_search_fn=search, weight_decay=0.01)
    jopt = joptim.LBFGS(parameters=jlin.parameters(),
                        grad_clip=jnn.ClipGradByGlobalNorm(4.0), **kw)
    topt = toptim.LBFGS(parameters=list(tlin.parameters()),
                        grad_clip=tnn.ClipGradByGlobalNorm(4.0), **kw)
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    def jclosure():
        jopt.clear_grad()
        loss = ((jlin(jx) - jy) ** 2).mean()
        loss.backward()
        return loss

    def tclosure():
        topt.clear_grad()
        loss = ((tlin(tx) - ty) ** 2).mean()
        loss.backward()
        return loss

    losses = []
    for _ in range(5):
        jl = float(np.asarray(jopt.step(jclosure)._data))
        tl = float(topt.step(tclosure).detach())
        losses.append(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(
            tlin.weight.detach().numpy().T, np.asarray(jlin.weight._data),
            rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            tlin.bias.detach().numpy(), np.asarray(jlin.bias._data),
            rtol=0, atol=1e-5)
    assert losses[-1] < losses[0]


def test_search_out_of_tries_as_jax():
    """A step size so large that every one of the 10 tries fails the
    sufficient-decrease test: each halves t, so the last evaluation (the
    parameters' place, and the loss returned) is at lr / 2^9 along
    d = -g (the first iteration has no history), while the iteration
    goes on from x0 + t * d with t = lr / 2^10: the stored step s is
    that one.  JAX does the same."""
    lr = 1e6
    w0, target = np.array([3.0, -2.0]), np.array([1.0, 2.0])
    jw, tw = _pair(list(w0))
    kw = dict(learning_rate=lr, max_iter=1, line_search_fn="strong_wolfe")
    jopt = joptim.LBFGS(parameters=[jw], **kw)
    topt = toptim.LBFGS(parameters=[tw], **kw)
    jc, tc = _quad_closures(jw, tw, jopt, topt, list(target))
    jloss = float(np.asarray(jopt.step(jc)._data))
    tloss = float(topt.step(tc).detach())
    d = -2.0 * (w0 - target)
    evaluated = w0 + lr / 2 ** 9 * d
    np.testing.assert_allclose(tw.detach().numpy(), evaluated, rtol=1e-6)
    np.testing.assert_allclose(tw.detach().numpy(), jw.numpy(), rtol=1e-6)
    np.testing.assert_allclose(tloss, ((evaluated - target) ** 2).sum(),
                               rtol=1e-5)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
    assert len(topt._s) == len(jopt._s) == 1
    np.testing.assert_allclose(topt._s[0].numpy(), lr / 2 ** 10 * d,
                               rtol=1e-6)
    np.testing.assert_allclose(topt._s[0].numpy(), np.asarray(jopt._s[0]),
                               rtol=1e-6)


def test_step_needs_a_closure():
    _jw, tw = _pair([1.0])
    with pytest.raises(ValueError):
        toptim.LBFGS(parameters=[tw]).step()
