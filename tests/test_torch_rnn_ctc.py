"""Port parity of the recurrent layers (``paddle_tpu_torch/nn/layer/
rnn.py``), the CTC loss and decoder (``nn/functional/ctc.py``) and CRNN
(``models/crnn.py``, the bridge ``models.convert.crnn_params_*``)
against the JAX package on the CPU, f32, inputs and weights from numpy
seeds.

- LSTM, GRU and SimpleRNN, 2 layers, one direction and both, batch- and
  time-major, with and without initial states: outputs and final states
  within 1e-5 absolute (observed <= 2e-7), and the input's gradient
  within 1e-5 of its largest entry.
- The cells through ``RNN`` / ``BiRNN`` with ``sequence_length``:
  outputs and states within 1e-5.
- ctc_loss on logits with repeated labels (a label twice in a row, where
  the recursion may not skip) and a zero-length label, per-sample input
  lengths, each reduction and ``norm_by_times``: values within relative
  1e-5 (observed 1e-7) and the logits' gradient within 1e-5 of its
  largest entry (observed 3e-8).
- ctc_decode equal to JAX's.
- crnn_tiny: logits within relative L2 1e-5 (observed 7e-7) with the
  bridge's weights; a 2-step ``TrainStep`` with Adam(1e-3) and the
  mean CTC loss against JAX's ``TrainStep``: losses within relative 1e-5,
  every parameter within relative L2 1e-4 (observed 7e-6) except the
  backbone convolutions' biases.  A batch norm follows each of those and
  takes out any constant a channel, so their gradient is zero up to
  rounding, and Adam turns that noise into steps of about lr either way
  in both frameworks: they are held to stay within 2 lr a step of where
  they started.
- Under ``auto_cast`` O1, CRNN's forward and the CTC loss give at every
  JAX op name the JAX op's types (``cast`` and ``reshape`` not compared;
  O2 is held on the ResNet blocks in ``tests/test_torch_resnet.py``).
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
from paddle_tpu.models import crnn_tiny as jax_crnn_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import crnn as tcrnn
from paddle_tpu_torch.models.convert import (crnn_params_from_numpy,
                                             crnn_params_to_numpy)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import ctc as tctc

TINY = dict(img_height=16, hidden_size=48, channels=(16, 32, 64))
SKIP = {"cast", "reshape"}


@contextlib.contextmanager
def numpy_init(seed):
    """The JAX initializers' draws taken from a numpy generator: the same
    laws, without compiling ``jax.random`` for every parameter shape."""
    rng = np.random.default_rng(seed)

    def uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, shape), dtype)

    def normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape), dtype)

    with mock.patch.object(jax.random, "uniform", uniform), \
            mock.patch.object(jax.random, "normal", normal):
        yield


def _arrays(jm):
    out = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    out.update({n: np.asarray(b._data) for n, b in jm.named_buffers()})
    return out


def _jt(a, grad=False):
    return paddle.to_tensor(a, stop_gradient=not grad)


def _tt(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


RNN_CASES = [("LSTM", "bidirect", False), ("LSTM", "forward", True),
             ("GRU", "bidirect", True), ("GRU", "forward", False),
             ("SimpleRNN", "bidirect", False),
             ("SimpleRNN", "forward", True)]


@pytest.mark.parametrize(
    "cls,direction,time_major", RNN_CASES,
    ids=[f"{c}-{d}-{'time' if t else 'batch'}_major"
         for c, d, t in RNN_CASES])
def test_rnn_layers_match_jax(cls, direction, time_major):
    rng = np.random.default_rng(0)
    with numpy_init(1):
        jm = getattr(jnn, cls)(5, 6, num_layers=2, direction=direction,
                               time_major=time_major)
    tm = getattr(tnn, cls)(5, 6, num_layers=2, direction=direction,
                           time_major=time_major)
    tm.load_state_dict({n: torch.from_numpy(np.array(a))
                        for n, a in _arrays(jm).items()})
    x = rng.standard_normal((7, 3, 5) if time_major else (3, 7, 5)) \
        .astype(np.float32)
    states = None
    if not time_major:   # initial states on the batch-major cases
        h0 = rng.standard_normal((2 * (1 + (direction == "bidirect")), 3,
                                  6)).astype(np.float32)
        states = (h0, h0[::-1].copy()) if cls == "LSTM" else h0
    jx, tx = _jt(x, True), _tt(x, True)
    jargs = None if states is None else \
        tuple(_jt(s) for s in states) if cls == "LSTM" else _jt(states)
    targs = None if states is None else \
        tuple(_tt(s) for s in states) if cls == "LSTM" else _tt(states)
    jo, js = jm(jx, jargs)
    to, ts = tm(tx, targs)
    for got, want in zip(_leaves((to, ts)), _leaves((jo, js))):
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want._data), rtol=0,
                                   atol=1e-5)
    g = rng.standard_normal(to.shape).astype(np.float32)
    (jo * _jt(g)).sum().backward()
    (to * _tt(g)).sum().backward()
    want = np.asarray(jx.grad._data)
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
def test_cells_through_rnn_and_birnn_with_lengths(cell):
    rng = np.random.default_rng(1)
    with numpy_init(2):
        jfw, jbw = getattr(jnn, cell)(4, 5), getattr(jnn, cell)(4, 5)
    tfw, tbw = getattr(tnn, cell)(4, 5), getattr(tnn, cell)(4, 5)
    for j, t in ((jfw, tfw), (jbw, tbw)):
        t.load_state_dict({n: torch.from_numpy(np.array(a))
                           for n, a in _arrays(j).items()})
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    lengths = np.array([6, 2, 4], np.int64)
    jo, js = jnn.BiRNN(jfw, jbw)(_jt(x), sequence_length=_jt(lengths))
    to, ts = tnn.BiRNN(tfw, tbw)(_tt(x), sequence_length=_tt(lengths))
    for got, want in zip(_leaves((to, ts)), _leaves((jo, js))):
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(want._data), rtol=0,
                                   atol=1e-5)
    jo, _ = jnn.RNN(jfw, time_major=True)(_jt(x))
    to, _ = tnn.RNN(tfw, time_major=True)(_tt(x))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo._data),
                               rtol=0, atol=1e-5)


def _ctc_inputs():
    rng = np.random.default_rng(2)
    T, B, C, L = 12, 4, 6, 5
    logits = (2 * rng.standard_normal((T, B, C))).astype(np.float32)
    labels = rng.integers(1, C, (B, L)).astype(np.int64)
    labels[0, 1] = labels[0, 0]            # a repeat: no skip between them
    labels[1, 2] = labels[1, 1]
    ilen = np.array([12, 10, 12, 8], np.int64)
    llen = np.array([5, 3, 0, 2], np.int64)
    return logits, labels, ilen, llen


@pytest.mark.parametrize("norm_by_times", [False, True],
                         ids=["plain", "norm_by_times"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_and_gradient_match_jax(reduction, norm_by_times):
    logits, labels, ilen, llen = _ctc_inputs()
    jl, tl = _jt(logits, True), _tt(logits, True)
    jo = JF.ctc_loss(jl, _jt(labels), _jt(ilen), _jt(llen),
                     reduction=reduction, norm_by_times=norm_by_times)
    to = TF.ctc_loss(tl, _tt(labels), _tt(ilen), _tt(llen),
                     reduction=reduction, norm_by_times=norm_by_times)
    want = np.asarray(jo._data)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(to.detach().numpy(), want, rtol=1e-5)
    weights = np.arange(1, to.numel() + 1, dtype=np.float32).reshape(
        to.shape)
    (jo * _jt(weights)).sum().backward()
    (to * _tt(weights)).sum().backward()
    gwant = np.asarray(jl.grad._data)
    np.testing.assert_allclose(tl.grad.numpy(), gwant, rtol=0,
                               atol=1e-5 * np.abs(gwant).max())


def test_ctc_decode_matches_jax():
    logits, _, ilen, _ = _ctc_inputs()
    logits[:, 0, :] = 0.0
    logits[::2, 0, 3] = 5.0                # 3 on even frames, blank between
    jdec, jlen = JF.ctc_decode(_jt(logits), _jt(ilen))
    tdec, tlen = TF.ctc_decode(_tt(logits), _tt(ilen))
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec._data))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen._data))
    assert tdec[0, :6].tolist() == [3] * 6


def _crnn_pair(seed=0):
    with numpy_init(seed):
        jm = jax_crnn_tiny(8, img_height=16)
    tm = crnn_params_from_numpy(_arrays(jm), 8, device="cpu", **TINY)
    return jm, tm


def _crnn_batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 1, 16, 32)).astype(np.float32)
    y = rng.integers(1, 8, (4, 4)).astype(np.int64)
    return x, y


ILEN = np.full(4, 8, np.int64)
LLEN = np.full(4, 4, np.int64)


def test_crnn_forward_and_bridge_match_jax():
    jm, tm = _crnn_pair()
    x, _ = _crnn_batch(3)
    want = np.asarray(jm(_jt(x))._data)
    got = tm(_tt(x)).detach().numpy()
    assert got.shape == (8, 4, 8)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
    arrays = _arrays(jm)
    back = crnn_params_to_numpy(tm)
    assert back.keys() == arrays.keys()
    assert "rnn.weight_hh_l1_reverse" in back
    for n in ("backbone.1._mean", "backbone.1._variance"):
        np.testing.assert_allclose(back[n], arrays[n], rtol=0, atol=1e-6)


def test_crnn_adam_train_step_matches_jax():
    jm, tm = _crnn_pair()
    init = _arrays(jm)
    lr = 1e-3
    jstep = JaxTrainStep(
        jm, lambda o, y: JF.ctc_loss(o, y, _jt(ILEN), _jt(LLEN)),
        joptim.Adam(learning_rate=lr, parameters=jm.parameters()))
    tstep = TrainStep(
        tm, lambda o, y: TF.ctc_loss(o, y, _tt(ILEN), _tt(LLEN)),
        toptim.Adam(learning_rate=lr, parameters=tm.parameters()))
    for seed in (4, 5):
        x, y = _crnn_batch(seed)
        jl = float(np.asarray(jstep(_jt(x), _jt(y))._data))
        tl = float(tstep(_tt(x), _tt(y)))
        assert abs(tl - jl) <= 1e-5 * abs(jl)
    jstep.sync()
    want, got = _arrays(jm), crnn_params_to_numpy(tm)
    noise = {f"backbone.{i}.bias" for i in (0, 4, 8)}
    for n, _p in jm.named_parameters():
        if n in noise:
            for side in (got[n], want[n]):
                assert np.abs(side - init[n]).max() <= 2 * 2 * lr, n
        else:
            assert np.linalg.norm(got[n] - want[n]) \
                <= 1e-4 * np.linalg.norm(want[n]), n


def _jax_types(jm, level, x, y):
    rec = collections.defaultdict(set)

    def hook(name, res):
        for leaf in jax.tree_util.tree_leaves(
                res, is_leaf=lambda v: hasattr(v, "_data")):
            rec[name].add(str(leaf.dtype))

    jdispatch.add_post_op_hook(hook)
    try:
        with jamp.auto_cast(level=level, dtype="bfloat16"):
            JF.ctc_loss(jm(_jt(x)), _jt(y), _jt(ILEN), _jt(LLEN))
    finally:
        jdispatch.remove_post_op_hook(hook)
    return {k: v for k, v in rec.items() if k not in SKIP}


def test_crnn_amp_op_output_types_follow_jax(monkeypatch):
    level = "O1"
    jm, tm = _crnn_pair()
    x, y = _crnn_batch(6)
    want = _jax_types(jm, level, x, y)
    rec = collections.defaultdict(set)

    def put(name, out):
        for o in _leaves(out):
            rec[name].add(str(o.dtype).replace("torch.", ""))

    def wrap(module, attr, name):
        fn = getattr(module, attr)

        def recorded(*a, **kw):
            out = fn(*a, **kw)
            put(name, out)
            return out
        monkeypatch.setattr(module, attr, recorded)

    for module, attr, name in (
            (TF, "_batch_mean", "mean"), (TF, "_batch_var", "var"),
            (TF, "_unbiased", "multiply"), (tcrnn, "_transpose", "transpose"),
            (tctc, "_ctc_nll", "ctc_loss_"), (tctc, "_clip", "clip"),
            (tctc, "_divide", "divide"), (tctc, "_mean", "mean")):
        wrap(module, attr, name)
    by_type = {tnn.Conv2D: "conv2d", tnn.BatchNorm2D: "batch_norm_f",
               tnn.ReLU: "relu", tnn.MaxPool2D: "max_pool2d",
               tnn.Linear: "linear", tnn.LSTM: "rnn_LSTM"}
    hooks = [m.register_forward_hook(
        lambda _m, _i, out, op=op: put(op, out))
        for m in tm.modules() for cls, op in by_type.items()
        if isinstance(m, cls)]
    try:
        with amp.auto_cast(level=level, dtype="bfloat16"):
            TF.ctc_loss(tm(_tt(x)), _tt(y), _tt(ILEN), _tt(LLEN))
    finally:
        for h in hooks:
            h.remove()
    assert dict(rec) == want
