"""Port parity of the fit path (``paddle_tpu_torch/hapi``, ``io``,
``metric``, ``framework/io.py``) against the JAX package's on the CPU.

- A tiny BERT (dropout 0) with the same weights in both packages,
  ``Model.prepare(AdamW, CrossEntropyLoss, Accuracy).fit`` over the same
  batches (one numpy seed shuffles both loaders), then ``evaluate`` and
  ``predict``: the step losses, eval loss and accuracy within relative
  1e-4 of JAX's (f32; the two round attention, layer norm and the AdamW
  update at different places, observed 1e-6..1e-5; accuracy counts are
  equal).
- ``EarlyStopping`` and ``ReduceLROnPlateau`` fed the same eval logs make
  the same decisions (stop flag, wait, best, the rate) as JAX's.
- ``DeferredScalar``: the loop hands one a step and reads none back
  until the epoch's end.
- ``save``/``load``: a ``Model`` round trip restores weights and
  optimizer state exactly; each package reads the other's files as the
  same numpy tree.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as joptim
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.io import Dataset as JaxDataset
from paddle_tpu.metric import Accuracy as JaxAccuracy
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JaxBert
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.hapi import DeferredScalar, Model
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.metric import Accuracy
from paddle_tpu_torch.models.bert import BertConfig
from paddle_tpu_torch.models.convert import (bert_params_from_numpy,
                                             bert_params_to_numpy)

TINY = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
SEQ = 16


def _sst2(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, TINY["vocab_size"], (n, SEQ)).astype(np.int32)
    y = (x == 7).any(axis=1).astype(np.int64)
    return x, y


class PortSST2(Dataset):
    def __init__(self, n, seed=0):
        self.x, self.y = _sst2(n, seed)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class JaxSST2(JaxDataset):
    def __init__(self, n, seed=0):
        self.x, self.y = _sst2(n, seed)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _models(lr=1e-3):
    paddle.seed(0)
    jnet = JaxBert(JaxBertConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jnet.named_parameters()}
    tnet = bert_params_from_numpy(BertConfig(**TINY), arrays, device="cpu")
    jm = JaxModel(jnet).prepare(
        joptim.AdamW(learning_rate=lr, parameters=jnet.parameters()),
        jnn.CrossEntropyLoss(), JaxAccuracy(), jit_compile=False)
    tm = Model(tnet).prepare(
        toptim.AdamW(learning_rate=lr, parameters=tnet.parameters()),
        tnn.CrossEntropyLoss(), Accuracy())
    return jm, tm


def test_fit_evaluate_predict_match_jax():
    jm, tm = _models()
    np.random.seed(1)
    jh = jm.fit(JaxSST2(32), batch_size=8, epochs=2, verbose=0,
                shuffle=True)
    np.random.seed(1)
    th = tm.fit(PortSST2(32), batch_size=8, epochs=2, verbose=0,
                shuffle=True)
    assert len(th["loss"]) == len(jh["loss"]) == 8
    assert all(isinstance(v, float) for v in th["loss"])
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    je = jm.evaluate(JaxSST2(16, seed=1), batch_size=8, verbose=0)
    te = tm.evaluate(PortSST2(16, seed=1), batch_size=8, verbose=0)
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-4)
    assert te["acc"] == je["acc"]
    jp = jm.predict(JaxSST2(16, seed=1), batch_size=8)
    tp = tm.predict(PortSST2(16, seed=1), batch_size=8)
    assert len(tp) == len(jp) == 2
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b._data),
                                   rtol=1e-4, atol=1e-5)
    got = bert_params_to_numpy(tm.network)
    for n, p in jm.network.named_parameters():
        if n.endswith("k_proj.bias"):
            # its gradient is zero up to rounding (a key bias shifts a
            # query's scores by one constant), which Adam amplifies
            continue
        np.testing.assert_allclose(got[n], np.asarray(p._data), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_fit_with_eval_data_and_num_iters():
    jm, tm = _models()
    np.random.seed(2)
    jh = jm.fit(JaxSST2(32), eval_data=JaxSST2(16, seed=1), batch_size=8,
                epochs=3, verbose=0, num_iters=6)
    np.random.seed(2)
    th = tm.fit(PortSST2(32), eval_data=PortSST2(16, seed=1), batch_size=8,
                epochs=3, verbose=0, num_iters=6)
    assert len(th["loss"]) == len(jh["loss"]) == 6
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    assert len(th["eval_loss"]) == len(jh["eval_loss"]) == 2
    np.testing.assert_allclose(np.ravel(th["eval_loss"]),
                               np.ravel(jh["eval_loss"]), rtol=1e-4)
    assert th["eval_acc"] == jh["eval_acc"]


class _Shell:
    """What a callback reads of a model: ``_optimizer`` and
    ``stop_training``."""

    def __init__(self, opt):
        self._optimizer = opt
        self.stop_training = False


EVAL_LOGS = [{"loss": [v], "acc": a} for v, a in (
    (1.0, 0.5), (0.9, 0.55), (0.95, 0.55), (0.899, 0.6), (0.91, 0.52),
    (0.93, 0.5), (0.8, 0.7), (0.85, 0.69), (0.86, 0.69), (0.87, 0.68))]


@pytest.mark.parametrize("monitor,mode,patience,min_delta,baseline", [
    ("loss", "auto", 2, 0.0, None),
    ("loss", "min", 1, 0.05, None),
    ("acc", "auto", 2, 0.0, None),
    ("acc", "max", 3, 0.01, 0.6),
])
def test_early_stopping_decisions_match_jax(monitor, mode, patience,
                                            min_delta, baseline):
    kw = dict(monitor=monitor, mode=mode, patience=patience, verbose=0,
              min_delta=min_delta, baseline=baseline, save_best_model=False)
    j, t = jcb.EarlyStopping(**kw), tcb.EarlyStopping(**kw)
    j.set_model(_Shell(None))
    t.set_model(_Shell(None))
    for logs in EVAL_LOGS:
        j.on_eval_end(dict(logs))
        t.on_eval_end(dict(logs))
        assert (t.model.stop_training, t.wait, t.best) == \
            (j.model.stop_training, j.wait, j.best)


@pytest.mark.parametrize("monitor,factor,patience,cooldown,min_lr", [
    ("loss", 0.5, 1, 0, 0.0),
    ("loss", 0.1, 2, 1, 2e-4),
    ("acc", 0.5, 1, 2, 0.0),
])
def test_reduce_lr_on_plateau_matches_jax(monitor, factor, patience,
                                          cooldown, min_lr):
    kw = dict(monitor=monitor, factor=factor, patience=patience, verbose=0,
              cooldown=cooldown, min_lr=min_lr)
    j, t = jcb.ReduceLROnPlateau(**kw), tcb.ReduceLROnPlateau(**kw)
    w = torch.nn.Parameter(torch.zeros(2))
    j.set_model(_Shell(joptim.SGD(learning_rate=0.01, parameters=[
        paddle.create_parameter([2], "float32")])))
    t.set_model(_Shell(toptim.SGD(learning_rate=0.01, parameters=[w])))
    for logs in EVAL_LOGS:
        j.on_eval_end(dict(logs))
        t.on_eval_end(dict(logs))
        assert t.model._optimizer.get_lr() == j.model._optimizer.get_lr()
        assert (t.wait, t.best, t.cooldown_counter) == \
            (j.wait, j.best, j.cooldown_counter)


def test_losses_are_read_back_only_at_epoch_ends(monkeypatch):
    reads = []
    real = DeferredScalar.item
    counted = lambda self: (reads.append(1), real(self))[1]  # noqa: E731
    monkeypatch.setattr(DeferredScalar, "item", counted)
    monkeypatch.setattr(DeferredScalar, "__float__", counted)
    seen = []

    class Probe(tcb.Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append(("batch", len(reads),
                         isinstance(logs["loss"], DeferredScalar)))

        def on_epoch_end(self, epoch, logs=None):
            seen.append(("epoch", len(reads), type(logs["loss"])))

    _, tm = _models()
    hist = tm.fit(PortSST2(24), batch_size=8, epochs=2, verbose=0,
                  callbacks=[Probe()])
    # no read during an epoch; the epoch's 3 losses and its last logs'
    # loss at its end
    assert seen == [("batch", 0, True)] * 3 + [("epoch", 4, float)] \
        + [("batch", 4, True)] * 3 + [("epoch", 8, float)]
    assert all(isinstance(v, float) for v in hist["loss"])


def test_monitor_callback_feeds_the_port_registry():
    from paddle_tpu_torch import monitor
    steps = monitor.counter("train_steps_total", "train steps executed")
    before = steps.value()
    _, tm = _models()
    tm.fit(PortSST2(16), batch_size=8, epochs=1, verbose=0,
           callbacks=[tcb.MonitorCallback()])
    assert steps.value() == before + 2
    assert np.isfinite(monitor.gauge("train_loss", "").value())


def test_model_save_load_round_trip(tmp_path):
    _, tm = _models()
    tm.fit(PortSST2(16), batch_size=8, epochs=1, verbose=0)
    tm.save(str(tmp_path / "ckpt"))
    _, other = _models()
    other.load(str(tmp_path / "ckpt"))
    want, got = tm.network.state_dict(), other.network.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    so, oo = tm._optimizer.state_dict(), other._optimizer.state_dict()
    assert so.keys() == oo.keys()
    for k in so:
        if isinstance(so[k], torch.Tensor):
            assert torch.equal(so[k], oo[k]), k
        else:
            assert so[k] == oo[k], k


def test_files_cross_packages(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "ids": np.arange(5, dtype=np.int64), "step": 7,
            "nested": [rng.standard_normal(2).astype(np.float32), "name"]}
    # the port writes, JAX reads
    tio.save({"w": torch.from_numpy(tree["w"]),
              "ids": torch.from_numpy(tree["ids"]), "step": 7,
              "nested": [torch.from_numpy(tree["nested"][0]), "name"]},
             str(tmp_path / "port.pd"))
    got = paddle.load(str(tmp_path / "port.pd"))
    np.testing.assert_array_equal(np.asarray(got["w"]._data), tree["w"])
    np.testing.assert_array_equal(np.asarray(got["ids"]._data), tree["ids"])
    np.testing.assert_array_equal(np.asarray(got["nested"][0]._data),
                                  tree["nested"][0])
    assert got["step"] == 7 and got["nested"][1] == "name"
    # JAX writes (bf16 too), the port reads
    paddle.save({"w": paddle.to_tensor(tree["w"]),
                 "b": paddle.to_tensor(tree["w"]).astype("bfloat16"),
                 "ids": paddle.to_tensor(tree["ids"]), "step": 7},
                str(tmp_path / "jax.pd"))
    back = tio.load(str(tmp_path / "jax.pd"))
    np.testing.assert_array_equal(back["w"].numpy(), tree["w"])
    assert back["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back["b"].float().numpy(),
        np.asarray(paddle.to_tensor(tree["w"]).astype("bfloat16")
                   .astype("float32")._data))
    np.testing.assert_array_equal(back["ids"].numpy(), tree["ids"])
    assert back["step"] == 7
