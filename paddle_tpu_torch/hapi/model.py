"""High-level Model API: ``fit``, ``evaluate``, ``predict`` (port of
paddle_tpu/hapi/model.py).

The loop keeps the JAX package's contract of no host sync a step: a
step's loss (and ``Accuracy``'s running value on a card) goes to the
callbacks as a ``DeferredScalar``, and ``fit`` forces an epoch's losses
at once at the epoch's end.  Batches reach the network's device without
a blocking copy: ``fit``, ``evaluate`` and ``predict`` build their
loaders with the device stage (``io.DataLoader(device_prefetch=True)``)
when the network lives on a card, and a batch still on the host is
copied with ``non_blocking=True``.

``prepare(jit_compile=True)`` runs the forward eagerly: ``jit.to_static``
is not ported (a divergence chosen on purpose).  ``amp_configs`` is
accepted and ignored, as in the JAX package.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..framework.io import load as _load, save as _save
from ..io import DataLoader
from ..metric import Metric


class DeferredScalar:
    """A device-resident scalar whose host read is deferred.

    The fit loop hands these to callbacks instead of reading each step's
    loss: the card keeps computing behind the Python loop, and the value
    is fetched only when a consumer reads it (``float()``,
    ``np.asarray()``, ``item()``), which the stock callbacks do at log
    and epoch boundaries.  Arithmetic and comparisons force the value,
    so a callback that does per-step arithmetic pays for the sync it
    asks for."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def item(self) -> float:
        v = self._value
        if isinstance(v, torch.Tensor):
            return float(v.detach().reshape(-1)[0])
        return float(np.asarray(v).ravel()[0])

    __float__ = item

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self.item())
        return a if dtype is None else a.astype(dtype)

    def __format__(self, spec):
        return format(self.item(), spec)

    def __repr__(self):
        return f"DeferredScalar({self.item()!r})"

    def __add__(self, other):
        return self.item() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self.item() - other

    def __rsub__(self, other):
        return other - self.item()

    def __mul__(self, other):
        return self.item() * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self.item() / other

    def __rtruediv__(self, other):
        return other / self.item()

    def __neg__(self):
        return -self.item()

    def __lt__(self, other):
        return self.item() < other

    def __le__(self, other):
        return self.item() <= other

    def __gt__(self, other):
        return self.item() > other

    def __ge__(self, other):
        return self.item() >= other

    def __eq__(self, other):
        return self.item() == other

    def __ne__(self, other):
        return self.item() != other

    def __hash__(self):
        return hash(self.item())


def _force(v):
    """A float for a DeferredScalar (a list of them element-wise)."""
    if isinstance(v, (list, tuple)):
        return [_force(x) for x in v]
    return float(v) if isinstance(v, DeferredScalar) else v


def _to_device(obj, dev):
    """Tensors of ``obj`` on ``dev``, copied without waiting."""
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == dev else obj.to(dev, non_blocking=True)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(o, dev) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, dev) for k, v in obj.items()}
    return obj


def _as_list(x):
    return x if x is None or isinstance(x, (list, tuple)) else [x]


class Model:
    """The reference's ``paddle.Model``: a network with an optimizer, a
    loss and metrics, trained by ``fit``."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False

    @property
    def _device(self):
        p = next(self.network.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit_compile=True):
        """Set the optimizer, loss and metrics.  ``jit_compile`` and
        ``amp_configs`` are accepted; the forward runs eagerly."""
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]
        return self

    def _loader(self, data, batch_size, shuffle=False, drop_last=False,
                num_workers=0):
        if isinstance(data, DataLoader):
            return data
        dev = self._device
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers,
                          device_prefetch=dev.type == "cuda", device=dev)

    def _prepare_batch(self, inputs, labels):
        dev = self._device
        inputs = _to_device(list(_as_list(inputs)), dev)
        labels = _as_list(labels)
        if labels is not None:
            labels = _to_device(list(labels), dev)
        return inputs, labels

    def train_batch(self, inputs, labels=None, update=True):
        """Forward, loss, backward and (with ``update``) the optimizer
        step on one batch; returns ``[loss]`` (and the metrics' values)
        with the loss as a ``DeferredScalar``."""
        self.network.train()
        inputs, labels = self._prepare_batch(inputs, labels)
        outputs = self.network(*inputs)
        losses = self._loss(outputs, *labels) if labels \
            else self._loss(outputs)
        loss = losses if isinstance(losses, torch.Tensor) else losses[0]
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        lazy = DeferredScalar(loss.detach())
        return ([lazy], metrics) if metrics else [lazy]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._prepare_batch(inputs, labels)
        outputs = self.network(*inputs)
        result = []
        if self._loss is not None and labels:
            losses = self._loss(outputs, *labels)
            loss = losses if isinstance(losses, torch.Tensor) else losses[0]
            result.append(DeferredScalar(loss))
        self._update_metrics(outputs, labels)
        return result

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs, _ = self._prepare_batch(inputs, None)
        return self.network(*inputs)

    def _update_metrics(self, outputs, labels):
        vals = []
        with torch.no_grad():
            for m in self._metrics:
                out = outputs if isinstance(outputs, torch.Tensor) \
                    else outputs[0]
                res = m.compute(out, *(labels or []))
                vals.append(m.update(res))
        return vals

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=1, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        """Train for ``epochs`` over ``train_data`` (a Dataset or a
        DataLoader), evaluating every ``eval_freq`` epochs; returns the
        history (``loss`` a step as floats, ``eval_*`` an evaluation)."""
        from .callbacks import config_callbacks
        loader = self._loader(train_data, batch_size, shuffle, drop_last,
                              num_workers)
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, log_freq=log_freq,
            verbose=verbose, save_freq=save_freq, save_dir=save_dir,
            metrics=[m.name() for m in self._metrics])
        history = {"loss": []}
        it = 0
        self.stop_training = False
        cbks.on_train_begin()
        for epoch in range(epochs):
            for m in self._metrics:
                m.reset()
            cbks.on_epoch_begin(epoch)
            logs = None        # only this epoch's last-batch logs
            epoch_start = len(history["loss"])
            for step, batch in enumerate(loader):
                if isinstance(batch, (list, tuple)) and len(batch) >= 2:
                    x, y = batch[0], batch[1]
                else:
                    x, y = batch, None
                cbks.on_train_batch_begin(step)
                result = self.train_batch(x, y)
                loss_val = result[0][0] if isinstance(result, tuple) \
                    else result[0]
                history["loss"].append(loss_val)
                bsz = x.shape[0] if isinstance(x, torch.Tensor) else len(x)
                it += 1
                logs = {"loss": loss_val, "batch_size": bsz}
                for m in self._metrics:
                    name = m.name()
                    if isinstance(name, str):
                        logs[name] = m.accumulate()
                cbks.on_train_batch_end(step, logs)
                if num_iters is not None and it >= num_iters:
                    break
            # epoch boundary: this epoch's losses are read back at once
            history["loss"][epoch_start:] = [
                float(v) for v in history["loss"][epoch_start:]]
            if logs is not None:
                logs = {k: _force(v) for k, v in logs.items()}
            cbks.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_res = self.evaluate(eval_data, batch_size=batch_size,
                                         verbose=0, callbacks=cbks)
                for k, v in eval_res.items():
                    history.setdefault("eval_" + k, []).append(v)
            if self.stop_training or \
                    (num_iters is not None and it >= num_iters):
                break
        cbks.on_train_end()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=1,
                 num_workers=0, callbacks=None):
        """Loss (the mean of the batches') and metrics over
        ``eval_data``, as floats."""
        from .callbacks import CallbackList, config_callbacks
        loader = self._loader(eval_data, batch_size,
                              num_workers=num_workers)
        if isinstance(callbacks, CallbackList):
            cbks = callbacks
        else:
            # verbose=0: evaluate prints its own summary below
            cbks = config_callbacks(callbacks, model=self, verbose=0,
                                    log_freq=log_freq, mode="eval")
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            if isinstance(batch, (list, tuple)) and len(batch) >= 2:
                x, y = batch[0], batch[1]
            else:
                x, y = batch, None
            cbks.on_eval_batch_begin(step)
            res = self.eval_batch(x, y)
            if res:
                losses.append(res[0])
            cbks.on_eval_batch_end(step, {"loss": res[0] if res else None})
        result = {}
        if losses:
            # eval boundary: the per-batch losses stayed on the device
            # through the loop; one read here
            result["loss"] = [float(np.mean([float(v) for v in losses]))]
        for m in self._metrics:
            name = m.name()
            result[name if isinstance(name, str) else name[0]] = \
                _force(m.accumulate())
        cbks.on_eval_end(result)
        if verbose:
            print("Eval:", result)
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """The network's outputs a batch (on its device)."""
        loader = self._loader(test_data, batch_size,
                              num_workers=num_workers)
        outputs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            outputs.append(self.predict_batch(x))
        return outputs

    def save(self, path, training=True):
        """``path.pdparams`` (the network's state) and, with
        ``training``, ``path.pdopt`` (the optimizer's), in the format of
        ``framework.io.save``."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        self.network.load_state_dict(_load(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt"))

    def parameters(self, *a, **k):
        return self.network.parameters(*a, **k)

    def summary(self, input_size=None, dtype=None):
        params = list(self.network.parameters())
        n_params = sum(p.numel() for p in params)
        trainable = sum(p.numel() for p in params if p.requires_grad)
        info = {"total_params": n_params, "trainable_params": trainable}
        print(f"Total params: {n_params:,} (trainable {trainable:,})")
        return info
