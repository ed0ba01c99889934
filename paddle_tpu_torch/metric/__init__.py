"""Metrics (port of paddle_tpu/metric/__init__.py): ``Metric``,
``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` and
``accuracy()``.

``Accuracy`` computes on the device the predictions live on and keeps
its running totals there, so a fit loop on a card reads nothing back a
step: on a card ``update`` and ``accumulate`` return
``hapi.model.DeferredScalar`` values (forced where a float is needed),
on the CPU plain floats, the JAX package's numbers.  ``Precision``,
``Recall`` and ``Auc`` count on the host in numpy, as the JAX package
does.
"""
from __future__ import annotations

import numpy as np
import torch


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _deferred(value):
    from ..hapi.model import DeferredScalar
    return DeferredScalar(value)


class Metric:
    """Base: ``reset``, ``update``, ``accumulate``, ``name``; ``compute``
    turns a step's outputs into what ``update`` takes."""

    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy over the last axis of the predictions; labels are
    class ids (a trailing axis of 1 is dropped) or one-hot."""

    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        """(..., maxk) f32: 1 where the i-th best prediction is the
        label."""
        p = torch.as_tensor(pred)
        lab = torch.as_tensor(label, device=p.device)
        idx = torch.topk(p.float(), self.maxk, dim=-1).indices
        if lab.dim() == p.dim() and lab.shape[-1] == 1:
            lab = lab[..., 0]
        if lab.dim() == p.dim():  # one-hot
            lab = lab.argmax(dim=-1)
        return (idx == lab[..., None].long()).float()

    def update(self, correct, *args):
        c = torch.as_tensor(correct)
        num = c.shape[0] if c.dim() > 0 else 1
        hits = torch.stack([c[..., :k].sum() for k in self.topk]).double()
        if self._total is None:
            self._total = torch.zeros_like(hits)
        self._total += hits
        self._count += num
        accs = hits / max(num, 1)
        return self._out(accs)

    def _out(self, values):
        """One value a k: floats on the CPU, deferred on a card."""
        if values.device.type == "cpu":
            out = [float(v) for v in values]
        else:
            out = [_deferred(v) for v in values.unbind()]
        return out[0] if len(out) == 1 else out

    def reset(self):
        self._total = None
        self._count = 0

    @property
    def total(self):
        """Hits so far, a k (floats)."""
        if self._total is None:
            return [0.0] * len(self.topk)
        return [float(v) for v in self._total]

    @property
    def count(self):
        return [self._count] * len(self.topk)

    def accumulate(self):
        if self._total is None:
            res = [0.0] * len(self.topk)
            return res[0] if len(res) == 1 else res
        return self._out(self._total / max(self._count, 1))

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision of ``preds > 0.5`` against 0/1 labels."""

    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, lab = _numpy(preds), _numpy(labels)
        pred_pos = (p.reshape(-1) > 0.5)
        actual = lab.reshape(-1).astype(bool)
        self.tp += int(np.sum(pred_pos & actual))
        self.fp += int(np.sum(pred_pos & ~actual))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of ``preds > 0.5`` against 0/1 labels."""

    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, lab = _numpy(preds), _numpy(labels)
        pred_pos = (p.reshape(-1) > 0.5)
        actual = lab.reshape(-1).astype(bool)
        self.tp += int(np.sum(pred_pos & actual))
        self.fn += int(np.sum(~pred_pos & actual))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Area under the ROC curve, by the trapezoid rule over
    ``num_thresholds`` buckets of the positive-class score."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc",
                 *args, **kwargs):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, lab = _numpy(preds), _numpy(labels)
        if p.ndim == 2:
            p = p[:, 1]
        idx = np.minimum((p * self.num_thresholds).astype(np.int64),
                         self.num_thresholds)
        lbl = lab.reshape(-1).astype(bool)
        np.add.at(self._stat_pos, idx[lbl], 1)
        np.add.at(self._stat_neg, idx[~lbl], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, dtype=np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos[::-1].cumsum()
        tot_neg = self._stat_neg[::-1].cumsum()
        n_pos, n_neg = tot_pos[-1], tot_neg[-1]
        if n_pos == 0 or n_neg == 0:
            return 0.0
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tot_pos / n_pos, tot_neg / n_neg))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of one batch, a 0-d f32 tensor on ``input``'s
    device."""
    m = Accuracy(topk=(k,))
    m.update(m.compute(input, label))
    return (m._total / max(m._count, 1)).float()[0]


__all__ = ["Accuracy", "Auc", "Metric", "Precision", "Recall", "accuracy"]
