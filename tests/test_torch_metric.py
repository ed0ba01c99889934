"""Port parity of the metrics (``paddle_tpu_torch/metric``) against the
JAX package's ``paddle_tpu.metric`` on the CPU: ``Accuracy`` (top-1 and
top-k, class-id labels with and without a trailing axis, one-hot
labels) batch by batch and accumulated, ``Precision``, ``Recall``,
``Auc`` and ``accuracy()``.  Counts are exact, so the values are equal
(``Auc``: the same trapezoid over the same buckets, within 1e-12)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.metric as jmetric
from paddle_tpu_torch import metric as tmetric


def _batches(n_classes, label_kind, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for b in (8, 5, 11):
        pred = rng.standard_normal((b, n_classes)).astype(np.float32)
        lab = rng.integers(0, n_classes, b)
        if label_kind == "column":
            lab = lab[:, None]
        elif label_kind == "onehot":
            lab = np.eye(n_classes, dtype=np.float32)[lab]
        out.append((pred, lab.astype(np.int64) if label_kind != "onehot"
                    else lab))
    return out


@pytest.mark.parametrize("topk", [(1,), (1, 3), 2])
@pytest.mark.parametrize("label_kind", ["ids", "column", "onehot"])
def test_accuracy_matches_jax(topk, label_kind):
    j, t = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    assert t.name() == j.name()
    for pred, lab in _batches(5, label_kind):
        jc = j.compute(paddle.to_tensor(pred), paddle.to_tensor(lab))
        tc = t.compute(torch.from_numpy(pred), torch.from_numpy(lab))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc._data))
        assert t.update(tc) == j.update(jc)
        assert t.accumulate() == j.accumulate()
    t.reset()
    j.reset()
    assert t.accumulate() == j.accumulate()


def test_precision_recall_auc_match_jax():
    rng = np.random.default_rng(1)
    ms = [(jmetric.Precision(), tmetric.Precision()),
          (jmetric.Recall(), tmetric.Recall()),
          (jmetric.Auc(num_thresholds=255), tmetric.Auc(num_thresholds=255))]
    for _ in range(3):
        p1 = rng.random(20).astype(np.float32)
        lab = rng.integers(0, 2, 20).astype(np.int64)
        for j, t in ms:
            if isinstance(t, tmetric.Auc):
                preds = np.stack([1 - p1, p1], axis=1)
                j.update(paddle.to_tensor(preds), paddle.to_tensor(lab))
                t.update(torch.from_numpy(preds), torch.from_numpy(lab))
            else:
                j.update(paddle.to_tensor(p1), paddle.to_tensor(lab))
                t.update(torch.from_numpy(p1), torch.from_numpy(lab))
    for j, t in ms:
        assert t.name() == j.name()
        np.testing.assert_allclose(t.accumulate(), j.accumulate(),
                                   rtol=0, atol=1e-12)
        t.reset()
        assert t.accumulate() == 0.0


def test_accuracy_function_matches_jax():
    pred, lab = _batches(4, "column")[0]
    for k in (1, 2):
        got = tmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(lab),
                               k=k)
        want = jmetric.accuracy(paddle.to_tensor(pred),
                                paddle.to_tensor(lab), k=k)
        assert got.dtype == torch.float32
        assert float(got) == float(np.asarray(want._data))
