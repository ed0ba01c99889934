"""``save`` and ``load`` (port of paddle_tpu/framework/io.py).

The file format is the JAX package's: a pickle of the object with every
tensor replaced by ``("__tensor__", numpy array)``, so a file written by
either package loads as the same numpy tree in the other.  A bf16 tensor
is written as f32 (numpy has no bf16 without ml_dtypes) and a bf16 array
read from a JAX file becomes a bf16 tensor again.  Loaded tensors are
CPU tensors.  Model weights cross packages through
``models/convert.py``, which transposes the Linear weights.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch


def _to_numpy_tree(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return ("__tensor__", t.numpy())
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_numpy_tree(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _from_numpy_tree(obj):
    if isinstance(obj, tuple) and len(obj) == 2 and \
            isinstance(obj[0], str) and obj[0] == "__tensor__":
        return _to_tensor(obj[1])
    if isinstance(obj, dict):
        return {k: _from_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_numpy_tree(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4):
    """Write ``obj`` (a tree of dicts, lists, tuples, tensors and plain
    values) to ``path`` in the JAX package's format."""
    with open(path, "wb") as f:
        pickle.dump(_to_numpy_tree(obj), f, protocol=protocol)


def load(path, **kwargs):
    """Read a file written by :func:`save` (of either package); tensors
    come back as CPU tensors."""
    with open(path, "rb") as f:
        return _from_numpy_tree(pickle.load(f))
