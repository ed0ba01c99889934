"""Carry a JAX-package LLaMA's (dense or MoE), BERT's, vision model's
(ResNet and the rest of the zoo) or CRNN's weights into the port."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..nn import Linear
from .bert import (BertConfig, BertForMaskedLM,
                   BertForSequenceClassification)
from .llama import LlamaConfig, LlamaForCausalLM
from .llama_moe import LlamaMoeConfig, LlamaMoeForCausalLM


def _linear_weights(model):
    """Names of the Linear weights: [in, out] in the JAX package and
    [out, in] here, so transposed on the way in and out.  Nothing else
    is (the stacked experts' w1/w2/b1/b2 and the gates' [d, E]
    ``gate_weight`` keep the JAX layout)."""
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, Linear)}


def _load(model, arrays):
    """Every entry of ``model.state_dict()`` (parameters, and buffers such
    as a batch norm's ``_mean`` / ``_variance``) from ``arrays``."""
    linear = _linear_weights(model)
    state = {}
    for name, param in model.state_dict().items():
        if name not in arrays:
            raise KeyError(f"no array for parameter {name!r}")
        a = np.asarray(arrays[name])
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)   # numpy's bf16 has no torch twin
        if name in linear:
            a = a.T
        if a.shape != tuple(param.shape):
            raise ValueError(f"{name}: array shape {a.shape} does not fit "
                             f"parameter shape {tuple(param.shape)}")
        state[name] = torch.from_numpy(np.array(a, copy=True)).to(
            device=param.device, dtype=param.dtype)
    extra = set(arrays) - set(state)
    if extra:
        raise KeyError(f"arrays name no parameter of the port: "
                       f"{sorted(extra)}")
    model.load_state_dict(state)
    return model


def _to_numpy(model, buffers=False):
    linear = _linear_weights(model)
    out = {}
    tensors = list(model.named_parameters())
    if buffers:
        tensors += list(model.named_buffers())
    for name, t in tensors:
        a = t.detach().float().cpu().numpy()
        out[name] = a.T if name in linear else a
    return out


def params_from_numpy(cfg: LlamaConfig, arrays: Dict[str, np.ndarray],
                      device="cuda", dtype=None) -> LlamaForCausalLM:
    """Build a port model computing the same function as a
    ``paddle_tpu`` LLaMA whose parameters are ``arrays``, keyed by their
    ``paddle_tpu`` names (``model.layers.0.self_attn.q_proj.weight``,
    ...).  The port's module tree uses the same names; every Linear
    weight is transposed, because the JAX package stores [in, out] and
    the port [out, in].  Missing or unexpected names raise."""
    return _load(LlamaForCausalLM(cfg, device=device, dtype=dtype,
                                  seed=None), arrays)


def params_to_numpy(model: LlamaForCausalLM) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_numpy`: every parameter as an
    f32 numpy array under its ``paddle_tpu`` name and layout (Linear
    weights transposed back to [in, out])."""
    return _to_numpy(model)


def moe_params_from_numpy(cfg: LlamaMoeConfig, arrays: Dict[str, np.ndarray],
                          device="cuda", dtype=None,
                          gate_dtype=None) -> LlamaMoeForCausalLM:
    """:func:`params_from_numpy` for a ``paddle_tpu`` ``LlamaMoeForCausalLM``:
    Linear weights transposed, the stacked experts
    (``model.layers.i.moe.experts.w1``/``b1``/``w2``/``b2``) and the gates
    (``model.layers.i.moe.gate.gate_weight`` [d, E]) as they are.
    ``gate_dtype`` keeps the gates in another type than ``dtype`` (f32
    gates in a bf16 model).  Missing or unexpected names raise."""
    return _load(LlamaMoeForCausalLM(cfg, device=device, dtype=dtype,
                                     seed=None, gate_dtype=gate_dtype),
                 arrays)


def moe_params_to_numpy(model: LlamaMoeForCausalLM) -> Dict[str, np.ndarray]:
    """The inverse of :func:`moe_params_from_numpy`."""
    return _to_numpy(model)


def bert_params_from_numpy(cfg: BertConfig, arrays: Dict[str, np.ndarray],
                          device="cuda", dtype=None):
    """:func:`params_from_numpy` for a ``paddle_tpu`` BERT: a
    ``BertForSequenceClassification`` (the arrays hold
    ``classifier.weight``) or a ``BertForMaskedLM`` (``decoder.weight``),
    every Linear weight transposed.  Missing or unexpected names
    raise."""
    cls = BertForMaskedLM if "decoder.weight" in arrays \
        else BertForSequenceClassification
    return _load(cls(cfg, device=device, dtype=dtype, seed=None), arrays)


def bert_params_to_numpy(model) -> Dict[str, np.ndarray]:
    """The inverse of :func:`bert_params_from_numpy`."""
    return _to_numpy(model)


def vision_params_from_numpy(arrays: Dict[str, np.ndarray], arch: str,
                            device="cuda", dtype=None, **kwargs):
    """A port ``vision.models`` model (``arch``: any factory the package
    exports, "resnet50", "mobilenet_v2", "densenet121", "inception_v3",
    ...; ``kwargs`` such as ``num_classes`` or ``scale`` go to it)
    computing the same function as a ``paddle_tpu`` one whose parameters
    and batch-norm buffers (``_mean``, ``_variance``) are ``arrays``,
    keyed by their ``paddle_tpu`` names.  The convolutions' weights are
    carried as they are (both packages hold [out, in / groups, kh, kw]);
    the Linears' are transposed.  Missing or unexpected names raise."""
    from ..vision import models as vision_models
    build = getattr(vision_models, arch)
    return _load(build(device=device, dtype=dtype, seed=None, **kwargs),
                 arrays)


def vision_params_to_numpy(model) -> Dict[str, np.ndarray]:
    """The inverse of :func:`vision_params_from_numpy`: parameters and
    buffers under their ``paddle_tpu`` names and layouts."""
    return _to_numpy(model, buffers=True)


def crnn_params_from_numpy(arrays: Dict[str, np.ndarray], num_classes: int,
                           device="cuda", dtype=None, **kwargs):
    """A port ``CRNN(num_classes, **kwargs)`` (``in_channels``,
    ``img_height``, ``hidden_size``, ``channels``) holding a ``paddle_tpu``
    CRNN's parameters and batch-norm buffers ``arrays``: the convolutions
    and the LSTM's ``weight_ih_l{k}`` ... (the same layout in both
    packages) as they are, the head Linear transposed.  Missing or
    unexpected names raise."""
    from .crnn import CRNN
    return _load(CRNN(num_classes, device=device, dtype=dtype, seed=None,
                      **kwargs), arrays)


def crnn_params_to_numpy(model) -> Dict[str, np.ndarray]:
    """The inverse of :func:`crnn_params_from_numpy`."""
    return _to_numpy(model, buffers=True)


def shard_params(params, tp: int, rank: int,
                 config: Optional[LlamaConfig] = None
                 ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shard of a dense LLaMA's parameters for
    tensor-parallel serving over ``tp`` ranks, cut by the plan of
    ``inference.paged._tp_plan``: q/k/v and gate/up keep the rank's
    ``1/tp`` of their output features (dim 0 of the port's [out, in]
    weights), o and down of their input features (dim 1), every other
    parameter whole.  ``params`` is a port model (the shards are views of
    its tensors) or the ``paddle_tpu`` model's arrays by name, in the
    JAX layout, with its ``config`` (the Linear weights are transposed
    first, as :func:`params_from_numpy` does; the shards are CPU tensors).
    The cuts are the ``addressable_shards[rank]`` of the JAX decoder's
    committed parameters, transposed."""
    from ..inference.paged import _tp_plan
    if isinstance(params, torch.nn.Module):
        plan = _tp_plan(params, tp)
        state = params.state_dict()
    else:
        skeleton = LlamaForCausalLM(config, device="meta", seed=None)
        plan = _tp_plan(skeleton, tp)
        linear = _linear_weights(skeleton)
        state = {}
        for name, a in params.items():
            a = np.array(a)                # a writable copy
            if a.dtype.name == "bfloat16":
                a = a.astype(np.float32)   # numpy's bf16 has no torch twin
            state[name] = torch.from_numpy(a.T if name in linear else a)
    out = {}
    for name, t in state.items():
        dim = plan.get(name)
        if dim is not None:
            size = t.shape[dim] // tp
            t = t.narrow(dim, rank * size, size)
        out[name] = t
    return out


def shard_model(model: LlamaForCausalLM, tp: int,
                rank: int) -> LlamaForCausalLM:
    """A new port model holding rank ``rank``'s shard of ``model``
    (:func:`shard_params`), on its device and in its type, with each
    attention module's head counts the rank's (``LlamaForCausalLM(...,
    tp=tp)``).  ``model`` is left as it is."""
    w = model.model.embed_tokens.weight
    shard = LlamaForCausalLM(model.config, device=w.device, dtype=w.dtype,
                             seed=None, tp=tp)
    shard.load_state_dict(shard_params(model, tp, rank))
    return shard.train(model.training)
