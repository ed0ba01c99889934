"""Carry a JAX-package LLaMA's (dense or MoE) weights into the port."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..nn import Linear
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


def _to_numpy(model):
    linear = _linear_weights(model)
    out = {}
    for name, param in model.named_parameters():
        a = param.detach().float().cpu().numpy()
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
