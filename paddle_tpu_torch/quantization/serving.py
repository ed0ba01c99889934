"""Serving-side int8 calibration (port of
paddle_tpu/quantization/serving.py).

Every Linear reached through the model's modules — the decoder layers'
projections and an untied lm_head — gets a symmetric per-out-channel
int8 twin: ``scale = max(absmax, 1e-30) / 127`` and ``w_q =
clip(round(w / scale), -127, 127)``, in f32, with the absmax taken
directly over each output channel (dim 0 of the port's [out, in]
weight), as the JAX package's ``PerChannelAbsmaxObserverLayer`` with
``quant_axis=1`` does on its [in, out] layout.  Embeddings (gathered,
not multiplied) and norms (1-D) stay in the model's type; a tied head
is not a Linear and stays too.  The twin keeps the port's [N, K] layout
(K contiguous), the layout ``ops.quant_matmul`` consumes.  For w8a8 the
twins of Linears that read one activation are concatenated into one
(``fuse=True``), so that activation is quantized once.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..nn import Linear

__all__ = ["SERVING_QUANT_MODES", "iter_quant_linears",
           "quantize_linear_weights"]

#: weight modes the serving path understands (None = full precision)
SERVING_QUANT_MODES = (None, "w8", "w8a8")


def iter_quant_linears(model):
    """Yield ``(name, layer)`` for every Linear with a 2-D weight."""
    for name, layer in model.named_modules():
        if isinstance(layer, Linear) and layer.weight is not None \
                and layer.weight.dim() == 2:
            yield name, layer


def _twin(layer):
    w = layer.weight.float()
    scale = w.abs().amax(dim=1).clamp_min(1e-30) / 127.0
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127,
                      127).to(torch.int8)
    return w_q.contiguous(), scale


@torch.no_grad()
def quantize_linear_weights(model, fuse: bool = False
                            ) -> List[Tuple[torch.nn.Module, torch.Tensor,
                                            torch.Tensor]]:
    """``(layer, w_q, scale)`` for every quantizable Linear: ``w_q``
    int8 [out, in], ``scale`` f32 [out], both on the weight's device.
    The model's own weights are untouched.

    ``fuse``: a module that names Linears reading one activation in
    ``quant_fused`` (LLaMA's attention: q|k|v; its MLP: gate|up) gets one
    entry ``(module, w_q, scale)`` in place of theirs, the twins and
    scales concatenated along the output axis in that order, so a w8a8
    step quantizes that activation once and runs one matmul.  Each
    output channel's twin is the same rows either way, so the fused
    product is bit-equal to the separate ones.  Groups with a bias stay
    per Linear."""
    out, fused = [], set()
    for module in model.modules() if fuse else ():
        names = getattr(module, "quant_fused", None)
        if not names:
            continue
        layers = [getattr(module, n) for n in names]
        if any(layer.bias is not None for layer in layers):
            continue
        twins = [_twin(layer) for layer in layers]
        out.append((module, torch.cat([t[0] for t in twins]),
                    torch.cat([t[1] for t in twins])))
        fused.update(id(layer) for layer in layers)
    for _name, layer in iter_quant_linears(model):
        if id(layer) not in fused:
            out.append((layer, *_twin(layer)))
    return out
