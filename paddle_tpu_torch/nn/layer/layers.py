"""``Sequential`` (port of paddle_tpu/nn/layer/layers.py ``Sequential``)
and the seeded init the port's vision and OCR models share."""
from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn


class Sequential(nn.Sequential):
    """Layers run in order.  Children are named "0", "1", ... or by the
    name of a ``(name, layer)`` pair (one list of pairs works too), as in
    the reference; a slice is a new ``Sequential`` of the layers, named
    from "0" again, as the JAX package names it."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) \
                and layers[0] and isinstance(layers[0][0], tuple):
            layers = tuple(layers[0])
        if any(isinstance(layer, tuple) for layer in layers):
            super().__init__(OrderedDict(
                layer if isinstance(layer, tuple) else (str(i), layer)
                for i, layer in enumerate(layers)))
        else:
            super().__init__(*layers)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Draw every weight of ``model`` with one generator on its device
    seeded by ``seed``, module by module in order, by the JAX package's
    laws: a module's own ``reset_parameters(generator)`` (convolutions,
    batch norms, recurrent layers), and for a ``Linear`` Xavier normal
    weights and a zero bias."""
    from .common import Linear
    from .transformer import xavier_normal_
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, Linear):
            xavier_normal_(module.weight, gen)
            if module.bias is not None:
                module.bias.zero_()
        elif hasattr(module, "reset_parameters"):
            module.reset_parameters(gen)
