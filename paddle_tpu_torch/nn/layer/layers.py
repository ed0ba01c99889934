"""``Sequential`` and ``LayerList`` (port of paddle_tpu/nn/layer/layers.py
``Sequential`` and ``LayerList``) and the seeded init the port's vision,
OCR and seq2seq models share."""
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


class LayerList(nn.ModuleList):
    """Layers held in a list, named "0", "1", ... (renumbered after an
    insert or a delete); a slice is a new ``LayerList``."""


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


def seed_model(model: nn.Module, dtype=None, seed=0) -> nn.Module:
    """The last steps of a seeded model's constructor: the model cast to
    ``dtype`` (when given); a dropout ``generator`` on its device, seeded
    by ``seed + 1`` (by 0 when ``seed`` is None), set on the model and on
    every ``Dropout`` in it, so that a graphed ``jit.TrainStep`` registers
    it (none on the meta device); then every weight drawn from ``seed``
    by ``init_weights``, unless ``seed`` is None (a caller that loads
    weights)."""
    from .common import Dropout
    if dtype is not None:
        model.to(dtype)
    dev = next(model.parameters()).device
    if dev.type != "meta":
        model.generator = torch.Generator(device=dev)
        model.generator.manual_seed(0 if seed is None else int(seed) + 1)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.generator = model.generator
    if seed is not None:
        init_weights(model, seed)
    return model
