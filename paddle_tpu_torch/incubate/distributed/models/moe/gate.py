"""MoE gates: naive top-k, GShard top-2, Switch top-1 (port of
paddle_tpu/incubate/distributed/models/moe/gate.py).

Routing keeps the JAX package's static-shape contract: each token's
top-k assignments get a slot in their expert's fixed-capacity buffer,
counted round-major over every token, and assignments past the capacity
are dropped (GShard/Switch semantics).  ``route`` returns that routing
as O(T) metadata for ``MoELayer``'s ragged path; ``forward`` densifies it
into the [T, E, C] combine/dispatch tensors of the einsum path.

The routing of f32 logits without GShard random keep is the top-k gating
kernel on the card (``ops.moe_gating``), as the JAX package takes its
Pallas kernel; bf16 logits and random keep take the plain oracle.  A
gate whose weight is f32 inside a bf16 model has f32 logits (the matmul
promotes, as ``jnp.matmul`` does), so its layer launches the kernel.

Random keep and switch jitter draw from ``gate.generator`` (a
``torch.Generator`` on the gate's device, or None for torch's global
one); both are uniforms fed to the routing, so a caller can pass the
same ones to both packages.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..... import amp
from .....ops.moe_gating import topk_gating
from .....ops.moe_gating import topk_routing_plain as _topk_routing


def moe_capacity(top_k, num_tokens, num_expert, factor):
    """Per-expert capacity C = ceil(top_k * T / E * factor), clamped to
    [1, T]."""
    cap = int(math.ceil(top_k * num_tokens * factor / max(num_expert, 1)))
    return max(1, min(cap, num_tokens))


def _capacity_gating(gates, top_k, capacity, normalize, random_keep=None):
    """Dense capacity-based top-k routing, the numerics oracle: (combine
    [T, E, C], dispatch [T, E, C] float 0/1, l_aux).  O(T * E * C)
    memory; the ragged path is what runs at scale."""
    E = gates.shape[1]
    eidx, pos, keep, w, l_aux = _topk_routing(gates, top_k, capacity,
                                              normalize, random_keep)
    oh_e = F.one_hot(eidx.long(), E).to(gates.dtype)             # [k,T,E]
    # slots past the capacity one-hot to nothing, as jax.nn.one_hot's
    # out-of-range classes do
    oh_c = F.one_hot(pos.long().clamp_max(capacity), capacity + 1
                     )[..., :capacity].to(gates.dtype)           # [k,T,C]
    sel = (oh_e[..., :, None] * oh_c[..., None, :]
           * keep[..., None, None].to(gates.dtype))              # [k,T,E,C]
    combine = (w[..., None, None] * sel).sum(dim=0)
    dispatch = (combine > 0).to(gates.dtype)
    return combine, dispatch, l_aux


def _moe_gating(logits, top_k, capacity, normalize, random_keep=None):
    gates = torch.softmax(logits, dim=-1)
    return _capacity_gating(gates, top_k, capacity, normalize, random_keep)


def _moe_topk_routing(logits, top_k, capacity, normalize, random_keep=None):
    """(eidx, pos, keep, w, l_aux) of ``logits`` [T, E].  f32 logits
    without random keep take the gating kernel on the card (its plain
    version on the CPU); bf16 logits stay on the oracle, as in the JAX
    package (the kernel computes in f32, so low-precision logits could
    route differently than the same-dtype oracle), and so does GShard
    random keep."""
    if random_keep is None and logits.dtype == torch.float32:
        return topk_gating(logits, top_k, capacity, normalize)
    gates = torch.softmax(logits, dim=-1)
    return _topk_routing(gates, top_k, capacity, normalize, random_keep)


class BaseGate(nn.Module):
    def __init__(self, num_expert, world_size):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = world_size * num_expert
        self.loss = None
        self.generator: Optional[torch.Generator] = None

    def capacity(self, num_tokens, training=True):
        factor = self.cap[0] if training else self.cap[1]
        return moe_capacity(self.top_k, num_tokens, self.tot_expert, factor)

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss

    def forward(self, x):
        raise NotImplementedError("Base gate cannot be called")


class NaiveGate(BaseGate):
    """Plain learned top-k gate, no balance loss; generous capacity
    (factors 2.0 training, 4.0 eval).  ``gate_weight`` is [d_model, E],
    the JAX package's layout."""

    use_balance_loss = False

    def __init__(self, d_model, num_expert, world_size, topk=2,
                 device=None, dtype=None):
        super().__init__(num_expert, world_size)
        self.d_model = d_model
        self.top_k = topk
        self.cap = (2.0, 4.0)
        self.normalize = True
        self.gate_weight = nn.Parameter(torch.empty(
            d_model, self.tot_expert, device=device, dtype=dtype))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """XavierNormal, as the JAX gate: N(0, sqrt(2 / (d_model + E)))."""
        std = math.sqrt(2.0 / (self.d_model + self.tot_expert))
        self.gate_weight.normal_(0.0, std, generator=generator)

    def gate_logits(self, x):
        # a bf16 x times an f32 weight gives f32 logits, as jnp.matmul's
        # promotion does; amp O1 casts both to the amp dtype (``matmul``
        # is on the white list), so the routing then takes the oracle
        x, weight = amp._cast_args("matmul", x, self.gate_weight)
        dt = torch.promote_types(x.dtype, weight.dtype)
        return x.to(dt) @ weight.to(dt)

    def _random_keep(self, num_tokens, device):
        return None

    def forward(self, x):
        """x [T, d_model] -> (combine, dispatch) [T, E, C]."""
        logits = self.gate_logits(x)
        cap = self.capacity(x.shape[0], self.training)
        logits, keep = amp._cast_args(
            "moe_gating", logits, self._random_keep(x.shape[0], x.device))
        combine, dispatch, l_aux = _moe_gating(
            logits, self.top_k, cap, self.normalize, keep)
        self.set_loss(l_aux if self.use_balance_loss else None)
        return combine, dispatch

    def route(self, x):
        """Ragged routing: x [T, d_model] -> (expert_idx, slot_pos, keep,
        weight) each [top_k, T], plus the capacity; O(T) memory."""
        logits = self.gate_logits(x)
        cap = self.capacity(x.shape[0], self.training)
        logits, rkeep = amp._cast_args(
            "moe_topk_routing", logits,
            self._random_keep(x.shape[0], x.device))
        eidx, pos, keep, w, l_aux = _moe_topk_routing(
            logits, self.top_k, cap, self.normalize, rkeep)
        self.set_loss(l_aux if self.use_balance_loss else None)
        return eidx, pos, keep, w, cap


class GShardGate(NaiveGate):
    """Top-2 gate with capacity (factors 1.2 training, 2.4 eval),
    load-balance loss and, in training, random second-choice keep."""

    use_balance_loss = True

    def __init__(self, d_model, num_expert, world_size, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None,
                 device=None, dtype=None):
        assert topk == 2, "GShard only supports top-2 gating"
        super().__init__(d_model, num_expert, world_size, topk=2,
                         device=device, dtype=dtype)
        self.cap = capacity
        self.random_routing = random_routing
        self.normalize = True

    def _random_keep(self, num_tokens, device):
        if not (self.training and self.random_routing):
            return None
        return torch.rand(num_tokens, generator=self.generator,
                          device=device, dtype=torch.float32)


class SwitchGate(NaiveGate):
    """Top-1 switch gate with multiplicative jitter in training and a
    balance loss."""

    use_balance_loss = True

    def __init__(self, d_model, num_expert, world_size, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None,
                 device=None, dtype=None):
        assert topk == 1, "Switch gate only supports top-1"
        super().__init__(d_model, num_expert, world_size, topk=1,
                         device=device, dtype=dtype)
        self.switch_eps = switch_eps
        self.cap = capacity
        self.normalize = False

    def gate_logits(self, x):
        logits = super().gate_logits(x)
        if self.training and self.switch_eps > 0:
            noise = torch.rand(logits.shape, generator=self.generator,
                               device=logits.device, dtype=logits.dtype)
            noise = noise * (2 * self.switch_eps) + (1.0 - self.switch_eps)
            logits = logits * noise
        return logits
