"""Mixture-of-experts layer (port of
paddle_tpu/incubate/distributed/models/moe/moe_layer.py).

Routing is static-shaped, as in the JAX package (see ``gate.py``).  Stock
gates take the ragged path: the tokens are scattered into [E, C, M]
expert buffers by their routing (``_ragged_dispatch``), the experts run
on those buffers, and each token gathers and weights its assignments'
outputs back (``_ragged_combine``); nothing [T, E, C]-sized is built.  A
gate that overrides ``forward`` keeps the dense combine/dispatch contract
and its two einsums.

``experts`` is an ``ExpertFFN`` (all experts' weights stacked on a leading
expert axis, [E, d, h] and [E, h, d] as in the JAX package, run as batched
products) or a list of per-expert modules.  Expert parallelism
(``shard_moe_layer``) is not ported yet.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..... import amp
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate


def _dispatch(dispatch, x):
    dt = torch.promote_types(dispatch.dtype, x.dtype)
    return torch.einsum("tec,tm->ecm", dispatch.to(dt), x.to(dt))


def _combine(combine, y):
    dt = torch.promote_types(combine.dtype, y.dtype)
    return torch.einsum("tec,ecm->tm", combine.to(dt), y.to(dt))


def _flat_slots(expert_idx, slot_pos, keep, capacity, dump):
    """Each assignment's row in the [E * C] buffer; dropped ones go to
    the dump row ``dump``."""
    flat = expert_idx.long() * capacity + slot_pos.long()
    return torch.where(keep, flat, torch.full_like(flat, dump))


def _ragged_dispatch(x, expert_idx, slot_pos, keep, num_expert, capacity):
    """Scatter tokens x [T, M] into [E, C, M] expert buffers by their
    routing ([k, T] each); dropped assignments land in a dump row that is
    sliced off.  Kept slots are unique by construction, so the add is a
    copy and exact (the dump row's sum, in any order, is discarded)."""
    k = expert_idx.shape[0]
    M = x.shape[-1]
    dump = num_expert * capacity
    flat = _flat_slots(expert_idx, slot_pos, keep, capacity, dump)
    buf = x.new_zeros(dump + 1, M)
    # [k, T] round-major, as x.repeat(k, 1) lays the copies out
    buf = buf.index_add(0, flat.reshape(-1), x.repeat(k, 1))
    return buf[:dump].view(num_expert, capacity, M)


def _ragged_combine(y, expert_idx, slot_pos, keep, weight):
    """Gather each assignment's expert output from y [E, C, M] and sum
    them per token with their weights: out [T, M]."""
    E, C, M = y.shape
    flat = _flat_slots(expert_idx, slot_pos, keep, C, E * C)
    y_flat = torch.cat([y.reshape(E * C, M), y.new_zeros(1, M)])
    g = y_flat[flat.reshape(-1)].view(*expert_idx.shape, M)      # [k, T, M]
    return (weight[..., None].to(y.dtype) * g).sum(dim=0)


#: jax.nn's activations by name; jax.nn.gelu defaults to the tanh
#: approximation, so "gelu" is F.gelu(approximate="tanh")
_ACTIVATIONS = {
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


def _expert_ffn(x, w1, b1, w2, b2, activation):
    """Stacked-expert FFN on [E, C, M] buffers (batched products).
    Biases may be None.  SwiGLU splits h into (u, g) and returns
    u * silu(g): the FIRST half is multiplied and the SECOND goes through
    silu, the opposite of ``LlamaMLP``'s silu(gate) * up."""
    h = torch.bmm(x, w1)
    if b1 is not None:
        h = h + b1[:, None, :]
    if activation == "swiglu":
        u, g = h.chunk(2, dim=-1)
        h = u * F.silu(g)
    elif activation in _ACTIVATIONS:
        h = _ACTIVATIONS[activation](h)
    else:
        raise ValueError(f"unknown expert activation {activation!r}")
    y = torch.bmm(h, w2)
    if b2 is not None:
        y = y + b2[:, None, :]
    return y


class ExpertFFN(nn.Module):
    """All experts' FFN weights stacked on a leading expert axis: w1
    [E, d_model, h] ([E, d_model, 2h] for swiglu), w2 [E, h, d_model],
    zero biases b1 and b2."""

    def __init__(self, num_expert, d_model, d_hidden, activation="gelu",
                 device=None, dtype=None):
        super().__init__()
        self.num_expert = num_expert
        self.activation = activation
        kw = dict(device=device, dtype=dtype)
        w1_cols = 2 * d_hidden if activation == "swiglu" else d_hidden
        self.w1 = nn.Parameter(torch.empty(num_expert, d_model, w1_cols,
                                           **kw))
        self.b1 = nn.Parameter(torch.zeros(num_expert, w1_cols, **kw))
        self.w2 = nn.Parameter(torch.empty(num_expert, d_hidden, d_model,
                                           **kw))
        self.b2 = nn.Parameter(torch.zeros(num_expert, d_model, **kw))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """XavierNormal with the JAX package's fans of a 3-D weight
        [a, b, c]: fan_in = b * c, fan_out = a * c; zero biases."""
        for w in (self.w1, self.w2):
            a, b, c = w.shape
            w.normal_(0.0, math.sqrt(2.0 / ((a + b) * c)),
                      generator=generator)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, expert_in):
        x, w1, b1, w2, b2 = amp._cast_args(
            "expert_ffn", expert_in, self.w1, self.b1, self.w2, self.b2)
        return _expert_ffn(x, w1, b1, w2, b2, self.activation)


class MoELayer(nn.Module):
    """``experts``: an ExpertFFN or a list of per-expert modules (the
    full expert set).  ``gate``: a BaseGate, or a config dict
    {"type": "gshard"|"switch"|"naive", "top_k": k} built on ``device``
    in ``dtype``.  ``recompute_interval > 0`` recomputes the experts in
    the backward while training."""

    def __init__(self, d_model: int,
                 experts: Union[ExpertFFN, Sequence[nn.Module]],
                 gate=None, moe_group=None, mp_group=None,
                 recompute_interval=0, recompute_ctx=None, device=None,
                 dtype=None):
        super().__init__()
        self.d_model = d_model
        if isinstance(experts, ExpertFFN):
            self.experts = experts
            self.num_expert = experts.num_expert
        else:
            self.experts = (experts if isinstance(experts, nn.ModuleList)
                            else nn.ModuleList(list(experts)))
            self.num_expert = len(self.experts)
        self.moe_group = moe_group
        self.recompute_interval = recompute_interval
        if gate is None:
            gate = {"type": "gshard", "top_k": 2}
        if isinstance(gate, dict):
            kind = gate.get("type", "gshard")
            topk = gate.get("top_k", 2 if kind != "switch" else 1)
            kw = dict(device=device, dtype=dtype)
            if kind == "naive":
                gate = NaiveGate(d_model, self.num_expert, 1, topk=topk, **kw)
            elif kind == "switch":
                # top-1 by definition: a config that says otherwise is
                # corrected with a warning, as in the JAX package
                if topk != 1:
                    import warnings
                    warnings.warn(
                        f"switch gate is top-1 by definition; ignoring "
                        f"top_k={topk}")
                gate = SwitchGate(d_model, self.num_expert, 1, topk=1, **kw)
            else:
                gate = GShardGate(d_model, self.num_expert, 1, topk=topk,
                                  **kw)
        assert isinstance(gate, BaseGate)
        assert gate.tot_expert == self.num_expert, (
            f"gate routes over {gate.tot_expert} experts but layer holds "
            f"{self.num_expert}")
        self.gate = gate

    @property
    def l_aux(self):
        return self.gate.get_loss(clear=False)

    def _run_experts(self, expert_in, use_recompute=False):
        def run(module, x):
            if use_recompute:
                return torch.utils.checkpoint.checkpoint(
                    module, x, use_reentrant=False,
                    context_fn=amp.recompute_contexts)
            return module(x)

        if isinstance(self.experts, ExpertFFN):
            return run(self.experts, expert_in)
        outs = []
        for i, expert in enumerate(self.experts):
            seg = run(expert, expert_in[i])
            if isinstance(seg, (tuple, list)):
                seg = seg[0]
            outs.append(seg)
        return torch.stack(outs)                                 # [E, C, M]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig_shape = x.shape
        tokens = x.reshape(-1, self.d_model)
        use_recompute = (self.recompute_interval > 0 and self.training
                         and torch.is_grad_enabled())
        if (isinstance(self.gate, NaiveGate)
                and type(self.gate).forward is NaiveGate.forward):
            # ragged path: O(T) routing metadata + scatter/gather; a gate
            # that overrides forward() keeps its dense contract below
            eidx, pos, keep, w, cap = self.gate.route(tokens)
            (routed,) = amp._cast_args("moe_ragged_dispatch", tokens)
            expert_in = _ragged_dispatch(routed, eidx, pos, keep,
                                         self.num_expert, cap)
            expert_out = self._run_experts(expert_in, use_recompute)
            expert_out, w = amp._cast_args("moe_ragged_combine",
                                           expert_out, w)
            y = _ragged_combine(expert_out, eidx, pos, keep, w)
        else:
            combine, dispatch = self.gate(tokens)
            expert_in = _dispatch(dispatch, tokens)              # [E, C, M]
            expert_out = self._run_experts(expert_in, use_recompute)
            y = _combine(combine, expert_out)                    # [T, M]
        return y.reshape(*orig_shape[:-1], y.shape[-1])
