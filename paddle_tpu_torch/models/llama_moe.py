"""Mixtral-style sparse-MoE LLaMA decoder (port of
paddle_tpu/models/llama_moe.py).

Attention is the dense model's ``LlamaAttention`` (flash kernel on the
card); each decoder's FFN is a ``MoELayer`` over an ``ExpertFFN`` with
stacked [E, ...] SwiGLU weights, routed by the ragged path through the
top-k gating kernel; the gates' load-balancing loss comes back beside the
logits.  ``generate`` is the dense model's eager KV-cache loop: call
``model.eval()`` first, because in training GShard draws random keeps
(and a switch gate jitters its logits), which take the plain routing in
both packages.

One divergence from the JAX package, chosen on purpose: a forward over KV
caches (``generate``'s path) leaves no gate loss behind.  The JAX model
records one per layer per step and nothing clears them, so they leak
into the next ``aux_loss()``; the tokens are the same either way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from .._device import resolve_device
from ..incubate.distributed.models.moe import ExpertFFN, MoELayer, NaiveGate
from ..nn import Embedding, Linear, RMSNorm
from .llama import (_DTYPES, LlamaAttention, LlamaConfig, LlamaForCausalLM,
                    _rope_tables)


@dataclass
class LlamaMoeConfig(LlamaConfig):
    """LlamaConfig + sparse-MoE routing knobs (Mixtral shape family).
    ``moe_top_k=None`` picks the gate's canonical k: 2 for gshard and
    naive, 1 for switch."""
    num_experts: int = 8
    moe_top_k: int = None
    gate_type: str = "gshard"          # gshard | switch | naive
    aux_loss_weight: float = 0.01

    def __post_init__(self):
        super().__post_init__()
        if self.moe_top_k is None:
            self.moe_top_k = 1 if self.gate_type == "switch" else 2


def mixtral_8x7b(num_hidden_layers: int = 32):
    """Mixtral-8x7B-v0.1's published widths (its ``config.json``) on this
    architecture: hidden 4096, 14336 per expert, 32 heads over 8 kv
    heads, 8 experts, top-2 GShard gates, vocab 32000, rope theta 1e6."""
    return LlamaMoeConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=num_hidden_layers, num_attention_heads=32,
        num_key_value_heads=8, max_position_embeddings=32768,
        rms_norm_eps=1e-5, rope_theta=1e6, num_experts=8, moe_top_k=2,
        gate_type="gshard")


class LlamaMoeDecoderLayer(nn.Module):
    """Attention + sparse-MoE FFN block.  With ``use_recompute`` the
    attention block and the expert FFNs are recomputed separately in the
    backward; the gate stays outside, so its loss keeps its graph."""

    def __init__(self, config: LlamaMoeConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.use_recompute = config.use_recompute
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.moe = MoELayer(
            config.hidden_size,
            ExpertFFN(config.num_experts, config.hidden_size,
                      config.intermediate_size, activation="swiglu", **kw),
            gate={"type": config.gate_type, "top_k": config.moe_top_k},
            recompute_interval=1 if config.use_recompute else 0, **kw)

    def forward(self, x, cos, sin, neg_sin, position_offset=0,
                kv_cache=None):
        attn_in = self.input_layernorm(x)
        new_cache = None
        if kv_cache is not None:
            attn_out, new_cache = self.self_attn(
                attn_in, cos, sin, neg_sin, position_offset,
                kv_cache=kv_cache)
        elif self.use_recompute and self.training \
                and torch.is_grad_enabled():
            attn_out = torch.utils.checkpoint.checkpoint(
                self.self_attn, attn_in, cos, sin, neg_sin, position_offset,
                use_reentrant=False)
        else:
            attn_out = self.self_attn(attn_in, cos, sin, neg_sin,
                                      position_offset)
        x = x + attn_out
        x = x + self.moe(self.post_attention_layernorm(x))
        if new_cache is not None:
            return x, new_cache
        return x


class LlamaMoeModel(nn.Module):
    def __init__(self, config: LlamaMoeConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList([LlamaMoeDecoderLayer(config, **kw)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        cos, sin = _rope_tables(
            config.hidden_size // config.num_attention_heads,
            config.max_position_embeddings, config.rope_theta)
        self.register_buffer("rope_cos", cos.to(device=device),
                             persistent=False)
        self.register_buffer("rope_sin", sin.to(device=device),
                             persistent=False)
        self.register_buffer("rope_sin_neg", (-sin).to(device=device),
                             persistent=False)

    def forward(self, input_ids, position_offset=0, kv_caches=None):
        """Hidden states; with ``kv_caches``, ``(hidden, new_caches)``
        and no gate loss left behind (see the module's docstring)."""
        x = self.embed_tokens(input_ids)
        new_caches = [] if kv_caches is not None else None
        for i, layer in enumerate(self.layers):
            if kv_caches is not None:
                x, cache = layer(x, self.rope_cos, self.rope_sin,
                                 self.rope_sin_neg, position_offset,
                                 kv_caches[i])
                new_caches.append(cache)
            else:
                x = layer(x, self.rope_cos, self.rope_sin, self.rope_sin_neg,
                          position_offset)
        x = self.norm(x)
        if new_caches is not None:
            for layer in self.layers:
                layer.moe.gate.get_loss(clear=True)
            return x, new_caches
        return x

    def aux_loss(self):
        """Sum of the layers' gate load-balancing losses, cleared on
        read (the reference's ``gate.get_loss(clear=True)``); None when
        no gate recorded one."""
        total = None
        for layer in self.layers:
            la = layer.moe.gate.get_loss(clear=True)
            if la is None:
                continue
            total = la if total is None else total + la
        return total


class LlamaMoeForCausalLM(nn.Module):
    """Causal LM over the MoE decoder; ``forward(input_ids)`` returns
    ``(logits, aux_loss_weight * aux)``.

    Weights are drawn on ``device`` from ``seed`` with the JAX
    initializers' distributions: N(0, 0.02) for the embedding and every
    Linear, XavierNormal for the gates and the stacked experts (the JAX
    package's fans), zero expert biases, unit norms; ``seed=None`` leaves
    them for a caller that loads them (``models.convert``).
    ``gate_dtype`` keeps the gates' weights in another type than
    ``dtype``: f32 gates in a bf16 model give f32 logits, which the
    gating kernel takes."""

    def __init__(self, config: LlamaMoeConfig, device="cuda", dtype=None,
                 seed: Optional[int] = 0, gate_dtype=None):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype if dtype is not None else _DTYPES[config.dtype]
        self.config = config
        self.model = LlamaMoeModel(config, device=device, dtype=dtype)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              device=device, dtype=dtype)
        if gate_dtype is not None:
            for layer in self.model.layers:
                layer.moe.gate.to(gate_dtype)
        if seed is not None:
            self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Draw every weight with one generator on the model's device
        seeded by ``seed``, module by module in ``modules()`` order."""
        device = self.model.embed_tokens.weight.device
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, (Linear, Embedding)):
                module.weight.normal_(0.0, 0.02, generator=gen)
            elif isinstance(module, (ExpertFFN, NaiveGate)):
                module.reset_parameters(gen)

    def forward(self, input_ids):
        logits = self._logits_of(self.model(input_ids))
        aux = self.model.aux_loss()
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        return logits, aux * self.config.aux_loss_weight

    def _logits_of(self, hidden):
        return self.lm_head(hidden)

    # the cache-path decode loop drives self.model(ids, offset, caches)
    # and self._logits_of, whatever the decoder: the dense model's
    generate = LlamaForCausalLM.generate


__all__ = ["LlamaMoeConfig", "LlamaMoeDecoderLayer", "LlamaMoeModel",
           "LlamaMoeForCausalLM", "mixtral_8x7b"]
