"""LLaMA decoder LM (port of paddle_tpu/models/llama.py).

The serving path hands a paged context down through ``paged_ctx``
exactly as the JAX model does; the eager decode loop (``generate``)
hands each layer its (k, v) cache through ``kv_caches``; without either,
attention is causal flash attention over the sequence, differentiable
for training.  RMSNorm, RoPE and attention run their hand-written
kernels on the card, forward and backward; the projections stay
``F.linear``, as the JAX package leaves them to XLA.  ``forward(input_ids, labels)`` returns
``(loss, logits)``; ``config.use_recompute`` recomputes each decoder
layer in the backward (``torch.utils.checkpoint``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .. import amp
from .._device import resolve_device
from ..nn import Embedding, Linear, RMSNorm
from ..nn.functional import cross_entropy
from ..ops.flash_attention import flash_attention_bshd
from ..ops import fused_norm_rope
from ..ops.quant_matmul import quant_forward

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    # recompute each decoder layer's activations in the backward instead
    # of keeping them (PaddleNLP's use_recompute; jax.checkpoint in the
    # JAX package)
    use_recompute: bool = False

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads


def llama_7b():
    return LlamaConfig()


def llama_small(vocab=32000):
    """~110M-param config."""
    return LlamaConfig(vocab_size=vocab, hidden_size=768,
                       intermediate_size=2048, num_hidden_layers=12,
                       num_attention_heads=12, num_key_value_heads=12,
                       max_position_embeddings=2048)


def _rope_tables(head_dim, max_pos, theta):
    """cos/sin (max_pos, head_dim/2): built in float64, stored in f32."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                           / head_dim))
    freqs = np.outer(np.arange(max_pos, dtype=np.float64), inv)
    return (torch.from_numpy(np.cos(freqs).astype(np.float32)),
            torch.from_numpy(np.sin(freqs).astype(np.float32)))


def apply_rope(q, k, cos, sin, position_offset, neg_sin):
    """Rotate-half RoPE on q (b, s, h, d) and k (b, s, kvh, d).

    ``position_offset`` is one int shared by every row, or a (b,) tensor
    of per-row offsets (continuous batching: each row sits at its own
    length).  A shared offset past the table raises; per-row offsets are
    device values the caller bounds (the engine does at submit), and an
    index past the table clamps, as JAX's gather does.  ``neg_sin`` is
    -sin for the backward's rotation (see ``fused_norm_rope``).  Under
    amp O2 the JAX op casts the f32 tables to the amp dtype, so the
    rotation uses the tables rounded to it (the kernel computes in f32
    either way)."""
    q, k, cos_c, sin_c = amp._cast_args("fused_rope", q, k, cos, sin)
    if cos_c is not cos:
        cos, sin = cos_c.float(), sin_c.float()
        neg_sin = -sin
    b, s = q.shape[0], q.shape[1]
    if isinstance(position_offset, torch.Tensor):
        positions = position_offset
    else:
        off = int(position_offset)
        if off + s > cos.shape[0]:
            raise ValueError(
                f"rope position {off + s} exceeds the table "
                f"({cos.shape[0]} = max_position_embeddings)")
        positions = torch.full((b,), off, dtype=torch.int32,
                               device=q.device)
    return fused_norm_rope.apply_rope(q, k, cos, sin, positions, neg_sin)


def _fused_projections(module, x):
    """The outputs of ``module.quant_fused``'s Linears from one armed
    fused twin (``_serving_quant``, set only inside a w8a8 serving step):
    one quantized matmul, split by views along the output axis."""
    out = quant_forward(x, module._serving_quant)
    widths = [getattr(module, n).out_features for n in module.quant_fused]
    return out.split(widths, dim=-1)


class LlamaAttention(nn.Module):
    #: Linears that read one activation: a w8a8 serving step arms their
    #: concatenated int8 twin on this module (``_serving_quant``)
    quant_fused = ("q_proj", "k_proj", "v_proj")

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 tp: int = 1):
        super().__init__()
        c = config
        # a tensor-parallel shard (tp > 1) holds its rank's heads; the
        # head width stays the model's
        self.num_heads = c.num_attention_heads // tp
        self.num_kv_heads = c.num_key_value_heads // tp
        self.head_dim = c.hidden_size // c.num_attention_heads
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(c.hidden_size, self.num_heads * self.head_dim,
                             **kw)
        self.k_proj = Linear(c.hidden_size,
                             self.num_kv_heads * self.head_dim, **kw)
        self.v_proj = Linear(c.hidden_size,
                             self.num_kv_heads * self.head_dim, **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, c.hidden_size,
                             **kw)
        self._serving_quant = None

    def forward(self, x, cos, sin, neg_sin, position_offset=0,
                kv_cache=None, paged_ctx=None):
        """The attention output; with ``kv_cache`` = (k, v) of the
        earlier positions, ``(output, (k, v))`` with this call's keys and
        values appended on the sequence axis, the queries attending
        causally aligned bottom-right (query i sees keys up to
        i + cached length)."""
        b, s = x.shape[0], x.shape[1]
        if self._serving_quant is not None:
            q, k, v = _fused_projections(self, x)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = q.view(b, s, self.num_heads, self.head_dim)
        k = k.view(b, s, self.num_kv_heads, self.head_dim)
        v = v.view(b, s, self.num_kv_heads, self.head_dim)
        q, k = apply_rope(q, k, cos, sin, position_offset, neg_sin)
        if paged_ctx is not None:
            out = paged_ctx.attend(q, k, v)
        else:
            if kv_cache is not None:
                k = torch.cat([kv_cache[0], k], dim=1)
                v = torch.cat([kv_cache[1], v], dim=1)
            q, k, v = amp._cast_args("flash_attention", q, k, v)
            out = flash_attention_bshd(q, k, v, causal=True)
        out = self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        if kv_cache is not None:
            return out, (k, v)
        return out


class LlamaMLP(nn.Module):
    quant_fused = ("gate_proj", "up_proj")      # as LlamaAttention's

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 tp: int = 1):
        super().__init__()
        c = config
        kw = dict(device=device, dtype=dtype)
        inner = c.intermediate_size // tp      # a shard's slice
        self.gate_proj = Linear(c.hidden_size, inner, **kw)
        self.up_proj = Linear(c.hidden_size, inner, **kw)
        self.down_proj = Linear(inner, c.hidden_size, **kw)
        self._serving_quant = None

    def forward(self, x):
        if self._serving_quant is not None:
            gate, up = _fused_projections(self, x)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 tp: int = 1):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, tp=tp, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, tp=tp, **kw)

    def forward(self, x, cos, sin, neg_sin, position_offset=0,
                kv_cache=None, paged_ctx=None):
        attn = self.self_attn(self.input_layernorm(x), cos, sin, neg_sin,
                              position_offset, kv_cache=kv_cache,
                              paged_ctx=paged_ctx)
        if kv_cache is not None:
            attn, new_cache = attn
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x))
        if kv_cache is not None:
            return x, new_cache
        return x


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 tp: int = 1):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, tp=tp, **kw)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        cos, sin = _rope_tables(
            config.hidden_size // config.num_attention_heads,
            config.max_position_embeddings, config.rope_theta)
        self.register_buffer("rope_cos", cos.to(device=device),
                             persistent=False)
        self.register_buffer("rope_sin", sin.to(device=device),
                             persistent=False)
        # -sin, the RoPE backward's table, kept so a train step makes none
        self.register_buffer("rope_sin_neg", (-sin).to(device=device),
                             persistent=False)

    def forward(self, input_ids, position_offset=0, kv_caches=None,
                paged_ctx=None):
        """Hidden states; with ``kv_caches`` (one (k, v) pair per layer,
        ``empty_kv_caches`` for a prefill), ``(hidden, new_caches)``."""
        x = self.embed_tokens(input_ids)
        recompute = (self.config.use_recompute and paged_ctx is None
                     and kv_caches is None and torch.is_grad_enabled())
        new_caches = [] if kv_caches is not None else None
        for i, layer in enumerate(self.layers):
            if paged_ctx is not None:
                paged_ctx.layer_idx = i
            if kv_caches is not None:
                x, cache = layer(x, self.rope_cos, self.rope_sin,
                                 self.rope_sin_neg, position_offset,
                                 kv_cache=kv_caches[i])
                new_caches.append(cache)
            elif recompute:
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, self.rope_cos, self.rope_sin, self.rope_sin_neg,
                    position_offset, use_reentrant=False,
                    context_fn=amp.recompute_contexts)
            else:
                x = layer(x, self.rope_cos, self.rope_sin, self.rope_sin_neg,
                          position_offset, paged_ctx=paged_ctx)
        x = self.norm(x)
        if new_caches is not None:
            return x, new_caches
        return x


def empty_kv_caches(model, batch: int):
    """One empty (k, v) cache pair per layer for the eager decode path:
    [batch, 0, kv_heads, head_dim] in the embedding's type and device
    (any causal LM with ``.config`` and ``.model.embed_tokens``)."""
    cfg = model.config
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    weight = model.model.embed_tokens.weight
    empty = torch.zeros((batch, 0, cfg.num_key_value_heads, head_dim),
                        dtype=weight.dtype, device=weight.device)
    return [(empty, empty) for _ in range(cfg.num_hidden_layers)]


class LlamaForCausalLM(nn.Module):
    """LLaMA causal LM.  Weights are drawn on ``device`` from ``seed`` as
    N(0, 0.02) for every projection and the embedding (norm weights are
    ones), as the JAX model's ``Normal(std=0.02)`` initializers do;
    ``seed=None`` leaves them uninitialized for a caller that loads
    them (``models.convert.params_from_numpy``).

    ``tp > 1`` builds one rank's shard for tensor-parallel serving
    (``inference.paged._tp_plan``): q/k/v and gate/up keep the rank's
    ``1/tp`` of their output features, o and down of their input
    features, the rest is whole.  Its forward gives the right hidden
    states only inside a serving step that closes each block with an
    all-reduce (``models.convert.shard_model`` builds one; the
    ``config`` stays the whole model's)."""

    def __init__(self, config: LlamaConfig, device="cuda", dtype=None,
                 seed: Optional[int] = 0, tp: int = 1):
        super().__init__()
        device = resolve_device(device)
        dtype = dtype if dtype is not None else _DTYPES[config.dtype]
        self.config = config
        self.model = LlamaModel(config, device=device, dtype=dtype, tp=tp)
        self.lm_head = (None if config.tie_word_embeddings else
                        Linear(config.hidden_size, config.vocab_size,
                               device=device, dtype=dtype))
        if seed is not None:
            self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Draw every Linear/Embedding weight from N(0, 0.02) with a
        generator on the model's device seeded by ``seed``."""
        device = self.model.embed_tokens.weight.device
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        for module in self.modules():
            if isinstance(module, (Linear, Embedding)):
                module.weight.normal_(0.0, 0.02, generator=gen)

    def forward(self, input_ids, labels=None):
        """Logits (b, s, vocab); with ``labels`` (b, s), ``(loss, logits)``
        where the loss is the mean cross entropy over labels other than
        -100, as the JAX model returns."""
        logits = self._logits_of(self.model(input_ids))
        if labels is None:
            return logits
        loss = cross_entropy(logits.reshape(-1, self.config.vocab_size),
                             labels.reshape(-1), ignore_index=-100)
        return loss, logits

    def _logits_of(self, hidden):
        if self.lm_head is not None:
            return self.lm_head(hidden)
        hidden, weight = amp._cast_args("tied_lm_head", hidden,
                                        self.model.embed_tokens.weight)
        return hidden @ weight.T

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, do_sample: bool = False,
                 eos_token_id: Optional[int] = None, seed: int = 0):
        """Autoregressive decoding with a KV cache, the JAX package's
        eager loop: one prefill forward over the prompt, then one forward
        per new token over the cached K/V (including one after the last
        token, as there).  Greedy by default; temperature, top-k and
        top-p sampling with ``do_sample=True`` draw on the host from
        ``np.random.default_rng(seed)`` exactly as the JAX loop does, so
        equal logits give equal tokens.  ``input_ids`` [b, s] (a tensor
        or an array); returns prompt and new tokens, [b, s + n]."""
        device = self.model.embed_tokens.weight.device
        ids = torch.as_tensor(input_ids, device=device)
        caches = empty_kv_caches(self, int(ids.shape[0]))
        hidden, caches = self.model(ids, 0, caches)
        logits = self._logits_of(hidden[:, -1:])
        out_tokens = [ids]
        rng = np.random.default_rng(seed)
        finished = np.zeros(int(ids.shape[0]), bool)
        pos = int(ids.shape[1])
        for _ in range(max_new_tokens):
            step_logits = logits[:, -1].float().cpu().numpy()
            if do_sample:
                if temperature and temperature != 1.0:
                    step_logits = step_logits / max(temperature, 1e-6)
                if top_k is not None:
                    kth = np.partition(
                        step_logits, -top_k, axis=-1)[:, -top_k][:, None]
                    step_logits = np.where(step_logits < kth, -np.inf,
                                           step_logits)
                if top_p is not None:
                    sort_idx = np.argsort(-step_logits, axis=-1)
                    sorted_l = np.take_along_axis(step_logits, sort_idx,
                                                  axis=-1)
                    probs = np.exp(sorted_l - sorted_l.max(-1, keepdims=True))
                    probs /= probs.sum(-1, keepdims=True)
                    cum = probs.cumsum(-1)
                    cut = cum - probs > top_p
                    sorted_l[cut] = -np.inf
                    restored = np.full_like(step_logits, -np.inf)
                    np.put_along_axis(restored, sort_idx, sorted_l, axis=-1)
                    step_logits = restored
                p = np.exp(step_logits - step_logits.max(-1, keepdims=True))
                p /= p.sum(-1, keepdims=True)
                nxt = np.array([rng.choice(p.shape[-1], p=p[b])
                                for b in range(p.shape[0])])
            else:
                nxt = step_logits.argmax(-1)
            if eos_token_id is not None:
                nxt = np.where(finished, eos_token_id, nxt)
                finished |= nxt == eos_token_id
            nxt_t = torch.as_tensor(nxt[:, None], dtype=ids.dtype,
                                    device=device)
            out_tokens.append(nxt_t)
            if eos_token_id is not None and finished.all():
                break
            hidden, caches = self.model(nxt_t, pos, caches)
            logits = self._logits_of(hidden)
            pos += 1
        return torch.cat(out_tokens, dim=1)
