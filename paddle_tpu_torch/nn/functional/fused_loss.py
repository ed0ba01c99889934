"""Chunked fused linear + softmax cross entropy (port of
paddle_tpu/nn/functional/fused_loss.py).

The LM head's loss is the largest activation of decoder pretraining:
[tokens, vocab] logits in f32 (8 x 1024 x 32000 is 1.05 GB), written in
the forward and read back, with a gradient of the same size, in the
backward.  This function never holds them whole: the forward walks row
chunks, computes each chunk's logits in f32, reduces them to the chunk's
summed loss and drops them; the backward computes each chunk's logits
again, forms ``softmax - one_hot`` scaled by ``g / n_valid``, and
accumulates dW (and db) in f32 across the chunks, cast once at the end.

Numerics, as the JAX package's custom VJP: the mean cross entropy of
``hidden @ weight.T (+ bias)`` over the rows whose label is not
``ignore_index`` (at least 1 in the divisor, so a batch with every row
ignored gives 0), in f32 whatever the input type.  The logits are f32
products of the operands as they are: on the card a bf16 pair goes
through ``torch.mm(..., out_dtype=torch.float32)`` (exact bf16 products
summed in f32, as ``preferred_element_type=f32``), on the CPU the
operands are cast to f32 first, which computes the same products.  The
backward's two products take f32 operands, as JAX's do.  A tail chunk
shorter than ``chunk_rows`` is a shorter slice where the JAX package pads
it with ignored rows; the result is the same.

Weight layout: ``weight`` is [vocab, hidden], as the port's ``Linear``
stores ``lm_head.weight``; the JAX package's is [hidden, vocab], its
``Linear``'s layout.

The chunk's products are plain large GEMMs that XLA computes outside any
Pallas kernel in the JAX package, so torch ops are the port's form of
them.
"""
from __future__ import annotations

import torch

_LOW = (torch.bfloat16, torch.float16)


def _chunk_logits(h, weight, bias):
    """[c, H] x [V, H] -> [c, V] f32 logits (plus the bias in f32)."""
    dt = torch.promote_types(h.dtype, weight.dtype)
    h, weight = h.to(dt), weight.to(dt)
    if h.device.type == "cuda" and dt in _LOW:
        logits = torch.mm(h, weight.t(), out_dtype=torch.float32)
    else:
        logits = h.float() @ weight.float().t()
    if bias is not None:
        logits = logits + bias.float()
    return logits


def _chunks(n, chunk_rows):
    return [(s, min(s + chunk_rows, n)) for s in range(0, n, chunk_rows)]


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, weight, bias, labels, ignore_index,
                chunk_rows):
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for s, e in _chunks(hidden.shape[0], chunk_rows):
            logits = _chunk_logits(hidden[s:e], weight, bias)
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(1, safe[s:e, None])[:, 0]
            total = total + torch.where(valid[s:e], lse - picked,
                                        0.0).sum()
        n_valid = valid.sum().float().clamp_min(1.0)
        ctx.save_for_backward(hidden, weight, bias, safe, valid, n_valid)
        ctx.chunk_rows = chunk_rows
        return total / n_valid

    @staticmethod
    def backward(ctx, g):
        hidden, weight, bias, safe, valid, n_valid = ctx.saved_tensors
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        scale = g.float() / n_valid               # d(mean) / d(row loss)
        w32 = weight.float()
        dh = torch.empty_like(hidden) if need_h else None
        dw = torch.zeros_like(w32) if need_w else None
        db = (torch.zeros(weight.shape[0], dtype=torch.float32,
                          device=weight.device)
              if need_b and bias is not None else None)
        for s, e in _chunks(hidden.shape[0], ctx.chunk_rows):
            h = hidden[s:e]
            delta = torch.softmax(_chunk_logits(h, weight, bias), dim=-1)
            delta.scatter_add_(1, safe[s:e, None], torch.full(
                (e - s, 1), -1.0, dtype=delta.dtype, device=delta.device))
            delta.mul_((valid[s:e].float() * scale)[:, None])
            if dh is not None:
                dh[s:e] = delta @ w32
            if dw is not None:
                dw.addmm_(delta.t(), h.float())
            if db is not None:
                db.add_(delta.sum(dim=0))
        return (dh, None if dw is None else dw.to(weight.dtype),
                None if db is None else db.to(bias.dtype), None, None, None)


def fused_linear_cross_entropy_raw(hidden, weight, labels, bias=None,
                                   ignore_index=-100, chunk_rows=1024):
    """Mean cross entropy of ``hidden @ weight.T (+ bias)`` against
    ``labels`` without the [tokens, vocab] logits.  hidden [..., H]
    (leading dims flattened), weight [V, H] (the port's ``Linear``
    layout), labels [...] integers.  Returns an f32 scalar,
    differentiable in hidden, weight and bias."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    l1 = labels.reshape(-1).long()
    chunk_rows = min(int(chunk_rows), max(h2.shape[0], 1))
    return _FusedLinearCE.apply(h2, weight, bias, l1, int(ignore_index),
                                chunk_rows)


__all__ = ["fused_linear_cross_entropy_raw"]
