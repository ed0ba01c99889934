"""CTC loss and greedy decoding (port of paddle_tpu/nn/functional/ctc.py).

The loss is the log-space alpha recursion over time, as in the JAX
package: labels padded to their longest, each sample's input and label
lengths masked, the blank-interleaved extended labels (2L + 1) built with
gathers, and autograd for the backward.  ``F.ctc_loss`` is not used: it
takes log-probabilities where the reference takes logits, and its CUDA
backward is nondeterministic.  Every step is a fixed-shape torch op, so a
graphed ``jit.TrainStep`` captures the loss whole.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import amp

# finite sentinel (JAX ``_NEG_INF``): logaddexp of two is finite, and so
# is its gradient
_NEG_INF = -1e30


class _TakeClasses(torch.autograd.Function):
    """``log_probs`` [T, B, C] gathered at ``ext`` [B, S] along C for every
    step: [T, B, S].  Its backward sums the gradients of the positions
    that name one class (the blank at every other position, repeated
    labels) with a batched f64 product against the one-hot of ``ext``,
    in a fixed order: the scatter-add of torch's gather backward adds
    them with atomics on a card, in an order that varies run to run."""

    @staticmethod
    def forward(ctx, log_probs, ext):
        ctx.save_for_backward(ext)
        ctx.classes = log_probs.shape[-1]
        steps = log_probs.shape[0]
        return log_probs.gather(2, ext.unsqueeze(0).expand(steps, -1, -1))

    @staticmethod
    def backward(ctx, grad):
        (ext,) = ctx.saved_tensors
        # a comparison, not ``F.one_hot``, which reads the indices' range
        # back to the host (a sync a graph capture refuses)
        classes = torch.arange(ctx.classes, device=ext.device)
        onehot = (ext.unsqueeze(-1) == classes).double()
        # [B, T, S] @ [B, S, C] -> [B, T, C]
        g = torch.bmm(grad.transpose(0, 1).double(), onehot)
        return g.transpose(0, 1).to(grad.dtype), None


def _ctc_nll(logits, labels, input_lengths, label_lengths, blank,
             norm_by_times):
    """JAX ``_ctc_loss`` (op ``ctc_loss_``): logits [T, B, C] (log-softmax
    taken here, in f32), labels [B, L] padded; per-sample NLL [B]."""
    steps, batch, _ = logits.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = logits.device
    log_probs = torch.log_softmax(logits.float(), -1)
    lab = labels.long()
    ext = torch.full((batch, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    # s - 2 may be skipped where ext[s] is a label unlike ext[s - 2]
    can_skip = torch.zeros((batch, S), dtype=torch.bool, device=dev)
    can_skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    ilen = input_lengths.long()
    llen = label_lengths.long()
    s_len = 2 * llen + 1
    emit = _TakeClasses.apply(log_probs, ext)          # [T, B, S]
    neg = torch.full((batch, 2), _NEG_INF, device=dev)
    first = emit[0]
    alpha = torch.cat([first[:, :1],
                       torch.where(llen[:, None] > 0, first[:, 1:2],
                                   _NEG_INF),
                       neg.new_full((batch, S - 2), _NEG_INF)], 1)
    for t in range(1, steps):
        a = torch.logaddexp(alpha, torch.cat([neg[:, :1], alpha[:, :-1]], 1))
        skip = torch.logaddexp(a, torch.cat([neg, alpha[:, :-2]], 1))
        new_alpha = torch.where(can_skip, skip, a) + emit[t]
        # frozen past the sample's input length (read at t = ilen - 1)
        alpha = torch.where((ilen > t)[:, None], new_alpha, alpha)
    idx_last = (s_len - 1).clamp(0, S - 1)
    idx_prev = (s_len - 2).clamp(0, S - 1)
    a_last = alpha.gather(1, idx_last[:, None])[:, 0]
    a_prev = alpha.gather(1, idx_prev[:, None])[:, 0]
    a_prev = torch.where(s_len >= 2, a_prev, _NEG_INF)
    nll = -torch.logaddexp(a_last, a_prev)
    if norm_by_times:
        nll = nll / ilen.float().clamp_min(1.0)
    return nll


def _clip(x, lo):
    """The JAX op ``clip`` of the mean's denominator."""
    (x,) = amp._cast_args("clip", x)
    return x.clamp_min(lo)


def _divide(a, b):
    a, b = amp._cast_args("divide", a, b)
    return a / b


def _mean(x):
    (x,) = amp._cast_args("mean", x)
    return x.mean()


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """The reference's ``ctc_loss``: raw LOGITS [max_logit_length, batch,
    num_classes + 1] (the softmax is inside, as warpctc's), int labels
    [batch, max_label_length], lengths [batch] as tensors on the logits'
    device.  ``"mean"`` divides each sample's NLL by its label length
    (clipped to at least 1) and averages; ``"sum"`` sums; ``"none"`` is
    the per-sample NLL."""
    logits, labels, input_lengths, label_lengths = amp._cast_args(
        "ctc_loss_", log_probs, labels, input_lengths, label_lengths)
    nll = _ctc_nll(logits, labels, input_lengths, label_lengths, int(blank),
                   bool(norm_by_times))
    if reduction == "mean":
        denom = _clip(label_lengths.float(), 1.0)
        return _mean(_divide(nll, denom))
    if reduction == "sum":
        (nll,) = amp._cast_args("sum", nll)
        return nll.sum()
    return nll


def ctc_decode(log_probs, input_lengths=None, blank=0):
    """Greedy (best-path) decoding on the host: the argmax of each frame,
    repeats collapsed, blanks dropped.  ``log_probs`` [T, B, C] (logits or
    log-probabilities).  Returns (decoded [B, Lmax] int64 padded with -1,
    lengths [B]) as CPU tensors."""
    if log_probs.dim() != 3:
        raise ValueError("ctc_decode expects [T, B, C] log-probs/logits")
    steps, batch, _ = log_probs.shape
    path = log_probs.argmax(-1).cpu().numpy()
    ilen = np.full(batch, steps) if input_lengths is None else \
        np.asarray(torch.as_tensor(input_lengths).cpu())
    outs = []
    for b in range(batch):
        seq, prev = [], -1
        for t in range(int(ilen[b])):
            c = int(path[t, b])
            if c != blank and c != prev:
                seq.append(c)
            prev = c
        outs.append(seq)
    dec = np.full((batch, max(max((len(s) for s in outs), default=0), 1)),
                  -1, np.int64)
    for b, s in enumerate(outs):
        dec[b, :len(s)] = s
    return (torch.from_numpy(dec),
            torch.tensor([len(s) for s in outs], dtype=torch.int64))
