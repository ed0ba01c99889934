"""Top-k MoE gating: a hand-written CUDA kernel and its plain version.

Port of paddle_tpu/ops/pallas/moe_gating.py (``topk_gating_pallas``, whose
``_round_kernel`` runs once per round).  Both compute the contract of the
routing oracle ``topk_routing_plain`` (the JAX package's
``gate._topk_routing``) from the logits: the softmax gates, ``top_k``
masked-argmax rounds, each assignment's slot in its expert's capacity
buffer counted ROUND-MAJOR over every token (every token's round-0
choice takes a slot before any round-1 choice, which decides what a full
expert drops), the keep mask, the capacity-masked weights and the GShard
balance loss.

``topk_gating`` takes the plain version for a CPU tensor and launches the
kernel of ``csrc/moe_gating.cu`` (its header says what bounds it and how
it is laid out) for a CUDA tensor; there is no fallback between the two.
With grad enabled it is ``_TopkGating``: the integer routing carries no
gradient, and the backward maps the weights' and the loss's cotangents
back to the logits through the softmax with torch ops, as autodiff of the
oracle does.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

#: the kernel keeps a token's gates in registers, up to this many experts
MAX_EXPERTS = 64


def topk_routing_plain(gates, top_k, capacity, normalize, random_keep=None):
    """Capacity-based top-k routing of ``gates`` [T, E] (softmax
    probabilities), the JAX package's ``_topk_routing``.

    ``random_keep``: optional [T] uniforms; the second choice is kept only
    where u < 2 * p2 (GShard random routing).  Returns (expert_idx [k, T]
    int32, slot_pos [k, T] int32, keep [k, T] bool, weight [k, T] in the
    gates' type, capacity-masked and normalized if asked, l_aux scalar).
    Slots count EVERY token that chose the expert, so dropped assignments
    leave holes in the buffer (GShard semantics).

    A chosen expert is masked by multiplying its gate by 0, not by -inf:
    where every other gate has underflowed to 0 the argmax picks the first
    expert again (ties go to the first index), and that assignment's
    weight is the expert's unmasked gate."""
    T, E = gates.shape
    remaining = gates
    fill = torch.zeros(E, dtype=torch.int64, device=gates.device)
    eidx_l, pos_l, keep_l, w_l = [], [], [], []
    first_mask = None
    for k in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                    # [T]
        onehot = F.one_hot(idx, E)                               # [T, E]
        if first_mask is None:
            first_mask = onehot
        pos_grid = torch.cumsum(onehot, dim=0) - onehot + fill[None, :]
        pos = (pos_grid * onehot).sum(dim=1)                     # [T]
        within = pos < capacity
        gate_val = gates.gather(1, idx[:, None])[:, 0]
        if k == 1 and random_keep is not None:
            within = within & (random_keep < 2.0 * gate_val)
        eidx_l.append(idx.to(torch.int32))
        pos_l.append(pos.to(torch.int32))
        keep_l.append(within)
        w_l.append(gate_val * within.to(gates.dtype))
        fill = fill + onehot.sum(dim=0)
        remaining = remaining * (1 - onehot).to(gates.dtype)
    w = torch.stack(w_l)                                         # [k, T]
    if normalize:
        w = w / w.sum(dim=0, keepdim=True).clamp_min(1e-9)
    # GShard load-balance loss over the primary (top-1) assignment:
    # E * sum_e(mean_prob_e * fraction_tokens_e)
    me = gates.mean(dim=0)
    ce = first_mask.to(gates.dtype).mean(dim=0)
    l_aux = (me * ce).sum() * E
    return (torch.stack(eidx_l), torch.stack(pos_l), torch.stack(keep_l), w,
            l_aux)


def topk_gating_plain(logits, top_k, capacity, normalize):
    """The kernel's plain version: ``topk_routing_plain`` on
    ``torch.softmax`` of ``logits`` [T, E]."""
    return topk_routing_plain(torch.softmax(logits, dim=-1), top_k, capacity,
                              normalize)


#: the kernel's paths (``csrc/moe_gating.cu``): up to WARP_TOKENS tokens
#: run on one warp; more on blocks of CHUNK_TOKENS tokens, a thread each
WARP_TOKENS = 32
CHUNK_TOKENS = 256


def gating_plan(T):
    """(device kernel, tokens a block) of a call with ``T`` tokens."""
    if T <= WARP_TOKENS:
        return "topk_gating_warp_kernel", WARP_TOKENS
    return "topk_gating_chunk_kernel", CHUNK_TOKENS


def topk_gating_chunked_plain(logits, top_k, capacity,
                              chunk=CHUNK_TOKENS):
    """The multi-block kernel's algebra in torch ops, on its raw
    contract: (eidx, pos, keep [k, T] int32, w [k, T] f32
    capacity-masked and unnormalized, fill [E] int32, gsum [E] f32).
    Every round's choice of a token at once; each chunk of ``chunk``
    tokens counts its assignments per (round, expert); a slot is the
    totals of the earlier rounds plus the counts of the earlier chunks in
    its round plus the token's exclusive count inside its chunk.  The
    gate mass is summed per chunk, then over the chunks in order."""
    gates = torch.softmax(logits, dim=-1)
    T, E = gates.shape
    remaining = gates
    eidx, raw = [], []
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        eidx.append(idx)
        raw.append(gates.gather(1, idx[:, None])[:, 0])
        remaining = remaining * (1 - F.one_hot(idx, E)).to(gates.dtype)
    eidx = torch.stack(eidx)                                  # [k, T]
    n = -(-T // chunk)
    onehot = F.pad(F.one_hot(eidx, E), (0, 0, 0, n * chunk - T))
    onehot = onehot.view(top_k, n, chunk, E)
    counts = onehot.sum(dim=2)                                # [k, n, E]
    totals = counts.sum(dim=1)                                # [k, E]
    base = ((totals.cumsum(dim=0) - totals)[:, None, :]       # rounds < r
            + counts.cumsum(dim=1) - counts)                  # chunks < c
    slot = onehot.cumsum(dim=2) - onehot + base[:, :, None, :]
    pos = (slot * onehot).sum(dim=-1).view(top_k, n * chunk)[:, :T]
    keep = pos < capacity
    w = torch.stack(raw) * keep.to(gates.dtype)
    gpart = F.pad(gates, (0, 0, 0, n * chunk - T)).view(n, chunk, E).sum(1)
    gsum = torch.zeros(E, dtype=gates.dtype, device=gates.device)
    for c in range(n):
        gsum = gsum + gpart[c]
    return (eidx.to(torch.int32), pos.to(torch.int32),
            keep.to(torch.int32), w, totals[0].to(torch.int32), gsum)


def _lib():
    lib = _build.load("moe_gating")
    if not getattr(lib, "_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.moe_topk_gating_fwd.argtypes = [vp, i32, i32, i32, i32, vp, vp,
                                            vp, vp, vp, vp, vp, vp, vp]
        lib.moe_topk_gating_fwd.restype = i32
        lib.moe_topk_gating_grid.argtypes = [i32, i32, i32]
        lib.moe_topk_gating_grid.restype = i32
        lib.moe_gating_error_string.argtypes = [i32]
        lib.moe_gating_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


#: per device: the chunk kernel's grid-barrier words (arrivals,
#: generation), zero once; each call leaves the arrivals at 0
_barriers = {}


def _barrier(dev):
    bar = _barriers.get(dev.index)
    if bar is None:
        bar = _barriers[dev.index] = torch.zeros(2, dtype=torch.int32,
                                                 device=dev)
    return bar


def gating_grid(T, E, top_k):
    """The launch grid (blocks) of a call with ``T`` tokens: 1 on the
    warp path, else the chunks, at most the blocks the card holds at
    once (asked of the card)."""
    if T <= WARP_TOKENS:
        return 1
    grid = _lib().moe_topk_gating_grid(T, E, top_k)
    if grid < 1:
        raise RuntimeError("moe_gating: the occupancy query failed")
    return grid


def topk_gating_cuda(logits, top_k, capacity):
    """Launch the CUDA gating kernel on f32 ``logits`` [T, E] (E <= 64) on
    the card: one warp up to ``WARP_TOKENS`` tokens, blocks of
    ``CHUNK_TOKENS`` above (:func:`gating_plan`).  Returns the kernel's
    raw outputs: ``eidx``, ``pos`` and ``keep`` [k, T] int32, the
    capacity-masked, unnormalized weight ``w`` [k, T] f32, the round-0
    ``fill`` [E] int32 (each expert's top-1 count) and ``gsum`` [E] f32
    (each expert's gate mass).  Calls on one device run one at a time
    (they share the chunk kernel's grid barrier), as on one stream."""
    if logits.device.type != "cuda" or logits.dtype != torch.float32 \
            or logits.dim() != 2:
        raise ValueError(f"topk_gating_cuda takes f32 [T, E] logits on a "
                         f"CUDA device, got {logits.dtype} "
                         f"{tuple(logits.shape)} on {logits.device}")
    T, E = logits.shape
    if not 1 <= E <= MAX_EXPERTS or top_k < 1 or capacity < 1:
        raise ValueError(f"topk_gating_cuda: 1 <= E <= {MAX_EXPERTS}, "
                         f"top_k >= 1 and capacity >= 1 expected, got E={E}, "
                         f"top_k={top_k}, capacity={capacity}")
    dev = logits.device
    logits = logits.contiguous()
    ints = torch.empty((3, top_k, T), dtype=torch.int32, device=dev)
    eidx, pos, keep = ints
    w = torch.empty((top_k, T), dtype=torch.float32, device=dev)
    if T == 0:
        return (eidx, pos, keep, w, torch.zeros(E, dtype=torch.int32,
                                                device=dev),
                torch.zeros(E, dtype=torch.float32, device=dev))
    fill = torch.empty(E, dtype=torch.int32, device=dev)
    gsum = torch.empty(E, dtype=torch.float32, device=dev)
    ws = bar = None
    if T > WARP_TOKENS:
        # per chunk: its (round, expert) counts and its gate mass
        ws = torch.empty(-(-T // CHUNK_TOKENS) * (top_k + 1) * E,
                         dtype=torch.int32, device=dev)
        bar = _barrier(dev)
    lib = _lib()
    status = lib.moe_topk_gating_fwd(
        logits.data_ptr(), T, E, int(top_k), int(capacity), eidx.data_ptr(),
        pos.data_ptr(), keep.data_ptr(), w.data_ptr(), fill.data_ptr(),
        gsum.data_ptr(), ws.data_ptr() if ws is not None else None,
        bar.data_ptr() if bar is not None else None, _build.stream_ptr(dev))
    if status:
        raise RuntimeError("moe_gating kernel launch failed: "
                           + lib.moe_gating_error_string(status).decode())
    topk_gating_cuda.launches += 1
    return eidx, pos, keep, w, fill, gsum


topk_gating_cuda.launches = 0


def _epilogue(logits, raw, normalize):
    """The JAX wrapper's epilogue on the kernel's raw outputs: w
    normalized by max(sum, 1e-9) in the logits' type, and l_aux from the
    kernel's own byproducts (round-0 fill is the top-1 count, gsum the
    gate mass), with no [T, E] replay."""
    eidx, pos, keep, w, fill, gsum = raw
    T, E = logits.shape
    if normalize:
        w = w / w.sum(dim=0, keepdim=True).clamp_min(1e-9)
    w = w.to(logits.dtype)
    l_aux = ((gsum / T) * (fill.to(torch.float32) / T)).sum() * E
    return eidx, pos, keep.bool(), w, l_aux


def _route(logits, top_k, capacity, normalize):
    """(eidx, pos, keep, w, l_aux): the plain version on the CPU, the
    kernel and its epilogue on the card."""
    if logits.device.type == "cpu":
        return topk_gating_plain(logits, top_k, capacity, normalize)
    return _epilogue(logits, topk_gating_cuda(logits, top_k, capacity),
                     normalize)


def _weights(logits, eidx, keep, normalize):
    """The differentiable part of the oracle with the routing held fixed:
    (w [k, T], l_aux) as functions of the logits."""
    gates = torch.softmax(logits, dim=-1)
    E = gates.shape[1]
    w = gates.gather(1, eidx.t().long()).t() * keep.to(gates.dtype)
    if normalize:
        w = w / w.sum(dim=0, keepdim=True).clamp_min(1e-9)
    ce = F.one_hot(eidx[0].long(), E).to(gates.dtype).mean(dim=0)
    return w, (gates.mean(dim=0) * ce).sum() * E


class _TopkGating(torch.autograd.Function):
    """Routing forward (kernel or plain version); backward through the
    softmax to the logits, for the weights and the balance loss."""

    @staticmethod
    def forward(ctx, logits, top_k, capacity, normalize):
        eidx, pos, keep, w, l_aux = _route(logits, top_k, capacity,
                                           normalize)
        ctx.save_for_backward(logits, eidx, keep)
        ctx.normalize = normalize
        ctx.mark_non_differentiable(eidx, pos, keep)
        return eidx, pos, keep, w, l_aux

    @staticmethod
    def backward(ctx, _deidx, _dpos, _dkeep, dw, dl_aux):
        logits, eidx, keep = ctx.saved_tensors
        with torch.enable_grad():
            x = logits.detach().requires_grad_()
            w, l_aux = _weights(x, eidx, keep, ctx.normalize)
            outs = [o for o, g in ((w, dw), (l_aux, dl_aux)) if g is not None]
            grads = [g for g in (dw, dl_aux) if g is not None]
            if not outs:
                return None, None, None, None
            (dx,) = torch.autograd.grad(outs, (x,), grads)
        return dx, None, None, None


def topk_gating(logits, top_k, capacity, normalize):
    """(eidx [k, T] int32, pos [k, T] int32, keep [k, T] bool, w [k, T],
    l_aux): the routing of ``logits`` [T, E], differentiable in the logits
    when grad is enabled and they require it."""
    if torch.is_grad_enabled() and logits.requires_grad:
        return _TopkGating.apply(logits, top_k, capacity, normalize)
    return _route(logits, top_k, capacity, normalize)
