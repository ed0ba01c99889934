"""FlashMask attention: hand-written CUDA kernels and their plain versions.

Port of paddle_tpu/ops/pallas/flashmask_attention.py, the reference's
``flashmask_attention`` (PaddlePaddle 3.0; Wang et al., "FlashMask:
Efficient and Rich Mask Extension of FlashAttention", arXiv:2410.01359).
The mask is given as per-column row intervals, ``startend_row_indices``
(b, hm, sk, ncol) int32: column j of the score matrix is masked for the
rows in [start_j, end_j).  With 1 column the band is [start, sq); with 2
it is [start, end); with 4 there are two bands, [s0, s1) and [s2, s3).
``causal`` adds the top-left causal mask ``rows < cols`` (no sk - sq
offset, unlike the flash kernels).  The mask heads ``hm`` divide the q
heads (q head i reads mask head i // (h / hm)), and so do the kv heads
(GQA, which the Pallas kernels lack: the JAX package's dense path
repeats K/V, and so does the port).

Semantics follow the Pallas kernels: masked scores take the finite
``DEFAULT_MASK_VALUE``, probabilities are zeroed by the mask rather than
left to underflow, and a row that every column masks gives out 0 and lse
``DEFAULT_MASK_VALUE`` (the JAX dense path, whose -1e30 bias leaves such
a row's scores all equal, gives the mean of v there instead).

The forward and the two FA2 backward kernels (dK/dV and dQ) live in
``csrc/flashmask_attention.cu``; its header says what bounds them.  Every
bf16 call runs on the tensor cores (wgmma: the flash kernels' designs,
``flashmask_fwd_wgmma_kernel``, ``flashmask_bwd_dkv_wgmma_kernel`` and
``flashmask_bwd_dq_wgmma_kernel``), every f32 call on the CUDA cores
(``flashmask_fwd_kernel``, ``flashmask_bwd_dkv_kernel``,
``flashmask_bwd_dq_kernel``); the dtype alone picks the kernel.  The bf16
backward kernels round P and dS to bf16 before their products (dQ: dS
before dQ += dS K), where the JAX kernels take them in f32.  They skip
tiles that the mask covers whole, from a table computed here by torch
ops on the device (``flashmask_skip_table``, the port of
``_skip_table``) at the kernels' own 64 x 64 tiles.  Every public
function takes the plain version for CPU tensors and launches the
kernels for CUDA tensors.  ``flashmask_attention_bshd`` is
differentiable when autograd asks for it: ``_FlashMaskAttention`` is the
port of the ``flashmask_attention_fused`` custom_vjp.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import (DEFAULT_MASK_VALUE, _DTYPES, _aligned, _into,
                              _repeat_kv)

#: rows of a q tile and columns of a kv tile in the CUDA kernels, and so
#: the tile of the skip table they read (``kB`` in the source)
BLOCK = 64


def _check(q, k, v, startend_row_indices):
    """Validate the shapes, as ``_prep`` does; return (ncol, hm)."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    se = startend_row_indices
    if se.dim() != 4 or se.shape[0] != b or se.shape[2] != sk:
        raise ValueError(f"startend_row_indices must be (b, mask heads, "
                         f"sk, ncol) = ({b}, hm, {sk}, ncol), got "
                         f"{tuple(se.shape)}")
    hm, ncol = se.shape[1], se.shape[3]
    if ncol not in (1, 2, 4):
        raise ValueError(f"startend_row_indices last dim must be 1, 2 or "
                         f"4, got {ncol}")
    if h % hm != 0:
        raise ValueError(f"mask heads ({hm}) must divide q heads ({h})")
    if h % kvh != 0 or k.shape != (b, kvh, sk, d) or v.shape != k.shape:
        raise ValueError(f"kv heads must divide q heads: q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if se.dtype.is_floating_point or se.dtype.is_complex \
            or se.dtype == torch.bool:
        raise ValueError(f"startend_row_indices must be integers, got "
                         f"{se.dtype}")
    return ncol, hm


def flashmask_skip_table(startend_row_indices, sq, causal=False,
                         block_q=BLOCK, block_kv=BLOCK):
    """(b, hm, n_q, n_kv) int32: 1 where the (q tile, kv tile) is masked
    whole, so the kernels skip it.  Torch ops on the intervals' device,
    with no host sync.  As ``_skip_table``: per kv tile the largest start
    and the smallest end of each interval column (columns past sk pad as
    the empty band [sq, sq)); a tile is covered when every row of it lies
    in one band for every column (conservative for 4 columns: a tile
    covered only by the union of both bands still runs); with ``causal``
    a tile wholly above the diagonal (q tile end <= kv tile start) is
    skipped too."""
    se = startend_row_indices
    b, hm, sk, ncol = se.shape
    n_q, n_kv = -(-sq // block_q), -(-sk // block_kv)
    cols = se.to(torch.int32).transpose(2, 3)           # (b, hm, ncol, sk)
    pad = n_kv * block_kv - sk
    if pad:
        cols = torch.nn.functional.pad(cols, (0, pad), value=sq)
    tiles = cols.reshape(b, hm, ncol, n_kv, block_kv)
    smax, smin = tiles.amax(-1), tiles.amin(-1)         # (b, hm, ncol, n_kv)
    q0 = torch.arange(n_q, device=se.device)[:, None] * block_q
    q1 = (q0 + block_q).clamp(max=sq)                   # (n_q, 1)

    def covered(lo_max, hi_min):
        return (lo_max[:, :, None, :] <= q0) & (hi_min[:, :, None, :] >= q1)

    if ncol == 1:
        full = covered(smax[:, :, 0], torch.full_like(smin[:, :, 0], sq))
    elif ncol == 2:
        full = covered(smax[:, :, 0], smin[:, :, 1])
    else:
        full = covered(smax[:, :, 0], smin[:, :, 1]) \
            | covered(smax[:, :, 2], smin[:, :, 3])
    if causal:
        k0 = torch.arange(n_kv, device=se.device)[None, :] * block_kv
        full = full | (q1 <= k0)
    return full.to(torch.int32)


# ------------------------------------------------------------ plain versions
def _heads(startend_row_indices, h):
    """The intervals per q head: (b, h, sk, ncol), head i from mask head
    i // (h / hm)."""
    hm = startend_row_indices.shape[1]
    return startend_row_indices.repeat_interleave(h // hm, dim=1)


def _keep(bands, rows, cols, ncol, causal):
    """KEEP mask (True = attend) of a kv block, as ``_keep_mask``: bands
    (b, h, nb, ncol), rows (sq, 1), cols (1, nb) -> (b, h, sq, nb).  With
    one column the band is [start, sq), and every row is below sq."""
    def lo(c):
        return bands[..., c][:, :, None, :]

    def band(a, b_):
        return (rows >= lo(a)) & (rows < lo(b_))

    if ncol == 1:
        masked = rows >= lo(0)
    elif ncol == 2:
        masked = band(0, 1)
    else:
        masked = band(0, 1) | band(2, 3)
    if causal:
        masked = masked | (rows < cols)
    return ~masked


def flashmask_attention_plain(q, k, v, startend_row_indices, causal=False,
                              scale=None, block_kv=512):
    """FlashMask forward, layout (b, h, s, d), with the Pallas kernel's
    semantics: kv blocks in turn with an online softmax in f32, masked
    scores set to ``DEFAULT_MASK_VALUE``, p = where(keep, exp(s - m), 0)
    cast to v's type before it meets v, and a fully masked row giving out
    0 and lse ``DEFAULT_MASK_VALUE``.  Returns (out, lse f32)."""
    ncol, _ = _check(q, k, v, startend_row_indices)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bands = _heads(startend_row_indices, h)
    kf, vf = _repeat_kv(k.float(), v.float(), h)
    qf = q.float()
    rows = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, h, sq, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for c0 in range(0, sk, block_kv):
        kb, vb = kf[:, :, c0:c0 + block_kv], vf[:, :, c0:c0 + block_kv]
        cols = c0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        keep = _keep(bands[:, :, c0:c0 + block_kv], rows, cols, ncol, causal)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        s = torch.where(keep, s, DEFAULT_MASK_VALUE)
        m_next = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.where(keep, torch.exp(s - m_next), 0.0)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd",
                                         p.to(v.dtype).float(), vb)
        m = m_next
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).to(q.dtype)
    lse = torch.where(l > 0.0, m + torch.log(l_safe), DEFAULT_MASK_VALUE)
    return out, lse[..., 0]


def flashmask_attention_backward_plain(q, k, v, out, lse, do,
                                       startend_row_indices, causal=False,
                                       scale=None, block_kv=512):
    """FlashMask FA2 backward, layout (b, h, s, d): kv blocks in turn,
    delta = rowsum(out * do) in f32, p = where(keep, exp(s - lse), 0)
    (never the exp of a masked row's lse, which would be inf), dK/dV of
    the GQA group summed in f32 before one cast.  Returns (dq, dk, dv)
    in the inputs' types."""
    ncol, _ = _check(q, k, v, startend_row_indices)
    b, h, sq, d = q.shape
    kv_h, sk = k.shape[1], k.shape[2]
    group = h // kv_h
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bands = _heads(startend_row_indices, h)
    kf, vf = _repeat_kv(k.float(), v.float(), h)
    qf, dof = q.float(), do.float()
    delta = (out.float() * dof).sum(-1)[..., None]           # (b, h, sq, 1)
    lse = lse[..., None]
    rows = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for c0 in range(0, sk, block_kv):
        kb, vb = kf[:, :, c0:c0 + block_kv], vf[:, :, c0:c0 + block_kv]
        cols = c0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        keep = _keep(bands[:, :, c0:c0 + block_kv], rows, cols, ncol, causal)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        p = torch.exp(torch.where(keep, s - lse, -math.inf))
        dv[:, :, c0:c0 + block_kv] = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vb)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dk[:, :, c0:c0 + block_kv] = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    if group != 1:
        dk = dk.view(b, kv_h, group, sk, d).sum(2)
        dv = dv.view(b, kv_h, group, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ CUDA kernels
def _lib():
    lib = _build.load("flashmask_attention")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        i32 = ctypes.c_int
        # b, h, kv_h, hm, sq, sk, d, ncol, strides; causal, scale, dtype,
        # stream
        tail = [i32] * 8 + [vp, i32, ctypes.c_float, i32, vp]
        lib.flashmask_fwd.argtypes = [vp] * 7 + tail
        lib.flashmask_bwd_dkv.argtypes = [vp] * 10 + tail
        lib.flashmask_bwd_dq.argtypes = [vp] * 9 + tail
        for fn in (lib.flashmask_fwd, lib.flashmask_bwd_dkv,
                   lib.flashmask_bwd_dq):
            fn.restype = i32
        lib.flashmask_error_string.argtypes = [i32]
        lib.flashmask_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _operands(what, q, k, v, startend_row_indices, skip, causal, floats):
    """Check the kernels' operands: q, k, v and every tensor of
    ``floats`` (name -> tensor; each wrapper checks their shapes) on one
    CUDA device, f32 or bf16 with a contiguous last dim and 16-byte
    aligned rows; head_dim 64 or 128.  Returns (intervals int32
    contiguous, skip table, shape args, strides of q, k, v and
    ``floats`` in order)."""
    dev = q.device
    ts = dict(q=q, k=k, v=v, **floats)
    ncol, hm = _check(q, k, v, startend_row_indices)
    if dev.type != "cuda" or any(t.device != dev for t in ts.values()) \
            or startend_row_indices.device != dev:
        raise ValueError(f"{what} needs every operand on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in ts.values()):
        raise ValueError(f"{what} takes f32 or bf16, got "
                         f"{sorted({str(t.dtype) for t in ts.values()})}")
    b, h, sq, d = q.shape
    kv_h, sk = k.shape[1], k.shape[2]
    if d not in (64, 128):
        raise ValueError(f"{what}: head_dim must be 64 or 128, got {d}")
    vec = 16 // q.element_size()
    for name, t in ts.items():
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} needs a contiguous last dim "
                             "and 16-byte aligned rows")
    se = startend_row_indices.to(torch.int32).contiguous()
    if skip is None:
        skip = flashmask_skip_table(se, sq, causal)
    n_q, n_kv = -(-sq // BLOCK), -(-sk // BLOCK)
    if skip.shape != (b, hm, n_q, n_kv) or skip.dtype != torch.int32 \
            or not skip.is_contiguous() or skip.device != dev:
        raise ValueError(f"{what}: the skip table must be contiguous int32 "
                         f"({b}, {hm}, {n_q}, {n_kv}) at tile {BLOCK}")
    strides = [st for t in ts.values() for st in t.stride()[:3]]
    return se, skip, (b, h, kv_h, hm, sq, sk, d, ncol), strides


def _launch(lib, fn, what, args, shape, strides, causal, scale, dtype,
            dev):
    st = (ctypes.c_int64 * len(strides))(*strides)
    status = fn(*args, *shape, ctypes.addressof(st), int(bool(causal)),
                float(scale), _DTYPES[dtype], _build.stream_ptr(dev))
    if status:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.flashmask_error_string(status).decode())


def flashmask_fwd_cuda(q, k, v, startend_row_indices, causal=False,
                       scale=None, out=None, skip=None):
    """Launch the FlashMask forward kernel (bf16: the tensor-core kernel;
    f32: the CUDA-core kernel) on (b, h, s, d) tensors (any strides with
    a contiguous last dim, 16-byte aligned rows).  Returns
    (out, lse f32 (b, h, sq)); ``out`` may be passed in, e.g. as a
    transposed view of a (b, s, h, d) buffer, and so may the skip
    table."""
    b, h, sq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if out is None:
        out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    se, skip, shape, strides = _operands(
        "flashmask_fwd_cuda", q, k, v, startend_row_indices, skip, causal,
        dict(out=out))
    if out.shape != q.shape:
        raise ValueError("flashmask_fwd_cuda: out must be shaped like q")
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return out, lse
    lib = _lib()
    _launch(lib, lib.flashmask_fwd, "flashmask_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), se.data_ptr(), skip.data_ptr()),
            shape, strides, causal, scale, q.dtype, q.device)
    flashmask_fwd_cuda.launches += 1
    return out, lse


flashmask_fwd_cuda.launches = 0


def _bwd_operands(what, q, k, v, do, lse, delta, startend_row_indices,
                  skip, causal, grads):
    se, skip, shape, strides = _operands(
        what, q, k, v, startend_row_indices, skip, causal,
        dict(do=do, **grads))
    if do.shape != q.shape:
        raise ValueError(f"{what}: do must be shaped like q")
    b, h, sq = q.shape[:3]
    for t in (lse, delta):
        if t.dtype != torch.float32 or t.shape != (b, h, sq) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{what}: lse and delta must be contiguous "
                             "(b, h, sq) f32")
    return se, skip, shape, strides


def flashmask_bwd_dkv_cuda(q, k, v, do, lse, delta, startend_row_indices,
                           dk, dv, causal=False, scale=None, skip=None):
    """Launch the dK/dV kernel (bf16: the tensor-core kernel, P and dS
    rounded to bf16 before their products; f32: the CUDA-core kernel):
    writes ``dk``, ``dv`` (b, kv_h, sk, d), the GQA group summed in f32
    before one cast."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    se, skip, shape, strides = _bwd_operands(
        "flashmask_bwd_dkv_cuda", q, k, v, do, lse, delta,
        startend_row_indices, skip, causal, dict(dk=dk, dv=dv))
    if dk.shape != k.shape or dv.shape != k.shape:
        raise ValueError("flashmask_bwd_dkv_cuda: dk, dv must be shaped "
                         "like k")
    if k.numel() == 0:
        return
    lib = _lib()
    _launch(lib, lib.flashmask_bwd_dkv, "flashmask_bwd_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), se.data_ptr(),
             skip.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            shape, strides, causal, scale, q.dtype, q.device)
    flashmask_bwd_dkv_cuda.launches += 1


flashmask_bwd_dkv_cuda.launches = 0


def flashmask_bwd_dq_cuda(q, k, v, do, lse, delta, startend_row_indices,
                          dq, causal=False, scale=None, skip=None):
    """Launch the dQ kernel (bf16: the tensor-core kernel, dS rounded to
    bf16 before dQ += dS K; f32: the CUDA-core kernel): writes ``dq`` (b,
    h, sq, d) once per element, in q's type."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    se, skip, shape, strides = _bwd_operands(
        "flashmask_bwd_dq_cuda", q, k, v, do, lse, delta,
        startend_row_indices, skip, causal, dict(dq=dq))
    if dq.shape != q.shape:
        raise ValueError("flashmask_bwd_dq_cuda: dq must be shaped like q")
    if q.numel() == 0:
        return
    lib = _lib()
    _launch(lib, lib.flashmask_bwd_dq, "flashmask_bwd_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), se.data_ptr(),
             skip.data_ptr(), dq.data_ptr()),
            shape, strides, causal, scale, q.dtype, q.device)
    flashmask_bwd_dq_cuda.launches += 1


flashmask_bwd_dq_cuda.launches = 0


# ------------------------------------------------------------- dispatchers
def flashmask_attention_forward(q, k, v, startend_row_indices, causal=False,
                                scale=None, out=None):
    """FlashMask forward, layout (b, h, s, d).  Returns (out, lse f32):
    the CUDA kernel on the card, the plain version on the CPU.  ``out``
    may be passed in, e.g. as a transposed view of a (b, s, h, d)
    buffer."""
    if q.device.type == "cpu":
        o, lse = flashmask_attention_plain(q, k, v, startend_row_indices,
                                           causal, scale)
        return _into(out, o), lse
    return flashmask_fwd_cuda(q, k, v, startend_row_indices, causal, scale,
                              out=out)


def flashmask_attention_backward(q, k, v, out, lse, do,
                                 startend_row_indices, causal=False,
                                 scale=None, dq=None, dk=None, dv=None):
    """FlashMask FA2 backward, layout (b, h, s, d): on the card delta =
    rowsum(out * do) in f32 (a torch op, as in the JAX package), one skip
    table, then the dK/dV and the dQ kernels; on the CPU the plain
    version.  The gradients may be passed in as buffers, e.g. transposed
    views of (b, s, h, d) tensors.  Returns (dq, dk, dv)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        grads = flashmask_attention_backward_plain(
            q, k, v, out, lse, do, startend_row_indices, causal, scale)
        return tuple(_into(buf, g) for buf, g in zip((dq, dk, dv), grads))
    do = _aligned(do)
    delta = (out.float() * do.float()).sum(-1).contiguous()
    lse = lse.contiguous()
    se = startend_row_indices.to(torch.int32).contiguous()
    skip = flashmask_skip_table(se, q.shape[2], causal)
    if dq is None:
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dk is None:
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    if dv is None:
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    flashmask_bwd_dkv_cuda(q, k, v, do, lse, delta, se, dk, dv, causal,
                           scale, skip=skip)
    flashmask_bwd_dq_cuda(q, k, v, do, lse, delta, se, dq, causal, scale,
                          skip=skip)
    return dq, dk, dv


def flashmask_attention_bshd(q, k, v, startend_row_indices, causal=False,
                             scale=None):
    """FlashMask attention in the Paddle layout (batch, seq, heads,
    head_dim).  With grad enabled and an input that requires it, this is
    ``_FlashMaskAttention``; otherwise one direct forward.  On the card
    the kernels read and write the (b, s, h, d) buffers through strides,
    with no transposed copies."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashMaskAttention.apply(q, k, v, startend_row_indices,
                                         bool(causal), scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flashmask_attention_forward(qt, kt, vt, startend_row_indices, causal,
                                scale, out=out.transpose(1, 2))
    return out


class _FlashMaskAttention(torch.autograd.Function):
    """Differentiable FlashMask attention in the (b, s, h, d) layout: the
    port of ``flashmask_attention_fused``'s custom_vjp.  The forward saves
    its output and f32 lse; the backward runs the dK/dV and dQ kernels on
    the card (the plain backward on the CPU) and returns no gradient for
    the intervals (the JAX package returns zeros)."""

    @staticmethod
    def forward(ctx, q, k, v, startend_row_indices, causal, scale):
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        _, lse = flashmask_attention_forward(
            qt, kt, vt, startend_row_indices, causal, scale,
            out=out.transpose(1, 2))
        ctx.save_for_backward(q, k, v, out, lse, startend_row_indices)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, se = ctx.saved_tensors
        dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for t in (q, k, v))
        qt, kt, vt, ot, dot = (t.transpose(1, 2)
                               for t in (q, k, v, out, do))
        flashmask_attention_backward(
            qt, kt, vt, ot, lse, dot, se, ctx.causal, ctx.scale,
            dq=dq.transpose(1, 2), dk=dk.transpose(1, 2),
            dv=dv.transpose(1, 2))
        return dq, dk, dv, None, None, None
