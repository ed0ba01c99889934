"""Flash attention: hand-written CUDA kernels and their plain versions.

Port of paddle_tpu/ops/pallas/flash_attention.py.  The forward kernels
live in ``csrc/flash_attention.cu``, the backward kernels (dK/dV and dQ)
in ``csrc/flash_attention_bwd.cu`` — each header says what it replaces,
what bounds it and how it is laid out.  bf16 calls of the forward and of
dK/dV take the tensor-core (wgmma) kernels, f32 calls the CUDA-core ones.
Every public function takes the plain version for CPU tensors and
launches the kernels for CUDA tensors.  ``flash_attention_bshd`` is
differentiable when autograd
asks for it: ``_FlashAttention`` saves the forward's output and f32 lse
and runs the backward kernels, as the JAX package's
``flash_attention_bhsd`` custom_vjp does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

#: the JAX package's mask value: finite (-0.7 * f32 max), so masked
#: columns contribute exact zeros and a fully masked row stays finite
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _repeat_kv(k, v, q_heads):
    group = q_heads // k.shape[1]
    if group != 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    return k, v


def mha_reference(q, k, v, causal=False, scale=None):
    """Plain attention, layout (batch, heads, seq, head_dim), GQA by
    repeating kv heads; the causal mask is bottom-right aligned."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = _repeat_kv(k, v, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def flash_attention_plain(q, k, v, causal=False, scale=None):
    """The XLA branch of the JAX package's ``_fwd_impl``: (out, lse)
    with lse the f32 log-sum-exp of the masked, scaled scores."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v = _repeat_kv(k, v, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, DEFAULT_MASK_VALUE)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype), lse


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        i32 = ctypes.c_int
        lib.flash_attention_fwd.argtypes = [
            vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp, i32,
            ctypes.c_float, i32, vp]
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def flash_attention_cuda(q, k, v, causal=False, scale=None, out=None):
    """Launch the CUDA flash-attention forward on (b, h, s, d) tensors
    (any strides with a contiguous last dim, 16-byte aligned rows).
    Returns (out, lse); ``out`` may be passed in, e.g. as a transposed
    view of a (b, s, h, d) buffer."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         "device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes f32 or bf16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    b, h, sq, d = q.shape
    kv_h, sk = k.shape[1], k.shape[2]
    if d not in (64, 128) or k.shape != (b, kv_h, sk, d) \
            or v.shape != k.shape or h % kv_h:
        raise ValueError(f"flash_attention_cuda: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} (head_dim 64 or 128)")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if out is None:
        out = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} needs a "
                             "contiguous last dim and 16-byte aligned rows")
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if b * h * sq == 0:
        return out, lse
    strides = (ctypes.c_int64 * 12)(*(q.stride()[:3] + k.stride()[:3]
                                      + v.stride()[:3] + out.stride()[:3]))
    lib = _lib()
    status = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, kv_h, sq, sk, d, ctypes.addressof(strides),
        int(bool(causal)), float(scale), _DTYPES[q.dtype],
        _build.stream_ptr(dev))
    if status:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(status)
                           .decode())
    flash_attention_cuda.launches += 1
    return out, lse


flash_attention_cuda.launches = 0


def _into(buf, t):
    """``t``, or ``buf`` holding a copy of it when a buffer was given."""
    return t if buf is None else buf.copy_(t)


def flash_attention_forward(q, k, v, causal=False, scale=None, out=None):
    """Attention forward, layout (b, h, s, d).  Returns (out, lse f32):
    the CUDA kernel on the card, the plain version on the CPU.  ``out``
    may be passed in, e.g. as a transposed view of a (b, s, h, d)
    buffer."""
    if q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, causal, scale)
        return _into(out, o), lse
    return flash_attention_cuda(q, k, v, causal, scale, out=out)


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """Attention in the Paddle layout (batch, seq, heads, head_dim).

    With grad enabled and an input that requires it, this is
    ``_FlashAttention``: forward and backward kernels on the card, their
    plain versions on the CPU.  Otherwise (serving, under ``no_grad``)
    it is one direct launch: ``mha_reference`` on the CPU, as the JAX
    package runs it off the TPU, the CUDA kernel on the card.  There the
    kernels read and write the (b, s, h, d) buffers through strides,
    with no transposed copies."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), scale)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.device.type == "cpu":
        # what the JAX package runs off the TPU (``_mha_ref_bshd``)
        return mha_reference(qt, kt, vt, causal, scale).transpose(1, 2)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention_cuda(qt, kt, vt, causal, scale, out=out.transpose(1, 2))
    return out


# ---------------------------------------------------------------- backward
def _bwd_blockwise(q, k, v, out, lse, do, causal, scale, block_kv=1024):
    """Plain FA2 backward (the JAX package's ``_bwd_blockwise``), layout
    (b, h, s, d): kv blocks in turn, p = where(mask, exp(s - lse), 0),
    dK/dV of the GQA group summed in f32.  Returns (dq, dk, dv) in the
    inputs' dtypes."""
    b, h, sq, d = q.shape
    kv_h, sk = k.shape[1], k.shape[2]
    group = h // kv_h
    kf, vf = _repeat_kv(k.float(), v.float(), h)
    qf = q.float()
    dof = do.float()
    delta = (out.float() * dof).sum(-1)                       # (b, h, sq)
    rows = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for c0 in range(0, sk, block_kv):
        kb, vb = kf[:, :, c0:c0 + block_kv], vf[:, :, c0:c0 + block_kv]
        cols = c0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        p = torch.exp(s - lse[..., None])
        if causal:   # bottom-right aligned (offset sk - sq)
            p = torch.where(rows + (sk - sq) >= cols, p, 0.0)
        dv[:, :, c0:c0 + block_kv] = torch.einsum("bhqk,bhqd->bhkd", p, dof)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dk[:, :, c0:c0 + block_kv] = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    if group != 1:
        dk = dk.view(b, kv_h, group, sk, d).sum(2)
        dv = dv.view(b, kv_h, group, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        i32 = ctypes.c_int
        lib.flash_attention_bwd_dkv.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
            vp, i32, ctypes.c_float, i32, vp]
        lib.flash_attention_bwd_dkv.restype = i32
        lib.flash_attention_bwd_dq.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp,
            i32, ctypes.c_float, i32, vp]
        lib.flash_attention_bwd_dq.restype = i32
        lib.flash_attention_bwd_error_string.argtypes = [i32]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _bwd_args(q, k, v, do, lse, delta, dq, dk, dv):
    """Check the backward kernels' operands; return (strides, shape)."""
    dev = q.device
    ts = dict(q=q, k=k, v=v, do=do, dq=dq, dk=dk, dv=dv)
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (*ts.values(), lse, delta)):
        raise ValueError("the flash backward kernels need every operand on "
                         "one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in ts.values()):
        raise ValueError(f"the flash backward kernels take f32 or bf16, got "
                         f"{sorted({str(t.dtype) for t in ts.values()})}")
    b, h, sq, d = q.shape
    kv_h, sk = k.shape[1], k.shape[2]
    if d not in (64, 128) or h % kv_h or k.shape != (b, kv_h, sk, d) \
            or any(t.shape != q.shape for t in (do, dq)) \
            or any(t.shape != k.shape for t in (v, dk, dv)):
        raise ValueError(f"flash backward: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} (head_dim "
                         "64 or 128, heads a multiple of kv heads)")
    for t in (lse, delta):
        if t.dtype != torch.float32 or t.shape != (b, h, sq) \
                or not t.is_contiguous():
            raise ValueError("flash backward: lse and delta must be "
                             "contiguous (b, h, sq) f32")
    vec = 16 // q.element_size()
    for name, t in ts.items():
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash backward: {name} needs a contiguous "
                             "last dim and 16-byte aligned rows")
    strides = (ctypes.c_int64 * 21)(*[st for t in ts.values()
                                      for st in t.stride()[:3]])
    return strides, (b, h, kv_h, sq, sk, d)


def _check(lib, status, what):
    if status:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.flash_attention_bwd_error_string(status)
                           .decode())


def flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta, dq, dk, dv,
                                 causal, scale):
    """Launch the dK/dV kernel: writes ``dk``, ``dv`` (b, kv_h, sk, d)."""
    strides, (b, h, kv_h, sq, sk, d) = _bwd_args(q, k, v, do, lse, delta,
                                                 dq, dk, dv)
    if b * kv_h * sk == 0:
        return
    lib = _bwd_lib()
    _check(lib, lib.flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        kv_h, sq, sk, d, ctypes.addressof(strides), int(bool(causal)),
        float(scale), _DTYPES[q.dtype], _build.stream_ptr(q.device)),
        "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv_cuda.launches += 1


flash_attention_bwd_dkv_cuda.launches = 0


def flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, dq, dk, dv,
                                causal, scale):
    """Launch the dQ kernel: writes ``dq`` (b, h, sq, d)."""
    strides, (b, h, kv_h, sq, sk, d) = _bwd_args(q, k, v, do, lse, delta,
                                                 dq, dk, dv)
    if b * h * sq == 0:
        return
    lib = _bwd_lib()
    _check(lib, lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, kv_h, sq, sk,
        d, ctypes.addressof(strides), int(bool(causal)), float(scale),
        _DTYPES[q.dtype], _build.stream_ptr(q.device)),
        "flash_attention_bwd_dq")
    flash_attention_bwd_dq_cuda.launches += 1


flash_attention_bwd_dq_cuda.launches = 0


def _aligned(t):
    """``t`` itself when the kernels can read it through strides, else a
    contiguous copy (an incoming gradient may come in any layout)."""
    vec = 16 // t.element_size()
    if t.stride(-1) == 1 and not any(st % vec for st in t.stride()[:-1]) \
            and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def flash_attention_backward_cuda(q, k, v, out, lse, do, causal=False,
                                  scale=None, dq=None, dk=None, dv=None):
    """FA2 backward on the card, layout (b, h, s, d) (any strides with a
    contiguous last dim): delta = rowsum(out * do) in f32 (a torch op, as
    in the JAX package), then the dK/dV and the dQ kernels.  The
    gradients may be passed in, e.g. as transposed views of (b, s, h, d)
    buffers.  Returns (dq, dk, dv)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    do = _aligned(do)
    delta = (out.float() * do.float()).sum(-1).contiguous()
    lse = lse.contiguous()
    if dq is None:
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dk is None:
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    if dv is None:
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    args = (q, k, v, do, lse, delta, dq, dk, dv, causal, scale)
    flash_attention_bwd_dkv_cuda(*args)
    flash_attention_bwd_dq_cuda(*args)
    return dq, dk, dv


def flash_attention_backward(q, k, v, out, lse, do, causal=False,
                             scale=None, dq=None, dk=None, dv=None):
    """FA2 backward, layout (b, h, s, d): the CUDA kernels on the card,
    ``_bwd_blockwise`` on the CPU.  The gradients may be passed in as
    buffers, as for ``flash_attention_backward_cuda``.  Returns (dq, dk,
    dv)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        grads = _bwd_blockwise(q, k, v, out, lse, do, causal, scale)
        return tuple(_into(buf, g) for buf, g in zip((dq, dk, dv), grads))
    return flash_attention_backward_cuda(q, k, v, out, lse, do, causal,
                                         scale, dq=dq, dk=dk, dv=dv)


class _FlashAttention(torch.autograd.Function):
    """Differentiable attention in the (b, s, h, d) layout: the port of
    ``flash_attention_bhsd``'s custom_vjp.  The forward saves its output
    and f32 lse; the backward runs the dK/dV and dQ kernels on the card
    (``_bwd_blockwise`` on the CPU).  Output and gradients are written
    straight into (b, s, h, d) buffers through transposed views."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        _, lse = flash_attention_forward(qt, kt, vt, causal, scale,
                                         out=out.transpose(1, 2))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                      for t in (q, k, v))
        qt, kt, vt, ot, dot = (t.transpose(1, 2)
                               for t in (q, k, v, out, do))
        flash_attention_backward(
            qt, kt, vt, ot, lse, dot, ctx.causal, ctx.scale,
            dq=dq.transpose(1, 2), dk=dk.transpose(1, 2),
            dv=dv.transpose(1, 2))
        return dq, dk, dv, None, None
