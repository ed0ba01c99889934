"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Port of paddle_tpu/ops/pallas/flash_attention.py (forward only; the
backward kernels belong to the training slice).  The kernel lives in
``csrc/flash_attention.cu`` — its header says what it replaces, what
bounds it and how it is laid out.  ``flash_attention_forward`` takes the
plain version for CPU tensors and launches the kernel for CUDA tensors.
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


def flash_attention_forward(q, k, v, causal=False, scale=None):
    """Attention forward, layout (b, h, s, d).  Returns (out, lse f32):
    the CUDA kernel on the card, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    return flash_attention_cuda(q, k, v, causal, scale)


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """Inference attention in the Paddle layout (batch, seq, heads,
    head_dim): ``mha_reference`` on the CPU, as the JAX package runs it
    off the TPU, the CUDA kernel on the card.  There the kernel reads
    and writes the (b, s, h, d) buffers through strides, with no
    transposed copies."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.device.type == "cpu":
        # what the JAX package runs off the TPU (``_mha_ref_bshd``)
        return mha_reference(qt, kt, vt, causal, scale).transpose(1, 2)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention_cuda(qt, kt, vt, causal, scale, out=out.transpose(1, 2))
    return out
