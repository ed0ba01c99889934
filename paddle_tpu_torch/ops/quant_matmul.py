"""Int8 quantized matmuls for serving: weight-only (w8) and w8a8.

Port of paddle_tpu/ops/pallas/quant_matmul.py.  The weight keeps the
port's Linear layout: ``w_q`` [N, K] int8, K contiguous (the JAX
package's twin is its transpose, [K, N]), with per-out-channel f32
scales ``scale`` [N].  ``weight_only_matmul`` and ``w8a8_matmul`` take
their plain versions (twins of ``weight_only_matmul_xla`` and
``w8a8_matmul_xla``) for CPU tensors and launch the CUDA kernels of
``csrc/quant_matmul.cu`` (its header says what they replace, what bounds
them and how they are laid out) for CUDA tensors; there is no fallback
between the two.

``dynamic_act_quant`` is the one symmetric int8 rule of the port: the
w8a8 activations here and the KV slots through
``paged_attention.quantize_kv``.  In the JAX package it is XLA ops; on
the card the port runs it as one kernel of the same source (bit-equal to
the torch ops of ``dynamic_act_quant_plain``), because the ~8 launches
of the torch ops cost host time on every Linear and every K/V write.
The kernel is picked by row shape (``act_quant_plan``), and a w8a8
serving step quantizes each distinct activation once: the twins of
Linears that read one activation are fused (``quant_forward`` on a
module's concatenated twin, ``quantization.serving``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: s32 cannot overflow below this depth: 127 * 127 * K < 2**31
MAX_K = 133_000


def dynamic_act_quant(x: torch.Tensor):
    """Symmetric dynamic int8 quantization over the last axis:
    x (..., K) float -> (x_q int8 (..., K), scale f32 (..., 1)), scale =
    absmax / 127.  A row of zeros quantizes to zeros with a tiny positive
    scale, so it dequantizes to exact zeros."""
    if x.device.type == "cpu":
        return dynamic_act_quant_plain(x)
    return dynamic_act_quant_cuda(x)


# ------------------------------------------------------------ plain twins
def dynamic_act_quant_plain(x: torch.Tensor):
    """Twin of the JAX package's ``dynamic_act_quant``, in torch ops.
    The divisor 127 is a tensor: torch on CUDA turns division by a Python
    scalar into a multiply by its reciprocal, a bit off the JAX rule."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-30) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def weight_only_matmul_plain(x, w_q, scale):
    """Twin of ``weight_only_matmul_xla``: x [M, K] float, w_q [N, K]
    int8, scale [N] -> x @ w_q.T in f32 (int8 values are exact in x's
    type), times the scale once, cast to x's type."""
    acc = x.float() @ w_q.float().t()
    return (acc * scale.float()[None, :]).to(x.dtype)


def w8a8_matmul_plain(x_q, x_scale, w_q, scale, out_dtype):
    """Twin of ``w8a8_matmul_xla``: the s8 x s8 product summed exactly
    (in f64, exact while |sum| < 2**53, then s32), dequantized as
    ``acc * x_scale * scale`` in f32, in that order.  f64 because the
    card has no integer matmul in torch."""
    acc = (x_q.double() @ w_q.double().t()).to(torch.int32)
    return (acc.float() * x_scale.float()
            * scale.float()[None, :]).to(out_dtype)


# ------------------------------------------------------------ the kernels
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("quant_matmul")
    if not getattr(lib, "_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.weight_only_matmul_workspace.argtypes = [i32, i32, i32, i32]
        lib.weight_only_matmul_workspace.restype = ctypes.c_longlong
        lib.weight_only_matmul_fwd.argtypes = [vp, vp, vp, vp, i32, i32, i32,
                                               i32, vp, vp]
        lib.weight_only_matmul_fwd.restype = i32
        lib.w8a8_matmul_workspace.argtypes = [i32, i32, i32]
        lib.w8a8_matmul_workspace.restype = ctypes.c_longlong
        lib.w8a8_matmul_fwd.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32,
                                        i32, vp, vp]
        lib.w8a8_matmul_fwd.restype = i32
        lib.dynamic_act_quant_fwd.argtypes = [vp, vp, vp, i32, i32, i32,
                                               i64, i64, i32, i32, i32,
                                               vp]
        lib.dynamic_act_quant_fwd.restype = i32
        lib.quant_matmul_error_string.argtypes = [i32]
        lib.quant_matmul_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _aligned(t):
    """Contiguous, 16-byte aligned (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(name, x, w_q, scale, tensors):
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or x.dim() != 2 \
            or x.shape[1] != w_q.shape[1] \
            or tuple(scale.shape) != (w_q.shape[0],) \
            or scale.dtype != torch.float32:
        raise ValueError(
            f"{name}: x [M, K], int8 w_q [N, K] and f32 scale [N] expected, "
            f"got {tuple(x.shape)} {x.dtype}, {tuple(w_q.shape)} "
            f"{w_q.dtype}, {tuple(scale.shape)} {scale.dtype}")
    if x.shape[1] > MAX_K:
        raise ValueError(f"{name}: K = {x.shape[1]} may overflow the s32 "
                         f"sum (at most {MAX_K})")


def _raise_on(status, lib, name):
    if status:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.quant_matmul_error_string(status).decode())


#: the quantizer's kernels, by row shape (``csrc/quant_matmul.cu``)
ACT_GROUP_MAX_K = 1024      # act_quant_group_kernel: rows this long or less
ACT_GROUP_THREADS = 128     # ... in blocks of this many threads
ACT_GROUP_BLOCKS_PER_SM = 16  # ... that many resident on an SM
ACT_ROW_THREADS = 256       # act_quant_row_kernel: threads it aims below
ACT_ROW_MAX_THREADS = 1024  # ... and at most
ACT_ROW_MAX_VECS = 4        # vectors a thread holds at most
#: the H100's SMs, where no card is asked (the CPU tests)
_DEFAULT_SMS = 132


def act_quant_plan(rows, K, dtype, aligned, sms=_DEFAULT_SMS):
    """The quantizer's launch for ``rows`` rows of ``K`` elements of
    ``dtype`` on a card of ``sms`` SMs, from shapes alone: (kernel name,
    grid, threads a block, param), param being the lanes a row (group
    kernel) or the threads a block (row kernel).  ``aligned``: every row
    starts 16-byte aligned and K fills whole 16-byte vectors, which the
    vector kernels read.  A lane of the group kernel holds one vector, or
    two where one would ask for more blocks than the card holds at once;
    a thread of the row kernel 1, 2 or 4, the fewest that keep the block
    within ``ACT_ROW_THREADS`` (chosen on the H100, PERF.md)."""
    n = 16 // (4 if dtype == torch.float32 else 2)
    nvec = K // n
    if aligned and K % n == 0:
        if K <= ACT_GROUP_MAX_K:
            lanes = min(32, 1 << max(0, nvec - 1).bit_length())
            if lanes > 1 and -(-rows * lanes // ACT_GROUP_THREADS) \
                    > ACT_GROUP_BLOCKS_PER_SM * sms:
                lanes //= 2
            return ("act_quant_group_kernel",
                    -(-rows * lanes // ACT_GROUP_THREADS),
                    ACT_GROUP_THREADS, lanes)
        for vecs in (1, 2, ACT_ROW_MAX_VECS):
            threads = -(-nvec // vecs)
            threads = -(-threads // 32) * 32
            if threads <= ACT_ROW_THREADS:
                break
        if threads <= ACT_ROW_MAX_THREADS:
            return "act_quant_row_kernel", rows, threads, threads
    return "act_quant_edge_kernel", rows, 256, 0


_sm_counts = {}


def _sms(device):
    """The SMs of a CUDA device, asked once."""
    sms = _sm_counts.get(device.index)
    if sms is None:
        sms = _sm_counts[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return sms


_ACT_PATHS = {"act_quant_group_kernel": 0, "act_quant_row_kernel": 1,
              "act_quant_edge_kernel": 2}


def _row_layout(x):
    """(inner, s_outer, s_inner): row r of ``x`` (..., K), last dim
    contiguous, starts at (r // inner) * s_outer + (r % inner) * s_inner
    elements, or None where the leading dims need more than two strides.
    A contiguous tensor is (1, K, 0); the v slice of a fused q|k|v output,
    (b * s, kv_heads, d) with strides (N, d, 1), is (kv_heads, N, d)."""
    dims = []                     # innermost first, size-1 dims dropped
    for n, st in reversed(list(zip(x.shape[:-1], x.stride()[:-1]))):
        if n == 1:
            continue
        if dims and st == dims[-1][0] * dims[-1][1]:
            dims[-1] = (dims[-1][0] * n, dims[-1][1])
        else:
            dims.append((n, st))
    if len(dims) > 2:
        return None
    if len(dims) < 2:
        return 1, (dims[0][1] if dims else x.shape[-1]), 0
    (inner, s_inner), (_outer, s_outer) = dims
    return inner, s_outer, s_inner


def dynamic_act_quant_cuda(x):
    """Launch the CUDA activation-quantization kernel on an f32/bf16
    tensor (..., K) on the card -> (x_q int8 (..., K), f32 (..., 1)).
    The kernel is chosen by row shape (:func:`act_quant_plan`); a view
    whose rows two strides address is read in place."""
    if x.device.type != "cuda" or x.dtype not in _DTYPES:
        raise ValueError(f"dynamic_act_quant_cuda takes an f32 or bf16 CUDA "
                         f"tensor, got {x.dtype} on {x.device}")
    layout = _row_layout(x) if x.dim() and x.stride(-1) == 1 else None
    if layout is None:
        x = x.contiguous()
        layout = _row_layout(x)
    inner, s_outer, s_inner = layout
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                        device=x.device)
    rows, K = scale.numel(), x.shape[-1]
    if rows == 0 or K == 0:
        return q, scale
    n = 16 // x.element_size()
    aligned = (x.data_ptr() % 16 == 0 and s_outer % n == 0
               and s_inner % n == 0)
    kernel, _grid, _threads, param = act_quant_plan(rows, K, x.dtype,
                                                    aligned, _sms(x.device))
    lib = _lib()
    _raise_on(lib.dynamic_act_quant_fwd(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, K, inner,
        s_outer, s_inner, _DTYPES[x.dtype], _ACT_PATHS[kernel], param,
        _build.stream_ptr(x.device)), lib, "dynamic_act_quant")
    dynamic_act_quant_cuda.launches += 1
    return q, scale


dynamic_act_quant_cuda.launches = 0


def weight_only_matmul_cuda(x, w_q, scale):
    """Launch the CUDA w8 kernel: x [M, K] f32/bf16, w_q [N, K] int8,
    scale [N] f32, all on one CUDA device -> [M, N] in x's type."""
    _check("weight_only_matmul_cuda", x, w_q, scale, (w_q, scale))
    if x.dtype not in _DTYPES:
        raise ValueError(f"weight_only_matmul_cuda takes f32 or bf16 x, got "
                         f"{x.dtype}")
    M, K = x.shape
    N = w_q.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    x, w_q, scale = _aligned(x), _aligned(w_q), _aligned(scale)
    lib = _lib()
    dtype = _DTYPES[x.dtype]
    # the kernel's scratch: f32 partial sums where it splits K
    n_ws = lib.weight_only_matmul_workspace(M, N, K, dtype)
    if n_ws < 0:
        raise RuntimeError("weight_only_matmul: the CUDA device query failed")
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device) \
        if n_ws else None
    _raise_on(lib.weight_only_matmul_fwd(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(), M, N,
        K, dtype, ws.data_ptr() if ws is not None else None,
        _build.stream_ptr(x.device)), lib, "weight_only_matmul")
    weight_only_matmul_cuda.launches += 1
    return out


weight_only_matmul_cuda.launches = 0


def w8a8_matmul_cuda(x_q, x_scale, w_q, scale, out_dtype):
    """Launch the CUDA w8a8 kernel: x_q [M, K] int8, x_scale [M, 1] f32,
    w_q [N, K] int8, scale [N] f32 -> [M, N] ``out_dtype`` (f32/bf16),
    bit-equal to ``w8a8_matmul_plain``.  The kernel is chosen by shape
    (M <= 16: mma.sync; above with K % 16 == 0: s8 wgmma, K split over
    blocks where the output tiles are few; else mma.sync tiles)."""
    _check("w8a8_matmul_cuda", x_q, w_q, scale, (x_scale, w_q, scale))
    M, K = x_q.shape
    if x_q.dtype != torch.int8 or x_scale.dtype != torch.float32 \
            or x_scale.numel() != M or out_dtype not in _DTYPES:
        raise ValueError(
            f"w8a8_matmul_cuda: int8 x_q, f32 x_scale [M, 1] and an f32/bf16 "
            f"output expected, got {x_q.dtype}, {x_scale.dtype} "
            f"{tuple(x_scale.shape)}, {out_dtype}")
    N = w_q.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    if M == 0 or N == 0:
        return out
    x_q, x_scale = _aligned(x_q), _aligned(x_scale)
    w_q, scale = _aligned(w_q), _aligned(scale)
    lib = _lib()
    # the kernel's scratch: s32 sums of each K split where it splits K
    n_ws = lib.w8a8_matmul_workspace(M, N, K)
    if n_ws < 0:
        raise RuntimeError("w8a8_matmul: the CUDA device query failed")
    ws = torch.empty(n_ws, dtype=torch.int32, device=x_q.device) \
        if n_ws else None
    _raise_on(lib.w8a8_matmul_fwd(
        x_q.data_ptr(), x_scale.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), M, N, K, _DTYPES[out_dtype],
        ws.data_ptr() if ws is not None else None,
        _build.stream_ptr(x_q.device)), lib, "w8a8_matmul")
    w8a8_matmul_cuda.launches += 1
    return out


w8a8_matmul_cuda.launches = 0


# ---------------------------------------------------------- entry points
def _wo_forward(x, w_q, scale):
    if x.device.type == "cpu":
        return weight_only_matmul_plain(x, w_q, scale)
    return weight_only_matmul_cuda(x, w_q, scale)


class _WeightOnlyMatmul(torch.autograd.Function):
    """The JAX package's ``weight_only_matmul`` custom_vjp: the backward
    is torch ops as ``_wo_bwd`` is XLA — dx = dy @ w_fp, dscale[n] =
    sum_m dy[m, n] * (x @ w_q.T)[m, n], no gradient for the int8 weight."""

    @staticmethod
    def forward(ctx, x, w_q, scale):
        ctx.save_for_backward(x, w_q, scale)
        return _wo_forward(x, w_q, scale)

    @staticmethod
    def backward(ctx, dy):
        x, w_q, scale = ctx.saved_tensors
        dyf = dy.float()
        w_fp = w_q.float() * scale.float()[:, None]
        dx = (dyf @ w_fp).to(x.dtype)
        acc = x.float() @ w_q.float().t()
        dscale = (dyf * acc).sum(dim=0).to(scale.dtype)
        return dx, None, dscale


def weight_only_matmul(x, w_q, scale):
    """y = x @ (w_q * scale[:, None]).T: x [M, K] float, w_q [N, K] int8,
    scale [N] f32 -> [M, N] in x's type.  Differentiable in x and scale
    when grad is enabled."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _WeightOnlyMatmul.apply(x, w_q, scale)
    return _wo_forward(x, w_q, scale)


def w8a8_matmul(x, w_q, scale):
    """y = dequant(quant(x) @ w_q.T): per-token dynamic activation
    quantization, then the s8 x s8 -> s32 product.  x [M, K] float;
    w_q [N, K] int8; scale [N] f32.  Returns [M, N] in x's type."""
    x_q, x_scale = dynamic_act_quant(x)
    if x.device.type == "cpu":
        return w8a8_matmul_plain(x_q, x_scale, w_q, scale, x.dtype)
    return w8a8_matmul_cuda(x_q, x_scale, w_q, scale, x.dtype)


def quant_forward(x, q):
    """x (..., K) through an armed int8 twin ``q = (mode, w_q, scale)``
    ([N, K] int8 and its per-out-channel scales): weight-only ("w8") or
    dynamic-per-token "w8a8".  Returns (..., N) in x's type."""
    mode, w_q, scale = q
    x2 = x.reshape(-1, x.shape[-1])
    if mode == "w8a8":
        out = w8a8_matmul(x2, w_q, scale)
    else:
        out = weight_only_matmul(x2, w_q, scale)
    return out.reshape(*x.shape[:-1], w_q.shape[0])


def quant_linear_forward(layer, x, q):
    """The quantized forward a ``Linear`` runs while a serving step has
    armed it with ``q`` (:func:`quant_forward`), plus its bias."""
    out = quant_forward(x, q)
    if layer.bias is not None:
        out = out + layer.bias
    return out
