"""RMSNorm and rotate-half RoPE: Triton kernels and their plain versions.

Port of paddle_tpu/ops/pallas/fused_norm_rope.py.  Each public function
takes its plain PyTorch version for a tensor on the CPU and launches its
Triton kernel for a tensor on the card; there is no fallback between the
two.  ``triton`` is imported inside the launchers, so this module imports
where Triton is not installed.

RMSNorm kernel (replaces ``_rms_kernel``, launched by
``rms_norm_pallas``): one program per row, one pass.  It reads each row
once and writes it once, so on the H100 it is bound by bytes; the design
keeps the whole row in registers (hidden 4096 is one block), accumulates
the mean square in f32 and writes the scaled row in the same pass.  It
rounds as ``rms_norm_xla`` does — the normalized row is cast to the input
type BEFORE the weight multiplies it — because the JAX serving step runs
that form (autotune under a trace defaults to XLA); the Pallas kernel
multiplies in f32 first and differs in the last bf16 bit.

RoPE kernel (replaces ``_rope_kernel``, launched by
``fused_rope_pallas``): one program per token rotates every q and k head
of it.  Bound by bytes (q and k read and written once, 6 operations per
element pair); the design gathers the token's cos/sin row once from a
per-row ``positions`` vector inside the kernel — which covers both the
shared-offset and the per-row-offset branches of ``llama.apply_rope`` —
and clamps the table index as JAX's gather does for pad positions.

Gradients (the JAX package's ``rms_norm_fused`` and ``fused_rope_fused``
custom_vjps): ``rms_norm`` and ``apply_rope`` become autograd Functions
when grad is enabled and an input requires it.  The RMSNorm backward is
``_rms_bwd`` in torch ops (the JAX one is XLA, not a kernel).  The RoPE
backward is the same Triton kernel run with a negated sin table — the
adjoint of a rotation by theta is the rotation by -theta — as
``_rope_bwd`` does; table cotangents are torch ops, computed only when
a table requires grad.
"""
import torch


# ----------------------------------------------------------------- rmsnorm
def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                   epsilon: float = 1e-6) -> torch.Tensor:
    """``rms_norm_xla``: f32 statistics, cast to x's type, then * weight."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out * weight if weight is not None else out


def rms_norm_triton(x: torch.Tensor, weight: torch.Tensor,
                    epsilon: float = 1e-6) -> torch.Tensor:
    """Launch the Triton RMSNorm kernel on CUDA tensors."""
    import triton
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError("rms_norm_triton needs x and weight on one CUDA "
                         "device")
    if weight.dtype != x.dtype or weight.shape != x.shape[-1:]:
        raise ValueError(
            f"weight must be ({x.shape[-1]},) {x.dtype}, got "
            f"{tuple(weight.shape)} {weight.dtype}")
    hidden = x.shape[-1]
    x2 = x.reshape(-1, hidden)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    out = torch.empty((x2.shape[0], hidden), dtype=x.dtype, device=x.device)
    if x2.shape[0]:
        block = triton.next_power_of_2(hidden)
        _rms_kernel()[(x2.shape[0],)](
            x2, weight.contiguous(), out, x2.stride(0), out.stride(0),
            hidden, float(epsilon), BLOCK=block,
            num_warps=min(16, max(1, block // 256)))
        rms_norm_triton.launches += 1
    return out.reshape(x.shape)


rms_norm_triton.launches = 0


def _rms_forward(x, weight, epsilon):
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, epsilon)
    return rms_norm_triton(x, weight, epsilon)


def rms_norm_backward(x, weight, g, epsilon):
    """``_rms_bwd`` of the JAX package: (dx in x's dtype, dw in w's dtype
    summed over every leading axis), f32 math."""
    xf, gf, wf = x.float(), g.float(), weight.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    gw = gf * wf
    dot = (gw * xf).sum(dim=-1, keepdim=True)
    dx = (r * gw - (r ** 3 / x.shape[-1]) * xf * dot).to(x.dtype)
    dw = (gf * xf * r).reshape(-1, x.shape[-1]).sum(0).to(weight.dtype)
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, epsilon):
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        return _rms_forward(x, weight, epsilon)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_backward(x, weight, g, ctx.epsilon)
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim: the Triton kernel on the card, the plain
    version on the CPU; differentiable (``_RMSNorm``) when autograd asks."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, epsilon)
    return _rms_forward(x, weight, epsilon)


# Triton kernels, defined at their first launch so that this module
# imports where Triton is absent
_kernels = {}


def _rms_kernel():
    kern = _kernels.get("rms")
    if kern is None:
        import triton
        import triton.language as tl
        globals()["tl"] = tl      # the jit compiler resolves module globals

        @triton.jit
        def kern(x_ptr, w_ptr, o_ptr, stride_x, stride_o, hidden, eps,
                 BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK)
            mask = cols < hidden
            x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                        other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=0) / hidden
            rstd = 1.0 / tl.sqrt(var + eps)
            y = (x * rstd).to(o_ptr.dtype.element_ty)
            w = tl.load(w_ptr + cols, mask=mask, other=0.0)
            out = y.to(tl.float32) * w.to(tl.float32)
            tl.store(o_ptr + row * stride_o + cols,
                     out.to(o_ptr.dtype.element_ty), mask=mask)

        _kernels["rms"] = kern
    return kern


# -------------------------------------------------------------------- rope
def apply_rope_plain(q: torch.Tensor, k: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor,
                     positions: torch.Tensor):
    """Rotate-half RoPE of q (b, s, h, d) and k (b, s, kvh, d) at
    per-row start ``positions`` (b,) over the full (max_pos, d/2) f32
    tables — the per-row branch of ``llama.apply_rope``; index past the
    table clamps like JAX's gather."""
    s = q.shape[1]
    idx = positions.to(torch.int64)[:, None] \
        + torch.arange(s, device=q.device)[None]
    idx = idx.clamp(0, cos.shape[0] - 1)
    c = cos[idx][:, :, None, :].float()
    si = sin[idx][:, :, None, :].float()

    def rot(x):
        half = x.shape[-1] // 2
        x1 = x[..., :half].float()
        x2 = x[..., half:].float()
        return torch.cat([x1 * c - x2 * si, x2 * c + x1 * si],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def apply_rope_triton(q: torch.Tensor, k: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor,
                      positions: torch.Tensor):
    """Launch the Triton RoPE kernel on CUDA tensors; returns new q, k."""
    import triton
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (k, cos, sin, positions)):
        raise ValueError(
            "apply_rope_triton needs every tensor on one CUDA device")
    b, s, h, d = q.shape
    kvh = k.shape[2]
    half = d // 2
    if k.shape != (b, s, kvh, d) or cos.shape[1] != half \
            or cos.dtype != torch.float32 or sin.shape != cos.shape:
        raise ValueError("apply_rope_triton: q (b,s,h,d), k (b,s,kvh,d), "
                         "cos/sin (max_pos, d/2) f32")
    q = q.contiguous()
    k = k.contiguous()
    oq = torch.empty_like(q)
    ok = torch.empty_like(k)
    if b * s:
        pos = positions.to(torch.int32).contiguous()
        _rope_kernel()[(b * s,)](
            q, k, oq, ok, cos.contiguous(), sin.contiguous(), pos, s, h,
            kvh, cos.shape[0], HALF=half,
            BHALF=triton.next_power_of_2(half),
            BH=triton.next_power_of_2(max(h, kvh)), num_warps=4)
        apply_rope_triton.launches += 1
    return oq, ok


apply_rope_triton.launches = 0


def _rope_forward(q, k, cos, sin, positions):
    if q.device.type == "cpu":
        return apply_rope_plain(q, k, cos, sin, positions)
    return apply_rope_triton(q, k, cos, sin, positions)


def rope_table_grads(q, k, gq, gk, positions, table_rows):
    """Cotangents of the (max_pos, d/2) cos and sin tables: with
    o1 = x1 c - x2 s and o2 = x2 c + x1 s, dc = sum g1 x1 + g2 x2 and
    ds = sum g2 x1 - g1 x2 over heads, added into each token's table
    row (clamped as the forward's gather is)."""
    s = q.shape[1]
    idx = (positions.to(torch.int64)[:, None]
           + torch.arange(s, device=q.device)[None]).clamp(0, table_rows - 1)
    dc = torch.zeros(table_rows, q.shape[-1] // 2, device=q.device)
    dsn = torch.zeros_like(dc)
    for x, gx in ((q, gq), (k, gk)):
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half].float(), x[..., half:].float()
        g1, g2 = gx[..., :half].float(), gx[..., half:].float()
        dc.index_add_(0, idx.reshape(-1),
                      (g1 * x1 + g2 * x2).sum(2).reshape(-1, half))
        dsn.index_add_(0, idx.reshape(-1),
                       (g2 * x1 - g1 * x2).sum(2).reshape(-1, half))
    return dc, dsn


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, cos, sin, positions, neg_sin):
        # q and k are needed only for table cotangents
        tables = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        ctx.save_for_backward(q if tables else None, k if tables else None,
                              cos, sin, positions, neg_sin)
        return _rope_forward(q, k, cos, sin, positions)

    @staticmethod
    def backward(ctx, gq, gk):
        q, k, cos, sin, positions, neg_sin = ctx.saved_tensors
        dq, dk = _rope_forward(gq, gk, cos, neg_sin, positions)
        dcos = dsin = None
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            dcos, dsin = rope_table_grads(q, k, gq, gk, positions,
                                          cos.shape[0])
            dcos, dsin = dcos.to(cos.dtype), dsin.to(sin.dtype)
        return dq, dk, dcos, dsin, None, None


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, positions: torch.Tensor,
               neg_sin: torch.Tensor):
    """Rotate-half RoPE at per-row start positions: the Triton kernel on
    the card, the plain version on the CPU.  Differentiable (``_Rope``)
    when autograd asks; its backward rotates by ``neg_sin`` (-sin, kept
    by the caller so a step allocates no table)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, cos, sin)):
        return _Rope.apply(q, k, cos, sin, positions, neg_sin)
    return _rope_forward(q, k, cos, sin, positions)


def _rope_kernel():
    kern = _kernels.get("rope")
    if kern is None:
        import triton
        import triton.language as tl
        globals()["tl"] = tl      # the jit compiler resolves module globals

        @triton.jit
        def kern(q_ptr, k_ptr, oq_ptr, ok_ptr, cos_ptr, sin_ptr, pos_ptr,
                 s_len, n_q_heads, n_k_heads, max_pos, HALF: tl.constexpr,
                 BHALF: tl.constexpr, BH: tl.constexpr):
            tok = tl.program_id(0).to(tl.int64)
            p = tl.load(pos_ptr + tok // s_len) + (tok % s_len)
            p = tl.minimum(tl.maximum(p, 0), max_pos - 1)
            cols = tl.arange(0, BHALF)
            c = tl.load(cos_ptr + p * HALF + cols, mask=cols < HALF,
                        other=0.0)[None, :]
            sn = tl.load(sin_ptr + p * HALF + cols, mask=cols < HALF,
                         other=0.0)[None, :]
            heads = tl.arange(0, BH)[:, None]
            # q heads
            mask = (heads < n_q_heads) & (cols[None, :] < HALF)
            at = tok * n_q_heads * 2 * HALF + heads * 2 * HALF + cols[None, :]
            x1 = tl.load(q_ptr + at, mask=mask, other=0.0).to(tl.float32)
            x2 = tl.load(q_ptr + at + HALF, mask=mask,
                         other=0.0).to(tl.float32)
            tl.store(oq_ptr + at, (x1 * c - x2 * sn).to(
                oq_ptr.dtype.element_ty), mask=mask)
            tl.store(oq_ptr + at + HALF, (x2 * c + x1 * sn).to(
                oq_ptr.dtype.element_ty), mask=mask)
            # k heads
            mask = (heads < n_k_heads) & (cols[None, :] < HALF)
            at = tok * n_k_heads * 2 * HALF + heads * 2 * HALF + cols[None, :]
            x1 = tl.load(k_ptr + at, mask=mask, other=0.0).to(tl.float32)
            x2 = tl.load(k_ptr + at + HALF, mask=mask,
                         other=0.0).to(tl.float32)
            tl.store(ok_ptr + at, (x1 * c - x2 * sn).to(
                ok_ptr.dtype.element_ty), mask=mask)
            tl.store(ok_ptr + at + HALF, (x2 * c + x1 * sn).to(
                ok_ptr.dtype.element_ty), mask=mask)

        _kernels["rope"] = kern
    return kern
