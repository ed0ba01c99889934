"""The port's hand-written kernels against their plain versions, on the
card.  These need a CUDA device (and nvcc and Triton there); elsewhere
they skip.  Run them on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda
"""
import re
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flashmask_attention as fm
from paddle_tpu_torch.ops import fused_norm_rope as nr
from paddle_tpu_torch.ops import moe_gating as mg
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda

DTYPES = {"f32": (torch.float32, 1e-4), "bf16": (torch.bfloat16, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, tol):
    # tol x max(1, max |want|): a few bf16 ulps of the largest value
    scale = max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


def _close_l2(got, want, tol):
    """``_close``, and the relative L2 difference ||got - want|| / ||want||
    within ``tol``: attention outputs lie far below 1, where a dropped or
    doubled context split would stay under the absolute limit."""
    _close(got, want, tol)
    diff = (got.float() - want.float()).norm()
    assert float(diff / want.float().norm().clamp_min(1e-30)) <= tol


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("causal,sq,sk,h,kvh,d", [
    (True, 200, 200, 4, 4, 128), (True, 70, 300, 4, 2, 64),
    (False, 129, 33, 2, 2, 128),
    # a speculative verify forward: k + 1 = 5 queries over cached keys
    (True, 5, 133, 32, 32, 128)])
def test_flash_forward_matches_plain(dev, dt, causal, sq, sk, h, kvh, d):
    dtype, tol = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, h, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(2, kvh, sk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(2, kvh, sk, d, generator=g, device=dev).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal)
    _close(out, ref, tol)
    _close(lse, ref_lse, 1e-4)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("qh,kvh,d", [(8, 8, 128), (8, 2, 64)])
def test_paged_ragged_matches_plain(dev, dt, qh, kvh, d):
    dtype, tol = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(1)
    spans = [1, 7, 16, 3]
    lens = torch.tensor([1, 40, 100, 3], dtype=torch.int32, device=dev)
    tables = torch.randperm(32, generator=g, device=dev)[:4 * 8] \
        .view(4, 8).to(torch.int32)
    kp = torch.randn(kvh, 32, 16, d, generator=g, device=dev).to(dtype)
    vp = torch.randn(kvh, 32, 16, d, generator=g, device=dev).to(dtype)
    q = torch.randn(4, 16, qh, d, generator=g, device=dev).to(dtype)
    ql = torch.tensor(spans, dtype=torch.int32, device=dev)
    out = pa.paged_attention_ragged(q, kp, vp, lens, ql, tables)
    ref = pa._ragged_plain(q, kp, vp, lens, ql, tables, d ** -0.5)
    real = (torch.arange(16, device=dev)[None] < ql[:, None])[..., None,
                                                               None]
    _close_l2(out * real, ref * real, tol)
    assert float((out.float() * ~real).abs().max()) == 0.0
    dec = pa.paged_attention(q[:, 0], kp, vp, lens, tables)
    _close_l2(dec, pa._decode_plain(q[:, 0], kp, vp, lens, tables,
                                    d ** -0.5), tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rms_norm_and_rope_match_plain(dev, dt):
    dtype, _ = DTYPES[dt]
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(3, 5, 4096, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).to(dtype)
    _close(nr.rms_norm(x, w, 1e-5), nr.rms_norm_plain(x, w, 1e-5), tol)
    from paddle_tpu_torch.models.llama import _rope_tables
    cos, sin = (t.to(dev) for t in _rope_tables(128, 64, 10000.0))
    q = torch.randn(3, 9, 8, 128, generator=g, device=dev).to(dtype)
    k = torch.randn(3, 9, 2, 128, generator=g, device=dev).to(dtype)
    pos = torch.tensor([0, 20, 60], dtype=torch.int32, device=dev)
    for got, want in zip(nr.apply_rope(q, k, cos, sin, pos, -sin),
                         nr.apply_rope_plain(q, k, cos, sin, pos)):
        _close(got, want, tol)


def _device_kernels(fn, want=()):
    """Names of the device kernels one call of ``fn`` runs (profiler).
    CUPTI now and then drops the kernel records of a window in which it
    asks for a new activity buffer, so a window that lacks a kernel whose
    name holds a string of ``want`` is opened again, after a pause that
    doubles each time, up to 6 windows (``chip_smoke.py``'s
    ``profiler_window``); the caller asserts on the last one."""
    for i in range(6):
        if i:
            time.sleep(0.05 * 2 ** i)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        if all(any(w in n for n in names) for w in want):
            break
    return names


def test_launch_counters_count_kernel_launches(dev):
    x = torch.randn(2, 4096, device=dev)
    before = nr.rms_norm_triton.launches
    nr.rms_norm(x, torch.ones(4096, device=dev))
    assert nr.rms_norm_triton.launches == before + 1
    np.testing.assert_array_equal(
        nr.rms_norm(x.cpu(), torch.ones(4096)).numpy(),
        nr.rms_norm_plain(x.cpu(), torch.ones(4096)).numpy())
    assert nr.rms_norm_triton.launches == before + 1


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("causal,sq,sk,h,kvh,d", [
    (True, 200, 200, 4, 4, 64), (True, 70, 300, 4, 2, 128),
    (False, 129, 33, 2, 1, 64), (True, 90, 40, 2, 2, 128)])
def test_flash_backward_matches_plain(dev, dt, causal, sq, sk, h, kvh, d):
    """dq, dk, dv of the dK/dV and dQ kernels against ``_bwd_blockwise``
    on the same card: GQA, sq < sk, sq > sk (fully masked rows) and
    lengths that are not a multiple of the 64-row tile."""
    dtype, _ = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(2, h, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(2, kvh, sk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(2, kvh, sk, d, generator=g, device=dev).to(dtype)
    do = torch.randn(2, h, sq, d, generator=g, device=dev).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    scale = d ** -0.5
    before = (fa.flash_attention_bwd_dkv_cuda.launches,
              fa.flash_attention_bwd_dq_cuda.launches)
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal, scale)
    assert (fa.flash_attention_bwd_dkv_cuda.launches,
            fa.flash_attention_bwd_dq_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    want = fa._bwd_blockwise(q, k, v, out, lse, do, causal, scale)
    # f32: summation order; bf16: the gradients' one rounding to bf16
    limit = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, b) <= limit


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_training_flash_rms_rope_grads_match_plain(dev, dt):
    """The autograd Functions on the card (forward and backward kernels,
    RoPE backward with -sin) against the same Functions on CPU copies
    (plain versions)."""
    dtype, _ = DTYPES[dt]
    from paddle_tpu_torch.models.llama import _rope_tables
    g = torch.Generator(device=dev).manual_seed(4)
    cos, sin = (t.to(dev) for t in _rope_tables(64, 256, 10000.0))
    q = torch.randn(2, 100, 4, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 100, 2, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 100, 2, 64, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(64, generator=g, device=dev)).to(dtype)
    gout = torch.randn(2, 100, 4, 64, generator=g, device=dev).to(dtype)
    pos = torch.zeros(2, dtype=torch.int32, device=dev)
    grads = []
    for where in (dev, torch.device("cpu")):
        leaves = [t.detach().to(where).clone().requires_grad_()
                  for t in (q, k, v, w)]
        tq, tk, tv, tw = leaves
        rq, rk = nr.apply_rope(tq, tk, cos.to(where), sin.to(where),
                               pos.to(where), neg_sin=-sin.to(where))
        out = fa.flash_attention_bshd(nr.rms_norm(rq, tw, 1e-5), rk, tv,
                                      causal=True)
        (out.float() * gout.to(where).float()).sum().backward()
        grads.append([t.grad.cpu() for t in leaves])
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(*grads):
        assert _rel_l2(a, b) <= limit


# the tensor-core (wgmma) kernels: bf16 forward, dK/dV and dQ.  (b, causal,
# sq, sk, q heads, kv heads, d): MHA and GQA 32/8 at head dims 64 and
# 128, sq < sk, sq > sk (rows that see no column), lengths that are not a
# multiple of the 64-row tiles, and decode (sq 1, the MoE generate step)
WGMMA_CASES = [(2, True, 200, 200, 4, 4, 64), (1, True, 256, 256, 32, 8, 128),
               (2, True, 70, 300, 4, 2, 128), (1, True, 300, 100, 8, 2, 64),
               (2, False, 129, 33, 2, 2, 128), (2, False, 77, 333, 32, 8, 64),
               (8, True, 1, 544, 32, 8, 128), (3, False, 1, 97, 4, 4, 64)]


def _wgmma_inputs(dev, b, sq, sk, h, kvh, d, seed, bshd):
    """bf16 q, k, v (b, h, s, d) and a dO; with ``bshd``, transposed views
    of (b, s, h, d) buffers, as the serving and training paths pass."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(heads, s):
        if bshd:
            return torch.randn(b, s, heads, d, generator=g, device=dev) \
                .bfloat16().transpose(1, 2)
        return torch.randn(b, heads, s, d, generator=g, device=dev).bfloat16()
    return rnd(h, sq), rnd(kvh, sk), rnd(kvh, sk), rnd(h, sq)


def _seen(sq, sk, causal, dev):
    """(sq,) bool: the rows that see at least one column."""
    rows = torch.arange(sq, device=dev)
    return rows + (sk - sq) >= 0 if causal else torch.ones_like(rows) > 0


@pytest.mark.parametrize("bshd", [False, True], ids=["bhsd", "bshd"])
@pytest.mark.parametrize("b,causal,sq,sk,h,kvh,d", WGMMA_CASES)
def test_flash_forward_wgmma_matches_plain(dev, bshd, b, causal, sq, sk, h,
                                           kvh, d):
    """The bf16 tensor-core forward against ``flash_attention_plain``
    (2e-2 of max |ref|, relative L2 2e-2, lse 1e-4).  A row that sees no
    column writes zeros and lse DEFAULT_MASK_VALUE (the plain version's
    softmax of an all-masked row is uniform instead)."""
    q, k, v, _ = _wgmma_inputs(dev, b, sq, sk, h, kvh, d, 10, bshd)
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal)
    seen = _seen(sq, sk, causal, dev)
    _close(out[:, :, seen], ref[:, :, seen], 2e-2)
    assert _rel_l2(out[:, :, seen], ref[:, :, seen]) <= 2e-2
    _close(lse[:, :, seen], ref_lse[:, :, seen], 1e-4)
    assert float(out[:, :, ~seen].float().abs().sum()) == 0.0
    assert bool((lse[:, :, ~seen] == fa.DEFAULT_MASK_VALUE).all())


@pytest.mark.parametrize("bshd", [False, True], ids=["bhsd", "bshd"])
@pytest.mark.parametrize("b,causal,sq,sk,h,kvh,d", WGMMA_CASES)
def test_flash_dkv_wgmma_matches_plain(dev, bshd, b, causal, sq, sk, h, kvh,
                                       d):
    """The bf16 tensor-core dK/dV (P and dS rounded to bf16 before their
    products) against ``_bwd_blockwise`` at the unchanged relative L2
    limit 1e-2; rows that see no column get zero gradients."""
    q, k, v, do = _wgmma_inputs(dev, b, sq, sk, h, kvh, d, 11, bshd)
    scale = d ** -0.5
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    got = fa.flash_attention_backward(q, k, v, out, lse, do, causal, scale)
    want = fa._bwd_blockwise(q, k, v, out, lse, do, causal, scale)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, w) <= 1e-2
    seen = _seen(sq, sk, causal, dev)
    assert float(got[0][:, :, ~seen].float().abs().sum()) == 0.0


@pytest.mark.parametrize("bshd", [False, True], ids=["bhsd", "bshd"])
@pytest.mark.parametrize("b,causal,sq,sk,h,kvh,d", WGMMA_CASES)
def test_flash_dq_wgmma_matches_plain(dev, bshd, b, causal, sq, sk, h, kvh,
                                      d):
    """The bf16 tensor-core dQ kernel alone (dS rounded to bf16 before
    dQ += dS K) against ``_bwd_blockwise``'s dq at relative L2 1e-2, one
    launch; rows that see no column get dQ exactly 0."""
    q, k, v, do = _wgmma_inputs(dev, b, sq, sk, h, kvh, d, 13, bshd)
    scale = d ** -0.5
    out, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    delta = (out.float() * do.float()).sum(-1).contiguous()
    dq = torch.full(q.shape, float("nan"), dtype=q.dtype, device=dev)
    dk, dv = (torch.empty(k.shape, dtype=k.dtype, device=dev)
              for _ in range(2))
    before = fa.flash_attention_bwd_dq_cuda.launches
    fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta, dq, dk, dv,
                                   causal, scale)
    assert fa.flash_attention_bwd_dq_cuda.launches == before + 1
    want = fa._bwd_blockwise(q, k, v, out, lse, do, causal, scale)[0]
    assert torch.isfinite(dq).all()
    assert _rel_l2(dq, want) <= 1e-2
    seen = _seen(sq, sk, causal, dev)
    assert float(dq[:, :, ~seen].float().abs().sum()) == 0.0


def test_bf16_flash_raises_without_its_kernel(dev, monkeypatch):
    """No fallback: a bf16 call whose kernel library does not build
    raises KernelBuildError, forward and backward."""
    from paddle_tpu_torch.ops import _build

    def broken(name):
        raise _build.KernelBuildError(f"nvcc failed on {name}.cu")

    q, k, v, do = _wgmma_inputs(dev, 1, 64, 64, 4, 4, 64, 12, False)
    out, lse = fa.flash_attention_forward(q, k, v, causal=True)
    monkeypatch.setattr(_build, "load", broken)
    with pytest.raises(_build.KernelBuildError):
        fa.flash_attention_forward(q, k, v, causal=True)
    with pytest.raises(_build.KernelBuildError):
        fa.flash_attention_backward(q, k, v, out, lse, do, True, 0.125)


QUANT_SHAPES = [(1, 4096, 4096), (8, 4096, 11008), (16, 512, 1024),
                (77, 300, 200), (130, 512, 384), (5, 33, 17), (40, 264, 136)]


def _quant_inputs(dev, m, k, n, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-4
    return x, w, s


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", QUANT_SHAPES)
def test_weight_only_matmul_matches_plain(dev, dt, m, k, n):
    """The w8 kernel (bf16: skinny at M <= 16, wgmma above, mma.sync
    tiles where K % 16 != 0; f32: tiled at every M) against its plain
    version: f32 sums in another order, or one bf16 rounding."""
    dtype, _ = DTYPES[dt]
    x, w, s = _quant_inputs(dev, m, k, n, dtype, 5)
    before = qm.weight_only_matmul_cuda.launches
    got = qm.weight_only_matmul(x, w, s)
    assert qm.weight_only_matmul_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    limit = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel_l2(got, qm.weight_only_matmul_plain(x, w, s)) <= limit


# bf16 w8 at M > 16 with K % 16 == 0: the wgmma kernel.  llama_7b's
# gate/up and down widths, a small one, and a narrow N that is not a
# multiple of the 128-feature tile
WO_WGMMA_MS = (17, 32, 64, 130, 1024)
WO_WGMMA_KN = ((4096, 11008), (11008, 4096), (512, 384), (4096, 200))


@pytest.mark.parametrize("m", WO_WGMMA_MS)
@pytest.mark.parametrize("k,n", WO_WGMMA_KN)
def test_weight_only_matmul_wgmma_matches_plain(dev, m, k, n):
    """The bf16 w8 wgmma kernel against its plain version: int8 -> bf16
    is exact, so only the f32 sum order and the one bf16 rounding of
    each output differ (relative L2 1e-2); one launch counted."""
    x, w, s = _quant_inputs(dev, m, k, n, torch.bfloat16, 14)
    before = qm.weight_only_matmul_cuda.launches
    got = qm.weight_only_matmul(x, w, s)
    assert qm.weight_only_matmul_cuda.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert torch.isfinite(got).all()
    assert _rel_l2(got, qm.weight_only_matmul_plain(x, w, s)) <= 1e-2


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", QUANT_SHAPES)
def test_w8a8_matmul_bit_equal_to_plain(dev, dt, m, k, n):
    """The s32 sum is exact and the epilogue multiplies in the plain
    version's order, so the kernel is bit-equal to it."""
    dtype, _ = DTYPES[dt]
    x, w, s = _quant_inputs(dev, m, k, n, dtype, 6)
    before = qm.w8a8_matmul_cuda.launches
    got = qm.w8a8_matmul(x, w, s)
    assert qm.w8a8_matmul_cuda.launches == before + 1
    xq, xs = qm.dynamic_act_quant_plain(x)
    assert torch.equal(got, qm.w8a8_matmul_plain(xq, xs, w, s, dtype))


# w8a8 at M > 16 with K % 16 == 0: the s8 wgmma kernel.  Its token tiles
# (32 for 17 and 32 rows, 64, 256 for 130 and 1024), K split where the
# output tiles are few (N 4096 at 17-64 rows, N 384 and 200), and N that
# is not a multiple of the 128-feature tile
W8A8_WGMMA_MS = (17, 32, 64, 130, 1024)
W8A8_WGMMA_KN = ((4096, 11008), (11008, 4096), (512, 384), (4096, 200))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("m", W8A8_WGMMA_MS)
@pytest.mark.parametrize("k,n", W8A8_WGMMA_KN)
def test_w8a8_wgmma_bit_equal_to_plain(dev, dt, m, k, n):
    """The s8 wgmma kernel's s32 sums are exact, split or not, and its
    epilogue multiplies in the plain version's order: bit-equal to
    ``w8a8_matmul_plain``, one launch counted."""
    dtype, _ = DTYPES[dt]
    x, w, s = _quant_inputs(dev, m, k, n, dtype, 15)
    xq, xs = qm.dynamic_act_quant(x)
    before = qm.w8a8_matmul_cuda.launches
    got = qm.w8a8_matmul_cuda(xq, xs, w, s, dtype)
    assert qm.w8a8_matmul_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, qm.w8a8_matmul_plain(xq, xs, w, s, dtype))


@pytest.mark.parametrize("m,k,kernel", [
    (17, 512, "w8a8_wgmma_kernel"), (1024, 4096, "w8a8_wgmma_kernel"),
    (16, 512, "w8a8_mma_skinny_kernel"), (40, 264, "w8a8_mma_tiled_kernel")])
def test_w8a8_kernel_chosen_by_shape(dev, m, k, kernel):
    """M <= 16 takes the skinny mma.sync kernel, M > 16 the wgmma kernel
    where K % 16 == 0 (TMA's 16-byte rows) and the mma.sync tiles
    otherwise, in bf16 and f32 alike."""
    for dtype in (torch.bfloat16, torch.float32):
        x, w, s = _quant_inputs(dev, m, k, 384, dtype, 16)
        xq, xs = qm.dynamic_act_quant(x)
        names = _device_kernels(
            lambda: qm.w8a8_matmul_cuda(xq, xs, w, s, dtype))
        assert any(kernel in n for n in names), names


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(8, 4096), (130, 300), (3, 5, 2, 128)])
def test_dynamic_act_quant_bit_equal_to_plain(dev, dt, shape):
    dtype, _ = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(9)
    x = (torch.randn(*shape, generator=g, device=dev) * 3).to(dtype)
    x[0] = 0                                  # a zero row
    before = qm.dynamic_act_quant_cuda.launches
    q, s = qm.dynamic_act_quant(x)
    assert qm.dynamic_act_quant_cuda.launches == before + 1
    pq, ps = qm.dynamic_act_quant_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)


# the rebuilt quantizer's shapes: llama_7b's decode and prefill
# activations, the K/V rows of a decode write and of a 1024-token
# prefill (b * s * kv heads rows of 128), and an odd f32 shape
ACT_QUANT_SHAPES = [((8, 4096), "bf16"), ((8, 11008), "bf16"),
                    ((1024, 4096), "bf16"), ((1024, 11008), "bf16"),
                    ((256, 128), "bf16"), ((32768, 128), "bf16"),
                    ((77, 300), "f32"), ((8, 4096), "f32"),
                    ((5, 1024), "bf16"), ((3, 8), "f32")]


@pytest.mark.parametrize("shape,dt", ACT_QUANT_SHAPES,
                         ids=[f"{'x'.join(map(str, s))}-{d}"
                              for s, d in ACT_QUANT_SHAPES])
def test_act_quant_kernels_bit_equal_to_plain(dev, shape, dt):
    """Each row-shape path of the quantizer against its plain version,
    bit for bit (IEEE division, round half to even), a zero row and a
    row of exact ties included; the kernel the plan names is the one
    that ran."""
    dtype, _ = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(10)
    x = (torch.randn(*shape, generator=g, device=dev) * 3).to(dtype)
    x[0] = 0
    if shape[0] > 2:
        x[1] = torch.arange(shape[1], device=dev).to(dtype) * 0.5 - 3.0
        # absmax 127, so the scale is exactly 1 and every x.5 a tie
        x[2] = ((torch.arange(shape[1], device=dev) % 509) * 0.5
                - 127.0).to(dtype)
    q, s = qm.dynamic_act_quant_cuda(x)
    pq, ps = qm.dynamic_act_quant_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    kernel, _grid, _threads, _param = qm.act_quant_plan(
        x.numel() // shape[-1], shape[-1], dtype, True, qm._sms(x.device))
    assert any(kernel in n for n in _device_kernels(
        lambda: qm.dynamic_act_quant_cuda(x)))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_act_quant_views_bit_equal_to_plain(dev, dt):
    """A misaligned view takes the scalar edge; the v slice of a fused
    q|k|v output (two strides over its rows) is read in place by the
    vector kernel; both bit-equal to the plain version."""
    dtype, _ = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(11)
    flat = (torch.randn(64 * 4096 + 1, generator=g, device=dev) * 3).to(
        dtype)
    x = flat[1:].view(64, 4096)                       # 2 or 4 bytes off
    assert x.data_ptr() % 16
    q, s = qm.dynamic_act_quant_cuda(x)
    pq, ps = qm.dynamic_act_quant_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert any("act_quant_edge_kernel" in n for n in _device_kernels(
        lambda: qm.dynamic_act_quant_cuda(x)))
    qkv = (torch.randn(2, 9, (8 + 2 * 2) * 128, generator=g, device=dev)
           * 3).to(dtype)
    v = qkv[..., 10 * 128:].view(2 * 9, 2, 128)
    assert not v.is_contiguous()
    q, s = qm.dynamic_act_quant_cuda(v)
    pq, ps = qm.dynamic_act_quant_plain(v.contiguous())
    assert torch.equal(q, pq) and torch.equal(s, ps)
    names = _device_kernels(lambda: qm.dynamic_act_quant_cuda(v))
    assert any("act_quant_group_kernel" in n for n in names), names


@pytest.mark.parametrize("m", [8, 1024])
@pytest.mark.parametrize("widths", [(4096, 4096, 4096), (4096, 1024, 1024),
                                    (11008, 11008)],
                         ids=["qkv-mha", "qkv-gqa", "gate-up"])
def test_w8a8_fused_call_equals_separate_calls(dev, m, widths):
    """One w8a8 call on the concatenated twins is torch.equal to the
    separate calls: the same codes, exact s32 sums, a per-element
    epilogue whatever the tiles or K splits of the wider N."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(m, 4096, generator=g, device=dev).bfloat16()
    ws = [torch.randint(-127, 128, (n, 4096), generator=g, device=dev,
                        dtype=torch.int8) for n in widths]
    ss = [torch.rand(n, generator=g, device=dev) * 1e-3 + 1e-4
          for n in widths]
    fused = qm.w8a8_matmul(x, torch.cat(ws), torch.cat(ss))
    for got, w, s in zip(fused.split(list(widths), dim=-1), ws, ss):
        assert torch.equal(got, qm.w8a8_matmul(x, w, s))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_w8a8_fused_twins_bit_equal_to_per_linear(dev, dt, monkeypatch):
    """A small GQA LLaMA served in w8a8 with int8 KV: prefill logits and
    greedy streams with the fused q|k|v and gate|up twins equal the
    per-Linear path's bit for bit, and the quantizer runs 4 * layers + 1
    + 2 * layers times a forward."""
    from paddle_tpu_torch.inference import paged
    from paddle_tpu_torch.inference.continuous import \
        ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import serving
    dtype, _ = DTYPES[dt]
    cfg = LlamaConfig(vocab_size=256, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, device=dev, dtype=dtype, seed=3)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 256, (1, 32)).astype(np.int32)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 17, 40)]
    real = serving.quantize_linear_weights
    outs = []
    for fuse in (True, False):
        if not fuse:
            monkeypatch.setattr(paged, "quantize_linear_weights",
                                lambda m, fuse=False: real(m, fuse=False))
        cache = pa.PagedKVCache.from_model(model, total_pages=16,
                                           page_size=16, kv_dtype="int8")
        dec = paged.PagedDecoder(model, quantize="w8a8")
        before = qm.dynamic_act_quant_cuda.launches
        with torch.no_grad():
            logits = dec.prefill(cache, [0], ids)
        quantized = qm.dynamic_act_quant_cuda.launches - before
        with ContinuousBatchingEngine(model, total_pages=64, page_size=16,
                                      max_batch=4, quantize="w8a8",
                                      kv_quant="int8", device=dev) as eng:
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            streams = [r.result(timeout=120).tolist() for r in reqs]
        outs.append((logits, streams, quantized))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    assert outs[0][2] == 4 * 2 + 1 + 2 * 2
    assert outs[1][2] == 7 * 2 + 1 + 2 * 2


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("qh,kvh,d", [(8, 8, 128), (8, 2, 64)])
def test_paged_ragged_int8_matches_plain(dev, dt, qh, kvh, d):
    """int8 pages with per-slot scales, dequantized in the kernel through
    the compute type, against the plain gather-and-dequantize version."""
    dtype, tol = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(7)
    spans = [1, 7, 16, 3]
    lens = torch.tensor([1, 40, 100, 3], dtype=torch.int32, device=dev)
    tables = torch.randperm(32, generator=g, device=dev)[:4 * 8] \
        .view(4, 8).to(torch.int32)
    kp, ks = pa.quantize_kv(torch.randn(kvh, 32, 16, d, generator=g,
                                        device=dev))
    vp, vs = pa.quantize_kv(torch.randn(kvh, 32, 16, d, generator=g,
                                        device=dev))
    q = torch.randn(4, 16, qh, d, generator=g, device=dev).to(dtype)
    ql = torch.tensor(spans, dtype=torch.int32, device=dev)
    sc = dict(k_scales=ks, v_scales=vs)
    out = pa.paged_attention_ragged(q, kp, vp, lens, ql, tables, **sc)
    ref = pa._ragged_plain(q, kp, vp, lens, ql, tables, d ** -0.5, **sc)
    real = (torch.arange(16, device=dev)[None] < ql[:, None])[..., None,
                                                               None]
    _close(out * real, ref * real, tol)
    assert float((out.float() * ~real).abs().max()) == 0.0
    dec = pa.paged_attention(q[:, 0], kp, vp, lens, tables, **sc)
    _close(dec, pa._decode_plain(q[:, 0], kp, vp, lens, tables, d ** -0.5,
                                 **sc), tol)


def test_quantized_path_raises_without_its_kernel(dev, monkeypatch):
    """No fallback: a kernel library that does not build surfaces as
    KernelBuildError on the quantized path."""
    from paddle_tpu_torch.ops import _build

    def broken(name):
        raise _build.KernelBuildError(f"nvcc failed on {name}.cu")

    monkeypatch.setattr(_build, "load", broken)
    x, w, s = _quant_inputs(dev, 8, 64, 32, torch.bfloat16, 8)
    for mode in ("w8", "w8a8"):
        with pytest.raises(_build.KernelBuildError):
            qm.quant_linear_forward(
                type("L", (), {"bias": None})(), x, (mode, w, s))


# (T, E, k, capacity): decode and prefill of the Mixtral-width path, a
# tight capacity that drops most assignments, top-1 and top-3
GATING_CASES = [(8, 8, 2, 5), (4096, 8, 2, 2458), (4096, 8, 2, 300),
                (37, 4, 1, 3), (1000, 32, 3, 40), (300, 64, 2, 12)]


@pytest.mark.parametrize("T,E,k,cap", GATING_CASES,
                         ids=[f"T{c[0]}-E{c[1]}-k{c[2]}-C{c[3]}"
                              for c in GATING_CASES])
def test_topk_gating_matches_plain(dev, T, E, k, cap):
    """Routing identical (the kernel's softmax sums in the order of
    torch's warp softmax; random logits have no gates an ulp apart), w
    within 1e-6 relative, l_aux within 1e-5, fill = the top-1 counts."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(T, E, generator=g, device=dev) * 2
    eidx, pos, keep, w, fill, gsum = mg.topk_gating_cuda(x, k, cap)
    got = mg._route(x, k, cap, True)
    want = mg.topk_gating_plain(x, k, cap, True)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(eidx, got[0]) and torch.equal(keep.bool(), got[2])
    assert torch.equal(fill.long(), torch.bincount(want[0][0].long(),
                                                   minlength=E))
    assert float((got[3] - want[3]).abs().max()) <= 1e-6
    assert abs(float(got[4]) - float(want[4])) <= 1e-5 * float(want[4])
    if cap < T * k // E:
        assert not bool(keep.all())          # the tight case drops


def test_topk_gating_underflowed_gates_match_plain(dev):
    """Gates that underflow to 0: the kernel masks a chosen gate by
    multiplying it by 0, so later rounds pick the first expert again
    (with ties to the first index), as the plain routing does."""
    x = torch.zeros(64, 8, device=dev)
    x[:, 2] = 200.0
    x[1::2, 5] = 200.0
    got = mg._route(x, 3, 64, True)
    want = mg.topk_gating_plain(x, 3, 64, True)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert got[0][:, 0].tolist() == [2, 0, 0]
    assert got[0][:, 1].tolist() == [2, 5, 0]


def test_topk_gating_grad_matches_plain_autograd(dev):
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(512, 8, generator=g, device=dev)
    cw = torch.randn(2, 512, generator=g, device=dev)
    grads = []
    for fn in (mg.topk_gating, mg.topk_gating_plain):
        lg = x.clone().requires_grad_()
        _, _, _, w, l_aux = fn(lg, 2, 100, True)
        ((w * cw).sum() + 3.0 * l_aux).backward()
        grads.append(lg.grad)
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5


def test_topk_gating_launch_counter(dev):
    x = torch.randn(16, 8, device=dev)
    before = mg.topk_gating_cuda.launches
    mg.topk_gating(x, 2, 4, True)
    assert mg.topk_gating_cuda.launches == before + 1
    mg.topk_gating(x.cpu(), 2, 4, True)
    assert mg.topk_gating_cuda.launches == before + 1


def _fm_intervals(kind, b, hm, sq, sk, seed):
    """(b, hm, sk, ncol) int32 FlashMask intervals of one kind."""
    g = torch.Generator().manual_seed(seed)
    j = torch.arange(sk).expand(b, hm, sk)
    if kind == "1col":       # documents: column j masks rows from j + r
        cols = [(j + torch.randint(1, 96, (b, hm, sk), generator=g))
                .clamp(max=sq)]
    elif kind == "2col":     # random bands [start, end)
        start = torch.randint(0, sq, (b, hm, sk), generator=g)
        cols = [start, start + (torch.rand(b, hm, sk, generator=g)
                                * (sq - start + 1)).long()]
    elif kind == "4col":     # rows [j - 70, j + 20) see column j
        cols = [(j + 20).clamp(max=sq), torch.full_like(j, sq),
                torch.zeros_like(j), (j - 70).clamp(min=0)]
    else:                    # rows [40, 90) masked by every column
        cols = [torch.full_like(j, 40), torch.full_like(j, 90)]
    return torch.stack(cols, -1).to(torch.int32)


# (kind, causal, b, h, kvh, hm, sq, sk, d): GQA, mask heads, sq != sk,
# lengths off the 64-row tile, and rows that every column masks
FLASHMASK_CASES = [
    ("1col", True, 2, 4, 4, 1, 200, 200, 64),
    ("2col", True, 1, 4, 2, 2, 130, 300, 128),
    ("4col", False, 2, 4, 1, 4, 257, 190, 64),
    ("masked_rows", False, 1, 2, 2, 1, 150, 150, 128),
]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("kind,causal,b,h,kvh,hm,sq,sk,d", FLASHMASK_CASES)
def test_flashmask_kernels_match_plain(dev, dt, kind, causal, b, h, kvh, hm,
                                       sq, sk, d):
    """The FlashMask forward, dK/dV and dQ kernels against their plain
    versions on the card, one launch each; fully masked rows give out 0,
    lse DEFAULT_MASK_VALUE and dq 0 exactly."""
    dtype, tol = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, kvh, sk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, kvh, sk, d, generator=g, device=dev).to(dtype)
    do = torch.randn(b, h, sq, d, generator=g, device=dev).to(dtype)
    se = _fm_intervals(kind, b, hm, sq, sk, 10).to(dev)
    launches = (fm.flashmask_fwd_cuda.launches,
                fm.flashmask_bwd_dkv_cuda.launches,
                fm.flashmask_bwd_dq_cuda.launches)
    out, lse = fm.flashmask_attention_forward(q, k, v, se, causal)
    got = fm.flashmask_attention_backward(q, k, v, out, lse, do, se, causal)
    assert (fm.flashmask_fwd_cuda.launches,
            fm.flashmask_bwd_dkv_cuda.launches,
            fm.flashmask_bwd_dq_cuda.launches) == tuple(n + 1
                                                        for n in launches)
    ref, ref_lse = fm.flashmask_attention_plain(q, k, v, se, causal)
    _close(out, ref, tol)
    _close(lse, ref_lse, 1e-4)
    want = fm.flashmask_attention_backward_plain(q, k, v, out, lse, do, se,
                                                 causal)
    limit = 1e-4 if dtype == torch.float32 else 1e-2
    for a, r in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, r) <= limit
    if kind == "masked_rows":
        assert float(out[:, :, 40:90].float().abs().max()) == 0.0
        assert bool((lse[:, :, 40:90] == fa.DEFAULT_MASK_VALUE).all())
        assert float(got[0][:, :, 40:90].float().abs().max()) == 0.0


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flashmask_functional_grads_match_cpu(dev, dt):
    """``F.flashmask_attention`` under autograd on the card (the three
    kernels through (b, s, h, d) strides) against the same call on CPU
    copies (the plain versions)."""
    from paddle_tpu_torch.nn import functional as TF
    dtype, tol = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(2, 190, 8, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 190, 2, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 190, 2, 64, generator=g, device=dev).to(dtype)
    gout = torch.randn(2, 190, 8, 64, generator=g, device=dev).to(dtype)
    se = _fm_intervals("1col", 2, 1, 190, 190, 12)
    outs, grads = [], []
    for where in (dev, torch.device("cpu")):
        leaves = [t.detach().to(where).clone().requires_grad_()
                  for t in (q, k, v)]
        out = TF.flashmask_attention(*leaves, se.to(where), causal=True)
        (out.float() * gout.to(where).float()).sum().backward()
        outs.append(out.detach().cpu())
        grads.append([t.grad.cpu() for t in leaves])
    _close(outs[0], outs[1], tol)
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip(*grads):
        assert _rel_l2(a, b) <= limit


# bf16 FlashMask dK/dV: the tensor-core kernel.  (kind, causal, b, h, kvh,
# hm, sq, sk, d, bshd): every FLASHMASK_CASES case, one on transposed views
# of (b, s, h, d) buffers, and 2 mask heads under GQA 8/2 with sq != sk
FLASHMASK_DKV_CASES = [c + (False,) for c in FLASHMASK_CASES] + [
    ("1col", True, 2, 8, 2, 1, 190, 190, 64, True),
    ("2col", True, 1, 8, 2, 2, 300, 260, 128, False)]


def _nan_buffer(dev, b, heads, s, d, bshd):
    """A NaN-filled bf16 (b, heads, s, d) output buffer; with ``bshd``, a
    transposed view of a (b, s, heads, d) one."""
    if bshd:
        return torch.full((b, s, heads, d), float("nan"), device=dev) \
            .bfloat16().transpose(1, 2)
    return torch.full((b, heads, s, d), float("nan"), device=dev).bfloat16()


def _fm_seen(se, h, sq, causal):
    """(b, h, sq) bool: the rows that keep at least one column."""
    rows = torch.arange(sq, device=se.device)[:, None]
    cols = torch.arange(se.shape[2], device=se.device)[None, :]
    keep = fm._keep(se, rows, cols, se.shape[-1], causal)
    return keep.any(-1).repeat_interleave(h // se.shape[1], 1)


@pytest.mark.parametrize("kind,causal,b,h,kvh,hm,sq,sk,d,bshd",
                         FLASHMASK_DKV_CASES)
def test_flashmask_fwd_wgmma_matches_plain(dev, kind, causal, b, h, kvh, hm,
                                           sq, sk, d, bshd):
    """The bf16 FlashMask forward kernel alone (P rounded to bf16 before it
    meets V, as the JAX kernel casts it) against the plain forward, one
    launch into a NaN-filled buffer: out within 2e-2 of max(1, max |ref|)
    and relative L2 2e-2, lse within 1e-4 on the rows that keep a column;
    rows that every column masks give out 0 and lse DEFAULT_MASK_VALUE
    exactly."""
    q, k, v, _ = _wgmma_inputs(dev, b, sq, sk, h, kvh, d, 19, bshd)
    se = _fm_intervals(kind, b, hm, sq, sk, 10).to(dev)
    out = _nan_buffer(dev, b, h, sq, d, bshd)
    before = fm.flashmask_fwd_cuda.launches
    _, lse = fm.flashmask_fwd_cuda(q, k, v, se, causal, out=out)
    assert fm.flashmask_fwd_cuda.launches == before + 1
    ref, ref_lse = fm.flashmask_attention_plain(q, k, v, se, causal)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _close(out, ref, 2e-2)
    assert _rel_l2(out, ref) <= 2e-2
    seen = _fm_seen(se, h, sq, causal)
    _close(lse[seen], ref_lse[seen], 1e-4)
    if not seen.all():
        assert float(out[~seen].float().abs().max()) == 0.0
        assert bool((lse[~seen] == fa.DEFAULT_MASK_VALUE).all())


@pytest.mark.parametrize("kind,causal,b,h,kvh,hm,sq,sk,d,bshd",
                         FLASHMASK_DKV_CASES)
def test_flashmask_dq_wgmma_matches_plain(dev, kind, causal, b, h, kvh, hm,
                                          sq, sk, d, bshd):
    """The bf16 FlashMask dQ kernel alone (dS rounded to bf16 before
    dQ += dS K) against the plain backward's dq at relative L2 1e-2, one
    launch into a NaN-filled buffer: finite, and exactly 0 on the rows
    that every column masks."""
    q, k, v, do = _wgmma_inputs(dev, b, sq, sk, h, kvh, d, 20, bshd)
    se = _fm_intervals(kind, b, hm, sq, sk, 10).to(dev)
    out, lse = fm.flashmask_attention_forward(q, k, v, se, causal)
    delta = (out.float() * do.float()).sum(-1).contiguous()
    dq = _nan_buffer(dev, b, h, sq, d, bshd)
    before = fm.flashmask_bwd_dq_cuda.launches
    fm.flashmask_bwd_dq_cuda(q, k, v, do, lse, delta, se, dq, causal)
    assert fm.flashmask_bwd_dq_cuda.launches == before + 1
    want = fm.flashmask_attention_backward_plain(q, k, v, out, lse, do, se,
                                                 causal)[0]
    assert torch.isfinite(dq).all()
    assert _rel_l2(dq, want) <= 1e-2
    seen = _fm_seen(se, h, sq, causal)
    if not seen.all():
        assert float(dq[~seen].float().abs().max()) == 0.0


@pytest.mark.parametrize("kind,causal,b,h,kvh,hm,sq,sk,d,bshd",
                         FLASHMASK_DKV_CASES)
def test_flashmask_dkv_wgmma_matches_plain(dev, kind, causal, b, h, kvh, hm,
                                           sq, sk, d, bshd):
    """The bf16 FlashMask dK/dV kernel alone (P^T and dS^T rounded to bf16
    before their products) against the plain backward's dk and dv at
    relative L2 1e-2, one launch; finite where rows are fully masked."""
    q, k, v, do = _wgmma_inputs(dev, b, sq, sk, h, kvh, d, 16, bshd)
    se = _fm_intervals(kind, b, hm, sq, sk, 10).to(dev)
    out, lse = fm.flashmask_attention_forward(q, k, v, se, causal)
    delta = (out.float() * do.float()).sum(-1).contiguous()
    dk, dv = (_nan_buffer(dev, b, kvh, sk, d, bshd) for _ in range(2))
    before = fm.flashmask_bwd_dkv_cuda.launches
    fm.flashmask_bwd_dkv_cuda(q, k, v, do, lse, delta, se, dk, dv, causal)
    assert fm.flashmask_bwd_dkv_cuda.launches == before + 1
    want = fm.flashmask_attention_backward_plain(q, k, v, out, lse, do, se,
                                                 causal)
    for got, ref in zip((dk, dv), want[1:]):
        assert torch.isfinite(got).all()
        assert _rel_l2(got, ref) <= 1e-2


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flashmask_dkv_kernel_chosen_by_dtype(dev, dt):
    """A bf16 forward + backward runs exactly the three tensor-core
    FlashMask kernels, an f32 one exactly the three CUDA-core kernels;
    each launched once."""
    dtype, _ = DTYPES[dt]
    g = torch.Generator(device=dev).manual_seed(17)
    q, k, v, do = (torch.randn(1, 4, 200, 64, generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    se = _fm_intervals("1col", 1, 1, 200, 200, 10).to(dev)
    wrappers = (fm.flashmask_fwd_cuda, fm.flashmask_bwd_dkv_cuda,
                fm.flashmask_bwd_dq_cuda)

    def fwd_bwd():
        out, lse = fm.flashmask_attention_forward(q, k, v, se, True)
        fm.flashmask_attention_backward(q, k, v, out, lse, do, se, True)
    fwd_bwd()       # the shapes' first call stays out of the window
    kinds = ("fwd", "bwd_dkv", "bwd_dq")
    want = {f"flashmask_{x}_wgmma_kernel" if dt == "bf16"
            else f"flashmask_{x}_kernel" for x in kinds}
    counts = []

    def counted():
        before = [w.launches for w in wrappers]
        fwd_bwd()
        counts.append([w.launches - n for w, n in zip(wrappers, before)])

    # every window's call launches each wrapper once; the last window's
    # kernels are exactly the three of the dtype
    names = _device_kernels(counted, want=want)
    assert counts and all(c == [1, 1, 1] for c in counts)
    ran = {m.group(1) for n in names
           for m in [re.search(r"(flashmask_\w+_kernel)", n)] if m}
    assert ran == want


def test_flashmask_raises_without_its_kernel(dev, monkeypatch):
    """No fallback: with the kernel library unbuildable,
    ``F.flashmask_attention`` raises KernelBuildError on the card, forward
    and backward."""
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.ops import _build

    def broken(name):
        raise _build.KernelBuildError(f"nvcc failed on {name}.cu")

    g = torch.Generator(device=dev).manual_seed(18)
    q, k, v = (torch.randn(1, 128, 4, 64, generator=g, device=dev)
               .bfloat16().requires_grad_() for _ in range(3))
    se = _fm_intervals("1col", 1, 1, 128, 128, 10).to(dev)
    out = TF.flashmask_attention(q, k, v, se, causal=True)
    monkeypatch.setattr(_build, "load", broken)
    with pytest.raises(_build.KernelBuildError):
        TF.flashmask_attention(q, k, v, se, causal=True)
    with pytest.raises(_build.KernelBuildError):
        out.backward(torch.ones_like(out))


# ---------------------------------------------- paged attention, split-KV
def _paged_inputs(dev, dtype, qh, kvh, d, spans, ctxs, int8, seed,
                  width=None, page=16):
    """One ragged call: row i holds ``spans[i]`` queries after
    ``ctxs[i]`` cached tokens, its pages drawn at random from one pool;
    ``width`` pads the tables past the longest row."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = np.asarray(ctxs) + np.asarray(spans)
    need = [-(-int(n) // page) for n in lens]
    total = sum(need) + 1
    width = width or max(need)
    perm = rng.permutation(total)
    tables = np.zeros((len(spans), width), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    kp = torch.randn(kvh, total, page, d, generator=g, device=dev)
    vp = torch.randn(kvh, total, page, d, generator=g, device=dev)
    sc = {}
    if int8:
        kp, ks = pa.quantize_kv(kp)
        vp, vs = pa.quantize_kv(vp)
        sc = dict(k_scales=ks, v_scales=vs)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    q = torch.randn(len(spans), max(spans), qh, d, generator=g,
                    device=dev).to(dtype)
    meta = [torch.as_tensor(x, dtype=torch.int32, device=dev)
            for x in (lens, spans)] + [torch.as_tensor(tables, device=dev)]
    return (q, kp, vp, *meta), sc


# (label, q heads, kv heads, head dim, spans, contexts, table width):
# a long b1 decode (16 splits), contexts one below, at and one above
# split edges, splits mostly past every row, a 256-token chunk row among
# decode rows (the tensor-core kernel), GQA 32/8 and 8/2 at d64
PAGED_SPLIT_CASES = [
    ("b1_ctx4000", 32, 32, 128, [1], [3999], None),
    ("split_edges", 32, 32, 128, [1] * 6, [254, 255, 256, 510, 511, 512],
     None),
    ("mostly_empty", 32, 32, 128, [1] * 4, [5, 40, 90, 3], 256),
    ("chunk_mix", 32, 32, 128, [256, 1, 1, 1], [700, 300, 1000, 30], None),
    ("gqa32_8", 32, 8, 128, [1, 5, 17, 1], [600, 255, 1000, 0], None),
    ("gqa8_2_d64", 8, 2, 64, [3, 1, 9, 2], [500, 256, 40, 1023], None),
]


@pytest.mark.parametrize("int8", [False, True], ids=["pages", "int8"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("label,qh,kvh,d,spans,ctxs,width",
                         PAGED_SPLIT_CASES,
                         ids=[c[0] for c in PAGED_SPLIT_CASES])
def test_paged_split_matches_plain(dev, dt, int8, label, qh, kvh, d, spans,
                                   ctxs, width):
    """The split-KV kernels against ``_ragged_plain`` and the split twin
    ``_split_plain`` (at the call's planned split) at real positions
    (bf16 2e-2, f32 1e-4: the largest difference times max(1, max |ref|)
    and the relative L2 difference); pad positions exactly 0; two calls
    bit-identical."""
    dtype, tol = DTYPES[dt]
    args, sc = _paged_inputs(dev, dtype, qh, kvh, d, spans, ctxs, int8,
                             seed=len(label), width=width)
    q, ql = args[0], args[4]
    real = (torch.arange(q.shape[1], device=dev)[None]
            < ql[:, None])[..., None, None]
    out = pa.paged_attention_cuda(*args, **sc)
    assert torch.equal(out, pa.paged_attention_cuda(*args, **sc))
    assert float((out.float() * ~real).abs().max()) == 0.0
    _close_l2(out * real, pa._ragged_plain(*args, d ** -0.5, **sc) * real,
              tol)
    split, _n = pa.plan_splits(
        q.shape[0], q.shape[1], qh, kvh, d, args[5].shape[1], 16,
        pa.block_rows(dtype, q.shape[1] * (qh // kvh)),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    twin = pa._split_plain(*args, d ** -0.5, split, **sc)
    _close_l2(out * real, twin * real, tol)


@pytest.mark.parametrize("int8", [False, True], ids=["pages", "int8"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_paged_routing_contracts_bit_exact(dev, dt, int8):
    """On the card, a full-span ragged row equals verify bit for bit (one
    kernel, one plan), and a ``max_q == 1`` ragged call equals decode."""
    dtype, _ = DTYPES[dt]
    args, sc = _paged_inputs(dev, dtype, 32, 8, 128, [5] * 4,
                             [100, 700, 1500, 3], int8, seed=21)
    q, kp, vp, lens, _ql, tabs = args
    full = torch.full_like(lens, 5)
    ragged = pa.paged_attention_ragged(q, kp, vp, lens, full, tabs, **sc)
    verify = pa.paged_attention_multi(q, kp, vp, lens, tabs, **sc)
    assert torch.equal(ragged, verify)
    # a full row beside shorter ones: its outputs do not move
    mixed = torch.tensor([5, 1, 3, 5], dtype=torch.int32, device=dev)
    part = pa.paged_attention_ragged(q, kp, vp, lens, mixed, tabs, **sc)
    assert torch.equal(part[[0, 3]], verify[[0, 3]])
    ones = torch.ones_like(lens)
    ragged1 = pa.paged_attention_ragged(q[:, :1], kp, vp, lens, ones, tabs,
                                        **sc)
    decode = pa.paged_attention(q[:, 0], kp, vp, lens, tabs, **sc)
    assert torch.equal(ragged1[:, 0], decode)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_paged_kernels_chosen_by_dtype_and_rows(dev, dt):
    """A bf16 call with multi-row blocks runs the tensor-core kernel, an
    f32 one the CUDA-core kernel; a decode call the CUDA-core kernel;
    split calls add the combine kernel; one counted launch a call."""
    dtype, _ = DTYPES[dt]
    multi, _ = _paged_inputs(dev, dtype, 32, 32, 128, [64, 1, 1, 1],
                             [300, 100, 900, 20], False, seed=5)
    single, _ = _paged_inputs(dev, dtype, 32, 32, 128, [1] * 2, [3000, 9],
                              False, seed=6)

    def names(args):
        pa.paged_attention_cuda(*args)     # first call outside the window
        before = pa.paged_attention_cuda.launches
        ran = _device_kernels(lambda: pa.paged_attention_cuda(*args))
        assert pa.paged_attention_cuda.launches == before + 1
        return {m.group(1) for n in ran
                for m in [re.search(r"(paged_attention_\w+_kernel)", n)] if m}

    want_multi = ("paged_attention_mma_kernel" if dt == "bf16"
                  else "paged_attention_decode_kernel")
    got = names(multi)
    assert want_multi in got
    assert ("paged_attention_mma_kernel" in got) == (dt == "bf16")
    got = names(single)
    assert got == {"paged_attention_decode_kernel",
                   "paged_attention_combine_kernel"}


def test_paged_attention_captures_in_a_cuda_graph(dev):
    """The wrapper reads nothing back to the host: a call captures in a
    CUDA graph, and the replay equals the eager call."""
    args, _ = _paged_inputs(dev, torch.bfloat16, 32, 32, 128, [1] * 8,
                            [1000, 30, 511, 256, 2000, 7, 64, 900], False,
                            seed=9)
    eager = pa.paged_attention_cuda(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention_cuda(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_paged_attention_raises_without_its_kernel(dev, monkeypatch):
    """No fallback: with the kernel library unbuildable, decode, verify
    and ragged calls on the card raise KernelBuildError."""
    from paddle_tpu_torch.ops import _build

    def broken(name):
        raise _build.KernelBuildError(f"nvcc failed on {name}.cu")

    monkeypatch.setattr(_build, "load", broken)
    args, _ = _paged_inputs(dev, torch.bfloat16, 8, 2, 64, [3, 1], [40, 9],
                            False, seed=4)
    q, kp, vp, lens, ql, tabs = args
    for call in (lambda: pa.paged_attention(q[:, 0], kp, vp, lens, tabs),
                 lambda: pa.paged_attention_multi(q, kp, vp, lens, tabs),
                 lambda: pa.paged_attention_ragged(*args)):
        with pytest.raises(_build.KernelBuildError):
            call()


# the rebuilt gating kernel: T 8 on the warp path; 37 (one chunk), 4096
# and 8192 (16 and 32 chunks) on the chunk kernel
GATING_SCAN = [(T, E, k) for T in (8, 37, 4096, 8192) for E in (4, 8, 32)
               for k in (1, 2, 3)]


@pytest.mark.parametrize("T,E,k", GATING_SCAN,
                         ids=[f"T{T}-E{E}-k{k}" for T, E, k in GATING_SCAN])
def test_topk_gating_paths_bit_equal_in_routing(dev, T, E, k):
    """Routing bit-equal to the plain version and to the chunked twin's
    algebra, with a capacity that drops and one that does not, random
    and underflowed gates; two calls bit-identical, gsum included; the
    warp kernel at T <= 32, the chunk kernel above (more than one block
    from T 4096)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import \
        moe_capacity
    g = torch.Generator(device=dev).manual_seed(T + E + k)
    for underflow in (False, True):
        x = torch.randn(T, E, generator=g, device=dev) * 1.4
        if underflow:
            x.zero_()
            x[:, E // 2] = 200.0
            x[1::2, E - 1] = 200.0
        for cap in (max(1, T * k // (2 * E)), moe_capacity(k, T, E, 2.4)):
            raw = mg.topk_gating_cuda(x, k, cap)
            again = mg.topk_gating_cuda(x, k, cap)
            for a, b in zip(raw, again):
                assert torch.equal(a, b)
            want = mg.topk_gating_plain(x, k, cap, False)
            for a, b in zip(raw[:3], want[:3]):
                assert torch.equal(a.to(b.dtype), b)
            assert float((raw[3] - want[3]).abs().max()) <= 1e-6
            twin = mg.topk_gating_chunked_plain(x, k, cap)
            assert torch.equal(raw[4], twin[4])
            torch.testing.assert_close(raw[5], twin[5], rtol=1e-5, atol=1e-6)
    kernel, threads = mg.gating_plan(T)
    names = _device_kernels(lambda: mg.topk_gating_cuda(x, k, cap))
    assert any(kernel in n for n in names), names
    if T > 32:
        assert mg.gating_grid(T, E, k) == -(-T // threads)
    if T >= 4096:
        assert mg.gating_grid(T, E, k) > 1


# ------------------------------------------------------------ CUDA graphs
# (quantize, kv_quant) of the graphed-step cases, all bf16
GRAPH_CASES = [(None, None), (None, "int8"), ("w8", None), ("w8a8", "int8")]


def _graph_model(dev):
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=256, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256)
    return LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16, seed=3)


def _launch_counts():
    from paddle_tpu_torch.inference import paged
    return {fn: fn.launches for fn in paged._counted_wrappers()}


def _graph_script(rng):
    """(method, args, kwargs) steps over sequences 0-5: prefills of two
    buckets and both tail kinds, chunk prefills, ragged decode steps
    (greedy, sampled, logits), each bucket at least twice."""
    def ids(n):
        return rng.integers(0, 256, (1, n)).astype(np.int32)

    def samp(n, flag, ctr=True):
        s = (np.arange(n, dtype=np.uint32) + 5, np.full(n, 0.9, np.float32),
             np.full(n, flag))
        return (s[0], np.full(n, 40, np.int32), *s[1:]) if ctr else s

    steps = [("prefill", ([0], ids(20)), dict(sampling=samp(1, True))),
             ("prefill", ([1], ids(30)), {}),
             ("prefill", ([2], ids(25)), dict(sampling=samp(1, True))),
             ("prefill", ([3], ids(16)), dict(sampling=samp(1, False))),
             ("prefill", ([4], ids(16)), dict(sampling=samp(1, False))),
             ("chunk_prefill", ([3], ids(10), 16),
              dict(sampling=samp(1, True))),
             ("chunk_prefill", ([4], ids(12), 16),
              dict(sampling=samp(1, True))),
             ("prefill", ([5], ids(31)), {})]
    lens = {0: 20, 1: 30, 2: 25, 3: 26, 4: 28, 5: 31}
    seqs = [0, 1, 2, 3]
    for i in range(6):
        rows = [[int(t)] for t in rng.integers(0, 256, 4)]
        kw = ({} if i % 3 == 2 else
              dict(sampling=samp(4, i % 3 == 1, ctr=False)))
        steps.append(("ragged_step", (seqs, rows, [lens[s] for s in seqs]),
                      kw))
        for s in seqs:
            lens[s] += 1
    return steps


def _run_graph_script(decs, caches, steps):
    """Each step through every decoder on its own cache; returns, per
    step, each decoder's output and its kernels' launch deltas."""
    got = []
    for method, args, kw in steps:
        row = []
        for dec, cache in zip(decs, caches):
            before = _launch_counts()
            out = getattr(dec, method)(cache, *args, **kw)
            after = _launch_counts()
            row.append((out, {fn.__name__: after[fn] - before[fn]
                              for fn in after if after[fn] != before[fn]}))
        got.append(row)
    return got


@pytest.mark.parametrize("quantize,kv", GRAPH_CASES,
                         ids=["bf16", "bf16-int8kv", "w8", "w8a8-int8kv"])
def test_graphed_steps_equal_eager(dev, quantize, kv):
    """``GraphedPagedDecoder`` against the eager ``PagedDecoder`` on two
    caches filled alike: prefill, chunk prefill and ragged steps, ids and
    logits bit-equal; a bucket's second call captures nothing and
    replays; each replay advances every launch counter by what the eager
    step launches; after ``reset_pools`` the replays stay right."""
    from paddle_tpu_torch.inference import paged
    model = _graph_model(dev)
    caches = [pa.PagedKVCache.from_model(model, total_pages=64,
                                         page_size=16, kv_dtype=kv)
              for _ in range(2)]
    eager = paged.PagedDecoder(model, quantize=quantize)
    graphed = paged.GraphedPagedDecoder(model, quantize=quantize)
    rng = np.random.default_rng(11)
    steps = _graph_script(rng)
    for (out_e, n_e), (out_g, n_g) in _run_graph_script(
            (eager, graphed), caches, steps):
        if isinstance(out_e, tuple):
            for a, b in zip(out_e, out_g):
                np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_array_equal(out_g, out_e)
        assert n_g == n_e
    keys = list(graphed._graphs)
    assert {k[0] for k in keys} == {"prefill", "prefix", "ragged"}
    assert graphed.captures == len(keys) < len(steps)
    assert graphed.replays == len(steps) - len(keys)
    # every graph again, after the pools are zeroed in place
    for c in caches:
        c.reset_pools()
        for sid in list(c._seq_pages):
            c.free(sid)
    captured = graphed.captures
    again = _run_graph_script((eager, graphed), caches, steps)
    for (out_e, _), (out_g, _) in again:
        for a, b in zip(out_e if isinstance(out_e, tuple) else (out_e,),
                        out_g if isinstance(out_g, tuple) else (out_g,)):
            np.testing.assert_array_equal(b, a)
    assert graphed.captures == captured


def test_graph_second_call_of_a_bucket_captures_nothing(dev):
    """One decode bucket: the first call captures, the next replays, and
    the paged kernel's counter grows by one launch a layer each time."""
    from paddle_tpu_torch.inference import paged
    model = _graph_model(dev)
    cache = pa.PagedKVCache.from_model(model, total_pages=32, page_size=16)
    dec = paged.GraphedPagedDecoder(model)
    dec.prefill(cache, [0], np.arange(5, dtype=np.int32)[None])
    greedy = (np.zeros(1, np.uint32), np.ones(1, np.float32),
              np.zeros(1, bool))
    for i, want in enumerate([(2, 0), (2, 1), (2, 2)]):
        before = pa.paged_attention_cuda.launches
        dec.ragged_step(cache, [0], [[7]], [5 + i], sampling=greedy)
        assert (dec.captures, dec.replays) == want
        assert pa.paged_attention_cuda.launches - before == 2


def test_graph_capture_failure_raises(dev):
    """No fallback: a body that reads a value back to the host cannot be
    captured, and the step raises with the lengths rolled back."""
    from paddle_tpu_torch.inference import paged
    model = _graph_model(dev)
    cache = pa.PagedKVCache.from_model(model, total_pages=32, page_size=16)
    dec = paged.GraphedPagedDecoder(model)
    def read_back(mod, args, out):
        float(out.float().sum())

    hook = model.model.norm.register_forward_hook(read_back)
    try:
        with pytest.raises(RuntimeError):
            dec.prefill(cache, [0], np.arange(5, dtype=np.int32)[None])
    finally:
        hook.remove()
    torch.cuda.synchronize()
    assert cache.length(0) == 0
    assert (dec.captures, dec._graphs) == (0, {})
