#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card and a checkout of the repository around it; without
either it exits nonzero and prints no result.  Phases, each fatal on
failure:

1. build   — compile every CUDA kernel from ``paddle_tpu_torch/ops/csrc``
            (one nvcc per source, in parallel); print the card's name and
            power limit as nvidia-smi reports them.
2. kernels — run each hand-written kernel at the serving path's shapes
            against its plain PyTorch version on the card, with a stated
            tolerance; time kernel, plain version and, where one PyTorch
            call computes the same function, that call (a yardstick the
            port never uses), each as device time per call from CUDA
            graph replays; compute each kernel's bound from the bytes
            and operations of its inputs.
3. small   — a small f32 model served on the card (kernels) and on the
            CPU (plain versions) from the same weights: the greedy token
            streams must agree.
4. serve   — llama_7b in bf16, weights drawn on the card from ``--seed``:
            8 requests through the continuous-batching engine, unchunked
            and then with 256-token prefill chunks.  The kernels' launch
            counters are zeroed just before each pass and read just
            after it; every kernel of a pass's path must have launched,
            every request must complete, and one request's prefill
            logits must agree with a plain forward of the same model on
            the card (in f32, and in bf16 relative to the plain bf16
            forward's own distance from f32).
5. profile — where a decode step's time goes: batch 8 at contexts 512
            and 2048, host-clock step times, then one ``torch.profiler``
            window for the device's busy time, idle share and top kernels.

The line before the last is the kernels' JSON record (each kernel's
``launches`` is its count in the unchunked pass, the engine's default;
``launches_by_path`` and ``serve`` give every pass's counts, TTFT p50
and decode tokens/s); the last line is ``{"ok": true, "device": {...}}``.
"""
import argparse
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_S = 3.35e12       # H100 SXM HBM3
BF16_FLOP_S = 989e12        # dense bf16 tensor-core peak
F32_FLOP_S = 67e12          # f32 outside the tensor cores

KERNELS = {
    "paged_attention": dict(
        route="cuda", source="paddle_tpu_torch/ops/csrc/paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:72"),
    "flash_attention_forward": dict(
        route="cuda", source="paddle_tpu_torch/ops/csrc/flash_attention.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:61"),
    "rms_norm": dict(
        route="triton", source="paddle_tpu_torch/ops/fused_norm_rope.py",
        replaces="paddle_tpu/ops/pallas/fused_norm_rope.py:34"),
    "apply_rope": dict(
        route="triton", source="paddle_tpu_torch/ops/fused_norm_rope.py",
        replaces="paddle_tpu/ops/pallas/fused_norm_rope.py:113"),
}


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, reps=20):
    """Mean device milliseconds per call of ``fn``: ``reps`` calls are
    captured in one CUDA graph and the graph is replayed between CUDA
    events, so the host's launch cost, which would hide a short kernel's
    own time, stays out of the number."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def cold_inputs(t, l2_bytes=50 << 20):
    """An endless cycle of copies of ``t`` that together outgrow the
    card's 50 MB L2, so a timed call reads its input from device memory,
    not from the cache the previous call warmed."""
    n = max(2, -(-2 * l2_bytes // (t.numel() * t.element_size())))
    return itertools.cycle([t.clone() for _ in range(n)])


def check(name, case, out, ref, tol):
    """Hold a kernel's output against its plain version: the largest
    absolute difference may be ``tol`` times max(1, max |ref|) (bf16
    tolerances are a few ulps of the largest value), and the relative L2
    difference ||out - ref|| / ||ref|| may be ``tol`` (this one scales
    with outputs far below 1, such as attention's, where a dropped page
    or tile would stay under the absolute limit).  Returns the largest
    absolute difference."""
    diff = out.float() - ref.float()
    err = float(diff.abs().max())
    rel = float(diff.norm() / ref.float().norm().clamp_min(1e-30))
    limit = tol * max(1.0, float(ref.float().abs().max()))
    ok = err <= limit and rel <= tol
    log(f"  {name} {case}: max_abs_err={err:.3e} limit={limit:.3e} "
        f"(tol {tol:g} x max(1, max|ref|)), rel_l2={rel:.3e} limit "
        f"{tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {case}: kernel differs from its "
                             f"plain version by {err:.3e} (limit "
                             f"{limit:.3e}), relative L2 {rel:.3e} (limit "
                             f"{tol:g})")
    return err


def bound_ms(n_bytes, n_ops, flop_s):
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / flop_s
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------- kernels
def check_paged(records, dev):
    from paddle_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)

    def case(label, dtype, q_heads, kv_heads, d, spans, ctxs, timed=False):
        b = len(spans)
        max_q = max(spans)
        lens = np.asarray(ctxs, np.int64) + np.asarray(spans)
        page = 16
        need = [-(-int(n) // page) for n in lens]
        total = sum(need) + 1
        width = 1
        while width < max(need):
            width *= 2
        perm = rng.permutation(total)
        tables = np.zeros((b, width), np.int32)
        at = 0
        for i, n in enumerate(need):
            tables[i, :n] = perm[at:at + n]
            at += n
        kp = torch.randn(kv_heads, total, page, d, generator=gen,
                         device=dev).to(dtype)
        vp = torch.randn(kv_heads, total, page, d, generator=gen,
                         device=dev).to(dtype)
        q = torch.randn(b, max_q, q_heads, d, generator=gen,
                        device=dev).to(dtype)
        lens_t = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        ql_t = torch.as_tensor(spans, dtype=torch.int32, device=dev)
        tab_t = torch.as_tensor(tables, device=dev)
        out = pa.paged_attention_cuda(q, kp, vp, lens_t, ql_t, tab_t)
        ref = pa._ragged_plain(q, kp, vp, lens_t, ql_t, tab_t,
                               1.0 / d ** 0.5)
        torch.cuda.synchronize()
        # positions past a row's span are bucket padding: the plain
        # version computes discarded values there, the kernel zeros
        real = (torch.arange(max_q, device=dev)[None, :]
                < ql_t[:, None])[:, :, None, None]
        if float((out.float() * ~real).abs().max()) != 0.0:
            raise AssertionError(f"paged_attention {label}: bucket pad "
                                 "positions are not zero")
        err = check("paged_attention", label, out * real, ref * real,
                    2e-2 if dtype == torch.bfloat16 else 1e-4)
        if not timed:
            return
        ms = cuda_ms(lambda: pa.paged_attention_cuda(
            q, kp, vp, lens_t, ql_t, tab_t))
        plain_ms = cuda_ms(lambda: pa._ragged_plain(
            q, kp, vp, lens_t, ql_t, tab_t, 1.0 / d ** 0.5), reps=3)
        el = q.element_size()
        # K/V of every row's context, read once per kv head; q and out
        n_bytes = (int(lens.sum()) * kv_heads * d * 2 * el
                   + 2 * int(sum(spans)) * q_heads * d * el)
        visible = sum(int(min(n, n - s + 1 + j))
                      for n, s in zip(lens, spans) for j in range(s))
        n_ops = 4 * visible * q_heads * d
        bms, by = bound_ms(n_bytes, n_ops, BF16_FLOP_S)
        log(f"  paged_attention {label}: {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bms:.4f} ms ({by})")
        records["paged_attention"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None)

    bf16, f32 = torch.bfloat16, torch.float32
    decode_ctx = list(rng.integers(64, 1056, 8))
    case("decode b8 32/32 d128 bf16 ctx<=1056", bf16, 32, 32, 128,
         [1] * 8, decode_ctx, timed=True)
    mix_spans = [1, 7, 64, 1, 7, 64, 1, 1]
    mix_ctx = list(rng.integers(0, 1984, 8))
    case("ragged spans 1/7/64 32/32 d128 bf16 ctx<=2048", bf16, 32, 32,
         128, mix_spans, mix_ctx)
    case("ragged gqa 32/8 d128 bf16", bf16, 32, 8, 128, mix_spans, mix_ctx)
    case("ragged 32/32 d128 f32", f32, 32, 32, 128, mix_spans, mix_ctx)
    case("ragged gqa 8/2 d64 bf16", bf16, 8, 2, 64, mix_spans, mix_ctx)
    case("verify full spans 32/32 bf16", bf16, 32, 32, 128, [5] * 4,
         [100, 700, 1500, 3])


def check_flash(records, dev):
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(2)

    def case(label, dtype, h, kvh, sq, sk, d, causal, timed=False):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)
        q, k, v = rnd(1, h, sq, d), rnd(1, kvh, sk, d), rnd(1, kvh, sk, d)
        out, lse = fa.flash_attention_cuda(q, k, v, causal=causal)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        bf = dtype == torch.bfloat16
        err = check("flash_attention_forward", label, out, ref,
                    2e-2 if bf else 1e-4)
        check("flash_attention_forward", label + " lse", lse, ref_lse,
              1e-4)
        if not timed:
            return
        ms = cuda_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal), reps=3)
        lib_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal))
        el = q.element_size()
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * el \
            + lse.numel() * 4
        off = sk - sq
        pairs = sum(min(sk, max(0, r + off + 1)) for r in range(sq)) \
            if causal else sq * sk
        n_ops = 4 * pairs * d * h
        bms, by = bound_ms(n_bytes, n_ops, BF16_FLOP_S)
        log(f"  flash_attention_forward {label}: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by})")
        records["flash_attention_forward"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms)

    bf16, f32 = torch.bfloat16, torch.float32
    case("s512 causal 32/32 d128 bf16", bf16, 32, 32, 512, 512, 128, True)
    case("s2048 causal 32/32 d128 bf16", bf16, 32, 32, 2048, 2048, 128,
         True, timed=True)
    case("sq256<sk1024 causal bf16", bf16, 32, 32, 256, 1024, 128, True)
    case("gqa 32/8 s512 causal bf16", bf16, 32, 8, 512, 512, 128, True)
    case("s512 causal f32", f32, 32, 32, 512, 512, 128, True)
    case("d64 sk1000 full bf16", bf16, 8, 8, 300, 1000, 64, False)
    # the serving layout: (b, s, h, d) buffers read through strides
    q = torch.randn(1, 777, 32, 128, generator=gen, device=dev).bfloat16()
    k = torch.randn(1, 777, 32, 128, generator=gen, device=dev).bfloat16()
    v = torch.randn(1, 777, 32, 128, generator=gen, device=dev).bfloat16()
    out = fa.flash_attention_bshd(q, k, v, causal=True)
    ref = fa.mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=True).transpose(1, 2)
    check("flash_attention_forward", "bshd s777 causal bf16", out, ref,
          2e-2)


def check_norm_rope(records, dev):
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops import fused_norm_rope as nr
    gen = torch.Generator(device=dev).manual_seed(3)
    eps = 1e-5

    for rows, dtype, timed in ((1024, torch.bfloat16, True),
                               (8, torch.bfloat16, False),
                               (64, torch.float32, False)):
        x = torch.randn(rows, 4096, generator=gen, device=dev).to(dtype)
        w = (1 + 0.1 * torch.randn(4096, generator=gen, device=dev)).to(dtype)
        out = nr.rms_norm_triton(x, w, eps)
        ref = nr.rms_norm_plain(x, w, eps)
        torch.cuda.synchronize()
        label = f"({rows}, 4096) {str(dtype).split('.')[-1]}"
        err = check("rms_norm", label, out, ref,
                    2e-2 if dtype == torch.bfloat16 else 1e-5)
        if not timed:
            continue
        xs = cold_inputs(x)
        ms = cuda_ms(lambda: nr.rms_norm_triton(next(xs), w, eps),
                     100)
        plain_ms = cuda_ms(lambda: nr.rms_norm_plain(next(xs), w,
                                                            eps), 100)
        lib = getattr(torch.nn.functional, "rms_norm", None)
        lib_ms = (cuda_ms(lambda: lib(next(xs), (4096,), w, eps),
                          100) if lib is not None else None)
        el = x.element_size()
        bms, by = bound_ms(2 * x.numel() * el + w.numel() * el,
                           4 * x.numel(), F32_FLOP_S)
        log(f"  rms_norm {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms} ms, bound {bms:.4f} ms ({by})")
        records["rms_norm"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=lib_ms)

    cos, sin = (t.to(dev) for t in _rope_tables(128, 4096, 10000.0))
    for b, s, h, kvh, dtype, timed in (
            (1, 1024, 32, 32, torch.bfloat16, True),
            (8, 1, 32, 32, torch.bfloat16, False),
            (8, 64, 32, 8, torch.bfloat16, False),
            (4, 16, 32, 32, torch.float32, False)):
        q = torch.randn(b, s, h, 128, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, s, kvh, 128, generator=gen, device=dev).to(dtype)
        pos = torch.randint(0, 4096 - s, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
        oq, ok = nr.apply_rope_triton(q, k, cos, sin, pos)
        rq, rk = nr.apply_rope_plain(q, k, cos, sin, pos)
        torch.cuda.synchronize()
        label = f"q({b},{s},{h},128) kv{kvh} {str(dtype).split('.')[-1]}"
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        err = max(check("apply_rope", label + " q", oq, rq, tol),
                  check("apply_rope", label + " k", ok, rk, tol))
        if not timed:
            continue
        qs, ks = cold_inputs(q), cold_inputs(k)
        ms = cuda_ms(lambda: nr.apply_rope_triton(
            next(qs), next(ks), cos, sin, pos), 100)
        plain_ms = cuda_ms(lambda: nr.apply_rope_plain(
            next(qs), next(ks), cos, sin, pos), 20)
        el = q.element_size()
        n_bytes = 2 * (q.numel() + k.numel()) * el \
            + 2 * b * s * 64 * 4 + b * 4
        bms, by = bound_ms(n_bytes, 3 * (q.numel() + k.numel()), F32_FLOP_S)
        log(f"  apply_rope {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by})")
        records["apply_rope"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None)


# ------------------------------------------------------------- serving
def counters():
    from paddle_tpu_torch.ops import fused_norm_rope as nr
    from paddle_tpu_torch.ops.flash_attention import flash_attention_cuda
    from paddle_tpu_torch.ops.paged_attention import paged_attention_cuda
    return {"paged_attention": paged_attention_cuda,
            "flash_attention_forward": flash_attention_cuda,
            "rms_norm": nr.rms_norm_triton,
            "apply_rope": nr.apply_rope_triton}


def serve(model, prompts, sharer, chunk, device):
    """Serve ``prompts`` (the last two sampled) and then ``sharer``,
    which shares prompts[0]'s first 256 tokens, once prompts[0] has its
    first token (so its prefix is cached).  Returns requests and wall
    seconds."""
    from paddle_tpu_torch.inference.continuous import \
        ContinuousBatchingEngine
    t0 = time.perf_counter()
    with ContinuousBatchingEngine(model, total_pages=1024, page_size=16,
                                  max_batch=8, prefill_chunk_tokens=chunk,
                                  device=device) as eng:
        reqs = []
        for i, p in enumerate(prompts):
            sampled = i >= len(prompts) - 2
            reqs.append(eng.submit(p, max_new_tokens=32, do_sample=sampled,
                                   temperature=0.8, seed=100 + i))
        while reqs[0].first_token_at is None and not reqs[0].done.is_set():
            time.sleep(0.005)
        reqs.append(eng.submit(sharer, max_new_tokens=32))
        for r in reqs:
            r.result(timeout=600)
        if device.type == "cuda":
            torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def serve_stats(reqs, wall):
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    span = max(r.finished_at for r in reqs) \
        - min(r.first_token_at for r in reqs)
    tpot = sorted((r.finished_at - r.first_token_at)
                  / max(1, len(r.generated) - 1) for r in reqs)
    return dict(requests=len(reqs), ttft_p50_s=ttft[len(ttft) // 2],
                tpot_p50_s=tpot[len(tpot) // 2],
                decode_tok_s=decode_tokens / span, wall_s=wall)


def plain_forward(model, ids):
    """The port's LLaMA forward on its plain versions (no kernel): the
    reference for the kernel path's logits on the card."""
    from paddle_tpu_torch.ops.flash_attention import mha_reference
    from paddle_tpu_torch.ops.fused_norm_rope import (apply_rope_plain,
                                                      rms_norm_plain)
    m = model.model
    x = m.embed_tokens(ids)
    b, s = ids.shape
    pos = torch.zeros(b, dtype=torch.int32, device=ids.device)
    for layer in m.layers:
        at = layer.self_attn
        h = rms_norm_plain(x, layer.input_layernorm.weight,
                           layer.input_layernorm.epsilon)
        q = at.q_proj(h).view(b, s, at.num_heads, at.head_dim)
        k = at.k_proj(h).view(b, s, at.num_kv_heads, at.head_dim)
        v = at.v_proj(h).view(b, s, at.num_kv_heads, at.head_dim)
        q, k = apply_rope_plain(q, k, m.rope_cos, m.rope_sin, pos)
        o = mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True).transpose(1, 2)
        x = x + at.o_proj(o.reshape(b, s, -1))
        x = x + layer.mlp(rms_norm_plain(
            x, layer.post_attention_layernorm.weight,
            layer.post_attention_layernorm.epsilon))
    x = rms_norm_plain(x, m.norm.weight, m.norm.epsilon)
    return model._logits_of(x).float()


def prefill_logits(model, ids):
    """Last-token logits of ``ids`` (1, s) through the serving prefill
    (kernels) and through ``plain_forward``, both on the model's card."""
    from paddle_tpu_torch.inference.paged import PagedDecoder
    from paddle_tpu_torch.ops.paged_attention import PagedKVCache
    cache = PagedKVCache.from_model(model, total_pages=32, page_size=16)
    with torch.no_grad():
        got = PagedDecoder(model).prefill(cache, [0], ids.cpu().numpy())
        ref = plain_forward(model, ids)[0, -1]
    return torch.as_tensor(got[0], device=ref.device), ref


def check_small():
    """A small f32 model: greedy streams on the card (kernels) equal the
    CPU's (plain versions) from the same weights."""
    from paddle_tpu_torch.inference.continuous import \
        ContinuousBatchingEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=512)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=7)
    gpu = LlamaForCausalLM(cfg, device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (9, 40, 130)]
    for chunk in (None, 32):
        streams = []
        for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
            with ContinuousBatchingEngine(model, total_pages=64,
                                          page_size=16, max_batch=4,
                                          prefill_chunk_tokens=chunk,
                                          device=dev) as eng:
                reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
                streams.append([r.result(timeout=300).tolist()
                                for r in reqs])
        if streams[0] != streams[1]:
            raise AssertionError(
                f"small f32 model, chunk={chunk}: greedy streams on the "
                f"card {streams[0]} differ from the CPU's {streams[1]}")
        log(f"  small f32 model chunk={chunk}: greedy streams of "
            f"{len(prompts)} requests equal card vs CPU")


def _device_us(evt):
    """Device time of a profiler kernel entry (0 for host-side operator
    entries, whose device time would count their kernels twice)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile_decode(model, batch, context, steps, seed):
    """Prefill ``batch`` sequences of ``context`` tokens one by one, then
    run ``steps`` ragged decode steps (one token per row): the first
    half timed on the host clock (each step ends in the host transfer
    of its token ids), the second half in one ``torch.profiler`` window
    for the device's busy time per step and its idle share."""
    from paddle_tpu_torch.inference.paged import PagedDecoder
    from paddle_tpu_torch.ops.paged_attention import PagedKVCache
    pages = batch * (-(-(context + steps + 8) // 16))
    cache = PagedKVCache.from_model(model, total_pages=pages + 1,
                                    page_size=16)
    dec = PagedDecoder(model)
    rng = np.random.default_rng(seed)
    seqs = list(range(batch))
    nxt = np.zeros(batch, np.int32)
    greedy1 = (np.zeros(1, np.uint32), np.zeros(1, np.int32),
               np.ones(1, np.float32), np.zeros(1, bool))
    walls = []
    for sid in seqs:
        ids = rng.integers(0, model.config.vocab_size,
                           (1, context)).astype(np.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt[sid] = dec.prefill(cache, [sid], ids, sampling=greedy1)[0]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    greedy = (np.zeros(batch, np.uint32), np.ones(batch, np.float32),
              np.zeros(batch, bool))

    def step():
        ctxs = [cache.length(s) for s in seqs]
        out, _ = dec.ragged_step(cache, seqs, [[int(t)] for t in nxt],
                                 ctxs, sampling=greedy)
        nxt[:] = out

    half = steps // 2
    times = []
    for _ in range(half):
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(times[1:], [25, 50, 75])
    n = steps - half
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(_device_us(e) for e in events)
    top = sorted(events, key=_device_us, reverse=True)[:8]
    return {
        "batch": batch, "context": context,
        "prefill_s_first": walls[0],
        "prefill_s_median_rest": float(np.median(walls[1:])),
        "step_ms_p25": q1, "step_ms_p50": med, "step_ms_p75": q3,
        "window_ms_per_step": window * 1e3 / n,
        "device_busy_ms_per_step": (busy_us / 1e3 / n) if busy_us
        else "not measured",
        # the profiler slows the host: idle share against the
        # unprofiled median step
        "device_idle_share": (1 - busy_us / 1e3 / n / med) if busy_us
        else "not measured",
        "top_device": [{"name": e.key[:60], "calls_per_step": e.count / n,
                        "device_ms_per_step": _device_us(e) / 1e3 / n}
                       for e in top if _device_us(e) > 0]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(paddle_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 1. build
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"build: {len(libs)} CUDA kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, info in sorted(_build.ptxas_info.items()):
        for line in info.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(smi[0])

    # 2. kernels against their plain versions
    records = {}
    log("kernels:")
    t0 = time.perf_counter()
    check_paged(records, dev)
    check_flash(records, dev)
    check_norm_rope(records, dev)
    log(f"kernels: checked in {time.perf_counter() - t0:.1f} s")

    # 3. a small model, card vs CPU
    log("small:")
    check_small()

    # 4. llama_7b serving
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    cfg = llama_7b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             seed=args.seed)
    torch.cuda.synchronize()
    log(f"serve: llama_7b ({cfg.num_hidden_layers} layers) bf16 weights "
        f"drawn in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params")
    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(64, 1025, 8)
    lengths[0] = max(lengths[0], 300)     # holds the shared 256 prefix
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lengths[:7]]
    sharer = np.concatenate([prompts[0][:256], rng.integers(
        0, cfg.vocab_size, int(lengths[7]) - 256 if lengths[7] > 256
        else 64)]).astype(np.int32)
    kernels = counters()
    launches = {}
    passes = {}
    greedy = {}
    for label, chunk in (("unchunked", None), ("chunked256", 256)):
        for fn in kernels.values():
            fn.launches = 0
        reqs, wall = serve(model, prompts, sharer, chunk, dev)
        got = {n: fn.launches for n, fn in kernels.items()}
        launches[label] = got
        for i, r in enumerate(reqs):
            if r.error is not None or len(r.generated) != 32:
                raise AssertionError(f"{label}: request {i} did not "
                                     f"complete ({r.error})")
            if not all(0 <= t < cfg.vocab_size for t in r.generated):
                raise AssertionError(f"{label}: token out of vocabulary")
        if reqs[-1].prefix_tokens != 256:
            raise AssertionError(f"{label}: the sharer hit "
                                 f"{reqs[-1].prefix_tokens} cached tokens, "
                                 "expected 256")
        stats = serve_stats(reqs, wall)
        passes[label] = dict(stats, launches=got)
        log(f"serve {label}: " + json.dumps(passes[label]))
        # with 256-token chunks every prompt rides the ragged kernel, so
        # that path has no flash launch
        need = [n for n in kernels if n != "flash_attention_forward"
                or chunk is None]
        missing = [n for n in need if got[n] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched on the "
                                 f"serving path: {missing}")
        greedy[label] = [r.generated for r in reqs[:6]]
    same = sum(a == b for a, b in zip(greedy["unchunked"],
                                      greedy["chunked256"]))
    log(f"serve: {same}/6 greedy streams identical unchunked vs chunked "
        "(bf16: the two paths round differently, so equality is "
        "reported, not required)")

    # 5. where a decode step's time goes (after the serve passes, so no
    # launch of it is counted there; before the f32 check below, which
    # turns the model to f32)
    log("profile:")
    for context in (512, 2048):
        log("  " + json.dumps(dict(profile_decode(model, 8, context, 32,
                                                  args.seed), card=smi[0])))

    # one request's prefill logits, kernel path vs plain forward on the
    # card: in f32 the two must agree closely; in bf16 the kernel path
    # must stay as close to the f32 result as the plain bf16 path does
    # (the two round at different places, and 32 random layers amplify
    # any rounding, so a fixed bf16 tolerance would say nothing)
    ids = torch.as_tensor(prompts[1][None, :256].astype(np.int64),
                          device=dev)
    got16, ref16 = prefill_logits(model, ids)
    model.float()
    got32, ref32 = prefill_logits(model, ids)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    r32 = rel(got32, ref32)
    r_kernel, r_plain = rel(got16, ref32), rel(ref16, ref32)
    log(f"serve: prefill logits of a 256-token request on the card, "
        f"relative L2 error: f32 kernels vs f32 plain {r32:.2e} (limit "
        f"1e-3); bf16 kernels vs f32 plain {r_kernel:.2e}, bf16 plain vs "
        f"f32 plain {r_plain:.2e} (limit 2x the latter); argmax f32 "
        f"{int(ref32.argmax())}, bf16 kernels {int(got16.argmax())}, "
        f"bf16 plain {int(ref16.argmax())}")
    if not (torch.isfinite(got16).all() and torch.isfinite(got32).all()):
        raise AssertionError("prefill logits are not finite")
    if r32 > 1e-3 or r_kernel > 2 * r_plain:
        raise AssertionError("prefill logits: the kernel path is further "
                             "from the plain forward than its limit")

    out = []
    for name, meta in KERNELS.items():
        out.append(dict(name=name, **meta,
                        launches=launches["unchunked"][name],
                        launches_by_path={p: launches[p][name]
                                          for p in launches},
                        **records[name]))
    serve_line = {p: {k: passes[p][k] for k in
                      ("ttft_p50_s", "decode_tok_s", "launches")}
                  for p in passes}
    print(json.dumps({"kernels": out, "serve": serve_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
