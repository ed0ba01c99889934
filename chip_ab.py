#!/usr/bin/env python3
"""Compare two checkouts of the port on one card, in turns.

    python3 chip_ab.py BASE_DIR
        [--phases flash,quant,flashmask,paged,serve,gating,train,moe]
        [--seed N]

BASE_DIR is a checkout inside this one, in a directory that
``.gitignore`` lists, e.g. one unpacked with
``git archive <commit> | tar -x -C .checkout/parent``, so the kernels it
builds stay in its own ``ops/_build/``.  Each side runs in a process of
its own from its own checkout, which builds its kernels from its own
sources, in the order base, this, this, base, so a drift of the card's
clocks over the call shows as a difference between the two runs of one
side.  Phases: ``flash`` times the flash forward (serve, train and MoE
decode shapes), dK/dV and dQ (train shape) kernels through their public
wrappers on the same seeded inputs; ``quant`` times the bf16 weight-only
(w8) and w8a8 int8 matmuls at llama_7b's four prefill widths (1024 rows)
and at 32 rows the same way, the activation quantizer at the serving
passes' row shapes (inputs read cold), w8a8 at 8 and 1024 rows as each
side serves q|k|v and gate|up (one quantizer + matmul a Linear, or one on
the fused twin) and quantizer + w8a8 at the four decode (K, N);
``gating`` times the top-k MoE gating kernel at T 8, 4096 and 8192 (E 8,
top-2); ``flashmask`` times FlashMask's forward, dK/dV and dQ kernels
at the flashmask phase's doc_causal and causal_full cases (b 1 x 8192,
32 heads x 128, bf16); ``paged`` times the paged
attention kernel(s) of one ``paged_attention_cuda`` call (32 heads x 128,
bf16, 16-token pages) at decode b8 with contexts up to 1056 (bf16 and
int8 pages), decode b8 at context 2048, decode b1 at context 4000 and the
chunked256 mix (a 256-token chunk row beside 7 decode rows), the pools
read cold; ``serve`` serves chip_smoke.py's 8 requests on llama_7b (bf16
weights from ``--seed``) in bf16, and with ``w8`` and ``w8a8`` weights
and int8 KV pages (after chip_smoke.py's warm-up wave, where the side's
``serve`` takes one), and times one 1024-token prefill of each mode
(host wall clock, synchronized, and device busy time in a profiler
window); ``train`` and ``moe`` run
``chip_smoke.py``'s end-to-end phases (llama_small training steps; the
Mixtral-width MoE generate).  Each side's ``chip_smoke.py`` must provide
``cuda_ms(fn)``, ``profiled_ms(fn)``, ``cold_inputs(t)``, ``serve(...)``,
``serve_stats``, ``fm_intervals``, ``train(seed, dev, card)`` and
``moe_generate(seed, dev, card)`` as this one does.  Prints one JSON
line per run, then a summary line with each side's two runs of every
metric.  Needs one CUDA card; exits nonzero if any run fails.
"""
import argparse
import json
import os
import subprocess
import sys

# the flash cases: (name, kernel, b, h, kv_h, sq, sk, d), bf16, causal
FLASH_CASES = (("fwd serve s2048 32/32 d128", "fwd", 1, 32, 32, 2048, 2048,
                128),
               ("fwd train b8 h12 s1024 d64", "fwd", 8, 12, 12, 1024, 1024,
                64),
               ("fwd decode b8 sq1 sk544 32/8 d128", "fwd", 8, 32, 8, 1, 544,
                128),
               ("dkv train b8 h12 s1024 d64", "dkv", 8, 12, 12, 1024, 1024,
                64),
               ("dq train b8 h12 s1024 d64", "dq", 8, 12, 12, 1024, 1024,
                64))
# the quantized cases: (M, K, N), bf16 x, llama_7b's q/k/v/o, gate/up,
# down and head widths at a 1024-token prefill, and gate/up at 32 rows;
# each through the w8 and the w8a8 kernel
QUANT_CASES = ((1024, 4096, 4096), (1024, 4096, 11008), (1024, 11008, 4096),
               (1024, 4096, 32000), (32, 4096, 11008))
# the activation quantizer's cases: (label, shape, misaligned), bf16 but
# the f32 one, chip_smoke.py's ACT_QUANT_CASES
ACT_QUANT_CASES = (("8 x 4096", (8, 4096), False),
                   ("8 x 11008", (8, 11008), False),
                   ("1024 x 4096", (1024, 4096), False),
                   ("1024 x 11008", (1024, 11008), False),
                   ("256 x 128", (256, 128), False),
                   ("32768 x 128", (32768, 128), False),
                   ("77 x 300 f32", (77, 300), False),
                   ("1024 x 4096 misaligned", (1024, 4096), True))
# llama_7b's decode Linears at 8 rows, (label, K, widths of the Linears
# that read one activation): w8a8 as each side serves them (the parent one
# quantizer + matmul a Linear, this tree one quantizer and one matmul on
# the fused twin), and quantizer + matmul at each (K, N) a decode w8a8
# call has (fused widths included)
W8A8_SERVED = (("q|k|v", 4096, (4096, 4096, 4096)),
               ("gate|up", 4096, (11008, 11008)))
W8A8_SERVED_ROWS = (8, 1024)          # a decode step's rows, a prefill's
W8A8_DECODE_KN = ((4096, 12288), (4096, 22016), (4096, 4096), (11008, 4096))
# the gating kernel's timed calls: Mixtral-width decode and prefill
GATING_CASES = ((8, 8, 2, 5), (4096, 8, 2, 2458), (8192, 8, 2, 4916))
# the FlashMask cases: chip_smoke.py's flashmask phase masks, each through
# the forward, dK/dV and dQ kernels
FLASHMASK_CASES = ("doc_causal", "causal_full")
FLASHMASK_KERNELS = ("fwd", "dkv", "dq")
# the paged cases: (name, spans, contexts, int8 pages), 32/32 heads d128
PAGED_DECODE_CTX = [148, 1052, 703, 96, 881, 420, 1006, 263]
PAGED_CASES = (
    ("decode b8 ctx<=1056", [1] * 8, PAGED_DECODE_CTX, False),
    ("int8 decode b8 ctx<=1056", [1] * 8, PAGED_DECODE_CTX, True),
    ("decode b8 ctx2048", [1] * 8, [2048] * 8, False),
    ("decode b1 ctx4000", [1], [3999], False),
    ("chunked256 mix ctx<=1024", [256] + [1] * 7,
     [717, 1011, 84, 530, 966, 311, 12, 640], False))
METRICS = {"flash": tuple(c[0] for c in FLASH_CASES),
           "quant": tuple(f"{mode} M{m} K{k} N{n}"
                          for mode in ("w8", "w8a8", "torch._int_mm")
                          for m, k, n in QUANT_CASES)
           + tuple(f"act_quant {c[0]}" for c in ACT_QUANT_CASES)
           + tuple(f"w8a8 served M{m} {c[0]}" for m in W8A8_SERVED_ROWS
                   for c in W8A8_SERVED)
           + tuple(f"act_quant+w8a8 M8 K{k} N{n}"
                   for k, n in W8A8_DECODE_KN),
           "gating": tuple(f"topk_gating T{t} E{e} k{k} C{c}"
                           for t, e, k, c in GATING_CASES),
           "flashmask": tuple(f"{kern} {c} b1 s8192 32/32 d128"
                              for c in FLASHMASK_CASES
                              for kern in FLASHMASK_KERNELS),
           "paged": tuple(c[0] for c in PAGED_CASES),
           "serve": tuple(f"{mode} {m}" for mode in ("bf16", "w8", "w8a8")
                          for m in (
               "ttft_p50_s", "tpot_p50_s", "prefill1024_wall_ms",
               "prefill1024_device_ms")),
           "train": ("step_ms_p50", "tokens_per_s", "mfu",
                     "device_busy_ms_per_step", "device_idle_share",
                     "device_ms_per_step_by_class"),
           "moe": ("prefill_s", "decode_ms_p50", "tokens_per_s",
                   "device_busy_ms_per_step", "device_idle_share")}


def flash(cs, seed, dev):
    """{case: device ms per call} of the flash forward, dK/dV and dQ
    kernels, timed with the side's own ``cuda_ms`` (CUDA-graph replay)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, kernel, b, h, kvh, sq, sk, d in FLASH_CASES:
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).bfloat16()
        q, k, v = rnd(b, h, sq, d), rnd(b, kvh, sk, d), rnd(b, kvh, sk, d)
        if kernel == "fwd":
            out[name] = cs.cuda_ms(lambda: fa.flash_attention_cuda(
                q, k, v, causal=True))
            continue
        do = rnd(b, h, sq, d)
        o, lse = fa.flash_attention_cuda(q, k, v, causal=True)
        delta = (o.float() * do.float()).sum(-1).contiguous()
        grads = [torch.empty_like(t) for t in (q, k, v)]
        launch = {"dkv": fa.flash_attention_bwd_dkv_cuda,
                  "dq": fa.flash_attention_bwd_dq_cuda}[kernel]
        out[name] = cs.cuda_ms(lambda: launch(
            q, k, v, do, lse, delta, *grads, True, d ** -0.5))
    return out


def quant(cs, seed, dev):
    """{case: device ms per call} of the bf16 w8 and w8a8 kernels, timed
    with the side's own ``cuda_ms``, and of ``torch._int_mm`` on the w8a8
    call's int8 operands (the yardstick; the port never calls it); the
    activation quantizer at its row shapes; w8a8 at decode and prefill
    rows as each side serves q|k|v and gate|up; quantizer + w8a8 at the
    decode (K, N)."""
    import itertools
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import quant_matmul as qm
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for m, k, n in QUANT_CASES:
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        sc = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        xq, xs = qm.dynamic_act_quant(x)
        out[f"w8 M{m} K{k} N{n}"] = cs.cuda_ms(
            lambda: qm.weight_only_matmul_cuda(x, w, sc))
        out[f"w8a8 M{m} K{k} N{n}"] = cs.cuda_ms(
            lambda: qm.w8a8_matmul_cuda(xq, xs, w, sc, torch.bfloat16))
        wt = w.t()
        out[f"torch._int_mm M{m} K{k} N{n}"] = cs.cuda_ms(
            lambda: torch._int_mm(xq, wt))
    # the quantizer alone, its inputs read cold (copies past the L2)
    for label, shape, misaligned in ACT_QUANT_CASES:
        dtype = torch.float32 if "f32" in label else torch.bfloat16
        n = int(np.prod(shape))
        base = (torch.randn(n + misaligned, generator=gen, device=dev)
                * 3).to(dtype)
        copies = max(2, -(-2 * (50 << 20) // (base.numel()
                                              * base.element_size())))
        xs_ = itertools.cycle([base.clone()[int(misaligned):].view(*shape)
                               for _ in range(copies)])
        out[f"act_quant {label}"] = cs.cuda_ms(
            lambda: qm.dynamic_act_quant_cuda(next(xs_)), 100)
    # w8a8 as each side serves the Linears that read one activation:
    # fused twins where the side has them (the module names its group),
    # else one quantizer + matmul a Linear
    from paddle_tpu_torch.models.llama import LlamaAttention
    fused = hasattr(LlamaAttention, "quant_fused")
    for m, (label, k, widths) in itertools.product(W8A8_SERVED_ROWS,
                                                   W8A8_SERVED):
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        ws = [torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                            dtype=torch.int8) for n in widths]
        ss = [torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
              for n in widths]
        if fused:
            w_cat, s_cat = torch.cat(ws), torch.cat(ss)
            served = lambda: qm.w8a8_matmul(x, w_cat, s_cat)  # noqa: E731
        else:
            served = lambda: [qm.w8a8_matmul(x, w, sc)  # noqa: E731
                              for w, sc in zip(ws, ss)]
        out[f"w8a8 served M{m} {label}"] = cs.cuda_ms(served)
    for k, n in W8A8_DECODE_KN:
        x = torch.randn(8, k, generator=gen, device=dev).bfloat16()
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        sc = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        out[f"act_quant+w8a8 M8 K{k} N{n}"] = cs.cuda_ms(
            lambda: qm.w8a8_matmul(x, w, sc))
    return out


def gating(cs, seed, dev):
    """{case: device ms per call} of the top-k gating kernel at the MoE
    pass's decode and prefill calls (f32 logits of standard deviation
    1.4, as the Mixtral-width gate gives), timed with the side's own
    ``cuda_ms``."""
    import torch
    from paddle_tpu_torch.ops import moe_gating as mg
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for T, E, k, cap in GATING_CASES:
        x = torch.randn(T, E, generator=gen, device=dev) * 1.4
        out[f"topk_gating T{T} E{E} k{k} C{cap}"] = cs.cuda_ms(
            lambda: mg.topk_gating_cuda(x, k, cap), 100)
    return out


def flashmask(cs, seed, dev):
    """{case: device ms per call} of FlashMask's forward, dK/dV and dQ
    kernels on the flashmask phase's intervals (``cs.fm_intervals``),
    given the skip table (and, for the backward, delta), timed with the
    side's own ``cuda_ms``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import flashmask_attention as fm
    gen = torch.Generator(device=dev).manual_seed(seed)
    s, d = 8192, 128
    out = {}
    for kind in FLASHMASK_CASES:
        se = cs.fm_intervals(kind, s, np.random.default_rng(0), dev)
        q, k, v, do = (torch.randn(1, 32, s, d, generator=gen,
                                   device=dev).bfloat16() for _ in range(4))
        o, lse = fm.flashmask_fwd_cuda(q, k, v, se, True)
        delta = (o.float() * do.float()).sum(-1).contiguous()
        skip = fm.flashmask_skip_table(se, s, True)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        launch = {
            "fwd": lambda: fm.flashmask_fwd_cuda(q, k, v, se, True, out=o,
                                                 skip=skip),
            "dkv": lambda: fm.flashmask_bwd_dkv_cuda(
                q, k, v, do, lse, delta, se, dk, dv, True, skip=skip),
            "dq": lambda: fm.flashmask_bwd_dq_cuda(
                q, k, v, do, lse, delta, se, dq, True, skip=skip)}
        for kern in FLASHMASK_KERNELS:
            out[f"{kern} {kind} b1 s8192 32/32 d128"] = cs.cuda_ms(
                launch[kern])
    return out


def paged(cs, seed, dev):
    """{case: device ms per call} of ``paged_attention_cuda`` (every
    kernel one call launches) on seeded pages and page tables, timed with
    the side's own ``cuda_ms``, the pools read cold (from device memory,
    not the L2)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    out = {}
    for name, spans, ctxs, int8 in PAGED_CASES:
        lens = np.asarray(ctxs) + np.asarray(spans)
        need = [-(-int(n) // 16) for n in lens]
        width = 1 << (max(need) - 1).bit_length()
        perm = rng.permutation(sum(need))
        tables = np.zeros((len(spans), width), np.int32)
        at = 0
        for i, n in enumerate(need):
            tables[i, :n] = perm[at:at + n]
            at += n
        kp, vp = (torch.randn(32, sum(need), 16, 128, generator=gen,
                              device=dev) for _ in range(2))
        sc = {}
        if int8:
            kp, ks = pa.quantize_kv(kp)
            vp, vs = pa.quantize_kv(vp)
            sc = dict(k_scales=ks, v_scales=vs)
        else:
            kp, vp = kp.bfloat16(), vp.bfloat16()
        q = torch.randn(len(spans), max(spans), 32, 128, generator=gen,
                        device=dev).bfloat16()
        meta = [torch.as_tensor(x, dtype=torch.int32, device=dev)
                for x in (lens, spans, tables)]
        # each call reads its pages from device memory, not the L2
        pools = [cs.cold_inputs(t) for t in (kp, vp, *sc.values())]

        def call():
            k_, v_, *s_ = (next(p) for p in pools)
            return pa.paged_attention_cuda(q, k_, v_, *meta,
                                           **dict(zip(sc, s_)))
        out[name] = cs.cuda_ms(call)
    return out


def serve(cs, seed, dev):
    """llama_7b in bf16 and with int8 weights (w8, w8a8): one 1024-token
    prefill alone, its synchronized wall milliseconds (median of 3 after
    a first call) and its device busy milliseconds (profiler); then
    chip_smoke.py's 8 requests through the engine, with int8 KV pages
    where the weights are int8 (TTFT and TPOT p50), after its warm-up
    wave where the side's ``serve`` takes one."""
    import inspect
    import time
    import numpy as np
    import torch
    from paddle_tpu_torch.inference.paged import PagedDecoder
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.ops.paged_attention import PagedKVCache
    cfg = llama_7b()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             seed=seed)
    # chip_smoke.py main()'s requests
    rng = np.random.default_rng(seed)
    lengths = rng.integers(64, 1025, 8)
    lengths[0] = max(lengths[0], 300)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lengths[:7]]
    sharer = np.concatenate([prompts[0][:256], rng.integers(
        0, cfg.vocab_size, int(lengths[7]) - 256 if lengths[7] > 256
        else 64)]).astype(np.int32)
    ids = rng.integers(0, cfg.vocab_size, (1, 1024)).astype(np.int32)
    # a side whose engine captures CUDA graphs serves chip_smoke.py's
    # warm-up wave first, so its measured wave replays them
    warm = [rng.integers(0, cfg.vocab_size, len(p)).astype(np.int32)
            for p in prompts]
    warmup = (warm, np.concatenate([warm[0][:256], rng.integers(
        0, cfg.vocab_size, len(sharer) - 256)]).astype(np.int32))
    kw = ({"warmup": warmup}
          if "warmup" in inspect.signature(cs.serve).parameters else {})
    out = {}
    for mode in (None, "w8", "w8a8"):
        # the prefill alone first: its first call also builds the int8
        # twins and compiles the Triton kernels, which the serve pass
        # would otherwise pay inside its TTFT
        cache = PagedKVCache.from_model(model, total_pages=80, page_size=16)
        decoder = PagedDecoder(model, quantize=mode)

        def prefill():
            decoder.prefill(cache, [0], ids)
            cache.free(0)
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        label = mode or "bf16"
        out[f"{label} prefill1024_wall_ms"] = float(np.median(walls[1:]))
        out[f"{label} prefill1024_device_ms"] = cs.profiled_ms(prefill,
                                                               reps=3)
        del cache, decoder
        torch.cuda.empty_cache()
        reqs, wall, _ = cs.serve(model, prompts, sharer, None, dev, mode,
                                 mode and "int8", **kw)
        stats = cs.serve_stats(reqs, wall)
        out[f"{label} ttft_p50_s"] = stats["ttft_p50_s"]
        out[f"{label} tpot_p50_s"] = stats["tpot_p50_s"]
        del reqs
        torch.cuda.empty_cache()
    return out


KERNEL_PHASES = {"flash": flash, "quant": quant, "flashmask": flashmask,
                 "paged": paged, "serve": serve, "gating": gating}


def child(phases, seed):
    """One side's run, from the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"card": card}
    for phase in phases:
        if phase in KERNEL_PHASES:
            out[phase] = KERNEL_PHASES[phase](cs, seed, dev)
        else:
            fn = {"train": cs.train, "moe": cs.moe_generate}[phase]
            rec, _launches = fn(seed, dev, card)
            out[phase] = {k: rec[k] for k in METRICS[phase]}
        torch.cuda.empty_cache()
    print("AB " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base")
    ap.add_argument("--phases",
                    default="flash,quant,flashmask,paged,serve,gating,train,"
                            "moe")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in METRICS for p in phases):
        ap.error(f"phases are {sorted(METRICS)}")
    if args.child:
        child(phases, args.seed)
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    base = os.path.abspath(args.base)
    runs = {"base": [], "this": []}
    for side in ("base", "this", "this", "base"):
        proc = subprocess.run(
            [sys.executable, os.path.join(here, "chip_ab.py"), base,
             "--phases", args.phases, "--seed", str(args.seed), "--child"],
            cwd=base if side == "base" else here, capture_output=True,
            text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(lines[-1][3:])
        runs[side].append(rec)
        print(json.dumps({"side": side, **rec}), flush=True)
    summary = {phase: {m: {side: [r[phase][m] for r in runs[side]]
                           for side in runs}
                       for m in METRICS[phase]} for phase in phases}
    print(json.dumps({"summary": summary, "card": runs["this"][0]["card"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
