#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N]

Needs one CUDA card and a checkout of the repository around it; without
either it exits nonzero and prints no result.  Phases, each fatal on
failure:

1. build   — compile every CUDA kernel from ``paddle_tpu_torch/ops/csrc``
            (one nvcc per source, in parallel, while the Triton kernels
            compile and are checked); print the card's name and power
            limit as nvidia-smi reports them; count the wgmma
            instructions (HGMMA, and IGMMA for s8) of each flash,
            FlashMask and int8 matmul kernel in ``cuobjdump -sass`` of
            its library: the tensor-core flash forward, dK/dV and dQ, the
            FlashMask forward, dK/dV and dQ and the w8 and w8a8 kernels
            must hold some.
2. kernels — run each hand-written kernel (paged attention in its bf16,
            f32 and int8-page modes, the w8 and w8a8 matmuls at llama_7b's
            decode shapes, every prefill width (the head's included) and
            32 rows; w8a8 bit-equal, also at 17 and 130 rows and with K
            split, each case's kernel read from a profiler window, and a
            call on fused twins bit-equal to the separate calls; the
            activation quantizer bit-equal at the activation and K/V row
            shapes of the serving passes and a misaligned view, its
            kernel and launch grid read from the trace) at the
            serving path's shapes
            against its plain PyTorch version on the card, with a stated
            tolerance; time kernel, plain version and, where one PyTorch
            call computes the same function, that call (a yardstick the
            port never uses), each as device time per call from CUDA
            graph replays; compute each kernel's bound from the bytes
            and operations of its inputs.  Each paged case's context
            splits are read from its launch grid and held against the
            plan; the paged planner's constants are timed beside other
            values (logged only).
   The top-k MoE gating kernel is held against its plain version
            (``torch.softmax`` and the routing oracle) on the same logits:
            routing identical, weights, balance loss and the backward's
            logit gradient within stated limits, at the MoE pass's decode
            and prefill shapes and at odd, drop-heavy, top-1 and top-3
            ones; two calls bit-identical; the path (one warp up to 32
            tokens, the multi-block chunk kernel above) and its launch
            grid read from the trace.
   The FlashMask forward, dK/dV and dQ kernels are held against their
            plain versions (1, 2 and 4 interval columns, causal on and
            off, 32 heads x 128 at s 2048, MHA and 32/8 GQA, bf16 and f32,
            a ragged s 1000 with 2 mask heads, fully masked rows exactly
            0; each case's forward and backward kernels read from
            profiler windows: bf16 on the tensor cores, f32 on the CUDA
            cores), timed at
            the flashmask phase's doc_causal case beside
            ``scaled_dot_product_attention`` with the same dense mask;
            without its kernel library ``F.flashmask_attention`` must
            raise.
   The training path's kernels are held and timed too, at llama_small's
            training shapes (batch 8 x sequence 1024): the flash dK/dV and
            dQ kernels (bf16 and f32, GQA, sq < sk, ragged lengths; the
            yardstick is ``scaled_dot_product_attention``'s backward, its
            kernels' device time from a profiler window), the RoPE
            backward launch (the RoPE kernel with -sin), and the forward
            kernels at those shapes.
   The flash forward is also timed at the MoE pass's decode call (b 8,
            one query over 544 columns, 32/8 heads, d 128), and the
            CUDA-core forward and dK/dV kernels (every f32 call's) at
            f32 cases.
   flashmask — ``F.flashmask_attention`` forward, then
            ``out.backward(dO)``, bf16, b 1 x 8192 packed tokens, head
            dim 128, five masks: doc_causal (32/32 and 32/8 heads),
            sliding_window (4096), doc_bidirectional and causal_full
            (timed beside the causal flash kernels and held against
            them; its forward, dK/dV and dQ kernels alone beside the
            flash forward, dK/dV and dQ kernels, their bounds, their
            plain versions and ``scaled_dot_product_attention`` with
            ``is_causal``); launch counters zeroed just before and read
            just after: one launch of each FlashMask kernel per forward
            + backward, no other kernel; then one profiler window over a
            bf16 forward + backward must show the three tensor-core
            FlashMask kernels and none of the CUDA-core ones.  Prints
            forward and forward+backward ms p50, tokens/s, peak memory
            and the share of 64 x 64 tiles skipped.
3. small   — a small f32 model served on the card (kernels, the
            engine's steps as CUDA graphs) and on the CPU (plain
            versions, eager) from the same weights, unquantized and
            with int8 weights (w8, w8a8) and int8 KV pages: the greedy
            token streams must agree, and the card's engine must have
            replayed graphs.  small-train: a small f32 model trains
            5 AdamW steps on the card and on the CPU from the same
            weights and batches: the per-step losses must agree.
            small-moe: a small f32 MoE model's greedy ``generate`` streams
            equal card vs CPU.  small-generate: the small f32 model's
            ``PagedGenerator`` greedy tokens on the card (graphs) equal
            the CPU's and its dense ``generate``'s on the card.
            small-legacy: the small f32 model through the engine's legacy
            composition (``unified_step=False``): greedy streams on the
            card equal the CPU's legacy ones and the card's unified ones,
            unchunked and chunked; then, each under its own fault plan
            (``paddle_tpu_torch.testing.faults``), a prefill fault, a
            sticky decode fault on one sequence (bisected), a transient
            decode fault (retried) and a ragged step that raises (the
            iteration re-run through the legacy composition, latched off
            after 3): exactly the poisoned request fails, the others'
            streams equal the clean run's, the pool comes back whole.
            small-lifecycle: the small f32 model through the workload
            scheduler: a ``batch`` request paused mid-prefill or
            mid-decode by an ``interactive`` one resumes with the CPU's
            and the unpreempted stream (greedy and sampled, unified and
            legacy); a TTL, a queue-wait deadline, a timed-out
            ``result``, ``max_queue=1``, ``drain(reject_queued=True)``, a
            submit after it, the resume TTL and an unknown class each end
            as the JAX engine's do, with the pool whole.
            small-speculative: the small f32 model with a draft model
            (the target itself, and a bad one of another seed), spec
            tokens 3, a sampled request riding along: the engine's
            streams on the card equal the CPU's and the draft-free ones,
            unified (verify rows in the ragged step) and legacy
            (``verify``), also with a w8 target and a full-precision
            draft; a failing draft prefill downgrades (not quarantines);
            ``SpeculativeGenerator`` card = CPU = dense ``generate``.
4. serve   — llama_7b in bf16, weights drawn on the card from ``--seed``:
            8 requests through the continuous-batching engine, unchunked,
            with 256-token prefill chunks (through the unified ragged
            step, and through the legacy composition:
            ``legacy_chunked256``, a dispatch a chunk and one decode step
            an iteration, which must dispatch no ragged step and launch
            the paged kernel once a layer of each decode step; the dense
            prefix attention of its continuation chunks is timed), and
            unchunked quantized (``quantize="w8"`` and ``"w8a8"``, both
            with ``kv_quant="int8"``), the page-table width pinned at 256
            pages.  No pass may retry, quarantine or fall back: no fault
            plan is installed, so any of these is a step that raised.
            Each pass first serves a warm-up wave on the same
            engine (the same prompt lengths, other tokens), whose steps
            capture the CUDA graphs, then the measured wave, which must
            capture none and replay; printed: the warm-up's captures, the
            measured replays, the bytes the warm-up reserved, TTFT and
            TPOT p50.  The kernels' launch counters are
            zeroed just before each measured wave and read just after it
            (a replay adds its capture's launches); every
            kernel of a pass's path must have launched (a quantized pass:
            in w8 its matmul once a Linear of every forward, in w8a8 once
            a distinct activation, q|k|v and gate|up fused, 4 a layer and
            the head; the quantizer once a w8a8 matmul and twice a layer
            for int8 K/V), every request
            must complete, and one request's prefill logits must agree
            with a plain forward of the same model on the card (in f32,
            and in bf16 relative to the plain bf16 forward's own
            distance from f32; quantized, in f32 against the plain
            quantized forward); a profiler window over the bf16 prefill
            must show the tensor-core flash forward, and ones over a bf16
            w8 and a w8a8 prefill the tensor-core w8 and w8a8 kernels.
   classes — the same model, 256-token chunks, 8 slots: 8 ``batch``
            requests of 1024 prompt tokens, then 4 ``interactive`` ones
            of 128 (tenants a, b, a, b), 32 new tokens each, after a
            warm-up wave of the same shape: with classes the batch class
            is preempted 4 times and resumed 4 times and the interactive
            requests finish first; ``classes_fifo`` (all in the default
            class) preempts nothing; TTFT and TPOT p50 by class, the
            scheduler's counters by class, ms a ragged step by bucket;
            measured captures 0, no failed step, ``drain`` True with the
            pool whole.
   speculative — the same model and the unchunked pass's traffic with a
            draft model, spec tokens 4: the target as its own draft and
            a bad draft (llama_7b's widths, 2 layers, another seed)
            through the unified step, the bad one through the legacy
            composition too (the unchunked pass is the draft-free run);
            each a warm-up wave, every ragged/verify/decode and draft
            bucket captured, then the measured wave (captures 0, launch
            counters zeroed just before it) and ``drain`` (True, both
            pools whole).  The paged kernel must launch once a layer of
            every target step and every draft step; printed: TTFT, TPOT
            p50 beside the draft-free one, decode tokens/s, wall, steps,
            proposed/accepted and the acceptance rate, accept lengths,
            dispatches, graphs, launches, and in bf16 (reported, not
            required) each greedy stream's agreement with the draft-free
            one and its first divergent position, where the top-2 logit
            gap of a plain f32 forward is printed later.  Then
            ``SpeculativeGenerator`` (b1, a 128-token prompt, 32 new)
            with both drafts beside the port's ``generate``: wall,
            tokens/s, its stats, agreement, launches (flash, no paged).
5. profile — where a decode step's time goes: batch 8 at contexts 512
            and 2048, w8 with int8 KV at 512, and bf16 at 512 with the
            table pinned at 256 pages, each through the eager and the
            graphed decoder on two caches filled alike (ids equal every
            step, a logits step bit-equal): host-clock step times, then a
            ``torch.profiler`` window each for the device's busy time,
            idle share, paged kernels' time and top kernels.
   generate — ``PagedGenerator`` on the same bf16 model (bench.py's
            ``bench_paged_decode`` shape: batch 8, a 128-token prompt,
            32 new greedy tokens, 256 pages of 16): a warm-up generate
            (its prefill and multi-step graphs captured), then a timed
            one with the launch counters zeroed just before and read just
            after: it must capture nothing, and its launches must equal
            the eager ``PagedDecoder``'s prefill plus one eager decode step
            a replay (32 paged, 65 RMSNorm, 32 RoPE a step); prints
            prefill s, decode s and decode tokens/s as bench.py counts
            them, replays, graph pool bytes and a profiler window's busy
            time.  Its tokens must equal an eager generate's; in a pool of
            72 pages, where only the per-token continuation fits, graphed
            equals eager too.  ``verify`` (b 8 x 5, greedy and drawn) must
            equal the ragged step over the same full-span blocks, ids and
            accept counts, and the verify form of the paged kernel is
            timed; ``batch_context_prefill`` (contexts 0, 128 and 300,
            bucket 4) against one prefill or chunk prefill a row, held
            after the model turns f32 (below): greedy ids equal, logits
            within relative L2 3e-3, and the bf16 batched logits no
            further from f32 than twice the bf16 per-row ones; a w8a8 +
            int8 KV generate of 8 tokens must run the w8a8 matmul, the
            quantizer and the int8-page paged kernel inside its replays,
            captures 0.
6. train   — llama_small (full width and depth) in bf16 with
            ``AdamW(multi_precision=True)`` through ``jit.TrainStep``, batch
            8 x sequence 1024, one batch drawn from ``--seed`` and
            repeated: 3 warm-up steps, then 20 timed steps with the launch
            counters zeroed just before them.  Prints step ms p25/p50/p75,
            tokens/s, model FLOPs per step and ``mfu`` (their share of the
            bf16 peak), peak memory, launches per step, and the device's
            busy time and idle share from one ``torch.profiler`` window.
            Every loss must be finite, the last below the first (one
            batch memorized), and every kernel of the path launched; the
            profiler window must show the tensor-core flash forward,
            dK/dV and dQ kernels and not their CUDA-core versions.
7. moe     — ``LlamaMoeForCausalLM`` at Mixtral-8x7B-v0.1's widths cut to 8
            of 32 layers, bf16 with f32 gates (so every MoE layer routes
            through the gating kernel), weights drawn on the card from
            ``--seed``, eval: greedy ``generate`` of 32 tokens for 8
            prompts of 512 tokens (33 forwards), launch counters zeroed
            just before it and read just after (gating 8 per forward);
            prints prefill seconds, decode ms per step, tokens/s, peak
            memory, and one ``torch.profiler`` window over decode steps
            (which must show the tensor-core flash forward).
            Then f32 logits of a 2-layer model at full width: the kernel
            path against a plain forward that replays its routing (limit
            1e-3), the routing held on its own against the plain routing
            of the same logits.

The line before the last is the kernels' JSON record: each kernel's
``launches`` is its count on its main path (the unchunked serve pass,
the engine's default, for the serving kernels; the train pass for the
two backward kernels; the w8 or w8a8 pass for the quantized matmuls; the
moe pass for the gating kernel; the flashmask phase for the FlashMask
kernels), ``launches_by_path`` its count in every pass (``generate``:
the timed ``PagedGenerator`` call), ``train_shape`` the times of a
serving kernel at the training shapes, ``decode`` and ``f32`` the flash
forward's decode and f32 cases (and dK/dV's f32 case), ``hgmma`` the
wgmma instructions of each instantiation; ``serve``, ``generate``,
``train``, ``moe``, ``flashmask``, ``classes`` and ``speculative`` hold
each pass's
end-to-end numbers, ``phase_s`` each phase's wall seconds.  The last
line is ``{"ok": true, "device": {...}}``.
"""
import argparse
import concurrent.futures
import contextlib
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()   # before torch's import, which takes seconds

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_S = 3.35e12       # H100 SXM HBM3
BF16_FLOP_S = 989e12        # dense bf16 tensor-core peak
F32_FLOP_S = 67e12          # f32 outside the tensor cores
INT8_OP_S = 1979e12         # dense s8 tensor-core peak
# profiler windows record device activity only: the host operators'
# events carry no device time and cost seconds of post-processing per
# window (about 0.5 s per llama_7b decode step)
DEVICE_ACTIVITY = [torch.profiler.ProfilerActivity.CUDA]

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
    "flash_attention_bwd_dkv": dict(
        route="cuda",
        source="paddle_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:182"),
    "flash_attention_bwd_dq": dict(
        route="cuda",
        source="paddle_tpu_torch/ops/csrc/flash_attention_bwd.cu",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:241"),
    "weight_only_matmul": dict(
        route="cuda", source="paddle_tpu_torch/ops/csrc/quant_matmul.cu",
        replaces="paddle_tpu/ops/pallas/quant_matmul.py:44"),
    "w8a8_matmul": dict(
        route="cuda", source="paddle_tpu_torch/ops/csrc/quant_matmul.cu",
        replaces="paddle_tpu/ops/pallas/quant_matmul.py:173"),
    # XLA ops in the JAX package (no pallas_call): the w8a8 prologue and
    # the KV pages' quantizer, one kernel here
    "dynamic_act_quant": dict(
        route="cuda", source="paddle_tpu_torch/ops/csrc/quant_matmul.cu",
        replaces="paddle_tpu/ops/pallas/quant_matmul.py:159"),
    "topk_gating": dict(
        route="cuda", source="paddle_tpu_torch/ops/csrc/moe_gating.cu",
        replaces="paddle_tpu/ops/pallas/moe_gating.py:48"),
    "flashmask_fwd": dict(
        route="cuda",
        source="paddle_tpu_torch/ops/csrc/flashmask_attention.cu",
        replaces="paddle_tpu/ops/pallas/flashmask_attention.py:72"),
    "flashmask_bwd_dkv": dict(
        route="cuda",
        source="paddle_tpu_torch/ops/csrc/flashmask_attention.cu",
        replaces="paddle_tpu/ops/pallas/flashmask_attention.py:122"),
    "flashmask_bwd_dq": dict(
        route="cuda",
        source="paddle_tpu_torch/ops/csrc/flashmask_attention.cu",
        replaces="paddle_tpu/ops/pallas/flashmask_attention.py:166"),
}
# the pass whose launch count is a kernel's ``launches``
MAIN_PATH = {name: "unchunked" for name in KERNELS}
MAIN_PATH.update(flash_attention_bwd_dkv="train",
                 flash_attention_bwd_dq="train",
                 weight_only_matmul="w8_int8kv", w8a8_matmul="w8a8_int8kv",
                 dynamic_act_quant="w8a8_int8kv", topk_gating="moe",
                 flashmask_fwd="flashmask", flashmask_bwd_dkv="flashmask",
                 flashmask_bwd_dq="flashmask")
# the paged kernel's timed long-context and chunk cases, llama_7b's 32
# heads x 128 in bf16: (label, spans, contexts, record key); chip_ab.py's
# paged phase times the same cases; the planner sweep's decode batch
PAGED_DECODE_CTX = [148, 1052, 703, 96, 881, 420, 1006, 263]
PAGED_TIMED = (
    ("decode b8 32/32 d128 bf16 ctx2048", [1] * 8, [2048] * 8, "ctx2048"),
    ("decode b1 32/32 d128 bf16 ctx4000", [1], [3999], "b1_ctx4000"),
    ("chunked256 mix: a 256-token chunk + 7 decode rows, ctx<=1024",
     [256] + [1] * 7, [717, 1011, 84, 530, 966, 311, 12, 640],
     "chunked256_mix"))
# the serve passes: (label, prefill chunk, quantize, kv_quant); their
# page-table width, pinned at ceil(max_position / page) for llama_7b, so
# a wave's bucket set does not hang on its context lengths (the JAX
# package's compile-free serving lane pins it the same way)
SERVE_TABLE_PAGES = 4096 // 16
# the profiled decode steps, batch 8: (context, quantize, kv_quant,
# min_table_pages); the last one is the first with the table pinned
PROFILE_CASES = ((512, None, None, 1), (2048, None, None, 1),
                 (512, "w8", "int8", 1), (512, None, None, SERVE_TABLE_PAGES))
# the serve passes: (label, prefill chunk, quantize, kv_quant, unified
# step); legacy_chunked256 is chunked256 through the legacy composition
# (a dispatch a chunk, then one decode step)
SERVE_PASSES = (("unchunked", None, None, None, True),
                ("chunked256", 256, None, None, True),
                ("legacy_chunked256", 256, None, None, False),
                ("w8_int8kv", None, "w8", "int8", True),
                ("w8a8_int8kv", None, "w8a8", "int8", True))
QUANT_KERNEL = {"w8": "weight_only_matmul", "w8a8": "w8a8_matmul"}
# the workload-scheduler serve passes, llama_7b bf16, unified, 256-token
# chunks, 8 slots: a wave is 8 ``batch``-class requests of 1024 prompt
# tokens, then, once the first has a chunk in, 4 ``interactive`` ones of
# 128 from tenants a, b, a, b; 32 new greedy tokens each.  Pages: 8 x 66
# + 4 x 10 + the pad page = 569 of 1024.  ``classes_fifo`` serves the
# same traffic with every request in the default class
CLASSES_BATCH, CLASSES_BATCH_PROMPT = 8, 1024
CLASSES_TENANTS, CLASSES_PROMPT, CLASSES_NEW = ("a", "b", "a", "b"), 128, 32
CLASSES_PASSES = (("classes", False), ("classes_fifo", True))
# the speculative phase on llama_7b bf16: the serve pass's traffic and
# engine (its ``unchunked`` pass is the draft-free run), spec_tokens 4,
# with the target as its own draft, and a bad draft at llama_7b's widths
# cut to 2 layers (another seed), through the unified step and the bad
# one through the legacy composition too: (label, draft, unified step);
# then SpeculativeGenerator, b1, a 128-token prompt, 32 new tokens
SPEC_K, SPEC_BAD_LAYERS = 4, 2
SPEC_PASSES = (("spec_self", "self", True), ("spec_bad", "bad", True),
               ("spec_bad_legacy", "bad", False))
SPEC_GEN_PROMPT, SPEC_GEN_NEW = 128, 32
# the training path's shapes: llama_small, batch 8 x sequence 1024
TRAIN_B, TRAIN_S, TRAIN_H, TRAIN_D, TRAIN_HIDDEN = 8, 1024, 12, 64, 768
# the generate phase: bench.py's bench_paged_decode shape at llama_7b's
# widths (batch 8, a 128-token prompt, 32 new tokens, 256 pages of 16);
# the per-token continuation is forced on 113-token prompts in a pool of
# 72 pages, which holds 113 + 31 tokens a row but not the first chunk's
# 113 + 32 (the chunk rounds up to a power of two); verify blocks of 5;
# batch_context_prefill rows as (cached context, new tokens), bucket 4
GEN_B, GEN_PROMPT, GEN_NEW, GEN_PAGES = 8, 128, 32, 256
GEN_TIGHT_PROMPT, GEN_TIGHT_PAGES = 113, 72
GEN_VERIFY_S = 5
GEN_BCP = ((0, 64), (128, 40), (300, 50))
GEN_QUANT_NEW = 8
# the MoE generate pass: Mixtral-8x7B's widths cut to 8 of its 32 layers,
# batch 8, a 512-token prompt, 32 new tokens (33 forwards); the logits
# check at 2 layers in f32
MOE_LAYERS, MOE_B, MOE_PROMPT, MOE_NEW, MOE_CHECK_LAYERS = 8, 8, 512, 32, 2
# the flashmask phase: b 1 x 8192 packed tokens, head dim 128, bf16; its
# documents (lengths 128-2048) drawn from a fixed seed, part of the cases
FM_S, FM_D, FM_DOC_SEED = 8192, 128, 0
# (case, q heads, kv heads, intervals, causal): llama_7b's attention and
# the Mixtral-8x7B widths of the moe phase (32 over 8 kv heads)
FM_CASES = (("doc_causal", 32, 32, "doc_causal", True),
            ("doc_causal_gqa", 32, 8, "doc_causal", True),
            ("sliding_window", 32, 32, "sliding_window", True),
            ("doc_bidirectional", 32, 32, "doc_bidirectional", False),
            ("causal_full", 32, 32, "causal_full", True))


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


def profiled_ms(fn, reps=10):
    """Mean device milliseconds per call of ``fn``: the summed time of
    the device kernels that ``reps`` calls launch, read from one
    ``torch.profiler`` window.  For calls a CUDA graph cannot capture (an
    autograd backward runs on the forward's stream, not the capture
    stream), where CUDA events around back-to-back calls would also count
    the host's launch gaps.  None when the profiler sees no device time."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=DEVICE_ACTIVITY) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(_device_us(e) for e in prof.key_averages())
    return busy_us / 1e3 / reps if busy_us else None


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


def sass_counts(lib_path, opcodes=("HGMMA", "IGMMA")):
    """{kernel: number of ``opcodes`` instructions} of each flash,
    FlashMask, int8 matmul and paged-attention kernel in a built library,
    from ``cuobjdump -sass`` (beside nvcc).  HGMMA (bf16) and IGMMA (s8)
    are wgmma in SASS, HMMA mma.sync, so a tensor-core kernel with none
    was not built as one."""
    from paddle_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : \S*?((?:flashmask|flash|wo|w8a8|"
                       r"paged_attention)_[a-z_]+?_kernel)(?:I(\w+?)EEv)?",
                       line)
        if fn:
            targs = fn.group(2) or ""
            args = re.findall(r"Li(\d+)E", targs)
            if re.match(r"(13__nv_bfloat16|f)?a", targs):
                args.insert(0, "i8")     # int8 pages (type code a)
            if "bfloat16" in targs:
                args.insert(0, "bf16")
            elif targs.startswith("f"):
                args.insert(0, "f32")
            name = f"{fn.group(1)}<{','.join(args)}>"
            counts[name] = 0
        elif "Function :" in line:
            name = None
        elif name is not None and any(op in line for op in opcodes):
            counts[name] += 1
    return counts


WINDOW_TRIES = 6


def _short_kernel(key):
    """``name<template args>`` of a profiler kernel entry's signature."""
    m = re.search(r"(\w+_kernel)(<[^(]*>)?", key)
    return m.group(0).replace(" ", "") if m else key


def profiler_window(fn, lacks, where):
    """A ``torch.profiler`` window around one call of ``fn``, opened again
    while ``lacks(names)`` (the device kernel entries the window
    recorded) returns what it misses.  CUPTI now and then drops the
    kernel records of a window in which it asks for a new activity
    buffer: the window then holds an "Activity Buffer Request" span
    inside a launch and lacks that launch's kernel (or the ones before
    it), at times in several windows in a row.  The kernels a call takes
    are fixed by its shapes and types, so such a window is opened again,
    after a pause that doubles each time, up to ``WINDOW_TRIES`` windows,
    each logged.  Returns (the last window, its names, what it lacks)."""
    for i in range(WINDOW_TRIES):
        if i:
            time.sleep(0.05 * 2 ** i)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=DEVICE_ACTIVITY) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        names = [e.key for e in events if _device_us(e) > 0]
        missing = lacks(names)
        if not missing:
            break
        asked = any(e.key == "Activity Buffer Request" for e in events)
        log(f"  {where}: profiler window {i + 1} of {WINDOW_TRIES} "
            f"recorded {len(names)} kernels, not {missing}"
            + (" (CUPTI asked for an activity buffer in it)" if asked
               else "")
            + ("; opened again" if i + 1 < WINDOW_TRIES else ""))
    return prof, names, missing


def window_seeing(fn, where, want, refuse):
    """A ``profiler_window`` around one call of ``fn`` in which every
    kernel whose name holds a string of ``want`` ran and none holding one
    of ``refuse`` (the bf16 paths must take the tensor-core kernels).  A
    refused kernel in any window fails at once, and so does a wanted one
    missing from every window."""
    def lacks(names):
        stray = [r for r in refuse if any(r in n for n in names)]
        if stray:
            raise AssertionError(f"{where}: device kernels {stray} ran off "
                                 "the path")
        return [w for w in want if not any(w in n for n in names)]

    prof, _names, missing = profiler_window(fn, lacks, where)
    if missing:
        raise AssertionError(f"{where}: device kernels {missing} never ran "
                             f"in {WINDOW_TRIES} profiler windows")
    return prof


def kernels_of(fn, grids=False, want=()):
    """Short names (``name<template args>``) of the device kernels that one
    call of ``fn`` runs, from a ``profiler_window``, opened again while it
    recorded no kernel at all (every call here launches one) or none
    named by a prefix in ``want``; the caller holds the names against its
    plan.  With ``grids``, also {short name without template args:
    (launch grid, block)}, as the window's exported trace records each
    kernel launch."""
    def lacks(names):
        short = [_short_kernel(n) for n in names]
        return [w for w in want if not any(n.startswith(w) for n in short)] \
            or ([] if names else ["any kernel"])

    prof, names, _missing = profiler_window(fn, lacks, "kernels_of")
    names = {_short_kernel(n) for n in names}
    if not grids:
        return sorted(names)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    launch = {}
    for e in events:
        m = re.search(r"(\w+_kernel)", e.get("name", ""))
        if e.get("cat") == "kernel" and m and "grid" in e.get("args", {}):
            launch[m.group(1)] = (list(e["args"]["grid"]),
                                  list(e["args"].get("block", [])))
    return sorted(names), launch


def w8a8_kernel(m, k):
    """The kernel a w8a8 call of m rows and depth k must take."""
    if m <= 16:
        return "w8a8_mma_skinny_kernel"
    return "w8a8_wgmma_kernel" if k % 16 == 0 else "w8a8_mma_tiled_kernel"


def bound_ms(n_bytes, n_ops, flop_s):
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / flop_s
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def rope_bytes(q, k, positions, table_rows):
    """Bytes a RoPE call must move: q and k read and written once, the
    positions read, and each distinct f32 cos and sin table row that the
    positions reach read once (tokens at one position share its row)."""
    s, half = q.shape[1], q.shape[-1] // 2
    idx = (positions.long()[:, None]
           + torch.arange(s, device=positions.device)[None])
    rows = int(torch.unique(idx.clamp(0, table_rows - 1)).numel())
    return (2 * (q.numel() + k.numel()) * q.element_size()
            + 2 * rows * half * 4 + positions.numel() * 4)


# ------------------------------------------------------------- kernels
def paged_kernels(pa, q, kv_heads, width, dtype, sms):
    """The plan of a paged call of these shapes: the device kernels it
    must run (the tensor-core kernel for bf16 blocks of 16 or more rows,
    else the CUDA-core one, and the combine where the context is split)
    and its number of context splits."""
    b, max_q, q_heads, d = q.shape
    per_block = pa.block_rows(dtype, max_q * (q_heads // kv_heads))
    _split, n_split = pa.plan_splits(b, max_q, q_heads, kv_heads, d, width,
                                     16, per_block, sms)
    want = {"paged_attention_mma_kernel" if per_block == 64
            else "paged_attention_decode_kernel"}
    if n_split > 1:
        want.add("paged_attention_combine_kernel")
    return want, n_split


def paged_inputs(pa, gen, rng, dev, dtype, q_heads, kv_heads, d, spans,
                 ctxs, int8=False, page=16):
    """One ragged paged call's inputs: row i holds ``spans[i]`` queries
    after ``ctxs[i]`` cached tokens, its pages drawn at random from one
    pool, its table padded to a power of two as the ragged step pads it.
    Returns ((q, k_pages, v_pages, lengths, q_lens, tables), the int8
    scales as keywords, the lengths on the host)."""
    lens = np.asarray(ctxs, np.int64) + np.asarray(spans)
    need = [-(-int(n) // page) for n in lens]
    total = sum(need) + 1
    width = 1 << (max(need) - 1).bit_length()
    perm = rng.permutation(total)
    tables = np.zeros((len(spans), width), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = perm[at:at + n]
        at += n
    kp, vp = (torch.randn(kv_heads, total, page, d, generator=gen,
                          device=dev).to(dtype) for _ in range(2))
    sc = {}
    if int8:       # int8 pages with their per-slot scales
        kp, ks = pa.quantize_kv(kp)
        vp, vs = pa.quantize_kv(vp)
        sc = dict(k_scales=ks, v_scales=vs)
    q = torch.randn(len(spans), max(spans), q_heads, d, generator=gen,
                    device=dev).to(dtype)
    meta = [torch.as_tensor(x, dtype=torch.int32, device=dev)
            for x in (lens, spans, tables)]
    return (q, kp, vp, *meta), sc, lens


def paged_cold_call(pa, args, sc):
    """A paged call that reads its pools from cycles of copies larger
    than the L2 (``cold_inputs``), for timing."""
    q, kp, vp, *meta = args
    pools = [cold_inputs(t) for t in (kp, vp, *sc.values())]

    def call():
        k_, v_, *s_ = (next(p) for p in pools)
        return pa.paged_attention_cuda(q, k_, v_, *meta,
                                       **dict(zip(sc, s_)))
    return call


def paged_plan_sweep(pa, gen, rng, dev):
    """The paged planner's constants (``SPLIT_TOKENS``, ``BLOCKS_PER_SM``,
    ``CHUNK_QUERIES``) and the one-row decode block, each timed beside
    other values on the cases that decide it: 32 heads x 128 in bf16 (the
    verify case over 8 kv heads; int8 pages where named), 16-token pages,
    pools read cold.  Each value is timed twice, in turns (a, b, c, c, b,
    a); the readings are logged with the number of splits each value
    plans, and no record keeps them."""
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk_ctx = PAGED_TIMED[2][2]
    cases = {"decode b8 ctx<=1056": ([1] * 8, PAGED_DECODE_CTX, 32),
             "int8 decode b8 ctx<=1056": ([1] * 8, PAGED_DECODE_CTX, 32),
             "decode b8 ctx512": ([1] * 8, [512] * 8, 32),
             "decode b8 ctx2048": ([1] * 8, [2048] * 8, 32),
             "decode b1 ctx4000": ([1], [3999], 32),
             "chunked256 mix": ([256] + [1] * 7, chunk_ctx, 32),
             "chunked64 mix": ([64] + [1] * 7, chunk_ctx, 32),
             "verify b8 x5 gqa 32/8": ([5] * 8, [1500, 700, 2000, 100, 1800,
                                                 900, 1200, 300], 8)}
    one_row = pa.block_rows

    def four_rows(dtype, rows):
        return 4 if rows == 1 else one_row(dtype, rows)
    decode = ("decode b8 ctx<=1056", "int8 decode b8 ctx<=1056",
              "decode b8 ctx2048", "decode b1 ctx4000")
    sweeps = (
        ("SPLIT_TOKENS", (256, 128, 512),
         decode + ("decode b8 ctx512", "verify b8 x5 gqa 32/8")),
        ("BLOCKS_PER_SM", (16, 8, 32),
         ("decode b8 ctx<=1056", "decode b8 ctx2048")),
        ("CHUNK_QUERIES", (64, 5, 1 << 30),
         ("chunked256 mix", "chunked64 mix", "verify b8 x5 gqa 32/8")),
        ("block_rows", (one_row, four_rows), decode))
    calls = {}
    for attr, values, keys in sweeps:
        for key in keys:
            spans, ctxs, kvh = cases[key]
            if key not in calls:
                args, sc, _ = paged_inputs(pa, gen, rng, dev, bf16, 32, kvh,
                                           128, spans, ctxs,
                                           int8=key.startswith("int8"))
                calls[key] = (args, paged_cold_call(pa, args, sc))
            args, call = calls[key]
            order = list(range(len(values)))
            times, plans = [[] for _ in values], [None] * len(values)
            for i in order + order[::-1]:
                setattr(pa, attr, values[i])
                try:
                    times[i].append(cuda_ms(call))
                    plans[i] = paged_kernels(pa, args[0], kvh,
                                             args[5].shape[1], bf16, sms)[1]
                finally:
                    setattr(pa, attr, values[0])
            shown = ["1-row" if v is one_row else "4-row"
                     if v is four_rows else str(v) for v in values]
            log(f"  paged sweep {attr} {key}: " + "; ".join(
                f"{s} ({n} split(s)) {t[0]:.4f}, {t[1]:.4f} ms"
                for s, n, t in zip(shown, plans, times)))


def act_quant_plan_sweep(qm, gen, dev):
    """The quantizer plan's constants, each timed beside other values on
    the shapes that decide them, bf16, inputs read cold: the row kernel's
    thread target ``ACT_ROW_THREADS`` (256; 128 and 512 give a 4096-wide
    row 4 or 1 vectors a thread) and the group kernel's two-vector rule
    (``ACT_GROUP_BLOCKS_PER_SM``: 16, or never).  Each value is timed
    twice, in turns (a, b, c, c, b, a); the readings are logged with the
    launch each value plans, and no record keeps them."""
    sms = qm._sms(dev)
    sweeps = (("ACT_ROW_THREADS", (256, 128, 512),
               ((1024, 4096), (8, 4096))),
              ("ACT_GROUP_BLOCKS_PER_SM", (16, 1 << 30),
               ((32768, 128), (256, 128))))
    for attr, values, shapes in sweeps:
        for shape in shapes:
            n = shape[0] * shape[1]
            base = (torch.randn(n, generator=gen, device=dev)
                    * 3).bfloat16()
            copies = max(2, -(-2 * (50 << 20) // (n * 2)))
            cold = itertools.cycle([base.clone().view(*shape)
                                    for _ in range(copies)])
            order = list(range(len(values)))
            times, plans = [[] for _ in values], [None] * len(values)
            for i in order + order[::-1]:
                setattr(qm, attr, values[i])
                try:
                    times[i].append(cuda_ms(
                        lambda: qm.dynamic_act_quant_cuda(next(cold)), 100))
                    plans[i] = qm.act_quant_plan(*shape, torch.bfloat16,
                                                 True, sms)
                finally:
                    setattr(qm, attr, values[0])
            log(f"  dynamic_act_quant sweep {attr} {shape}: " + "; ".join(
                f"{v} ({p[0]} {p[1]} x {p[2]}, param {p[3]}) {t[0]:.4f}, "
                f"{t[1]:.4f} ms" for v, p, t in zip(values, plans, times)))


def check_paged(records, dev):
    from paddle_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rec_all = records["paged_attention"] = {}

    def case(label, dtype, q_heads, kv_heads, d, spans, ctxs, timed=None,
             int8=False):
        args, sc, lens = paged_inputs(pa, gen, rng, dev, dtype, q_heads,
                                      kv_heads, d, spans, ctxs, int8)
        q, ql_t = args[0], args[4]

        def call():
            return pa.paged_attention_cuda(*args, **sc)
        out = call()
        ref = pa._ragged_plain(*args, 1.0 / d ** 0.5, **sc)
        torch.cuda.synchronize()
        # positions past a row's span are bucket padding: the plain
        # version computes discarded values there, the kernel zeros
        real = (torch.arange(q.shape[1], device=dev)[None, :]
                < ql_t[:, None])[:, :, None, None]
        if float((out.float() * ~real).abs().max()) != 0.0:
            raise AssertionError(f"paged_attention {label}: bucket pad "
                                 "positions are not zero")
        err = check("paged_attention", label, out * real, ref * real,
                    2e-2 if dtype == torch.bfloat16 else 1e-4)
        # the device kernels the call ran and the paged kernel's launch
        # grid, (row tiles, context splits, rows x kv heads), from an
        # uncounted profiler window, against the plan
        want, plan = paged_kernels(pa, q, kv_heads, args[5].shape[1], dtype,
                                   sms)
        ran, grids = kernels_of(call, grids=True, want=want)
        main = [g for n, (g, _block) in grids.items()
                if n != "paged_attention_combine_kernel"]
        n_split = main[0][1] if len(main) == 1 else None
        log(f"  paged_attention {label}: device kernels {ran}, launch grids "
            f"{grids}: {n_split} context split(s) (plan {plan})")
        short = {n.split("<")[0] for n in ran}
        if short != want or n_split != plan:
            raise AssertionError(f"paged_attention {label}: ran {ran} with "
                                 f"grids {grids}, expected {sorted(want)} "
                                 f"and {plan} split(s)")
        if not timed:
            return
        ms = cuda_ms(paged_cold_call(pa, args, sc))
        plain_ms = cuda_ms(lambda: pa._ragged_plain(
            *args, 1.0 / d ** 0.5, **sc), reps=3)
        el = q.element_size()
        # K/V of every row's context, read once per kv head (int8: one
        # byte each plus an f32 scale per slot and head); q and out
        per_slot = d * args[1].element_size() + (4 if int8 else 0)
        n_bytes = (int(lens.sum()) * kv_heads * per_slot * 2
                   + 2 * int(sum(spans)) * q_heads * d * el)
        visible = sum(int(min(n, n - s + 1 + j))
                      for n, s in zip(lens, spans) for j in range(s))
        n_ops = 4 * visible * q_heads * d
        bms, by = bound_ms(n_bytes, n_ops, BF16_FLOP_S)
        log(f"  paged_attention {label}: {ms:.4f} ms (pools read cold), "
            f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, library_ms=None, case=label,
                   n_split=n_split, device_kernels=ran)
        if timed == "main":
            rec_all.update(rec)
        else:
            rec_all[timed] = rec

    bf16, f32 = torch.bfloat16, torch.float32
    decode_ctx = list(rng.integers(64, 1056, 8))
    case("decode b8 32/32 d128 bf16 ctx<=1056", bf16, 32, 32, 128,
         [1] * 8, decode_ctx, timed="main")
    mix_spans = [1, 7, 64, 1, 7, 64, 1, 1]
    mix_ctx = list(rng.integers(0, 1984, 8))
    case("ragged spans 1/7/64 32/32 d128 bf16 ctx<=2048", bf16, 32, 32,
         128, mix_spans, mix_ctx)
    case("ragged gqa 32/8 d128 bf16", bf16, 32, 8, 128, mix_spans, mix_ctx)
    case("ragged 32/32 d128 f32", f32, 32, 32, 128, mix_spans, mix_ctx)
    case("ragged gqa 8/2 d64 bf16", bf16, 8, 2, 64, mix_spans, mix_ctx)
    case("verify full spans 32/32 bf16", bf16, 32, 32, 128, [5] * 4,
         [100, 700, 1500, 3])
    # the int8 KV mode, at the same tolerances (both sides attend the
    # same dequantized values)
    case("int8 decode b8 32/32 d128 bf16 ctx<=1056", bf16, 32, 32, 128,
         [1] * 8, decode_ctx, timed="int8", int8=True)
    case("int8 ragged spans 1/7/64 32/32 d128 bf16", bf16, 32, 32, 128,
         mix_spans, mix_ctx, int8=True)
    case("int8 ragged gqa 32/8 d128 bf16", bf16, 32, 8, 128, mix_spans,
         mix_ctx, int8=True)
    case("int8 ragged 32/32 d128 f32", f32, 32, 32, 128, mix_spans, mix_ctx,
         int8=True)
    case("int8 verify full spans gqa 8/2 d64 bf16", bf16, 8, 2, 64, [5] * 4,
         [100, 700, 1500, 3], int8=True)
    # long contexts (many splits) and the chunked256 pass's mix: one
    # 256-token chunk row beside 7 decode rows (the tensor-core kernel)
    for label, spans, ctxs, key in PAGED_TIMED:
        case(label, bf16, 32, 32, 128, spans, ctxs, timed=key)
    paged_plan_sweep(pa, gen, rng, dev)


# llama_7b's quantized Linears: (M, K, N) at decode (the ragged step's 8
# rows; q/k/v/o, gate/up, down, lm_head), at prefill, and odd tails
QUANT_DECODE = ((8, 4096, 4096), (8, 4096, 11008), (8, 11008, 4096),
                (8, 4096, 32000))
QUANT_PREFILL = (1024, 4096, 11008)
# the other prefill widths, timed only: q/k/v/o, down and the head
QUANT_PREFILL_MORE = ((1024, 4096, 4096), (1024, 11008, 4096),
                      (1024, 4096, 32000))
QUANT_ODD = ((77, 300, 200), (1, 4096, 32000), (5, 33, 17))
# w8a8 above 16 rows: the narrowest token tile (17 rows), a ragged 130
# (two 128-token tiles' worth in one 256-token tile) and the down
# projection at 32 rows, whose 32 output tiles split K 4 ways; bit-equal
# checks, the last one timed
QUANT_W8A8 = ((17, 4096, 11008), (130, 4096, 11008), (32, 11008, 4096))
# the activation quantizer's cases: (label, shape, dtype, misaligned):
# llama_7b's decode and prefill activations, the K/V rows of a decode step
# (b 8 x 32 kv heads) and of a 1024-token prefill (1024 x 32), an odd f32
# shape and a view 2 bytes off 16-byte alignment (the scalar edge)
ACT_QUANT_CASES = (
    ("8 x 4096 bf16", (8, 4096), torch.bfloat16, False),
    ("8 x 11008 bf16", (8, 11008), torch.bfloat16, False),
    ("1024 x 4096 bf16", (1024, 4096), torch.bfloat16, False),
    ("1024 x 11008 bf16", (1024, 11008), torch.bfloat16, False),
    ("256 x 128 bf16 (K/V decode write)", (256, 128), torch.bfloat16, False),
    ("32768 x 128 bf16 (K/V prefill write)", (32768, 128), torch.bfloat16,
     False),
    ("77 x 300 f32", (77, 300), torch.float32, False),
    ("1024 x 4096 bf16 misaligned view", (1024, 4096), torch.bfloat16,
     True))


def quant_bytes(m, k, n, el, w8a8):
    """Bytes a quantized matmul must move: the int8 weight and f32
    scales, x (int8 plus an f32 scale per row for w8a8) and y once."""
    x_bytes = m * k + m * 4 if w8a8 else m * k * el
    return n * k + n * 4 + x_bytes + m * n * el


def check_quant(records, dev):
    """The w8 and w8a8 kernels against their plain versions at llama_7b's
    shapes, bf16 and f32; times beside the plain versions and a
    yardstick the port never calls: ``F.linear`` with the bf16 twin for
    w8 (the same product at twice the weight bytes), ``torch._int_mm``
    for w8a8 (it needs M > 16: timed at M = 32 and at the prefill
    shape).  Then the no-fallback check: with the kernel library
    unbuildable, the quantized Linear raises ``KernelBuildError``."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import quant_matmul as qm
    gen = torch.Generator(device=dev).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {"weight_only_matmul": [], "w8a8_matmul": []}

    def case(m, k, n, dtype, timed):
        x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        sc = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        xq, xs = qm.dynamic_act_quant(x)
        label = f"M{m} K{k} N{n} {str(dtype).split('.')[-1]}"
        got = qm.weight_only_matmul_cuda(x, w, sc)
        ref = qm.weight_only_matmul_plain(x, w, sc)
        torch.cuda.synchronize()
        # f32: sums in another order; bf16: one rounding of each output
        err8 = check("weight_only_matmul", label, got, ref,
                     1e-5 if dtype == f32 else 1e-2)
        got = qm.w8a8_matmul_cuda(xq, xs, w, sc, dtype)
        ref = qm.w8a8_matmul_plain(xq, xs, w, sc, dtype)
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(got, ref))
        ran = kernels_of(lambda: qm.w8a8_matmul_cuda(xq, xs, w, sc, dtype),
                         want=(w8a8_kernel(m, k),))
        log(f"  w8a8_matmul {label}: kernels {ran}")
        if not any(n.startswith(w8a8_kernel(m, k)) for n in ran):
            raise AssertionError(f"w8a8_matmul {label} ran {ran}, not "
                                 f"{w8a8_kernel(m, k)}")
        # exact s32 sums and the same epilogue: bit-equal expected
        erra = check("w8a8_matmul", f"{label} bit_equal={bit_equal}", got,
                     ref, 1e-6)
        if not bit_equal:
            raise AssertionError(f"w8a8_matmul {label}: not bit-equal to "
                                 "its plain version")
        if not timed:
            return
        el = x.element_size()
        peak = BF16_FLOP_S if dtype == bf16 else F32_FLOP_S
        wb = w.to(dtype)
        ms = cuda_ms(lambda: qm.weight_only_matmul_cuda(x, w, sc))
        plain_ms = cuda_ms(lambda: qm.weight_only_matmul_plain(x, w, sc),
                           reps=3)
        lib_ms = cuda_ms(lambda: torch.nn.functional.linear(x, wb))
        bms, by = bound_ms(quant_bytes(m, k, n, el, False), 2 * m * n * k,
                           peak)
        log(f"  weight_only_matmul {label}: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, F.linear bf16 twin {lib_ms:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
        rows["weight_only_matmul"].append(dict(
            case=label, max_abs_err=err8, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=lib_ms))
        ms = cuda_ms(lambda: qm.w8a8_matmul_cuda(xq, xs, w, sc, dtype))
        plain_ms = cuda_ms(lambda: qm.w8a8_matmul_plain(xq, xs, w, sc,
                                                        dtype), reps=3)
        lib_ms = None
        if m > 16:
            wt = w.t()
            lib_ms = cuda_ms(lambda: torch._int_mm(xq, wt))
        bms, by = bound_ms(quant_bytes(m, k, n, el, True), 2 * m * n * k,
                           INT8_OP_S)
        log(f"  w8a8_matmul {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch._int_mm {lib_ms} ms, bound {bms:.4f} ms ({by})")
        rows["w8a8_matmul"].append(dict(
            case=label, max_abs_err=erra, bit_equal=bit_equal, ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
            kernels=ran))

    for m, k, n in QUANT_DECODE:
        case(m, k, n, bf16, timed=True)
        case(m, k, n, f32, timed=False)
    case(*QUANT_PREFILL, bf16, timed=True)
    case(*QUANT_PREFILL, f32, timed=False)
    for m, k, n in QUANT_PREFILL_MORE:
        case(m, k, n, bf16, timed=True)
    # the w8a8 yardstick needs M > 16
    case(32, 4096, 11008, bf16, timed=True)
    for m, k, n in QUANT_W8A8:
        case(m, k, n, bf16, timed=m == 32)
        case(m, k, n, f32, timed=False)
    for m, k, n in QUANT_ODD:
        for dtype in (bf16, f32):
            case(m, k, n, dtype, timed=False)
    # each kernel's record: the decode gate/up shape, every timed shape
    # beside it
    for name, timed in rows.items():
        head = dict(timed[1])
        head["shapes"] = timed
        records[name] = head

    # the activation quantizer: bit-equal expected (IEEE division, round
    # half to even) at every row shape of the serving passes, each path's
    # kernel and launch grid read from the trace against the plan, each
    # timed with L2-cold inputs beside its byte bound
    quant_rows = []
    for label, shape, dtype, misaligned in ACT_QUANT_CASES:
        # misaligned: a contiguous view one element past an aligned buffer
        n_el, off = int(np.prod(shape)), int(misaligned)
        base = (torch.randn(n_el + off, generator=gen, device=dev)
                * 3).to(dtype)
        x = base[off:].view(*shape)
        q, s = qm.dynamic_act_quant_cuda(x)
        pq, ps = qm.dynamic_act_quant_plain(x)
        torch.cuda.synchronize()
        if not (torch.equal(q, pq) and torch.equal(s, ps)):
            raise AssertionError(f"dynamic_act_quant {label}: not bit-equal "
                                 "to its plain version")
        err = max(check("dynamic_act_quant", label + " q bit_equal=True",
                        q, pq, 1e-6),
                  check("dynamic_act_quant", label + " scale", s, ps, 1e-6))
        rows_, K = n_el // shape[-1], shape[-1]
        kernel, grid, threads, _param = qm.act_quant_plan(
            rows_, K, dtype, not misaligned, qm._sms(dev))
        ran, launch = kernels_of(lambda: qm.dynamic_act_quant_cuda(x),
                                 grids=True, want=(kernel,))
        got = launch.get(kernel)
        log(f"  dynamic_act_quant {label}: kernels {ran}, launch {got} "
            f"(plan {kernel} grid {grid} x {threads} threads)")
        if got is None or got[0][0] != grid or got[1][0] != threads:
            raise AssertionError(f"dynamic_act_quant {label}: ran {launch}, "
                                 f"planned {kernel} grid {grid} x {threads}")
        # copies that outgrow the 50 MB L2, as cold_inputs makes them
        copies = max(2, -(-2 * (50 << 20)
                          // (base.numel() * base.element_size())))
        cold = itertools.cycle([base.clone()[off:].view(*shape)
                                for _ in range(copies)])
        ms = cuda_ms(lambda: qm.dynamic_act_quant_cuda(next(cold)), 100)
        plain_ms = cuda_ms(lambda: qm.dynamic_act_quant_plain(next(cold)),
                           20)
        bms, by = bound_ms(n_el * x.element_size() + n_el + rows_ * 4,
                           3 * n_el, F32_FLOP_S)
        log(f"  dynamic_act_quant {label}: {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bms:.4f} ms ({by}), {bms / ms:.2f} of it")
        quant_rows.append(dict(
            case=label, max_abs_err=err, bit_equal=True, ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
            kernel=kernel, grid=got[0], block=got[1]))
    # the record: the 1024 x 4096 prefill activation, every shape beside it
    records["dynamic_act_quant"] = dict(quant_rows[2], shapes=quant_rows)
    act_quant_plan_sweep(qm, gen, dev)

    # the fused w8a8 twins: one call on q|k|v's or gate|up's concatenated
    # twins is bit-equal to the separate calls
    for m in (8, 1024):
        x = torch.randn(m, 4096, generator=gen, device=dev).bfloat16()
        for widths in ((4096, 4096, 4096), (11008, 11008)):
            ws = [torch.randint(-127, 128, (n, 4096), generator=gen,
                                device=dev, dtype=torch.int8)
                  for n in widths]
            ss = [torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
                  for n in widths]
            fused = qm.w8a8_matmul(x, torch.cat(ws), torch.cat(ss))
            same = all(torch.equal(a, qm.w8a8_matmul(x, w, sc)) for a, w, sc
                       in zip(fused.split(list(widths), dim=-1), ws, ss))
            log(f"  w8a8_matmul fused M{m} N {'|'.join(map(str, widths))}: "
                f"bit-equal to the separate calls: {same}")
            if not same:
                raise AssertionError("w8a8_matmul: the fused call differs "
                                     "from the separate calls")

    def unbuildable(name):
        raise _build.KernelBuildError(f"nvcc failed on {name}.cu "
                                      "(simulated)")

    x = torch.randn(8, 4096, device=dev, dtype=bf16)
    w = torch.zeros(64, 4096, device=dev, dtype=torch.int8)
    sc = torch.ones(64, device=dev)
    layer = type("Bare", (), {"bias": None})()
    real_load, _build.load = _build.load, unbuildable
    try:
        for mode in ("w8", "w8a8"):
            try:
                qm.quant_linear_forward(layer, x, (mode, w, sc))
            except _build.KernelBuildError:
                continue
            raise AssertionError(f"{mode}: the quantized Linear did not "
                                 "raise without its kernel library")
    finally:
        _build.load = real_load
    log("  no fallback: without its kernel library the quantized Linear "
        "raises KernelBuildError (w8 and w8a8)")


def check_flash(records, dev):
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(2)

    def case(label, dtype, h, kvh, sq, sk, d, causal, timed=False, b=1):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)
        q, k, v = rnd(b, h, sq, d), rnd(b, kvh, sk, d), rnd(b, kvh, sk, d)
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
        # SDPA's causal mask is top-left aligned: at sq = 1 the
        # bottom-right mask this function uses keeps every column
        lib_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(
                             q, k, v, is_causal=causal and sq > 1,
                             enable_gqa=h != kvh))
        el = q.element_size()
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * el \
            + lse.numel() * 4
        n_ops = 4 * causal_pairs(sq, sk, causal) * d * h * q.shape[0]
        bms, by = bound_ms(n_bytes, n_ops, BF16_FLOP_S if bf else F32_FLOP_S)
        log(f"  flash_attention_forward {label}: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by})")
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, library_ms=lib_ms)
        if timed is True:
            records["flash_attention_forward"] = rec
        else:   # "decode" or "f32", after the main case
            records["flash_attention_forward"][timed] = dict(case=label,
                                                             **rec)

    bf16, f32 = torch.bfloat16, torch.float32
    case("s512 causal 32/32 d128 bf16", bf16, 32, 32, 512, 512, 128, True)
    case("s2048 causal 32/32 d128 bf16", bf16, 32, 32, 2048, 2048, 128,
         True, timed=True)
    case("sq256<sk1024 causal bf16", bf16, 32, 32, 256, 1024, 128, True)
    # SpeculativeGenerator's verify forward: k + 1 = 5 queries over the
    # cached keys, causally aligned bottom-right
    case("verify sq5 sk133 32/32 d128 bf16 causal", bf16, 32, 32, 5, 133,
         128, True)
    case("verify sq5 sk133 32/32 d128 f32 causal", f32, 32, 32, 5, 133,
         128, True)
    case("gqa 32/8 s512 causal bf16", bf16, 32, 8, 512, 512, 128, True)
    case("s512 causal f32", f32, 32, 32, 512, 512, 128, True, timed="f32")
    case("d64 sk1000 full bf16", bf16, 8, 8, 300, 1000, 64, False)
    # the MoE generate pass's decode call: one query over its context
    case("decode b8 sq1 sk544 32/8 d128 bf16", bf16, 32, 8, 1, 544, 128,
         True, timed="decode", b=8)
    case("decode b8 sq1 sk544 32/8 d128 f32", f32, 32, 8, 1, 544, 128, True,
         b=8)
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
        bms, by = bound_ms(rope_bytes(q, k, pos, cos.shape[0]),
                           3 * (q.numel() + k.numel()), F32_FLOP_S)
        log(f"  apply_rope {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bms:.4f} ms ({by})")
        records["apply_rope"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None)


def causal_pairs(sq, sk, causal):
    """(q, kv) pairs the mask lets through, per head."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, r + off + 1)) for r in range(sq))


def check_flash_bwd(records, dev):
    """The dK/dV and dQ kernels against ``_bwd_blockwise`` on the card;
    at the training shape, their times beside the plain version's and
    ``scaled_dot_product_attention``'s backward (a yardstick that
    computes dq, dk and dv together; the port never calls it)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(5)

    def case(label, dtype, b, h, kvh, sq, sk, d, causal, timed=False):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)
        q, k, v = rnd(b, h, sq, d), rnd(b, kvh, sk, d), rnd(b, kvh, sk, d)
        do = rnd(b, h, sq, d)
        scale = d ** -0.5
        out, lse = fa.flash_attention_cuda(q, k, v, causal=causal)
        got = fa.flash_attention_backward_cuda(q, k, v, out, lse, do,
                                               causal, scale)
        ref = fa._bwd_blockwise(q, k, v, out, lse, do, causal, scale)
        torch.cuda.synchronize()
        # f32: summation order; bf16: one rounding of each gradient, and
        # (dK/dV) P and dS rounded to bf16 before their products
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        errs = {}
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            if not torch.isfinite(g).all():
                raise AssertionError(f"flash backward {label}: {name} is "
                                     "not finite")
            errs[name] = check("flash_attention_bwd", f"{label} {name}", g,
                               r, tol)
        if not timed:
            return
        delta = (out.float() * do.float()).sum(-1).contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        args = (q, k, v, do, lse, delta, dq, dk, dv, causal, scale)
        dkv_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(*args))
        dq_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(*args))
        plain_ms = cuda_ms(lambda: fa._bwd_blockwise(
            q, k, v, out, lse, do, causal, scale), reps=3)
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lout = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, is_causal=causal)
        lib_ms = profiled_ms(lambda: torch.autograd.grad(
            lout, (lq, lk, lv), do, retain_graph=True))
        el = q.element_size()
        pairs = causal_pairs(sq, sk, causal) * b * h
        rows = b * h * sq * 4 * 2                    # lse and delta, f32
        dkv_bytes = (q.numel() + do.numel() + 2 * k.numel()
                     + 2 * k.numel()) * el + rows
        dq_bytes = (2 * q.numel() + do.numel() + 2 * k.numel()) * el + rows
        bf = dtype == torch.bfloat16
        for name, ms, n_ops, n_bytes, err in (
                ("flash_attention_bwd_dkv", dkv_ms, 4 * 2 * pairs * d,
                 dkv_bytes, max(errs["dk"], errs["dv"])),
                ("flash_attention_bwd_dq", dq_ms, 3 * 2 * pairs * d,
                 dq_bytes, errs["dq"])):
            bms, by = bound_ms(n_bytes, n_ops,
                               BF16_FLOP_S if bf else F32_FLOP_S)
            log(f"  {name} {label}: {ms:.4f} ms, plain (dq+dk+dv) "
                f"{plain_ms:.4f} ms, sdpa backward (dq+dk+dv, profiler) "
                f"{lib_ms} ms, bound {bms:.4f} ms ({by})")
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by, library_ms=lib_ms,
                       case=label)
            if bf:
                records[name] = rec
            else:   # after the bf16 case
                records[name]["f32"] = rec

    bf16, f32 = torch.bfloat16, torch.float32
    b, h, s, d = TRAIN_B, TRAIN_H, TRAIN_S, TRAIN_D
    case(f"b{b} h{h} s{s} d{d} causal bf16", bf16, b, h, h, s, s, d, True,
         timed=True)
    case(f"b{b} h{h} s{s} d{d} causal f32", f32, b, h, h, s, s, d, True,
         timed=True)
    case("gqa 32/8 s2048 d128 causal bf16", bf16, 1, 32, 8, 2048, 2048,
         128, True)
    case("gqa 32/8 s512 d128 causal f32", f32, 1, 32, 8, 512, 512, 128,
         True)
    case("sq300<sk1000 causal 8/2 d128 bf16", bf16, 2, 8, 2, 300, 1000,
         128, True)
    case("sq500>sk200 causal d64 f32", f32, 2, 4, 4, 500, 200, 64, True)
    case("sq77 sk333 full gqa 8/1 d64 bf16", bf16, 2, 8, 1, 77, 333, 64,
         False)


def time_train_shapes(records, dev):
    """The forward kernels and the RoPE backward launch (the RoPE kernel
    with -sin) at the training shapes (llama_small, batch 8 x 1024):
    each held against its plain version there, then timed.  Adds each
    serving kernel's ``train_shape`` record."""
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm_rope as nr
    gen = torch.Generator(device=dev).manual_seed(6)
    b, s, h, d, hid = TRAIN_B, TRAIN_S, TRAIN_H, TRAIN_D, TRAIN_HIDDEN
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    # flash forward, (b, h, s, d) as the training path's views
    q, k, v = rnd(b, h, s, d), rnd(b, h, s, d), rnd(b, h, s, d)
    label = f"b{b} h{h} s{s} d{d} causal bf16"
    out, lse = fa.flash_attention_cuda(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = check("flash_attention_forward", label, out, ref, 2e-2)
    check("flash_attention_forward", label + " lse", lse, ref_lse, 1e-4)
    ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                       reps=3)
    lib_ms = cuda_ms(lambda: torch.nn.functional
                     .scaled_dot_product_attention(q, k, v, is_causal=True))
    bms, by = bound_ms(4 * q.numel() * 2 + b * h * s * 4,
                       4 * causal_pairs(s, s, True) * b * h * d, BF16_FLOP_S)
    log(f"  flash_attention_forward {label}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms "
        f"({by})")
    records["flash_attention_forward"]["train_shape"] = dict(
        case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)

    # RMSNorm over (b, s, hidden)
    x = rnd(b * s, hid)
    w = (1 + 0.1 * torch.randn(hid, generator=gen, device=dev)).to(bf16)
    label = f"({b * s}, {hid}) bf16"
    err = check("rms_norm", label, nr.rms_norm_triton(x, w, 1e-5),
                nr.rms_norm_plain(x, w, 1e-5), 2e-2)
    xs = cold_inputs(x)
    ms = cuda_ms(lambda: nr.rms_norm_triton(next(xs), w, 1e-5), 100)
    plain_ms = cuda_ms(lambda: nr.rms_norm_plain(next(xs), w, 1e-5), 100)
    lib = getattr(torch.nn.functional, "rms_norm", None)
    lib_ms = (cuda_ms(lambda: lib(next(xs), (hid,), w, 1e-5), 100)
              if lib is not None else None)
    bms, by = bound_ms(2 * x.numel() * 2 + hid * 2, 4 * x.numel(),
                       F32_FLOP_S)
    log(f"  rms_norm {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {lib_ms} ms, bound {bms:.4f} ms ({by})")
    records["rms_norm"]["train_shape"] = dict(
        case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)

    # RoPE forward, then its backward: the same kernel with the negated
    # sin table on the cotangents of q and k; positions all 0 (the
    # shared-offset branch)
    cos, sin = (t.to(dev) for t in _rope_tables(d, 2048, 10000.0))
    neg = -sin
    pos = torch.zeros(b, dtype=torch.int32, device=dev)
    fq, fk = rnd(b, s, h, d), rnd(b, s, h, d)
    oq, ok = nr.apply_rope_triton(fq, fk, cos, sin, pos)
    rq, rk = nr.apply_rope_plain(fq, fk, cos, sin, pos)
    torch.cuda.synchronize()
    label = f"forward q,k ({b},{s},{h},{d}) bf16"
    check("apply_rope", label + " q", oq, rq, 2e-2)
    check("apply_rope", label + " k", ok, rk, 2e-2)
    gq, gk = rnd(b, s, h, d), rnd(b, s, h, d)
    oq, ok = nr.apply_rope_triton(gq, gk, cos, neg, pos)
    rq, rk = nr.apply_rope_plain(gq, gk, cos, neg, pos)
    torch.cuda.synchronize()
    label = f"backward (-sin) q,k ({b},{s},{h},{d}) bf16"
    err = max(check("apply_rope", label + " dq", oq, rq, 2e-2),
              check("apply_rope", label + " dk", ok, rk, 2e-2))
    qs, ks = cold_inputs(gq), cold_inputs(gk)
    ms = cuda_ms(lambda: nr.apply_rope_triton(next(qs), next(ks), cos, neg,
                                              pos), 100)
    plain_ms = cuda_ms(lambda: nr.apply_rope_plain(next(qs), next(ks), cos,
                                                   neg, pos), 20)
    bms, by = bound_ms(rope_bytes(gq, gk, pos, cos.shape[0]),
                       3 * (gq.numel() + gk.numel()), F32_FLOP_S)
    log(f"  apply_rope {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by})")
    records["apply_rope"]["train_shape"] = dict(
        case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None)


def gating_bytes(T, E, k):
    """Bytes the gating function must move: the f32 logits read once,
    eidx, pos, keep and w written once per assignment, fill and gsum."""
    return T * E * 4 + 16 * k * T + 8 * E


def check_moe_gating(records, dev):
    """The top-k gating kernel against its plain version (``torch.softmax``
    and the routing oracle) on the same logits: the Mixtral-width path's
    decode (T 8) and prefill (T 4096) calls and T 37 and 8192 at E 8,
    top-2, eval capacity; a tight capacity that drops most assignments;
    E 4 top-1 and E 32 top-3.  Routing (eidx, pos, keep) and the round-0
    fill must be identical, w within 1e-6 and l_aux within 1e-5
    relative, and the backward's logit gradient within 1e-5 of autograd
    of the plain version; two calls bit-identical; the kernel and launch
    grid read from the trace against the plan (one warp up to 32 tokens,
    more than one block from 4096).  Timed at the decode and prefill
    shapes; no single PyTorch call computes this function (library:
    none)."""
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_capacity
    from paddle_tpu_torch.ops import moe_gating as mg
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = [(T, 8, 2, moe_capacity(2, T, 8, 2.4), T in (8, 4096))
             for T in (8, 37, 4096, 8192)]
    cases += [(4096, 8, 2, 256, False),
              (4096, 4, 1, moe_capacity(1, 4096, 4, 2.4), False),
              (4096, 32, 3, moe_capacity(3, 4096, 32, 2.4), False),
              (64, 8, 3, 64, False)]
    timed = []
    for T, E, k, cap, time_it in cases:
        # the card model's gate logits have a standard deviation of about
        # 1.4 (unit RMS-normed rows times an XavierNormal [4096, 8] weight)
        x = torch.randn(T, E, generator=gen, device=dev) * 1.4
        label = f"T{T} E{E} k{k} C{cap}"
        if k == 3 and E == 8:
            # every gate but one or two underflows to 0: a chosen gate is
            # masked by multiplying it by 0, so later rounds pick the
            # first expert again, as the oracle does
            x = torch.zeros(T, E, device=dev)
            x[:, 2] = 200.0
            x[1::2, 5] = 200.0
            label += " underflowed gates"
        raw = mg.topk_gating_cuda(x, k, cap)
        got = mg._route(x, k, cap, True)
        want = mg.topk_gating_plain(x, k, cap, True)
        torch.cuda.synchronize()
        for name, a, b in zip(("eidx", "pos", "keep"), got[:3], want[:3]):
            if not torch.equal(a, b):
                bad = int((a != b).any(dim=0).sum())
                raise AssertionError(f"topk_gating {label}: {name} differs "
                                     f"from the plain routing on {bad} "
                                     "tokens")
        fill = torch.bincount(want[0][0].long(), minlength=E)
        if not torch.equal(raw[4].long(), fill):
            raise AssertionError(f"topk_gating {label}: fill {raw[4]} is not "
                                 f"the top-1 count {fill}")
        kept = float(want[2].float().mean())
        err = check("topk_gating", f"{label} w (routing identical, "
                    f"kept {kept:.3f})", got[3], want[3], 1e-6)
        aux_rel = abs(float(got[4]) - float(want[4])) / abs(float(want[4]))
        log(f"  topk_gating {label} l_aux: {float(got[4]):.6f} vs plain "
            f"{float(want[4]):.6f}, relative {aux_rel:.2e} (limit 1e-5)")
        if aux_rel > 1e-5:
            raise AssertionError(f"topk_gating {label}: l_aux off by "
                                 f"{aux_rel:.2e} relative")
        # backward: the kernel path's Function against autograd of the
        # plain version, same cotangents
        cw = torch.randn(k, T, generator=gen, device=dev)
        grads = []
        for fn in (mg.topk_gating, mg.topk_gating_plain):
            lg = x.clone().requires_grad_()
            _, _, _, w, l_aux = fn(lg, k, cap, True)
            ((w * cw).sum() + 3.0 * l_aux).backward()
            grads.append(lg.grad)
        check("topk_gating", f"{label} d logits", grads[0], grads[1], 1e-5)
        # the path and its launch grid, from the trace: one warp up to 32
        # tokens, the chunk kernel on its planned grid above
        kernel, threads = mg.gating_plan(T)
        ran, launch = kernels_of(lambda: mg.topk_gating_cuda(x, k, cap),
                                 grids=True, want=(kernel,))
        got_launch = launch.get(kernel)
        grid = mg.gating_grid(T, E, k)
        log(f"  topk_gating {label}: kernels {ran}, launch {got_launch} "
            f"(plan {kernel} grid {grid} x {threads} threads)")
        if got_launch is None or got_launch[0][0] != grid \
                or got_launch[1][0] != threads or (T >= 4096) != (grid > 1):
            raise AssertionError(f"topk_gating {label}: ran {launch}, "
                                 f"planned {kernel} grid {grid} x {threads}")
        # two calls are bit-identical, the gate mass included
        again = mg.topk_gating_cuda(x, k, cap)
        if not all(torch.equal(a, b) for a, b in zip(raw, again)):
            raise AssertionError(f"topk_gating {label}: two calls differ")
        if not time_it:
            continue
        ms = cuda_ms(lambda: mg.topk_gating_cuda(x, k, cap), 100)
        plain_ms = cuda_ms(lambda: mg.topk_gating_plain(x, k, cap, True),
                           reps=3)
        bms, by = bound_ms(gating_bytes(T, E, k), 8 * T * E, F32_FLOP_S)
        log(f"  topk_gating {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bms:.6f} ms ({by}), library none")
        timed.append(dict(case=label, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          library_ms=None, kernel=kernel,
                          grid=got_launch[0], block=got_launch[1]))
    # the record: the decode call (256 of a generate's 264 launches), the
    # prefill call beside it
    records["topk_gating"] = dict(timed[0], shapes=timed)


# ------------------------------------------------------------- flashmask
def doc_bounds(s, rng, lo, hi):
    """Per position, the start and end of its document: documents of
    seeded lengths lo..hi filling s tokens, the last one cut."""
    lengths = []
    while sum(lengths) < s:
        lengths.append(int(rng.integers(lo, hi + 1)))
    ends = np.minimum(np.cumsum(lengths), s)
    starts = np.concatenate([[0], ends[:-1]])
    doc = np.searchsorted(ends, np.arange(s), side="right")
    return starts[doc], ends[doc]


def fm_intervals(kind, s, rng, dev, hm=1, docs=(128, 2048), window=4096):
    """(1, hm, s, ncol) int32 FlashMask intervals (column j masks rows
    [start_j, end_j)) of one kind: ``doc_causal`` (1 column: rows from
    the end of j's document on; with causal, a packed causal document
    mask), ``sliding_window`` (2: [j + window, s), Mistral's form),
    ``doc_bidirectional`` (4: [doc end, s) and [0, doc start)),
    ``causal_full`` (1: start = s, nothing beyond causal), ``band`` (2:
    a random band per mask head and column) and ``masked_rows`` (2: rows
    [s/4, s/2) masked by every column)."""
    j = np.arange(s)
    start, end = doc_bounds(s, rng, *docs)
    if kind == "doc_causal":
        cols = [end]
    elif kind == "sliding_window":
        cols = [np.minimum(j + window, s), np.full(s, s)]
    elif kind == "doc_bidirectional":
        cols = [end, np.full(s, s), np.zeros(s), start]
    elif kind == "causal_full":
        cols = [np.full(s, s)]
    elif kind == "band":
        lo = rng.integers(0, s, (hm, s))
        cols = [lo, lo + rng.integers(0, s - lo + 1)]
    else:
        cols = [np.full(s, s // 4), np.full(s, s // 2)]
    se = np.broadcast_to(np.stack(cols, -1), (hm, s, len(cols)))
    return torch.as_tensor(np.array(se[None]), dtype=torch.int32,
                           device=dev)


def fm_keep(se, sq, causal):
    """The dense KEEP mask (b, hm, sq, sk) bool of the intervals."""
    from paddle_tpu_torch.ops.flashmask_attention import _keep
    sk = se.shape[2]
    rows = torch.arange(sq, device=se.device)[:, None]
    cols = torch.arange(sk, device=se.device)[None, :]
    return _keep(se, rows, cols, se.shape[-1], causal)


def check_flashmask(records, dev):
    """The FlashMask forward, dK/dV and dQ kernels against their plain
    versions on the card (1, 2 and 4 interval columns, causal on and
    off, MHA and GQA, bf16 and f32, a ragged length with 2 mask heads,
    fully masked rows); at the flashmask phase's doc_causal case (b 1 x
    8192, 32 heads x 128, bf16) their times beside the plain versions',
    their bounds over the pairs the mask keeps, the share of tiles that
    run, and ``scaled_dot_product_attention`` with the same dense boolean
    mask (a yardstick the port never calls)."""
    from paddle_tpu_torch.ops import flashmask_attention as fm
    gen = torch.Generator(device=dev).manual_seed(13)
    rng = np.random.default_rng(13)

    def case(label, dtype, h, kvh, s, d, kind, causal, hm=1, docs=(64, 512),
             window=512, timed=False):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)
        q, k, v, do = (rnd(1, h, s, d), rnd(1, kvh, s, d), rnd(1, kvh, s, d),
                       rnd(1, h, s, d))
        se = fm_intervals(kind, s, rng, dev, hm, docs, window)
        out, lse = fm.flashmask_fwd_cuda(q, k, v, se, causal)
        got = fm.flashmask_attention_backward(q, k, v, out, lse, do, se,
                                              causal)
        # bf16 on the tensor cores, f32 on the CUDA cores: each pass runs
        # exactly its own FlashMask kernels
        tc = "_wgmma" if dtype == torch.bfloat16 else ""
        for what, fn, want in (
                ("forward", lambda: fm.flashmask_fwd_cuda(q, k, v, se,
                                                          causal),
                 {f"flashmask_fwd{tc}_kernel"}),
                ("backward", lambda: fm.flashmask_attention_backward(
                    q, k, v, out, lse, do, se, causal),
                 {f"flashmask_bwd_dkv{tc}_kernel",
                  f"flashmask_bwd_dq{tc}_kernel"})):
            ran = kernels_of(fn, want=want)
            seen = {n.split("<")[0] for n in ran
                    if n.startswith("flashmask_")}
            if seen != want:
                raise AssertionError(f"flashmask {label}: the {what} ran "
                                     f"{ran}, not {sorted(want)}")
        ref, ref_lse = fm.flashmask_attention_plain(q, k, v, se, causal)
        want = fm.flashmask_attention_backward_plain(q, k, v, out, lse, do,
                                                     se, causal)
        torch.cuda.synchronize()
        keep = fm_keep(se, s, causal)
        dead = (~keep.any(-1)).repeat_interleave(h // hm, 1)   # (1, h, s)
        for name, t in (("out", out), ("lse", lse), ("dq", got[0]),
                        ("dk", got[1]), ("dv", got[2])):
            if not torch.isfinite(t).all():
                raise AssertionError(f"flashmask {label}: {name} is not "
                                     "finite")
        # a zero error can be real (one GEMM of the plain version may sum
        # in the kernel's order), but not against an all-zero reference
        for name, r in (("out", ref), ("dq", want[0]), ("dk", want[1]),
                        ("dv", want[2])):
            if float(r.float().abs().max()) == 0.0:
                raise AssertionError(f"flashmask {label}: the plain {name} "
                                     "is all zeros, the case checks nothing")
        bf = dtype == torch.bfloat16
        err = check("flashmask_fwd", label, out, ref, 2e-2 if bf else 1e-4)
        check("flashmask_fwd", label + " lse", lse[~dead], ref_lse[~dead],
              1e-4)
        # f32: summation order; bf16: one rounding of each gradient
        errs = {name: check(f"flashmask_bwd_{name}", label, g, r,
                            1e-2 if bf else 1e-4)
                for name, g, r in zip(("dq", "dk", "dv"), got, want)}
        if dead.any():
            ok = (float(out[dead].float().abs().max()) == 0.0
                  and bool((lse[dead] == fm.DEFAULT_MASK_VALUE).all())
                  and bool((ref_lse[dead] == fm.DEFAULT_MASK_VALUE).all())
                  and float(got[0][dead].float().abs().max()) == 0.0)
            log(f"  flashmask {label}: {int(dead.sum())} fully masked rows "
                f"give out 0, lse DEFAULT_MASK_VALUE and dq 0 exactly: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flashmask {label}: fully masked rows "
                                     "are not exact zeros")
        if not timed:
            return
        # timed: each kernel alone, given the skip table and delta
        sei = se.contiguous()
        skip = fm.flashmask_skip_table(sei, s, causal)
        delta = (out.float() * do.float()).sum(-1).contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        fwd_ms = cuda_ms(lambda: fm.flashmask_fwd_cuda(
            q, k, v, sei, causal, skip=skip))
        dkv_ms = cuda_ms(lambda: fm.flashmask_bwd_dkv_cuda(
            q, k, v, do, lse, delta, sei, dk, dv, causal, skip=skip))
        dq_ms = cuda_ms(lambda: fm.flashmask_bwd_dq_cuda(
            q, k, v, do, lse, delta, sei, dq, causal, skip=skip))
        plain_fwd = cuda_ms(lambda: fm.flashmask_attention_plain(
            q, k, v, se, causal), reps=3)
        plain_bwd = cuda_ms(lambda: fm.flashmask_attention_backward_plain(
            q, k, v, out, lse, do, se, causal), reps=3)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_fwd = profiled_ms(lambda: sdpa(q, k, v, attn_mask=keep))
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lout = sdpa(lq, lk, lv, attn_mask=keep)
        lib_bwd = profiled_ms(lambda: torch.autograd.grad(
            lout, (lq, lk, lv), do, retain_graph=True))
        pairs = int(keep.sum()) * (h // hm)          # kept (q, k) pairs
        el = q.element_size()
        rows = h * s * 4                             # one f32 per row
        ints = se.numel() * 4
        share = 1.0 - float(skip.float().mean())
        for name, ms, plain, lib, n_ops, n_bytes, e in (
                ("flashmask_fwd", fwd_ms, plain_fwd, lib_fwd, 4 * d * pairs,
                 (2 * q.numel() + k.numel() + v.numel()) * el + rows + ints,
                 err),
                ("flashmask_bwd_dkv", dkv_ms, plain_bwd, lib_bwd,
                 8 * d * pairs,
                 (2 * q.numel() + 4 * k.numel()) * el + 2 * rows + ints,
                 max(errs["dk"], errs["dv"])),
                ("flashmask_bwd_dq", dq_ms, plain_bwd, lib_bwd, 6 * d * pairs,
                 (3 * q.numel() + 2 * k.numel()) * el + 2 * rows + ints,
                 errs["dq"])):
            bms, by = bound_ms(n_bytes, n_ops, BF16_FLOP_S)
            log(f"  {name} {label}: {ms:.4f} ms, plain {plain:.4f} ms"
                f"{' (dq+dk+dv)' if 'bwd' in name else ''}, sdpa with the "
                f"mask {lib} ms, bound {bms:.4f} ms ({by}), {pairs} kept "
                f"pairs, {share:.4f} of 64x64 tiles run")
            records[name] = dict(max_abs_err=e, ms=ms, plain_ms=plain,
                                 bound_ms=bms, bound_by=by, library_ms=lib,
                                 case=label, kept_pairs=pairs,
                                 tiles_run_share=share)

    bf16, f32 = torch.bfloat16, torch.float32
    s = 2048
    case("doc 1col causal 32/32 d128 bf16", bf16, 32, 32, s, 128,
         "doc_causal", True)
    case("doc 1col causal gqa 32/8 d128 bf16", bf16, 32, 8, s, 128,
         "doc_causal", True)
    case("doc 1col full 32/32 d128 f32", f32, 32, 32, s, 128, "doc_causal",
         False)
    case("window 2col causal 32/32 d128 f32", f32, 32, 32, s, 128,
         "sliding_window", True)
    case("band 2col full gqa 32/8 d128 bf16", bf16, 32, 8, s, 128, "band",
         False)
    case("bidir 4col full 32/32 d128 bf16", bf16, 32, 32, s, 128,
         "doc_bidirectional", False)
    case("bidir 4col causal gqa 32/8 d128 f32", f32, 32, 8, s, 128,
         "doc_bidirectional", True)
    case("ragged s1000 band 2col causal 4/4 d64 hm2 bf16", bf16, 4, 4, 1000,
         64, "band", True, hm=2)
    case("ragged s1000 band 2col causal 4/4 d64 hm2 f32", f32, 4, 4, 1000,
         64, "band", True, hm=2)
    case("masked rows 2col full 8/2 d128 f32", f32, 8, 2, 512, 128,
         "masked_rows", False)
    case("masked rows 2col causal 8/8 d64 bf16", bf16, 8, 8, 512, 64,
         "masked_rows", True)
    # the flashmask phase's doc_causal case, its documents included
    rng = np.random.default_rng(FM_DOC_SEED)
    case(f"doc_causal b1 s{FM_S} 32/32 d{FM_D} bf16", bf16, 32, 32, FM_S,
         FM_D, "doc_causal", True, docs=(128, 2048), timed=True)

    # no fallback: without its kernel library F.flashmask_attention raises,
    # forward and backward
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.ops import _build

    def unbuildable(name):
        raise _build.KernelBuildError(f"nvcc failed on {name}.cu "
                                      "(simulated)")

    q, k, v = (torch.randn(1, 128, 4, 64, generator=gen, device=dev)
               .to(bf16).requires_grad_() for _ in range(3))
    se = fm_intervals("doc_causal", 128, rng, dev, docs=(16, 64))
    out = TF.flashmask_attention(q, k, v, se, causal=True)
    real_load, _build.load = _build.load, unbuildable
    try:
        for what, fn in (("forward", lambda: TF.flashmask_attention(
                q, k, v, se, causal=True)),
                         ("backward", lambda: out.backward(
                             torch.ones_like(out)))):
            try:
                fn()
            except _build.KernelBuildError:
                continue
            raise AssertionError(f"F.flashmask_attention {what} did not "
                                 "raise without its kernel library")
    finally:
        _build.load = real_load
    log("  no fallback: without its kernel library F.flashmask_attention "
        "raises KernelBuildError (forward and backward)")


def event_ms(fn):
    """Milliseconds of one synchronized call of ``fn``, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def flashmask_phase(seed, dev, card, reps=5):
    """``F.flashmask_attention`` as a training step runs it: forward, then
    ``out.backward(dO)``, bf16, b 1 x 8192 packed tokens, head dim 128,
    one case per mask (``FM_CASES``).  The launch counters are zeroed
    just before the cases and read just after them: each forward launches
    the forward kernel once, each backward the dK/dV and dQ kernels once,
    and no other kernel launches.  Then, uncounted: a profiler window
    over one forward + backward, which must run the three tensor-core
    FlashMask kernels and no CUDA-core one; each FlashMask kernel alone on
    causal_full's inputs beside the flash kernel for the same function
    (bottom-right and top-left causal alike at sq = sk), its bound, its
    plain version and SDPA with ``is_causal``; and the flash kernels'
    forward + backward timed beside causal_full's, outputs and gradients
    held against FlashMask's.  Returns the phase's record and its launch
    counts."""
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.ops import flashmask_attention as fm
    kernels = counters()
    gen = torch.Generator(device=dev).manual_seed(seed)
    rec = {"card": card, "batch": 1, "seq": FM_S, "head_dim": FM_D,
           "dtype": "bf16", "reps": reps}
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    for name, h, kvh, kind, causal in FM_CASES:
        # one document layout for every case, the same as check_flashmask's
        se = fm_intervals(kind, FM_S, np.random.default_rng(FM_DOC_SEED),
                          dev)

        def rnd(heads):
            return torch.randn(1, FM_S, heads, FM_D, generator=gen,
                               device=dev).to(torch.bfloat16)
        q, k, v = (rnd(n).requires_grad_() for n in (h, kvh, kvh))
        dout = rnd(h)

        def fwd():
            return TF.flashmask_attention(q, k, v, se, causal=causal)

        def fwd_bwd():
            for t in (q, k, v):
                t.grad = None
            out = fwd()
            out.backward(dout)
            return out.detach()

        before = {n: fn.launches for n, fn in kernels.items()}
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd()                              # first call of the shapes
        fwd_ms = [event_ms(fwd) for _ in range(reps)]
        fb_ms = [event_ms(fwd_bwd) for _ in range(reps)]
        out = fwd_bwd()
        peak = torch.cuda.max_memory_allocated()
        got = {n: fn.launches - before[n] for n, fn in kernels.items()}
        # one launch of each kernel per forward + backward, one forward
        # launch per forward alone, and no other kernel
        n_fb = reps + 2
        expect = dict(flashmask_fwd=n_fb + reps, flashmask_bwd_dkv=n_fb,
                      flashmask_bwd_dq=n_fb)
        stray = {n: c for n, c in got.items() if c != expect.get(n, 0)}
        if stray:
            raise AssertionError(f"flashmask {name}: launches {stray} in "
                                 f"{n_fb} forward+backward and {reps} "
                                 f"forward calls, expected {expect} and no "
                                 "other kernel")
        for t in (out, q.grad, k.grad, v.grad):
            if not torch.isfinite(t).all():
                raise AssertionError(f"flashmask {name}: non-finite output "
                                     "or gradient")
        fb = float(np.median(fb_ms))
        rec[name] = {
            "heads": h, "kv_heads": kvh, "ncol": se.shape[-1],
            "causal": causal, "fwd_ms_p50": float(np.median(fwd_ms)),
            "fwd_bwd_ms_p50": fb, "fwd_bwd_ms_min": float(min(fb_ms)),
            "tokens_per_s": FM_S / (fb / 1e3), "peak_memory_gb": peak / 1e9,
            "tiles_skipped_share": float(fm.flashmask_skip_table(
                se, FM_S, causal).float().mean()),
            "pairs_kept_share": float(fm_keep(se, FM_S, causal)
                                      .float().mean()),
            "launches": {n: got[n] for n in expect},
            "fwd_bwd_calls": n_fb, "fwd_calls": reps}
        log(f"flashmask {name}: " + json.dumps(rec[name]))
        if name == "causal_full":
            full = (q, k, v, dout, out, se)
    launches = {n: fn.launches for n, fn in kernels.items()}

    # the port's causal flash kernels on causal_full's inputs, uncounted
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bshd
    q, k, v, dout, out, se = full
    grads_fm = [t.grad.clone() for t in (q, k, v)]

    # a bf16 forward + backward runs the three tensor-core FlashMask
    # kernels and none of the CUDA-core ones
    def fm_fwd_bwd():
        for t in (q, k, v):
            t.grad = None
        TF.flashmask_attention(q, k, v, se, causal=True).backward(dout)

    fm_fwd_bwd()
    names = ("flashmask_fwd", "flashmask_bwd_dkv", "flashmask_bwd_dq")
    rec["kernels_seen"] = [f"{n}_wgmma_kernel" for n in names]
    window_seeing(fm_fwd_bwd, "flashmask causal_full forward + backward",
                  rec["kernels_seen"], [f"{n}_kernel" for n in names])
    log("flashmask: a bf16 forward + backward ran "
        f"{rec['kernels_seen']} and no CUDA-core FlashMask kernel")

    # each kernel alone on these inputs, FlashMask's beside the flash one
    # (the same function at sq = sk), with its bound over the kept pairs,
    # its plain version and SDPA with is_causal (a yardstick only)
    from paddle_tpu_torch.ops import flash_attention as fa
    qt, kt, vt, dot = (t.detach().transpose(1, 2) for t in (q, k, v, dout))
    ot = out.transpose(1, 2)
    _, lse = fm.flashmask_fwd_cuda(qt, kt, vt, se, True)
    delta = (ot.float() * dot.float()).sum(-1).contiguous()
    skip = fm.flashmask_skip_table(se, FM_S, True)
    bufs = [torch.empty(t.shape, dtype=t.dtype, device=dev)
            for t in (qt, kt, vt)]
    scale = FM_D ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    full_rec = rec["causal_full"]
    full_rec.update(
        fwd_ms=cuda_ms(lambda: fm.flashmask_fwd_cuda(
            qt, kt, vt, se, True, skip=skip)),
        flash_fwd_ms=cuda_ms(lambda: fa.flash_attention_cuda(
            qt, kt, vt, causal=True)),
        dkv_ms=cuda_ms(lambda: fm.flashmask_bwd_dkv_cuda(
            qt, kt, vt, dot, lse, delta, se, bufs[1], bufs[2], True,
            skip=skip)),
        flash_dkv_ms=cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
            qt, kt, vt, dot, lse, delta, *bufs, True, scale)),
        dq_ms=cuda_ms(lambda: fm.flashmask_bwd_dq_cuda(
            qt, kt, vt, dot, lse, delta, se, bufs[0], True, skip=skip)),
        flash_dq_ms=cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(
            qt, kt, vt, dot, lse, delta, *bufs, True, scale)),
        plain_fwd_ms=cuda_ms(lambda: fm.flashmask_attention_plain(
            qt, kt, vt, se, True), reps=3),
        plain_bwd_ms=cuda_ms(lambda: fm.flashmask_attention_backward_plain(
            qt, kt, vt, ot, lse, dot, se, True), reps=3),
        sdpa_fwd_ms=cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True)))
    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (qt, kt, vt))
    lout = sdpa(lq, lk, lv, is_causal=True)
    full_rec["sdpa_bwd_ms"] = profiled_ms(lambda: torch.autograd.grad(
        lout, (lq, lk, lv), dot, retain_graph=True))
    del lq, lk, lv, lout
    # operations per kept (q, k) pair of every head: 4d forward, 8d dK/dV,
    # 6d dQ; bytes as check_flashmask counts them
    pairs = int(fm_keep(se, FM_S, True).sum()) * qt.shape[1]
    el, rows, ints = qt.element_size(), qt.shape[1] * FM_S * 4, se.numel() * 4
    for name, n_ops, n_bytes in (
            ("fwd", 4, (2 * qt.numel() + kt.numel() + vt.numel()) * el
             + rows + ints),
            ("dkv", 8, (2 * qt.numel() + 4 * kt.numel()) * el + 2 * rows
             + ints),
            ("dq", 6, (3 * qt.numel() + 2 * kt.numel()) * el + 2 * rows
             + ints)):
        full_rec[f"{name}_bound_ms"], full_rec[f"{name}_bound_by"] = \
            bound_ms(n_bytes, n_ops * FM_D * pairs, BF16_FLOP_S)
        log(f"flashmask causal_full {name} alone: "
            f"{full_rec[f'{name}_ms']:.4f} ms, the flash kernel on the same "
            f"inputs {full_rec[f'flash_{name}_ms']:.4f} ms, bound "
            f"{full_rec[f'{name}_bound_ms']:.4f} ms "
            f"({full_rec[f'{name}_bound_by']}, {pairs} kept pairs)")
    log(f"flashmask causal_full plain forward "
        f"{full_rec['plain_fwd_ms']:.4f} ms, backward (dq+dk+dv) "
        f"{full_rec['plain_bwd_ms']:.4f} ms; sdpa is_causal forward "
        f"{full_rec['sdpa_fwd_ms']:.4f} ms, backward (dq+dk+dv, profiler) "
        f"{full_rec['sdpa_bwd_ms']} ms")
    del qt, kt, vt, dot, ot, lse, delta, skip, bufs

    def flash_fwd():
        return flash_attention_bshd(q, k, v, causal=True)

    def flash_fwd_bwd():
        flash_fwd().backward(dout)

    for t in (q, k, v):
        t.grad = None
    flash_fwd_bwd()
    check("flashmask", "causal_full out vs the causal flash kernel", out,
          flash_fwd().detach(), 2e-2)
    for name, t, g in zip(("dq", "dk", "dv"), (q, k, v), grads_fm):
        check("flashmask", f"causal_full {name} vs the flash kernels", g,
              t.grad, 1e-2)
    f_fwd = [event_ms(flash_fwd) for _ in range(reps)]
    f_fb = []
    for _ in range(reps):
        for t in (q, k, v):
            t.grad = None
        f_fb.append(event_ms(flash_fwd_bwd))
    rec["causal_full"]["flash_fwd_ms_p50"] = float(np.median(f_fwd))
    rec["causal_full"]["flash_fwd_bwd_ms_p50"] = float(np.median(f_fb))
    log(f"flashmask causal_full beside the flash kernels: fwd "
        f"{rec['causal_full']['flash_fwd_ms_p50']:.3f} ms, fwd+bwd "
        f"{rec['causal_full']['flash_fwd_bwd_ms_p50']:.3f} ms")
    del q, k, v, dout, out, full, grads_fm
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


# ------------------------------------------------------------- serving
def counters():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flashmask_attention as fm
    from paddle_tpu_torch.ops import fused_norm_rope as nr
    from paddle_tpu_torch.ops import moe_gating as mg
    from paddle_tpu_torch.ops import quant_matmul as qm
    from paddle_tpu_torch.ops.paged_attention import paged_attention_cuda
    return {"paged_attention": paged_attention_cuda,
            "flash_attention_forward": fa.flash_attention_cuda,
            "rms_norm": nr.rms_norm_triton,
            "apply_rope": nr.apply_rope_triton,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_cuda,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_cuda,
            "weight_only_matmul": qm.weight_only_matmul_cuda,
            "w8a8_matmul": qm.w8a8_matmul_cuda,
            "dynamic_act_quant": qm.dynamic_act_quant_cuda,
            "topk_gating": mg.topk_gating_cuda,
            "flashmask_fwd": fm.flashmask_fwd_cuda,
            "flashmask_bwd_dkv": fm.flashmask_bwd_dkv_cuda,
            "flashmask_bwd_dq": fm.flashmask_bwd_dq_cuda}


def serve(model, prompts, sharer, chunk, device, quantize=None,
          kv_quant=None, warmup=None, kernels=None, unified=True,
          draft_model=None, warm=None, drain=False):
    """Serve ``prompts`` (the last two sampled) and then ``sharer``,
    which shares prompts[0]'s first 256 tokens, once prompts[0] has its
    first token (so its prefix is cached).  With ``warmup`` (prompts,
    sharer) of the same lengths and other tokens, that wave runs first on
    the same engine, so the measured wave's buckets are captured before
    it starts; ``kernels``' launch counters are zeroed just before the
    measured wave.  The prompts of a wave are queued under the engine's
    lock, so the scheduler admits them together, as each wave.  Returns
    the measured requests, wall seconds, and the KV cache's resident
    bytes (pages, scales) with the engine's graph counts: captures in the
    warm-up and in the measured wave, the measured wave's replays, and
    the bytes the warm-up added to ``torch.cuda.memory_reserved`` (the
    graphs' pool with its staging), the measured wave's dispatches by
    mode and steps, and the engine's failure counters over both waves (retries,
    quarantines, unified fallbacks), which an ordinary pass must hold at
    0: no fault plan is installed, so a nonzero count is a kernel or
    step that raised and was absorbed.  With ``draft_model`` the engine
    speculates (``SPEC_K`` tokens), ``warm(eng)`` runs after the warm-up
    wave (its captures count as the warm-up's), the measured wave's
    speculative counters join the record, and with ``drain``
    the engine is closed with ``drain(timeout=300)`` and the pools'
    state after it recorded."""
    from paddle_tpu_torch.inference.continuous import \
        ContinuousBatchingEngine

    def wave(eng, prompts, sharer):
        reqs = []
        with eng._cond:
            for i, p in enumerate(prompts):
                sampled = i >= len(prompts) - 2
                reqs.append(eng.submit(p, max_new_tokens=32,
                                       do_sample=sampled, temperature=0.8,
                                       seed=100 + i))
        while reqs[0].first_token_at is None and not reqs[0].done.is_set():
            time.sleep(0.005)
        reqs.append(eng.submit(sharer, max_new_tokens=32))
        for r in reqs:
            r.result(timeout=600)
        if device.type == "cuda":
            torch.cuda.synchronize()
        return reqs

    info = {}
    with ContinuousBatchingEngine(model, total_pages=1024, page_size=16,
                                  max_batch=8, prefill_chunk_tokens=chunk,
                                  quantize=quantize, kv_quant=kv_quant,
                                  min_table_pages=SERVE_TABLE_PAGES,
                                  unified_step=unified,
                                  draft_model=draft_model,
                                  spec_tokens=SPEC_K,
                                  device=device) as eng:
        if warmup is not None:
            # cached blocks released on both sides, so the difference is
            # what the warm-up holds: the graphs' pool and the staging
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            wave(eng, *warmup)
            if warm is not None:
                warm(eng)
            torch.cuda.empty_cache()
            info.update(captures_warmup=eng.captures,
                        graph_pool_bytes=torch.cuda.memory_reserved(device)
                        - reserved)
        captured, replayed = eng.captures, eng.replays
        dispatched = dict(eng.dispatches)
        spec_keys = ("spec_proposed", "spec_accepted", "spec_rollbacks",
                     "spec_draft_failures")
        spec0 = {k: getattr(eng, k) for k in spec_keys}
        steps0 = eng.steps
        lens0 = list(eng.spec_accept_lens)
        for fn in (kernels or {}).values():
            fn.launches = 0
        t0 = time.perf_counter()
        reqs = wave(eng, prompts, sharer)
        wall = time.perf_counter() - t0
        info.update(captures=eng.captures - captured,
                    replays=eng.replays - replayed,
                    dispatches={m: n - dispatched[m]
                                for m, n in eng.dispatches.items()},
                    steps=eng.steps - steps0,
                    decode_retries=eng.decode_retries,
                    quarantined=eng.quarantined,
                    unified_fallbacks=eng.unified_fallbacks,
                    kv_pool_bytes=eng.cache.kv_pool_bytes,
                    kv_scale_bytes=eng.cache.kv_scale_bytes)
        if draft_model is not None:
            info.update({k: getattr(eng, k) - n for k, n in spec0.items()})
            info["spec_accept_lens"] = [
                n - m for n, m in zip(eng.spec_accept_lens, lens0)]
            info["acceptance_rate"] = (info["spec_accepted"]
                                       / max(1, info["spec_proposed"]))
            info["draft_dispatches"] = info["dispatches"]["draft"]
        if drain:
            info["drained"] = eng.drain(timeout=300)
            info["pools_after_drain"] = dict(
                free_pages=eng.cache.free_pages,
                total_pages=eng.cache.total_pages,
                reserved_pages=eng._reserved_pages,
                pad_pages=eng._pad_pages,
                draft_pages=eng.draft_pages,
                draft_free_pages=(eng.draft_cache.free_pages
                                  if draft_model is not None else None),
                draft_total_pages=(eng.draft_cache.total_pages
                                   if draft_model is not None else None),
                reserved_draft_pages=eng._reserved_draft_pages)
    return reqs, wall, info


def serve_classes(model, waves, fifo, device, kernels):
    """One engine (llama_7b's serve settings: 1024 pages of 16, 8 slots,
    256-token chunks, the table pinned at ``SERVE_TABLE_PAGES``, the
    unified step) serves ``waves[0]`` as its warm-up and then
    ``waves[1]``, the measured wave, each (batch prompts, interactive
    prompts): the batch requests are queued together under the engine's
    lock, so all 8 are admitted and every slot is held; once the first has
    a chunk in, the interactive requests are queued together, from tenants
    a, b, a, b.  In ``classes`` they are the ``batch`` and
    ``interactive`` classes, so each interactive arrival pauses a batch
    prefill and takes its slot; with ``fifo`` every request is in the
    default class and the interactive ones wait for slots.  The launch
    counters are zeroed just before the measured wave and read just after
    it.  Each ragged step of the measured wave is timed on the host
    clock (it returns after its outputs reach the host) by its bucket,
    (rows, span) rounded up to powers of two.  The engine is closed with
    ``drain(timeout=300)``.  Returns the measured (batch, interactive)
    requests, wall seconds and a record: graph counts, dispatches, the
    scheduler's counters by class over the measured wave, failure
    counters, launches, ms a ragged step by bucket, the drain's result
    and the pool's state after it."""
    from paddle_tpu_torch.inference.continuous import \
        ContinuousBatchingEngine
    from paddle_tpu_torch.inference.paged import next_pow2

    def wave(eng, batch, interactive):
        with eng._cond:
            breqs = [eng.submit(p, max_new_tokens=CLASSES_NEW,
                                priority=None if fifo else "batch")
                     for p in batch]
        while not breqs[0].prefill_pos and not breqs[0].done.is_set():
            time.sleep(0.001)
        with eng._cond:
            ireqs = [eng.submit(p, max_new_tokens=CLASSES_NEW,
                                priority=None if fifo else "interactive",
                                tenant=t)
                     for p, t in zip(interactive, CLASSES_TENANTS)]
        for r in breqs + ireqs:
            r.result(timeout=600)
        torch.cuda.synchronize()
        return breqs, ireqs

    def delta(after, before):
        return {c: {k: n - before[c][k] for k, n in cs.items()}
                for c, cs in after.items()}

    with ContinuousBatchingEngine(model, total_pages=1024, page_size=16,
                                  max_batch=8, prefill_chunk_tokens=256,
                                  min_table_pages=SERVE_TABLE_PAGES,
                                  device=device) as eng:
        wave(eng, *waves[0])
        captured, replayed = eng.captures, eng.replays
        dispatched = dict(eng.dispatches)
        counted = eng.scheduler_info()["counts"]
        ragged, steps = eng._decoder.ragged_step, {}

        def timed(cache, seq_ids, rows, ctxs, **kw):
            t = time.perf_counter()
            got = ragged(cache, seq_ids, rows, ctxs, **kw)
            key = (f"{next_pow2(len(rows))}x"
                   f"{next_pow2(max(len(r) for r in rows))}")
            steps.setdefault(key, []).append(time.perf_counter() - t)
            return got

        eng._decoder.ragged_step = timed
        _zero(kernels)
        t0 = time.perf_counter()
        breqs, ireqs = wave(eng, *waves[1])
        wall = time.perf_counter() - t0
        eng._decoder.ragged_step = ragged
        info = dict(captures_warmup=captured,
                    captures=eng.captures - captured,
                    replays=eng.replays - replayed,
                    dispatches={m: n - dispatched[m]
                                for m, n in eng.dispatches.items()},
                    counts=delta(eng.scheduler_info()["counts"], counted),
                    launches=_counts(kernels),
                    ragged_ms_by_bucket={
                        k: dict(steps=len(v), ms_mean=1e3 * sum(v) / len(v))
                        for k, v in sorted(steps.items())},
                    decode_retries=eng.decode_retries,
                    quarantined=eng.quarantined,
                    unified_fallbacks=eng.unified_fallbacks)
        info["drained"] = eng.drain(timeout=300)
        info["pool_after_drain"] = dict(
            free_pages=eng.cache.free_pages,
            total_pages=eng.cache.total_pages,
            reserved_pages=eng._reserved_pages, pad_pages=eng._pad_pages)
    return breqs, ireqs, wall, info


def classes_phase(model, seed, kernels, card):
    """The ``classes`` and ``classes_fifo`` serve passes (see
    ``serve_classes``) on the bf16 llama_7b model.  Prints and returns
    each pass's record: TTFT and TPOT p50 by class, wall seconds, the
    scheduler's counters by class, graph counts, dispatches; and the
    launches of each measured wave.  Fails unless, in ``classes``, the
    batch class was preempted 4 times and resumed 4 times and deferred
    chunks, every interactive request finished before the last batch
    request; in ``classes_fifo`` nothing was preempted; and in both the
    measured wave captured no graph, no step failed, every request
    completed, the paged, RMSNorm and RoPE kernels launched, and the
    drain returned True with the pool whole and only the pad page
    reserved."""
    rng = np.random.default_rng(seed + 1)
    vocab = model.config.vocab_size
    device = model.model.embed_tokens.weight.device

    def draw():
        return ([rng.integers(0, vocab, CLASSES_BATCH_PROMPT)
                 .astype(np.int32) for _ in range(CLASSES_BATCH)],
                [rng.integers(0, vocab, CLASSES_PROMPT).astype(np.int32)
                 for _ in CLASSES_TENANTS])

    waves = (draw(), draw())      # warm-up and measured: other tokens
    records, launches = {}, {}
    for label, fifo in CLASSES_PASSES:
        breqs, ireqs, wall, info = serve_classes(model, waves, fifo,
                                                 device, kernels)
        for r in breqs + ireqs:
            if r.error is not None or len(r.generated) != CLASSES_NEW:
                raise AssertionError(f"{label}: a request did not "
                                     f"complete ({r.error})")
        by_class = {"batch": serve_stats(breqs, wall),
                    "interactive": serve_stats(ireqs, wall)}
        rec = dict(ttft_p50_s={c: st["ttft_p50_s"]
                               for c, st in by_class.items()},
                   tpot_p50_s={c: st["tpot_p50_s"]
                               for c, st in by_class.items()},
                   wall_s=wall, card=card, **info)
        log(f"serve {label}: " + json.dumps(rec))
        counts = info["counts"]
        preempted = sum(c["preempted"] for c in counts.values())
        if fifo:
            wrong = preempted != 0
        else:
            last_batch = max(r.finished_at for r in breqs)
            wrong = (counts["batch"]["preempted"] != 4
                     or counts["batch"]["resumed"] != 4
                     or preempted != 4
                     or not counts["batch"]["deferrals"]
                     or not all(r.finished_at < last_batch for r in ireqs))
        absorbed = [info[k] for k in ("decode_retries", "quarantined",
                                      "unified_fallbacks")]
        pool = info["pool_after_drain"]
        got = info["launches"]
        missing = [n for n in ("paged_attention", "rms_norm", "apply_rope")
                   if not got[n]]
        stray = [n for n in ("weight_only_matmul", "w8a8_matmul",
                             "dynamic_act_quant") if got[n]]
        if wrong or info["captures"] or not info["replays"] \
                or any(absorbed) or missing or stray \
                or not info["drained"] \
                or pool["free_pages"] != pool["total_pages"] \
                or pool["reserved_pages"] != pool["pad_pages"]:
            raise AssertionError(
                f"{label}: counts {counts}, captures {info['captures']}, "
                f"replays {info['replays']}, failure counters {absorbed}, "
                f"kernels never launched {missing}, off the path {stray}, "
                f"drained {info['drained']}, pool {pool}")
        records[label] = rec
        launches[label] = got
        gc.collect()
        torch.cuda.empty_cache()
    log("serve classes: interactive TTFT p50 "
        f"{records['classes']['ttft_p50_s']['interactive']:.4f} s with "
        "classes, "
        f"{records['classes_fifo']['ttft_p50_s']['interactive']:.4f} s "
        "FIFO")
    return records, launches


def warm_spec_buckets(eng, unified):
    """Capture every graph a speculative wave of ``serve`` can step
    through, whatever order its rows finish in (the accept counts of a
    wave decide when each greedy row retires): the ragged step's verify
    rows (span SPEC_K + 1) at 1, 2, 4 and 8 rows, greedy and drawing,
    and its decode rows at 1 and 2 rows drawing (the two sampled
    requests left alone); legacy, ``verify`` and ``step`` at the same
    buckets; the draft's ``multi_step`` at 1, 2, 4 and 8 rows.  Rows sit
    on scratch sequences at context 0, freed after."""
    k = SPEC_K
    cache, dcache = eng.cache, eng.draft_cache

    def sampling(b, draw, ctrs=False):
        flags = np.zeros(b, bool)
        flags[0] = draw
        if ctrs:
            return (np.zeros(b, np.uint32), np.zeros(b, np.int32),
                    np.ones(b, np.float32), flags)
        return np.zeros(b, np.uint32), np.ones(b, np.float32), flags

    keys = [(b, True, draw) for b in (1, 2, 4, 8) for draw in (False, True)]
    keys += [(b, False, True) for b in (1, 2)]
    for b, verify, draw in keys:
        seqs = [f"__warm{i}" for i in range(b)]
        span = k + 1 if verify else 1
        if unified:
            eng._decoder.ragged_step(
                cache, seqs, [np.zeros(span, np.int32)] * b, [0] * b,
                n_drafts=[span - 1] * b, sampling=sampling(b, draw))
        elif verify:
            eng._decoder.verify(cache, seqs, np.zeros((b, span), np.int32),
                                np.zeros(b, np.int32),
                                sampling=sampling(b, draw))
        else:
            eng._decoder.step(cache, seqs, np.zeros((b, 1), np.int32),
                              np.zeros(b, np.int32),
                              sampling=sampling(b, draw, ctrs=True))
        for sid in seqs:
            cache.free(sid)
    for b in (1, 2, 4, 8):
        seqs = [f"__warm{i}" for i in range(b)]
        eng._draft_decoder.multi_step(dcache, seqs, np.zeros(b, np.int32),
                                      np.zeros(b, np.int32), k + 1)
        for sid in seqs:
            dcache.free(sid)
    torch.cuda.synchronize()


def first_divergence(got, want):
    """The first index where two token lists differ, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def speculative_phase(model, prompts, sharer, warmup, kernels, plain, seed,
                      card):
    """Speculative decoding on llama_7b in bf16 (the ``SPEC_PASSES``): the
    serve pass's traffic through the engine with the target as its own
    draft and with a bad draft, unified and legacy, each a warm-up wave
    (then ``warm_spec_buckets``) and a measured wave with the launch
    counters zeroed just before it, closed with ``drain``; then
    ``SpeculativeGenerator`` (b1, SPEC_GEN_PROMPT, SPEC_GEN_NEW) with
    both drafts against the port's ``generate``.  ``plain`` is the
    draft-free ``unchunked`` pass of this run (record, requests).

    Fails unless every request completes, the measured waves capture no
    graph and retry, quarantine, fall back or downgrade nothing, the
    unified passes dispatch ragged steps and no verify or decode step and
    the legacy one no ragged step, the draft proposes, the paged kernel
    launches exactly once a layer of every target step (ragged, or verify
    and decode) and of every draft step (SPEC_K + 1 a proposal), the
    flash, RMSNorm and RoPE kernels launch, and the drain returns True
    with both pools whole, only the pad headroom reserved and no draft
    page pinned.  bf16 makes exactness a report, not a check: each greedy
    stream's agreement with the draft-free one and its first divergent
    position (the top-2 logit gap there comes later, from a plain f32
    forward).  Returns the phase's record, the launches of each measured
    pass, and the divergences for the gap."""
    import dataclasses
    from paddle_tpu_torch.inference import SpeculativeGenerator
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cfg = model.config
    device = model.model.embed_tokens.weight.device
    bad = LlamaForCausalLM(
        dataclasses.replace(cfg, num_hidden_layers=SPEC_BAD_LAYERS),
        device=device, dtype=torch.bfloat16, seed=seed + 18)
    drafts = {"self": model, "bad": bad}
    plain_rec, plain_reqs = plain
    greedy_idx = [i for i in range(len(plain_reqs))
                  if not plain_reqs[i].do_sample]
    rec, launches, divergences = {}, {}, []
    for label, name, unified in SPEC_PASSES:
        layers = drafts[name].config.num_hidden_layers
        reqs, wall, info = serve(
            model, prompts, sharer, None, device, warmup=warmup,
            kernels=kernels, unified=unified, draft_model=drafts[name],
            warm=lambda eng, u=unified: warm_spec_buckets(eng, u),
            drain=True)
        got = _counts(kernels)
        disp = info["dispatches"]
        n_spec = len(greedy_idx)
        proposals = disp["draft"] - n_spec
        target_steps = (disp["ragged"] if unified
                        else disp["verify"] + disp["decode"])
        want_paged = (cfg.num_hidden_layers * target_steps
                      + (SPEC_K + 1) * layers * proposals)
        pools = info["pools_after_drain"]
        problems = []
        for i, r in enumerate(reqs):
            if r.error is not None or len(r.generated) != 32 \
                    or not all(0 <= t < cfg.vocab_size for t in r.generated):
                problems.append(f"request {i} did not complete ({r.error})")
        if info["captures"] or not info["replays"]:
            problems.append(f"measured captures {info['captures']}, "
                            f"replays {info['replays']}")
        absorbed = [info[k] for k in ("decode_retries", "quarantined",
                                      "unified_fallbacks",
                                      "spec_draft_failures")]
        if any(absorbed):
            problems.append(f"failures absorbed {absorbed}")
        if (unified and (not disp["ragged"] or disp["verify"]
                         or disp["decode"])) \
                or (not unified and (disp["ragged"] or not disp["verify"])) \
                or proposals <= 0 or not info["spec_proposed"]:
            problems.append(f"dispatches {disp}")
        if got["paged_attention"] != want_paged:
            problems.append(f"{got['paged_attention']} paged launches, want "
                            f"{want_paged}")
        missing = [n for n in ("flash_attention_forward", "rms_norm",
                               "apply_rope") if not got[n]]
        if missing:
            problems.append(f"kernels never launched: {missing}")
        if not info["drained"] or pools["free_pages"] != pools["total_pages"] \
                or pools["draft_free_pages"] != pools["draft_total_pages"] \
                or pools["reserved_pages"] != pools["pad_pages"] \
                or pools["reserved_draft_pages"] != pools["pad_pages"] \
                or pools["draft_pages"]:
            problems.append(f"drained {info['drained']}, pools {pools}")
        if problems:
            raise AssertionError(f"speculative {label}: " + "; ".join(problems))
        agree = []
        for i in greedy_idx:
            at = first_divergence(reqs[i].generated, plain_reqs[i].generated)
            agree.append(at)
            if at is not None:
                ids = np.concatenate([reqs[i].prompt, np.asarray(
                    plain_reqs[i].generated[:at], np.int32)])
                divergences.append(dict(
                    label=label, request=i, position=at, ids=ids,
                    tokens=(int(plain_reqs[i].generated[at]),
                            int(reqs[i].generated[at]))))
        stats = serve_stats(reqs, wall)
        rec[label] = dict(
            stats, card=card, draft=name, draft_layers=layers,
            unified=unified, launches=got, paged_launches_want=want_paged,
            greedy_equal_draft_free=sum(a is None for a in agree),
            greedy_requests=len(agree), first_divergence=agree,
            tpot_p50_draft_free_s=plain_rec["tpot_p50_s"],
            steps_draft_free=plain_rec["steps"],
            **{k: info[k] for k in info if k != "launches"})
        launches[label] = got
        log(f"speculative {label}: " + json.dumps(
            {k: v for k, v in rec[label].items() if k != "launches"}))
        log(f"  launches: " + json.dumps(got))
        del reqs
        gc.collect()
        torch.cuda.empty_cache()

    # the standalone generator, b1, against the port's generate
    rng = np.random.default_rng(seed + 19)
    ids = rng.integers(0, cfg.vocab_size, (1, SPEC_GEN_PROMPT))
    warm_ids = rng.integers(0, cfg.vocab_size, (1, SPEC_GEN_PROMPT))
    tids = torch.as_tensor(ids, device=device)
    model.generate(torch.as_tensor(warm_ids, device=device),
                   max_new_tokens=4)
    torch.cuda.synchronize()
    _zero(kernels)
    t0 = time.perf_counter()
    ref = model.generate(tids, max_new_tokens=SPEC_GEN_NEW).cpu().numpy()
    torch.cuda.synchronize()
    gen_rec = {"generate": dict(wall_s=time.perf_counter() - t0,
                                launches=_counts(kernels))}
    ref_new = ref[0, SPEC_GEN_PROMPT:].tolist()
    for name, draft in drafts.items():
        gen = SpeculativeGenerator(model, draft, SPEC_K)
        gen.generate(warm_ids, max_new_tokens=4)
        torch.cuda.synchronize()
        _zero(kernels)
        t0 = time.perf_counter()
        out = gen.generate(ids, max_new_tokens=SPEC_GEN_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _counts(kernels)
        new = out[0, SPEC_GEN_PROMPT:].tolist()
        if out.shape != (1, SPEC_GEN_PROMPT + SPEC_GEN_NEW) or got["paged_attention"] \
                or not all(got[n] for n in ("flash_attention_forward",
                                            "rms_norm", "apply_rope")) \
                or not all(0 <= t < cfg.vocab_size for t in new):
            raise AssertionError(f"SpeculativeGenerator draft={name}: output "
                                 f"{out.shape}, launches {got}")
        at = first_divergence(new, ref_new)
        if at is not None:
            divergences.append(dict(
                label=f"generator_{name}", request=0, position=at,
                ids=np.concatenate([ids[0], ref[0, SPEC_GEN_PROMPT:][:at]]),
                tokens=(int(ref_new[at]), int(new[at]))))
        gen_rec[name] = dict(wall_s=wall, decode_tok_s=SPEC_GEN_NEW / wall,
                             first_divergence=at, launches=got,
                             **gen.last_stats)
        log(f"speculative generator draft={name}: " + json.dumps(
            gen_rec[name]))
    gen_rec["generate"]["decode_tok_s"] = \
        SPEC_GEN_NEW / gen_rec["generate"]["wall_s"]
    log("speculative generator generate (draft-free): "
        + json.dumps(gen_rec["generate"]))
    rec["generator"] = gen_rec
    del bad, drafts
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches, divergences


def top2_gaps(model, divergences):
    """For each bf16 divergence, the top-2 logit gap of a plain f32
    forward (``plain_forward``) at the divergent position, and the two
    tokens' logits there (one forward a distinct prefix)."""
    out, seen = [], {}
    for d in divergences:
        key = d["ids"].tobytes()
        if key not in seen:
            ids = torch.as_tensor(
                d["ids"][None].astype(np.int64),
                device=model.model.embed_tokens.weight.device)
            with torch.no_grad():
                seen[key] = plain_forward(model, ids)[0]
        logits = seen[key]
        top = torch.topk(logits, 2).values
        want, got = d["tokens"]
        out.append(dict(label=d["label"], request=d["request"],
                        position=d["position"],
                        top2_gap=float(top[0] - top[1]),
                        logit_draft_free=float(logits[want]),
                        logit_speculative=float(logits[got])))
    return out


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


def time_prefix_suffix_attention(model, chunk, lengths):
    """Device ms of one call of the dense prefix attention that a
    legacy continuation chunk runs in each layer
    (``inference.paged._prefix_suffix_attention``: the JAX package's own
    dense masked attention, no kernel of its own), at the
    legacy_chunked256 pass's shape: a ``chunk``-token suffix over a page
    table pinned at ``SERVE_TABLE_PAGES`` pages of 16, the prefix the
    median of the wave's prompt lengths cut to whole chunks; pools of the
    pass's 1024 pages.  Returns {"per_call": ms, "per_chunk": ms for every
    layer, "prefix_tokens": n}."""
    from paddle_tpu_torch.inference.paged import _prefix_suffix_attention
    c = model.config
    dev, dtype = model.model.embed_tokens.weight.device, \
        model.model.embed_tokens.weight.dtype
    kvh, d = c.num_key_value_heads, c.hidden_size // c.num_attention_heads
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(1, chunk, c.num_attention_heads, d, generator=g,
                    device=dev).to(dtype)
    k_suf, v_suf = (torch.randn(1, chunk, kvh, d, generator=g, device=dev)
                    .to(dtype) for _ in range(2))
    k_pages, v_pages = (torch.randn(kvh, 1024, 16, d, generator=g,
                                    device=dev).to(dtype) for _ in range(2))
    prefix = max(chunk, int(np.median(lengths)) // chunk * chunk)
    tables = torch.zeros(1, SERVE_TABLE_PAGES, dtype=torch.int32,
                         device=dev)
    tables[0, :prefix // 16] = torch.arange(prefix // 16, device=dev)
    plens = torch.full((1,), prefix, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: _prefix_suffix_attention(q, k_suf, v_suf, k_pages,
                                                  v_pages, tables, plens))
    del k_pages, v_pages
    return {"per_call": ms, "per_chunk": ms * c.num_hidden_layers,
            "prefix_tokens": prefix}


class CodeReplay:
    """The int8 codes the kernel path's quantizer (``dynamic_act_quant``:
    the w8a8 activations and every int8 K/V write) returned in one
    prefill, in call order, replayed into the plain forward.

    Two f32 sums taken in different orders can put a value on either side
    of an int8 rounding tie, a whole quantization step apart, and random
    layers amplify that until the logits of two sound paths differ by
    1e-2 to 0.3.  Replaying the kernel path's codes removes the flips at
    their source, so the logits are held at a fixed limit; the codes are
    held on their own: each against the plain quantizer's on the plain
    path's own values, at most one step apart, on at most 1% of them,
    with scales within 1e-3 relative, the limit of the values they scale
    (a sound run on an H100 reads 4.2e-5 at full depth; a wrong rule
    moves most codes or a scale: truncation, a wrong row, or dividing by
    128 for 127, 7.9e-3)."""

    MAX_FLIP_SHARE = 1e-2
    MAX_SCALE_REL = 1e-3

    def __init__(self):
        self.codes, self.flips, self.n, self.worst_step = [], 0, 0, 0
        self.worst_scale = 0.0

    @contextlib.contextmanager
    def recording(self):
        from paddle_tpu_torch.ops import quant_matmul as qm
        kernel = qm.dynamic_act_quant_cuda

        def record(x):
            q, scale = kernel(x)
            self.codes.append((q, scale))
            return q, scale

        # the wrapper counts its launches under the module's name, which
        # is ``record`` meanwhile
        record.launches = kernel.launches
        qm.dynamic_act_quant_cuda = record
        try:
            yield
        finally:
            qm.dynamic_act_quant_cuda = kernel
            kernel.launches = record.launches

    def quantize(self, x):
        """The next recorded codes for ``x``, checked against the plain
        quantizer's codes of ``x`` itself."""
        from paddle_tpu_torch.ops import quant_matmul as qm
        own_q, own_s = qm.dynamic_act_quant_plain(x)
        if not self.codes:
            raise AssertionError("the plain forward quantized more often "
                                 "than the kernel path")
        q, scale = self.codes.pop(0)
        if q.numel() != own_q.numel():
            raise AssertionError(
                f"replayed codes of {tuple(q.shape)} for a value of "
                f"{tuple(own_q.shape)}: the two paths quantize in another "
                "order")
        q, scale = q.reshape(own_q.shape), scale.reshape(own_s.shape)
        step = (q.int() - own_q.int()).abs()
        self.flips += int((step != 0).sum())
        self.n += q.numel()
        self.worst_step = max(self.worst_step, int(step.max()))
        self.worst_scale = max(self.worst_scale, float(
            ((scale - own_s).abs() / own_s).max()))
        return q, scale

    def verdict(self):
        """Raises unless every code was replayed and the codes agree as a
        sound quantizer's do; returns the flipped share."""
        share = self.flips / max(1, self.n)
        if self.codes:
            raise AssertionError(f"{len(self.codes)} recorded quantizations "
                                 "were never replayed")
        if self.worst_step > 1 or share > self.MAX_FLIP_SHARE \
                or self.worst_scale > self.MAX_SCALE_REL:
            raise AssertionError(
                f"int8 codes of the kernel path vs the plain quantizer: "
                f"worst step {self.worst_step} (limit 1), flipped share "
                f"{share:.2e} (limit {self.MAX_FLIP_SHARE}), scales "
                f"{self.worst_scale:.2e} relative (limit "
                f"{self.MAX_SCALE_REL})")
        return share


def plain_forward(model, ids, quantize=None, kv_quant=None, replay=None):
    """The port's LLaMA forward on its plain versions (no kernel): the
    reference for the kernel path's last-token logits on the card.
    ``quantize`` runs every Linear through the plain quantized matmul with
    the same int8 twins the serving path builds (per Linear; in w8a8 the
    activation q, k and v read, and the one gate and up read, quantized
    once each, so the codes come in the kernel path's order);
    ``kv_quant`` makes attention consume the int8 round trip of K and V,
    as the pages hold them.  ``replay`` (a :class:`CodeReplay`) supplies
    the kernel path's int8 codes wherever the plain path quantizes."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    from paddle_tpu_torch.ops.flash_attention import mha_reference
    from paddle_tpu_torch.ops.fused_norm_rope import (apply_rope_plain,
                                                      rms_norm_plain)
    from paddle_tpu_torch.ops.paged_attention import dequantize_kv
    from paddle_tpu_torch.quantization.serving import \
        quantize_linear_weights
    twins = {id(layer): (w_q, sc) for layer, w_q, sc in
             (quantize_linear_weights(model) if quantize else ())}
    act_quant = replay.quantize if replay else qm.dynamic_act_quant_plain

    def linears(x, *layers):
        """The outputs of Linears that all read ``x``; in w8a8, ``x`` is
        quantized once for all of them, as the serving path's fused twins
        (q|k|v, gate|up) quantize it."""
        if not quantize:
            return [layer(x) for layer in layers]
        x2 = x.reshape(-1, x.shape[-1])
        if quantize == "w8a8":
            xq, xs = act_quant(x2)
            ys = [qm.w8a8_matmul_plain(xq, xs, *twins[id(layer)], x.dtype)
                  for layer in layers]
        else:
            ys = [qm.weight_only_matmul_plain(x2, *twins[id(layer)])
                  for layer in layers]
        return [y.reshape(*x.shape[:-1], -1) for y in ys]

    def linear(layer, x):
        return linears(x, layer)[0]

    def kv(t):
        return dequantize_kv(*act_quant(t), t.dtype) if kv_quant else t

    m = model.model
    x = m.embed_tokens(ids)
    b, s = ids.shape
    pos = torch.zeros(b, dtype=torch.int32, device=ids.device)
    for layer in m.layers:
        at, mlp = layer.self_attn, layer.mlp
        h = rms_norm_plain(x, layer.input_layernorm.weight,
                           layer.input_layernorm.epsilon)
        q, k, v = linears(h, at.q_proj, at.k_proj, at.v_proj)
        q = q.view(b, s, at.num_heads, at.head_dim)
        k = k.view(b, s, at.num_kv_heads, at.head_dim)
        v = v.view(b, s, at.num_kv_heads, at.head_dim)
        q, k = apply_rope_plain(q, k, m.rope_cos, m.rope_sin, pos)
        k, v = kv(k), kv(v)
        o = mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True).transpose(1, 2)
        x = x + linear(at.o_proj, o.reshape(b, s, -1))
        h = rms_norm_plain(x, layer.post_attention_layernorm.weight,
                           layer.post_attention_layernorm.epsilon)
        gate, up = linears(h, mlp.gate_proj, mlp.up_proj)
        x = x + linear(mlp.down_proj, torch.nn.functional.silu(gate) * up)
    # the last token only, as the serving prefill's head sees it
    x = rms_norm_plain(x[:, -1], m.norm.weight, m.norm.epsilon)
    head = model.lm_head
    return (linear(head, x) if head is not None
            else model._logits_of(x)).float()


def prefill_logits(model, ids, quantize=None, kv_quant=None):
    """Last-token logits of ``ids`` (1, s) through the serving prefill
    (kernels) and through ``plain_forward``, both on the model's card.
    Where the path quantizes activations or K/V, the plain forward replays
    the kernel path's int8 codes; the :class:`CodeReplay` comes back
    third (None otherwise)."""
    from paddle_tpu_torch.inference.paged import PagedDecoder
    from paddle_tpu_torch.ops.paged_attention import PagedKVCache
    cache = PagedKVCache.from_model(model, total_pages=32, page_size=16,
                                    kv_dtype=kv_quant)
    replay = CodeReplay() if quantize == "w8a8" or kv_quant else None
    with torch.no_grad():
        decoder = PagedDecoder(model, quantize=quantize)
        with replay.recording() if replay else contextlib.nullcontext():
            got = decoder.prefill(cache, [0], ids.cpu().numpy())
        ref = plain_forward(model, ids, quantize, kv_quant, replay)[0]
    return torch.as_tensor(got[0], device=ref.device), ref, replay


# the tensor-core kernel a bf16 prefill's quantized Linears must take (every
# one has more than 16 rows and K % 16 == 0), and the mma.sync tiles it
# must not
QUANT_PREFILL_KERNEL = {"w8": ("wo_wgmma_kernel", "wo_mma_tiled_kernel"),
                        "w8a8": ("w8a8_wgmma_kernel",
                                 "w8a8_mma_tiled_kernel")}


def quant_prefill_window(model, ids, quantize):
    """One bf16 quantized prefill of ``ids`` (1, s) in a ``torch.profiler``
    window, which must show the mode's tensor-core kernel
    (``QUANT_PREFILL_KERNEL``) and not its mma.sync tiles."""
    from paddle_tpu_torch.inference.paged import PagedDecoder
    from paddle_tpu_torch.ops.paged_attention import PagedKVCache
    want, refuse = QUANT_PREFILL_KERNEL[quantize]
    with torch.no_grad():
        decoder = PagedDecoder(model, quantize=quantize)

        def prefill():
            cache = PagedKVCache.from_model(model, total_pages=32,
                                            page_size=16)
            decoder.prefill(cache, [0], ids.cpu().numpy())

        window_seeing(prefill, f"{quantize} prefill", (want,), (refuse,))


def _small_models():
    """The small f32 LLaMA of the small checks, on the CPU and on the
    card with the same weights."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=512)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=7)
    gpu = LlamaForCausalLM(cfg, device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def check_small():
    """A small f32 model: greedy streams on the card (kernels) equal the
    CPU's (plain versions) from the same weights, unquantized and with
    int8 weights (w8, w8a8) and int8 KV pages, unchunked and chunked."""
    from paddle_tpu_torch.inference.continuous import \
        ContinuousBatchingEngine
    cpu, gpu = _small_models()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (9, 40, 130)]
    for (quant, kv), chunk in itertools.product(
            ((None, None), ("w8", "int8"), ("w8a8", "int8")), (None, 32)):
        streams, graphs = [], []
        for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
            with ContinuousBatchingEngine(model, total_pages=64,
                                          page_size=16, max_batch=4,
                                          prefill_chunk_tokens=chunk,
                                          quantize=quant, kv_quant=kv,
                                          device=dev) as eng:
                reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
                streams.append([r.result(timeout=300).tolist()
                                for r in reqs])
                graphs.append((eng.captures, eng.replays))
        label = f"quantize={quant} kv_quant={kv} chunk={chunk}"
        if streams[0] != streams[1]:
            raise AssertionError(
                f"small f32 model, {label}: greedy streams on the "
                f"card {streams[0]} differ from the CPU's {streams[1]}")
        if not graphs[0][1]:
            raise AssertionError(f"small f32 model, {label}: the card's "
                                 f"engine replayed no CUDA graph")
        log(f"  small f32 model {label}: greedy streams of "
            f"{len(prompts)} requests equal card (CUDA graphs: "
            f"{graphs[0][0]} captured, {graphs[0][1]} replays) vs CPU")


def check_small_legacy():
    """The small f32 model of ``check_small`` through the engine's legacy
    composition (``unified_step=False``: a dispatch a prompt chunk, then
    one padded decode step) and its failure isolation, on the card:

    - legacy greedy streams on the card equal the CPU's legacy streams
      and the card's unified streams, unchunked and with 32-token chunks;
    - with w8a8 weights and int8 KV pages, 32-token chunks, legacy
      greedy streams on the card equal the CPU's, and the int8 matmul and
      the quantizer launch once a quantized activation (and twice a layer
      for the KV pages) of every dispatch;
    - a ``prefill`` fault with nth=2 errors exactly that request;
    - a sticky ``decode_step`` fault on one sequence is bisected and
      ejects exactly that request;
    - a transient ``decode_step`` fault (nth=3) is retried once;
    - a ragged step that raises an injected fault falls back to the
      legacy composition with equal streams, and 3 failures latch the
      unified path off;
    - a ragged step that raises any other error fails the requests of
      that step with it, with no fallback and no latch.

    In every case the survivors' streams equal the clean run's, the pool
    comes back whole and only the pad headroom stays reserved.  Each
    fault plan is installed for its engine alone."""
    from paddle_tpu_torch.inference.continuous import \
        ContinuousBatchingEngine
    from paddle_tpu_torch.testing import faults
    cpu, gpu = _small_models()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (9, 40, 130)]

    kernels = counters()

    def run(model, dev, unified, chunk=None, plan=None, broken=None,
            quantize=None, kv_quant=None):
        """Serve the prompts as one batch; ``broken`` is the exception
        class every ragged step raises.  A request failing with a fault
        (or with ``broken``) gives None."""
        _zero(kernels)
        with contextlib.ExitStack() as stack:
            if plan is not None:
                stack.enter_context(faults.installed(faults.FaultPlan(plan)))
            eng = stack.enter_context(ContinuousBatchingEngine(
                model, total_pages=64, page_size=16, max_batch=4,
                prefill_chunk_tokens=chunk, unified_step=unified,
                quantize=quantize, kv_quant=kv_quant, device=dev))
            if broken is not None:
                def ragged_step(*a, **kw):
                    raise broken("injected ragged step failure")
                eng._decoder.ragged_step = ragged_step
            with eng._cond:         # admitted together: one batch
                reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
            outs = []
            for r in reqs:
                try:
                    outs.append(r.result(timeout=300).tolist())
                except (faults.FaultError, broken or faults.FaultError):
                    outs.append(None)
            t0 = time.monotonic()
            while eng.cache.free_pages != 64 and time.monotonic() - t0 < 30:
                time.sleep(0.01)
            state = dict(free_pages=eng.cache.free_pages,
                         reserved=eng._reserved_pages,
                         retries=eng.decode_retries,
                         quarantined=eng.quarantined,
                         fallbacks=eng.unified_fallbacks,
                         latched=eng._unified_off,
                         dispatches=dict(eng.dispatches),
                         captures=eng.captures, replays=eng.replays,
                         launches=_counts(kernels))
        if faults.active() is not None:
            raise AssertionError("a fault plan outlived its check")
        if state["free_pages"] != 64 or state["reserved"] != 1:
            raise AssertionError(f"small legacy: the pool did not come back "
                                 f"whole: {state}")
        return outs, state

    for chunk in (None, 32):
        card, st = run(gpu, "cuda", False, chunk)
        cpu_outs, _ = run(cpu, "cpu", False, chunk)
        unified, _ = run(gpu, "cuda", True, chunk)
        if not (card == cpu_outs == unified) or st["dispatches"]["ragged"] \
                or not st["replays"]:
            raise AssertionError(
                f"small f32 model legacy chunk={chunk}: card {card}, CPU "
                f"{cpu_outs}, card unified {unified}; {st}")
        log(f"  small f32 model legacy chunk={chunk}: greedy streams equal "
            f"card legacy vs CPU legacy vs card unified; dispatches "
            f"{st['dispatches']}, {st['captures']} graphs captured, "
            f"{st['replays']} replays")
        if chunk is None:
            clean = card
    # w8a8 weights and int8 KV pages: every dispatch is one forward of
    # the quantized model, which quantizes 4 activations a layer and the
    # head's and writes int8 K and V a layer
    quant = dict(quantize="w8a8", kv_quant="int8")
    card, st = run(gpu, "cuda", False, 32, **quant)
    cpu_outs, _ = run(cpu, "cpu", False, 32, **quant)
    layers = gpu.config.num_hidden_layers
    forwards = sum(st["dispatches"].values())
    want = {"w8a8_matmul": (4 * layers + 1) * forwards,
            "dynamic_act_quant": (6 * layers + 1) * forwards,
            "weight_only_matmul": 0}
    got = {k: st["launches"][k] for k in want}
    if card != cpu_outs or got != want or st["dispatches"]["ragged"] \
            or not st["replays"]:
        raise AssertionError(
            f"small f32 model legacy w8a8 int8 KV chunk=32: card {card}, "
            f"CPU {cpu_outs}; launches {got} (want {want}); {st}")
    log(f"  small f32 model legacy w8a8 int8 KV chunk=32: greedy streams "
        f"equal card vs CPU; dispatches {st['dispatches']}, launches "
        f"{got}, {st['captures']} graphs captured, {st['replays']} replays")
    # (label, fault plan, exception class of a broken ragged step, the
    # requests that must fail, the counters it must end with)
    cases = (
        ("prefill nth=2", [{"site": "prefill", "nth": 2}], None, {1},
         dict(quarantined=1, retries=0)),
        ("sticky decode_step seq 1", [{"site": "decode_step",
                                       "seq_id": 1}], None, {1},
         dict(quarantined=1, retries=5)),
        ("transient decode_step nth=3", [{"site": "decode_step",
                                          "nth": 3}], None, set(),
         dict(quarantined=0, retries=1)),
        ("ragged step raises a fault", None, faults.FaultError, set(),
         dict(quarantined=0, retries=0, fallbacks=3, latched=True)),
        ("ragged step raises another error", None, RuntimeError,
         {0, 1, 2}, dict(quarantined=3, retries=0, fallbacks=0,
                         latched=False)))
    for label, plan, broken, victims, counts in cases:
        outs, st = run(gpu, "cuda", True, plan=plan, broken=broken)
        want = [None if i in victims else o for i, o in enumerate(clean)]
        got = {k: st[k] for k in counts}
        if outs != want or got != counts:
            raise AssertionError(f"small legacy fault check {label}: "
                                 f"streams {outs} (want {want}), counters "
                                 f"{got} (want {counts})")
        log(f"  small f32 model fault check {label}: "
            + (f"requests {sorted(victims)} failed, " if victims else "")
            + f"the others' streams equal the clean run's; {got}, pool "
            f"whole, dispatches {st['dispatches']}")


def check_small_lifecycle():
    """The small f32 model of ``check_small`` through the engine's request
    lifecycle and workload scheduler, on the card and on the CPU from the
    same weights:

    - preemption: a ``batch``-class request (130 tokens, chunks of 32,
      every chunk paced by a ``delay`` rule) is paused mid-prefill by an
      ``interactive`` one in an engine of one slot; its greedy stream and
      its sampled stream on the card equal the CPU's and the card's
      unpreempted run's, through the unified step and through the legacy
      composition, with one preemption and one resume;
    - decode preemption: a decoding batch row paused by an interactive
      arrival (no prefill left to pause) resumes with the unpreempted
      stream, greedy and sampled, both compositions;
    - lifecycle, each case ending with the pool whole and only the pad
      headroom reserved: a TTL expiring mid-decode (``DeadlineExceeded``),
      a queue-wait deadline rejecting an unadmitted request, a timed-out
      ``result`` cancelling, ``max_queue=1`` raising ``EngineSaturated``
      naming the class, ``drain(reject_queued=True)`` failing the queued
      requests with ``EngineDraining`` and completing the admitted one, a
      ``submit`` after the drain raising ``EngineDraining``, the resume
      TTL reaping a paused prefill (``DeadlineExceeded``), an unknown
      class raising ``ValueError``.

    The paged, flash, RMSNorm and RoPE kernels must have launched on the
    card over the check (flash in the unchunked lifecycle cases' prefill,
    the paged kernel in its ragged and decode forms)."""
    from paddle_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine, DeadlineExceeded, EngineDraining,
        EngineSaturated)
    from paddle_tpu_torch.testing import faults
    cpu, gpu = _small_models()
    rng = np.random.default_rng(11)
    long_p = rng.integers(0, 512, 130).astype(np.int32)
    short_p = rng.integers(0, 512, 9).astype(np.int32)
    kernels = counters()
    _zero(kernels)

    def engine(model, dev, **kw):
        kw.setdefault("total_pages", 64)
        kw.setdefault("max_batch", 1)
        return ContinuousBatchingEngine(model, page_size=16, device=dev,
                                        **kw)

    def wait_for(cond, what, timeout=60.0):
        end = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > end:
                raise AssertionError(f"small lifecycle: timed out waiting "
                                     f"for {what}")
            time.sleep(0.001)

    def whole(eng, label):
        def idle():
            with eng._cond:
                return not (len(eng._sched) or eng._preempted
                            or eng._prefilling or eng._active) \
                    and eng.cache.free_pages == eng.cache.total_pages
        wait_for(idle, f"{label}: the engine idle with its pool whole")
        if eng._reserved_pages != eng._pad_pages:
            raise AssertionError(f"small lifecycle {label}: reserved "
                                 f"{eng._reserved_pages} pages idle")

    def pace(*sites, delay=0.02):
        return faults.installed(faults.FaultPlan(
            [{"site": s, "kind": "delay", "delay_s": delay}
             for s in sites]))

    def preempted(model, dev, unified, sampled, mid_decode, preempt):
        """The batch request's stream and the batch class's counters;
        with ``preempt`` an interactive request arrives mid-prefill (or,
        ``mid_decode``, once 4 tokens are out) and must finish first."""
        kw = dict(max_new_tokens=24, do_sample=sampled, temperature=0.8,
                  seed=5, priority="batch")
        chunk = None if mid_decode else 32
        site = "decode_step" if mid_decode else "prefill_chunk"
        with pace(site), engine(model, dev, prefill_chunk_tokens=chunk,
                                unified_step=unified) as eng:
            rb = eng.submit(long_p, **kw)
            if preempt:
                wait_for((lambda: len(rb.generated) >= 4) if mid_decode
                         else (lambda: rb.prefill_pos > 0), "progress")
                ri = eng.submit(short_p, max_new_tokens=8,
                                priority="interactive")
                ri.result(timeout=120)
            got = rb.result(timeout=120).tolist()
            if preempt and not ri.finished_at < rb.finished_at:
                raise AssertionError("small lifecycle: the interactive "
                                     "request did not finish first")
            whole(eng, "preemption")
            return got, eng.scheduler_info()["counts"]["batch"]

    for mid_decode, unified, sampled in itertools.product(
            (False, True), (True, False), (False, True)):
        label = (f"{'decode' if mid_decode else 'prefill'} preemption "
                 f"{'unified' if unified else 'legacy'} "
                 f"{'sampled' if sampled else 'greedy'}")
        card, counts = preempted(gpu, "cuda", unified, sampled,
                                 mid_decode, True)
        host, _ = preempted(cpu, "cpu", unified, sampled, mid_decode, True)
        alone, _ = preempted(gpu, "cuda", unified, sampled, mid_decode,
                             False)
        if not card == host == alone or counts["preempted"] != 1 \
                or counts["resumed"] != 1:
            raise AssertionError(
                f"small lifecycle {label}: card {card}, CPU {host}, card "
                f"unpreempted {alone}; batch counters {counts}")
        log(f"  small f32 model {label}: batch stream equal card "
            f"preempted vs CPU preempted vs card unpreempted; batch "
            f"preempted {counts['preempted']}, resumed {counts['resumed']}"
            f", chunks {counts['chunks']}")

    def raises(exc, fn, match, label):
        try:
            fn()
        except exc as e:
            if match not in str(e):
                raise AssertionError(f"small lifecycle {label}: {e!r} "
                                     f"lacks {match!r}") from e
            return e
        raise AssertionError(f"small lifecycle {label}: no "
                             f"{exc.__name__}")

    # (label, body(eng) -> note) over an engine of its own, paced
    def ttl(eng):
        r = eng.submit(short_p, max_new_tokens=200, ttl_s=0.3)
        raises(DeadlineExceeded, lambda: r.result(timeout=60), "TTL",
               "ttl")
        if r.first_token_at is None or len(r.generated) >= 200:
            raise AssertionError("small lifecycle ttl: expired outside "
                                 "its decode")
        return f"expired after {len(r.generated)} tokens"

    def queue_wait(eng):
        r1 = eng.submit(short_p, max_new_tokens=200)
        wait_for(lambda: r1.seq_id is not None, "admission")
        r2 = eng.submit(short_p, max_new_tokens=4, queue_timeout_s=0.1)
        raises(DeadlineExceeded, lambda: r2.result(timeout=60),
               "queue-wait", "queue wait")
        r1.cancel()
        if r2.seq_id is not None:
            raise AssertionError("small lifecycle queue wait: admitted")
        return "rejected unadmitted"

    def timeout_cancels(eng):
        r = eng.submit(short_p, max_new_tokens=200)
        raises(TimeoutError, lambda: r.result(timeout=0.05), "cancelled",
               "result timeout")
        wait_for(r.done.is_set, "the cancelled request's reap")
        return f"cancelled after {len(r.generated)} tokens"

    def saturated(eng):
        r1 = eng.submit(short_p, max_new_tokens=200)
        wait_for(lambda: r1.seq_id is not None, "admission")
        eng.submit(short_p, max_new_tokens=4)
        e = raises(EngineSaturated,
                   lambda: eng.submit(short_p, max_new_tokens=4),
                   "is full", "max_queue=1")
        if e.priority_class != "standard":
            raise AssertionError(f"small lifecycle max_queue=1: class "
                                 f"{e.priority_class}")
        r1.cancel()
        return f"EngineSaturated, class {e.priority_class}"

    def reject_queued(eng):
        r1 = eng.submit(short_p, max_new_tokens=24)
        wait_for(lambda: r1.seq_id is not None, "admission")
        queued = [eng.submit(short_p, max_new_tokens=4) for _ in range(2)]
        if not eng.drain(timeout=120, reject_queued=True):
            raise AssertionError("small lifecycle drain: timed out")
        for q in queued:
            raises(EngineDraining, lambda: q.result(timeout=1),
                   "reject_queued", "drain reject_queued")
        if len(r1.result(timeout=1)) != len(short_p) + 24 \
                or eng.drain_rejected != 2:
            raise AssertionError("small lifecycle drain: the admitted "
                                 "request did not complete")
        raises(EngineDraining, lambda: eng.submit(short_p), "draining",
               "submit after drain")
        return "2 queued failed with EngineDraining, admitted complete; " \
            "a later submit raised EngineDraining"

    def resume_ttl(eng):
        rb = eng.submit(long_p, max_new_tokens=4, priority="batch")
        wait_for(lambda: rb.prefill_pos > 0, "first chunk")
        ri = eng.submit(short_p, max_new_tokens=100,
                        priority="interactive")
        raises(DeadlineExceeded, lambda: rb.result(timeout=60),
               "resume TTL", "resume ttl")
        ri.result(timeout=120)
        counts = eng.scheduler_info()["counts"]["batch"]
        if counts["preempt_expired"] != 1:
            raise AssertionError(f"small lifecycle resume ttl: {counts}")
        return f"paused prefill reaped at {rb.prefill_pos} tokens"

    def unknown_class(eng):
        raises(ValueError, lambda: eng.submit(short_p, priority="gold"),
               "unknown priority class", "unknown class")
        return "ValueError"

    cases = (("ttl", ttl, {}), ("queue wait", queue_wait, {}),
             ("result timeout", timeout_cancels, {}),
             ("max_queue=1", saturated, dict(max_queue=1)),
             ("drain reject_queued", reject_queued, {}),
             ("resume ttl", resume_ttl, dict(prefill_chunk_tokens=32,
                                             preempt_resume_ttl_s=0.15)),
             ("unknown class", unknown_class, {}))
    for label, body, kw in cases:
        with pace("prefill_chunk", "decode_step", delay=0.01), \
                engine(gpu, "cuda", **kw) as eng:
            note = body(eng)
            whole(eng, label)
            log(f"  small f32 model lifecycle {label}: {note}; cancelled "
                f"{eng.cancelled}, expired {eng.expired}, saturated "
                f"{eng.saturated}, pool whole")
    if faults.active() is not None:
        raise AssertionError("a fault plan outlived its check")
    got = {n: kernels[n].launches for n in (
        "paged_attention", "flash_attention_forward", "rms_norm",
        "apply_rope")}
    if not all(got.values()):
        raise AssertionError(f"small lifecycle: kernels not launched on "
                             f"the card: {got}")
    log(f"  small f32 model lifecycle: launches on the card {got}")


def check_small_generate():
    """The small f32 model of ``check_small``: ``PagedGenerator`` on the
    card (CUDA graphs, kernels) gives the greedy tokens of the CPU's
    (plain versions) and of the port's dense ``generate`` on the card
    (JAX ``test_paged_generation_matches_dense``)."""
    from paddle_tpu_torch.inference import PagedGenerator
    cpu, gpu = _small_models()
    ids = np.random.default_rng(7).integers(0, 512, (3, 9)).astype(np.int32)
    card = PagedGenerator(gpu, total_pages=64, page_size=16)
    outs = {"card": card.generate(ids, max_new_tokens=12),
            "cpu": PagedGenerator(cpu, total_pages=64, page_size=16,
                                  device="cpu").generate(
                                      ids, max_new_tokens=12),
            "dense": gpu.generate(torch.as_tensor(ids, device="cuda"),
                                  max_new_tokens=12).cpu().numpy()}
    if not (np.array_equal(outs["card"], outs["cpu"])
            and np.array_equal(outs["card"], outs["dense"])):
        raise AssertionError(f"small f32 model: PagedGenerator tokens on "
                             f"the card, on the CPU and dense generate "
                             f"differ: {outs}")
    if not card._decoder.replays:
        raise AssertionError("small f32 model: PagedGenerator replayed no "
                             "CUDA graph")
    log(f"  small f32 model PagedGenerator: greedy tokens of 3 rows x 12 "
        f"equal card (CUDA graphs: {card._decoder.captures} captured, "
        f"{card._decoder.replays} replays) vs CPU vs dense generate")


def check_small_speculative():
    """The small f32 model of ``check_small`` with a draft model
    (speculative decoding), on the card (CUDA graphs, kernels) and on the
    CPU from the same weights, spec_tokens 3:

    - the engine's streams, through the unified step (verify rows) and
      the legacy composition (``verify``), with the target as its own
      draft and with a bad draft (another seed), a sampled request riding
      along: card = CPU = the card's draft-free streams, the draft's and
      the target's graphs replayed, both pools whole after the wave;
    - a w8 target with a full-precision draft: card = CPU = the card's
      w8 draft-free streams;
    - a failing draft prefill downgrades its request (not quarantined),
      whose stream stays the draft-free one, and its draft pages go back;
    - ``SpeculativeGenerator`` (b1, 12 new, k 3) with both drafts: card =
      CPU = the card's dense ``generate``."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            SpeculativeGenerator)
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cpu, gpu = _small_models()
    bad_cpu = LlamaForCausalLM(cpu.config, device="cpu", seed=8)
    bad_gpu = LlamaForCausalLM(cpu.config, device="cuda", seed=None)
    bad_gpu.load_state_dict(bad_cpu.state_dict())
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (9, 40, 130, 17)]

    def run(model, draft, dev, unified=True, quantize=None, broken=False):
        with ContinuousBatchingEngine(model, total_pages=64, page_size=16,
                                      max_batch=4, unified_step=unified,
                                      quantize=quantize, draft_model=draft,
                                      spec_tokens=3, device=dev) as eng:
            if broken:
                def prefill(*a, **kw):
                    raise RuntimeError("injected draft prefill failure")
                eng._draft_decoder.prefill = prefill
            with eng._cond:         # admitted together: one batch
                reqs = [eng.submit(p, max_new_tokens=12,
                                   do_sample=i == 3, temperature=0.8,
                                   seed=5) for i, p in enumerate(prompts)]
            outs = [r.result(timeout=300).tolist() for r in reqs]
            drained = eng.drain(timeout=60)
            state = dict(drained=drained, captures=eng.captures,
                         replays=eng.replays,
                         draft_replays=(eng._draft_decoder.replays
                                        if draft is not None else 0),
                         proposed=eng.spec_proposed,
                         accepted=eng.spec_accepted,
                         failures=eng.spec_draft_failures,
                         quarantined=eng.quarantined,
                         dispatches=dict(eng.dispatches),
                         use_draft=[r.use_draft for r in reqs],
                         free=eng.cache.free_pages,
                         draft_free=(eng.draft_cache.free_pages
                                     if draft is not None else 64),
                         reserved=(eng._reserved_pages,
                                   eng._reserved_draft_pages,
                                   eng._pad_pages))
        whole = (state["drained"] and state["free"] == 64
                 and state["draft_free"] == 64
                 and state["reserved"][0] == state["reserved"][1]
                 == state["reserved"][2])
        if not whole:
            raise AssertionError(f"small speculative: the pools did not "
                                 f"come back whole: {state}")
        return outs, state

    for quantize in (None, "w8"):
        plain, _ = run(gpu, None, "cuda", quantize=quantize)
        drafts = (("self", gpu, cpu), ("bad", bad_gpu, bad_cpu))
        if quantize:
            # the draft stays at full precision: a separate clone
            clones = []
            for dev in ("cuda", "cpu"):
                clones.append(LlamaForCausalLM(cpu.config, device=dev,
                                               seed=None))
                clones[-1].load_state_dict(cpu.state_dict())
            drafts = (("clone", *clones),)
        for (name, d_gpu, d_cpu), unified in itertools.product(
                drafts, (True, False)):
            card, st = run(gpu, d_gpu, "cuda", unified, quantize)
            host, _ = run(cpu, d_cpu, "cpu", unified, quantize)
            label = (f"quantize={quantize} draft={name} "
                     f"{'unified' if unified else 'legacy'}")
            mode = "ragged" if unified else "verify"
            if not (card == host == plain) or not st["draft_replays"] \
                    or not st["dispatches"][mode] \
                    or st["dispatches"]["ragged" if not unified
                                        else "verify"] \
                    or not st["proposed"]:
                raise AssertionError(
                    f"small speculative {label}: card {card}, CPU {host}, "
                    f"draft-free {plain}; {st}")
            log(f"  small f32 model speculative {label}: streams of "
                f"{len(prompts)} requests (one sampled) equal card vs CPU vs "
                f"draft-free; accepted {st['accepted']}/{st['proposed']}, "
                f"dispatches {st['dispatches']}, {st['captures']} graphs "
                f"captured, {st['replays']} replays, pools whole")
    plain, _ = run(gpu, None, "cuda")
    outs, st = run(gpu, gpu, "cuda", broken=True)
    if outs != plain or st["failures"] != 3 or st["quarantined"] \
            or any(st["use_draft"]) or st["proposed"]:
        raise AssertionError(f"small speculative draft prefill failure: "
                             f"streams {outs} (want {plain}), {st}")
    log(f"  small f32 model speculative: a failing draft prefill downgraded "
        f"its 3 greedy requests (not quarantined), streams equal the "
        f"draft-free ones, pools whole")
    ids = prompts[0][None]
    for name, d_gpu, d_cpu in (("self", gpu, cpu), ("bad", bad_gpu, bad_cpu)):
        card = SpeculativeGenerator(gpu, d_gpu, 3)
        got = card.generate(ids, max_new_tokens=12)
        host = SpeculativeGenerator(cpu, d_cpu, 3).generate(
            ids, max_new_tokens=12)
        dense = gpu.generate(torch.as_tensor(
            ids, device=gpu.model.embed_tokens.weight.device),
            max_new_tokens=12).cpu().numpy()
        if not (np.array_equal(got, host) and np.array_equal(got, dense)):
            raise AssertionError(f"small SpeculativeGenerator draft={name}: "
                                 f"card {got}, CPU {host}, dense {dense}")
        log(f"  small f32 model SpeculativeGenerator draft={name}: 12 tokens "
            f"equal card vs CPU vs dense generate; {card.last_stats}")


def _counts(kernels):
    return {n: fn.launches for n, fn in kernels.items()}


def _zero(kernels):
    for fn in kernels.values():
        fn.launches = 0


def _eager_generator(model, pages, **kw):
    """A ``PagedGenerator`` stepping through the eager ``PagedDecoder``
    (the same bodies as the graphs, run op by op)."""
    from paddle_tpu_torch.inference.paged import PagedDecoder, PagedGenerator
    gen = PagedGenerator(model, total_pages=pages, page_size=16, **kw)
    gen._decoder = PagedDecoder(model, quantize=kw.get("quantize"))
    return gen


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def batch_context_prefill_logits(model, seed):
    """Three rows at cached contexts 0, 128 and 300 through one graphed
    ``batch_context_prefill`` (bucket 4), and the same rows through one
    eager ``prefill`` or ``chunk_prefill`` each, on two caches filled
    alike: both logits, the prefix graph keys, the relative L2 a row and
    whether the greedy ids agree."""
    from paddle_tpu_torch.inference.paged import (GraphedPagedDecoder,
                                                  PagedDecoder)
    from paddle_tpu_torch.ops.paged_attention import PagedKVCache
    vocab = model.config.vocab_size
    rng = np.random.default_rng(seed + 16)
    ctx_ids = [rng.integers(0, vocab, (1, k)).astype(np.int32)
               for k, _n in GEN_BCP]
    rows = [rng.integers(0, vocab, n).astype(np.int32) for _k, n in GEN_BCP]
    bdec, pdec = GraphedPagedDecoder(model), PagedDecoder(model)
    bc, pc = (PagedKVCache.from_model(model, total_pages=GEN_PAGES,
                                      page_size=16) for _ in range(2))
    for d, c in ((bdec, bc), (pdec, pc)):
        for sid, (k, _n) in enumerate(GEN_BCP):
            if k:
                d.prefill(c, [sid], ctx_ids[sid])
    got = bdec.batch_context_prefill(bc, [0, 1, 2], rows,
                                     [k for k, _n in GEN_BCP])
    want = np.stack([
        pdec.chunk_prefill(pc, [sid], row[None], k)[0] if k
        else pdec.prefill(pc, [sid], row[None])[0]
        for sid, ((k, _n), row) in enumerate(zip(GEN_BCP, rows))])
    return {"keys": sorted(str(k) for k in bdec._graphs
                           if k[0] == "prefix"),
            "rel_l2": [_rel(g, w) for g, w in zip(got, want)],
            "ids_equal": bool(np.array_equal(got.argmax(-1),
                                             want.argmax(-1))),
            "logits": (got, want)}


def check_batch_context_prefill(model, seed, bf16):
    """``batch_context_prefill`` against one prefill or chunk prefill a
    row on the f32 model: greedy ids equal, each row's logits within
    relative L2 3e-3; the bf16 run's (``bf16``, from the generate phase)
    batched logits no further from the f32 per-row ones than twice its
    own per-row logits are (the two round at different places, and 32
    random layers amplify any rounding).  Returns the f32 record."""
    rec = batch_context_prefill_logits(model, seed)
    got16, want16 = bf16["logits"]
    ref = rec["logits"][1]
    rec["bf16_batched_vs_f32"] = _rel(got16, ref)
    rec["bf16_per_row_vs_f32"] = _rel(want16, ref)
    del rec["logits"], bf16["logits"]
    log("batch_context_prefill (f32): " + json.dumps(rec))
    if not rec["ids_equal"] or max(rec["rel_l2"]) > 3e-3 \
            or rec["bf16_batched_vs_f32"] > 2 * rec["bf16_per_row_vs_f32"]:
        raise AssertionError(
            "batch_context_prefill: greedy ids differ or logits past "
            "relative L2 3e-3 against one prefill a row in f32, or the "
            "bf16 batched logits further than twice the per-row ones from "
            "f32")
    return rec


def generate_phase(model, seed, kernels):
    """``PagedGenerator`` on llama_7b in bf16 (bench.py's
    ``bench_paged_decode`` shape): a warm-up generate, then a timed one
    whose launches are counted (its steps replay the warm-up's graphs:
    the prefill, and one multi-step graph replayed 32 times), held
    against the eager ``PagedDecoder``'s prefill and one decode step,
    and its tokens against an eager generate; the per-token continuation
    forced by a small pool, graphed vs eager; ``verify`` against the
    ragged step over the same blocks; ``batch_context_prefill`` against
    one prefill or chunk prefill a row; a w8a8 + int8 KV generate.
    Returns the phase's record and the timed generate's launches."""
    from paddle_tpu_torch.inference.paged import (GraphedPagedDecoder,
                                                  PagedDecoder,
                                                  PagedGenerator)
    from paddle_tpu_torch.ops import paged_attention as tpa
    from paddle_tpu_torch.ops.paged_attention import (PagedKVCache,
                                                      paged_attention_multi)
    cfg = model.config
    vocab = cfg.vocab_size
    rng = np.random.default_rng(seed + 15)
    ids = rng.integers(0, vocab, (GEN_B, GEN_PROMPT)).astype(np.int32)
    warm_ids = rng.integers(0, vocab, ids.shape).astype(np.int32)
    seqs = list(range(GEN_B))
    pos = np.full(GEN_B, GEN_PROMPT, np.int32)
    rec = {}

    def valid(out, prompt, new, label):
        if out.shape != (GEN_B, prompt + new) or not (
                (0 <= out) & (out < vocab)).all():
            raise AssertionError(f"generate {label}: output {out.shape} "
                                 "of the wrong shape or out of vocabulary")

    # the timed generate: captures in the warm-up only
    gen = PagedGenerator(model, total_pages=GEN_PAGES, page_size=16)
    dec = gen._decoder
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    gen.generate(warm_ids, max_new_tokens=GEN_NEW)
    torch.cuda.empty_cache()
    rec["graph_pool_bytes"] = torch.cuda.memory_reserved() - reserved
    rec["captures_warmup"] = dec.captures
    replays = dec.replays
    _zero(kernels)
    out = gen.generate(ids, max_new_tokens=GEN_NEW)
    launches = _counts(kernels)
    valid(out, GEN_PROMPT, GEN_NEW, "timed")
    rec.update(captures=dec.captures - rec["captures_warmup"],
               replays=dec.replays - replays,
               graph_keys=sorted(str(k) for k in dec._graphs),
               prefill_s=gen.last_prefill_seconds,
               decode_s=gen.last_decode_seconds)
    decode_tokens = (out.shape[1] - GEN_PROMPT - 1) * GEN_B
    rec["decode_tok_s"] = decode_tokens / max(gen.last_decode_seconds, 1e-9)
    if rec["captures"] or set(k[0] for k in dec._graphs) != {"prefill",
                                                              "multi"}:
        raise AssertionError(f"generate: the timed call captured "
                             f"{rec['captures']} graphs (keys "
                             f"{rec['graph_keys']}); it must replay the "
                             "warm-up's prefill and multi-step graphs")
    # one graphed generate under the profiler: the device's busy time
    wall_ms, events, busy = _window(
        lambda: gen.generate(ids, max_new_tokens=GEN_NEW), 1)
    steps = rec["replays"] - 1              # the prefill's replay, then
    rec.update(window_ms=wall_ms,           # one a decode step
               device_busy_ms=busy if busy else "not measured",
               device_idle_share=1 - busy / wall_ms if busy
               else "not measured",
               paged_ms_per_decode_step=sum(
                   _device_us(e) for e in events
                   if "paged_attention" in e.key) / 1e3 / steps
               if busy else "not measured",
               decode_steps=steps)

    # eager: the same tokens; its prefill and one decode step's launches
    eager = _eager_generator(model, GEN_PAGES)
    want = eager.generate(ids, max_new_tokens=GEN_NEW)
    rec["ids_equal_eager"] = bool(np.array_equal(out, want))
    rec["eager_prefill_s"] = eager.last_prefill_seconds
    rec["eager_decode_s"] = eager.last_decode_seconds
    if not rec["ids_equal_eager"]:
        raise AssertionError("generate: graphed tokens differ from the "
                             "eager PagedDecoder's")
    edec, cache = eager._decoder, PagedKVCache.from_model(
        model, total_pages=GEN_PAGES, page_size=16)
    _zero(kernels)
    first = edec.prefill(cache, seqs, ids).argmax(-1).astype(np.int32)
    prefill_n = _counts(kernels)
    _zero(kernels)
    edec.step(cache, seqs, first[:, None], pos)
    step_n = _counts(kernels)
    del cache
    rec["launches"] = launches
    rec["launches_per_decode_step"] = {
        n: (launches[n] - prefill_n[n]) / steps for n in launches
        if launches[n]}
    rec["eager_step_launches"] = {n: c for n, c in step_n.items() if c}
    bad = {n for n in launches
           if launches[n] != prefill_n[n] + steps * step_n[n]}
    if bad or step_n["paged_attention"] != cfg.num_hidden_layers:
        raise AssertionError(
            f"generate: launches {launches} are not the eager prefill's "
            f"{prefill_n} plus {steps} x the eager step's {step_n} "
            f"(kernels {sorted(bad)})")
    log("generate: " + json.dumps(rec))

    # the per-token continuation: the first chunk cannot be reserved
    tight = {}
    for name in ("graphed", "eager"):
        g = (PagedGenerator(model, total_pages=GEN_TIGHT_PAGES, page_size=16)
             if name == "graphed" else
             _eager_generator(model, GEN_TIGHT_PAGES))
        got = g.generate(ids[:, :GEN_TIGHT_PROMPT], max_new_tokens=GEN_NEW)
        valid(got, GEN_TIGHT_PROMPT, GEN_NEW, "tight")
        tight[name] = (got, sorted({k[0] for k in g._decoder._staging}),
                       g.cache.free_pages)
    modes = tight["graphed"][1]
    rec["tight"] = {"modes": modes,
                    "ids_equal_eager": bool(np.array_equal(
                        tight["graphed"][0], tight["eager"][0]))}
    if modes != ["decode", "prefill"] or tight["eager"][1] != modes \
            or not rec["tight"]["ids_equal_eager"] \
            or tight["graphed"][2] != GEN_TIGHT_PAGES:
        raise AssertionError(f"generate, {GEN_TIGHT_PAGES} pages: the "
                             f"per-token continuation did not run or its "
                             f"tokens differ from eager: {rec['tight']}")
    del g, tight

    # verify against the ragged step over the same full-span blocks
    vdec, rdec = GraphedPagedDecoder(model), GraphedPagedDecoder(model)
    caches = [PagedKVCache.from_model(model, total_pages=GEN_PAGES,
                                      page_size=16) for _ in range(2)]
    for d, c in zip((vdec, rdec), caches):
        first = d.prefill(c, seqs, ids).argmax(-1).astype(np.int32)
    drafts = vdec.multi_step(caches[0], seqs, first, pos, GEN_VERIFY_S - 1)
    block = np.concatenate([first[:, None], drafts], axis=1)
    for row in range(GEN_B // 2):           # half the rows reject a draft
        block[row, 1 + row % (GEN_VERIFY_S - 1)] += 1
    block %= vocab
    nd = [GEN_VERIFY_S - 1] * GEN_B
    rec["verify"] = {}
    for kind, flags in (("greedy", np.zeros(GEN_B, bool)),
                        ("draw", np.arange(GEN_B) % 2 == 0)):
        sampling = (np.arange(GEN_B, dtype=np.uint32) + 40,
                    np.full(GEN_B, 0.8, np.float32), flags)
        outs = []
        for call in range(3):
            for c in caches:
                for sid in seqs:
                    c.truncate(sid, GEN_PROMPT)
            t0 = time.perf_counter()
            v = vdec.verify(caches[0], seqs, block, pos, sampling=sampling)
            v_ms = (time.perf_counter() - t0) * 1e3
            r = rdec.ragged_step(caches[1], seqs, list(block), list(pos),
                                 n_drafts=nd, sampling=sampling)
            outs.append((v, r, v_ms))
        (v_out, v_acc), (r_out, r_acc), _ = outs[0]
        rec["verify"][kind] = {
            "accept": v_acc.tolist(), "ids": v_out.tolist(),
            "equal_ragged": bool(np.array_equal(v_out, r_out)
                                 and np.array_equal(v_acc, r_acc)),
            "step_ms_host": [o[2] for o in outs[1:]]}
        if not rec["verify"][kind]["equal_ragged"] or any(
                not np.array_equal(o[0][0], v_out) for o in outs):
            raise AssertionError(
                f"verify {kind}: ids {v_out.tolist()} accept "
                f"{v_acc.tolist()} differ from the full-span ragged step's "
                f"{r_out.tolist()} {r_acc.tolist()}, or between calls")
    rec["verify"]["captures"] = vdec.captures
    # the verify form of the paged kernel at the step's shapes, on layer
    # 0's pools as the step left them (read warm), against its plain
    # version; bound: each row's K/V read once, q and out
    heads, d = cfg.num_attention_heads, cfg.hidden_size // \
        cfg.num_attention_heads
    kv_heads = cfg.num_key_value_heads
    n_kv = GEN_PROMPT + GEN_VERIFY_S
    lens = torch.full((GEN_B,), n_kv, dtype=torch.int32,
                      device=model.model.embed_tokens.weight.device)
    width = max(k[4] for k in vdec._graphs if k[0] == "verify")
    tables, _ = caches[0].page_table(seqs, max_pages=width)
    q = torch.randn(GEN_B, GEN_VERIFY_S, heads, d, dtype=torch.bfloat16,
                    device=lens.device)
    pools = (caches[0].k_pages[0], caches[0].v_pages[0])
    ms = cuda_ms(lambda: paged_attention_multi(q, *pools, lens, tables))
    plain_ms = cuda_ms(lambda: tpa._multi_plain(q, *pools, lens, tables,
                                                d ** -0.5), reps=3)
    err = check("paged_attention", f"verify b{GEN_B} x{GEN_VERIFY_S} "
                f"{heads}/{kv_heads} ctx {n_kv}",
                paged_attention_multi(q, *pools, lens, tables),
                tpa._multi_plain(q, *pools, lens, tables, d ** -0.5), 2e-2)
    visible = GEN_B * sum(n_kv - GEN_VERIFY_S + 1 + j
                          for j in range(GEN_VERIFY_S))
    bms, by = bound_ms(GEN_B * n_kv * kv_heads * d * 2 * 2
                       + 2 * GEN_B * GEN_VERIFY_S * heads * d * 2,
                       4 * visible * heads * d, BF16_FLOP_S)
    rec["verify"].update(paged_ms_per_call=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, max_abs_err=err)
    log("generate verify: " + json.dumps(rec["verify"]))
    del vdec, rdec, caches

    # batch_context_prefill against one prefill / chunk prefill a row;
    # held to its limits in f32 (check_batch_context_prefill), where bf16
    # rounding amplified by 32 random layers does not hide a fault
    rec["batch_context_prefill"] = batch_context_prefill_logits(model, seed)
    log("generate batch_context_prefill (bf16): " + json.dumps(
        {k: v for k, v in rec["batch_context_prefill"].items()
         if k != "logits"}))

    # w8a8 weights + int8 KV pages through the multi-step graph
    qgen = PagedGenerator(model, total_pages=GEN_PAGES, page_size=16,
                          quantize="w8a8", kv_dtype="int8")
    qgen.generate(warm_ids, max_new_tokens=GEN_QUANT_NEW)
    captured, replays = qgen._decoder.captures, qgen._decoder.replays
    _zero(kernels)
    q_out = qgen.generate(ids, max_new_tokens=GEN_QUANT_NEW)
    q_n = _counts(kernels)
    valid(q_out, GEN_PROMPT, GEN_QUANT_NEW, "w8a8 int8 KV")
    forwards = qgen._decoder.replays - replays
    layers = cfg.num_hidden_layers
    rec["w8a8_int8kv"] = {
        "captures": qgen._decoder.captures - captured, "replays": forwards,
        "kv_page_dtype": str(qgen.cache.k_pages[0].dtype),
        "launches": {n: c for n, c in q_n.items() if c},
        "decode_s": qgen.last_decode_seconds}
    log("generate w8a8_int8kv: " + json.dumps(rec["w8a8_int8kv"]))
    if rec["w8a8_int8kv"]["captures"] \
            or q_n["w8a8_matmul"] != (4 * layers + 1) * forwards \
            or q_n["dynamic_act_quant"] != (6 * layers + 1) * forwards \
            or q_n["paged_attention"] != layers * (forwards - 1) \
            or q_n["weight_only_matmul"] \
            or qgen.cache.k_pages[0].dtype != torch.int8:
        raise AssertionError("generate w8a8 + int8 KV: the timed call "
                             "captured, or its int8 kernels did not run "
                             f"inside the graphs as expected: {q_n}")
    del qgen, gen, eager
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def _lm_loss(logits, labels):
    """The classic f32-logits cross entropy of ``bench.py``'s LLaMA
    pretrain step."""
    from paddle_tpu_torch.nn.functional import cross_entropy
    return cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                         labels.reshape(-1))


def check_small_train():
    """A small f32 model trains 5 AdamW steps (2-step accumulation,
    global-norm clipping) from the same weights and batches three ways:
    the graphed step on the card (kernels, CUDA graphs), the eager step on
    the card (the same body without graphs) and on the CPU (plain
    versions).  Graphed and eager card losses and parameters must be
    bit-equal; card and CPU losses within relative 1e-4 (f32 on both
    sides; sums run in other orders)."""
    from paddle_tpu_torch.jit import EagerTrainStep, TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig(vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=512)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=9)
    rng = np.random.default_rng(9)
    batches = [rng.integers(0, 512, (2, 2, 200)) for _ in range(5)]
    losses, models, steps = [], [], []
    for cls, dev in ((TrainStep, "cuda"), (EagerTrainStep, "cuda"),
                     (TrainStep, "cpu")):
        model = cpu
        if dev == "cuda":
            model = LlamaForCausalLM(cfg, device="cuda", seed=None)
            model.load_state_dict(cpu.state_dict())
        step = cls(model, _lm_loss, AdamW(
            learning_rate=1e-3, parameters=model.parameters(),
            grad_clip=ClipGradByGlobalNorm(1.0)), accumulate_steps=2)
        out = [step(torch.as_tensor(ids, device=dev),
                    torch.as_tensor(labels, device=dev))
               for ids, labels in batches]
        losses.append(torch.stack(out).cpu().numpy())
        models.append(model)
        steps.append(step)
    graphed, eager = steps[:2]
    same = all(torch.equal(a, b) for a, b in zip(
        models[0].parameters(), models[1].parameters()))
    rel = np.abs(losses[0] - losses[2]) / np.abs(losses[2])
    log(f"  small-train f32 5 AdamW steps (accumulate 2, clip 1.0): card "
        f"graphed {losses[0].tolist()} ({graphed.captures} captures, "
        f"{graphed.replays} replays), card eager {losses[1].tolist()}, cpu "
        f"{losses[2].tolist()}; graphed vs eager losses and parameters "
        f"bit-equal: {bool((losses[0] == losses[1]).all()) and same}; card "
        f"vs cpu max relative difference {rel.max():.2e} (limit 1e-4)")
    if not np.isfinite(losses[0]).all() or rel.max() > 1e-4:
        raise AssertionError("small-train: the card's losses differ from "
                             "the CPU's")
    if not ((losses[0] == losses[1]).all() and same):
        raise AssertionError("small-train: the graphed card step differs "
                             "from the eager card step")
    if (graphed.captures, graphed.replays) != (2, 3):
        raise AssertionError(f"small-train: {graphed.captures} captures and "
                             f"{graphed.replays} replays, expected 2 and 3")


def check_small_moe():
    """A small f32 MoE model (GShard top-2 over 8 experts, eval): greedy
    ``generate`` streams on the card (kernels, the gating kernel once per
    layer and forward) equal the CPU's (plain versions) from the same
    weights."""
    from paddle_tpu_torch.models.llama_moe import (LlamaMoeConfig,
                                                   LlamaMoeForCausalLM)
    from paddle_tpu_torch.ops import moe_gating as mg
    cfg = LlamaMoeConfig(vocab_size=512, hidden_size=256,
                         intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=512, num_experts=8)
    cpu = LlamaMoeForCausalLM(cfg, device="cpu", seed=7).eval()
    gpu = LlamaMoeForCausalLM(cfg, device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    gpu.eval()
    ids = np.random.default_rng(7).integers(0, 512, (4, 40))
    new = 12
    before = mg.topk_gating_cuda.launches
    card = gpu.generate(torch.as_tensor(ids, device="cuda"),
                        max_new_tokens=new).cpu()
    launched = mg.topk_gating_cuda.launches - before
    ref = cpu.generate(torch.as_tensor(ids), max_new_tokens=new)
    if not torch.equal(card, ref):
        raise AssertionError(f"small f32 MoE model: greedy streams on the "
                             f"card {card[:, 40:].tolist()} differ from the "
                             f"CPU's {ref[:, 40:].tolist()}")
    want = cfg.num_hidden_layers * (new + 1)
    if launched != want:
        raise AssertionError(f"small f32 MoE model: {launched} gating "
                             f"launches, expected {want}")
    log(f"  small f32 MoE model: greedy generate of {ids.shape[0]} x "
        f"{new} tokens equal card vs CPU, {launched} gating launches")


class RouteRecord:
    """The routing the gating kernel returned in one forward of the
    kernel path, per layer in call order, with the logits it was given.

    A gate value one ulp off can flip a top-2 choice or a capacity drop,
    a discrete change that depth amplifies; so the plain forward replays
    the kernel path's routing (``moe_plain_forward``), and the routing is
    held on its own against the plain routing of the same logits
    (``verdict``)."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def recording(self):
        from paddle_tpu_torch.ops import moe_gating as mg
        kernel = mg.topk_gating_cuda

        def record(logits, top_k, capacity):
            out = kernel(logits, top_k, capacity)
            self.calls.append((logits.detach().clone(), top_k, capacity,
                               out))
            return out

        # the wrapper counts its launches under the module's name, which
        # is ``record`` meanwhile
        record.launches = kernel.launches
        mg.topk_gating_cuda = record
        try:
            yield
        finally:
            mg.topk_gating_cuda = kernel
            kernel.launches = record.launches

    def verdict(self):
        """Each layer's kernel routing against the plain routing of the
        same logits: a token's choices may differ only where two of its
        top k + 1 gates are within 1e-6; where no choice differs, slots
        and keeps are identical.  Returns the differing tokens per
        layer."""
        from paddle_tpu_torch.ops import moe_gating as mg
        differing = []
        for i, (logits, k, cap, out) in enumerate(self.calls):
            eidx, pos, keep = out[0], out[1], out[2].bool()
            want = mg.topk_gating_plain(logits, k, cap, True)
            rows = (eidx != want[0]).any(dim=0)
            n = int(rows.sum())
            differing.append(n)
            if n:
                top = torch.softmax(logits, -1).topk(
                    min(k + 1, logits.shape[1]), dim=-1).values
                gap = (top[:, :-1] - top[:, 1:]).min(dim=-1).values
                far = int((rows & (gap > 1e-6)).sum())
                if far:
                    raise AssertionError(
                        f"layer {i}: the kernel routes {far} tokens "
                        "otherwise than the plain routing of the same "
                        "logits, with no gates within 1e-6")
            elif not (torch.equal(pos, want[1])
                      and torch.equal(keep, want[2])):
                raise AssertionError(f"layer {i}: same choices, but slots "
                                     "or keeps differ from the plain "
                                     "routing")
        return differing


def moe_plain_forward(model, ids, record):
    """The MoE model's logits on the plain versions (RMSNorm, RoPE,
    attention) with each layer's routing replayed from the kernel path's
    ``record``; the weights of the replayed choices are the plain softmax
    of this path's own gate logits."""
    from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
        _ragged_combine, _ragged_dispatch)
    from paddle_tpu_torch.ops import moe_gating as mg
    from paddle_tpu_torch.ops.flash_attention import mha_reference
    from paddle_tpu_torch.ops.fused_norm_rope import (apply_rope_plain,
                                                      rms_norm_plain)
    m = model.model
    x = m.embed_tokens(ids)
    b, s = ids.shape
    pos = torch.zeros(b, dtype=torch.int32, device=ids.device)
    if len(record.calls) != len(m.layers):
        raise AssertionError(f"{len(record.calls)} routings recorded for "
                             f"{len(m.layers)} layers")
    for layer, (_, _, cap, out) in zip(m.layers, record.calls):
        at, moe = layer.self_attn, layer.moe
        h = rms_norm_plain(x, layer.input_layernorm.weight,
                           layer.input_layernorm.epsilon)
        q = at.q_proj(h).view(b, s, at.num_heads, at.head_dim)
        k = at.k_proj(h).view(b, s, at.num_kv_heads, at.head_dim)
        v = at.v_proj(h).view(b, s, at.num_kv_heads, at.head_dim)
        q, k = apply_rope_plain(q, k, m.rope_cos, m.rope_sin, pos)
        o = mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True).transpose(1, 2)
        x = x + at.o_proj(o.reshape(b, s, -1))
        h = rms_norm_plain(x, layer.post_attention_layernorm.weight,
                           layer.post_attention_layernorm.epsilon)
        tokens = h.reshape(b * s, -1)
        eidx, slot, keep = out[0], out[1], out[2].bool()
        w, _ = mg._weights(moe.gate.gate_logits(tokens), eidx, keep,
                           moe.gate.normalize)
        buf = _ragged_dispatch(tokens, eidx, slot, keep, moe.num_expert, cap)
        y = _ragged_combine(moe.experts(buf), eidx, slot, keep, w)
        x = x + y.view(b, s, -1)
    x = rms_norm_plain(x, m.norm.weight, m.norm.epsilon)
    return model.lm_head(x).float()


def check_moe_launches(launches, forwards, layers):
    """Every forward of the MoE generate pass launches the gating kernel,
    flash attention and RoPE once per layer and RMSNorm twice per layer
    and once for the final norm; no other kernel launches."""
    want = dict(topk_gating=layers * forwards,
                flash_attention_forward=layers * forwards,
                apply_rope=layers * forwards,
                rms_norm=(2 * layers + 1) * forwards)
    wrong = {n: (launches[n], c) for n, c in want.items() if launches[n] != c}
    stray = [n for n, c in launches.items() if c and n not in want]
    if forwards != MOE_NEW + 1 or wrong or stray:
        raise AssertionError(f"moe: {forwards} forwards (expected "
                             f"{MOE_NEW + 1}); launches (got, expected) "
                             f"{wrong}; launched off the path: {stray}")


def moe_generate(seed, dev, card):
    """Mixtral-8x7B's widths cut to ``MOE_LAYERS`` layers, bf16 with f32
    gates, eval: greedy ``generate`` of ``MOE_NEW`` tokens for ``MOE_B``
    prompts of ``MOE_PROMPT`` tokens drawn from ``seed``, after a short
    warm-up call.  The launch counters are zeroed just before the timed
    call and read just after it.  Then one ``torch.profiler`` window over
    decode steps of the same loop.  Returns the pass's record and its
    launch counts."""
    from paddle_tpu_torch.models.llama import empty_kv_caches
    from paddle_tpu_torch.models.llama_moe import (LlamaMoeForCausalLM,
                                                   mixtral_8x7b)
    cfg = mixtral_8x7b(MOE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaMoeForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                seed=seed, gate_dtype=torch.float32)
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (MOE_B, MOE_PROMPT)), device=dev)
    log(f"moe: llama_moe at Mixtral-8x7B widths, {cfg.num_hidden_layers} of "
        f"32 layers, bf16 with f32 gates, {n_params / 1e9:.2f} B params, "
        f"batch {MOE_B} x {MOE_PROMPT} prompt tokens, {MOE_NEW} new, greedy")
    model.generate(ids[:, :64], max_new_tokens=2)        # warm-up
    torch.cuda.synchronize()
    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    stamps = []
    hook = model.model.register_forward_pre_hook(
        lambda *_: stamps.append(time.perf_counter()))
    try:
        out = model.generate(ids, max_new_tokens=MOE_NEW)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    finally:
        hook.remove()
    launches = {n: fn.launches for n, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    forwards = len(stamps) - 1
    prefill_s = stamps[1] - stamps[0]
    steps = np.diff(stamps[1:]) * 1e3
    total_s = stamps[-1] - stamps[0]
    q1, med, q3 = np.percentile(steps, [25, 50, 75])
    if tuple(out.shape) != (MOE_B, MOE_PROMPT + MOE_NEW) \
            or not torch.equal(out[:, :MOE_PROMPT], ids) \
            or not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"moe: generate returned {tuple(out.shape)} "
                             "tokens, or changed the prompt, or left the "
                             "vocabulary")
    L = cfg.num_hidden_layers
    check_moe_launches(launches, forwards, L)

    # where a decode step's time goes: the generate loop's step (forward,
    # head, host argmax) in one profiler window
    with torch.no_grad():
        caches = empty_kv_caches(model, MOE_B)
        hidden, caches = model.model(ids, 0, caches)
        logits = model._logits_of(hidden[:, -1:])
        n_prof = 4
        state = {"pos": MOE_PROMPT, "caches": caches, "logits": logits}

        def decode_steps():
            # a window opened again decodes on from where the last stopped
            for _ in range(n_prof):
                nxt = state["logits"][:, -1].float().cpu().numpy().argmax(-1)
                nxt_t = torch.as_tensor(nxt[:, None], device=dev)
                hidden, state["caches"] = model.model(nxt_t, state["pos"],
                                                      state["caches"])
                state["logits"] = model._logits_of(hidden)
                state["pos"] += 1

        seen = ("flash_fwd_wgmma_kernel",)
        prof = window_seeing(decode_steps, "moe decode", seen,
                             ("flash_fwd_kernel",))
        del caches, hidden, logits, state
    events = prof.key_averages()
    busy_us = sum(_device_us(e) for e in events)
    top = sorted(events, key=_device_us, reverse=True)[:8]
    rec = {
        "card": card, "layers": L, "params_b": n_params / 1e9,
        "batch": MOE_B, "prompt": MOE_PROMPT, "new_tokens": MOE_NEW,
        "forwards": forwards, "prefill_s": prefill_s,
        "decode_ms_p25": q1, "decode_ms_p50": med, "decode_ms_p75": q3,
        "generate_s": total_s, "tokens_per_s": MOE_B * MOE_NEW / total_s,
        "peak_memory_gb": peak / 1e9,
        "launches": launches,
        "gating_launches_per_forward": launches["topk_gating"] / forwards,
        "attention_kernels_seen": list(seen),
        "device_busy_ms_per_step": (busy_us / 1e3 / n_prof) if busy_us
        else "not measured",
        # against the unprofiled median step of the generate call
        "device_idle_share": (1 - busy_us / 1e3 / n_prof / med) if busy_us
        else "not measured",
        "top_device": [{"name": e.key[:60],
                        "calls_per_step": e.count / n_prof,
                        "device_ms_per_step": _device_us(e) / 1e3 / n_prof}
                       for e in top if _device_us(e) > 0]}
    del model, out
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def moe_logits(seed, dev):
    """f32 logits of a batch-2 x 512 prompt at Mixtral-8x7B's widths and
    ``MOE_CHECK_LAYERS`` layers: the kernel path's forward against
    ``moe_plain_forward`` replaying its routing, relative L2 within 1e-3;
    the routing held on its own (``RouteRecord.verdict``).  The experts
    are drawn from N(0, 0.02) here: XavierNormal's fans of a [8, 4096,
    28672] weight give a std of 1.3e-4, and the layers' MoE output would
    be about 1e-6 of the residual, which no logits check could see."""
    from paddle_tpu_torch.models.llama_moe import (LlamaMoeForCausalLM,
                                                   mixtral_8x7b)
    cfg = mixtral_8x7b(MOE_CHECK_LAYERS)
    model = LlamaMoeForCausalLM(cfg, device=dev, dtype=torch.float32,
                                seed=seed)
    model.eval()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for layer in model.model.layers:
            layer.moe.experts.w1.normal_(0.0, 0.02, generator=gen)
            layer.moe.experts.w2.normal_(0.0, 0.02, generator=gen)
    rng = np.random.default_rng(seed + 1)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, MOE_PROMPT)),
                          device=dev)
    record = RouteRecord()
    with torch.no_grad():
        with record.recording():
            got, aux = model(ids)
        ref = moe_plain_forward(model, ids, record)
    torch.cuda.synchronize()
    differing = record.verdict()
    r = float((got - ref).norm() / ref.norm())
    kept = [float(out[2].float().mean()) for _, _, _, out in record.calls]
    log(f"moe: f32 logits of 2 x {MOE_PROMPT} tokens at full width, "
        f"{MOE_CHECK_LAYERS} layers: kernels vs plain forward replaying the "
        f"kernel routing, relative L2 {r:.2e} (limit 1e-3); tokens routed "
        f"otherwise by the plain routing of the same logits, per layer: "
        f"{differing}; kept share per layer {kept}; aux {float(aux):.6f}")
    if not torch.isfinite(got).all() or r > 1e-3:
        raise AssertionError("moe logits: the kernel path is further from "
                             "the plain forward than its limit")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(logits_rel_l2=r, routing_differing_tokens=differing)


def _kernel_class(name):
    """A device kernel's share of the train step: the port's attention
    kernels, its Triton kernels (RMSNorm, RoPE: ``kern``), cuBLAS GEMMs,
    the loss's softmax, and every other torch op."""
    if "flash_bwd" in name:
        return "flash_backward"
    if "flash_fwd" in name:
        return "flash_forward"
    if name == "kern":
        return "triton_rms_rope"
    if "nvjet" in name or "gemm" in name.lower() or "cutlass" in name:
        return "gemm"
    if "SoftMax" in name or "nll_loss" in name:
        return "cross_entropy"
    return "other_torch_ops"


def model_flops(cfg, batch, seq):
    """Model FLOPs of one training step, from the shapes: forward plus a
    backward of twice the forward, for every Linear (2 per weight per
    token each way) and the causal attention products (QK^T and PV over
    the visible pairs)."""
    d = cfg.hidden_size // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * d
    per_layer = cfg.hidden_size * (2 * cfg.hidden_size + 2 * kv) \
        + 3 * cfg.hidden_size * cfg.intermediate_size
    linear = cfg.num_hidden_layers * per_layer \
        + cfg.hidden_size * cfg.vocab_size
    tokens = batch * seq
    attn_fwd = 4 * batch * cfg.num_attention_heads * d \
        * causal_pairs(seq, seq, True) * cfg.num_hidden_layers
    return 3 * (2 * linear * tokens + attn_fwd)


TRAIN_KERNELS = ("flash_attention_forward", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq", "rms_norm", "apply_rope")


def _host_ms(fn, n):
    """Host ms of each of ``n`` calls of ``fn``, each ended by a
    synchronize."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def train_run_steps(trainer, mode, cfg, rng, dev):
    """``run_steps`` over 8 distinct batches (bench.py's on-chip
    ``k_fused``) at a constant rate or under LinearWarmup(CosineAnnealing
    Decay), against 8 single graphed calls (each followed by the
    schedule's step) from the same weights: losses and parameters must
    be bit-equal.  Then a second ``run_steps`` over 8 more batches, which
    must only replay, is timed: tokens/s and mfu."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import lr as sched_lr

    def rate():
        if mode == "constant":
            return 1e-3
        return sched_lr.LinearWarmup(
            sched_lr.CosineAnnealingDecay(1e-3, T_max=16), warmup_steps=4,
            start_lr=1e-5, end_lr=1e-3)

    def batches():
        out = []
        for _ in range(8):
            x = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
            out.append((torch.as_tensor(x[:, :-1], device=dev),
                        torch.as_tensor(x[:, 1:], device=dev)))
        return out

    fused, single = trainer(TrainStep, rate()), trainer(TrainStep, rate())
    if not fused.fused_supported:
        raise AssertionError(f"train run_steps {mode}: not fused")
    first = batches()
    got = fused.run_steps(first)
    want = []
    for ids, labels in first:
        want.append(single(ids, labels))
        if single._sched() is not None:
            single._sched().step()
    want = torch.stack(want)
    equal = torch.equal(got, want) and all(
        torch.equal(a, b) for a, b in zip(fused.model.parameters(),
                                          single.model.parameters()))
    del single
    second = batches()
    captured, replayed = fused.captures, fused.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fused.run_steps(second)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals = torch.cat([got, out]).cpu().numpy()
    rec = {"k": 8, "wall_ms": wall * 1e3, "step_ms": wall * 1e3 / 8,
           "tokens_per_s": 8 * TRAIN_B * TRAIN_S / wall,
           "mfu": 8 * model_flops(cfg, TRAIN_B, TRAIN_S) / wall / BF16_FLOP_S,
           "captures": fused.captures - captured,
           "replays": fused.replays - replayed,
           "equal_to_single_calls": equal,
           "losses": [float(x) for x in vals]}
    log(f"  run_steps {mode}: " + json.dumps(rec))
    if not np.isfinite(vals).all():
        raise AssertionError(f"train run_steps {mode}: non-finite loss")
    if not equal:
        raise AssertionError(
            f"train run_steps {mode}: losses {got.tolist()} or parameters "
            f"differ from 8 single graphed calls' {want.tolist()}")
    if rec["captures"]:
        raise AssertionError(f"train run_steps {mode}: the second run "
                             f"captured {rec['captures']} graphs")
    return rec


def train(seed, dev, card, steps=20, warmup=3):
    """llama_small pretraining steps on the card through the graphed
    ``TrainStep``: ``warmup`` steps (the first runs eagerly and captures),
    then ``steps`` timed ones, which must capture nothing, with the launch
    counters zeroed just before them.  Then the same weights and batch
    through the eager step (``EagerTrainStep``): its first 5 losses must
    equal the graphed step's bit for bit and its launches a step a
    replay's, and its step ms and busy time are measured beside the
    graphs'.  Then ``run_steps`` (``train_run_steps``).  Returns the train
    pass's record and the timed steps' launch counts."""
    from paddle_tpu_torch.jit import EagerTrainStep, TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_small
    from paddle_tpu_torch.optimizer import AdamW
    cfg = llama_small()

    def trainer(cls, lr=1e-3):
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=seed)
        return cls(model, _lm_loss, AdamW(
            learning_rate=lr, parameters=model.parameters(),
            multi_precision=True))

    step = trainer(TrainStep)
    n_params = sum(p.numel() for p in step.model.parameters())
    rng = np.random.default_rng(seed)
    ids_np = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    ids = torch.as_tensor(ids_np[:, :-1], device=dev)
    labels = torch.as_tensor(ids_np[:, 1:], device=dev)
    log(f"train: llama_small ({cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}) bf16 + AdamW(multi_precision) "
        f"{n_params / 1e6:.1f} M params, batch {TRAIN_B} x {TRAIN_S}, "
        "graphed TrainStep")
    kernels = counters()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # cached blocks released on both sides, so the difference is what the
    # warm-up holds: the graph pool, static buffers and gradient sums
    reserved = torch.cuda.memory_reserved(dev)
    losses = [step(ids, labels) for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool_bytes = torch.cuda.memory_reserved(dev) - reserved
    captures_warmup = step.captures
    for fn in kernels.values():
        fn.launches = 0
    captured, replayed = step.captures, step.replays
    times = _host_ms(lambda: losses.append(step(ids, labels)), steps)
    launches = {n: fn.launches for n, fn in kernels.items()}
    captures, replays = step.captures - captured, step.replays - replayed
    peak = torch.cuda.max_memory_allocated()
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    n_prof = 2
    seen = ("flash_fwd_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
            "flash_bwd_dq_wgmma_kernel")
    prof = window_seeing(
        lambda: losses.extend(step(ids, labels) for _ in range(n_prof)),
        "train", seen,
        ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"))
    events = prof.key_averages()
    busy_us = sum(_device_us(e) for e in events)
    top = sorted(events, key=_device_us, reverse=True)[:16]
    by_class = {}
    for e in events:
        by_class[_kernel_class(e.key)] = by_class.get(
            _kernel_class(e.key), 0.0) + _device_us(e) / 1e3 / n_prof
    vals = torch.stack(losses).float().cpu().numpy()
    log("  losses: " + " ".join(f"{x:.4f}" for x in vals))

    # the eager step on the same weights and batch
    eager = trainer(EagerTrainStep)
    for fn in kernels.values():
        fn.launches = 0
    eager_losses = torch.stack([eager(ids, labels) for _ in range(5)])
    eager_launches = {n: fn.launches / 5 for n, fn in kernels.items()}
    eager_times = _host_ms(lambda: eager(ids, labels), 10)
    _ms, _events, eager_busy = _window(lambda: eager(ids, labels), n_prof)
    equal = torch.equal(torch.stack(losses[:5]), eager_losses)
    e_med = float(np.percentile(eager_times, 50))
    eager_rec = {
        "step_ms_p25": float(np.percentile(eager_times, 25)),
        "step_ms_p50": e_med,
        "step_ms_p75": float(np.percentile(eager_times, 75)),
        "device_busy_ms_per_step": eager_busy or "not measured",
        "device_idle_share": (1 - eager_busy / e_med) if eager_busy
        else "not measured",
        "launches_per_step": eager_launches,
        "losses": [float(x) for x in eager_losses.cpu()]}
    log("  eager: " + json.dumps(eager_rec))
    del eager
    gc.collect()
    torch.cuda.empty_cache()

    flops = model_flops(cfg, TRAIN_B, TRAIN_S)
    rec = {
        "card": card, "batch": TRAIN_B, "seq": TRAIN_S,
        "params_m": n_params / 1e6,
        "step_ms_p25": q1, "step_ms_p50": med, "step_ms_p75": q3,
        "tokens_per_s": TRAIN_B * TRAIN_S / (med / 1e3),
        "model_flops_per_step": flops,
        "mfu": flops / (med / 1e3) / BF16_FLOP_S,
        "peak_memory_gb": peak / 1e9,
        "captures_warmup": captures_warmup, "captures": captures,
        "replays": replays, "graph_pool_bytes": pool_bytes,
        "launches_per_step": {n: c / steps for n, c in launches.items()},
        "device_busy_ms_per_step": (busy_us / 1e3 / n_prof) if busy_us
        else "not measured",
        "device_idle_share": (1 - busy_us / 1e3 / n_prof / med) if busy_us
        else "not measured",
        "device_ms_per_step_by_class": by_class,
        "top_device": [{"name": e.key[:60],
                        "calls_per_step": e.count / n_prof,
                        "device_ms_per_step": _device_us(e) / 1e3 / n_prof}
                       for e in top if _device_us(e) > 0],
        "loss_first": float(vals[0]), "loss_last": float(vals[-1]),
        "first_5_losses_equal_eager": equal,
        "eager": eager_rec,
        "attention_kernels_seen": list(seen)}
    if not np.isfinite(vals).all():
        raise AssertionError(f"train: non-finite loss {vals.tolist()}")
    if not vals[-1] < vals[0]:
        raise AssertionError(f"train: the last loss {vals[-1]} is not below "
                             f"the first {vals[0]}")
    if captures or replays != steps:
        raise AssertionError(f"train: the timed steps captured {captures} "
                             f"graphs and replayed {replays}; after the "
                             "warm-up every step must replay")
    if not equal:
        raise AssertionError(
            f"train: the graphed step's first 5 losses {vals[:5].tolist()} "
            f"differ from the eager step's {eager_rec['losses']}")
    missing = [n for n in TRAIN_KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"train: kernels never launched on the "
                             f"training path: {missing}")
    apart = {n: (launches[n] / steps, eager_launches[n])
             for n in TRAIN_KERNELS
             if launches[n] / steps != eager_launches[n]}
    if apart:
        raise AssertionError(f"train: launches a step, replayed vs eager, "
                             f"differ: {apart}")
    rec["run_steps"] = {mode: train_run_steps(trainer, mode, cfg, rng, dev)
                        for mode in ("constant", "warmup_cosine")}
    return rec, launches


def _device_us(evt):
    """Device time of a profiler kernel entry (0 for host-side operator
    entries, whose device time would count their kernels twice)."""
    if evt.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _window(fn, n):
    """``fn`` ``n`` times in one ``torch.profiler`` window: wall ms a
    call, the key averages, and the device's busy ms a call (None where
    the profiler saw no device time)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=DEVICE_ACTIVITY) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(_device_us(e) for e in events)
    return window * 1e3 / n, events, (busy_us / 1e3 / n if busy_us
                                      else None)


def profile_decode(model, batch, context, steps, seed, quantize=None,
                   kv_quant=None, min_table_pages=1):
    """Prefill ``batch`` sequences of ``context`` tokens one by one, then
    run ``steps`` ragged decode steps (one token per row), through the
    eager ``PagedDecoder`` and the ``GraphedPagedDecoder`` on two caches
    filled alike: the ids must be equal every step, and a last step's
    logits bit-equal.  The first half of the steps, the two decoders in
    turns, is timed on the host clock (each step ends in the host
    transfer of its token ids; the graphed decoder's first step captures
    and is left out); the second half runs each decoder in one
    ``torch.profiler`` window, for the device's busy time per step, its
    idle share against the unprofiled median step, and the paged
    kernels' device ms per step."""
    from paddle_tpu_torch.inference.paged import (GraphedPagedDecoder,
                                                  PagedDecoder)
    from paddle_tpu_torch.ops.paged_attention import PagedKVCache
    pages = batch * (-(-(context + steps + 8) // 16))
    decs = {}
    for name, cls in (("eager", PagedDecoder),
                      ("graphed", GraphedPagedDecoder)):
        cache = PagedKVCache.from_model(model, total_pages=pages + 1,
                                        page_size=16, kv_dtype=kv_quant)
        decs[name] = (cls(model, quantize=quantize,
                          min_table_pages=min_table_pages), cache)
    rng = np.random.default_rng(seed)
    seqs = list(range(batch))
    nxt = {name: np.zeros(batch, np.int32) for name in decs}
    greedy1 = (np.zeros(1, np.uint32), np.zeros(1, np.int32),
               np.ones(1, np.float32), np.zeros(1, bool))
    walls = {name: [] for name in decs}
    for sid in seqs:
        ids = rng.integers(0, model.config.vocab_size,
                           (1, context)).astype(np.int32)
        for name, (dec, cache) in decs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nxt[name][sid] = dec.prefill(cache, [sid], ids,
                                         sampling=greedy1)[0]
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    greedy = (np.zeros(batch, np.uint32), np.ones(batch, np.float32),
              np.zeros(batch, bool))

    def step(name, sampling=greedy):
        dec, cache = decs[name]
        ctxs = [cache.length(s) for s in seqs]
        out, _ = dec.ragged_step(cache, seqs, [[int(t)] for t in nxt[name]],
                                 ctxs, sampling=sampling)
        if sampling is not None:
            nxt[name][:] = out
        return out

    def agree(where):
        if not np.array_equal(nxt["eager"], nxt["graphed"]):
            raise AssertionError(
                f"profile ctx {context} {quantize} {kv_quant}: graphed "
                f"ids {nxt['graphed'].tolist()} differ from eager "
                f"{nxt['eager'].tolist()} at {where}")

    agree("prefill")
    half = steps // 2
    times = {name: [] for name in decs}
    for i in range(half):
        for name in decs:
            t0 = time.perf_counter()
            step(name)
            times[name].append((time.perf_counter() - t0) * 1e3)
        agree(f"step {i}")
    n = steps - half
    res = {"batch": batch, "context": context, "quantize": quantize,
           "kv_quant": kv_quant, "min_table_pages": min_table_pages}
    for name, (dec, _cache) in decs.items():
        q1, med, q3 = np.percentile(times[name][1:], [25, 50, 75])
        window_ms, events, busy = _window(lambda: step(name), n)
        paged_us = sum(_device_us(e) for e in events
                       if "paged_attention" in e.key)
        top = sorted(events, key=_device_us, reverse=True)[:6]
        res[name] = {
            "prefill_s_first": walls[name][0],
            "prefill_s_median_rest": float(np.median(walls[name][1:])),
            "step_ms_p25": q1, "step_ms_p50": med, "step_ms_p75": q3,
            "window_ms_per_step": window_ms,
            "device_busy_ms_per_step": busy if busy else "not measured",
            # the profiler slows the host: idle share against the
            # unprofiled median step
            "device_idle_share": (1 - busy / med) if busy
            else "not measured",
            "paged_ms_per_step": paged_us / 1e3 / n if busy
            else "not measured",
            "captures": dec.captures, "replays": dec.replays,
            "top_device": [{"name": e.key[:60],
                            "calls_per_step": e.count / n,
                            "device_ms_per_step": _device_us(e) / 1e3 / n}
                           for e in top if _device_us(e) > 0]}
    agree("the profiled steps")
    if decs["graphed"][0].captures != 2:
        raise AssertionError(
            f"profile: {decs['graphed'][0].captures} captures, expected "
            "2 (the prefill bucket and the decode bucket)")
    logits = [step(name, sampling=None) for name in decs]
    if not np.array_equal(*logits):
        raise AssertionError(f"profile ctx {context}: graphed logits differ "
                             "from eager (bit for bit)")
    return res


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
    # wall seconds of each phase, from the start of this process
    phase_s = {}
    clock = [T_START]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        log(f"[{name}: {phase_s[name]:.1f} s]")

    # 1. build: one nvcc per CUDA source, waited on by a thread while
    # this one sets up the card and checks the Triton kernels (2.), which
    # need no nvcc; leaving the block waits for every nvcc, on error too
    from paddle_tpu_torch.ops import _build

    def build_all():
        t0 = time.perf_counter()
        return _build.build_all(), time.perf_counter() - t0

    records = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        build = pool.submit(build_all)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        log(smi[0])
        lap("start")
        log("kernels:")
        check_norm_rope(records, dev)
        lap("check_norm_rope")
        libs, build_s = build.result()
    log(f"build: {len(libs)} CUDA kernels in {build_s:.1f} s, beside the "
        "Triton checks")
    for name, info in sorted(_build.ptxas_info.items()):
        for line in info.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    # wgmma instructions in the tensor-core kernels' machine code
    hgmma = {}
    for name in ("flash_attention", "flash_attention_bwd", "quant_matmul",
                 "flashmask_attention"):
        hgmma.update(sass_counts(libs[name]))
    log("  HGMMA/IGMMA per kernel: " + json.dumps(hgmma))
    tensor_core = {k: c for k, c in hgmma.items() if "wgmma" in k}
    if sorted({k.split("<")[0] for k in tensor_core}) != [
            "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
            "flash_fwd_wgmma_kernel", "flashmask_bwd_dkv_wgmma_kernel",
            "flashmask_bwd_dq_wgmma_kernel", "flashmask_fwd_wgmma_kernel",
            "w8a8_wgmma_kernel", "wo_wgmma_kernel"] \
            or min(tensor_core.values()) == 0:
        raise AssertionError(f"the tensor-core kernels hold no wgmma: "
                             f"{hgmma}")
    # mma.sync in the paged kernels: the tensor-core kernel has it, the
    # CUDA-core (decode) and combine kernels not
    hmma = sass_counts(libs["paged_attention"], opcodes=("HMMA",))
    log("  HMMA per paged kernel: " + json.dumps(hmma))
    if not any("mma_kernel" in k for k in hmma) or any(
            ("mma_kernel" in k) != (c > 0) for k, c in hmma.items()):
        raise AssertionError(f"paged_attention_mma_kernel must hold HMMA "
                             f"and the CUDA-core kernels none: {hmma}")
    lap("build")

    # 2. kernels against their plain versions
    for fn in (check_paged, check_quant, check_flash, check_flash_bwd,
               time_train_shapes, check_moe_gating, check_flashmask):
        fn(records, dev)
        lap(fn.__name__)
    for name, prefix in (("flash_attention_forward", "flash_fwd"),
                         ("flash_attention_bwd_dkv", "flash_bwd_dkv"),
                         ("flash_attention_bwd_dq", "flash_bwd_dq"),
                         ("weight_only_matmul", "wo_"),
                         ("w8a8_matmul", "w8a8_"),
                         ("flashmask_fwd", "flashmask_fwd"),
                         ("flashmask_bwd_dkv", "flashmask_bwd_dkv"),
                         ("flashmask_bwd_dq", "flashmask_bwd_dq")):
        records[name]["hgmma"] = {k: c for k, c in hgmma.items()
                                  if k.startswith(prefix)}
    records["paged_attention"]["hmma"] = hmma
    gc.collect()
    torch.cuda.empty_cache()

    # FlashMask forward + backward at 8192 packed tokens (before the 7B
    # model takes the card's memory)
    launches = {}
    fm_rec, launches["flashmask"] = flashmask_phase(args.seed, dev, smi[0])
    lap("flashmask")

    # 3. a small model, card vs CPU: serving, then training
    log("small:")
    check_small()
    lap("check_small")
    check_small_legacy()
    lap("check_small_legacy")
    check_small_lifecycle()
    lap("check_small_lifecycle")
    check_small_generate()
    lap("check_small_generate")
    check_small_speculative()
    lap("check_small_speculative")
    check_small_train()
    lap("check_small_train")
    check_small_moe()
    lap("check_small_moe")

    # 4. llama_7b serving
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    cfg = llama_7b()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             seed=args.seed)
    torch.cuda.synchronize()
    log(f"serve: llama_7b ({cfg.num_hidden_layers} layers) bf16, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params")
    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(64, 1025, 8)
    lengths[0] = max(lengths[0], 300)     # holds the shared 256 prefix
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lengths[:7]]
    sharer = np.concatenate([prompts[0][:256], rng.integers(
        0, cfg.vocab_size, int(lengths[7]) - 256 if lengths[7] > 256
        else 64)]).astype(np.int32)
    # each pass's warm-up wave: the same lengths, other tokens (so it
    # makes no prefix hit that the measured wave would not make)
    warm = [rng.integers(0, cfg.vocab_size, len(p)).astype(np.int32)
            for p in prompts]
    warmup = (warm, np.concatenate([warm[0][:256], rng.integers(
        0, cfg.vocab_size, len(sharer) - 256)]).astype(np.int32))
    kernels = counters()
    passes = {}
    greedy = {}
    norms_per_forward = 2 * cfg.num_hidden_layers + 1
    from paddle_tpu_torch.testing import faults
    if faults.active() is not None:
        raise AssertionError("a fault plan is installed outside the fault "
                             "checks")
    for label, chunk, quant, kv, unified in SERVE_PASSES:
        # the launch counters are zeroed inside, just before the measured
        # wave; its steps replay graphs the warm-up captured, each replay
        # adding its capture's launches
        reqs, wall, info = serve(model, prompts, sharer, chunk, dev, quant,
                                 kv, warmup=warmup, kernels=kernels,
                                 unified=unified)
        got = {n: fn.launches for n, fn in kernels.items()}
        if info["captures"] or not info["replays"]:
            raise AssertionError(
                f"{label}: the measured wave captured {info['captures']} "
                f"CUDA graphs and replayed {info['replays']}; after the "
                "warm-up every step must replay")
        absorbed = {k: info[k] for k in ("decode_retries", "quarantined",
                                         "unified_fallbacks")}
        if any(absorbed.values()):
            raise AssertionError(f"{label}: steps failed and were absorbed "
                                 f"by the engine's isolation: {absorbed}")
        disp = info["dispatches"]
        if not unified:
            # the legacy composition: no ragged step, and the paged kernel
            # only in its decode form, one launch a layer of each decode
            # step (the first chunks take flash, the continuation chunks
            # the dense prefix attention)
            if disp["ragged"] or not disp["decode"] \
                    or got["paged_attention"] \
                    != cfg.num_hidden_layers * disp["decode"]:
                raise AssertionError(
                    f"{label}: dispatches {disp} and "
                    f"{got['paged_attention']} paged launches; the legacy "
                    "composition runs no ragged step and the paged kernel "
                    "once a layer of each decode step")
        elif disp["decode"]:
            raise AssertionError(f"{label}: the unified pass dispatched "
                                 f"decode steps: {disp}")
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
        passes[label] = dict(stats, launches=got, card=smi[0], **info)
        if not unified:
            passes[label]["prefix_suffix_attention_ms"] = \
                time_prefix_suffix_attention(model, chunk, lengths)
        # with 256-token chunks every prompt rides the ragged kernel, so
        # that path has no flash launch; a quantized pass launches its
        # matmul kernel once a Linear of every forward in w8 (7 a layer
        # and the head) and once a distinct activation in w8a8 (q|k|v,
        # o, gate|up, down: 4 a layer, and the head), the other one
        # never; the quantizer runs once a w8a8 matmul and twice a layer
        # for int8 K/V pages
        need = ["paged_attention", "rms_norm", "apply_rope"]
        if chunk is None or not unified:
            need.append("flash_attention_forward")
        if quant or kv:
            need.append("dynamic_act_quant")
        forwards = got["rms_norm"] / norms_per_forward
        layers = cfg.num_hidden_layers
        per_forward = {}
        if quant:
            need.append(QUANT_KERNEL[quant])
            per_forward[QUANT_KERNEL[quant]] = \
                (4 if quant == "w8a8" else 7) * layers + 1
        if quant or kv:
            per_forward["dynamic_act_quant"] = \
                (4 * layers + 1 if quant == "w8a8" else 0) \
                + (2 * layers if kv else 0)
        for name, each in per_forward.items():
            passes[label][f"{name}_launches_per_forward"] = \
                got[name] / forwards
            if got[name] != each * forwards:
                raise AssertionError(
                    f"{label}: {got[name]} {name} launches in {forwards} "
                    f"forwards, expected {each} each")
        log(f"serve {label}: " + json.dumps(passes[label]))
        missing = [n for n in need if got[n] == 0]
        stray = [k for q, k in QUANT_KERNEL.items() if q != quant and got[k]]
        if not (quant or kv) and got["dynamic_act_quant"]:
            stray.append("dynamic_act_quant")
        if missing or stray:
            raise AssertionError(f"{label}: kernels never launched on the "
                                 f"serving path: {missing}; launched off "
                                 f"it: {stray}")
        greedy[label] = [r.generated for r in reqs[:6]]
        if label == "unchunked":
            unchunked_reqs = reqs
        if quant:
            # the engine and its int8 twins go before the next pass
            del reqs
            gc.collect()
            torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(greedy["unchunked"],
                                      greedy["chunked256"]))
    log(f"serve: {same}/6 greedy streams identical unchunked vs chunked "
        "(bf16: the two paths round differently, so equality is "
        "reported, not required)")
    same = sum(a == b for a, b in zip(greedy["chunked256"],
                                      greedy["legacy_chunked256"]))
    log(f"serve: {same}/6 greedy streams identical chunked256 vs "
        "legacy_chunked256 (reported: bf16, other kernels)")
    for label in ("w8_int8kv", "w8a8_int8kv"):
        same = sum(a == b for a, b in zip(greedy["unchunked"],
                                          greedy[label]))
        log(f"serve: {same}/6 greedy streams of {label} identical to the "
            f"bf16 pass's (reported); KV pages {passes[label]['kv_pool_bytes']}"
            f" B + scales {passes[label]['kv_scale_bytes']} B against bf16 "
            f"pages {passes['unchunked']['kv_pool_bytes']} B")
    lap("serve")
    classes_rec, classes_launches = classes_phase(model, args.seed, kernels,
                                                  smi[0])
    launches.update(classes_launches)
    lap("serve_classes")
    # speculative decoding: the engine's draft model against the
    # unchunked pass (its draft-free run), then SpeculativeGenerator
    spec_rec, spec_launches, spec_div = speculative_phase(
        model, prompts, sharer, warmup, kernels,
        (passes["unchunked"], unchunked_reqs), args.seed, smi[0])
    launches.update(spec_launches)
    del unchunked_reqs
    lap("speculative")

    # 5. where a decode step's time goes (after the serve passes, so no
    # launch of it is counted there; before the f32 check below, which
    # turns the model to f32)
    log("profile:")
    profiles = []
    for context, quant, kv, width in PROFILE_CASES:
        profiles.append(dict(profile_decode(model, 8, context, 32,
                                            args.seed, quant, kv, width),
                             card=smi[0]))
        log("  " + json.dumps(profiles[-1]))
        gc.collect()
        torch.cuda.empty_cache()
    log("profile: paged kernels' device ms a bf16 ctx 512 decode step, "
        "graphed, table width next_pow2(pages) / pinned at "
        f"{SERVE_TABLE_PAGES} pages: {profiles[0]['graphed']['paged_ms_per_step']}"
        f" / {profiles[3]['graphed']['paged_ms_per_step']}")
    lap("profile")

    # 6. PagedGenerator (the multi-step and per-token decode graphs),
    # verify and batch_context_prefill on the same bf16 model
    log("generate:")
    gen_rec, launches["generate"] = generate_phase(model, args.seed,
                                                   kernels)
    gen_rec["card"] = smi[0]
    lap("generate")

    # one request's prefill logits, kernel path vs plain forward on the
    # card: in f32 the two must agree closely; in bf16 the kernel path
    # must stay as close to the f32 result as the plain bf16 path does
    # (the two round at different places, and 32 random layers amplify
    # any rounding, so a fixed bf16 tolerance would say nothing)
    ids = torch.as_tensor(prompts[1][None, :256].astype(np.int64),
                          device=dev)
    bf16 = []
    window_seeing(lambda: bf16.append(prefill_logits(model, ids)[:2]),
                  "serve prefill", ("flash_fwd_wgmma_kernel",),
                  ("flash_fwd_kernel",))
    got16, ref16 = bf16[-1]
    log("serve: the bf16 prefill ran flash_fwd_wgmma_kernel (profiler)")
    for quant in ("w8", "w8a8"):
        quant_prefill_window(model, ids, quant)
        log(f"serve: the bf16 {quant} prefill ran "
            f"{QUANT_PREFILL_KERNEL[quant][0]} (profiler)")
    gc.collect()
    model.float()
    # the speculative phase's bf16 divergences: the draft-free run's top-2
    # logit gap there, from a plain f32 forward
    spec_rec["bf16_divergence_gaps"] = top2_gaps(model, spec_div)
    log("speculative: bf16 divergences from the draft-free streams, top-2 "
        "logit gap of a plain f32 forward there: "
        + json.dumps(spec_rec["bf16_divergence_gaps"]))
    got32, ref32, _ = prefill_logits(model, ids)
    gen_rec["batch_context_prefill_f32"] = check_batch_context_prefill(
        model, args.seed, gen_rec["batch_context_prefill"])

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
    # the quantized prefills in f32 at full depth, kernels vs plain
    # versions with the same int8 twins; the plain forward replays the
    # kernel path's int8 codes (``CodeReplay`` says why and how the codes
    # are held), so what is left is f32 order: limit 1e-3, as unquantized
    for quant, kv in (("w8", None), ("w8", "int8"), ("w8a8", "int8")):
        got, ref, replay = prefill_logits(model, ids, quant, kv)
        r = rel(got, ref)
        codes = ""
        if replay:
            share = replay.verdict()
            codes = (f"; {replay.n} int8 codes replayed, {share:.2e} of "
                     f"them one step from the plain quantizer's, scales "
                     f"within {replay.worst_scale:.2e}")
        log(f"serve: prefill logits {quant} kv_quant={kv}, f32 kernels vs "
            f"f32 plain, relative L2 {r:.2e} (limit 1e-3){codes}; int8 "
            f"moves the plain logits {rel(ref, ref32):.2e}; argmax kernels "
            f"{int(got.argmax())}, plain {int(ref.argmax())}")
        if not torch.isfinite(got).all() or r > 1e-3:
            raise AssertionError(
                f"prefill logits {quant} kv_quant={kv}: the kernel path is "
                "further from the plain forward than its limit")
        gc.collect()
    lap("prefill_logits")

    # 7. llama_small pretraining (the 7B model's 27 GB of f32 go first,
    # with the slice that shares its tensors and the loop's last handle)
    del model
    torch.cuda.empty_cache()
    train_rec, launches["train"] = train(args.seed, dev, smi[0])
    log("train: " + json.dumps(train_rec))
    lap("train")

    # 8. the MoE model generating at Mixtral-8x7B widths (the 7B model
    # and the trainer are gone), then its full-width f32 logits
    moe_rec, launches["moe"] = moe_generate(args.seed, dev, smi[0])
    log("moe: " + json.dumps(moe_rec))
    lap("moe")
    moe_rec.update(moe_logits(args.seed, dev))
    lap("moe_logits")
    phase_s["total"] = time.perf_counter() - T_START

    out = []
    for name, meta in KERNELS.items():
        out.append(dict(name=name, **meta,
                        launches=launches[MAIN_PATH[name]][name],
                        launches_by_path={p: launches[p][name]
                                          for p in launches},
                        **records[name]))
    serve_line = {p: {k: passes[p][k] for k in
                      ("ttft_p50_s", "tpot_p50_s", "decode_tok_s", "wall_s",
                       "kv_pool_bytes", "kv_scale_bytes", "launches",
                       "captures_warmup", "captures", "replays",
                       "graph_pool_bytes", "dispatches", "decode_retries",
                       "quarantined", "unified_fallbacks")}
                  for p in passes}
    serve_line["legacy_chunked256"]["prefix_suffix_attention_ms"] = \
        passes["legacy_chunked256"]["prefix_suffix_attention_ms"]
    train_line = {k: train_rec[k] for k in (
        "step_ms_p25", "step_ms_p50", "step_ms_p75",
        "device_busy_ms_per_step", "device_idle_share", "tokens_per_s",
        "mfu", "peak_memory_gb", "captures_warmup", "captures", "replays",
        "graph_pool_bytes", "launches_per_step", "loss_first", "loss_last",
        "first_5_losses_equal_eager")}
    train_line["eager"] = {k: train_rec["eager"][k] for k in (
        "step_ms_p50", "device_busy_ms_per_step", "device_idle_share")}
    train_line["run_steps"] = {
        m: {k: r[k] for k in ("tokens_per_s", "mfu", "step_ms",
                              "equal_to_single_calls")}
        for m, r in train_rec["run_steps"].items()}
    moe_line = {k: moe_rec[k] for k in (
        "layers", "prefill_s", "decode_ms_p50", "tokens_per_s",
        "peak_memory_gb", "device_idle_share", "launches", "logits_rel_l2")}
    fm_line = {c[0]: {k: fm_rec[c[0]][k] for k in fm_rec[c[0]] if k in (
        "fwd_ms_p50", "fwd_bwd_ms_p50", "tokens_per_s", "peak_memory_gb",
        "tiles_skipped_share", "flash_fwd_ms_p50", "flash_fwd_bwd_ms_p50",
        "fwd_ms", "dkv_ms", "dq_ms", "flash_fwd_ms", "flash_dkv_ms",
        "flash_dq_ms", "fwd_bound_ms", "dkv_bound_ms", "dq_bound_ms",
        "plain_fwd_ms", "plain_bwd_ms", "sdpa_fwd_ms", "sdpa_bwd_ms")}
        for c in FM_CASES}
    gen_line = {k: gen_rec[k] for k in (
        "prefill_s", "decode_s", "decode_tok_s", "captures_warmup",
        "captures", "replays", "graph_pool_bytes", "device_busy_ms",
        "device_idle_share", "paged_ms_per_decode_step",
        "launches_per_decode_step", "ids_equal_eager")}
    gen_line["verify"] = {k: gen_rec["verify"][k] for k in (
        "paged_ms_per_call", "plain_ms", "bound_ms", "bound_by",
        "max_abs_err")}
    print(json.dumps({"kernels": out, "serve": serve_line,
                      "generate": gen_line,
                      "train": train_line, "moe": moe_line,
                      "flashmask": fm_line,
                      "speculative": {
                          p: ({k: r[k] for k in (
                              "ttft_p50_s", "tpot_p50_s",
                              "tpot_p50_draft_free_s", "decode_tok_s",
                              "wall_s", "steps", "steps_draft_free",
                              "spec_proposed",
                              "spec_accepted", "acceptance_rate",
                              "spec_accept_lens", "dispatches",
                              "captures_warmup", "captures", "replays",
                              "greedy_equal_draft_free", "drained")}
                              if p in {c[0] for c in SPEC_PASSES} else r)
                          for p, r in spec_rec.items()},
                      "classes": {p: {k: r[k] for k in (
                          "ttft_p50_s", "tpot_p50_s", "wall_s", "counts",
                          "captures_warmup", "captures", "replays",
                          "dispatches", "ragged_ms_by_bucket")}
                          for p, r in classes_rec.items()},
                      "phase_s": {k: round(v, 2) for k, v in phase_s.items()}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
