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
            small-recovery: the small f32 model served to mid-decode,
            then one fault at a step boundary: a transient
            ``buffer_loss`` (unified and legacy, replayed a row at a time
            and batched), a sticky one on one sequence, sampled rows, the
            target as its own draft (the loss on the verify), w8 weights
            with int8 KV pages, a late prefix sharer after the loss, an
            ``engine_wedge`` delay under the step watchdog, and
            ``snapshot`` / JSON / ``stop`` / ``restore`` on a fresh
            engine: the streams on the card equal a fault-free run on the
            card, which equals the CPU's; exactly the sticky row fails;
            every engine drains with both pools whole.
            small-overload: the small f32 model through the overload
            controls: a batch row paused by the TPOT trigger (unified
            and legacy) gives the stream of the CPU and of the card's
            run without the budget; a scripted deadline shed and a
            scripted brownout ladder (its rungs, its decisions at rung
            2) decide on the card as on the CPU.
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
   recovery — the same model, traffic and engine (unchunked): each pass
            a warm-up wave with its own recovery, then the measured wave
            (launch counters zeroed just before it), one fault installed
            at a step boundary once every row holds 8 tokens:
            ``loss_batched`` and ``loss_per_row`` (one ``buffer_loss``,
            the survivors replayed in batched rounds or a prefill a row),
            ``wedge`` (an ``engine_wedge`` delay of 0.6 s under
            ``step_timeout_s=0.25``) and ``snapshot_restore`` (a snapshot
            mid-wave, JSON, ``stop``, ``restore`` on a fresh engine).
            Printed: the MTTR (the failure hook's entry to the replay's
            end) beside the ragged step's p50, replay dispatches, rows
            replayed, captures (must be 0) and launches by kernel inside
            the recovery window, TTFT and TPOT p50 beside the fault-free
            unchunked pass, the relative L2 of the survivors' K/V after
            the replay against a copy taken before the fault, the
            watchdog's timeouts, the snapshot's ms and entries, the time
            from ``restore`` to every row's next token, and (bf16,
            reported) each stream's agreement with the fault-free one
            and its first divergence, whose f32 top-2 gap comes later.
   tp      — tensor parallelism (``tp=2``), two processes on the one
            card over gloo, asked for explicitly (NCCL, the default on a
            card, puts rank r on cuda:r; it runs (a) as well where two
            cards are visible, and otherwise a line says it did not run);
            the sharded steps run eagerly (``PagedDecoder``).  (a)
            llama_7b's widths cut to 2 layers in f32 beside tp=1 on the
            card: prefill logits within relative L2 1e-5 (argmax equal),
            a rank's KV pool bytes half the whole pool's, 8 greedy
            streams equal in the unified and the legacy compositions, and
            with int8 collectives the card's prefill logits nearer the
            same tp=2 decoder's on the CPU than a quarter of the
            quantization's own distance (their distance from tp=1, the
            streams left equal and the f32 top-2 gap at each divergence
            printed).  (b) the bf16 llama_7b at full
            depth with the unchunked pass's traffic (a warm-up wave, then
            the measured one; counters zeroed just before it on both
            ranks): TTFT and TPOT p50 and decode tokens/s beside the
            tp=1 graphed pass, each rank's peak memory and launches, 2
            block reductions a layer a forward on each rank, the streams
            against tp=1 (bf16: reported, first divergences with their
            f32 top-2 gap later); then a launch wave (the traffic's
            lengths, other tokens, queued together, greedy) on the same
            engine and on an eager tp=1 engine: each rank's paged, flash,
            RMSNorm and RoPE launches must equal the eager tp=1 pass's.
   overload — the same model with the classes traffic, an engine a
            sub-case: ``tpot`` (the interactive TPOT budget at 0.9x and
            2x the classes pass's interactive TPOT p50, every ragged
            bucket captured first: decode preemptions, rows parked, TPOT
            p50 by class, decode tokens/s; 2x must pause nothing),
            ``shed`` (the batch deadline at 2x the decode p50 the
            controller reads, 4 interactive then 24 batch arrivals: sheds
            batch only, Retry-After within [1, 30], every admitted
            request complete), ``brownout`` (thresholds 0.25, 0.5, 0.75,
            0.95 over ``max_queue=16``, 32 arrivals 10 ms apart: rungs,
            transitions, sheds never interactive, seconds back to rung
            0) and
            ``trace`` (the wave with capture off and on: TPOT p50 of
            both, a chrome trace both schema checks pass, dropped
            events, the bytes of ``prometheus_text()``); the measured
            waves of tpot and trace capture no graph.
   server  — the HTTP front door (``GenerationServer``) on the same
            model, after the tp phase: (a) in this process, a journal in
            a temporary directory, every ragged decode bucket captured,
            then the unchunked pass's warm-up and measured waves as
            concurrent one-row POSTs (launch counters zeroed just before
            the measured one, which must capture nothing and launch the
            paged, flash, RMSNorm and RoPE kernels): HTTP wall p50/p99,
            tokens/s, TTFT and TPOT p50 beside the direct run's, streams
            equal to the direct run's (bf16: reported, first divergences
            with their f32 top-2 gap later), then a wave of fresh tokens
            under each journal fsync policy (os, interval_ms, always:
            TPOT p50, journal bytes, records and fsyncs), ``/health``;
            (b) the small f32 model: HTTP streams equal
            ``engine.generate``'s; (c) a child-process server on a journal
            (fsync always) SIGKILLed mid-decode with a greedy and a
            sampled row, restarted on the same journal: restored
            requests, ``/result/<id>`` equal to an uninterrupted child's
            streams bit for bit, seconds from the restart to listening
            and to the first restored token.  ``--only server`` runs the
            build, the unchunked pass and this phase.
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
   train_paths — the rest of training, each sub-case a graphed
            ``TrainStep`` (3 warm-up steps, then timed steps that must
            capture nothing) whose first 5 losses must equal an eager
            twin's (``EagerTrainStep``, the same seeded weights) bit for
            bit, losses falling: (a) ``fused_ce``, the train case's model
            with ``fused_linear_cross_entropy`` (chunk 1024) over the
            hidden states (bench.py's fused route), its first loss within
            1e-2 of the unfused one, the four head products timed apart;
            (b) ``amp_o1``, f32 parameters under ``amp_level="O1"``
            (tensor-core flash kernels in a profiler window, RMSNorm in
            f32); (c) ``amp_o2``, ``amp.decorate(level="O2")`` of an f32
            model holding the train case's bf16 weights: the same
            weights and first 5 losses; (d) ``moe``, Mixtral-8x7B's
            widths cut to 1 layer (2 do not fit AdamW's state and
            temporaries), bf16 with f32 naive gates, batch 4 x 512: the
            gating kernel and the flash kernels once a layer a step.  ``--only train_paths`` runs the flash backward check,
            ``train`` and this phase alone.
   fit     — the hapi fit path and ZeRO offload: (a) ``loader``, the train
            case's graphed ``TrainStep`` fed by
            ``DataLoader(device_prefetch=True)`` (single calls, then
            ``run_steps`` of 4 twice): staged batches equal ``.to(device)``
            of the host batches, losses equal a host-fed twin's; step ms
            p50 with and without the device stage, ``input_wait_seconds``
            p50; (b) ``bert_fit``, BERT-base in f32 through
            ``Model.fit`` (AdamW 2e-5, ``CrossEntropyLoss``, ``Accuracy``),
            batch 32 x 128, under sync-debug warnings (none from
            ``hapi``, ``io`` or the optimizer; the rest printed by call
            site), the first 5 losses equal an explicit eager loop's, then
            ``evaluate``; (c) ``bert_o1``, the graphed
            ``TrainStep(amp_level="O1")`` (bench.py config 2): dropout 0
            through ``graphed_path``, dropout 0.1 losses falling; (d)
            ``offload``, the train case after
            ``group_sharded_parallel(..., "os_g", offload=True)``: losses
            and weights equal the trainer without offload, state pinned
            on the host, step ms and device peak of both; (e)
            ``offload_moe``, Mixtral-8x7B's widths at 2 layers offloaded
            (the depth train_paths (d) cannot fit): graphed = eager, the
            host's MemAvailable, pinned bytes, device peak, step ms.
            Before it (after the kernel checks), the flash kernels are
            checked and timed at BERT-base's shapes (b32 h12 s128 d64,
            no mask, bf16 and f32: records ``bert_bf16``, ``bert_f32``).
            ``--only fit`` runs the build, those checks and this phase.
   vision  — the vision and OCR training paths through the graphed
            ``TrainStep``, each sub-case's losses, parameters and
            batch-norm buffers equal to an eager twin's
            (``EagerTrainStep``, the same seeded weights) bit for bit
            after its first steps, then 20 timed steps capturing nothing
            (step ms p25/p50/p75, images/s, device busy ms and idle share
            from a profiler window, device ms of cuDNN's convolutions
            beside the rest, launches a step, mfu, peak memory): (a)
            ``resnet50_cifar``, bench.py's config 1 (``resnet50
            (num_classes=10)``, b256 x 3 x 32 x 32, Momentum(0.1, 0.9,
            weight_decay=5e-4), ``CrossEntropyLoss``, O1; 3 steps equal);
            (b) ``resnet50_imagenet``, config 4's one-card lane
            (``resnet50()``, 1000 classes, b128 x 3 x 224 x 224, O1; 2
            steps equal); both also timed with cuDNN free to take its
            nondeterministic algorithms (the port's convolutions run
            under its deterministic flags); (c) ``crnn_ctc``, config 3
            (``CRNN(96, img_height=32)``, b64 x 1 x 32 x 320, 40-token
            labels of 1..95, input lengths 80, Adam(1e-3), the mean CTC
            loss, f32; 3 steps equal, and two graphed runs from one start
            equal); (d) ``small_f32``: resnet18 and crnn_tiny in f32
            (TF32 off), the card against the CPU on the same weights:
            logits, one step's loss, parameters and buffers within
            relative L2 1e-4; (e) ``mobilenet_v2`` (``mobilenet_v2()``,
            b128 x 3 x 224 x 224, Momentum(0.1, 0.9, weight_decay=4e-5),
            O1; 2 steps equal with the classifier's dropout at 0, then
            the timed steps with the published Dropout(0.2) drawing from
            the model's generator); (f) ``zoo``: one graphed O1 step of
            lenet (b256 x 1 x 28 x 28, 10 classes), alexnet, vgg16,
            squeezenet1_1, mobilenet_v1, mobilenet_v3_small / large,
            shufflenet_v2_x1_0, densenet121, googlenet (with its aux
            heads: ce(out) + 0.3 (ce(aux1) + ce(aux2))) at b32 x 3 x 224
            x 224 and inception_v3 at 299 x 299, then 5 timed replays
            capturing nothing (step ms p50, images/s, mfu); then
            mobilenet_v3_small(scale=0.5) and shufflenet_v2_x0_25 in f32
            eval, card vs CPU, logits within 1e-4.  ``--only vision``
            runs the build and this phase.
   seq2seq — Transformer-base (Vaswani et al. 2017: d_model 512, 8
            heads, 6 + 6 layers, d_ff 2048, dropout 0.1) as a user of
            ``nn.Transformer`` wraps it (``Seq2Seq``: token and position
            embeddings, the output Linear over 37000 tokens): (a)
            ``train``, b32 x 128 source and 128 target tokens, the
            causal ``tgt_mask``, Adam(1e-4, beta2 0.98, eps 1e-9), the
            graphed ``TrainStep`` at O1 through ``graphed_path`` at
            dropout 0 (12 flash forward, dK/dV and dQ launches a step:
            the encoder's self-attention and the cross-attention; the
            masked self-attention is the plain softmax), then dropout
            0.1 losses falling; (b) ``beam``, the model in bf16, eval,
            ``BeamSearchDecoder(beam_size=4)`` + ``dynamic_decode
            (max_step_num=64)`` over 8 sentences of 128 tokens (12 flash
            forwards a step over the caches; encoder ms, step ms p50,
            hypothesis tokens/s, idle share); (c) ``small_f32``, 2 + 2
            layers at d_model 128 (2 heads of 64), card vs CPU: logits
            within 1e-4, beam ids, parents and lengths equal.  Before it
            (after the kernel checks), the flash kernels are checked and
            timed at its shapes (records ``seq2seq_train``: forward,
            dK/dV, dQ at b32 h8 s128 d64 bf16; ``seq2seq_beam_sk{128,
            1, 17, 64}``: the forward at one query row).
            ``--only seq2seq`` runs the build, those checks and this
            phase.
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
the timed ``PagedGenerator`` call; ``server``: the server's measured
wave), ``train_shape`` the times of a
serving kernel at the training shapes, ``decode`` and ``f32`` the flash
forward's decode and f32 cases (and dK/dV's f32 case), ``hgmma`` the
wgmma instructions of each instantiation; ``serve``, ``generate``,
``train``, ``train_paths``, ``fit``, ``vision``, ``seq2seq``, ``moe``,
``flashmask``, ``classes``,
``speculative``,
``recovery``, ``overload``, ``tp`` and ``server`` hold each pass's
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
import warnings

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
# the recovery phase on llama_7b bf16: the unchunked serve pass's traffic
# and engine; the fault lands once every row holds RECOVERY_AT tokens; the
# wedge is an engine_wedge delay of WEDGE_DELAY_S under a watchdog timeout
# of WEDGE_TIMEOUT_S
RECOVERY_AT = 8
WEDGE_TIMEOUT_S, WEDGE_DELAY_S = 0.25, 0.6
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
# train_paths (d): Mixtral-8x7B's widths cut to 1 layer, batch 4 x 512.
# Two layers (3.165 B parameters: 50.6 GB of bf16 weights, f32 masters and
# moments and bf16 gradients) ran out of the card's 79.18 GiB in the first
# step's AdamW update, which adds the f32 gradients and the denominator
# (25.3 GB) at once (71.06 GiB allocated, 7.21 GiB reserved and free)
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S = 1, 4, 512
# the fit phase: BERT-base (the JAX example's and bench.py config 2's
# widths) at batch 32 x 128, FIT_STEPS fit steps; the loader case on the
# train cell's model: single calls (the first LOADER_WARMUP untimed),
# then run_steps of LOADER_K twice; the offload cases' steps, and the
# MoE offload case at Mixtral's widths cut to 2 layers (the depth that
# does not fit the card without offload)
FIT_B, FIT_S, FIT_STEPS = 32, 128, 20
LOADER_SINGLE, LOADER_WARMUP, LOADER_K = 10, 3, 4
OFFLOAD_STEPS = 8
OFFLOAD_MOE_LAYERS, OFFLOAD_MOE_STEPS = 2, 3
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


PRIMER_KERNEL = "spin_kernel"


def _prime():
    """Two launches of PyTorch's spin kernel (``torch.cuda._sleep``), a
    name no call here runs, to open a window ahead of the call."""
    for _ in range(2):
        torch.cuda._sleep(1000)


def profiler_window(fn, lacks, where, prime=False):
    """A ``torch.profiler`` window around one call of ``fn``, opened again
    while ``lacks(names)`` (the device kernel entries the window
    recorded) returns what it misses.  CUPTI now and then drops the
    kernel records of a window in which it asks for a new activity
    buffer: the window then holds an "Activity Buffer Request" span
    inside a launch and lacks that launch's kernel (or the ones before
    it), at times in several windows in a row.  The kernels a call takes
    are fixed by its shapes and types, so such a window is opened again,
    after a pause that doubles each time, up to ``WINDOW_TRIES`` windows,
    each logged.  With ``prime``, ``_prime`` runs first in each window,
    so a request made at the window's first launch loses a primer's
    record and not the call's (a call of one launch lost it in 6 windows
    in a row); the primer's entries are left out of the names.  Returns
    (the last window, its names, what it lacks)."""
    for i in range(WINDOW_TRIES):
        if i:
            time.sleep(0.05 * 2 ** i)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=DEVICE_ACTIVITY) as prof:
            if prime:
                _prime()
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        names = [e.key for e in events if _device_us(e) > 0
                 and not (prime and PRIMER_KERNEL in e.key)]
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
    call of ``fn`` runs, from a primed ``profiler_window``, opened again
    while it recorded no kernel at all (every call here launches one) or
    none named by a prefix in ``want``; the caller holds the names against its
    plan.  With ``grids``, also {short name without template args:
    (launch grid, block)}, as the window's exported trace records each
    kernel launch."""
    def lacks(names):
        short = [_short_kernel(n) for n in names]
        return [w for w in want if not any(n.startswith(w) for n in short)] \
            or ([] if names else ["any kernel"])

    prof, names, _missing = profiler_window(fn, lacks, "kernels_of",
                                            prime=True)
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
        if e.get("cat") == "kernel" and m and "grid" in e.get("args", {}) \
                and m.group(1) != PRIMER_KERNEL:
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
    at the training shape, and at the MoE training shape (Mixtral's 32/8
    heads of d128 at s512, batch 4: ``train_paths``' sub-case (d)),
    their times beside the plain version's and
    ``scaled_dot_product_attention``'s backward (a yardstick that
    computes dq, dk and dv together; the port never calls it)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(5)

    def case(label, dtype, b, h, kvh, sq, sk, d, causal, timed=None):
        """``timed``: None, or the record it fills: "main" (the kernel's
        own record, its ``f32`` block for f32) or a block's name."""
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
            lq, lk, lv, is_causal=causal, enable_gqa=kvh != h)
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
            if timed != "main":
                records[name][timed] = rec
            elif bf:
                records[name] = rec
            else:   # after the bf16 case
                records[name]["f32"] = rec

    bf16, f32 = torch.bfloat16, torch.float32
    b, h, s, d = TRAIN_B, TRAIN_H, TRAIN_S, TRAIN_D
    case(f"b{b} h{h} s{s} d{d} causal bf16", bf16, b, h, h, s, s, d, True,
         timed="main")
    case(f"b{b} h{h} s{s} d{d} causal f32", f32, b, h, h, s, s, d, True,
         timed="main")
    b, s = MOE_TRAIN_B, MOE_TRAIN_S
    case(f"MoE train b{b} 32/8 s{s} d128 causal bf16", bf16, b, 32, 8, s, s,
         128, True, timed="moe_train_shape")
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
          draft_model=None, warm=None, drain=False, before_wave=None,
          after_wave=None, **engine_kw):
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
    state after it recorded.  ``before_wave(eng)`` runs just after the
    counters are zeroed, ``after_wave(eng)`` once the measured wave's
    record is taken; ``engine_kw`` go to the engine (``tp``, ...)."""
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
                                  device=device, **engine_kw) as eng:
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
        if before_wave is not None:
            before_wave(eng)
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
        if after_wave is not None:
            after_wave(eng)
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


def classes_wave(eng, batch, interactive, fifo=False):
    """One wave of the classes traffic on ``eng``: the batch requests
    queued together under the engine's lock, then, once the first has a
    chunk in, the interactive ones together, from tenants a, b, a, b (in
    the default class with ``fifo``); waits for every request and the
    card.  Returns (batch, interactive) requests."""
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
        return classes_wave(eng, batch, interactive, fifo)

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


def recovery_phase(model, prompts, sharer, warmup, kernels, plain, card):
    """Crash recovery on llama_7b in bf16, full depth, over the unchunked
    serve pass's traffic and engine (8 slots, the table pinned at
    ``SERVE_TABLE_PAGES``).  Each pass serves a warm-up wave with its own
    recovery (so every bucket the recovery steps through is captured),
    then the measured wave, with the launch counters zeroed just before
    it; the fault is installed at a step boundary once every row holds
    ``RECOVERY_AT`` tokens, and the plan is cleared as the recovery
    starts, so one fault lands in each wave:

    - ``loss_batched`` / ``loss_per_row``: one ``buffer_loss`` (both pools
      zeroed), the survivors replayed in one batched round or a prefill
      a row;
    - ``wedge``: ``step_timeout_s=WEDGE_TIMEOUT_S`` and one
      ``engine_wedge`` delay of ``WEDGE_DELAY_S``: the watchdog flags the
      step, the engine zeroes the pools, replays a row at a time and
      retries;
    - ``snapshot_restore``: ``snapshot`` mid-wave, a JSON round trip,
      ``stop``, then ``restore`` on a fresh engine over the same model
      (which first serves the warm-up wave).

    The recovery window runs from the engine's failure hook
    (``_after_step_failure``, entered as the failed call returns and is
    rolled back) to the end of the replay: its length is the MTTR, and
    the captures (must be 0) and kernel launches inside it are read
    there.  The survivors' cached K/V (every resident slot, all layers)
    is copied at the step boundary before the fault and held against the
    replayed K/V (relative L2, reported: bf16 replay re-ingests decoded
    tokens through prefill attention).  Fails unless every request
    completes, no batched replay round raised in either wave (the
    engine would fall back to a row at a time without a word), each
    measured wave recovers once with no quarantine,
    replays every one of its 8 rows, captures nothing in the window and
    launches the flash kernel once a layer of each per-row replay and
    none in a batched round, the watchdog flags the wedge, the restored
    streams complete, and each engine drains with the pool whole.
    Stream agreement with the fault-free unchunked pass (``plain``) is
    reported with the first divergences (bf16), whose f32 top-2 gap
    comes later.  Returns the record and the divergences."""
    from paddle_tpu_torch.distributed.watchdog import CommTaskManager
    from paddle_tpu_torch.inference.continuous import \
        ContinuousBatchingEngine
    from paddle_tpu_torch.testing import faults
    cfg = model.config
    device = model.model.embed_tokens.weight.device
    plain_rec, plain_reqs = plain
    layers = cfg.num_hidden_layers
    mgr = CommTaskManager.instance()
    mgr._scan_interval = 0.05
    free, total = torch.cuda.mem_get_info(device)
    log(f"recovery: {free / 2**30:.2f} of {total / 2**30:.2f} GiB free, "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated "
        "at the start")

    def engine(**kw):
        return ContinuousBatchingEngine(
            model, total_pages=1024, page_size=16, max_batch=8,
            min_table_pages=SERVE_TABLE_PAGES, device=device, **kw)

    def submit_wave(eng, ps, sh):
        reqs = []
        with eng._cond:
            for i, p in enumerate(ps):
                reqs.append(eng.submit(p, max_new_tokens=32,
                                       do_sample=i >= len(ps) - 2,
                                       temperature=0.8, seed=100 + i))
        while reqs[0].first_token_at is None and not reqs[0].done.is_set():
            time.sleep(0.001)
        reqs.append(eng.submit(sh, max_new_tokens=32))
        return reqs

    def ripe(reqs, label):
        while not all(len(r.generated) >= RECOVERY_AT for r in reqs):
            if any(r.done.is_set() for r in reqs):
                raise AssertionError(f"recovery {label}: a request ended "
                                     f"before every row held "
                                     f"{RECOVERY_AT} tokens")
            time.sleep(0.0005)

    def at_boundary(eng, fn):
        """``fn()`` with the engine's loop held between two steps."""
        with eng._cond:
            eng._snap_waiters += 1
            try:
                while eng._stepping:
                    eng._cond.wait(0.1)
                return fn()
            finally:
                eng._snap_waiters -= 1
                eng._cond.notify_all()

    def resident(eng, reqs):
        """Every live row's cached (page, slot), flat, on the card."""
        ps = eng.cache.page_size
        idx = []
        for r in reqs:
            pos = np.arange(eng.cache.length(r.seq_id))
            pages = np.asarray(eng.cache._seq_pages[r.seq_id])
            idx.append(pages[pos // ps] * ps + pos % ps)
        return torch.as_tensor(np.concatenate(idx), device=device)

    def gather(eng, idx):
        out = []
        for pool in eng.cache.k_pages + eng.cache.v_pages:
            kvh, total, ps, d = pool.shape
            out.append(pool.view(kvh, total * ps, d).index_select(1, idx))
        return out

    def hook(eng, window):
        """Wrap the failure hook: clear the plan (one fault a wave) and
        record the recovery window, and the batched replay: record what
        made a round fail (the engine falls back to a row at a time
        without a word)."""
        orig = eng._after_step_failure
        orig_batch = eng._replay_kv_batch

        def batch(rows, targets):
            try:
                return orig_batch(rows, targets)
            except Exception as e:  # noqa: BLE001 — recorded, re-raised
                window.setdefault("batch_errors", []).append(repr(e)[:400])
                raise

        eng._replay_kv_batch = batch

        def hooked(error=None, exclude=(), in_step=False):
            faults.clear()
            t0 = time.perf_counter()
            before = dict(captures=eng.captures, launches=_counts(kernels),
                          dispatches=eng.replay_dispatches,
                          replays=eng.survivor_replays,
                          rebuilds=eng.rebuilds)
            out = orig(error, exclude, in_step)
            if eng.rebuilds > before["rebuilds"]:
                torch.cuda.synchronize()
                w = dict(mttr_s=time.perf_counter() - t0,
                         recovery_s=eng.recovery_s[-1],
                         error=type(error).__name__,
                         peak_reserved_gib=torch.cuda.max_memory_reserved(
                             device) / 2**30,
                         captures=eng.captures - before["captures"],
                         replay_dispatches=eng.replay_dispatches
                         - before["dispatches"],
                         survivors_replayed=eng.survivor_replays
                         - before["replays"],
                         launches={n: c - before["launches"][n]
                                   for n, c in _counts(kernels).items()})
                snap = window.get("pages_before")
                if snap is not None:
                    after = gather(eng, window["idx"])
                    num = sum(float((a.float() - b.float()).norm() ** 2)
                              for a, b in zip(after, snap))
                    den = sum(float(b.float().norm() ** 2) for b in snap)
                    per = [float((a.float() - b.float()).norm()
                                 / b.float().norm().clamp_min(1e-30))
                           for a, b in zip(after, snap)]
                    w.update(pages_rel_l2=(num / den) ** 0.5,
                             pages_rel_l2_max=max(per),
                             pages_rel_l2_layer0=max(per[0],
                                                     per[layers]))
                    del after, snap
                    window.pop("pages_before")
                window.setdefault("recoveries", []).append(w)
            return out

        eng._after_step_failure = hooked

    def timed_ragged(eng, times):
        orig = eng._decoder.ragged_step

        def ragged_step(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            times.append(time.perf_counter() - t0)
            return out

        eng._decoder.ragged_step = ragged_step

    def fault_wave(eng, ps, sh, plan, window, label, copy=False):
        reqs = submit_wave(eng, ps, sh)
        ripe(reqs, label)

        def install():
            if copy:
                window["idx"] = resident(eng, reqs)
                window["pages_before"] = gather(eng, window["idx"])
            faults.install(faults.FaultPlan(plan))

        at_boundary(eng, install)
        for r in reqs:
            r.result(timeout=600)
        torch.cuda.synchronize()
        faults.clear()
        return reqs

    def agree(label, reqs, want_reqs):
        at = [first_divergence(r.generated, w.generated)
              for r, w in zip(reqs, want_reqs)]
        for i, (a, r, w) in enumerate(zip(at, reqs, want_reqs)):
            if a is not None and not w.do_sample:
                divergences.append(dict(
                    label=label, request=i, position=a,
                    ids=np.concatenate([w.prompt, np.asarray(
                        w.generated[:a], np.int32)]),
                    tokens=(int(w.generated[a]), int(r.generated[a]))))
        return at

    def finish(eng, label, reqs):
        problems = []
        for i, r in enumerate(reqs):
            if r.error is not None or len(r.generated) != 32 \
                    or not all(0 <= t < cfg.vocab_size
                               for t in r.generated):
                problems.append(f"request {i} did not complete "
                                f"({r.error})")
        drained = eng.drain(timeout=300)
        whole = drained and eng.cache.free_pages == eng.cache.total_pages \
            and eng._reserved_pages == eng._pad_pages
        if not whole:
            problems.append(f"drained {drained}, free pages "
                            f"{eng.cache.free_pages}, reserved "
                            f"{eng._reserved_pages}")
        return problems, whole

    rec, divergences = {}, []
    loss = [{"site": "buffer_loss", "nth": 1}]
    wedge = [{"site": "engine_wedge", "kind": "delay",
              "delay_s": WEDGE_DELAY_S, "nth": 1}]
    for label, kw, plan in (
            ("loss_batched", dict(replay_batch=True), loss),
            ("loss_per_row", dict(replay_batch=False), loss),
            ("wedge", dict(step_timeout_s=WEDGE_TIMEOUT_S), wedge)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with engine(**kw) as eng:
                batched = eng.replay_batch
                warm_window, window, times = {}, {}, []
                hook(eng, warm_window)
                fault_wave(eng, *warmup, plan, warm_window, label)
                del eng._after_step_failure      # the warm-up's hooks
                del eng._replay_kv_batch
                hook(eng, window)
                timed_ragged(eng, times)
                captured = eng.captures
                counts0 = {k: getattr(eng, k) for k in (
                    "rebuilds", "quarantined", "decode_retries")}
                timeouts = mgr.timeouts
                torch.cuda.reset_peak_memory_stats(device)
                _zero(kernels)
                t0 = time.perf_counter()
                reqs = fault_wave(eng, prompts, sharer, plan, window,
                                  label, copy=True)
                wall = time.perf_counter() - t0
                got = _counts(kernels)
                problems, whole = finish(eng, label, reqs)
                measured_captures = eng.captures - captured
                counts = {k: getattr(eng, k) - v for k, v in counts0.items()}
                flagged = mgr.timeouts - timeouts
        wins = window.get("recoveries", [])
        w = wins[0] if len(wins) == 1 else {}
        for where, win in (("warm-up", warm_window), ("measured", window)):
            if win.get("batch_errors"):
                problems.append(f"{where} wave: a batched replay round "
                                f"failed: {win['batch_errors']}")
        if len(wins) != 1 or counts["rebuilds"] != 1 \
                or counts["quarantined"]:
            problems.append(f"recoveries {wins}, counters {counts}")
        else:
            if w["captures"]:
                problems.append(f"{w['captures']} captures in the window")
            if w["survivors_replayed"] != len(reqs) \
                    or not w["replay_dispatches"]:
                problems.append(f"replayed {w['survivors_replayed']} rows "
                                f"in {w['replay_dispatches']} dispatches")
            flash = w["launches"]["flash_attention_forward"]
            want_flash = 0 if batched else layers * w["replay_dispatches"]
            if flash != want_flash or w["launches"]["rms_norm"] \
                    != (2 * layers + 1) * w["replay_dispatches"]:
                problems.append(f"window launches {w['launches']}, want "
                                f"{want_flash} flash")
        if label == "wedge" and (flagged < 1 or w.get("error")
                                 != "_EngineWedged"):
            problems.append(f"watchdog timeouts {flagged}, window {w}")
        if problems:
            raise AssertionError(f"recovery {label}: " + "; ".join(problems))
        at = agree(label, reqs, plain_reqs)
        stats = serve_stats(reqs, wall)
        rec[label] = dict(
            card=card, replay_batch=batched, **w, ragged_step_ms_p50=1e3 * float(
                np.median(times)) if times else None,
            ragged_steps=len(times),
            ttft_p50_s=stats["ttft_p50_s"], tpot_p50_s=stats["tpot_p50_s"],
            ttft_p50_fault_free_s=plain_rec["ttft_p50_s"],
            tpot_p50_fault_free_s=plain_rec["tpot_p50_s"],
            wall_s=wall, captures_wave=measured_captures,
            warmup_mttr_s=warm_window.get("recoveries", [{}])[0]
            .get("mttr_s"), watchdog_timeouts=flagged,
            decode_retries=counts["decode_retries"],
            streams_equal_fault_free=sum(a is None for a in at),
            first_divergence=at, wave_launches=got, drained=whole)
        log(f"recovery {label}: " + json.dumps(
            {k: v for k, v in rec[label].items()
             if k not in ("launches", "wave_launches")}))
        log(f"  window launches: " + json.dumps(w["launches"]))
        del reqs, eng
        gc.collect()
        torch.cuda.empty_cache()
    mgr.stop()

    # snapshot mid-wave, JSON, stop; restore on a fresh engine
    label = "snapshot_restore"
    with engine() as eng_a:
        for r in submit_wave(eng_a, *warmup):
            r.result(timeout=600)
        reqs = submit_wave(eng_a, prompts, sharer)
        ripe(reqs, label)
        t0 = time.perf_counter()
        snap = eng_a.snapshot()
        snapshot_ms = 1e3 * (time.perf_counter() - t0)
        text = json.dumps(snap)
        eng_a.stop()
    gc.collect()
    torch.cuda.empty_cache()
    snap = json.loads(text)
    cut = {e["request_id"]: len(e["generated"]) for e in snap["requests"]}
    with engine() as eng_b:
        for r in submit_wave(eng_b, *warmup):
            r.result(timeout=600)
        captured = eng_b.captures
        _zero(kernels)
        t0 = time.perf_counter()
        restored = eng_b.restore(snap)
        while not all(len(r.generated) > cut[r.request_id]
                      or r.done.is_set() for r in restored):
            time.sleep(0.0005)
        next_token_s = time.perf_counter() - t0
        for r in restored:
            r.result(timeout=600)
        wall = time.perf_counter() - t0
        got = _counts(kernels)
        problems, whole = finish(eng_b, label, restored)
        restore_captures = eng_b.captures - captured
    if len(restored) != len(reqs) or len(snap["requests"]) != len(reqs) \
            or any(c < RECOVERY_AT for c in cut.values()):
        problems.append(f"{len(snap['requests'])} entries, {len(restored)} "
                        f"restored, cut {cut}")
    if problems:
        raise AssertionError(f"recovery {label}: " + "; ".join(problems))
    by_prompt = {tuple(w.prompt.tolist()): w for w in plain_reqs}
    at = agree(label, restored, [by_prompt[tuple(r.prompt.tolist())]
                                 for r in restored])
    rec[label] = dict(
        card=card, snapshot_ms=snapshot_ms, entries=len(snap["requests"]),
        snapshot_bytes=len(text), generated_at_cut=sorted(cut.values()),
        restore_to_next_token_s=next_token_s, wall_s=wall,
        captures_restore=restore_captures, launches=got,
        streams_equal_fault_free=sum(a is None for a in at),
        first_divergence=at, drained=whole)
    log(f"recovery {label}: " + json.dumps(
        {k: v for k, v in rec[label].items() if k != "launches"}))
    del restored, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return rec, divergences


def warm_ragged_buckets(eng, rows=(1, 2, 4, 8), spans=(1, 128, 256)):
    """Capture the ragged step's greedy graphs at every (rows, span)
    bucket a classes wave can reach once pauses change its batch: rows
    sit on scratch sequences at context 0, freed after."""
    for b in rows:
        for span in spans:
            seqs = [f"__warm{i}" for i in range(b)]
            eng._decoder.ragged_step(
                eng.cache, seqs, [np.zeros(span, np.int32)] * b, [0] * b,
                sampling=(np.zeros(b, np.uint32), np.ones(b, np.float32),
                          np.zeros(b, bool)))
            for sid in seqs:
                eng.cache.free(sid)
    torch.cuda.synchronize()


def overload_phase(model, seed, classes_tpot_p50, kernels, card):
    """The overload controls on llama_7b bf16 with the classes traffic
    (``classes_wave``: 8 batch requests of 1024 tokens, then 4
    interactive of 128, 32 new tokens, 256-token chunks, 8 slots, the
    table pinned at ``SERVE_TABLE_PAGES``), each sub-case on an engine of
    its own:

    - ``tpot``: the interactive class's ``tpot_budget_s`` at 0.9x, then
      2x, the interactive TPOT p50 of this run's ``classes`` pass, the
      batch class preemptible, every ragged bucket a pause can reach
      captured first: decode preemptions, the most rows parked at once
      and the rows parked when the last interactive request finished,
      TPOT p50 by class and decode tokens/s beside the ``classes``
      pass's, decode preemptions (the trigger's and the slot
      preemptions of decoding rows); the 2x budget must pause nothing;
    - ``shed``: the batch class's ``deadline_s`` at 2x the decode-step
      p50 the controller reads (the process's ``decode_step_seconds``),
      a burst of 4 interactive then 24 batch arrivals: sheds by class
      (batch only), each Retry-After within [1, 30],
      ``retry_after_hint`` by class, every admitted request complete;
    - ``brownout``: thresholds (0.25, 0.5, 0.75, 0.95) over
      ``max_queue=16``, the buckets captured first, 32 arrivals 10 ms
      apart (batch, standard, interactive, batch, ...) of 128 tokens:
      the rungs passed through, the transitions, sheds by class (never
      interactive), the seconds from the last completion to rung 0;
    - ``trace``: the classes wave with capture off, then on
      (``monitor.start_capture``): TPOT p50 of both, the chrome trace's
      events (both schema checks return nothing), the delta of
      ``trace_dropped_events_total``, the bytes of ``prometheus_text()``.

    The launch counters are zeroed before each measured wave of tpot and
    trace and read after it; their captures must be 0 and the paged,
    RMSNorm and RoPE kernels must launch.  Returns the record and the
    launches of the trace-off wave."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.inference import continuous as cont
    from paddle_tpu_torch.inference.scheduler import PriorityClass
    rng = np.random.default_rng(seed + 3)
    vocab = model.config.vocab_size
    device = model.model.embed_tokens.weight.device
    reg = monitor.get_registry()

    def series(name, **labels):
        m = reg.get(name)
        return 0.0 if m is None else m.value(**labels)

    def prompt(n):
        return rng.integers(0, vocab, n).astype(np.int32)

    def draw():
        return ([prompt(CLASSES_BATCH_PROMPT) for _ in range(CLASSES_BATCH)],
                [prompt(CLASSES_PROMPT) for _ in CLASSES_TENANTS])

    def classes(tpot=None, deadline=None):
        return (PriorityClass("interactive", rank=0, weight=8,
                              tpot_budget_s=tpot),
                PriorityClass("standard", rank=1, weight=4),
                PriorityClass("batch", rank=2, weight=1, preemptible=True,
                              deadline_s=deadline))

    def engine(**kw):
        return cont.ContinuousBatchingEngine(
            model, total_pages=1024, page_size=16, max_batch=8,
            prefill_chunk_tokens=256, min_table_pages=SERVE_TABLE_PAGES,
            device=device, **kw)

    def complete(reqs, label):
        for r in reqs:
            r.result(timeout=600)       # raises the request's error
            if not all(0 <= t < vocab for t in r.generated):
                raise AssertionError(f"overload {label}: a token out of "
                                     "the vocabulary")

    def measured_wave(eng, wave, label):
        """One classes wave, launch counters zeroed just before it; the
        rows the TPOT trigger pauses are counted (slot preemptions of
        decoding rows count in ``decode_preemptions_total`` too), and the
        parked rows sampled at every ragged step."""
        ragged, parked = eng._decoder.ragged_step, []
        trigger, parks = eng._tpot_preempt_locked, [0]

        def sampled(*a, **kw):
            parked.append((time.perf_counter(),
                           sum(r._tpot_parked for r in eng._preempted),
                           eng._step_ewma or 0.0))
            return ragged(*a, **kw)

        def counted():
            n = len(eng._preempted)
            trigger()
            parks[0] += len(eng._preempted) - n

        eng._decoder.ragged_step = sampled
        eng._tpot_preempt_locked = counted
        captured, pre0 = eng.captures, series("decode_preemptions_total")
        _zero(kernels)
        t0 = time.perf_counter()
        breqs, ireqs = classes_wave(eng, *wave)
        wall = time.perf_counter() - t0
        eng._decoder.ragged_step = ragged
        eng._tpot_preempt_locked = trigger
        complete(breqs + ireqs, label)
        launches = _counts(kernels)
        last_i = max(r.finished_at for r in ireqs)
        by_class = {"batch": serve_stats(breqs, wall),
                    "interactive": serve_stats(ireqs, wall)}
        rec = dict(
            tpot_p50_s={c: st["tpot_p50_s"] for c, st in by_class.items()},
            ttft_p50_s={"interactive":
                        by_class["interactive"]["ttft_p50_s"]},
            decode_tok_s=serve_stats(breqs + ireqs, wall)["decode_tok_s"],
            wall_s=wall, captures=eng.captures - captured,
            decode_preemptions=series("decode_preemptions_total") - pre0,
            tpot_parks=parks[0],
            parked_max=max(n for _, n, _ in parked),
            parked_at_last_interactive=[n for t, n, _ in parked
                                        if t <= last_i][-1],
            step_ewma_max_s=max(e for _, _, e in parked),
            decode_p50_read_s=cont._decode_p50_seconds())
        missing = [n for n in ("paged_attention", "rms_norm", "apply_rope")
                   if not launches[n]]
        if rec["captures"] or missing:
            raise AssertionError(f"overload {label}: captures "
                                 f"{rec['captures']} in the measured wave, "
                                 f"kernels never launched {missing}")
        return rec, launches

    out, launches = {"classes_tpot_p50_s": classes_tpot_p50}, {}
    # tpot: the trigger against 0.9x and 2x the classes pass's TPOT
    for factor in (0.9, 2.0):
        label = f"tpot_{factor}x"
        budget = factor * classes_tpot_p50
        with engine(scheduler_classes=classes(tpot=budget)) as eng:
            warm_ragged_buckets(eng)
            rec, _ = measured_wave(eng, draw(), label)
            rec.update(budget_s=budget,
                       counts=eng.scheduler_info()["counts"])
        out[label] = rec
        log(f"overload {label}: " + json.dumps(rec))
        gc.collect()
        torch.cuda.empty_cache()
    if out["tpot_2.0x"]["tpot_parks"]:
        raise AssertionError("overload tpot: a budget of 2x the classes "
                             "TPOT p50 paused rows: "
                             f"{out['tpot_2.0x']['tpot_parks']}")

    # shed: the batch deadline at 2x the decode p50 the controller reads
    p50 = cont._decode_p50_seconds()
    deadline = 2 * p50
    with engine(scheduler_classes=classes(deadline=deadline)) as eng:
        captured = eng.captures
        sheds = {"interactive": [], "standard": [], "batch": []}
        admitted = []
        t0 = time.perf_counter()
        for cls, n in (("interactive", 4), ("batch", 24)):
            for _ in range(n):
                try:
                    admitted.append(eng.submit(
                        prompt(CLASSES_PROMPT if cls == "interactive"
                               else CLASSES_BATCH_PROMPT),
                        max_new_tokens=CLASSES_NEW, priority=cls))
                except cont.EngineSaturated as e:
                    sheds[e.priority_class].append(e.retry_after_s)
        burst_s = time.perf_counter() - t0
        hints = {c: eng.retry_after_hint(c) for c in sheds}
        complete(admitted, "shed")
        rec = dict(decode_p50_read_s=p50, deadline_s=deadline,
                   burst_s=burst_s, admitted=len(admitted),
                   sheds={c: len(v) for c, v in sheds.items()},
                   retry_after_s=sorted(set(sheds["batch"])),
                   retry_after_hint=hints,
                   counts=eng.scheduler_info()["counts"],
                   captures=eng.captures - captured)
    out["shed"] = rec
    log("overload shed: " + json.dumps(rec))
    if not sheds["batch"] or sheds["interactive"] or sheds["standard"] \
            or not all(1 <= s <= 30 for s in sheds["batch"]) \
            or not all(1 <= h <= 30 for h in hints.values()):
        raise AssertionError(f"overload shed: {rec}")
    gc.collect()
    torch.cuda.empty_cache()

    # brownout: a 32-request burst against the ladder, which climbs a
    # rung an iteration: the burst's buckets are captured first, so no
    # iteration of it waits on a capture
    with engine(brownout_thresholds=(0.25, 0.5, 0.75, 0.95),
                max_queue=16) as eng:
        warm_ragged_buckets(eng, spans=(1, CLASSES_PROMPT))
        rungs = []
        set_rung = eng._set_brownout_locked

        def record(level, pressure):
            if level != eng._brownout:
                rungs.append(dict(t_s=time.perf_counter() - t0,
                                  rung=level, pressure=pressure))
            set_rung(level, pressure)

        eng._set_brownout_locked = record
        order = ("batch", "standard", "interactive", "batch")
        sheds = {c: 0 for c in order}
        full, admitted = 0, []
        t0 = time.perf_counter()
        for i in range(32):
            try:
                admitted.append(eng.submit(prompt(CLASSES_PROMPT),
                                           max_new_tokens=CLASSES_NEW,
                                           priority=order[i % 4]))
            except cont.EngineSaturated as e:
                if e.retry_after_s is None:
                    full += 1          # the class's queue is full
                else:
                    sheds[e.priority_class] += 1
            time.sleep(0.01)
        complete(admitted, "brownout")
        done = max(r.finished_at for r in admitted)
        end = time.monotonic() + 10
        while eng.scheduler_info()["brownout_level"] and \
                time.monotonic() < end:
            time.sleep(0.001)
        back = time.perf_counter() - done
        rec = dict(rungs_reached=sorted({r["rung"] for r in rungs}),
                   transitions=rungs, sheds=sheds, queue_full=full,
                   admitted=len(admitted),
                   back_to_rung_0_s=back,
                   level_after=eng.scheduler_info()["brownout_level"])
    out["brownout"] = rec
    log("overload brownout: " + json.dumps(rec))
    if not rungs or sheds["interactive"] or rec["level_after"] != 0:
        raise AssertionError(f"overload brownout: {rec}")
    gc.collect()
    torch.cuda.empty_cache()

    # trace: the same wave with capture off, then on
    with engine(scheduler_classes=classes()) as eng:
        warm_ragged_buckets(eng)
        off, launches["overload"] = measured_wave(eng, draw(), "trace off")
        dropped = series("trace_dropped_events_total")
        monitor.start_capture()
        try:
            on, _ = measured_wave(eng, draw(), "trace on")
        finally:
            monitor.stop_capture()
        payload = monitor.export_chrome_trace()
        problems = monitor.validate_chrome_trace(payload)
        rec = dict(tpot_p50_off_s=off["tpot_p50_s"],
                   tpot_p50_on_s=on["tpot_p50_s"],
                   decode_tok_s_off=off["decode_tok_s"],
                   decode_tok_s_on=on["decode_tok_s"],
                   trace_events=len(payload["traceEvents"]),
                   trace_bytes=len(json.dumps(payload)),
                   requests_traced=len(monitor.get_tracer().request_ids()),
                   dropped_events=series("trace_dropped_events_total")
                   - dropped,
                   validate_chrome_trace=problems,
                   prometheus_text_bytes=len(monitor.prometheus_text()),
                   captures=off["captures"] + on["captures"])
    out["trace"] = rec
    log("overload trace: " + json.dumps(rec))
    if problems or rec["requests_traced"] != CLASSES_BATCH \
            + len(CLASSES_TENANTS):
        raise AssertionError(f"overload trace: {rec}")
    for label in ("tpot_0.9x", "tpot_2.0x"):
        out[label]["card"] = card
    out["card"] = card
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


# ------------------------------------------------------ tensor parallel
# the tp phase: tp=2 as two processes on the one card over gloo, asked
# for explicitly (NCCL, the default on a card, puts rank r on cuda:r and
# so needs two cards; it runs (a) too where there are).  (a) llama_7b's
# widths cut to TP_F32_LAYERS layers in f32 beside tp=1 on the card:
# prefill logits, TP_F32_PROMPTS greedy streams of TP_F32_NEW tokens,
# unified and legacy, and the int8 collectives.  (b) the bf16 llama_7b
# at full depth with the serve traffic beside the unchunked pass, then a
# launch wave (the serve lengths, other tokens, queued together, greedy,
# TP_LAUNCH_NEW tokens) on the tp=2 engine and on an eager tp=1 one
TP, TP_BACKEND = 2, "gloo"
TP_F32_LAYERS, TP_F32_PROMPTS, TP_F32_NEW = 2, 8, 16
TP_LAUNCH_NEW = 16
TP_QUANT_CPU_SHARE = 0.25
TP_KERNELS = ("paged_attention", "flash_attention_forward", "rms_norm",
              "apply_rope")


def _worker_counts(group, kernels):
    """Each worker's launch counts, under ``kernels``' names."""
    return [{n: got[fn.__name__] for n, fn in kernels.items()}
            for got in group.query("launches")]


def _queued_wave(eng, prompts, new):
    """Every prompt queued under the engine's lock (admitted together),
    greedy; returns the requests once all are done, and the wave's
    dispatches by mode."""
    before = dict(eng.dispatches)
    with eng._cond:
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    for r in reqs:
        r.result(timeout=600)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs, {m: n - before[m] for m, n in eng.dispatches.items()}


def tp_f32_check(seed, dev, backend, cfg=None):
    """(a): f32 at llama_7b's widths (``cfg``) cut to TP_F32_LAYERS: a
    tp=2 decoder's prefill logits against a tp=1 one's (relative L2 <=
    1e-5, argmax equal), the pool bytes, TP_F32_PROMPTS greedy streams of
    tp=2 engines equal to tp=1 engines' (unified and legacy), and the
    int8 collectives (the card's prefill logits nearer the same tp=2
    decoder's on the CPU than TP_QUANT_CPU_SHARE of the quantization's
    own distance; their distance from tp=1 and the streams they keep
    equal reported)."""
    from paddle_tpu_torch.distributed.tensor_parallel import \
        TensorParallelGroup
    from paddle_tpu_torch.inference.continuous import \
        ContinuousBatchingEngine
    from paddle_tpu_torch.inference.paged import PagedDecoder
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    from paddle_tpu_torch.ops.paged_attention import PagedKVCache
    cfg = cfg or llama_7b()
    cfg.num_hidden_layers = TP_F32_LAYERS
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                             seed=seed + 31)
    rng = np.random.default_rng(seed + 31)
    ids = rng.integers(0, cfg.vocab_size, (1, 300)).astype(np.int32)
    rec = dict(backend=backend, layers=TP_F32_LAYERS, dtype="float32")
    t0 = time.perf_counter()
    with TensorParallelGroup(TP, dev, backend=backend) as g:
        rec["group_start_s"] = time.perf_counter() - t0
        one = PagedDecoder(model)
        c1 = PagedKVCache.from_model(model, total_pages=64, page_size=16)
        want = torch.from_numpy(one.prefill(c1, [0], ids))
        for quant in (False, True):
            dec = PagedDecoder(model, tp_group=g, tp_quant_collectives=quant)
            cache = PagedKVCache.from_model(model, total_pages=64,
                                            page_size=16, tp_group=g)
            got = torch.from_numpy(dec.prefill(cache, [0], ids))
            key = "quant_" if quant else ""
            rec[key + "prefill_rel_l2"] = float((got - want).norm()
                                                / want.norm())
            rec[key + "prefill_max_abs_err"] = float(
                (got - want).abs().max())
            rec[key + "argmax_equal"] = int(got.argmax()) \
                == int(want.argmax())
        quant_logits = got
        rec.update(kv_pool_bytes=cache.kv_pool_bytes,
                   kv_pool_bytes_per_chip=cache.kv_pool_bytes_per_chip,
                   kv_pool_bytes_tp1=c1.kv_pool_bytes)
    if rec["prefill_rel_l2"] > 1e-5 or not rec["argmax_equal"] \
            or not torch.isfinite(quant_logits).all():
        raise AssertionError(f"tp f32 over {backend}: tp=2 prefill logits "
                             f"stray from tp=1's: {rec}")
    if rec["kv_pool_bytes_per_chip"] * TP != rec["kv_pool_bytes"] \
            or rec["kv_pool_bytes"] != rec["kv_pool_bytes_tp1"]:
        raise AssertionError(f"tp f32: pool bytes {rec}")
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(16, 257, TP_F32_PROMPTS)]

    def streams(**kw):
        with ContinuousBatchingEngine(model, total_pages=256, page_size=16,
                                      max_batch=8, device=dev, **kw) as eng:
            reqs, _ = _queued_wave(eng, prompts, TP_F32_NEW)
            return ([list(r.generated) for r in reqs],
                    type(eng._decoder).__name__)

    for unified in (True, False):
        label = "unified" if unified else "legacy"
        base, rec[f"{label}_decoder_tp1"] = streams(unified_step=unified)
        got, rec[f"{label}_decoder_tp2"] = streams(
            unified_step=unified, tp=TP, tp_backend=backend)
        rec[f"{label}_streams_equal"] = sum(a == b
                                            for a, b in zip(base, got))
        if got != base:
            raise AssertionError(
                f"tp f32 {label} over {backend}: tp=2 streams {got} differ "
                f"from tp=1's {base}")
        if label == "unified":
            unified_base = base
    # the int8 collectives round each block half's partial sum to one
    # absmax int8 scale over the whole (tokens x 4096) tensor, which the
    # largest rows set: the logits move from tp=1's by the scheme itself
    # (JAX's, which the CPU tests hold the port to), and that distance is
    # reported, with the streams they flip and the tp=1 f32 top-2 gap at
    # each first divergence.  What is held is that the card computes the
    # same quantized function as the CPU (the plain versions, gloo): the
    # rounding is discontinuous, so the card's f32 differences flip a
    # few codes, but the card's quantized logits must lie far closer to
    # the CPU's than either to the unquantized ones (a wrong scale or
    # gather would put them a whole quantization error apart)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=None)
    cpu_model.load_state_dict(model.state_dict())
    exact = torch.from_numpy(PagedDecoder(cpu_model).prefill(
        PagedKVCache.from_model(cpu_model, total_pages=64, page_size=16),
        [0], ids))
    with TensorParallelGroup(TP, "cpu") as g:
        dec = PagedDecoder(cpu_model, tp_group=g, tp_quant_collectives=True)
        cache = PagedKVCache.from_model(cpu_model, total_pages=64,
                                        page_size=16, tp_group=g)
        host = torch.from_numpy(dec.prefill(cache, [0], ids))
    del cpu_model, dec, cache
    rec["quant_prefill_rel_l2_card_vs_cpu"] = float(
        (quant_logits - host).norm() / host.norm())
    rec["quant_prefill_rel_l2_cpu_vs_exact"] = float(
        (host - exact).norm() / exact.norm())
    if rec["quant_prefill_rel_l2_card_vs_cpu"] \
            > TP_QUANT_CPU_SHARE * rec["quant_prefill_rel_l2_cpu_vs_exact"]:
        raise AssertionError(
            f"tp f32 int8 collectives over {backend}: the card's prefill "
            f"logits are {rec['quant_prefill_rel_l2_card_vs_cpu']} "
            f"(relative L2) from the CPU's, past {TP_QUANT_CPU_SHARE} of "
            f"the quantization's own distance, "
            f"{rec['quant_prefill_rel_l2_cpu_vs_exact']}")
    got, _ = streams(tp=TP, tp_backend=backend, tp_quant_collectives=True)
    divergences = []
    for i, (a, b) in enumerate(zip(unified_base, got)):
        at = first_divergence(b, a)
        if at is not None:
            divergences.append(dict(
                label="tp2_int8_collectives", request=i, position=at,
                ids=np.concatenate([prompts[i],
                                    np.asarray(a[:at], np.int32)]),
                tokens=(int(a[at]), int(b[at]))))
    rec["quant_streams_equal"] = TP_F32_PROMPTS - len(divergences)
    rec["quant_divergence_gaps"] = top2_gaps(model, divergences)
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def tp_serve_check(model, prompts, sharer, warmup, kernels, plain, seed,
                   card, dev, backend=TP_BACKEND):
    """(b): the bf16 model at full depth served at tp=2 over ``backend``
    (gloo: both ranks on the one card) with the serve traffic (a warm-up
    wave, then the measured one), beside the unchunked tp=1 pass
    ``plain`` = (its record, its
    requests): TTFT, TPOT, decode tokens/s, each rank's peak memory and
    launches, the block reductions a forward on each rank (2 a layer),
    the streams against tp=1 (bf16: reported, with the first
    divergences); then the launch wave on the same engine and on an
    eager tp=1 engine: each rank's paged, flash, RMSNorm and RoPE
    launches must equal the eager tp=1 pass's."""
    from paddle_tpu_torch.inference import continuous
    from paddle_tpu_torch.inference.paged import PagedDecoder
    cfg = model.config
    layers = cfg.num_hidden_layers
    plain_rec, plain_reqs = plain
    rng = np.random.default_rng(seed + 37)
    launch_prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                      for n in [len(p) for p in prompts] + [len(sharer)]]
    state = {}

    def before(eng):
        g = eng.tp_group
        g.query("zero_launches")
        g.query("reset_peak")
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        state["reduces"] = (g.collectives.reduces, g.query("reduces")[0])

    def after(eng):
        g = eng.tp_group
        if dev.type == "cuda":
            torch.cuda.synchronize()
        state["rank0"] = {n: fn.launches for n, fn in kernels.items()}
        state["rank1"] = _worker_counts(g, kernels)[0]
        state["peak"] = [torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None,
                         *g.query("memory")]
        r0, r1 = state["reduces"]
        state["reduces"] = (g.collectives.reduces - r0,
                            g.query("reduces")[0] - r1)
        state["decoder"] = type(eng._decoder).__name__
        for fn in kernels.values():
            fn.launches = 0
        g.query("zero_launches")
        _, state["launch_dispatches"] = _queued_wave(eng, launch_prompts,
                                                     TP_LAUNCH_NEW)
        state["launch_rank0"] = {n: fn.launches for n, fn in kernels.items()}
        state["launch_rank1"] = _worker_counts(g, kernels)[0]

    t0 = time.perf_counter()
    reqs, wall, info = serve(model, prompts, sharer, None, dev,
                             warmup=warmup, kernels=kernels,
                             before_wave=before, after_wave=after, tp=TP,
                             tp_backend=backend)
    pass_s = time.perf_counter() - t0
    # the eager tp=1 engine of the launch wave: its steps run the eager
    # decoder in place of the graphed one (the same device bodies)
    graphed = continuous.GraphedPagedDecoder
    continuous.GraphedPagedDecoder = PagedDecoder
    try:
        with continuous.ContinuousBatchingEngine(
                model, total_pages=1024, page_size=16, max_batch=8,
                min_table_pages=SERVE_TABLE_PAGES, device=dev) as eng:
            eager_decoder = type(eng._decoder).__name__
            for fn in kernels.values():
                fn.launches = 0
            _, eager_disp = _queued_wave(eng, launch_prompts, TP_LAUNCH_NEW)
            eager = {n: fn.launches for n, fn in kernels.items()}
    finally:
        continuous.GraphedPagedDecoder = graphed

    norms = 2 * layers + 1
    forwards = state["rank0"]["rms_norm"] / norms
    rec = dict(serve_stats(reqs, wall), backend=backend, tp=TP,
               card=card, decoder=state["decoder"], pass_s=pass_s,
               tp1_graphed=dict(ttft_p50_s=plain_rec["ttft_p50_s"],
                                tpot_p50_s=plain_rec["tpot_p50_s"],
                                decode_tok_s=plain_rec["decode_tok_s"]),
               peak_memory_gb=[None if b is None else b / 2 ** 30
                               for b in state["peak"]],
               reduces=list(state["reduces"]), forwards=forwards,
               reduces_per_forward=[r / max(forwards, 1)
                                    for r in state["reduces"]],
               launch_wave=dict(
                   new_tokens=TP_LAUNCH_NEW,
                   dispatches=state["launch_dispatches"],
                   dispatches_eager_tp1=eager_disp,
                   eager_tp1_decoder=eager_decoder,
                   rank0={n: state["launch_rank0"][n] for n in TP_KERNELS},
                   rank1={n: state["launch_rank1"][n] for n in TP_KERNELS},
                   eager_tp1={n: eager[n] for n in TP_KERNELS}),
               **{k: info[k] for k in ("captures", "dispatches", "steps",
                                       "decode_retries", "quarantined",
                                       "unified_fallbacks",
                                       "kv_pool_bytes")})
    agree, divergences = [], []
    for i, (r, p) in enumerate(zip(reqs, plain_reqs)):
        at = first_divergence(r.generated, p.generated)
        agree.append(at)
        if at is not None:
            divergences.append(dict(
                label=f"tp2_{backend}", request=i, position=at,
                ids=np.concatenate([p.prompt, np.asarray(p.generated[:at],
                                                         np.int32)]),
                tokens=(int(p.generated[at]), int(r.generated[at]))))
    rec.update(streams_equal_tp1=sum(a is None for a in agree),
               requests=len(agree), first_divergence=agree,
               sharer_prefix_tokens=reqs[-1].prefix_tokens)
    log(f"tp bf16 {backend}: " + json.dumps(rec))
    log("  launches rank 0: " + json.dumps(state["rank0"]))
    log("  launches rank 1: " + json.dumps(state["rank1"]))
    for i, r in enumerate(reqs):
        if r.error is not None or len(r.generated) != 32:
            raise AssertionError(f"tp bf16: request {i} did not complete "
                                 f"({r.error})")
    if state["decoder"] != "PagedDecoder" or info["captures"] \
            or any(info[k] for k in ("decode_retries", "quarantined",
                                     "unified_fallbacks")):
        raise AssertionError(f"tp bf16: the sharded steps must run eagerly "
                             f"and none may fail: {rec}")
    for n in TP_KERNELS:
        if state["rank0"][n] != state["rank1"][n]:
            raise AssertionError(f"tp bf16: {n} launched {state['rank0'][n]}"
                                 f" times on rank 0, {state['rank1'][n]} on"
                                 " rank 1")
    if list(state["reduces"]) != [2 * layers * forwards] * TP:
        raise AssertionError(f"tp bf16: {state['reduces']} block reductions "
                             f"in {forwards} forwards, expected "
                             f"{2 * layers} each on every rank")
    wave = rec["launch_wave"]
    if wave["dispatches"] != eager_disp or not (
            wave["rank0"] == wave["rank1"] == wave["eager_tp1"]):
        raise AssertionError(f"tp bf16 launch wave: each rank must launch "
                             f"what the eager tp=1 pass does: {wave}")
    if dev.type == "cuda" and not all(wave["eager_tp1"].values()):
        raise AssertionError(f"tp bf16 launch wave: a kernel never "
                             f"launched: {wave}")
    label = "tp2" if backend == TP_BACKEND else f"tp2_{backend}"
    launches = {label: state["rank0"], f"{label}_rank1": state["rank1"]}
    del reqs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec, launches, divergences


def tp_phase(model, prompts, sharer, warmup, kernels, plain, seed, card,
             dev):
    """The tp phase: (a) and (b) over gloo on the one card, and over NCCL
    (a rank a card) where two cards are visible.  Returns the record, the
    launches by pass, and the bf16 divergences by backend."""
    rec = {"card": card, "device_count": torch.cuda.device_count()}
    log(f"tp: tp={TP}, two processes on {card} over {TP_BACKEND} (asked "
        "for: NCCL needs a card a rank); the sharded steps run eagerly "
        "(PagedDecoder), tp=1 graphed beside them")
    rec["f32"] = {TP_BACKEND: tp_f32_check(seed, dev, TP_BACKEND)}
    log("tp f32: " + json.dumps(rec["f32"][TP_BACKEND]))
    backends = [TP_BACKEND]
    if torch.cuda.device_count() >= TP:
        backends.append("nccl")
        rec["f32"]["nccl"] = tp_f32_check(seed, dev, "nccl")
        log("tp f32 nccl: " + json.dumps(rec["f32"]["nccl"]))
    else:
        rec["nccl"] = (f"not run: torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}, NCCL puts a rank on "
                       f"each of {TP} cards")
        log("tp: NCCL " + rec["nccl"])
    rec["bf16"], launches, divergences = {}, {}, {}
    for backend in backends:
        rec["bf16"][backend], got, divergences[backend] = tp_serve_check(
            model, prompts, sharer, warmup, kernels, plain, seed, card, dev,
            backend)
        launches.update(got)
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


def check_small_recovery():
    """The small f32 model of ``check_small`` through the engine's crash
    recovery, on the card (the steps and the replays as CUDA graphs) and
    on the CPU from the same weights.  Four requests (24 new tokens, so a
    row the draft speeds up by 4 tokens a step is still mid-stream) are
    served to mid-decode (3 tokens each), then one fault is installed at
    a step boundary:

    - a transient ``buffer_loss`` (both pools zeroed), unified and
      legacy, replayed a row at a time (the card's default) and batched;
    - a sticky ``buffer_loss`` on one sequence, which fails exactly that
      request;
    - sampled rows (the device sampler);
    - the target as its own draft (spec tokens 3), ``nth=2`` passing the
      draft's proposal and landing on the verify;
    - ``kv_quant="int8"`` with ``quantize="w8"``;
    - a late sharer of a 32-token prefix admitted after the loss, which
      still hits;
    - an ``engine_wedge`` delay of 0.6 s under ``step_timeout_s=0.25``,
      in a wave after a fault-free one on the same engine, so that no
      first call's graph capture runs in the watched wave;
    - ``snapshot`` mid-stream, a JSON round trip, ``stop``, ``restore`` on
      a fresh engine.

    Each case's streams must equal a fault-free run on the card, which
    must equal the CPU's; each recovery is counted (one rebuild, no
    quarantine but the sticky row's), and each engine drains with both
    pools whole."""
    from paddle_tpu_torch.distributed.watchdog import CommTaskManager
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.testing import faults
    cpu, gpu = _small_models()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (9, 40, 130, 17)]
    system = rng.integers(0, 512, 32).astype(np.int32)
    sharers = [np.concatenate([system, rng.integers(0, 512, 7)])
               .astype(np.int32) for _ in range(4)]
    sampled = [dict(do_sample=True, temperature=0.8, seed=5 + i)
               for i in range(4)]
    new = 24
    mgr = CommTaskManager.instance()
    mgr._scan_interval = 0.05

    def engine(model, dev, **kw):
        return ContinuousBatchingEngine(model, total_pages=64, page_size=16,
                                        max_batch=4, device=dev, **kw)

    def at_boundary(eng, plan):
        with eng._cond:
            eng._snap_waiters += 1
            try:
                while eng._stepping:
                    eng._cond.wait(0.1)
                faults.install(faults.FaultPlan(plan))
            finally:
                eng._snap_waiters -= 1
                eng._cond.notify_all()

    def ripen(eng, ps, kws):
        faults.install(faults.FaultPlan(
            [{"site": "decode_step", "kind": "delay", "delay_s": 0.005}]))
        reqs = [eng.submit(p, max_new_tokens=new, **kw)
                for p, kw in zip(ps, kws)]
        end = time.monotonic() + 120
        while not all(len(r.generated) >= 3 for r in reqs):
            if time.monotonic() > end or any(r.done.is_set()
                                             for r in reqs):
                raise AssertionError("small recovery: the rows never "
                                     "reached mid-decode together")
            time.sleep(0.001)
        return reqs

    def outcome(reqs):
        out = []
        for r in reqs:
            try:
                out.append(r.result(timeout=300).tolist())
            except faults.FaultError:
                out.append(None)
        return out

    def close(eng, label):
        faults.clear()
        state = dict(rebuilds=eng.rebuilds, replays=eng.survivor_replays,
                     replay_dispatches=eng.replay_dispatches,
                     quarantined=eng.quarantined,
                     drained=eng.drain(timeout=60),
                     free=eng.cache.free_pages,
                     reserved=eng._reserved_pages, pad=eng._pad_pages,
                     draft_free=(eng.draft_cache.free_pages
                                 if eng.draft_cache is not None else 64),
                     captures=eng.captures, replays_graph=eng.replays)
        if not state["drained"] or state["free"] != 64 \
                or state["draft_free"] != 64 \
                or state["reserved"] != state["pad"]:
            raise AssertionError(f"small recovery {label}: the pools did "
                                 f"not come back whole: {state}")
        return state

    def clean(model, dev, ps, kws, **kw):
        with engine(model, dev, **kw) as eng:
            reqs = [eng.submit(p, max_new_tokens=new, **k)
                    for p, k in zip(ps, kws)]
            return [r.result(timeout=300).tolist() for r in reqs]

    def loss(model, dev, ps, kws, plan, **kw):
        with engine(model, dev, **kw) as eng:
            reqs = ripen(eng, ps, kws)
            at_boundary(eng, plan)
            outs = outcome(reqs)
            return outs, close(eng, "loss")

    greedy = [{}] * 4
    refs = {}
    for name, ps, kws, kw in (("greedy", prompts, greedy, {}),
                              ("sampled", prompts, sampled, {}),
                              ("int8", prompts, greedy,
                               dict(quantize="w8", kv_quant="int8")),
                              ("prefix", sharers[:1], greedy[:1], {})):
        card = clean(gpu, "cuda", ps, kws, **kw)
        host = clean(cpu, "cpu", ps, kws, **kw)
        if card != host:
            raise AssertionError(f"small recovery: the fault-free {name} "
                                 f"streams differ, card {card}, CPU {host}")
        refs[name] = card
    # (label, workload, fault plan, engine arguments, victims, quarantined)
    transient = [{"site": "buffer_loss", "nth": 1}]
    cases = [(f"transient {'unified' if u else 'legacy'} "
              f"{'batched' if b else 'per-row'}", "greedy", transient,
              dict(unified_step=u, replay_batch=b), set())
             for u in (True, False) for b in (False, True)]
    cases += [
        ("sticky seq 2", "greedy", [{"site": "buffer_loss", "seq_id": 2}],
         {}, {2}),
        ("sampled", "sampled", transient, {}, set()),
        ("draft on the verify", "greedy", [{"site": "buffer_loss",
                                            "nth": 2}],
         dict(draft_model=gpu, spec_tokens=3), set()),
        ("w8 int8 KV", "int8", transient,
         dict(quantize="w8", kv_quant="int8"), set())]
    for label, work, plan, kw, victims in cases:
        kws = sampled if work == "sampled" else greedy
        ref = refs[work]
        host_kw = dict(kw, draft_model=cpu) if "draft_model" in kw else kw
        got, st = loss(gpu, "cuda", prompts, kws, plan, **kw)
        host, hst = loss(cpu, "cpu", prompts, kws, plan, **host_kw)
        want = [None if i in victims else o for i, o in enumerate(ref)]
        # every row is still mid-stream at the fault: all are replayed
        replayed_all = bool(victims) or st["replays"] == len(prompts)
        if got != want or host != want or st["rebuilds"] < 1 \
                or st["quarantined"] != len(victims) or not replayed_all:
            raise AssertionError(
                f"small recovery {label}: card {got}, CPU {host}, want "
                f"{want}; card {st}, CPU {hst}")
        log(f"  small f32 model recovery {label}: streams card = CPU = "
            f"fault-free" + (f", requests {sorted(victims)} failed" if
                             victims else "")
            + f"; rebuilds {st['rebuilds']}, replays {st['replays']}, "
            f"replay dispatches {st['replay_dispatches']}, graphs "
            f"{st['captures']} captured / {st['replays_graph']} replays, "
            "pools whole")
    # a late sharer after the loss: the replay registered the prefix again
    for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
        with engine(model, dev) as eng:
            first = eng.submit(sharers[0], max_new_tokens=new)
            first.result(timeout=300)
            reqs = ripen(eng, sharers[1:3], greedy[:2])
            at_boundary(eng, transient)
            outs = outcome(reqs)
            faults.clear()
            late = eng.submit(sharers[3], max_new_tokens=new)
            outs.append(late.result(timeout=300).tolist())
            st = close(eng, "late sharer")
        want = [clean(model, dev, [p], greedy[:1])[0] for p in sharers[1:]]
        if outs != want or late.prefix_tokens != 32 or st["rebuilds"] != 1:
            raise AssertionError(f"small recovery late sharer on {dev}: "
                                 f"{outs} (want {want}), hit "
                                 f"{late.prefix_tokens}, {st}")
    log("  small f32 model recovery: a sharer admitted after the loss hit "
        "the 32-token prefix the replay registered again, card and CPU")
    # the watchdog: a wedged step is flagged, rebuilt, replayed, retried.
    # A bucket's first call captures its graph inside the watched window
    # and may itself outlast 0.25 s (then rightly flagged), so a
    # fault-free wave captures every bucket first; both waves run the
    # legacy composition, which an engine_wedge plan diverts to anyway
    wedge = [{"site": "engine_wedge", "kind": "delay", "delay_s": 0.6,
              "nth": 3}]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with engine(gpu, "cuda", step_timeout_s=0.25,
                    unified_step=False) as eng:
            warm = outcome([eng.submit(p, max_new_tokens=new)
                            for p in prompts])
            before = dict(rebuilds=eng.rebuilds, captures=eng.captures,
                          quarantined=eng.quarantined)
            timeouts = mgr.timeouts
            with faults.installed(faults.FaultPlan(wedge)):
                reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
                outs = outcome(reqs)
            st = close(eng, "wedge")
    mgr.stop()
    flagged = mgr.timeouts - timeouts
    rebuilds = st["rebuilds"] - before["rebuilds"]
    if warm != refs["greedy"] or outs != refs["greedy"] or rebuilds != 1 \
            or flagged < 1 or st["quarantined"] != before["quarantined"] \
            or "engine/decode_step" in mgr.heartbeat_names():
        raise AssertionError(f"small recovery wedge: warm-up {warm}, "
                             f"wedged {outs}, {st}, before the wedged "
                             f"wave {before}, timeouts {flagged}")
    log(f"  small f32 model recovery wedge (0.6 s under a 0.25 s "
        f"timeout, after a fault-free wave that captured "
        f"{before['captures']} graphs and rebuilt {before['rebuilds']} "
        f"times): {flagged} watchdog timeout(s), rebuilds {rebuilds}, "
        f"graphs {st['captures'] - before['captures']} captured in the "
        f"wedged wave, streams equal the fault-free ones")
    # snapshot and restore on a fresh engine
    kws = greedy[:2] + sampled[2:]
    want = refs["greedy"][:2] + refs["sampled"][2:]
    eng_a = engine(gpu, "cuda")
    ripen(eng_a, prompts, kws)
    snap = json.loads(json.dumps(eng_a.snapshot()))
    eng_a.stop()
    faults.clear()
    with engine(gpu, "cuda") as eng_b:
        restored = eng_b.restore(snap)
        outs = [r.result(timeout=300).tolist() for r in restored]
        close(eng_b, "restore")
    by_prompt = {tuple(p.tolist()): w for p, w in zip(prompts, want)}
    if len(restored) != 4 or outs != [by_prompt[tuple(r.prompt.tolist())]
                                      for r in restored]:
        raise AssertionError(f"small recovery snapshot/restore: {outs}")
    log(f"  small f32 model snapshot/restore: {len(snap['requests'])} "
        f"entries ({sum(len(e['generated']) for e in snap['requests'])} "
        "generated tokens) restored on a fresh engine, streams equal the "
        "fault-free ones")


def check_small_overload():
    """The small f32 model of ``check_small`` through the overload
    controls, on the card and on the CPU from the same weights:

    - the TPOT trigger: a ``batch`` request decoding in an engine of two
      slots, then an ``interactive`` one (TPOT budget 1e-4 s, far under
      the paced 0.02 s step) takes the free slot, so only the trigger can
      pause the batch row; its stream equals the CPU's and the card's
      run without the budget (no pause), unified and legacy, and
      ``decode_preemptions_total`` moves on both sides and not without
      the budget;
    - a scripted shed: a batch class with a 1e-9 s deadline, one slot
      held, then arrivals of batch, batch, standard, interactive, batch:
      admitted, shed, admitted, admitted, shed (Retry-After within
      [1, 30]), on the card as on the CPU;
    - a scripted ladder: thresholds (0.25, 0.5, 0.75, 0.95) over
      ``max_queue=8``, a burst of 5 interactive requests into one slot,
      at rung 2 arrivals of batch, standard and interactive: the rungs
      the ladder passes through and the decisions equal the CPU's, and
      the engine ends at rung 0.

    The paged, RMSNorm and RoPE kernels must have launched on the card
    over the check."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.inference.continuous import (
        ContinuousBatchingEngine, EngineSaturated)
    from paddle_tpu_torch.inference.scheduler import PriorityClass
    from paddle_tpu_torch.testing import faults
    cpu, gpu = _small_models()
    rng = np.random.default_rng(12)
    long_p = rng.integers(0, 512, 130).astype(np.int32)
    short_p = rng.integers(0, 512, 9).astype(np.int32)
    kernels = counters()
    _zero(kernels)
    preemptions = monitor.get_registry().get("decode_preemptions_total")

    def classes(tpot=None, deadline=None):
        return (PriorityClass("interactive", rank=0, weight=8,
                              tpot_budget_s=tpot),
                PriorityClass("standard", rank=1, weight=4),
                PriorityClass("batch", rank=2, weight=1, preemptible=True,
                              deadline_s=deadline))

    def engine(model, dev, **kw):
        return ContinuousBatchingEngine(model, total_pages=64, page_size=16,
                                        device=dev, **kw)

    def pace(delay):
        return faults.installed(faults.FaultPlan(
            [{"site": "decode_step", "kind": "delay", "delay_s": delay}]))

    def wait_for(cond, what, timeout=60.0):
        end = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > end:
                raise AssertionError(f"small overload: timed out waiting "
                                     f"for {what}")
            time.sleep(0.001)

    def tpot_run(model, dev, unified, budget):
        before = preemptions.value()
        with pace(0.02), engine(model, dev, max_batch=2,
                                scheduler_classes=classes(tpot=budget),
                                default_class="standard",
                                tpot_preempt_cooldown_s=0.0,
                                unified_step=unified) as eng:
            rb = eng.submit(long_p, max_new_tokens=24, priority="batch")
            wait_for(lambda: len(rb.generated) >= 2, "the batch row")
            ri = eng.submit(short_p, max_new_tokens=8,
                            priority="interactive")
            ri.result(timeout=120)
            return rb.result(timeout=120).tolist(), \
                preemptions.value() - before

    for unified in (True, False):
        label = "unified" if unified else "legacy"
        card, n_card = tpot_run(gpu, "cuda", unified, 1e-4)
        host, n_host = tpot_run(cpu, "cpu", unified, 1e-4)
        alone, n_alone = tpot_run(gpu, "cuda", unified, None)
        if not card == host == alone or not n_card or not n_host \
                or n_alone:
            raise AssertionError(
                f"small overload tpot {label}: card {card}, CPU {host}, "
                f"card without the budget {alone}; decode preemptions "
                f"{n_card} / {n_host} / {n_alone}")
        log(f"  small f32 model overload tpot {label}: the parked batch "
            f"row's stream equal card vs CPU vs card unparked; decode "
            f"preemptions card {n_card:.0f}, CPU {n_host:.0f}, unparked 0")

    def submit_all(eng, order, prompt, new):
        decisions, reqs = [], []
        for cls in order:
            try:
                reqs.append(eng.submit(prompt, max_new_tokens=new,
                                       priority=cls))
                decisions.append((cls, "admitted"))
            except EngineSaturated as e:
                if e.priority_class != cls \
                        or not 1 <= e.retry_after_s <= 30:
                    raise AssertionError(f"small overload: shed {cls} "
                                         f"as {e.priority_class}, "
                                         f"Retry-After {e.retry_after_s}")
                decisions.append((cls, "shed"))
        return decisions, reqs

    def shed_script(model, dev):
        with pace(0.02), engine(model, dev, max_batch=1,
                                scheduler_classes=classes(deadline=1e-9),
                                default_class="standard") as eng:
            eng.submit(short_p, max_new_tokens=3).result(timeout=120)
            r1 = eng.submit(long_p, max_new_tokens=12, priority="batch")
            wait_for(lambda: len(r1.generated) >= 1, "the slot held")
            decisions, reqs = submit_all(
                eng, ("batch", "batch", "standard", "interactive", "batch"),
                short_p, 2)
            for r in reqs + [r1]:
                r.result(timeout=120)
            return decisions

    card, host = shed_script(gpu, "cuda"), shed_script(cpu, "cpu")
    want = [("batch", "admitted"), ("batch", "shed"),
            ("standard", "admitted"), ("interactive", "admitted"),
            ("batch", "shed")]
    if not card == host == want:
        raise AssertionError(f"small overload shed: card {card}, CPU "
                             f"{host}, want {want}")
    log(f"  small f32 model overload shed: decisions card = CPU = {want}")

    def ladder_script(model, dev):
        with pace(0.03), engine(model, dev, max_batch=1, max_queue=8,
                                brownout_thresholds=(0.25, 0.5, 0.75, 0.95),
                                brownout_patience=2) as eng:
            rungs = []
            set_rung = eng._set_brownout_locked

            def record(level, pressure):
                if level != eng._brownout:
                    rungs.append(level)
                set_rung(level, pressure)

            eng._set_brownout_locked = record
            with eng._cond:
                reqs = [eng.submit(short_p, max_new_tokens=4,
                                   priority="interactive")
                        for _ in range(5)]
            wait_for(lambda: eng.scheduler_info()["brownout_level"] == 2,
                     "rung 2")
            decisions, more = submit_all(
                eng, ("batch", "standard", "interactive"), short_p, 4)
            for r in reqs + more:
                r.result(timeout=120)
            wait_for(lambda: eng.scheduler_info()["brownout_level"] == 0,
                     "rung 0")
            return rungs, decisions

    card, host = ladder_script(gpu, "cuda"), ladder_script(cpu, "cpu")
    if card != host or max(card[0]) != 2 or card[0][-1] != 0 \
            or card[1] != [("batch", "shed"), ("standard", "shed"),
                           ("interactive", "admitted")]:
        raise AssertionError(f"small overload ladder: card {card}, CPU "
                             f"{host}")
    log(f"  small f32 model overload ladder: rungs {card[0]}, decisions at "
        f"rung 2 {card[1]}, card = CPU")
    if faults.active() is not None:
        raise AssertionError("a fault plan outlived its check")
    got = {n: kernels[n].launches for n in ("paged_attention", "rms_norm",
                                            "apply_rope")}
    if not all(got.values()):
        raise AssertionError(f"small overload: kernels not launched on "
                             f"the card: {got}")
    log(f"  small f32 model overload: launches on the card {got}")


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
    if "topk_gating" in name:
        return "moe_gating"
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

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
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
        "peak_over_start_gb": (peak - base) / 1e9,
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
        "losses_first_5": [float(x) for x in vals[:5]],
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


class HiddenLM(torch.nn.Module):
    """``bench.py``'s ``_HiddenLM``: the decoder's hidden states, for a
    loss that computes the LM head itself (the fused route)."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, input_ids):
        return self.lm.model(input_ids)


def moe_model_flops(cfg, batch, seq):
    """``model_flops`` of an MoE LLaMA: each token through its top-k
    experts' SwiGLU (3 products of hidden x intermediate); the expert
    buffers' padding to the capacity is not counted."""
    d = cfg.hidden_size // cfg.num_attention_heads
    kv = cfg.num_key_value_heads * d
    per_layer = cfg.hidden_size * (2 * cfg.hidden_size + 2 * kv) \
        + cfg.moe_top_k * 3 * cfg.hidden_size * cfg.intermediate_size
    linear = cfg.num_hidden_layers * per_layer \
        + cfg.hidden_size * cfg.vocab_size
    attn_fwd = 4 * batch * cfg.num_attention_heads * d \
        * causal_pairs(seq, seq, True) * cfg.num_hidden_layers
    return 3 * (2 * linear * batch * seq + attn_fwd)


def graphed_path(label, make, ids, labels, kernels, flops, steps=20,
                 warmup=3, n_prof=2, seen=None, refuse=(), tokens=None):
    """One ``train_paths`` sub-case: the graphed ``TrainStep`` that
    ``make(TrainStep)`` builds takes ``warmup`` steps (the first runs
    eagerly and captures), then ``steps`` timed ones with the launch
    counters zeroed just before, then ``n_prof`` in a profiler window
    (one that sees every kernel named in ``seen`` and none in
    ``refuse``, where given).  Then the graphed trainer and its graph
    pool are freed and ``make(EagerTrainStep)`` (the same seeded weights)
    takes 5 steps on the same batch.  The timed steps must capture
    nothing and replay every step; the losses must be finite and fall;
    the first 5 graphed losses must equal the eager ones bit for bit;
    a replay's launches a step must equal an eager step's.  ``tokens``:
    the tokens a step counts for tokens/s (``ids.numel()`` by default;
    ``ids`` may be a tuple of inputs).  Returns the record, the timed
    steps' launches and the graphed losses."""
    from paddle_tpu_torch.jit import EagerTrainStep, TrainStep
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step = make(TrainStep)
    losses = [step(ids, labels) for _ in range(warmup)]
    torch.cuda.synchronize()
    captures_warmup = step.captures
    for fn in kernels.values():
        fn.launches = 0
    captured, replayed = step.captures, step.replays
    times = _host_ms(lambda: losses.append(step(ids, labels)), steps)
    launches = {n: fn.launches for n, fn in kernels.items()}
    captures, replays = step.captures - captured, step.replays - replayed
    peak = torch.cuda.max_memory_allocated()

    if seen:
        events = window_seeing(
            lambda: losses.extend(step(ids, labels) for _ in range(n_prof)),
            label, seen, refuse).key_averages()
    else:
        _ms, events, _busy = _window(
            lambda: losses.append(step(ids, labels)), n_prof)
    busy_ms = sum(_device_us(e) for e in events) / 1e3 / n_prof
    by_class = {}
    for e in events:
        cls = _kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + _device_us(e) / 1e3 / n_prof
    vals = torch.stack(losses).float().cpu().numpy()
    del step, losses
    gc.collect()
    torch.cuda.empty_cache()
    eager = make(EagerTrainStep)
    for fn in kernels.values():
        fn.launches = 0
    eager_vals = torch.stack([eager(ids, labels) for _ in range(5)]) \
        .float().cpu().numpy()
    eager_launches = {n: fn.launches / 5 for n, fn in kernels.items()}
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    rec = {"step_ms_p25": q1, "step_ms_p50": med, "step_ms_p75": q3,
           "tokens_per_s": (tokens or ids.numel()) / (med / 1e3),
           "model_flops_per_step": flops,
           "mfu": flops / (med / 1e3) / BF16_FLOP_S,
           "peak_memory_gb": peak / 1e9,
           "peak_over_start_gb": (peak - base) / 1e9,
           "captures_warmup": captures_warmup, "captures": captures,
           "replays": replays,
           "launches_per_step": {n: c / steps for n, c in launches.items()
                                 if c},
           "device_busy_ms_per_step": busy_ms or "not measured",
           "device_idle_share": (1 - busy_ms / med) if busy_ms
           else "not measured",
           "device_ms_per_step_by_class": by_class,
           "losses": [float(x) for x in vals],
           "eager_losses": [float(x) for x in eager_vals],
           "first_5_losses_equal_eager": bool(
               np.array_equal(vals[:5], eager_vals))}
    log(f"  {label}: " + json.dumps(rec))
    if not np.isfinite(vals).all():
        raise AssertionError(f"{label}: non-finite loss {vals.tolist()}")
    if not vals[-1] < vals[0]:
        raise AssertionError(f"{label}: the last loss {vals[-1]} is not "
                             f"below the first {vals[0]}")
    if captures or replays != steps:
        raise AssertionError(f"{label}: the timed steps captured "
                             f"{captures} graphs and replayed {replays}")
    if not rec["first_5_losses_equal_eager"]:
        raise AssertionError(f"{label}: the graphed step's first 5 losses "
                             f"{vals[:5].tolist()} differ from the eager "
                             f"step's {eager_vals.tolist()}")
    apart = {n: (launches[n] / steps, eager_launches[n]) for n in kernels
             if launches[n] / steps != eager_launches[n]}
    if apart:
        raise AssertionError(f"{label}: launches a step, replayed vs eager, "
                             f"differ: {apart}")
    return rec, launches, vals


def head_products(dev, hidden, vocab, rows, chunk=1024):
    """Device ms a step of the fused loss's four head products over
    ``rows`` rows in chunks of ``chunk``: the forward's logits (bf16
    operands, ``torch.mm(..., out_dtype=torch.float32)``), the backward's
    recomputed logits (the same product), dh = delta @ W and dW +=
    delta^T @ h (f32 operands, TF32 off), each timed on one chunk and
    multiplied by the chunks; with each one's bound (bf16 or f32 peak)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    h = torch.randn(chunk, hidden, generator=gen, device=dev).bfloat16()
    w = (0.02 * torch.randn(vocab, hidden, generator=gen,
                            device=dev)).bfloat16()
    delta = torch.randn(chunk, vocab, generator=gen, device=dev) / vocab
    w32, h32 = w.float(), h.float()
    dw = torch.zeros(vocab, hidden, device=dev)
    n = -(-rows // chunk)
    ops = 2 * chunk * hidden * vocab
    out = {}
    for name, fn, peak in (
            ("logits_forward", lambda: torch.mm(
                h, w.t(), out_dtype=torch.float32), BF16_FLOP_S),
            ("logits_backward", lambda: torch.mm(
                h, w.t(), out_dtype=torch.float32), BF16_FLOP_S),
            ("dh", lambda: delta @ w32, F32_FLOP_S),
            ("dw", lambda: dw.addmm_(delta.t(), h32), F32_FLOP_S)):
        ms = cuda_ms(fn)
        el = 2 if peak == BF16_FLOP_S else 4
        bms, by = bound_ms((chunk * hidden + vocab * hidden) * el
                           + chunk * vocab * 4, ops, peak)
        out[name] = {"ms_per_step": ms * n, "bound_ms_per_step": bms * n,
                     "bound_by": by}
    return out


def train_paths(seed, dev, card, train_rec):
    """The rest of LLaMA training on the card, each sub-case a graphed
    ``TrainStep`` held against its eager twin (``graphed_path``):
    (a) ``fused_ce``: llama_small in bf16 + AdamW(multi_precision) whose
    loss is ``fused_linear_cross_entropy`` over ``HiddenLM`` (bench.py's
    fused route, chunk 1024), its first loss within 1e-2 relative of the
    ``train`` phase's (the unfused route, same weights and batch), and
    the head products timed apart; (b) ``amp_o1``: llama_small with f32
    parameters, ``TrainStep(amp_level="O1")``: the bf16 wgmma flash
    kernels in a profiler window, RMSNorm launched in f32; (c)
    ``amp_o2``: an f32 llama_small holding the ``train`` trainer's bf16
    weights upcast, ``amp.decorate(level="O2")``: its weights equal that
    trainer's and its first 5 losses too, bit for bit; (d) ``moe``:
    Mixtral-8x7B's widths cut to ``MOE_TRAIN_LAYERS`` layers, bf16 with
    f32 naive gates (the routing takes the gating kernel) and
    AdamW(multi_precision), batch ``MOE_TRAIN_B`` x ``MOE_TRAIN_S``: the
    gating kernel twice a step, the flash kernels once a layer.  Returns
    the phase's record and each sub-case's launches."""
    import dataclasses
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_linear_cross_entropy
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_small
    from paddle_tpu_torch.models.llama_moe import (LlamaMoeForCausalLM,
                                                   mixtral_8x7b)
    from paddle_tpu_torch.ops import fused_norm_rope as nr
    from paddle_tpu_torch.optimizer import AdamW
    cfg = llama_small()
    bf16 = torch.bfloat16
    kernels = counters()
    rng = np.random.default_rng(seed)
    ids_np = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    ids = torch.as_tensor(ids_np[:, :-1], device=dev)
    labels = torch.as_tensor(ids_np[:, 1:], device=dev)
    flops = model_flops(cfg, TRAIN_B, TRAIN_S)
    seen = ("flash_fwd_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
            "flash_bwd_dq_wgmma_kernel")
    refuse = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
              "flash_bwd_dq_kernel")
    rec, launches = {"card": card}, {}

    def fused(cls):
        model = LlamaForCausalLM(cfg, device=dev, dtype=bf16, seed=seed)
        head = model.lm_head.weight

        def loss_fn(hidden, lab):
            return fused_linear_cross_entropy(
                hidden.reshape(-1, cfg.hidden_size), head, lab.reshape(-1),
                chunk_rows=1024)
        return cls(HiddenLM(model), loss_fn, AdamW(
            learning_rate=1e-3, parameters=model.parameters(),
            multi_precision=True))

    log(f"train_paths (a) fused_ce: llama_small bf16 + AdamW("
        f"multi_precision), batch {TRAIN_B} x {TRAIN_S}, "
        "fused_linear_cross_entropy (chunk 1024) on HiddenLM")
    a, launches["fused_ce"], vals = graphed_path(
        "fused_ce", fused, ids, labels, kernels, flops, seen=seen,
        refuse=refuse)
    a["loss_first_unfused"] = train_rec["loss_first"]
    a["loss_first_rel_unfused"] = abs(float(vals[0]) - a[
        "loss_first_unfused"]) / abs(a["loss_first_unfused"])
    a["peak_over_start_gb_unfused"] = train_rec["peak_over_start_gb"]
    a["step_ms_p50_unfused"] = train_rec["step_ms_p50"]
    a["head_products"] = head_products(dev, cfg.hidden_size,
                                       cfg.vocab_size, TRAIN_B * TRAIN_S)
    log("  fused_ce head products: " + json.dumps(a["head_products"]))
    if a["loss_first_rel_unfused"] > 1e-2:
        raise AssertionError(
            f"fused_ce: first loss {float(vals[0])} is "
            f"{a['loss_first_rel_unfused']:.3e} from the unfused route's "
            f"{a['loss_first_unfused']} (limit 1e-2 relative)")
    missing = [n for n in TRAIN_KERNELS if not launches["fused_ce"][n]]
    if missing:
        raise AssertionError(f"fused_ce: kernels never launched: {missing}")
    rec["fused_ce"] = a

    def o1(cls):
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32,
                                 seed=seed)
        return cls(model, _lm_loss, AdamW(
            learning_rate=1e-3, parameters=model.parameters()),
            amp_level="O1", amp_dtype="bfloat16")

    log("train_paths (b) amp_o1: llama_small f32 parameters, "
        "TrainStep(amp_level='O1', amp_dtype='bfloat16') + AdamW")
    norm_types = set()
    real_rms = nr._rms_forward

    def rms_spy(x, weight, epsilon):
        norm_types.add(str(x.dtype))
        return real_rms(x, weight, epsilon)

    nr._rms_forward = rms_spy
    try:
        b, launches["amp_o1"], _vals = graphed_path(
            "amp_o1", o1, ids, labels, kernels, flops, seen=seen,
            refuse=refuse)
    finally:
        nr._rms_forward = real_rms
    b["rms_norm_input_types"] = sorted(norm_types)
    if norm_types != {"torch.float32"} or not launches["amp_o1"]["rms_norm"]:
        raise AssertionError(f"amp_o1: RMSNorm ran on {norm_types}, "
                             f"{launches['amp_o1']['rms_norm']} launches; "
                             "O1 runs it in f32")
    rec["amp_o1"] = b

    log("train_paths (c) amp_o2: amp.decorate(level='O2') of an f32 "
        "llama_small holding the train trainer's bf16 weights")
    gc.collect()
    torch.cuda.empty_cache()
    low = LlamaForCausalLM(cfg, device=dev, dtype=bf16, seed=seed)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.float32, seed=None)
    model.load_state_dict({k: v.float() for k, v in
                           low.state_dict().items()})
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    same = all(x.dtype == bf16 and torch.equal(x, y) for x, y in
               zip(model.parameters(), low.parameters()))
    del low
    step = TrainStep(model, _lm_loss, opt)
    o2 = [float(step(ids, labels)) for _ in range(5)]
    c = {"weights_equal_bf16_trainer": same, "losses": o2,
         "train_losses_first_5": train_rec["losses_first_5"],
         "losses_equal_train": o2 == train_rec["losses_first_5"],
         "captures": step.captures, "replays": step.replays}
    log("  amp_o2: " + json.dumps(c))
    del step, model, opt
    if not (same and c["losses_equal_train"]):
        raise AssertionError(f"amp_o2: decorated weights equal the bf16 "
                             f"trainer's: {same}; losses {o2} against the "
                             f"train phase's {train_rec['losses_first_5']}")
    rec["amp_o2"] = c

    mcfg = dataclasses.replace(mixtral_8x7b(MOE_TRAIN_LAYERS),
                               gate_type="naive")
    mrng = np.random.default_rng(seed + 1)
    m_np = mrng.integers(0, mcfg.vocab_size, (MOE_TRAIN_B, MOE_TRAIN_S + 1))
    m_ids = torch.as_tensor(m_np[:, :-1], device=dev)
    m_labels = torch.as_tensor(m_np[:, 1:], device=dev)

    def moe_loss(outputs, lab):
        logits, aux = outputs
        return _lm_loss(logits, lab) + aux

    def moe(cls):
        model = LlamaMoeForCausalLM(mcfg, device=dev, dtype=bf16, seed=seed,
                                    gate_dtype=torch.float32)
        return cls(model, moe_loss, AdamW(
            learning_rate=1e-3, parameters=model.parameters(),
            multi_precision=True))

    n_params = sum(p.numel() for p in LlamaMoeForCausalLM(
        mcfg, device="meta", seed=None).parameters())
    log(f"train_paths (d) moe: Mixtral-8x7B widths, {MOE_TRAIN_LAYERS} "
        f"layer(s), {n_params / 1e9:.3f} B params, bf16 + f32 naive gates + "
        f"AdamW(multi_precision), batch {MOE_TRAIN_B} x {MOE_TRAIN_S}")
    gc.collect()
    torch.cuda.empty_cache()
    d, launches["moe_train"], _vals = graphed_path(
        "moe", moe, m_ids, m_labels, kernels,
        moe_model_flops(mcfg, MOE_TRAIN_B, MOE_TRAIN_S), steps=10)
    d["params_b"] = n_params / 1e9
    d["layers"] = MOE_TRAIN_LAYERS
    per_step = d["launches_per_step"]
    want = {"topk_gating": MOE_TRAIN_LAYERS,
            "flash_attention_forward": MOE_TRAIN_LAYERS,
            "flash_attention_bwd_dkv": MOE_TRAIN_LAYERS,
            "flash_attention_bwd_dq": MOE_TRAIN_LAYERS,
            "rms_norm": 2 * MOE_TRAIN_LAYERS + 1,
            "apply_rope": 2 * MOE_TRAIN_LAYERS}
    apart = {n: (per_step.get(n, 0), k) for n, k in want.items()
             if per_step.get(n, 0) != k}
    if apart:
        raise AssertionError(f"moe: launches a step (got, want): {apart}")
    rec["moe"] = d
    return rec, launches


def bert_flops(cfg, batch, seq):
    """Model FLOPs of one BERT classification training step, from the
    shapes: forward plus a backward of twice the forward, for the
    encoder's Linears (2 per weight per token each way), the pooler and
    classifier on the first token, and the attention products (QK^T and
    PV over every pair: no mask)."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    d = h // cfg.num_attention_heads
    tokens = batch * seq
    linear = cfg.num_hidden_layers * (4 * h * h + 2 * h * f) * tokens \
        + (h * h + h * cfg.num_labels) * batch
    attn = 4 * batch * cfg.num_attention_heads * d * seq * seq \
        * cfg.num_hidden_layers
    return 3 * (2 * linear + attn)


def time_bert_shapes(records, dev):
    """The flash forward, dK/dV and dQ kernels at BERT-base's attention
    shape (batch ``FIT_B`` x ``FIT_S``, 12 heads of d64, no mask), bf16
    (the O1 step) and f32 (the eager fit): each held against its plain
    version, then timed beside the plain version and
    ``scaled_dot_product_attention`` (its backward from a profiler
    window).  Adds each kernel's ``bert_bf16`` and ``bert_f32``
    records."""
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(11)
    b, h, s, d = FIT_B, 12, FIT_S, 64
    for dtype, tag in ((torch.bfloat16, "bert_bf16"),
                       (torch.float32, "bert_f32")):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)
        q, k, v, do = (rnd(b, h, s, d) for _ in range(4))
        label = f"BERT b{b} h{h} s{s} d{d} full {tag[5:]}"
        bf = dtype == torch.bfloat16
        peak = BF16_FLOP_S if bf else F32_FLOP_S
        el = q.element_size()
        out, lse = fa.flash_attention_cuda(q, k, v, causal=False)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=False)
        torch.cuda.synchronize()
        err = check("flash_attention_forward", label, out, ref,
                    2e-2 if bf else 1e-4)
        check("flash_attention_forward", label + " lse", lse, ref_lse, 1e-4)
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=False))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, False),
                           reps=3)
        lib_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(q, k, v))
        pairs = b * h * s * s
        bms, by = bound_ms(4 * q.numel() * el + b * h * s * 4,
                           4 * pairs * d, peak)
        log(f"  flash_attention_forward {label}: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by})")
        records.setdefault("flash_attention_forward", {})[tag] = dict(
            case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=lib_ms)
        scale = d ** -0.5
        got = fa.flash_attention_backward_cuda(q, k, v, out, lse, do, False,
                                               scale)
        want = fa._bwd_blockwise(q, k, v, out, lse, do, False, scale)
        torch.cuda.synchronize()
        errs = {n: check("flash_attention_bwd", f"{label} {n}", g, r,
                         1e-2 if bf else 1e-4)
                for n, g, r in zip(("dq", "dk", "dv"), got, want)}
        delta = (out.float() * do.float()).sum(-1).contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        args = (q, k, v, do, lse, delta, dq, dk, dv, False, scale)
        dkv_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(*args))
        dq_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(*args))
        plain_ms = cuda_ms(lambda: fa._bwd_blockwise(
            q, k, v, out, lse, do, False, scale), reps=3)
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lout = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv)
        lib_ms = profiled_ms(lambda: torch.autograd.grad(
            lout, (lq, lk, lv), do, retain_graph=True))
        rows = b * h * s * 4 * 2                     # lse and delta, f32
        for name, ms, n_ops, n_bytes, e in (
                ("flash_attention_bwd_dkv", dkv_ms, 4 * 2 * pairs * d,
                 (2 * q.numel() + 4 * k.numel()) * el + rows,
                 max(errs["dk"], errs["dv"])),
                ("flash_attention_bwd_dq", dq_ms, 3 * 2 * pairs * d,
                 (3 * q.numel() + 2 * k.numel()) * el + rows, errs["dq"])):
            bms, by = bound_ms(n_bytes, n_ops, peak)
            log(f"  {name} {label}: {ms:.4f} ms, plain (dq+dk+dv) "
                f"{plain_ms:.4f} ms, sdpa backward (dq+dk+dv, profiler) "
                f"{lib_ms} ms, bound {bms:.4f} ms ({by})")
            records.setdefault(name, {})[tag] = dict(
                case=label, max_abs_err=e, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)


class SeqPairs:
    """Seeded token sequences as (input ids, next-token labels), int64:
    the loader case's dataset."""

    def __init__(self, n, seq, vocab, seed):
        self.ids = np.random.default_rng(seed).integers(0, vocab,
                                                        (n, seq + 1))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i, :-1], self.ids[i, 1:]


class SyntheticSST2:
    """The JAX example's SST-2-shaped pairs (``examples/finetune_bert.py``):
    token ids (n, seq) and the label "token 7 appears", int64."""

    def __init__(self, n, seq, vocab, seed):
        rng = np.random.default_rng(seed)
        self.x = rng.integers(0, vocab, (n, seq))
        self.y = (self.x == 7).any(axis=1).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def hist_p50(hist, before):
    """The upper bound of the bucket holding the median of the
    observations ``hist`` gained since its ``cumulative_counts()`` were
    ``before``, and their count."""
    now = hist.cumulative_counts()
    got = [a - b for a, b in zip(now, before)]
    n = got[-1]
    for bound, c in zip(list(hist.buckets) + [float("inf")], got):
        if n and c >= n / 2:
            return bound, n
    return None, n


def fit_loader(seed, dev):
    """(a) ``loader``: the llama_small graphed ``TrainStep`` (bf16 +
    AdamW(multi_precision), batch ``TRAIN_B`` x ``TRAIN_S``) fed by
    ``DataLoader(device_prefetch=True)`` over seeded token sequences:
    ``LOADER_SINGLE`` single calls, then ``run_steps`` of ``LOADER_K``
    twice.  Each staged batch must equal ``.to(dev)`` of the host batch,
    and the losses must equal a second trainer's, same weights, fed the
    host tensors of the same batches.  Step ms p50 (host clock, each
    step ended by a synchronize, after ``LOADER_WARMUP`` calls) for both,
    and the p50 of ``input_wait_seconds`` over each run's batches."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_small
    from paddle_tpu_torch.optimizer import AdamW
    cfg = llama_small()
    n = TRAIN_B * (LOADER_SINGLE + 2 * LOADER_K)
    ds = SeqPairs(n, TRAIN_S, cfg.vocab_size, seed)
    host = list(DataLoader(ds, batch_size=TRAIN_B))
    staged = list(DataLoader(ds, batch_size=TRAIN_B, device_prefetch=True,
                             device=dev))
    batches_equal = len(staged) == len(host) and all(
        sx.device == dev and torch.equal(sx, hx.to(dev))
        and torch.equal(sy, hy.to(dev))
        for (sx, sy), (hx, hy) in zip(staged, host))
    del staged
    wait_h = monitor.get_registry().get("input_wait_seconds")

    def run(prefetch):
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=seed)
        step = TrainStep(model, _lm_loss, AdamW(
            learning_rate=1e-3, parameters=model.parameters(),
            multi_precision=True))
        before = wait_h.cumulative_counts()
        it = iter(DataLoader(ds, batch_size=TRAIN_B, device_prefetch=prefetch,
                             device=dev if prefetch else None))
        losses, times = [], []
        for i in range(LOADER_SINGLE):
            t0 = time.perf_counter()
            x, y = next(it)
            losses.append(step(x, y))
            torch.cuda.synchronize()
            if i >= LOADER_WARMUP:
                times.append((time.perf_counter() - t0) * 1e3)
        for _ in range(2):
            losses.extend(step.run_steps(
                [next(it) for _ in range(LOADER_K)]).unbind())
        torch.cuda.synchronize()
        it.close()
        p50, count = hist_p50(wait_h, before)
        out = {"losses": torch.stack(losses).float().cpu(),
               "step_ms_p50": float(np.percentile(times, 50)),
               "input_wait_s_p50_bucket": p50, "input_waits": count,
               "captures": step.captures, "replays": step.replays}
        del step, model
        gc.collect()
        torch.cuda.empty_cache()
        return out

    fed = run(True)
    plain = run(False)
    equal = torch.equal(fed["losses"], plain["losses"])
    rec = {"batch": TRAIN_B, "seq": TRAIN_S, "single_calls": LOADER_SINGLE,
           "run_steps_k": LOADER_K,
           "staged_batches_equal_to_device": batches_equal,
           "losses_equal_host_fed": equal,
           "losses": [float(v) for v in fed["losses"]],
           "step_ms_p50_prefetch": fed["step_ms_p50"],
           "step_ms_p50_host": plain["step_ms_p50"],
           "input_wait_s_p50_bucket_prefetch":
               fed["input_wait_s_p50_bucket"],
           "input_wait_s_p50_bucket_host": plain["input_wait_s_p50_bucket"],
           "input_waits": fed["input_waits"],
           "captures": fed["captures"], "replays": fed["replays"]}
    log("  loader: " + json.dumps(rec))
    if not batches_equal:
        raise AssertionError("fit loader: a staged batch differs from "
                             ".to(device) of its host batch")
    if not equal or not torch.isfinite(fed["losses"]).all():
        raise AssertionError(f"fit loader: losses fed by the device stage "
                             f"{fed['losses'].tolist()} differ from the "
                             f"host-fed ones {plain['losses'].tolist()}")
    return rec


class _SyncProbe:
    """Collects the synchronizing CUDA calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports, each with the
    innermost frame of this repository on its stack (its call site)."""

    def __init__(self, root):
        self.root = root
        self.sites = []

    def showwarning(self, message, category, filename, lineno, file=None,
                    line=None):
        import traceback
        if "called a synchronizing CUDA operation" not in str(message):
            return
        site = f"{filename}:{lineno}"
        for fr in reversed(traceback.extract_stack()[:-1]):
            if fr.filename.startswith(self.root) and \
                    os.path.basename(fr.filename) != "chip_smoke.py":
                site = f"{os.path.relpath(fr.filename, self.root)}:" \
                    f"{fr.lineno}"
                break
        self.sites.append(site)


def _fit_callback(n_steps, probe, stamps):
    """A fit callback that turns sync-debug warnings on at the first
    step's start and off at the last step's end (the epoch's loss read
    comes after), stamping each step's end on the host clock."""
    from paddle_tpu_torch.hapi.callbacks import Callback

    class SyncWindow(Callback):
        def on_train_batch_begin(self, step, logs=None):
            if step == 0:
                torch.cuda.set_sync_debug_mode("warn")

        def on_train_batch_end(self, step, logs=None):
            stamps.append(time.perf_counter())
            if step == n_steps - 1:
                torch.cuda.set_sync_debug_mode("default")

    return SyncWindow()


def fit_bert(seed, dev, kernels):
    """(b) ``bert_fit``: the JAX example's path at BERT-base width (12
    layers, 768, vocab 30522, dropout 0.1), f32, batch ``FIT_B`` x
    ``FIT_S``: ``Model(BertForSequenceClassification).prepare(AdamW(2e-5),
    CrossEntropyLoss(), Accuracy()).fit`` over ``FIT_STEPS`` batches of a
    shuffled SyntheticSST2 (one numpy seed), then ``evaluate``.  The
    steps run under sync-debug warnings: none may come from ``hapi``,
    ``io`` or the optimizer; the others are printed by call site.  The
    first 5 losses must equal an explicit eager loop's (forward,
    ``backward``, ``step``, ``clear_grad``) over the same batches and
    seeded weights bit for bit.  Step ms p50 (host clock between step
    ends after the first 5: the loop runs ahead of the card until its
    queue fills, then at the card's pace), tokens/s, the device's idle
    share over 3 ``train_batch`` calls and a profiler window that must
    show the CUDA-core (f32) flash forward and backward kernels.
    Returns the record and the fit's launches."""
    import warnings
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.models.bert import (BertForSequenceClassification,
                                              bert_base)
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bert_base()
    train = SyntheticSST2(FIT_B * FIT_STEPS, FIT_S, cfg.vocab_size, seed)
    held = SyntheticSST2(FIT_B * 4, FIT_S, cfg.vocab_size, seed + 1)

    def build():
        net = BertForSequenceClassification(cfg, device=dev, seed=seed)
        return net, AdamW(learning_rate=2e-5, parameters=net.parameters())

    gc.collect()
    torch.cuda.empty_cache()
    net, opt = build()
    model = Model(net).prepare(opt, CrossEntropyLoss(), Accuracy())
    probe = _SyncProbe(os.path.dirname(os.path.abspath(__file__)))
    stamps = []
    for fn in kernels.values():
        fn.launches = 0
    np.random.seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = probe.showwarning
        try:
            hist = model.fit(train, batch_size=FIT_B, epochs=1, verbose=0,
                             callbacks=[_fit_callback(FIT_STEPS, probe,
                                                      stamps)])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    gaps = np.diff(stamps[4:]) * 1e3
    med = float(np.percentile(gaps, 50))
    ev = model.evaluate(held, batch_size=FIT_B, verbose=0)

    x = torch.as_tensor(train.x[:FIT_B], device=dev)
    y = torch.as_tensor(train.y[:FIT_B], device=dev)
    seen = ("flash_fwd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
    window_seeing(lambda: model.train_batch(x, y), "bert_fit", seen,
                  ("wgmma",))
    win_ms, _events, busy = _window(lambda: model.train_batch(x, y), 3)
    del model, net, opt
    gc.collect()
    torch.cuda.empty_cache()

    # the explicit eager loop over the same batches and seeded weights
    net, opt = build()
    loss_fn = CrossEntropyLoss()
    np.random.seed(seed)
    want = []
    for i, (bx, by) in enumerate(DataLoader(train, batch_size=FIT_B,
                                            shuffle=True)):
        if i == 5:
            break
        loss = loss_fn(net(bx.to(dev)), by.to(dev))
        loss.backward()
        opt.step()
        opt.clear_grad()
        want.append(float(loss.detach()))
    del net, opt
    gc.collect()
    torch.cuda.empty_cache()

    ours = [s for s in probe.sites
            if s.startswith(("paddle_tpu_torch/hapi", "paddle_tpu_torch/io",
                             "paddle_tpu_torch/optimizer"))]
    by_site = {}
    for s in probe.sites:
        by_site[s] = by_site.get(s, 0) + 1
    per_step = {n: c / FIT_STEPS for n, c in launches.items() if c}
    rec = {"config": "bert_base f32, dropout 0.1, AdamW(2e-5)",
           "batch": FIT_B, "seq": FIT_S, "steps": FIT_STEPS,
           "step_ms_p50": med, "wall_s": wall,
           "tokens_per_s": FIT_B * FIT_S / (med / 1e3),
           "mfu_f32_peak": bert_flops(cfg, FIT_B, FIT_S) / (med / 1e3)
           / F32_FLOP_S,
           "device_busy_ms_per_step": busy or "not measured",
           "device_idle_share": (1 - busy / win_ms) if busy
           else "not measured",
           "syncs_by_site": by_site, "syncs_in_hapi_io_optimizer": len(ours),
           "launches_per_step": per_step,
           "losses_first_5": hist["loss"][:5], "eager_losses_first_5": want,
           "first_5_losses_equal_eager": hist["loss"][:5] == want,
           "loss_first": hist["loss"][0], "loss_last": hist["loss"][-1],
           "eval": ev, "flash_kernels_seen": list(seen)}
    log("  bert_fit: " + json.dumps(rec))
    if ours:
        raise AssertionError(f"bert_fit: synchronizing calls from hapi, io "
                             f"or the optimizer in the fit's steps: {ours}")
    if not rec["first_5_losses_equal_eager"]:
        raise AssertionError(f"bert_fit: the fit's first 5 losses "
                             f"{hist['loss'][:5]} differ from the eager "
                             f"loop's {want}")
    if not np.isfinite(hist["loss"]).all():
        raise AssertionError("bert_fit: non-finite loss")
    for name in ("flash_attention_forward", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        if per_step.get(name) != cfg.num_hidden_layers:
            raise AssertionError(f"bert_fit: {name} ran {per_step.get(name)}"
                                 f" times a step, not once a layer")
    return rec, launches


def fit_bert_o1(seed, dev, kernels):
    """(c) ``bert_o1``: ``bench.py``'s config-2 path, BERT-base with f32
    parameters through the graphed ``TrainStep(amp_level="O1")``, batch
    ``FIT_B`` x ``FIT_S``, AdamW(1e-4): with both dropout probabilities at
    0, ``graphed_path`` (the first 5 losses equal ``EagerTrainStep``'s bit
    for bit, the tensor-core flash kernels in a window, timed steps
    capturing nothing); at the config's 0.1, 10 graphed steps whose last
    3 losses average below their first 3.  Returns the record and the
    timed steps' launches."""
    import dataclasses
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import (BertForSequenceClassification,
                                              bert_base)
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    cfg = bert_base()
    quiet = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0)
    data = SyntheticSST2(FIT_B, FIT_S, cfg.vocab_size, seed + 2)
    x = torch.as_tensor(data.x, device=dev)
    y = torch.as_tensor(data.y, device=dev)
    loss_fn = CrossEntropyLoss()

    def maker(c):
        def make(cls):
            net = BertForSequenceClassification(c, device=dev, seed=seed)
            return cls(net, loss_fn, AdamW(
                learning_rate=1e-4, parameters=net.parameters()),
                amp_level="O1", amp_dtype="bfloat16")
        return make

    seen = ("flash_fwd_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
            "flash_bwd_dq_wgmma_kernel")
    refuse = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
              "flash_bwd_dq_kernel")
    rec, launches, _vals = graphed_path(
        "bert_o1", maker(quiet), x, y, kernels,
        bert_flops(cfg, FIT_B, FIT_S), seen=seen, refuse=refuse)
    rec["dropout"] = 0.0
    gc.collect()
    torch.cuda.empty_cache()
    step = maker(cfg)(TrainStep)
    vals = torch.stack([step(x, y) for _ in range(10)]).float().cpu()
    drop = {"dropout": cfg.hidden_dropout_prob,
            "losses": [float(v) for v in vals],
            "captures": step.captures, "replays": step.replays}
    rec["dropout_0.1"] = drop
    log("  bert_o1 dropout 0.1: " + json.dumps(drop))
    del step
    gc.collect()
    torch.cuda.empty_cache()
    if not torch.isfinite(vals).all() or \
            not vals[-3:].mean() < vals[:3].mean():
        raise AssertionError(f"bert_o1: at dropout 0.1 the losses "
                             f"{vals.tolist()} do not fall")
    return rec, launches


def _offload_states(opt):
    return [t for acc in opt._accumulators.values() for t in acc.values()] \
        + list(opt._master_weights.values())


def fit_offload(seed, dev):
    """(d) ``offload``: the llama_small graphed ``TrainStep`` (bf16 +
    AdamW(multi_precision), batch ``TRAIN_B`` x ``TRAIN_S``) after
    ``group_sharded_parallel(..., "os_g", offload=True)`` against the
    same trainer without offload: ``OFFLOAD_STEPS`` steps each from the
    same seeded weights; the losses and the final weights must be equal
    bit for bit, and every state tensor and master a pinned CPU tensor
    between steps.  Step ms p50 (steps after the third, each ended by a
    synchronize) and the device peak over the trainer's start for
    both."""
    from paddle_tpu_torch.distributed import group_sharded_parallel
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_small
    from paddle_tpu_torch.optimizer import AdamW
    cfg = llama_small()
    rng = np.random.default_rng(seed + 3)
    ids_np = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    ids = torch.as_tensor(ids_np[:, :-1], device=dev)
    labels = torch.as_tensor(ids_np[:, 1:], device=dev)

    def run(offload):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                                 seed=seed)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    multi_precision=True)
        model, opt, _ = group_sharded_parallel(model, opt, "os_g",
                                               offload=offload)
        step = TrainStep(model, _lm_loss, opt)
        losses, times = [], []
        for i in range(OFFLOAD_STEPS):
            t0 = time.perf_counter()
            losses.append(step(ids, labels))
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        states = _offload_states(opt)
        out = {"losses": torch.stack(losses).float().cpu(),
               "weights": [p.detach().clone() for p in model.parameters()],
               "step_ms_p50": float(np.percentile(times, 50)),
               "peak_over_start_gb":
                   (torch.cuda.max_memory_allocated() - base) / 1e9,
               "state_gb": sum(t.numel() * t.element_size()
                               for t in states) / 1e9,
               "state_pinned": all(t.device.type == "cpu" and t.is_pinned()
                                   for t in states),
               "state_on_card": all(t.device == dev for t in states),
               "captures": step.captures, "replays": step.replays}
        del step, model, opt, states
        return out

    plain = run(False)
    off = run(True)
    equal = torch.equal(off["losses"], plain["losses"]) and all(
        torch.equal(a, b) for a, b in zip(off["weights"], plain["weights"]))
    rec = {"steps": OFFLOAD_STEPS, "losses": [float(v) for v in
                                              off["losses"]],
           "losses_and_weights_equal_no_offload": equal,
           "state_pinned_on_host": off["state_pinned"],
           "state_gb": off["state_gb"],
           "step_ms_p50": off["step_ms_p50"],
           "step_ms_p50_no_offload": plain["step_ms_p50"],
           "peak_over_start_gb": off["peak_over_start_gb"],
           "peak_over_start_gb_no_offload": plain["peak_over_start_gb"],
           "peak_drop_gb": plain["peak_over_start_gb"]
           - off["peak_over_start_gb"],
           "captures": off["captures"], "replays": off["replays"]}
    del plain, off
    gc.collect()
    torch.cuda.empty_cache()
    log("  offload: " + json.dumps(rec))
    if not (equal and rec["state_pinned_on_host"]):
        raise AssertionError(f"offload: equal to the trainer without "
                             f"offload: {equal}; state pinned on the host: "
                             f"{rec['state_pinned_on_host']}")
    return rec


def mem_available_gb():
    """The host's MemAvailable (``/proc/meminfo``), GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return None


def fit_offload_moe(seed, dev):
    """(e) ``offload_moe``: the MoE training case that did not fit the card
    without offload (``train_paths`` (d) runs 1 layer): Mixtral-8x7B's
    widths cut to ``OFFLOAD_MOE_LAYERS`` layers, bf16 with f32 naive
    gates + AdamW(multi_precision), batch ``MOE_TRAIN_B`` x
    ``MOE_TRAIN_S``, offloaded: ``OFFLOAD_MOE_STEPS`` graphed steps, then
    as many eager (``EagerTrainStep``) ones from the same seeded weights,
    losses equal bit for bit.  The host's MemAvailable first, the pinned
    state's bytes, the device peak and the step ms of each step (host
    clock, each ended by a synchronize)."""
    import dataclasses
    from paddle_tpu_torch.distributed import group_sharded_parallel
    from paddle_tpu_torch.jit import EagerTrainStep, TrainStep
    from paddle_tpu_torch.models.llama_moe import (LlamaMoeForCausalLM,
                                                   mixtral_8x7b)
    from paddle_tpu_torch.optimizer import AdamW
    avail = mem_available_gb()
    log(f"  offload_moe: host MemAvailable {avail:.1f} GB")
    mcfg = dataclasses.replace(mixtral_8x7b(OFFLOAD_MOE_LAYERS),
                               gate_type="naive")
    rng = np.random.default_rng(seed + 4)
    m_np = rng.integers(0, mcfg.vocab_size, (MOE_TRAIN_B, MOE_TRAIN_S + 1))
    ids = torch.as_tensor(m_np[:, :-1], device=dev)
    labels = torch.as_tensor(m_np[:, 1:], device=dev)

    def moe_loss(outputs, lab):
        logits, aux = outputs
        return _lm_loss(logits, lab) + aux

    def run(cls):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = LlamaMoeForCausalLM(mcfg, device=dev, dtype=torch.bfloat16,
                                    seed=seed, gate_dtype=torch.float32)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                    multi_precision=True)
        model, opt, _ = group_sharded_parallel(model, opt, "os_g",
                                               offload=True)
        step = cls(model, moe_loss, opt)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        losses, times = [], []
        for _ in range(OFFLOAD_MOE_STEPS):
            t0 = time.perf_counter()
            losses.append(step(ids, labels))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        states = _offload_states(opt)
        out = {"losses": torch.stack(losses).float().cpu(), "step_ms": times,
               "setup_s": setup,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "pinned_gb": sum(t.numel() * t.element_size()
                                for t in states) / 1e9,
               "state_pinned": all(t.is_pinned() for t in states),
               "params_b": sum(p.numel() for p in model.parameters()) / 1e9,
               "captures": getattr(step, "captures", None),
               "replays": getattr(step, "replays", None)}
        del step, model, opt, states
        return out

    graphed = run(TrainStep)
    eager = run(EagerTrainStep)
    gc.collect()
    torch.cuda.empty_cache()
    # the ~38 GB of pinned blocks go back to the host for later phases
    host_empty = getattr(torch._C, "_host_emptyCache", None)
    if host_empty is not None:
        host_empty()
    equal = torch.equal(graphed["losses"], eager["losses"])
    rec = {"layers": OFFLOAD_MOE_LAYERS, "batch": MOE_TRAIN_B,
           "seq": MOE_TRAIN_S, "params_b": graphed["params_b"],
           "host_mem_available_gb": avail,
           "pinned_state_gb": graphed["pinned_gb"],
           "state_pinned": graphed["state_pinned"],
           "peak_memory_gb": graphed["peak_memory_gb"],
           "peak_memory_gb_eager": eager["peak_memory_gb"],
           "step_ms": graphed["step_ms"],
           "step_ms_eager": eager["step_ms"],
           "setup_s": graphed["setup_s"],
           "losses": [float(v) for v in graphed["losses"]],
           "eager_losses": [float(v) for v in eager["losses"]],
           "graphed_equal_eager": equal,
           "captures": graphed["captures"], "replays": graphed["replays"]}
    log("  offload_moe: " + json.dumps(rec))
    if not (equal and rec["state_pinned"]) or \
            not torch.isfinite(graphed["losses"]).all():
        raise AssertionError(f"offload_moe: graphed {rec['losses']} vs "
                             f"eager {rec['eager_losses']}; state pinned: "
                             f"{rec['state_pinned']}")
    return rec


def fit_phase(seed, dev, card, kernels):
    """The ``fit`` phase: (a) ``loader``, (b) ``bert_fit``, (c)
    ``bert_o1``, (d) ``offload``, (e) ``offload_moe``.  Returns the record
    and the launches of the bert_fit and bert_o1 timed steps."""
    rec, launches = {"card": card}, {}
    log("fit (a) loader: llama_small graphed TrainStep fed by "
        f"DataLoader(device_prefetch=True), batch {TRAIN_B} x {TRAIN_S}")
    rec["loader"] = fit_loader(seed, dev)
    log(f"fit (b) bert_fit: BERT-base f32 Model.fit, batch {FIT_B} x "
        f"{FIT_S}, {FIT_STEPS} steps")
    rec["bert_fit"], launches["bert_fit"] = fit_bert(seed, dev, kernels)
    log(f"fit (c) bert_o1: BERT-base TrainStep(amp_level='O1'), batch "
        f"{FIT_B} x {FIT_S}")
    rec["bert_o1"], launches["bert_o1"] = fit_bert_o1(seed, dev, kernels)
    log("fit (d) offload: llama_small graphed TrainStep, os_g offload vs "
        "none")
    rec["offload"] = fit_offload(seed, dev)
    log(f"fit (e) offload_moe: Mixtral-8x7B widths, {OFFLOAD_MOE_LAYERS} "
        f"layers, batch {MOE_TRAIN_B} x {MOE_TRAIN_S}, offloaded")
    rec["offload_moe"] = fit_offload_moe(seed, dev)
    return rec, launches


# ------------------------------------------------------------------ vision
# bench.py's configs 1 (ResNet-50, CIFAR-10 shapes, b256, O1), 4 (its
# one-card lane: ResNet-50 at ImageNet's 224 x 224, b128, O1) and 3 (CRNN
# + CTC, b64 x 1 x 32 x 320, f32)
VISION_CIFAR_B, VISION_IMAGENET_B = 256, 128
CRNN_B, CRNN_H, CRNN_W, CRNN_CLASSES = 64, 32, 320, 96
VISION_STEPS = 20
# the rest of the zoo: mobilenet_v2 as ImageNet training runs it (b128,
# Momentum 0.1 / 0.9, weight decay 4e-5), then one graphed O1 step of each
# factory at its published widths and input
MBV2_B, MBV2_SIZE = 128, 224
ZOO_B, ZOO_TIMED = 32, 5
ZOO_CASES = (("lenet", 256, 1, 28, 10), ("alexnet", ZOO_B, 3, 224, 1000),
             ("vgg16", ZOO_B, 3, 224, 1000),
             ("squeezenet1_1", ZOO_B, 3, 224, 1000),
             ("mobilenet_v1", ZOO_B, 3, 224, 1000),
             ("mobilenet_v3_small", ZOO_B, 3, 224, 1000),
             ("mobilenet_v3_large", ZOO_B, 3, 224, 1000),
             ("shufflenet_v2_x1_0", ZOO_B, 3, 224, 1000),
             ("densenet121", ZOO_B, 3, 224, 1000),
             ("googlenet", ZOO_B, 3, 224, 1000),
             ("inception_v3", ZOO_B, 3, 299, 1000))


def vision_flops(build, shape):
    """Forward FLOPs (2 a multiply-add) of the convolutions, Linears and
    LSTM products of ``build(device)`` on an input of ``shape``, counted
    by hooks over a forward on the meta device."""
    from paddle_tpu_torch.nn import LSTM, Conv2D, Linear
    model = build(torch.device("meta"))
    total = [0]

    def count(m, inp, out):
        if isinstance(m, Conv2D):
            total[0] += 2 * out.numel() * (m.in_channels // m.groups) \
                * int(np.prod(m.kernel_size))
        elif isinstance(m, Linear):
            total[0] += 2 * out.numel() * m.in_features
        else:
            rows = inp[0].shape[0] * inp[0].shape[1]
            g = 4 * m.hidden_size
            for layer in range(m.num_layers):
                width = m.input_size if layer == 0 \
                    else m.hidden_size * m.bidirect
                total[0] += 2 * rows * g * (width + m.hidden_size) \
                    * m.bidirect

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (Conv2D, Linear, LSTM))]
    with torch.no_grad():
        model(torch.empty(shape, device="meta"))
    for h in hooks:
        h.remove()
    return total[0]


def _state(model):
    """Parameters and buffers (a batch norm's running statistics), cloned."""
    return {n: t.detach().clone() for n, t in model.state_dict().items()}


def _same_state(a, b):
    return [n for n in a if not torch.equal(a[n], b[n])]


def vision_path(label, make, x, y, flops, peak_flop_s, equal_steps,
                steps=VISION_STEPS, twice=False, cudnn_cost=False,
                quiet=None):
    """One ``vision`` sub-case.  ``make(cls)`` builds the model from the
    seed and its ``cls`` train step (``TrainStep`` or ``EagerTrainStep``).
    The graphed step takes ``equal_steps`` steps from the start (the
    first runs eagerly and captures); its losses, parameters and
    batch-norm buffers must then equal an eager twin's after as many
    steps, bit for bit (and, with ``twice``, a second graphed run's from
    the same start).  Then ``steps`` timed steps, which must capture
    nothing, and 2 in a profiler window: step ms p25/p50/p75, images/s,
    device busy ms and idle share, device ms by kernel class, launches a
    step, mfu against ``peak_flop_s``, peak memory.  With
    ``cudnn_cost``, a graphed trainer whose convolutions may take
    cuDNN's nondeterministic algorithms is timed too (its graph is
    captured without the port's deterministic flags), beside the step.
    With ``quiet`` (a maker of the same model with its dropouts at 0),
    the bit-for-bit check runs on ``quiet``'s graphed and eager trainers
    and the timed steps on ``make``'s, dropout drawing."""
    from paddle_tpu_torch.jit import EagerTrainStep, TrainStep
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    equal = quiet or make
    step = equal(TrainStep)
    losses = [step(x, y) for _ in range(equal_steps)]
    graphed_state = _state(step.model)
    if quiet is not None:
        del step
        gc.collect()
        torch.cuda.empty_cache()
        step = make(TrainStep)
        losses += [step(x, y) for _ in range(2)]
    captures_warmup = step.captures
    captured, replayed = step.captures, step.replays
    times = _host_ms(lambda: losses.append(step(x, y)), steps)
    captures, replays = step.captures - captured, step.replays - replayed
    peak = torch.cuda.max_memory_allocated()
    _ms, events, busy_ms = _window(lambda: losses.append(step(x, y)), 2)
    by_class, launches, top = {}, 0, []
    for e in events:
        us = _device_us(e)
        if us:
            cls = _vision_class(e.key)
            by_class[cls] = by_class.get(cls, 0.0) + us / 1e3 / 2
            launches += e.count
            top.append((us / 1e3 / 2, e.count // 2, e.key[:80]))
    top.sort(reverse=True)
    vals = torch.stack(losses).float().cpu().numpy()
    del step, losses
    gc.collect()
    torch.cuda.empty_cache()
    rec = {}
    if cudnn_cost:
        from unittest import mock
        from paddle_tpu_torch.nn import functional as PF
        with mock.patch.object(PF, "_deterministic_cudnn",
                               contextlib.nullcontext):
            free = make(TrainStep)
            for _ in range(3):
                free(x, y)
            rec["nondeterministic_cudnn_step_ms_p50"] = float(np.median(
                _host_ms(lambda: free(x, y), 10)))
        del free
        gc.collect()
        torch.cuda.empty_cache()
    eager = equal(EagerTrainStep)
    eager_vals = torch.stack([eager(x, y) for _ in range(equal_steps)]) \
        .float().cpu().numpy()
    apart = _same_state(graphed_state, _state(eager.model))
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    again = []
    if twice:
        second = equal(TrainStep)
        for _ in range(equal_steps):
            second(x, y)
        again = _same_state(graphed_state, _state(second.model))
        del second
        gc.collect()
        torch.cuda.empty_cache()
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    rec.update({
        "step_ms_p25": q1, "step_ms_p50": med, "step_ms_p75": q3,
        "images_per_s": x.shape[0] / (med / 1e3),
        "model_flops_per_step": flops,
        "mfu": flops / (med / 1e3) / peak_flop_s,
        "peak_flop_s": peak_flop_s,
        "device_busy_ms_per_step": busy_ms or "not measured",
        "device_idle_share": (1 - busy_ms / med) if busy_ms
        else "not measured",
        "device_ms_per_step_by_class": by_class,
        "top_kernels_ms_calls_per_step": top[:10],
        "launches_per_step": launches / 2,
        "peak_memory_gb": peak / 1e9,
        "peak_over_start_gb": (peak - base) / 1e9,
        "captures_warmup": captures_warmup, "captures": captures,
        "replays": replays,
        "losses_first": [float(v) for v in vals[:equal_steps]],
        "loss_last": float(vals[-1]),
        "graphed_equals_eager_steps": equal_steps,
        "graphed_equals_eager": bool(
            np.array_equal(vals[:equal_steps], eager_vals)) and not apart,
        "state_tensors_apart": apart})
    if twice:
        rec["two_runs_equal"] = not again
    log(f"  {label}: " + json.dumps(rec))
    if not np.isfinite(vals).all():
        raise AssertionError(f"{label}: non-finite loss {vals.tolist()}")
    if captures or replays != steps:
        raise AssertionError(f"{label}: the timed steps captured "
                             f"{captures} graphs and replayed {replays}")
    if not rec["graphed_equals_eager"]:
        raise AssertionError(
            f"{label}: after {equal_steps} steps the graphed trainer's "
            f"losses {vals[:equal_steps].tolist()} / eager "
            f"{eager_vals.tolist()}, tensors apart: {apart[:8]}")
    if again:
        raise AssertionError(f"{label}: two graphed runs from one start "
                             f"differ in {again[:8]}")
    return rec


def _vision_class(name):
    """A device kernel's share of a vision step: torch's own depthwise
    convolution kernels (``conv_depthwise2d*``, which torch runs for
    depthwise convolutions instead of cuDNN), cuDNN's convolutions
    (kernels named for a convolution, its data or weight gradient, an FFT
    or a layout transpose), GEMMs (cuBLAS, and any convolution cuDNN runs
    as a plain GEMM), and the torch ops (batch norm, casts, pooling, the
    LSTM's gates, the CTC recursion, the optimizer)."""
    low = name.lower()
    if "conv_depthwise" in low:
        return "torch_depthwise_conv"
    if any(k in low for k in ("conv", "cudnn", "wgrad", "dgrad", "fprop",
                              "fft", "nchwtonhwc", "nhwctonchw")):
        return "cudnn_conv"
    if "nvjet" in low or "gemm" in low or "cutlass" in low:
        return "gemm"
    return "other_torch_ops"


def _rel_l2(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm())


def vision_small_f32(seed, dev):
    """(d) ``small_f32``: resnet18(num_classes=10) at b16 x 3 x 32 x 32 and
    crnn_tiny(8, img_height=16) at b4 x 1 x 16 x 32, f32, TF32 off, the
    same weights (drawn on the CPU, copied to the card): train-mode
    logits, then one step (Momentum 0.01, 0.9; the graphed ``TrainStep``
    on the card, ``EagerTrainStep`` on the CPU): the loss and every
    parameter and buffer within relative L2 1e-4.  resnet18 takes 16
    images: its last stage's maps are 1 x 1, and a batch norm over 4
    values a channel turns rounding into gradients 1e-2 apart (at b4 a
    convolution's weight came out 1.6e-4 from the CPU's after one step,
    with logits 1.9e-5 apart)."""
    from paddle_tpu_torch.jit import EagerTrainStep, TrainStep
    from paddle_tpu_torch.models import crnn_tiny
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18
    gen = torch.Generator().manual_seed(seed + 9)
    cases = {
        "resnet18": (lambda d: resnet18(num_classes=10, device=d, seed=seed),
                     torch.randn(16, 3, 32, 32, generator=gen),
                     torch.randint(0, 10, (16,), generator=gen),
                     lambda ilen, llen: CrossEntropyLoss()),
        "crnn_tiny": (lambda d: crnn_tiny(8, img_height=16, device=d,
                                          seed=seed),
                      torch.randn(4, 1, 16, 32, generator=gen),
                      torch.randint(1, 8, (4, 4), generator=gen),
                      lambda ilen, llen: lambda o, y: PF.ctc_loss(
                          o, y, ilen, llen))}
    rec = {}
    for name, (build, x, y, loss) in cases.items():
        cpu = build("cpu")
        card = build(dev)
        card.load_state_dict(cpu.state_dict())
        logits = {}
        # no autograd graph may outlive the forward: a step captured while
        # one holds the parameters' AccumulateGrad nodes fails
        with torch.no_grad():
            for side, model, d in (("cpu", cpu, "cpu"),
                                   ("card", card, dev)):
                logits[side] = model(x.to(d))
        ilen, llen = torch.full((4,), 8), torch.full((4,), 4)
        steps = {}
        for side, model, d, cls in (("cpu", cpu, "cpu", EagerTrainStep),
                                    ("card", card, dev, TrainStep)):
            fn = loss(ilen.to(d), llen.to(d))
            steps[side] = cls(model, fn, Momentum(
                learning_rate=0.01, momentum=0.9,
                parameters=model.parameters()))(x.to(d), y.to(d))
        want, got = cpu.state_dict(), card.state_dict()
        rels = {n: _rel_l2(got[n], want[n]) for n in want
                if want[n].abs().sum() > 0}
        worst = max(rels, key=rels.get)
        r = {"logits_rel_l2": _rel_l2(logits["card"], logits["cpu"]),
             "loss_card": float(steps["card"]),
             "loss_cpu": float(steps["cpu"]),
             "tensor_rel_l2_worst": rels[worst], "tensor_worst": worst}
        rec[name] = r
        log(f"  small_f32 {name}: " + json.dumps(r))
        if not (r["logits_rel_l2"] <= 1e-4 and rels[worst] <= 1e-4 and
                abs(r["loss_card"] - r["loss_cpu"])
                <= 1e-4 * abs(r["loss_cpu"])):
            raise AssertionError(f"small_f32 {name}: the card is further "
                                 f"from the CPU than 1e-4: {r}")
    return rec


def _zoo_build(name):
    from paddle_tpu_torch.vision import models as zoo
    return zoo.LeNet if name == "lenet" else getattr(zoo, name)


def _no_dropout(model):
    from paddle_tpu_torch.nn import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


def vision_mobilenet_v2(seed, dev, rng):
    """(e) ``mobilenet_v2``: ``mobilenet_v2()`` (scale 1.0, 1000 classes),
    b128 x 3 x 224 x 224, Momentum(0.1, 0.9, weight_decay=4e-5), O1,
    through ``vision_path``: graphed = eager bit for bit with the
    classifier's dropout at 0 (2 steps), then the timed steps with the
    published Dropout(0.2) drawing from the model's generator (which the
    graphed step registers); also timed with the convolutions free of the
    port's deterministic flags."""
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import mobilenet_v2
    ce = CrossEntropyLoss()

    def maker(p):
        def make(cls):
            net = mobilenet_v2(device=dev, seed=seed)
            if p == 0.0:
                _no_dropout(net)
            return cls(net, ce, Momentum(
                learning_rate=0.1, momentum=0.9, weight_decay=4e-5,
                parameters=net.parameters()), amp_level="O1")
        return make

    x = torch.as_tensor(rng.standard_normal(
        (MBV2_B, 3, MBV2_SIZE, MBV2_SIZE)).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.integers(0, 1000, MBV2_B), device=dev)
    flops = 3 * vision_flops(lambda d: mobilenet_v2(device=d, seed=None),
                             tuple(x.shape))
    rec = vision_path("mobilenet_v2", maker(0.2), x, y, flops, BF16_FLOP_S,
                      2, quiet=maker(0.0), cudnn_cost=True)
    rec["dropout_in_timed_steps"] = 0.2
    return rec


def vision_zoo_steps(seed, dev, rng):
    """(f) ``zoo``: each factory of ``ZOO_CASES`` at its published widths
    through the graphed ``TrainStep`` at O1 (Momentum(0.01, 0.9,
    weight_decay=4e-5: vgg16 and alexnet, without batch norm, are
    trained at 0.01; ``CrossEntropyLoss``; googlenet with its aux heads,
    ce(out) + 0.3 (ce(aux1) + ce(aux2))): one step that captures, then
    ``ZOO_TIMED`` timed replays, which must capture nothing: step ms p50,
    images/s, mfu, peak memory, captures."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    ce = CrossEntropyLoss()

    def aux_loss(out, y):
        return ce(out[0], y) + 0.3 * (ce(out[1], y) + ce(out[2], y))

    rec = {}
    for name, b, ch, size, classes in ZOO_CASES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        build = _zoo_build(name)
        x = torch.as_tensor(rng.standard_normal(
            (b, ch, size, size)).astype(np.float32), device=dev)
        y = torch.as_tensor(rng.integers(0, classes, b), device=dev)
        net = build(num_classes=classes, device=dev, seed=seed)
        step = TrainStep(net, aux_loss if name == "googlenet" else ce,
                         Momentum(learning_rate=0.01, momentum=0.9,
                                  weight_decay=4e-5,
                                  parameters=net.parameters()),
                         amp_level="O1")
        t0 = time.perf_counter()
        first = step(x, y)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        captured = step.captures
        losses = [first]
        times = _host_ms(lambda: losses.append(step(x, y)), ZOO_TIMED)
        flops = 3 * vision_flops(
            lambda d: build(num_classes=classes, device=d, seed=None),
            tuple(x.shape))
        med = float(np.median(times))
        vals = torch.stack(losses).float().cpu()
        r = {"batch": b, "input": [ch, size, size], "step_ms_p50": med,
             "images_per_s": b / (med / 1e3),
             "model_flops_per_step": flops,
             "mfu": flops / (med / 1e3) / BF16_FLOP_S,
             "first_step_s": first_s,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "captures_warmup": captured,
             "captures": step.captures - captured,
             "replays": step.replays, "loss_first": float(vals[0]),
             "loss_last": float(vals[-1])}
        rec[name] = r
        log(f"  zoo {name}: " + json.dumps(r))
        del step, net, x, y, losses
        if not torch.isfinite(vals).all():
            raise AssertionError(f"zoo {name}: non-finite loss "
                                 f"{vals.tolist()}")
        if r["captures"] or r["replays"] != ZOO_TIMED:
            raise AssertionError(f"zoo {name}: the timed steps captured "
                                 f"{r['captures']} graphs, replayed "
                                 f"{r['replays']}")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def vision_zoo_small_f32(seed, dev):
    """The zoo's card-vs-CPU check: ``mobilenet_v3_small(scale=0.5)`` and
    ``shufflenet_v2_x0_25`` (10 classes) in f32 (TF32 off), eval, b4 x 3
    x 64 x 64, the same weights (drawn on the CPU, copied to the card):
    logits within relative L2 1e-4."""
    from paddle_tpu_torch.vision.models import (mobilenet_v3_small,
                                                shufflenet_v2_x0_25)
    gen = torch.Generator().manual_seed(seed + 13)
    x = torch.randn(4, 3, 64, 64, generator=gen)
    rec = {}
    for name, build in (("mobilenet_v3_small_x0_5",
                         lambda d: mobilenet_v3_small(
                             scale=0.5, num_classes=10, device=d,
                             seed=seed)),
                        ("shufflenet_v2_x0_25",
                         lambda d: shufflenet_v2_x0_25(
                             num_classes=10, device=d, seed=seed))):
        cpu = build("cpu").eval()
        card = build(dev).eval()
        card.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            rel = _rel_l2(card(x.to(dev)), cpu(x))
        rec[name] = {"logits_rel_l2": rel}
        log(f"  zoo small_f32 {name}: logits rel L2 {rel:.3g}")
        if not rel <= 1e-4:
            raise AssertionError(f"zoo small_f32 {name}: the card's "
                                 f"logits are {rel} from the CPU's")
    return rec


def vision_phase(seed, dev, card):
    """The ``vision`` phase: (a) ``resnet50_cifar``, (b)
    ``resnet50_imagenet``, (c) ``crnn_ctc``, (d) ``small_f32``, (e)
    ``mobilenet_v2``, (f) ``zoo`` and the zoo's ``zoo_small_f32``.
    Returns the record."""
    from paddle_tpu_torch.models import CRNN
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.nn import functional as PF
    from paddle_tpu_torch.optimizer import Adam, Momentum
    from paddle_tpu_torch.vision.models import resnet50
    rec = {"card": card}
    ce = CrossEntropyLoss()
    rng = np.random.default_rng(seed + 7)

    def resnet_maker(classes):
        def make(cls):
            net = resnet50(num_classes=classes, device=dev, seed=seed)
            return cls(net, ce, Momentum(
                learning_rate=0.1, momentum=0.9, weight_decay=5e-4,
                parameters=net.parameters()), amp_level="O1")
        return make

    for label, classes, batch, size, equal in (
            ("resnet50_cifar", 10, VISION_CIFAR_B, 32, 3),
            ("resnet50_imagenet", 1000, VISION_IMAGENET_B, 224, 2)):
        log(f"vision ({'a' if classes == 10 else 'b'}) {label}: "
            f"resnet50(num_classes={classes}), b{batch} x 3 x {size} x "
            f"{size}, Momentum(0.1, 0.9, weight_decay=5e-4), graphed "
            "TrainStep at O1")
        x = torch.as_tensor(rng.standard_normal(
            (batch, 3, size, size)).astype(np.float32), device=dev)
        y = torch.as_tensor(rng.integers(0, classes, batch), device=dev)
        flops = 3 * vision_flops(
            lambda d, c=classes: resnet50(num_classes=c, device=d,
                                          seed=None), tuple(x.shape))
        rec[label] = vision_path(label, resnet_maker(classes), x, y, flops,
                                 BF16_FLOP_S, equal, cudnn_cost=True)
        del x, y
    log(f"vision (c) crnn_ctc: CRNN({CRNN_CLASSES}, img_height={CRNN_H}), "
        f"b{CRNN_B} x 1 x {CRNN_H} x {CRNN_W}, labels {CRNN_W // 8} tokens, "
        f"input lengths {CRNN_W // 4}, Adam(1e-3), f32, graphed TrainStep")
    x = torch.as_tensor(rng.standard_normal(
        (CRNN_B, 1, CRNN_H, CRNN_W)).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.integers(1, CRNN_CLASSES,
                                     (CRNN_B, CRNN_W // 8)), device=dev)
    ilen = torch.full((CRNN_B,), CRNN_W // 4, dtype=torch.int64, device=dev)
    llen = torch.full((CRNN_B,), CRNN_W // 8, dtype=torch.int64, device=dev)

    def crnn_make(cls):
        net = CRNN(CRNN_CLASSES, img_height=CRNN_H, device=dev, seed=seed)
        return cls(net, lambda o, lab: PF.ctc_loss(o, lab, ilen, llen),
                   Adam(learning_rate=1e-3, parameters=net.parameters()))

    flops = 3 * vision_flops(
        lambda d: CRNN(CRNN_CLASSES, img_height=CRNN_H, device=d,
                       seed=None), tuple(x.shape))
    rec["crnn_ctc"] = vision_path("crnn_ctc", crnn_make, x, y, flops,
                                  F32_FLOP_S, 3, twice=True)
    del x, y
    log("vision (d) small_f32: resnet18 and crnn_tiny, card vs CPU")
    rec["small_f32"] = vision_small_f32(seed, dev)
    log(f"vision (e) mobilenet_v2: mobilenet_v2(), b{MBV2_B} x 3 x 224 x "
        "224, Momentum(0.1, 0.9, weight_decay=4e-5), graphed TrainStep at "
        "O1, Dropout(0.2) in the timed steps")
    rec["mobilenet_v2"] = vision_mobilenet_v2(seed, dev, rng)
    log(f"vision (f) zoo: one graphed O1 step a factory, then {ZOO_TIMED} "
        "timed replays")
    rec["zoo"] = vision_zoo_steps(seed, dev, rng)
    rec["zoo_small_f32"] = vision_zoo_small_f32(seed, dev)
    return rec


# Transformer-base (Vaswani et al. 2017, "Attention Is All You Need",
# Table 3, base: d_model 512, 8 heads, 6 + 6 layers, d_ff 2048, dropout
# 0.1, WMT14 En-De's shared vocabulary of about 37000 tokens) trained at
# b32 x 128 source and 128 target tokens, then beam search (beam 4, 64
# steps) over 8 source sentences of 128 tokens
S2S_D, S2S_HEADS, S2S_LAYERS, S2S_FF, S2S_VOCAB = 512, 8, 6, 2048, 37000
S2S_B, S2S_SRC, S2S_TGT = 32, 128, 128
S2S_LR = 1e-4
BEAM_B, BEAM_K, BEAM_STEPS = 8, 4, 64
BOS, EOS = 1, 2
S2S_FLASH = {"flash_attention_forward": 12, "flash_attention_bwd_dkv": 12,
             "flash_attention_bwd_dq": 12}


class Seq2Seq(torch.nn.Module):
    """Transformer-base as a user of ``paddle.nn.Transformer`` builds it
    around the port's ``Transformer``: source and target token
    embeddings scaled by sqrt(d_model) plus a learned position
    embedding, the causal ``tgt_mask`` (a buffer), and the output Linear
    over the vocabulary.  ``forward(src, tgt)`` gives the logits [b,
    tgt, vocab].  The embeddings are drawn N(0, d_model^-0.5) and the
    output Linear by the JAX package's Linear law, from ``seed``."""

    def __init__(self, dev, seed, dropout=0.1, dtype=None, d_model=S2S_D,
                 nhead=S2S_HEADS, layers=S2S_LAYERS, ff=S2S_FF,
                 vocab=S2S_VOCAB, max_len=256, tgt_len=S2S_TGT):
        from paddle_tpu_torch.nn import Embedding, Linear, Transformer
        from paddle_tpu_torch.nn.layer.transformer import xavier_normal_
        super().__init__()
        self.scale = d_model ** 0.5
        self.transformer = Transformer(d_model, nhead, layers, layers, ff,
                                       dropout, device=dev, dtype=dtype,
                                       seed=seed)
        kw = dict(device=dev, dtype=dtype)
        self.src_emb = Embedding(vocab, d_model, **kw)
        self.tgt_emb = Embedding(vocab, d_model, **kw)
        self.pos_emb = Embedding(max_len, d_model, **kw)
        self.out = Linear(d_model, vocab, bias=True, **kw)
        self.register_buffer(
            "tgt_mask",
            self.transformer.generate_square_subsequent_mask(tgt_len))
        gen = torch.Generator(device=dev).manual_seed(seed + 2)
        with torch.no_grad():
            for emb in (self.src_emb, self.tgt_emb, self.pos_emb):
                emb.weight.normal_(0.0, d_model ** -0.5, generator=gen)
            xavier_normal_(self.out.weight, gen)
            self.out.bias.zero_()

    def embed(self, emb, ids, pos):
        return emb(ids) * self.scale + self.pos_emb(pos)

    def encode(self, src):
        pos = torch.arange(src.shape[1], device=src.device)
        return self.transformer.encoder(self.embed(self.src_emb, src, pos))

    def forward(self, src, tgt):
        t = tgt.shape[1]
        pos = torch.arange(t, device=tgt.device)
        h = self.transformer.decoder(self.embed(self.tgt_emb, tgt, pos),
                                     self.encode(src),
                                     self.tgt_mask[:t, :t])
        return self.out(h)


class BeamCell:
    """The decoder of a ``Seq2Seq`` as a ``BeamSearchDecoder`` cell.  Its
    states are (the position [n], each layer's (Cache, StaticCache) of
    ``gen_cache(memory)`` as plain tuples: the decode loop rebuilds nested
    states with their type, which a namedtuple does not allow).  A call
    adds the position embedding to the tokens' embeddings, runs the
    decoder over the caches (one query row a sequence: the flash forward
    against the cached keys, then against the source's) and returns the
    last hidden state."""

    def __init__(self, model):
        from paddle_tpu_torch.nn import MultiHeadAttention
        self.model = model
        self.mha = MultiHeadAttention

    def init_states(self, memory):
        caches = self.model.transformer.decoder.gen_cache(memory)
        pos = torch.zeros(memory.shape[0], dtype=torch.int64,
                          device=memory.device)
        return pos, self.plain(caches)

    @staticmethod
    def plain(caches):
        return tuple((tuple(incr), tuple(static))
                     for incr, static in caches)

    def embed(self, ids):
        return self.model.tgt_emb(ids) * self.model.scale

    def __call__(self, inputs, states):
        pos, caches = states
        x = (inputs + self.model.pos_emb(pos))[:, None]
        named = [(self.mha.Cache(*incr), self.mha.StaticCache(*static))
                 for incr, static in caches]
        out, named = self.model.transformer.decoder(x, None, cache=named)
        return out[:, 0], (pos + 1, self.plain(named))


def seq2seq_flops(b, src, tgt, d=S2S_D, ff=S2S_FF, layers=S2S_LAYERS,
                  vocab=S2S_VOCAB):
    """Model FLOPs of one training step, from the shapes: forward plus a
    backward of twice the forward.  Linears, 2 per weight per token: the
    encoder's (4 d^2 + 2 d ff) over source tokens, the decoder's
    self-attention, cross-attention query and output, and feed-forward
    (6 d^2 + 2 d ff) over target tokens and its cross-attention keys and
    values (2 d^2) over source tokens, the output Linear (d vocab) over
    target tokens.  Attention products (QK^T and PV, 4 d a pair) a layer:
    the encoder's src^2 pairs, the decoder's causal pairs and its tgt x
    src cross pairs."""
    linear = layers * ((4 * d * d + 2 * d * ff) * b * src
                       + (6 * d * d + 2 * d * ff) * b * tgt
                       + 2 * d * d * b * src) + d * vocab * b * tgt
    pairs = layers * b * (src * src + causal_pairs(tgt, tgt, True)
                          + tgt * src)
    return 3 * (2 * linear + 4 * d * pairs)


def time_seq2seq_shapes(records, dev):
    """The flash kernels at the Transformer's shapes, bf16, d64, no mask,
    each held against its plain version, then timed beside it and
    ``scaled_dot_product_attention``: forward, dK/dV and dQ at the
    training shape (b32 h8 s128: the encoder's self-attention and the
    decoder's cross-attention), and the forward at beam search's shapes
    (b32 = 8 sentences x beam 4, h8, one query row against the source's
    128 keys or the target cache's 1, 17 and 64).  Adds each kernel's
    ``seq2seq_train`` and the forward's ``seq2seq_beam_sk{n}``
    records."""
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(17)
    b, h, d = S2S_B, S2S_HEADS, S2S_D // S2S_HEADS
    el = 2

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    for sq, sk in ((S2S_SRC, S2S_SRC), (1, S2S_SRC), (1, 1), (1, 17),
                   (1, 64)):
        tag = "seq2seq_train" if sq > 1 else f"seq2seq_beam_sk{sk}"
        label = f"seq2seq b{b} h{h} sq{sq} sk{sk} d{d} full bf16"
        q, do = rnd(b, h, sq, d), rnd(b, h, sq, d)
        k, v = rnd(b, h, sk, d), rnd(b, h, sk, d)
        out, lse = fa.flash_attention_cuda(q, k, v, causal=False)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=False)
        torch.cuda.synchronize()
        err = check("flash_attention_forward", label, out, ref, 2e-2)
        check("flash_attention_forward", label + " lse", lse, ref_lse, 1e-4)
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=False))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, False),
                           reps=3)
        lib_ms = cuda_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(q, k, v))
        pairs = b * h * sq * sk
        bms, by = bound_ms((2 * q.numel() + 2 * k.numel()) * el
                           + b * h * sq * 4, 4 * pairs * d, BF16_FLOP_S)
        log(f"  flash_attention_forward {label}: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by})")
        records.setdefault("flash_attention_forward", {})[tag] = dict(
            case=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=lib_ms)
        if sq == 1:
            continue
        scale = d ** -0.5
        got = fa.flash_attention_backward_cuda(q, k, v, out, lse, do, False,
                                               scale)
        want = fa._bwd_blockwise(q, k, v, out, lse, do, False, scale)
        torch.cuda.synchronize()
        errs = {n: check("flash_attention_bwd", f"{label} {n}", g, r, 1e-2)
                for n, g, r in zip(("dq", "dk", "dv"), got, want)}
        delta = (out.float() * do.float()).sum(-1).contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        args = (q, k, v, do, lse, delta, dq, dk, dv, False, scale)
        dkv_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv_cuda(*args))
        dq_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq_cuda(*args))
        plain_ms = cuda_ms(lambda: fa._bwd_blockwise(
            q, k, v, out, lse, do, False, scale), reps=3)
        lq, lk, lv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lout = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv)
        lib_ms = profiled_ms(lambda: torch.autograd.grad(
            lout, (lq, lk, lv), do, retain_graph=True))
        rows = b * h * sq * 4 * 2                    # lse and delta, f32
        for name, ms, n_ops, n_bytes, e in (
                ("flash_attention_bwd_dkv", dkv_ms, 4 * 2 * pairs * d,
                 (2 * q.numel() + 4 * k.numel()) * el + rows,
                 max(errs["dk"], errs["dv"])),
                ("flash_attention_bwd_dq", dq_ms, 3 * 2 * pairs * d,
                 (3 * q.numel() + 2 * k.numel()) * el + rows, errs["dq"])):
            bms, by = bound_ms(n_bytes, n_ops, BF16_FLOP_S)
            log(f"  {name} {label}: {ms:.4f} ms, plain (dq+dk+dv) "
                f"{plain_ms:.4f} ms, sdpa backward (dq+dk+dv, profiler) "
                f"{lib_ms} ms, bound {bms:.4f} ms ({by})")
            records.setdefault(name, {})[tag] = dict(
                case=label, max_abs_err=e, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)


def s2s_data(seed, dev, b, src_len, tgt_len, vocab):
    """Source ids and the target's input and label ids (the target drawn
    one token longer and shifted), from ``np.random.default_rng(seed)``
    as bench.py draws its data."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vocab, (b, src_len))
    tgt = rng.integers(0, vocab, (b, tgt_len + 1))
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (src, tgt[:, :-1], tgt[:, 1:]))


def seq2seq_train(seed, dev, kernels):
    """(a) ``train``: ``Seq2Seq`` (f32 parameters) through the graphed
    ``TrainStep(amp_level="O1")``, Adam(beta2 0.98, eps 1e-9: the
    paper's; a constant 1e-4 for its 4000-step warm-up, which would leave
    these steps below 5e-6), cross entropy over the logits, b32 x 128
    source and 128 target tokens.  With dropout 0, ``graphed_path``: the
    first 5 losses equal ``EagerTrainStep``'s bit for bit, 20 timed steps
    capturing nothing, a profiler window that must show the tensor-core
    flash kernels; each timed step launches the flash forward, dK/dV and
    dQ 12 times (6 encoder self-attentions, 6 cross-attentions; the
    decoder's masked self-attention is the plain softmax, as in JAX) and
    no other kernel of the port.  At the published dropout 0.1, 10
    graphed steps whose last 3 losses average below their first 3.
    Returns the record and the timed steps' launches."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Adam
    src, tgt_in, tgt_out = s2s_data(seed, dev, S2S_B, S2S_SRC, S2S_TGT,
                                    S2S_VOCAB)
    ce = CrossEntropyLoss()

    def maker(dropout):
        def make(cls):
            net = Seq2Seq(dev, seed, dropout)
            return cls(net, ce, Adam(
                learning_rate=S2S_LR, beta2=0.98, epsilon=1e-9,
                parameters=net.parameters()), amp_level="O1")
        return make

    seen = ("flash_fwd_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
            "flash_bwd_dq_wgmma_kernel")
    refuse = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
              "flash_bwd_dq_kernel")
    rec, launches, _vals = graphed_path(
        "seq2seq_train", maker(0.0), (src, tgt_in), tgt_out, kernels,
        seq2seq_flops(S2S_B, S2S_SRC, S2S_TGT), seen=seen, refuse=refuse,
        tokens=tgt_out.numel())
    rec["dropout"] = 0.0
    rec["model_flops_counted"] = (
        "3 x forward: Linears 2 a weight a token, the output Linear over "
        "target tokens, attention 4 d a visible pair (decoder causal)")
    if rec["launches_per_step"] != S2S_FLASH:
        raise AssertionError(f"seq2seq_train: launches a step "
                             f"{rec['launches_per_step']}, not {S2S_FLASH}")
    gc.collect()
    torch.cuda.empty_cache()
    step = maker(0.1)(TrainStep)
    vals = torch.stack([step((src, tgt_in), tgt_out)
                        for _ in range(10)]).float().cpu()
    drop = {"dropout": 0.1, "losses": [float(v) for v in vals],
            "captures": step.captures, "replays": step.replays}
    rec["dropout_0.1"] = drop
    log("  seq2seq_train dropout 0.1: " + json.dumps(drop))
    del step
    gc.collect()
    torch.cuda.empty_cache()
    if not torch.isfinite(vals).all() or \
            not vals[-3:].mean() < vals[:3].mean():
        raise AssertionError(f"seq2seq_train: at dropout 0.1 the losses "
                             f"{vals.tolist()} do not fall")
    return rec, launches


def beam_decode(model, src, beam, steps):
    """``dynamic_decode`` of a ``BeamSearchDecoder`` over ``model``'s
    ``BeamCell`` (start ``BOS``, end ``EOS``): the encoder once, then the
    loop.  Returns (ids, final states, lengths, the steps' outputs, the
    host time of each step's start, the encoder's and the loop's wall
    ms)."""
    from paddle_tpu_torch.nn import BeamSearchDecoder, dynamic_decode
    t0 = time.perf_counter()
    memory = model.encode(src)
    cell = BeamCell(model)
    inits = cell.init_states(memory)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decoder = BeamSearchDecoder(cell, BOS, EOS, beam,
                                embedding_fn=cell.embed,
                                output_fn=model.out)
    stamps, outputs = [], []
    step, finalize = decoder.step, decoder.finalize

    def timed_step(*args, **kw):
        stamps.append(time.perf_counter())
        return step(*args, **kw)

    def keep(outs, states, lengths):
        outputs.extend(outs)
        return finalize(outs, states, lengths)

    decoder.step, decoder.finalize = timed_step, keep
    ids, states, lengths = dynamic_decode(decoder, inits,
                                          max_step_num=steps,
                                          return_length=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stamps.append(t2)
    return (ids, states, lengths, outputs, stamps, (t1 - t0) * 1e3,
            (t2 - t1) * 1e3)


def seq2seq_beam(seed, dev, kernels):
    """(b) ``beam``: the same model (``Seq2Seq`` from the seed) in bf16,
    eval, ``BeamSearchDecoder(beam_size=4)`` + ``dynamic_decode
    (max_step_num=64)`` over 8 source sentences of 128 tokens: a warm-up
    decode, then one with the launch counters zeroed just before the
    loop and read just after (12 flash forwards a step: each decoder
    layer's cached self-attention and its cross-attention; no other
    kernel of the port), then one in a profiler window for the device's
    busy time.  Encoder ms, decode step ms p50 (host clock from one
    step's start to the next, the loop's one ``finished.all()`` read a
    step included), steps, hypothesis tokens/s (sentences x beam x steps
    over the loop's wall time), the ids' shape [8, steps, 4]."""
    model = Seq2Seq(dev, seed, dtype=torch.bfloat16).eval()
    src = torch.as_tensor(np.random.default_rng(seed + 19).integers(
        0, S2S_VOCAB, (BEAM_B, S2S_SRC)), device=dev)
    with torch.no_grad():
        beam_decode(model, src, BEAM_K, 4)
        for fn in kernels.values():
            fn.launches = 0
        ids, states, lengths, outputs, stamps, enc_ms, loop_ms = \
            beam_decode(model, src, BEAM_K, BEAM_STEPS)
        launches = {n: fn.launches for n, fn in kernels.items()
                    if fn.launches}
        win_ms, _events, busy_ms = _window(
            lambda: beam_decode(model, src, BEAM_K, BEAM_STEPS), 1)
    steps = len(outputs)
    step_ms = np.diff(stamps[:-1]) * 1e3 if steps > 2 else [loop_ms]
    # a step: each decoder layer's self- and cross-attention; the
    # encoder's self-attentions run once inside the counted call too
    want = {"flash_attention_forward": 2 * S2S_LAYERS * steps + S2S_LAYERS}
    rec = {"batch": BEAM_B, "beam": BEAM_K, "max_steps": BEAM_STEPS,
           "steps": steps, "encoder_ms": enc_ms,
           "decode_loop_ms": loop_ms,
           "decode_step_ms_p50": float(np.median(step_ms)),
           "hypothesis_tokens_per_s": BEAM_B * BEAM_K * steps
           / (loop_ms / 1e3),
           "flash_launches": launches.get("flash_attention_forward", 0),
           "flash_launches_per_step": (launches.get(
               "flash_attention_forward", 0) - S2S_LAYERS) / steps,
           "launches": launches,
           "window_ms": win_ms,
           "device_busy_ms": busy_ms or "not measured",
           "device_idle_share": (1 - busy_ms / win_ms) if busy_ms
           else "not measured",
           "ids_shape": list(ids.shape),
           "lengths": lengths.cpu().tolist(),
           "finished": int(states.finished.sum())}
    log("  seq2seq_beam: " + json.dumps(rec))
    if launches != want:
        raise AssertionError(f"seq2seq_beam: launches {launches}, not "
                             f"{want}")
    if list(ids.shape) != [BEAM_B, steps, BEAM_K]:
        raise AssertionError(f"seq2seq_beam: ids {list(ids.shape)}")
    if not ((ids >= 0) & (ids < S2S_VOCAB)).all():
        raise AssertionError("seq2seq_beam: ids out of the vocabulary")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def seq2seq_small_f32(seed, dev):
    """(c) ``small_f32``: a ``Seq2Seq`` of 2 + 2 layers, d_model 128, 2
    heads of 64 (the kernels' head width), d_ff 256, 1000 tokens, in f32
    (TF32 off), dropout 0, the same weights on the card and the CPU (the
    end token's output bias raised by 1.5, so that beams end at
    different steps): logits of b4 x 24 source and 16 target tokens within
    relative L2 1e-4 of the CPU's; a beam search (4 sentences, beam 3, up
    to 12 steps) whose ids, parent ids and lengths equal the CPU's and
    whose scores are within 1e-4."""
    small = dict(dropout=0.0, d_model=128, nhead=2, layers=2, ff=256,
                 vocab=1000, max_len=64, tgt_len=16)
    cpu = Seq2Seq("cpu", seed, **small).eval()
    with torch.no_grad():
        cpu.out.bias[EOS] += 1.5
    card = Seq2Seq(dev, seed, **small).eval()
    card.load_state_dict(cpu.state_dict())
    src, tgt_in, _ = s2s_data(seed + 23, "cpu", 4, 24, 16, 1000)
    with torch.no_grad():
        rel = _rel_l2(card(src.to(dev), tgt_in.to(dev)), cpu(src, tgt_in))
        got = beam_decode(card, src.to(dev), 3, 12)
        want = beam_decode(cpu, src, 3, 12)
    same = {
        "ids": torch.equal(got[0].cpu(), want[0]),
        "parent_ids": len(got[3]) == len(want[3]) and all(
            torch.equal(a.parent_ids.cpu(), b.parent_ids)
            for a, b in zip(got[3], want[3])),
        "lengths": torch.equal(got[2].cpu(), want[2])}
    scores = max(float((a.scores.cpu() - b.scores).abs().max())
                 for a, b in zip(got[3], want[3]))
    rec = {"logits_rel_l2": rel, "beam_steps": len(want[3]),
           "beam_lengths": want[2].tolist(), "beam_equal": same,
           "beam_scores_max_abs_diff": scores}
    log("  seq2seq small_f32: " + json.dumps(rec))
    if not (rel <= 1e-4 and all(same.values()) and scores <= 1e-4):
        raise AssertionError(f"seq2seq small_f32: the card differs from "
                             f"the CPU: {rec}")
    return rec


def seq2seq_phase(seed, dev, card, kernels):
    """The ``seq2seq`` phase: (a) ``train``, (b) ``beam``, (c)
    ``small_f32`` ((d), the flash kernels at these shapes, ran with the
    kernel checks: ``time_seq2seq_shapes``).  Returns the record and the
    launches of the training step's timed steps."""
    rec = {"card": card}
    log(f"seq2seq (a) train: Transformer-base (d_model {S2S_D}, "
        f"{S2S_HEADS} heads, {S2S_LAYERS} + {S2S_LAYERS} layers, d_ff "
        f"{S2S_FF}, vocab {S2S_VOCAB}), b{S2S_B} x {S2S_SRC} + {S2S_TGT} "
        "tokens, Adam(1e-4, beta2 0.98, eps 1e-9), graphed TrainStep at O1")
    rec["train"], launches = seq2seq_train(seed, dev, kernels)
    log(f"seq2seq (b) beam: bf16, {BEAM_B} sentences x {S2S_SRC} tokens, "
        f"beam {BEAM_K}, up to {BEAM_STEPS} steps")
    rec["beam"], _beam_launches = seq2seq_beam(seed, dev, kernels)
    log("seq2seq (c) small_f32: 2 + 2 layers, d_model 128, card vs CPU")
    rec["small_f32"] = seq2seq_small_f32(seed, dev)
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


def serve_model(seed, dev):
    """llama_7b in bf16, weights drawn on the card from ``seed``, and the
    serve traffic: 7 prompts of 64-1024 tokens, a sharer of the first's
    256-token prefix, each pass's warm-up wave (the same lengths, other
    tokens, so it makes no prefix hit the measured wave would not make)
    and the 8 lengths."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_7b
    cfg = llama_7b()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             seed=seed)
    torch.cuda.synchronize()
    log(f"serve: llama_7b ({cfg.num_hidden_layers} layers) bf16, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params")
    rng = np.random.default_rng(seed)
    lengths = rng.integers(64, 1025, 8)
    lengths[0] = max(lengths[0], 300)     # holds the shared 256 prefix
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lengths[:7]]
    sharer = np.concatenate([prompts[0][:256], rng.integers(
        0, cfg.vocab_size, int(lengths[7]) - 256 if lengths[7] > 256
        else 64)]).astype(np.int32)
    warm = [rng.integers(0, cfg.vocab_size, len(p)).astype(np.int32)
            for p in prompts]
    warmup = (warm, np.concatenate([warm[0][:256], rng.integers(
        0, cfg.vocab_size, len(sharer) - 256)]).astype(np.int32))
    return model, prompts, sharer, warmup, lengths


# ------------------------------------------------------------- server
#: the journal fsync policies the server phase times a wave under
SERVER_POLICIES = ("os", "interval_ms", "always")
#: the crash check's traffic: a greedy and a sampled row (pinned seed)
CRASH_BODIES = ({}, {"do_sample": True, "temperature": 0.8, "seed": 11})
CRASH_NEW = 48


def warm_serve_buckets(eng, rows=(1, 2, 4, 8)):
    """Capture the ragged decode step's graphs (span 1) at every row
    bucket a wave of HTTP requests can reach, with the greedy and the
    drawing tail: arrival order decides the batches, so the warm-up wave
    alone may miss some.  Rows sit on scratch sequences, freed after."""
    for b in rows:
        for draw in (False, True):
            seqs = [f"__warm{i}" for i in range(b)]
            flags = np.zeros(b, bool)
            flags[0] = draw
            eng._decoder.ragged_step(
                eng.cache, seqs, [np.zeros(1, np.int32)] * b, [0] * b,
                sampling=(np.zeros(b, np.uint32),
                          np.full(b, 0.8, np.float32), flags))
            for sid in seqs:
                eng.cache.free(sid)
    torch.cuda.synchronize()


def _http(srv, method, path, body=None, timeout=600):
    """(status, JSON reply) of one request to ``srv`` (a server object or
    a port)."""
    import urllib.error
    import urllib.request
    port = srv if isinstance(srv, int) else srv.port
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_wave(srv, prompts, sharer, tag):
    """The serve pass's wave over HTTP: the prompts as concurrent one-row
    POSTs (the last two sampled at 0.8 with seeds 100 + i, as ``serve``
    submits them), then the sharer once the first request has a token
    (its prefix is then cached).  Returns the engine's request handles in
    order (caught at ``submit``), each POST's wall seconds, the replies'
    output ids and the wave's wall seconds."""
    eng = srv._engine
    handles = {}
    submit = eng.submit

    def catching(*a, **kw):
        r = submit(*a, **kw)
        handles[r.request_id] = r
        return r

    bodies = [dict({"input_ids": [p.tolist()], "max_new_tokens": 32,
                    "request_id": f"{tag}-{i}"},
                   **({"do_sample": True, "temperature": 0.8,
                       "seed": 100 + i} if i >= len(prompts) - 2 else {}))
              for i, p in enumerate(prompts)]
    bodies.append({"input_ids": [sharer.tolist()], "max_new_tokens": 32,
                   "request_id": f"{tag}-sharer"})
    walls = [None] * len(bodies)
    outs = [None] * len(bodies)

    def client(i):
        t0 = time.perf_counter()
        code, out = _http(srv, "POST", "/generate", bodies[i])
        walls[i] = time.perf_counter() - t0
        if code != 200:
            raise AssertionError(f"server {tag}: POST {i} got {code}: {out}")
        outs[i] = out["output_ids"][0]

    eng.submit = catching
    try:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            futs = [pool.submit(client, i) for i in range(len(prompts))]
            first = f"{tag}-0"
            while first not in handles or (
                    handles[first].first_token_at is None
                    and not handles[first].done.is_set()):
                time.sleep(0.002)
            futs.append(pool.submit(client, len(prompts)))
            for f in futs:
                f.result()
        wall = time.perf_counter() - t0
    finally:
        del eng.submit
    reqs = [handles[b["request_id"]] for b in bodies]
    return reqs, walls, outs, wall


def _journal_counts():
    from paddle_tpu_torch import monitor
    reg = monitor.get_registry()
    return (reg.get("journal_bytes").value(),
            reg.get("journal_records_total").value(),
            reg.get("journal_fsync_seconds").sum_count()[1])


def server_wave_record(srv, reqs, walls, outs, wall, before, captured,
                       replayed):
    stats = serve_stats(reqs, wall)
    w = sorted(walls)
    after = _journal_counts()
    new = sum(len(o) for o in outs) - sum(len(r.prompt) for r in reqs)
    return dict(stats, http_wall_p50_s=w[len(w) // 2],
                http_wall_p99_s=w[min(len(w) - 1,
                                      int(np.ceil(0.99 * len(w))) - 1)],
                tokens_per_s=new / wall,
                journal_bytes=after[0] - before[0],
                journal_records=after[1] - before[1],
                journal_fsyncs=after[2] - before[2],
                captures=srv._engine.captures - captured,
                replays=srv._engine.replays - replayed)


def server_7b(model, prompts, sharer, warmup, kernels, plain, seed, card,
              dev):
    """(a) ``GenerationServer`` in this process on the serve phase's bf16
    llama_7b, a journal in a temporary directory: the warm-up, the
    measured wave (the unchunked pass's requests, launch counters zeroed
    just before), then one wave of fresh tokens of the same lengths a
    journal fsync policy."""
    from paddle_tpu_torch.inference import GenerationServer
    plain_rec, plain_reqs = plain
    cfg = model.config
    rng = np.random.default_rng(seed + 25)

    def fresh():
        ps = [rng.integers(0, cfg.vocab_size, len(p)).astype(np.int32)
              for p in prompts]
        return ps, np.concatenate([ps[0][:256], rng.integers(
            0, cfg.vocab_size, len(sharer) - 256)]).astype(np.int32)

    rec, divergences = {"card": card}, []
    with tempfile.TemporaryDirectory() as jdir:
        srv = GenerationServer(model, total_pages=1024, page_size=16,
                               max_batch=8,
                               min_table_pages=SERVE_TABLE_PAGES,
                               journal_dir=jdir, device=dev).start()
        try:
            eng = srv._engine
            warm_serve_buckets(eng)
            http_wave(srv, *warmup, "warm")
            rec["captures_warmup"] = eng.captures
            for fn in kernels.values():
                fn.launches = 0
            captured, replayed = eng.captures, eng.replays
            before = _journal_counts()
            reqs, walls, outs, wall = http_wave(srv, prompts, sharer, "main")
            torch.cuda.synchronize()
            got = {n: fn.launches for n, fn in kernels.items()}
            main = server_wave_record(srv, reqs, walls, outs, wall, before,
                                      captured, replayed)
            main.update(launches=got, direct_ttft_p50_s=plain_rec["ttft_p50_s"],
                        direct_tpot_p50_s=plain_rec["tpot_p50_s"],
                        direct_decode_tok_s=plain_rec["decode_tok_s"])
            need = ("paged_attention", "flash_attention_forward", "rms_norm",
                    "apply_rope")
            missing = [n for n in need if not got[n]]
            if main["captures"] or missing:
                raise AssertionError(
                    f"server: the measured wave captured {main['captures']} "
                    f"graphs; kernels never launched: {missing}")
            for i, (r, o) in enumerate(zip(reqs, outs)):
                if r.error is not None or len(r.generated) != 32 \
                        or o != r.output_ids.tolist():
                    raise AssertionError(f"server: request {i} did not "
                                         f"complete over HTTP ({r.error})")
            if reqs[-1].prefix_tokens != 256:
                raise AssertionError(f"server: the sharer hit "
                                     f"{reqs[-1].prefix_tokens} cached "
                                     "tokens, expected 256")
            same = 0
            for i, (r, w) in enumerate(zip(reqs, plain_reqs)):
                at = first_divergence(r.generated, w.generated)
                if at is None:
                    same += 1
                    continue
                divergences.append(dict(
                    label="server", request=i, position=at,
                    ids=np.concatenate([w.prompt, np.asarray(
                        w.generated[:at], np.int32)]),
                    tokens=(int(w.generated[at]), int(r.generated[at]))))
            main["streams_equal_direct"] = same
            main["first_divergences"] = [
                {k: d[k] for k in ("request", "position")}
                for d in divergences]
            rec["main"] = main
            log("server main wave: " + json.dumps(main))
            rec["tpot_p50_s_by_fsync"] = {}
            for policy in SERVER_POLICIES:
                srv._journal.set_policy(policy)
                captured, replayed = eng.captures, eng.replays
                before = _journal_counts()
                w = server_wave_record(srv, *http_wave(srv, *fresh(), policy),
                                       before, captured, replayed)
                if w["captures"]:
                    raise AssertionError(f"server fsync={policy}: the wave "
                                         f"captured {w['captures']} graphs")
                rec[f"fsync_{policy}"] = w
                rec["tpot_p50_s_by_fsync"][policy] = w["tpot_p50_s"]
                log(f"server fsync={policy}: " + json.dumps(w))
            srv._journal.set_policy(srv._journal.fsync_policy)
            code, health = _http(srv, "GET", "/health")
            if code != 200 or health["journal"]["live_requests"] \
                    or health["free_pages"] != health["total_pages"]:
                raise AssertionError(f"server: /health {code} {health}")
            rec["health"] = {k: health[k] for k in (
                "status", "free_pages", "total_pages", "requests_total",
                "kv_pool_bytes", "tp", "mesh_shape", "journal")}
        finally:
            srv.stop()
    # the same wave on a server without a journal: what the journal costs
    # beside what the HTTP front door and arrival order cost
    del srv, eng
    gc.collect()
    torch.cuda.empty_cache()
    srv = GenerationServer(model, total_pages=1024, page_size=16,
                           max_batch=8, min_table_pages=SERVE_TABLE_PAGES,
                           device=dev).start()
    try:
        eng = srv._engine
        warm_serve_buckets(eng)
        http_wave(srv, *warmup, "warm_plain")
        captured, replayed = eng.captures, eng.replays
        w = server_wave_record(srv, *http_wave(srv, *fresh(), "no_journal"),
                               _journal_counts(), captured, replayed)
        if w["captures"] or w["journal_records"]:
            raise AssertionError(f"server without a journal: {w}")
        rec["no_journal"] = w
        log("server without a journal: " + json.dumps(w))
    finally:
        srv.stop()
    return rec, got, divergences


def server_small_f32(dev):
    """(b) the small f32 model: HTTP streams equal ``engine.generate``'s
    exactly, greedy rows of three lengths and a sampled row."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationServer)
    _, gpu = _small_models()
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (9, 40, 130)]
    new = 16
    with ContinuousBatchingEngine(gpu, total_pages=64, page_size=16,
                                  max_batch=4, device=dev) as eng:
        greedy = eng.generate(prompts, max_new_tokens=new)
        drawn = eng.generate([prompts[1]], max_new_tokens=new,
                             do_sample=True, temperature=0.8, seed=5)
    want = [greedy[i, :len(p) + new].tolist() for i, p in enumerate(prompts)]
    want.append(drawn[0].tolist())
    with GenerationServer(gpu, total_pages=64, page_size=16, max_batch=4,
                          device=dev) as srv:
        bodies = [{"input_ids": [p.tolist()], "max_new_tokens": new}
                  for p in prompts]
        bodies.append({"input_ids": [prompts[1].tolist()],
                       "max_new_tokens": new, "do_sample": True,
                       "temperature": 0.8, "seed": 5})
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            got = list(pool.map(
                lambda b: _http(srv, "POST", "/generate", b), bodies))
    got = [out["output_ids"][0] if code == 200 else (code, out)
           for code, out in got]
    if got != want:
        raise AssertionError(f"server small f32: HTTP streams {got} differ "
                             f"from engine.generate's {want}")
    log(f"server small f32: {len(want)} HTTP streams (3 greedy, 1 sampled) "
        "equal engine.generate's")
    return len(want)


def server_child(jdir, status, pace):
    """``--server-child``: a ``GenerationServer`` over the small f32 model
    on ``jdir`` (fsync ``always``), its decode steps paced by ``pace``
    seconds; writes ``status`` (port, restored requests, times) once it
    listens and ``status.first`` at the first token a restored request
    gains, then serves until killed."""
    t_start = time.time()
    from paddle_tpu_torch.inference import GenerationServer
    from paddle_tpu_torch.testing import faults
    _, gpu = _small_models()
    if pace:
        faults.install(faults.FaultPlan(
            [{"site": "decode_step", "kind": "delay", "delay_s": pace}]))
    srv = GenerationServer(gpu, total_pages=64, page_size=16, max_batch=4,
                           journal_dir=jdir, journal_fsync="always",
                           device="cuda")
    journaled = {e["request_id"]: len(e.get("generated") or ())
                 for e in srv._journal_entries}
    srv.start()

    def put(path, payload):
        with open(path + ".tmp", "w") as f:
            json.dump(payload, f)
        os.replace(path + ".tmp", path)

    put(status, {"port": srv.port, "restored": srv._restored_requests,
                 "journaled": journaled, "t_start": t_start,
                 "t_ready": time.time()})
    while journaled:
        for rid, n in journaled.items():
            res = srv._engine.result_for(rid) or {}
            if res.get("status") == "done" \
                    or res.get("generated_tokens", 0) > n:
                put(status + ".first", {"t_first": time.time(), "id": rid})
                journaled = {}
                break
        time.sleep(0.0005)
    while True:
        time.sleep(1)


def _wait_file(path, proc, timeout=240):
    end = time.monotonic() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise AssertionError(f"server child exited {proc.returncode} "
                                 f"before writing {path}")
        if time.monotonic() > end:
            raise AssertionError(f"server child wrote no {path}")
        time.sleep(0.01)
    with open(path) as f:
        return json.load(f)


def server_crash_check(card):
    """(c) SIGKILL a child-process server mid-decode and restart it on the
    same journal: the restart restores both requests and ``/result/<id>``
    gives an uninterrupted child's streams bit for bit."""
    here = os.path.abspath(__file__)
    procs = []
    rec = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        def spawn(name, jdir, pace=0.0):
            status = os.path.join(tmp, name + ".json")
            t0 = time.time()
            p = subprocess.Popen(
                [sys.executable, here, "--server-child", jdir, status,
                 str(pace)], stdout=subprocess.DEVNULL)
            procs.append(p)
            return p, status, t0

        try:
            jkill, jref = os.path.join(tmp, "killed"), os.path.join(tmp, "ref")
            a, a_status, _ = spawn("a", jkill, 0.03)
            u, u_status, _ = spawn("u", jref)
            pa = _wait_file(a_status, a)["port"]
            pu = _wait_file(u_status, u)["port"]
            rng = np.random.default_rng(26)
            prompts = [rng.integers(0, 512, n).astype(np.int32)
                       for n in (40, 130)]
            ids = [f"crash-{i}" for i in range(len(prompts))]
            bodies = [dict({"input_ids": [p.tolist()],
                            "max_new_tokens": CRASH_NEW,
                            "request_id": rid}, **kw)
                      for p, rid, kw in zip(prompts, ids, CRASH_BODIES)]
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(2) as pool:
                ref = list(pool.map(lambda b: _http(pu, "POST", "/generate",
                                                    b), bodies))
            # a fresh process's first wave: its graphs are captured then
            rec["uninterrupted_first_wave_s"] = time.perf_counter() - t0
            if any(code != 200 for code, _ in ref):
                raise AssertionError(f"server crash: the uninterrupted "
                                     f"child answered {ref}")
            ref = [out["output_ids"][0] for _, out in ref]
            u.kill()
            killed_clients = concurrent.futures.ThreadPoolExecutor(2)
            for b in bodies:
                killed_clients.submit(_http, pa, "POST", "/generate", b, 60)
            seen = {}
            end = time.monotonic() + 120
            while not (len(seen) == 2 and min(seen.values()) >= 8):
                if time.monotonic() > end:
                    raise AssertionError(f"server crash: rows never reached "
                                         f"mid-decode: {seen}")
                for rid in ids:
                    code, res = _http(pa, "GET", f"/result/{rid}")
                    if code == 202:
                        seen[rid] = res["generated_tokens"]
                time.sleep(0.005)
            a.kill()                    # SIGKILL mid-decode
            a.wait()
            killed_clients.shutdown(wait=True)
            rec["generated_at_kill"] = [seen[r] for r in ids]
            b_proc, b_status, t_spawn = spawn("b", jkill)
            st = _wait_file(b_status, b_proc)
            first = _wait_file(b_status + ".first", b_proc)
            done = {}
            end = time.monotonic() + 120
            while len(done) < len(ids):
                if time.monotonic() > end:
                    raise AssertionError("server crash: the restarted child "
                                         "did not finish the requests")
                for rid in ids:
                    code, res = _http(st["port"], "GET", f"/result/{rid}")
                    if code == 200:
                        done[rid] = res
                time.sleep(0.01)
            code, health = _http(st["port"], "GET", "/health")
            got = [done[rid].get("output_ids") for rid in ids]
            rec.update(
                restored_requests=health["restored_requests"],
                journaled_generated=[st["journaled"].get(r) for r in ids],
                restart_to_listening_s=st["t_ready"] - t_spawn,
                restart_to_first_restored_token_s=first["t_first"] - t_spawn,
                restore_to_first_token_s=first["t_first"] - st["t_ready"],
                streams_equal_uninterrupted=sum(
                    g == r for g, r in zip(got, ref)),
                journal=health["journal"])
            log("server crash: " + json.dumps(rec))
            if health["restored_requests"] != len(ids) or got != ref:
                raise AssertionError(
                    f"server crash: restored {health['restored_requests']} "
                    f"of {len(ids)}; streams equal the uninterrupted "
                    f"child's: {[g == r for g, r in zip(got, ref)]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    return rec


def server_phase(model, prompts, sharer, warmup, kernels, plain, seed, card,
                 dev):
    """The HTTP front door: (a) the 7B server, (b) small f32 HTTP vs
    ``engine.generate``, (c) SIGKILL and restart on the journal."""
    rec, launches, divergences = server_7b(model, prompts, sharer, warmup,
                                           kernels, plain, seed, card, dev)
    rec["small_f32_streams_equal"] = server_small_f32(dev)
    rec["crash"] = server_crash_check(card)
    return rec, launches, divergences


def server_only(seed, dev, card):
    """``--only server``: the unchunked serve pass (the direct run the
    server is held against) and the server phase."""
    model, prompts, sharer, warmup, _ = serve_model(seed, dev)
    kernels = counters()
    reqs, wall, info = serve(model, prompts, sharer, None, dev,
                             warmup=warmup, kernels=kernels)
    plain = dict(serve_stats(reqs, wall), card=card, **info)
    log("serve unchunked: " + json.dumps(plain))
    rec, _, divergences = server_phase(model, prompts, sharer, warmup,
                                       kernels, (plain, reqs), seed, card,
                                       dev)
    del reqs
    gc.collect()
    model.float()
    rec["main"]["bf16_divergence_gaps"] = top2_gaps(model, divergences)
    return rec


def tp_gaps(model, rec, divergences):
    """The tp phase's bf16 divergences from tp=1, with the top-2 logit gap
    of a plain f32 forward there (``model`` in f32 by now)."""
    for backend, divs in divergences.items():
        rec["bf16"][backend]["bf16_divergence_gaps"] = top2_gaps(model, divs)
        log(f"tp {backend}: bf16 divergences of tp=2 from the tp=1 streams, "
            "top-2 logit gap of a plain f32 forward there: "
            + json.dumps(rec["bf16"][backend]["bf16_divergence_gaps"]))


def tp_only(seed, dev, card):
    """``--only tp``: the unchunked serve pass (the tp phase's tp=1
    baseline) and the tp phase alone, for a machine with two cards or
    more, where both of its checks run over NCCL too."""
    model, prompts, sharer, warmup, _ = serve_model(seed, dev)
    kernels = counters()
    reqs, wall, info = serve(model, prompts, sharer, None, dev,
                             warmup=warmup, kernels=kernels)
    plain = dict(serve_stats(reqs, wall), card=card, **info)
    log("serve unchunked: " + json.dumps(plain))
    rec, _, divergences = tp_phase(model, prompts, sharer, warmup, kernels,
                                   (plain, reqs), seed, card, dev)
    del reqs
    gc.collect()
    model.float()
    tp_gaps(model, rec, divergences)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("tp", "train_paths", "fit",
                                       "vision", "seq2seq", "server"),
                    help="after the build, run only the unchunked serve "
                    "pass and the tp phase (over NCCL too on two cards), "
                    "or only the flash backward check and the train and "
                    "train_paths phases, or only the flash kernels at "
                    "BERT's shapes and the fit phase, or only the vision "
                    "phase, or only the flash kernels at the "
                    "Transformer's shapes and the seq2seq phase, or only "
                    "the unchunked serve pass and the server phase")
    ap.add_argument("--server-child", nargs=3,
                    metavar=("JOURNAL_DIR", "STATUS", "PACE_S"),
                    help=argparse.SUPPRESS)
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
    if args.server_child:
        # the server phase's child process (its crash check)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        jdir, status, pace = args.server_child
        server_child(jdir, status, float(pace))
        return 0
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
    checks = (check_paged, check_quant, check_flash, check_flash_bwd,
              time_train_shapes, check_moe_gating, check_flashmask)
    if args.only == "train_paths":
        checks = (check_flash_bwd,)
    if args.only == "fit":
        checks = ()
    if args.only == "server":
        server_rec = server_only(args.seed, dev, smi[0])
        lap("server")
        phase_s["total"] = time.perf_counter() - T_START
        print(json.dumps({"server": server_rec, "phase_s": {
            k: round(v, 2) for k, v in phase_s.items()}}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "vision":
        vision_rec = vision_phase(args.seed, dev, smi[0])
        lap("vision")
        phase_s["total"] = time.perf_counter() - T_START
        print(json.dumps({"vision": vision_rec, "phase_s": {
            k: round(v, 2) for k, v in phase_s.items()}}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    shapes = (time_bert_shapes, time_seq2seq_shapes)
    if args.only in ("train_paths", "fit"):
        shapes = (time_bert_shapes,)
    if args.only == "seq2seq":
        checks, shapes = (), (time_seq2seq_shapes,)
    for fn in checks + shapes:
        fn(records, dev)
        lap(fn.__name__)
    if args.only == "seq2seq":
        s2s_rec, _launches = seq2seq_phase(args.seed, dev, smi[0],
                                           counters())
        lap("seq2seq")
        phase_s["total"] = time.perf_counter() - T_START
        print(json.dumps({"seq2seq": s2s_rec, "seq2seq_shapes": {
            n: {t: r for t, r in records[n].items()
                if t.startswith("seq2seq")}
            for n in ("flash_attention_forward", "flash_attention_bwd_dkv",
                      "flash_attention_bwd_dq")},
            "phase_s": {k: round(v, 2) for k, v in phase_s.items()}}),
            flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "fit":
        fit_rec, _launches = fit_phase(args.seed, dev, smi[0], counters())
        lap("fit")
        phase_s["total"] = time.perf_counter() - T_START
        print(json.dumps({"fit": fit_rec, "bert_shapes": {
            n: {t: records[n][t] for t in ("bert_bf16", "bert_f32")}
            for n in ("flash_attention_forward", "flash_attention_bwd_dkv",
                      "flash_attention_bwd_dq")},
            "phase_s": {k: round(v, 2) for k, v in phase_s.items()}}),
            flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.only == "train_paths":
        train_rec, _launches = train(args.seed, dev, smi[0])
        log("train: " + json.dumps(train_rec))
        lap("train")
        paths_rec, _launches = train_paths(args.seed, dev, smi[0],
                                           train_rec)
        lap("train_paths")
        phase_s["total"] = time.perf_counter() - T_START
        print(json.dumps({"train_paths": paths_rec, "flash_bwd": {
            n: records[n] for n in ("flash_attention_bwd_dkv",
                                    "flash_attention_bwd_dq")},
            "phase_s": {k: round(v, 2) for k, v in phase_s.items()}}),
            flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
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
    if args.only == "tp":
        tp_rec = tp_only(args.seed, dev, smi[0])
        lap("tp")
        phase_s["total"] = time.perf_counter() - T_START
        print(json.dumps({"tp": tp_rec, "phase_s": {
            k: round(v, 2) for k, v in phase_s.items()}}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

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
    check_small_recovery()
    lap("check_small_recovery")
    check_small_overload()
    lap("check_small_overload")
    check_small_train()
    lap("check_small_train")
    check_small_moe()
    lap("check_small_moe")

    # 4. llama_7b serving
    model, prompts, sharer, warmup, lengths = serve_model(args.seed, dev)
    cfg = model.config
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
    lap("speculative")
    # crash recovery over the same traffic, against the unchunked pass
    recovery_rec, recovery_div = recovery_phase(
        model, prompts, sharer, warmup, kernels,
        (passes["unchunked"], unchunked_reqs), smi[0])
    lap("recovery")
    # tensor parallelism, tp=2 on the one card, against tp=1
    tp_rec, tp_launches, tp_div = tp_phase(
        model, prompts, sharer, warmup, kernels,
        (passes["unchunked"], unchunked_reqs), args.seed, smi[0], dev)
    launches.update(tp_launches)
    lap("tp")
    # the HTTP front door on the same model and traffic, its journal, and
    # a child-process server killed and restarted on its journal
    server_rec, launches["server"], server_div = server_phase(
        model, prompts, sharer, warmup, kernels,
        (passes["unchunked"], unchunked_reqs), args.seed, smi[0], dev)
    del unchunked_reqs
    lap("server")
    # the overload controls over the classes traffic
    overload_rec, overload_launches = overload_phase(
        model, args.seed, classes_rec["classes"]["tpot_p50_s"]["interactive"],
        kernels, smi[0])
    launches.update(overload_launches)
    lap("overload")

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
    recovery_rec["bf16_divergence_gaps"] = top2_gaps(model, recovery_div)
    log("recovery: bf16 divergences from the fault-free streams, top-2 "
        "logit gap of a plain f32 forward there: "
        + json.dumps(recovery_rec["bf16_divergence_gaps"]))
    tp_gaps(model, tp_rec, tp_div)
    server_rec["main"]["bf16_divergence_gaps"] = top2_gaps(model, server_div)
    log("server: bf16 divergences from the direct run's streams, top-2 "
        "logit gap of a plain f32 forward there: "
        + json.dumps(server_rec["main"]["bf16_divergence_gaps"]))
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
    # the rest of training: the fused loss, amp O1 and O2, MoE training
    paths_rec, paths_launches = train_paths(args.seed, dev, smi[0],
                                            train_rec)
    launches.update(paths_launches)
    lap("train_paths")
    # the fit path: the DataLoader's device stage, BERT-base through
    # Model.fit and the O1 TrainStep, ZeRO offload
    fit_rec, fit_launches = fit_phase(args.seed, dev, smi[0], counters())
    launches.update(fit_launches)
    lap("fit")
    # the vision and OCR training paths: bench.py's configs 1, 4 (one
    # card) and 3 through the graphed TrainStep, then card vs CPU
    vision_rec = vision_phase(args.seed, dev, smi[0])
    lap("vision")
    # the Transformer encoder-decoder: Transformer-base training through
    # the graphed TrainStep, beam search over its caches, card vs CPU
    s2s_rec, launches["seq2seq"] = seq2seq_phase(args.seed, dev, smi[0],
                                                 counters())
    lap("seq2seq")

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
        "mfu", "peak_memory_gb", "peak_over_start_gb", "captures_warmup",
        "captures", "replays",
        "graph_pool_bytes", "launches_per_step", "loss_first", "loss_last",
        "first_5_losses_equal_eager")}
    train_line["eager"] = {k: train_rec["eager"][k] for k in (
        "step_ms_p50", "device_busy_ms_per_step", "device_idle_share")}
    train_line["run_steps"] = {
        m: {k: r[k] for k in ("tokens_per_s", "mfu", "step_ms",
                              "equal_to_single_calls")}
        for m, r in train_rec["run_steps"].items()}
    paths_line = {"card": paths_rec["card"], "amp_o2": {
        k: paths_rec["amp_o2"][k] for k in ("weights_equal_bf16_trainer",
                                            "losses_equal_train")}}
    for p in ("fused_ce", "amp_o1", "moe"):
        paths_line[p] = {k: paths_rec[p][k] for k in (
            "step_ms_p25", "step_ms_p50", "step_ms_p75", "tokens_per_s",
            "mfu", "peak_memory_gb", "peak_over_start_gb",
            "device_idle_share", "captures",
            "replays", "launches_per_step", "first_5_losses_equal_eager")}
    paths_line["fused_ce"]["head_products"] = \
        paths_rec["fused_ce"]["head_products"]
    fit_line = {"card": fit_rec["card"], "loader": fit_rec["loader"],
                "offload": fit_rec["offload"],
                "offload_moe": fit_rec["offload_moe"]}
    fit_line["bert_fit"] = {k: v for k, v in fit_rec["bert_fit"].items()
                            if k != "launches_per_step"}
    fit_line["bert_o1"] = {k: fit_rec["bert_o1"][k] for k in (
        "step_ms_p25", "step_ms_p50", "step_ms_p75", "tokens_per_s", "mfu",
        "peak_memory_gb", "device_idle_share", "captures", "replays",
        "launches_per_step", "first_5_losses_equal_eager", "dropout_0.1")}
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
                      "train": train_line, "train_paths": paths_line,
                      "fit": fit_line,
                      "vision": vision_rec,
                      "seq2seq": s2s_rec,
                      "moe": moe_line,
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
                      "recovery": {p: {k: v for k, v in r.items()
                                       if k not in ("launches",
                                                    "wave_launches")}
                                   if isinstance(r, dict) else r
                                   for p, r in recovery_rec.items()},
                      "classes": {p: {k: r[k] for k in (
                          "ttft_p50_s", "tpot_p50_s", "wall_s", "counts",
                          "captures_warmup", "captures", "replays",
                          "dispatches", "ragged_ms_by_bucket")}
                          for p, r in classes_rec.items()},
                      "overload": overload_rec,
                      "tp": tp_rec,
                      "server": server_rec,
                      "phase_s": {k: round(v, 2) for k, v in phase_s.items()}}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
