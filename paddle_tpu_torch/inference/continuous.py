"""Continuous batching over the paged-KV pool (port of the core of
paddle_tpu/inference/continuous.py).

Requests enqueue in the workload scheduler (``scheduler.py``: per-class,
per-tenant bounded queues, weighted deficit round-robin); a scheduler
thread admits them whenever a running slot and enough pool pages are
free.  Admission reserves each sequence's worst-case pages (prompt +
max_new_tokens, plus the pad-row headroom), so a step can never run out
of pages mid-flight, and maps any cached prompt prefix read-only.  With
one class and one tenant the admission order is FIFO.  When every slot
is held and a more urgent class waits, a preemptible request (the
``batch`` class by default) is paused, mid-prefill or, with
``decode_preempt``, mid-decode: it keeps its seq id, pages and
reservation, and resumes where it stopped when a slot frees; it is never
prefilled again.  Each iteration runs one of two compositions:

  * unified (``unified_step=True``, the default): whole prompts prefill
    through the length-bucketed prefill (or, on a prefix hit, the
    prefix) step when ``prefill_chunk_tokens`` is None, otherwise the
    planned prompt chunks (most urgent class first, under the chunk
    budget) ride the ragged step; then ONE ragged step
    (``PagedDecoder.ragged_step``) runs the chunks and every active row;
  * legacy (``unified_step=False``): one prefill or chunk-prefill
    dispatch a planned chunk, then ONE decode step
    (``PagedDecoder.step``) for every active row, the batch padded to a
    power of two with rows on a scratch sequence;

and retires finished sequences (pages freed, waiter woken).

Lifecycle, as in the JAX engine: a request may carry a total TTL
(``ttl_s``) and a queue-wait deadline (``queue_timeout_s``); the loop
reaps expired and cancelled requests between steps (queued, mid-prefill,
paused or decoding), reclaims their pages and reservations, and their
waiters get :class:`DeadlineExceeded` or :class:`RequestCancelled`.
``preempt_resume_ttl_s`` bounds how long a paused request may hold its
reservation (an aging boost at half of it, reaped past it).  A full
class queue raises :class:`EngineSaturated`; ``drain`` stops admissions
(:class:`EngineDraining`), lets every submitted request finish (or fails
the queued ones with ``reject_queued``) and stops the thread.  A
finished request's outcome stays in a bounded result cache
(``result_for(request_id)``, ``result_cache_size`` entries).

Overload controls, as in the JAX engine:

  * SLO-aware admission: an arrival of a class with ``deadline_s`` sheds
    on arrival (:class:`EngineSaturated` with ``retry_after_s``) when the
    projected queue wait, the class's depth x the p50 of the
    process-wide ``decode_step_seconds`` histogram, already exceeds the
    budget; ``retry_after_hint(priority)`` gives a client the same
    truthful wait;
  * the brownout ladder (``brownout_thresholds``, four ascending
    queue-pressure ratios; off by default): pressure is the larger of
    the queue's fill and the most urgent budgeted class's attainment
    deficit; rung L sheds the L least urgent rank bands on arrival (rung
    3 and up everything but the top band, with its deadline halved);
    rungs climb at once and come down after ``brownout_patience`` calm
    iterations, and an idle engine drops to rung 0.  Rung 4 sheds as
    rung 3 does and flips the journal's fsync policy to ``"os"``
    (coming down restores the configured one);
  * the TPOT trigger: at full occupancy, when the loop's measured
    iteration time (an EWMA over iterations with active rows) exceeds an
    active row's ``tpot_budget_s``, the least urgent preemptible
    decoding row is paused (at most once a ``tpot_preempt_cooldown_s``)
    and stays parked while the breach lasts.

Telemetry, as in the JAX engine: the engine feeds the JAX package's
process-wide series (``paddle_tpu_torch.monitor``: queue depth, batch
occupancy, decode-step and prefill seconds, TTFT, generated tokens, the
prefix cache, failure isolation, speculation, recovery, quantized
serving, ``engine_dispatches_total{mode}``, decode preemptions and the
brownout ladder) under their names, beside the plain counters it keeps
an engine (``dispatches``, ``quarantined``, ...); inside a
``monitor.start_capture()`` window every request's lifecycle and every
step land on the tracer, and outside one each probe is an attribute
read.

Speculative decoding, as in the JAX engine: with ``draft_model`` the
draft proposes ``spec_tokens`` greedy tokens a greedy active row in ONE
``multi_step`` over its own PagedKVCache (pages allocated and freed in
lockstep with the target's), and the target scores each row's
``spec_tokens + 1`` tokens in one step: as verify rows of the ragged
step (unified) or one ``verify`` step (legacy), the accept counts and
the bonus token computed on the device.  Greedy speculation is exact:
the streams are target-only greedy whatever the draft proposes; sampled
and opted-out rows ride along with drafts of -1, which never match, and
advance one token with the draw they would make in a plain step.  A
rejected suffix rolls back by truncating both caches (the pages stay
mapped inside the admission reservation).  A draft-side failure (its
prefill or its proposal) downgrades the affected requests to plain
decode for the rest of their life, with their draft pages released at
once: speculation is an optimization and never fails a request.

Failures are isolated per request, as in the JAX engine: a failing
prefill or chunk quarantines its own request; a failing decode step is
retried once, then bisected down to the rows that fail alone, which are
quarantined.  A ragged step that fails on an injected fault
(``FaultError``) is rolled back and the same iteration re-run through
the legacy composition, and after 3 such failures in a row the unified
path is latched off.  Any other ragged failure is not re-run: the JAX
engine re-runs every failure, but here the legacy composition takes
other code (dense attention for continuation chunks), which would hide
a broken ragged kernel, so the requests of the failed step are
quarantined with its error and the queue is served on.  A quarantined
request's waiter gets the error, its pages are reclaimed, and everyone
else is served on.  Only a fault outside any step (admission, planning)
reaches ``_fail_all``.  The fault-injection sites (``testing.faults``)
``prefill``, ``prefill_chunk``, ``decode_step`` and ``engine_wedge``
fire here, ``buffer_loss`` in every decoder step; an iteration under a
plan that targets an engine site diverts to the legacy composition,
whose dispatch granularity defines the blast radius.

Crash recovery, as in the JAX engine:

  * one replay primitive (``_replay_kv``): a sequence's KV is rebuilt by
    re-ingesting ``prompt + generated`` up to its cached length through
    the prompt-ingest steps, into the pages it already maps; draws are
    keyed by (seed, absolute position) and the pending ``next_token`` is
    host state, so a stream continues token for token;
  * after a lost pool (the ``buffer_loss`` site zeroes both pools in
    place: ``PagedKVCache.generation`` bumps) every failed step or chunk
    is followed by ``_after_step_failure``: every survivor (decoding,
    mid-prefill, paused; the draft pool to its own length) is replayed,
    batched (``replay_batch``: rounds of up to ``max_batch`` rows through
    ``batch_context_prefill``) or a row at a time, prefix entries are
    re-registered, and only then is the step retried or bisected; a row
    whose own replay fails is quarantined alone;
  * the step watchdog (``step_timeout_s``): every dispatch brackets a
    heartbeat the watchdog (``distributed.watchdog``) scans; a step past
    the timeout is flagged as wedged, and when it returns the engine
    rolls it back, zeroes the pools, replays the survivors and retries.
    A step that never returns cannot be interrupted from the host: the
    flag is read only once the call comes back.  On a card a bucket's
    first call captures its CUDA graph inside the window, so a capture
    that outlasts the timeout is flagged like any slow step;
  * ``snapshot`` quiesces at a step boundary and serializes every live
    request (the JAX engine's entry format, ``"version": 1``), and
    ``restore`` resubmits each entry, whose prefill then ingests
    ``prompt + generated`` (``_Request.prefill_target``) and keeps the
    journaled next token.

A real CUDA fault (an illegal address, a device-side assert) leaves the
process's CUDA context unusable, so the in-process recovery is reached
by injected faults only; a process that crashes resumes its streams
through ``snapshot``/``restore`` in a new process.
"""
from __future__ import annotations

import math
import threading
import time
import uuid
import warnings
from collections import OrderedDict, deque, namedtuple
from typing import List, Optional

import numpy as np
import torch

from .. import monitor
from .._device import resolve_device
from ..distributed.tensor_parallel import TensorParallelGroup
from ..distributed.watchdog import CommTaskManager
from ..monitor.trace import get_tracer as _get_tracer
from ..ops.paged_attention import PagedKVCache
from ..testing import faults as _faults
from . import journal as _journal_mod
from .paged import (GraphedPagedDecoder, PagedDecoder, _tp_plan, next_pow2,
                    sample_token)
from .scheduler import DEFAULT_CLASS, QueueFull, WorkloadScheduler

_PAD_SEQ = "__pad__"

# recovery times the engine keeps (``recovery_s``), newest last
_RECOVERY_HISTORY = 256

# fault-injection sites whose quarantine semantics are defined against
# the legacy per-mode dispatch granularity (one poisoned chunk fails one
# request, a decode fault bisects the batch, a lost pool or a wedge is
# recovered step by step): an iteration running under a plan that
# targets any of them diverts to the legacy composition
_ENGINE_FAULT_SITES = frozenset((
    "prefill", "prefill_chunk", "decode_step", "engine_wedge",
    "buffer_loss", "page_alloc"))
# except pacing: a delay-kind rule on a dispatch site injects no failure,
# and the unified step fires these sites itself (same sleep, same seq_id
# targeting)
_PACING_FAULT_SITES = frozenset(("prefill", "prefill_chunk",
                                 "decode_step"))

#: one request's share of a speculative step: the bonus token (its id,
#: or the logits row), the accept count computed on the device, and the
#: drafts the host proposed (so accepted tokens need no second read back)
_SpecRow = namedtuple("_SpecRow", ("out", "accept", "drafts"))


def _null_sampling(n: int = 1):
    """Sampling arguments for ``n`` rows that draw nothing: the
    argmax-only tail for a dispatch whose token is discarded (the
    draft's prompt ingestion, KV replay)."""
    return (np.zeros(n, np.uint32), np.zeros(n, np.int32),
            np.ones(n, np.float32), np.zeros(n, bool))


class EngineSaturated(RuntimeError):
    """The bounded admission queue of the request's class is full, or the
    overload controls shed the arrival; retryable later.
    ``priority_class`` names the class; ``retry_after_s`` is the shed's
    truthful wait in seconds (None for a full queue)."""

    priority_class: Optional[str] = None
    retry_after_s: Optional[int] = None


class EngineDraining(RuntimeError):
    """The engine is draining for graceful shutdown and accepts no new
    submissions (in-flight requests still complete)."""


class DeadlineExceeded(RuntimeError):
    """The request's queue-wait deadline, total TTL or resume TTL expired
    before completion; its pages and reservation were reclaimed."""


class RequestCancelled(RuntimeError):
    """The request was cooperatively cancelled via ``cancel()``."""


class _EngineWedged(RuntimeError):
    """The watchdog flagged the step in flight as wedged (its heartbeat
    aged past ``step_timeout_s``).  The step's results are suspect: the
    engine rolls it back, zeroes the pools, replays the survivors and
    retries, and the retry and bisection ladder bounds a wedge that
    persists."""


# engine telemetry: the JAX engine's series, names and help texts
_queue_depth = monitor.gauge(
    "inference_queue_depth", "sequences waiting for admission")
_active_seqs = monitor.gauge(
    "inference_active_sequences", "sequences in the running decode batch")
_batch_occupancy = monitor.histogram(
    "inference_batch_occupancy", "active/max_batch fraction per decode "
    "step", buckets=tuple(i / 8 for i in range(1, 9)))
_decode_step_s = monitor.histogram(
    "decode_step_seconds", "one continuous-batching decode step")
_prefill_s = monitor.histogram(
    "prefill_seconds", "one sequence's prefill")
_tokens_total = monitor.counter(
    "generated_tokens_total", "tokens produced by the decode loop")
_ttft_s = monitor.histogram(
    "time_to_first_token_seconds", "submit -> first sampled token")
_gen_latency_s = monitor.histogram(
    "generate_latency_seconds", "submit -> sequence retirement")
# prefix-cache effectiveness and the on-device-sampling flag
_prefix_lookups = monitor.counter(
    "prefix_cache_lookups_total", "admissions that consulted the prefix "
    "cache")
_prefix_hits = monitor.counter(
    "prefix_cache_hits_total", "admissions whose prompt shared a cached "
    "page-aligned prefix")
_prefix_hit_tokens = monitor.counter(
    "prefix_cache_hit_tokens_total", "prompt tokens served from cached "
    "prefix pages instead of being re-prefilled")
_sampling_on_device_g = monitor.gauge(
    "sampling_on_device", "1 when the engine samples inside the compiled "
    "step (host transfer is (batch,) ids), 0 on the host-logits path")
# failure isolation, the lifecycle and the serving heartbeat
_decode_retries = monitor.counter(
    "decode_retries_total", "decode-step re-executions after a failure "
    "(one whole-batch retry, then one per bisection probe)")
_quarantined = monitor.counter(
    "quarantined_requests_total", "requests ejected by failure "
    "isolation: failed prefill, or poisoned sequence identified by "
    "decode-step bisection")
_expired_total = monitor.counter(
    "requests_expired_total", "requests retired by deadline expiry "
    "(queue-wait or total TTL)")
_cancelled_total = monitor.counter(
    "requests_cancelled_total", "requests retired by cooperative "
    "cancel()")
_saturated_total = monitor.counter(
    "engine_saturated_total", "submissions rejected because the bounded "
    "admission queue was full")
_last_step_ts = monitor.gauge(
    "engine_last_step_timestamp_seconds", "unix time the engine last "
    "completed a prefill or decode step — the serving heartbeat")
_draining_g = monitor.gauge(
    "engine_draining", "1 while the engine is draining for graceful "
    "shutdown, else 0")
_drain_rejected = monitor.counter(
    "drain_rejected_requests_total", "queued-but-unadmitted requests "
    "failed fast by drain(reject_queued=True)")
# speculative decoding: acceptance economics and the draft pool
_spec_proposed = monitor.counter(
    "spec_proposed_tokens_total", "draft tokens proposed to the "
    "compiled verify step")
_spec_accepted = monitor.counter(
    "spec_accepted_tokens_total", "proposed draft tokens the target "
    "verified and accepted")
_spec_accept_len = monitor.histogram(
    "spec_accept_len", "accepted draft tokens per sequence per verify "
    "step", buckets=tuple(float(i) for i in range(9)) + (12.0, 16.0,
                                                        24.0, 32.0))
_spec_rollback = monitor.counter(
    "spec_rollback_total", "per-sequence verify outcomes that rejected "
    "a draft suffix (partial multi-token rollback on both caches)")
_spec_draft_pages = monitor.gauge(
    "spec_draft_pages", "pages pinned in the draft model's KV pool — "
    "the speculative mode's capacity cost")
_spec_draft_failures = monitor.counter(
    "spec_draft_failures_total", "draft-side prefill/propose failures "
    "that downgraded requests to plain decode")
# crash recovery: replays, rebuilds and the MTTR histogram
_survivor_replays = monitor.counter(
    "survivor_replays_total", "sequences whose KV was reconstructed by "
    "replay (re-prefill of prompt + generated-so-far) after a "
    "donated-buffer loss or watchdog-driven rebuild")
_rebuilds_total = monitor.counter(
    "engine_rebuilds_total", "pool-rebuild recovery events the engine "
    "absorbed: device-side donated-buffer losses plus watchdog-flagged "
    "wedged steps")
_recovery_s = monitor.histogram(
    "engine_recovery_seconds", "one recovery event end to end: pool "
    "rebuild + every survivor's KV replay (the serving MTTR)")
_snapshot_reqs = monitor.counter(
    "snapshot_requests_total", "in-flight requests serialized by "
    "engine.snapshot()")
# quantized serving
_quant_enabled_g = monitor.gauge(
    "quant_enabled", "1 when the engine's compiled programs run "
    "quantized weights (w8/w8a8), else 0")
_kv_quant_enabled_g = monitor.gauge(
    "kv_quant_enabled", "1 when the PagedKVCache stores int8 pages "
    "with per-slot scale pools, else 0")
_kv_quant_pool_bytes_g = monitor.gauge(
    "kv_quant_pool_bytes", "resident bytes of the KV data pages "
    "(int8 mode stores a quarter of f32 / half of bf16)")
_kv_quant_scale_bytes_g = monitor.gauge(
    "kv_quant_scale_bytes", "resident bytes of the int8 mode's "
    "per-slot scale pools (0 at full precision)")
_replay_dispatches = monitor.counter(
    "replay_dispatches_total", "compiled dispatches issued by survivor-"
    "KV replay (batched replay amortizes many survivors per dispatch)")
# dispatch economics: the unified step folds prefill, chunk, decode and
# verify rows into one "ragged" dispatch
_dispatches_total = monitor.counter(
    "engine_dispatches_total", "compiled program dispatches issued by "
    "the serving loop, per program mode — 'ragged' is the unified "
    "single-dispatch step; 'prefill'/'chunk'/'decode'/'verify' are the "
    "legacy composition; 'draft' is the draft model's own propose/"
    "ingest dispatches (a second model: never foldable)", ("mode",))
_unified_fallbacks = monitor.counter(
    "engine_unified_fallbacks_total", "iterations where the unified "
    "ragged dispatch failed and the engine re-ran the step through the "
    "legacy multi-dispatch composition (whose retry/bisect isolation "
    "then owns the failure)")
# the overload controller's own series, materialized at import
_decode_preempt_total = monitor.counter(
    "decode_preemptions_total", "decoding rows paused mid-decode "
    "(pages kept, next token still pending host-side) so an urgent "
    "waiter could take the slot or an interactive row could get back "
    "inside its TPOT budget; the row resumes bit-exactly through the "
    "preempt/resume path")
_brownout_level_g = monitor.gauge(
    "engine_brownout_level", "degradation ladder rung: 0 normal, "
    "1 shed least-urgent class, 2 shed two least-urgent classes, "
    "3 interactive-only (tightened deadline checks), 4 journal "
    "fsync flipped to 'os'")
_brownout_transitions = monitor.counter(
    "engine_brownout_transitions_total", "brownout ladder rung "
    "changes (escalations are immediate, de-escalations are damped "
    "by the hysteresis patience)")
_decode_preempt_total.inc(0)
_brownout_level_g.set(0)
_brownout_transitions.inc(0)

# the process-wide trace buffer: off outside a monitor.start_capture()
# window, when every probe below is one attribute read
_tracer = _get_tracer()


def _note_quarantine(req) -> None:
    """Count a quarantine in the process-wide series and stamp it on the
    request's timeline: one helper, so the two cannot drift across the
    ejection sites."""
    _quarantined.inc()
    _tracer.request_event(
        getattr(req, "request_id", None), "quarantine",
        error=(type(req.error).__name__ if req.error is not None
               else None))


def _decode_p50_seconds() -> Optional[float]:
    """p50 of the process-wide ``decode_step_seconds`` histogram (the
    upper bound of the bucket holding the median, as Prometheus reads
    it), or None before anything decoded."""
    counts = _decode_step_s.cumulative_counts()
    total = counts[-1]
    if total <= 0:
        return None
    rank = 0.5 * total
    for bound, cum in zip(_decode_step_s.buckets, counts):
        if cum >= rank:
            return bound
    return _decode_step_s.buckets[-1]


def retry_after_seconds(queue_depth: int,
                        decode_p50_s: Optional[float]) -> int:
    """Retry-After for a saturated engine: the backlog's estimated
    service time, queue depth x the measured decode-step p50, clamped to
    [1, 30] seconds; 1 before any step was measured."""
    if not queue_depth or not decode_p50_s or decode_p50_s <= 0:
        return 1
    return int(min(30.0, max(1.0, math.ceil(queue_depth * decode_p50_s))))


class _Request:
    """One sequence's life in the engine."""

    def __init__(self, prompt, max_new_tokens, eos_token_id, do_sample,
                 temperature, seed, ttl_s=None, queue_timeout_s=None,
                 priority=None, tenant="default", request_id=None):
        # a stable id, the caller's or assigned here, carried verbatim
        # across snapshot and restore
        self.request_id = (str(request_id) if request_id
                           else f"req-{uuid.uuid4().hex[:16]}")
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.seed = int(seed) & 0xFFFFFFFF   # on-device threefry seed
        self.rng = np.random.default_rng(seed)   # host draws
        self.prefix_tokens = 0       # prompt tokens shared at admission
        # the class and tenant the scheduler queues this request under,
        # and the chunked prefill cursor (prompt tokens resident in the
        # cache: a preempted request resumes from here)
        self.priority = priority     # normalized by the scheduler
        self.tenant = str(tenant)
        self.prefill_pos = 0
        self.chunks_done = 0         # prefill dispatches (trace detail)
        self.admitted_at: Optional[float] = None
        self._admit_plan = None      # (need, shared_tok) fit-check stash
        # a restored request's prefill ingests prompt + generated (see
        # ``prefill_target``)
        self.replay_tokens: Optional[np.ndarray] = None
        # preempted_at / paused_total bound a paused request's page
        # reservation (paused_total accumulates across preempt/resume
        # cycles, so re-preemption cannot reset the aging clock)
        self.preempted_at: Optional[float] = None
        self.paused_total = 0.0
        # parked by the TPOT trigger: stays paused while the breach lasts
        self._tpot_parked = False
        self.generated: List[int] = []
        self.next_token: Optional[int] = None   # sampled, not yet decoded
        # speculative decoding: whether this request speculates, and
        # whether it holds a draft-pool reservation
        self.use_draft = False
        self._draft_reserved = False
        self.seq_id: Optional[int] = None
        self.done = threading.Event()
        self._cancel = threading.Event()
        self.error: Optional[BaseException] = None
        self.submitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # deadlines are absolute perf_counter instants; the loop reaps at
        # admission and between steps
        self.ttl_s = ttl_s
        self.queue_timeout_s = queue_timeout_s
        self.deadline = (None if ttl_s is None
                         else self.submitted_at + float(ttl_s))
        self.queue_deadline = (
            None if queue_timeout_s is None
            else self.submitted_at + float(queue_timeout_s))

    @property
    def output_ids(self) -> np.ndarray:
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    @property
    def prefill_target(self) -> np.ndarray:
        """The tokens that must be in the cache before this request
        decodes: its prompt, or for a restored request prompt + the
        tokens generated before the snapshot, ingested by the same
        prompt-ingest steps."""
        return (self.prompt if self.replay_tokens is None
                else self.replay_tokens)

    def cancel(self) -> bool:
        """Cooperative cancel: honored before admission and between
        steps (a step in flight finishes first).  The request's pages
        and reservation are reclaimed when the scheduler reaps it;
        waiters get :class:`RequestCancelled`.  Returns False if the
        request had already finished."""
        already_done = self.done.is_set()
        self._cancel.set()
        return not already_done

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def _lifecycle_error(self, now: float,
                         queued: bool) -> Optional[BaseException]:
        """The error this request should retire with right now, or None
        while it is still live."""
        if self._cancel.is_set():
            return RequestCancelled("request cancelled")
        if self.deadline is not None and now > self.deadline:
            return DeadlineExceeded(
                f"request exceeded its {float(self.ttl_s):.3f}s TTL")
        if queued and self.queue_deadline is not None \
                and now > self.queue_deadline:
            return DeadlineExceeded(
                f"request waited past its {float(self.queue_timeout_s):.3f}s "
                "queue-wait deadline without being admitted")
        return None

    def result(self, timeout=None, cancel_on_timeout: bool = True
               ) -> np.ndarray:
        """Wait for the generation; returns prompt + generated ids, or
        raises the error the request failed with.  On timeout the request
        is cancelled by default (``cancel_on_timeout=False`` keeps it
        running), so an abandoned wait does not leave the sequence
        decoding, and holding pool pages, forever."""
        if not self.done.wait(timeout):
            if cancel_on_timeout:
                self.cancel()
                raise TimeoutError(
                    "generation still running; request cancelled "
                    "(pass cancel_on_timeout=False to keep it)")
            raise TimeoutError("generation still running")
        if self.error is not None:
            raise self.error
        return self.output_ids


class ContinuousBatchingEngine:
    """Scheduler + step loop over one shared PagedKVCache.

    ``submit`` is thread-safe and non-blocking; ``generate`` is the
    blocking batch facade.  ``sample_on_device`` keeps the sampling tail
    on the model's device (only (batch,) ids reach the host);
    ``prefix_cache`` keeps retired prompts' page-aligned prefix KV
    resident (refcounted, LRU-evicted under pool pressure);
    ``prefill_chunk_tokens`` caps the prompt tokens one iteration
    ingests, so long prompts interleave with decode.  ``quantize``
    ("w8"/"w8a8") and ``kv_quant`` ("int8") select quantized serving.
    ``device`` is where the model lives; the engine's steps run on
    PyTorch's current stream there, from the scheduler thread.  On a
    card they are CUDA graphs (``GraphedPagedDecoder``: one per mode,
    tail kind and bucket, captured the first time a bucket runs, replayed
    after; ``captures`` and ``replays`` count them), on the CPU the eager
    ``PagedDecoder``.  ``min_table_pages`` floors the ragged and prefix
    steps' page-table width: pinned at ceil(max_position / page_size) it
    gives every context length one bucket, so mixed short and long
    traffic stops capturing new graphs, for more paged-attention splits
    over the wider table.  ``unified_step=False`` runs every iteration
    through the legacy composition (a dispatch a chunk, then one decode
    step), the JAX engine's escape hatch.

    Lifecycle and scheduling, as the JAX engine's constructor takes
    them: ``max_queue`` bounds each class's admission queue (overflow
    raises :class:`EngineSaturated`; ``PriorityClass.max_queue``
    overrides it a class); ``default_ttl_s`` and
    ``default_queue_timeout_s`` are the deadlines a ``submit`` may
    override; ``scheduler_classes`` and ``default_class`` configure the
    class taxonomy (``submit(priority=..., tenant=...)``);
    ``preempt_resume_ttl_s`` bounds how long a paused request may hold
    its reservation; ``decode_preempt`` lets a slot preemption pause a
    decoding row when no preemptible prefill is left;
    ``result_cache_size`` bounds the finished outcomes ``result_for``
    keeps.

    Overload controls (see the module docstring): a class's
    ``deadline_s`` sheds doomed arrivals and its ``tpot_budget_s`` arms
    the TPOT trigger (paced by ``tpot_preempt_cooldown_s``);
    ``brownout_thresholds`` (None: off, else four ascending
    queue-pressure ratios) and ``brownout_patience`` configure the
    ladder; ``retry_after_hint`` and ``scheduler_info()``'s
    ``brownout_level`` report it.

    Speculative decoding: ``draft_model`` (same vocabulary, on the same
    device) proposes ``spec_tokens`` tokens a step for every greedy
    request that does not opt out (``submit(draft=False)``); it has its
    own decoder (graphed on a card) and page pool of
    ``draft_total_pages`` (default ``total_pages``), and stays at full
    precision whatever ``quantize`` and ``kv_quant`` say.

    Tensor parallelism: ``tp > 1`` serves the model over ``tp`` ranks,
    one process a rank (``distributed.tensor_parallel``): this process is
    rank 0 and plans every step, ``tp - 1`` spawned workers execute them.
    The weights are cut Megatron-style (``paged._tp_plan``) and every KV
    pool on its kv-head axis, so one engine is one replica whose
    scheduling surface is unchanged.  ``tp_quant_collectives`` closes
    each block with the int8 all-gather in place of the sum all-reduce;
    ``tp_backend`` is the device group's: None runs gloo on the CPU and
    NCCL on a card (rank r on ``cuda:r``, so ``tp`` visible cards), and
    ``"gloo"`` on a card puts every rank on ``device``.  The sharded steps
    run eagerly (``PagedDecoder``) on every backend; a draft model stays
    whole on rank 0.  ``quantize`` does not compose with ``tp > 1``, as in
    JAX; ``kv_quant`` does.  ``stop`` (and leaving a ``with`` block) ends
    every worker.

    Crash recovery: ``step_timeout_s`` registers the step heartbeat with
    the process's watchdog (``distributed.watchdog.CommTaskManager``);
    ``replay_batch`` replays the survivors after a lost pool in batched
    rounds (None: on the CPU, not on a card, where a batched round's
    first chunk runs the dense prefix attention where the original
    prefill ran the flash kernel); ``snapshot`` / ``restore`` carry live
    streams across a restart.

    Durability: ``journal`` (an ``inference.journal.RequestJournal``)
    receives every admission, one coalesced record an iteration (the
    ids that took a slot, each surviving row's new tokens and pending
    token), the page provenance of cached prefixes and every retirement.
    The engine only enqueues, under its lock; the journal's writer
    thread does the I/O.  The records are host data (Python ints and
    the prompt's numpy array), so journaling never reads the card.  A
    hard ``stop()`` journals nothing: a relaunch resumes what was live,
    as after a SIGKILL.  ``RequestJournal.recovered_requests()`` of a
    predecessor's journal feeds ``restore``.

    Counters, the engine's counterparts of the JAX monitor's:
    ``dispatches`` by mode (``ragged``, ``prefill``, ``chunk``,
    ``decode``, ``verify``, and ``draft`` for the draft model's prompt
    ingestion and proposals; a retry or bisection probe counts again),
    ``steps`` (decode, verify or ragged steps that carried active rows),
    ``decode_retries``, ``quarantined`` (requests failed alone),
    ``unified_fallbacks`` (ragged steps re-run through the legacy
    composition), ``cancelled`` and ``expired`` (requests reaped),
    ``saturated`` (submissions refused by a full queue) and
    ``drain_rejected`` (queued requests failed by ``drain``); with a
    draft, ``spec_proposed`` and ``spec_accepted`` (draft tokens),
    ``spec_rollbacks`` (verify outcomes that rejected a suffix),
    ``spec_accept_lens`` (verify outcomes by accept length 0..k),
    ``spec_draft_failures`` (requests downgraded), ``last_spec`` (the
    last step's (proposed, accepted)) and ``draft_pages`` (pages the
    draft pool pins); ``rebuilds`` (pool losses recovered),
    ``survivor_replays`` (requests replayed), ``replay_dispatches``
    (replay steps, not in ``dispatches``), ``recovery_s`` (the last
    recoveries' seconds, newest last) and ``snapshot_requests``
    (entries serialized); per class, ``scheduler_info()["counts"]``.
    The process-wide series of ``paddle_tpu_torch.monitor`` count the
    same events over every engine of the process."""

    def __init__(self, model, total_pages: int = 512, page_size: int = 16,
                 max_batch: int = 8, sample_on_device: bool = True,
                 prefix_cache: bool = True, max_queue: int = 256,
                 default_ttl_s: Optional[float] = None,
                 default_queue_timeout_s: Optional[float] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 scheduler_classes=None,
                 default_class: str = DEFAULT_CLASS,
                 min_table_pages: int = 1,
                 preempt_resume_ttl_s: Optional[float] = None,
                 quantize: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 unified_step: bool = True,
                 decode_preempt: bool = True,
                 draft_model=None, spec_tokens: int = 4,
                 draft_total_pages: Optional[int] = None,
                 step_timeout_s: Optional[float] = None,
                 replay_batch: Optional[bool] = None,
                 result_cache_size: int = 256,
                 brownout_thresholds=None,
                 brownout_patience: int = 3,
                 tpot_preempt_cooldown_s: float = 0.25,
                 tp: int = 1, tp_quant_collectives: bool = False,
                 tp_backend: Optional[str] = None,
                 journal=None,
                 device="cuda"):
        self.device = resolve_device(device)
        weight = model.model.embed_tokens.weight
        if weight.device != self.device:
            raise ValueError(f"the model lives on {weight.device}, the "
                             f"engine was asked for {self.device}")
        if prefill_chunk_tokens is not None \
                and int(prefill_chunk_tokens) < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1 or None")
        # admission queues live in the workload scheduler (per class,
        # per tenant); the engine owns three lists the drain, reap and
        # fail paths must see: _prefilling (admitted, chunk cursor
        # advancing), _preempted (paused, pages kept, waiting for a slot)
        # and _active (decoding)
        self.max_queue = int(max_queue)
        self._sched = WorkloadScheduler(
            classes=scheduler_classes, max_queue=self.max_queue,
            default_class=default_class)
        # the overload controls: the ladder is off with None, else its
        # rungs 1..4 trip at these queue-pressure ratios (depth /
        # max_queue); it climbs at once and comes down after
        # brownout_patience calm iterations, and an idle engine drops to
        # rung 0.  The TPOT trigger pauses a preemptible decoding row at
        # full occupancy when the measured step time breaches a running
        # row's tpot_budget_s, at most once a cooldown
        if brownout_thresholds is not None:
            brownout_thresholds = tuple(
                float(t) for t in brownout_thresholds)
            if len(brownout_thresholds) != 4 \
                    or list(brownout_thresholds) \
                    != sorted(brownout_thresholds):
                raise ValueError(
                    "brownout_thresholds must be 4 ascending "
                    f"queue-pressure ratios, got {brownout_thresholds!r}")
        self.brownout_thresholds = brownout_thresholds
        self.brownout_patience = max(1, int(brownout_patience))
        self.tpot_preempt_cooldown_s = float(tpot_preempt_cooldown_s)
        self._brownout = 0
        self._brownout_calm = 0              # scheduler thread only
        self._step_ewma: Optional[float] = None   # scheduler thread only
        self._tpot_last_preempt = 0.0        # scheduler thread only
        # finished outcomes by request id, bounded FIFO (result_for)
        self.result_cache_size = max(0, int(result_cache_size))
        self._results: "OrderedDict[str, dict]" = OrderedDict()
        self.model = model
        self.max_batch = int(max_batch)
        self.max_position = int(model.config.max_position_embeddings)
        self.sample_on_device = bool(sample_on_device)
        _sampling_on_device_g.set(int(self.sample_on_device))
        self.prefix_cache = bool(prefix_cache)
        self.default_ttl_s = default_ttl_s
        self.default_queue_timeout_s = default_queue_timeout_s
        self.prefill_chunk_tokens = (None if prefill_chunk_tokens is None
                                     else int(prefill_chunk_tokens))
        # a paused request holds its page reservation at most this long:
        # past half of it an aging boost forces its resume ahead of any
        # queued class, past all of it it is reaped (None: unbounded)
        self.preempt_resume_ttl_s = (
            None if preempt_resume_ttl_s is None
            else float(preempt_resume_ttl_s))
        self.decode_preempt = bool(decode_preempt)
        self.unified_step = bool(unified_step)
        # latched after 3 ragged-step failures in a row: the legacy
        # composition serves from then on
        self._unified_off = False
        self._unified_failures = 0
        # the write-ahead journal: admit and retire records are appended
        # at their sites, under the lock; _jadm / _jrows gather the
        # iteration's step record, and _disp_n / _disp_ragged its
        # dispatch count and mode (scheduler thread only)
        self.journal = journal
        self._jadm: List[str] = []
        self._jrows: List[tuple] = []
        self._disp_n = 0
        self._disp_ragged = False
        self.dispatches = {"ragged": 0, "prefill": 0, "chunk": 0,
                           "decode": 0, "verify": 0, "draft": 0}
        self.steps = 0
        self.decode_retries = 0
        self.quarantined = 0
        self.unified_fallbacks = 0
        self.cancelled = 0
        self.expired = 0
        self.saturated = 0
        self.drain_rejected = 0
        # quantized serving: ``quantize`` runs every Linear of the steps
        # in int8 ("w8" weight-only, "w8a8" dynamic per token);
        # ``kv_quant="int8"`` stores the KV pages in int8 with per-slot
        # scale pools
        if kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant must be None or 'int8', got {kv_quant!r}")
        self.quantize = quantize
        self.kv_quant = kv_quant
        # tensor parallelism: the plan and the quantize refusal are
        # checked before any worker starts; the workers end if the rest
        # of the set-up fails
        self.tp = int(tp)
        if self.tp < 1:
            raise ValueError(f"tp degree must be >= 1, got {self.tp}")
        self.tp_quant_collectives = bool(tp_quant_collectives)
        self.tp_group = None
        if self.tp > 1:
            if quantize is not None:
                raise ValueError(
                    "quantize='w8'/'w8a8' does not compose with tensor "
                    "parallelism (kv_quant='int8' does)")
            _tp_plan(model, self.tp)
            self.tp_group = TensorParallelGroup(self.tp, self.device,
                                                backend=tp_backend)
        try:
            self.cache = PagedKVCache.from_model(
                model, total_pages=total_pages, page_size=page_size,
                kv_dtype=kv_quant, tp_group=self.tp_group)
            decoder = (GraphedPagedDecoder if self.device.type == "cuda"
                       else PagedDecoder)
            if self.tp_group is not None:
                self._decoder = PagedDecoder(
                    model, min_table_pages=min_table_pages,
                    tp_group=self.tp_group,
                    tp_quant_collectives=self.tp_quant_collectives)
            else:
                self._decoder = decoder(model, quantize=quantize,
                                        min_table_pages=min_table_pages)
            _quant_enabled_g.set(int(quantize is not None))
            _kv_quant_enabled_g.set(int(kv_quant is not None))
            _kv_quant_pool_bytes_g.set(self.cache.kv_pool_bytes)
            _kv_quant_scale_bytes_g.set(self.cache.kv_scale_bytes)
            _replay_dispatches.inc(0)       # materialize the series
            # speculative decoding: the draft gets its own decoder and page
            # pool, at full precision (its accuracy sets the acceptance rate)
            self.draft_model = draft_model
            self.spec_k = int(spec_tokens)
            if draft_model is not None:
                if self.spec_k < 1:
                    raise ValueError("spec_tokens must be >= 1")
                if int(draft_model.config.vocab_size) \
                        != int(model.config.vocab_size):
                    raise ValueError(
                        "draft and target models must share a vocabulary "
                        f"({draft_model.config.vocab_size} vs "
                        f"{model.config.vocab_size})")
                dweight = draft_model.model.embed_tokens.weight
                if dweight.device != self.device:
                    raise ValueError(f"the draft model lives on "
                                     f"{dweight.device}, the engine on "
                                     f"{self.device}")
                self._draft_decoder = decoder(draft_model,
                                              min_table_pages=min_table_pages)
                self.draft_cache = PagedKVCache.from_model(
                    draft_model,
                    total_pages=(total_pages if draft_total_pages is None
                                 else draft_total_pages),
                    page_size=page_size)
                self._draft_max_position = int(
                    draft_model.config.max_position_embeddings)
            else:
                self._draft_decoder = None
                self.draft_cache = None
                self._draft_max_position = 0
        except BaseException:
            if self.tp_group is not None:
                self.tp_group.close()
            raise
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rollbacks = 0
        self.spec_draft_failures = 0
        self.spec_accept_lens = [0] * (self.spec_k + 1)
        self.last_spec = (0, 0)
        # headroom for the legacy steps' pad rows on the scratch
        # sequence: a decode pad writes slot 0 of its one page, a verify
        # pad (and a draft proposal's) spec_tokens + 1 slots (the ragged
        # step's pad rows change no page)
        pad_tokens = self.spec_k + 1 if self._spec else 1
        self._pad_pages = max(1, -(-pad_tokens // int(page_size)))
        self._reserved_pages = self._pad_pages
        self._reserved_draft_pages = self._pad_pages
        self._active: List[_Request] = []
        self._prefilling: List[_Request] = []
        self._preempted: List[_Request] = []
        self._cond = threading.Condition()
        self._stop = False
        self._draining = False
        self._next_seq = 0
        # crash recovery: batched survivor replay is off on a card, where
        # a batched round's first chunk takes the dense prefix attention
        # in place of the flash kernel the original prefill ran (as the
        # JAX engine turns it off on a TPU)
        self.replay_batch = (self.device.type != "cuda"
                             if replay_batch is None else bool(replay_batch))
        self.step_timeout_s = step_timeout_s
        self.rebuilds = 0
        self.survivor_replays = 0
        self.replay_dispatches = 0
        self.recovery_s = deque(maxlen=_RECOVERY_HISTORY)
        self.snapshot_requests = 0
        # the summed pool generation last reconciled: a bump after a
        # failed step means a pool was lost and the survivors replay
        self._pool_gen = self._generation()
        # _wedged: set by the watchdog thread, read after each dispatch;
        # _step_started_at: the dispatch in flight's start, the
        # heartbeat's age; _stepping / _snap_waiters: the snapshot's
        # step-boundary barrier
        self._wedged = threading.Event()
        self._step_started_at: Optional[float] = None
        self._stepping = False
        self._snap_waiters = 0
        self._hb_id: Optional[int] = None
        if step_timeout_s is not None:
            mgr = CommTaskManager.instance()
            self._hb_id = mgr.register_heartbeat(
                "engine/decode_step", self._step_age,
                float(step_timeout_s), on_timeout=self._wedged.set)
            mgr.start()
        # every live engine counts toward the journals' co-location
        # scaling (a journal-less one steps on the same GIL)
        _journal_mod.engine_started()
        self._coloc_registered = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- public
    @property
    def _spec(self) -> bool:
        return self.draft_model is not None

    @property
    def captures(self) -> int:
        """CUDA graphs the engine's steps have captured, the draft's
        included (0 on the CPU)."""
        return self._decoder.captures + (self._draft_decoder.captures
                                         if self._spec else 0)

    @property
    def replays(self) -> int:
        """Steps that replayed a captured graph, the draft's included (0
        on the CPU)."""
        return self._decoder.replays + (self._draft_decoder.replays
                                        if self._spec else 0)

    @property
    def draft_pages(self) -> int:
        """Pages the draft pool pins (0 without a draft)."""
        return self.draft_cache.pinned_pages if self._spec else 0

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, do_sample: bool = False,
               temperature: float = 1.0, seed: int = 0,
               ttl_s: Optional[float] = None,
               queue_timeout_s: Optional[float] = None,
               priority: Optional[str] = None,
               tenant: str = "default",
               draft: Optional[bool] = None,
               request_id: Optional[str] = None,
               _restore: Optional[dict] = None) -> _Request:
        """Queue one request; returns its handle (``result()`` waits).

        ``request_id`` is a stable id for the request, carried verbatim
        across ``snapshot`` and ``restore`` (``req-<16 hex>`` when
        omitted); a ValueError while a live request holds the same id.
        ``_restore`` is a snapshot entry (``restore`` passes it): the
        request starts with its generated tokens and pending next token,
        its prefill ingests prompt + generated, and its deadlines are the
        entry's, not this engine's defaults.

        ``draft`` is the request's speculative opt-in: None speculates
        whenever the engine has a draft model and the request is greedy,
        False opts out, True demands it (ValueError without a draft
        model, with ``do_sample``, or past the draft's positions).
        ``ttl_s`` and ``queue_timeout_s`` override the engine's default
        deadlines; ``priority`` names a scheduling class (None -> the
        default class; an unknown name is a ValueError, a client mistake
        and not a capacity problem); ``tenant`` is a free-form tenant id
        fair-queued within the class.  Raises :class:`EngineDraining`
        once draining, :class:`EngineSaturated` when the class's queue
        is full or the overload controls shed the arrival (then with
        ``retry_after_s``)."""
        # the class is resolved before any capacity check: an unknown
        # class is never reported as saturation or draining
        pclass = self._sched.resolve(priority)
        req = _Request(prompt, max_new_tokens, eos_token_id, do_sample,
                       temperature, seed,
                       ttl_s=self.default_ttl_s if ttl_s is None else ttl_s,
                       queue_timeout_s=(self.default_queue_timeout_s
                                        if queue_timeout_s is None
                                        else queue_timeout_s),
                       priority=pclass.name, tenant=tenant,
                       request_id=request_id)
        if _restore is not None:
            # preloaded before the scheduler can see the request: its
            # prefill ingests prompt + generated, and the journaled next
            # token (kept even with nothing generated yet) continues the
            # stream
            gen = [int(t) for t in _restore.get("generated", ())]
            if gen:
                req.generated = gen
                req.replay_tokens = np.concatenate(
                    [req.prompt, np.asarray(gen, np.int32)])
            nt = _restore.get("next_token")
            req.next_token = None if nt is None else int(nt)
            # the entry's deadlines verbatim: None means none remained,
            # and this engine's defaults must not reap restored streams
            ttl = _restore.get("ttl_remaining_s")
            req.ttl_s = ttl
            req.deadline = (None if ttl is None
                            else req.submitted_at + float(ttl))
            qt = _restore.get("queue_timeout_remaining_s")
            req.queue_timeout_s = qt
            req.queue_deadline = (None if qt is None
                                  else req.submitted_at + float(qt))
        if len(req.prompt) < 1:
            raise ValueError("the prompt needs at least one token")
        total = len(req.prompt) + req.max_new_tokens
        # a verify step writes spec_tokens + 1 positions before it rolls
        # back, so the rope table must hold the overhang for every
        # request of a speculative engine (opted-out rows ride in the
        # same block)
        overhang = self.spec_k if self._spec else 0
        if total + overhang > self.max_position:
            raise ValueError(
                f"prompt + max_new_tokens = {total} "
                + (f"+ speculative overhang {overhang} " if overhang
                   else "")
                + f"exceeds the model's max_position_embeddings "
                f"({self.max_position})")
        if draft and not self._spec:
            raise ValueError("draft=True but the engine was built without "
                             "a draft_model")
        use = self._spec and (draft is None or bool(draft))
        if use and req.do_sample:
            # acceptance by argmax is exact only for greedy rows; sampled
            # rows ride along unaccelerated
            if draft:
                raise ValueError(
                    "speculative decoding is greedy-exact only; draft=True "
                    "cannot be combined with do_sample")
            use = False
        if use and total + self.spec_k > self._draft_max_position:
            if draft:
                raise ValueError(
                    f"prompt + max_new_tokens + speculative overhang = "
                    f"{total + self.spec_k} exceeds the DRAFT model's "
                    f"max_position_embeddings ({self._draft_max_position})")
            use = False
        req.use_draft = use
        need = self._pages_for(req)
        if need > self.cache.total_pages - self._pad_pages:
            raise RuntimeError(
                f"request needs {need} pages but the pool holds "
                f"{self.cache.total_pages} total; grow total_pages")
        if req.use_draft \
                and need > self.draft_cache.total_pages - self._pad_pages:
            raise RuntimeError(
                f"request needs {need} draft-cache pages but the draft "
                f"pool holds {self.draft_cache.total_pages} total; grow "
                "draft_total_pages")
        with self._cond:
            if self._draining:
                raise EngineDraining(
                    "engine is draining or drained; not accepting new "
                    "requests")
            if self._stop:
                raise RuntimeError("engine stopped")
            if request_id is not None:
                # an id may be reused once its request has finished,
                # never while it is live
                live = (self._active + self._prefilling + self._preempted
                        + self._sched.pending())
                if any(r.request_id == req.request_id for r in live):
                    raise ValueError(f"request_id {req.request_id!r} is "
                                     "already live; pick a new id")
            # SLO-aware admission: shed a doomed arrival before it enters
            # the queue or holds a trace timeline slot, when its class's
            # deadline budget is already blown by the projected queue
            # wait or the brownout ladder sheds the class
            shed_after = self._shed_decision_locked(pclass)
            if shed_after is not None:
                self._sched.note_shed(pclass.name)
                self.saturated += 1
                _saturated_total.inc()
                _tracer.request_event(
                    req.request_id, "shed", cls=pclass.name,
                    retry_after_s=shed_after, brownout=self._brownout)
                err = EngineSaturated(
                    f"admission shed for class {pclass.name!r}: "
                    "projected queue wait exceeds its SLO budget "
                    f"(brownout level {self._brownout}); retry in "
                    f"~{shed_after}s")
                err.priority_class = pclass.name
                err.retry_after_s = shed_after
                raise err
            try:
                self._sched.push(req)
            except QueueFull as e:
                self.saturated += 1
                _saturated_total.inc()
                err = EngineSaturated(str(e))
                err.priority_class = e.priority_class
                raise err from None
            if self.journal is not None:
                # before the scheduler thread can see the request, so no
                # step or retire record of it precedes its admit record
                self.journal.append_admit(self._journal_entry(req))
            _queue_depth.set(len(self._sched))
            _tracer.request_event(
                req.request_id, "enqueue", cls=req.priority,
                tenant=req.tenant, prompt_tokens=len(req.prompt),
                restored=bool(_restore is not None))
            self._cond.notify_all()
        return req

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 seed: int = 0, ttl_s: Optional[float] = None,
                 draft: Optional[bool] = None,
                 priority: Optional[str] = None,
                 tenant: str = "default",
                 request_id: Optional[str] = None):
        """Blocking batch API: one sequence per row (row i seeded
        ``seed + i``; rows may differ in length), outputs eos-padded to a
        common length; ``draft`` and ``request_id`` as
        :meth:`generate_with_requests` takes them.  If any row fails to
        submit or errors, the rows already submitted are cancelled and
        the error re-raised, so a rejected batch never leaves orphan
        sequences decoding against the pool."""
        out, _reqs = self.generate_with_requests(
            input_ids, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id, do_sample=do_sample,
            temperature=temperature, seed=seed, ttl_s=ttl_s, draft=draft,
            priority=priority, tenant=tenant, request_id=request_id)
        return out

    def generate_with_requests(self, input_ids, max_new_tokens: int = 32,
                               eos_token_id: Optional[int] = None,
                               do_sample: bool = False,
                               temperature: float = 1.0, seed: int = 0,
                               ttl_s: Optional[float] = None,
                               draft: Optional[bool] = None,
                               priority: Optional[str] = None,
                               tenant: str = "default",
                               request_id: Optional[str] = None):
        """:meth:`generate` returning ``(output_ids, requests)``, so a
        server can hand each row's ``request_id`` back to its client.
        ``draft`` is every row's speculative opt-in (``submit``'s);
        ``request_id`` is the id of a single row, and of a multi-row call
        the stem of its rows' ids, ``<id>/<row>``."""
        ids = [np.asarray(row) for row in input_ids]

        def rid(i: int) -> Optional[str]:
            if request_id is None:
                return None
            return request_id if len(ids) == 1 else f"{request_id}/{i}"

        reqs: List[_Request] = []
        try:
            for i, row in enumerate(ids):
                reqs.append(self.submit(row, max_new_tokens, eos_token_id,
                                        do_sample, temperature, seed + i,
                                        ttl_s=ttl_s, draft=draft,
                                        priority=priority, tenant=tenant,
                                        request_id=rid(i)))
            rows = [r.result() for r in reqs]
        except BaseException:
            for r in reqs:
                r.cancel()
            raise
        width = max(len(r) for r in rows)
        out = np.full((len(rows), width),
                      0 if eos_token_id is None else eos_token_id, np.int32)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out, reqs

    @property
    def draining(self) -> bool:
        return self._draining

    def retry_after_hint(self, priority: Optional[str] = None) -> int:
        """Seconds a refused client should wait before retrying: the
        backlog x the measured decode-step p50, clamped to [1, 30].  With
        ``priority`` (a class of this engine) the backlog is that class's
        queue, otherwise the whole queue.  A class with a deadline budget
        gets the time for its backlog to drain back under the budget
        (halved at rung 3 and up), the wait the shed decision projects."""
        with self._cond:
            cls = None
            if priority is not None \
                    and priority in {c.name for c in self._sched.classes}:
                cls = self._sched.resolve(priority)
                depth = self._sched.depth(priority)
            else:
                depth = len(self._sched)
            level = self._brownout
        p50 = _decode_p50_seconds()
        hint = retry_after_seconds(depth, p50)
        if cls is not None and cls.deadline_s is not None \
                and p50 and p50 > 0:
            budget = cls.deadline_s * (0.5 if level >= 3 else 1.0)
            projected = depth * p50
            if projected > budget:
                hint = int(min(30.0, max(1.0,
                                         math.ceil(projected - budget))))
        return hint

    # ------------------------------------------------- overload controls
    def _shed_decision_locked(self, pclass) -> Optional[int]:
        """Caller holds ``self._cond``.  Why this arrival must shed, as a
        truthful Retry-After in seconds, or None to admit.  Two
        controllers:

        * the brownout ladder sheds whole classes: rung L sheds the L
          least urgent rank bands (rung >= 3 sheds every rank below the
          top one and halves the surviving class's deadline budget);
        * a class's ``deadline_s`` sheds a request that is already
          doomed: the projected queue wait (class depth x the measured
          decode-step p50) past the budget means it would time out after
          holding pages, so it is refused now."""
        level = self._brownout
        p50 = _decode_p50_seconds()
        if level >= 1:
            ranks = sorted({c.rank for c in self._sched.classes})
            if pclass.rank > ranks[0]:
                bands = ranks[1:]
                shed = bands[len(bands) - min(level, len(bands)):]
                if level >= 3 or pclass.rank in shed:
                    depth = self._sched.depth(pclass.name)
                    return retry_after_seconds(max(1, depth), p50)
        budget = pclass.deadline_s
        if budget is None or not p50 or p50 <= 0:
            return None
        if level >= 3:
            budget *= 0.5
        projected = self._sched.depth(pclass.name) * p50
        if projected <= budget:
            return None
        return int(min(30.0, max(1.0, math.ceil(projected - budget))))

    def _set_brownout_locked(self, level: int, pressure: float) -> None:
        """Caller holds ``self._cond``.  Move the ladder to ``level``;
        rung 4 trades the journal's configured durability for throughput
        (fsync ``"os"``, undone on the way down, unlike the watchdog's
        ``degrade``)."""
        if level == self._brownout:
            return
        prev, self._brownout = self._brownout, level
        _brownout_level_g.set(level)
        _brownout_transitions.inc()
        _tracer.request_event(None, "brownout", level=level, prev=prev,
                              pressure=round(pressure, 4))
        if self.journal is not None:
            if level >= 4:
                self.journal.set_policy("os")
            elif prev >= 4:
                self.journal.set_policy(self.journal.fsync_policy)

    def _update_brownout_locked(self) -> None:
        """Caller holds ``self._cond``.  One control-loop evaluation an
        iteration.  Pressure is the larger of the queue's fill (depth /
        ``max_queue``) and the most urgent budgeted class's attainment
        deficit; a rung climbs at once and comes down only after
        ``brownout_patience`` calm iterations below half the rung's
        threshold (hysteresis, so a load hovering at a threshold cannot
        thrash the ladder)."""
        th = self.brownout_thresholds
        if th is None:
            return
        ratio = len(self._sched) / float(max(1, self.max_queue))
        att = self._sched.urgent_attainment()
        pressure = ratio if att is None else max(ratio, 1.0 - att)
        level = self._brownout
        if level < 4 and pressure >= th[level]:
            self._brownout_calm = 0
            self._set_brownout_locked(level + 1, pressure)
            return
        if level > 0 and pressure < 0.5 * th[level - 1]:
            self._brownout_calm += 1
            if self._brownout_calm >= self.brownout_patience:
                self._brownout_calm = 0
                self._set_brownout_locked(level - 1, pressure)
        else:
            self._brownout_calm = 0

    def _count_dispatch(self, mode: str) -> None:
        """One serving dispatch attempt of ``mode``: the engine's counter,
        the process-wide series and the iteration's count for its journal
        record (a retry or bisection probe counts again)."""
        self.dispatches[mode] += 1
        _dispatches_total.inc(mode=mode)
        self._disp_n += 1
        if mode == "ragged":
            self._disp_ragged = True

    # ---------------------------------------------------- result cache
    def _cache_result_locked(self, req) -> None:
        """Caller holds ``self._cond``.  Keep a finished request's outcome
        in the bounded result cache, so a detached client can read it by
        id (``result_for``), after a restore too."""
        if not self.result_cache_size:
            return
        if req.error is None:
            entry = {"request_id": req.request_id, "status": "done",
                     "output_ids": [int(t) for t in req.output_ids],
                     "new_tokens": len(req.generated)}
        else:
            entry = {"request_id": req.request_id, "status": "error",
                     "error": str(req.error),
                     "error_type": type(req.error).__name__}
        self._results[req.request_id] = entry
        self._results.move_to_end(req.request_id)
        while len(self._results) > self.result_cache_size:
            self._results.popitem(last=False)

    def result_for(self, request_id: str) -> Optional[dict]:
        """The outcome for ``request_id``: ``status`` ``done`` (with
        ``output_ids``) or ``error`` once finished, ``pending`` (with
        ``generated_tokens``) while queued or in flight, None for an id
        this engine never saw or one evicted from the bounded cache."""
        with self._cond:
            hit = self._results.get(request_id)
            if hit is not None:
                return dict(hit)
            live = (self._active + self._prefilling + self._preempted
                    + self._sched.pending())
            for r in live:
                if r.request_id == request_id:
                    return {"request_id": request_id, "status": "pending",
                            "generated_tokens": len(r.generated)}
        return None

    def scheduler_info(self) -> dict:
        """JSON-able scheduling state: the policy knobs, per-class and
        per-tenant queue depths, per-class counters, the lengths of the
        in-flight lists and the brownout ladder's rung."""
        with self._cond:
            return {
                "prefill_chunk_tokens": self.prefill_chunk_tokens,
                "default_class": self._sched.default_class,
                "classes": self._sched.policy(),
                "tenants_queued": self._sched.tenant_depths(),
                "counts": self._sched.counts(),
                "prefilling": len(self._prefilling),
                "preempted": len(self._preempted),
                "brownout_level": self._brownout,
                "brownout_enabled": self.brownout_thresholds is not None,
                "decode_preempt": self.decode_preempt,
            }

    # ------------------------------------------------ snapshot / restore
    @staticmethod
    def _entry_fields(r) -> dict:
        """The request fields a snapshot entry and a journal admit record
        both carry beside their tokens and deadlines: one builder, so a
        field cannot restore on one path and be dropped on the other."""
        return {
            "request_id": r.request_id,
            "max_new_tokens": r.max_new_tokens,
            "eos_token_id": (None if r.eos_token_id is None
                             else int(r.eos_token_id)),
            "do_sample": r.do_sample,
            "temperature": r.temperature,
            "seed": r.seed,
            "priority": r.priority,
            "tenant": r.tenant,
            "draft": bool(r.use_draft),
        }

    # ----------------------------------------------- write-ahead journal
    def _journal_entry(self, req) -> dict:
        """The admit record's payload: the request's full state as a
        snapshot entry (a restored request carries its generated tokens
        and pending token, so replay is idempotent by id), with the
        deadlines as wall-clock instants, which mean the same in the next
        process."""
        now_p = time.perf_counter()
        now_w = time.time()

        def wall(d):
            return None if d is None else now_w + (d - now_p)

        return {
            **self._entry_fields(req),
            "prompt": req.prompt,            # numpy; the writer encodes
            "generated": [int(t) for t in req.generated],
            "next_token": (None if req.next_token is None
                           else int(req.next_token)),
            "deadline_unix": wall(req.deadline),
            "queue_deadline_unix": wall(req.queue_deadline),
        }

    def _journal_retire(self, req) -> None:
        if self.journal is None:
            return
        why = ("done" if req.error is None
               else type(req.error).__name__)
        self.journal.append_retire(req.request_id, why=why)

    def _journal_pages(self, req, event: str, n_tokens: int) -> None:
        """Page provenance: the page-aligned prefix ``req`` shares with
        the prefix cache, its local page indices and the content key that
        names the same prefix on another replica."""
        if self.journal is None:
            return
        ps = self.cache.page_size
        n = (int(n_tokens) // ps) * ps
        if n <= 0:
            return
        pages = self.cache._seq_pages.get(req.seq_id, [])[:n // ps]
        self.journal.append_pages(
            req.request_id, event, n, pages,
            self.cache.prefix_key_hex(req.prompt, n))

    def _journal_flush_step(self) -> None:
        """Scheduler thread, end of an iteration: one step record with
        the ids that took a slot and every surviving row's new tokens and
        pending token, for the journal's writer thread."""
        if self.journal is not None and (self._jadm or self._jrows):
            self.journal.append_step(
                self._jadm, self._jrows, dispatches=self._disp_n,
                mode=(("ragged" if self._disp_ragged else "legacy")
                      if self._disp_n else None))
        self._jadm = []
        self._jrows = []
        self._disp_n = 0
        self._disp_ragged = False

    def snapshot(self) -> dict:
        """Every live request as a JSON-able dict, the JAX engine's format
        (``{"version": 1, "requests": [...]}``, one entry a request:
        prompt, generated ids, pending next token, remaining TTL, the
        ``_entry_fields``).  Waits for the step in flight to finish, so
        the cut lies between steps; in-flight streams come first, then
        the queued requests (a restore that overflows its queues drops
        queued work, not streams).  Safe on an idle engine (no entry)
        and while draining."""
        with self._cond:
            self._snap_waiters += 1
            try:
                while self._stepping and not self._stop:
                    self._cond.wait(0.1)
                now = time.perf_counter()
                cuts = [(r, r.prompt, list(r.generated), r.next_token)
                        for r in (list(self._active)
                                  + list(self._prefilling)
                                  + list(self._preempted)
                                  + self._sched.pending())
                        if not r.done.is_set() and not r.cancelled]
            finally:
                self._snap_waiters -= 1
                self._cond.notify_all()
        entries = []
        for r, prompt, generated, next_token in cuts:
            entries.append({
                **self._entry_fields(r),
                "prompt": [int(t) for t in prompt],
                "generated": [int(t) for t in generated],
                "next_token": (None if next_token is None
                               else int(next_token)),
                "ttl_remaining_s": (None if r.deadline is None
                                    else max(1e-3, r.deadline - now)),
                # an admitted request met its queue-wait deadline: the
                # restore must not impose it again
                "queue_timeout_remaining_s": (
                    None if r.queue_deadline is None
                    or r.admitted_at is not None
                    else max(1e-3, r.queue_deadline - now)),
            })
        self.snapshot_requests += len(entries)
        _snapshot_reqs.inc(len(entries))
        return {"version": 1, "requests": entries}

    def restore(self, snapshot: dict, strict: bool = True
                ) -> List[_Request]:
        """Submit every entry of a :meth:`snapshot` (of this engine or
        the JAX engine) to this engine; returns the new handles.  An
        entry with generated tokens prefills prompt + generated and
        continues from its journaled next token, so its stream goes on
        token for token (a sampled row draws by (seed, position) on the
        device sampler; on the host sampler, ``sample_on_device=False``,
        draws after the restore come from a freshly seeded generator).
        ``strict=False`` warns and skips an entry this engine refuses
        (unknown class, full queue, too long) instead of raising.  A
        ``draft`` entry may speculate here if this engine can (None);
        one without opts out (False)."""
        out: List[_Request] = []
        for e in snapshot.get("requests", ()):
            try:
                out.append(self.submit(
                    np.asarray(e["prompt"], np.int32),
                    max_new_tokens=int(e.get("max_new_tokens", 32)),
                    eos_token_id=e.get("eos_token_id"),
                    do_sample=bool(e.get("do_sample", False)),
                    temperature=float(e.get("temperature", 1.0)),
                    seed=int(e.get("seed", 0)),
                    draft=None if e.get("draft") else False,
                    priority=e.get("priority"),
                    tenant=e.get("tenant", "default"),
                    request_id=e.get("request_id"),
                    _restore=e))
            except Exception as exc:  # noqa: BLE001 — per entry
                if strict:
                    raise
                warnings.warn(f"snapshot restore skipped one request: "
                              f"{exc!r}")
        return out

    def stop_admissions(self) -> None:
        """Flip the draining flag synchronously (``drain()`` sets it
        again, idempotently): every later ``submit`` raises
        :class:`EngineDraining`."""
        with self._cond:
            self._draining = True
            _draining_g.set(1)
            self._cond.notify_all()

    def drain(self, timeout: Optional[float] = None,
              reject_queued: bool = False) -> bool:
        """Graceful shutdown: stop accepting new submissions, let every
        already-submitted request (queued, prefilling, paused and
        decoding) run to completion, then stop the scheduler thread; the
        pool reclaims to idle as the last sequence retires.  Returns True
        when fully drained, False if ``timeout`` elapsed first (the
        engine keeps draining: call again, or ``stop()``).

        ``reject_queued=True`` fails the queued, unadmitted requests at
        once with :class:`EngineDraining` (they hold no pages) while the
        admitted ones still run to completion."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        rejected: List[_Request] = []
        with self._cond:
            self._draining = True
            _draining_g.set(1)
            if reject_queued and len(self._sched):
                rejected = self._sched.pop_all()
                for r in rejected:
                    r.error = EngineDraining(
                        "engine draining: request rejected before "
                        "admission (reject_queued)")
                    self._cache_result_locked(r)
                    self._journal_retire(r)
                self.drain_rejected += len(rejected)
                _queue_depth.set(0)
                _drain_rejected.inc(len(rejected))
            self._cond.notify_all()
        for r in rejected:
            r.done.set()
        with self._cond:
            while len(self._sched) or self._active or self._prefilling \
                    or self._preempted:
                if self._stop:
                    # a concurrent stop() errored what was left: that is
                    # not a completed drain
                    return False
                wait = 0.5
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        return False
                self._cond.wait(wait)
        self.stop()
        _draining_g.set(0)
        return True

    def stop(self):
        """Hard stop: errors whatever is still queued or running.  Use
        :meth:`drain` for the graceful path."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=60)
        if getattr(self, "_coloc_registered", False):
            self._coloc_registered = False
            _journal_mod.engine_stopped()
        if self._hb_id is not None:
            # a heartbeat outliving its engine would be flagged forever
            CommTaskManager.instance().unregister_heartbeat(self._hb_id)
            self._hb_id = None
        if self.tp_group is not None:
            self.tp_group.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # ---------------------------------------------------------- scheduler
    def _step_age(self) -> Optional[float]:
        """The watchdog's probe: seconds the dispatch in flight has run,
        None while none is (never flagged)."""
        t0 = self._step_started_at
        return None if t0 is None else time.monotonic() - t0

    def _generation(self) -> int:
        """Both caches' pool generations summed: ``reset_pools`` bumps
        one per lost pool."""
        return self.cache.generation + (self.draft_cache.generation
                                        if self._spec else 0)

    def _pages_for(self, req) -> int:
        total = len(req.prompt) + req.max_new_tokens
        if self._spec:
            # a verify step writes spec_tokens + 1 tokens from a length
            # of at most prompt + max_new - 1 before it rolls back (the
            # draft's proposal peaks at the same bound)
            total += self.spec_k
        return -(-total // self.cache.page_size)

    def _free_pads_locked(self) -> None:
        """Caller holds ``self._cond`` (or the loop is stopping).  Give
        the pad scratch pages back in both pools, so an idle engine
        reports whole pools."""
        self.cache.free(_PAD_SEQ)
        if self._spec:
            self.draft_cache.free(_PAD_SEQ)
            _spec_draft_pages.set(self.draft_cache.pinned_pages)

    @staticmethod
    def _pause_age(r, now: Optional[float] = None) -> float:
        """Total time this request has spent paused: the current pause
        plus every earlier preempt/resume cycle, so re-preemption can
        never reset the aging and reap clock."""
        age = r.paused_total
        if r.preempted_at is not None:
            age += (time.perf_counter() if now is None else now) \
                - r.preempted_at
        return age

    def _quarantine(self, req) -> None:
        """Count one request failed alone, in the engine's counter and
        the process-wide series, with its timeline event."""
        self.quarantined += 1
        _note_quarantine(req)

    def _preempt_expired_error(self, r,
                               now: float) -> Optional[BaseException]:
        """Caller holds ``self._cond``.  The reap error for a paused
        request that exhausted its resume TTL, or None while it may still
        resume (or no TTL is configured)."""
        ttl = self.preempt_resume_ttl_s
        if ttl is None or self._pause_age(r, now) <= ttl:
            return None
        self._sched.note_preempt_expired(r)
        return DeadlineExceeded(
            f"preempted request spent more than its {ttl:.3f}s resume "
            "TTL paused without a slot freeing up")

    def _preempt_rank_locked(self, r) -> int:
        """Caller holds ``self._cond``.  A request's effective rank for
        preemption decisions: its class rank, or, once it has spent half
        the resume TTL paused, an aging boost (rank -1) that outranks
        every queued class, so a slot that frees goes to the aged request
        (and an aged resumed request cannot be picked as a victim again)
        instead of fresh urgent traffic starving it to the reap bound."""
        ttl = self.preempt_resume_ttl_s
        if ttl is not None and self._pause_age(r) >= 0.5 * ttl:
            return -1
        return self._sched.class_of(r).rank

    def _admission_cost_locked(self, req) -> Optional[int]:
        """Caller holds ``self._cond``.  Pure fit check: the pages this
        admission would newly reserve (its DRR cost, at least 1), or None
        when it does not fit now.  A cached prefix reserves only the
        un-shared pages plus the shared pages no other live sharer pins
        yet."""
        shared_tok, newly_pinned = (
            self.cache.probe_prefix(req.prompt) if self.prefix_cache
            else (0, 0))
        need = (self._pages_for(req)
                - shared_tok // self.cache.page_size + newly_pinned)
        if self._reserved_pages + need > self.cache.total_pages:
            return None
        # the draft pool reserves the whole worst case (no prefix sharing
        # there: the draft ingests whole prompts); both pools fit or
        # neither is reserved
        if req.use_draft and self._reserved_draft_pages \
                + self._pages_for(req) > self.draft_cache.total_pages:
            return None
        # stashed for _finalize_admission_locked: nothing can change the
        # pool between this check and the commit (same lock hold)
        req._admit_plan = (need, shared_tok)
        return max(1, need)

    def _finalize_admission_locked(self, req) -> None:
        """Caller holds ``self._cond``.  Reserve the worst-case pages,
        assign the sequence id, acquire any cached prefix and stamp the
        admission."""
        need, shared_tok = req._admit_plan
        req._admit_plan = None
        self._reserved_pages += need
        if req.use_draft:
            self._reserved_draft_pages += self._pages_for(req)
            req._draft_reserved = True
        req.seq_id = self._next_seq
        self._next_seq += 1
        if shared_tok:
            got = self.cache.acquire_prefix(req.seq_id, req.prompt)
            if got != shared_tok:
                raise RuntimeError(
                    f"prefix probe found {shared_tok} tokens but acquire "
                    f"mapped {got}")
            req.prefix_tokens = got
        req.prefill_pos = req.prefix_tokens
        req.admitted_at = time.perf_counter()
        self._sched.note_admitted(req, req.admitted_at)
        if self.journal is not None:
            # the admitted mark drops the met queue-wait deadline on
            # recovery, as a snapshot does
            self._jadm.append(req.request_id)
            if req.prefix_tokens:
                self._journal_pages(req, "acquired", req.prefix_tokens)
        _tracer.request_event(
            req.request_id, "admitted", cls=req.priority,
            seq_id=req.seq_id, prefix_tokens=req.prefix_tokens,
            queue_wait_s=round(req.admitted_at - req.submitted_at, 6))

    def _tpot_parked_locked(self, r) -> bool:
        """Caller holds ``self._cond``.  True while a row the TPOT trigger
        parked must stay parked: some active row's TPOT budget is still
        breached by the measured step time.  The aging boost (half the
        resume TTL) overrides, so parking never starves a row past the
        reservation bound; once no active row breaches, the row resumes
        through the ordinary path."""
        if not r._tpot_parked:
            return False
        if self._preempt_rank_locked(r) < self._sched.class_of(r).rank:
            return False                       # the aging boost won
        ewma = self._step_ewma
        if ewma is None:
            return False
        for a in self._active:
            budget = self._sched.class_of(a).tpot_budget_s
            if budget is not None and ewma > budget:
                return True
        return False

    def _best_preempted_locked(self) -> Optional[_Request]:
        """Caller holds ``self._cond``.  The paused request that should
        resume first: most urgent effective class (aging boost
        included), then preemption order.  Rows the TPOT trigger parked
        stay out while the breach that parked them lasts: resuming one
        into the still too slow batch would undo the pause."""
        cands = [r for r in self._preempted
                 if not self._tpot_parked_locked(r)]
        if not cands:
            return None
        return min(cands,
                   key=lambda r: (self._preempt_rank_locked(r),
                                  self._preempted.index(r)))

    def _preemption_victim_locked(self, rank: int) -> Optional[_Request]:
        """Caller holds ``self._cond``.  The request to pause so a
        rank-``rank`` request can take its slot: the least urgent
        preemptible prefilling request strictly outranked by the waiter,
        preferring the least prefill progress (cheapest pause); with
        ``decode_preempt`` and no such prefill, the least urgent
        preemptible decoding row, preferring the fewest tokens decoded.
        Effective rank, so an aging-boosted request is immune."""
        victims = [r for r in self._prefilling
                   if self._sched.class_of(r).preemptible
                   and self._preempt_rank_locked(r) > rank]
        if victims:
            return max(victims,
                       key=lambda r: (self._sched.class_of(r).rank,
                                      -r.prefill_pos))
        if not self.decode_preempt:
            return None
        victims = [r for r in self._active
                   if self._sched.class_of(r).preemptible
                   and self._preempt_rank_locked(r) > rank]
        if not victims:
            return None
        return max(victims,
                   key=lambda r: (self._sched.class_of(r).rank,
                                  -len(r.generated)))

    def _pause_locked(self, victim, for_rank: int) -> None:
        """Caller holds ``self._cond``.  Move a preemption victim,
        mid-prefill or mid-decode, onto the paused list (seq id, pages
        and reservation all kept; a decoding row keeps its pending
        ``next_token``) for a waiter of rank ``for_rank``."""
        if victim in self._prefilling:
            self._prefilling.remove(victim)
        else:
            self._active.remove(victim)
            _decode_preempt_total.inc()
        victim.preempted_at = time.perf_counter()
        self._preempted.append(victim)
        self._sched.note_preempted(victim)
        _tracer.request_event(
            victim.request_id, "preempt", for_rank=for_rank,
            prefill_pos=victim.prefill_pos,
            decoded=len(victim.generated))

    def _resume_locked(self, pre) -> None:
        """Caller holds ``self._cond``.  Un-pause a request: its pause
        time banks into ``paused_total`` and chunking continues from
        ``prefill_pos`` (it is never prefilled again).  A row paused
        mid-decode (first token out, next token pending) rejoins the
        decode batch directly: the chunk planner has no work for it."""
        self._preempted.remove(pre)
        if pre.preempted_at is not None:
            pre.paused_total += time.perf_counter() - pre.preempted_at
            pre.preempted_at = None
        pre._tpot_parked = False
        if pre.first_token_at is not None \
                and pre.prefill_pos >= len(pre.prefill_target):
            self._active.append(pre)
        else:
            self._prefilling.append(pre)
        self._sched.note_resumed(pre)
        _tracer.request_event(pre.request_id, "resume",
                              prefill_pos=pre.prefill_pos,
                              decoded=len(pre.generated),
                              paused_s=round(pre.paused_total, 6))

    def _tpot_preempt_locked(self) -> None:
        """Caller holds ``self._cond``.  The TPOT trigger: at full
        occupancy, when the loop's measured iteration time (an EWMA over
        iterations with active rows: for an active row one iteration is
        one output token) breaches a running row's ``tpot_budget_s``,
        pause the least urgent preemptible decoding row so the smaller
        batch steps faster.  At most once a
        ``tpot_preempt_cooldown_s``; the parked row stays out while the
        breach lasts (``_tpot_parked_locked``) and its pause counts
        toward the aging and reap clocks."""
        if not self.decode_preempt or not self._active:
            return
        if len(self._active) + len(self._prefilling) < self.max_batch:
            return
        ewma = self._step_ewma
        if ewma is None:
            return
        now = time.perf_counter()
        if now - self._tpot_last_preempt < self.tpot_preempt_cooldown_s:
            return
        breached = [r for r in self._active
                    if self._sched.class_of(r).tpot_budget_s is not None
                    and ewma > self._sched.class_of(r).tpot_budget_s]
        if not breached:
            return
        urgent = min(self._sched.class_of(r).rank for r in breached)
        victims = [r for r in self._active
                   if self._sched.class_of(r).preemptible
                   and self._preempt_rank_locked(r) > urgent]
        if not victims:
            return
        victim = max(victims,
                     key=lambda r: (self._sched.class_of(r).rank,
                                    -len(r.generated)))
        self._pause_locked(victim, urgent)
        victim._tpot_parked = True
        self._tpot_last_preempt = now

    def _admit_locked(self) -> None:
        """Caller holds ``self._cond``.  Fill free slots from (a) paused
        requests, which resume for free (their pages are reserved), and
        (b) the scheduler's queues in weighted-DRR order; when every slot
        is held and a more urgent class waits, pause a preemptible
        request and hand its slot over.  Under sustained urgent load a
        preemptible request stays paused (that is the priority contract)
        holding its reservation; ``preempt_resume_ttl_s`` bounds that."""
        pending_rank = None     # rank a preemption just freed a slot for
        while True:
            slots = (self.max_batch - len(self._active)
                     - len(self._prefilling))
            qrank = self._sched.min_waiting_rank()
            pre = self._best_preempted_locked()
            if slots <= 0:
                if qrank is None:
                    break
                victim = self._preemption_victim_locked(qrank)
                head = self._sched.peek_urgent()
                if victim is None or head is None \
                        or self._admission_cost_locked(head) is None:
                    break
                self._pause_locked(victim, qrank)
                pending_rank = qrank
                continue
            if pending_rank is None and pre is not None and (
                    qrank is None
                    or self._preempt_rank_locked(pre) <= qrank):
                self._resume_locked(pre)
                continue
            # a slot bought with a preemption belongs to the rank it was
            # bought for: a less urgent class's banked deficit must not
            # take it (that would pause one batch prefill to start
            # another)
            req = self._sched.pop_next(self._admission_cost_locked,
                                       max_rank=pending_rank)
            pending_rank = None
            if req is None:
                if pre is not None:
                    self._resume_locked(pre)
                    continue
                break
            self._finalize_admission_locked(req)
            self._prefilling.append(req)
        _queue_depth.set(len(self._sched))

    def _plan_chunks_locked(self) -> List:
        """Caller holds ``self._cond``.  (request, n_tokens) prefill work
        for this iteration, most urgent class first (admission order
        within a class): whole remaining prompts without a chunk budget,
        else at most ``prefill_chunk_tokens`` tokens, each request's
        chunk full-size or its prompt's tail (never split to fit the
        budget's leftover, so chunk shapes stay position-derived).  A
        request whose chunk the budget gave to a more urgent class is
        counted as deferred (same-class queueing is not a deferral)."""
        if not self._prefilling:
            return []
        order = sorted(
            range(len(self._prefilling)),
            key=lambda i: (self._sched.class_of(
                self._prefilling[i]).rank, i))
        chunk = self.prefill_chunk_tokens
        plan: List = []
        budget = chunk
        best_served_rank: Optional[int] = None
        for i in order:
            req = self._prefilling[i]
            remaining = len(req.prefill_target) - req.prefill_pos
            if remaining <= 0:
                continue
            if budget is None:
                plan.append((req, remaining))
                continue
            rank = self._sched.class_of(req).rank
            if budget <= 0:
                if best_served_rank is not None \
                        and rank > best_served_rank:
                    self._sched.note_chunk_deferred(req)
                continue
            n = min(remaining, chunk)
            plan.append((req, n))
            if best_served_rank is None or rank < best_served_rank:
                best_served_rank = rank
            budget -= n
        return plan

    @staticmethod
    def _row_sampling(reqs, n: Optional[int] = None):
        """(seeds, temps, flags) for the sampling tail, padded to ``n``
        rows (default ``len(reqs)``); a None entry and a pad row draw
        nothing."""
        n = len(reqs) if n is None else n
        seeds = np.zeros(n, np.uint32)
        temps = np.ones(n, np.float32)
        flags = np.zeros(n, bool)
        for i, r in enumerate(reqs):
            if r is None:
                continue
            seeds[i] = r.seed
            temps[i] = max(r.temperature, 1e-6)
            flags[i] = r.do_sample
        return seeds, temps, flags

    def _sampling_for(self, reqs, ctrs):
        """(seeds, ctrs, temps, flags), padded to ``len(ctrs)`` rows (pad
        rows draw nothing), as in the JAX engine: ``ctrs`` is each row's
        absolute token position, the counter of its draw."""
        seeds, temps, flags = self._row_sampling(reqs, len(ctrs))
        return seeds, np.asarray(ctrs, np.int32), temps, flags

    def _pick(self, req, logits_row) -> int:
        """Host-side sampling (``sample_on_device=False``): the JAX
        engine's ``sample_token`` on the request's numpy generator."""
        return sample_token(np.asarray(torch.as_tensor(logits_row)
                                       .float().cpu()),
                            req.do_sample, req.temperature, req.rng)

    def _ingest(self, decoder, cache, sid, tokens, k: int, n: int,
                sampling):
        """One bucketed prompt-ingest dispatch of tokens[k:k+n] into
        ``sid``'s pages: fresh prefill at k == 0, the context-prefill
        continuation otherwise.  The serving prefill (``_prefill_chunk``)
        and the replay (``_replay_kv``) both come here, so a replay takes
        the steps of the path it replays."""
        ids = tokens[None, k:k + n]
        if k:
            return decoder.chunk_prefill(cache, [sid], ids,
                                         context_tokens=k,
                                         sampling=sampling)
        return decoder.prefill(cache, [sid], ids, sampling=sampling)

    def _prefill_chunk(self, req, n: int) -> bool:
        """Ingest the next ``n`` tokens of ``req``'s prefill target (its
        prompt, or a restored request's prompt + generated) in one step;
        True once the target is resident (only then is the next token
        sampled, at its absolute position).  Fires ``prefill`` on the
        request's first chunk and ``prefill_chunk`` on every one.  A
        dispatch the watchdog flagged raises :class:`_EngineWedged` with
        the cache rolled back to the chunk's start."""
        target = req.prefill_target
        k = req.prefill_pos
        total = len(target)
        n = min(n, total - k)
        last = k + n == total
        if not self.sample_on_device:
            sampling = None
        else:
            sampling = self._sampling_for([req if last else None], [total])
        self._wedged.clear()      # only this dispatch may flag itself
        t0 = self._step_started_at = time.monotonic()
        t_tr = _tracer.now_ns() if _tracer.enabled else 0
        try:
            if k == req.prefix_tokens:
                # per-sequence site, once: chunking must not change
                # existing fault plans' semantics
                _faults.maybe_fire("prefill", seq_ids=[req.seq_id])
            _faults.maybe_fire("prefill_chunk", seq_ids=[req.seq_id])
            self._count_dispatch("chunk" if k else "prefill")
            with monitor.span("engine/prefill", histogram=_prefill_s):
                out = self._ingest(self._decoder, self.cache, req.seq_id,
                                   target, k, n, sampling)
        finally:
            self._step_started_at = None
        _last_step_ts.set(time.time())
        try:
            self._check_wedged(t0)
        except _EngineWedged:
            # the chunk's writes are suspect: back to its start, so the
            # rebuild, replay and retry are exact
            self.cache.truncate(req.seq_id, k)
            raise
        req.prefill_pos = k + n
        req.chunks_done += 1
        self._sched.note_chunk(req)
        if _tracer.enabled and t_tr:
            # t_tr == 0: the window opened mid-dispatch, no slice
            _tracer.step_record(
                "prefill_chunk", self.steps, t_tr, _tracer.now_ns(),
                request=req.request_id, tokens=n, pos=k,
                cls=req.priority)
            _tracer.request_event(req.request_id, "prefill_chunk",
                                  tokens=n, pos=k, chunk=req.chunks_done)
        if last:
            self._finish_prefill(req, out[0], sampling is not None)
        return last

    def _finish_prefill(self, req, out_row, sampled: bool) -> None:
        """The prefill target is resident: register the prompt's
        prefixes, ingest the draft's copy, latch the first token (a
        restored request keeps its journaled one) and stamp the time to
        first token."""
        if self.prefix_cache:
            _prefix_lookups.inc()
            if req.prefix_tokens:
                _prefix_hits.inc()
                _prefix_hit_tokens.inc(req.prefix_tokens)
            self.cache.register_prefix(req.seq_id, req.prompt)
            self._journal_pages(req, "registered", len(req.prompt))
        if req.use_draft:
            # the draft ingests the whole target (its pool shares no
            # prefix), so its cache sits at the target's length: the
            # lockstep every proposal and verify keeps.  Only at prefill
            # completion, so a request paused mid-prefill never touched
            # the draft pool.  The token it draws is discarded
            try:
                self._count_dispatch("draft")
                self._draft_decoder.prefill(self.draft_cache, [req.seq_id],
                                            req.prefill_target[None],
                                            sampling=_null_sampling())
            except Exception:  # noqa: BLE001 — downgrade, don't fail
                self._downgrade_draft([req])
        if req.next_token is None:
            # a restored request's journaled token equals the replayed
            # draw; on the host sampler a new pick would burn a draw
            req.next_token = (int(out_row) if sampled
                              else self._pick(req, out_row))
        req.first_token_at = time.perf_counter()
        ttft = req.first_token_at - req.submitted_at
        _ttft_s.observe(ttft)
        self._sched.note_first_token(req, ttft)
        _tracer.request_event(req.request_id, "first_token",
                              ttft_s=round(ttft, 6))
        if self.journal is not None:
            # no token appended yet, but the first pending token is host
            # state a SIGKILL must not lose
            self._jrows.append((req.request_id, (), req.next_token))

    def _run_chunks(self, plan) -> None:
        """One dispatch a planned chunk (device work, called without the
        lock).  A failing chunk quarantines exactly its request: the
        decoder already rolled the failed dispatch back, retirement
        reclaims the pages every earlier chunk wrote, and if the failure
        lost the pools the other requests are replayed before the next
        dispatch.  A wedged chunk is retried once, after the rebuild."""
        completed, failed = [], []
        for req, n in plan:
            if req.cancelled or req.done.is_set():
                # cancelled: the next reap retires it; done: its replay
                # failed in an earlier chunk's recovery
                continue
            try:
                if self._prefill_chunk(req, n):
                    completed.append(req)
            except _EngineWedged as e:
                # pools zeroed, every survivor replayed (this request's
                # earlier chunks too), then the same chunk once more
                self._after_step_failure(e)
                if req.done.is_set():
                    # its own replay failed: already quarantined
                    continue
                try:
                    if self._prefill_chunk(req, n):
                        completed.append(req)
                except Exception as e2:  # noqa: BLE001 — quarantine
                    req.error = e2
                    failed.append(req)
                    self._after_step_failure(e2, exclude=(req,))
            except Exception as e:  # noqa: BLE001 — quarantine this one
                req.error = e
                failed.append(req)
                # a lost pool zeroed every other sequence's KV too:
                # replay them before the next dispatch (a no-op when no
                # pool was lost)
                self._after_step_failure(e, exclude=(req,))
        if not completed and not failed:
            return
        with self._cond:
            for r in failed:
                if r in self._prefilling:
                    self._prefilling.remove(r)
                # quarantine before retire: the timeline's last event is
                # the retirement at every ejection site
                self._quarantine(r)
                self._retire_locked(r)
            for r in completed:
                if r in self._prefilling:
                    self._prefilling.remove(r)
                    self._active.append(r)
            self._cond.notify_all()
        for r in failed:
            r.done.set()

    # ------------------------------------------ legacy composition
    def _legacy_iteration(self) -> bool:
        """True when this iteration must run the legacy composition: the
        ``unified_step=False`` escape hatch, the repeated-failure latch,
        or an installed fault plan targeting the legacy dispatch sites
        (their quarantine semantics are defined per legacy dispatch —
        one poisoned chunk fails one request — which a single ragged
        step would widen).  Delay-kind rules on the dispatch sites
        themselves are pacing, not failure injection: the unified step
        fires those sites itself, so they do not divert."""
        if not self.unified_step or self._unified_off:
            return True
        plan = _faults.active()
        return plan is not None and any(
            r.site in _ENGINE_FAULT_SITES
            and not (r.kind == "delay" and r.site in _PACING_FAULT_SITES)
            for r in plan.rules)

    def _bucket(self, n: int) -> int:
        return min(next_pow2(n), self.max_batch)

    def _propose_drafts(self, reqs) -> np.ndarray:
        """(len(reqs), spec_tokens) draft proposals: ONE ``multi_step`` of
        spec_tokens + 1 greedy steps on the draft decoder for the rows
        that speculate (it feeds the last token and every proposal, so
        the draft cache covers them all), padded to a bucket with rows
        on the draft pool's scratch sequence.  The other rows, and all of
        them when the draft fails (they are downgraded), get -1, which
        never matches: they advance one token, as in a plain step."""
        k = self.spec_k
        drafts = np.full((len(reqs), k), -1, np.int32)
        d_idx = [i for i, r in enumerate(reqs) if r.use_draft]
        if not d_idx:
            return drafts
        npad = self._bucket(len(d_idx)) - len(d_idx)
        d_seqs = [reqs[i].seq_id for i in d_idx]
        d_tok = np.zeros(len(d_idx) + npad, np.int32)
        d_pos = np.zeros(len(d_idx) + npad, np.int32)
        for j, i in enumerate(d_idx):
            d_tok[j] = reqs[i].generated[-1]
            d_pos[j] = self.draft_cache.length(d_seqs[j])
        if npad:
            self.draft_cache.truncate(_PAD_SEQ, 0)
            d_seqs += [_PAD_SEQ] * npad
        try:
            self._count_dispatch("draft")
            prop = self._draft_decoder.multi_step(
                self.draft_cache, d_seqs, d_tok, d_pos, k + 1)
        except Exception:  # noqa: BLE001 — downgrade, don't fail
            self._downgrade_draft([reqs[i] for i in d_idx])
        else:
            for j, i in enumerate(d_idx):
                drafts[i] = prop[j, :k]
        return drafts

    def _note_spec(self, accepts) -> None:
        """Count a speculative step's outcome: ``accepts`` holds the
        accept count of every row that proposed."""
        k = self.spec_k
        self.last_spec = (k * len(accepts), sum(accepts))
        self.spec_proposed += k * len(accepts)
        self.spec_accepted += sum(accepts)
        for a in accepts:
            self.spec_accept_lens[a] += 1
            self.spec_rollbacks += a < k
        if accepts:
            _spec_proposed.inc(k * len(accepts))
            _spec_accepted.inc(sum(accepts))
            rejected = 0
            for a in accepts:
                _spec_accept_len.observe(a)
                rejected += a < k
            if rejected:
                _spec_rollback.inc(rejected)
        _spec_draft_pages.set(self.draft_cache.pinned_pages)

    def _exec_spec_step(self, reqs) -> List[_SpecRow]:
        """ONE speculative step for ``reqs`` (the legacy composition's):
        the draft proposes (``_propose_drafts``), then the target scores
        the whole (bucket, spec_tokens + 1) block in ONE ``verify`` step,
        padded with rows on the scratch sequence; the accept counts and
        bonus tokens come from the device.  Both caches are truncated
        here to each row's verified length pos + accept + 1.  Replays
        identically after a rollback (a greedy draft, the same draw
        counters), which retry and bisection depend on."""
        k = self.spec_k
        b = self._bucket(len(reqs))
        npad = b - len(reqs)
        # a flag raised against an earlier dispatch must not condemn
        # this one; the heartbeat covers the proposal and the verify
        self._wedged.clear()
        t0 = self._step_started_at = time.monotonic()
        try:
            step_ids = [r.seq_id for r in reqs]
            _faults.maybe_fire("decode_step", seq_ids=step_ids)
            _faults.maybe_fire("engine_wedge", seq_ids=step_ids)
            with monitor.span("engine/decode_step",
                              histogram=_decode_step_s):
                drafts = self._propose_drafts(reqs)
                block = np.zeros((b, k + 1), np.int32)
                pos = np.zeros(b, np.int32)
                seq_ids = []
                for i, r in enumerate(reqs):
                    block[i, 0] = r.generated[-1]
                    block[i, 1:] = drafts[i]
                    pos[i] = self.cache.length(r.seq_id)
                    seq_ids.append(r.seq_id)
                if npad:
                    self.cache.truncate(_PAD_SEQ, 0)
                    seq_ids.extend([_PAD_SEQ] * npad)
                # the draw's counter, pos + accept + 1, is computed on
                # the device, so a sampled row draws where a plain step
                # would
                sampling = (self._row_sampling(reqs, b)
                            if self.sample_on_device else None)
                self._count_dispatch("verify")
                out, accept = self._decoder.verify(
                    self.cache, seq_ids, block, pos, sampling=sampling)
                self._check_wedged(t0)
        finally:
            self._step_started_at = None
        _last_step_ts.set(time.time())
        rows = []
        for i, r in enumerate(reqs):
            a = int(accept[i])
            # partial rollback: the rejected positions' lengths unwind on
            # both caches; their pages stay mapped and later steps
            # rewrite their slots
            new_len = int(pos[i]) + a + 1
            self.cache.truncate(r.seq_id, new_len)
            if r.use_draft:
                self.draft_cache.truncate(r.seq_id, new_len)
            rows.append(_SpecRow(out[i], a, drafts[i]))
        self._note_spec([int(accept[i]) for i, r in enumerate(reqs)
                         if r.use_draft])
        return rows

    def _exec_step(self, reqs) -> list:
        """ONE decode step for ``reqs`` (all of, or a bisected subset of,
        the active batch), padded to ``min(next_pow2(n), max_batch)``
        rows; with a draft and a row of ``reqs`` that speculates, one
        speculative step (``_exec_spec_step``).  Tokens, positions and
        draw counters come from request and cache state, so a
        rolled-back step replays identically, which retry and bisection
        depend on.  Returns one output per request (the sampled id, or
        the logits row; a :class:`_SpecRow` when speculative)."""
        if self._spec and any(r.use_draft for r in reqs):
            return self._exec_spec_step(reqs)
        self.last_spec = (0, 0)
        b = self._bucket(len(reqs))
        npad = b - len(reqs)
        # the new token enters the sequence now: its rope position
        # (== current length) is read before the write
        tokens = np.zeros((b, 1), np.int32)
        pos = np.zeros(b, np.int32)
        seq_ids = []
        for i, r in enumerate(reqs):
            tokens[i, 0] = r.generated[-1]
            pos[i] = self.cache.length(r.seq_id)
            seq_ids.append(r.seq_id)        # the decoder allocates pages
        if npad:
            # pad rows: the scratch sequence rewrites its slot 0 every
            # step, one row after another, and its page stays across
            # steps until the engine goes idle.  Truncate FIRST: its
            # length grew by the pad count last step, and allocating
            # against that could demand a second page
            self.cache.truncate(_PAD_SEQ, 0)
            self.cache.allocate(_PAD_SEQ, 1)    # no-op while held
            seq_ids.extend([_PAD_SEQ] * npad)
        sampling = (self._sampling_for(reqs, pos + 1)
                    if self.sample_on_device else None)
        self._wedged.clear()
        t0 = self._step_started_at = time.monotonic()
        try:
            # the faults fire before the decoder runs, so never inside a
            # CUDA graph's capture
            _faults.maybe_fire("decode_step", seq_ids=seq_ids[:len(reqs)])
            _faults.maybe_fire("engine_wedge", seq_ids=seq_ids[:len(reqs)])
            with monitor.span("engine/decode_step",
                              histogram=_decode_step_s):
                self._count_dispatch("decode")
                out = self._decoder.step(self.cache, seq_ids, tokens, pos,
                                         sampling=sampling)
                self._check_wedged(t0)
        finally:
            self._step_started_at = None
        _last_step_ts.set(time.time())
        return [out[i] for i in range(len(reqs))]

    def _lengths(self, reqs) -> dict:
        """seq id -> (target length, draft length or None) before a
        step, what a failed attempt rolls back to."""
        return {r.seq_id: (self.cache.length(r.seq_id),
                           (self.draft_cache.length(r.seq_id)
                            if r.use_draft else None))
                for r in reqs}

    def _rollback_step(self, reqs, lens_before) -> None:
        """Restore pre-step lengths after a failed attempt (the decoder
        rolls back its own advance; this covers faults fired before it
        ran, and a draft proposal that ran before the verify failed).
        Pages stay mapped: they are inside the admission reservation and
        the replay rewrites their slots."""
        for r in reqs:
            tgt, dft = lens_before[r.seq_id]
            self.cache.truncate(r.seq_id, tgt)
            if dft is not None:
                self.draft_cache.truncate(r.seq_id, dft)

    def _step_isolated(self, reqs, lens_before):
        """(survivors, rows, poisoned) for one logical decode step: try
        the whole batch; on failure retry once (transient faults), then
        bisect to isolate the poisoned sequence(s) instead of erroring
        everyone.  After a failure that lost the pools (or a wedge) every
        survivor's KV is replayed before the retry, so it never decodes
        over zeroed pages; a row whose own replay failed leaves the retry
        as poisoned."""
        try:
            return reqs, self._exec_step(reqs), []
        except Exception as e:  # noqa: BLE001 — retried below
            self._rollback_step(reqs, lens_before)
            live, poisoned = self._split_replay_dead(
                reqs, self._after_step_failure(e, in_step=True))
        self.decode_retries += 1
        _decode_retries.inc()
        if not live:
            return [], [], poisoned
        try:
            return live, self._exec_step(live), poisoned
        except Exception as e2:  # noqa: BLE001 — bisected below
            self._rollback_step(live, lens_before)
            live, dead = self._split_replay_dead(
                live, self._after_step_failure(e2, in_step=True))
            poisoned += dead
            if not live:
                return [], [], poisoned
            s, o, p = self._bisect_step(live, lens_before, e2)
            return s, o, p + poisoned

    def _split_replay_dead(self, reqs, dead):
        """(live, quarantined): ``reqs`` split around ``dead``, the rows
        whose replay failed (their error is already set); each dead row
        counts as a quarantine."""
        if not dead:
            return list(reqs), []
        dead_ids = {id(r) for r in dead}
        live, out = [], []
        for r in reqs:
            if id(r) in dead_ids:
                self._quarantine(r)
                out.append(r)
            else:
                live.append(r)
        return live, out

    def _bisect_step(self, reqs, lens_before, error):
        """Deterministic fault isolation: halve the failing batch and
        replay each half (solo replay at size 1).  Healthy halves advance
        their token normally; a size-1 failure quarantines that request
        with the error that killed it.  O(k log n) extra step attempts
        for k poisoned sequences in a batch of n."""
        if len(reqs) == 1:
            r = reqs[0]
            r.error = error
            self._quarantine(r)
            return [], [], [r]
        mid = (len(reqs) + 1) // 2
        survivors, rows, poisoned = [], [], []
        for half in (reqs[:mid], reqs[mid:]):
            # a row whose replay failed in a sibling's recovery carries
            # its error: never step it again (_decode_step retires it)
            half = [r for r in half if r.error is None]
            if not half:
                continue
            self.decode_retries += 1
            _decode_retries.inc()
            try:
                half_rows = self._exec_step(half)
            except Exception as e:  # noqa: BLE001 — bisected further
                self._rollback_step(half, lens_before)
                # a lost pool zeroed the other half's KV too, advanced or
                # not: replay everyone before probing on
                live, dead = self._split_replay_dead(
                    half, self._after_step_failure(e, in_step=True))
                poisoned.extend(dead)
                if live:
                    s, o, p = self._bisect_step(live, lens_before, e)
                    survivors.extend(s)
                    rows.extend(o)
                    poisoned.extend(p)
            else:
                survivors.extend(half)
                rows.extend(half_rows)
        return survivors, rows, poisoned

    def _decode_step(self) -> None:
        """One token for every active sequence, padded to a bucket;
        failures are isolated per sequence (retry, then bisect) rather
        than erroring the whole batch."""
        active = self._active
        lens_before = self._lengths(active)
        for r in active:
            r.generated.append(r.next_token)
        self._note_batch(active)
        t_tr = _tracer.now_ns() if _tracer.enabled else 0
        survivors, rows, poisoned = self._step_isolated(active, lens_before)
        # a row whose replay failed outside the failing subset's scope
        # (its half had stepped already, or had not yet) carries its
        # error: retire it here, never leave it decoding over a half
        # rebuilt cache.  A row whose token executed retires without the
        # pop; one that never stepped joins the poisoned
        dead_done = []
        if any(r.error is not None for r in survivors):
            pairs = list(zip(survivors, rows))
            survivors, rows = [], []
            for r, row in pairs:
                if r.error is not None:
                    self._quarantine(r)
                    dead_done.append(r)
                else:
                    survivors.append(r)
                    rows.append(row)
        accounted = ({id(r) for r in survivors} | {id(r) for r in poisoned}
                     | {id(r) for r in dead_done})
        for r in active:
            if id(r) not in accounted and not r.done.is_set() \
                    and r.error is not None:
                self._quarantine(r)
                poisoned.append(r)
        if _tracer.enabled and t_tr:
            # the step's wall time includes its retries and bisection
            # probes: that is this step's cost (t_tr == 0: the window
            # opened mid-dispatch, no slice)
            self._step_trace(active, t_tr, _tracer.now_ns(),
                             len(poisoned))
        still, retired = self._advance_rows(survivors, rows,
                                            self.sample_on_device)
        for r in poisoned:
            # the token recorded for this step never executed
            r.generated.pop()
        ended = retired + poisoned + dead_done
        with self._cond:
            self.steps += 1
            for r in ended:
                self._retire_locked(r)
            self._active = still
            if not still:
                # idle: the scratch pages go back too, before the
                # waiters wake, so a drained engine reports whole pools
                self._free_pads_locked()
            self._cond.notify_all()
        _active_seqs.set(len(still))
        for r in ended:
            r.done.set()

    def _note_batch(self, active) -> None:
        """A step with ``active`` rows begins: the batch gauges."""
        _active_seqs.set(len(active))
        _batch_occupancy.observe(len(active) / self.max_batch)
        # the gauge is process-wide, so the engine that steps asserts its
        # mode again every step
        _sampling_on_device_g.set(int(self.sample_on_device))

    def _step_trace(self, active, t_start: int, t_end: int,
                    poisoned: int) -> None:
        """One decode step on the tracer's step track: the batch's
        composition by class, the speculative economics and the
        requests."""
        comp: dict = {}
        for r in active:
            comp[r.priority] = comp.get(r.priority, 0) + 1
        prop, acc = self.last_spec
        _tracer.step_record(
            "decode", self.steps, t_start, t_end, batch=len(active),
            classes=comp, spec_proposed=prop, spec_accepted=acc,
            poisoned=poisoned, requests=[r.request_id for r in active])

    def _advance_rows(self, reqs, rows, sampled: bool):
        """(still, retired) after a decode or verify step: a request that
        hit eos or its budget retires, the others latch their next token.
        A speculative row first takes its accepted drafts one by one,
        with the same eos and budget checks a plain step applies a token
        at a time, so its stream is target-only greedy's token for
        token."""
        still, retired = [], []
        _tokens_total.inc(len(reqs))
        accepted_emitted = 0
        for r, row in zip(reqs, rows):
            # this step appended one token before it ran; the journal
            # row carries it and any accepted drafts
            j0 = len(r.generated) - 1
            if _tracer.enabled:
                if isinstance(row, _SpecRow):
                    _tracer.request_event(
                        r.request_id, "verify_step", step=self.steps,
                        accept=int(row.accept))
                else:
                    _tracer.request_event(r.request_id, "decode_step",
                                          step=self.steps)
            eos_hit = (r.eos_token_id is not None
                       and r.generated[-1] == r.eos_token_id)
            if eos_hit or len(r.generated) >= r.max_new_tokens:
                retired.append(r)
                continue
            if isinstance(row, _SpecRow):
                done = False
                for t in row.drafts[:row.accept]:
                    r.generated.append(int(t))
                    accepted_emitted += 1
                    if (r.eos_token_id is not None
                            and int(t) == r.eos_token_id) \
                            or len(r.generated) >= r.max_new_tokens:
                        done = True
                        break
                if done:
                    retired.append(r)
                    continue
                row = row.out
            r.next_token = int(row) if sampled else self._pick(r, row)
            still.append(r)
            if self.journal is not None:
                # a continuing row only: a retiring one's retire record
                # drops it, and a crash before that replays its last
                # step to the same tokens
                self._jrows.append((r.request_id, r.generated[j0:],
                                    r.next_token))
        if accepted_emitted:
            _tokens_total.inc(accepted_emitted)
        return still, retired

    # ------------------------------------------------ unified ragged step
    def _unified_rollback(self, chunks, active, lens_before) -> None:
        """Undo the unified composition after a failed ragged step, so
        the legacy re-run replays the exact same step: appended decode
        tokens pop and every row's length returns to its pre-step value
        in both caches (the decoder rolled its own advance back; this
        covers a fault fired before it ran, a wedged step's advance and
        the draft's proposal)."""
        for req, _target, k, _n, _last in chunks:
            self.cache.truncate(req.seq_id, k)
        for r in active:
            r.generated.pop()
        self._rollback_step(active, lens_before)

    def _unified_step(self, plan) -> None:
        """ONE ragged step for the iteration: the planned prompt chunks
        plus every active row's decode token, or, when a row speculates,
        every active row as a (spec_tokens + 1)-token verify row of
        freshly proposed drafts (-1 for the rows that do not speculate).
        Chunk bookkeeping, prefill completion, the accept counts (both
        caches truncated to the verified length) and retirement
        follow.  On an injected fault, or a step the watchdog flagged as
        wedged, the composition unwinds, a lost pool is rebuilt and the
        survivors replayed, and the iteration re-runs through the legacy
        composition, whose retry and bisection own failure isolation; 3
        such failures in a row latch the unified path off.  Any other
        failure unwinds and fails the step's requests alone (see the
        module docstring)."""
        chunks = []
        for req, n in plan:
            if req.cancelled or req.done.is_set():
                continue
            target = req.prefill_target
            k = req.prefill_pos
            n = min(n, len(target) - k)
            chunks.append((req, target, k, n, k + n == len(target)))
        active = list(self._active)
        if not chunks and not active:
            return
        spec = self._spec and any(r.use_draft for r in active)
        lens_before = self._lengths(active)
        for r in active:
            r.generated.append(r.next_token)
        if active:
            self._note_batch(active)
        t_tr = _tracer.now_ns() if _tracer.enabled else 0
        seq_ids, rows, ctxs = [], [], []
        for req, target, k, n, _last in chunks:
            seq_ids.append(req.seq_id)
            rows.append(target[k:k + n])
            ctxs.append(k)
        for r in active:
            seq_ids.append(r.seq_id)
            rows.append(np.asarray([r.generated[-1]], np.int32))
            ctxs.append(self.cache.length(r.seq_id))
        if self.sample_on_device:
            # intermediate chunk rows draw nothing; the counter of every
            # draw is computed in the step from the row's position
            sampling = self._row_sampling(
                [req if last else None for req, *_, last in chunks]
                + active)
        else:
            sampling = None
        try:
            drafts = None
            if spec:
                drafts = self._propose_drafts(active)
                for i in range(len(active)):
                    rows[len(chunks) + i] = np.concatenate(
                        [rows[len(chunks) + i], drafts[i]])
            self._wedged.clear()
            t0 = self._step_started_at = time.monotonic()
            try:
                # only delay-kind pacing rules can be live here
                # (_legacy_iteration diverts everything else): fire the
                # legacy sites so throttling plans pace the unified step
                # as they pace the composition it replaces
                for req, _target, k, _n, _last in chunks:
                    if not k:
                        _faults.maybe_fire("prefill", seq_ids=[req.seq_id])
                    _faults.maybe_fire("prefill_chunk",
                                       seq_ids=[req.seq_id])
                if active:
                    _faults.maybe_fire("decode_step",
                                       seq_ids=[r.seq_id for r in active])
                hist = _decode_step_s if active else _prefill_s
                with monitor.span("engine/ragged_step", histogram=hist):
                    self._count_dispatch("ragged")
                    out, accept = self._decoder.ragged_step(
                        self.cache, seq_ids, rows, ctxs,
                        n_drafts=([0] * len(chunks)
                                  + [self.spec_k] * len(active)
                                  if spec else None),
                        sampling=sampling)
                    self._check_wedged(t0)
            finally:
                self._step_started_at = None
            _last_step_ts.set(time.time())
        except (_faults.FaultError, _EngineWedged) as e:
            # the legacy re-run isolates; a wedge (the engine's own
            # watchdog) or a lost pool first rebuilds and replays the
            # survivors, so the re-run never decodes over zeroed pages
            self._unified_rollback(chunks, active, lens_before)
            self.unified_fallbacks += 1
            _unified_fallbacks.inc()
            self._unified_failures += 1
            if self._unified_failures >= 3:
                self._unified_off = True
            self._after_step_failure(e)
            self._run_chunks(plan)
            if self._active:
                self._decode_step()
            return
        except Exception as e:  # noqa: BLE001 — fail the step's requests
            self._unified_rollback(chunks, active, lens_before)
            failed = [req for req, *_ in chunks] + active
            self._after_step_failure(e, exclude=failed)
            self._quarantine_step([req for req, *_ in chunks], active, e)
            return
        self._unified_failures = 0
        now_ns = _tracer.now_ns() if _tracer.enabled and t_tr else 0
        nchunks = len(chunks)
        completed = []
        for i, (req, _target, k, n, last) in enumerate(chunks):
            req.prefill_pos = k + n
            req.chunks_done += 1
            self._sched.note_chunk(req)
            if _tracer.enabled and t_tr:
                _tracer.step_record(
                    "prefill_chunk", self.steps, t_tr, now_ns,
                    request=req.request_id, tokens=n, pos=k,
                    cls=req.priority)
                _tracer.request_event(req.request_id, "prefill_chunk",
                                      tokens=n, pos=k,
                                      chunk=req.chunks_done)
            if last:
                completed.append(req)
                self._finish_prefill(req, out[i], sampling is not None)
        outs = list(out[nchunks:])
        if spec:
            for i, r in enumerate(active):
                a = int(accept[nchunks + i])
                # partial rollback on both caches, as in _exec_spec_step
                new_len = lens_before[r.seq_id][0] + a + 1
                self.cache.truncate(r.seq_id, new_len)
                if r.use_draft:
                    self.draft_cache.truncate(r.seq_id, new_len)
                outs[i] = _SpecRow(outs[i], a, drafts[i])
            self._note_spec([int(accept[nchunks + i])
                             for i, r in enumerate(active) if r.use_draft])
        elif active:
            self.last_spec = (0, 0)
        if active and _tracer.enabled and t_tr:
            self._step_trace(active, t_tr, now_ns, 0)
        still, retired = self._advance_rows(active, outs,
                                            sampling is not None)
        with self._cond:
            if active:
                self.steps += 1
                for r in retired:
                    self._retire_locked(r)
                self._active = still
                if not still:
                    self._free_pads_locked()
            for r in completed:
                if r in self._prefilling:
                    self._prefilling.remove(r)
                    self._active.append(r)
            self._cond.notify_all()
        if active:
            _active_seqs.set(len(still))
        for r in retired:
            r.done.set()

    def _quarantine_step(self, prefilling, active, error) -> None:
        """Fail the requests of a rolled-back ragged step with its error:
        their pages and reservations go back, the queue is served on."""
        failed = prefilling + active
        with self._cond:
            self._prefilling = [r for r in self._prefilling
                                if r not in prefilling]
            self._active = [r for r in self._active if r not in active]
            if not self._active:
                self._free_pads_locked()
            for r in failed:
                r.error = error
                self._quarantine(r)
                self._retire_locked(r)
            self._cond.notify_all()
        for r in failed:
            r.done.set()

    def _retire_locked(self, req) -> None:
        """Caller holds ``self._cond``.  Free the request's pages and
        exactly the reservation its retirement uncovers: the worst-case
        pages it never allocated plus each held page that stopped being
        pinned (a page another sharer still maps keeps its
        reservation)."""
        slack = (self._pages_for(req)
                 - len(self.cache._seq_pages.get(req.seq_id, ())))
        released = self.cache.free(req.seq_id)
        self._reserved_pages -= slack + released
        self._release_draft_locked(req)
        req.finished_at = time.perf_counter()
        if req.error is None:
            _gen_latency_s.observe(req.finished_at - req.submitted_at)
        self._sched.note_retired(req)   # the class's TPOT
        self._cache_result_locked(req)
        self._journal_retire(req)
        _tracer.request_event(
            req.request_id, "retire", ok=req.error is None,
            generated=len(req.generated),
            latency_s=round(req.finished_at - req.submitted_at, 6))

    def _release_draft_locked(self, req) -> None:
        """Caller holds ``self._cond``.  Free the request's draft pages
        and exactly the reservation they covered (the draft pool has no
        prefix index, so every freed page is free).  Once only: a
        downgrade and the retirement both come here."""
        if not req._draft_reserved:
            return
        slack = (self._pages_for(req)
                 - len(self.draft_cache._seq_pages.get(req.seq_id, ())))
        released = self.draft_cache.free(req.seq_id)
        self._reserved_draft_pages -= slack + released
        req._draft_reserved = False

    def _downgrade_draft(self, reqs) -> None:
        """After a draft-side failure the requests decode on the plain
        path instead of failing, for the rest of their life (a draft
        cache out of lockstep cannot rejoin), and their draft pages go
        back at once."""
        _spec_draft_failures.inc(len(list(reqs)))
        with self._cond:
            for r in reqs:
                self.spec_draft_failures += 1
                r.use_draft = False
                self._release_draft_locked(r)

    # ------------------------------------------------------ crash recovery
    def _pools_rebuilt(self) -> bool:
        """True once for each pool loss: the caches' summed generation
        against the last value the engine reconciled.  Scheduler thread
        only."""
        g = self._generation()
        if g == self._pool_gen:
            return False
        self._pool_gen = g
        return True

    def _replay_kv(self, req, upto=None, dlen=None) -> None:
        """The replay primitive: rebuild one sequence's KV by re-ingesting
        ``prompt + generated`` up to its cached length (``upto``) through
        ``_ingest``, chunked at ``prefill_chunk_tokens`` (or whole), into
        the pages it already maps (a shared prefix page is rewritten with
        the same content); the draft pool to its own length ``dlen`` in
        one prefill.  The outputs are discarded and the pending
        ``next_token`` is kept; the prompt's prefix entries are
        registered again once the replay covers the prompt.  ``upto`` and
        ``dlen`` default to the cache lengths; the batched path records
        them before it truncates anything, so its per-row fallback can
        replay a row that a failed round left part-way."""
        sid = req.seq_id
        if upto is None:
            upto = self.cache.length(sid)
        if dlen is None:
            dlen = (self.draft_cache.length(sid)
                    if self._spec and req.use_draft else 0)
        if upto <= 0 and dlen <= 0:
            return                          # nothing resident yet
        sampling = _null_sampling() if self.sample_on_device else None
        tokens = req.output_ids
        if upto > 0:
            self.cache.truncate(sid, 0)
            chunk = self.prefill_chunk_tokens or upto
            k = 0
            while k < upto:
                n = min(chunk, upto - k)
                # a replay that wedges on a sick device is as visible to
                # the watchdog as the step that led to it
                self._step_started_at = time.monotonic()
                try:
                    self.replay_dispatches += 1
                    _replay_dispatches.inc()
                    self._ingest(self._decoder, self.cache, sid, tokens,
                                 k, n, sampling)
                finally:
                    self._step_started_at = None
                k += n
            if self.prefix_cache and upto >= len(req.prompt):
                self.cache.register_prefix(sid, req.prompt)
        if dlen > 0:
            self.draft_cache.truncate(sid, 0)
            self._step_started_at = time.monotonic()
            try:
                self.replay_dispatches += 1
                _replay_dispatches.inc()
                self._draft_decoder.prefill(self.draft_cache, [sid],
                                            tokens[None, :dlen],
                                            sampling=sampling)
            finally:
                self._step_started_at = None
        self.survivor_replays += 1
        _survivor_replays.inc()
        _tracer.request_event(req.request_id, "replay",
                              tokens=int(upto), draft_tokens=int(dlen))

    def _replay_kv_batch(self, rows, targets) -> None:
        """Batched survivor replay: each pool's rows re-ingest in lockstep
        rounds of up to ``max_batch`` rows a ``batch_context_prefill``
        step, each row up to ``prefill_chunk_tokens`` a round (or the
        rest of its target), dropping out at its target length; the
        draft pool's rows after the target's.  ``targets`` maps
        ``id(req)`` to the (target, draft) lengths recorded before any
        truncation.  A failure propagates: the caller falls back to the
        per-row replay, which names the row at fault."""
        def collect(cache, which):
            out = []
            for r in rows:
                upto = targets[id(r)][which]
                if upto > 0:
                    out.append((r, r.output_ids[:upto], upto))
                    cache.truncate(r.seq_id, 0)
            return out

        def rounds(decoder, cache, work, chunk):
            cursor = {id(r): 0 for r, _, _ in work}
            pending = list(work)
            while pending:
                batch = pending[:self.max_batch]
                sids = [r.seq_id for r, _, _ in batch]
                ks = [cursor[id(r)] for r, _, _ in batch]
                slices = [toks[k:k + min(chunk or upto, upto - k)]
                          for (r, toks, upto), k in zip(batch, ks)]
                self._step_started_at = time.monotonic()
                try:
                    self.replay_dispatches += 1
                    _replay_dispatches.inc()
                    decoder.batch_context_prefill(
                        cache, sids, slices, ks,
                        sampling=(_null_sampling(len(sids))
                                  if self.sample_on_device else None))
                finally:
                    self._step_started_at = None
                for (r, _toks, _upto), sl in zip(batch, slices):
                    cursor[id(r)] += len(sl)
                pending = [(r, toks, upto) for r, toks, upto in pending
                           if cursor[id(r)] < upto]

        chunk = self.prefill_chunk_tokens
        work = collect(self.cache, 0)
        rounds(self._decoder, self.cache, work, chunk)
        for r, _toks, upto in work:
            if self.prefix_cache and upto >= len(r.prompt):
                self.cache.register_prefix(r.seq_id, r.prompt)
        dwork = collect(self.draft_cache, 1) if self._spec else []
        if dwork:
            rounds(self._draft_decoder, self.draft_cache, dwork, chunk)
        done = {}
        for r, _, _ in work + dwork:
            done.setdefault(id(r), r)
        self.survivor_replays += len(done)
        _survivor_replays.inc(len(done))
        if _tracer.enabled:
            for r in done.values():
                _tracer.request_event(
                    r.request_id, "replay", batched=True,
                    tokens=int(targets[id(r)][0]),
                    draft_tokens=int(targets[id(r)][1]))

    def _replay_survivors(self, exclude=()) -> List[_Request]:
        """After a pool loss, replay every live sequence (decoding,
        mid-prefill and paused) to its cached length; ``exclude`` names
        requests about to be quarantined.  Batched with
        ``replay_batch``; a failed batched step cannot name its row, so
        the pass falls back to a row at a time.  A row whose own replay
        fails is marked with the error and returned for quarantine; if
        that failure lost the pools again, the pass restarts, so every
        earlier row is replayed over the new pools (each restart drops a
        row).  Scheduler thread only."""
        skip = {id(r) for r in exclude}
        failed: List[_Request] = []

        def eligible():
            # r.error: a row an earlier recovery of this step condemned
            # (its done is set at the step's end)
            return [r for r in (self._active + self._prefilling
                                + self._preempted)
                    if id(r) not in skip and r.seq_id is not None
                    and not r.done.is_set() and r.error is None]

        targets = {id(r): (self.cache.length(r.seq_id),
                           (self.draft_cache.length(r.seq_id)
                            if self._spec and r.use_draft else 0))
                   for r in eligible()}
        batched = self.replay_batch
        while True:
            restart = False
            rows = eligible()
            if batched and len(rows) > 1:
                try:
                    self._replay_kv_batch(rows, targets)
                    break
                except Exception:  # noqa: BLE001 — isolate a row at a time
                    batched = False
                    self._pools_rebuilt()   # reconcile a loss mid-batch
                    continue
            for r in rows:
                try:
                    self._replay_kv(r, *targets[id(r)])
                except Exception as e:  # noqa: BLE001 — this row alone
                    r.error = e
                    skip.add(id(r))
                    failed.append(r)
                    if self._pools_rebuilt():
                        restart = True
                        break
            if not restart:
                break
        return failed

    def _after_step_failure(self, error=None, exclude=(),
                            in_step: bool = False) -> List[_Request]:
        """Run after any failed (or wedged) step or chunk, once it is
        rolled back: a wedge zeroes the pools outright; then, if a pool
        was lost (here or at the ``buffer_loss`` site), every survivor's
        KV is replayed before the caller retries.  Requests whose own
        replay failed are quarantined: with ``in_step`` the ones in the
        active batch are returned (the caller drops them from its retry
        and pops their unexecuted token), every other one is retired
        here.  Costs one comparison when no pool was lost.  A recovery's
        time (``recovery_s``) runs from here to the end of the replay."""
        t0 = time.perf_counter()
        if isinstance(error, _EngineWedged):
            self.cache.reset_pools()
            if self._spec:
                self.draft_cache.reset_pools()
        if not self._pools_rebuilt():
            return []
        self.rebuilds += 1
        _rebuilds_total.inc()
        t_tr = _tracer.now_ns() if _tracer.enabled else 0
        with monitor.span("engine/recovery", histogram=_recovery_s):
            failed = self._replay_survivors(exclude=exclude)
        self.recovery_s.append(time.perf_counter() - t0)
        if _tracer.enabled and t_tr:
            _tracer.step_record(
                "recovery", self.steps, t_tr, _tracer.now_ns(),
                wedged=isinstance(error, _EngineWedged),
                replay_failed=len(failed))
        if not failed:
            return []
        caller_owned = ([r for r in failed if r in self._active]
                        if in_step else [])
        eject = [r for r in failed if r not in caller_owned]
        if eject:
            with self._cond:
                for r in eject:
                    for name in ("_active", "_prefilling", "_preempted"):
                        lst = getattr(self, name)
                        if r in lst:
                            lst.remove(r)
                    self._quarantine(r)
                    self._retire_locked(r)
                self._cond.notify_all()
            for r in eject:
                r.done.set()
        return caller_owned

    def _check_wedged(self, started_at: Optional[float] = None) -> None:
        """Raise :class:`_EngineWedged` if the watchdog flagged the
        dispatch that just returned.  ``started_at`` guards against a
        stale fire: the watchdog reads the age and calls ``on_timeout``
        as two actions, so a fire aimed at an earlier slow dispatch can
        land after the next one started; a dispatch shorter than
        ``step_timeout_s`` did not wedge."""
        if not self._wedged.is_set():
            return
        self._wedged.clear()
        if started_at is not None and self.step_timeout_s is not None \
                and time.monotonic() - started_at \
                <= float(self.step_timeout_s):
            return
        raise _EngineWedged("the step ran past the watchdog's heartbeat "
                            "timeout; its results are suspect")

    def _reap_locked(self) -> List[_Request]:
        """Caller holds ``self._cond``.  Retire the requests that were
        cancelled or whose deadline passed, queued (through the
        scheduler), mid-prefill, paused (also past the resume TTL) and
        decoding: a queued one holds nothing, the others give back their
        pages and exactly the reservation ``_retire_locked`` releases,
        so an abandoned request never holds pool capacity past its TTL.
        Returns them; the caller sets their ``done`` events outside the
        lock."""
        now = time.perf_counter()
        out: List[_Request] = []
        for r in self._sched.reap(now):
            r.error = r._lifecycle_error(now, queued=True)
            self._count_lifecycle(r)
            self._cache_result_locked(r)
            self._journal_retire(r)
            _tracer.request_event(r.request_id, "retire", ok=False)
            out.append(r)
        if out:
            _queue_depth.set(len(self._sched))
        for name in ("_prefilling", "_preempted", "_active"):
            keep: List[_Request] = []
            for r in getattr(self, name):
                err = r._lifecycle_error(now, queued=False)
                if err is None and name == "_preempted":
                    err = self._preempt_expired_error(r, now)
                if err is None:
                    keep.append(r)
                    continue
                r.error = err
                self._count_lifecycle(r)
                self._retire_locked(r)
                out.append(r)
            if name == "_active" and self._active and not keep:
                # everything reaped: the pad scratch pages go back too
                self._free_pads_locked()
            setattr(self, name, keep)
        if out:
            self._cond.notify_all()
        return out

    def _count_lifecycle(self, req) -> None:
        if isinstance(req.error, RequestCancelled):
            self.cancelled += 1
            _cancelled_total.inc()
            _tracer.request_event(req.request_id, "cancel")
        else:
            self.expired += 1
            _expired_total.inc()
            _tracer.request_event(req.request_id, "expire")

    def _fail_all(self, exc) -> None:
        """Last resort, for a fault outside any step (isolation failed
        or admission and planning raised): error every queued, in-flight
        and paused request, free their pages and reservations, and keep
        serving.  A request that retired earlier in the same step (its
        ``done`` is set after the step) gets its generation, not the
        error."""
        with self._cond:
            queued = self._sched.pop_all()
            holders = self._active + self._prefilling + self._preempted
            for r in holders + queued:
                if r.done.is_set():
                    continue
                if r.finished_at is None:
                    r.error = exc
                    self._cache_result_locked(r)
                    # the error reaches its waiter: terminal, so a
                    # restart must not resurrect it
                    self._journal_retire(r)
                r.done.set()
            for r in holders:
                if r.seq_id is not None:
                    self.cache.free(r.seq_id)
                    if self._spec:
                        self.draft_cache.free(r.seq_id)
                r._draft_reserved = False
            self._free_pads_locked()
            self._reserved_pages = self._pad_pages
            self._reserved_draft_pages = self._pad_pages
            self._active = []
            self._prefilling = []
            self._preempted = []
            _active_seqs.set(0)
            _queue_depth.set(0)
            self._cond.notify_all()

    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cond:
                while not self._stop and not len(self._sched) \
                        and not self._active and not self._prefilling \
                        and not self._preempted:
                    # brownout is a property of load: an engine with
                    # nothing queued or running is not browned out, or a
                    # drained engine would shed the next burst's first
                    # arrivals
                    if self._brownout:
                        self._set_brownout_locked(0, 0.0)
                    self._cond.wait(timeout=0.5)
                if self._stop:
                    self._free_pads_locked()
                    stopped = (self._sched.pop_all() + self._prefilling
                               + self._preempted + self._active)
                    self._prefilling = []
                    self._preempted = []
                    self._active = []
                    for r in stopped:
                        r.error = RuntimeError("engine stopped")
                        self._cache_result_locked(r)
                        r.done.set()
                    return
            # for an active row one iteration is one output token, so the
            # whole iteration's wall time, chunks included, is the
            # per-token latency the TPOT trigger judges
            had_active = False
            t_iter = time.perf_counter()
            try:
                with self._cond:
                    reaped = self._reap_locked()
                    # the overload controls, once an iteration: the ladder
                    # first (its rung gates this iteration's sheds), then
                    # the TPOT trigger (its freed slot is visible to the
                    # admission below)
                    self._update_brownout_locked()
                    self._tpot_preempt_locked()
                    self._admit_locked()
                    plan = self._plan_chunks_locked()
                    # the snapshot barrier: a waiting snapshot() takes its
                    # cut before the next step starts (the wait releases
                    # the lock; nothing it does changes the plan)
                    while self._snap_waiters and not self._stop:
                        self._cond.wait(0.1)
                    self._stepping = bool(plan) or bool(self._active)
                    had_active = bool(self._active)
                for r in reaped:
                    r.done.set()
                t_iter = time.perf_counter()
                if self._legacy_iteration():
                    # legacy composition: a dispatch a planned chunk
                    # (a failing one quarantines only its request), then
                    # ONE decode step for everything active
                    self._run_chunks(plan)
                    if self._active:
                        self._decode_step()
                else:
                    if self.prefill_chunk_tokens is None and plan:
                        # unchunked: whole prompts prefill through the
                        # length-bucketed prefill/prefix steps, and only
                        # the active rows (span 1) ride the ragged step
                        self._run_chunks(plan)
                        plan = ()
                    self._unified_step(plan)
            except Exception as e:  # noqa: BLE001 — fail loudly
                # a fault outside any step's isolation: every waiter
                # gets the error; the thread keeps serving
                self._fail_all(e)
            finally:
                if had_active:
                    dt = time.perf_counter() - t_iter
                    self._step_ewma = (dt if self._step_ewma is None
                                       else 0.7 * self._step_ewma
                                       + 0.3 * dt)
                # the iteration's one step record (rows of requests
                # _fail_all retired are ignored at replay: their retire
                # record comes first)
                self._journal_flush_step()
                if self._stepping:
                    with self._cond:
                        self._stepping = False
                        self._cond.notify_all()
