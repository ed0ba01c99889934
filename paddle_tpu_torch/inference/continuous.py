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
the queued ones with ``reject_queued``) and stops the thread.  The JAX
engine's overload controls (arrival shedding on a class's
``deadline_s``, the TPOT trigger on ``tpot_budget_s``, the brownout
ladder) are not ported: a class that sets either budget is refused.

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
``prefill``, ``prefill_chunk`` and ``decode_step`` fire here; an
iteration under a plan that targets an engine site diverts to the
legacy composition, whose dispatch granularity defines the blast
radius.  The JAX engine's crash recovery (``_after_step_failure``,
``_split_replay_dead``: pools rebuilt and survivors' KV replayed after a
donated buffer is lost or a step wedges) is not ported: here a failed
step has already rolled its lengths back and no pool is donated, so it
comes with the watchdog and survivor replay.
"""
from __future__ import annotations

import threading
import time
from collections import namedtuple
from typing import List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..ops.paged_attention import PagedKVCache
from ..testing import faults as _faults
from .paged import GraphedPagedDecoder, PagedDecoder, next_pow2, sample_token
from .scheduler import DEFAULT_CLASS, QueueFull, WorkloadScheduler

_PAD_SEQ = "__pad__"

# fault-injection sites whose quarantine semantics are defined against
# the legacy per-mode dispatch granularity (one poisoned chunk fails one
# request, a decode fault bisects the batch): an iteration running under
# a plan that targets any of them diverts to the legacy composition.
# The port fires no ``engine_wedge`` or ``buffer_loss``; they stay so a
# plan written for the JAX engine diverts as it does there
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


def _null_sampling():
    """Sampling arguments for one row that draws nothing: the argmax-only
    tail for a dispatch whose token is discarded (the draft's prompt
    ingestion)."""
    return (np.zeros(1, np.uint32), np.zeros(1, np.int32),
            np.ones(1, np.float32), np.zeros(1, bool))


class EngineSaturated(RuntimeError):
    """The bounded admission queue of the request's class is full;
    retryable later.  ``priority_class`` names the class."""

    priority_class: Optional[str] = None


class EngineDraining(RuntimeError):
    """The engine is draining for graceful shutdown and accepts no new
    submissions (in-flight requests still complete)."""


class DeadlineExceeded(RuntimeError):
    """The request's queue-wait deadline, total TTL or resume TTL expired
    before completion; its pages and reservation were reclaimed."""


class RequestCancelled(RuntimeError):
    """The request was cooperatively cancelled via ``cancel()``."""


class _Request:
    """One sequence's life in the engine."""

    def __init__(self, prompt, max_new_tokens, eos_token_id, do_sample,
                 temperature, seed, ttl_s=None, queue_timeout_s=None,
                 priority=None, tenant="default"):
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
        self.admitted_at: Optional[float] = None
        self._admit_plan = None      # (need, shared_tok) fit-check stash
        # preempted_at / paused_total bound a paused request's page
        # reservation (paused_total accumulates across preempt/resume
        # cycles, so re-preemption cannot reset the aging clock)
        self.preempted_at: Optional[float] = None
        self.paused_total = 0.0
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
    decoding row when no preemptible prefill is left.

    Speculative decoding: ``draft_model`` (same vocabulary, on the same
    device) proposes ``spec_tokens`` tokens a step for every greedy
    request that does not opt out (``submit(draft=False)``); it has its
    own decoder (graphed on a card) and page pool of
    ``draft_total_pages`` (default ``total_pages``), and stays at full
    precision whatever ``quantize`` and ``kv_quant`` say.

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
    draft pool pins); per class, ``scheduler_info()["counts"]``."""

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
        self._sched = WorkloadScheduler(
            classes=scheduler_classes, max_queue=max_queue,
            default_class=default_class)
        budgeted = [c.name for c in self._sched.classes
                    if c.deadline_s is not None
                    or c.tpot_budget_s is not None]
        if budgeted:
            raise ValueError(
                f"classes {budgeted} set deadline_s or tpot_budget_s: the "
                "overload controls are not ported yet")
        self.model = model
        self.max_batch = int(max_batch)
        self.max_position = int(model.config.max_position_embeddings)
        self.sample_on_device = bool(sample_on_device)
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
        self.cache = PagedKVCache.from_model(model, total_pages=total_pages,
                                             page_size=page_size,
                                             kv_dtype=kv_quant)
        decoder = (GraphedPagedDecoder if self.device.type == "cuda"
                   else PagedDecoder)
        self._decoder = decoder(model, quantize=quantize,
                                min_table_pages=min_table_pages)
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
               draft: Optional[bool] = None) -> _Request:
        """Queue one request; returns its handle (``result()`` waits).

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
        is full."""
        # the class is resolved before any capacity check: an unknown
        # class is never reported as saturation or draining
        pclass = self._sched.resolve(priority)
        req = _Request(prompt, max_new_tokens, eos_token_id, do_sample,
                       temperature, seed,
                       ttl_s=self.default_ttl_s if ttl_s is None else ttl_s,
                       queue_timeout_s=(self.default_queue_timeout_s
                                        if queue_timeout_s is None
                                        else queue_timeout_s),
                       priority=pclass.name, tenant=tenant)
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
            try:
                self._sched.push(req)
            except QueueFull as e:
                self.saturated += 1
                err = EngineSaturated(str(e))
                err.priority_class = e.priority_class
                raise err from None
            self._cond.notify_all()
        return req

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 seed: int = 0, ttl_s: Optional[float] = None,
                 priority: Optional[str] = None,
                 tenant: str = "default"):
        """Blocking batch API: one sequence per row (row i seeded
        ``seed + i``; rows may differ in length), outputs eos-padded to a
        common length.  If any row fails to submit or errors, the rows
        already submitted are cancelled and the error re-raised, so a
        rejected batch never leaves orphan sequences decoding against the
        pool."""
        reqs: List[_Request] = []
        try:
            for i, row in enumerate(input_ids):
                reqs.append(self.submit(row, max_new_tokens, eos_token_id,
                                        do_sample, temperature, seed + i,
                                        ttl_s=ttl_s, priority=priority,
                                        tenant=tenant))
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
        return out

    @property
    def draining(self) -> bool:
        return self._draining

    def scheduler_info(self) -> dict:
        """JSON-able scheduling state: the policy knobs, per-class and
        per-tenant queue depths, per-class counters and the lengths of
        the in-flight lists."""
        with self._cond:
            return {
                "prefill_chunk_tokens": self.prefill_chunk_tokens,
                "default_class": self._sched.default_class,
                "classes": self._sched.policy(),
                "tenants_queued": self._sched.tenant_depths(),
                "counts": self._sched.counts(),
                "prefilling": len(self._prefilling),
                "preempted": len(self._preempted),
                "decode_preempt": self.decode_preempt,
            }

    def stop_admissions(self) -> None:
        """Flip the draining flag synchronously (``drain()`` sets it
        again, idempotently): every later ``submit`` raises
        :class:`EngineDraining`."""
        with self._cond:
            self._draining = True
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
            if reject_queued and len(self._sched):
                rejected = self._sched.pop_all()
                for r in rejected:
                    r.error = EngineDraining(
                        "engine draining: request rejected before "
                        "admission (reject_queued)")
                self.drain_rejected += len(rejected)
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
        return True

    def stop(self):
        """Hard stop: errors whatever is still queued or running.  Use
        :meth:`drain` for the graceful path."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # ---------------------------------------------------------- scheduler
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
        self._sched.note_admitted(req)

    def _best_preempted_locked(self) -> Optional[_Request]:
        """Caller holds ``self._cond``.  The paused request that should
        resume first: most urgent effective class (aging boost
        included), then preemption order."""
        if not self._preempted:
            return None
        return min(self._preempted,
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

    def _pause_locked(self, victim) -> None:
        """Caller holds ``self._cond``.  Move a preemption victim,
        mid-prefill or mid-decode, onto the paused list (seq id, pages
        and reservation all kept; a decoding row keeps its pending
        ``next_token``)."""
        if victim in self._prefilling:
            self._prefilling.remove(victim)
        else:
            self._active.remove(victim)
        victim.preempted_at = time.perf_counter()
        self._preempted.append(victim)
        self._sched.note_preempted(victim)

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
        if pre.first_token_at is not None \
                and pre.prefill_pos >= len(pre.prompt):
            self._active.append(pre)
        else:
            self._prefilling.append(pre)
        self._sched.note_resumed(pre)

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
                self._pause_locked(victim)
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
            remaining = len(req.prompt) - req.prefill_pos
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

    def _ingest(self, req, k: int, n: int, sampling):
        """One bucketed prompt-ingest dispatch of prompt[k:k+n]: fresh
        prefill at k == 0, the context-prefill continuation otherwise."""
        ids = req.prompt[None, k:k + n]
        if k:
            return self._decoder.chunk_prefill(
                self.cache, [req.seq_id], ids, context_tokens=k,
                sampling=sampling)
        return self._decoder.prefill(self.cache, [req.seq_id], ids,
                                     sampling=sampling)

    def _prefill_chunk(self, req, n: int) -> bool:
        """Ingest the next ``n`` prompt tokens of ``req`` in one step;
        True once the prompt is resident (only then is the first token
        sampled, at its absolute position).  Fires ``prefill`` on the
        request's first chunk and ``prefill_chunk`` on every one."""
        k = req.prefill_pos
        total = len(req.prompt)
        n = min(n, total - k)
        last = k + n == total
        if not self.sample_on_device:
            sampling = None
        else:
            sampling = self._sampling_for([req if last else None], [total])
        if k == req.prefix_tokens:
            # per-sequence site, once: chunking must not change existing
            # fault plans' semantics
            _faults.maybe_fire("prefill", seq_ids=[req.seq_id])
        _faults.maybe_fire("prefill_chunk", seq_ids=[req.seq_id])
        self.dispatches["chunk" if k else "prefill"] += 1
        out = self._ingest(req, k, n, sampling)
        req.prefill_pos = k + n
        self._sched.note_chunk(req)
        if last:
            self._finish_prefill(req, out[0], sampling is not None)
        return last

    def _finish_prefill(self, req, out_row, sampled: bool) -> None:
        """The prompt is resident: register its prefixes, ingest the
        draft's copy, latch the first token and stamp the time to first
        token."""
        if self.prefix_cache:
            self.cache.register_prefix(req.seq_id, req.prompt)
        if req.use_draft:
            # the draft ingests the whole prompt (its pool shares no
            # prefix), so its cache sits at the target's length: the
            # lockstep every proposal and verify keeps.  Only at prefill
            # completion, so a request paused mid-prefill never touched
            # the draft pool.  The token it draws is discarded
            try:
                self.dispatches["draft"] += 1
                self._draft_decoder.prefill(self.draft_cache, [req.seq_id],
                                            req.prompt[None],
                                            sampling=_null_sampling())
            except Exception:  # noqa: BLE001 — downgrade, don't fail
                self._downgrade_draft([req])
        req.next_token = (int(out_row) if sampled
                          else self._pick(req, out_row))
        req.first_token_at = time.perf_counter()
        self._sched.note_first_token(req,
                                     req.first_token_at - req.submitted_at)

    def _run_chunks(self, plan) -> None:
        """One dispatch a planned chunk (device work, called without the
        lock).  A failing chunk quarantines exactly its request: the
        decoder already rolled the failed dispatch back, retirement
        reclaims the pages every earlier chunk wrote, and the other
        requests are untouched."""
        completed, failed = [], []
        for req, n in plan:
            if req.cancelled or req.done.is_set():
                # cancelled: the next reap retires it
                continue
            try:
                if self._prefill_chunk(req, n):
                    completed.append(req)
            except Exception as e:  # noqa: BLE001 — quarantine this one
                req.error = e
                failed.append(req)
        if not completed and not failed:
            return
        with self._cond:
            for r in failed:
                self._prefilling.remove(r)
                self.quarantined += 1
                self._retire_locked(r)
            for r in completed:
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
            self.dispatches["draft"] += 1
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
        _faults.maybe_fire("decode_step", seq_ids=[r.seq_id for r in reqs])
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
        # the draw's counter, pos + accept + 1, is computed on the
        # device, so a sampled row draws where a plain step would
        sampling = (self._row_sampling(reqs, b)
                    if self.sample_on_device else None)
        self.dispatches["verify"] += 1
        out, accept = self._decoder.verify(self.cache, seq_ids, block, pos,
                                           sampling=sampling)
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
        # the fault fires before the decoder runs, so never inside a
        # CUDA graph's capture
        _faults.maybe_fire("decode_step", seq_ids=seq_ids[:len(reqs)])
        self.dispatches["decode"] += 1
        out = self._decoder.step(self.cache, seq_ids, tokens, pos,
                                 sampling=sampling)
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
        everyone."""
        try:
            return reqs, self._exec_step(reqs), []
        except Exception:  # noqa: BLE001 — retried below
            self._rollback_step(reqs, lens_before)
        self.decode_retries += 1
        try:
            return reqs, self._exec_step(reqs), []
        except Exception as e:  # noqa: BLE001 — bisected below
            self._rollback_step(reqs, lens_before)
            return self._bisect_step(reqs, lens_before, e)

    def _bisect_step(self, reqs, lens_before, error):
        """Deterministic fault isolation: halve the failing batch and
        replay each half (solo replay at size 1).  Healthy halves advance
        their token normally; a size-1 failure quarantines that request
        with the error that killed it.  O(k log n) extra step attempts
        for k poisoned sequences in a batch of n."""
        if len(reqs) == 1:
            r = reqs[0]
            r.error = error
            self.quarantined += 1
            return [], [], [r]
        mid = (len(reqs) + 1) // 2
        survivors, rows, poisoned = [], [], []
        for half in (reqs[:mid], reqs[mid:]):
            self.decode_retries += 1
            try:
                half_rows = self._exec_step(half)
            except Exception as e:  # noqa: BLE001 — bisected further
                self._rollback_step(half, lens_before)
                s, o, p = self._bisect_step(half, lens_before, e)
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
        survivors, rows, poisoned = self._step_isolated(active, lens_before)
        still, retired = self._advance_rows(survivors, rows,
                                            self.sample_on_device)
        for r in poisoned:
            # the token recorded for this step never executed
            r.generated.pop()
        with self._cond:
            self.steps += 1
            for r in retired + poisoned:
                self._retire_locked(r)
            self._active = still
            if not still:
                # idle: the scratch pages go back too, before the
                # waiters wake, so a drained engine reports whole pools
                self._free_pads_locked()
            self._cond.notify_all()
        for r in retired + poisoned:
            r.done.set()

    def _advance_rows(self, reqs, rows, sampled: bool):
        """(still, retired) after a decode or verify step: a request that
        hit eos or its budget retires, the others latch their next token.
        A speculative row first takes its accepted drafts one by one,
        with the same eos and budget checks a plain step applies a token
        at a time, so its stream is target-only greedy's token for
        token."""
        still, retired = [], []
        for r, row in zip(reqs, rows):
            eos_hit = (r.eos_token_id is not None
                       and r.generated[-1] == r.eos_token_id)
            if eos_hit or len(r.generated) >= r.max_new_tokens:
                retired.append(r)
                continue
            if isinstance(row, _SpecRow):
                done = False
                for t in row.drafts[:row.accept]:
                    r.generated.append(int(t))
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
        return still, retired

    # ------------------------------------------------ unified ragged step
    def _unified_rollback(self, chunks, active, lens_before) -> None:
        """Undo the unified composition after a failed ragged step, so
        the legacy re-run replays the exact same step: appended decode
        tokens pop and every row's length returns to its pre-step value
        in both caches (the decoder rolled its own advance back; this
        covers a fault fired before it ran and the draft's proposal)."""
        for req, k, _n, _last in chunks:
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
        follow.  On an injected fault the
        composition unwinds and the iteration re-runs through the legacy
        composition, whose retry and bisection own failure isolation; 3
        such failures in a row latch the unified path off.  Any other
        failure unwinds and fails the step's requests alone (see the
        module docstring)."""
        chunks = []
        for req, n in plan:
            if req.cancelled or req.done.is_set():
                continue
            k = req.prefill_pos
            n = min(n, len(req.prompt) - k)
            chunks.append((req, k, n, k + n == len(req.prompt)))
        active = list(self._active)
        if not chunks and not active:
            return
        spec = self._spec and any(r.use_draft for r in active)
        lens_before = self._lengths(active)
        for r in active:
            r.generated.append(r.next_token)
        seq_ids, rows, ctxs = [], [], []
        for req, k, n, _last in chunks:
            seq_ids.append(req.seq_id)
            rows.append(req.prompt[k:k + n])
            ctxs.append(k)
        for r in active:
            seq_ids.append(r.seq_id)
            rows.append(np.asarray([r.generated[-1]], np.int32))
            ctxs.append(self.cache.length(r.seq_id))
        if self.sample_on_device:
            # intermediate chunk rows draw nothing; the counter of every
            # draw is computed in the step from the row's position
            sampling = self._row_sampling(
                [req if last else None for req, _k, _n, last in chunks]
                + active)
        else:
            sampling = None
        try:
            # only delay-kind pacing rules can be live here
            # (_legacy_iteration diverts everything else): fire the
            # legacy sites so throttling plans pace the unified step as
            # they pace the composition it replaces
            for req, k, _n, _last in chunks:
                if not k:
                    _faults.maybe_fire("prefill", seq_ids=[req.seq_id])
                _faults.maybe_fire("prefill_chunk", seq_ids=[req.seq_id])
            if active:
                _faults.maybe_fire("decode_step",
                                   seq_ids=[r.seq_id for r in active])
            drafts = None
            if spec:
                drafts = self._propose_drafts(active)
                for i in range(len(active)):
                    rows[len(chunks) + i] = np.concatenate(
                        [rows[len(chunks) + i], drafts[i]])
            self.dispatches["ragged"] += 1
            out, accept = self._decoder.ragged_step(
                self.cache, seq_ids, rows, ctxs,
                n_drafts=([0] * len(chunks) + [self.spec_k] * len(active)
                          if spec else None),
                sampling=sampling)
        except _faults.FaultError:  # the legacy re-run isolates
            self._unified_rollback(chunks, active, lens_before)
            self.unified_fallbacks += 1
            self._unified_failures += 1
            if self._unified_failures >= 3:
                self._unified_off = True
            self._run_chunks(plan)
            if self._active:
                self._decode_step()
            return
        except Exception as e:  # noqa: BLE001 — fail the step's requests
            self._unified_rollback(chunks, active, lens_before)
            self._quarantine_step([req for req, *_ in chunks], active, e)
            return
        self._unified_failures = 0
        nchunks = len(chunks)
        completed = []
        for i, (req, k, n, last) in enumerate(chunks):
            req.prefill_pos = k + n
            self._sched.note_chunk(req)
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
                self._prefilling.remove(r)
                self._active.append(r)
            self._cond.notify_all()
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
                self._retire_locked(r)
            self.quarantined += len(failed)
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
        self._sched.note_retired(req)

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
        with self._cond:
            for r in reqs:
                self.spec_draft_failures += 1
                r.use_draft = False
                self._release_draft_locked(r)

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
            out.append(r)
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
        else:
            self.expired += 1

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
            self._cond.notify_all()

    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cond:
                while not self._stop and not len(self._sched) \
                        and not self._active and not self._prefilling \
                        and not self._preempted:
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
                        r.done.set()
                    return
            try:
                with self._cond:
                    reaped = self._reap_locked()
                    self._admit_locked()
                    plan = self._plan_chunks_locked()
                for r in reaped:
                    r.done.set()
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
