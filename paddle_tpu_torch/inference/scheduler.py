"""Heterogeneous-workload scheduler (port of
paddle_tpu/inference/scheduler.py).

Admission policy and per-class accounting for the continuous-batching
engine:

  * **priority classes**: requests carry a class (``interactive`` >
    ``standard`` > ``batch`` by default); classes have weights (admission
    share) and a ``preemptible`` flag (the engine may pause a preemptible
    request's chunked prefill, or its decode, to hand its slot to more
    urgent traffic: the paused request keeps its pages and resumes, it
    never re-prefills);
  * **weighted-fair queueing**: admission order is deficit round-robin
    at two levels: across classes (deficit replenished by class weight,
    cost charged in reserved pages, highest accumulated deficit served
    first, so the long-run service share tracks the weights while no
    class starves) and, within a class, across per-tenant FIFO queues
    (equal-quantum DRR, so one tenant's burst cannot monopolize its
    class);
  * **bounded per-class queues**: each class has its own admission queue
    bound; overflow raises :class:`QueueFull` naming the class, which the
    engine maps to ``EngineSaturated``.

With one class and one tenant the selection is FIFO: the queue's head,
or nothing while the head does not fit.

Concurrency contract: a ``WorkloadScheduler`` owns no lock; every method
is called with the engine's ``_cond`` held.

Accounting: each class keeps plain counters (:meth:`counts`) where the
JAX package feeds its process-wide monitor series; the port has no
monitor registry yet, and the queue-wait, TTFT and TPOT histograms come
with it.  The per-class SLO attainment window (``slo_recent``) is host
state and is kept as in the JAX package.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "PriorityClass", "WorkloadScheduler", "QueueFull",
    "DEFAULT_CLASSES", "DEFAULT_CLASS",
]


@dataclass(frozen=True)
class PriorityClass:
    """One scheduling class.  ``rank`` orders urgency (lower = more
    urgent: chunk budget and slot preemption both favor lower ranks);
    ``weight`` is the class's admission share under weighted DRR;
    ``preemptible`` marks classes whose chunked prefill, and whose
    in-flight decode, the engine may pause for lower-rank traffic;
    ``max_queue`` overrides the scheduler-wide per-class queue bound.

    SLO budgets (both optional, None disables them): ``deadline_s`` is
    the class's queue-wait/TTFT budget, which the attainment window
    counts against; ``tpot_budget_s`` the per-token decode budget.  The
    overload controls that act on them (arrival shedding, the TPOT
    trigger) are not ported yet, so the port's engine refuses a class
    that sets either."""

    name: str
    rank: int
    weight: int = 1
    preemptible: bool = False
    max_queue: Optional[int] = None
    deadline_s: Optional[float] = None
    tpot_budget_s: Optional[float] = None


#: the default class taxonomy: chat-style traffic outranks everything,
#: offline/batch work is preemptible and gets the smallest share
DEFAULT_CLASSES: Tuple[PriorityClass, ...] = (
    PriorityClass("interactive", rank=0, weight=8),
    PriorityClass("standard", rank=1, weight=4),
    PriorityClass("batch", rank=2, weight=1, preemptible=True),
)
DEFAULT_CLASS = "standard"

#: deficit accumulation cap, in quanta: an idle-then-bursty class may
#: bank at most this many rounds of credit (classic DRR zeroes credit on
#: empty; the cap bounds it instead so a re-appearing class cannot
#: monopolize admission with stale credit)
_DEFICIT_CAP_ROUNDS = 16

#: recent per-class SLO attainment window (requests)
_ATTAINMENT_WINDOW = 64

#: the per-class counters :meth:`WorkloadScheduler.counts` reports:
#: admissions, bounded-queue rejections, preemptions (prefill or
#: decode), resumes, prefill chunks run, chunks deferred because the
#: budget went to a more urgent class, paused requests reaped past the
#: resume TTL, and arrivals shed by the overload controller (not ported
#: yet: always 0)
COUNTERS = ("admitted", "rejected", "preempted", "resumed", "chunks",
            "deferrals", "preempt_expired", "shed")


class QueueFull(RuntimeError):
    """A class's bounded admission queue overflowed.  The engine maps
    this to ``EngineSaturated``; ``priority_class`` names the class whose
    backlog overflowed."""

    def __init__(self, priority_class: str, depth: int, bound: int):
        super().__init__(
            f"admission queue for class {priority_class!r} is full "
            f"({depth}/{bound} requests); retry later")
        self.priority_class = priority_class
        self.depth = depth
        self.bound = bound


class _TenantQueue:
    __slots__ = ("queue", "deficit")

    def __init__(self):
        self.queue: Deque = deque()
        self.deficit = 0.0


class _ClassState:
    __slots__ = ("spec", "tenants", "deficit", "depth", "slo_recent",
                 "counts")

    def __init__(self, spec: PriorityClass):
        self.spec = spec
        # insertion-ordered so tenant DRR visits are deterministic
        self.tenants: "OrderedDict[str, _TenantQueue]" = OrderedDict()
        self.deficit = 0.0
        self.depth = 0
        # sliding window of per-request SLO outcomes: 1 = TTFT met the
        # class deadline budget, 0 = blown
        self.slo_recent: Deque[int] = deque(maxlen=_ATTAINMENT_WINDOW)
        self.counts: Dict[str, int] = dict.fromkeys(COUNTERS, 0)


class WorkloadScheduler:
    """Per-class, per-tenant admission queues + weighted-DRR selection.

    Not thread-safe by itself: the owning engine calls every method with
    its scheduler lock held (see the module docstring).
    """

    def __init__(self, classes: Optional[Sequence[PriorityClass]] = None,
                 max_queue: int = 256,
                 default_class: str = DEFAULT_CLASS):
        specs = tuple(classes) if classes is not None else DEFAULT_CLASSES
        if not specs:
            raise ValueError("at least one PriorityClass is required")
        names = [c.name for c in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names in {names}")
        self._classes: Dict[str, _ClassState] = {
            c.name: _ClassState(c) for c in specs}
        self._by_rank: List[_ClassState] = sorted(
            self._classes.values(), key=lambda cs: (cs.spec.rank,
                                                    cs.spec.name))
        self.max_queue = int(max_queue)
        if default_class not in self._classes:
            raise ValueError(
                f"default_class {default_class!r} is not one of {names}")
        self.default_class = default_class

    # ----------------------------------------------------------- lookup
    def resolve(self, name: Optional[str]) -> PriorityClass:
        """The class for a submitted ``priority`` (None -> default).
        ValueError for unknown names: an unknown class is the client's
        mistake, never a retryable."""
        if name is None:
            name = self.default_class
        cs = self._classes.get(name)
        if cs is None:
            raise ValueError(
                f"unknown priority class {name!r}; classes are "
                f"{sorted(self._classes)}")
        return cs.spec

    def class_of(self, req) -> PriorityClass:
        return self._classes[req.priority].spec

    @property
    def classes(self) -> Tuple[PriorityClass, ...]:
        return tuple(cs.spec for cs in self._by_rank)

    def __len__(self) -> int:
        return sum(cs.depth for cs in self._by_rank)

    def depth(self, priority: Optional[str] = None) -> int:
        """Queued requests in one class (or overall with None)."""
        if priority is None:
            return len(self)
        cs = self._classes.get(priority)
        return 0 if cs is None else cs.depth

    def depths(self) -> Dict[str, int]:
        return {cs.spec.name: cs.depth for cs in self._by_rank}

    def tenant_depths(self) -> Dict[str, Dict[str, int]]:
        return {cs.spec.name: {t: len(tq.queue)
                               for t, tq in cs.tenants.items()
                               if tq.queue}
                for cs in self._by_rank}

    def policy(self) -> dict:
        """JSON-able policy knobs + live depths."""
        return {cs.spec.name: {
            "rank": cs.spec.rank,
            "weight": cs.spec.weight,
            "preemptible": cs.spec.preemptible,
            "max_queue": (self.max_queue if cs.spec.max_queue is None
                          else cs.spec.max_queue),
            "queued": cs.depth,
            "deadline_s": cs.spec.deadline_s,
            "tpot_budget_s": cs.spec.tpot_budget_s,
            "slo_attainment": self.attainment(cs.spec.name),
        } for cs in self._by_rank}

    def counts(self) -> Dict[str, Dict[str, int]]:
        """``{class: {counter: n}}`` for every class (see ``COUNTERS``)."""
        return {cs.spec.name: dict(cs.counts) for cs in self._by_rank}

    def attainment(self, priority: str) -> Optional[float]:
        """Fraction of the class's last ``_ATTAINMENT_WINDOW`` first
        tokens that met ``deadline_s`` (None while the class has no
        budget or no samples)."""
        cs = self._classes.get(priority)
        if cs is None or not cs.slo_recent:
            return None
        return sum(cs.slo_recent) / len(cs.slo_recent)

    # ------------------------------------------------------------ queues
    def push(self, req) -> None:
        """Enqueue onto the request's (class, tenant) queue.  Raises
        :class:`QueueFull` when the class's bounded queue is full."""
        cs = self._classes[self.resolve(req.priority).name]
        req.priority = cs.spec.name          # normalize None -> default
        bound = (self.max_queue if cs.spec.max_queue is None
                 else cs.spec.max_queue)
        if cs.depth >= bound:
            cs.counts["rejected"] += 1
            raise QueueFull(cs.spec.name, cs.depth, bound)
        tq = cs.tenants.get(req.tenant)
        if tq is None:
            tq = cs.tenants[req.tenant] = _TenantQueue()
        tq.queue.append(req)
        cs.depth += 1

    @staticmethod
    def _set_depth(cs: _ClassState, delta: int) -> None:
        cs.depth += delta
        if cs.depth == 0:
            # classic DRR: an emptied queue forfeits leftover credit, and
            # its tenant entries go too, so the per-tenant map can never
            # grow without bound on client-supplied tenant ids
            cs.deficit = 0.0
            cs.tenants.clear()

    @staticmethod
    def _prune_tenants(cs: _ClassState) -> None:
        """Drop emptied tenant queues (forfeiting their DRR credit, the
        classic rule) so the tenant map is bounded by the live tenant
        count, not by every tenant string ever submitted."""
        for name in [n for n, tq in cs.tenants.items() if not tq.queue]:
            del cs.tenants[name]

    def min_waiting_rank(self) -> Optional[int]:
        """Rank of the most urgent nonempty class, or None when idle: the
        engine's slot-preemption trigger reads this."""
        for cs in self._by_rank:
            if cs.depth:
                return cs.spec.rank
        return None

    def peek_urgent(self):
        """A head request of the most urgent nonempty class (first
        nonempty tenant queue), without popping: the engine uses it for a
        pages-fit check before paying for a slot preemption."""
        for cs in self._by_rank:
            if not cs.depth:
                continue
            for tq in cs.tenants.values():
                if tq.queue:
                    return tq.queue[0]
        return None

    def pending(self) -> List:
        """Every queued request without popping, most urgent class first
        (FIFO within each tenant queue)."""
        out: List = []
        for cs in self._by_rank:
            for tq in cs.tenants.values():
                out.extend(tq.queue)
        return out

    def pop_all(self) -> List:
        """Remove and return every queued request (drain-reject, stop and
        fail-all paths)."""
        out: List = []
        for cs in self._by_rank:
            for tq in cs.tenants.values():
                out.extend(tq.queue)
                tq.queue.clear()
            if cs.depth:
                self._set_depth(cs, -cs.depth)
        return out

    def reap(self, now: float) -> List:
        """Remove queued requests whose lifecycle ended (cancel or
        deadline) and return them; the engine counts and wakes them."""
        out: List = []
        for cs in self._by_rank:
            removed = 0
            for tq in cs.tenants.values():
                if not tq.queue:
                    continue
                keep: Deque = deque()
                for r in tq.queue:
                    if r._lifecycle_error(now, queued=True) is None:
                        keep.append(r)
                    else:
                        out.append(r)
                        removed += 1
                tq.queue = keep
            if removed:
                self._prune_tenants(cs)
                self._set_depth(cs, -removed)
        return out

    # --------------------------------------------------------- selection
    @staticmethod
    def _tenant_candidate(cs: _ClassState, can_admit):
        """(tenant, tenant_queue, req, cost) for this class under
        tenant-level DRR: among tenants whose head fits right now, serve
        the highest deficit (replenishing equal quanta until someone
        affords).  Heads are never skipped within a tenant queue: FIFO
        per tenant is part of the fairness contract."""
        heads = []
        for tname, tq in cs.tenants.items():
            if not tq.queue:
                continue
            cost = can_admit(tq.queue[0])
            if cost is not None:
                heads.append((tname, tq, tq.queue[0], float(cost)))
        if not heads:
            return None
        # equal replenish quantum per tenant (weights are a class
        # concept); the service charge below is what makes shares fair
        quantum = max(1.0, min(h[3] for h in heads))
        cap = _DEFICIT_CAP_ROUNDS * max(h[3] for h in heads)
        while True:
            afford = [h for h in heads if h[1].deficit >= h[3]]
            if afford:
                return max(afford, key=lambda h: h[1].deficit)
            for _, tq, _, _ in heads:
                tq.deficit = min(tq.deficit + quantum, cap)

    def pop_next(self, can_admit: Callable,
                 max_rank: Optional[int] = None) -> Optional[object]:
        """Pop the next request to admit, or None if nothing is
        admissible.

        ``can_admit(req) -> Optional[cost]`` must be pure: it returns the
        admission cost (reserved pages) when the request fits the
        engine's capacity right now, else None.  Selection is weighted
        DRR across classes (deficit += weight per replenish round; the
        highest-deficit affordable class is served, rank breaking ties so
        urgency wins among equals), then tenant DRR within the class.
        Deficits are charged in cost units, so the service share tracks
        weight x pages, not request count.

        ``max_rank`` restricts candidates to classes at that rank or more
        urgent: the engine passes the rank it just preempted a victim
        for, so a slot paid for with a preemption can never be consumed
        by a less urgent class's banked deficit."""
        candidates = []
        for cs in self._by_rank:
            if not cs.depth:
                continue
            if max_rank is not None and cs.spec.rank > max_rank:
                continue
            found = self._tenant_candidate(cs, can_admit)
            if found is not None:
                candidates.append((cs,) + found)
        if not candidates:
            return None
        # the cap banks at most _DEFICIT_CAP_ROUNDS rounds of weight, but
        # must still reach the costliest head: costs are pages, weights
        # are quanta, so a lone low-weight class with a large request
        # must become affordable, not spin the loop forever
        cap = max(_DEFICIT_CAP_ROUNDS
                  * max(c[0].spec.weight for c in candidates),
                  max(c[4] for c in candidates))
        while True:
            afford = [c for c in candidates if c[0].deficit >= c[4]]
            if afford:
                cs, _tname, tq, req, cost = min(
                    afford, key=lambda c: (-c[0].deficit, c[0].spec.rank))
                break
            for c in candidates:
                c[0].deficit = min(c[0].deficit + c[0].spec.weight, cap)
        popped = tq.queue.popleft()
        assert popped is req
        cs.deficit -= cost
        tq.deficit -= cost
        self._prune_tenants(cs)
        self._set_depth(cs, -1)
        return req

    # ------------------------------------------------------ accounting
    def _count(self, req, name: str) -> None:
        self._classes[req.priority].counts[name] += 1

    def note_admitted(self, req) -> None:
        """One admission (the queue-wait histogram comes with the
        monitor)."""
        self._count(req, "admitted")

    def note_first_token(self, req, ttft_s: float) -> None:
        cs = self._classes[req.priority]
        if cs.spec.deadline_s is not None:
            cs.slo_recent.append(1 if ttft_s <= cs.spec.deadline_s
                                 else 0)

    def note_shed(self, priority: str) -> None:
        """One arrival shed by the overload controller (not ported yet;
        sheds do not enter the attainment window)."""
        self._classes[priority].counts["shed"] += 1

    def note_retired(self, req) -> None:
        """A request retired.  The JAX package observes its TPOT here;
        that histogram comes with the monitor, so nothing is counted."""

    def note_preempted(self, req) -> None:
        self._count(req, "preempted")

    def note_resumed(self, req) -> None:
        self._count(req, "resumed")

    def note_chunk(self, req) -> None:
        self._count(req, "chunks")

    def note_chunk_deferred(self, req) -> None:
        self._count(req, "deferrals")

    def note_preempt_expired(self, req) -> None:
        self._count(req, "preempt_expired")
