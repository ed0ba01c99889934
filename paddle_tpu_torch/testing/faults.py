"""Deterministic fault injection for the serving stack (a copy of
paddle_tpu/testing/faults.py, which the port cannot import: it would load
jax through ``paddle_tpu/__init__.py``).

A :class:`FaultPlan` is a list of rules, each naming an instrumented
*site* and when/how to fire there.  The engine and the page allocator
call :func:`maybe_fire` at their sites; with no plan installed that is
one global ``is None`` check — the serving hot path pays nothing.  With
a plan installed, a matching rule either raises :class:`FaultError`
(simulating a poisoned request / failed device step) or sleeps (pacing a
step).

The port fires six of the sites: ``prefill``, ``prefill_chunk``,
``decode_step`` and ``engine_wedge`` (``inference.continuous``),
``buffer_loss`` (``inference.paged``, once every decoder step) and
``page_alloc`` (``ops.paged_attention.PagedKVCache``).  The others are
kept so that a plan written for the JAX package validates here; each
waits for the port of the module that fires it (the HTTP server, the
journal, the fleet router).

Sites (the names the JAX runtime fires):

  ``prefill``       once per sequence prefill, ``seq_ids=[seq_id]``
                    (fired on the FIRST chunk when prefill is chunked,
                    so plans written against it keep their semantics)
  ``prefill_chunk`` once per chunked-prefill dispatch,
                    ``seq_ids=[seq_id]`` — combine with ``nth`` to
                    poison a specific chunk of a specific sequence
  ``decode_step``   once per compiled decode-step attempt, with the
                    stepped batch's ``seq_ids`` (retry and bisect
                    attempts fire again — a *sticky* seq-targeted rule
                    keeps failing until the sequence is quarantined)
  ``page_alloc``    once per page taken from the pool free list
  ``http_handler``  once per POST /generate before engine submission
  ``buffer_loss``   device-fault site: fired once in every paged
                    decoder step, just before its body runs, with the
                    step's ``seq_ids``; when it fires the cache's pools
                    are ZEROED IN PLACE (``PagedKVCache.reset_pools``:
                    the KV is lost, ``generation`` bumps, the prefix
                    index is dropped) before the error propagates, as a
                    real device-side step failure would lose them — the
                    engine must then replay every survivor's KV.  The
                    JAX decoder deletes its donated buffers instead and
                    rebuilds them; the port's pools are never donated,
                    and zeroing keeps their addresses, so captured CUDA
                    graphs stay valid
  ``engine_wedge``  device-fault site: fired inside the
                    engine's decode-step window; a ``delay`` rule here
                    emulates a wedged step long enough for the
                    watchdog heartbeat to fire and trigger the bounded
                    rebuild + survivor-replay restart path
  ``journal_write`` durability-fault site: fired on the
                    journal writer thread before each record frame is
                    written; an ``error`` rule TEARS the write — half
                    the frame reaches the file, exactly what a crash
                    mid-write leaves — and the writer rotates to a
                    fresh segment so recovery's torn-tail truncation
                    is what loses the record, not the emulation
  ``journal_fsync`` durability-fault site: fired at each
                    journal fsync point; a ``delay`` rule emulates a
                    hung fsync (the watchdog heartbeat then degrades
                    the journal to os-policy instead of stalling), an
                    ``error`` rule a failed fsync (counted + degraded)
  ``route_admit``   router-fault site: fired by the fleet
                    router before each admission FORWARD attempt (every
                    retry fires again) — an ``error`` rule emulates a
                    route that fails before reaching any replica, so
                    the bounded-backoff retry ladder is testable
                    without killing a replica
  ``replica_probe`` router-fault site: fired by the replica
                    supervisor before each health probe; a sticky
                    ``error`` rule makes a healthy replica LOOK dead
                    (probe failures accrue, the circuit opens, the
                    heartbeat ages) — the failover path minus the
                    actual corpse

Rule dict fields (JSON-friendly — the JAX package's
``tools/serve_bench.py --fault-plan`` takes exactly this as a JSON
document):

  ``site``         required, one of :data:`SITES`
  ``kind``         ``"error"`` (default) or ``"delay"``
  ``nth``          fire exactly on the nth *matching* occurrence
                   (1-based), once
  ``seq_id``       only invocations whose ``seq_ids`` contain this id
                   match; without ``nth``/``probability`` the rule is
                   STICKY (fires on every match) — the shape bisection
                   quarantine needs to eject
  ``probability``  fire each match with this chance, drawn from the
                   plan's seeded RNG (deterministic per plan seed)
  ``delay_s``      sleep for ``kind="delay"`` (default 0.05)
  ``message``      FaultError text override

All counting and RNG state lives in the plan, guarded by one lock —
the engine scheduler thread and HTTP handler threads fire
concurrently.  ``plan.fired`` records every shot for assertions.
"""
from __future__ import annotations

import json
import random
import threading
import time
from typing import Dict, List, Optional, Sequence

__all__ = [
    "SITES", "FaultError", "FaultRule", "FaultPlan",
    "install", "clear", "active", "maybe_fire", "installed",
]

SITES = ("prefill", "prefill_chunk", "decode_step", "page_alloc",
         "http_handler", "buffer_loss", "engine_wedge",
         "journal_write", "journal_fsync", "route_admit",
         "replica_probe")


class FaultError(Exception):
    """An injected failure.  Deliberately NOT a RuntimeError: the JAX
    package's GenerationServer maps RuntimeError to 503 (retryable
    capacity), and an injected fault must surface as the 500 a real
    unexpected server fault would."""


class FaultRule:
    """One site's firing rule (see module docstring for field
    semantics)."""

    __slots__ = ("site", "kind", "nth", "seq_id", "probability",
                 "delay_s", "message", "_matches", "_fires")

    def __init__(self, site: str, kind: str = "error",
                 nth: Optional[int] = None, seq_id=None,
                 probability: Optional[float] = None,
                 delay_s: float = 0.05, message: str = ""):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; "
                             f"sites are {SITES}")
        if kind not in ("error", "delay"):
            raise ValueError(f"fault kind must be 'error' or 'delay', "
                             f"got {kind!r}")
        self.site = site
        self.kind = kind
        self.nth = None if nth is None else int(nth)
        self.seq_id = seq_id
        self.probability = probability
        self.delay_s = float(delay_s)
        self.message = message
        self._matches = 0        # matching invocations seen
        self._fires = 0          # times this rule actually fired

    def _should_fire(self, rng: random.Random, seq_ids) -> bool:
        """Caller holds the plan lock."""
        if self.seq_id is not None:
            if seq_ids is None or self.seq_id not in seq_ids:
                return False
        self._matches += 1
        if self.nth is not None:
            return self._matches == self.nth       # exactly once
        if self.probability is not None:
            return rng.random() < self.probability
        return True                                # sticky

    def describe(self) -> str:
        tgt = f" seq={self.seq_id}" if self.seq_id is not None else ""
        when = (f" nth={self.nth}" if self.nth is not None
                else f" p={self.probability}"
                if self.probability is not None else " sticky")
        return f"{self.site}/{self.kind}{tgt}{when}"


class FaultPlan:
    """A seeded, thread-safe set of fault rules."""

    def __init__(self, rules: Sequence[Dict], seed: int = 0):
        self.rules: List[FaultRule] = [
            r if isinstance(r, FaultRule) else FaultRule(**r)
            for r in rules]
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        #: every shot taken: (site, rule_index, seq_ids or None)
        self.fired: List[tuple] = []

    @classmethod
    def from_json(cls, doc) -> "FaultPlan":
        """Build from a JSON string or already-parsed dict:
        ``{"seed": 0, "rules": [{"site": ..., ...}, ...]}`` (a bare
        list is taken as the rules)."""
        if isinstance(doc, (str, bytes)):
            doc = json.loads(doc)
        if isinstance(doc, list):
            doc = {"rules": doc}
        return cls(doc.get("rules", []), seed=doc.get("seed", 0))

    def error_rule_count(self) -> int:
        return sum(1 for r in self.rules if r.kind == "error")

    def fire(self, site: str, seq_ids=None) -> None:
        """Evaluate every rule for this site; the first firing error
        rule raises (delays all sleep first, outside the lock)."""
        delays, err = [], None
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.site != site:
                    continue
                if not rule._should_fire(self._rng, seq_ids):
                    continue
                rule._fires += 1
                self.fired.append(
                    (site, i, None if seq_ids is None else list(seq_ids)))
                if rule.kind == "delay":
                    delays.append(rule.delay_s)
                elif err is None:
                    err = FaultError(
                        rule.message
                        or f"injected fault at {rule.describe()}")
        for d in delays:
            time.sleep(d)
        if err is not None:
            raise err

    def snapshot(self) -> List[dict]:
        """Per-rule (matches, fires) for assertions/bench output."""
        with self._lock:
            return [{"rule": r.describe(), "matches": r._matches,
                     "fires": r._fires} for r in self.rules]


_active: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide active plan (replaces any
    previous one).  Returns the plan for chaining."""
    global _active
    if not isinstance(plan, FaultPlan):
        plan = FaultPlan.from_json(plan)
    _active = plan
    return plan


def clear() -> None:
    global _active
    _active = None


def active() -> Optional[FaultPlan]:
    return _active


def maybe_fire(site: str, seq_ids=None) -> None:
    """The runtime's hook: no-op unless a plan is installed."""
    plan = _active
    if plan is not None:
        plan.fire(site, seq_ids)


class installed:
    """``with faults.installed(plan): ...`` — install for the block,
    always clear after (test hygiene: a leaked plan poisons every later
    engine in the process)."""

    def __init__(self, plan):
        self.plan = install(plan) if not isinstance(plan, FaultPlan) \
            else plan

    def __enter__(self):
        install(self.plan)
        return self.plan

    def __exit__(self, *exc):
        clear()
        return False
