"""Port parity: the port's ``WorkloadScheduler``
(``paddle_tpu_torch.inference.scheduler``) against the JAX package's on
the same seeded streams of operations (host only, no model).

Each stream pushes stand-in requests over the three default classes and
three tenants into bounded queues, pops with a seeded cost table whose
``can_admit`` sometimes refuses a request and sometimes under a
``max_rank``, reaps requests that were cancelled or expired, and now and
then pops everything.  After every operation the two schedulers must
agree: the request popped, the ``QueueFull`` raised (class, depth,
bound), ``depths()``, ``tenant_depths()`` and ``policy()``."""
import dataclasses

import numpy as np
import pytest

from paddle_tpu.inference import scheduler as jax_sched
from paddle_tpu_torch.inference import scheduler as port_sched

CLASSES = (None, "interactive", "standard", "batch")
TENANTS = ("t0", "t1", "t2")


class _Stub:
    """What the scheduler reads of a request: its class, its tenant and
    whether its lifecycle ended."""

    def __init__(self, ident, priority, tenant):
        self.ident = ident
        self.priority = priority
        self.tenant = tenant
        self.dead = False

    def _lifecycle_error(self, now, queued):
        assert queued
        return RuntimeError("ended") if self.dead else None


def _ident(req):
    return None if req is None else req.ident


def _state(s):
    return s.depths(), s.tenant_depths(), s.policy(), len(s)


def _push(s, req):
    try:
        s.push(req)
    except (jax_sched.QueueFull, port_sched.QueueFull) as e:
        return (e.priority_class, e.depth, e.bound, str(e))
    return None


def _stream(seed, n_ops=200):
    """Drive both schedulers through one seeded stream; returns the
    number of pops that admitted a request and of QueueFull raised."""
    rng = np.random.default_rng(seed)
    jax_s = jax_sched.WorkloadScheduler(max_queue=3)
    port_s = port_sched.WorkloadScheduler(max_queue=3)
    twins = {}               # ident -> (JAX stub, port stub)
    cost = {}                # ident -> pages the request would reserve
    popped = full = 0
    for step in range(n_ops):
        op = rng.choice(["push", "pop", "reap", "pop_all"],
                        p=[0.5, 0.35, 0.12, 0.03])
        if op == "push":
            ident = len(twins)
            cls = CLASSES[rng.integers(len(CLASSES))]
            tenant = TENANTS[rng.integers(len(TENANTS))]
            pair = (_Stub(ident, cls, tenant), _Stub(ident, cls, tenant))
            twins[ident] = pair
            cost[ident] = int(rng.integers(1, 9))
            got = [_push(jax_s, pair[0]), _push(port_s, pair[1])]
            assert got[0] == got[1], (step, got)
            assert pair[0].priority == pair[1].priority
            full += got[0] is not None
        elif op == "pop":
            # a request fits while its cost is within this pop's room;
            # can_admit stays pure within the call
            room = int(rng.integers(0, 10))
            max_rank = [None, None, 0, 1, 2][rng.integers(5)]

            def can_admit(req, room=room):
                c = cost[req.ident]
                return c if c <= room else None

            got = [_ident(jax_s.pop_next(can_admit, max_rank=max_rank)),
                   _ident(port_s.pop_next(can_admit, max_rank=max_rank))]
            assert got[0] == got[1], (step, room, max_rank, got)
            popped += got[0] is not None
        elif op == "reap":
            queued = [r.ident for r in port_s.pending()]
            for ident in queued:
                if rng.random() < 0.3:
                    for stub in twins[ident]:
                        stub.dead = True
            got = [sorted(_ident(r) for r in jax_s.reap(0.0)),
                   sorted(_ident(r) for r in port_s.reap(0.0))]
            assert got[0] == got[1], (step, got)
        else:
            got = [[_ident(r) for r in jax_s.pop_all()],
                   [_ident(r) for r in port_s.pop_all()]]
            assert got[0] == got[1], (step, got)
        assert _state(jax_s) == _state(port_s), (step, op)
        assert [_ident(r) for r in jax_s.pending()] \
            == [_ident(r) for r in port_s.pending()]
        assert jax_s.min_waiting_rank() == port_s.min_waiting_rank()
        assert _ident(jax_s.peek_urgent()) == _ident(port_s.peek_urgent())
    return popped, full, port_s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_operation_stream_matches_jax(seed):
    popped, full, port_s = _stream(seed)
    # the stream exercised admission and the queue bound
    assert popped > 20 and full > 0
    rejected = sum(c["rejected"] for c in port_s.counts().values())
    assert rejected == full


def test_default_classes_match_jax():
    assert [dataclasses.asdict(c) for c in port_sched.DEFAULT_CLASSES] \
        == [dataclasses.asdict(c) for c in jax_sched.DEFAULT_CLASSES]
    assert port_sched.DEFAULT_CLASS == jax_sched.DEFAULT_CLASS
    assert port_sched._DEFICIT_CAP_ROUNDS == jax_sched._DEFICIT_CAP_ROUNDS


def test_resolve_and_construction_errors_match_jax():
    """Unknown classes, duplicate names, an empty taxonomy and an unknown
    default class raise ValueError in both, with the same message."""
    cases = [
        lambda m: m.WorkloadScheduler().resolve("gold"),
        lambda m: m.WorkloadScheduler(classes=()),
        lambda m: m.WorkloadScheduler(classes=(
            m.PriorityClass("a", 0), m.PriorityClass("a", 1))),
        lambda m: m.WorkloadScheduler(default_class="gold"),
    ]
    for case in cases:
        msgs = []
        for mod in (jax_sched, port_sched):
            with pytest.raises(ValueError) as e:
                case(mod)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_attainment_window_matches_jax():
    """A class with a TTFT budget: the sliding attainment window and the
    policy report agree with JAX's over 100 first tokens (the window
    holds the last 64)."""
    rng = np.random.default_rng(3)
    scheds = [m.WorkloadScheduler(classes=(
        m.PriorityClass("chat", 0, weight=4, deadline_s=0.5),
        m.PriorityClass("bulk", 1, preemptible=True)),
        default_class="bulk") for m in (jax_sched, port_sched)]
    for ttft in rng.uniform(0.0, 1.0, 100):
        for s in scheds:
            s.note_first_token(_Stub(0, "chat", "t0"), float(ttft))
            s.note_first_token(_Stub(0, "bulk", "t0"), float(ttft))
    assert scheds[0].attainment("chat") == scheds[1].attainment("chat")
    assert scheds[1].attainment("bulk") is None
    assert scheds[0].policy() == scheds[1].policy()


def test_counts_follow_the_hooks():
    s = port_sched.WorkloadScheduler()
    req = _Stub(0, "batch", "t0")
    for hook in (s.note_admitted, s.note_preempted, s.note_resumed,
                 s.note_chunk, s.note_chunk, s.note_chunk_deferred,
                 s.note_preempt_expired, s.note_retired):
        hook(req)
    s.note_shed("interactive")
    counts = s.counts()
    assert counts["batch"] == dict(admitted=1, rejected=0, preempted=1,
                                   resumed=1, chunks=2, deferrals=1,
                                   preempt_expired=1, shed=0)
    assert counts["interactive"]["shed"] == 1
    assert not any(counts["standard"].values())
