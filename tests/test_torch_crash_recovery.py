"""Port parity: the engine's crash recovery against the JAX engine on the
same weights (the tiny model of ``tests/test_crash_recovery.py``, its
JAX weights carried over; CPU, f32).

Four requests are served to mid-decode, then one fault is injected at a
step boundary: a transient ``buffer_loss`` (both pools zeroed), a sticky
one on one sequence, sampled rows, a draft attached (the loss on the
verify), int8 KV pages under w8 weights, a late prefix sharer after the
loss, a step the watchdog flags as wedged, a snapshot restored on a fresh
engine.  Every surviving stream must equal the JAX engine's fault-free
stream token for token, a sticky fault must fail exactly its request,
and the engine must drain with both pools whole.  Replay runs batched
and a row at a time; the engine runs the unified step and the legacy
composition.  A snapshot taken by either engine restores on the other.
The JAX engine's fault-free runs are made once for the module."""
import json
import time
import warnings

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.testing import faults as jax_faults
from paddle_tpu_torch.distributed.watchdog import CommTaskManager
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.testing import faults

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(total_pages=64, page_size=8, max_batch=4)
NEW = 12
SAMPLED = [dict(do_sample=True, temperature=0.8, seed=100 + i)
           for i in range(4)]
INT8 = dict(quantize="w8", kv_quant="int8")
COMPOSITION = pytest.mark.parametrize("unified", [True, False],
                                      ids=["unified", "legacy"])
REPLAY = pytest.mark.parametrize("batched", [True, False],
                                 ids=["batched", "per_row"])


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear()
    jax_faults.clear()


def _prompts():
    rng = np.random.default_rng(20)
    return [rng.integers(0, 64, (5,)).astype(np.int32) for _ in range(4)]


def _prefix_prompts():
    """A seed request, three sharers of its 16-token system prompt and
    a late sharer, each the system prompt + 5 tokens."""
    rng = np.random.default_rng(24)
    system = rng.integers(0, 64, (16,)).astype(np.int32)
    return [np.concatenate([system, rng.integers(0, 64, (5,))])
            .astype(np.int32) for _ in range(5)]


def _streams(eng, prompts, kws=None):
    kws = kws or [{}] * len(prompts)
    reqs = [eng.submit(p, max_new_tokens=NEW, **kw)
            for p, kw in zip(prompts, kws)]
    return [r.result(timeout=120).tolist() for r in reqs]


@pytest.fixture(scope="module")
def want(models):
    """The JAX engine's fault-free streams: greedy, sampled, the prefix
    sharers (each request alone) and greedy under w8 + int8 KV."""
    jm = models[0]
    out = {}
    with JaxEngine(jm, **ENGINE) as eng:
        out["greedy"] = _streams(eng, _prompts())
        out["sampled"] = _streams(eng, _prompts(), SAMPLED)
        out["prefix"] = [_streams(eng, [p])[0] for p in _prefix_prompts()]
    with JaxEngine(jm, **INT8, **ENGINE) as eng:
        out["int8"] = _streams(eng, _prompts())
    return out


def make_engine(model, **kw):
    for k, v in ENGINE.items():
        kw.setdefault(k, v)
    return ContinuousBatchingEngine(model, device="cpu", **kw)


def at_step_boundary(eng, plan):
    """Install a fault plan between two engine steps (the snapshot
    barrier), so its counting starts at a known point."""
    with eng._cond:
        eng._snap_waiters += 1
        try:
            while eng._stepping:
                eng._cond.wait(0.1)
            faults.install(faults.FaultPlan(plan))
        finally:
            eng._snap_waiters -= 1
            eng._cond.notify_all()


def wait_for(cond, what, timeout=60.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.005)


def ripen(eng, prompts, kws=None, min_generated=2, pace=faults):
    """Submit every prompt and wait until each row is mid-decode (a mild
    decode pacing keeps the window open)."""
    pace.install(pace.FaultPlan(
        [{"site": "decode_step", "kind": "delay", "delay_s": 0.01}]))
    kws = kws or [{}] * len(prompts)
    reqs = [eng.submit(p, max_new_tokens=NEW, **kw)
            for p, kw in zip(prompts, kws)]
    wait_for(lambda: all(len(r.generated) >= min_generated for r in reqs),
             "every row mid-decode")
    assert not any(r.done.is_set() for r in reqs)
    return reqs


def results(reqs):
    """Each request's stream, or None if it failed with an injected
    fault."""
    out = []
    for r in reqs:
        try:
            out.append(r.result(timeout=120).tolist())
        except faults.FaultError:
            out.append(None)
    return out


def drained_whole(eng):
    """The engine drains, both pools whole, only the pad headroom
    reserved."""
    faults.clear()
    assert eng.drain(timeout=60)
    assert eng.cache.free_pages == eng.cache.total_pages
    assert eng._reserved_pages == eng._pad_pages
    if eng.draft_cache is not None:
        assert eng.draft_cache.free_pages == eng.draft_cache.total_pages
        assert eng._reserved_draft_pages == eng._pad_pages


@COMPOSITION
@REPLAY
def test_transient_buffer_loss_streams_match_jax(models, want, unified,
                                                 batched):
    with make_engine(models[1], unified_step=unified,
                     replay_batch=batched) as eng:
        reqs = ripen(eng, _prompts())
        at_step_boundary(eng, [{"site": "buffer_loss", "nth": 1}])
        got = results(reqs)
        assert (eng.rebuilds, eng.survivor_replays, eng.quarantined) \
            == (1, 4, 0)
        assert eng.replay_dispatches == (1 if batched else 4)
        assert len(eng.recovery_s) == 1
        drained_whole(eng)
    assert got == want["greedy"]


@COMPOSITION
@REPLAY
def test_sticky_buffer_loss_quarantines_exactly_that_row(models, want,
                                                         unified, batched):
    with make_engine(models[1], unified_step=unified,
                     replay_batch=batched) as eng:
        reqs = ripen(eng, _prompts())
        victim = reqs[2].seq_id
        at_step_boundary(eng, [{"site": "buffer_loss", "seq_id": victim}])
        got = results(reqs)
        assert eng.quarantined == 1
        drained_whole(eng)
    assert got == [None if i == 2 else w
                   for i, w in enumerate(want["greedy"])]


@REPLAY
def test_sampled_rows_replay_exactly(models, want, batched):
    with make_engine(models[1], replay_batch=batched) as eng:
        reqs = ripen(eng, _prompts(), SAMPLED)
        at_step_boundary(eng, [{"site": "buffer_loss", "nth": 1}])
        got = results(reqs)
        assert eng.rebuilds == 1
        drained_whole(eng)
    assert got == want["sampled"]


@REPLAY
def test_buffer_loss_on_the_verify_replays_both_pools(models, want,
                                                      batched):
    """A perfect draft (the target itself): nth=2 passes the draft's
    proposal and lands on the target's verify; both pools replay in
    lockstep and no request is downgraded."""
    tm = models[1]
    with make_engine(tm, draft_model=tm, spec_tokens=3,
                     replay_batch=batched) as eng:
        reqs = ripen(eng, _prompts())
        at_step_boundary(eng, [{"site": "buffer_loss", "nth": 2}])
        got = results(reqs)
        assert eng.rebuilds == 1 and eng.spec_draft_failures == 0
        assert eng.quarantined == 0
        drained_whole(eng)
    assert got == want["greedy"]


@REPLAY
def test_int8_kv_replay_matches_jax(models, want, batched):
    with make_engine(models[1], replay_batch=batched, **INT8) as eng:
        reqs = ripen(eng, _prompts())
        at_step_boundary(eng, [{"site": "buffer_loss", "nth": 1}])
        got = results(reqs)
        assert eng.rebuilds == 1
        drained_whole(eng)
    assert got == want["int8"]


@REPLAY
def test_late_sharer_hits_the_prefix_after_a_loss(models, want, batched):
    """The loss drops the prefix index; the replay registers it again,
    so a sharer admitted after the loss still hits."""
    seed, *sharers, late = _prefix_prompts()
    with make_engine(models[1], replay_batch=batched) as eng:
        first = eng.submit(seed, max_new_tokens=NEW).result(timeout=120)
        reqs = ripen(eng, sharers)
        assert all(r.prefix_tokens == 16 for r in reqs)
        at_step_boundary(eng, [{"site": "buffer_loss", "nth": 1}])
        got = results(reqs)
        faults.clear()
        assert eng.rebuilds == 1
        r_late = eng.submit(late, max_new_tokens=NEW)
        got.append(r_late.result(timeout=120).tolist())
        assert r_late.prefix_tokens == 16
        drained_whole(eng)
    assert [first.tolist()] + got == want["prefix"]


@pytest.fixture
def watchdog():
    mgr = CommTaskManager.instance()
    interval = mgr._scan_interval
    mgr._scan_interval = 0.05
    yield mgr
    mgr.stop()
    mgr._scan_interval = interval


@COMPOSITION
def test_wedged_step_rebuilds_and_streams_match_jax(models, want, unified,
                                                    watchdog):
    """An ``engine_wedge`` delay of 0.6 s under ``step_timeout_s=0.25``:
    the watchdog flags the step, the engine zeroes the pools, replays
    every row and retries."""
    timeouts = watchdog.timeouts
    plan = [{"site": "engine_wedge", "kind": "delay", "delay_s": 0.6,
             "nth": 3}]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with make_engine(models[1], unified_step=unified,
                         step_timeout_s=0.25) as eng:
            assert "engine/decode_step" in watchdog.heartbeat_names()
            with faults.installed(faults.FaultPlan(plan)):
                got = _streams(eng, _prompts())
            assert eng.rebuilds == 1 and eng.quarantined == 0
            drained_whole(eng)
    assert watchdog.timeouts > timeouts
    assert "engine/decode_step" not in watchdog.heartbeat_names()
    assert got == want["greedy"]


def test_wedged_ragged_step_reruns_through_legacy(models, want, watchdog):
    """A decode pacing rule does not divert the unified step, so a slow
    ragged step is flagged as wedged: rolled back, rebuilt, replayed and
    re-run through the legacy composition."""
    plan = [{"site": "decode_step", "kind": "delay", "delay_s": 0.6,
             "nth": 3}]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with make_engine(models[1], step_timeout_s=0.25) as eng:
            with faults.installed(faults.FaultPlan(plan)):
                got = _streams(eng, _prompts())
            assert eng.rebuilds == 1 and eng.unified_fallbacks == 1
            assert eng.dispatches["decode"] >= 1
            drained_whole(eng)
    assert got == want["greedy"]


def _restore_and_finish(eng, snap, prompts, streams):
    restored = eng.restore(snap)
    by_prompt = {tuple(p.tolist()): s for p, s in zip(prompts, streams)}
    got = [r.result(timeout=120).tolist() for r in restored]
    return restored, got, [by_prompt[tuple(r.prompt.tolist())]
                           for r in restored]


@COMPOSITION
def test_snapshot_restore_round_trip(models, want, unified):
    """Greedy and sampled rows (one in the batch class of another
    tenant): snapshot mid-stream, JSON round trip, stop, restore on a
    fresh engine."""
    kws = [{}, dict(priority="batch", tenant="offline"), SAMPLED[2],
           SAMPLED[3]]
    prompts = _prompts()
    streams = want["greedy"][:2] + want["sampled"][2:]
    eng_a = make_engine(models[1], unified_step=unified)
    reqs = ripen(eng_a, prompts, kws, min_generated=3)
    snap = eng_a.snapshot()
    eng_a.stop()
    faults.clear()
    snap = json.loads(json.dumps(snap))
    assert snap["version"] == 1 and len(snap["requests"]) == 4
    assert eng_a.snapshot_requests == 4
    for e in snap["requests"]:
        assert 3 <= len(e["generated"]) < NEW
        assert e["next_token"] is not None
    with make_engine(models[1], unified_step=unified) as eng_b:
        restored, got, expect = _restore_and_finish(eng_b, snap, prompts,
                                                    streams)
        offline = [r for r in restored if r.tenant == "offline"]
        assert len(offline) == 1 and offline[0].priority == "batch"
        assert [r.request_id for r in restored] \
            == [e["request_id"] for e in snap["requests"]]
        drained_whole(eng_b)
    assert got == expect
    assert all(r.error is not None for r in reqs)    # the stopped engine


def test_jax_snapshot_restores_on_the_port(models, want):
    prompts = _prompts()
    eng = JaxEngine(models[0], **ENGINE)
    ripen(eng, prompts, min_generated=3, pace=jax_faults)
    snap = json.loads(json.dumps(eng.snapshot()))
    eng.stop()
    jax_faults.clear()
    with make_engine(models[1]) as port:
        _, got, expect = _restore_and_finish(port, snap, prompts,
                                             want["greedy"])
        drained_whole(port)
    assert got == expect


def test_port_snapshot_restores_on_jax(models, want):
    prompts = _prompts()
    port = make_engine(models[1])
    ripen(port, prompts, min_generated=3)
    snap = json.loads(json.dumps(port.snapshot()))
    port.stop()
    faults.clear()
    with JaxEngine(models[0], **ENGINE) as eng:
        _, got, expect = _restore_and_finish(eng, snap, prompts,
                                             want["greedy"])
    assert got == expect


def test_snapshot_of_an_idle_engine_is_empty(models):
    with make_engine(models[1]) as eng:
        assert eng.snapshot() == {"version": 1, "requests": []}


def test_restore_nonstrict_skips_an_unplaceable_entry(models):
    rng = np.random.default_rng(27)
    good = {"prompt": [int(t) for t in rng.integers(0, 64, (5,))],
            "generated": [], "next_token": None, "max_new_tokens": 4,
            "seed": 1}
    bad = dict(good, max_new_tokens=10_000)      # past the rope table
    snap = {"version": 1, "requests": [bad, good]}
    with make_engine(models[1]) as eng:
        with pytest.raises(ValueError):
            eng.restore(snap)
        with pytest.warns(UserWarning, match="skipped one request"):
            restored = eng.restore(snap, strict=False)
        assert len(restored) == 1
        assert len(restored[0].result(timeout=120)) == 9


def test_remaining_ttl_carries_into_restore(models):
    eng_a = make_engine(models[1])
    ripen(eng_a, _prompts()[:1],
          [dict(ttl_s=600.0, queue_timeout_s=5.0)], min_generated=1)
    snap = eng_a.snapshot()
    eng_a.stop()
    faults.clear()
    remaining = snap["requests"][0]["ttl_remaining_s"]
    assert 0 < remaining < 600.0
    # admitted: the queue-wait deadline is met and not carried
    assert snap["requests"][0]["queue_timeout_remaining_s"] is None
    # nor do the restoring engine's defaults apply
    with make_engine(models[1], default_ttl_s=0.5,
                     default_queue_timeout_s=0.001) as eng_b:
        r = eng_b.restore(snap)[0]
        assert r.ttl_s == pytest.approx(remaining)
        assert r.queue_timeout_s is None and r.queue_deadline is None
        r.result(timeout=120)


def test_request_id_survives_restore(models, want):
    prompts = _prompts()[:2]
    eng_a = make_engine(models[1])
    reqs = [eng_a.submit(prompts[0], max_new_tokens=NEW,
                         request_id="client-7")]
    pace = ripen(eng_a, prompts[1:], min_generated=2)
    assert reqs[0].request_id == "client-7"
    assert pace[0].request_id.startswith("req-") \
        and len(pace[0].request_id) == 20
    snap = eng_a.snapshot()
    eng_a.stop()
    faults.clear()
    with make_engine(models[1]) as eng_b:
        restored = eng_b.restore(snap)
        ids = {r.request_id: r for r in restored}
        assert set(ids) == {"client-7", pace[0].request_id}
        assert ids["client-7"].result(timeout=120).tolist() \
            == want["greedy"][0]


def test_a_live_duplicate_request_id_raises(models):
    p = _prompts()[0]
    with make_engine(models[1]) as eng:
        faults.install(faults.FaultPlan(
            [{"site": "decode_step", "kind": "delay", "delay_s": 0.01}]))
        first = eng.submit(p, max_new_tokens=NEW, request_id="dup")
        with pytest.raises(ValueError, match="already live"):
            eng.submit(p, max_new_tokens=NEW, request_id="dup")
        first.result(timeout=120)
        faults.clear()
        # finished: the id may be used again
        eng.submit(p, max_new_tokens=2, request_id="dup").result(timeout=120)
