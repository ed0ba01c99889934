"""The port's fault-injection harness (``paddle_tpu_torch.testing.faults``)
against the JAX package's, and the engine's per-request failure isolation
driven by it (CPU, f32).

The plans fire exactly as JAX's on the same rules, seed and calls.  Under
the JAX package's fault scenarios (``tests/test_engine_faults.py``
``TestQuarantine``, ``tests/test_unified_step.py``'s fallback and
diversion tests) the port's engine fails exactly the poisoned request:
the others finish with the JAX engine's streams, the pool comes back
whole and only the pad headroom stays reserved."""
import json
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.testing import faults as jax_faults
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.ops.paged_attention import PagedKVCache
from paddle_tpu_torch.testing import faults

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(total_pages=64, page_size=8, max_batch=4)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear()


# ----------------------------------------------------------- the plans
# (rules, seed, calls): each call is (site, seq_ids)
PLANS = {
    "nth": ([{"site": "decode_step", "nth": 3},
             {"site": "prefill", "nth": 1, "message": "first prefill"}],
            0, [("decode_step", [0, 1])] * 5 + [("prefill", [4])] * 2),
    "sticky_seq": ([{"site": "decode_step", "seq_id": 2}],
                   0, [("decode_step", [0, 1]), ("decode_step", [1, 2]),
                       ("decode_step", [2]), ("decode_step", None),
                       ("prefill", [2])]),
    "seq_and_nth": ([{"site": "prefill_chunk", "seq_id": 1, "nth": 2}],
                    0, [("prefill_chunk", [0]), ("prefill_chunk", [1])]
                    * 3),
    "probability": ([{"site": "decode_step", "probability": 0.4},
                     {"site": "page_alloc", "probability": 0.7}],
                    1234, [("decode_step", [i]) for i in range(20)]
                    + [("page_alloc", None)] * 20),
    "delay": ([{"site": "decode_step", "kind": "delay", "delay_s": 0.01},
               {"site": "decode_step", "nth": 2}],
              0, [("decode_step", [0])] * 3),
}


def _drive(mod, rules, seed, calls):
    """Fire ``calls`` through a plan of ``mod`` (the port's or JAX's
    faults module): which calls raised (with the message), the plan's
    shot log and its per-rule snapshot."""
    plan = mod.FaultPlan(rules, seed=seed)
    raised = []
    with mod.installed(plan):
        for site, seq_ids in calls:
            try:
                mod.maybe_fire(site, seq_ids=seq_ids)
                raised.append(None)
            except mod.FaultError as e:
                raised.append(str(e))
    assert mod.active() is None
    return raised, plan.fired, plan.snapshot()


@pytest.mark.parametrize("name", list(PLANS))
def test_plans_fire_exactly_as_jax(name):
    rules, seed, calls = PLANS[name]
    got = _drive(faults, rules, seed, calls)
    assert got == _drive(jax_faults, rules, seed, calls)
    assert any(got[0])


def test_nth_sticky_and_probability_semantics():
    raised, _fired, _snap = _drive(faults, *PLANS["nth"])
    assert raised[:5] == [None, None, "injected fault at decode_step/error "
                          "nth=3", None, None]
    assert raised[5:] == ["first prefill", None]
    raised, _fired, snap = _drive(faults, *PLANS["sticky_seq"])
    assert raised == [None, raised[1], raised[1], None, None]
    assert snap == [{"rule": "decode_step/error seq=2 sticky",
                     "matches": 2, "fires": 2}]
    raised, _fired, _snap = _drive(faults, *PLANS["probability"])
    again, _fired, _snap = _drive(faults, *PLANS["probability"])
    assert raised == again and 0 < sum(r is not None for r in raised) < 40


def test_delay_rule_sleeps_and_never_raises():
    plan = faults.FaultPlan([{"site": "decode_step", "kind": "delay",
                              "delay_s": 0.05}])
    with faults.installed(plan):
        t0 = time.perf_counter()
        faults.maybe_fire("decode_step", seq_ids=[0])
        assert time.perf_counter() - t0 >= 0.05
    assert plan.snapshot()[0]["fires"] == 1
    assert isinstance(faults.FaultError("x"), Exception)
    assert not isinstance(faults.FaultError("x"), RuntimeError)


def test_json_round_trip_and_validation():
    doc = {"seed": 7, "rules": [{"site": "prefill", "nth": 2},
                                {"site": "decode_step", "seq_id": 3,
                                 "kind": "delay", "delay_s": 0.0}]}
    for src in (doc, json.dumps(doc)):
        plan = faults.FaultPlan.from_json(src)
        want = jax_faults.FaultPlan.from_json(src)
        assert plan.seed == want.seed == 7
        assert [r.describe() for r in plan.rules] \
            == [r.describe() for r in want.rules]
        assert plan.error_rule_count() == want.error_rule_count() == 1
    assert len(faults.FaultPlan.from_json(doc["rules"]).rules) == 2
    assert faults.install(json.dumps(doc)).seed == 7
    faults.clear()
    assert faults.active() is None
    faults.maybe_fire("decode_step")        # no plan: a no-op
    assert faults.SITES == jax_faults.SITES
    for bad, match in (({"site": "nowhere"}, "unknown fault site"),
                       ({"site": "prefill", "kind": "explode"},
                        "fault kind must be")):
        with pytest.raises(ValueError, match=match):
            faults.FaultPlan([bad])
        with pytest.raises(ValueError, match=match):
            jax_faults.FaultPlan([bad])


def test_page_alloc_site_fires_in_the_cache():
    cache = PagedKVCache(1, 1, 8, total_pages=8, page_size=4, device="cpu")
    with faults.installed(faults.FaultPlan([{"site": "page_alloc",
                                             "nth": 2}])):
        cache.allocate(0, 4)
        with pytest.raises(faults.FaultError):
            cache.allocate(1, 4)
        cache.allocate(1, 4)
    assert cache.free_pages == 6


# -------------------------------------------------- the engine scenarios
def _rng_prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (n,)).astype(np.int32) for n in sizes]


def _sharers(seed):
    """A seed prompt and three prompts sharing its 16-token prefix."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, 64, (16,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 64, (5,))])
               .astype(np.int32) for _ in range(4)]
    return prompts[3], prompts[:3]


# every prompt whose greedy stream a scenario checks, with its budget
SCENARIOS = {
    "prefill": [(p, 6) for p in _rng_prompts(7, (5, 5, 5))],
    "bisect": [(p, 6) for p in _sharers(8)[1]] + [(_sharers(8)[0], 2)],
    "transient": [(p, 8) for p in _rng_prompts(9, (5,))],
    "queued": [(p, 6) for p in _rng_prompts(11, (5, 9, 7, 6))],
    "fallback": [(p, m) for p, m in zip(_rng_prompts(12, (5, 9)), (8, 6))],
}


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


@pytest.fixture(scope="module")
def ref(models):
    """The JAX engine's greedy stream of every scenario prompt, served
    once, without faults: {(prompt bytes, budget): stream}."""
    jm, _tm = models
    todo = {(p.tobytes(), m): p for rows in SCENARIOS.values()
            for p, m in rows}
    with JaxEngine(jm, unified_step=False, **ENGINE) as eng:
        reqs = {key: eng.submit(p, max_new_tokens=key[1])
                for key, p in todo.items()}
        return {key: r.result(timeout=300).tolist()
                for key, r in reqs.items()}


def _want(ref, p, m):
    return ref[(p.tobytes(), m)]


def _drained(eng):
    """The pool back whole and only the pad headroom reserved, once the
    loop has retired everything."""
    t0 = time.monotonic()
    while eng.cache.free_pages != ENGINE["total_pages"] \
            and time.monotonic() - t0 < 30:
        time.sleep(0.01)
    assert eng.cache.free_pages == ENGINE["total_pages"]
    assert eng._reserved_pages == 1


def test_poisoned_prefill_errors_only_that_request(models, ref):
    _jm, tm = models
    rows = SCENARIOS["prefill"]
    plan = faults.FaultPlan([{"site": "prefill", "nth": 2}])
    with faults.installed(plan), ContinuousBatchingEngine(
            tm, device="cpu", **ENGINE) as eng:
        reqs = [eng.submit(p, max_new_tokens=m) for p, m in rows]
        with pytest.raises(faults.FaultError):
            reqs[1].result(timeout=120)
        for i in (0, 2):
            assert reqs[i].result(timeout=120).tolist() \
                == _want(ref, *rows[i])
        _drained(eng)
        assert eng.quarantined == 1
        assert eng.dispatches["ragged"] == 0


def test_decode_bisection_ejects_poisoned_sharer(models, ref):
    """A sticky mid-decode fault on one prefix-cache sharer: bisection
    ejects exactly it; the healthy sharers keep their refcounted prefix
    pages and finish with the JAX engine's streams."""
    _jm, tm = models
    seed_prompt, prompts = _sharers(8)
    # seq 0 seeds the prefix; sharers are seqs 1..3 — poison seq 2
    plan = faults.FaultPlan([{"site": "decode_step", "seq_id": 2}])
    with faults.installed(plan), ContinuousBatchingEngine(
            tm, device="cpu", **ENGINE) as eng:
        assert eng.submit(seed_prompt, max_new_tokens=2).result(
            timeout=120).tolist() == _want(ref, seed_prompt, 2)
        with eng._cond:     # admitted together: one decode batch
            reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        with pytest.raises(faults.FaultError):
            reqs[1].result(timeout=120)       # seq 2 = reqs[1]
        for i in (0, 2):
            assert reqs[i].result(timeout=120).tolist() \
                == _want(ref, prompts[i], 6)
        assert reqs[0].prefix_tokens == reqs[2].prefix_tokens == 16
        _drained(eng)
        assert not eng.cache._seq_refs
        assert eng.cache.cached_prefix_pages > 0
        assert eng.quarantined == 1
        # after the failed attempt: its retry, the halves [seq 1, seq 2]
        # and [seq 3], and the failing half's two solo probes
        assert eng.decode_retries == 5
        assert eng.dispatches["ragged"] == 0


def test_transient_decode_fault_retries_and_recovers(models, ref):
    _jm, tm = models
    (p, m), = SCENARIOS["transient"]
    plan = faults.FaultPlan([{"site": "decode_step", "nth": 3}])
    with faults.installed(plan), ContinuousBatchingEngine(
            tm, device="cpu", **ENGINE) as eng:
        assert eng.submit(p, max_new_tokens=m).result(
            timeout=120).tolist() == _want(ref, p, m)
        assert (eng.decode_retries, eng.quarantined) == (1, 0)
        _drained(eng)


def test_page_alloc_fault_quarantines_the_allocating_request(models, ref):
    """The second page taken from the pool belongs to the second
    prefill of the iteration: that request alone fails."""
    _jm, tm = models
    rows = SCENARIOS["prefill"]
    plan = faults.FaultPlan([{"site": "page_alloc", "nth": 2}])
    with faults.installed(plan), ContinuousBatchingEngine(
            tm, device="cpu", **ENGINE) as eng:
        with eng._cond:
            reqs = [eng.submit(p, max_new_tokens=m) for p, m in rows]
        with pytest.raises(faults.FaultError):
            reqs[1].result(timeout=120)
        for i in (0, 2):
            assert reqs[i].result(timeout=120).tolist() \
                == _want(ref, *rows[i])
        _drained(eng)
        assert eng.quarantined == 1


def test_failed_decode_step_spares_queued_requests(models, ref):
    """A decode step that fails for one request ejects that request
    alone: the ones still queued behind a full batch are admitted later
    and finish with the JAX engine's streams (``_fail_all`` would have
    errored them all)."""
    _jm, tm = models
    rows = SCENARIOS["queued"]
    plan = faults.FaultPlan([{"site": "decode_step", "seq_id": 0}])
    with faults.installed(plan), ContinuousBatchingEngine(
            tm, device="cpu", **dict(ENGINE, max_batch=2)) as eng:
        with eng._cond:
            reqs = [eng.submit(p, max_new_tokens=m) for p, m in rows]
            assert len(eng._sched) == 4
        with pytest.raises(faults.FaultError):
            reqs[0].result(timeout=120)
        for r, (p, m) in zip(reqs[1:], rows[1:]):
            assert r.result(timeout=120).tolist() == _want(ref, p, m)
        _drained(eng)
        assert eng.quarantined == 1


def test_dispatch_failure_falls_back_to_legacy_exactly(models, ref):
    """A ragged step failing on an injected fault rolls the composition
    back and re-runs the same iteration through the legacy composition:
    tokens identical, fallbacks counted, and 3 failures in a row latch
    the unified path off for the engine's lifetime."""
    _jm, tm = models
    rows = SCENARIOS["fallback"]
    with ContinuousBatchingEngine(tm, device="cpu", **ENGINE) as eng:
        def broken(*a, **kw):
            raise faults.FaultError("injected ragged dispatch failure")

        eng._decoder.ragged_step = broken
        reqs = [eng.submit(p, max_new_tokens=m) for p, m in rows]
        outs = [r.result(timeout=300).tolist() for r in reqs]
        assert eng._unified_off
        assert eng.unified_fallbacks == 3
        assert eng.dispatches["ragged"] == 3
        assert eng.quarantined == 0
        _drained(eng)
    assert outs == [_want(ref, p, m) for p, m in rows]


def test_delay_pacing_plan_stays_unified(models, ref):
    """A delay-kind rule on a dispatch site is pacing, not failure
    injection: the unified step fires the site itself and stays
    unified."""
    _jm, tm = models
    rows = SCENARIOS["fallback"]
    plan = faults.FaultPlan([{"site": "decode_step", "kind": "delay",
                              "delay_s": 0.002}])
    with faults.installed(plan), ContinuousBatchingEngine(
            tm, device="cpu", **ENGINE) as eng:
        outs = [eng.submit(p, max_new_tokens=m) for p, m in rows]
        outs = [r.result(timeout=300).tolist() for r in outs]
        assert eng.dispatches["ragged"] > 0 and eng.dispatches["decode"] == 0
    assert plan.snapshot()[0]["fires"] == eng.dispatches["ragged"]
    assert outs == [_want(ref, p, m) for p, m in rows]


def test_fault_plan_iterations_divert_to_legacy(models, ref):
    """An iteration under an engine-site fault plan runs the legacy
    composition: the fault fires at its documented site, is retried, and
    the output still matches."""
    _jm, tm = models
    rows = SCENARIOS["fallback"]
    plan = faults.FaultPlan([{"site": "decode_step", "nth": 2}])
    with faults.installed(plan), ContinuousBatchingEngine(
            tm, device="cpu", **ENGINE) as eng:
        outs = [eng.submit(p, max_new_tokens=m) for p, m in rows]
        outs = [r.result(timeout=300).tolist() for r in outs]
        assert eng.dispatches["ragged"] == 0 and eng.dispatches["decode"] > 0
        assert (eng.decode_retries, eng.quarantined) == (1, 0)
    assert outs == [_want(ref, p, m) for p, m in rows]


def test_single_fallback_with_padded_rows_returns_the_pad_page(models, ref):
    """One injected ragged failure with three active rows: the legacy
    re-run pads its decode step to four rows on the scratch sequence,
    the unified path (not latched) finishes the requests, and its
    retirement gives the scratch page back, so the drained pool is
    whole."""
    _jm, tm = models
    rows = SCENARIOS["prefill"]
    with ContinuousBatchingEngine(tm, device="cpu", **ENGINE) as eng:
        real = eng._decoder.ragged_step
        calls = []

        def once(*a, **kw):
            calls.append(len(a[1]))
            if len(calls) == 1:
                raise faults.FaultError("injected ragged dispatch failure")
            return real(*a, **kw)

        eng._decoder.ragged_step = once
        with eng._cond:     # admitted together: one batch of three
            reqs = [eng.submit(p, max_new_tokens=m) for p, m in rows]
        outs = [r.result(timeout=300).tolist() for r in reqs]
        assert calls[0] == 3
        assert (eng.unified_fallbacks, eng._unified_off) == (1, False)
        assert eng.dispatches["decode"] == 1
        assert eng.dispatches["ragged"] == len(calls) > 1
        _drained(eng)
    assert outs == [_want(ref, p, m) for p, m in rows]


def test_ragged_kernel_error_fails_its_requests_without_fallback(models,
                                                                 ref):
    """A ragged step that fails for a reason other than an injected fault
    (a kernel that does not build or launch) is not re-run through the
    legacy composition, whose other code would hide it: the requests of
    that step fail with its error, nothing latches, and the requests
    queued behind them are served with the JAX engine's streams."""
    _jm, tm = models
    rows = SCENARIOS["queued"]
    with ContinuousBatchingEngine(
            tm, device="cpu", **dict(ENGINE, max_batch=2)) as eng:
        real = eng._decoder.ragged_step
        calls = []

        def broken_once(*a, **kw):
            calls.append(len(a[1]))
            if len(calls) == 1:
                raise RuntimeError("ragged kernel launch failed")
            return real(*a, **kw)

        eng._decoder.ragged_step = broken_once
        with eng._cond:
            reqs = [eng.submit(p, max_new_tokens=m) for p, m in rows]
        for r in reqs[:2]:
            with pytest.raises(RuntimeError, match="ragged kernel"):
                r.result(timeout=120)
        for r, (p, m) in zip(reqs[2:], rows[2:]):
            assert r.result(timeout=120).tolist() == _want(ref, p, m)
        assert calls[0] == 2
        assert (eng.unified_fallbacks, eng._unified_failures) == (0, 0)
        assert not eng._unified_off
        assert eng.quarantined == 2
        assert eng.dispatches["decode"] == eng.decode_retries == 0
        _drained(eng)
