"""The port's overload controls, result cache and engine series against
the JAX package's (``paddle_tpu/inference/continuous.py``,
``tests/test_decode_preemption.py``, ``tests/test_engine_faults.py``).

The controllers' decisions are held against JAX's on the same inputs,
each side's method run on an engine shell holding only the state the
method reads: ``retry_after_seconds``, ``_decode_p50_seconds``, the
brownout ladder's rung sequence, ``_shed_decision_locked`` and
``retry_after_hint`` over a grid, and the TPOT trigger's victim.  Then
the engine on the tiny model (f32, CPU, steps paced by ``delay``
faults): a TPOT-parked batch row gives the stream of JAX's engine and of
the run without the pause, a doomed arrival sheds with a truthful
Retry-After, budgetless classes never shed, the ladder climbs and comes
back, rung 1 sheds the lower ranks only, ``result_for`` equals JAX's,
and the process-wide series move as JAX's do for the same workload (as
deltas: the series are process-wide and a worker runs many tests)."""
import math
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)

import paddle_tpu as paddle
from paddle_tpu import monitor as jmon
from paddle_tpu.inference import continuous as jcont
from paddle_tpu.inference import scheduler as jsched
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.monitor import registry as jreg
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.inference import continuous as tcont
from paddle_tpu_torch.inference import scheduler as tsched
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.monitor import registry as treg
from paddle_tpu_torch.testing import faults as tfaults

SIDES = {"jax": (jcont, jsched, jreg), "port": (tcont, tsched, treg)}


# ----------------------------------------------------- controller logic
@pytest.mark.parametrize("depth,p50,want", [
    (0, 0.5, 1), (5, None, 1), (3, 0.001, 1), (10, 0.5, 5), (7, 0.33, 3),
    (1000, 0.5, 30)])
def test_retry_after_seconds_table(depth, p50, want):
    assert tcont.retry_after_seconds(depth, p50) \
        == jcont.retry_after_seconds(depth, p50) == want


@pytest.mark.parametrize("values", [
    (), (0.003,), (0.001, 0.002, 0.004, 0.5), (1e-7, 2.0, 2.0, 40.0),
    (100.0,), (0.01,) * 5 + (3.0,) * 6])
def test_decode_p50_after_the_same_observations(monkeypatch, values):
    got = {}
    for side, (cont, _sched, reg) in SIDES.items():
        h = reg.Histogram("decode_step_seconds", "one step")
        monkeypatch.setattr(cont, "_decode_step_s", h)
        for v in values:
            h.observe(v)
        got[side] = cont._decode_p50_seconds()
    assert got["port"] == got["jax"]
    assert (got["port"] is None) == (not values)


class _Stub:
    """What the scheduler and the controllers read of a request."""

    def __init__(self, priority, generated=0, tenant="t"):
        self.priority = priority
        self.tenant = tenant
        self.request_id = f"stub-{id(self)}"
        self.submitted_at = time.perf_counter()
        self.generated = [0] * generated
        self.prefill_pos = 0
        self.preempted_at = None
        self.paused_total = 0.0
        self._tpot_parked = False
        self.error = None
        self.first_token_at = None
        self.finished_at = None


def _classes(sched_mod, deadlines=(None, None, None, None),
             tpot=(None, None, None, None)):
    return tuple(sched_mod.PriorityClass(
        name, rank=rank, weight=w, preemptible=pre, deadline_s=d,
        tpot_budget_s=b)
        for (name, rank, w, pre), d, b in zip(
            (("interactive", 0, 8, False), ("standard", 1, 4, False),
             ("batch", 2, 1, True), ("bulk", 3, 1, True)),
            deadlines, tpot))


def _shell(side, classes=None, max_queue=8, **state):
    """An engine of ``side`` holding only what the controllers read: its
    scheduler (queues of stub requests), the ladder and the TPOT
    trigger's state."""
    cont, sched_mod, _reg = SIDES[side]
    eng = object.__new__(cont.ContinuousBatchingEngine)
    import threading
    eng._cond = threading.Condition()
    eng._sched = sched_mod.WorkloadScheduler(
        classes=classes or _classes(sched_mod), max_queue=max_queue)
    eng.max_queue = max_queue
    eng.journal = None
    eng.brownout_thresholds = None
    eng.brownout_patience = 3
    eng._brownout = 0
    eng._brownout_calm = 0
    eng.decode_preempt = True
    eng.max_batch = 4
    eng._active, eng._prefilling, eng._preempted = [], [], []
    eng._step_ewma = None
    eng._tpot_last_preempt = 0.0
    eng.tpot_preempt_cooldown_s = 0.0
    eng.preempt_resume_ttl_s = None
    for k, v in state.items():
        setattr(eng, k, v)
    return eng


def _fill(eng, depths):
    """Queue stub requests to reach ``depths`` ({class: n})."""
    for cls, n in depths.items():
        for _ in range(n):
            eng._sched.push(_Stub(cls))


class _LoadSched:
    """A scripted queue for the ladder: its depth and the urgent class's
    attainment."""

    def __init__(self):
        self.n, self.att = 0, None

    def __len__(self):
        return self.n

    def urgent_attainment(self):
        return self.att


def test_brownout_rung_sequence_matches_jax():
    """One scripted run of queue ratios and attainments through both
    ladders: the rungs after every evaluation are equal (climb at once,
    hysteresis and patience on the way down, attainment as pressure)."""
    script = ([(2, None)] * 2 + [(3, None), (5, None), (7, None),
                                 (8, None), (8, None)]
              + [(1, None)] * 4 + [(0, None)] * 7
              + [(0, 0.9), (0, 0.4), (0, 0.2), (0, 0.95)]
              + [(0, 1.0)] * 12 + [(4, 0.7), (4, 0.7), (0, None)] * 2)
    rungs = {}
    for side in SIDES:
        eng = _shell(side, brownout_thresholds=(0.25, 0.5, 0.75, 0.95),
                     brownout_patience=2)
        eng._sched = _LoadSched()
        seq = []
        for n, att in script:
            eng._sched.n, eng._sched.att = n, att
            with eng._cond:
                eng._update_brownout_locked()
            seq.append(eng._brownout)
        rungs[side] = seq
    assert rungs["port"] == rungs["jax"]
    assert max(rungs["port"]) == 4 and rungs["port"][-1] < 4
    assert len(set(rungs["port"])) == 5


def test_brownout_off_and_thresholds_checked(models):
    eng = _shell("port")
    eng._sched = _LoadSched()
    eng._sched.n = 8
    with eng._cond:
        eng._update_brownout_locked()
    assert eng._brownout == 0
    for bad in ((0.5, 0.2, 0.7, 0.9), (0.25, 0.5, 0.75)):
        with pytest.raises(ValueError, match="4 ascending"):
            tcont.ContinuousBatchingEngine(models[1], device="cpu",
                                           brownout_thresholds=bad)


@pytest.mark.parametrize("rung", [0, 1, 2, 3, 4])
def test_shed_decision_and_hint_grid_match_jax(monkeypatch, rung):
    """``_shed_decision_locked`` and ``retry_after_hint`` over class
    rank, queue depth, decode p50 and deadline budget at one rung: equal
    to JAX's at every point."""
    points = 0
    for deadlines in ((None, None, None, None), (0.05, 1.0, 0.02, None),
                      (2.0, 0.5, 1e-9, 10.0)):
        for depth in (0, 1, 3, 40):
            for p50 in (None, 0.004, 0.3):
                got = {}
                for side, (cont, sched_mod, _r) in SIDES.items():
                    monkeypatch.setattr(cont, "_decode_p50_seconds",
                                        lambda v=p50: v)
                    eng = _shell(side, _classes(sched_mod, deadlines),
                                 max_queue=64, _brownout=rung)
                    _fill(eng, {c.name: depth for c in eng._sched.classes})
                    with eng._cond:
                        shed = [eng._shed_decision_locked(c)
                                for c in eng._sched.classes]
                    hints = [eng.retry_after_hint(c.name)
                             for c in eng._sched.classes]
                    got[side] = (shed, hints, eng.retry_after_hint(),
                                 eng.retry_after_hint("no-such-class"))
                    points += 1
                assert got["port"] == got["jax"], (deadlines, depth, p50)
                shed, hints, _, _ = got["port"]
                assert all(s is None or 1 <= s <= 30 for s in shed)
                assert all(1 <= h <= 30 for h in hints)
                # the most urgent band never sheds on the ladder alone
                if deadlines[0] is None:
                    assert shed[0] is None
    assert points == 2 * 3 * 4 * 3


@pytest.mark.parametrize("case", [
    "bulk_first", "fewest_tokens", "under_budget", "not_full",
    "none_preemptible", "cooldown", "no_decode_preempt", "no_ewma",
    "aging_boost"])
def test_tpot_victim_matches_jax(case):
    """The TPOT trigger's victim (or none) on the same batch, then
    whether the parked row may resume, in both engines."""
    rows = [("interactive", 3), ("batch", 5), ("batch", 2), ("bulk", 9)]
    ewma, cooldown, last = 0.02, 0.0, 0.0
    kw = {}
    if case == "fewest_tokens":
        rows[3] = ("standard", 9)
    elif case == "under_budget":
        ewma = 0.005
    elif case == "not_full":
        rows = rows[:3]
    elif case == "none_preemptible":
        rows = [("interactive", 3), ("standard", 1), ("standard", 4),
                ("interactive", 8)]
    elif case == "cooldown":
        cooldown, last = 60.0, time.perf_counter()
    elif case == "no_decode_preempt":
        kw["decode_preempt"] = False
    elif case == "no_ewma":
        ewma = None
    elif case == "aging_boost":
        kw["preempt_resume_ttl_s"] = 0.001
    out = {}
    for side, (_c, sched_mod, _r) in SIDES.items():
        eng = _shell(side, _classes(sched_mod, tpot=(0.01, None, None,
                                                     None)),
                     _step_ewma=ewma, tpot_preempt_cooldown_s=cooldown,
                     _tpot_last_preempt=last, **kw)
        eng._active = [_Stub(c, g) for c, g in rows]
        with eng._cond:
            eng._tpot_preempt_locked()
            paused = [eng._active.index(r) if r in eng._active else
                      [id(a) for a in eng._active].count(id(r))
                      for r in eng._preempted]
            idx = [i for i, (c, g) in enumerate(rows)
                   if any(p.priority == c and len(p.generated) == g
                          for p in eng._preempted)]
            if case == "aging_boost":
                time.sleep(0.002)
            parked = [eng._tpot_parked_locked(r) for r in eng._preempted]
            best = eng._best_preempted_locked()
            eng._step_ewma = 0.001            # the breach is over
            after = eng._best_preempted_locked()
        out[side] = (idx, len(paused), parked, best is None,
                     after is None)
    assert out["port"] == out["jax"]
    idx = out["port"][0]
    want = {"bulk_first": [3], "fewest_tokens": [2], "aging_boost": [3]}
    assert idx == want.get(case, [])
    if idx:
        # parked while breached (unless the aging boost won), then free
        assert out["port"][2:] == (([False], False, False)
                                   if case == "aging_boost"
                                   else ([True], True, False))


# --------------------------------------------------------- the engine
TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2,
            num_key_value_heads=2, max_position_embeddings=128)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    tfaults.clear()
    jfaults.clear()


def wait_for(cond, timeout=60.0, msg="condition"):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.002)


def value(mon, name, **labels):
    m = mon.get_registry().get(name)
    return 0.0 if m is None else m.value(**labels)


def engine(side, model, **kw):
    kw.setdefault("total_pages", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch", 4)
    if side == "port":
        return tcont.ContinuousBatchingEngine(model, device="cpu", **kw)
    return jcont.ContinuousBatchingEngine(model, **kw)


def pace(side, delay_s):
    mod = tfaults if side == "port" else jfaults
    return mod.installed(mod.FaultPlan(
        [{"site": "decode_step", "kind": "delay", "delay_s": delay_s}]))


def tpot_run(side, model, prompt, budget, **kw):
    """A batch row decoding, then an interactive arrival into the free
    slot (occupancy 2 of 2): with an interactive TPOT budget under the
    step time only the TPOT trigger can pause the batch row.  Returns
    its ids and the decode preemptions counted."""
    cont, sched_mod, _r = SIDES[side]
    mon = tmon if side == "port" else jmon
    classes = _classes(sched_mod, tpot=(budget, None, None, None))[:3]
    before = value(mon, "decode_preemptions_total")
    rng = np.random.default_rng(30)
    with pace(side, 0.02), engine(side, model, max_batch=2,
                                  scheduler_classes=classes,
                                  default_class="standard",
                                  tpot_preempt_cooldown_s=0.0,
                                  **kw) as eng:
        rb = eng.submit(prompt, max_new_tokens=10, priority="batch")
        wait_for(lambda: len(rb.generated) >= 2, msg="victim decoding")
        ri = eng.submit(rng.integers(0, 64, (5,)), max_new_tokens=6,
                        priority="interactive")
        ri.result(timeout=120)
        got = rb.result(timeout=120).tolist()
        if side == "port":
            assert eng.scheduler_info()["preempted"] == 0
            assert not rb._tpot_parked
    return got, value(mon, "decode_preemptions_total") - before


@pytest.fixture(scope="module")
def tpot_prompt():
    return np.random.default_rng(30).integers(0, 64, (16,)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_tpot(models, tpot_prompt):
    got, n = tpot_run("jax", models[0], tpot_prompt, 1e-4)
    assert n > 0
    return got


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
def test_tpot_parked_row_matches_jax_engine(models, tpot_prompt, jax_tpot,
                                            unified):
    jm, tm = models
    got, parked = tpot_run("port", tm, tpot_prompt, 1e-4,
                           unified_step=unified)
    plain, none = tpot_run("port", tm, tpot_prompt, None,
                           unified_step=unified)
    assert parked > 0 and none == 0
    assert got == plain == jax_tpot
    ref = jm.generate(paddle.to_tensor(tpot_prompt[None]), max_new_tokens=10)
    assert got == np.asarray(ref.numpy() if hasattr(ref, "numpy")
                             else ref)[0].tolist()


def test_doomed_arrival_sheds_with_truthful_retry_after(models):
    """A class whose projected queue wait (depth x decode p50) already
    exceeds its deadline sheds on arrival: never queued, counted per
    class, and its Retry-After is the projection's (the hint agrees)."""
    _jm, tm = models
    classes = _classes(tsched, deadlines=(None, None, 1e-9, None))[:3]
    rng = np.random.default_rng(31)
    shed0 = value(tmon, "sched_shed_on_arrival_total", cls="batch")
    with pace("port", 0.02), engine("port", tm, max_batch=1,
                                    scheduler_classes=classes,
                                    default_class="standard") as eng:
        eng.submit(rng.integers(0, 64, (6,)),
                   max_new_tokens=3).result(timeout=60)
        r1 = eng.submit(rng.integers(0, 64, (8,)), max_new_tokens=8,
                        priority="batch")
        wait_for(lambda: len(r1.generated) >= 1, msg="slot held")
        r2 = eng.submit(rng.integers(0, 64, (8,)), max_new_tokens=2,
                        priority="batch")        # depth 0: admitted
        with pytest.raises(tcont.EngineSaturated) as ei:
            eng.submit(rng.integers(0, 64, (8,)), max_new_tokens=2,
                       priority="batch")
        p50 = tcont._decode_p50_seconds()
        want = int(min(30, max(1, math.ceil(1 * p50 - 1e-9))))
        assert ei.value.priority_class == "batch"
        assert ei.value.retry_after_s == want
        assert eng.retry_after_hint("batch") == want
        assert eng.scheduler_info()["counts"]["batch"]["shed"] == 1
        assert eng.saturated == 1
        assert len(r1.result(timeout=60)) == 16
        assert len(r2.result(timeout=60)) == 10
    assert value(tmon, "sched_shed_on_arrival_total", cls="batch") \
        == shed0 + 1


def test_budgetless_classes_never_shed(models):
    _jm, tm = models
    rng = np.random.default_rng(32)
    shed0 = value(tmon, "sched_shed_on_arrival_total", cls="batch")
    with pace("port", 0.02), engine("port", tm, max_batch=1) as eng:
        reqs = [eng.submit(rng.integers(0, 64, (6,)), max_new_tokens=2,
                           priority="batch") for _ in range(4)]
        for r in reqs:
            assert len(r.result(timeout=60)) == 8
        assert eng.scheduler_info()["counts"]["batch"]["shed"] == 0
    assert value(tmon, "sched_shed_on_arrival_total", cls="batch") == shed0


def test_ladder_escalates_under_pressure_and_recovers(models):
    """Queue pressure climbs the ladder (gauge, transitions,
    ``scheduler_info``); an idle engine goes back to rung 0, so the next
    burst's first arrivals are not shed."""
    _jm, tm = models
    rng = np.random.default_rng(33)
    trans0 = value(tmon, "engine_brownout_transitions_total")
    with pace("port", 0.03), engine(
            "port", tm, max_batch=1, max_queue=8,
            brownout_thresholds=(0.25, 0.5, 0.75, 0.95),
            brownout_patience=2) as eng:
        assert eng.scheduler_info()["brownout_enabled"]
        reqs = [eng.submit(rng.integers(0, 64, (6,)), max_new_tokens=4,
                           priority="interactive") for _ in range(5)]
        wait_for(lambda: eng.scheduler_info()["brownout_level"] >= 1,
                 msg="ladder escalation")
        assert value(tmon, "engine_brownout_transitions_total") > trans0
        for r in reqs:
            assert len(r.result(timeout=60)) == 10
        wait_for(lambda: eng.scheduler_info()["brownout_level"] == 0,
                 timeout=10.0, msg="ladder recovery")
        assert value(tmon, "engine_brownout_level") == 0
        ok = eng.submit(rng.integers(0, 64, (6,)), max_new_tokens=2,
                        priority="batch")
        assert len(ok.result(timeout=60)) == 8


def test_rung_one_sheds_lower_ranks_only(models):
    _jm, tm = models
    rng = np.random.default_rng(34)
    with pace("port", 0.03), engine(
            "port", tm, max_batch=1, max_queue=4,
            brownout_thresholds=(0.25, 2.0, 2.0, 2.0),
            brownout_patience=64) as eng:
        reqs = [eng.submit(rng.integers(0, 64, (6,)), max_new_tokens=4,
                           priority="interactive") for _ in range(3)]
        wait_for(lambda: eng.scheduler_info()["brownout_level"] >= 1,
                 msg="rung 1")
        with pytest.raises(tcont.EngineSaturated) as ei:
            eng.submit(rng.integers(0, 64, (6,)), max_new_tokens=2,
                       priority="batch")
        assert ei.value.priority_class == "batch"
        assert 1 <= ei.value.retry_after_s <= 30
        # the top rank band still admits at rung 1
        ok = eng.submit(rng.integers(0, 64, (6,)), max_new_tokens=2,
                        priority="interactive")
        for r in reqs + [ok]:
            r.result(timeout=60)
        assert eng.scheduler_info()["counts"]["batch"]["shed"] == 1
        assert eng.scheduler_info()["counts"]["interactive"]["shed"] == 0


def result_script(side, model):
    """One scripted run (1 slot, cache of 3): "a" decoding, "b" queued,
    "c" cancelled in the queue, then "b2" and "d"; ``result_for`` read at
    each point."""
    rng = np.random.default_rng(40)
    seen = {}
    with pace(side, 0.02), engine(side, model, max_batch=1,
                                  result_cache_size=3) as eng:
        a = eng.submit(rng.integers(0, 64, (10,)), max_new_tokens=4,
                       request_id="a")
        wait_for(lambda: len(a.generated) >= 1, msg="a decoding")
        b = eng.submit(rng.integers(0, 64, (7,)), max_new_tokens=3,
                       request_id="b")
        c = eng.submit(rng.integers(0, 64, (7,)), max_new_tokens=3,
                       request_id="c")
        seen["a_live"] = eng.result_for("a")["status"]
        seen["b_queued"] = eng.result_for("b")
        c.cancel()
        # reaped at the next iteration, while "a" still decodes
        wait_for(lambda: eng.result_for("c")["status"] == "error",
                 msg="c reaped")
        seen["c"] = eng.result_for("c")
        a.result(timeout=120)
        b.result(timeout=120)
        for rid in ("a", "b", "never"):
            seen[rid] = eng.result_for(rid)
        b2 = eng.submit(np.arange(3), max_new_tokens=12, request_id="b2")
        with pytest.raises(ValueError, match="already live"):
            eng.submit(np.arange(3), request_id="b2")
        d = eng.submit(rng.integers(0, 64, (5,)), max_new_tokens=2,
                       request_id="d")
        b2.result(timeout=120)
        d.result(timeout=120)
        seen["after"] = {rid: eng.result_for(rid)
                         for rid in ("a", "b", "c", "b2", "d")}
    return seen


def test_result_for_matches_jax(models):
    jm, tm = models
    want = result_script("jax", jm)
    got = result_script("port", tm)
    assert got == want
    assert got["a_live"] == "pending"
    assert got["b_queued"] == {"request_id": "b", "status": "pending",
                               "generated_tokens": 0}
    assert got["a"]["status"] == got["b"]["status"] == "done"
    assert got["a"]["new_tokens"] == 4 and len(got["a"]["output_ids"]) == 14
    assert got["c"]["error_type"] == "RequestCancelled"
    assert got["never"] is None
    # the cache holds the three newest outcomes: b, b2 and d
    assert [rid for rid, e in got["after"].items() if e] == ["b", "b2", "d"]


SERIES = (("sched_admitted_total", {"cls": "batch"}),
          ("sched_admitted_total", {"cls": "standard"}),
          ("sched_prefill_chunks_total", {"cls": "batch"}),
          ("sched_prefill_chunks_total", {"cls": "standard"}),
          ("generated_tokens_total", {}),
          ("prefix_cache_lookups_total", {}),
          ("prefix_cache_hits_total", {}),
          ("prefix_cache_hit_tokens_total", {}),
          ("quarantined_requests_total", {}),
          ("requests_cancelled_total", {}),
          ("engine_saturated_total", {}),
          ("decode_preemptions_total", {})) + tuple(
    ("engine_dispatches_total", {"mode": m})
    for m in ("ragged", "prefill", "chunk", "decode", "verify", "draft"))


def series_run(side, model, **kw):
    """A small workload served one request at a time (so both engines
    see the same admissions): a prompt, one sharing its first 16 tokens
    (a prefix hit), a batch-class one and a sampled one.  Returns the
    series' deltas and the streams."""
    mon = tmon if side == "port" else jmon
    before = [value(mon, n, **lb) for n, lb in SERIES]
    rng = np.random.default_rng(50)
    base = rng.integers(0, 64, (20,)).astype(np.int32)
    prompts = [base, np.concatenate([base[:16], rng.integers(0, 64, (5,))]),
               rng.integers(0, 64, (13,)), rng.integers(0, 64, (9,))]
    outs = []
    with engine(side, model, **kw) as eng:
        for i, p in enumerate(prompts):
            r = eng.submit(p.astype(np.int32), max_new_tokens=5,
                           priority="batch" if i == 2 else None,
                           do_sample=i == 3, temperature=0.7, seed=9)
            outs.append(r.result(timeout=120).tolist())
    after = [value(mon, n, **lb) for n, lb in SERIES]
    return {f"{n}{lb}": a - b
            for (n, lb), a, b in zip(SERIES, after, before)}, outs


@pytest.mark.parametrize("unified,chunk", [(True, 8), (False, 8),
                                           (True, None)],
                         ids=["unified8", "legacy8", "unified_whole"])
def test_engine_series_deltas_match_jax(models, unified, chunk):
    jm, tm = models
    want, jout = series_run("jax", jm, unified_step=unified,
                            prefill_chunk_tokens=chunk)
    got, tout = series_run("port", tm, unified_step=unified,
                           prefill_chunk_tokens=chunk)
    assert tout == jout
    assert got == want
    assert got["generated_tokens_total{}"] == 20
    assert got["prefix_cache_hit_tokens_total{}"] == 16
    assert got["sched_admitted_total{'cls': 'standard'}"] == 3


def test_every_jax_engine_series_is_ported():
    """The engine, scheduler and watchdog series of the JAX package exist
    in the port's registry under the same names, kinds and labels."""
    import paddle_tpu.distributed.watchdog  # noqa: F401 — registers
    import paddle_tpu_torch.distributed.watchdog  # noqa: F401
    src = (open(jcont.__file__).read() + open(jsched.__file__).read()
           + open(paddle_tpu.distributed.watchdog.__file__).read())
    names = [n for n in jmon.get_registry().snapshot()
             if f'"{n}"' in src]
    assert len(names) >= 50
    j, t = jmon.get_registry(), tmon.get_registry()
    for n in names:
        assert t.get(n) is not None, n
        assert (t.get(n).kind, t.get(n).label_names) \
            == (j.get(n).kind, j.get(n).label_names), n
        if isinstance(t.get(n), treg.Histogram):
            assert t.get(n).buckets == j.get(n).buckets
