"""The port's engine request lifecycle and workload scheduling against
the JAX package's (``paddle_tpu/inference/continuous.py``,
``tests/test_scheduler.py``, ``tests/test_engine_faults.py``), on the
tiny model of those tests with the JAX weights carried over (CPU, f32).

- A batch-class request preempted mid-prefill by an interactive one
  resumes from where it stopped and gives JAX ``model.generate``'s
  greedy ids, in both compositions and on a prefix hit.
- A decoding batch row paused by an interactive arrival resumes with
  the stream of the unpreempted run, greedy and sampled.
- TTL and queue-wait deadlines, a timed-out ``result`` (which cancels),
  bounded queues (``EngineSaturated``), ``drain`` (with and without
  ``reject_queued``), the resume TTL, and the classes the port refuses.
  Every case ends with the pool whole and only the pad headroom
  reserved.

Fault plans with ``delay`` rules pace the steps, as the JAX tests pace
theirs, so the timings these cases need hold on a fast CPU."""
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        DeadlineExceeded, EngineDraining,
                                        EngineSaturated, PriorityClass,
                                        RequestCancelled)
from paddle_tpu_torch.inference.scheduler import DEFAULT_CLASSES
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.testing import faults

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
    faults.clear()


def reference(jm, prompt, max_new_tokens):
    out = jm.generate(paddle.to_tensor(np.asarray(prompt)[None]),
                      max_new_tokens=max_new_tokens)
    out = out.numpy() if hasattr(out, "numpy") else np.asarray(out)
    return out[0].tolist()


def wait_for(cond, timeout=60.0, msg="condition"):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.002)


def make_engine(model, **kw):
    kw.setdefault("total_pages", 64)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch", 4)
    return ContinuousBatchingEngine(model, device="cpu", **kw)


def pace(site, delay_s):
    return faults.installed(faults.FaultPlan(
        [{"site": site, "kind": "delay", "delay_s": delay_s}]))


def assert_whole(eng):
    """The pool comes back whole: no request held anywhere, every page
    free (cached prefix pages are evictable and count as free) and only
    the pad headroom reserved."""
    def idle():
        with eng._cond:
            return not (len(eng._sched) or eng._preempted
                        or eng._prefilling or eng._active) \
                and eng.cache.free_pages == eng.cache.total_pages
    wait_for(idle, msg="the engine idle with its pool whole")
    assert eng._reserved_pages == eng._pad_pages == 1


def batch_counts(eng):
    return eng.scheduler_info()["counts"]["batch"]


def preempt_run(tm, prompt, max_new, **engine_kw):
    """One batch-class request, preempted mid-prefill by an interactive
    one (max_batch 1, chunks of 8, every chunk paced): returns the batch
    request's ids and the batch class's counters."""
    rng = np.random.default_rng(4)
    with pace("prefill_chunk", 0.02), \
            make_engine(tm, max_batch=1, prefill_chunk_tokens=8,
                        **engine_kw) as eng:
        rb = eng.submit(prompt, max_new_tokens=max_new, priority="batch")
        wait_for(lambda: rb.prefill_pos > rb.prefix_tokens,
                 msg="first chunk")
        assert rb.prefill_pos < len(prompt)
        ri = eng.submit(rng.integers(0, 64, (5,)), max_new_tokens=4,
                        priority="interactive")
        ri.result(timeout=60)
        got = rb.result(timeout=60).tolist()
        assert ri.finished_at < rb.finished_at
        assert_whole(eng)
        return got, batch_counts(eng), eng.dispatches


@pytest.mark.parametrize("unified", [True, False],
                         ids=["unified", "legacy"])
def test_preempted_prefill_matches_jax_generate(models, unified):
    jm, tm = models
    p = np.random.default_rng(5).integers(0, 64, (40,)).astype(np.int32)
    got, counts, disp = preempt_run(tm, p, 6, unified_step=unified)
    assert got == reference(jm, p, 6)
    assert counts["preempted"] == counts["resumed"] == 1
    # resumed, not prefilled again: 5 chunks of 8 in all
    assert counts["chunks"] == 5
    assert (disp["ragged"] > 0) == unified
    assert (disp["decode"] > 0) != unified


@pytest.mark.parametrize("unified", [True, False],
                         ids=["unified", "legacy"])
def test_preempted_prefix_hit_matches_jax_generate(models, unified):
    """A request mapping a cached 16-token prefix, preempted in its
    suffix, continues from the shared pages exactly."""
    jm, tm = models
    rng = np.random.default_rng(6)
    system = rng.integers(0, 64, (16,)).astype(np.int32)
    sharer = np.concatenate([system, rng.integers(0, 64, (25,))]) \
        .astype(np.int32)
    seed_p = np.concatenate([system, rng.integers(0, 64, (3,))]) \
        .astype(np.int32)
    with make_engine(tm, max_batch=1, prefill_chunk_tokens=8,
                     unified_step=unified) as eng:
        eng.submit(seed_p, max_new_tokens=2).result(timeout=60)
        with pace("prefill_chunk", 0.02):
            rb = eng.submit(sharer, max_new_tokens=6, priority="batch")
            wait_for(lambda: rb.prefill_pos > rb.prefix_tokens,
                     msg="first suffix chunk")
            ri = eng.submit(rng.integers(0, 64, (5,)), max_new_tokens=4,
                            priority="interactive")
            ri.result(timeout=60)
            got = rb.result(timeout=60).tolist()
        assert rb.prefix_tokens == 16
        assert batch_counts(eng)["preempted"] == 1
        assert_whole(eng)
    assert got == reference(jm, sharer, 6)


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_decode_preempted_row_resumes_with_its_stream(models, sampled):
    """No prefill is left to pause, so the interactive arrival pauses the
    decoding batch row (its next token pending); the row rejoins the
    batch when the slot frees and finishes with the unpreempted run's
    stream: draws are keyed by (seed, absolute position)."""
    _jm, tm = models
    rng = np.random.default_rng(7)
    p = rng.integers(0, 64, (12,)).astype(np.int32)
    kw = dict(max_new_tokens=24, do_sample=sampled, temperature=0.9,
              seed=3, priority="batch")
    with make_engine(tm, max_batch=1) as eng:
        want = eng.submit(p, **kw).result(timeout=60).tolist()
    with pace("decode_step", 0.01), make_engine(tm, max_batch=1) as eng:
        rb = eng.submit(p, **kw)
        wait_for(lambda: len(rb.generated) >= 4, msg="batch decoding")
        ri = eng.submit(rng.integers(0, 64, (5,)), max_new_tokens=4,
                        priority="interactive")
        ri.result(timeout=60)
        got = rb.result(timeout=60).tolist()
        assert ri.finished_at < rb.finished_at
        counts = batch_counts(eng)
        assert counts["preempted"] == counts["resumed"] == 1
        assert counts["chunks"] == 1          # never prefilled again
        assert_whole(eng)
    assert got == want


def test_decode_preempt_off_waits_for_the_slot(models):
    """With ``decode_preempt=False`` a decoding batch row keeps its slot:
    the interactive request waits for it to retire."""
    _jm, tm = models
    rng = np.random.default_rng(8)
    with pace("decode_step", 0.005), \
            make_engine(tm, max_batch=1, decode_preempt=False) as eng:
        rb = eng.submit(rng.integers(0, 64, (6,)), max_new_tokens=16,
                        priority="batch")
        wait_for(lambda: len(rb.generated) >= 2, msg="batch decoding")
        ri = eng.submit(rng.integers(0, 64, (5,)), max_new_tokens=4,
                        priority="interactive")
        ri.result(timeout=60)
        assert rb.finished_at < ri.finished_at
        assert batch_counts(eng)["preempted"] == 0
        assert_whole(eng)


def test_interactive_chunks_go_first_and_defer_batch(models):
    """Under a chunk budget the interactive class's chunk runs before the
    batch class's, which counts a deferral; one batch request at a time
    is no deferral (same-class queueing)."""
    _jm, tm = models
    rng = np.random.default_rng(9)
    with pace("prefill_chunk", 0.01), \
            make_engine(tm, max_batch=2, prefill_chunk_tokens=8) as eng:
        rb = eng.submit(rng.integers(0, 64, (64,)), max_new_tokens=2,
                        priority="batch")
        wait_for(lambda: rb.prefill_pos > 0, msg="first chunk")
        ri = eng.submit(rng.integers(0, 64, (24,)), max_new_tokens=2,
                        priority="interactive")
        ri.result(timeout=60)
        assert rb.prefill_pos < 64
        rb.result(timeout=60)
        info = eng.scheduler_info()
        assert info["counts"]["batch"]["deferrals"] >= 3
        assert info["counts"]["interactive"]["deferrals"] == 0
        assert info["counts"]["batch"]["preempted"] == 0
        assert_whole(eng)


# ------------------------------------------------ lifecycle and drain
def test_deadline_expiry_frees_reserved_pages(models):
    _jm, tm = models
    rng = np.random.default_rng(0)
    with pace("decode_step", 0.02), \
            make_engine(tm, total_pages=16, max_batch=2) as eng:
        # 8 pages reserved at admission; the TTL expires long before 60
        # paced tokens decode
        r = eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=60,
                       ttl_s=0.3)
        with pytest.raises(DeadlineExceeded, match="TTL"):
            r.result(timeout=60)
        assert r.first_token_at is not None
        assert len(r.generated) < 60
        assert eng.expired == 1 and eng.cancelled == 0
        assert_whole(eng)
        ok = eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=4)
        assert len(ok.result(timeout=60)) == 8


def test_queue_wait_deadline_rejects_unadmitted(models):
    _jm, tm = models
    rng = np.random.default_rng(1)
    with pace("decode_step", 0.01), make_engine(tm, max_batch=1) as eng:
        r1 = eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=60)
        wait_for(lambda: r1.seq_id is not None, msg="r1 admission")
        r2 = eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=4,
                        queue_timeout_s=0.1)
        with pytest.raises(DeadlineExceeded, match="queue-wait"):
            r2.result(timeout=60)
        assert r2.seq_id is None             # never admitted
        assert eng.expired == 1
        r1.cancel()
        assert_whole(eng)


def test_cancel_mid_decode_frees_pages(models):
    _jm, tm = models
    rng = np.random.default_rng(2)
    with pace("decode_step", 0.005), make_engine(tm) as eng:
        r = eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=60)
        wait_for(lambda: r.first_token_at is not None, msg="decode start")
        assert r.cancel()
        with pytest.raises(RequestCancelled):
            r.result(timeout=60)
        assert len(r.generated) < 60
        assert eng.cancelled == 1
        assert_whole(eng)


def test_result_timeout_cancels_by_default(models):
    """A timed-out ``result()`` cancels, so an abandoned wait does not
    leave the sequence decoding and holding pages;
    ``cancel_on_timeout=False`` keeps it running."""
    _jm, tm = models
    rng = np.random.default_rng(3)
    with pace("decode_step", 0.005), make_engine(tm) as eng:
        r = eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=100)
        with pytest.raises(TimeoutError, match="cancelled"):
            r.result(timeout=0.02)
        assert r.cancelled
        wait_for(r.done.is_set, msg="reap after the timeout's cancel")
        with pytest.raises(RequestCancelled):
            r.result()
        assert_whole(eng)
        r2 = eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=24)
        with pytest.raises(TimeoutError):
            r2.result(timeout=0.02, cancel_on_timeout=False)
        assert not r2.cancelled
        assert len(r2.result(timeout=60)) == 28
        assert eng.cancelled == 1
        assert_whole(eng)


def test_bounded_queue_saturation_names_the_class(models):
    _jm, tm = models
    rng = np.random.default_rng(4)
    with pace("decode_step", 0.01), \
            make_engine(tm, max_batch=1, max_queue=1) as eng:
        r1 = eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=60)
        wait_for(lambda: r1.seq_id is not None, msg="r1 admission")
        eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=4)
        with pytest.raises(EngineSaturated) as e:
            eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=4)
        assert e.value.priority_class == "standard"
        # the bound is per class: the batch class still has room, and an
        # unknown class is a ValueError, never saturation
        eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=4,
                   priority="batch")
        with pytest.raises(ValueError, match="unknown priority class"):
            eng.submit(rng.integers(0, 64, (4,)), priority="gold")
        assert eng.saturated == 1
        counts = eng.scheduler_info()["counts"]
        assert counts["standard"]["rejected"] == 1
        assert counts["batch"]["rejected"] == 0
        r1.cancel()
        assert eng.drain(timeout=60)
        assert_whole(eng)


def test_drain_under_load_completes_all_admitted(models):
    _jm, tm = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 64, (4,)).astype(np.int32)
               for _ in range(4)]
    eng = make_engine(tm, max_batch=2)
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    assert eng.drain(timeout=60)
    for r in reqs:
        assert len(r.result(timeout=1)) == 12
    assert eng.cache.free_pages == 64
    assert eng._reserved_pages == 1
    with pytest.raises(EngineDraining):
        eng.submit(prompts[0], max_new_tokens=4)
    # an unknown class is refused as such even while draining
    with pytest.raises(ValueError, match="unknown priority class"):
        eng.submit(prompts[0], priority="gold")
    assert not eng._thread.is_alive()


def test_drain_timeout_returns_false_but_keeps_draining(models):
    _jm, tm = models
    rng = np.random.default_rng(6)
    with pace("decode_step", 0.02):
        eng = make_engine(tm, max_batch=2)
        r = eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=32)
        assert eng.drain(timeout=0.05) is False
        assert eng.draining
        with pytest.raises(EngineDraining):
            eng.submit(rng.integers(0, 64, (4,)))
        assert eng.drain(timeout=60) is True
        assert len(r.result(timeout=1)) == 36
    assert eng.cache.free_pages == 64 and eng._reserved_pages == 1


def test_drain_reject_queued_fails_fast_keeps_admitted(models):
    _jm, tm = models
    rng = np.random.default_rng(21)
    with pace("decode_step", 0.01):
        eng = make_engine(tm, max_batch=1)
        r1 = eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=24)
        wait_for(lambda: r1.seq_id is not None, msg="r1 admission")
        queued = [eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=4)
                  for _ in range(2)]
        assert eng.drain(timeout=60, reject_queued=True)
        for q in queued:
            with pytest.raises(EngineDraining):
                q.result(timeout=1)
            assert q.seq_id is None
        assert len(r1.result(timeout=1)) == 28
    assert eng.drain_rejected == 2
    assert eng.cache.free_pages == 64 and eng._reserved_pages == 1


def test_stop_admissions_refuses_new_work(models):
    _jm, tm = models
    with make_engine(tm) as eng:
        eng.stop_admissions()
        assert eng.draining
        with pytest.raises(EngineDraining):
            eng.submit(np.arange(4, dtype=np.int32))


def test_resume_ttl_reaps_a_paused_prefill(models):
    """A batch prefill paused behind a long interactive request holds its
    reservation at most ``preempt_resume_ttl_s``: past it, it is reaped
    with ``DeadlineExceeded`` and its pages come back, while the
    interactive request finishes."""
    _jm, tm = models
    rng = np.random.default_rng(10)
    with faults.installed(faults.FaultPlan([
            {"site": "prefill_chunk", "kind": "delay", "delay_s": 0.02},
            {"site": "decode_step", "kind": "delay", "delay_s": 0.01}])), \
            make_engine(tm, max_batch=1, prefill_chunk_tokens=8,
                        preempt_resume_ttl_s=0.15) as eng:
        rb = eng.submit(rng.integers(0, 64, (40,)), max_new_tokens=4,
                        priority="batch")
        wait_for(lambda: rb.prefill_pos > 0, msg="first chunk")
        ri = eng.submit(rng.integers(0, 64, (5,)), max_new_tokens=60,
                        priority="interactive")
        with pytest.raises(DeadlineExceeded, match="resume TTL"):
            rb.result(timeout=60)
        assert rb.prefill_pos < 40
        assert len(ri.result(timeout=60)) == 65
        counts = batch_counts(eng)
        assert counts["preempted"] == 1 and counts["resumed"] == 0
        assert counts["preempt_expired"] == 1
        assert eng.expired == 1
        assert_whole(eng)


@pytest.mark.parametrize("budget", ["deadline_s", "tpot_budget_s"])
def test_a_class_budget_is_refused(models, budget):
    """The overload controls that act on a class's budgets are not
    ported, so a class carrying one is refused, never ignored."""
    _jm, tm = models
    classes = DEFAULT_CLASSES + (PriorityClass("slo", 0, **{budget: 1.0}),)
    with pytest.raises(ValueError, match="not ported"):
        make_engine(tm, scheduler_classes=classes)


def test_scheduler_info_reports_policy_and_depths(models):
    _jm, tm = models
    rng = np.random.default_rng(11)
    with pace("decode_step", 0.01), make_engine(tm, max_batch=1) as eng:
        r1 = eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=40)
        wait_for(lambda: r1.seq_id is not None, msg="r1 admission")
        with eng._cond:        # nothing is admitted while it is held
            for tenant in ("a", "b", "a"):
                eng.submit(rng.integers(0, 64, (4,)), max_new_tokens=2,
                           priority="interactive", tenant=tenant)
            info = eng.scheduler_info()
        assert info["default_class"] == "standard"
        assert info["tenants_queued"] == {
            "interactive": {"a": 2, "b": 1}, "standard": {}, "batch": {}}
        assert info["classes"]["interactive"]["queued"] == 3
        assert info["classes"]["batch"]["preemptible"]
        assert info["classes"]["interactive"]["max_queue"] == 256
        r1.cancel()
        assert eng.drain(timeout=60)
        assert_whole(eng)
