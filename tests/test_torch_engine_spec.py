"""Port parity: the engine's draft model (speculative decoding) against
the JAX engine with the same draft, on the tiny model of
``tests/test_spec_decode_engine.py`` with the JAX weights carried over
(CPU, f32).

Each workload is one wave of two speculating greedy requests, a sampled
one riding along and a prefix owner, then a request on the owner's
cached prefix.  The port serves it through the unified ragged step
(verify rows) and the legacy composition (``verify``), with the target
as its own (perfect) draft and with a bad draft: its streams must equal
the JAX engine's and the port's draft-free run's, and its
``spec_accepted`` / ``spec_proposed`` the JAX monitor's
``spec_accepted_tokens_total`` / ``spec_proposed_tokens_total`` deltas.
The JAX engine runs each configuration at most once a module: the
unified step with the bad draft and the legacy composition with the
perfect one (its two compositions give equal streams and counts, which
its own tests hold), and each port run is held against the JAX run of
its draft.

In the port alone, each against the draft-free stream: a cancel
mid-stream frees both pools, a sticky decode fault quarantines only the
faulty speculating row (retried, bisected), a ragged step raising an
injected fault re-runs through the legacy composition, a failing draft
prefill or proposal downgrades and does not quarantine, a decoding row
paused with its draft cache resumes bit-identical, the ``submit``
checks, and a w8 target with a full-precision draft."""
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import monitor
from paddle_tpu.inference.continuous import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        RequestCancelled)
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.testing import faults

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(total_pages=64, page_size=4, max_batch=4, spec_tokens=3,
              min_table_pages=16)
# JAX engine configuration -> (unified, draft)
JAX_RUNS = {"unified_bad": (True, "bad"), "legacy_perfect": (False,
                                                             "perfect")}


def _arrays(model):
    return {n: np.asarray(p._data) for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, port model): the target, which is also its
    own perfect draft, and a bad draft of another seed."""
    out = {}
    for name, seed in (("target", 0), ("bad", 7)):
        paddle.seed(seed)
        jm = JaxLM(JaxConfig(**TINY))
        out[name] = (jm, params_from_numpy(LlamaConfig(**TINY), _arrays(jm),
                                           device="cpu"))
    out["perfect"] = out["target"]
    return out


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear()


def _prompts():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n in (5, 6, 7, 8)]
    # shares the owner's first 4-token page (one prompt bucket for all)
    sharer = np.concatenate([prompts[3][:4],
                             rng.integers(0, 64, (4,))]).astype(np.int32)
    return prompts, sharer


def _serve(eng):
    """The workload: streams and the sharer's prefix-hit length."""
    prompts, sharer = _prompts()
    kw = [dict(max_new_tokens=10), dict(max_new_tokens=8),
          dict(max_new_tokens=8, do_sample=True, temperature=0.8, seed=11),
          dict(max_new_tokens=6)]
    with eng._cond:       # admitted together: one batch
        reqs = [eng.submit(p, **k) for p, k in zip(prompts, kw)]
    outs = [r.result(timeout=300).tolist() for r in reqs]
    hit = eng.submit(sharer, max_new_tokens=6)
    outs.append(hit.result(timeout=300).tolist())
    return outs, hit.prefix_tokens


def _monitor(name):
    m = monitor.snapshot().get(name)
    return m["series"][0]["value"] if m and m["series"] else 0.0


@pytest.fixture(scope="module")
def jax_runs(models):
    """config -> (streams, prefix hit, proposed, accepted) of the JAX
    engine, each configuration run once."""
    out = {}
    for name, (unified, draft) in JAX_RUNS.items():
        before = [_monitor(f"spec_{k}_tokens_total")
                  for k in ("proposed", "accepted")]
        with JaxEngine(models["target"][0], unified_step=unified,
                       draft_model=models[draft][0], **ENGINE) as eng:
            streams, hit = _serve(eng)
        after = [_monitor(f"spec_{k}_tokens_total")
                 for k in ("proposed", "accepted")]
        out[draft] = (streams, hit, after[0] - before[0],
                      after[1] - before[1])
    return out


def make_engine(model, **kw):
    for k, v in ENGINE.items():
        kw.setdefault(k, v)
    return ContinuousBatchingEngine(model, device="cpu", **kw)


def assert_whole(eng):
    """Both pools come back whole, only the pad headroom reserved."""
    def idle():
        with eng._cond:
            busy = len(eng._sched) or eng._preempted or eng._prefilling \
                or eng._active
        return not busy and eng.cache.free_pages == eng.cache.total_pages \
            and (eng.draft_cache is None
                 or eng.draft_cache.free_pages == eng.draft_cache.total_pages)
    end = time.monotonic() + 30
    while not idle():
        assert time.monotonic() < end, "the engine never came back idle"
        time.sleep(0.005)
    assert eng._reserved_pages == eng._pad_pages == 1
    assert eng._reserved_draft_pages == eng._pad_pages
    assert eng.draft_pages == 0


@pytest.fixture(scope="module")
def plain(models):
    """The port's draft-free streams of the workload."""
    with make_engine(models["target"][1]) as eng:
        return _serve(eng)


@pytest.mark.parametrize("unified", [True, False],
                         ids=["unified", "legacy"])
@pytest.mark.parametrize("draft", ["perfect", "bad"])
def test_streams_and_acceptance_match_jax(models, jax_runs, plain, unified,
                                          draft):
    with make_engine(models["target"][1], unified_step=unified,
                     draft_model=models[draft][1]) as eng:
        streams, hit = _serve(eng)
        assert_whole(eng)
        counts = (eng.spec_proposed, eng.spec_accepted)
        disp = dict(eng.dispatches)
        lens, rollbacks = list(eng.spec_accept_lens), eng.spec_rollbacks
        steps = eng.steps
    want, want_hit, proposed, accepted = jax_runs[draft]
    assert hit == want_hit == 4
    assert streams == want == plain[0]
    assert counts == (proposed, accepted)
    assert sum(lens) * ENGINE["spec_tokens"] == proposed
    assert sum(a * n for a, n in enumerate(lens)) == accepted
    assert rollbacks == sum(lens[:-1])
    if draft == "perfect":
        assert accepted == proposed > 0 and rollbacks == 0
    else:
        assert accepted < proposed
    # the draft ingests each greedy prompt once and proposes once a step
    # in which a row speculates (the sampled row may finish alone)
    assert 4 < disp["draft"] <= 4 + steps
    if unified:
        assert disp["ragged"] > 0 and disp["verify"] == disp["decode"] == 0
    else:
        assert disp["ragged"] == 0 and disp["verify"] > 0
        assert disp["verify"] + disp["decode"] == steps


def test_perfect_draft_cuts_steps(models, plain):
    """k = 3 and a perfect draft: one step emits up to 4 tokens."""
    target = models["target"][1]
    p = _prompts()[0][0]
    steps = []
    for draft in (None, target):
        with make_engine(target, draft_model=draft) as eng:
            got = eng.submit(p, max_new_tokens=12).result(timeout=300)
            steps.append(eng.steps)
    assert got.tolist()[:len(p) + 10] == plain[0][0]
    assert steps[0] == 12 and steps[1] == 3


def test_cancel_mid_stream_frees_both_pools(models, plain):
    target = models["target"][1]
    prompts, _ = _prompts()
    with make_engine(target, draft_model=target) as eng:
        # paced steps, so the cancel lands mid-stream
        with faults.installed(faults.FaultPlan([
                {"site": "decode_step", "kind": "delay", "delay_s": 0.02}])):
            keeper = eng.submit(prompts[0], max_new_tokens=10)
            victim = eng.submit(prompts[1], max_new_tokens=60)
            end = time.monotonic() + 30
            while len(victim.generated) < 4:
                assert time.monotonic() < end
                time.sleep(0.002)
            assert victim.cancel()
            with pytest.raises(RequestCancelled):
                victim.result(timeout=60)
            assert keeper.result(timeout=60).tolist() == plain[0][0]
        assert victim.seq_id not in eng.cache._seq_pages
        assert victim.seq_id not in eng.draft_cache._seq_pages
        assert eng.cancelled == 1
        assert_whole(eng)


@pytest.mark.parametrize("unified", [True, False],
                         ids=["unified", "legacy"])
def test_sticky_fault_quarantines_only_the_faulty_row(models, plain,
                                                      unified):
    """A decode fault on seq 1 diverts to the legacy composition, whose
    speculative step is retried, then bisected (both caches rolled back
    each time): exactly that request fails."""
    target = models["target"][1]
    prompts, _ = _prompts()
    with faults.installed(faults.FaultPlan([{"site": "decode_step",
                                             "seq_id": 1}])), \
            make_engine(target, draft_model=models["bad"][1],
                        unified_step=unified) as eng:
        with eng._cond:
            keeper = eng.submit(prompts[0], max_new_tokens=10)
            victim = eng.submit(prompts[1], max_new_tokens=8)
        with pytest.raises(faults.FaultError):
            victim.result(timeout=60)
        assert keeper.result(timeout=60).tolist() == plain[0][0]
        assert eng.quarantined == 1 and eng.decode_retries >= 2
        assert eng.dispatches["ragged"] == 0
        assert_whole(eng)


def test_ragged_fault_replays_the_step_through_legacy(models, plain):
    """A ragged step raising an injected fault unwinds both caches and
    the same speculative step runs through ``verify``; after 3 the
    unified path latches off."""
    target = models["target"][1]
    with make_engine(target, draft_model=target) as eng:
        def ragged_step(*a, **kw):
            raise faults.FaultError("injected ragged step failure")
        eng._decoder.ragged_step = ragged_step
        streams, _hit = _serve(eng)
        assert eng.unified_fallbacks == 3 and eng._unified_off
        assert eng.spec_accepted == eng.spec_proposed > 0
        assert eng.dispatches["verify"] > 0
        assert_whole(eng)
    assert streams == plain[0]


@pytest.mark.parametrize("where", ["prefill", "multi_step"])
def test_draft_failure_downgrades_not_quarantines(models, plain, where):
    target = models["target"][1]
    p = _prompts()[0][0]
    with make_engine(target, draft_model=target) as eng:
        def boom(*a, **kw):
            raise RuntimeError(f"injected draft {where} failure")
        setattr(eng._draft_decoder, where, boom)
        req = eng.submit(p, max_new_tokens=10)
        out = req.result(timeout=60).tolist()
        assert not req.use_draft and req.error is None
        assert eng.spec_draft_failures == 1 and eng.quarantined == 0
        assert req.seq_id not in eng.draft_cache._seq_pages
        assert eng.spec_proposed == 0
        assert_whole(eng)
    assert out == plain[0][0]


def test_decode_preempted_row_keeps_its_draft_cache(models):
    """A speculating batch row paused mid-decode keeps both caches and
    resumes still speculating, with the unpreempted stream."""
    target = models["target"][1]
    rng = np.random.default_rng(24)
    p = rng.integers(0, 64, (20,)).astype(np.int32)
    kw = dict(max_new_tokens=16, priority="batch", draft=True)
    with make_engine(target, max_batch=1) as eng:
        want = eng.submit(p, max_new_tokens=16).result(timeout=60).tolist()
    with faults.installed(faults.FaultPlan([
            {"site": "decode_step", "kind": "delay", "delay_s": 0.02}])), \
            make_engine(target, max_batch=1, draft_model=target,
                        spec_tokens=2) as eng:
        rb = eng.submit(p, **kw)
        end = time.monotonic() + 30
        while len(rb.generated) < 2:
            assert time.monotonic() < end
            time.sleep(0.002)
        ri = eng.submit(rng.integers(0, 64, (5,)), max_new_tokens=2,
                        priority="interactive", draft=False)
        ri.result(timeout=60)
        got = rb.result(timeout=60).tolist()
        counts = eng.scheduler_info()["counts"]["batch"]
        assert counts["preempted"] == counts["resumed"] == 1
        assert ri.finished_at < rb.finished_at
        assert rb.use_draft and eng.spec_accepted == eng.spec_proposed > 0
        assert_whole(eng)
    assert got == want


def _validation(eng, case):
    p = np.zeros(4, np.int32)
    if case == "draft_without_model":
        with pytest.raises(ValueError, match="draft"):
            eng.submit(p, max_new_tokens=4, draft=True)
    elif case == "draft_with_sampling":
        with pytest.raises(ValueError, match="greedy"):
            eng.submit(p, max_new_tokens=4, draft=True, do_sample=True)
        assert not eng.submit(p, max_new_tokens=4, do_sample=True,
                              seed=1).use_draft
    elif case == "overhang":
        # 120 + 3 fits 128 with the 3-token overhang, 125 + 3 does not
        req = eng.submit(np.zeros(100, np.int32), max_new_tokens=20)
        req.result(timeout=60)
        with pytest.raises(ValueError, match="overhang"):
            eng.submit(np.zeros(100, np.int32), max_new_tokens=26)
    else:            # opt_out
        req = eng.submit(p, max_new_tokens=6, draft=False)
        req.result(timeout=60)
        assert not req.use_draft
        assert req.seq_id not in eng.draft_cache._seq_pages
        assert eng.spec_proposed == 0 and eng.dispatches["draft"] == 0


@pytest.mark.parametrize("case", ["draft_without_model",
                                  "draft_with_sampling", "overhang",
                                  "opt_out"])
def test_submit_validation(models, case):
    target = models["target"][1]
    draft = None if case == "draft_without_model" else target
    with make_engine(target, draft_model=draft) as eng:
        _validation(eng, case)
        assert_whole(eng)


def test_constructor_validation(models):
    target = models["target"][1]
    with pytest.raises(ValueError, match="spec_tokens"):
        make_engine(target, draft_model=target, spec_tokens=0)
    other = LlamaForCausalLM(LlamaConfig(**dict(TINY, vocab_size=32)),
                             device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        make_engine(target, draft_model=other)


def test_w8_target_with_full_precision_draft(models):
    """quantize applies to the target only: a w8 target speculating with
    a full-precision clone gives the w8 target's draft-free stream."""
    target = models["target"][1]
    clone = params_from_numpy(LlamaConfig(**TINY),
                              _arrays(models["target"][0]), device="cpu")
    prompts, _ = _prompts()
    streams = []
    for draft in (None, clone):
        with make_engine(target, quantize="w8", draft_model=draft) as eng:
            with eng._cond:
                reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            streams.append([r.result(timeout=60).tolist() for r in reqs])
            if draft is not None:
                assert eng._draft_decoder.quantize is None
                assert eng.spec_proposed > 0
            assert_whole(eng)
    assert streams[0] == streams[1]
