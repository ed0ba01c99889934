"""Port parity: paddle_tpu_torch's continuous-batching engine against the
JAX package's engine on the same weights and requests (CPU, f32).
Greedy streams must be identical token for token — unchunked, chunked,
and with a prefix-cache hit.  Sampled rows draw JAX's threefry bits, so
sampled streams must be identical too; they are also held to replay and
to their distribution."""
import threading

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.inference.paged import fused_sample
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(total_pages=64, page_size=8, max_batch=4)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


def _prompts():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n in (5, 12, 20)]
    # shares the last prompt's first two 8-token pages
    sharer = np.concatenate([prompts[2][:16],
                             rng.integers(0, 64, (5,))]).astype(np.int32)
    return prompts, sharer


def _serve(engine):
    """Three concurrent greedy requests, then the prefix owner again and
    a request sharing its cached prefix.  Returns the streams and the
    sharer's prefix-hit length."""
    prompts, sharer = _prompts()
    reqs = [engine.submit(p, max_new_tokens=6) for p in prompts]
    outs = [r.result(timeout=300).tolist() for r in reqs]
    outs.append(engine.submit(prompts[2], max_new_tokens=3)
                .result(timeout=300).tolist())
    hit = engine.submit(sharer, max_new_tokens=5)
    outs.append(hit.result(timeout=300).tolist())
    return outs, hit.prefix_tokens


@pytest.mark.parametrize("chunk", [None, 8], ids=["unchunked", "chunked"])
def test_greedy_streams_match_jax_engine(models, chunk):
    jm, tm = models
    with JaxEngine(jm, prefill_chunk_tokens=chunk, **ENGINE) as eng:
        want, want_hit = _serve(eng)
    with ContinuousBatchingEngine(tm, prefill_chunk_tokens=chunk,
                                  device="cpu", **ENGINE) as eng:
        got, got_hit = _serve(eng)
        assert eng.cache.free_pages == ENGINE["total_pages"]
        assert eng._reserved_pages == eng._pad_pages
    assert got_hit == want_hit == 16
    assert got == want


def _serve_sampled(engine):
    """Three sampled requests beside one greedy one, at two temperatures
    and three seeds; returns every stream."""
    prompts, sharer = _prompts()
    reqs = [engine.submit(p, max_new_tokens=8, do_sample=True,
                          temperature=t, seed=s)
            for p, t, s in zip(prompts, (0.8, 1.0, 1.5), (11, 0, 2 ** 32 - 1))]
    reqs.append(engine.submit(sharer, max_new_tokens=8))
    return [r.result(timeout=300).tolist() for r in reqs]


@pytest.mark.parametrize("chunk", [None, 8], ids=["unchunked", "chunked"])
def test_sampled_streams_match_jax_engine(models, chunk):
    jm, tm = models
    with JaxEngine(jm, prefill_chunk_tokens=chunk, **ENGINE) as eng:
        want = _serve_sampled(eng)
    with ContinuousBatchingEngine(tm, prefill_chunk_tokens=chunk,
                                  device="cpu", **ENGINE) as eng:
        got = _serve_sampled(eng)
    assert got == want


def _serve_host_sampled(engine):
    """Two sampled requests at temperature 1.5 (seeds 1 and 2) beside a
    greedy one, sampled on the host."""
    prompts, _ = _prompts()
    reqs = [engine.submit(p, max_new_tokens=8, do_sample=True,
                          temperature=1.5, seed=s)
            for p, s in zip(prompts[:2], (1, 2))]
    reqs.append(engine.submit(prompts[2], max_new_tokens=8))
    return [r.result(timeout=300).tolist() for r in reqs]


@pytest.mark.parametrize("chunk", [None, 8], ids=["unchunked", "chunked"])
def test_host_sampled_streams_match_jax_engine(models, chunk):
    """``sample_on_device=False`` draws from each request's numpy
    generator, as the JAX engine's ``sample_token`` does."""
    jm, tm = models
    with JaxEngine(jm, prefill_chunk_tokens=chunk, sample_on_device=False,
                   **ENGINE) as eng:
        want = _serve_host_sampled(eng)
    with ContinuousBatchingEngine(tm, prefill_chunk_tokens=chunk,
                                  sample_on_device=False, device="cpu",
                                  **ENGINE) as eng:
        got = _serve_host_sampled(eng)
    assert got == want


@pytest.mark.parametrize("chunk", [None, 8], ids=["unchunked", "chunked"])
def test_sampled_request_replays_under_any_batch(models, chunk):
    """A sampled request's draws are keyed by (seed, absolute position),
    so it replays exactly alone or beside other traffic."""
    _jm, tm = models
    prompts, _ = _prompts()
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.8, seed=11)
    with ContinuousBatchingEngine(tm, prefill_chunk_tokens=chunk,
                                  device="cpu", **ENGINE) as eng:
        alone = eng.submit(prompts[1], **kw).result(timeout=300)
        others = [eng.submit(p, max_new_tokens=8) for p in prompts]
        busy = eng.submit(prompts[1], **kw)
        reseeded = eng.submit(prompts[1], **dict(kw, seed=12))
        for r in others:
            r.result(timeout=300)
        np.testing.assert_array_equal(busy.result(timeout=300), alone)
        assert not np.array_equal(reseeded.result(timeout=300), alone)


def test_fused_sample_matches_softmax_distribution():
    logits = torch.tensor([[1.0, 0.5, 0.0, -0.5, 2.0, -1.0, 0.3, 1.2]])
    temp = 0.7
    n = 4000
    # one row per counter, all drawn in one batched call
    tok = fused_sample(logits.expand(n, 8), np.full(n, 5, np.uint32),
                       np.arange(n, dtype=np.int32),
                       np.full(n, temp, np.float32), np.ones(n, bool))
    counts = np.bincount(tok.numpy(), minlength=8)
    want = torch.softmax(logits[0] / temp, dim=0).numpy()
    # 4000 draws: a binomial share's standard deviation is <= 0.008
    np.testing.assert_allclose(counts / n, want, rtol=0, atol=0.035)
    # greedy rows are the argmax
    tok = fused_sample(logits, np.zeros(1, np.uint32), np.zeros(1, np.int32),
                       np.ones(1, np.float32), np.array([False]))
    assert int(tok[0]) == 4


def test_failed_step_fails_its_requests_loudly(models, monkeypatch):
    """A ragged step that raises (not an injected fault) wakes its
    request's waiter with the error (no hang) and quarantines it, with
    no re-run through the legacy composition; its pages are freed and
    the engine keeps serving."""
    _jm, tm = models
    prompts, _ = _prompts()
    with ContinuousBatchingEngine(tm, device="cpu", **ENGINE) as eng:
        boom = RuntimeError("injected step failure")
        real = eng._decoder.ragged_step
        armed = threading.Event()
        armed.set()

        def failing(*a, **kw):
            if armed.is_set():
                armed.clear()
                raise boom
            return real(*a, **kw)

        monkeypatch.setattr(eng._decoder, "ragged_step", failing)
        req = eng.submit(prompts[0], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="injected step failure"):
            req.result(timeout=60)
        assert (eng.quarantined, eng.unified_fallbacks) == (1, 0)
        assert eng.dispatches["decode"] == 0
        assert eng.cache.free_pages == ENGINE["total_pages"]
        out = eng.submit(prompts[0], max_new_tokens=4).result(timeout=60)
        assert len(out) == len(prompts[0]) + 4


def test_engine_refuses_a_model_on_another_device(models):
    _jm, tm = models
    with pytest.raises(ValueError, match="lives on"):
        ContinuousBatchingEngine(tm, device="meta")
