"""Port parity: the engine's legacy composition (``unified_step=False``:
one dispatch a prefill chunk, then one decode step for every active row,
padded to a power of two with rows on a scratch sequence) against the
JAX engine's legacy composition on the same weights and requests (CPU,
f32), and against the port's own unified ragged step.  Greedy streams
must be identical token for token — unchunked, chunked, with a prefix
hit and with int8 KV pages — and so must sampled ones, whose draws are
keyed by (seed, absolute position) whatever the pad rows around them."""
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch.inference import continuous
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.inference.paged import PagedDecoder
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(total_pages=64, page_size=8, max_batch=4)
# (prefill chunk, sampled, kv_quant) of each JAX reference stream set
CASES = {"greedy": (None, False, None),
         "greedy_chunked": (8, False, None),
         "sampled": (None, True, None),
         "sampled_chunked": (8, True, None),
         "int8kv_chunked": (8, False, "int8")}


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


def _serve(engine, sampled):
    """Three concurrent requests (sampled at two temperatures beside a
    greedy one, or all greedy), then the prefix owner again and a request
    sharing its cached prefix.  Returns the streams and the sharer's
    prefix-hit length."""
    prompts, sharer = _prompts()
    draws = [(sampled and i < 2, t, s)
             for i, (t, s) in enumerate(((0.8, 11), (1.5, 2 ** 32 - 1),
                                         (1.0, 0)))]
    reqs = [engine.submit(p, max_new_tokens=6, do_sample=d, temperature=t,
                          seed=s) for p, (d, t, s) in zip(prompts, draws)]
    outs = [r.result(timeout=300).tolist() for r in reqs]
    outs.append(engine.submit(prompts[2], max_new_tokens=3)
                .result(timeout=300).tolist())
    hit = engine.submit(sharer, max_new_tokens=5, do_sample=sampled,
                        seed=5)
    outs.append(hit.result(timeout=300).tolist())
    return outs, hit.prefix_tokens


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engine's legacy streams of every case, computed once."""
    jm, _tm = models
    out = {}
    for name, (chunk, sampled, kv) in CASES.items():
        with JaxEngine(jm, prefill_chunk_tokens=chunk, kv_quant=kv,
                       unified_step=False, **ENGINE) as eng:
            out[name] = _serve(eng, sampled)
    return out


def _port(tm, case, unified=False):
    chunk, sampled, kv = CASES[case]
    with ContinuousBatchingEngine(tm, prefill_chunk_tokens=chunk,
                                  kv_quant=kv, unified_step=unified,
                                  device="cpu", **ENGINE) as eng:
        got = _serve(eng, sampled)
        assert eng.cache.free_pages == ENGINE["total_pages"]
        assert eng._reserved_pages == eng._pad_pages == 1
        assert (eng.decode_retries, eng.quarantined,
                eng.unified_fallbacks) == (0, 0, 0)
        return got, dict(eng.dispatches)


@pytest.mark.parametrize("case", list(CASES))
def test_legacy_streams_match_jax_legacy(models, jax_streams, case):
    _jm, tm = models
    (got, got_hit), disp = _port(tm, case)
    want, want_hit = jax_streams[case]
    assert got_hit == want_hit == 16
    assert got == want
    chunked = CASES[case][0] is not None
    assert disp["ragged"] == 0 and disp["decode"] > 0
    # the two prefix hits' suffixes and (chunked) every later chunk go
    # through the chunk-prefill continuation
    assert disp["prefill"] == 3
    assert disp["chunk"] == (1 + 2 + 1 + 1 if chunked else 2)


@pytest.mark.parametrize("case", ["greedy", "sampled_chunked"])
def test_legacy_equals_unified(models, case):
    """The port's two compositions give the same streams; the legacy one
    dispatches no ragged step, the unified one no decode step (and,
    chunked, no prefill either: every chunk rides the ragged step)."""
    _jm, tm = models
    (leg, _), d_leg = _port(tm, case)
    (uni, _), d_uni = _port(tm, case, unified=True)
    assert leg == uni
    assert d_leg["ragged"] == 0 and d_leg["decode"] > 0
    assert d_uni["decode"] == 0 and d_uni["ragged"] > 0
    if CASES[case][0] is None:
        assert d_uni["prefill"] == d_leg["prefill"] == 3
        assert d_uni["chunk"] == d_leg["chunk"] == 2
    else:
        assert d_uni["prefill"] == d_uni["chunk"] == 0


def test_padded_sampled_rows_draw_their_own_tokens(models):
    """A sampled request's stream is the same alone (a batch of one, no
    pad row) and beside one or two others (a bucket of 2, or of 4 with a
    pad row): ``_sampling_for`` pads seeds, temperatures and flags to the
    bucket, and pad rows draw nothing."""
    _jm, tm = models
    prompts, _ = _prompts()
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.8, seed=11)
    with ContinuousBatchingEngine(tm, unified_step=False, device="cpu",
                                  **ENGINE) as eng:
        alone = eng.submit(prompts[1], **kw).result(timeout=300)
        streams = []
        for others in (prompts[:1], [prompts[0], prompts[2]]):
            with eng._cond:       # admitted together: one decode bucket
                reqs = [eng.submit(p, max_new_tokens=8) for p in others]
                busy = eng.submit(prompts[1], **kw)
            streams.append(busy.result(timeout=300))
            for r in reqs:
                r.result(timeout=300)
        assert eng.cache.free_pages == ENGINE["total_pages"]
        seeds, ctrs, temps, flags = eng._sampling_for(
            [continuous._Request(prompts[1], 8, None, True, 0.8, 11)],
            [9, 1, 1, 1])
    for got in streams:
        np.testing.assert_array_equal(got, alone)
    assert [len(a) for a in (seeds, ctrs, temps, flags)] == [4] * 4
    assert flags.tolist() == [True, False, False, False]


@pytest.mark.parametrize("pads", [1, 2, 3])
def test_pad_rows_change_no_real_page_or_output(models, pads):
    """Pad rows on the one scratch sequence write slot 0 of its page
    once a row (identical values, so the duplicate targets are benign)
    and advance its length by the pad count: in a bucket of 4, row 0's
    output and pages are bit-equal whether 0, 1, 2 or 3 of the other
    rows are pads."""
    _jm, tm = models
    ids = np.random.default_rng(3).integers(0, 64, (4, 10)).astype(np.int32)
    results = []
    for n_pad in (0, pads):
        cache = continuous.PagedKVCache.from_model(tm, total_pages=16,
                                                   page_size=8)
        dec = PagedDecoder(tm)
        first = dec.prefill(cache, [0, 1, 2, 3], ids).argmax(axis=-1)
        seq_ids = [0, 1, 2, 3][:4 - n_pad]
        if n_pad:
            cache.truncate(continuous._PAD_SEQ, 0)
            cache.allocate(continuous._PAD_SEQ, 1)
            seq_ids += [continuous._PAD_SEQ] * n_pad
        real = 4 - n_pad
        tokens = np.zeros((4, 1), np.int32)
        tokens[:real, 0] = first[:real]
        pos = np.zeros(4, np.int32)
        pos[:real] = 10
        logits = dec.step(cache, seq_ids, tokens, pos)
        pages = cache._seq_pages[0]
        results.append((logits[0], [t[:, pages].clone() for t in
                                    cache.k_pages + cache.v_pages]))
        if n_pad:
            assert cache.length(continuous._PAD_SEQ) == n_pad
            assert len(cache._seq_pages[continuous._PAD_SEQ]) == 1
        assert cache.length(0) == 11
    (l0, p0), (l1, p1) = results
    np.testing.assert_array_equal(l1, l0)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


def test_cancelling_every_active_row_returns_the_pad_page(models):
    """Legacy mode: three decoding rows (padded to four on the scratch
    sequence) all cancelled between steps; the reap that empties the
    batch gives the scratch page back, so the pool comes back whole."""
    _jm, tm = models
    prompts, _sharer = _prompts()
    with ContinuousBatchingEngine(tm, unified_step=False, device="cpu",
                                  **ENGINE) as eng:
        with eng._cond:     # admitted together: one batch of three
            reqs = [eng.submit(p, max_new_tokens=100) for p in prompts]
        with eng._cond:
            while eng.dispatches["decode"] < 2:
                eng._cond.wait(timeout=1)
            assert len(eng._active) == 3
            for r in reqs:
                r.cancel()
        for r in reqs:
            with pytest.raises(continuous.RequestCancelled):
                r.result(timeout=120)
        t0 = time.monotonic()
        while eng.cache.free_pages != ENGINE["total_pages"] \
                and time.monotonic() - t0 < 30:
            time.sleep(0.01)
        assert eng.cache.free_pages == ENGINE["total_pages"]
        assert eng._reserved_pages == 1
