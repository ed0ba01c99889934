"""The port's engine cancels cooperatively, as the JAX package's does
(``paddle_tpu/inference/continuous.py`` ``_Request.cancel``,
``_reap_locked``, ``generate``): a batch that fails leaves no row
decoding against the pool, and a cancelled row frees its pages without
disturbing the rows beside it (CPU, f32)."""
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch.inference import continuous
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(total_pages=64, page_size=8, max_batch=4)


@pytest.fixture(scope="module")
def model():
    paddle.seed(0)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


def _prompts(*lengths):
    rng = np.random.default_rng(4)
    return [rng.integers(0, 64, (n,)).astype(np.int32) for n in lengths]


def _idle(eng):
    """The engine holds no request and only the pad-row headroom."""
    with eng._cond:
        return (not len(eng._sched) and not eng._preempted
                and not eng._prefilling and not eng._active
                and eng._reserved_pages == eng._pad_pages
                and eng.cache.free_pages == ENGINE["total_pages"])


def _wait(cond, timeout=60.0):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError("timed out")
        time.sleep(0.005)


def _spy_submits(eng, monkeypatch):
    """Record every request ``generate`` submits."""
    seen, real = [], eng.submit

    def submit(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(eng, "submit", submit)
    return seen


@pytest.mark.parametrize("chunk", [None, 8], ids=["unchunked", "chunked"])
def test_batch_with_a_too_long_row_leaves_no_orphans(model, monkeypatch,
                                                     chunk):
    """The last row is past max_position_embeddings: ``generate`` raises
    and cancels the rows it already submitted, which the loop reaps —
    queue, mid-prefill and active lists empty, every page and reservation
    back, each waiter told ``RequestCancelled``."""
    with ContinuousBatchingEngine(model, device="cpu",
                                  prefill_chunk_tokens=chunk,
                                  **ENGINE) as eng:
        seen = _spy_submits(eng, monkeypatch)
        rows = _prompts(5, 12, 120)
        with pytest.raises(ValueError, match="max_position_embeddings"):
            eng.generate(rows, max_new_tokens=60)
        assert len(seen) == 2
        for r in seen:
            assert r.cancelled
            with pytest.raises(continuous.RequestCancelled):
                r.result(timeout=60)
            assert len(r.generated) < 60
        _wait(lambda: _idle(eng))
        # and the engine keeps serving
        out = eng.generate(_prompts(5, 7), max_new_tokens=4)
        assert out.shape == (2, 11)


def test_a_failing_row_cancels_the_rest_of_its_batch(model, monkeypatch):
    """The first row's prefill fails (its ``result()`` raises): the other
    rows of the batch are cancelled, not left decoding, and the error is
    the failing row's."""
    with ContinuousBatchingEngine(model, device="cpu", **ENGINE) as eng:
        seen = _spy_submits(eng, monkeypatch)
        real = eng._decoder.prefill

        def prefill(cache, seq_ids, ids, **kw):
            if ids.shape[1] == 9:
                raise RuntimeError("injected prefill failure")
            return real(cache, seq_ids, ids, **kw)

        monkeypatch.setattr(eng._decoder, "prefill", prefill)
        with pytest.raises(RuntimeError, match="injected prefill failure"):
            eng.generate(_prompts(9, 5, 12), max_new_tokens=60)
        assert len(seen) == 3
        for r in seen[1:]:
            with pytest.raises(continuous.RequestCancelled):
                r.result(timeout=60)
            assert len(r.generated) < 60
        _wait(lambda: _idle(eng))


def test_cancelled_row_leaves_the_others_as_they_were(model):
    """Cancel one row of a running batch: the other rows finish with the
    tokens they have without the cancel, the cancelled row's waiter gets
    ``RequestCancelled``, and its pages come back."""
    prompts = _prompts(5, 12, 20)
    with ContinuousBatchingEngine(model, device="cpu", **ENGINE) as eng:
        reqs = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, (6, 60, 6))]
        want = [r.result(timeout=120).tolist() for r in reqs]
    with ContinuousBatchingEngine(model, device="cpu", **ENGINE) as eng:
        reqs = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, (6, 60, 6))]
        _wait(lambda: reqs[1].first_token_at is not None)
        assert reqs[1].cancel()
        with pytest.raises(continuous.RequestCancelled):
            reqs[1].result(timeout=60)
        assert len(reqs[1].generated) < 60
        assert reqs[0].result(timeout=60).tolist() == want[0]
        assert reqs[2].result(timeout=60).tolist() == want[2]
        _wait(lambda: _idle(eng))
        # a finished request cannot be cancelled
        assert not reqs[0].cancel()
        assert reqs[0].result().tolist() == want[0]


def test_cancel_before_admission(model):
    """A request cancelled while queued never takes a slot or a page."""
    prompts = _prompts(5, 6)
    with ContinuousBatchingEngine(model, device="cpu", total_pages=64,
                                  page_size=8, max_batch=1) as eng:
        first = eng.submit(prompts[0], max_new_tokens=40)
        second = eng.submit(prompts[1], max_new_tokens=4)
        assert second.cancel()
        with pytest.raises(continuous.RequestCancelled):
            second.result(timeout=60)
        assert second.seq_id is None
        assert len(first.result(timeout=120)) == 5 + 40
        _wait(lambda: _idle(eng))
