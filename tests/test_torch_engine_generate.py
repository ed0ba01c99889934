"""The engine's blocking batch API against the JAX engine's
(``paddle_tpu/inference/continuous.py:1046-1099``): ``generate`` takes
``draft`` and ``request_id``, and ``generate_with_requests`` returns the
output ids with the requests, a multi-row call's ids being
``<id>/<row>`` and a single row's the id itself (CPU, f32, the JAX
weights carried over)."""
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(total_pages=64, page_size=4, max_batch=4, min_table_pages=16)
NEW = 6


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, port model): the target and a draft of
    another seed."""
    out = {}
    for name, seed in (("target", 0), ("draft", 7)):
        paddle.seed(seed)
        jm = JaxLM(JaxConfig(**TINY))
        arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        out[name] = (jm, params_from_numpy(LlamaConfig(**TINY), arrays,
                                           device="cpu"))
    return out


def _rows(n=2, length=6):
    rng = np.random.default_rng(5)
    return rng.integers(0, 64, (n, length)).astype(np.int32)


def _port(models, draft=True, **kw):
    if draft:
        kw.update(draft_model=models["draft"][1], spec_tokens=2)
    return ContinuousBatchingEngine(models["target"][1], device="cpu",
                                    **ENGINE, **kw)


def test_two_rows_with_a_draft_equal_jax_streams_and_ids(models):
    with JaxEngine(models["target"][0], draft_model=models["draft"][0],
                   spec_tokens=2, **ENGINE) as eng:
        want, jreqs = eng.generate_with_requests(
            _rows(), max_new_tokens=NEW, request_id="gen")
    with _port(models) as eng:
        got, reqs = eng.generate_with_requests(
            _rows(), max_new_tokens=NEW, request_id="gen")
        assert eng.spec_proposed > 0
    np.testing.assert_array_equal(got, np.asarray(want))
    assert [r.request_id for r in reqs] \
        == [r.request_id for r in jreqs] == ["gen/0", "gen/1"]
    assert all(r.done.is_set() and r.error is None for r in reqs)


def test_draft_false_equals_the_draft_free_run(models):
    with _port(models, draft=False) as eng:
        want = eng.generate(_rows(), max_new_tokens=NEW)
    with _port(models) as eng:
        got = eng.generate(_rows(), max_new_tokens=NEW, draft=False,
                           request_id="plain")
        assert eng.spec_proposed == 0
        assert eng.result_for("plain/1")["status"] == "done"
    np.testing.assert_array_equal(got, want)


def test_a_single_row_keeps_its_id(models):
    with _port(models, draft=False) as eng:
        out, reqs = eng.generate_with_requests(_rows(1), max_new_tokens=NEW,
                                               request_id="solo")
    assert [r.request_id for r in reqs] == ["solo"]
    assert out.shape == (1, 6 + NEW)


def test_a_failing_row_cancels_the_submitted_ones(models):
    """The second row runs past max_position_embeddings: the call raises
    and the first row, already submitted, is cancelled and reaped."""
    rng = np.random.default_rng(6)
    rows = [rng.integers(0, 64, (5,)).astype(np.int32),
            rng.integers(0, 64, (120,)).astype(np.int32)]
    with _port(models) as eng:
        with pytest.raises(ValueError, match="max_position_embeddings"):
            eng.generate_with_requests(rows, max_new_tokens=60,
                                       request_id="bad")
        end = time.monotonic() + 60
        while eng.result_for("bad/0") is None \
                or eng.result_for("bad/0")["status"] == "pending":
            assert time.monotonic() < end, "the first row was not reaped"
            time.sleep(0.005)
        assert eng.result_for("bad/0")["status"] == "error"
