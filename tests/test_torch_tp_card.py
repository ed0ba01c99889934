"""Tensor-parallel serving on the card: tp=2 as two processes on one card
over gloo (asked for explicitly; NCCL puts a rank on each card) against
tp=1 on the same card, with the kernels.  A small f32 model: prefill and
decode logits of the tp=2 decoder against the tp=1 one's, greedy streams
of tp=2 engines equal to tp=1 engines' (unified and legacy, int8 KV
pages too), and each rank launching the same kernels as the other.
These need a CUDA device; elsewhere they skip.  Run them on the card with

    python -m pytest --noconftest tests/test_torch_tp_card.py

The CPU twins, against the JAX package, are in
``tests/test_torch_tp_engine.py``."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.cuda_graphs import counted_wrappers
from paddle_tpu_torch.distributed.tensor_parallel import TensorParallelGroup
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.inference.paged import PagedDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.paged_attention import PagedKVCache

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=512)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", seed=7)


@pytest.fixture(scope="module")
def group(model):
    g = TensorParallelGroup(2, "cuda", backend="gloo")
    yield g
    g.close()


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (9, 40, 130, 77)]


def test_decoder_logits_match_tp1(model, group):
    one = PagedDecoder(model)
    c1 = PagedKVCache.from_model(model, total_pages=32, page_size=16)
    two = PagedDecoder(model, tp_group=group)
    c2 = PagedKVCache.from_model(model, total_pages=32, page_size=16,
                                 tp_group=group)
    prompt = _prompts()[2][None]
    a, b = one.prefill(c1, [0], prompt), two.prefill(c2, [0], prompt)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    tok = a.argmax(-1).astype(np.int32).reshape(1, 1)
    pos = np.array([prompt.shape[1]], np.int32)
    for _ in range(6):
        a, b = one.step(c1, [0], tok, pos), two.step(c2, [0], tok, pos)
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
        assert a.argmax() == b.argmax()
        tok = a.argmax(-1).astype(np.int32).reshape(1, 1)
        pos = pos + 1


def test_each_rank_launches_the_same_kernels(model, group):
    dec = PagedDecoder(model, tp_group=group)
    cache = PagedKVCache.from_model(model, total_pages=32, page_size=16,
                                    tp_group=group)
    wrappers = counted_wrappers()
    for fn in wrappers:
        fn.launches = 0
    group.query("zero_launches")
    logits = dec.prefill(cache, [0], _prompts()[1][None])
    tok = logits.argmax(-1).astype(np.int32).reshape(1, 1)
    dec.step(cache, [0], tok, np.array([40], np.int32))
    torch.cuda.synchronize()
    mine = {fn.__name__: fn.launches for fn in wrappers}
    assert group.query("launches") == [mine]
    assert mine["paged_attention_cuda"] == 2          # the decode step
    assert mine["flash_attention_cuda"] == 2          # the prefill
    assert mine["rms_norm_triton"] == 2 * (2 * 2 + 1)


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["bf", "int8kv"])
def test_engine_streams_equal_tp1(model, unified, kv_quant):
    def run(**kw):
        with ContinuousBatchingEngine(model, total_pages=64, page_size=16,
                                      max_batch=4, unified_step=unified,
                                      kv_quant=kv_quant, device="cuda",
                                      **kw) as eng:
            reqs = [eng.submit(p, max_new_tokens=12) for p in _prompts()]
            return [r.result(timeout=300).tolist() for r in reqs]

    assert run(tp=2, tp_backend="gloo") == run()


def test_nccl_without_two_cards_names_the_way_out(model):
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible: NCCL can start")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        TensorParallelGroup(2, "cuda")
