"""Speculative decoding on the card: the engine with a draft model, its
steps and the draft's proposals as CUDA graphs (``GraphedPagedDecoder``),
against the eager engine on the CPU from the same f32 weights, and
``SpeculativeGenerator`` on the card against its CPU run.  These need a
CUDA device; elsewhere they skip.  Run them on the card with

    python -m pytest --noconftest tests/test_torch_engine_spec_card.py

In f32 the card's kernels and the CPU's plain versions give the same
greedy ids on these small models, so the streams are held exactly."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        SpeculativeGenerator)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=256)
ENGINE = dict(total_pages=64, page_size=16, max_batch=4, spec_tokens=3,
              min_table_pages=16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode")
    return torch.device("cuda")


def _pair(seed):
    """The same f32 weights on the CPU and on the card."""
    cpu = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=seed)
    card = LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", seed=None)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in (7, 30, 75, 12)]


def _wave(eng, prompts):
    """The prompts admitted together, the last one sampled."""
    with eng._cond:
        reqs = [eng.submit(p, max_new_tokens=10, do_sample=i == 3,
                           temperature=0.9, seed=3)
                for i, p in enumerate(prompts)]
    return [r.result(timeout=300).tolist() for r in reqs]


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
@pytest.mark.parametrize("draft", ["self", "bad"])
def test_graphed_spec_engine_equals_cpu(dev, unified, draft):
    cpu, card = _pair(3)
    d_cpu, d_card = (cpu, card) if draft == "self" else _pair(4)
    outs = {}
    for name, model, d, device in (("card", card, d_card, "cuda"),
                                   ("cpu", cpu, d_cpu, "cpu"),
                                   ("plain", card, None, "cuda")):
        with ContinuousBatchingEngine(model, draft_model=d,
                                      unified_step=unified, device=device,
                                      **ENGINE) as eng:
            outs[name] = _wave(eng, _prompts(5))
            if name == "card":
                assert eng._draft_decoder.replays > 0
                assert eng.spec_proposed > 0
                assert eng.dispatches["verify" if not unified
                                      else "ragged"] > 0
                assert eng.drain(timeout=60)
                assert eng.draft_cache.free_pages == ENGINE["total_pages"]
                assert eng._reserved_draft_pages == eng._pad_pages
    assert outs["card"] == outs["cpu"] == outs["plain"]


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
def test_second_wave_captures_nothing(dev, unified):
    """A second wave of the same prompt lengths (other tokens) and a
    perfect draft replays the graphs the first captured."""
    _cpu, card = _pair(3)
    with ContinuousBatchingEngine(card, draft_model=card,
                                  unified_step=unified, device="cuda",
                                  **ENGINE) as eng:
        _wave(eng, _prompts(5))
        captured, replayed = eng.captures, eng.replays
        _wave(eng, _prompts(6))
        assert eng.captures == captured and eng.replays > replayed


@pytest.mark.parametrize("draft", ["self", "bad"])
def test_speculative_generator_card_equals_cpu(dev, draft):
    cpu, card = _pair(3)
    d_cpu, d_card = (cpu, card) if draft == "self" else _pair(4)
    ids = _prompts(7)[1][None]
    got = SpeculativeGenerator(card, d_card, 4).generate(ids,
                                                         max_new_tokens=16)
    want = SpeculativeGenerator(cpu, d_cpu, 4).generate(ids,
                                                        max_new_tokens=16)
    dense = card.generate(torch.as_tensor(ids, device=dev),
                          max_new_tokens=16).cpu().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dense)
