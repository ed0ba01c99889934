"""Port parity: ``SpeculativeGenerator`` (greedy draft-verify over the
concat KV-cache forward) against the JAX package's on the same weights
and prompt, in f32 on the CPU — ids equal, and ``last_stats``' rounds,
proposed and accepted equal — with a bad draft, the target as its own
draft, an eos cut and a sparse-MoE target with a dense draft; every
stream also equals the port's target-only greedy ``generate``.  Plus the
O(accepted) rollback of ``_RollbackKV``.

The JAX generator runs op by op, compiling each new cache length's
shapes, so its runs share one prompt and a few tokens, and run once a
module."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import SpeculativeGenerator as JaxSpeculative
from paddle_tpu.models import LlamaMoeConfig as JaxMoeConfig
from paddle_tpu.models import LlamaMoeForCausalLM as JaxMoeLM
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch.inference import SpeculativeGenerator
from paddle_tpu_torch.inference.speculative import _RollbackKV
from paddle_tpu_torch.models.convert import (moe_params_from_numpy,
                                             params_from_numpy)
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.llama_moe import LlamaMoeConfig

# the widths of tests/test_torch_engine_spec.py's model, so one process
# running both compiles the JAX package's ops once
WIDTHS = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=128)
MOE = dict(WIDTHS, num_hidden_layers=1, num_experts=4, gate_type="naive")
PROMPT = np.random.default_rng(0).integers(0, 64, (1, 3)).astype(np.int32)
NEW = 3
# case -> (target, draft, k, max_new_tokens, eos position in the bad
# draft's stream or None)
CASES = {"bad_draft": ("dense", "bad", 2, NEW, None),
         "self_draft": ("dense", "dense", 2, NEW, None),
         "eos": ("dense", "bad", 2, NEW, 1),
         "moe_target": ("moe", "bad", 2, NEW, None)}


def _arrays(model):
    return {n: np.asarray(p._data) for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, port model) on the same weights."""
    paddle.seed(0)
    dense = JaxLM(JaxConfig(num_hidden_layers=1, **WIDTHS))
    paddle.seed(99)
    bad = JaxLM(JaxConfig(num_hidden_layers=1, **WIDTHS))
    paddle.seed(10)
    moe = JaxMoeLM(JaxMoeConfig(**MOE))
    moe.eval()
    out = {}
    for name, jm in (("dense", dense), ("bad", bad)):
        out[name] = (jm, params_from_numpy(
            LlamaConfig(num_hidden_layers=1, **WIDTHS), _arrays(jm),
            device="cpu"))
    tm = moe_params_from_numpy(LlamaMoeConfig(**MOE), _arrays(moe),
                               device="cpu")
    tm.eval()
    out["moe"] = (moe, tm)
    return out


def _eos(case, streams):
    pos = CASES[case][4]
    if pos is None:
        return None
    return int(streams["bad_draft"][0][0, PROMPT.shape[1] + pos])


@pytest.fixture(scope="module")
def jax_runs(models):
    """case -> (ids, last_stats) of the JAX generator, each run once."""
    out = {}
    for case, (target, draft, k, new, _pos) in CASES.items():
        gen = JaxSpeculative(models[target][0], models[draft][0], k)
        ids = gen.generate(PROMPT, max_new_tokens=new,
                           eos_token_id=_eos(case, out))
        out[case] = (np.asarray(ids), dict(gen.last_stats))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_generator_matches_jax(models, jax_runs, case):
    target, draft, k, new, _pos = CASES[case]
    eos = _eos(case, jax_runs)
    gen = SpeculativeGenerator(models[target][1], models[draft][1], k)
    got = gen.generate(PROMPT, max_new_tokens=new, eos_token_id=eos)
    want, stats = jax_runs[case]
    np.testing.assert_array_equal(got, want)
    for key in ("rounds", "proposed", "accepted", "acceptance_rate",
                "tokens_per_round"):
        assert gen.last_stats[key] == stats[key], key
    if case == "self_draft":
        assert stats["acceptance_rate"] == 1.0
    if case in ("bad_draft", "moe_target"):
        assert stats["accepted"] < stats["proposed"]
    if eos is not None:
        assert got[0, -1] == eos and got.shape[1] < PROMPT.shape[1] + new
    # exact: the target-only greedy stream, up to where it stops
    ref = models[target][1].generate(torch.as_tensor(PROMPT),
                                     max_new_tokens=new, eos_token_id=eos)
    n = got.shape[1]
    np.testing.assert_array_equal(got, np.asarray(ref)[:, :n])


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_any_lookahead_is_target_greedy(models, k):
    """Whatever k, the budget clamp included, the stream is the target's
    greedy one (port alone)."""
    target, draft = models["dense"][1], models["bad"][1]
    gen = SpeculativeGenerator(target, draft, k)
    got = gen.generate(PROMPT, max_new_tokens=9)
    ref = target.generate(torch.as_tensor(PROMPT), max_new_tokens=9)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert gen.last_stats["proposed"] >= gen.last_stats["rounds"] >= 1


def test_rejects_batched_input(models):
    gen = SpeculativeGenerator(models["dense"][1], models["dense"][1])
    with pytest.raises(ValueError, match="batch 1"):
        gen.generate(np.zeros((2, 4), np.int32), max_new_tokens=4)
    with pytest.raises(ValueError):
        SpeculativeGenerator(models["dense"][1], models["bad"][1], 0)


def test_absorb_preserves_base_identity_and_slices_only_tail():
    """A round's outcome keeps the fed base (the same objects) and takes
    only the accepted prefix of the appended block; the next feed merges
    them once."""
    t, k, accepted = 10, 4, 2
    base = [(torch.zeros(1, t, 2, 8), torch.zeros(1, t, 2, 8))]
    kv = _RollbackKV(base)
    fed = kv.feed()
    assert fed is base and fed[0][0] is base[0][0]      # no-op merge
    full = [(torch.ones(1, t + k + 1, 2, 8), torch.ones(1, t + k + 1, 2, 8))]
    kv.absorb(full, t + accepted + 1)
    assert kv.base is base and kv.base[0][0] is base[0][0]
    assert int(kv.tail[0][0].shape[1]) == accepted + 1
    assert kv.length == t + accepted + 1
    with pytest.raises(RuntimeError):
        kv.absorb(full, t + 1)                # absorb follows a feed
    merged = kv.feed()
    assert int(merged[0][0].shape[1]) == t + accepted + 1
    assert kv.tail is None
    assert float(merged[0][0][:, :t].abs().sum()) == 0.0
    assert bool((merged[0][0][:, t:] == 1).all())


def test_rollback_keeps_the_caches_at_the_stream(models):
    """After a generate with a rejecting draft the live caches cover the
    emitted stream but its unverified last token."""
    target, draft = models["dense"][1], models["bad"][1]
    gen = SpeculativeGenerator(target, draft, 3)
    got = gen.generate(PROMPT, max_new_tokens=8)
    assert gen.last_stats["accepted"] < gen.last_stats["proposed"]
    assert gen._tgt_kv.length in (got.shape[1] - 1, got.shape[1])
    assert gen._dft_kv.length <= gen._tgt_kv.length
