"""Port parity: ``params_from_numpy`` carries a JAX-package LLaMA's
weights into paddle_tpu_torch, and the port's logits equal the JAX
model's on the same ids, in f32 on the CPU."""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

SMALL = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=64)


def jax_arrays(model):
    return {n: np.asarray(p._data) for n, p in model.named_parameters()}


@pytest.mark.parametrize("kv_heads,tied", [(4, False), (2, False),
                                           (2, True)],
                         ids=["mha", "gqa", "gqa_tied"])
def test_logits_match_jax(kv_heads, tied):
    kw = dict(SMALL, num_key_value_heads=kv_heads, tie_word_embeddings=tied)
    paddle.seed(3)
    jm = JaxLM(JaxConfig(**kw))
    tm = params_from_numpy(LlamaConfig(**kw), jax_arrays(jm), device="cpu")
    ids = np.random.default_rng(0).integers(0, 64, (2, 19)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids))._data)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    # f32 logits of a 2-layer model; observed differences are ~1e-7
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_params_from_numpy_transposes_linear_weights():
    kw = dict(SMALL, num_key_value_heads=2)
    paddle.seed(4)
    jm = JaxLM(JaxConfig(**kw))
    arrays = jax_arrays(jm)
    tm = params_from_numpy(LlamaConfig(**kw), arrays, device="cpu")
    q = tm.model.layers[0].self_attn.k_proj.weight.detach().numpy()
    np.testing.assert_array_equal(
        q, arrays["model.layers.0.self_attn.k_proj.weight"].T)
    emb = tm.model.embed_tokens.weight.detach().numpy()
    np.testing.assert_array_equal(emb, arrays["model.embed_tokens.weight"])
    with pytest.raises(KeyError):
        params_from_numpy(LlamaConfig(**kw),
                          dict(arrays, extra=np.zeros(1)), device="cpu")


def test_seeded_init_draws_normal_002_and_unit_norms():
    kw = dict(SMALL, num_key_value_heads=2)
    a = LlamaForCausalLM(LlamaConfig(**kw), device="cpu", seed=5)
    b = LlamaForCausalLM(LlamaConfig(**kw), device="cpu", seed=5)
    w = a.model.layers[1].mlp.up_proj.weight.detach()
    assert torch.equal(w, b.model.layers[1].mlp.up_proj.weight.detach())
    assert abs(float(w.std()) - 0.02) < 0.003
    assert torch.equal(a.model.norm.weight.detach(), torch.ones(32))


def test_cuda_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaForCausalLM(LlamaConfig(**SMALL))
