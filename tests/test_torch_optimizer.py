"""Port parity: the eager optimizer step (``loss.backward(); opt.step()``)
against the JAX package's on the same tiny LLaMA, weights and batch, on
the CPU (f32).

Gradient clipping hands the update new, scaled gradients and leaves
``p.grad`` as backward wrote it, as the JAX package's
``ClipGradByGlobalNorm`` returns new pairs.  AdamW's
``apply_decay_param_fun`` sees each parameter's ``name`` (``''`` for the
LLaMA's parameters, as JAX passes ``p.name``), not the state-dict key
``param_<i>``.  After two steps every parameter tensor is held within
relative L2 1e-4 of JAX's (the frameworks' gradients sum in different
orders; see test_torch_train.py)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as joptim
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.models.convert import (params_from_numpy,
                                             params_to_numpy)
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.nn import functional as TF

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
STEPS = 2


def _models():
    paddle.seed(3)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


def _batch(step):
    rng = np.random.default_rng(10 + step)
    return (rng.integers(0, 128, (2, 16)).astype(np.int32),
            rng.integers(0, 128, (2, 16)).astype(np.int32))


def _jax_backward(jm, step):
    ids, labels = _batch(step)
    logits = jm(paddle.to_tensor(ids))
    JF.cross_entropy(logits.reshape([-1, 128]).astype("float32"),
                     paddle.to_tensor(labels).reshape([-1])).backward()


def _port_backward(tm, step):
    ids, labels = (torch.from_numpy(a).long() for a in _batch(step))
    TF.cross_entropy(tm(ids).reshape(-1, 128).float(),
                     labels.reshape(-1)).backward()


def _params_close(jm, tm, limit=1e-4):
    want = {n: np.asarray(p._data, np.float32)
            for n, p in jm.named_parameters()}
    got = params_to_numpy(tm)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        rel = np.linalg.norm(got[name] - w) / np.linalg.norm(w)
        assert rel <= limit, f"{name}: relative L2 {rel:.3e} > {limit}"


def _steps(make):
    """STEPS eager steps on both sides; returns the models and the
    port's gradients as backward left them and as they were after
    ``step()`` (of the last step)."""
    jm, tm = _models()
    jopt = make(joptim, jnn, jm.parameters())
    topt = make(toptim, tnn, tm.parameters())
    for step in range(STEPS):
        _jax_backward(jm, step)
        jopt.step()
        jopt.clear_grad()
        _port_backward(tm, step)
        before = [p.grad.clone() for p in tm.parameters()]
        topt.step()
        after = [p.grad for p in tm.parameters()]
        topt.clear_grad()
    return jm, tm, before, after


def test_clip_leaves_grads_and_follows_jax():
    """ClipGradByGlobalNorm(0.01) scales every gradient here (the global
    norm is far above 0.01), yet ``p.grad`` comes out of ``step()``
    bit for bit as backward wrote it, and the clipped update is JAX's."""
    def make(mod, nn, params):
        return mod.AdamW(learning_rate=1e-2, parameters=params,
                         grad_clip=nn.ClipGradByGlobalNorm(0.01))
    jm, tm, before, after = _steps(make)
    for b, a in zip(before, after):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _params_close(jm, tm)


def test_clip_returns_new_pairs():
    p = torch.nn.Parameter(torch.ones(3))
    frozen = torch.nn.Parameter(torch.ones(2))
    frozen.need_clip = False
    g, gf = torch.full((3,), 4.0), torch.full((2,), 5.0)
    out = tnn.ClipGradByGlobalNorm(1.0)([(p, g), (frozen, gf), (p, None)])
    assert out[0][0] is p and out[1] == (frozen, gf) and out[2] == (p, None)
    torch.testing.assert_close(out[0][1], torch.full((3,), 1 / 3 ** 0.5))
    torch.testing.assert_close(g, torch.full((3,), 4.0), rtol=0, atol=0)


@pytest.mark.parametrize("keep", ["all", "none", "by_name"])
def test_decay_names_match_jax(keep):
    """``apply_decay_param_fun`` is called with the same names on both
    sides (``''`` for every LLaMA parameter), and the decayed updates
    agree."""
    seen = {"jax": [], "port": []}

    def rule(side):
        def fun(name):
            seen[side].append(name)
            if keep == "by_name":   # a name-based rule, as users write it
                return "norm" not in name and "bias" not in name
            return keep == "all"
        return fun

    def make(mod, nn, params):
        side = "jax" if mod is joptim else "port"
        return mod.AdamW(learning_rate=1e-2, weight_decay=0.5,
                         parameters=params, apply_decay_param_fun=rule(side))
    jm, tm, _before, _after = _steps(make)
    assert set(seen["port"]) == set(seen["jax"]) == {""}
    assert len(seen["port"]) >= len(list(tm.parameters()))
    _params_close(jm, tm)
