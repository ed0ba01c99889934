"""Port parity of the chunked fused linear + cross entropy
(``paddle_tpu_torch/nn/functional/fused_loss.py`` and
``incubate.nn.functional.fused_linear_cross_entropy``) against the JAX
package's custom VJP on the same inputs, on the CPU; and a tiny LLaMA
trained through the fused loss (bench.py's ``_HiddenLM`` route) by both
packages' ``TrainStep``.

The port takes the weight as its ``Linear`` stores it, [vocab, hidden];
the JAX function takes [hidden, vocab], so every case passes the
transpose of one array to the port.  Tolerances: f32 loss within
relative 1e-6 (the two sum the chunks' rows in other orders), gradients
within relative 1e-5 of their largest entry; bf16 operands give an f32
loss within 1e-5 (bf16 products are exact in f32, so only the summation
order differs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as joptim
from paddle_tpu.incubate.nn.functional import \
    fused_linear_cross_entropy as jax_fused_ce
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.nn.functional.fused_loss import \
    fused_linear_cross_entropy_raw as jax_raw
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.incubate.nn.functional import \
    fused_linear_cross_entropy
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.nn.functional.fused_loss import \
    fused_linear_cross_entropy_raw

H, V = 24, 40


def _inputs(n, seed=0, ignore=0.0, bias=False, lead=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if lead is None else lead
    h = rng.standard_normal(shape + (H,)).astype(np.float32)
    w = (0.3 * rng.standard_normal((H, V))).astype(np.float32)
    lab = rng.integers(0, V, shape).astype(np.int64)
    lab[rng.random(shape) < ignore] = -100
    b = (0.1 * rng.standard_normal(V)).astype(np.float32) if bias else None
    return h, w, lab, b


def _jax(h, w, lab, b, chunk, dtype=jnp.float32):
    """Loss and (dh, dw, db) of the JAX function."""
    def f(h_, w_, b_):
        return jax_raw(h_, w_, jnp.asarray(lab), bias=b_,
                       ignore_index=-100, chunk_rows=chunk)
    args = (jnp.asarray(h, dtype), jnp.asarray(w, dtype),
            None if b is None else jnp.asarray(b, dtype))
    argnums = (0, 1) if b is None else (0, 1, 2)
    loss, grads = jax.value_and_grad(f, argnums=argnums)(*args)
    grads = [np.asarray(g.astype(jnp.float32)) for g in grads]
    return float(loss), grads + [None] * (3 - len(grads)), str(loss.dtype)


def _port(h, w, lab, b, chunk, dtype=torch.float32):
    th = torch.tensor(h, dtype=dtype, requires_grad=True)
    # the port's layout: [vocab, hidden]
    tw = torch.tensor(w.T.copy(), dtype=dtype, requires_grad=True)
    tb = None if b is None else torch.tensor(b, dtype=dtype,
                                             requires_grad=True)
    loss = fused_linear_cross_entropy(th, tw, torch.from_numpy(lab),
                                      bias=tb, chunk_rows=chunk)
    loss.backward()
    grads = [th.grad.float().numpy(), tw.grad.float().numpy().T,
             None if tb is None else tb.grad.float().numpy()]
    return float(loss.detach()), grads, loss.dtype


def _grads_close(got, want, tol=1e-5):
    for name, g, r in zip(("dh", "dw", "db"), got, want):
        if r is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=tol * np.abs(r).max(), err_msg=name)


CASES = {
    # n, chunk, ignored share, bias, leading dims
    "even_chunks": (64, 16, 0.0, False, None),
    "ignore_and_bias": (64, 16, 0.3, True, None),
    "tail_chunk": (50, 16, 0.2, False, None),
    "one_chunk": (37, 1024, 0.0, True, None),
    "hidden_3d": (None, 8, 0.1, False, (3, 7)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax(case):
    n, chunk, ignore, bias, lead = CASES[case]
    h, w, lab, b = _inputs(n, seed=len(case), ignore=ignore, bias=bias,
                           lead=lead)
    want, want_g, _ = _jax(h, w, lab, b, chunk)
    got, got_g, dtype = _port(h, w, lab, b, chunk)
    assert dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    _grads_close(got_g, want_g)


def test_every_row_ignored_gives_zero():
    h, w, lab, b = _inputs(20, seed=3, bias=True)
    lab[:] = -100
    want, want_g, _ = _jax(h, w, lab, b, 8)
    got, got_g, _ = _port(h, w, lab, b, 8)
    assert got == 0.0 == want
    for g in got_g:
        assert np.isfinite(g).all() and not np.abs(g).any()
    _grads_close(got_g, want_g)


def test_bf16_inputs_give_f32_loss():
    h, w, lab, _ = _inputs(48, seed=4, ignore=0.1)
    want, want_g, jdtype = _jax(h, w, lab, None, 16, jnp.bfloat16)
    got, got_g, dtype = _port(h, w, lab, None, 16, torch.bfloat16)
    assert jdtype == "float32" and dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # dh and dw come back in bf16 from f32 products: one rounding each
    _grads_close(got_g, want_g, tol=1e-2)


def test_chunk_rows_larger_than_rows_and_raw_entry():
    """chunk_rows above N is cut to N (one chunk), as in JAX; the raw
    function and the incubate entry are one computation."""
    h, w, lab, _ = _inputs(10, seed=5)
    th, tw = torch.from_numpy(h), torch.from_numpy(w.T.copy())
    a = fused_linear_cross_entropy_raw(th, tw, torch.from_numpy(lab),
                                       chunk_rows=4096)
    b = fused_linear_cross_entropy(th, tw, torch.from_numpy(lab),
                                   chunk_rows=10)
    assert torch.equal(a, b)
    np.testing.assert_allclose(float(a), _jax(h, w, lab, None, 4096)[0],
                               rtol=1e-6)


# ----------------------------------------------- the _HiddenLM route
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)


class _JaxHiddenLM(jnn.Layer):
    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, input_ids):
        return self.lm.model(input_ids)


class _PortHiddenLM(torch.nn.Module):
    """bench.py's ``_HiddenLM``: the decoder's hidden states, the loss
    computes the head."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, input_ids):
        return self.lm.model(input_ids)


def test_hidden_lm_train_step_follows_jax():
    """Three AdamW steps on one batch of a tiny LLaMA whose loss is the
    fused route (chunk 24 rows of 64: a tail chunk): losses within
    relative 1e-5 of the JAX ``TrainStep``'s on the same weights, and
    falling."""
    paddle.seed(0)
    jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")

    def jloss(hidden, labels):
        return jax_fused_ce(hidden.reshape([-1, 64]), jm.lm_head.weight,
                            labels.reshape([-1]), chunk_rows=24)

    def tloss(hidden, labels):
        return fused_linear_cross_entropy(
            hidden.reshape(-1, 64), tm.lm_head.weight, labels.reshape(-1),
            chunk_rows=24)

    jstep = JaxTrainStep(_JaxHiddenLM(jm), jloss, joptim.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()))
    tstep = TrainStep(_PortHiddenLM(tm), tloss, toptim.AdamW(
        learning_rate=1e-3, parameters=tm.parameters()))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 128, (2, 32)).astype(np.int32)
    lab = rng.integers(0, 128, (2, 32)).astype(np.int32)
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(np.asarray(jstep(paddle.to_tensor(ids),
                                         paddle.to_tensor(lab))._data)))
        tl.append(float(tstep(torch.from_numpy(ids).long(),
                              torch.from_numpy(lab).long())))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
