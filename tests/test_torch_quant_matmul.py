"""Port parity: the int8 quantization rules and quantized matmuls of
paddle_tpu_torch against the JAX package — the Pallas kernels in
interpret mode, the ``*_xla`` oracles, ``jax.grad`` of the custom_vjp,
and the serving calibration on the same weights."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.ops.pallas import quant_matmul as jqm
from paddle_tpu.quantization import serving as jserving
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops import quant_matmul as tqm
from paddle_tpu_torch.quantization import serving as tserving

SHAPES = [(m, k, n) for m in (1, 5, 130) for k in (64, 300)
          for n in (96, 200)]


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)     # JAX [K, N]
    s = rng.uniform(0.005, 0.05, n).astype(np.float32)
    return x, w, s


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_dynamic_act_quant_bit_equal_with_zero_row():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 77)).astype(np.float32) * 3
    x[2] = 0.0
    x[4, 5] = 127.5 / 127 * np.abs(x[4]).max()     # a rounding tie
    jq, js = jqm.dynamic_act_quant(jnp.asarray(x))
    tq, ts = tqm.dynamic_act_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert int(tq[2].abs().max()) == 0 and float(ts[2, 0]) > 0


def test_quantize_kv_bit_equal():
    x = np.random.default_rng(2).standard_normal((2, 9, 3, 16)).astype(
        np.float32)
    jq, js = jpa.quantize_kv(jnp.asarray(x))
    tq, ts = tpa.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tpa.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jpa.dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_weight_only_f32_matches_pallas_and_xla(m, k, n):
    x, w, s = _inputs(m, k, n)
    got = tqm.weight_only_matmul(torch.from_numpy(x),
                                 torch.from_numpy(np.ascontiguousarray(w.T)),
                                 torch.from_numpy(s)).numpy()
    jx, jw, js = jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)
    for want in (jqm.weight_only_matmul_pallas(jx, jw, js, interpret=True),
                 jqm.weight_only_matmul_xla(jx, jw, js)):
        # f32 sums of K products in another order: 1e-5 of each value,
        # and of the largest where a sum cancels
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_weight_only_bf16_matches_pallas_and_xla(m, k, n):
    x, w, s = _inputs(m, k, n, seed=3)
    got = tqm.weight_only_matmul(
        torch.from_numpy(x).bfloat16(),
        torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    jx, jw, js = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(s)
    for want in (jqm.weight_only_matmul_pallas(jx, jw, js, interpret=True),
                 jqm.weight_only_matmul_xla(jx, jw, js)):
        assert _rel_l2(got.float().numpy(),
                       np.asarray(want, np.float32)) <= 1e-2


def test_weight_only_grad_matches_jax():
    x, w, s = _inputs(5, 64, 96, seed=4)
    dy = np.random.default_rng(5).standard_normal((5, 96)).astype(np.float32)

    def loss(xx, ss):
        return jnp.sum(jqm.weight_only_matmul(xx, jnp.asarray(w), ss)
                       * jnp.asarray(dy))

    jdx, jds = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    out = tqm.weight_only_matmul(tx, torch.from_numpy(np.ascontiguousarray(
        w.T)), ts)
    (out * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(1, 64, 96), (7, 33, 17), (130, 300, 200)])
def test_w8a8_bit_equal_to_xla_and_pallas(m, k, n):
    x, w, s = _inputs(m, k, n, seed=6)
    got = tqm.w8a8_matmul(torch.from_numpy(x),
                          torch.from_numpy(np.ascontiguousarray(w.T)),
                          torch.from_numpy(s)).numpy()
    jq, jxs = jqm.dynamic_act_quant(jnp.asarray(x))
    want = jqm.w8a8_matmul_xla(jq, jxs, jnp.asarray(w), jnp.asarray(s),
                               jnp.float32)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(jqm.w8a8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s))))
    pallas = jqm.w8a8_matmul_pallas(jq, jxs, jnp.asarray(w), jnp.asarray(s),
                                    jnp.float32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-6, atol=0)


def test_quantize_linear_weights_bit_equal_to_jax():
    cfg = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, max_position_embeddings=64)
    paddle.seed(3)
    jm = JaxLM(JaxConfig(**cfg))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = params_from_numpy(LlamaConfig(**cfg), arrays, device="cpu")
    want = jserving.quantize_linear_weights(jm)
    got = tserving.quantize_linear_weights(tm)
    # 7 projections per layer and the untied head
    assert len(got) == len(want) == 7 * 2 + 1
    jnames = {id(layer): name for name, layer in jm.named_sublayers()}
    tnames = {id(layer): name for name, layer in tm.named_modules()}
    assert [tnames[id(l)] for l, _, _ in got] \
        == [jnames[id(l)] for l, _, _ in want]
    for (_, tq, ts), (_, jq, js) in zip(got, want):
        assert tq.dtype == torch.int8 and tq.is_contiguous()
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the model's own weights are untouched
    assert tm.lm_head.weight.dtype == torch.float32
    assert tm.lm_head._serving_quant is None
    assert tserving.SERVING_QUANT_MODES == jserving.SERVING_QUANT_MODES


def test_cpu_dispatch_counts_no_launch_and_cuda_wrappers_refuse_cpu():
    x, w, s = _inputs(3, 64, 96)
    tx, tw, ts = (torch.from_numpy(x),
                  torch.from_numpy(np.ascontiguousarray(w.T)),
                  torch.from_numpy(s))
    kernels = (tqm.weight_only_matmul_cuda, tqm.w8a8_matmul_cuda,
               tqm.dynamic_act_quant_cuda)
    before = [k.launches for k in kernels]
    tqm.weight_only_matmul(tx, tw, ts)
    tqm.w8a8_matmul(tx, tw, ts)
    assert [k.launches for k in kernels] == before
    with pytest.raises(ValueError, match="CUDA"):
        tqm.weight_only_matmul_cuda(tx, tw, ts)
    xq, xs = tqm.dynamic_act_quant(tx)
    with pytest.raises(ValueError, match="CUDA"):
        tqm.w8a8_matmul_cuda(xq, xs, tw, ts, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tqm.dynamic_act_quant_cuda(tx)


def test_quant_linear_forward_keeps_leading_dims():
    from paddle_tpu_torch.nn import Linear
    layer = Linear(64, 96, bias=True, device="cpu")
    torch.nn.init.normal_(layer.weight)
    torch.nn.init.normal_(layer.bias)
    (_, w_q, scale), = tserving.quantize_linear_weights(layer)
    x = torch.randn(2, 3, 64)
    for mode, fn in (("w8", tqm.weight_only_matmul),
                     ("w8a8", tqm.w8a8_matmul)):
        layer._serving_quant = (mode, w_q, scale)
        got = layer(x)
        layer._serving_quant = None
        want = fn(x.reshape(6, 64), w_q, scale).reshape(2, 3, 96) + layer.bias
        assert torch.equal(got, want)
    assert torch.equal(layer(x), torch.nn.functional.linear(
        x, layer.weight, layer.bias))
