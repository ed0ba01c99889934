"""w8a8 serving quantizes each distinct activation once: the int8 twins of
q|k|v and gate|up are concatenated along the output axis and armed on
their module, so a layer runs 4 quantizer and 4 w8a8 calls instead of 7
and 7.  Held on a small GQA LLaMA on the CPU, in f32 and bf16: logits
and greedy streams bit-equal to the per-Linear path, the twins equal to
the JAX package's calibration, the prefill logits close to the JAX
quantized decoder's, and the calls counted per forward."""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.paged import JittedPagedDecoder
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.ops.pallas.paged_attention import PagedKVCache as JaxCache
from paddle_tpu.quantization import serving as jserving
from paddle_tpu_torch.inference import paged
from paddle_tpu_torch.inference.continuous import ContinuousBatchingEngine
from paddle_tpu_torch.inference.paged import PagedDecoder
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaAttention, LlamaConfig, \
    LlamaMLP
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import quant_matmul as qm
from paddle_tpu_torch.ops.paged_attention import PagedKVCache
from paddle_tpu_torch.quantization import serving

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
LAYERS = TINY["num_hidden_layers"]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(5)
    return JaxLM(JaxConfig(**TINY))


def _port(jm, dtype):
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu",
                             dtype=dtype)


@pytest.fixture
def per_linear(monkeypatch):
    """Make every PagedDecoder built inside the test arm one twin per
    Linear (the path before fusion)."""
    real = serving.quantize_linear_weights

    def unfused(model, fuse=False):
        return real(model, fuse=False)

    def use():
        monkeypatch.setattr(paged, "quantize_linear_weights", unfused)
    return use


def _ids(n, seed=3):
    return np.random.default_rng(seed).integers(0, 64, (1, n)).astype(
        np.int32)


def test_fused_twins_concatenate_the_per_linear_twins(jax_model):
    tm = _port(jax_model, None)
    sep = {id(layer): (w, s) for layer, w, s in
           serving.quantize_linear_weights(tm)}
    fused = serving.quantize_linear_weights(tm, fuse=True)
    # per layer: q|k|v, gate|up, o and down; and the untied head
    assert len(fused) == 4 * LAYERS + 1
    modules = [m for m, _, _ in fused
               if isinstance(m, (LlamaAttention, LlamaMLP))]
    assert len(modules) == 2 * LAYERS
    for module, w_q, scale in fused:
        names = getattr(module, "quant_fused", None)
        if names is None:
            assert torch.equal(w_q, sep[id(module)][0])
            continue
        parts = [sep[id(getattr(module, n))] for n in names]
        assert torch.equal(w_q, torch.cat([p[0] for p in parts]))
        assert torch.equal(scale, torch.cat([p[1] for p in parts]))
        assert w_q.is_contiguous() and w_q.dtype == torch.int8
    # GQA: q|k|v is (heads + 2 kv heads) x head_dim rows
    attn = tm.model.layers[0].self_attn
    (w_qkv,) = [w for m, w, _ in fused if m is attn]
    assert w_qkv.shape == ((4 + 2 * 2) * 8, 32)
    # the JAX package's calibration of the same Linears, row for row
    jtwins = jserving.quantize_linear_weights(jax_model)
    jq = {n: np.asarray(w).T for n, (_, w, _) in zip(
        [n for n, _ in serving.iter_quant_linears(tm)], jtwins)}
    np.testing.assert_array_equal(
        w_qkv.numpy(), np.concatenate([jq[f"model.layers.0.self_attn.{p}"]
                                       for p in ("q_proj", "k_proj",
                                                 "v_proj")]))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("kv", [None, "int8"], ids=["bf16kv", "int8kv"])
def test_fused_prefill_logits_bit_equal_to_per_linear(jax_model, per_linear,
                                                      dt, kv):
    tm = _port(jax_model, DTYPES[dt])
    ids = _ids(13)
    outs = []
    for fuse in (True, False):
        if not fuse:
            per_linear()
        cache = PagedKVCache.from_model(tm, total_pages=8, page_size=8,
                                        kv_dtype=kv)
        dec = PagedDecoder(tm, quantize="w8a8")
        outs.append(dec.prefill(cache, [0], ids))
        outs.append(dec.chunk_prefill(cache, [0], _ids(5, 4),
                                      context_tokens=13))
    np.testing.assert_array_equal(outs[0], outs[2])
    np.testing.assert_array_equal(outs[1], outs[3])
    # disarmed after the steps, modules and Linears alike
    assert all(m._serving_quant is None for m in tm.modules()
               if hasattr(m, "_serving_quant"))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("chunk", [None, 8], ids=["unchunked", "chunked"])
def test_fused_greedy_streams_equal_per_linear(jax_model, per_linear, dt,
                                               chunk):
    tm = _port(jax_model, DTYPES[dt])
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 64, (n,)).astype(np.int32)
               for n in (5, 12, 20)]
    streams = []
    for fuse in (True, False):
        if not fuse:
            per_linear()
        with ContinuousBatchingEngine(tm, total_pages=64, page_size=8,
                                      max_batch=4, quantize="w8a8",
                                      kv_quant="int8",
                                      prefill_chunk_tokens=chunk,
                                      device="cpu") as eng:
            reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            streams.append([r.result(timeout=300).tolist() for r in reqs])
    assert streams[0] == streams[1]


def test_fused_logits_match_jax_quantized_decoder(jax_model):
    ids = _ids(13, seed=7)
    jc = JaxCache.from_model(jax_model, total_pages=8, page_size=8,
                             kv_dtype="int8")
    want = JittedPagedDecoder(jax_model, quantize="w8a8").prefill(jc, [0],
                                                                  ids)
    tm = _port(jax_model, None)
    tc = PagedKVCache.from_model(tm, total_pages=8, page_size=8,
                                 kv_dtype="int8")
    got = PagedDecoder(tm, quantize="w8a8").prefill(tc, [0], ids)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5


@pytest.mark.parametrize("quantize,kv,quantizer,matmuls", [
    ("w8a8", None, 4 * LAYERS + 1, 4 * LAYERS + 1),
    ("w8a8", "int8", 4 * LAYERS + 1 + 2 * LAYERS, 4 * LAYERS + 1),
    ("w8", "int8", 2 * LAYERS, 7 * LAYERS + 1)])
def test_quantized_calls_per_forward(jax_model, monkeypatch, quantize, kv,
                                     quantizer, matmuls):
    """One prefill is one forward: w8a8 quantizes 4 activations a layer
    and the head's, int8 KV adds K and V; w8 keeps a call per Linear."""
    tm = _port(jax_model, None)
    calls = {"quant": 0, "mm": 0}
    real_q, real_w8a8 = qm.dynamic_act_quant, qm.w8a8_matmul_plain
    real_w8 = qm.weight_only_matmul_plain

    def quant(x):
        calls["quant"] += 1
        return real_q(x)

    def count(real):
        def fn(*args):
            calls["mm"] += 1
            return real(*args)
        return fn

    monkeypatch.setattr(qm, "dynamic_act_quant", quant)
    monkeypatch.setattr(pa, "dynamic_act_quant", quant)
    monkeypatch.setattr(qm, "w8a8_matmul_plain", count(real_w8a8))
    monkeypatch.setattr(qm, "weight_only_matmul_plain", count(real_w8))
    cache = PagedKVCache.from_model(tm, total_pages=8, page_size=8,
                                    kv_dtype=kv)
    dec = PagedDecoder(tm, quantize=quantize)
    calls.update(quant=0, mm=0)
    dec.prefill(cache, [0], _ids(11))
    assert calls == {"quant": quantizer, "mm": matmuls}


def test_training_forward_never_sees_a_fused_twin(jax_model):
    """Outside a serving step the modules run their Linears: the forward
    and its gradients are those of the unquantized model."""
    tm = _port(jax_model, None)
    PagedDecoder(tm, quantize="w8a8")
    ids = torch.from_numpy(_ids(9).astype(np.int64))
    loss, _ = tm(ids, labels=ids)
    loss.backward()
    assert tm.model.layers[0].self_attn.q_proj.weight.grad is not None
    assert all(m._serving_quant is None for m in tm.modules()
               if hasattr(m, "_serving_quant"))


# (rows, K, dtype, aligned) -> (kernel, grid, threads, lanes or threads)
# on a 132-SM card: the plan is shapes alone, so the CPU holds it
ACT_PLANS = [
    ((8, 4096, torch.bfloat16, True), ("act_quant_row_kernel", 8, 256, 256)),
    ((1024, 11008, torch.bfloat16, True),
     ("act_quant_row_kernel", 1024, 352, 352)),
    ((8, 4096, torch.float32, True), ("act_quant_row_kernel", 8, 256, 256)),
    ((1, 32768, torch.bfloat16, True),
     ("act_quant_row_kernel", 1, 1024, 1024)),
    ((256, 128, torch.bfloat16, True),
     ("act_quant_group_kernel", 32, 128, 16)),
    ((32768, 128, torch.bfloat16, True),
     ("act_quant_group_kernel", 2048, 128, 8)),
    ((77, 300, torch.float32, True), ("act_quant_group_kernel", 20, 128, 32)),
    ((3, 8, torch.float32, True), ("act_quant_group_kernel", 1, 128, 2)),
    ((1024, 4096, torch.bfloat16, False),
     ("act_quant_edge_kernel", 1024, 256, 0)),
    ((77, 300, torch.bfloat16, True), ("act_quant_edge_kernel", 77, 256, 0)),
    ((1, 65536, torch.bfloat16, True), ("act_quant_edge_kernel", 1, 256, 0))]


@pytest.mark.parametrize("args,want", ACT_PLANS,
                         ids=[f"{a[0]}x{a[1]}-{str(a[2])[6:]}-"
                              f"{'aligned' if a[3] else 'misaligned'}"
                              for a, _ in ACT_PLANS])
def test_act_quant_plan_by_row_shape(args, want):
    assert qm.act_quant_plan(*args, sms=132) == want


def test_row_layout_reads_a_fused_v_slice_in_place():
    """The v slice of a fused q|k|v output, (b * s, kv heads, d), is
    addressed by two strides; a contiguous tensor by one; rows that need
    three strides take a copy."""
    qkv = torch.zeros(2, 9, (4 + 2 * 2) * 8)
    v = qkv[..., 6 * 8:].view(18, 2, 8)
    assert qm._row_layout(v) == (2, 64, 8)
    assert qm._row_layout(torch.zeros(3, 5, 7)) == (1, 7, 0)
    assert qm._row_layout(torch.zeros(7)) == (1, 7, 0)
    x = torch.zeros(4, 3, 5, 8)
    assert qm._row_layout(x[:, :, 1:]) == (4, 40, 8)
    assert qm._row_layout(x[:, 1:, 1:]) is None
