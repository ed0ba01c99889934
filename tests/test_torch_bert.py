"""Port parity of BERT (``paddle_tpu_torch/models/bert.py``, the encoder
of ``nn/layer/transformer.py``, ``LayerNorm``, ``Dropout``, ``gelu``,
``tanh``, ``CrossEntropyLoss``) against the JAX package's on the CPU.

- A tiny BERT with dropout 0 and the same weights (the bridge,
  ``models.convert.bert_params_from_numpy``): sequence-classification
  logits, loss and every parameter's gradient, without a mask (the flash
  path's plain versions) and with an ``attention_mask`` (the masked
  softmax), within 1e-5 absolute of JAX's (f32, logits of order 0.1;
  observed ~1e-8) and gradients within 1e-4 of their largest entry (at
  least 1e-8: the key biases' gradients are 0 up to rounding); the
  masked-LM head likewise.
- The bridge: ``bert_params_to_numpy`` gives back the arrays given.
- Under ``auto_cast`` O1 and O2 each op name the JAX package dispatches
  gives the types the JAX op gives (``cast`` and ``reshape`` not
  compared, as in ``tests/test_torch_amp.py``).
- Dropout: eval and p = 0 are the identity, training scales kept entries
  by 1 / (1 - p), and the mask follows the module's generator.
- The card's embedding backward (``sorted_row_sums``), run here on the
  CPU: correctly rounded sums, the same bits every call.
"""
import collections

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.framework import dispatch as jdispatch
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import BertForMaskedLM as JaxMLM
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JaxBert
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models.convert import (bert_params_from_numpy,
                                             bert_params_to_numpy)
from paddle_tpu_torch.nn import functional as tfunctional
from paddle_tpu_torch.nn.layer import common as tcommon
from paddle_tpu_torch.nn.layer import transformer as ttransformer

TINY = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=128,
            max_position_embeddings=32, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
RNG = np.random.default_rng(0)
IDS = RNG.integers(0, 100, (2, 16)).astype(np.int32)
TYPES = RNG.integers(0, 2, (2, 16)).astype(np.int32)
MASK = np.ones((2, 16), np.int32)
MASK[1, 10:] = 0
LABELS = np.array([0, 1], np.int64)
SKIP = {"cast", "reshape"}


def _pair(jcls=JaxBert, **over):
    paddle.seed(0)
    jm = jcls(JaxBertConfig(**dict(TINY, **over)))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = bert_params_from_numpy(tbert.BertConfig(**dict(TINY, **over)),
                                arrays, device="cpu")
    return jm, tm, arrays


def _linear_names(tm):
    return {f"{n}.weight" for n, m in tm.named_modules()
            if isinstance(m, tnn.Linear)}


@pytest.mark.parametrize("masked", [False, True], ids=["flash", "mask"])
@pytest.mark.parametrize("head", ["seq_cls", "mlm"])
def test_logits_loss_and_grads_match_jax(masked, head):
    jcls = JaxBert if head == "seq_cls" else JaxMLM
    jm, tm, _ = _pair(jcls)
    labels = LABELS if head == "seq_cls" else \
        np.where(RNG.random((2, 16)) < 0.3, IDS, -100).astype(np.int64)
    jkw = dict(token_type_ids=paddle.to_tensor(TYPES),
               labels=paddle.to_tensor(labels))
    tkw = dict(token_type_ids=torch.from_numpy(TYPES),
               labels=torch.from_numpy(labels))
    if masked:
        jkw["attention_mask"] = paddle.to_tensor(MASK)
        tkw["attention_mask"] = torch.from_numpy(MASK)
    jloss, jlogits = jm(paddle.to_tensor(IDS), **jkw)
    jloss.backward()
    tloss, tlogits = tm(torch.from_numpy(IDS), **tkw)
    tloss.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(),
                               np.asarray(jlogits._data), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tloss.detach()),
                               float(np.asarray(jloss._data)),
                               rtol=1e-5)
    linear = _linear_names(tm)
    tgrads = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        if p.grad is None:            # the MLM head leaves the pooler out
            assert tgrads[n].grad is None, n
            continue
        want = np.asarray(p.grad._data)
        got = tgrads[n].grad.numpy()
        got = got.T if n in linear else got
        # a floor of 1e-8: the key biases' gradients are 0 up to rounding
        # (a key bias shifts all of a query's scores by one constant)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=max(1e-4 * np.abs(want).max(), 1e-8),
                                   err_msg=n)


def test_bridge_round_trip_and_names():
    _, tm, arrays = _pair()
    back = bert_params_to_numpy(tm)
    assert back.keys() == arrays.keys()
    for n, a in arrays.items():
        np.testing.assert_array_equal(back[n], a)
    with pytest.raises(KeyError):
        bert_params_from_numpy(tbert.BertConfig(**TINY),
                               dict(arrays, extra=np.zeros(1)),
                               device="cpu")


def _jax_types(jm, level, masked):
    rec = collections.defaultdict(set)

    def hook(name, res):
        for leaf in jax.tree_util.tree_leaves(
                res, is_leaf=lambda x: hasattr(x, "_data")):
            rec[name].add(str(leaf.dtype))

    jdispatch.add_post_op_hook(hook)
    try:
        with jamp.auto_cast(level=level, dtype="bfloat16"):
            jm(paddle.to_tensor(IDS), attention_mask=paddle.to_tensor(MASK)
               if masked else None, labels=paddle.to_tensor(LABELS))
    finally:
        jdispatch.remove_post_op_hook(hook)
    return {k: v for k, v in rec.items() if k not in SKIP}


def _port_types(tm, level, masked, monkeypatch):
    """The port's op outputs under the JAX op names."""
    rec = collections.defaultdict(set)

    def put(name, *outs):
        for o in outs:
            rec[name].add(str(o.dtype).replace("torch.", ""))

    def wrap(module, attr, *names):
        fn = getattr(module, attr)

        def recorded(*a, **kw):
            out = fn(*a, **kw)
            put_all = out if isinstance(out, tuple) else (out,)
            for name in names:
                put(name, *put_all)
            return out
        monkeypatch.setattr(module, attr, recorded)

    wrap(ttransformer, "add", "add")
    wrap(tbert, "add", "add")
    wrap(tbert, "_additive_mask", "rsub", "multiply")
    wrap(tbert, "_first_token", "getitem")
    wrap(tfunctional, "scaled_dot_product_attention", "sdpa")
    wrap(tfunctional, "gelu", "gelu")
    wrap(tfunctional, "cross_entropy", "cross_entropy_f")
    by_type = {tnn.Embedding: "embedding_", tnn.LayerNorm: "layer_norm_f",
               tnn.Linear: "linear", tnn.Dropout: "dropout_",
               tnn.Tanh: "tanh"}
    hooks = []
    for m in tm.modules():
        for cls, op in by_type.items():
            if isinstance(m, cls):
                hooks.append(m.register_forward_hook(
                    lambda _m, _i, out, op=op: put(op, out)))
    hooks.append(tm.bert.embeddings.register_forward_pre_hook(
        lambda _m, inp: put("zeros_like", inp[0])))
    try:
        with amp.auto_cast(level=level, dtype="bfloat16"):
            tm(torch.from_numpy(IDS), attention_mask=torch.from_numpy(MASK)
               if masked else None, labels=torch.from_numpy(LABELS))
    finally:
        for h in hooks:
            h.remove()
    return dict(rec)


@pytest.mark.parametrize("masked", [False, True], ids=["flash", "mask"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_op_output_types_follow_jax(level, masked, monkeypatch):
    jm, tm, _ = _pair(hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.1)
    tm.train()
    want = _jax_types(jm, level, masked)
    got = _port_types(tm, level, masked, monkeypatch)
    assert got == want


def test_dropout_modes_and_generator():
    x = torch.ones(4, 1000)
    d = tnn.Dropout(0.25, generator=torch.Generator().manual_seed(3))
    d.eval()
    assert torch.equal(d(x), x)
    d.train()
    y = d(x)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert 0.7 < kept.float().mean() < 0.8
    d.generator.manual_seed(3)
    assert torch.equal(d(x), y)
    assert torch.equal(tnn.Dropout(0.0)(x), x)
    down = tnn.Dropout(0.25, mode="downscale_in_infer")
    down.eval()
    assert torch.allclose(down(x), x * 0.75)
    rows = tnn.Dropout(0.5, axis=0,
                       generator=torch.Generator().manual_seed(0))(x)
    assert all(len(set(r.tolist())) == 1 for r in rows)


def test_layer_norm_and_activations_match_jax():
    import paddle_tpu.nn as jnn
    import paddle_tpu.nn.functional as JF
    x = RNG.standard_normal((3, 5, 8)).astype(np.float32)
    w = RNG.standard_normal(8).astype(np.float32)
    b = RNG.standard_normal(8).astype(np.float32)
    jln = jnn.LayerNorm(8, epsilon=1e-6)
    jln.weight._data = jax.numpy.asarray(w)
    jln.bias._data = jax.numpy.asarray(b)
    tln = tnn.LayerNorm(8, epsilon=1e-6)
    with torch.no_grad():
        tln.weight.copy_(torch.from_numpy(w))
        tln.bias.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(tln(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jln(paddle.to_tensor(x))._data),
                               rtol=0, atol=1e-5)
    for tf, jf in ((tfunctional.gelu, JF.gelu), (tfunctional.tanh, JF.tanh)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                                   np.asarray(jf(paddle.to_tensor(x))._data),
                                   rtol=0, atol=1e-6)
    logits = RNG.standard_normal((6, 4)).astype(np.float32)
    lab = np.array([0, 3, -100, 1, 2, 2], np.int64)
    got = tnn.CrossEntropyLoss()(torch.from_numpy(logits),
                                 torch.from_numpy(lab))
    want = jnn.CrossEntropyLoss()(paddle.to_tensor(logits),
                                  paddle.to_tensor(lab))
    np.testing.assert_allclose(float(got), float(np.asarray(want._data)),
                               rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tnn.CrossEntropyLoss(soft_label=True)


@pytest.mark.parametrize("rows,shape,same", [
    (2, (32, 128), True), (1000, (32, 128), False), (7, (5,), False),
    (50, (0,), False)], ids=["token_types", "words", "few", "empty"])
def test_sorted_row_sums_is_the_embedding_gradient(rows, shape, same):
    """The card's embedding backward (``sorted_row_sums``) on the CPU: each
    row within half an f32 ulp of the f64 sum of its tokens' gradients
    (the f64 prefix sums round once), within 1e-4 of torch's own
    backward (which sums up to 4096 tokens of a row in f32), and the
    same bits on every call."""
    gen = torch.Generator().manual_seed(1)
    ids = torch.zeros(shape, dtype=torch.long) if same else \
        torch.randint(0, rows, shape, generator=gen)
    grad = torch.randn(*shape, 16, generator=gen)
    got = tcommon.sorted_row_sums(ids, grad, rows)
    exact = torch.zeros(rows, 16, dtype=torch.float64).index_add_(
        0, ids.reshape(-1), grad.reshape(-1, 16).double())
    ulp = torch.finfo(torch.float32).eps * exact.abs().clamp_min(1e-30)
    assert ((got.double() - exact).abs() <= ulp).all()
    w = torch.zeros(rows, 16, requires_grad=True)
    torch.nn.functional.embedding(ids, w).backward(grad)
    # torch's own backward sums 4096 tokens of a row in f32
    torch.testing.assert_close(got, w.grad, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, tcommon.sorted_row_sums(ids, grad, rows))
