"""Port parity of the Transformer encoder-decoder with its caches
(``paddle_tpu_torch/nn/layer/transformer.py``), ``gather_tree`` and
beam search (``paddle_tpu_torch/nn/decode.py``) against the JAX package
on the CPU, f32, weights and inputs from numpy seeds (the JAX model's
parameters are drawn anew from numpy after it is built: its layers are
deep copies of one layer, and a parity test of identical layers would
not see a layer mixed up with another).

- ``Transformer`` forward with the causal ``tgt_mask``: within relative
  L2 1e-5 of JAX's.
- Incremental decoding, one position a call with ``gen_cache``'s
  ``Cache`` / ``StaticCache``: each position within 1e-5 of the full
  masked forward's and of JAX's incremental output; the same for
  ``TransformerEncoder(cache=)`` against its causal forward.
- ``gather_tree`` equals JAX's on random parents.
- ``BeamSearchDecoder`` + ``dynamic_decode`` on an ``LSTMCell`` cell
  and on a Transformer-decoder cell (its caches carried as plain tuples
  on both sides: the JAX package's ``_tree_map`` rebuilds a namedtuple
  with ``type(tree)(generator)``, which raises, and the port keeps
  that): ids, parents and lengths equal, scores within 1e-5, for
  ``return_length`` and ``output_time_major`` both ways.  JAX's
  ``tile_beam_merge_with_batch`` cannot tile gen_cache's empty
  ``Cache``; the port's can, and the JAX side runs with the port's
  tiling (a repeat of rows).
- Ties: ``jax.lax.top_k`` puts the lower index first among equal
  values, ``torch.topk`` promises no order; the port's selection is a
  stable descending sort and equals JAX's on rows of deliberate ties.
- Two training steps (AdamW, the paper's beta2 0.98 and eps 1e-9) of a
  small seq2seq model through ``TrainStep`` against JAX's: the losses
  within relative 1e-5, every parameter within relative L2 1e-4 but the
  attention's key biases, whose gradient is 0 up to rounding (softmax
  ignores them) and which Adam moves by up to lr a step on either side:
  those within 2 lr a step.
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as joptim
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.nn import decode as jdecode
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.convert import _load, _to_numpy
from paddle_tpu_torch.nn import decode as tdecode
from paddle_tpu_torch.nn import functional as TF

D, HEADS, FF, LAYERS, V = 32, 2, 64, 2, 11
START, END = 1, 2


@contextlib.contextmanager
def numpy_init(seed):
    rng = np.random.default_rng(seed)

    def uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, shape), dtype)

    def normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape, np.float32), dtype)

    with mock.patch.object(jax.random, "uniform", uniform), \
            mock.patch.object(jax.random, "normal", normal):
        yield


def _redraw(jm, seed):
    """Every parameter of the JAX model drawn anew from numpy: weights
    N(0, 1 / fan_in), LayerNorm scales 1 + N(0, 0.1), biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    for name, p in jm.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("bias"):
            a = 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        p._data = jnp.asarray(a, jnp.float32)
    return {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _j(x):
    return paddle.to_tensor(x)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t._data)


@pytest.fixture(scope="module")
def pair():
    """The JAX ``Transformer`` and the port's on the same weights, in
    eval mode (dropout 0.1 is published; eval leaves it out)."""
    with numpy_init(0):
        jm = jnn.Transformer(D, HEADS, LAYERS, LAYERS, FF, dropout=0.1)
    arrays = _redraw(jm, 1)
    tm = _load(tnn.Transformer(D, HEADS, LAYERS, LAYERS, FF, dropout=0.1,
                               device="cpu", seed=None), arrays)
    jm.eval()
    tm.eval()
    return jm, tm


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_forward_with_causal_mask_matches_jax(pair):
    jm, tm = pair
    src, tgt = _inputs(2, (2, 7, D), (2, 5, D))
    jmask = jm.generate_square_subsequent_mask(5)
    tmask = tm.generate_square_subsequent_mask(5)
    np.testing.assert_array_equal(tmask.numpy(), _np(jmask))
    want = _np(jm(_j(src), _j(tgt), tgt_mask=jmask))
    with torch.no_grad():
        got = tm(torch.from_numpy(src), torch.from_numpy(tgt),
                 tgt_mask=tmask).numpy()
    assert got.shape == (2, 5, D)
    assert _rel(got, want) <= 1e-5


def _incremental(dec, memory, tgt, wrap):
    """The decoder run one position a call over ``gen_cache(memory)``."""
    cache = dec.gen_cache(memory)
    outs = []
    for t in range(tgt.shape[1]):
        out, cache = dec(wrap(tgt[:, t:t + 1]), memory, cache=cache)
        outs.append(_np(out))
    return np.concatenate(outs, 1), cache


def test_incremental_decoding_matches_full_forward_and_jax(pair):
    jm, tm = pair
    src, tgt = _inputs(3, (2, 6, D), (2, 4, D))
    with torch.no_grad():
        tmem = tm.encoder(torch.from_numpy(src))
        full = tm.decoder(torch.from_numpy(tgt), tmem,
                          tm.generate_square_subsequent_mask(4)).numpy()
        got, cache = _incremental(tm.decoder, tmem, tgt, torch.from_numpy)
    jmem = jm.encoder(_j(src))
    want, jcache = _incremental(jm.decoder, jmem, tgt, _j)
    for t in range(4):
        assert _rel(got[:, t], full[:, t]) <= 1e-5, t
        assert _rel(got[:, t], want[:, t]) <= 1e-5, t
    incr, static = cache[0]
    assert isinstance(incr, tnn.MultiHeadAttention.Cache)
    assert isinstance(static, tnn.MultiHeadAttention.StaticCache)
    assert incr.k.shape == (2, 4, HEADS, D // HEADS)
    assert static.k.shape == (2, 6, HEADS, D // HEADS)
    assert _rel(incr.v.numpy(), _np(jcache[0][0].v)) <= 1e-5


def test_encoder_cache_matches_causal_forward_and_jax(pair):
    jm, tm = pair
    (src,) = _inputs(4, (2, 5, D))
    mask = tm.generate_square_subsequent_mask(5)
    with torch.no_grad():
        full = tm.encoder(torch.from_numpy(src), mask).numpy()
        cache = tm.encoder.gen_cache(torch.from_numpy(src))
        got = []
        for t in range(5):
            out, cache = tm.encoder(torch.from_numpy(src[:, t:t + 1]),
                                    cache=cache)
            got.append(out.numpy())
    jcache = jm.encoder.gen_cache(_j(src))
    want = []
    for t in range(5):
        out, jcache = jm.encoder(_j(src[:, t:t + 1]), cache=jcache)
        want.append(_np(out))
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    assert _rel(got, full) <= 1e-5
    assert _rel(got, want) <= 1e-5
    assert cache[0].k.shape == (2, 5, HEADS, D // HEADS)


def test_gather_tree_matches_jax():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 50, (6, 3, 4)).astype(np.int32)
    parents = rng.integers(0, 4, (6, 3, 4)).astype(np.int32)
    want = _np(JF.gather_tree(_j(ids), _j(parents)))
    got = TF.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_keeps_jax_order_among_ties():
    rows = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 1.0, 1.0, 1.0],
                     [-1e9 + 0.25] * 4 + [-1e9] * 4,
                     [2.0] * 8], np.float32)
    for k in (1, 3, 5):
        wv, wi = jax.lax.top_k(jnp.asarray(rows), k)
        gv, gi = tdecode._top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # -1e9 + a log-prob rounds to one f32 for every token
    assert np.float32(-1e9) + np.float32(-2.3) == np.float32(-1e9)


class _Flat:
    """A cell whose logits are the same for every token: every step is a
    row of ties (beam 0's V tokens at one value, the dead beams' at
    another)."""

    def __init__(self, lib):
        self.lib = lib

    def __call__(self, inputs, states):
        n = states.shape[0]
        if self.lib == "torch":
            return torch.zeros(n, V), states + 1
        return paddle.zeros([n, V]), states + 1


def _run_beam(decoder, inits, **kw):
    """``dynamic_decode``, with the steps' outputs kept from
    ``finalize``."""
    seen = []
    finalize = decoder.finalize

    def keep(outputs, states, lengths):
        seen.extend(outputs)
        return finalize(outputs, states, lengths)
    decoder.finalize = keep
    res = (jdecode if isinstance(decoder, jdecode.BeamSearchDecoder)
           else tdecode).dynamic_decode(decoder, inits, **kw)
    return res, seen


def _same_outputs(seen_t, seen_j, scores_tol=1e-5):
    assert len(seen_t) == len(seen_j)
    for ot, oj in zip(seen_t, seen_j):
        np.testing.assert_array_equal(_np(ot.predicted_ids),
                                      _np(oj.predicted_ids))
        np.testing.assert_array_equal(_np(ot.parent_ids),
                                      _np(oj.parent_ids))
        s_t, s_j = _np(ot.scores), _np(oj.scores)
        live = s_j > -1e8
        np.testing.assert_array_equal(s_t[~live], s_j[~live])
        assert np.abs(s_t[live] - s_j[live]).max(initial=0) <= \
            scores_tol * max(1.0, np.abs(s_j[live]).max(initial=0))


def test_beam_search_ties_follow_jax():
    tdec = tdecode.BeamSearchDecoder(_Flat("torch"), START, END, 3)
    jdec = jdecode.BeamSearchDecoder(_Flat("jax"), START, END, 3)
    (tids, tst), seen_t = _run_beam(tdec, torch.zeros(2, 1),
                                    max_step_num=3)
    (jids, jst), seen_j = _run_beam(jdec, paddle.zeros([2, 1]),
                                    max_step_num=3)
    _same_outputs(seen_t, seen_j, 0.0)
    np.testing.assert_array_equal(tids.numpy(), _np(jids))
    # beam 0's first three tokens, in index order
    np.testing.assert_array_equal(seen_t[0].predicted_ids.numpy(),
                                  [[0, 1, 2]] * 2)


def test_nested_namedtuple_state_raises_as_in_jax():
    k = np.zeros((2, 0, HEADS, D // HEADS), np.float32)
    tdec = tdecode.BeamSearchDecoder(_Flat("torch"), START, END, 2)
    jdec = jdecode.BeamSearchDecoder(_Flat("jax"), START, END, 2)
    with pytest.raises(TypeError):
        jdec.initialize(jnn.MultiHeadAttention.Cache(_j(k), _j(k)))
    with pytest.raises(TypeError):
        tdec.initialize(tnn.MultiHeadAttention.Cache(
            torch.from_numpy(k), torch.from_numpy(k)))


def _lstm_parts(lib, seed=6):
    """Token embedding, LSTMCell and output Linear, as one container of
    each package (JAX's drawn from numpy, the port's loaded from it)."""
    if lib == "jax":
        with numpy_init(seed):
            parts = jnn.Layer()
            parts.emb = jnn.Embedding(V, 16)
            parts.cell = jnn.LSTMCell(16, 24)
            parts.out = jnn.Linear(24, V)
        arrays = _redraw(parts, seed)
        # the end token more likely at every step, so beams finish at
        # different steps
        parts.out.bias._data = parts.out.bias._data.at[END].add(1.5)
        arrays["out.bias"] = np.asarray(parts.out.bias._data)
        return parts, arrays
    parts = torch.nn.Module()
    parts.emb = tnn.Embedding(V, 16)
    parts.cell = tnn.LSTMCell(16, 24)
    parts.out = tnn.Linear(24, V, bias=True)
    return parts


@pytest.mark.parametrize("time_major", [False, True])
def test_lstm_beam_search_matches_jax(time_major):
    jparts, arrays = _lstm_parts("jax")
    tparts = _load(_lstm_parts("torch"), arrays)
    B, K, H = 3, 4, 24
    jdec = jdecode.BeamSearchDecoder(jparts.cell, START, END, K,
                                     embedding_fn=jparts.emb,
                                     output_fn=jparts.out)
    tdec = tdecode.BeamSearchDecoder(tparts.cell, START, END, K,
                                     embedding_fn=tparts.emb,
                                     output_fn=tparts.out)
    h0 = np.random.default_rng(7).standard_normal((B, H)).astype(np.float32)
    kw = dict(max_step_num=8, output_time_major=time_major,
              return_length=True)
    (jids, jst, jlen), seen_j = _run_beam(
        jdec, (_j(h0), _j(np.zeros_like(h0))), **kw)
    with torch.no_grad():
        (tids, tst, tlen), seen_t = _run_beam(
            tdec, (torch.from_numpy(h0), torch.zeros(B, H)), **kw)
    _same_outputs(seen_t, seen_j)
    want_shape = (len(seen_j), B, K) if time_major else (B, len(seen_j), K)
    assert tuple(tids.shape) == want_shape
    np.testing.assert_array_equal(tids.numpy(), _np(jids))
    np.testing.assert_array_equal(tlen.numpy(), _np(jlen))
    np.testing.assert_array_equal(tst.finished.numpy(),
                                  np.asarray(jst.finished))
    assert _rel(tst.log_probs.numpy(), np.asarray(jst.log_probs)) <= 1e-5
    # some beams finished before others (the lengths differ)
    assert len(np.unique(tlen.numpy())) > 1


class _DecoderCell:
    """A Transformer-decoder cell for beam search: the states are (the
    position [N], the layers' caches as plain tuples ((k, v), (k, v)));
    each call embeds the tokens' inputs at their position, runs the
    decoder over the caches and returns the last hidden state."""

    def __init__(self, lib, decoder, pos_emb):
        self.lib, self.decoder, self.pos_emb = lib, decoder, pos_emb
        mha = tnn.MultiHeadAttention if lib == "torch" \
            else jnn.MultiHeadAttention
        self.Cache, self.Static = mha.Cache, mha.StaticCache

    def plain(self, caches):
        return tuple((tuple(incr), tuple(static))
                     for incr, static in caches)

    def __call__(self, inputs, states):
        pos, caches = states
        x = inputs + self.pos_emb(pos)
        x = x.reshape([x.shape[0], 1, x.shape[-1]]) if self.lib == "jax" \
            else x[:, None]
        named = [(self.Cache(*incr), self.Static(*static))
                 for incr, static in caches]
        out, named = self.decoder(x, None, cache=named)
        out = out.reshape([out.shape[0], out.shape[-1]])
        return out, (pos + 1, self.plain(named))


@pytest.mark.parametrize("time_major", [False, True])
def test_transformer_beam_search_matches_jax(pair, time_major):
    jm, tm = pair
    with numpy_init(8):
        jparts = jnn.Layer()
        jparts.emb = jnn.Embedding(V, D)
        jparts.pos = jnn.Embedding(16, D)
        jparts.out = jnn.Linear(D, V)
    arrays = _redraw(jparts, 8)
    jparts.out.bias._data = jparts.out.bias._data.at[END].add(1.0)
    arrays["out.bias"] = np.asarray(jparts.out.bias._data)
    tparts = torch.nn.Module()
    tparts.emb = tnn.Embedding(V, D)
    tparts.pos = tnn.Embedding(16, D)
    tparts.out = tnn.Linear(D, V, bias=True)
    _load(tparts, arrays)
    (src,) = _inputs(9, (2, 6, D))
    K = 3
    kw = dict(max_step_num=5, output_time_major=time_major,
              return_length=True)
    jcell = _DecoderCell("jax", jm.decoder, jparts.pos)
    jmem = jm.encoder(_j(src))
    jinit = (paddle.zeros([2], "int64"),
             jcell.plain(jm.decoder.gen_cache(jmem)))
    jdec = jdecode.BeamSearchDecoder(jcell, START, END, K,
                                     embedding_fn=jparts.emb,
                                     output_fn=jparts.out)
    # JAX's tiling reshapes to (-1,) + shape[1:], which cannot infer the
    # -1 of gen_cache's empty Cache (zero steps); the port's repeats rows
    # (ROADMAP queue 3).  The JAX side runs with the same repeat.
    with pytest.raises(ZeroDivisionError):
        jdec.initialize(jinit)
    with mock.patch.object(
            jdecode.BeamSearchDecoder, "tile_beam_merge_with_batch",
            staticmethod(lambda x, k: jdecode.wrap_array(
                jnp.repeat(jdecode._arr(x), k, axis=0)))):
        (jids, jst, jlen), seen_j = _run_beam(jdec, jinit, **kw)
    with torch.no_grad():
        tcell = _DecoderCell("torch", tm.decoder, tparts.pos)
        tmem = tm.encoder(torch.from_numpy(src))
        tinit = (torch.zeros(2, dtype=torch.int64),
                 tcell.plain(tm.decoder.gen_cache(tmem)))
        tdec = tdecode.BeamSearchDecoder(tcell, START, END, K,
                                         embedding_fn=tparts.emb,
                                         output_fn=tparts.out)
        (tids, tst, tlen), seen_t = _run_beam(tdec, tinit, **kw)
    _same_outputs(seen_t, seen_j)
    np.testing.assert_array_equal(tids.numpy(), _np(jids))
    np.testing.assert_array_equal(tlen.numpy(), _np(jlen))
    steps = len(seen_t)
    assert tuple(tids.shape) == ((steps, 2, K) if time_major
                                 else (2, steps, K))
    pos, caches = tst.cell_states
    np.testing.assert_array_equal(pos.numpy(), [steps] * (2 * K))
    assert caches[0][0][0].shape == (2 * K, steps, HEADS, D // HEADS)


def _seq2seq(lib):
    """Source and target embeddings, a ``Transformer`` and the output
    Linear, as a user of ``nn.Transformer`` builds them, in ``lib``'s
    package."""
    nn = jnn if lib == "jax" else tnn
    base = jnn.Layer if lib == "jax" else torch.nn.Module

    class Seq2Seq(base):
        def __init__(self):
            super().__init__()
            kw = {} if lib == "jax" else dict(device="cpu", seed=None)
            self.src_emb = nn.Embedding(V, D)
            self.tgt_emb = nn.Embedding(V, D)
            self.transformer = nn.Transformer(D, HEADS, LAYERS, LAYERS, FF,
                                              dropout=0.0, **kw)
            self.out = nn.Linear(D, V) if lib == "jax" \
                else nn.Linear(D, V, bias=True)
            self.mask = self.transformer.generate_square_subsequent_mask(6)

        def forward(self, src, tgt):
            h = self.transformer(self.src_emb(src), self.tgt_emb(tgt),
                                 tgt_mask=self.mask)
            return self.out(h)
    return Seq2Seq()


def test_seq2seq_adamw_step_matches_jax():
    with numpy_init(10):
        jm = _seq2seq("jax")
    arrays = _redraw(jm, 11)
    tm = _load(_seq2seq("torch"), arrays)
    rng = np.random.default_rng(12)
    src = rng.integers(3, V, (4, 7))
    tgt = rng.integers(3, V, (4, 7))
    tin, tout = tgt[:, :-1], tgt[:, 1:]
    opt = dict(learning_rate=1e-3, beta2=0.98, epsilon=1e-9,
               weight_decay=0.01)
    jce, tce = jnn.CrossEntropyLoss(), tnn.CrossEntropyLoss()
    jstep = JaxTrainStep(jm, lambda o, y: jce(o, y), joptim.AdamW(
        parameters=jm.parameters(), **opt))
    tstep = TrainStep(tm, lambda o, y: tce(o, y), toptim.AdamW(
        parameters=tm.parameters(), **opt))
    for _ in range(2):
        jl = float(_np(jstep((_j(src), _j(tin)), _j(tout))))
        tl = float(tstep((torch.from_numpy(src), torch.from_numpy(tin)),
                         torch.from_numpy(tout)))
        assert abs(tl - jl) <= 1e-5 * abs(jl)
    jstep.sync()
    want = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    got = _to_numpy(tm)
    assert got.keys() == want.keys()
    for n in want:
        if n.endswith("k_proj.bias"):
            # softmax ignores it: its gradient is 0 up to rounding, which
            # Adam (eps 1e-9) turns into steps of lr either way
            assert np.abs(got[n] - want[n]).max() <= 2 * 2 * 1e-3, n
        else:
            assert _rel(got[n], want[n]) <= 1e-4, n
