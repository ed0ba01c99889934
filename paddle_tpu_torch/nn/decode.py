"""Seq2seq decoding (port of paddle_tpu/nn/decode.py): ``Decoder``,
``BeamSearchDecoder`` and ``dynamic_decode``.

The decode loop is a host loop, as in the JAX package: each step is the
cell, a log-softmax, one selection of the best ``beam_size`` scores of a
row and the gathers of the states, queued on the cell's device; the
loop reads ``finished.all()`` back once a step to stop early.  The last
step's backtrace is ``functional.gather_tree``.
"""
from __future__ import annotations

import collections

import torch

from . import functional as F

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


def _tree_map(fn, tree):
    """``fn`` on each leaf of nested tuples and lists, rebuilt with
    ``type(tree)`` as the JAX package rebuilds them (a namedtuple in the
    tree raises there, and here too)."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (tuple, list)):
        tree = tree[0]
    return tree


def _top_k(x, k):
    """The ``k`` largest values of each row of ``x`` and their indices,
    in descending order, ties going to the lower index as in
    ``jax.lax.top_k``: a stable descending sort keeps equal values in
    index order (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Decoder:
    """The step-decoder interface: ``initialize(inits) -> (inputs,
    states, finished)``, ``step(time, inputs, states) -> (outputs,
    states, inputs, finished)``, ``finalize(outputs, states,
    lengths)``."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over a cell ``(inputs, states) -> (outputs,
    new_states)``; ``embedding_fn`` maps token ids to the next step's
    inputs, ``output_fn`` the cell's outputs to vocabulary logits.  The
    cell's states are nested tuples and lists of tensors whose first
    dim is batch x beam."""

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B * beam, ...], each batch row repeated."""
        return x.repeat_interleave(beam_size, dim=0)

    def _merge(self, a):        # [B, beam, ...] -> [B * beam, ...]
        return a.reshape((-1,) + tuple(a.shape[2:]))

    def _split(self, a):        # [B * beam, ...] -> [B, beam, ...]
        return a.reshape((-1, self.beam_size) + tuple(a.shape[1:]))

    def initialize(self, initial_cell_states):
        states = _tree_map(
            lambda t: self.tile_beam_merge_with_batch(t, self.beam_size),
            initial_cell_states)
        leaf = _first_leaf(states)
        bxk, dev = leaf.shape[0], leaf.device
        batch = bxk // self.beam_size
        start = torch.full((bxk,), self.start_token, dtype=torch.int32,
                           device=dev)
        inputs = self.embedding_fn(start) \
            if self.embedding_fn is not None else start
        # beam 0 live, the rest dead (the first step's symmetry break)
        log_probs = torch.tensor(
            [0.0] + [-1e9] * (self.beam_size - 1), dtype=torch.float32,
            device=dev).repeat(batch, 1)
        finished = torch.zeros((batch, self.beam_size), dtype=torch.bool,
                               device=dev)
        lengths = torch.zeros((batch, self.beam_size), dtype=torch.int32,
                              device=dev)
        state = self.StateWrapper(states, log_probs, finished, lengths)
        return inputs, state, finished

    def step(self, time, inputs, states, **kwargs):
        cell_out, cell_states = self.cell(inputs, states.cell_states,
                                          **kwargs)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        logits = cell_out                                  # [B*beam, V]
        V = logits.shape[-1]
        lp = self._split(torch.log_softmax(logits, dim=-1))  # [B, beam, V]
        prev = states.log_probs[..., None]                 # [B, beam, 1]
        # finished beams only propagate through end_token with prob 1
        fin = states.finished[..., None]
        onehot_end = torch.arange(V, device=logits.device) == self.end_token
        masked = torch.where(onehot_end, 0.0, -1e9)
        total = torch.where(fin, prev + masked, prev + lp)  # [B, beam, V]
        flat = total.reshape(total.shape[0], -1)            # [B, beam*V]
        top_val, top_idx = _top_k(flat, self.beam_size)
        parent = top_idx // V                               # [B, beam]
        token = (top_idx % V).int()
        brow = torch.arange(flat.shape[0], device=flat.device)[:, None]

        def gather_state(s):
            return self._merge(self._split(s)[brow, parent])

        next_cell = _tree_map(gather_state, cell_states)
        was_fin = states.finished[brow, parent]
        now_fin = was_fin | (token == self.end_token)
        lengths = states.lengths[brow, parent] + (~was_fin).int()
        next_state = self.StateWrapper(next_cell, top_val, now_fin, lengths)
        outputs = self.OutputWrapper(top_val, token, parent.int())
        flat_token = token.reshape(-1)
        next_inputs = self.embedding_fn(flat_token) \
            if self.embedding_fn is not None else flat_token
        return outputs, next_state, next_inputs, now_fin

    def finalize(self, outputs, final_states, sequence_lengths):
        """The steps' ids traced back through their parents: [T, B,
        beam]."""
        ids = torch.stack([o.predicted_ids for o in outputs])
        parents = torch.stack([o.parent_ids for o in outputs])
        return F.gather_tree(ids, parents), final_states

    @property
    def tracks_own_finished(self):
        return True


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every lane finishes or ``max_step_num``
    steps have run: the final ids [B, T, beam] ([T, B, beam] with
    ``output_time_major``), the final states and, with
    ``return_length``, the lengths [B, beam].  ``impute_finished`` and
    ``is_test`` are accepted and ignored, as in the JAX package."""
    inputs, states, finished = decoder.initialize(inits)
    outputs = []
    step = 0
    limit = int(max_step_num) if max_step_num is not None else None
    while limit is None or step < limit:
        out, states, inputs, finished = decoder.step(step, inputs, states,
                                                     **kwargs)
        outputs.append(out)
        step += 1
        if bool(finished.all()):
            break
    lengths = getattr(states, "lengths", None)
    final, final_states = decoder.finalize(outputs, states, lengths)
    if isinstance(final, torch.Tensor) and not output_time_major:
        final = final.movedim(0, 1)                       # [B, T, beam]
    if return_length:
        return final, final_states, lengths
    return final, final_states
