"""Speculative decoding (port of paddle_tpu/inference/speculative.py): a
small draft model proposes, the target model verifies k tokens in ONE
forward (Leviathan et al. 2023, greedy variant).

Verification is one forward over the k proposed tokens and the last fed
one — on a card the flash forward kernel with ``k + 1`` queries over the
cached keys, causally aligned bottom-right — in place of k single-token
decode forwards, so the acceptance rate turns memory-bound decode
forwards into one denser verify forward.

Greedy speculative decoding is exact: the emitted sequence is the
target-only greedy one whatever the draft proposes (every accepted token
is the target's argmax given its prefix, and the first disagreement
emits the target's own argmax) — exact up to the rounding of a
``k + 1``-row forward against single-row ones, which in f32 moves no
argmax of the tests' models.

KV caches are the models' per-layer (k, v) concat caches (the
``kv_caches`` path of ``LlamaModel.forward``); rejected suffixes roll
back through :class:`_RollbackKV`: the pre-round cache stays alive as
the base and only the appended block's accepted prefix is sliced out, so
a rollback costs O(accepted tokens), never an O(T) rebuild.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..models.llama import empty_kv_caches


class _RollbackKV:
    """Concat-KV cache with O(appended) rollback.

    The per-layer caches fed to the last forward stay alive as ``base``;
    a round's outcome is absorbed by slicing only the new block's
    accepted prefix into ``tail``, never by re-slicing the whole
    [T]-long cache.  ``feed()`` merges base and tail once, just before
    the next forward, where the model's own cache append concatenates
    the same sizes anyway."""

    __slots__ = ("base", "tail")

    def __init__(self, caches):
        self.base = caches          # list[(k, v)], k/v (1, T, kvh, d)
        self.tail = None

    @property
    def length(self) -> int:
        n = int(self.base[0][0].shape[1])
        if self.tail is not None:
            n += int(self.tail[0][0].shape[1])
        return n

    def feed(self):
        """The per-layer caches for the next forward (any pending tail
        merged into the base, one concat a layer)."""
        if self.tail is not None:
            self.base = [(torch.cat([bk, tk], dim=1),
                          torch.cat([bv, tv], dim=1))
                         for (bk, bv), (tk, tv) in zip(self.base, self.tail)]
            self.tail = None
        return self.base

    def absorb(self, full_caches, keep: int) -> None:
        """Record a round's outcome: ``full_caches`` is what the model
        returned (the fed base and the appended block); keep the first
        ``keep`` positions.  The base stays as it is, the same objects,
        and only [base_len:keep) of the block is sliced out (a view),
        O(keep - base_len) a layer."""
        if self.tail is not None:
            raise RuntimeError("absorb() must follow a feed()")
        base_len = int(self.base[0][0].shape[1])
        if keep <= base_len:
            return
        self.tail = [(k[:, base_len:keep], v[:, base_len:keep])
                     for k, v in full_caches]


class SpeculativeGenerator:
    """Greedy speculative decoding over (target, draft) causal LMs.

    Both models expose the ``model(ids, position_offset, kv_caches) ->
    (hidden, new_caches)`` cache path and ``_logits_of`` (the port's
    ``LlamaForCausalLM`` and ``LlamaMoeForCausalLM``), on one device.
    ``num_speculative_tokens`` is the draft lookahead k; the acceptance
    statistics of the last call land in ``last_stats``."""

    def __init__(self, target_model, draft_model,
                 num_speculative_tokens: int = 4):
        if num_speculative_tokens < 1:
            raise ValueError("num_speculative_tokens must be >= 1")
        self.target = target_model
        self.draft = draft_model
        self.k = int(num_speculative_tokens)
        self.last_stats: dict = {}

    @staticmethod
    def _argmax(model, hidden):
        """Greedy ids of every position of ``hidden`` (1, s, h): (s,) on
        the device, from f32 logits."""
        return model._logits_of(hidden)[0].float().argmax(dim=-1)

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None) -> np.ndarray:
        """Greedy decode; batch 1 a call (the rollback is per sequence).
        ``input_ids`` (s,) or (1, s), a tensor or an array; returns the
        whole [1, prompt + new] id array."""
        ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                         else input_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        if ids.shape[0] != 1:
            raise ValueError("speculative generate is per-sequence "
                             "(batch 1); batch via the serving engine")
        device = self.target.model.embed_tokens.weight.device
        n_prompt = ids.shape[1]
        t0 = time.perf_counter()
        proposed = accepted = rounds = 0

        def tokens(seq):
            return torch.as_tensor(np.asarray(seq, np.int64)[None],
                                   device=device)

        x = tokens(ids[0])
        # prefill both models on the prompt
        h, caches = self.target.model(x, 0, empty_kv_caches(self.target, 1))
        tgt = _RollbackKV(caches)
        nxt = int(self._argmax(self.target, h[:, -1:])[0])
        _, caches = self.draft.model(x, 0, empty_kv_caches(self.draft, 1))
        dft = _RollbackKV(caches)
        # the live caches, for the rollback tests (the base's identity
        # across a rejected round)
        self._tgt_kv, self._dft_kv = tgt, dft
        out = [int(t) for t in ids[0]] + [nxt]
        # invariant: the caches cover out[:-1]; out[-1] is unverified
        while len(out) - n_prompt < max_new_tokens:
            if eos_token_id is not None and out[-1] == eos_token_id:
                break
            rounds += 1
            L = len(out) - 1                  # verified cached positions
            budget = max_new_tokens - (len(out) - n_prompt)
            k = min(self.k, budget)
            # the draft cache can trail L (an all-accepted round emits its
            # last draft without feeding it): ingest the gap, verified
            # tokens, in one forward; the filled cache is the round's
            # rollback base
            dfeed = dft.feed()
            dft_len = int(dfeed[0][0].shape[1])
            if dft_len < L:
                _, dfeed = self.draft.model(tokens(out[dft_len:L]), dft_len,
                                            dfeed)
                dft.base = dfeed
            # the draft proposes k tokens, one forward each, on the
            # device (read back once, after the k-th)
            cur = tokens(out[-1:])
            dwork = dfeed
            drafts = []
            for j in range(k):
                dh, dwork = self.draft.model(cur, L + j, dwork)
                cur = self._argmax(self.draft, dh)[None]
                drafts.append(cur)
            proposed += k
            # the target verifies in ONE forward over k + 1 tokens
            block = torch.cat([tokens(out[-1:])] + drafts, dim=1)
            th, tfull = self.target.model(block, L, tgt.feed())
            targets = self._argmax(self.target, th).tolist()
            draft_tokens = block[0, 1:].tolist()
            # targets[i] = the target's next token after block[:i + 1]
            n_ok = 0
            while n_ok < k and draft_tokens[n_ok] == targets[n_ok]:
                n_ok += 1
            accepted += n_ok
            emitted = draft_tokens[:n_ok] + [targets[n_ok]]
            out.extend(emitted)
            # O(accepted) rollback: the fed base stays, only the accepted
            # prefix of the new block is sliced out; rejected suffixes
            # never enter the cache
            new_len = len(out) - 1
            tgt.absorb(tfull, new_len)
            dft.absorb(dwork, min(new_len, L + k))
            if eos_token_id is not None and eos_token_id in emitted:
                cut = emitted.index(eos_token_id)
                out = out[:len(out) - len(emitted) + cut + 1]
                break
        out = out[:n_prompt + max_new_tokens]
        self.last_stats = {
            "rounds": rounds,
            "proposed": proposed,
            "accepted": accepted,
            "acceptance_rate": round(accepted / max(proposed, 1), 3),
            "tokens_per_round": round(
                (len(out) - n_prompt) / max(rounds, 1), 2),
            "seconds": round(time.perf_counter() - t0, 4),
        }
        return np.asarray([out], dtype=np.int64)
