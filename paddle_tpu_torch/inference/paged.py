"""Paged-KV serving steps for causal LMs (port of
paddle_tpu/inference/paged.py: the prefill, prefix/chunk and ragged
programs, the fused sampling tail, and quantized serving — int8 weights
through the armed ``Linear`` hook, int8 KV pages).

Where the JAX package compiles one program per (mode, bucket) and
donates the page pools through it, the port runs the same steps eagerly
and writes the pools in place.  It keeps the JAX package's shapes — the
power-of-two batch and span buckets, the pad rows (context 0, span 1),
right-padded prompt buckets — so that each step's shapes stay the few
that a later CUDA-graph capture needs.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from ..ops.flash_attention import DEFAULT_MASK_VALUE, flash_attention_bshd
from ..ops.paged_attention import (PagedKVCache, _gather_dequant,
                                   _scatter_pages, dequantize_kv,
                                   paged_attention_ragged, quantize_kv)
from ..quantization.serving import (SERVING_QUANT_MODES,
                                    quantize_linear_weights)
from . import _threefry


def next_pow2(n: int) -> int:
    """Smallest power of two >= n: the bucketing rule for prompt length,
    page-table width and batch size."""
    b = 1
    while b < n:
        b *= 2
    return b


def fused_sample(logits, seeds, ctrs, temps, flags):
    """Sampling tail: per row the greedy argmax or, where ``flags`` is
    set, a draw from softmax(logits / temperature).

    logits (batch, vocab) f32 on the model's device; seeds, ctrs, temps,
    flags host arrays (batch,).  A draw is the JAX package's
    ``jax.random.categorical(fold_in(PRNGKey(seed), ctr), logits /
    max(temp, 1e-6))`` on the same random bits (``_threefry``), where
    the counter is the token's absolute position: a (seed, position) pair
    replays
    the same draw whatever the batch around it, and the port's stream
    equals the JAX engine's.  The sampled rows are drawn together in
    one batched sequence of torch ops on the logits' device.  Returns
    (batch,) int32 on the logits' device."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    rows = np.flatnonzero(np.asarray(flags, bool))
    if not rows.size:
        return greedy
    dev = logits.device
    pick = torch.from_numpy(rows).to(dev)
    seed = torch.from_numpy(np.asarray(seeds, np.uint32)[rows]
                            .astype(np.int64)).to(dev)
    ctr = torch.from_numpy(np.asarray(ctrs, np.int32)[rows]
                           .astype(np.int64)).to(dev)
    temp = torch.from_numpy(np.asarray(temps, np.float32)[rows]).to(dev)
    key = _threefry.fold_in(_threefry.prng_key(seed), ctr)
    scaled = logits[pick].float() / temp.clamp_min(1e-6)[:, None]
    out = greedy.clone()
    out[pick] = _threefry.categorical(key, scaled).to(torch.int32)
    return out


def sample_token(logits_row, do_sample, temperature, rng) -> int:
    """One row's next token on the host (the engine's
    ``sample_on_device=False`` path, a copy of the JAX package's
    ``sample_token``): the greedy argmax, or a draw from
    softmax(logits / temperature) by the request's numpy generator
    ``rng``, so the port draws the JAX engine's tokens."""
    if do_sample:
        z = np.asarray(logits_row, np.float32) / max(temperature, 1e-6)
        p = np.exp(z - z.max())
        p /= p.sum()
        return int(rng.choice(p.shape[-1], p=p))
    return int(np.asarray(logits_row).argmax())


def _prefix_suffix_attention(q, k_suf, v_suf, k_pages, v_pages, tables,
                             prefix_lens, k_scales=None, v_scales=None):
    """Prompt-suffix attention for rows whose prefix KV is already in
    pages: every suffix token attends the whole gathered prefix plus the
    suffix causally.  Dense masked attention, as in the JAX package.

    q (b, s, q_heads, d); k_suf/v_suf (b, s, kv_heads, d) post-rope (in
    the int8 mode already round-tripped by the caller); pages (kv_heads,
    total, page, d), int8 with ``k/v_scales`` (kv_heads, total, page, 1);
    tables (b, P) int32 pointing at the prefix pages; prefix_lens (b,)
    int32.  Returns (b, s, q_heads, d)."""
    b, s, qh, d = q.shape
    group = qh // k_suf.shape[2]
    t_pre = tables.shape[1] * k_pages.shape[2]
    k_all = torch.cat([_gather_dequant(k_pages, k_scales, tables, q.dtype),
                       k_suf.transpose(1, 2)], dim=2)
    v_all = torch.cat([_gather_dequant(v_pages, v_scales, tables, q.dtype),
                       v_suf.transpose(1, 2)], dim=2)
    if group != 1:
        k_all = k_all.repeat_interleave(group, dim=1)
        v_all = v_all.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", q.transpose(1, 2).float(),
                          k_all.float()) / math.sqrt(d)
    t = torch.arange(t_pre + s, device=q.device)
    # prefix columns: valid below the row's prefix length; suffix
    # columns: causal within the suffix (right pads sit after every
    # real token, so causality masks them out)
    valid_pre = (t[None, :] < prefix_lens.long()[:, None])[:, None, None, :]
    i = torch.arange(s, device=q.device)
    valid_suf = ((t[None, :] >= t_pre)
                 & (t[None, :] - t_pre <= i[:, None]))[None, None]
    scores = torch.where(valid_pre | valid_suf, scores, DEFAULT_MASK_VALUE)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p.to(v_all.dtype).float(),
                       v_all.float())
    return out.transpose(1, 2).to(q.dtype)


class PagedContext:
    """Attention driver handed down to the attention layers for one step.

    Every mode first writes the step's K/V into the pages at the
    host-planned (page, slot) targets.  Targets aimed past the pool — the
    pad positions of a bucket, which the JAX scatter drops — are removed
    on the host before the write.  Then:

    - ``"prefill"``: fresh prompts, causal flash attention over the
      (right-padded) batch;
    - ``"prefix"``: prompt suffixes over their cached prefix pages
      (``tables``, ``prefix_lens``), dense;
    - ``"ragged"``: each row's left-aligned span over its pages, through
      ``paged_attention_ragged`` (``lens`` counts the span, ``q_lens``
      is the span length).

    In the int8 KV mode the write quantizes per slot and head and stores
    the scales beside the values, and prefill attends the round-tripped
    K/V, so every consumer sees exactly what the pages hold.
    """

    def __init__(self, cache: PagedKVCache, pg: np.ndarray, sl: np.ndarray,
                 mode: str, lens=None, tables=None, q_lens=None,
                 prefix_lens=None):
        if mode not in ("prefill", "prefix", "ragged"):
            raise ValueError(f"unknown paged attention mode {mode!r}")
        dev = cache.device
        keep = np.flatnonzero(pg < cache.total_pages)
        self.cache = cache
        self.mode = mode
        self.keep = (None if keep.size == pg.size
                     else torch.from_numpy(keep).to(dev))
        self.pg = torch.from_numpy(pg[keep].astype(np.int64)).to(dev)
        self.sl = torch.from_numpy(sl[keep].astype(np.int64)).to(dev)
        self.lens = lens
        self.tables = tables
        self.q_lens = q_lens
        self.prefix_lens = prefix_lens
        self.layer_idx = 0

    def _store(self, pool, vals) -> None:
        """Scatter (b * s, kv_heads, last) values at the kept targets."""
        if self.keep is not None:
            vals = vals.index_select(0, self.keep)
        _scatter_pages(pool, self.pg, self.sl, vals.transpose(0, 1))

    def _write(self, layer, x, pages, scales):
        """Write one of k/v (b, s, kv_heads, d) into its pool; returns
        the values prefill attention consumes (round-tripped in the int8
        mode; the ragged step reads the pages instead)."""
        b, s, kvh, d = x.shape
        flat = x.reshape(b * s, kvh, d)
        if not self.cache.kv_quant:
            self._store(pages[layer], flat)
            return x
        x8, sc = quantize_kv(flat)
        self._store(pages[layer], x8)
        self._store(scales[layer], sc)
        if self.mode == "ragged":
            return None
        return dequantize_kv(x8, sc, x.dtype).reshape(b, s, kvh, d)

    def attend(self, q, k, v):
        """q (b, s, q_heads, d), k/v (b, s, kv_heads, d), post-rope.
        Writes k/v into the pages and returns (b, s, q_heads, d)."""
        c, i = self.cache, self.layer_idx
        k = self._write(i, k, c.k_pages, c.k_scales)
        v = self._write(i, v, c.v_pages, c.v_scales)
        kp, vp = c.k_pages[i], c.v_pages[i]
        ks, vs = (c.k_scales[i], c.v_scales[i]) if c.kv_quant \
            else (None, None)
        if self.mode == "prefill":
            return flash_attention_bshd(q, k, v, causal=True)
        if self.mode == "prefix":
            return _prefix_suffix_attention(q, k, v, kp, vp, self.tables,
                                            self.prefix_lens, ks, vs)
        return paged_attention_ragged(q, kp, vp, self.lens, self.q_lens,
                                      self.tables, k_scales=ks, v_scales=vs)


class PagedDecoder:
    """The serving steps over a :class:`PagedKVCache`: whole-prompt
    prefill, prefix/chunk prefill and the ragged unified step.  Every
    step plans its page writes on the host, runs the model once with a
    :class:`PagedContext`, and on any failure rolls the sequences'
    lengths back to where the step found them.

    ``quantize="w8"`` or ``"w8a8"`` builds every Linear's int8 twin once
    (``quantization.serving.quantize_linear_weights``) and arms the
    Linears with it for the duration of each step; the model's own
    weights stay as they are.  In "w8a8" the twins of Linears that read
    one activation are fused (q|k|v and gate|up, armed on their module),
    so each distinct activation is quantized once; "w8" keeps one call a
    Linear, its f32 sums being split by N (``wo_splits``).  The arming
    writes onto the model's shared modules, so a quantized decoder owns
    its model while it steps: no other decoder on the same model may step
    at the same time."""

    def __init__(self, model, quantize: Optional[str] = None):
        if quantize not in SERVING_QUANT_MODES:
            raise ValueError(
                f"quantize must be one of {SERVING_QUANT_MODES}, got "
                f"{quantize!r}")
        self.model = model
        self.max_position = int(model.config.max_position_embeddings)
        self.device = model.model.embed_tokens.weight.device
        self.quantize = quantize
        self._quant = (quantize_linear_weights(model,
                                               fuse=quantize == "w8a8")
                       if quantize else [])

    @contextlib.contextmanager
    def _armed(self):
        """Arm every quantized Linear with its twin for one step, and in
        w8a8 every module with its fused twin (q|k|v, gate|up: one
        activation quantized once, one matmul); cleared on the way out,
        on failure too."""
        for layer, w_q, scale in self._quant:
            layer._serving_quant = (self.quantize, w_q, scale)
        try:
            yield
        finally:
            for layer, _w_q, _scale in self._quant:
                layer._serving_quant = None

    # ---------------------------------------------------------- helpers
    def _tensor(self, a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    def _last_logits(self, hidden, last_idx):
        """f32 logits of each row's last real position (bucketed prompts
        are right-padded past it)."""
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        last = hidden[rows, self._tensor(last_idx, torch.int64)]
        return self.model._logits_of(last).float()

    @staticmethod
    def _tail(logits, sampling):
        """(seeds, ctrs, temps, flags) -> sampled ids; no flag set ->
        argmax ids; ``sampling=None`` -> the logits themselves."""
        if sampling is None:
            return logits.cpu().numpy()
        seeds, ctrs, temps, flags = sampling
        return fused_sample(logits, seeds, ctrs, temps,
                            flags).cpu().numpy()

    @staticmethod
    def _rollback_lengths(cache, seq_ids, before) -> None:
        """Undo a failed step's ``advance`` (its pages stay mapped)."""
        for sid, n in zip(seq_ids, before):
            cache.truncate(sid, n)

    @staticmethod
    def _pad_prefill_plan(cache, ids_np, pg, sl, b, s, s_b):
        """Right-pad a bucketed prompt's ids and (page, slot) targets; pad
        positions aim past the pool, so their writes are dropped."""
        pad = s_b - s
        ids_np = np.pad(ids_np, ((0, 0), (0, pad)))
        pg = np.concatenate(
            [pg.reshape(b, s),
             np.full((b, pad), cache.total_pages, np.int32)],
            axis=1).reshape(-1)
        sl = np.concatenate(
            [sl.reshape(b, s), np.zeros((b, pad), np.int32)],
            axis=1).reshape(-1)
        return ids_np, pg, sl

    # ------------------------------------------------------------ steps
    @torch.no_grad()
    def prefill(self, cache: PagedKVCache, seq_ids, ids_np,
                sampling=None) -> np.ndarray:
        """Prompt pass for fresh sequences: ids_np (batch, s) int32, all
        rows of real length s; the prompt pads right to a power of two
        (never past the rope table).  Returns the last real
        token's logits (batch, vocab) f32, or with
        ``sampling=(seeds, ctrs, temps, flags)`` the sampled ids."""
        b, s = ids_np.shape
        if s > self.max_position:
            raise ValueError(
                f"prompt length {s} exceeds max_position_embeddings "
                f"({self.max_position})")
        before = [cache.length(sid) for sid in seq_ids]
        for sid in seq_ids:
            cache.allocate(sid, s)
        pg, sl = cache.plan_write(seq_ids, s)
        cache.advance(seq_ids, s)
        s_b = min(next_pow2(s), self.max_position)
        if s_b != s:
            ids_np, pg, sl = self._pad_prefill_plan(cache, ids_np, pg, sl,
                                                    b, s, s_b)
        try:
            ctx = PagedContext(cache, pg, sl, "prefill")
            with self._armed():
                hidden = self.model.model(self._tensor(ids_np, torch.int64),
                                          0, paged_ctx=ctx)
                logits = self._last_logits(hidden, np.full(b, s - 1))
            return self._tail(logits, sampling)
        except BaseException:
            self._rollback_lengths(cache, seq_ids, before)
            raise

    def prefix_prefill(self, cache: PagedKVCache, seq_ids, ids_np,
                       prefix_tokens: int, sampling=None) -> np.ndarray:
        """Suffix-only prompt pass for sequences whose first
        ``prefix_tokens`` (page-aligned) prompt tokens are cached and
        already mapped (``PagedKVCache.acquire_prefix``)."""
        k = int(prefix_tokens)
        if k <= 0 or k % cache.page_size:
            raise ValueError(
                f"prefix_tokens must be a positive multiple of the page "
                f"size ({cache.page_size}), got {k}")
        return self._context_prefill(cache, seq_ids, ids_np, k, sampling)

    def chunk_prefill(self, cache: PagedKVCache, seq_ids, ids_np,
                      context_tokens: int, sampling=None) -> np.ndarray:
        """Chunked-prefill continuation: ingest the next ids_np
        (batch, s) slice of prompts whose first ``context_tokens`` tokens
        are cached, at any (not necessarily page-aligned) length."""
        k = int(context_tokens)
        if k <= 0:
            raise ValueError(
                f"context_tokens must be positive, got {k} (use "
                "prefill() for a fresh sequence)")
        return self._context_prefill(cache, seq_ids, ids_np, k, sampling)

    @torch.no_grad()
    def _context_prefill(self, cache, seq_ids, ids_np, k: int,
                         sampling) -> np.ndarray:
        b, s = ids_np.shape
        if k + s > self.max_position:
            raise ValueError(
                f"prompt length {k + s} exceeds max_position_embeddings "
                f"({self.max_position})")
        before = []
        for sid in seq_ids:
            if cache.length(sid) != k:
                raise ValueError(
                    f"sequence {sid!r} is at length {cache.length(sid)}, "
                    f"expected the cached context length {k}")
            before.append(k)
            cache.allocate(sid, s)
        pg, sl = cache.plan_write(seq_ids, s)
        cache.advance(seq_ids, s)
        s_b = min(next_pow2(s), self.max_position - k)
        if s_b != s:
            ids_np, pg, sl = self._pad_prefill_plan(cache, ids_np, pg, sl,
                                                    b, s, s_b)
        # the context may end mid-page (chunked prefill): gather the
        # partial page too; attention masks columns past k
        n_pre = -(-k // cache.page_size)
        ptabs = np.zeros((b, next_pow2(n_pre)), np.int32)
        for i, sid in enumerate(seq_ids):
            ptabs[i, :n_pre] = cache._seq_pages[sid][:n_pre]
        try:
            plens = self._tensor(np.full(b, k, np.int32))
            ctx = PagedContext(cache, pg, sl, "prefix",
                               tables=self._tensor(ptabs),
                               prefix_lens=plens)
            # the prefix length doubles as the per-row rope offset
            with self._armed():
                hidden = self.model.model(self._tensor(ids_np, torch.int64),
                                          plens, paged_ctx=ctx)
                logits = self._last_logits(hidden, np.full(b, s - 1))
            return self._tail(logits, sampling)
        except BaseException:
            self._rollback_lengths(cache, seq_ids, before)
            raise

    @torch.no_grad()
    def ragged_step(self, cache: PagedKVCache, seq_ids, rows, ctxs,
                    n_drafts=None, sampling=None):
        """One ragged serving step: ``rows[i]`` is a 1-D int32 token span
        for ``seq_ids[i]`` whose cached context length is ``ctxs[i]`` — a
        decode row is its one last sampled token, a prefill/chunk row
        the next prompt slice, a verify row the last fed token followed
        by ``n_drafts[i]`` draft proposals.

        Spans left-align in a power-of-two span bucket and the batch pads
        to a power of two with context-0, span-1 rows; pad positions
        write nowhere.  Page allocation is all-or-nothing across the
        batch; on failure every length rolls back to ``ctxs``.

        Returns ``(out, accept)`` for the real rows: ``accept[i]`` counts
        the leading drafts the model reproduced (0 for non-verify rows);
        ``out`` is the emitted token ids under
        ``sampling=(seeds, temps, flags)``, or the selected position's
        logits when ``sampling`` is None."""
        b = len(seq_ids)
        ns = [len(r) for r in rows]
        if b == 0 or min(ns) < 1:
            raise ValueError("every row needs at least one token")
        nds = [0] * b if n_drafts is None else [int(x) for x in n_drafts]
        before = []
        for sid, k, n, nd in zip(seq_ids, ctxs, ns, nds):
            if nd and n != nd + 1:
                raise ValueError(
                    f"verify row for {sid!r} must be 1 fed token + "
                    f"{nd} drafts, got {n} tokens")
            if cache.length(sid) != int(k):
                raise ValueError(
                    f"sequence {sid!r} is at length {cache.length(sid)}, "
                    f"expected the cached context length {k}")
            if int(k) + n > self.max_position:
                raise ValueError(
                    f"context {k} + span {n} exceeds "
                    f"max_position_embeddings ({self.max_position})")
            before.append(int(k))
        cache.allocate_batch_atomic(seq_ids, ns)
        # span bucket clamped by the deepest context, so the round-up
        # never walks pad positions past the rope table on its own
        s_b = max(max(ns),
                  min(next_pow2(max(ns)),
                      self.max_position - max(int(k) for k in ctxs)))
        b_b = next_pow2(b)
        ids = np.zeros((b_b, s_b), np.int32)
        pg = np.full((b_b, s_b), cache.total_pages, np.int32)  # dropped
        sl = np.zeros((b_b, s_b), np.int32)
        for i, (sid, row, n) in enumerate(zip(seq_ids, rows, ns)):
            ids[i, :n] = np.asarray(row, np.int32)
            rpg, rsl = cache.plan_write([sid], n)
            pg[i, :n] = rpg
            sl[i, :n] = rsl
            cache.advance([sid], n)
        needed = max(len(cache._seq_pages.get(sid, ())) for sid in seq_ids)
        tabs = np.zeros((b_b, next_pow2(needed)), np.int32)
        for i, sid in enumerate(seq_ids):
            t = cache._seq_pages[sid]
            tabs[i, :len(t)] = t
        ctx_arr = np.zeros(b_b, np.int32)
        ctx_arr[:b] = before
        ql = np.ones(b_b, np.int32)          # pad rows: 1-token span,
        ql[:b] = ns                          # context 0, dropped writes
        nd_arr = np.zeros(b_b, np.int32)
        nd_arr[:b] = nds
        try:
            ctx_t = self._tensor(ctx_arr)
            ql_t = self._tensor(ql)
            nd_t = self._tensor(nd_arr)
            ids_t = self._tensor(ids, torch.int64)
            paged = PagedContext(cache, pg.reshape(-1), sl.reshape(-1),
                                 "ragged", lens=ctx_t + ql_t,
                                 tables=self._tensor(tabs), q_lens=ql_t)
            with self._armed():
                hidden = self.model.model(ids_t, ctx_t, paged_ctx=paged)
                lg = self.model._logits_of(hidden).float()   # (B, S, V)
            targets = lg.argmax(dim=-1)
            # verify-row accept arithmetic, gated to the first nd
            # positions so chunk/decode rows (nd == 0) accept nothing
            j = torch.arange(1, s_b, device=self.device)[None, :]
            match = ((ids_t[:, 1:] == targets[:, :-1])
                     & (j <= nd_t[:, None])).long()
            accept = match.cumprod(dim=1).sum(dim=1)         # (B,)
            # the row's output position: its last real token, or the
            # bonus position of a verify row
            sel = ql_t.long() - 1 - nd_t.long() + accept
            rows_t = torch.arange(b_b, device=self.device)
            lg_sel = lg[rows_t, sel]
            accept_np = accept.cpu().numpy().astype(np.int32)
            if sampling is None:
                out = lg_sel.cpu().numpy()
            else:
                seeds, temps, flags = sampling
                pad = b_b - b
                # absolute position of the emitted token: the counter of
                # its (seed, position) draw
                ctrs = ctx_arr + ql - nd_arr + accept_np
                out = fused_sample(
                    lg_sel,
                    np.concatenate([np.asarray(seeds, np.uint32),
                                    np.zeros(pad, np.uint32)]),
                    ctrs,
                    np.concatenate([np.asarray(temps, np.float32),
                                    np.ones(pad, np.float32)]),
                    np.concatenate([np.asarray(flags, bool),
                                    np.zeros(pad, bool)])).cpu().numpy()
        except BaseException:
            self._rollback_lengths(cache, seq_ids, before)
            raise
        return out[:b], accept_np[:b]
