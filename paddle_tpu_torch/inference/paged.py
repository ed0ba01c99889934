"""Paged-KV serving steps for causal LMs (port of
paddle_tpu/inference/paged.py: the prefill, prefix/chunk and ragged
programs, the fused sampling tail, and quantized serving — int8 weights
through the armed ``Linear`` hook, int8 KV pages).

Each step comes in two parts.  The host plans it — page allocation, the
(page, slot) write targets, page tables, the bucket's pads — into the
bucket's staging buffer (:class:`_Staging`: one byte buffer, pinned on a
card), which reaches the device in one copy.  The step's device body then
runs the model over the staged tensors: every shape is the bucket's, the
KV write has the bucket's length, the accept counts, output positions and
draw counters are computed on the device, and the outputs come back in
one copy.  The JAX package's buckets are kept — power-of-two batch and
span buckets, pad rows of context 0 and span 1, right-padded prompts,
the page-table width ``max(next_pow2(pages), min_table_pages)``.

:class:`PagedDecoder` runs the bodies eagerly (the counterpart of the
JAX package's eager oracle); :class:`GraphedPagedDecoder` captures each
(mode, tail kind, bucket) once as a CUDA graph and replays it, the
counterpart of ``JittedPagedDecoder``'s compiled programs.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from ..cuda_graphs import capture
# under its old name here, where the card tests read it
from ..cuda_graphs import counted_wrappers as _counted_wrappers  # noqa: F401
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


_NUMPY = {torch.int64: np.int64, torch.float32: np.float32,
          torch.bool: np.bool_}


def _on(x, dtype, device):
    """A host array or a tensor as a tensor of ``dtype`` on ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x).astype(_NUMPY[dtype]))
    return x.to(device=device, dtype=dtype)


def fused_sample(logits, seeds, ctrs, temps, flags):
    """Sampling tail, the JAX package's ``fused_sample``: per row the
    greedy argmax AND a draw from softmax(logits / temperature), selected
    by ``flags``.

    logits (batch, vocab) f32 on the model's device; seeds, ctrs, temps,
    flags (batch,) tensors on that device or host arrays.  A draw is
    ``jax.random.categorical(fold_in(PRNGKey(seed), ctr), logits /
    max(temp, 1e-6))`` on the same random bits (``_threefry``), where the
    counter is the token's absolute position: a row's draw depends only
    on its (seed, position) pair, whatever the batch around it, and the
    port's stream equals the JAX engine's.  Every row draws, so the tail
    reads nothing back and a CUDA graph can hold it.  Returns (batch,)
    int32 on the logits' device."""
    dev = logits.device
    greedy = logits.argmax(dim=-1).to(torch.int32)
    key = _threefry.fold_in(_threefry.prng_key(_on(seeds, torch.int64, dev)),
                            _on(ctrs, torch.int64, dev))
    temp = _on(temps, torch.float32, dev).clamp_min(1e-6)
    draw = _threefry.categorical(key, logits.float() / temp[:, None])
    return torch.where(_on(flags, torch.bool, dev), draw.to(torch.int32),
                       greedy)


def _tail_kind(flags):
    """The tail a step ends in, from the host flags: "draw" (the fused
    sampling tail), "greedy" (argmax only: no row samples) or False (the
    logits, ``sampling=None``).  It is part of a graph's key."""
    if flags is None:
        return False
    return "draw" if np.any(flags) else "greedy"


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
    """Attention driver handed down to the attention layers for one step,
    built from device tensors only (the counterpart of the JAX package's
    ``_TracedPagedContext``).

    Every mode first writes the step's K/V into the pages: all of the
    bucket's ``b * s`` positions, flat position i taking the value of
    position ``src[i]`` to (``pg[i]``, ``sl[i]``).  A real position is
    its own source; a pad aims at the step's first real target with that
    token's value, so it changes nothing where the JAX scatter drops it.
    Then:

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

    def __init__(self, cache: PagedKVCache, mode: str, pg, sl, src,
                 lens=None, tables=None, q_lens=None, prefix_lens=None):
        if mode not in ("prefill", "prefix", "ragged"):
            raise ValueError(f"unknown paged attention mode {mode!r}")
        self.cache = cache
        self.mode = mode
        self.pg, self.sl, self.src = pg, sl, src
        self.lens = lens
        self.tables = tables
        self.q_lens = q_lens
        self.prefix_lens = prefix_lens
        self.layer_idx = 0

    def _store(self, pool, vals) -> None:
        """Scatter (b * s, kv_heads, last) values at every target."""
        _scatter_pages(pool, self.pg, self.sl,
                       vals.index_select(0, self.src).transpose(0, 1))

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


class _Staging:
    """Named tensors laid out in one byte buffer on the host — pinned
    when the device is a card — and its twin on the device, so a step's
    inputs go up, and its outputs come down, in one copy each.  On the
    CPU the two are one buffer.  ``fields`` is ((name, shape, dtype),
    ...); ``host`` holds numpy views, ``dev`` tensor views."""

    def __init__(self, fields, device):
        offsets, size = [], 0
        for _name, shape, dtype in fields:
            offsets.append(size)
            size += -(-math.prod(shape) * dtype.itemsize // 16) * 16
        card = device.type == "cuda"
        self._host = torch.empty(max(size, 16), dtype=torch.uint8,
                                 pin_memory=card)
        self._dev = (torch.empty_like(self._host, device=device) if card
                     else self._host)
        self._done = torch.cuda.Event() if card else None

        def views(buf):
            return {name: buf[o:o + math.prod(shape) * dtype.itemsize]
                    .view(dtype).view(shape)
                    for (name, shape, dtype), o in zip(fields, offsets)}

        self.host = {k: t.numpy() for k, t in views(self._host).items()}
        self.dev = views(self._dev)

    def upload(self) -> None:
        """The host buffer to the device, not waited on: the step's work
        follows on the same stream."""
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)

    def download(self) -> dict:
        """The device buffer to the host, waited on; returns copies."""
        if self._done is not None:
            self._host.copy_(self._dev, non_blocking=True)
            self._done.record(torch.cuda.current_stream(self._dev.device))
            self._done.synchronize()
        return {k: v.copy() for k, v in self.host.items()}


def _inputs(mode, kind, rows, span, width):
    """The staged inputs of a step: ids, the write plan (targets and
    sources), the mode's lengths and tables, and the draw's per-row
    seeds, temperatures and flags (with the counters where the host
    knows them: prefill and prefix)."""
    i32, i64 = torch.int32, torch.int64
    n = rows * span
    f = [("ids", (rows, span), i64), ("pg", (n,), i64), ("sl", (n,), i64),
         ("src", (n,), i64)]
    if mode == "ragged":
        f += [("ctx", (rows,), i32), ("ql", (rows,), i32),
              ("nd", (rows,), i32), ("tables", (rows, width), i32)]
    else:
        f.append(("last", (rows,), i64))
    if mode == "prefix":
        f += [("tables", (rows, width), i32), ("plens", (rows,), i32)]
    if kind == "draw":
        f += [("seeds", (rows,), i64), ("temps", (rows,), torch.float32),
              ("flags", (rows,), torch.bool)]
        if mode != "ragged":
            f.append(("ctrs", (rows,), i64))
    return f


def _plan_writes(host, plans, span):
    """Fill the staged write plan from each real row's (pages, slots):
    real positions are their own sources, pads (the rest of a row, and
    pad rows) aim at flat position 0's target — the step's first real
    token — and take its value."""
    pg, sl, src = (host[k].reshape(-1, span) for k in ("pg", "sl", "src"))
    pg[:] = plans[0][0][0]
    sl[:] = plans[0][1][0]
    src[:] = 0
    for i, (rpg, rsl) in enumerate(plans):
        n = len(rpg)
        pg[i, :n] = rpg
        sl[i, :n] = rsl
        src[i, :n] = np.arange(i * span, i * span + n)


class PagedDecoder:
    """The serving steps over a :class:`PagedKVCache`: whole-prompt
    prefill, prefix/chunk prefill and the ragged unified step.  Every
    step plans its page writes on the host into the staging buffer of
    its bucket (kept from call to call), runs its device body eagerly,
    and on any failure rolls the sequences' lengths back to where the
    step found them.

    ``min_table_pages`` floors the page-table width of the ragged and
    prefix steps (``max(next_pow2(pages), min_table_pages)``, as in
    ``JittedPagedDecoder``): pinned at the pool's worst case it gives
    one width, and so one bucket, for every context length.

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

    #: CUDA graphs captured and replayed (``GraphedPagedDecoder``); the
    #: eager decoder makes none
    captures = 0
    replays = 0

    def __init__(self, model, quantize: Optional[str] = None,
                 min_table_pages: int = 1):
        if quantize not in SERVING_QUANT_MODES:
            raise ValueError(
                f"quantize must be one of {SERVING_QUANT_MODES}, got "
                f"{quantize!r}")
        self.model = model
        self.max_position = int(model.config.max_position_embeddings)
        self.vocab = int(model.config.vocab_size)
        self.device = model.model.embed_tokens.weight.device
        self.quantize = quantize
        self.min_table_pages = max(1, int(min_table_pages))
        self._quant = (quantize_linear_weights(model,
                                               fuse=quantize == "w8a8")
                       if quantize else [])
        # (mode, tail kind, bucket) -> (inputs, outputs) staging buffers
        self._staging = {}

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
    def _stage(self, key):
        """The (inputs, outputs) staging buffers of a step's key."""
        st = self._staging.get(key)
        if st is None:
            mode, kind, rows, span = key[:4]
            width = key[4] if len(key) > 4 else 0
            out = ([("out", (rows,), torch.int32)] if kind
                   else [("out", (rows, self.vocab), torch.float32)])
            if mode == "ragged":
                out.append(("accept", (rows,), torch.int32))
            st = self._staging[key] = (
                _Staging(_inputs(mode, kind, rows, span, width),
                         self.device),
                _Staging(out, self.device))
        return st

    def _execute(self, cache, key, body) -> None:
        """Run a step's device body over its staged tensors: eagerly."""
        with self._armed():
            body()

    def _run(self, cache, key, fill, body) -> dict:
        """One step: ``fill(host views)`` plans it, the inputs go up in
        one copy, ``body(dev inputs, dev outputs)`` runs, the outputs
        come back in one copy."""
        inp, out = self._stage(key)
        fill(inp.host)
        inp.upload()
        self._execute(cache, key, lambda: body(inp.dev, out.dev))
        return out.download()

    @staticmethod
    def _tail(kind, logits, d, ctrs):
        """(rows, vocab) f32 logits -> the step's output, by tail kind."""
        if kind == "draw":
            return fused_sample(logits, d["seeds"], ctrs, d["temps"],
                                d["flags"])
        if kind == "greedy":
            return logits.argmax(dim=-1).to(torch.int32)
        return logits

    def _last_logits(self, hidden, last):
        """f32 logits of each row's last real position (bucketed prompts
        are right-padded past it)."""
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        return self.model._logits_of(hidden[rows, last]).float()

    @staticmethod
    def _fill_sampling(h, sampling, with_ctrs):
        """Stage the draw's (seeds, [ctrs,] temps, flags); pad rows draw
        nothing (flag off, temperature 1)."""
        seeds, *rest = sampling
        ctrs, temps, flags = rest if with_ctrs else (None, *rest)
        n = len(flags)
        h["seeds"][:] = 0
        h["temps"][:] = 1
        h["flags"][:] = False
        h["seeds"][:n] = np.asarray(seeds, np.uint32)
        h["temps"][:n] = np.asarray(temps, np.float32)
        h["flags"][:n] = np.asarray(flags, bool)
        if with_ctrs:
            h["ctrs"][:n] = np.asarray(ctrs, np.int32)

    @staticmethod
    def _rollback_lengths(cache, seq_ids, before) -> None:
        """Undo a failed step's ``advance`` (its pages stay mapped)."""
        for sid, n in zip(seq_ids, before):
            cache.truncate(sid, n)

    # ------------------------------------------------------ device bodies
    def _prompt_body(self, cache, kind):
        """Device body of a prefill (``"prefill"``) or prefix/chunk
        (``"prefix"``) step over the staged (rows, span) prompt."""
        def body(d, o):
            if "plens" in d:
                ctx = PagedContext(cache, "prefix", d["pg"], d["sl"],
                                   d["src"], tables=d["tables"],
                                   prefix_lens=d["plens"])
                # the prefix length doubles as the per-row rope offset
                pos = d["plens"]
            else:
                ctx = PagedContext(cache, "prefill", d["pg"], d["sl"],
                                   d["src"])
                pos = 0
            hidden = self.model.model(d["ids"], pos, paged_ctx=ctx)
            logits = self._last_logits(hidden, d["last"])
            o["out"].copy_(self._tail(kind, logits, d, d.get("ctrs")))
        return body

    def _ragged_body(self, cache, kind):
        """Device body of a ragged step (the JAX ragged program,
        ``paddle_tpu/inference/paged.py:741-812``): accept counts, the
        output position and the draw counters on the device."""
        def body(d, o):
            ids, ctx, ql, nd = d["ids"], d["ctx"], d["ql"], d["nd"]
            paged = PagedContext(cache, "ragged", d["pg"], d["sl"],
                                 d["src"], lens=ctx + ql,
                                 tables=d["tables"], q_lens=ql)
            hidden = self.model.model(ids, ctx, paged_ctx=paged)
            lg = self.model._logits_of(hidden).float()       # (B, S, V)
            targets = lg.argmax(dim=-1)
            # verify-row accept arithmetic, gated to the first nd
            # positions so chunk/decode rows (nd == 0) accept nothing
            j = torch.arange(1, ids.shape[1], device=ids.device)[None, :]
            match = ((ids[:, 1:] == targets[:, :-1])
                     & (j <= nd[:, None])).long()
            accept = match.cumprod(dim=1).sum(dim=1)         # (B,)
            # the row's output position: its last real token, or the
            # bonus position of a verify row
            sel = ql.long() - 1 - nd.long() + accept
            rows = torch.arange(ids.shape[0], device=ids.device)
            if kind == "greedy":
                o["out"].copy_(targets[rows, sel])
            else:
                # the draw's counter: the emitted token's absolute
                # position
                ctrs = ctx.long() + ql.long() - nd.long() + accept
                o["out"].copy_(self._tail(kind, lg[rows, sel], d, ctrs))
            o["accept"].copy_(accept)
        return body

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
        kind = _tail_kind(None if sampling is None else sampling[3])

        def fill(h):
            h["ids"][:] = 0
            h["ids"][:, :s] = ids_np
            _plan_writes(h, list(zip(pg.reshape(b, s), sl.reshape(b, s))),
                         s_b)
            h["last"][:] = s - 1
            if kind == "draw":
                self._fill_sampling(h, sampling, True)

        try:
            return self._run(cache, ("prefill", kind, b, s_b), fill,
                             self._prompt_body(cache, kind))["out"]
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
        # the context may end mid-page (chunked prefill): gather the
        # partial page too; attention masks columns past k
        n_pre = -(-k // cache.page_size)
        width = max(next_pow2(n_pre), self.min_table_pages)
        kind = _tail_kind(None if sampling is None else sampling[3])

        def fill(h):
            h["ids"][:] = 0
            h["ids"][:, :s] = ids_np
            _plan_writes(h, list(zip(pg.reshape(b, s), sl.reshape(b, s))),
                         s_b)
            h["last"][:] = s - 1
            h["tables"][:] = 0
            for i, sid in enumerate(seq_ids):
                h["tables"][i, :n_pre] = cache._seq_pages[sid][:n_pre]
            h["plens"][:] = k
            if kind == "draw":
                self._fill_sampling(h, sampling, True)

        try:
            return self._run(cache, ("prefix", kind, b, s_b, width), fill,
                             self._prompt_body(cache, kind))["out"]
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
        change no page.  Page allocation is all-or-nothing across the
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
        plans = []
        for sid, n in zip(seq_ids, ns):
            plans.append(cache.plan_write([sid], n))
            cache.advance([sid], n)
        needed = max(len(cache._seq_pages.get(sid, ())) for sid in seq_ids)
        width = max(next_pow2(needed), self.min_table_pages)
        kind = _tail_kind(None if sampling is None else sampling[2])

        def fill(h):
            h["ids"][:] = 0
            for i, (row, n) in enumerate(zip(rows, ns)):
                h["ids"][i, :n] = np.asarray(row, np.int32)
            _plan_writes(h, plans, s_b)
            h["tables"][:] = 0
            for i, sid in enumerate(seq_ids):
                t = cache._seq_pages[sid]
                h["tables"][i, :len(t)] = t
            # pad rows: a 1-token span at context 0, no draft
            h["ctx"][:] = 0
            h["ctx"][:b] = before
            h["ql"][:] = 1
            h["ql"][:b] = ns
            h["nd"][:] = 0
            h["nd"][:b] = nds
            if kind == "draw":
                self._fill_sampling(h, sampling, False)

        try:
            got = self._run(cache, ("ragged", kind, b_b, s_b, width), fill,
                            self._ragged_body(cache, kind))
        except BaseException:
            self._rollback_lengths(cache, seq_ids, before)
            raise
        return got["out"][:b], got["accept"][:b]


class GraphedPagedDecoder(PagedDecoder):
    """:class:`PagedDecoder` whose steps are CUDA graphs: the port's
    ``JittedPagedDecoder``.  It keeps one ``torch.cuda.CUDAGraph`` per
    (mode, tail kind, bucket) — (rows, span, table width) for the ragged
    and prefix steps, (rows, span) for prefill — captured lazily, as
    ``jax.jit`` compiles lazily.  The first call of a bucket runs its body
    eagerly on the real inputs (that call is the step) and then captures
    it, which executes nothing; later calls copy their inputs into the
    bucket's staging buffer and replay.  Every graph draws on one memory
    pool, and between steps only the staged inputs and outputs stay
    alive.

    A graph holds the addresses of the cache's pools, the model's weights
    and the int8 twins, so a decoder serves the one cache it first
    stepped (``PagedKVCache.reset_pools`` zeroes the pools in place).
    ``captures`` and ``replays`` count graphs, the counterpart of the
    JAX engine's ``jit_recompile_count``: steady serving captures none.
    A replay runs no Python, so each kernel wrapper's ``launches`` grows
    by what its capture counted (the capture's own count is taken back:
    it launched nothing).  There is no fallback: a capture or replay
    that fails raises."""

    def __init__(self, model, quantize: Optional[str] = None,
                 min_table_pages: int = 1):
        super().__init__(model, quantize=quantize,
                         min_table_pages=min_table_pages)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need the model on a card, it "
                             f"lives on {self.device}")
        self.captures = 0
        self.replays = 0
        self._cache = None
        # key -> (graph, {kernel wrapper: launches a replay})
        self._graphs = {}
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(self.device)

    def _execute(self, cache, key, body) -> None:
        if self._cache is None:
            self._cache = cache
        elif cache is not self._cache:
            raise ValueError("a GraphedPagedDecoder serves the one cache "
                             "its graphs were captured over")
        entry = self._graphs.get(key)
        if entry is not None:
            graph, launches = entry
            graph.replay()
            for fn, n in launches.items():
                fn.launches += n
            self.replays += 1
            return
        # the bucket's first call: the step itself, eagerly, on the
        # stream the capture uses (so its lazy set-up happens there)
        here = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(here)
        with torch.cuda.stream(self._stream), self._armed():
            body()
        here.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        with self._armed():
            _out, launches = capture(graph, self._pool, self._stream, body)
        self._graphs[key] = (graph, launches)
        self.captures += 1
