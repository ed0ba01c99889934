"""Paged-KV serving steps for causal LMs (port of
paddle_tpu/inference/paged.py: the prefill, prefix/chunk, batched
context, decode, verify, multi-step and ragged programs, the fused
sampling tail, quantized serving — int8 weights through the armed
``Linear`` hook, int8 KV pages — the eager oracle and
``PagedGenerator``).

Each step comes in two parts.  The host plans it — page allocation, the
(page, slot) write targets, page tables, the bucket's pads — into the
bucket's staging buffer (:class:`_Staging`: one byte buffer, pinned on a
card), which reaches the device in one copy.  The step's device body then
runs the model over the staged tensors: every shape is the bucket's, the
KV write has the bucket's length, the accept counts, output positions and
draw counters are computed on the device, and the outputs come back in
one copy.  The JAX package's buckets are kept — power-of-two batch and
span buckets, pad rows of context 0 and span 1, right-padded prompts,
the page-table width ``max(next_pow2(pages), min_table_pages)``; the
decode, verify and multi-step batches are not bucketed, as there.

:class:`PagedDecoder` runs the bodies eagerly; :class:`GraphedPagedDecoder`
captures each (mode, tail kind, bucket) once as a CUDA graph and replays
it, the counterpart of ``JittedPagedDecoder``'s compiled programs.
:class:`EagerPagedContext` is the JAX package's eager oracle, which no
step uses: the tests hold the device bodies against it.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..cuda_graphs import capture
# under its old name here, where the card tests read it
from ..cuda_graphs import counted_wrappers as _counted_wrappers  # noqa: F401
from ..ops.flash_attention import DEFAULT_MASK_VALUE, flash_attention_bshd
from ..ops.paged_attention import (PagedKVCache, PagesExhausted,
                                   _gather_dequant,
                                   _scatter_pages, dequantize_kv,
                                   paged_attention, paged_attention_multi,
                                   paged_attention_ragged, quantize_kv)
from ..quantization.serving import (SERVING_QUANT_MODES,
                                    quantize_linear_weights)
from ..testing import faults as _faults
from . import _threefry


def next_pow2(n: int) -> int:
    """Smallest power of two >= n: the bucketing rule for prompt length,
    page-table width and batch size."""
    b = 1
    while b < n:
        b *= 2
    return b


def _buffer_loss(seq_ids) -> Optional[BaseException]:
    """The ``buffer_loss`` device-fault site (JAX ``_maybe_lose_buffers``),
    fired once a step just before its body: the error a rule raised
    there, or None.  The step then zeroes the cache's pools in place
    (``reset_pools``: ``generation`` bumps and the prefix index is
    dropped) and re-raises it, which loses every sequence's KV as a real
    device-side step fault would, so the engine must replay the
    survivors.  The JAX decoder deletes its donated buffers and rebuilds
    them; the port's pools are never donated, and zeroing them keeps
    their addresses, so the CUDA graphs captured over them stay valid.
    No plan installed: one ``is None`` check."""
    if _faults.active() is None:
        return None
    try:
        _faults.maybe_fire("buffer_loss", seq_ids=list(seq_ids))
    except BaseException as exc:
        return exc
    return None


def _row_parallel(model) -> list:
    """The row-parallel Linears of a LLaMA (o and down of every layer)."""
    return [lin for layer in model.model.layers
            for lin in (layer.self_attn.o_proj, layer.mlp.down_proj)]


def _tp_plan(model, tp: int):
    """Megatron-style tensor-parallel plan for a LLaMA-shaped serving
    model over ``tp`` ranks (JAX ``_tp_plan``,
    ``paddle_tpu/inference/paged.py:71-126``).

    Column-parallel (output features cut; dim 0 of the port's [out, in]
    weights): q/k/v and the MLP's gate/up, so each rank computes its own
    heads and its own slice of the intermediate activations with no
    communication.  Row-parallel (input features cut, dim 1): o and down,
    whose matmuls give partial sums that one sum over the ranks closes a
    block half (``_make_tp_reduce``).  Everything else (norms, embedding,
    head) stays whole on every rank, so the logits and the sampling tail
    run replicated after the reduce.

    Returns ``{parameter name: the dim its shard is cut along}`` for the
    cut parameters (the others are whole).  Raises ValueError for a
    model that is not LLaMA-shaped, heads, kv heads or an intermediate
    size that ``tp`` does not divide, or a row-parallel projection with
    a bias (each rank's bias would be summed ``tp`` times)."""
    layers = getattr(getattr(model, "model", None), "layers", None)
    if not layers or not all(hasattr(getattr(layer, "mlp", None),
                                     "gate_proj") for layer in layers):
        raise ValueError(
            "tensor-parallel serving needs a LLaMA-shaped model "
            "(model.model.layers with self_attn/mlp blocks)")
    dims = {}
    for i, layer in enumerate(layers):
        attn, mlp = layer.self_attn, layer.mlp
        if attn.num_heads % tp or attn.num_kv_heads % tp:
            raise ValueError(
                f"layer {i}: num_heads ({attn.num_heads}) and "
                f"num_kv_heads ({attn.num_kv_heads}) must divide the "
                f"tensor-parallel degree ({tp})")
        if mlp.gate_proj.out_features % tp:
            raise ValueError(
                f"layer {i}: intermediate_size "
                f"({mlp.gate_proj.out_features}) must divide the "
                f"tensor-parallel degree ({tp})")
        p = f"model.layers.{i}."
        for name in ("self_attn.q_proj", "self_attn.k_proj",
                     "self_attn.v_proj", "mlp.gate_proj", "mlp.up_proj"):
            lin = layer.get_submodule(name)
            dims[p + name + ".weight"] = 0
            if lin.bias is not None:
                dims[p + name + ".bias"] = 0
        for name in ("self_attn.o_proj", "mlp.down_proj"):
            if layer.get_submodule(name).bias is not None:
                raise ValueError(
                    "row-parallel projections must be bias-free under "
                    "tensor parallelism")
            dims[p + name + ".weight"] = 1
    return dims


def _make_tp_reduce(collectives, quant: bool):
    """The collective closing each row-parallel block half (JAX
    ``_make_tp_reduce``, ``paddle_tpu/inference/paged.py:552-586``): a sum
    all-reduce in the partial sums' own type, or with ``quant`` the int8
    variant: absmax-scale the local partial sum to int8 (``scale =
    max(amax, 1e-8) / 127``, ``clip(round(x / scale), -127, 127)``),
    all-gather the int8 codes and the f32 scales, then dequantize and
    sum locally in ``x``'s type: a rank moves 8/tp times fewer bytes than
    in an f32 ring all-reduce (4x at tp=2), at the cost of one absmax
    rounding a block half.  ``collectives`` is the group's
    (:class:`~paddle_tpu_torch.distributed.tensor_parallel.Collectives`);
    every call counts in its ``reduces``."""
    tp = collectives.tp

    def reduce(x):
        collectives.reduces += 1
        return collectives.all_reduce(x)

    def quant_reduce(x):
        collectives.reduces += 1
        scale = x.abs().amax().float().clamp_min(1e-8) / 127.0
        q = torch.clamp(torch.round(x.float() / scale), -127.0,
                        127.0).to(torch.int8)
        qg = collectives.all_gather(q)                    # (tp, ...) int8
        sg = collectives.all_gather(scale.reshape(1))     # (tp, 1) f32
        return (qg.to(x.dtype)
                * sg.to(x.dtype).reshape((tp,) + (1,) * x.ndim)).sum(dim=0)

    return quant_reduce if quant else reduce


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
      is the span length);
    - ``"decode"``: one token a row (s == 1) over its pages, through
      ``paged_attention`` (``lens`` counts the token just written);
    - ``"verify"``: an s-token block a row over its pages, through
      ``paged_attention_multi`` (``lens`` counts the whole block).

    A decode or verify batch has no pad position.  In the int8 KV mode
    the write quantizes per slot and head and stores the scales beside
    the values, and prefill attends the round-tripped K/V, so every
    consumer sees exactly what the pages hold.
    """

    def __init__(self, cache: PagedKVCache, mode: str, pg, sl, src,
                 lens=None, tables=None, q_lens=None, prefix_lens=None):
        if mode not in ("prefill", "prefix", "ragged", "decode", "verify"):
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
        mode; the other modes read the pages instead)."""
        b, s, kvh, d = x.shape
        flat = x.reshape(b * s, kvh, d)
        if not self.cache.kv_quant:
            self._store(pages[layer], flat)
            return x
        x8, sc = quantize_kv(flat)
        self._store(pages[layer], x8)
        self._store(scales[layer], sc)
        if self.mode not in ("prefill", "prefix"):
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
        if self.mode == "decode":
            return paged_attention(q[:, 0], kp, vp, self.lens, self.tables,
                                   k_scales=ks, v_scales=vs)[:, None]
        if self.mode == "verify":
            return paged_attention_multi(q, kp, vp, self.lens, self.tables,
                                         k_scales=ks, v_scales=vs)
        return paged_attention_ragged(q, kp, vp, self.lens, self.q_lens,
                                      self.tables, k_scales=ks, v_scales=vs)


class EagerPagedContext:
    """The eager oracle, the JAX package's ``_PagedContext``
    (``paddle_tpu/inference/paged.py:216-262``): a per-forward attention
    context over a :class:`PagedKVCache` whose host bookkeeping runs
    inside the forward.  Each layer appends its K/V through
    ``cache.write_batch`` (the last layer's write advances the lengths);
    prefill then runs causal flash attention over the batch's own
    (round-tripped, in the int8 mode) K/V, and decode runs
    ``paged_attention`` over the sequences' page tables, counting the
    token just written below the last layer.  No step runs it: the steps'
    device bodies (:class:`PagedContext`) are held against it.  Allocate
    the sequences' pages before the forward."""

    def __init__(self, cache: PagedKVCache, seq_ids, prefill: bool):
        self.cache = cache
        self.seq_ids = list(seq_ids)
        self.prefill = prefill
        self.layer_idx = 0

    def attend(self, q, k, v):
        """q/k/v (batch, s, heads, head_dim) post-rope; returns
        (batch, s, q_heads, head_dim)."""
        cache, layer = self.cache, self.layer_idx
        cache.write_batch(layer, self.seq_ids, k, v)
        if self.prefill:
            if cache.kv_quant:
                k, v = (dequantize_kv(*quantize_kv(t), t.dtype)
                        for t in (k, v))
            return flash_attention_bshd(q, k, v, causal=True)
        tables, lens = cache.page_table(self.seq_ids)
        if layer < cache.num_layers - 1:
            lens = lens + k.shape[1]
        scales = ((cache.k_scales[layer], cache.v_scales[layer])
                  if cache.kv_quant else (None, None))
        return paged_attention(q[:, 0], cache.k_pages[layer],
                               cache.v_pages[layer], lens, tables,
                               k_scales=scales[0],
                               v_scales=scales[1])[:, None]


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
    sources), the mode's positions, lengths and tables, and the draw's
    per-row seeds, temperatures and flags (with the counters where the
    host knows them: prefill, prefix and decode).

    A multi-step run (``"multi"``, ``span`` its power-of-two step bucket)
    stages its whole plan, one row of targets and positions a step, with
    the token it carries (``ids``) and its step counter (``i``): the
    upload resets both, and each replay of the step reads row ``i``."""
    i32, i64 = torch.int32, torch.int64
    if mode == "multi":
        return [("ids", (rows, 1), i64), ("i", (1,), i64),
                ("src", (rows,), i64), ("pg", (span, rows), i64),
                ("sl", (span, rows), i64), ("pos", (span, rows), i32),
                ("tables", (rows, width), i32)]
    n = rows * span
    f = [("ids", (rows, span), i64), ("pg", (n,), i64), ("sl", (n,), i64),
         ("src", (n,), i64)]
    if mode == "ragged":
        f += [("ctx", (rows,), i32), ("ql", (rows,), i32),
              ("nd", (rows,), i32), ("tables", (rows, width), i32)]
    elif mode in ("decode", "verify"):
        f += [("pos", (rows,), i32), ("lens", (rows,), i32),
              ("tables", (rows, width), i32)]
    else:
        f.append(("last", (rows,), i64))
    if mode == "prefix":
        f += [("tables", (rows, width), i32), ("plens", (rows,), i32)]
    if kind == "draw":
        f += [("seeds", (rows,), i64), ("temps", (rows,), torch.float32),
              ("flags", (rows,), torch.bool)]
        if mode not in ("ragged", "verify"):
            f.append(("ctrs", (rows,), i64))
    return f


def _fill_tables(host, cache, seq_ids):
    """Stage each sequence's whole page table, zero past its pages (pad
    rows: all zeros)."""
    host["tables"][:] = 0
    for i, sid in enumerate(seq_ids):
        pages = cache._seq_pages[sid]
        host["tables"][i, :len(pages)] = pages


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
    prefill, prefix/chunk and batched context prefill, the ragged
    unified step, and the decode, verify and multi-step programs.  Every
    step plans its page writes on the host into the staging buffer of
    its bucket (kept from call to call) and runs its device body
    eagerly.

    The failure contract (the counterpart of the JAX package's
    ``_recover_pools``): the pools are written in place and never
    donated, so there is nothing to rebuild.  A step that fails before
    its body — in planning, staging or the upload — has changed no page,
    and every step, wherever it fails, rolls its sequences' lengths back
    to where it found them; pages it allocated stay mapped, as in JAX,
    and a retry rewrites their slots.  The one exception is the injected
    ``buffer_loss`` fault (``_buffer_loss``), fired once a step just
    before its body: it zeroes every pool in place, and the engine
    replays the survivors' KV.

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
    at the same time.

    ``tp_group`` (a ``distributed.tensor_parallel.TensorParallelGroup``)
    serves the model tensor-parallel (``_tp_plan``): the decoder steps
    its rank-0 shard (``models.convert.shard_model``; the caller's model
    is left as it is), each worker its own, and the row-parallel Linears
    are armed with the block-closing sum for the duration of each step
    (``_make_tp_reduce``; ``tp_quant_collectives`` for the int8 one).  At
    the ``_run`` seam rank 0 plans a step, broadcasts its header and
    staged bytes, and every rank uploads and runs the same body over its
    shard and its pool shard; after each block's reduce the hidden state
    is the same on every rank, so the logits, the accept arithmetic and
    the sampling tail are too, and only rank 0 downloads.  The steps run
    eagerly on every backend (gloo collectives cannot be captured in a
    CUDA graph).  ``quantize`` does not compose with it, as in JAX."""

    #: CUDA graphs captured and replayed (``GraphedPagedDecoder``); the
    #: eager decoder makes none
    captures = 0
    replays = 0

    def __init__(self, model, quantize: Optional[str] = None,
                 min_table_pages: int = 1, tp_group=None,
                 tp_quant_collectives: bool = False):
        if quantize not in SERVING_QUANT_MODES:
            raise ValueError(
                f"quantize must be one of {SERVING_QUANT_MODES}, got "
                f"{quantize!r}")
        self.tp_group = tp_group
        self.tp = 1 if tp_group is None else tp_group.tp
        self.tp_quant_collectives = bool(tp_quant_collectives
                                         and tp_group is not None)
        self._tp_row_layers, self._tp_reduce_fn = [], None
        if tp_group is not None:
            if quantize is not None:
                raise ValueError(
                    "quantize='w8'/'w8a8' does not compose with tensor "
                    "parallelism: the int8 weight twins are calibrated per "
                    "whole out-channel and the int8 matmul kernels serve "
                    "one card (kv_quant='int8' does compose)")
            _tp_plan(model, self.tp)
            where = model.model.embed_tokens.weight.device
            if where != tp_group.device:
                raise ValueError(f"the model lives on {where}, rank 0 of "
                                 f"the group on {tp_group.device}")
            from ..models.convert import shard_model
            self._tp_handle = tp_group.add_decoder(
                model, min_table_pages, self.tp_quant_collectives)
            model = shard_model(model, self.tp, 0)
        self.model = model
        if tp_group is not None:
            self._set_tp(_make_tp_reduce(tp_group.collectives,
                                         self.tp_quant_collectives))
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

    def _set_tp(self, reduce_fn) -> None:
        """Make this decoder's model (a rank's shard) close each
        row-parallel block with ``reduce_fn`` while it steps."""
        self._tp_row_layers = _row_parallel(self.model)
        self._tp_reduce_fn = reduce_fn

    @contextlib.contextmanager
    def _armed(self):
        """Arm every quantized Linear with its twin for one step, and in
        w8a8 every module with its fused twin (q|k|v, gate|up: one
        activation quantized once, one matmul); under tensor parallelism
        arm every row-parallel Linear with the block-closing reduce;
        cleared on the way out, on failure too."""
        for layer, w_q, scale in self._quant:
            layer._serving_quant = (self.quantize, w_q, scale)
        for layer in self._tp_row_layers:
            layer._tp_reduce = self._tp_reduce_fn
        try:
            yield
        finally:
            for layer, _w_q, _scale in self._quant:
                layer._serving_quant = None
            for layer in self._tp_row_layers:
                layer._tp_reduce = None

    # ---------------------------------------------------------- helpers
    def _stage(self, key):
        """The (inputs, outputs) staging buffers of a step's key."""
        st = self._staging.get(key)
        if st is None:
            mode, kind, rows, span = key[:4]
            width = key[4] if len(key) > 4 else 0
            if mode == "multi":
                out = [("out", (span, rows), torch.int32)]
            elif kind:
                out = [("out", (rows,), torch.int32)]
            else:
                out = [("out", (rows, self.vocab), torch.float32)]
            if mode in ("ragged", "verify"):
                out.append(("accept", (rows,), torch.int32))
            st = self._staging[key] = (
                _Staging(_inputs(mode, kind, rows, span, width),
                         self.device),
                _Staging(out, self.device))
        return st

    def _execute(self, cache, key, body, n: int = 1) -> None:
        """Run a step's device body ``n`` times over its staged tensors:
        eagerly."""
        with self._armed():
            for _ in range(n):
                body()

    def _body(self, cache, key):
        """The device body of a step's key (``_run``'s, and a
        tensor-parallel worker's for the header it receives)."""
        mode, kind = key[0], key[1]
        if mode in ("prefill", "prefix"):
            return self._prompt_body(cache, kind)
        if mode == "ragged":
            return self._ragged_body(cache, kind)
        if mode == "multi":
            return self._multi_body(cache)
        return self._span_body(cache, mode, kind)

    def _run(self, cache, seq_ids, key, fill, n: int = 1) -> dict:
        """One step of ``seq_ids``: ``fill(host views)`` plans it, the
        ``buffer_loss`` site fires, the inputs go up in one copy, the
        key's body (``_body``: dev inputs, dev outputs) runs (``n`` times
        in a row for a multi-step run, with no host read between), the
        outputs come back in one copy.  Under tensor parallelism the
        header (key, ``n``, whether the site fired) and the staged bytes
        go to every worker before the upload; a fired site zeroes every
        rank's pools and no rank runs the body."""
        g = self.tp_group
        if cache.tp_group is not g:
            raise ValueError("a decoder steps a cache sharded over its own "
                             "tensor-parallel group (or neither sharded)")
        inp, out = self._stage(key)
        fill(inp.host)
        lost = _buffer_loss(seq_ids)
        if g is not None:
            g.step(self._tp_handle, cache._tp_handle, key, n,
                   lost is not None, inp._host)
        inp.upload()
        if lost is not None:
            cache._reset_local()
            raise lost
        body = self._body(cache, key)
        with g.guard() if g is not None else contextlib.nullcontext():
            self._execute(cache, key, lambda: body(inp.dev, out.dev), n)
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

    def _table_width(self, cache, seq_ids) -> int:
        """Page-table width of a step whose sequences' pages are all
        allocated: ``max(next_pow2(pages), min_table_pages)``."""
        needed = max(len(cache._seq_pages.get(sid, ())) for sid in seq_ids)
        return max(next_pow2(needed), self.min_table_pages)

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

    def _accept_tail(self, kind, ids, lg, ctx, ql, nd, d, o) -> None:
        """The accept counts and the emitted output of a ragged or verify
        step, on the device: ids (B, S) the staged spans, lg (B, S, V)
        their f32 logits, ctx/ql/nd (B,) each row's cached context, span
        length and draft count (a verify row: the whole block, S - 1
        drafts)."""
        targets = lg.argmax(dim=-1)
        # verify-row accept arithmetic, gated to the first nd positions
        # so chunk/decode rows (nd == 0) accept nothing
        j = torch.arange(1, ids.shape[1], device=ids.device)[None, :]
        match = ((ids[:, 1:] == targets[:, :-1])
                 & (j <= nd[:, None])).long()
        accept = match.cumprod(dim=1).sum(dim=1)             # (B,)
        # the row's output position: its last real token, or the bonus
        # position of a verify row
        sel = ql.long() - 1 - nd.long() + accept
        rows = torch.arange(ids.shape[0], device=ids.device)
        if kind == "greedy":
            o["out"].copy_(targets[rows, sel])
        else:
            # the draw's counter: the emitted token's absolute position
            ctrs = ctx.long() + ql.long() - nd.long() + accept
            o["out"].copy_(self._tail(kind, lg[rows, sel], d, ctrs))
        o["accept"].copy_(accept)

    def _ragged_body(self, cache, kind):
        """Device body of a ragged step (the JAX ragged program,
        ``paddle_tpu/inference/paged.py:741-812``): accept counts, the
        output position and the draw counters on the device."""
        def body(d, o):
            ids, ctx, ql, nd = d["ids"], d["ctx"], d["ql"], d["nd"]
            paged = PagedContext(cache, "ragged", d["pg"], d["sl"],
                                 d["src"], lens=ctx + ql,
                                 tables=d["tables"], q_lens=ql)
            # a draft of -1 (a row that proposed nothing) never matches;
            # its embedding reads row 0, and only positions the row's
            # accept count of 0 discards see it
            hidden = self.model.model(ids.clamp_min(0), ctx,
                                      paged_ctx=paged)
            lg = self.model._logits_of(hidden).float()       # (B, S, V)
            self._accept_tail(kind, ids, lg, ctx, ql, nd, d, o)
        return body

    def _span_body(self, cache, mode, kind):
        """Device body of a decode step (the JAX "decode" program,
        ``paddle_tpu/inference/paged.py:645-663``) or a verify step (its
        "verify" program, ``:705-753``): a verify block is a full-span
        ragged row — S tokens, S - 1 of them drafts — so its accept
        counts, bonus position and draw counter (pos + accept + 1) come
        from the ragged step's arithmetic."""
        def body(d, o):
            ids, pos = d["ids"], d["pos"]
            paged = PagedContext(cache, mode, d["pg"], d["sl"], d["src"],
                                 lens=d["lens"], tables=d["tables"])
            # -1 drafts embed as id 0 (see _ragged_body)
            hidden = self.model.model(
                ids.clamp_min(0) if mode == "verify" else ids, pos,
                paged_ctx=paged)
            lg = self.model._logits_of(hidden).float()       # (B, S, V)
            if mode == "decode":
                o["out"].copy_(self._tail(kind, lg[:, -1], d, d.get("ctrs")))
                return
            ql = torch.full_like(pos, ids.shape[1])
            self._accept_tail(kind, ids, lg, pos, ql, ql - 1, d, o)
        return body

    def _multi_body(self, cache):
        """Device body of one greedy step of a multi-step run (the body
        of the JAX ``lax.scan``, ``paddle_tpu/inference/paged.py:1330-1346``):
        the step counter ``i`` picks row ``i`` of the staged targets and
        positions, the carried token is embedded, attention sees
        ``pos + 1`` tokens, and the argmax goes to row ``i`` of the output
        and into the carry; then ``i`` advances.  Nothing here comes from
        the host, so a replay needs no upload and no read back."""
        def body(d, o):
            i = d["i"]
            pos = d["pos"].index_select(0, i)[0]
            paged = PagedContext(cache, "decode",
                                 d["pg"].index_select(0, i)[0],
                                 d["sl"].index_select(0, i)[0], d["src"],
                                 lens=pos + 1, tables=d["tables"])
            hidden = self.model.model(d["ids"], pos, paged_ctx=paged)
            nxt = self.model._logits_of(hidden)[:, -1].float().argmax(dim=-1)
            o["out"].index_copy_(0, i, nxt[None].to(torch.int32))
            d["ids"].copy_(nxt[:, None])
            i.add_(1)
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
            return self._run(cache, seq_ids, ("prefill", kind, b, s_b),
                             fill)["out"]
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
            return self._run(cache, seq_ids,
                             ("prefix", kind, b, s_b, width), fill)["out"]
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
        width = self._table_width(cache, seq_ids)
        kind = _tail_kind(None if sampling is None else sampling[2])

        def fill(h):
            h["ids"][:] = 0
            for i, (row, n) in enumerate(zip(rows, ns)):
                h["ids"][i, :n] = np.asarray(row, np.int32)
            _plan_writes(h, plans, s_b)
            _fill_tables(h, cache, seq_ids)
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
            got = self._run(cache, seq_ids,
                            ("ragged", kind, b_b, s_b, width), fill)
        except BaseException:
            self._rollback_lengths(cache, seq_ids, before)
            raise
        return got["out"][:b], got["accept"][:b]

    @torch.no_grad()
    def batch_context_prefill(self, cache: PagedKVCache, seq_ids, rows, ks,
                              sampling=None) -> np.ndarray:
        """Batched context prefill (JAX ``batch_context_prefill``):
        ingest ``rows[i]`` (a 1-D int32 token slice) for ``seq_ids[i]``
        whose cached context length is ``ks[i]`` in one step of the
        ``"prefix"`` body, with a prefix length and rope offset a row; a
        row with ``ks[i] == 0`` is a fresh prefill.  The batch pads to a
        power of two with rows of prefix length 0 that draw nothing, the
        span to ``min(next_pow2(max span), max_position - max(ks))``
        (never below the longest span), so it shares graphs with
        :meth:`prefix_prefill` and :meth:`chunk_prefill`.  Returns the
        last real token's output per row: ids under ``sampling=(seeds,
        ctrs, temps, flags)``, logits otherwise."""
        b = len(seq_ids)
        ns = [len(r) for r in rows]
        if b == 0 or min(ns) < 1:
            raise ValueError("every row needs at least one token")
        before = []
        for sid, k, n in zip(seq_ids, ks, ns):
            if cache.length(sid) != int(k):
                raise ValueError(
                    f"sequence {sid!r} is at length {cache.length(sid)}, "
                    f"expected the cached context length {k}")
            if int(k) + n > self.max_position:
                raise ValueError(
                    f"context {k} + chunk {n} exceeds "
                    f"max_position_embeddings ({self.max_position})")
            before.append(int(k))
            cache.allocate(sid, n)
        s_b = max(max(ns),
                  min(next_pow2(max(ns)),
                      self.max_position - max(int(k) for k in ks)))
        b_b = next_pow2(b)
        plans = []
        for sid, n in zip(seq_ids, ns):
            plans.append(cache.plan_write([sid], n))
            cache.advance([sid], n)
        n_pre = [-(-int(k) // cache.page_size) for k in ks]
        width = max(next_pow2(max(1, max(n_pre))), self.min_table_pages)
        kind = _tail_kind(None if sampling is None else sampling[3])

        def fill(h):
            h["ids"][:] = 0
            for i, (row, n) in enumerate(zip(rows, ns)):
                h["ids"][i, :n] = np.asarray(row, np.int32)
            _plan_writes(h, plans, s_b)
            h["last"][:] = 0
            h["last"][:b] = [n - 1 for n in ns]
            h["tables"][:] = 0
            for i, (sid, npg) in enumerate(zip(seq_ids, n_pre)):
                h["tables"][i, :npg] = cache._seq_pages[sid][:npg]
            h["plens"][:] = 0
            h["plens"][:b] = before
            if kind == "draw":
                self._fill_sampling(h, sampling, True)

        try:
            got = self._run(cache, seq_ids,
                            ("prefix", kind, b_b, s_b, width), fill)
        except BaseException:
            self._rollback_lengths(cache, seq_ids, before)
            raise
        return got["out"][:b]

    @torch.no_grad()
    def step(self, cache: PagedKVCache, seq_ids, tokens_np, positions_np,
             sampling=None) -> np.ndarray:
        """One decode token for every sequence (JAX ``step``): tokens_np
        (batch, 1) int32, positions_np (batch,) each row's current length.
        The batch is not bucketed.  Returns the last logits (batch,
        vocab) f32, or with ``sampling=(seeds, ctrs, temps, flags)`` the
        next ids (batch,) int32 drawn on the device."""
        positions_np = np.asarray(positions_np)
        if int(positions_np.max()) + 1 > self.max_position:
            raise ValueError(
                f"decode position {int(positions_np.max()) + 1} exceeds "
                f"max_position_embeddings ({self.max_position})")
        for sid in seq_ids:
            cache.allocate(sid, 1)
        return self._span_step("decode", cache, seq_ids,
                               np.asarray(tokens_np).reshape(-1, 1),
                               positions_np, sampling)["out"]

    @torch.no_grad()
    def verify(self, cache: PagedKVCache, seq_ids, block_np, positions_np,
               sampling=None):
        """Speculative verify (JAX ``verify``): score a (batch, S) block,
        each row's last fed token followed by S - 1 draft proposals, at
        positions_np (batch,), each row's current length.  All S
        positions are written and the lengths advance by S; the caller
        rolls a row back to its verified length with
        ``cache.truncate(sid, pos + accept + 1)``, and the pages stay
        mapped.  Returns ``(out, accept)``: ``accept`` (batch,) the
        leading drafts the model reproduced, computed on the device;
        ``out`` the bonus token ids under ``sampling=(seeds, temps,
        flags)`` (a sampled row draws at position pos + accept + 1), or
        the bonus position's logits (batch, vocab) f32 without."""
        block_np = np.asarray(block_np)
        positions_np = np.asarray(positions_np)
        s = block_np.shape[1]
        if int(positions_np.max()) + s > self.max_position:
            raise ValueError(
                f"verify through position {int(positions_np.max()) + s} "
                f"exceeds max_position_embeddings ({self.max_position})")
        cache.allocate_batch_atomic(seq_ids, s)
        got = self._span_step("verify", cache, seq_ids, block_np,
                              positions_np, sampling)
        return got["out"], got["accept"]

    def _span_step(self, mode, cache, seq_ids, block, positions, sampling):
        """A decode or verify step over pages already allocated: plan the
        (batch, s) block's writes, advance, run the body at table width
        ``max(next_pow2(pages), min_table_pages)``."""
        b, s = block.shape
        before = [cache.length(sid) for sid in seq_ids]
        pg, sl = cache.plan_write(seq_ids, s)
        cache.advance(seq_ids, s)
        width = self._table_width(cache, seq_ids)
        kind = _tail_kind(None if sampling is None else sampling[-1])

        def fill(h):
            h["ids"][:] = block
            _plan_writes(h, list(zip(pg.reshape(b, s), sl.reshape(b, s))),
                         s)
            h["pos"][:] = positions
            h["lens"][:] = [cache.length(sid) for sid in seq_ids]
            _fill_tables(h, cache, seq_ids)
            if kind == "draw":
                self._fill_sampling(h, sampling, mode == "decode")

        try:
            return self._run(cache, seq_ids, (mode, kind, b, s, width),
                             fill)
        except BaseException:
            self._rollback_lengths(cache, seq_ids, before)
            raise

    @torch.no_grad()
    def multi_step(self, cache: PagedKVCache, seq_ids, tokens_np,
                   positions_np, n_steps: int) -> np.ndarray:
        """``n_steps`` greedy tokens a sequence (JAX ``multi_step``):
        tokens_np (batch,) the last token of each row, positions_np
        (batch,) each row's current length.  Pages for every step are
        reserved up front, all or nothing (:class:`PagesExhausted` leaves
        nothing reserved); one
        table covers the final length and step j attends ``pos + j + 1``
        tokens.  The whole (steps, batch) plan goes up in one copy, padded
        to ``next_pow2(n_steps)`` rows that never run; one step body is
        run ``n_steps`` times — on a card, one CUDA graph replayed with no
        host read between replays — carrying its token and step counter
        on the device, and the tokens come back in one copy.  Returns
        (batch, n_steps) int32."""
        positions_np = np.asarray(positions_np)
        b, n = len(seq_ids), int(n_steps)
        if n < 1:
            raise ValueError(f"n_steps must be >= 1, got {n}")
        if int(positions_np.max()) + n > self.max_position:
            raise ValueError(
                f"decode through position {int(positions_np.max()) + n} "
                f"exceeds max_position_embeddings ({self.max_position})")
        before = [cache.length(sid) for sid in seq_ids]
        cache.allocate_batch_atomic(seq_ids, n)
        pg, sl = cache.plan_write(seq_ids, n)
        cache.advance(seq_ids, n)
        width = self._table_width(cache, seq_ids)

        def fill(h):
            h["ids"][:, 0] = np.asarray(tokens_np).reshape(-1)
            h["i"][:] = 0
            h["src"][:] = np.arange(b)
            for k, v in (("pg", pg), ("sl", sl),
                         ("pos", positions_np[:, None] + np.arange(n))):
                h[k][:] = 0
                h[k][:n] = v.reshape(b, n).T
            _fill_tables(h, cache, seq_ids)

        try:
            got = self._run(cache, seq_ids,
                            ("multi", "greedy", b, next_pow2(n), width),
                            fill, n)
        except BaseException:
            self._rollback_lengths(cache, seq_ids, before)
            raise
        return np.ascontiguousarray(got["out"][:n].T)


class GraphedPagedDecoder(PagedDecoder):
    """:class:`PagedDecoder` whose steps are CUDA graphs: the port's
    ``JittedPagedDecoder``.  It keeps one ``torch.cuda.CUDAGraph`` per
    (mode, tail kind, bucket) — (rows, span, table width) for the ragged,
    prefix, decode and verify steps, (rows, span) for prefill, (rows,
    step bucket, table width) for a multi-step run — captured lazily, as
    ``jax.jit`` compiles lazily.  The first call of a bucket runs its body
    eagerly on the real inputs (that call is the step) and then captures
    it, which executes nothing; later calls copy their inputs into the
    bucket's staging buffer and replay.  A multi-step run of N steps
    replays its one-step graph N times in a row (N - 1 on its first
    call), counting N replays.  Every graph draws on one memory pool, and
    between steps only the staged inputs and outputs stay alive.

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

    def _execute(self, cache, key, body, n: int = 1) -> None:
        if self._cache is None:
            self._cache = cache
        elif cache is not self._cache:
            raise ValueError("a GraphedPagedDecoder serves the one cache "
                             "its graphs were captured over")
        entry = self._graphs.get(key)
        if entry is None:
            # the bucket's first call: the step itself, eagerly, on the
            # stream the capture uses (so its lazy set-up happens there)
            here = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(here)
            with torch.cuda.stream(self._stream), self._armed():
                body()
            here.wait_stream(self._stream)
            graph = torch.cuda.CUDAGraph()
            with self._armed():
                _out, launches = capture(graph, self._pool, self._stream,
                                         body)
            entry = self._graphs[key] = (graph, launches)
            self.captures += 1
            n -= 1
        graph, launches = entry
        for _ in range(n):
            graph.replay()
        for fn, count in launches.items():
            fn.launches += count * n
        self.replays += n


class PagedGenerator:
    """Batched greedy or sampled decoding over a shared page pool (the
    JAX package's ``PagedGenerator``)::

        gen = PagedGenerator(model, total_pages=512, page_size=16)
        out_ids = gen.generate(input_ids, max_new_tokens=64)

    ``device`` is where the model lives (``"cuda"`` by default, as the
    engine's): on a card the steps are CUDA graphs
    (:class:`GraphedPagedDecoder`), on the CPU the eager
    :class:`PagedDecoder`.  A model elsewhere, or ``"cuda"`` without a
    card, raises.  The prefill is one step that returns logits.  Greedy
    generation decodes in :meth:`PagedDecoder.multi_step` chunks of
    ``min(next_pow2(remaining), 64, max_position - pos)`` tokens and, where
    a chunk's pages cannot be reserved, goes on one :meth:`PagedDecoder.step`
    a token; eos is applied afterwards.  Sampling runs one step a token
    that returns logits and draws on the host from
    ``np.random.default_rng(seed)`` (``sample_token``), as JAX does."""

    def __init__(self, model, total_pages: int = 256, page_size: int = 16,
                 quantize: Optional[str] = None,
                 kv_dtype: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        weight = model.model.embed_tokens.weight
        if weight.device != self.device:
            raise ValueError(f"the model lives on {weight.device}, the "
                             f"generator was asked for {self.device}")
        self.model = model
        self._next_seq = 0
        self.cache = PagedKVCache.from_model(
            model, total_pages=total_pages, page_size=page_size,
            kv_dtype=kv_dtype)
        decoder = (GraphedPagedDecoder if self.device.type == "cuda"
                   else PagedDecoder)
        self._decoder = decoder(model, quantize=quantize)
        # wall seconds of the last generate()'s prefill and decode
        self.last_prefill_seconds = 0.0
        self.last_decode_seconds = 0.0

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 seed: int = 0) -> np.ndarray:
        """input_ids (batch, prompt) ints (an array or a tensor); returns
        (batch, prompt + generated) token ids as a numpy array.  The
        batch's pages are freed on the way out, on failure too."""
        ids = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                         else input_ids)
        b = ids.shape[0]
        seq_ids = list(range(self._next_seq, self._next_seq + b))
        self._next_seq += b
        rng = np.random.default_rng(seed)
        try:
            return self._generate(ids, seq_ids, max_new_tokens,
                                  eos_token_id, do_sample, temperature, rng)
        finally:
            for sid in seq_ids:
                self.cache.free(sid)

    def _generate(self, ids, seq_ids, max_new_tokens, eos_token_id,
                  do_sample, temperature, rng):
        b, s = ids.shape
        dec = self._decoder
        t0 = time.perf_counter()
        step = dec.prefill(self.cache, seq_ids, ids.astype(np.int32))
        self.last_prefill_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = [ids]
        if (not do_sample and max_new_tokens > 1
                and s + max_new_tokens <= dec.max_position):
            first = step.argmax(axis=-1).astype(np.int32)
            pieces = [first[:, None]]
            cur, pos, remaining = first, s, max_new_tokens - 1
            done = (first == eos_token_id) if eos_token_id is not None \
                else None
            # power-of-two chunks (the last one rounded up and cut), so
            # any length replays a bounded set of graphs; a chunk whose
            # pages cannot be reserved (nothing is left reserved) hands
            # over to one step a token from where the chunks stopped
            while remaining > 0:
                if done is not None and done.all():
                    break
                n = min(next_pow2(remaining), 64, dec.max_position - pos)
                try:
                    chunk = dec.multi_step(self.cache, seq_ids, cur,
                                           np.full(b, pos, np.int32), n)
                except PagesExhausted:
                    break
                pieces.append(chunk[:, :remaining])
                if done is not None:
                    done |= (pieces[-1] == eos_token_id).any(axis=1)
                cur = chunk[:, -1].astype(np.int32)
                pos += n
                remaining -= n
            while remaining > 0:
                if done is not None and done.all():
                    break
                logits = dec.step(self.cache, seq_ids, cur[:, None],
                                  np.full(b, pos, np.int32))
                cur = logits.argmax(axis=-1).astype(np.int32)
                pieces.append(cur[:, None])
                if done is not None:
                    done |= cur == eos_token_id
                pos += 1
                remaining -= 1
            gen = np.concatenate(pieces, axis=1)
            if eos_token_id is not None:
                hit = gen == eos_token_id
                after = (np.cumsum(hit, axis=1) - hit.astype(int)) > 0
                gen = np.where(after, eos_token_id, gen)
                # the stepwise width: up to the step where the last row
                # finished
                alldone = (np.cumsum(hit, axis=1) > 0).all(axis=0)
                if alldone.any():
                    gen = gen[:, :int(np.argmax(alldone)) + 1]
            out.append(gen.astype(ids.dtype))
            self.last_decode_seconds = time.perf_counter() - t0
            return np.concatenate(out, axis=1)

        finished = np.zeros(b, bool)
        pos = s
        for _ in range(max_new_tokens):
            nxt = np.array([sample_token(row, do_sample, temperature, rng)
                            for row in step])
            if eos_token_id is not None:
                nxt = np.where(finished, eos_token_id, nxt)
                finished |= nxt == eos_token_id
            out.append(nxt[:, None].astype(ids.dtype))
            if eos_token_id is not None and finished.all():
                break
            step = dec.step(self.cache, seq_ids, out[-1].astype(np.int32),
                            np.full(b, pos, np.int32))
            pos += 1
        self.last_decode_seconds = time.perf_counter() - t0
        return np.concatenate(out, axis=1)
