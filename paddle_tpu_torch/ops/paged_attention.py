"""Paged attention and the paged KV cache.

Port of paddle_tpu/ops/pallas/paged_attention.py without the
tensor-parallel mesh.  ``paged_attention``, ``paged_attention_multi`` and
``paged_attention_ragged`` share the CUDA kernels of
``csrc/paged_attention.cu`` (its header says what they replace, what
bounds them and how they are laid out), split over the context by
:func:`plan_splits`, and take their plain twins of the JAX package's XLA
oracles for CPU tensors.  ``_split_plain`` is the twin of the kernels'
split-and-merge arithmetic, for the tests.  Each takes ``k_scales`` and
``v_scales`` for the int8 KV mode: pages of int8 values with one f32
scale per slot and head, dequantized by :func:`dequantize_kv`.

The page allocator (:class:`PagedKVCache`) is host-side bookkeeping; the
page pools live on the cache's device and are updated in place.  Taking a
page from the free list fires the ``page_alloc`` fault site
(``testing.faults``), as in the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _build
from .flash_attention import DEFAULT_MASK_VALUE
from .quant_matmul import dynamic_act_quant
from .._device import resolve_device
from ..testing import faults as _faults


class PagesExhausted(RuntimeError):
    """The page pool cannot provide the pages an allocation needs, even
    after evicting every reclaimable prefix-cache entry."""


# --------------------------------------------------------- int8 KV quant
def quantize_kv(x):
    """Symmetric int8 quantization of K/V appends: per token and head,
    absmax over head_dim.  x (..., d) float -> (q int8 (..., d), scale
    f32 (..., 1)).  Scales are per slot because pages are append-only.
    The same rule as :func:`quant_matmul.dynamic_act_quant`."""
    return dynamic_act_quant(x)


def dequantize_kv(q, scale, dtype):
    """Invert :func:`quantize_kv`: int8 values times f32 scales, cast to
    the compute ``dtype`` — the one dequant rule of every consumer (the
    gathers here, the kernel's staging, the pages' round trip)."""
    return (q.float() * scale).to(dtype)


# ------------------------------------------------------------ plain twins
def _gather_dequant(pages, scales, page_tables, dtype):
    """Pages (kv_heads, total, page, d) gathered through (batch, W)
    tables to (batch, kv_heads, W * page, d); with ``scales`` (the int8
    mode's (kv_heads, total, page, 1) pool) dequantized per slot right
    after the gather."""
    def g(pool):
        kv_heads, _tot, page_size, last = pool.shape
        batch, width = page_tables.shape
        got = pool[:, page_tables.long()]          # (kvh, b, W, page, last)
        return got.permute(1, 0, 2, 3, 4).reshape(
            batch, kv_heads, width * page_size, last)

    if scales is not None:
        return dequantize_kv(g(pages), g(scales), dtype)
    return g(pages).to(dtype)


def _gathered_kv(q_heads, k_pages, v_pages, page_tables, dtype,
                 k_scales=None, v_scales=None):
    """Table-indexed K and V pages, (batch, q_heads, T, d): kv heads
    repeated over their query group."""
    k = _gather_dequant(k_pages, k_scales, page_tables, dtype)
    v = _gather_dequant(v_pages, v_scales, page_tables, dtype)
    group = q_heads // k_pages.shape[0]
    if group != 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    return k, v


def _span_attention(q, k, v, limit, scale):
    """Dense attention of q (b, nq, qh, d) over gathered k/v (b, qh, T, d)
    with per-row, per-query column limits broadcastable to
    (b, 1, nq, 1).  Masked columns contribute exact zeros."""
    qt = q.transpose(1, 2)
    s = torch.einsum("bhsd,bhtd->bhst", qt.float(), k.float()) * scale
    cols = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    s = torch.where(cols < limit, s, DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(), v.float())
    return out.transpose(1, 2).to(q.dtype)


def _decode_plain(q, k_pages, v_pages, lengths, page_tables, scale,
                  k_scales=None, v_scales=None):
    """Twin of ``_decode_xla``: one query per row, q (b, q_heads, d),
    attending cols < length."""
    k, v = _gathered_kv(q.shape[1], k_pages, v_pages, page_tables, q.dtype,
                        k_scales, v_scales)
    limit = lengths.long()[:, None, None, None]
    return _span_attention(q[:, None], k, v, limit, scale)[:, 0]


def _multi_plain(q, k_pages, v_pages, lengths, page_tables, scale,
                 k_scales=None, v_scales=None):
    """Twin of ``_multi_xla``: q (b, nq, q_heads, d); query s of the
    block attends cols < length - (nq - 1 - s)."""
    n_query = q.shape[1]
    k, v = _gathered_kv(q.shape[2], k_pages, v_pages, page_tables, q.dtype,
                        k_scales, v_scales)
    qpos = torch.arange(n_query, device=q.device)[None, None, :, None]
    limit = lengths.long()[:, None, None, None] - (n_query - 1 - qpos)
    return _span_attention(q, k, v, limit, scale)


def _ragged_plain(q, k_pages, v_pages, lengths, q_lens, page_tables,
                  scale, k_scales=None, v_scales=None):
    """Twin of ``_ragged_xla``: row b's real queries sit left-aligned in
    the bucket, query j attends cols < min(kv, kv - q_len + 1 + j); pad
    queries clamp at kv and compute values the caller discards."""
    n_query = q.shape[1]
    k, v = _gathered_kv(q.shape[2], k_pages, v_pages, page_tables, q.dtype,
                        k_scales, v_scales)
    qpos = torch.arange(n_query, device=q.device)[None, None, :, None]
    kv = lengths.long()[:, None, None, None]
    ql = q_lens.long()[:, None, None, None]
    return _span_attention(q, k, v, torch.minimum(kv, kv - ql + 1 + qpos),
                           scale)


def _split_plain(q, k_pages, v_pages, lengths, q_lens, page_tables, scale,
                 split_tokens, k_scales=None, v_scales=None):
    """Twin of the kernel's split-KV algebra, for the tests: the columns
    ``[0, W * page_size)`` cut into splits of ``split_tokens``; each split
    keeps (m, l, acc) over its visible columns (m = -inf and l = 0 where
    it sees none, p rounded to the compute type before p @ v), and the
    partials merge split by split in order, each weighted by
    exp(m - max m).  Pad queries (j >= q_len) and rows with len == 0 come
    back as zeros, as from the kernel; q (b, max_q, q_heads, d)."""
    n_query = q.shape[1]
    k, v = _gathered_kv(q.shape[2], k_pages, v_pages, page_tables, q.dtype,
                        k_scales, v_scales)
    s = torch.einsum("bhsd,bhtd->bhst", q.transpose(1, 2).float(),
                     k.float()) * scale
    qpos = torch.arange(n_query, device=q.device)[None, None, :, None]
    kv = lengths.long()[:, None, None, None]
    ql = q_lens.long()[:, None, None, None]
    limit = torch.minimum(kv, kv - ql + 1 + qpos)
    cols = torch.arange(k.shape[2], device=q.device)
    parts = []
    for lo in range(0, k.shape[2], split_tokens):
        hi = min(lo + split_tokens, k.shape[2])
        si = torch.where(cols[lo:hi] < limit, s[..., lo:hi], -math.inf)
        m = si.amax(dim=-1, keepdim=True)
        p = torch.exp(si - torch.where(m == -math.inf, 0.0, m))
        acc = torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype).float(),
                           v[:, :, lo:hi].float())
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    top = torch.where(top == -math.inf, 0.0, top)
    l_sum = torch.zeros_like(parts[0][1])
    a_sum = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.where(m == -math.inf, 0.0, torch.exp(m - top))
        l_sum = l_sum + f * l
        a_sum = a_sum + f * acc
    out = torch.where(l_sum == 0, 0.0, a_sum / torch.where(l_sum == 0, 1.0,
                                                            l_sum))
    real = (qpos < ql) & (kv > 0)
    return torch.where(real, out, 0.0).transpose(1, 2).to(q.dtype)


# ------------------------------------------------------------- the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: columns a context split covers, before the planner stretches it
SPLIT_TOKENS = 256
#: the most pages a split covers: a block keeps its split's table
#: entries in shared memory
MAX_SPLIT_PAGES = 2048
#: blocks an SM past which the planner stops splitting
BLOCKS_PER_SM = 16
#: a bucket of this many queries or more (a prefill chunk) takes one
#: split
CHUNK_QUERIES = 64
_SM_COUNT: Dict[int, int] = {}


def block_rows(dtype, rows):
    """Query rows of one kernel block, from the rows of a (row, kv head)
    pair (``max_q * group``): bf16 takes the tensor-core kernel (64 rows)
    from 16 rows, below that the CUDA-core kernel of 1 or 4 rows (eight
    lanes a token) or 16; f32 always the 16-row CUDA-core kernel."""
    if dtype != torch.bfloat16:
        return 16
    if rows >= 16:
        return 64
    return 1 if rows == 1 else 4 if rows <= 4 else 16


def plan_splits(batch, max_q, q_heads, kv_heads, head_dim, table_width,
                page_size, rows_per_block, sm_count):
    """(split_tokens, n_split) of a call, from its shapes alone (never
    the lengths, so the wrapper reads nothing back from the device).

    Splits of ``SPLIT_TOKENS`` columns (a multiple of ``page_size``) cover
    the table's ``table_width * page_size`` columns, so a decode batch of a
    few rows still gives every SM blocks.  Where the query rows alone
    already give the grid ``BLOCKS_PER_SM`` blocks an SM the splits grow
    (fewer, longer), and a bucket of ``CHUNK_QUERIES`` queries or more
    takes one split: no partials, no combine.  So the f32 partials (one
    row of head_dim per split, row and head) never pass those of about
    ``2 * BLOCKS_PER_SM * sm_count`` blocks."""
    split = -(-SPLIT_TOKENS // page_size)           # in pages
    n = -(-table_width // split)
    rows = max_q * (q_heads // kv_heads)
    blocks = batch * kv_heads * -(-rows // rows_per_block)
    n_use = 1 if max_q >= CHUNK_QUERIES else min(
        n, -(-BLOCKS_PER_SM * sm_count // blocks))
    n_use = max(n_use, -(-table_width // MAX_SPLIT_PAGES))
    if n_use < n:
        split = -(-table_width // n_use)
        n = -(-table_width // split)
    return split * page_size, n


def _sm_count(dev):
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def _lib():
    lib = _build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        i32 = ctypes.c_int
        lib.paged_attention_fwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
            i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, i32, i32, vp]
        lib.paged_attention_fwd.restype = i32
        lib.paged_attention_error_string.argtypes = [i32]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def paged_attention_cuda(q, k_pages, v_pages, lengths, q_lens, page_tables,
                         scale=None, k_scales=None, v_scales=None):
    """Launch the CUDA ragged paged-attention kernel.

    q (b, max_q, q_heads, d) f32/bf16 with d 64 or 128; pages
    (kv_heads, total_pages, page_size, d) of q's type, or int8 with
    ``k_scales``/``v_scales`` (kv_heads, total_pages, page_size, 1) f32;
    lengths, q_lens (b,) and page_tables (b, W) int32, all on one CUDA
    device.  Query j of row b attends cols < min(len, len - q_len + 1 +
    j); positions j >= q_len are bucket padding and come back as zeros.
    Every real row needs ``lengths[b] <= W * page_size`` and table
    entries below ``total_pages``: the kernel reads what the table
    names.  The context splits come from :func:`plan_splits`; nothing is
    read back to the host."""
    dev = q.device
    quant = k_scales is not None
    scales = (k_scales, v_scales) if quant else ()
    if dev.type != "cuda" or any(
            t.device != dev for t in (k_pages, v_pages, lengths, q_lens,
                                      page_tables, *scales)):
        raise ValueError("paged_attention_cuda needs every tensor on one "
                         "CUDA device")
    page_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _DTYPES or k_pages.dtype != page_dtype \
            or v_pages.dtype != page_dtype:
        raise ValueError(f"paged_attention_cuda takes f32 or bf16 q and "
                         f"pages of q's type (int8 with scales), got "
                         f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if quant and (v_scales is None or any(
            s.dtype != torch.float32
            or tuple(s.shape) != tuple(k_pages.shape[:3]) + (1,)
            for s in scales)):
        raise ValueError("paged_attention_cuda: int8 pages need f32 "
                         "k_scales and v_scales of shape (kv_heads, "
                         "total_pages, page_size, 1)")
    b, max_q, q_heads, d = q.shape
    kv_heads, total_pages, page_size, _d = k_pages.shape
    if d not in (64, 128) or _d != d or v_pages.shape != k_pages.shape \
            or q_heads % kv_heads or page_tables.shape[0] != b \
            or b * kv_heads > 65535:
        raise ValueError(f"paged_attention_cuda: unsupported shapes q "
                         f"{tuple(q.shape)} pages {tuple(k_pages.shape)} "
                         "(head_dim 64 or 128)")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q, kp, vp = q.contiguous(), k_pages.contiguous(), v_pages.contiguous()
    ks, vs = ((k_scales.contiguous(), v_scales.contiguous()) if quant
              else (kp, vp))          # ignored by the kernel without int8
    lens, qls, tabs = (t.to(torch.int32).contiguous()
                       for t in (lengths, q_lens, page_tables))
    out = torch.empty_like(q)
    if b == 0:
        return out
    width = tabs.shape[1]
    rows = max_q * (q_heads // kv_heads)
    per_block = block_rows(q.dtype, rows)
    split_tokens, n_split = plan_splits(b, max_q, q_heads, kv_heads, d,
                                        width, page_size, per_block,
                                        _sm_count(dev))
    part_acc = part_ml = out        # unused with one split
    if n_split > 1:
        n = n_split * b * kv_heads * rows
        part_acc = torch.empty(n * d, dtype=torch.float32, device=dev)
        part_ml = torch.empty(2 * n, dtype=torch.float32, device=dev)
    lib = _lib()
    status = lib.paged_attention_fwd(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), lens.data_ptr(), qls.data_ptr(), tabs.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), b, max_q,
        q_heads, kv_heads, d, page_size, total_pages, width, split_tokens,
        n_split, float(scale), _DTYPES[q.dtype], int(quant), per_block,
        _build.stream_ptr(dev))
    if status:
        raise RuntimeError("paged_attention kernel launch failed: "
                           + lib.paged_attention_error_string(status)
                           .decode())
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def paged_attention(q, k_pages, v_pages, lengths, page_tables, scale=None,
                    k_scales=None, v_scales=None):
    """Decode-step attention over a paged KV cache.

    q (batch, q_heads, head_dim), one new token per sequence already
    written to the pages; k/v_pages (kv_heads, total_pages, page_size,
    head_dim); lengths (batch,) valid cached tokens including the new
    one; page_tables (batch, max_pages_per_seq) int32; k/v_scales
    (kv_heads, total_pages, page_size, 1) f32 when the pages are int8."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _decode_plain(q, k_pages, v_pages, lengths, page_tables,
                             scale, k_scales, v_scales)
    ones = torch.ones_like(lengths, dtype=torch.int32)
    return paged_attention_cuda(q[:, None], k_pages, v_pages, lengths,
                                ones, page_tables, scale, k_scales,
                                v_scales)[:, 0]


def paged_attention_multi(q, k_pages, v_pages, lengths, page_tables,
                          scale=None, k_scales=None, v_scales=None):
    """Multi-query (speculative verify) attention: q (batch, n_query,
    q_heads, head_dim) whose K/V are already in the pages; query s
    attends cols < length - (n_query - 1 - s).  An ``n_query == 1`` call
    is exactly :func:`paged_attention`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] == 1:
        return paged_attention(q[:, 0], k_pages, v_pages, lengths,
                               page_tables, scale, k_scales,
                               v_scales)[:, None]
    if q.device.type == "cpu":
        return _multi_plain(q, k_pages, v_pages, lengths, page_tables, scale,
                            k_scales, v_scales)
    full = torch.full_like(lengths, q.shape[1], dtype=torch.int32)
    return paged_attention_cuda(q, k_pages, v_pages, lengths, full,
                                page_tables, scale, k_scales, v_scales)


def paged_attention_ragged(q, k_pages, v_pages, lengths, q_lens,
                           page_tables, scale=None, k_scales=None,
                           v_scales=None):
    """Ragged paged attention: rows with different query-span lengths —
    decode rows, prefill/chunk spans and verify blocks — in one call.

    q (batch, max_q, q_heads, head_dim), row b's ``q_lens[b]`` real
    queries left-aligned in the bucket; lengths (batch,) cached tokens
    including the row's whole span; query j attends
    cols < lengths[b] - q_lens[b] + j + 1.  A row whose span fills the
    bucket reproduces :func:`paged_attention_multi`'s verify mask, and a
    ``max_q == 1`` call is exactly :func:`paged_attention`.  On the CPU
    pad queries compute discarded values, as in the JAX package; the
    kernel writes zeros there.  Returns (batch, max_q, q_heads,
    head_dim).  ``k/v_scales`` mark int8 pages, as in
    :func:`paged_attention`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] == 1:
        return paged_attention(q[:, 0], k_pages, v_pages, lengths,
                               page_tables, scale, k_scales,
                               v_scales)[:, None]
    if q.device.type == "cpu":
        return _ragged_plain(q, k_pages, v_pages, lengths, q_lens,
                             page_tables, scale, k_scales, v_scales)
    return paged_attention_cuda(q, k_pages, v_pages, lengths, q_lens,
                                page_tables, scale, k_scales, v_scales)


# ------------------------------------------------------------- page cache
def _scatter_pages(pool, pages, slots, vals):
    """Write ``vals`` (kv_heads, n, d) into ``pool`` (kv_heads,
    total_pages, page_size, d) at (pages[i], slots[i]), in place — one
    ``index_put_`` for a whole step's writes.  Every index must be in
    range: where the JAX scatter drops writes aimed past the pool (the
    pad positions of a bucket), ``index_put_`` raises.  So a step writes
    all of its bucket's positions, each pad aimed at the step's first
    real target and carrying that token's value (``PagedContext``): the
    duplicates hold identical bytes, so the write stays deterministic,
    and its length is the bucket's, as a CUDA graph needs."""
    pool.permute(1, 2, 0, 3).index_put_(
        (pages, slots), vals.transpose(0, 1).to(pool.dtype))


class _PrefixEntry:
    """One cached page-aligned prompt prefix: the pages holding its KV
    plus the token count they cover.  The entry holds one index ref on
    every page, so the KV survives the registering sequence's retirement
    (evictable under pool pressure, LRU order)."""

    __slots__ = ("pages", "n_tokens")

    def __init__(self, pages: List[int], n_tokens: int):
        self.pages = pages
        self.n_tokens = n_tokens


class PagedKVCache:
    """Paged KV cache: per-layer page pools on the device plus host-side
    page-table bookkeeping, with refcounted pages and a prefix index.

    Layout per layer: (kv_heads, total_pages, page_size, head_dim).

    Pages carry two kinds of references: sequence refs (a live sequence
    maps the page) and index refs (a cached prompt prefix retains it).  A
    page returns to the free list only when both drop to zero.  Pages are
    append-only, so a full page whose tokens are a page-aligned prompt
    prefix can be shared read-only by any request with the same prefix.
    Index-retained pages with no sequence ref are evictable: ``allocate``
    reclaims them in LRU order under pool pressure, so they count as
    available capacity (``free_pages``).

    ``tp_group`` (a tensor-parallel group, see
    ``distributed.tensor_parallel``) shards every pool, data and scales,
    on its leading kv-head axis: this process (rank 0) holds
    ``kv_heads / tp`` heads' pools, and each worker allocates its own.
    The allocator, page tables, lengths and prefix index live here only:
    rank 0 plans every step.  ``kv_pool_bytes`` stays the whole pool's,
    ``kv_pool_bytes_per_chip`` is a rank's.
    """

    @classmethod
    def from_model(cls, model, total_pages: int = 256,
                   page_size: int = 16,
                   kv_dtype: Optional[str] = None,
                   tp_group=None) -> "PagedKVCache":
        """Cache sized for a causal LM's config, on its device and in
        its dtype; ``kv_dtype="int8"`` selects the quantized storage,
        ``tp_group`` shards the pools over a tensor-parallel group."""
        c = model.config
        w = model.model.embed_tokens.weight
        return cls(num_layers=c.num_hidden_layers,
                   kv_heads=c.num_key_value_heads,
                   head_dim=c.hidden_size // c.num_attention_heads,
                   total_pages=total_pages, page_size=page_size,
                   dtype=w.dtype, kv_dtype=kv_dtype, device=w.device,
                   tp_group=tp_group)

    def __init__(self, num_layers: int, kv_heads: int, head_dim: int,
                 total_pages: int = 256, page_size: int = 16,
                 dtype=torch.float32, kv_dtype: Optional[str] = None,
                 device="cuda", tp_group=None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        self.tp_group = tp_group
        self.tp = 1 if tp_group is None else tp_group.tp
        if kv_heads % self.tp:
            raise ValueError(
                f"kv_heads ({kv_heads}) must divide evenly over the "
                f"tensor-parallel group ({self.tp} ranks) to shard the "
                f"page pools on the head axis")
        self.num_layers = num_layers
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.page_size = page_size
        self.total_pages = total_pages
        # the int8 mode stores int8 pages beside per-slot f32 scale pools;
        # ``dtype`` stays the compute type attention dequantizes toward
        self.dtype = dtype
        self.kv_quant = kv_dtype == "int8"
        self.device = resolve_device(device)
        if tp_group is not None and self.device != tp_group.device:
            raise ValueError(f"the cache lives on {self.device}, rank 0 of "
                             f"the group on {tp_group.device}")
        self.k_pages: List[torch.Tensor] = []
        self.v_pages: List[torch.Tensor] = []
        self.k_scales: List[torch.Tensor] = []
        self.v_scales: List[torch.Tensor] = []
        self._alloc_pools()
        self._free: List[int] = list(range(total_pages))
        self._seq_pages: Dict[object, List[int]] = {}
        self._seq_len: Dict[object, int] = {}
        # page -> refcount, split by holder kind: PINNED while a sequence
        # maps it, EVICTABLE while only the prefix index retains it
        self._seq_refs: Dict[int, int] = {}
        self._idx_refs: Dict[int, int] = {}
        # page-aligned prefix hash-chain key -> entry, oldest first
        self._prefix_index: "OrderedDict[bytes, _PrefixEntry]" = \
            OrderedDict()
        self.prefix_evictions = 0
        # bumped every time reset_pools rebuilds the pools zeroed
        self.generation = 0
        if tp_group is not None:
            self._tp_handle = tp_group.add_cache(
                num_layers=num_layers, kv_heads=kv_heads // self.tp,
                head_dim=head_dim, total_pages=total_pages,
                page_size=page_size, dtype=dtype, kv_dtype=kv_dtype)

    def _alloc_pools(self) -> None:
        def pools(last, dtype):
            shape = (self.kv_heads // self.tp, self.total_pages,
                     self.page_size, last)
            return [torch.zeros(shape, dtype=dtype, device=self.device)
                    for _ in range(self.num_layers)]

        store = torch.int8 if self.kv_quant else self.dtype
        self.k_pages = pools(self.head_dim, store)
        self.v_pages = pools(self.head_dim, store)
        if self.kv_quant:
            self.k_scales = pools(1, torch.float32)
            self.v_scales = pools(1, torch.float32)

    @property
    def kv_pool_bytes(self) -> int:
        """Resident bytes of the KV data pages across all layers (and
        all ranks of a tensor-parallel group)."""
        return self.tp * sum(t.numel() * t.element_size()
                             for t in self.k_pages + self.v_pages)

    @property
    def kv_pool_bytes_per_chip(self) -> int:
        """A rank's resident bytes of the KV data pages: the whole pool
        over the tensor-parallel degree (``kv_pool_bytes`` on one
        card)."""
        return self.kv_pool_bytes // self.tp

    @property
    def kv_scale_bytes(self) -> int:
        """Resident bytes of the int8 mode's scale pools (0 when the
        cache stores full-precision KV), all ranks'."""
        return self.tp * sum(t.numel() * t.element_size()
                             for t in self.k_scales + self.v_scales)

    # ------------------------------------------------------- bookkeeping
    def _decref_seq(self, page: int) -> bool:
        """Drop one sequence ref; True if the page became unpinned."""
        n = self._seq_refs[page] - 1
        if n:
            self._seq_refs[page] = n
            return False
        del self._seq_refs[page]
        if page not in self._idx_refs:
            self._free.append(page)
        return True

    def _decref_idx(self, page: int) -> None:
        n = self._idx_refs[page] - 1
        if n:
            self._idx_refs[page] = n
            return
        del self._idx_refs[page]
        if page not in self._seq_refs:
            self._free.append(page)

    def _evict_prefixes(self, n_pages: int) -> None:
        """Drop prefix entries in LRU order until ``n_pages`` pages are
        free (or nothing more is reclaimable).  Entries whose pages are
        all pinned by live sequences are skipped: dropping them frees
        nothing."""
        for key in list(self._prefix_index):
            if len(self._free) >= n_pages:
                break
            entry = self._prefix_index[key]
            if all(p in self._seq_refs for p in entry.pages):
                continue
            del self._prefix_index[key]
            self.prefix_evictions += 1
            for p in entry.pages:
                self._decref_idx(p)

    def _pop_free_page(self) -> int:
        _faults.maybe_fire("page_alloc")
        if not self._free:
            self._evict_prefixes(1)
        if not self._free:
            raise PagesExhausted(
                f"PagedKVCache out of pages ({self.total_pages} x "
                f"{self.page_size} tokens); free() finished sequences or "
                "grow total_pages")
        p = self._free.pop()
        self._seq_refs[p] = 1
        return p

    def allocate_batch_atomic(self, seq_ids, n_tokens) -> None:
        """Reserve pages for more tokens on every sequence, or none at
        all: a mid-batch exhaustion rolls back this call's reservations
        before re-raising.  ``n_tokens`` is one count for the batch or
        one count per sequence."""
        seq_ids = list(seq_ids)
        if isinstance(n_tokens, (int, np.integer)):
            counts = [int(n_tokens)] * len(seq_ids)
        else:
            counts = [int(n) for n in n_tokens]
        before = {sid: len(self._seq_pages.get(sid, ()))
                  for sid in seq_ids}
        try:
            for sid, n in zip(seq_ids, counts):
                self.allocate(sid, n)
        except PagesExhausted:
            for sid in seq_ids:
                pages = self._seq_pages.get(sid, [])
                while len(pages) > before[sid]:
                    self._decref_seq(pages.pop())
            raise

    def allocate(self, seq_id, n_tokens: int) -> None:
        """Reserve pages so the sequence can hold ``n_tokens`` more
        tokens; evictable prefix pages are reclaimed LRU-first before
        this raises :class:`PagesExhausted`."""
        pages = self._seq_pages.setdefault(seq_id, [])
        need_total = -(-(self._seq_len.get(seq_id, 0) + n_tokens)
                       // self.page_size)
        while len(pages) < need_total:
            pages.append(self._pop_free_page())

    def free(self, seq_id) -> int:
        """Release the sequence's refs on its pages; returns how many
        pages stopped being pinned (newly free or newly evictable)."""
        released = 0
        for p in self._seq_pages.pop(seq_id, []):
            released += self._decref_seq(p)
        self._seq_len.pop(seq_id, None)
        return released

    def reset_pools(self) -> None:
        """Zero the pools in place (the scale pools too, in the int8
        mode; every rank's shard under tensor parallelism): their
        addresses and shapes stay, so the CUDA graphs a
        ``GraphedPagedDecoder`` captured over them stay valid.
        Bookkeeping survives, cached K/V does not, so the prefix index is
        dropped and ``generation`` bumps."""
        self._reset_local()
        if self.tp_group is not None:
            self.tp_group.reset_pools(self._tp_handle)

    def _zero_pools(self) -> None:
        for pool in self.k_pages + self.v_pages + self.k_scales \
                + self.v_scales:
            pool.zero_()

    def _reset_local(self) -> None:
        """:meth:`reset_pools` on this rank only (a step whose
        ``buffer_loss`` site fired tells the workers in its header)."""
        self.generation += 1
        self._zero_pools()
        while self._prefix_index:
            _, entry = self._prefix_index.popitem(last=False)
            for p in entry.pages:
                self._decref_idx(p)

    # ---------------------------------------------------- prefix caching
    def _usable_prefix_tokens(self, tokens: np.ndarray) -> int:
        """Longest page-aligned prefix a prompt may share: full pages
        only, and at least one prompt token stays un-shared so prefill
        still produces next-token logits."""
        return (len(tokens) - 1) // self.page_size * self.page_size

    def _prefix_keys(self, tokens: np.ndarray, n_pages: int) -> List[bytes]:
        """Index key per page-aligned prefix as an incremental hash
        chain, key_i = blake2b(key_{i-1} || page_i tokens): O(prompt)."""
        keys, h = [], b""
        ps = self.page_size
        for i in range(n_pages):
            h = hashlib.blake2b(h + tokens[i * ps:(i + 1) * ps].tobytes(),
                                digest_size=16).digest()
            keys.append(h)
        return keys

    def _lookup_prefix(self, tokens):
        """(key, entry) of the longest cached page-aligned prefix of
        ``tokens``, or None."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = self._usable_prefix_tokens(tokens)
        for key in reversed(self._prefix_keys(tokens, n // self.page_size)):
            entry = self._prefix_index.get(key)
            if entry is not None:
                return key, entry
        return None

    def probe_prefix(self, tokens) -> Tuple[int, int]:
        """(shared_tokens, newly_pinned_pages) for the longest cached
        prefix of ``tokens``, without acquiring it."""
        hit = self._lookup_prefix(tokens)
        if hit is None:
            return 0, 0
        _, entry = hit
        newly = sum(1 for p in entry.pages if p not in self._seq_refs)
        return entry.n_tokens, newly

    def acquire_prefix(self, seq_id, tokens) -> int:
        """Map the longest cached prefix of ``tokens`` into the fresh
        sequence ``seq_id`` read-only; returns the shared token count
        (0 on a miss)."""
        if seq_id in self._seq_pages:
            raise ValueError(f"sequence {seq_id!r} already has pages")
        hit = self._lookup_prefix(tokens)
        if hit is None:
            return 0
        key, entry = hit
        self._prefix_index.move_to_end(key)              # LRU touch
        for p in entry.pages:
            self._seq_refs[p] = self._seq_refs.get(p, 0) + 1
        self._seq_pages[seq_id] = list(entry.pages)
        self._seq_len[seq_id] = entry.n_tokens
        return entry.n_tokens

    def register_prefix(self, seq_id, tokens) -> int:
        """After ``seq_id``'s prompt KV is written, retain every
        page-aligned prefix of ``tokens`` in the index (one index ref per
        page per entry).  Idempotent; returns the number of new
        entries."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        pages = self._seq_pages.get(seq_id, [])
        added = 0
        n_pages = len(tokens) // self.page_size
        for i, key in enumerate(self._prefix_keys(tokens, n_pages), 1):
            if key in self._prefix_index:
                self._prefix_index.move_to_end(key)
                continue
            held = pages[:i]
            for p in held:
                self._idx_refs[p] = self._idx_refs.get(p, 0) + 1
            self._prefix_index[key] = _PrefixEntry(held,
                                                   i * self.page_size)
            added += 1
        return added

    def prefix_key_hex(self, tokens, n_tokens: int) -> Optional[str]:
        """Content hash (hex) of the page-aligned prefix covering
        ``n_tokens`` of ``tokens``, or None below one page: the key the
        journal's page-provenance records carry, which names the same
        prefix on every replica (page indices are local)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n_pages = int(n_tokens) // self.page_size
        if n_pages <= 0:
            return None
        return self._prefix_keys(tokens, n_pages)[-1].hex()

    @property
    def pinned_pages(self) -> int:
        """Pages currently mapped by at least one live sequence."""
        return len(self._seq_refs)

    @property
    def cached_prefix_pages(self) -> int:
        """Index-retained pages with no sequence ref (reclaimable)."""
        return sum(1 for p in list(self._idx_refs)
                   if p not in self._seq_refs)

    def truncate(self, seq_id, length: int) -> None:
        """Roll a sequence's logical length back; its pages stay
        allocated and later writes rewrite their tail slots."""
        if self._seq_len.get(seq_id, 0) > length:
            self._seq_len[seq_id] = length

    @property
    def free_pages(self) -> int:
        """Capacity available to new allocations: free pages plus
        evictable prefix-cache pages."""
        return len(self._free) + self.cached_prefix_pages

    def length(self, seq_id) -> int:
        return self._seq_len.get(seq_id, 0)

    def page_table(self, seq_ids, max_pages: Optional[int] = None):
        """(batch, max_pages) int32 table and (batch,) int32 lengths for
        a batch, as tensors on the cache's device."""
        tables = [self._seq_pages.get(s, []) for s in seq_ids]
        if max_pages is None:
            max_pages = max(1, max(len(t) for t in tables))
        tab = np.zeros((len(seq_ids), max_pages), np.int32)
        for i, t in enumerate(tables):
            tab[i, :len(t)] = t
        lens = np.asarray([self._seq_len.get(s, 0) for s in seq_ids],
                          np.int32)
        return (torch.from_numpy(tab).to(self.device),
                torch.from_numpy(lens).to(self.device))

    # ------------------------------------------------------- data writes
    def plan_write(self, seq_ids, n: int):
        """Host-side (page, slot) targets for ``n`` new tokens per
        sequence as flat (batch*n,) int32 arrays; does not advance
        lengths (call :meth:`advance` once the write is planned)."""
        b = len(seq_ids)
        pages_flat = np.empty(b * n, np.int32)
        slots_flat = np.empty(b * n, np.int32)
        for i, sid in enumerate(seq_ids):
            start = self._seq_len.get(sid, 0)
            pages = self._seq_pages[sid]
            pos = start + np.arange(n)
            pages_flat[i * n:(i + 1) * n] = [
                pages[p] for p in pos // self.page_size]
            slots_flat[i * n:(i + 1) * n] = pos % self.page_size
        return pages_flat, slots_flat

    def advance(self, seq_ids, n: int) -> None:
        """Advance logical lengths by ``n`` tokens per sequence."""
        for sid in seq_ids:
            self._seq_len[sid] = self._seq_len.get(sid, 0) + n

    def write(self, layer: int, seq_id, k_new, v_new) -> None:
        """Append (tokens, kv_heads, head_dim) k/v for one sequence into
        its pages (call :meth:`allocate` first; the last layer's write
        advances the length)."""
        self.write_batch(layer, [seq_id], k_new[None], v_new[None])

    def write_batch(self, layer: int, seq_ids, k_new, v_new) -> None:
        """Append one step's k/v for many sequences, k_new/v_new (batch,
        tokens, kv_heads, head_dim), with one ``_scatter_pages`` per pool
        at the targets :meth:`plan_write` gives; in the int8 mode each
        slot and head is quantized on the way in and its scale written
        beside it.  The eager write of the oracle
        (``inference.paged.EagerPagedContext``); the steps' device bodies
        write through their staged plan instead.  The last layer's write
        advances the lengths."""
        b, n = k_new.shape[0], k_new.shape[1]
        pages, slots = (torch.from_numpy(a.astype(np.int64)).to(self.device)
                        for a in self.plan_write(seq_ids, n))
        for new, data, scales in ((k_new, self.k_pages, self.k_scales),
                                  (v_new, self.v_pages, self.v_scales)):
            flat = new.reshape((b * n,) + tuple(new.shape[2:]))
            if self.kv_quant:
                flat, sc = quantize_kv(flat)
                _scatter_pages(scales[layer], pages, slots,
                               sc.transpose(0, 1))
            _scatter_pages(data[layer], pages, slots, flat.transpose(0, 1))
        if layer == self.num_layers - 1:
            self.advance(seq_ids, n)
