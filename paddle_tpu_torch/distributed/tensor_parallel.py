"""Tensor-parallel serving over ``torch.distributed``, a process a rank:
the port's counterpart of ``make_tp_mesh``
(``paddle_tpu/framework/jax_compat.py:132``) and of the serving programs
that the JAX package ``shard_map``s over it.

JAX's engine is one controller.  PyTorch's idiom is one process a rank,
and the engine's host loop decides from wall-clock deadlines, its step
time and thread timing, so copies of it on several ranks would drift
apart.  Here rank 0, the caller's process, plans every step, and the
other ranks only execute: :class:`TensorParallelGroup` spawns ``tp - 1``
worker processes (start method ``spawn``; their entry point,
:func:`_worker_main`, lives in this package, so a worker imports torch
and this package, never jax) and joins them over a ``TCPStore`` that
rank 0 opens on a free port, in two process groups:

- a gloo group on the CPU for control: each step's header (its mode and
  bucket, the repeat count of a multi-step run, the ``buffer_loss``
  flag) and its staged input bytes, broadcast from rank 0
  (``inference.paged.PagedDecoder._run``);
- a device group for the collective that closes each row-parallel block
  (``inference.paged._make_tp_reduce``): gloo on the CPU; NCCL on a card
  by default, rank r on ``cuda:r``; gloo on a card only when the caller
  asks for it (``backend="gloo"``), every rank then on the caller's card,
  with gloo staging each collective through the host.  The backend is
  never switched behind the caller's back.

Python objects — a worker's shard of the weights, a pool's shape, the
queries the tests and ``chip_smoke.py`` make — travel through a
``multiprocessing`` queue a worker (CPU tensors in shared memory), each
announced by a control header; replies come back the same way.  Every
wait on a worker is bounded by ``TIMEOUT_S`` and looks at the worker's
process first, so a dead worker makes the next call raise
:class:`TensorParallelError` naming its rank instead of hanging.  A
worker waits for its next header for up to a week, and exits when rank
0's connection closes or rank 0's process is gone.
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import os
import queue
import sys
import threading
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .._device import resolve_device

# the control header: op, decoder handle, cache handle, mode, tail kind,
# rows, span, table width, repeat count, buffer_loss flag, payload bytes
_HEADER = 11
_STEP, _DECODER, _CACHE, _RESET, _QUERY, _CLOSE = range(1, 7)
_MODES = ("prefill", "prefix", "ragged", "decode", "verify", "multi")
_KINDS = (False, "greedy", "draw")
# how long a worker waits for rank 0's next header
_IDLE = datetime.timedelta(days=7)
#: the bound on every collective and every wait on a worker, in seconds
TIMEOUT_S = 120.0


class TensorParallelError(RuntimeError):
    """A rank of a tensor-parallel group failed, died or did not answer;
    the message names the rank."""


def _broadcast(pg, tensor, timeout) -> None:
    """Rank 0's ``tensor`` into every rank's, on a gloo or NCCL group."""
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    opts.rootTensor = 0
    opts.timeout = timeout
    pg.broadcast([tensor], opts).wait()


def _groups(store, rank, tp, backend, timeout):
    """The control group (gloo, CPU) and the device group of one rank."""
    ctrl = dist.ProcessGroupGloo(dist.PrefixStore("ctrl", store), rank, tp,
                                 timeout)
    dstore = dist.PrefixStore("dev", store)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        dev = dist.ProcessGroupNCCL(dstore, rank, tp, opts)
    else:
        dev = dist.ProcessGroupGloo(dstore, rank, tp, timeout)
    return ctrl, dev


class Collectives:
    """The device group's collectives, as the row-parallel reduce uses
    them (``inference.paged._make_tp_reduce``), on every rank alike.
    ``reduces`` counts the block-closing reductions this rank ran."""

    def __init__(self, pg, tp: int):
        self.pg = pg
        self.tp = tp
        self.reduces = 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place, in its own type."""
        self.pg.allreduce([x]).wait()
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x``, stacked along a new leading axis of
        ``tp``."""
        outs = [torch.empty_like(x) for _ in range(self.tp)]
        self.pg.allgather([outs], [x.contiguous()]).wait()
        return torch.stack(outs)


def _encode_key(key) -> list:
    mode, kind, rows, span = key[:4]
    width = key[4] if len(key) > 4 else 0
    return [_MODES.index(mode), _KINDS.index(kind), rows, span, width]


def _decode_key(codes) -> tuple:
    mode, kind, rows, span, width = (int(c) for c in codes)
    key = (_MODES[mode], _KINDS[kind], rows, span)
    return key if key[0] == "prefill" else key + (width,)


def _shared(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``t`` in shared memory (a queue passes its handle)."""
    out = torch.empty(t.shape, dtype=t.dtype).share_memory_()
    out.copy_(t)
    return out


class TensorParallelGroup:
    """``tp`` ranks for tensor-parallel serving: this process is rank 0,
    and ``tp - 1`` spawned workers are the others (see the module
    docstring).  ``device`` is rank 0's device, where the model lives;
    ``backend`` the device group's: None picks gloo on the CPU and NCCL
    on a card, which puts rank r on ``cuda:r`` and needs ``tp`` visible
    cards; ``"gloo"`` on a card puts every rank on ``device``.
    ``TIMEOUT_S`` bounds every collective and every wait on a worker.

    A :class:`~paddle_tpu_torch.inference.paged.PagedDecoder` and a
    :class:`~paddle_tpu_torch.ops.paged_attention.PagedKVCache` given the
    group send each worker its shard of the weights and its pools' shape
    (:meth:`add_decoder`, :meth:`add_cache`), and every step's header and
    staged bytes (:meth:`step`).  :meth:`close` (or leaving a ``with``
    block) ends every worker; a closed group refuses work."""

    def __init__(self, tp: int, device="cuda",
                 backend: Optional[str] = None):
        tp = int(tp)
        if tp < 1:
            raise ValueError(f"tp degree must be >= 1, got {tp}")
        if tp == 1:
            raise ValueError("a tensor-parallel group spans tp >= 2 ranks; "
                             "tp=1 is the single-process path (no group)")
        dev = resolve_device(device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                             f"{backend!r}")
        if backend == "nccl":
            if dev.type != "cuda":
                raise ValueError("the NCCL backend needs a card; tensor "
                                 "parallelism on the CPU runs gloo")
            n = torch.cuda.device_count()
            if n < tp:
                raise RuntimeError(
                    f"tp={tp} over NCCL puts rank r on cuda:r, but only "
                    f"{n} CUDA device(s) are visible. Make {tp} cards "
                    f"visible (CUDA_VISIBLE_DEVICES), or pass "
                    f"backend='gloo' (the engine's tp_backend='gloo') to "
                    f"run every rank on {dev} with gloo collectives "
                    f"staged through the host.")
            if dev.index != 0:
                raise ValueError(f"over NCCL rank 0 runs on cuda:0; the "
                                 f"model lives on {dev}")
            devices = [torch.device("cuda", r) for r in range(tp)]
        else:
            devices = [dev] * tp
        self.tp = tp
        self.device = dev
        self.backend = backend
        self._timeout = datetime.timedelta(seconds=TIMEOUT_S)
        self._lock = threading.RLock()
        self._handles = itertools.count(1)
        self._closed = False
        if dev.type == "cuda":
            # every kernel built before any worker starts, so no two
            # processes compile one source at once
            from ..ops import _build
            _build.build_all()
        self._store = dist.TCPStore("127.0.0.1", 0, tp, True,
                                    timeout=self._timeout,
                                    wait_for_workers=False)
        ctx = mp.get_context("spawn")
        self._inbox = [ctx.Queue() for _ in range(tp - 1)]
        self._outbox = [ctx.Queue() for _ in range(tp - 1)]
        self._procs = [
            ctx.Process(target=_worker_main, name=f"tp-rank{r}",
                        args=(r, tp, self._store.port, backend,
                              str(devices[r]), self._inbox[r - 1],
                              self._outbox[r - 1]),
                        daemon=True)
            for r in range(1, tp)]
        try:
            for p in self._procs:
                p.start()
            self._wait_ready()
            self._ctrl, pg = _groups(self._store, 0, tp, backend,
                                     self._timeout)
        except BaseException:
            self._end_workers()
            raise
        self.collectives = Collectives(pg, tp)

    # ------------------------------------------------------------ workers
    def _wait_ready(self) -> None:
        """Wait until every worker has reached the store (so the groups'
        rendezvous does not sit out its timeout on a worker that died
        while starting)."""
        deadline = time.monotonic() + TIMEOUT_S
        for r, p in enumerate(self._procs, 1):
            while not self._store.check([f"ready{r}"]):
                if not p.is_alive():
                    raise self._dead(r)
                if time.monotonic() > deadline:
                    raise TensorParallelError(
                        f"tensor-parallel rank {r} did not start within "
                        f"{TIMEOUT_S} s")
                time.sleep(0.02)

    def _worker_error(self, r: int) -> str:
        """The last error a worker reported, if it reported one."""
        try:
            while True:
                msg = self._outbox[r - 1].get_nowait()
                if msg[0] == "error":
                    return msg[1]
        except (queue.Empty, OSError, EOFError):
            return ""

    def _dead(self, r: int) -> TensorParallelError:
        p = self._procs[r - 1]
        said = self._worker_error(r)
        return TensorParallelError(
            f"tensor-parallel rank {r} (pid {p.pid}) exited with code "
            f"{p.exitcode}" + (f":\n{said}" if said else ""))

    def check(self) -> None:
        """Raise :class:`TensorParallelError` if the group is closed or a
        worker has exited."""
        if self._closed:
            raise TensorParallelError("the tensor-parallel group is closed")
        for r, p in enumerate(self._procs, 1):
            if not p.is_alive():
                raise self._dead(r)

    @contextlib.contextmanager
    def guard(self):
        """Around a step's device body.  An error there while a worker has
        died (a collective whose peer went away) becomes a
        :class:`TensorParallelError` naming the rank.  Any other error
        left the workers inside the body, waiting on collectives rank 0
        will not make, so the ranks are out of step: the group is closed
        (its workers killed) and the error raised as a
        :class:`TensorParallelError`."""
        try:
            yield
        except BaseException as exc:
            for r, p in enumerate(self._procs, 1):
                p.join(0.5)
                if not p.is_alive() and isinstance(exc, Exception):
                    raise self._dead(r) from exc
            with self._lock:
                self._closed = True
                for p in self._procs:
                    p.kill()
                self._end_workers()
            if not isinstance(exc, Exception):
                raise                 # an interrupt stays one
            raise TensorParallelError(
                "a step failed on rank 0 inside its body while the other "
                "ranks were in it, so the ranks are out of step; the "
                "tensor-parallel group is closed"
            ) from exc

    def _header(self, op, *fields) -> None:
        h = torch.zeros(_HEADER, dtype=torch.int64)
        h[0] = op
        h[1:1 + len(fields)] = torch.tensor(fields, dtype=torch.int64)
        _broadcast(self._ctrl, h, self._timeout)

    def _send(self, op, handle, per_worker=None) -> None:
        """One control message to every worker: ``per_worker[i]`` (an
        object for worker rank i + 1) goes through its queue first."""
        self.check()
        if per_worker is not None:
            for box, obj in zip(self._inbox, per_worker):
                box.put(obj)
        self._header(op, handle)

    def _reply(self, r: int):
        deadline = time.monotonic() + TIMEOUT_S
        while True:
            try:
                kind, value = self._outbox[r - 1].get(timeout=0.2)
            except queue.Empty:
                if not self._procs[r - 1].is_alive():
                    raise self._dead(r) from None
                if time.monotonic() > deadline:
                    raise TensorParallelError(
                        f"tensor-parallel rank {r} did not answer within "
                        f"{TIMEOUT_S} s") from None
                continue
            if kind == "error":
                raise TensorParallelError(
                    f"tensor-parallel rank {r} failed:\n{value}")
            return value

    # -------------------------------------------------------------- work
    def step(self, decoder: int, cache: int, key, n: int, lose: bool,
             payload: torch.Tensor) -> None:
        """Start one step on every worker: the header, then the staged
        input bytes (``payload``, rank 0's host staging buffer), which
        each worker receives into its own staging buffer of the key."""
        with self._lock:
            self.check()
            self._header(_STEP, decoder, cache, *_encode_key(key), n,
                         int(lose), payload.numel())
            _broadcast(self._ctrl, payload, self._timeout)

    def add_decoder(self, model, min_table_pages: int,
                    quant_collectives: bool) -> int:
        """Send each worker its shard of ``model``'s weights (cut by
        ``models.convert.shard_params``, in shared CPU memory); the
        worker builds its shard model and decoder on its device.
        Returns the decoder's handle."""
        from ..models.convert import shard_params
        w = model.model.embed_tokens.weight
        msgs = [(model.config, w.dtype,
                 {k: _shared(v) for k, v in
                  shard_params(model, self.tp, r).items()},
                 min_table_pages, quant_collectives)
                for r in range(1, self.tp)]
        with self._lock:
            handle = next(self._handles)
            self._send(_DECODER, handle, msgs)
            for r in range(1, self.tp):
                self._reply(r)           # built: the shared copies may go
        return handle

    def add_cache(self, **spec) -> int:
        """Allocate a pool shard on every worker (``spec``: the
        ``PagedKVCache`` arguments of one rank's shard).  Returns the
        cache's handle."""
        with self._lock:
            handle = next(self._handles)
            self._send(_CACHE, handle, [spec] * (self.tp - 1))
            for r in range(1, self.tp):
                self._reply(r)
        return handle

    def reset_pools(self, cache: int) -> None:
        """Zero a cache's pool shards on every worker."""
        with self._lock:
            self._send(_RESET, cache)

    def query(self, what: str, handle: int = 0) -> list:
        """Ask every worker, in rank order: ``"pools"`` (a cache's pool
        shards, as CPU tensors: (k, v, k scales, v scales) a layer),
        ``"params"`` (a decoder's shard weights), ``"launches"`` (each
        kernel wrapper's launch count, by its function name),
        ``"zero_launches"``, ``"memory"`` (peak device bytes allocated
        since the last ``"reset_peak"``; None on the CPU),
        ``"reset_peak"``, ``"reduces"`` (the block-closing reductions the
        worker ran) or ``"modules"`` (the jax or ``paddle_tpu`` modules
        the worker imported: none)."""
        with self._lock:
            self._send(_QUERY, handle,
                       [(what, handle)] * (self.tp - 1))
            return [self._reply(r) for r in range(1, self.tp)]

    # ------------------------------------------------------------- close
    def _end_workers(self) -> None:
        for p in self._procs:
            if p.pid is not None:
                p.join(10)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        for box in self._inbox + self._outbox:
            box.cancel_join_thread()
            box.close()

    def close(self) -> None:
        """End every worker (a close header, then a kill for any that
        has not exited within 10 s); idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                if all(p.is_alive() for p in self._procs):
                    self._header(_CLOSE)
            except RuntimeError:
                pass                  # a worker went away: killed below
            self._end_workers()
            self._ctrl = self.collectives = self._store = None

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ------------------------------------------------------------ the worker
def _exit_with_parent(ppid: int) -> None:
    """A worker's watch thread: rank 0 gone means the worker goes."""
    while True:
        time.sleep(1.0)
        if os.getppid() != ppid:
            os._exit(1)


def _answer(what, handle, decoders, caches, collectives, dev):
    from ..cuda_graphs import counted_wrappers
    if what == "pools":
        c = caches[handle]
        scales = (c.k_scales, c.v_scales) if c.kv_quant else \
            ([None] * c.num_layers, [None] * c.num_layers)
        return [tuple(None if t is None else _shared(t)
                      for t in (k, v, ks, vs))
                for k, v, ks, vs in zip(c.k_pages, c.v_pages, *scales)]
    if what == "params":
        return {k: _shared(v)
                for k, v in decoders[handle].model.state_dict().items()}
    if what == "launches":
        return {fn.__name__: fn.launches for fn in counted_wrappers()}
    if what == "zero_launches":
        for fn in counted_wrappers():
            fn.launches = 0
        return None
    if what == "memory":
        return (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
    if what == "reset_peak":
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        return None
    if what == "reduces":
        return collectives.reduces
    if what == "modules":
        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
    raise ValueError(f"unknown query {what!r}")


def _worker_main(rank: int, tp: int, port: int, backend: str, device: str,
                 inbox, outbox) -> None:
    """A worker rank: join the groups, then execute what rank 0 sends
    until the close header.  Any error is reported through ``outbox`` and
    ends the worker (rank 0 names it on its next call)."""
    try:
        with torch.no_grad():
            _serve_rank(rank, tp, port, backend, device, inbox, outbox)
    except BaseException:
        outbox.put(("error", traceback.format_exc()))
        outbox.close()
        outbox.join_thread()
        os._exit(1)


def _serve_rank(rank, tp, port, backend, device, inbox, outbox):
    from ..inference.paged import PagedDecoder, _make_tp_reduce
    from ..models.llama import LlamaForCausalLM
    from ..ops.paged_attention import PagedKVCache

    threading.Thread(target=_exit_with_parent, args=(os.getppid(),),
                     daemon=True).start()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore("127.0.0.1", port, tp, False, timeout=timeout)
    store.set(f"ready{rank}", "1")
    ctrl, pg = _groups(store, rank, tp, backend, timeout)
    collectives = Collectives(pg, tp)
    decoders, caches = {}, {}
    h = torch.zeros(_HEADER, dtype=torch.int64)
    while True:
        _broadcast(ctrl, h, _IDLE)
        op, handle = int(h[0]), int(h[1])
        if op == _STEP:
            dec, cache = decoders[handle], caches[int(h[2])]
            key, n, lose = _decode_key(h[3:8]), int(h[8]), bool(h[9])
            inp, out = dec._stage(key)
            if inp._host.numel() != int(h[10]):
                raise RuntimeError(f"step {key}: rank 0 staged {int(h[10])} "
                                   f"bytes, this rank {inp._host.numel()}")
            _broadcast(ctrl, inp._host, timeout)
            inp.upload()
            if lose:
                cache._zero_pools()
                continue
            body = dec._body(cache, key)
            dec._execute(cache, key, lambda: body(inp.dev, out.dev), n)
        elif op == _DECODER:
            config, dtype, state, min_table_pages, quant = \
                inbox.get(timeout=TIMEOUT_S)
            model = LlamaForCausalLM(config, device=dev, dtype=dtype,
                                     seed=None, tp=tp)
            model.load_state_dict(state)
            del state
            dec = PagedDecoder(model, min_table_pages=min_table_pages)
            dec._set_tp(_make_tp_reduce(collectives, quant))
            decoders[handle] = dec
            outbox.put(("ok", None))
        elif op == _CACHE:
            # the rank's pool shards; the cache's page bookkeeping is
            # never consulted here (rank 0 plans every step)
            spec = inbox.get(timeout=TIMEOUT_S)
            caches[handle] = PagedKVCache(device=dev, **spec)
            outbox.put(("ok", None))
        elif op == _RESET:
            caches[handle]._zero_pools()
        elif op == _QUERY:
            what, arg = inbox.get(timeout=TIMEOUT_S)
            outbox.put(("ok", _answer(what, arg, decoders, caches,
                                      collectives, dev)))
        elif op == _CLOSE:
            return
        else:
            raise RuntimeError(f"unknown control op {op}")


__all__ = ["Collectives", "TensorParallelError", "TensorParallelGroup"]
