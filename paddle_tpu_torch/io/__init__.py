"""Data loading: datasets, samplers and the DataLoader (port of
paddle_tpu/io/__init__.py).

Batches are CPU torch tensors (``default_collate_fn``).  The samplers
draw from numpy's global generator as the JAX package's do, so a run
seeded with ``np.random.seed`` visits samples in the same order in both
packages.  A background thread prefetches host batches; with
``device_prefetch`` a second thread stages each batch on the card: it
pins the batch, copies it with ``non_blocking=True`` on the loader's own
CUDA stream and records an event, and the consumer's stream waits on
that event before the batch is handed out (``record_stream`` tells the
allocator where the batch is used), so the copy of the next batch
overlaps the current step.  On the CPU the stage hands the batch on as
it is.  ``num_workers > 0`` loads in spawned worker processes, which
never touch CUDA: they send numpy batches back, and the parent's device
stage moves them.
"""
from __future__ import annotations

import bisect
import itertools
import math
import queue
import threading
import time
from typing import List

import numpy as np
import torch

from .. import monitor
from .._device import resolve_device

# how long the consumer (the training loop) sat blocked waiting for the
# next batch: what the device prefetch stage drives toward zero
_input_wait_s = monitor.histogram(
    "input_wait_seconds", "time the DataLoader consumer spent blocked "
    "waiting for the next batch")


class Dataset:
    """A map-style dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (tuple, list))
                       else [sample])
        return tuple(out)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(itertools.accumulate(
            len(d) for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of the given lengths (or fractions summing to 1) over a
    permutation drawn from numpy's global generator."""
    if all(isinstance(n, float) for n in lengths) and \
            abs(sum(lengths) - 1.0) < 1e-6:
        n = len(dataset)
        lengths = [int(math.floor(n * frac)) for frac in lengths]
        for i in range(n - sum(lengths)):
            lengths[i % len(lengths)] += 1
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    perm = np.random.permutation(len(dataset)).tolist()
    out, offset = [], 0
    for length in lengths:
        out.append(Subset(dataset, perm[offset:offset + length]))
        offset += length
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """The given indices without replacement, in random order."""

    def __init__(self, indices):
        if len(indices) == 0:
            raise ValueError(
                "SubsetRandomSampler requires a non-empty index list")
        self.indices = list(indices)

    def __iter__(self):
        order = np.random.permutation(len(self.indices))
        return iter([self.indices[i] for i in order])

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(rank, world size) of an initialized ``torch.distributed``, else
    (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DistributedBatchSampler(BatchSampler):
    """A rank's share of the indices: the epoch's order (shuffled by
    ``RandomState(epoch)``), padded to a multiple of the world size,
    every ``nranks``-th index from ``local_rank``.  The rank and the
    world size default to ``torch.distributed``'s when it is
    initialized, else 0 and 1."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        world_rank, world_size = _world()
        self.nranks = num_replicas if num_replicas is not None \
            else world_size
        self.local_rank = rank if rank is not None else world_rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate(
            [indices, indices[:self.total_size - n]])
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Stack a list of samples into CPU tensors: arrays and tensors
    stacked, ints as int64, floats as f32, strings kept as a list, dicts
    and sequences field by field."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, torch.Tensor):
        return torch.stack([s.cpu() for s in batch])
    if isinstance(sample, (bool, np.bool_)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    return torch.from_numpy(np.asarray(batch))


def _map_tensors(fn, obj):
    """``obj`` with ``fn`` applied to every tensor in it."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    return obj


class _Staged:
    """A batch copied to the card on the loader's stream, with the event
    that marks the end of its copy."""

    __slots__ = ("batch", "event", "device")

    def __init__(self, batch, event, device):
        self.batch = batch
        self.event = event
        self.device = device

    def take(self):
        """The batch, usable on the caller's current stream: that stream
        waits for the copy, and each tensor is recorded as used there."""
        here = torch.cuda.current_stream(self.device)
        here.wait_event(self.event)

        def mark(t):
            t.record_stream(here)
            return t
        return _map_tensors(mark, self.batch)


class _PrefetchIter:
    """Background-thread prefetcher (host-side pipeline overlap), with an
    optional device stage: when ``device_fn`` is given, a second thread
    applies it to each host batch and buffers the result in its own
    bounded queue, so the next batch's host-to-device copy is issued from
    the pipeline and overlaps the current step.

    ``close()`` (also triggered by exhaustion, a producer error and GC)
    shuts every pipeline thread down, even when the consumer abandons the
    iterator mid-epoch with full queues: every queue put polls a stop
    event instead of blocking forever."""

    _POLL_S = 0.1

    def __init__(self, producer, depth, device_fn=None, device_depth=2):
        # the thread closures capture ONLY these locals, never ``self``: a
        # thread frame holding the iterator would keep it reachable, so
        # __del__ (the abandon-path shutdown) could never fire and the
        # threads would leak
        done = self._done = object()
        stop = self._stop = threading.Event()
        exc_box = self._exc_box = [None]
        poll = self._POLL_S
        host_q = queue.Queue(maxsize=depth)
        self._q = host_q
        self.threads: List[threading.Thread] = []

        def put(q, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=poll)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in producer:
                    if not put(host_q, item):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                if exc_box[0] is None:
                    exc_box[0] = e
            finally:
                put(host_q, done)

        self.threads.append(threading.Thread(
            target=produce, name="dataloader-prefetch", daemon=True))
        if device_fn is not None:
            dev_q = queue.Queue(maxsize=max(device_depth, 1))
            self._q = dev_q

            def stage():
                try:
                    while not stop.is_set():
                        try:
                            item = host_q.get(timeout=poll)
                        except queue.Empty:
                            continue
                        if item is done or \
                                not put(dev_q, device_fn(item)):
                            return
                except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                    if exc_box[0] is None:
                        exc_box[0] = e
                finally:
                    put(dev_q, done)

            self.threads.append(threading.Thread(
                target=stage, name="dataloader-device-stage", daemon=True))
        for t in self.threads:
            t.start()

    @property
    def _exc(self):
        return self._exc_box[0]

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=self._POLL_S)
                break
            except queue.Empty:
                if not self._stop.is_set() and \
                        any(t.is_alive() for t in self.threads):
                    continue
                # the threads are gone (or we were closed): anything they
                # enqueued is already visible; drain it before declaring
                # exhaustion, or the epoch's tail batches would be lost
                try:
                    item = self._q.get_nowait()
                    break
                except queue.Empty:
                    _input_wait_s.observe(time.perf_counter() - t0)
                    self.close()
                    if self._exc is not None:
                        raise self._exc
                    raise StopIteration
        _input_wait_s.observe(time.perf_counter() - t0)
        if item is self._done:
            self.close()
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item.take() if isinstance(item, _Staged) else item

    def close(self):
        """Stop the pipeline threads (idempotent; safe mid-epoch: the
        threads see the stop event at their next queue poll)."""
        self._stop.set()
        for t in self.threads:
            if t is not threading.current_thread():
                t.join(timeout=5)

    def __del__(self):
        self._stop.set()


def _stage_device(sharding, device):
    """The device a loader stages its batches on: the one device of
    ``sharding`` (a device, or a sequence of devices), else ``device``
    (default ``"cuda"``).  A sharding over more than one device raises:
    data parallelism is not ported yet."""
    if sharding is not None:
        devices = list(sharding) if isinstance(sharding, (list, tuple)) \
            else [sharding]
        if len(devices) != 1:
            raise NotImplementedError(
                f"device_sharding over {len(devices)} devices: the port "
                "stages a batch on one device (data parallelism is not "
                "ported yet)")
        return resolve_device(devices[0])
    return resolve_device("cuda" if device is None else device)


class DataLoader:
    """Batches of a dataset (the reference's ``paddle.io.DataLoader``).

    ``num_workers > 0`` loads in spawned worker processes fed by an index
    queue; ``prefetch_factor`` batches are staged ahead on a background
    thread either way.

    Device prefetch: ``device_prefetch=True`` adds a device stage to the
    pipeline (the module docstring says how a batch crosses), buffered
    ``device_prefetch_depth`` deep.  It stages on ``device`` (default
    ``"cuda"``, which raises without a card: pass ``device="cpu"`` there,
    where the stage hands each batch on as it is) or on the one device of
    ``device_sharding``, which turns the stage on by default.  A staged
    batch is bit-identical to ``.to(device)`` of the host batch.
    """

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, device_prefetch=None,
                 device_sharding=None, device_prefetch_depth=2,
                 device=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self.device_sharding = device_sharding
        self.device_prefetch = (device_sharding is not None
                                if device_prefetch is None
                                else bool(device_prefetch))
        self.device_prefetch_depth = max(int(device_prefetch_depth), 1)
        self.device = _stage_device(device_sharding, device) \
            if self.device_prefetch else None
        self._stream = None
        self._payload = None
        self._pool = None
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _produce(self):
        if self._iterable:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
            return
        if self.num_workers > 0:
            yield from self._produce_mp()
            return
        yield from self._produce_sp()

    def _produce_sp(self):
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])

    def _pickle_payload(self):
        """Pickle the worker payload once (spawned workers unpickle it);
        ``_PICKLE_FAILED`` when it cannot be pickled."""
        import pickle
        import warnings

        if self._payload is not None:
            return self._payload
        try:
            self._payload = pickle.dumps(
                (self.dataset, self.collate_fn, self.worker_init_fn))
        except Exception as e:  # noqa: BLE001 — lambdas, closures, local classes
            warnings.warn(
                f"num_workers={self.num_workers} needs a picklable dataset/"
                f"collate_fn/worker_init_fn under the spawn start method "
                f"({e!r}); falling back to in-process loading", stacklevel=3)
            self._payload = _PICKLE_FAILED
        return self._payload

    def _produce_mp(self):
        # spawn, not fork: forking a multithreaded parent (CUDA, the
        # prefetch threads) can deadlock
        if self._pickle_payload() is _PICKLE_FAILED:
            yield from self._produce_sp()
            return
        # a pool serves one epoch at a time; a second concurrent iterator
        # (or a pool whose workers died) gets a fresh private pool
        pool = self._pool
        private = pool is None or pool.busy or not pool.alive()
        if private:
            pool = _WorkerPool(self._payload, self.num_workers,
                               self.prefetch_factor)
            if self._pool is None and self.persistent_workers:
                self._pool, private = pool, False
        try:
            yield from pool.run_epoch(list(self.batch_sampler), self.timeout)
        finally:
            if private or not self.persistent_workers:
                pool.shutdown()
                if pool is self._pool:
                    self._pool = None

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown()

    def _device_stage_fn(self):
        """The device stage, run on the pipeline's stage thread: on a
        card every tensor of the batch is pinned and copied on the
        loader's stream, and an event marks the end of the copies; on
        the CPU the batch passes as it is."""
        dev = self.device
        if dev.type != "cuda":
            return lambda batch: batch
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream = self._stream

        def copy(t):
            if t.device == dev:
                return t
            src = t if t.device.type != "cpu" or t.is_pinned() \
                else t.pin_memory()
            return src.to(dev, non_blocking=True)

        def stage(batch):
            with torch.cuda.stream(stream):
                out = _map_tensors(copy, batch)
                event = torch.cuda.Event()
                event.record(stream)
            return _Staged(out, event, dev)
        return stage

    def __iter__(self):
        return _PrefetchIter(
            self._produce(), self.prefetch_factor,
            device_fn=self._device_stage_fn() if self.device_prefetch
            else None,
            device_depth=self.device_prefetch_depth)


class _WorkerPool:
    """Spawned DataLoader worker processes.  Reusable across epochs with
    ``persistent_workers=True``: workers are stateless per index batch,
    so an epoch is a numbered stream of (seq, indices) items with
    exactly-once accounting in the parent."""

    def __init__(self, payload, num_workers, prefetch_factor):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.index_q = ctx.Queue()
        self.out_q = ctx.Queue(maxsize=num_workers * prefetch_factor)
        self.busy = False
        # epoch generation: stale items of an abandoned epoch are dropped
        # by tag, not mistaken for data
        self._gen = 0
        self.workers = [
            ctx.Process(target=_mp_worker_boot,
                        args=(payload, w, num_workers, self.index_q,
                              self.out_q),
                        daemon=True)
            for w in range(num_workers)
        ]
        for w in self.workers:
            w.start()

    def alive(self):
        return all(w.is_alive() for w in self.workers)

    def run_epoch(self, batches, timeout=0):
        self.busy = True
        try:
            yield from self._run_epoch(batches, timeout)
        finally:
            self.busy = False

    def _run_epoch(self, batches, timeout):
        self._gen += 1
        gen = self._gen
        for seq, indices in enumerate(batches):
            self.index_q.put((gen, seq, indices))
        pending = {}
        next_seq = 0
        received = 0
        waited = 0.0
        while received < len(batches):
            try:
                g, seq, batch, err = self.out_q.get(timeout=_POLL_S)
            except queue.Empty:
                # a worker that died (an unpicklable payload class in the
                # child, a worker_init_fn crash, an OOM kill) surfaces as
                # an error, not a hang of the parent
                dead = [w.name for w in self.workers if not w.is_alive()]
                if dead:
                    self.shutdown()
                    raise RuntimeError(
                        f"DataLoader worker(s) {dead} exited unexpectedly "
                        f"(check child stderr; spawned workers must be able "
                        f"to import the dataset/collate_fn module)")
                waited += _POLL_S
                if timeout and waited >= timeout:
                    self.shutdown()
                    raise TimeoutError(
                        f"DataLoader batch not produced within {timeout}s")
                continue
            waited = 0.0
            if g != gen:
                continue   # a leftover of an abandoned earlier epoch
            received += 1
            if err is not None:
                self.shutdown()
                raise err
            pending[seq] = batch
            while next_seq in pending:
                yield _from_numpy_batch(pending.pop(next_seq))
                next_seq += 1

    def shutdown(self):
        for w in self.workers:
            if w.is_alive():
                w.terminate()
        for w in self.workers:
            w.join(timeout=5)


_POLL_S = 2.0
_PICKLE_FAILED = object()   # distinct from the "not yet computed" None


class WorkerInfo:
    """What ``get_worker_info()`` returns inside a worker."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """The calling worker's ``WorkerInfo``; None in the main process."""
    return _worker_info


def _mp_worker_boot(payload, wid, num_workers, index_q, out_q):
    """A spawned worker's entry (module level: spawn pickles the target).

    It hides every card before anything can touch CUDA, so a worker never
    initializes a CUDA context: it sees CPU tensors only, and sends numpy
    batches back."""
    import os
    import pickle

    global _worker_info
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    dataset, collate_fn, worker_init_fn = pickle.loads(payload)
    _worker_info = WorkerInfo(wid, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(wid)
    while True:
        item = index_q.get()
        if item is None:
            break
        gen, seq, indices = item
        try:
            batch = collate_fn([dataset[i] for i in indices])
            out_q.put((gen, seq, _to_numpy_batch(batch), None))
        except Exception as e:  # noqa: BLE001 — sent to the parent
            out_q.put((gen, seq, None, e))


def _to_numpy_batch(obj):
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy_batch(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_numpy_batch(v) for k, v in obj.items()}
    return obj


def _from_numpy_batch(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_numpy_batch(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _from_numpy_batch(v) for k, v in obj.items()}
    return obj


__all__ = [
    "BatchSampler", "ChainDataset", "ComposeDataset", "ConcatDataset",
    "DataLoader", "Dataset", "DistributedBatchSampler", "IterableDataset",
    "RandomSampler", "Sampler", "SequenceSampler", "Subset",
    "SubsetRandomSampler", "TensorDataset", "WeightedRandomSampler",
    "WorkerInfo", "default_collate_fn", "get_worker_info", "random_split",
]
