"""Port parity of data loading (``paddle_tpu_torch/io``) against the JAX
package's ``paddle_tpu.io`` on the CPU, and the prefetch pipeline's
contracts (the cases of ``tests/test_dataloader_prefetch.py``).

- Samplers and loaders visit the same indices in the same order as JAX's
  under one numpy seed (``RandomSampler``, ``WeightedRandomSampler``,
  ``SubsetRandomSampler``, ``random_split``, ``DistributedBatchSampler``
  with its epochs, shuffled ``DataLoader`` batches); values exactly
  equal.
- ``default_collate_fn``: the JAX collate's values and kinds (ints as
  int64, which JAX holds as int32; f32 floats, stacked arrays, dicts,
  strings).
- ``IterableDataset`` with and without ``drop_last``; ``ChainDataset``,
  ``ConcatDataset``, ``ComposeDataset``, ``Subset``, ``TensorDataset``.
- The prefetch pipeline with the device stage (``device="cpu"``: it
  hands batches on as they are): order, ``drop_last``, ``close()``
  idempotent, threads gone after GC of an abandoned iterator, a
  producer's error raised in the consumer, a slow producer's tail
  batches kept, ``input_wait_seconds`` observed, a sharding over more
  than one device refused, and one 2-worker spawn case (two epochs, same
  order, ``get_worker_info`` in the workers).
The device stage on a card is checked in
``tests/test_torch_fit_card.py``.
"""
import gc
import time
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu_torch import io as tio


class ArangeDataset(tio.Dataset):
    """Deterministic and spawn-picklable (module level)."""

    def __init__(self, n=24, width=4):
        self.n = n
        self.width = width

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return np.full((self.width,), idx, np.float32), \
            np.asarray(idx, np.int64)


class WorkerIdDataset(ArangeDataset):
    """Tags each sample with the id of the worker that loaded it."""

    def __getitem__(self, idx):
        info = tio.get_worker_info()
        x, y = super().__getitem__(idx)
        return x, y, np.asarray(-1 if info is None else info.id, np.int64)


class JaxArange(jio.Dataset):
    def __init__(self, n=24, width=4):
        self.inner = ArangeDataset(n, width)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, idx):
        return self.inner[idx]


def _rows(loader):
    return [float(b[0][i, 0]) for b in loader for i in range(len(b[0]))]


@pytest.mark.parametrize("case", ["random", "random_replacement",
                                  "weighted", "subset_random"])
def test_samplers_match_jax_under_one_seed(case):
    data = list(range(37))
    make = {
        "random": lambda m: m.RandomSampler(data),
        "random_replacement": lambda m: m.RandomSampler(
            data, replacement=True, num_samples=50),
        "weighted": lambda m: m.WeightedRandomSampler(
            np.linspace(0.1, 2.0, 37), 40),
        "subset_random": lambda m: m.SubsetRandomSampler(range(3, 30, 2)),
    }[case]
    np.random.seed(5)
    want = [list(make(jio)) for _ in range(2)]
    np.random.seed(5)
    got = [list(make(tio)) for _ in range(2)]
    assert got == want and want[0] != want[1]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last):
    ds = list(range(23))
    for rank in range(3):
        kw = dict(batch_size=4, num_replicas=3, rank=rank, shuffle=shuffle,
                  drop_last=drop_last)
        j = jio.DistributedBatchSampler(ds, **kw)
        t = tio.DistributedBatchSampler(ds, **kw)
        for epoch in range(2):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert list(t) == list(j)
            assert len(t) == len(j)


def test_distributed_batch_sampler_world_defaults():
    """Without torch.distributed initialized: rank 0 of 1."""
    t = tio.DistributedBatchSampler(list(range(10)), batch_size=4)
    assert (t.local_rank, t.nranks) == (0, 1)
    assert list(t) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_random_split_matches_jax():
    np.random.seed(3)
    want = [s.indices for s in jio.random_split(list(range(20)),
                                                [0.5, 0.3, 0.2])]
    np.random.seed(3)
    got = [s.indices for s in tio.random_split(list(range(20)),
                                               [0.5, 0.3, 0.2])]
    assert got == want
    with pytest.raises(ValueError):
        tio.random_split(list(range(5)), [2, 2])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_order_and_values_match_jax(shuffle, drop_last):
    np.random.seed(7)
    jl = list(jio.DataLoader(JaxArange(22), batch_size=4, shuffle=shuffle,
                             drop_last=drop_last))
    np.random.seed(7)
    tl = list(tio.DataLoader(ArangeDataset(22), batch_size=4,
                             shuffle=shuffle, drop_last=drop_last))
    assert len(tl) == len(jl) == (5 if drop_last else 6)
    for (tx, ty), (jx, jy) in zip(tl, jl):
        assert tx.dtype == torch.float32 and ty.dtype == torch.int64
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx._data))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy._data))


def test_default_collate_matches_jax():
    samples = [{"x": np.arange(3, dtype=np.float32) + i, "n": i,
                "f": 0.5 * i, "s": f"s{i}", "t": (np.int32(i), [i, i + 1])}
               for i in range(4)]
    got = tio.default_collate_fn(samples)
    want = jio.default_collate_fn(samples)

    def same(a, b):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, list) and b and isinstance(b[0], str):
            assert a == b
        elif isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            arr = np.asarray(b._data)
            assert isinstance(a, torch.Tensor)
            # JAX holds the int64 ints as int32 (x64 is off there)
            assert a.numpy().dtype.kind == arr.dtype.kind
            np.testing.assert_array_equal(a.numpy(), arr)
    same(got, want)
    assert got["n"].dtype == torch.int64 and got["f"].dtype == torch.float32
    stacked = tio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert stacked.shape == (2, 2)


class Stream(tio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.asarray([i], np.float32)


class JaxStream(jio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.asarray([i], np.float32)


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset_and_drop_last_match_jax(drop_last):
    got = [b.numpy() for b in tio.DataLoader(Stream(10), batch_size=4,
                                             drop_last=drop_last)]
    want = [np.asarray(b._data) for b in jio.DataLoader(
        JaxStream(10), batch_size=4, drop_last=drop_last)]
    assert len(got) == len(want) == (2 if drop_last else 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        len(tio.DataLoader(Stream(3)))


def test_dataset_combinators():
    a, b = ArangeDataset(3), ArangeDataset(4)
    cat = tio.ConcatDataset([a, b])
    assert len(cat) == 7 and float(cat[5][0][0]) == 2.0
    assert float(cat[-1][0][0]) == 3.0
    comp = tio.ComposeDataset([a, b])
    assert len(comp) == 3 and len(comp[1]) == 4
    assert [float(x[0]) for x in tio.ChainDataset([Stream(2), Stream(3)])] \
        == [0.0, 1.0, 0.0, 1.0, 2.0]
    sub = tio.Subset(b, [3, 1])
    assert len(sub) == 2 and int(sub[0][1]) == 3
    td = tio.TensorDataset([torch.arange(5), torch.arange(5) * 2])
    assert len(td) == 5 and int(td[2][1]) == 4


def _stage_loader(n=24, **kw):
    return tio.DataLoader(ArangeDataset(n), device_prefetch=True,
                          device="cpu", **kw)


def test_device_stage_order_and_drop_last():
    assert _rows(_stage_loader(24, batch_size=4)) == \
        [float(i) for i in range(24)]
    kept = list(_stage_loader(10, batch_size=4, drop_last=True))
    assert len(kept) == 2
    all_b = list(_stage_loader(10, batch_size=4))
    assert len(all_b) == 3 and all_b[-1][0].shape[0] == 2


def test_device_stage_needs_a_device_or_one_device_sharding():
    with pytest.raises(NotImplementedError):
        tio.DataLoader(ArangeDataset(4), device_sharding=["cpu", "cpu"])
    loader = tio.DataLoader(ArangeDataset(8), batch_size=4,
                            device_sharding=["cpu"])
    assert loader.device_prefetch and loader.device == torch.device("cpu")
    assert _rows(loader) == [float(i) for i in range(8)]


def test_close_stops_threads_and_is_idempotent():
    it = iter(_stage_loader(64, batch_size=2, prefetch_factor=2))
    next(it)
    threads = list(it.threads)
    assert len(threads) == 2               # host producer + device stage
    it.close()
    assert all(not t.is_alive() for t in threads)
    with pytest.raises(StopIteration):     # a closed iterator is done
        next(it)
    it.close()
    done = iter(_stage_loader(8, batch_size=2))
    list(done)                             # exhaustion closes
    assert all(not t.is_alive() for t in done.threads)
    done.close()


def test_abandoned_iterator_threads_exit_via_gc():
    it = iter(_stage_loader(256, batch_size=2, prefetch_factor=2))
    next(it)
    threads = list(it.threads)
    ref = weakref.ref(it)
    del it
    gc.collect()
    assert ref() is None                   # the iterator was collectable
    deadline = time.monotonic() + 5
    while any(t.is_alive() for t in threads) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert all(not t.is_alive() for t in threads)


class Faulty(ArangeDataset):
    def __getitem__(self, idx):
        if idx == 5:
            raise KeyError("sample 5 is broken")
        return super().__getitem__(idx)


def test_producer_error_reaches_the_consumer():
    it = iter(tio.DataLoader(Faulty(12), batch_size=2, device_prefetch=True,
                             device="cpu"))
    seen = []
    with pytest.raises(KeyError, match="sample 5"):
        for b in it:
            seen.append(b)
    assert len(seen) == 2
    assert all(not t.is_alive() for t in it.threads)


class Slow(ArangeDataset):
    def __getitem__(self, idx):
        if idx >= self.n - 2:
            time.sleep(0.15)               # slower than the poll interval
        return super().__getitem__(idx)


def test_slow_producer_tail_batches_not_dropped():
    rows = _rows(tio.DataLoader(Slow(8), batch_size=1, device_prefetch=True,
                                device="cpu"))
    assert rows == [float(i) for i in range(8)]


def test_input_wait_seconds_observed():
    from paddle_tpu_torch import monitor
    h = monitor.get_registry().get("input_wait_seconds")
    _, before = h.sum_count()
    list(_stage_loader(8, batch_size=4))
    _, after = h.sum_count()
    assert after == before + 3             # 2 batches and the end


def test_spawn_workers_keep_order_across_epochs():
    loader = tio.DataLoader(WorkerIdDataset(16), batch_size=4,
                            num_workers=2, device_prefetch=True,
                            device="cpu", persistent_workers=True)
    try:
        for _ in range(2):
            rows, workers = [], set()
            for x, _y, wid in loader:
                assert isinstance(x, torch.Tensor)
                rows.extend(x[:, 0].tolist())
                workers.update(wid.tolist())
            assert rows == [float(i) for i in range(16)]
            assert workers <= {0, 1} and workers
    finally:
        if loader._pool is not None:
            loader._pool.shutdown()
    assert tio.get_worker_info() is None
