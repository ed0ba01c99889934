"""Port parity: tensor-parallel serving (``tp=2``) on ``torch.distributed``
over gloo on the CPU, against the JAX package's tensor-parallel decoder
and engine (``tests/test_tp_engine.py``: virtual CPU devices, a
``('tensor',)`` mesh) on the same weights.

The port runs one process a rank: rank 0 (this process) plans every
step and a spawned worker executes it on its shard.  Held here:

- each rank's shard of every parameter is the JAX decoder's committed
  ``addressable_shards[r]`` (transposed), and so is what
  ``models.convert.shard_params`` cuts from the JAX arrays;
- a prefill and 6 decode steps give the JAX tp=2 decoder's logits within
  1e-5 with equal argmax, and each rank's pool shard, fetched from the
  worker, is the JAX pool's ``addressable_shards[r]``;
- greedy streams equal the JAX tp=2 engine's in the unified, legacy,
  chunked, prefix-hit and speculative compositions, and ``kv_quant=
  "int8"`` at tp=2 equals the port's tp=1 int8 run;
- ``tp_quant_collectives`` moves int8 codes through the all-gather, gives
  the JAX tp=2 decoder's int8-collective logits within 1e-5, and stays
  within JAX's own limits against tp=1 (prefill logits within 0.05, at
  most one flipped stream of six);
- the refusals: ``quantize`` with tp > 1, kv heads, heads or an
  intermediate size that tp does not divide, a biased row-parallel
  projection, tp < 1, NCCL on the CPU;
- recovery and workers: ``reset_pools`` keeps the shard shapes on every
  rank, a ``buffer_loss`` zeroes every rank's pools and the survivors'
  streams equal the fault-free run, a tp=1 snapshot restores into a tp=2
  engine, a killed worker fails the pending requests with an error that
  names its rank, the worker imports no jax, and closing ends every
  worker.

Each engine spawns its worker (seconds), so each composition runs once.
"""
import multiprocessing
import time

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.jax_compat import make_tp_mesh
from paddle_tpu.inference.continuous import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.paged import JittedPagedDecoder
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.ops.pallas.paged_attention import \
    PagedKVCache as JaxKVCache
from paddle_tpu_torch.distributed.tensor_parallel import (
    TensorParallelError, TensorParallelGroup)
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference.paged import PagedDecoder, _tp_plan
from paddle_tpu_torch.models.convert import (_linear_weights,
                                             params_from_numpy,
                                             shard_params)
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.ops.paged_attention import PagedKVCache
from paddle_tpu_torch.testing import faults

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
ENGINE = dict(total_pages=128, page_size=8, max_batch=4,
              sample_on_device=False)


def jax_model(seed=0, **over):
    paddle.seed(seed)
    return JaxLM(JaxConfig(**dict(TINY, **over)))


def port_model(seed=0, **over):
    """The port's twin of ``jax_model(seed)`` (the same weights)."""
    jm = jax_model(seed, **over)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return params_from_numpy(LlamaConfig(**dict(TINY, **over)), arrays,
                             device="cpu")


def _prompts(ns, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (n,)).astype(np.int32) for n in ns]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear()


@pytest.fixture(scope="module")
def group():
    """One tp=2 group (a spawned worker) for the decoder-level tests."""
    g = TensorParallelGroup(2, "cpu")
    yield g
    g.close()


def _ended(g):
    """Every worker of a closed group has exited and been reaped."""
    assert g.closed
    children = multiprocessing.active_children()
    for p in g._procs:
        assert not p.is_alive() and p not in children


def port_run(prompts, draft=False, new=8, **kw):
    """Greedy streams (host argmax over f32 logits) of the port's engine,
    as ``tests/test_tp_engine.py``'s ``greedy_run``; a tp engine's
    workers must be gone once it is left."""
    kw = dict(ENGINE, **kw)
    if draft:
        kw.update(draft_model=port_model(), spec_tokens=2)
    with ContinuousBatchingEngine(port_model(), device="cpu", **kw) as eng:
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        out = [r.result(timeout=120).tolist() for r in reqs]
    if eng.tp_group is not None:
        _ended(eng.tp_group)
    return out


def jax_run(prompts, draft=False, new=8, **kw):
    kw = dict(ENGINE, **kw)
    if draft:
        kw.update(draft_model=jax_model(), spec_tokens=2)
    with JaxEngine(jax_model(), **kw) as eng:
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        return [np.asarray(r.result(timeout=600)).tolist() for r in reqs]


# ------------------------------------------------------------ the decoder
def _shards(dec, g):
    """Rank -> the decoder's shard weights (rank 1 from the worker)."""
    return [dec.model.state_dict(), g.query("params", dec._tp_handle)[0]]


def test_parameter_shards_match_jax_addressable_shards(group):
    mesh = make_tp_mesh(2)
    jm = jax_model()
    jd = JittedPagedDecoder(jm, mesh=mesh)
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    pm = port_model()
    dec = PagedDecoder(pm, tp_group=group)
    linear = _linear_weights(pm)
    ranks = _shards(dec, group)
    assert len(jd.params) == len(ranks[0]) == len(ranks[1])
    for name, p in jm.named_parameters():
        for r in range(2):
            want = np.asarray(p._data.addressable_shards[r].data)
            got = ranks[r][name].numpy()
            got = got.T if name in linear else got
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            cut = shard_params(arrays, 2, r, LlamaConfig(**TINY))[name]
            cut = cut.numpy().T if name in linear else cut.numpy()
            np.testing.assert_array_equal(cut, want, err_msg=name)
    # the caller's model is left whole
    assert pm.model.layers[0].self_attn.num_heads == 4
    assert dec.model.model.layers[0].self_attn.num_heads == 2


def _pool_shards(cache, g):
    """Rank -> per layer (k, v) pool shard (rank 1 from the worker)."""
    theirs = g.query("pools", cache._tp_handle)[0]
    return [list(zip(cache.k_pages, cache.v_pages)),
            [(k, v) for k, v, _, _ in theirs]]


def test_decoder_parity_and_pool_shards(group):
    mesh = make_tp_mesh(2)
    jm = jax_model()
    jd = JittedPagedDecoder(jm, mesh=mesh)
    jc = JaxKVCache.from_model(jm, total_pages=32, page_size=8, mesh=mesh)
    pm = port_model()
    dec = PagedDecoder(pm, tp_group=group)
    cache = PagedKVCache.from_model(pm, total_pages=32, page_size=8,
                                    tp_group=group)
    assert cache.tp == 2
    assert cache.kv_pool_bytes_per_chip * 2 == cache.kv_pool_bytes
    assert cache.kv_pool_bytes == jc.kv_pool_bytes    # the whole pool's
    assert tuple(cache.k_pages[0].shape) == (1, 32, 8, 8)

    prompt = _prompts((8,))[0][None]
    want = np.asarray(jd.prefill(jc, [0], prompt))
    got = dec.prefill(cache, [0], prompt)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    pos = np.array([prompt.shape[1]], np.int32)
    tok = want.argmax(-1).astype(np.int32).reshape(1, 1)
    for _ in range(6):
        want = np.asarray(jd.step(jc, [0], tok, pos))
        got = dec.step(cache, [0], tok, pos)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
        tok = want.argmax(-1).astype(np.int32).reshape(1, 1)
        pos = pos + 1
    for r, layers in enumerate(_pool_shards(cache, group)):
        for i, (k, v) in enumerate(layers):
            for mine, theirs in ((k, jc.k_pages[i]), (v, jc.v_pages[i])):
                np.testing.assert_allclose(
                    mine.numpy(),
                    np.asarray(theirs.addressable_shards[r].data),
                    rtol=1e-5, atol=1e-5, err_msg=f"rank {r} layer {i}")
    # every rank ran the same block-closing reductions: 2 a layer a forward
    assert group.query("reduces") == [group.collectives.reduces]


def test_reset_pools_keeps_shard_shapes_on_every_rank(group):
    pm = port_model()
    dec = PagedDecoder(pm, tp_group=group)
    cache = PagedKVCache.from_model(pm, total_pages=16, page_size=8,
                                    tp_group=group, kv_dtype="int8")
    dec.prefill(cache, [0], _prompts((9,))[0][None])
    before = group.query("pools", cache._tp_handle)[0]
    assert any(bool(k.any()) for k, _, _, _ in before)
    shapes = [[tuple(t.shape) for t in layer] for layer in before]
    cache.reset_pools()
    assert cache.generation == 1
    after = group.query("pools", cache._tp_handle)[0]
    assert [[tuple(t.shape) for t in layer] for layer in after] == shapes
    for layer in after:
        assert not any(bool(t.any()) for t in layer)
    assert not any(bool(t.any()) for t in cache.k_pages + cache.v_pages
                   + cache.k_scales + cache.v_scales)
    assert [tuple(t.shape) for t in cache.k_pages] == [(1, 16, 8, 8)] * 2
    assert cache.kv_pool_bytes_per_chip * 2 == cache.kv_pool_bytes


def test_buffer_loss_zeroes_every_ranks_pools(group):
    pm = port_model()
    dec = PagedDecoder(pm, tp_group=group)
    cache = PagedKVCache.from_model(pm, total_pages=16, page_size=8,
                                    tp_group=group)
    logits = dec.prefill(cache, [0], _prompts((9,))[0][None])
    tok = logits.argmax(-1).astype(np.int32).reshape(1, 1)
    faults.install(faults.FaultPlan([{"site": "buffer_loss", "nth": 1}]))
    with pytest.raises(faults.FaultError):
        dec.step(cache, [0], tok, np.array([9], np.int32))
    faults.clear()
    assert cache.generation == 1 and cache.length(0) == 9
    for layers in _pool_shards(cache, group):
        for k, v in layers:
            assert not k.any() and not v.any()
    # the group goes on stepping after the loss
    dec.step(cache, [0], tok, np.array([9], np.int32))


def test_int8_collectives_move_int8_codes_within_jax_limits(group):
    gathered = []
    real = group.collectives.all_gather

    def spy(x):
        gathered.append(x.dtype)
        return real(x)

    jm = jax_model()
    jd = JittedPagedDecoder(jm)
    jc = JaxKVCache.from_model(jm, total_pages=16, page_size=8)
    pm = port_model()
    dec = PagedDecoder(pm, tp_group=group, tp_quant_collectives=True)
    cache = PagedKVCache.from_model(pm, total_pages=16, page_size=8,
                                    tp_group=group)
    prompt = _prompts((13,))[0][None]
    group.collectives.all_gather = spy
    try:
        got = dec.prefill(cache, [0], prompt)
    finally:
        del group.collectives.all_gather
    want = np.asarray(jd.prefill(jc, [0], prompt))
    assert float(np.max(np.abs(got - want))) < 0.05
    # codes and scales, one pair a block half
    assert gathered == [torch.int8, torch.float32] * 4
    # the same arithmetic as the JAX tp=2 decoder's int8 collectives
    mesh = make_tp_mesh(2)
    jq = jax_model()
    jqd = JittedPagedDecoder(jq, mesh=mesh, tp_quant_collectives=True)
    jqc = JaxKVCache.from_model(jq, total_pages=16, page_size=8, mesh=mesh)
    np.testing.assert_allclose(got, np.asarray(jqd.prefill(jqc, [0], prompt)),
                               rtol=1e-5, atol=1e-5)


def test_worker_imports_no_jax(group):
    assert group.query("modules") == [[]]


# ------------------------------------------------------------ the engine
COMPOSITIONS = {
    "unified": ((5, 9, 13, 20), {}),
    "legacy": ((5, 9, 3), dict(unified_step=False)),
    # 40-token prompts chunk at 8 through the prefix step
    "chunked": ((40, 37, 6), dict(prefill_chunk_tokens=8)),
    # the same-seed draft accepts nearly everything: verify is hot
    "speculative": ((6, 11, 4), dict(draft=True)),
}


@pytest.mark.parametrize("composition", list(COMPOSITIONS))
def test_engine_streams_equal_jax_tp2(composition):
    ns, kw = COMPOSITIONS[composition]
    prompts = _prompts(ns)
    assert port_run(prompts, tp=2, **kw) == jax_run(prompts, tp=2, **kw)


def test_engine_prefix_hit_equals_jax_tp2():
    rng = np.random.default_rng(3)
    system = rng.integers(0, 64, (16,)).astype(np.int32)
    suffixed = [np.concatenate([system, rng.integers(0, 64, (n,))])
                .astype(np.int32) for n in (5, 7)]

    def run(engine, model, **kw):
        with engine(model, prefix_cache=True, **ENGINE, **kw) as eng:
            # sequenced: the second submission hits the first's prefix
            outs = [np.asarray(eng.submit(p, max_new_tokens=8)
                               .result(timeout=600)).tolist()
                    for p in suffixed]
            hits = eng.cache.cached_prefix_pages
        return outs, hits

    want, _ = run(JaxEngine, jax_model(), tp=2)
    got, hits = run(ContinuousBatchingEngine, port_model(), tp=2,
                    device="cpu")
    assert hits > 0
    assert got == want


def test_int8_kv_at_tp2_equals_tp1():
    prompts = _prompts((5, 9, 13, 20))
    assert port_run(prompts, tp=2, kv_quant="int8") \
        == port_run(prompts, kv_quant="int8")


def test_int8_collectives_flip_at_most_one_stream_of_six():
    prompts = _prompts((5, 9, 13, 20, 7, 16))
    base = jax_run(prompts)
    quant = port_run(prompts, tp=2, tp_quant_collectives=True)
    assert sum(a == b for a, b in zip(base, quant)) >= len(prompts) - 1


# -------------------------------------------------- refusals (no worker)
REFUSALS = {
    "quantize": (lambda: ContinuousBatchingEngine(
        port_model(), tp=2, quantize="w8", device="cpu"), "quantize"),
    "kv_heads": (lambda: ContinuousBatchingEngine(
        port_model(num_key_value_heads=1), tp=2, device="cpu"), "kv"),
    "heads": (lambda: _tp_plan(port_model(num_key_value_heads=4), 3),
              "num_heads"),
    "intermediate": (lambda: _tp_plan(port_model(intermediate_size=63), 2),
                     "intermediate_size"),
    "tp_below_one": (lambda: ContinuousBatchingEngine(
        port_model(), tp=0, device="cpu"), "tp degree"),
    "group_below_one": (lambda: TensorParallelGroup(0, "cpu"), "tp degree"),
    "nccl_on_cpu": (lambda: TensorParallelGroup(2, "cpu", backend="nccl"),
                    "NCCL"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refused(case):
    before = set(multiprocessing.active_children())
    build, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        build()
    assert set(multiprocessing.active_children()) <= before


def test_biased_row_parallel_projection_refused():
    pm = port_model()
    o = pm.model.layers[1].self_attn.o_proj
    o.bias = torch.nn.Parameter(torch.zeros(o.out_features))
    with pytest.raises(ValueError, match="bias-free"):
        _tp_plan(pm, 2)


def test_decoder_and_cache_refusals(group):
    with pytest.raises(ValueError, match="quantize"):
        PagedDecoder(port_model(), quantize="w8", tp_group=group)
    with pytest.raises(ValueError, match="kv_heads"):
        PagedKVCache(num_layers=2, kv_heads=1, head_dim=8, total_pages=4,
                     page_size=8, device="cpu", tp_group=group)
    # a decoder steps only a cache sharded over its own group
    pm = port_model()
    plain = PagedKVCache.from_model(pm, total_pages=4, page_size=8)
    with pytest.raises(ValueError, match="its own"):
        PagedDecoder(pm, tp_group=group).prefill(
            plain, [0], _prompts((5,))[0][None])
    assert plain.length(0) == 0


# ------------------------------------------------- recovery and workers
def at_step_boundary(eng, plan):
    """Install a fault plan between two engine steps."""
    with eng._cond:
        eng._snap_waiters += 1
        try:
            while eng._stepping:
                eng._cond.wait(0.1)
            faults.install(faults.FaultPlan(plan))
        finally:
            eng._snap_waiters -= 1
            eng._cond.notify_all()


def ripen(eng, prompts, new, min_generated=2):
    """Submit every prompt and wait until each row is mid-decode."""
    faults.install(faults.FaultPlan(
        [{"site": "decode_step", "kind": "delay", "delay_s": 0.01}]))
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    end = time.monotonic() + 60
    while not all(len(r.generated) >= min_generated for r in reqs):
        assert time.monotonic() < end, "rows never reached mid-decode"
        time.sleep(0.005)
    assert not any(r.done.is_set() for r in reqs)
    return reqs


def test_buffer_loss_survivors_equal_fault_free():
    prompts = _prompts((5, 6, 7, 8), seed=20)
    want = port_run(prompts, new=12)
    with ContinuousBatchingEngine(port_model(), tp=2, device="cpu",
                                  **ENGINE) as eng:
        reqs = ripen(eng, prompts, 12)
        at_step_boundary(eng, [{"site": "buffer_loss", "nth": 1}])
        got = [r.result(timeout=120).tolist() for r in reqs]
        assert (eng.rebuilds, eng.survivor_replays, eng.quarantined) \
            == (1, 4, 0)
    assert got == want


def test_tp1_snapshot_restores_into_tp2():
    prompts = _prompts((5, 6, 7, 8), seed=20)
    want = port_run(prompts, new=12)
    eng = ContinuousBatchingEngine(port_model(), device="cpu", **ENGINE)
    ripen(eng, prompts, 12, min_generated=3)
    snap = eng.snapshot()
    eng.stop()
    faults.clear()
    by_prompt = {tuple(p.tolist()): w for p, w in zip(prompts, want)}
    with ContinuousBatchingEngine(port_model(), tp=2, device="cpu",
                                  **ENGINE) as eng:
        restored = eng.restore(snap)
        got = [r.result(timeout=120).tolist() for r in restored]
    assert len(restored) == 4
    assert got == [by_prompt[tuple(r.prompt.tolist())] for r in restored]


def test_killed_worker_fails_requests_naming_its_rank():
    with ContinuousBatchingEngine(port_model(), tp=2, device="cpu",
                                  **ENGINE) as eng:
        worker = eng.tp_group._procs[0]
        worker.kill()
        worker.join(30)
        t0 = time.monotonic()
        for p in _prompts((5, 9)):
            with pytest.raises(TensorParallelError, match="rank 1"):
                eng.submit(p, max_new_tokens=4).result(timeout=60)
        assert time.monotonic() - t0 < 30
    _ended(eng.tp_group)


def test_rank0_failing_mid_body_closes_the_group(monkeypatch):
    """The worker is left inside the body, so the ranks are out of step:
    the group closes rather than pair later collectives wrongly."""
    with TensorParallelGroup(2, "cpu") as g:
        pm = port_model()
        dec = PagedDecoder(pm, tp_group=g)
        cache = PagedKVCache.from_model(pm, total_pages=8, page_size=8,
                                        tp_group=g)

        def broken(x):
            raise RuntimeError("rank 0 lost its last norm")

        monkeypatch.setattr(dec.model.model.norm, "forward", broken)
        with pytest.raises(TensorParallelError, match="out of step") as e:
            dec.prefill(cache, [0], _prompts((5,))[0][None])
        assert "lost its last norm" in str(e.value.__cause__)
        assert cache.length(0) == 0
        _ended(g)


def test_close_ends_every_worker(group):
    group.close()
    _ended(group)
    with pytest.raises(TensorParallelError, match="closed"):
        group.check()
