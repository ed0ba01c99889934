"""The engine's crash recovery on the card: the engine's steps and its
replays as CUDA graphs (``GraphedPagedDecoder``) against the same engine
on the CPU from the same f32 weights, and the graphs captured before a
``buffer_loss`` replayed after it.  These need a CUDA device; elsewhere
they skip.  Run them on the card with

    python -m pytest --noconftest tests/test_torch_crash_recovery_card.py

The ``buffer_loss`` site zeroes the pools in place, so the graphs
captured over them stay valid: after the loss the graphed decoder must
give what the eager decoder gives on the card, bit for bit.  In f32 the
card's kernels and the CPU's plain versions give the same greedy ids on
this small model, so the engine's streams are held exactly.

A collection that runs inside a capture and frees an unreachable graph
would invalidate that capture (a graph's destroy is a call the capturing
thread may not make): ``cuda_graphs.capture`` keeps the collector off
while a body is captured, which a batched replay's first call (the
largest body the engine captures) relies on."""
import gc
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.cuda_graphs import capture
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference.paged import GraphedPagedDecoder, PagedDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.paged_attention import PagedKVCache
from paddle_tpu_torch.testing import faults

pytestmark = pytest.mark.cuda

VOCAB = 256
CFG = dict(vocab_size=VOCAB, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=256)
ENGINE = dict(total_pages=64, page_size=16, max_batch=4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear()


def _pair(seed=3):
    cpu = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=seed)
    card = LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", seed=None)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, VOCAB, n).astype(np.int32)
            for n in (7, 30, 75, 12)]


def _serve(model, device, unified, batched, loss):
    """Four requests (the last sampled) to mid-decode, then, with
    ``loss``, one ``buffer_loss`` at a step boundary: the streams, the
    recovery counters and whether the engine drained whole."""
    kws = [{}, {}, {}, dict(do_sample=True, temperature=0.9, seed=3)]
    with ContinuousBatchingEngine(model, unified_step=unified,
                                  replay_batch=batched, device=device,
                                  **ENGINE) as eng:
        faults.install(faults.FaultPlan(
            [{"site": "decode_step", "kind": "delay", "delay_s": 0.01}]))
        reqs = [eng.submit(p, max_new_tokens=12, **kw)
                for p, kw in zip(_prompts(), kws)]
        end = time.monotonic() + 120
        while not all(len(r.generated) >= 3 for r in reqs):
            assert time.monotonic() < end
            time.sleep(0.002)
        if loss:
            with eng._cond:
                eng._snap_waiters += 1
                while eng._stepping:
                    eng._cond.wait(0.1)
                faults.install(faults.FaultPlan(
                    [{"site": "buffer_loss", "nth": 1}]))
                eng._snap_waiters -= 1
                eng._cond.notify_all()
        streams = [r.result(timeout=300).tolist() for r in reqs]
        faults.clear()
        state = (eng.rebuilds, eng.survivor_replays, eng.quarantined)
        drained = eng.drain(timeout=60) \
            and eng.cache.free_pages == ENGINE["total_pages"] \
            and eng._reserved_pages == eng._pad_pages
    return streams, state, drained


@pytest.mark.parametrize("batched", [False, True], ids=["per_row", "batched"])
@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
def test_small_recovery_card_equals_cpu(dev, unified, batched):
    cpu, card = _pair()
    got, state, drained = _serve(card, "cuda", unified, batched, True)
    host, host_state, _ = _serve(cpu, "cpu", unified, batched, True)
    clean, _, _ = _serve(card, "cuda", unified, batched, False)
    assert drained and state == host_state == (1, 4, 0)
    assert got == host == clean


def _decode(dec, cache, seqs, tokens):
    """One greedy decode step of ``seqs``: the next ids."""
    pos = np.array([cache.length(s) for s in seqs], np.int32)
    greedy = (np.zeros(len(seqs), np.uint32), pos + 1,
              np.ones(len(seqs), np.float32), np.zeros(len(seqs), bool))
    return dec.step(cache, seqs, np.asarray(tokens, np.int32)[:, None],
                    pos, sampling=greedy)


def _script(dec, cache, prompt_ids):
    """Prefill two rows, decode 3 steps, lose the pools on the 4th, replay
    both rows through prefill (the captured prefill bucket), decode 3
    more: every id and the pools after."""
    seqs = [0, 1]
    greedy = (np.zeros(2, np.uint32), np.full(2, prompt_ids.shape[1],
                                              np.int32),
              np.ones(2, np.float32), np.zeros(2, bool))
    ids = [dec.prefill(cache, seqs, prompt_ids, sampling=greedy).tolist()]
    history = np.concatenate([prompt_ids, np.asarray(ids[0])[:, None]], 1)
    for _ in range(3):
        ids.append(_decode(dec, cache, seqs, ids[-1]).tolist())
        history = np.concatenate([history, np.asarray(ids[-1])[:, None]],
                                 1)
    gen = cache.generation
    with faults.installed(faults.FaultPlan(
            [{"site": "buffer_loss", "nth": 1}])):
        with pytest.raises(faults.FaultError):
            _decode(dec, cache, seqs, ids[-1])
    assert cache.generation == gen + 1
    assert all(int(p.abs().max()) == 0 for p in cache.k_pages)
    # the replay: each row's resident tokens (all but the last sampled)
    # through a fresh prefill of the same length
    for s in seqs:
        cache.truncate(s, 0)
    dec.prefill(cache, seqs, history[:, :-1], sampling=greedy)
    for _ in range(3):
        ids.append(_decode(dec, cache, seqs, ids[-1]).tolist())
    return ids, [p.clone() for p in cache.k_pages + cache.v_pages]


def test_graphs_stay_valid_after_a_buffer_loss(dev):
    _cpu, card = _pair()
    rng = np.random.default_rng(9)
    prompt_ids = rng.integers(0, VOCAB, (2, 13)).astype(np.int32)
    runs = []
    for cls in (GraphedPagedDecoder, PagedDecoder):
        dec = cls(card)
        cache = PagedKVCache.from_model(card, total_pages=32, page_size=16)
        runs.append(_script(dec, cache, prompt_ids))
        if cls is GraphedPagedDecoder:
            # captured: the prefill and the decode step at table widths 1
            # and 2 (the faulted step captured nothing); replayed: two
            # decode steps before the loss, the prefill graph in the
            # replay and two decode steps after
            assert (dec.captures, dec.replays) == (3, 5)
    (g_ids, g_pools), (e_ids, e_pools) = runs
    assert g_ids == e_ids
    assert all(torch.equal(a, b) for a, b in zip(g_pools, e_pools))


def test_a_collection_inside_a_capture_frees_no_graph(dev):
    """An earlier graph held only by a reference cycle turns to garbage
    while a body is captured, and the body's allocations would set off
    a full collection (thresholds 1, 1, 1): the capture still succeeds,
    the old graph is freed after it, and the new graph replays right."""
    x = torch.arange(256, device=dev, dtype=torch.float32)
    stream = torch.cuda.Stream(dev)
    old = torch.cuda.CUDAGraph()
    capture(old, torch.cuda.graph_pool_handle(), stream, lambda: x * 2)
    cycle = [old]
    cycle.append(cycle)                 # only the collector frees it
    held = {"cycle": cycle}
    del old, cycle
    thresholds = gc.get_threshold()

    def body():
        held.clear()                    # the old graph is garbage now
        gc.set_threshold(1, 1, 1)
        junk = [[i] for i in range(2000)]
        del junk
        return x + 1

    new = torch.cuda.CUDAGraph()
    try:
        out, _ = capture(new, torch.cuda.graph_pool_handle(), stream, body)
    finally:
        gc.set_threshold(*thresholds)
    assert gc.isenabled()
    gc.collect()
    new.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, x + 1)
