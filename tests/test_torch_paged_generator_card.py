"""The paged decoder's decode, verify, multi-step and batched context
steps as CUDA graphs (``GraphedPagedDecoder``) against the eager
``PagedDecoder`` on the card, and ``PagedGenerator`` on the card against
the CPU's, on a small LLaMA whose attention, RMSNorm and RoPE run the
port's kernels.  These need a CUDA device; elsewhere they skip.  Run
them on the card with

    python -m pytest --noconftest tests/test_torch_paged_generator_card.py

Graphed and eager run the same kernels in the same order on the same
inputs: ids are held bit for bit, f32 logits within 1e-5, and each
kernel wrapper's launch count after a replay equals the eager call's."""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.cuda_graphs import counted_wrappers
from paddle_tpu_torch.inference import PagedGenerator, paged
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.paged_attention import PagedKVCache

pytestmark = pytest.mark.cuda

VOCAB = 256
CFG = dict(vocab_size=VOCAB, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=256)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (quantize, kv_dtype) of the graphed-vs-eager cases
MODES = {"plain": (None, None), "w8a8_int8kv": ("w8a8", "int8")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode")
    return torch.device("cuda")


def _model(dtype, device="cuda"):
    return LlamaForCausalLM(LlamaConfig(**CFG), device=device, dtype=dtype,
                            seed=3)


def _script(rng, base):
    """The calls of one pass, on sequences ``base + 0..2``: a prefill, a
    batched context prefill (a fresh row among them), decode steps
    (logits, greedy, drawn), verify blocks (logits, greedy, drawn), and
    multi-step runs of 5 and 7 (one step bucket)."""
    s = [base, base + 1, base + 2]
    draw4 = (np.array([3, 4, 5], np.uint32), None,
             np.array([0.8, 1.0, 1.2], np.float32),
             np.array([True, False, True]))
    greedy4 = (np.zeros(3, np.uint32), None, np.ones(3, np.float32),
               np.zeros(3, bool))
    rows = [rng.integers(0, VOCAB, n).astype(np.int32) for n in (6, 9, 4)]
    return [
        ("prefill", (s[:2], rng.integers(0, VOCAB, (2, 11)).astype(
            np.int32)), {}),
        ("batch_context_prefill", (s, rows, [11, 11, 0]), {}),
        ("step", (s, None, [17, 20, 4]), {}),
        ("step", (s, None, [18, 21, 5]), {"sampling": greedy4}),
        ("step", (s, None, [19, 22, 6]), {"sampling": draw4}),
        ("verify", (s, None, [20, 23, 7], 4), {}),
        ("verify", (s, None, [24, 27, 11], 4),
         {"sampling": (draw4[0], draw4[2], np.zeros(3, bool))}),
        ("verify", (s, None, [28, 31, 15], 4),
         {"sampling": (draw4[0], draw4[2], draw4[3])}),
        ("multi_step", (s, None, [32, 35, 19], 5), {}),
        ("multi_step", (s, None, [37, 40, 24], 7), {}),
    ]


def _run(dec, cache, calls, feed):
    """Run ``calls`` on one decoder; ``feed`` carries each row's last
    token between calls.  Yields (output, launches by wrapper) a call."""
    wrappers = counted_wrappers()
    for name, args, kw in calls:
        counts = [fn.launches for fn in wrappers]
        seqs = args[0]
        if name == "prefill":
            out = dec.prefill(cache, args[0], args[1])
            feed[:2] = out.argmax(-1)
        elif name == "batch_context_prefill":
            out = dec.batch_context_prefill(cache, *args)
            feed[:] = out.argmax(-1)
        elif name == "step":
            sampling = kw.get("sampling")
            if sampling is not None:
                sampling = (sampling[0], np.asarray(args[2]) + 1,
                            *sampling[2:])
            out = dec.step(cache, seqs, feed[:, None].astype(np.int32),
                           np.asarray(args[2], np.int32), sampling=sampling)
            feed[:] = out if sampling is not None else out.argmax(-1)
        elif name == "verify":
            for sid, p in zip(seqs, args[2]):
                cache.truncate(sid, p)
            block = np.stack([feed] + [(feed + j) % VOCAB
                                       for j in range(1, args[3])], axis=1)
            out = dec.verify(cache, seqs, block.astype(np.int32),
                             np.asarray(args[2], np.int32), **kw)
            feed[:] = out[0] if "sampling" in kw else out[0].argmax(-1)
        else:
            for sid, p in zip(seqs, args[2]):
                cache.truncate(sid, p)
            out = dec.multi_step(cache, seqs, feed.astype(np.int32),
                                 np.asarray(args[2], np.int32), args[3])
            feed[:] = out[:, -1]
        torch.cuda.synchronize()
        yield out, {fn.__name__: fn.launches - n
                    for fn, n in zip(wrappers, counts) if fn.launches != n}


def _outputs_equal(name, a, b, dtype):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if x.dtype == np.float32 and dtype == torch.float32:
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_graphed_steps_equal_eager(dev, dt, mode):
    """Every call of the script twice: graphed outputs equal eager's
    (ids bit for bit, f32 logits within 1e-5), each kernel wrapper's
    launches a call equal eager's, one capture a key on the first pass
    and none on the second, a multi-step run of N counted as N
    replays."""
    quant, kv = MODES[mode]
    model = _model(DTYPES[dt])
    decs = [paged.PagedDecoder(model, quantize=quant),
            paged.GraphedPagedDecoder(model, quantize=quant)]
    caches = [PagedKVCache.from_model(model, total_pages=64, page_size=16,
                                      kv_dtype=kv) for _ in decs]
    for rnd in range(2):
        calls = _script(np.random.default_rng(rnd), 10 * rnd)
        feeds = [np.zeros(3, np.int64) for _ in decs]
        captures, replays = decs[1].captures, decs[1].replays
        runs = [_run(d, c, calls, f) for d, c, f in zip(decs, caches, feeds)]
        for (name, _a, _k), (out_e, n_e), (out_g, n_g) in zip(calls, *runs):
            _outputs_equal(name, out_e, out_g, DTYPES[dt])
            assert n_g == n_e, name
            assert n_e.get("paged_attention_cuda", 0) or name in (
                "prefill", "batch_context_prefill"), name
        keys = len(decs[1]._graphs)
        if rnd == 0:
            assert decs[1].captures == keys
        else:
            assert decs[1].captures == captures
        # a multi-step run of N replays N times (N - 1 on a capture)
        assert decs[1].replays - replays == \
            sum(c[1][3] if c[0] == "multi_step" else 1 for c in calls) \
            - (decs[1].captures - captures)
        for sid in range(10 * rnd, 10 * rnd + 3):
            for c in caches:
                c.free(sid)
    assert {k[0] for k in decs[1]._graphs} == {
        "prefill", "prefix", "decode", "verify", "multi"}


def test_multi_step_replays_without_a_host_read(dev):
    """A multi-step run of 6 on a captured key: 6 replays, one upload and
    one download, and the tokens equal 6 single greedy decode steps."""
    model = _model(torch.float32)
    dec = paged.GraphedPagedDecoder(model)
    cache = PagedKVCache.from_model(model, total_pages=64, page_size=16)
    ids = np.random.default_rng(1).integers(0, VOCAB, (2, 9)).astype(
        np.int32)
    first = dec.prefill(cache, [0, 1], ids).argmax(-1).astype(np.int32)
    dec.multi_step(cache, [0, 1], first, np.array([9, 9], np.int32), 6)
    for sid in (0, 1):
        cache.truncate(sid, 9)
    moves = []
    up, down = paged._Staging.upload, paged._Staging.download
    paged._Staging.upload = lambda st: moves.append("up") or up(st)
    paged._Staging.download = lambda st: moves.append("down") or down(st)
    try:
        replays = dec.replays
        got = dec.multi_step(cache, [0, 1], first,
                             np.array([9, 9], np.int32), 6)
    finally:
        paged._Staging.upload, paged._Staging.download = up, down
    assert moves == ["up", "down"] and dec.replays - replays == 6
    eager = paged.PagedDecoder(model)
    c2 = PagedKVCache.from_model(model, total_pages=64, page_size=16)
    tok = eager.prefill(c2, [0, 1], ids).argmax(-1).astype(np.int32)
    want = []
    greedy = (np.zeros(2, np.uint32), np.zeros(2, np.int32),
              np.ones(2, np.float32), np.zeros(2, bool))
    for j in range(6):
        tok = eager.step(c2, [0, 1], tok[:, None],
                         np.full(2, 9 + j, np.int32), sampling=greedy)
        want.append(tok)
    np.testing.assert_array_equal(got, np.stack(want, axis=1))


@pytest.mark.parametrize("kw", [{}, {"eos": True}, {"tight": True}],
                         ids=["greedy", "eos", "pool_pressure"])
def test_generator_on_the_card_equals_the_cpu(dev, kw):
    """``PagedGenerator`` on the card (graphs) and on the CPU (plain
    versions), same f32 weights: equal greedy tokens, with an eos and
    under pool pressure (one step a token after a chunk fails); the
    timed-again call captures nothing."""
    cpu = _model(torch.float32, device="cpu")
    gpu = _model(torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, 9)).astype(
        np.int32)
    # 5 pages of 16: a 9 + 20 token row fits in two, but the first chunk
    # (rounded up to 32 tokens) needs three each
    pages = 5 if kw.get("tight") else 64
    gens = [PagedGenerator(m, total_pages=pages, page_size=16, device=d)
            for m, d in ((gpu, "cuda"), (cpu, "cpu"))]
    eos = None
    if kw.get("eos"):
        eos = int(gens[1].generate(ids, max_new_tokens=12)[0, 12])
    outs = [g.generate(ids, max_new_tokens=20, eos_token_id=eos)
            for g in gens]
    np.testing.assert_array_equal(outs[0], outs[1])
    captures = gens[0]._decoder.captures
    again = gens[0].generate(ids, max_new_tokens=20, eos_token_id=eos)
    np.testing.assert_array_equal(again, outs[0])
    assert gens[0]._decoder.captures == captures
    assert gens[0].cache.free_pages == pages
