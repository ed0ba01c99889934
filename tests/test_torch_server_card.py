"""``GenerationServer`` on the card: the in-process server's f32 streams
(greedy and a sampled row with a pinned seed) equal the engine's own on
the same model, and a served wave after a warm-up (every ragged decode
bucket, then a wave of the same lengths) makes no blocking CUDA sync
(``torch.cuda.set_sync_debug_mode("warn")`` reports none) and captures
no CUDA graph.  These need a CUDA device; elsewhere they skip.
Run them on the card with

    python -m pytest --noconftest tests/test_torch_server_card.py

The CPU twins are in ``tests/test_torch_server.py``."""
import json
import threading
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationServer)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=512)
ENGINE = dict(total_pages=128, page_size=16, max_batch=4)
NEW = 16


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels have "
                    "no CPU mode")
    return LlamaForCausalLM(LlamaConfig(**CFG), device="cuda", seed=7)


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (9, 40, 130)]


BODIES = [dict(), dict(), dict(do_sample=True, temperature=0.8, seed=5)]


def _post(srv, body):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _served(srv, prompts):
    """The prompts as concurrent one-row POSTs; their output ids."""
    out = [None] * len(prompts)

    def client(i):
        out[i] = _post(srv, dict({"input_ids": [prompts[i].tolist()],
                                  "max_new_tokens": NEW},
                                 **BODIES[i]))["output_ids"][0]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


def test_http_streams_equal_engine_streams_f32(model):
    prompts = _prompts(1)
    with ContinuousBatchingEngine(model, device="cuda", **ENGINE) as eng:
        reqs = [eng.submit(p, max_new_tokens=NEW, **kw)
                for p, kw in zip(prompts, BODIES)]
        want = [r.result(timeout=300).tolist() for r in reqs]
    with GenerationServer(model, device="cuda", **ENGINE) as srv:
        got = _served(srv, prompts)
        health = srv.health()
    assert got == want
    assert health["free_pages"] == health["total_pages"]


def _warm_ragged(eng, rows=(1, 2, 4)):
    """Capture the ragged decode graphs (span 1) at every row bucket with
    both tails: arrival order decides which batches a wave of HTTP
    requests makes, so a warm-up wave alone may miss some."""
    for b in rows:
        for draw in (False, True):
            seqs = [f"__warm{i}" for i in range(b)]
            flags = np.zeros(b, bool)
            flags[0] = draw
            eng._decoder.ragged_step(
                eng.cache, seqs, [np.zeros(1, np.int32)] * b, [0] * b,
                sampling=(np.zeros(b, np.uint32),
                          np.full(b, 0.8, np.float32), flags))
            for sid in seqs:
                eng.cache.free(sid)


def test_served_wave_makes_no_blocking_sync(model):
    # the table width pinned at the longest request's pages, so a step's
    # graph key does not depend on which rows share it
    with GenerationServer(model, device="cuda", min_table_pages=16,
                          **ENGINE) as srv:
        _warm_ragged(srv._engine)
        _served(srv, _prompts(2))                 # warm-up: captures
        captures = srv._engine.captures
        with warnings.catch_warnings(record=True) as log:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = _served(srv, _prompts(3))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert srv._engine.captures == captures
        assert srv._engine.replays > 0
    syncs = [str(w.message) for w in log
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert syncs == []
    assert all(len(row) == len(p) + NEW
               for row, p in zip(got, _prompts(3)))
