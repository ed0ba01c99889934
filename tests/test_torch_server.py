"""Port parity: ``GenerationServer`` over HTTP and the engine's journal.

The JAX engine serves the same prompts once for the module, on a 2-layer
tiny LLaMA whose weights the port's model carries over (CPU, f32).  The
port's ``/generate`` must give the JAX engine's greedy ids exactly; the
error mapping of ``tests/test_inference_server.py`` and
``tests/test_engine_faults.py`` holds on the port (400, 404, 429 with
``Retry-After``, 501, 503, 504, 500); a server restarted on the same
``journal_dir`` after a hard stop, or on the same ``snapshot_path`` after
a SIGTERM, resumes the requests under their ids to the streams of an
uninterrupted run (``tests/test_crash_recovery.py``); and a port engine's
journal, fed the same prompts under the same ids as a JAX engine's,
recovers to the same live set."""
import contextlib
import json
import os
import signal
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)

import paddle_tpu as paddle
from paddle_tpu.inference.continuous import \
    ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.journal import RequestJournal as JaxJournal
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.testing import faults as jax_faults
from paddle_tpu_torch.distributed.fault_tolerance import PreemptionHandler
from paddle_tpu_torch.inference import ContinuousBatchingEngine
from paddle_tpu_torch.inference import GenerationServer
from paddle_tpu_torch.inference.journal import RequestJournal
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.testing import faults

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=2, max_position_embeddings=64)
ENGINE = dict(total_pages=64, page_size=8, max_batch=4)
NEW = 12
IDS = ["r0", "r1", "r2"]
KWS = [{}, dict(priority="batch", tenant="offline"),
       dict(do_sample=True, temperature=0.8, seed=7)]


@contextlib.contextmanager
def numpy_init(seed):
    """The JAX initializers' draws from a numpy generator: the same laws,
    without compiling ``jax.random`` for every parameter shape."""
    rng = np.random.default_rng(seed)

    def uniform(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(rng.uniform(minval, maxval, shape), dtype)

    def normal(key, shape, dtype=jnp.float32):
        return jnp.asarray(rng.standard_normal(shape), dtype)

    with mock.patch.object(jax.random, "uniform", uniform), \
            mock.patch.object(jax.random, "normal", normal):
        yield


def _prompts():
    """Three 10-token prompts: a full page each, so prefill completion
    journals page provenance."""
    rng = np.random.default_rng(31)
    return [rng.integers(0, 64, (10,)).astype(np.int32) for _ in range(3)]


def wait_for(cond, what, timeout=60.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.005)


def ripen(eng, pace, ids=None, min_generated=2):
    """Submit the prompts (under ``ids``) and wait until every row is
    mid-decode, with decode steps paced by a mild delay."""
    pace.install(pace.FaultPlan(
        [{"site": "decode_step", "kind": "delay", "delay_s": 0.01}]))
    reqs = [eng.submit(p, max_new_tokens=NEW,
                       request_id=None if ids is None else ids[i], **kw)
            for i, (p, kw) in enumerate(zip(_prompts(), KWS))]
    wait_for(lambda: all(len(r.generated) >= min_generated for r in reqs),
             "every row mid-decode")
    assert not any(r.done.is_set() for r in reqs)
    return reqs


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    with numpy_init(0):
        jm = JaxLM(JaxConfig(**TINY))
    arrays = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    return jm, params_from_numpy(LlamaConfig(**TINY), arrays, device="cpu")


@pytest.fixture(scope="module")
def want(models, tmp_path_factory):
    """One JAX engine run: the uninterrupted streams of the three
    prompts (greedy, greedy in the batch class, sampled with a pinned
    seed); and a journaled JAX engine hard-stopped mid-decode, with the
    live set its journal recovers."""
    jm = models[0]
    with JaxEngine(jm, **ENGINE) as eng:
        reqs = [eng.submit(p, max_new_tokens=NEW, **kw)
                for p, kw in zip(_prompts(), KWS)]
        streams = [r.result(timeout=120).tolist() for r in reqs]
    d = str(tmp_path_factory.mktemp("jax_journal"))
    j = JaxJournal(d, fsync="always")
    eng = JaxEngine(jm, journal=j, **ENGINE)
    try:
        ripen(eng, jax_faults, IDS)
    finally:
        eng.stop()          # hard stop: no retire records, as a SIGKILL
        jax_faults.clear()
        j.close()
    with JaxJournal(d) as j:
        live = j.recovered_requests()
    return {"streams": streams, "live": live}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear()
    jax_faults.clear()


def server(model, **kw):
    for k, v in ENGINE.items():
        kw.setdefault(k, v)
    return GenerationServer(model, device="cpu", **kw)


def url(srv, path):
    return f"http://{srv.host}:{srv.port}{path}"


def post(srv, path, body, timeout=120):
    req = urllib.request.Request(url(srv, path),
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def get(srv, path, timeout=30):
    try:
        with urllib.request.urlopen(url(srv, path), timeout=timeout) as r:
            body = r.read()
            ctype = r.headers.get("Content-Type", "")
            return r.status, (json.loads(body) if "json" in ctype
                              else body.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _prefix_of(entry, stream):
    """The entry's generated tokens and pending token continue its
    prompt along ``stream``."""
    got = list(entry["prompt"]) + list(entry["generated"]) \
        + [entry["next_token"]]
    return got == stream[:len(got)]


# ------------------------------------------------------------ /generate
def test_generate_matches_jax_engine_greedy(models, want):
    """The two greedy rows as one /generate batch give the JAX engine's
    ids; /health, /metrics and the request ids answer."""
    ids = np.stack(_prompts()[:2])
    with server(models[1]) as srv:
        code, out, _ = post(srv, "/generate",
                            {"input_ids": ids.tolist(),
                             "max_new_tokens": NEW})
        assert code == 200
        assert out["new_tokens"] == NEW
        assert out["output_ids"] == want["streams"][:2]
        assert len(out["request_ids"]) == 2
        for rid, stream in zip(out["request_ids"], want["streams"]):
            code, res = get(srv, f"/result/{rid}")
            assert code == 200 and res["output_ids"] == stream
        code, health = get(srv, "/health")
        assert code == 200 and health["status"] == "ok"
        assert health["free_pages"] == health["total_pages"] == 64
        assert health["requests_total"] >= 1
        assert health["tp"] == 1 and health["mesh_shape"] is None
        assert health["quantize"] is None and health["kv_quant"] is None
        assert health["speculative"] is False
        code, text = get(srv, "/metrics")
        assert code == 200
        assert ('requests_total{server="generation",'
                'route="/generate"}') in text
        assert "generated_tokens_total" in text


def test_health_keys_match_jax_server(models):
    """/health answers the JAX server's keys (its tp fields too; a
    journal adds ``journal`` and ``restored_requests``)."""
    import paddle_tpu.inference.server as jax_server
    import inspect
    src = inspect.getsource(jax_server.GenerationServer.__init__)
    keys = {k for k in ("status", "draining", "uptime_s",
                        "requests_total", "free_pages", "total_pages",
                        "page_size", "cached_prefix_pages",
                        "sampling_on_device", "active_sequences",
                        "queued_sequences", "retry_after_hint",
                        "scheduler", "quantize", "kv_quant",
                        "kv_pool_bytes", "kv_scale_bytes", "tp",
                        "mesh_shape", "tp_quant_collectives",
                        "kv_pool_bytes_per_chip", "speculative")
            if f'"{k}"' in src}
    assert len(keys) == 22
    with server(models[1]) as srv:
        assert set(srv.health()) == keys


# ---------------------------------------------------------- error mapping
def test_bad_requests_are_400(models):
    with server(models[1]) as srv:
        code, body, _ = post(srv, "/generate", {"input_ids": [1, 2, 3]})
        assert code == 400 and "2-D" in body["error"]
        code, body, _ = post(srv, "/generate", [[1, 2]])
        assert code == 400 and "JSON object" in body["error"]
        code, body, _ = post(srv, "/generate",
                             {"input_ids": [[1, 2]], "priority": "vip"})
        assert code == 400 and "vip" in body["error"]
        code, body, _ = post(srv, "/generate", {"max_new_tokens": 2})
        assert code == 400


def test_rope_overflow_400_pool_overflow_503(models):
    with server(models[1], total_pages=8) as srv:
        code, body, _ = post(srv, "/generate",
                             {"input_ids": [[1] * 40],
                              "max_new_tokens": 100})
        assert code == 400 and "max_position" in body["error"]
        code, body, _ = post(srv, "/generate",
                             {"input_ids": [[1] * 40],
                              "max_new_tokens": 24})
        assert code == 503 and "pages" in body["error"]
        code, body, _ = post(srv, "/generate",
                             {"input_ids": [[1] * 4], "max_new_tokens": 2})
        assert code == 200 and body["new_tokens"] == 2


@pytest.mark.parametrize("priority", [None, "batch"])
def test_queue_overflow_429_with_class_aware_retry_after(models, priority):
    """A full class queue is 429 with a ``Retry-After`` equal to the
    engine's hint for that class; another class's queue still admits."""
    rng = np.random.default_rng(14)
    results = []
    extra = {} if priority is None else {"priority": priority}

    def client(srv, max_new):
        results.append(post(srv, "/generate", dict(
            {"input_ids": rng.integers(0, 64, (1, 4)).tolist(),
             "max_new_tokens": max_new}, **extra), timeout=300))

    with faults.installed(faults.FaultPlan(
            [{"site": "decode_step", "kind": "delay", "delay_s": 0.03}])):
        with server(models[1], max_batch=1, max_queue=1) as srv:
            t1 = threading.Thread(target=client, args=(srv, 24))
            t1.start()
            wait_for(lambda: len(srv._engine._active) == 1, "one active")
            t2 = threading.Thread(target=client, args=(srv, 4))
            t2.start()
            wait_for(lambda: len(srv._engine._sched) == 1, "one queued")
            code, body, headers = post(srv, "/generate", dict(
                {"input_ids": [[5, 6, 7]], "max_new_tokens": 4}, **extra))
            assert code == 429
            hint = int(headers["Retry-After"])
            assert 1 <= hint <= 30
            assert hint == srv._engine.retry_after_hint(priority)
            if priority is not None:
                assert priority in body["error"]
                assert srv._engine.retry_after_hint("interactive") == 1
                code, _, _ = post(srv, "/generate", {
                    "input_ids": [[1, 2, 3]], "max_new_tokens": 2,
                    "priority": "interactive"}, timeout=300)
                assert code == 200
            t1.join(timeout=300)
            t2.join(timeout=300)
    assert [c for c, _, _ in results] == [200, 200]


def test_request_body_ttl_maps_to_504(models):
    with faults.installed(faults.FaultPlan(
            [{"site": "decode_step", "kind": "delay", "delay_s": 0.05}])):
        with server(models[1]) as srv:
            code, body, _ = post(srv, "/generate", {
                "input_ids": [[1, 2, 3, 4]], "max_new_tokens": 40,
                "timeout_s": 0.2})
            assert code == 504 and "TTL" in body["error"]


def test_http_handler_fault_is_500(models):
    with server(models[1]) as srv:
        with faults.installed(faults.FaultPlan(
                [{"site": "http_handler", "nth": 1}])):
            code, body, _ = post(srv, "/generate",
                                 {"input_ids": [[1, 2]],
                                  "max_new_tokens": 2})
        assert code == 500 and "injected fault" in body["error"]
        code, _, _ = post(srv, "/generate", {"input_ids": [[1, 2]],
                                             "max_new_tokens": 2})
        assert code == 200


def test_routes_404_501_trace_and_timeline(models):
    """Unknown routes and ids are 404, ``/debug/cost`` is 501 naming the
    missing analysis tier, and a trace window exports a valid chrome
    trace with the request's timeline."""
    from paddle_tpu_torch import monitor
    with server(models[1]) as srv:
        assert get(srv, "/nope")[0] == 404
        assert post(srv, "/nope", {})[0] == 404
        assert get(srv, "/result/never")[0] == 404
        code, body = get(srv, "/debug/cost")
        assert code == 501 and "paddle_tpu.analysis" in body["error"]
        assert post(srv, "/debug/trace/start", {})[1] == {"capturing": True}
        code, out, _ = post(srv, "/generate", {
            "input_ids": [[1, 2, 3]], "max_new_tokens": 3,
            "request_id": "traced"})
        assert code == 200 and out["request_ids"] == ["traced"]
        assert post(srv, "/debug/trace/stop", {})[1] == {
            "capturing": False}
        code, trace = get(srv, "/debug/trace")
        assert code == 200 and monitor.validate_chrome_trace(trace) == []
        code, tl = get(srv, "/debug/requests/traced")
        assert code == 200
        assert "retire" in [e["kind"] for e in tl["events"]]
        assert get(srv, "/debug/requests/other")[0] == 404


def test_sigterm_drains_rejecting_new_and_admin_migrate(models, want):
    """SIGTERM through ``PreemptionHandler``: the requests in flight
    finish with the JAX engine's streams, a new /generate and
    /admin/migrate get 503 with ``draining``; before it, /admin/migrate
    restores entries and reports an id it already knows as live."""
    prompts = _prompts()
    handler = PreemptionHandler(signals=())
    results = [None, None]

    def client(i, srv):
        results[i] = post(srv, "/generate", {
            "input_ids": [prompts[i].tolist()], "max_new_tokens": NEW},
            timeout=300)

    with server(models[1], max_batch=2) as srv:
        entry = {"request_id": "moved", "prompt": prompts[0].tolist(),
                 "generated": want["streams"][0][10:13],
                 "next_token": want["streams"][0][13],
                 "max_new_tokens": NEW}
        code, body, _ = post(srv, "/admin/migrate", {"requests": [entry]})
        assert code == 200 and body["restored"] == ["moved"]
        wait_for(lambda: srv._engine.result_for("moved")["status"]
                 == "done", "migrated request done")
        assert srv._engine.result_for("moved")["output_ids"] \
            == want["streams"][0]
        code, body, _ = post(srv, "/admin/migrate", {"requests": [entry]})
        assert body["live"] == ["moved"] and body["restored"] == []
        assert post(srv, "/admin/migrate", {"requests": 1})[0] == 400
        srv.attach_preemption(handler)
        with faults.installed(faults.FaultPlan(
                [{"site": "decode_step", "kind": "delay",
                  "delay_s": 0.04}])):
            threads = [threading.Thread(target=client, args=(i, srv))
                       for i in range(2)]
            for t in threads:
                t.start()
            wait_for(lambda: len(srv._engine._active) >= 1, "load")
            handler._on_signal(signal.SIGTERM, None)
            assert srv.draining and handler.preempted()
            code, body, _ = post(srv, "/generate", {
                "input_ids": [[1, 2, 3]], "max_new_tokens": 4})
            assert code == 503 and body["draining"] is True
            code, body, _ = post(srv, "/admin/migrate", {"requests": []})
            assert code == 503 and body["draining"] is True
            code, health = get(srv, "/health")
            assert health["draining"] is True
            assert health["status"] == "draining"
            for t in threads:
                t.join(timeout=300)
            assert srv.wait_drained(timeout=300)
    for (code, body, _), stream in zip(results, want["streams"]):
        assert code == 200 and body["output_ids"] == [stream]


def test_bind_failure_leaks_no_thread(models, tmp_path):
    """A server whose port is taken raises and leaves no engine thread,
    journal writer or watchdog probe behind."""
    from paddle_tpu_torch.distributed.watchdog import CommTaskManager
    with server(models[1]) as first:
        before = set(threading.enumerate())
        with pytest.raises(OSError):
            server(models[1], port=first.port, step_timeout_s=30.0,
                   journal_dir=str(tmp_path / "j"),
                   journal_fsync_timeout_s=30.0)
        # the process-wide watchdog's scan thread may stay; nothing else
        wait_for(lambda: {t.name for t in set(threading.enumerate())
                          - before} <= {"comm-watchdog"}, "threads ended")
        names = CommTaskManager.instance().heartbeat_names()
        assert "journal/writer" not in names
        assert "engine/decode_step" not in names


def test_journal_dir_and_snapshot_path_mutually_exclusive(models,
                                                          tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive"):
        server(models[1], journal_dir=str(tmp_path / "j"),
               snapshot_path=str(tmp_path / "s"))


# -------------------------------------------------------------- restart
def test_journal_dir_restart_resumes_as_uninterrupted(models, want,
                                                      tmp_path):
    """A server hard-stopped mid-decode (no retire record, as a SIGKILL
    leaves it) and restarted on the same ``journal_dir`` resumes every
    request under its id; ``/result/<id>`` gives the uninterrupted
    run's stream, sampled row included."""
    jdir = str(tmp_path / "journal")
    srv = server(models[1], journal_dir=jdir).start()
    try:
        ripen(srv._engine, faults, IDS)
    finally:
        srv.stop()          # still paced: every row is mid-decode
        faults.clear()
    srv = server(models[1], journal_dir=jdir).start()
    try:
        assert srv._restored_requests == 3
        code, health = get(srv, "/health")
        assert health["journal"]["path"] == jdir
        assert health["journal"]["segments"] >= 1
        assert health["journal"]["fsync_policy"] == "interval_ms"
        assert health["restored_requests"] == 3
        outs = {}
        for rid in IDS:
            def done(rid=rid):
                code, outs[rid] = get(srv, f"/result/{rid}")
                return code == 200
            wait_for(done, f"re-attach {rid}")
    finally:
        srv.stop()
    assert [outs[r]["output_ids"] for r in IDS] == want["streams"]
    # every request retired: the journal resumes nothing more
    with RequestJournal(jdir) as j:
        assert j.recovered_requests() == []


def test_sigterm_snapshot_restart_resumes(models, want, tmp_path):
    """SIGTERM with ``snapshot_path``: the snapshot is written at once
    (every request in flight), the drain finishes them; a server
    started on a snapshot taken mid-decode resumes them to the
    uninterrupted streams."""
    path = str(tmp_path / "engine.snap")
    srv = server(models[1], snapshot_path=path).start()
    try:
        reqs = ripen(srv._engine, faults, IDS)
        assert srv.save_snapshot(path + ".mid") == 3
        handler = PreemptionHandler(signals=())
        srv.attach_preemption(handler)
        handler._on_signal(signal.SIGTERM, None)
        assert srv.draining
        with open(path) as f:
            assert len(json.load(f)["requests"]) == 3
        faults.clear()
        assert srv.wait_drained(timeout=120)
        assert [r.result(timeout=1).tolist() for r in reqs] \
            == want["streams"]
    finally:
        srv.stop()
    os.replace(path + ".mid", path)
    srv = server(models[1], snapshot_path=path).start()
    try:
        assert srv._restored_requests == 3
        assert os.path.exists(path + ".restored")
        code, health = get(srv, "/health")
        assert health["snapshot_path"] == path
        assert health["restored_requests"] == 3
        wait_for(lambda: all(
            (srv._engine.result_for(r) or {}).get("status") == "done"
            for r in IDS), "restored requests done")
        assert [srv._engine.result_for(r)["output_ids"] for r in IDS] \
            == want["streams"]
    finally:
        srv.stop()


def test_sigterm_with_journal_flushes_then_compacts(models, tmp_path):
    jdir = str(tmp_path / "journal")
    srv = server(models[1], journal_dir=jdir).start()
    try:
        handler = PreemptionHandler(signals=())
        srv.attach_preemption(handler)
        reqs = ripen(srv._engine, faults)
        wait_for(lambda: srv._journal.live_count == 3, "admits applied")
        handler._on_signal(signal.SIGTERM, None)
        assert srv.draining
        faults.clear()
        assert srv.wait_drained(timeout=120)
        for r in reqs:
            r.result(timeout=1)
        wait_for(lambda: srv._journal.live_count == 0,
                 "post-drain compaction")
    finally:
        srv.stop()
    with RequestJournal(jdir) as j:
        assert j.recovered_requests() == []


# ------------------------------------------------ the engines' journals
def test_port_engine_journal_recovers_jax_live_set(models, want,
                                                   tmp_path):
    """The port's engine, fed the prompts under the ids the JAX engine
    got and hard-stopped mid-decode, journals the live set the JAX
    engine's journal holds: the same ids, fields, prompts and page
    provenance, and tokens along the same streams.  Each live set,
    restored on a port engine, completes to those streams."""
    d = str(tmp_path / "j")
    j = RequestJournal(d, fsync="always")
    eng = ContinuousBatchingEngine(models[1], journal=j, device="cpu",
                                   **ENGINE)
    try:
        ripen(eng, faults, IDS)
    finally:
        eng.stop()
        faults.clear()
        j.close()
    with RequestJournal(d) as j:
        live = j.recovered_requests()
        assert j.info()["live_requests"] == 3
    by_id = {e["request_id"]: e for e in live}
    jax_by_id = {e["request_id"]: e for e in want["live"]}
    assert sorted(by_id) == sorted(jax_by_id) == IDS
    varying = ("generated", "next_token")
    for rid, stream in zip(IDS, want["streams"]):
        got, ref = by_id[rid], jax_by_id[rid]
        assert {k: v for k, v in got.items() if k not in varying} \
            == {k: v for k, v in ref.items() if k not in varying}
        assert got["prefix"]["event"] == "registered"
        assert got["prefix"]["tokens"] == 8
        assert _prefix_of(got, stream) and _prefix_of(ref, stream)
    for entries in (live, want["live"]):
        with ContinuousBatchingEngine(models[1], device="cpu",
                                      **ENGINE) as eng2:
            done = eng2.restore({"version": 1, "requests": entries})
            outs = {r.request_id: r.result(timeout=120).tolist()
                    for r in done}
        assert [outs[r] for r in IDS] == want["streams"]


def test_engine_journal_retires_every_terminal_path(models, tmp_path):
    """A finished, a cancelled and a quarantined request each leave a
    retire record: nothing comes back on restart; a brownout at rung 4
    flips the journal to ``os`` and back."""
    d = str(tmp_path / "j")
    j = RequestJournal(d, fsync="always")
    with faults.installed(faults.FaultPlan([{"site": "prefill",
                                             "nth": 2}])):
        with ContinuousBatchingEngine(models[1], journal=j, device="cpu",
                                      unified_step=False,
                                      **ENGINE) as eng:
            ok = eng.submit(_prompts()[0], max_new_tokens=4)
            bad = eng.submit(_prompts()[1], max_new_tokens=4)
            ok.result(timeout=120)
            with pytest.raises(faults.FaultError):
                bad.result(timeout=120)
            gone = eng.submit(_prompts()[2], max_new_tokens=NEW)
            gone.cancel()
            wait_for(lambda: gone.done.is_set(), "cancel reaped")
            with eng._cond:
                eng._set_brownout_locked(4, 1.0)
                assert j.effective_policy == "os"
                eng._set_brownout_locked(2, 0.0)
                assert j.effective_policy == "always"
    j.close()
    with RequestJournal(d) as j2:
        assert j2.recovered_requests() == []
