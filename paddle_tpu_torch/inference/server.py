"""HTTP serving front door over the continuous-batching engine (the port
of ``GenerationServer`` from ``paddle_tpu/inference/server.py``; stdlib
``http.server``, JSON in and out).

Every request is measured into the port's metrics registry
(``requests_total`` by server and route, ``request_latency_seconds``).
The JAX module's ``InferenceServer`` and ``serve()`` front the StableHLO
``Predictor`` and are not ported.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .. import monitor

__all__ = ["GenerationServer"]


_requests_total = monitor.counter(
    "requests_total", "HTTP requests served", ("server", "route"))
_request_latency = monitor.histogram(
    "request_latency_seconds", "HTTP request wall latency",
    ("server", "route"))


class _JsonHandler(BaseHTTPRequestHandler):
    """Shared HTTP plumbing: quiet logs (``access_log=True`` turns them
    on), JSON replies and per-route telemetry."""

    server_kind = "http"     # a server class names its own

    def log_message(self, fmt, *args):
        if getattr(self, "_outer", None) is not None \
                and self._outer._access_log:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _reply(self, code, payload, headers=None):
        body = json.dumps(payload).encode()
        self._reply_bytes(code, body, "application/json", headers)

    def _reply_text(self, code, text,
                    content_type="text/plain; version=0.0.4"):
        self._reply_bytes(code, text.encode(), content_type)

    def _reply_bytes(self, code, body, content_type, headers=None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self):
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n))

    def _track(self, route):
        """Count the request (registry and the server's own count) and
        return a latency span for the handling block."""
        _requests_total.inc(server=self.server_kind, route=route)
        self._outer._bump_requests()
        return monitor.span(f"http/{self.server_kind}{route}",
                            histogram=_request_latency,
                            server=self.server_kind, route=route)


class _ServerLifecycle:
    """start / stop / context manager, uptime and request accounting."""

    def _init_stats(self, access_log: bool):
        self._access_log = bool(access_log)
        self._started_at = time.monotonic()
        self._requests_lock = threading.Lock()
        self._requests_served = 0
        # set once serve_forever runs.  The listener is bound at
        # construction (``port`` is final then, an ephemeral port-0 bind
        # too, and any journal or snapshot restore is done), so a
        # connection made after wait_ready() is served, never refused
        self._ready = threading.Event()

    @property
    def address(self):
        """``(host, port)`` of the bound listener."""
        return (self.host, self.port)

    def wait_ready(self, timeout=None) -> bool:
        """Block until :meth:`start`'s serving thread runs (True), or
        ``timeout`` passed (False)."""
        return self._ready.wait(timeout)

    def _bump_requests(self):
        with self._requests_lock:
            self._requests_served += 1

    @property
    def requests_served(self) -> int:
        with self._requests_lock:
            return self._requests_served

    @property
    def uptime_s(self) -> float:
        return time.monotonic() - self._started_at

    def start(self):
        # a short poll, so stop() returns in a tenth of a second
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        daemon=True)
        self._thread.start()
        self._ready.set()
        return self

    def stop(self):
        self._ready.clear()
        if self._thread is not None:
            # shutdown() waits for the serve_forever loop, which a server
            # never started does not run: only the socket closes there
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


class GenerationServer(_ServerLifecycle):
    """Serve a causal LM through the paged continuous-batching engine
    over HTTP.

    POST /generate  {"input_ids": [[...], ...], "max_new_tokens": N,
                     "eos_token_id": id?, "do_sample": bool?,
                     "temperature": float?, "seed": int?, "draft": bool?,
                     "timeout_s": s?, "priority": class?, "tenant": id?,
                     "request_id": id?}
        -> {"output_ids": [[...], ...], "new_tokens": N,
            "request_ids": [...]}

    Every row of every request in flight is a sequence of one shared
    ``ContinuousBatchingEngine``: concurrent requests decode together a
    step, and short generations retire without waiting for long ones.  A
    sampled request without ``seed`` takes the server's request count.
    Every constructor argument goes to the engine (``device`` too: the
    card unless the caller asks for ``"cpu"``, where the model must
    live).

    Error mapping:
      400 = malformed request (bad JSON or shape, an unknown class, or
            prompt + max_new_tokens past the model's positions);
      429 = the class's admission queue is full or the overload controls
            shed it, with a ``Retry-After`` header (the shed's own hint,
            else the class's backlog x the decode-step p50);
      503 = the page pool cannot hold the request, or the server drains
            (then with ``"draining": true``);
      504 = the request's deadline (TTL or queue wait) passed;
      500 = anything else (the ``http_handler`` fault site fires here).

    Other routes: GET ``/health`` (pool, queues, scheduler, quantization,
    tensor parallelism, the draft pool, the journal), GET ``/metrics``
    (Prometheus text), POST ``/debug/trace/start`` and ``/stop`` with GET
    ``/debug/trace`` (the capture window as chrome-trace JSON), GET
    ``/debug/requests/<id>`` (one request's events), GET ``/result/<id>``
    (200 finished, 202 in flight, 404 unknown; journaled ids survive a
    restart), POST ``/admin/migrate`` (a failed replica's recovered live
    set, restored here with ``strict=False``).  GET ``/debug/cost``
    replies 501: it reads the JAX package's analysis tier, which has no
    port yet.

    Drain: ``begin_drain()``, or SIGTERM through ``attach_preemption``,
    stops admissions (503 with ``"draining": true``) while the requests
    in flight finish; ``wait_drained`` waits for it.

    Persistence (``journal_dir`` and ``snapshot_path`` exclude each
    other): ``journal_dir`` runs the write-ahead journal
    (``inference.journal.RequestJournal``, fsync ``journal_fsync``:
    ``always`` / ``interval_ms`` / ``os``), so a SIGKILL mid-decode loses
    nothing: the next server on the same directory recovers the live set
    and resumes every request (journaled ids, deadlines verbatim) after
    its socket binds and before it serves.  On SIGTERM the journal is
    flushed durably, and compacted once the drain completed.
    ``snapshot_path`` is the cooperative format: SIGTERM writes
    ``engine.snapshot()`` there (``save_snapshot``, through
    ``durable_replace``), drains, and writes it again once the drain
    completed; the next server consumes it (renamed ``<path>.restored``)
    and resumes its entries."""

    def __init__(self, model, host: str = "127.0.0.1", port: int = 0,
                 total_pages: int = 512, page_size: int = 16,
                 max_batch: int = 8, sample_on_device: bool = True,
                 prefix_cache: bool = True, access_log: bool = False,
                 max_queue: int = 256,
                 default_ttl_s: Optional[float] = None,
                 step_timeout_s: Optional[float] = None,
                 draft_model=None, spec_tokens: int = 4,
                 draft_total_pages: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 scheduler_classes=None,
                 min_table_pages: int = 1,
                 snapshot_path: Optional[str] = None,
                 preempt_resume_ttl_s: Optional[float] = None,
                 quantize: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 replay_batch: Optional[bool] = None,
                 journal_dir: Optional[str] = None,
                 journal_fsync: str = "interval_ms",
                 journal_fsync_interval_ms: float = 50.0,
                 journal_segment_bytes: int = 1 << 20,
                 journal_fsync_timeout_s: Optional[float] = None,
                 brownout_thresholds=None,
                 brownout_patience: int = 3,
                 decode_preempt: bool = True,
                 tpot_preempt_cooldown_s: float = 0.25,
                 tp: int = 1,
                 tp_quant_collectives: bool = False,
                 device="cuda"):
        from ..testing import faults as _faults
        from .continuous import (ContinuousBatchingEngine,
                                 DeadlineExceeded, EngineDraining,
                                 EngineSaturated)

        if journal_dir and snapshot_path:
            raise ValueError(
                "journal_dir and snapshot_path are mutually exclusive: "
                "the write-ahead journal supersedes the cooperative "
                "snapshot (one persistence format)")
        self._journal = None
        self._journal_entries = []
        if journal_dir:
            from .journal import RequestJournal
            # opening the journal recovers a predecessor's segments; the
            # entries are resubmitted once the socket is bound
            self._journal = RequestJournal(
                journal_dir, fsync=journal_fsync,
                fsync_interval_ms=journal_fsync_interval_ms,
                segment_bytes=journal_segment_bytes,
                fsync_timeout_s=journal_fsync_timeout_s)
            self._journal_entries = self._journal.recovered_requests()
        try:
            self._engine = ContinuousBatchingEngine(
                model, total_pages=total_pages, page_size=page_size,
                max_batch=max_batch, sample_on_device=sample_on_device,
                prefix_cache=prefix_cache, max_queue=max_queue,
                default_ttl_s=default_ttl_s,
                step_timeout_s=step_timeout_s,
                draft_model=draft_model, spec_tokens=spec_tokens,
                draft_total_pages=draft_total_pages,
                prefill_chunk_tokens=prefill_chunk_tokens,
                scheduler_classes=scheduler_classes,
                min_table_pages=min_table_pages,
                preempt_resume_ttl_s=preempt_resume_ttl_s,
                quantize=quantize, kv_quant=kv_quant,
                replay_batch=replay_batch, journal=self._journal,
                brownout_thresholds=brownout_thresholds,
                brownout_patience=brownout_patience,
                decode_preempt=decode_preempt,
                tpot_preempt_cooldown_s=tpot_preempt_cooldown_s,
                tp=tp, tp_quant_collectives=tp_quant_collectives,
                device=device)
        except BaseException:
            # a refused engine argument must not leak the journal's
            # writer thread, open segment or watchdog probe (the live set
            # stays on disk for the next attempt)
            if self._journal is not None:
                self._journal.close()
            raise
        self._count_lock = threading.Lock()
        self._request_count = 0
        self._drain_thread: Optional[threading.Thread] = None
        self._drain_result: Optional[bool] = None
        self._snapshot_path = snapshot_path
        self._restored_requests = 0
        self._init_stats(access_log)
        outer = self

        class Handler(_JsonHandler):
            server_kind = "generation"
            _outer = outer

            def do_GET(self):
                if self.path == "/health":
                    with self._track("/health"):
                        self._reply(200, outer.health())
                elif self.path == "/metrics":
                    with self._track("/metrics"):
                        self._reply_text(200, monitor.prometheus_text())
                elif self.path == "/debug/trace":
                    with self._track("/debug/trace"):
                        self._reply(200, monitor.export_chrome_trace())
                elif self.path.startswith("/debug/requests/"):
                    # one route label for every id, so ids cannot blow up
                    # the metrics' cardinality
                    with self._track("/debug/requests"):
                        rid = self.path[len("/debug/requests/"):]
                        tl = monitor.request_timeline(rid)
                        if tl is None:
                            self._reply(404, {
                                "error": f"no timeline for request "
                                         f"{rid!r} (tracing off, or "
                                         "evicted from the bounded "
                                         "buffer)"})
                        else:
                            self._reply(200, tl)
                elif self.path == "/debug/cost":
                    with self._track("/debug/cost"):
                        self._reply(501, {
                            "error": "/debug/cost is not implemented: it "
                                     "runs the JAX package's analytical "
                                     "cost model (paddle_tpu.analysis), "
                                     "which the port does not have yet"})
                elif self.path.startswith("/result/"):
                    # re-attach by request id: a restored request keeps
                    # its journaled id, so the id works across a restart
                    with self._track("/result"):
                        rid = self.path[len("/result/"):]
                        res = outer._engine.result_for(rid)
                        if res is None:
                            self._reply(404, {
                                "error": f"unknown request id {rid!r} "
                                         "(never seen, or evicted from "
                                         "the bounded result cache)"})
                        elif res.get("status") == "pending":
                            self._reply(202, res)
                        else:
                            self._reply(200, res)
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path == "/debug/trace/start":
                    with self._track("/debug/trace/start"):
                        monitor.start_capture()
                        self._reply(200, {"capturing": True})
                    return
                if self.path == "/debug/trace/stop":
                    with self._track("/debug/trace/stop"):
                        monitor.stop_capture()
                        self._reply(200, {"capturing": False})
                    return
                if self.path == "/admin/migrate":
                    with self._track("/admin/migrate"):
                        self._do_migrate()
                    return
                if self.path != "/generate":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                with self._track("/generate"):
                    self._do_generate()

            def _do_migrate(self):
                """A failed replica's recovered live set, restored here
                (``strict=False``: one entry that does not fit must not
                abort the rest).  Ids this replica already knows count as
                ``live``, so a caller that retries after a crash retires
                them at the source rather than leaving them behind."""
                if outer._engine.draining:
                    self._reply(503, {"error": "replica draining; "
                                      "migrate elsewhere",
                                      "draining": True})
                    return
                try:
                    body = self._read_json()
                    entries = body.get("requests", [])
                    if not isinstance(entries, list):
                        raise ValueError("requests must be a list")
                except (ValueError, TypeError, AttributeError,
                        json.JSONDecodeError) as e:
                    self._reply(400, {"error": str(e)})
                    return
                live, todo = [], []
                for e in entries:
                    rid = e.get("request_id")
                    if rid is not None \
                            and outer._engine.result_for(rid) is not None:
                        live.append(rid)
                    else:
                        todo.append(e)
                try:
                    with warnings.catch_warnings(record=True) as wlog:
                        warnings.simplefilter("always")
                        reqs = outer._engine.restore(
                            {"version": 1, "requests": todo},
                            strict=False)
                except Exception as e:  # noqa: BLE001 — server fault
                    self._reply(500, {"error": str(e)})
                    return
                ok = [r.request_id for r in reqs]
                landed = set(ok) | set(live)
                self._reply(200, {
                    "restored": ok,
                    "live": live,
                    "rejected": [e.get("request_id") for e in entries
                                 if e.get("request_id") not in landed],
                    # restore warns once a skipped entry: the reasons
                    "warnings": [str(w.message) for w in wlog]})

            def _do_generate(self):
                try:
                    _faults.maybe_fire("http_handler")
                    try:
                        req = self._read_json()
                        if not isinstance(req, dict):
                            raise ValueError("request body must be a "
                                             "JSON object")
                        ids = np.asarray(req["input_ids"], np.int32)
                        if ids.ndim != 2:
                            raise ValueError("input_ids must be 2-D "
                                             "(batch, seq)")
                        max_new = int(req.get("max_new_tokens", 32))
                        eos = req.get("eos_token_id")
                        do_sample = bool(req.get("do_sample", False))
                        temperature = float(req.get("temperature", 1.0))
                        ttl = req.get("timeout_s")
                        ttl = None if ttl is None else float(ttl)
                        draft = req.get("draft")
                        draft = None if draft is None else bool(draft)
                        priority = req.get("priority")
                        priority = (None if priority is None
                                    else str(priority))
                        tenant = str(req.get("tenant", "default"))
                        request_id = req.get("request_id")
                        request_id = (None if request_id is None
                                      else str(request_id))
                        with outer._count_lock:
                            outer._request_count += 1
                            seed = int(req.get("seed",
                                               outer._request_count))
                    except (KeyError, ValueError, TypeError,
                            json.JSONDecodeError) as e:
                        self._reply(400, {"error": str(e)})
                        return
                    try:
                        out, rows = outer._engine.generate_with_requests(
                            ids, max_new_tokens=max_new, eos_token_id=eos,
                            do_sample=do_sample, temperature=temperature,
                            seed=seed, ttl_s=ttl, draft=draft,
                            priority=priority, tenant=tenant,
                            request_id=request_id)
                    except ValueError as e:
                        # the client's request is wrong (past the rope
                        # table, unknown class, a live id): 400, never
                        # the retryable 503
                        self._reply(400, {"error": str(e)})
                        return
                    self._reply(200, {
                        "output_ids": out.tolist(),
                        "new_tokens": int(out.shape[1] - ids.shape[1]),
                        "request_ids": [r.request_id for r in rows]})
                except EngineSaturated as e:
                    # a shed carries its own projected wait; a full queue
                    # gets the requesting class's backlog hint
                    hint = getattr(e, "retry_after_s", None)
                    cls = getattr(e, "priority_class", None) or priority
                    if hint is None:
                        hint = outer._engine.retry_after_hint(cls)
                    self._reply(429, {"error": str(e)}, headers={
                        "Retry-After": str(hint)})
                except EngineDraining as e:
                    self._reply(503, {"error": str(e), "draining": True})
                except DeadlineExceeded as e:
                    self._reply(504, {"error": str(e)})
                except RuntimeError as e:
                    # the page pool cannot hold it: retry elsewhere
                    self._reply(503, {"error": str(e)})
                except Exception as e:   # noqa: BLE001 — server fault
                    self._reply(500, {"error": str(e)})

        try:
            self._httpd = ThreadingHTTPServer((host, port), Handler)
        except BaseException:
            # a failed bind (a predecessor still releasing the port) must
            # not leak the running engine (its scheduler thread, its step
            # watchdog probe) nor the journal's writer and fsync probe
            self._engine.stop()
            if self._journal is not None:
                self._journal.close()
            raise
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        # a predecessor's state is consumed after the bind (a failed bind
        # must not have eaten it) and before serve_forever: restored
        # requests decode by the time the first request arrives
        if self._journal is not None:
            self._restored_requests = self._restore_journal()
        elif snapshot_path and os.path.exists(snapshot_path):
            self._restored_requests = self._restore_snapshot(snapshot_path)

    def health(self) -> dict:
        """The ``/health`` payload (the JAX server's keys)."""
        eng = self._engine
        cache = eng.cache
        draining = eng.draining
        payload = {
            "status": "draining" if draining else "ok",
            "draining": draining,
            "uptime_s": round(self.uptime_s, 3),
            "requests_total": self.requests_served,
            "free_pages": cache.free_pages,
            "total_pages": cache.total_pages,
            "page_size": cache.page_size,
            "cached_prefix_pages": cache.cached_prefix_pages,
            "sampling_on_device": eng.sample_on_device,
            "active_sequences": len(eng._active),
            "queued_sequences": len(eng._sched),
            "retry_after_hint": eng.retry_after_hint(),
            "scheduler": eng.scheduler_info(),
            "quantize": eng.quantize,
            "kv_quant": eng.kv_quant,
            "kv_pool_bytes": cache.kv_pool_bytes,
            "kv_scale_bytes": cache.kv_scale_bytes,
            "tp": eng.tp,
            "mesh_shape": {"tensor": eng.tp} if eng.tp > 1 else None,
            "tp_quant_collectives": eng.tp_quant_collectives,
            "kv_pool_bytes_per_chip": cache.kv_pool_bytes_per_chip,
            "speculative": eng._spec}
        if self._snapshot_path:
            payload.update({"snapshot_path": self._snapshot_path,
                            "restored_requests": self._restored_requests})
        if self._journal is not None:
            payload.update({"journal": self._journal.info(),
                            "restored_requests": self._restored_requests})
        if eng._spec:
            dc = eng.draft_cache
            payload.update({"spec_tokens": eng.spec_k,
                            "draft_free_pages": dc.free_pages,
                            "draft_total_pages": dc.total_pages,
                            "draft_pinned_pages": dc.pinned_pages})
        return payload

    # ------------------------------------------------ write-ahead journal
    def _restore_journal(self) -> int:
        """Resubmit the live set the journal recovered through the
        engine's restore (``strict=False``).  Entries the engine refused
        are retired in the journal as ``unrestorable``, so they do not
        come back at every later compaction."""
        entries = self._journal_entries
        if not entries:
            return 0
        try:
            reqs = self._engine.restore({"version": 1,
                                         "requests": entries},
                                        strict=False)
        except Exception as e:  # noqa: BLE001 — start anyway
            warnings.warn(f"journal restore failed: {e!r}")
            return 0
        ok = {r.request_id for r in reqs}
        for e in entries:
            rid = e.get("request_id")
            if rid is not None and rid not in ok:
                self._journal.append_retire(rid, why="unrestorable")
        return len(reqs)

    # ----------------------------------------------------------- snapshot
    def _restore_snapshot(self, path: str) -> int:
        """Consume a predecessor's snapshot: rename it first (a crash
        mid-restore must not resume it twice), then resubmit its entries
        (``strict=False``)."""
        consumed = path + ".restored"
        try:
            os.replace(path, consumed)
            with open(consumed) as f:
                snap = json.load(f)
        except (OSError, ValueError) as e:
            warnings.warn(f"snapshot restore skipped: {e!r}")
            return 0
        try:
            return len(self._engine.restore(snap, strict=False))
        except Exception as e:  # noqa: BLE001 — valid JSON of the wrong
            # shape resumes nothing, but the server still starts
            warnings.warn(f"snapshot restore failed: {e!r}")
            return 0

    def save_snapshot(self, path: Optional[str] = None) -> int:
        """Write every live request to ``path`` (default: the configured
        ``snapshot_path``) atomically and durably; returns the count.  The
        engine's cut lies between two steps."""
        path = path or self._snapshot_path
        if not path:
            raise ValueError("no snapshot_path configured")
        snap = self._engine.snapshot()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f)
        from .journal import durable_replace
        durable_replace(tmp, path)
        return len(snap["requests"])

    # ---------------------------------------------------------- shutdown
    @property
    def draining(self) -> bool:
        return self._engine.draining

    def begin_drain(self, timeout: Optional[float] = None,
                    reject_queued: bool = False) -> None:
        """Start a graceful drain without blocking (idempotent): new
        /generate requests get 503 with ``"draining": true`` while every
        request in flight runs to completion; the listener stays up for
        /health and /metrics.  ``reject_queued=True`` fails the queued,
        unadmitted requests at once."""
        if self._drain_thread is not None and self._drain_thread.is_alive():
            return
        self._drain_result = None

        def _drain():
            self._drain_result = self._engine.drain(
                timeout=timeout, reject_queued=reject_queued)

        self._drain_thread = threading.Thread(
            target=_drain, name="server-drain", daemon=True)
        self._drain_thread.start()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Block until a drain started by :meth:`begin_drain` ends; True
        if it ended within ``timeout``."""
        t = self._drain_thread
        if t is None:
            eng = self._engine
            with eng._cond:
                return not (eng._active or len(eng._sched)
                            or eng._prefilling or eng._preempted)
        t.join(timeout)
        return not t.is_alive()

    def attach_preemption(self, handler,
                          drain_timeout: Optional[float] = None) -> None:
        """Wire a ``distributed.fault_tolerance.PreemptionHandler``: on
        SIGTERM the server stops admitting at once and drains.  With a
        journal, the log is flushed durably first (it already holds
        everything in flight) and compacted once the drain completed, so
        a relaunch resumes exactly what the grace period was too short
        to finish.  With ``snapshot_path``, a snapshot is written at once
        and again once the drain completed."""
        def drain_on_preemption():
            # admissions stop synchronously: begin_drain only starts a
            # thread, and a request admitted before it flips the flag
            # would miss the snapshot
            self._engine.stop_admissions()
            self.begin_drain(timeout=drain_timeout)
            if self._journal is not None:
                try:
                    self._journal.flush(sync=True, timeout=30.0)
                except Exception as e:  # noqa: BLE001 — drain anyway
                    warnings.warn(f"pre-drain journal flush failed: "
                                  f"{e!r}")

                def _refresh_journal():
                    if self.wait_drained(None) and self._drain_result:
                        try:
                            self._journal.compact(wait=True,
                                                  timeout=30.0)
                        except Exception as e:  # noqa: BLE001 — keep
                            # the flushed log rather than none
                            warnings.warn(
                                f"post-drain journal compaction "
                                f"failed: {e!r}")
                threading.Thread(target=_refresh_journal, daemon=True,
                                 name="journal-refresh").start()
            elif self._snapshot_path:
                try:
                    self.save_snapshot()
                except Exception as e:   # noqa: BLE001 — drain anyway
                    warnings.warn(f"pre-drain snapshot failed: {e!r}")

                def _refresh():
                    # rewrite only after a drain that completed its
                    # requests: a timed-out drain or a hard stop keeps
                    # the first snapshot, or the relaunch resumes nothing
                    if self.wait_drained(None) and self._drain_result:
                        try:
                            self.save_snapshot()
                        except Exception as e:  # noqa: BLE001 — keep
                            # the first snapshot rather than none
                            warnings.warn(
                                f"post-drain snapshot refresh failed: "
                                f"{e!r}")
                threading.Thread(target=_refresh, daemon=True,
                                 name="snapshot-refresh").start()
        handler.on_preemption(drain_on_preemption)

    def stop(self):
        super().stop()
        self._engine.stop()
        if self._drain_thread is not None:
            self._drain_thread.join(timeout=5)
            self._drain_thread = None
        if self._journal is not None:
            # close writes and fsyncs what is queued and retires nothing:
            # a relaunch on the same directory resumes what was live
            self._journal.close()
