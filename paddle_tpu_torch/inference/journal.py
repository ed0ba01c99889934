"""Write-ahead request journal: crash recovery that survives SIGKILL (the
port of ``paddle_tpu/inference/journal.py``; host code only, no torch).

A snapshot taken on SIGTERM covers only the failures a process gets to
see.  A SIGKILL, an OOM kill or a power loss destroys every request in
flight, unless its host state is on disk.  The engine's replay is exact
for greedy and sampled rows (a sampled draw's counter is the request's
seed and the absolute position), so recovery needs only that host state:
prompt, seed, generated ids and the pending next token, never KV.

:class:`RequestJournal` is that log:

  * **append-only records framed with a CRC32**: a 2-byte magic, the
    payload's length and CRC32, then the JSON payload.  Record types:
    ``admit`` (the full request state at admission; a restored request's
    record carries its generated tokens, so replay is idempotent by
    request id), ``step`` (one record an engine iteration: the ids that
    took a slot, and for each surviving row the tokens appended and the
    new pending token), ``retire`` (done, cancelled, expired,
    quarantined, failed: the live set is admitted minus retired) and
    ``pages`` (which prefix-cache pages a request acquired at admission
    or registered at prefill completion, with the content hash of the
    shared prefix, the key that names the same prefix on any replica);
  * **one writer thread**: producers (the engine, under its lock) only
    append to an in-memory queue; the writer encodes, frames, writes and
    fsyncs in batches;
  * **fsync policies**: ``"always"`` (after every batch),
    ``"interval_ms"`` (at most every ``fsync_interval_ms``, scaled by the
    number of live engines in the process), ``"os"`` (never; the page
    cache decides).  With ``fsync_timeout_s`` a hung fsync trips the
    watchdog (``distributed.watchdog.CommTaskManager``), which flips the
    journal to ``os`` (``journal_degraded``) instead of stalling the
    writer and every flush behind it;
  * **rotation and compaction**: segments rotate at ``segment_bytes``;
    once the dead share of the record units (units of retired requests
    over all units) passes ``compact_dead_ratio`` the writer rewrites the
    live set into a fresh segment and renames the replaced ones
    ``*.consumed`` (one generation kept);
  * **torn tails**: recovery stops reading a segment at its first bad
    frame (short header, bad magic, bad CRC, short payload), counts it
    (``journal_torn_records_total``) and goes on with the next segment;
  * **recovery that survives its own crash**: opening a journal over
    segments replays them oldest first into the live set, writes the
    live set to a fresh segment, fsyncs it, and only then renames the old
    ones.  A restart that dies at any point of this replays to the same
    live set next time: ``admit`` replaces by id, and ``step`` and
    ``retire`` records of unknown ids are ignored.

The on-disk format is the JAX package's byte for byte: segments written
by either package recover in the other into the same live set.

With a journal, the server's SIGTERM path is ``flush(sync=True)`` (the
log already holds everything) and one :meth:`compact` after the drain.
:func:`durable_replace` and :func:`fsync_file_and_dir` are the atomic
persistence helpers the segment switch and ``save_snapshot`` share.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
import warnings
import weakref
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from .. import monitor
from ..testing import faults as _faults

__all__ = [
    "RequestJournal", "FSYNC_POLICIES",
    "durable_replace", "fsync_file_and_dir",
    "live_engines", "engine_started", "engine_stopped",
]

FSYNC_POLICIES = ("always", "interval_ms", "os")

# co-location: N engines in one process mean N writer threads sharing
# the GIL.  Every engine registers here when it starts and stops, and
# every live journal scales its flush interval by the count, so the
# writers' wake rate stays about constant as engines share a process
_coloc_lock = threading.Lock()
_live_engines = 0
_journals: "weakref.WeakSet" = weakref.WeakSet()


def live_engines() -> int:
    with _coloc_lock:
        return _live_engines


def _set_live_engines(delta: int) -> int:
    global _live_engines
    with _coloc_lock:
        _live_engines = max(0, _live_engines + delta)
        n = _live_engines
        journals = list(_journals)
    for j in journals:
        j._set_colocation(max(1, n))
    return n


def engine_started() -> int:
    """One more engine is live in this process; returns the new count.
    Every engine calls it, with a journal or without (it steps on the
    same GIL either way)."""
    return _set_live_engines(+1)


def engine_stopped() -> int:
    return _set_live_engines(-1)


#: frame = MAGIC + <u32 payload length> + <u32 payload crc32> + payload
_MAGIC = b"RJ"
_HEADER = struct.Struct("<II")
_HEADER_LEN = len(_MAGIC) + _HEADER.size

_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".seg"
_CONSUMED_SUFFIX = ".consumed"

# the journal's series, under the JAX package's names, made at import so
# they read 0 from the first scrape
_records_total = monitor.counter(
    "journal_records_total", "records appended to the write-ahead "
    "request journal (admit + coalesced step + retire)")
_bytes_total = monitor.counter(
    "journal_bytes", "framed bytes appended to the write-ahead request "
    "journal")
_fsync_s = monitor.histogram(
    "journal_fsync_seconds", "one journal fsync (the durability cost "
    "of the configured policy)")
_compactions_total = monitor.counter(
    "journal_compactions_total", "live-set compactions (dead-record "
    "ratio crossings, recovery compactions and explicit compact() "
    "calls)")
_torn_total = monitor.counter(
    "journal_torn_records_total", "torn/corrupt frames recovery "
    "truncated at (one per damaged segment tail)")
_recovered_total = monitor.counter(
    "journal_recovered_requests_total", "live requests reconstructed "
    "from journal segments at process restart")
_degraded_g = monitor.gauge(
    "journal_degraded", "1 after a hung/failed fsync flipped the "
    "journal to os-policy degraded mode, else 0")
_records_total.inc(0)
_bytes_total.inc(0)
_compactions_total.inc(0)
_torn_total.inc(0)
_recovered_total.inc(0)
_degraded_g.set(0)


# ------------------------------------------------------------------ fsync
def fsync_file_and_dir(path: str) -> None:
    """fsync ``path`` and its parent directory: the file's data, then the
    directory entry that names it."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def _fsync_dir(dirpath: str) -> None:
    try:
        dfd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return                      # no directory handles on this platform
    try:
        os.fsync(dfd)
    except OSError:
        pass                        # a directory that cannot be fsynced
    finally:
        os.close(dfd)


def durable_replace(tmp: str, dst: str) -> None:
    """``os.replace`` that survives a power loss: fsync the new file's
    data (or the rename could publish an empty file), rename, then fsync
    the parent directory so the new entry lasts."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, dst)
    _fsync_dir(os.path.dirname(os.path.abspath(dst)))


# ------------------------------------------------------------- encoding
def _json_default(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(f"journal cannot encode {type(obj).__name__}")


def _encode(rec: dict) -> bytes:
    return json.dumps(rec, separators=(",", ":"),
                      default=_json_default).encode()


def _frame(payload: bytes) -> bytes:
    return (_MAGIC + _HEADER.pack(len(payload), zlib.crc32(payload))
            + payload)


def _read_frames(raw: bytes):
    """Yield the records of one segment's bytes; a final None marks a
    torn or corrupt frame, after which nothing can be read."""
    off, n = 0, len(raw)
    while off < n:
        if off + _HEADER_LEN > n or raw[off:off + 2] != _MAGIC:
            yield None
            return
        length, crc = _HEADER.unpack_from(raw, off + 2)
        start = off + _HEADER_LEN
        end = start + length
        if end > n:
            yield None
            return
        payload = raw[start:end]
        if zlib.crc32(payload) != crc:
            yield None
            return
        try:
            yield json.loads(payload)
        except ValueError:
            yield None
            return
        off = end


# ------------------------------------------------------------- live set
class _LiveSet:
    """The journal's replay state: request id -> entry, and the units the
    compaction trigger reads.  The recovery scan and the writer's live
    mirror share it, so the two apply records alike.

    Units: an ``admit`` is 1, a ``step`` one an admitted id and one a
    row, a ``pages`` 1, a ``retire`` one an id.  ``dead_ratio`` is the
    share of units that name requests no longer live."""

    def __init__(self):
        self.entries: "OrderedDict[str, dict]" = OrderedDict()
        self._units: Dict[str, int] = {}    # live id -> units held
        self.total_units = 0
        self.live_units = 0

    def apply(self, rec: dict) -> None:
        t = rec.get("t")
        if t == "admit":
            e = rec.get("req") or {}
            rid = e.get("request_id")
            if rid is None:
                return
            if rid in self.entries:     # a re-admission replaces
                self.live_units -= self._units.pop(rid)
            self.entries[rid] = dict(e)
            self._units[rid] = 1
            self.total_units += 1
            self.live_units += 1
        elif t == "step":
            for rid in rec.get("adm", ()):
                self.total_units += 1
                e = self.entries.get(rid)
                if e is None:
                    continue
                e["admitted"] = True
                self._units[rid] += 1
                self.live_units += 1
            for row in rec.get("rows", ()):
                rid, toks, nxt = row[0], row[1], row[2]
                self.total_units += 1
                e = self.entries.get(rid)
                if e is None:
                    continue            # retired or compacted away
                if toks:
                    e["generated"] = list(e.get("generated") or ()) \
                        + [int(tk) for tk in toks]
                e["next_token"] = None if nxt is None else int(nxt)
                e["admitted"] = True    # a row implies admission
                self._units[rid] += 1
                self.live_units += 1
        elif t == "pages":
            # the latest record wins: a request acquires at most one
            # cached prefix, and its registration supersedes that
            rid = rec.get("id")
            self.total_units += 1
            e = self.entries.get(rid)
            if e is None:
                return
            e["prefix"] = {
                "event": rec.get("event"),
                "tokens": int(rec.get("tokens") or 0),
                "pages": [int(p) for p in rec.get("pages", ())],
                "key": rec.get("key"),
            }
            self._units[rid] += 1
            self.live_units += 1
        elif t == "retire":
            for rid in rec.get("ids", ()):
                self.total_units += 1
                if rid in self.entries:
                    del self.entries[rid]
                    self.live_units -= self._units.pop(rid)

    @property
    def dead_ratio(self) -> float:
        if self.total_units <= 0:
            return 0.0
        return 1.0 - self.live_units / self.total_units

    def reset_accounting(self) -> None:
        """After a compaction the log holds one admit a live entry."""
        self._units = {rid: 1 for rid in self.entries}
        self.total_units = len(self.entries)
        self.live_units = len(self.entries)


class RequestJournal:
    """See the module docstring.  Producers (:meth:`append_admit`,
    :meth:`append_step`, :meth:`append_retire`, :meth:`append_pages`)
    only enqueue, from any thread; one writer thread owns every file
    operation."""

    def __init__(self, path: str, fsync: str = "interval_ms",
                 fsync_interval_ms: float = 50.0,
                 segment_bytes: int = 1 << 20,
                 compact_dead_ratio: float = 0.6,
                 compact_min_records: int = 64,
                 fsync_timeout_s: Optional[float] = None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync must be one of {FSYNC_POLICIES}, got {fsync!r}")
        self.path = os.path.abspath(path)
        self.fsync_policy = fsync           # configured
        self._policy = fsync                # in force (degrade flips it)
        self.fsync_interval_s = float(fsync_interval_ms) / 1000.0
        # the writer's interval is the configured one x the live engines
        # of the process, kept current by engine_started/engine_stopped
        self._colocation = max(1, live_engines())
        _journals.add(self)
        self.segment_bytes = int(segment_bytes)
        self.compact_dead_ratio = float(compact_dead_ratio)
        self.compact_min_records = int(compact_min_records)
        os.makedirs(self.path, exist_ok=True)
        self._degraded = False
        self._lock = threading.Condition()
        self._queue: List[dict] = []
        self._appended = 0          # records enqueued
        self._written = 0           # records written to the segment file
        self._synced = 0            # records covered by the last fsync
        self._force_sync_below = 0  # flush(sync=True) high-water mark
        self._compact_req = 0       # explicit compact() requests
        self._compact_done = 0
        self._closing = False
        self._closed = False
        self._dirty = False         # bytes written since the last fsync
        self._last_sync = time.monotonic()
        # the watchdog's probe: the age of the writer's file operation in
        # flight, so a hung fsync is seen like a hung step
        self._op_started: Optional[float] = None
        self._hb_id: Optional[int] = None
        # recovery: replay whatever a predecessor left behind
        self._live = _LiveSet()
        self.torn_records = 0
        self._recovered: List[dict] = []
        segs = self._segments()
        if segs:
            self._recover(segs)
        self._seg_seq = self._next_seq()
        self._seg_path = self._seg_name(self._seg_seq)
        self._f = open(self._seg_path, "ab")
        _fsync_dir(self.path)        # the new segment's directory entry
        self._writer = threading.Thread(target=self._writer_loop,
                                        name="journal-writer", daemon=True)
        self._writer.start()
        if fsync_timeout_s is not None:
            from ..distributed.watchdog import CommTaskManager
            mgr = CommTaskManager.instance()
            self._hb_id = mgr.register_heartbeat(
                "journal/writer", self._op_age, float(fsync_timeout_s),
                on_timeout=self.degrade)
            mgr.start()
        _degraded_g.set(int(self._degraded))

    # ------------------------------------------------------- segments
    def _seg_name(self, seq: int) -> str:
        return os.path.join(self.path,
                            f"{_SEG_PREFIX}{seq:08d}{_SEG_SUFFIX}")

    def _segments(self) -> List[str]:
        out = []
        for name in os.listdir(self.path):
            if name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX):
                out.append(os.path.join(self.path, name))
        return sorted(out)

    def _next_seq(self) -> int:
        segs = self._segments()
        if not segs:
            return 1
        last = os.path.basename(segs[-1])
        return int(last[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]) + 1

    @property
    def segment_count(self) -> int:
        return len(self._segments())

    # ------------------------------------------------------- recovery
    def _recover(self, segs: List[str]) -> None:
        """Replay ``segs`` oldest first into the live set, then write the
        live set to a fresh segment before consuming them: the order that
        makes a crash at any point here re-runnable."""
        for seg in segs:
            with open(seg, "rb") as f:
                raw = f.read()
            for rec in _read_frames(raw):
                if rec is None:
                    self.torn_records += 1
                    _torn_total.inc()
                    break
                self._live.apply(rec)
        now = time.time()
        self._recovered = [self._restore_entry(e, now)
                           for e in self._live.entries.values()]
        # streams in flight first: if the live set overflows the
        # restoring engine's queues, queued work is what gets dropped
        self._recovered.sort(
            key=lambda e: 0 if (e.get("generated")
                                or e.get("next_token") is not None
                                or e.get("_admitted")) else 1)
        for e in self._recovered:
            e.pop("_admitted", None)
        _recovered_total.inc(len(self._recovered))
        seq = self._next_seq()
        self._write_compact_segment(seq, consumed=segs)
        self._live.reset_accounting()

    @staticmethod
    def _restore_entry(e: dict, now: float) -> dict:
        """A journal entry as a snapshot entry: the absolute wall-clock
        deadlines become the remaining seconds ``restore`` takes verbatim
        (None means no deadline, never the restoring engine's defaults),
        and an admitted request's spent queue-wait deadline is dropped,
        as ``engine.snapshot()`` drops it."""
        d = dict(e)
        admitted = bool(d.pop("admitted", False))
        ddl = d.pop("deadline_unix", None)
        d["ttl_remaining_s"] = (None if ddl is None
                                else max(1e-3, float(ddl) - now))
        qdl = d.pop("queue_deadline_unix", None)
        d["queue_timeout_remaining_s"] = (
            None if qdl is None or admitted
            else max(1e-3, float(qdl) - now))
        d["_admitted"] = admitted
        return d

    def recovered_requests(self) -> List[dict]:
        """The live set a predecessor's segments held, as the snapshot
        entries ``engine.restore`` takes."""
        return [dict(e) for e in self._recovered]

    # ------------------------------------------------------ producers
    def _append(self, rec: dict) -> None:
        with self._lock:
            if self._closing or self._closed:
                return              # a late retire during teardown
            self._queue.append(rec)
            self._appended += 1
            self._lock.notify_all()

    def append_admit(self, entry: dict) -> None:
        """``entry`` is the full request state (the snapshot entry's
        fields with ``deadline_unix`` / ``queue_deadline_unix``); a
        restored request's entry carries its generated tokens."""
        self._append({"t": "admit", "req": entry})

    def append_step(self, admitted_ids, rows, dispatches=None,
                    mode=None) -> None:
        """One record an engine iteration: ``admitted_ids`` took a slot,
        ``rows`` is ``(request_id, [tokens appended], next_token)`` a
        surviving row (a prefill completion is a row with no tokens and
        the first pending token).  ``dispatches`` and ``mode``
        (``"ragged"`` or ``"legacy"``) say how the iteration ran; they
        are optional and replay ignores them."""
        rec = {
            "t": "step", "adm": [str(i) for i in admitted_ids],
            "rows": [[str(rid), [int(tk) for tk in toks],
                      None if nxt is None else int(nxt)]
                     for rid, toks, nxt in rows]}
        if dispatches is not None:
            rec["n"] = int(dispatches)
        if mode is not None:
            rec["mode"] = str(mode)
        self._append(rec)

    def append_retire(self, request_id: str, why: str = "done") -> None:
        self._append({"t": "retire", "ids": [str(request_id)],
                      "why": why})

    def append_pages(self, request_id: str, event: str, tokens: int,
                     pages, key: Optional[str]) -> None:
        """Page provenance: ``event`` is ``"acquired"`` (admission mapped
        a cached prefix) or ``"registered"`` (prefill completion kept this
        prompt's page-aligned prefixes), ``tokens`` the page-aligned
        shared length, ``pages`` the local page indices behind it and
        ``key`` the prefix's content hash, which names the same prefix on
        another replica."""
        self._append({"t": "pages", "id": str(request_id),
                      "event": str(event), "tokens": int(tokens),
                      "pages": [int(p) for p in pages],
                      "key": key})

    # ------------------------------------------------------- control
    def flush(self, sync: bool = True,
              timeout: Optional[float] = None) -> bool:
        """Block until everything appended so far is written (and with
        ``sync`` fsynced, under the ``os`` policy too: the SIGTERM path's
        floor).  False if ``timeout`` passed first."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        with self._lock:
            target = self._appended
            if sync:
                self._force_sync_below = max(self._force_sync_below,
                                             target)
            self._lock.notify_all()
            while (self._written < target
                   or (sync and self._synced < target)):
                if self._closed:
                    return False
                wait = 0.05
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        return False
                self._lock.wait(wait)
        return True

    def compact(self, wait: bool = True,
                timeout: Optional[float] = None) -> bool:
        """Ask for a live-set compaction (after a drain: a drained engine
        compacts to an empty live set, so a relaunch resumes nothing)."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        with self._lock:
            if self._closed:
                return False
            self._compact_req += 1
            target = self._compact_req
            self._lock.notify_all()
            if not wait:
                return True
            while self._compact_done < target and not self._closed:
                w = 0.05
                if deadline is not None:
                    w = min(w, deadline - time.monotonic())
                    if w <= 0:
                        return False
                self._lock.wait(w)
        return self._compact_done >= target

    def degrade(self) -> None:
        """Flip to the ``os`` policy for good (the watchdog's
        ``on_timeout``): admissions and flushes must not wait behind a
        hung fsync; durability narrows to what the OS writes back."""
        if self._degraded:
            return
        self._degraded = True
        self._policy = "os"
        _degraded_g.set(1)
        warnings.warn(
            "journal writer fsync exceeded its watchdog timeout; "
            "degrading to fsync='os' (durability now depends on the OS "
            "page cache)")

    def set_policy(self, policy: str) -> None:
        """Set the policy in force (the brownout ladder's last rung flips
        to ``os`` and coming down restores ``fsync_policy``).  Unlike
        :meth:`degrade` it can be undone and does not mark the journal
        degraded; once degraded, ``os`` stays and this does nothing."""
        if policy not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy must be one of {FSYNC_POLICIES}, "
                f"got {policy!r}")
        with self._lock:
            if self._degraded:
                return
            if policy == self._policy:
                return
            self._policy = policy
            self._lock.notify_all()

    def _set_colocation(self, n: int) -> None:
        with self._lock:
            self._colocation = max(1, int(n))
            self._lock.notify_all()

    @property
    def effective_fsync_interval_s(self) -> float:
        """The interval the writer flushes at: the configured one x the
        live engines of the process."""
        return self.fsync_interval_s * self._colocation

    @property
    def degraded(self) -> bool:
        return self._degraded

    @property
    def effective_policy(self) -> str:
        return self._policy

    @property
    def live_count(self) -> int:
        with self._lock:
            return len(self._live.entries)

    def info(self) -> dict:
        """JSON-able state for ``/health``."""
        # the directory scan runs outside the lock, which producers
        # holding the engine's lock wait on
        segments = self.segment_count
        with self._lock:
            return {
                "path": self.path,
                "fsync_policy": self.fsync_policy,
                "effective_fsync_policy": self._policy,
                "degraded": self._degraded,
                "colocated_engines": self._colocation,
                "effective_fsync_interval_ms": round(
                    self.effective_fsync_interval_s * 1000.0, 3),
                "segments": segments,
                "live_requests": len(self._live.entries),
                "torn_records": self.torn_records,
            }

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Write what is queued, fsync, stop the writer.  Idempotent.
        Live entries stay journaled: a close without retirement is the
        state a relaunch resumes from."""
        with self._lock:
            if self._closed and not self._writer.is_alive():
                return
            self._closing = True
            self._lock.notify_all()
        self._writer.join(timeout=timeout)
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        if self._hb_id is not None:
            from ..distributed.watchdog import CommTaskManager
            CommTaskManager.instance().unregister_heartbeat(self._hb_id)
            self._hb_id = None
        try:
            self._f.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # --------------------------------------------------- writer thread
    def _op_age(self) -> Optional[float]:
        t0 = self._op_started
        return None if t0 is None else time.monotonic() - t0

    def _writer_loop(self) -> None:
        while True:
            with self._lock:
                while (not self._queue and not self._closing
                       and self._compact_req <= self._compact_done
                       and not (self._dirty and self._sync_due())):
                    self._lock.wait(min(
                        0.2, max(self.effective_fsync_interval_s, 1e-3)))
                batch = self._queue
                self._queue = []
                closing = self._closing
                want_compact = self._compact_req > self._compact_done
            try:
                if batch:
                    self._write_batch(batch)
                if self._dirty and (closing or self._sync_due()):
                    self._do_fsync()
                if want_compact or self._auto_compact_due():
                    self._compact_io()
                    with self._lock:
                        if want_compact:
                            self._compact_done = self._compact_req
                        self._lock.notify_all()
            except Exception as e:   # noqa: BLE001 — the journal degrades,
                # it never takes the serving engine down with it
                warnings.warn(f"journal writer error: {e!r}")
                self.degrade()
                with self._lock:
                    self._written = self._appended
                    self._synced = self._appended
                    if want_compact:
                        self._compact_done = self._compact_req
                    self._lock.notify_all()
            if closing and not self._queue:
                with self._lock:
                    if not self._queue:     # nothing raced in
                        self._lock.notify_all()
                        return

    def _sync_due(self) -> bool:
        if self._synced < self._force_sync_below:
            return True             # a flush(sync=True) is waiting
        if self._policy == "always":
            return True
        if self._policy == "os":
            return False
        return (time.monotonic() - self._last_sync
                >= self.effective_fsync_interval_s)

    def _write_batch(self, batch: List[dict]) -> None:
        for rec in batch:
            payload = _encode(rec)
            frame = _frame(payload)
            self._op_started = time.monotonic()
            torn = False
            try:
                try:
                    _faults.maybe_fire("journal_write")
                except _faults.FaultError:
                    # a torn write: half the frame reaches the file, as a
                    # crash mid-write leaves it, and the writer rotates,
                    # so recovery's truncation loses this record only
                    self._f.write(frame[:max(4, len(frame) // 2)])
                    self._f.flush()
                    self._dirty = True
                    torn = True
                else:
                    self._f.write(frame)
                    self._dirty = True
            finally:
                self._op_started = None
            with self._lock:
                self._written += 1
                if not torn:
                    # mirrored under the lock: live_count and info()
                    # read it from other threads
                    self._live.apply(rec)
            if torn:
                self._rotate()
                continue
            _records_total.inc()
            _bytes_total.inc(len(frame))
            if self._f.tell() > self.segment_bytes:
                self._rotate()       # a record at a time: bounded segments
        self._f.flush()
        with self._lock:
            self._lock.notify_all()

    def _do_fsync(self) -> None:
        written = self._written
        self._op_started = time.monotonic()
        t0 = time.perf_counter()
        try:
            try:
                _faults.maybe_fire("journal_fsync")
                os.fsync(self._f.fileno())
            except _faults.FaultError as e:
                warnings.warn(f"journal fsync failed (injected): {e}")
                self.degrade()
            except OSError as e:
                warnings.warn(f"journal fsync failed: {e!r}")
                self.degrade()
        finally:
            self._op_started = None
        _fsync_s.observe(time.perf_counter() - t0)
        self._dirty = False
        self._last_sync = time.monotonic()
        with self._lock:
            self._synced = max(self._synced, written)
            self._lock.notify_all()

    def _rotate(self) -> None:
        """Close the current segment durably and open the next."""
        self._f.flush()
        try:
            os.fsync(self._f.fileno())
        except OSError as e:
            # as in _do_fsync: a failed fsync degrades loudly and still
            # releases the flush() waiters
            warnings.warn(f"journal fsync failed at segment rotation: "
                          f"{e!r}")
            self.degrade()
        self._f.close()
        self._seg_seq = self._next_seq()
        self._seg_path = self._seg_name(self._seg_seq)
        self._f = open(self._seg_path, "ab")
        _fsync_dir(self.path)
        self._last_sync = time.monotonic()
        self._dirty = False
        with self._lock:
            # what was written went down with the old segment's fsync
            self._synced = max(self._synced, self._written)
            self._lock.notify_all()

    def _auto_compact_due(self) -> bool:
        return (self._live.total_units >= self.compact_min_records
                and self._live.dead_ratio > self.compact_dead_ratio)

    def _compact_io(self) -> None:
        """Writer thread only: rewrite the live set into a fresh segment,
        fsync it, then rename every replaced segment ``*.consumed`` (older
        consumed files are removed).  Until the renames land, recovery
        replays old and new segments to the same state."""
        old = self._segments()
        self._f.flush()
        try:
            os.fsync(self._f.fileno())
        except OSError:
            pass
        self._f.close()
        with self._lock:
            self._synced = max(self._synced, self._written)
            self._lock.notify_all()
        seq = self._next_seq()
        self._write_compact_segment(seq, consumed=old)
        self._live.reset_accounting()
        self._seg_seq = seq + 1
        self._seg_path = self._seg_name(self._seg_seq)
        self._f = open(self._seg_path, "ab")
        _fsync_dir(self.path)
        self._dirty = False
        self._last_sync = time.monotonic()

    def _write_compact_segment(self, seq: int, consumed=()) -> None:
        path = self._seg_name(seq)
        with open(path, "wb") as f:
            # the entries carry their "admitted" marks (the live mirror
            # stamps them), so admit records alone carry the live set
            for e in self._live.entries.values():
                f.write(_frame(_encode({"t": "admit", "req": e})))
            f.flush()
            try:
                os.fsync(f.fileno())
            except OSError as e:
                # the new segment is not known to be durable: keep the
                # replaced ones (old + new replay to the same state)
                warnings.warn(
                    f"journal compaction fsync failed ({e!r}); "
                    "keeping the replaced segments")
                self.degrade()
                _fsync_dir(self.path)
                _compactions_total.inc()
                return
        _fsync_dir(self.path)
        for seg in consumed:
            try:
                os.replace(seg, seg + _CONSUMED_SUFFIX)
            except OSError:
                pass
        # keep only the generation just consumed
        keep = {seg + _CONSUMED_SUFFIX for seg in consumed}
        for name in os.listdir(self.path):
            p = os.path.join(self.path, name)
            if name.endswith(_CONSUMED_SUFFIX) and p not in keep:
                try:
                    os.remove(p)
                except OSError:
                    pass
        _fsync_dir(self.path)
        _compactions_total.inc()
