"""Port parity: the write-ahead request journal.  The case bodies of
``tests/test_journal.py`` run on both packages' ``RequestJournal`` (framing,
replay, torn tails, rotation, compaction, crash-loop safety, the fault
sites, the watchdog's degrade, the durable helpers, concurrent producers);
then segments written by either package are recovered by the other into
the same live set, and the same records frame to the same bytes.  Host
code only: nothing here steps a model."""
import os
import shutil
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch_threads  # noqa: F401  (one intra-op thread)

from paddle_tpu import monitor as jax_monitor
from paddle_tpu.distributed.watchdog import \
    CommTaskManager as JaxCommTaskManager
from paddle_tpu.inference import journal as jax_journal
from paddle_tpu.testing import faults as jax_faults
from paddle_tpu_torch import monitor as torch_monitor
from paddle_tpu_torch.distributed.watchdog import \
    CommTaskManager as TorchCommTaskManager
from paddle_tpu_torch.inference import journal as torch_journal
from paddle_tpu_torch.testing import faults as torch_faults


def _jax_server():
    from paddle_tpu.inference.server import GenerationServer
    return GenerationServer


def _torch_server():
    from paddle_tpu_torch.inference.server import GenerationServer
    return GenerationServer


PACKAGES = {
    "jax": types.SimpleNamespace(
        journal=jax_journal, monitor=jax_monitor, faults=jax_faults,
        watchdog=JaxCommTaskManager, server=_jax_server),
    "torch": types.SimpleNamespace(
        journal=torch_journal, monitor=torch_monitor, faults=torch_faults,
        watchdog=TorchCommTaskManager, server=_torch_server),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    p = PACKAGES[request.param]
    p.RequestJournal = p.journal.RequestJournal
    yield p
    p.faults.clear()


def counter_value(pkg, name):
    m = pkg.monitor.get_registry().get(name)
    return 0.0 if m is None else m.value()


def admit(rid, **kw):
    e = {"request_id": rid, "prompt": [1, 2, 3], "generated": [],
         "next_token": None, "max_new_tokens": 8, "eos_token_id": None,
         "do_sample": False, "temperature": 1.0, "seed": 0,
         "priority": "standard", "tenant": "default", "draft": False,
         "deadline_unix": None, "queue_deadline_unix": None}
    e.update(kw)
    return e


def segs(d, consumed=False):
    suffix = ".seg.consumed" if consumed else ".seg"
    return sorted(f for f in os.listdir(d) if f.endswith(suffix))


def wait_for(cond, timeout=30.0, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {msg}")


class TestFramingAndReplay:
    def test_roundtrip_admit_step_retire(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        with pkg.RequestJournal(d, fsync="always") as j:
            j.append_admit(admit("a"))
            j.append_admit(admit("b"))
            j.append_step(["a", "b"], [("a", [5, 6], 7),
                                       ("b", [], 9)])
            j.append_retire("b", why="done")
            assert j.flush(sync=True, timeout=30)
        with pkg.RequestJournal(d) as j2:
            ent = j2.recovered_requests()
        assert [e["request_id"] for e in ent] == ["a"]
        e = ent[0]
        assert e["generated"] == [5, 6]
        assert e["next_token"] == 7
        assert e["ttl_remaining_s"] is None
        assert e["queue_timeout_remaining_s"] is None

    def test_step_record_carries_dispatch_count_and_mode(self, pkg,
                                                          tmp_path):
        d = str(tmp_path / "j")
        with pkg.RequestJournal(d, fsync="always") as j:
            j.append_admit(admit("a"))
            j.append_step(["a"], [("a", [5], 6)], dispatches=1,
                          mode="ragged")
            j.append_step([], [("a", [6], 7)], dispatches=3,
                          mode="legacy")
            j.append_step([], [("a", [7], 8)])
            j.flush(sync=True, timeout=30)
        raw = b"".join(
            open(os.path.join(d, f), "rb").read() for f in segs(d))
        steps = [r for r in pkg.journal._read_frames(raw)
                 if r["t"] == "step"]
        assert [(r.get("n"), r.get("mode")) for r in steps] == \
            [(1, "ragged"), (3, "legacy"), (None, None)]
        assert steps[0]["n"] == 1
        with pkg.RequestJournal(d) as j2:
            ent = j2.recovered_requests()
        assert ent[0]["generated"] == [5, 6, 7]
        assert ent[0]["next_token"] == 8

    def test_readmit_replaces_state_idempotently(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        with pkg.RequestJournal(d, fsync="always") as j:
            j.append_admit(admit("a"))
            j.append_step([], [("a", [1], 2)])
            j.append_admit(admit("a", generated=[1, 2, 3], next_token=4))
            j.append_step([], [("a", [4], 5)])
            j.flush()
        with pkg.RequestJournal(d) as j2:
            ent = j2.recovered_requests()
        assert len(ent) == 1
        assert ent[0]["generated"] == [1, 2, 3, 4]
        assert ent[0]["next_token"] == 5

    def test_unknown_ids_in_step_and_retire_ignored(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        with pkg.RequestJournal(d, fsync="always") as j:
            j.append_step(["ghost"], [("ghost", [1], 2)])
            j.append_retire("ghost")
            j.append_admit(admit("real"))
            j.flush()
        with pkg.RequestJournal(d) as j2:
            assert [e["request_id"] for e in j2.recovered_requests()] \
                == ["real"]

    def test_deadlines_convert_to_remaining_seconds(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        with pkg.RequestJournal(d, fsync="always") as j:
            j.append_admit(admit("t", deadline_unix=time.time() + 50.0,
                                 queue_deadline_unix=time.time() + 20.0))
            j.flush()
        with pkg.RequestJournal(d) as j2:
            e = j2.recovered_requests()[0]
        assert 40.0 < e["ttl_remaining_s"] <= 50.0
        assert 10.0 < e["queue_timeout_remaining_s"] <= 20.0

    def test_expired_deadline_clamps_positive(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        with pkg.RequestJournal(d, fsync="always") as j:
            j.append_admit(admit("t", deadline_unix=time.time() - 5.0))
            j.flush()
        with pkg.RequestJournal(d) as j2:
            e = j2.recovered_requests()[0]
        assert 0 < e["ttl_remaining_s"] <= 1e-3

    def test_in_flight_entries_order_before_queued(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        with pkg.RequestJournal(d, fsync="always") as j:
            j.append_admit(admit("queued"))
            j.append_admit(admit("mid_stream"))
            j.append_step(["mid_stream"], [("mid_stream", [1], 2)])
            j.flush()
        with pkg.RequestJournal(d) as j2:
            ids = [e["request_id"] for e in j2.recovered_requests()]
        assert ids == ["mid_stream", "queued"]

    def test_invalid_fsync_policy_rejected(self, pkg, tmp_path):
        with pytest.raises(ValueError):
            pkg.RequestJournal(str(tmp_path / "j"), fsync="sometimes")


class TestTornTail:
    def _write(self, pkg, d, n=5):
        with pkg.RequestJournal(d, fsync="always") as j:
            for i in range(n):
                j.append_admit(admit(f"r{i}"))
            j.flush()

    @pytest.mark.parametrize("chop", [3, 7, 1])
    def test_truncated_tail_recovers_full_frames(self, pkg, tmp_path,
                                                  chop):
        d = str(tmp_path / "j")
        self._write(pkg, d)
        seg = os.path.join(d, segs(d)[-1])
        size = os.path.getsize(seg)
        with open(seg, "r+b") as f:
            f.truncate(size - chop)
        before = counter_value(pkg, "journal_torn_records_total")
        with pkg.RequestJournal(d) as j2:
            ids = [e["request_id"] for e in j2.recovered_requests()]
        assert ids == ["r0", "r1", "r2", "r3"]
        assert counter_value(pkg, "journal_torn_records_total") \
            == before + 1

    def test_corrupt_crc_truncates_there(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        self._write(pkg, d)
        seg = os.path.join(d, segs(d)[-1])
        with open(seg, "r+b") as f:
            f.seek(-3, os.SEEK_END)
            f.write(b"\xff")
        with pkg.RequestJournal(d) as j2:
            ids = [e["request_id"] for e in j2.recovered_requests()]
        assert ids == ["r0", "r1", "r2", "r3"]

    def test_garbage_segment_recovers_empty_not_crash(self, pkg,
                                                      tmp_path):
        d = str(tmp_path / "j")
        os.makedirs(d)
        with open(os.path.join(d, "wal-00000001.seg"), "wb") as f:
            f.write(os.urandom(256))
        before = counter_value(pkg, "journal_torn_records_total")
        with pkg.RequestJournal(d) as j:
            assert j.recovered_requests() == []
        assert counter_value(pkg, "journal_torn_records_total") \
            == before + 1


class TestRotationAndCompaction:
    def test_rotation_spreads_segments_and_recovery_spans_them(
            self, pkg, tmp_path):
        d = str(tmp_path / "j")
        with pkg.RequestJournal(d, fsync="always", segment_bytes=256) as j:
            for i in range(12):
                j.append_admit(admit(f"r{i}"))
            j.flush()
            assert j.segment_count >= 3
        with pkg.RequestJournal(d) as j2:
            ids = sorted(e["request_id"] for e in j2.recovered_requests())
        assert ids == sorted(f"r{i}" for i in range(12))

    def test_dead_ratio_compaction_shrinks_log(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        before = counter_value(pkg, "journal_compactions_total")
        with pkg.RequestJournal(d, fsync="os", compact_min_records=20,
                                compact_dead_ratio=0.5) as j:
            for i in range(30):
                j.append_admit(admit(f"dead{i}"))
                j.append_retire(f"dead{i}")
            j.append_admit(admit("keep"))
            j.flush(sync=False)
            wait_for(lambda: counter_value(
                pkg, "journal_compactions_total") > before,
                msg="auto compaction")
        with pkg.RequestJournal(d) as j2:
            assert [e["request_id"] for e in j2.recovered_requests()] \
                == ["keep"]

    def test_explicit_compact_consumes_segments(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        with pkg.RequestJournal(d, fsync="always", segment_bytes=256) as j:
            for i in range(10):
                j.append_admit(admit(f"r{i}"))
                j.append_retire(f"r{i}")
            j.append_admit(admit("live"))
            j.flush()
            n_before = j.segment_count
            assert j.compact(wait=True, timeout=30)
            assert j.segment_count < n_before
            assert segs(d, consumed=True)
            assert j.live_count == 1
        with pkg.RequestJournal(d) as j2:
            assert [e["request_id"] for e in j2.recovered_requests()] \
                == ["live"]

    def test_consumed_generations_pruned(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        with pkg.RequestJournal(d, fsync="os") as j:
            j.append_admit(admit("a"))
            j.flush(sync=False)
            assert j.compact(wait=True, timeout=30)
            first_gen = set(segs(d, consumed=True))
            j.append_retire("a")
            j.flush(sync=False)
            assert j.compact(wait=True, timeout=30)
            second_gen = set(segs(d, consumed=True))
        assert second_gen and not (first_gen & second_gen)


class TestCrashLoopSafety:
    """Recovery is idempotent: a restart that dies mid-recovery or
    mid-compaction and restarts again rebuilds the same live set."""

    def _seed(self, pkg, d):
        with pkg.RequestJournal(d, fsync="always") as j:
            j.append_admit(admit("a"))
            j.append_step(["a"], [("a", [1, 2], 3)])
            j.append_admit(admit("b"))
            j.append_retire("nobody")
            j.flush()

    def _live(self, pkg, d):
        with pkg.RequestJournal(d) as j:
            return {e["request_id"]: e for e in j.recovered_requests()}

    def test_recovery_renames_consumed_and_is_rerunnable(self, pkg,
                                                         tmp_path):
        d = str(tmp_path / "j")
        self._seed(pkg, d)
        old = segs(d)
        first = self._live(pkg, d)
        assert [s + ".consumed" for s in old] == segs(d, consumed=True)
        assert self._live(pkg, d) == first
        assert self._live(pkg, d) == first
        assert set(first) == {"a", "b"}
        assert first["a"]["generated"] == [1, 2]
        assert first["a"]["next_token"] == 3

    def test_restart_on_partially_compacted_segments(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        self._seed(pkg, d)
        first = self._live(pkg, d)
        for name in segs(d, consumed=True):
            p = os.path.join(d, name)
            os.rename(p, p[:-len(".consumed")])
        assert self._live(pkg, d) == first

    def test_restart_on_torn_compacted_segment(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        self._seed(pkg, d)
        ref = self._live(pkg, d)
        for name in segs(d, consumed=True):
            p = os.path.join(d, name)
            os.rename(p, p[:-len(".consumed")])
        compact = os.path.join(d, segs(d)[-1])
        with open(compact, "r+b") as f:
            f.truncate(max(0, os.path.getsize(compact) - 5))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = self._live(pkg, d)
        assert got == ref

    def test_recovered_entries_readmitted_then_rerecovered(self, pkg,
                                                           tmp_path):
        d = str(tmp_path / "j")
        self._seed(pkg, d)
        with pkg.RequestJournal(d, fsync="always") as j:
            ent = j.recovered_requests()
            for e in ent:
                j.append_admit(admit(
                    e["request_id"], generated=e["generated"],
                    next_token=e["next_token"]))
            j.flush()
        again = self._live(pkg, d)
        assert {r: (e["generated"], e["next_token"])
                for r, e in again.items()} \
            == {e["request_id"]: (e["generated"], e["next_token"])
                for e in ent}


class TestFaultSitesAndDegrade:
    def test_sites_registered(self, pkg):
        assert "journal_write" in pkg.faults.SITES
        assert "journal_fsync" in pkg.faults.SITES

    def test_journal_write_tears_one_record_keeps_rest(self, pkg,
                                                       tmp_path):
        d = str(tmp_path / "j")
        with pkg.faults.installed(pkg.faults.FaultPlan(
                [{"site": "journal_write", "nth": 2}])):
            with pkg.RequestJournal(d, fsync="always") as j:
                for i in range(4):
                    j.append_admit(admit(f"w{i}"))
                j.flush()
        before = counter_value(pkg, "journal_torn_records_total")
        with pkg.RequestJournal(d) as j2:
            ids = sorted(e["request_id"]
                         for e in j2.recovered_requests())
        assert ids == ["w0", "w2", "w3"]
        assert counter_value(pkg, "journal_torn_records_total") \
            == before + 1

    def test_journal_fsync_error_degrades_not_raises(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pkg.faults.installed(pkg.faults.FaultPlan(
                    [{"site": "journal_fsync", "nth": 1}])):
                with pkg.RequestJournal(d, fsync="always") as j:
                    j.append_admit(admit("a"))
                    wait_for(lambda: j.degraded, msg="degrade")
                    assert j.effective_policy == "os"
                    assert j.fsync_policy == "always"
        assert counter_value(pkg, "journal_degraded") == 1

    def test_hung_fsync_fires_watchdog_and_degrades(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        before = counter_value(pkg, "comm_timeouts_total")
        mgr = pkg.watchdog.instance()
        scanning = mgr._thread is not None and mgr._thread.is_alive()
        j = pkg.RequestJournal(d, fsync="always", fsync_timeout_s=0.05)
        try:
            with pkg.faults.installed(pkg.faults.FaultPlan(
                    [{"site": "journal_fsync", "kind": "delay",
                      "delay_s": 0.6}])):
                j.append_admit(admit("a"))
                wait_for(lambda: j._op_age() is not None
                         and j._op_age() > 0.05, msg="hung fsync")
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    pkg.watchdog.instance().scan_once()
                wait_for(lambda: j.degraded, msg="watchdog degrade")
            assert j.effective_policy == "os"
            assert counter_value(pkg, "comm_timeouts_total") >= before + 1
            assert counter_value(pkg, "journal_degraded") == 1
            j.append_admit(admit("b"))
            assert j.flush(sync=False, timeout=30)
        finally:
            j.close()
            if not scanning:
                # the journal started the process-wide watchdog's scan
                # thread at its default 1 s period; a later test that
                # times a shorter scan must find it stopped
                mgr.stop()

    def test_sites_free_when_disabled(self, pkg, tmp_path):
        assert pkg.faults.active() is None
        with pkg.RequestJournal(str(tmp_path / "j"), fsync="always") as j:
            j.append_admit(admit("a"))
            assert j.flush(sync=True, timeout=30)


class TestDurableHelpers:
    def test_durable_replace_moves_content(self, pkg, tmp_path):
        tmp = str(tmp_path / "x.tmp")
        dst = str(tmp_path / "x.json")
        with open(tmp, "w") as f:
            f.write("payload")
        pkg.journal.durable_replace(tmp, dst)
        assert not os.path.exists(tmp)
        with open(dst) as f:
            assert f.read() == "payload"

    def test_fsync_file_and_dir_runs(self, pkg, tmp_path):
        p = str(tmp_path / "f")
        with open(p, "w") as f:
            f.write("x")
        pkg.journal.fsync_file_and_dir(p)

    def test_save_snapshot_uses_durable_replace(self, pkg):
        import inspect
        src = inspect.getsource(pkg.server().save_snapshot)
        assert "durable_replace" in src


class TestWriterConcurrency:
    def test_many_producers_one_writer(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        with pkg.RequestJournal(d, fsync="interval_ms",
                                fsync_interval_ms=5.0) as j:
            def produce(tid):
                for i in range(25):
                    j.append_admit(admit(f"t{tid}-{i}"))
                    if i % 3 == 0:
                        j.append_retire(f"t{tid}-{i}")
            threads = [threading.Thread(target=produce, args=(t,))
                       for t in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert j.flush(sync=True, timeout=60)
        with pkg.RequestJournal(d) as j2:
            ids = {e["request_id"] for e in j2.recovered_requests()}
        expect = {f"t{t}-{i}" for t in range(4) for i in range(25)
                  if i % 3 != 0}
        assert ids == expect

    def test_append_after_close_is_noop(self, pkg, tmp_path):
        d = str(tmp_path / "j")
        j = pkg.RequestJournal(d, fsync="always")
        j.append_admit(admit("a"))
        j.close()
        j.append_retire("a")
        with pkg.RequestJournal(d) as j2:
            assert [e["request_id"] for e in j2.recovered_requests()] \
                == ["a"]


# ------------------------------------------------- across the packages
def _history(j):
    """Every record type, a numpy prompt, a torn tail to come: the same
    calls on either package's journal."""
    j.append_admit(admit("a", prompt=np.arange(5, dtype=np.int32),
                         deadline_unix=4102444800.0))
    j.append_admit(admit("b", do_sample=True, temperature=0.8, seed=7))
    j.append_admit(admit("c", priority="batch", tenant="offline",
                         queue_deadline_unix=4102444800.0))
    j.append_step(["a", "b"], [("a", [], 11), ("b", [], 12)],
                  dispatches=1, mode="ragged")
    j.append_pages("a", "registered", 16, [3, 4], "ab" * 16)
    j.append_step([], [("a", [11], 13), ("b", [12, 14], 15)],
                  dispatches=2, mode="legacy")
    j.append_retire("b", why="RequestCancelled")
    j.append_admit(admit("d", generated=[1, 2], next_token=3))


def _stable(entries):
    """Recovered entries without the seconds left, which the clock moves
    between two recoveries."""
    out = []
    for e in entries:
        e = dict(e)
        for k in ("ttl_remaining_s", "queue_timeout_remaining_s"):
            e[k] = None if e[k] is None else round(e[k] / 3600.0)
        out.append(e)
    return out


def _info(j):
    return {k: v for k, v in j.info().items() if k != "path"}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("torn", [False, True], ids=["whole", "torn"])
def test_segments_recover_across_packages(tmp_path, writer, reader, torn):
    """Segments one package wrote recover in the other into the live set
    the writer's own package recovers, with the same ``info()``; a torn
    tail is cut at the same record in both."""
    d = str(tmp_path / "w")
    with PACKAGES[writer].journal.RequestJournal(
            d, fsync="always", segment_bytes=512) as j:
        _history(j)
        assert j.flush(sync=True, timeout=30)
    if torn:
        seg = os.path.join(d, segs(d)[-1])
        with open(seg, "r+b") as f:
            f.truncate(os.path.getsize(seg) - 4)
    shutil.copytree(d, str(tmp_path / "r"))
    with PACKAGES[writer].journal.RequestJournal(d) as own, \
            PACKAGES[reader].journal.RequestJournal(
                str(tmp_path / "r")) as other:
        got, want = other.recovered_requests(), own.recovered_requests()
        assert _stable(got) == _stable(want)
        assert _info(other) == _info(own)
    ids = [e["request_id"] for e in want]
    assert ids == (["a", "c"] if torn else ["a", "d", "c"])
    a = want[0]
    assert a["generated"] == [11] and a["next_token"] == 13
    assert a["prefix"] == {"event": "registered", "tokens": 16,
                           "pages": [3, 4], "key": "ab" * 16}
    # the compacted segments each wrote are byte-identical too
    assert [open(os.path.join(d, s), "rb").read() for s in segs(d)] \
        == [open(os.path.join(str(tmp_path / "r"), s), "rb").read()
            for s in segs(str(tmp_path / "r"))]


def test_same_records_frame_to_same_bytes(tmp_path):
    """Each record, numpy values included, encodes and frames to the
    same bytes in both packages, and the same appends write byte-equal
    segments."""
    recs = [{"t": "admit", "req": admit(
                "x", prompt=np.asarray([7, 8, 9], np.int32),
                generated=[np.int64(4)], temperature=np.float32(0.5))},
            {"t": "step", "adm": ["x"], "rows": [["x", [4, 5], 6]],
             "n": 1, "mode": "ragged"},
            {"t": "pages", "id": "x", "event": "acquired", "tokens": 8,
             "pages": [1], "key": None},
            {"t": "retire", "ids": ["x"], "why": "done"}]
    for rec in recs:
        want = jax_journal._frame(jax_journal._encode(rec))
        assert torch_journal._frame(torch_journal._encode(rec)) == want
        assert list(torch_journal._read_frames(want)) \
            == list(jax_journal._read_frames(want))
    raw = {}
    for name, p in PACKAGES.items():
        d = str(tmp_path / name)
        with p.journal.RequestJournal(d, fsync="always") as j:
            _history(j)
            assert j.flush(sync=True, timeout=30)
        raw[name] = [open(os.path.join(d, s), "rb").read()
                     for s in segs(d)]
    assert raw["torch"] == raw["jax"]
    assert sum(len(b) for b in raw["jax"]) > 0
