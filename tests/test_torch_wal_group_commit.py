"""Group commit and request-scoped WAL batching on the port, the cases
of ``tests/test_wal_group_commit.py`` that need no cluster, histogram
or plugin hook, on the CPU: the bounded commit window and its early
exits, acknowledgement by sequence, one framed write and one fsync per
put body, telnet burst and import buffer, the crash contract on a torn
tail, degraded mode, and the WAL's counters in ``/api/stats`` under
the reference's names. Plus the front end's durability: an
``/api/put`` body read back after a crash, and ``/diediedie`` flushing.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from test_torch_wal import T0, jtsdb, ptsdb, segments

from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu_torch.core.wal import WriteAheadLog
from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
from opentsdb_tpu_torch.tsd.server import ServerThread
from opentsdb_tpu_torch.tsd.telnet import TelnetRouter
from opentsdb_tpu_torch.utils.faults import FaultInjector


def _fsyncs(t) -> int:
    """Physical fsync attempts seen at the wal.fsync site (armed with a
    schedule that never fails: a counter)."""
    return t.faults._sites["wal.fsync"].calls


class TestGroupCommitWindow:
    def test_concurrent_writers_amortize_fsyncs(self, tmp_path):
        t = ptsdb(tmp_path, **{"tsd.storage.wal.group_window_ms": "25"})
        t.faults.arm("wal.fsync")
        threads, per = 6, 40

        def writer(k):
            for i in range(per):
                t.add_point("gc.m", T0 + k * 10_000 + i, i, {"h": f"w{k}"})

        ths = [threading.Thread(target=writer, args=(k,))
               for k in range(threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(60)
        total = threads * per
        assert t.store.total_points() == total
        assert 0 < t.wal.group_syncs <= total // 3, t.wal.health_info()
        assert _fsyncs(t) <= total // 3 + 5
        assert t.wal.piggybacked_syncs > 0
        assert t.wal.records_per_sync() > 1.0
        assert t.wal.sync_lag() == 0
        t.shutdown()

    def test_lone_writer_never_delayed_past_window(self, tmp_path):
        window_s = 0.4
        t = ptsdb(tmp_path, **{"tsd.storage.wal.group_window_ms":
                               str(int(window_s * 1000))})
        n = 5
        t0 = time.monotonic()
        for i in range(n):
            t.add_point("lone.m", T0 + i, i, {"h": "a"})
        elapsed = time.monotonic() - t0
        assert elapsed < n * (window_s + 0.5)
        assert elapsed / n < window_s, (elapsed, t.wal.health_info())
        assert t.wal.idle_breaks >= 1
        assert t.wal.sync_lag() == 0
        t.shutdown()

    def test_blocked_waiters_do_not_hold_window_open(self, tmp_path):
        window_s = 1.0
        t = ptsdb(tmp_path, **{"tsd.storage.wal.group_window_ms":
                               str(int(window_s * 1000))})
        ths = [threading.Thread(target=lambda k=k: t.add_point(
            "w.m", T0 + k, k, {"h": f"w{k}"})) for k in range(2)]
        t0 = time.monotonic()
        for th in ths:
            th.start()
        for th in ths:
            th.join(30)
        assert time.monotonic() - t0 < 0.9 * window_s
        assert t.wal.sync_lag() == 0
        t.shutdown()

    def test_size_cap_cuts_window_short(self, tmp_path):
        t = ptsdb(tmp_path, **{"tsd.storage.wal.group_window_ms": "3000",
                               "tsd.storage.wal.group_max_records": "5"})
        w = t.wal
        for i in range(10):          # appended, not yet synced
            w.log_point("data", 0, (T0 + i) * 1000, float(i), False)
        t0 = time.monotonic()
        w.sync()
        assert time.monotonic() - t0 < 1.0
        assert w.size_triggers == 1
        assert w.sync_lag() == 0
        t.wal.close()

    def test_fsync_failure_never_strands_waiters(self, tmp_path):
        """With the disk down, every durable put still returns
        (degraded, and flagged) and nothing deadlocks."""
        t = ptsdb(tmp_path, **{
            "tsd.storage.wal.group_window_ms": "50",
            "tsd.faults.wal.fsync_error_rate": "1.0",
            "tsd.storage.wal.resync_interval_ms": "100"})
        done = []

        def writer(k):
            for i in range(10):
                t.add_point("strand.m", T0 + k * 100 + i, i, {"h": f"w{k}"})
            done.append(k)

        ths = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(30)
        assert len(done) == 4, "a durable put stranded on a dead disk"
        assert t.wal.degraded and t.wal.health_info()["degraded"]
        assert t.wal.sync_failures >= 1
        assert t.store.total_points() == 40
        t.wal.close()

    @pytest.mark.parametrize("role,raw,want", [
        ("", "", 0.0), ("shard", "", 2.0), ("shard", "0", 0.0),
        ("", "7", 7.0)])
    def test_group_window_follows_the_role(self, tmp_path, role, raw,
                                           want):
        """The reference's window is ``want`` ms: 2 ms by default on a
        cluster shard, where the router's clients write concurrently,
        and an explicit value, 0 included, wins."""
        keys = {"tsd.cluster.role": role,
                "tsd.storage.wal.group_window_ms": raw}
        t = ptsdb(tmp_path, **keys)
        assert t.wal.health_info()["group_window_ms"] == want
        t.wal.close()


class TestBatchScope:
    def test_put_body_is_one_fsync(self, tmp_path):
        """An N-series put body (add_point_groups) commits one fsync."""
        t = ptsdb(tmp_path)
        t.faults.arm("wal.fsync")
        groups = [("b.m", {"h": f"h{g}"}, list(range(5)),
                   [T0 + i for i in range(5)], list(range(5)))
                  for g in range(6)]
        before = _fsyncs(t)
        assert t.add_point_groups(groups) == (30, [])
        assert _fsyncs(t) - before == 1
        t.shutdown()
        assert ptsdb(tmp_path).store.total_points() == 30

    def test_import_buffer_is_one_fsync(self, tmp_path):
        t = ptsdb(tmp_path)
        t.faults.arm("wal.fsync")
        buf = "".join(f"i.m {T0 + i} {i} h=h{i % 4}\n"
                      for i in range(40)).encode()
        before = _fsyncs(t)
        assert t.import_buffer(buf) == (40, [])
        assert _fsyncs(t) - before == 1
        t.wal.close()
        assert ptsdb(tmp_path).store.total_points() == 40

    def test_add_series_points_is_one_fsync(self, tmp_path):
        t = ptsdb(tmp_path)
        t.faults.arm("wal.fsync")
        before = _fsyncs(t)
        t.add_series_points("s.m", [{"h": f"h{i}"} for i in range(8)],
                            T0 + 60 * np.arange(6)[None, :].repeat(8, 0),
                            np.ones((8, 6)))
        assert _fsyncs(t) - before == 1
        t.wal.close()
        assert ptsdb(tmp_path).store.total_points() == 48

    def test_batch_commits_on_exception(self, tmp_path):
        w = WriteAheadLog(str(tmp_path / "wal"))
        with pytest.raises(RuntimeError, match="boom"):
            with w.batch():
                w.log_point("data", 0, T0 * 1000, 1.0, False)
                w.sync()
                raise RuntimeError("boom")
        assert w.last_seq() == 1
        assert w.sync_lag() == 0
        w.close()

    def test_close_mid_scope_sheds_instead_of_raising(self, tmp_path):
        w = WriteAheadLog(str(tmp_path / "wal"))
        with w.batch():
            w.log_point("data", 0, T0 * 1000, 1.0, False)
            w.sync()
            w.close()
        assert w.append_dropped == 1
        assert w.last_seq() == 0

    def test_degraded_batch_keeps_known_unmarked(self, tmp_path):
        fi = FaultInjector()
        fi.arm("wal.append", error_rate=1.0)
        w = WriteAheadLog(str(tmp_path / "wal"), faults=fi,
                          resync_ms=60_000)
        with w.batch():
            w.ensure_series("data", 0, "m", {"h": "a"})
            w.log_point("data", 0, T0 * 1000, 1.0, False)
            w.sync()
        assert ("data", 0) not in w._known
        assert w.append_failures == 1 and w.degraded
        fi.disarm()
        w._append_failing = False
        w.ensure_series("data", 0, "m", {"h": "a"})
        assert ("data", 0) in w._known
        w.close()

    def test_torn_tail_acked_prefix_survives_exactly(self, tmp_path):
        t = ptsdb(tmp_path)
        groups = [("t.m", {"h": f"h{g}"}, [0, 1, 2, 3],
                   [T0 + 4 * k + g for k in range(4)], [1, 2, 3, 4])
                  for g in range(3)]
        assert t.add_point_groups(groups) == (12, [])    # acknowledged
        (seg,) = segments(tmp_path)
        acked_size = seg.stat().st_size
        t.add_point_groups([("t.m", {"h": "x"}, list(range(5)),
                             [T0 + 100 + i for i in range(5)], [1.0] * 5)])
        with open(seg, "r+b") as fh:
            fh.truncate(acked_size + 7)   # mid-header of the second body
        assert ptsdb(tmp_path).store.total_points() == 12


class TestFrontEnd:
    def test_telnet_burst_is_one_fsync(self, tmp_path):
        t = ptsdb(tmp_path)
        t.faults.arm("wal.fsync")
        r = TelnetRouter(t)
        before = _fsyncs(t)
        lines = [f"put s.m {T0 + i} {i} h=a" for i in range(20)]
        lines.insert(5, f"put s.m {T0 + 5} nan h=a")   # replayed scalar
        responses, exc = r.execute_lines(lines)
        assert responses == [] and exc is None
        assert _fsyncs(t) - before == 1
        want = t.store.series_points(0)
        t.wal.close()
        got = ptsdb(tmp_path).store.series_points(0)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1].view(np.int64),
                                      want[1].view(np.int64))

    def test_http_put_body_is_durable_in_one_fsync(self, tmp_path):
        t = ptsdb(tmp_path)
        t.faults.arm("wal.fsync")
        body = json.dumps([{"metric": "h.m", "timestamp": T0 + i,
                            "value": i, "tags": {"h": f"h{i % 3}"}}
                           for i in range(12)]).encode()
        before = _fsyncs(t)
        resp = HttpRpcRouter(t).handle(HttpRequest("POST", "/api/put",
                                                   body=body))
        assert resp.status == 204
        assert _fsyncs(t) - before == 1
        t.wal.close()                   # a crash: no flush
        assert ptsdb(tmp_path).store.total_points() == 12

    def test_stats_carry_wal_counters_under_reference_names(self,
                                                           tmp_path):
        body = json.dumps([{"metric": "o.m", "timestamp": T0 + i,
                            "value": i, "tags": {"h": "a"}}
                           for i in range(10)]).encode()
        t, j = ptsdb(tmp_path / "p"), jtsdb(tmp_path / "j")
        pr, jr = HttpRpcRouter(t), JRouter(j)
        pr.handle(HttpRequest("POST", "/api/put", body=body))
        jr.handle(JRequest("POST", "/api/put", body=body))
        got = {r["metric"] for r in json.loads(
            pr.handle(HttpRequest("GET", "/api/stats")).body)
            if r["metric"].startswith("tsd.wal.")}
        want = {r["metric"] for r in json.loads(
            jr.handle(JRequest("GET", "/api/stats")).body)
            if r["metric"].startswith("tsd.wal.")}
        assert got == want and "tsd.wal.records_per_sync" in got
        info = t.wal.health_info()
        assert info.keys() == j.wal.health_info().keys()
        assert info["group_syncs"] >= 1 and info["records_per_sync"] > 1
        t.shutdown()
        j.shutdown()

    def test_diediedie_flushes(self, tmp_path):
        t = ptsdb(tmp_path)
        st = ServerThread(t).start()
        base = f"http://127.0.0.1:{st.port}"
        req = urllib.request.Request(
            base + "/api/put", method="POST", data=json.dumps(
                {"metric": "d.m", "timestamp": T0, "value": 3,
                 "tags": {"h": "a"}}).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 204
        with urllib.request.urlopen(base + "/diediedie", timeout=30) as resp:
            assert resp.status == 200
        st.stop(timeout=30)    # already stopping: joins its thread
        # the snapshot holds the point and the log holds nothing more
        assert os.path.isfile(tmp_path / "META.json")
        assert not segments(tmp_path)
        t2 = ptsdb(tmp_path, **{"tsd.storage.wal.enable": "false"})
        assert t2.store.series_points(0)[1].tolist() == [3.0]
