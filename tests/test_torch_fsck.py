"""``fsck`` on the port (``opentsdb_tpu_torch/tools/fsck.py``) held
against the JAX package's (``opentsdb_tpu/tools/fsck.py``): the cases of
``tests/test_fsck_corruption.py``, ``tests/test_stats_auth_fsck.py::
TestFsck``, the fsck cases of ``tests/test_coldstore.py`` and
``tests/test_lifecycle.py`` (``TestFsckLifecycle``), each run on one
TSDB of each package with the same writes and the same corruption, on
the memory and the native store where the case allows. The reports must
agree exactly: ``errors``, ``fixed``, ``series_checked``,
``points_checked`` and ``lines``, in the same order. Queries after a
repair are held by ``torch_pair.assert_rows_close`` (float64 on both
sides, rtol 1e-9 and atol 1e-9 * max|x|; timestamps, tags and NaN
positions equal).

The corruption goes in through the stores' own calls, which both
packages have (``append`` below the write validation, ``patch_value``,
and a UID table entry removed), not through the reference's per-series
buffers, which the port's stores do not keep.

ROADMAP Queue 3 item 28 is pinned here: the reference's memory store
reports an emptied series as a ghost (zero points, buffers still
allocated) when the lifecycle is on; the port's stores keep no buffer
of a series and report none.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import torch_pair  # noqa: F401 - the JAX package's private native build
from torch_pair import JConfig, JQuery, JTSDB, assert_rows_close, rows

from opentsdb_tpu.tools.fsck import run_fsck as jrun_fsck
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.query.model import TSQuery
from opentsdb_tpu_torch.tools.fsck import MAX_VALID_MS
from opentsdb_tpu_torch.tools.fsck import run_fsck as trun_fsck

BASE = 1356998400
STORES = ("native", "memory")
KEYS = {"tsd.core.auto_create_metrics": "true"}


class Pair:
    """A JAX TSDB and a port TSDB (CPU, float64) with the same keys."""

    def __init__(self, backend="native", data_dirs=("", ""), **keys):
        k = {**KEYS, "tsd.storage.backend": backend, **keys}
        self.jt = JTSDB(JConfig(**{**k, "tsd.tpu.platform": "cpu",
                                   "tsd.storage.data_dir": data_dirs[0]}))
        self.tt = TSDB(Config(**{**k, "tsd.torch.device": "cpu",
                                 "tsd.torch.dtype": "float64",
                                 "tsd.storage.data_dir": data_dirs[1]}))

    def each(self, fn):
        return [fn(self.jt), fn(self.tt)]

    def fsck(self, fix=False, workers=8):
        """Both reports; they must be equal field by field. ``workers``
        is the reference's thread count (the port's scan takes none)."""
        j = jrun_fsck(self.jt, fix=fix, workers=workers)
        t = trun_fsck(self.tt, fix=fix)
        assert t.lines == j.lines
        assert (t.errors, t.fixed, t.series_checked, t.points_checked) == \
            (j.errors, j.fixed, j.series_checked, j.points_checked)
        return t

    def query(self, metric="f.m", end=BASE + 3600):
        q = {"start": BASE * 1000, "end": end * 1000,
             "queries": [{"metric": metric, "aggregator": "sum"}]}
        got = rows(self.tt.execute_query(TSQuery.from_json(q).validate()))
        want = rows(self.jt.execute_query(JQuery.from_json(q).validate()))
        assert_rows_close(got, want)
        return got

    def sid(self, metric="f.m"):
        return self.each(lambda t: int(t.store.series_ids_for_metric(
            t.uids.metrics.get_id(metric))[0]))

    def append(self, ts_ms, value, metric="f.m"):
        for t, sid in zip((self.jt, self.tt), self.sid(metric)):
            t.store.append(sid, ts_ms, value, False)

    def close(self):
        for t in (self.jt, self.tt):
            t.shutdown()


@pytest.fixture(params=STORES)
def pair(request):
    p = Pair(request.param)
    yield p
    p.close()


@pytest.fixture
def memory_pair():
    p = Pair("memory")
    yield p
    p.close()


def seed(p, n=10):
    ts = BASE + 30 * np.arange(1, n + 1, dtype=np.int64)
    p.each(lambda t: t.add_points("f.m", ts, np.arange(1, n + 1,
                                                       dtype=np.float64),
                                  {"host": "a"}))
    return ts


# -- tests/test_fsck_corruption.py ---------------------------------------------

def test_no_data(pair):
    rep = pair.fsck()
    assert rep.errors == 0 and rep.series_checked == 0


def test_no_errors(pair):
    seed(pair)
    rep = pair.fsck()
    assert rep.errors == 0 and rep.points_checked == 10


def test_no_errors_ms_and_seconds_mixed(pair):
    pair.each(lambda t: t.add_point("f.m", BASE + 1, 1.0, {"host": "a"}))
    pair.each(lambda t: t.add_point("f.m", (BASE + 1) * 1000 + 500, 2.0,
                                    {"host": "a"}))
    assert pair.fsck().errors == 0


def test_multiple_series_parallel_scan(pair):
    ts = BASE + np.arange(1, 11, dtype=np.int64)
    for i in range(50):
        pair.each(lambda t: t.add_points("f.m", ts, np.ones(10),
                                         {"host": f"h{i}"}))
    rep = pair.fsck(workers=8)
    assert rep.errors == 0 and rep.series_checked == 50


def test_nonfinite_detect(pair):
    ts = seed(pair)
    pair.append(int(ts[-1] + 30) * 1000, float("inf"))
    pair.append(int(ts[-1] + 60) * 1000, float("nan"))
    rep = pair.fsck()
    assert rep.errors >= 1 and any("non-finite" in ln for ln in rep.lines)


def test_nonfinite_fix_repairs_and_rescan_clean(pair):
    ts = seed(pair)
    pair.append(int(ts[-1] + 30) * 1000, float("nan"))
    assert pair.fsck(fix=True).fixed >= 1
    assert pair.fsck().errors == 0
    got = pair.query()
    assert len(got[0][4]) == 10 and np.isfinite(got[0][4]).all()


def test_bad_timestamps_detect_and_fix(pair):
    seed(pair)
    pair.append((1 << 33) * 1000 * 1000, 5.0)
    rep = pair.fsck()
    assert any("out of range" in ln for ln in rep.lines)
    assert pair.fsck(fix=True).fixed >= 1
    assert pair.fsck().errors == 0
    assert len(pair.query()[0][4]) == 10


def test_memory_store_pending_dupes_detected(memory_pair):
    """The memory store reports a duplicate not folded yet, and
    ``--fix`` folds it: the last write wins."""
    p = memory_pair
    p.each(lambda t: t.add_point("f.m", BASE + 30, 1.0, {"host": "a"}))
    p.each(lambda t: t.add_point("f.m", BASE + 30, 2.0, {"host": "a"}))
    rep = p.fsck(fix=True)
    assert rep.errors >= 1 and rep.fixed >= 1
    assert any("duplicate timestamp" in ln for ln in rep.lines)
    assert p.fsck().errors == 0
    got = p.query()
    assert got[0][3] == [(BASE + 30) * 1000] and got[0][4] == [2.0]


def test_memory_store_out_of_order_detected(memory_pair):
    p = memory_pair
    for ts in (BASE + 60, BASE + 30, BASE + 90):
        p.each(lambda t: t.add_point("f.m", ts, float(ts), {"host": "a"}))
    rep = p.fsck()
    assert any("buffer out of order" in ln for ln in rep.lines)
    assert p.fsck(fix=True).fixed == 1 and p.fsck().errors == 0
    assert p.query()[0][3] == [(BASE + s) * 1000 for s in (30, 60, 90)]


def test_native_store_dupes_resolved_internally():
    p = Pair("native")
    try:
        p.each(lambda t: t.add_point("f.m", BASE + 30, 1.0, {"host": "a"}))
        p.each(lambda t: t.add_point("f.m", BASE + 30, 2.0, {"host": "a"}))
        assert p.fsck().errors == 0
        assert p.query()[0][4] == [2.0]
    finally:
        p.close()


@pytest.mark.parametrize("kind", ["metric", "tagk", "tagv"])
def test_orphaned_uid_detected(memory_pair, kind):
    p = memory_pair
    seed(p)
    name = {"metric": "f.m", "tagk": "host", "tagv": "a"}[kind]
    for t in (p.jt, p.tt):
        reg = t.uids.by_kind(kind)
        uid = reg.get_id(name)
        with reg._lock:
            del reg._id_to_name[uid]
            del reg._name_to_id[name]
    rep = p.fsck()
    assert rep.errors >= 1 and any("unresolvable" in ln for ln in rep.lines)


def test_fix_flushes_durable_store(tmp_path):
    """Repairs survive a restart: the fix snapshots and truncates the
    WAL, in both packages."""
    dirs = (str(tmp_path / "j"), str(tmp_path / "t"))
    p = Pair(data_dirs=dirs)
    ts = seed(p)
    p.append(int(ts[-1] + 30) * 1000, float("nan"))
    p.each(lambda t: t.flush())
    assert p.fsck(fix=True).fixed >= 1
    p.close()
    p2 = Pair(data_dirs=dirs)
    try:
        assert p2.fsck().errors == 0
        got = p2.query()
        assert len(got[0][4]) == 10 and np.isfinite(got[0][4]).all()
    finally:
        p2.close()


def test_report_lines_name_series(pair):
    ts = seed(pair)
    pair.append(int(ts[-1] + 30) * 1000, float("nan"))
    assert any("f.m" in ln for ln in pair.fsck().lines)


# -- tests/test_stats_auth_fsck.py::TestFsck ----------------------------------

def test_clean_store_seeded(pair):
    for i in range(300):
        pair.each(lambda t: t.add_point("sys.cpu.user", BASE + i * 10, i,
                                        {"host": "web01"}))
        pair.each(lambda t: t.add_point("sys.cpu.user", BASE + i * 10,
                                        300 - i, {"host": "web02"}))
    rep = pair.fsck()
    assert rep.errors == 0 and rep.series_checked == 2
    assert rep.points_checked == 600


def test_detects_nonfinite_values(pair):
    pair.each(lambda t: t.add_point("m", BASE, 1.0, {"host": "a"}))
    for t, sid in zip((pair.jt, pair.tt), pair.sid("m")):
        t.store.patch_value(sid, BASE * 1000, float("nan"))
    rep = pair.fsck()
    assert rep.errors == 1 and rep.fixed == 0
    assert pair.fsck(fix=True).fixed == 1
    assert pair.fsck().errors == 0


def test_detects_duplicate_timestamps(memory_pair):
    p = memory_pair
    p.each(lambda t: t.add_point("m", BASE, 1.0, {"host": "a"}))
    p.each(lambda t: t.add_point("m", BASE, 2.0, {"host": "a"}))
    rep = p.fsck()
    assert rep.errors >= 1 and any("duplicate" in ln for ln in rep.lines)
    assert p.fsck(fix=True).fixed >= 1
    ts, vals, _ = p.tt.store.series_points(0)
    assert list(ts) == [BASE * 1000] and list(vals) == [2.0]
    assert p.fsck().errors == 0


def test_detects_out_of_range_timestamp(pair):
    pair.each(lambda t: t.add_point("m", BASE, 1.0, {"host": "a"}))
    pair.append(-5, 1.0, metric="m")
    assert any("out of range" in ln for ln in pair.fsck().lines)
    pair.fsck(fix=True)
    assert pair.fsck().errors == 0


def test_repairs_corruption_in_place(pair):
    pair.each(lambda t: t.add_point("m", BASE, 1.0, {"host": "a"}))
    pair.each(lambda t: t.add_point("m", BASE + 60, 2.0, {"host": "a"}))
    for ts_ms, v in ((BASE * 1000 + 120_000, float("nan")),
                     (BASE * 1000 + 180_000, float("inf")), (-5, 7.0),
                     (MAX_VALID_MS + 1, 8.0)):
        pair.append(ts_ms, v, metric="m")
    rep = pair.fsck()
    assert any("non-finite" in ln for ln in rep.lines)
    assert any("out of range" in ln for ln in rep.lines)
    assert rep.fixed == 0
    assert pair.fsck(fix=True).fixed >= 2
    assert pair.fsck().errors == 0
    ts, vals, _ = pair.tt.store.series_points(pair.sid("m")[1])
    np.testing.assert_array_equal(ts, [BASE * 1000, BASE * 1000 + 60_000])
    np.testing.assert_array_equal(vals, [1.0, 2.0])


def test_repair_survives_restart(tmp_path):
    dirs = (str(tmp_path / "j"), str(tmp_path / "t"))
    p = Pair(data_dirs=dirs)
    p.each(lambda t: t.add_point("m", BASE, 1.0, {"host": "a"}))
    p.append(BASE * 1000 + 60_000, float("nan"), metric="m")
    p.each(lambda t: t.flush())
    assert p.fsck(fix=True).fixed >= 1
    p.close()
    p2 = Pair(data_dirs=dirs)
    try:
        assert p2.fsck().errors == 0
        ts, _, _ = p2.tt.store.series_points(p2.sid("m")[1])
        np.testing.assert_array_equal(ts, [BASE * 1000])
    finally:
        p2.close()


@pytest.mark.parametrize("backend", STORES)
def test_patch_value(backend):
    p = Pair(backend)
    try:
        p.each(lambda t: t.add_point("m", BASE, 1.0, {"host": "a"}))
        for t, sid in zip((p.jt, p.tt), p.sid("m")):
            t.store.patch_value(sid, BASE * 1000, 42.0)
            with pytest.raises(KeyError):
                t.store.patch_value(sid, 999, 0.0)
        assert p.query("m")[0][4] == [42.0]
    finally:
        p.close()


def test_report_order_follows_the_shards(pair):
    """Many series with a fault each: the lines come shard by shard, in
    the reference's order, not by series id."""
    ts = BASE + np.arange(1, 4, dtype=np.int64)
    for i in range(40):
        pair.each(lambda t: t.add_points("f.m", ts, np.ones(3),
                                         {"host": f"h{i}"}))
    sids = pair.each(lambda t: [int(s) for s in t.store.series_ids_for_metric(
        t.uids.metrics.get_id("f.m"))])
    for t, ids in zip((pair.jt, pair.tt), sids):
        for sid in ids:
            t.store.append(sid, BASE * 1000 + 60_000, float("nan"), False)
    rep = pair.fsck()
    assert rep.errors == 40
    order = [int(ln.split()[2]) for ln in rep.lines]
    assert order != sorted(order)


# -- tests/test_coldstore.py (fsck) ------------------------------------------

from test_torch_coldstore import manifest, q, run, spilled  # noqa: E402


def test_cold_orphan_segment_flagged_and_removed(tmp_path):
    jt, tt, _, _ = spilled(tmp_path)
    for t in (jt, tt):
        cold = t.lifecycle.coldstore
        cold.write_segment(
            "sys.cpu", "1m", [{"tags": [["host", "h00"]], "off": 0,
                              "cnt": 1}],
            np.asarray([BASE * 1000], dtype=np.int64),
            {s: np.ones(1) for s in ("sum", "count", "min", "max")})
    p = _wrap(jt, tt)
    assert any("not in manifest" in ln for ln in p.fsck().lines)
    assert p.fsck(fix=True).fixed > 0
    assert not any("not in manifest" in ln for ln in p.fsck().lines)


def test_cold_corrupt_segment_quarantined(tmp_path):
    jt, tt, _, _ = spilled(tmp_path)
    for t, d in ((jt, "j"), (tt, "t")):
        seg = manifest(tmp_path / d)["metrics"]["sys.cpu"]["segments"][0]
        path = tmp_path / d / seg["file"]
        with open(path, "r+b") as fh:
            fh.seek(os.path.getsize(path) - 10)
            fh.write(b"\xff\xff\xff")
    p = _wrap(jt, tt)
    assert any("checksum mismatch" in ln for ln in p.fsck().lines)
    assert p.fsck(fix=True).fixed > 0
    for d in ("j", "t"):
        assert any(f.endswith(".quarantine")
                   for f in os.listdir(tmp_path / d))
    assert not any("cold" in ln for ln in p.fsck().lines)
    assert_rows_close(run(tt, q()), run(jt, q()))


def test_cold_missing_demote_boundary_report_only(tmp_path):
    jt, tt, _, _ = spilled(tmp_path)
    for t in (jt, tt):
        mid = t.uids.metrics.get_id("sys.cpu")
        with t.lifecycle._lock:
            t.lifecycle._boundaries.pop(mid)
    p = _wrap(jt, tt)
    assert any("no demotion boundary" in ln for ln in p.fsck().lines)
    rep = p.fsck(fix=True)
    assert rep.fixed == 0
    assert any("ERROR: cold segment" in ln for ln in rep.lines)
    for t in (jt, tt):
        assert t.lifecycle.coldstore.segments_quarantined == 0


def test_cold_boundary_inconsistency_clamped(tmp_path):
    from test_torch_coldstore import DEMOTE_B
    jt, tt, _, _ = spilled(tmp_path)
    for t in (jt, tt):
        cold = t.lifecycle.coldstore
        with cold._lock:
            cold._metrics["sys.cpu"]["spill_boundary_ms"] = \
                DEMOTE_B + 3600_000
            cold._save_manifest_locked()
    p = _wrap(jt, tt)
    assert any("double-served" in ln for ln in p.fsck().lines)
    p.fsck(fix=True)
    for t in (jt, tt):
        assert t.lifecycle.coldstore.spill_boundary("sys.cpu") == DEMOTE_B
    assert not any("double-served" in ln for ln in p.fsck().lines)


def _wrap(jt, tt) -> Pair:
    p = Pair.__new__(Pair)
    p.jt, p.tt = jt, tt
    return p


# -- tests/test_lifecycle.py::TestFsckLifecycle -------------------------------

LC_NOW_MS = (BASE + 7200) * 1000
LC = {"tsd.rollups.enable": "true", "tsd.lifecycle.enable": "true",
      "tsd.lifecycle.demote_after": "30m",
      "tsd.lifecycle.demote_tiers": "1m"}


def lc_ingest(p, n_series, span_s):
    ts = np.arange(BASE, BASE + span_s, 1, dtype=np.int64)
    rng = np.random.default_rng(0)
    for i in range(n_series):
        v = rng.normal(100, 10, span_s)
        p.each(lambda t: t.add_points("sys.cpu", ts, v, {"host": f"h{i:02d}"}))


@pytest.mark.parametrize("backend", STORES)
def test_expired_detection_and_repair(backend):
    p = Pair(backend, **{**LC, "tsd.lifecycle.retention": "1h",
                         "tsd.lifecycle.demote_after": ""})
    try:
        lc_ingest(p, 2, 600)
        for t in (p.jt, p.tt):
            real = t.lifecycle.scan_expired
            t.lifecycle.scan_expired = \
                lambda now_ms=None, real=real: real(LC_NOW_MS)
        assert any("expired-but-present" in ln for ln in p.fsck().lines)
        assert p.fsck(fix=True).fixed > 0
        for t in (p.jt, p.tt):
            sids = t.store.series_ids_for_metric(
                t.uids.metrics.get_id("sys.cpu"))
            assert int(t.store.count_range(sids, 1, LC_NOW_MS).sum()) == 0
        assert p.fsck().errors == 0
    finally:
        p.close()


@pytest.mark.parametrize("backend", STORES)
def test_ghost_series(backend):
    """An emptied series: the reference's memory store reports it as a
    ghost and releases it on ``--fix``; the port's stores, like both
    native stores, hold nothing for it and report nothing (Queue 3
    item 28). Everything else in the reports is equal."""
    p = Pair(backend, **{**LC, "tsd.lifecycle.retention": ""})
    try:
        lc_ingest(p, 2, 120)
        for t in (p.jt, p.tt):
            sids = t.store.series_ids_for_metric(
                t.uids.metrics.get_id("sys.cpu"))
            t.store.delete_range(sids[:1], 1, LC_NOW_MS)
        j, t = jrun_fsck(p.jt), trun_fsck(p.tt)
        ghost = [ln for ln in j.lines if "ghost series" in ln]
        assert len(ghost) == (1 if backend == "memory" else 0)
        assert t.lines == [ln for ln in j.lines if ln not in ghost]
        assert t.errors == j.errors - len(ghost)
        assert (t.series_checked, t.points_checked) == \
            (j.series_checked, j.points_checked)
        # the reference's fix of its ghost runs a lifecycle sweep (at the
        # wall clock: it demotes the raw points); the port has nothing
        # to fix, so only each side's re-run is held clean
        jrun_fsck(p.jt, fix=True)
        trun_fsck(p.tt, fix=True)
        assert jrun_fsck(p.jt).errors == trun_fsck(p.tt).errors == 0
    finally:
        p.close()


def test_fsck_unchanged_when_lifecycle_disabled(memory_pair):
    p = memory_pair
    lc_ingest(p, 1, 60)
    for t in (p.jt, p.tt):
        t.store.get_or_create_series(
            t.uids.metrics.get_id("sys.cpu"),
            [(t.uids.tag_names.get_id("host"),
              t.uids.tag_values.get_or_create_id("zz"))])
    assert p.fsck().errors == 0
