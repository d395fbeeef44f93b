"""The cold tier on the port (``opentsdb_tpu_torch/coldstore/``) held
against the JAX package's (``opentsdb_tpu/coldstore/``): segment files
written by either package are read by the other (the same bytes), the
spill sweep on the same seeded data gives the same report, manifest,
segment files and three-zone stitched rows, on both stores. Cases
mirror ``tests/test_coldstore.py``: the format and its checksums, the
spill and its fault, restart in the other package, the crash order (an
orphan segment file; RAM duplicates clipped at the spill boundary and
purged by the next sweep), merge-compaction, retention drops and
trims, quarantine and the boundary clamp, ``fsck_scan``.

ROADMAP Queue 3 item 21 is pinned here: an armed ``coldstore.read`` or
an open cold read breaker makes the reference serve the tier and raw
zones alone (200, part of the history); the port raises DegradedError,
a structured 503 with ``Retry-After``, and the next query answers in
full, equal to the reference's full answer.

Tolerance: float64 on both sides, rtol 1e-9 and atol 1e-9 * max|x|
(``torch_pair.assert_rows_close``); timestamps, tags and NaN positions
equal; reports equal exactly, and manifests and segment bytes on the
native store (on the memory store the sum column within 1e-12).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

import torch_pair  # noqa: F401 - the JAX package's private native build
from torch_pair import (ENGINE_KEYS, JConfig, JQuery, JTSDB,
                        assert_rows_close, rows)

from opentsdb_tpu.coldstore import format as jfmt
from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.coldstore import format as tfmt
from opentsdb_tpu_torch.query.model import TSQuery
from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
from opentsdb_tpu_torch.utils.faults import DegradedError

BASE = 1356998400
BASE_MS = BASE * 1000
SPAN_S = 7200
STEP_S = 10
NOW_MS = BASE_MS + SPAN_S * 1000
# demote_after=30m, spill_after=60m with 1m tiers:
# cold [BASE, NOW-60m) | tier [NOW-60m, NOW-30m) | raw [NOW-30m, NOW]
DEMOTE_B = NOW_MS - 1800_000
SPILL_B = NOW_MS - 3600_000
STORES = ("memory", "native")
CLOCK_FIELDS = ("durationMs",)
KEYS = {"tsd.core.auto_create_metrics": "true",
        "tsd.rollups.enable": "true",
        "tsd.lifecycle.enable": "true",
        "tsd.lifecycle.demote_after": "30m",
        "tsd.lifecycle.demote_tiers": "1m",
        "tsd.lifecycle.spill_after": "60m", **ENGINE_KEYS}


def make(port: bool, cold_dir: str = "", data_dir: str = "",
         backend: str = "native", **extra):
    k = {**KEYS, "tsd.storage.backend": backend, **extra}
    if data_dir:
        k["tsd.storage.data_dir"] = data_dir
    elif cold_dir:
        k["tsd.coldstore.dir"] = cold_dir
    if port:
        return TSDB(Config(**{**k, "tsd.torch.device": "cpu",
                              "tsd.torch.dtype": "float64"}))
    return JTSDB(JConfig(**{**k, "tsd.tpu.platform": "cpu"}))


def ingest(ts_list, n_series=4, seed=7, metric="sys.cpu"):
    ts = np.arange(BASE, BASE + SPAN_S, STEP_S, dtype=np.int64)
    rng = np.random.default_rng(seed)
    for i in range(n_series):
        vals = rng.normal(100, 10, len(ts))
        for t in ts_list:
            t.add_points(metric, ts, vals,
                         {"host": f"h{i:02d}", "dc": f"dc{i % 2}"})


def sweep(t, now_ms=NOW_MS):
    rep = t.lifecycle.sweep(now_ms=now_ms)
    for f in CLOCK_FIELDS:
        rep.pop(f, None)
    return rep


def q(ds="1m-sum", agg="sum", start=BASE_MS, end=NOW_MS, gb="dc"):
    sub = {"metric": "sys.cpu", "aggregator": agg, "downsample": ds}
    if gb:
        sub["filters"] = [{"type": "wildcard", "tagk": gb, "filter": "*",
                           "groupBy": True}]
    return {"start": start, "end": end, "queries": [sub]}


def run(t, query):
    model = TSQuery if isinstance(t, TSDB) else JQuery
    return rows(t.execute_query(model.from_json(query).validate()))


def spilled(tmp_path, backend="native", **extra):
    """A spilled TSDB of each package on the same data, cold dirs apart
    (``j`` and ``t`` under ``tmp_path``)."""
    jt = make(False, str(tmp_path / "j"), backend=backend, **extra)
    tt = make(True, str(tmp_path / "t"), backend=backend, **extra)
    ingest((jt, tt))
    jr, tr = sweep(jt), sweep(tt)
    assert jr["spilled"] > 0
    return jt, tt, jr, tr


def manifest(d):
    with open(os.path.join(d, "manifest.json")) as fh:
        return json.load(fh)


# -- the segment format -------------------------------------------------------

@pytest.mark.parametrize("ts", [
    [BASE_MS, BASE_MS + 60_000, BASE_MS + 120_000],
    [BASE_MS + 1, BASE_MS + 7],
    [0, 2**40],
    []])
def test_pack_timestamps_equal(ts):
    a = np.asarray(ts, dtype=np.int64)
    got, want = tfmt.pack_timestamps(a), jfmt.pack_timestamps(a)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype and got[1:] == want[1:]


def _segment_args(sketch: bool):
    ts = BASE_MS + 60_000 * np.arange(6, dtype=np.int64)
    cols = {s: np.arange(6, dtype=np.float64) + i
            for i, s in enumerate(tfmt.STATS)}
    header = {"metric": "m", "interval": "1m", "base_ms": 0, "scale": 1,
              "start_ms": int(ts[0]), "end_ms": int(ts[-1]),
              "stats": list(tfmt.STATS),
              "series": [{"tags": [["host", "a"]], "off": 0, "cnt": 3},
                         {"tags": [["host", "b"]], "off": 3, "cnt": 3}]}
    col, base, scale = tfmt.pack_timestamps(ts)
    header.update(base_ms=base, scale=scale)
    sk = None
    if sketch:
        blobs = [b"", b"xy", b"", b"abc", b"d", b""]
        off = np.zeros(7, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=off[1:])
        sk = (off, b"".join(blobs))
    return header, col, cols, sk


@pytest.mark.parametrize("sketch", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_segment_written_by_one_package_read_by_the_other(tmp_path, writer,
                                                          sketch):
    header, col, cols, sk = _segment_args(sketch)
    wmod, rmod = (jfmt, tfmt) if writer == "jax" else (tfmt, jfmt)
    entry = wmod.write_segment(str(tmp_path), "s.cold", dict(header), col,
                               cols, sketch=sk)
    other = (tfmt if writer == "jax" else jfmt).write_segment(
        str(tmp_path / "o"), "s.cold", dict(header), col, cols, sketch=sk)
    assert entry == other
    assert (tmp_path / "s.cold").read_bytes() == \
        (tmp_path / "o" / "s.cold").read_bytes()
    seg = rmod.Segment(str(tmp_path / "s.cold"))
    assert seg.header["format"] == (2 if sketch else 1)
    np.testing.assert_array_equal(seg.ts64(0, 6),
                                  BASE_MS + 60_000 * np.arange(6))
    for s in tfmt.STATS:
        np.testing.assert_array_equal(np.asarray(seg.cols[s]), cols[s])
    assert seg.series == [((("host", "a"),), 0, 3), ((("host", "b"),), 3, 3)]
    if sketch:
        assert [seg.sketch_blob(i) for i in range(6)] == \
            [None, b"xy", None, b"abc", b"d", None]
    assert rmod.verify_data_crc(str(tmp_path / "s.cold"))


@pytest.mark.parametrize("damage", ["magic", "header", "truncate", "data"])
def test_corruption_detected_alike(tmp_path, damage):
    header, col, cols, _ = _segment_args(False)
    path = tmp_path / "s.cold"
    tfmt.write_segment(str(tmp_path), "s.cold", header, col, cols)
    raw = bytearray(path.read_bytes())
    if damage == "magic":
        raw[0:2] = b"XX"
    elif damage == "header":
        raw[30] ^= 0xFF
    elif damage == "truncate":
        raw = raw[:-9]
    else:
        raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    outcome = []
    for mod in (jfmt, tfmt):
        try:
            mod.Segment(str(path))
            outcome.append(("ok", mod.verify_data_crc(str(path))))
        except mod.SegmentError as exc:
            outcome.append(("error", str(exc)))
    assert outcome[0] == outcome[1]
    assert outcome[0] != ("ok", True)


# -- the spill ---------------------------------------------------------------

@pytest.mark.parametrize("backend", STORES)
def test_spill_equals_reference(tmp_path, backend):
    """The same report (compaction counters aside: ROADMAP Queue 3 item
    22), the same manifest and segment bytes, the same boundaries, and
    the same three-zone rows for each stat and window. On the memory
    store the tier sums (and so the sum column, its checksum and the
    header's length) may differ in the last bits: the two memory
    stores' ``bucket_reduce`` add a cell's points in another order; the
    columns agree within 1e-12."""
    jt, tt, jr, tr = spilled(tmp_path, backend)
    if backend == "memory":
        jr = {**jr, "bytesReclaimed": 0, "seriesReleased": 0}
    assert tr == jr
    mj, mt = manifest(tmp_path / "j"), manifest(tmp_path / "t")
    if backend == "native":
        assert mt == mj
    for e, et in zip(mj["metrics"]["sys.cpu"]["segments"],
                     mt["metrics"]["sys.cpu"]["segments"]):
        fj, ft = tmp_path / "j" / e["file"], tmp_path / "t" / et["file"]
        if backend == "native":
            assert ft.read_bytes() == fj.read_bytes()
            continue
        loose = ("bytes", "data_crc", "header_crc")
        assert {k: v for k, v in et.items() if k not in loose} == \
            {k: v for k, v in e.items() if k not in loose}
        sj, st = tfmt.Segment(str(fj)), tfmt.Segment(str(ft))
        assert st.series == sj.series
        np.testing.assert_array_equal(np.asarray(st.ts), np.asarray(sj.ts))
        for stat in tfmt.STATS:
            np.testing.assert_allclose(np.asarray(st.cols[stat]),
                                       np.asarray(sj.cols[stat]),
                                       rtol=1e-12)
        assert bytes(st.sk_blob) == bytes(sj.sk_blob)
    for t in (jt, tt):
        assert t.lifecycle.coldstore.spill_boundary("sys.cpu") == SPILL_B
        mid = t.uids.metrics.get_id("sys.cpu")
        assert t.lifecycle.demote_boundary(mid) == DEMOTE_B
        tier = t.rollup_store.tier("1m", "sum")
        assert int(tier.count_range(tier.series_ids_for_metric(mid), 1,
                                    SPILL_B - 1).sum()) == 0
    for ds, agg in (("1m-sum", "sum"), ("1m-count", "sum"),
                    ("1m-min", "min"), ("1m-max", "max"),
                    ("1m-avg", "avg"), ("5m-sum", "sum")):
        assert_rows_close(run(tt, q(ds, agg)), run(jt, q(ds, agg)))
    for start, end in ((BASE_MS, SPILL_B - 1), (SPILL_B - 600_000,
                                                DEMOTE_B + 600_000)):
        assert_rows_close(run(tt, q(start=start, end=end)),
                          run(jt, q(start=start, end=end)))


def test_spill_write_fault_leaves_ram_authoritative(tmp_path):
    outs = []
    for port, d in ((False, "j"), (True, "t")):
        t = make(port, str(tmp_path / d),
                 **{"tsd.faults.coldstore.write_error_count": "1"})
        ingest((t,))
        rep = sweep(t)
        assert rep["error"].startswith("InjectedFault")
        assert t.lifecycle.coldstore.spill_errors == 1
        assert t.lifecycle.coldstore.spill_boundary("sys.cpu") == 0
        rep2 = sweep(t)
        outs.append((rep, rep2, run(t, q())))
    assert outs[0][:2] == outs[1][:2]
    assert_rows_close(outs[1][2], outs[0][2])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restart_in_the_other_package(tmp_path, writer):
    """A data_dir swept and spilled by one package (snapshot, WAL,
    ``lifecycle.json``, cold manifest and segments, ``sketches.bin``)
    restarts in the other and serves the same rows."""
    d = str(tmp_path / "d")
    src = make(writer == "port", data_dir=d)
    ingest((src,))
    sweep(src)
    want = run(src, q())
    want_pct = run(src, {"start": BASE_MS, "end": NOW_MS, "queries": [
        {"metric": "sys.cpu", "aggregator": "sum", "percentiles": [50, 99],
         "downsample": "10m-avg"}]})
    src.shutdown()
    assert {"lifecycle.json", "sketches.bin", "coldstore"} <= \
        set(os.listdir(d))
    dst = make(writer == "jax", data_dir=d)
    assert dst.lifecycle.coldstore.spill_boundary("sys.cpu") == SPILL_B
    assert_rows_close(run(dst, q()), want)
    assert_rows_close(run(dst, {"start": BASE_MS, "end": NOW_MS,
                                "queries": [{"metric": "sys.cpu",
                                             "aggregator": "sum",
                                             "percentiles": [50, 99],
                                             "downsample": "10m-avg"}]}),
                      want_pct)
    dst.shutdown()


# -- the crash order ---------------------------------------------------------

def test_orphan_segment_invisible_and_flagged(tmp_path):
    """A segment written but never committed (a crash before the
    manifest write) is not read, and ``fsck_scan`` reports it, in both
    packages; ``remove_orphan`` sets it aside."""
    jt, tt, _, _ = spilled(tmp_path)
    served = [run(t, q()) for t in (jt, tt)]
    findings = []
    for t in (jt, tt):
        cold = t.lifecycle.coldstore
        cold.write_segment("sys.cpu", "1m",
                           [{"tags": [["dc", "dc0"], ["host", "h00"]],
                             "off": 0, "cnt": 1}],
                           np.asarray([SPILL_B], dtype=np.int64),
                           {s: np.ones(1) for s in tfmt.STATS})
        mid = t.uids.metrics.get_id("sys.cpu")
        f = cold.fsck_scan({"sys.cpu": t.lifecycle.demote_boundary(mid)})
        findings.append(f)
        assert [x["fix"] for x in f] == ["orphan"]
        cold.remove_orphan(f[0]["file"])
        assert cold.fsck_scan({"sys.cpu": DEMOTE_B}) == []
    assert findings[0] == findings[1]
    for t, want in zip((jt, tt), served):
        assert run(t, q()) == want
    assert_rows_close(served[1], served[0])


def test_resurrected_tier_duplicates_clipped_then_reconciled(tmp_path):
    """A crash between the manifest commit and the RAM purge leaves the
    spilled cells in the cold segments and in the tier: stitched reads
    clip them, the next sweep purges them, in both packages."""
    jt, tt, _, _ = spilled(tmp_path)
    want = [run(t, q()) for t in (jt, tt)]
    reps = []
    for t in (jt, tt):
        mid = t.uids.metrics.get_id("sys.cpu")
        tier = t.rollup_store.tier("1m", "sum")
        tsids = tier.series_ids_for_metric(mid)
        cells = BASE_MS + 60_000 * np.arange(10, dtype=np.int64)
        tier.append_grid(tsids, cells, np.full((len(tsids), 10), 1e6),
                         np.ones((len(tsids), 10), dtype=bool))
        assert int(tier.count_range(tsids, 1, SPILL_B - 1).sum()) > 0
        reps.append(sweep(t))
        assert int(tier.count_range(tsids, 1, SPILL_B - 1).sum()) == 0
    assert reps[0] == reps[1]
    for t, w in zip((jt, tt), want):
        assert run(t, q()) == w


# -- compaction, retention, quarantine ---------------------------------------

def test_merge_compaction_equals_reference(tmp_path):
    """Two spills give two segments; ``tsd.coldstore.compact_segments=1``
    merges them on the next sweep, in both packages, into the same
    file."""
    outs = []
    for port, d in ((False, "j"), (True, "t")):
        t = make(port, str(tmp_path / d),
                 **{"tsd.coldstore.compact_segments": "1"})
        ingest((t,))
        reps = [sweep(t, NOW_MS - 1200_000), sweep(t, NOW_MS)]
        outs.append((reps, manifest(tmp_path / d), run(t, q())))
    (jreps, jm, jrows), (treps, tm, trows) = outs
    assert treps == jreps
    assert tm == jm
    assert jreps[1]["coldCompacted"] >= 1
    assert_rows_close(trows, jrows)


def test_retention_drops_and_trims_segments_alike(tmp_path):
    outs = []
    for port, d in ((False, "j"), (True, "t")):
        t = make(port, str(tmp_path / d))
        ingest((t,))
        sweep(t)
        t.lifecycle.update_policies({"policies": [{
            "metric": "*", "retention": "100m", "demoteAfter": "30m",
            "demoteTiers": ["1m"], "spillAfter": "60m"}]})
        rep = sweep(t)
        outs.append((rep, manifest(tmp_path / d), run(t, q()),
                     t.lifecycle.coldstore.counters()))
    assert outs[1][0] == outs[0][0] and outs[0][0]["purged"] > 0
    assert outs[1][1] == outs[0][1]
    assert_rows_close(outs[1][2], outs[0][2])
    for k in ("segmentsDropped", "pointsDeleted", "segmentsWritten"):
        assert outs[1][3][k] == outs[0][3][k]


def test_quarantine_and_clamp_alike(tmp_path):
    jt, tt, _, _ = spilled(tmp_path)
    for t, d in ((jt, "j"), (tt, "t")):
        cold = t.lifecycle.coldstore
        seg = manifest(tmp_path / d)["metrics"]["sys.cpu"]["segments"][0]
        assert cold.quarantine("sys.cpu", seg["file"])
        assert (tmp_path / d / (seg["file"] + ".quarantine")).exists()
        assert not cold.quarantine("sys.cpu", seg["file"])
        assert not cold.clamp_boundary("sys.cpu", SPILL_B)
        assert cold.clamp_boundary("sys.cpu", SPILL_B - 600_000)
        assert cold.spill_boundary("sys.cpu") == SPILL_B - 600_000
        f = cold.fsck_scan({"sys.cpu": SPILL_B - 1200_000})
        assert [x["fix"] for x in f] == ["clamp"]
    assert manifest(tmp_path / "t") == manifest(tmp_path / "j")
    assert_rows_close(run(tt, q()), run(jt, q()))


# -- Queue 3 item 21: a failed cold read ------------------------------------

def _status(router, cls):
    resp = router.handle(cls(method="POST", path="/api/query",
                             body=json.dumps(q()).encode()))
    return resp


@pytest.mark.parametrize("how", ["fault", "breaker"])
def test_failed_cold_read_503_where_the_reference_serves_part(tmp_path,
                                                              how):
    """The reference answers the tier and raw zones alone (200, fewer
    points); the port answers a structured 503 with ``Retry-After`` and
    no rows, counts the failure as the reference does, and its next
    query answers in full, equal to the reference's full answer."""
    extra = {"tsd.query.cache.enable": "false",
             "tsd.coldstore.breaker.failure_threshold":
                 "1" if how == "breaker" else "3",
             "tsd.coldstore.breaker.reset_timeout_ms": "60000"}
    jt, tt, _, _ = spilled(tmp_path, **extra)
    full = run(jt, q())
    assert_rows_close(run(tt, q()), full)
    for t in (jt, tt):
        t.faults.arm("coldstore.read", error_count=1)
    # the reference answers (200) from whatever cold calls of the query
    # did not fail; with the breaker open, from the tier and raw only
    part = run(jt, q())
    assert part
    if how == "breaker":
        assert min(min(r[3]) for r in run(jt, q())) >= SPILL_B
    with pytest.raises(DegradedError, match="cold segment read failed"):
        run(tt, q())
    if how == "breaker":
        # the failure opened the breaker (threshold 1): the next read
        # is refused before it touches a segment
        assert tt.lifecycle.coldstore.read_breaker.state == "open"
        resp = _status(HttpRpcRouter(tt), HttpRequest)
        assert resp.status == 503 and resp.headers.get("Retry-After")
        err = json.loads(resp.body)["error"]
        assert err["code"] == 503 and "breaker is open" in err["message"]
        assert _status(JRouter(jt), JRequest).status == 200
        for t in (jt, tt):
            t.lifecycle.coldstore.read_breaker.reset_timeout_ms = 0.0
    # one read error each; the reference then serves the rest of that
    # query past its open breaker (counted as degraded serves, one per
    # cold call), the port counts one refusal per 503
    jc, tc = (t.lifecycle.coldstore.counters() for t in (jt, tt))
    assert tc["readErrors"] == jc["readErrors"] == 1
    assert tc["degradedServes"] == (1 if how == "breaker" else 0)
    assert jc["degradedServes"] >= tc["degradedServes"]
    assert_rows_close(run(tt, q()), full)
    assert_rows_close(run(jt, q()), full)


def test_describe_and_stats_equal_reference(tmp_path):
    """After a spill, ``GET /api/lifecycle``'s document (clocks and the
    cold directory aside) and the lifecycle's and cold store's stats
    are the reference's, ``storage.cold_bytes`` among them (the
    reference's trace-span latencies aside)."""
    jt, tt, _, _ = spilled(tmp_path)
    docs = []
    for t in (jt, tt):
        doc = t.lifecycle.describe()
        for part in (doc["counters"],):
            for f in ("lastSweepDurationMs", "lastSweepTime"):
                part.pop(f)
        doc["coldstore"].pop("dir")
        docs.append(doc)
    assert docs[1] == docs[0]
    stats = []
    for t in (jt, tt):
        stats.append({(r["metric"], tuple(sorted(r["tags"].items()))):
                      r["value"] for r in t.stats.collect().as_json()
                      if ("lifecycle." in r["metric"]
                          or "coldstore." in r["metric"]
                          or "cold_bytes" in r["metric"])
                      and "duration" not in r["metric"]
                      # the reference's span latencies come with obs/
                      # (ROADMAP Queue 1 item 1.6)
                      and not r["metric"].startswith("tsd.latency.")})
    assert stats[1] == stats[0]
    cold_bytes = []
    for t in (jt, tt):
        c = type(t.stats.collect())()
        t.collect_stats(c)
        cold_bytes.append([r["value"] for r in c.as_json()
                           if r["metric"] == "tsd.storage.cold_bytes"])
    assert cold_bytes[1] == cold_bytes[0] and cold_bytes[0][0] > 0


def test_spill_of_stat_stores_that_disagree(tmp_path):
    """A tier series that only the sum store holds (an external
    ``/api/rollup`` writer's) makes the four stat stores disagree: the
    spill takes the per-series union, the missing stats NaN, as the
    reference does; the same manifest and segment bytes."""
    for port, d in ((False, "j"), (True, "t")):
        t = make(port, str(tmp_path / d))
        ingest((t,))
        for off in (60, 120):
            t.add_aggregate_point("sys.cpu", BASE + off, 5.0,
                                  {"host": "ext", "dc": "dc0"}, False,
                                  "1m", "sum")
        assert sweep(t)["spilled"] > 0
    mj, mt = manifest(tmp_path / "j"), manifest(tmp_path / "t")
    assert mt == mj
    for e in mj["metrics"]["sys.cpu"]["segments"]:
        assert (tmp_path / "t" / e["file"]).read_bytes() == \
            (tmp_path / "j" / e["file"]).read_bytes()
    seg = tfmt.Segment(str(tmp_path / "t" / mj["metrics"]["sys.cpu"]
                           ["segments"][0]["file"]))
    ext = [(off, cnt) for tags, off, cnt in seg.series
           if ("host", "ext") in tags]
    assert len(ext) == 1
    off, cnt = ext[0]
    assert np.isnan(np.asarray(seg.cols["count"])[off:off + cnt]).all()


def test_spill_of_a_cell_that_one_stat_store_adds(tmp_path):
    """An external writer's cell on an existing series, between two of
    the rollup job's cells and in the max store alone: that series'
    timestamps are the union of the four stores', the other stats NaN
    at that cell, as the reference's; the same manifest and segment
    bytes."""
    for port, d in ((False, "j"), (True, "t")):
        t = make(port, str(tmp_path / d))
        ingest((t,))
        t.add_aggregate_point("sys.cpu", BASE + 90, 7.0,
                              {"host": "h01", "dc": "dc1"}, False,
                              "1m", "max")
        assert sweep(t)["spilled"] > 0
    mj, mt = manifest(tmp_path / "j"), manifest(tmp_path / "t")
    assert mt == mj
    for e in mj["metrics"]["sys.cpu"]["segments"]:
        assert (tmp_path / "t" / e["file"]).read_bytes() == \
            (tmp_path / "j" / e["file"]).read_bytes()
    seg = tfmt.Segment(str(tmp_path / "t" / mj["metrics"]["sys.cpu"]
                           ["segments"][0]["file"]))
    (off, cnt), = [(off, cnt) for tags, off, cnt in seg.series
                   if ("host", "h01") in tags]
    ts = seg.ts64(off, off + cnt)
    row = off + int(np.nonzero(ts == (BASE + 90) * 1000)[0][0])
    assert np.asarray(seg.cols["max"])[row] == 7.0
    for stat in ("sum", "count", "min"):
        assert np.isnan(np.asarray(seg.cols[stat])[row])
