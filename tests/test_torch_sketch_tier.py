"""The lifecycle's sketch tier on the port (``sketch/store.py`` and the
sketch zones of ``sketch/query.py``) held against the JAX package's:
``sketches.bin`` written by either package loads in the other; a
percentile sub-query over a scalar metric whose history lies across
the three sketch zones (cold segment blobs, the in-RAM sketch tier, the
raw tail), and over a histogram metric whose arena rows were spilled
to cold sketch segments (spliced with the live arena rows,
``merge_pct_rows``), answers as the reference does; the demote-time
fold runs under ``sketch.fold``.

Tolerance: the sketches are the reference's bytes, so percentile values
agree within rtol 1e-9 (``torch_pair.assert_rows_close``); timestamps,
tags and row sets equal.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import torch_pair  # noqa: F401 - the JAX package's private native build
from torch_pair import JConfig, JQuery, JTSDB, assert_rows_close, rows

from opentsdb_tpu.core.histogram import SimpleHistogram as JHist
from opentsdb_tpu.sketch.ddsketch import DDSketch as JSketch
from opentsdb_tpu.sketch.query import merge_pct_rows as jmerge
from opentsdb_tpu.sketch.store import SketchTierStore as JStore
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.core.histogram import SimpleHistogram
from opentsdb_tpu_torch.query.engine import QueryResult
from opentsdb_tpu_torch.query.model import TSQuery
from opentsdb_tpu_torch.sketch.ddsketch import DDSketch
from opentsdb_tpu_torch.sketch.query import merge_pct_rows
from opentsdb_tpu_torch.sketch.store import SketchTierStore

BASE = 1356998400
BASE_MS = BASE * 1000
SPAN_S = 7200
NOW_MS = BASE_MS + SPAN_S * 1000
SPILL_B = NOW_MS - 3600_000
DEMOTE_B = NOW_MS - 1800_000
KEYS = {"tsd.core.auto_create_metrics": "true",
        "tsd.rollups.enable": "true",
        "tsd.lifecycle.enable": "true",
        "tsd.lifecycle.demote_after": "30m",
        "tsd.lifecycle.demote_tiers": "1m",
        "tsd.lifecycle.spill_after": "60m",
        "tsd.storage.backend": "native",
        "tsd.query.cache.enable": "false"}


def make(port: bool, data_dir: str, **extra):
    k = {**KEYS, "tsd.storage.data_dir": data_dir, **extra}
    if port:
        return TSDB(Config(**{**k, "tsd.torch.device": "cpu",
                              "tsd.torch.dtype": "float64"}))
    return JTSDB(JConfig(**{**k, "tsd.tpu.platform": "cpu"}))


def run(t, query):
    model = TSQuery if isinstance(t, TSDB) else JQuery
    return rows(t.execute_query(model.from_json(query).validate()))


def pct(metric="lat", ds="10m-avg", gb=None, start=BASE_MS, end=NOW_MS):
    sub = {"metric": metric, "aggregator": "sum",
           "percentiles": [50.0, 99.0, 99.9]}
    if ds:
        sub["downsample"] = ds
    if gb:
        sub["filters"] = [{"type": "wildcard", "tagk": gb, "filter": "*",
                           "groupBy": True}]
    return {"start": start, "end": end, "queries": [sub]}


def scalar_pair(tmp_path, **extra):
    jt = make(False, str(tmp_path / "j"), **extra)
    tt = make(True, str(tmp_path / "t"), **extra)
    ts = np.arange(BASE, BASE + SPAN_S, 10, dtype=np.int64)
    rng = np.random.default_rng(5)
    for i in range(6):
        vals = rng.lognormal(3.0, 0.7, len(ts))
        for t in (jt, tt):
            t.add_points("lat", ts, vals, {"host": f"h{i}",
                                           "dc": f"dc{i % 2}"})
    reps = [t.lifecycle.sweep(now_ms=NOW_MS) for t in (jt, tt)]
    for r in reps:
        r.pop("durationMs")
    return jt, tt, reps


@pytest.fixture(scope="module")
def zones(tmp_path_factory):
    jt, tt, reps = scalar_pair(tmp_path_factory.mktemp("zones"))
    yield jt, tt, reps
    for t in (jt, tt):
        t.shutdown()


def test_demote_and_spill_fold_the_same_cells(zones):
    jt, tt, (jr, tr) = zones
    assert tr == jr and jr["spilled"] > 0
    js, ts_ = jt.lifecycle.sketches, tt.lifecycle.sketches
    assert ts_.describe() == js.describe()
    assert ts_.cell_ms("lat") == js.cell_ms("lat") == 60_000
    want = sorted((tags, c, s.to_bytes())
                  for tags, c, s in js.cells("lat", 0, NOW_MS))
    got = sorted((tags, c, s.to_bytes())
                 for tags, c, s in ts_.cells("lat", 0, NOW_MS))
    assert got == want and len(got) == 6 * 30
    # the cold zone holds the spilled cells' blobs
    jrows = jt.lifecycle.coldstore.sketch_rows("lat", None, 0, NOW_MS)
    trows = tt.lifecycle.coldstore.sketch_rows("lat", None, 0, NOW_MS)
    assert sorted(trows) == sorted(jrows) and len(jrows) == 6 * 60


@pytest.mark.parametrize("window", [
    (BASE_MS, NOW_MS),                        # cold, tier and raw tail
    (BASE_MS, SPILL_B - 1),                   # cold only
    (SPILL_B, DEMOTE_B - 1),                  # the sketch tier only
    (SPILL_B - 1200_000, DEMOTE_B + 600_000)])
@pytest.mark.parametrize("ds,gb", [("10m-avg", None), ("30m-sum", "dc"),
                                   (None, "host")])
def test_zone_percentiles_equal_reference(zones, window, ds, gb):
    jt, tt, _ = zones
    query = pct(ds=ds, gb=gb, start=window[0], end=window[1])
    assert_rows_close(run(tt, query), run(jt, query))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sketches_bin_is_read_by_the_other_package(zones, tmp_path, writer):
    jt, tt, _ = zones
    src = (jt if writer == "jax" else tt).lifecycle.sketches
    path = str(tmp_path / "sketches.bin")
    src.path = path
    try:
        src.save()
    finally:
        src.path = ""
    other = (SketchTierStore if writer == "jax" else JStore)(path)
    other.load()
    assert other.describe()["cells"] == src.describe()["cells"]
    assert sorted((tags, c, s.to_bytes())
                  for tags, c, s in other.cells("lat", 0, NOW_MS)) == \
        sorted((tags, c, s.to_bytes())
               for tags, c, s in src.cells("lat", 0, NOW_MS))


def test_restart_serves_the_same_percentiles(tmp_path):
    jt, tt, _ = scalar_pair(tmp_path)
    want = [run(t, pct()) for t in (jt, tt)]
    for t in (jt, tt):
        t.shutdown()
    for port, d in ((False, "j"), (True, "t")):
        assert os.path.isfile(tmp_path / d / "sketches.bin")
    j2, t2 = make(False, str(tmp_path / "j")), make(True, str(tmp_path / "t"))
    assert_rows_close(run(t2, pct()), want[1])
    assert_rows_close(run(j2, pct()), want[0])
    assert_rows_close(want[1], want[0])
    for t in (j2, t2):
        t.shutdown()


def test_sketch_fold_fault_aborts_the_demotion(tmp_path):
    reps = []
    for port, d in ((False, "j"), (True, "t")):
        t = make(port, str(tmp_path / d),
                 **{"tsd.faults.sketch.fold_error_count": "1"})
        ts = np.arange(BASE, BASE + SPAN_S, 30, dtype=np.int64)
        t.add_points("lat", ts, np.arange(len(ts), dtype=float),
                     {"host": "a"})
        rep = t.lifecycle.sweep(now_ms=NOW_MS)
        rep.pop("durationMs")
        mid = t.uids.metrics.get_id("lat")
        assert t.lifecycle.demote_boundary(mid) == 0
        assert int(t.store.count_range(t.store.series_ids_for_metric(mid),
                                       1, NOW_MS).sum()) == len(ts)
        rep2 = t.lifecycle.sweep(now_ms=NOW_MS)
        rep2.pop("durationMs")
        reps.append((rep, rep2))
        t.shutdown()
    assert reps[1] == reps[0]
    assert reps[0][0]["error"].startswith("InjectedFault")
    assert reps[0][1]["demoted"] > 0


def hist_pair(tmp_path):
    """A histogram metric, 2 h of one point a minute, spilled: the
    arena rows before the spill boundary become cold sketch rows."""
    out = []
    for port, d, cls in ((False, "j", JHist), (True, "t", SimpleHistogram)):
        t = make(port, str(tmp_path / d),
                 **{"tsd.lifecycle.demote_after": "",
                    "tsd.lifecycle.spill_after": "",
                    "tsd.lifecycle.policy.lat.h.demote_after": "30m",
                    "tsd.lifecycle.policy.lat.h.spill_after": "60m"})
        rng = np.random.default_rng(2)
        for i in range(120):
            for host in ("a", "b"):
                h = cls([0.0, 1.0, 2.0, 4.0, 8.0])
                for v, c in zip((0.5, 1.5, 3.0, 6.0),
                                rng.integers(1, 50, 4)):
                    h.add(v, int(c))
                t.add_histogram_point("lat.h", BASE + i * 60,
                                      t.histogram_manager.encode(h),
                                      {"host": host})
        rep = t.lifecycle.sweep(now_ms=NOW_MS)
        rep.pop("durationMs")
        out.append((t, rep))
    return out


def test_histogram_spill_splices_cold_and_live_rows(tmp_path):
    (jt, jr), (tt, tr) = hist_pair(tmp_path)
    assert tr == jr and jr["histogramSpilled"] == 2 * 60
    for t in (jt, tt):
        mid = t.uids.metrics.get_id("lat.h")
        assert t._histogram_arenas[mid].total_points == 2 * 60
    for query in (pct("lat.h", ds="10m-avg"), pct("lat.h", ds=None,
                                                  gb="host"),
                  pct("lat.h", ds="30m-avg", start=BASE_MS,
                      end=SPILL_B - 1)):
        got, want = run(tt, query), run(jt, query)
        assert_rows_close(got, want)
        assert min(min(r[3]) for r in got) < SPILL_B


def _results(make_row, spec):
    return [make_row(m, tags, dps) for m, tags, dps in spec]


def test_merge_pct_rows_equals_reference():
    a = [("m_pct_50", {"h": "a"}, [(1000, 1.0), (3000, 3.0)]),
         ("m_pct_50", {"h": "b"}, [(1000, 5.0)])]
    b = [("m_pct_50", {"h": "a"}, [(2000, 2.0), (3000, 9.0)]),
         ("m_pct_50", {"h": "c"}, [(4000, 4.0)])]

    def port_row(m, tags, dps):
        return QueryResult(m, tags, [], (
            np.asarray([t for t, _ in dps], dtype=np.int64),
            np.asarray([v for _, v in dps], dtype=np.float64)))

    class JRow:
        def __init__(self, m, tags, dps):
            self.metric, self.tags, self.dps = m, tags, list(dps)
            self.sub_query_index = 0

    got = merge_pct_rows(_results(port_row, a), _results(port_row, b))
    want = jmerge(_results(JRow, a), _results(JRow, b))
    assert [(r.metric, r.tags, r.dps) for r in got] == \
        [(r.metric, r.tags, r.dps) for r in want]
    assert merge_pct_rows([], []) == []


def test_ddsketch_bytes_are_the_reference():
    rng = np.random.default_rng(1)
    vals = rng.lognormal(2.0, 1.0, 500)
    a, b = DDSketch(0.01), JSketch(0.01)
    a.add_values(vals)
    b.add_values(vals)
    assert a.to_bytes() == b.to_bytes()
    assert DDSketch.from_bytes(b.to_bytes()).to_bytes() == b.to_bytes()
