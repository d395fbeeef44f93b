"""The port's histograms and percentile sub-queries against the JAX
package's, on the CPU.

- Codec and arena: ``SimpleHistogram`` (blob bytes, ``percentile``,
  ``merge``, ``set_bucket``, ``to_json``) equal to the reference's; a
  batch of odd blobs lands as the reference's; the arena's growth, snapshot stability and under/overflow columns equal
  to the reference arena's.
- Ops: ``merge_histograms`` and ``percentiles_from_merged`` (and the
  pipeline) equal the reference's float64 ``percentiles_from_counts``
  bit for bit. Against the reference's float32 device pipeline they
  differ only at the (percentile, segment) positions where the float32
  and the float64 target ranks fall on two sides of a cumulative count
  (:func:`positions`); a pinned input holds one such position (ROADMAP
  Queue 3).
- Engine: both TSDBs take the same writes by ``add_histogram_point`` and
  ``add_histogram_batch`` (with the same per-point errors). The rows
  (names ``<metric>_pct_<q>``, tags, aggregated tags, timestamps) are
  equal; the values equal the reference's engine with its device
  pipeline replaced by the float64 one bit for bit, and its float32
  answer everywhere but at the positions found by the same rule.
  The result cache sees a histogram write.
- URI ``percentile[...]``, ``/api/histogram`` and telnet ``histogram``
  against the reference's parser and routers.
- Durability: ``T_HIST`` record bytes and ``histograms.json`` bytes
  (v2) equal the reference's; each package replays the other's log and
  loads the other's file, v2 and v1.

Tolerance: none. Every comparison is bit for bit, or as stated above.
"""

import base64
import json
import threading

import numpy as np
import pytest
import torch

from torch_pair import ENGINE_KEYS, T0

from opentsdb_tpu import TSDB as JTSDB  # noqa: E402  (after torch_pair)
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.core import histogram as jhist
from opentsdb_tpu.ops import histogram_kernels as jkern
from opentsdb_tpu.query import histogram_engine as jengine
from opentsdb_tpu.query.model import TSQuery as JQuery
from opentsdb_tpu.query.model import parse_uri_subquery as jparse_uri
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu.tsd.telnet import TelnetRouter as JTelnet
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.core import histogram as thist
from opentsdb_tpu_torch.ops import histogram_kernels as tkern
from opentsdb_tpu_torch.query.model import BadRequestError, TSQuery
from opentsdb_tpu_torch.query.model import parse_uri_subquery as tparse_uri
from opentsdb_tpu_torch.tsd.http_api import HttpRpcRouter
from opentsdb_tpu_torch.tsd.telnet import TelnetRouter

HM = "lat.hist"
BOUNDS = [float(b) for b in np.logspace(0, 3, 9)]


def bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.int64)


def blob(counts, bounds=BOUNDS, under=0, over=0) -> bytes:
    h = jhist.SimpleHistogram(bounds)
    h.counts = [int(c) for c in counts]
    h.underflow, h.overflow = int(under), int(over)
    return jhist.SimpleHistogramCodec().encode(h)


def positions(merged: np.ndarray, qs) -> np.ndarray:
    """[Q, S] True where the reference's float32 target rank and the
    float64 one count a different number of cumulative counts below
    them (the counts here are small: the cumulative counts are exact in
    both)."""
    cum = np.cumsum(merged, axis=1)
    tot = merged.sum(axis=1)
    t64 = tot[None, :] * np.array([q / 100.0 for q in qs])[:, None]
    f32 = np.asarray(qs, dtype=np.float32) / np.float32(100.0)
    t32 = tot.astype(np.float32)[None, :] * f32[:, None]
    i64 = (cum[None] < t64[:, :, None]).sum(axis=2)
    i32 = (cum.astype(np.float32)[None] < t32[:, :, None]).sum(axis=2)
    return i64 != i32


# -- codec and arena -----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simple_histogram_equals_reference(seed):
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(1, 12))
    bounds = np.sort(rng.uniform(0, 100, nb + 1)).tolist()
    j, t = jhist.SimpleHistogram(bounds), thist.SimpleHistogram(bounds)
    for v in rng.uniform(-10, 120, 200).tolist():
        c = int(rng.integers(1, 4))
        j.add(v, c)
        t.add(v, c)
    for h in (j, t):
        h.set_bucket(bounds[-1], bounds[-1] + 5, 7)   # appended
        h.set_bucket(bounds[0] - 3, bounds[0] - 1, 2)  # prepended, gap
        h.set_bucket(h.bounds[2], h.bounds[3], 11)     # replaced
    with pytest.raises(ValueError) as je:
        j.set_bucket(bounds[0], bounds[-1], 1)
    with pytest.raises(ValueError) as te:
        t.set_bucket(bounds[0], bounds[-1], 1)
    assert str(te.value) == str(je.value)
    assert (t.bounds, t.counts, t.underflow, t.overflow) == \
        (j.bounds, j.counts, j.underflow, j.overflow)
    assert t.to_json() == j.to_json()
    assert t.total_count() == j.total_count()
    for q in [0, 0.1, 1, 25, 50, 75, 99, 99.9, 100] + \
            rng.uniform(0, 100, 20).tolist():
        assert bits(t.percentile(q)) == bits(j.percentile(q))
    for bad in (-1, 100.5):
        with pytest.raises(ValueError):
            t.percentile(bad)
    jc, tc = jhist.SimpleHistogramCodec(), thist.SimpleHistogramCodec()
    assert tc.encode(t) == jc.encode(j)
    assert tc.encode(t, include_id=False) == jc.encode(j, include_id=False)
    back = tc.decode(jc.encode(j))
    assert (back.bounds, back.counts, back.underflow, back.overflow) == \
        (list(j.bounds), j.counts, j.underflow, j.overflow)
    # merge: bucket-wise sums, under/overflow added; other bounds refused
    j2, t2 = jc.decode(jc.encode(j)), tc.decode(tc.encode(t))
    j.merge(j2)
    t.merge(t2)
    assert (t.counts, t.underflow, t.overflow) == \
        (j.counts, j.underflow, j.overflow)
    assert tc.encode(t) == jc.encode(j)
    with pytest.raises(ValueError, match="different buckets"):
        t.merge(thist.SimpleHistogram([0.0, 1.0]))
    empty = thist.SimpleHistogram()
    empty.merge(t)
    assert empty.counts == t.counts and empty.percentile(50) == \
        t.percentile(50)
    with pytest.raises(ValueError, match="no buckets"):
        thist.SimpleHistogram().add(1.0)


def test_codec_manager_errors_equal_reference():
    jm, tm = jhist.HistogramCodecManager(), thist.HistogramCodecManager()
    good = blob(range(8))
    for data in (b"", b"\x07abc", good[:20], b"\x01"):
        with pytest.raises(Exception) as je:
            jm.decode(data)
        with pytest.raises(Exception) as te:
            tm.decode(data)
        assert (type(te.value), str(te.value)) == \
            (type(je.value), str(je.value))
    assert tm.encode(tm.decode(good)) == good
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        thist.HistogramCodecManager(Config(**{
            "tsd.core.histograms.config": '{"x.Codec": 2}'}))


@pytest.mark.parametrize("case", ["uniform", "lengths", "bounds", "codec",
                                  "big-counter", "one-bound", "not-bytes"])
def test_batch_of_odd_blobs_lands_as_reference(case):
    """One ``add_histogram_batch`` of blobs of one shape but one (a
    longer blob, other bounds, an unknown codec, a counter past int64,
    a single bound, a str): the port decodes point by point as the
    reference does, with the same errors and the same arena rows."""
    rng = np.random.default_rng(4)
    blobs = [blob(rng.integers(0, 2**40, 8), under=int(rng.integers(0, 9)),
                  over=int(rng.integers(0, 9))) for _ in range(13)]
    if case == "lengths":
        blobs[5] = blobs[5] + b"\x00"
    elif case == "bounds":
        blobs[7] = blob(range(8), bounds=[b + 1 for b in BOUNDS])
    elif case == "codec":
        blobs[3] = b"\x02" + blobs[3][1:]
    elif case == "big-counter":
        blobs[2] = blob(range(8), over=2**63)
    elif case == "one-bound":
        blobs = [blob([], bounds=[1.0])] * 3
    elif case == "not-bytes":
        blobs[1] = "text"
    points = [(HM, T0 + i, b, {"host": f"h{i:03d}"})
              for i, b in enumerate(blobs)]
    jt, tt = jtsdb(), ttsdb()
    if case in ("big-counter", "one-bound"):
        # blobs that decode but do not fit an arena row: the batch
        # raises in both; the reference keeps the groups it appended
        # before the failing one, the port appends none
        raised = []
        for t in (jt, tt):
            with pytest.raises((OverflowError, ValueError)) as e:
                t.add_histogram_batch(points)
            raised.append(type(e.value))
        assert raised[0] is raised[1]
        assert hist_state(tt) == {}
        return
    got = []
    for t in (jt, tt):
        errs = []
        try:
            out = t.add_histogram_batch(
                points, on_error=lambda i, e: errs.append((i, repr(e))))
        except Exception as e:  # noqa: BLE001 - compared below
            out = repr(e)
        got.append((out, errs))
    assert got[1] == got[0]
    assert hist_state(tt) == hist_state(jt)
    tt.shutdown()


def test_arena_growth_snapshot_and_counters_equal_reference():
    rng = np.random.default_rng(9)
    ja, ta = jhist.HistogramArena(), thist.HistogramArena()
    codec = jhist.SimpleHistogramCodec()
    snaps = []
    for i in range(2500):                 # past two growths of 1024
        b = BOUNDS if i % 7 else [0.0, 5.0, 10.0]
        nb = len(b) - 1
        h = codec.decode(blob(rng.integers(0, 50, nb), b,
                              int(rng.integers(0, 3)),
                              int(rng.integers(0, 3))))
        ja.append(T0 * 1000 + i, i % 37, h)
        ta.append(T0 * 1000 + i, i % 37, thist.SimpleHistogramCodec()
                  .decode(codec.encode(h)))
        if i in (10, 1023, 1024, 2000):
            sub = ta.groups[tuple(BOUNDS)]
            snaps.append([a.copy() for a in sub.snapshot()]
                         + list(sub.snapshot()))
    assert ta.total_points == ja.total_points == 2500
    assert ta.groups.keys() == ja.groups.keys()
    for key in ja.groups:
        js, ts_ = ja.groups[key], ta.groups[key]
        for a, b in zip(js.snapshot(), ts_.snapshot()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ts_.under[:ts_.n], js.under[:js.n])
        np.testing.assert_array_equal(ts_.over[:ts_.n], js.over[:js.n])
    # a snapshot taken before later appends and growths stays as it was
    for snap in snaps:
        for copy, view in zip(snap[:3], snap[3:]):
            np.testing.assert_array_equal(copy, view)


# -- ops: bit for bit against float64, the recorded kind against float32 -----

SHAPES = [  # (rows, buckets, segments, percentiles)
    (1, 1, 1, 1), (7, 3, 4, 5), (101, 64, 10, 5), (33, 3, 50, 1),
    (255, 64, 3, 5), (9, 1, 12, 5)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_merge_and_percentiles_bit_equal_float64(seed, shape):
    n, nb, nseg, nq = shape
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 50, (n, nb)).astype(np.float64)
    counts[rng.random(n) < 0.2] = 0.0           # empty histograms
    seg = rng.integers(0, nseg, n)
    seg[seg == nseg - 1] = 0                    # the last segment empty
    bounds = np.cumsum(rng.uniform(0.5, 3.0, nb + 1))
    qs = [0.0, 99.9, 50.0, 100.0, 12.5][:nq]
    merged = np.zeros((nseg, nb))
    np.add.at(merged, seg, counts)
    want = jengine.percentiles_from_counts(merged, bounds, qs)

    got_merged = tkern.merge_histograms(torch.from_numpy(counts),
                                        torch.from_numpy(seg), nseg)
    np.testing.assert_array_equal(bits(got_merged.numpy()), bits(merged))
    got = tkern.percentiles_from_merged(
        got_merged, torch.from_numpy(tkern.bucket_mids(bounds)), qs).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))
    piped = tkern.histogram_percentile_pipeline(counts, seg, nseg, bounds,
                                                qs, device="cpu")
    np.testing.assert_array_equal(bits(piped), bits(want))
    # the reference's device pipeline: float32 mids, float32 targets
    jax_out = jkern.histogram_percentile_pipeline(
        counts, seg.astype(np.int32), nseg, bounds, qs)
    p = positions(merged, qs)
    np.testing.assert_array_equal(jax_out[~p], got[~p].astype(np.float32))
    assert (jax_out[p] != got[p].astype(np.float32)).all()


def test_pinned_float32_divergence():
    """ROADMAP Queue 3: one segment of 1,000,999 points, counts [999998,
    1001, 0], p99.9. The float64 target is 999998.001, past the first
    bucket's cumulative count, so the answer is bucket 1 (1.5); the
    float32 target rounds to 999998.0, which the first bucket reaches,
    so the reference's device path answers bucket 0 (0.5)."""
    counts = np.array([[999998.0, 1001.0, 0.0]])
    bounds = np.array([0.0, 1.0, 2.0, 3.0])
    assert positions(counts, [99.9]).tolist() == [[True]]
    want = jengine.percentiles_from_counts(counts, bounds, [99.9])
    got = tkern.histogram_percentile_pipeline(counts, [0], 1, bounds,
                                              [99.9], device="cpu")
    jax_out = jkern.histogram_percentile_pipeline(
        counts, np.zeros(1, np.int32), 1, bounds, [99.9])
    assert want.tolist() == got.tolist() == [[1.5]]
    assert jax_out.tolist() == [[0.5]]


# -- engine parity -------------------------------------------------------------

KEYS = {"tsd.core.auto_create_metrics": "true", **ENGINE_KEYS}


def jtsdb(**extra) -> JTSDB:
    return JTSDB(JConfig(**{"tsd.tpu.platform": "cpu", **KEYS, **extra}))


def ttsdb(**extra) -> TSDB:
    return TSDB(Config(**{"tsd.torch.device": "cpu", **KEYS, **extra}))


def seeded_points(seed: int, n_series: int = 24, steps: int = 12):
    """(metric, ts, blob, tags) of ``n_series`` series a minute apart,
    counts 0-49 over 8 buckets and a few under/overflow counts; tags
    ``host``, ``dc`` (3 values), ``rack`` (5)."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(steps):
        for i in range(n_series):
            if rng.random() < 0.05:
                continue                      # a missing point
            out.append((HM, T0 + 60 * j,
                        blob(rng.integers(0, 50, 8),
                             under=int(rng.integers(0, 3)),
                             over=int(rng.integers(0, 3))),
                        {"host": f"h{i:03d}", "dc": f"dc{i % 3}",
                         "rack": f"r{i % 5}"}))
    return out


BAD_POINTS = [
    (HM, T0, b"", {"host": "h000", "dc": "dc0", "rack": "r0"}),
    (HM, -5, blob(range(8)), {"host": "h001", "dc": "dc1", "rack": "r1"}),
    (HM, T0, b"\x09xx", {"host": "hnew", "dc": "dc9", "rack": "r9"}),
    ("bad!", T0, blob(range(8)), {"host": "h000"}),
    (HM, T0, blob(range(8)), {}),
]


def write_both(jt, tt, points):
    """The first points one by one, the rest (with the bad ones mixed
    in) in two batches; both packages must report the same errors."""
    k = len(points) // 4
    for metric, ts, b, tags in points[:k]:
        assert tt.add_histogram_point(metric, ts, b, tags) == \
            jt.add_histogram_point(metric, ts, b, tags)
    rest = points[k:]
    mid = len(rest) // 2
    for batch in (rest[:mid] + BAD_POINTS[:3], BAD_POINTS[3:] + rest[mid:]):
        jerr, terr = [], []
        jn, jmsg = jt.add_histogram_batch(
            batch, on_error=lambda i, e: jerr.append((i, str(e))))
        tn, tmsg = tt.add_histogram_batch(
            batch, on_error=lambda i, e: terr.append((i, str(e))))
        assert (tn, tmsg, terr) == (jn, jmsg, jerr)


class F64Reference:
    """Replaces the reference's device pipeline (as the reference's
    engine imports it at call time) with a spy: it runs the real float32
    pipeline and a float64 one (numpy merge and the reference's own
    ``percentiles_from_counts``), checks that they differ only at
    :func:`positions`, counts those positions, and answers with the
    float64 result (``use64``) or the float32 one."""

    def __init__(self, monkeypatch):
        self.real = jkern.histogram_percentile_pipeline
        self.use64 = True
        self.diverged = 0
        monkeypatch.setattr(jkern, "histogram_percentile_pipeline",
                            self.run)

    def run(self, counts, seg_ids, num_segments, bounds, qs):
        counts = np.asarray(counts, dtype=np.float64)[:len(seg_ids)]
        out32 = self.real(counts, seg_ids, num_segments, bounds, qs)
        merged = np.zeros((num_segments, counts.shape[1]))
        np.add.at(merged, np.asarray(seg_ids), counts)
        out64 = jengine.percentiles_from_counts(
            merged, np.asarray(bounds, dtype=np.float64), qs)
        p = positions(merged, qs)
        np.testing.assert_array_equal(out32[~p],
                                      out64[~p].astype(np.float32))
        present = np.bincount(seg_ids, minlength=num_segments) > 0
        self.diverged += int((p & present[None, :]).sum())
        return out64 if self.use64 else out32


def rows(results):
    return [(r.metric, r.tags, sorted(r.aggregated_tags),
             [t for t, _ in r.dps], [v for _, v in r.dps]) for r in results]


def query(q: dict, start=T0, end=T0 + 3600, **extra) -> dict:
    return {"start": str(start), "end": str(end), "queries": [q], **extra}


def run_both(jt, tt, q: dict, ref: F64Reference):
    """The port's rows equal the float64 reference's bit for bit, and
    the float32 reference's but at the counted positions."""
    got = rows(tt.execute_query(TSQuery.from_json(q).validate()))
    ref.use64, ref.diverged = True, 0
    want = rows(jt.execute_query(JQuery.from_json(q).validate()))
    assert [g[:4] for g in got] == [w[:4] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g[4]), bits(w[4]))
    ref.use64, ref.diverged = False, 0
    want32 = rows(jt.execute_query(JQuery.from_json(q).validate()))
    differ = sum(int((np.float32(g[4]) != np.float32(w[4])).sum())
                 for g, w in zip(got, want32))
    assert differ == ref.diverged
    return got


@pytest.fixture
def ref64(monkeypatch):
    return F64Reference(monkeypatch)


@pytest.fixture(scope="module")
def pair():
    jt, tt = jtsdb(), ttsdb()
    write_both(jt, tt, seeded_points(0))
    yield jt, tt
    tt.shutdown()


PCT = [50.0, 99.0, 99.9]
ENGINE_QUERIES = {
    "no-group": query({"aggregator": "sum", "metric": HM,
                       "percentiles": PCT}),
    "group-by": query({"aggregator": "sum", "metric": HM,
                       "percentiles": [99.0, 25.0],
                       "filters": [{"type": "wildcard", "tagk": "dc",
                                    "filter": "*", "groupBy": True}]}),
    "filtered": query({"aggregator": "sum", "metric": HM,
                       "percentiles": PCT,
                       "filters": [{"type": "literal_or", "tagk": "host",
                                    "filter": "h001|h002|h007",
                                    "groupBy": False},
                                   {"type": "wildcard", "tagk": "rack",
                                    "filter": "*", "groupBy": True}]}),
    "partial-window": query({"aggregator": "sum", "metric": HM,
                             "percentiles": [90.0]},
                            start=T0 + 150, end=T0 + 420),
    "downsample": query({"aggregator": "sum", "metric": HM,
                         "percentiles": PCT, "downsample": "5m-sum",
                         "filters": [{"type": "wildcard", "tagk": "dc",
                                      "filter": "*", "groupBy": True}]}),
    "ms": query({"aggregator": "sum", "metric": HM, "percentiles": [75.0],
                 "downsample": "2m-sum"}, msResolution=True),
    "unknown-groupby-key": query({"aggregator": "sum", "metric": HM,
                                  "percentiles": [50.0],
                                  "filters": [{"type": "wildcard",
                                               "tagk": "nokey",
                                               "filter": "*",
                                               "groupBy": True}]}),
    "empty-window": query({"aggregator": "sum", "metric": HM,
                           "percentiles": [50.0]},
                          start=T0 + 7200, end=T0 + 9000),
}


@pytest.mark.parametrize("name", sorted(ENGINE_QUERIES))
def test_engine_equals_reference(pair, ref64, name):
    got = run_both(*pair, ENGINE_QUERIES[name], ref64)
    if name in ("empty-window", "unknown-groupby-key"):
        assert got == []
    else:
        assert got and all(r[0].startswith(f"{HM}_pct_") for r in got)


def test_engine_unknown_metric_raises_as_reference(pair, ref64):
    jt, tt = pair
    q = query({"aggregator": "sum", "metric": "no.such",
               "percentiles": [50.0]})
    with pytest.raises(BadRequestError) as te:
        tt.execute_query(TSQuery.from_json(q).validate())
    with pytest.raises(ValueError) as je:
        jt.execute_query(JQuery.from_json(q).validate())
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("sketch", ["true", "false"])
def test_metric_with_scalar_and_histogram_series(ref64, sketch):
    """A metric with scalar and histogram series: the percentile rows
    come from the arenas alone, as the reference's (its sketch path
    folds no scalar point of a histogram metric), sketches on or
    off."""
    jt, tt = jtsdb(**{"tsd.sketch.enable": sketch}), \
        ttsdb(**{"tsd.sketch.enable": sketch})
    pts = seeded_points(8, 6, 4)
    for t in (jt, tt):
        t.add_histogram_batch(pts)
        for i in range(6):
            t.add_point(HM, T0 + 30 * i, 10.0 * i, {"host": f"h{i:03d}"})
    got = run_both(jt, tt, query({"aggregator": "sum", "metric": HM,
                                  "percentiles": PCT,
                                  "downsample": "2m-sum"}), ref64)
    assert got and {g[0] for g in got} == {f"{HM}_pct_{q:g}" for q in PCT}
    tt.shutdown()


def test_mixed_bounds_host_path_and_clash(ref64):
    """A window whose histograms have two bounds classes takes the host
    merge in both packages; two classes at one output timestamp of one
    group is a 400 naming it."""
    jt, tt = jtsdb(), ttsdb()
    rng = np.random.default_rng(5)
    other = [0.0, 10.0, 100.0, 1000.0]
    points = []
    for j in range(6):
        for i in range(5):
            b = BOUNDS if j < 3 else other
            points.append(("mx", T0 + 60 * j,
                           blob(rng.integers(0, 30, len(b) - 1), b),
                           {"host": f"h{i}", "dc": f"dc{i % 2}"}))
    write_both(jt, tt, points)
    for q in (query({"aggregator": "sum", "metric": "mx",
                     "percentiles": PCT}),
              query({"aggregator": "sum", "metric": "mx",
                     "percentiles": [50.0], "downsample": "3m-sum",
                     "filters": [{"type": "wildcard", "tagk": "dc",
                                  "filter": "*", "groupBy": True}]})):
        # the host path is float64 in both packages
        got = rows(tt.execute_query(TSQuery.from_json(q).validate()))
        want = rows(jt.execute_query(JQuery.from_json(q).validate()))
        assert got and [g[:4] for g in got] == [w[:4] for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(bits(g[4]), bits(w[4]))
    clash = query({"aggregator": "sum", "metric": "mx",
                   "percentiles": [50.0], "downsample": "6m-sum"})
    with pytest.raises(BadRequestError) as te:
        tt.execute_query(TSQuery.from_json(clash).validate())
    with pytest.raises(ValueError) as je:
        jt.execute_query(JQuery.from_json(clash).validate())
    assert str(te.value) == str(je.value)
    assert "different buckets at timestamp" in str(te.value)


def test_device_cache_hits_equal_cold_and_see_writes():
    """At the default keys the collected counts stay in the device
    cache: warm calls give the cold call's bits, and a write moves the
    histogram version, so the next call reads it."""
    t = TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.core.auto_create_metrics": "true",
                       "tsd.query.cache.enable": "false"}))
    for metric, ts, b, tags in seeded_points(1, 12, 4):
        t.add_histogram_point(metric, ts, b, tags)
    q = TSQuery.from_json(ENGINE_QUERIES["group-by"]).validate()
    cold = rows(t.execute_query(q))
    cache = t.device_grid_cache
    hits = cache.hits
    for _ in range(2):
        warm = rows(t.execute_query(q))
        assert warm == cold and [bits(w[4]).tolist() for w in warm] == \
            [bits(c[4]).tolist() for c in cold]
    assert cache.hits == hits + 2
    entry = next(iter(cache._entries.values()))
    assert entry[1][0].dtype == torch.float64
    t.add_histogram_point(HM, T0 + 30, blob([10**6] + [0] * 7),
                          {"host": "h000", "dc": "dc0", "rack": "r0"})
    after = rows(t.execute_query(q))
    assert after != cold
    t.shutdown()


@pytest.mark.parametrize("how", ["point", "batch", "scalar"])
def test_result_cache_sees_writes(how):
    """At the default keys (the result cache on) a percentile answer in
    the cache does not outlive a histogram write, nor a scalar write
    under the sketch path."""
    t = TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.core.auto_create_metrics": "true"}))
    assert t.result_cache is not None
    tags = {"host": "h000", "dc": "dc0", "rack": "r0"}
    if how == "scalar":
        t.add_points("sc", T0 + 60 * np.arange(10), np.arange(10.0), tags)
        metric = "sc"
    else:
        for metric_, ts, b, tg in seeded_points(2, 6, 3):
            t.add_histogram_point(metric_, ts, b, tg)
        metric = HM
    q = query({"aggregator": "sum", "metric": metric,
               "percentiles": [50.0, 99.0]})
    first = rows(t.execute_query(TSQuery.from_json(q).validate()))
    again = rows(t.execute_query(TSQuery.from_json(q).validate()))
    assert again == first
    if how == "point":
        t.add_histogram_point(HM, T0 + 1, blob([0] * 7 + [10**6]), tags)
    elif how == "batch":
        t.add_histogram_batch([(HM, T0 + 1, blob([0] * 7 + [10**6]),
                                tags)])
    else:
        t.add_point("sc", T0 + 1, 10**6, tags)
    after = rows(t.execute_query(TSQuery.from_json(q).validate()))
    assert after != first
    t.shutdown()


# -- the URI form, /api/histogram and telnet histogram -------------------------

@pytest.mark.parametrize("spec", [
    "sum:percentile[99, 99.9]:lat.hist",
    "sum:1m-sum:percentiles[50,75]:lat.hist{dc=*}",
    "sum:PERCENTILE[ 90 ]:lat.hist{host=h1|h2}",
    "sum:percentile[]:lat.hist",
    "sum:percentile[9x]:lat.hist",
    "sum:percentile99:lat.hist"])
def test_uri_percentile_section_parses_as_reference(spec):
    try:
        want = jparse_uri(spec)
    except ValueError as e:
        with pytest.raises(BadRequestError) as te:
            tparse_uri(spec)
        assert type(e).__name__ == "BadRequestError"
        assert str(te.value) == str(e)
        return
    got = tparse_uri(spec)
    assert got.percentiles == want.percentiles
    assert (got.metric, got.downsample, got.aggregator) == \
        (want.metric, want.downsample, want.aggregator)
    assert [(f.filter_name, f.tagk, f.filter_expr, f.group_by)
            for f in got.filters] == \
        [(f.filter_name, f.tagk, f.filter_expr, f.group_by)
         for f in want.filters]


def _hist_dps(points):
    return [{"metric": m, "timestamp": ts,
             "value": base64.b64encode(b).decode(), "tags": tags}
            for m, ts, b, tags in points]


PUT_BODIES = {
    "good": _hist_dps(seeded_points(3, 6, 2)),
    "bad-blob": _hist_dps(seeded_points(3, 2, 1))
    + [{"metric": HM, "timestamp": T0, "value": "!!notbase64",
        "tags": {"host": "x"}},
       {"metric": HM, "timestamp": T0, "value": base64.b64encode(
           b"\x05zz").decode(), "tags": {"host": "y"}},
       {"metric": HM, "timestamp": T0, "tags": {"host": "z"}},
       {"metric": HM, "timestamp": "soon", "value": "AA==",
        "tags": {"host": "z"}}],
    "one": _hist_dps(seeded_points(3, 1, 1))[0],
}


@pytest.mark.parametrize("flags", ["", "details", "summary"])
@pytest.mark.parametrize("body", sorted(PUT_BODIES))
def test_api_histogram_answers_as_reference(ref64, body, flags):
    from test_torch_http import compare, send_both
    jt, tt = jtsdb(), ttsdb()
    params = {flags: "true"} if flags else {}
    jr, pr = JRouter(jt), HttpRpcRouter(tt)
    got, want = send_both(jr, pr, "POST", "/api/histogram",
                          PUT_BODIES[body], **params)
    compare("bytes", got, want, {})
    # what landed reads back alike
    q = query({"aggregator": "sum", "metric": HM,
               "percentiles": [50.0, 99.0],
               "filters": [{"type": "wildcard", "tagk": "host",
                            "filter": "*", "groupBy": True}]})
    run_both(jt, tt, q, ref64)
    tt.shutdown()


def test_api_histogram_method_and_mode():
    from test_torch_http import compare, send_both
    jt, tt = jtsdb(), ttsdb()
    got, want = send_both(JRouter(jt), HttpRpcRouter(tt), "GET",
                          "/api/histogram")
    compare("bytes", got, want, {})
    ro = TSDB(Config(**{"tsd.torch.device": "cpu", "tsd.mode": "ro"}))
    jro = JTSDB(JConfig(**{"tsd.tpu.platform": "cpu", "tsd.mode": "ro"}))
    got, want = send_both(JRouter(jro), HttpRpcRouter(ro), "POST",
                          "/api/histogram", PUT_BODIES["one"])
    compare("bytes", got, want, {})
    assert got.status == 404


def test_telnet_histogram_answers_as_reference(ref64):
    jt, tt = jtsdb(), ttsdb()
    lines = [f"histogram {m} {ts} {base64.b64encode(b).decode()} "
             + " ".join(f"{k}={v}" for k, v in tags.items())
             for m, ts, b, tags in seeded_points(6, 5, 3)]
    lines += ["histogram", f"histogram {HM} {T0} AA== host",
              f"histogram {HM} {T0} !!! host=a",
              f"histogram {HM} abc AA== host=a",
              f"histogram {HM} {T0} {base64.b64encode(b'').decode()}x "
              "host=a",
              f"histogram bad! {T0} "
              f"{base64.b64encode(blob(range(8))).decode()} host=a"]
    jr, pr = JTelnet(jt), TelnetRouter(tt)
    for line in lines:
        assert pr.execute(line) == jr.execute(line), line
    got, gexc = pr.execute_lines(lines[:4])
    want, wexc = jr.execute_lines(lines[:4])
    assert got == want and gexc is None and wexc is None
    run_both(jt, tt, query({"aggregator": "sum", "metric": HM,
                            "percentiles": PCT}), ref64)
    assert "histogram" in pr.execute("help")
    tt.shutdown()


# -- durability ------------------------------------------------------------------

def _durable_pair(tmp_path, name: str):
    from test_torch_wal import jtsdb as jdur, ptsdb as pdur
    return (jdur(tmp_path / "j" / name), pdur(tmp_path / "p" / name))


def write_durable(t, seed: int) -> None:
    """Histogram and scalar writes through every histogram write path:
    points one by one (new UIDs among them), a batch with bad points, a
    second bounds class."""
    pts = seeded_points(seed, 5, 3)
    for metric, ts, b, tags in pts[:4]:
        t.add_histogram_point(metric, ts, b, tags)
    t.add_point("w.a", T0, 1, {"host": "h000"})
    t.add_histogram_batch(pts[4:] + BAD_POINTS)
    t.add_histogram_point("other.hist", (T0 + 5) * 1000 + 250,
                          blob([1, 2, 3], [0.0, 1.0, 2.0, 3.0], 4, 5),
                          {"host": "h000"})


def hist_state(t) -> dict:
    """Every histogram point keyed by metric name, tag names and ms
    timestamp: (bounds, counts bits, under, over)."""
    out = {}
    for mid, arena in t._histogram_arenas.items():
        metric = t.uids.metrics.get_name(mid)
        for key, sub in arena.groups.items():
            ts, sid, rows_ = sub.snapshot()
            for i in range(sub.n):
                rec = t.histogram_store.series(int(sid[i]))
                names = tuple(sorted((t.uids.tag_names.get_name(k),
                                      t.uids.tag_values.get_name(v))
                                     for k, v in rec.tags))
                out.setdefault((metric, names, int(ts[i])), []).append(
                    (key, bits(rows_[i]).tolist(), int(sub.under[i]),
                     int(sub.over[i])))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_wal_histogram_bytes_equal_reference(tmp_path, seed):
    from test_torch_wal import segments
    j, p = _durable_pair(tmp_path, "d")
    write_durable(j, seed)
    write_durable(p, seed)
    js, ps = segments(tmp_path / "j" / "d"), segments(tmp_path / "p" / "d")
    assert len(js) == len(ps) >= 1
    for a, b in zip(js, ps):
        assert a.read_bytes() == b.read_bytes()
    j.wal.close()
    p.wal.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_histogram_log_cross_replays(tmp_path, writer):
    from test_torch_wal import jtsdb as jdur, ptsdb as pdur
    make_w, make_r = (jdur, pdur) if writer == "jax" else (pdur, jdur)
    w = make_w(tmp_path / "w")
    write_durable(w, 3)
    want = hist_state(w)
    w.wal.close()
    r = make_r(tmp_path / "w")
    assert hist_state(r) == want and want
    r.wal.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_histograms_json_bytes_equal_reference(tmp_path, seed):
    j, p = _durable_pair(tmp_path, "d")
    for t in (j, p):
        write_durable(t, seed)
        t.flush()
    want = (tmp_path / "j" / "d" / "histograms.json").read_bytes()
    assert (tmp_path / "p" / "d" / "histograms.json").read_bytes() == want
    assert json.loads(want)["v"] == 2 and json.loads(want)["arenas"]
    j.wal.close()
    p.wal.close()


@pytest.mark.parametrize("fmt", ["v2", "v1"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_histograms_cross_load(tmp_path, writer, fmt):
    """Each package loads the other's ``histograms.json`` (flushed, the
    WAL gone): the v2 columns, and the v1 list of one blob per point."""
    from test_torch_wal import jtsdb as jdur, ptsdb as pdur
    make_w, make_r = (jdur, pdur) if writer == "jax" else (pdur, jdur)
    d = tmp_path / "d"
    w = make_w(d)
    write_durable(w, 4)
    want = hist_state(w)
    w.shutdown()
    if fmt == "v1":
        codec = jhist.SimpleHistogramCodec()
        doc = []
        for mid, arena in w._histogram_arenas.items():
            for key, sub in arena.groups.items():
                ts, sid, rows_ = sub.snapshot()
                for i in range(sub.n):
                    rec = w.histogram_store.series(int(sid[i]))
                    h = jhist.SimpleHistogram(key)
                    h.counts = [int(c) for c in rows_[i]]
                    h.underflow, h.overflow = int(sub.under[i]), \
                        int(sub.over[i])
                    doc.append({"metric": mid,
                                "tags": [list(x) for x in rec.tags],
                                "points": [[int(ts[i]), base64.b64encode(
                                    codec.encode(h)).decode()]]})
        (d / "histograms.json").write_text(json.dumps(doc))
    r = make_r(d)
    assert hist_state(r) == want and want
    r.shutdown()


@pytest.mark.parametrize("how", ["batch", "point", "scope"])
def test_flush_during_histogram_write_counts_once(tmp_path, monkeypatch,
                                                  how):
    """A flush that starts while a histogram write sits between its
    arena append and its WAL record, then a crash (the WAL closed, no
    later flush): the reopened TSDB holds each point once. The flush
    waits for the write, so the snapshot's WAL sequence covers every
    point the snapshot holds; replaying one over it would add its
    counts twice. ``scope`` writes inside a request's WAL batch
    scope."""
    from test_torch_wal import ptsdb as pdur
    d = tmp_path / "d"
    t = pdur(d)
    pts = seeded_points(0, 3, 2)
    t.add_histogram_batch(pts[:3])
    rest = pts[3:]
    arrived, flushed = threading.Event(), threading.Event()
    log = t.wal.log_histogram

    def slow_log(*a):
        arrived.set()
        flushed.wait(0.5)       # a flush that does not wait lands here
        log(*a)

    monkeypatch.setattr(t.wal, "log_histogram", slow_log)

    def write():
        if how == "batch":
            t.add_histogram_batch(rest)
        elif how == "point":
            for p in rest:
                t.add_histogram_point(*p)
        else:
            # a request's scope, left after the flush had its chance
            with t._wal_scope():
                t.add_point("w.a", T0, 1, {"host": "a"})
                t.add_histogram_batch(rest)
                flushed.wait(0.5)

    writer = threading.Thread(target=write)
    writer.start()
    assert arrived.wait(10)
    flusher = threading.Thread(target=lambda: (t.flush(), flushed.set()))
    flusher.start()
    writer.join()
    flusher.join()
    want = hist_state(t)
    assert sum(len(v) for v in want.values()) == len(pts)
    t.wal.close()
    r = pdur(d)
    assert hist_state(r) == want
    r.shutdown()


def test_query_path_leaves_out_under_and_overflow(ref64):
    """ROADMAP Queue 3 item 7, recorded as the reference has it: one
    point whose underflow holds most of its count. ``SimpleHistogram``'s
    own p50 is the bottom bound; both packages' query paths rank over
    the buckets alone and answer a bucket's midpoint."""
    jt, tt = jtsdb(), ttsdb()
    b = blob([1, 2, 3, 4, 0, 0, 0, 0], under=1000, over=5)
    tags = {"host": "h000"}
    assert thist.HistogramCodecManager().decode(b).percentile(50) == \
        jhist.HistogramCodecManager().decode(b).percentile(50) == BOUNDS[0]
    jt.add_histogram_point(HM, T0, b, tags)
    tt.add_histogram_point(HM, T0, b, tags)
    got = run_both(jt, tt, query({"aggregator": "sum", "metric": HM,
                                  "percentiles": [50.0]}), ref64)
    mids = tkern.bucket_mids(BOUNDS)
    assert bits(got[0][4]).tolist() == bits([mids[2]]).tolist()
    tt.shutdown()
