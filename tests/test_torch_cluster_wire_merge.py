"""The port's binary cluster wire and partial merge against the JAX
package's (``opentsdb_tpu_torch/cluster/{wire,merge}.py``):

- the codec byte for byte: frames, status, query and continuous-query
  payloads, write batches (the reference's cases and seeded batches),
  their decodes, the strictness errors, torn payloads, the int-emission
  mask and the streamed partial grids (``qres_frames``, sketches
  included) with their decode;
- ``decompose_plan`` over every aggregator of both registries;
- ``StreamMerger`` over the same seeded legs (sum, count, min, max, the
  avg twins, ``none``, a percentile aggregator's sketch fold and sketch
  partials): the same groups, tags and timestamps, and the same value
  bits, since both fold the legs in the same order.
"""

from __future__ import annotations

import base64
import json

import numpy as np
import pytest

from torch_cluster_pair import BASE_MS, JAX, PORT, SIDES

from opentsdb_tpu.meta.annotation import Annotation as JAnnotation
from opentsdb_tpu.sketch.ddsketch import DDSketch as JSketch
from opentsdb_tpu_torch.meta.annotation import Annotation as TAnnotation


def _both(fn):
    """``fn(side)`` on both packages; the outcome or the error's type
    name and text."""
    out = []
    for side in SIDES:
        try:
            out.append(("ok", fn(side)))
        except Exception as e:  # noqa: BLE001 - compared across sides
            out.append((type(e).__name__, str(e)))
    return out


def test_frames_status_and_query_payloads():
    rng = np.random.default_rng(3)
    for n in (0, 1, 17, 4096):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for ftype in (1, 3, 6, 9):
            a, b = (side.wire._frame(ftype, int(n) * 7 + 1, payload)
                    for side in SIDES)
            assert a == b
    for status, body in ((200, b""), (400, b'{"error":{}}'),
                         (65535, b"x" * 300)):
        a, b = (side.wire.encode_status(status, body) for side in SIDES)
        assert a == b
        assert PORT.wire.decode_status(a) == JAX.wire.decode_status(a)
    for trace in ("", "t1:s2:1", "x" * 70000):
        a, b = (side.wire.encode_query(trace, b'{"q":1}') for side in SIDES)
        assert a == b
        assert PORT.wire.decode_query(a) == JAX.wire.decode_query(a)
        a, b = (side.wire.encode_cq(trace, "POST",
                                    "/api/query/continuous", b"{}")
                for side in SIDES)
        assert a == b
        assert PORT.wire.decode_cq(a) == JAX.wire.decode_cq(a)
    assert _both(lambda s: s.wire.encode_cq("", "GET", "/" * 70000, b""))[
        0][0] == "WireEncodeError"
    assert len({r for r in _both(lambda s: s.wire.decode_cq(b"\x05"))}) \
        == 1


REF_BATCH = [
    {"metric": "w.m", "timestamp": 1356998400, "value": 7,
     "tags": {"host": "a", "dc": "x"}},
    {"metric": "w.m", "timestamp": 1356998401, "value": 2.5,
     "tags": {"dc": "x", "host": "a"}},
    {"metric": "w.m", "timestamp": 1356998400, "value": -(2 ** 52),
     "tags": {"host": "b"}},
    {"metric": "w.other", "timestamp": -1356998400, "value": 0.25,
     "tags": None},
]


def _seeded_batch(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(1, 400))):
        v = float(rng.normal()) if rng.random() < 0.5 \
            else int(rng.integers(-10 ** 9, 10 ** 9))
        out.append({"metric": f"m{int(rng.integers(0, 3))}",
                    "timestamp": 1356998400 + int(rng.integers(0, 10 ** 6)),
                    "value": v,
                    "tags": {"host": f"h{int(rng.integers(0, 20))}",
                             "dc": f"dc{int(rng.integers(0, 4))}"}})
    return out


@pytest.mark.parametrize("batch", [REF_BATCH] + [_seeded_batch(s)
                                                 for s in range(4)],
                         ids=["reference"] + [f"seed{s}" for s in range(4)])
def test_write_batches_byte_for_byte(batch):
    a, b = (side.wire.encode_write(batch, trace="t-abc") for side in SIDES)
    assert a == b
    (ta, ga), (tb, gb) = (side.wire.decode_write(a) for side in SIDES)
    assert ta == tb == "t-abc"
    assert ga == gb
    for ga_, gb_ in zip(ga, gb):
        assert [type(v) for v in ga_[4]] == [type(v) for v in gb_[4]]


@pytest.mark.parametrize("bad", [
    {"metric": "m", "timestamp": 1, "value": True, "tags": {}},
    {"metric": "m", "timestamp": 1, "value": 1 << 53, "tags": {}},
    {"metric": "m", "timestamp": 1, "value": "7", "tags": {}},
    {"metric": "m", "timestamp": 1.0, "value": 1, "tags": {}},
    {"metric": "", "timestamp": 1, "value": 1, "tags": {}},
    {"metric": 7, "timestamp": 1, "value": 1, "tags": {}},
    {"metric": "m", "timestamp": 1, "value": 1, "tags": {"a": 1}},
    {"metric": "m", "timestamp": 1, "value": 1, "tags": {}, "extra": 1},
    ["not", "a", "dict"]])
def test_write_encoding_is_strict(bad):
    got = _both(lambda s: s.wire.encode_write([bad]))
    assert got[0] == got[1] and got[0][0] == "WireEncodeError"


def test_torn_payloads_are_refused():
    payload = JAX.wire.encode_write(
        [{"metric": "m", "timestamp": 1, "value": 1.5, "tags": {"h": "a"}}])
    for torn in (payload + b"X", payload[:-1]):
        got = _both(lambda s: s.wire.decode_write(torn))
        assert [g[0] for g in got] == ["WireProtocolError"] * 2
    got = _both(lambda s: s.wire.decode_qres(b"\x01\x00\x00\x00"))
    assert [g[0] for g in got] == ["WireProtocolError"] * 2


def test_integral_mask():
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        rng.normal(size=200) * 1e6, np.round(rng.normal(size=200) * 1e3),
        [np.nan, np.inf, -np.inf, 2.0 ** 53, -(2.0 ** 53) + 1, 0.0, -0.0,
         0.5, 1e300]])
    assert np.array_equal(PORT.wire._integral_mask(vals),
                          JAX.wire._integral_mask(vals))


class _Spec:
    no_annotations = False
    global_annotations = True


def _results(side, seed: int) -> list:
    """Seeded QueryResults of ``side``'s engine, with tsuids, notes and
    a sketch partial."""
    rng = np.random.default_rng(seed)
    Note = TAnnotation if side is PORT else JAnnotation
    out = []
    for g in range(int(rng.integers(1, 6))):
        n = int(rng.integers(0, 40))
        ts = BASE_MS + np.sort(rng.choice(10 ** 6, n, replace=False))
        vals = np.where(rng.random(n) < 0.5, np.round(rng.normal(size=n) * 9),
                        rng.normal(size=n))
        vals[rng.random(n) < 0.1] = np.nan
        kw = dict(metric="q.m", tags={"host": f"h{g}"},
                  aggregated_tags=["dc"] if g % 2 else [],
                  tsuids=[f"{g:06X}"] if g == 1 else None,
                  sub_query_index=2,
                  annotations=[Note(tsuid="", start_time=BASE_MS // 1000,
                                    description="d")] if g == 0 else None,
                  global_annotations=[Note(start_time=BASE_MS // 1000 + 5,
                                           description="g")]
                  if g == 2 else None,
                  dps_arrays=(ts.astype(np.int64), vals.astype(np.float64)))
        r = side.engine.QueryResult(**kw)
        if g == 3:
            r.sketches = [(int(BASE_MS), b"\x01\x02\x03"),
                          (int(BASE_MS) + 10, b"")]
        out.append(r)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_partial_grid_frames_byte_for_byte(seed):
    frames = [side.wire.qres_frames(9, 2, _results(side, seed), _Spec(),
                                    chunk_bytes=512)
              for side in SIDES]
    assert frames[0] == frames[1] and frames[0]
    for fr in frames[0]:
        payload = fr[JAX.wire._HDR.size:]
        (sa, ra), (sb, rb) = (side.wire.decode_qres(payload)
                              for side in SIDES)
        assert sa == sb == 2
        # repr: NaN values compare by their spelling
        assert repr([{**r, "dps": list(r["dps"])} for r in ra]) == \
            repr([{**r, "dps": list(r["dps"])} for r in rb])
    assert PORT.wire.qres_frames(9, 3, [], _Spec()) == []


# -- merge -------------------------------------------------------------------


def _sub(side, spec: dict):
    body = {"start": str(BASE_MS), "end": str(BASE_MS + 600_000),
            "queries": [dict({"metric": "c.m"}, **spec)]}
    return side.TSQuery.from_json(body).validate().queries[0]


def test_decompose_plan_over_every_aggregator():
    from opentsdb_tpu.ops import aggregators as jaggs
    from opentsdb_tpu_torch.ops import aggregators as taggs
    names = sorted(set(jaggs.names()) | set(taggs.names()))
    assert set(jaggs.names()) == set(taggs.names())
    for name in names:
        got = _both(lambda s: s.merge.decompose_plan(
            _sub(s, {"aggregator": name})))
        assert got[0] == got[1], name
    got = _both(lambda s: s.merge.decompose_plan(
        _sub(s, {"aggregator": "sum", "percentiles": [50.0, 99.0]})))
    assert got[0] == got[1] == ("ok", "sketch")
    for name in ("p95", "median", "ep95r7", "dev", "sum"):
        assert PORT.merge.sketch_agg_quantile(name) == \
            JAX.merge.sketch_agg_quantile(name)


MERGE_SUBS = [
    {"aggregator": "sum", "downsample": "10s-sum"},
    {"aggregator": "zimsum", "downsample": "10s-sum"},
    {"aggregator": "count", "downsample": "10s-count"},
    {"aggregator": "min", "downsample": "10s-min"},
    {"aggregator": "mimmax", "downsample": "10s-max"},
    {"aggregator": "avg", "downsample": "10s-avg"},
    {"aggregator": "none"},
    {"aggregator": "p95", "downsample": "10s-avg",
     "filters": [{"type": "wildcard", "tagk": "dc", "filter": "*",
                  "groupBy": True}]},
    {"aggregator": "sum", "downsample": "10s-avg",
     "percentiles": [50.0, 99.0]},
    {"aggregator": "sum", "downsample": "10s-sum",
     "filters": [{"type": "wildcard", "tagk": "dc", "filter": "*",
                  "groupBy": True}]},
]


def _legs(seed: int, plans: list[str], slots) -> list[list[dict]]:
    """Three shards' partial rows for every expanded sub, seeded: each
    shard reports some groups (a group may span shards), NaN gaps, int
    and float values, as an HTTP arrays body parses."""
    rng = np.random.default_rng(seed)
    legs = []
    for shard in range(3):
        rows = []
        for plan, (p_idx, s_idx) in zip(plans, slots):
            for idx in (p_idx, s_idx):
                if idx is None:
                    continue
                for g in range(int(rng.integers(0, 4))):
                    dc = f"dc{int(rng.integers(0, 3))}"
                    tags = {"dc": dc} if plan != "concat" else \
                        {"dc": dc, "host": f"h{shard}{g}"}
                    if rng.random() < 0.5:
                        tags["rack"] = f"r{shard}"
                    row = {"metric": "c.m", "tags": tags,
                           "aggregateTags": ["host"],
                           "query": {"index": idx}}
                    ts = [BASE_MS + 10_000 * k for k in range(10)
                          if rng.random() < 0.7]
                    if plan == "sketch":
                        blobs = []
                        for t in ts:
                            sk = JSketch(0.01)
                            for v in rng.normal(size=5) * 100:
                                sk.add(float(v))
                            blobs.append([t, sk.to_b64()])
                        row["dps"] = []
                        row["sketchDps"] = blobs
                    else:
                        dps = []
                        for t in ts:
                            v = float(rng.normal() * 50)
                            if rng.random() < 0.4:
                                v = int(round(v))
                            if rng.random() < 0.1:
                                v = float("nan")
                            dps.append([t, v])
                        row["dps"] = dps
                    rows.append(row)
        legs.append(rows)
    return legs


def _merged(side, subs_spec, legs_json) -> list:
    subs = [_sub(side, spec) for spec in subs_spec]
    for i, s in enumerate(subs):
        s.index = i
    plans = [side.merge.decompose_plan(s) for s in subs]
    slots, k = [], 0
    for plan in plans:
        if plan == "avg":
            slots.append((k, k + 1))
            k += 2
        else:
            slots.append((k, None))
            k += 1
    m = side.merge.StreamMerger(subs, plans, slots, sketch_alpha=0.01)
    for leg in json.loads(legs_json):
        m.add_leg(leg)
    out = []
    for r in m.results():
        ts, vals = r.dps_arrays
        out.append((r.sub_query_index, r.metric, r.tags,
                    sorted(r.aggregated_tags), list(r.tsuids),
                    np.asarray(ts).tolist(),
                    np.asarray(vals, dtype=np.float64).tobytes()))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_stream_merger_on_the_same_legs(seed):
    subs = [JAX.TSQuery.from_json({
        "start": str(BASE_MS), "end": str(BASE_MS + 600_000),
        "queries": [dict({"metric": "c.m"}, **s) for s in MERGE_SUBS]
    }).validate().queries]
    plans = [JAX.merge.decompose_plan(s) for s in subs[0]]
    slots, k = [], 0
    for plan in plans:
        slots.append((k, k + 1) if plan == "avg" else (k, None))
        k += 2 if plan == "avg" else 1
    legs_json = json.dumps(_legs(seed, plans, slots))
    got = _merged(PORT, MERGE_SUBS, legs_json)
    want = _merged(JAX, MERGE_SUBS, legs_json)
    assert got == want and got


def test_batch_merge_equals_the_stream_merge():
    """``merge_sub`` over the gathered legs of one sub is what the
    ``StreamMerger`` folds leg by leg, in both packages (the
    reference's claim that the incremental merge is bit-identical to
    the batch one)."""
    legs_json = json.dumps(_legs(5, ["direct", "avg", "concat"],
                                 [(0, None), (1, 2), (3, None)]))
    for side in SIDES:
        specs = MERGE_SUBS[0], MERGE_SUBS[5], MERGE_SUBS[6]
        stream = _merged(side, list(specs), legs_json)
        subs = [_sub(side, spec) for spec in specs]
        batch = []
        for i, (sub, plan, (p_idx, s_idx)) in enumerate(zip(
                subs, ["direct", "avg", "concat"],
                [(0, None), (1, 2), (3, None)])):
            sub.index = i
            gathered = [[r for r in leg if r["query"]["index"] == idx]
                        for idx in (p_idx, s_idx) if idx is not None
                        for leg in json.loads(legs_json)]
            n = len(json.loads(legs_json))
            primary, secondary = gathered[:n], gathered[n:] or None
            for r in side.merge.merge_sub(sub, side.merge.gb_tag_keys(sub),
                                          plan, primary, secondary):
                ts, vals = r.dps_arrays
                batch.append((r.sub_query_index, r.metric, r.tags,
                              sorted(r.aggregated_tags), list(r.tsuids),
                              np.asarray(ts).tolist(),
                              np.asarray(vals, dtype=np.float64).tobytes()))
        assert batch == stream and batch


def test_tag_fold_and_group_identity():
    rows = [{"metric": "m", "tags": {"host": "a", "dc": "x"},
             "aggregateTags": ["rack"]},
            {"metric": "m", "tags": {"host": "b", "dc": "x"},
             "aggregateTags": []},
            {"metric": "m", "tags": {"dc": "x"}, "aggregateTags": ["host"]}]
    out = []
    for side in SIDES:
        g = side.merge.MergedGroup(rows[0])
        for r in rows[1:]:
            g.fold_tags(r)
        out.append((g.tags, sorted(g.agg_tags),
                    side.merge.group_key(rows[0], ["dc", "host"]),
                    side.merge.gb_tag_keys(_sub(side, {
                        "aggregator": "sum",
                        "filters": [{"type": "wildcard", "tagk": "dc",
                                     "filter": "*", "groupBy": True}]}))))
    assert out[0] == out[1]


def test_sketch_row_blob_forms():
    """``sketchDps`` blobs merge from base64 and from bytes alike, and
    an undecodable blob is skipped on both."""
    sk = JSketch(0.01)
    for v in (1.0, 2.0, 40.0):
        sk.add(v)
    b64 = sk.to_b64()
    rows = [{"metric": "m", "tags": {}, "aggregateTags": [], "dps": [],
             "query": {"index": 0},
             "sketchDps": [[BASE_MS, b64],
                           [BASE_MS + 1, base64.b64decode(b64)],
                           [BASE_MS + 2, "!!notb64"]]}]
    out = []
    for side in SIDES:
        sub = _sub(side, {"aggregator": "sum", "percentiles": [50.0]})
        m = side.merge.StreamMerger([sub], ["sketch"], [(0, None)])
        m.add_leg(rows)
        out.append([(r.metric, np.asarray(r.dps_arrays[0]).tolist(),
                     np.asarray(r.dps_arrays[1]).tolist())
                    for r in m.results()])
    assert out[0] == out[1] and out[0]
