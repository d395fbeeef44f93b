"""``/api/query/exp`` and ``/api/query/gexp`` against the JAX
package's (``query/expression/``, mirroring ``tests/test_expression.py``
and the gexp cases of ``tests/test_http.py``).

One table of request bodies goes to both HTTP routers over the same
data at both packages' defaults (the port on the CPU in float64): the
statuses are equal, error bodies byte for byte, and answers equal as
parsed JSON with numbers within rtol 1e-9. The expression core's
functions are held to the reference's on seeded frames.
"""

from __future__ import annotations

import copy
import json
import math

import numpy as np
import pytest

from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.query.expression import core as jcore
from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.query.expression import core as tcore
from opentsdb_tpu_torch.tsd import http_api
from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter

BASE = 1356998400


def _write(t) -> None:
    """``tests/test_expression.py``'s data: m.a/m.b on host x (m.a also
    on y), px.a at 1 s for 600 s, m.n a counter, m.empty no points."""
    for i in range(4):
        t.add_point("m.a", BASE + i * 60, 10 * (i + 1), {"host": "x"})
        t.add_point("m.b", BASE + i * 60, i + 1, {"host": "x"})
        t.add_point("m.a", BASE + i * 60, 5.0, {"host": "y"})
    for i in range(600):
        t.add_point("px.a", BASE + i, 100 + 10 * math.sin(i / 7),
                    {"host": "x"})
        t.add_point("m.n", BASE + i, float(i * 3 + (i % 5)),
                    {"host": f"n{i % 3}", "dc": f"d{i % 2}"})
    t.uids.metrics.get_or_create_id("m.empty")


@pytest.fixture(scope="module")
def routers():
    keys = {"tsd.core.auto_create_metrics": "true"}
    jt = JTSDB(JConfig(**{**keys, "tsd.tpu.platform": "cpu"}))
    tt = TSDB(Config(**{**keys, "tsd.torch.device": "cpu",
                        "tsd.torch.dtype": "float64"}))
    for t in (jt, tt):
        _write(t)
    yield JRouter(jt), HttpRpcRouter(tt)
    for t in (jt, tt):
        t.shutdown()


def _close(got, want, where="$"):
    """Equal JSON, numbers within rtol 1e-9."""
    if isinstance(want, bool) or want is None or isinstance(want, str):
        assert got == want, where
    elif isinstance(want, (int, float)):
        assert isinstance(got, (int, float)) and \
            not isinstance(got, bool), where
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12,
                                   err_msg=where)
    elif isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    else:
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")


def _send(routers, method, path, body=None, **params):
    jr, pr = routers
    prm = {k: v if isinstance(v, list) else [str(v)]
           for k, v in params.items()}
    raw = json.dumps(body).encode() if body is not None else b""
    want = jr.handle(JRequest(method, path, prm, {}, raw))
    got = pr.handle(HttpRequest(method, path, prm, {}, raw))
    assert got.status == want.status, (got.body[:300], want.body[:300])
    if want.status != 200:
        assert got.body == want.body
        return None
    out = json.loads(got.body)
    _close(out, json.loads(want.body))
    return out


def _exp(exprs, outputs=None, metrics=None, filters=True, **top):
    body = {"time": {"start": str(BASE), "end": str(BASE + 300),
                     "aggregator": "sum"},
            "metrics": metrics or [
                {"id": "A", "metric": "m.a", **({"filter": "f1"}
                                                 if filters else {})},
                {"id": "B", "metric": "m.b", **({"filter": "f1"}
                                                 if filters else {})}],
            "expressions": exprs}
    if filters:
        body["filters"] = [{"id": "f1", "tags": [
            {"type": "wildcard", "tagk": "host", "filter": "*",
             "groupBy": True}]}]
    if outputs:
        body["outputs"] = outputs
    body.update(top)
    return body


def _px(**top):
    body = {"time": {"start": str(BASE), "end": str(BASE + 600),
                     "aggregator": "sum"},
            "metrics": [{"id": "A", "metric": "px.a"}],
            "expressions": [{"id": "e", "expr": "A * 2"}],
            "outputs": [{"id": "e"}]}
    body.update(top)
    return body


EXP = {
    "intersection": _exp([{"id": "e", "expr": "A + B",
                           "join": {"operator": "intersection"}}]),
    "union-scalar-fill": _exp([{"id": "e", "expr": "A + B",
                                "join": {"operator": "union"},
                                "fillPolicy": {"policy": "scalar",
                                               "value": 100}}]),
    "union-nan-fill": _exp([{"id": "e", "expr": "A * B",
                             "fillPolicy": {"policy": "nan"}}]),
    "percent": _exp([{"id": "e", "expr": "B / A * 100"}]),
    "rate": (lambda b: (b["metrics"][0].update(rate=True), b)[1])(
        _exp([{"id": "e", "expr": "A + 0"}])),
    "alias": _exp([{"id": "e", "expr": "A + B"}],
                  outputs=[{"id": "e", "alias": "my-output"}]),
    "no-agg-tags": _exp([{"id": "e", "expr": "A + B",
                          "join": {"operator": "union",
                                   "includeAggTags": False}}],
                        filters=False),
    "bad-join-400": _exp([{"id": "e", "expr": "A + B",
                           "join": {"operator": "cross"}}]),
    "nested-one": _exp([{"id": "e1", "expr": "A + B"},
                        {"id": "e2", "expr": "e1 * 2"}], [{"id": "e2"}]),
    "nested-two-out-of-order": _exp(
        [{"id": "e3", "expr": "e2 + 1"}, {"id": "e2", "expr": "e1 * 2"},
         {"id": "e1", "expr": "A + B"}], [{"id": "e3"}]),
    "one-of-two-outputs": _exp([{"id": "e1", "expr": "A + B"},
                                {"id": "e2", "expr": "A - B"}],
                               [{"id": "e2"}]),
    "default-outputs": _exp([{"id": "e1", "expr": "A + B"},
                             {"id": "e2", "expr": "A - B"}]),
    "metric-output": _exp([{"id": "e1", "expr": "A + B"}],
                          [{"id": "A"}, {"id": "e1"}]),
    "self-reference-400": _exp([{"id": "e1", "expr": "e1 + A"}]),
    "circular-400": _exp([{"id": "e1", "expr": "e2 + A"},
                          {"id": "e2", "expr": "e1 + B"}]),
    "unknown-variable-400": _exp([{"id": "e1", "expr": "A + NOPE"}]),
    "unknown-output-400": _exp([{"id": "e1", "expr": "A + B"}],
                               [{"id": "zz"}]),
    "unknown-metric-400": (lambda b: (b["metrics"][0].update(
        metric="no.such.metric"), b)[1])(_exp([{"id": "e1",
                                                "expr": "A + B"}])),
    "empty-result": _exp([{"id": "e1", "expr": "A + B"}], metrics=[
        {"id": "A", "metric": "m.empty"}, {"id": "B", "metric": "m.empty"}],
        filters=False),
    "downsampler-object": (lambda b: (b["time"].update(downsampler={
        "interval": "2m", "aggregator": "avg"}), b)[1])(
        _exp([{"id": "e1", "expr": "A + B"}])),
    "downsampler-string": (lambda b: (b["time"].update(
        downsampler="2m-max"), b)[1])(_exp([{"id": "e1", "expr": "A+B"}])),
    "downsampler-bad-400": (lambda b: (b["time"].update(downsampler=300),
                                       b)[1])(_exp([{"id": "e1",
                                                     "expr": "A + B"}])),
    "per-metric-downsampler": (lambda b: (b["metrics"][0].update(
        downsampler={"interval": "5m", "aggregator": "max"}), b)[1])(
        _exp([{"id": "e1", "expr": "A + 0"}])),
    "per-metric-downsampler-bad-400": (lambda b: (b["metrics"][0].update(
        downsampler=["5m-avg"]), b)[1])(_exp([{"id": "e1",
                                               "expr": "A + 0"}])),
    "pixels-query-level": _px(pixels=20),
    "pixels-per-output-wins": (lambda b: (b.update(outputs=[
        {"id": "e", "pixels": 10}]), b)[1])(_px(pixels=300)),
    "pixels-minmaxlttb": _px(pixels=25, pixelFn="minmaxlttb"),
    "pixels-zero-is-off": _px(pixels=0),
    "pixels-bad-400": _px(pixels="0800"),
    "pixel-fn-bad-400": _px(pixels=10, pixelFn="nope"),
    "group-by-counter": {
        "time": {"start": str(BASE), "end": str(BASE + 599),
                 "aggregator": "sum", "downsampler": "1m-avg"},
        "filters": [{"id": "f", "tags": [{"type": "wildcard",
                                          "tagk": "dc", "filter": "*",
                                          "groupBy": True}]}],
        "metrics": [{"id": "N", "metric": "m.n", "filter": "f",
                     "rate": True},
                    {"id": "T", "metric": "m.n"}],
        "expressions": [{"id": "share", "expr": "N / T * 100"}]},
}


@pytest.mark.parametrize("name", sorted(EXP))
def test_exp_equals_reference(routers, name):
    out = _send(routers, "POST", "/api/query/exp", EXP[name])
    if name.endswith("-400"):
        assert out is None
    else:
        assert out["outputs"]


GEXP = {
    "scale": "scale(sum:m.a,10)",
    "absolute": "absolute(scale(sum:m.a,-1))",
    "alias": "alias(sum:m.a{host=*},'renamed')",
    "moving-average": "movingAverage(sum:px.a,5)",
    "moving-average-time": "movingAverage(sum:px.a,'30s')",
    "highest-current": "highestCurrent(sum:m.a{host=*},1)",
    "highest-max": "highestMax(sum:m.n{host=*},2)",
    "time-shift": "timeShift(sum:m.a,'1m')",
    "sum-series": "sumSeries(sum:m.a,sum:m.b)",
    "diff-series": "diffSeries(sum:m.a,sum:m.b)",
    "multiply-series": "multiplySeries(sum:m.a,sum:m.b)",
    "divide-series": "divideSeries(sum:m.b,sum:m.a)",
    "downsampled": "scale(sum:1m-avg:m.n{dc=*},0.5)",
    "rate": "scale(sum:rate:m.n,60)",
}


@pytest.mark.parametrize("name", sorted(GEXP))
def test_gexp_equals_reference(routers, name):
    out = _send(routers, "GET", "/api/query/gexp", exp=GEXP[name],
                start=BASE, end=BASE + 600)
    assert out


def test_gexp_several_and_errors(routers):
    """Two ``exp`` params answer in order; the errors of the reference
    (no exp, no start, an unknown metric) answer its bytes."""
    out = _send(routers, "GET", "/api/query/gexp",
                exp=["scale(sum:m.a,2)", "sumSeries(sum:m.a,sum:m.b)"],
                start=BASE, end=BASE + 300)
    assert len(out) == 3
    _send(routers, "GET", "/api/query/gexp", start=BASE)
    _send(routers, "GET", "/api/query/gexp", exp="scale(sum:m.a,2)")
    _send(routers, "GET", "/api/query/gexp", exp="scale(sum:nope,2)",
          start=BASE)
    _send(routers, "GET", "/api/query/exp")


def test_expression_endpoints_left_the_unported_table():
    """The router refuses no endpoint any more (its table of unported
    ones went with the last of them): ``exp`` and ``gexp`` are routed
    to their handlers."""
    assert not hasattr(http_api, "UNPORTED")
    tt = TSDB(Config(**{"tsd.torch.device": "cpu"}))
    try:
        assert "query" in http_api.HttpRpcRouter(tt)._routes
    finally:
        tt.shutdown()


# -- the expression core ----------------------------------------------------

def _frames(mod, seed: int):
    rng = np.random.default_rng(seed)
    ts = 1000 * np.arange(0, 40, dtype=np.int64)
    a = rng.normal(5, 2, (3, 40))
    a[rng.random((3, 40)) < 0.15] = np.nan
    b = rng.normal(1, 1, (2, 30))
    return {"a": mod.SeriesFrame(ts, a, [{"host": h} for h in "xyz"],
                                 [[] for _ in range(3)], "m.a"),
            "b": mod.SeriesFrame(ts[5:35], b, [{"host": h} for h in "xq"],
                                 [["dc"] for _ in range(2)], "m.b")}


@pytest.mark.parametrize("expr", ["a + b", "a * b - 2", "a / b",
                                  "-(a + 1) * 3", "b - a / 2",
                                  "(a + b) * (a - b)", "2.5 * a"])
@pytest.mark.parametrize("join", ["union", "intersection"])
def test_evaluate_expression_equals_reference(expr, join):
    for fill in (0.0, float("nan"), 7.0):
        got = tcore.evaluate_expression(expr, _frames(tcore, 3),
                                        join_operator=join,
                                        fill_missing=fill)
        want = jcore.evaluate_expression(expr, _frames(jcore, 3),
                                         join_operator=join,
                                         fill_missing=fill)
        np.testing.assert_array_equal(got.ts, want.ts)
        np.testing.assert_array_equal(got.values, want.values)
        assert (got.tags, got.agg_tags, got.metric) == \
            (want.tags, want.agg_tags, want.metric)


def test_gexp_functions_and_frames_equal_reference():
    assert set(tcore.GEXP_FUNCTIONS) == set(jcore.GEXP_FUNCTIONS)
    tf, jf = _frames(tcore, 5)["a"], _frames(jcore, 5)["a"]
    for name, args in (("movingAverage", (3,)), ("movingAverage", ("5s",)),
                       ("highestCurrent", (2,)), ("highestMax", (1,)),
                       ("timeShift", ("2s",)), ("scale", (1.5,)),
                       ("absolute", ())):
        got = tcore.GEXP_FUNCTIONS[name](tf, *args)
        want = jcore.GEXP_FUNCTIONS[name](jf, *args)
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.ts, want.ts)
    # the results round trip: rows drop NaN points as the reference's
    got = tcore.SeriesFrame.from_results(tf.to_results(sub_query_index=2))
    rows = jf.to_results(sub_query_index=2)
    want = jcore.SeriesFrame.from_results(rows)
    np.testing.assert_array_equal(got.ts, want.ts)
    np.testing.assert_array_equal(got.values, want.values)
    for g, w in zip(tf.to_results(), rows):
        assert g.dps == w.dps and g.tags == w.tags
    assert tcore.SeriesFrame.from_results([]).num_series == 0


def test_exp_metric_runs_through_the_engine(routers, monkeypatch):
    """Each metric of an ``/exp`` body runs as a sub-query of the port's
    engine (its placement and kernels), not beside it."""
    from opentsdb_tpu_torch.query import engine as tengine
    calls = []
    orig = tengine.QueryEngine.run
    monkeypatch.setattr(tengine.QueryEngine, "run",
                        lambda self, tsq, stats=None: (
                            calls.append(tsq.queries[0].metric),
                            orig(self, tsq, stats))[1])
    _send(routers, "POST", "/api/query/exp",
          copy.deepcopy(EXP["percent"]))
    assert calls == ["m.a", "m.b"]
