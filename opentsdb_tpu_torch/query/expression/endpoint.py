"""The ``/api/query/exp`` and ``/api/query/gexp`` endpoints (ref:
``opentsdb_tpu/query/expression/endpoint.py``; OpenTSDB's
``src/tsd/QueryExecutor.java:85``, the topo-sorted ExpressionIterator
DAG; ``QueryRpc.java:113``, gexp routing; the POJO request model
``src/query/pojo/Query.java:33``).

Each metric or leaf sub-query runs through the port's engine
(``TSDB.new_query().run``), so its tail takes the engine's placement
and kernels; the expressions then combine the host results in numpy.
"""

from __future__ import annotations

import json
import re

from opentsdb_tpu_torch.query import filters as filters_mod
from opentsdb_tpu_torch.query.expression.core import (GEXP_FUNCTIONS,
                                                SeriesFrame,
                                                evaluate_expression)
from opentsdb_tpu_torch.query.model import (BadRequestError, TSQuery, TSSubQuery,
                                      _validate_pixel_fn,
                                      _validate_pixels,
                                      parse_uri_subquery)


# ---------------------------------------------------------------------------
# /api/query/gexp  (ref: QueryRpc gexp handling)
# ---------------------------------------------------------------------------

def handle_gexp(router, request):
    from opentsdb_tpu_torch.tsd.http_api import HttpResponse
    exprs = request.params.get("exp", [])
    if not exprs:
        raise BadRequestError("Missing parameter exp")
    start = request.param("start")
    if not start:
        raise BadRequestError("Missing start time")
    end = request.param("end")

    all_results = []
    for i, expr in enumerate(exprs):
        frame = _eval_gexp(router.tsdb, expr, start, end)
        results = frame.to_results(sub_query_index=i)
        all_results.extend(results)
    tsq = TSQuery(start=start, end=end, queries=[])
    tsq.start_ms, tsq.end_ms = 0, 1  # already applied per sub-eval
    tsq.ms_resolution = request.flag("ms")
    body = router.serializer.format_query(tsq, all_results)
    return HttpResponse(200, body)


def _eval_gexp(tsdb, expr: str, start: str, end: str | None
               ) -> SeriesFrame:
    """Recursively evaluate a gexp: ``func(args...)`` over m-type
    sub-query leaves."""
    expr = expr.strip()
    m = re.match(r"^(\w+)\((.*)\)$", expr, re.DOTALL)
    if m and m.group(1) in GEXP_FUNCTIONS:
        fname = m.group(1)
        args = _split_args(m.group(2))
        fn = GEXP_FUNCTIONS[fname]
        evaluated = []
        for arg in args:
            arg = arg.strip()
            if re.fullmatch(r"-?\d+(\.\d+)?", arg):
                evaluated.append(float(arg))
            elif re.fullmatch(r"'[^']*'|\"[^\"]*\"", arg):
                evaluated.append(arg[1:-1])
            elif re.fullmatch(r"\d+[smhdwny]", arg):
                evaluated.append(arg)
            else:
                evaluated.append(_eval_gexp(tsdb, arg, start, end))
        return fn(*evaluated)
    # leaf: an m-type sub-query
    sub = parse_uri_subquery(expr)
    tsq = TSQuery(start=start, end=end, queries=[sub])
    tsq.validate()
    results = tsdb.new_query().run(tsq)
    return SeriesFrame.from_results(results)


def _split_args(body: str) -> list[str]:
    """Split on commas not inside parens/braces."""
    args, depth, cur = [], 0, []
    for c in body:
        if c in "({[":
            depth += 1
        elif c in ")}]":
            depth -= 1
        if c == "," and depth == 0:
            args.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if cur or not args:
        args.append("".join(cur))
    return args


def _reduce_frame(frame: SeriesFrame, window_ms: tuple[int, int],
                  px: int, fn: str) -> SeriesFrame:
    """Pixel-budget selection over one output frame: per-series keep
    masks from the shared kernels (``ops/visual_downsample``), then a
    timestamp column survives when ANY series keeps it — exp emits
    row-per-timestamp union rows, so column selection is the only
    shape-preserving reduction. Bounded by ~4·px kept columns per
    series for M4 (px per series for minmaxlttb)."""
    import numpy as np

    from opentsdb_tpu_torch.ops import visual_downsample as vd
    emit = np.ones(frame.values.shape, dtype=bool)
    keep = vd.keep_mask(frame.values, emit, frame.ts,
                        window_ms[0], window_ms[1], px,
                        fn or vd.DEFAULT_PIXEL_FN)
    if keep is None:
        return frame
    col = keep.any(axis=0)
    return SeriesFrame(frame.ts[col], frame.values[:, col],
                       frame.tags, frame.agg_tags, frame.metric)


# ---------------------------------------------------------------------------
# /api/query/exp  (ref: QueryExecutor.java:222 + pojo model)
# ---------------------------------------------------------------------------

def handle_exp(router, request):
    from opentsdb_tpu_torch.tsd.http_api import HttpResponse
    if request.method != "POST":
        raise BadRequestError("/api/query/exp requires POST")
    obj = request.json_object(default={})
    tsdb = router.tsdb

    time_spec = obj.get("time") or {}
    start = str(time_spec.get("start", ""))
    end = time_spec.get("end")
    aggregator = time_spec.get("aggregator", "sum")
    # pixel-aware output reduction: exp assembles its
    # own rows, bypassing the engine's _build_results, so the budget
    # applies HERE — after the expression DAG evaluates. Reducing the
    # metric INPUTS instead would change the arithmetic (an expression
    # over M4-selected subsets is not the M4 selection of the
    # expression). Query-level ``pixels``/``pixelFn`` ride at the top
    # of the body; a per-output override wins (the per-sub rule).
    q_px = _validate_pixels(obj.get("pixels") or 0, "pixels")
    q_fn = _validate_pixel_fn(obj.get("pixelFn") or "", "pixelFn")
    def _ds_string(downsampler, where: str) -> str | None:
        """pojo Downsampler object -> "interval-agg[-fill]" string
        (ref: pojo/Downsampler.java). Strings pass through for the
        convenience form; anything else is a clean 400."""
        if not downsampler:
            return None
        if isinstance(downsampler, str):
            return downsampler
        if not isinstance(downsampler, dict):
            raise BadRequestError(
                f"{where} must be an object with "
                "interval/aggregator (ref: pojo/Downsampler.java)")
        spec = (f"{downsampler.get('interval')}-"
                f"{downsampler.get('aggregator', 'avg')}")
        fp_obj = downsampler.get("fillPolicy") or {}
        if not isinstance(fp_obj, dict):
            raise BadRequestError(
                f"{where}.fillPolicy must be an object")
        fp = fp_obj.get("policy")
        if fp:
            spec += f"-{fp}"
        return spec

    ds_spec = _ds_string(time_spec.get("downsampler"),
                         "time.downsampler")

    # named filter sets (ref: pojo/Filter.java)
    filter_sets: dict[str, list] = {}
    for f in obj.get("filters") or []:
        if not isinstance(f, dict):
            raise BadRequestError("each filter must be an object")
        tags = f.get("tags") or []
        if not isinstance(tags, list) or not all(
                isinstance(t, dict) for t in tags):
            raise BadRequestError(
                "filter tags must be an array of objects")
        filter_sets[f.get("id", "")] = [
            filters_mod.build_filter(t) for t in tags]

    # time-spec rate applies to every metric unless overridden
    time_rate = bool(time_spec.get("rate", False))
    time_rate_options = time_spec.get("rateOptions")

    # metrics: id -> sub-query (ref: pojo/Metric.java incl. per-metric
    # rate/rateOptions)
    variables: dict[str, SeriesFrame] = {}
    metric_meta: dict[str, dict] = {}
    window_ms: tuple[int, int] | None = None
    for mspec in obj.get("metrics") or []:
        if not isinstance(mspec, dict):
            raise BadRequestError("each metric must be an object")
        mid = mspec.get("id")
        if not mid:
            raise BadRequestError("metric missing id")
        sub = TSSubQuery.from_json({
            "metric": mspec.get("metric"),
            "aggregator": mspec.get("aggregator") or aggregator,
            "downsample": _ds_string(
                mspec.get("downsampler"),
                f"metrics[{mid}].downsampler") or ds_spec,
            "rate": mspec.get("rate", time_rate),
            "rateOptions": (mspec.get("rateOptions")
                            or time_rate_options),
        })
        sub.filters = list(filter_sets.get(mspec.get("filter", ""),
                                           []))
        tsq = TSQuery(start=start, end=end, queries=[sub])
        tsq.validate()
        window_ms = (tsq.start_ms, tsq.end_ms)
        results = tsdb.new_query().run(tsq)
        variables[mid] = SeriesFrame.from_results(results)
        metric_meta[mid] = mspec

    # expressions DAG: evaluate in dependency order
    # (ref: QueryExecutor jgrapht topo sort :31-35)
    exprs = {e.get("id"): e for e in obj.get("expressions") or []}
    resolved: dict[str, SeriesFrame] = {}

    def resolve(eid: str, seen: tuple = ()):
        if eid in resolved:
            return resolved[eid]
        if eid in seen:
            raise BadRequestError(f"circular expression reference: {eid}")
        spec = exprs[eid]
        scope = dict(variables)
        for dep in exprs:
            if dep != eid and dep in spec.get("expr", ""):
                scope[dep] = resolve(dep, seen + (eid,))
        # per-expression join + fill (ref: pojo/Join.java SetOperator,
        # pojo/Expression.java fillPolicy -> NumericFillPolicy)
        join = spec.get("join") or {}
        operator = str(join.get("operator") or "union").lower()
        if operator not in ("union", "intersection"):
            raise BadRequestError(
                f"unknown join operator {operator!r}")
        fp = spec.get("fillPolicy") or {}
        if not isinstance(fp, dict):
            raise BadRequestError(
                f"expression {eid} fillPolicy must be an object")
        policy = str(fp.get("policy") or "zero").lower()
        if policy in ("nan", "null"):
            fill = float("nan")
        elif policy == "scalar":
            fill = float(fp.get("value", 0))
        elif policy == "zero":
            fill = 0.0
        else:
            raise BadRequestError(f"unknown fill policy {policy!r}")
        frame = evaluate_expression(spec.get("expr", ""), scope,
                                    join_operator=operator,
                                    fill_missing=fill)
        if not bool(join.get("includeAggTags", True)):
            frame = SeriesFrame(frame.ts, frame.values, frame.tags,
                                [[] for _ in range(frame.num_series)],
                                frame.metric)
        resolved[eid] = frame
        return frame

    outputs = obj.get("outputs") or [{"id": eid} for eid in exprs]
    out_results = []
    for i, ospec in enumerate(outputs):
        oid = ospec.get("id")
        if oid in exprs:
            frame = resolve(oid)
        elif oid in variables:
            frame = variables[oid]
        else:
            raise BadRequestError(f"unknown output id {oid!r}")
        opx = _validate_pixels(ospec.get("pixels") or 0,
                               f"outputs[{oid}].pixels")
        ofn = _validate_pixel_fn(ospec.get("pixelFn") or "",
                                 f"outputs[{oid}].pixelFn")
        px = opx or q_px
        if px and window_ms is not None and len(frame.ts):
            frame = _reduce_frame(frame, window_ms, px, ofn or q_fn)
        dps_rows = []
        for t_idx, ts in enumerate(frame.ts):
            row = [int(ts)]
            row.extend(
                None if (v != v) else (int(v) if float(v).is_integer()
                                       else float(v))
                for v in frame.values[:, t_idx])
            dps_rows.append(row)
        # the output alias renames the emitted series metric (ref:
        # pojo/Output.java alias consumed by QueryExecutor's serdes)
        alias = ospec.get("alias")
        out_results.append({
            "id": oid,
            "alias": alias,
            "dps": dps_rows,
            "dpsMeta": {
                "firstTimestamp": int(frame.ts[0]) if len(frame.ts)
                else 0,
                "lastTimestamp": int(frame.ts[-1]) if len(frame.ts)
                else 0,
                "setCount": frame.num_series,
                "series": frame.num_series,
            },
            "meta": [{"index": 0, "metrics": ["timestamp"]}] + [
                {"index": s + 1,
                 "metrics": [alias or frame.metric],
                 "commonTags": frame.tags[s]
                 if s < len(frame.tags) else {},
                 "aggregatedTags": (frame.agg_tags[s]
                                    if s < len(frame.agg_tags) else [])}
                for s in range(frame.num_series)],
        })
    body = json.dumps({"outputs": out_results, "query": obj},
                      separators=(",", ":")).encode()
    return HttpResponse(200, body)
