"""Query model: the public JSON/URI query surface
(ref: ``src/core/TSQuery.java:44``, ``TSSubQuery.java:48``).

Validation semantics follow ``TSQuery.validateAndSetQuery``: start time
required, aggregator required per sub-query, one of metric|tsuids
required, times normalized to ms, end defaulting to now. A pixel
budget (``pixels``/``pixelFn``, the URI's ``downsample=<N>px``) rides
beside each sub-query's identity (``effective_pixels``). The
reference's ``sketchPartials`` (a cluster router's request) is not
ported yet and raises NotImplementedError.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from typing import Any

from opentsdb_tpu_torch.ops import aggregators as aggs_mod
from opentsdb_tpu_torch.ops.downsample import DownsamplingSpecification
from opentsdb_tpu_torch.ops.rate import RateOptions
from opentsdb_tpu_torch.query import filters as filters_mod
from opentsdb_tpu_torch.utils import datetime_util


class BadRequestError(ValueError):
    """400-level query errors (ref: src/tsd/BadRequestException.java)."""


def _validate_pixels(raw, where: str) -> int:
    """A pixel budget: a positive integer up to ``MAX_PIXELS``, 0 or
    absent for none; 400 on anything else (ref: ``_validate_pixels``,
    strict: a typo must not pass as "no reduction")."""
    from opentsdb_tpu_torch.ops.visual_downsample import MAX_PIXELS
    if raw is None or raw == 0:
        return 0
    if isinstance(raw, (bool, float)) or not isinstance(raw, (int, str)):
        raise BadRequestError(f"Invalid {where}: {raw!r} "
                              "(want a positive integer pixel count)")
    if isinstance(raw, str) and (
            not (raw.isascii() and raw.isdigit())
            or (len(raw) > 1 and raw[0] == "0")):
        # int() would take underscores and unicode digits; a leading
        # zero is taken as a typo
        raise BadRequestError(
            f"Invalid {where}: {raw!r} "
            "(want a positive integer pixel count)")
    px = int(raw)
    if px == 0:
        return 0
    if px < 0 or px > MAX_PIXELS:
        raise BadRequestError(
            f"Invalid {where}: {raw!r} (want 0..{MAX_PIXELS})")
    return px


def _validate_pixel_fn(raw, where: str) -> str:
    from opentsdb_tpu_torch.ops.visual_downsample import PIXEL_FNS
    if not raw:
        return ""
    fn = str(raw).lower()
    if fn not in PIXEL_FNS:
        raise BadRequestError(
            f"Invalid {where}: {raw!r} "
            f"(supported: {', '.join(PIXEL_FNS)})")
    return fn


def effective_pixels(tsq, sub) -> tuple[int, str]:
    """The pixel budget a sub-query's output is reduced under (ref:
    ``effective_pixels``): the sub-query's own wins over the query's;
    the operator defaults to M4. (0, fn) means none."""
    from opentsdb_tpu_torch.ops.visual_downsample import DEFAULT_PIXEL_FN
    px = sub.pixels or tsq.pixels
    fn = sub.pixel_fn or tsq.pixel_fn or DEFAULT_PIXEL_FN
    return (px, fn) if px else (0, fn)


@dataclass
class TSSubQuery:
    """(ref: TSSubQuery.java:48-104)"""
    aggregator: str = ""
    metric: str | None = None
    tsuids: list[str] = field(default_factory=list)
    downsample: str | None = None
    rate: bool = False
    rate_options: RateOptions = field(default_factory=RateOptions)
    filters: list[filters_mod.TagVFilter] = field(default_factory=list)
    explicit_tags: bool = False
    percentiles: list[float] = field(default_factory=list)
    # ROLLUP_NOFALLBACK | ROLLUP_RAW | ROLLUP_FALLBACK |
    # ROLLUP_FALLBACK_RAW (ref: RollupQuery ROLLUP_USAGE)
    rollup_usage: str = "ROLLUP_NOFALLBACK"
    index: int = 0
    # the pixel budget (ops/visual_downsample.py): 0 inherits the
    # query's; fn "" inherits it, or the default (m4)
    pixels: int = 0
    pixel_fn: str = ""
    # populated during validation
    agg: aggs_mod.Aggregator | None = None
    ds_spec: DownsamplingSpecification | None = None

    def validate(self, timezone: str | None = None,
                 use_calendar: bool = False) -> None:
        if not self.aggregator:
            raise BadRequestError("Missing the aggregation function")
        self.pixels = _validate_pixels(self.pixels, "pixels")
        self.pixel_fn = _validate_pixel_fn(self.pixel_fn, "pixelFn")
        try:
            self.agg = aggs_mod.get(self.aggregator)
        except KeyError as e:
            raise BadRequestError(e.args[0]) from None
        if not self.metric and not self.tsuids:
            raise BadRequestError(
                "Missing the metric or tsuids, provide at least one")
        if self.downsample:
            try:
                self.ds_spec = DownsamplingSpecification.parse(
                    self.downsample, timezone)
            except ValueError as e:
                raise BadRequestError(str(e)) from None
            if use_calendar and not self.ds_spec.run_all:
                # the query-level useCalendar flag aligns every
                # downsample to calendar boundaries (ref: TSQuery
                # useCalendar -> DownsamplingSpecification.useCalendar)
                self.ds_spec = replace(self.ds_spec, use_calendar=True)

    def identity_key(self) -> tuple:
        """Value identity excluding ``index`` (ref: TSSubQuery
        equals/hashCode), over the fields this port parses."""
        return (self.aggregator, self.metric, tuple(self.tsuids),
                self.downsample, self.rate,
                (self.rate_options.counter,
                 self.rate_options.counter_max,
                 self.rate_options.reset_value,
                 self.rate_options.drop_resets),
                tuple((f.filter_name, f.tagk, f.filter_expr, f.group_by)
                      for f in self.filters),
                self.explicit_tags, tuple(self.percentiles),
                self.rollup_usage)

    @classmethod
    def from_json(cls, obj: dict[str, Any], index: int = 0) -> "TSSubQuery":
        filters = [filters_mod.build_filter(f)
                   for f in obj.get("filters", [])]
        if obj.get("tags"):
            filters.extend(filters_mod.tags_to_filters(obj["tags"]))
        rate_opts = RateOptions()
        if obj.get("rateOptions"):
            ro = obj["rateOptions"]
            rate_opts = RateOptions(
                counter=bool(ro.get("counter", False)),
                counter_max=float(ro.get("counterMax", 2**64 - 1)),
                reset_value=float(ro.get("resetValue", 0)),
                drop_resets=bool(ro.get("dropResets", False)))
        return cls(
            aggregator=obj.get("aggregator", ""),
            metric=obj.get("metric"),
            tsuids=list(obj.get("tsuids") or []),
            downsample=obj.get("downsample"),
            rate=bool(obj.get("rate", False)),
            rate_options=rate_opts,
            filters=filters,
            explicit_tags=bool(obj.get("explicitTags", False)),
            percentiles=[float(p) for p in obj.get("percentiles") or []],
            rollup_usage=obj.get("rollupUsage", "ROLLUP_NOFALLBACK"),
            pixels=obj.get("pixels") or 0,
            pixel_fn=obj.get("pixelFn") or "",
            index=index)

    def to_json(self) -> dict[str, Any]:
        """(ref: TSSubQuery serialization for ``showQuery``)"""
        return {
            "aggregator": self.aggregator,
            "metric": self.metric,
            "tsuids": self.tsuids or None,
            "downsample": self.downsample,
            "rate": self.rate,
            "rateOptions": (self.rate_options.to_json()
                            if self.rate else None),
            "filters": [f.to_json() for f in self.filters],
            "explicitTags": self.explicit_tags,
            "index": self.index,
            **({"rollupUsage": self.rollup_usage}
               if self.rollup_usage != "ROLLUP_NOFALLBACK" else {}),
            **({"percentiles": list(self.percentiles)}
               if self.percentiles else {}),
            **({"pixels": self.pixels} if self.pixels else {}),
            **({"pixelFn": self.pixel_fn} if self.pixel_fn else {}),
        }


@dataclass
class TSQuery:
    """(ref: TSQuery.java:44)"""
    start: str = ""
    end: str | None = None
    queries: list[TSSubQuery] = field(default_factory=list)
    timezone: str | None = None
    # annotations are not ported (the port has no ``meta/``): both
    # flags are parsed and echoed, and no result carries any
    no_annotations: bool = False
    global_annotations: bool = False
    ms_resolution: bool = False
    show_tsuids: bool = False
    show_summary: bool = False
    show_stats: bool = False
    show_query: bool = False
    delete: bool = False
    use_calendar: bool = False
    # the query-level pixel budget (``downsample=<N>px[-<fn>]`` in the
    # URI, ``pixels``/``pixelFn`` in JSON); a sub-query's own wins
    pixels: int = 0
    pixel_fn: str = ""
    # populated during validation
    start_ms: int = 0
    end_ms: int = 0

    def validate(self, now_ms: int | None = None) -> "TSQuery":
        """(ref: TSQuery.validateAndSetQuery)"""
        if not self.start:
            raise BadRequestError("Missing start time")
        self.start_ms = datetime_util.parse_datetime_ms(
            self.start, self.timezone, now_ms)
        if self.end:
            self.end_ms = datetime_util.parse_datetime_ms(
                self.end, self.timezone, now_ms)
        else:
            import time as _t
            self.end_ms = (now_ms if now_ms is not None
                           else int(_t.time() * 1000))
        if self.end_ms <= self.start_ms:
            raise BadRequestError(
                "end time must be greater than the start time")
        if not self.queries:
            raise BadRequestError("Missing queries")
        self.pixels = _validate_pixels(self.pixels, "downsample pixels")
        self.pixel_fn = _validate_pixel_fn(self.pixel_fn, "pixelFn")
        for i, sub in enumerate(self.queries):
            sub.index = i
            sub.validate(self.timezone, self.use_calendar)
        return self

    def dedupe_queries(self) -> "TSQuery":
        """Collapse duplicate sub-queries, first occurrence wins. Only
        the URI form does this (ref: QueryRpc.parseQuery :617 rebuilds
        through a LinkedHashSet); POST bodies keep duplicates."""
        seen: set = set()
        deduped = []
        for sub in self.queries:
            # two sub-queries that differ only in their pixel budget
            # are not duplicates (the budget is outside identity_key)
            key = (sub.identity_key(), sub.pixels, sub.pixel_fn)
            if key in seen:
                continue
            seen.add(key)
            deduped.append(sub)
        self.queries = deduped
        return self

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "TSQuery":
        if not isinstance(obj, dict):
            raise BadRequestError("query must be a JSON object")
        if obj.get("sketchPartials"):
            from opentsdb_tpu_torch.sketch.query import PARTIALS_NOT_PORTED
            raise NotImplementedError(PARTIALS_NOT_PORTED)
        raw_queries = obj.get("queries") or []
        if not isinstance(raw_queries, list) or not all(
                isinstance(q, dict) for q in raw_queries):
            raise BadRequestError(
                "queries must be an array of sub-query objects")
        return cls(
            start=str(obj.get("start", "")),
            end=(str(obj["end"]) if obj.get("end") not in (None, "")
                 else None),
            queries=[TSSubQuery.from_json(q, i)
                     for i, q in enumerate(raw_queries)],
            timezone=obj.get("timezone"),
            no_annotations=bool(obj.get("noAnnotations", False)),
            global_annotations=bool(obj.get("globalAnnotations", False)),
            ms_resolution=bool(obj.get("msResolution")
                               or obj.get("ms", False)),
            show_tsuids=bool(obj.get("showTSUIDs", False)),
            show_summary=bool(obj.get("showSummary", False)),
            show_stats=bool(obj.get("showStats", False)),
            show_query=bool(obj.get("showQuery", False)),
            delete=bool(obj.get("delete", False)),
            use_calendar=bool(obj.get("useCalendar", False)),
            pixels=obj.get("pixels") or 0,
            pixel_fn=obj.get("pixelFn") or "",
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "start": self.start, "end": self.end,
            "timezone": self.timezone,
            "queries": [q.to_json() for q in self.queries],
            "noAnnotations": self.no_annotations,
            "globalAnnotations": self.global_annotations,
            "msResolution": self.ms_resolution,
            "showTSUIDs": self.show_tsuids,
            **({"pixels": self.pixels} if self.pixels else {}),
            **({"pixelFn": self.pixel_fn} if self.pixel_fn else {}),
        }


def parse_uri_subquery(spec: str, index: int = 0) -> TSSubQuery:
    """Parse the URI form
    ``agg:[interval-ds:][rate[{...}]:][explicit_tags:][percentile[..]:]metric{tags}[{filters}]``
    (ref: QueryRpc.parseMTypeSubQuery), with the histogram section
    ``percentile[...]`` (or ``percentiles[...]``)."""
    parts = spec.split(":")
    if len(parts) < 2:
        raise BadRequestError(f"Invalid parameter m={spec!r}")
    sub = TSSubQuery(aggregator=parts[0], index=index)
    for middle in parts[1:-1]:
        if middle.startswith("rate"):
            sub.rate = True
            sub.rate_options = RateOptions.parse(middle)
        elif middle == "explicit_tags":
            sub.explicit_tags = True
        elif middle.lower().startswith("percentile"):
            # percentile[98,99.9] (ref: QueryRpc.parsePercentiles
            # :887-903, tolerant of spaces)
            pm = re.match(r"^percentiles?\s*\[\s*([^\]]*?)\s*\]$",
                          middle, re.IGNORECASE)
            if not pm:
                raise BadRequestError(
                    f"Malformatted percentile query parameter: "
                    f"{middle!r}")
            try:
                sub.percentiles = [float(p)
                                   for p in pm.group(1).split(",")
                                   if p.strip()]
            except ValueError:
                raise BadRequestError(
                    f"Malformatted percentile query parameter: "
                    f"{middle!r}") from None
            if not sub.percentiles:
                # 'percentile[]' must not become a query without
                # percentiles (ref: parsePercentiles rejects it)
                raise BadRequestError(
                    f"Malformatted percentile query parameter: "
                    f"{middle!r}")
        elif middle:
            sub.downsample = middle
    # metric{groupby-tags}{filter-tags}
    m = re.match(r"^([^{]+)(\{[^}]*\})?(\{[^}]*\})?$", parts[-1])
    if not m:
        raise BadRequestError(f"Invalid metric: {parts[-1]!r}")
    sub.metric = m.group(1)

    def pairs(blob: str):
        body = blob[1:-1].strip()
        for pair in body.split(",") if body else ():
            k, _, v = pair.partition("=")
            if not k or not v:
                raise BadRequestError(f"Invalid tag spec: {pair!r}")
            yield k.strip(), v.strip()

    # first {...} groups by, second {...} filters only (2.2+ semantics)
    if m.group(2) and m.group(3):
        for k, v in pairs(m.group(2)):
            sub.filters.append(filters_mod.get_filter(k, v,
                                                      group_by=True))
        for k, v in pairs(m.group(3)):
            sub.filters.append(filters_mod.get_filter(k, v))
    elif m.group(2):
        # single tagset: old-style conversion decides group-by per value
        sub.filters.extend(filters_mod.tags_to_filters(
            dict(pairs(m.group(2)))))
    return sub


def parse_uri_tsuid_subquery(spec: str, index: int = 0) -> TSSubQuery:
    """Parse the URI form ``agg:[interval-ds:][rate:]tsuid1,tsuid2``
    (ref: QueryRpc.parseTsuidTypeSubQuery)."""
    parts = spec.split(":")
    if len(parts) < 2 or len(parts) > 5:
        raise BadRequestError(f"Invalid parameter tsuids={spec!r}")
    sub = TSSubQuery(aggregator=parts[0], index=index)
    for middle in parts[1:-1]:
        if middle.startswith("rate"):
            sub.rate = True
            sub.rate_options = RateOptions.parse(middle)
        elif middle:
            sub.downsample = middle
    sub.tsuids = [t.strip().upper() for t in parts[-1].split(",")
                  if t.strip()]
    if not sub.tsuids:
        raise BadRequestError(f"Invalid parameter tsuids={spec!r}")
    return sub


def parse_uri_pixels(spec: str) -> tuple[int, str]:
    """Parse ``downsample=<N>px[-<fn>]`` (``1500px``,
    ``800px-minmaxlttb``); anything else is a 400, not a silent no-op
    (ref: ``parse_uri_pixels``)."""
    m = re.match(r"^(\d+)px(?:-([a-z0-9]+))?$", spec.strip().lower())
    if not m:
        raise BadRequestError(
            f"Invalid downsample parameter: {spec!r} "
            "(want <pixels>px or <pixels>px-<m4|minmaxlttb>)")
    return (_validate_pixels(m.group(1), "downsample pixels"),
            _validate_pixel_fn(m.group(2), "downsample pixel fn"))


def parse_uri_query(params: dict[str, list[str]]) -> TSQuery:
    """Parse ``/api/query?start=...&m=...`` URI params (ref:
    QueryRpc.parseQuery)."""
    def first(key, default=None):
        vals = params.get(key)
        return vals[0] if vals else default

    # tsuid sub-queries come first, as in the reference, so mixed
    # tsuids= and m= requests keep its output indices
    queries = [parse_uri_tsuid_subquery(spec, i)
               for i, spec in enumerate(params.get("tsuids", []))]
    queries += [parse_uri_subquery(spec, len(queries) + i)
                for i, spec in enumerate(params.get("m", []))]
    pixels, pixel_fn = (parse_uri_pixels(first("downsample"))
                        if first("downsample") is not None else (0, ""))
    return TSQuery(
        start=first("start", ""),
        end=first("end"),
        queries=queries,
        timezone=first("tz"),
        use_calendar=first("use_calendar",
                           first("useCalendar", "false"))
        in ("true", ""),
        no_annotations=first("no_annotations", "false") == "true",
        global_annotations=first("global_annotations", "false") == "true",
        ms_resolution=first("ms", first("ms_resolution", "false"))
        in ("true", ""),
        show_tsuids=first("show_tsuids", "false") == "true",
        show_summary=first("show_summary", "false") == "true",
        show_query=first("show_query", "false") == "true",
        pixels=pixels,
        pixel_fn=pixel_fn,
    )
