"""Query model: the public JSON/URI query surface
(ref: ``src/core/TSQuery.java:44``, ``TSSubQuery.java:48``).

Validation semantics follow ``TSQuery.validateAndSetQuery``: start time
required, aggregator required per sub-query, one of metric|tsuids
required, times normalized to ms, end defaulting to now. The
pixel-budget keys of the reference's model are not ported yet and
raise NotImplementedError.
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


def _refuse_pixels(obj: dict) -> None:
    if obj.get("pixels") or obj.get("pixelFn"):
        raise NotImplementedError(
            "pixel-budget output reduction is not ported yet")


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
    index: int = 0
    # populated during validation
    agg: aggs_mod.Aggregator | None = None
    ds_spec: DownsamplingSpecification | None = None

    def validate(self, timezone: str | None = None,
                 use_calendar: bool = False) -> None:
        if not self.aggregator:
            raise BadRequestError("Missing the aggregation function")
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

    @classmethod
    def from_json(cls, obj: dict[str, Any], index: int = 0) -> "TSSubQuery":
        _refuse_pixels(obj)
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
            index=index)


@dataclass
class TSQuery:
    """(ref: TSQuery.java:44)"""
    start: str = ""
    end: str | None = None
    queries: list[TSSubQuery] = field(default_factory=list)
    timezone: str | None = None
    ms_resolution: bool = False
    show_tsuids: bool = False
    delete: bool = False
    use_calendar: bool = False
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
        for i, sub in enumerate(self.queries):
            sub.index = i
            sub.validate(self.timezone, self.use_calendar)
        return self

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "TSQuery":
        if not isinstance(obj, dict):
            raise BadRequestError("query must be a JSON object")
        _refuse_pixels(obj)
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
            ms_resolution=bool(obj.get("msResolution")
                               or obj.get("ms", False)),
            show_tsuids=bool(obj.get("showTSUIDs", False)),
            delete=bool(obj.get("delete", False)),
            use_calendar=bool(obj.get("useCalendar", False)),
        )


def parse_uri_subquery(spec: str, index: int = 0) -> TSSubQuery:
    """Parse the URI form
    ``agg:[interval-ds:][rate[{...}]:][explicit_tags:]metric{tags}[{filters}]``
    (ref: QueryRpc.parseMTypeSubQuery). The percentile section of the
    URI form is not ported yet and raises NotImplementedError."""
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
            raise NotImplementedError(
                "percentile sub-queries are not ported yet")
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
