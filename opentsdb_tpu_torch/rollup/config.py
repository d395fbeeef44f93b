"""Rollup tier configuration (ref: ``opentsdb_tpu/rollup/config.py``,
``src/rollup/RollupConfig.java:60``, ``RollupInterval.java:32``).

A rollup tier is one downsampling interval materialized ahead of query
time (raw -> 1m -> 1h). Each tier is kept as one store per aggregator:
sum, count, min and max, the four the reference writes; avg is derived
at query time as sum over count.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from opentsdb_tpu_torch.utils import datetime_util

# aggregator <-> numeric id of the rollup cell qualifiers (ref:
# RollupConfig.java aggregationIds :261-287)
DEFAULT_AGG_IDS = {"sum": 0, "count": 1, "min": 2, "max": 3}


@dataclass
class RollupInterval:
    """(ref: RollupInterval.java:32)"""
    table: str
    pre_aggregation_table: str
    interval: str          # e.g. "1m", "1h"
    row_span: str = "1d"   # "1h" | "1d" | "1m" (month) | "1y"
    default_interval: bool = False
    interval_ms: int = field(init=False)

    def __post_init__(self) -> None:
        self.interval_ms = datetime_util.parse_duration_ms(self.interval)

    @property
    def unit(self) -> str:
        return datetime_util.duration_unit(self.interval)


class RollupConfig:
    """(ref: RollupConfig.java:60)"""

    def __init__(self, intervals: list[RollupInterval],
                 agg_ids: dict[str, int] | None = None):
        if not intervals:
            raise ValueError("rollup config needs at least one interval")
        self.intervals = sorted(intervals, key=lambda iv: iv.interval_ms)
        self.agg_ids = dict(agg_ids or DEFAULT_AGG_IDS)
        self.id_to_agg = {v: k for k, v in self.agg_ids.items()}
        self._by_interval = {iv.interval: iv for iv in self.intervals}

    @classmethod
    def default(cls) -> "RollupConfig":
        return cls([
            RollupInterval("tsdb-rollup-1m", "tsdb-rollup-agg-1m", "1m", "1d"),
            RollupInterval("tsdb-rollup-1h", "tsdb-rollup-agg-1h", "1h", "1y",
                           default_interval=True),
        ])

    @classmethod
    def from_file(cls, path: str) -> "RollupConfig":
        with open(path, encoding="utf-8") as fh:
            return cls.from_json(json.load(fh))

    @classmethod
    def from_json(cls, obj) -> "RollupConfig":
        """The reference's JSON: a bare list of interval objects, or
        ``{"intervals": [...], "aggregationIds": {...}}``."""
        if isinstance(obj, list):
            intervals_json, agg_ids = obj, None
        else:
            intervals_json = obj.get("intervals", [])
            agg_ids = obj.get("aggregationIds")
        intervals = [
            RollupInterval(
                table=iv.get("table", f"tsdb-rollup-{iv['interval']}"),
                pre_aggregation_table=iv.get(
                    "preAggregationTable",
                    f"tsdb-rollup-agg-{iv['interval']}"),
                interval=iv["interval"],
                row_span=iv.get("rowSpan", "1d"),
                default_interval=bool(iv.get("defaultInterval", False)),
            ) for iv in intervals_json
        ]
        return cls(intervals, agg_ids)

    def get_interval(self, interval: str) -> RollupInterval:
        try:
            return self._by_interval[interval]
        except KeyError:
            raise ValueError(f"no rollup tier for interval {interval!r}"
                             ) from None

    def best_match(self, interval_ms: int) -> RollupInterval | None:
        """The widest tier whose interval divides the query's downsample
        interval, or None when raw data must answer (ref: TsdbQuery's
        rollup best match :143-150)."""
        best = None
        for iv in self.intervals:
            if iv.interval_ms <= interval_ms and \
                    interval_ms % iv.interval_ms == 0:
                best = iv
        return best

    def to_json(self) -> dict:
        return {
            "intervals": [
                {"table": iv.table,
                 "preAggregationTable": iv.pre_aggregation_table,
                 "interval": iv.interval, "rowSpan": iv.row_span,
                 "defaultInterval": iv.default_interval}
                for iv in self.intervals],
            "aggregationIds": self.agg_ids,
        }
