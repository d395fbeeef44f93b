"""Expression evaluation core (ref: ``opentsdb_tpu/query/expression/
core.py``; OpenTSDB's ``src/query/expression/``), host numpy in both
packages, over the port's :class:`QueryResult` columns.

OpenTSDB evaluates cross-metric arithmetic with time-synced iterators
(``ExpressionIterator.java:40``, ``TimeSyncedIterator``,
``IntersectionIterator``/``UnionIterator``) pulling one timestamp at a
time. Here a variable is a :class:`SeriesFrame`, a dense
``[series, time]`` matrix on a shared timestamp grid, and every
expression/function is a vectorized numpy op. Set joins
(intersection/union on tag sets, ref ``SetOperator``) become row
alignment by tag-key.

Functions mirror ``ExpressionFactory.java:32-38``: alias, scale,
absolute, movingAverage, highestCurrent, highestMax, timeShift,
sumSeries, diffSeries, multiplySeries, divideSeries.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from opentsdb_tpu_torch.query.engine import QueryResult


@dataclass
class SeriesFrame:
    """A set of series on one timestamp grid: the array form of one
    sub-query result (one row per output group)."""
    ts: np.ndarray                      # [T] ms
    values: np.ndarray                  # [S, T], NaN = missing
    tags: list[dict[str, str]]          # per row
    agg_tags: list[list[str]] = field(default_factory=list)
    metric: str = ""

    @classmethod
    def from_results(cls, results: list[QueryResult]) -> "SeriesFrame":
        if not results:
            return cls(np.empty(0, dtype=np.int64),
                       np.empty((0, 0)), [], [], "")
        all_ts = np.unique(np.concatenate(
            [np.asarray(r.dps_arrays[0], dtype=np.int64) for r in results]))
        values = np.full((len(results), len(all_ts)), np.nan)
        for i, r in enumerate(results):
            ts, vals = r.dps_arrays
            values[i, np.searchsorted(all_ts, ts)] = vals
        return cls(all_ts, values,
                   [dict(r.tags) for r in results],
                   [list(r.aggregated_tags) for r in results],
                   results[0].metric)

    def to_results(self, metric: str | None = None,
                   sub_query_index: int = 0) -> list[QueryResult]:
        out = []
        ts = np.asarray(self.ts, dtype=np.int64)
        for i in range(self.values.shape[0]):
            row = np.asarray(self.values[i], dtype=np.float64)
            have = ~np.isnan(row)
            out.append(QueryResult(
                metric=metric or self.metric,
                tags=self.tags[i] if i < len(self.tags) else {},
                aggregated_tags=(self.agg_tags[i]
                                 if i < len(self.agg_tags) else []),
                dps_arrays=(ts[have], row[have]),
                sub_query_index=sub_query_index))
        return out

    def copy_with(self, values: np.ndarray,
                  metric: str | None = None) -> "SeriesFrame":
        return SeriesFrame(self.ts, values, self.tags, self.agg_tags,
                           metric if metric is not None else self.metric)

    @property
    def num_series(self) -> int:
        return self.values.shape[0]


def align_frames(a: SeriesFrame, b: SeriesFrame, operator: str = "union"
                 ) -> tuple[SeriesFrame, SeriesFrame]:
    """Join two frames on series tags and timestamp union
    (ref: IntersectionIterator / UnionIterator set joins)."""
    # timestamp union grid
    all_ts = np.union1d(a.ts, b.ts)

    def regrid(f: SeriesFrame) -> np.ndarray:
        out = np.full((f.num_series, len(all_ts)), np.nan)
        idx = np.searchsorted(all_ts, f.ts)
        out[:, idx] = f.values
        return out

    av, bv = regrid(a), regrid(b)
    key = lambda tags: tuple(sorted(tags.items()))
    a_keys = {key(t): i for i, t in enumerate(a.tags)}
    b_keys = {key(t): i for i, t in enumerate(b.tags)}
    if operator == "intersection":
        keys = [k for k in a_keys if k in b_keys]
    else:  # union
        keys = list(dict.fromkeys(list(a_keys) + list(b_keys)))
    # Only genuinely scalar-like single-series frames broadcast against
    # the other side: a fully-aggregated result has an empty tag dict.
    # A tagged single-series frame goes through the keyed join below so
    # intersection honors tag-set semantics (ref IntersectionIterator).
    a_scalar = a.num_series == 1 and not (a.tags and a.tags[0])
    b_scalar = b.num_series == 1 and not (b.tags and b.tags[0])
    if a_scalar and b.num_series > 1:
        keys = list(b_keys)
        a_rows = np.zeros(len(keys), dtype=int)
        b_rows = np.asarray([b_keys[k] for k in keys])
        tags = [dict(k) for k in keys]
        return (SeriesFrame(all_ts, av[a_rows], tags, b.agg_tags,
                            a.metric),
                SeriesFrame(all_ts, bv[b_rows], tags, b.agg_tags,
                            b.metric))
    if b_scalar and a.num_series > 1:
        keys = list(a_keys)
        b_rows = np.zeros(len(keys), dtype=int)
        av2 = np.stack([av[a_keys[k]] for k in keys]) if keys else av
        tags = [dict(k) for k in keys]
        return (SeriesFrame(all_ts, av2, tags, a.agg_tags, a.metric),
                SeriesFrame(all_ts, bv[b_rows], tags, a.agg_tags,
                            b.metric))
    an = np.full((len(keys), len(all_ts)), np.nan)
    bn = np.full((len(keys), len(all_ts)), np.nan)
    agg_tags: list[list[str]] = []
    for i, k in enumerate(keys):
        row_agg: list[str] = []
        if k in a_keys:
            an[i] = av[a_keys[k]]
            if a_keys[k] < len(a.agg_tags):
                row_agg = list(a.agg_tags[a_keys[k]])
        if k in b_keys:
            bn[i] = bv[b_keys[k]]
            if not row_agg and b_keys[k] < len(b.agg_tags):
                row_agg = list(b.agg_tags[b_keys[k]])
        agg_tags.append(row_agg)
    tags = [dict(k) for k in keys]
    return (SeriesFrame(all_ts, an, tags, agg_tags, a.metric),
            SeriesFrame(all_ts, bn, tags, agg_tags, b.metric))


def binary_op(a: SeriesFrame, b: SeriesFrame, op: str,
              operator: str = "union",
              fill_missing: float = 0.0) -> SeriesFrame:
    """Elementwise arithmetic after join. Missing values substitute
    ``fill_missing`` (the reference's NumericFillPolicy default ZERO)."""
    aa, bb = align_frames(a, b, operator)
    av = np.where(np.isnan(aa.values), fill_missing, aa.values)
    bv = np.where(np.isnan(bb.values), fill_missing, bb.values)
    both_missing = np.isnan(aa.values) & np.isnan(bb.values)
    if op == "+":
        out = av + bv
    elif op == "-":
        out = av - bv
    elif op == "*":
        out = av * bv
    elif op == "/":
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(bv == 0, 0.0, av / bv)
    else:
        raise ValueError(f"unknown operator {op!r}")
    out = np.where(both_missing, np.nan, out)
    return aa.copy_with(out)


def scalar_op(a: SeriesFrame, scalar: float, op: str,
              scalar_left: bool = False) -> SeriesFrame:
    v = a.values
    if op == "+":
        out = scalar + v if scalar_left else v + scalar
    elif op == "-":
        out = scalar - v if scalar_left else v - scalar
    elif op == "*":
        out = v * scalar
    elif op == "/":
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(v == 0, 0.0, scalar / v) if scalar_left \
                else v / scalar
    else:
        raise ValueError(f"unknown operator {op!r}")
    return a.copy_with(out)


# ---------------------------------------------------------------------------
# gexp function library (ref: ExpressionFactory.java:32-38)
# ---------------------------------------------------------------------------

def fn_absolute(frame: SeriesFrame) -> SeriesFrame:
    return frame.copy_with(np.abs(frame.values))


def fn_scale(frame: SeriesFrame, factor: float) -> SeriesFrame:
    return frame.copy_with(frame.values * factor)


def fn_alias(frame: SeriesFrame, name: str) -> SeriesFrame:
    return frame.copy_with(frame.values, metric=name)


def fn_moving_average(frame: SeriesFrame, window: str) -> SeriesFrame:
    """(ref: MovingAverage.java:709) window = point count or time
    duration like '1m'."""
    from opentsdb_tpu_torch.utils import datetime_util
    v = frame.values
    out = np.full_like(v, np.nan)
    if isinstance(window, str) and window and not window.isdigit():
        win_ms = datetime_util.parse_duration_ms(window)
        ts = frame.ts
        for t in range(v.shape[1]):
            # trailing window [t - win, t): inclusive lower edge
            lo = np.searchsorted(ts, ts[t] - win_ms, side="left")
            if lo < t:
                seg = v[:, lo:t]
                with np.errstate(invalid="ignore"):
                    out[:, t] = np.nanmean(seg, axis=1)
    else:
        n = int(window)
        for t in range(v.shape[1]):
            lo = max(0, t - n)
            if lo < t:
                seg = v[:, lo:t]
                with np.errstate(invalid="ignore"):
                    out[:, t] = np.nanmean(seg, axis=1)
    return frame.copy_with(np.where(np.isnan(out), 0.0, out))


def fn_highest_current(frame: SeriesFrame, count: int) -> SeriesFrame:
    """Top-N series by most recent value (ref: HighestCurrent)."""
    if frame.num_series == 0:
        return frame
    last_vals = np.full(frame.num_series, -np.inf)
    for i in range(frame.num_series):
        valid = ~np.isnan(frame.values[i])
        if valid.any():
            last_vals[i] = frame.values[i][valid][-1]
    top = np.argsort(-last_vals, kind="stable")[:int(count)]
    return SeriesFrame(frame.ts, frame.values[top],
                       [frame.tags[i] for i in top],
                       [frame.agg_tags[i] for i in top
                        if i < len(frame.agg_tags)], frame.metric)


def fn_highest_max(frame: SeriesFrame, count: int) -> SeriesFrame:
    if frame.num_series == 0:
        return frame
    with np.errstate(invalid="ignore"):
        maxes = np.where(np.all(np.isnan(frame.values), axis=1), -np.inf,
                         np.nanmax(np.where(np.isnan(frame.values),
                                            -np.inf, frame.values),
                                   axis=1))
    top = np.argsort(-maxes, kind="stable")[:int(count)]
    return SeriesFrame(frame.ts, frame.values[top],
                       [frame.tags[i] for i in top],
                       [frame.agg_tags[i] for i in top
                        if i < len(frame.agg_tags)], frame.metric)


def fn_time_shift(frame: SeriesFrame, interval: str) -> SeriesFrame:
    """Shift series forward in time (ref: TimeShift)."""
    from opentsdb_tpu_torch.utils import datetime_util
    shift_ms = datetime_util.parse_duration_ms(interval)
    return SeriesFrame(frame.ts + shift_ms, frame.values, frame.tags,
                       frame.agg_tags, frame.metric)


def _reduce_series(frames: list[SeriesFrame], op: str) -> SeriesFrame:
    acc = frames[0]
    for f in frames[1:]:
        acc = binary_op(acc, f, op)
    return acc


def fn_sum_series(*frames: SeriesFrame) -> SeriesFrame:
    return _reduce_series(list(frames), "+")


def fn_diff_series(*frames: SeriesFrame) -> SeriesFrame:
    return _reduce_series(list(frames), "-")


def fn_multiply_series(*frames: SeriesFrame) -> SeriesFrame:
    return _reduce_series(list(frames), "*")


def fn_divide_series(*frames: SeriesFrame) -> SeriesFrame:
    return _reduce_series(list(frames), "/")


GEXP_FUNCTIONS: dict[str, Callable] = {
    "absolute": fn_absolute,
    "scale": fn_scale,
    "alias": fn_alias,
    "movingAverage": fn_moving_average,
    "highestCurrent": fn_highest_current,
    "highestMax": fn_highest_max,
    "timeShift": fn_time_shift,
    "sumSeries": fn_sum_series,
    "diffSeries": fn_diff_series,
    "multiplySeries": fn_multiply_series,
    "divideSeries": fn_divide_series,
    # aliases registered by the reference factory
    # (ExpressionFactory.java:37-57: shift, sum, difference, multiply,
    # divide map to the same implementations)
    "shift": fn_time_shift,
    "sum": fn_sum_series,
    "difference": fn_diff_series,
    "multiply": fn_multiply_series,
    "divide": fn_divide_series,
}


# ---------------------------------------------------------------------------
# infix expression parser (ref: Expressions.java infix parse + the
# JavaCC grammar src/parser.jj used by SyntaxChecker)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.\d+|\.\d+|\d+)|(?P<id>[A-Za-z_][\w.\-]*)"
    r"|(?P<op>[+\-*/()]))")


class InfixParser:
    """Tiny recursive-descent parser for ``a + b * 2`` style expressions
    over named variables. ``join_operator`` and ``fill_missing`` carry
    the expression's pojo Join / NumericFillPolicy settings into every
    binary join (ref: pojo/Join.java SetOperator,
    expression/NumericFillPolicy.java)."""

    def __init__(self, text: str, join_operator: str = "union",
                 fill_missing: float = 0.0):
        self.tokens = self._tokenize(text)
        self.pos = 0
        self.join_operator = join_operator
        self.fill_missing = fill_missing

    @staticmethod
    def _tokenize(text: str):
        tokens = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m or m.end() == pos:
                if text[pos:].strip():
                    raise ValueError(
                        f"bad expression near: {text[pos:]!r}")
                break
            if m.group("num"):
                tokens.append(("num", float(m.group("num"))))
            elif m.group("id"):
                tokens.append(("id", m.group("id")))
            else:
                tokens.append(("op", m.group("op")))
            pos = m.end()
        return tokens

    def parse(self, variables: dict[str, SeriesFrame]) -> SeriesFrame:
        result = self._expr(variables)
        if self.pos != len(self.tokens):
            raise ValueError("trailing tokens in expression")
        if isinstance(result, float):
            raise ValueError("expression must reference a variable")
        return result

    def _peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) \
            else (None, None)

    def _expr(self, variables):
        left = self._term(variables)
        while self._peek() == ("op", "+") or self._peek() == ("op", "-"):
            op = self.tokens[self.pos][1]
            self.pos += 1
            right = self._term(variables)
            left = self._apply(left, right, op)
        return left

    def _term(self, variables):
        left = self._factor(variables)
        while self._peek() == ("op", "*") or self._peek() == ("op", "/"):
            op = self.tokens[self.pos][1]
            self.pos += 1
            right = self._factor(variables)
            left = self._apply(left, right, op)
        return left

    def _factor(self, variables):
        kind, val = self._peek()
        if kind == "op" and val == "(":
            self.pos += 1
            inner = self._expr(variables)
            if self._peek() != ("op", ")"):
                raise ValueError("missing ')'")
            self.pos += 1
            return inner
        if kind == "op" and val == "-":
            self.pos += 1
            inner = self._factor(variables)
            if isinstance(inner, float):
                return -inner
            return scalar_op(inner, -1.0, "*")
        if kind == "num":
            self.pos += 1
            return val
        if kind == "id":
            self.pos += 1
            if val not in variables:
                raise ValueError(f"unknown variable {val!r}")
            return variables[val]
        raise ValueError(f"unexpected token {val!r}")

    def _apply(self, left, right, op):
        if isinstance(left, float) and isinstance(right, float):
            return {"+": left + right, "-": left - right,
                    "*": left * right,
                    "/": left / right if right else 0.0}[op]
        if isinstance(left, float):
            return scalar_op(right, left, op, scalar_left=True)
        if isinstance(right, float):
            return scalar_op(left, right, op)
        return binary_op(left, right, op,
                         operator=self.join_operator,
                         fill_missing=self.fill_missing)


def evaluate_expression(text: str,
                        variables: dict[str, SeriesFrame],
                        join_operator: str = "union",
                        fill_missing: float = 0.0) -> SeriesFrame:
    return InfixParser(text, join_operator,
                       fill_missing).parse(variables)
