"""The aggregation registry (ref: ``src/core/Aggregators.java``).

Every reference aggregator name with its merge-time interpolation mode
(``Aggregators.Interpolation`` :38-44), and the NaN-aware reductions
along one axis of a tensor for the non-percentile aggregators. NaN
encodes "no value for this series at this bucket":

- ``sum``/``zimsum``: sum of non-NaN, all-NaN -> NaN (Sum.runDouble)
- ``avg``: mean of non-NaN, all-NaN -> NaN
- ``dev``: population stddev, one value -> 0, none -> NaN
- ``diff``: last non-NaN minus first non-NaN, single -> 0 (Diff)
- ``count``: number of non-NaN values (Count.runDouble)
- ``first``/``last``: first/last entry along the axis with a value
- ``multiply``: product; ``squareSum``: sum of squares

Median and the percentile family keep their registry entries, but
their reductions raise NotImplementedError: they arrive with a later
slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Callable

import torch


class Interpolation(Enum):
    """(ref: Aggregators.Interpolation :38-44)"""
    LERP = "lerp"
    ZIM = "zim"    # zero if missing
    MAX = "max"    # type max if missing (used by mimmin)
    MIN = "min"    # type min if missing (used by mimmax)
    PREV = "prev"  # previous value if missing (pfsum)


def _valid(x):
    return ~torch.isnan(x)


def _nan_where_empty(result, x, axis):
    return torch.where(_valid(x).any(dim=axis), result,
                       torch.full_like(result, float("nan")))


def agg_sum(x, axis=0):
    return _nan_where_empty(torch.nansum(x, dim=axis), x, axis)


def agg_min(x, axis=0):
    return _nan_where_empty(
        torch.where(_valid(x), x, torch.inf).amin(dim=axis), x, axis)


def agg_max(x, axis=0):
    return _nan_where_empty(
        torch.where(_valid(x), x, -torch.inf).amax(dim=axis), x, axis)


def agg_avg(x, axis=0):
    cnt = _valid(x).sum(dim=axis)
    total = torch.nansum(x, dim=axis)
    return torch.where(cnt > 0, total / cnt.clamp(min=1),
                       torch.full_like(total, float("nan")))


def agg_count(x, axis=0):
    return _valid(x).sum(dim=axis).to(x.dtype)


def agg_multiply(x, axis=0):
    return _nan_where_empty(
        torch.where(_valid(x), x, 1.0).prod(dim=axis), x, axis)


def agg_squaresum(x, axis=0):
    return _nan_where_empty(torch.nansum(x * x, dim=axis), x, axis)


def agg_dev(x, axis=0):
    """POPULATION standard deviation (divisor n), matching the
    reference (ref: Aggregators.StdDev :498). 0 for a single value, NaN
    for none; mean-shifted two-pass formula, clamped at 0."""
    valid = _valid(x)
    cnt = valid.sum(dim=axis)
    safe_cnt = cnt.clamp(min=1)
    mean = torch.nansum(x, dim=axis) / safe_cnt
    centered = torch.where(valid, x - mean.unsqueeze(axis), 0.0)
    var = (centered * centered).sum(dim=axis) / safe_cnt
    dev = torch.sqrt(var.clamp(min=0.0))
    nan = torch.full_like(dev, float("nan"))
    return torch.where(cnt == 0, nan,
                       torch.where(cnt == 1, torch.zeros_like(dev), dev))


def _first_last_positions(x, axis):
    s = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = s
    pos = torch.arange(s, device=x.device).reshape(shape)
    first_pos = torch.where(_valid(x), pos, s).amin(dim=axis)
    last_pos = torch.where(_valid(x), pos, -1).amax(dim=axis)
    return first_pos, last_pos


def _pick(x, pos, axis):
    safe = pos.clamp(0, x.shape[axis] - 1).unsqueeze(axis)
    return torch.gather(x, axis, safe).squeeze(axis)


def agg_first(x, axis=0):
    first_pos, _ = _first_last_positions(x, axis)
    picked = _pick(x, first_pos, axis)
    return torch.where(first_pos < x.shape[axis], picked,
                       torch.full_like(picked, float("nan")))


def agg_last(x, axis=0):
    _, last_pos = _first_last_positions(x, axis)
    picked = _pick(x, last_pos, axis)
    return torch.where(last_pos >= 0, picked,
                       torch.full_like(picked, float("nan")))


def agg_diff(x, axis=0):
    """last non-NaN - first non-NaN; exactly one value -> 0; none -> NaN
    (ref: Aggregators.Diff :576)."""
    cnt = _valid(x).sum(dim=axis)
    d = agg_last(x, axis) - agg_first(x, axis)
    nan = torch.full_like(d, float("nan"))
    return torch.where(cnt == 0, nan,
                       torch.where(cnt == 1, torch.zeros_like(d), d))


def _not_ported(x, axis=0):
    raise NotImplementedError(
        "median and percentile aggregators are not ported yet")


@dataclass(frozen=True)
class Aggregator:
    """One aggregation function + its merge-time interpolation mode."""
    name: str
    interpolation: Interpolation
    reduce: Callable  # (x[S,B], axis) -> [B]
    percentile: float | None = None
    estimation: str | None = None

    def __call__(self, x, axis=0):
        return self.reduce(x, axis=axis)

    @property
    def is_none(self) -> bool:
        return self.name == "none"


def _agg_none(x, axis=0):
    raise RuntimeError(
        "'none' must not be aggregated; the pipeline emits raw series")


_REGISTRY: dict[str, Aggregator] = {}


def _register(agg: Aggregator) -> Aggregator:
    _REGISTRY[agg.name] = agg
    return agg


# Registration mirrors Aggregators.java:47-172 name-for-name.
SUM = _register(Aggregator("sum", Interpolation.LERP, agg_sum))
PFSUM = _register(Aggregator("pfsum", Interpolation.PREV, agg_sum))
MIN = _register(Aggregator("min", Interpolation.LERP, agg_min))
MAX = _register(Aggregator("max", Interpolation.LERP, agg_max))
AVG = _register(Aggregator("avg", Interpolation.LERP, agg_avg))
MEDIAN = _register(Aggregator("median", Interpolation.LERP, _not_ported))
NONE = _register(Aggregator("none", Interpolation.ZIM, _agg_none))
MULTIPLY = _register(Aggregator("multiply", Interpolation.LERP,
                                agg_multiply))
# the query-facing registry name is "mult" (Aggregators.java:183)
_REGISTRY["mult"] = MULTIPLY
DEV = _register(Aggregator("dev", Interpolation.LERP, agg_dev))
DIFF = _register(Aggregator("diff", Interpolation.LERP, agg_diff))
ZIMSUM = _register(Aggregator("zimsum", Interpolation.ZIM, agg_sum))
MIMMIN = _register(Aggregator("mimmin", Interpolation.MAX, agg_min))
MIMMAX = _register(Aggregator("mimmax", Interpolation.MIN, agg_max))
SQUARESUM = _register(Aggregator("squareSum", Interpolation.ZIM,
                                 agg_squaresum))
COUNT = _register(Aggregator("count", Interpolation.ZIM, agg_count))
FIRST = _register(Aggregator("first", Interpolation.ZIM, agg_first))
LAST = _register(Aggregator("last", Interpolation.ZIM, agg_last))

for _q, _name in ((99.9, "p999"), (99.0, "p99"), (95.0, "p95"),
                  (90.0, "p90"), (75.0, "p75"), (50.0, "p50")):
    _register(Aggregator(_name, Interpolation.LERP, _not_ported,
                         percentile=_q, estimation="legacy"))
    for _est in ("r3", "r7"):
        _register(Aggregator(f"e{_name}{_est}", Interpolation.LERP,
                             _not_ported, percentile=_q,
                             estimation=_est))


def get(name: str) -> Aggregator:
    """(ref: Aggregators.get :222)"""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"No such aggregator: {name}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


def exists(name: str) -> bool:
    return name in _REGISTRY
