"""Rate / counter conversion (ref: ``src/core/RateSpan.java:21``,
``RateOptions.java:27``).

First difference dv/dt (per second) between a series' successive
*present* points over the ``[series, bucket]`` grid: each present cell
looks up the previous present cell of its own series, so holes (NaN)
are skipped like the reference's iterator skips to the prior datapoint.

Counter semantics (RateOptions):
- ``counter``: negative delta means rollover; corrected rate =
  (counter_max - prev + cur) / dt (RateSpan.java:150-170)
- ``drop_resets``: drop the rolled-over point instead
- ``reset_value``: corrected rates above this emit 0

The first present point of every series has no predecessor and produces
no rate (NaN).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from opentsdb_tpu_torch.ops.interp import carry_prev, shift_prev, under_carry


@dataclass(frozen=True)
class RateOptions:
    """(ref: RateOptions.java:27-52)"""
    counter: bool = False
    counter_max: float = float(2**64 - 1)
    reset_value: float = 0.0
    drop_resets: bool = False

    @classmethod
    def parse(cls, spec: str | None) -> "RateOptions":
        """Parse the query-string form ``rate{counter[,max[,reset]]}``
        (ref: QueryRpc parseRateOptions)."""
        if not spec or spec == "rate":
            return cls()
        if not (spec.startswith("rate{") and spec.endswith("}")):
            raise ValueError(f"invalid rate options: {spec}")
        parts = spec[5:-1].split(",")
        counter = parts[0] in ("counter", "dropcounter")
        drop = parts[0] == "dropcounter"
        counter_max = float(2**64 - 1)
        reset = 0.0
        if len(parts) >= 2 and parts[1]:
            counter_max = float(parts[1])
        if len(parts) >= 3 and parts[2]:
            reset = float(parts[2])
        return cls(counter=counter, counter_max=counter_max,
                   reset_value=reset, drop_resets=drop)

    def to_json(self) -> dict:
        return {"counter": self.counter, "counterMax": self.counter_max,
                "resetValue": self.reset_value,
                "dropResets": self.drop_resets}


def _rate_kernel(grid, bucket_ts, counter: bool, counter_max: float,
                 reset_value: float, drop_resets: bool, carry=None):
    """grid [S, B] (NaN = absent), bucket_ts [B] int64 relative ms ->
    per-second rates, NaN where a cell has no present predecessor.

    ``carry`` = (values [S], int64 times [S], present [S]): each series'
    last present cell before ``grid``'s buckets, when ``grid`` is one
    time block of a longer range; a cell with no present predecessor of
    its own in the block takes it."""
    nan = float("nan")
    mask = ~torch.isnan(grid)
    t_cur = bucket_ts[None, :]
    ts_row = t_cur.expand_as(grid)
    gz = torch.where(mask, grid, 0.0)
    pv, pt, pp = carry_prev((gz, ts_row), mask)
    v_prev, t_prev, has_prev = shift_prev((pv, pt, pp), (0.0, 0, False))
    if carry is not None:
        v_prev, t_prev, has_prev = under_carry((v_prev, t_prev, has_prev),
                                               carry)
    # integer timestamp differences before the float cast: exact
    dt_sec = (t_cur - t_prev).to(grid.dtype) / 1000.0
    dt_sec = torch.where(dt_sec > 0, dt_sec, 1.0)
    delta = grid - v_prev
    rate = delta / dt_sec
    if counter:
        rolled = delta < 0
        corrected = (counter_max - v_prev + grid) / dt_sec
        rate = torch.where(rolled, corrected, rate)
        if drop_resets:
            rate = torch.where(rolled, nan, rate)
        if reset_value > 0:
            rate = torch.where(rate > reset_value, 0.0, rate)
    return torch.where(mask & has_prev, rate, nan)
