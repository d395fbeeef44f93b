"""The port's calendar downsampling against the JAX package: the
calendar interval edges (``previous_interval_ms``/``next_interval_ms``),
``calendar_bucket_edges`` and ``assign_buckets`` over every unit, a
DST-crossing ``1dc`` window in ``America/New_York``, a ``1nc`` window
and ``useCalendar``, and whole calendar queries through both
``TSDB.execute_query``. The grid path declines calendar buckets in both
packages, so queries take the point path with the grid reduction on or
off.

Tolerance: float64 on both sides, rtol 1e-9 and atol 1e-9 * max|x|;
timestamps, NaN positions and emit masks equal.
"""

import zoneinfo

import numpy as np
import pytest

from opentsdb_tpu.ops import downsample as jds
from opentsdb_tpu.utils import datetime_util as jdt
from opentsdb_tpu_torch.ops import downsample as tds
from opentsdb_tpu_torch.utils import datetime_util as tdt
from torch_pair import (ENGINE_KEYS, GRID_ON, irregular, port_tsdb,
                        reference_tsdb, run_both, uri_query)

NY = "America/New_York"
# 2013-03-10 02:00 EST -> EDT, 2013-11-03 02:00 EDT -> EST
SPRING = 1362873600          # 2013-03-10 00:00 UTC
FALL = 1383436800            # 2013-11-03 00:00 UTC
ZONES = [None, NY, "Asia/Kolkata", "Australia/Lord_Howe"]
UNITS = [(250, "ms"), (30, "s"), (15, "m"), (2, "h"), (1, "d"), (3, "d"),
         (1, "w"), (1, "n"), (2, "n"), (1, "y")]


@pytest.mark.parametrize("tz", ZONES)
@pytest.mark.parametrize("interval,unit", UNITS)
def test_interval_edges(interval, unit, tz):
    rng = np.random.default_rng(interval)
    stamps = np.r_[SPRING * 1000 + rng.integers(0, 2 * 86_400_000, 6),
                   FALL * 1000 + rng.integers(0, 2 * 86_400_000, 6)]
    for ts in stamps.tolist():
        assert tdt.previous_interval_ms(ts, interval, unit, tz) == \
            jdt.previous_interval_ms(ts, interval, unit, tz)
        assert tdt.next_interval_ms(ts, interval, unit, tz) == \
            jdt.next_interval_ms(ts, interval, unit, tz)


@pytest.mark.parametrize("spec,start,end,tz", [
    ("1dc-sum", SPRING - 3 * 86_400, SPRING + 3 * 86_400, NY),   # DST on
    ("1dc-sum", FALL - 2 * 86_400, FALL + 2 * 86_400, NY),       # DST off
    ("1nc-avg", 1356998400, 1356998400 + 200 * 86_400, None),    # months
    ("1nc-avg", 1356998400, 1356998400 + 200 * 86_400, NY),
    ("1wc-max", SPRING - 20 * 86_400, SPRING + 20 * 86_400, NY),
    ("15mc-max", SPRING + 5 * 3600, SPRING + 9 * 3600, NY),
    ("6hc-min", SPRING - 86_400, SPRING + 86_400, NY),
    ("1hc-sum", FALL - 6 * 3600, FALL + 86_400, NY),             # DST off
    ("1yc-count", 1300000000, 1400000000, None),
    ("2n-sum", 1356998400, 1356998400 + 300 * 86_400, None),     # n: calendar
])
def test_calendar_buckets(spec, start, end, tz):
    """Edges and bucket assignment of calendar specs, the DST-crossing
    days 23 and 25 hours long."""
    tspec = tds.DownsamplingSpecification.parse(spec, tz)
    jspec = jds.DownsamplingSpecification.parse(spec, tz)
    assert (tspec.use_calendar, tspec.interval, tspec.unit) == \
        (jspec.use_calendar, jspec.interval, jspec.unit)
    rng = np.random.default_rng(1)
    ts = np.sort(rng.integers(start * 1000, end * 1000, 500))
    for a, b in zip(tds.assign_buckets(ts, tspec, start * 1000, end * 1000),
                    jds.assign_buckets(ts, jspec, start * 1000,
                                       end * 1000)):
        np.testing.assert_array_equal(a, b)
    edges = tds.calendar_bucket_edges(start * 1000, end * 1000,
                                      tspec.interval, tspec.unit, tz)
    np.testing.assert_array_equal(
        edges, jds.calendar_bucket_edges(start * 1000, end * 1000,
                                         jspec.interval, jspec.unit, tz))
    if spec.startswith("1dc") and tz == NY:
        days = set(np.diff(edges) // 3_600_000)
        assert days == ({23, 24} if start < SPRING + 86_400 and
                        SPRING < end else {24, 25})


@pytest.mark.parametrize("spec", ["15mc-avg", "6hc-min"])
def test_repeated_local_hour_raises(spec):
    """Sub-day calendar steps over the hour New York repeats when it
    sets its clocks back: the next edge falls at or before the last,
    and the reference's edge loop never ends (not called here). The
    port raises instead."""
    tspec = tds.DownsamplingSpecification.parse(spec, NY)
    with pytest.raises(ValueError, match="does not advance"):
        tds.calendar_bucket_edges(FALL * 1000, (FALL + 86_400) * 1000,
                                  tspec.interval, tspec.unit, NY)


def test_missing_zone_raises():
    """A zone the system database lacks raises; it never becomes UTC."""
    for mod in (tdt, jdt):
        with pytest.raises(zoneinfo.ZoneInfoNotFoundError):
            mod.previous_interval_ms(SPRING * 1000, 1, "d", "Mars/Olympus")
    with pytest.raises(zoneinfo.ZoneInfoNotFoundError):
        tds.calendar_bucket_edges(SPRING * 1000, SPRING * 1000 + 1, 1, "d",
                                  "Mars/Olympus")


# -- whole queries ------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    # 60 series, a point about every 20 minutes over the 6 days around
    # the spring DST change in New York; 30 series of a point about
    # every 6 hours over 200 days
    start = SPRING - 3 * 86_400
    metrics = {"d": irregular(60, 432, seed=31, t0=start, step=1200,
                              jitter=300),
               "mo": irregular(30, 800, seed=32, t0=1356998400,
                               step=21_600, jitter=3600)}
    jt = reference_tsdb(metrics)
    return jt, port_tsdb(jt, metrics)


SPRING_WINDOW = (SPRING - 3 * 86_400, SPRING + 3 * 86_400 - 1)
QUERIES = [
    ("avg:1dc-max:d{dc=*}", SPRING_WINDOW, NY, False),
    ("sum:1dc-sum:rate:d{dc=*}", SPRING_WINDOW, NY, False),
    ("p99:1dc-median:d{dc=*}", SPRING_WINDOW, NY, False),
    ("sum:6hc-last:d", SPRING_WINDOW, NY, False),
    ("avg:15mc-max:d{dc=*}", (SPRING + 5 * 3600, SPRING + 9 * 3600 - 1),
     NY, False),
    ("max:1d-avg:d{dc=*}", SPRING_WINDOW, NY, True),     # useCalendar
    ("sum:1nc-sum:mo{dc=*}", (1356998400, 1356998400 + 190 * 86_400),
     None, False),
    ("avg:1nc-count:mo", (1356998400, 1356998400 + 190 * 86_400), NY,
     False),
    ("dev:1wc-avg:mo{dc=*}", (1356998400, 1356998400 + 190 * 86_400),
     NY, False),
]


@pytest.mark.parametrize("grid", ["off", "on"])
@pytest.mark.parametrize("m,window,tz,use_calendar", QUERIES)
def test_calendar_query_matches_reference(pair, m, window, tz,
                                          use_calendar, grid):
    jt, tt = pair
    keys = GRID_ON if grid == "on" else ENGINE_KEYS
    for key, value in keys.items():
        jt.config.override_config(key, value)
        tt.config.override_config(key, value)
    extra = {"timezone": tz} if tz else {}
    if use_calendar:
        extra["useCalendar"] = True
    got = run_both(jt, tt, uri_query(m, window[0], window[1], **extra))
    assert any(len(r[3]) > 1 for r in got)


def test_prepared_batch_cache_keys_use_calendar(pair):
    """With the device cache on, ``1d-avg`` and the same downsample under
    ``useCalendar`` get their own prepared batches: the second answers
    with calendar days, as a cache-off call does. (The reference keys
    its prepared batches on the downsample string and time zone only,
    and serves the first batch's fixed days to the second query.)"""
    from opentsdb_tpu_torch.query.model import TSQuery
    from torch_pair import rows
    jt, _ = pair
    cached = port_tsdb(jt, ["d"], {**ENGINE_KEYS,
                                   "tsd.query.device_cache_mb": "64"})
    fresh = port_tsdb(jt, ["d"])
    q1 = uri_query("max:1d-avg:d", *SPRING_WINDOW, timezone=NY)
    q2 = dict(q1, useCalendar=True)
    plain = rows(cached.execute_query(TSQuery.from_json(q1).validate()))
    cal = rows(cached.execute_query(TSQuery.from_json(q2).validate()))
    want = rows(fresh.execute_query(TSQuery.from_json(q2).validate()))
    assert cal == want and cal[0][3] != plain[0][3]
