"""Date/time parsing (ref: ``src/utils/DateTime.java``).

Relative ``<n><unit>-ago``, ``now``, unix seconds / milliseconds /
``sec.ms``, ``<n>ms`` raw milliseconds, and the absolute formats
``yyyy/MM/dd[ -]HH:mm[:ss]`` with optional timezone, and the
calendar-aligned interval edges of ``c``-suffixed downsamples. All
functions return milliseconds. A timezone name that the system zone
database does not hold raises (``zoneinfo.ZoneInfoNotFoundError``);
no zone means UTC.
"""

from __future__ import annotations

import re
import time as _time
from datetime import datetime, timedelta, timezone
from zoneinfo import ZoneInfo

# duration multipliers in seconds (ref: DateTime.java:207-217)
_MULTIPLIERS = {
    "ms": 0.001,
    "s": 1,
    "m": 60,
    "h": 3600,
    "d": 3600 * 24,
    "w": 3600 * 24 * 7,
    "n": 3600 * 24 * 30,   # month (average)
    "y": 3600 * 24 * 365,  # year (no leap handling, matches reference)
}

_DURATION_RE = re.compile(r"^(\d+)(ms|[smhdwny])$")
_ALL_MS_RE = re.compile(r"^[0-9]+ms$")


def parse_duration_ms(duration: str) -> int:
    """Parse ``60s``/``10m``/``1ms`` etc. to milliseconds
    (ref: DateTime.parseDuration, DateTime.java:186-226)."""
    m = _DURATION_RE.match(duration)
    if not m:
        raise ValueError(f"Invalid duration: {duration}")
    interval = int(m.group(1))
    if interval <= 0:
        raise ValueError(f"Zero or negative duration: {duration}")
    unit = m.group(2)
    if unit == "ms":
        return interval
    return int(interval * _MULTIPLIERS[unit] * 1000)


def duration_unit(duration: str) -> str:
    """The unit suffix of a duration (ref: DateTime.getDurationUnits)."""
    m = _DURATION_RE.match(duration)
    if not m:
        raise ValueError(f"Invalid duration: {duration}")
    return m.group(2)


def duration_interval(duration: str) -> int:
    """The numeric prefix of a duration (ref: DateTime.getDurationInterval)."""
    m = _DURATION_RE.match(duration)
    if not m:
        raise ValueError(f"Invalid duration: {duration}")
    return int(m.group(1))


def parse_datetime_ms(value: str, tz: str | None = None,
                      now_ms: int | None = None) -> int:
    """Parse any reference-accepted time string to unix milliseconds
    (ref: DateTime.parseDateTimeString, DateTime.java:75-160)."""
    if value is None or value == "":
        return -1
    if _ALL_MS_RE.match(value):
        return int(value[:-2])
    lowered = value.lower()
    now = int(_time.time() * 1000) if now_ms is None else now_ms
    if lowered == "now":
        return now
    if lowered.endswith("-ago"):
        return now - parse_duration_ms(value[:-4])
    if "/" in value or ":" in value:
        return _parse_absolute(value, tz)
    # numeric: seconds, milliseconds, or seconds.millis
    if "." in value:
        if not re.match(r"^[0-9]{10}\.[0-9]{1,3}$", value):
            raise ValueError(f"Invalid time: {value}")
        sec, _, ms = value.partition(".")
        return int(sec) * 1000 + int(ms.ljust(3, "0"))
    try:
        t = int(value)
    except ValueError:
        raise ValueError(f"Invalid time: {value}") from None
    if t < 0:
        raise ValueError(f"Invalid time (negative): {value}")
    # 13+ digits = already ms (ref: DateTime.java numeric branch)
    return t if len(value) >= 13 else t * 1000


def _parse_absolute(value: str, tz: str | None) -> int:
    fmts = {
        10: ["%Y/%m/%d"],
        16: ["%Y/%m/%d-%H:%M", "%Y/%m/%d %H:%M"],
        19: ["%Y/%m/%d-%H:%M:%S", "%Y/%m/%d %H:%M:%S"],
    }
    candidates = fmts.get(len(value))
    if not candidates:
        raise ValueError(f"Invalid absolute date: {value}")
    zone = ZoneInfo(tz) if tz else datetime.now().astimezone().tzinfo
    for fmt in candidates:
        try:
            dt = datetime.strptime(value, fmt).replace(tzinfo=zone)
            return int(dt.timestamp() * 1000)
        except ValueError:
            continue
    raise ValueError(f"Invalid date: {value}")


# --- calendar-aligned downsample buckets (ref: DateTime.previousInterval,
# DateTime.java:394-470) ----------------------------------------------------

def previous_interval_ms(ts_ms: int, interval: int, unit: str,
                         tz: str | None = None) -> int:
    """Snap ``ts_ms`` down to the previous calendar-aligned interval start.

    Units follow the reference: ms/s/m/h align within the day; d aligns to
    midnight; w aligns to start-of-week (Sunday, per java.util.Calendar
    defaults); n aligns to the 1st of the month; y to Jan 1.
    """
    zone = ZoneInfo(tz) if tz else timezone.utc
    dt = datetime.fromtimestamp(ts_ms / 1000, zone)
    if unit == "ms":
        ms_of_sec = ts_ms % 1000
        return ts_ms - (ms_of_sec % interval)
    if unit == "s":
        base = dt.replace(microsecond=0)
        sec_of_day = base.hour * 3600 + base.minute * 60 + base.second
        snapped = sec_of_day - (sec_of_day % interval)
        day0 = base.replace(hour=0, minute=0, second=0)
        return int((day0 + timedelta(seconds=snapped)).timestamp() * 1000)
    if unit == "m":
        base = dt.replace(second=0, microsecond=0)
        min_of_day = base.hour * 60 + base.minute
        snapped = min_of_day - (min_of_day % interval)
        day0 = base.replace(hour=0, minute=0)
        return int((day0 + timedelta(minutes=snapped)).timestamp() * 1000)
    if unit == "h":
        base = dt.replace(minute=0, second=0, microsecond=0)
        snapped = base.hour - (base.hour % interval)
        return int(base.replace(hour=snapped).timestamp() * 1000)
    if unit == "d":
        day0 = dt.replace(hour=0, minute=0, second=0, microsecond=0)
        return int(day0.timestamp() * 1000)
    if unit == "w":
        day0 = dt.replace(hour=0, minute=0, second=0, microsecond=0)
        # java.util.Calendar weeks start on Sunday
        days_back = (day0.weekday() + 1) % 7
        return int((day0 - timedelta(days=days_back)).timestamp() * 1000)
    if unit == "n":
        m0 = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        return int(m0.timestamp() * 1000)
    if unit == "y":
        y0 = dt.replace(month=1, day=1, hour=0, minute=0, second=0,
                        microsecond=0)
        return int(y0.timestamp() * 1000)
    raise ValueError(f"unknown calendar unit {unit!r}")


def next_interval_ms(ts_ms: int, interval: int, unit: str,
                     tz: str | None = None) -> int:
    """The start of the calendar interval after the one containing ts_ms."""
    zone = ZoneInfo(tz) if tz else timezone.utc
    start = previous_interval_ms(ts_ms, interval, unit, tz)
    if unit in ("ms", "s", "m", "h"):
        step = int(_MULTIPLIERS[unit] * 1000) * interval
        return start + step
    dt = datetime.fromtimestamp(start / 1000, zone)
    if unit in ("d", "w"):
        # advance by calendar days, re-anchoring at local midnight —
        # a fixed 86400s step drifts an hour across DST transitions
        days = interval * (7 if unit == "w" else 1)
        target = (dt.date() + timedelta(days=days))
        dt = datetime(target.year, target.month, target.day,
                      tzinfo=zone)
        return int(dt.timestamp() * 1000)
    if unit == "n":
        month = dt.month - 1 + interval
        dt = dt.replace(year=dt.year + month // 12, month=month % 12 + 1)
    elif unit == "y":
        dt = dt.replace(year=dt.year + interval)
    return int(dt.timestamp() * 1000)
