"""Per-metric query guardrails
(ref: ``src/query/QueryLimitOverride.java:52``).

Default byte / datapoint caps come from config
(``tsd.query.limits.bytes.default`` / ``.data_points.default``, 0 =
disabled); per-metric overrides are regex-matched items loaded from a
JSON file (``tsd.query.limits.overrides.config``) that is re-read when
its mtime changes, checked at most every
``tsd.query.limits.overrides.interval`` seconds (the reference reloads
on a HashedWheelTimer; polling the mtime on access is the timer-free
equivalent). The engine checks the limits on every path that scans:
the point path after it materializes, a prepared-batch hit with the
count it cached, and the grid path after the storage-side reduction.

Enforcement happens in the query engine right after the scan phase
counts points (the analogue of SaltScanner's per-scanner byte/dp
accounting, ``SaltScanner.java:660``): bytes are estimated at 16 per
point (8B timestamp + 8B value column), since storage here is the
in-memory column store, not HBase cells.

Override file format (same fields as QueryLimitOverrideItem)::

    [{"regex": "^sys\\..*", "byteLimit": 0, "dataPointsLimit": 1000}]
"""

from __future__ import annotations

import json
import os
import re
import time

BYTES_PER_DP = 16


class QueryLimitExceeded(RuntimeError):
    """(ref: the IllegalStateException raised by SaltScanner when a
    query blows its byte/dp budget)"""


class QueryLimitOverride:
    """(ref: QueryLimitOverride.java:90)"""

    def __init__(self, config):
        self.default_byte_limit = config.get_int(
            "tsd.query.limits.bytes.default", 0)
        self.default_data_points_limit = config.get_int(
            "tsd.query.limits.data_points.default", 0)
        if self.default_byte_limit < 0:
            raise ValueError("The default byte limit cannot be negative")
        if self.default_data_points_limit < 0:
            raise ValueError(
                "The default data points limit cannot be negative")
        self.file_location = config.get_string(
            "tsd.query.limits.overrides.config", "")
        self.reload_interval = config.get_int(
            "tsd.query.limits.overrides.interval", 0)
        self._overrides: list[tuple[re.Pattern, int, int]] = []
        self._loaded_mtime = 0.0
        self._next_check = 0.0
        if self.file_location:
            self._load()

    # -- file loading ---------------------------------------------------

    def _load(self) -> None:
        try:
            mtime = os.path.getmtime(self.file_location)
        except OSError:
            return
        if mtime == self._loaded_mtime:
            return
        try:
            with open(self.file_location, encoding="utf-8") as fh:
                items = json.load(fh)
        except (OSError, ValueError):
            # keep serving the previous overrides (ref: loadFromFile
            # logs and returns on parse errors)
            return
        overrides = []
        for item in items:
            regex = item.get("regex", "")
            if not regex:
                continue
            overrides.append((re.compile(regex),
                              int(item.get("byteLimit", 0)),
                              int(item.get("dataPointsLimit", 0))))
        self._overrides = overrides
        self._loaded_mtime = mtime

    def _maybe_reload(self) -> None:
        if not self.file_location or self.reload_interval <= 0:
            return
        now = time.monotonic()
        if now >= self._next_check:
            self._next_check = now + self.reload_interval
            self._load()

    # -- lookups (ref: getByteLimit :137 / getDataPointLimit :158) ------

    def get_byte_limit(self, metric: str) -> int:
        self._maybe_reload()
        if metric:
            for pattern, byte_limit, _ in self._overrides:
                if pattern.search(metric):
                    return byte_limit
        return self.default_byte_limit

    def get_data_point_limit(self, metric: str) -> int:
        self._maybe_reload()
        if metric:
            for pattern, _, dp_limit in self._overrides:
                if pattern.search(metric):
                    return dp_limit
        return self.default_data_points_limit

    # -- enforcement ----------------------------------------------------

    def check(self, metric: str, num_points: int) -> None:
        """Raise QueryLimitExceeded when the scan result for ``metric``
        exceeds its datapoint or (estimated) byte budget."""
        dp_limit = self.get_data_point_limit(metric)
        if dp_limit > 0 and num_points > dp_limit:
            raise QueryLimitExceeded(
                f"Sorry, you have attempted to fetch more than our "
                f"limit of {dp_limit} data points for metric "
                f"{metric!r} (got {num_points}). Please try "
                f"filtering using more tags or decrease your time "
                f"range.")
        byte_limit = self.get_byte_limit(metric)
        est = num_points * BYTES_PER_DP
        if byte_limit > 0 and est > byte_limit:
            raise QueryLimitExceeded(
                f"Sorry, you have attempted to fetch more than our "
                f"limit of {byte_limit} bytes for metric {metric!r} "
                f"(estimated {est}). Please try filtering using more "
                f"tags or decrease your time range.")
