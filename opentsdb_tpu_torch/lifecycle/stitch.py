"""Stitched read view: cold disk segments + rollup-tier history + raw
tail across the spill and demotion boundaries (ref:
``opentsdb_tpu/lifecycle/stitch.py``).

After age-based demotion, raw points older than a metric's demotion
boundary exist only in the rollup tiers; the raw store keeps the tail.
After a cold spill, the oldest tier history lives in mmap-backed disk
segments (:mod:`opentsdb_tpu_torch.coldstore`) instead of RAM. A query
spanning the boundaries reads all three through one
``TimeSeriesStore``-shaped object, which the query engine selects
exactly like a plain tier store, so every path that selects a store
(the point path's K1 and K2, the grid path's ``bucket_reduce``, the
blocked path, the mesh branches) reads it:

- series identity (sids, metric index, tag matrices) is the RAW
  store's: every live series has a raw record even when all its points
  were demoted, so filters, group-by and result assembly are unchanged;
- reads split at ``spill_boundary_ms`` and ``boundary_ms``: cold
  segments serve ``[start, spill)``, the in-RAM tier serves ``[spill,
  boundary)`` (raw sids mapped to tier sids by (metric, tags)
  identity; the cold view does its own identity mapping) and the raw
  store serves ``[boundary, end]``;
- ``bucket_reduce`` combines the parts channel-wise over one bucket
  grid, so the grid path (and the avg sum/count division) is
  value-identical to an undemoted store for decomposable downsample
  functions; ``materialize`` and ``materialize_padded`` give each row
  its cold, tier and raw points in time order, padded as the raw store
  pads (NaN values, zero timestamps), which the point path's span
  layout needs.

``tail_stat`` names the statistic the tier's point VALUES carry, so
the raw tail contributes the matching channel: a ``count`` tier's
stitched view materializes tail points with value 1.0 (summing them
counts them) and adds raw bucket counts into the sums channel of
``bucket_reduce``.

Versioning: ``version`` holds the raw, tier and cold versions and both
boundaries, and instances are cached per (metric, tier, agg, boundary)
by the lifecycle manager, so a sweep or a write to any part changes the
key of every read-side cache (result cache, device grid cache,
prepared-batch pools).

A failed cold read (corrupt segment, disk error, armed
``coldstore.read`` fault) or an open cold read breaker raises
:class:`~opentsdb_tpu_torch.utils.faults.DegradedError`, which the
front end answers with a structured 503 and ``Retry-After``. The
reference's guard serves the tier and raw parts alone there (partial
history, 200); the port never answers with part of the range it was
asked for (ROADMAP Queue 3 item 21). Both bump the cold
``mutation_epoch``, through the same counters.
"""

from __future__ import annotations

import threading

import numpy as np

from opentsdb_tpu_torch.core.store import (_INSTANCE_IDS, PaddedBatch,
                                           PointBatch)
from opentsdb_tpu_torch.utils.faults import DegradedError

_TAIL_STATS = ("sum", "count", "min", "max")


def _cold_failed(cold, exc: Exception, breaker) -> DegradedError:
    """Count one failed cold read (breaker, read errors, epoch) and the
    503 that answers it."""
    if breaker is not None:
        breaker.record_failure()
    cold.note_read_error(exc)
    return DegradedError(
        f"cold segment read failed ({type(exc).__name__}: {exc}); the "
        "query would miss its spilled history", retry_after_s=1)


def _cold_blocked(cold) -> DegradedError:
    cold.note_degraded_serve()
    return DegradedError("the cold read breaker is open; the query "
                         "would miss its spilled history",
                         retry_after_s=1)


def guarded_sketch_rows(cold, metric: str, start_ms: int, end_ms: int
                        ) -> tuple[list, bool]:
    """Cold sketch-column read behind the same guard as
    :meth:`StitchedStore._cold` (ref: ``guarded_sketch_rows``): an open
    read breaker or a failed read raises DegradedError, where the
    reference returns ``([], False)`` and serves the remaining zones.
    Returns ``(rows, True)``."""
    breaker = getattr(cold, "read_breaker", None)
    if breaker is not None and not breaker.allow():
        raise _cold_blocked(cold)
    try:
        rows = cold.sketch_rows(metric, None, start_ms, end_ms)
    except Exception as exc:  # noqa: BLE001 - counted, then a 503
        raise _cold_failed(cold, exc, breaker) from exc
    if breaker is not None:
        breaker.record_success()
    return rows, True


def sketch_zone_read(tsdb, metric: str, metric_id: int,
                     start_ms: int, end_ms: int):
    """The sketch twin of the stitched three-way read (ref:
    ``sketch_zone_read``): per-series quantile sketches split at the
    spill and demotion boundaries.

    Returns ``(items, raw_rng, cold_ok)``:

    - ``items``: ``(tags_names_tuple, cell_ts, DDSketch)`` rows from
      the cold segments' sketch column (``cell_ts < spill_b``) and the
      in-RAM sketch tier (``spill_b <= cell_ts < demote_b``). The zone
      split is by cell timestamp, so a RAM cell whose spilled disk
      duplicate still lingers (crash reconciliation) is counted once.
    - ``raw_rng``: the ``[demote_b, end]`` raw-tail window the caller
      folds itself (None when the window ends before the boundary).
    - ``cold_ok``: True. A cold zone that cannot be read (breaker
      open, read error, undecodable blob) raises DegradedError; the
      reference returns False there and serves the rest.
    """
    from opentsdb_tpu_torch.sketch.ddsketch import DDSketch, SketchError
    lc = tsdb.lifecycle
    sketches = getattr(lc, "sketches", None) if lc is not None \
        else None
    demote_b = lc.demote_boundary(metric_id) if lc is not None else 0
    cold = getattr(lc, "coldstore", None) if lc is not None else None
    spill_b = 0
    if cold is not None and sketches is not None and demote_b:
        # same clamp as StitchedStore: cold never serves past the
        # demotion boundary
        spill_b = min(cold.spill_boundary(metric), demote_b)
    items: list[tuple[tuple, int, DDSketch]] = []
    cold_ok = True
    if spill_b and start_ms < spill_b:
        rows, cold_ok = guarded_sketch_rows(
            cold, metric, start_ms, min(end_ms, spill_b - 1))
        for tags, cts, blob in rows:
            try:
                items.append((tags, cts, DDSketch.from_bytes(blob)))
            except (SketchError, ValueError) as exc:
                raise _cold_failed(cold, exc, None) from exc
    if sketches is not None and demote_b:
        lo = max(start_ms, spill_b)
        hi = min(end_ms, demote_b - 1)
        if lo <= hi:
            items.extend(sketches.cells(metric, lo, hi))
    raw_lo = max(start_ms, demote_b)
    raw_rng = (raw_lo, end_ms) if raw_lo <= end_ms else None
    return items, raw_rng, cold_ok


class StitchedStore:
    """(see module docstring; ref: ``StitchedStore``)"""

    fault_site = "store"

    def __init__(self, raw_store, tier_store, metric_id: int,
                 boundary_ms: int, tail_stat: str, cold=None,
                 spill_boundary_ms: int = 0, cold_store=None):
        if tail_stat not in _TAIL_STATS:
            raise ValueError(f"bad tail_stat {tail_stat!r}")
        self.instance_id = next(_INSTANCE_IDS)
        self.raw = raw_store
        self.tier = tier_store
        self.metric_id = metric_id
        self.boundary_ms = int(boundary_ms)
        self.tail_stat = tail_stat
        # cold third (ColdStatView) + its owning ColdStore (breaker,
        # read-failure counters). The spill boundary is CLAMPED to the
        # demotion boundary: a manifest claiming more would make cold
        # and raw both serve [boundary, spill) — the one invariant a
        # corrupt manifest must not break (fsck reports the excess).
        self.cold = cold
        self.cold_store = cold_store
        self.spill_boundary_ms = min(int(spill_boundary_ms),
                                     self.boundary_ms) \
            if cold is not None else 0
        self._map_lock = threading.Lock()
        # raw sid -> tier sid map, versioned by both stores' series
        # counts (identity indexes are append-only)
        self._sid_map: tuple | None = None

    # -- identity surface: the RAW store's ---------------------------------

    @property
    def fault_injector(self):
        return self.raw.fault_injector

    @property
    def points_written(self) -> int:
        n = self.raw.points_written + self.tier.points_written
        if self.cold is not None:
            n += self.cold.points_written
        return n

    @property
    def mutation_epoch(self) -> int:
        e = (getattr(self.raw, "mutation_epoch", 0)
             + getattr(self.tier, "mutation_epoch", 0))
        if self.cold is not None:
            e += self.cold.mutation_epoch
        return e

    @property
    def version(self) -> tuple:
        """The parts' versions and both boundaries: a write, a delete or
        a sweep to any part, or a moved boundary, changes it."""
        cold = self.cold.version if self.cold is not None else (0, 0)
        return (*self.raw.version, *self.tier.version, *cold,
                self.boundary_ms, self.spill_boundary_ms)

    def series(self, series_id: int):
        return self.raw.series(series_id)

    def num_series(self) -> int:
        return self.raw.num_series()

    def metric_ids(self):
        return self.raw.metric_ids()

    def metric_index(self, metric_id: int):
        return self.raw.metric_index(metric_id)

    def series_ids_for_metric(self, metric_id: int) -> np.ndarray:
        return self.raw.series_ids_for_metric(metric_id)

    def total_points(self) -> int:
        n = self.raw.total_points() + self.tier.total_points()
        if self.cold is not None:
            n += self.cold.total_points()
        return n

    # -- sid mapping --------------------------------------------------------

    def _tier_sids(self, sids: np.ndarray) -> np.ndarray:
        """Tier sid per raw sid (-1 when the tier never saw the
        series). Cached over the full metric, invalidated by either
        index growing."""
        from opentsdb_tpu_torch.query.engine import _match_series_by_tags
        key = (self.raw.num_series(), self.tier.num_series())
        with self._map_lock:
            cached = self._sid_map
            if cached is None or cached[0] != key:
                all_raw = self.raw.series_ids_for_metric(self.metric_id)
                mapped = _match_series_by_tags(
                    self.raw, self.tier, all_raw, self.metric_id)
                order = np.argsort(all_raw, kind="stable")
                cached = (key, all_raw[order], mapped[order])
                self._sid_map = cached
        _, sorted_raw, sorted_tier = cached
        sids = np.asarray(sids, dtype=np.int64)
        if len(sorted_raw) == 0:
            return np.full(len(sids), -1, dtype=np.int64)
        pos = np.searchsorted(sorted_raw, sids)
        pos_c = np.minimum(pos, len(sorted_raw) - 1)
        hit = sorted_raw[pos_c] == sids
        return np.where(hit, sorted_tier[pos_c], -1)

    def _split(self, start_ms: int, end_ms: int):
        """(cold_range | None, tier_range | None, raw_range | None)
        for one request. With no cold third the spill boundary is 0
        and the cold range is always None."""
        b = self.boundary_ms
        s = self.spill_boundary_ms
        cold_rng = (start_ms, min(end_ms, s - 1)) \
            if s and start_ms < s else None
        tier_lo = max(start_ms, s)
        tier_rng = (tier_lo, min(end_ms, b - 1)) \
            if tier_lo < b and tier_lo <= end_ms else None
        raw_rng = (max(start_ms, b), end_ms) if end_ms >= b else None
        return cold_rng, tier_rng, raw_rng

    def _cold(self, fn_name: str, *args):
        """Run one cold read behind the guard (ref: ``_cold``): an open
        read breaker, or a failure, raises DegradedError (a 503) after
        the counters and the cold epoch note it. The reference returns
        None there and serves the tier and raw parts alone."""
        cs = self.cold_store
        breaker = getattr(cs, "read_breaker", None) \
            if cs is not None else None
        if breaker is not None and not breaker.allow():
            raise _cold_blocked(cs)
        try:
            out = getattr(self.cold, fn_name)(*args)
        except Exception as exc:  # noqa: BLE001 - counted, then a 503
            if cs is None:
                raise
            raise _cold_failed(cs, exc, breaker) from exc
        if breaker is not None:
            breaker.record_success()
        return out

    # -- reads --------------------------------------------------------------

    def count_range(self, series_ids, start_ms: int,
                    end_ms: int) -> np.ndarray:
        sids = np.asarray(series_ids, dtype=np.int64)
        out = np.zeros(len(sids), dtype=np.int64)
        cold_rng, tier_rng, raw_rng = self._split(start_ms, end_ms)
        if raw_rng is not None:
            out += self.raw.count_range(sids, *raw_rng)
        if tier_rng is not None:
            tsids = self._tier_sids(sids)
            present = np.nonzero(tsids >= 0)[0]
            if len(present):
                out[present] += self.tier.count_range(
                    tsids[present], *tier_rng)
        if cold_rng is not None:
            out += self._cold("count_range", sids, *cold_rng)
        return out

    def bucket_reduce(self, series_ids, start_ms: int, end_ms: int,
                      t0: int, interval_ms: int, nbuckets: int,
                      want_minmax: bool = False):
        """Channel-wise combination of the cold segments, the tier
        part and the raw tail over ONE shared bucket grid (same
        t0/interval/nbuckets for all, so a bucket straddling a
        boundary sums exactly)."""
        sids = np.asarray(series_ids, dtype=np.int64)
        s = len(sids)
        sums = np.zeros((s, nbuckets))
        cnts = np.zeros((s, nbuckets))
        mins = maxs = None
        if want_minmax:
            mins = np.full((s, nbuckets), np.inf)
            maxs = np.full((s, nbuckets), -np.inf)
        cold_rng, tier_rng, raw_rng = self._split(start_ms, end_ms)
        if cold_rng is not None:
            # cold cells carry the same statistic as the tier's (the
            # segment stores all four stat columns; this view reads
            # the matching one), so they combine exactly like tier
            # cells — no tail_stat conversion
            c_sums, c_cnts, c_mins, c_maxs = self._cold(
                "bucket_reduce", sids, cold_rng[0], cold_rng[1], t0,
                interval_ms, nbuckets, want_minmax)
            sums += c_sums
            cnts += c_cnts
            if want_minmax:
                np.minimum(mins, c_mins, out=mins)
                np.maximum(maxs, c_maxs, out=maxs)
        if tier_rng is not None:
            tsids = self._tier_sids(sids)
            present = np.nonzero(tsids >= 0)[0]
            if len(present):
                t_sums, t_cnts, t_mins, t_maxs = \
                    self.tier.bucket_reduce(
                        tsids[present], tier_rng[0], tier_rng[1], t0,
                        interval_ms, nbuckets, want_minmax=want_minmax)
                sums[present] += t_sums
                cnts[present] += t_cnts
                if want_minmax:
                    # fancy indexing copies: assign back, don't `out=`
                    mins[present] = np.minimum(mins[present], t_mins)
                    maxs[present] = np.maximum(maxs[present], t_maxs)
        if raw_rng is not None:
            r_sums, r_cnts, r_mins, r_maxs = self.raw.bucket_reduce(
                sids, raw_rng[0], raw_rng[1], t0, interval_ms,
                nbuckets, want_minmax=want_minmax)
            # the raw tail contributes the statistic this tier's point
            # values carry: counting a count-tier's tail means adding
            # raw bucket COUNTS into the sums channel
            sums += r_cnts if self.tail_stat == "count" else r_sums
            cnts += r_cnts
            if want_minmax:
                np.minimum(mins, r_mins, out=mins)
                np.maximum(maxs, r_maxs, out=maxs)
        return sums, cnts, mins, maxs

    def _parts(self, sids: np.ndarray, start_ms: int, end_ms: int
               ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Each zone's points, oldest zone first, as ``(series_idx,
        ts_ms, values)`` with ``series_idx`` (positions in ``sids``)
        grouped in ascending order and each series time-ascending."""
        parts: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        cold_rng, tier_rng, raw_rng = self._split(start_ms, end_ms)
        if cold_rng is not None:
            cb = self._cold("materialize", sids, *cold_rng)
            if cb.num_points:
                parts.append((cb.series_idx, cb.ts_ms, cb.values))
        if tier_rng is not None:
            tsids = self._tier_sids(sids)
            present = np.nonzero(tsids >= 0)[0]
            if len(present):
                tb = self.tier.materialize(tsids[present], *tier_rng)
                if tb.num_points:
                    parts.append((present[tb.series_idx], tb.ts_ms,
                                  tb.values))
        if raw_rng is not None:
            rb = self.raw.materialize(sids, *raw_rng)
            if rb.num_points:
                vals = rb.values
                if self.tail_stat == "count":
                    # summing the tail must COUNT it (count-tier cells
                    # hold counts; see module docstring)
                    vals = np.ones_like(vals)
                parts.append((rb.series_idx, rb.ts_ms, vals))
        return parts

    @staticmethod
    def _placement(parts, s: int):
        """Where each part's points go in the merged rows: per part the
        column of each point within its row (the points of the earlier
        zones of that row come first), and the row lengths. One pass per
        part, no sort: each part is grouped by series already."""
        cols = []
        before = np.zeros(s, dtype=np.int64)
        for si, _ts, _v in parts:
            si = np.asarray(si, dtype=np.int64)
            c = np.bincount(si, minlength=s)
            first = np.cumsum(c) - c
            cols.append(before[si] + np.arange(len(si)) - first[si])
            before += c
        return cols, before

    def materialize(self, series_ids, start_ms: int,
                    end_ms: int) -> PointBatch:
        """Flat merged batch (ref: ``materialize``): per series, cold
        points (oldest) precede tier points precede raw tail points, the
        order the reference's stable sort on the series index gives."""
        sids = np.asarray(series_ids, dtype=np.int64)
        parts = self._parts(sids, start_ms, end_ms)
        if not parts:
            return PointBatch(sids, np.empty(0, dtype=np.int32),
                              np.empty(0, dtype=np.int64),
                              np.empty(0, dtype=np.float64))
        cols, row = self._placement(parts, len(sids))
        row_start = np.cumsum(row) - row
        n = int(row.sum())
        ts_ms = np.empty(n, dtype=np.int64)
        values = np.empty(n, dtype=np.float64)
        for (si, ts, v), col in zip(parts, cols):
            pos = row_start[si] + col
            ts_ms[pos] = ts
            values[pos] = v
        series_idx = np.repeat(np.arange(len(sids), dtype=np.int32), row)
        return PointBatch(sids, series_idx, ts_ms, values)

    def materialize_padded(self, series_ids, start_ms: int,
                           end_ms: int) -> PaddedBatch:
        """The row-padded layout of :meth:`materialize`, as the raw
        store pads (NaN values, zero timestamps past a row's count),
        written from the zones directly."""
        sids = np.asarray(series_ids, dtype=np.int64)
        parts = self._parts(sids, start_ms, end_ms)
        cols, row = self._placement(parts, len(sids))
        pmax = max(1, int(row.max())) if len(sids) else 1
        values2d = np.full((len(sids), pmax), np.nan)
        ts2d = np.zeros((len(sids), pmax), dtype=np.int64)
        for (si, ts, v), col in zip(parts, cols):
            values2d[si, col] = v
            ts2d[si, col] = ts
        return PaddedBatch(sids, values2d, ts2d, row)

    # -- destructive ops (delete=true queries) ------------------------------

    def delete_range(self, series_ids, start_ms: int,
                     end_ms: int) -> int:
        """delete=true over a stitched view removes the range from ALL
        parts (cold segments, tier history, raw tail). The cold delete
        is NOT behind the degradation guard: silently skipping it
        would report success for points still on disk."""
        sids = np.asarray(series_ids, dtype=np.int64)
        deleted = self.raw.delete_range(sids, start_ms, end_ms)
        tsids = self._tier_sids(sids)
        present = tsids[tsids >= 0]
        if len(present):
            deleted += self.tier.delete_range(present, start_ms,
                                              end_ms)
        if self.cold is not None and self.spill_boundary_ms \
                and start_ms < self.spill_boundary_ms:
            deleted += self.cold.delete_range(sids, start_ms, end_ms)
        return deleted
