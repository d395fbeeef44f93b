"""In-RAM sketch tier: per-cell quantile sketches of demoted raw data
(ref: ``opentsdb_tpu/sketch/store.py``; ``sketches.bin`` is the
reference's format, so either package loads the other's).

The fifth stat column's middle zone. Lifecycle demotion folds the raw
points it is about to purge into per-(series, cell) sketches here
(cells at the metric's finest demote-tier interval); the spill moves
cells below the spill boundary into the cold segment's sketch blob
column and drops them from RAM; the query path merges the three zones
(cold blobs, these cells, a raw-tail fold) per group and bucket.

Keys are metric NAME + sorted tag name pairs — stable across restarts
(same rule as ``lifecycle.json``), so the sidecar persistence file
(``sketches.bin``, JSON with base64 sketch blobs, atomic replace)
reloads cleanly into a fresh process. Persistence is written by the
sweeper *before* it purges the raw points a fold covered — the same
durable-first ordering the spill uses.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading

from opentsdb_tpu_torch.sketch.ddsketch import DDSketch

LOG = logging.getLogger("sketch.store")

_FILE_VERSION = 1


class SketchTierStore:
    """Holds ``metric name -> {tags: {cell_ts: DDSketch}}`` plus the
    metric's cell width. All access is under one lock — folds happen
    on the sweeper, reads snapshot lists out."""

    def __init__(self, path: str = "", alpha: float = 0.01,
                 max_buckets: int = 4096):
        self.path = path
        self.alpha = float(alpha)
        self.max_buckets = int(max_buckets)
        self._lock = threading.Lock()
        # keyed by policied metric name; cells are bounded below by the
        # spill boundary (spill moves them to disk) and above by the
        # demote boundary
        self._metrics: dict[str, dict] = {}
        # counters (stats surface)
        self.points_folded = 0
        self.cells_folded = 0
        self.cells_spilled = 0
        self.save_errors = 0

    # ------------------------------------------------------------------
    # fold side (lifecycle sweeper)
    # ------------------------------------------------------------------

    def merge_cells(self, metric: str, cell_ms: int, items) -> int:
        """Merge ``(tags_names_tuple, cell_ts, DDSketch)`` items into
        the metric's cells (exact DDSketch merge on collision).
        Returns cells touched."""
        n = 0
        with self._lock:
            ent = self._metrics.setdefault(
                metric, {"cell_ms": int(cell_ms), "series": {}})
            ent["cell_ms"] = int(cell_ms)
            series = ent["series"]
            for tags, cell_ts, sk in items:
                cells = series.setdefault(tuple(tags), {})
                cur = cells.get(int(cell_ts))
                if cur is None:
                    cells[int(cell_ts)] = sk
                else:
                    cur.merge(sk)
                self.points_folded += int(sk.count)
                n += 1
            self.cells_folded += n
        return n

    # ------------------------------------------------------------------
    # read side (query path / spill)
    # ------------------------------------------------------------------

    def cell_ms(self, metric: str) -> int:
        with self._lock:
            ent = self._metrics.get(metric)
            return int(ent["cell_ms"]) if ent else 0

    def cells(self, metric: str, start_ms: int, end_ms: int
              ) -> list[tuple[tuple, int, DDSketch]]:
        """Snapshot of ``(tags, cell_ts, sketch-copy)`` rows whose
        cell_ts falls in [start_ms, end_ms]. Copies so callers merge
        freely without mutating the store."""
        out = []
        with self._lock:
            ent = self._metrics.get(metric)
            if not ent:
                return out
            for tags, cells in ent["series"].items():
                for cts, sk in cells.items():
                    if start_ms <= cts <= end_ms:
                        out.append((tags, cts, sk.copy()))
        return out

    def blob_for(self, metric: str, tags, cell_ts: int
                 ) -> bytes | None:
        with self._lock:
            ent = self._metrics.get(metric)
            if not ent:
                return None
            cells = ent["series"].get(tuple(tags))
            if not cells:
                return None
            sk = cells.get(int(cell_ts))
            return sk.to_bytes() if sk is not None else None

    def has_cells(self, metric: str) -> bool:
        with self._lock:
            ent = self._metrics.get(metric)
            return bool(ent and any(ent["series"].values()))

    # ------------------------------------------------------------------
    # purge side
    # ------------------------------------------------------------------

    def delete_before(self, metric: str, cutoff_ms: int,
                      spilled: bool = False) -> int:
        """Drop cells whose WHOLE window [T, T+cell_ms) sits before
        ``cutoff_ms`` — the tier purge's cell-window rule. ``spilled``
        attributes the drop to a spill (counted separately) rather
        than retention."""
        dropped = 0
        with self._lock:
            ent = self._metrics.get(metric)
            if not ent:
                return 0
            iv = int(ent["cell_ms"])
            for tags in list(ent["series"]):
                cells = ent["series"][tags]
                dead = [t for t in cells if t + iv <= cutoff_ms]
                for t in dead:
                    del cells[t]
                dropped += len(dead)
                if not cells:
                    del ent["series"][tags]
            if not ent["series"]:
                del self._metrics[metric]
        if spilled:
            self.cells_spilled += dropped
        return dropped

    # ------------------------------------------------------------------
    # persistence (sidecar file, atomic replace)
    # ------------------------------------------------------------------

    def save(self) -> None:
        """Best-effort atomic persist — a failed save means the cells
        folded since the last good save are re-derived only if their
        raw points still exist; the sweeper therefore saves BEFORE it
        purges raw."""
        if not self.path:
            return
        with self._lock:
            doc = {"version": _FILE_VERSION, "metrics": {
                metric: {
                    "cell_ms": ent["cell_ms"],
                    "series": [
                        {"tags": [list(p) for p in tags],
                         "cells": [[cts, base64.b64encode(
                             sk.to_bytes()).decode("ascii")]
                            for cts, sk in sorted(cells.items())]}
                        for tags, cells in sorted(
                            ent["series"].items())],
                } for metric, ent in self._metrics.items()}}
        try:
            from opentsdb_tpu_torch.core.persist import atomic_write
            atomic_write(self.path,
                         json.dumps(doc, separators=(",", ":")).encode())
        except OSError as exc:  # pragma: no cover - disk trouble
            self.save_errors += 1
            LOG.warning("could not persist sketch cells: %s", exc)

    def load(self) -> None:
        if not self.path or not os.path.isfile(self.path):
            return
        try:
            with open(self.path, encoding="utf-8") as fh:
                doc = json.load(fh)
            metrics = {}
            for metric, ent in (doc.get("metrics") or {}).items():
                series = {}
                for srow in ent.get("series", ()):
                    tags = tuple(tuple(p) for p in srow["tags"])
                    series[tags] = {
                        int(cts): DDSketch.from_b64(b64)
                        for cts, b64 in srow.get("cells", ())}
                metrics[metric] = {"cell_ms": int(ent["cell_ms"]),
                                   "series": series}
        except (OSError, ValueError, KeyError) as exc:
            LOG.warning("could not load sketch cells from %s: %s",
                        self.path, exc)
            return
        with self._lock:
            self._metrics = metrics

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    def describe(self) -> dict:
        with self._lock:
            cells = sum(len(c) for ent in self._metrics.values()
                        for c in ent["series"].values())
            return {"metrics": len(self._metrics), "cells": cells,
                    "pointsFolded": self.points_folded,
                    "cellsFolded": self.cells_folded,
                    "cellsSpilled": self.cells_spilled,
                    "saveErrors": self.save_errors}
