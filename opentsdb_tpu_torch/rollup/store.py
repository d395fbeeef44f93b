"""Rollup tier storage (ref: ``opentsdb_tpu/rollup/store.py``,
``src/rollup/RollupUtils.java:120-178``).

One store per (tier, aggregator) and one for pre-aggregated points,
each made by the same factory as the raw store (``make_store``: the
native C++ store by default). They are written by
``TSDB.add_aggregate_point`` (``/api/rollup``, telnet ``rollup``) and
by the rollup job (:mod:`opentsdb_tpu_torch.rollup.job`). Their scans
check the ``rollup.store`` fault site (ref: ``RollupStore._new_store``),
so a degraded tier is armed and seen apart from the raw store; a tier
made when first written is wired the moment it exists.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

from opentsdb_tpu_torch.rollup.config import RollupConfig


class RollupStore:
    def __init__(self, config: RollupConfig, store_factory: Callable,
                 fault_injector=None):
        self.config = config
        self._factory = store_factory
        self.fault_injector = fault_injector
        # guards the tiers dict: writers make tiers when first written
        # while query threads copy it for the serve version
        self._tiers_lock = threading.Lock()
        # (interval, agg) -> store; a handful, fixed by the config
        self._tiers: dict[tuple[str, str], object] = {}
        self._preagg = self._new_store()
        # (interval, agg) -> (mutation_epoch, points_written, has data)
        self._has_data_cache: dict[tuple[str, str], tuple] = {}

    def _new_store(self):
        store = self._factory()
        store.fault_injector = self.fault_injector
        store.fault_site = "rollup.store"
        return store

    def tier(self, interval: str, agg: str):
        """The store of one (interval, aggregator), made when first
        asked for; ValueError for an aggregator or interval the config
        does not hold."""
        agg = agg.lower()
        if agg not in self.config.agg_ids:
            raise ValueError(
                f"unsupported rollup aggregator {agg!r} "
                f"(supported: {sorted(self.config.agg_ids)})")
        self.config.get_interval(interval)
        key = (interval, agg)
        store = self._tiers.get(key)
        if store is None:
            with self._tiers_lock:
                store = self._tiers.get(key)
                if store is None:
                    store = self._tiers[key] = self._new_store()
        return store

    def tiers(self) -> list[tuple[tuple[str, str], object]]:
        """The ``((interval, agg), store)`` pairs made so far, sorted."""
        with self._tiers_lock:
            return sorted(self._tiers.items(), key=lambda kv: kv[0])

    def version(self) -> tuple:
        """Write and delete version over every tier and the preagg
        store, with the tier count (a tier that comes into being can
        change a query's tier selection)."""
        tiers = self.tiers()
        return (len(tiers), *self._preagg.version,
                *((key, *store.version) for key, store in tiers))

    def add_point(self, interval: str, agg: str, metric_id: int,
                  tag_ids: Sequence[tuple[int, int]], ts_ms: int,
                  value: float) -> int:
        store = self.tier(interval, agg)
        sid = store.get_or_create_series(metric_id, tag_ids)
        store.append(sid, ts_ms, value)
        return sid

    def add_preagg_point(self, metric_id: int,
                         tag_ids: Sequence[tuple[int, int]], ts_ms: int,
                         value: float) -> int:
        sid = self._preagg.get_or_create_series(metric_id, tag_ids)
        self._preagg.append(sid, ts_ms, value)
        return sid

    def preagg_store(self):
        return self._preagg

    def has_data(self, interval: str, agg: str) -> bool:
        """Whether the tier holds a point, in O(1) in steady state (tier
        selection asks on every query): writes only add, so a True
        verdict holds until a destructive operation moves the store's
        ``mutation_epoch``; only then does the walk over every series
        run again (a tier emptied by deletes must stop being chosen)."""
        key = (interval, agg.lower())
        store = self._tiers.get(key)
        if store is None:
            return False
        pw = store.points_written
        if pw == 0:
            return False
        ep = store.mutation_epoch
        cached = self._has_data_cache.get(key)
        if cached is not None and cached[0] == ep:
            if cached[2]:
                return True
            if pw == cached[1]:
                return False
            # writes landed since the False verdict: data exists now
            self._has_data_cache[key] = (ep, pw, True)
            return True
        res = store.total_points() > 0
        self._has_data_cache[key] = (ep, pw, res)
        return res
