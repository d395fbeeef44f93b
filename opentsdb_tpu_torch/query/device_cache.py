"""Device-resident grid and batch cache: the card's memory as the block
cache (ref: ``opentsdb_tpu/query/device_cache.py``).

A repeated query over the same window should not re-scan the host store
nor re-upload what it found. The engine keeps the storage-side
``[S, B]`` grids and the prepared point batches it uploaded here, as
device tensors, so a warm repeat starts at the pipeline's tail.

Entries are keyed by the exact reduction parameters and carry the
store's version (``TimeSeriesStore.version``; every write bumps it), so
a hit is always the tensor a fresh scan would upload. The cache is an
LRU bounded by bytes (``tsd.query.device_cache_mb``).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any


def array_digest(arr) -> bytes:
    """Content fingerprint of an index array (series ids, group ids)."""
    return hashlib.blake2b(memoryview(arr), digest_size=16).digest()


class DeviceGridCache:
    """LRU of device tensors keyed by (reduction params, store
    version). The host-RAM prepared-batch pool of host-placed queries
    is one too (``TSDB.host_prep_cache``), with its own
    ``stat_prefix``."""

    def __init__(self, max_bytes: int,
                 stat_prefix: str = "query.devicecache"):
        self.max_bytes = max_bytes
        self.stat_prefix = stat_prefix
        self._lock = threading.Lock()
        # key -> (version, arrays: tuple, meta: dict, nbytes: int)
        self._entries: OrderedDict[Any, tuple] = OrderedDict()
        self.nbytes = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key, version):
        """(arrays, meta) on a hit with a matching version, else None.
        An entry of another version is stale (the store changed) and
        is dropped."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or entry[0] != version:
                if entry is not None:
                    self.nbytes -= entry[3]
                    del self._entries[key]
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry[1], entry[2]

    def put(self, key, version, arrays: tuple, meta: dict) -> None:
        """Store ``arrays`` (tensors or ``PreparedBatch``es, counted by
        their ``nbytes``) and evict least recently used entries until
        the cache fits. An entry larger than the whole cache is not
        stored: it would only evict everything else."""
        nbytes = sum(a.nbytes for a in arrays if a is not None)
        if nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.nbytes -= old[3]
            self._entries[key] = (version, arrays, meta, nbytes)
            self.nbytes += nbytes
            while self.nbytes > self.max_bytes:
                _, (_, _, _, nb) = self._entries.popitem(last=False)
                self.nbytes -= nb

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.nbytes = 0

    def collect_stats(self, collector) -> None:
        collector.record(f"{self.stat_prefix}.bytes", self.nbytes)
        collector.record(f"{self.stat_prefix}.entries", len(self._entries))
        collector.record(f"{self.stat_prefix}.hits", self.hits)
        collector.record(f"{self.stat_prefix}.misses", self.misses)
