"""The TSDB facade (ref: ``src/core/TSDB.java:87``).

Owns the UID registry and the store, and is where a caller picks the
device: ``tsd.torch.device`` is ``"cuda"`` unless the caller asks for
``"cpu"``, and constructing a TSDB on ``cuda`` raises when no card is
present. Writes go to the store that ``tsd.storage.backend`` names
(the native C++ store by default, or the memory store). On the native
store, :meth:`TSDB.import_buffer` takes whole bursts of import lines
through one native parse.

With ``tsd.storage.data_dir`` set (native store only), writes are
durable as in the reference: construction loads the directory's
snapshot (:mod:`~opentsdb_tpu_torch.core.persist`) and replays its
write-ahead log (:mod:`~opentsdb_tpu_torch.core.wal`,
``tsd.storage.wal.enable``, on by default), every write path logs
under one WAL batch scope and syncs once before it returns,
:meth:`TSDB.flush` snapshots and truncates the log, and
:meth:`TSDB.shutdown` flushes and closes it. Without a data_dir
nothing written survives the process.

The TSDB also owns the serve path's caches (the device cache, the
result cache and the per-metric tag matrices), the sub-query fan-out
pool (:meth:`TSDB.shutdown` stops it), the query limits, the stats
registry the front end reads (``/api/stats``, telnet ``stats``), and
the continuous-query registry (:attr:`TSDB.streaming`, made at first
use). Every raw write path offers its acknowledged points to that
registry after the write (and its WAL sync) is done, under a
:class:`TapGate` that a partial's re-seed holds alone.

With ``tsd.query.mesh`` set, the TSDB builds its query mesh
(:attr:`TSDB.query_mesh`, :mod:`opentsdb_tpu_torch.parallel`) from the
device list the caller gives (``mesh_devices``); a shape the list
cannot hold raises ValueError. With ``tsd.mesh.coordinator`` set, it
first joins the multi-process rendezvous
(:func:`~opentsdb_tpu_torch.parallel.distributed.initialize_from_config`).
"""

from __future__ import annotations

import contextlib
import functools
import heapq
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from opentsdb_tpu_torch.core import persist
from opentsdb_tpu_torch.core import tags as tags_mod
from opentsdb_tpu_torch.core.histogram import (HistogramArena,
                                               HistogramCodecManager)
from opentsdb_tpu_torch.core.store import TimeSeriesStore, pad_mask
from opentsdb_tpu_torch.core.uid import (FailedToAssignUniqueIdError,
                                         UidRegistry)
from opentsdb_tpu_torch.core.wal import WriteAheadLog
from opentsdb_tpu_torch.native.store_backend import (IMPORT_ERRORS,
                                                     make_store,
                                                     parse_import_buffer)
from opentsdb_tpu_torch.parallel import distributed
from opentsdb_tpu_torch.parallel.mesh import default_devices, mesh_from_spec
from opentsdb_tpu_torch.query.device_cache import DeviceGridCache
from opentsdb_tpu_torch.query.engine import refuse_unported_keys
from opentsdb_tpu_torch.query.limits import QueryLimitOverride
from opentsdb_tpu_torch.query.result_cache import QueryResultCache
from opentsdb_tpu_torch.rollup.config import RollupConfig
from opentsdb_tpu_torch.rollup.store import RollupStore
from opentsdb_tpu_torch.stats.stats import (ServePayloadStats,
                                            StatsCollectorRegistry)
from opentsdb_tpu_torch.utils.config import Config
from opentsdb_tpu_torch.utils.faults import (CircuitBreaker, FaultInjector,
                                             RetryPolicy, call_with_retries)

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the bits of a timestamp above the seconds range (ref: Const.SECOND_MASK)
_SECOND_MASK = 0xFFFFFFFF00000000
# points per WAL record of a bulk write (25 bytes each)
_WAL_LINES = 1 << 22


class TapGate:
    """Orders the raw writes against the continuous queries' re-seeds.

    A write holds the gate, shared, from before its points reach the
    store until after it has offered them to the registry; a partial's
    bootstrap holds it alone while it clears its buffers and scans the
    store. So a scan never sees a point whose offer is still to come
    (it would be folded twice), and never misses one whose offer it has
    thrown away. Writes wait while a re-seed scans. A thread inside a
    write enters again freely (``add_point_groups`` calls
    ``add_points``), and cannot seal the gate."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._writers = 0
        self._sealed = False
        self._local = threading.local()

    def in_write(self) -> bool:
        return getattr(self._local, "depth", 0) > 0

    def enter(self) -> None:
        depth = getattr(self._local, "depth", 0)
        if not depth:
            with self._cond:
                while self._sealed:
                    self._cond.wait()
                self._writers += 1
        self._local.depth = depth + 1

    def leave(self) -> None:
        depth = self._local.depth - 1
        self._local.depth = depth
        if not depth:
            with self._cond:
                self._writers -= 1
                if self._sealed and not self._writers:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def sealed(self):
        """Wait for the writes in flight to finish, and keep new ones
        out until the block ends."""
        if self.in_write():
            raise RuntimeError("a write cannot re-seed a partial")
        with self._cond:
            while self._sealed:
                self._cond.wait()
            self._sealed = True
            while self._writers:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._sealed = False
                self._cond.notify_all()


def _tapped(write):
    """A raw write path: it runs under the TSDB's :class:`TapGate`."""
    @functools.wraps(write)
    def gated(self, *args, **kwargs):
        self.tap_gate.enter()
        try:
            return write(self, *args, **kwargs)
        finally:
            self.tap_gate.leave()
    return gated


def resolve_device(config: Config) -> torch.device:
    """The compute device named by ``tsd.torch.device``; raises when it
    is ``cuda`` and no card is present (there is no silent CPU
    fallback)."""
    dev = torch.device(config.get_string("tsd.torch.device"))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported tsd.torch.device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tsd.torch.device is 'cuda' but no CUDA device is "
            "available; set tsd.torch.device=cpu to run on the CPU")
    return dev


def resolve_dtype(config: Config) -> torch.dtype:
    name = config.get_string("tsd.torch.dtype")
    if name not in _DTYPES:
        raise ValueError(f"unsupported tsd.torch.dtype {name!r}")
    return _DTYPES[name]


def _to_ms(timestamp: int) -> int:
    """A second or millisecond timestamp in milliseconds (ref:
    ``codec.to_ms``: an int with a bit set above the low 32 is in ms;
    a float raises TypeError there, and here)."""
    return timestamp if timestamp & _SECOND_MASK else timestamp * 1000


def normalize_timestamps(ts) -> np.ndarray:
    """Validate unix timestamps (seconds or ms) and return int64 ms
    (ref: TSDB.java:1274 checkTimestampAndTags; a value at or above
    2^32 is already in milliseconds)."""
    ts = np.asarray(ts, dtype=np.int64)
    if len(ts) == 0:
        raise ValueError("empty point batch")
    if int(ts.min()) <= 0:
        raise ValueError(f"invalid timestamp {int(ts.min())}")
    is_ms = ts >= (1 << 32)
    if int(ts[is_ms].max(initial=0)) > (1 << 47):
        raise ValueError("timestamp out of range")
    return np.where(is_ms, ts, ts * 1000)


class TSDB:
    """(ref: src/core/TSDB.java:87)"""

    def __init__(self, config: Config | None = None,
                 mesh_devices: Sequence | None = None):
        """``mesh_devices`` is the device list a query mesh
        (``tsd.query.mesh``) is drawn from: by default the visible cards,
        or the CPU when ``tsd.torch.device`` is ``cpu``. It may name a
        device more than once (virtual shards on one device)."""
        self.config = config or Config()
        refuse_unported_keys(self.config)
        # the multi-process rendezvous comes before any device touch
        # (ref: TSDB.__init__ with tsd.mesh.coordinator)
        distributed.initialize_from_config(self.config)
        self.device = resolve_device(self.config)
        self.dtype = resolve_dtype(self.config)
        # the query mesh (ref: TSDB.query_mesh), built here so that a
        # shape the device list cannot hold raises now: there is no
        # single-device fallback
        if mesh_devices is None:
            mesh_devices = [self.device] if self.device.type == "cpu" \
                else default_devices()
        self._query_mesh = mesh_from_spec(
            self.config.get_string("tsd.query.mesh", ""), mesh_devices)
        self.uids = UidRegistry(
            metric_width=self.config.get_int(
                "tsd.storage.uid.width.metric"),
            tagk_width=self.config.get_int("tsd.storage.uid.width.tagk"),
            tagv_width=self.config.get_int("tsd.storage.uid.width.tagv"),
            random_metrics=self.config.get_bool(
                "tsd.core.uid.random_metrics"))
        # raises when the native library does not build (no fallback)
        self.store = make_store(self.config)
        self.mode = self.config.get_string("tsd.mode")
        self.auto_metric = self.config.get_bool(
            "tsd.core.auto_create_metrics")
        self.auto_tagk = self.config.get_bool("tsd.core.auto_create_tagks")
        self.auto_tagv = self.config.get_bool("tsd.core.auto_create_tagvs")
        self.datapoints_added = 0
        self.start_time = time.time()
        # per-metric byte / data-point caps the engine checks after
        # each scan (ref: TSDB.query_limits)
        self.query_limits = QueryLimitOverride(self.config)
        self.stats = StatsCollectorRegistry()
        # response bytes and serialization time of /api/query, fed by
        # the HTTP handler
        self.payload_stats = ServePayloadStats()
        self.stats.register(self.payload_stats)
        self._device_grid_cache: DeviceGridCache | None = None
        self._device_cache_lock = threading.Lock()
        # the host-RAM twin for host-placed prepared batches: a pool
        # apart, so host entries never evict the card's grids
        self._host_prep_cache: DeviceGridCache | None = None
        self._host_cache_mb = self.config.get_int("tsd.query.host_cache_mb")
        # (store instance, metric id) -> (series count, TagMatrix):
        # the engine's per-metric tag matrix, rebuilt when the metric
        # gains a series
        self._tagmat_cache: dict = {}
        # the serve-path result cache and the sub-query fan-out pool,
        # made when first needed
        self._result_cache: QueryResultCache | None = None
        self._result_cache_mb = self.config.get_int("tsd.query.cache.mb")
        self._fanout_pool: ThreadPoolExecutor | None = None
        self._fanout_workers = self.config.get_int(
            "tsd.query.fanout.workers")
        # fault injection for the WAL and the snapshot flush (armed by
        # tsd.faults.* keys; one dict miss per site when disarmed)
        self.faults = FaultInjector(self.config)
        self.stats.register(self.faults)
        # the device pipeline's breaker (ref: TSDB.device_breaker), in
        # its shedding mode only: the reference's host re-answer of a
        # failed query is a fallback the port does not have
        if self.config.get_bool("tsd.query.degraded.host_fallback"):
            raise ValueError(
                "tsd.query.degraded.host_fallback=true re-answers a failed "
                "device query on the host; the port has no fallback after "
                "a failure (an open breaker answers 503): set it to false")
        threshold = self.config.get_int(
            "tsd.query.breaker.failure_threshold")
        self.device_breaker: CircuitBreaker | None = None
        if threshold > 0:
            self.device_breaker = CircuitBreaker(
                "device.pipeline", failure_threshold=threshold,
                reset_timeout_ms=self.config.get_int(
                    "tsd.query.breaker.reset_timeout_ms"))
            self.stats.register(self.device_breaker)
        # histogram points (ref: TSDB.java:125-135): the codecs, an
        # index of the histogram series (a memory store that holds no
        # points), and per metric a columnar arena of the points; the
        # version moves with every histogram write (read-side caches)
        self.histogram_manager = HistogramCodecManager(self.config)
        self.histogram_store = TimeSeriesStore()
        self._histogram_arenas: dict[int, HistogramArena] = {}
        self._histogram_lock = threading.Lock()
        self._histogram_version = 0
        # rollup tiers (ref: TSDB.java:170-185), their stores made by the
        # raw store's factory (the native store by default)
        self.rollup_config: RollupConfig | None = None
        self.rollup_store: RollupStore | None = None
        self.agg_tag_key = self.config.get_string("tsd.rollups.agg_tag_key")
        if self.config.get_bool("tsd.rollups.enable"):
            path = self.config.get_string("tsd.rollups.config")
            self.rollup_config = (RollupConfig.from_file(path) if path
                                  else RollupConfig.default())
            self.rollup_store = RollupStore(
                self.rollup_config, lambda: make_store(self.config))
        self.data_dir = self.config.get_string("tsd.storage.data_dir")
        self.wal: WriteAheadLog | None = None
        self._wal_applied_seq = 0
        # what the last start recovered: seconds of the snapshot load
        # and of the WAL replay, and the points the replay applied
        self.recovery = {"load_s": 0.0, "replay_s": 0.0,
                         "points_replayed": 0}
        # the continuous-query registry (streaming/), made at first use
        # by the ``streaming`` property: the write paths' tap reads this
        # attribute, one read per write while no query is registered
        self._streaming = None
        self.tap_gate = TapGate()
        # errors of post-write hooks (the streaming tap), by hook: a
        # hook never fails a write that already happened
        self.hook_errors: dict[str, int] = {}
        # set by tsd/warmup.py's thread: a stopping server stops it
        self._warmup_stop: threading.Event | None = None
        if self.data_dir:
            self._open_data_dir()

    def _open_data_dir(self) -> None:
        """Load the snapshot, then open the WAL and replay what the
        snapshot does not cover (ref: TSDB.__init__)."""
        if self.store.backend != "native":
            raise ValueError(
                "tsd.storage.data_dir needs tsd.storage.backend=native: "
                f"the {self.store.backend} store drops the per-point "
                "integer flag that the snapshot and WAL formats carry")
        t = time.perf_counter()
        persist.load_store(self, self.data_dir)
        self.recovery["load_s"] = time.perf_counter() - t
        cfg = self.config
        if not cfg.get_bool("tsd.storage.wal.enable", True):
            return
        wal = WriteAheadLog(
            os.path.join(self.data_dir, "wal"),
            fsync_mode=cfg.get_string("tsd.storage.wal.fsync", "always"),
            segment_bytes=cfg.get_int("tsd.storage.wal.segment_mb",
                                      64) << 20,
            interval_ms=cfg.get_int("tsd.storage.wal.fsync_interval_ms",
                                    200),
            faults=self.faults,
            retry=RetryPolicy.from_config(cfg, "tsd.storage.wal.retry"),
            resync_ms=cfg.get_int("tsd.storage.wal.resync_interval_ms"),
            group_window_ms=self._wal_group_window_ms(),
            group_max_records=cfg.get_int(
                "tsd.storage.wal.group_max_records"),
            group_max_bytes=cfg.get_int("tsd.storage.wal.group_max_bytes"))
        self.stats.register(wal)
        # the snapshot's series keep their numbering on load
        wal.seed_known("data", self.store.num_series())
        if self.rollup_store is not None:
            wal.seed_known("preagg",
                           self.rollup_store.preagg_store().num_series())
            for (interval, agg), store in self.rollup_store.tiers():
                wal.seed_known(f"tier:{interval}:{agg}", store.num_series())
        t = time.perf_counter()
        try:
            recovered = wal.replay(self, self._wal_applied_seq)
        except BaseException:
            wal.close()     # no thread of a TSDB that did not start
            raise
        self.recovery["replay_s"] = time.perf_counter() - t
        self.recovery["points_replayed"] = recovered
        if recovered:
            logging.getLogger("tsdb").info(
                "WAL replay recovered %d points", recovered)
        self.wal = wal

    def _wal_group_window_ms(self) -> int:
        """``tsd.storage.wal.group_window_ms``; "" (the default) means 0
        (ref: TSDB._wal_group_window_ms, whose 2 ms on a cluster shard
        the port cannot reach: ``tsd.cluster.role`` is refused)."""
        raw = self.config.get_string("tsd.storage.wal.group_window_ms",
                                     "").strip()
        return int(raw) if raw else 0

    @property
    def query_mesh(self):
        """The ('series', 'time') device mesh ``/api/query`` runs on,
        from ``tsd.query.mesh`` (:mod:`opentsdb_tpu_torch.parallel`), or
        None for the single-device pipeline (ref: ``TSDB.query_mesh``,
        the mesh that replaces SaltScanner.java:70's 20-way scan
        fan-out)."""
        return self._query_mesh

    @property
    def device_grid_cache(self) -> DeviceGridCache | None:
        """The device-resident grid and prepared-batch cache
        (:mod:`opentsdb_tpu_torch.query.device_cache`), made when first
        needed at ``tsd.query.device_cache_mb``; None while that key is
        0 (ref: ``TSDB.device_grid_cache``)."""
        mb = self.config.get_int("tsd.query.device_cache_mb")
        if mb <= 0:
            return None
        with self._device_cache_lock:
            if self._device_grid_cache is None:
                self._device_grid_cache = DeviceGridCache(mb << 20)
            return self._device_grid_cache

    @property
    def host_prep_cache(self) -> DeviceGridCache | None:
        """The host-RAM prepared-batch cache of host-placed queries
        (ref: ``TSDB.host_prep_cache``), made when first needed at
        ``tsd.query.host_cache_mb``; None while that key is 0."""
        if self._host_cache_mb <= 0:
            return None
        with self._device_cache_lock:
            if self._host_prep_cache is None:
                self._host_prep_cache = DeviceGridCache(
                    self._host_cache_mb << 20,
                    stat_prefix="query.hostcache")
                self.stats.register(self._host_prep_cache)
            return self._host_prep_cache

    @property
    def result_cache(self) -> QueryResultCache | None:
        """The serve-path result cache
        (:mod:`opentsdb_tpu_torch.query.result_cache`), or None when it
        is off. ``tsd.query.cache.enable`` is read on every call, so it
        can be switched at run time without losing the entries (ref:
        ``TSDB.result_cache``)."""
        if self._result_cache_mb <= 0 or not self.config.get_bool(
                "tsd.query.cache.enable", True):
            return None
        with self._device_cache_lock:
            if self._result_cache is None:
                self._result_cache = QueryResultCache(
                    self._result_cache_mb << 20,
                    shards=self.config.get_int("tsd.query.cache.shards"))
            return self._result_cache

    @property
    def query_fanout_pool(self) -> ThreadPoolExecutor | None:
        """The pool independent sub-queries of one TSQuery run on, or
        None (serial) at ``tsd.query.fanout.workers=0`` (ref:
        ``TSDB.query_fanout_pool``)."""
        if self._fanout_workers <= 0:
            return None
        with self._device_cache_lock:
            if self._fanout_pool is None:
                self._fanout_pool = ThreadPoolExecutor(
                    max_workers=self._fanout_workers,
                    thread_name_prefix="tsd-subq")
            return self._fanout_pool

    @property
    def streaming(self):
        """The continuous-query registry
        (:mod:`opentsdb_tpu_torch.streaming.registry`), made at first
        use, or None while ``tsd.streaming.enable`` is false (ref:
        ``TSDB.streaming``)."""
        if not self.config.get_bool("tsd.streaming.enable", True):
            return None
        if self._streaming is None:
            with self._device_cache_lock:
                if self._streaming is None:
                    from opentsdb_tpu_torch.streaming.registry import \
                        ContinuousQueryRegistry
                    reg = ContinuousQueryRegistry(self)
                    self.stats.register(reg)
                    self._streaming = reg
        return self._streaming

    def _tap(self, offer, *args) -> None:
        """Offer acknowledged points to the continuous queries. They are
        in the store and the WAL already, so a failure never fails the
        write (ref: ``TSDB._run_hook``): it is counted (``hooks.errors``,
        hook ``stream.tap``) and logged, and every partial is marked for
        rebuild, since some may now lack the points; the next pull
        re-seeds from the store."""
        try:
            offer(*args)
        except Exception:  # noqa: BLE001 - the write is acknowledged
            self._streaming.invalidate()
            n = self.hook_errors.get("stream.tap", 0) + 1
            self.hook_errors["stream.tap"] = n
            if n <= 5 or n % 1000 == 0:
                logging.getLogger("tsdb").exception(
                    "stream.tap hook failed (%d so far); the write "
                    "itself succeeded, the partials rebuild", n)

    def _tap_lines(self, metric_id: int, sids: np.ndarray,
                   ts_ms: np.ndarray, values: np.ndarray) -> None:
        """Offer acknowledged points of one metric, of any series, to
        the continuous queries (one chunk per shared partial)."""
        if self._streaming is not None and len(ts_ms):
            self._tap(self._streaming.offer_lines, metric_id, sids,
                      ts_ms, values)

    def drop_caches(self) -> None:
        """(ref: TSDB.dropCaches) The UID tables are authoritative; the
        device cache, its host-RAM twin and the result cache are
        dropped, and the continuous queries' partials rebuild from the
        store at their next serve."""
        if self._device_grid_cache is not None:
            self._device_grid_cache.clear()
        if self._host_prep_cache is not None:
            self._host_prep_cache.clear()
        if self._result_cache is not None:
            self._result_cache.clear()
        if self._streaming is not None:
            self._streaming.invalidate()

    def serve_version(self) -> tuple:
        """The version of every store a query can read (ref:
        ``TSDB.serve_version``): the raw store, the histograms and the
        rollup tiers with the preagg store. A write or a delete to any
        of them changes it."""
        parts = [*self.store.version, self._histogram_version,
                 *self.histogram_store.version]
        if self.rollup_store is not None:
            parts.append(self.rollup_store.version())
        return tuple(parts)

    def memory_info(self) -> dict:
        """Footprint by store (ref: ``TSDB.memory_info``): series,
        points and bytes of the raw store and of each rollup store that
        reports them (the native store does), and their totals."""
        stores = [("raw", self.store)]
        if self.rollup_store is not None:
            stores.append(("rollup:preagg", self.rollup_store.preagg_store()))
            stores += [(f"rollup:{interval}:{agg}", store) for
                       (interval, agg), store in self.rollup_store.tiers()]
        out = {name: store.memory_info() for name, store in stores
               if hasattr(store, "memory_info")}
        totals = {"resident_bytes": 0, "live_bytes": 0, "dead_bytes": 0,
                  "series": 0, "points": 0}
        for info in out.values():
            for k in totals:
                totals[k] += info.get(k, 0)
        out["total"] = totals
        return out

    def flush(self) -> None:
        """Snapshot the store into the data_dir under the
        ``tsd.storage.flush.retry`` policy, then delete the WAL segments
        the snapshot covers (ref: ``TSDB.flush``). Nothing without a
        data_dir."""
        if not self.data_dir:
            return
        wal_seq = call_with_retries(
            lambda: persist.save_store(self, self.data_dir),
            RetryPolicy.from_config(self.config, "tsd.storage.flush.retry"),
            retryable=(OSError,),
            on_retry=lambda attempt, exc: logging.getLogger(
                "tsdb").warning("snapshot flush failed (attempt %d: %s); "
                                "retrying", attempt, exc))
        if self.wal is not None:
            self.wal.truncate(wal_seq)

    def shutdown(self) -> None:
        """Stop a running warmup, flush, stop the continuous queries'
        fold workers and the fan-out pool (waiting for their threads to
        end), then close the WAL (ref: ``TSDB.shutdown``)."""
        if self._warmup_stop is not None:
            self._warmup_stop.set()
        self.flush()
        if self._streaming is not None:
            self._streaming.shutdown()
        with self._device_cache_lock:
            pool, self._fanout_pool = self._fanout_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        if self.wal is not None:
            self.wal.close()

    # -- suggest and stats (ref: TSDB.java:1762-1846, collectStats :753)

    def suggest_metrics(self, search: str = "", max_results: int = 25):
        return self.uids.metrics.suggest(search, max_results)

    def suggest_tag_names(self, search: str = "", max_results: int = 25):
        return self.uids.tag_names.suggest(search, max_results)

    def suggest_tag_values(self, search: str = "", max_results: int = 25):
        return self.uids.tag_values.suggest(search, max_results)

    def collect_stats(self, collector) -> None:
        self.uids.metrics.collect_stats(collector)
        self.uids.tag_names.collect_stats(collector)
        self.uids.tag_values.collect_stats(collector)
        self.store.collect_stats(collector)
        collector.record("datapoints.added", self.datapoints_added)
        for hook, n in sorted(self.hook_errors.items()):
            collector.record("hooks.errors", n, hook=hook)
        collector.record("uptime.seconds",
                         int(time.time() - self.start_time))

    def assign_uid(self, kind: str, name: str) -> int:
        """Assign a UID explicitly (``/api/uid/assign``, ``tsdb
        mkmetric``); logged to the WAL (ref: ``TSDB.assign_uid``)."""
        tags_mod.validate_string(f"{kind} name", name)
        uid = self.uids.by_kind(kind).assign_id(name)
        if self.wal is not None:
            self.wal.log_uid(kind, name)
            self.wal.sync()
        return uid

    # -- write path -------------------------------------------------------

    def _wal_scope(self):
        """One request's WAL batch scope: its records land as one framed
        write and its syncs as one group-committed fsync at scope exit
        (:meth:`WriteAheadLog.batch`); nothing without a WAL."""
        if self.wal is None:
            return contextlib.nullcontext()
        return self.wal.batch()

    def _resolve_uids(self, metric: str,
                      tags_list: Sequence[dict[str, str]],
                      create: bool = False
                      ) -> tuple[int, list[list[tuple[int, int]]]]:
        """UIDs of one metric and of many series' tags. New names are
        assigned in the order a per-point write would meet them
        (series order, then each series' tag order). ``create`` assigns
        missing names whatever the auto-create keys say (WAL replay: the
        write they belong to was acknowledged)."""
        def ids(registry, names, auto):
            return (registry.get_or_create_ids(names) if auto or create
                    else [registry.get_id(n) for n in names])

        metric_id = ids(self.uids.metrics, [metric], self.auto_metric)[0]
        keys = [k for tags in tags_list for k in tags]
        vals = [v for tags in tags_list for v in tags.values()]
        kids = ids(self.uids.tag_names, keys, self.auto_tagk)
        vids = ids(self.uids.tag_values, vals, self.auto_tagv)
        pairs = list(zip(kids, vids))
        out, pos = [], 0
        for tags in tags_list:
            out.append(pairs[pos:pos + len(tags)])
            pos += len(tags)
        return metric_id, out

    def _check_writable(self) -> None:
        if self.mode == "ro":
            raise PermissionError("TSD is in read-only mode")

    @_tapped
    def add_point(self, metric: str, timestamp: int, value: int | float,
                  tags: dict[str, str]) -> int:
        """Write one datapoint; returns the series id
        (ref: TSDB.addPoint :1012/:1057/:1097). The timestamp is checked
        first, with the reference's per-point messages."""
        self._check_writable()
        if timestamp <= 0:
            raise ValueError(f"invalid timestamp {timestamp}")
        if timestamp >= (1 << 32) and timestamp > (1 << 47):
            raise ValueError(f"timestamp out of range: {timestamp}")
        metric_id, sid, ts_ms, vals = self._write_series(
            metric, [timestamp], [float(value)], tags,
            [type(value) is int])
        if self._streaming is not None:
            # the scalar tap: a tuple append, no numpy per point
            self._tap(self._streaming.offer, metric_id, sid,
                      int(ts_ms[0]), float(vals[0]))
        return sid

    @_tapped
    def add_points(self, metric: str, timestamps, values,
                   tags: dict[str, str], is_int=None) -> int:
        """Bulk write many points of ONE series; returns the series id.
        The whole batch is validated before anything is written.
        ``is_int`` is one integer flag or one per point (by default,
        whether the values' dtype is an integer one); the native store
        keeps them."""
        self._check_writable()
        metric_id, sid, ts_ms, vals = self._write_series(
            metric, timestamps, values, tags, is_int)
        if self._streaming is not None:
            self._tap_lines(metric_id, np.full(len(ts_ms), sid, np.int64),
                            ts_ms, vals)
        return sid

    def _write_series(self, metric: str, timestamps, values,
                      tags: dict[str, str], is_int):
        """The write of :meth:`add_points`, logged and synced; returns
        (metric id, series id, timestamps in ms, float64 values)."""
        raw = np.asarray(values)
        vals = raw.astype(np.float64)
        if np.shape(timestamps) != vals.shape or vals.ndim != 1:
            raise ValueError("timestamps/values must be equal-length 1-D")
        ts_ms = normalize_timestamps(timestamps)
        tags_mod.check_metric_and_tags(metric, tags)
        if is_int is None:
            is_int = np.issubdtype(raw.dtype, np.integer)
        metric_id, (tag_ids,) = self._resolve_uids(metric, [tags])
        sid = self.store.get_or_create_series(metric_id, tag_ids)
        self.store.append_many(sid, ts_ms, vals, is_int)
        if self.wal is not None:
            # joins an enclosing request's scope (add_point_groups')
            with self.wal.batch():
                self.wal.ensure_series("data", sid, metric, tags)
                self.wal.log_points("data", sid, ts_ms, vals, np.broadcast_to(
                    np.asarray(is_int, dtype=np.uint8), ts_ms.shape))
                self.wal.sync()
        self.datapoints_added += len(ts_ms)
        return metric_id, sid, ts_ms, vals

    def add_point_groups(self, groups, on_error=None
                         ) -> tuple[int, list[str]]:
        """Columnar bulk write of points already grouped by series:
        ``groups`` yields ``(metric, tags, refs, timestamps, values)``
        where ``refs[i]`` is an opaque per-point handle handed back to
        ``on_error(ref, exc)`` for failing points. A group whose bulk
        write fails replays per point, so every valid point lands and
        errors stay per-point (ref: TSDB.add_point_groups)."""
        errors: list[str] = []
        written = 0
        # the whole request commits as one WAL write and one fsync
        with self._wal_scope():
            for metric, tags, refs, ts_list, raw in groups:
                try:
                    self.add_points(metric, ts_list, raw, tags,
                                    is_int=[type(v) is int for v in raw])
                    written += len(ts_list)
                except (ValueError, TypeError, LookupError,
                        PermissionError):
                    for j in range(len(ts_list)):
                        try:
                            self.add_point(metric, ts_list[j], raw[j],
                                           tags)
                            written += 1
                        except (ValueError, TypeError, LookupError,
                                PermissionError) as e:
                            errors.append(f"{metric} @{ts_list[j]}: {e}")
                            if on_error is not None:
                                on_error(refs[j], e)
        return written, errors

    @_tapped
    def add_series_points(self, metric: str,
                          tags_list: Sequence[dict[str, str]],
                          ts2d: np.ndarray, values2d: np.ndarray,
                          counts: np.ndarray | None = None
                          ) -> np.ndarray:
        """Columnar bulk write of many series of one metric: row i of
        ``ts2d``/``values2d`` (its first ``counts[i]`` cells, or all of
        them) goes to the series tagged ``tags_list[i]``. Each distinct
        tag string is validated once, UIDs resolve in one pass, and the
        store takes one append. Returns the series ids."""
        self._check_writable()
        ts2d = np.asarray(ts2d, dtype=np.int64)
        values2d = np.asarray(values2d)
        is_int = np.issubdtype(values2d.dtype, np.integer)
        values2d = values2d.astype(np.float64, copy=False)
        if ts2d.shape != values2d.shape or ts2d.ndim != 2 \
                or len(tags_list) != ts2d.shape[0]:
            raise ValueError("ts2d/values2d must be [S, P] with one "
                             "tag set per row")
        tags_mod.validate_string("metric name", metric)
        names: dict[str, set] = {"tag name": set(), "tag value": set()}
        for tags in tags_list:
            tags_mod.check_tag_count(metric, tags)
            names["tag name"].update(tags)
            names["tag value"].update(tags.values())
        for what, distinct in names.items():
            for s in distinct:
                tags_mod.validate_string(what, s)
        if counts is None:
            sids_rows, ts_flat, val_flat = None, ts2d.reshape(-1), \
                values2d.reshape(-1)
        else:
            present = ~pad_mask(np.asarray(counts, dtype=np.int64),
                                ts2d.shape[1])
            ts_flat, val_flat = ts2d[present], values2d[present]
            sids_rows = present
        ts_ms = normalize_timestamps(ts_flat)
        metric_id, tag_ids = self._resolve_uids(metric, tags_list)
        sids = self.store.get_or_create_series_bulk(metric_id, tag_ids)
        if sids_rows is None:
            point_sids = np.repeat(sids, ts2d.shape[1])
        else:
            point_sids = np.broadcast_to(sids[:, None],
                                         ts2d.shape)[sids_rows]
        self.store.append_lines(point_sids, ts_ms, val_flat, is_int)
        if self.wal is not None:
            with self.wal.batch():
                for sid, tags in zip(sids.tolist(), tags_list):
                    self.wal.ensure_series("data", sid, metric, tags)
                for lo in range(0, len(ts_ms), _WAL_LINES):
                    hi = min(lo + _WAL_LINES, len(ts_ms))
                    self.wal.log_lines("data", point_sids[lo:hi],
                                       ts_ms[lo:hi], val_flat[lo:hi],
                                       np.full(hi - lo, is_int, np.uint8))
                self.wal.sync()
        self.datapoints_added += len(ts_ms)
        self._tap_lines(metric_id, point_sids, ts_ms, val_flat)
        return sids

    def add_aggregate_point(self, metric: str, timestamp: int,
                            value: int | float, tags: dict[str, str],
                            is_groupby: bool, interval: str | None,
                            rollup_agg: str | None,
                            groupby_agg: str | None = None) -> int:
        """Write one rollup or pre-aggregated point; returns its series
        id in the store it went to (ref: ``TSDB.add_aggregate_point``,
        TSDB.java:1320-1418). A pre-aggregate (``is_groupby``) is tagged
        with its group-by aggregator under ``tsd.rollups.agg_tag_key``;
        with no ``interval`` it goes to the preagg store, else to the
        tier of ``interval`` and ``rollup_agg``."""
        if self.rollup_store is None:
            raise RuntimeError("rollups are not enabled "
                               "(tsd.rollups.enable=false)")
        tags = dict(tags)
        if is_groupby:
            agg = (groupby_agg or rollup_agg or "").upper()
            if not agg:
                raise ValueError("missing group-by aggregator")
            tags[self.agg_tag_key] = agg
        tags_mod.check_metric_and_tags(metric, tags)
        metric_id, (tag_ids,) = self._resolve_uids(metric, [tags])
        ts_ms, value = _to_ms(timestamp), float(value)
        if interval is None:
            kind = "preagg"
            sid = self.rollup_store.add_preagg_point(metric_id, tag_ids,
                                                     ts_ms, value)
        else:
            if rollup_agg is None:
                raise ValueError("missing rollup aggregator")
            kind = f"tier:{interval}:{rollup_agg.lower()}"
            sid = self.rollup_store.add_point(interval, rollup_agg,
                                              metric_id, tag_ids, ts_ms,
                                              value)
        if self.wal is not None:
            with self.wal.batch():
                self.wal.ensure_series(kind, sid, metric, tags)
                self.wal.log_point(kind, sid, ts_ms, value, False)
                self.wal.sync()
        self.datapoints_added += 1
        return sid

    # -- histogram points (ref: TSDB.add_histogram_batch :847,
    #    add_histogram_point :920) ---------------------------------------

    @staticmethod
    def _check_timestamp(timestamp: int) -> None:
        """(ref: TSDB.java:1274 checkTimestampAndTags)"""
        if timestamp <= 0:
            raise ValueError(f"invalid timestamp {timestamp}")
        if timestamp >= (1 << 32) and timestamp > (1 << 47):
            raise ValueError(f"timestamp out of range: {timestamp}")

    def _arena_append(self, landed: list) -> None:
        """Append histogram points to the arenas, one bulk append per
        (metric, bounds) class, move the version and log the points to
        the WAL, all under one take of the histogram lock. ``landed``
        holds ``(metric_id, sid, ts_ms, hist, record)`` per point, in
        order; ``record`` is the ``(metric, tags, ts, blob)`` to log, or
        None. A snapshot reads the WAL sequence and the arenas under the
        same lock (:func:`persist.save_store`), so a point is either in
        the snapshot and covered by its sequence, or in neither: replay
        never adds a point to an arena twice."""
        classes: dict[tuple, list] = {}
        for p in landed:
            classes.setdefault((p[0], p[3].bounds_key()), []).append(p)
        appends = []
        for (mid, key), pts in classes.items():
            rows = np.array([p[3].counts for p in pts],
                            dtype=np.float64).reshape(len(pts), -1)
            appends.append((mid, key, (
                np.array([p[2] for p in pts], dtype=np.int64),
                np.array([p[1] for p in pts], dtype=np.int64), rows,
                np.array([p[3].underflow for p in pts], dtype=np.int64),
                np.array([p[3].overflow for p in pts], dtype=np.int64))))
        with self._histogram_lock:
            for mid, key, cols in appends:
                arena = self._histogram_arenas.get(mid)
                if arena is None:
                    arena = self._histogram_arenas[mid] = HistogramArena()
                sub = arena.groups.get(key)
                if sub is None:
                    sub = arena.groups[key] = HistogramArena._Sub(
                        key, max(1, len(key) - 1))
                sub.append_many(*cols)
                arena.total_points += len(cols[0])
            self._histogram_version += 1
            if self.wal is not None:
                for *_p, record in landed:
                    if record is not None:
                        self.wal.log_histogram(*record)
                # records an enclosing batch scope holds take their
                # sequence numbers now, under the lock
                self.wal.flush_batch()

    def add_histogram_batch(self, points, on_error=None
                            ) -> tuple[int, list[str]]:
        """Bulk write ``(metric, timestamp, raw_blob, tags)`` histogram
        points, grouped by series so names are checked and UIDs
        resolved once per series (ref: ``add_histogram_batch``). A
        group checks its names, then each point's timestamp and blob,
        before it touches the UID tables: a group with no valid point
        makes no UID and no series. A failing point is reported through
        ``on_error(index, exc)``. The valid points land in one arena
        append with their WAL records (:meth:`_arena_append`), and the
        WAL syncs once. Returns (points written, error strings)."""
        groups: dict[tuple, list] = {}
        errors: list[str] = []
        landed: list[tuple] = []

        def fail(idx: int, metric: str, ts, e: Exception) -> None:
            errors.append(f"{metric} @{ts}: {e}")
            if on_error is not None:
                on_error(idx, e)

        for i, (metric, ts, blob, tags) in enumerate(points):
            key = (metric, tuple(sorted(tags.items())))
            groups.setdefault(key, []).append((i, ts, blob, tags))
        with self._wal_scope():
            for (metric, _), items in groups.items():
                tags = items[0][3]
                try:
                    tags_mod.check_metric_and_tags(metric, tags)
                except Exception as e:  # noqa: BLE001 - the group's error
                    for idx, ts, _b, _t in items:
                        fail(idx, metric, ts, e)
                    continue
                valid = []
                for idx, ts, blob, _t in items:
                    try:
                        self._check_timestamp(ts)
                        valid.append((idx, ts, blob, _to_ms(ts),
                                      self.histogram_manager.decode(blob)))
                    except Exception as e:  # noqa: BLE001 - a point's
                        fail(idx, metric, ts, e)
                if not valid:
                    continue
                try:
                    metric_id, (tag_ids,) = self._resolve_uids(metric,
                                                               [tags])
                    sid = self.histogram_store.get_or_create_series(
                        metric_id, tag_ids)
                except Exception as e:  # noqa: BLE001 - the group's
                    for idx, ts, _b, _tm, _h in valid:
                        fail(idx, metric, ts, e)
                    continue
                landed.extend((metric_id, sid, ts_ms, hist,
                               (metric, tags, ts, blob))
                              for _idx, ts, blob, ts_ms, hist in valid)
            if landed:
                self._arena_append(landed)
                if self.wal is not None:
                    self.wal.sync()
        self.datapoints_added += len(landed)
        return len(landed), errors

    def add_histogram_point(self, metric: str, timestamp: int,
                            raw_blob: bytes, tags: dict[str, str],
                            _wal: bool = True, create: bool = False) -> int:
        """Write one encoded histogram point; returns its series id (ref:
        TSDB.java:1132). Names, timestamp and blob are checked before
        any UID is made. ``create`` makes missing names whatever the
        auto-create keys say (WAL replay: the write was
        acknowledged)."""
        tags_mod.check_metric_and_tags(metric, tags)
        self._check_timestamp(timestamp)
        hist = self.histogram_manager.decode(raw_blob)
        metric_id, (tag_ids,) = self._resolve_uids(metric, [tags],
                                                   create=create)
        sid = self.histogram_store.get_or_create_series(metric_id, tag_ids)
        record = (metric, tags, timestamp, raw_blob) if _wal else None
        self._arena_append([(metric_id, sid, _to_ms(timestamp), hist,
                             record)])
        if record is not None and self.wal is not None:
            self.wal.sync()
        self.datapoints_added += 1
        return sid

    def _import_series(self, line: bytes) -> tuple[int, str, dict, int]:
        """The series id, metric and tags of one import line's series,
        created (with its UIDs) when new, and the metric's id."""
        text = line.decode("utf-8")
        # the parser splits on spaces and tabs only
        words = [w for w in text.replace("\t", " ").split(" ") if w]
        metric = words[0]
        tags = dict(w.partition("=")[::2] for w in words[3:])
        if not text.isascii():
            # the parser passes UTF-8 bytes through; names are checked
            # letter by letter here
            tags_mod.check_metric_and_tags(metric, tags)
        metric_id, (tag_ids,) = self._resolve_uids(metric, [tags])
        return (self.store.get_or_create_series(metric_id, tag_ids),
                metric, tags, metric_id)

    @_tapped
    def import_buffer(self, buf: bytes, on_error=None, durable: bool = True
                      ) -> tuple[int, list[str]]:
        """Columnar write of import lines (``metric ts value tagk=tagv
        ...``, one per line; ref: ``TSDB.import_buffer``). One native
        pass parses the buffer and labels each line with its series;
        each distinct series resolves its UIDs once, from its first
        line; the points land by ``append_lines``.

        Everything happens in line order: a series resolves when the
        walk reaches its first line, so new UIDs are assigned as a
        line-at-a-time writer would assign them, and a failing line
        (rejected by the parser, or of a series that fails to resolve)
        is reported through ``on_error(lineno, exc)`` only after every
        line before it has landed and been logged, so a caller may write
        it another way there. Blank and comment lines are skipped.
        With a WAL the lines are logged as the reference logs them (the
        new series' records, then one record of every line) under one
        batch scope and one sync; ``durable=False`` leaves them out of
        the log (the reference's ``setDurable(false)``). Returns (points
        written, error strings). Needs the native store."""
        self._check_writable()
        if self.store.backend != "native":
            raise RuntimeError("import_buffer parses with the native "
                               "store's library: it needs "
                               "tsd.storage.backend=native")
        parsed = parse_import_buffer(buf)
        gids, errs = parsed.group_ids, parsed.errors
        ts_ms = np.where(parsed.ts >= (1 << 32), parsed.ts,
                         parsed.ts * 1000)
        gsid = np.full(parsed.num_groups, -1, dtype=np.int64)
        gmid = np.full(parsed.num_groups, -1, dtype=np.int64)
        gnames: list = [None] * parsed.num_groups
        unlogged: list[int] = []    # groups resolved since the last log
        wal = self.wal if durable else None
        errors: list[str] = []
        done = written = logged = 0

        def line_sids(lo: int, hi: int) -> np.ndarray:
            g = gids[lo:hi]
            return np.where(g >= 0, gsid[np.maximum(g, 0)], -1)

        def land(upto: int) -> None:
            """Append the lines from the last stop up to ``upto``."""
            nonlocal done, written
            lo, done = done, upto + 1
            if upto > lo:
                written += self.store.append_lines(
                    line_sids(lo, upto), ts_ms[lo:upto],
                    parsed.values[lo:upto], parsed.is_int[lo:upto])

        def log(upto: int) -> None:
            """Log the lines not yet logged before ``upto``, after the
            records of the series resolved so far."""
            nonlocal logged
            lo, logged = logged, upto
            for g in sorted(unlogged):
                wal.ensure_series("data", int(gsid[g]), *gnames[g])
            unlogged.clear()
            wal.log_lines("data", line_sids(lo, upto), ts_ms[lo:upto],
                          parsed.values[lo:upto], parsed.is_int[lo:upto])

        def fail(i: int, exc: Exception) -> None:
            land(i)
            errors.append(f"line {i + 1}: {exc}")
            if on_error is not None:
                if wal is not None and (line_sids(logged, i) >= 0).any():
                    # what on_error writes must follow these lines
                    log(i + 1)
                on_error(i + 1, exc)

        # the walk stops at each failing line and each series' first
        # line, in line order (a heap: a series that fails to resolve
        # adds its later lines)
        valid = np.flatnonzero(gids >= 0)
        uniq, pos = np.unique(gids[valid], return_index=True)
        firsts = np.full(parsed.num_groups, -1, dtype=np.int64)
        firsts[uniq] = valid[pos]
        stops = np.union1d(np.flatnonzero(errs > 0), firsts[uniq]).tolist()
        failed: dict[int, Exception] = {}
        with self._wal_scope():
            while stops:
                i = heapq.heappop(stops)
                code, g = int(errs[i]), int(gids[i])
                if code > 0:
                    fail(i, ValueError(IMPORT_ERRORS[code]))
                elif g in failed:
                    fail(i, failed[g])
                else:
                    try:
                        sid, metric, tags, mid = self._import_series(
                            parsed.rep_lines[g])
                        gsid[g], gnames[g] = sid, (metric, tags)
                        gmid[g] = mid
                        unlogged.append(g)
                    except (ValueError, LookupError,
                            FailedToAssignUniqueIdError) as e:
                        failed[g] = e
                        for j in (np.flatnonzero(gids[i + 1:] == g)
                                  + i + 1).tolist():
                            heapq.heappush(stops, j)
                        fail(i, e)
            land(len(gids))
            if wal is not None and parsed.num_groups:
                if logged < len(gids):
                    log(len(gids))
                wal.sync()
        self.datapoints_added += written
        if self._streaming is not None and written:
            # the landed lines, by metric (a line of a failed series or
            # one the parser rejected has sid -1 and did not land)
            sids = line_sids(0, len(gids))
            landed = np.flatnonzero((sids >= 0) & (errs == 0))
            mids = gmid[gids[landed]]
            for mid in np.unique(mids).tolist():
                rows = landed[mids == mid]
                self._tap_lines(mid, sids[rows], ts_ms[rows],
                                parsed.values[rows])
        return written, errors

    # -- query path -------------------------------------------------------

    def new_query(self):
        from opentsdb_tpu_torch.query.engine import QueryEngine
        return QueryEngine(self)

    def execute_query(self, ts_query) -> list:
        """Run a validated TSQuery end-to-end, returning result groups
        (the call the reference's ``/api/query`` handler makes)."""
        return self.new_query().run(ts_query)
