"""The TSDB facade (ref: ``src/core/TSDB.java:87``).

Owns the UID registry and the store, and is where a caller picks the
device: ``tsd.torch.device`` is ``"cuda"`` unless the caller asks for
``"cpu"``, and constructing a TSDB on ``cuda`` raises when no card is
present. Writes go to the store that ``tsd.storage.backend`` names
(the native C++ store by default, or the memory store). On the native
store, :meth:`TSDB.import_buffer` takes whole bursts of import lines
through one native parse.

With ``tsd.storage.data_dir`` set, writes are durable as in the
reference, on either store: construction loads the directory's
snapshot (:mod:`~opentsdb_tpu_torch.core.persist`) and replays its
write-ahead log (:mod:`~opentsdb_tpu_torch.core.wal`,
``tsd.storage.wal.enable``, on by default), every write path logs
under one WAL batch scope and syncs once before it returns,
:meth:`TSDB.flush` snapshots and truncates the log, and
:meth:`TSDB.shutdown` flushes and closes it. Without a data_dir
nothing written survives the process.

The TSDB holds the annotations (:attr:`TSDB.annotations`), the TSMeta
and UIDMeta documents (:attr:`TSDB.meta`) and the trees
(:func:`~opentsdb_tpu_torch.tree.tree.tree_manager`), and loads the
plugin slots and the authenticator when it is built
(:meth:`TSDB.initialize_plugins`). The write filters and the UID
filter run before a point is written; the meta tracking, the external
meta cache and the realtime publisher run after it is durable, through
:meth:`TSDB._run_hook`, which counts a hook's failure and never fails
the write. A write filter, the publisher or the meta cache is a
per-point hook: the writes of many points then call it once per
point.

The TSDB also owns the serve path's caches (the device cache, the
result cache and the per-metric tag matrices), the sub-query fan-out
pool (:meth:`TSDB.shutdown` stops it), the query limits, the stats
registry the front end reads (``/api/stats``, telnet ``stats``), and
the continuous-query registry (:attr:`TSDB.streaming`, made at first
use). Every raw write path offers its acknowledged points to that
registry after the write (and its WAL sync) is done, under a
:class:`TapGate` that a partial's re-seed holds alone.

The TSDB owns the observability layer (``obs/``): the request tracer
(:attr:`TSDB.tracer`, which feeds the per-stage latency histograms and
writes the query-shape log under the data_dir), the self-telemetry pump
(:attr:`TSDB.telemetry`), the sampling profiler (:attr:`TSDB.profiler`)
and the SLO burn tracker (:attr:`TSDB.slo`); the server starts the pump
and the profiler, :meth:`TSDB.shutdown` joins them. With
``tsd.control.enable`` the control plane (:attr:`TSDB.control`,
``control/``) is made at first use. The constructor warns of every
configured ``tsd.*`` key the port does not read
(:meth:`Config.warn_unknown_keys`).

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
from opentsdb_tpu_torch.meta.annotation import AnnotationStore
from opentsdb_tpu_torch.meta.meta_store import MetaStore
from opentsdb_tpu_torch.native.store_backend import (IMPORT_ERRORS,
                                                     make_store,
                                                     parse_import_buffer)
from opentsdb_tpu_torch.obs.profiler import SamplingProfiler
from opentsdb_tpu_torch.obs.slo import SloTracker
from opentsdb_tpu_torch.obs.telemetry import SelfTelemetry
from opentsdb_tpu_torch.obs.trace import Tracer, trace_begin, trace_end
from opentsdb_tpu_torch.parallel import distributed
from opentsdb_tpu_torch.parallel.mesh import (default_devices,
                                              mesh_from_spec,
                                              parse_mesh_spec)
from opentsdb_tpu_torch.query.device_cache import DeviceGridCache
from opentsdb_tpu_torch.query.limits import QueryLimitOverride
from opentsdb_tpu_torch.query.result_cache import QueryResultCache
from opentsdb_tpu_torch.rollup.config import RollupConfig
from opentsdb_tpu_torch.rollup.store import RollupStore
from opentsdb_tpu_torch.stats.stats import (ServePayloadStats,
                                            StatsCollectorRegistry)
from opentsdb_tpu_torch.utils.config import Config
from opentsdb_tpu_torch.utils.faults import (CircuitBreaker, FaultInjector,
                                             RetryPolicy, call_with_retries)
from opentsdb_tpu_torch.utils.plugin import load_plugin_instances

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the bits of a timestamp above the seconds range (ref: Const.SECOND_MASK)
_SECOND_MASK = 0xFFFFFFFF00000000
# points per WAL record of a bulk write (25 bytes each)
_WAL_LINES = 1 << 22


class PartialWriteError(Exception):
    """A write of many points landed ``written`` of them before one
    failed (ref: ``PartialWriteError``): raised by the per-point hook
    path of :meth:`TSDB.add_points`, so a caller replays only the rest.
    The hooks already ran for the landed points and are not
    idempotent."""

    def __init__(self, written: int, cause: Exception):
        super().__init__(str(cause))
        self.written = written
        self.cause = cause


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
        # a typo'd or unported knob would be ignored silently: warn of
        # every configured key the port does not read (ref:
        # TSDB.__init__)
        self.config.warn_unknown_keys()
        # a typo'd mesh spec raises ValueError here, as at the
        # reference's boot
        parse_mesh_spec(self.config.get_string("tsd.query.mesh", ""))
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
        # fault injection (armed by tsd.faults.* keys; one dict miss per
        # site when disarmed): the WAL, the snapshot flush, the store
        # scans and the lifecycle check it
        self.faults = FaultInjector(self.config)
        # raises when the native library does not build (no fallback)
        self.store = make_store(self.config)
        self.store.fault_injector = self.faults
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
        self.stats.register(self.faults)
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
                self.rollup_config, lambda: make_store(self.config),
                fault_injector=self.faults)
        self.data_dir = self.config.get_string("tsd.storage.data_dir")
        # observability (obs/): the tracer (tsd.trace.enable=false makes
        # every trace site one thread-local read returning None), the
        # self-telemetry pump and the sampling profiler (started by the
        # server, joined by shutdown) and the SLO burn tracker
        self.tracer = Tracer(self.config, data_dir=self.data_dir,
                             stats=self.stats)
        self.stats.register(self.tracer)
        self.telemetry = SelfTelemetry(self)
        self.stats.register(self.telemetry)
        self.profiler = SamplingProfiler(self)
        self.stats.register(self.profiler)
        self.slo = SloTracker(self.config)
        self.stats.register(self.slo)
        # the control plane (control/), made at first use by the
        # ``control`` property; the server's admission seam reads this
        # attribute, one read per query while it is off
        self._control = None
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
        # the data lifecycle (lifecycle/), made at first use by the
        # ``lifecycle`` property when tsd.lifecycle.enable is true
        self._lifecycle = None
        # the cluster router (cluster/), made at first use by the
        # ``cluster`` property on a tsd.cluster.role=router TSD; the
        # health endpoint reads this attribute so as not to make it
        self._cluster = None
        self.tap_gate = TapGate()
        # errors of post-write hooks, by hook (``_run_hook``; the
        # streaming tap, ``_tap``): a hook never fails a write that
        # already happened
        self.hook_errors: dict[str, int] = {}
        # set by tsd/warmup.py's thread: a stopping server stops it
        self._warmup_stop: threading.Event | None = None
        # annotations, TSMeta/UIDMeta and trees (meta/, tree/); the
        # tree manager is made at first use (tree.tree.tree_manager)
        self.annotations = AnnotationStore()
        self.meta = MetaStore(self)
        self._tree_manager = None
        # plugin slots (ref: TSDB.java:146-167), loaded by
        # initialize_plugins at the end of construction
        self.rt_publisher = None
        self.search_plugin = None
        self.storage_exception_handler = None
        self.write_filters: list = []
        self.uid_filter = None
        self.meta_cache = None
        self.authentication = None
        # any per-point hook on: the writes of many points call them
        # point by point (set by initialize_plugins)
        self._point_hooks = False
        if self.data_dir:
            self._open_data_dir()
        try:
            self.initialize_plugins()
        except BaseException:
            if self.wal is not None:
                self.wal.close()    # no thread of a TSDB that did not start
            raise

    def _open_data_dir(self) -> None:
        """Load the snapshot, then open the WAL and replay what the
        snapshot does not cover (ref: TSDB.__init__). Both stores keep
        the per-point integer flag the formats carry."""
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
        self.annotations.wal = wal

    def initialize_plugins(self) -> None:
        """Load the plugin slots and the authenticator (ref:
        ``TSDB.initialize_plugins``, TSDB.java initializePlugins :390).
        The TSDB calls it when it is built, so no configured slot is
        left unloaded. A slot loads when
        ``<prefix>.enable`` is true and ``<prefix>.plugin`` names a
        class (:func:`~opentsdb_tpu_torch.utils.plugin.
        load_plugin_instances`); a class that does not import raises
        here, and the TSDB is not built."""
        cfg = self.config
        self.rt_publisher = load_plugin_instances(
            cfg, "tsd.rtpublisher", single=True, init_arg=self)
        self.search_plugin = load_plugin_instances(
            cfg, "tsd.search", single=True, init_arg=self)
        self.storage_exception_handler = load_plugin_instances(
            cfg, "tsd.core.storage_exception_handler", single=True,
            init_arg=self)
        # a filter may opt out of the per-point call
        # (ref: WriteableDataPointFilterPlugin.filterDataPoints)
        self.write_filters = [
            f for f in load_plugin_instances(
                cfg, "tsd.core.write_filter", init_arg=self)
            if not hasattr(f, "filter_data_points")
            or f.filter_data_points()]
        self.uid_filter = load_plugin_instances(
            cfg, "tsd.uid.filter", single=True, init_arg=self)
        self.meta_cache = load_plugin_instances(
            cfg, "tsd.core.meta.cache", single=True, init_arg=self)
        if cfg.get_bool("tsd.core.authentication.enable"):
            from opentsdb_tpu_torch.auth.simple import SimpleAuthentication
            self.authentication = SimpleAuthentication(cfg)
        self._point_hooks = bool(self.write_filters
                                 or self.rt_publisher is not None
                                 or self.meta_cache is not None)

    def _run_hook(self, name: str, fn, *args) -> None:
        """Run one post-write hook (the meta tracking, the external meta
        cache, the realtime publisher, the tree filing). The point is
        durable when it runs, so a failure must not fail the write: the
        client would retry a write that happened. It is counted
        (``hooks.errors`` in /api/stats, by hook) and logged, as the
        reference's ``_run_hook`` does; the write goes on. This is the
        reference's contract for hooks, not a fallback of a device
        path."""
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 - the write is acknowledged
            n = self.hook_errors.get(name, 0) + 1
            self.hook_errors[name] = n
            if n <= 5 or n % 1000 == 0:
                logging.getLogger("tsdb").exception(
                    "%s hook failed (%d so far); the write itself "
                    "succeeded", name, n)

    def _wal_group_window_ms(self) -> int:
        """``tsd.storage.wal.group_window_ms`` with the reference's
        role-aware default (ref: ``TSDB._wal_group_window_ms``): ""
        (unset) means 0 standalone but 2 ms on a cluster shard, where
        every client of the router writes concurrently, so a commit
        window amortizes fsyncs. An explicit value, 0 included, wins."""
        raw = self.config.get_string("tsd.storage.wal.group_window_ms",
                                     "").strip()
        if raw:
            return int(raw)
        role = self.config.get_string("tsd.cluster.role", "").strip()
        return 2 if role == "shard" else 0

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
                self.stats.register(self._result_cache)
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

    @property
    def lifecycle(self):
        """The data-lifecycle manager
        (:mod:`opentsdb_tpu_torch.lifecycle.manager`), made at first use,
        or None while ``tsd.lifecycle.enable`` is false, the default
        (ref: ``TSDB.lifecycle``). The query engine asks it for the
        stitched tier views; the server starts its sweeper."""
        if not self.config.get_bool("tsd.lifecycle.enable", False):
            return None
        if self._lifecycle is None:
            with self._device_cache_lock:
                if self._lifecycle is None:
                    from opentsdb_tpu_torch.lifecycle.manager import \
                        LifecycleManager
                    lc = LifecycleManager(self)
                    self.stats.register(lc)
                    self._lifecycle = lc
        return self._lifecycle

    @property
    def cluster(self):
        """The cluster router (:mod:`opentsdb_tpu_torch.cluster.router`),
        made at first use, or None unless this TSD runs as
        ``tsd.cluster.role = router`` (ref: ``TSDB.cluster``). The HTTP
        and telnet layers branch writes and reads through it; shards
        and standalone TSDs serve locally."""
        if self.config.get_string("tsd.cluster.role", "") != "router":
            return None
        if self._cluster is None:
            with self._device_cache_lock:
                if self._cluster is None:
                    from opentsdb_tpu_torch.cluster.router import \
                        ClusterRouter
                    router = ClusterRouter(self)
                    self.stats.register(router)
                    self._cluster = router
        return self._cluster

    @property
    def control(self):
        """The control plane (:mod:`opentsdb_tpu_torch.control.plane`),
        made at first use, or None while ``tsd.control.enable`` is false,
        the default (ref: ``TSDB.control``). Getting it attaches the
        tenant QoS's result-cache insert gate."""
        if not self.config.get_bool("tsd.control.enable", False):
            return None
        if self._control is None:
            with self._device_cache_lock:
                if self._control is None:
                    from opentsdb_tpu_torch.control.plane import \
                        ControlPlane
                    ctl = ControlPlane(self)
                    self.stats.register(ctl)
                    self._control = ctl
        # outside the lock: wire() makes the result cache, which takes it
        self._control.wire()
        return self._control

    def purge_histograms_before(self, metric_id: int,
                                cutoff_ms: int) -> int:
        """Drop one metric's histogram points older than ``cutoff_ms``
        and move the histogram version and the histogram store's epoch,
        so every read-side cache drops them (ref:
        ``TSDB.purge_histograms_before``; the lifecycle's retention and
        histogram spill). Returns the points removed."""
        with self._histogram_lock:
            arena = self._histogram_arenas.get(metric_id)
            if arena is None:
                return 0
            removed = arena.purge_before(cutoff_ms)
            if removed:
                if not arena.groups:
                    del self._histogram_arenas[metric_id]
                self._histogram_version += 1
                self.histogram_store.mutation_epoch += 1
        return removed

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
        ``TSDB.serve_version``): the raw store, the histograms, the
        annotations and the rollup tiers with the preagg store. A write
        or a delete to any of them changes it."""
        parts = [*self.store.version, self._histogram_version,
                 *self.histogram_store.version, self.annotations.version]
        if self.rollup_store is not None:
            parts.append(self.rollup_store.version())
        return tuple(parts)

    def _stores(self) -> list:
        """(name, store) of the raw store and of each rollup store."""
        stores = [("raw", self.store)]
        if self.rollup_store is not None:
            stores.append(("rollup:preagg", self.rollup_store.preagg_store()))
            stores += [(f"rollup:{interval}:{agg}", store) for
                       (interval, agg), store in self.rollup_store.tiers()]
        return stores

    @staticmethod
    def _footprint(stores) -> dict:
        """Each store's ``memory_info`` that reports one, and their
        totals."""
        out = {name: store.memory_info() for name, store in stores
               if hasattr(store, "memory_info")}
        totals = {"resident_bytes": 0, "live_bytes": 0, "dead_bytes": 0,
                  "series": 0, "points": 0}
        for info in out.values():
            for k in totals:
                totals[k] += info.get(k, 0)
        out["total"] = totals
        return out

    def memory_info(self) -> dict:
        """Footprint by store (ref: ``TSDB.memory_info``): series,
        points and bytes of the raw store and of each rollup store that
        reports them (the native store does), and their totals."""
        return self._footprint(self._stores())

    def storage_memory_info(self) -> dict:
        """Footprint by store for ``/api/health``'s storage section (ref:
        ``TSDB.storage_memory_info``): :meth:`memory_info`'s stores and
        the histogram index, with the cold tier's disk-resident segments
        apart from RAM (``cold``, ``total.cold_bytes``)."""
        stores = self._stores()
        stores.insert(1, ("histogram", self.histogram_store))
        lc = self._lifecycle
        cold = lc.coldstore if lc is not None else None
        if cold is not None:
            stores.append(("cold", cold))
        out = self._footprint(stores)
        out["total"]["cold_bytes"] = out["cold"]["disk_bytes"] \
            if cold is not None else 0
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

    def shutdown(self, flush: bool = True) -> None:
        """Stop the control plane first (it steers the rest), the
        self-telemetry pump, the profiler, a running warmup, the
        cluster router (its replay thread, wire links and fan-out pool)
        and the lifecycle's sweeper, close the query-shape log, flush, stop the
        continuous queries' fold workers and the fan-out pool (waiting
        for every thread to end), close the WAL, then shut the realtime
        publisher and the search plugin down (ref: ``TSDB.shutdown``).
        ``flush=False`` leaves the snapshot as it is (the command line's
        read-only commands, which the reference does not flush): what
        was written since is in the WAL."""
        if self._control is not None:
            self._control.stop()
        self.telemetry.stop()
        self.profiler.stop()
        if self._warmup_stop is not None:
            self._warmup_stop.set()
        if self._cluster is not None:
            self._cluster.stop()
        if self._lifecycle is not None:
            self._lifecycle.stop()
        self.tracer.close()
        if flush:
            self.flush()
        if self._streaming is not None:
            self._streaming.shutdown()
        with self._device_cache_lock:
            pool, self._fanout_pool = self._fanout_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        if self.wal is not None:
            self.wal.close()
        if self.rt_publisher is not None:
            self.rt_publisher.shutdown()
        if self.search_plugin is not None:
            self.search_plugin.shutdown()

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
        lc = self._lifecycle
        cold = lc.coldstore if lc is not None else None
        collector.record("storage.cold_bytes",
                         cold.cold_bytes() if cold is not None else 0)
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
        write they belong to was acknowledged). With a UID filter, names
        resolve one at a time (:meth:`_resolve_uids_filtered`)."""
        if self.uid_filter is not None and not create:
            return self._resolve_uids_filtered(metric, tags_list)

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

    def _resolve_uids_filtered(self, metric: str,
                               tags_list: Sequence[dict[str, str]]
                               ) -> tuple[int, list[list[tuple[int, int]]]]:
        """:meth:`_resolve_uids` under the UID filter (ref:
        ``_resolve_write_uids``, UniqueIdFilterPlugin.allowUIDAssignment):
        name by name in the order a per-point write meets them, the
        filter asked before a new name gets a UID. A name it rejects
        raises FailedToAssignUniqueIdError; the names before it keep
        theirs."""
        def resolve(registry, kind: str, name: str, auto: bool,
                    tags: dict) -> int:
            if not auto:
                return registry.get_id(name)
            if not registry.has_name(name) and \
                    not self.uid_filter.allow_uid_assignment(
                        kind, name, metric, tags):
                raise FailedToAssignUniqueIdError(
                    f"UID filter rejected assignment of {kind} {name!r}")
            return registry.get_or_create_id(name)

        metric_id = resolve(self.uids.metrics, "metric", metric,
                            self.auto_metric,
                            tags_list[0] if tags_list else {})
        out = []
        for tags in tags_list:
            out.append([(resolve(self.uids.tag_names, "tagk", k,
                                 self.auto_tagk, tags),
                         resolve(self.uids.tag_values, "tagv", v,
                                 self.auto_tagv, tags))
                        for k, v in tags.items()])
        return metric_id, out

    def _check_writable(self) -> None:
        if self.mode == "ro":
            raise PermissionError("TSD is in read-only mode")

    @_tapped
    def add_point(self, metric: str, timestamp: int, value: int | float,
                  tags: dict[str, str], durable: bool = True) -> int:
        """Write one datapoint; returns the series id, or -1 when a write
        filter turned it away (ref: TSDB.addPoint :1012/:1057/:1097).
        The timestamp is checked first, with the reference's per-point
        messages, then the names, then the write filters.
        ``durable=False`` leaves the point out of the WAL (the
        reference's ``setDurable(false)``)."""
        self._check_writable()
        if timestamp <= 0:
            raise ValueError(f"invalid timestamp {timestamp}")
        if timestamp >= (1 << 32) and timestamp > (1 << 47):
            raise ValueError(f"timestamp out of range: {timestamp}")
        if self.write_filters:
            tags_mod.check_metric_and_tags(metric, tags)
            if not self._allowed(metric, timestamp, value, tags):
                return -1
        metric_id, sid, ts_ms, vals = self._write_series(
            metric, [timestamp], [float(value)], tags,
            [type(value) is int], durable=durable)
        if self._streaming is not None:
            # the scalar tap: a tuple append, no numpy per point
            self._tap(self._streaming.offer, metric_id, sid,
                      int(ts_ms[0]), float(vals[0]))
        if self._point_hooks or self.meta.track_ts:
            tag_ids = self.store.series(sid).tags
            self._series_hooks(metric_id, tag_ids, sid, 1)
            if self._point_hooks:
                self._point_hook(self.uids.tsuid(metric_id, tag_ids),
                                 metric, timestamp, value, tags)
        return sid

    def _allowed(self, metric: str, timestamp: int, value,
                 tags: dict[str, str]) -> bool:
        """Whether every write filter lets the point through (ref:
        ``allow_data_point``, TSDB.java:1262)."""
        for filt in self.write_filters:
            allow = getattr(filt, "allow_data_point", filt)
            if not allow(metric, timestamp, value, tags):
                return False
        return True

    def _series_hooks(self, metric_id: int, tag_ids, sid: int,
                      count: int) -> None:
        """The meta hook of ``count`` points written to one series: the
        built-in TSMeta tracking, unless an external meta cache takes
        its place (ref: TSDB.java:1225-1245)."""
        if self.meta_cache is None and self.meta.track_ts:
            self._run_hook("meta", self.meta.on_datapoint, metric_id,
                           tag_ids, sid, count)

    def _point_hook(self, tsuid: bytes, metric: str, timestamp: int,
                    value, tags: dict[str, str]) -> None:
        """The per-point hooks of one written point: the external meta
        cache's counter and the realtime publisher (ref: add_point's
        hooks), each through :meth:`_run_hook`."""
        if self.meta_cache is not None:
            self._run_hook("meta_cache",
                           self.meta_cache.increment_and_get_counter,
                           tsuid)
        if self.rt_publisher is not None:
            self._run_hook("rt_publisher",
                           self.rt_publisher.publish_data_point,
                           metric, timestamp, value, tags, tsuid)

    @_tapped
    def add_points(self, metric: str, timestamps, values,
                   tags: dict[str, str], is_int=None) -> int:
        """Bulk write many points of ONE series; returns the series id.
        The whole batch is validated before anything is written.
        ``is_int`` is one integer flag or one per point (by default,
        whether the values' dtype is an integer one); both stores keep
        them. With a per-point hook on, the points go one by one
        through :meth:`add_point` (ref: ``add_points``), under one WAL
        scope; a failure raises :class:`PartialWriteError` with the
        count that landed."""
        self._check_writable()
        if self._point_hooks:
            return self._add_points_hooked(metric, timestamps, values,
                                           tags, is_int)
        metric_id, sid, ts_ms, vals = self._write_series(
            metric, timestamps, values, tags, is_int)
        if self._streaming is not None:
            self._tap_lines(metric_id, np.full(len(ts_ms), sid, np.int64),
                            ts_ms, vals)
        if self.meta.track_ts:
            self._series_hooks(metric_id, self.store.series(sid).tags, sid,
                               len(ts_ms))
        return sid

    def _add_points_hooked(self, metric: str, timestamps, values,
                           tags: dict[str, str], is_int) -> int:
        """:meth:`add_points` with a per-point hook on: the batch is
        validated whole, then each point is one :meth:`add_point`."""
        raw = np.asarray(values)
        if np.shape(timestamps) != raw.shape or raw.ndim != 1:
            raise ValueError("timestamps/values must be equal-length 1-D")
        normalize_timestamps(timestamps)
        tags_mod.check_metric_and_tags(metric, tags)
        if is_int is None:
            is_int = np.issubdtype(raw.dtype, np.integer)
        flags = np.broadcast_to(np.asarray(is_int, dtype=bool), raw.shape)
        sid = -1
        done = 0
        with self._wal_scope():
            for t, v, f in zip(np.asarray(timestamps).tolist(),
                               raw.tolist(), flags.tolist()):
                try:
                    sid = self.add_point(metric, int(t),
                                         int(v) if f else float(v), tags)
                except Exception as e:  # noqa: BLE001 - reported below
                    raise PartialWriteError(done, e) from e
                done += 1
        return sid

    def _write_series(self, metric: str, timestamps, values,
                      tags: dict[str, str], is_int, durable: bool = True):
        """The write of :meth:`add_points`, logged (unless not
        ``durable``) and synced; returns (metric id, series id,
        timestamps in ms, float64 values)."""
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
        if self.wal is not None and durable:
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

        def replay(metric, tags, refs, ts_list, raw, first: int) -> None:
            nonlocal written
            for j in range(first, len(ts_list)):
                try:
                    # a point a write filter turns away counts as
                    # written, as in the reference
                    self.add_point(metric, ts_list[j], raw[j], tags)
                    written += 1
                except Exception as e:  # noqa: BLE001 - a point's error
                    errors.append(f"{metric} @{ts_list[j]}: {e}")
                    if on_error is not None:
                        on_error(refs[j], e)

        # the whole request commits as one WAL write and one fsync
        with self._wal_scope():
            for metric, tags, refs, ts_list, raw in groups:
                try:
                    self.add_points(metric, ts_list, raw, tags,
                                    is_int=[type(v) is int for v in raw])
                    written += len(ts_list)
                except PartialWriteError as pe:
                    # the hooked loop landed pe.written points and the
                    # next failed after its hooks may have run: it is
                    # not retried (hooks are not idempotent), the rest
                    # replay point by point
                    k = pe.written
                    written += k
                    errors.append(f"{metric} @{ts_list[k]}: {pe.cause}")
                    if on_error is not None:
                        on_error(refs[k], pe.cause)
                    replay(metric, tags, refs, ts_list, raw, k + 1)
                except Exception:  # noqa: BLE001 - replayed per point
                    # nothing landed: every point on its own, so the good
                    # ones land and each error maps to its point
                    replay(metric, tags, refs, ts_list, raw, 0)
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
        store takes one append. Returns the series ids.

        The hooks run per series and per point: the write filters ask
        for each point before anything is written (a row they empty
        makes no series, and its id is -1), the meta tracking counts
        each series' points once, and the meta cache and the realtime
        publisher see each point."""
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
        rows = None
        if self.write_filters:
            present = np.ones(ts2d.shape, dtype=bool) if sids_rows is None \
                else sids_rows.copy()
            for i, j in zip(*np.nonzero(present)):
                v = float(values2d[i, j])
                present[i, j] = self._allowed(
                    metric, int(ts2d[i, j]), int(v) if is_int else v,
                    tags_list[i])
            n_rows = ts2d.shape[0]
            if not present.any(axis=1).all():
                rows = np.flatnonzero(present.any(axis=1))
                if not len(rows):
                    # nothing passed: no UID and no series is made
                    return np.full(n_rows, -1, dtype=np.int64)
                tags_list = [tags_list[i] for i in rows.tolist()]
                ts2d, values2d, present = ts2d[rows], values2d[rows], \
                    present[rows]
            sids_rows = present
            ts_flat, val_flat = ts2d[present], values2d[present]
            ts_ms = normalize_timestamps(ts_flat) if len(ts_flat) \
                else ts_flat
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
        if self._point_hooks or self.meta.track_ts:
            per_row = np.full(len(sids), ts2d.shape[1], dtype=np.int64) \
                if sids_rows is None else sids_rows.sum(axis=1)
            for i, sid in enumerate(sids.tolist()):
                if not per_row[i]:
                    continue        # a row with no point writes none
                self._series_hooks(metric_id, tag_ids[i], sid,
                                   int(per_row[i]))
                if not self._point_hooks:
                    continue
                tsuid = self.uids.tsuid(metric_id, tag_ids[i])
                cells = slice(None) if sids_rows is None else sids_rows[i]
                for t, v in zip(ts2d[i][cells].tolist(),
                                values2d[i][cells].tolist()):
                    self._point_hook(tsuid, metric, t,
                                     int(v) if is_int else v, tags_list[i])
        if rows is not None:
            out = np.full(n_rows, -1, dtype=np.int64)
            out[rows] = sids
            return out
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
        tier of ``interval`` and ``rollup_agg``. The realtime publisher
        sees it (``publish_aggregate_point``, RTPublisher.java's
        publishAggregatePoint)."""
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
        if self.rt_publisher is not None:
            self._run_hook("rt_publisher",
                           self.rt_publisher.publish_aggregate_point,
                           metric, timestamp, value, tags,
                           self.uids.tsuid(metric_id, tag_ids))
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
        WAL syncs once; then the realtime publisher sees each
        (``publish_histogram_point``). Returns (points written, error
        strings)."""
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
        for metric_id, sid, _ts, _h, record in landed:
            self._publish_histogram(metric_id, sid, record)
        return len(landed), errors

    def _publish_histogram(self, metric_id: int, sid: int, record) -> None:
        """The realtime publisher's hook of one written histogram point
        ``record`` = (metric, tags, timestamp, blob)."""
        if self.rt_publisher is not None:
            metric, tags, ts, blob = record
            self._run_hook(
                "rt_publisher", self.rt_publisher.publish_histogram_point,
                metric, ts, blob, tags, self.uids.tsuid(
                    metric_id, self.histogram_store.series(sid).tags))

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
        if record is not None:
            self._publish_histogram(metric_id, sid, record)
        return sid

    @staticmethod
    def _import_names(line: bytes) -> tuple[str, dict]:
        """The metric and tags of one import line."""
        text = line.decode("utf-8")
        # the parser splits on spaces and tabs only
        words = [w for w in text.replace("\t", " ").split(" ") if w]
        metric = words[0]
        tags = dict(w.partition("=")[::2] for w in words[3:])
        if not text.isascii():
            # the parser passes UTF-8 bytes through; names are checked
            # letter by letter here
            tags_mod.check_metric_and_tags(metric, tags)
        return metric, tags

    def _import_series(self, line: bytes) -> tuple[int, str, dict, int]:
        """The series id, metric and tags of one import line's series,
        created (with its UIDs) when new, and the metric's id."""
        metric, tags = self._import_names(line)
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
        written, error strings). Needs the native store.

        With a per-point hook on, each line is one :meth:`add_point`
        instead (the reference's ``use_hooks`` path,
        :meth:`_import_hooked`); with meta tracking alone, each series'
        landed lines are counted once."""
        self._check_writable()
        if self.store.backend != "native":
            raise RuntimeError("import_buffer parses with the native "
                               "store's library: it needs "
                               "tsd.storage.backend=native")
        # the stages of a traced burst (ref: import_buffer's spans):
        # decode is the parse and the series' resolution walk
        h_dec = trace_begin("ingest.decode")
        parsed = parse_import_buffer(buf)
        if h_dec is not None:
            h_dec.tag(lines=int(parsed.num_lines),
                      groups=int(parsed.num_groups))
        if self._point_hooks:
            trace_end(h_dec)
            return self._import_hooked(parsed, on_error, durable)
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
            trace_end(h_dec)
            h_sc = trace_begin("store.scatter")
            land(len(gids))
            trace_end(h_sc)
            if wal is not None and parsed.num_groups:
                if logged < len(gids):
                    log(len(gids))
                wal.sync()
        self.datapoints_added += written
        if self._streaming is not None and written:
            # the landed lines, by metric (a line of a failed series or
            # one the parser rejected has sid -1 and did not land)
            h_tap = trace_begin("stream.tap")
            sids = line_sids(0, len(gids))
            landed = np.flatnonzero((sids >= 0) & (errs == 0))
            mids = gmid[gids[landed]]
            for mid in np.unique(mids).tolist():
                rows = landed[mids == mid]
                self._tap_lines(mid, sids[rows], ts_ms[rows],
                                parsed.values[rows])
            trace_end(h_tap)
        if self.meta.track_ts and written:
            # each series' landed lines, counted once (ref: the bulk
            # path's meta hook)
            landed = gids[(line_sids(0, len(gids)) >= 0) & (errs == 0)]
            counts = np.bincount(landed, minlength=parsed.num_groups)
            for g in np.flatnonzero(counts).tolist():
                sid = int(gsid[g])
                self._series_hooks(int(gmid[g]),
                                   self.store.series(sid).tags, sid,
                                   int(counts[g]))
        return written, errors

    def _import_hooked(self, parsed, on_error, durable: bool
                       ) -> tuple[int, list[str]]:
        """:meth:`import_buffer` with a per-point hook on: each line, in
        line order, is one :meth:`add_point` under one WAL scope (ref:
        ``use_hooks``). A line a write filter turns away counts as
        written, as in the reference."""
        errors: list[str] = []
        names: dict[int, tuple] = {}    # each series' metric and tags
        written = 0
        values = parsed.values.tolist()
        with self._wal_scope():
            for i, (code, g, t, f) in enumerate(zip(
                    parsed.errors.tolist(), parsed.group_ids.tolist(),
                    parsed.ts.tolist(), parsed.is_int.tolist())):
                if code == 0 and g < 0:
                    continue            # a blank or comment line
                try:
                    if code > 0:
                        raise ValueError(IMPORT_ERRORS[code])
                    if g not in names:
                        names[g] = self._import_names(parsed.rep_lines[g])
                    metric, tags = names[g]
                    self.add_point(metric, t,
                                   int(values[i]) if f else values[i],
                                   tags, durable=durable)
                    written += 1
                except Exception as e:  # noqa: BLE001 - the line's error
                    errors.append(f"line {i + 1}: {e}")
                    if on_error is not None:
                        on_error(i + 1, e)
        return written, errors

    # -- query path -------------------------------------------------------

    def new_query(self):
        from opentsdb_tpu_torch.query.engine import QueryEngine
        return QueryEngine(self)

    def execute_query(self, ts_query) -> list:
        """Run a validated TSQuery end-to-end, returning result groups
        (the call the reference's ``/api/query`` handler makes)."""
        return self.new_query().run(ts_query)
