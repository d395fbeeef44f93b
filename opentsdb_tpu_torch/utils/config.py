"""Flat ``tsd.*`` configuration (ref: ``src/utils/Config.java``).

A flat string->string property map with typed getters and defaults,
holding only the keys the PyTorch port reads. Keys keep the
reference's ``tsd.`` namespace; port-specific keys live under
``tsd.torch.*``.

Every key the port reads is declared: in ``_DEFAULTS``, in
``_DECLARED_EXTRA`` (a default at the call site), under a dynamic
prefix, or under the prefix of a plugin slot the config enables.
:meth:`Config.warn_unknown_keys`, called when a TSDB is built, logs one
warning per configured ``tsd.*`` key nothing reads, as the reference's
does (``opentsdb_tpu/utils/config.py``), so a typo'd or unported knob
is not silently ignored.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Any

from opentsdb_tpu_torch.utils.plugin import PLUGIN_SLOTS

log = logging.getLogger("config")

_DEFAULTS: dict[str, str] = {
    "tsd.core.auto_create_metrics": "false",
    "tsd.core.auto_create_tagks": "true",
    "tsd.core.auto_create_tagvs": "true",
    "tsd.mode": "rw",  # rw | ro | wo (ref: TSDB.java:103)
    # the TSD front end (tsd/server.py, tsd/http_api.py): one port for
    # HTTP and telnet; 0 binds an ephemeral port the server reports
    "tsd.network.port": "4242",
    "tsd.network.bind": "0.0.0.0",
    "tsd.network.backlog": "3072",
    "tsd.network.reuse_address": "true",
    "tsd.http.request.enable_chunked": "false",
    "tsd.http.request.max_chunk": "1048576",
    "tsd.http.request.cors_domains": "",
    "tsd.http.request.cors_headers": (
        "Authorization, Content-Type, Accept, Origin, User-Agent, DNT, "
        "Cache-Control, X-Mx-ReqToken, Keep-Alive, X-Requested-With, "
        "If-Modified-Since"),
    # the /q PNG cache (ref: "/tmp/opentsdb_tpu"; here under the
    # process's temporary directory, apart from the JAX package's)
    "tsd.http.cachedir": os.path.join(tempfile.gettempdir(),
                                      "opentsdb_tpu_torch"),
    # "" = the package's own tsd/static
    "tsd.http.staticroot": "",
    "tsd.http.show_stack_trace": "false",
    # /q PNG renders apply an M4 pixel budget equal to the chart width
    # (opt out per request with downsample=0px)
    "tsd.http.graph.auto_pixels": "true",
    # ms a query may take before the server answers 504; 0: no limit
    "tsd.query.timeout": "0",
    "tsd.query.allow_simultaneous_duplicates": "true",
    # per-metric scan caps (query/limits.py); 0 turns a cap off
    "tsd.query.limits.bytes.default": "0",
    "tsd.query.limits.data_points.default": "0",
    # query load shedding: a structured 503 + Retry-After past these
    # in-flight / queued counts (0: unlimited)
    "tsd.query.admission.max_inflight": "0",
    "tsd.query.admission.max_queue": "0",
    "tsd.query.admission.retry_after_s": "1",
    # where the points live (native/store_backend.py): "native" (the
    # default, as in the reference) is the C++ store of
    # csrc/tsdbstore.cc, built with g++ at first use; "memory" is the
    # numpy CSR store of core/store.py. A native store that does not
    # build raises: there is no fallback to the memory store.
    "tsd.storage.backend": "native",
    # durability (core/persist.py, core/wal.py): a non-empty data_dir
    # loads its snapshot and replays its write-ahead log at start, logs
    # every write before it is acknowledged, and snapshots on flush and
    # shutdown. The WAL's enable (true), fsync (always | interval |
    # never), fsync_interval_ms (200) and segment_mb (64) keys take
    # their defaults in TSDB, as in the reference.
    "tsd.storage.data_dir": "",
    #   the WAL's write and fsync retry ladder; when it runs out the
    #   WAL degrades (wal.degraded in the stats) instead of failing
    #   writes, and probes again every resync_interval_ms
    "tsd.storage.wal.retry.attempts": "4",
    "tsd.storage.wal.retry.base_ms": "5",
    "tsd.storage.wal.retry.deadline_ms": "2000",
    "tsd.storage.wal.resync_interval_ms": "1000",
    #   group commit: the fsync leader may hold a commit window of
    #   this many ms for concurrent writers, cut short by the caps
    #   below or by a quiet log. "" is 0 (the reference's 2 on a
    #   cluster shard needs tsd.cluster.role, which is refused)
    "tsd.storage.wal.group_window_ms": "",
    "tsd.storage.wal.group_max_records": "4096",
    "tsd.storage.wal.group_max_bytes": "4194304",
    #   the snapshot flush's retry ladder
    "tsd.storage.flush.retry.attempts": "3",
    "tsd.storage.flush.retry.base_ms": "20",
    "tsd.storage.flush.retry.deadline_ms": "10000",
    "tsd.storage.uid.width.metric": "3",
    "tsd.storage.uid.width.tagk": "3",
    "tsd.storage.uid.width.tagv": "3",
    # where the query compute runs: "cuda" (default; raises when no
    # card is present) or "cpu" (the plain-PyTorch versions of every
    # kernel — the test configuration)
    "tsd.torch.device": "cuda",
    # compute dtype of the query pipeline: float32, or float64 on
    # request (the CUDA kernels are float32-only; float64 runs the
    # dense PyTorch path)
    "tsd.torch.dtype": "float32",
    # the reference engine's defaults: fixed-interval downsamples of
    # the grid functions reduce storage-side to a [S, B] grid, and
    # grids and uploaded point batches stay on the device (LRU, MB;
    # 0 turns the cache off). grid_reduce=false with the cache at 0 is
    # the point path with nothing cached.
    "tsd.query.grid_reduce": "true",
    "tsd.query.device_cache_mb": "1024",
    # [S, B] cells above which a query leaves the grid path for the
    # point path; 0 means 1 << 26 (ref: ops/blocked.py)
    "tsd.query.max_device_cells": "0",
    # host-tail placement budgets (query/engine.py::host_tail_device):
    # a query whose padded [S, B] falls under its budget runs the
    # pipeline's tail on the host CPU, chosen before any device call,
    # by size alone. 0 = the built-in default (2^20 cells and 2^25
    # cells x groups for median/percentiles, 2^23 cells for the linear
    # aggregators), -1 = never on the host
    "tsd.query.host_tail_max_cells": "0",
    "tsd.query.host_tail_max_cellgroups": "0",
    "tsd.query.host_tail_max_cells_linear": "0",
    # host-RAM prepared-batch cache of host-placed queries (MB; 0 off):
    # a pool apart from the device cache, so host entries never evict
    # the card's grids
    "tsd.query.host_cache_mb": "512",
    # the device pipeline's circuit breaker (0 failures: no breaker):
    # a device failure is counted and raised; past the threshold the
    # breaker opens and queries answer 503 with Retry-After, touching
    # no device, until the reset window lets one probe through
    "tsd.query.breaker.failure_threshold": "5",
    "tsd.query.breaker.reset_timeout_ms": "30000",
    # the reference re-answers a failed device query on its host (true
    # there by default); the port never gives way to another path after
    # a failure, so only false is accepted: true raises when the TSDB
    # is built
    "tsd.query.degraded.host_fallback": "false",
    # the serve-path result cache (query/result_cache.py): a sharded LRU
    # of sub-query result groups, keyed on the normalized query and
    # versioned by the store, so writes invalidate. enable is read per
    # query; mb = 0 turns it off for the TSDB's life.
    "tsd.query.cache.enable": "true",
    "tsd.query.cache.mb": "256",
    "tsd.query.cache.shards": "8",
    #   relative-time (end=now) queries may be served up to one
    #   downsample interval stale, at most ttl_max_s; relative queries
    #   without a downsample are cached for ttl_relative_s (0: never)
    "tsd.query.cache.ttl_max_s": "300",
    "tsd.query.cache.ttl_relative_s": "0",
    # the sub-queries of one TSQuery run on a pool of this many threads
    # (0: one after another)
    "tsd.query.fanout.workers": "4",
    # rollup tiers (rollup/, ref: TSDB.java:170-185): config is a JSON
    # file of tiers ("" = 1m at a 1d row span and 1h at 1y); agg_tag_key
    # tags a pre-aggregate point with its group-by aggregator
    "tsd.rollups.enable": "false",
    "tsd.rollups.config": "",
    "tsd.rollups.tag_raw": "false",
    "tsd.rollups.agg_tag_key": "_aggregate",
    "tsd.rollups.raw_agg_tag_value": "RAW",
    "tsd.rollups.block_derived": "true",
    # tsd.rollups.job.device (unset, as in the reference: false) picks
    # the rollup job's route: false reduces in the store
    # (tss_bucket_reduce) and coarsens on the host, true runs the tiles
    # in PyTorch on tsd.torch.device (rollup/job.py)
    # continuous queries (streaming/): the fold workers' count (0 folds
    # inline at the drain threshold) and backlog cap per shared partial
    # (past it the backlog is dropped and the partial rebuilds at its
    # next serve), and the SSE Last-Event-ID replay depth (0: no
    # resume). As in the reference, the other keys read call-site
    # defaults and do not show in /api/config:
    #   tsd.streaming.enable (true), .serve (true), .max_queries (64),
    #   .max_windows (2880), .buffer_points (4096), .queue_events (256),
    #   .heartbeat_s (5), .publish_min_interval_ms (200),
    #   .sse.max_lifetime_s (0: unbounded),
    #   .breaker.failure_threshold (3), .breaker.reset_timeout_ms
    #   (30000); the server warmup (tsd/warmup.py) tsd.tpu.warmup
    #   (true), .buckets (""), .budget_s (600), .percentiles (true);
    #   the query mesh (parallel/): tsd.query.mesh ("": off; "auto" or
    #   "series:N[,time:M]" over TSDB(mesh_devices=...)) and the
    #   multi-process rendezvous (parallel/distributed.py):
    #   tsd.mesh.coordinator ("": one process; host:port of process 0),
    #   .num_processes (0), .process_id (-1), .init_timeout (120 s)
    "tsd.streaming.resume_events": "64",
    "tsd.streaming.workers.count": "2",
    "tsd.streaming.workers.max_pending_points": "262144",
    # self-telemetry (obs/telemetry.py): every interval the TSD ingests
    # its own counters, gauges and stage percentiles as tsd.* series
    # through the normal write path (0 = off); self_tag is the host=
    # tag of every record ("" = hostname-port)
    "tsd.stats.self_interval": "0",
    "tsd.stats.self_tag": "",
    # request tracing (obs/trace.py): keep 1 in `sample` request roots
    # (slow and failed ones always); ring/slow_ring bound the retained
    # roots, max_spans one trace; the query-shape log is
    # <data_dir>/query_shapes.jsonl, rotated past max_kb
    "tsd.trace.enable": "true",
    "tsd.trace.sample": "64",
    "tsd.trace.ring": "256",
    "tsd.trace.slow_ring": "64",
    "tsd.trace.max_spans": "512",
    "tsd.trace.shapes.enable": "true",
    "tsd.trace.shapes.max_kb": "1024",
    # a query root slower than this (ms) is kept whatever the sampling
    # and logged with its trace id into /logs (0 = off)
    "tsd.query.slowlog.threshold_ms": "0",
    # the sampling profiler behind GET /api/profile (obs/profiler.py)
    "tsd.profile.enable": "true",
    "tsd.profile.hz": "4",
    "tsd.profile.ring_s": "60",
    "tsd.profile.max_depth": "48",
    # SLO burn rates (obs/slo.py), per endpoint and window
    "tsd.slo.enable": "true",
    "tsd.slo.windows": "300,3600",
    "tsd.slo.query.latency_ms": "1000",
    "tsd.slo.query.latency_objective": "0.99",
    "tsd.slo.query.availability_objective": "0.999",
    "tsd.slo.put.latency_ms": "500",
    "tsd.slo.put.latency_objective": "0.99",
    "tsd.slo.put.availability_objective": "0.999",
}

# keys read with a default at the call site only (ref: the reference's
# _DECLARED_EXTRA; these do not show in /api/config unless set)
_DECLARED_EXTRA: frozenset[str] = frozenset({
    # the cold tier (coldstore/)
    "tsd.coldstore.breaker.failure_threshold",
    "tsd.coldstore.breaker.reset_timeout_ms",
    "tsd.coldstore.compact_segments",
    "tsd.coldstore.dir",
    "tsd.coldstore.enable",
    # the control plane (control/)
    "tsd.control.enable",
    "tsd.control.interval_s",
    "tsd.control.breaker.failure_threshold",
    "tsd.control.breaker.reset_timeout_ms",
    "tsd.control.materialize.enable",
    "tsd.control.materialize.max",
    "tsd.control.materialize.min_score",
    "tsd.control.materialize.hysteresis",
    "tsd.control.materialize.mem_penalty_mb",
    "tsd.control.tenant.tag",
    "tsd.control.tenant.header",
    "tsd.control.qos.enable",
    "tsd.control.qos.weights",
    "tsd.control.qos.max_tenants",
    "tsd.control.qos.burn_penalty",
    "tsd.control.qos.tenant_cache_mb",
    "tsd.control.qos.tenant_fold_mb",
    "tsd.control.placement.enable",
    "tsd.control.placement.auto",
    "tsd.control.placement.hot_ratio",
    # authentication, meta and trees, the server
    "tsd.core.authentication.enable",
    "tsd.core.authentication.roles",
    "tsd.core.authentication.users",
    "tsd.core.histograms.config",
    "tsd.core.connections.limit",
    "tsd.core.socket.timeout",
    "tsd.core.meta.enable_realtime_ts",
    "tsd.core.meta.enable_realtime_uid",
    "tsd.core.meta.enable_tsuid_tracking",
    "tsd.core.tree.enable_processing",
    "tsd.core.uid.random_metrics",
    "tsd.http.query.allow_delete",
    "tsd.http.query.stream_threshold_dps",
    # the reference's legacy alias of tsd.http.request.enable_chunked
    # (either spelling enables chunked bodies)
    "tsd.http.request_enable_chunked",
    "tsd.http.serializer.plugin",
    "tsd.uidfilter.metric_patterns",
    "tsd.uidfilter.tagk_patterns",
    "tsd.uidfilter.tagv_patterns",
    # the data lifecycle (lifecycle/)
    "tsd.lifecycle.breaker.failure_threshold",
    "tsd.lifecycle.breaker.reset_timeout_ms",
    "tsd.lifecycle.demote_after",
    "tsd.lifecycle.demote_tiers",
    "tsd.lifecycle.enable",
    "tsd.lifecycle.flush_after_sweep",
    "tsd.lifecycle.interval_s",
    "tsd.lifecycle.retention",
    "tsd.lifecycle.spill_after",
    # the reference's segment compaction and timestamp packing; the
    # port's stores have nothing to compact or pack (ROADMAP recorded
    # divergence 22), so these are declared and have no effect
    "tsd.lifecycle.compact",
    "tsd.lifecycle.pack_timestamps",
    # the query mesh and its rendezvous (parallel/)
    "tsd.mesh.coordinator",
    "tsd.mesh.init_timeout",
    "tsd.mesh.num_processes",
    "tsd.mesh.process_id",
    "tsd.query.mesh",
    # the query engine
    "tsd.query.limits.overrides.config",
    "tsd.query.limits.overrides.interval",
    "tsd.query.workers",
    "tsd.rollups.job.device",
    # the sketch tier (sketch/)
    "tsd.sketch.enable",
    "tsd.sketch.alpha",
    "tsd.sketch.max_buckets",
    # the WAL and the snapshot flush
    "tsd.storage.flush.retry.max_ms",
    "tsd.storage.wal.retry.max_ms",
    "tsd.storage.wal.enable",
    "tsd.storage.wal.fsync",
    "tsd.storage.wal.fsync_interval_ms",
    "tsd.storage.wal.segment_mb",
    # continuous queries (streaming/)
    "tsd.streaming.breaker.failure_threshold",
    "tsd.streaming.breaker.reset_timeout_ms",
    "tsd.streaming.buffer_points",
    "tsd.streaming.enable",
    "tsd.streaming.heartbeat_s",
    "tsd.streaming.max_queries",
    "tsd.streaming.max_windows",
    "tsd.streaming.publish_min_interval_ms",
    "tsd.streaming.queue_events",
    "tsd.streaming.serve",
    "tsd.streaming.sse.max_lifetime_s",
    # the warmup (tsd/warmup.py)
    "tsd.tpu.warmup",
    "tsd.tpu.warmup.buckets",
    "tsd.tpu.warmup.budget_s",
    "tsd.tpu.warmup.percentiles",
    # the cluster tier (cluster/); the gossip keys take the
    # reference's defaults at their call sites in cluster/gossip.py
    # (interval_ms 250, stale_ms 5000, log_max 4096, timeout_ms 2000)
    "tsd.cluster.role",
    "tsd.cluster.peers",
    "tsd.cluster.vnodes",
    "tsd.cluster.rf",
    "tsd.cluster.routers",
    "tsd.cluster.gossip.interval_ms",
    "tsd.cluster.gossip.stale_ms",
    "tsd.cluster.gossip.log_max",
    "tsd.cluster.gossip.timeout_ms",
    "tsd.cluster.replica.repair",
    "tsd.cluster.reshard.backfill_batch",
    "tsd.cluster.reshard.interval_ms",
    "tsd.cluster.retire.enable",
    "tsd.cluster.retire.interval_ms",
    "tsd.cluster.timeout_ms",
    "tsd.cluster.hedge_after_ms",
    "tsd.cluster.wire.enable",
    "tsd.cluster.wire.max_inflight",
    "tsd.cluster.wire.fallback_ttl_ms",
    "tsd.cluster.wire.connect_timeout_ms",
    "tsd.cluster.sub_retry.max_concurrent",
    "tsd.cluster.sub_memo.ttl_ms",
    "tsd.cluster.sub_memo.max_entries",
    "tsd.cluster.metric_versions.max_entries",
    "tsd.cluster.retry.attempts",
    "tsd.cluster.retry.base_ms",
    "tsd.cluster.retry.max_ms",
    "tsd.cluster.retry.deadline_ms",
    "tsd.cluster.breaker.failure_threshold",
    "tsd.cluster.breaker.reset_timeout_ms",
    "tsd.cluster.spool.dir",
    "tsd.cluster.spool.max_mb",
    "tsd.cluster.spool.compact_mb",
    "tsd.cluster.spool.replay_interval_ms",
    "tsd.cluster.spool.replay_batch",
    "tsd.cluster.fanout_workers",
    "tsd.cluster.fleet_health_ttl_ms",
    "tsd.cluster.read_repair.enable",
    "tsd.cluster.read_repair.max_pending",
})

# key families with tails from the config itself: fault arming
# (tsd.faults.<site>_<knob>, whose site utils/faults.py checks) and the
# per-metric lifecycle policies
DYNAMIC_KEY_PREFIXES: tuple[str, ...] = ("tsd.faults.",
                                         "tsd.lifecycle.policy.")


def is_declared_key(key: str) -> bool:
    """Whether the port reads ``key``: a default, a call-site default,
    a dynamic family or a plugin slot's enable and plugin keys."""
    if key in _DEFAULTS or key in _DECLARED_EXTRA:
        return True
    if any(key.startswith(p) for p in DYNAMIC_KEY_PREFIXES):
        return True
    return any(key in (f"{slot}.enable", f"{slot}.plugin")
               for slot in PLUGIN_SLOTS)


# where a config is looked for when none is named (ref: Config.java's
# search path, ``opentsdb_tpu/utils/config.py``)
_SEARCH_PATHS = (
    "./opentsdb.conf",
    "/etc/opentsdb.conf",
    "/etc/opentsdb/opentsdb.conf",
    "/opt/opentsdb/opentsdb.conf",
)


class Config:
    """(ref: src/utils/Config.java:52) The defaults, then a properties
    file (``config_file``, or with ``auto_load`` the first file of the
    search path that exists), then the keyword overrides."""

    def __init__(self, config_file: str | None = None,
                 auto_load: bool = False, **overrides: Any):
        self._props: dict[str, str] = dict(_DEFAULTS)
        # the file loaded, if any (ref: Config.getConfigLocation)
        self.config_location: str | None = None
        if config_file:
            self.load_file(config_file)
        elif auto_load:
            for path in _SEARCH_PATHS:
                if os.path.isfile(path):
                    self.load_file(path)
                    break
        for key, val in overrides.items():
            self._props[key.replace("__", ".")] = str(val)

    def load_file(self, path: str) -> None:
        """Read a java-properties-style file: ``key = value`` (or
        ``key: value``) lines; blank lines and ``#``/``!`` comments
        skipped (ref: ``Config.load_file``)."""
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith(("#", "!")):
                    continue
                for sep in ("=", ":"):
                    idx = line.find(sep)
                    if idx > 0:
                        self._props[line[:idx].strip()] = \
                            line[idx + 1:].strip()
                        break
        self.config_location = path

    def get_string(self, key: str, default: str | None = None) -> str:
        if key in self._props:
            return self._props[key]
        if default is not None:
            return default
        raise KeyError(key)

    def get_int(self, key: str, default: int | None = None) -> int:
        try:
            return int(self._props[key])
        except KeyError:
            if default is not None:
                return default
            raise

    def get_float(self, key: str, default: float | None = None) -> float:
        try:
            return float(self._props[key])
        except KeyError:
            if default is not None:
                return default
            raise

    def get_bool(self, key: str, default: bool = False) -> bool:
        val = self._props.get(key)
        if val is None:
            return default
        return val.strip().lower() in ("true", "1", "yes")

    def __iter__(self):
        """(key, value) pairs of every property."""
        return iter(list(self._props.items()))

    def unknown_keys(self) -> list[str]:
        """Configured ``tsd.*`` keys nothing in the port reads (ref:
        ``Config.unknown_keys``). Keys under an enabled plugin slot's
        prefix are exempt: the plugin owns that namespace."""
        owned = [f"{slot}." for slot in PLUGIN_SLOTS
                 if self.get_bool(f"{slot}.enable", False)]
        return sorted(
            k for k in self._props
            if k.startswith("tsd.") and not is_declared_key(k)
            and not any(k.startswith(p) for p in owned))

    def warn_unknown_keys(self, logger: logging.Logger | None = None
                          ) -> list[str]:
        """Log one warning per unknown ``tsd.*`` key instead of ignoring
        it silently (ref: ``Config.warn_unknown_keys``); returns them."""
        logger = logger or log
        unknown = self.unknown_keys()
        for key in unknown:
            logger.warning(
                "unknown config key %r is not read by anything and "
                "will be IGNORED — check for a typo (see "
                "utils/config.py declared-key registry)", key)
        return unknown

    def override_config(self, key: str, value: Any) -> None:
        """Set one key at run time (ref: Config.java:317). The query
        engine reads its keys per query, and the TSDB its device cache
        size when the cache is first needed."""
        self._props[key] = str(value)

    def dump_configuration(self) -> dict[str, str]:
        """All properties for ``/api/config``, secrets redacted as the
        reference redacts passwords."""
        return {k: "********" if "pass" in k.lower() else v
                for k, v in sorted(self._props.items())}
