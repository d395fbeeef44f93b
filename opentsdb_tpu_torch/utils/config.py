"""Flat ``tsd.*`` configuration (ref: ``src/utils/Config.java``).

A flat string->string property map with typed getters and defaults,
holding only the keys the PyTorch port reads. Keys keep the
reference's ``tsd.`` namespace; port-specific keys live under
``tsd.torch.*``.
"""

from __future__ import annotations

from typing import Any

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
    "tsd.http.show_stack_trace": "false",
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
}


class Config:
    """(ref: src/utils/Config.java:52)"""

    def __init__(self, **overrides: Any):
        self._props: dict[str, str] = dict(_DEFAULTS)
        for key, val in overrides.items():
            self._props[key.replace("__", ".")] = str(val)

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
