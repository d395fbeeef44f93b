"""The plugin extension points of the TSD (ref: ``RTPublisher.java:39``,
``StorageExceptionHandler.java:31``, ``RpcPlugin.java:36``,
``HttpRpcPlugin.java:40``, ``WriteableDataPointFilterPlugin``,
``UniqueIdFilterPlugin``, ``MetaDataCache.java:29``, ``StartupPlugin``,
``SearchPlugin.java:51``; the JAX package's ``plugins.py``).

All load through :mod:`opentsdb_tpu_torch.utils.plugin` and share the
lifecycle: construction with no arguments, ``initialize(tsdb)``,
``shutdown()``, ``version()``, ``collect_stats(collector)``. The
histogram codec ABI is :class:`~opentsdb_tpu_torch.core.histogram.
HistogramCodec`, the authentication ABI
:class:`~opentsdb_tpu_torch.auth.simple.SimpleAuthentication`, and an
HTTP serializer subclasses :class:`~opentsdb_tpu_torch.tsd.
json_serializer.HttpJsonSerializer`.
"""

from __future__ import annotations

import re
from typing import Any


class Plugin:
    """The lifecycle every plugin ABI shares."""

    def initialize(self, tsdb) -> None:  # noqa: B027
        """Called once after construction; raise to abort startup."""

    def shutdown(self) -> None:  # noqa: B027
        """Called when the TSD stops."""

    def version(self) -> str:
        return "2.4.0"

    def collect_stats(self, collector) -> None:  # noqa: B027
        """Report the plugin's metrics into /api/stats."""


class RTPublisher(Plugin):
    """Realtime fan-out of every stored point (ref: RTPublisher.java:39).
    It runs after the write is durable: a failure is counted, never
    raised into the write (``TSDB._run_hook``)."""

    def publish_data_point(self, metric: str, timestamp: int,
                           value, tags: dict[str, str],
                           tsuid: str) -> None:
        raise NotImplementedError

    def publish_aggregate_point(self, metric: str, timestamp: int,
                                value, tags: dict[str, str],
                                tsuid: str) -> None:  # noqa: B027
        """A rollup or pre-aggregated point
        (ref: RTPublisher.publishAggregatePoint)."""

    def publish_histogram_point(self, metric: str, timestamp: int,
                                raw_data: bytes,
                                tags: dict[str, str],
                                tsuid: str) -> None:  # noqa: B027
        """An encoded histogram point
        (ref: RTPublisher.publishHistogramPoint)."""

    def publish_annotation(self, annotation) -> None:  # noqa: B027
        pass


class StorageExceptionHandler(Plugin):
    """Takes the points a storage error dropped
    (ref: StorageExceptionHandler.java:31 handleError)."""

    def handle_error(self, datapoint: dict, error: Exception) -> None:
        raise NotImplementedError


class WriteableDataPointFilterPlugin(Plugin):
    """Lets a point through to storage or not (ref: TSDB.java:1262,
    allowDataPoint)."""

    def filter_data_points(self) -> bool:
        """Whether this filter wants the per-point call."""
        return True

    def allow_data_point(self, metric: str, timestamp: int, value,
                         tags: dict[str, str]) -> bool:
        raise NotImplementedError


class UniqueIdFilterPlugin(Plugin):
    """Asked before a new metric, tag name or tag value gets a UID
    (ref: src/uid/UniqueIdFilterPlugin.java)."""

    def fill_uid_cache(self) -> bool:
        return True

    def allow_uid_assignment(self, kind: str, value: str, metric: str,
                             tags: dict[str, str] | None) -> bool:
        raise NotImplementedError


class UniqueIdWhitelistFilter(UniqueIdFilterPlugin):
    """Regex whitelist (ref: src/uid/UniqueIdWhitelistFilter.java:37):
    comma-separated patterns per UID kind from
    ``tsd.uidfilter.{metric,tagk,tagv}_patterns``; a new name must match
    one pattern of its kind, and a kind without patterns takes all."""

    def initialize(self, tsdb) -> None:
        cfg = tsdb.config if hasattr(tsdb, "config") else tsdb
        self._patterns = {}
        for kind, key in (("metric", "tsd.uidfilter.metric_patterns"),
                          ("tagk", "tsd.uidfilter.tagk_patterns"),
                          ("tagv", "tsd.uidfilter.tagv_patterns")):
            raw = cfg.get_string(key, "")
            self._patterns[kind] = [re.compile(p.strip())
                                    for p in raw.split(",") if p.strip()]

    def allow_uid_assignment(self, kind: str, value: str, metric: str,
                             tags: dict[str, str] | None) -> bool:
        pats = self._patterns.get(kind) or []
        if not pats:
            return True
        return any(p.search(value) for p in pats)


class MetaDataCache(Plugin):
    """An external TSMeta counter service (ref: MetaDataCache.java:29):
    called on every write in place of the built-in meta tracking."""

    def increment_and_get_counter(self, tsuid: str) -> None:
        raise NotImplementedError


class StartupPlugin(Plugin):
    """Hooks around the daemon's start (ref: StartupPlugin,
    TSDMain.java:251): ``initialize(config)`` before the TSDB exists,
    ``set_ready(tsdb)`` once the socket is bound."""

    def initialize(self, config) -> None:  # noqa: B027
        pass

    def set_ready(self, tsdb) -> None:  # noqa: B027
        pass


class RpcPlugin(Plugin):
    """A protocol server sharing the TSD process (ref:
    RpcPlugin.java:36), started after the TSDB and stopped at
    shutdown."""


class HttpRpcPlugin(Plugin):
    """An HTTP endpoint under ``/plugin/<path>``
    (ref: HttpRpcPlugin.java:40, ``tsd.http.rpc``)."""

    def path(self) -> str:
        """The route under /plugin/ this handler owns."""
        raise NotImplementedError

    def execute(self, tsdb, request) -> Any:
        """Return an HttpResponse for the request."""
        raise NotImplementedError


class SearchPlugin(Plugin):
    """An external index (ref: SearchPlugin.java:51): takes TSMeta,
    UIDMeta and annotation upserts and deletes, answers /api/search
    queries of its own types, and may rewrite queries."""

    def index_ts_meta(self, meta) -> None:  # noqa: B027
        pass

    def delete_ts_meta(self, tsuid: str) -> None:  # noqa: B027
        pass

    def index_uid_meta(self, meta) -> None:  # noqa: B027
        pass

    def delete_uid_meta(self, meta) -> None:  # noqa: B027
        pass

    def index_annotation(self, note) -> None:  # noqa: B027
        pass

    def delete_annotation(self, note) -> None:  # noqa: B027
        pass

    def execute_query(self, query_type: str, query: dict) -> dict:
        raise NotImplementedError

    def resolve_ts_query(self, ts_query):
        """Optionally rewrite a TSQuery (ref: resolveTSQuery :152)."""
        return ts_query


class HttpSerializerPlugin:
    """Another wire format (ref: HttpSerializer.java:93): subclass
    :class:`opentsdb_tpu_torch.tsd.json_serializer.HttpJsonSerializer`,
    override the parse_*/format_* pairs and give it a ``shortname``;
    ``tsd.http.serializer.plugin`` names the class, which the router
    registers under its shortname and makes the default."""
