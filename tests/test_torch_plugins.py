"""The port's plugin slots (``opentsdb_tpu_torch/plugins.py``,
``utils/plugin.py``, ``TSDB.initialize_plugins`` and the write hooks)
against the JAX package's, on the CPU.

- The 12 cases of ``tests/test_plugins.py``, each run on both packages
  with a plugin class of each package's ABI, named by dotted path in
  this module, and each also asserting what that file asserts.
- ``tsd.http.serializer.plugin``: a serializer subclassing each
  package's own ``HttpJsonSerializer`` is registered under its
  shortname and made the default: ``/api/version`` and ``/api/query``
  answer in its format through both routers, and ``?serializer=json``
  still picks JSON. (The port ignored the key before: ROADMAP Queue 3.)
- The hooks of every write path both packages share (``add_point``,
  ``add_points``, a put body, a telnet burst through ``import_buffer``)
  with a write filter, a UID filter, the realtime publisher and the meta
  cache on: the same points land and the same events reach the plugins;
  the port's ``add_series_points`` against the reference's per-point
  writes of the same points; a failing hook never fails a write and is
  counted in ``/api/stats`` under the reference's name.
- The command line's ``tsd.startup`` (``initialize(config)``, then
  ``set_ready(tsdb)`` once the socket is bound) and ``tsd.rpc`` plugins,
  in a subprocess of each package.

Tolerance: none; events, statuses and JSON compare exactly.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_wal import series_of
from torch_meta_pair import (JAX, PORT, T0, answer, both, call, request,
                             router, tsdb)

import opentsdb_tpu.plugins as jp
import opentsdb_tpu.tsd.json_serializer as jser
import opentsdb_tpu_torch.plugins as tp
import opentsdb_tpu_torch.tsd.json_serializer as tser

ROOT = Path(__file__).resolve().parent.parent


def _name(side) -> str:
    return "Port" if side is PORT else "Jax"


def _slot(prefix: str, cls: str, side) -> dict:
    return {f"{prefix}.enable": "true",
            f"{prefix}.plugin": f"test_torch_plugins.{_name(side)}{cls}"}


# -- plugin classes of each package's ABI, by dotted path --------------------

class _Publisher:
    events: dict = {"port": [], "jax": []}
    side = ""

    def publish_data_point(self, metric, timestamp, value, tags, tsuid):
        self.events[self.side].append(
            ("point", metric, timestamp, value, type(value).__name__,
             dict(tags), bytes(tsuid).hex()))

    def publish_aggregate_point(self, metric, timestamp, value, tags,
                                tsuid):
        self.events[self.side].append(
            ("aggregate", metric, timestamp, value, dict(tags)))

    def publish_histogram_point(self, metric, timestamp, raw, tags, tsuid):
        self.events[self.side].append(
            ("histogram", metric, timestamp, len(raw), dict(tags)))


class PortPublisher(_Publisher, tp.RTPublisher):
    side = "port"


class JaxPublisher(_Publisher, jp.RTPublisher):
    side = "jax"


class _Filter:
    def allow_data_point(self, metric, timestamp, value, tags):
        if metric == "raise.me":
            raise RuntimeError("filter broke")
        return not metric.startswith("blocked.") and value != 13


class PortFilter(_Filter, tp.WriteableDataPointFilterPlugin):
    pass


class JaxFilter(_Filter, jp.WriteableDataPointFilterPlugin):
    pass


class _SEH:
    errors: dict = {"port": [], "jax": []}
    side = ""

    def handle_error(self, datapoint, error):
        self.errors[self.side].append((datapoint, str(error)))


class PortSEH(_SEH, tp.StorageExceptionHandler):
    side = "port"


class JaxSEH(_SEH, jp.StorageExceptionHandler):
    side = "jax"


class _HttpRpc:
    def path(self):
        return "dummy/sub"

    def execute(self, tsdb, request):
        http = PORT.http if isinstance(self, tp.Plugin) else JAX.http
        return http.HttpResponse(200, json.dumps(
            {"hello": "plugin", "method": request.method}).encode())


class PortHttpRpc(_HttpRpc, tp.HttpRpcPlugin):
    pass


class JaxHttpRpc(_HttpRpc, jp.HttpRpcPlugin):
    pass


class _Serializer:
    shortname = "dummy"
    response_content_type = "application/x-dummy"

    def format_version(self, info):
        info = dict(info)
        info["serializer"] = "dummy"
        return json.dumps(info).encode()

    def format_query(self, ts_query, results, **kw):
        return json.dumps({"dummy": [
            {"metric": r.metric, "tags": r.tags, "n": r.num_dps}
            for r in results]}).encode()


class PortSerializer(_Serializer, tser.HttpJsonSerializer):
    pass


class JaxSerializer(_Serializer, jser.HttpJsonSerializer):
    pass


class _MetaCache:
    counters: dict = {"port": {}, "jax": {}}
    side = ""

    def increment_and_get_counter(self, tsuid):
        c = self.counters[self.side]
        c[bytes(tsuid).hex()] = c.get(bytes(tsuid).hex(), 0) + 1


class PortMetaCache(_MetaCache, tp.MetaDataCache):
    side = "port"


class JaxMetaCache(_MetaCache, jp.MetaDataCache):
    side = "jax"


class _Broken:
    def publish_data_point(self, *args):
        raise RuntimeError("publisher down")


class PortBroken(_Broken, tp.RTPublisher):
    pass


class JaxBroken(_Broken, jp.RTPublisher):
    pass


class _Marker:
    """Startup and RPC plugins for the command line: each step appends
    a line to ``$TSD_PLUGIN_MARKS``; ready stops the daemon."""

    def _mark(self, what):
        with open(os.environ["TSD_PLUGIN_MARKS"], "a") as fh:
            side = "Port" if isinstance(self, tp.Plugin) else "Jax"
            fh.write(f"{side}:{what}\n")


class _Startup(_Marker):
    def initialize(self, config):
        self._mark(f"init:{type(config).__name__}")

    def set_ready(self, tsdb):
        self._mark(f"ready:{tsdb.datapoints_added}")
        os.kill(os.getpid(), signal.SIGTERM)

    def shutdown(self):
        self._mark("startup-shutdown")


class PortStartup(_Startup, tp.StartupPlugin):
    pass


class JaxStartup(_Startup, jp.StartupPlugin):
    pass


class _Rpc(_Marker):
    def initialize(self, tsdb):
        self._mark(f"rpc-init:{type(tsdb).__name__}")

    def shutdown(self):
        self._mark("rpc-shutdown")


class PortRpc(_Rpc, tp.RpcPlugin):
    pass


class JaxRpc(_Rpc, jp.RpcPlugin):
    pass


@pytest.fixture(autouse=True)
def _clear_records():
    for store in (_Publisher.events, _SEH.errors, _MetaCache.counters):
        for v in store.values():
            v.clear()


# -- the cases of tests/test_plugins.py ---------------------------------------

def test_rtpublisher_receives_points():
    def scenario(side):
        t = tsdb(side, **_slot("tsd.rtpublisher", "Publisher", side))
        t.add_point("sys.cpu.user", T0, 42, {"host": "web01"})
        return _Publisher.events[side.name]

    got, want = both(scenario)
    assert got == want
    assert got[0][1:4] == ("sys.cpu.user", T0, 42) and got[0][-1]


def test_write_filter_blocks_points():
    def scenario(side):
        t = tsdb(side, **_slot("tsd.core.write_filter", "Filter", side))
        out = [t.add_point("sys.ok", T0, 1, {"host": "a"}),
               t.add_point("blocked.metric", T0, 1, {"host": "a"})]
        return out, t.datapoints_added, t.uids.metrics.items()

    got, want = both(scenario)
    assert got == want
    assert got[0][0] >= 0 and got[0][1] == -1 and got[1] == 1


def test_uid_whitelist_filter_vetoes_assignment():
    def scenario(side):
        t = tsdb(side, **{
            "tsd.uid.filter.enable": "true",
            "tsd.uid.filter.plugin":
                f"{side.plugins.__name__}.UniqueIdWhitelistFilter",
            "tsd.uidfilter.metric_patterns": r"^sys\..*,^net\..*"})
        t.add_point("sys.cpu.user", T0, 1, {"host": "a"})
        with pytest.raises(Exception) as e:
            t.add_point("evil.metric", T0, 1, {"host": "a"})
        t.add_point("sys.cpu.user", T0 + 1, 2, {"host": "a"})
        return type(e.value).__name__, str(e.value), t.uids.metrics.items()

    got, want = both(scenario)
    assert got == want
    assert got[0] == "FailedToAssignUniqueIdError"


def test_storage_exception_handler_called(monkeypatch):
    def scenario(side):
        t = tsdb(side, **_slot("tsd.core.storage_exception_handler", "SEH",
                               side))

        def boom(*a, **kw):
            raise RuntimeError("storage down")

        monkeypatch.setattr(t.store, "append_many", boom)
        monkeypatch.setattr(t.store, "append", boom)
        body = [{"metric": "m", "timestamp": T0, "value": 1,
                 "tags": {"h": "a"}},
                {"metric": "m", "timestamp": "x", "value": 1,
                 "tags": {"h": "a"}}]
        return (call(side, t, "POST", "/api/put", {"details": ""}, body),
                _SEH.errors[side.name])

    got, want = both(scenario)
    assert got == want
    assert got[0][0] == 400 and len(got[1]) == 1
    assert "storage down" in got[1][0][1]


def test_http_rpc_plugin_route():
    def scenario(side):
        t = tsdb(side, **_slot("tsd.http.rpc", "HttpRpc", side))
        return [call(side, t, m, p) for m, p in (
            ("GET", "/plugin/dummy/sub"), ("POST", "/plugin/dummy/sub"),
            ("GET", "/plugin/nope"), ("GET", "/plugin"))]

    got, want = both(scenario)
    assert got == want
    assert [a[0] for a in got] == [200, 200, 404, 404]
    assert got[0][1] == {"hello": "plugin", "method": "GET"}


def test_serializer_plugin_slot():
    def scenario(side):
        t = tsdb(side, **{"tsd.http.serializer.plugin":
                          f"test_torch_plugins.{_name(side)}Serializer"})
        return json.loads(router(side, t).handle(
            request(side, "GET", "/api/version")).body)["serializer"]

    got, want = both(scenario)
    assert got == want == "dummy"


def test_serializer_negotiation():
    def scenario(side):
        t = tsdb(side, **{"tsd.http.serializer.plugin":
                          f"test_torch_plugins.{_name(side)}Serializer"})
        out = []
        for name in ("json", "dummy", "nope"):
            resp = router(side, t).handle(request(
                side, "GET", "/api/version", {"serializer": name}))
            body = json.loads(resp.body)
            out.append((resp.status, "serializer" in body,
                        body.get("error", {}).get("message")))
        listed = json.loads(router(side, t).handle(
            request(side, "GET", "/api/serializers")).body)
        out.append([{**d, "class": d["class"].replace(_name(side), "")}
                    for d in listed])
        return out

    got, want = both(scenario)
    assert got == want
    assert got[:3] == [(200, False, None), (200, True, None),
                       (400, False, "Unable to find serializer with "
                        "name 'nope'")]


def test_meta_cache_replaces_builtin_tracking():
    def scenario(side):
        t = tsdb(side, **_slot("tsd.core.meta.cache", "MetaCache", side),
                 **{"tsd.core.meta.enable_realtime_ts": "true"})
        t.add_point("sys.cpu.user", T0, 1, {"host": "a"})
        t.add_point("sys.cpu.user", T0 + 10, 2, {"host": "a"})
        return _MetaCache.counters[side.name], len(t.meta.ts_meta)

    got, want = both(scenario)
    assert got == want
    assert list(got[0].values()) == [2] and got[1] == 0


def test_uid_whitelist_empty_patterns_allow_all():
    def scenario(side):
        filt = side.plugins.UniqueIdWhitelistFilter()
        filt.initialize(side.Config())
        return filt.allow_uid_assignment("metric", "anything", "m", {})

    got, want = both(scenario)
    assert got is want is True


def _basic(user: str, pw: str) -> dict:
    import base64
    return {"authorization": "Basic " + base64.b64encode(
        f"{user}:{pw}".encode()).decode()}


class TestHttpAuth:
    """(ref: AuthenticationChannelHandler + Permissions.java:25)"""

    def test_authenticate_http_basic(self):
        import hashlib
        digest = hashlib.sha256(b"secret").hexdigest()

        def scenario(side):
            auth = side.auth.SimpleAuthentication(side.Config(**{
                "tsd.core.authentication.users": f"alice:{digest}"}))
            return [(s.status.name, s.user) for s in (
                auth.authenticate_http(_basic("alice", "secret")),
                auth.authenticate_http(_basic("alice", "wrong")),
                auth.authenticate_http({}))]

        got, want = both(scenario)
        assert got == want
        assert got == [("SUCCESS", "alice"), ("UNAUTHORIZED", "alice"),
                       ("UNAUTHORIZED", "")]

    def test_allow_all_without_users(self):
        def scenario(side):
            auth = side.auth.SimpleAuthentication(side.Config())
            return auth.authenticate_http({}).status.name

        got, want = both(scenario)
        assert got == want == "SUCCESS"

    def test_permission_denied_returns_403(self):
        def scenario(side):
            class NoQueryState(side.auth.AuthState):
                def has_permission(self, perm):
                    return perm is not side.auth.Permissions.HTTP_QUERY

            t = tsdb(side)
            return call(side, t, "GET", "/api/query",
                        {"start": "1h-ago", "m": "sum:x"},
                        auth=NoQueryState("bob",
                                          side.auth.AuthStatus.SUCCESS))

        got, want = both(scenario)
        assert got == want and got[0] == 403


# -- the serializer plugin: the fault the port had ----------------------------

def test_serializer_plugin_is_loaded_and_made_the_default():
    """``tsd.http.serializer.plugin`` names a serializer subclassing each
    package's own ``HttpJsonSerializer``; both routers answer
    ``/api/version`` and ``/api/query`` in its format, and
    ``?serializer=json`` still picks JSON."""
    def scenario(side):
        t = tsdb(side, **{"tsd.http.serializer.plugin":
                          f"test_torch_plugins.{_name(side)}Serializer"})
        t.add_points("m", T0 + 60 * np.arange(5), np.arange(5.0),
                     {"host": "a"})
        q = {"start": str(T0), "end": str(T0 + 600),
             "m": "sum:1m-avg:m{host=*}"}
        out = [answer(router(side, t).handle(request(side, "GET", path, p)))
               for path, p in (("/api/version", {}), ("/api/query", q),
                               ("/api/query", {**q, "serializer": "json"}))]
        version = json.loads(router(side, t).handle(request(
            side, "GET", "/api/version")).body)
        return [a[:3] for a in out[1:]], version["serializer"], \
            out[0][2], "serializer" in out[0][1] if isinstance(
                out[0][1], dict) else None

    got, want = both(scenario)
    assert got == want
    (plugin_q, json_q), marker, ctype, _ = got
    assert plugin_q[1] == b'{"dummy": [{"metric": "m", "tags": {"host": ' \
        b'"a"}, "n": 5}]}' and plugin_q[2] == "application/x-dummy"
    assert json_q[0] == 200 and json_q[1][0]["dps"]["1356998400"] == 0
    assert marker == "dummy" and ctype == "application/x-dummy"


# -- the hooks of every write path --------------------------------------------

HOOKED = ("Publisher", "Filter", "MetaCache")


def _hooked(side, **extra):
    keys = {**_slot("tsd.rtpublisher", "Publisher", side),
            **_slot("tsd.core.write_filter", "Filter", side),
            **_slot("tsd.core.meta.cache", "MetaCache", side),
            "tsd.uid.filter.enable": "true",
            "tsd.uid.filter.plugin":
                f"{side.plugins.__name__}.UniqueIdWhitelistFilter",
            "tsd.uidfilter.tagv_patterns": "^h", **extra}
    return tsdb(side, **keys)


def _points(t) -> dict:
    """Every series' points by names: timestamps, value bits and integer
    flags as lists."""
    return {k: tuple(np.asarray(a).tolist() for a in v)
            for k, v in series_of(t).items()}


def _write_everything(side):
    t = _hooked(side)
    telnet = side.telnet.TelnetRouter(t, None) if side is JAX \
        else side.telnet.TelnetRouter(t)
    out = [t.add_point("m.a", T0, 1, {"host": "h1"}),
           t.add_point("m.a", T0 + 1, 13, {"host": "h1"}),       # filtered
           t.add_point("blocked.x", T0, 1, {"host": "h1"})]
    out.append(t.add_points("m.b", T0 + np.arange(4), np.array([1, 13, 3, 4]),
                            {"host": "h2"}))
    for body in ([{"metric": "m.c", "timestamp": T0 + k, "value": v,
                   "tags": {"host": "h3"}} for k, v in
                  enumerate([1.5, 13, 2])]
                 + [{"metric": "m.c", "timestamp": T0, "value": 1,
                     "tags": {"host": "xx"}},
                    {"metric": "raise.me", "timestamp": T0, "value": 1,
                     "tags": {"host": "h3"}}],):
        out.append(call(side, t, "POST", "/api/put", {"details": ""}, body))
    lines = [f"put m.d {T0 + k} {v} host=h{4 + k % 2}"
             for k, v in enumerate([1, 2, 13, 4, 5.5])]
    lines += [f"put m.d {T0} 1 host=zz", f"put raise.me {T0} 1 host=h4",
              f"put blocked.y {T0} 2 host=h4", f"put m.d x 1 host=h4"]
    out.append(telnet.execute_lines(lines)[0])
    out.append(telnet.execute_lines([f"put m.e {T0} 7 host=h9"])[0])
    return (out, _points(t), _by_series(t, _Publisher.events[side.name]),
            {_names(t, k): n for k, n in
             _MetaCache.counters[side.name].items()},
            t.datapoints_added,
            sorted(n for n, _ in t.uids.tag_values.items()),
            t.hook_errors)


def _names(t, tsuid: str) -> tuple:
    """A TSUID of ``t`` by its metric and tag names."""
    for mid, tags in t.store.series_identities() if hasattr(
            t.store, "series_identities") else (
            (t.store.series(s).metric_id, t.store.series(s).tags)
            for s in range(t.store.num_series())):
        if t.uids.tsuid(mid, tags).hex() == tsuid:
            return (t.uids.metrics.get_name(mid), tuple(
                (t.uids.tag_names.get_name(k), t.uids.tag_values.get_name(v))
                for k, v in tags))
    raise KeyError(tsuid)


def _by_series(t, events: list) -> list:
    """The publisher's events with each TSUID by its names, series by
    series in their order (a burst files its new names in line order in
    the port, in the parser's group order in the reference: ROADMAP
    Queue 3 item 3)."""
    named = [(_names(t, e[-1]), e[:-1]) for e in events]
    return sorted(named, key=lambda x: x[0])


def test_write_paths_with_hooks_equal_reference():
    got, want = both(_write_everything)
    assert got == want
    points = got[1]
    assert ("m.a", (("host", "h1"),)) in points
    assert not any(k[0].startswith(("blocked", "raise")) for k in points)
    assert all(13.0 not in v[1] for v in points.values())
    assert len(got[2]) == sum(len(v[0]) for v in points.values())


def test_import_buffer_without_hooks_takes_the_bulk_path(monkeypatch):
    """No hook on: the port's bulk path runs, and neither the per-line
    replay nor a per-point hook is called."""
    t = tsdb(PORT)

    def never(*a, **kw):
        raise AssertionError("a hook path ran")

    monkeypatch.setattr(t, "_import_hooked", never)
    monkeypatch.setattr(t, "add_point", never)
    monkeypatch.setattr(t, "_point_hook", never)
    written, errors = t.import_buffer(
        b"m 1356998400 1 host=a\nm 1356998401 2 host=b\n")
    assert (written, errors) == (2, [])


def test_add_series_points_hooks_equal_per_point_writes():
    """The port's columnar write against the reference's ``add_points``
    of each row: the same points land, the same events, counters and
    filter verdicts."""
    tags = [{"host": f"h{i}"} for i in range(4)] + [{"host": "zz"}]
    ts2d = T0 + np.arange(4)[None, :].repeat(5, axis=0)
    vals = np.array([[1, 13, 2, 3], [13, 13, 13, 13], [4, 5, 6, 7],
                     [8, 9, 13, 10], [1, 2, 3, 4]])
    counts = np.array([4, 4, 2, 3, 4])
    t = _hooked(PORT)
    with pytest.raises(Exception) as e:
        t.add_series_points("m", tags, ts2d, vals, counts)
    assert type(e.value).__name__ == "FailedToAssignUniqueIdError"
    sids = t.add_series_points("m", tags[:4], ts2d[:4], vals[:4],
                               counts[:4])
    j = _hooked(JAX)
    for i in range(4):
        for k in range(counts[i]):
            j.add_point("m", int(ts2d[i, k]), int(vals[i, k]), tags[i])
    assert sids[1] == -1 and (sids[[0, 2, 3]] >= 0).all()
    assert _points(t) == _points(j)
    assert sorted(_Publisher.events["port"]) == \
        sorted(_Publisher.events["jax"])
    assert _MetaCache.counters["port"] == _MetaCache.counters["jax"]
    assert t.uids.tag_values.items() == j.uids.tag_values.items()


def test_failing_hook_is_counted_never_fails_the_write():
    def scenario(side):
        t = tsdb(side, **_slot("tsd.rtpublisher", "Broken", side))
        t.add_point("m", T0, 1, {"host": "a"})
        resp = call(side, t, "POST", "/api/put", {"summary": ""},
                    [{"metric": "m", "timestamp": T0 + 1, "value": 2,
                      "tags": {"host": "a"}}])
        stats = call(side, t, "GET", "/api/stats")[1]
        rows = [r for r in stats if r["metric"].endswith("hooks.errors")]
        return resp, t.datapoints_added, t.hook_errors, \
            [(r["value"], r["tags"].get("hook")) for r in rows]

    got, want = both(scenario)
    assert got == want
    assert got[1] == 2 and got[2] == {"rt_publisher": 2}
    assert got[3] == [(2, "rt_publisher")]


def test_rollup_and_histogram_points_are_published():
    """ROADMAP Queue 3: the port hands rollup and histogram points to
    the publisher (RTPublisher.publishAggregatePoint and
    publishHistogramPoint, the Java reference's contract); the JAX
    package's write paths never call them."""
    from test_torch_histogram import blob

    def scenario(side):
        t = tsdb(side, **_slot("tsd.rtpublisher", "Publisher", side),
                 **{"tsd.rollups.enable": "true"})
        t.add_aggregate_point("r.m", T0, 2.5, {"host": "a"}, False, "1m",
                              "sum")
        t.add_histogram_batch([("hm", T0, blob(np.arange(8)),
                                {"host": "a"})])
        t.add_histogram_point("hm", T0 + 60, blob(np.arange(8)),
                              {"host": "a"})
        return _Publisher.events[side.name]

    got, want = both(scenario)
    assert want == []
    assert [e[0] for e in got] == ["aggregate", "histogram", "histogram"]
    assert got[0] == ("aggregate", "r.m", T0, 2.5, {"host": "a"})


# -- the command line's startup and RPC plugins -------------------------------

@pytest.mark.parametrize("side", ["port", "jax"])
def test_tsd_startup_and_rpc_plugins(tmp_path, side):
    marks = tmp_path / "marks"
    name = "Port" if side == "port" else "Jax"
    pkg, dev = (("opentsdb_tpu_torch", "--tsd.torch.device=cpu")
                if side == "port" else
                ("opentsdb_tpu", "--tsd.tpu.platform=cpu"))
    env = {**os.environ, "TSD_PLUGIN_MARKS": str(marks),
           "PYTHONPATH": os.pathsep.join([str(ROOT / "tests"), str(ROOT)]),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-m", f"{pkg}.tools.cli", "tsd",
         "--tsd.network.port=0", dev, "--tsd.tpu.warmup=false",
         "--tsd.startup.enable=true",
         f"--tsd.startup.plugin=test_torch_plugins.{name}Startup",
         "--tsd.rpc.enable=true",
         f"--tsd.rpc.plugin=test_torch_plugins.{name}Rpc"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert marks.read_text().splitlines() == [
        f"{name}:init:Config", f"{name}:rpc-init:TSDB", f"{name}:ready:0",
        f"{name}:rpc-shutdown", f"{name}:startup-shutdown"]


def test_import_buffer_counts_lines_as_the_reference():
    """With a write filter on, a line it turns away counts as written
    and one it raises on fails, in both packages. (The port reports the
    failing lines in line order, the reference its parse errors
    first.)"""
    def scenario(side):
        t = tsdb(side, **_slot("tsd.core.write_filter", "Filter", side))
        errors = []
        buf = (f"m {T0} 1 host=a\nm {T0 + 1} 13 host=a\n"
               f"raise.me {T0} 1 host=a\nblocked.z {T0} 2 host=b\n"
               f"m x 1 host=a\n").encode()
        written, _ = t.import_buffer(
            buf, on_error=lambda n, e: errors.append(n))
        return written, sorted(errors), t.datapoints_added

    got, want = both(scenario)
    assert got == want == (3, [3, 5], 1)


def test_hooked_import_replays_lines_in_line_order():
    """With a per-point hook on, a burst replays line by line through
    ``add_point``: the publisher sees the points in line order, and a
    failing line reaches ``on_error`` after every line before it has
    landed."""
    _Publisher.events["port"].clear()
    t = _hooked(PORT)
    seen = []
    buf = (f"m {T0} 1 host=h2\nm {T0} 2 host=h1\nm x 1 host=h1\n"
           f"m {T0 + 1} 3 host=h2\n").encode()
    written, errors = t.import_buffer(
        buf, on_error=lambda n, e: seen.append((n, t.datapoints_added)))
    assert written == 3 and seen == [(3, 2)] and len(errors) == 1
    assert [(e[3], e[5]["host"]) for e in _Publisher.events["port"]] == \
        [(1, "h2"), (2, "h1"), (3, "h2")]
