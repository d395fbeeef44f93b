"""The authentication key and the plugin slots start a TSD as the JAX
package's do, and random metric UIDs are ported (ROADMAP Queue 3 item
15, closed).

- ``tsd.core.authentication.enable=true`` builds the same
  ``SimpleAuthentication`` in both packages (the port's ``TSDB()``, the
  JAX package's ``initialize_plugins``), with the same answers.
- each plugin slot with ``<prefix>.enable=true`` and a class that does
  not import raises the loader's ImportError in both packages, where
  each loads it (the TSDB, the command line's startup and RPC plugins,
  the HTTP router); a slot without a class, or with a class but not
  enabled, loads nothing in either.
- ``tsdb tsd`` builds the TSDB, its plugins with it, before it listens:
  a bad role permission or a plugin that does not import stops it
  there, with the reference's error.
- ``tsd.core.uid.random_metrics=true``: the port's metric UIDs and
  tsuids equal the JAX package's bit for bit (the same seeded RNG and
  retry on a collision), the collision counter too.
"""

import hashlib
import subprocess
import sys
from pathlib import Path

import pytest

import torch_pair  # noqa: F401 - the JAX package's private native build
from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.core.uid import FailedToAssignUniqueIdError as JFailed
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu.utils.plugin import load_plugin_instances as jload
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.auth.simple import AuthStatus
from opentsdb_tpu_torch.core.uid import FailedToAssignUniqueIdError
from opentsdb_tpu_torch.tsd.http_api import HttpRpcRouter
from opentsdb_tpu_torch.utils.plugin import PLUGIN_SLOTS, load_plugin_instances

ROOT = Path(__file__).resolve().parent.parent
CPU = {"tsd.torch.device": "cpu"}
JCPU = {"tsd.tpu.platform": "cpu"}
SLOTS = list(PLUGIN_SLOTS)


def test_every_plugin_slot_of_the_reference_is_listed():
    assert SLOTS == ["tsd.rtpublisher", "tsd.search",
                     "tsd.core.storage_exception_handler",
                     "tsd.core.write_filter", "tsd.uid.filter",
                     "tsd.core.meta.cache", "tsd.startup", "tsd.rpc",
                     "tsd.http.rpc"]


def test_authentication_refused():
    """No longer refused: both packages build the authenticator from
    the same keys and answer alike."""
    key = "tsd.core.authentication.enable"
    users = {"tsd.core.authentication.users":
             f"ann:{hashlib.sha256(b'pw').hexdigest()}:ro",
             "tsd.core.authentication.roles": "ro:http_query"}
    tt = TSDB(Config(**CPU, **{key: "true"}, **users))
    jt = JTSDB(JConfig(**JCPU, **{key: "true"}, **users))
    jt.initialize_plugins()
    for user, pw in (("ann", "pw"), ("ann", "no"), ("bob", "pw")):
        got, want = (a.authenticate(user, pw)
                     for a in (tt.authentication, jt.authentication))
        assert (got.status.name, got.user, sorted(got.roles),
                sorted(p.name for p in got.permissions)) == \
            (want.status.name, want.user, sorted(want.roles),
             sorted(p.name for p in want.permissions))
    assert tt.authentication.authenticate("ann", "pw").status is \
        AuthStatus.SUCCESS
    tt.shutdown()
    off = TSDB(Config(**CPU, **{key: "false"}))
    assert off.authentication is None
    off.shutdown()


def _load_error(prefix: str, cfg: dict, port: bool):
    """The exception each package raises where it loads ``prefix``."""
    try:
        if prefix in ("tsd.startup", "tsd.rpc"):
            (load_plugin_instances if port else jload)(
                (Config if port else JConfig)(**cfg), prefix)
        elif prefix == "tsd.http.rpc":
            if port:
                HttpRpcRouter(TSDB(Config(**CPU, **cfg)))
            else:
                JRouter(JTSDB(JConfig(**JCPU, **cfg)))
        elif port:
            TSDB(Config(**CPU, **cfg))
        else:
            JTSDB(JConfig(**JCPU, **cfg)).initialize_plugins()
    except Exception as exc:  # noqa: BLE001 - compared below
        return exc
    return None


@pytest.mark.parametrize("prefix", SLOTS)
def test_plugin_slot_refused(prefix):
    """A slot whose class does not import: the loader's ImportError,
    with the same message, in both packages."""
    cfg = {f"{prefix}.enable": "true", f"{prefix}.plugin": "nosuch.Mod"}
    got, want = (_load_error(prefix, cfg, port) for port in (True, False))
    assert isinstance(got, ImportError) and isinstance(want, ImportError)
    assert (type(got), str(got)) == (type(want), str(want))
    assert "nosuch" in str(got)


@pytest.mark.parametrize("prefix", SLOTS)
def test_plugin_slot_off_is_no_refusal(prefix):
    """Enabled with no class, or a class not enabled: the reference's
    loader returns nothing for both (``load_plugin_instances``)."""
    for cfg in ({f"{prefix}.enable": "true"},
                {f"{prefix}.enable": "false",
                 f"{prefix}.plugin": "nosuch.Mod"}):
        assert jload(JConfig(**cfg), prefix) == []
        assert load_plugin_instances(Config(**cfg), prefix) == []
        TSDB(Config(**CPU, **cfg)).shutdown()


@pytest.mark.parametrize("key,value", [
    ("tsd.core.authentication.enable", "true"),
    ("tsd.search.plugin", "nosuch.Mod")])
def test_tsd_exits_before_listening(key, value):
    """The TSDB and its plugins are built before the socket: a role
    naming no permission (the reference's ValueError) or a search
    plugin that does not import stops ``tsdb tsd`` there."""
    if key == "tsd.search.plugin":
        extra = ["--tsd.search.enable=true"]
        want = "ModuleNotFoundError: No module named 'nosuch'"
    else:
        extra = ["--tsd.core.authentication.roles=r:not_a_perm"]
        want = "ValueError: invalid permission 'not_a_perm'"
        with pytest.raises(ValueError, match="invalid permission"):
            JTSDB(JConfig(**JCPU, **{
                key: value, "tsd.core.authentication.roles":
                "r:not_a_perm"})).initialize_plugins()
    out = subprocess.run(
        [sys.executable, "-m", "opentsdb_tpu_torch.tools.cli", "tsd",
         "--tsd.network.port=0", "--tsd.torch.device=cpu",
         "--tsd.tpu.warmup=false", f"--{key}={value}", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert want in out.stderr
    assert "TSD listening" not in out.stdout


def _random_pair(width: int = 3):
    keys = {"tsd.core.auto_create_metrics": "true",
            "tsd.core.uid.random_metrics": "true",
            "tsd.storage.uid.width.metric": str(width)}
    jt = JTSDB(JConfig(**keys, **{"tsd.tpu.platform": "cpu"}))
    tt = TSDB(Config(**keys, **CPU))
    return jt, tt


def test_random_metric_uids_match_the_reference():
    jt, tt = _random_pair()
    names = [f"m.{i}" for i in range(60)]
    for t in (jt, tt):
        for i, name in enumerate(names):
            t.add_point(name, 1356998400 + i, float(i),
                        {"host": f"h{i % 5}", "dc": f"dc{i % 2}"})
    got = [tt.uids.metrics.get_id(n) for n in names]
    want = [jt.uids.metrics.get_id(n) for n in names]
    assert got == want
    assert got[0] == 16080999
    # tag UIDs stay sequential
    assert tt.uids.tag_values.get_id("h0") == \
        jt.uids.tag_values.get_id("h0")
    # each series' tsuid, from its own tags
    for i, n in enumerate(names):
        pairs = (("host", f"h{i % 5}"), ("dc", f"dc{i % 2}"))
        ids = [[(t.uids.tag_names.get_id(k), t.uids.tag_values.get_id(v))
                for k, v in pairs] for t in (tt, jt)]
        assert tt.uids.tsuid(got[i], ids[0]) == \
            jt.uids.tsuid(want[i], ids[1])


def test_random_metric_uid_collisions_match_the_reference():
    """A one-byte metric width: the draws collide and retry alike, and
    the space runs out at the same name with the same error."""
    jt, tt = _random_pair(width=1)
    got, want = [], []
    for i in range(300):
        for t, out, err in ((jt, want, JFailed),
                            (tt, got, FailedToAssignUniqueIdError)):
            try:
                out.append(t.uids.metrics.get_or_create_id(f"m{i}"))
            except err as exc:
                out.append(str(exc))
    assert got == want
    assert any(isinstance(x, str) for x in got)
    assert tt.uids.metrics.random_id_collisions == \
        jt.uids.metrics.random_id_collisions > 0


def test_random_metric_uids_in_the_stats():
    _jt, tt = _random_pair()
    tt.add_point("m", 1356998400, 1.0, {"host": "a"})

    rows = []

    class Rec:
        def record(self, name, value, **tags):
            rows.append((name, value, tags))

    tt.uids.metrics.collect_stats(Rec())
    assert ("uid.random-id-collisions", 0, {"kind": "metric"}) in rows


# -- the cluster tier: what resharding (1.6d(ii)) and the sibling routers ----
# -- (1.6d(iii)) brought -----------------------------------------------------

ROUTER = {**CPU, "tsd.cluster.role": "router",
          "tsd.cluster.peers": "s0=127.0.0.1:1,s1=127.0.0.1:2"}
JROUTER = {**JCPU, "tsd.cluster.role": "router",
           "tsd.cluster.peers": "s0=127.0.0.1:1,s1=127.0.0.1:2"}


@pytest.mark.parametrize("key,value", [
    ("tsd.cluster.routers", "r1=127.0.0.1:9")])
def test_sibling_router_keys_build_a_bus(key, value):
    """The sibling routers' gossip (1.6d(iii)) is ported. A router naming a sibling builds in both packages with a
    bus of that one sibling, whose health document is the same up to
    the nonce and the clock; with the key empty there is no bus."""
    docs = []
    for tsdb in (JTSDB(JConfig(**{**JROUTER, key: value})),
                 TSDB(Config(**{**ROUTER, key: value}))):
        try:
            bus = tsdb.cluster.gossip
            assert sorted(bus.siblings) == ["r1"]
            doc = bus.health_info()
            assert len(doc.pop("nonce")) == 16
            for sib in doc["siblings"].values():
                sib.pop("last_ok_age_s")
            docs.append(doc)
        finally:
            tsdb.shutdown()
    assert docs[0] == docs[1]
    assert docs[1]["degraded"] is False
    assert docs[1]["siblings"]["r1"]["address"] == "127.0.0.1:9"
    t = TSDB(Config(**{**ROUTER, key: ""}))
    try:
        assert t.cluster.gossip is None
    finally:
        t.shutdown()


@pytest.mark.parametrize("rf", ["2", "3"])
def test_replication_factor_builds_a_router(rf):
    """Replication is ported: a router at ``tsd.cluster.rf`` 2 or 3
    builds in both packages, with the same factor, ring and replica
    sets (rf is clamped to the ring's two shards in both)."""
    t = TSDB(Config(**{**ROUTER, "tsd.cluster.rf": rf}))
    j = JTSDB(JConfig(**{**JROUTER, "tsd.cluster.rf": rf}))
    try:
        assert t.cluster.rf == j.cluster.rf == int(rf)
        assert t.cluster.ring.replica_sets(int(rf)) == \
            j.cluster.ring.replica_sets(int(rf))
        assert t.cluster.health_info()["rf"] == \
            j.cluster.health_info()["rf"]
    finally:
        t.shutdown()
        j.shutdown()


def _volatile_free(doc):
    """A reshard document without its wall-clock fence."""
    return {k: v for k, v in doc.items() if k != "fence_ms"}


def test_placement_auto_refused_on_a_router():
    """No longer refused: with ``tsd.control.placement.auto=true`` a
    router of either package builds, and a tick over a hot shard
    applies the plane's own plan, opening the same cutover at epoch 1;
    a second tick defers while the window is open."""
    keys = {"tsd.control.enable": "true",
            "tsd.control.placement.auto": "true",
            "tsd.control.placement.hot_ratio": "1.5"}
    got = []
    for tsdb in (JTSDB(JConfig(**{**JROUTER, **keys})),
                 TSDB(Config(**{**ROUTER, **keys}))):
        try:
            tsdb.cluster.peers["s0"].forwarded_points = 1000
            tsdb.cluster.peers["s1"].forwarded_points = 10
            first, second = {}, {}
            tsdb.control._placement_tick(0, first)
            tsdb.control._placement_tick(0, second)
            got.append((_volatile_free(first["placement"]["applied"]),
                        second["placement"],
                        tsdb.control.describe()["placement"],
                        tsdb.cluster.resharding))
        finally:
            tsdb.shutdown()
    assert got[0] == got[1]
    assert got[1][0]["epoch"] == 1 and got[1][3] is True
    assert got[1][1]["deferred"] == "reshard in progress"
    # not a router: the key applies nothing, as in the reference
    TSDB(Config(**{**CPU, **keys})).shutdown()


def _router_pair():
    t = TSDB(Config(**ROUTER))
    j = JTSDB(JConfig(**JROUTER))
    return t, j


def _call(router, request_cls, method, path, body=None):
    import json
    return router.handle(request_cls(
        method=method, path=path,
        body=json.dumps(body).encode() if body is not None else b""))


@pytest.mark.parametrize("method,path,item", [
    ("POST", "/api/cluster/reshard", "1.6d(ii)")])
def test_router_endpoints_refused(method, path, item):
    """No longer refused: resharding (1.6d(ii)) is ported, and ``POST
    /api/cluster/reshard`` on the port's router answers the JAX
    package's 200 with the same document (the cutover opened at epoch
    1), then the same 400 to a second install while it is open."""
    import json
    from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest
    t, j = _router_pair()
    body = {"peers": "s0=127.0.0.1:1", "vnodes": 64}
    try:
        got = []
        for router, cls in ((JRouter(j), JRequest),
                            (HttpRpcRouter(t), HttpRequest)):
            first = _call(router, cls, method, path, body)
            again = _call(router, cls, method, path, body)
            got.append((first.status,
                        _volatile_free(json.loads(first.body)),
                        again.status, again.body))
        assert got[0] == got[1]
        assert got[1][0] == 200 and got[1][2] == 400
        assert got[1][1]["epoch"] == 1 and got[1][1]["active"]
    finally:
        t.shutdown()
        j.shutdown()


def test_gossip_answers_the_reference_s_400():
    """A router that names no sibling routers answers ``POST
    /api/cluster/gossip`` with the reference's 400."""
    from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest
    t, j = _router_pair()
    try:
        got = [_call(HttpRpcRouter(t), HttpRequest, "POST",
                     "/api/cluster/gossip", {}),
               _call(JRouter(j), JRequest, "POST", "/api/cluster/gossip",
                     {})]
        assert got[0].status == got[1].status == 400
        assert got[0].body == got[1].body
    finally:
        t.shutdown()
        j.shutdown()


def test_a_confirmed_placement_plan_is_refused():
    """No longer refused: a standing proposal confirmed by its planId
    reshards the ring on the port as in the reference (the same ring
    at the plan's vnodes, epoch 1); the reference's 400s for no
    proposal and a stale id stay."""
    from opentsdb_tpu.query.model import BadRequestError as JBadRequest
    from opentsdb_tpu_torch.query.model import BadRequestError
    keys = {"tsd.control.enable": "true",
            "tsd.control.placement.hot_ratio": "1.5"}
    got = []
    for tsdb, bad in ((JTSDB(JConfig(**{**JROUTER, **keys})), JBadRequest),
                      (TSDB(Config(**{**ROUTER, **keys})),
                       BadRequestError)):
        try:
            plane = tsdb.control
            with pytest.raises(bad, match="no reshard proposal"):
                plane.apply_plan("x")
            router = tsdb.cluster
            router.peers["s0"].forwarded_points = 1000
            router.peers["s1"].forwarded_points = 10
            plane._placement_tick(0, {})
            plan = plane.plan_info()
            assert plan["hotShards"] == ["s0"] and plan["planId"]
            with pytest.raises(bad, match="planId does not match"):
                plane.apply_plan("stale")
            assert not router.resharding
            done = plane.apply_plan(plan["planId"])
            got.append((_volatile_free(done),
                        plane.plan_info()["appliedPlanId"]
                        == plan["planId"], router.ring.vnodes
                        == plan["proposal"]["vnodes"]))
        finally:
            tsdb.shutdown()
    assert got[0] == got[1]
    assert got[1][0]["epoch"] == 1 and got[1][1] and got[1][2]


@pytest.mark.parametrize("method,path", [
    ("POST", "/api/query/continuous"), ("GET", "/api/query/continuous")])
def test_router_continuous_queries_answer_as_the_reference(method, path):
    """Federated continuous queries are ported: on a router whose shards
    cannot be reached, a registration answers the reference's 503 (no
    shard to hold it) and the list its empty 200, byte for byte."""
    from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest
    body = {"id": "c1", "start": "1h-ago", "queries": [
        {"metric": "m", "aggregator": "sum", "downsample": "1m-sum"}]}
    t, j = _router_pair()
    try:
        got = [_call(HttpRpcRouter(t), HttpRequest, method, path, body),
               _call(JRouter(j), JRequest, method, path, body)]
        assert got[0].status == got[1].status == \
            (503 if method == "POST" else 200)
        assert got[0].body == got[1].body
    finally:
        t.shutdown()
        j.shutdown()


def test_replica_sel_parses_as_the_reference():
    """A replicated router's read plan (``replicaSel``) is ported: a
    shard parses it, writes it back and keys its cache on it as the
    reference does, and refuses a malformed one with the same 400."""
    from opentsdb_tpu.query.model import BadRequestError as JBad
    from opentsdb_tpu.query.model import TSQuery as JQuery
    from opentsdb_tpu_torch.query.model import BadRequestError, TSQuery
    doc = {"start": "1h-ago", "queries": [
        {"metric": "m", "aggregator": "sum"}],
        "replicaSel": {"peers": ["s0", "s1"], "vnodes": 8, "rf": 2,
                       "sets": [["s0", "s1"]]}}
    t, j = TSQuery.from_json(doc), JQuery.from_json(doc)
    assert t.replica_sel == j.replica_sel
    assert t.to_json()["replicaSel"] == j.to_json()["replicaSel"]
    bad = dict(doc, replicaSel={"peers": ["s0"], "sets": [["s9"]]})
    errors = []
    for parse, err in ((TSQuery.from_json, BadRequestError),
                       (JQuery.from_json, JBad)):
        with pytest.raises(err) as e:
            parse(bad)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
