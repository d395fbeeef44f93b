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
