"""Keys that turn on what the port does not have are refused, and random
metric UIDs are ported (ROADMAP Queue 3 item 15, closed).

- ``tsd.core.authentication.enable=true`` and each plugin slot with
  ``<prefix>.enable=true`` and a ``<prefix>.plugin`` class (the
  reference's own test for loading one, ``utils/plugin.py:47-51``) make
  ``TSDB()`` raise NotImplementedError naming the key and "the rest,
  with no device compute"; a slot without a class, or with a class but
  not enabled, loads nothing in the reference and is no refusal here.
  ``tsdb tsd`` builds the TSDB first, so it exits before anything
  listens.
- ``tsd.core.uid.random_metrics=true``: the port's metric UIDs and
  tsuids equal the JAX package's bit for bit (the same seeded RNG and
  retry on a collision), the collision counter too.
"""

import subprocess
import sys
from pathlib import Path

import pytest

import torch_pair  # noqa: F401 - the JAX package's private native build
from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.core.uid import FailedToAssignUniqueIdError as JFailed
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.core.uid import FailedToAssignUniqueIdError
from opentsdb_tpu_torch.query.engine import _UNPORTED_PLUGIN_SLOTS

ROOT = Path(__file__).resolve().parent.parent
CPU = {"tsd.torch.device": "cpu"}
SLOTS = [prefix for prefix, _ in _UNPORTED_PLUGIN_SLOTS]
REFUSED = "not ported yet \\(ROADMAP Queue 1, the rest, with no device " \
    "compute\\)"


def test_every_plugin_slot_of_the_reference_is_listed():
    assert SLOTS == ["tsd.rtpublisher", "tsd.search",
                     "tsd.core.storage_exception_handler",
                     "tsd.core.write_filter", "tsd.uid.filter",
                     "tsd.core.meta.cache", "tsd.startup", "tsd.rpc",
                     "tsd.http.rpc"]


def test_authentication_refused():
    key = "tsd.core.authentication.enable"
    with pytest.raises(NotImplementedError,
                       match=f"{key}=true .*{REFUSED}"):
        TSDB(Config(**CPU, **{key: "true"}))
    TSDB(Config(**CPU, **{key: "false"})).shutdown()


@pytest.mark.parametrize("prefix", SLOTS)
def test_plugin_slot_refused(prefix):
    cfg = {f"{prefix}.enable": "true", f"{prefix}.plugin": "nosuch.Mod"}
    with pytest.raises(NotImplementedError,
                       match=f"{prefix}.enable=true with {prefix}.plugin="
                       f"nosuch.Mod .*{REFUSED}"):
        TSDB(Config(**CPU, **cfg))


@pytest.mark.parametrize("prefix", SLOTS)
def test_plugin_slot_off_is_no_refusal(prefix):
    """Enabled with no class, or a class not enabled: the reference's
    loader returns nothing for both (``load_plugin_instances``)."""
    from opentsdb_tpu.utils.plugin import load_plugin_instances
    for cfg in ({f"{prefix}.enable": "true"},
                {f"{prefix}.enable": "false",
                 f"{prefix}.plugin": "nosuch.Mod"}):
        assert load_plugin_instances(JConfig(**cfg), prefix) == []
        TSDB(Config(**CPU, **cfg)).shutdown()


@pytest.mark.parametrize("key,value", [
    ("tsd.core.authentication.enable", "true"),
    ("tsd.search.plugin", "nosuch.Mod")])
def test_tsd_exits_before_listening(key, value):
    extra = ["--tsd.search.enable=true"] if key == "tsd.search.plugin" \
        else []
    out = subprocess.run(
        [sys.executable, "-m", "opentsdb_tpu_torch.tools.cli", "tsd",
         "--tsd.network.port=0", "--tsd.torch.device=cpu",
         "--tsd.tpu.warmup=false", f"--{key}={value}", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr
    assert "the rest, with no device compute" in out.stderr
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
