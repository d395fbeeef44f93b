"""The store scan fault sites on the port (``store`` on the raw stores,
``rollup.store`` on the tier and preagg stores), held against the JAX
package: the cases of ``tests/test_faults.py`` (``TestStoreFaults``'
read latency) and ``tests/test_result_cache.py`` (the degraded tier),
run on both packages, on both stores. Also the configuration keys: a
key of the control plane's, the router's, the backfill's, the retire
pass's, the federated continuous queries' or the sibling routers'
gossip's sites arms it, and one that names no site at all warns and
arms nothing that is checked.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest

import torch_pair  # noqa: F401 - the JAX package's private native build
from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.query.model import TSQuery as JQuery
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.query.model import TSQuery
from opentsdb_tpu_torch.utils.faults import (KNOWN_SITES, FaultInjector,
                                             InjectedFault)

BASE = 1356998400
STORES = ("memory", "native")


def make(port: bool, backend: str, **keys):
    base = {"tsd.core.auto_create_metrics": "true",
            "tsd.storage.backend": backend, **keys}
    if port:
        return TSDB(Config(**{"tsd.torch.device": "cpu",
                              "tsd.torch.dtype": "float64", **base}))
    return JTSDB(JConfig(**{"tsd.tpu.platform": "cpu", **base}))


def seed(t, n=5):
    rng = np.random.default_rng(0)
    for i in range(n):
        t.add_points("f.m", BASE + 10 * np.arange(30),
                     rng.normal(10, 1, 30), {"host": f"h{i}"})


def query(t, metric="f.m", ds="1m-sum", end=BASE + 300):
    model = TSQuery if isinstance(t, TSDB) else JQuery
    sub = {"metric": metric, "aggregator": "sum"}
    if ds:
        sub["downsample"] = ds
    return t.execute_query(model.from_json({
        "start": BASE, "end": end, "queries": [sub]}).validate())


def dps(results):
    return {(r.metric, tuple(sorted(r.tags.items()))): r.dps
            for r in results}


def test_reference_sites_are_ported_but_cluster_and_control():
    """Every site of the reference, and none is refused: the control
    plane's ``control.*`` came with ``control/``, the router's
    ``cluster.peer``, ``cluster.wire`` and ``cluster.replica`` with
    ``cluster/``, ``cluster.cq`` with the federated continuous queries,
    ``cluster.reshard`` and ``cluster.retire`` with resharding, and
    ``cluster.gossip`` (and its per-sibling family) with the sibling
    routers."""
    from opentsdb_tpu.utils.faults import DYNAMIC_SITE_PREFIXES as JDYN
    from opentsdb_tpu.utils.faults import KNOWN_SITES as JSITES
    from opentsdb_tpu_torch.utils.faults import DYNAMIC_SITE_PREFIXES
    assert KNOWN_SITES == JSITES
    assert DYNAMIC_SITE_PREFIXES == JDYN
    assert {"control.materialize", "control.qos", "control.placement",
            "cluster.peer", "cluster.wire", "cluster.replica",
            "cluster.cq", "cluster.reshard", "cluster.retire",
            "cluster.gossip"} <= KNOWN_SITES


@pytest.mark.parametrize("backend", STORES)
def test_store_read_latency_injection(backend):
    """``tsd.faults.store.latency_ms`` arms the scan check the reference
    has (``tests/test_faults.py::test_store_read_latency_injection``):
    the query answers and the site counts its calls."""
    calls = []
    for port in (False, True):
        t = make(port, backend, **{"tsd.faults.store.latency_ms": "1"})
        seed(t)
        assert len(query(t)) == 1
        calls.append(t.faults.health_info()["sites"]["store"]["calls"])
    assert min(calls) >= 1


@pytest.mark.parametrize("backend", STORES)
def test_store_error_fails_the_raw_scan(backend):
    outs = []
    for port in (False, True):
        t = make(port, backend,
                 **{"tsd.faults.store.error_count": "1",
                    "tsd.query.cache.enable": "false"})
        seed(t)
        with pytest.raises(OSError, match="injected fault at 'store'"):
            query(t)
        outs.append(dps(query(t)))   # the schedule's next call passes
    assert outs[0].keys() == outs[1].keys()
    for key in outs[0]:
        np.testing.assert_allclose([v for _, v in outs[1][key]],
                                   [v for _, v in outs[0][key]],
                                   rtol=1e-12)


def tier_tsdb(port: bool, backend: str):
    t = make(port, backend, **{"tsd.rollups.enable": "true"})
    for off in range(0, 600, 60):
        t.add_aggregate_point("r.m", BASE + off, 10.0, {"host": "a"},
                              False, "1m", "sum")
    seed(t)     # raw data rides along
    return t


@pytest.mark.parametrize("backend", STORES)
def test_lazily_created_tiers_carry_fault_sites(backend):
    for port in (False, True):
        t = tier_tsdb(port, backend)
        tier = t.rollup_store.tier("1m", "sum")
        assert tier.fault_injector is t.faults
        assert tier.fault_site == "rollup.store"
        assert t.rollup_store.preagg_store().fault_site == "rollup.store"
        # a tier made after the TSDB is wired the moment it exists
        late = t.rollup_store.tier("1h", "max")
        assert (late.fault_injector, late.fault_site) == \
            (t.faults, "rollup.store")
        assert t.store.fault_site == "store"


@pytest.mark.parametrize("backend", STORES)
def test_degraded_tier_fails_loudly_and_cache_unpoisoned(backend):
    """(ref: ``tests/test_result_cache.py::TestDegradedTier``) An armed
    ``rollup.store`` fails the tier-answered query, leaves raw queries
    alone and caches nothing; after disarming, the answer reflects the
    tier write that landed before the fault and is cached again."""
    answers = []
    for port in (False, True):
        t = tier_tsdb(port, backend)
        q = lambda: query(t, metric="r.m", end=BASE + 600)  # noqa: E731
        r1 = q()
        assert r1
        t.faults.arm("rollup.store", error_count=10)
        t.add_aggregate_point("r.m", BASE + 300, 99.0, {"host": "a"},
                              False, "1m", "sum")
        with pytest.raises(OSError):
            q()
        assert query(t, ds=None)     # the raw path is another site
        rc = t.result_cache
        entries = rc.total_entries
        t.faults.disarm("rollup.store")
        r2 = q()
        assert dps(r2) != dps(r1)
        assert rc.total_entries == entries + 1
        assert dps(q()) == dps(r2)
        answers.append(dps(r2))
    assert answers[0] == answers[1]


@pytest.mark.parametrize("key", [
    "tsd.faults.cluster.peer_error_rate",
    "tsd.faults.cluster.peer.s1_error_count",
    "tsd.faults.cluster.wire.s0.latency_ms",
    "tsd.faults.cluster.cq.x.latency_ms",
    "tsd.faults.cluster.cq_error_count",
    "tsd.faults.cluster.reshard_error_count",
    "tsd.faults.cluster.retire_error_once",
    "tsd.faults.cluster.gossip.r1_error_rate",
    "tsd.faults.control.qos_error_count",
    "tsd.faults.control.placement.error_once"])
def test_cluster_and_control_site_keys_arm(key):
    """A key of the control plane's, the router's, the backfill's, the
    retire pass's, the federated continuous queries' or the sibling
    routers' gossip's sites (per-peer ones included) arms its one site,
    as the reference does: none of them is refused any longer."""
    j = JTSDB(JConfig(**{"tsd.tpu.platform": "cpu", key: "1"}))
    t = TSDB(Config(**{"tsd.torch.device": "cpu", key: "1"}))
    try:
        sites = t.faults.health_info()["sites"]
        assert len(sites) == 1 and key.startswith(
            f"tsd.faults.{next(iter(sites))}")
        assert sites == j.faults.health_info()["sites"]
    finally:
        t.shutdown()
        j.shutdown()


def test_unknown_site_key_warns_on_both(caplog):
    from opentsdb_tpu.utils.faults import FaultInjector as JFaultInjector
    for cls in (JFaultInjector, FaultInjector):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="faults"):
            # tsdlint: allow[fault-sites] deliberately unregistered —
            # the warning for a typo'd key is what this test holds
            cls().configure([("tsd.faults.stroe.latency_ms", "5")])
        assert "unknown fault site 'stroe'" in caplog.text
        with pytest.raises(ValueError, match="unknown fault site"):
            # tsdlint: allow[fault-sites] deliberately unregistered —
            # arm() must refuse a typo'd site
            cls().arm("stroe")


@pytest.mark.parametrize("site", sorted(KNOWN_SITES))
def test_every_known_site_arms(site):
    inj = FaultInjector()
    inj.arm(site, error_count=1)
    with pytest.raises(InjectedFault):
        inj.check(site)
    inj.check(site)
