"""The engine's device breaker in its shedding mode, against the JAX
package's at ``tsd.query.degraded.host_fallback=false`` (mirroring
``tests/test_faults.py::TestDeviceBreakerFallback``).

The port keeps only the shedding mode: a device failure is counted and
raised (a 500 over HTTP); past the threshold the breaker opens and a
query that would touch the device answers 503 with Retry-After without
a device call; after the reset window one probe goes through and its
success closes the breaker. ``host_fallback=true`` (the reference's
default, its host re-answer) raises when the TSDB is built. The
reference's cold re-run of a failed warm hit is also a fallback: the
port raises there (ROADMAP Queue 3), pinned below with both packages.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.query.model import TSQuery as JQuery
from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu.utils.faults import DegradedError as JDegradedError
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.query.model import TSQuery
from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
from opentsdb_tpu_torch.utils import faults as tfaults
from opentsdb_tpu_torch.utils.faults import DegradedError, InjectedFault

BASE = 1356998400
# the reference's TestDeviceBreakerFallback.CFG, shedding mode
CFG = {"tsd.query.host_tail_max_cells": "-1",
       "tsd.query.host_tail_max_cells_linear": "-1",
       "tsd.query.cache.enable": "false",
       "tsd.query.breaker.failure_threshold": "2",
       "tsd.query.breaker.reset_timeout_ms": "60000",
       "tsd.query.degraded.host_fallback": "false",
       "tsd.core.auto_create_metrics": "true"}


def _pair(**extra):
    jt = JTSDB(JConfig(**{**CFG, "tsd.tpu.platform": "cpu",
                          "tsd.tpu.warmup": "false", **extra}))
    tt = TSDB(Config(**{**CFG, "tsd.torch.device": "cpu",
                        "tsd.torch.dtype": "float64", **extra}))
    for t in (jt, tt):
        for i in range(50):
            t.add_point("f.m", BASE + i * 10, float(i), {"host": "a"})
            t.add_point("f.m", BASE + i * 10, float(2 * i), {"host": "b"})
    return jt, tt


def _query(t, downsample=None):
    spec = {"metric": "f.m", "aggregator": "sum"}
    if downsample:
        spec["downsample"] = downsample
    model = TSQuery if isinstance(t, TSDB) else JQuery
    return t.execute_query(model.from_json({
        "start": BASE * 1000, "end": (BASE + 3600) * 1000,
        "queries": [spec]}).validate())


def _calls(t) -> int:
    return t.faults.health_info()["sites"]["device.compile"]["calls"]


def _close(*dbs):
    for t in dbs:
        t.shutdown()


def test_device_compile_is_a_known_site():
    assert "device.compile" in tfaults.KNOWN_SITES
    t = TSDB(Config(**{"tsd.torch.device": "cpu"}))
    t.faults.arm("device.compile", error_count=1)
    _close(t)


def test_host_fallback_true_raises_when_built():
    """The reference's ``host_fallback=true`` re-answers a failed query
    on the host: a fallback, refused when the TSDB is built."""
    with pytest.raises(ValueError, match="host_fallback"):
        TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.query.degraded.host_fallback": "true"}))
    t = TSDB(Config(**{"tsd.torch.device": "cpu"}))
    assert t.device_breaker.name == "device.pipeline"
    assert t.device_breaker.failure_threshold == 5
    assert t.device_breaker.reset_timeout_ms == 30000
    off = TSDB(Config(**{"tsd.torch.device": "cpu",
                         "tsd.query.breaker.failure_threshold": "0"}))
    assert off.device_breaker is None
    _close(t, off)


@pytest.mark.parametrize("path", ["point", "grid", "grid-host"])
def test_fallback_disabled_sheds_structured_503(path):
    """(ref: ``test_fallback_disabled_sheds_structured_503``) failures
    answer 500 until the breaker trips, then 503 with Retry-After and
    no further device call, in both packages; on the grid path too,
    and for a query whose tail would be host-placed (the reference's
    ``_tail_device`` sheds it before placement)."""
    extra = {"tsd.faults.device.compile_error_rate": "1.0"}
    if path == "grid-host":
        extra.update({"tsd.query.host_tail_max_cells": "0",
                      "tsd.query.host_tail_max_cells_linear": "0"})
    jt, tt = _pair(**extra)
    params = {"start": [str(BASE * 1000)],
              "end": [str((BASE + 3600) * 1000)],
              "m": ["sum:f.m" if path == "point" else "sum:1m-avg:f.m"]}
    statuses = []
    for t, router, req in ((jt, JRouter(jt), JRequest),
                           (tt, HttpRpcRouter(tt), HttpRequest)):
        def q():
            return router.handle(req("GET", "/api/query", params, {},
                                     b""))
        got = []
        if path == "grid-host":
            # a host-placed tail never touches the device: no failure
            got.append(q().status)
            for _ in range(2):
                t.device_breaker.record_failure()
        else:
            got += [q().status, q().status]
        assert t.device_breaker.state == t.device_breaker.OPEN
        calls = _calls(t)
        resp = q()
        got.append(resp.status)
        assert resp.headers.get("Retry-After")
        assert json.loads(resp.body)["error"]["code"] == 503
        assert _calls(t) == calls
        statuses.append(got)
    assert statuses[0] == statuses[1] == \
        ([200, 503] if path == "grid-host" else [500, 500, 503])
    _close(jt, tt)


def test_open_breaker_sheds_without_device_calls():
    """(ref: ``test_open_breaker_serves_from_host_without_device_calls``
    at ``host_fallback=false``) once open, a query raises DegradedError
    and the device fault site is not consulted again."""
    jt, tt = _pair(**{"tsd.faults.device.compile_error_rate": "1.0"})
    for t, err in ((jt, JDegradedError), (tt, DegradedError)):
        for _ in range(2):
            with pytest.raises(Exception):
                _query(t)
        assert t.device_breaker.state == t.device_breaker.OPEN
        calls = _calls(t)
        with pytest.raises(err):
            _query(t)
        assert _calls(t) == calls
    _close(jt, tt)


def test_run_device_sheds_with_the_breaker_open():
    """(ref: ``test_open_breaker_without_host_twin_sheds_structured``)
    an open breaker refuses a dispatch with DegradedError; the port has
    no host twin to route to."""
    jt, tt = _pair()
    for t, err in ((jt, JDegradedError), (tt, DegradedError)):
        engine = t.new_query()
        t.device_breaker.record_failure()
        t.device_breaker.record_failure()
        assert t.device_breaker.state == t.device_breaker.OPEN
        with pytest.raises(err):
            engine._run_device(lambda: 1)
    # a host-placed dispatch bypasses the breaker in both
    assert tt.new_query()._run_device(lambda: "host",
                                      on_device=False) == "host"
    _close(jt, tt)


def test_breaker_probe_recovers_after_reset_window():
    """(ref: ``test_breaker_probe_recovers_after_reset_window``) two
    injected failures open it; past the window the probe's success
    closes it, and the answer equals the reference's."""
    jt, tt = _pair(**{"tsd.faults.device.compile_error_count": "2"})
    answers = []
    for t in (jt, tt):
        for _ in range(2):
            with pytest.raises(Exception):
                _query(t)
        assert t.device_breaker.state == t.device_breaker.OPEN
        t.device_breaker._opened_at -= 61
        t.drop_caches()
        answers.append(_query(t))
        assert t.device_breaker.state == t.device_breaker.CLOSED
        assert t.device_breaker.recoveries == 1
    assert answers[0][0].dps == answers[1][0].dps
    _close(jt, tt)


def test_failure_is_counted_and_raised_not_retried():
    """A device failure raises the injected fault (no host re-answer):
    the breaker counts it, ``fallbacks`` stays 0, and the next query
    succeeds with the schedule spent."""
    _, tt = _pair(**{"tsd.faults.device.compile_error_count": "1"})
    with pytest.raises(InjectedFault):
        _query(tt)
    b = tt.device_breaker
    assert (b.failures, b.total_failures, b.fallbacks) == (1, 1, 0)
    assert _query(tt)[0].dps
    assert b.failures == 0 and b.state == b.CLOSED
    _close(tt)


def test_failing_warm_hit_raises_where_the_reference_reruns_cold():
    """ROADMAP Queue 3: a warm prepared-batch hit that fails on the
    device. The reference (``_run_sub`` :865-876) re-runs the query
    cold and answers; the port raises (no fallback). Both count the
    failure."""
    keys = {"tsd.query.grid_reduce": "false"}
    jt, tt = _pair(**keys)
    for t in (jt, tt):
        _query(t)                      # fills the device prep cache
        t.faults.arm("device.compile", error_count=1)
    want = _query(jt)
    assert jt.device_breaker.total_failures == 1
    with pytest.raises(InjectedFault):
        _query(tt)
    assert tt.device_breaker.total_failures == 1
    assert _query(tt)[0].dps == want[0].dps
    _close(jt, tt)


def test_breaker_state_in_the_stats():
    t = TSDB(Config(**{"tsd.torch.device": "cpu"}))
    rows = [r for r in t.stats.collect().records
            if r[0] == "tsd.breaker.state"]
    assert any(r[2].get("breaker") == "device.pipeline" for r in rows)
    _close(t)


def test_warm_host_pool_hit_serves_with_the_breaker_open():
    """A host-placed warm hit touches no device, so it still answers
    while the breaker is open, as in the reference; a device-placed
    query over the same data is refused."""
    jt, tt = _pair(**{"tsd.query.host_tail_max_cells": "0",
                      "tsd.query.host_tail_max_cells_linear": "0",
                      "tsd.query.grid_reduce": "false"})
    for t in (jt, tt):
        first = _query(t)
        t.device_breaker.record_failure()
        t.device_breaker.record_failure()
        again = _query(t)
        assert again[0].dps == first[0].dps
        assert t.host_prep_cache.hits >= 1
    np.testing.assert_allclose([v for _, v in first[0].dps],
                               [v for _, v in _query(jt)[0].dps])
    _close(jt, tt)
