"""The port's control plane (``opentsdb_tpu_torch/control/``) held to the
JAX package's (``opentsdb_tpu/control/``) on the CPU.

- ``cq_candidate`` over a matrix of queries: the same canonical strings,
  bodies and auto ids.
- The shape miner in both directions: each package's miner scores a
  log the other wrote exactly as that package's own miner does.
- Materialization: the auto continuous query answers a repeat pull
  bit for bit as a hand-registered one of the same body, and as the
  JAX package's auto query on the same data; hysteresis, the blacklist
  and the cap.
- ``TenantGovernor``: the same decisions on the same call sequences;
  its result-cache insert gate and fold budget; the noisy-tenant battery
  over real sockets.
- Placement on a TSD that is not a router, and on a router: a
  confirmed plan and ``tsd.control.placement.auto=true`` reshard the
  ring as in the reference (``TestPlacement``'s twins).
- Chaos: each ``control.*`` fault site parks the loop while the data
  plane serves; the breaker; a disabled plane does nothing.

Tolerance: none. Strings, scores, decisions, statuses and query answers
compare exactly.
"""

import json
import random
import threading
import time

import pytest

from torch_obs_pair import JAX, PORT, SIDES, both, call, shutdown, tsdb

NOW_S = int(time.time())
CTL = {"tsd.control.enable": "true"}
# the minute a test starts in: its data sits inside "30m-ago" for five
# minutes from then, whenever the worker reaches the test
_NOW = [NOW_S]


@pytest.fixture(autouse=True)
def now():
    _NOW[0] = int(time.time()) // 60 * 60
    return _NOW[0]


@pytest.fixture
def made():
    out = []
    yield out
    for t in out:
        shutdown(t)


def mk(made, side, tmp_path=None, **keys):
    """A control-plane TSDB; with ``tmp_path`` it logs query shapes."""
    extra = dict(CTL)
    if tmp_path is not None:
        d = tmp_path / side.name
        d.mkdir(parents=True, exist_ok=True)
        extra.update({"tsd.storage.data_dir": str(d),
                      "tsd.storage.wal.enable": "false"})
    t = tsdb(side, **extra, **keys)
    made.append(t)
    return t


def seed(t, metric="ctl.cpu", n=40):
    for i in range(n):
        t.add_point(metric, _NOW[0] - 1500 + i * 30, float(i),
                    {"host": "a" if i % 2 else "b"})


def qparams(metric="ctl.cpu"):
    return {"start": "30m-ago", "m": f"sum:1m-sum:{metric}"}


def pull(side, router, metric="ctl.cpu", n=1):
    for _ in range(n):
        r = call(side, router, "GET", "/api/query", **qparams(metric))
        assert r.status == 200, r.body
    return r


def tsq(side, metric="ctl.cpu", start="30m-ago", ds="1m-sum", **over):
    sub = {"metric": metric, "aggregator": "sum", "downsample": ds}
    sub.update(over.pop("sub", {}))
    q = side.TSQuery.from_json({"start": start, "queries": [sub], **over})
    q.validate()
    return q


# -- cq_candidate --------------------------------------------------------

_WILD = {"type": "wildcard", "tagk": "host", "filter": "*",
         "groupBy": True}
_LIT = {"type": "literal_or", "tagk": "dc", "filter": "x|y",
        "groupBy": False}
CANDIDATES = [
    ("plain", {}),
    ("rate", {"sub": {"rate": True,
                      "rateOptions": {"counter": True, "counterMax": 100}}}),
    ("filters", {"sub": {"filters": [_WILD, _LIT]}}),
    ("filters-swapped", {"sub": {"filters": [_LIT, _WILD]}}),
    ("max", {"ds": "5m-max"}),
    ("avg", {"ds": "1m-avg"}),
    ("count", {"ds": "1m-count"}),
    ("p95", {"ds": "1m-p95"}),
    ("absolute", {"start": NOW_S * 1000 - 3600_000}),
    ("end-relative", {"end": "1m-ago"}),
    ("calendar", {"ds": "1mc-sum"}),
    ("run-all", {"ds": "0all-sum"}),
    ("explicit", {"sub": {"explicitTags": True, "filters": [_WILD]}}),
    ("timezone", {"timezone": "UTC"}),
    ("fill", {"ds": "1m-sum-zero"}),
    ("pct", {"sub": {"percentiles": [99.0, 50.0]}}),
]


@pytest.mark.parametrize("case,over", CANDIDATES,
                         ids=[c[0] for c in CANDIDATES])
def test_cq_candidate(case, over):
    def run(side):
        q = tsq(side, **dict(over))
        cand = side.shapes.cq_candidate(q)
        if cand is None:
            return None
        return cand, side.shapes.candidate_body(cand), \
            side.shapes.auto_id(cand)

    got, want = both(run)
    assert got == want
    if case in ("plain", "rate", "filters"):
        assert got is not None and got[2].startswith("auto-")
    if case in ("absolute", "p95", "calendar", "timezone"):
        assert got is None


def test_cq_candidate_of_a_delete_is_none():
    for side in SIDES:
        q = tsq(side)
        q.delete = True
        assert side.shapes.cq_candidate(q) is None


def test_filter_order_preserved():
    for side in SIDES:
        a = side.shapes.cq_candidate(tsq(side, sub={"filters": [_WILD,
                                                                _LIT]}))
        b = side.shapes.cq_candidate(tsq(side, sub={"filters": [_LIT,
                                                                _WILD]}))
        assert a != b
        assert [f["tagk"] for f in side.shapes.candidate_body(a)[
            "queries"][0]["filters"]] == ["host", "dc"]


# -- the miner -------------------------------------------------------------

def _scores(side, path):
    return [(s.candidate, s.count, s.miss_count, s.score,
             s.miss_cost_ms) for s in side.miner.mine_shapes(str(path))]


def test_miner_oracle_on_a_written_log(tmp_path):
    """Same log bytes, and any line order of them, mine to the same
    ordered scores in both packages; torn, non-dict and untagged lines
    are skipped, the rotated generation is read."""
    cand_a = PORT.shapes.cq_candidate(tsq(PORT, "m.a"))
    cand_b = PORT.shapes.cq_candidate(tsq(PORT, "m.b"))
    lines = [json.dumps({"ts": i, "durationMs": 40.0 + i,
                         "cache": "miss" if i % 3 == 0 else "hit",
                         "cq": cand_a}) for i in range(12)]
    lines += [json.dumps({"ts": i, "durationMs": 5.0, "cache": "miss",
                          "cq": cand_b}) for i in range(5)]
    lines += ['{"torn": ', "[1, 2]", json.dumps({"durationMs": 3.0})]
    shuffled = list(lines)
    random.Random(7).shuffle(shuffled)
    (tmp_path / "a.jsonl").write_text("\n".join(lines) + "\n")
    (tmp_path / "b.jsonl").write_text("\n".join(shuffled) + "\n")
    (tmp_path / "b.jsonl.1").write_text(lines[0] + "\n")
    for name in ("a.jsonl", "b.jsonl"):
        got, want = both(lambda side: _scores(side, tmp_path / name))
        assert got == want
    assert _scores(PORT, tmp_path / "a.jsonl")[0][1] == 12
    assert _scores(PORT, tmp_path / "b.jsonl")[0][1] == 13
    assert PORT.miner.mine_shapes(str(tmp_path / "nope")) == []
    assert PORT.miner.mine_shapes("") == []


def test_miner_scores_either_package_s_log(made, tmp_path):
    """The shape log is interchangeable: each package's miner scores the
    log the other package wrote exactly as that package's miner does,
    and the two logs of one request stream agree on every candidate, its
    count and its misses (the durations, timing, aside)."""
    logs = {}
    for side in SIDES:
        # every pull a miss on both sides: a relative window's cache
        # entry reads the clock
        t = mk(made, side, tmp_path, **{"tsd.query.cache.enable": "false"})
        seed(t, "ctl.hot")
        seed(t, "ctl.cold")
        r = side.http.HttpRpcRouter(t)
        pull(side, r, "ctl.hot", 5)
        pull(side, r, "ctl.cold", 2)
        call(side, r, "GET", "/api/query", start="30m-ago",
             m="sum:1m-p95:ctl.hot")
        logs[side.name] = t.tracer.shape_path
    for path in logs.values():
        got, want = both(lambda side: _scores(side, path))
        assert got == want
    port_log, jax_log = (_scores(PORT, logs["port"]),
                         _scores(JAX, logs["jax"]))
    # the score's order reads the durations: compare as sets
    assert sorted((c, n, m) for c, n, m, _s, _c in port_log) == \
        sorted((c, n, m) for c, n, m, _s, _c in jax_log)
    assert sorted(n for _c, n, _m, _s, _x in port_log) == [2, 5]


# -- materialization ----------------------------------------------------------

def test_auto_materializes_and_serves(made, tmp_path):
    reports = []
    for side in SIDES:
        t = mk(made, side, tmp_path,
               **{"tsd.control.materialize.min_score": "0"})
        seed(t)
        r = side.http.HttpRpcRouter(t)
        pull(side, r, n=6)
        rep = t.control.tick()
        assert rep["errors"] == {}
        mats = json.loads(call(side, r, "GET",
                               "/api/control/materialized").body)
        before = t.streaming.serve_hits
        pull(side, r)
        assert t.streaming.serve_hits == before + 1
        reports.append((rep["materialize"],
                        [(m["id"], m["missCount"], m["coldScans"],
                          m["body"]) for m in mats]))
    assert reports[0] == reports[1]
    assert reports[0][0]["registered"] == 1


def test_auto_cq_bit_identical_to_hand_registered(made, tmp_path):
    """The port's auto continuous query answers the repeat pull byte for
    byte as a hand-registered one of the same body on an identically
    written TSD, and as the JAX package's auto query."""
    bodies = {}
    for side in SIDES:
        t_auto = mk(made, side, tmp_path / "a",
                    **{"tsd.control.materialize.min_score": "0"})
        t_hand = mk(made, side, tmp_path / "h")
        seed(t_auto)
        seed(t_hand)
        ra = side.http.HttpRpcRouter(t_auto)
        rh = side.http.HttpRpcRouter(t_hand)
        pull(side, ra, n=6)
        assert t_auto.control.tick()["materialize"]["registered"] == 1
        cand = side.shapes.cq_candidate(tsq(side))
        t_hand.streaming.register(dict(side.shapes.candidate_body(cand),
                                       id="hand1"))
        body_auto = pull(side, ra).body
        body_hand = pull(side, rh).body
        assert t_auto.streaming.serve_hits >= 1
        assert t_hand.streaming.serve_hits >= 1
        assert body_auto == body_hand
        bodies[side.name] = json.loads(body_auto)
    assert bodies["port"] == bodies["jax"]


def test_retirement_waits_for_hysteresis(made, tmp_path):
    import os
    for side in SIDES:
        t = mk(made, side, tmp_path, **{
            "tsd.control.materialize.min_score": "0",
            "tsd.control.materialize.hysteresis": "2"})
        seed(t)
        r = side.http.HttpRpcRouter(t)
        pull(side, r, n=6)
        t.control.tick()
        cid = json.loads(call(side, r, "GET",
                              "/api/control/materialized").body)[0]["id"]
        os.unlink(t.tracer.shape_path)
        t.control.tick()
        assert t.streaming.get(cid) is not None   # one cold scan
        t.control.tick()
        assert t.streaming.get(cid) is None       # the second retires
        assert json.loads(call(side, r, "GET",
                               "/api/control/materialized").body) == []
        assert t.control.retired_total == 1


def test_rejected_candidate_blacklisted_not_retried(made, tmp_path,
                                                    monkeypatch):
    for side in SIDES:
        t = mk(made, side, tmp_path,
               **{"tsd.control.materialize.min_score": "0"})
        seed(t)
        pull(side, side.http.HttpRpcRouter(t), n=6)
        from opentsdb_tpu.query.model import BadRequestError as JBad
        from opentsdb_tpu_torch.query.model import BadRequestError as TBad
        bad = TBad if side is PORT else JBad
        calls = []

        def reject(obj, now_ms=None, bad=bad, calls=calls):
            calls.append(obj)
            raise bad("not maintainable")

        monkeypatch.setattr(t.streaming, "register", reject)
        rep = t.control.tick()
        assert rep["errors"] == {}
        assert rep["materialize"]["registered"] == 0
        t.control.tick()
        assert len(calls) == 1
        assert t.control.describe()["materialize"]["blacklisted"] == 1


def test_cap_keeps_top_scorers_only(made, tmp_path):
    for side in SIDES:
        t = mk(made, side, tmp_path, **{
            "tsd.control.materialize.min_score": "0",
            "tsd.control.materialize.max": "1"})
        seed(t, "ctl.hot")
        seed(t, "ctl.cold")
        r = side.http.HttpRpcRouter(t)
        pull(side, r, "ctl.hot", 8)
        pull(side, r, "ctl.cold", 2)
        t.control.tick()
        mats = json.loads(call(side, r, "GET",
                               "/api/control/materialized").body)
        assert [m["body"]["queries"][0]["metric"] for m in mats] == \
            ["ctl.hot"]


# -- tenant QoS -------------------------------------------------------------------

def _gov(made, side, **extra):
    t = mk(made, side, **{"tsd.control.qos.enable": "true", **extra})
    return t, t.control.qos


def _sequence(g, now):
    """One call sequence of the reference's governor battery; every
    decision it takes."""
    out = []
    out.append(g.try_admit("noisy", 4, now_s=now))
    out.append(g.try_admit("victim", 4, now_s=now))
    g.started("noisy")
    g.started("noisy")
    out.append(g.try_admit("noisy", 4, now_s=now))
    out.append(g.try_admit("victim", 4, now_s=now))
    g.finished("noisy")
    out.append(g.try_admit("noisy", 4, now_s=now))
    for _ in range(3):
        out.append(g.try_admit("solo", 0, now_s=now))
    # an idle tenant leaves the fair-share split after its window
    out.append(g.try_admit("noisy", 4, now_s=now + 60))
    out.append(g.try_admit("gold", 4, now_s=now + 60))
    g.started("gold")
    out.append(g.try_admit("gold", 4, now_s=now + 60))
    for i in range(50):
        g.record("noisy", 10.0, errored=True, now_s=now + 61)
        g.record("victim", 2000.0, errored=i % 2 == 0, now_s=now + 61)
    out.append(g.refresh(now_s=now + 61))
    out.append(g.try_admit("noisy", 8, now_s=now + 61))
    out.append(g.try_admit("victim", 8, now_s=now + 61))
    doc = g.describe(now_s=now + 61)
    out.append(doc)
    return out


@pytest.mark.parametrize("keys", [
    {}, {"tsd.control.qos.weights": "gold:3,bronze:1"},
    {"tsd.control.qos.burn_penalty": "0.25"},
    {"tsd.control.qos.max_tenants": "2"}],
    ids=["default", "weights", "penalty", "overflow"])
def test_governor_decisions(made, keys):
    now = 1_700_000_000.0
    got, want = both(lambda side: _sequence(_gov(made, side, **keys)[1],
                                            now))
    assert got == want


def test_governor_cache_gate(made):
    def run(side):
        t, g = _gov(made, side, **{"tsd.control.qos.tenant_cache_mb": "1"})
        g.try_admit("a", 0)
        g.bind("a")
        out = [g.cache_gate(512 * 1024) for _ in range(3)]
        g.unbind()
        out.append(g.cache_gate(1 << 30))
        g.refresh()
        g.bind("a")
        out.append(g.cache_gate(512 * 1024))
        g.unbind()
        return out, g.cache_gate_rejects

    got, want = both(run)
    assert got == want == ([True, True, False, True, True], 1)


def test_gated_result_still_serves(made, tmp_path):
    """An over-budget tenant's results serve but are not kept."""
    for side in SIDES:
        t = mk(made, side, tmp_path, **{
            "tsd.control.qos.enable": "true",
            "tsd.control.qos.tenant_cache_mb": "1"})
        seed(t)
        g = t.control.qos
        cache = t.result_cache
        assert cache.insert_gate is not None
        g.try_admit("hog", 0)
        g.bind("hog")
        g._tenants["hog"].cache_bytes = g.cache_budget_bytes
        r = side.http.HttpRpcRouter(t)
        pull(side, r)
        assert cache.gated >= 1 and cache.total_entries == 0
        g.unbind()
        pull(side, r)
        assert cache.total_entries == 1


def test_fold_budget_gates_registration(made, tmp_path):
    answers = []
    for side in SIDES:
        t = mk(made, side, tmp_path, **{
            "tsd.control.qos.enable": "true",
            "tsd.control.qos.tenant_fold_mb": "1"})
        seed(t)
        t.control.qos.fold_budget_bytes = 100
        r = side.http.HttpRpcRouter(t)
        body = side.shapes.candidate_body(
            side.shapes.cq_candidate(tsq(side)))
        hog = {"x-tsd-tenant": "hog"}
        out = [call(side, r, "POST", "/api/query/continuous", body,
                    headers=hog).status]
        resp = call(side, r, "POST", "/api/query/continuous",
                    dict(body, id="second"), headers=hog)
        out.append((resp.status, resp.body))
        out.append(call(side, r, "POST", "/api/query/continuous",
                        dict(body, id="third"),
                        headers={"x-tsd-tenant": "calm"}).status)
        out.append(t.streaming.projected_fold_bytes(body))
        out.append(t.streaming.tenant_fold_bytes("hog") > 0)
        out.append(t.control.qos.fold_budget_rejects)
        answers.append(out)
    assert answers[0] == answers[1]
    assert answers[0][0] == 200 and answers[0][1][0] == 400


def test_stats_surface_tenant_attribution(made):
    docs = []
    for side in SIDES:
        t, g = _gov(made, side)
        g.try_admit("a", 1, now_s=_NOW[0])
        g.started("a")
        g.try_admit("b", 1, now_s=_NOW[0])
        rows = sorted((n, v, tuple(sorted(tags.items())))
                      for n, v, tags in t.stats.collect().records
                      if n.startswith("tsd.control."))
        doc = json.loads(call(side, side.http.HttpRpcRouter(t), "GET",
                              "/api/stats/tenants").body)
        for tenant in doc["tenants"].values():
            tenant.pop("activeAgeS")
        docs.append((rows, doc))
    assert docs[0] == docs[1]


def test_noisy_tenant_sheds_victim_serves(made):
    """Over real sockets: 10 noisy clients and the victim at once against
    ``max_inflight=8``; the noisy tenant absorbs structured tenant sheds
    with ``Retry-After``, the victim none."""
    import http.client
    t = mk(made, PORT, **{"tsd.control.qos.enable": "true",
                          "tsd.query.admission.max_inflight": "8",
                          "tsd.query.admission.retry_after_s": "2"})
    assert t.control is not None
    t.add_point("nt.m", _NOW[0] - 60, 1.0, {"host": "a"})
    srv = PORT.server.ServerThread(t, port=0).start()
    path = "/api/query?start=1h-ago&m=sum:nt.m"

    def fetch(tenant):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=30)
        conn.request("GET", path, headers={"X-TSD-Tenant": tenant})
        resp = conn.getresponse()
        out = (resp.status, resp.getheader("Retry-After"), resp.read())
        conn.close()
        return out

    try:
        assert fetch("victim")[0] == 200
        orig = srv.server.http_router.handle

        def slow_handle(request):
            if "query" in request.path:
                time.sleep(0.4)
            return orig(request)

        srv.server.http_router.handle = slow_handle
        results: dict = {}

        def run(i, tenant):
            results[i] = fetch(tenant)

        threads = [threading.Thread(target=run, args=(i, "noisy"))
                   for i in range(10)]
        threads.append(threading.Thread(target=run, args=(10, "victim")))
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        victim = results[10]
        noisy = [results[i] for i in range(10)]
        assert victim[0] == 200, victim
        sheds = [(ra, json.loads(b)["error"]) for s, ra, b in noisy
                 if s == 503]
        tenant_sheds = [(ra, e) for ra, e in sheds
                        if "shed cause: tenant" in e["details"]]
        assert tenant_sheds
        for ra, err in tenant_sheds:
            assert ra == "2"
            assert "fair in-flight share" in err["message"]
        doc = t.control.qos.describe()
        assert doc["tenants"]["noisy"]["shed"] == len(tenant_sheds)
        assert doc["tenants"]["victim"]["shed"] == 0
        tenants = json.loads(call(PORT, srv.server.http_router, "GET",
                                  "/api/stats/tenants").body)
        assert tenants["tenants"]["victim"]["shed"] == 0
    finally:
        srv.stop()


# -- placement ---------------------------------------------------------------------

def test_standalone_placement(made):
    answers = []
    for side in SIDES:
        t = mk(made, side)
        r = side.http.HttpRpcRouter(t)
        out = [json.loads(call(side, r, "GET", "/api/control/plan").body)]
        for body in ({"planId": "abc"}, {}):
            resp = call(side, r, "POST", "/api/control/plan", body)
            out.append((resp.status, resp.body))
        out.append(call(side, r, "DELETE", "/api/control/plan").status)
        out.append(t.control.tick()["errors"])
        out.append(t.control.describe()["placement"])
        answers.append(out)
    assert answers[0] == answers[1]
    assert answers[0][0]["proposal"] is None
    assert answers[0][1][0] == 400


def _router(made, side, tmp_path, **keys):
    """A control-plane router over three unreachable shards, with a
    spool dir (ref: ``_router_tsdb``)."""
    t = mk(made, side, **{
        "tsd.cluster.role": "router",
        "tsd.cluster.peers": "p0=127.0.0.1:1,p1=127.0.0.1:2,p2=127.0.0.1:3",
        "tsd.cluster.spool.dir": str(tmp_path / side.name / "spool"),
        **keys})
    t.cluster.peers["p0"].forwarded_points = 8000
    t.cluster.peers["p1"].forwarded_points = 100
    t.cluster.peers["p2"].forwarded_points = 100
    return t


def _reshard_doc(doc):
    return {k: v for k, v in doc.items() if k != "fence_ms"}


def test_confirm_executes_stale_id_rejected(made, tmp_path):
    """(ref: ``TestPlacement.test_confirm_executes_stale_id_rejected``)
    a stale planId answers 400 and opens nothing; the standing id runs
    the router's reshard, at the plan's vnodes, on both packages."""
    answers = []
    for side in SIDES:
        t = _router(made, side, tmp_path)
        t.control.tick()
        r = side.http.HttpRpcRouter(t)
        stale = call(side, r, "POST", "/api/control/plan",
                     {"planId": "deadbeef"})
        active0 = t.cluster.state.active
        plan = json.loads(call(side, r, "GET", "/api/control/plan").body)
        resp = call(side, r, "POST", "/api/control/plan",
                    {"planId": plan["planId"]})
        answers.append((stale.status, stale.body, active0, resp.status,
                        _reshard_doc(json.loads(resp.body)),
                        t.cluster.state.active,
                        t.cluster.ring.vnodes == plan["proposal"]["vnodes"],
                        t.control.plan_info()["appliedPlanId"]
                        == plan["planId"]))
    assert answers[0] == answers[1]
    assert answers[0][0] == 400 and answers[0][2] is False
    assert answers[0][3] == 200 and answers[0][5] is True
    assert answers[0][6] and answers[0][7]


def test_auto_opt_in_applies_own_plan(made, tmp_path):
    """(ref: ``TestPlacement.test_auto_opt_in_applies_own_plan``) with
    ``tsd.control.placement.auto=true`` a tick applies the plane's own
    plan, and a second tick stacks no reshard on the open window."""
    answers = []
    for side in SIDES:
        t = _router(made, side, tmp_path,
                    **{"tsd.control.placement.auto": "true"})
        rep = t.control.tick()
        applied = rep["placement"].get("applied")
        rep2 = t.control.tick()
        answers.append((rep["errors"], _reshard_doc(applied),
                        t.cluster.state.active, rep2["errors"],
                        rep2["placement"].get("deferred"),
                        t.cluster.epoch, t.control.plans_applied))
    assert answers[0] == answers[1]
    assert answers[0][0] == {} and answers[0][2] is True
    assert answers[0][3] == {}
    assert answers[0][4] == "reshard in progress"
    assert answers[0][5] == 1 and answers[0][6] == 1


# -- chaos ------------------------------------------------------------------------

SITES = ["control.materialize", "control.qos", "control.placement"]


@pytest.mark.parametrize("site", SITES)
def test_armed_site_parks_loop_not_data_plane(made, tmp_path, site):
    answers = []
    for side in SIDES:
        t = mk(made, side, tmp_path, **{
            "tsd.control.qos.enable": "true",
            "tsd.control.materialize.min_score": "0"})
        seed(t)
        r = side.http.HttpRpcRouter(t)
        pull(side, r, n=3)
        t.faults.arm(site, error_count=100)
        rep = t.control.tick()
        out = [sorted(rep["errors"])]
        for _ in range(3):
            out.append(t.control.tick().get("skipped"))
        health = json.loads(call(side, r, "GET", "/api/health").body)
        out.append((health["control"]["tickErrors"],
                    health["control"]["breaker"], health["causes"]))
        resp = call(side, r, "POST", "/api/put",
                    {"metric": "ctl.cpu", "timestamp": _NOW[0],
                     "value": 1.0, "tags": {"host": "z"}})
        out.append(resp.status)
        out.append(pull(side, r).status)
        out.append(call(side, r, "GET", "/api/stats").status)
        answers.append(out)
    assert answers[0] == answers[1]
    assert answers[0][0] == [site.split(".", 1)[1]]


def test_killed_control_thread_leaves_data_plane(made, tmp_path):
    for side in SIDES:
        t = mk(made, side, tmp_path, **{"tsd.control.qos.enable": "true"})
        seed(t)
        t.control.start()
        t.control.stop()
        r = side.http.HttpRpcRouter(t)
        assert call(side, r, "POST", "/api/put",
                    {"metric": "ctl.cpu", "timestamp": _NOW[0], "value": 1.0,
                     "tags": {"host": "z"}}).status in (200, 204)
        assert pull(side, r).status == 200
        assert t.control.qos.try_admit("a", 2) is None


def test_breaker_gates_ticks_and_recovers(made):
    answers = []
    for side in SIDES:
        t = mk(made, side, **{
            "tsd.control.breaker.failure_threshold": "2",
            "tsd.control.breaker.reset_timeout_ms": "60000",
            "tsd.control.qos.enable": "true"})
        t.faults.arm("control.qos", error_count=2)
        out = [sorted(t.control.tick()["errors"]) for _ in range(2)]
        out.append(t.control.breaker.state)
        out.append(t.control.tick().get("skipped"))
        t.control.breaker.reset_timeout_ms = 0
        out.append(t.control.tick()["errors"])
        out.append(t.control.breaker.state)
        answers.append(out)
    assert answers[0] == answers[1]
    assert answers[0][2] == "open" and answers[0][3] == "breaker open"
    assert answers[0][-1] == "closed"


def test_disabled_control_is_inert(made):
    for side in SIDES:
        t = tsdb(side)
        made.append(t)
        assert t.control is None
        r = side.http.HttpRpcRouter(t)
        assert call(side, r, "GET", "/api/control").status == 400
        health = json.loads(call(side, r, "GET", "/api/health").body)
        assert health["control"] == {"enabled": False}
        assert not [th for th in threading.enumerate()
                    if th.name == "tsd-control"]


def test_loop_ticks_under_traffic_and_stops_clean(made, tmp_path):
    t = mk(made, PORT, tmp_path, **{
        "tsd.control.qos.enable": "true",
        "tsd.control.materialize.min_score": "0",
        "tsd.control.interval_s": "0.05"})
    seed(t)
    r = PORT.http.HttpRpcRouter(t)
    t.control.start()
    stop = threading.Event()
    errs = []

    def pound():
        g = t.control.qos
        while not stop.is_set():
            try:
                if g.try_admit("x", 4) is None:
                    g.started("x")
                    pull(PORT, r)
                    g.finished("x")
            except Exception as exc:  # noqa: BLE001 - reported below
                errs.append(exc)
                return

    threads = [threading.Thread(target=pound) for _ in range(3)]
    for th in threads:
        th.start()
    time.sleep(0.5)
    stop.set()
    for th in threads:
        th.join(5)
    assert not errs
    assert t.control.ticks >= 2
    rows = [row for row in t.tracer.recent(limit=200)
            if row["name"] == "control.loop"]
    assert rows
    t.control.stop()
    assert not [th for th in threading.enumerate()
                if th.name == "tsd-control"]
