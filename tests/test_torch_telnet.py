"""The port's telnet router against the JAX package's: the same ``put``
lines into both, then the same error lines and the same query answers
(through each package's HTTP router, compared as in
``test_torch_http.py``)."""

import pytest

from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu.tsd.telnet import TelnetRouter as JTelnet
from opentsdb_tpu_torch.tsd.http_api import HttpRpcRouter
from opentsdb_tpu_torch.tsd.telnet import (TelnetCloseConnection,
                                           TelnetRouter,
                                           TelnetServerShutdown)
from test_torch_http import close_pair, compare, make_pair, send_both
from torch_pair import ENGINE_KEYS, GRID_ON, T0

GOOD = [f"put tel.m {T0 + 60 * j} {i * 10 + j} host=h{i} dc=d{i % 2}"
        for i in range(4) for j in range(30)]
BAD = [
    "put",
    f"put tel.m {T0} 1",
    f"put tel.m abc 1 host=a",
    f"put tel.m {T0} 1_0 host=a",
    f"put tel.m {T0} 1.5.2 host=a",
    f"put tel.m {T0} hosta host=a",
    f"put tel.m {T0} 1 hosta",
    f"put tel.m {T0} 1 host=a=b",
    f"put tel.m {T0} 1 host=",
    f"put bad! {T0} 1 host=a",
    f"put tel.m -5 1 host=a",
    f"put tel.m 0 1 host=a",
    f"put tel.m {2**48} 1 host=a",
    f"put tel.m {T0} 1 " + " ".join(f"k{i}=v" for i in range(9)),
    f"put tel.m {T0} 1 bad!=v",
]
SPECIAL = [f"put tel.s {T0 + 60} nan host=a",
           f"put tel.s {T0 + 120} -inf host=a",
           f"put tel.s {(T0 + 180) * 1000 + 250} 2.5 host=a",
           f"put tel.s {T0 + 240} 7 host=a host=a"]


@pytest.fixture(params=["engine", "grid"])
def pair(request):
    keys = {"engine": ENGINE_KEYS, "grid": GRID_ON}[request.param]
    jt, tt = make_pair(keys, {})
    yield jt, tt
    close_pair(jt, tt)


def _query_both(jt, tt, m: str):
    got, want = send_both(JRouter(jt), HttpRpcRouter(tt), "GET",
                          "/api/query", start=T0 - 1, end=T0 + 3600,
                          m=m, ms="true")
    compare("query", got, want, {})


@pytest.mark.parametrize("order", ["good-then-bad", "interleaved",
                                   "one-by-one"])
def test_put_lines(pair, order):
    jt, tt = pair
    jr, pr = JTelnet(jt), TelnetRouter(tt)
    if order == "good-then-bad":
        bursts = [GOOD + BAD + SPECIAL]
    elif order == "interleaved":
        mixed = [x for pair_ in zip(GOOD, BAD + SPECIAL + GOOD)
                 for x in pair_]
        bursts = [mixed]
    else:
        bursts = [[line] for line in GOOD[:10] + BAD + SPECIAL]
    for lines in bursts:
        want, wexc = jr.execute_lines(lines)
        got, gexc = pr.execute_lines(lines)
        assert got == want
        assert gexc is None and wexc is None
        assert len(got) == sum(line in BAD for line in lines)
    for m in ("none:tel.m{host=*}", "sum:5m-avg:tel.m{dc=*}",
              "sum:tel.s{host=*}"):
        _query_both(jt, tt, m)


def test_put_line_by_line_matches_burst(pair):
    """The scalar ``put`` and the batched ``put_lines`` answer the same
    error text for every bad line."""
    _, tt = pair
    router = TelnetRouter(tt)
    burst = router.put_lines(BAD)
    single = [router.execute(line) for line in BAD]
    assert burst == single and all(single)


def test_uid_order_of_a_mixed_burst(pair):
    """ROADMAP Queue 3: in one burst, a line the reference's columnar
    parser hands back to its scalar ``put`` (a ``nan`` value) and a
    plain line, each naming a new tag value. The reference assigns the
    plain line's UID first (``import_buffer`` resolves its parsed lines,
    then the scalar replay runs), so its group-by answer lists ``y``
    before ``x``; the port assigns UIDs in line order, as a client
    sending one line at a time sees on both."""
    jt, tt = pair
    lines = [f"put tel.o {T0} nan host=x", f"put tel.o {T0} 1 host=y"]
    assert JTelnet(jt).execute_lines(lines) == ([], None)
    assert TelnetRouter(tt).execute_lines(lines) == ([], None)
    order = {name: sorted("xy", key=t.uids.tag_values.get_id)
             for name, t in (("reference", jt), ("port", tt))}
    assert order == {"reference": ["y", "x"], "port": ["x", "y"]}
    jt2, tt2 = make_pair(ENGINE_KEYS, {})
    try:
        for line in lines:
            assert JTelnet(jt2).execute(line) == ""
        assert sorted("xy", key=jt2.uids.tag_values.get_id) == ["x", "y"]
    finally:
        close_pair(jt2, tt2)


def test_commands(pair):
    jt, tt = pair
    jr, pr = JTelnet(jt), TelnetRouter(tt)
    for line in ("help", "dropcaches", "nope arg", ""):
        assert pr.execute(line) == jr.execute(line), line
    # version and stats describe each package
    assert pr.execute("version").startswith(
        "opentsdb_tpu_torch version [")
    jt.add_point("tel.m", T0, 1, {"host": "a"})
    tt.add_point("tel.m", T0, 1, {"host": "a"})
    names = {ln.split()[0] for ln in jr.execute("stats").splitlines()}
    got = pr.execute("stats").splitlines()
    assert got and {ln.split()[0] for ln in got} <= names
    with pytest.raises(TelnetCloseConnection):
        pr.execute("exit")
    with pytest.raises(TelnetServerShutdown):
        pr.execute("diediedie")
    resp, exc = pr.execute_lines(["put", "exit", "put"])
    assert isinstance(exc, TelnetCloseConnection) and len(resp) == 1


@pytest.mark.parametrize("cmd", ["rollup"])
def test_unported_commands(pair, cmd):
    """``rollup`` was the last unported command: with rollups off it
    answers the reference's error line."""
    jt, tt = pair
    line = f"{cmd} 1m:sum m {T0} 1 host=a"
    got = TelnetRouter(tt).execute(line)
    assert got == JTelnet(jt).execute(line) == (
        "rollup: RuntimeError: rollups are not enabled "
        "(tsd.rollups.enable=false)")


def test_read_only_has_no_put():
    from opentsdb_tpu_torch import TSDB, Config
    t = TSDB(Config(**{"tsd.torch.device": "cpu", "tsd.mode": "ro"}))
    assert TelnetRouter(t).execute(f"put m {T0} 1 h=a") == \
        "error: unknown command: put"


# -- rollup lines ----------------------------------------------------------

GOOD_ROLLUP = (
    [f"rollup 1m:{agg} roll.m {T0 + 60 * j} {v} host=h{i}"
     for i in range(2) for j in range(10)
     for agg, v in (("sum", 60 * j + i), ("count", 60))]
    + [f"rollup 1h:MAX roll.m {T0} 7.5 host=h0",
       f"rollup sum roll.m {T0} 5 dc=x",
       f"rollup 1m:sum:max roll.m {T0 + 60} 6 dc=x",
       f"rollup 1m:sum roll.m {T0 + 120} nan host=h1"])
BAD_ROLLUP = [
    "rollup",
    f"rollup 1m:sum roll.m {T0} 1",
    f"rollup 9m:sum roll.m {T0} 1 host=a",
    f"rollup 1m:p99 roll.m {T0} 1 host=a",
    f"rollup 1m:sum roll.m abc 1 host=a",
    f"rollup 1m:sum roll.m {T0} 1_0 host=a",
    f"rollup 1m:sum roll.m {T0} x host=a",
    f"rollup 1m:sum bad! {T0} 1 host=a",
    f"rollup 1m:sum roll.m {T0} 1 hosta",
    f"rollup 1m:sum roll.m {T0} 1 host=a=b",
]


@pytest.fixture(params=["engine", "grid"])
def rollup_pair(request):
    keys = {"engine": ENGINE_KEYS, "grid": GRID_ON}[request.param]
    jt, tt = make_pair({**keys, "tsd.rollups.enable": "true"}, {})
    yield jt, tt
    close_pair(jt, tt)


def test_rollup_lines(rollup_pair):
    """Each ``rollup`` line answers what the reference answers (silent
    on success), by line and by burst, and the tiers read back alike."""
    jt, tt = rollup_pair
    jr, pr = JTelnet(jt), TelnetRouter(tt)
    lines = GOOD_ROLLUP + BAD_ROLLUP
    want = [jr.execute(ln) for ln in lines]
    assert [pr.execute(ln) for ln in lines] == want
    assert not any(want[:len(GOOD_ROLLUP)])
    assert all(want[len(GOOD_ROLLUP):])
    resp, exc = pr.execute_lines(lines)
    assert exc is None and resp == [w for w in want if w]
    for m in ("sum:1m-sum:roll.m{host=*}", "sum:2m-avg:roll.m{host=*}",
              "max:1h-max:roll.m", "sum:1m-count:roll.m"):
        _query_both(jt, tt, m)
