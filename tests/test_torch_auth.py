"""The port's authentication (``opentsdb_tpu_torch/auth/simple.py``,
the server's first exchange, the routers' permissions) against the JAX
package's, on the CPU.

- The 14 cases of ``tests/test_stats_auth_fsck.py``'s ``TestAuth`` and
  ``TestRoleAuthorization``, each run on both packages (the
  authenticator, the HTTP router's 403s, the telnet router's denials),
  each also asserting what that file asserts.
- Every route under the permission the reference's router gives it:
  each ``/api/query`` endpoint (the continuous queries, ``/exp`` and
  ``/gexp`` included) under HTTP_QUERY, equal to the reference. The
  port also asks HTTP_PUT of ``/api/rollup`` and ``/api/histogram``,
  where the JAX package asks nothing (ROADMAP Queue 3: the Java
  reference's RollupDataPointRpc and HistogramDataPointRpc extend
  PutDataPointRpc).
- A running server with ``tsd.core.authentication.enable``: HTTP Basic
  (401 with the reference's body and ``WWW-Authenticate`` before any
  handler; a CORS preflight passes without credentials; the state rides
  ``request.auth``), and telnet's first exchange (``auth_fail``,
  ``auth_success``, then the state gates ``put``).

Tolerance: none; statuses, bodies and lines compare exactly.
"""

import base64
import hashlib
import http.client
import json
import socket

import pytest

from torch_meta_pair import JAX, T0, both, call, tsdb

from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.tsd.server import ServerThread


def sha(pw: str) -> str:
    return hashlib.sha256(pw.encode()).hexdigest()


USERS = {"tsd.core.authentication.users":
         f"reader:{sha('r')}:ro,writer:{sha('w')}:rw,"
         f"admin:{sha('a')}:root,norole:{sha('n')}",
         "tsd.core.authentication.roles":
         "ro:http_query,rw:http_query|http_put|telnet_put,root:all"}
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _auth(side, **keys):
    return side.auth.SimpleAuthentication(side.Config(**keys))


def _state(s) -> tuple:
    return (s.status.name, s.user, s.message, sorted(s.roles),
            sorted(p.name for p in s.permissions), s.token is not None)


# -- TestAuth -----------------------------------------------------------------

@case
def allow_all_when_no_users(side):
    state = _auth(side).authenticate("whoever", "whatever")
    assert state.status.name == "SUCCESS"
    assert state.has_permission(side.auth.Permissions.HTTP_QUERY)
    return _state(state)


@case
def password_check(side):
    auth = _auth(side, **{"tsd.core.authentication.users":
                          f"admin:{sha('secret')}"})
    out = [_state(auth.authenticate(u, p)) for u, p in (
        ("admin", "secret"), ("admin", "wrong"), ("nosuch", "x"))]
    assert [o[0] for o in out] == ["SUCCESS", "UNAUTHORIZED",
                                   "UNAUTHORIZED"]
    return out


@case
def success_has_token_and_permissions(side):
    auth = _auth(side, **{"tsd.core.authentication.users":
                          f"admin:{sha('s')}"})
    ok, denied = auth.authenticate("admin", "s"), \
        auth.authenticate("admin", "no")
    perm = side.auth.Permissions.TELNET_PUT
    assert ok.token is not None and ok.has_permission(perm)
    assert not denied.has_permission(perm)
    return _state(ok), _state(denied)


@case
def telnet_command_form(side):
    auth = _auth(side, **{"tsd.core.authentication.users":
                          f"bob:{sha('pw')}"})
    out = [_state(auth.authenticate_telnet(w))
           for w in (["auth", "bob", "pw"], ["auth"])]
    assert [o[0] for o in out] == ["SUCCESS", "ERROR"]
    return out


@case
def http_basic_header(side):
    auth = _auth(side, **{"tsd.core.authentication.users":
                          f"bob:{sha('pw')}"})
    tok = base64.b64encode(b"bob:pw").decode()
    out = [_state(auth.authenticate_http(h)) for h in (
        {"authorization": f"Basic {tok}"}, {},
        {"authorization": "Bearer zzz"},
        {"authorization": "Basic $$$not-b64$$$"})]
    assert [o[0] for o in out] == ["SUCCESS", "UNAUTHORIZED",
                                   "UNAUTHORIZED", "ERROR"]
    return out


# -- TestRoleAuthorization ----------------------------------------------------

@case
def full_reference_permission_set(side):
    out = sorted(p.name for p in side.auth.Permissions)
    assert out == ["CREATE_METRIC", "CREATE_TAGK", "CREATE_TAGV",
                   "HTTP_PUT", "HTTP_QUERY", "TELNET_PUT"]
    return out


@case
def role_grants(side):
    auth = _auth(side, **USERS)
    out = [_state(auth.authenticate(u, p))
           for u, p in (("reader", "r"), ("writer", "w"), ("admin", "a"))]
    assert out[0][4] == ["HTTP_QUERY"] and len(out[2][4]) == 6
    return out


@case
def user_without_roles_has_none(side):
    state = _auth(side, **USERS).authenticate("norole", "n")
    assert state.status.name == "SUCCESS" and not state.permissions
    return _state(state)


def _authed(side):
    t = tsdb(side)
    t.authentication = _auth(side, **USERS)
    return t


def _as(t, user, pw):
    return t.authentication.authenticate(user, pw)


PUT = [{"metric": "m", "timestamp": T0, "value": 1, "tags": {"h": "a"}}]


@case
def http_put_403_for_reader(side):
    t = _authed(side)
    out = [call(side, t, "POST", "/api/put", body=PUT, auth=_as(t, u, p))
           for u, p in (("reader", "r"), ("writer", "w"))]
    assert [o[0] for o in out] == [403, 204]
    return out


@case
def http_query_403_without_grant(side):
    t = _authed(side)
    t.add_point("m", T0, 1, {"h": "a"})
    params = {"start": str(T0 - 100), "m": "sum:m"}
    out = [call(side, t, "GET", "/api/query", params, auth=_as(t, u, p))
           for u, p in (("norole", "n"), ("reader", "r"))]
    assert [o[0] for o in out] == [403, 200]
    return out


@case
def uid_assign_403_without_create(side):
    t = _authed(side)
    out = [call(side, t, "POST", "/api/uid/assign",
                body={"metric": ["new.metric"]}, auth=_as(t, u, p))
           for u, p in (("writer", "w"), ("admin", "a"))]
    assert [o[0] for o in out] == [403, 200]
    return out


@case
def uid_assign_checks_all_kinds_before_committing(side):
    t = _authed(side)
    t.authentication._role_grants["rw"] = frozenset(
        t.authentication._role_grants["rw"]
        | {side.auth.Permissions.CREATE_METRIC})
    out = call(side, t, "POST", "/api/uid/assign",
               body={"metric": ["brand.new"], "tagk": ["brand_tag"]},
               auth=_as(t, "writer", "w"))
    assert out[0] == 403 and not t.uids.metrics.has_name("brand.new")
    return out


@case
def telnet_put_gated(side):
    t = _authed(side)
    telnet = side.telnet.TelnetRouter(t, None) if side is JAX \
        else side.telnet.TelnetRouter(t)
    reader, writer = _as(t, "reader", "r"), _as(t, "writer", "w")
    out = [telnet.execute(f"put m {T0} 1 h=a", auth=reader),
           telnet.execute(f"put m {T0} 1 h=a", auth=writer),
           telnet.execute(f"rollup 1m:sum m {T0} 1 h=a", auth=reader),
           telnet.execute_lines([f"put m {T0 + k} 1 h=a" for k in range(3)],
                                auth=reader)[0],
           "version" in telnet.execute("version", auth=reader),
           t.datapoints_added]
    assert "permission denied" in out[0] and out[1] == "" and out[4]
    return out


@case
def bad_role_permission_name_fails_fast(side):
    with pytest.raises(ValueError, match="not_a_perm") as e:
        _auth(side, **{"tsd.core.authentication.roles": "r:not_a_perm"})
    return str(e.value)


def test_every_reference_case_is_here():
    assert len(CASES) == 14


@pytest.mark.parametrize("name", list(CASES))
def test_auth_case_equals_reference(name):
    got, want = both(CASES[name])
    assert got == want


# -- every route under its permission -----------------------------------------

QUERY_ROUTES = [
    ("GET", "/api/query", {"start": str(T0), "m": "sum:m"}, b""),
    ("GET", "/api/query/last", {"timeseries": "m{h=a}"}, b""),
    ("POST", "/api/query/continuous", {}, {"start": str(T0), "queries": [
        {"aggregator": "sum", "metric": "m", "downsample": "1m-sum"}]}),
    ("GET", "/api/query/continuous", {}, b""),
    ("GET", "/api/query/continuous/x/stream", {}, b""),
    ("GET", "/api/query/exp", {"start": str(T0), "m": "sum:m"}, b""),
    ("GET", "/api/query/gexp", {"start": str(T0),
                                "exp": "scale(sum:m,2)"}, b""),
]


@pytest.mark.parametrize("route", QUERY_ROUTES,
                         ids=[f"{m}-{p}" for m, p, _q, _b in QUERY_ROUTES])
def test_query_routes_need_http_query(route):
    method, path, params, body = route

    def scenario(side):
        t = _authed(side)
        t.add_point("m", T0, 1, {"h": "a"})
        return call(side, t, method, path, params, body,
                    auth=_as(t, "norole", "n"))

    got, want = both(scenario)
    assert got == want and got[0] == 403
    assert got[1]["error"]["details"] == "HTTP_QUERY is not granted"


@pytest.mark.parametrize("path", ["/api/rollup", "/api/histogram"])
def test_rollup_and_histogram_need_http_put(path):
    """ROADMAP Queue 3: the port asks HTTP_PUT of these writes; the JAX
    package's router asks nothing and lets a reader write."""
    def scenario(side):
        t = tsdb(side, **{"tsd.rollups.enable": "true"})
        t.authentication = _auth(side, **USERS)
        return call(side, t, "POST", path, body=[],
                    auth=_as(t, "reader", "r"))[0]

    got, want = both(scenario)
    assert got == 403 and want != 403


# -- a running server ---------------------------------------------------------

def _basic(user, pw) -> dict:
    return {"Authorization": "Basic " + base64.b64encode(
        f"{user}:{pw}".encode()).decode()}


def _http(st, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", st.port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _telnet(st, text: str, lines: int) -> list[str]:
    """Send ``text`` and read until ``lines`` answer lines came: before
    its ``auth`` succeeds every line of a connection, ``exit`` too, is
    answered ``auth_fail``, and the connection stays open."""
    with socket.create_connection(("127.0.0.1", st.port), 30) as s:
        s.sendall(text.encode())
        out = b""
        while out.count(b"\n") < lines:
            chunk = s.recv(65536)
            if not chunk:
                break
            out += chunk
    return out.decode().splitlines()


@pytest.fixture
def server():
    st = ServerThread(TSDB(Config(**{
        "tsd.torch.device": "cpu", "tsd.core.auto_create_metrics": "true",
        "tsd.core.authentication.enable": "true",
        "tsd.http.request.cors_domains": "*", **USERS}))).start()
    yield st
    st.stop()


def test_http_basic_on_a_running_server(server):
    put = json.dumps(PUT).encode()
    status, headers, body = _http(server, "GET", "/api/version")
    assert status == 401
    assert headers["WWW-Authenticate"] == 'Basic realm="opentsdb"'
    assert body == b'{"error":{"code":401,"message":' \
        b'"Authentication required"}}'
    assert _http(server, "GET", "/api/version",
                 headers=_basic("reader", "x"))[0] == 401
    assert _http(server, "POST", "/api/put", put,
                 _basic("reader", "r"))[0] == 403
    assert _http(server, "POST", "/api/put", put,
                 _basic("writer", "w"))[0] == 204
    status, _, body = _http(server, "GET",
                            f"/api/query?start={T0}&m=sum:m",
                            headers=_basic("reader", "r"))
    assert status == 200 and json.loads(body)[0]["dps"] == {str(T0): 1}
    # a CORS preflight carries no credentials and is not refused
    status, headers, _ = _http(server, "OPTIONS", "/api/put",
                               headers={"Origin": "http://x"})
    assert status == 200 and "Access-Control-Allow-Methods" in headers


def test_telnet_first_exchange_on_a_running_server(server):
    assert _telnet(server, f"put m {T0} 1 h=a\nexit\n", 2) == \
        ["auth_fail", "auth_fail"]
    assert _telnet(server, "auth reader x\nauth reader r\n"
                   f"put m {T0} 1 h=a\nexit\n", 3) == [
        "auth_fail", "auth_success",
        "put: permission denied (TELNET_PUT not granted)"]
    out = _telnet(server, f"auth writer w\nput m {T0} 2 h=a\n"
                  f"put m {T0 + 1} 3 h=a\nversion\nexit\n", 2)
    assert out[0] == "auth_success" and "version" in out[1]
    assert server.server.tsdb.datapoints_added == 2
    # the reference's router answers the same lines for the same states
    j = tsdb(JAX)
    j.authentication = _auth(JAX, **USERS)
    jt = JAX.telnet.TelnetRouter(j, None)
    assert jt.execute(f"put m {T0} 1 h=a",
                      auth=_as(j, "reader", "r")) == \
        "put: permission denied (TELNET_PUT not granted)"
