"""The port's TSD server over real sockets on 127.0.0.1, port 0: HTTP
and telnet sniffed on one port, keep-alive, chunked request bodies and
streamed responses, load shedding (503 + Retry-After), the query
timeout (504), gzip, CORS, the idle reaper, and a clean stop that
leaves no worker thread behind. Every server is stopped in a fixture
finalizer, so a failing test leaves no ``tsd-query``/``tsd-subq``
thread for the test files after it. The thread checks count only the
threads started since the fixture began: other test files of the same
process may leave pools of their own alive."""

import gzip
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.tsd.server import ServerThread

ROOT = Path(__file__).resolve().parent.parent
T0 = 1356998400
POOLS = ("tsd-query", "tsd-subq", "tsd-http", "tsd-server")


def _pool_threads(baseline: set) -> list[str]:
    """Names of the live pool threads that are not in ``baseline``."""
    return [t.name for t in threading.enumerate()
            if t.name.startswith(POOLS) and t not in baseline]


@pytest.fixture
def serve():
    """Factory: a started server over a fresh CPU TSDB with ``keys``;
    every server is stopped (and its threads joined) at teardown, and no
    pool thread started since the fixture began may be left.
    ``serve.baseline`` is the set of threads alive before it."""
    started = []
    baseline = set(threading.enumerate())

    def make(**keys) -> ServerThread:
        tsdb = TSDB(Config(**{"tsd.torch.device": "cpu",
                              "tsd.core.auto_create_metrics": "true",
                              **keys}))
        st = ServerThread(tsdb).start()
        started.append(st)
        return st

    make.baseline = baseline
    yield make
    for st in started:
        st.stop()
    assert not _pool_threads(baseline)


def _http(st, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", st.port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _telnet(st, text: str, wait_close: bool = True) -> bytes:
    with socket.create_connection(("127.0.0.1", st.port), 30) as s:
        s.sendall(text.encode())
        out = b""
        if wait_close:
            while chunk := s.recv(65536):
                out += chunk
        return out


def _put_body(n: int, metric: str = "srv.m") -> bytes:
    return json.dumps([{"metric": metric, "timestamp": T0 + 60 * i,
                        "value": i, "tags": {"host": f"h{i % 3}"}}
                       for i in range(n)]).encode()


def test_http_and_telnet_on_one_port(serve):
    st = serve()
    status, _, body = _http(st, "GET", "/api/version")
    assert status == 200 and json.loads(body)["repo"] == \
        "opentsdb_tpu_torch"
    out = _telnet(st, f"put tel.m {T0} 5 host=a\nput bad\nversion\n"
                  "exit\n")
    lines = out.decode().splitlines()
    assert lines[0].startswith("put: illegal argument")
    assert lines[1].startswith("opentsdb_tpu_torch version [")
    status, _, body = _http(
        st, "GET", f"/api/query?start={T0}&m=sum:tel.m{{host=*}}")
    assert status == 200
    assert json.loads(body)[0]["dps"] == {str(T0): 5}


def test_keep_alive_and_put(serve):
    st = serve()
    conn = http.client.HTTPConnection("127.0.0.1", st.port, timeout=30)
    try:
        conn.request("POST", "/api/put?summary", body=_put_body(30))
        resp = conn.getresponse()
        assert resp.status == 200 and \
            resp.getheader("Connection") == "keep-alive"
        assert json.loads(resp.read()) == {"success": 30, "failed": 0}
        sock = conn.sock
        conn.request("GET", f"/api/query?start={T0}&m=sum:srv.m")
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert conn.sock is sock      # the same connection served both
        assert len(body[0]["dps"]) == 30
    finally:
        conn.close()


def _raw(st, request: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", st.port), 30) as s:
        s.sendall(request)
        out = b""
        while chunk := s.recv(65536):
            out += chunk
        return out


def _chunked(body: bytes, size: int = 100) -> bytes:
    out = b""
    for i in range(0, len(body), size):
        piece = body[i:i + size]
        out += f"{len(piece):x}\r\n".encode() + piece + b"\r\n"
    return out + b"0\r\n\r\n"


@pytest.mark.parametrize("enabled", [True, False])
def test_chunked_request_body(serve, enabled):
    st = serve(**{"tsd.http.request.enable_chunked": str(enabled)})
    head = (b"POST /api/put?summary HTTP/1.1\r\nHost: x\r\n"
            b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n")
    out = _raw(st, head + _chunked(_put_body(20)))
    status = int(out.split(b" ", 2)[1])
    if enabled:
        assert status == 200
        assert out.endswith(b'{"success":20,"failed":0}')
    else:
        assert status == 400 and b"enable_chunked" in out


def test_bad_framing_refused(serve):
    st = serve(**{"tsd.http.request.enable_chunked": "true"})
    out = _raw(st, b"POST /api/put HTTP/1.1\r\nTransfer-Encoding: gzip"
               b"\r\n\r\n")
    assert out.startswith(b"HTTP/1.1 400")
    out = _raw(st, b"POST /api/put HTTP/1.1\r\nContent-Length: x\r\n\r\n")
    assert out.startswith(b"HTTP/1.1 400")
    out = _raw(st, b"POST /api/put HTTP/1.1\r\nContent-Length: "
               + str((64 << 20) + 1).encode() + b"\r\n\r\n")
    assert out.startswith(b"HTTP/1.1 413")


def test_streamed_response_equals_the_whole_body(serve):
    """Past ``tsd.http.query.stream_threshold_dps`` the answer streams
    with chunked transfer encoding, with the bytes of the whole one."""
    st = serve(**{"tsd.http.query.stream_threshold_dps": "40"})
    assert _http(st, "POST", "/api/put", body=_put_body(60))[0] == 204
    path = f"/api/query?start={T0}&m=none:srv.m{{host=*}}"
    status, headers, streamed = _http(st, "GET", path)
    assert status == 200 and headers["Transfer-Encoding"] == "chunked"
    status, headers, whole = _http(st, "GET", path + "&show_summary=true")
    assert "Transfer-Encoding" not in headers
    rows = json.loads(whole)
    assert json.loads(streamed) == rows[:-1] and "statsSummary" in rows[-1]


def test_gzip(serve):
    st = serve()
    status, headers, body = _http(st, "GET", "/api/config",
                                  headers={"Accept-Encoding": "gzip"})
    assert status == 200 and headers["Content-Encoding"] == "gzip"
    assert headers["Vary"] == "Accept-Encoding"
    plain = _http(st, "GET", "/api/config")[2]
    assert gzip.decompress(body) == plain
    # small bodies stay plain
    _, headers, _ = _http(st, "GET", "/api/version",
                          headers={"Accept-Encoding": "gzip"})
    assert "Content-Encoding" not in headers


def test_cors(serve):
    st = serve(**{"tsd.http.request.cors_domains": "http://a.example"})
    _, headers, _ = _http(st, "GET", "/api/version",
                          headers={"Origin": "http://a.example"})
    assert headers["Access-Control-Allow-Origin"] == "http://a.example"
    _, headers, _ = _http(st, "GET", "/api/version",
                          headers={"Origin": "http://b.example"})
    assert "Access-Control-Allow-Origin" not in headers
    status, headers, _ = _http(st, "OPTIONS", "/api/query")
    assert status == 200 and "GET" in \
        headers["Access-Control-Allow-Methods"]


class _BlockingEngine:
    """Stands in for the query engine: blocks until released."""

    def __init__(self, release: threading.Event, entered: threading.Event):
        self.release, self.entered = release, entered

    def run(self, tsq, stats=None):
        self.entered.set()
        assert self.release.wait(30)
        return []


def _blocking(st) -> tuple[threading.Event, threading.Event]:
    release, entered = threading.Event(), threading.Event()
    st.server.tsdb.new_query = lambda: _BlockingEngine(release, entered)
    return release, entered


def test_admission_sheds_with_retry_after(serve):
    st = serve(**{"tsd.query.admission.max_inflight": "1",
                  "tsd.query.admission.retry_after_s": "3"})
    release, entered = _blocking(st)
    first: list = []
    t = threading.Thread(target=lambda: first.append(_http(
        st, "GET", f"/api/query?start={T0}&m=sum:x")))
    t.start()
    try:
        assert entered.wait(30)
        status, headers, body = _http(
            st, "GET", f"/api/query?start={T0}&m=sum:x")
        assert status == 503 and headers["Retry-After"] == "3"
        err = json.loads(body)["error"]
        assert err["code"] == 503 and "in-flight" in err["message"]
        # writes and admin endpoints are never shed
        assert _http(st, "GET", "/api/version")[0] == 200
    finally:
        release.set()
        t.join(30)
    assert first[0][0] == 200


def test_duplicate_queries_refused_when_not_allowed():
    """With ``tsd.query.allow_simultaneous_duplicates=false`` the same
    query from the same endpoint while the first runs is a 400; the
    running one shows in /api/stats/query, then the completed list."""
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
    tsdb = TSDB(Config(**{"tsd.torch.device": "cpu",
                          "tsd.query.allow_simultaneous_duplicates":
                          "false"}))
    release, entered = threading.Event(), threading.Event()
    tsdb.new_query = lambda: _BlockingEngine(release, entered)
    router = HttpRpcRouter(tsdb)

    def query():
        return router.handle(HttpRequest(
            method="GET", path="/api/query", remote="10.0.0.1:4000",
            params={"start": [str(T0)], "m": ["sum:dup.m"]}))

    first: list = []
    t = threading.Thread(target=lambda: first.append(query()))
    t.start()
    try:
        assert entered.wait(30)
        running = json.loads(router.handle(HttpRequest(
            method="GET", path="/api/stats/query")).body)["running"]
        assert [q["remote"] for q in running
                if q["query"]["queries"][0]["metric"] == "dup.m"] == \
            ["10.0.0.1:4000"]
        resp = query()
        assert resp.status == 400
        assert json.loads(resp.body)["error"]["message"] == \
            "Query is already executing for endpoint: 10.0.0.1:4000"
    finally:
        release.set()
        t.join(30)
    assert not t.is_alive() and first[0].status == 200
    done = json.loads(router.handle(HttpRequest(
        method="GET", path="/api/stats/query")).body)
    assert not [q for q in done["running"]
                if q["query"]["queries"][0]["metric"] == "dup.m"]
    mine = [q for q in done["completed"]
            if q["query"]["queries"][0]["metric"] == "dup.m"]
    assert [q["executed"] for q in mine] == [True]


def test_query_timeout_504(serve):
    st = serve(**{"tsd.query.timeout": "200"})
    release, _ = _blocking(st)
    try:
        t = time.monotonic()
        status, _, body = _http(st, "GET",
                                f"/api/query?start={T0}&m=sum:x")
        assert status == 504 and time.monotonic() - t < 20
        assert json.loads(body)["error"]["message"] == \
            "Query timeout exceeded (200ms)"
    finally:
        release.set()


def test_idle_connection_reaped(serve):
    st = serve(**{"tsd.core.socket.timeout": "1"})
    with socket.create_connection(("127.0.0.1", st.port), 30) as s:
        t = time.monotonic()
        assert s.recv(10) == b""          # closed by the server
        assert 0.5 < time.monotonic() - t < 20
    assert st.server.connections.idle_closed == 1


def test_connection_limit(serve):
    st = serve(**{"tsd.core.connections.limit": "1"})
    with socket.create_connection(("127.0.0.1", st.port), 30) as held:
        held.sendall(b"vers")      # hold the one slot open
        time.sleep(0.2)
        out = _raw(st, b"GET /api/version HTTP/1.1\r\n\r\n")
        assert out.startswith(b"HTTP/1.1 503") and b"Retry-After" in out


@pytest.mark.parametrize("how", ["http", "telnet"])
def test_diediedie_stops_cleanly(serve, how):
    st = serve(**{"tsd.query.fanout.workers": "2"})
    _http(st, "POST", "/api/put", body=_put_body(10, "a.m"))
    _http(st, "POST", "/api/put", body=_put_body(10, "b.m"))
    # a two-sub query starts the tsd-subq pool
    status, _, _ = _http(
        st, "POST", "/api/query", body=json.dumps(
            {"start": T0, "queries": [
                {"aggregator": "sum", "metric": "a.m"},
                {"aggregator": "sum", "metric": "b.m"}]}).encode())
    assert status == 200
    assert any(n.startswith("tsd-subq")
               for n in _pool_threads(serve.baseline))
    if how == "http":
        status, _, body = _http(st, "GET", "/diediedie")
        assert status == 200 and b"shutting down" in body
    else:
        assert _telnet(st, "diediedie\n") == \
            b"Cleanup complete, shutting down.\n"
    st._thread.join(30)
    assert not st._thread.is_alive()
    assert not _pool_threads(serve.baseline)


def test_cli_tsd_serves_and_stops_on_sigterm(tmp_path):
    """``python -m opentsdb_tpu_torch.tools.cli tsd`` on the CPU binds
    an ephemeral port, reports it, serves, and exits 0 on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "opentsdb_tpu_torch.tools.cli", "tsd",
         "--tsd.torch.device=cpu", "--tsd.network.port=0",
         "--tsd.network.bind", "127.0.0.1",
         "--tsd.core.auto_create_metrics=true"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        line = proc.stdout.readline()
        assert line.startswith("TSD listening on 127.0.0.1:"), \
            proc.stderr.read() if not line else line
        port = int(line.rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/api/put", body=_put_body(5))
        assert conn.getresponse().status == 204
        conn.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("command", ["query", "import", "nope"])
def test_cli_other_commands_refused(command):
    out = subprocess.run(
        [sys.executable, "-m", "opentsdb_tpu_torch.tools.cli", command],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert ("not ported yet" if command != "nope" else
            "unknown command") in out.stderr
