"""The port's ``/q`` graphs and ``/s`` static files
(``opentsdb_tpu_torch/tsd/graph.py``, ``tsd/http_api.py``) held against
the JAX package's routers over the same data: the cases of
``tests/test_search_graph.py::TestGraphEndpoint`` and the static
containment cases of ``tests/test_http_robustness.py``
(``TestStaticPathTraversal``, the sibling-prefix cases), plus the
dashboard at ``/`` and ``/favicon.ico``.

The data is the reference's two-series fixture (``sys.cpu.user`` on
web01 and web02, 300 points at 10 s). Both TSDBs run in float64 (the
port on the CPU), so every body is compared byte for byte: the ascii
and JSON bodies, the error bodies, the static files, and the PNGs, which
the same matplotlib draws from the same values (through the same M4
pixel budget). The statuses must be equal everywhere.
"""

from __future__ import annotations

import pytest

import torch_pair  # noqa: F401 - the JAX package's private native build
from torch_pair import JConfig, JTSDB

from opentsdb_tpu.stats.stats import QueryStats as JQueryStats
from opentsdb_tpu.tsd.http_api import HttpRequest as JRequest
from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.stats.stats import QueryStats
from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter

BASE = 1356998400
START = "2012/12/31-23:00:00"
PNG = b"\x89PNG\r\n\x1a\n"


def make_routers(keys: dict):
    jt = JTSDB(JConfig(**{"tsd.core.auto_create_metrics": "true",
                          "tsd.tpu.platform": "cpu", **keys}))
    tt = TSDB(Config(**{"tsd.core.auto_create_metrics": "true",
                        "tsd.torch.device": "cpu",
                        "tsd.torch.dtype": "float64", **keys}))
    for t in (jt, tt):
        for i in range(300):
            t.add_point("sys.cpu.user", BASE + i * 10, i, {"host": "web01"})
            t.add_point("sys.cpu.user", BASE + i * 10, 300 - i,
                        {"host": "web02"})
    return JRouter(jt), HttpRpcRouter(tt)


def close(jr, tr) -> None:
    """Shut both TSDBs down and join the JAX package's fan-out pool,
    which its shutdown leaves running (a two-sub /q starts it); a later
    test file on the same worker counts its threads."""
    jr.tsdb.shutdown()
    pool = getattr(jr.tsdb, "_fanout_pool", None)
    if pool is not None:
        pool.shutdown(wait=True)
    tr.tsdb.shutdown()


@pytest.fixture
def routers(tmp_path):
    jr, tr = make_routers({})
    jr.tsdb.config.override_config("tsd.http.cachedir", str(tmp_path / "j"))
    tr.tsdb.config.override_config("tsd.http.cachedir", str(tmp_path / "t"))
    yield jr, tr
    close(jr, tr)


def send(routers, path, params=None, multi=None):
    """One GET to both routers; equal status and equal bodies. Returns
    the port's response."""
    prm = {k: [v] for k, v in (params or {}).items()}
    prm.update(multi or {})
    jr, tr = routers
    want = jr.handle(JRequest(method="GET", path=path, params=prm,
                              headers={}, body=b"", remote="t"))
    got = tr.handle(HttpRequest(method="GET", path=path, params=prm,
                                headers={}, body=b"", remote="t"))
    assert got.status == want.status, (got.body[:300], want.body[:300])
    assert got.body == want.body, (got.body[:300], want.body[:300])
    assert got.content_type == want.content_type
    return got


# -- TestGraphEndpoint --------------------------------------------------------

def test_ascii_output(routers):
    resp = send(routers, "/q", {"start": START, "m": "sum:sys.cpu.user",
                                "ascii": "true"})
    assert resp.status == 200
    lines = resp.body.decode().splitlines()
    assert lines[0].startswith("sys.cpu.user 13569984") and len(lines) == 300


def test_json_output(routers):
    resp = send(routers, "/q", {"start": START, "m": "sum:sys.cpu.user",
                                "json": "true"})
    assert resp.status == 200 and b'"metric":"sys.cpu.user"' in resp.body


def test_png_output_and_cache(routers, tmp_path):
    pytest.importorskip("matplotlib")
    params = {"start": START, "m": "sum:sys.cpu.user", "wxh": "300x200"}
    resp = send(routers, "/q", params)
    assert resp.status == 200 and resp.body[:8] == PNG
    for d in ("j", "t"):
        assert len(list((tmp_path / d).glob("*.png"))) == 1
    assert send(routers, "/q", params).body == resp.body


def test_missing_metric_param(routers):
    resp = send(routers, "/q", {"start": "1356998000"})
    assert resp.status == 400 and b"Missing 'm' parameter" in resp.body


def test_plot_option_surface(routers):
    pytest.importorskip("matplotlib")
    base = {"start": START, "m": "sum:sys.cpu.user", "wxh": "300x200"}
    bodies = {send(routers, "/q", base).body}
    for extra in ({"style": "linespoint"}, {"smooth": "csplines"},
                  {"title": "hello", "ylabel": "ms"},
                  {"yrange": "[0:500]", "ylog": "true"},
                  {"key": "out top left"},
                  {"bgcolor": "x333333", "fgcolor": "xffffff"},
                  {"nokey": "true"}, {"yformat": "%.1f"}):
        resp = send(routers, "/q", {**base, **extra})
        assert resp.status == 200 and resp.body[:8] == PNG, extra
        bodies.add(resp.body)
    assert len(bodies) == 9


def test_y2_axis_per_metric_options(routers):
    pytest.importorskip("matplotlib")
    resp = send(routers, "/q", multi={
        "start": [START], "m": ["sum:sys.cpu.user", "max:sys.cpu.user"],
        "o": ["", "axis x1y2"], "y2label": ["right"],
        "y2range": ["[0:1000]"], "y2log": [""], "wxh": ["300x200"]})
    assert resp.status == 200 and resp.body[:8] == PNG


def test_bad_yrange_400(routers):
    pytest.importorskip("matplotlib")
    resp = send(routers, "/q", {"start": START, "m": "sum:sys.cpu.user",
                                "yrange": "0:500"})
    assert resp.status == 400


def test_graph_records_query_stats(routers):
    send(routers, "/q", {"start": START, "m": "sum:sys.cpu.user",
                         "ascii": "true"})
    for cls in (JQueryStats, QueryStats):
        done = cls.running_and_completed()["completed"]
        assert done and done[-1]["executed"]


def test_graph_render_failure_not_executed(routers):
    resp = send(routers, "/q", {"start": START, "m": "sum:sys.cpu.user",
                                "yrange": "not-a-range"})
    assert resp.status == 400
    for cls in (JQueryStats, QueryStats):
        done = cls.running_and_completed()["completed"]
        assert done and done[-1]["executed"] is False


def test_png_without_matplotlib_is_501(routers, monkeypatch):
    """A host without matplotlib runs the query, then answers the
    reference's 501."""
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    resp = send(routers, "/q", {"start": START, "m": "sum:sys.cpu.user"})
    assert resp.status == 501 and b"Graphing requires matplotlib" in resp.body


def test_pixel_budget_off_by_key(tmp_path):
    """``tsd.http.graph.auto_pixels=false`` leaves a PNG's query at full
    resolution; the charts of both packages still agree."""
    pytest.importorskip("matplotlib")
    jr, tr = make_routers({"tsd.http.graph.auto_pixels": "false"})
    try:
        jr.tsdb.config.override_config("tsd.http.cachedir",
                                       str(tmp_path / "j"))
        tr.tsdb.config.override_config("tsd.http.cachedir",
                                       str(tmp_path / "t"))
        resp = send((jr, tr), "/q", {"start": START, "wxh": "200x100",
                                     "m": "sum:sys.cpu.user"})
        assert resp.status == 200 and resp.body[:8] == PNG
    finally:
        close(jr, tr)


# -- static files -------------------------------------------------------------

@pytest.fixture(scope="module")
def static_routers():
    jr, tr = make_routers({})
    yield jr, tr
    close(jr, tr)


@pytest.mark.parametrize("path", [
    "/s/../../../etc/passwd", "/s/..%2f..%2fetc/passwd",
    "/s/subdir/../../../../etc/hostname", "/s//etc/passwd",
    "/s/%2e%2e/%2e%2e/etc/passwd", "/s/....//....//etc/passwd"])
def test_static_traversal_rejected(static_routers, path):
    resp = send(static_routers, path)
    assert resp.status == 404 and b"root:" not in resp.body


def test_static_and_home_pages(static_routers):
    resp = send(static_routers, "/s/index.html")
    assert resp.status == 200 and b"<!DOCTYPE html>" in resp.body
    assert send(static_routers, "/").body == resp.body
    assert send(static_routers, "/favicon.ico").status == 204


@pytest.fixture
def sibling_routers(tmp_path):
    root = tmp_path / "static"
    root.mkdir()
    (root / "ok.txt").write_text("public")
    (root / "favicon.ico").write_bytes(b"\x00\x00\x01\x00")
    sibling = tmp_path / "static_private"
    sibling.mkdir()
    (sibling / "secret.txt").write_text("SECRET")
    jr, tr = make_routers({"tsd.http.staticroot": str(root)})
    yield jr, tr
    close(jr, tr)


def test_sibling_prefix_dir_is_404(sibling_routers):
    resp = send(sibling_routers, "/s/../static_private/secret.txt")
    assert resp.status == 404 and b"SECRET" not in resp.body


def test_root_files_still_serve(sibling_routers):
    assert send(sibling_routers, "/s/ok.txt").body == b"public"
    assert send(sibling_routers, "/favicon.ico").status == 200
    # a root without index.html: the short page of each package
    assert send_status(sibling_routers, "/") == 200


def send_status(routers, path) -> int:
    jr, tr = routers
    got = tr.handle(HttpRequest(method="GET", path=path))
    assert got.status == jr.handle(JRequest(method="GET", path=path)).status
    return got.status


def test_cachedir_default():
    """Queue 3 item 27: the reference caches ``/q`` PNGs under
    ``/tmp/opentsdb_tpu`` by default; the port under
    ``<tempdir>/opentsdb_tpu_torch``, so the two packages never share a
    cache, and the process's temporary directory is honoured."""
    import os
    import tempfile
    assert JConfig().get_string("tsd.http.cachedir") == "/tmp/opentsdb_tpu"
    assert Config().get_string("tsd.http.cachedir") == os.path.join(
        tempfile.gettempdir(), "opentsdb_tpu_torch")


def test_cached_png_served_before_the_query(routers):
    """Queue 3 item 30: a PNG request whose chart is in the cache (younger
    than ``max_age``) gets the cached bytes in both packages; the JAX
    package runs the query again first, the port (as the Java
    GraphHandler's ``isDiskCacheHit``) does not."""
    pytest.importorskip("matplotlib")
    runs = {}
    for side, router in zip(("jax", "port"), routers):
        real = router.tsdb.new_query

        def counted(real=real, side=side):
            runs[side] = runs.get(side, 0) + 1
            return real()
        router.tsdb.new_query = counted
    params = {"start": START, "m": "sum:sys.cpu.user", "wxh": "300x200"}
    first = send(routers, "/q", params)
    assert runs == {"jax": 1, "port": 1}
    assert send(routers, "/q", params).body == first.body
    assert runs == {"jax": 2, "port": 1}
