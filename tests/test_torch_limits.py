"""Query limits (``query/limits.py``) on the port's three engine paths,
each held against the JAX engine's refusal of the same query over the
same data: the point path after it materializes, a prepared-batch hit
with the count it cached, and the grid path (cold and cached) after the
storage-side reduction. Then the override file and its reload."""

import json
import os
import time

import pytest

from opentsdb_tpu.tsd.http_api import HttpRpcRouter as JRouter
from opentsdb_tpu_torch.query import engine as engine_mod
from opentsdb_tpu_torch.query.limits import (QueryLimitExceeded,
                                             QueryLimitOverride)
from opentsdb_tpu_torch.tsd.http_api import HttpRpcRouter
from opentsdb_tpu_torch.utils.config import Config
from test_torch_http import (CPU, END, close_pair, compare, make_pair,
                             send_both)
from torch_pair import ENGINE_KEYS, GRID_ON, T0

M = f"sum:5m-avg:{CPU}{{dc=*}}"
# (keys, points the path counts): 12 series x 60 points, one of them
# 40, is 700 points in the window; the storage-side reduction of the
# grid path does not count the one NaN value
PATHS = {
    "point": (ENGINE_KEYS, 700),
    "prepared-hit": ({**ENGINE_KEYS, "tsd.query.device_cache_mb": "64"},
                     700),
    "grid": (GRID_ON, 699),
    "grid-hit": ({**GRID_ON, "tsd.query.device_cache_mb": "64"}, 699),
}


def _set_limits(tsdbs, dps: int = 0, nbytes: int = 0) -> None:
    for t in tsdbs:
        t.query_limits.default_data_points_limit = dps
        t.query_limits.default_byte_limit = nbytes


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("limit", ["data_points", "bytes"])
def test_413_on_each_path(path, limit, monkeypatch):
    keys, points = PATHS[path]
    jt, tt = make_pair(keys)
    try:
        jr, pr = JRouter(jt), HttpRpcRouter(tt)
        if path.endswith("hit"):
            # warm the cache under no limit, then refuse from the hit:
            # the port must not scan again
            got, want = send_both(jr, pr, "GET", "/api/query", start=T0,
                                  end=END, m=M)
            compare("query", got, want, {})

            def no_scan(*a, **k):
                raise AssertionError("the cache hit scanned the store")

            monkeypatch.setattr(engine_mod.QueryEngine,
                                "_materialize_points", no_scan)
            monkeypatch.setattr(tt.store, "bucket_reduce", no_scan)
        if limit == "data_points":
            _set_limits((jt, tt), dps=points - 1)
        else:
            _set_limits((jt, tt), nbytes=16 * points - 1)
        got, want = send_both(jr, pr, "GET", "/api/query", start=T0,
                              end=END, m=M)
        assert want.status == 413
        compare("bytes", got, want, {})
        assert str(points if limit == "data_points" else 16 * points) \
            in json.loads(got.body)["error"]["message"]
        # at the count itself the query passes on both
        if limit == "data_points":
            _set_limits((jt, tt), dps=points)
        else:
            _set_limits((jt, tt), nbytes=16 * points)
        got, want = send_both(jr, pr, "GET", "/api/query", start=T0,
                              end=END, m=M)
        compare("query", got, want, {})
    finally:
        close_pair(jt, tt)


def test_override_file_and_reload(tmp_path):
    """A regex override wins over the default, and the file is read
    again once its mtime changes (checked at most every
    ``tsd.query.limits.overrides.interval`` seconds)."""
    path = tmp_path / "limits.json"
    path.write_text(json.dumps([{"regex": r"^sys\.cpu",
                                 "dataPointsLimit": 10}]))
    lim = QueryLimitOverride(Config(**{
        "tsd.query.limits.data_points.default": "1000",
        "tsd.query.limits.overrides.config": str(path),
        "tsd.query.limits.overrides.interval": "1"}))
    with pytest.raises(QueryLimitExceeded, match="limit of 10 data"):
        lim.check("sys.cpu.user", 11)
    lim.check("sys.mem", 999)
    with pytest.raises(QueryLimitExceeded, match="limit of 1000 data"):
        lim.check("sys.mem", 1001)
    path.write_text(json.dumps([{"regex": r"^sys\.cpu",
                                 "dataPointsLimit": 50,
                                 "byteLimit": 100}]))
    st = path.stat()
    os.utime(path, (st.st_atime, st.st_mtime + 5))
    time.sleep(1.05)
    lim.check("sys.cpu.user", 6)
    with pytest.raises(QueryLimitExceeded, match="limit of 100 bytes"):
        lim.check("sys.cpu.user", 7)
    # a file that no longer parses keeps the overrides in force
    path.write_text("{broken")
    os.utime(path, (st.st_atime, st.st_mtime + 10))
    time.sleep(1.05)
    with pytest.raises(QueryLimitExceeded, match="limit of 100 bytes"):
        lim.check("sys.cpu.user", 7)


def test_negative_default_refused():
    with pytest.raises(ValueError):
        QueryLimitOverride(Config(**{
            "tsd.query.limits.data_points.default": "-1"}))
