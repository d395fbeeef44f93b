"""Shared helpers of the port's parity tests over irregular data: seeded
data with jittered and dropped points, a reference TSDB holding it, the
port's TSDB loaded from the reference's export (same UIDs, same
series), and a whole-query comparison of the two.

Tolerance (as ``test_torch_pipeline.py``): float64 on both sides,
rtol 1e-9 and atol 1e-9 * max|x|; NaN positions, timestamps, tags and
aggregateTags equal.

Importing this module points the JAX package's native store at a
library built privately for the tests (:func:`jax_native_library`):
every ``tests/test_torch_*.py`` that builds a JAX ``TSDB`` or uses
``opentsdb_tpu.native`` imports it first.
"""

import fcntl
import hashlib
import inspect
import os
import platform
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from opentsdb_tpu.native import store_backend as jnative

# the JAX package's build flags (opentsdb_tpu/native/store_backend.py,
# build_library); a test holds each to that function's source
JAX_CXX = "g++"
JAX_CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                 "-pthread")
BUILD_DIR = Path(__file__).resolve().parent.parent / \
    "opentsdb_tpu_torch" / "_build"
_JAX_LIBRARY: Path | None = None


def _cpu_id() -> bytes:
    """The first processor's entry of /proc/cpuinfo without the lines
    that change while it runs (``-march=native`` depends on the CPU)."""
    try:
        first = Path("/proc/cpuinfo").read_text().strip().split("\n\n")[0]
    except OSError:
        first = ""
    return "\n".join([platform.machine()] + [
        ln for ln in first.splitlines()
        if not ln.lower().startswith(("cpu mhz", "bogomips"))]).encode()


def jax_native_library() -> Path | None:
    """Build the JAX package's ``tsdbstore.cc`` with its flags into a
    private file and point ``opentsdb_tpu.native.store_backend`` at it.

    The JAX package compiles in place (``g++ ... -o libtsdbstore.so``)
    and loads any file newer than its sources, so parallel test workers
    can load a file another worker is still writing, and a failed load
    stays cached for the process. Here the library is compiled into a
    temporary file and renamed into ``opentsdb_tpu_torch/_build/
    jax_tsdbstore_<hash>.so`` (the hash covers the source, the flags,
    the compiler's version and the CPU), under an ``flock`` so one
    worker builds and the others wait. Once per process; None when the
    host has no C++ compiler (the tests that need the library skip).
    """
    global _JAX_LIBRARY
    if _JAX_LIBRARY is not None:
        return _JAX_LIBRARY
    src = Path(jnative._SRC)
    try:
        version = subprocess.run([JAX_CXX, "--version"], capture_output=True,
                                 check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    digest = hashlib.sha256(b"\0".join((
        src.read_bytes(), " ".join(JAX_CXX_FLAGS).encode(), version,
        _cpu_id()))).hexdigest()[:16]
    out = BUILD_DIR / f"jax_tsdbstore_{digest}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "jax_tsdbstore.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run([JAX_CXX, *JAX_CXX_FLAGS, str(src), "-o", tmp],
                               capture_output=True, check=True, timeout=600)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        # the JAX package rebuilds (in place) a library older than its
        # sources: keep this one newer
        newest = max(src.stat().st_mtime,
                     Path(inspect.getsourcefile(jnative)).stat().st_mtime)
        if out.stat().st_mtime < newest:
            os.utime(out)
    if jnative._lib is None:
        jnative._LIB_PATH = str(out)
        jnative._build_error = None
    _JAX_LIBRARY = out
    return out


jax_native_library()

from opentsdb_tpu import TSDB as JTSDB  # noqa: E402
from opentsdb_tpu import Config as JConfig  # noqa: E402
from opentsdb_tpu.query.model import TSQuery as JQuery  # noqa: E402
from opentsdb_tpu_torch import TSDB, Config  # noqa: E402
from opentsdb_tpu_torch.core.state import load_arrays  # noqa: E402
from opentsdb_tpu_torch.query.model import TSQuery  # noqa: E402

T0 = 1356998400            # an hour boundary, seconds
# the point path with nothing cached and no result cache, on both sides
ENGINE_KEYS = {"tsd.query.grid_reduce": "false",
               "tsd.query.device_cache_mb": "0",
               "tsd.query.host_tail_max_cells": "-1",
               "tsd.query.host_tail_max_cells_linear": "-1",
               "tsd.query.cache.enable": "false"}
GRID_ON = {**ENGINE_KEYS, "tsd.query.grid_reduce": "true"}


def irregular(s: int, p: int, seed: int, t0: int = T0, step: int = 60,
              jitter: int = 10, drop: float = 0.02, nan: float = 0.0):
    """(tags_list, ts2d seconds, values2d, counts): series i holds the
    points ``t0 + step * j + u`` (``u`` a whole second in
    ``[0, jitter)``) of the ``p`` slots that survive a ``drop`` share of
    random losses, packed left in its row; values ``normal(100, 15)``,
    a ``nan`` share of them NaN. Tags ``host``, ``dc`` (6 values) and
    ``rack`` (40)."""
    rng = np.random.default_rng(seed)
    ts = t0 + step * np.arange(p, dtype=np.int64)[None, :] \
        + rng.integers(0, jitter, (s, p))
    vals = rng.normal(100.0, 15.0, (s, p))
    vals[rng.random((s, p)) < nan] = np.nan
    keep = rng.random((s, p)) >= drop
    counts = keep.sum(axis=1)
    ts2d = np.zeros((s, p), dtype=np.int64)
    v2d = np.full((s, p), np.nan)
    for i in range(s):
        ts2d[i, :counts[i]] = ts[i, keep[i]]
        v2d[i, :counts[i]] = vals[i, keep[i]]
    tags = [{"host": f"h{i:03d}", "dc": f"dc{i % 6}", "rack": f"r{i % 40}"}
            for i in range(s)]
    return tags, ts2d, v2d, counts


def reference_tsdb(metrics: dict, keys: dict = ENGINE_KEYS):
    """A reference TSDB holding each metric's (tags, ts2d, values2d,
    counts)."""
    jt = JTSDB(JConfig(**{"tsd.core.auto_create_metrics": "true",
                          "tsd.tpu.platform": "cpu", **keys}))
    for metric, (tags, ts2d, v2d, counts) in metrics.items():
        for i, t in enumerate(tags):
            n = counts[i]
            if n:
                jt.add_points(metric, ts2d[i, :n], v2d[i, :n], t)
    return jt


def export(jt, metric: str):
    """One metric of a reference TSDB as plain arrays: series in
    creation order, each tag dict in tag-key UID order."""
    mid = jt.uids.metrics.get_id(metric)
    sids = jt.store.series_ids_for_metric(mid)
    _, triples = jt.store.metric_index(mid).arrays()
    tags_list = []
    for sid in sids:
        rows = triples[triples[:, 0] == sid]
        rows = rows[np.argsort(rows[:, 1])]
        tags_list.append({jt.uids.tag_names.get_name(int(k)):
                          jt.uids.tag_values.get_name(int(v))
                          for _, k, v in rows})
    padded = jt.store.materialize_padded(sids, 0, 2**62)
    return tags_list, padded.ts2d, padded.values2d, padded.counts


def port_tsdb(jt, metrics, keys: dict = ENGINE_KEYS):
    """The port on the CPU in float64, loaded from ``jt``'s export."""
    tt = TSDB(Config(**{"tsd.torch.device": "cpu",
                        "tsd.torch.dtype": "float64", **keys}))
    for metric in metrics:
        load_arrays(tt, metric, *export(jt, metric))
    return tt


def rows(results):
    return [(r.metric, r.tags, sorted(r.aggregated_tags),
             [t for t, _ in r.dps], [v for _, v in r.dps])
            for r in results]


def assert_rows_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:4] == w[:4]
        gv, wv = np.asarray(g[4]), np.asarray(w[4])
        np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))
        np.testing.assert_allclose(gv, wv, rtol=1e-9, atol=1e-9 * max(
            np.nanmax(np.abs(wv), initial=0.0), 1.0), equal_nan=True)


def run_both(jt, tt, query: dict):
    """``query`` (TSQuery JSON) through both engines; the rows must
    agree. Returns the port's rows."""
    want = rows(jt.execute_query(JQuery.from_json(query).validate()))
    got = rows(tt.execute_query(TSQuery.from_json(query).validate()))
    assert_rows_close(got, want)
    return got


def uri_query(m: str, start: int = T0, end: int | None = None,
              **extra) -> dict:
    """The TSQuery JSON of one URI sub-query ``m``."""
    from opentsdb_tpu_torch.query.model import parse_uri_subquery
    sub = parse_uri_subquery(m)
    q = {"aggregator": sub.aggregator, "metric": sub.metric,
         "rate": sub.rate,
         "filters": [{"type": f.filter_name, "tagk": f.tagk,
                      "filter": f.filter_expr, "groupBy": f.group_by}
                     for f in sub.filters]}
    if sub.downsample:
        q["downsample"] = sub.downsample
    if sub.rate_options.counter:
        ro = sub.rate_options
        q["rateOptions"] = {"counter": True, "counterMax": ro.counter_max,
                            "resetValue": ro.reset_value,
                            "dropResets": ro.drop_resets}
    out = {"start": str(start),
           "end": str(end if end is not None else start + 3599),
           "queries": [q]}
    out.update(extra)
    return out
