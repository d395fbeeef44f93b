"""The port's multi-process mesh layer (``opentsdb_tpu_torch/parallel/
distributed.py``) against the JAX package's: twins of
``tests/test_distributed.py`` and ``tests/test_multihost.py`` on the CPU.

- The layout: the ``[local devices, hosts]`` grid over ``[cpu] * 8``
  (one process; fake hosts split the list) against the reference's
  over its 8 virtual devices, the mesh's axis names, ``series_home``,
  and the sharded step on that mesh against the reference's.
- The rendezvous: one process is a no-op, a dead coordinator fails the
  boot within ``tsd.mesh.init_timeout``, and two processes joined on
  gloo (``tsd.mesh.coordinator`` on an ephemeral localhost port,
  ``tsd.query.mesh=series:4,time:2``, each with ``[cpu] * 4``, the time
  axis spanning them) answer as one process does on ``[cpu] * 8``, and
  as the JAX package on its 8 virtual devices. Each child process runs
  under a timeout of its own and is killed past it.

Tolerance: float64 on both sides, rtol 1e-9 and atol 1e-9 * max|x|;
timestamps and tags equal.
"""

import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_pair  # noqa: F401  (the JAX package's private native build)
from torch_mesh_data import QUERIES, answer, seed

from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.ops.pipeline import PipelineSpec as JSpec
from opentsdb_tpu.parallel import distributed as jdist
from opentsdb_tpu.parallel import sharded_pipeline as jsp
from opentsdb_tpu.query.model import TSQuery as JQuery
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
from opentsdb_tpu_torch.ops.rate import RateOptions
from opentsdb_tpu_torch.parallel import distributed as tdist
from opentsdb_tpu_torch.parallel import sharded_pipeline as tsp
from opentsdb_tpu_torch.query.model import TSQuery

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
DEVS = [CPU] * 8
CHILD_TIMEOUT_S = 240


def test_grid_single_process_all_local():
    assert tdist.multihost_device_grid(DEVS).shape == \
        jdist.multihost_device_grid().shape == (8, 1)


def test_grid_fake_hosts_split():
    devs = [torch.device("cpu", i) for i in range(8)]
    grid = tdist.multihost_device_grid(devs, num_hosts=4)
    assert grid.shape == jdist.multihost_device_grid(num_hosts=4).shape \
        == (2, 4)
    # the devices of one column come from one (fake) host's chunk
    assert grid[0, 0] == devs[0] and grid[1, 0] == devs[1]
    assert grid[0, 3] == devs[6] and grid[1, 3] == devs[7]


def test_grid_uneven_split_rejected():
    with pytest.raises(ValueError):
        tdist.multihost_device_grid(DEVS, num_hosts=3)
    with pytest.raises(ValueError):
        jdist.multihost_device_grid(num_hosts=3)


def test_mesh_axis_names():
    mesh = tdist.make_multihost_mesh(DEVS, num_hosts=2)
    assert mesh.shape == dict(jdist.make_multihost_mesh(num_hosts=2).shape)
    assert mesh.shape == {"series": 4, "time": 2}
    assert mesh.axis_names == ("series", "time")
    assert mesh.time_group is None and mesh.local_time == [0, 1]


def test_series_home_round_robin():
    mesh = tdist.make_multihost_mesh(DEVS, num_hosts=2)
    jmesh = jdist.make_multihost_mesh(num_hosts=2)
    # one process: every shard homes to process 0, a total, stable map
    for shard in range(16):
        assert tdist.series_home(shard, mesh) == \
            jdist.series_home(shard, jmesh) == 0


def test_sharded_pipeline_runs_on_multihost_mesh():
    """The sharded step on the multi-host-shaped mesh (series local,
    time across hosts) equals the reference's."""
    s, b, g, points_per = 8, 6, 3, 18
    rng = np.random.default_rng(5)
    values = rng.normal(50.0, 10.0, size=s * points_per)
    sidx = np.repeat(np.arange(s, dtype=np.int32), points_per)
    bidx = np.tile((np.arange(points_per, dtype=np.int32) * b)
                   // points_per, s)
    bts = np.arange(b, dtype=np.int64) * 60_000
    gids = (np.arange(s) % g).astype(np.int32)
    kw = dict(num_series=s, num_buckets=b, num_groups=g,
              ds_function="avg", agg_name="sum", rate=True)
    jm = jdist.make_multihost_mesh(num_hosts=2)
    want = jsp.run_sharded(jm, JSpec(**kw), jsp.prepare_sharded_batch(
        values, sidx, bidx, bts, gids, s, g, 4, 2))
    tm = tdist.make_multihost_mesh(DEVS, num_hosts=2)
    got = tsp.run_sharded(tm, PipelineSpec(**kw), tsp.prepare_sharded_batch(
        values, sidx, bidx, bts, gids, s, g, 4, 2), RateOptions(),
        dtype=torch.float64)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-9,
                               equal_nan=True)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_put_global_and_to_host_round_trip():
    mesh = tdist.make_multihost_mesh(DEVS, num_hosts=2)
    x = np.arange(8 * 6, dtype=np.float64).reshape(8, 6)
    for spec in (("series", "time"), ("series", None), (None, "time")):
        arr = tdist.put_global(x, mesh, spec)
        assert len(arr.shards) == 8
        np.testing.assert_array_equal(tdist.to_host(arr), x)


def test_one_process_is_a_no_op():
    tdist.initialize(num_processes=1)
    assert not tdist.initialize_from_config(Config())
    assert not tdist.is_distributed()
    assert tdist.process_count() == 1 and tdist.process_index() == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(code: str, args_of, n: int, tmp_path: Path):
    """Start ``n`` child processes of ``code``; each runs under
    CHILD_TIMEOUT_S and is killed past it. Returns (returncode, output)
    per child."""
    script = tmp_path / "child.py"
    script.write_text(code)
    procs = [subprocess.Popen(
        [sys.executable, str(script), *args_of(i)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(n)]
    out = []
    for p in procs:
        try:
            log = p.communicate(timeout=CHILD_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            log = p.communicate()[0] + "\n[killed at the timeout]"
        out.append((p.returncode, log))
    return out


DEAD = r"""
import sys, time
sys.path.insert(0, ".")
from opentsdb_tpu_torch import TSDB, Config
t0 = time.monotonic()
try:
    TSDB(Config(**{"tsd.torch.device": "cpu",
                   "tsd.mesh.coordinator": f"127.0.0.1:{sys.argv[1]}",
                   "tsd.mesh.num_processes": "2",
                   "tsd.mesh.process_id": "1",
                   "tsd.mesh.init_timeout": "3"}))
except Exception as exc:
    print("FAILED", type(exc).__name__, f"{time.monotonic() - t0:.1f}")
    sys.exit(3)
print("STARTED")
"""


def test_dead_coordinator_fails_the_boot_within_its_timeout(tmp_path):
    port = _free_port()      # nothing listens there
    ((rc, log),) = _run_children(DEAD, lambda i: [str(port)], 1, tmp_path)
    assert rc == 3, log[-3000:]
    secs = float(log.split("FAILED")[1].split()[1])
    assert secs < 3 + 20, log[-3000:]


WORKER = r"""
import json, sys
sys.path.insert(0, ".")
import torch
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.parallel import distributed
from opentsdb_tpu_torch.query.model import TSQuery

pid, port, outpath = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, "tests")
from torch_mesh_data import QUERIES, answer, seed

cpu = torch.device("cpu")
t = TSDB(Config(**{
    "tsd.torch.device": "cpu", "tsd.torch.dtype": "float64",
    "tsd.core.auto_create_metrics": "true",
    "tsd.mesh.coordinator": f"127.0.0.1:{port}",
    "tsd.mesh.num_processes": "2", "tsd.mesh.process_id": str(pid),
    "tsd.mesh.init_timeout": "120",
    "tsd.query.mesh": "series:4,time:2"}), mesh_devices=[cpu] * 4)
assert distributed.process_count() == 2
mesh = t.query_mesh
assert mesh.shape == {"series": 4, "time": 2}, mesh.shape
assert mesh.local_time == [pid], mesh.local_time
seed(t)
# a second facade over the same store with a budget that forces the
# blocked path (host-chained carries across time blocks)
tb = TSDB(Config(**{
    "tsd.torch.device": "cpu", "tsd.torch.dtype": "float64",
    "tsd.query.mesh": "series:4,time:2",
    "tsd.query.max_device_cells": "64",
    "tsd.query.grid_reduce": "false"}), mesh_devices=[cpu] * 4)
tb.store, tb.uids = t.store, t.uids
out = []
for q, facade in [(q, t) for q in QUERIES] + [(QUERIES[0], tb)]:
    out.append(answer(facade.execute_query(TSQuery.from_json(q)
                                           .validate())))
with open(outpath, "w") as f:
    json.dump(out, f)
print("worker", pid, "done", flush=True)
"""

def _assert_answers_close(got: list, want: list) -> None:
    assert [g["tags"] for g in got] == [w["tags"] for w in want]
    for g, w in zip(got, want):
        assert [a for a, _ in g["dps"]] == [a for a, _ in w["dps"]]
        wv = np.asarray([v for _, v in w["dps"]])
        np.testing.assert_allclose(
            [v for _, v in g["dps"]], wv, rtol=1e-9,
            atol=1e-9 * max(np.nanmax(np.abs(wv), initial=0.0), 1.0))


def test_two_process_mesh_matches_single_process(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"out{i}.json" for i in range(2)]
    runs = _run_children(WORKER, lambda i: [str(i), str(port),
                                            str(outs[i])], 2, tmp_path)
    for rc, log in runs:
        assert rc == 0, log[-4000:]
    got = [json.loads(o.read_text()) for o in outs]
    # both processes hold the same full answer (SPMD)
    assert got[0] == got[1]
    assert len(got[0]) == len(QUERIES) + 1
    # the blocked answer equals the plain one
    _assert_answers_close(got[0][-1], got[0][0])

    # the port in one process on [cpu] * 8, and the JAX package on its
    # 8 virtual devices, each with the same mesh shape
    one = TSDB(Config(**{"tsd.torch.device": "cpu",
                         "tsd.torch.dtype": "float64",
                         "tsd.core.auto_create_metrics": "true",
                         "tsd.query.mesh": "series:4,time:2"}),
               mesh_devices=[CPU] * 8)
    seed(one)
    jt = JTSDB(JConfig(**{"tsd.core.auto_create_metrics": "true",
                          "tsd.tpu.platform": "cpu",
                          "tsd.query.mesh": "series:4,time:2"}))
    seed(jt)
    for qi, q in enumerate(QUERIES):
        mine = answer(one.execute_query(TSQuery.from_json(q).validate()))
        ref = answer(jt.execute_query(JQuery.from_json(q).validate()))
        _assert_answers_close(got[0][qi], mine)
        _assert_answers_close(mine, ref)
