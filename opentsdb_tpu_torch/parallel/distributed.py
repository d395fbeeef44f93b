"""Multi-process deployment of the query mesh (port of
``opentsdb_tpu/parallel/distributed.py``).

The reference scales beyond one JVM by running many stateless TSDs
behind a load balancer, all reading one storage cluster. Here, as in
the JAX package, one process per host joins a rendezvous and a single
('series', 'time') mesh spans every process's devices. The rendezvous
is ``torch.distributed.init_process_group`` on the gloo backend at
``tcp://<tsd.mesh.coordinator>``.

Axis placement puts the chatty collective on the fast link:

- the **series** axis lays out over each process's own devices: the
  group-by reductions cross it on every query, and never leave the
  process;
- the **time** axis spans the processes: time blocks are almost
  independent, and only rate and interpolation boundary carries
  (``[S_loc]`` vectors per block edge) and results cross it, through
  gloo (:mod:`.collectives`).

Every process holds the same data and runs the same queries (SPMD): the
analogue of many TSDs reading one storage cluster.
:func:`series_home` names the process that owns a series shard's
ingest.
"""

from __future__ import annotations

import logging
from datetime import timedelta

import numpy as np
import torch

from opentsdb_tpu_torch.parallel.collectives import AxisGroup, every_shard
from opentsdb_tpu_torch.parallel.mesh import (Mesh, ShardedArray,
                                              block_slices)

LOG = logging.getLogger(__name__)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               initialization_timeout: int = 120) -> None:
    """Join the multi-process rendezvous (a no-op for one process).

    ``torch.distributed.init_process_group`` on gloo at
    ``tcp://<coordinator_address>``; the process with ``process_id`` 0
    hosts the rendezvous. Unlike a TPU pod, nothing here tells a process
    its peers: all three arguments are required. A dead coordinator
    fails the boot in a bounded time: the rendezvous client gives up
    after ``initialization_timeout`` seconds a try (it tries twice)."""
    import torch.distributed as dist
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    if not coordinator_address or num_processes is None \
            or process_id is None or process_id < 0:
        raise ValueError(
            "a multi-process mesh needs tsd.mesh.coordinator, "
            "tsd.mesh.num_processes and tsd.mesh.process_id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=initialization_timeout))


def initialize_from_config(config) -> bool:
    """The TSD's multi-process entry point: when
    ``tsd.mesh.coordinator`` is set, join the rendezvous before any
    device touch. Idempotent; returns True when running multi-process.

    Launch, one line per host::

        tsdb tsd --tsd.mesh.coordinator=host0:9255 \\
                 --tsd.mesh.num_processes=2 --tsd.mesh.process_id=0 \\
                 --tsd.query.mesh=auto
    """
    coordinator = config.get_string("tsd.mesh.coordinator", "")
    if not coordinator:
        return False
    num_processes = config.get_int("tsd.mesh.num_processes", 0)
    process_id = config.get_int("tsd.mesh.process_id", -1)
    initialize(coordinator, num_processes if num_processes > 0 else None,
               process_id if process_id >= 0 else None,
               config.get_int("tsd.mesh.init_timeout", 120))
    LOG.info("torch.distributed up: process %d/%d", process_index(),
             process_count())
    return is_distributed()


def is_distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if is_distributed() else 0


def put_global(x, mesh: Mesh, spec: tuple) -> ShardedArray:
    """Upload a host array onto ``mesh`` cut by ``spec``: each position
    this process holds gets its block, on its device, from this
    process's own (identical, SPMD) host copy. A block that several
    positions share on one device is uploaded once."""
    xnp = np.asarray(x)
    shards, done = {}, {}
    for i, j in mesh.positions():
        sl = block_slices(mesh, spec, xnp.shape, i, j)
        dev = mesh.device(i, j)
        key = (tuple((s.start, s.stop) for s in sl), str(dev))
        t = done.get(key)
        if t is None:
            t = done[key] = torch.from_numpy(
                np.ascontiguousarray(xnp[sl])).to(dev)
        shards[(i, j)] = t
    return ShardedArray(mesh, spec, xnp.shape, shards)


def to_host(x: ShardedArray) -> np.ndarray:
    """Bring a sharded array to host numpy, gathering the other
    processes' blocks when its time axis spans processes: every process
    receives the full array, the analogue of each TSD serializing the
    complete response."""
    mesh = x.mesh
    first = next(iter(x.shards.values()))
    out = np.empty(x.shape, dtype=first.cpu().numpy().dtype)
    for (i, j), t in x.shards.items():
        out[block_slices(mesh, x.spec, x.shape, i, j)] = t.cpu().numpy()
    group = mesh.time_group
    if group is None or "time" not in x.spec:
        return out
    # this process filled its own columns; the others arrive by gloo
    dim = x.spec.index("time")
    blk = x.shape[dim] // mesh.shape["time"]
    lo = mesh.local_time[0] * blk
    mine = torch.from_numpy(np.ascontiguousarray(
        np.take(out, range(lo, lo + blk * group.local), axis=dim)))
    slabs = every_shard([mine], AxisGroup(group.world, group.rank, 1))
    return np.concatenate([s.numpy() for s in slabs], axis=dim)


def multihost_device_grid(devices=None,
                          num_hosts: int | None = None) -> np.ndarray:
    """Arrange devices into a ``[local devices, hosts]`` grid: rows
    (the series axis) hold one host's devices, columns (the time axis)
    cross hosts. Under a rendezvous, ``devices`` is this process's list
    and every process holds the same count; column h is process h's.
    In one process, ``num_hosts`` splits the flat device list into equal
    fake hosts (the tests' virtual devices)."""
    from opentsdb_tpu_torch.parallel.mesh import default_devices
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else default_devices())]
    if num_hosts is None:
        # one column per process, each holding its own device list
        num_hosts = process_count()
        grid = np.empty((len(devs), num_hosts), dtype=object)
        for h in range(num_hosts):
            grid[:, h] = devs
        return grid
    if len(devs) % num_hosts:
        raise ValueError(
            f"{len(devs)} devices do not split into {num_hosts} hosts")
    per = len(devs) // num_hosts
    grid = np.empty((per, num_hosts), dtype=object)
    for h in range(num_hosts):
        grid[:, h] = devs[h * per:(h + 1) * per]
    return grid


def make_multihost_mesh(devices=None, num_hosts: int | None = None,
                        n_series: int | None = None) -> Mesh:
    """A ('series', 'time') mesh with series local to a process and
    time across processes. Under a rendezvous, ``devices`` is this
    process's list, laid out ``[n_series, len(devices) / n_series]``
    per process (``n_series`` defaults to every device), and the
    processes' blocks side by side along the time axis."""
    world = process_count()
    if world == 1 or num_hosts is not None:
        return Mesh(multihost_device_grid(devices, num_hosts))
    from opentsdb_tpu_torch.parallel.mesh import default_devices
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else default_devices())]
    n_series = n_series or len(devs)
    if len(devs) % n_series:
        raise ValueError(f"{len(devs)} devices do not fill "
                         f"{n_series} series rows")
    local = len(devs) // n_series
    grid = np.empty((n_series, local * world), dtype=object)
    owner = np.empty(grid.shape, dtype=np.int64)
    for h in range(world):
        for k, d in enumerate(devs):
            grid[k // local, h * local + k % local] = d
            owner[k // local, h * local + k % local] = h
    return Mesh(grid, owner, process_index(),
                AxisGroup(world, process_index(), local))


def series_home(series_shard: int, mesh: Mesh) -> int:
    """Which process owns a series shard's ingest (ref-analogue:
    asynchbase region-aware write routing): the process of the device
    at ``[shard % series_size, 0]``."""
    series_size = mesh.shape["series"]
    return int(mesh.process_index[series_shard % series_size, 0])
