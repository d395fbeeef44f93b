"""Device mesh construction (port of ``opentsdb_tpu/parallel/mesh.py``).

The reference scales by (a) the 20-way salt-bucket scan fan-out inside
one TSD (SaltScanner.java:70) and (b) stateless TSD scale-out behind a
load balancer, and maps both onto one ``('series', 'time')`` mesh:

- ``series`` axis: the salt axis. Series land on its shards in
  contiguous blocks, and group-by reductions cross it with the sums,
  minima and maxima of :mod:`.collectives`;
- ``time`` axis: long ranges split into blocks of buckets; rate and
  interpolation exchange boundary carries over it.

A :class:`Mesh` is a ``[n_series, n_time]`` array of ``torch.device``s
drawn from a device list the caller gives: by default the visible
cards, or the CPU where there is none. The list may name one device
more than once, the counterpart of the virtual XLA host devices the
reference's tests run on: ``[cpu] * 8`` on the CPU, ``[cuda:0] * 4`` on
one card. Such a mesh runs the sharded code on that device, one shard
after another; it shows the sharded code's answers, not a scaling.

When the mesh spans processes (:mod:`.distributed`), each process holds
every series shard of its own block of time columns, and only the time
axis's collectives cross processes.

A :class:`ShardedArray` is the counterpart of a ``jax.Array`` with a
``NamedSharding``: a global array cut over the mesh by a partition spec
(per dimension ``"series"``, ``"time"`` or None), one tensor per mesh
position this process holds.
"""

from __future__ import annotations

import numpy as np
import torch

AXES = ("series", "time")


class Mesh:
    """A ``('series', 'time')`` grid of devices (ref: ``jax.sharding.Mesh``
    over those axis names).

    ``devices`` is the global ``[n_series, n_time]`` object array,
    ``process_index`` the process holding each position, ``rank`` this
    process and ``time_group`` the :class:`~.collectives.AxisGroup` of
    the time axis when its columns span processes (else None). Meshes
    compare by identity, as the device cache keys them."""

    def __init__(self, devices: np.ndarray, process_index=None, rank: int = 0,
                 time_group=None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2:
            raise ValueError(f"a mesh is 2-D, got {devices.shape}")
        self.devices = devices
        self.axis_names = AXES
        self.process_index = (np.zeros(devices.shape, dtype=np.int64)
                              if process_index is None
                              else np.asarray(process_index))
        self.rank = rank
        self.time_group = time_group
        # the time columns this process holds (a process holds whole
        # columns: the series axis never crosses processes)
        self.local_time = [j for j in range(devices.shape[1])
                           if self.process_index[0, j] == rank]

    @property
    def shape(self) -> dict[str, int]:
        return {"series": self.devices.shape[0],
                "time": self.devices.shape[1]}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i, j]

    def positions(self) -> list[tuple[int, int]]:
        """The (series, time) positions this process holds."""
        return [(i, j) for i in range(self.devices.shape[0])
                for j in self.local_time]

    def __repr__(self) -> str:
        names = np.vectorize(str, otypes=[object])(self.devices)
        return (f"Mesh(series={self.shape['series']}, "
                f"time={self.shape['time']}, devices={names.tolist()})")


class ShardedArray:
    """A global array of ``shape`` cut over ``mesh`` by ``spec`` (one
    axis name or None per dimension): ``shards[(i, j)]`` is the block of
    mesh position ``(i, j)``, for each position this process holds.
    Dimensions the spec does not split are whole in every block."""

    __slots__ = ("mesh", "spec", "shape", "shards")

    def __init__(self, mesh: Mesh, spec: tuple, shape: tuple, shards: dict):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.shards = shards

    def __getitem__(self, pos: tuple[int, int]) -> torch.Tensor:
        return self.shards[pos]

    @property
    def nbytes(self) -> int:
        """Device bytes of the distinct shard tensors (the device
        cache's measure)."""
        distinct = {id(t): t for t in self.shards.values()}
        return sum(t.nbytes for t in distinct.values())


def block_slices(mesh: Mesh, spec: tuple, shape: tuple, i: int,
                 j: int) -> tuple:
    """The slices of the global array that position (i, j) holds."""
    index = {"series": i, "time": j}
    out = []
    for dim, axis in enumerate(spec):
        if axis is None:
            out.append(slice(None))
            continue
        n = mesh.shape[axis]
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} ({shape[dim]}) does not "
                             f"split over {n} {axis} shards")
        blk = shape[dim] // n
        out.append(slice(index[axis] * blk, (index[axis] + 1) * blk))
    return tuple(out)


def default_devices() -> list[torch.device]:
    """The visible cards, or the CPU where there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device(f"cuda:{i}") for i in range(n)] or \
        [torch.device("cpu")]


def make_mesh(n_series: int | None = None, n_time: int = 1,
              devices=None) -> Mesh:
    """Build a ('series', 'time') mesh over ``devices`` (by default
    :func:`default_devices`), which it uses whole."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else default_devices())]
    total = len(devs)
    if n_series is None:
        n_series = total // n_time
    if n_series * n_time != total:
        raise ValueError(f"mesh {n_series}x{n_time} != {total} devices")
    grid = np.empty((n_series, n_time), dtype=object)
    for k, d in enumerate(devs):
        grid[k // n_time, k % n_time] = d
    return Mesh(grid)


def mesh_from_spec(spec: str, devices=None) -> Mesh | None:
    """Parse the ``tsd.query.mesh`` config value into a query mesh over
    ``devices`` (this process's device list; by default
    :func:`default_devices`).

    Accepted forms:

    - ``""``: multi-device execution off (the single-device pipeline);
    - ``"auto"``: every device on the series axis (None over one
      device: the sharded code buys nothing there);
    - ``"series:N"`` / ``"series:N,time:M"``: an explicit shape on the
      first N*M devices.

    A shape wanting more devices than the list holds raises ValueError:
    there is no single-device fallback (the reference logs and runs
    single-device). When the process joined a multi-process rendezvous
    (:mod:`.distributed`), the time axis spans the processes: M must be
    a multiple of their count, and each process holds N x M/count
    positions on its own devices (``"auto"``: every local device on the
    series axis, one time column per process).
    """
    from opentsdb_tpu_torch.parallel import distributed
    shape = parse_mesh_spec(spec)
    if shape is None:
        return None
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else default_devices())]
    world = distributed.process_count()
    if world > 1:
        if shape == "auto":
            shape = (len(devs), world)
        n_series, n_time = shape
        if n_time % world:
            raise ValueError(
                f"tsd.query.mesh={spec!r} puts {n_time} time shards on "
                f"{world} processes; the time axis spans the processes, "
                f"so time must be a multiple of {world}")
        need = n_series * (n_time // world)
        if need > len(devs):
            raise ValueError(
                f"tsd.query.mesh={spec!r} wants {need} devices in each "
                f"of {world} processes, {len(devs)} available")
        return distributed.make_multihost_mesh(devs[:need],
                                               n_series=n_series)
    if shape == "auto":
        if len(devs) <= 1:
            return None
        return make_mesh(len(devs), 1, devices=devs)
    n_series, n_time = shape
    need = n_series * n_time
    if need > len(devs):
        raise ValueError(
            f"tsd.query.mesh={spec!r} wants {need} devices, "
            f"{len(devs)} available")
    return make_mesh(n_series, n_time, devices=devs[:need])


def parse_mesh_spec(spec: str) -> tuple[int, int] | str | None:
    """Validate a ``tsd.query.mesh`` string without touching devices:
    returns (n_series, n_time), the string ``"auto"``, or None for off.
    Called when a TSDB is built, so a typo fails at boot, not as an
    HTTP 500 on the first query."""
    spec = (spec or "").strip().lower()
    if not spec:
        return None
    if spec == "auto":
        return "auto"
    n_series = n_time = 1
    for part in spec.split(","):
        axis, _, n = part.partition(":")
        axis = axis.strip()
        if axis not in AXES:
            raise ValueError(
                f"unknown mesh axis {axis!r} in tsd.query.mesh={spec!r} "
                "(expected 'auto' or 'series:N[,time:M]')")
        try:
            count = int(n)
        except ValueError:
            raise ValueError(
                f"bad device count {n!r} for axis {axis!r} in "
                f"tsd.query.mesh={spec!r}") from None
        if count < 1:
            raise ValueError(
                f"axis {axis!r} needs >= 1 device in "
                f"tsd.query.mesh={spec!r}")
        if axis == "series":
            n_series = count
        else:
            n_time = count
    return n_series, n_time
