"""Collectives along one mesh axis: the port's counterparts of what
``shard_map`` lends the reference (``lax.psum``, ``pmin``, ``pmax``,
``all_gather`` and ``ppermute``).

Each takes the per-shard tensors of one axis that this process holds,
in shard order (``parts``), and returns one tensor per part, on that
part's device. Shards of one axis may sit on one device (a mesh over a
repeated device list) or on several.

- **Fixed order.** A reduction moves every partial to the first part's
  device and combines them in shard order, sums in float64 (int64 for
  integers) as the port's ``GroupPlan`` does, then rounds once and
  copies the result back. There is no float atomic, and no
  ``index_add_``, ``scatter_reduce_`` or float ``cumsum``: two runs
  give the same bits.
- **Across processes.** When the axis spans processes (``group``, an
  :class:`AxisGroup`; the mesh's time axis under :mod:`.distributed`),
  each process first gathers every other process's parts through
  ``torch.distributed`` on the gloo group, staged through host tensors
  (gloo's ``all_gather`` takes CPU tensors only), and then combines all
  of them in shard order as above, so every process computes the same
  bits. That axis carries only ``[S_loc]`` carry vectors and results.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AxisGroup:
    """An axis whose shards span the processes of the default
    ``torch.distributed`` group: ``world`` processes, each holding
    ``local`` consecutive shards, this one (``rank``) the shards
    ``[rank * local, (rank + 1) * local)``."""
    world: int
    rank: int
    local: int


def _host_all_gather(t: torch.Tensor, group: AxisGroup) -> list:
    """``torch.distributed.all_gather`` of ``t`` through host memory:
    one CPU tensor per process, in rank order."""
    import torch.distributed as dist
    src = t.detach().cpu()
    boolean = src.dtype == torch.bool
    if boolean:  # gloo moves no bool tensors
        src = src.to(torch.uint8)
    src = src.contiguous()
    out = [torch.empty_like(src) for _ in range(group.world)]
    dist.all_gather(out, src)
    return [o.bool() for o in out] if boolean else out


def every_shard(parts: list, group: AxisGroup | None = None) -> list:
    """Every shard of the axis in shard order: this process's ``parts``
    as they are and, when the axis spans processes, the other
    processes' as CPU tensors."""
    if group is None:
        return list(parts)
    if len(parts) != group.local:
        raise ValueError(f"{len(parts)} parts, {group.local} expected")
    gathered = _host_all_gather(torch.stack([p.cpu() for p in parts]),
                                group)
    full = [g[m] for g in gathered for m in range(group.local)]
    off = group.rank * group.local
    full[off:off + group.local] = parts
    return full


def _combine(parts: list, group, op) -> list:
    full = every_shard(parts, group)
    dev = parts[0].device
    wide = torch.float64 if full[0].is_floating_point() else torch.int64
    acc = full[0].to(dev, wide, copy=True)
    for p in full[1:]:
        acc = op(acc, p.to(dev, wide))
    acc = acc.to(parts[0].dtype)
    return [acc.to(p.device) for p in parts]


def psum(parts: list, group: AxisGroup | None = None) -> list:
    """Sum over the axis, added in shard order in float64 (int64 for
    integers) on the first part's device and rounded once."""
    return _combine(parts, group, torch.add)


def pmin(parts: list, group: AxisGroup | None = None) -> list:
    return _combine(parts, group, torch.minimum)


def pmax(parts: list, group: AxisGroup | None = None) -> list:
    return _combine(parts, group, torch.maximum)


def all_gather(parts: list, tiled: bool = False,
               group: AxisGroup | None = None) -> list:
    """Every shard's tensor, stacked on a new leading axis, or with
    ``tiled`` concatenated along axis 0, in shard order."""
    full = every_shard(parts, group)
    dev = parts[0].device
    joined = (torch.cat if tiled else torch.stack)(
        [p.to(dev) for p in full])
    return [joined.to(p.device) for p in parts]


def ppermute(parts: list, perm, group: AxisGroup | None = None) -> list:
    """Send shard ``src``'s tensor to shard ``dst`` for each
    ``(src, dst)`` of ``perm``; a shard that receives nothing gets
    zeros (``lax.ppermute``)."""
    full = every_shard(parts, group)
    src_of = {dst: src for src, dst in perm}
    off = 0 if group is None else group.rank * group.local
    out = []
    for m, p in enumerate(parts):
        src = src_of.get(off + m)
        out.append(torch.zeros_like(p) if src is None
                   else full[src].to(p.device))
    return out
