"""Device functions of the histogram query path (ref:
``opentsdb_tpu/ops/histogram_kernels.py``; ``src/core/
HistogramAggregationIterator.java:319``, the query-time bucket-wise SUM,
and ``SimpleHistogram.percentile`` :133).

A batch of histogram points is a ``[N, NB]`` float64 count matrix on
the device. :func:`merge_histograms` sums its rows into segments (one
per group and output timestamp) and :func:`percentiles_from_merged`
turns each merged row into percentiles by a cumulative count and a
rank compare over the bucket axis.

Both are PyTorch on the device, with no hand kernel: the reference's
versions are XLA (``jax.jit``), not Pallas. Both work in float64, where
the codec's integer counts (u64) add exactly below 2^53: the group sums
(:class:`~opentsdb_tpu_torch.ops.groupby.GroupPlan`, in a fixed order)
and the running ``cumsum`` give the same bits in any order of
additions, so the answer equals the host's float64
``percentiles_from_counts`` bit for bit on every call. The reference's
device path casts the counts to float32 first, which rounds a merged
count past 2^24 (ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch

from opentsdb_tpu_torch.ops.groupby import GroupPlan

# calls of each device function, for a caller that shows which ran (set
# them to 0 to reset)
CALLS = {"merge_histograms": 0, "percentiles_from_merged": 0}


def merge_histograms(counts: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Bucket-wise SUM of histogram rows into segments: counts [N, NB]
    float64, seg_ids [N] -> [num_segments, NB] float64, empty segments
    0. A fixed-order group sum (``GroupPlan``), never a dense one-hot:
    that one would be [N, num_segments]."""
    CALLS["merge_histograms"] += 1
    plan = GroupPlan(seg_ids.to(counts.device), num_segments)
    return plan.sum(counts.to(torch.float64))


def percentiles_from_merged(merged: torch.Tensor, mids: torch.Tensor,
                            qs) -> torch.Tensor:
    """merged [S, NB] float64 counts, mids [NB] bucket midpoints, qs
    (percentiles 0-100) -> [Q, S] float64.

    The midpoint convention of ``SimpleHistogram.percentile`` (:133),
    as ``percentiles_from_counts`` computes it: the target rank is
    ``total * (q / 100.0)``, the bucket is the count of cumulative
    counts below it (clipped to the last bucket), and an empty segment
    gives 0."""
    CALLS["percentiles_from_merged"] += 1
    merged = merged.to(torch.float64)
    totals = merged.sum(dim=1)                            # [S]
    cum = torch.cumsum(merged, dim=1)                     # [S, NB]
    frac = torch.tensor([float(q) / 100.0 for q in qs],
                        dtype=torch.float64, device=merged.device)
    target = totals[None, :] * frac[:, None]              # [Q, S]
    idx = (cum[None, :, :] < target[:, :, None]).sum(dim=2)
    idx = idx.clamp_(max=mids.shape[0] - 1)
    out = mids.to(torch.float64)[idx]
    return torch.where(totals[None, :] > 0, out, torch.zeros_like(out))


def bucket_mids(bounds) -> np.ndarray:
    """[NB] float64 midpoints of ``bounds`` [NB + 1]."""
    b = np.asarray(bounds, dtype=np.float64)
    return (b[:-1] + b[1:]) / 2.0


def histogram_percentile_pipeline(counts, seg_ids, num_segments: int,
                                  bounds, qs,
                                  device: torch.device | str | None = None
                                  ) -> np.ndarray:
    """Host entry: merge and percentiles in one device round trip.

    counts [N, NB] (a device tensor, e.g. a cache hit, or a host
    array, uploaded to ``device``), seg_ids [N] (group * T + time
    slot), bounds [NB + 1] -> [Q, num_segments] float64 on the host.
    Nothing is padded: the reference pads N and the segment count to
    shape buckets only to spare XLA recompiles."""
    if isinstance(counts, torch.Tensor):
        dev = counts.device
    else:
        dev = torch.device(device if device is not None else "cuda")
        counts = torch.from_numpy(np.ascontiguousarray(
            counts, dtype=np.float64)).to(dev)
    seg = torch.from_numpy(np.ascontiguousarray(
        seg_ids, dtype=np.int64)).to(dev)
    merged = merge_histograms(counts, seg, num_segments)
    mids = torch.from_numpy(bucket_mids(bounds)).to(dev)
    return percentiles_from_merged(merged, mids, qs).cpu().numpy()
