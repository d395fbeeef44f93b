"""DDSketch: a mergeable quantile sketch with relative-error bounds
(ref: ``opentsdb_tpu/sketch/ddsketch.py``; its bytes are the
reference's).

Chosen over KLL because its guarantee is *relative* (a q-quantile
estimate within ``alpha`` of the true value, for any q) which is the
right contract for latency-shaped data, its merge is a plain per-bucket
count addition (exactly associative and commutative as long as counts
stay integral, which they do below 2^53 in float64), and its state is
tiny and trivially serializable. KLL's rank-error guarantee is stronger
in the tails only if you keep raw samples around; its merge involves
randomized compaction, which would break the "router merge is bit-equal
to a single-node sketch" property this subsystem promises.

State is canonical: sparse sorted (bucket_index, count) parallel arrays
for the positive and negative stores plus a zero count, exact running
count/min/max. Because merge unions indices and adds integral counts,
any merge order over the same multiset of points produces the *same*
canonical state, hence the same serialized bytes and the same extracted
quantiles — merging per-shard partials at the router is bit-equal to
folding all points on one node.

Bucket ``i`` covers ``(gamma^(i-1), gamma^i]`` with
``gamma = (1 + alpha) / (1 - alpha)``; the estimate for a bucket is the
midpoint ``2 * gamma^i / (gamma + 1)``, within ``alpha`` relative error
of every value in the bucket. Values in ``[-MIN_INDEXABLE,
MIN_INDEXABLE]`` land in the zero bucket (estimate 0.0); negatives
mirror into their own store. NaNs are skipped at fold time.

Collapsing (``tsd.sketch.max_buckets``) only ever happens at *fold*
time, never at merge time: a merge of uncollapsed sketches is exact, so
distribution over shards/tiers cannot change the answer.
"""

from __future__ import annotations

import base64
import math
import struct

import numpy as np

# values at or below this magnitude are not indexable (log would
# explode the index range) and count as exact zeros
MIN_INDEXABLE = 1e-12

DEFAULT_ALPHA = 0.01
DEFAULT_MAX_BUCKETS = 4096

_MAGIC = b"DDSK"
_VERSION = 1
# magic, version u8, pad, n_pos u16... use u32s for safety:
# alpha f64, zero f64, count f64, min f64, max f64, n_pos u32, n_neg u32
_HDR = struct.Struct("<4sBxxxdddddII")


class SketchError(ValueError):
    """Raised on alpha mismatch or a corrupt serialized sketch."""


class DDSketch:
    """One mergeable quantile sketch. Not thread-safe; callers own
    locking (the stores that hold sketches guard them)."""

    __slots__ = ("alpha", "gamma", "_lg", "pos_idx", "pos_cnt",
                 "neg_idx", "neg_cnt", "zero_count", "count",
                 "min", "max")

    def __init__(self, alpha: float = DEFAULT_ALPHA):
        if not (0.0 < alpha < 1.0):
            raise SketchError(f"alpha out of range: {alpha!r}")
        self.alpha = float(alpha)
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self.gamma)
        self.pos_idx = np.empty(0, dtype=np.int32)
        self.pos_cnt = np.empty(0, dtype=np.float64)
        self.neg_idx = np.empty(0, dtype=np.int32)
        self.neg_cnt = np.empty(0, dtype=np.float64)
        self.zero_count = 0.0
        self.count = 0.0
        self.min = math.inf
        self.max = -math.inf

    # ------------------------------------------------------------------
    # folding
    # ------------------------------------------------------------------

    def _keys(self, mags: np.ndarray) -> np.ndarray:
        """Bucket indices for positive magnitudes (vectorized)."""
        return np.ceil(np.log(mags) / self._lg).astype(np.int32)

    def add_values(self, values: np.ndarray) -> None:
        """Fold a column of raw values (NaNs skipped) into the sketch."""
        v = np.asarray(values, dtype=np.float64)
        v = v[np.isfinite(v)]
        if not len(v):
            return
        pos = v > MIN_INDEXABLE
        neg = v < -MIN_INDEXABLE
        nzero = int(len(v) - int(pos.sum()) - int(neg.sum()))
        if nzero:
            self.zero_count += nzero
        if pos.any():
            idx, cnt = np.unique(self._keys(v[pos]), return_counts=True)
            self.pos_idx, self.pos_cnt = _merge_store(
                self.pos_idx, self.pos_cnt, idx, cnt.astype(np.float64))
        if neg.any():
            idx, cnt = np.unique(self._keys(-v[neg]), return_counts=True)
            self.neg_idx, self.neg_cnt = _merge_store(
                self.neg_idx, self.neg_cnt, idx, cnt.astype(np.float64))
        self.count += len(v)
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))

    def add(self, value: float) -> None:
        self.add_values(np.asarray([value]))

    def add_weighted(self, values: np.ndarray,
                     weights: np.ndarray) -> None:
        """Fold pre-counted values (histogram bucket midpoints with
        their counts). Rows with non-finite values or non-positive
        weights are skipped."""
        v = np.asarray(values, dtype=np.float64)
        w = np.asarray(weights, dtype=np.float64)
        keep = np.isfinite(v) & (w > 0)
        v, w = v[keep], w[keep]
        if not len(v):
            return
        pos = v > MIN_INDEXABLE
        neg = v < -MIN_INDEXABLE
        zero = ~pos & ~neg
        if zero.any():
            self.zero_count += float(w[zero].sum())
        for mask, flip, store in ((pos, 1.0, "pos"), (neg, -1.0,
                                                      "neg")):
            if not mask.any():
                continue
            idx, inv = np.unique(self._keys(flip * v[mask]),
                                 return_inverse=True)
            cnt = np.zeros(len(idx), dtype=np.float64)
            np.add.at(cnt, inv, w[mask])
            if store == "pos":
                self.pos_idx, self.pos_cnt = _merge_store(
                    self.pos_idx, self.pos_cnt, idx, cnt)
            else:
                self.neg_idx, self.neg_cnt = _merge_store(
                    self.neg_idx, self.neg_cnt, idx, cnt)
        self.count += float(w.sum())
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))

    # ------------------------------------------------------------------
    # merge
    # ------------------------------------------------------------------

    def merge(self, other: "DDSketch") -> None:
        """Exact in-place merge (per-bucket count addition). Merge
        order cannot change the resulting canonical state."""
        if other.count == 0:
            return
        if abs(other.alpha - self.alpha) > 1e-12:
            raise SketchError(
                f"alpha mismatch: {self.alpha} vs {other.alpha}")
        self.pos_idx, self.pos_cnt = _merge_store(
            self.pos_idx, self.pos_cnt, other.pos_idx, other.pos_cnt)
        self.neg_idx, self.neg_cnt = _merge_store(
            self.neg_idx, self.neg_cnt, other.neg_idx, other.neg_cnt)
        self.zero_count += other.zero_count
        self.count += other.count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def copy(self) -> "DDSketch":
        out = DDSketch(self.alpha)
        out.pos_idx = self.pos_idx.copy()
        out.pos_cnt = self.pos_cnt.copy()
        out.neg_idx = self.neg_idx.copy()
        out.neg_cnt = self.neg_cnt.copy()
        out.zero_count = self.zero_count
        out.count = self.count
        out.min = self.min
        out.max = self.max
        return out

    # ------------------------------------------------------------------
    # collapsing (fold-time only)
    # ------------------------------------------------------------------

    def collapse(self, max_buckets: int) -> None:
        """Bound memory by folding the *lowest* buckets of whichever
        store is largest into its lowest kept bucket (the standard
        DDSketch policy: the relative-error guarantee survives for
        every quantile whose value lands at or above the collapse
        point — in latency data, all the ones anybody asks for).
        Called at fold time only; merges never collapse."""
        while len(self.pos_idx) + len(self.neg_idx) > max_buckets:
            # the negative store's lowest-magnitude buckets are the
            # *highest* values of that store; collapsing must eat the
            # lowest VALUES overall, which for negatives means the
            # highest magnitudes (largest indices)
            if len(self.neg_idx) == 1:
                # last negative bucket: fold toward the zero bucket
                self.zero_count += float(self.neg_cnt[0])
                self.neg_idx = self.neg_idx[:0]
                self.neg_cnt = self.neg_cnt[:0]
            elif len(self.neg_idx):
                keep = len(self.neg_idx) - 1
                self.neg_cnt[keep - 1] += self.neg_cnt[keep]
                self.neg_idx = self.neg_idx[:keep]
                self.neg_cnt = self.neg_cnt[:keep]
            else:
                cnt0 = float(self.pos_cnt[0])
                self.pos_idx = self.pos_idx[1:]
                self.pos_cnt = self.pos_cnt[1:].copy()
                if len(self.pos_cnt):
                    self.pos_cnt[0] += cnt0
                else:
                    self.zero_count += cnt0

    # ------------------------------------------------------------------
    # extraction
    # ------------------------------------------------------------------

    def _bucket_value(self, idx: int) -> float:
        return 2.0 * (self.gamma ** idx) / (self.gamma + 1.0)

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` (percent, 0..100) — NaN when empty.
        Within ``alpha`` relative error of the true quantile of the
        folded population (exact for min/max and the zero bucket)."""
        if self.count == 0:
            return math.nan
        rank = (q / 100.0) * (self.count - 1.0)
        cum = 0.0
        # ascending value order: negatives from the most negative
        # (largest index) up, then zero, then positives ascending
        for i in range(len(self.neg_idx) - 1, -1, -1):
            cum += float(self.neg_cnt[i])
            if cum > rank:
                return self._clamp(-self._bucket_value(
                    int(self.neg_idx[i])))
        cum += self.zero_count
        if cum > rank:
            return self._clamp(0.0)
        for i in range(len(self.pos_idx)):
            cum += float(self.pos_cnt[i])
            if cum > rank:
                return self._clamp(self._bucket_value(
                    int(self.pos_idx[i])))
        return self.max

    def quantiles(self, qs) -> list[float]:
        return [self.quantile(q) for q in qs]

    def _clamp(self, v: float) -> float:
        return min(max(v, self.min), self.max)

    # ------------------------------------------------------------------
    # serialization (deterministic little-endian binary)
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        head = _HDR.pack(_MAGIC, _VERSION, self.alpha, self.zero_count,
                         self.count, self.min, self.max,
                         len(self.pos_idx), len(self.neg_idx))
        return b"".join((
            head,
            np.ascontiguousarray(self.pos_idx, dtype="<i4").tobytes(),
            np.ascontiguousarray(self.pos_cnt, dtype="<f8").tobytes(),
            np.ascontiguousarray(self.neg_idx, dtype="<i4").tobytes(),
            np.ascontiguousarray(self.neg_cnt, dtype="<f8").tobytes(),
        ))

    @classmethod
    def from_bytes(cls, blob: bytes) -> "DDSketch":
        if len(blob) < _HDR.size:
            raise SketchError("sketch blob truncated")
        (magic, ver, alpha, zero, count, mn, mx,
         n_pos, n_neg) = _HDR.unpack_from(blob)
        if magic != _MAGIC or ver != _VERSION:
            raise SketchError(
                f"bad sketch header {magic!r} v{ver}")
        need = _HDR.size + 12 * (n_pos + n_neg)
        if len(blob) != need:
            raise SketchError(
                f"sketch blob length {len(blob)} != {need}")
        out = cls(alpha)
        off = _HDR.size
        out.pos_idx = np.frombuffer(blob, "<i4", n_pos, off) \
            .astype(np.int32)
        off += 4 * n_pos
        out.pos_cnt = np.frombuffer(blob, "<f8", n_pos, off) \
            .astype(np.float64)
        off += 8 * n_pos
        out.neg_idx = np.frombuffer(blob, "<i4", n_neg, off) \
            .astype(np.int32)
        off += 4 * n_neg
        out.neg_cnt = np.frombuffer(blob, "<f8", n_neg, off) \
            .astype(np.float64)
        out.zero_count = zero
        out.count = count
        out.min = mn
        out.max = mx
        return out

    def to_b64(self) -> str:
        return base64.b64encode(self.to_bytes()).decode("ascii")

    @classmethod
    def from_b64(cls, text: str) -> "DDSketch":
        return cls.from_bytes(base64.b64decode(text))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"DDSketch(alpha={self.alpha}, count={self.count}, "
                f"buckets={len(self.pos_idx) + len(self.neg_idx)})")


def _merge_store(idx_a: np.ndarray, cnt_a: np.ndarray,
                 idx_b: np.ndarray, cnt_b: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Union two sorted sparse (index, count) stores, adding counts of
    shared indices. Output is sorted unique — the canonical form."""
    if not len(idx_a):
        return idx_b.astype(np.int32), cnt_b.astype(np.float64)
    if not len(idx_b):
        return idx_a, cnt_a
    all_idx = np.concatenate([idx_a, idx_b])
    all_cnt = np.concatenate([cnt_a, cnt_b])
    uniq, inv = np.unique(all_idx, return_inverse=True)
    cnt = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(cnt, inv, all_cnt)
    return uniq.astype(np.int32), cnt


def merge_all(sketches, alpha: float | None = None) -> DDSketch:
    """Merge an iterable of sketches into a fresh one (the identity
    sketch when empty — callers supply alpha for that case)."""
    it = iter(sketches)
    first = next(it, None)
    if first is None:
        return DDSketch(alpha if alpha is not None else DEFAULT_ALPHA)
    out = first.copy()
    for s in it:
        out.merge(s)
    return out
