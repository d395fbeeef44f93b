"""Storage integrity check and repair (ref: ``src/tools/Fsck.java:83``,
``opentsdb_tpu/tools/fsck.py``).

The reference fsck walks HBase rows per salt bucket looking for bad row
keys, duplicate timestamps, orphaned or unknown cells, bad value
encodings and bad compacted columns (Fsck.java:99-119). The column
stores cannot hold most byte-level corruptions, so the checks map to
the store's own invariants:

- **unresolvable UIDs**: a series naming a metric, tagk or tagv UID the
  UID tables lack (ref: orphaned rows);
- **duplicate timestamps** and **unsorted points**: writes of the memory
  store not folded yet (``--fix`` folds them: the last write wins, ref:
  fix_duplicates); the native store sorts and dedupes as it writes, so
  it never has either;
- **non-finite values**: NaN and infinite points, which poison
  aggregations (ref: bad VLE and float encodings);
- **out-of-range timestamps**: not positive, or past the 4-byte second
  of the row-key format.

With the data lifecycle on (:mod:`opentsdb_tpu_torch.lifecycle`), fsck
also reports **expired-but-present points** (raw points older than
their metric's retention, which a sweep should have purged); ``--fix``
purges them through the lifecycle's sweep, so the mutation versions,
the snapshot and the WAL stay in step. The reference also reports
**ghost series** (no point, buffers not released); the port's stores
keep no buffer of a series, so there is none to report (ROADMAP Queue
3 item 28).

With the cold tier on (:mod:`opentsdb_tpu_torch.coldstore`), fsck checks
every manifest segment: the header and data checksums, its range
against the metric's spill boundary, a spill boundary past the demotion
boundary (which would serve the range between them twice), and orphan
segment files an interrupted spill left. ``--fix`` quarantines a corrupt
segment (renamed aside, dropped from the manifest), so queries fall back
to tier or raw data, and clamps an inconsistent boundary.

The reference scans one shard per thread (its per-salt-bucket
FsckWorker, Fsck.java:257) and reports the shards in the order their
first series comes. The port reads each store's columns once
(``fsck_columns``) and checks them with numpy, and groups and orders
its report lines by the same shards: a series' shard is the hash of its
metric and tag UIDs modulo the salt buckets, as the reference's store
assigns it (``opentsdb_tpu/core/store.py:515-520``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from opentsdb_tpu_torch.core import const


@dataclass
class FsckReport:
    errors: int = 0
    fixed: int = 0
    series_checked: int = 0
    points_checked: int = 0
    lines: list[str] = field(default_factory=list)

    def error(self, msg: str, fixed: bool = False) -> None:
        self.errors += 1
        if fixed:
            self.fixed += 1
        self.lines.append(("FIXED: " if fixed else "ERROR: ") + msg)


MAX_VALID_MS = (const.MAX_SECOND_TIMESTAMP + const.MAX_TIMESPAN) * 1000


def shard_order(identities) -> list[int]:
    """Series ids grouped by shard, the shards in the order of their
    first series and each shard's series ascending: the order of the
    reference's report (its ``shards`` dict of per-shard sid lists)."""
    buckets = const.salt_buckets()
    shards: dict[int, list[int]] = {}
    for sid, key in enumerate(identities):
        shards.setdefault(hash(key) % buckets, []).append(sid)
    return [sid for sids in shards.values() for sid in sids]


def run_fsck(tsdb, fix: bool = False) -> FsckReport:
    """Check (and with ``fix`` repair) ``tsdb``'s store, lifecycle and
    cold tier. The reference's ``workers`` thread count has no
    counterpart: the scan is one vectorized pass over the columns."""
    report = FsckReport()
    _fsck_store(tsdb, fix, report)
    _fsck_lifecycle(tsdb, fix, report)
    _fsck_coldstore(tsdb, fix, report)
    if fix and report.fixed and tsdb.data_dir:
        # make the repairs durable (ref: Fsck writes them back to
        # HBase): a snapshot of the repaired store, and the WAL it
        # covers truncated, so a replay cannot bring the points back
        tsdb.flush()
    return report


def _fsck_store(tsdb, fix: bool, report: FsckReport) -> None:
    """The per-series checks (ref: FsckWorker, Fsck.java:257)."""
    store = tsdb.store
    identities = store.series_identities()
    counts, ts, vals, unsorted, distinct = store.fsck_columns()
    n_series = len(identities)
    counts, unsorted, distinct = (counts[:n_series], unsorted[:n_series],
                                  distinct[:n_series])
    owner = np.repeat(np.arange(n_series), counts)
    bad_vals = np.bincount(owner, weights=~np.isfinite(vals),
                           minlength=n_series).astype(np.int64)
    bad_ts = np.bincount(owner, weights=(ts <= 0) | (ts > MAX_VALID_MS),
                         minlength=n_series).astype(np.int64)
    metrics = dict((i, n) for n, i in tsdb.uids.metrics.items())
    tagks = {i for _, i in tsdb.uids.tag_names.items()}
    tagvs = {i for _, i in tsdb.uids.tag_values.items()}
    report.series_checked += n_series
    report.points_checked += int(counts.sum())
    flagged = unsorted | (bad_vals > 0) | (bad_ts > 0)
    repairs: list[int] = []
    for sid in shard_order(identities):
        metric_id, tags = identities[sid]
        name = f"series {sid}"
        # UID resolution (ref: unknown or orphaned cells)
        metric = metrics.get(metric_id)
        if metric is None:
            report.error(f"{name}: unresolvable metric UID {metric_id}")
        else:
            name = f"series {sid} ({metric})"
        for kid, vid in tags:
            if kid not in tagks:
                report.error(f"{name}: unresolvable tagk UID {kid}")
            if vid not in tagvs:
                report.error(f"{name}: unresolvable tagv UID {vid}")
        if not flagged[sid] or counts[sid] == 0:
            continue
        if unsorted[sid]:
            dupes = int(counts[sid] - distinct[sid])
            if dupes > 0:
                report.error(f"{name}: {dupes} duplicate timestamp(s), "
                             "last write wins", fixed=fix)
            else:
                report.error(f"{name}: buffer out of order", fixed=fix)
        # non-finite values (ref: bad float encodings)
        if bad_vals[sid]:
            report.error(f"{name}: {int(bad_vals[sid])} non-finite "
                         "value(s)", fixed=fix)
        # timestamp range (ref: bad row keys and timestamps)
        if bad_ts[sid]:
            report.error(f"{name}: {int(bad_ts[sid])} timestamp(s) out of "
                         "range", fixed=fix)
        if bad_vals[sid] or bad_ts[sid]:
            repairs.append(sid)
    if fix:
        if unsorted.any():
            # the sort and the last-write-wins dedupe (only the memory
            # store has writes to fold)
            store.fold()
        for sid in repairs:
            # in place on either store (ref: Fsck.java:99-119)
            store.repair_series(sid, 1, MAX_VALID_MS, drop_nonfinite=True)


def _fsck_lifecycle(tsdb, fix: bool, report: FsckReport) -> None:
    """Expired-but-present points, when the lifecycle is on. The repair
    goes through the lifecycle's sweep, never a delete of its own, so
    the versions, the snapshot and the WAL stay in step."""
    lc = tsdb.lifecycle
    if lc is None:
        return
    expired = lc.scan_expired()
    for metric in sorted(expired):
        report.error(
            f"metric {metric}: {expired[metric]} expired-but-present "
            f"point(s) past the retention TTL", fixed=fix)
    if fix and expired:
        lc.sweep()


def _fsck_coldstore(tsdb, fix: bool, report: FsckReport) -> None:
    """Cold-tier segment integrity (module docstring). The repairs go
    through the cold store's own quarantine and clamp, so its manifest
    stays atomic and its version bumps."""
    lc = tsdb.lifecycle
    cold = lc.coldstore if lc is not None else None
    if cold is None:
        return
    boundaries: dict[str, int] = {}
    with lc._lock:
        mids = dict(lc._boundaries)
    for mid, b in mids.items():
        try:
            boundaries[tsdb.uids.metrics.get_name(mid)] = b
        except LookupError:
            continue
    for finding in cold.fsck_scan(boundaries):
        what = finding["file"] or "manifest"
        msg = f"cold segment {what}: {finding['problem']}"
        if not fix or finding["fix"] == "report":
            # a "report" finding has no safe repair (a lost
            # lifecycle.json: quarantining healthy segments would
            # destroy servable history)
            report.error(msg)
            continue
        if finding["fix"] == "quarantine":
            fixed = cold.quarantine(finding["metric"], finding["file"])
        elif finding["fix"] == "clamp":
            fixed = cold.clamp_boundary(finding["metric"],
                                        finding["boundary"])
        else:  # an orphan file of an interrupted spill
            cold.remove_orphan(finding["file"])
            fixed = True
        report.error(msg, fixed=fixed)
