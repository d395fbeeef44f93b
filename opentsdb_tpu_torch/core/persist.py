"""Snapshots of the store under ``tsd.storage.data_dir`` (ref:
``opentsdb_tpu/core/persist.py``, snapshot format 1).

A snapshot is the UID tables (``uids.json``), the series index
(``data/series.json``: each series' metric UID, tag UID pairs and its
run of points) and the point columns (``data/points.npz``: ``ts``
int64 ms, ``vals`` float64 and ``ints`` bool, the per-point integer
flag), and last ``META.json`` with ``wal_applied_seq``, the WAL
sequence the snapshot covers. Each file is written under a temporary
name and renamed. :func:`save_store` runs on ``TSDB.flush`` and
``TSDB.shutdown``, :func:`load_store` when a TSDB starts; the WAL then
replays what the snapshot does not cover. The files are the
reference's, byte for byte for the same writes, so either package
opens the other's directory.

The reference's snapshot also holds rollup tiers, histograms,
annotations, meta and trees, which the port has not ported: their
files load when they are empty (the reference writes them so), and a
snapshot with any entry in them is refused, naming the ROADMAP Queue 1
item that ports it.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

_FORMAT_VERSION = 1


def save_store(tsdb, data_dir: str) -> int:
    """Write a full snapshot. Returns the WAL sequence it covers,
    captured before the content, so a concurrent write can only be
    covered twice (replay tolerates that), never lost."""
    tsdb.faults.check("store.flush")
    wal_seq = tsdb.wal.last_seq() if tsdb.wal is not None else 0
    os.makedirs(data_dir, exist_ok=True)
    _save_uids(tsdb.uids, data_dir)
    _save_timeseries(tsdb.store, os.path.join(data_dir, "data"))
    meta = {"format": _FORMAT_VERSION,
            "points_written": tsdb.store.points_written,
            "wal_applied_seq": wal_seq}
    _atomic_write(os.path.join(data_dir, "META.json"),
                  json.dumps(meta).encode())
    return wal_seq


def load_store(tsdb, data_dir: str) -> bool:
    """Load a snapshot into a fresh TSDB; False when there is none."""
    meta_path = os.path.join(data_dir, "META.json")
    if not os.path.isfile(meta_path):
        return False
    with open(meta_path, encoding="utf-8") as fh:
        meta = json.load(fh)
    if meta.get("format") != _FORMAT_VERSION:
        raise ValueError(f"unsupported snapshot format {meta.get('format')}")
    _refuse_unported(data_dir)
    tsdb._wal_applied_seq = int(meta.get("wal_applied_seq", 0))
    _load_uids(tsdb.uids, data_dir)
    _load_timeseries(tsdb.store, os.path.join(data_dir, "data"))
    return True


def _json(path: str):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _refuse_unported(data_dir: str) -> None:
    """Raise when the snapshot holds an entry of a subsystem the port
    lacks; the empty files the reference writes pass."""
    held = []
    for name in sorted(os.listdir(data_dir)):
        full = os.path.join(data_dir, name, "series.json")
        if name.startswith("rollup-") and os.path.isfile(full) \
                and _json(full):
            held.append((f"rollup store {name}", "rollups"))
    rest = "the rest, with no device compute"
    path = os.path.join(data_dir, "histograms.json")
    if os.path.isfile(path):
        doc = _json(path)
        if doc if isinstance(doc, list) else (doc.get("series")
                                              or doc.get("arenas")):
            held.append(("histograms",
                         "histograms and percentile sub-queries"))
    path = os.path.join(data_dir, "annotations.json")
    if os.path.isfile(path) and _json(path):
        held.append(("annotations", rest))
    path = os.path.join(data_dir, "meta.json")
    if os.path.isfile(path) and any(_json(path).values()):
        held.append(("TSMeta and UIDMeta", rest))
    path = os.path.join(data_dir, "trees.json")
    if os.path.isfile(path) and _json(path):
        held.append(("trees", rest))
    if held:
        raise NotImplementedError(
            f"the snapshot in {data_dir} holds "
            + "; ".join(f"{what}, not ported yet (ROADMAP Queue 1, "
                        f"{item})" for what, item in held))


def _atomic_write(path: str, data: bytes) -> None:
    _atomic_write_with(path, lambda fh: fh.write(data))


def _atomic_write_with(path: str, write) -> None:
    """Call ``write(file)`` on a temporary file beside ``path``, then
    rename it over ``path``."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as fh:
            write(fh)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _save_uids(uids, data_dir: str) -> None:
    doc = {}
    for kind in ("metric", "tagk", "tagv"):
        registry = uids.by_kind(kind)
        doc[kind] = {"width": registry.width,
                     "max_id": registry.max_id(),
                     "names": dict(registry.items())}
    _atomic_write(os.path.join(data_dir, "uids.json"),
                  json.dumps(doc).encode())


def _load_uids(uids, data_dir: str) -> None:
    path = os.path.join(data_dir, "uids.json")
    if not os.path.isfile(path):
        return
    doc = _json(path)
    for kind in ("metric", "tagk", "tagv"):
        entry = doc.get(kind, {})
        uids.by_kind(kind).load(
            {n: int(i) for n, i in entry.get("names", {}).items()},
            int(entry.get("max_id", 0)))


def _save_timeseries(store, directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    counts, ts, vals, ints = store.read_all()
    offsets = np.cumsum(counts) - counts
    index = [{"metric": metric_id, "tags": [list(p) for p in tags],
              "offset": int(o), "count": int(c)}
             for (metric_id, tags), o, c in zip(
                 store.series_identities(), offsets.tolist(),
                 counts.tolist())]
    _atomic_write(os.path.join(directory, "series.json"),
                  json.dumps(index).encode())
    _atomic_write_with(
        os.path.join(directory, "points.npz"),
        lambda fh: np.savez_compressed(fh, ts=ts, vals=vals,
                                       ints=ints.astype(bool)))


def _load_timeseries(store, directory: str) -> None:
    index_path = os.path.join(directory, "series.json")
    if not os.path.isfile(index_path):
        return
    index = _json(index_path)
    npz = np.load(os.path.join(directory, "points.npz"))
    all_ts, all_vals, all_ints = npz["ts"], npz["vals"], npz["ints"]
    n = len(index)
    # series in index order, one bulk creation per run of one metric,
    # so a series gets the id it had when the snapshot was written
    sids = np.empty(n, dtype=np.int64)
    lo = 0
    while lo < n:
        metric_id, hi = index[lo]["metric"], lo + 1
        while hi < n and index[hi]["metric"] == metric_id:
            hi += 1
        sids[lo:hi] = store.get_or_create_series_bulk(
            metric_id, [[tuple(p) for p in e["tags"]]
                        for e in index[lo:hi]])
        lo = hi
    counts = np.fromiter((e["count"] for e in index), np.int64, n)
    offsets = np.fromiter((e["offset"] for e in index), np.int64, n)
    starts = np.cumsum(counts) - counts
    total = int(counts.sum())
    if np.array_equal(offsets, starts):
        # the runs lie back to back in index order, as save_store
        # writes them
        all_ts, all_vals, all_ints = (a[:total] for a in
                                      (all_ts, all_vals, all_ints))
    else:
        pos = np.repeat(offsets - starts, counts) + np.arange(total)
        all_ts, all_vals, all_ints = all_ts[pos], all_vals[pos], \
            all_ints[pos]
    if n:
        store.append_lines(np.repeat(sids, counts), all_ts, all_vals,
                           all_ints)
