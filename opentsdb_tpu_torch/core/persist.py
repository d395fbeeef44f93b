"""Snapshots of the store under ``tsd.storage.data_dir`` (ref:
``opentsdb_tpu/core/persist.py``, snapshot format 1).

A snapshot is the UID tables (``uids.json``), the series index
(``data/series.json``: each series' metric UID, tag UID pairs and its
run of points), the point columns (``data/points.npz``: ``ts`` int64
ms, ``vals`` float64 and ``ints`` bool, the per-point integer flag),
the histogram points (``histograms.json``: each histogram series'
identity and each arena's columns, base64, format v2; the v1 format of
one blob per point loads too), with rollups on each rollup store in a
directory of its own laid out as ``data/`` (``rollup-<interval>-<agg>/``
per tier, ``rollup-preagg/``), and last ``META.json`` with
``wal_applied_seq``, the WAL sequence the snapshot covers. A tier the
rollup config no longer holds is skipped at load, and with rollups off
the ``rollup-*`` directories are left unread and in place, as the
reference leaves them.
:func:`save_store` runs on ``TSDB.flush`` and ``TSDB.shutdown``,
:func:`load_store` when a TSDB starts; the WAL then replays what the
snapshot does not cover. The files are the reference's, byte for byte
for the same writes, so either package opens the other's directory.

The files change together or not at all. A save stages each
file beside its target (``<name>.staged``), fsyncs them and their
directories, writes the commit marker ``SNAPSHOT.commit`` (the renames
and the WAL sequence), renames the staged files into place, fsyncs the
directories and removes the marker. A load first settles a save that
stopped half way: with a marker it finishes the renames (roll
forward), without one it deletes the staged files (roll back; the old
snapshot is whole and the WAL was not truncated, since ``TSDB.flush``
truncates only after the save). A series index whose runs do not fit
the point columns, which the reference's in-place ``points.npz``
write can leave, is refused, never served in part.

The reference's snapshot also holds annotations, meta and trees, which
the port has not ported: their files load when they are
empty (the reference writes them so), and a snapshot with any entry in
them is refused, naming the ROADMAP Queue 1 item that ports it.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import threading

import numpy as np

_FORMAT_VERSION = 1
ROLLUP_PREFIX = "rollup-"

log = logging.getLogger("persist")

MARKER = "SNAPSHOT.commit"
STAGED = ".staged"
# one save at a time in this process: the staged names are fixed
_SAVE_LOCK = threading.Lock()


def _rollup_dirs(tsdb, data_dir: str) -> list[tuple[str, object]]:
    """(directory, store) of each rollup store: ``rollup-<interval>-
    <agg>/`` per tier made so far and ``rollup-preagg/`` (ref:
    ``save_store``); none with rollups off."""
    rollups = tsdb.rollup_store
    if rollups is None:
        return []
    out = [(os.path.join(data_dir, f"{ROLLUP_PREFIX}{interval}-{agg}"), st)
           for (interval, agg), st in rollups.tiers()]
    out.append((os.path.join(data_dir, f"{ROLLUP_PREFIX}preagg"),
                rollups.preagg_store()))
    return out


def save_store(tsdb, data_dir: str) -> int:
    """Write a full snapshot, all its files at once (module docstring).
    Returns the WAL sequence it covers, captured before the scalar
    content, so a concurrent scalar write can only be covered twice
    (replay keeps the last write of a timestamp), never lost. The
    histogram arenas are read with the sequence, under the histogram
    lock that a histogram write logs under: replay adds a histogram
    point to its arena, so none may be both in the snapshot and past
    its sequence."""
    tsdb.faults.check("store.flush")
    with tsdb._histogram_lock:
        wal_seq = tsdb.wal.last_seq() if tsdb.wal is not None else 0
        hist_cols = _histogram_columns(tsdb)
    data = os.path.join(data_dir, "data")
    with _SAVE_LOCK:
        os.makedirs(data, exist_ok=True)
        # finish a swap an earlier attempt left half done before staging
        # over its files: its marker must never name a new, partial file
        _settle(data_dir)
        index, write_points = _timeseries_payload(tsdb.store)
        meta = {"format": _FORMAT_VERSION,
                "points_written": tsdb.store.points_written,
                "wal_applied_seq": wal_seq}
        files = [(os.path.join(data_dir, "uids.json"),
                  _bytes_writer(_uids_doc(tsdb.uids))),
                 (os.path.join(data, "series.json"), _bytes_writer(index)),
                 (os.path.join(data, "points.npz"), write_points),
                 (os.path.join(data_dir, "histograms.json"),
                  _bytes_writer(_histograms_doc(tsdb, hist_cols)))]
        dirs = [data]
        for directory, store in _rollup_dirs(tsdb, data_dir):
            os.makedirs(directory, exist_ok=True)
            r_index, r_write = _timeseries_payload(store)
            files += [(os.path.join(directory, "series.json"),
                       _bytes_writer(r_index)),
                      (os.path.join(directory, "points.npz"), r_write)]
            dirs.append(directory)
        files.append((os.path.join(data_dir, "META.json"),
                      _bytes_writer(json.dumps(meta).encode())))
        targets = []
        for path, write in files:
            _stage(path, write)
            targets.append(path)
        for directory in dirs + [data_dir]:
            _fsync_dir(directory)
        _write_marker(data_dir, targets, wal_seq)
        _finish(data_dir, targets)
    return wal_seq


def load_store(tsdb, data_dir: str) -> bool:
    """Load a snapshot into a fresh TSDB; False when there is none."""
    if os.path.isdir(data_dir):
        with _SAVE_LOCK:
            _settle(data_dir)
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
    _load_histograms(tsdb, data_dir)
    if tsdb.rollup_store is not None:
        _load_rollups(tsdb.rollup_store, data_dir)
    return True


def _load_rollups(rollups, data_dir: str) -> None:
    """Load each ``rollup-*`` directory into its store (ref:
    ``load_store``). A tier the config no longer holds is skipped, with
    a log line, as the reference skips it. With rollups off the caller
    leaves the directories unread and in place."""
    for name in sorted(os.listdir(data_dir)):
        full = os.path.join(data_dir, name)
        if not (name.startswith(ROLLUP_PREFIX) and os.path.isdir(full)):
            continue
        rest = name[len(ROLLUP_PREFIX):]
        if rest == "preagg":
            _load_timeseries(rollups.preagg_store(), full)
            continue
        interval, _, agg = rest.rpartition("-")
        try:
            store = rollups.tier(interval, agg)
        except ValueError as e:
            log.warning("snapshot: %s skipped: %s", full, e)
            continue
        _load_timeseries(store, full)


# -- the atomic swap ---------------------------------------------------------

def _bytes_writer(data: bytes):
    return lambda fh: fh.write(data)


def _stage(path: str, write) -> None:
    """Call ``write(file)`` on ``path + STAGED`` and fsync it."""
    with open(path + STAGED, "wb") as fh:
        write(fh)
        fh.flush()
        os.fsync(fh.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_marker(data_dir: str, targets: list[str], wal_seq: int) -> None:
    """The commit point: once ``SNAPSHOT.commit`` is whole on disk, the
    staged files are the snapshot."""
    doc = {"renames": [[os.path.relpath(t + STAGED, data_dir),
                        os.path.relpath(t, data_dir)] for t in targets],
           "wal_applied_seq": wal_seq}
    path = os.path.join(data_dir, MARKER)
    _stage(path, _bytes_writer(json.dumps(doc).encode()))
    os.replace(path + STAGED, path)
    _fsync_dir(data_dir)


def _finish(data_dir: str, targets: list[str]) -> None:
    """Rename every staged file still there into place, then remove
    the marker (steps 4-6 of a save, and the roll forward of a load)."""
    for target in targets:
        if os.path.exists(target + STAGED):
            os.replace(target + STAGED, target)
        elif not os.path.exists(target):
            raise ValueError(
                f"{os.path.join(data_dir, MARKER)} names {target}, but "
                "neither it nor its staged copy exists")
    for directory in sorted({os.path.dirname(t) for t in targets}):
        _fsync_dir(directory)
    os.unlink(os.path.join(data_dir, MARKER))
    _fsync_dir(data_dir)


def _settle(data_dir: str) -> None:
    """Finish a save that reached its marker (roll forward); delete
    the staged files of one that did not (roll back)."""
    marker = os.path.join(data_dir, MARKER)
    if os.path.isfile(marker):
        doc = _json(marker)
        _finish(data_dir, [os.path.join(data_dir, final)
                           for _, final in doc["renames"]])
    rollup_dirs = [os.path.join(data_dir, name) for name in
                   (os.listdir(data_dir) if os.path.isdir(data_dir) else ())
                   if name.startswith(ROLLUP_PREFIX)]
    for directory in [data_dir, os.path.join(data_dir, "data")] + \
            sorted(rollup_dirs):
        if not os.path.isdir(directory):
            continue
        stray = [name for name in os.listdir(directory)
                 if name.endswith(STAGED)]
        for name in stray:
            os.unlink(os.path.join(directory, name))
        if stray:
            _fsync_dir(directory)


def _json(path: str):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _refuse_unported(data_dir: str) -> None:
    """Raise when the snapshot holds an entry of a subsystem the port
    lacks; the empty files the reference writes pass."""
    held = []
    rest = "the rest, with no device compute"
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


def _uids_doc(uids) -> bytes:
    doc = {}
    for kind in ("metric", "tagk", "tagv"):
        registry = uids.by_kind(kind)
        doc[kind] = {"width": registry.width,
                     "max_id": registry.max_id(),
                     "names": dict(registry.items())}
    return json.dumps(doc).encode()


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


def _timeseries_payload(store):
    """``series.json``'s bytes and a writer of ``points.npz``."""
    counts, ts, vals, ints = store.read_all()
    offsets = np.cumsum(counts) - counts
    index = [{"metric": metric_id, "tags": [list(p) for p in tags],
              "offset": int(o), "count": int(c)}
             for (metric_id, tags), o, c in zip(
                 store.series_identities(), offsets.tolist(),
                 counts.tolist())]
    return json.dumps(index).encode(), \
        lambda fh: np.savez_compressed(fh, ts=ts, vals=vals,
                                       ints=ints.astype(bool))


def _load_timeseries(store, directory: str) -> None:
    index_path = os.path.join(directory, "series.json")
    if not os.path.isfile(index_path):
        return
    index = _json(index_path)
    npz = np.load(os.path.join(directory, "points.npz"))
    all_ts, all_vals, all_ints = npz["ts"], npz["vals"], npz["ints"]
    n = len(index)
    counts = np.fromiter((e["count"] for e in index), np.int64, n)
    offsets = np.fromiter((e["offset"] for e in index), np.int64, n)
    total, held = int(counts.sum()), len(all_ts)
    if (len(all_vals) != held or len(all_ints) != held or total != held
            or (n and (offsets.min() < 0
                       or int((offsets + counts).max()) > held))):
        # a torn swap of the two files (the reference writes points.npz
        # in place): serve none of it rather than part
        raise ValueError(
            f"torn snapshot: {index_path} indexes {total} points, but "
            f"{os.path.join(directory, 'points.npz')} holds {held} "
            f"(ts {len(all_ts)}, vals {len(all_vals)}, ints "
            f"{len(all_ints)})")
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
    starts = np.cumsum(counts) - counts
    if not np.array_equal(offsets, starts):
        # the runs are not back to back in index order, as save_store
        # writes them
        pos = np.repeat(offsets - starts, counts) + np.arange(total)
        all_ts, all_vals, all_ints = all_ts[pos], all_vals[pos], \
            all_ints[pos]
    if n:
        store.append_lines(np.repeat(sids, counts), all_ts, all_vals,
                           all_ints)


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def _histogram_columns(tsdb) -> list[tuple]:
    """Each arena's stable snapshot views, ``(metric id, bounds, ts,
    sid, rows, under, over)``; the caller holds the histogram lock, and
    the base64 work runs outside it, so writes do not wait for a
    flush."""
    return [(mid, sub.bounds, *sub.snapshot(), sub.under[:sub.n],
             sub.over[:sub.n])
            for mid, arena in tsdb._histogram_arenas.items()
            for sub in arena.groups.values()]


def _histograms_doc(tsdb, columns: list[tuple]) -> bytes:
    """``histograms.json``'s bytes (ref: ``_save_histograms``, format
    v2): each histogram series' identity, and each arena's columns
    (:func:`_histogram_columns`) as base64 of the raw int64/float64
    buffers."""
    arenas = []
    seen_sids: set[int] = set()
    for mid, bounds, ts, sid, rows, under, over in columns:
        arenas.append({"metric": mid, "bounds": list(bounds),
                       "n": int(len(ts)), "ts": _b64(ts), "sid": _b64(sid),
                       "rows": _b64(rows), "under": _b64(under),
                       "over": _b64(over)})
        seen_sids.update(int(s) for s in np.unique(sid))
    series = {}
    for s in sorted(seen_sids):
        rec = tsdb.histogram_store.series(s)
        series[str(s)] = {"metric": rec.metric_id,
                          "tags": [list(p) for p in rec.tags]}
    return json.dumps({"v": 2, "series": series, "arenas": arenas}).encode()


def _load_histograms(tsdb, data_dir: str) -> None:
    """Load ``histograms.json`` (ref: ``_load_histograms``): v2 recreates
    the series first (an old id -> new id map) and appends each arena's
    columns in bulk; the v1 legacy list holds one blob per point."""
    from opentsdb_tpu_torch.core.histogram import HistogramArena
    path = os.path.join(data_dir, "histograms.json")
    if not os.path.isfile(path):
        return
    doc = _json(path)
    if isinstance(doc, list):
        for entry in doc:
            for ts, blob in entry["points"]:
                hist = tsdb.histogram_manager.decode(base64.b64decode(blob))
                sid = tsdb.histogram_store.get_or_create_series(
                    entry["metric"], [tuple(p) for p in entry["tags"]])
                arena = tsdb._histogram_arenas.setdefault(
                    entry["metric"], HistogramArena())
                arena.append(int(ts), sid, hist)
        return
    sid_map: dict[int, int] = {}
    for old_sid, ident in doc.get("series", {}).items():
        sid_map[int(old_sid)] = tsdb.histogram_store.get_or_create_series(
            ident["metric"], [tuple(p) for p in ident["tags"]])
    if sid_map:
        old_ids = np.fromiter(sid_map, dtype=np.int64, count=len(sid_map))
        lut = np.zeros(int(old_ids.max()) + 1, dtype=np.int64)
        lut[old_ids] = np.fromiter(sid_map.values(), dtype=np.int64,
                                   count=len(sid_map))

    def column(raw: str, dtype, n: int):
        return np.frombuffer(base64.b64decode(raw), dtype=dtype)[:n]

    for entry in doc.get("arenas", []):
        n = int(entry["n"])
        nb = max(1, len(entry["bounds"]) - 1)
        ts = column(entry["ts"], np.int64, n)
        sid = column(entry["sid"], np.int64, n)
        # the under/overflow columns may be absent or empty
        under, over = (column(entry[k], np.int64, n) if entry.get(k)
                       else None for k in ("under", "over"))
        rows = np.frombuffer(base64.b64decode(entry["rows"]),
                             dtype=np.float64).reshape(-1, nb)[:n]
        arena = tsdb._histogram_arenas.setdefault(entry["metric"],
                                                  HistogramArena())
        key = tuple(entry["bounds"])
        sub = arena.groups.get(key)
        if sub is None:
            sub = arena.groups[key] = HistogramArena._Sub(key, nb)
        sub.append_many(ts, lut[sid] if len(sid) else sid, rows, under,
                        over)
        arena.total_points += n
