"""The port's snapshots (``opentsdb_tpu_torch/core/persist.py``)
against the JAX package's (``opentsdb_tpu/core/persist.py``, format 1),
on the CPU.

- Byte compatibility: the same writes (``tests/test_torch_wal.py``'s
  ``write_all``, from a seed) flushed by both packages give equal
  ``uids.json``, ``data/series.json`` and ``META.json`` bytes, and
  ``data/points.npz`` arrays equal bit for bit.
- Cross-reading: a directory either package wrote (a snapshot plus an
  unflushed WAL tail, the log closed without a flush) opens in the
  other, with the points equal bit for bit and each package's answer
  equal to the one it gives on its own directory.
- Annotations, meta and trees: a reference snapshot holding them loads
  into the port equal to the reference's own load; the empty files the
  reference writes load (histograms load:
  ``tests/test_torch_histogram.py``; both directions in
  ``tests/test_torch_memory_durability.py``).
- Rollup stores: the ``rollup-*`` directories equal the reference's
  for the same writes and cross-read; a tier the config no longer holds
  is skipped, and with rollups off the directories are left in place;
  the crash-after-each-step test again with the rollup stores' files
  in the swap.
- Flush and shutdown: the flush retry policy, a flush without a
  data_dir, shutdown's flush.
- The atomic swap of the seven files (the annotations' and the meta's
  among them): a save crashed after each of its steps (each staged
  file, the commit marker, each rename, the marker's removal) leaves a
  directory from which a reopened TSDB reads back every acknowledged
  point, histogram point and annotation, each in its own series;
  a series index whose runs do not fit the point columns, with no
  marker, is refused by name.
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from test_torch_histogram import blob, hist_state
from test_torch_wal import (ROLLUPS, T0, answers, assert_same_series,
                            jtsdb, ptsdb, rollup_state, same_bits, segments,
                            series_of, write_all, write_rollups)

from opentsdb_tpu_torch.core import persist
from opentsdb_tpu_torch.meta.annotation import Annotation
from opentsdb_tpu_torch.utils.faults import InjectedFault

FILES = ("uids.json", "data/series.json", "META.json")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_bytes_equal_reference(tmp_path, seed):
    j, p = jtsdb(tmp_path / "j"), ptsdb(tmp_path / "p")
    for t in (j, p):
        write_all(t, seed)
        t.flush()
    for name in FILES:
        want = (tmp_path / "j" / name).read_bytes()
        assert (tmp_path / "p" / name).read_bytes() == want, name
    jz = np.load(tmp_path / "j" / "data" / "points.npz")
    pz = np.load(tmp_path / "p" / "data" / "points.npz")
    assert sorted(jz.files) == sorted(pz.files) == ["ints", "ts", "vals"]
    for name in jz.files:
        assert jz[name].dtype == pz[name].dtype
        np.testing.assert_array_equal(
            pz[name].view(np.int64) if name == "vals" else pz[name],
            jz[name].view(np.int64) if name == "vals" else jz[name])
    # the flush truncated both logs alike
    assert [s.name for s in segments(tmp_path / "j")] == \
        [s.name for s in segments(tmp_path / "p")]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_plus_tail_cross_reads(tmp_path, writer):
    make_w, make_r = (jtsdb, ptsdb) if writer == "jax" else (ptsdb, jtsdb)
    for d, make in ((tmp_path / "theirs", make_w),
                    (tmp_path / "mine", make_r)):
        t = make(d)
        write_all(t, 7)
        t.flush()
        # an unflushed tail: out of order, a new series, a new metric
        t.add_point("w.a", T0 + 30, 4.5, {"host": "h0"})
        t.add_points("w.e", T0 + 60 * np.arange(3), np.arange(3) * 2,
                     {"host": "h9"})
        t.wal.close()
        if d.name == "theirs":
            w = t
    r = make_r(tmp_path / "theirs")
    own = make_r(tmp_path / "mine")
    assert_same_series(series_of(r), series_of(w))
    assert_same_series(series_of(r), series_of(own))
    same_bits(answers(r), answers(own))


def test_empty_reference_files_load(tmp_path):
    """A JAX snapshot with rollups on holds empty rollup stores and the
    empty histogram, annotation and meta files: the port opens it."""
    j = jtsdb(tmp_path, **{"tsd.rollups.enable": "true"})
    j.add_point("m", T0, 1, {"h": "a"})
    j.flush()
    names = {p.name for p in tmp_path.iterdir()}
    assert {"annotations.json", "histograms.json", "meta.json"} <= names
    assert any(n.startswith("rollup-") for n in names)
    t = ptsdb(tmp_path)
    assert t.store.series_points(0)[1].tolist() == [1.0]


def _reference_entries(d: Path, name: str) -> None:
    """The reference's snapshot in ``d`` with entries of ``name``."""
    keys = {"tsd.core.meta.enable_realtime_ts": "true",
            "tsd.core.meta.enable_realtime_uid": "true"} \
        if name == "meta" else {}
    j = jtsdb(d, **keys)
    j.add_point("m", T0, 1, {"h": "a"})
    if name == "annotations":
        from opentsdb_tpu.meta.annotation import Annotation as JNote
        j.annotations.store(JNote("", T0, 0, "deploy", "n", {"k": "v"}))
        tsuid = j.uids.tsuid(1, [(1, 1)]).hex().upper()
        j.annotations.store(JNote(tsuid, T0 + 60, T0 + 90, "spike"))
    elif name == "trees":
        from opentsdb_tpu.tree.tree import TreeRule, tree_manager
        tree = tree_manager(j).create_tree("by metric", "d")
        tree.set_rule(TreeRule(type="METRIC", separator="."))
        tree.set_rule(TreeRule(level=1, type="TAGK", field="h"))
    j.shutdown()


def _entries_of(t, name: str):
    """What a TSDB of either package loaded of ``name``."""
    if name == "annotations":
        return sorted((tsuid, a.start_time, a.end_time, a.description,
                       a.notes, a.custom)
                      for tsuid, by_time in t.annotations._by_tsuid.items()
                      for a in by_time.values())
    if name == "meta":
        return ({k: v.to_json() for k, v in t.meta.ts_meta.items()},
                {k: v.to_json() for k, v in t.meta.uid_meta.items()},
                dict(t.meta.ts_counters))
    return [tree.to_json() for tree in t._tree_manager.all_trees()]


@pytest.mark.parametrize("name", ["rollup", "annotations", "meta",
                                  "trees"])
def test_snapshot_refuses_unported_entries(tmp_path, name):
    """No longer refused: a reference snapshot with annotations, meta
    documents or trees loads into the port equal to the reference's own
    load of it. Rollup stores: with rollups off their directories are
    left unread and in place, as the reference leaves them."""
    if name == "rollup":
        t = ptsdb(tmp_path)
        t.add_point("m", T0, 1, {"h": "a"})
        t.shutdown()
        (tmp_path / "rollup-1m-sum").mkdir()
        (tmp_path / "rollup-1m-sum" / "series.json").write_text(
            json.dumps([{"metric": 1, "tags": [[1, 1]], "offset": 0,
                         "count": 1}]))
        t = ptsdb(tmp_path)
        assert t.rollup_store is None
        assert t.store.series_points(0)[1].tolist() == [1.0]
        t.shutdown()
        assert (tmp_path / "rollup-1m-sum" / "series.json").is_file()
        return
    _reference_entries(tmp_path, name)
    got = _entries_of(ptsdb(tmp_path), name)
    assert got and got == _entries_of(jtsdb(tmp_path), name)


def test_snapshot_keeps_series_ids_flags_and_uids(tmp_path):
    t = ptsdb(tmp_path)
    write_all(t, 4)
    want = {sid: t.store.series_points(sid)
            for sid in range(t.store.num_series())}
    ids = t.store.series_identities()
    t.shutdown()
    assert not segments(tmp_path)       # shutdown flushed and truncated
    t2 = ptsdb(tmp_path)
    assert t2.recovery["points_replayed"] == 0
    assert t2.store.series_identities() == ids
    for sid, (ts, vals, ints) in want.items():
        got = t2.store.series_points(sid)
        np.testing.assert_array_equal(got[0], ts)
        np.testing.assert_array_equal(got[1].view(np.int64),
                                      vals.view(np.int64))
        np.testing.assert_array_equal(got[2], ints)
    for kind in ("metric", "tagk", "tagv"):
        a, b = t.uids.by_kind(kind), t2.uids.by_kind(kind)
        assert a.items() == b.items() and a.max_id() == b.max_id()


def test_load_gathers_runs_stored_out_of_order(tmp_path):
    """An index whose runs are not back to back in its order (a valid
    format-1 file) loads each series' own points."""
    t = ptsdb(tmp_path)
    t.add_points("m", [T0, T0 + 1], [1.0, 2.0], {"h": "a"})
    t.add_points("m", [T0, T0 + 1, T0 + 2], [3.0, 4.0, 5.0], {"h": "b"})
    t.shutdown()
    d = tmp_path / "data"
    index = json.loads((d / "series.json").read_text())
    z = np.load(d / "points.npz")
    # store series b's run first
    order = np.r_[2:5, 0:2]
    index[0]["offset"], index[1]["offset"] = 3, 0
    (d / "series.json").write_text(json.dumps(index))
    np.savez_compressed(d / "points.npz", ts=z["ts"][order],
                        vals=z["vals"][order], ints=z["ints"][order])
    t2 = ptsdb(tmp_path)
    assert t2.store.series_points(0)[1].tolist() == [1.0, 2.0]
    assert t2.store.series_points(1)[1].tolist() == [3.0, 4.0, 5.0]


@pytest.mark.parametrize("failures,ok", [(2, True), (5, False)])
def test_flush_retries_under_its_policy(tmp_path, failures, ok):
    """``tsd.storage.flush.retry`` (3 attempts by default) absorbs two
    injected failures of the snapshot; five exhaust it and raise."""
    t = ptsdb(tmp_path, **{"tsd.faults.store.flush_error_count":
                           str(failures),
                           "tsd.storage.flush.retry.base_ms": "1"})
    t.add_point("m", T0, 1, {"h": "a"})
    if ok:
        t.flush()
        assert (tmp_path / "META.json").exists()
        assert not segments(tmp_path)
    else:
        with pytest.raises(InjectedFault):
            t.flush()
        assert not (tmp_path / "META.json").exists()
        assert segments(tmp_path)        # the log still holds the point
    assert t.faults.health_info()["sites"]["store.flush"]["calls"] == \
        (failures + 1 if ok else 3)


def test_flush_without_data_dir_writes_nothing(tmp_path, monkeypatch):
    from opentsdb_tpu_torch import TSDB, Config
    t = TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.core.auto_create_metrics": "true"}))
    t.add_point("m", T0, 1, {"h": "a"})
    monkeypatch.setattr(persist, "save_store", None)   # must not run
    t.flush()
    t.shutdown()
    assert t.wal is None and not list(tmp_path.iterdir())


# -- the atomic swap ---------------------------------------------------------

class Crash(BaseException):
    """The process dies here: no retry ladder catches it."""


def _note(t, phase: int) -> None:
    """A global annotation per phase, in either package, through its
    store (logged to the WAL)."""
    cls = Annotation
    if type(t).__module__.startswith("opentsdb_tpu."):
        from opentsdb_tpu.meta.annotation import Annotation as cls
    t.annotations.store(cls("", T0 + phase, 0, f"phase {phase}"))


def notes_state(t) -> list:
    return [(a.start_time, a.description)
            for a in t.annotations.global_range(0, 2 * T0)]


def _run1(t, phase):
    hosts = ("a",) if phase == 0 else ("b",)
    for h in hosts:
        t.add_points("m", T0 + 60 * np.arange(10), np.arange(10.0) + ord(h),
                     {"host": h})
        t.add_histogram_point("hm", T0, blob(np.arange(8) + ord(h)),
                              {"host": h})
    _note(t, phase)


def _run2(t, phase):
    if phase == 0:
        for h in ("a", "b"):
            t.add_points("m", T0 + 60 * np.arange(10),
                         np.arange(10.0) + ord(h), {"host": h})
        t.add_histogram_batch([("hm", T0 + 60 * k, blob(np.arange(8) + k),
                                {"host": "a"}) for k in range(3)])
    else:
        t.add_points("m", T0 + 60 * np.arange(10, 15),
                     np.arange(10.0, 15.0) + 100, {"host": "a"})
        t.add_histogram_point("hm", T0 + 600, blob(np.arange(8) * 3),
                              {"host": "a"})
    _note(t, phase)


RUNS = {"run1": _run1, "run2": _run2}
# each step of a save: the seven staged files (uids, data's two,
# histograms, annotations, meta, META), the marker staged, the marker
# in place, each rename, the marker removed (the WAL untruncated)
CRASH_POINTS = ([f"stage:{k}" for k in range(1, 9)] + ["marker"]
                + [f"rename:{k}" for k in range(1, 8)] + ["saved"])


def _crash_at(monkeypatch, t, point):
    kind, _, k = point.partition(":")
    calls = {"n": 0}

    def after(real, counted=lambda *a: True):
        def wrapped(*args):
            out = real(*args)
            if counted(*args):
                calls["n"] += 1
                if calls["n"] == int(k or 1):
                    raise Crash(point)
            return out
        return wrapped

    if kind == "stage":
        monkeypatch.setattr(persist, "_stage", after(persist._stage))
    elif kind == "marker":
        monkeypatch.setattr(persist, "_write_marker",
                            after(persist._write_marker))
    elif kind == "rename":
        monkeypatch.setattr(persist.os, "replace", after(
            os.replace, lambda src, dst: not dst.endswith(persist.MARKER)))
    else:
        monkeypatch.setattr(t.wal, "truncate", after(lambda seq: None))


@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("run", sorted(RUNS))
def test_crashed_save_reads_every_point_back(tmp_path, monkeypatch, run,
                                             point):
    write = RUNS[run]
    t = ptsdb(tmp_path / "d")
    write(t, 0)
    t.flush()
    write(t, 1)
    with monkeypatch.context() as m:
        _crash_at(m, t, point)
        with pytest.raises(Crash):
            t.flush()
    t.wal.close()                       # the process is gone
    staged = [p.name for p in (tmp_path / "d").rglob("*.staged")]
    marker = (tmp_path / "d" / persist.MARKER).exists()
    assert marker == (point.startswith("rename") or point == "marker")
    assert bool(staged) == (point not in ("rename:7", "saved"))
    want = ptsdb(tmp_path / "w")
    write(want, 0)
    write(want, 1)
    got = ptsdb(tmp_path / "d")
    assert not list((tmp_path / "d").rglob("*.staged"))
    assert not (tmp_path / "d" / persist.MARKER).exists()
    assert_same_series(series_of(got), series_of(want))
    assert hist_state(got) == hist_state(want) != {}
    assert notes_state(got) == notes_state(want) != []
    # the settled directory is a whole snapshot again, which the
    # reference opens
    got.shutdown()
    ref = jtsdb(tmp_path / "d")
    assert_same_series(series_of(ref), series_of(want))
    assert hist_state(ref) == hist_state(want)
    assert notes_state(ref) == notes_state(want)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_torn_reference_style_snapshot_is_refused(tmp_path, run, writer):
    """The second flush's ``uids.json`` and ``series.json`` beside the
    first flush's ``points.npz`` and ``META.json``, with the WAL as it
    was before the second flush and no marker: the reference's in-place
    ``points.npz`` write can leave it. The port names both files and
    both totals and serves nothing."""
    d, keep = tmp_path / "d", tmp_path / "keep"
    t = (jtsdb if writer == "jax" else ptsdb)(d)
    write = RUNS[run]
    write(t, 0)
    t.flush()
    keep.mkdir()
    shutil.copy(d / "data" / "points.npz", keep)
    shutil.copy(d / "META.json", keep)
    write(t, 1)
    shutil.copytree(d / "wal", keep / "wal")
    t.flush()
    t.wal.close()
    shutil.copy(keep / "points.npz", d / "data" / "points.npz")
    shutil.copy(keep / "META.json", d / "META.json")
    shutil.rmtree(d / "wal")
    shutil.copytree(keep / "wal", d / "wal")
    new_total = {"run1": 20, "run2": 25}[run]
    old_total = {"run1": 10, "run2": 20}[run]
    with pytest.raises(ValueError, match=(
            rf"torn snapshot: .*series\.json indexes {new_total} points, "
            rf"but .*points\.npz holds {old_total}")):
        ptsdb(d)


# -- rollup stores in the snapshot -----------------------------------------

def _rollup_files(d: Path) -> list:
    return sorted(str(p.relative_to(d)) for p in d.glob("rollup-*/*"))


@pytest.mark.parametrize("seed", [0, 1])
def test_rollup_snapshot_bytes_equal_reference(tmp_path, seed):
    """The same rollup writes flushed by both packages: the same
    ``rollup-*`` directories, ``series.json`` bytes and ``points.npz``
    arrays."""
    j = jtsdb(tmp_path / "j", **ROLLUPS)
    p = ptsdb(tmp_path / "p", **ROLLUPS)
    for t in (j, p):
        write_rollups(t, seed)
        t.flush()
    names = _rollup_files(tmp_path / "j")
    assert names == _rollup_files(tmp_path / "p") and len(names) == 8
    for name in names:
        a, b = tmp_path / "j" / name, tmp_path / "p" / name
        if name.endswith(".json"):
            assert b.read_bytes() == a.read_bytes(), name
            continue
        jz, pz = np.load(a), np.load(b)
        assert sorted(jz.files) == sorted(pz.files)
        for k in jz.files:
            np.testing.assert_array_equal(
                pz[k].view(np.int64) if k == "vals" else pz[k],
                jz[k].view(np.int64) if k == "vals" else jz[k])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rollup_snapshot_cross_reads(tmp_path, writer):
    """A snapshot with rollup stores plus a WAL tail of rollup records
    opens in the other package with every store bit for bit."""
    make_w, make_r = (jtsdb, ptsdb) if writer == "jax" else (ptsdb, jtsdb)
    w = make_w(tmp_path, **ROLLUPS)
    write_rollups(w, 5)
    w.flush()
    w.add_aggregate_point("r.m", T0 + 900, 3.0, {"host": "z"}, False, "1h",
                          "min")
    want = rollup_state(w)
    w.wal.close()
    r = make_r(tmp_path, **ROLLUPS)
    assert rollup_state(r) == want


def test_unconfigured_tier_dir_is_skipped(tmp_path, caplog):
    """A ``rollup-*`` directory of a tier the config no longer holds is
    skipped with a log line (the reference skips it silently); the
    other stores load."""
    p = ptsdb(tmp_path, **ROLLUPS)
    write_rollups(p, 6)
    p.shutdown()
    want = {k: v for k, v in rollup_state(p).items()
            if not k[0].startswith("1h:")}
    cfg = tmp_path / "tiers.json"
    cfg.write_text('[{"interval": "1m"}]')
    extra = {**ROLLUPS, "tsd.rollups.config": str(cfg)}
    with caplog.at_level("WARNING", logger="persist"):
        t = ptsdb(tmp_path, **extra)
    assert rollup_state(t) == want
    assert any("rollup-1h-max skipped" in r.getMessage()
               for r in caplog.records)
    ref = jtsdb(tmp_path, **extra)
    assert rollup_state(ref) == want


def test_rollup_dirs_left_in_place_with_rollups_off(tmp_path):
    p = ptsdb(tmp_path, **ROLLUPS)
    write_rollups(p, 7)
    p.shutdown()
    want = rollup_state(p)
    before = _rollup_files(tmp_path)
    t = ptsdb(tmp_path)
    assert t.rollup_store is None
    t.add_point("m", T0, 1.0, {"h": "a"})
    t.shutdown()
    assert _rollup_files(tmp_path) == before
    assert rollup_state(ptsdb(tmp_path, **ROLLUPS)) == want


def _rollup_run(t, phase):
    _run1(t, phase)
    hosts = ("a",) if phase == 0 else ("b", "c")
    for h in hosts:
        for j in range(3):
            t.add_aggregate_point("r.m", T0 + 60 * j, float(j + ord(h)),
                                  {"host": h}, False, "1m", "sum")
    if phase == 0:
        t.add_aggregate_point("r.m", T0, 2.0, {"dc": "x"}, True, None, None,
                              "sum")
    else:
        t.add_aggregate_point("r.m", T0, 4.0, {"host": "a"}, False, "1h",
                              "count")


# with rollups on, the second flush stages uids, data's two files,
# histograms, annotations, meta, the 1h count, 1m sum and preagg
# stores' two files each, and META: 13 files, then the marker
ROLLUP_CRASH_POINTS = ([f"stage:{k}" for k in range(1, 15)] + ["marker"]
                       + [f"rename:{k}" for k in range(1, 14)] + ["saved"])


@pytest.mark.parametrize("point", ROLLUP_CRASH_POINTS)
def test_crashed_save_with_rollups_reads_every_point_back(tmp_path,
                                                          monkeypatch,
                                                          point):
    """The atomic swap covers the rollup stores' files: a save crashed
    after any step leaves a directory from which every acknowledged raw,
    histogram and rollup point reads back, in the port and in the
    reference."""
    t = ptsdb(tmp_path / "d", **ROLLUPS)
    _rollup_run(t, 0)
    t.flush()
    _rollup_run(t, 1)
    with monkeypatch.context() as m:
        _crash_at(m, t, point)
        with pytest.raises(Crash):
            t.flush()
    t.wal.close()
    staged = list((tmp_path / "d").rglob("*.staged"))
    assert bool(staged) == (point not in ("rename:13", "saved"))
    want = ptsdb(tmp_path / "w", **ROLLUPS)
    _rollup_run(want, 0)
    _rollup_run(want, 1)
    got = ptsdb(tmp_path / "d", **ROLLUPS)
    assert not list((tmp_path / "d").rglob("*.staged"))
    assert not (tmp_path / "d" / persist.MARKER).exists()
    assert_same_series(series_of(got), series_of(want))
    assert rollup_state(got) == rollup_state(want) != {}
    assert hist_state(got) == hist_state(want)
    assert notes_state(got) == notes_state(want) != []
    got.shutdown()
    ref = jtsdb(tmp_path / "d", **ROLLUPS)
    assert rollup_state(ref) == rollup_state(want)
