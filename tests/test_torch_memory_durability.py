"""Durability on the ``memory`` store and of the operator state
(annotations, TSMeta/UIDMeta, trees) against the JAX package's, on the
CPU.

- The memory store keeps each point's integer flag, so a ``data_dir``
  works on it: the same writes (:func:`write_all`, from a seed: ints
  and floats, new UIDs, out of order and duplicate points; the memory
  store has no import parser) flushed, then more written and the log closed
  without a flush, reopen in either package on either store with every
  point, value bit and flag equal; the snapshot files and the WAL are
  byte for byte the reference's.
- The operator state, both ways: annotations (a snapshot's
  ``annotations.json`` and the WAL's ``T_ANNOT``/``T_ANNOT_DEL`` tail),
  the meta documents (``meta.json``) and the trees (``trees.json``)
  written by one package load in the other equal to what the writer
  holds, and with the clock pinned the three files are byte for byte
  the reference's.

Tolerance: none; points compare bit for bit, documents exactly.
"""

import numpy as np
import pytest

from test_torch_wal import (T0, assert_same_series, jtsdb, ptsdb, segments,
                            series_of)
from torch_meta_pair import JAX, PORT, frozen_clock

MEMORY = {"tsd.storage.backend": "memory"}
META = {"tsd.core.meta.enable_realtime_ts": "true",
        "tsd.core.meta.enable_realtime_uid": "true",
        "tsd.core.tree.enable_processing": "true"}


def write_all(t, seed: int) -> None:
    """``tests/test_torch_wal.py``'s writes without the import buffer."""
    rng = np.random.default_rng(seed)
    hosts = [f"h{i}" for i in range(4)]
    t.add_point("w.a", T0, int(rng.integers(0, 100)), {"host": hosts[0]})
    t.add_point("w.a", T0 + 60, float(rng.normal()), {"host": hosts[0]})
    t.add_points("w.a", T0 + 60 * np.arange(1, 6), rng.normal(50, 5, 5),
                 {"host": hosts[1], "dc": "x"})
    t.add_points("w.b", T0 + 60 * np.arange(4),
                 rng.integers(-10, 10, 4), {"host": hosts[2]})
    t.add_point("w.a", T0 - 120, 3, {"host": hosts[0]})        # out of order
    t.add_point("w.a", T0, float(rng.normal()), {"host": hosts[0]})  # dup
    t.add_point_groups([
        ("w.c", {"host": hosts[3]}, [0, 1, 2], [T0 + 30, T0, T0 + 90],
         [1, float(rng.normal()), 7]),
        ("w.a", {"host": hosts[1], "dc": "x"}, [3], [T0 + 600],
         [int(rng.integers(0, 9))])])


def _make(side, d, backend, **keys):
    extra = MEMORY if backend == "memory" else {}
    return (ptsdb if side is PORT else jtsdb)(d, **extra, **keys)


@pytest.mark.parametrize("reader", ["port-memory", "port-native",
                                    "jax-memory", "jax-native"])
@pytest.mark.parametrize("seed", [0, 1])
def test_memory_store_data_dir_round_trips(tmp_path, seed, reader):
    """The port on the memory store writes; each package and store
    reads. The port's directory equals the reference's for the same
    writes."""
    d = tmp_path / "port"
    t = ptsdb(d, **MEMORY)
    write_all(t, seed)
    t.flush()
    write_all(t, seed + 10)
    t.add_point("w.z", T0, 7, {"host": "late"})
    t.wal.close()
    want = series_of(t)
    side, backend = reader.split("-")
    got = _make(PORT if side == "port" else JAX, d, backend)
    assert_same_series(series_of(got), want)
    flags = np.concatenate([v[2] for v in want.values()])
    assert flags.any() and not flags.all()


def test_memory_store_files_equal_reference(tmp_path):
    """The same writes on the port's memory store and the reference's:
    the same snapshot and WAL bytes."""
    p, j = ptsdb(tmp_path / "p", **MEMORY), jtsdb(tmp_path / "j", **MEMORY)
    for t in (p, j):
        write_all(t, 5)
        t.flush()
        write_all(t, 6)
    for name in ("uids.json", "data/series.json", "META.json"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    pz, jz = (np.load(tmp_path / d / "data" / "points.npz")
              for d in ("p", "j"))
    for name in ("ts", "vals", "ints"):
        assert pz[name].tobytes() == jz[name].tobytes(), name
    assert [s.read_bytes() for s in segments(tmp_path / "p")] == \
        [s.read_bytes() for s in segments(tmp_path / "j")]


def test_reference_memory_directory_reads_in_the_port(tmp_path):
    j = jtsdb(tmp_path, **MEMORY)
    write_all(j, 3)
    j.flush()
    write_all(j, 4)
    j.wal.close()
    got = ptsdb(tmp_path, **MEMORY)
    assert_same_series(series_of(got), series_of(j))


# -- annotations, meta and trees ----------------------------------------------

def _operator_writes(side, t, phase: int) -> None:
    """Points with meta tracking and a tree filing them, and notes:
    global, per series, replaced and deleted."""
    note = side.annotation.Annotation
    if phase == 0:
        tree = side.tree.tree_manager(t).create_tree("by-dc", "d")
        tree.set_rule(side.tree.TreeRule(level=0, type="TAGK", field="dc"))
        tree.set_rule(side.tree.TreeRule(level=1, type="METRIC",
                                         separator="."))
    for i in range(4):
        t.add_points(f"op.m{phase}", T0 + 60 * np.arange(3),
                     np.arange(3) + i, {"host": f"h{i}", "dc": f"d{i % 2}"})
    tsuid = t.uids.tsuid(t.uids.metrics.get_id(f"op.m{phase}"), sorted(
        (t.uids.tag_names.get_id(k), t.uids.tag_values.get_id(v))
        for k, v in (("host", "h1"), ("dc", "d1")))).hex().upper()
    t.annotations.store(note("", T0 + phase, 0, f"global {phase}",
                             custom={"k": str(phase)}))
    t.annotations.store(note(tsuid, T0 + 60, T0 + 120, "spike"))
    t.annotations.store(note(tsuid, T0 + 60, T0 + 180, "spike, longer"))
    t.annotations.store(note("", T0 + 500 + phase, 0, "gone"))
    t.annotations.delete("", T0 + 500 + phase)


def _state(t) -> tuple:
    notes = sorted((k, a.to_json()["startTime"], a.to_json())
                   for k, d in t.annotations._by_tsuid.items()
                   for a in d.values())
    meta = ({k: v.to_json() for k, v in t.meta.ts_meta.items()},
            {k: v.to_json() for k, v in t.meta.uid_meta.items()},
            dict(t.meta.ts_counters))
    mgr = t._tree_manager
    trees = [tree.to_json() for tree in mgr.all_trees()] if mgr else []
    return notes, meta, trees


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("backend", ["memory", "native"])
def test_operator_state_round_trips(tmp_path, monkeypatch, writer,
                                    backend):
    """Written by one package (a snapshot, then a WAL tail of notes),
    read by the other: the notes, meta documents and tree definitions
    that the snapshot holds, and the notes of the tail. (Meta documents
    and trees are durable from the snapshot, in both packages: the WAL
    has no record of them.)"""
    frozen_clock(monkeypatch)
    w_side, r_side = (PORT, JAX) if writer == "port" else (JAX, PORT)
    d = tmp_path / "d"
    w = _make(w_side, d, backend, **META)
    _operator_writes(w_side, w, 0)
    w.flush()
    flushed = _state(w)
    _operator_writes(w_side, w, 1)
    w.wal.close()
    r = _make(r_side, d, backend, **META)
    notes, meta, trees = _state(r)
    assert notes == _state(w)[0]
    assert (meta, trees) == flushed[1:]
    assert len(notes) == 4 and len(meta[0]) == 4 and len(trees) == 1
    # the reader's own flush gives the writer's files back
    r.flush()
    again = _make(w_side, d, backend, **META)
    assert _state(again)[0] == notes and _state(again)[1:] == (meta, trees)


def test_operator_files_equal_reference(tmp_path, monkeypatch):
    """The same writes in both packages, clock pinned: the same
    ``annotations.json``, ``meta.json`` and ``trees.json`` bytes, and
    the same WAL bytes (the notes' records among them)."""
    frozen_clock(monkeypatch)
    for side, name in ((PORT, "p"), (JAX, "j")):
        t = _make(side, tmp_path / name, "native", **META)
        _operator_writes(side, t, 0)
        t.flush()
        _operator_writes(side, t, 1)
        t.wal.close()
    for name in ("annotations.json", "meta.json", "trees.json"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    assert [s.read_bytes() for s in segments(tmp_path / "p")] == \
        [s.read_bytes() for s in segments(tmp_path / "j")]
