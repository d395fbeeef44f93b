"""The port's write-ahead log (``opentsdb_tpu_torch/core/wal.py``)
against the JAX package's (``opentsdb_tpu/core/wal.py``), on the CPU.

- Byte compatibility: the same writes, made from a seed, through the
  write paths both packages share (``add_point``, ``add_points``,
  ``add_point_groups``, ``import_buffer``; int and float values, new
  UIDs, out-of-order and duplicate points) give WAL segments equal byte
  for byte, in sequence order.
- Cross-reading: a log either package wrote, closed without a flush,
  replays in the other; the stores' points are equal bit for bit and
  each package answers a query on the other's directory with the bits
  it gives on its own.
- The cases of ``tests/test_wal.py`` that need no rollup or annotation,
  and every case of ``tests/test_wal_torn_tail.py``, on the port
  (histogram records: ``tests/test_torch_histogram.py``).
- Annotation records (``T_ANNOT``, ``T_ANNOT_DEL``) the reference wrote
  replay in the port as in the reference; a rollup store's record with
  rollups off raises, naming the key (the reference drops it: ROADMAP
  Queue 3); the memory store keeps a data_dir's points and flags
  (``tests/test_torch_memory_durability.py``).
- Rollup records (``preagg``, ``tier:*``): the same bytes as the
  reference's, replayed by either package, after a snapshot too.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from torch_pair import ENGINE_KEYS, assert_rows_close, rows

from opentsdb_tpu import TSDB as JTSDB  # noqa: E402  (after torch_pair)
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.core import wal as jwal
from opentsdb_tpu.query.model import TSQuery as JQuery
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.core import wal as twal
from opentsdb_tpu_torch.query.model import TSQuery

ROOT = Path(__file__).resolve().parent.parent
T0 = 1356998400


def ptsdb(d, **extra) -> TSDB:
    return TSDB(Config(**{"tsd.torch.device": "cpu",
                          "tsd.torch.dtype": "float64",
                          "tsd.core.auto_create_metrics": "true",
                          "tsd.storage.data_dir": str(d),
                          **ENGINE_KEYS, **extra}))


def jtsdb(d, **extra) -> JTSDB:
    return JTSDB(JConfig(**{"tsd.tpu.platform": "cpu",
                            "tsd.core.auto_create_metrics": "true",
                            "tsd.query.compile_cache_dir": "off",
                            "tsd.storage.data_dir": str(d),
                            **ENGINE_KEYS, **extra}))


def write_all(t, seed: int) -> None:
    """One sequence of writes through the paths both packages share:
    new UIDs, int and float values, out-of-order and duplicate points,
    a put body of several series and an import buffer with a bad line."""
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
    lines = [f"w.d {T0 + 60 * j} {rng.normal():.6f} host={hosts[j % 3]}"
             for j in range(6)]
    lines.insert(3, f"w.d notatime 1 host={hosts[0]}")
    lines.append(f"w.a {T0 + 900} 12 host={hosts[0]}")
    t.import_buffer(("\n".join(lines) + "\n").encode())


def segments(d) -> list[Path]:
    return sorted((Path(d) / "wal").glob("wal-*.log"))


def series_of(t) -> dict:
    """Every series' points keyed by metric and tag names."""
    out = {}
    for sid in range(t.store.num_series()):
        if hasattr(t.store, "series_points"):
            ts, vals, ints = t.store.series_points(sid)
            mid, tags = t.store.series_identities()[sid]
        else:
            rec = t.store.series(sid)
            ts, vals, ints = rec.buffer.view_full()
            mid, tags = rec.metric_id, rec.tags
        key = (t.uids.metrics.get_name(mid),
               tuple(sorted((t.uids.tag_names.get_name(k),
                             t.uids.tag_values.get_name(v))
                            for k, v in tags)))
        out[key] = (ts, vals.view(np.int64), np.asarray(ints, bool))
    return out


def assert_same_series(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        for x, y in zip(a[key], b[key]):
            np.testing.assert_array_equal(x, y, err_msg=str(key))


QUERY = {"start": str(T0 - 300), "end": str(T0 + 1200),
         "queries": [{"aggregator": "sum", "metric": "w.a",
                      "downsample": "1m-avg"}]}


def answers(t):
    if isinstance(t, TSDB):
        return rows(t.execute_query(TSQuery.from_json(QUERY).validate()))
    return rows(t.execute_query(JQuery.from_json(QUERY).validate()))


def same_bits(a, b) -> None:
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x[:4] == y[:4]
        np.testing.assert_array_equal(np.asarray(x[4]).view(np.int64),
                                      np.asarray(y[4]).view(np.int64))


# -- byte compatibility and cross-reading -------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wal_bytes_equal_reference(tmp_path, seed):
    j, p = jtsdb(tmp_path / "j"), ptsdb(tmp_path / "p")
    write_all(j, seed)
    write_all(p, seed)
    js, ps = segments(tmp_path / "j"), segments(tmp_path / "p")
    assert len(js) == len(ps) >= 1
    for a, b in zip(js, ps):
        # wal-<first seq>-<pid>.log: the same first sequence numbers
        assert a.name.split("-")[1] == b.name.split("-")[1]
        assert a.read_bytes() == b.read_bytes()
    assert p.wal.last_seq() == j.wal.last_seq()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_unflushed_log_cross_reads(tmp_path, writer):
    """A log closed without a flush replays in the other package: the
    points equal bit for bit, and each package answers the query on the
    other's directory with the bits it gives on its own."""
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    make_w, make_r = (jtsdb, ptsdb) if writer == "jax" else (ptsdb, jtsdb)
    w = make_w(theirs)
    write_all(w, 5)
    w.wal.close()
    own = make_r(mine)
    write_all(own, 5)
    r = make_r(theirs)
    assert_same_series(series_of(r), series_of(w))
    assert_same_series(series_of(r), series_of(own))
    same_bits(answers(r), answers(own))
    # the two engines agree too (the reference's tolerance)
    port_side = r if isinstance(r, TSDB) else own
    jax_side = w if isinstance(w, JTSDB) else r
    assert_rows_close(answers(port_side), answers(jax_side))


def test_add_series_points_replays_in_both(tmp_path):
    """The port's bulk write logs its series and one T_LINES record per
    chunk; both packages replay it."""
    p = ptsdb(tmp_path)
    tags = [{"host": f"h{i}", "dc": f"dc{i % 2}"} for i in range(5)]
    ts = T0 + 60 * np.arange(4)[None, :].repeat(5, 0)
    vals = np.random.default_rng(3).normal(size=(5, 4))
    counts = np.array([4, 3, 4, 0, 2])
    p.add_series_points("w.s", tags, ts, vals, counts)
    p.wal.close()
    want = series_of(p)
    assert_same_series(series_of(ptsdb(tmp_path)), want)
    assert_same_series(series_of(jtsdb(tmp_path)), want)


# -- the cases of tests/test_wal.py on the port -------------------------------

def _sum(t, metric, start=T0 - 10, end=T0 + 100000) -> dict:
    q = TSQuery.from_json({"start": start, "end": end, "queries": [
        {"aggregator": "sum", "metric": metric}]}).validate()
    out = {}
    for g in t.execute_query(q):
        for ts, v in g.dps:
            out[int(ts) // 1000] = out.get(int(ts) // 1000, 0) + float(v)
    return out


def test_unflushed_points_survive_restart(tmp_path):
    t = ptsdb(tmp_path)
    t.add_point("m", T0, 5, {"h": "a"})
    t.add_point("m", T0 + 10, 7, {"h": "a"})
    t.add_points("m", np.asarray([T0 + 20, T0 + 30]),
                 np.asarray([1.5, 2.5]), {"h": "b"})
    t2 = ptsdb(tmp_path)      # no flush: the first is dropped as a crash
    assert _sum(t2, "m") == {T0: 5.0, T0 + 10: 7.0, T0 + 20: 1.5,
                             T0 + 30: 2.5}
    assert t2.recovery["points_replayed"] == 4


def test_snapshot_plus_wal_tail(tmp_path):
    t = ptsdb(tmp_path)
    t.add_point("m", T0, 1, {"h": "a"})
    t.flush()                 # the snapshot covers it; the log truncates
    t.add_point("m", T0 + 10, 2, {"h": "a"})     # log only
    t.add_point("m2", T0, 9, {"h": "x"})         # a new series, log only
    t2 = ptsdb(tmp_path)
    assert _sum(t2, "m") == {T0: 1.0, T0 + 10: 2.0}
    assert _sum(t2, "m2") == {T0: 9.0}
    assert t2.recovery["points_replayed"] == 2
    t3 = ptsdb(tmp_path)      # no double replay on another restart
    assert _sum(t3, "m") == {T0: 1.0, T0 + 10: 2.0}


def test_truncate_removes_covered_segments(tmp_path):
    t = ptsdb(tmp_path)
    for i in range(10):
        t.add_point("m", T0 + i, i, {"h": "a"})
    assert segments(tmp_path)
    t.flush()
    assert not segments(tmp_path)


def test_import_buffer_durable_and_opt_out(tmp_path):
    buf = f"m {T0} 1 h=a\nm {T0 + 1} 2 h=b\n".encode()
    ptsdb(tmp_path / "dur").import_buffer(buf)
    assert _sum(ptsdb(tmp_path / "dur"), "m") == {T0: 1.0, T0 + 1: 2.0}
    # the opt-out (setDurable(false)) is not replayed
    t = ptsdb(tmp_path / "nodur")
    assert t.import_buffer(buf, durable=False) == (2, [])
    with pytest.raises(Exception):
        _sum(ptsdb(tmp_path / "nodur"), "m")


def test_uid_assignment_replay(tmp_path):
    t = ptsdb(tmp_path)
    uid = t.assign_uid("metric", "pre.created")
    assert ptsdb(tmp_path).uids.metrics.get_id("pre.created") == uid
    # and the reference replays the port's record
    assert jtsdb(tmp_path).uids.metrics.get_id("pre.created") == uid


def test_torn_tail_tolerated(tmp_path):
    t = ptsdb(tmp_path)
    t.add_point("m", T0, 1, {"h": "a"})
    t.add_point("m", T0 + 1, 2, {"h": "a"})
    with open(segments(tmp_path)[0], "ab") as fh:   # a torn record
        fh.write(b"\x02\xff\xff\xff")
    assert _sum(ptsdb(tmp_path), "m") == {T0: 1.0, T0 + 1: 2.0}


def test_wal_disabled(tmp_path):
    off = {"tsd.storage.wal.enable": "false"}
    t = ptsdb(tmp_path, **off)
    assert t.wal is None
    t.add_point("m", T0, 1, {"h": "a"})
    with pytest.raises(Exception):
        _sum(ptsdb(tmp_path, **off), "m")    # snapshots only


@pytest.mark.parametrize("before", [0, 5])
def test_replay_sid_drift_chained_remap(tmp_path, before):
    """Series records whose ids are not the store's order remap through
    a lookup, not in place. With no snapshot the log's ids 6 and 5 map
    to 0 and 1; after a snapshot of 5 series they map to 5 and 6, a
    chain {6: 5, 5: 6} that substitution in place corrupts."""
    if before:
        t = ptsdb(tmp_path)
        for i in range(before):
            t.add_point("m", T0, 1.0, {"h": f"s{i}"})
        t.flush()
        w = t.wal
    else:
        w = twal.WriteAheadLog(str(tmp_path / "wal"), fsync_mode="never")
    w._append_json(twal.T_SERIES, {"k": "data", "sid": 6, "m": "m",
                                   "t": [["h", "b"]]})
    w._append_json(twal.T_SERIES, {"k": "data", "sid": 5, "m": "m",
                                   "t": [["h", "a"]]})
    w.log_lines("data", np.asarray([5, 6, 5]),
                np.asarray([T0, T0, T0 + 1]) * 1000,
                np.asarray([10.0, 20.0, 11.0]), np.zeros(3, np.uint8))
    w.log_point("data", 6, (T0 + 2) * 1000, 21.0, False)
    w.close()
    t = ptsdb(tmp_path)
    by_host = {key[1][0][1]: sorted(np.asarray(v[1]).view(np.float64))
               for key, v in series_of(t).items()}
    assert by_host == {"a": [10.0, 11.0], "b": [20.0, 21.0],
                       **{f"s{i}": [1.0] for i in range(before)}}


def test_segment_rotation_replay(tmp_path):
    w = twal.WriteAheadLog(str(tmp_path / "wal"), fsync_mode="never",
                           segment_bytes=512)
    for i in range(50):
        w._append_json(twal.T_SERIES, {"k": "data", "sid": i, "m": "m",
                                       "t": [["h", f"x{i}"]]})
        w.log_point("data", i, (T0 + i) * 1000, float(i), False)
    assert len(w._segments()) > 3
    w.close()
    t = ptsdb(tmp_path)
    assert t.store.num_series() == 50
    assert t.store.points_written == 50


def test_import_burst_replays_in_line_order(tmp_path):
    """A burst whose rejected line is written another way in between
    (telnet's replay) logs its lines around that write, so replay keeps
    the last write of a timestamp where the store has it."""
    t = ptsdb(tmp_path)
    buf = f"m {T0} 1 h=a\nm {T0} nan h=a\nm {T0 + 1} 2 h=a\n".encode()
    t.import_buffer(buf, on_error=lambda lineno, exc: t.add_point(
        "m", T0, float("nan"), {"h": "a"}))
    want = series_of(t)
    np.testing.assert_array_equal(np.isnan(
        want[("m", (("h", "a"),))][1].view(np.float64)), [True, False])
    t.wal.close()
    assert_same_series(series_of(ptsdb(tmp_path)), want)


KILLER = textwrap.dedent("""\
    import os, sys, numpy as np
    sys.path.insert(0, %(repo)r)
    from opentsdb_tpu_torch import TSDB, Config
    t = TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.core.auto_create_metrics": "true",
                       "tsd.storage.data_dir": %(datadir)r}))
    base = 1356998400
    i = 0
    out = os.fdopen(1, "w", buffering=1)
    while True:
        n = 50
        ts = np.arange(base + i * n, base + (i + 1) * n)
        t.add_points("km", ts, np.full(n, float(i)),
                     {"h": "h%%d" %% (i %% 7)})
        out.write("%%d\\n" %% ((i + 1) * n))   # the ack, after the fsync
        i += 1
""")


def test_sigkill_loses_zero_acked_points(tmp_path):
    """Every point acknowledged (printed after add_points returned, so
    after its fsync) is there after SIGKILL and a restart."""
    datadir = str(tmp_path / "kill9")
    proc = subprocess.Popen(
        [sys.executable, "-c", KILLER % {"repo": str(ROOT),
                                         "datadir": datadir}],
        stdout=subprocess.PIPE)
    acked = 0
    deadline = time.time() + 120
    try:
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            acked = int(line)
            if acked >= 1000:
                break
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
        proc.stdout.close()
    assert acked >= 1000, "the writer never reached 1000 points"
    t = ptsdb(datadir)
    total = sum(len(t.store.series_points(sid)[0])
                for sid in range(t.store.num_series()))
    assert total >= acked, f"lost acknowledged points: {acked} > {total}"


# -- the cases of tests/test_wal_torn_tail.py on the port ----------------------

def _write5(d, n=5):
    t = ptsdb(d)
    for i in range(n):
        t.add_point("w.m", T0 + i * 10, float(i), {"host": "a"})
    t.wal.close()


def _values(t):
    out = t.execute_query(TSQuery.from_json({
        "start": T0 * 1000, "end": (T0 + 3600) * 1000,
        "queries": [{"metric": "w.m", "aggregator": "sum"}]}).validate())
    return [v for _, v in out[0].dps] if out else []


def test_truncated_payload_keeps_prefix_and_repairs_file(tmp_path):
    _write5(tmp_path, 5)
    (seg,) = segments(tmp_path)
    size = seg.stat().st_size
    os.truncate(seg, size - 3)     # a crash tore the last payload
    t = ptsdb(tmp_path)
    assert _values(t) == [0.0, 1.0, 2.0, 3.0]
    repaired = seg.stat().st_size
    assert repaired < size - 3     # the file ends at its last good record
    t.wal.close()
    t2 = ptsdb(tmp_path)           # a second start sees a clean file
    assert _values(t2) == [0.0, 1.0, 2.0, 3.0]
    assert seg.stat().st_size == repaired
    t2.wal.close()


def test_partial_header_fragment_truncated(tmp_path):
    _write5(tmp_path, 3)
    (seg,) = segments(tmp_path)
    size = seg.stat().st_size
    with open(seg, "ab") as fh:
        fh.write(b"\x02\x10\x00")  # 3 bytes of a 17-byte header
    t = ptsdb(tmp_path)
    assert _values(t) == [0.0, 1.0, 2.0]
    assert seg.stat().st_size == size
    t.wal.close()


def test_corrupt_crc_garbage_truncated(tmp_path):
    _write5(tmp_path, 3)
    (seg,) = segments(tmp_path)
    size = seg.stat().st_size
    with open(seg, "ab") as fh:
        fh.write(b"\x02" + b"\xde\xad\xbe\xef" * 8)   # a bad CRC
    t = ptsdb(tmp_path)
    assert _values(t) == [0.0, 1.0, 2.0]
    assert seg.stat().st_size == size
    t.wal.close()


def test_bad_magic_segment_skipped_never_raises(tmp_path):
    _write5(tmp_path, 3)
    (seg,) = segments(tmp_path)
    seg.write_bytes(b"NOTAWAL!")
    t = ptsdb(tmp_path)            # comes up
    assert t.store.total_points() == 0
    assert seg.stat().st_size == 8   # left for inspection
    t.wal.close()


def test_log_stays_appendable_after_repair(tmp_path):
    _write5(tmp_path, 4)
    (seg,) = segments(tmp_path)
    os.truncate(seg, seg.stat().st_size - 2)
    t = ptsdb(tmp_path)
    assert _values(t) == [0.0, 1.0, 2.0]
    t.add_point("w.m", T0 + 100, 9.0, {"host": "a"})
    t.wal.close()
    t2 = ptsdb(tmp_path)
    assert _values(t2) == [0.0, 1.0, 2.0, 9.0]
    t2.wal.close()


# -- refusals -------------------------------------------------------------------

def _reference_record(w, kind: str) -> None:
    """One record of a subsystem the port lacks, written by the JAX
    package's WAL."""
    if kind == "annotation":
        w.log_annotation({"tsuid": "", "startTime": T0,
                          "description": "deploy"})
    elif kind == "annotation-delete":
        w.log_annotation_delete("", T0)
    else:
        w.ensure_series(kind, 0, "m", {"h": "a"})
        w.log_point(kind, 0, T0 * 1000, 1.0, False)


@pytest.mark.parametrize("kind,item", [
    ("annotation", "the rest, with no device compute"),
    ("annotation-delete", "the rest, with no device compute"),
    ("preagg", "rollups"),
    ("tier:1m:sum", "rollups")])
def test_replay_refuses_unported_records(tmp_path, kind, item):
    """An annotation record (ported) replays as the reference replays
    it; a rollup store's record (ported) with rollups off is refused
    naming the key that turns them on (ROADMAP Queue 3: the reference
    drops it)."""
    w = jwal.WriteAheadLog(str(tmp_path / "wal"), fsync_mode="never")
    w.ensure_series("data", 0, "m", {"h": "a"})
    w.log_point("data", 0, T0 * 1000, 1.0, False)
    _reference_record(w, kind)
    w.close()
    if item == "rollups":
        with pytest.raises(ValueError, match="set tsd.rollups.enable=true"):
            ptsdb(tmp_path)
        return
    p = ptsdb(tmp_path)
    p.wal.close()
    j = jtsdb(tmp_path)
    notes, want = ([(a.tsuid, a.start_time, a.description)
                    for a in t.annotations.global_range(0, T0 * 2)]
                   for t in (p, j))
    assert notes == want
    assert notes == ([("", T0, "deploy")] if kind == "annotation" else [])
    assert p.annotations.version == j.annotations.version
    assert_same_series(series_of(p), series_of(j))


def test_memory_backend_with_data_dir_raises(tmp_path):
    """No longer raises: the memory store keeps the integer flag, so a
    data_dir holds its points and flags as the native store's does."""
    t = ptsdb(tmp_path, **{"tsd.storage.backend": "memory"})
    assert t.store.backend == "memory"
    t.add_points("m", T0 + np.arange(3), [1, 2, 3], {"h": "a"})
    t.add_point("m", T0 + 5, 2.5, {"h": "a"})
    t.wal.close()
    got = ptsdb(tmp_path, **{"tsd.storage.backend": "memory"})
    want = jtsdb(tmp_path)
    assert_same_series(series_of(got), series_of(want))
    ts, vals, ints = got.store.series_points(0)
    assert ints.tolist() == [True, True, True, False]
    # without a data_dir the memory store stays a choice
    TSDB(Config(**{"tsd.torch.device": "cpu",
                   "tsd.storage.backend": "memory"}))


def test_unknown_record_type_raises(tmp_path):
    w = twal.WriteAheadLog(str(tmp_path / "wal"), fsync_mode="never")
    w._append(42, b"?")
    w.close()
    with pytest.raises(ValueError, match="unknown record type 42"):
        ptsdb(tmp_path)


def test_replay_creates_uids_whatever_the_auto_create_keys(tmp_path):
    """ROADMAP Queue 3: a log written with auto-created names, replayed
    by a TSDB whose ``tsd.core.auto_create_metrics`` is false. The
    reference's replay fails to resolve the series, logs it and drops
    its acknowledged points; the port's recreates the names, since the
    write they belong to was acknowledged."""
    for make, d in ((jtsdb, tmp_path / "j"), (ptsdb, tmp_path / "p")):
        t = make(d)
        t.add_points("m", T0 + np.arange(3), np.arange(3.0), {"h": "a"})
        t.wal.close()
    strict = {"tsd.core.auto_create_metrics": "false"}
    j = jtsdb(tmp_path / "j", **strict)
    assert j.store.num_series() == 0          # the reference lost them
    p = ptsdb(tmp_path / "p", **strict)
    assert p.recovery["points_replayed"] == 3
    assert _sum(p, "m") == {T0: 0.0, T0 + 1: 1.0, T0 + 2: 2.0}


# -- rollup stores' records (kinds preagg and tier:<interval>:<agg>) ----------

ROLLUPS = {"tsd.rollups.enable": "true"}


def write_rollups(t, seed: int) -> None:
    """Tier and pre-aggregate points through ``add_aggregate_point``:
    two tiers of one interval, a second interval, a preagg point and a
    pre-aggregate in a tier, int and float values, a duplicate."""
    rng = np.random.default_rng(seed)
    for h in ("a", "b"):
        for j in range(5):
            t.add_aggregate_point("r.m", T0 + 60 * j,
                                  float(rng.normal(100, 5)), {"host": h},
                                  False, "1m", "sum")
            t.add_aggregate_point("r.m", T0 + 60 * j, 60, {"host": h},
                                  False, "1m", "count")
        t.add_aggregate_point("r.m", T0, float(rng.normal()), {"host": h},
                              False, "1h", "MAX")
    t.add_aggregate_point("r.m", T0, 5.0, {"dc": "x"}, True, None, None,
                          "sum")
    t.add_aggregate_point("r.m", T0 + 60, 6, {"dc": "x"}, True, "1m", "sum",
                          "max")
    t.add_aggregate_point("r.m", T0, 1.5, {"host": "a"}, False, "1m", "sum")


def rollup_state(t) -> dict:
    """Every rollup store series' points, keyed by the store, metric
    and tag names; values as their bits."""
    rs = t.rollup_store
    stores = [("preagg", rs.preagg_store())] + [
        (f"{iv}:{agg}", st) for (iv, agg), st in sorted(rs._tiers.items())]
    out = {}
    for kind, st in stores:
        for mid in st.metric_ids():
            for sid in st.series_ids_for_metric(mid):
                rec = st.series(int(sid))
                b = st.materialize([int(sid)], 0, 2 ** 62)
                key = (kind, t.uids.metrics.get_name(mid), tuple(sorted(
                    (t.uids.tag_names.get_name(k),
                     t.uids.tag_values.get_name(v)) for k, v in rec.tags)))
                out[key] = (b.ts_ms.tolist(),
                            b.values.view(np.int64).tolist())
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_rollup_wal_bytes_equal_reference(tmp_path, seed):
    j = jtsdb(tmp_path / "j", **ROLLUPS)
    p = ptsdb(tmp_path / "p", **ROLLUPS)
    for t in (j, p):
        write_rollups(t, seed)
    js, ps = segments(tmp_path / "j"), segments(tmp_path / "p")
    assert [a.read_bytes() for a in js] == [b.read_bytes() for b in ps]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rollup_records_cross_replay(tmp_path, writer):
    """A log of rollup records, closed without a flush, replays in
    either package into the same stores bit for bit."""
    make_w, make_r = (jtsdb, ptsdb) if writer == "jax" else (ptsdb, jtsdb)
    w = make_w(tmp_path / "theirs", **ROLLUPS)
    write_rollups(w, 3)
    write_all(w, 3)
    want = rollup_state(w)
    assert len(want) == 8
    w.wal.close()
    r = make_r(tmp_path / "theirs", **ROLLUPS)
    assert rollup_state(r) == want
    assert_same_series(series_of(r), series_of(w))
    own = make_r(tmp_path / "mine", **ROLLUPS)
    write_rollups(own, 3)
    assert rollup_state(own) == want


def test_rollup_records_after_a_snapshot(tmp_path):
    """The snapshot's tier series keep their numbering (seed_known), so
    a tail of records on them replays onto the same series."""
    p = ptsdb(tmp_path, **ROLLUPS)
    write_rollups(p, 4)
    p.flush()
    p.add_aggregate_point("r.m", T0 + 600, 9.0, {"host": "a"}, False, "1m",
                          "sum")
    p.add_aggregate_point("r.m", T0 + 600, 2.0, {"host": "c"}, False, "1m",
                          "sum")
    want = rollup_state(p)
    p.wal.close()
    assert rollup_state(ptsdb(tmp_path, **ROLLUPS)) == want
    assert rollup_state(jtsdb(tmp_path, **ROLLUPS)) == want


def test_rollup_record_with_rollups_off_diverges(tmp_path):
    """ROADMAP Queue 3: a tier or preagg record replayed with rollups
    off. The reference logs the error and drops the record (its data
    point is gone); the port raises, naming the key."""
    w = ptsdb(tmp_path / "d", **ROLLUPS)
    w.add_point("m", T0, 1.0, {"h": "a"})
    w.add_aggregate_point("m", T0, 60.0, {"h": "a"}, False, "1m", "sum")
    w.wal.close()
    ref = jtsdb(tmp_path / "d")
    assert ref.rollup_store is None
    assert ref.store.total_points() == 1
    with pytest.raises(ValueError, match="rollup store 'tier:1m:sum', but "
                       "rollups are off: set tsd.rollups.enable=true"):
        ptsdb(tmp_path / "d")


def test_tier_record_of_an_unconfigured_tier_raises(tmp_path):
    """A tier the rollup config no longer holds: the port raises (the
    reference drops the record, as above)."""
    w = ptsdb(tmp_path, **ROLLUPS)
    w.add_aggregate_point("m", T0, 1.0, {"h": "a"}, False, "1h", "sum")
    w.wal.close()
    cfg = tmp_path / "tiers.json"
    cfg.write_text('[{"interval": "1m"}]')
    with pytest.raises(ValueError, match="no rollup tier for interval "
                       "'1h'"):
        ptsdb(tmp_path, **ROLLUPS, **{"tsd.rollups.config": str(cfg)})
