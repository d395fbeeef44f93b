"""The port's annotations and TSMeta/UIDMeta documents
(``opentsdb_tpu_torch/meta/``) against the JAX package's, on the CPU.

The 28 cases of ``tests/test_meta.py``, each run as one scenario on
both packages (``torch_meta_pair.both``) with the clock pinned: the
realtime tracking, the annotation store, and the editing RPCs
``/api/uid/uidmeta`` and ``/api/uid/tsmeta`` with their search plugin
hooks. Each case also asserts what ``tests/test_meta.py`` asserts of
the reference, so two equally wrong answers fail too. Then the
annotation endpoints (``/api/annotation``, ``/bulk``,
``/api/annotations``) and the meta hooks of every bulk write path.

Tolerance: none; documents, JSON bodies and statuses compare exactly.
"""

import numpy as np
import pytest

from torch_meta_pair import (T0, both, call, frozen_clock, tsdb,
                             tsuid_of)

TRACK = {"tsd.core.meta.enable_realtime_ts": "true",
         "tsd.core.meta.enable_realtime_uid": "true"}
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _docs(t) -> list:
    return sorted((m.to_json() for m in t.meta.all_ts_meta()),
                  key=lambda d: d["tsuid"])


def _uid_hex(t, name="sys.cpu.user") -> str:
    return t.uids.metrics.int_to_uid(t.uids.metrics.get_id(name)).hex() \
        .upper()


# -- realtime tracking (ref: TSDB.java:1225-1245) -----------------------------

@case
def disabled_by_default(side):
    t = tsdb(side)
    t.add_point("sys.cpu.user", T0, 1, {"host": "a"})
    assert t.meta.all_ts_meta() == []
    return _docs(t)


@case
def tsmeta_created_on_first_write(side):
    t = tsdb(side, **TRACK)
    t.add_point("sys.cpu.user", T0, 1, {"host": "a"})
    meta = t.meta.all_ts_meta()[0]
    assert [m.name for m in meta.tags] == ["host", "a"]
    assert meta.total_dps == 1
    return _docs(t)


@case
def counter_increments_per_datapoint(side):
    t = tsdb(side, **TRACK)
    for i in range(5):
        t.add_point("m", T0 + i, i, {"host": "a"})
    assert t.meta.all_ts_meta()[0].total_dps == 5
    return _docs(t), dict(t.meta.ts_counters)


@case
def distinct_series_distinct_tsmeta(side):
    t = tsdb(side, **TRACK)
    t.add_point("m", T0, 1, {"host": "a"})
    t.add_point("m", T0, 2, {"host": "b"})
    assert len(t.meta.all_ts_meta()) == 2
    return _docs(t)


@case
def get_by_tsuid_case_insensitive(side):
    t = tsdb(side, **TRACK)
    t.add_point("m", T0, 1, {"host": "a"})
    tsuid = t.meta.all_ts_meta()[0].tsuid
    return t.meta.get_ts_meta(tsuid.lower()).to_json()


@case
def uid_meta_tracked(side):
    t = tsdb(side, **TRACK)
    t.add_point("sys.cpu.user", T0, 1, {"host": "a"})
    meta = t.meta.get_uid_meta("metric", _uid_hex(t))
    assert meta.type == "METRIC" and meta.name == "sys.cpu.user"
    return meta.to_json(), sorted(t.meta.uid_meta)


@case
def tsmeta_json_shape(side):
    t = tsdb(side, **TRACK)
    t.add_point("m", T0, 1, {"host": "a"})
    js = t.meta.all_ts_meta()[0].to_json()
    assert set(js) >= {"tsuid", "displayName", "description", "created",
                       "units", "retention", "lastReceived",
                       "totalDatapoints", "metric", "tags"}
    return js


@case
def search_plugin_indexing(side):
    t = tsdb(side, **TRACK)
    seen = []

    class Plug:
        def index_ts_meta(self, m):
            seen.append(("ts", m.tsuid))

        def index_uid_meta(self, m):
            seen.append(("uid", m.name))

    t.search_plugin = Plug()
    t.add_point("m", T0, 1, {"host": "a"})
    assert {k for k, _ in seen} == {"ts", "uid"}
    return seen


@case
def purge(side):
    t = tsdb(side, **TRACK)
    t.add_point("m", T0, 1, {"host": "a"})
    out = t.meta.purge()
    assert out == (1, 3) and t.meta.all_ts_meta() == []
    return out


# -- the annotation store (ref: TestAnnotation.java) -------------------------

def _notes(side):
    store = side.annotation.AnnotationStore()
    note = side.annotation.Annotation
    store.store(note(tsuid="0101", start_time=100, description="ts-note"))
    store.store(note(start_time=150, description="global-1"))
    store.store(note(start_time=250, description="global-2"))
    return store


def _js(notes) -> list:
    return [n.to_json() for n in notes]


@case
def store_and_get(side):
    store = _notes(side)
    assert store.get("0101", 999) is None
    return store.get("0101", 100).to_json(), store.version


@case
def store_merges_on_same_key(side):
    store = side.annotation.AnnotationStore()
    note = side.annotation.Annotation
    store.store(note(tsuid="01", start_time=5, description="a"))
    updated = store.store(note(tsuid="01", start_time=5, description="b",
                               notes="n"))
    assert store.get("01", 5).notes == "n"
    return updated.to_json(), store.version


@case
def global_range(side):
    store = _notes(side)
    assert len(store.global_range(0, 300)) == 2
    return _js(store.global_range(0, 200)), _js(store.global_range(0, 300))


@case
def per_tsuid_range(side):
    store = _notes(side)
    assert store.range("0101", 101, 200) == []
    return _js(store.range("0101", 0, 200))


@case
def delete(side):
    store = _notes(side)
    out = (store.delete("0101", 100), store.delete("0101", 100))
    assert out == (True, False)
    return out, store.get("0101", 100), store.version


@case
def delete_range_global(side):
    store = _notes(side)
    n = store.delete_range(None, 0, 200)
    assert n == 1
    return n, _js(store.global_range(0, 300)), store.version


@case
def delete_range_tsuids(side):
    store = _notes(side)
    n = store.delete_range(["0101"], 0, 200)
    assert n == 1 and len(store.global_range(0, 300)) == 2
    return n, store.get("0101", 100), _js(store.global_range(0, 300))


@case
def json_round_trip(side):
    cls = side.annotation.Annotation
    note = cls(tsuid="0101", start_time=100, end_time=200, description="d",
               notes="n", custom={"k": "v"})
    again = cls.from_json(note.to_json())
    assert again == note
    return again.to_json()


@case
def global_json_omits_tsuid(side):
    cls = side.annotation.Annotation
    js = cls(start_time=1).to_json()
    assert "tsuid" not in js
    return js, cls.from_json(js).tsuid


# -- the editing RPCs (ref: UniqueIdRpc.java:179-226,314) ---------------------

def _written(side):
    t = tsdb(side, **TRACK)
    t.add_point("sys.cpu.user", T0, 1, {"host": "a"})
    return t


@case
def uidmeta_post_merges(side):
    t = _written(side)
    uid = _uid_hex(t)
    a = call(side, t, "POST", "/api/uid/uidmeta",
             body={"uid": uid, "type": "metric", "displayName": "CPU"})
    b = call(side, t, "POST", "/api/uid/uidmeta",
             body={"uid": uid, "type": "metric", "notes": "hello"})
    assert b[1]["displayName"] == "CPU" and b[1]["notes"] == "hello"
    return a, b


@case
def uidmeta_put_replaces(side):
    t = _written(side)
    uid = _uid_hex(t)
    call(side, t, "POST", "/api/uid/uidmeta",
         body={"uid": uid, "type": "metric", "displayName": "CPU",
               "notes": "keepme?"})
    out = call(side, t, "PUT", "/api/uid/uidmeta",
               body={"uid": uid, "type": "metric",
                     "description": "replaced"})
    assert out[1]["displayName"] == "" and out[1]["notes"] == ""
    return out


@case
def uidmeta_unchanged_post_304(side):
    t = _written(side)
    body = {"uid": _uid_hex(t), "type": "metric", "displayName": "X"}
    out = [call(side, t, "POST", "/api/uid/uidmeta", body=body)[0]
           for _ in range(2)]
    assert out == [200, 304]
    return out


@case
def uidmeta_unknown_uid_404(side):
    t = tsdb(side, **TRACK)
    out = call(side, t, "POST", "/api/uid/uidmeta",
               body={"uid": "FFFFFF", "type": "metric",
                     "displayName": "X"})
    assert out[0] == 404
    return out


@case
def uidmeta_delete(side):
    t = _written(side)
    uid = _uid_hex(t)
    call(side, t, "POST", "/api/uid/uidmeta",
         body={"uid": uid, "type": "metric", "displayName": "X"})
    out = call(side, t, "DELETE", "/api/uid/uidmeta",
               params={"uid": uid, "type": "metric"})
    assert out[0] == 204 and t.meta.get_uid_meta("metric", uid) is None
    return out, call(side, t, "GET", "/api/uid/uidmeta",
                     params={"uid": uid, "type": "metric"})


@case
def tsmeta_post_put_delete_roundtrip(side):
    t = _written(side)
    tsuid = t.meta.all_ts_meta()[0].tsuid
    out = [call(side, t, "POST", "/api/uid/tsmeta",
                body={"tsuid": tsuid, "units": "ms", "retention": 30}),
           call(side, t, "PUT", "/api/uid/tsmeta",
                body={"tsuid": tsuid, "description": "d"}),
           call(side, t, "GET", "/api/uid/tsmeta", params={"tsuid": tsuid}),
           call(side, t, "DELETE", "/api/uid/tsmeta",
                params={"tsuid": tsuid})]
    assert out[0][1]["units"] == "ms" and out[1][1]["units"] == ""
    assert t.meta.get_ts_meta(tsuid) is None
    return out


@case
def tsmeta_unknown_tsuid_404(side):
    t = tsdb(side, **TRACK)
    out = call(side, t, "POST", "/api/uid/tsmeta",
               body={"tsuid": "00000100000100AAAA", "units": "x"})
    assert out[0] == 404
    return out


@case
def tsmeta_metric_spec_create(side):
    t = _written(side)
    out = call(side, t, "POST", "/api/uid/tsmeta",
               params={"m": "sys.cpu.user{host=a}", "create": "true"},
               body={"m": "sys.cpu.user{host=a}", "create": "true",
                     "displayName": "via-spec"})
    assert out[1]["displayName"] == "via-spec"
    return out


@case
def search_plugin_hooks_fire(side):
    t = _written(side)
    events = []

    class SP:
        def index_ts_meta(self, m):
            events.append(("its", m.tsuid))

        def delete_ts_meta(self, tsuid):
            events.append(("dts", tsuid))

        def index_uid_meta(self, m):
            events.append(("iuid", m.uid))

        def delete_uid_meta(self, m):
            events.append(("duid", m.uid))

    t.search_plugin = SP()
    uid = _uid_hex(t)
    call(side, t, "POST", "/api/uid/uidmeta",
         body={"uid": uid, "type": "metric", "displayName": "X"})
    call(side, t, "DELETE", "/api/uid/uidmeta",
         params={"uid": uid, "type": "metric"})
    assert ("iuid", uid) in events and ("duid", uid) in events
    return events


@case
def tsmeta_unknown_metric_spec_404(side):
    t = tsdb(side, **TRACK)
    out = call(side, t, "POST", "/api/uid/tsmeta",
               params={"m": "no.such{host=a}", "create": "true"})
    assert out[0] == 404
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_meta_case_equals_reference(name, monkeypatch):
    frozen_clock(monkeypatch)
    got, want = both(CASES[name])
    assert got == want


# -- the annotation endpoints -------------------------------------------------

def _annotation_rpcs(side):
    t = tsdb(side)
    t.add_point("m", T0, 1, {"host": "a"})
    tsuid = tsuid_of(t, "m", {"host": "a"})
    return [
        call(side, t, "POST", "/api/annotation",
             body={"tsuid": tsuid.lower(), "startTime": T0,
                   "description": "d", "custom": {"a": "1"}}),
        # POST merges into the stored note, PUT replaces it
        call(side, t, "POST", "/api/annotation",
             body={"tsuid": tsuid, "startTime": T0, "notes": "n",
                   "custom": {"b": "2"}}),
        call(side, t, "GET", "/api/annotation",
             params={"tsuid": tsuid, "start_time": T0}),
        call(side, t, "PUT", "/api/annotation",
             body={"tsuid": tsuid, "startTime": T0, "notes": "only"}),
        call(side, t, "GET", "/api/annotation",
             params={"tsuid": tsuid, "start_time": T0}),
        call(side, t, "POST", "/api/annotation", body={"description": "x"}),
        call(side, t, "POST", "/api/annotation",
             body={"startTime": True}),
        call(side, t, "POST", "/api/annotation/bulk",
             body=[{"startTime": T0 + 10, "description": "g1"},
                   {"startTime": T0 + 20, "description": "g2"},
                   {"tsuid": tsuid, "startTime": T0 + 30}]),
        call(side, t, "POST", "/api/annotation/bulk", body=[1]),
        call(side, t, "GET", "/api/annotations",
             params={"start_time": T0, "end_time": T0 + 15}),
        call(side, t, "POST", "/api/annotations"),
        call(side, t, "DELETE", "/api/annotation/bulk", body={}),
        call(side, t, "DELETE", "/api/annotation/bulk",
             body={"global": True, "startTime": T0, "endTime": T0 + 15}),
        call(side, t, "DELETE", "/api/annotation/bulk",
             body={"tsuids": [tsuid], "startTime": T0,
                   "endTime": T0 + 100}),
        call(side, t, "DELETE", "/api/annotation",
             params={"tsuid": tsuid, "start_time": T0}),
        call(side, t, "GET", "/api/annotations",
             params={"start_time": T0, "end_time": T0 + 100}),
        call(side, t, "PATCH", "/api/annotation"),
        t.annotations.version,
    ]


def test_annotation_endpoints_equal_reference():
    got, want = both(_annotation_rpcs)
    assert got == want
    assert [a[0] for a in got[:-1]] == [200, 200, 200, 200, 200, 400, 400,
                                        200, 400, 200, 405, 400, 200, 200,
                                        404, 200, 405]


def _bulk_writes(side):
    """Every bulk write path with TSMeta tracking on: the counters."""
    t = tsdb(side, **TRACK)
    t.add_points("m.a", T0 + np.arange(4), np.arange(4.0), {"host": "a"})
    t.add_point_groups([("m.b", {"host": "b"}, [0, 1], [T0, T0 + 1],
                         [1, 2.5])])
    t.import_buffer(b"m.c %d 1 host=c\nm.c %d 2 host=c\nm.c x 1 host=d\n"
                    % (T0, T0 + 1))
    return {tsuid_of(t, m, {"host": h}): t.meta.ts_counters[
        tsuid_of(t, m, {"host": h})] for m, h in (("m.a", "a"),
                                                  ("m.b", "b"),
                                                  ("m.c", "c"))}, \
        len(t.meta.uid_meta)


def test_bulk_write_paths_track_as_reference(monkeypatch):
    frozen_clock(monkeypatch)
    got, want = both(_bulk_writes)
    assert got == want
    assert sorted(got[0].values()) == [2, 2, 4]


def test_add_series_points_tracks_each_series(monkeypatch):
    """The port's columnar write (no reference twin): one meta count per
    series, equal to the reference's per-point writes of the same
    points."""
    frozen_clock(monkeypatch)
    from torch_meta_pair import JAX, PORT
    tags = [{"host": f"h{i}"} for i in range(5)]
    ts2d = T0 + np.arange(3)[None, :].repeat(5, axis=0)
    vals = np.arange(15.0).reshape(5, 3)
    t = tsdb(PORT, **TRACK)
    t.add_series_points("m", tags, ts2d, vals, counts=np.array(
        [3, 1, 0, 2, 3]))
    j = tsdb(JAX, **TRACK)
    for i, n in enumerate([3, 1, 0, 2, 3]):
        if n:
            j.add_points("m", ts2d[i, :n], vals[i, :n], tags[i])
    def by_series(x):
        # by names: the port's empty row made its tag value's UID
        return {(m.metric.name, tuple(u.name for u in m.tags)):
                (m.total_dps, m.created, m.last_received)
                for m in x.meta.all_ts_meta()}

    assert by_series(t) == by_series(j)
    assert len(by_series(t)) == 4
