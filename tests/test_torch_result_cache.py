"""The port's serve-path caches and sub-query fan-out
(``query/result_cache.py``, ``QueryEngine.run``/``_run_fanout``/
``_run_sub_cached``, ``TSDB._tagmat_cache``).

The classes mirror those of ``tests/test_result_cache.py`` that apply
to the port (it has no rollups, annotations, deletes or fault sites):
no test may observe a stale result after a write, N concurrent
identical queries run the engine once, the byte budget and the
relative-time TTL hold, sub-queries fan out on ``tsd-subq`` threads
and join in sub order, and ``delete=true`` stays serial and raises.
``TestParity`` runs the same TSQueries, before and after a write,
through the JAX package's TSDB and the port's with both caches on:
rows, emitted timestamps and values agree (float64, rtol 1e-9).

Every TSDB built here is shut down by the ``tsdbs`` fixture, which
joins its fan-out threads, so none outlives its test.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest

from opentsdb_tpu import TSDB as JTSDB
from opentsdb_tpu import Config as JConfig
from opentsdb_tpu.query.model import TSQuery as JQuery
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.query import result_cache as rc_mod
from opentsdb_tpu_torch.query.engine import QueryEngine, TagMatrix
from opentsdb_tpu_torch.query.model import TSQuery
from opentsdb_tpu_torch.query.result_cache import QueryResultCache
from torch_pair import jax_native_library

# the JAX TSDBs below use the JAX package's native store: take the
# tests' private build of its library
jax_native_library()

BASE = 1356998400


@pytest.fixture
def tsdbs():
    """Factory of CPU TSDBs (float64, auto-created metrics); each is
    shut down at teardown and its fan-out threads must have ended."""
    made = []

    def make(**extra):
        t = TSDB(Config(**{"tsd.torch.device": "cpu",
                           "tsd.torch.dtype": "float64",
                           "tsd.core.auto_create_metrics": "true",
                           **extra}))
        made.append(t)
        return t

    yield make
    threads = []
    for t in made:
        if t._fanout_pool is not None:
            threads += list(t._fanout_pool._threads)
        t.shutdown()
    assert not [th for th in threads if th.is_alive()]


def _seed(t, metric="m", n=5, pts=50):
    """n series of pts points at one a minute (a regular cadence, so a
    query without a downsample takes the point path's dense batch)."""
    rng = np.random.default_rng(0)
    ts = BASE + 60 * np.arange(pts)
    for i in range(n):
        t.add_points(metric, ts, rng.normal(10, 3, pts),
                     {"host": f"h{i}", "dc": f"d{i % 2}"})


def _q(metric="m", agg="sum", ds="1m-avg", start=BASE,
       end=BASE + 2999, **extra):
    sub = {"metric": metric, "aggregator": agg}
    if ds:
        sub["downsample"] = ds
    return TSQuery.from_json({
        "start": start * 1000, "end": end * 1000,
        "queries": [sub], **extra}).validate()


def _multi_q(n, metric="m", start=BASE, end=BASE + 2999):
    return TSQuery.from_json({
        "start": start * 1000, "end": end * 1000,
        "queries": [{"metric": metric, "aggregator": agg,
                     "downsample": "1m-avg"}
                    for agg in ("sum", "max", "min", "avg",
                                "count")[:n]]}).validate()


def _dps(results):
    return [(r.tags, r.sub_query_index, r.dps) for r in results]


class TestInvalidation:
    def test_write_then_version_bump_then_miss(self, tsdbs):
        t = tsdbs()
        _seed(t)
        r1 = t.execute_query(_q())
        r2 = t.execute_query(_q())
        rc = t.result_cache
        assert rc.hits == 1 and rc.misses == 1
        assert _dps(r1) == _dps(r2)
        t.add_point("m", BASE + 60, 1000.0, {"host": "h0", "dc": "d0"})
        r3 = t.execute_query(_q())
        assert rc.hits == 1 and rc.misses == 2
        assert _dps(r3) != _dps(r1)

    @pytest.mark.parametrize("write", ["add_point", "add_points",
                                       "add_point_groups",
                                       "add_series_points"])
    def test_every_write_path_invalidates(self, tsdbs, write):
        t = tsdbs()
        _seed(t)
        before = _dps(t.execute_query(_q()))
        tags = {"host": "h1", "dc": "d1"}
        if write == "add_point":
            t.add_point("m", BASE + 120, 99.0, tags)
        elif write == "add_points":
            t.add_points("m", [BASE + 120], [99.0], tags)
        elif write == "add_point_groups":
            t.add_point_groups([("m", tags, [0], [BASE + 120], [99.0])])
        else:
            t.add_series_points("m", [tags], np.array([[BASE + 120]]),
                                np.array([[99.0]]))
        after = _dps(t.execute_query(_q()))
        assert after != before
        assert t.result_cache.hits == 0
        fresh = tsdbs(**{"tsd.query.cache.enable": "false"})
        fresh.store, fresh.uids = t.store, t.uids
        assert _dps(fresh.execute_query(_q())) == after

    def test_dropcaches_empties(self, tsdbs):
        t = tsdbs()
        _seed(t)
        t.execute_query(_q())
        rc = t.result_cache
        assert rc.total_entries == 1 and rc.total_bytes > 0
        t.drop_caches()
        assert rc.total_entries == 0 and rc.total_bytes == 0
        t.execute_query(_q())
        assert rc.misses == 2


class TestSingleFlight:
    def test_n_concurrent_identical_one_execution(self, tsdbs):
        t = tsdbs()
        _seed(t)
        calls = []
        release = threading.Event()
        orig = t.store.materialize_padded

        def counted(*a, **k):
            calls.append(threading.get_ident())
            release.wait(5)
            return orig(*a, **k)

        t.store.materialize_padded = counted
        n = 6
        results: list = [None] * n
        errors: list = []

        def worker(i):
            try:
                results[i] = t.execute_query(_q(ds=None))
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        # let every thread reach the cache before the leader finishes
        deadline = time.monotonic() + 5
        while t.result_cache.coalesced + len(calls) < n \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        release.set()
        for th in threads:
            th.join(10)
        assert not any(th.is_alive() for th in threads)
        assert not errors, errors
        assert len(calls) == 1, f"engine executed {len(calls)} times"
        rc = t.result_cache
        assert rc.coalesced == n - 1 and rc.misses == 1
        for r in results[1:]:
            assert _dps(r) == _dps(results[0])

    def test_failed_leader_propagates_and_does_not_poison(self, tsdbs):
        t = tsdbs()
        _seed(t)
        release = threading.Event()

        def boom(*a, **k):
            release.wait(5)
            raise OSError("injected scan failure")

        orig = t.store.materialize_padded
        t.store.materialize_padded = boom
        n = 4
        errors: list = []

        def worker():
            try:
                t.execute_query(_q(ds=None))
            except OSError as exc:
                errors.append(exc)

        threads = [threading.Thread(target=worker) for _ in range(n)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 5
        rc = t.result_cache
        while rc.misses + rc.coalesced < n \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        release.set()
        for th in threads:
            th.join(10)
        assert not any(th.is_alive() for th in threads)
        assert len(errors) == n
        assert rc.total_entries == 0  # the error was never cached
        t.store.materialize_padded = orig
        assert t.execute_query(_q(ds=None))

    def test_stress_versions_never_cross(self):
        """Many threads (more than cores), few keys, a version that
        moves under them, and a short switch interval: every answer is
        the one computed for the version its caller captured, and the
        outcomes partition the lookups."""
        cache = QueryResultCache(1 << 16, shards=2)
        version = [0]
        lookups = [0]
        bad: list = []
        lock = threading.Lock()

        def worker(seed):
            rng = np.random.default_rng(seed)
            for _ in range(200):
                key = ("k", int(rng.integers(0, 3)))
                if rng.random() < 0.05:
                    with lock:
                        version[0] += 1
                ver = (version[0],)
                value, _ = cache.get_or_compute(
                    key, ver, lambda v=ver, k=key: [(k, v)])
                with lock:
                    lookups[0] += 1
                if value != [(key, ver)]:
                    bad.append((key, ver, value))

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(32)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(30)
        finally:
            sys.setswitchinterval(old)
        assert not any(th.is_alive() for th in threads)
        assert not bad, bad[:3]
        assert cache.hits + cache.misses + cache.coalesced == lookups[0]


class TestRelativeTimeTTL:
    @staticmethod
    def _rq(downsample="1m-avg"):
        sub = {"metric": "m", "aggregator": "sum"}
        if downsample:
            sub["downsample"] = downsample
        return TSQuery.from_json({"start": "1h-ago", "queries": [sub]}) \
            .validate(now_ms=(BASE + 3000) * 1000)

    def test_relative_with_downsample_hits_within_ttl(self, tsdbs):
        t = tsdbs()
        _seed(t)
        r1 = t.execute_query(self._rq())
        r2 = t.execute_query(self._rq())
        rc = t.result_cache
        assert rc.hits == 1 and rc.misses == 1
        assert _dps(r1) == _dps(r2)

    def test_ttl_expiry_recomputes(self, tsdbs):
        t = tsdbs()
        _seed(t)
        t.execute_query(self._rq())
        rc = t.result_cache
        # age the entry past its 60 s (1m downsample) TTL
        rc._clock = lambda base=time.monotonic: base() + 61.0
        t.execute_query(self._rq())
        assert rc.hits == 0 and rc.misses == 2

    def test_relative_without_downsample_bypasses(self, tsdbs):
        t = tsdbs()
        _seed(t)
        t.execute_query(self._rq(downsample=None))
        assert t.result_cache.bypasses == 1
        assert t.result_cache.total_entries == 0

    def test_absolute_entries_have_no_ttl(self, tsdbs):
        t = tsdbs()
        _seed(t)
        t.execute_query(_q())
        rc = t.result_cache
        rc._clock = lambda base=time.monotonic: base() + 3600.0
        t.execute_query(_q())
        assert rc.hits == 1


class TestEvictionAndBudget:
    @staticmethod
    def _results(nbytes):
        class R:
            dps_arrays = (np.zeros(max(nbytes // 16, 1)),
                          np.zeros(max(nbytes // 16, 1)))
            tsuids: list = []
        return [R()]

    def test_byte_budget_evicts_lru(self):
        cache = QueryResultCache(8192, shards=1)
        v = (1,)
        for i in range(16):
            cache.get_or_compute(("k", i), v, lambda: self._results(2048))
        assert cache.evicted > 0
        assert cache.total_bytes <= cache.max_bytes
        assert cache._get(("k", 15), v, 0) is not rc_mod._MISSING
        assert cache._get(("k", 0), v, 0) is rc_mod._MISSING

    def test_oversized_value_never_cached(self):
        cache = QueryResultCache(1024, shards=1)
        cache.get_or_compute(("big",), (1,),
                             lambda: self._results(1 << 20))
        assert cache.total_entries == 0

    def test_version_mismatch_drops_entry_bytes(self):
        cache = QueryResultCache(1 << 20, shards=2)
        cache.get_or_compute(("k",), (1,), lambda: self._results(512))
        b1 = cache.total_bytes
        assert b1 > 0
        cache.get_or_compute(("k",), (2,), lambda: self._results(512))
        assert cache.total_bytes == b1  # replaced, not leaked
        assert cache.total_entries == 1

    def test_lookup_and_store(self):
        cache = QueryResultCache(1 << 20, shards=2)
        assert cache.lookup(("k",), (1,)) is None
        cache.store(("k",), (1,), ["v"])
        assert cache.lookup(("k",), (1,)) == ["v"]
        assert cache.lookup(("k",), (2,)) is None
        assert (cache.hits, cache.misses) == (1, 2)

    def test_cache_mb_zero_disables(self, tsdbs):
        t = tsdbs(**{"tsd.query.cache.mb": "0"})
        _seed(t)
        t.execute_query(_q())
        assert t.result_cache is None

    def test_enable_false_disables_but_is_runtime_togglable(self, tsdbs):
        t = tsdbs(**{"tsd.query.cache.enable": "false"})
        _seed(t)
        t.execute_query(_q())
        assert t.result_cache is None
        t.config.override_config("tsd.query.cache.enable", "true")
        t.execute_query(_q())
        t.execute_query(_q())
        assert t.result_cache.hits == 1


class TestFanout:
    def test_ordering_threads_and_serial_equality(self, tsdbs,
                                                  monkeypatch):
        t = tsdbs()
        _seed(t)
        names = []
        orig = QueryEngine._run_sub
        monkeypatch.setattr(
            QueryEngine, "_run_sub", lambda self, tsq, sub: names.append(
                threading.current_thread().name) or orig(self, tsq, sub))
        results = t.execute_query(_multi_q(4))
        idxs = [r.sub_query_index for r in results]
        assert idxs == sorted(idxs) and set(idxs) == {0, 1, 2, 3}
        # the first sub on the calling thread, the rest on the pool
        assert len(names) == 4
        assert sum(n.startswith("tsd-subq") for n in names) >= 1
        assert names.count(threading.current_thread().name) >= 1
        serial = tsdbs(**{"tsd.query.fanout.workers": "0"})
        _seed(serial)
        assert serial.query_fanout_pool is None
        assert _dps(results) == _dps(serial.execute_query(_multi_q(4)))

    def test_parallel_faster_than_serial_on_4_subs(self, tsdbs):
        # a store with a fixed per-scan latency makes the speedup
        # deterministic: 4 subs x 150 ms serial vs ~150 ms fanned out
        delay = 0.15

        def slow_store(t):
            orig = t.store.bucket_reduce

            def slow(*a, **k):
                time.sleep(delay)
                return orig(*a, **k)
            t.store.bucket_reduce = slow

        # no device cache: the four subs share one grid, and every
        # sub must scan
        t_par = tsdbs(**{"tsd.query.device_cache_mb": "0"})
        _seed(t_par)
        t_ser = tsdbs(**{"tsd.query.fanout.workers": "0",
                         "tsd.query.device_cache_mb": "0"})
        _seed(t_ser)
        slow_store(t_par)
        slow_store(t_ser)
        q = _multi_q(4)
        t0 = time.perf_counter()
        r_par = t_par.execute_query(q)
        par_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r_ser = t_ser.execute_query(_multi_q(4))
        ser_s = time.perf_counter() - t0
        assert _dps(r_par) == _dps(r_ser)
        assert ser_s >= 4 * delay
        assert par_s < ser_s - delay, (par_s, ser_s)

    def test_fanout_error_propagates_earliest_sub(self, tsdbs):
        t = tsdbs()
        _seed(t)
        with pytest.raises(Exception) as exc_info:
            t.execute_query(TSQuery.from_json({
                "start": BASE * 1000, "end": (BASE + 2999) * 1000,
                "queries": [
                    {"metric": "m", "aggregator": "sum"},
                    {"metric": "no.such.metric", "aggregator": "sum"},
                    {"metric": "m", "aggregator": "p99"},
                ]}).validate())
        assert "no.such.metric" in str(exc_info.value)

    def test_identical_subs_in_one_query_coalesce(self, tsdbs):
        t = tsdbs()
        _seed(t)
        tsq = TSQuery.from_json({
            "start": BASE * 1000, "end": (BASE + 2999) * 1000,
            "queries": [{"metric": "m", "aggregator": "sum",
                         "downsample": "1m-avg"}] * 2}).validate()
        results = t.execute_query(tsq)
        assert sorted({r.sub_query_index for r in results}) == [0, 1]
        rc = t.result_cache
        assert rc.misses == 1
        assert rc.coalesced + rc.hits == 1


class TestCacheKeying:
    @pytest.mark.parametrize("flag", ["showTSUIDs", "msResolution"])
    def test_output_flags_are_part_of_the_key(self, tsdbs, flag):
        t = tsdbs()
        _seed(t)
        t.execute_query(_q())
        t.execute_query(_q(**{flag: True}))
        rc = t.result_cache
        assert rc.misses == 2 and rc.hits == 0
        r = t.execute_query(_q(**{flag: True}))
        assert rc.hits == 1
        if flag == "showTSUIDs":
            assert r[0].tsuids

    def test_sub_identity_is_the_key(self):
        a = _q().queries[0]
        b = _q(agg="max").queries[0]
        c = _q().queries[0]
        c.index = 3
        assert a.identity_key() != b.identity_key()
        assert a.identity_key() == c.identity_key()
        tsq = _q()
        assert rc_mod.cache_plan(tsq, a, Config())[0] \
            == rc_mod.cache_plan(tsq, c, Config())[0]

    def test_sub_index_relabeled_on_cross_query_hit(self, tsdbs):
        t = tsdbs()
        _seed(t, metric="a")
        _seed(t, metric="b")
        tsq = TSQuery.from_json({
            "start": BASE * 1000, "end": (BASE + 2999) * 1000,
            "queries": [
                {"metric": "a", "aggregator": "sum",
                 "downsample": "1m-avg"},
                {"metric": "b", "aggregator": "sum",
                 "downsample": "1m-avg"}]}).validate()
        t.execute_query(tsq)
        rb = t.execute_query(_q(metric="b"))
        assert t.result_cache.hits == 1
        assert all(r.sub_query_index == 0 for r in rb)


class TestWaiterReadAfterWrite:
    def test_newer_version_waiter_recomputes(self):
        cache = QueryResultCache(1 << 20, shards=1)
        in_compute = threading.Event()
        release = threading.Event()

        def slow_old():
            in_compute.set()
            release.wait(5)
            return ["old"]

        out = {}

        def leader():
            out["leader"] = cache.get_or_compute(("k",), (1,), slow_old)

        def waiter():
            in_compute.wait(5)
            out["waiter"] = cache.get_or_compute(
                ("k",), (2,), lambda: ["new"])

        tl = threading.Thread(target=leader)
        tw = threading.Thread(target=waiter)
        tl.start()
        in_compute.wait(5)
        tw.start()
        time.sleep(0.1)  # the waiter is parked on the flight
        release.set()
        tl.join(5)
        tw.join(5)
        assert not tl.is_alive() and not tw.is_alive()
        assert out["leader"] == (["old"], "miss")
        assert out["waiter"][0] == ["new"]
        got, how = cache.get_or_compute(("k",), (2,),
                                        lambda: ["recomputed"])
        assert got == ["new"] and how == "hit"

    def test_same_version_waiter_still_coalesces(self):
        cache = QueryResultCache(1 << 20, shards=1)
        in_compute = threading.Event()
        release = threading.Event()
        calls = []

        def slow():
            calls.append(1)
            in_compute.set()
            release.wait(5)
            return ["v"]

        out = {}
        tl = threading.Thread(target=lambda: out.update(
            leader=cache.get_or_compute(("k",), (1,), slow)))
        tw = threading.Thread(target=lambda: (
            in_compute.wait(5),
            out.update(waiter=cache.get_or_compute(("k",), (1,), slow))))
        tl.start()
        in_compute.wait(5)
        tw.start()
        time.sleep(0.1)
        release.set()
        tl.join(5)
        tw.join(5)
        assert not tl.is_alive() and not tw.is_alive()
        assert len(calls) == 1
        assert out["waiter"] == (["v"], "coalesced")

    def test_flight_completes_even_when_put_fails(self):
        cache = QueryResultCache(1 << 20, shards=1)
        orig_put = cache._put
        cache._put = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("bookkeeping"))
        value, outcome = cache.get_or_compute(("k",), (1,),
                                              lambda: ["v"])
        assert value == ["v"] and outcome == "miss"
        assert not cache._inflight
        cache._put = orig_put
        assert cache.get_or_compute(("k",), (1,),
                                    lambda: ["w"])[0] == ["w"]


class TestDeleteQueriesStaySerial:
    def test_multi_sub_delete_raises_before_fanout_or_cache(
            self, tsdbs, monkeypatch):
        """A multi-sub ``delete=true`` query runs its subs one after
        another, bypasses the result cache and answers as the reference
        (each sub reads the window, then deletes it: the second sub
        finds nothing); without delete the subs fan out."""
        t = tsdbs()
        _seed(t)
        jt = JTSDB(JConfig(**{"tsd.core.auto_create_metrics": "true",
                              "tsd.tpu.platform": "cpu"}))
        _seed(jt)

        def no_fanout(*a, **k):
            raise AssertionError("delete query took the fan-out path")

        monkeypatch.setattr(QueryEngine, "_run_fanout", no_fanout)
        body = {"start": BASE * 1000, "end": (BASE + 2999) * 1000,
                "delete": True,
                "queries": [{"metric": "m", "aggregator": "sum"},
                            {"metric": "m", "aggregator": "max"}]}
        tsq = TSQuery.from_json(body).validate()
        try:
            got = t.execute_query(tsq)
            want = jt.execute_query(JQuery.from_json(body).validate())
        finally:
            jt.shutdown()
        assert [(r.metric, r.sub_query_index) for r in got] == \
            [(r.metric, r.sub_query_index) for r in want] == [("m", 0)]
        np.testing.assert_array_equal(got[0].dps_arrays[0],
                                      [ts for ts, _ in want[0].dps])
        np.testing.assert_allclose(got[0].dps_arrays[1],
                                   [v for _, v in want[0].dps], rtol=1e-6)
        # both subs bypassed the cache: no entry was made
        assert t.result_cache.bypasses == 2
        assert t.result_cache.total_entries == 0
        # non-delete multi-sub queries still fan out
        tsq.delete = False
        with pytest.raises(AssertionError, match="fan-out"):
            t.execute_query(tsq)


class TestTagMatrixCache:
    def test_hit_miss_on_new_series_and_subarray(self, tsdbs,
                                                 monkeypatch):
        t = tsdbs(**{"tsd.query.cache.enable": "false"})
        _seed(t)
        built = []
        orig = TagMatrix.from_triples.__func__
        monkeypatch.setattr(
            TagMatrix, "from_triples", classmethod(
                lambda cls, sids, triples: built.append(len(sids))
                or orig(cls, sids, triples)))
        t.execute_query(_q(ds="1m-avg"))
        t.execute_query(_q(agg="max"))
        assert built == [5]  # the second query hit the matrix
        mid = t.uids.metrics.get_id("m")
        key = (t.store.instance_id, mid)
        assert t._tagmat_cache[key][0] == 5
        # a new series: the index grew, so the matrix is rebuilt
        t.add_point("m", BASE, 1.0, {"host": "h9", "dc": "d0"})
        t.execute_query(_q())
        assert built == [5, 6] and t._tagmat_cache[key][0] == 6
        # a filtered sub-array of the series is neither served nor
        # stored from the cache
        sids = t.store.series_ids_for_metric(mid)
        sub = _q().queries[0]
        eng = t.new_query()
        got_sids, tags = eng._apply_filters(mid, sub, sids[:3].copy())
        assert built == [5, 6, 3] and tags.num_series == 3
        assert t._tagmat_cache[key][0] == 6
        assert t._tagmat_cache[key][1].num_series == 6


class TestParity:
    """The JAX package's TSDB and the port's, both with their result
    and device caches on (the reference's host-CPU tail off), answer
    the same TSQueries alike before and after a write, hit for hit."""

    QUERIES = [
        ["sum:5m-avg:rate:m{dc=*}"],
        ["max:2m-min:m{host=*}", "sum:m{dc=d1}"],
        ["avg:10m-sum:m", "dev:5m-avg:m{dc=*}",
         "count:1m-count:m{host=h1|h3}"],
    ]

    @staticmethod
    def _rows(results):
        return [(r.sub_query_index, r.metric, r.tags,
                 sorted(r.aggregated_tags), [ts for ts, _ in r.dps],
                 [v for _, v in r.dps]) for r in results]

    def _both(self, jt, tt, subs):
        from opentsdb_tpu_torch.query.model import parse_uri_subquery
        queries = []
        for m in subs:
            sub = parse_uri_subquery(m)
            q = {"aggregator": sub.aggregator, "metric": sub.metric,
                 "rate": sub.rate,
                 "filters": [{"type": f.filter_name, "tagk": f.tagk,
                              "filter": f.filter_expr,
                              "groupBy": f.group_by}
                             for f in sub.filters]}
            if sub.downsample:
                q["downsample"] = sub.downsample
            queries.append(q)
        body = {"start": str(BASE), "end": str(BASE + 2999),
                "queries": queries}
        want = self._rows(jt.execute_query(JQuery.from_json(body)
                                           .validate()))
        got = self._rows(tt.execute_query(TSQuery.from_json(body)
                                          .validate()))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g[:5] == w[:5]
            np.testing.assert_allclose(g[5], w[5], rtol=1e-9, atol=1e-9)
        return got

    def test_queries_before_and_after_a_write(self, tsdbs):
        jt = JTSDB(JConfig(**{"tsd.core.auto_create_metrics": "true",
                              "tsd.tpu.platform": "cpu",
                              "tsd.query.host_tail_max_cells": "-1",
                              "tsd.query.host_tail_max_cells_linear":
                                  "-1"}))
        try:
            tt = tsdbs()
            for db in (jt, tt):
                _seed(db, n=8)
            cold = [self._both(jt, tt, q) for q in self.QUERIES]
            warm = [self._both(jt, tt, q) for q in self.QUERIES]
            assert warm == cold
            assert (tt.result_cache.hits, tt.result_cache.misses) \
                == (jt.result_cache.hits, jt.result_cache.misses) == (6, 6)
            for db in (jt, tt):
                db.add_point("m", BASE + 600, 500.0,
                             {"host": "h2", "dc": "d0"})
            after = [self._both(jt, tt, q) for q in self.QUERIES]
            assert after != cold
            assert tt.result_cache.misses == jt.result_cache.misses == 12
        finally:
            pool = jt._fanout_pool
            jt.shutdown()
            if pool is not None:
                pool.shutdown(wait=True)

