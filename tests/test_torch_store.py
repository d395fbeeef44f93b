"""The port's two stores, each test a case of both backends: the
columnar memory store (``opentsdb_tpu_torch.core.store``) and the native
store (``opentsdb_tpu_torch.native.store_backend``), against the
reference's portable store (``opentsdb_tpu.core.store``) under the same
writes: ragged series, out-of-order chunks, duplicate timestamps (last
write wins), and inclusive range reads. ``test_torch_native_store.py``
holds the native store against the reference's native one."""

import sys
import threading

import numpy as np
import pytest

from opentsdb_tpu.core.store import TimeSeriesStore as JStore
from opentsdb_tpu_torch.core.store import TimeSeriesStore
from opentsdb_tpu_torch.native.store_backend import NativeTimeSeriesStore

T0 = 1_356_998_400_000
BACKENDS = {"memory": TimeSeriesStore, "native": NativeTimeSeriesStore}
backends = pytest.mark.parametrize("backend", sorted(BACKENDS))


def TStore(backend: str):
    return BACKENDS[backend]()


def _fill(seed: int, backend: str):
    rng = np.random.default_rng(seed)
    j, t = JStore(num_shards=4), TStore(backend)
    tags = [((1, i), (2, i % 3)) for i in range(25)]
    js = j.get_or_create_series_bulk(7, tags)
    ts_ = t.get_or_create_series_bulk(7, tags)
    np.testing.assert_array_equal(js, ts_)
    for chunk in range(4):
        sids = rng.integers(0, 25, 300)
        ts = T0 + 1000 * rng.integers(0, 500, 300)
        vals = rng.normal(size=300)
        j.append_lines(sids, ts, vals, np.zeros(300, dtype=bool))
        t.append_lines(sids, ts, vals)
        if chunk == 1:
            # a read between writes: the next fold merges into data
            # that is already sorted
            np.testing.assert_array_equal(
                t.count_range(ts_, 0, 2**62), j.count_range(js, 0, 2**62))
    return j, t, js


@backends
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lo,hi", [(0, 2**62), (T0 + 100_000, T0 + 300_000),
                                   (T0 + 250_500, T0 + 250_999),
                                   (T0 + 499_000, T0 + 499_000)])
def test_range_reads_match_reference(seed, lo, hi, backend):
    j, t, sids = _fill(seed, backend)
    sel = sids[::2][::-1]          # a subset, out of order
    np.testing.assert_array_equal(t.count_range(sel, lo, hi),
                                  j.count_range(sel, lo, hi))
    jp = j.materialize_padded(sel, lo, hi)
    tp = t.materialize_padded(sel, lo, hi)
    np.testing.assert_array_equal(tp.counts, jp.counts)
    np.testing.assert_array_equal(tp.ts2d, jp.ts2d)
    np.testing.assert_array_equal(tp.values2d, jp.values2d)
    assert tp.num_points == jp.num_points


@backends
def test_metric_index_and_errors(backend):
    t = TStore(backend)
    a = t.get_or_create_series_bulk(1, [((5, 9),), ((5, 8), (6, 1))])
    b = t.get_or_create_series(1, ((6, 1), (5, 8)))   # same tag set
    assert b == a[1]
    sids, triples = t.metric_index(1).arrays()
    np.testing.assert_array_equal(sids, a)
    assert sorted(map(tuple, triples.tolist())) == \
        [(0, 5, 9), (1, 5, 8), (1, 6, 1)]
    assert len(t.series_ids_for_metric(2)) == 0
    with pytest.raises(IndexError):
        t.append_lines([5], [T0], [1.0])
    with pytest.raises(ValueError):
        t.append_lines([0, 1], [T0], [1.0])
    assert t.append_lines([-1, 0], [T0, T0], [1.0, 2.0]) == 1


@backends
def test_metric_index_folds_once_under_concurrent_readers(backend):
    """Sub-queries read a metric's index from several threads while
    series are added: every series id appears once, however the reads
    and the writes interleave (more threads than cores, a short switch
    interval)."""
    t = TStore(backend)
    stop = threading.Event()
    seen_dup = []

    def reader():
        while not stop.is_set():
            idx = t.metric_index(7)
            if idx is not None:
                sids, _ = idx.arrays()
                if len(np.unique(sids)) != len(sids):
                    seen_dup.append(len(sids))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=reader) for _ in range(16)]
    try:
        for th in threads:
            th.start()
        for i in range(400):
            t.get_or_create_series_bulk(7, [((1, i), (2, 0))])
    finally:
        stop.set()
        for th in threads:
            th.join(10)
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    sids, triples = t.metric_index(7).arrays()
    assert not seen_dup
    np.testing.assert_array_equal(sids, np.arange(400))
    assert len(triples) == 800
