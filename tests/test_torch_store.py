"""The port's columnar store (``opentsdb_tpu_torch.core.store``) against
the reference's portable store (``opentsdb_tpu.core.store``) under the
same writes: ragged series, out-of-order chunks, duplicate timestamps
(last write wins), and inclusive range reads."""

import numpy as np
import pytest

from opentsdb_tpu.core.store import TimeSeriesStore as JStore
from opentsdb_tpu_torch.core.store import TimeSeriesStore as TStore

T0 = 1_356_998_400_000


def _fill(seed: int):
    rng = np.random.default_rng(seed)
    j, t = JStore(num_shards=4), TStore()
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


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lo,hi", [(0, 2**62), (T0 + 100_000, T0 + 300_000),
                                   (T0 + 250_500, T0 + 250_999),
                                   (T0 + 499_000, T0 + 499_000)])
def test_range_reads_match_reference(seed, lo, hi):
    j, t, sids = _fill(seed)
    sel = sids[::2][::-1]          # a subset, out of order
    np.testing.assert_array_equal(t.count_range(sel, lo, hi),
                                  j.count_range(sel, lo, hi))
    jp = j.materialize_padded(sel, lo, hi)
    tp = t.materialize_padded(sel, lo, hi)
    np.testing.assert_array_equal(tp.counts, jp.counts)
    np.testing.assert_array_equal(tp.ts2d, jp.ts2d)
    np.testing.assert_array_equal(tp.values2d, jp.values2d)
    assert tp.num_points == jp.num_points


def test_metric_index_and_errors():
    t = TStore()
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
