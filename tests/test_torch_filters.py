"""The port's ``regexp`` and ``not_key`` filters against the JAX
package: parsing (the ``type(expr)`` shorthand, the JSON form, the
old-style tag map), value matching, the planner's handling of
``match_absent``/``includes_present`` in ``FilterEvaluator.apply``
(an unknown key, several filters on one key, a key every series lacks),
and whole queries through both ``TSDB.execute_query``.
"""

import numpy as np
import pytest

from opentsdb_tpu.query import filters as jflt
from opentsdb_tpu_torch.query import filters as tflt
from torch_pair import (ENGINE_KEYS, GRID_ON, irregular, port_tsdb,
                        reference_tsdb, run_both, uri_query)

VALUES = ["web01", "web02", "db01", "Web03", "cache-a", "", "web", "xweb1"]


@pytest.mark.parametrize("expr", ["web.*", "^web0[12]$", "w", ".*",
                                  "(db|cache).*", "[A-Z].*"])
def test_regexp_matches_like_reference(expr):
    j, t = jflt.get_filter("host", f"regexp({expr})"), \
        tflt.get_filter("host", f"regexp({expr})")
    assert (t.filter_name, t.filter_expr, t.group_by) == \
        (j.filter_name, j.filter_expr, j.group_by)
    assert [t.match_value(v) for v in VALUES] == \
        [j.match_value(v) for v in VALUES]
    assert not t.match_absent and t.includes_present


def test_not_key_parses_like_reference():
    for make in (lambda m: m.get_filter("host", "not_key()"),
                 lambda m: m.build_filter({"type": "not_key",
                                           "tagk": "host", "filter": ""})):
        j, t = make(jflt), make(tflt)
        assert (t.filter_name, t.group_by, t.match_absent,
                t.includes_present) == (j.filter_name, j.group_by,
                                        j.match_absent, j.includes_present)
        assert t.match_absent and not t.includes_present
    for mod in (jflt, tflt):
        with pytest.raises(ValueError):
            mod.get_filter("host", "not_key(web01)")
        with pytest.raises(ValueError):
            mod.build_filter({"type": "not_key", "tagk": "host",
                              "filter": "", "groupBy": True})


def test_tag_map_conversion_groups_regexp():
    tags = {"host": "regexp(web.*)", "dc": "not_key()", "rack": "r1|r2"}
    got = [(f.filter_name, f.tagk, f.group_by)
           for f in tflt.tags_to_filters(tags)]
    want = [(f.filter_name, f.tagk, f.group_by)
            for f in jflt.tags_to_filters(tags)]
    assert got == want


@pytest.fixture(scope="module")
def pair():
    """120 series of metric ``f``; every 4th lacks the ``rack`` key and
    every 6th carries an ``env`` key."""
    tags, ts2d, v2d, counts = irregular(120, 30, seed=41)
    for i, t in enumerate(tags):
        if i % 4 == 0:
            del t["rack"]
        if i % 6 == 0:
            t["env"] = "prod" if i % 12 else "dev"
    metrics = {"f": (tags, ts2d, v2d, counts)}
    jt = reference_tsdb(metrics)
    return jt, port_tsdb(jt, metrics)


FILTER_SETS = [
    [("regexp", "host", "h0[0-4].*", True)],
    [("regexp", "rack", "r[0-9]$", False)],
    [("not_key", "rack", "", False)],
    [("not_key", "env", "", False), ("regexp", "dc", "dc[12]", True)],
    [("not_key", "nosuchkey", "", False)],
    [("not_key", "nosuchkey", "", False), ("wildcard", "dc", "dc*", True)],
    [("regexp", "nosuchkey", ".*", False)],
    [("regexp", "host", "h1.*", False), ("regexp", "host", ".*5$", True)],
    [("not_key", "rack", "", False), ("literal_or", "rack", "r1", False)],
]


def _mask(mod, uids_owner, filters, sids, triples):
    ev = mod.FilterEvaluator(uids_owner.uids)
    return ev.apply([mod.build_filter({"type": t, "tagk": k, "filter": e,
                                       "groupBy": g})
                     for t, k, e, g in filters], sids, triples)


@pytest.mark.parametrize("filters", FILTER_SETS,
                         ids=lambda fs: "+".join(f[0] for f in fs))
def test_evaluator_matches_reference(pair, filters):
    """The series mask of each filter set, with ``match_absent`` for
    ``not_key`` (also on a key that no series has)."""
    jt, tt = pair
    mid = jt.uids.metrics.get_id("f")
    jsids, jtrip = jt.store.metric_index(mid).arrays()
    tmid = tt.uids.metrics.get_id("f")
    tsids, ttrip = tt.store.metric_index(tmid).arrays()
    want = _mask(jflt, jt, filters, jsids, jtrip)
    got = _mask(tflt, tt, filters, tsids, ttrip)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid", ["off", "on"])
@pytest.mark.parametrize("filters", FILTER_SETS[:6] + FILTER_SETS[7:8],
                         ids=lambda fs: "+".join(f[0] for f in fs))
def test_filter_query_matches_reference(pair, filters, grid):
    jt, tt = pair
    keys = GRID_ON if grid == "on" else ENGINE_KEYS
    for key, value in keys.items():
        jt.config.override_config(key, value)
        tt.config.override_config(key, value)
    q = uri_query("sum:5m-avg:f")
    q["queries"][0]["filters"] = [
        {"type": t, "tagk": k, "filter": e, "groupBy": g}
        for t, k, e, g in filters]
    run_both(jt, tt, q)


def test_not_key_with_explicit_tags(pair):
    """``explicitTags`` keeps the series whose key set equals the
    filters' keys, ``not_key``'s key among them, as in the reference:
    so no series passes both, in either package."""
    jt, tt = pair
    for key, value in ENGINE_KEYS.items():
        jt.config.override_config(key, value)
        tt.config.override_config(key, value)
    q = uri_query("sum:5m-avg:f")
    q["queries"][0]["explicitTags"] = True
    q["queries"][0]["filters"] = [
        {"type": "wildcard", "tagk": k, "filter": "*", "groupBy": False}
        for k in ("host", "dc")] + [
        {"type": "not_key", "tagk": "env", "filter": "", "groupBy": False}]
    from opentsdb_tpu.query.model import TSQuery as JQuery
    from opentsdb_tpu_torch.query.model import TSQuery
    want = jt.execute_query(JQuery.from_json(q).validate())
    got = tt.execute_query(TSQuery.from_json(q).validate())
    assert len(got) == len(want) == 0
