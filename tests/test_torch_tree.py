"""The port's trees (``opentsdb_tpu_torch/tree/``) against the JAX
package's, on the CPU.

The 46 cases of ``tests/test_tree.py`` (TreeRule, TreeBuilder, Tree
CRUD and Branch, the TreeManager against a TSDB, the display formatter,
strict and testing modes), each run as one scenario on both packages
with the clock pinned, each also asserting what ``tests/test_tree.py``
asserts. Then ``/api/tree`` and its sub-endpoints through both routers,
and realtime filing from the meta hook
(``tsd.core.tree.enable_processing``).

Tolerance: none; paths, branch and tree JSON, statuses compare exactly.
"""

import pytest

from torch_meta_pair import T0, both, call, frozen_clock, tsdb, tsuid_of

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _rule(side, **kw):
    return side.tree.TreeRule(**kw)


# -- TreeRule (ref: TestTreeRule.java) ---------------------------------------

@case
def invalid_type_raises(side):
    with pytest.raises(ValueError) as e:
        _rule(side, type="BOGUS")
    return str(e.value)


@case
def type_case_normalized(side):
    out = _rule(side, type="metric").type
    assert out == "METRIC"
    return out


@case
def metric_rule_extracts_metric(side):
    out = _rule(side, type="METRIC").extract("sys.cpu.user", {}, {})
    assert out == ["sys.cpu.user"]
    return out


@case
def metric_rule_with_separator_splits(side):
    out = _rule(side, type="METRIC", separator=".").extract(
        "sys.cpu.user", {}, {})
    assert out == ["sys", "cpu", "user"]
    return out


@case
def separator_drops_empty_parts(side):
    out = _rule(side, type="METRIC", separator=".").extract("sys..cpu",
                                                            {}, {})
    assert out == ["sys", "cpu"]
    return out


@case
def tagk_rule_reads_tag_value(side):
    out = _rule(side, type="TAGK", field="host").extract(
        "m", {"host": "web01"}, {})
    assert out == ["web01"]
    return out


@case
def tagk_rule_missing_tag_returns_none(side):
    out = _rule(side, type="TAGK", field="host").extract(
        "m", {"dc": "lax"}, {})
    assert out is None
    return out


@case
def custom_rules_read_custom_fields(side):
    out = []
    for t in ("METRIC_CUSTOM", "TAGK_CUSTOM", "TAGV_CUSTOM"):
        rule = _rule(side, type=t, custom_field="owner")
        out.append((rule.extract("m", {}, {"owner": "ops"}),
                    rule.extract("m", {}, {})))
    assert out == [(["ops"], None)] * 3
    return out


@case
def regex_extracts_group_one(side):
    out = _rule(side, type="TAGK", field="host",
                regex=r"^(\w+)\.example\.com$").extract(
        "m", {"host": "web01.example.com"}, {})
    assert out == ["web01"]
    return out


@case
def regex_no_match_returns_none(side):
    out = _rule(side, type="TAGK", field="host", regex=r"^(\d+)$").extract(
        "m", {"host": "web01"}, {})
    assert out is None
    return out


@case
def regex_group_idx(side):
    out = _rule(side, type="METRIC", regex=r"^(\w+)\.(\w+)",
                regex_group_idx=1).extract("sys.cpu.user", {}, {})
    assert out == ["cpu"]
    return out


@case
def json_round_trip(side):
    rule = _rule(side, tree_id=1, level=2, order=3, type="TAGK",
                 field="host", regex=r"(.*)", separator="",
                 description="d", notes="n")
    again = side.tree.TreeRule.from_json(rule.to_json())
    assert again.to_json() == rule.to_json()
    return again.to_json()


# -- TreeBuilder (ref: TestTreeBuilder.java) ----------------------------------

def _metric_tree(side, separator="."):
    tree = side.tree.Tree(1, "test")
    tree.set_rule(_rule(side, level=0, order=0, type="METRIC",
                        separator=separator))
    return tree


def _process(side, tree, *args):
    return side.tree.TreeBuilder(tree).process(*args)


def _state(tree) -> tuple:
    return (tree.root.to_json(), tree.collisions, tree.not_matched,
            tree.to_json())


@case
def process_files_series_under_path(side):
    tree = _metric_tree(side)
    path = _process(side, tree, "0101", "sys.cpu.user", {"host": "web01"})
    leaf = tree.root.branches["sys"].branches["cpu"].leaves["user"]
    assert path == ["sys", "cpu", "user"] and leaf.tsuid == "0101"
    return path, _state(tree), leaf.to_json(), \
        tree.root.branches["sys"].to_json()


@case
def level_order_fallback(side):
    tree = side.tree.Tree(1)
    tree.set_rule(_rule(side, level=0, order=0, type="TAGK", field="dc"))
    tree.set_rule(_rule(side, level=0, order=1, type="TAGK", field="host"))
    tree.set_rule(_rule(side, level=1, order=0, type="METRIC"))
    path = _process(side, tree, "0202", "m", {"host": "web01"})
    assert path == ["web01", "m"]
    return path, _state(tree)


@case
def multi_level_path(side):
    tree = side.tree.Tree(1)
    tree.set_rule(_rule(side, level=0, order=0, type="TAGK", field="dc"))
    tree.set_rule(_rule(side, level=1, order=0, type="METRIC",
                        separator="."))
    path = _process(side, tree, "0303", "sys.cpu",
                    {"dc": "lax", "host": "web01"})
    assert path == ["lax", "sys", "cpu"]
    return path, _state(tree)


@case
def no_match_recorded_in_not_matched(side):
    tree = side.tree.Tree(1)
    tree.set_rule(_rule(side, level=0, order=0, type="TAGK",
                        field="absent"))
    path = _process(side, tree, "0404", "m", {})
    assert path is None and "0404" in tree.not_matched
    return path, _state(tree)


@case
def store_failures_off_skips_recording(side):
    tree = side.tree.Tree(1)
    tree.store_failures = False
    tree.set_rule(_rule(side, level=0, order=0, type="TAGK",
                        field="absent"))
    _process(side, tree, "0505", "m", {})
    assert tree.not_matched == {}
    return _state(tree)


@case
def leaf_collision_recorded(side):
    tree = _metric_tree(side, separator="")
    out = [_process(side, tree, "0A", "cpu", {}),
           _process(side, tree, "0B", "cpu", {})]
    assert out == [["cpu"], None] and tree.collisions.get("0B") == "0A"
    return out, _state(tree)


@case
def same_tsuid_reprocess_is_idempotent(side):
    tree = _metric_tree(side, separator="")
    out = [_process(side, tree, "0A", "cpu", {}) for _ in range(2)]
    assert out == [["cpu"], ["cpu"]] and tree.collisions == {}
    return out, _state(tree)


# -- Tree CRUD and Branch (ref: TestTree.java, TestBranch.java) ---------------

@case
def set_get_delete_rule(side):
    tree = side.tree.Tree(1)
    tree.set_rule(_rule(side, level=0, order=0, type="METRIC"))
    out = [tree.get_rule(0, 0).to_json(), tree.delete_rule(0, 0),
           tree.get_rule(0, 0), tree.delete_rule(0, 0)]
    assert out[1:] == [True, None, False]
    return out


@case
def delete_all_rules(side):
    tree = side.tree.Tree(1)
    tree.set_rule(_rule(side, level=0, order=0, type="METRIC"))
    tree.set_rule(_rule(side, level=1, order=0, type="METRIC"))
    tree.delete_all_rules()
    assert tree.rules == {}
    return tree.to_json()


@case
def update_respects_overwrite_flag(side):
    tree = side.tree.Tree(1, "orig", "desc")
    tree.update({"name": "", "description": "new"}, overwrite=False)
    first = tree.to_json()
    tree.update({"name": ""}, overwrite=True)
    assert first["name"] == "orig" and tree.name == ""
    return first, tree.to_json()


@case
def to_json_shape(side):
    tree = side.tree.Tree(7, "n", "d")
    tree.set_rule(_rule(side, level=0, order=0, type="METRIC"))
    js = tree.to_json()
    assert js["treeId"] == 7 and js["rules"][0]["type"] == "METRIC"
    return js


@case
def branch_ids_stable_and_distinct(side):
    a = side.tree.Branch(1, ("sys",), "sys")
    b = side.tree.Branch(1, ("sys", "cpu"), "cpu")
    assert a.branch_id != b.branch_id
    assert a.branch_id == side.tree.Branch(1, ("sys",), "sys").branch_id
    return a.branch_id, b.branch_id, a.depth, b.depth


@case
def branch_json_includes_children_and_leaves(side):
    root = side.tree.Branch(1, (), "ROOT")
    child = side.tree.Branch(1, ("sys",), "sys")
    child.leaves["cpu"] = side.tree.Leaf("cpu", "0101", "sys.cpu")
    root.branches["sys"] = child
    return root.to_json(), child.to_json()


# -- the TreeManager against a TSDB (ref: TreeSync.java) ----------------------

@case
def create_get_delete(side):
    t = tsdb(side)
    mgr = side.tree.tree_manager(t)
    tree = mgr.create_tree("t1")
    assert mgr.get_tree(tree.tree_id) is tree and mgr.all_trees() == [tree]
    tree.root.branches["x"] = side.tree.Branch(tree.tree_id, ("x",), "x")
    out = [mgr.delete_tree(tree.tree_id, definition=False),
           mgr.get_tree(tree.tree_id).root.to_json(),
           mgr.delete_tree(tree.tree_id, definition=True),
           mgr.get_tree(tree.tree_id)]
    assert out[0] and out[2] and out[3] is None
    return out


@case
def sync_all_files_written_series(side):
    t = tsdb(side)
    mgr = side.tree.tree_manager(t)
    tree = mgr.create_tree("by-host")
    tree.set_rule(_rule(side, level=0, order=0, type="TAGK", field="host"))
    tree.set_rule(_rule(side, level=1, order=0, type="METRIC"))
    t.add_point("sys.cpu.user", T0, 1, {"host": "web01"})
    t.add_point("sys.cpu.user", T0, 2, {"host": "web02"})
    n = mgr.sync_all()
    assert n == 2 and set(tree.root.branches) == {"web01", "web02"}
    return n, _state(tree), [b.to_json()
                             for b in tree.root.branches.values()]


@case
def get_branch_by_id(side):
    t = tsdb(side)
    mgr = side.tree.tree_manager(t)
    tree = mgr.create_tree("t")
    tree.set_rule(_rule(side, level=0, order=0, type="METRIC",
                        separator="."))
    _process(side, tree, "0101", "sys.cpu", {})
    sys_branch = tree.root.branches["sys"]
    assert mgr.get_branch(sys_branch.branch_id) is sys_branch
    assert mgr.get_root_branch(tree.tree_id) is tree.root
    return sys_branch.branch_id, mgr.get_branch("ffffffffffffffff")


@case
def tsuids_endpoint(side):
    t = tsdb(side)
    mgr = side.tree.tree_manager(t)
    tree = mgr.create_tree("t")
    tree.set_rule(_rule(side, level=0, order=0, type="METRIC"))
    t.add_point("sys.cpu.user", T0, 1, {"host": "web01"})
    tsuid = tsuid_of(t, "sys.cpu.user", {"host": "web01"})
    out = mgr.test_tsuids(tree, [tsuid, "DEADBEEF0000"])
    assert out[tsuid]["branch"] == ["sys.cpu.user"]
    assert out["DEADBEEF0000"]["valid"] is False
    return out


# -- the display formatter (ref: processTimeseriesMetaFormat*) ----------------

def _formatted(side, tsuid="0101", **rule_kw):
    tree = side.tree.Tree(1, "t")
    r = _rule(side, **{"type": "TAGK", "field": "host", "level": 0,
                       "order": 0, **rule_kw})
    tree.rules.setdefault(r.level, {})[r.order] = r
    return _process(side, tree, tsuid, "sys.cpu.user",
                    {"host": "web01.lga.mysite.com"}, {"owner": "ops"})


@case
def format_value(side):
    out = _formatted(side, display_format="name: {value}")
    assert out == ["name: web01.lga.mysite.com"]
    return out


@case
def format_ovalue_vs_value_with_split(side):
    out = _formatted(side, separator=".", display_format="{value}@{ovalue}")
    assert out[:2] == ["web01@web01.lga.mysite.com",
                       "lga@web01.lga.mysite.com"]
    return out


@case
def format_tsuid(side):
    out = _formatted(side, tsuid="0A0B", display_format="{tsuid}")
    assert out == ["0A0B"]
    return out


@case
def format_tag_name_tagk(side):
    out = _formatted(side, display_format="{tag_name}={value}")
    assert out == ["host=web01.lga.mysite.com"]
    return out


def _one_rule(side, rule, tags, custom):
    tree = side.tree.Tree(1, "t")
    tree.rules.setdefault(rule.level, {})[rule.order] = rule
    return _process(side, tree, "01", "m", tags, custom)


@case
def format_tag_name_custom(side):
    out = _one_rule(side, _rule(side, type="TAGK_CUSTOM",
                                custom_field="owner", level=0, order=0,
                                display_format="{tag_name}:{value}"),
                    {"host": "h"}, {"owner": "ops"})
    assert out == ["owner:ops"]
    return out


@case
def format_tag_name_wrong_type_blanked(side):
    out = _one_rule(side, _rule(side, type="METRIC", level=0, order=0,
                                display_format="pre{tag_name}post"), {}, {})
    assert out == ["prepost"]
    return out


@case
def format_multi_tokens(side):
    out = _formatted(side, tsuid="FF",
                     display_format="{tag_name} | {value} | {tsuid}")
    assert out == ["host | web01.lga.mysite.com | FF"]
    return out


@case
def empty_format_uses_extracted(side):
    out = _formatted(side, display_format="")
    assert out == ["web01.lga.mysite.com"]
    return out


@case
def format_with_regex_extraction(side):
    out = _formatted(side, regex=r"^(\w+)\.", display_format="dc:{value}")
    assert out == ["dc:web01"]
    return out


@case
def format_survives_json_round_trip(side):
    r = _rule(side, type="TAGK", field="host", display_format="x{value}")
    out = side.tree.TreeRule.from_json(r.to_json()).display_format
    assert out == "x{value}"
    return out


# -- strict and testing modes (ref: processTimeseriesMetaStrict) --------------

def _two_level(side, strict=False):
    tree = side.tree.Tree(1, "t")
    tree.strict_match = strict
    tree.rules.setdefault(0, {})[0] = _rule(side, type="TAGK", field="dc",
                                            level=0, order=0)
    tree.rules.setdefault(1, {})[0] = _rule(side, type="METRIC", level=1,
                                            order=0)
    return tree


@case
def non_strict_files_partial_match(side):
    tree = _two_level(side)
    out = _process(side, tree, "01", "sys.m", {"host": "h"}, {})
    assert out == ["sys.m"]
    return out, _state(tree)


@case
def levels_all_match(side):
    tree = _two_level(side)
    out = _process(side, tree, "01", "sys.m", {"dc": "lga", "host": "h"},
                   {})
    assert out == ["lga", "sys.m"]
    return out, _state(tree)


@case
def custom_rule_empty_value_skipped(side):
    tree = side.tree.Tree(1, "t")
    tree.rules.setdefault(0, {})[0] = _rule(
        side, type="TAGK_CUSTOM", custom_field="owner", level=0, order=0)
    tree.rules.setdefault(1, {})[0] = _rule(side, type="METRIC", level=1,
                                            order=0)
    out = _process(side, tree, "01", "m", {}, {"owner": ""})
    assert out == ["m"]
    return out


@case
def second_order_rule_tried_on_miss(side):
    tree = side.tree.Tree(1, "t")
    tree.rules.setdefault(0, {})[0] = _rule(side, type="TAGK", field="nope",
                                            level=0, order=0)
    tree.rules.setdefault(0, {})[1] = _rule(side, type="TAGK", field="host",
                                            level=0, order=1)
    out = _process(side, tree, "01", "m", {"host": "web"}, {})
    assert out == ["web"]
    return out


@case
def strict_partial_match_rejected(side):
    tree = _two_level(side, strict=True)
    out = _process(side, tree, "01", "sys.m", {"host": "h"}, {})
    assert out is None and "01" in tree.not_matched
    return out, _state(tree)


@case
def strict_full_match_filed(side):
    tree = _two_level(side, strict=True)
    out = _process(side, tree, "01", "sys.m", {"dc": "lga"}, {})
    assert out == ["lga", "sys.m"]
    return out, _state(tree)


@case
def blanked_format_is_no_match_and_falls_back(side):
    tree = side.tree.Tree(1, "t")
    tree.rules.setdefault(0, {})[0] = _rule(
        side, type="METRIC", level=0, order=0, display_format="{tag_name}")
    tree.rules.setdefault(0, {})[1] = _rule(side, type="TAGK", field="host",
                                            level=0, order=1)
    out = _process(side, tree, "01", "m", {"host": "web"}, {})
    assert out == ["web"]
    return out


def test_every_reference_case_is_here():
    assert len(CASES) == 46


@pytest.mark.parametrize("name", list(CASES))
def test_tree_case_equals_reference(name, monkeypatch):
    frozen_clock(monkeypatch)
    got, want = both(CASES[name])
    assert got == want


# -- /api/tree and realtime filing --------------------------------------------

def _tree_rpcs(side):
    t = tsdb(side)
    for h in ("web01", "web02"):
        t.add_point("sys.cpu.user", T0, 1, {"host": h, "dc": "lga"})
    tsuid = tsuid_of(t, "sys.cpu.user", {"host": "web01", "dc": "lga"})
    out = [
        call(side, t, "GET", "/api/tree"),
        call(side, t, "POST", "/api/tree", body={"description": "x"}),
        call(side, t, "POST", "/api/tree",
             body={"name": "by-dc", "description": "d",
                   "strictMatch": True}),
        call(side, t, "POST", "/api/tree/rules",
             body=[{"treeId": 1, "level": 0, "order": 0, "type": "TAGK",
                    "field": "dc"},
                   {"treeId": 1, "level": 1, "order": 0,
                    "type": "METRIC", "separator": "."}]),
        call(side, t, "POST", "/api/tree/rule",
             body={"treeId": 1, "level": 2, "order": 0, "type": "TAGK",
                   "field": "host"}),
        call(side, t, "POST", "/api/tree/rule",
             body={"treeId": 9, "type": "METRIC"}),
        call(side, t, "POST", "/api/tree/rules", body=[1]),
        call(side, t, "GET", "/api/tree/rule",
             params={"treeid": 1, "level": 1, "order": 0}),
        call(side, t, "GET", "/api/tree/rule",
             params={"treeid": 1, "level": 7, "order": 0}),
        call(side, t, "GET", "/api/tree", params={"treeid": 1}),
        call(side, t, "GET", "/api/tree", params={"treeid": 5}),
        call(side, t, "PUT", "/api/tree",
             body={"treeId": 1, "name": "by-dc", "enabled": True}),
    ]
    mgr = side.tree.tree_manager(t)
    out.append(mgr.sync_all())
    root = mgr.get_root_branch(1)
    child = next(iter(root.branches.values()))
    out += [
        call(side, t, "GET", "/api/tree/branch", params={"treeid": 1}),
        call(side, t, "GET", "/api/tree/branch",
             params={"branch": child.branch_id}),
        call(side, t, "GET", "/api/tree/branch", params={"branch": "00"}),
        call(side, t, "GET", "/api/tree/branch"),
        call(side, t, "GET", "/api/tree/test",
             params={"treeid": 1, "tsuids": tsuid}),
        call(side, t, "POST", "/api/tree/test",
             params={"treeid": 1}, body={"tsuids": [tsuid, "00000F"]}),
        call(side, t, "GET", "/api/tree/collisions", params={"treeid": 1}),
        call(side, t, "GET", "/api/tree/notmatched", params={"treeid": 1}),
        call(side, t, "GET", "/api/tree/nope"),
        call(side, t, "DELETE", "/api/tree/rule",
             params={"treeid": 1, "level": 2, "order": 0}),
        call(side, t, "DELETE", "/api/tree/rule",
             params={"treeid": 1, "level": 2, "order": 0}),
        call(side, t, "DELETE", "/api/tree", params={"treeid": 1}),
        call(side, t, "GET", "/api/tree/branch", params={"treeid": 1}),
        call(side, t, "DELETE", "/api/tree/rules", params={"treeid": 1}),
        call(side, t, "DELETE", "/api/tree",
             params={"treeid": 1, "definition": "true"}),
        call(side, t, "DELETE", "/api/tree", params={"treeid": 1}),
        call(side, t, "PATCH", "/api/tree"),
    ]
    return out


def test_tree_endpoints_equal_reference(monkeypatch):
    frozen_clock(monkeypatch)
    got, want = both(_tree_rpcs)
    assert got == want
    assert [a[0] for a in got if isinstance(a, tuple)][:5] == \
        [200, 400, 200, 200, 200]


def _realtime(side):
    """Realtime filing from the meta hook, on every write path both
    packages share."""
    t = tsdb(side, **{"tsd.core.meta.enable_realtime_ts": "true",
                      "tsd.core.tree.enable_processing": "true"})
    mgr = side.tree.tree_manager(t)
    tree = mgr.create_tree("rt")
    tree.set_rule(_rule(side, level=0, order=0, type="TAGK", field="dc"))
    tree.set_rule(_rule(side, level=1, order=0, type="TAGK", field="host"))
    t.add_point("m", T0, 1, {"dc": "a", "host": "h1"})
    t.add_points("m", [T0, T0 + 1], [1.0, 2.0], {"dc": "a", "host": "h2"})
    t.add_point_groups([("m", {"dc": "b", "host": "h3"}, [0], [T0], [3])])
    t.import_buffer(b"m %d 4 dc=b host=h4\nm %d 5 dc=c host=h1\n"
                    % (T0, T0))
    t.add_point("m", T0 + 5, 1, {"dc": "a", "host": "h1"})    # not new
    return _state(tree), t.hook_errors


def test_realtime_processing_equals_reference(monkeypatch):
    frozen_clock(monkeypatch)
    got, want = both(_realtime)
    assert got == want
    assert set(got[0][0]["branches"][0]) >= {"displayName"}
    assert len(got[0][0]["branches"]) == 3


def test_tree_fault_never_fails_a_write(monkeypatch):
    """The ``tree.store`` fault site: filing fails, the write lands and
    the hook's error is counted, in both packages."""
    frozen_clock(monkeypatch)

    def scenario(side):
        t = tsdb(side, **{"tsd.core.meta.enable_realtime_ts": "true",
                          "tsd.core.tree.enable_processing": "true"})
        side.tree.tree_manager(t).create_tree("rt").set_rule(
            _rule(side, type="METRIC"))
        t.faults.arm("tree.store", error_rate=1.0)
        t.add_point("m", T0, 1, {"host": "a"})
        return t.hook_errors, len(t.meta.ts_meta), t.datapoints_added

    got, want = both(scenario)
    assert got == want == ({"tree.rt": 1}, 1, 1)
