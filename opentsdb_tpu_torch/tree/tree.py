"""Hierarchical browse trees (ref: ``src/tree/``).

``Tree`` (Tree.java:73) + ``TreeRule`` (TreeRule.java:57) +
``TreeBuilder`` (TreeBuilder.java:30-59) + ``Branch``/``Leaf``
(Branch.java:88, Leaf.java:58): a rule pipeline that files every
timeseries (TSMeta) into a browsable hierarchy. Rules are organized in
levels; within a level, orders are tried until one produces a branch
name. METRIC rules split the metric (optionally by separator), TAGK
rules take a tag's value, *_CUSTOM rules read custom meta fields, and
regexes extract capture group 1.

A new TSMeta is filed in realtime when
``tsd.core.tree.enable_processing`` is on
(TSDB.processTSMetaThroughTrees :2033), or every series in one pass by
:meth:`TreeManager.sync_all` (TreeSync.java). Snapshots hold the tree
definitions in ``trees.json``; the branches are rebuilt by filing (the
JAX package's ``tree/tree.py``).
"""

from __future__ import annotations

import hashlib
import re
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any

from opentsdb_tpu_torch.search.lookup import sid_from_tsuid


@dataclass
class TreeRule:
    """(ref: TreeRule.java:57)"""
    tree_id: int = 0
    level: int = 0
    order: int = 0
    type: str = "METRIC"  # METRIC|METRIC_CUSTOM|TAGK|TAGK_CUSTOM|TAGV_CUSTOM
    field: str = ""
    custom_field: str = ""
    regex: str = ""
    separator: str = ""
    description: str = ""
    notes: str = ""
    regex_group_idx: int = 0
    display_format: str = ""

    VALID_TYPES = ("METRIC", "METRIC_CUSTOM", "TAGK", "TAGK_CUSTOM",
                   "TAGV_CUSTOM")

    def __post_init__(self):
        if self.type.upper() not in self.VALID_TYPES:
            raise ValueError(f"Invalid rule type: {self.type}")
        self.type = self.type.upper()
        if self.regex:
            self._compiled = re.compile(self.regex)
        else:
            self._compiled = None

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "TreeRule":
        return cls(
            tree_id=int(obj.get("treeId") or obj.get("treeid", 0)),
            level=int(obj.get("level", 0)),
            order=int(obj.get("order", 0)),
            type=(obj.get("type") or "METRIC"),
            field=obj.get("field", "") or "",
            custom_field=obj.get("customField", "") or "",
            regex=obj.get("regex", "") or "",
            separator=obj.get("separator", "") or "",
            description=obj.get("description", "") or "",
            notes=obj.get("notes", "") or "",
            regex_group_idx=int(obj.get("regexGroupIdx", 0)),
            display_format=obj.get("displayFormat", "") or "",
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "treeId": self.tree_id, "level": self.level,
            "order": self.order, "type": self.type, "field": self.field,
            "customField": self.custom_field, "regex": self.regex,
            "separator": self.separator, "description": self.description,
            "notes": self.notes, "regexGroupIdx": self.regex_group_idx,
            "displayFormat": self.display_format,
        }

    def _source_value(self, metric: str, tags: dict[str, str],
                      custom: dict[str, str]) -> str | None:
        """The raw value this rule reads, before regex/split."""
        if self.type == "METRIC":
            return metric
        if self.type == "TAGK":
            return tags.get(self.field)
        if self.type in ("METRIC_CUSTOM", "TAGK_CUSTOM",
                         "TAGV_CUSTOM"):
            return custom.get(self.custom_field)
        return None

    def extract(self, metric: str, tags: dict[str, str],
                custom: dict[str, str]) -> list[str] | None:
        """Branch name(s) this rule produces for a series, or None."""
        value = self._source_value(metric, tags, custom)
        if not value:
            return None
        if self._compiled is not None:
            m = self._compiled.search(value)
            if not m or m.lastindex is None or \
                    m.lastindex < self.regex_group_idx + 1:
                return None
            value = m.group(self.regex_group_idx + 1)
            if not value:
                return None
        if self.separator:
            parts = [p for p in value.split(self.separator) if p]
            return parts or None
        return [value]

    def format_name(self, original: str, extracted: str,
                    tsuid: str) -> str:
        """Branch display name via the rule's display formatter
        (ref: TreeBuilder.setCurrentName): ``{ovalue}`` = the value
        before regex/split, ``{value}`` = the extracted token,
        ``{tsuid}`` = the series id, ``{tag_name}`` = the rule's
        field (TAGK) or custom field (*_CUSTOM; blanked for other
        types, matching the reference's warning path)."""
        fmt = self.display_format
        if not fmt:
            return extracted
        if self.type == "TAGK":
            tag_name = self.field
        elif self.type in ("METRIC_CUSTOM", "TAGK_CUSTOM",
                           "TAGV_CUSTOM"):
            tag_name = self.custom_field
        else:
            tag_name = ""  # (ref: setCurrentName blanks + warns)
        # single pass over the FORMAT string: placeholder-looking text
        # inside substituted DATA (custom meta is arbitrary) must not
        # be re-substituted
        subs = {"{ovalue}": original, "{value}": extracted,
                "{tsuid}": tsuid, "{tag_name}": tag_name}
        return re.sub(
            r"\{(?:ovalue|value|tsuid|tag_name)\}",
            lambda m: subs[m.group(0)], fmt)

    def extract_named(self, metric: str, tags: dict[str, str],
                      custom: dict[str, str], tsuid: str
                      ) -> list[str] | None:
        """:meth:`extract` with the display formatter applied per
        token. ``{ovalue}`` is the whole pre-split value, mirroring
        the reference's processSplit -> setCurrentName flow."""
        original = self._source_value(metric, tags, custom)
        parts = self.extract(metric, tags, custom)
        if parts is None:
            return None
        named = [self.format_name(original or "", p, tsuid)
                 for p in parts]
        # a formatter can blank a name (e.g. {tag_name} on a METRIC
        # rule); empty branch names are dropped like extract() drops
        # empty split tokens, and an all-empty result is no match so
        # later-order fallback rules still get their turn
        named = [n for n in named if n]
        return named or None


@dataclass
class Leaf:
    """(ref: Leaf.java:58)"""
    display_name: str
    tsuid: str
    metric: str = ""
    tags: dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        return {"displayName": self.display_name, "tsuid": self.tsuid,
                "metric": self.metric, "tags": self.tags}


class Branch:
    """(ref: Branch.java:88)"""

    def __init__(self, tree_id: int, path: tuple[str, ...],
                 display_name: str):
        self.tree_id = tree_id
        self.path = path
        self.display_name = display_name
        # the tree index itself (Branch.java): bounded by the series
        # the rules file
        self.branches: dict[str, Branch] = {}
        self.leaves: dict[str, Leaf] = {}

    @property
    def branch_id(self) -> str:
        h = hashlib.md5("/".join(self.path).encode()).hexdigest()[:12]
        return f"{self.tree_id:04x}{h}"

    @property
    def depth(self) -> int:
        return len(self.path)

    def to_json(self, recurse_leaves: bool = True) -> dict[str, Any]:
        return {
            "treeId": self.tree_id,
            "branchId": self.branch_id,
            "path": {str(i): p for i, p in enumerate(self.path)},
            "displayName": self.display_name,
            "depth": self.depth,
            "branches": [b.to_json(False)
                         for _, b in sorted(self.branches.items())] or None,
            "leaves": ([leaf.to_json()
                        for _, leaf in sorted(self.leaves.items())]
                       if recurse_leaves else None) or None,
        }


class Tree:
    """(ref: Tree.java:73)"""

    def __init__(self, tree_id: int, name: str = "",
                 description: str = ""):
        self.tree_id = tree_id
        self.name = name
        self.description = description
        self.notes = ""
        self.strict_match = False
        self.enabled = True
        self.store_failures = True
        self.created = int(time.time())
        # level -> order -> rule
        self.rules: dict[int, dict[int, TreeRule]] = {}
        self.root = Branch(tree_id, (), name or "ROOT")
        self.collisions: dict[str, str] = {}
        self.not_matched: dict[str, str] = {}
        self._lock = threading.Lock()

    def update(self, obj: dict[str, Any], overwrite: bool) -> None:
        for attr, key in (("name", "name"), ("description", "description"),
                          ("notes", "notes")):
            if overwrite:
                # PUT replaces the definition: unspecified fields reset
                # (ref: TestTreeRpc.handleTreeQSPut expects name:"")
                setattr(self, attr, obj.get(key, ""))
            elif obj.get(key):
                setattr(self, attr, obj[key])
        if overwrite:
            # full replace: unspecified booleans reset to their
            # defaults too (ref: Tree.copyChanges(tree, true))
            self.strict_match = bool(obj.get("strictMatch", False))
            self.enabled = bool(obj.get("enabled", False))
            self.store_failures = bool(obj.get("storeFailures", False))
        else:
            if "strictMatch" in obj:
                self.strict_match = bool(obj["strictMatch"])
            if "enabled" in obj:
                self.enabled = bool(obj["enabled"])
            if "storeFailures" in obj:
                self.store_failures = bool(obj["storeFailures"])

    def set_rule(self, rule: TreeRule) -> None:
        rule.tree_id = self.tree_id
        with self._lock:
            self.rules.setdefault(rule.level, {})[rule.order] = rule

    def get_rule(self, level: int, order: int) -> TreeRule | None:
        return self.rules.get(level, {}).get(order)

    def delete_rule(self, level: int, order: int) -> bool:
        with self._lock:
            if self.get_rule(level, order) is None:
                return False
            del self.rules[level][order]
            if not self.rules[level]:
                del self.rules[level]
            return True

    def delete_all_rules(self) -> None:
        with self._lock:
            self.rules.clear()

    def to_json(self) -> dict[str, Any]:
        rules = [r.to_json() for level in sorted(self.rules)
                 for _, r in sorted(self.rules[level].items())]
        return {
            "treeId": self.tree_id, "name": self.name,
            "description": self.description, "notes": self.notes,
            "strictMatch": self.strict_match, "enabled": self.enabled,
            "storeFailures": self.store_failures,
            "created": self.created, "rules": rules,
        }


class TreeBuilder:
    """(ref: TreeBuilder.java:30-59) Files one series into a tree."""

    def __init__(self, tree: Tree):
        self.tree = tree

    def process(self, tsuid: str, metric: str, tags: dict[str, str],
                custom: dict[str, str] | None = None
                ) -> list[str] | None:
        """Returns the branch path, or None when unmatched."""
        custom = custom or {}
        path: list[str] = []
        missed_levels = False
        for level in sorted(self.tree.rules):
            parts = None
            for order in sorted(self.tree.rules[level]):
                rule = self.tree.rules[level][order]
                parts = rule.extract_named(metric, tags, custom,
                                           tsuid)
                if parts:
                    break
            if parts:
                path.extend(parts)
            else:
                missed_levels = True
        if not path:
            if self.tree.store_failures:
                self.tree.not_matched[tsuid] = "no rules matched"
            return None
        if self.tree.strict_match and missed_levels:
            # strict mode requires EVERY rule level to contribute
            # (ref: TreeBuilder strict_match — a series missing any
            # level is not filed)
            if self.tree.store_failures:
                self.tree.not_matched[tsuid] = \
                    "strict match: not all rule levels matched"
            return None
        # build branches
        node = self.tree.root
        for i, part in enumerate(path[:-1]):
            key = part
            child = node.branches.get(key)
            if child is None:
                child = Branch(self.tree.tree_id,
                               tuple(path[:i + 1]), part)
                node.branches[key] = child
            node = child
        leaf_name = path[-1]
        existing = node.leaves.get(leaf_name)
        if existing is not None and existing.tsuid != tsuid:
            if self.tree.store_failures:
                self.tree.collisions[tsuid] = existing.tsuid
            return None
        node.leaves[leaf_name] = Leaf(leaf_name, tsuid, metric,
                                      dict(tags))
        return path


class TreeManager:
    """Registry of trees owned by a TSDB (the tsdb-tree table)."""

    def __init__(self, tsdb):
        # weak, as the meta store's: the TSDB holds this manager
        self._tsdb_ref = weakref.ref(tsdb)
        self._lock = threading.Lock()
        self.trees: dict[int, Tree] = {}
        self._next_id = 0
        self.enable_realtime = tsdb.config.get_bool(
            "tsd.core.tree.enable_processing")

    @property
    def tsdb(self):
        return self._tsdb_ref()

    def create_tree(self, name: str, description: str = "") -> Tree:
        with self._lock:
            self._next_id += 1
            tree = Tree(self._next_id, name, description)
            self.trees[tree.tree_id] = tree
            return tree

    def get_tree(self, tree_id: int) -> Tree | None:
        return self.trees.get(tree_id)

    def all_trees(self) -> list[Tree]:
        return [self.trees[i] for i in sorted(self.trees)]

    def delete_tree(self, tree_id: int, definition: bool) -> bool:
        with self._lock:
            tree = self.trees.get(tree_id)
            if tree is None:
                return False
            if definition:
                del self.trees[tree_id]
            else:
                tree.root = Branch(tree_id, (), tree.name or "ROOT")
                tree.collisions.clear()
                tree.not_matched.clear()
            return True

    def get_branch(self, branch_id: str) -> Branch | None:
        for tree in self.trees.values():
            found = self._find_branch(tree.root, branch_id)
            if found is not None:
                return found
        return None

    def get_root_branch(self, tree_id: int) -> Branch | None:
        tree = self.trees.get(tree_id)
        return tree.root if tree else None

    def _find_branch(self, node: Branch, branch_id: str
                     ) -> Branch | None:
        if node.branch_id == branch_id:
            return node
        for child in node.branches.values():
            found = self._find_branch(child, branch_id)
            if found is not None:
                return found
        return None

    # -- series processing --------------------------------------------

    def process_series(self, tsuid: str, metric: str,
                       tags: dict[str, str]) -> None:
        """Realtime hook (ref: TSDB.processTSMetaThroughTrees :2033).

        Runs the ``tree.store`` fault-injection site: filing a series
        into tree branches is the tree WRITE path (realtime from
        ingest via MetaStore.on_datapoint, and batch via
        :meth:`sync_all`). On the ingest side the TSDB hook guard
        swallows an armed fault — tree failures never fail a write."""
        faults = getattr(self.tsdb, "faults", None)
        if faults is not None:
            faults.check("tree.store")
        for tree in self.trees.values():
            if tree.enabled:
                TreeBuilder(tree).process(tsuid, metric, tags)

    def sync_all(self) -> int:
        """Batch rebuild from the data store (ref: TreeSync.java)."""
        uids = self.tsdb.uids
        count = 0
        for mid in self.tsdb.store.metric_ids():
            metric = uids.metrics.get_name(mid)
            for sid in self.tsdb.store.series_ids_for_metric(mid).tolist():
                rec = self.tsdb.store.series(sid)
                tags = {uids.tag_names.get_name(k):
                        uids.tag_values.get_name(v) for k, v in rec.tags}
                tsuid = uids.tsuid(rec.metric_id, rec.tags).hex().upper()
                self.process_series(tsuid, metric, tags)
                count += 1
        return count

    def test_tsuids(self, tree: Tree, tsuids: list[str]
                    ) -> dict[str, Any]:
        """(ref: TreeRpc test endpoint)"""
        out: dict[str, Any] = {}
        uids = self.tsdb.uids
        for tsuid in tsuids:
            try:
                sid, metric = sid_from_tsuid(self.tsdb, tsuid)
                if sid is None:
                    out[tsuid] = {"valid": False,
                                  "error": "unknown timeseries"}
                    continue
                rec = self.tsdb.store.series(sid)
                tags = {uids.tag_names.get_name(k):
                        uids.tag_values.get_name(v) for k, v in rec.tags}
                # dry run on a scratch tree copy
                scratch = Tree(tree.tree_id, tree.name)
                scratch.rules = tree.rules
                path = TreeBuilder(scratch).process(tsuid.upper(), metric,
                                                    tags)
                out[tsuid] = {"valid": path is not None,
                              "branch": path or []}
            except Exception as e:  # noqa: BLE001
                out[tsuid] = {"valid": False, "error": str(e)}
        return out


def tree_manager(tsdb) -> TreeManager:
    mgr = getattr(tsdb, "_tree_manager", None)
    if mgr is None:
        mgr = TreeManager(tsdb)
        tsdb._tree_manager = mgr
    return mgr
