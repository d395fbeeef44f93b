"""Tag-value filters (ref: ``src/query/filter/TagVFilter.java`` and
subclasses).

The filter types ported so far: ``literal_or``,
``not_literal_or``, ``wildcard`` and ``iwildcard`` (plus their
case-insensitive literal twins), with the ``type(expr)`` shorthand and
the old-style tag-map conversion (``*`` -> iwildcard group-by, ``a|b``
-> literal_or group-by, exact value -> literal_or non-grouping; ref
TagVFilter.tagsToFilters). ``regexp`` and ``not_key`` arrive with a
later slice and raise NotImplementedError.

Evaluation is vectorized: a filter resolves the set of matching tagv
UIDs once over the distinct values of the metric, then the series mask
is a numpy ``isin`` over the metric's columnar tag index.
"""

from __future__ import annotations

import fnmatch
import re
from typing import Sequence

import numpy as np

_FILTER_RE = re.compile(r"^(\w+)\((.*)\)$", re.DOTALL)
_NOT_PORTED = ("regexp", "not_key")


class TagVFilter:
    """(ref: TagVFilter.java:70)"""

    filter_name = ""

    def __init__(self, tagk: str, filter_expr: str, group_by: bool = False):
        if not tagk:
            raise ValueError("missing tag key")
        self.tagk = tagk
        self.filter_expr = filter_expr
        self.group_by = group_by
        self.post_init()

    def post_init(self) -> None:
        pass

    def match_value(self, value: str) -> bool:
        raise NotImplementedError

    def __repr__(self) -> str:
        return (f"{self.filter_name}(tagk={self.tagk}, "
                f"filter={self.filter_expr}, group_by={self.group_by})")


class TagVLiteralOrFilter(TagVFilter):
    """``literal_or(v1|v2)`` (ref: TagVLiteralOrFilter.java:35)"""
    filter_name = "literal_or"
    case_insensitive = False

    def post_init(self) -> None:
        if not self.filter_expr:
            raise ValueError("empty literal_or filter")
        values = self.filter_expr.split("|")
        self._literals = {v.lower() if self.case_insensitive else v
                          for v in values if v}

    def match_value(self, value: str) -> bool:
        v = value.lower() if self.case_insensitive else value
        return v in self._literals


class TagVILiteralOrFilter(TagVLiteralOrFilter):
    filter_name = "iliteral_or"
    case_insensitive = True


class TagVNotLiteralOrFilter(TagVLiteralOrFilter):
    filter_name = "not_literal_or"

    def match_value(self, value: str) -> bool:
        return not super().match_value(value)


class TagVNotILiteralOrFilter(TagVILiteralOrFilter):
    filter_name = "not_iliteral_or"

    def match_value(self, value: str) -> bool:
        return not super().match_value(value)


class TagVWildcardFilter(TagVFilter):
    """``wildcard(*web*)`` — ``*`` globs, case sensitive
    (ref: TagVWildcardFilter.java:34)"""
    filter_name = "wildcard"
    case_insensitive = False

    def post_init(self) -> None:
        expr = self.filter_expr
        if not expr or "*" not in expr:
            raise ValueError(
                f"wildcard filter must contain '*': {expr!r}")
        if self.case_insensitive:
            expr = expr.lower()
        self._regex = re.compile(fnmatch.translate(expr))
        self.matches_all = expr.strip("*") == ""

    def match_value(self, value: str) -> bool:
        if self.matches_all:
            return True
        v = value.lower() if self.case_insensitive else value
        return self._regex.match(v) is not None


class TagVIWildcardFilter(TagVWildcardFilter):
    filter_name = "iwildcard"
    case_insensitive = True


_FILTER_TYPES: dict[str, type[TagVFilter]] = {
    cls.filter_name: cls for cls in (
        TagVLiteralOrFilter, TagVILiteralOrFilter, TagVNotLiteralOrFilter,
        TagVNotILiteralOrFilter, TagVWildcardFilter, TagVIWildcardFilter)
}


def _filter_class(ftype: str) -> type[TagVFilter]:
    cls = _FILTER_TYPES.get(ftype)
    if cls is not None:
        return cls
    if ftype in _NOT_PORTED:
        raise NotImplementedError(
            f"filter type {ftype!r} is not ported yet")
    raise ValueError(f"Unrecognized filter type: {ftype}")


def get_filter(tagk: str, expr: str, group_by: bool = False) -> TagVFilter:
    """Parse ``type(value)`` shorthand, or bare value / ``a|b`` / ``*``
    old-style (ref: TagVFilter.getFilter :199-260 + tagsToFilters)."""
    m = _FILTER_RE.match(expr)
    if m:
        return _filter_class(m.group(1))(tagk, m.group(2), group_by)
    if "*" in expr:
        return TagVIWildcardFilter(tagk, expr, group_by)
    return TagVLiteralOrFilter(tagk, expr, group_by)


def build_filter(obj: dict) -> TagVFilter:
    """From the 2.x JSON form {type, tagk, filter, groupBy}."""
    return _filter_class(obj.get("type", ""))(
        obj.get("tagk", ""), obj.get("filter", ""),
        bool(obj.get("groupBy", False)))


def tags_to_filters(tags: dict[str, str]) -> list[TagVFilter]:
    """Old-style v1 tag map -> filters (ref: TagVFilter.tagsToFilters):
    ``*``/wildcards and ``a|b`` group by; exact values only filter."""
    out = []
    for tagk, expr in tags.items():
        group_by = "*" in expr or "|" in expr or expr.startswith(
            ("wildcard(", "iwildcard(", "literal_or(", "iliteral_or(",
             "regexp("))
        out.append(get_filter(tagk, expr, group_by=group_by))
    return out


class FilterEvaluator:
    """Vectorized filter application over a metric's columnar tag index."""

    def __init__(self, uids):
        self._uids = uids

    def matching_tagv_ids(self, filt: TagVFilter,
                          candidate_ids: np.ndarray) -> np.ndarray:
        """Run the string predicate over distinct candidate tagv ids."""
        tagv = self._uids.tag_values
        keep = [vid for vid in candidate_ids.tolist()
                if filt.match_value(tagv.get_name(int(vid)))]
        return np.asarray(keep, dtype=np.int64)

    def apply(self, filters: Sequence[TagVFilter], sids: np.ndarray,
              tag_triples: np.ndarray) -> np.ndarray:
        """Return the boolean keep-mask over ``sids``; every filter must
        pass (ref: TsdbQuery/SaltScanner filter chain semantics).
        ``tag_triples`` is the metric index's [T,3] (sid, tagk, tagv)."""
        if len(sids) == 0:
            return np.zeros(0, dtype=bool)
        keep = np.ones(len(sids), dtype=bool)
        order = np.argsort(sids, kind="stable")
        sorted_sids = sids[order]
        by_key: dict[str, list[TagVFilter]] = {}
        for f in filters:
            by_key.setdefault(f.tagk, []).append(f)
        for tagk, flist in by_key.items():
            try:
                kid = self._uids.tag_names.get_id(tagk)
            except LookupError:
                # unknown tag key: no series can match a value filter
                return np.zeros(len(sids), dtype=bool)
            rows = tag_triples[tag_triples[:, 1] == kid]
            has_key = np.zeros(len(sids), dtype=bool)
            series_tagv = np.full(len(sids), -1, dtype=np.int64)
            ins = np.searchsorted(sorted_sids, rows[:, 0])
            ins_c = np.minimum(ins, len(sids) - 1)
            valid = sorted_sids[ins_c] == rows[:, 0]
            pos = order[ins_c[valid]]
            has_key[pos] = True
            series_tagv[pos] = rows[valid, 2]
            cand = np.unique(series_tagv[has_key])
            for f in flist:
                matched = self.matching_tagv_ids(f, cand)
                keep &= has_key & np.isin(series_tagv, matched)
        return keep
