"""Canonical continuous-query candidates for the shape miner (ref:
``opentsdb_tpu/control/shapes.py``).

The query-shape log (``obs/trace.py``) records per-request tags, not raw
bodies — so the HTTP layer tags each *materializable* query with a
canonical CQ-candidate body at serve time (:func:`cq_candidate`), and
the miner groups log lines on that tag. The candidate is a compact
sorted-key JSON string: byte-equal candidates ARE the same standing
query, which is what makes the miner deterministic (same shape log ⇒
same materialization set) and lets the auto-registered CQ serve the
repeat pull through the registry's normal ``(metric, identity_key)``
match.

Derivation is deliberately CONSERVATIVE and cheap: it mirrors the
registry's validation rules (fixed-interval decomposable downsample,
no tsuids/explicitTags/delete/calendar) but the registry stays the
authority — a candidate it still rejects is blacklisted by the
materializer, never retried.
"""

from __future__ import annotations

import hashlib
import json

from opentsdb_tpu_torch.query.result_cache import _is_relative
from opentsdb_tpu_torch.streaming.plan import DECOMPOSABLE_DS

#: auto-registered continuous-query id prefix — the materializer owns
#: (and only ever retires) ids under this prefix
AUTO_ID_PREFIX = "auto-"


def cq_candidate(tsq) -> str | None:
    """The canonical standing-query body for one served TSQuery, or
    None when the shape cannot be maintained as a continuous query.
    Only the live-dashboard shape (relative start) qualifies: an
    absolute historical window never repeats as ingest advances, so
    materializing it buys nothing the result cache doesn't."""
    if tsq.delete or tsq.timezone or tsq.use_calendar:
        return None
    if not tsq.queries:
        return None
    if not _is_relative(tsq.start) or not _is_relative(tsq.end):
        return None
    subs = []
    for sub in tsq.queries:
        if sub.tsuids or not sub.metric or sub.explicit_tags:
            return None
        spec = sub.ds_spec
        if spec is None or spec.run_all or spec.use_calendar \
                or spec.unit in ("n", "y") or spec.interval_ms <= 0:
            return None
        if spec.function not in DECOMPOSABLE_DS:
            return None
        body = {
            "aggregator": sub.aggregator,
            "metric": sub.metric,
            "downsample": sub.downsample,
            # filter ORDER is preserved: the registry's serve match
            # keys on identity_key(), whose filter tuple is ordered —
            # a sorted candidate would register a CQ the original
            # query could never hit
            "filters": [json.dumps(f.to_json(), sort_keys=True)
                        for f in sub.filters],
        }
        if sub.rate:
            body["rate"] = True
            body["rateOptions"] = sub.rate_options.to_json()
        if sub.percentiles:
            # order preserved, same identity_key reasoning as filters
            body["percentiles"] = list(sub.percentiles)
        subs.append(body)
    doc = {"start": tsq.start, "end": tsq.end or "",
           "queries": subs}
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def candidate_body(candidate: str) -> dict:
    """Rebuild the registration body for one canonical candidate
    string (the inverse of :func:`cq_candidate`'s packing)."""
    doc = json.loads(candidate)
    queries = []
    for sub in doc["queries"]:
        q = {
            "aggregator": sub["aggregator"],
            "metric": sub["metric"],
            "downsample": sub["downsample"],
            "filters": [json.loads(f) for f in sub["filters"]],
        }
        if sub.get("rate"):
            q["rate"] = True
            q["rateOptions"] = sub.get("rateOptions") or {}
        if sub.get("percentiles"):
            q["percentiles"] = list(sub["percentiles"])
        queries.append(q)
    body = {"start": doc["start"], "queries": queries}
    if doc.get("end"):
        body["end"] = doc["end"]
    return body


def auto_id(candidate: str) -> str:
    """Deterministic registry id for one candidate: the same mined
    shape maps to the same CQ id on every node and every restart."""
    digest = hashlib.sha256(candidate.encode()).hexdigest()[:12]
    return f"{AUTO_ID_PREFIX}{digest}"


__all__ = ["AUTO_ID_PREFIX", "auto_id", "candidate_body",
           "cq_candidate"]
