"""Shape miner: scores standing-query candidates out of the shape log
(ref: ``opentsdb_tpu/control/miner.py``).

One scan reads ``query_shapes.jsonl`` (rotated generation first, same
walk as ``/api/stats/query_shapes``), groups lines by their canonical
``cq`` candidate tag (:mod:`opentsdb_tpu_torch.control.shapes`), and scores
each group ``count x miss-cost`` — the workload-observed benefit of
materializing that shape as a standing shared partial: how often it
is pulled, times what a pull costs when neither the streaming
registry nor the result cache already answers it.

The miner is a PURE function of the log bytes: same log ⇒ same scores
⇒ same materialization set (the determinism oracle the control test
battery checks). Torn lines, non-JSON lines and lines without a
candidate tag are skipped exactly like the stats endpoint skips them.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


@dataclass
class ShapeScore:
    """One mined candidate's aggregate."""

    candidate: str
    count: int = 0
    miss_count: int = 0
    durations: list = field(default_factory=list)   # miss durations
    all_durations: list = field(default_factory=list)

    @property
    def miss_cost_ms(self) -> float:
        """p50 of cache-miss durations; a shape the cache always
        answers falls back to the overall p50 (its miss cost is
        unobserved, not zero — scoring it zero would starve shapes
        that are hot precisely because the cache carries them)."""
        vals = self.durations or self.all_durations
        return _p50(vals)

    @property
    def score(self) -> float:
        return round(self.count * self.miss_cost_ms, 3)


def _p50(vals: list) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    return float(s[len(s) // 2])


def mine_shapes(shape_path: str) -> list[ShapeScore]:
    """Scan the shape log into candidate scores, highest score first;
    ties break on the candidate string so the ordering (and therefore
    the materialization set) is fully deterministic."""
    shapes: dict[str, ShapeScore] = {}
    if not shape_path:
        return []
    for p in (shape_path + ".1", shape_path):
        if not os.path.isfile(p):
            continue
        try:
            with open(p, "r", encoding="utf-8") as fh:
                for line in fh:
                    try:
                        doc = json.loads(line)
                    except ValueError:
                        continue  # torn tail of a rotation
                    if not isinstance(doc, dict):
                        continue
                    cand = doc.get("cq")
                    if not cand or not isinstance(cand, str):
                        continue
                    s = shapes.get(cand)
                    if s is None:
                        s = shapes[cand] = ShapeScore(cand)
                    s.count += 1
                    dur = float(doc.get("durationMs", 0.0))
                    s.all_durations.append(dur)
                    if doc.get("cache") == "miss":
                        s.miss_count += 1
                        s.durations.append(dur)
        except OSError:
            continue
    return sorted(shapes.values(),
                  key=lambda s: (-s.score, s.candidate))


__all__ = ["ShapeScore", "mine_shapes"]
