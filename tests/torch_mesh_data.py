"""The data and queries of the two-process mesh test
(``tests/test_torch_distributed.py``), in a module of their own that
imports only numpy: its child processes run the port alone."""

import numpy as np

BASE = 1356998400

QUERIES = [
    # 40 series x 60 buckets: over the blocked facade's 64-cell budget
    # (x8 devices), so the child's last answer streams blocks
    {"start": BASE * 1000, "end": (BASE + 3600) * 1000,
     "queries": [{"metric": "sys.mh", "aggregator": "sum",
                  "downsample": "1m-avg", "rate": True,
                  "filters": [{"type": "wildcard", "tagk": "host",
                               "filter": "*", "groupBy": True}]}]},
    {"start": BASE * 1000, "end": (BASE + 3600) * 1000,
     "queries": [{"metric": "sys.mh", "aggregator": "p95",
                  "downsample": "10m-avg"}]},
    {"start": BASE * 1000, "end": (BASE + 3600) * 1000,
     "queries": [{"metric": "sys.mh", "aggregator": "avg",
                  "downsample": "5m-max",
                  "filters": [{"type": "wildcard", "tagk": "host",
                               "filter": "*", "groupBy": True}]}]},
]


def seed(t):
    """The same data in every process (the analogue of many TSDs
    reading one storage cluster); ``t`` is either package's TSDB."""
    rng = np.random.default_rng(11)
    ts = BASE + np.arange(60, dtype=np.int64) * 60
    for i in range(40):
        t.add_points("sys.mh", ts, rng.normal(100.0, 15.0, 60),
                     {"host": f"h{i % 8}", "core": f"c{i}"})


def answer(results) -> list:
    """An answer as plain JSON: rows sorted by tags."""
    return [{"tags": r.tags, "dps": [[int(a), float(v)] for a, v in r.dps]}
            for r in sorted(results, key=lambda r: sorted(r.tags.items()))]
