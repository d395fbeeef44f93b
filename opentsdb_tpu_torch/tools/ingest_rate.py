"""Time the bulk ingest of ``chip_smoke.py``'s phase 9 (a):
``TSDB.add_series_points`` of config 3's series (``host``, ``dc``,
``rack`` tags, 60 points a minute apart, seed 0) into a fresh TSDB with
no write hook on, on the card.

    python opentsdb_tpu_torch/tools/ingest_rate.py [--root DIR]
        [--series N] [--repeats R] [--backend native|memory]
        [--after-hooks] [--after-drop N]

``--root`` imports the package from another checkout, so two commits
can be timed on one host. ``--after-hooks`` first builds a TSDB with
phase 17 (c)'s hooks on (TSMeta and UIDMeta tracking, a two-level tree)
over 100k series and drops it without a collection, so the first ingest
runs beside whatever the drop left to the garbage collector;
``--after-drop N`` does the same with a TSDB of N such series and no
hook (as phase 3's TSDB is dropped before phase 9). Each
repeat is a new TSDB, shut down, dropped and collected after it. Prints
one JSON line: the seconds and points/s of each repeat, and the objects
the collector tracked before the first."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

T0 = 1356998400
POINTS = 60


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).parents[2]),
                    help="import opentsdb_tpu_torch from this checkout "
                    "(default: this one)")
    ap.add_argument("--series", type=int, default=250_000,
                    help="series (default: phase 9's 1M / 4)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--backend", default="native")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--after-hooks", action="store_true")
    ap.add_argument("--after-drop", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    keys = {"tsd.torch.device": args.device,
            "tsd.core.auto_create_metrics": "true",
            "tsd.storage.backend": args.backend}
    if args.after_hooks:
        from opentsdb_tpu_torch.tree.tree import TreeRule, tree_manager
        hooked = TSDB(Config(**{
            **keys, "tsd.core.meta.enable_realtime_ts": "true",
            "tsd.core.meta.enable_realtime_uid": "true",
            "tsd.core.tree.enable_processing": "true"}))
        tree = tree_manager(hooked).create_tree("by dc and host")
        tree.set_rule(TreeRule(level=0, type="TAGK", field="dc"))
        tree.set_rule(TreeRule(level=1, type="TAGK", field="host"))
        n = 100_000
        hooked.add_series_points(
            "ops.hooked", [{"host": f"h{i}", "dc": f"dc{i % 100}",
                            "rack": f"r{i % 2000}"} for i in range(n)],
            np.full((n, 1), T0), np.ones((n, 1)))
        hooked.shutdown()
        del hooked, tree

    def data(n: int):
        rng = np.random.default_rng(0)
        return ([{"host": f"h{i}", "dc": f"dc{i % 100}",
                  "rack": f"r{i % 2000}"} for i in range(n)],
                np.broadcast_to(T0 + 60 * np.arange(POINTS, dtype=np.int64),
                                (n, POINTS)),
                rng.normal(100.0, 15.0, (n, POINTS)))

    if args.after_drop:
        dropped = TSDB(Config(**keys))
        dropped.add_series_points("sys.cpu.user", *data(args.after_drop))
        dropped.shutdown()
        del dropped
    tags, ts2d, values = data(args.series)
    tracked = len(gc.get_objects())
    secs = []
    for _ in range(args.repeats):
        tsdb = TSDB(Config(**keys))
        t = time.perf_counter()
        tsdb.add_series_points("sys.cpu.user", tags, ts2d, values)
        secs.append(time.perf_counter() - t)
        tsdb.shutdown()
        del tsdb
        gc.collect()
    n_points = args.series * POINTS
    print(json.dumps({"root": args.root, "backend": args.backend,
                      "after_hooks": args.after_hooks,
                      "after_drop": args.after_drop,
                      "tracked_before": tracked, "seconds": secs,
                      "points_per_s": [n_points / s for s in secs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
