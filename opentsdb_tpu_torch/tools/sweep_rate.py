"""Time one lifecycle sweep at the shape of ``chip_smoke.py``'s phase
18: ``sys.cpu.user`` over N series (``host``, ``dc``, ``rack`` tags) x
2 h at one point a second (normal(100, 15), seed 18) on the native
store in a data_dir, demoted into the 1m and 1h tiers up to the second
hour's start and spilled up to the first's, with the sketch tier off,
on, or each in turn.

    python opentsdb_tpu_torch/tools/sweep_rate.py [--series N]
        [--sketch off,on] [--device cuda|cpu] [--backend native|memory]

Each mode is a new TSDB in a new data_dir, removed after it. Prints one
JSON line: per mode the sweep's seconds, the seconds of its sketch fold
(``LifecycleManager._fold_sketches``, 0 with the tier off) and its
spill (``_gather_tier_history`` and the segment writes,
``LifecycleManager._spill``), and the sweep's report."""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

T0 = 1356998400            # an hour's start
START_S = T0 + 120         # the data: [T0 + 2 m, T0 + 2 h 2 m)
SPAN_S = 7200
CHUNK = 2_000              # series per ingest call
# now half an hour past the demotion boundary (T0 + 2 h); demote_after
# 30m and spill_after 1h floor to the 1h tier: spill boundary T0 + 1 h
NOW_MS = (T0 + 7200 + 1800) * 1000


def timed(obj, name: str, acc: list) -> None:
    """Wrap ``obj.name`` so each call adds its seconds to ``acc[0]``."""
    inner = getattr(obj, name)

    def wrapper(*a, **k):
        t = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            acc[0] += time.perf_counter() - t
    setattr(obj, name, wrapper)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--series", type=int, default=2_000,
                    help="series (default: phase 18's 20k / 10)")
    ap.add_argument("--sketch", default="off,on",
                    help="the sketch tier in each mode, in order")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="native")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).parents[2]))
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    n = args.series
    ts = START_S + np.arange(SPAN_S, dtype=np.int64)
    modes = []
    for mode in args.sketch.split(","):
        root = Path(tempfile.mkdtemp(prefix="tsd-sweep-rate-"))
        try:
            tsdb = TSDB(Config(**{
                "tsd.torch.device": args.device,
                "tsd.storage.backend": args.backend,
                "tsd.core.auto_create_metrics": "true",
                "tsd.storage.data_dir": str(root),
                "tsd.rollups.enable": "true",
                "tsd.lifecycle.enable": "true",
                "tsd.lifecycle.demote_tiers": "1m,1h",
                "tsd.lifecycle.demote_after": "30m",
                "tsd.lifecycle.spill_after": "1h",
                "tsd.lifecycle.flush_after_sweep": "false",
                "tsd.sketch.enable": "true" if mode == "on" else "false"}))
            rng = np.random.default_rng(18)
            t = time.perf_counter()
            for lo in range(0, n, CHUNK):
                hi = min(lo + CHUNK, n)
                tsdb.add_series_points(
                    "sys.cpu.user",
                    [{"host": f"h{i}", "dc": f"dc{i % 100}",
                      "rack": f"r{i % 2000}"} for i in range(lo, hi)],
                    np.broadcast_to(ts, (hi - lo, SPAN_S)),
                    rng.normal(100.0, 15.0, (hi - lo, SPAN_S)))
            ingest_s = time.perf_counter() - t
            lc = tsdb.lifecycle
            fold, spill = [0.0], [0.0]
            timed(lc, "_fold_sketches", fold)
            timed(lc, "_spill", spill)
            t = time.perf_counter()
            rep = lc.sweep(now_ms=NOW_MS)
            sweep_s = time.perf_counter() - t
            modes.append({"sketch": mode, "ingest_s": ingest_s,
                          "sweep_s": sweep_s, "fold_s": fold[0],
                          "spill_s": spill[0], "report": rep})
            tsdb.shutdown()
            del tsdb, lc
        finally:
            shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"series": n, "points": n * SPAN_S,
                      "device": args.device, "backend": args.backend,
                      "modes": modes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
