#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``opentsdb_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--series N] [--profile]

1. prints the card (``nvidia-smi``), the torch/CUDA versions and the
   kernel build time (``csrc/fused_pipeline.cu`` is compiled here);
2. holds each CUDA kernel against its plain PyTorch version on the card
   over the downsample x aggregator x rate/counter sweep at odd sizes;
3. drives the main path at full width (BASELINE config 3: 1M series of
   ``sys.cpu.user`` x 60 points at one a minute, queried as
   ``sum:5m-avg:rate`` grouped by ``dc`` -> 100 groups, the span kernel,
   and by ``rack`` -> 2000 groups, the one-hot kernel) through
   ``TSDB.add_series_points`` and ``TSDB.execute_query``, checks that
   both kernels launched and that the answers match the plain version,
   and prints the time of each stage;
4. prints one JSON line describing each kernel, the card line and, last,
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line. Without a CUDA card,
or outside a checkout of the repository, it exits 2.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
METRIC = "sys.cpu.user"
T0 = 1356998400            # aligned to the hour (seconds)
POINTS = 60                # one hour at one point a minute
QUERIES = (("sum:5m-avg:rate:sys.cpu.user{dc=*}", "span_reduce"),
           ("sum:5m-avg:rate:sys.cpu.user{rack=*}", "onehot_reduce"))
# the four keys that put the reference engine on its point path (the
# port's engine serves only that path, and these are its defaults)
ENGINE_KEYS = {"tsd.query.grid_reduce": "false",
               "tsd.query.device_cache_mb": "0",
               "tsd.query.host_tail_max_cells": "-1",
               "tsd.query.host_tail_max_cells_linear": "-1"}
# device memory rate by card name (NVIDIA data sheets), bytes/s
_MEM_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
             ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
F32_PEAK = 67e12           # float32 FLOP/s outside the tensor cores
TOL_REL, TOL_ABS = 1e-5, 1e-6
REPEATS = 5                # warm repeats per timed stage


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, repeats: int) -> float:
    """Mean device time of ``fn`` over ``repeats`` launches after two
    warm-up calls, by CUDA events."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def timed(fn, repeats: int):
    """(last result, wall seconds of each of ``repeats`` calls), each
    call ending in a device synchronize."""
    import torch
    out, secs = None, []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    return out, secs


def device_share(torch, fn, label: str) -> None:
    """Trace one call of ``fn`` with torch.profiler and print the
    device-busy time (sum of device kernel and copy self times) against
    the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device-side events only: a CPU op (aten::copy_) also reports the
    # device time of what it launched, and CUPTI's "Activity Buffer
    # Request" entries are the profiler's own bookkeeping
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0
           and not e.key.startswith("Activity Buffer")]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    if busy_us <= 0:
        print(f"  profile {label}: no device time in the trace "
              "(device idle share not measured)")
        return
    print(f"  profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / wall_us:.4f}; top device ops: " + ", ".join(
              f"{e.key} {e.self_device_time_total / 1e3:.3f} ms"
              for e in top))


def compare(got, want, terms) -> float:
    """Max |got - want|; raises where it exceeds the tolerance."""
    import numpy as np
    import torch
    err = (got - want).abs()
    check(bool(torch.equal(torch.isnan(got), torch.isnan(want))),
          "NaN positions differ")
    bad = err > TOL_REL * terms + TOL_ABS
    if bool(bad.any()):
        i = int(torch.argmax((err - TOL_REL * terms).nan_to_num(-1.0)))
        cell = tuple(int(c) for c in np.unravel_index(i, got.shape))
        raise SmokeFailure(
            f"kernel disagrees with plain at {cell}: kernel "
            f"{float(got[cell])!r} plain {float(want[cell])!r} "
            f"sum|terms| {float(terms[cell])!r}; max err "
            f"{float(err.max())!r}")
    return float(err.nan_to_num(0.0).max()) if err.numel() else 0.0


def kernel_vs_plain(fused, spec, values, bucket_ts, gids, k, cm, rv,
                    allow_span: bool):
    """Run the wrapper and the plain version on the same device inputs;
    check acc, result NaNs and emit. Returns (kernel name, max err)."""
    import torch
    batch = fused.prepare(values, bucket_ts, gids, spec,
                          allow_span=allow_span)
    if batch.spans is not None:
        name = "span_reduce"
        got = fused.span_reduce(batch.values, batch.gids, batch.spans,
                                batch.group_start, batch.inv_dt, spec, k,
                                cm, rv)
    else:
        name = "onehot_reduce"
        got = fused.onehot_reduce(batch.values, batch.gids, batch.inv_dt,
                                  spec, k, cm, rv)
    t = fused._transform_plain(batch.values, batch.inv_dt, spec, k, cm, rv)
    want = fused._group_stage_plain(t, batch.gids, spec.num_groups)
    terms = fused._group_stage_plain(t.abs(), batch.gids, spec.num_groups)
    torch.cuda.synchronize()
    err = compare(got, want, terms)
    res_k, emit_k = fused._finalize(got, batch.sizes, spec)
    res_p, emit_p = fused._finalize(want, batch.sizes, spec)
    check(bool(torch.equal(emit_k, emit_p)), "emit masks differ")
    check(bool(torch.equal(torch.isnan(res_k), torch.isnan(res_p))),
          "result NaN positions differ")
    return name, err


def phase_sweep(torch, fused, PipelineSpec) -> dict:
    """Kernels vs plain over ds-fn x aggregator x rate at odd sizes."""
    import numpy as np
    rng = np.random.default_rng(7)
    worst = {"span_reduce": 0.0, "onehot_reduce": 0.0}
    cases = {"span_reduce": 0, "onehot_reduce": 0}
    failures = []
    # (S, B, k, G, sorted group ids -> span layout); the one-hot cases
    # (unsorted) cover P % 4 != 0 (P = 63) at G > 1024, the group-chunk
    # loop (G = 4000), rings that wrap (200,003 rows give each warp of
    # 132 blocks of 24 about two 32-row tiles of four chunks (P = 64),
    # some eight steps through its two ring stages) and rows of 26,000
    # buckets, more than the shared accumulator holds (bucket chunks)
    sizes = ((1000, 5, 3, 7, True), (4097, 12, 5, 37, True),
             (3001, 7, 9, 61, False), (2050, 13, 4, 4000, False),
             (5003, 9, 7, 2500, False), (200_003, 16, 4, 2000, False),
             (70, 26_000, 1, 3, False))
    rates = ((False, False), (True, False), (True, True))
    for s, b, k, g, sort in sizes:
        p = b * k
        base = rng.normal(100.0, 15.0, (s, p))
        counter = np.cumsum(rng.uniform(1, 50, (s, p)), axis=1)
        counter[s // 3, p // 2:] -= counter[s // 3, p // 2] * 0.9
        on_card = {False: torch.as_tensor(base, dtype=torch.float32).cuda(),
                   True: torch.as_tensor(counter,
                                         dtype=torch.float32).cuda()}
        gids = rng.integers(0, g, s).astype(np.int32)
        if sort:
            gids.sort()
        ts = np.arange(b, dtype=np.int64) * 60_000 + T0 * 1000
        for ds in sorted(fused._DS_FNS):
            line = {}
            for agg in sorted(fused._AGG_FNS):
                for rate, ctr in rates:
                    spec = PipelineSpec(num_series=s, num_buckets=b,
                                        num_groups=g, ds_function=ds,
                                        agg_name=agg, rate=rate,
                                        rate_counter=ctr)
                    vals = on_card[ctr]
                    cm, rv = (2.0**32, 5.0) if ctr else \
                        (float(2**64 - 1), 0.0)
                    try:
                        name, err = kernel_vs_plain(fused, spec, vals, ts,
                                                    gids, k, cm, rv,
                                                    allow_span=sort)
                    except SmokeFailure as exc:
                        failures.append(f"S={s} B={b} k={k} G={g} ds={ds}"
                                        f" agg={agg} rate={rate} "
                                        f"counter={ctr}: {exc}")
                        continue
                    worst[name] = max(worst[name], err)
                    cases[name] += 1
                    line[name] = max(line.get(name, 0.0), err)
            print(f"  sweep S={s} B={b} k={k} G={g} ds={ds}: "
                  + ", ".join(f"{n} max_abs_err={e:.3g}"
                              for n, e in line.items()))
    for line in failures:
        print(f"  FAIL {line}")
    check(not failures, f"{len(failures)} sweep cases failed")
    for name in worst:
        print(f"  sweep {name}: {cases[name]} cases pass, "
              f"max_abs_err={worst[name]:.6g}")
        check(cases[name] > 0, f"sweep never reached {name}")
    return worst


def make_data(n_series: int):
    import numpy as np
    rng = np.random.default_rng(0)
    tags = [{"host": f"h{i}", "dc": f"dc{i % 100}",
             "rack": f"r{i % 2000}"} for i in range(n_series)]
    ts_row = T0 + 60 * np.arange(POINTS, dtype=np.int64)
    ts2d = np.broadcast_to(ts_row, (n_series, POINTS))
    values = rng.normal(100.0, 15.0, (n_series, POINTS))
    return tags, ts2d, values


def p50(xs) -> float:
    return statistics.median(xs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--series", type=int, default=1_000_000,
                    help="series in the main-path run (default: the "
                    "full 1M of BASELINE config 3)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one query of each kind with "
                    "torch.profiler and print the device's busy and "
                    "idle share of it")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "opentsdb_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(opentsdb_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.ops import _cuda_build, fused
    from opentsdb_tpu_torch.ops import downsample as ds_mod
    from opentsdb_tpu_torch.ops import pipeline
    from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t = time.perf_counter()
    _cuda_build.library()
    print(f"kernel build+load: {time.perf_counter() - t:.3f} s "
          f"({_cuda_build.library_path().name})")
    log = _cuda_build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                print("  ptxas:", line.strip())

    print("phase 2: kernels vs plain on the card "
          f"(|k - p| <= {TOL_REL}*sum|terms| + {TOL_ABS})")
    phase_sweep(torch, fused, PipelineSpec)

    s = args.series
    print(f"phase 3: main path, {s} series x {POINTS} points"
          + ("" if s == 1_000_000 else " (CUT from 1,000,000)"))
    tsdb = TSDB(Config(**{"tsd.torch.device": "cuda",
                          "tsd.core.auto_create_metrics": "true",
                          **ENGINE_KEYS}))
    tags, ts2d, values = make_data(s)
    t = time.perf_counter()
    tsdb.add_series_points(METRIC, tags, ts2d, values)
    ingest_s = time.perf_counter() - t
    n_points = s * POINTS
    print(f"  ingest: {ingest_s:.3f} s ({n_points / ingest_s:,.0f} "
          "points/s, add_series_points)")
    start, end = str(T0), str(T0 + POINTS * 60 - 1)

    def query(m: str):
        return TSQuery(start=start, end=end,
                       queries=[parse_uri_subquery(m)]).validate()

    # the main path: counts reset just before, read just after
    for w in (fused.span_reduce, fused.onehot_reduce):
        w.launches = 0
    e2e: dict[str, list[float]] = {}
    answers = {}
    for m, _ in QUERIES:
        e2e[m] = []
        for i in range(REPEATS + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            answers[m] = tsdb.execute_query(query(m))
            e2e[m].append(time.perf_counter() - t)
        e2e[m] = e2e[m][1:]  # first run is the warm-up
    launches = {"span_reduce": fused.span_reduce.launches,
                "onehot_reduce": fused.onehot_reduce.launches}
    if args.profile:
        for m, _ in QUERIES:
            device_share(torch, lambda: tsdb.execute_query(query(m)), m)
    print(f"  main-path launches: {launches}")
    for kname, n in launches.items():
        check(n > 0, f"{kname} was never launched on the main path")

    report = {}
    store = tsdb.store
    metric_id = tsdb.uids.metrics.get_id(METRIC)
    sids = store.series_ids_for_metric(metric_id)
    for m, kname in QUERIES:
        tq = query(m)
        sub = tq.queries[0]
        eng = tsdb.new_query()
        gb = [tsdb.uids.tag_names.get_id(f.tagk) for f in sub.filters
              if f.group_by]

        def plan():
            sel, tag_mat = eng._apply_filters(metric_id, sub, sids)
            return (sel, tag_mat) + eng._group_ids(tag_mat, gb)

        (sel, tag_mat, gids, g), plan_t = timed(plan, REPEATS)
        padded, mat_t = timed(lambda: store.materialize_padded(
            sel, tq.start_ms, tq.end_ms), REPEATS)

        def assign():
            bidx, bts = ds_mod.assign_buckets_padded(
                padded.ts2d, padded.counts, sub.ds_spec, tq.start_ms,
                tq.end_ms)
            return bidx, bts, pipeline.detect_regular_padded(
                padded.counts, bidx, len(bts))

        (bidx, bts, k), assign_t = timed(assign, REPEATS)
        b = len(bts)
        spec = PipelineSpec(num_series=len(sel), num_buckets=b,
                            num_groups=g, ds_function="avg",
                            agg_name="sum", rate=True)
        vals, up_t = timed(lambda: pipeline.upload(
            padded.values2d, torch.float32, "cuda"), REPEATS)
        batch, prep_t = timed(lambda: fused.prepare(vals, bts, gids, spec),
                              REPEATS)
        (res_t, emit_t), run_t = timed(lambda: fused.run(batch, spec, k),
                                       REPEATS)
        _, asm_t = timed(lambda: eng._build_results(
            tq, sub, metric_id, sel, tag_mat, gids, g, bts,
            res_t.cpu().numpy(), emit_t.cpu().numpy()), REPEATS)
        ok = fused.supported(spec, vals.dtype, vals.device)
        layout = "span" if batch.spans is not None else "one-hot"
        print(f"  {m}: S={len(sel)} P={padded.values2d.shape[1]} B={b} "
              f"k={k} G={g}; regular={k is not None} supported={ok} "
              f"nan={bool(torch.isnan(vals).any())} -> {layout} "
              f"layout ({kname})")
        check(k is not None and ok, "config-3 batch left the fused path")
        check(kname == ("span_reduce" if batch.spans is not None
                        else "onehot_reduce"), "unexpected layout")
        res, emit = pipeline.execute_auto(padded, bidx, bts, gids, spec,
                                          None, dtype=torch.float32,
                                          device="cuda")
        check(res.is_cuda and emit.is_cuda, "results are not on cuda")
        cm, rv = float(2**64 - 1), 0.0
        _, err = kernel_vs_plain(fused, spec, vals, bts, gids, k, cm, rv,
                                 allow_span=True)
        # the engine's answer against the plain version's
        t_plain = fused._transform_plain(batch.values, batch.inv_dt, spec,
                                         k, cm, rv)
        acc_p = fused._group_stage_plain(t_plain, batch.gids, g)
        terms = fused._group_stage_plain(t_plain.abs(), batch.gids, g)
        want, want_emit = fused._finalize(acc_p, batch.sizes, spec)
        rows = answers[m]
        check(len(rows) == g, f"expected {g} groups, got {len(rows)}")
        got_vals = np.stack([r.dps_arrays[1] for r in rows])
        check(got_vals.shape == (g, b - 1), "unexpected result shape")
        check(bool(np.isfinite(got_vals).all()), "non-finite results")
        wm = want_emit.cpu().numpy()
        check(bool(wm[:, 1:].all()) and not wm[:, 0].any(),
              "unexpected emit mask")
        diff = np.abs(got_vals - want.cpu().numpy()[:, 1:])
        check(bool((diff <= TOL_REL * terms.cpu().numpy()[:, 1:]
                    + TOL_ABS).all()),
              f"engine answer differs from plain: {diff.max()}")

        if batch.spans is not None:
            run = (lambda: fused.span_reduce(
                batch.values, batch.gids, batch.spans, batch.group_start,
                batch.inv_dt, spec, k, cm, rv))
            order = torch.as_tensor(fused._sort_order(
                np.asarray(gids, dtype=np.int32))).cuda()
            gather_ms = cuda_ms(lambda: vals.index_select(0, order), 10)
        else:
            run = (lambda: fused.onehot_reduce(
                batch.values, batch.gids, batch.inv_dt, spec, k, cm, rv))
            gather_ms = None
        ms = cuda_ms(run, 10)
        plain_ms = cuda_ms(lambda: fused._group_stage_plain(
            fused._transform_plain(batch.values, batch.inv_dt, spec, k,
                                   cm, rv), batch.gids, g), 10)
        n_s, p = batch.values.shape
        nbytes = n_s * p * 4 + n_s * 4 + b * 4 + g * b * 4
        if batch.spans is not None:
            nbytes += batch.spans.numel() * 4 + (g + 1) * 4
        rate = next(r for key, r in _MEM_RATE if key in name)
        flops = n_s * p + n_s * b * 8
        bound_ms = max(nbytes / rate, flops / F32_PEAK) * 1e3
        bound_by = "bytes" if nbytes / rate >= flops / F32_PEAK \
            else "operations"
        e2e_p50 = p50(e2e[m])
        stages = (("plan", plan_t), ("materialize", mat_t),
                  ("assign", assign_t), ("upload", up_t),
                  ("prepare (host prep + gather)", prep_t),
                  ("kernel+finalize", run_t), ("assemble", asm_t))
        print(f"  {m}: p50 ms: " + ", ".join(
            f"{n} {p50(v) * 1e3:.3f}" for n, v in stages)
            + f"; sum {sum(p50(v) for _, v in stages) * 1e3:.3f}")
        print(f"  {m}: gather "
              + (f"{gather_ms:.4f} ms" if gather_ms is not None
                 else "none (one-hot)")
              + f", kernel {ms:.4f} ms (bound {bound_ms:.4f} ms at "
              f"{rate / 1e12:.2f} TB/s), plain {plain_ms:.4f} ms "
              "(CUDA events); end-to-end query p50 "
              f"{e2e_p50 * 1e3:.3f} ms ({n_points / e2e_p50:,.0f} "
              "points/s)")
        report[kname] = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "max_abs_err": err,
                         "gather_ms": gather_ms}

    lines = {"span_reduce": ("opentsdb_tpu/ops/pallas_fused.py:270",
                             "span_reduce_kernel"),
             "onehot_reduce": ("opentsdb_tpu/ops/pallas_fused.py:241",
                               "onehot_reduce_kernel")}
    src = (ROOT / "opentsdb_tpu_torch/csrc/fused_pipeline.cu") \
        .read_text().splitlines()
    kernels = []
    for kname, (replaces, sym) in lines.items():
        line = next(i + 1 for i, text in enumerate(src)
                    if f" {sym}(" in text)
        r = report[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"opentsdb_tpu_torch/csrc/fused_pipeline.cu:{line}",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
