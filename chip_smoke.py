#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``opentsdb_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--series N] [--profile]

1. prints the card (``nvidia-smi``), the host CPU, the torch/CUDA
   versions and the build times of the kernels (``csrc/fused_pipeline.cu``
   with nvcc) and of the native store (``csrc/tsdbstore.cc`` with g++),
   compiled here at the same time;
2. holds each CUDA kernel against its plain PyTorch version on the card
   over the downsample x aggregator x rate/counter sweep at odd sizes
   (the plain group sums added in float64, ``plain_reduce(exact=True)``;
   ``plain_ms`` times the float32 plain version the wrappers run on the
   CPU), and times a plain read (``sum()``) of a [1M, 60] float32
   matrix, the kernels' input, against the card's memory rate;
3. drives the main path at full width (BASELINE config 3: 1M series of
   ``sys.cpu.user`` x 60 points at one a minute, queried as
   ``sum:5m-avg:rate`` grouped by ``dc`` -> 100 groups, the span kernel
   reading the rows through the group-sort permutation, and by ``rack``
   -> 2000 groups, the one-hot kernel) through
   ``TSDB.add_series_points`` and ``TSDB.execute_query``, checks that
   both kernels launched and that the answers match the plain version,
   prints the time of each stage, and checks that 20 launches of each
   kernel on the same inputs give the first one's bits (the one-hot
   kernel also on the ``dc`` grouping, forced onto its layout);
4. runs the same two queries on the same data at the engine's default
   keys (the grid path: the store reduces each window to a [S, B] grid,
   uploaded once and kept in the device cache): cold (caches dropped
   before each call) and warm p50, the time of each stage, no kernel
   launched, the answers against the same query run through the port
   on the CPU in float64, warm against cold, the cache's hits, and the
   cached grid against a fresh reduction bit for bit;
5. runs them with ``tsd.query.grid_reduce=false`` and the cache on (the
   prepared-batch path): warm hits launch the span and one-hot kernels,
   answer as phase 3 did and equal each other bit for bit;
6. drives the serve path at the default keys (result cache on, fan-out
   on 4 threads): the tag-matrix cache (``{dc=*}`` builds it,
   ``{rack=*}`` hits it), the result cache (a miss, five hits equal to
   it bit for bit and to the same query with the cache off, then a
   write that the next call must see), and one TSQuery of both
   queries, fanned out: at the defaults (grid path) and at
   ``grid_reduce=false`` with every cache off, where the span and
   one-hot kernels launch once each from two threads; each sub answers
   as it does alone;
7. drives the irregular point paths at full width on a fresh TSDB at
   the default keys but the result cache: config 3's 1M series with
   each point jittered by 0-9 s and 2% of them dropped (seed 0),
   queried as ``sum:5m-last:rate`` by ``dc`` (the padded layout),
   ``p99:5m-median`` by ``rack`` (the flat layout, rank downsample and
   rank group stage), ``avg:15mc-max`` by ``dc`` in
   ``America/New_York`` (calendar buckets) and ``sum`` by ``dc`` with
   no downsample (a union grid of up to 600 timestamps, flat). Each
   answer is checked against the same query through the port on the
   CPU in float64 over a tenth of its groups (each with all of its
   series), two cold calls and the warm calls (prepared-batch hits)
   must give the same bits, and neither kernel may launch; prints
   the stage p50s, the peak device memory and, with ``--profile``, the
   device's idle share. The union grid's S x B exceeds the cell budget
   at full width: it streams in time blocks (no prepared batch, one
   warm call, each stage timed once), and its staged unblocked run
   must equal it bit for bit, both peaks printed;
8. the front end (run after phase 5, on phase 3's TSDB and keys,
   before phase 6 writes a point that makes one series irregular):
   the port's ``TSDServer`` in process on an ephemeral port, driven
   over sockets. (a) ``/api/query`` by POST and GET for both queries,
   one K1 or K2 launch per call, each answer equal to
   ``execute_query``'s through the port's serializer bit for bit and
   to phase 3's float64 reference; HTTP p50 beside the direct p50 and
   the serializer's time. (b) The same at the default keys: a miss,
   then result-cache hits. (d) 8 concurrent clients of (a). (e) An
   unported endpoint answers 501, a bad aggregator 400. (c) 1M points
   by ``/api/put`` in 1000-point bodies over 4 kept-alive connections
   and 200k telnet ``put`` lines, points/s of each, and an exact
   read-back of both by ``/api/query``. The server must stop cleanly;
9. the storage backends A/B: a quarter of config 3's series (250k,
   seed 0; ``STORE_CUT``, for the run's time limit) into two fresh
   TSDBs, ``tsd.storage.backend=native`` then ``memory``,
   each: (a) ``add_series_points`` ingest and the first read after it;
   (b) the p50 of 3 calls of ``count_range``, ``materialize``,
   ``materialize_padded`` and a 5m ``bucket_reduce`` over all 1M
   series; (c) both queries on phase 3's keys (the point path, K1 and
   K2 launching) and, caches dropped, at the default keys (the grid
   path), each with the engine's stage table (plan, scan, compute,
   rest) and checked against a float64 numpy reference of the same
   data (:func:`config3_reference`); (d) series 0
   rewritten at a timestamp before its last point, then the cold
   ``{dc=*}`` point-path query; (e) 200k import lines by
   ``TSDB.import_buffer`` (native only) and by the telnet burst path,
   read back. The backends' materialized points must be equal bit for
   bit, their ``bucket_reduce`` sums within 1e-12 relative, and their
   point-path answers (also after the rewrite) equal bit for bit;
10. durability (``tsd.storage.data_dir``, the WAL at ``fsync=always``,
   on the native store, the point path with the result cache off), on
   phase 9's quarter of config 3's series, in a fresh directory under
   ``$TMPDIR`` (its filesystem and free bytes printed; fewer than 8 GiB
   free fails): (a) the series by
   ``add_series_points`` with the WAL (seconds, WAL bytes, records and
   fsyncs, against phase 9's native ingest); (b) 1M points by
   ``/api/put`` in 1000-point bodies with the WAL (points/s against
   phase 8's, fsyncs per body); (c) a child process writes the series
   with the WAL, acknowledges and is SIGKILLed; a TSDB on its
   directory recovers (snapshot load and WAL replay timed apart),
   must read back every point, and answers ``{dc=*}`` and ``{rack=*}``
   with one K1 or K2 launch each, bit for bit as (a)'s TSDB that never
   died; (d) ``flush()`` (seconds, snapshot bytes, segments truncated),
   a restart from the snapshot alone with the same answers, then one
   out-of-order point on series 0 by a killed child process, read back
   after the restart and in the rewritten answer, equal to (a)'s TSDB
   after the same write;
11. blocked long ranges: a fresh TSDB on the native store at the
   default keys but the result cache, holding config 3's 1M series
   over two hours (120 points a minute apart, 2% dropped, seed 0, no
   jitter), queried as ``sum:1m-avg:rate`` by ``dc`` (the rate carry
   crosses the block edge) and ``avg:1m-avg`` by ``rack`` (LERP's prev
   and next carries, 2000 groups). S x B exceeds the cell budget, so
   the grid path declines and the point path streams 2 blocks: the
   blocked counters must move and neither kernel launch, a cold call
   and the staged run (a second blocked run) must give the same bits
   (a second cold call was CUT for the run's time), the answer must
   equal the unblocked point path's
   (``tsd.query.max_device_cells=268435456``,
   ``grid_reduce=false``) bit for bit and the port on the CPU in
   float64 at phase 7's tolerance over a tenth of its groups (each with
   all of its series; CUT from all groups for the run's time); prints
   both device peaks (the
   blocked one must be the lower), the stage times (plan, materialize,
   assign, flatten, the host split into blocks, pass 1, pass 2,
   assemble) and, with ``--profile``, the device's idle share;
12. histograms, BASELINE config 4 (``bench_e2e.py:253-282``), on a
   fresh TSDB at the default keys but the result cache: (a) 250k series
   (``HIST_CUT``: CUT from config 4's 1M for the run's time)
   of ``sys.lat.hist`` (``host=h<i>``, ``dc=dc<i%100>``) x 1 point (the
   depth cut from 2 points a minute apart), 64 buckets on
   ``np.logspace(0, 4, 65)``, counts
   ``integers(0, 50)`` from seed 3, by ``add_histogram_batch`` in batches
   of 25,000 (ingest seconds and points/s); (b) Q1 ``sum`` with
   ``percentiles [99, 99.9]`` (one group, one timestamp; at 1M series
   every merged bucket passed 2^24) and Q2 the same by ``dc`` at
   ``5m-sum`` (100
   groups): two cold calls and the warm p50 of 5 (device-cache hits),
   the answers equal to a float64 numpy reference of the same counts
   bit for bit, the same bits on every call, neither kernel launched,
   the counts float64 on the card, the stages of one cold call (plan,
   arena slice, window rows, upload, segments, merge, percentiles,
   emit) and, with ``--profile``, the device's idle share; (c) ``merge_histograms`` and
   ``percentiles_from_merged`` timed by CUDA events beside a plain read
   of the [250k, 64] float64 counts, printed on the ``histogram`` line;
   (d) ``sum:5m-avg`` percentiles [50, 99] over 10k scalar series x 60
   ``lognormal(3, 0.8)`` points (seed 0) by the sketch fold, each within
   alpha of the exact order statistic, two calls the same bits; (e) 10k
   of (a)'s points by ``/api/histogram`` and one telnet ``histogram``
   line to the TSD server with the WAL on, Q1 by HTTP equal to
   ``execute_query`` and the reference, the same bits after a restart
   from the WAL alone and from the snapshot;
13. rollups, BASELINE config 5 (``bench_e2e.py:287-337``), on a fresh
   TSDB on the native store with ``tsd.rollups.enable`` (tiers 1m and
   1h) at the default keys but the result cache: (a) 50k series (CUT
   from config 5's 100k) of ``sys.cpu.user`` (config 3's tags) x 3600
   points a second apart,
   ``normal(100, 15)`` from seed 5, by ``add_series_points`` and
   ``append_grid``; ``run_rollup_job`` over the hour by the storage
   route (the default) and then, on fresh tiers, with
   ``tsd.rollups.job.device=true`` (seconds, raw points/s, points
   written per tier, the device calls; with ``--profile`` the device
   route's idle share); the two routes' tiers equal (1h sums within
   1e-12) and a 1-in-100 sample equal to numpy float64; (b) on the
   storage route's tiers, ``sum:5m-avg:rate{dc=*}`` (the avg path),
   ``sum:5m-sum:rate`` by ``dc`` and ``rack`` with ``grid_reduce=false``
   and ``device_cache_mb=0`` (K1 and K2 on the 1m sum tier, each also
   held to its plain version), ``max:1h-max{rack=*}`` and
   ``sum:5m-count{dc=*}``: two cold calls and the warm p50 of 5, the
   same bits on every call, the stages of one cold call, the tier
   points read, each answer held to the same query with
   ``ROLLUP_RAW``, to the port on the CPU in float64 and to numpy
   float64 (maxes and counts exactly the raw answer); the job's tile,
   the coarsen and the avg divide timed by CUDA events beside a bound
   and a plain read, printed on the ``rollup`` line; (c) tier and
   pre-aggregate points by ``/api/rollup`` and one telnet ``rollup``
   line to the TSD server with the WAL on (points/s), read back
   exactly, and the same after a restart from the WAL alone and from
   the snapshot;
14. continuous queries and the server warmup, the live dashboard of
   ``bench_e2e.py:335-431`` (``bench_live``) at config 5's width: a
   fresh TSDB on the native store at the default keys but the result
   cache, 100k series of ``sys.cpu.user`` (config 3's tags) x 600
   points a second apart (CUT from ``bench_live``'s 1800),
   ``normal(100, 10)`` from seed 11, by
   ``append_grid``, the 1,000 hosts of ``dc2`` silent for 3 minutes
   halfway. Standing queries over the 10 minutes: (a) ``sum:1m-avg``
   by ``dc`` and ``avg:1m-max`` by ``rack`` (both filter on both
   keys, so they share one partial), (b) 16 copies of (a)'s first,
   (c) ``sum:1m-sum`` sliding 5m and hopping 5m/2m, (d) sessions at a
   2m gap over ``dc2``, (e) p99 and p99.9 over ``dc1``. 2 rounds (CUT
   from 5) of live traffic (500 ``add_point``, 10,000 points by
   ``/api/put`` and 1,000 telnet lines each); after every round (a)
   and (b) pulled by ``execute_query`` and HTTP are served from the
   windows
   (``serve_hits``, ``streamingHit``) and equal the batch engine on
   the grid path and, over the first 5 minutes, on the point path
   (K1 by ``dc``, K2 by ``rack``, launches counted); (c) and (d)'s
   ``/result`` equal a numpy float64 fold of the raw points; (e)
   equals the batch sketch path bit for bit; an SSE subscriber over a
   socket gets its snapshot and a ``windows`` event per round (push
   latency). Then ``stream.fold`` armed once (a shed, a rebuild),
   persistently (the breaker opens, pulls shed equal to batch,
   ``/result`` 503 with Retry-After, no 500) and disarmed (the probe
   closes it); the tail's device time, the refresh p50 against the
   full recompute, ``add_point`` p50 with 0, 10 and 50 standing
   queries, fold seconds for 1 query and 16 sharing a partial, and
   the ring's bytes; last, 10k series snapshotted into a data_dir and
   ``tools/cli.py tsd`` started on it twice, with ``tsd.tpu.warmup``
   on (its class count and seconds) and off, the first ``/api/query``
   timed after each. Prints the ``streaming`` line;
15. dashboard surfaces (run after phase 6, on phase 3's TSDB before it
   goes, and on one small TSDB built by ``append_grid`` at the default
   keys but the result cache): (a) the host tail's default budgets: a
   ``sum`` and a ``p99`` query (``1m-avg`` over an hour at one point a
   minute, B = 60) at the S just under and just over each budget (the
   linear 2^23 cells: 131,072 / 131,073 series; the rank 2^20 cells:
   16,384 / 16,385; the rank 2^25 cells x groups: 31 / 32 groups over
   16k series), each at its default placement and pinned the other
   way, p50 of 5 and the tail's time (``computeTime``), the grid's
   device checked, every answer held to a float64 numpy reference and
   the two placements to each other; (b) the device breaker on the
   card (threshold 2, a 1 s window): two injected ``device.compile``
   failures answered 500 and counted, then 503 with Retry-After and no
   dispatch, and after the window the probe closes it; (c)
   ``/api/query/exp`` ``a / b * 100`` (``sum:5m-avg:rate`` over
   ``sum:5m-max:rate`` by ``dc``) and ``/gexp`` ``scale(...,100)`` over
   config 3 on the point path, K1 launching for each sub-query, held to
   numpy over float64 sub-results; (d) an M4 pixel budget (300) over
   64 raw series of an hour at 1 s, each row's kept set equal to
   ``naive_m4_reference``; (e) a tsuid sub-query of 100 config-3
   series (a kernel launch, held to numpy) and a ``delete=true`` over
   10 minutes of one series by ``POST /api/query``, read back. Prints
   ``phase 15: N s``;
16. the query mesh on one card (run after phase 15, on phase 3's store
   before its TSDB goes): facades over that store with
   ``tsd.query.mesh`` at ``series:4`` and at ``series:2,time:2``, each
   drawn from ``mesh_devices=[cuda:0] * 4`` (4 virtual shards on the
   one card: the sharded code's answers, no multi-card scaling), at the
   default keys but the result cache, over the first 11 buckets of 5 m
   (clear of phase 6's write). ``sum:5m-avg:rate`` by ``dc`` and by
   ``rack`` go through (a) the sharded point path
   (``grid_reduce=false``): two cold calls and a prepared-batch hit,
   (b) the sharded grid path: two cold calls and a grid-cache hit, all
   bit-equal (one cold call by ``rack`` in (a) and (b)), and (c) the
   sharded blocked path (``tsd.query.max_device_cells=1000000``, the
   budget scaled by the 4 shards: 3 blocks; by ``dc`` on the first
   shape, by ``rack`` on the second); each answer held to a float64
   numpy reference at phase 3's tolerance, its emit mask equal to the
   single-card path's (phase 3's TSDB on the same window), its stage
   times printed. (d) A ``p99`` by ``dc`` (the histogram estimator)
   within 2 x range / 512 of the exact order statistic, and (e) a
   ``multiply`` over a TSDB of config 3's first 8 series (the
   all-gather path) within 1e-5 relative. (f) Two child processes on
   the card, each with a timeout of its own, joined on gloo at an
   ephemeral ``tsd.mesh.coordinator`` with ``series:2,time:2`` over
   ``[cuda:0] * 2`` each (the time axis across the processes), each
   holding phase 9's quarter of the series, started first and run
   beside (a)-(e) (their times share the host's CPUs): both give the
   same bits, held to numpy and to the single-card path's values and
   emit masks.
   Neither kernel runs inside a shard, as in the reference. Prints
   ``phase 16: N s``;
17. prints the run's wall time, the ``histogram``, ``rollup``,
   ``streaming``, ``surfaces`` and ``mesh`` lines, one JSON line
   describing each kernel (its launches are those of phases 3, 5, 8,
   6, 15, 9, 10, 13 and 14; phases 11, 12 and 16 launch neither on
   their paths), the card line and, last,
   ``{"ok": true, "device": {...}}``. Each phase's header says how far
   into the run it starts.

Phases 3-8, 11, 13, 14, 15 and 16 run on the default store, the native
one. Phases 3-5, 7, 9, 11, 12, 13, 14, 15 and 16 run with the result
cache off, so that every call reaches the path it measures. Every phase
before 15 pins the host tail off (``HOST_TAIL_OFF``), so that each
kernel launch and device tail it times stays on the card, and prints
where ``host_tail_for_dims`` would place its queries at the default
budgets. The phases that start a TSD server in process pin
``tsd.tpu.warmup=false``, so that no warmup runs on the card while they
time it.

Any failure exits non-zero without the last line. Without a CUDA card,
or outside a checkout of the repository, it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import shutil
import subprocess
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
METRIC = "sys.cpu.user"
T0 = 1356998400            # aligned to the hour (seconds)
POINTS = 60                # one hour at one point a minute
QUERIES = (("sum:5m-avg:rate:sys.cpu.user{dc=*}", "span_reduce"),
           ("sum:5m-avg:rate:sys.cpu.user{rack=*}", "onehot_reduce"))
# the host tail off: at the default budgets (tsd.query.host_tail_max_*
# = 0) a query whose padded [S, B] is small runs its tail on the host
# CPU, and phases 9, 10, 13 and 14 and the warmup would leave the card.
# Every phase before phase 15 pins the host tail off on its TSDB, so
# that each kernel launch and device tail it times stays on the card,
# and prints where the defaults would place its queries (placement());
# phase 15 (a) measures both sides of the default budgets
HOST_TAIL_OFF = {"tsd.query.host_tail_max_cells": "-1",
                 "tsd.query.host_tail_max_cells_linear": "-1"}
# the keys that put the engine on its point path with nothing cached
# (phase 3); phases 4 and 5 set all but the result cache and the host
# tail back to the defaults, and phase 6 that too (engine_defaults())
ENGINE_KEYS = {"tsd.query.grid_reduce": "false",
               "tsd.query.device_cache_mb": "0",
               **HOST_TAIL_OFF,
               "tsd.query.cache.enable": "false"}
# phase 7: (query, time zone, the prepared batch's layout)
IRREGULAR_QUERIES = (
    ("sum:5m-last:rate:sys.cpu.user{dc=*}", None, "padded"),
    ("p99:5m-median:sys.cpu.user{rack=*}", None, "flat"),
    ("avg:15mc-max:sys.cpu.user{dc=*}", "America/New_York", "padded"),
    ("sum:sys.cpu.user{dc=*}", None, "flat"))
JITTER_S = 10              # phase 7: whole seconds of jitter, 0-9
IRREGULAR_REPEATS = 3      # phase 7: warm hits and repeats per stage
DROP = 0.02                # phase 7: share of points dropped
CPU64_SHARE = 10           # phases 7, 11: 1 in 10 groups held to CPU float64
FANOUT_REPEATS = 3         # repeats of each point-path fan-out reading
REPRO_LAUNCHES = 20        # launches of each kernel's reproducibility reading
# device memory rate by card name (NVIDIA data sheets), bytes/s
_MEM_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
             ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
F32_PEAK = 67e12           # float32 FLOP/s outside the tensor cores
# float64 FLOP/s outside the tensor cores (NVIDIA's H100 SXM data sheet)
F64_PEAK = 34e12
TOL_REL, TOL_ABS = 1e-5, 1e-6
REPEATS = 5                # warm repeats per timed stage
# phases 9 and 10 hold a quarter of the series: at config 3's full 1M
# they took 400 of the run's 1200 s (PERF.md section 4)
STORE_CUT = 4
# readings of one phase that a later one prints beside its own
READINGS: dict[str, float] = {}


class SmokeFailure(RuntimeError):
    pass


def engine_defaults():
    """The engine keys' defaults as the phases before 15 run them: the
    reference's, but the host tail off (HOST_TAIL_OFF)."""
    from opentsdb_tpu_torch import Config
    return Config(**HOST_TAIL_OFF)


def placement(label: str, s: int, b: int, g: int, agg: str = "sum",
              emit_raw: bool = False) -> bool:
    """Print where ``host_tail_for_dims`` places a query's tail of true
    dims (S, B, G) at the default budgets and as the phase runs it (the
    host tail off); returns True where the defaults would place it on
    the host."""
    from opentsdb_tpu_torch import Config
    from opentsdb_tpu_torch.query.engine import host_tail_for_dims
    host = host_tail_for_dims(Config(), s, b, g, emit_raw, agg) \
        is not None
    pinned = host_tail_for_dims(engine_defaults(), s, b, g, emit_raw, agg)
    print(f"  placement {label} [S={s}, B={b}, G={g}, {agg}]: "
          f"{'host' if host else 'card'} at the default budgets; "
          f"{'host' if pinned is not None else 'card'} as run "
          "(host tail pinned off)")
    return host


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def host_cpu() -> str:
    """The host CPU: ``lscpu``'s model name where it is installed, and
    the vendor, family, model and stepping of ``/proc/cpuinfo``."""
    import shutil
    said = []
    if shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=60).stdout
        said += [f"lscpu model name {line.split(':', 1)[1].strip()!r}"
                 for line in out.splitlines()
                 if line.startswith("Model name:")]
    first = Path("/proc/cpuinfo").read_text().strip().split("\n\n")[0]
    fields = dict(line.split(":", 1) for line in first.splitlines()
                  if ":" in line)
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    said.append("/proc/cpuinfo " + ", ".join(
        f"{k} {fields[k]!r}" for k in ("vendor_id", "model name",
                                       "cpu family", "model", "stepping")
        if k in fields))
    return "; ".join(said)


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
              f"{e.key[:72]} {e.self_device_time_total / 1e3:.3f} ms"
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
    check acc, result NaNs and emit. Returns (kernel name, max err,
    whether the rows were read through a group-sort permutation)."""
    import torch
    batch = fused.prepare(values, bucket_ts, gids, spec,
                          allow_span=allow_span)
    if batch.spans is not None:
        name = "span_reduce"
        got = fused.span_reduce(batch.values, batch.order, batch.gids,
                                batch.spans, batch.group_start,
                                batch.inv_dt, spec, k, cm, rv)
    else:
        name = "onehot_reduce"
        got = fused.onehot_reduce(batch.values, batch.order, batch.gids,
                                  batch.group_start, batch.inv_dt, spec,
                                  k, cm, rv)
    want = fused.plain_reduce(batch, spec, k, cm, rv, exact=True)
    terms = fused.plain_reduce(batch, spec, k, cm, rv, exact=True,
                               magnitude=True)
    torch.cuda.synchronize()
    err = compare(got, want, terms)
    res_k, emit_k = fused._finalize(got, batch.sizes, spec)
    res_p, emit_p = fused._finalize(want, batch.sizes, spec)
    check(bool(torch.equal(emit_k, emit_p)), "emit masks differ")
    check(bool(torch.equal(torch.isnan(res_k), torch.isnan(res_p))),
          "result NaN positions differ")
    return name, err, batch.order is not None


def phase_sweep(torch, fused, PipelineSpec) -> dict:
    """Kernels vs plain over ds-fn x aggregator x rate at odd sizes."""
    import numpy as np
    rng = np.random.default_rng(7)
    worst = {"span_reduce": 0.0, "onehot_reduce": 0.0}
    cases = {"span_reduce": 0, "onehot_reduce": 0}
    permuted = 0  # span cases whose rows were read through the order
    failures = []
    # (S, B, k, G, layout): "sorted" ids in the span layout, "span"
    # unsorted ids in the span layout (rows read through the
    # permutation; G <= 8 always fits), "onehot" unsorted ids with the
    # span layout refused. Both unsorted kinds cover P % 4 != 0 (P =
    # 63) and rings that wrap (200,003 rows give each warp of 132 blocks
    # of 24 about two 32-row tiles of four chunks (P = 64), some eight
    # steps through its two ring stages); the one-hot cases also cover
    # G > 1024, the group-chunk loop (G = 4000) and rows of 26,000
    # buckets, more than the shared accumulator holds (bucket chunks)
    sizes = ((1000, 5, 3, 7, "sorted"), (4097, 12, 5, 37, "sorted"),
             (129, 12, 5, 3, "span"), (3001, 7, 9, 5, "span"),
             (200_003, 16, 4, 7, "span"),
             (3001, 7, 9, 61, "onehot"), (2050, 13, 4, 4000, "onehot"),
             (5003, 9, 7, 2500, "onehot"),
             (200_003, 16, 4, 2000, "onehot"),
             (70, 26_000, 1, 3, "onehot"))
    rates = ((False, False), (True, False), (True, True))
    for s, b, k, g, layout in sizes:
        p = b * k
        base = rng.normal(100.0, 15.0, (s, p))
        counter = np.cumsum(rng.uniform(1, 50, (s, p)), axis=1)
        counter[s // 3, p // 2:] -= counter[s // 3, p // 2] * 0.9
        on_card = {False: torch.as_tensor(base, dtype=torch.float32).cuda(),
                   True: torch.as_tensor(counter,
                                         dtype=torch.float32).cuda()}
        gids = rng.integers(0, g, s).astype(np.int32)
        if layout == "sorted":
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
                        name, err, perm = kernel_vs_plain(
                            fused, spec, vals, ts, gids, k, cm, rv,
                            allow_span=layout != "onehot")
                    except SmokeFailure as exc:
                        failures.append(f"S={s} B={b} k={k} G={g} "
                                        f"{layout} ds={ds} agg={agg} "
                                        f"rate={rate} counter={ctr}: "
                                        f"{exc}")
                        continue
                    worst[name] = max(worst[name], err)
                    cases[name] += 1
                    permuted += perm
                    line[name] = max(line.get(name, 0.0), err)
            print(f"  sweep S={s} B={b} k={k} G={g} {layout} ds={ds}: "
                  + ", ".join(f"{n} max_abs_err={e:.3g}"
                              for n, e in line.items()))
    for line in failures:
        print(f"  FAIL {line}")
    check(not failures, f"{len(failures)} sweep cases failed")
    for name in worst:
        print(f"  sweep {name}: {cases[name]} cases pass, "
              f"max_abs_err={worst[name]:.6g}")
        check(cases[name] > 0, f"sweep never reached {name}")
    print(f"  sweep span_reduce through the permutation: {permuted} "
          "cases")
    check(permuted > 0, "no sweep case read rows through the order")
    return worst


def plain_read(torch, rate: float) -> float:
    """Time a plain read of config 3's [1M, 60] float32 value matrix
    (``sum()``, by CUDA events) against the card's memory rate; returns
    its ms."""
    import numpy as np
    x = torch.as_tensor(np.random.default_rng(0).normal(
        100.0, 15.0, (1_000_000, POINTS)), dtype=torch.float32).cuda()
    ms = cuda_ms(lambda: x.sum(), 20)
    print(f"  plain read: sum() of [1000000, {POINTS}] float32 "
          f"({x.numel() * 4 / 1e6:.0f} MB) {ms:.4f} ms = "
          f"{x.numel() * 4 / ms / 1e9:.3f} TB/s of {rate / 1e12:.2f} TB/s")
    return ms


def rate_terms(torch, grid64, gids, g: int, bucket_ts):
    """[G, B] sum over each group's series of (|x_b| + |x_(b-1)|) / dt_b:
    the magnitude of the terms a summed rate of the grid adds up."""
    import numpy as np
    a = np.abs(grid64)
    per = np.zeros_like(a)
    per[:, 1:] = (a[:, 1:] + a[:, :-1]) / (np.diff(bucket_ts) / 1000.0)
    return torch.zeros((g, a.shape[1]), dtype=torch.float64).index_add_(
        0, torch.as_tensor(np.asarray(gids, dtype=np.int64)),
        torch.as_tensor(per))


def answer_values(rows, g: int, b: int):
    """The emitted values of a config-3 rate answer as a [G, B - 1]
    float64 tensor (the rate's first bucket is never emitted)."""
    import numpy as np
    import torch
    check(len(rows) == g, f"expected {g} groups, got {len(rows)}")
    vals = np.stack([r.dps_arrays[1] for r in rows])
    check(vals.shape == (g, b - 1), "unexpected result shape")
    check(bool(np.isfinite(vals).all()), "non-finite results")
    return torch.as_tensor(vals)


def config3_reference(values) -> dict:
    """Each of QUERIES over :func:`make_data`'s ``values`` in float64
    with numpy: ``{m: (tag key, tag value prefix, [G, B - 1] answer,
    [G, B - 1] sum|terms|)}``, row i the group whose tag value ends in
    i."""
    import numpy as np
    n = values.shape[0]
    avg = values.reshape(n, POINTS // 5, 5).mean(axis=2)
    per = {"rate": np.diff(avg, axis=1) / 300.0,
           "terms": (np.abs(avg[:, 1:]) + np.abs(avg[:, :-1])) / 300.0}
    out = {}
    for m, _ in QUERIES:
        key, prefix, mod = ("dc", "dc", 100) if "{dc=*}" in m \
            else ("rack", "r", 2000)
        gid = np.arange(n) % mod
        g = min(n, mod)
        want, terms = (np.stack([np.bincount(gid, x[:, j], minlength=g)
                                 for j in range(x.shape[1])], axis=1)
                       for x in (per["rate"], per["terms"]))
        out[m] = (key, prefix, want, terms)
    return out


def held_to_reference(rows, ref) -> float:
    """Max |got - want| of a config-3 rate answer against its
    :func:`config3_reference` entry; raises past the tolerance."""
    import torch
    key, prefix, want, terms = ref
    idx = [int(r.tags[key][len(prefix):]) for r in rows]
    check(sorted(idx) == list(range(len(want))),
          f"{len(idx)} groups in the answer, not {len(want)}")
    got = answer_values(rows, len(idx), want.shape[1] + 1)
    return compare(got, torch.as_tensor(want[idx]),
                   torch.as_tensor(terms[idx]))


def repeat_reading(torch, run) -> tuple[float, bool]:
    """A kernel's reproducibility across launches, on the same inputs:
    (max |d| of REPRO_LAUNCHES launches from the first, all of them
    bit-equal to it)."""
    first = run()
    worst, same = 0.0, True
    for _ in range(REPRO_LAUNCHES - 1):
        out = run()
        worst = max(worst, float((out - first).abs().max()))
        same = same and bool(torch.equal(out, first))
    return worst, same


def same_bits(rows_a, rows_b) -> bool:
    """Two answers hold the same groups, timestamps and value bits."""
    import numpy as np
    return len(rows_a) == len(rows_b) and all(
        a.tags == b.tags
        and np.array_equal(a.dps_arrays[0], b.dps_arrays[0])
        and np.array_equal(a.dps_arrays[1].view(np.int64),
                           b.dps_arrays[1].view(np.int64))
        for a, b in zip(rows_a, rows_b))


def prod_reading(torch, grid, gids, g: int) -> None:
    """A reading for the record, not a check: the group stage's
    fixed-order product (``GroupPlan.prod``, the ``multiply``
    aggregator) against ``torch.segment_reduce``'s over the same rows
    in group order: device time, and whether two calls give the same
    bits."""
    import numpy as np
    from opentsdb_tpu_torch.ops.groupby import GroupPlan
    x = 1.0 + (grid - 100.0) * 1e-5   # near 1: the products stay finite
    gid_t = torch.as_tensor(np.asarray(gids, dtype=np.int64),
                            device=grid.device)
    plan_ms = cuda_ms(lambda: GroupPlan(gid_t, g), 5)
    plan = GroupPlan(gid_t, g)
    ours = [plan.prod(x) for _ in range(2)]
    ours_ms = cuda_ms(lambda: plan.prod(x), 5)
    xs = x.index_select(0, torch.sort(gid_t, stable=True).indices)
    lengths = torch.bincount(gid_t, minlength=g)
    seg = [torch.segment_reduce(xs, "prod", lengths=lengths, axis=0)
           for _ in range(2)]
    seg_ms = cuda_ms(lambda: torch.segment_reduce(
        xs, "prod", lengths=lengths, axis=0), 5)
    torch.cuda.synchronize()
    print(f"    group product, G={g}: GroupPlan build {plan_ms:.4f} ms, "
          f"prod {ours_ms:.4f} ms, two calls bit-equal "
          f"{bool(torch.equal(ours[0], ours[1]))}; segment_reduce prod "
          f"{seg_ms:.4f} ms, two calls bit-equal "
          f"{bool(torch.equal(seg[0], seg[1]))}, max |d| from GroupPlan "
          f"{float((seg[0] - ours[0]).abs().max())!r}")


def reset_launches(fused) -> None:
    for w in (fused.span_reduce, fused.onehot_reduce):
        w.launches = 0


def read_launches(fused) -> dict:
    return {"span_reduce": fused.span_reduce.launches,
            "onehot_reduce": fused.onehot_reduce.launches}


def phase_grid(torch, tsdb, query, profile: bool) -> None:
    """Phase 4: the grid path at the default engine keys."""
    import numpy as np
    from opentsdb_tpu_torch import Config
    from opentsdb_tpu_torch.ops import downsample as ds_mod
    from opentsdb_tpu_torch.ops import fused, pipeline
    from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
    from opentsdb_tpu_torch.query.engine import grid_cache_key
    defaults = engine_defaults()
    for key in ENGINE_KEYS:
        if key != "tsd.query.cache.enable":
            tsdb.config.override_config(key, defaults.get_string(key))
    store = tsdb.store
    metric_id = tsdb.uids.metrics.get_id(METRIC)
    sids = store.series_ids_for_metric(metric_id)
    reset_launches(fused)
    runs = {}
    for m, _ in QUERIES:
        cold_s = []
        for i in range(REPEATS):
            tsdb.drop_caches()
            cold, secs = timed(lambda: tsdb.execute_query(query(m)), 1)
            cold_s += secs
            if i == 0:
                first = cold
            # the device cache dropped in between: the same bits
            check(same_bits(cold, first),
                  f"{m}: two cold grid calls differ in their bits")
        cache = tsdb.device_grid_cache
        hits = cache.hits
        warm, warm_s = timed(lambda: tsdb.execute_query(query(m)),
                             REPEATS)
        check(cache.hits == hits + REPEATS,
              f"warm grid calls made {cache.hits - hits} cache hits, "
              f"not {REPEATS}")
        runs[m] = (cold, warm, cold_s, warm_s)
    launches = read_launches(fused)
    print(f"  grid-path launches: {launches}")
    check(not any(launches.values()), "the grid path launched a kernel")
    if profile:
        for m, _ in QUERIES:
            tsdb.drop_caches()
            device_share(torch, lambda: tsdb.execute_query(query(m)),
                         f"{m} grid cold")
            device_share(torch, lambda: tsdb.execute_query(query(m)),
                         f"{m} grid warm")

    for m, _ in QUERIES:
        cold, warm, cold_s, warm_s = runs[m]
        tq = query(m)
        sub = tq.queries[0]
        ds = sub.ds_spec
        check(sub.aggregator == "sum" and sub.rate,
              "rate_terms bounds a summed rate only")
        eng = tsdb.new_query()
        gb = [tsdb.uids.tag_names.get_id(f.tagk) for f in sub.filters
              if f.group_by]

        def plan():
            sel, tag_mat = eng._apply_filters(metric_id, sub, sids)
            return (sel, tag_mat) + eng._group_ids(tag_mat, gb)

        (sel, tag_mat, gids, g), plan_t = timed(plan, REPEATS)
        bts = ds_mod.fixed_bucket_edges(tq.start_ms, tq.end_ms,
                                        ds.interval_ms)
        b = len(bts)

        def reduce():
            return pipeline.grid_from_reduce(
                ds.function, *store.bucket_reduce(
                    sel, tq.start_ms, tq.end_ms, int(bts[0]),
                    ds.interval_ms, b))

        (grid64, present), red_t = timed(reduce, REPEATS)
        (grid, has), up_t = timed(lambda: pipeline.put_grid(
            grid64, present, torch.float32, "cuda"), REPEATS)
        spec = PipelineSpec(num_series=len(sel), num_buckets=b,
                            num_groups=g, ds_function="avg",
                            agg_name=sub.agg.name, rate=sub.rate)
        (res, emit), tail_t = timed(lambda: pipeline.execute_grid(
            grid, has, bts, gids, spec, sub.rate_options), REPEATS)
        _, asm_t = timed(lambda: eng._build_results(
            tq, sub, metric_id, sel, tag_mat, gids, g, bts,
            res.cpu().numpy(), emit.cpu().numpy()), REPEATS)
        check(res.is_cuda and emit.is_cuda, "results are not on cuda")

        # the same query through the port on the CPU in float64
        g64, h64 = pipeline.put_grid(grid64, present, torch.float64,
                                     "cpu")
        want, want_emit = pipeline.execute_grid(g64, h64, bts, gids, spec,
                                                sub.rate_options)
        check(bool(want_emit[:, 1:].all()) and not want_emit[:, 0].any(),
              "unexpected emit mask")
        terms = rate_terms(torch, grid64, gids, g, bts)[:, 1:]
        want = want[:, 1:]
        err = compare(answer_values(cold, g, b), want, terms)
        check(same_bits(warm, cold), f"{m}: warm and cold grid answers "
              "differ in their bits")
        # the cached grid is the one a fresh reduction uploads
        hit = tsdb.device_grid_cache.get(
            grid_cache_key(store, sel, tq.start_ms, tq.end_ms, bts,
                           ds.interval_ms, ds.function), store.version)
        check(hit is not None, "no cached grid for the query")
        (cgrid, chas), _ = hit
        check(bool(torch.equal(cgrid.view(torch.int32),
                               grid.view(torch.int32)))
              and bool(torch.equal(chas, has)),
              "the cached grid differs from a fresh reduction")
        if profile:
            # the upload alone: its copy's share of a cold query
            device_share(torch, lambda: pipeline.put_grid(
                grid64, present, torch.float32, "cuda"),
                f"{m} grid upload")
        stages = (("plan", plan_t), ("bucket_reduce", red_t),
                  ("upload", up_t), ("tail", tail_t),
                  ("assemble", asm_t))
        print(f"  {m} grid: S={len(sel)} B={b} G={g}; p50 ms: "
              + ", ".join(f"{n} {p50(v) * 1e3:.3f}" for n, v in stages)
              + f"; sum {sum(p50(v) for _, v in stages) * 1e3:.3f}")
        print(f"  {m} grid: end-to-end p50 cold {p50(cold_s) * 1e3:.3f} "
              f"ms, warm {p50(warm_s) * 1e3:.3f} ms; max_abs_err vs "
              f"CPU float64 {err:.6g}; {REPEATS} cold calls and the "
              "warm ones equal bit for bit; cached grid equals a fresh "
              "one bit for bit")
        prod_reading(torch, grid, gids, g)


def phase_prepared(torch, tsdb, query, ref3: dict) -> dict:
    """Phase 5: grid_reduce=false with the device cache on. Returns
    the warm hits' kernel launches."""
    import numpy as np
    from opentsdb_tpu_torch.ops import fused
    tsdb.config.override_config("tsd.query.grid_reduce", "false")
    cache = tsdb.device_grid_cache
    check(cache is not None, "the device cache is off")
    for m, _ in QUERIES:  # cold: the first call uploads the batch
        tsdb.execute_query(query(m))
    hits = cache.hits
    reset_launches(fused)
    answers, secs = {}, {}
    again = {}
    for m, _ in QUERIES:
        answers[m], secs[m] = timed(lambda: tsdb.execute_query(query(m)),
                                    REPEATS)
        again[m] = tsdb.execute_query(query(m))
    launches = read_launches(fused)
    print(f"  prepared-batch launches: {launches}")
    check(cache.hits == hits + (REPEATS + 1) * len(QUERIES),
          f"warm calls made {cache.hits - hits} cache hits")
    for m, kname in QUERIES:
        diff = max(float(np.abs(a.dps_arrays[1] - b.dps_arrays[1]).max())
                   for a, b in zip(answers[m], again[m]))
        print(f"  {m} prepared: two warm hits ({kname}) differ by max "
              f"|d| {diff!r}; bit-equal {same_bits(answers[m], again[m])}")
        check(same_bits(answers[m], again[m]),
              f"two {kname} hits differ in their bits")
    for m, kname in QUERIES:
        check(launches[kname] >= REPEATS,
              f"{kname} did not launch on each warm hit")
        want, terms = ref3[m]
        g, b = want.shape[0], want.shape[1] + 1
        err = compare(answer_values(answers[m], g, b), want, terms)
        print(f"  {m} prepared: warm p50 {p50(secs[m]) * 1e3:.3f} ms "
              f"({kname}); max_abs_err vs phase 3's plain {err:.6g}")
    return launches


def phase_serve(torch, tsdb, query, ref3: dict, last_tags: dict) -> dict:
    """Phase 6: the serve path at the default keys (result cache on,
    fan-out on 4 threads). Returns the kernel launches of its point-path
    fan-out calls."""
    import numpy as np
    from opentsdb_tpu_torch import Config
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.query import engine as engine_mod
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    cfg = tsdb.config
    defaults = engine_defaults()

    def set_keys(**keys):
        for key in ENGINE_KEYS:
            cfg.override_config(key, defaults.get_string(key))
        for key, val in keys.items():
            cfg.override_config(key, val)

    set_keys()
    rc = tsdb.result_cache
    check(rc is not None and tsdb.query_fanout_pool is not None,
          "the result cache or the fan-out pool is off at the defaults")
    (dc, _), (rack, kname_rack) = QUERIES
    store = tsdb.store
    metric_id = tsdb.uids.metrics.get_id(METRIC)
    sids = store.series_ids_for_metric(metric_id)

    # -- the tag-matrix cache: builds counted on the class
    builds = []
    from_triples = engine_mod.TagMatrix.__dict__["from_triples"]
    engine_mod.TagMatrix.from_triples = classmethod(
        lambda cls, s, t: builds.append(len(s))
        or from_triples.__func__(cls, s, t))
    try:
        def plan(m):
            sub = query(m).queries[0]
            eng = tsdb.new_query()
            _, tag_mat = eng._apply_filters(metric_id, sub, sids)
            return eng._group_ids(tag_mat, [
                tsdb.uids.tag_names.get_id(f.tagk) for f in sub.filters
                if f.group_by])

        built_s = []
        for _ in range(REPEATS):
            tsdb._tagmat_cache.clear()
            built_s += timed(lambda: plan(dc), 1)[1]
        hit_s = timed(lambda: plan(rack), REPEATS)[1]
        check(len(builds) == REPEATS, "the tag matrix was not reused")
        tsdb._tagmat_cache.clear()
        tsdb.drop_caches()
        n0 = len(builds)
        dc_s = timed(lambda: tsdb.execute_query(query(dc)), 1)[1]
        rack_s = timed(lambda: tsdb.execute_query(query(rack)), 1)[1]
        check(len(builds) - n0 == 1,
              f"{len(builds) - n0} tag-matrix builds for two queries")
    finally:
        engine_mod.TagMatrix.from_triples = from_triples
    print(f"  tag matrix: plan p50 {p50(built_s) * 1e3:.3f} ms with the "
          f"matrix built ({dc}), {p50(hit_s) * 1e3:.3f} ms on a hit "
          f"({rack}); end to end {dc} {dc_s[0] * 1e3:.3f} ms (matrix "
          f"built, grid cold), then {rack} {rack_s[0] * 1e3:.3f} ms "
          "(matrix hit, grid hit): 1 build, 1 hit")

    # -- the result cache: a miss, hits equal to it, the same query with
    # the cache off equal to it
    rc.clear()
    h0, m0 = rc.hits, rc.misses
    miss, miss_s = timed(lambda: tsdb.execute_query(query(dc)), 1)
    hits, hit_s = [], []
    for _ in range(REPEATS):
        rows, secs = timed(lambda: tsdb.execute_query(query(dc)), 1)
        hits.append(rows)
        hit_s += secs
    check((rc.hits - h0, rc.misses - m0) == (REPEATS, 1),
          f"result cache: {rc.hits - h0} hits, {rc.misses - m0} misses")
    check(all(same_bits(r, miss) for r in hits),
          "a result-cache hit differs from its miss")
    set_keys(**{"tsd.query.cache.enable": "false"})
    check(same_bits(tsdb.execute_query(query(dc)), miss),
          "the miss differs from the same query with the cache off")
    set_keys()
    print(f"  result cache {dc}: miss {miss_s[0] * 1e3:.3f} ms, hit p50 "
          f"{p50(hit_s) * 1e3:.3f} ms over {REPEATS}; hits, miss and a "
          "cache-off call equal bit for bit")

    # -- fan-out: one TSQuery of both queries against each sub alone
    q0 = query(dc)

    def both():
        return TSQuery(start=q0.start, end=q0.end, queries=[
            parse_uri_subquery(m, i) for i, m in
            enumerate((dc, rack))]).validate()

    def split(rows):
        idx = [r.sub_query_index for r in rows]
        check(idx == sorted(idx), "fan-out results out of sub order")
        return ([r for r in rows if r.sub_query_index == 0],
                [r for r in rows if r.sub_query_index == 1])

    def uncached(fn):
        # the result cache emptied, so each call runs the engine
        def run():
            rc.clear()
            return fn()
        return run

    fan, fan_s = timed(uncached(lambda: tsdb.execute_query(both())),
                       REPEATS)
    one_dc, one_dc_s = timed(uncached(
        lambda: tsdb.execute_query(query(dc))), REPEATS)
    one_rack, one_rack_s = timed(uncached(
        lambda: tsdb.execute_query(query(rack))), REPEATS)
    fan_dc, fan_rack = split(fan)
    check(same_bits(fan_dc, one_dc) and same_bits(fan_rack, one_rack),
          "a fanned-out grid sub differs from the sub alone")
    print(f"  fan-out, grid path (device cache warm): p50 "
          f"{p50(fan_s) * 1e3:.3f} ms against {p50(one_dc_s) * 1e3:.3f} "
          f"+ {p50(one_rack_s) * 1e3:.3f} = "
          f"{(p50(one_dc_s) + p50(one_rack_s)) * 1e3:.3f} ms alone; each "
          "sub equals itself alone bit for bit")

    set_keys(**{"tsd.query.grid_reduce": "false",
                "tsd.query.device_cache_mb": "0",
                "tsd.query.cache.enable": "false"})
    total = {"span_reduce": 0, "onehot_reduce": 0}
    fan_s = []
    for _ in range(FANOUT_REPEATS):
        # counts set to 0 just before each call and read just after
        reset_launches(fused)
        fan, secs = timed(lambda: tsdb.execute_query(both()), 1)
        n = read_launches(fused)
        check(n == {"span_reduce": 1, "onehot_reduce": 1},
              f"a point-path fan-out launched {n}")
        fan_s += secs
        for k in total:
            total[k] += n[k]
    one_dc, one_dc_s = timed(lambda: tsdb.execute_query(query(dc)),
                             FANOUT_REPEATS)
    one_rack, one_rack_s = timed(lambda: tsdb.execute_query(query(rack)),
                                 FANOUT_REPEATS)
    fan_dc, fan_rack = split(fan)
    check(same_bits(fan_dc, one_dc) and same_bits(fan_rack, one_rack),
          "a fanned-out point-path sub differs from it alone")
    want, terms = ref3[rack]
    g, b = want.shape[0], want.shape[1] + 1
    err = compare(answer_values(fan_rack, g, b),
                  answer_values(one_rack, g, b), terms)
    print(f"  fan-out, point path (every cache off): launches {total} "
          f"over {FANOUT_REPEATS} calls; p50 {p50(fan_s) * 1e3:.3f} ms "
          f"against {p50(one_dc_s) * 1e3:.3f} + "
          f"{p50(one_rack_s) * 1e3:.3f} = "
          f"{(p50(one_dc_s) + p50(one_rack_s)) * 1e3:.3f} ms alone; "
          f"both subs equal bit for bit to them alone ({kname_rack} max "
          f"|d| {err!r})")

    # -- a write: the next call misses and equals a cache-off call. The
    # point lands after the last series' last one, inside the window
    set_keys()
    before = tsdb.execute_query(query(dc))
    m0 = rc.misses
    tsdb.add_point(METRIC, T0 + POINTS * 60 - 30, 1000.0, last_tags)
    after, after_s = timed(lambda: tsdb.execute_query(query(dc)), 1)
    check(rc.misses == m0 + 1, "the call after a write was not a miss")
    check(not same_bits(after, before), "the write changed no answer")
    set_keys(**{"tsd.query.cache.enable": "false"})
    check(same_bits(tsdb.execute_query(query(dc)), after),
          "after a write, the recompute differs from a cache-off call")
    set_keys()
    print(f"  result cache after a write: miss {after_s[0] * 1e3:.3f} ms "
          "(store fold, grid cold), equal bit for bit to a cache-off "
          "call")
    return total


# phase 8: the front end (HTTP and telnet on one port)
# phase 8's repeats and volumes, CUT for the run's time limit (from 5
# HTTP and 3 direct calls, 8 clients and 1M points)
FE_REPEATS = 5             # HTTP calls per query in (a), 1 POST + 4 GET
FE_DIRECT = 3              # direct execute_query calls per query in (a)
FE_CLIENTS = 8             # concurrent HTTP clients in (d)
PUT_SERIES, PUT_STEPS = 1000, 1000       # (c): 1M points by /api/put
PUT_BODY_SERIES, PUT_BODY_STEPS = 100, 10  # 1000 points per body
PUT_CONNS = 4
TEL_SERIES, TEL_STEPS = 200, 1000        # (c): 200k telnet put lines


def _sub_json(m: str) -> dict:
    """The JSON form of one URI sub-query."""
    from opentsdb_tpu_torch.query.model import parse_uri_subquery
    sub = parse_uri_subquery(m)
    return {"aggregator": sub.aggregator, "metric": sub.metric,
            "downsample": sub.downsample, "rate": sub.rate,
            "filters": [f.to_json() for f in sub.filters]}


def _http(conn, method: str, path: str, body: bytes | None = None):
    """One request on a kept-alive http.client connection: (status,
    body, seconds)."""
    t = time.perf_counter()
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    return resp.status, data, time.perf_counter() - t


def _fe_values(rows, g: int, b: int):
    """[G, B - 1] float64 values of a parsed config-3 rate answer."""
    import torch
    check(len(rows) == g, f"expected {g} groups, got {len(rows)}")
    vals = [list(r["dps"].values()) for r in rows]
    check(all(len(v) == b - 1 for v in vals), "unexpected result shape")
    return torch.tensor(vals, dtype=torch.float64)


def put_points(port: int, metric: str) -> float:
    """PUT_SERIES x PUT_STEPS points of ``metric`` by ``/api/put`` in
    1000-point bodies over PUT_CONNS kept-alive connections; the
    seconds it took. Host i's point j is ``(i * 7 + j) % 100000``."""
    import http.client
    n_series_bodies = PUT_SERIES // PUT_BODY_SERIES

    def put_bodies(c: int):
        for k in range(c, n_series_bodies * (PUT_STEPS // PUT_BODY_STEPS),
                       PUT_CONNS):
            s0 = (k % n_series_bodies) * PUT_BODY_SERIES
            j0 = (k // n_series_bodies) * PUT_BODY_STEPS
            yield json.dumps([
                {"metric": metric, "timestamp": T0 + 60 * j,
                 "value": (i * 7 + j) % 100_000, "tags": {"host": f"p{i}"}}
                for i in range(s0, s0 + PUT_BODY_SERIES)
                for j in range(j0, j0 + PUT_BODY_STEPS)]).encode()

    bodies = [list(put_bodies(c)) for c in range(PUT_CONNS)]
    fails = []

    def putter(c: int) -> None:
        cn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            for b in bodies[c]:
                status, data, _ = _http(cn, "POST", "/api/put", b)
                if status != 204:
                    fails.append((status, data[:200]))
        finally:
            cn.close()

    t = time.perf_counter()
    threads = [threading.Thread(target=putter, args=(c,))
               for c in range(PUT_CONNS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    secs = time.perf_counter() - t
    check(not fails, f"puts failed: {fails[:3]}")
    return secs


def phase_front_end(torch, tsdb, query, ref3: dict,
                    profile: bool) -> dict:
    """Phase 8: the port's TSD server in process on an ephemeral port
    over phase 3's TSDB and keys, driven over real sockets. Returns the
    kernel launches of its HTTP queries in (a) and (d)."""
    import http.client
    import socket
    import threading
    import urllib.parse
    from opentsdb_tpu_torch import Config
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.tsd.json_serializer import HttpJsonSerializer
    from opentsdb_tpu_torch.tsd.server import ServerThread
    cfg, defaults = tsdb.config, engine_defaults()

    def set_keys(keys: dict) -> None:
        for key in ENGINE_KEYS:
            cfg.override_config(key, keys.get(key,
                                              defaults.get_string(key)))

    set_keys(ENGINE_KEYS)
    # the router's serializer: the native dps formatter on this store
    ser = HttpJsonSerializer.for_tsdb(tsdb)
    q0 = query(QUERIES[0][0])
    start, end = q0.start, q0.end
    st = serve_pinned(ServerThread, tsdb)
    print(f"  server on 127.0.0.1:{st.port} (ephemeral), keys of phase 3")
    total = {"span_reduce": 0, "onehot_reduce": 0}

    def connect():
        return http.client.HTTPConnection("127.0.0.1", st.port,
                                          timeout=600)

    def post_body(m: str) -> bytes:
        return json.dumps({"start": start, "end": end,
                           "queries": [_sub_json(m)]}).encode()

    def get_path(m: str) -> str:
        return "/api/query?" + urllib.parse.urlencode(
            {"start": start, "end": end, "m": m})

    try:
        # (a) POST and GET of each query: one launch of its kernel each
        expected = {}
        conn = connect()
        for m, kname in QUERIES:
            other = next(k for _, k in QUERIES if k != kname)
            direct_s = []
            for _ in range(FE_DIRECT):
                torch.cuda.synchronize()
                t = time.perf_counter()
                rows = tsdb.execute_query(query(m))
                direct_s.append(time.perf_counter() - t)
            ser_s = timed(lambda: ser.format_query(query(m), rows),
                          REPEATS)[1]
            want = json.loads(ser.format_query(query(m), rows))
            expected[m] = want
            http_s = []
            for i in range(FE_REPEATS):
                reset_launches(fused)
                if i == 0:
                    status, body, secs = _http(conn, "POST", "/api/query",
                                               post_body(m))
                else:
                    status, body, secs = _http(conn, "GET", get_path(m))
                n = read_launches(fused)
                check(status == 200, f"{m}: HTTP {status}: {body[:300]!r}")
                check(n == {kname: 1, other: 0},
                      f"{m}: an HTTP query launched {n}")
                total[kname] += 1
                check(json.loads(body) == want,
                      f"{m}: the HTTP answer differs from execute_query's")
                http_s.append(secs)
            if profile:
                reset_launches(fused)
                device_share(torch, lambda: _http(conn, "GET", get_path(m)),
                             f"HTTP GET {m}")
                total[kname] += read_launches(fused)[kname]
            wv, terms = ref3[m]
            err = compare(_fe_values(want, wv.shape[0], wv.shape[1] + 1),
                          wv, terms)
            print(f"  (a) {m}: HTTP p50 {p50(http_s) * 1e3:.3f} ms over "
                  f"{FE_REPEATS} (1 POST, {FE_REPEATS - 1} GET), direct "
                  f"execute_query p50 {p50(direct_s) * 1e3:.3f} ms over "
                  f"{FE_DIRECT}, serializer p50 {p50(ser_s) * 1e3:.3f} ms "
                  f"({len(body)} bytes); one {kname} launch per call; "
                  f"answers equal execute_query's bit for bit, max |d| "
                  f"vs phase 3's float64 reference {err!r}")

        # (b) the default grid and result-cache keys: a miss, then hits
        set_keys({})
        for m, _ in QUERIES:
            status, miss, miss_s = _http(conn, "GET", get_path(m))
            check(status == 200, f"{m}: HTTP {status}")
            hit_s = []
            for _ in range(REPEATS):
                status, body, secs = _http(conn, "GET", get_path(m))
                check(status == 200 and body == miss,
                      f"{m}: a result-cache hit differs from its miss")
                hit_s.append(secs)
            wv, terms = ref3[m]
            err = compare(_fe_values(json.loads(miss), wv.shape[0],
                                     wv.shape[1] + 1), wv, terms)
            print(f"  (b) {m} at the default keys: HTTP miss "
                  f"{miss_s * 1e3:.3f} ms, result-cache hit p50 "
                  f"{p50(hit_s) * 1e3:.3f} ms over {REPEATS}; hits equal "
                  f"the miss byte for byte, max |d| vs phase 3's "
                  f"reference {err!r}")
        set_keys(ENGINE_KEYS)
        conn.close()

        # (d) concurrent clients of (a)
        lat, bad = [], []
        lock = threading.Lock()

        def client(i: int) -> None:
            m = QUERIES[i % 2][0]
            c = connect()
            try:
                status, body, secs = _http(c, "POST", "/api/query",
                                           post_body(m))
                ok = status == 200 and json.loads(body) == expected[m]
            finally:
                c.close()
            with lock:
                lat.append(secs)
                if not ok:
                    bad.append((m, status))

        reset_launches(fused)
        t = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(FE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t
        n = read_launches(fused)
        check(not bad, f"concurrent answers wrong: {bad}")
        half = FE_CLIENTS // 2
        check(n == {"span_reduce": half, "onehot_reduce": half},
              f"{FE_CLIENTS} concurrent queries launched {n}")
        for k in total:
            total[k] += n[k]
        lat.sort()
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        print(f"  (d) {FE_CLIENTS} concurrent clients: every answer "
              f"equal to (a)'s; p50 {p50(lat) * 1e3:.3f} ms, p99 "
              f"{p99 * 1e3:.3f} ms, wall {wall * 1e3:.3f} ms; launches {n}")

        # (e) an unported endpoint and a bad aggregator
        conn = connect()
        status, body, _ = _http(conn, "GET", "/api/search/lookup?m=x")
        check(status == 501 and b"not ported yet" in body,
              f"an unported endpoint answered {status}")
        status, body, _ = _http(conn, "GET", get_path(
            f"nope:{METRIC}{{dc=*}}"))
        check(status == 400 and b"No such aggregator" in body,
              f"a bad aggregator answered {status}")
        conn.close()
        print("  (e) /api/search/lookup: 501 (not ported yet); a bad "
              "aggregator: 400")

        # (c) writes: /api/put over kept-alive connections, then telnet
        put_metric, tel_metric = "sys.fe.put", "sys.fe.tel"
        put_s = put_points(st.port, put_metric)
        n_put = PUT_SERIES * PUT_STEPS
        READINGS["put_points_per_s"] = n_put / put_s
        lines = "".join(
            f"put {tel_metric} {T0 + 60 * j} {(i * 3 + j) % 100_000} "
            f"host=t{i}\n" for j in range(TEL_STEPS)
            for i in range(TEL_SERIES)).encode()
        t = time.perf_counter()
        with socket.create_connection(("127.0.0.1", st.port), 600) as sk:
            sk.sendall(lines + b"version\nexit\n")
            out = b""
            while chunk := sk.recv(65536):
                out += chunk
        tel_s = time.perf_counter() - t
        check(out.decode().startswith("opentsdb_tpu_torch version")
              and out.count(b"\n") == 1,
              f"telnet answered more than the version: {out[:300]!r}")
        n_tel = TEL_SERIES * TEL_STEPS
        print(f"  (c) /api/put: {n_put} points in {n_put // 1000} bodies "
              f"of 1000 over {PUT_CONNS} kept-alive connections, "
              f"{put_s:.3f} s ({n_put / put_s:,.0f} points/s); telnet: "
              f"{n_tel} put lines on one connection, {tel_s:.3f} s "
              f"({n_tel / tel_s:,.0f} points/s)")
        conn = connect()
        for metric, series, steps, prefix, mul in (
                (put_metric, PUT_SERIES, PUT_STEPS, "p", 7),
                (tel_metric, TEL_SERIES, TEL_STEPS, "t", 3)):
            path = "/api/query?" + urllib.parse.urlencode(
                {"start": T0, "end": T0 + 60 * steps - 1,
                 "m": f"none:{metric}{{host=*}}"})
            status, body, secs = _http(conn, "GET", path)
            check(status == 200, f"read-back of {metric}: HTTP {status}")
            rows = json.loads(body)
            check(len(rows) == series, f"{metric}: {len(rows)} series")
            for r in rows:
                i = int(r["tags"]["host"][1:])
                want = {str(T0 + 60 * j): (i * mul + j) % 100_000
                        for j in range(steps)}
                check(r["dps"] == want, f"{metric} host {i} differs")
            print(f"  (c) read-back of {metric} by /api/query: "
                  f"{series * steps} points exact, {secs * 1e3:.3f} ms "
                  "(the first read after the writes)")
        conn.close()
    finally:
        st.stop()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("tsd-query", "tsd-http", "tsd-server"))]
    check(not left, f"threads left after the server stopped: {left}")
    print(f"  server stopped cleanly; HTTP-path launches {total}")
    return total


def make_data(n_series: int):
    import numpy as np
    rng = np.random.default_rng(0)
    tags = [{"host": f"h{i}", "dc": f"dc{i % 100}",
             "rack": f"r{i % 2000}"} for i in range(n_series)]
    ts_row = T0 + 60 * np.arange(POINTS, dtype=np.int64)
    ts2d = np.broadcast_to(ts_row, (n_series, POINTS))
    values = rng.normal(100.0, 15.0, (n_series, POINTS))
    return tags, ts2d, values


def make_irregular(n_series: int):
    """Config 3's series with irregular points: slot j of series i is
    at ``T0 + 60 j + u`` (``u`` a whole second in 0-9) and is dropped
    with probability DROP; values ``normal(100, 15)``; seed 0. Returns
    (tags, ts2d, values2d, counts), each row's points packed left."""
    import numpy as np
    rng = np.random.default_rng(0)
    tags = [{"host": f"h{i}", "dc": f"dc{i % 100}",
             "rack": f"r{i % 2000}"} for i in range(n_series)]
    shape = (n_series, POINTS)
    ts = T0 + 60 * np.arange(POINTS, dtype=np.int64) \
        + rng.integers(0, JITTER_S, shape)
    values = rng.normal(100.0, 15.0, shape)
    keep = rng.random(shape) >= DROP
    # kept slots first, in time order
    order = np.argsort(~keep, axis=1, kind="stable")
    counts = keep.sum(axis=1)
    ts2d = np.take_along_axis(ts, order, axis=1)
    values2d = np.take_along_axis(values, order, axis=1)
    pad = np.arange(POINTS)[None, :] >= counts[:, None]
    ts2d[pad], values2d[pad] = 0, np.nan
    return tags, ts2d, values2d, counts


def against_cpu64(torch, m: str, grid, spec, gids, rate_options,
                  res_np, emit_np, groups: int | None = None
                  ) -> tuple[float, float]:
    """Hold an answer (``res_np``, ``emit_np``, [G, B]) against the same
    query run through the port's unblocked point path on the CPU in
    float64, at |got - want| <= TOL_REL * sum|terms| + TOL_ABS. With
    ``groups``, only groups ``0..groups-1`` are held, each over all of
    its series on the query's own time grid (a group's answer depends on
    its series alone). Returns (max |got - want| over the emitted cells,
    CPU seconds)."""
    import numpy as np
    from opentsdb_tpu_torch.ops.pipeline import (prepare_auto,
                                                 prepare_flat,
                                                 run_prepared)
    t = time.perf_counter()
    gids = np.asarray(gids)
    padded, bucket_idx = grid.padded, grid.bucket_idx
    if padded is None:
        values, series_idx = grid.batch.values, grid.batch.series_idx
    if groups is not None and groups < spec.num_groups:
        keep = gids < groups
        gids = gids[keep]
        spec = replace(spec, num_series=len(gids), num_groups=groups)
        res_np, emit_np = res_np[:groups], emit_np[:groups]
        if padded is not None:
            padded = padded._replace(
                series_ids=padded.series_ids[keep],
                values2d=padded.values2d[keep], ts2d=padded.ts2d[keep],
                counts=padded.counts[keep])
            bucket_idx = bucket_idx[keep]
        else:
            at = keep[series_idx]
            rank = (np.cumsum(keep) - 1).astype(np.int32)
            values, series_idx, bucket_idx = (
                values[at], rank[series_idx[at]], bucket_idx[at])
    if padded is not None:
        cpu_prep = prepare_auto(padded, bucket_idx, spec,
                                dtype=torch.float64, device="cpu")
    else:
        cpu_prep = prepare_flat(values, series_idx, bucket_idx, spec,
                                dtype=torch.float64, device="cpu")
    want, want_emit = run_prepared(cpu_prep, grid.bucket_ts, gids, spec,
                                   rate_options)
    if spec.rate:
        # a summed rate's terms: (|x_b| + |x_(b-1)|) / dt_b over the
        # group's series, from the same sum without the rate
        a, _ = run_prepared(cpu_prep, grid.bucket_ts, gids,
                            replace(spec, rate=False), rate_options)
        dt = np.diff(grid.bucket_ts) / 1000.0
        terms = torch.zeros_like(a)
        terms[:, 1:] = (a[:, 1:].abs() + a[:, :-1].abs()) \
            / torch.as_tensor(dt)
    else:
        # positive values (checked by the callers): no cancellation, so
        # the answer is the magnitude of its terms
        terms = want.abs()
    cpu_s = time.perf_counter() - t
    del cpu_prep
    check(bool(np.array_equal(emit_np, want_emit.numpy())),
          f"{m}: emit masks differ from the CPU float64 port")
    got = torch.as_tensor(res_np, dtype=torch.float64)
    shown = torch.as_tensor(emit_np)
    err = compare(torch.where(shown, got, 0.0),
                  torch.where(shown, want, 0.0),
                  torch.where(shown, terms, 0.0))
    return err, cpu_s


def reset_blocked() -> None:
    from opentsdb_tpu_torch.ops.blocked import execute_blocked
    execute_blocked.runs = execute_blocked.blocks = 0


def read_blocked() -> tuple[int, int]:
    """(blocked runs, blocks) since the last :func:`reset_blocked`."""
    from opentsdb_tpu_torch.ops.blocked import execute_blocked
    return execute_blocked.runs, execute_blocked.blocks


def phase_irregular(torch, n_series: int, profile: bool) -> None:
    """Phase 7: the irregular point paths on a fresh TSDB."""
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.ops.blocked import pick_block_buckets
    from opentsdb_tpu_torch.ops.pipeline import run_prepared
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    tsdb = TSDB(Config(**{"tsd.torch.device": "cuda",
                          "tsd.core.auto_create_metrics": "true",
                          "tsd.query.cache.enable": "false",
                          **HOST_TAIL_OFF}))
    tags, ts2d, values2d, counts = make_irregular(n_series)
    check(bool(np.nanmin(values2d) > 0), "phase 7 data holds a value <= 0")
    t = time.perf_counter()
    tsdb.add_series_points(METRIC, tags, ts2d, values2d, counts)
    n_points = int(counts.sum())
    print(f"  ingest: {n_points} points ({DROP:.0%} of "
          f"{n_series * POINTS} dropped, jitter 0-{JITTER_S - 1} s) in "
          f"{time.perf_counter() - t:.3f} s")
    del tags, ts2d, values2d
    store = tsdb.store
    metric_id = tsdb.uids.metrics.get_id(METRIC)
    sids = store.series_ids_for_metric(metric_id)
    start, end = str(T0), str(T0 + POINTS * 60 - 1)
    cache = tsdb.device_grid_cache
    check(cache is not None, "the device cache is off")

    def query(m, tz):
        return TSQuery(start=start, end=end, timezone=tz,
                       queries=[parse_uri_subquery(m)]).validate()

    reset_launches(fused)
    for m, tz, layout in IRREGULAR_QUERIES:
        torch.cuda.synchronize()
        tsdb.drop_caches()
        torch.cuda.reset_peak_memory_stats()
        reset_blocked()
        cold, cold_s = timed(lambda: tsdb.execute_query(query(m, tz)), 1)
        peak = torch.cuda.max_memory_allocated()
        # an S x B over the cell budget (the union grid at full width)
        # streams in time blocks and makes no prepared batch: its warm
        # calls run it again, once, and each staged stage runs once
        runs, blocks = read_blocked()
        hits = cache.hits
        repeats = 1 if runs else IRREGULAR_REPEATS
        warm, warm_s = timed(lambda: tsdb.execute_query(query(m, tz)),
                             repeats)
        check(cache.hits == hits + (0 if runs else repeats),
              f"{m}: warm calls made {cache.hits - hits} cache hits")
        check(read_blocked() == (runs * (1 + repeats),
                                 blocks * (1 + repeats)),
              f"{m}: the warm calls left the cold call's path")
        check(same_bits(warm, cold),
              f"{m}: a warm call differs from its cold call")
        tsdb.drop_caches()
        check(same_bits(tsdb.execute_query(query(m, tz)), cold),
              f"{m}: two cold calls differ in their bits")
        if profile:
            tsdb.drop_caches()
            device_share(torch, lambda: tsdb.execute_query(query(m, tz)),
                         f"{m} cold")
            device_share(torch, lambda: tsdb.execute_query(query(m, tz)),
                         f"{m} warm")

        # the stages, one by one
        tq = query(m, tz)
        sub = tq.queries[0]
        eng = tsdb.new_query()
        gb = [tsdb.uids.tag_names.get_id(f.tagk) for f in sub.filters
              if f.group_by]

        def plan():
            sel, tag_mat = eng._apply_filters(metric_id, sub, sids)
            return (sel, tag_mat) + eng._group_ids(tag_mat, gb)

        (sel, tag_mat, gids, g), plan_t = timed(plan, repeats)
        points, mat_t = timed(lambda: eng._materialize_points(
            store, sel, tq), repeats)
        grid, grid_t = timed(lambda: eng._time_grid(sub, tq, points),
                             repeats)
        spec = eng._point_spec(sub, len(sel), g, False, grid.bucket_ts,
                               grid.ds_function, grid.fill_policy,
                               grid.fill_value, grid.complete)
        b = len(grid.bucket_ts)
        bb = pick_block_buckets(len(sel), b, eng._budget)
        check(bool(runs) == (len(sel) * b > eng._budget)
              and blocks == runs * -(-b // bb),
              f"{m}: {runs} blocked runs of {blocks} blocks at S x B = "
              f"{len(sel) * b}, budget {eng._budget}")
        # the staged run takes the unblocked point path
        torch.cuda.reset_peak_memory_stats()
        prep, up_t = timed(lambda: eng._prepare_points(grid, spec),
                           repeats)
        # (a cut of the series can fit the union grid in the padded
        # layout's budget)
        check(prep.kind == layout or n_series < 1_000_000,
              f"{m}: the {prep.kind} layout, not {layout}")
        (res, emit), dev_t = timed(lambda: run_prepared(
            prep, grid.bucket_ts, gids, spec, sub.rate_options),
            repeats)
        staged_peak = torch.cuda.max_memory_allocated()
        check(res.is_cuda and emit.is_cuda, "results are not on cuda")
        res_np, emit_np = res.cpu().numpy(), emit.cpu().numpy()
        rows, asm_t = timed(lambda: eng._build_results(
            tq, sub, metric_id, sel, tag_mat, gids, g, grid.bucket_ts,
            res_np, emit_np), repeats)
        check(same_bits(rows, cold), f"{m}: the staged run differs from "
              "the engine's")
        if runs:
            check(peak < staged_peak, f"{m}: the blocked run's peak is "
                  "not below the unblocked run's")
            print(f"  {m}: blocked ({runs} run of {blocks} blocks of "
                  f"{bb} buckets) peak device memory "
                  f"{peak / 2**30:.3f} GiB; the staged unblocked run "
                  f"{staged_peak / 2**30:.3f} GiB (35.284 GiB when the "
                  "default keys ran it unblocked on an H100 80GB HBM3); "
                  "equal bit for bit")

        # the float64 reference on the CPU: a tenth of the groups
        held = max(1, g // CPU64_SHARE)
        err, cpu_s = against_cpu64(torch, m, grid, spec, gids,
                                   sub.rate_options, res_np, emit_np,
                                   held)
        emitted = int(emit_np.sum())
        check(len(rows) == g and emitted > 0 and bool(np.isfinite(
            res_np[emit_np]).all()), f"{m}: {len(rows)} groups of {g}, "
              "or no finite value emitted")
        stages = (("plan", plan_t), ("materialize", mat_t),
                  ("assign", grid_t), ("upload", up_t),
                  ("device", dev_t), ("assemble", asm_t))
        print(f"  {m}: S={len(sel)} B={b} G={g} {prep.kind} layout, "
              f"{emitted} cells emitted; p50 ms: " + ", ".join(
                  f"{n} {p50(v) * 1e3:.3f}" for n, v in stages)
              + f"; sum {sum(p50(v) for _, v in stages) * 1e3:.3f}")
        print(f"  {m}: end-to-end cold {cold_s[0] * 1e3:.3f} ms, warm "
              f"p50 {p50(warm_s) * 1e3:.3f} ms; peak device memory "
              f"{peak / 2**30:.3f} GiB (cold call); max_abs_err vs CPU "
              f"float64 {err:.6g} over groups 0-{held - 1} of {g} "
              f"({cpu_s:.1f} s on the CPU); two cold "
              "calls and the warm calls equal bit for bit")
        del points, grid, prep, res, emit
    launches = read_launches(fused)
    print(f"  irregular-path launches: {launches}")
    check(not any(launches.values()),
          "an irregular query launched a fused kernel")
    tsdb.shutdown()


BACKEND_REPEATS = 3        # phase 9: calls per p50 reading
IMPORT_SERIES, IMPORT_STEPS = 200, 1000  # phase 9 (e): 200k import lines


def _stats_run(tsdb, tq):
    """One query through the engine with a ``QueryStats``: (rows, wall
    seconds, the engine's stage times in ms by stat name)."""
    from opentsdb_tpu_torch.stats.stats import QueryStats
    stats = QueryStats(query=tq)
    t = time.perf_counter()
    rows = tsdb.new_query().run(tq, stats)
    secs = time.perf_counter() - t
    stats.mark_complete()
    return rows, secs, dict(stats.stats)


def _stage_line(secs: list, stats: list) -> str:
    """The p50 of each of the engine's stages and of the whole call:
    plan (filters and tag matrix), scan (the store's read: materialize
    or bucket_reduce), compute (the device pipeline and its download)
    and the rest (time grid, prepare, upload, assembly)."""
    names = (("plan", "stringToUidTime"), ("scan", "materializeTime"),
             ("compute", "computeTime"))
    cols = {n: [st.get(k, 0.0) for st in stats] for n, k in names}
    cols["rest"] = [sec * 1e3 - sum(st.get(k, 0.0) for _, k in names)
                    for sec, st in zip(secs, stats)]
    return ", ".join(f"{n} {p50(v):.3f}" for n, v in cols.items()) \
        + f"; end-to-end {p50(secs) * 1e3:.3f}"


def phase_backends(torch, n_series: int, query) -> dict:
    """Phase 9: the storage backends A/B on config 3's data, one fresh
    TSDB each. Returns the kernel launches of its point-path queries."""
    import gc
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.tsd.telnet import TelnetRouter
    t_phase = time.perf_counter()
    tags, ts2d, values = make_data(n_series)
    refs = config3_reference(values)
    n_points = n_series * POINTS
    start_ms, end_ms = T0 * 1000, (T0 + POINTS * 60 - 1) * 1000
    defaults = engine_defaults()
    grid_keys = {k: defaults.get_string(k) for k in ENGINE_KEYS}
    grid_keys["tsd.query.cache.enable"] = "false"
    imports = [f"{T0 + 60 * j} {(i * 5 + j) % 100_000} host=m{i}"
               for j in range(IMPORT_STEPS) for i in range(IMPORT_SERIES)]
    buf = "".join(f"sys.imp {x}\n" for x in imports).encode()
    puts = [f"put sys.tel {x}" for x in imports]
    launches = {"span_reduce": 0, "onehot_reduce": 0}
    out: dict = {}
    for backend in ("native", "memory"):
        tsdb = TSDB(Config(**{"tsd.torch.device": "cuda",
                              "tsd.core.auto_create_metrics": "true",
                              "tsd.storage.backend": backend,
                              **ENGINE_KEYS}))
        check(tsdb.store.backend == backend, f"not a {backend} store")
        store, res = tsdb.store, {}
        out[backend] = res
        # (a) ingest
        t = time.perf_counter()
        tsdb.add_series_points(METRIC, tags, ts2d, values)
        ingest_s = time.perf_counter() - t
        READINGS[f"{backend}_ingest_s"] = ingest_s
        sids = store.series_ids_for_metric(tsdb.uids.metrics.get_id(METRIC))
        # (b) the store's reads over every series
        t = time.perf_counter()
        counts = store.count_range(sids, start_ms, end_ms)
        first_s = time.perf_counter() - t
        check(len(sids) == n_series and bool((counts == POINTS).all()),
              f"{backend}: the store holds the wrong points")
        reads = {
            "count_range": lambda: store.count_range(sids, start_ms,
                                                     end_ms),
            "materialize": lambda: store.materialize(sids, start_ms,
                                                     end_ms),
            "materialize_padded": lambda: store.materialize_padded(
                sids, start_ms, end_ms),
            "bucket_reduce 5m": lambda: store.bucket_reduce(
                sids, start_ms, end_ms, start_ms, 300_000, POINTS // 5)}
        read_s = {}
        for name, fn in reads.items():
            secs = []
            for _ in range(BACKEND_REPEATS):
                t = time.perf_counter()
                res[name] = fn()
                secs.append(time.perf_counter() - t)
            read_s[name] = p50(secs)
        print(f"  {backend} (a) ingest: {ingest_s:.3f} s "
              f"({n_points / ingest_s:,.0f} points/s, add_series_points); "
              f"first read after it (count_range) {first_s * 1e3:.3f} ms")
        print(f"  {backend} (b) store reads over {n_series} series, p50 of "
              f"{BACKEND_REPEATS} in ms: " + ", ".join(
                  f"{n} {v * 1e3:.3f}" for n, v in read_s.items()))
        # (c) both queries on the point path and, cold, on the grid path
        for path, keys in (("point", ENGINE_KEYS), ("grid", grid_keys)):
            for key, val in keys.items():
                tsdb.config.override_config(key, val)
            for m, kname in QUERIES:
                secs, stats = [], []
                reset_launches(fused)
                for i in range(BACKEND_REPEATS + (path == "point")):
                    tsdb.drop_caches()
                    rows, sec, st = _stats_run(tsdb, query(m))
                    if path == "grid" or i > 0:   # the point path warms up
                        secs.append(sec)
                        stats.append(st)
                n = read_launches(fused)
                if path == "point":
                    check(n[kname] > 0, f"{backend}: {m} launched no "
                          f"{kname} on the point path")
                    for k in launches:
                        launches[k] += n[k]
                else:
                    check(not any(n.values()),
                          f"{backend}: the grid path launched {n}")
                err = held_to_reference(rows, refs[m])
                res[path, m] = rows
                print(f"  {backend} (c) {m} {path} path, p50 of "
                      f"{len(secs)} in ms: {_stage_line(secs, stats)}; "
                      f"launches {n}; max |d| vs the float64 reference "
                      f"{err!r}")
        # (d) one out-of-order write, then the cold point-path query
        for key, val in ENGINE_KEYS.items():
            tsdb.config.override_config(key, val)
        tsdb.add_point(METRIC, T0 + 600, 1000.0, tags[0])
        m = QUERIES[0][0]
        res["rewrite"], sec, st = _stats_run(tsdb, query(m))
        print(f"  {backend} (d) series 0 rewritten at T0+600 s (before "
              f"its last point), then {m} on the point path: "
              f"{sec * 1e3:.3f} ms (scan {st['materializeTime']:.3f} ms)")
        # (e) a burst of import lines: TSDB.import_buffer on the native
        # store, and the telnet burst path of each store
        if backend == "native":
            t = time.perf_counter()
            written, errors = tsdb.import_buffer(buf)
            imp_s = time.perf_counter() - t
            check(written == len(imports) and not errors,
                  f"import_buffer wrote {written}: {errors[:3]}")
            said = (f"import_buffer {len(imports)} lines {imp_s:.3f} s "
                    f"({len(imports) / imp_s:,.0f} lines/s); ")
        else:
            said = "import_buffer needs the native store; "
        t = time.perf_counter()
        answers = TelnetRouter(tsdb).put_lines(puts)
        tel_s = time.perf_counter() - t
        check(not answers, f"telnet puts answered {answers[:3]}")
        for metric in ("sys.tel", "sys.imp")[:2 if backend == "native"
                                             else 1]:
            got = store.count_range(store.series_ids_for_metric(
                tsdb.uids.metrics.get_id(metric)), 0, 2**62)
            check(len(got) == IMPORT_SERIES
                  and bool((got == IMPORT_STEPS).all()),
                  f"{backend}: {metric} read back wrong")
        print(f"  {backend} (e) {said}telnet put_lines of the same "
              f"{len(puts)} lines {tel_s:.3f} s ({len(puts) / tel_s:,.0f} "
              "lines/s); every point read back")
        tsdb.shutdown()
        del tsdb, store
        gc.collect()
        if backend == "memory":
            nat = out["native"]
            for name in ("materialize", "materialize_padded"):
                for a, b in zip(res[name], nat[name]):
                    check(a.dtype == b.dtype and np.array_equal(
                        a.view(np.int64) if a.dtype == np.float64 else a,
                        b.view(np.int64) if b.dtype == np.float64 else b),
                        f"{name}: the backends differ")
            red = "bucket_reduce 5m"
            (sm, cm, _, _), (sn, cn, _, _) = res[red], nat[red]
            check(np.array_equal(cm, cn), "bucket_reduce counts differ")
            rel = float((np.abs(sm - sn)
                         / np.where(sn == 0, 1.0, np.abs(sn))).max())
            check(rel <= 1e-12, f"bucket_reduce sums differ by {rel!r}")
            for m, _ in QUERIES:
                check(same_bits(res["point", m], nat["point", m]),
                      f"{m}: the backends' point-path answers differ")
            grid_d = max(float(np.abs(
                np.stack([r.dps_arrays[1] for r in res["grid", m]])
                - np.stack([r.dps_arrays[1] for r in nat["grid", m]])
            ).max()) for m, _ in QUERIES)
            check(same_bits(res["rewrite"], nat["rewrite"]),
                  "the answers after the rewrite differ")
            print("  backends: materialize and materialize_padded equal "
                  f"bit for bit; bucket_reduce counts equal, sums within "
                  f"{rel!r} relative; point-path answers equal bit for "
                  f"bit (also after the rewrite); grid-path answers "
                  f"within {grid_d!r} of each other")
    print(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")
    return launches


DURABLE_MIN_FREE = 8 << 30    # phase 10: bytes the data dirs need free
WRITER_TIMEOUT_S = 600        # phase 10: a writer's wait for its ack
# phase 10's writer: a child process on a data_dir that writes, prints
# "acked" once every write is acknowledged, and waits to be killed
WRITER = """
import json, sys, time
root, mode, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
import chip_smoke
from opentsdb_tpu_torch import TSDB, Config
t = TSDB(Config(**json.loads(sys.argv[4])))
tags, ts2d, values = chip_smoke.make_data(n)
if mode == "config3":
    t.add_series_points(chip_smoke.METRIC, tags, ts2d, values)
    print("acked", n * chip_smoke.POINTS, flush=True)
else:
    t.add_point(chip_smoke.METRIC, chip_smoke.T0 + 600, 1000.0, tags[0])
    print("acked 1", flush=True)
time.sleep(3600)
"""


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def filesystem(path: Path) -> str:
    """The type and mount point of the filesystem holding ``path``."""
    path, mount, fstype = str(path.resolve()) + "/", "/", "?"
    for line in Path("/proc/mounts").read_text().splitlines():
        parts = line.split()
        if len(parts) > 2 and path.startswith(parts[1].rstrip("/") + "/") \
                and len(parts[1]) >= len(mount):
            mount, fstype = parts[1], parts[2]
    return f"{fstype} mounted on {mount}"


def kill_writer(mode: str, n: int, keys: dict, log: Path) -> float:
    """Run WRITER in ``mode`` as a child process, wait for its
    acknowledgement, then SIGKILL it (no flush, no shutdown). Returns
    the seconds from its start to the acknowledgement."""
    import signal
    t = time.perf_counter()
    got: list = []
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", WRITER, str(ROOT), mode, str(n),
             json.dumps(keys)], stdout=subprocess.PIPE, stderr=err,
            cwd=ROOT)
        try:
            reader = threading.Thread(target=lambda: got.append(
                proc.stdout.readline().decode()), daemon=True)
            reader.start()
            reader.join(WRITER_TIMEOUT_S)
            acked_s = time.perf_counter() - t
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            proc.stdout.close()
    line = got[0] if got else ""
    check(line.startswith("acked"), f"the {mode} writer died before its "
          f"acknowledgement: {log.read_text()[-2000:]}")
    check(proc.returncode == -signal.SIGKILL,
          f"the writer ended with {proc.returncode}, not by SIGKILL")
    return acked_s


def phase_durability(torch, n_series: int, query) -> dict:
    """Phase 10: durability at config 3 with tsd.storage.data_dir (the
    WAL at fsync=always, snapshots) on the native store, on the point
    path with the result cache off. Returns the kernel launches of its
    queries."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.tsd.server import ServerThread
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="tsd-durability-"))
    free = shutil.disk_usage(root).free
    print(f"  data dirs under {root}: {filesystem(root)}, {free} bytes "
          "free")
    check(free >= DURABLE_MIN_FREE,
          f"{free} bytes free, fewer than {DURABLE_MIN_FREE}")
    base = {"tsd.torch.device": "cuda",
            "tsd.core.auto_create_metrics": "true",
            "tsd.storage.wal.fsync": "always", **ENGINE_KEYS}

    def keys(d: Path) -> dict:
        return {**base, "tsd.storage.data_dir": str(d)}

    launches = {"span_reduce": 0, "onehot_reduce": 0}
    n_points = n_series * POINTS
    open_dbs: list = []

    def durable(d: Path):
        t = TSDB(Config(**keys(d)))
        open_dbs.append(t)
        return t

    def crash(t) -> None:
        """Drop a TSDB without a flush: its log closes as a kill's
        would leave it."""
        t.wal.close()
        open_dbs.remove(t)

    def one_query(t, m: str, kname: str, what: str):
        """Run ``m`` on ``t``; it must launch ``kname`` once and the
        other kernel never."""
        other = next(k for _, k in QUERIES if k != kname)
        reset_launches(fused)
        tq = time.perf_counter()
        rows = t.execute_query(query(m))
        secs = time.perf_counter() - tq
        n = read_launches(fused)
        check(n == {kname: 1, other: 0},
              f"{what}: {m} launched {n}, not one {kname}")
        launches[kname] += 1
        print(f"  {what}: {m} {secs * 1e3:.3f} ms, one {kname} launch")
        return rows

    def run_queries(t, what: str) -> dict:
        return {m: one_query(t, m, kname, what) for m, kname in QUERIES}

    try:
        tags, ts2d, values = make_data(n_series)
        # (a) ingest with the WAL on; this TSDB never dies
        ref = durable(root / "a")
        t = time.perf_counter()
        ref.add_series_points(METRIC, tags, ts2d, values)
        ingest_s = time.perf_counter() - t
        w = ref.wal
        no_wal = READINGS.get("native_ingest_s")
        print(f"  (a) ingest with the WAL: {ingest_s:.3f} s "
              f"({n_points / ingest_s:,.0f} points/s, add_series_points, "
              f"fsync=always); WAL {dir_bytes(root / 'a' / 'wal')} bytes, "
              f"{w.last_seq()} records, {w.group_syncs} fsyncs; "
              + (f"{ingest_s / no_wal:.3f}x phase 9's native ingest "
                 f"without a WAL ({no_wal:.3f} s)" if no_wal else
                 "phase 9's ingest not measured"))
        before = run_queries(ref, "(a) never died")
        refs = config3_reference(values)
        for m, _ in QUERIES:
            held_to_reference(before[m], refs[m])

        # (b) /api/put with the WAL on
        put_db = durable(root / "b")
        st = serve_pinned(ServerThread, put_db)
        try:
            put_s = put_points(st.port, "sys.wal.put")
            syncs = put_db.wal.group_syncs
            got = put_db.store.count_range(put_db.store.series_ids_for_metric(
                put_db.uids.metrics.get_id("sys.wal.put")), 0, 2**62)
        finally:
            st.stop()        # shuts the TSDB down: a flush
            open_dbs.remove(put_db)
        n_put, n_bodies = PUT_SERIES * PUT_STEPS, \
            PUT_SERIES * PUT_STEPS // (PUT_BODY_SERIES * PUT_BODY_STEPS)
        check(len(got) == PUT_SERIES and int(got.sum()) == n_put,
              f"/api/put with the WAL: {int(got.sum())} points read back")
        plain = READINGS.get("put_points_per_s")
        print(f"  (b) /api/put with the WAL: {n_put} points in {n_bodies} "
              f"bodies over {PUT_CONNS} connections, {put_s:.3f} s "
              f"({n_put / put_s:,.0f} points/s"
              + (f", {n_put / put_s / plain:.3f}x phase 8's "
                 f"{plain:,.0f} without a WAL" if plain else "")
              + f"); {syncs} fsyncs, {syncs / n_bodies:.3f} per body; "
              "every point read back")
        del put_db
        shutil.rmtree(root / "b")

        # (c) a child writes config 3 with the WAL, is killed, recovers
        acked_s = kill_writer("config3", n_series, keys(root / "c"),
                              root / "writer-c.log")
        print(f"  (c) writer process acknowledged {n_points} points after "
              f"{acked_s:.3f} s, then SIGKILL (no flush); WAL "
              f"{dir_bytes(root / 'c' / 'wal')} bytes")
        t = time.perf_counter()
        rec = durable(root / "c")
        rec_s = time.perf_counter() - t
        r = rec.recovery
        sids = rec.store.series_ids_for_metric(rec.uids.metrics.get_id(
            METRIC))
        got = int(rec.store.count_range(sids, 0, 2**62).sum())
        print(f"  (c) time to recover: {rec_s:.3f} s (snapshot load "
              f"{r['load_s']:.3f} s, WAL replay {r['replay_s']:.3f} s, "
              f"{r['points_replayed']} points replayed); {got} points "
              f"read back in {len(sids)} series")
        check(got == n_points and len(sids) == n_series,
              f"recovered {got} points in {len(sids)} series, not "
              f"{n_points} in {n_series}")
        after = run_queries(rec, "(c) recovered")
        for m, _ in QUERIES:
            check(same_bits(after[m], before[m]),
                  f"{m}: the recovered answer differs from the one that "
                  "never died")
        print("  (c) both answers equal the never-killed TSDB's bit for "
              "bit")

        # (d) snapshot, restart from it alone, then one more point
        segs = len(list((root / "c" / "wal").glob("wal-*.log")))
        t = time.perf_counter()
        rec.flush()
        flush_s = time.perf_counter() - t
        left = len(list((root / "c" / "wal").glob("wal-*.log")))
        snap = dir_bytes(root / "c") - dir_bytes(root / "c" / "wal")
        print(f"  (d) flush: {flush_s:.3f} s, snapshot {snap} bytes "
              f"(points.npz {(root / 'c/data/points.npz').stat().st_size}),"
              f" {segs - left} of {segs} WAL segments truncated")
        crash(rec)
        del rec
        gc.collect()
        t = time.perf_counter()
        snap_db = durable(root / "c")
        open_s = time.perf_counter() - t
        check(snap_db.recovery["points_replayed"] == 0,
              "the restart after the flush replayed points")
        print(f"  (d) restart from the snapshot alone: {open_s:.3f} s "
              f"(load {snap_db.recovery['load_s']:.3f} s)")
        reload = run_queries(snap_db, "(d) snapshot")
        for m, _ in QUERIES:
            check(same_bits(reload[m], before[m]),
                  f"{m}: the answer after the snapshot reload differs")
        crash(snap_db)
        del snap_db
        gc.collect()
        acked_s = kill_writer("point", 1, keys(root / "c"),
                              root / "writer-d.log")
        t = time.perf_counter()
        tail = durable(root / "c")
        tail_s = time.perf_counter() - t
        check(tail.recovery["points_replayed"] == 1,
              f"replayed {tail.recovery['points_replayed']} points, not 1")
        ts0, v0, _ = tail.store.series_points(0)
        at = np.flatnonzero(ts0 == (T0 + 600) * 1000)
        check(len(at) == 1 and v0[at[0]] == 1000.0 and len(ts0) == POINTS,
              "the point written after the flush was not read back")
        m, kname = QUERIES[0]
        rows = one_query(tail, m, kname, "(d) snapshot plus tail")
        ref.add_point(METRIC, T0 + 600, 1000.0, tags[0])
        check(same_bits(rows, one_query(ref, m, kname,
                                        "(d) never died, same write")),
              f"{m}: the rewritten answer differs from the never-killed "
              "TSDB's after the same write")
        check(not same_bits(rows, before[m]), "the rewrite changed nothing")
        print(f"  (d) one out-of-order point on series 0 by a writer "
              f"process (acknowledged after {acked_s:.3f} s), SIGKILL, "
              f"restart {tail_s:.3f} s (load "
              f"{tail.recovery['load_s']:.3f} s, replay "
              f"{tail.recovery['replay_s']:.3f} s): the point read back, "
              f"and {m} equals the never-killed TSDB's after the same "
              "write bit for bit")
    finally:
        for t in open_dbs:
            t.wal.close()
        open_dbs.clear()
        shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 10: {time.perf_counter() - t_phase:.1f} s")
    return launches


LONG_POINTS = 120          # phase 11: two hours at one point a minute
LONG_QUERIES = (
    ("sum:1m-avg:rate:sys.cpu.user{dc=*}", "the rate carry"),
    ("avg:1m-avg:sys.cpu.user{rack=*}", "LERP's prev and next carries"))
UNBLOCKED_CELLS = "268435456"   # phase 11: a budget past S x B


def make_long(n_series: int):
    """Config 3's series over two hours: slot j of series i is at
    ``T0 + 60 j``, dropped with probability DROP; values
    ``normal(100, 15)``; seed 0. Returns (tags, ts2d, values2d,
    counts), each row's points packed left."""
    import numpy as np
    rng = np.random.default_rng(0)
    tags = [{"host": f"h{i}", "dc": f"dc{i % 100}",
             "rack": f"r{i % 2000}"} for i in range(n_series)]
    shape = (n_series, LONG_POINTS)
    values = rng.normal(100.0, 15.0, shape)
    keep = rng.random(shape) >= DROP
    order = np.argsort(~keep, axis=1, kind="stable")
    counts = keep.sum(axis=1)
    ts2d = np.broadcast_to(T0 + 60 * np.arange(LONG_POINTS, dtype=np.int64),
                           shape)
    ts2d = np.take_along_axis(ts2d, order, axis=1)
    values2d = np.take_along_axis(values, order, axis=1)
    pad = np.arange(LONG_POINTS)[None, :] >= counts[:, None]
    ts2d[pad], values2d[pad] = 0, np.nan
    return tags, ts2d, values2d, counts


def phase_long(torch, n_series: int, profile: bool) -> None:
    """Phase 11: long ranges streamed in time blocks on a fresh TSDB."""
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.ops.blocked import pick_block_buckets
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    t_phase = time.perf_counter()
    tsdb = TSDB(Config(**{"tsd.torch.device": "cuda",
                          "tsd.core.auto_create_metrics": "true",
                          "tsd.query.cache.enable": "false",
                          **HOST_TAIL_OFF}))
    tags, ts2d, values2d, counts = make_long(n_series)
    check(bool(np.nanmin(values2d) > 0), "phase 11 data holds a value <= 0")
    t = time.perf_counter()
    tsdb.add_series_points(METRIC, tags, ts2d, values2d, counts)
    n_points = int(counts.sum())
    print(f"  ingest: {n_points} points ({DROP:.0%} of "
          f"{n_series * LONG_POINTS} dropped, no jitter) in "
          f"{time.perf_counter() - t:.3f} s")
    del tags, ts2d, values2d, counts
    store = tsdb.store
    metric_id = tsdb.uids.metrics.get_id(METRIC)
    sids = store.series_ids_for_metric(metric_id)
    start, end = str(T0), str(T0 + LONG_POINTS * 60 - 1)
    keys = tsdb.config

    def query(m):
        return TSQuery(start=start, end=end,
                       queries=[parse_uri_subquery(m)]).validate()

    def cold(m):
        tsdb.drop_caches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows, secs = timed(lambda: tsdb.execute_query(query(m)), 1)
        return rows, secs[0], torch.cuda.max_memory_allocated()

    for m, carry in LONG_QUERIES:
        reset_blocked()
        reset_launches(fused)
        rows, cold_s, peak = cold(m)
        runs, blocks = read_blocked()
        launches = read_launches(fused)
        # the same query unblocked: the budget raised past S x B, and
        # the grid path off (it would add in another order)
        keys.override_config("tsd.query.max_device_cells", UNBLOCKED_CELLS)
        keys.override_config("tsd.query.grid_reduce", "false")
        whole, whole_s, whole_peak = cold(m)
        keys.override_config("tsd.query.max_device_cells", "0")
        keys.override_config("tsd.query.grid_reduce", "true")
        tsdb.drop_caches()
        check(read_blocked() == (runs, blocks),
              f"{m}: the unblocked run streamed in blocks")
        check(same_bits(whole, rows), f"{m}: blocked and unblocked runs "
              "differ in their bits")
        if profile:
            tsdb.drop_caches()
            device_share(torch, lambda: tsdb.execute_query(query(m)),
                         f"{m} blocked cold")

        # the stages, one by one
        tq = query(m)
        sub = tq.queries[0]
        eng = tsdb.new_query()
        gb = [tsdb.uids.tag_names.get_id(f.tagk) for f in sub.filters
              if f.group_by]
        (sel, tag_mat), plan_t = timed(
            lambda: eng._apply_filters(metric_id, sub, sids), 1)
        gids, g = eng._group_ids(tag_mat, gb)
        points, mat_t = timed(lambda: eng._materialize_points(
            store, sel, tq), 1)
        grid, grid_t = timed(lambda: eng._time_grid(sub, tq, points), 1)
        b = len(grid.bucket_ts)
        bb = pick_block_buckets(len(sel), b, eng._budget)
        spec = eng._point_spec(sub, len(sel), g, False, grid.bucket_ts,
                               grid.ds_function, grid.fill_policy,
                               grid.fill_value, grid.complete)
        stages: dict = {}
        (res_np, emit_np), run_t = timed(lambda: eng._run_blocked(
            grid, gids, spec, sub.rate_options, stages), 1)
        rows3, asm_t = timed(lambda: eng._build_results(
            tq, sub, metric_id, sel, tag_mat, gids, g, grid.bucket_ts,
            res_np, emit_np), 1)
        # the staged run is the second blocked run of the query: the
        # two must give the same bits
        check(same_bits(rows3, rows), f"{m}: the staged run differs from "
              "the engine's")
        check(runs == 1 and blocks == -(-b // bb) == 2
              and len(sel) * b > eng._budget
              or n_series < 1_000_000 and runs == blocks == 0,
              f"{m}: {runs} blocked runs of {blocks} blocks at S x B = "
              f"{len(sel) * b}, budget {eng._budget}")
        check(not any(launches.values()), f"{m}: launched {launches}")
        check(peak < whole_peak or not runs, f"{m}: the blocked peak "
              f"{peak} is not below the unblocked {whole_peak}")
        # the float64 reference on the CPU: a tenth of the groups, as in
        # phase 7 (CUT from all of them: 76 s of a 931 s run on one H100)
        err, cpu_s = against_cpu64(torch, m, grid, spec, gids,
                                   sub.rate_options, res_np, emit_np,
                                   max(1, g // CPU64_SHARE))
        emitted = int(emit_np.sum())
        check(len(rows) == g and emitted > 0 and bool(np.isfinite(
            res_np[emit_np]).all()), f"{m}: {len(rows)} groups of {g}, "
              "or no finite value emitted")
        flatten = run_t[0] - sum(stages.values())
        staged = (("plan", plan_t[0]), ("materialize", mat_t[0]),
                  ("assign", grid_t[0]), ("flatten", flatten),
                  ("host split", stages["split"]),
                  ("pass 1", stages["pass1"]),
                  ("pass 2", stages["pass2"]), ("assemble", asm_t[0]))
        print(f"  {m} ({carry}): S={len(sel)} B={b} G={g}, {runs} blocked "
              f"run of {blocks} blocks of {bb} buckets (budget "
              f"{eng._budget} cells), {emitted} cells emitted; no kernel "
              "launched")
        print(f"  {m}: stages ms: " + ", ".join(
            f"{n} {v * 1e3:.3f}" for n, v in staged)
            + f"; sum {sum(v for _, v in staged) * 1e3:.3f}")
        print(f"  {m}: end-to-end cold {cold_s * 1e3:.3f} ms blocked, "
              f"{whole_s * 1e3:.3f} ms unblocked; peak device memory "
              f"{peak / 2**30:.3f} GiB blocked, {whole_peak / 2**30:.3f} "
              "GiB unblocked; blocked equal to unblocked and to its staged "
              "run bit for bit; max_abs_err "
              f"vs CPU float64 {err:.6g} ({cpu_s:.1f} s on the CPU)")
        del points, grid, res_np, emit_np, rows, rows3, whole
    tsdb.shutdown()
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")


# phase 12: BASELINE config 4, histograms and percentile sub-queries
HIST_METRIC = "sys.lat.hist"
HIST_BUCKETS = 64
# per series, a minute apart: config 4's depth, cut from 2 so that the
# phase fits its 150 s (the per-series write path took 141 s for 2M
# points on the card's host)
HIST_POINTS = 1
# phase 12 holds a quarter of config 4's 1M series: at 1M its ingest
# took 116 s of a 1133 s run on one H100, past the run's 900 s
HIST_CUT = 4
HIST_BATCH = 25_000        # points per add_histogram_batch (bench_e2e.py)
HIST_QS = (99.0, 99.9)
HIST_WINDOW = (T0, T0 + 299)         # one 5-minute bucket
SKETCH_SERIES, SKETCH_POINTS = 10_000, 60   # (d)
HIST_FE_SERIES = 10_000 // HIST_POINTS   # (e): 10k points by /api/histogram
HIST_FE_BODY = 1000        # points per /api/histogram body


def hist_percentiles(merged, bounds, qs):
    """[Q, S] percentiles of float64 merged counts [S, NB] in numpy: the
    reference's ``percentiles_from_counts``, written out here."""
    import numpy as np
    totals = merged.sum(axis=1)
    cum = np.cumsum(merged, axis=1)
    mids = (bounds[:-1] + bounds[1:]) / 2.0
    out = np.empty((len(qs), len(merged)))
    for qi, q in enumerate(qs):
        idx = np.sum(cum < (totals * (q / 100.0))[:, None], axis=1)
        out[qi] = np.where(totals > 0,
                           mids[np.clip(idx, 0, len(mids) - 1)], 0.0)
    return out


def hist_blobs(counts_be, prefix: bytes) -> list:
    """One codec blob per row of big-endian u64 counts (no under or
    overflow)."""
    tail = bytes(16)
    return [prefix + row.tobytes() + tail for row in counts_be]


def hist_rows(rows, metric: str) -> dict:
    """{(q, dc tag or None): (timestamps, values)} of an answer."""
    import numpy as np
    out = {}
    for r in rows:
        check(r.metric.startswith(f"{metric}_pct_"),
              f"unexpected row {r.metric}")
        q = float(r.metric.rsplit("_", 1)[1])
        ts, vals = r.dps_arrays
        out[(q, r.tags.get("dc"))] = (np.asarray(ts).tolist(),
                                      np.asarray(vals, dtype=np.float64))
    return out


def rows_bits(rows) -> list:
    import numpy as np
    return [(r.metric, r.tags, sorted(r.aggregated_tags),
             np.asarray(r.dps_arrays[0]).tolist(),
             np.asarray(r.dps_arrays[1]).view(np.int64).tolist())
            for r in rows]


def phase_histograms(torch, n_series: int, profile: bool) -> dict:
    """Phase 12: BASELINE config 4 (p99/p999 over histogram series, a
    quarter of its 1M) on the card. Returns the ``histogram`` line's
    readings."""
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.ops import histogram_kernels as hk
    from opentsdb_tpu_torch.query import histogram_engine as he
    from opentsdb_tpu_torch.query.model import TSQuery
    t_phase = time.perf_counter()
    keys = {"tsd.torch.device": "cuda",
            "tsd.core.auto_create_metrics": "true",
            "tsd.query.cache.enable": "false", **HOST_TAIL_OFF}

    # (a) data: point j of series i is counts[j, i] (seed 3, point 0
    # drawn as bench_e2e.py draws its one point)
    bounds = np.logspace(0, 4, HIST_BUCKETS + 1)
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 50, (HIST_POINTS, n_series, HIST_BUCKETS))
    counts_be = counts.astype(">u8")
    prefix = (b"\x01" + np.array([HIST_BUCKETS + 1], ">u2").tobytes()
              + bounds.astype(">f8").tobytes())
    tags = [{"host": f"h{i}", "dc": f"dc{i % 100}"} for i in range(n_series)]
    tsdb = TSDB(Config(**keys))
    n_points = HIST_POINTS * n_series
    ingest_s = blob_s = 0.0
    for j in range(HIST_POINTS):
        for lo in range(0, n_series, HIST_BATCH):
            hi = min(lo + HIST_BATCH, n_series)
            t = time.perf_counter()
            blobs = hist_blobs(counts_be[j, lo:hi], prefix)
            batch = [(HIST_METRIC, T0 + 60 * j, b, tags[i])
                     for i, b in zip(range(lo, hi), blobs)]
            t1 = time.perf_counter()
            written, errors = tsdb.add_histogram_batch(batch)
            ingest_s += time.perf_counter() - t1
            blob_s += t1 - t
            check(written == hi - lo and not errors,
                  f"histogram batch wrote {written}: {errors[:3]}")
    print(f"  (a) ingest: {n_points} points of {n_series} series x "
          f"{HIST_POINTS}, {HIST_BUCKETS} buckets, by add_histogram_batch "
          f"in batches of {HIST_BATCH}: {ingest_s:.3f} s "
          f"({n_points / ingest_s:,.0f} points/s; building the blobs "
          f"{blob_s:.3f} s more)")

    # the float64 numpy reference of both queries
    t = time.perf_counter()
    q1_merged = counts.sum(axis=1).astype(np.float64)    # [HIST_POINTS, NB]
    dc = np.arange(n_series) % 100
    q2_merged = np.stack([np.bincount(dc, weights=counts[:, :, b].sum(
        axis=0).astype(np.float64), minlength=100)
        for b in range(HIST_BUCKETS)], axis=1)                  # [100, NB]
    want = {"Q1": hist_percentiles(q1_merged, bounds, HIST_QS),
            "Q2": hist_percentiles(q2_merged, bounds, HIST_QS)}
    big = int((q1_merged > 2 ** 24).sum())
    print(f"  numpy float64 reference: {time.perf_counter() - t:.3f} s; "
          f"Q1's merged buckets past 2^24: {big} of {q1_merged.size}; "
          f"merged totals {q1_merged.sum(axis=1).astype(np.int64).tolist()}")

    def tsq(ds: str | None, group: bool):
        sub = {"aggregator": "sum", "metric": HIST_METRIC,
               "percentiles": list(HIST_QS)}
        if ds:
            sub["downsample"] = ds
        if group:
            sub["filters"] = [{"type": "wildcard", "tagk": "dc",
                               "filter": "*", "groupBy": True}]
        return TSQuery.from_json({"start": str(HIST_WINDOW[0]),
                                  "end": str(HIST_WINDOW[1]),
                                  "queries": [sub]}).validate()

    queries = {"Q1": tsq(None, False), "Q2": tsq("5m-sum", True)}

    def held(name: str, rows) -> None:
        got = hist_rows(rows, HIST_METRIC)
        w = want[name]
        if name == "Q1":
            check(len(got) == len(HIST_QS), f"Q1: {len(got)} rows")
            for qi, q in enumerate(HIST_QS):
                ts, vals = got[(q, None)]
                check(ts == [(T0 + 60 * j) * 1000
                             for j in range(HIST_POINTS)],
                      f"Q1 timestamps {ts}")
                check(vals.view(np.int64).tolist()
                      == w[qi].view(np.int64).tolist(),
                      f"Q1 p{q}: {vals.tolist()} != {w[qi].tolist()}")
        else:
            check(len(got) == len(HIST_QS) * 100, f"Q2: {len(got)} rows")
            for qi, q in enumerate(HIST_QS):
                for g in range(100):
                    ts, vals = got[(q, f"dc{g}")]
                    check(ts == [T0 * 1000] and vals.view(np.int64)[0]
                          == w[qi, g:g + 1].view(np.int64)[0],
                          f"Q2 p{q} dc{g}: {vals.tolist()} != "
                          f"{w[qi, g]!r}")

    readings = {}
    calls_total = dict.fromkeys(hk.CALLS, 0)
    for name, q in queries.items():
        reset_launches(fused)
        calls0 = dict(hk.CALLS)
        colds, cold_rows = [], []
        for _ in range(2):
            tsdb.drop_caches()
            (rows,), secs = timed(lambda: [tsdb.execute_query(q)], 1)
            colds.append(secs[0])
            cold_rows.append(rows_bits(rows))
        held(name, rows)
        warm_rows, warm_s = timed(lambda: tsdb.execute_query(q), REPEATS)
        n = read_launches(fused)
        calls = {k: hk.CALLS[k] - calls0[k] for k in calls0}
        check(not any(n.values()), f"{name}: a kernel launched {n}")
        check(cold_rows[0] == cold_rows[1] == rows_bits(warm_rows),
              f"{name}: cold and warm calls differ in their bits")
        check(calls == {"merge_histograms": 2 + REPEATS,
                        "percentiles_from_merged": 2 + REPEATS},
              f"{name}: the device functions ran {calls}")
        for k, v in calls.items():
            calls_total[k] += v
        entry = next(e for k, e in tsdb.device_grid_cache._entries.items()
                     if k[0] == "hist")
        check(entry[1][0].is_cuda and entry[1][0].dtype == torch.float64,
              "the cached counts are not float64 on the card")
        readings[name] = {"cold_ms": [c * 1e3 for c in colds],
                          "warm_p50_ms": p50(warm_s) * 1e3}
        print(f"  (b) {name} {q.queries[0].downsample or 'no downsample'}"
              f"{' {dc=*}' if name == 'Q2' else ''}: cold "
              + " / ".join(f"{c * 1e3:.3f}" for c in colds)
              + f" ms, warm p50 {p50(warm_s) * 1e3:.3f} ms over {REPEATS} "
              f"(device-cache hits); {len(rows)} rows bit-equal to the "
              "numpy float64 reference, cold and warm calls the same "
              f"bits; K1/K2 launches {n}; device calls {calls}")
        if profile:
            tsdb.drop_caches()
            device_share(torch, lambda: tsdb.execute_query(q),
                         f"{name} cold")
            device_share(torch, lambda: tsdb.execute_query(q),
                         f"{name} warm")
        hist_stages(torch, tsdb, q, name)

    # (c) the device functions on the card, against a plain read
    counts_dev = entry[1][0]
    n_rows = counts_dev.shape[0]
    meta = entry[2]
    seg, _, ts_out, _ = he.segments(
        queries["Q1"], queries["Q1"].queries[0],
        np.zeros(n_series, dtype=np.int32), 1, meta["point_sidx"],
        meta["point_ts"])
    seg_dev = torch.from_numpy(seg).cuda()
    nseg = len(ts_out)
    mids = torch.from_numpy(hk.bucket_mids(bounds)).cuda()
    merged = hk.merge_histograms(counts_dev, seg_dev, nseg)
    rate = next(r for key, r in _MEM_RATE
                if key in torch.cuda.get_device_name(0))
    merge_ms = cuda_ms(lambda: hk.merge_histograms(counts_dev, seg_dev,
                                                   nseg), 10)
    pct_ms = cuda_ms(lambda: hk.percentiles_from_merged(merged, mids,
                                                        HIST_QS), 10)
    read_ms = cuda_ms(lambda: counts_dev.sum(), 10)
    merge_bytes = counts_dev.numel() * 8 + n_rows * 8 + merged.numel() * 8
    merge_flops = counts_dev.numel()
    merge_bound = max(merge_bytes / rate, merge_flops / F64_PEAK) * 1e3
    pct_bytes = merged.numel() * 8 + mids.numel() * 8 + \
        len(HIST_QS) * nseg * 8
    pct_flops = merged.numel() * (2 + len(HIST_QS))
    pct_bound = max(pct_bytes / rate, pct_flops / F64_PEAK) * 1e3
    hist_line = [
        {"name": "merge_histograms", "route": "torch",
         "source": "opentsdb_tpu_torch/ops/histogram_kernels.py",
         "replaces": "opentsdb_tpu/ops/histogram_kernels.py:24 (XLA)",
         "calls": calls_total["merge_histograms"], "ms": merge_ms,
         "bound_ms": merge_bound,
         "bound_by": "bytes" if merge_bytes / rate >=
         merge_flops / F64_PEAK else "operations",
         "plain_read_ms": read_ms, "rows": n_rows, "segments": nseg},
        {"name": "percentiles_from_merged", "route": "torch",
         "source": "opentsdb_tpu_torch/ops/histogram_kernels.py",
         "replaces": "opentsdb_tpu/ops/histogram_kernels.py:36 (XLA)",
         "calls": calls_total["percentiles_from_merged"], "ms": pct_ms,
         "bound_ms": pct_bound,
         "bound_by": "bytes" if pct_bytes / rate >= pct_flops / F64_PEAK
         else "operations", "segments": nseg}]
    print(f"  (c) merge_histograms [{n_rows}, {HIST_BUCKETS}] float64 -> "
          f"{nseg} segments: {merge_ms:.4f} ms (bound {merge_bound:.4f} "
          f"ms, {merge_bytes} bytes at {rate / 1e12:.2f} TB/s); "
          f"percentiles_from_merged: {pct_ms:.4f} ms (bound "
          f"{pct_bound:.6f} ms); plain read (sum()) of the counts "
          f"{read_ms:.4f} ms (CUDA events, 10 calls)")
    del counts_dev, merged, seg_dev
    tsdb.shutdown()
    del tsdb

    # (d) percentiles on a scalar metric: the sketch fold, host only
    sketch_percentiles(n_series)

    # (e) the front end and durability
    hist_front_end(counts, bounds, prefix, tags, keys)
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")
    return {"functions": hist_line, **readings}


def hist_stages(torch, tsdb, q, name: str) -> None:
    """One cold call of ``q`` by the histogram engine's stages, each
    timed with a device synchronize: plan, arena slice, window rows,
    upload, segments, merge, percentiles, emit."""
    from opentsdb_tpu_torch.ops import histogram_kernels as hk
    from opentsdb_tpu_torch.query import histogram_engine as he
    sub = q.queries[0]
    secs = {}

    def stage(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        secs[label] = (time.perf_counter() - t) * 1e3
        return r

    metric_id, sids, tag_mat, gids, g = stage(
        "plan", lambda: he.plan_subquery(tsdb, tsdb.histogram_store, sub))
    active = stage("arena slice", lambda: he.arena_slice(
        tsdb, q, metric_id, sids))
    bounds, rows, psidx, pts = stage(
        "window rows", lambda: he.window_rows(active[0], sids))
    counts = stage("upload", lambda: he.upload(rows, tsdb.device))
    seg, _, ts_out, present = stage("segments", lambda: he.segments(
        q, sub, gids, g, psidx, pts))
    merged = stage("merge", lambda: hk.merge_histograms(
        counts, torch.from_numpy(seg).cuda(), g * len(ts_out)))
    pcts = stage("percentiles", lambda: hk.percentiles_from_merged(
        merged, torch.from_numpy(hk.bucket_mids(bounds)).cuda(),
        sub.percentiles).cpu().numpy())
    stage("emit", lambda: he._emit_groups(
        tsdb, q, sub, tag_mat, gids, g, ts_out, present,
        pcts.reshape(len(sub.percentiles), g, len(ts_out))))
    print(f"  {name} stages, ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in secs.items())
        + f"; sum {sum(secs.values()):.3f}")


def sketch_percentiles(n_series: int) -> None:
    """(d): percentiles of a scalar metric by the sketch fold (host)."""
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.query.model import TSQuery
    from opentsdb_tpu_torch.sketch.query import documented_alpha
    s = min(SKETCH_SERIES, n_series)
    rng = np.random.default_rng(0)
    vals = rng.lognormal(3.0, 0.8, (s, SKETCH_POINTS))
    ts2d = np.broadcast_to(T0 + 60 * np.arange(SKETCH_POINTS), vals.shape)
    t = TSDB(Config(**{"tsd.torch.device": "cuda",
                       "tsd.core.auto_create_metrics": "true",
                       "tsd.query.cache.enable": "false",
                       **HOST_TAIL_OFF}))
    t.add_series_points("sys.lat", [{"host": f"h{i}"} for i in range(s)],
                        ts2d, vals)
    q = TSQuery.from_json({
        "start": str(T0), "end": str(T0 + 60 * SKETCH_POINTS - 1),
        "queries": [{"aggregator": "sum", "metric": "sys.lat",
                     "downsample": "5m-avg",
                     "percentiles": [50.0, 99.0]}]}).validate()
    secs = []
    tt = time.perf_counter()
    rows = t.execute_query(q)
    secs.append(time.perf_counter() - tt)
    tt = time.perf_counter()
    rows2 = t.execute_query(q)
    secs.append(time.perf_counter() - tt)
    check(rows_bits(rows) == rows_bits(rows2),
          "(d) two sketch calls differ in their bits")
    alpha = documented_alpha(t)
    cell = np.arange(SKETCH_POINTS) // 5
    worst = 0.0
    check(len(rows) == 2, f"(d) {len(rows)} rows")
    for r, qv in zip(rows, (50.0, 99.0)):
        ts, got = r.dps_arrays
        check(len(ts) == SKETCH_POINTS // 5, f"(d) {len(ts)} buckets")
        for k in range(len(ts)):
            pts = np.sort(vals[:, cell == k].ravel())
            exact = pts[int(np.floor(qv / 100 * (len(pts) - 1)))]
            rel = abs(got[k] - exact) / abs(exact)
            worst = max(worst, rel)
            check(rel <= alpha, f"(d) p{qv} bucket {k}: {got[k]!r} vs "
                  f"exact {exact!r}, relative {rel!r} > alpha {alpha}")
    print(f"  (d) sketch fold, sum:5m-avg percentiles [50, 99] over {s} "
          f"series x {SKETCH_POINTS} points: "
          + " / ".join(f"{x * 1e3:.3f}" for x in secs)
          + f" ms (two calls, the same bits); worst relative error "
          f"against the exact order statistic {worst!r} <= alpha {alpha}")
    t.shutdown()


def hist_front_end(counts, bounds, prefix: bytes, tags, keys: dict) -> None:
    """(e): config 4's first points by ``/api/histogram`` and one telnet
    ``histogram`` line to the TSD server with the WAL on; the query by
    HTTP equal to ``execute_query``; the same bits after a restart from
    the WAL alone and from the snapshot."""
    import base64
    import http.client
    import shutil
    import socket
    import tempfile
    import urllib.parse
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.query.model import TSQuery
    from opentsdb_tpu_torch.tsd.json_serializer import HttpJsonSerializer
    from opentsdb_tpu_torch.tsd.server import ServerThread
    n = min(HIST_FE_SERIES, counts.shape[1] - 1)
    root = Path(tempfile.mkdtemp(prefix="tsd-histograms-"))
    d, crashed = root / "d", root / "wal-only"
    dkeys = {**keys, "tsd.storage.data_dir": str(d),
             "tsd.storage.wal.fsync": "always"}
    counts_be = counts.astype(">u8")
    dps = [{"metric": HIST_METRIC, "timestamp": T0 + 60 * j,
            "value": base64.b64encode(b).decode(), "tags": tags[i]}
           for j in range(HIST_POINTS)
           for i, b in zip(range(n), hist_blobs(counts_be[j, :n], prefix))]
    tel_blob = hist_blobs(counts_be[0, n:n + 1], prefix)[0]
    line = (f"histogram {HIST_METRIC} {T0} "
            f"{base64.b64encode(tel_blob).decode()} host={tags[n]['host']} "
            f"dc={tags[n]['dc']}\n").encode()
    q = TSQuery.from_json({
        "start": str(HIST_WINDOW[0]), "end": str(HIST_WINDOW[1]),
        "queries": [{"aggregator": "sum", "metric": HIST_METRIC,
                     "percentiles": list(HIST_QS)}]}).validate()
    merged = counts[:, :n].sum(axis=1).astype(np.float64)
    merged[0] += counts[0, n]
    want = hist_percentiles(merged, bounds, HIST_QS)
    tsdb = TSDB(Config(**dkeys))
    st = serve_pinned(ServerThread, tsdb)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", st.port, timeout=600)
        t = time.perf_counter()
        for lo in range(0, len(dps), HIST_FE_BODY):
            status, body, _ = _http(conn, "POST", "/api/histogram?summary",
                                    json.dumps(dps[lo:lo + HIST_FE_BODY])
                                    .encode())
            check(status == 200 and json.loads(body) == {
                "success": min(HIST_FE_BODY, len(dps) - lo), "failed": 0},
                f"/api/histogram: HTTP {status}: {body[:300]!r}")
        put_s = time.perf_counter() - t
        with socket.create_connection(("127.0.0.1", st.port), 600) as sk:
            sk.sendall(line + b"version\nexit\n")
            out = b""
            while chunk := sk.recv(65536):
                out += chunk
        check(out.decode().startswith("opentsdb_tpu_torch version")
              and out.count(b"\n") == 1,
              f"telnet answered more than the version: {out[:300]!r}")
        status, body, http_s = _http(
            conn, "GET", "/api/query?" + urllib.parse.urlencode({
                "start": HIST_WINDOW[0], "end": HIST_WINDOW[1],
                "m": f"sum:percentile[99, 99.9]:{HIST_METRIC}"}))
        check(status == 200, f"/api/query: HTTP {status}: {body[:300]!r}")
        rows = tsdb.execute_query(q)
        ser = HttpJsonSerializer.for_tsdb(tsdb)
        check(json.loads(body) == json.loads(ser.format_query(q, rows)),
              "the HTTP answer differs from execute_query's")
        got = hist_rows(rows, HIST_METRIC)
        for qi, qv in enumerate(HIST_QS):
            check(got[(qv, None)][1].view(np.int64).tolist()
                  == want[qi].view(np.int64).tolist(),
                  f"(e) p{qv}: {got[(qv, None)][1].tolist()} != "
                  f"{want[qi].tolist()}")
        base = rows_bits(rows)
        # a copy of the directory while the server runs: what a kill
        # leaves (every acknowledged write is in the fsynced log)
        shutil.copytree(d, crashed)
        conn.close()
    finally:
        st.stop()                 # shuts the TSDB down: flush, snapshot
    print(f"  (e) {len(dps)} points by /api/histogram in bodies of "
          f"{HIST_FE_BODY} with the WAL (fsync=always), {put_s:.3f} s "
          f"({len(dps) / put_s:,.0f} points/s), and one telnet histogram "
          f"line; HTTP query {http_s * 1e3:.3f} ms, equal to "
          "execute_query's and to the numpy float64 reference")
    for label, path in (("the WAL alone", crashed), ("the snapshot", d)):
        t = time.perf_counter()
        r = TSDB(Config(**{**dkeys, "tsd.storage.data_dir": str(path)}))
        load_s = time.perf_counter() - t
        snap = (path / "histograms.json").exists()
        check(snap == (path == d), f"{label}: histograms.json {snap}")
        check(rows_bits(r.execute_query(q)) == base,
              f"the restart from {label} answers other bits")
        print(f"  (e) restart from {label}: {load_s:.3f} s (load "
              f"{r.recovery['load_s']:.3f}, replay "
              f"{r.recovery['replay_s']:.3f} s), the same bits")
        r.wal.close()
    shutil.rmtree(root, ignore_errors=True)


ROLLUP_SERIES = 50_000     # phase 13: CUT from config 5's 100,000
ROLLUP_POINTS = 3600       # phase 13: one hour at one point a second
ROLLUP_CHUNK = 2_000       # phase 13: series per ingest call
ROLLUP_SAMPLE = 100        # phase 13 (a): 1 in 100 series held to numpy
ROLLUP_FE_HOSTS = 100      # phase 13 (c): hosts of the /api/rollup points
ROLLUP_FE_MINUTES = 45     # (c): 1m sum and count cells per host
ROLLUP_FE_HOURS = 10       # (c): 1h max cells per host
ROLLUP_FE_PREAGG = 1_000   # (c): pre-aggregates by /api/rollup
ROLLUP_FE_BODY = 1_000     # (c): points per /api/rollup body
ROLLUP_FE_METRIC = "rollup.fe"
# phase 13 (b): the point path with nothing cached, for the kernels
POINT_KEYS = {"tsd.query.grid_reduce": "false",
              "tsd.query.device_cache_mb": "0"}
# phase 13 (b): (query, keys beyond the defaults, the kernel it launches)
ROLLUP_QUERIES = (
    ("sum:5m-avg:rate:sys.cpu.user{dc=*}", {}, None),
    ("sum:5m-sum:rate:sys.cpu.user{dc=*}", POINT_KEYS, "span_reduce"),
    ("sum:5m-sum:rate:sys.cpu.user{rack=*}", POINT_KEYS, "onehot_reduce"),
    ("max:1h-max:sys.cpu.user{rack=*}", {}, None),
    ("sum:5m-count:sys.cpu.user{dc=*}", {}, None))


def rollup_query(m: str, usage: str | None = None,
                 hours: int = 1):
    """The TSQuery of ``m`` over phase 13's hour (or ``hours`` from
    it), with a rollupUsage."""
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    sub = parse_uri_subquery(m)
    if usage:
        sub.rollup_usage = usage
    return TSQuery(start=str(T0), end=str(T0 + 3600 * hours - 1),
                   queries=[sub]).validate()


def preagg_points(tsdb) -> dict:
    """The preagg store's points by tag names: (timestamps, values)."""
    store = tsdb.rollup_store.preagg_store()
    out = {}
    for mid in store.metric_ids():
        for sid in store.series_ids_for_metric(mid):
            tags = tuple(sorted((tsdb.uids.tag_names.get_name(k),
                                 tsdb.uids.tag_values.get_name(v))
                                for k, v in store.series(int(sid)).tags))
            b = store.materialize([int(sid)], 0, 2 ** 62)
            out[tags] = (b.ts_ms.tolist(), b.values.tolist())
    return out


def counting(mod, name: str, calls: dict):
    """Wrap ``mod.name`` so that each call on a CUDA tensor adds one to
    ``calls[name]``; returns the function to put back."""
    real = getattr(mod, name)

    def wrapped(*args, **kw):
        if args[0].is_cuda:
            calls[name] = calls.get(name, 0) + 1
        return real(*args, **kw)

    setattr(mod, name, wrapped)
    return real


def rollup_reference(m1: dict, n: int) -> dict:
    """Each of ROLLUP_QUERIES over the float64 per-minute statistics of
    the raw points (``m1``, [S, 60] each): ``{m: (tag key, tag value
    prefix, [G, B'] answer, [G, B'] sum|terms|)}``."""
    import numpy as np
    s5 = m1["sum"].reshape(n, 12, 5).sum(axis=2)
    out = {}
    for m, _, _ in ROLLUP_QUERIES:
        key, prefix, mod = ("dc", "dc", 100) if "{dc=*}" in m \
            else ("rack", "r", 2000)
        gid = np.arange(n) % mod
        g = min(n, mod)

        def grouped(x):
            return np.stack([np.bincount(gid, x[:, j], minlength=g)
                             for j in range(x.shape[1])], axis=1)

        if ":rate:" in m:
            x = s5 / 300.0 if "5m-avg" in m else s5
            want = grouped(np.diff(x, axis=1) / 300.0)
            terms = grouped((np.abs(x[:, 1:]) + np.abs(x[:, :-1])) / 300.0)
        elif "1h-max" in m:
            want = np.full((g, 1), -np.inf)
            np.maximum.at(want[:, 0], gid, m1["max"].max(axis=1))
            terms = np.abs(want)
        else:
            want = grouped(np.full((n, 12), 300.0))
            terms = want
        out[m] = (key, prefix, want, terms)
    return out


def rows_by_group(rows, key: str, prefix: str, g: int):
    """A tier answer's rows as a [G, B'] float64 array, row i the group
    whose tag value ends in i, and the rows' timestamps."""
    import numpy as np
    idx = [int(r.tags[key][len(prefix):]) for r in rows]
    check(sorted(idx) == list(range(g)),
          f"{len(idx)} groups in the answer, not {g}")
    vals = np.empty((g, len(rows[0].dps_arrays[1])))
    for i, r in zip(idx, rows):
        check(len(r.dps_arrays[1]) == vals.shape[1], "ragged answer")
        vals[i] = r.dps_arrays[1]
    check(bool(np.isfinite(vals).all()), "non-finite results")
    return vals, [r.dps_arrays[0].tolist() for r in rows]


def tier_kernel_vs_plain(torch, tsdb, store, m: str) -> tuple[str, float]:
    """The query's batch over the tier ``store`` through its kernel and
    the plain version on the card (phase 3's check)."""
    from opentsdb_tpu_torch.ops import downsample as ds_mod
    from opentsdb_tpu_torch.ops import fused, pipeline
    from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
    tq = rollup_query(m)
    sub = tq.queries[0]
    eng = tsdb.new_query()
    mid = tsdb.uids.metrics.get_id(METRIC)
    sel, tag_mat = eng._apply_filters(
        mid, sub, store.series_ids_for_metric(mid), store)
    gb = [tsdb.uids.tag_names.get_id(f.tagk) for f in sub.filters
          if f.group_by]
    gids, g = eng._group_ids(tag_mat, gb)
    padded = store.materialize_padded(sel, tq.start_ms, tq.end_ms)
    bidx, bts = ds_mod.assign_buckets_padded(
        padded.ts2d, padded.counts, sub.ds_spec, tq.start_ms, tq.end_ms)
    k = pipeline.detect_regular_padded(padded.counts, bidx, len(bts))
    check(k == 5, f"{m}: the tier's batch is not 5 cells a bucket ({k})")
    spec = PipelineSpec(num_series=len(sel), num_buckets=len(bts),
                        num_groups=g, ds_function="sum", agg_name="sum",
                        rate=True)
    vals = pipeline.upload(padded.values2d, torch.float32, "cuda")
    name, err, _ = kernel_vs_plain(fused, spec, vals, bts, gids, k,
                                   float(2**64 - 1), 0.0, allow_span=True)
    return name, err


def phase_rollups(torch, n_series: int, profile: bool):
    """Phase 13: BASELINE config 5 (the rollup job) and queries on its
    tiers. Returns (the kernels' launches, the ``rollup`` line)."""
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.native.store_backend import make_store
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.ops.pipeline import (PipelineSpec,
                                                 execute_avg_divide)
    from opentsdb_tpu_torch.query import engine as engine_mod
    from opentsdb_tpu_torch.rollup import job as rjob
    from opentsdb_tpu_torch.rollup.store import RollupStore
    t_phase = time.perf_counter()
    keys = {"tsd.torch.device": "cuda",
            "tsd.core.auto_create_metrics": "true",
            "tsd.rollups.enable": "true",
            "tsd.query.cache.enable": "false", **HOST_TAIL_OFF}
    tsdb = TSDB(Config(**keys))
    check(tsdb.store.backend == "native",
          "phase 13 runs on the default store, the native one")
    n, p = n_series, ROLLUP_POINTS
    t0_ms, end_ms = T0 * 1000, T0 * 1000 + p * 1000 - 1
    ts_ms = t0_ms + 1000 * np.arange(p, dtype=np.int64)
    tags = [{"host": f"h{i}", "dc": f"dc{i % 100}", "rack": f"r{i % 2000}"}
            for i in range(n)]

    # (a) data, seed 5, with a float64 per-minute reference (each
    # minute added in time order) and the sampled series' raw points
    rng = np.random.default_rng(5)
    m1 = {k: np.empty((n, p // 60)) for k in ("sum", "min", "max")}
    sample = np.arange(0, n, ROLLUP_SAMPLE)
    sample_vals = np.empty((len(sample), p))
    sids = np.empty(n, dtype=np.int64)
    mask = np.ones((ROLLUP_CHUNK, p - 1), dtype=bool)
    gen_s = ingest_s = 0.0
    for lo in range(0, n, ROLLUP_CHUNK):
        hi = min(lo + ROLLUP_CHUNK, n)
        t = time.perf_counter()
        vals = rng.normal(100.0, 15.0, (hi - lo, p))
        x = vals.reshape(hi - lo, p // 60, 60)
        acc = np.zeros((hi - lo, p // 60))
        for j in range(60):
            acc += x[:, :, j]
        m1["sum"][lo:hi], m1["min"][lo:hi], m1["max"][lo:hi] = \
            acc, x.min(axis=2), x.max(axis=2)
        at = sample[(sample >= lo) & (sample < hi)]
        sample_vals[at // ROLLUP_SAMPLE] = vals[at - lo]
        t1 = time.perf_counter()
        # the series and their first point by the bulk write, the rest
        # of the hour by append_grid (bench_e2e.py:300-318)
        sids[lo:hi] = tsdb.add_series_points(
            METRIC, tags[lo:hi], np.full((hi - lo, 1), T0, np.int64),
            vals[:, :1])
        tsdb.store.append_grid(sids[lo:hi], ts_ms[1:], vals[:, 1:],
                               mask[:hi - lo])
        ingest_s += time.perf_counter() - t1
        gen_s += t1 - t
    del vals, x
    n_raw = n * p
    check(tsdb.store.points_written == n_raw,
          f"{tsdb.store.points_written} raw points written, not {n_raw}")
    check(np.array_equal(sids, np.arange(n)), "unexpected raw series ids")
    print(f"  (a) ingest: {n} series x {p} points ({n_raw:,} raw points, "
          f"1 h at 1 s, normal(100, 15) seed 5) by add_series_points + "
          f"append_grid in chunks of {ROLLUP_CHUNK}: {ingest_s:.3f} s "
          f"({n_raw / ingest_s:,.0f} points/s; drawing the data and the "
          f"numpy reference {gen_s:.3f} s more)")

    # (a) the job by both routes, on fresh tiers each
    want_written = {"1m": n * 60 * 4, "1h": n * 4}
    stores, calls = {}, {}
    for route, device in (("storage", "false"), ("device", "true")):
        tsdb.config.override_config("tsd.rollups.job.device", device)
        tsdb.rollup_store = RollupStore(tsdb.rollup_config,
                                        lambda: make_store(tsdb.config))
        reals = [counting(rjob, f, calls)
                 for f in ("_rollup_tile_dense", "_rollup_tile", "_coarsen")]
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            written = rjob.run_rollup_job(tsdb, t0_ms, end_ms, ["1m", "1h"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            for f, real in zip(("_rollup_tile_dense", "_rollup_tile",
                                "_coarsen"), reals):
                setattr(rjob, f, real)
        check(written == want_written,
              f"{route} route wrote {written}, not {want_written}")
        stores[route] = tsdb.rollup_store
        print(f"  (a) job, {route} route (tsd.rollups.job.device="
              f"{device}): {secs:.3f} s ({n_raw / secs:,.0f} raw points/s); "
              f"written {written}; device calls "
              f"{calls if device == 'true' else {}}")
        READINGS[f"rollup_job_{route}_s"] = secs
    check(calls.get("_rollup_tile_dense", 0) > 0
          and calls.get("_rollup_tile", 0) == 0
          and calls["_coarsen"] == calls["_rollup_tile_dense"],
          f"the device route's tiles ran {calls}")
    if profile:
        tsdb.rollup_store = RollupStore(tsdb.rollup_config,
                                        lambda: make_store(tsdb.config))
        device_share(torch, lambda: rjob.run_rollup_job(
            tsdb, t0_ms, end_ms, ["1m", "1h"]), "job, device route")
    tsdb.config.override_config("tsd.rollups.job.device", "false")

    # the routes' tiers: the same series, timestamps, counts, mins and
    # maxes bit for bit, 1m sums bit for bit (both add in time order),
    # 1h sums within 1e-12 (numpy's pairwise order on the host)
    worst = 0.0
    for (iv, agg), a in stores["storage"].tiers():
        b = stores["device"].tier(iv, agg)
        check(a.series_identities() == b.series_identities(),
              f"{iv}:{agg}: the routes' series differ")
        ca, ta, va, _ = a.read_all()
        cb, tb, vb, _ = b.read_all()
        check(np.array_equal(ca, cb) and np.array_equal(ta, tb),
              f"{iv}:{agg}: the routes' points differ")
        if agg == "sum" and iv == "1h":
            rel = np.abs(va - vb) / np.abs(va)
            worst = float(rel.max())
            check(worst <= 1e-12, f"1h sums differ by {worst!r} relative")
        else:
            check(np.array_equal(va.view(np.int64), vb.view(np.int64)),
                  f"{iv}:{agg}: the routes' values differ in their bits")
    print("  (a) the routes' tiers: the same series, timestamps, counts, "
          "mins, maxes and 1m sums bit for bit (both add each minute in "
          f"time order); 1h sums within {worst!r} relative (<= 1e-12)")
    del stores["device"]
    tsdb.rollup_store = stores.pop("storage")

    # (a) a 1-in-100 sample against numpy, at the same bounds
    rs = tsdb.rollup_store
    for iv, width in (("1m", 60), ("1h", 3600)):
        x = sample_vals.reshape(len(sample), p // width, width)
        want = {"count": np.full(x.shape[:2], float(width)),
                "min": x.min(axis=2), "max": x.max(axis=2)}
        if iv == "1m":
            acc = np.zeros(x.shape[:2])
            for j in range(width):
                acc += x[:, :, j]
            want["sum"] = acc
        else:
            want["sum"] = x.sum(axis=2)
        for agg, w in want.items():
            store = rs.tier(iv, agg)
            check(all(store.series(int(s)).tags
                      == tsdb.store.series(int(s)).tags for s in sample[:50]),
                  f"{iv}:{agg}: tier series out of the raw order")
            batch = store.materialize(sample, t0_ms, end_ms)
            got = batch.values.reshape(len(sample), -1)
            check(np.array_equal(batch.ts_ms.reshape(got.shape)[0],
                                 t0_ms + width * 1000
                                 * np.arange(got.shape[1])),
                  f"{iv}:{agg}: tier timestamps")
            if agg == "sum" and iv == "1h":
                check(bool(np.allclose(got, w, rtol=1e-12, atol=0)),
                      "1h sums differ from numpy")
            else:
                check(np.array_equal(got.view(np.int64), w.view(np.int64)),
                      f"{iv}:{agg}: the tier differs from numpy")
    print(f"  (a) {len(sample)} sampled series (1 in {ROLLUP_SAMPLE}) "
          "against numpy float64 of their raw points: 1m sum/count/min/max "
          "and 1h count/min/max bit for bit, 1h sums within 1e-12")

    # (b) queries on the storage route's tiers
    cpu = TSDB(Config(**{**keys, "tsd.torch.device": "cpu",
                         "tsd.torch.dtype": "float64"}))
    # the port on the CPU in float64 over the same UIDs and stores
    cpu.uids, cpu.store = tsdb.uids, tsdb.store
    cpu.rollup_config, cpu.rollup_store = tsdb.rollup_config, rs
    refs = rollup_reference(m1, n)
    launches = {"span_reduce": 0, "onehot_reduce": 0}
    div_calls = {}
    real_div = counting(engine_mod, "execute_avg_divide", div_calls)
    readings = {}
    try:
        for m, extra, kname in ROLLUP_QUERIES:
            key, prefix, want, terms = refs[m]
            g = want.shape[0]
            tq = rollup_query(m)
            for k_, v_ in extra.items():
                tsdb.config.override_config(k_, v_)
            reset_launches(fused)
            colds, bits = [], []
            for _ in range(2):
                tsdb.drop_caches()
                (rows,), secs = timed(lambda: [tsdb.execute_query(tq)], 1)
                colds.append(secs[0])
                bits.append(rows)
            warm_rows, warm_s = timed(lambda: tsdb.execute_query(tq),
                                      REPEATS)
            n_l = read_launches(fused)
            tsdb.drop_caches()
            _, st_secs, st = _stats_run(tsdb, tq)
            for k_ in extra:
                tsdb.config.override_config(k_, Config().get_string(k_))
            read_pts = int(st.get("dpsPostFilter", 0))
            if kname is None:
                check(not any(n_l.values()), f"{m}: a kernel launched {n_l}")
            else:
                other = next(k for k in n_l if k != kname)
                check(n_l[kname] == 2 + REPEATS and n_l[other] == 0,
                      f"{m}: launches {n_l}")
                for k_, v_ in n_l.items():
                    launches[k_] += v_
            check(same_bits(bits[0], bits[1])
                  and same_bits(bits[0], warm_rows),
                  f"{m}: the calls differ in their bits")
            got, ts_got = rows_by_group(bits[0], key, prefix, g)
            check(got.shape == want.shape, f"{m}: shape {got.shape}")
            tier_pts = n * (120 if "5m-avg" in m else 60)
            if "1h-max" in m:
                tier_pts = n
            check(read_pts == tier_pts,
                  f"{m}: read {read_pts} points, not the tier's {tier_pts}")
            # the same query over the raw points, and the CPU float64 port
            raw_rows = tsdb.execute_query(rollup_query(m, "ROLLUP_RAW"))
            raw, ts_raw = rows_by_group(raw_rows, key, prefix, g)
            cpu64, ts_cpu = rows_by_group(cpu.execute_query(tq), key,
                                          prefix, g)
            check(ts_got == ts_raw == ts_cpu, f"{m}: timestamps differ")
            errs = {}
            for name, other_v in (("raw", raw), ("cpu64", cpu64),
                                  ("numpy", want)):
                errs[name] = compare(torch.as_tensor(got),
                                     torch.as_tensor(other_v),
                                     torch.as_tensor(terms))
            if ":rate:" not in m:
                # maxes and counts: exactly the raw answer
                check(np.array_equal(got, raw), f"{m}: differs from raw")
            if "5m-count" in m:
                check(bool((got == 300.0 * (n // 100)).all()),
                      f"{m}: a cell is not 300 x the group's series")
            readings[m] = {"cold_ms": [c * 1e3 for c in colds],
                           "warm_p50_ms": p50(warm_s) * 1e3}
            keys_said = (" (grid_reduce=false, device_cache_mb=0)"
                         if extra else "")
            print(f"  (b) {m}{keys_said}: cold "
                  + " / ".join(f"{c * 1e3:.3f}" for c in colds)
                  + f" ms, warm p50 {p50(warm_s) * 1e3:.3f} ms over "
                  f"{REPEATS}; read {read_pts:,} tier points; launches "
                  f"{n_l}; max |got - want| against ROLLUP_RAW "
                  f"{errs['raw']!r}, the CPU float64 port "
                  f"{errs['cpu64']!r}, numpy float64 {errs['numpy']!r}; "
                  "two cold calls and the warm calls the same bits")
            print(f"  (b) {m} stages of one cold call (ms): "
                  + _stage_line([st_secs], [st]))
            if profile:
                tsdb.drop_caches()
                device_share(torch, lambda: tsdb.execute_query(tq),
                             f"{m} cold")
    finally:
        setattr(engine_mod, "execute_avg_divide", real_div)
    check(div_calls.get("execute_avg_divide", 0) > 0,
          "the avg path never divided on the device")
    for m, _, kname in ROLLUP_QUERIES:
        if kname is not None:
            name, err = tier_kernel_vs_plain(torch, tsdb, rs.tier("1m", "sum"),
                                             m)
            check(name == kname, f"{m}: {name} ran, not {kname}")
            print(f"  (b) {m}: {kname} against its plain version on the "
                  f"1m sum tier's batch, max |k - p| {err!r}")

    # (b) the device functions by CUDA events, at the phase's shapes
    rate = next(r for key_, r in _MEM_RATE
                if key_ in torch.cuda.get_device_name(0))
    # a tile of the job's shape: its chunk of series (a 6 h window at
    # one point a second) x the hour's points
    rows_t = min(n, rjob._TILE_CELL_BUDGET // (360 * 60))
    tile_in = torch.from_numpy(np.random.default_rng(6).normal(
        100.0, 15.0, (rows_t, p))).cuda()
    grids = rjob._rollup_tile_dense(tile_in, 60, 60)
    tile_ms = cuda_ms(lambda: rjob._rollup_tile_dense(tile_in, 60, 60), 10)
    coarse_ms = cuda_ms(lambda: rjob._coarsen(grids, 0, 60, 1), 10)
    tile_read = cuda_ms(lambda: tile_in.sum(), 10)
    grid_read = cuda_ms(lambda: grids.sum(), 10)
    tile_bytes = tile_in.numel() * 8 + grids.numel() * 8
    tile_ops = tile_in.numel() * 6
    coarse_bytes = grids.numel() * 8 + grids.numel() // 60 * 8
    coarse_ops = grids.numel() * 3
    tsdb.drop_caches()
    tsdb.execute_query(rollup_query(ROLLUP_QUERIES[0][0]))
    gs, gc = next(e for k_, e in tsdb.device_grid_cache._entries.items()
                  if k_[0] == "avgdiv")[1]
    s_, b_ = gs.shape
    gids = np.arange(s_, dtype=np.int32) % 100
    bts = t0_ms + 300_000 * np.arange(b_, dtype=np.int64)
    spec = PipelineSpec(num_series=s_, num_buckets=b_, num_groups=100,
                        ds_function="avg", agg_name="sum", rate=True)
    div_ms = cuda_ms(lambda: execute_avg_divide(gs, gc, bts, gids, spec),
                     10)
    div_read = cuda_ms(lambda: (gs.sum(), gc.sum()), 10)
    div_bytes = 2 * gs.numel() * gs.element_size() + s_ * 4 + 100 * b_ * 5
    div_ops = gs.numel() * 8
    line = []
    for name, replaces, calls_n, ms, nbytes, ops, read, peak, shape in (
            ("_rollup_tile_dense", "opentsdb_tpu/rollup/job.py:56 (XLA)",
             calls.get("_rollup_tile_dense", 0), tile_ms, tile_bytes,
             tile_ops, tile_read, F64_PEAK, [rows_t, p]),
            ("_coarsen", "opentsdb_tpu/rollup/job.py:79 (XLA)",
             calls.get("_coarsen", 0), coarse_ms, coarse_bytes, coarse_ops,
             grid_read, F64_PEAK, list(grids.shape)),
            ("execute_avg_divide",
             "opentsdb_tpu/ops/pipeline.py:358 (XLA)",
             div_calls.get("execute_avg_divide", 0), div_ms, div_bytes,
             div_ops, div_read, F32_PEAK, [s_, b_])):
        bound = max(nbytes / rate, ops / peak) * 1e3
        line.append({"name": name, "route": "torch",
                     "source": "opentsdb_tpu_torch/" + (
                         "ops/pipeline.py" if "divide" in name
                         else "rollup/job.py"),
                     "replaces": replaces, "calls": calls_n, "ms": ms,
                     "bound_ms": bound,
                     "bound_by": "bytes" if nbytes / rate >= ops / peak
                     else "operations", "plain_read_ms": read,
                     "shape": shape})
        print(f"  (b) {name} {shape}: {ms:.4f} ms (bound {bound:.4f} ms, "
              f"{nbytes} bytes at {rate / 1e12:.2f} TB/s), plain read "
              f"{read:.4f} ms (CUDA events, 10 calls); {calls_n} calls "
              "on the phase's path")
    del gs, gc, grids, tile_in
    cpu.shutdown()
    tsdb.shutdown()
    del tsdb, cpu, rs

    # (c) writes by /api/rollup and telnet, then restarts
    rollup_front_end(keys)
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")
    return launches, {"functions": line, **readings}


def rollup_front_end(keys: dict) -> None:
    """(c): tier and pre-aggregate points by ``/api/rollup`` and one
    telnet ``rollup`` line to the TSD server with the WAL on; read back
    by HTTP queries and the preagg store, exactly; the same bits after
    a restart from the WAL alone and from the snapshot."""
    import http.client
    import shutil
    import socket
    import tempfile
    import urllib.parse
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.tsd.json_serializer import HttpJsonSerializer
    from opentsdb_tpu_torch.tsd.server import ServerThread
    root = Path(tempfile.mkdtemp(prefix="tsd-rollups-"))
    d, crashed = root / "d", root / "wal-only"
    dkeys = {**keys, "tsd.storage.data_dir": str(d),
             "tsd.storage.wal.fsync": "always"}
    hosts, mins, hours = ROLLUP_FE_HOSTS, ROLLUP_FE_MINUTES, ROLLUP_FE_HOURS
    mf = ROLLUP_FE_METRIC

    def tier_dp(i, ts, value, interval, agg):
        return {"metric": mf, "timestamp": ts, "value": value,
                "tags": {"host": f"fe{i}", "dc": f"dc{i % 10}"},
                "interval": interval, "aggregator": agg}

    dps = ([tier_dp(i, T0 + 60 * j, i * 1000 + j, "1m", "sum")
            for i in range(hosts) for j in range(mins)]
           + [tier_dp(i, T0 + 60 * j, 60, "1m", "count")
              for i in range(hosts) for j in range(mins)]
           + [tier_dp(i, T0 + 3600 * h, i * 100 + h, "1h", "max")
              for i in range(hosts) for h in range(hours)])
    pre = [{"metric": mf, "timestamp": T0 + 60 * (k // 10), "value": k,
            "tags": {"dc": f"dc{k % 10}"}, "groupByAggregator": "sum"}
           for k in range(ROLLUP_FE_PREAGG)]
    line = (f"rollup 1m:sum {mf} {T0 + 60 * mins} 7 host=fe0 dc=dc0\n"
            ).encode()
    queries = {m: rollup_query(m) for m in (
        f"sum:1m-sum:{mf}{{host=*}}", f"sum:1m-count:{mf}{{dc=*}}")}
    queries[f"max:1h-max:{mf}{{host=*}}"] = rollup_query(
        f"max:1h-max:{mf}{{host=*}}", hours=hours)
    tsdb = TSDB(Config(**dkeys))
    st = serve_pinned(ServerThread, tsdb)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", st.port, timeout=600)
        body_pts = dps + pre
        t = time.perf_counter()
        for lo in range(0, len(body_pts), ROLLUP_FE_BODY):
            chunk = body_pts[lo:lo + ROLLUP_FE_BODY]
            status, body, _ = _http(conn, "POST", "/api/rollup?summary",
                                    json.dumps(chunk).encode())
            check(status == 200 and json.loads(body) == {
                "success": len(chunk), "failed": 0},
                f"/api/rollup: HTTP {status}: {body[:300]!r}")
        put_s = time.perf_counter() - t
        with socket.create_connection(("127.0.0.1", st.port), 600) as sk:
            sk.sendall(line + b"version\nexit\n")
            out = b""
            while chunk_b := sk.recv(65536):
                out += chunk_b
        check(out.decode().startswith("opentsdb_tpu_torch version")
              and out.count(b"\n") == 1,
              f"telnet answered more than the version: {out[:300]!r}")
        ser = HttpJsonSerializer.for_tsdb(tsdb)
        base = {}
        for m, q in queries.items():
            status, body, http_s = _http(
                conn, "GET", "/api/query?" + urllib.parse.urlencode({
                    "start": q.start, "end": q.end, "m": m}))
            check(status == 200, f"/api/query: HTTP {status}: {body[:300]!r}")
            rows = tsdb.execute_query(q)
            check(json.loads(body) == json.loads(ser.format_query(q, rows)),
                  f"{m}: the HTTP answer differs from execute_query's")
            base[m] = rows
        # exactly what was written
        sums = {r.tags["host"]: r.dps_arrays[1].tolist()
                for r in base[f"sum:1m-sum:{mf}{{host=*}}"]}
        check(sums == {f"fe{i}": [i * 1000 + j for j in range(mins)]
                       + ([7] if i == 0 else []) for i in range(hosts)},
              "the 1m sums read back differ from those written")
        for r in base[f"sum:1m-count:{mf}{{dc=*}}"]:
            check(r.dps_arrays[1].tolist() == [600.0] * mins,
                  f"1m counts read back {r.dps_arrays[1][:5]}")
        maxes = {r.tags["host"]: r.dps_arrays[1].tolist()
                 for r in base[f"max:1h-max:{mf}{{host=*}}"]}
        check(maxes == {f"fe{i}": [i * 100 + h for h in range(hours)]
                        for i in range(hosts)},
              "the 1h maxes read back differ from those written")
        pre_want = preagg_points(tsdb)
        check(pre_want == {
            (("_aggregate", "SUM"), ("dc", f"dc{d}")): (
                [(T0 + 60 * j) * 1000 for j in range(ROLLUP_FE_PREAGG // 10)],
                [float(10 * j + d) for j in range(ROLLUP_FE_PREAGG // 10)])
            for d in range(10)}, "the preagg store holds other points")
        shutil.copytree(d, crashed)
        conn.close()
    finally:
        st.stop()
    print(f"  (c) {len(dps)} tier points (1m sum and count, 1h max) and "
          f"{len(pre)} pre-aggregates by /api/rollup in bodies of "
          f"{ROLLUP_FE_BODY} with the WAL (fsync=always): {put_s:.3f} s "
          f"({len(body_pts) / put_s:,.0f} points/s), and one telnet rollup "
          "line; the HTTP answers equal to execute_query's and to what "
          "was written")
    for label, path in (("the WAL alone", crashed), ("the snapshot", d)):
        t = time.perf_counter()
        r = TSDB(Config(**{**dkeys, "tsd.storage.data_dir": str(path)}))
        load_s = time.perf_counter() - t
        snap = (path / "rollup-1m-sum").is_dir()
        check(snap == (path == d), f"{label}: rollup-1m-sum/ {snap}")
        for m, q in queries.items():
            check(same_bits(r.execute_query(q), base[m]),
                  f"{m}: the restart from {label} answers other bits")
        check(preagg_points(r) == pre_want,
              f"the preagg store after the restart from {label}")
        print(f"  (c) restart from {label}: {load_s:.3f} s (load "
              f"{r.recovery['load_s']:.3f}, replay "
              f"{r.recovery['replay_s']:.3f} s), the same bits")
        r.shutdown()
    shutil.rmtree(root, ignore_errors=True)


# phase 14: continuous queries (streaming/) and the server warmup, the
# live dashboard of bench_e2e.py:335-431 (bench_live) at config 5's width
LIVE_SERIES = 100_000      # bench_live's 5,000 raised to config 5's width
LIVE_SPAN_S = 600          # 10 minutes at 1 s, CUT from bench_live's 30
LIVE_CHUNK = 10_000        # series per append_grid
LIVE_ROUNDS = 2            # CUT from 5, for the run's time limit
LIVE_TICK_HOSTS = 500      # add_point per round (bench_live)
LIVE_PUT_POINTS = 10_000   # /api/put per round, past buffer_points
LIVE_PUT_BODY = 1_000
LIVE_TEL_LINES = 1_000     # telnet put per round
LIVE_PREFIX_S = 300        # the point-path comparison's window
LIVE_GAP_S = (300, 480)    # dc2's hosts write nothing in [5 m, 8 m)
LIVE_SHARED = 16           # (b): copies of (a)'s first query
LIVE_WARM_SERIES = 10_000  # the warmup's data_dir
LIVE_WARM_SPAN_S = 300
LIVE_TAX_TICKS = 2_000     # add_point calls per ingest-tax reading
LIVE_FOLD_POINTS = 240_000  # points folded per fold-seconds reading
LIVE_BREAKER_RESET_MS = 1000


def live_query(agg: str, ds: str, filters: list, window=None,
               pct=None, end_s: int = LIVE_SPAN_S) -> dict:
    """One standing query's JSON over [T0, T0 + end_s)."""
    sub = {"metric": METRIC, "aggregator": agg, "downsample": ds,
           "filters": filters}
    if pct:
        sub["percentiles"] = pct
    q = {"start": T0 * 1000, "end": (T0 + end_s) * 1000 - 1,
         "queries": [sub]}
    if window:
        q["window"] = window
    return q


def _wild(tagk: str, group_by: bool) -> dict:
    return {"type": "wildcard", "tagk": tagk, "filter": "*",
            "groupBy": group_by}


def _lit(tagk: str, value: str) -> dict:
    return {"type": "literal_or", "tagk": tagk, "filter": value,
            "groupBy": False}


def live_tags(i: int) -> dict:
    return {"host": f"h{i}", "dc": f"dc{i % 100}", "rack": f"r{i % 2000}"}


def streamed_close(got, want, what: str) -> float:
    """Result groups of two runs of one query: the same groups and
    timestamps, values within TOL_REL * |want| + TOL_ABS (every term of
    these sums and maxes is positive, so |want| is their sum|terms|).
    Returns the max |got - want|."""
    import numpy as np
    gm = {tuple(sorted(r.tags.items())): r.dps_arrays for r in got}
    wm = {tuple(sorted(r.tags.items())): r.dps_arrays for r in want}
    check(gm.keys() == wm.keys() and len(wm) > 0,
          f"{what}: groups differ ({len(gm)} against {len(wm)})")
    worst = 0.0
    for key, (wt, wv) in wm.items():
        gt, gv = gm[key]
        check(np.array_equal(gt, wt), f"{what}: timestamps differ")
        check(bool(np.array_equal(np.isnan(gv), np.isnan(wv))),
              f"{what}: NaN positions differ")
        err = np.abs(np.nan_to_num(gv - wv))
        bad = err > TOL_REL * np.abs(np.nan_to_num(wv)) + TOL_ABS
        check(not bad.any(), f"{what}: {key} differs, max |d| "
              f"{float(err.max())!r}")
        worst = max(worst, float(err.max(initial=0.0)))
    return worst


class SseReader(threading.Thread):
    """Reads one event stream over a socket and records the arrival of
    every event by type."""

    def __init__(self, port: int, path: str):
        import socket
        super().__init__(name="smoke-sse-reader", daemon=True)
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=600)
        self.sock.sendall(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n"
                          "Accept-Encoding: gzip\r\n\r\n".encode())
        self.cond = threading.Condition()
        self.arrivals: list[tuple[str, float]] = []
        self.head = b""
        self.error = None

    def run(self) -> None:
        buf = b""
        try:
            while True:
                chunk = self.sock.recv(1 << 16)
                if not chunk:
                    return
                now = time.perf_counter()
                buf += chunk
                if not self.head and b"\r\n\r\n" in buf:
                    self.head, buf = buf.split(b"\r\n\r\n", 1)
                while b"\n\n" in buf:
                    block, buf = buf.split(b"\n\n", 1)
                    for line in block.split(b"\n"):
                        if line.startswith(b"event: "):
                            with self.cond:
                                self.arrivals.append(
                                    (line[7:].decode(), now))
                                self.cond.notify_all()
        except OSError as e:
            self.error = e

    def wait_count(self, event: str, n: int, timeout: float = 60.0):
        deadline = time.perf_counter() + timeout
        with self.cond:
            while sum(e == event for e, _ in self.arrivals) < n:
                left = deadline - time.perf_counter()
                check(left > 0, f"no {event} event {n} over SSE")
                self.cond.wait(left)
            return [t for e, t in self.arrivals if e == event][n - 1]

    def close(self) -> None:
        import socket
        # shutdown wakes the reader's recv; close alone would not
        self.sock.shutdown(socket.SHUT_RDWR)
        self.sock.close()
        self.join(30)


def live_oracles(minute_sums, dc2_sums, dc2_counts):
    """The windowed views' float64 answers from per-minute sums of the
    raw points: (sliding 5m, hopping 5m/2m) of the total, and each dc2
    series' sessions at a 2m gap, {host index: {edge ms: sum}}."""
    import numpy as np
    edges = T0 * 1000 + 60_000 * np.arange(LIVE_SPAN_S // 60)
    k = 5
    sliding = {int(e): float(minute_sums[max(0, i - k + 1):i + 1].sum())
               for i, e in enumerate(edges)}
    hopping = {e: v for e, v in sliding.items() if e % 120_000 == 0}
    sessions = {}
    for idx in dc2_sums:
        present = np.flatnonzero(dc2_counts[idx] > 0)
        out, first = {}, None
        for j, b in enumerate(present):
            if j == 0 or edges[b] - edges[present[j - 1]] > 120_000:
                first = int(edges[b])
                out[first] = 0.0
            out[first] += float(dc2_sums[idx][b])
        sessions[idx] = out
    return sliding, hopping, sessions


def warm_server_first_query(data_dir: Path, warm: bool) -> dict:
    """Start ``tools/cli.py tsd`` on ``data_dir`` in a subprocess,
    wait for its listening line (and, with warmup on, its warmup line),
    time the first ``/api/query``, and kill it."""
    import http.client
    import re
    import signal
    cmd = [sys.executable, "-m", "opentsdb_tpu_torch.tools.cli", "tsd",
           "--tsd.network.port=0", "--tsd.network.bind=127.0.0.1",
           f"--tsd.storage.data_dir={data_dir}",
           f"--tsd.tpu.warmup={'true' if warm else 'false'}",
           *(f"--{k}={v}" for k, v in HOST_TAIL_OFF.items())]
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines: dict[str, list] = {"out": [], "err": []}
    cond = threading.Condition()

    def pump(stream, key):
        for line in stream:
            with cond:
                lines[key].append((time.perf_counter(), line.rstrip()))
                cond.notify_all()

    readers = [threading.Thread(target=pump, args=(proc.stdout, "out"),
                                daemon=True),
               threading.Thread(target=pump, args=(proc.stderr, "err"),
                                daemon=True)]
    for r in readers:
        r.start()

    def wait_for(key: str, pattern: str, timeout: float = 300.0):
        deadline = time.perf_counter() + timeout
        with cond:
            while True:
                for t, line in lines[key]:
                    m = re.search(pattern, line)
                    if m:
                        return t, m
                left = deadline - time.perf_counter()
                if left <= 0 or proc.poll() is not None:
                    raise SmokeFailure(
                        f"no {pattern!r} from the TSD: "
                        + " | ".join(ln for _, ln in lines["err"][-5:]))
                cond.wait(min(left, 1.0))

    try:
        t_listen, m = wait_for("out", r"TSD listening on \S+:(\d+)")
        port = int(m.group(1))
        out = {"listen_s": t_listen - t_start}
        if warm:
            t_warm, m = wait_for("err", r"warmup: (\d+) classes in "
                                 r"([0-9.]+)s")
            out["classes"] = int(m.group(1))
            out["warmup_s"] = float(m.group(2))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        status, data, secs = _http(
            conn, "GET", f"/api/query?start={T0}&end="
            f"{T0 + LIVE_WARM_SPAN_S - 1}&m=sum:1m-avg:{METRIC}%7Bdc=*%7D")
        conn.close()
        check(status == 200, f"first query answered {status}")
        rows = json.loads(data)
        check(len(rows) == 100 and all(len(r["dps"]) == 5 for r in rows),
              "the first query's answer has the wrong shape")
        out["first_query_s"] = secs
        return out
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(60)
        for r in readers:
            r.join(10)


def phase_streaming(torch, n_series: int, profile: bool):
    """Phase 14: continuous queries and the server warmup on the card.
    Returns (the kernels' launches, the ``streaming`` line)."""
    import http.client
    import shutil
    import socket
    import tempfile
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.ops.pipeline import (PipelineSpec, execute_grid,
                                                 put_grid)
    from opentsdb_tpu_torch.query.model import TSQuery
    from opentsdb_tpu_torch.stats.stats import QueryStat, QueryStats
    from opentsdb_tpu_torch.tsd.server import ServerThread
    t_phase = time.perf_counter()
    n, p = n_series, LIVE_SPAN_S
    end_ms = (T0 + p) * 1000 - 1
    keys = {"tsd.torch.device": "cuda",
            "tsd.core.auto_create_metrics": "true",
            "tsd.query.cache.enable": "false", **HOST_TAIL_OFF,
            "tsd.tpu.warmup": "false",
            # publishes come from the explicit pumps below and the
            # measured flushes, as in bench_live
            "tsd.streaming.publish_min_interval_ms": "1000000000",
            "tsd.streaming.heartbeat_s": "60",
            "tsd.streaming.breaker.reset_timeout_ms":
                str(LIVE_BREAKER_RESET_MS)}
    tsdb = TSDB(Config(**keys))
    check(tsdb.store.backend == "native",
          "phase 14 runs on the default store, the native one")
    reg = tsdb.streaming

    # data: normal(100, 10) from seed 11 by append_grid; dc2's hosts
    # leave a 3-minute gap; per-minute sums kept for the oracles
    rng = np.random.default_rng(11)
    ts_grid = T0 * 1000 + 1000 * np.arange(p, dtype=np.int64)
    mid = tsdb.uids.metrics.get_or_create_id(METRIC)
    minute_sums = np.zeros(p // 60)
    dc2 = {}
    gen_s = ingest_s = 0.0
    vmin = np.inf
    for lo in range(0, n, LIVE_CHUNK):
        hi = min(lo + LIVE_CHUNK, n)
        t = time.perf_counter()
        vals = rng.normal(100.0, 10.0, (hi - lo, p))
        mask = np.ones((hi - lo, p), dtype=bool)
        rows = np.arange(lo, hi)
        gap_rows = np.flatnonzero(rows % 100 == 2)
        mask[gap_rows, LIVE_GAP_S[0]:LIVE_GAP_S[1]] = False
        vmin = min(vmin, float(vals.min()))
        mv = np.where(mask, vals, 0.0).reshape(hi - lo, p // 60, 60)
        per_minute = mv.sum(axis=2)
        minute_sums += per_minute.sum(axis=0)
        counts = mask.reshape(hi - lo, p // 60, 60).sum(axis=2)
        for r in gap_rows:
            dc2[int(lo + r)] = [per_minute[r].copy(), counts[r].copy()]
        _, tag_ids = tsdb._resolve_uids(
            METRIC, [live_tags(i) for i in range(lo, hi)])
        t1 = time.perf_counter()
        sids = tsdb.store.get_or_create_series_bulk(mid, tag_ids)
        tsdb.store.append_grid(sids, ts_grid, vals, mask)
        ingest_s += time.perf_counter() - t1
        gen_s += t1 - t
    del vals, mask, mv
    check(vmin > 0, "phase 14 data holds a value <= 0")
    n_raw = tsdb.store.points_written
    print(f"  ingest: {n} series x {p} points at 1 s ({n_raw:,} points; "
          f"normal(100, 10) seed 11; dc2's 1,000 hosts silent in "
          f"[{LIVE_GAP_S[0]}, {LIVE_GAP_S[1]}) s) by append_grid in "
          f"chunks of {LIVE_CHUNK}: {ingest_s:.3f} s "
          f"({n_raw / ingest_s:,.0f} points/s; drawing the data "
          f"{gen_s:.3f} s more)")

    # the standing queries, all over [T0, T0 + 30 min)
    qa1 = live_query("sum", "1m-avg", [_wild("dc", True),
                                        _wild("rack", False)])
    # max as the group aggregator has no kernel (K1 and K2 sum groups),
    # so (a)'s second query aggregates its 1m-max by avg
    qa2 = live_query("avg", "1m-max", [_wild("rack", True),
                                        _wild("dc", False)])
    qc_s = live_query("sum", "1m-sum", [],
                      window={"type": "sliding", "size": "5m"})
    qc_h = live_query("sum", "1m-sum", [],
                      window={"type": "hopping", "size": "5m",
                              "slide": "2m"})
    qd = live_query("none", "1m-sum", [_lit("dc", "dc2")],
                    window={"type": "session", "gap": "2m"})
    qe = live_query("sum", "1m-avg", [_lit("dc", "dc1")],
                    pct=[99.0, 99.9])
    boot = {}
    cqs = {}
    for name, q in (("a1", qa1), ("a2", qa2), ("c_sliding", qc_s),
                    ("c_hopping", qc_h), ("d", qd), ("e", qe)):
        t = time.perf_counter()
        cqs[name] = reg.register(q, now_ms=end_ms)
        boot[name] = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(LIVE_SHARED):
        reg.register({**qa1, "id": f"b{i}"}, now_ms=end_ms)
    boot["b"] = time.perf_counter() - t
    shared = cqs["a1"].plans[0].shared
    check(cqs["a2"].plans[0].shared is shared and len(shared.views)
          == 2 + LIVE_SHARED, "(a) and (b) do not share one partial")
    check(cqs["c_hopping"].plans[0].shared is
          cqs["c_sliding"].plans[0].shared,
          "(c)'s sliding and hopping views do not share one partial")
    print(f"  registration (bootstrap by bucket_reduce, s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in boot.items())
          + f"; {len(reg._partials)} shared partials for "
          f"{len(reg.list())} standing queries; ring "
          f"{reg.fold_bytes():,} bytes")

    def tsq_of(q):
        return TSQuery.from_json(q).validate()

    def batch(q, **over):
        """The port's batch engine: streaming off, the result cache off
        (this TSDB's keys), the other keys as given."""
        saved = {"tsd.streaming.serve": tsdb.config.get_string(
            "tsd.streaming.serve", "true"),
            **{k: tsdb.config.get_string(k) for k in over}}
        tsdb.config.override_config("tsd.streaming.serve", "false")
        for k, v in over.items():
            tsdb.config.override_config(k, v)
        try:
            return tsdb.execute_query(tsq_of(q))
        finally:
            for k, v in saved.items():
                tsdb.config.override_config(k, v)

    def pulled(q):
        """One pull through execute_query, served from the windows."""
        hits, fb = reg.serve_hits, reg.serve_fallbacks
        stats = QueryStats("smoke", tsq_of(q))
        out = tsdb.new_query().run(tsq_of(q), stats)
        stats.mark_complete()
        check(reg.serve_hits == hits + 1 and reg.serve_fallbacks == fb,
              "a pull was not served from the windows")
        check(stats.stats.get(QueryStat.STREAMING_HIT.value) == 1,
              "streamingHit is not in the query stats")
        return out

    st = serve_pinned(ServerThread, tsdb)
    conn = http.client.HTTPConnection("127.0.0.1", st.port, timeout=600)
    tel = socket.create_connection(("127.0.0.1", st.port), timeout=600)
    sse = SseReader(st.port,
                    f"/api/query/continuous/{cqs['a1'].id}/stream")
    sse.start()
    sse.wait_count("snapshot", 1)
    check(b"text/event-stream" in sse.head
          and b"chunked" in sse.head.lower()
          and b"content-encoding" not in sse.head.lower(),
          "the event stream is not chunked text/event-stream, or gzipped")

    def http_pull(q):
        hits = reg.serve_hits
        status, data, secs = _http(conn, "POST", "/api/query",
                                   json.dumps(q).encode())
        check(status == 200, f"an HTTP pull answered {status}")
        check(reg.serve_hits == hits + 1,
              "an HTTP pull was not served from the windows")
        return json.loads(data), secs

    def result_rows(cq):
        status, data, _ = _http(conn, "GET",
                                f"/api/query/continuous/{cq.id}/result")
        check(status == 200, f"/result answered {status}")
        return json.loads(data)

    dc2_rows = sorted(dc2)
    dc2_sums = {i: dc2[i][0] for i in dc2_rows}
    dc2_counts = {i: dc2[i][1] for i in dc2_rows}
    prefix = {m: live_query(q["queries"][0]["aggregator"],
                            q["queries"][0]["downsample"],
                            q["queries"][0]["filters"],
                            end_s=LIVE_PREFIX_S)
              for m, q in (("a1", qa1), ("a2", qa2))}
    incr, full, push, http_s, point_launches = [], [], [], [], {}
    worst = {"grid": 0.0, "point": 0.0, "windows": 0.0}
    put_s = tel_s = tick_s = 0.0
    # seconds by step, summed over the rounds
    step_s = dict.fromkeys(("(a) pulls", "(a) HTTP pulls", "(a) grid batch",
                            "(a) point pulls + batch", "(c)(d) /result",
                            "(e) pull", "(e) batch"), 0.0)
    t_rounds = time.perf_counter()
    for r in range(LIVE_ROUNDS):
        # live traffic: one point per tick host by add_point, a burst by
        # /api/put past buffer_points and one by telnet put, at
        # timestamps the grid does not hold
        base = (T0 + p - 60 + 10 * r) * 1000
        t = time.perf_counter()
        for j in range(LIVE_TICK_HOSTS):
            tsdb.add_point(METRIC, base + 500, 100.0 + r, live_tags(j))
        tick_s += time.perf_counter() - t
        t = time.perf_counter()
        for lo in range(0, LIVE_PUT_POINTS, LIVE_PUT_BODY):
            body = json.dumps([
                {"metric": METRIC, "timestamp": base + 250,
                 "value": 50.0 + j % 7, "tags": live_tags(j)}
                for j in range(lo, lo + LIVE_PUT_BODY)]).encode()
            status, data, _ = _http(conn, "POST", "/api/put", body)
            check(status == 204, f"/api/put answered {status}: {data[:200]}")
        put_s += time.perf_counter() - t
        t = time.perf_counter()
        # telnet put is silent: a "version" after the burst answers once
        # every line before it has been written and offered to the taps
        tel.sendall(("".join(
            f"put {METRIC} {base + 750} {20.0 + j % 3} "
            + " ".join(f"{k}={v}" for k, v in live_tags(j).items()) + "\n"
            for j in range(LIVE_PUT_POINTS,
                           LIVE_PUT_POINTS + LIVE_TEL_LINES))
            + "version\n").encode())
        got_tel = b""
        while b"built from revision" not in got_tel:
            chunk = tel.recv(1 << 16)
            check(bool(chunk), "the telnet connection closed")
            got_tel += chunk
        check(got_tel.startswith(b"opentsdb_tpu_torch version"),
              f"a telnet put answered {got_tel[:200]!r}")
        # (and one more point a round, the SSE reading's)
        want_pts = n_raw + r + (r + 1) * (LIVE_TICK_HOSTS
                                          + LIVE_PUT_POINTS + LIVE_TEL_LINES)
        tel_s += time.perf_counter() - t
        check(tsdb.store.points_written == want_pts,
              f"{tsdb.store.points_written} points, not {want_pts}")
        # the oracles' inputs: every live point of the round
        b = (base // 1000 - T0) // 60
        minute_sums[b] += sum(100.0 + r for _ in range(LIVE_TICK_HOSTS))
        minute_sums[b] += sum(50.0 + j % 7 for j in range(LIVE_PUT_POINTS))
        minute_sums[b] += sum(20.0 + j % 3 for j in range(
            LIVE_PUT_POINTS, LIVE_PUT_POINTS + LIVE_TEL_LINES))
        for j in dc2_rows:
            if j < LIVE_TICK_HOSTS:
                dc2_sums[j][b] += 100.0 + r
                dc2_counts[j][b] += 1
            if j < LIVE_PUT_POINTS:
                dc2_sums[j][b] += 50.0 + j % 7
                dc2_counts[j][b] += 1
            elif j < LIVE_PUT_POINTS + LIVE_TEL_LINES:
                dc2_sums[j][b] += 20.0 + j % 3
                dc2_counts[j][b] += 1

        # (a) and (b): pulls by execute_query and HTTP, then the batch
        # engine on the grid path (the full recompute) and, over the
        # first minutes, on the point path (K1 by dc, K2 by rack)
        for m, q in (("a1", qa1), ("a2", qa2)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = pulled(q)
            secs = time.perf_counter() - t
            step_s["(a) pulls"] += secs
            if m == "a1":
                incr.append(secs)
            rows, secs = http_pull(q)
            http_s.append(secs)
            step_s["(a) HTTP pulls"] += secs
            hv = {tuple(sorted(x["tags"].items())):
                  np.array(list(x["dps"].values()), dtype=np.float64)
                  for x in rows}
            check(len(hv) == len(got), "the HTTP pull's groups differ")
            for res in got:
                # the serializer prints each float32 value's shortest
                # repr, which reads back within a float32 ulp
                hvals = hv[tuple(sorted(res.tags.items()))]
                check(bool(np.allclose(hvals, res.dps_arrays[1],
                                       rtol=2 ** -23, atol=0)),
                      "the HTTP pull differs from execute_query's")
            torch.cuda.synchronize()
            t = time.perf_counter()
            want = batch(q)
            secs = time.perf_counter() - t
            step_s["(a) grid batch"] += secs
            if m == "a1":
                full.append(secs)
            worst["grid"] = max(worst["grid"], streamed_close(
                got, want, f"({m}) grid, round {r}"))
            t = time.perf_counter()
            got_pre = pulled(prefix[m])
            reset_launches(fused)
            want_pre = batch(prefix[m], **{
                "tsd.query.grid_reduce": "false",
                "tsd.query.device_cache_mb": "0"})
            for kname, k in read_launches(fused).items():
                point_launches[kname] = point_launches.get(kname, 0) + k
            step_s["(a) point pulls + batch"] += time.perf_counter() - t
            worst["point"] = max(worst["point"], streamed_close(
                got_pre, want_pre, f"({m}) point path"))
        # (c) and (d): the windowed views' /result against numpy
        t = time.perf_counter()
        sliding, hopping, sessions = live_oracles(
            minute_sums, dc2_sums, dc2_counts)
        for cq, want in ((cqs["c_sliding"], sliding),
                         (cqs["c_hopping"], hopping)):
            rows = result_rows(cq)
            check(len(rows) == 1, "a (c) view answered other than one row")
            got = {int(k): v for k, v in rows[0]["dps"].items()}
            check(set(got) == set(want), f"{cq.id}: edges differ")
            for e, v in want.items():
                err = abs(got[e] - v)
                check(err <= TOL_REL * abs(v) + TOL_ABS,
                      f"{cq.id} at {e}: {got[e]!r} against {v!r}")
                worst["windows"] = max(worst["windows"], err / abs(v))
        rows = result_rows(cqs["d"])
        check(len(rows) == len(dc2_rows), "(d) rows differ")
        for row in rows:
            i = int(row["tags"]["host"][1:])
            got = {int(k): v for k, v in row["dps"].items()
                   if v is not None}
            want = sessions[i]
            check(set(got) == set(want), f"(d) h{i}: sessions differ")
            for e, v in want.items():
                check(abs(got[e] - v) <= TOL_REL * abs(v) + TOL_ABS,
                      f"(d) h{i} at {e}: {got[e]!r} against {v!r}")
        step_s["(c)(d) /result"] += time.perf_counter() - t
        # (e): the sketch channel against the batch sketch path
        t = time.perf_counter()
        got = pulled(qe)
        step_s["(e) pull"] += time.perf_counter() - t
        t = time.perf_counter()
        want = batch(qe)
        step_s["(e) batch"] += time.perf_counter() - t
        check(len(got) == 2 and [
            (x.metric, x.tags, x.dps_arrays[0].tolist(),
             x.dps_arrays[1].tobytes()) for x in got] == [
            (x.metric, x.tags, x.dps_arrays[0].tolist(),
             x.dps_arrays[1].tobytes()) for x in want],
              "(e) percentiles differ from the batch sketch path's bits")
        # SSE: one write, one pump of (a)'s first query, one frame
        n_win = sum(e == "windows" for e, _ in sse.arrivals)
        t = time.perf_counter()
        tsdb.add_point(METRIC, base + 900, 1.0, live_tags(0))
        reg.pump(cqs["a1"], force=True)
        push.append(sse.wait_count("windows", n_win + 1) - t)
    rounds_s = time.perf_counter() - t_rounds
    check(point_launches.get("span_reduce", 0) >= LIVE_ROUNDS
          and point_launches.get("onehot_reduce", 0) >= LIVE_ROUNDS,
          f"the point path did not launch both kernels: {point_launches}")
    n_live = LIVE_ROUNDS * (LIVE_TICK_HOSTS + LIVE_PUT_POINTS
                            + LIVE_TEL_LINES)
    print(f"  {LIVE_ROUNDS} rounds in {rounds_s:.3f} s: each "
          f"{LIVE_TICK_HOSTS} add_point ({tick_s / LIVE_ROUNDS:.3f} s), "
          f"{LIVE_PUT_POINTS} points by /api/put in "
          f"{LIVE_PUT_POINTS // LIVE_PUT_BODY} bodies "
          f"({LIVE_PUT_POINTS * LIVE_ROUNDS / put_s:,.0f} points/s) and "
          f"{LIVE_TEL_LINES} telnet lines ({tel_s / LIVE_ROUNDS:.3f} s to "
          f"land); {n_live:,} live points, all read back; fold workers "
          f"drained {reg.workers.drains} times")
    print("  per round, s: " + ", ".join(
        f"{k} {v / LIVE_ROUNDS:.3f}" for k, v in step_s.items()))
    print(f"  pulls: serve_hits {reg.serve_hits}, serve_fallbacks "
          f"{reg.serve_fallbacks}; (a)/(b) equal to the grid path (max "
          f"|d| {worst['grid']!r}) and over the first "
          f"{LIVE_PREFIX_S // 60} minutes to the point path (max |d| "
          f"{worst['point']!r}; launches {point_launches}); (c) sliding "
          "and hopping equal to numpy float64 (max rel "
          f"{worst['windows']:.3g}),"
          f" (d) {len(dc2_rows)} series' sessions equal, (e) bit for bit")
    incr_p50, full_p50 = p50(incr), p50(full)
    print(f"  refresh p50: incremental {incr_p50 * 1e3:.3f} ms against "
          f"full recompute {full_p50 * 1e3:.3f} ms, "
          f"{full_p50 / incr_p50:.2f}x (bench_live asks for 10x or "
          f"more; reported, not gated); HTTP pull p50 "
          f"{p50(http_s) * 1e3:.3f} ms")
    print(f"  SSE: 1 snapshot, {sum(e == 'windows' for e, _ in sse.arrivals)}"
          f" windows events; push p50 {p50(push) * 1e3:.3f} ms (write to "
          "delivered frame)")
    # where one pull of (a)'s first query goes, its serve taken stage
    # by stage after a write (an unchanged ring reuses the cached tail
    # and does no device work at all); the tail's device time; and,
    # with --profile, one pull's device idle share
    view = cqs["a1"].plans[0]
    tsq_a1 = tsq_of(qa1)
    stages = {}
    tsdb.add_point(METRIC, (T0 + p - 5) * 1000 + 50, 3.0, live_tags(2))
    t = time.perf_counter()
    reg._drain_group(shared)
    stages["drain"] = time.perf_counter() - t
    with shared.lock:
        t = time.perf_counter()
        grid, present, edges, _ = view.grid_for(T0 * 1000, end_ms)
        stages["windows to grid"] = time.perf_counter() - t
        tag_mat, gids, g, _gb = view._groups_locked()
        t = time.perf_counter()
        result, emit = view._tail_locked(edges, grid, present, gids, g,
                                         False)
        stages["upload + tail + download"] = time.perf_counter() - t
        t = time.perf_counter()
        tsdb.new_query()._build_results(
            tsq_a1, tsq_a1.queries[0], shared.metric_id,
            np.asarray(shared._sids, dtype=np.int64), tag_mat, gids, g,
            edges, result, emit)
        stages["assemble"] = time.perf_counter() - t
    print("  one pull's stages, ms: " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in stages.items()))
    dgrid, dhas = put_grid(grid, present, tsdb.dtype, tsdb.device)
    spec = PipelineSpec(num_series=grid.shape[0], num_buckets=len(edges),
                        num_groups=g, ds_function="avg", agg_name="sum")
    tail_ms = cuda_ms(lambda: execute_grid(dgrid, dhas, edges, gids, spec),
                      10)
    print(f"  the tail on the card ([{grid.shape[0]}, {len(edges)}] -> "
          f"[{g}, {len(edges)}]): {tail_ms:.4f} ms (CUDA events)")
    if profile:
        tsdb.add_point(METRIC, (T0 + p - 5) * 1000 + 60, 3.0,
                       live_tags(3))
        device_share(torch, lambda: pulled(qa1), "(a) pull after a write")

    # faults: one fold failure, then a persistent one, then healing
    tsdb.faults.arm("stream.fold", error_count=1)
    tsdb.add_point(METRIC, (T0 + p - 5) * 1000 + 100, 7.0, live_tags(1))
    fe0, fb0, rb0 = reg.fold_errors, reg.serve_fallbacks, reg.rebuilds
    shed = tsdb.execute_query(tsq_of(qa1))
    check(reg.fold_errors == fe0 + 1 and reg.serve_fallbacks == fb0 + 1,
          "an armed stream.fold did not shed the pull")
    streamed_close(shed, batch(qa1), "(a) shed once")
    got = pulled(qa1)
    check(reg.rebuilds == rb0 + 1, "the pull after a fold fault did not "
          "rebuild")
    streamed_close(got, batch(qa1), "(a) after the rebuild")
    tsdb.faults.arm("stream.fold", error_rate=1.0)
    statuses = []
    for i in range(4):
        tsdb.add_point(METRIC, (T0 + p - 5) * 1000 + 200 + i, 7.0,
                       live_tags(1))
        status, data, _ = _http(conn, "POST", "/api/query",
                                json.dumps(qa1).encode())
        statuses.append(status)
    check(reg.breaker.state == reg.breaker.OPEN,
          f"the breaker did not trip: {reg.breaker.state}")
    want = batch(qa1)
    wv = {tuple(sorted(x.tags.items())): x.dps_arrays[1] for x in want}
    for x in json.loads(data):
        check(np.array_equal(np.array(list(x["dps"].values())),
                             wv[tuple(sorted(x["tags"].items()))]),
              "a shed pull differs from the batch answer")
    conn.request("GET", "/api/query/continuous/"
                 f"{cqs['c_sliding'].id}/result")
    resp = conn.getresponse()
    retry_after = resp.getheader("Retry-After")
    err = json.loads(resp.read())["error"]
    statuses.append(resp.status)
    check(resp.status == 503 and err["code"] == 503 and retry_after,
          f"/result answered {resp.status} (Retry-After {retry_after}) "
          "with the breaker open")
    check(500 not in statuses, f"a 500 while degraded: {statuses}")
    tsdb.faults.disarm("stream.fold")
    time.sleep(LIVE_BREAKER_RESET_MS / 1000 + 0.2)
    got = pulled(qa1)
    check(reg.breaker.state == reg.breaker.CLOSED,
          "the probe did not close the breaker")
    streamed_close(got, batch(qa1), "(a) after the breaker closed")
    check(len(result_rows(cqs["c_sliding"])) == 1, "(c) after healing")
    print(f"  faults: stream.fold once -> 1 pull shed, then rebuilt, "
          f"equal; persistently -> breaker open after "
          f"{reg.breaker.trips} trip(s), pulls shed equal to batch, "
          f"/result 503 with Retry-After {retry_after}, statuses "
          f"{statuses}; disarmed -> closed after {LIVE_BREAKER_RESET_MS} "
          f"ms, equal; fold_errors {reg.fold_errors}, rebuilds "
          f"{reg.rebuilds}")
    ring = reg.fold_bytes()
    conn.close()
    tel.close()
    sse.close()
    st.stop()       # stops the fold workers and shuts the TSDB down
    check(not any(th.name.startswith("tsd-stream-fold-")
                  for th in threading.enumerate()),
          "a fold worker outlived its TSDB")
    del tsdb, grid, dgrid, dhas

    # the write path's tax: add_point p50 with 0, 10 and 50 standing
    # queries (no WAL: the tap alone), and fold seconds for 1 query
    # against 16 sharing one partial (bench_e2e.py:433-590)
    def small(**extra):
        return TSDB(Config(**{"tsd.torch.device": "cuda",
                              "tsd.core.auto_create_metrics": "true",
                              "tsd.tpu.warmup": "false", **HOST_TAIL_OFF,
                              **extra}))
    fns = ["1m-sum", "1m-avg", "1m-max", "1m-min", "1m-count",
           "2m-sum", "2m-avg", "2m-max", "2m-min", "2m-count"]
    aggs = ["sum", "avg", "max", "min", "sum"]

    def tax_q(i):
        return {"start": T0 * 1000, "end": (T0 + p) * 1000 - 1,
                "queries": [{"metric": "sys.tax", "aggregator":
                             aggs[i % 5], "downsample": fns[i % 10]}]}
    tax = {}
    for n_cq in (0, 10, 50):
        t_db = small()
        for i in range(n_cq):
            t_db.streaming.register(tax_q(i), now_ms=end_ms)
        secs = []
        for i in range(LIVE_TAX_TICKS):
            t = time.perf_counter()
            t_db.add_point("sys.tax", T0 + i % p, 1.0, {"host": f"h{i % 8}"})
            secs.append(time.perf_counter() - t)
        tax[n_cq] = p50(secs) * 1e6
        t_db.shutdown()
    fold_s = {}
    for n_cq in (1, LIVE_SHARED):
        t_db = small(**{"tsd.streaming.workers.count": "0",
                        "tsd.streaming.buffer_points": str(1 << 30),
                        "tsd.streaming.workers.max_pending_points":
                            str(1 << 30)})
        for i in range(n_cq):
            t_db.streaming.register({**tax_q(0), "id": f"f{i}"},
                                    now_ms=end_ms)
        per = LIVE_FOLD_POINTS // 64
        ts = T0 * 1000 + np.arange(per, dtype=np.int64) * (p * 1000 // per)
        t_db.add_series_points("sys.tax", [{"host": f"h{i}"}
                                           for i in range(64)],
                               np.tile(ts, (64, 1)),
                               rng.normal(100, 10, (64, per)))
        groups = list(t_db.streaming._partials)
        check(len(groups) == 1, "the fold readings' queries do not share")
        t = time.perf_counter()
        for g_ in groups:
            t_db.streaming._drain_group(g_)
        fold_s[n_cq] = time.perf_counter() - t
        check(groups[0].points_folded == LIVE_FOLD_POINTS,
              "the fold reading folded another count of points")
        t_db.shutdown()
    print(f"  add_point p50 (no WAL) with 0 / 10 / 50 standing queries: "
          f"{tax[0]:.1f} / {tax[10]:.1f} / {tax[50]:.1f} us "
          f"({tax[50] / tax[0]:.2f}x at 50); fold of "
          f"{LIVE_FOLD_POINTS:,} points for 1 query {fold_s[1]:.4f} s, "
          f"for {LIVE_SHARED} sharing one partial "
          f"{fold_s[LIVE_SHARED]:.4f} s")

    # warmup: a data_dir of 10k series, the TSD started twice on it
    root = Path(tempfile.mkdtemp(prefix="tsd-warmup-"))
    w_db = TSDB(Config(**{"tsd.torch.device": "cuda",
                          "tsd.core.auto_create_metrics": "true",
                          "tsd.storage.data_dir": str(root)}))
    ws, wp = LIVE_WARM_SERIES, LIVE_WARM_SPAN_S
    w_db.add_series_points(
        METRIC, [live_tags(i) for i in range(ws)],
        np.tile(T0 + np.arange(wp, dtype=np.int64), (ws, 1)),
        rng.normal(100, 10, (ws, wp)))
    t = time.perf_counter()
    w_db.shutdown()     # the snapshot
    snap_s = time.perf_counter() - t
    warm = warm_server_first_query(root, True)
    cold = warm_server_first_query(root, False)
    shutil.rmtree(root, ignore_errors=True)
    print(f"  warmup ({ws} series x {wp} points in a data_dir, snapshot "
          f"{snap_s:.3f} s; tools/cli.py tsd in a subprocess): on, "
          f"{warm['classes']} classes in {warm['warmup_s']:.1f} s, first "
          f"/api/query {warm['first_query_s'] * 1e3:.3f} ms; off, first "
          f"/api/query {cold['first_query_s'] * 1e3:.3f} ms (listening "
          f"after {warm['listen_s']:.1f} / {cold['listen_s']:.1f} s)")
    check(warm["classes"] > 0, "the warmup ran no class")
    line = {
        "series": n, "points": n_raw, "rounds": LIVE_ROUNDS,
        "live_points": n_live, "ingest_s": ingest_s,
        "bootstrap_s": boot, "incremental_p50_ms": incr_p50 * 1e3,
        "full_p50_ms": full_p50 * 1e3,
        "refresh_speedup": full_p50 / incr_p50,
        "http_pull_p50_ms": p50(http_s) * 1e3,
        "sse_push_p50_ms": p50(push) * 1e3,
        "tail_ms": tail_ms, "ring_bytes": ring,
        "add_point_p50_us": {str(k): v for k, v in tax.items()},
        "fold_s": {str(k): v for k, v in fold_s.items()},
        "warmup": {"classes": warm["classes"],
                   "warmup_s": warm["warmup_s"],
                   "first_query_ms_warm": warm["first_query_s"] * 1e3,
                   "first_query_ms_cold": cold["first_query_s"] * 1e3},
        "phase_s": time.perf_counter() - t_phase}
    print(f"  phase 14: {line['phase_s']:.1f} s")
    return point_launches, line


# phase 15: dashboard surfaces on phase 3's TSDB (config 3) and one small
# TSDB built by append_grid: the host tail's budget edges, the device
# breaker, /api/query/exp and /gexp, a pixel budget, tsuids and delete
EDGE_SERIES = 131_073      # (a): one past the linear budget's edge at B=60
EDGE_POINTS = 60           # (a): an hour at one point a minute, 1m-avg
# (a): (label, query, S, G): at B = 60 (64 padded) the linear budget
# 2^23 cells holds 131,072 padded series, the rank budget 2^20 cells
# 16,384, and 2^25 cells x groups 32 padded groups at 16,384 series (31
# groups bucket to 32, 32 to 40)
EDGE_CASES = (
    ("linear 2^23 cells, under", "sum:1m-avg:edge.m{}{lin=a}",
     131_072, 1),
    ("linear 2^23 cells, over", "sum:1m-avg:edge.m", 131_073, 1),
    ("rank 2^20 cells, under", "p99:1m-avg:edge.m{}{rank=a}", 16_384, 1),
    ("rank 2^20 cells, over", "p99:1m-avg:edge.m{}{rank=a|b}", 16_385, 1),
    ("rank 2^25 cells x groups, under",
     "p99:1m-avg:edge.m{grp=*}{rank=a,grp=not_literal_or(g31)}",
     15_872, 31),
    ("rank 2^25 cells x groups, over", "p99:1m-avg:edge.m{grp=*}{rank=a}",
     16_384, 32))
# (a): budgets far past any query, to pin a tail on the host
HOST_PINNED = {"tsd.query.host_tail_max_cells": str(1 << 40),
               "tsd.query.host_tail_max_cellgroups": str(1 << 50),
               "tsd.query.host_tail_max_cells_linear": str(1 << 40)}
SURF_BREAKER_RESET_MS = 1000   # (b): the small TSDB's reset window
SURF_WINDOW = (T0, T0 + 3299)  # (c), (e): 11 buckets of 5 m, clear of
#                                phase 6's late point on the last series
PX_SERIES = 64             # (d): raw series of an hour at one point a second
PX_POINTS = 3600
PX_BUDGET = 300            # (d): pixels of the chart
TSUID_SERIES = 100         # (e): tsuids of one sub-query
# (c), (e): calls per p50 over config 3 (an /exp call runs two point-path
# queries over 1M series, 4-5 s; REPEATS would take 35 s of the 60)
SURF_REPEATS = 3
DELETE_S = 600             # (e): the deleted range's seconds


def legacy_percentile(x, q: float):
    """Column order statistic of ``x`` [n, B] with commons-math3's
    legacy estimation (h = q(n+1)/100 clamped to [1, n], linear between
    ranks), in float64: the p99 aggregator's semantics."""
    import numpy as np
    srt = np.sort(np.asarray(x, dtype=np.float64), axis=0)
    n = srt.shape[0]
    h = min(max(q / 100.0 * (n + 1), 1.0), float(n))
    lo = int(np.floor(h))
    frac = h - lo
    hi = min(lo, n - 1)
    return srt[lo - 1] + frac * (srt[hi] - srt[lo - 1])


def config3_window(values, ds: str, key: str, buckets: int):
    """``sum:5m-<ds>:rate`` by ``key`` (dc: i % 100, rack: i % 2000) over
    the first ``buckets`` 5-minute buckets of :func:`make_data`'s
    ``values`` in float64: ([G, B - 1] answer, [G, B - 1] sum|terms|)."""
    import numpy as np
    n = values.shape[0]
    groups = 100 if key == "dc" else 2000
    win = values[:, :buckets * 5].reshape(n, buckets, 5)
    cell = win.mean(axis=2) if ds == "avg" else win.max(axis=2)
    rate = np.diff(cell, axis=1) / 300.0
    terms = (np.abs(cell[:, 1:]) + np.abs(cell[:, :-1])) / 300.0
    gid = np.arange(n) % groups
    return tuple(np.stack([np.bincount(gid, x[:, j], minlength=groups)
                           for j in range(x.shape[1])], axis=1)
                 for x in (rate, terms))


def phase_surfaces(torch, tsdb, values, query) -> dict:
    """Phase 15: dashboard surfaces. (a) the host tail at its default
    budgets on a small TSDB: a sum and a p99 query at the S just under
    and just over each budget, each at its default placement and pinned
    the other way; (b) the device breaker on the card; (c)
    ``/api/query/exp`` and ``/gexp`` over config 3 sub-queries that run
    K1 on phase 3's TSDB; (d) an M4 pixel budget over raw series of an
    hour at 1 s; (e) a tsuid sub-query of 100 tsuids on phase 3's TSDB
    and a ``delete=true`` over a range, read back. Returns the kernel
    launches of (c) and (e)."""
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.ops import visual_downsample as vd
    from opentsdb_tpu_torch.query import engine as engine_mod
    from opentsdb_tpu_torch.query.engine import host_tail_for_dims
    from opentsdb_tpu_torch.query.model import (TSQuery,
                                                parse_uri_subquery)
    from opentsdb_tpu_torch.stats.stats import QueryStats
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
    t_phase = time.perf_counter()
    out: dict = {}

    # the small TSDB at the defaults but the result cache, with a short
    # breaker window for (b) and deletes allowed for (e)
    small = TSDB(Config(**{
        "tsd.torch.device": "cuda", "tsd.core.auto_create_metrics": "true",
        "tsd.query.cache.enable": "false", "tsd.tpu.warmup": "false",
        "tsd.query.breaker.failure_threshold": "2",
        "tsd.query.breaker.reset_timeout_ms": str(SURF_BREAKER_RESET_MS),
        "tsd.http.query.allow_delete": "true"}))
    rng = np.random.default_rng(15)
    t = time.perf_counter()
    n, p = EDGE_SERIES, EDGE_POINTS
    edge_vals = rng.normal(100.0, 15.0, (n, p))
    tags = [{"host": f"h{i}", "lin": "a" if i < n - 1 else "b",
             "rank": "a" if i < 16_384 else ("b" if i == 16_384 else "c"),
             "grp": f"g{i % 32}"} for i in range(n)]
    mid = small.uids.metrics.get_or_create_id("edge.m")
    _, tag_ids = small._resolve_uids("edge.m", tags)
    sids = small.store.get_or_create_series_bulk(mid, tag_ids)
    small.store.append_grid(sids, T0 * 1000 + 60_000 * np.arange(p),
                            edge_vals, np.ones((n, p), dtype=bool))
    px_vals = 100.0 + np.cumsum(rng.normal(0.0, 1.0, (PX_SERIES, PX_POINTS)),
                                axis=1)
    pmid = small.uids.metrics.get_or_create_id("px.raw")
    _, ptags = small._resolve_uids("px.raw", [{"host": f"h{i}"}
                                              for i in range(PX_SERIES)])
    psids = small.store.get_or_create_series_bulk(pmid, ptags)
    px_ts = T0 * 1000 + 1000 * np.arange(PX_POINTS)
    small.store.append_grid(psids, px_ts, px_vals,
                            np.ones(px_vals.shape, dtype=bool))
    print(f"  small TSDB: edge.m {n} series x {p} points at 1 m and px.raw "
          f"{PX_SERIES} x {PX_POINTS} at 1 s by append_grid "
          f"({small.store.points_written:,} points, normal(100, 15) and a "
          f"random walk from seed 15): {time.perf_counter() - t:.3f} s")
    window = (str(T0), str(T0 + p * 60 - 1))

    # (a) the budget edges: default placement and pinned the other way
    grids: list = []
    real_grid = engine_mod.execute_grid
    engine_mod.execute_grid = lambda g, *a, **k: (
        grids.append(g.device.type), real_grid(g, *a, **k))[1]
    try:
        for label, m, s_want, g_want in EDGE_CASES:
            sub = parse_uri_subquery(m)
            tq = TSQuery(start=window[0], end=window[1],
                         queries=[sub]).validate()
            sel = np.ones(n, dtype=bool)
            for f in sub.filters:
                col = np.array([tg[f.tagk] for tg in tags])
                if f.filter_name == "literal_or":
                    sel &= np.isin(col, f.filter_expr.split("|"))
                elif f.filter_name == "not_literal_or":
                    sel &= ~np.isin(col, f.filter_expr.split("|"))
            rows_i = np.flatnonzero(sel)
            check(len(rows_i) == s_want, f"{label}: {len(rows_i)} series")
            grp = (np.array([int(tags[i]["grp"][1:]) for i in rows_i])
                   if g_want > 1 else np.zeros(len(rows_i), dtype=int))
            keys_g = sorted(set(grp.tolist()))
            check(len(keys_g) == g_want, f"{label}: {len(keys_g)} groups")
            x = edge_vals[rows_i]
            if sub.agg.name == "sum":
                want = np.stack([x[grp == k].sum(axis=0) for k in keys_g])
                tol = TOL_REL * np.stack([np.abs(x[grp == k]).sum(axis=0)
                                          for k in keys_g]) + TOL_ABS
            else:
                want = np.stack([legacy_percentile(x[grp == k], 99.0)
                                 for k in keys_g])
                tol = TOL_REL * np.abs(want) + TOL_ABS
            host = host_tail_for_dims(Config(), s_want, p, g_want, False,
                                      sub.agg.name) is not None
            check(host == label.endswith("under"),
                  f"{label}: placed on the {'host' if host else 'card'}")
            res = {}
            for how, pin in (("default", {}),
                             ("pinned", HOST_TAIL_OFF if host
                              else HOST_PINNED)):
                on_host = host if how == "default" else not host
                for k_, v_ in pin.items():
                    small.config.override_config(k_, v_)
                grids.clear()
                rows = small.execute_query(tq)      # warm-up
                e2e, tails = [], []
                for _ in range(REPEATS):
                    rows, secs, st = _stats_run(small, tq)
                    e2e.append(secs)
                    tails.append(st.get("computeTime", 0.0))
                for k_ in pin:
                    small.config.override_config(k_,
                                                 Config().get_string(k_))
                check(set(grids) == {"cpu" if on_host else "cuda"},
                      f"{label} {how}: the tail ran on {set(grids)}")
                check(len(rows) == g_want, f"{label}: {len(rows)} rows")
                got = np.stack([r.dps_arrays[1] for r in sorted(
                    rows, key=lambda r: int(r.tags.get("grp", "g0")[1:]))])
                check(got.shape == want.shape, f"{label}: {got.shape}")
                err = np.abs(got - want)
                check(bool((err <= tol).all()),
                      f"{label} {how}: max |d| {err.max()!r} past the "
                      "tolerance")
                res[how] = (got, p50(e2e), p50(tails), on_host, err.max())
            a, b = res["default"][0], res["pinned"][0]
            check(bool((np.abs(a - b) <= 2 * tol).all()),
                  f"{label}: default and pinned answers differ")
            d, q = res["default"], res["pinned"]
            print(f"  (a) {label}: {m} S={s_want} B={p} G={g_want}: "
                  f"{'host' if d[3] else 'card'} by default p50 "
                  f"{d[1] * 1e3:.3f} ms (tail {d[2]:.3f} ms), "
                  f"{'host' if q[3] else 'card'} pinned p50 "
                  f"{q[1] * 1e3:.3f} ms (tail {q[2]:.3f} ms); "
                  f"max |d| vs numpy float64 {d[4]!r} / {q[4]!r}")
            out.setdefault("edges", []).append({
                "case": label, "series": s_want, "groups": g_want,
                "default": "host" if d[3] else "card",
                "default_ms": d[1] * 1e3, "default_tail_ms": d[2],
                "pinned_ms": q[1] * 1e3, "pinned_tail_ms": q[2]})
    finally:
        engine_mod.execute_grid = real_grid

    # (b) the breaker on the card: failures answered 500 and counted,
    # past the threshold a 503 with Retry-After and no dispatch, the
    # probe closes it after the reset window
    router = HttpRpcRouter(small)
    params = {"start": [window[0]], "end": [window[1]],
              "m": ["sum:1m-avg:edge.m"]}

    def get():
        t0 = time.perf_counter()
        r = router.handle(HttpRequest("GET", "/api/query", dict(params)))
        return r, time.perf_counter() - t0

    br = small.device_breaker
    small.faults.arm("device.compile", error_count=2)
    site = small.faults._sites["device.compile"]
    codes = [get()[0].status for _ in range(2)]
    check(codes == [500, 500] and br.total_failures == 2,
          f"(b) failures answered {codes}, counted {br.total_failures}")
    check(br.state == br.OPEN, f"(b) breaker {br.state} after 2 failures")
    calls = site.calls
    shed = [get() for _ in range(REPEATS)]
    check(all(r.status == 503 and r.headers.get("Retry-After")
              for r, _ in shed), "(b) an open breaker did not answer 503 "
          "with Retry-After")
    check(site.calls == calls, "(b) a shed query reached the device")
    time.sleep(SURF_BREAKER_RESET_MS / 1000 + 0.2)
    probe, probe_s = get()
    check(probe.status == 200 and br.state == br.CLOSED
          and br.recoveries == 1, f"(b) the probe answered "
          f"{probe.status}, breaker {br.state}")
    out["breaker_503_ms"] = p50([s for _, s in shed]) * 1e3
    print(f"  (b) breaker: 2 injected device.compile failures answered "
          f"500 and counted; then {REPEATS} queries 503 with Retry-After "
          f"{shed[0][0].headers['Retry-After']} s, no dispatch, p50 "
          f"{out['breaker_503_ms']:.3f} ms; after "
          f"{SURF_BREAKER_RESET_MS} ms the probe answered 200 in "
          f"{probe_s * 1e3:.3f} ms and closed the breaker")

    # (c) /api/query/exp and /gexp over config-3 sub-queries on K1
    for k_, v_ in ENGINE_KEYS.items():
        tsdb.config.override_config(k_, v_)
    r3 = HttpRpcRouter(tsdb)
    nb = (SURF_WINDOW[1] - SURF_WINDOW[0] + 1) // 300
    a_ref, a_terms = config3_window(values, "avg", "dc", nb)
    b_ref, b_terms = config3_window(values, "max", "dc", nb)
    body = {"time": {"start": str(SURF_WINDOW[0]),
                     "end": str(SURF_WINDOW[1]), "aggregator": "sum",
                     "downsampler": {"interval": "5m", "aggregator": "avg"},
                     "rate": True},
            "filters": [{"id": "f", "tags": [{"type": "wildcard",
                                              "tagk": "dc", "filter": "*",
                                              "groupBy": True}]}],
            "metrics": [{"id": "a", "metric": METRIC, "filter": "f"},
                        {"id": "b", "metric": METRIC, "filter": "f",
                         "downsampler": {"interval": "5m",
                                         "aggregator": "max"}}],
            "expressions": [{"id": "e", "expr": "a / b * 100"}],
            "outputs": [{"id": "e"}]}
    raw = json.dumps(body).encode()
    reset_launches(fused)
    exp_s = []
    for _ in range(SURF_REPEATS):
        t0 = time.perf_counter()
        resp = r3.handle(HttpRequest("POST", "/api/query/exp", body=raw))
        exp_s.append(time.perf_counter() - t0)
        check(resp.status == 200, f"(c) /exp answered {resp.status}: "
              f"{resp.body[:300]!r}")
    exp_launch = read_launches(fused)
    check(exp_launch["span_reduce"] == 2 * SURF_REPEATS,
          f"(c) /exp launched {exp_launch}, not K1 twice a call")
    o = json.loads(resp.body)["outputs"][0]
    cols = [int(mm["commonTags"]["dc"][2:]) for mm in o["meta"][1:]]
    check(sorted(cols) == list(range(100)), "(c) /exp lost a dc")
    got = np.array([[np.nan if v is None else v for v in row[1:]]
                    for row in o["dps"]], dtype=np.float64).T[
        np.argsort(cols)]
    want = a_ref / b_ref * 100.0
    ta, tb = TOL_REL * a_terms + TOL_ABS, TOL_REL * b_terms + TOL_ABS
    tol = 1.01 * 100.0 * (ta / np.abs(b_ref)
                          + np.abs(a_ref) * tb / b_ref ** 2)
    check(got.shape == want.shape, f"(c) /exp shape {got.shape}")
    err = np.abs(got - want)
    check(bool((err <= tol).all()), f"(c) /exp max |d| {err.max()!r}")
    out["exp_p50_ms"] = p50(exp_s) * 1e3
    reset_launches(fused)
    gq = {"exp": [f"scale(sum:5m-avg:rate:{METRIC}{{dc=*}},100)"],
          "start": [str(SURF_WINDOW[0])], "end": [str(SURF_WINDOW[1])]}
    gexp_s = []
    for _ in range(SURF_REPEATS):
        t0 = time.perf_counter()
        gresp = r3.handle(HttpRequest("GET", "/api/query/gexp", gq))
        gexp_s.append(time.perf_counter() - t0)
        check(gresp.status == 200, f"(c) /gexp answered {gresp.status}")
    gexp_launch = read_launches(fused)
    check(gexp_launch["span_reduce"] == SURF_REPEATS,
          f"(c) /gexp launched {gexp_launch}")
    grows = json.loads(gresp.body)
    gidx = [int(r["tags"]["dc"][2:]) for r in grows]
    gvals = np.array([list(r["dps"].values()) for r in grows])[
        np.argsort(gidx)]
    gerr = np.abs(gvals - 100.0 * a_ref)
    check(bool((gerr <= 100.0 * ta).all()),
          f"(c) /gexp max |d| {gerr.max()!r}")
    print(f"  (c) /api/query/exp 'a / b * 100' (a sum:5m-avg:rate, b "
          f"sum:5m-max:rate, by dc, {nb} buckets): p50 "
          f"{out['exp_p50_ms']:.3f} ms of {SURF_REPEATS}, K1 launched "
          f"{exp_launch['span_reduce']} times, max |d| vs numpy float64 "
          f"{err.max()!r}; /gexp scale(...,100): p50 "
          f"{p50(gexp_s) * 1e3:.3f} ms, K1 {gexp_launch['span_reduce']}, "
          f"max |d| {gerr.max()!r}")

    # (d) an M4 pixel budget over raw series of an hour at 1 s
    def px_query(agg: str, px: int):
        obj = {"start": str(T0), "end": str(T0 + PX_POINTS - 1),
               "queries": [{"aggregator": agg, "metric": "px.raw",
                            "filters": [{"type": "wildcard",
                                         "tagk": "host", "filter": "*",
                                         "groupBy": True}]}]}
        if px:
            obj["queries"][0]["pixels"] = px
        return TSQuery.from_json(obj).validate()

    (full,), full_s = timed(lambda: [small.execute_query(
        px_query("none", 0))], REPEATS)
    (red,), red_s = timed(lambda: [small.execute_query(
        px_query("none", PX_BUDGET))], REPEATS)
    check(len(full) == len(red) == PX_SERIES, "(d) rows lost")
    kept_pts = 0
    for f_row, r_row in zip(full, red):
        ts, v = f_row.dps_arrays
        naive = vd.naive_m4_reference(ts, v, np.ones(len(ts), dtype=bool),
                                      T0 * 1000, (T0 + PX_POINTS - 1) * 1000,
                                      PX_BUDGET)
        idx = np.searchsorted(ts, r_row.dps_arrays[0])
        check(set(idx.tolist()) == naive and bool(
            np.array_equal(r_row.dps_arrays[1].view(np.int64),
                           v[idx].view(np.int64))),
              f"(d) {f_row.tags}: M4 kept set differs from the naive "
              "reference")
        kept_pts += len(idx)
    grid_v = np.stack([r.dps_arrays[1] for r in full])
    _, m4_s = timed(lambda: vd.keep_mask(
        grid_v, np.ones(grid_v.shape, dtype=bool), full[0].dps_arrays[0],
        T0 * 1000, (T0 + PX_POINTS - 1) * 1000, PX_BUDGET, "m4"), REPEATS)
    out["m4_ms"] = p50(m4_s) * 1e3
    print(f"  (d) none:px.raw{{host=*}} pixels={PX_BUDGET}: "
          f"{kept_pts:,} of {PX_SERIES * PX_POINTS:,} points kept, every "
          f"row's kept set equal to naive_m4_reference and its values bit "
          f"for bit; query p50 {p50(red_s) * 1e3:.3f} ms against "
          f"{p50(full_s) * 1e3:.3f} ms at full resolution; the M4 pass "
          f"over [{PX_SERIES}, {PX_POINTS}] {out['m4_ms']:.3f} ms")

    # (e) 100 tsuids on phase 3's TSDB (K1), then a delete=true, read back
    store = tsdb.store
    mid3 = tsdb.uids.metrics.get_id(METRIC)
    n3 = values.shape[0]
    rows_t = [(9973 * k) % n3 for k in range(TSUID_SERIES)]
    all_sids = store.series_ids_for_metric(mid3)
    tsuids = [tsdb.uids.tsuid(mid3, store.series(int(all_sids[i])).tags)
              .hex().upper() for i in rows_t]
    tq = TSQuery.from_json({
        "start": str(SURF_WINDOW[0]), "end": str(SURF_WINDOW[1]),
        "queries": [{"aggregator": "sum", "tsuids": tsuids,
                     "downsample": "5m-avg", "rate": True}]}).validate()
    reset_launches(fused)
    (trows,), tsuid_s = timed(lambda: [tsdb.execute_query(tq)],
                              SURF_REPEATS)
    tl = read_launches(fused)
    check(sum(tl.values()) == SURF_REPEATS,
          f"(e) tsuid query launched {tl}")
    check(len(trows) == 1 and sorted(trows[0].tsuids) == sorted(tsuids),
          "(e) the tsuid answer names other series")
    sub_v = values[rows_t, :nb * 5].reshape(TSUID_SERIES, nb, 5).mean(2)
    t_want = (np.diff(sub_v, axis=1) / 300.0).sum(axis=0)
    t_terms = ((np.abs(sub_v[:, 1:]) + np.abs(sub_v[:, :-1])) / 300.0) \
        .sum(axis=0)
    t_err = np.abs(trows[0].dps_arrays[1] - t_want)
    check(bool((t_err <= TOL_REL * t_terms + TOL_ABS).all()),
          f"(e) tsuid answer max |d| {t_err.max()!r}")
    # the delete: host h0 of px.raw over its first 10 minutes
    dbody = json.dumps({"start": str(T0), "end": str(T0 + DELETE_S - 1),
                        "delete": True, "queries": [{
                            "aggregator": "sum", "metric": "px.raw",
                            "tags": {"host": "h0"}}]}).encode()
    h0 = np.array([psids[0]])
    before = small.store.count_range(psids, T0 * 1000,
                                     (T0 + PX_POINTS) * 1000)
    dresp = router.handle(HttpRequest("POST", "/api/query", body=dbody))
    check(dresp.status == 200, f"(e) delete answered {dresp.status}")
    dvals = np.array(list(json.loads(dresp.body)[0]["dps"].values()))
    check(bool(np.allclose(dvals, px_vals[0, :DELETE_S], rtol=TOL_REL,
                           atol=TOL_ABS)), "(e) the delete's answer is not "
          "the points it removed")
    after = small.store.count_range(psids, T0 * 1000,
                                    (T0 + PX_POINTS) * 1000)
    check(int(small.store.count_range(h0, T0 * 1000,
                                      (T0 + DELETE_S) * 1000 - 1)[0]) == 0
          and int(after[0]) == PX_POINTS - DELETE_S
          and bool(np.array_equal(after[1:], before[1:])),
          f"(e) read back after the delete: {after[:3]}")
    again = small.execute_query(TSQuery.from_json(
        {**json.loads(dbody), "delete": False}).validate())
    check(again == [], "(e) the deleted range still answers")
    print(f"  (e) {TSUID_SERIES} tsuids of config 3 (sum:5m-avg:rate): p50 "
          f"{p50(tsuid_s) * 1e3:.3f} ms, launches {tl}, max |d| vs numpy "
          f"float64 {t_err.max()!r}; delete=true of px.raw h0 over "
          f"{DELETE_S} s by POST /api/query answered its {len(dvals)} "
          f"points, then h0 holds {int(after[0])} of {int(before[0])}, "
          "the other series unchanged, the range answers nothing")
    small.shutdown()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 15: {out['phase_s']:.1f} s")
    return {k: exp_launch[k] + gexp_launch[k] + tl[k]
            for k in exp_launch}, out


MESH_SHAPES = ("series:4", "series:2,time:2")
MESH_SHARDS = 4            # phase 16: virtual shards, the one card 4 times
MESH_WINDOW = (T0, T0 + 3299)   # 11 buckets of 5 m, clear of phase 6's write
MESH_BUCKETS = 11
# (d): at 1M series a 4-shard mesh scales the budget to 4M cells, so
# blocks of 4 of the 11 buckets: 3 blocks
MESH_BLOCK_CELLS = "1000000"
MESH_FEW = 8               # (e): series of the multiply query
MESH_CHILD_TIMEOUT_S = 300  # (f): each child's own limit
MESH_CACHE_MB = "4096"     # (a)-(c): room for a cut 1M x 55-point batch

MESH_WORKER = """
import json, sys, time
t0 = time.perf_counter()
root, pid, port, n, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], \\
    int(sys.argv[4]), sys.argv[5]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.parallel import distributed
from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery

card = torch.device("cuda", 0)
t = TSDB(Config(**{
    "tsd.torch.device": "cuda", "tsd.core.auto_create_metrics": "true",
    **cs.ENGINE_KEYS, "tsd.tpu.warmup": "false",
    "tsd.mesh.coordinator": f"127.0.0.1:{port}",
    "tsd.mesh.num_processes": "2", "tsd.mesh.process_id": str(pid),
    "tsd.mesh.init_timeout": "120", "tsd.query.mesh": "series:2,time:2"}),
    mesh_devices=[card] * 2)
assert distributed.process_count() == 2
assert t.query_mesh.local_time == [pid], t.query_mesh.local_time
join_s = time.perf_counter() - t0
tags, ts2d, values = cs.make_data(n)
t1 = time.perf_counter()
t.add_series_points(cs.METRIC, tags, ts2d, values)
ingest_s = time.perf_counter() - t1
single = TSDB(Config(**{"tsd.torch.device": "cuda", **cs.ENGINE_KEYS}))
single.store, single.uids = t.store, t.uids
res = {"join_s": join_s, "ingest_s": ingest_s, "queries": {}}
for m, _ in cs.QUERIES:
    tq = TSQuery(start=str(cs.MESH_WINDOW[0]), end=str(cs.MESH_WINDOW[1]),
                 queries=[parse_uri_subquery(m)]).validate()
    t1 = time.perf_counter()
    rows = t.execute_query(tq)
    res["queries"][m] = {
        "s": time.perf_counter() - t1,
        "mesh": [[r.tags, r.dps_arrays[0].tolist(),
                  r.dps_arrays[1].tolist()] for r in rows],
        "single": [[r.tags, r.dps_arrays[0].tolist(),
                    r.dps_arrays[1].tolist()]
                   for r in single.execute_query(tq)]}
res["total_s"] = time.perf_counter() - t0
with open(out, "w") as f:
    json.dump(res, f)
print("child", pid, "done", flush=True)
"""


def mesh_reference(values, m: str):
    """A config-3 query over :data:`MESH_WINDOW` in float64 with numpy:
    (tag key, tag value prefix, [G, B - 1] answer, [G, B - 1] sum|terms|)
    as :func:`held_to_reference` reads it."""
    key, prefix = ("dc", "dc") if "{dc=*}" in m else ("rack", "r")
    return (key, prefix) + config3_window(values, "avg", key, MESH_BUCKETS)


def emits_equal(rows_a, rows_b) -> bool:
    """Two answers hold the same groups and timestamps: their emit masks
    are equal."""
    import numpy as np
    return len(rows_a) == len(rows_b) and all(
        a.tags == b.tags and np.array_equal(a.dps_arrays[0],
                                            b.dps_arrays[0])
        for a, b in zip(rows_a, rows_b))


def start_mesh_children(n: int) -> tuple:
    """Phase 16 (f): start two processes on the one card, to join on
    gloo, each holding ``n`` series of config 3 and a
    ``series:2,time:2`` mesh over ``[cuda:0] * 2``. Returns what
    :func:`finish_mesh_children` reads."""
    import socket
    import tempfile
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmp = Path(tempfile.mkdtemp(prefix="mesh16-"))
    script = tmp / "child.py"
    script.write_text(MESH_WORKER)
    outs = [tmp / f"out{i}.json" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(ROOT), str(i), str(port), str(n),
         str(outs[i])], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    return procs, outs, time.perf_counter()


def finish_mesh_children(started: tuple) -> list:
    """Wait for the children of :func:`start_mesh_children`, each under
    its own timeout from its start (past it every child is killed and
    the phase fails). Returns each child's answers and times."""
    procs, outs, t0 = started
    logs = []
    for p in procs:
        left = MESH_CHILD_TIMEOUT_S - (time.perf_counter() - t0)
        try:
            logs.append(p.communicate(timeout=max(left, 1.0))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise SmokeFailure(f"(f) a child ran past "
                               f"{MESH_CHILD_TIMEOUT_S} s and was killed")
    for p, log in zip(procs, logs):
        check(p.returncode == 0,
              f"(f) a child exited {p.returncode}: {log[-3000:]}")
    kids = [json.loads(o.read_text()) for o in outs]
    shutil.rmtree(outs[0].parent, ignore_errors=True)
    return kids


def phase_mesh(torch, tsdb, values, profile: bool = False) -> dict:
    """Phase 16: the query mesh on one card. Facades over phase 3's
    store with ``tsd.query.mesh`` at ``series:4`` and
    ``series:2,time:2`` over ``[cuda:0] * 4``: (a) the sharded point
    path (``grid_reduce=false``), cold calls and a prepared-batch hit;
    (b) the sharded grid path, two cold calls and a grid-cache hit;
    (c) the sharded blocked path in 3 blocks; each for both group-bys,
    held to the float64 numpy reference at phase 3's tolerance, with the
    single-card path's emit masks; (d) a p99 (histogram estimator)
    and (e) a multiply (all-gather) query over a few series; (f) two
    processes on the card
    joined on gloo with the time axis across them. With ``profile``,
    the device's idle share of a cold point and grid call by ``dc``
    per shape. Returns the ``mesh`` JSON line's readings."""
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.parallel import sharded_pipeline as sp
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    t_phase = time.perf_counter()
    n = values.shape[0]
    card = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    start, end = str(MESH_WINDOW[0]), str(MESH_WINDOW[1])

    def query(m: str):
        return TSQuery(start=start, end=end,
                       queries=[parse_uri_subquery(m)]).validate()

    def facade(shape: str, keys: dict):
        f = TSDB(Config(**{"tsd.torch.device": "cuda",
                           "tsd.query.cache.enable": "false",
                           "tsd.tpu.warmup": "false",
                           "tsd.query.mesh": shape, **keys}),
                 mesh_devices=[card] * MESH_SHARDS)
        f.store, f.uids = tsdb.store, tsdb.uids
        return f

    # (f) starts first and runs beside (a)-(e): the times of both share
    # the host's CPUs
    cut = max(1, n // STORE_CUT)
    children = start_mesh_children(cut)
    t = time.perf_counter()
    refs = {m: mesh_reference(values, m) for m, _ in QUERIES}
    print(f"  window {start}..{end} ({MESH_BUCKETS} buckets of 5 m, clear "
          f"of phase 6's write); float64 numpy references "
          f"{time.perf_counter() - t:.3f} s")
    # the single-card path on the same window: phase 3's TSDB and keys
    single = {}
    for m, _ in QUERIES:
        single[m], secs, st = _stats_run(tsdb, query(m))
        err = held_to_reference(single[m], refs[m])
        print(f"  single card {m}: {_stage_line([secs], [st])} ms; max |d| "
              f"vs float64 {err!r}")
    out: dict = {"shards": MESH_SHARDS, "card": name, "series": n,
                 "shapes": {}}
    point_keys = {**ENGINE_KEYS, "tsd.query.device_cache_mb": MESH_CACHE_MB}
    grid_keys = {**HOST_TAIL_OFF,
                 "tsd.query.device_cache_mb": MESH_CACHE_MB}
    blocked_keys = {**ENGINE_KEYS,
                    "tsd.query.max_device_cells": MESH_BLOCK_CELLS}
    for shape in MESH_SHAPES:
        point, grid = facade(shape, point_keys), facade(shape, grid_keys)
        blocked = facade(shape, blocked_keys)
        shape_out = out["shapes"][shape] = {}
        for m, _ in QUERIES:
            tq = query(m)
            row: dict = {}
            # (a) the point path: cold calls (two by dc), then the hit
            runs0 = sp.run_sharded_device.runs
            cold = []
            for _ in range(2 if "{dc=*}" in m else 1):
                point.drop_caches()
                cold.append(_stats_run(point, tq))
            hits0 = point.device_grid_cache.hits
            warm = _stats_run(point, tq)
            check(point.device_grid_cache.hits == hits0 + 1,
                  f"(a) {shape} {m}: the repeat missed the device cache")
            check(sp.run_sharded_device.runs == runs0 + len(cold) + 1,
                  f"(a) {shape} {m}: the sharded point step did not run")
            check(same_bits(cold[0][0], cold[-1][0]),
                  f"(a) {shape} {m}: two cold calls differ in their bits")
            check(same_bits(cold[0][0], warm[0]),
                  f"(a) {shape} {m}: the prepared-batch hit differs")
            row["point_err"] = held_to_reference(cold[0][0], refs[m])
            check(emits_equal(cold[0][0], single[m]),
                  f"(a) {shape} {m}: emit masks differ from one card's")
            row["point_cold_s"] = [c[1] for c in cold]
            row["prepared_hit_s"] = warm[1]
            point_rows = cold[0][0]
            cold_line = _stage_line([c[1] for c in cold],
                                    [c[2] for c in cold])
            print(f"  {shape} (a) point {m}: cold {cold_line} ms; "
                  f"prepared hit {warm[1] * 1e3:.3f} ms; {len(cold)} cold "
                  f"call(s) and the hit bit-equal; max |d| vs float64 "
                  f"{row['point_err']!r}; emit masks = one card's")
            # (b) the grid path: cold calls (two by dc), then the
            # cached grid
            runs0 = sp.run_sharded_grid.runs
            cold = []
            for _ in range(2 if "{dc=*}" in m else 1):
                grid.drop_caches()
                cold.append(_stats_run(grid, tq))
            warm = _stats_run(grid, tq)
            check(sp.run_sharded_grid.runs == runs0 + len(cold) + 1,
                  f"(b) {shape} {m}: the sharded grid step did not run")
            check(same_bits(cold[0][0], cold[-1][0])
                  and same_bits(cold[0][0], warm[0]),
                  f"(b) {shape} {m}: cold, cold and warm differ")
            row["grid_err"] = held_to_reference(cold[0][0], refs[m])
            check(emits_equal(cold[0][0], single[m]),
                  f"(b) {shape} {m}: emit masks differ from one card's")
            row["grid_cold_s"] = [c[1] for c in cold]
            row["grid_warm_s"] = warm[1]
            cold_line = _stage_line([c[1] for c in cold],
                                    [c[2] for c in cold])
            print(f"  {shape} (b) grid {m}: cold {cold_line} ms; "
                  f"warm {warm[1] * 1e3:.3f} ms; bit-equal; max |d| vs "
                  f"float64 {row['grid_err']!r}")
            shape_out[m] = row
            # (c) the blocked path: by dc on the first shape, by rack on
            # the second
            if ("{dc=*}" in m) != (shape == MESH_SHAPES[0]):
                continue
            b0 = sp.execute_blocked_sharded.blocks
            rows, secs, st = _stats_run(blocked, tq)
            row["blocks"] = sp.execute_blocked_sharded.blocks - b0
            check(2 <= row["blocks"] <= 3,
                  f"(c) {shape} {m}: {row['blocks']} blocks, not 2-3")
            row["blocked_err"] = held_to_reference(rows, refs[m])
            check(emits_equal(rows, single[m]),
                  f"(c) {shape} {m}: emit masks differ from one card's")
            row["blocked_s"] = secs
            print(f"  {shape} (c) blocked {m}: {row['blocks']} blocks, "
                  f"{_stage_line([secs], [st])} ms; max |d| vs float64 "
                  f"{row['blocked_err']!r}; bit-equal to (a) "
                  f"{same_bits(rows, point_rows)}")
        if profile:
            m = QUERIES[0][0]
            tq = query(m)
            for f, path in ((point, "point"), (grid, "grid")):
                f.drop_caches()
                device_share(torch, lambda: f.execute_query(tq),
                             f"{shape} {path} cold {m}")
        # (d) p99 by dc on the grid path: the histogram estimator
        cells = values[:, :MESH_BUCKETS * 5].reshape(
            n, MESH_BUCKETS, 5).mean(axis=2)
        m = "p99:5m-avg:sys.cpu.user{dc=*}"
        rows, secs, _ = _stats_run(grid, query(m))
        idx = [int(r.tags["dc"][2:]) for r in rows]
        check(sorted(idx) == list(range(min(n, 100))),
              f"(d) {shape}: {len(idx)} groups")
        worst = 0.0
        for r, g in zip(rows, idx):
            mine = cells[g::100]
            exact = legacy_percentile(mine, 99.0)
            bound = 2.0 * (mine.max(axis=0) - mine.min(axis=0)) \
                / sp.PERCENTILE_BINS + TOL_ABS
            d = np.abs(r.dps_arrays[1] - exact)
            check(bool((d <= bound).all()),
                  f"(d) {shape} p99 dc{g}: |d| {d.max()!r} past the "
                  f"estimator's bound {bound.min()!r}")
            worst = max(worst, float(d.max()))
        print(f"  {shape} (d) {m}: {secs * 1e3:.3f} ms cold on the grid "
              f"path; max |d| vs the exact float64 order statistic "
              f"{worst!r}, within 2 x range / {sp.PERCENTILE_BINS}")
        out["shapes"][shape]["p99"] = {"s": secs, "max_abs_err": worst}
        # (e) multiply on the point path, over a TSDB of config 3's
        # first few series (a product of 1M values overflows)
        few = TSDB(Config(**{"tsd.torch.device": "cuda",
                             "tsd.core.auto_create_metrics": "true",
                             "tsd.tpu.warmup": "false",
                             "tsd.query.mesh": shape, **ENGINE_KEYS}),
                   mesh_devices=[card] * MESH_SHARDS)
        few.add_series_points(METRIC, *make_data(MESH_FEW))
        m = "multiply:5m-avg:sys.cpu.user"
        runs0 = sp.run_sharded_device.runs
        rows, secs, _ = _stats_run(few, query(m))
        check(sp.run_sharded_device.runs == runs0 + 1,
              f"(e) {shape}: the sharded point step did not run")
        few.shutdown()
        want = np.prod(cells[:MESH_FEW], axis=0)
        check(len(rows) == 1, f"(e) {shape}: {len(rows)} groups")
        rel = float(np.max(np.abs(rows[0].dps_arrays[1] - want) / want))
        check(rel <= TOL_REL, f"(e) {shape} multiply: relative error "
              f"{rel!r}")
        print(f"  {shape} (e) {m} over {MESH_FEW} series: "
              f"{secs * 1e3:.3f} ms; max relative |d| vs float64 {rel!r}")
        out["shapes"][shape]["multiply"] = {"s": secs, "max_rel_err": rel}
        for f in (point, grid, blocked):
            f.shutdown()

    # (f) two processes on the card, the time axis across them
    kids = finish_mesh_children(children)
    kid_s = time.perf_counter() - children[2]
    sub_vals = values[:cut]
    for m, _ in QUERIES:
        a, b = (k["queries"][m] for k in kids)
        check(a["mesh"] == b["mesh"],
              f"(f) {m}: the two processes' answers differ")
        key, prefix, want, terms = mesh_reference(sub_vals, m)
        got = np.asarray([r[2] for r in a["mesh"]])
        idx = [int(r[0][key][len(prefix):]) for r in a["mesh"]]
        check(sorted(idx) == list(range(len(want))),
              f"(f) {m}: {len(idx)} groups")
        err = compare(torch.as_tensor(got), torch.as_tensor(want[idx]),
                      torch.as_tensor(terms[idx]))
        check([r[:2] for r in a["mesh"]] == [r[:2] for r in a["single"]],
              f"(f) {m}: emit masks differ from the single-card path's")
        one = compare(torch.as_tensor(got),
                      torch.as_tensor(np.asarray([r[2] for r in
                                                  a["single"]])),
                      torch.as_tensor(terms[idx]))
        print(f"  (f) {m}: 2 processes x series:2,time:2 on [cuda:0] * 2 "
              f"each, {cut} series (STORE_CUT): the processes' answers "
              f"bit-equal; cold {a['s']:.3f} and {b['s']:.3f} s; max |d| "
              f"vs float64 "
              f"{err!r}, vs the single-card path {one!r}")
    print(f"  (f) children (run beside (a)-(e)): join "
          f"{kids[0]['join_s']:.3f}/{kids[1]['join_s']:.3f} s, ingest "
          f"{kids[0]['ingest_s']:.3f}/{kids[1]['ingest_s']:.3f} s, whole "
          f"child {kids[0]['total_s']:.3f}/{kids[1]['total_s']:.3f} s; "
          f"collected {kid_s:.3f} s after their start")
    out["two_process"] = {"series": cut,
                          "child_s": [k["total_s"] for k in kids],
                          "query_s": {m: [k["queries"][m]["s"]
                                          for k in kids]
                                      for m, _ in QUERIES}}
    print(f"  {MESH_SHARDS} shards on one {name}, no multi-card scaling "
          "shown")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 16: {out['phase_s']:.1f} s")
    return out


def p50(xs) -> float:
    return statistics.median(xs)


def serve_pinned(server_thread, tsdb):
    """Start the TSD server on ``tsdb`` with ``tsd.tpu.warmup=false``:
    a phase that times the server keeps the warmup off the card."""
    tsdb.config.override_config("tsd.tpu.warmup", "false")
    return server_thread(tsdb, host="127.0.0.1", port=0).start()


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
    t_run = time.perf_counter()

    def header(text: str) -> None:
        print(f"{text} [{time.perf_counter() - t_run:.1f} s into the run]")

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
    from opentsdb_tpu_torch.native import _build as _native_build
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
    print(f"host cpu: {host_cpu()}, {os.cpu_count()} logical CPUs")
    # the native store's g++ build runs while nvcc builds the kernels
    native_s: list = []
    native_err: list = []

    def build_native() -> None:
        t = time.perf_counter()
        try:
            _native_build.library()
        except Exception as e:  # noqa: BLE001 - re-raised below
            native_err.append(e)
        native_s.append(time.perf_counter() - t)

    g_plus_plus = threading.Thread(target=build_native)
    g_plus_plus.start()
    t = time.perf_counter()
    _cuda_build.library()
    print(f"kernel build+load: {time.perf_counter() - t:.3f} s "
          f"({_cuda_build.library_path().name})")
    g_plus_plus.join()
    if native_err:
        raise native_err[0]
    print(f"native store build+load: {native_s[0]:.3f} s "
          f"({_native_build.library_path().name}, "
          f"{_native_build.compiler()} {' '.join(_native_build.CXX_FLAGS)})")
    log = _cuda_build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                print("  ptxas:", line.strip())

    header("phase 2: kernels vs plain on the card "
           f"(|k - p| <= {TOL_REL}*sum|terms| + {TOL_ABS})")
    phase_sweep(torch, fused, PipelineSpec)
    rate = next(r for key, r in _MEM_RATE if key in name)
    read_ms = plain_read(torch, rate)

    s = args.series
    header(f"phase 3: main path, {s} series x {POINTS} points"
           + ("" if s == 1_000_000 else " (CUT from 1,000,000)"))
    tsdb = TSDB(Config(**{"tsd.torch.device": "cuda",
                          "tsd.core.auto_create_metrics": "true",
                          **ENGINE_KEYS}))
    check(tsdb.store.backend == "native",
          "phases 3-8 run on the default store, the native one")
    print(f"  store: tsd.storage.backend={tsdb.store.backend} (the "
          "default)")
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

    # phases 3-6, 8 and 15 (c)/(e) query this data: config 3's dims
    for m, _ in QUERIES:
        placement(m, s, POINTS // 5, min(s, 100 if "{dc=*}" in m else 2000))

    # the main path: counts reset just before, read just after
    reset_launches(fused)
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
    launches = read_launches(fused)
    if args.profile:
        for m, _ in QUERIES:
            device_share(torch, lambda: tsdb.execute_query(query(m)), m)
    print(f"  main-path launches: {launches}")
    for kname, n in launches.items():
        check(n > 0, f"{kname} was never launched on the main path")

    report, ref3 = {}, {}
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
        if batch.spans is not None:
            # config 3's dc ids (i % 100) are unsorted: the span kernel
            # must read its rows through the permutation, not in place
            check(batch.order is not None,
                  "the span batch carries no group-sort permutation")
        res, emit = pipeline.execute_auto(padded, bidx, bts, gids, spec,
                                          None, dtype=torch.float32,
                                          device="cuda")
        check(res.is_cuda and emit.is_cuda, "results are not on cuda")
        cm, rv = float(2**64 - 1), 0.0
        _, err, _ = kernel_vs_plain(fused, spec, vals, bts, gids, k, cm,
                                    rv, allow_span=True)
        # the engine's answer against the plain version's
        acc_p = fused.plain_reduce(batch, spec, k, cm, rv, exact=True)
        terms = fused.plain_reduce(batch, spec, k, cm, rv, exact=True,
                                   magnitude=True)
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
        ref3[m] = (want.cpu()[:, 1:], terms.cpu()[:, 1:])

        # the span path gathers nothing: its device time is the kernel's
        if batch.spans is not None:
            run = (lambda: fused.span_reduce(
                batch.values, batch.order, batch.gids, batch.spans,
                batch.group_start, batch.inv_dt, spec, k, cm, rv))
        else:
            run = (lambda: fused.onehot_reduce(
                batch.values, batch.order, batch.gids, batch.group_start,
                batch.inv_dt, spec, k, cm, rv))
        ms = cuda_ms(run, 10)
        repro = {kname: repeat_reading(torch, run)}
        if batch.spans is not None:
            # the same rows and groups on the one-hot layout
            oh = fused.prepare(vals, bts, gids, spec, allow_span=False)
            repro["onehot_reduce, one-hot layout forced"] = \
                repeat_reading(torch, lambda: fused.onehot_reduce(
                    oh.values, oh.order, oh.gids, oh.group_start,
                    oh.inv_dt, spec, k, cm, rv))
        print(f"  {m}: {REPRO_LAUNCHES} launches against the first: "
              + "; ".join(f"{n} max |d| {d!r}, bit-equal {same}"
                          for n, (d, same) in repro.items()))
        for n, (_, same) in repro.items():
            check(same, f"{n}: {REPRO_LAUNCHES} launches on the same "
                  "inputs differ in their bits")
        # the plain version as the wrapper runs it for CPU tensors
        # (float32 sums; the span batch's rows reordered first)
        plain_ms = cuda_ms(
            lambda: fused.plain_reduce(batch, spec, k, cm, rv), 10)
        n_s, p = batch.values.shape
        # values, ids, 1/dt, group starts and out; the span kernel also
        # reads its spans, and both the permutation
        nbytes = n_s * p * 4 + n_s * 4 + b * 4 + (g + 1) * 4 + g * b * 4
        if batch.spans is not None:
            nbytes += batch.spans.numel() * 4
        if batch.order is not None:
            nbytes += batch.order.numel() * 4
        flops = n_s * p + n_s * b * 8
        bound_ms = max(nbytes / rate, flops / F32_PEAK) * 1e3
        bound_by = "bytes" if nbytes / rate >= flops / F32_PEAK \
            else "operations"
        e2e_p50 = p50(e2e[m])
        stages = (("plan", plan_t), ("materialize", mat_t),
                  ("assign", assign_t), ("upload", up_t),
                  ("prepare", prep_t),
                  ("kernel+finalize", run_t), ("assemble", asm_t))
        print(f"  {m}: p50 ms: " + ", ".join(
            f"{n} {p50(v) * 1e3:.3f}" for n, v in stages)
            + f"; sum {sum(p50(v) for _, v in stages) * 1e3:.3f}")
        print(f"  {m}: kernel {ms:.4f} ms, gather_ms null (no gather: "
              "the device time is the kernel's) (bound "
              f"{bound_ms:.4f} ms at "
              f"{rate / 1e12:.2f} TB/s), plain {plain_ms:.4f} ms "
              "(CUDA events); end-to-end query p50 "
              f"{e2e_p50 * 1e3:.3f} ms ({n_points / e2e_p50:,.0f} "
              "points/s)")
        report[kname] = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "max_abs_err": err}

    header(f"phase 4: grid path at the default engine keys but the "
           "result cache, same data "
           f"(|got - want| <= {TOL_REL}*sum|terms| + {TOL_ABS})")
    phase_grid(torch, tsdb, query, args.profile)
    header("phase 5: prepared-batch cache (tsd.query.grid_reduce=false)")
    for kname, n in phase_prepared(torch, tsdb, query, ref3).items():
        launches[kname] += n
    # phase 8 runs here, on phase 3's data before phase 6 writes a point
    # that makes one series irregular (the kernels need regular rows)
    header("phase 8: the front end on the card (TSDServer, HTTP and "
           "telnet over sockets)")
    for kname, n in phase_front_end(torch, tsdb, query, ref3,
                                    args.profile).items():
        launches[kname] += n
    header("phase 6: the serve path at the default keys (result cache, "
           "tag-matrix cache, sub-query fan-out)")
    for kname, n in phase_serve(torch, tsdb, query, ref3,
                                tags[-1]).items():
        launches[kname] += n
    # phase 15 runs here, on phase 3's TSDB before it goes
    header("phase 15: dashboard surfaces (the host tail's budget edges, "
           "the device breaker, /api/query/exp and /gexp, a pixel budget, "
           f"tsuids and delete) (|got - want| <= {TOL_REL}*sum|terms| + "
           f"{TOL_ABS})")
    surf_launches, surfaces = phase_surfaces(torch, tsdb, values, query)
    for kname, n in surf_launches.items():
        launches[kname] += n
    # phase 16 runs here too, on phase 3's store before the TSDB goes
    header(f"phase 16: the query mesh on one card, {MESH_SHARDS} virtual "
           f"shards ({' and '.join(MESH_SHAPES)} over [cuda:0] x "
           f"{MESH_SHARDS}), {s} series x {MESH_BUCKETS} buckets"
           + ("" if s == 1_000_000 else " (CUT from 1,000,000)")
           + f" (|got - want| <= {TOL_REL}*sum|terms| + {TOL_ABS})")
    mesh = phase_mesh(torch, tsdb, values, args.profile)
    tsdb.shutdown()
    del tsdb, tags, ts2d, values
    header(f"phase 7: irregular data, {s} series x {POINTS} slots"
           + ("" if s == 1_000_000 else " (CUT from 1,000,000)")
           + f" (|got - want| <= {TOL_REL}*sum|terms| + {TOL_ABS})")
    for m, _tz, _kind in IRREGULAR_QUERIES:
        b_irr = 4 if "15mc" in m else (12 if "5m-" in m else POINTS * 10)
        placement(m, s, b_irr, min(s, 100 if "{dc=*}" in m else 2000),
                  m.split(":")[0])
    phase_irregular(torch, s, args.profile)
    cut = max(1, s // STORE_CUT)
    header(f"phase 9: storage backends A/B, {cut} series x {POINTS} "
           "points (CUT from 1,000,000), tsd.storage.backend=native then "
           "memory")
    for m, _ in QUERIES:   # phases 9 and 10
        placement(m, cut, POINTS // 5,
                  min(cut, 100 if "{dc=*}" in m else 2000))
    for kname, n in phase_backends(torch, cut, query).items():
        launches[kname] += n
    header(f"phase 10: durability, {cut} series x {POINTS} points (CUT "
           "from 1,000,000), tsd.storage.data_dir on the native store")
    for kname, n in phase_durability(torch, cut, query).items():
        launches[kname] += n
    header(f"phase 11: blocked long ranges, {s} series x {LONG_POINTS} "
           "points" + ("" if s == 1_000_000 else " (CUT from 1,000,000)")
           + f" (|got - want| <= {TOL_REL}*sum|terms| + {TOL_ABS})")
    for m, _carry in LONG_QUERIES:
        placement(m + " (blocked before placement)", s, LONG_POINTS,
                  min(s, 100 if "{dc=*}" in m else 2000))
    phase_long(torch, s, args.profile)
    hn = max(1, s // HIST_CUT)
    header(f"phase 12: histograms, BASELINE config 4, {hn} series (CUT "
           f"from 1,000,000) x {HIST_POINTS} point (depth CUT from 2) x "
           f"{HIST_BUCKETS} buckets")
    hist = phase_histograms(torch, hn, args.profile)
    rn = min(ROLLUP_SERIES, s)
    header(f"phase 13: rollups, BASELINE config 5, {rn} series x "
           f"{ROLLUP_POINTS} points at 1 s (CUT from 100,000)"
           + f" (|got - want| <= {TOL_REL}*sum|terms| + {TOL_ABS})")
    for m, _extra, _k in ROLLUP_QUERIES:
        placement(m, rn, 1 if "1h-" in m else 12,
                  min(rn, 100 if "{dc=*}" in m else 2000), m.split(":")[0])
    rollup_launches, rollup = phase_rollups(torch, rn, args.profile)
    for kname, n in rollup_launches.items():
        launches[kname] += n
    ln = min(LIVE_SERIES, s)
    header(f"phase 14: continuous queries and warmup, {ln} series x "
           f"{LIVE_SPAN_S} points at 1 s (CUT from 1800), {LIVE_ROUNDS} "
           "rounds (CUT from 5)"
           + ("" if ln == LIVE_SERIES else " (series CUT from 100,000)")
           + f" (|got - want| <= {TOL_REL}*|want| + {TOL_ABS})")
    placement("a continuous query's tail by dc", ln, LIVE_SPAN_S // 60,
              min(ln, 100))
    placement("a continuous query's tail by rack", ln, LIVE_SPAN_S // 60,
              min(ln, 2000))
    for b_w in (60, 288):
        placement("a warm class", LIVE_WARM_SERIES, b_w, 100)
    live_launches, streaming = phase_streaming(torch, ln, args.profile)
    for kname, n in live_launches.items():
        launches[kname] += n

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
            "bound_by": r["bound_by"], "library_ms": None,
            # a plain read of the same [1M, 60] float32 matrix
            "plain_read_ms": read_ms})
    print(f"run: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"histogram": hist}))
    print(json.dumps({"rollup": rollup}))
    print(json.dumps({"streaming": streaming}))
    print(json.dumps({"surfaces": surfaces}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
