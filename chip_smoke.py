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
   rank group stage) and ``avg:15mc-max`` by ``dc`` in
   ``America/New_York`` (calendar buckets), and ``sum`` with no
   downsample over ``dc0`` and ``dc1`` (a union grid of up to 600
   timestamps; CUT from all of ``dc=*`` for the run's time, with
   the cell budget cut alike, ``UNION_SHARE``), which streams in 9 time
   blocks as the full width did: the blocked counters must move on
   it alone, and its peak device memory must be below the staged,
   unblocked run's. Each
   answer is checked against the same query through the port on the
   CPU in float64 over a twentieth of its groups (each with all of its
   series; ``CPU64_SHARE``, CUT from a tenth), the cold call, its
   staged run (and a second cold call of the union query alone,
   ``SECOND_COLD_QUERIES``: CUT from all four) and the warm call (a prepared-batch hit;
   1 with each stage timed once, ``IRREGULAR_REPEATS``, CUT from 3
   for the run's time) must give the same bits, and neither kernel may
   launch; prints
   the stage p50s, the peak device memory and, with ``--profile``, the
   device's idle share;
8. the front end (run after phase 5, on phase 3's TSDB and keys,
   before phase 6 writes a point that makes one series irregular):
   the port's ``TSDServer`` in process on an ephemeral port, driven
   over sockets. (a) ``/api/query`` by POST and GET for both queries,
   one K1 or K2 launch per call, each answer equal to
   ``execute_query``'s through the port's serializer bit for bit and
   to phase 3's float64 reference; HTTP p50 beside the direct p50 and
   the serializer's time. (b) The same at the default keys: a miss,
   then result-cache hits. (d) 4 concurrent clients of (a) (CUT from
   8). (e) ``/q`` with no query and a bad aggregator answer 400;
   then phase 24 (d) runs on the same server. (c) 250k points
   (CUT from 1M for the run's time, ``PUT_STEPS``)
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
   fsyncs, against phase 9's native ingest); (b) 100k points by
   ``/api/put`` in 1000-point bodies with the WAL (CUT from 1M for the
   run's time, ``DURABLE_PUT_STEPS``; points/s against phase 8's,
   fsyncs per body); (c) a child process writes the series
   with the WAL, acknowledges and is SIGKILLed; a TSDB on its
   directory recovers (snapshot load and WAL replay timed apart),
   must read back every point, and answers ``{dc=*}`` and ``{rack=*}``
   with one K1 or K2 launch each, bit for bit as (a)'s TSDB that never
   died; (d) ``flush()`` (seconds, snapshot bytes, segments truncated)
   and a restart from the snapshot alone with the same answers; then
   one out-of-order point on series 0, acknowledged and dropped
   unflushed (by this process: the second killed writer was CUT for
   the run's time), must replay from the WAL tail past the snapshot,
   read back, and give ``{dc=*}`` (one K1 launch) bit for bit as (a)'s
   TSDB after the same write;
11. blocked long ranges: a fresh TSDB on the native store at the
   default keys but the result cache, holding config 3's 1M series
   over 80 minutes (80 points a minute apart, CUT from two hours; 2%
   dropped, seed 0, no jitter), queried as ``sum:1m-avg:rate`` by
   ``dc`` (the rate carry crosses the block edge) and ``avg:1m-avg`` by
   ``rack`` (LERP's prev and next carries, 2000 groups). S x B exceeds the cell budget, so
   the grid path declines and the point path streams 2 blocks: the
   blocked counters must move and neither kernel launch (a second cold
   call, and then the staged run, a second blocked run timed stage by
   stage, were CUT for the run's time), the answer must
   equal the unblocked point path's
   (``tsd.query.max_device_cells=268435456``,
   ``grid_reduce=false``) bit for bit and the port on the CPU in
   float64 at phase 7's tolerance over a twentieth of its groups (each
   with all of its series; CUT from all groups, then a tenth, for the
   run's time); prints
   both device peaks (the
   blocked one must be the lower), the host stages before the blocks
   (plan, materialize, assign) and, with ``--profile``, the device's
   idle share;
12. histograms, BASELINE config 4 (``bench_e2e.py:253-282``), on a
   fresh TSDB at the default keys but the result cache: (a) 125k series
   (``HIST_CUT``: CUT from config 4's 1M, to 250k then 125k, for the
   run's time)
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
   of the [125k, 64] float64 counts, printed on the ``histogram`` line;
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
   2m gap over ``dc2``, (e) p99 and p99.9 over ``dc1``. 1 round (CUT
   from 5, then 2) of live traffic (500 ``add_point``, 10,000 points by
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
   (``grid_reduce=false``): cold calls and a prepared-batch hit,
   (b) the sharded grid path: cold calls and a grid-cache hit, all
   bit-equal (two cold calls by ``dc`` on the first shape, one
   elsewhere: the second by ``dc`` on the second shape CUT with phase
   23), and (c) the
   sharded blocked path (``tsd.query.max_device_cells=1000000``, the
   budget scaled by the 4 shards: 3 blocks; by ``dc`` on the first
   shape, by ``rack`` on the second over its first 8 buckets, 2
   blocks, CUT from 11); each answer held to a float64
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
17. the operator surface (run after phase 16; (a) and (b) on phase 3's
   TSDB before it goes): (a) 100 annotations on ``dc0`` series and 2
   global ones by ``POST /api/annotation/bulk``, then
   ``sum:5m-avg:rate`` by ``dc`` over phase 15's 11 buckets on the
   point path, cold, with the notes and with ``noAnnotations``
   (``OPS_COLD`` calls each, one K1 launch a call): values and emit
   masks bit-equal, ``dc0`` carrying its members' notes in member order
   (each the store's ``range``), every group the 2 global ones; (b)
   p50 of 5 of ``/api/query/last`` over the 10k ``dc0`` series (each
   the store's last point), ``/api/search/lookup`` and
   ``/api/uid/assign`` of 100 names; (c) on fresh TSDBs, the write path
   with every hook on (realtime TSMeta and UIDMeta tracking, a
   two-level tree filed in realtime, a counting realtime publisher, a
   write filter, a UID whitelist: ``chip_smoke.CountingPublisher`` and
   ``SkipFilter`` by dotted path) against the same writes with none:
   50k series x 1 point by ``add_series_points`` (per-series hooks)
   and 500 of them x 60 points by one telnet burst (``import_buffer``,
   each line one ``add_point`` with the hooks on; both CUT by half),
   points/s of each; 50k TSMetas, 50k tree leaves
   and every point published; (d) a running ``TSDServer`` with
   ``tsd.core.authentication.enable``: 401 without credentials, 403 for
   a reader's ``/api/put``, 200 for a writer's, telnet ``auth_fail`` and
   ``auth_success``, and the p50 of 20 authenticated ``/api/query``
   calls against the same on a server without authentication; (e) a
   ``data_dir`` on the memory store and one on the native store: 5k
   series of ints and 5k of floats, 101 notes, their TSMetas and a
   tree; a flush; as many points and notes more; the log closed without
   a flush: a reopened TSDB holds every point, its integer flag and
   every note, and the snapshot's meta documents and tree. Prints each
   stage and ``phase 17: N s``;
18. the data lifecycle, BASELINE config 5's shape (run after phase 14,
   on fresh TSDBs on the native store with ``tsd.rollups.enable``,
   tiers 1m and 1h, a ``tsd.storage.data_dir`` and the result cache
   off): 20k series (CUT from 100k) of ``sys.cpu.user`` (config 3's
   tags) x 2 h at one point a second (CUT from 24 h; 144M points) from
   ``T0 + 2 m``, ``normal(100, 15)`` from seed 18, by
   ``add_series_points`` and ``append_grid``. (a) The policy by ``POST
   /api/lifecycle`` (``demoteAfter`` and ``spillAfter`` in seconds from
   the wall clock, so that the 1h-floored boundaries land at ``T0 + 2
   h`` and ``T0 + 1 h``) and one ``POST /api/lifecycle/sweep``: its
   seconds and report, the demoted count equal to the raw points
   before the boundary, the tier points equal to the plain rollup's,
   a sample of the RAM tier's 1m sums equal to numpy bit for bit. The
   zones are then cold ``[T0 + 2 m, T0 + 1 h)``, RAM tier ``[T0 + 1 h,
   T0 + 2 h)`` and raw ``[T0 + 2 h, T0 + 2 h 2 m)``. (b)
   ``sum:1m-sum`` by ``dc`` and by ``rack`` on the point path
   (``grid_reduce=false``, ``device_cache_mb=0``): over the demoted 118
   minutes (one cell a bucket: K1 and K2, one launch a call, cold and
   warm, each kernel held to its plain version on the stitched batch)
   and over the whole 2 h (irregular rows: the padded or flat path, no
   kernel), each answer held to a float64 numpy reference of the raw
   points, the zones' read times printed; (c) the whole 2 h at the
   default keys (the grid path, each zone's ``bucket_reduce``) and the
   cold zone alone on the point path (K1); (d) shutdown (a flush) and a
   reopen of the data_dir (the snapshot, ``lifecycle.json``, the cold
   manifest): (b)'s history queries bit-equal; (f) on the reopened
   TSDB, ``tsd.faults.coldstore.read_error_count=1``: ``POST
   /api/query`` over the cold zone answers a structured 503 with
   ``Retry-After`` and no rows, the next one answers in full; (e) on a
   TSDB of its own with the sketch tier on and 1h demotion: p99 by hour
   over 1k series x 2 h at 10 s across the three sketch zones (cold
   segment blobs, RAM sketch cells, the raw tail), each within alpha
   of the exact order statistic, bit-equal after a flush and a reopen
   (``sketches.bin``). Prints each stage and ``phase 18: N s``;
19. observability and the control plane. (a) and (b) run after phase 17
   on phase 3's TSDB while a ``TSDServer`` serves it, with
   ``tsd.trace.sample=1`` and phase 3's keys, over phase 15's window
   (clear of phase 6's write): (a) ``POST /api/query`` of both queries,
   one K1 or K2 launch inside each; ``GET /api/trace/<id>``: the tree
   ``tests/test_torch_trace.py`` gives for the request (``query.http``
   with its shape tags over the admission, plan, execute, assemble and
   serialize stages), the answer held to a float64 numpy reference, and
   ``query.execute`` at least the kernel's CUDA-event time (phase 3);
   the stage p50s; the tracing tax: 200 result-cache hits and a
   100k-point ``/api/put`` each with the tracer on and off. (b)
   ``/metrics`` (ms, bytes, every line a valid sample, ``# EOF``
   last), ``/api/health``, ``/api/stats/raw``, ``/api/profile``
   (the ``query`` role present) and ``/logs``. (c)-(e) run after phase
   18 on a TSDB of their own: 100k series x 10 min at 1 s (seed 19,
   ending a minute before the wall clock) by ``append_grid``, a
   data_dir for the shape log, ``tsd.control.enable`` with ticks by
   request only, tenant QoS at ``max_inflight`` 4 and
   ``tsd.stats.self_interval=1``: (c) one dashboard query over
   ``15m-ago`` pulled 8 times, ``POST /api/control/tick`` registers its
   ``auto-*`` continuous query, the next pull is served by the registry
   (``query.streaming_lookup`` in its trace), equal byte for byte to a
   hand-registered query of the same body and to the engine's K1
   answer over the data's buckets within the tolerance; (d) 16 noisy
   clients and one victim for 3 s: the noisy tenant's tenant 503s
   with ``Retry-After``, none for the victim, its p50 and p99; (e) the
   pump's ``tsd.datapoints.added`` answering ``/api/query``, and where
   its tail runs. Prints ``phase 19: N s`` and an ``obs`` line;
20. the cluster at one replica (run last, on TSDBs of its own): three
   shard TSDs (``tsd.cluster.role=shard``, phase 3's keys, each a
   ``TSDServer`` on 127.0.0.1) behind a router TSD
   (``tsd.cluster.role=router``, the binary wire on, a spool dir under
   ``$TMPDIR``). (a) Config 3's series of ``dc0``-``dc51`` (520k, CUT
   from 1M: every ``{dc=*}`` and ``{rack=*}`` group of the cut is a
   whole group of phase 3's answer, and each shard keeps 1040 racks, so
   ``{rack=*}`` runs K2 there) from phase 3's values, placed by the
   router's ring, each shard loading its own by ``add_series_points``;
   the series on each shard against ``ring.distribution``. (b) Both
   queries through the router over the wire and, from a second router
   with ``tsd.cluster.wire.enable=false``, over JSON HTTP: the p50 of 2
   calls after a warm-up, one K1 launch per shard per ``{dc=*}`` call
   and one K2 launch per ``{rack=*}`` call, every merged group held to
   phase 3's answer by phase 2's rule; ``avg`` (sum and count twins on
   each shard) equal to the sum over the group's series count, ``max``
   equal to the shards' own maxes exactly. (c) 50k points (CUT from
   100k) by ``/api/put`` and 10k telnet lines to the router's socket
   (points/s),
   read back through the router exactly. (d) ``s1``'s listener closed:
   ``{dc=*}`` answers 200 with ``shardsDegraded: ["s1"]`` and the
   result cache does not keep it; 10k points acknowledged into ``s1``'s
   spool; ``s1`` back: the drain timed and every point read back. (e)
   ``/api/cluster``, ``/api/cluster/status``, ``/api/stats/fleet``,
   ``/api/health``, and ``/api/trace/<id>`` of a traced query with a
   leg from each shard; with ``--profile``, the device's idle share of
   a ``{dc=*}`` call through the router. Prints the card beside every
   time, and ``phase 20: N s``;
21. federated continuous queries and replication. (a) On phase 20's
   cluster before it stops: ``sum:1m-sum:sys.cpu.user{dc=*}`` and
   ``max:1m-max:sys.cpu.user{rack=*}`` registered through the router
   over the data's hour (absolute windows: the data sits in 2013), 10k
   points put through the router, each ``/result`` pull (p50) equal to
   the router's batch ``/api/query`` of the same query and to a float64
   numpy recompute of the cut's values and the put points; one pushed
   ``windows`` frame of the ``/stream`` after a put (its latency); with
   ``s1``'s listener closed the pull answers ``shardsDegraded: ["s1"]``
   and ``complete: false``, with it back the pull is whole and equal to
   the one before; a delete leaves every shard's registry empty. (b) A
   new router over three new shards at ``tsd.cluster.rf=2`` (an
   in-memory spool, no background replay): the same 520k series, each
   on its two owners (about 1.04M series rows); ``{dc=*}`` (K1) and
   ``{rack=*}`` (K2) through the router: the p50, the shards' replica
   mask (its cold and warm seconds), every group equal to phase 20's
   answer within phase 2's rule, two calls bit-equal, and exactly one
   launch per reading shard per call. (c) ``s1`` down: both answers
   still equal the all-up ones, with no ``shardsDegraded``; once
   ``s1``'s breaker is open, 2 launches a call; the router's
   ``read_fallbacks`` rose. (d) 10k points put in two bodies while
   ``s1`` is down: acknowledged, spooled for ``s1`` and ``s1`` marked
   dirty; the first spool record is lost (an in-memory spool); ``s1``
   back: the spool drained (``s1`` then lacks exactly the lost points)
   and ``repair_peer`` run (seconds, points copied), every point read
   back from each of its two owners through a ``replicaSel`` that
   assigns that owner. Prints ``phase 21: N s``
   and a ``replication`` line;
22. online resharding and stale-copy retirement (on TSDBs
   of its own, rf=1 and the default 5 s peer timeout): four shard TSDs
   (``tsd.http.query.allow_delete``) and a router over three of them
   with a spool dir. (a) Config 3's series ``i < 34,000`` of
   ``dc0``-``dc51`` (17,680, CUT from 1M: 17 series a rack, the fewest
   at which every shard keeps more than 1024 racks on 3 and on 4
   shards, so ``{rack=*}`` runs K2 on each), placed by the ring; each
   shard's K1/K2 route for both queries from one direct call; both
   queries through the router (p50 of 2 after a warm-up), held to
   float64 numpy, one launch a shard a call. (b) ``POST
   /api/cluster/reshard`` adds ``s3`` (epoch 1); 10,200 points of the
   next 170 cut series put through the router; the reads stay on the
   old ring and include them. (c) One backfill unit stepped by hand;
   the router dropped and rebuilt over the same spool dir (epoch, both
   rings, done-markers and fence back); its loop finishes the copy at
   the default 250 ms and finalizes (seconds, series, points). (d) The
   reads at epoch 1 through the selector on 4 shards, 4 launches a
   call, every shard's route again, ``s3`` a fifth to three tenths of
   the series. (e) A router restarted with
   ``tsd.cluster.retire.interval_ms=50`` resumes the retire pass: each
   former owner's series count drops by exactly the series it lost,
   and the reads equal (d)'s. Prints ``phase 22: N s`` and a
   ``reshard`` line;
23. sibling routers (run last, on TSDBs of its own): r0 and r1, each a
   TSD server on its own socket naming the other in
   ``tsd.cluster.routers``, the result cache on, over three new shard
   TSDs and a spare holding phase 22's cut; both push loops stopped,
   every push and backfill step by hand. (a) Both queries warmed in
   r1's cache; 10,200 points of the next 170 cut series put through
   r0; before any push r1 answers from its cache (the negative
   control, no launch), after one push r0 -> r1 (its ms) r1's next
   read of each query misses its cache (one launch a shard) and holds
   the new data to float64 numpy; then both routers' p50s, one launch
   a shard a call (each router's cache dropped before each call).
   (b) A partition (the fault sites ``cluster.gossip.r0`` on r1 and
   ``cluster.gossip.r1`` on r0) and r1's stale window cut to 500 ms:
   another 10,200 points through r0; r1's ``/api/health`` names
   ``cluster_gossip_degraded`` and every read through it bypasses the
   cache, runs on every shard and is exact; r1's landed push clears
   it; r1 then answers (a)'s cached rows (the negative control) until
   r0's push carries the partition's writes, and its next reads miss,
   on every shard, held to numpy.
   (c) r0 begins the grow to 4 shards and copies one unit; one push
   and r1 holds the open window (``topology_adoptions`` 1); r0's server
   is stopped; 10,200 points put through r1; r1 copies every unit and
   finalizes alone; r0 rebuilt over its spool dir comes back with the
   window open and one push from r1 finalizes it; every shard's route
   K1/K2 on 4 shards and both routers' reads held to numpy. Prints
   ``phase 23: N s`` and a ``gossip`` line;
24. the command line, its codec and the rest of the HTTP surface, in
   two parts. (a)-(c) run after phase 10's (d), on its directory (a
   quarter of config 3, ``STORE_CUT``: a snapshot and a one-point WAL
   tail) before it goes, with the point path's keys: (a) ``python3 -m
   opentsdb_tpu_torch.tools.cli query ... sum:5m-avg:rate:sys.cpu.user
   dc=*`` in a fresh process on the card (its wall seconds), its lines
   equal to the reference's ``tsdb query`` format of phase 10 (a)'s
   in-process answer and that answer held to the float64 numpy
   reference; then ``cli.main`` in this process for ``rack=*``, one K2
   launch, held the same way. (b) ``scan --import`` of ``dc0``-``dc4``
   (12.5k series x 60 points, 750k lines; ``TOOLS_DCS``, CUT from
   ``dc0``-``dc9``), gzipped, then
   ``import`` into a fresh directory with the WAL (points/s beside
   phase 9 (e)'s ``import_buffer``); a restart from it reads every
   point back exactly, and ``{dc=*}`` there (one K1 launch) holds its
   5 groups to the reference's. (c) ``fsck`` over the directory: 0
   errors over 15M points (its seconds); on (b)'s directory a NaN and
   a timestamp past ``MAX_VALID_MS`` written through the store:
   ``fsck`` finds both (exit 1), ``fsck --fix`` fixes both, ``fsck``
   again is clean, and ``{dc=*}`` equals its answer before the faults
   bit for bit. (d) runs inside phase 8's server window: ``/q`` ascii
   by ``dc`` (one K1 launch, equal to phase 8 (a)'s ``execute_query``
   answer in the ascii format), JSON by ``rack`` (one K2 launch, equal
   to phase 8 (a)'s ``/api/query`` body byte for byte), a 1024x768 PNG
   by ``dc`` (one
   K1 launch, and a second call from the disk cache with none; on a
   host without matplotlib the reference's 501, which it says),
   ``/s/index.html``, ``/`` and a traversal (404), ``tsdb check`` on
   ``dc0`` three times with exit codes 0, 1 and 2 (thresholds from the
   numpy sums), and ``cleancache``. Prints the seconds of each part;
25. prints the run's wall time, the ``histogram``, ``rollup``,
   ``streaming``, ``surfaces``, ``mesh``, ``ops``, ``lifecycle``,
   ``obs``, ``cluster``, ``replication``, ``reshard`` and ``gossip``
   lines, one JSON line describing each kernel (its launches are those
   of phases 3, 5, 8, 6, 15, 17, 19, 9, 10, 13, 14, 18, 20, 21, 22, 23
   and 24; phases 11, 12 and 16 launch neither on their paths), the card
   line and, last,
   ``{"ok": true, "device": {...}}``. Each phase's header says how far
   into the run it starts.

Phases 3-8, 11, 13, 14, 15, 16 and 18 run on the default store, the
native one. Phases 3-5, 7, 9, 11, 12, 13, 14, 15, 16 and 18 run with the
result cache off, so that every call reaches the path it measures. Every phase
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
import gc
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
    ("sum:sys.cpu.user{dc=dc0|dc1}", None, "padded"))
# phase 7: the query with no downsample (a union grid of up to 600
# timestamps) reads dc0 and dc1, a fiftieth of the series (CUT from
# {dc=*} over all of them, 51-84 s of a run on one H100), at the default
# cell budget cut alike, so it streams in the 9 time blocks of the full
# width; its staged, unblocked run now fits the padded layout (flat at
# full width)
UNION_QUERY = IRREGULAR_QUERIES[3][0]
UNION_SHARE = 50
JITTER_S = 10              # phase 7: whole seconds of jitter, 0-9
# phase 7: warm hits and repeats per stage, CUT from 3: a whole run
# took 906.6 s on one H100 (phase 7 127.2 s), and a repeat of its three
# unblocked queries' warm call and stages costs 3.1-4.5 s each
IRREGULAR_REPEATS = 1
# phase 7: the queries whose second cold call is held bit-equal to the
# first, CUT from all four for the run's time (phase 24 added; each
# big query's second cold call took 2.7-3.2 s on one H100 80GB HBM3 at
# 700 W): the other three are held bit-equal to their staged run, a
# second computation from the store up on the same path
SECOND_COLD_QUERIES = (UNION_QUERY,)
DROP = 0.02                # phase 7: share of points dropped
# phases 7, 11: 1 in 20 groups held to CPU float64 (CUT from 1 in 10 for
# the run's time when phase 19 came)
CPU64_SHARE = 20
# repeats of each point-path fan-out reading, CUT from 3 for the run's
# time with phase 23
FANOUT_REPEATS = 2
REPRO_LAUNCHES = 20        # launches of each kernel's reproducibility reading
# device memory rate by card name (NVIDIA data sheets), bytes/s
_MEM_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
             ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
F32_PEAK = 67e12           # float32 FLOP/s outside the tensor cores
# float64 FLOP/s outside the tensor cores (NVIDIA's H100 SXM data sheet)
F64_PEAK = 34e12
TOL_REL, TOL_ABS = 1e-5, 1e-6
REPEATS = 5                # warm repeats per timed stage
# phase 3's end-to-end calls and stage timings per query, and phase 4's
# cold calls and stage timings, CUT from REPEATS for the run's time
# (phase 19 added: 892.2-893.8 s from a git archive on one H100;
# ROADMAP's chip_smoke.py notes)
MAIN_REPEATS = 2
GRID_REPEATS = 3
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
    """Raise SmokeFailure(what) unless ``cond``; first print the port's
    latest warnings and errors from its log ring (``/logs``), which
    holds what a failing server or router logged."""
    if not cond:
        logring = sys.modules.get("opentsdb_tpu_torch.utils.logring")
        if logring is not None:
            for line in reversed(logring.ring_buffer.lines()[:200]):
                if " WARNING " in line or " ERROR " in line:
                    print(f"  log: {line[:400]}", file=sys.stderr)
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
        for i in range(GRID_REPEATS):
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
                             GRID_REPEATS)
        check(cache.hits == hits + GRID_REPEATS,
              f"warm grid calls made {cache.hits - hits} cache hits, "
              f"not {GRID_REPEATS}")
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

        (sel, tag_mat, gids, g), plan_t = timed(plan, GRID_REPEATS)
        bts = ds_mod.fixed_bucket_edges(tq.start_ms, tq.end_ms,
                                        ds.interval_ms)
        b = len(bts)

        def reduce():
            return pipeline.grid_from_reduce(
                ds.function, *store.bucket_reduce(
                    sel, tq.start_ms, tq.end_ms, int(bts[0]),
                    ds.interval_ms, b))

        (grid64, present), red_t = timed(reduce, GRID_REPEATS)
        (grid, has), up_t = timed(lambda: pipeline.put_grid(
            grid64, present, torch.float32, "cuda"), GRID_REPEATS)
        spec = PipelineSpec(num_series=len(sel), num_buckets=b,
                            num_groups=g, ds_function="avg",
                            agg_name=sub.agg.name, rate=sub.rate)
        (res, emit), tail_t = timed(lambda: pipeline.execute_grid(
            grid, has, bts, gids, spec, sub.rate_options), GRID_REPEATS)
        _, asm_t = timed(lambda: eng._build_results(
            tq, sub, metric_id, sel, tag_mat, gids, g, bts,
            res.cpu().numpy(), emit.cpu().numpy()), GRID_REPEATS)
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
              f"CPU float64 {err:.6g}; {GRID_REPEATS} cold calls and the "
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
# HTTP and 3 direct calls, 8 clients and 1M points; then, with phase 19,
# to 3 HTTP and 2 direct calls; with phase 22, to 4 clients; with phase
# 23, to 2 HTTP and 1 direct call)
FE_REPEATS = 2             # HTTP calls per query in (a), 1 POST + 1 GET
FE_DIRECT = 1              # direct execute_query calls per query in (a)
FE_CLIENTS = 4             # concurrent HTTP clients in (d), CUT from 8
#                            (12.3 s of wall at 8 on one H100 80GB HBM3
#                            at 700 W, PERF.md §5)
# (c): 250k points by /api/put, CUT from 1M for the run's time (phase
# 19 added; ROADMAP's chip_smoke.py notes)
PUT_SERIES, PUT_STEPS = 1000, 250
PUT_BODY_SERIES, PUT_BODY_STEPS = 100, 10  # 1000 points per body
PUT_CONNS = 4
# phase 10 (b): 100k points by /api/put with the WAL, CUT from 1M for
# the run's time (phase 18 added; ROADMAP's chip_smoke.py notes)
DURABLE_PUT_STEPS = 100
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


def put_points(port: int, metric: str, steps: int = PUT_STEPS) -> float:
    """PUT_SERIES x ``steps`` points of ``metric`` by ``/api/put`` in
    1000-point bodies over PUT_CONNS kept-alive connections; the
    seconds it took. Host i's point j is ``(i * 7 + j) % 100000``."""
    import http.client
    n_series_bodies = PUT_SERIES // PUT_BODY_SERIES

    def put_bodies(c: int):
        for k in range(c, n_series_bodies * (steps // PUT_BODY_STEPS),
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


def phase_front_end(torch, tsdb, query, ref3: dict, profile: bool,
                    tools=None) -> dict:
    """Phase 8: the port's TSD server in process on an ephemeral port
    over phase 3's TSDB and keys, driven over real sockets. ``tools``,
    called after (e) with the server's port, (a)'s answers as parsed
    JSON and its GET bodies, runs phase 24 (d) in the same window.
    Returns the kernel launches of its HTTP queries in (a) and (d)."""
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
        expected, get_bodies = {}, {}
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
                    get_bodies[m] = body
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

        # (e) a bad aggregator; /q with no m= (phase 24 (d) drives /q)
        conn = connect()
        status, body, _ = _http(conn, "GET", "/q")
        check(status == 400 and b"Missing 'm' parameter" in body,
              f"/q with no query answered {status}")
        status, body, _ = _http(conn, "GET", get_path(
            f"nope:{METRIC}{{dc=*}}"))
        check(status == 400 and b"No such aggregator" in body,
              f"a bad aggregator answered {status}")
        conn.close()
        print("  (e) /q with no m=: 400; a bad aggregator: 400")
        if tools is not None:
            tools(st.port, expected, get_bodies)

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


def answer_grid(rows, bucket_ts, g: int):
    """[G, B] float64 values and emit mask of an engine answer of ``g``
    groups, row i group i (every group emitted, as the callers check)."""
    import numpy as np
    res = np.zeros((g, len(bucket_ts)))
    emit = np.zeros((g, len(bucket_ts)), dtype=bool)
    for i, r in enumerate(rows):
        ts, vals = r.dps_arrays
        j = np.searchsorted(bucket_ts, ts)
        check(bool(np.array_equal(np.asarray(bucket_ts)[j], ts)),
              "an answer's timestamps are not its buckets'")
        res[i, j], emit[i, j] = vals, True
    return res, emit


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
    from opentsdb_tpu_torch.ops.blocked import (DEFAULT_CELL_BUDGET,
                                                pick_block_buckets)
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
        tsdb.config.override_config(
            "tsd.query.max_device_cells",
            str(DEFAULT_CELL_BUDGET // UNION_SHARE) if m == UNION_QUERY
            else "0")
        torch.cuda.synchronize()
        tsdb.drop_caches()
        torch.cuda.reset_peak_memory_stats()
        reset_blocked()
        cold, cold_s = timed(lambda: tsdb.execute_query(query(m, tz)), 1)
        peak = torch.cuda.max_memory_allocated()
        # an S x B over the cell budget (the union grid) streams in time
        # blocks and makes no prepared batch: its warm call runs it
        # again
        runs, blocks = read_blocked()
        check(bool(runs) == (m == UNION_QUERY),
              f"{m}: {runs} blocked runs")
        hits = cache.hits
        repeats = IRREGULAR_REPEATS
        warm, warm_s = timed(lambda: tsdb.execute_query(query(m, tz)),
                             repeats)
        check(cache.hits == hits + (0 if runs else repeats),
              f"{m}: warm calls made {cache.hits - hits} cache hits")
        check(read_blocked() == (runs * (1 + repeats),
                                 blocks * (1 + repeats)),
              f"{m}: the warm calls left the cold call's path")
        check(same_bits(warm, cold),
              f"{m}: a warm call differs from its cold call")
        if m in SECOND_COLD_QUERIES:
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
        # (a cut of the series can fit the flat query in the padded
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
        # the float64 reference on the CPU: a twentieth of the groups
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
              f"({cpu_s:.1f} s on the CPU); "
              + ("two cold calls" if m in SECOND_COLD_QUERIES else
                 "the cold call, the staged run")
              + " and the warm calls equal bit for bit")
        if runs:
            check(peak < staged_peak, f"{m}: the blocked run's peak is "
                  "not below the unblocked run's")
            print(f"  {m}: blocked ({runs} run of {blocks} blocks of "
                  f"{bb} buckets, budget {eng._budget} cells) peak device "
                  f"memory {peak / 2**30:.3f} GiB; the staged unblocked "
                  f"run {staged_peak / 2**30:.3f} GiB; equal bit for bit")
        del points, grid, prep, res, emit
    tsdb.config.override_config("tsd.query.max_device_cells", "0")
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
            READINGS["import_lines_per_s"] = len(imports) / imp_s
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
root, n = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
import chip_smoke
from opentsdb_tpu_torch import TSDB, Config
t = TSDB(Config(**json.loads(sys.argv[3])))
tags, ts2d, values = chip_smoke.make_data(n)
t.add_series_points(chip_smoke.METRIC, tags, ts2d, values)
print("acked", n * chip_smoke.POINTS, flush=True)
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


def kill_writer(n: int, keys: dict, log: Path) -> float:
    """Run WRITER (``n`` config-3 series) as a child process, wait for
    its acknowledgement, then SIGKILL it (no flush, no shutdown).
    Returns the seconds from its start to the acknowledgement."""
    import signal
    t = time.perf_counter()
    got: list = []
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", WRITER, str(ROOT), str(n),
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
    check(line.startswith("acked"), f"the writer died before its "
          f"acknowledgement: {log.read_text()[-2000:]}")
    check(proc.returncode == -signal.SIGKILL,
          f"the writer ended with {proc.returncode}, not by SIGKILL")
    return acked_s


def phase_durability(torch, n_series: int, query, then=None) -> dict:
    """Phase 10: durability at config 3 with tsd.storage.data_dir (the
    WAL at fsync=always, snapshots) on the native store, on the point
    path with the result cache off. ``then(d, ref, values)`` runs last,
    before the directories go (phase 24 (a)-(c)): ``d`` is (c)'s and
    (d)'s directory, released, ``ref`` (a)'s TSDB and ``values`` the
    data both hold. Returns the kernel launches of its queries."""
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
            put_s = put_points(st.port, "sys.wal.put", DURABLE_PUT_STEPS)
            syncs = put_db.wal.group_syncs
            got = put_db.store.count_range(put_db.store.series_ids_for_metric(
                put_db.uids.metrics.get_id("sys.wal.put")), 0, 2**62)
        finally:
            st.stop()        # shuts the TSDB down: a flush
            open_dbs.remove(put_db)
        n_put = PUT_SERIES * DURABLE_PUT_STEPS
        n_bodies = n_put // (PUT_BODY_SERIES * PUT_BODY_STEPS)
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
        acked_s = kill_writer(n_series, keys(root / "c"),
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
        # one out-of-order point on series 0, acknowledged (fsync=always)
        # and dropped unflushed: the restart loads the snapshot and
        # replays the log's tail past it (the writer is this process;
        # (c) covers a killed one)
        snap_db.add_point(METRIC, T0 + 600, 1000.0, tags[0])
        crash(snap_db)
        del snap_db
        gc.collect()
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
        print(f"  (d) one out-of-order point on series 0, acknowledged, "
              f"dropped unflushed; restart {tail_s:.3f} s (load "
              f"{tail.recovery['load_s']:.3f} s, replay "
              f"{tail.recovery['replay_s']:.3f} s): the point read back, "
              f"and {m} equals the never-killed TSDB's after the same "
              "write bit for bit")
        print(f"  phase 10: {time.perf_counter() - t_phase:.1f} s")
        if then is not None:
            crash(tail)          # the directory's WAL closed, no flush
            del tail
            gc.collect()
            written = values.copy()
            written[0, 10] = 1000.0     # T0 + 600 on series 0
            then(root / "c", ref, written)
    finally:
        for t in open_dbs:
            t.wal.close()
        open_dbs.clear()
        shutil.rmtree(root, ignore_errors=True)
    return launches


# phase 11: 80 minutes at one point a minute, CUT from two hours (120)
# for the run's time with phase 23: S x B = 80M cells still passes the
# 64M budget, so both queries still stream 2 blocks (67 + 13 buckets)
LONG_POINTS = 80
LONG_QUERIES = (
    ("sum:1m-avg:rate:sys.cpu.user{dc=*}", "the rate carry"),
    ("avg:1m-avg:sys.cpu.user{rack=*}", "LERP's prev and next carries"))
UNBLOCKED_CELLS = "268435456"   # phase 11: a budget past S x B


def make_long(n_series: int):
    """Config 3's series over LONG_POINTS minutes: slot j of series i is at
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
        # the engine's blocked answer as [G, B] grids (every group emits)
        check(len(rows) == g, f"{m}: {len(rows)} groups of {g}")
        res_np, emit_np = answer_grid(rows, grid.bucket_ts, g)
        check(runs == 1 and blocks == -(-b // bb) == 2
              and len(sel) * b > eng._budget
              or n_series < 1_000_000 and runs == blocks == 0,
              f"{m}: {runs} blocked runs of {blocks} blocks at S x B = "
              f"{len(sel) * b}, budget {eng._budget}")
        check(not any(launches.values()), f"{m}: launched {launches}")
        check(peak < whole_peak or not runs, f"{m}: the blocked peak "
              f"{peak} is not below the unblocked {whole_peak}")
        # the float64 reference on the CPU: a twentieth of the groups, as
        # in phase 7 (CUT from all of them: 76 s of a 931 s run on one
        # H100)
        err, cpu_s = against_cpu64(torch, m, grid, spec, gids,
                                   sub.rate_options, res_np, emit_np,
                                   max(1, g // CPU64_SHARE))
        emitted = int(emit_np.sum())
        check(len(rows) == g and emitted > 0 and bool(np.isfinite(
            res_np[emit_np]).all()), f"{m}: {len(rows)} groups of {g}, "
              "or no finite value emitted")
        staged = (("plan", plan_t[0]), ("materialize", mat_t[0]),
                  ("assign", grid_t[0]))
        print(f"  {m} ({carry}): S={len(sel)} B={b} G={g}, {runs} blocked "
              f"run of {blocks} blocks of {bb} buckets (budget "
              f"{eng._budget} cells), {emitted} cells emitted; no kernel "
              "launched")
        print(f"  {m}: host stages before the blocks, ms: " + ", ".join(
            f"{n} {v * 1e3:.3f}" for n, v in staged))
        print(f"  {m}: end-to-end cold {cold_s * 1e3:.3f} ms blocked, "
              f"{whole_s * 1e3:.3f} ms unblocked; peak device memory "
              f"{peak / 2**30:.3f} GiB blocked, {whole_peak / 2**30:.3f} "
              "GiB unblocked; blocked equal to unblocked bit for bit; "
              f"max_abs_err vs CPU float64 {err:.6g} ({cpu_s:.1f} s on the "
              "CPU)")
        del points, grid, res_np, emit_np, rows, whole
    tsdb.shutdown()
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")


# phase 12: BASELINE config 4, histograms and percentile sub-queries
HIST_METRIC = "sys.lat.hist"
HIST_BUCKETS = 64
# per series, a minute apart: config 4's depth, cut from 2 so that the
# phase fits its 150 s (the per-series write path took 141 s for 2M
# points on the card's host)
HIST_POINTS = 1
# phase 12 holds an eighth of config 4's 1M series: at 1M its ingest
# took 116 s of a 1133 s run on one H100, past the run's 900 s (CUT to a
# quarter then, to an eighth when phase 19 came)
HIST_CUT = 8
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
LIVE_ROUNDS = 1            # CUT from 5, then 2, for the run's time limit
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
# (e): calls per p50 over config 3; CUT from 3 for the run's time when
# phase 19 came
SURF_REPEATS = 2
# (c): /exp and /gexp calls over config 3 (an /exp call runs two
# point-path queries over 1M series, 4.8 s on one H100 80GB HBM3 at
# 700.00 W); CUT from SURF_REPEATS (2) for the run's time with phase 23
EXP_REPEATS = 1
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
    for _ in range(EXP_REPEATS):
        t0 = time.perf_counter()
        resp = r3.handle(HttpRequest("POST", "/api/query/exp", body=raw))
        exp_s.append(time.perf_counter() - t0)
        check(resp.status == 200, f"(c) /exp answered {resp.status}: "
              f"{resp.body[:300]!r}")
    exp_launch = read_launches(fused)
    check(exp_launch["span_reduce"] == 2 * EXP_REPEATS,
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
    for _ in range(EXP_REPEATS):
        t0 = time.perf_counter()
        gresp = r3.handle(HttpRequest("GET", "/api/query/gexp", gq))
        gexp_s.append(time.perf_counter() - t0)
        check(gresp.status == 200, f"(c) /gexp answered {gresp.status}")
    gexp_launch = read_launches(fused)
    check(gexp_launch["span_reduce"] == EXP_REPEATS,
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
          f"{out['exp_p50_ms']:.3f} ms of {EXP_REPEATS}, K1 launched "
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
# (c) on the second shape: the first 8 of the 11 buckets, 2 blocks of 4,
# CUT from 11 (3 blocks; 8.4 s on one H100 80GB HBM3 at 700 W, PERF.md
# §5) with phase 22
MESH_BLOCKED_CUT_BUCKETS = 8
# (a), (b): two cold calls by dc on the first shape (their bits held
# equal: two fresh sharded computations, the prepare stage included), one
# elsewhere; CUT from two by dc on each shape for the run's time with
# phase 23 (5.2-5.9 s a point-path call on one H100 80GB HBM3 at 700.00
# W on a slow host; each hit's bits still checked against its cold call)
def mesh_cold_calls(shape: str, m: str) -> int:
    return 2 if "{dc=*}" in m and shape == MESH_SHAPES[0] else 1


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
            # (a) the point path: the cold call(s), then the hit
            runs0 = sp.run_sharded_device.runs
            cold = []
            for _ in range(mesh_cold_calls(shape, m)):
                point.drop_caches()
                cold.append(_stats_run(point, tq))
            hits0 = point.device_grid_cache.hits
            warm = _stats_run(point, tq)
            check(point.device_grid_cache.hits == hits0 + 1,
                  f"(a) {shape} {m}: the repeat missed the device cache")
            check(sp.run_sharded_device.runs == runs0 + len(cold) + 1,
                  f"(a) {shape} {m}: the sharded point step did not run")
            check(all(same_bits(cold[0][0], c[0]) for c in cold[1:]),
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
            # (b) the grid path: the cold call(s), then the
            # cached grid
            runs0 = sp.run_sharded_grid.runs
            cold = []
            for _ in range(mesh_cold_calls(shape, m)):
                grid.drop_caches()
                cold.append(_stats_run(grid, tq))
            warm = _stats_run(grid, tq)
            check(sp.run_sharded_grid.runs == runs0 + len(cold) + 1,
                  f"(b) {shape} {m}: the sharded grid step did not run")
            check(all(same_bits(cold[0][0], c[0]) for c in cold[1:])
                  and same_bits(cold[0][0], warm[0]),
                  f"(b) {shape} {m}: the cold calls and the warm differ")
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
            # the second over its first MESH_BLOCKED_CUT_BUCKETS buckets
            if ("{dc=*}" in m) != (shape == MESH_SHAPES[0]):
                continue
            nb = MESH_BUCKETS if shape == MESH_SHAPES[0] \
                else MESH_BLOCKED_CUT_BUCKETS
            btq = TSQuery(start=start, end=str(MESH_WINDOW[0] + nb * 300
                                               - 1),
                          queries=[parse_uri_subquery(m)]).validate()
            bref = refs[m][:2] + config3_window(values, "avg", refs[m][0],
                                                nb)
            b0 = sp.execute_blocked_sharded.blocks
            rows, secs, st = _stats_run(blocked, btq)
            row["blocks"] = sp.execute_blocked_sharded.blocks - b0
            check(2 <= row["blocks"] <= 3,
                  f"(c) {shape} {m}: {row['blocks']} blocks, not 2-3")
            row["blocked_err"] = held_to_reference(rows, bref)
            check(len(rows) == len(single[m]) and all(
                      a.tags == b.tags and np.array_equal(
                          a.dps_arrays[0], b.dps_arrays[0][:nb - 1])
                      for a, b in zip(rows, single[m])),
                  f"(c) {shape} {m}: emit masks differ from one card's")
            row["blocked_s"] = secs
            same = len(rows) == len(point_rows) and all(
                np.array_equal(a.dps_arrays[1], b.dps_arrays[1][:nb - 1])
                for a, b in zip(rows, point_rows))
            print(f"  {shape} (c) blocked {m} over {nb} buckets: "
                  f"{row['blocks']} blocks, "
                  f"{_stage_line([secs], [st])} ms; max |d| vs float64 "
                  f"{row['blocked_err']!r}; bit-equal to (a) over those "
                  f"buckets {same}")
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


# phase 17: the operator surface on the card (authentication, the plugin
# slots, annotations, meta, search and trees)
OPS_NOTES = 100            # (a): notes on {dc=dc0} series, beside 2 global
OPS_COLD = 2               # (a): cold calls per p50, each 2.2-2.7 s at
#                            1M on one H100 (phase 17's budget is 45 s)
OPS_READS = 5              # (b): calls per p50
OPS_ASSIGN = 100           # (b): names per /api/uid/assign call
# (c): series x 1 point by add_series_points, CUT from 100,000 with
# phase 22 (the hook run took 13.9 s at 100k on one H100 80GB HBM3 at
# 700 W, PERF.md §5)
OPS_HOOK_SERIES = 50_000
OPS_BURST_SERIES = 500     # (c): series x OPS_BURST_POINTS by telnet,
#                            CUT from 1,000 with phase 22 (with hooks on
#                            each line is one add_point, ~13k lines/s on
#                            the card's host at 1,000)
OPS_BURST_POINTS = 60
OPS_AUTH_CALLS = 20        # (d): calls per p50
OPS_DUR_SERIES = 5_000     # (e): series per metric, per backend (5k
#                            take about 2.5 s a backend on one H100)
OPS_DUR_POINTS = 10


class CountingPublisher:
    """Phase 17 (c)'s realtime publisher (``tsd.rtpublisher.plugin =
    chip_smoke.CountingPublisher``): counts what it is handed."""

    def initialize(self, tsdb) -> None:
        self.points = 0

    def publish_data_point(self, metric, timestamp, value, tags,
                           tsuid) -> None:
        self.points += 1

    def shutdown(self) -> None:
        pass


class SkipFilter:
    """Phase 17 (c)'s write filter (``tsd.core.write_filter.plugin =
    chip_smoke.SkipFilter``): turns away metrics under ``blocked.``."""

    def allow_data_point(self, metric, timestamp, value, tags) -> bool:
        return not metric.startswith("blocked.")


def ops_keys(hooks: bool) -> dict:
    """Phase 17 (c)'s TSDB keys: every write hook on, or none."""
    keys = {"tsd.torch.device": "cuda",
            "tsd.core.auto_create_metrics": "true", **ENGINE_KEYS}
    if hooks:
        keys.update({
            "tsd.core.meta.enable_realtime_ts": "true",
            "tsd.core.meta.enable_realtime_uid": "true",
            "tsd.core.tree.enable_processing": "true",
            "tsd.rtpublisher.enable": "true",
            "tsd.rtpublisher.plugin": "chip_smoke.CountingPublisher",
            "tsd.core.write_filter.enable": "true",
            "tsd.core.write_filter.plugin": "chip_smoke.SkipFilter",
            "tsd.uid.filter.enable": "true",
            "tsd.uid.filter.plugin":
                "opentsdb_tpu_torch.plugins.UniqueIdWhitelistFilter",
            "tsd.uidfilter.metric_patterns": r"^ops\."})
    return keys


def ops_write(tsdb, hooks: bool) -> tuple[float, float]:
    """Phase 17 (c)'s writes: OPS_HOOK_SERIES series x 1 point by
    ``add_series_points`` (per-series hooks), then the first
    OPS_BURST_SERIES of them x OPS_BURST_POINTS by one telnet burst
    (``import_buffer``, per-point hooks); seconds of each."""
    import numpy as np
    from opentsdb_tpu_torch.tree.tree import TreeRule, tree_manager
    from opentsdb_tpu_torch.tsd.telnet import TelnetRouter
    if hooks:
        tree = tree_manager(tsdb).create_tree("by dc and host")
        tree.set_rule(TreeRule(level=0, type="TAGK", field="dc"))
        tree.set_rule(TreeRule(level=1, type="TAGK", field="host"))
    rng = np.random.default_rng(17)
    n = OPS_HOOK_SERIES
    tags = [{"host": f"h{i}", "dc": f"dc{i % 100}", "rack": f"r{i % 2000}"}
            for i in range(n)]
    t = time.perf_counter()
    tsdb.add_series_points("ops.hooked", tags, np.full((n, 1), T0),
                           rng.normal(100.0, 15.0, (n, 1)))
    series_s = time.perf_counter() - t
    vals = rng.normal(100.0, 15.0, (OPS_BURST_SERIES, OPS_BURST_POINTS))
    lines = [f"put ops.hooked {T0 + 60 * (j + 1)} {vals[i, j]:.6f} "
             f"host=h{i} dc=dc{i % 100} rack=r{i % 2000}"
             for i in range(OPS_BURST_SERIES)
             for j in range(OPS_BURST_POINTS)]
    t = time.perf_counter()
    out, deferred = TelnetRouter(tsdb).execute_lines(lines)
    burst_s = time.perf_counter() - t
    check(out == [] and deferred is None,
          f"(c) the telnet burst answered {out[:3]}")
    return series_s, burst_s


def ops_durable(root: Path, backend: str) -> dict:
    """Phase 17 (e) on one store: points (ints and floats), notes, the
    meta documents and a tree; a flush; more points and notes; the log
    closed without a flush; a reopened TSDB must hold every point, flag
    and note, and the snapshot's meta and tree."""
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.meta.annotation import Annotation
    from opentsdb_tpu_torch.tree.tree import TreeRule, tree_manager
    keys = {"tsd.torch.device": "cuda", "tsd.core.auto_create_metrics":
            "true", "tsd.storage.backend": backend,
            "tsd.storage.data_dir": str(root / backend),
            "tsd.core.meta.enable_realtime_ts": "true",
            "tsd.core.meta.enable_realtime_uid": "true",
            "tsd.core.tree.enable_processing": "true", **ENGINE_KEYS}
    n, p = OPS_DUR_SERIES, OPS_DUR_POINTS
    rng = np.random.default_rng(23)
    tags = [{"host": f"h{i}", "dc": f"dc{i % 100}"} for i in range(n)]
    ts = T0 + 60 * np.arange(2 * p, dtype=np.int64)
    ints = rng.integers(-1000, 1000, (n, 2 * p))
    floats = rng.normal(0.0, 1e3, (n, 2 * p))
    t = time.perf_counter()
    w = TSDB(Config(**keys))
    tree = tree_manager(w).create_tree("durable")
    tree.set_rule(TreeRule(level=0, type="TAGK", field="dc"))
    tree.set_rule(TreeRule(level=1, type="METRIC"))

    def write(half: slice, k0: int) -> None:
        ts2d = np.broadcast_to(ts[half], (n, p))
        w.add_series_points("ops.ints", tags, ts2d, ints[:, half])
        w.add_series_points("ops.floats", tags, ts2d, floats[:, half])
        for k in range(k0, k0 + 50):
            w.annotations.store(Annotation(
                w.uids.tsuid(w.uids.metrics.get_id("ops.ints"), sorted(
                    (w.uids.tag_names.get_id(a), w.uids.tag_values.get_id(b))
                    for a, b in tags[k].items())).hex().upper(),
                int(ts[k % (2 * p)]), 0, f"note {k}"))
        w.annotations.store(Annotation("", T0 + k0, 0, f"global {k0}"))

    write(slice(0, p), 0)
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    w.flush()
    flush_s = time.perf_counter() - t
    flushed = ({k: m.to_json() for k, m in w.meta.ts_meta.items()},
               [tr.to_json() for tr in tree_manager(w).all_trees()])
    write(slice(p, 2 * p), 50)
    w.annotations.delete("", T0)
    w.wal.close()                       # the process is gone
    t = time.perf_counter()
    r = TSDB(Config(**keys))
    reopen_s = time.perf_counter() - t

    def points(db) -> dict:
        c, ts_, vals, flags = db.store.read_all()
        return {"counts": c.tolist(), "ts": ts_.tobytes(),
                "vals": vals.tobytes(), "ints": flags.tobytes()}

    def notes(db) -> list:
        return sorted((k, a.start_time, a.description)
                      for k, d in db.annotations._by_tsuid.items()
                      for a in d.values())

    got = points(r)
    check(got == points(w), f"(e) {backend}: the reopened points differ")
    check(bytes(got["ints"]).count(1) == n * 2 * p,
          f"(e) {backend}: the integer flags did not come back")
    check(notes(r) == notes(w) and len(notes(r)) == 101,
          f"(e) {backend}: the notes differ ({len(notes(r))})")
    check(({k: m.to_json() for k, m in r.meta.ts_meta.items()},
           [tr.to_json() for tr in tree_manager(r).all_trees()]) == flushed
          and len(flushed[0]) == 2 * n,
          f"(e) {backend}: the meta documents or the tree differ")
    r.shutdown()
    return {"write_s": write_s, "flush_s": flush_s, "reopen_s": reopen_s,
            "points": 2 * n * 2 * p,
            "replayed": r.recovery["points_replayed"]}


def phase_ops(torch, tsdb, values, tags, fused) -> tuple[dict, dict]:
    """Phase 17: the operator surface. (a) an annotated query on phase
    3's TSDB (K1), (b) the reads, (c) the write path with every hook on,
    (d) authentication on a running server, (e) the durability of the
    new state on both stores. Returns (K1 launches of (a), the
    ``ops`` line)."""
    import http.client
    import socket
    import tempfile
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.query.model import TSQuery
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
    from opentsdb_tpu_torch.tsd.server import ServerThread
    from opentsdb_tpu_torch.tree.tree import tree_manager
    t_phase = time.perf_counter()
    out: dict = {}
    for k_, v_ in ENGINE_KEYS.items():
        tsdb.config.override_config(k_, v_)
    router = HttpRpcRouter(tsdb)
    uids = tsdb.uids
    mid = uids.metrics.get_id(METRIC)
    s = len(tags)

    def tsuid_of(i: int) -> str:
        return uids.tsuid(mid, sorted(
            (uids.tag_names.get_id(k), uids.tag_values.get_id(v))
            for k, v in tags[i].items())).hex().upper()

    # (a) 100 notes on dc0 series (i = 0, 100, ...) and 2 global, by one
    # POST /api/annotation/bulk; then the {dc=*} query, cold, with and
    # without them
    noted = list(range(0, min(s, 100 * OPS_NOTES), 100))
    lo, hi = SURF_WINDOW
    notes = [{"tsuid": tsuid_of(i), "startTime": lo + 60 * (j % 50),
              "description": f"deploy {j}"} for j, i in enumerate(noted)]
    notes += [{"startTime": lo + 30, "description": "global 0"},
              {"startTime": hi - 30, "endTime": hi, "description":
               "global 1"}]
    t = time.perf_counter()
    resp = router.handle(HttpRequest("POST", "/api/annotation/bulk",
                                     body=json.dumps(notes).encode()))
    bulk_ms = (time.perf_counter() - t) * 1e3
    check(resp.status == 200 and len(json.loads(resp.body)) == len(notes),
          f"(a) /api/annotation/bulk answered {resp.status}")

    def annotated(no: bool) -> dict:
        return {"start": str(lo), "end": str(hi), "noAnnotations": no,
                "globalAnnotations": not no, "queries": [{
                    "aggregator": "sum", "metric": METRIC,
                    "downsample": "5m-avg", "rate": True,
                    "filters": [{"type": "wildcard", "tagk": "dc",
                                 "filter": "*", "groupBy": True}]}]}

    runs: dict = {False: [], True: []}
    rows: dict = {}
    k1 = 0
    for _ in range(OPS_COLD):
        for no in (True, False):
            reset_launches(fused)
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows[no] = tsdb.execute_query(
                TSQuery.from_json(annotated(no)).validate())
            runs[no].append(time.perf_counter() - t)
            n_l = read_launches(fused)
            check(n_l == {"span_reduce": 1, "onehot_reduce": 0},
                  f"(a) a cold call launched {n_l}, not K1 once")
            k1 += 1
    with_n, without_n = rows[False], rows[True]
    check(len(with_n) == len(without_n) == min(s, 100),
          "(a) the group counts differ")
    for a, b in zip(with_n, without_n):
        check(a.tags == b.tags and all(
            np.array_equal(np.asarray(x).view(np.int64),
                           np.asarray(y).view(np.int64))
            for x, y in zip(a.dps_arrays, b.dps_arrays)),
            "(a) values or emit mask moved with the annotations")
        check(b.annotations == [] and b.global_annotations == [],
              "(a) noAnnotations carried notes")
        check([g.description for g in a.global_annotations] ==
              ["global 0", "global 1"], "(a) the global notes differ")
    by_dc = {r.tags["dc"]: r for r in with_n}
    want = [(tsuid_of(i), lo + 60 * (j % 50)) for j, i in enumerate(noted)]
    got = [(n.tsuid, n.start_time) for n in by_dc["dc0"].annotations]
    check(got == want, "(a) dc0's notes are not its members' in order")
    check(all(tsdb.annotations.range(ts_, lo, hi)[0].start_time == st
              for ts_, st in want), "(a) the store's range differs")
    check(all(not r.annotations for d, r in by_dc.items() if d != "dc0"),
          "(a) a group without notes carried some")
    reset_launches(fused)
    body = json.loads(router.handle(HttpRequest(
        "POST", "/api/query", body=json.dumps(annotated(False)).encode())
    ).body)
    torch.cuda.synchronize()
    n_l = read_launches(fused)
    check(n_l == {"span_reduce": 1, "onehot_reduce": 0},
          f"(a) POST /api/query launched {n_l}, not K1 once")
    k1 += n_l["span_reduce"]
    head = next(g for g in body if g["tags"]["dc"] == "dc0")
    check(len(head["annotations"]) == len(noted)
          and len(head["globalAnnotations"]) == 2,
          "(a) the serialized head lost its notes")
    out["annotated_ms"] = p50(runs[False]) * 1e3
    out["plain_ms"] = p50(runs[True]) * 1e3
    print(f"  (a) {len(notes)} notes by /api/annotation/bulk in "
          f"{bulk_ms:.3f} ms; sum:5m-avg:rate{{dc=*}} over {s} series, "
          f"cold p50 of {OPS_COLD}: annotated {out['annotated_ms']:.1f} ms "
          f"against noAnnotations {out['plain_ms']:.1f} ms (+"
          f"{out['annotated_ms'] - out['plain_ms']:.1f} ms), one K1 launch "
          "a call; values and emit mask bit-equal; dc0 carries its "
          f"{len(noted)} notes in member order, every group the 2 global")

    # (b) the reads: /api/query/last over dc0, /api/search/lookup,
    # /api/uid/assign
    reads: dict = {"last": [], "lookup": [], "assign": []}
    n_dc0 = len(range(0, s, 100))
    for c in range(OPS_READS):
        t = time.perf_counter()
        resp = router.handle(HttpRequest("GET", "/api/query/last", {
            "timeseries": [f"{METRIC}{{dc=dc0}}"], "resolve": [""]}))
        reads["last"].append(time.perf_counter() - t)
        check(resp.status == 200, f"(b) /api/query/last {resp.status}")
        last = json.loads(resp.body)
        t = time.perf_counter()
        resp = router.handle(HttpRequest("GET", "/api/search/lookup", {
            "m": [f"{METRIC}{{dc=dc0}}"]}))
        reads["lookup"].append(time.perf_counter() - t)
        found = json.loads(resp.body)
        check(resp.status == 200 and found["totalResults"] == n_dc0
              and len(found["results"]) == min(25, n_dc0),
              f"(b) /api/search/lookup answered {resp.status}")
        t = time.perf_counter()
        resp = router.handle(HttpRequest(
            "POST", "/api/uid/assign", body=json.dumps({
                "metric": [f"ops.assign.{c}.{k}"
                           for k in range(OPS_ASSIGN)]}).encode()))
        reads["assign"].append(time.perf_counter() - t)
        check(resp.status == 200 and len(json.loads(resp.body)["metric"])
              == OPS_ASSIGN, f"(b) /api/uid/assign answered {resp.status}")
    check(len(last) == n_dc0, f"(b) {len(last)} last points")
    for pt in last:
        i = int(pt["tags"]["host"][1:])
        if i == s - 1:
            continue                    # phase 6's late point
        v = float(values[i, -1])
        check(pt["timestamp"] == (T0 + 60 * (POINTS - 1)) * 1000
              and pt["value"] == (str(int(v)) if v.is_integer()
                                  else str(v)),
              f"(b) series {i}'s last point {pt}")
    for k, v in reads.items():
        out[f"{k}_ms"] = p50(v) * 1e3
    print(f"  (b) p50 of {OPS_READS}: /api/query/last over {n_dc0} series "
          f"{out['last_ms']:.3f} ms (each the store's last point); "
          f"/api/search/lookup {METRIC}{{dc=dc0}} {out['lookup_ms']:.3f} "
          f"ms ({n_dc0} found); /api/uid/assign of {OPS_ASSIGN} metrics "
          f"{out['assign_ms']:.3f} ms")

    # (c) the write path with every hook on against none
    off_db = TSDB(Config(**ops_keys(False)))
    off = ops_write(off_db, False)
    on_db = TSDB(Config(**ops_keys(True)))
    on = ops_write(on_db, True)
    written = OPS_HOOK_SERIES + OPS_BURST_SERIES * OPS_BURST_POINTS
    check(on_db.datapoints_added == off_db.datapoints_added == written,
          f"(c) {on_db.datapoints_added} points written")
    check(on_db.rt_publisher.points == written,
          f"(c) the publisher saw {on_db.rt_publisher.points}")
    check(len(on_db.meta.ts_meta) == OPS_HOOK_SERIES,
          f"(c) {len(on_db.meta.ts_meta)} TSMetas")
    root_b = tree_manager(on_db).all_trees()[0].root
    leaves = sum(len(b.leaves) for b in root_b.branches.values())
    check(leaves == OPS_HOOK_SERIES, f"(c) {leaves} tree leaves")
    check(on_db.hook_errors == {}, f"(c) hook errors {on_db.hook_errors}")
    check(on_db.meta.ts_counters[tsuid_of_db(on_db, 0)] ==
          1 + OPS_BURST_POINTS, "(c) a TSMeta's count differs")
    out.update({"series_on_s": on[0], "series_off_s": off[0],
                "burst_on_s": on[1], "burst_off_s": off[1]})
    print(f"  (c) {OPS_HOOK_SERIES} series x 1 point by add_series_points: "
          f"hooks on {on[0]:.3f} s ({OPS_HOOK_SERIES / on[0]:,.0f} "
          f"points/s) against off {off[0]:.3f} s "
          f"({OPS_HOOK_SERIES / off[0]:,.0f}), x{on[0] / off[0]:.1f}; "
          f"{OPS_BURST_SERIES} x {OPS_BURST_POINTS} by a telnet burst: on "
          f"{on[1]:.3f} s ({OPS_BURST_SERIES * OPS_BURST_POINTS / on[1]:,.0f}"
          f" points/s) against off {off[1]:.3f} s "
          f"({OPS_BURST_SERIES * OPS_BURST_POINTS / off[1]:,.0f}), "
          f"x{on[1] / off[1]:.1f}; {len(on_db.meta.ts_meta)} TSMetas, "
          f"{leaves} tree leaves, {on_db.rt_publisher.points} points "
          "published, no hook error")
    on_db.shutdown()
    off_db.shutdown()
    del on_db, off_db

    # (d) authentication on a running server, against one without it
    def sha(pw: str) -> str:
        import hashlib
        return hashlib.sha256(pw.encode()).hexdigest()

    users = {"tsd.core.authentication.users":
             f"reader:{sha('r')}:ro,writer:{sha('w')}:rw",
             "tsd.core.authentication.roles":
             "ro:http_query,rw:http_query|http_put|telnet_put"}
    auth_keys = {"tsd.torch.device": "cuda",
                 "tsd.core.auto_create_metrics": "true", **ENGINE_KEYS}

    def basic(user: str, pw: str) -> dict:
        import base64
        return {"Authorization": "Basic " + base64.b64encode(
            f"{user}:{pw}".encode()).decode(),
            "Content-Type": "application/json"}

    put = json.dumps([{"metric": "ops.auth", "timestamp": T0 + 60 * k,
                       "value": k, "tags": {"host": f"h{k % 10}"}}
                      for k in range(600)]).encode()
    qpath = f"/api/query?start={T0}&end={T0 + 3599}&m=sum:1m-avg:ops.auth"

    def talk(st, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", st.port, timeout=60)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    def telnet(st, text: str, lines: int) -> list:
        with socket.create_connection(("127.0.0.1", st.port), 60) as sk:
            sk.sendall(text.encode())
            got = b""
            while got.count(b"\n") < lines:
                chunk = sk.recv(65536)
                if not chunk:
                    break
                got += chunk
        return got.decode().splitlines()

    def query_p50(st, headers) -> tuple:
        conn = http.client.HTTPConnection("127.0.0.1", st.port, timeout=60)
        secs = []
        try:
            for _ in range(OPS_AUTH_CALLS + 1):
                t = time.perf_counter()
                conn.request("GET", qpath, headers=headers)
                r = conn.getresponse()
                body = r.read()
                secs.append(time.perf_counter() - t)
                check(r.status == 200, f"(d) /api/query {r.status}")
        finally:
            conn.close()
        return p50(secs[1:]), body

    st_auth = serve_pinned(ServerThread, TSDB(Config(**{
        **auth_keys, **users, "tsd.core.authentication.enable": "true"})))
    st_open = serve_pinned(ServerThread, TSDB(Config(**auth_keys)))
    try:
        check(talk(st_auth, "GET", "/api/version")[0] == 401,
              "(d) no credentials did not answer 401")
        check(talk(st_auth, "POST", "/api/put", put,
                   basic("reader", "r"))[0] == 403,
              "(d) a reader's put did not answer 403")
        code, body = talk(st_auth, "POST", "/api/put?summary", put,
                          basic("writer", "w"))
        check(code == 200 and json.loads(body)["success"] == 600,
              f"(d) a writer's put answered {code}")
        check(talk(st_open, "POST", "/api/put", put,
                   {"Content-Type": "application/json"})[0] == 204,
              "(d) the open server's put failed")
        lines = telnet(st_auth, "auth writer nope\nauth writer w\n"
                       f"put ops.telnet {T0} 1 host=t\nversion\nexit\n", 3)
        check(lines[:2] == ["auth_fail", "auth_success"]
              and "version" in lines[2], f"(d) telnet answered {lines}")
        authed, a_body = query_p50(st_auth, basic("reader", "r"))
        opened, o_body = query_p50(st_open, {})
        check(json.loads(a_body)[0]["dps"] == json.loads(o_body)[0]["dps"],
              "(d) the authenticated answer differs")
    finally:
        st_auth.stop()
        st_open.stop()
    out["auth_query_ms"] = authed * 1e3
    out["open_query_ms"] = opened * 1e3
    print(f"  (d) a running server with tsd.core.authentication.enable: "
          f"401 with no credentials, 403 for a reader's put, 200 for a "
          f"writer's; telnet auth_fail then auth_success; /api/query p50 "
          f"of {OPS_AUTH_CALLS} authenticated {out['auth_query_ms']:.3f} ms "
          f"against {out['open_query_ms']:.3f} ms without authentication "
          f"({(authed - opened) * 1e6:+.1f} us)")

    # (e) the durability of the new state on both stores
    root = Path(tempfile.mkdtemp(prefix="tsd-operator-"))
    try:
        for backend in ("memory", "native"):
            d = ops_durable(root, backend)
            out[f"durable_{backend}"] = d
            print(f"  (e) {backend} store: {d['points']} points (ints and "
                  f"floats), 101 notes, {2 * OPS_DUR_SERIES} TSMetas and a "
                  f"tree: write {d['write_s']:.3f} s, flush "
                  f"{d['flush_s']:.3f} s, reopen without a flush "
                  f"{d['reopen_s']:.3f} s ({d['replayed']} points "
                  "replayed); every point, flag and note back, the "
                  "snapshot's meta and tree")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 17: {out['phase_s']:.1f} s")
    return {"span_reduce": k1, "onehot_reduce": 0}, out


LC_SERIES = 20_000         # phase 18: config 5's shape, CUT from 100,000
LC_SPAN_S = 7200           # two hours at one point a second (CUT from 24 h)
LC_START = T0 + 120        # the data: [T0 + 2 m, T0 + 2 h 2 m)
LC_CHUNK = 2_000           # series per ingest call
LC_END_S = LC_START + LC_SPAN_S
# the boundaries, each floored to the coarsest demoted tier (1h):
# cold [start, T0+1h) | RAM tier [T0+1h, T0+2h) | raw [T0+2h, end), 58,
# 60 and 2 minutes. A raw tail of an hour (demote_after=1h) would leave
# 72M raw points for the snapshot of (d) to flush and reload, about ten
# times the 7.3M values that take 14 s here; the 1h floor puts a cold
# zone of half the demoted history only at an hour's boundary
LC_DEMOTE_B = (T0 + 7200) * 1000
LC_SPILL_B = (T0 + 3600) * 1000
# the policy's demote_after and spill_after are set by POST
# /api/lifecycle relative to the wall clock (the sweep's now), so that
# now - demote_after and now - spill_after fall half an hour past the
# boundaries above
LC_KEYS = {"tsd.rollups.enable": "true", "tsd.lifecycle.enable": "true",
           "tsd.lifecycle.demote_tiers": "1m,1h",
           # (d) flushes once; a flush after the sweep as well would
           # write the same snapshot twice
           "tsd.lifecycle.flush_after_sweep": "false",
           # the sketch tier is (e)'s, on a TSDB of its own: folding
           # the demoted points into per-minute sketch cells is host
           # work of minutes at this width, past the phase's time
           # (opentsdb_tpu_torch/tools/sweep_rate.py times it)
           "tsd.sketch.enable": "false"}
LC_QUERIES = (("sum:1m-sum:sys.cpu.user{dc=*}", "span_reduce"),
              ("sum:1m-sum:sys.cpu.user{rack=*}", "onehot_reduce"))
LC_SKETCH_SERIES = 1_000   # (e): series of the sketch-zone metric
LC_SKETCH_STEP_S = 10      # (e): one point each 10 s
LC_SKETCH_QS = (99.0,)


def lc_policy() -> dict:
    """The policy body of (a): demote_after and spill_after as seconds
    from the wall clock to half an hour past each boundary."""
    now_s = int(time.time())
    return {"policies": [{
        "metric": "*", "demoteTiers": ["1m", "1h"],
        "demoteAfter": f"{now_s - (LC_DEMOTE_B // 1000 + 1800)}s",
        "spillAfter": f"{now_s - (LC_SPILL_B // 1000 + 1800)}s"}]}


def lc_query(m: str, start_s: int, end_s: int):
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    return TSQuery(start=str(start_s), end=str(end_s),
                   queries=[parse_uri_subquery(m)]).validate()


def lc_grouped(x, key: str):
    """[S, B] per-series values summed into [G, B] by ``dc`` (i % 100)
    or ``rack`` (i % 2000)."""
    import numpy as np
    mod = min(x.shape[0], 100 if key == "dc" else 2000)
    gid = np.arange(x.shape[0]) % mod
    return np.stack([np.bincount(gid, x[:, j], minlength=mod)
                     for j in range(x.shape[1])], axis=1)


def lc_held(rows, key: str, want, terms, what: str) -> float:
    """The rows against the float64 reference at phase 3's tolerance;
    returns the worst |got - want| / (sum|terms| + 1)."""
    import numpy as np
    prefix = "dc" if key == "dc" else "r"
    got, _ = rows_by_group(rows, key, prefix, want.shape[0])
    check(got.shape == want.shape, f"{what}: shape {got.shape}, not "
          f"{want.shape}")
    diff = np.abs(got - want)
    check(bool((diff <= TOL_REL * terms + TOL_ABS).all()),
          f"{what}: differs from the float64 reference by "
          f"{float((diff / (terms + 1)).max())!r}")
    return float((diff / (terms + 1)).max())


def phase_lifecycle(torch, fused, n_series: int) -> tuple[dict, dict]:
    """Phase 18: the data lifecycle. Returns (the kernels' launches,
    the ``lifecycle`` line)."""
    import tempfile
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.lifecycle.stitch import StitchedStore
    from opentsdb_tpu_torch.ops import downsample as ds_mod
    from opentsdb_tpu_torch.ops import pipeline
    from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
    t_phase = time.perf_counter()
    out: dict = {}
    launches = {"span_reduce": 0, "onehot_reduce": 0}
    root = Path(tempfile.mkdtemp(prefix="tsd-lifecycle-"))
    keys = {"tsd.torch.device": "cuda",
            "tsd.core.auto_create_metrics": "true",
            "tsd.query.cache.enable": "false",
            "tsd.storage.data_dir": str(root / "main"),
            **HOST_TAIL_OFF, **LC_KEYS}
    point = {**keys, **POINT_KEYS}
    n, p = n_series, LC_SPAN_S
    try:
        tsdb = TSDB(Config(**point))
        check(tsdb.store.backend == "native",
              "phase 18 runs on the default store, the native one")
        # data, seed 18: config 3's tags, normal(100, 15) at 1 s, with
        # float64 per-minute sums, each minute added in time order; every
        # value is positive (checked), so the sums are also the sums of
        # |x| the tolerance scales by
        rng = np.random.default_rng(18)
        tags = [{"host": f"h{i}", "dc": f"dc{i % 100}",
                 "rack": f"r{i % 2000}"} for i in range(n)]
        ts_ms = (LC_START + np.arange(p, dtype=np.int64)) * 1000
        m1 = np.empty((n, p // 60))
        mask = np.ones((LC_CHUNK, p - 1), dtype=bool)
        gen_s = ingest_s = 0.0
        for lo in range(0, n, LC_CHUNK):
            hi = min(lo + LC_CHUNK, n)
            t = time.perf_counter()
            vals = rng.normal(100.0, 15.0, (hi - lo, p))
            x = vals.reshape(hi - lo, p // 60, 60)
            check(float(vals.min()) > 0, "a drawn value is not positive")
            acc = np.zeros((hi - lo, p // 60))
            for j in range(60):
                acc += x[:, :, j]
            m1[lo:hi] = acc
            t1 = time.perf_counter()
            sids = tsdb.add_series_points(
                METRIC, tags[lo:hi], np.full((hi - lo, 1), LC_START,
                                             np.int64), vals[:, :1])
            tsdb.store.append_grid(sids, ts_ms[1:], vals[:, 1:],
                                   mask[:hi - lo])
            ingest_s += time.perf_counter() - t1
            gen_s += t1 - t
        del vals, x
        check(tsdb.store.points_written == n * p, "raw points written")
        print(f"  ingest: {n} series x {p} points ({n * p:,} raw points, "
              f"2 h at 1 s from {LC_START}, normal(100, 15) seed 18) by "
              f"add_series_points + append_grid: {ingest_s:.3f} s "
              f"({n * p / ingest_s:,.0f} points/s; drawing the data and "
              f"the numpy reference {gen_s:.3f} s more)")
        mid = tsdb.uids.metrics.get_id(METRIC)
        all_sids = tsdb.store.series_ids_for_metric(mid)
        before = int(tsdb.store.count_range(all_sids, 1,
                                            LC_DEMOTE_B - 1).sum())

        # (a) the policy by POST /api/lifecycle, one sweep by POST
        # /api/lifecycle/sweep
        router = HttpRpcRouter(tsdb)
        policy = lc_policy()
        resp = router.handle(HttpRequest(
            method="POST", path="/api/lifecycle",
            body=json.dumps(policy).encode()))
        check(resp.status == 200, f"(a) the policy answered {resp.status}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        resp = router.handle(HttpRequest(method="POST",
                                         path="/api/lifecycle/sweep"))
        sweep_s = time.perf_counter() - t
        check(resp.status == 200, f"(a) sweep answered {resp.status}")
        rep = json.loads(resp.body)
        print(f"  (a) POST /api/lifecycle {json.dumps(policy)}; POST "
              f"/api/lifecycle/sweep: {sweep_s:.3f} s; report "
              f"{json.dumps(rep)}")
        check("error" not in rep, f"(a) the sweep failed: {rep}")
        check(rep["demoted"] == before == n * (LC_DEMOTE_B // 1000
                                               - LC_START),
              f"(a) demoted {rep['demoted']}, raw points before the "
              f"boundary {before}")
        # the plain rollup of [start, boundary): a 1m cell per minute
        # and a 1h cell per hour touched, each of the four statistics
        n_1m = (LC_DEMOTE_B // 1000 - LC_START) // 60
        n_1h = len({(s // 3600) for s in range(LC_START,
                                               LC_DEMOTE_B // 1000)})
        check(rep["tierPointsWritten"] == n * (n_1m + n_1h) * 4,
              f"(a) tier points {rep['tierPointsWritten']}, the plain "
              f"rollup's {n * (n_1m + n_1h) * 4}")
        n_cold = (LC_SPILL_B // 1000 - LC_START) // 60
        check(rep["spilled"] == n * (n_cold + 1),
              f"(a) spilled {rep['spilled']}, not {n * (n_cold + 1)}")
        check(tsdb.lifecycle.demote_boundary(mid) == LC_DEMOTE_B,
              "(a) demotion boundary")
        cold = tsdb.lifecycle.coldstore
        check(cold.spill_boundary(METRIC) == LC_SPILL_B,
              "(a) spill boundary")
        out.update(sweep_s=sweep_s, demoted=rep["demoted"],
                   tier_points=rep["tierPointsWritten"],
                   spilled=rep["spilled"], cold_bytes=cold.cold_bytes())
        # a sample of the RAM tier's 1m sums against numpy, bit for bit
        tier = tsdb.rollup_store.tier("1m", "sum")
        sample = np.arange(0, n, 200)
        tb = tier.materialize(sample, LC_SPILL_B, LC_DEMOTE_B - 1)
        want = m1[sample, n_cold:n_1m]
        check(np.array_equal(tb.values.reshape(want.shape).view(np.int64),
                             want.view(np.int64)),
              "(a) the RAM tier's 1m sums differ from numpy")

        def zones(store, sub, start_ms, end_ms):
            """Seconds of the stitched view's cold, tier and raw reads."""
            sel, _ = tsdb.new_query()._apply_filters(
                mid, sub, store.series_ids_for_metric(mid), store)
            cold_rng, tier_rng, raw_rng = store._split(start_ms, end_ms)
            out_s = []
            t = time.perf_counter()
            if cold_rng is not None:
                store.cold.materialize(sel, *cold_rng)
            out_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            if tier_rng is not None:
                tsids = store._tier_sids(sel)
                store.tier.materialize(tsids[tsids >= 0], *tier_rng)
            out_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            if raw_rng is not None:
                store.raw.materialize(sel, *raw_rng)
            out_s.append(time.perf_counter() - t)
            return out_s

        def run(t_db, m, start_s, end_s, what):
            reset_launches(fused)
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows = t_db.execute_query(lc_query(m, start_s, end_s))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            return rows, secs, read_launches(fused)

        hist_end = LC_DEMOTE_B // 1000 - 1
        whole_end = LC_END_S - 1
        cold_end = LC_SPILL_B // 1000 - 1
        answers = {}
        # (b) the point path over the stitched view
        for m, kname in LC_QUERIES:
            key = "dc" if "{dc=*}" in m else "rack"
            other = "onehot_reduce" if kname == "span_reduce" \
                else "span_reduce"
            tq = lc_query(m, LC_START, hist_end)
            store = tsdb.new_query()._select_store(tq.queries[0])[0]
            check(isinstance(store, StitchedStore)
                  and store.cold is not None,
                  f"(b) {m}: the engine did not select the stitched view")
            secs = []
            for call in ("cold", "warm"):
                rows, s_, n_l = run(tsdb, m, LC_START, hist_end, call)
                secs.append(s_)
                check(n_l == {kname: 1, other: 0},
                      f"(b) {m} history, {call}: launches {n_l}")
                launches[kname] += 1
            answers[("hist", m)] = rows
            err = lc_held(rows, key, lc_grouped(m1[:, :n_1m], key),
                          lc_grouped(m1[:, :n_1m], key), f"(b) {m}")
            # the kernel against its plain version on the stitched batch
            sub = tq.queries[0]
            eng = tsdb.new_query()
            sel, tag_mat = eng._apply_filters(
                mid, sub, store.series_ids_for_metric(mid), store)
            gids, g = eng._group_ids(
                tag_mat, [tsdb.uids.tag_names.get_id(key)])
            padded = store.materialize_padded(sel, tq.start_ms, tq.end_ms)
            bidx, bts = ds_mod.assign_buckets_padded(
                padded.ts2d, padded.counts, sub.ds_spec, tq.start_ms,
                tq.end_ms)
            k = pipeline.detect_regular_padded(padded.counts, bidx,
                                               len(bts))
            check(k == 1, f"(b) {m}: the stitched history is not one cell "
                  f"a bucket ({k})")
            spec = PipelineSpec(num_series=len(sel), num_buckets=len(bts),
                                num_groups=g, ds_function="sum",
                                agg_name="sum")
            vals = pipeline.upload(padded.values2d, torch.float32, "cuda")
            name, kerr, _ = kernel_vs_plain(fused, spec, vals, bts, gids,
                                            k, float(2**64 - 1), 0.0,
                                            allow_span=True)
            check(name == kname, f"(b) {m}: {name} on the stitched batch")
            z = zones(store, sub, tq.start_ms, tq.end_ms)
            print(f"  (b) {m} over the demoted {n_1m} min (cold {n_cold}"
                  f" + RAM tier {n_1m - n_cold} cells a series, the point "
                  f"path): cold "
                  f"{secs[0] * 1e3:.1f} ms, warm {secs[1] * 1e3:.1f} ms, "
                  f"one {kname} launch a call; zone reads cold "
                  f"{z[0] * 1e3:.1f} ms, tier {z[1] * 1e3:.1f} ms; "
                  f"{kname} on the stitched batch against its plain "
                  f"version max |d| {kerr!r}; against numpy float64 "
                  f"worst {err!r} of sum|terms|")
            out[f"b_{key}_cold_ms"] = secs[0] * 1e3
            out[f"b_{key}_warm_ms"] = secs[1] * 1e3
            # the whole 2 h: 60 raw points a bucket after the boundary,
            # one cell before it: irregular rows, no kernel
            rows, s_, n_l = run(tsdb, m, LC_START, whole_end, "whole")
            check(n_l == {kname: 0, other: 0},
                  f"(b) {m} whole: launches {n_l}")
            answers[("whole", m)] = rows
            err = lc_held(rows, key, lc_grouped(m1, key),
                          lc_grouped(m1, key), f"(b) {m} whole")
            z = zones(store, sub, LC_START * 1000, LC_END_S * 1000 - 1)
            print(f"  (b) {m} over the whole 2 h (three zones, irregular "
                  f"rows: the padded/flat path, no kernel): "
                  f"{s_ * 1e3:.1f} ms; zone reads cold {z[0] * 1e3:.1f} "
                  f"ms, tier {z[1] * 1e3:.1f} ms, raw {z[2] * 1e3:.1f} ms;"
                  f" against numpy float64 worst {err!r} of sum|terms|")
            out[f"b_{key}_whole_ms"] = s_ * 1e3
            out[f"zones_{key}_ms"] = [x * 1e3 for x in z]

        # (c) the grid path at the default keys, and the cold zone alone
        for k_, v_ in POINT_KEYS.items():
            tsdb.config.override_config(k_, engine_defaults().get_string(k_))
        m, kname = LC_QUERIES[0]
        rows, s_, n_l = run(tsdb, m, LC_START, whole_end, "grid")
        check(n_l == {"span_reduce": 0, "onehot_reduce": 0},
              f"(c) grid launches {n_l}")
        for k_, v_ in POINT_KEYS.items():
            tsdb.config.override_config(k_, v_)
        err = lc_held(rows, "dc", lc_grouped(m1, "dc"),
                      lc_grouped(m1, "dc"), "(c) grid")
        rows_c, s_c, n_c = run(tsdb, m, LC_START, cold_end, "cold zone")
        check(n_c == {"span_reduce": 1, "onehot_reduce": 0},
              f"(c) cold-zone launches {n_c}")
        launches["span_reduce"] += 1
        err_c = lc_held(rows_c, "dc", lc_grouped(m1[:, :n_cold], "dc"),
                        lc_grouped(m1[:, :n_cold], "dc"), "(c) cold zone")
        print(f"  (c) {m} whole 2 h at the default keys (the grid path, "
              f"each zone's bucket_reduce): {s_ * 1e3:.1f} ms, worst "
              f"{err!r}; over the cold zone alone ([{LC_START}, "
              f"{cold_end}], the point path, one span_reduce launch): "
              f"{s_c * 1e3:.1f} ms, worst {err_c!r}")
        out["c_grid_ms"], out["c_cold_ms"] = s_ * 1e3, s_c * 1e3

        # (d) flush, reopen, the same bits
        t = time.perf_counter()
        tsdb.shutdown()
        flush_s = time.perf_counter() - t
        del router, tsdb
        gc.collect()
        t = time.perf_counter()
        tsdb = TSDB(Config(**point))
        open_s = time.perf_counter() - t
        mid = tsdb.uids.metrics.get_id(METRIC)
        check(tsdb.lifecycle.demote_boundary(mid) == LC_DEMOTE_B
              and tsdb.lifecycle.coldstore.spill_boundary(METRIC)
              == LC_SPILL_B, "(d) boundaries after the reopen")
        for m, kname in LC_QUERIES:
            rows, s_, n_l = run(tsdb, m, LC_START, hist_end, "reopened")
            check(n_l[kname] == 1, f"(d) {m}: launches {n_l}")
            launches[kname] += 1
            check(rows_bits(rows) == rows_bits(answers[("hist", m)]),
                  f"(d) {m}: the reopened answer differs in its bits")
        print(f"  (d) shutdown (flush) {flush_s:.3f} s; reopen "
              f"{open_s:.3f} s (snapshot, lifecycle.json, the cold "
              "manifest); both history queries bit-equal to (b), one "
              "launch each")
        out["flush_s"], out["reopen_s"] = flush_s, open_s

        # (f) an armed coldstore.read: a 503, then the full answer
        tsdb.faults.configure([("tsd.faults.coldstore.read_error_count",
                                "1")])
        router = HttpRpcRouter(tsdb)
        m, kname = LC_QUERIES[0]
        body = json.dumps({"start": LC_START, "end": cold_end, "queries": [
            {"metric": METRIC, "aggregator": "sum", "downsample": "1m-sum",
             "filters": [{"type": "wildcard", "tagk": "dc", "filter": "*",
                          "groupBy": True}]}]}).encode()
        reset_launches(fused)
        t = time.perf_counter()
        r1 = router.handle(HttpRequest(method="POST", path="/api/query",
                                       body=body))
        s1 = time.perf_counter() - t
        check(r1.status == 503 and r1.headers.get("Retry-After"),
              f"(f) a failed cold read answered {r1.status}")
        check(json.loads(r1.body)["error"]["code"] == 503,
              "(f) the 503 is not structured")
        t = time.perf_counter()
        r2 = router.handle(HttpRequest(method="POST", path="/api/query",
                                       body=body))
        s2 = time.perf_counter() - t
        check(r2.status == 200, f"(f) the next query answered {r2.status}")
        n_f = read_launches(fused)
        launches["span_reduce"] += n_f["span_reduce"]
        got = {tuple(sorted(d["tags"].items())): d["dps"]
               for d in json.loads(r2.body)}
        check(len(got) == min(n, 100) and all(len(v) == n_cold
                                      for v in got.values()),
              "(f) the next answer is not whole")
        print(f"  (f) tsd.faults.coldstore.read_error_count=1: 503 with "
              f"Retry-After in {s1 * 1e3:.1f} ms, no rows; the next query "
              f"200 in {s2 * 1e3:.1f} ms, {len(got)} groups x {n_cold} "
              f"buckets; read errors "
              f"{tsdb.lifecycle.coldstore.read_errors}")
        tsdb.shutdown()
        del tsdb, router
        gc.collect()

        # (e) percentiles over the three sketch zones
        out.update(lifecycle_sketch_zones(torch, root / "sketch"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 18: {out['phase_s']:.1f} s")
    return launches, out


def lifecycle_sketch_zones(torch, data_dir: Path) -> dict:
    """(e): a 1k-series metric demoted into the 1h tier with the sketch
    tier on: p99 by hour across the cold sketch blobs, the RAM sketch
    cells and the raw tail, within alpha of the exact order statistic,
    the same bits after a flush and a reopen (``sketches.bin``)."""
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.query.model import TSQuery
    from opentsdb_tpu_torch.sketch.query import documented_alpha
    keys = {"tsd.torch.device": "cuda",
            "tsd.core.auto_create_metrics": "true",
            "tsd.query.cache.enable": "false",
            "tsd.storage.data_dir": str(data_dir), **HOST_TAIL_OFF,
            **LC_KEYS, "tsd.lifecycle.demote_tiers": "1h",
            "tsd.lifecycle.demote_after": "30m",
            "tsd.lifecycle.spill_after": "1h",
            "tsd.sketch.enable": "true"}
    n = LC_SKETCH_SERIES
    p = LC_SPAN_S // LC_SKETCH_STEP_S
    rng = np.random.default_rng(19)
    vals = rng.lognormal(3.0, 0.7, (n, p))
    ts = LC_START + LC_SKETCH_STEP_S * np.arange(p, dtype=np.int64)
    t = TSDB(Config(**keys))
    t.add_series_points("sys.lat.lc", [{"host": f"h{i}"}
                                       for i in range(n)],
                        np.broadcast_to(ts, (n, p)), vals)
    tt = time.perf_counter()
    # now half an hour past the demotion boundary: the boundaries of
    # (a)-(d)
    rep = t.lifecycle.sweep(now_ms=LC_DEMOTE_B + 1800_000)
    sweep_s = time.perf_counter() - tt
    check("error" not in rep and rep["spilled"] > 0,
          f"(e) the sweep: {rep}")
    q = TSQuery.from_json({
        "start": str(T0), "end": str(LC_END_S - 1),
        "queries": [{"aggregator": "sum", "metric": "sys.lat.lc",
                     "downsample": "1h-avg",
                     "percentiles": list(LC_SKETCH_QS)}]}).validate()
    tt = time.perf_counter()
    rows = t.execute_query(q)
    q_s = time.perf_counter() - tt
    alpha = documented_alpha(t)
    hour = ts // 3600
    check(len(rows) == 1, f"(e) {len(rows)} rows")
    got_ts, got = rows[0].dps_arrays
    check(len(got_ts) == 3, f"(e) {len(got_ts)} buckets, not the three "
          "zones' hours")
    worst = 0.0
    for k, h in enumerate(sorted(set(hour.tolist()))):
        pts = np.sort(vals[:, hour == h].ravel())
        exact = pts[int(np.floor(LC_SKETCH_QS[0] / 100 * (len(pts) - 1)))]
        rel = abs(got[k] - exact) / abs(exact)
        worst = max(worst, rel)
        check(rel <= alpha, f"(e) hour {h}: {got[k]!r} vs exact "
              f"{exact!r}, relative {rel!r} > alpha {alpha}")
    t.shutdown()
    t2 = TSDB(Config(**keys))
    again = t2.execute_query(q)
    check(rows_bits(again) == rows_bits(rows),
          "(e) the reopened answer differs in its bits (sketches.bin)")
    t2.shutdown()
    print(f"  (e) p99 by hour over {n} series x {p} points at "
          f"{LC_SKETCH_STEP_S} s (cold sketch blobs, RAM sketch cells, "
          f"raw tail): sweep {sweep_s:.3f} s ({rep['demoted']} demoted, "
          f"{rep['spilled']} spilled), query {q_s * 1e3:.1f} ms; worst "
          f"relative error against the exact order statistic {worst!r} "
          f"<= alpha {alpha}; the same bits after a reopen")
    return {"e_sweep_s": sweep_s, "e_query_ms": q_s * 1e3,
            "e_worst_rel": worst}


def tsuid_of_db(tsdb, i: int) -> str:
    """Phase 17 (c): the TSUID of ``ops.hooked`` series i."""
    u = tsdb.uids
    return u.tsuid(u.metrics.get_id("ops.hooked"), sorted(
        (u.tag_names.get_id(k), u.tag_values.get_id(v)) for k, v in
        {"host": f"h{i}", "dc": f"dc{i % 100}",
         "rack": f"r{i % 2000}"}.items())).hex().upper()


# phase 19: observability and the control plane on the card
OBS_TAX_CALLS = 200        # (a): result-cache hits per tracing setting
OBS_TAX_PUT_STEPS = 100    # (a): 1000 series x 100 = 100k /api/put points
OBS_PROFILE_S = 5          # (b): the profile window read
CTL_SERIES = 100_000       # (c): phase 14's LIVE_SERIES
CTL_SPAN_S = 600           # (c): 10 minutes at 1 s
CTL_CHUNK = 10_000         # (c): series per append_grid
CTL_PULLS = 8              # (c): dashboard pulls before the tick
CTL_REPEATS = 2            # (c): pulls and batch calls per p50
QOS_NOISY = 16             # (d): clients of the noisy tenant
QOS_SECONDS = 3.0          # (d): how long the tenants send
CTL_QUERY = "sum:1m-sum:sys.cpu.user{dc=*}"
CTL_NOISY_QUERY = "sum:1m-avg:sys.cpu.user{rack=*}"
_OM_SAMPLE = (r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="'
              r'([^"\\]|\\.)*"(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?'
              r'\})? (-?[0-9.e+-]+|\+Inf|-Inf|NaN)$')


def openmetrics_samples(text: str) -> int:
    """A strict read of an OpenMetrics body: every line a HELP or TYPE
    comment or a valid sample, ``# EOF`` last; the sample count."""
    import re
    lines = text.split("\n")
    check(lines[-1] == "" and lines[-2] == "# EOF",
          "the /metrics body does not end with # EOF")
    sample = re.compile(_OM_SAMPLE)
    n = 0
    for ln in lines[:-2]:
        if ln.startswith(("# HELP ", "# TYPE ")):
            continue
        check(bool(sample.match(ln)), f"an invalid /metrics line: {ln!r}")
        n += 1
    return n


def query_tree_ok(doc: dict, m: str, s: int, g: int,
                  streaming: bool) -> None:
    """A ``/api/query`` trace's tree as ``tests/test_torch_trace.py``
    gives it for the same request on the CPU, plus the server's
    ``query.admission``: one ``query.http`` root carrying the shape tags
    and ``cache=miss``, and under it, each once, the admission, the
    plan (``series``, ``groups``), the execution, the assembly and the
    serialization; ids and durations aside."""
    roots = doc["tree"]
    check(len(roots) == 1 and roots[0]["name"] == "query.http",
          f"{m}: the trace has roots {[r['name'] for r in roots]}")
    root = roots[0]
    tags = root["tags"]
    metric = m.split(":")[-1].split("{")[0]
    check(tags["metrics"] == metric and tags["subs"] == 1
          and tags["aggregator"] == m.split(":")[0]
          and tags["cache"] == "miss" and tags["pixels"] == 0
          and tags["delete"] is False, f"{m}: root tags {tags}")
    want = {"query.admission": {}, "query.plan": {"sub": 0, "series": s,
                                                   "groups": g},
            "query.execute": {"sub": 0, "metric": metric},
            "query.assemble": {"sub": 0, "groups": g, "pixels": 0},
            "query.serialize": {}}
    if streaming:
        want["query.streaming_lookup"] = {"sub": 0}
    got = {c["name"]: c.get("tags", {}) for c in root["children"]}
    check(len(root["children"]) == len(want) and got == want,
          f"{m}: the stages {got}, expected {want}")
    check(all(not c["children"] and c["parentId"] == root["spanId"]
              for c in root["children"]), f"{m}: a stage is not a child "
          "of the root")


def grouped_values(rows: list, key: str, g: int):
    """A JSON answer's rows as a [G, B] float64 tensor, row i the group
    whose ``key`` tag ends in i."""
    import torch
    prefix = "dc" if key == "dc" else "r"
    idx = [int(r["tags"][key][len(prefix):]) for r in rows]
    check(sorted(idx) == list(range(g)), f"{len(idx)} groups, not {g}")
    out = [None] * g
    for i, r in zip(idx, rows):
        out[i] = list(r["dps"].values())
    return torch.tensor(out, dtype=torch.float64)


def phase_obs(torch, tsdb, values, report: dict) -> dict:
    """Phase 19 (a) and (b) on config 3's TSDB (phase 3's data and
    keys): traced queries through the socket server, the tracing tax,
    and the read surface while it serves. The window is phase 15's,
    clear of phase 6's late write, so that the point path's rows are
    regular and the kernels run. Returns the kernels' launches and the
    readings for the ``obs`` line."""
    import http.client
    import urllib.parse
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.tsd.server import ServerThread
    cfg = tsdb.config
    for key, value in ENGINE_KEYS.items():
        cfg.override_config(key, value)
    cfg.override_config("tsd.trace.sample", "1")
    tracer = tsdb.tracer
    tracer.sample_n = 1         # keep every root for the phase
    st = serve_pinned(ServerThread, tsdb)
    total = {"span_reduce": 0, "onehot_reduce": 0}
    out: dict = {}
    lo, hi = SURF_WINDOW
    nb = (hi - lo + 1) // 300

    def path_of(m: str) -> str:
        return "/api/query?" + urllib.parse.urlencode(
            {"start": lo, "end": hi, "m": m})

    conn = http.client.HTTPConnection("127.0.0.1", st.port, timeout=600)
    try:
        # (a) the two kernel queries, traced
        for m, kname in QUERIES:
            other = next(k for _, k in QUERIES if k != kname)
            reset_launches(fused)
            body = json.dumps({"start": str(lo), "end": str(hi),
                               "queries": [_sub_json(m)]}).encode()
            conn.request("POST", "/api/query", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            n = read_launches(fused)
            check(resp.status == 200, f"{m}: HTTP {resp.status}")
            check(n == {kname: 1, other: 0}, f"{m}: launched {n}")
            total[kname] += 1
            tid = resp.getheader("X-TSD-Trace-Id")
            check(bool(tid), f"{m}: no X-TSD-Trace-Id")
            status, tbody, _ = _http(conn, "GET", f"/api/trace/{tid}")
            check(status == 200, f"{m}: /api/trace/{tid}: {status}")
            doc = json.loads(tbody)
            key = "dc" if "{dc=*}" in m else "rack"
            wv, terms = (torch.from_numpy(x) for x in
                         config3_window(values, "avg", key, nb))
            g = wv.shape[0]
            query_tree_ok(doc, m, len(tsdb.store.series_ids_for_metric(
                tsdb.uids.metrics.get_id(METRIC))), g,
                tsdb._streaming is not None)
            err = compare(grouped_values(json.loads(data), key, g), wv,
                          terms)
            spans = {s["name"]: s["durationMs"] for s in doc["spans"]}
            kernel_ms = report[kname]["ms"]
            check(spans["query.execute"] >= kernel_ms,
                  f"{m}: query.execute {spans['query.execute']} ms is "
                  f"below the kernel's {kernel_ms} ms")
            print(f"  (a) {m}: one {kname} launch inside trace {tid}; "
                  "its tree is the tests' (query.http: admission, plan, "
                  "execute, assemble, serialize); max |d| vs a float64 "
                  f"numpy reference {err!r}; query.execute "
                  f"{spans['query.execute']:.3f} ms >= the kernel's "
                  f"{kernel_ms:.4f} ms (CUDA events, phase 3); root "
                  f"{spans['query.http']:.3f} ms, admission "
                  f"{spans['query.admission']:.3f}, plan "
                  f"{spans['query.plan']:.3f}, assemble "
                  f"{spans['query.assemble']:.3f}, serialize "
                  f"{spans['query.serialize']:.3f}")
            out[f"{kname}_execute_ms"] = spans["query.execute"]
            out[f"{kname}_root_ms"] = spans["query.http"]
        stages = tsdb.stats.latency_summary()["stages"]
        print("  (a) stage p50s (ms, stage histograms, 1 ms buckets): "
              + ", ".join(f"{k} {v['p50']:g} (n={v['count']})"
                          for k, v in sorted(stages.items())))

        # (a) the tax: result-cache hits and a 100k-point /api/put, the
        # tracer on and off on this TSDB
        cfg.override_config("tsd.query.cache.enable", "true")
        m = QUERIES[0][0]
        reset_launches(fused)
        status, miss, _ = _http(conn, "GET", path_of(m))
        check(status == 200, f"the cache's miss: HTTP {status}")
        total["span_reduce"] += read_launches(fused)["span_reduce"]
        hits = {True: [], False: []}
        for block in range(4):
            on = block % 2 == 0
            tracer.enabled = on
            for _ in range(OBS_TAX_CALLS // 2):
                status, body, secs = _http(conn, "GET", path_of(m))
                check(status == 200 and body == miss,
                      "a result-cache hit differs from its miss")
                hits[on].append(secs)
        put_s = {}
        for on in (True, False):
            tracer.enabled = on
            put_s[on] = put_points(st.port, f"sys.tax.{int(on)}",
                                   steps=OBS_TAX_PUT_STEPS)
        tracer.enabled = True
        cfg.override_config("tsd.query.cache.enable", "false")
        n_put = PUT_SERIES * OBS_TAX_PUT_STEPS
        out.update({"hit_p50_traced_ms": p50(hits[True]) * 1e3,
                    "hit_p50_untraced_ms": p50(hits[False]) * 1e3,
                    "put_100k_traced_s": put_s[True],
                    "put_100k_untraced_s": put_s[False]})
        print(f"  (a) tracing tax: result-cache hit p50 "
              f"{out['hit_p50_traced_ms']:.4f} ms traced vs "
              f"{out['hit_p50_untraced_ms']:.4f} ms untraced "
              f"({OBS_TAX_CALLS} HTTP calls each, alternating blocks of "
              f"{OBS_TAX_CALLS // 2}); /api/put of {n_put} points "
              f"{put_s[True]:.3f} s traced ({n_put / put_s[True]:,.0f} "
              f"points/s) vs {put_s[False]:.3f} s untraced "
              f"({n_put / put_s[False]:,.0f} points/s)")

        # (b) the read surface while it serves
        reads = {}
        for path in ("/metrics", "/api/health", "/api/stats/raw",
                     f"/api/profile?seconds={OBS_PROFILE_S}", "/logs"):
            status, body, secs = _http(conn, "GET", path)
            check(status == 200, f"{path}: HTTP {status}")
            reads[path.split("?")[0]] = (body, secs)
        first_ms = reads["/metrics"][1] * 1e3
        metrics_s = []
        for _ in range(REPEATS):
            status, body, secs = _http(conn, "GET", "/metrics")
            check(status == 200, f"/metrics: HTTP {status}")
            metrics_s.append(secs)
        secs = p50(metrics_s)
        n_samples = openmetrics_samples(body.decode())
        health = json.loads(reads["/api/health"][0])
        raw = json.loads(reads["/api/stats/raw"][0])
        prof = reads["/api/profile"][0].decode()
        roles = sorted({ln.split(";", 1)[0] for ln in prof.splitlines()})
        check("query" in roles, f"no query role in the profile: {roles}")
        n_logs = len(reads["/logs"][0].splitlines())
        out.update({"metrics_ms": secs * 1e3,
                    "metrics_first_ms": first_ms,
                    "metrics_bytes": len(body),
                    "health_status": health["status"]})
        print(f"  (b) /metrics: {secs * 1e3:.3f} ms p50 over {REPEATS} "
              f"(the first {first_ms:.3f} ms), {len(body):,} bytes, "
              f"{n_samples} samples, every line valid, # EOF last; "
              f"/api/health: status {health['status']}, causes "
              f"{health['causes']} ({reads['/api/health'][1] * 1e3:.3f} "
              f"ms); /api/stats/raw: {len(raw['records'])} records, "
              f"{len(raw['histograms'])} histograms "
              f"({reads['/api/stats/raw'][1] * 1e3:.3f} ms); "
              f"/api/profile?seconds={OBS_PROFILE_S}: roles {roles}, "
              f"{len(prof.splitlines())} stacks; /logs: {n_logs} lines")
    finally:
        conn.close()
        st.stop()
    return total, out


def phase_control(torch, n_series: int) -> tuple[dict, dict]:
    """Phase 19 (c)-(e) on a TSDB of their own: the control plane at the
    live dashboard's width, tenant QoS over sockets, and the
    self-telemetry pump. Returns the kernels' launches and the readings
    for the ``obs`` line."""
    import http.client
    import shutil
    import tempfile
    import urllib.parse
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.control.shapes import (auto_id, candidate_body,
                                                   cq_candidate)
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.query.engine import host_tail_for_dims
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    from opentsdb_tpu_torch.tsd.server import ServerThread
    total = {"span_reduce": 0, "onehot_reduce": 0}
    out: dict = {}
    root = Path(tempfile.mkdtemp(prefix="tsd-control-"))
    keys = {"tsd.torch.device": "cuda",
            "tsd.core.auto_create_metrics": "true",
            "tsd.query.cache.enable": "false", **HOST_TAIL_OFF,
            "tsd.tpu.warmup": "false",
            "tsd.storage.data_dir": str(root),
            "tsd.storage.wal.enable": "false",
            "tsd.trace.sample": "1",
            "tsd.control.enable": "true",
            # ticks by POST /api/control/tick only
            "tsd.control.interval_s": "0",
            "tsd.control.materialize.min_score": "0",
            "tsd.control.qos.enable": "true",
            "tsd.control.tenant.header": "x-tsd-tenant",
            "tsd.query.admission.max_inflight": "4",
            "tsd.stats.self_interval": "1"}
    tsdb = TSDB(Config(**keys))
    st = None
    try:
        # data: n series x 10 min at 1 s from seed 19, ending a minute
        # before the current one, so that "15m-ago" holds it whole
        m0 = int(time.time()) // 60 * 60 - 660
        rng = np.random.default_rng(19)
        ts_grid = m0 * 1000 + 1000 * np.arange(CTL_SPAN_S, dtype=np.int64)
        mid = tsdb.uids.metrics.get_or_create_id(METRIC)
        t = time.perf_counter()
        for lo in range(0, n_series, CTL_CHUNK):
            hi = min(lo + CTL_CHUNK, n_series)
            vals = rng.normal(100.0, 10.0, (hi - lo, CTL_SPAN_S))
            _, tag_ids = tsdb._resolve_uids(
                METRIC, [live_tags(i) for i in range(lo, hi)])
            sids = tsdb.store.get_or_create_series_bulk(mid, tag_ids)
            tsdb.store.append_grid(sids, ts_grid, vals,
                                   np.ones(vals.shape, dtype=bool))
        ingest_s = time.perf_counter() - t
        print(f"  (c) ingest: {n_series} series x {CTL_SPAN_S} points at "
              f"1 s from {m0} (seed 19) by append_grid: {ingest_s:.3f} s")
        st = serve_pinned(ServerThread, tsdb)
        conn = http.client.HTTPConnection("127.0.0.1", st.port,
                                          timeout=600)
        pull_path = "/api/query?" + urllib.parse.urlencode(
            {"start": "15m-ago", "m": CTL_QUERY})
        hdr = {"X-TSD-Tenant": "victim"}

        def pull(c, headers=None):
            t = time.perf_counter()
            c.request("GET", pull_path, headers=headers or {})
            r = c.getresponse()
            data = r.read()
            return r.status, data, time.perf_counter() - t, \
                r.getheader("X-TSD-Trace-Id")

        # (c) the dashboard pulled CTL_PULLS times, then one tick
        pulls = []
        for _ in range(CTL_PULLS):
            status, body, secs, _ = pull(conn)
            check(status == 200, f"a dashboard pull: HTTP {status}")
            pulls.append(secs)
        cand = cq_candidate(TSQuery(start="15m-ago", queries=[
            parse_uri_subquery(CTL_QUERY)]).validate())
        cid = auto_id(cand)
        t = time.perf_counter()
        status, tick, _ = _http(conn, "POST", "/api/control/tick")
        tick_s = time.perf_counter() - t
        tick = json.loads(tick)
        check(status == 200 and tick["errors"] == {}
              and tick["materialize"]["registered"] == 1,
              f"the tick: HTTP {status} {tick}")
        reg = tsdb.streaming
        check(reg.get(cid) is not None, f"no auto query {cid} registered")
        hits0 = reg.serve_hits
        status, auto_body, secs, tid = pull(conn)
        check(status == 200 and reg.serve_hits == hits0 + 1,
              "the pull after the tick was not served by the registry")
        status, tbody, _ = _http(conn, "GET", f"/api/trace/{tid}")
        names = {s["name"] for s in json.loads(tbody)["spans"]}
        check("query.streaming_lookup" in names
              and "query.execute" not in names,
              f"the served pull's trace holds {sorted(names)}")
        served = []
        for _ in range(CTL_REPEATS):
            status, body, secs, _ = pull(conn)
            check(status == 200 and body == auto_body,
                  "a served pull differs from the first")
            served.append(secs)
        # a hand-registered query of the same body, bootstrapped anew
        reg.delete(cid)
        reg.register(dict(candidate_body(cand), id="hand"))
        hits0 = reg.serve_hits
        status, hand_body, _, _ = pull(conn)
        check(status == 200 and reg.serve_hits == hits0 + 1,
              "the hand-registered query did not serve the pull")
        check(hand_body == auto_body, "the auto continuous query's answer "
              "differs from a hand-registered one's")
        # the engine's batch answer: the whole data buckets, on the point
        # path (K1), every cache off
        for key, value in ENGINE_KEYS.items():
            tsdb.config.override_config(key, value)
        batch_q = {"start": m0, "end": m0 + CTL_SPAN_S - 1,
                   "queries": [_sub_json(CTL_QUERY)]}
        batch_s = []
        for i in range(CTL_REPEATS):
            reset_launches(fused)
            status, bbody, secs = _http(conn, "POST", "/api/query",
                                        json.dumps(batch_q).encode())
            n = read_launches(fused)
            check(status == 200 and n == {"span_reduce": 1,
                                          "onehot_reduce": 0},
                  f"the batch answer: HTTP {status}, launched {n}")
            total["span_reduce"] += 1
            batch_s.append(secs)
        # back to the default engine keys (the grid path) for (d)
        for key in ("tsd.query.grid_reduce", "tsd.query.device_cache_mb"):
            tsdb.config.override_config(
                key, engine_defaults().get_string(key))
        got = {tuple(sorted(r["tags"].items())): r["dps"]
               for r in json.loads(auto_body)}
        want = {tuple(sorted(r["tags"].items())): r["dps"]
                for r in json.loads(bbody)}
        check(set(got) == set(want) and len(got) == 100,
              "the served and batch answers hold other groups")
        err = 0.0
        for k, dps in want.items():
            check(set(dps) <= set(got[k]), f"{k}: buckets differ")
            for ts, v in dps.items():
                d = abs(got[k][ts] - v)
                check(d <= TOL_REL * abs(v) + TOL_ABS,
                      f"{k} @{ts}: served {got[k][ts]} vs batch {v}")
                err = max(err, d)
        out.update({"tick_s": tick_s, "pull_before_p50_ms":
                    p50(pulls) * 1e3, "served_pull_p50_ms":
                    p50(served) * 1e3, "batch_p50_ms": p50(batch_s) * 1e3})
        print(f"  (c) {CTL_PULLS} pulls of {CTL_QUERY} over 15m-ago "
              f"(grid path, p50 {p50(pulls) * 1e3:.3f} ms), then POST "
              f"/api/control/tick: {tick_s:.3f} s, {cid} registered "
              f"({tick['materialize']}); the next pull served by the "
              "registry (query.streaming_lookup in its trace, "
              f"serve_hits +1), p50 {p50(served) * 1e3:.3f} ms over "
              f"{CTL_REPEATS}; equal byte for byte to a hand-registered "
              "query of the same body; the engine's batch answer over "
              f"the data's 10 buckets (K1, one launch a call, caches off) "
              f"p50 {p50(batch_s) * 1e3:.3f} ms, max |served - batch| "
              f"{err!r}")
        conn.close()

        # (d) tenant QoS over sockets: QOS_NOISY noisy clients and one
        # victim, max_inflight 4
        noisy_path = "/api/query?" + urllib.parse.urlencode(
            {"start": m0, "end": m0 + CTL_SPAN_S - 1,
             "m": CTL_NOISY_QUERY})
        warm = http.client.HTTPConnection("127.0.0.1", st.port, timeout=600)
        check(pull(warm, hdr)[0] == 200, "the victim's first pull")
        status, _, _ = _http(warm, "GET", noisy_path)
        check(status == 200, "the noisy query's first call")
        warm.close()
        results = {"noisy": [], "victim": []}
        lock = threading.Lock()
        stop_at = time.monotonic() + QOS_SECONDS

        def client(tenant: str, path: str) -> None:
            c = http.client.HTTPConnection("127.0.0.1", st.port,
                                           timeout=600)
            try:
                while time.monotonic() < stop_at:
                    t = time.perf_counter()
                    c.request("GET", path, headers={"X-TSD-Tenant": tenant})
                    r = c.getresponse()
                    data = r.read()
                    rec = (r.status, r.getheader("Retry-After"), data,
                           time.perf_counter() - t)
                    with lock:
                        results[tenant].append(rec)
                    if r.getheader("Connection", "") == "close":
                        c.close()
                        c = http.client.HTTPConnection(
                            "127.0.0.1", st.port, timeout=600)
            finally:
                c.close()

        threads = [threading.Thread(target=client,
                                    args=("noisy", noisy_path))
                   for _ in range(QOS_NOISY)]
        threads.append(threading.Thread(target=client,
                                        args=("victim", pull_path)))
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        noisy_sheds = [(ra, json.loads(b)["error"])
                       for s, ra, b, _ in results["noisy"] if s == 503]
        tenant_sheds = [(ra, e) for ra, e in noisy_sheds
                        if "shed cause: tenant" in e["details"]]
        check(tenant_sheds and all(ra == "1" for ra, _ in tenant_sheds),
              f"the noisy tenant shed {len(tenant_sheds)} tenant 503s")
        victim = results["victim"]
        check(all(s == 200 for s, _, _, _ in victim),
              "the victim was shed: "
              f"{[s for s, _, _, _ in victim if s != 200]}")
        lat = sorted(secs for _, _, _, secs in victim)
        v99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
        conn = http.client.HTTPConnection("127.0.0.1", st.port, timeout=600)
        status, tbody, _ = _http(conn, "GET", "/api/stats/tenants")
        tenants = json.loads(tbody)
        check(tenants["tenants"]["victim"]["shed"] == 0
              and tenants["tenants"]["noisy"]["shed"]
              == len(tenant_sheds), f"/api/stats/tenants: {tenants}")
        out.update({"victim_p50_ms": p50(lat) * 1e3,
                    "victim_p99_ms": v99 * 1e3,
                    "noisy_tenant_sheds": len(tenant_sheds),
                    "noisy_served": sum(1 for s, _, _, _ in
                                        results["noisy"] if s == 200)})
        print(f"  (d) {QOS_NOISY} noisy clients ({CTL_NOISY_QUERY}) and "
              f"one victim (the served dashboard) for {QOS_SECONDS:g} s "
              "at max_inflight 4: noisy "
              f"{len(results['noisy'])} calls, {len(tenant_sheds)} "
              "tenant 503s with Retry-After, "
              f"{len(noisy_sheds) - len(tenant_sheds)} other 503s; victim "
              f"{len(victim)} calls, none shed, p50 {p50(lat) * 1e3:.3f} "
              f"ms, p99 {v99 * 1e3:.3f} ms; /api/stats/tenants "
              + json.dumps({k: {f: v[f] for f in ("requests", "shed",
                                                   "weight", "penalty")}
                            for k, v in tenants["tenants"].items()}))

        # (e) the self-telemetry pump (tsd.stats.self_interval=1)
        deadline = time.monotonic() + 10
        while tsdb.telemetry.pumps < 3:
            check(time.monotonic() < deadline, "fewer than 3 pumps in 10 s")
            time.sleep(0.1)
        path = "/api/query?" + urllib.parse.urlencode(
            {"start": "5m-ago", "m": "sum:tsd.datapoints.added"})
        status, body, secs = _http(conn, "GET", path)
        rows = json.loads(body) if status == 200 else []
        check(status == 200 and len(rows) == 1
              and len(rows[0]["dps"]) >= 3,
              f"tsd.datapoints.added: HTTP {status}, {body[:200]!r}")
        s_self = len(tsdb.store.series_ids_for_metric(
            tsdb.uids.metrics.get_id("tsd.datapoints.added")))
        b_self = len(rows[0]["dps"])
        at_default = host_tail_for_dims(Config(), s_self, b_self, 1,
                                        True, "sum")
        as_run = host_tail_for_dims(tsdb.config, s_self, b_self, 1, True,
                                    "sum")
        conn.close()
        print(f"  (e) {tsdb.telemetry.pumps} pumps "
              f"({tsdb.telemetry.points_written} points); sum:tsd."
              f"datapoints.added over 5m-ago answers {b_self} points in "
              f"{secs * 1e3:.3f} ms; its tail [S={s_self}, B={b_self}]: "
              f"{'host' if at_default is not None else 'card'} at the "
              "default budgets, "
              f"{'host' if as_run is not None else 'card'} as run (host "
              "tail pinned off)")
    finally:
        # the data_dir holds the shape log only: the stop's flush would
        # snapshot the phase's 60M points (~25 s on the card's host)
        tsdb.data_dir = ""
        if st is not None:
            st.stop()
        else:
            tsdb.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    left = [th.name for th in threading.enumerate() if th.name.startswith(
        ("tsd-control", "tsd-telemetry", "tsd-profiler", "tsd-query",
         "tsd-http", "tsd-server"))]
    check(not left, f"threads left after phase 19: {left}")
    return total, out


# phase 20: the cluster at one replica on the card
CLUSTER_SHARDS = 3
# the series with dc0-dc51 (520k of 1M): every {dc=*} and {rack=*}
# group of the cut is a whole group of phase 3's answer (rack = i %
# 2000, dc = i % 100), and each shard keeps 1040 rack groups, past the
# span layout's 1024, so {rack=*} runs the one-hot kernel there. A
# quarter (dc0-dc24) would leave 500 racks and put {rack=*} on the span
# kernel on every shard. CUT from 600k (dc0-dc59), at which phase 20
# took 73.1 s on one H100 80GB HBM3 at 700 W (ROADMAP's chip_smoke.py
# notes)
CLUSTER_DCS = 52
CLUSTER_REPEATS = 2        # (b): timed calls per p50, after a warm-up
CLUSTER_AVG = "avg:5m-avg:rate:sys.cpu.user{dc=*}"
CLUSTER_MAX = "max:5m-avg:rate:sys.cpu.user{dc=*}"
# (c): 1000 series x 50 = 50k /api/put points, CUT from 100k for the
# run's time with phase 23
CLUSTER_PUT_STEPS = 50
CLUSTER_TEL_LINES = 10_000  # (c): one telnet burst
CLUSTER_OUTAGE_POINTS = 10_000  # (d): points put while s1 is down


def _listener(st, up: bool, port: int = 0) -> None:
    """Close (``up=False``) or reopen a ServerThread's listener on its
    own loop: a closed listener is a shard that went away, its data
    kept (the reference's LivePeer.kill and restart)."""
    import asyncio
    srv = st.server

    async def close():
        s = srv._server
        if s is not None:
            s.close()
            await s.wait_closed()
            srv._server = None

    async def reopen():
        srv._server = await asyncio.start_server(
            srv._handle_connection, "127.0.0.1", port, reuse_address=True)

    asyncio.run_coroutine_threadsafe(
        close() if not up else reopen(), srv._loop).result(60)


def _cluster_rows(handler, request_cls, m: str, start: str, end: str):
    """(status, rows, degraded shards, trace id) of one router query."""
    resp = handler.handle(request_cls(
        method="GET", path="/api/query",
        params={"start": [start], "end": [end], "m": [m]}))
    doc = json.loads(resp.body)
    degraded = []
    if doc and isinstance(doc[-1], dict) and "shardsDegraded" in doc[-1]:
        degraded = doc[-1]["shardsDegraded"]
        doc = doc[:-1]
    return resp.status, doc, degraded, resp.headers.get("X-TSD-Trace-Id")


def _held_groups(torch, rows, key: str, want, terms, what: str) -> float:
    """Hold each merged group (``<key>=<prefix><n>``) to row n of
    phase 3's float64 answer by phase 2's rule; max |got - want|."""
    import numpy as np
    prefix = "dc" if key == "dc" else "r"
    idx = [int(r["tags"][key][len(prefix):]) for r in rows]
    got = torch.tensor([list(r["dps"].values()) for r in rows],
                       dtype=torch.float64)
    check(got.shape == (len(rows), want.shape[1]),
          f"{what}: unexpected shape {tuple(got.shape)}")
    sel = torch.tensor(idx)
    return compare(got, want[sel], terms[sel])


def phase_cluster(torch, data, ref3: dict, card: str, profile: bool,
                  header) -> tuple[dict, dict, dict]:
    """Phase 20: a cluster router in front of three shard TSDs on one
    card (``data`` is :func:`make_data`'s), then phase 21 (a) on the
    same cluster before it stops. Returns the kernel launches of (b),
    the ``cluster`` line, and what phase 21 takes from here: the wire
    answers of (b) (``rf1_rows``), 21 (a)'s launches (``fed_launches``)
    and its readings (``fed``)."""
    import http.client
    import socket
    import tempfile

    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.cluster.hashring import series_shard_key
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
    from opentsdb_tpu_torch.tsd.server import ServerThread

    t_phase = time.perf_counter()
    out: dict = {"card": card}
    marks = [t_phase]
    stage_s: dict = {}

    def mark(name: str) -> None:
        marks.append(time.perf_counter())
        stage_s[name] = marks[-1] - marks[-2]

    shard_keys = {"tsd.torch.device": "cuda",
                  "tsd.core.auto_create_metrics": "true",
                  "tsd.cluster.role": "shard", **ENGINE_KEYS}
    shards = [TSDB(Config(**shard_keys)) for _ in range(CLUSTER_SHARDS)]
    sts = [serve_pinned(ServerThread, t) for t in shards]
    spec = ",".join(f"s{i}=127.0.0.1:{st.port}" for i, st in enumerate(sts))
    spool = Path(tempfile.mkdtemp(prefix="chip_smoke_spool_"))
    router_keys = {"tsd.torch.device": "cuda",
                   "tsd.cluster.role": "router", "tsd.cluster.peers": spec,
                   "tsd.cluster.spool.dir": str(spool),
                   "tsd.cluster.spool.replay_interval_ms": "100",
                   "tsd.cluster.breaker.reset_timeout_ms": "300",
                   "tsd.trace.sample": "1",
                   # phase 21 (a): the federated stream pumps the shards
                   # every quarter second when no frame is queued
                   "tsd.streaming.heartbeat_s": "0.25"}
    router = TSDB(Config(**router_keys))
    rst = serve_pinned(ServerThread, router)
    # the second router, over JSON HTTP, caches nothing: every call of
    # (b) reaches the shards
    plain = TSDB(Config(**{**router_keys,
                           "tsd.cluster.spool.dir": str(spool / "http"),
                           "tsd.cluster.wire.enable": "false",
                           "tsd.query.cache.enable": "false"}))
    wire_h, http_h = rst.server.http_router, HttpRpcRouter(plain)
    start, end = str(T0), str(T0 + POINTS * 60 - 1)
    mark("start")
    try:
        # (a) the data: config 3's series of dc0-dc51, placed by the
        # router's ring, each shard loading its own
        tags, ts2d, values = data
        n_series = len(tags)
        keep = np.asarray([i for i in range(n_series)
                           if i % 100 < CLUSTER_DCS], dtype=np.int64)
        ring = router.cluster.ring
        t = time.perf_counter()
        keys = [series_shard_key(METRIC, tags[i]) for i in keep.tolist()]
        owners = ring.shards_for_keys(keys)
        place_s = time.perf_counter() - t
        by_shard = {f"s{i}": [] for i in range(CLUSTER_SHARDS)}
        for i, own in zip(keep.tolist(), owners):
            by_shard[own[0]].append(i)
        t = time.perf_counter()
        for i, t_shard in enumerate(shards):
            rows = np.asarray(by_shard[f"s{i}"], dtype=np.int64)
            t_shard.add_series_points(METRIC, [tags[j] for j in rows],
                                      ts2d[rows], values[rows])
        load_s = time.perf_counter() - t
        dist = ring.distribution(keys)
        counts = {f"s{i}": int(t_shard.store.num_series())
                  for i, t_shard in enumerate(shards)}
        print(f"  (a) {len(keep)} series (dc0-dc{CLUSTER_DCS - 1}) x "
              f"{POINTS} points: ring placement {place_s:.3f} s, shard "
              f"loads {load_s:.3f} s; series per shard {counts} against "
              f"ring.distribution {dist} (on {card})")
        check(counts == dist, "a shard holds other series than the ring "
              "places on it")
        out.update(series=int(len(keep)), per_shard=counts)
        mark("a")

        # (b) reads through the router: the wire and JSON HTTP
        router.config.override_config("tsd.query.cache.enable", "false")
        reset_launches(fused)
        calls = {kname: 0 for _m, kname in QUERIES}
        reads: dict = {}
        wire_rows: dict = {}
        for m, kname in QUERIES:
            key = "dc" if "{dc=*}" in m else "rack"
            want, terms = ref3[m]
            for label, h in (("wire", wire_h), ("http", http_h)):
                secs = []
                for i in range(CLUSTER_REPEATS + 1):
                    tq = time.perf_counter()
                    status, rows, deg, _ = _cluster_rows(
                        h, HttpRequest, m, start, end)
                    secs.append(time.perf_counter() - tq)
                    calls[kname] += 1
                    check(status == 200 and not deg,
                          f"{m} over {label}: {status}, degraded {deg}")
                if label == "wire":
                    wire_rows[m] = rows
                err = _held_groups(torch, rows, key, want, terms,
                                   f"{m} over {label}")
                g = len(rows)
                check(g == (CLUSTER_DCS if key == "dc"
                            else 20 * CLUSTER_DCS),
                      f"{m}: {g} merged groups")
                reads[f"{key}_{label}_ms"] = p50(secs[1:]) * 1e3
                reads[f"{key}_max_abs_err"] = err
                print(f"  (b) {m} over {label}: p50 "
                      f"{p50(secs[1:]) * 1e3:.1f} ms of {CLUSTER_REPEATS} "
                      f"after a warm-up, {g} groups held to phase 3's "
                      f"answer, max |d| {err!r} (on {card})")
        got = read_launches(fused)
        print(f"  (b) launches {got} over {calls} router calls "
              f"x {CLUSTER_SHARDS} shards")
        for kname, n in calls.items():
            check(got[kname] == n * CLUSTER_SHARDS,
                  f"{kname}: {got[kname]} launches, want one per shard "
                  f"per call ({n * CLUSTER_SHARDS})")
        launches = dict(got)
        # an avg fans out as sum and count twins on each shard, both on
        # the span kernel; max merges exactly
        reset_launches(fused)
        secs = []
        for i in range(2):   # a warm-up and one timed call
            tq = time.perf_counter()
            status, avg_rows, deg, _ = _cluster_rows(
                wire_h, HttpRequest, CLUSTER_AVG, start, end)
            secs.append(time.perf_counter() - tq)
            check(status == 200 and not deg, f"avg: {status} {deg}")
        twins = read_launches(fused)
        check(twins["span_reduce"] == 2 * CLUSTER_SHARDS * 2,
              f"avg's twins launched {twins}")
        launches["span_reduce"] += twins["span_reduce"]
        launches["onehot_reduce"] += twins["onehot_reduce"]
        sum_rows = {r["tags"]["dc"]: r for r in wire_rows[QUERIES[0][0]]}
        # avg = sum / count over the same 10k series a group: the
        # group's sum divided by 10k, each bucket
        worst = 0.0
        for r in avg_rows:
            s_row = sum_rows[r["tags"]["dc"]]["dps"]
            for ts, v in r["dps"].items():
                want_v = s_row[ts] / (n_series // 100)
                worst = max(worst, abs(v - want_v) / max(abs(want_v), 1e-9))
        check(worst <= 1e-5, f"avg against sum / count: {worst!r}")
        _s, max_rows, _d, _t = _cluster_rows(wire_h, HttpRequest,
                                             CLUSTER_MAX, start, end)
        per_shard = []
        for t_shard in shards:
            tq = TSQuery(start=start, end=end,
                         queries=[parse_uri_subquery(CLUSTER_MAX)]
                         ).validate()
            per_shard.append({r.tags["dc"]: r.dps_arrays[1]
                              for r in t_shard.execute_query(tq)})
        for r in max_rows:
            want_max = np.max(np.stack([p[r["tags"]["dc"]]
                                        for p in per_shard]), axis=0)
            check(np.array_equal(np.asarray(list(r["dps"].values())),
                                 want_max),
                  f"max over the shards is not exact for {r['tags']}")
        reads["avg_wire_ms"] = secs[1] * 1e3
        print(f"  (b) {CLUSTER_AVG} over wire: {secs[1] * 1e3:.1f} ms "
              f"after a warm-up, {len(avg_rows)} groups = "
              f"sum / count within {worst:.2e}; {CLUSTER_MAX}: the "
              f"shards' maxes exactly (on {card})")
        out["reads"] = reads
        mark("b")

        # (c) writes through the router: /api/put and a telnet burst
        put_s = put_points(rst.port, "sys.cluster.put", CLUSTER_PUT_STEPS)
        n_put = PUT_SERIES * CLUSTER_PUT_STEPS
        lines = "".join(
            f"put sys.cluster.tel {T0 + j} {j % 997} host=t{j % 100}\n"
            for j in range(CLUSTER_TEL_LINES)).encode()
        t = time.perf_counter()
        with socket.create_connection(("127.0.0.1", rst.port), 600) as sk:
            sk.sendall(lines + b"version\nexit\n")
            buf = b""
            while chunk := sk.recv(65536):
                buf += chunk
        tel_s = time.perf_counter() - t
        check(buf.decode().startswith("opentsdb_tpu_torch version")
              and buf.count(b"\n") == 1,
              f"telnet answered more than the version: {buf[:300]!r}")
        # an acknowledged write is on its shard or in its spool: read
        # back once every spool has replayed (none is, as a rule)
        spooled = {n: p.spooled_points
                   for n, p in router.cluster.peers.items()}
        # each shard's write legs that spooled, read legs that failed,
        # and breaker failures and trips so far
        def legs_now() -> dict:
            return {n: {"spooled_batches": p.spooled_batches,
                        "query_failures": p.query_failures,
                        "breaker_failures": p.breaker.total_failures,
                        "breaker_trips": p.breaker.trips}
                    for n, p in router.cluster.peers.items()}

        legs = legs_now()
        print(f"  (c) legs after the writes: {legs}")
        deadline = time.perf_counter() + 60
        while any(p.spool.pending_records for p in
                  router.cluster.peers.values()) \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        check(not any(p.spool.pending_records
                      for p in router.cluster.peers.values()),
              "a spool did not drain after (c)'s writes")
        conn = http.client.HTTPConnection("127.0.0.1", rst.port,
                                          timeout=600)
        try:
            status, body, _ = _http(
                conn, "GET", f"/api/query?start={T0}&end={T0 + 7200}"
                "&m=none:sys.cluster.put&arrays=true")
            put_rows = json.loads(body)
            marks_ = [r for r in put_rows if "dps" not in r]
            check(status == 200 and not marks_, f"/api/put read back: "
                  f"HTTP {status}, {marks_}; legs now {legs_now()}")
            got_pts = sum(len(r["dps"]) for r in put_rows)
            check(status == 200 and got_pts == n_put,
                  f"/api/put read back {got_pts} of {n_put}")
            for r in json.loads(body)[:50]:
                i = int(r["tags"]["host"][1:])
                for ts, v in r["dps"]:
                    j = (ts - T0) // 60
                    check(v == (i * 7 + j) % 100_000,
                          f"put point {i},{j} reads back {v}")
            status, body, _ = _http(
                conn, "GET", f"/api/query?start={T0}&end={T0 + 20000}"
                "&m=zimsum:sys.cluster.tel&arrays=true")
            tel_rows = json.loads(body)
            marks_ = [r for r in tel_rows if "dps" not in r]
            check(status == 200 and not marks_, f"telnet burst read "
                  f"back: HTTP {status}, {marks_}; legs now {legs_now()}")
            check(sum(len(r["dps"]) for r in tel_rows)
                  == CLUSTER_TEL_LINES, "telnet burst read back short")
            check(sum(v for r in tel_rows for _t, v in r["dps"]) ==
                  sum(j % 997 for j in range(CLUSTER_TEL_LINES)),
                  "telnet burst read back other values")
        finally:
            conn.close()
        out["writes"] = {"put_points_per_s": n_put / put_s,
                         "telnet_lines_per_s": CLUSTER_TEL_LINES / tel_s,
                         "spooled_points": spooled, "legs": legs}
        print(f"  (c) {n_put} points by /api/put through the router: "
              f"{put_s:.3f} s ({n_put / put_s:,.0f} points/s); "
              f"{CLUSTER_TEL_LINES} telnet lines {tel_s:.3f} s "
              f"({CLUSTER_TEL_LINES / tel_s:,.0f} lines/s); both read "
              f"back exactly; points spooled on the way {spooled} "
              f"(on {card})")
        mark("c")

        # (d) an outage: s1's listener closed
        router.config.override_config("tsd.query.cache.enable", "true")
        rc = router.cluster
        stores0, skips0 = rc.cache_stores, rc.cache_degraded_skips
        s1_port = sts[1].port
        _listener(sts[1], up=False)
        status, rows, deg, _ = _cluster_rows(wire_h, HttpRequest,
                                             QUERIES[0][0], start, end)
        check(status == 200 and deg == ["s1"],
              f"outage: {status}, degraded {deg}")
        check(rc.cache_stores == stores0
              and rc.cache_degraded_skips == skips0 + 1,
              "the result cache kept a degraded answer")
        check(len(rows) == CLUSTER_DCS, "outage answer lost groups")
        pts = [{"metric": "sys.cluster.outage", "timestamp": T0 + j,
                "value": j, "tags": {"host": f"o{j % 1000}"}}
               for j in range(CLUSTER_OUTAGE_POINTS)]
        conn = http.client.HTTPConnection("127.0.0.1", rst.port,
                                          timeout=600)
        try:
            status, body, _ = _http(conn, "POST",
                                    "/api/put?summary=true",
                                    json.dumps(pts).encode())
            check(status == 200 and json.loads(body)["failed"] == 0,
                  f"outage put: {status} {body[:200]!r}")
            spooled = rc.peers["s1"].spool.pending_records
            check(spooled > 0, "nothing was spooled for s1")
            _listener(sts[1], up=True, port=s1_port)
            t = time.perf_counter()
            deadline = t + 120
            while rc.peers["s1"].spool.pending_records and \
                    time.perf_counter() < deadline:
                time.sleep(0.02)
            drain_s = time.perf_counter() - t
            check(rc.peers["s1"].spool.pending_records == 0,
                  "s1's spool did not drain")
            status, body, _ = _http(
                conn, "GET", f"/api/query?start={T0}&end={T0 + 20000}"
                "&m=zimsum:sys.cluster.outage&arrays=true")
            got = sorted(v for r in json.loads(body) for _t, v in r["dps"])
            check(got == list(range(CLUSTER_OUTAGE_POINTS)),
                  f"outage points read back: {len(got)}")
        finally:
            conn.close()
        out["outage"] = {"spooled_records": spooled, "drain_s": drain_s}
        print(f"  (d) s1 down: {{dc=*}} 200 with shardsDegraded ['s1'], "
              f"not cached; {CLUSTER_OUTAGE_POINTS} points acknowledged "
              f"into {spooled} spool record(s); s1 back: drained in "
              f"{drain_s:.3f} s, every point read back (on {card})")
        mark("d")

        # (e) the router's surface and a stitched trace
        surface_ms = {}
        for path in ("/api/cluster", "/api/cluster/status",
                     "/api/stats/fleet", "/api/health"):
            tq = time.perf_counter()
            resp = wire_h.handle(HttpRequest(method="GET", path=path))
            surface_ms[path] = (time.perf_counter() - tq) * 1e3
            check(resp.status == 200, f"{path}: {resp.status}")
            doc = json.loads(resp.body)
            if path == "/api/health":
                fl = doc["cluster"]["fleet"]
                check(doc["cluster"]["role"] == "router" and fl["ok"] ==
                      CLUSTER_SHARDS, f"health: {fl}")
            if path == "/api/stats/fleet":
                check(doc["shardsDegraded"] == [], "fleet degraded")
        router.config.override_config("tsd.query.cache.enable", "false")
        status, _rows, _deg, tid = _cluster_rows(
            wire_h, HttpRequest, QUERIES[0][0], start, end)
        check(status == 200 and tid, "the traced query kept no trace")
        resp = wire_h.handle(HttpRequest(method="GET",
                                         path=f"/api/trace/{tid}"))
        doc = json.loads(resp.body)
        roots = [s for s in doc["spans"] if s["name"] == "query.http"]
        legs = [s for s in doc["spans"] if s["name"] == "cluster.peer"]
        check(resp.status == 200 and len(roots) == CLUSTER_SHARDS + 1
              and len(legs) == CLUSTER_SHARDS
              and not doc.get("stitchIncomplete"),
              f"stitched trace: {len(roots)} roots, {len(legs)} legs")
        out["surface_ms"] = surface_ms
        print(f"  (e) /api/cluster, /status, /api/stats/fleet, /api/health "
              f"200 in " + ", ".join(f"{v:.1f}" for v in surface_ms.values())
              + f" ms, s1 just written by its spool; /api/trace/{tid}: "
              f"{doc['spanCount']} spans, a query.http leg from each of "
              f"{CLUSTER_SHARDS} shards under its cluster.peer span "
              f"(on {card})")
        if profile:
            device_share(torch, lambda: _cluster_rows(
                wire_h, HttpRequest, QUERIES[0][0], start, end),
                "a {dc=*} call through the router")
        mark("e")
        header(f"phase 21 (a): federated continuous queries through "
               f"phase 20's router, {len(keep)} series on "
               f"{CLUSTER_SHARDS} shards")
        t_fed = time.perf_counter()
        fed_launches, fed = phase_federated(
            torch, router, rst, wire_h, shards, sts, data, keep, card)
        fed["phase_s"] = time.perf_counter() - t_fed
        marks.append(time.perf_counter())
    finally:
        plain.shutdown()
        rst.stop()
        for st in sts:
            st.stop()
        shutil.rmtree(spool, ignore_errors=True)
    mark("stop")
    out["stage_s"] = stage_s
    out["phase_s"] = time.perf_counter() - t_phase - fed["phase_s"]
    print("  seconds by stage: " + ", ".join(
        f"{k} {v:.1f}" for k, v in stage_s.items()))
    print(f"phase 20: {out['phase_s']:.1f} s (phase 21 (a): "
          f"{fed['phase_s']:.1f} s)")
    return launches, out, {"rf1_rows": wire_rows,
                           "fed_launches": fed_launches, "fed": fed}


# phase 21 (a): federated continuous queries on phase 20's cluster
FED_QUERIES = (("fed-dc", "sum", "dc"), ("fed-rack", "max", "rack"))
FED_PUT_POINTS = 10_000    # points put through the router
FED_BODY = 1_000           # points per /api/put body
FED_PULLS = 2              # /result pulls per p50
FED_PUSH_S = 30.0          # the longest wait for a pushed frame
CQ_PATH = "/api/query/continuous"


def fed_body(cid: str, agg: str, key: str) -> dict:
    """One federated registration over the data's hour: an absolute
    window, since the data sits in 2013 (a relative window back to it
    would hold millions of one-minute windows)."""
    return {"id": cid, "start": T0 * 1000,
            "end": (T0 + POINTS * 60 - 1) * 1000,
            "queries": [{"metric": METRIC, "aggregator": agg,
                         "downsample": f"1m-{agg}",
                         "filters": [{"type": "wildcard", "tagk": key,
                                      "filter": "*", "groupBy": True}]}]}


def fed_grid(rows, key: str, g: int):
    """[g, POINTS] float64 of a ``1m`` answer by ``key`` (rows' dps keyed
    by ms or s), NaN where a group-minute is absent; and the rows'
    trailing ``completeness`` marker, or None."""
    import numpy as np
    marker = None
    if rows and "completeness" in rows[-1] and "metric" not in rows[-1]:
        marker = rows[-1]["completeness"]
        rows = rows[:-1]
    out = np.full((g, POINTS), np.nan)
    prefix = "dc" if key == "dc" else "r"
    for r in rows:
        i = int(r["tags"][key][len(prefix):])
        for ts, v in r["dps"].items():
            t = int(ts)
            t = t // 1000 if t > 10 ** 11 else t
            out[i, (t - T0) // 60] = v
    return out, marker


def fed_reference(values, keep, put_rows, put_j, put_v):
    """Float64 numpy answers of both registrations over the cut's
    values and the put points: ``{key: (want, terms)}`` with [g, POINTS]
    arrays, rows the groups (dc i, rack i); the max's terms are
    |want|."""
    import numpy as np
    vals = values[keep]
    dc, rack = keep % 100, keep % 2000
    s_want = np.stack([np.bincount(dc, vals[:, j], minlength=100)
                       for j in range(POINTS)], axis=1)
    s_terms = np.stack([np.bincount(dc, np.abs(vals[:, j]), minlength=100)
                        for j in range(POINTS)], axis=1)
    np.add.at(s_want, (put_rows % 100, put_j), put_v)
    np.add.at(s_terms, (put_rows % 100, put_j), np.abs(put_v))
    s_want[np.bincount(dc, minlength=100) == 0] = np.nan
    order = np.argsort(rack, kind="stable")
    starts = np.flatnonzero(np.r_[True, np.diff(rack[order]) != 0])
    m_want = np.full((2000, POINTS), np.nan)
    m_want[rack[order][starts]] = np.maximum.reduceat(vals[order], starts,
                                                      axis=0)
    np.fmax.at(m_want, (put_rows % 2000, put_j), put_v)
    return {"dc": (s_want, s_terms), "rack": (m_want, np.abs(m_want))}


def fed_held(got, want, terms, what: str) -> float:
    """Max |got - want| over the groups ``want`` holds, by phase 2's
    rule; raises past it or where the group-minutes differ."""
    import numpy as np
    rows = ~np.isnan(want).all(axis=1)
    check(np.array_equal(np.isnan(got[rows]), np.isnan(want[rows]))
          and np.isnan(got[~rows]).all(),
          f"{what}: other group-minutes than the reference")
    err = np.abs(got[rows] - want[rows])
    bad = err > TOL_REL * terms[rows] + TOL_ABS
    check(not bool(np.nan_to_num(bad).any()),
          f"{what}: {int(np.nansum(bad))} cells past the tolerance, max "
          f"|d| {float(np.nanmax(err))!r}")
    return float(np.nanmax(err))


def phase_federated(torch, router, rst, wire_h, shards, sts, data, keep,
                    card: str) -> tuple[dict, dict]:
    """Phase 21 (a) on phase 20's cluster. Returns the kernel launches of
    its batch answers and its readings."""
    import http.client
    import queue as queue_mod

    import numpy as np
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest

    tags, _ts2d, values = data
    out: dict = {"card": card}
    rc = router.cluster
    # the batch answers below must come from the engines, not from the
    # shards' registries (a registered tumbling query serves /api/query)
    for t_shard in shards:
        t_shard.config.override_config("tsd.streaming.serve", "false")

    def call(method: str, path: str, body=None):
        resp = wire_h.handle(HttpRequest(
            method=method, path=path,
            body=json.dumps(body).encode() if body is not None else b""))
        return resp.status, (json.loads(resp.body) if resp.body else None)

    def pull(cid: str):
        t = time.perf_counter()
        status, doc = call("GET", f"{CQ_PATH}/{cid}/result")
        check(status == 200, f"{cid} /result: HTTP {status} {doc}")
        return doc, time.perf_counter() - t

    reg_s = {}
    for cid, agg, key in FED_QUERIES:
        t = time.perf_counter()
        status, doc = call("POST", CQ_PATH, fed_body(cid, agg, key))
        reg_s[cid] = time.perf_counter() - t
        check(status == 200 and doc["federated"] and doc["shards"] ==
              [f"s{i}" for i in range(CLUSTER_SHARDS)],
              f"register {cid}: HTTP {status} {doc}")
    print(f"  (a) registered {[c for c, _a, _k in FED_QUERIES]} on "
          f"{CLUSTER_SHARDS} shards: " + ", ".join(
              f"{c} {s * 1e3:.1f} ms" for c, s in reg_s.items())
          + f" (on {card})")

    # the put: minute j of FED_PUT_POINTS cut series, at 30 s past it
    pick = keep[np.linspace(0, len(keep) - 1, FED_PUT_POINTS).astype(
        np.int64)]
    put_j = np.arange(FED_PUT_POINTS) % POINTS
    put_v = ((np.arange(FED_PUT_POINTS) * 37) % 1000) / 8.0
    pts = [{"metric": METRIC, "timestamp": int(T0 + 60 * j + 30),
            "value": float(v), "tags": tags[int(i)]}
           for i, j, v in zip(pick, put_j, put_v)]
    conn = http.client.HTTPConnection("127.0.0.1", rst.port, timeout=600)
    try:
        t = time.perf_counter()
        for lo in range(0, len(pts), FED_BODY):
            status, body, _ = _http(conn, "POST", "/api/put?summary=true",
                                    json.dumps(pts[lo:lo + FED_BODY])
                                    .encode())
            check(status == 200 and json.loads(body)["failed"] == 0,
                  f"the put: {status} {body[:200]!r}")
        put_s = time.perf_counter() - t
    finally:
        conn.close()
    ref = fed_reference(values, keep, pick, put_j, put_v)

    reset_launches(fused)
    pulls, answers = {}, {}
    for cid, agg, key in FED_QUERIES:
        g = 100 if key == "dc" else 2000
        secs = []
        for _ in range(FED_PULLS):
            doc, sec = pull(cid)
            secs.append(sec)
        got, marker = fed_grid(doc, key, g)
        check(marker is None, f"{cid}: a marker on a whole pull: {marker}")
        want, terms = ref[key]
        err = fed_held(got, want, terms, f"{cid} against float64")
        # the router's batch answer of the same query, from the engines
        body = dict(fed_body(cid, agg, key), msResolution=True)
        body.pop("id")
        t = time.perf_counter()
        status, batch = call("POST", "/api/query", body)
        batch_s = time.perf_counter() - t
        check(status == 200, f"{cid} batch: HTTP {status}")
        bgot, bmarker = fed_grid(batch, key, g)
        check(bmarker is None and not any(
            isinstance(r, dict) and "shardsDegraded" in r for r in batch),
            f"{cid} batch degraded")
        berr = fed_held(bgot, got, terms, f"{cid} against the batch")
        pulls[cid] = p50(secs)
        answers[cid] = got
        out[f"{cid}_pull_ms"] = p50(secs) * 1e3
        out[f"{cid}_batch_ms"] = batch_s * 1e3
        out[f"{cid}_max_abs_err"] = max(err, berr)
        print(f"  (a) {cid} ({agg}:1m-{agg} by {key}): /result p50 "
              f"{p50(secs) * 1e3:.1f} ms of {FED_PULLS} against "
              f"{batch_s * 1e3:.1f} ms for the batch /api/query; "
              f"{int((~np.isnan(got).all(axis=1)).sum())} groups equal to "
              f"float64 numpy within max |d| {err!r} and to the batch "
              f"/api/query within {berr!r} (on {card})")
    launches = read_launches(fused)
    print(f"  (a) {FED_PUT_POINTS} points put through the router in "
          f"{put_s:.3f} s; the batch answers launched {launches}")

    # push: one windows frame after a put, through the stream endpoint;
    # the shards' dirty windows of the put above are drained first, so
    # that the first frame pushed is the late put's
    rc.cqs.pump(rc.cqs.get("fed-dc"))
    resp = wire_h.handle(HttpRequest(method="GET",
                                     path=f"{CQ_PATH}/fed-dc/stream"))
    check(resp.status == 200, f"/stream: HTTP {resp.status}")
    frames: queue_mod.Queue = queue_mod.Queue()
    go = threading.Event()

    def reader() -> None:
        it = iter(resp.body_iter)
        try:
            for chunk in it:
                frames.put(chunk)
                if chunk.startswith(b"event: snapshot") or \
                        b"\nevent: snapshot" in chunk:
                    go.set()
                if b"event: windows" in chunk:
                    return
        finally:
            it.close()

    th = threading.Thread(target=reader, name="chip-smoke-sse")
    th.start()
    check(go.wait(FED_PUSH_S), "no snapshot frame on the stream")
    late = [{"metric": METRIC, "timestamp": T0 + 60 * (POINTS - 1) + 45,
             "value": 1.0, "tags": tags[int(keep[0])]}]
    t = time.perf_counter()
    status, _doc = call("POST", "/api/put", late)
    check(status == 204, f"the late put: HTTP {status}")
    frame = None
    deadline = time.perf_counter() + FED_PUSH_S
    while time.perf_counter() < deadline:
        try:
            chunk = frames.get(timeout=max(deadline - time.perf_counter(),
                                           0.01))
        except queue_mod.Empty:
            break
        if b"event: windows" in chunk:
            frame = chunk
            break
    push_s = time.perf_counter() - t
    th.join(FED_PUSH_S)
    check(frame is not None and not th.is_alive(),
          "no windows frame was pushed after the put")
    doc = json.loads(frame.decode().split("data: ", 1)[1])
    edge = str((T0 + 60 * (POINTS - 1)) * 1000)
    check(any(edge in u["dps"] for u in doc["updates"]),
          "the pushed frame does not hold the put's minute")
    out["push_ms"] = push_s * 1e3
    print(f"  (a) a put to the router reached the /stream as a windows "
          f"frame in {push_s * 1e3:.1f} ms (the stream pumps every "
          f"{rc.cqs.heartbeat_s} s when idle) (on {card})")

    # s1 down, then back
    whole, _ = pull("fed-dc")
    s1_port = sts[1].port
    _listener(sts[1], up=False)
    # the shard's wire session ends once its watchdog (50 ms) sees the
    # listener gone
    time.sleep(0.2)
    try:
        doc, _ = pull("fed-dc")
        got, marker = fed_grid(doc, "dc", 100)
        check(marker is not None and marker.get("shardsDegraded") ==
              ["s1"] and marker.get("complete") is False,
              f"outage pull: marker {marker}")
    finally:
        _listener(sts[1], up=True, port=s1_port)
    doc, _ = pull("fed-dc")
    check(doc == whole, "the pull after s1 came back differs from the "
          "pull before it went")
    print("  (a) s1 down: the pull answers 200 with shardsDegraded "
          "['s1'] and complete false; s1 back: the pull is whole again "
          "and equal to the one before")

    for cid, _agg, _key in FED_QUERIES:
        status, _ = call("DELETE", f"{CQ_PATH}/{cid}")
        check(status == 204, f"delete {cid}: HTTP {status}")
    left = [[q.id for q in t_shard.streaming.list()] for t_shard in shards]
    check(left == [[]] * CLUSTER_SHARDS, f"registries after delete: {left}")
    for t_shard in shards:
        t_shard.config.override_config("tsd.streaming.serve", "true")
    out.update(register_ms={c: s * 1e3 for c, s in reg_s.items()},
               put_s=put_s)
    print("  (a) deleted: every shard's registry is empty")
    return launches, out


# phase 21 (b)-(d): replication on three new shards
RF = 2
RF_REPEATS = 2             # (b): timed calls per p50, after a warm-up
RF_OUTAGE_POINTS = 10_000  # (d): points put while s1 is down
RF_OUTAGE_METRIC = "sys.rf.outage"
# (c): how long an opened breaker keeps s1 out of the read plan; (d)
# waits it out before the drain
RF_BREAKER_RESET_MS = 3000
RF_TRIP_CALLS = 10         # (c): most calls that may go into opening it


def router_groups(rows, key: str):
    """{group index: [values]} of parsed router rows grouped by ``key``."""
    prefix = "dc" if key == "dc" else "r"
    return {int(r["tags"][key][len(prefix):]): list(r["dps"].values())
            for r in rows}


def held_rows(torch, got_rows, want_rows, key: str, terms, what: str
              ) -> float:
    """Max |got - want| of two router answers over the same groups, by
    phase 2's rule with phase 3's terms."""
    got, want = router_groups(got_rows, key), router_groups(want_rows, key)
    check(sorted(got) == sorted(want),
          f"{what}: {len(got)} groups against {len(want)}")
    idx = sorted(got)
    return compare(torch.tensor([got[i] for i in idx], dtype=torch.float64),
                   torch.tensor([want[i] for i in idx],
                                dtype=torch.float64), terms[idx])


def phase_replicated(torch, data, keep, ref3: dict, rf1_rows: dict,
                     card: str) -> tuple[dict, dict]:
    """Phase 21 (b)-(d): a router at ``tsd.cluster.rf=2`` over three new
    shard TSDs. Returns every kernel launch of (b) and (c), warm-ups
    included, and the ``replication`` line."""
    import http.client

    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.cluster import replica as replica_mod
    from opentsdb_tpu_torch.cluster.hashring import series_shard_key
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.query.model import TSQuery
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest
    from opentsdb_tpu_torch.tsd.server import ServerThread

    t_phase = time.perf_counter()
    out: dict = {"card": card, "rf": RF}
    marks = [t_phase]
    stage_s: dict = {}

    def mark(name: str) -> None:
        marks.append(time.perf_counter())
        stage_s[name] = marks[-1] - marks[-2]

    shard_keys = {"tsd.torch.device": "cuda",
                  "tsd.core.auto_create_metrics": "true",
                  "tsd.cluster.role": "shard", **ENGINE_KEYS}
    shards = [TSDB(Config(**shard_keys)) for _ in range(CLUSTER_SHARDS)]
    sts = [serve_pinned(ServerThread, t) for t in shards]
    spec = ",".join(f"s{i}=127.0.0.1:{st.port}" for i, st in enumerate(sts))
    # an in-memory spool (a write it takes for a dead shard marks the
    # shard dirty) and no background replay: (d) drains and repairs by
    # hand
    router = TSDB(Config(**{
        "tsd.torch.device": "cuda", "tsd.cluster.role": "router",
        "tsd.cluster.peers": spec, "tsd.cluster.rf": str(RF),
        "tsd.cluster.spool.replay_interval_ms": "3600000",
        "tsd.cluster.breaker.reset_timeout_ms": str(RF_BREAKER_RESET_MS),
        "tsd.query.cache.enable": "false"}))
    rst = serve_pinned(ServerThread, router)
    wire_h = rst.server.http_router
    rc = router.cluster
    start, end = str(T0), str(T0 + POINTS * 60 - 1)
    launches = {"span_reduce": 0, "onehot_reduce": 0}

    def take() -> dict:
        """The launches since the last take (counted into the phase's),
        the counts set to 0 again."""
        got = read_launches(fused)
        for k in launches:
            launches[k] += got[k]
        reset_launches(fused)
        return got

    mark("start")
    try:
        # the data: each cut series on both of its owners
        tags, ts2d, values = data
        t = time.perf_counter()
        keys = [series_shard_key(METRIC, tags[i]) for i in keep.tolist()]
        owners = rc.ring.shards_for_keys(keys, RF)
        place_s = time.perf_counter() - t
        by_shard = {f"s{i}": [] for i in range(CLUSTER_SHARDS)}
        for i, own in zip(keep.tolist(), owners):
            for name in own:
                by_shard[name].append(i)
        t = time.perf_counter()
        for i, t_shard in enumerate(shards):
            rows = np.asarray(by_shard[f"s{i}"], dtype=np.int64)
            t_shard.add_series_points(METRIC, [tags[j] for j in rows],
                                      ts2d[rows], values[rows])
        load_s = time.perf_counter() - t
        counts = {f"s{i}": int(t_shard.store.num_series())
                  for i, t_shard in enumerate(shards)}
        check(counts == {n: len(v) for n, v in by_shard.items()}
              and sum(counts.values()) == RF * len(keep),
              f"series per shard {counts}")
        out.update(series=int(len(keep)), series_rows=sum(counts.values()),
                   per_shard=counts)
        print(f"  (b) {len(keep)} series on {RF} owners each: "
              f"{sum(counts.values())} series rows {counts}; ring "
              f"placement {place_s:.3f} s, shard loads {load_s:.3f} s "
              f"(on {card})")
        mark("load")

        # (b) reads: a warm-up call of each query (the mask cold), then
        # RF_REPEATS timed calls
        mask = replica_mod.store_series_mask
        mask.calls, mask.hashed, mask.seconds = 0, 0, 0.0
        reset_launches(fused)
        first_ms = []
        for m, _kname in QUERIES:
            t = time.perf_counter()
            status, _rows, deg, _ = _cluster_rows(wire_h, HttpRequest, m,
                                                  start, end)
            first_ms.append((time.perf_counter() - t) * 1e3)
            check(status == 200 and not deg, f"{m}: {status} {deg}")
        cold = (mask.calls, mask.hashed, mask.seconds)
        mask.calls, mask.hashed, mask.seconds = 0, 0, 0.0
        take()
        calls = {kname: 0 for _m, kname in QUERIES}
        up_rows: dict = {}
        reads: dict = {}
        for m, kname in QUERIES:
            key = "dc" if "{dc=*}" in m else "rack"
            _want, terms = ref3[m]
            secs, answers = [], []
            for _ in range(RF_REPEATS):
                t = time.perf_counter()
                status, rows, deg, _ = _cluster_rows(wire_h, HttpRequest,
                                                     m, start, end)
                secs.append(time.perf_counter() - t)
                calls[kname] += 1
                check(status == 200 and not deg, f"{m}: {status} {deg}")
                answers.append(rows)
            check(answers[0] == answers[1],
                  f"{m}: two calls at rf={RF} differ in their bits")
            g = len(rows)
            check(g == (CLUSTER_DCS if key == "dc" else 20 * CLUSTER_DCS),
                  f"{m}: {g} merged groups")
            err = _held_groups(torch, rows, key, _want, terms,
                               f"{m} at rf={RF}")
            err1 = held_rows(torch, rows, rf1_rows[m], key, terms,
                             f"{m} at rf={RF} against rf=1")
            up_rows[m] = rows
            reads[f"{key}_ms"] = p50(secs) * 1e3
            reads[f"{key}_max_abs_err"] = max(err, err1)
            print(f"  (b) {m} at rf={RF}: p50 {p50(secs) * 1e3:.1f} ms of "
                  f"{RF_REPEATS} after a warm-up, {g} groups held to phase "
                  f"3's answer (max |d| {err!r}) and to phase 20's rf=1 "
                  f"answer (max |d| {err1!r}), two calls bit-equal "
                  f"(on {card})")
        got = take()
        for kname, n in calls.items():
            check(got[kname] == n * CLUSTER_SHARDS,
                  f"{kname}: {got[kname]} launches, want one per reading "
                  f"shard per call ({n * CLUSTER_SHARDS})")
        warm = (mask.calls, mask.hashed, mask.seconds)
        out["mask"] = {"cold_calls": cold[0], "cold_hashed": cold[1],
                       "cold_s": cold[2], "first_calls_ms": first_ms,
                       "warm_calls": warm[0],
                       "warm_hashed": warm[1],
                       "warm_ms_per_call": warm[2] / max(warm[0], 1) * 1e3}
        print(f"  (b) launches {got} over {calls} router calls x "
              f"{CLUSTER_SHARDS} reading shards; the replica mask: cold "
              f"{cold[0]} shard calls hashed {cold[1]} series in "
              f"{cold[2]:.3f} s (summed over the shards; the router's "
              f"warm-up calls {first_ms[0]:.1f} and {first_ms[1]:.1f} ms), "
              f"warm {warm[0]} "
              f"shard calls hashed {warm[1]}, "
              f"{out['mask']['warm_ms_per_call']:.2f} ms a call (on {card})")
        mark("b")

        # (c) s1 down: its sets are read by their other owner
        s1_port = sts[1].port
        peer1 = rc.peers["s1"]
        fb0 = rc.read_fallbacks
        _listener(sts[1], up=False)
        time.sleep(0.2)   # the wire session's watchdog (50 ms)
        for m, kname in QUERIES:
            key = "dc" if "{dc=*}" in m else "rack"
            _want, terms = ref3[m]
            # calls while s1's breaker is closed assign it its sets and
            # re-read them from a sibling (a fallback round): open it
            for _ in range(RF_TRIP_CALLS):
                if peer1.breaker.blocking():
                    break
                status, rows, deg, _ = _cluster_rows(wire_h, HttpRequest,
                                                     m, start, end)
                check(status == 200 and not deg,
                      f"{m} with s1 down: {status} {deg}")
            check(peer1.breaker.blocking(), "s1's breaker did not open")
            take()
            t = time.perf_counter()
            status, rows, deg, _ = _cluster_rows(wire_h, HttpRequest, m,
                                                 start, end)
            sec = time.perf_counter() - t
            got = take()
            check(status == 200 and not deg,
                  f"{m} with s1 down: {status} {deg}")
            check(got[kname] == CLUSTER_SHARDS - 1,
                  f"{m} with s1 down launched {got}, want "
                  f"{CLUSTER_SHARDS - 1} {kname}")
            err = held_rows(torch, rows, up_rows[m], key, terms,
                            f"{m} with s1 down")
            reads[f"{key}_s1_down_ms"] = sec * 1e3
            print(f"  (c) s1 down: {m} 200 with no shardsDegraded in "
                  f"{sec * 1e3:.1f} ms, {got[kname]} {kname} launches, "
                  f"held to the all-up answer (max |d| {err!r}) "
                  f"(on {card})")
        fallbacks = rc.read_fallbacks - fb0
        check(fallbacks > 0, "no read fell back from s1")
        out["reads"] = reads
        out["read_fallbacks"] = fallbacks
        print(f"  (c) read_fallbacks rose by {fallbacks}; the phase's "
              f"launches so far, warm-ups and the calls that opened s1's "
              f"breaker included: {launches}")
        mark("c")

        # (d) writes while s1 is down, in two bodies; s1's in-memory
        # spool loses the first (as a router restart would lose it all),
        # the drain replays the second, and the repair copies the rest
        # from the surviving replicas
        pts = [{"metric": RF_OUTAGE_METRIC, "timestamp": T0 + j,
                "value": j, "tags": {"host": f"o{j % 1000}"}}
               for j in range(RF_OUTAGE_POINTS)]
        half = RF_OUTAGE_POINTS // 2
        put_s = 0.0
        conn = http.client.HTTPConnection("127.0.0.1", rst.port,
                                          timeout=600)
        try:
            for body_pts in (pts[:half], pts[half:]):
                status, body, secs = _http(conn, "POST",
                                           "/api/put?summary=true",
                                           json.dumps(body_pts).encode())
                put_s += secs
                check(status == 200 and json.loads(body)["failed"] == 0,
                      f"outage put: {status} {body[:200]!r}")
        finally:
            conn.close()
        spooled = peer1.spool.pending_records
        dirty = rc.dirty.peek("s1")
        check(spooled >= 2 and RF_OUTAGE_METRIC in dirty,
              f"s1: {spooled} spooled records, dirty {dirty}")
        check(not peer1.spool.durable, "s1's spool is on disk")
        lost = peer1.spool._queue.popleft()
        peer1.spool._mem_bytes -= len(lost)
        lost_pts = len(json.loads(lost))
        ring = rc.ring
        sets = ring.replica_sets(RF)

        def owner_points(name: str, t_shard) -> tuple[dict, dict]:
            """(what ``name`` reads of the outage metric through a
            replicaSel assigning it every set it is in, what those sets
            hold)."""
            sel = replica_mod.sel_doc(ring.names, ring.vnodes, RF,
                                      [st_ for st_ in sets if name in st_])
            tq = TSQuery.from_json({
                "start": str(T0 - 1), "end": str(T0 + RF_OUTAGE_POINTS),
                "replicaSel": sel, "queries": [
                    {"metric": RF_OUTAGE_METRIC,
                     "aggregator": "none"}]}).validate()
            got_pts = {}
            for r in t_shard.execute_query(tq):
                ts_arr, vals = r.dps_arrays
                for ts, v in zip(ts_arr.tolist(), vals.tolist()):
                    got_pts[(r.tags["host"], ts // 1000)] = v
            want_pts = {(dp["tags"]["host"], dp["timestamp"]):
                        float(dp["value"]) for dp in pts
                        if name in ring.shards_for(
                            dp["metric"], dp["tags"], RF)}
            return got_pts, want_pts

        _listener(sts[1], up=True, port=s1_port)
        t = time.perf_counter()
        while peer1.breaker.blocking() and \
                time.perf_counter() - t < RF_BREAKER_RESET_MS / 1e3 + 10:
            time.sleep(0.02)
        wait_s = time.perf_counter() - t
        t = time.perf_counter()
        rc.drain_spool(peer1)
        drain_s = time.perf_counter() - t
        check(peer1.spool.pending_records == 0, "s1's spool did not drain")
        got1, want1 = owner_points("s1", shards[1])
        check(set(got1) < set(want1)
              and len(want1) - len(got1) == lost_pts,
              f"s1 reads {len(got1)} of its {len(want1)} outage points "
              f"after the drain, {lost_pts} of them lost with the spool")
        rp0 = rc.repair_points
        t = time.perf_counter()
        repaired = rc.repair_peer(peer1)
        repair_s = time.perf_counter() - t
        copied = rc.repair_points - rp0
        check(repaired and not rc.dirty.peek("s1") and copied >= lost_pts,
              f"repair: {repaired}, dirty {rc.dirty.peek('s1')}, "
              f"{copied} points copied, {lost_pts} lost")
        seen: dict = {}
        for i, t_shard in enumerate(shards):
            name = f"s{i}"
            got_pts, want_pts = owner_points(name, t_shard)
            check(got_pts == want_pts,
                  f"{name} reads {len(got_pts)} outage points through its "
                  f"selector, its sets hold {len(want_pts)}")
            for k in got_pts:
                seen[k] = seen.get(k, 0) + 1
        check(len(seen) == RF_OUTAGE_POINTS
              and set(seen.values()) == {RF},
              "not every outage point reads back from both owners")
        out["outage"] = {"points": RF_OUTAGE_POINTS, "put_s": put_s,
                         "spooled_records": spooled,
                         "breaker_wait_s": wait_s, "drain_s": drain_s,
                         "repair_s": repair_s, "repair_points": copied,
                         "lost_points": lost_pts}
        print(f"  (d) s1 down: {RF_OUTAGE_POINTS} points acknowledged in "
              f"two bodies, {put_s:.3f} s, into {spooled} spool records, "
              f"s1 dirty for {sorted(dirty)}; the first record lost "
              f"({lost_pts} of s1's {len(want1)} points); s1 back: the "
              f"breaker half-opened in {wait_s:.3f} s, the spool drained "
              f"in {drain_s:.3f} s ({len(got1)} points on s1), "
              f"repair_peer copied {copied} points in {repair_s:.3f} s; "
              f"every point read back from each of its {RF} owners "
              f"through a replicaSel assigning that owner (on {card})")
        mark("d")
    finally:
        rst.stop()
        for st in sts:
            st.stop()
    mark("stop")
    out["stage_s"] = stage_s
    print("  seconds by stage: " + ", ".join(
        f"{k} {v:.1f}" for k, v in stage_s.items()))
    return launches, out


# phase 22: online resharding and stale-copy retirement
# config 3's series i < RESHARD_SERIES with i % 100 < CLUSTER_DCS
# (17,680): 17 series a rack, the fewest whole series a rack at which
# every shard keeps more than 1024 racks before the grow (3 shards:
# 1036-1039 racks) and after it (4 shards: 1027-1034), so {rack=*}
# runs K2 on each; at 16 a rack (32,000) one shard of 4 keeps 1023 and
# would run K1. CUT from 1,000,000 (the ring's placement, computed in
# the phase, is what decides it)
RESHARD_SERIES = 34_000
RESHARD_WINDOW_SERIES = 170   # (b): the next 170 cut series x 60 points
RESHARD_BODY = 1_020          # (b): points per /api/put body (17 series)
RESHARD_REPEATS = 2           # timed calls per p50, after a warm-up
RESHARD_RETIRE_MS = "50"      # (e): tsd.cluster.retire.interval_ms
RESHARD_WAIT_S = 120          # the longest wait for a background loop


def reshard_reference(values, idx) -> dict:
    """``{m: (want, terms)}`` of both QUERIES over config 3's series
    ``idx`` in float64 with numpy (as :func:`config3_reference`), row n
    the group whose tag value ends in n."""
    import numpy as np
    import torch
    vals = values[idx]
    avg = vals.reshape(len(idx), POINTS // 5, 5).mean(axis=2)
    per = (np.diff(avg, axis=1) / 300.0,
           (np.abs(avg[:, 1:]) + np.abs(avg[:, :-1])) / 300.0)
    out = {}
    for m, _ in QUERIES:
        mod = 100 if "{dc=*}" in m else 2000
        gid = idx % mod
        out[m] = tuple(torch.from_numpy(np.stack(
            [np.bincount(gid, x[:, j], minlength=mod)
             for j in range(x.shape[1])], axis=1)) for x in per)
    return out


def router_reads(torch, h, label: str, ref: dict, n_shards: int, take,
                 card: str, before=None) -> tuple:
    """A warm-up and RESHARD_REPEATS timed calls of both QUERIES over the
    data's hour through the router handler ``h`` (``before()`` ahead of
    each call, where given): the p50s, each answer held to ``ref``
    (:func:`reshard_reference`), one launch per reading shard per call
    (``take()`` returns the launches since its last call)."""
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest
    start, end = str(T0), str(T0 + POINTS * 60 - 1)
    take()
    got_ms, rows_of, calls = {}, {}, {k: 0 for _m, k in QUERIES}
    for m, kname in QUERIES:
        key = "dc" if "{dc=*}" in m else "rack"
        want, terms = ref[m]
        secs = []
        for _ in range(RESHARD_REPEATS + 1):
            if before is not None:
                before()
            t = time.perf_counter()
            status, rows, deg, _ = _cluster_rows(h, HttpRequest, m,
                                                 start, end)
            secs.append(time.perf_counter() - t)
            calls[kname] += 1
            check(status == 200 and not deg,
                  f"{m} {label}: {status}, degraded {deg}")
        g = len(rows)
        check(g == (CLUSTER_DCS if key == "dc" else 20 * CLUSTER_DCS),
              f"{m} {label}: {g} merged groups")
        err = _held_groups(torch, rows, key, want, terms, f"{m} {label}")
        got_ms[f"{key}_ms"] = p50(secs[1:]) * 1e3
        got_ms[f"{key}_max_abs_err"] = err
        rows_of[m] = rows
        print(f"  {m} {label}: p50 {p50(secs[1:]) * 1e3:.1f} ms of "
              f"{RESHARD_REPEATS} after a warm-up, {g} groups held "
              f"to numpy (max |d| {err!r}) (on {card})")
    got = take()
    for kname, n in calls.items():
        check(got[kname] == n * n_shards,
              f"{kname} {label}: {got[kname]} launches, want one per "
              f"reading shard per call ({n * n_shards})")
    print(f"  launches {label}: {got} over {calls} router calls x "
          f"{n_shards} reading shards")
    return got_ms, rows_of


def shard_routes(shards, ring, sel: bool, take) -> dict:
    """Each shard's kernel for each query: the launch of one direct
    call on the shard (``shards[i]`` is ``s<i>``), through a replicaSel
    assigning it its sets on ``ring`` when ``sel``."""
    from opentsdb_tpu_torch.cluster import replica as replica_mod
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    start, end = str(T0), str(T0 + POINTS * 60 - 1)
    got_routes = {}
    for name in ring.names:
        t_shard = shards[int(name[1:])]
        per = {}
        for m, kname in QUERIES:
            doc = TSQuery(start=start, end=end,
                          queries=[parse_uri_subquery(m)]).to_json()
            if sel:
                doc["replicaSel"] = replica_mod.sel_doc(
                    ring.names, ring.vnodes, 1,
                    [t_ for t_ in ring.replica_sets(1) if name in t_])
            take()
            t_shard.execute_query(TSQuery.from_json(doc).validate())
            got = take()
            ran = [k for k, n in got.items() if n]
            check(sum(got.values()) == 1 and ran == [kname],
                  f"{name} ran {got} for {m}, want one {kname}")
            per["dc" if "{dc=*}" in m else "rack"] = "+".join(ran) or "none"
        got_routes[name] = per
    return got_routes


def phase_reshard(torch, data, card: str) -> tuple[dict, dict]:
    """Phase 22: a router over three shard TSDs grows the ring to four
    online (``POST /api/cluster/reshard``), is killed mid-cutover,
    resumes, finalizes and retires the stale copies. Returns every
    kernel launch of its reads, warm-ups and route probes included, and
    the ``reshard`` line."""
    import tempfile

    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.cluster.hashring import HashRing, series_shard_key
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
    from opentsdb_tpu_torch.tsd.server import ServerThread

    t_phase = time.perf_counter()
    out: dict = {"card": card, "series_cut": RESHARD_SERIES}
    marks = [t_phase]
    stage_s: dict = {}

    def mark(name: str) -> None:
        marks.append(time.perf_counter())
        stage_s[name] = marks[-1] - marks[-2]

    tags, ts2d, values = data
    keep = np.asarray([i for i in range(RESHARD_SERIES)
                       if i % 100 < CLUSTER_DCS], dtype=np.int64)
    win = np.asarray([i for i in range(RESHARD_SERIES, len(tags))
                      if i % 100 < CLUSTER_DCS][:RESHARD_WINDOW_SERIES],
                     dtype=np.int64)
    every = np.concatenate([keep, win])
    ref_a = reshard_reference(values, keep)
    ref_b = reshard_reference(values, every)
    shard_keys = {"tsd.torch.device": "cuda",
                  "tsd.core.auto_create_metrics": "true",
                  "tsd.cluster.role": "shard",
                  # the retire pass deletes through the shards' gate
                  "tsd.http.query.allow_delete": "true", **ENGINE_KEYS}
    shards = [TSDB(Config(**shard_keys))
              for _ in range(CLUSTER_SHARDS + 1)]
    sts = [serve_pinned(ServerThread, t) for t in shards]
    addrs = [f"s{i}=127.0.0.1:{st.port}" for i, st in enumerate(sts)]
    spool = Path(tempfile.mkdtemp(prefix="chip_smoke_reshard_"))
    router_keys = {"tsd.torch.device": "cuda",
                   "tsd.cluster.role": "router",
                   "tsd.cluster.peers": ",".join(addrs[:CLUSTER_SHARDS]),
                   "tsd.cluster.spool.dir": str(spool),
                   "tsd.query.cache.enable": "false"}
    start, end = str(T0), str(T0 + POINTS * 60 - 1)
    launches = {"span_reduce": 0, "onehot_reduce": 0}

    def take() -> dict:
        """The launches since the last take (counted into the phase's),
        the counts set to 0 again."""
        got = read_launches(fused)
        for k in launches:
            launches[k] += got[k]
        reset_launches(fused)
        return got

    def router_for(**keys):
        """A router TSDB over the spool dir, not yet started."""
        t = TSDB(Config(**{**router_keys, **keys}))
        return t, t.cluster, HttpRpcRouter(t)

    def held_series(t_shard) -> int:
        """Series of the metric with points in the hour on one shard."""
        return len(t_shard.execute_query(TSQuery(
            start=start, end=end,
            queries=[parse_uri_subquery(f"none:{METRIC}")]).validate()))

    def wait_for(cond, what: str) -> float:
        t = time.perf_counter()
        while not cond():
            check(time.perf_counter() - t < RESHARD_WAIT_S,
                  f"{what} did not happen in {RESHARD_WAIT_S} s")
            time.sleep(0.01)
        return time.perf_counter() - t

    router = None
    mark("start")
    try:
        # (a) the cut on three shards, placed by the router's ring; the
        # reads at epoch 0. The first router steps its backfill by hand
        router, rc, h = router_for(**{
            "tsd.cluster.reshard.interval_ms": "3600000"})
        rc.start()
        names = [f"s{i}" for i in range(CLUSTER_SHARDS + 1)]
        keys = [series_shard_key(METRIC, tags[i]) for i in every.tolist()]
        old_own = np.asarray([t_[0] for t_ in rc.ring.shards_for_keys(keys)])
        new_own = np.asarray([t_[0] for t_ in HashRing(
            names, vnodes=rc.ring.vnodes).shards_for_keys(keys)])
        is_keep = np.arange(len(every)) < len(keep)
        t = time.perf_counter()
        for i, t_shard in enumerate(shards[:CLUSTER_SHARDS]):
            rows = every[is_keep & (old_own == f"s{i}")]
            t_shard.add_series_points(METRIC, [tags[j] for j in rows],
                                      ts2d[rows], values[rows])
        load_s = time.perf_counter() - t
        counts = {n: held_series(shards[i])
                  for i, n in enumerate(names[:CLUSTER_SHARDS])}
        check(counts == {n: int((is_keep & (old_own == n)).sum())
                         for n in counts}, f"series per shard {counts}")
        print(f"  (a) {len(keep)} series (i < {RESHARD_SERIES}, dc0-dc"
              f"{CLUSTER_DCS - 1}) x {POINTS} points on {CLUSTER_SHARDS} "
              f"shards: {counts}, loaded in {load_s:.3f} s (on {card})")
        r0 = shard_routes(shards, rc.ring, False, take)
        print(f"  (a) routes at epoch 0: {r0}")
        for n, per in r0.items():
            check(per == {"dc": "span_reduce", "rack": "onehot_reduce"},
                  f"{n} at epoch 0 routes {per}")
        reads_a, _ = router_reads(torch, h, "at epoch 0", ref_a,
                                  CLUSTER_SHARDS, take, card)
        out.update(series=int(len(keep)), per_shard=counts, routes0=r0)
        mark("a")

        # (b) the install, and writes and reads in the window
        resp = h.handle(HttpRequest(
            method="POST", path="/api/cluster/reshard",
            body=json.dumps({"peers": ",".join(addrs)}).encode()))
        doc = json.loads(resp.body)
        check(resp.status == 200 and doc["epoch"] == 1 and doc["active"],
              f"reshard install: {resp.status} {resp.body[:300]!r}")
        pts = [{"metric": METRIC, "timestamp": int(ts2d[i, j]),
                "value": float(values[i, j]), "tags": tags[i]}
               for i in win.tolist() for j in range(POINTS)]
        t = time.perf_counter()
        for k in range(0, len(pts), RESHARD_BODY):
            resp = h.handle(HttpRequest(
                method="POST", path="/api/put",
                params={"summary": ["true"]},
                body=json.dumps(pts[k:k + RESHARD_BODY]).encode()))
            check(resp.status == 200
                  and json.loads(resp.body)["failed"] == 0,
                  f"window put: {resp.status} {resp.body[:300]!r}")
        put_s = time.perf_counter() - t
        print(f"  (b) installed at epoch {doc['epoch']} (s3 joins); "
              f"{len(pts)} points of {len(win)} more cut series put "
              f"through the router in the window in {put_s:.3f} s "
              f"({len(pts) / put_s:,.0f} points/s), written to the old "
              f"and the new owners (on {card})")
        reads_b, _ = router_reads(torch, h, "in the window (the old ring)",
                                  ref_b, CLUSTER_SHARDS, take, card)
        before = {n: held_series(shards[i]) for i, n in enumerate(names)}
        want_before = {n: int((old_own == n).sum()) for n in names}
        want_before["s3"] = int(((new_own == "s3") & ~is_keep).sum())
        check(before == want_before,
              f"series per shard in the window {before}, want "
              f"{want_before}")
        mark("b")

        # (c) one unit copied by hand, the router killed and rebuilt
        # over the same spool dir, the rest copied by its loop at the
        # default 250 ms interval
        step = rc.backfill_step()
        check(step.get("phase") == "copied", f"first unit: {step}")
        first_points = rc.backfiller.backfilled_points

        def state(r) -> tuple:
            return (r.epoch, list(r.ring.names), list(r.old_ring.names),
                    r.state.done, r.state.fence_ms)

        left = state(rc)
        router.shutdown()
        router, rc, h = router_for(**{"tsd.cluster.retire.enable":
                                      "false"})
        back = state(rc)
        check(back == left and rc.resharding,
              f"the rebuilt router resumed {back}, the killed one left "
              f"{left}")
        print(f"  (c) {step['series']} series of {step['peer']} copied by "
              f"hand; the router killed and rebuilt: epoch {back[0]}, "
              f"ring {back[1]}, old ring {back[2]}, done {back[3]} back")
        rc.start()
        backfill_s = wait_for(lambda: not rc.resharding,
                              "the backfill's finalize")
        moved = int((old_own != new_own).sum())
        bf_series = step["series"] + rc.backfiller.backfilled_series
        bf_points = first_points + rc.backfiller.backfilled_points
        check(bf_series == moved and bf_points == moved * POINTS,
              f"backfilled {bf_series} series, {bf_points} points; "
              f"{moved} series moved")
        print(f"  (c) the loop finished the copy and finalized in "
              f"{backfill_s:.3f} s: {bf_series} series, {bf_points} points "
              f"moved in all ({bf_points / backfill_s:,.0f} points/s "
              f"after the resume) (on {card})")
        out["backfill"] = {"s": backfill_s, "series": bf_series,
                           "points": bf_points, "window_put_s": put_s}
        mark("c")

        # (d) the reads at epoch 1, through the selector on 4 shards
        reads_d, rows_d = router_reads(torch, h, "at epoch 1", ref_b,
                                       CLUSTER_SHARDS + 1, take, card)
        r1 = shard_routes(shards, rc.ring, True, take)
        print(f"  (d) routes at epoch 1: {r1}")
        for n, per in r1.items():
            check(per == {"dc": "span_reduce", "rack": "onehot_reduce"},
                  f"{n} at epoch 1 routes {per}")
        s3_share = int((new_own == "s3").sum()) / len(every)
        check(0.2 <= s3_share <= 0.3, f"s3 owns {s3_share:.3f}")
        out["routes1"] = r1
        mark("d")

        # (e) the retire pass: a router restarted across the un-retired
        # epoch resumes it
        router.shutdown()
        router, rc, h = router_for(**{"tsd.cluster.retire.interval_ms":
                                      RESHARD_RETIRE_MS})
        check(rc.retirer.pending(), "no retire pass pending")
        rc.start()
        retire_s = wait_for(lambda: rc.state.retired_epoch == 1,
                            "the retire pass")
        after = {n: held_series(shards[i]) for i, n in enumerate(names)}
        lost = {n: int(((old_own == n) & (new_own != n)).sum())
                for n in names}
        want_after = {n: int((new_own == n).sum()) for n in names}
        check(after == want_after and all(
                  after[n] == before[n] - lost[n]
                  for n in names[:CLUSTER_SHARDS]),
              f"series per shard after the retire pass {after}, before "
              f"{before}, lost {lost}")
        check(rc.retirer.retired_series == sum(lost.values()),
              f"retired {rc.retirer.retired_series}, lost {lost}")
        print(f"  (e) the retire pass at {RESHARD_RETIRE_MS} ms: "
              f"{retire_s:.3f} s, {rc.retirer.retire_queries} deletes; "
              f"series per shard {before} -> {after} (each former "
              f"owner less what it lost, {lost}) (on {card})")
        reads_e, rows_e = router_reads(torch, h, "after the retire pass",
                                       ref_b, CLUSTER_SHARDS + 1, take,
                                       card)
        for m, _k in QUERIES:
            key = "dc" if "{dc=*}" in m else "rack"
            held_rows(torch, rows_e[m], rows_d[m], key, ref_b[m][1],
                      f"{m} after the retire pass against (d)")
        same = all(rows_e[m] == rows_d[m] for m, _k in QUERIES)
        print(f"  (e) both answers equal (d)'s (bit-equal: {same})")
        out["retire"] = {"s": retire_s, "lost": lost, "before": before,
                         "after": after,
                         "queries": rc.retirer.retire_queries}
        out["reads"] = {"epoch0": reads_a, "window": reads_b,
                        "epoch1": reads_d, "retired": reads_e}
        mark("e")
    finally:
        if router is not None:
            router.shutdown()
        for st in sts:
            st.stop()
        shutil.rmtree(spool, ignore_errors=True)
    mark("stop")
    out["stage_s"] = stage_s
    out["phase_s"] = time.perf_counter() - t_phase
    print("  seconds by stage: " + ", ".join(
        f"{k} {v:.1f}" for k, v in stage_s.items()))
    print(f"phase 22: {out['phase_s']:.1f} s")
    return launches, out


# phase 23: sibling routers, the gossip bus
# the data is phase 22's cut (RESHARD_SERIES: 17,680 series, the fewest
# at which every shard keeps K1 for {dc=*} and K2 for {rack=*} on 3
# shards and on 4), on three new shard TSDs and a spare; each stage
# writes the next RESHARD_WINDOW_SERIES cut series through a router
GOSSIP_STALE_MS = 500          # (b): r1's stale window in the partition
GOSSIP_HAND_MS = "3600000"     # push loops stopped: every push by hand
GOSSIP_PORTS = (20000, 32768)  # routers' ports, below the ephemeral range


def reserve_port(taken: set) -> int:
    """A port the routers can name before either binds it: below
    Linux's ephemeral range, where the other router's outgoing
    connections cannot take it meanwhile."""
    import random
    import socket
    rng = random.Random(os.getpid() ^ time.time_ns())
    while True:
        port = rng.randrange(*GOSSIP_PORTS)
        if port in taken:
            continue
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
        taken.add(port)
        return port


def phase_gossip(torch, data, card: str) -> tuple[dict, dict]:
    """Phase 23: two sibling routers, each on its own socket and naming
    the other in ``tsd.cluster.routers``, over three shard TSDs and a
    spare: cache coherence over one push, a partition that degrades a
    router to cache-bypassed reads, and a sibling that finishes the
    reshard a dead router began. Returns every kernel launch of its
    reads and route probes, and the ``gossip`` line."""
    import tempfile

    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.cluster.hashring import HashRing, series_shard_key
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.tsd.http_api import HttpRequest, HttpRpcRouter
    from opentsdb_tpu_torch.tsd.server import ServerThread

    t_phase = time.perf_counter()
    out: dict = {"card": card, "series_cut": RESHARD_SERIES}
    marks = [t_phase]
    stage_s: dict = {}

    def mark(name: str) -> None:
        marks.append(time.perf_counter())
        stage_s[name] = marks[-1] - marks[-2]

    tags, ts2d, values = data
    keep = np.asarray([i for i in range(RESHARD_SERIES)
                       if i % 100 < CLUSTER_DCS], dtype=np.int64)
    pool = [i for i in range(RESHARD_SERIES, len(tags))
            if i % 100 < CLUSTER_DCS]
    w = RESHARD_WINDOW_SERIES
    wins = [np.asarray(pool[k * w:(k + 1) * w], dtype=np.int64)
            for k in range(3)]
    shard_keys = {"tsd.torch.device": "cuda",
                  "tsd.core.auto_create_metrics": "true",
                  "tsd.cluster.role": "shard",
                  "tsd.http.query.allow_delete": "true", **ENGINE_KEYS}
    shards = [TSDB(Config(**shard_keys))
              for _ in range(CLUSTER_SHARDS + 1)]
    sts = [serve_pinned(ServerThread, t) for t in shards]
    addrs = [f"s{i}=127.0.0.1:{st.port}" for i, st in enumerate(sts)]
    spools = [Path(tempfile.mkdtemp(prefix=f"chip_smoke_gossip_r{i}_"))
              for i in (0, 1)]
    taken: set = set()
    ports = [reserve_port(taken), reserve_port(taken)]
    launches = {"span_reduce": 0, "onehot_reduce": 0}

    def take() -> dict:
        got = read_launches(fused)
        for k in launches:
            launches[k] += got[k]
        reset_launches(fused)
        return got

    def router_keys(i: int) -> dict:
        """r<i>'s keys: the result cache on (the reference's default);
        the push loops, the stale window and the backfill loop an hour
        (every push and backfill step below is by hand); no retire pass
        (phase 22's)."""
        return {"tsd.torch.device": "cuda", "tsd.tpu.warmup": "false",
                "tsd.cluster.role": "router",
                "tsd.cluster.peers": ",".join(addrs[:CLUSTER_SHARDS]),
                "tsd.cluster.routers":
                    f"r{1 - i}=127.0.0.1:{ports[1 - i]}",
                "tsd.cluster.spool.dir": str(spools[i]),
                "tsd.cluster.gossip.interval_ms": GOSSIP_HAND_MS,
                "tsd.cluster.gossip.stale_ms": GOSSIP_HAND_MS,
                "tsd.cluster.reshard.interval_ms": GOSSIP_HAND_MS,
                "tsd.cluster.retire.enable": "false"}

    def start_router(i: int):
        t = TSDB(Config(**router_keys(i)))
        st = ServerThread(t, host="127.0.0.1", port=ports[i]).start()
        t.cluster.gossip.stop()
        return [t, t.cluster, HttpRpcRouter(t), st]

    def put(h, idx, label: str) -> float:
        pts = [{"metric": METRIC, "timestamp": int(ts2d[i, j]),
                "value": float(values[i, j]), "tags": tags[i]}
               for i in idx.tolist() for j in range(POINTS)]
        t = time.perf_counter()
        for k in range(0, len(pts), RESHARD_BODY):
            resp = h.handle(HttpRequest(
                method="POST", path="/api/put",
                params={"summary": ["true"]},
                body=json.dumps(pts[k:k + RESHARD_BODY]).encode()))
            check(resp.status == 200
                  and json.loads(resp.body)["failed"] == 0,
                  f"{label} put: {resp.status} {resp.body[:300]!r}")
        put_s = time.perf_counter() - t
        print(f"  {label}: {len(pts)} points of {len(idx)} more cut series "
              f"put through the router in {put_s:.3f} s "
              f"({len(pts) / put_s:,.0f} points/s) (on {card})")
        return put_s

    def causes(h) -> list:
        resp = h.handle(HttpRequest(method="GET", path="/api/health"))
        check(resp.status == 200, f"/api/health answered {resp.status}")
        return json.loads(resp.body)["causes"]

    def one_push(bus, label: str) -> float:
        t = time.perf_counter()
        acked = bus.push_once()
        ms = (time.perf_counter() - t) * 1e3
        check(acked == 1, f"{label}: the push was acknowledged {acked} "
              "times")
        return ms

    def through_r1(label: str) -> tuple[dict, dict, int]:
        """Both queries once through r1, its cache as it stands: the
        rows of each, the launches and r1's new cache hits."""
        hits = rc1.cache_hits
        take()
        rows = {}
        for m, _k in QUERIES:
            status, rows[m], deg, _ = _cluster_rows(h1, HttpRequest, m,
                                                    start, end)
            check(status == 200 and not deg,
                  f"{label} {m}: {status}, degraded {deg}")
        return rows, take(), rc1.cache_hits - hits

    def fresh_in_r1(label: str, ref: dict) -> None:
        """Both queries through r1's cache after a push: each a miss
        (the bumped version), one K1 or K2 on every shard, held to
        ``ref`` by phase 2's rule."""
        rows, got, hits = through_r1(label)
        check(got == {"span_reduce": CLUSTER_SHARDS,
                      "onehot_reduce": CLUSTER_SHARDS} and hits == 0,
              f"{label}: {got} launches, {hits} cache hits; want a miss "
              "a query on every shard")
        for m, _k in QUERIES:
            _held_groups(torch, rows[m], "dc" if "{dc=*}" in m else "rack",
                         *ref[m], f"{label} {m}")

    rs: list = [None, None]
    try:
        rs = [start_router(0), start_router(1)]
        (_t0, rc0, h0, _s0), (_t1, rc1, h1, _s1) = rs
        names = [f"s{i}" for i in range(CLUSTER_SHARDS + 1)]
        keys = [series_shard_key(METRIC, tags[i]) for i in keep.tolist()]
        own = np.asarray([t_[0] for t_ in rc0.ring.shards_for_keys(keys)])
        t = time.perf_counter()
        for i, t_shard in enumerate(shards[:CLUSTER_SHARDS]):
            rows = keep[own == f"s{i}"]
            t_shard.add_series_points(METRIC, [tags[j] for j in rows],
                                      ts2d[rows], values[rows])
        load_s = time.perf_counter() - t
        # each router learns the other's nonce (a join each way)
        hello_ms = [one_push(rc0.gossip, "r0's hello"),
                    one_push(rc1.gossip, "r1's hello")]
        print(f"  {len(keep)} series (i < {RESHARD_SERIES}, dc0-dc"
              f"{CLUSTER_DCS - 1}) x {POINTS} points on {CLUSTER_SHARDS} "
              f"shards, loaded in {load_s:.3f} s; routers r0 :{ports[0]} "
              f"and r1 :{ports[1]}, each naming the other; the first "
              f"pushes (joins) {hello_ms[0]:.1f} / {hello_ms[1]:.1f} ms "
              f"(on {card})")
        mark("start")

        # (a) a write through r0 reaches r1's cache over one push
        ref_0 = reshard_reference(values, keep)
        every = np.concatenate([keep, wins[0]])
        ref_a = reshard_reference(values, every)
        start, end = str(T0), str(T0 + POINTS * 60 - 1)
        cached = {}
        take()
        for m, _k in QUERIES:
            key = "dc" if "{dc=*}" in m else "rack"
            first = _cluster_rows(h1, HttpRequest, m, start, end)
            again = _cluster_rows(h1, HttpRequest, m, start, end)
            check(first[0] == again[0] == 200 and first[1] == again[1],
                  f"(a) {m}: r1's repeat is not its first answer")
            _held_groups(torch, first[1], key, *ref_0[m],
                         f"(a) {m} warm in r1")
            cached[m] = first[1]
        got = take()
        check(got == {"span_reduce": CLUSTER_SHARDS,
                      "onehot_reduce": CLUSTER_SHARDS}
              and rc1.cache_hits >= 2,
              f"(a) warming r1: {got} launches, {rc1.cache_hits} hits; "
              "want one miss a query on every shard, then a hit")
        put_a = put(h0, wins[0], "(a) r0")
        stale, got, hits = through_r1("(a) r1 before any push")
        check(stale == cached and not any(got.values()) and hits == 2,
              f"(a) before any push r1 answered anew: {got} launches, "
              f"{hits} cache hits")
        applied = rc1.gossip.deltas_applied
        push_ms = one_push(rc0.gossip, "(a) r0 to r1")
        applied = rc1.gossip.deltas_applied - applied
        check(applied > 0, "(a) r1 applied no delta")
        fresh_in_r1("(a) r1 after the push", ref_a)
        print(f"  (a) negative control: before any push r1 answers both "
              f"queries from its cache, the write not in them; one push "
              f"r0 -> r1 in {push_ms:.1f} ms ({applied} delta(s) "
              "applied), and r1's next reads miss its cache, one K1 or "
              "K2 on every shard, and hold the write")

        # the timed p50s: each call a miss (caches dropped ahead of it)
        reads_a, rows_a = {}, {}
        for i in (1, 0):
            reads_a[f"r{i}"], rows_a[i] = router_reads(
                torch, rs[i][2], f"(a) through r{i} after the push", ref_a,
                CLUSTER_SHARDS, take, card, before=rs[i][0].drop_caches)
        out["a"] = {"push_ms": push_ms, "hello_ms": hello_ms,
                    "put_s": put_a, "reads": reads_a}
        mark("a")

        # (b) a partition: r1's pushes to r0 fail (the fault site
        # cluster.gossip.r0 on r1, and cluster.gossip.r1 on r0). First
        # r1's cache holds both queries again ((a)'s timed calls dropped
        # it before each call: it kept the last query's alone)
        warm_b, _got, _hits = through_r1("(b) r1 warmed")
        check(warm_b == rows_a[1], "(b) r1's warm answers differ from "
              "(a)'s timed ones")
        rc1.gossip.stale_s = GOSSIP_STALE_MS / 1000.0
        rs[1][0].faults.arm("cluster.gossip.r0", error_rate=1.0)
        rs[0][0].faults.arm("cluster.gossip.r1", error_rate=1.0)
        check(rc1.gossip.push_once() == 0 and rc0.gossip.push_once() == 0,
              "(b) a push crossed the partition")
        every = np.concatenate([every, wins[1]])
        ref_b = reshard_reference(values, every)
        put_b = put(h0, wins[1], "(b) r0, unseen by r1")
        t = time.perf_counter()
        while not rc1.gossip.degraded():
            check(time.perf_counter() - t < 30, "(b) r1 never degraded")
            time.sleep(0.01)
        check("cluster_gossip_degraded" in causes(h1),
              f"(b) r1's /api/health causes {causes(h1)}")
        bypass0 = rc1.gossip.cache_bypasses
        reads_b = {"r1": router_reads(
            torch, h1, "(b) through r1, degraded", ref_b, CLUSTER_SHARDS,
            take, card)[0]}
        bypasses = rc1.gossip.cache_bypasses - bypass0
        check(bypasses == 2 * (RESHARD_REPEATS + 1),
              f"(b) {bypasses} cache bypasses through r1")
        reads_b["r0"] = router_reads(
            torch, h0, "(b) through r0", ref_b, CLUSTER_SHARDS, take, card,
            before=rs[0][0].drop_caches)[0]
        rs[1][0].faults.disarm("cluster.gossip.r0")
        rs[0][0].faults.disarm("cluster.gossip.r1")
        # r1's own push landing clears its degraded state; r0's deltas
        # of the partition have not reached r1 yet
        heal_ms = one_push(rc1.gossip, "(b) r1 to r0 after the partition")
        check(not rc1.gossip.degraded()
              and "cluster_gossip_degraded" not in causes(h1),
              "(b) the landed push left r1 degraded")
        rc1.gossip.stale_s = rc0.gossip.stale_s
        # negative control: r1 answers from the entries it held before
        # the partition, without the partition's writes
        stale, got, hits = through_r1("(b) r1 before r0's push")
        check(stale == warm_b and not any(got.values()) and hits == 2,
              f"(b) before r0's push r1 answered anew: {got} launches, "
              f"{hits} cache hits")
        sync_ms = one_push(rc0.gossip, "(b) r0 to r1 after the partition")
        fresh_in_r1("(b) r1 after r0's push", ref_b)
        print(f"  (b) r1 degraded after its {GOSSIP_STALE_MS} ms stale "
              f"window: cluster_gossip_degraded in /api/health, "
              f"{bypasses} reads around the cache, each on every shard "
              f"and exact; one landed push ({heal_ms:.1f} ms) cleared it; "
              f"r1 then answered (a)'s cached rows until r0's push "
              f"({sync_ms:.1f} ms) carried the partition's writes: the "
              "next reads missed, on every shard, and held them")
        out["b"] = {"stale_ms": GOSSIP_STALE_MS, "put_s": put_b,
                    "cache_bypasses": bypasses, "heal_push_ms": heal_ms,
                    "sync_push_ms": sync_ms,
                    "reads": reads_b}
        mark("b")

        # (c) r0 begins 3 -> 4, r1 adopts the window over one push, r0
        # is shut down mid-window; r1 finishes alone. The backfill moves
        # every series whose owner changes, (c)'s own writes included
        every = np.concatenate([every, wins[2]])
        ref_c = reshard_reference(values, every)
        keys = [series_shard_key(METRIC, tags[i]) for i in every.tolist()]
        new_own = np.asarray([t_[0] for t_ in HashRing(
            names, vnodes=rc0.ring.vnodes).shards_for_keys(keys)])
        old_own = np.asarray([t_[0] for t_ in
                              rc0.ring.shards_for_keys(keys)])
        resp = h0.handle(HttpRequest(
            method="POST", path="/api/cluster/reshard",
            body=json.dumps({"peers": ",".join(addrs)}).encode()))
        check(resp.status == 200 and json.loads(resp.body)["epoch"] == 1,
              f"(c) reshard install: {resp.status} {resp.body[:300]!r}")
        adopt_ms = one_push(rc0.gossip, "(c) r0 to r1 with the window")
        # a unit copied by r0 before it goes (as phase 22 (c))
        step = rc0.backfill_step()
        check(step.get("phase") == "copied", f"(c) r0's unit: {step}")
        check(rc1.gossip.topology_adoptions == 1 and rc1.epoch == 1
              and rc1.resharding and rc1.ring.names == names,
              f"(c) r1 adopted {rc1.gossip.topology_adoptions} times, "
              f"epoch {rc1.epoch}, ring {rc1.ring.names}")
        rs[0][3].stop()  # r0's server, its router and its TSDB
        rs[0] = None
        check(rc1.resharding, "(c) r1 finished before r0 went down")
        put_c = put(h1, wins[2], "(c) r1, in the window, r0 down")
        t = time.perf_counter()
        steps = []
        while rc1.resharding:
            steps.append(rc1.backfill_step().get("phase"))
            check(steps[-1] != "blocked" and len(steps) < 200,
                  f"(c) r1's backfill steps {steps}")
        backfill_s = time.perf_counter() - t
        moved = int((old_own != new_own).sum())
        bf = rc1.backfiller
        check(bf.backfilled_series == moved
              and bf.backfilled_points == moved * POINTS,
              f"(c) r1 backfilled {bf.backfilled_series} series, "
              f"{bf.backfilled_points} points; {moved} moved")
        print(f"  (c) r0 began 3 -> 4; one push ({adopt_ms:.1f} ms) and r1 "
              f"adopted the window (topology_adoptions 1, epoch 1); r0 shut "
              f"down; r1 copied {bf.backfilled_series} series, "
              f"{bf.backfilled_points} points in {len(steps)} steps by "
              f"hand (r0's unit again, duplicates dedupe on the shards) "
              f"and finalized alone in {backfill_s:.3f} s (on {card})")
        rs[0] = start_router(0)
        rc0 = rs[0][1]
        check(rc0.epoch == 1 and rc0.resharding,
              f"(c) the rebuilt r0 resumed epoch {rc0.epoch}, window "
              f"{rc0.resharding}")
        converge_ms = one_push(rc1.gossip, "(c) r1 to the rebuilt r0")
        check(rc0.epoch == rc1.epoch == 1 and not rc0.resharding
              and rc0.ring.names == rc1.ring.names == names
              and rc0.gossip.topology_adoptions == 1,
              f"(c) the rebuilt r0: epoch {rc0.epoch}, window "
              f"{rc0.resharding}, ring {rc0.ring.names}")
        print(f"  (c) r0 rebuilt over its spool dir at epoch 1 with the "
              f"window open; one push from r1 ({converge_ms:.1f} ms) "
              f"finalized it: both routers at epoch 1 on {names}")
        routes = shard_routes(shards, rc1.ring, True, take)
        print(f"  (c) routes at epoch 1: {routes}")
        for n, per in routes.items():
            check(per == {"dc": "span_reduce", "rack": "onehot_reduce"},
                  f"(c) {n} at epoch 1 routes {per}")
        reads_c = {f"r{i}": router_reads(
            torch, rs[i][2], f"(c) through r{i} at epoch 1", ref_c,
            CLUSTER_SHARDS + 1, take, card, before=rs[i][0].drop_caches)[0]
            for i in (1, 0)}
        out["c"] = {"adopt_push_ms": adopt_ms, "put_s": put_c,
                    "backfill": {"s": backfill_s,
                                 "series": bf.backfilled_series,
                                 "points": bf.backfilled_points},
                    "converge_push_ms": converge_ms, "routes": routes,
                    "reads": reads_c}
        out["topology_adoptions"] = {
            "r0": rc0.gossip.topology_adoptions,
            "r1": rc1.gossip.topology_adoptions}
        mark("c")
    finally:
        for r in rs:
            if r is not None:
                r[3].stop()
        for st in sts:
            st.stop()
        for sp in spools:
            shutil.rmtree(sp, ignore_errors=True)
    mark("stop")
    out["launches"] = dict(launches)
    out["stage_s"] = stage_s
    out["phase_s"] = time.perf_counter() - t_phase
    print("  seconds by stage: " + ", ".join(
        f"{k} {v:.1f}" for k, v in stage_s.items()))
    print(f"phase 23: {out['phase_s']:.1f} s")
    return launches, out


# phase 24: the command line, its codec and the rest of the HTTP surface.
# (a)-(c) run on phase 10's data directory after its (d): a quarter of
# config 3 (STORE_CUT, 250k series x 60 points, 15M points) as a
# snapshot and a one-point WAL tail, read through the port's
# ``tools.cli``; (d) runs inside phase 8's server window, on phase 3's
# TSDB and keys.
# (b): the dc groups dumped by scan --import and re-imported: dc0-dc4
# (12.5k series x 60 points), CUT from dc0-dc9 for the run's time
TOOLS_DCS = 5
TOOLS_TIMEOUT_S = 300      # (a): the subprocess query's own limit
CHECK_DC = "dc0"           # (d): the group `tsdb check` reads


def cli_lines(rows) -> list[str]:
    """The reference's ``tsdb query`` lines of an answer
    (``opentsdb_tpu/tools/cli.py:188-192``): metric, seconds, the value
    (an int when whole), the sorted tags."""
    out = []
    for r in rows:
        tag_str = " ".join(f"{k}={v}" for k, v in sorted(r.tags.items()))
        for ts, v in r.dps:
            val = int(v) if float(v).is_integer() else v
            out.append(f"{r.metric} {ts // 1000} {val} {tag_str}".rstrip())
    return out


def run_cli(argv) -> tuple[int, str, float]:
    """``opentsdb_tpu_torch.tools.cli.main(argv)`` in this process:
    (exit code, its stdout, wall seconds)."""
    import contextlib
    import io
    from opentsdb_tpu_torch.tools import cli
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = cli.main(list(argv))
    return code, out.getvalue(), time.perf_counter() - t


def cli_query_args(m: str) -> list[str]:
    """A URI sub-query as ``tsdb query``'s words: ``sum:...:metric
    tagk=v ...``."""
    spec, _, tags = m.rstrip("}").partition("{")
    return [spec] + (tags.split(",") if tags else [])


def phase_tools(torch, d: Path, ref, values, query) -> dict:
    """Phase 24 (a)-(c): ``tsdb query``, ``scan --import``, ``import`` and
    ``fsck`` on phase 10's directory ``d``. ``ref`` is phase 10 (a)'s
    TSDB, which never died and took the same writes, and ``values`` the
    data those writes leave. Returns the kernel launches of its
    queries."""
    import gzip
    import tempfile
    import numpy as np
    from opentsdb_tpu_torch import TSDB, Config
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.tools.fsck import MAX_VALID_MS
    t_phase = time.perf_counter()
    launches = {"span_reduce": 0, "onehot_reduce": 0}
    (m_dc, k1), (m_rack, k2) = QUERIES
    window = [str(T0), str(T0 + POINTS * 60 - 1)]
    flags = [f"--{k}={v}" for k, v in ENGINE_KEYS.items()]
    refs = config3_reference(values)

    def counted(kname: str, what: str, fn):
        other = k2 if kname == k1 else k1
        reset_launches(fused)
        out = fn()
        n = read_launches(fused)
        check(n == {kname: 1, other: 0}, f"{what} launched {n}, not one "
              f"{kname}")
        launches[kname] += 1
        return out

    # (a) the entry point in a fresh process on the card, then in this one
    cmd = [sys.executable, "-m", "opentsdb_tpu_torch.tools.cli", "query",
           f"--tsd.storage.data_dir={d}", *flags, *window,
           *cli_query_args(m_dc)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=TOOLS_TIMEOUT_S)
    sub_s = time.perf_counter() - t
    check(proc.returncode == 0, f"tsdb query exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    want = ref.execute_query(query(m_dc))
    got = proc.stdout.splitlines()
    check(got == cli_lines(want), "tsdb query's lines differ from the "
          "reference's format of the in-process answer")
    err = held_to_reference(want, refs[m_dc])
    print(f"  (a) `tsdb query {' '.join(cli_query_args(m_dc))}` in a fresh "
          f"process on the card (snapshot and WAL tail, point-path keys): "
          f"{sub_s:.3f} s wall; {len(got)} lines, each the reference's "
          f"format of phase 10 (a)'s in-process answer; max |d| vs the "
          f"float64 numpy reference {err!r}")
    code, out, cli_s = counted(k2, f"tsdb query {m_rack}", lambda: run_cli(
        ["query", f"--tsd.storage.data_dir={d}", *flags, *window,
         *cli_query_args(m_rack)]))
    want_rack = ref.execute_query(query(m_rack))
    check(code == 0 and out.splitlines() == cli_lines(want_rack),
          f"tsdb query {m_rack} in process: exit {code}, lines differ")
    err = held_to_reference(want_rack, refs[m_rack])
    print(f"  (a) the same command in process for {m_rack}: {cli_s:.3f} s "
          f"(snapshot load and the query), one {k2} launch, "
          f"{len(out.splitlines())} lines as the reference's format; max "
          f"|d| {err!r}")

    # (b) scan --import of dc0-dc9, gzip, import into a fresh directory
    root = Path(tempfile.mkdtemp(prefix="tsd-tools-"))
    try:
        dcs = [f"dc{i}" for i in range(TOOLS_DCS)]
        code, dump, scan_s = run_cli(
            ["scan", f"--tsd.storage.data_dir={d}", *flags, "--import",
             *window, METRIC, f"dc={'|'.join(dcs)}"])
        rows_in = np.flatnonzero(np.arange(len(values)) % 100 < TOOLS_DCS)
        n_lines = len(rows_in) * POINTS
        check(code == 0 and dump.count("\n") == n_lines,
              f"scan --import: exit {code}, {dump.count(chr(10))} lines, "
              f"not {n_lines}")
        gz = root / "dump.txt.gz"
        t = time.perf_counter()
        gz.write_bytes(gzip.compress(dump.encode(), compresslevel=1))
        gz_s = time.perf_counter() - t
        del dump
        e = root / "imported"
        code, out, imp_s = run_cli(
            ["import", f"--tsd.storage.data_dir={e}",
             "--tsd.core.auto_create_metrics=true", *flags, str(gz)])
        check(code == 0 and f"imported {n_lines} data points" in out,
              f"import: exit {code}: {out[-500:]}")
        phase9 = READINGS.get("import_lines_per_s")
        print(f"  (b) scan --import of {'-'.join(dcs[::len(dcs) - 1])}: "
              f"{n_lines} lines in {scan_s:.3f} s (snapshot load, the "
              f"none query, formatting); gzip {gz.stat().st_size} bytes "
              f"in {gz_s:.3f} s; import with the WAL into a fresh "
              f"directory {imp_s:.3f} s ({n_lines / imp_s:,.0f} points/s, "
              "the snapshot at the end included"
              + (f"; phase 9 (e)'s import_buffer {phase9:,.0f} lines/s)"
                 if phase9 else ")"))
        keys = {"tsd.torch.device": "cuda", **ENGINE_KEYS,
                "tsd.storage.data_dir": str(e)}
        t = time.perf_counter()
        back = TSDB(Config(**keys))
        open_s = time.perf_counter() - t
        counts, ts, vals, _ = back.store.read_all()
        hosts = {i: int(n[1:]) for n, i in back.uids.tag_values.items()
                 if n.startswith("h")}
        hk = back.uids.tag_names.get_id("host")
        order = np.asarray([hosts[dict(tags)[hk]]
                            for _, tags in back.store.series_identities()])
        check(len(order) == len(rows_in) and bool((counts == POINTS).all())
              and np.array_equal(np.sort(order), rows_in),
              f"read back {len(order)} series, not {len(rows_in)}")
        # the scan prints what the engine returns: at the default
        # tsd.torch.dtype, D's values rounded to float32 (as the
        # reference's scan on its float32 device)
        want_ts = (T0 + 60 * np.arange(POINTS, dtype=np.int64)) * 1000
        dumped = values[order].astype(np.float32).astype(np.float64)
        check(np.array_equal(ts.reshape(-1, POINTS),
                             np.broadcast_to(want_ts, (len(order), POINTS)))
              and np.array_equal(vals.reshape(-1, POINTS).view(np.int64),
                                 dumped.view(np.int64)),
              "the imported points differ from the scanned ones")
        before = counted(k1, f"{m_dc} on the imported data",
                         lambda: back.execute_query(query(m_dc)))
        key, prefix, wv, terms = refs[m_dc]
        err = held_to_reference(before, (key, prefix, wv[:TOOLS_DCS],
                                         terms[:TOOLS_DCS]))
        back.shutdown(flush=False)
        del back
        print(f"  (b) restart from it: {open_s:.3f} s; {len(order)} series "
              f"x {POINTS} points read back exactly as scanned (timestamps, "
              f"and the value bits of D's points in float32, the engine's "
              f"dtype); {m_dc} there: one {k1} launch, {len(before)} "
              f"groups held to D's {len(before)} by phase 2's rule, max |d| "
              f"{err!r}")

        # (c) fsck over D, then two injected faults on (b)'s directory
        code, out, fsck_s = run_cli(["fsck", f"--tsd.storage.data_dir={d}",
                                     *flags])
        check(code == 0 and out == "Total errors: 0\n",
              f"fsck over D: exit {code}: {out[-500:]}")
        print(f"  (c) fsck over D ({len(values) * POINTS} points, "
              f"{len(values)} series): 0 errors, {fsck_s:.3f} s (snapshot "
              "load and the scan)")
        hurt = TSDB(Config(**keys))
        sid = 0
        hurt.store.append(sid, T0 * 1000 + 30_000, float("nan"))
        hurt.store.append(sid, MAX_VALID_MS + 1000, 1.0)
        hurt.shutdown()          # the snapshot holds both
        del hurt
        code, out, s1 = run_cli(["fsck", f"--tsd.storage.data_dir={e}",
                                 *flags])
        lines = out.splitlines()
        check(code == 1 and lines[-1] == "Total errors: 2"
              and any("1 non-finite value(s)" in ln for ln in lines)
              and any("1 timestamp(s) out of range" in ln for ln in lines),
              f"fsck after the injection: exit {code}: {out[-500:]}")
        code, out, s2 = run_cli(["fsck", f"--tsd.storage.data_dir={e}",
                                 *flags, "--fix"])
        check(code == 0 and out.splitlines()[-1]
              == "Total errors: 2  (fixed: 2)",
              f"fsck --fix: exit {code}: {out[-500:]}")
        code, out, s3 = run_cli(["fsck", f"--tsd.storage.data_dir={e}",
                                 *flags])
        check(code == 0 and out == "Total errors: 0\n",
              f"fsck after --fix: exit {code}: {out[-500:]}")
        fixed = TSDB(Config(**keys))
        after = counted(k1, f"{m_dc} after the repair",
                        lambda: fixed.execute_query(query(m_dc)))
        fixed.shutdown(flush=False)
        del fixed
        check(same_bits(after, before), f"{m_dc} after the repair differs "
              "from the answer before the injection")
        print(f"  (c) on (b)'s directory, a NaN at T0+30 s and a point past "
              f"MAX_VALID_MS on series 0: fsck found both ({s1:.3f} s, exit "
              f"1), fsck --fix fixed both ({s2:.3f} s), fsck again clean "
              f"({s3:.3f} s); {m_dc} after the repair equals the answer "
              "before the injection bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 24 (a)-(c): {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_graph(torch, tsdb, port: int, query, ref3: dict, values,
                answers: dict, get_bodies: dict) -> dict:
    """Phase 24 (d), inside phase 8's server window (phase 3's TSDB and
    keys, the point path): ``/q`` ascii, JSON and PNG, ``/s``, ``/``,
    ``tsdb check`` and ``cleancache``. ``values`` is phase 3's data,
    ``answers`` phase 8 (a)'s ``execute_query`` answers through the
    serializer (parsed) and ``get_bodies`` its ``/api/query`` GET
    bodies, on the same data and keys. Returns the kernel launches of
    its queries."""
    import http.client
    import struct
    import tempfile
    import urllib.parse
    import numpy as np
    from opentsdb_tpu_torch.ops import fused
    t_phase = time.perf_counter()
    launches = {"span_reduce": 0, "onehot_reduce": 0}
    (m_dc, k1), (m_rack, k2) = QUERIES
    q0 = query(m_dc)
    start, end = q0.start, q0.end
    cache = Path(tempfile.mkdtemp(prefix="tsd-qcache-"))
    tsdb.config.override_config("tsd.http.cachedir", str(cache))
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def path(endpoint: str, m: str, *flags: str) -> str:
        return (f"{endpoint}?" + urllib.parse.urlencode(
            {"start": start, "end": end, "m": m})
            + "".join(f"&{f}" for f in flags))

    def get(p: str, kname: str | None):
        """GET ``p``; ``kname`` must launch once (None: no launch)."""
        reset_launches(fused)
        status, body, secs = _http(conn, "GET", p)
        n = read_launches(fused)
        want = {k: int(k == kname) for k in launches}
        check(n == want, f"GET {p[:80]} launched {n}, not {want}")
        if kname is not None:
            launches[kname] += 1
        return status, body, secs

    try:
        status, body, secs = get(path("/q", m_dc, "ascii"), k1)
        # _render's ascii lines of execute_query's answer (its JSON
        # carries each value's float64 repr, so the floats are exact)
        want = "\n".join(
            f"{r['metric']} {int(ts)} {v:g} "
            f"{' '.join(f'{k}={x}' for k, x in sorted(r['tags'].items()))}"
            .rstrip() for r in answers[m_dc]
            for ts, v in r["dps"].items()).encode()
        check(status == 200 and body == want,
              f"/q ascii: HTTP {status}, body differs from execute_query's")
        n_lines = len(body.splitlines())
        print(f"  (d) /q {m_dc} ascii: {secs * 1e3:.3f} ms, one {k1} launch, "
              f"{n_lines} lines equal to execute_query's answer in "
              "_render's ascii format")
        status, body, secs = get(path("/q", m_rack, "json"), k2)
        check(status == 200 and body == get_bodies[m_rack],
              "/q json differs from phase 8 (a)'s /api/query body")
        wv, terms = ref3[m_rack]
        err = compare(_fe_values(json.loads(body), wv.shape[0],
                                 wv.shape[1] + 1), wv, terms)
        print(f"  (d) /q {m_rack} json: {secs * 1e3:.3f} ms, one {k2} "
              f"launch, {len(body)} bytes equal to phase 8 (a)'s "
              f"/api/query GET body byte for byte; max |d| vs phase 3's "
              f"reference {err!r}")
        png = path("/q", m_dc, "wxh=1024x768")
        status, body, secs = get(png, k1)
        if status == 200:
            w, h = struct.unpack(">II", body[16:24])
            check(body[:8] == b"\x89PNG\r\n\x1a\n" and (w, h) == (1024, 768),
                  f"/q png: {(w, h)}")
            s2, again, secs2 = get(png, None)
            check(s2 == 200 and again == body, "the cached PNG differs")
            said = (f"200 image/png {w}x{h} in {secs * 1e3:.3f} ms (one "
                    f"{k1} launch, the M4 budget of 1024 px after it); "
                    f"again from the disk cache in {secs2 * 1e3:.3f} ms, "
                    "no launch")
        else:
            check(status == 501 and b"Graphing requires matplotlib" in body,
                  f"/q png: HTTP {status}: {body[:300]!r}")
            said = (f"501 (no matplotlib on this host: the reference's "
                    f"answer) after one {k1} launch, {secs * 1e3:.3f} ms")
        print(f"  (d) /q {m_dc} wxh=1024x768: {said}")
        for p, want_status in (("/s/index.html", 200), ("/", 200),
                               ("/s/../../etc/passwd", 404)):
            status, body, _ = get(p, None)
            check(status == want_status, f"GET {p}: HTTP {status}")
        print("  (d) /s/index.html 200, / 200 (the same page), "
              "/s/../../etc/passwd 404")
        # tsdb check over /q?...&ascii&nagios, thresholds from the
        # reference's answer: the sum over dc0's series at each minute
        dc0 = values[int(CHECK_DC[2:])::100]
        top = float(dc0.sum(axis=0).max())
        base = ["check", "-H", "127.0.0.1", "-p", str(port), "-m", METRIC,
                "-t", f"dc={CHECK_DC}", "-d", str(POINTS * 60),
                "-N", str(T0 + POINTS * 60)]
        said = []
        for thresholds, want_code in ((["-c", str(2 * top)], 0),
                                      (["-w", str(top / 2), "-c",
                                        str(2 * top)], 1),
                                      (["-c", str(top / 2)], 2)):
            code, out, secs = run_cli(base + thresholds)
            check(code == want_code and f"{POINTS}" in out,
                  f"tsdb check {thresholds}: exit {code}: {out!r}")
            said.append(f"exit {code} {secs * 1e3:.1f} ms")
        print(f"  (d) tsdb check -m {METRIC} -t dc={CHECK_DC} (the sum of "
              f"{len(dc0)} series, {POINTS} points, max {top:.1f}) with "
              "-c above it, -w below and -c above, -c below: "
              + ", ".join(said))
        code, out, _ = run_cli(["cleancache",
                                f"--tsd.http.cachedir={cache}"])
        check(code == 0 and out.startswith("removed ")
              and not cache.exists(), f"cleancache: {out!r}")
        print(f"  (d) cleancache: {out.strip()}")
    finally:
        conn.close()
        shutil.rmtree(cache, ignore_errors=True)
    print(f"  phase 24 (d): {time.perf_counter() - t_phase:.1f} s; "
          f"launches {launches}")
    return launches


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
        for i in range(MAIN_REPEATS + 1):
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

        (sel, tag_mat, gids, g), plan_t = timed(plan, MAIN_REPEATS)
        padded, mat_t = timed(lambda: store.materialize_padded(
            sel, tq.start_ms, tq.end_ms), MAIN_REPEATS)

        def assign():
            bidx, bts = ds_mod.assign_buckets_padded(
                padded.ts2d, padded.counts, sub.ds_spec, tq.start_ms,
                tq.end_ms)
            return bidx, bts, pipeline.detect_regular_padded(
                padded.counts, bidx, len(bts))

        (bidx, bts, k), assign_t = timed(assign, MAIN_REPEATS)
        b = len(bts)
        spec = PipelineSpec(num_series=len(sel), num_buckets=b,
                            num_groups=g, ds_function="avg",
                            agg_name="sum", rate=True)
        vals, up_t = timed(lambda: pipeline.upload(
            padded.values2d, torch.float32, "cuda"), MAIN_REPEATS)
        batch, prep_t = timed(lambda: fused.prepare(vals, bts, gids, spec),
                              MAIN_REPEATS)
        (res_t, emit_t), run_t = timed(lambda: fused.run(batch, spec, k),
                                       MAIN_REPEATS)
        _, asm_t = timed(lambda: eng._build_results(
            tq, sub, metric_id, sel, tag_mat, gids, g, bts,
            res_t.cpu().numpy(), emit_t.cpu().numpy()), MAIN_REPEATS)
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

    def graphs(port: int, answers: dict, get_bodies: dict) -> None:
        header("phase 24 (d): /q, /s, tsdb check and cleancache on phase "
               f"8's server, {s} series, the point-path keys")
        for kname, n in phase_graph(torch, tsdb, port, query, ref3,
                                    values, answers, get_bodies).items():
            launches[kname] += n

    for kname, n in phase_front_end(torch, tsdb, query, ref3,
                                    args.profile, graphs).items():
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
    # phase 17 runs here too: (a) and (b) on phase 3's TSDB
    header(f"phase 17: the operator surface (annotations, lookups, the "
           f"write hooks, authentication, durability of the new state), "
           f"{s} series")
    ops_launches, ops = phase_ops(torch, tsdb, values, tags, fused)
    for kname, n in ops_launches.items():
        launches[kname] += n
    # phase 19 (a) and (b) run here too, on phase 3's TSDB while it serves
    header(f"phase 19 (a)-(b): traced queries, the tracing tax and the "
           f"read surface, {s} series")
    t_obs = time.perf_counter()
    obs_launches, obs = phase_obs(torch, tsdb, values, report)
    obs_s = time.perf_counter() - t_obs
    for kname, n in obs_launches.items():
        launches[kname] += n
    tsdb.shutdown()
    del tsdb, tags, ts2d, values
    # the routers of phases 8-17 hold phase 3's TSDB in reference
    # cycles: free it, and phase 17's TSDBs, before phase 7 times
    gc.collect()
    header(f"phase 7: irregular data, {s} series x {POINTS} slots"
           + ("" if s == 1_000_000 else " (CUT from 1,000,000)")
           + f" (|got - want| <= {TOL_REL}*sum|terms| + {TOL_ABS})")
    for m, _tz, _kind in IRREGULAR_QUERIES:
        b_irr = 4 if "15mc" in m else (12 if "5m-" in m else POINTS * 10)
        if m == UNION_QUERY:
            placement(m, s // UNION_SHARE, b_irr, 2, m.split(":")[0])
            continue
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

    def tools(d: Path, ref, written) -> None:
        header(f"phase 24 (a)-(c): tsdb query, scan --import, import and "
               f"fsck on phase 10's directory, {cut} series x {POINTS} "
               "points (CUT from 1,000,000), the point-path keys "
               f"(|got - want| <= {TOL_REL}*sum|terms| + {TOL_ABS})")
        for kname, n in phase_tools(torch, d, ref, written, query).items():
            launches[kname] += n

    for kname, n in phase_durability(torch, cut, query, tools).items():
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
           "round (CUT from 5, then 2)"
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
    cn = min(LC_SERIES, s)
    header(f"phase 18: the data lifecycle, BASELINE config 5's shape, {cn} "
           f"series x {LC_SPAN_S} points at 1 s (CUT from 100,000 x 24 h)"
           f" (|got - want| <= {TOL_REL}*sum|terms| + {TOL_ABS})")
    for m, _ in LC_QUERIES:
        placement(m, cn, (LC_DEMOTE_B // 1000 - LC_START) // 60,
                  min(cn, 100 if "{dc=*}" in m else 2000))
    lc_launches, lifecycle = phase_lifecycle(torch, fused, cn)
    for kname, n in lc_launches.items():
        launches[kname] += n
    qn = min(CTL_SERIES, s)
    header(f"phase 19 (c)-(e): the control plane, tenant QoS and "
           f"self-telemetry, {qn} series x {CTL_SPAN_S} points at 1 s"
           + ("" if qn == CTL_SERIES else " (series CUT from 100,000)")
           + f" (|got - want| <= {TOL_REL}*|want| + {TOL_ABS})")
    t_ctl = time.perf_counter()
    ctl_launches, ctl = phase_control(torch, qn)
    for kname, n in ctl_launches.items():
        launches[kname] += n
    obs.update(ctl)
    obs_s += time.perf_counter() - t_ctl
    obs["phase_s"] = obs_s
    print(f"phase 19: {obs_s:.1f} s")
    header(f"phase 20: the cluster at one replica, a router over "
           f"{CLUSTER_SHARDS} shard TSDs on one card, config 3's series "
           f"of dc0-dc{CLUSTER_DCS - 1} (CUT from 1,000,000 to "
           f"{CLUSTER_DCS}%) (|got - want| <= {TOL_REL}*sum|terms| + "
           f"{TOL_ABS})")
    data = make_data(s)
    cl_launches, cluster, to21 = phase_cluster(torch, data, ref3, card,
                                               args.profile, header)
    for kname, n in cl_launches.items():
        launches[kname] += n
    for kname, n in to21["fed_launches"].items():
        launches[kname] += n
    gc.collect()   # phase 20's TSDBs, before three new shards load
    header(f"phase 21 (b)-(d): replication at tsd.cluster.rf={RF}, a "
           f"router over {CLUSTER_SHARDS} new shard TSDs, the same series "
           f"on {RF} owners each (|got - want| <= {TOL_REL}*sum|terms| + "
           f"{TOL_ABS})")
    t_rf = time.perf_counter()
    keep = np.asarray([i for i in range(s) if i % 100 < CLUSTER_DCS],
                      dtype=np.int64)
    rf_launches, replication = phase_replicated(
        torch, data, keep, ref3, to21["rf1_rows"], card)
    for kname, n in rf_launches.items():
        launches[kname] += n
    replication["federated"] = to21["fed"]
    replication["phase_s"] = to21["fed"]["phase_s"] \
        + time.perf_counter() - t_rf
    print(f"phase 21: {replication['phase_s']:.1f} s")
    gc.collect()   # phase 21's TSDBs, before four new shards load
    header(f"phase 22: online resharding, a router over "
           f"{CLUSTER_SHARDS} shard TSDs grown to {CLUSTER_SHARDS + 1}, "
           f"config 3's series i < {RESHARD_SERIES} of dc0-dc"
           f"{CLUSTER_DCS - 1} (CUT from 1,000,000: 17 series a rack, "
           f"the fewest at which every shard's {{rack=*}} runs K2 on 3 "
           f"and on 4 shards) (|got - want| <= {TOL_REL}*sum|terms| + "
           f"{TOL_ABS})")
    rs_launches, reshard = phase_reshard(torch, data, card)
    for kname, n in rs_launches.items():
        launches[kname] += n
    gc.collect()   # phase 22's TSDBs, before four new shards load
    header(f"phase 23: sibling routers, r0 and r1 on their own sockets "
           f"over {CLUSTER_SHARDS} shard TSDs and a spare, phase 22's cut "
           f"of config 3 (i < {RESHARD_SERIES} of dc0-dc{CLUSTER_DCS - 1},"
           f" CUT from 1,000,000) (|got - want| <= {TOL_REL}*sum|terms| + "
           f"{TOL_ABS})")
    gs_launches, gossip = phase_gossip(torch, data, card)
    del data
    for kname, n in gs_launches.items():
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
    print(json.dumps({"ops": ops}))
    print(json.dumps({"lifecycle": lifecycle}))
    print(json.dumps({"obs": obs}))
    print(json.dumps({"cluster": cluster}))
    print(json.dumps({"replication": replication}))
    print(json.dumps({"reshard": reshard}))
    print(json.dumps({"gossip": gossip}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
