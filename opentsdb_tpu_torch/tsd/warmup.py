"""Server-start warmup (ref: ``opentsdb_tpu/tsd/warmup.py``).

The reference pre-compiles the XLA programs of the common query shape
classes in a background thread at server start, so the first query of
each class does not pay a multi-second compile. The port has no XLA
compiles, but its first query pays for other things that start-up can
take instead: building or loading the CUDA library
(``ops/_cuda_build.py``) and the store library (``native/_build.py``),
creating the CUDA context, and PyTorch's lazy loading of the modules
and kernels the grid tail uses. So its warmup does three things, in a
thread started by the TSD server (``tsd.tpu.warmup``, true by default):

1. it loads the libraries, building them where needed (the CUDA one
   only when the query device is a card);
2. it runs every class the reference would compile once, on zeros:
   each resident store's (S, B, G) combination from
   :func:`warmup_shapes`, times the reference's aggregator specs
   ({sum, avg} x {plain, rate}, and p95/p99 under
   ``tsd.tpu.warmup.percentiles``), plus the ``none`` aggregator's
   per-series class. Each runs where the engine would place it
   (``query/engine.py::host_tail_for_dims``, the same function): on the
   host CPU under the host-tail budget, else on the query device;
3. it runs the avg-divide tail (``execute_avg_divide``), placed as the
   linear class, where the sum and count tiers of a rollup interval
   are resident.

With a query mesh (``tsd.query.mesh``), step 2 runs each class's
aggregator specs through the mesh's grid step instead
(``parallel.sharded_pipeline.run_sharded_grid`` over a cut grid of
zeros), as the reference warms its sharded programs; a mesh query never
takes the host tail, and the reference warms neither the ``none`` class
nor the avg divide there, so neither runs.

(The reference also compiles its histogram percentile programs; the
port's histogram path runs PyTorch functions with no compile to warm,
so it runs none of them here.)

The reference buckets S and G into shape classes (``ops/shapes``)
because its compiled programs are keyed on shapes. The port's programs
are not, so it takes S and G as they are: :func:`warmup_shapes` is the
reference's class list before its bucketing; only the placement
buckets them, inside ``host_tail_for_dims``.

``tsd.tpu.warmup.buckets`` adds series counts to warm,
``tsd.tpu.warmup.budget_s`` bounds the run (0: no bound), and
:func:`run_warmup` stops between classes once ``tsdb._warmup_stop`` is
set (a stopping server sets it). A failed library build or class
raises in the warmup thread, which logs it: nothing switches to
another path, and the first query then raises the same error.
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

log = logging.getLogger("warmup")

# warm at most this many metrics' tag indexes per store, and cap the
# group classes derived from tag cardinality (ref: _GROUP_SCAN_METRICS,
# _GROUP_CLASS_CAP)
_GROUP_SCAN_METRICS = 32
_GROUP_CLASS_CAP = 2048
# the bucket counts of the reference's two dashboard classes: 1h at 1m
# and 24h at 5m
_WARM_BUCKETS = (60, 288)


def _group_classes(store) -> set[int]:
    """The group counts a wildcard group-by over ``store`` can produce:
    the distinct tag values per (metric, tag key), of at most
    ``_GROUP_SCAN_METRICS`` metrics, capped (ref: ``_group_classes``)."""
    out: set[int] = set()
    for mid in store.metric_ids()[:_GROUP_SCAN_METRICS]:
        idx = store.metric_index(mid)
        if idx is None:
            continue
        _, triples = idx.arrays()
        if len(triples) == 0:
            continue
        kids = triples[:, 1]
        for kid in np.unique(kids):
            nv = int(len(np.unique(triples[kids == kid, 2])))
            if nv > 1:
                out.add(min(nv, _GROUP_CLASS_CAP))
    return out


def _resident_stores(tsdb) -> list:
    """The raw store, and every rollup tier and the preagg store that
    hold series (ref: ``_resident_stores``)."""
    stores = [tsdb.store]
    rs = tsdb.rollup_store
    if rs is not None:
        stores += [st for _key, st in rs.tiers() if st.num_series()]
        pre = rs.preagg_store()
        if pre.num_series():
            stores.append(pre)
    return stores


def warmup_shapes(tsdb) -> list[tuple[int, int, int]]:
    """The (S, B, G) classes to warm: per resident store its series
    count S (at least 1) and group classes (1, ``min(S, 100)`` and the
    tag cardinalities), at each of the two bucket counts, plus the
    series counts of ``tsd.tpu.warmup.buckets``; sorted, without
    duplicates. The reference's list before its shape bucketing."""
    per_store = [(max(store.num_series(), 1), _group_classes(store))
                 for store in _resident_stores(tsdb)]
    for tok in tsdb.config.get_string("tsd.tpu.warmup.buckets",
                                      "").split(","):
        if tok.strip():
            per_store.append((int(tok), set()))
    combos = set()
    for s, gset in per_store:
        for g in gset | {1, min(s, 100)}:
            for b in _WARM_BUCKETS:
                combos.add((s, b, int(g)))
    return sorted(combos)


def load_libraries(tsdb) -> None:
    """Load the store library and, on a card, the CUDA library,
    building each where needed (a failed build raises)."""
    from opentsdb_tpu_torch.native import _build as native_build
    native_build.library()
    if tsdb.device.type == "cuda":
        from opentsdb_tpu_torch.ops import _cuda_build
        _cuda_build.library()


def _agg_specs(tsdb, s: int, b: int, g: int, pct: bool):
    """(spec, device) of each warm class: placed by the engine's own
    ``host_tail_for_dims`` (ref: ``dev_lin``, ``dev_pct``,
    ``dev_raw``)."""
    from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
    from opentsdb_tpu_torch.query.engine import host_tail_for_dims
    cfg = tsdb.config

    def placed(agg_name: str, emit_raw: bool = False, **kw):
        host = host_tail_for_dims(cfg, s, b, g, emit_raw, agg_name)
        return (PipelineSpec(num_series=s, num_buckets=b, num_groups=g,
                             ds_function="avg", agg_name=agg_name,
                             emit_raw=emit_raw, host=host is not None,
                             **kw), host or tsdb.device)

    for agg in ("sum", "avg"):
        for rate in (False, True):
            yield placed(agg, rate=rate)
    if pct:
        for agg in ("p95", "p99"):
            yield placed(agg)
    # the aggregator "none" class: per series, no group stage
    yield placed("sum", emit_raw=True)


def _avg_divide_resident(tsdb) -> bool:
    """Whether the sum and count tiers of some interval hold series
    (ref: ``warm_avgdiv``)."""
    rs = tsdb.rollup_store
    if rs is None:
        return False
    tiers = dict(rs.tiers())
    return any(agg == "sum" and (iv, "count") in tiers
               and st.num_series() for (iv, agg), st in tiers.items())


def run_warmup(tsdb) -> int:
    """Load the libraries, then run the warm set on the query device
    (see the module docstring). Returns the number of classes run; it
    stops between classes when ``tsdb._warmup_stop`` is set or the
    budget (``tsd.tpu.warmup.budget_s``) is spent."""
    from opentsdb_tpu_torch.ops.pipeline import (execute_avg_divide,
                                                 execute_grid, put_grid)
    t0 = time.monotonic()
    load_libraries(tsdb)
    cfg = tsdb.config
    pct = cfg.get_bool("tsd.tpu.warmup.percentiles", True)
    budget_s = cfg.get_int("tsd.tpu.warmup.budget_s", 600)
    stop = tsdb._warmup_stop
    avg_div = _avg_divide_resident(tsdb)
    dtype = tsdb.dtype
    ran = 0

    def halt() -> bool:
        if stop is not None and stop.is_set():
            log.info("warmup stopped after %d classes", ran)
            return True
        if budget_s and time.monotonic() - t0 > budget_s:
            log.warning("warmup budget (%ds) spent after %d classes",
                        budget_s, ran)
            return True
        return False

    mesh = tsdb.query_mesh
    for s, b, g in warmup_shapes(tsdb):
        if halt():
            return ran
        grids = {}
        bts = np.arange(b, dtype=np.int64) * 60_000
        gids = np.zeros(s, dtype=np.int32)
        if mesh is not None:
            ran += _warm_mesh_class(tsdb, mesh, s, b, g, pct, halt)
            continue
        specs = list(_agg_specs(tsdb, s, b, g, pct))
        for spec, where in specs:
            if halt():
                return ran
            if where not in grids:
                grids[where] = put_grid(np.zeros((s, b)),
                                        np.zeros((s, b), bool), dtype,
                                        where)
            grid, has = grids[where]
            # .cpu() waits for the device, as a query's answer does
            execute_grid(grid, has, bts, gids, spec)[0].cpu()
            ran += 1
        if avg_div:
            for spec, where in specs[:4:2]:      # sum and avg, plain
                if halt():
                    return ran
                grid = grids[where][0]
                execute_avg_divide(grid, grid, bts, gids, spec)[0].cpu()
                ran += 1
    log.info("warmup: %d classes in %.1fs", ran, time.monotonic() - t0)
    return ran


def _warm_mesh_class(tsdb, mesh, s: int, b: int, g: int, pct: bool,
                     halt) -> int:
    """One (S, B, G) class through the mesh's grid step: one cut grid
    of zeros, shared by the aggregator specs ({sum, avg} x {plain,
    rate}, and p95/p99 with ``pct``), none placed on the host. Returns
    the number of specs run."""
    from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
    from opentsdb_tpu_torch.parallel.sharded_pipeline import (
        prepare_sharded_grid, run_sharded_grid, sharded_grid_gids)
    args, s_loc, b_loc, s_pad = prepare_sharded_grid(
        mesh, np.zeros((s, b)), np.zeros((s, b), dtype=bool),
        np.arange(b, dtype=np.int64) * 60_000, tsdb.dtype)
    dgids = sharded_grid_gids(mesh, np.zeros(s, dtype=np.int32), s_pad, g)
    aggs = [(agg, rate) for agg in ("sum", "avg") for rate in (False, True)]
    if pct:
        aggs += [("p95", False), ("p99", False)]
    ran = 0
    for agg, rate in aggs:
        if halt():
            break
        spec = PipelineSpec(num_series=s, num_buckets=b, num_groups=g,
                            ds_function="avg", agg_name=agg, rate=rate)
        # host arrays: the copy waits for the device, as a query's does
        run_sharded_grid(mesh, spec, (*args, dgids), s_loc, b_loc, g)
        ran += 1
    return ran


def _run_logged(tsdb) -> None:
    try:
        run_warmup(tsdb)
    except Exception:  # noqa: BLE001 - the thread's end: log it
        # nothing switches to another path: the first query that needs
        # what failed raises the same error
        log.exception("warmup failed")


def start_warmup_thread(tsdb) -> threading.Thread | None:
    """Start the warmup in a background thread (``shape-warmup``), or
    None while ``tsd.tpu.warmup`` is false. ``tsdb._warmup_stop``
    stops it between classes; the server joins the thread on stop."""
    if not tsdb.config.get_bool("tsd.tpu.warmup", True):
        return None
    tsdb._warmup_stop = threading.Event()
    t = threading.Thread(target=_run_logged, args=(tsdb,),
                         name="shape-warmup", daemon=True)
    t.start()
    return t
