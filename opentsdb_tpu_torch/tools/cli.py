"""The ``tsdb`` command line of the port (ref: ``tsdb.in:65-117``,
``src/tools/``, ``opentsdb_tpu/tools/cli.py``).

    python -m opentsdb_tpu_torch.tools.cli <command> [args]
        [--config=FILE] [--tsd.key=value ...] [--datadir DIR]
        [--auto-metric] [--port N]

The subcommands are the reference's:

- ``tsd``      start the TSD server (TSDMain.java:48)
- ``query``    ad-hoc queries, CliQuery's output (CliQuery.java:34);
  ``--graph PATH`` draws a PNG with matplotlib instead
- ``import``   bulk load text files, gzip by extension
  (TextImporter.java:40); ``--no-wal`` skips the WAL
- ``scan``     dump series, ``--import`` in import format
  (DumpSeries.java:42)
- ``mkmetric`` assign metric UIDs (``uid assign metrics``)
- ``uid``      grep/assign/rename/delete/fsck/metasync/metapurge of the
  UID tables (UidManager.java:50)
- ``fsck``     storage integrity check, ``--fix``/``--fix-all`` repair
  (Fsck.java:83)
- ``search``   ``lookup [--use_meta]`` of time series (Search.java)
- ``treesync`` run every series through the trees (TreeSync.java)
- ``rollup``   the rollup job over ``START END [INTERVAL ...]``
- ``version``, ``drain`` (tools/tsddrain.py), ``check`` (tools/check_tsd)
  and ``cleancache`` (tools/clean_cache.sh)

A command that reads or writes data builds a TSDB from the config (the
store of ``tsd.storage.data_dir``), on the card unless
``--tsd.torch.device=cpu`` asks for the CPU, and shuts it down before
it returns: its threads joined, the WAL closed and the store freed. A
command that writes (``import``, ``uid assign``/``rename``/``delete``/
``metasync``/``metapurge``, ``fsck`` that fixed something, ``rollup``)
snapshots into the data_dir first, as the reference flushes; the others
leave the snapshot as it is. ``query`` at the default keys runs the
grid path; with the point path's keys (``--tsd.query.grid_reduce=false``
and the rest) it launches the fused kernels.

Config handling is CliOptions/ConfigArgP's: ``--config=PATH`` loads a
properties file (else the first of ``./opentsdb.conf``,
``/etc/opentsdb.conf``, ... that exists), then each ``--tsd.key=value``
flag overrides a key. With no command, ``-h``, ``--help`` or ``help``
the usage goes to stderr and the exit code is 2, as for an unknown
command.

``tsd`` prints ``TSD listening on HOST:PORT`` once it is bound (port 0
binds an ephemeral one), logs to stderr and stops cleanly on SIGINT,
SIGTERM, telnet ``diediedie`` or HTTP ``/diediedie``.
"""

from __future__ import annotations

import asyncio
import gzip
import logging
import os
import signal
import sys
import time

from opentsdb_tpu_torch.utils.config import Config

USAGE = """usage: tsdb <command> [args]
Valid commands: fsck, import, mkmetric, query, tsd, scan, search,
                treesync, rollup, uid, version, drain, check,
                cleancache
"""


def parse_common_args(argv: list[str]) -> tuple[Config, list[str]]:
    """(ref: CliOptions.parse + ConfigArgP overrides) ``--config``,
    ``--tsd.key=value`` (or ``--tsd.key value``), ``--auto-metric``,
    ``--datadir`` and ``--port``; the rest is returned."""
    config_file = None
    overrides: dict[str, str] = {}
    rest: list[str] = []
    i = 0

    def value() -> str:
        nonlocal i
        if "=" in argv[i]:
            return argv[i].split("=", 1)[1]
        i += 1
        return argv[i]

    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--config"):
            config_file = value()
        elif arg.startswith("--tsd."):
            overrides[arg[2:].split("=", 1)[0]] = value()
        elif arg == "--auto-metric":
            overrides["tsd.core.auto_create_metrics"] = "true"
        elif arg.startswith("--datadir"):
            overrides["tsd.storage.data_dir"] = value()
        elif arg.startswith("--port"):
            overrides["tsd.network.port"] = value()
        else:
            rest.append(arg)
        i += 1
    config = Config(config_file=config_file, auto_load=config_file is None)
    for k, v in overrides.items():
        config.override_config(k, v)
    return config, rest


def make_tsdb(config: Config):
    from opentsdb_tpu_torch.core.tsdb import TSDB
    return TSDB(config)


def _parse_queries(args: list[str], force_none: bool):
    """``START [END] query [tagk=v ...] ...`` into a validated TSQuery
    (ref: CliQuery.parseCommandLineQuery). END is optional: it is the
    second word when that word has no ``:``."""
    from opentsdb_tpu_torch.query.model import TSQuery, parse_uri_subquery
    start, pos, end = args[0], 1, None
    if pos < len(args) and ":" not in args[pos]:
        end = args[pos]
        pos += 1
    subs = []
    while pos < len(args):
        spec = args[pos]
        pos += 1
        tag_parts = []
        while pos < len(args) and "=" in args[pos] \
                and ":" not in args[pos]:
            tag_parts.append(args[pos])
            pos += 1
        if tag_parts:
            spec += "{" + ",".join(tag_parts) + "}"
        if force_none and ":" not in spec:
            spec = "none:" + spec
        sub = parse_uri_subquery(spec, len(subs))
        if force_none:
            sub.aggregator = "none"
        subs.append(sub)
    tsq = TSQuery(start=start, end=end, queries=subs)
    tsq.validate()
    return tsq


def _print_rows(results, raw: bool) -> None:
    """``metric ts value tags``, integral values without a fraction
    (ref: CliQuery); ``raw`` is DumpSeries' ``metric ts_ms value
    {tags}``."""
    for r in results:
        tag_str = " ".join(f"{k}={v}" for k, v in sorted(r.tags.items()))
        for ts, v in r.dps:
            val = int(v) if float(v).is_integer() else v
            if raw:
                print(f"{r.metric} {ts} {val} {{{tag_str}}}")
            else:
                print(f"{r.metric} {ts // 1000} {val} {tag_str}".rstrip())


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_tsd(config: Config, args: list[str]) -> int:
    """(ref: TSDMain.java:71) The startup plugin (``tsd.startup``) is
    initialized with the config before the TSDB exists; then the TSDB
    is built, its plugin slots with it, so a card asked for and absent,
    or a plugin that does not load, fails here, before anything
    listens; then the RPC plugins (``tsd.rpc``) start. Once the socket
    is bound the startup plugin's ``set_ready(tsdb)`` runs; at the end
    the RPC plugins and the startup plugin shut down."""
    from opentsdb_tpu_torch.tsd.server import TSDServer
    from opentsdb_tpu_torch.utils.plugin import load_plugin_instances

    # the server's log lines (the warmup's class count among them) go
    # to stderr; a handler of its own, since the /logs ring's handler is
    # on the root logger already and basicConfig would then do nothing
    stderr = logging.StreamHandler()
    stderr.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logging.getLogger().addHandler(stderr)
    logging.getLogger().setLevel(logging.INFO)
    startup = load_plugin_instances(config, "tsd.startup", single=True)
    tsdb = make_tsdb(config)
    server = TSDServer(tsdb)
    rpc_plugins = load_plugin_instances(config, "tsd.rpc", init_arg=tsdb)

    async def main():
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, server.request_shutdown)
        await server.start()
        if startup is not None:
            startup.set_ready(tsdb)
        print(f"TSD listening on {server.host}:{server.port}", flush=True)
        await server.serve_forever()

    asyncio.run(main())
    for plugin in rpc_plugins:
        plugin.shutdown()
    if startup is not None:
        startup.shutdown()
    return 0


def cmd_query(config: Config, args: list[str]) -> int:
    """``tsdb query [--graph PATH] START [END] <aggregator:[ds:][rate:]
    metric [tagk=v ...]> ...`` (ref: CliQuery.java:34; ``--graph`` is
    CliQuery's chart output, a matplotlib PNG here instead of gnuplot
    files). Output: ``metric timestamp value tags``."""
    graph_path = None
    if "--graph" in args:
        i = args.index("--graph")
        if i + 1 >= len(args):
            print("--graph needs a PATH", file=sys.stderr)
            return 2
        graph_path = args[i + 1]
        del args[i:i + 2]
    if len(args) < 2:
        print("usage: tsdb query [--graph PATH] START-DATE [END-DATE] "
              "[queries...]", file=sys.stderr)
        return 2
    tsq = _parse_queries(args, force_none=False)
    if graph_path:
        # before the query runs: a large scan is not wasted on a host
        # without the optional dependency
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("--graph requires matplotlib", file=sys.stderr)
            return 2
    tsdb = make_tsdb(config)
    try:
        results = tsdb.new_query().run(tsq)
    finally:
        tsdb.shutdown(flush=False)
    if graph_path:
        from opentsdb_tpu_torch.tsd.graph import plot_results_basic
        fig, ax = plt.subplots(figsize=(10, 6), dpi=100)
        plot_results_basic(ax, results)
        if results:
            ax.legend(fontsize=8)
        fig.autofmt_xdate()
        fig.savefig(graph_path)
        plt.close(fig)
        print(f"wrote {graph_path}")
        return 0
    _print_rows(results, raw=False)
    return 0


def cmd_import(config: Config, args: list[str]) -> int:
    """(ref: TextImporter.java:40) Lines ``metric ts value tagk=tagv
    ...``; a ``.gz`` file is read through gzip. Each 64 MiB chunk goes
    through ``TSDB.import_buffer`` (one native parse, UIDs resolved once
    a series, one WAL write and sync a chunk). A bad line prints
    ``error: PATH:LINE: why`` and the rest go on; past 100 errors the
    import stops. ``--no-wal`` leaves the lines out of the WAL (ref:
    the batch import's ``setDurable(false)``); the closing snapshot
    makes them durable."""
    durable = "--no-wal" not in args
    args = [a for a in args if a != "--no-wal"]
    if not args:
        print("usage: tsdb import [--no-wal] path [more paths]",
              file=sys.stderr)
        return 2
    tsdb = make_tsdb(config)
    total = 0
    errors = 0
    start = time.monotonic()
    chunk_bytes = 64 << 20

    class _TooManyErrors(Exception):
        pass

    try:
        for path in args:
            opener = gzip.open if path.endswith(".gz") else open
            base_line = 0

            def on_error(i: int, e: Exception) -> None:
                # stop printing, and abort, at the cap: a binary or
                # wrong-format chunk can hold millions of bad lines
                nonlocal errors
                errors += 1
                if errors <= 100:
                    print(f"error: {path}:{base_line + i}: {e}",
                          file=sys.stderr)
                else:
                    raise _TooManyErrors

            with opener(path, "rb") as fh:
                tail = b""
                while True:
                    block = fh.read(chunk_bytes)
                    if not block:
                        buf, tail = tail, b""
                        if not buf:
                            break
                    else:
                        block = tail + block
                        cut = block.rfind(b"\n")
                        if cut < 0:
                            tail = block
                            continue
                        buf, tail = block[:cut + 1], block[cut + 1:]
                    try:
                        written, _ = tsdb.import_buffer(
                            buf, on_error=on_error, durable=durable)
                    except _TooManyErrors:
                        print("too many errors, aborting", file=sys.stderr)
                        return 1
                    total += written
                    base_line += buf.count(b"\n")
                    if not block:
                        break
    finally:
        tsdb.shutdown()
    dt = time.monotonic() - start
    rate = total / dt if dt > 0 else 0
    print(f"Total: imported {total} data points in {dt:.3f}s "
          f"({rate:,.1f} points/s)")
    return 0 if errors == 0 else 1


def cmd_scan(config: Config, args: list[str]) -> int:
    """(ref: DumpSeries.java:42) ``tsdb scan [--import] START [END]
    query...``: every point of the matching series, unaggregated, as
    ``metric ts_ms value {tags}``, or with ``--import`` in the import
    format."""
    import_format = bool(args) and args[0] == "--import"
    if import_format:
        args = args[1:]
    if len(args) < 2:
        print("usage: tsdb scan [--import] START [END] queries...",
              file=sys.stderr)
        return 2
    tsq = _parse_queries(args, force_none=True)
    tsdb = make_tsdb(config)
    try:
        results = tsdb.new_query().run(tsq)
    finally:
        tsdb.shutdown(flush=False)
    _print_rows(results, raw=not import_format)
    return 0


def cmd_mkmetric(config: Config, args: list[str]) -> int:
    """(ref: tsdb.in mkmetric = uid assign metrics)"""
    return cmd_uid(config, ["assign", "metrics"] + args)


def cmd_uid(config: Config, args: list[str]) -> int:
    """(ref: UidManager.java:50)"""
    if not args:
        print("usage: tsdb uid <subcommand> args\n"
              "  grep [kind] <RE>\n"
              "  assign <kind> <name>...\n"
              "  rename <kind> <name> <newname>\n"
              "  delete <kind> <name>\n"
              "  fsck\n  metasync\n  metapurge", file=sys.stderr)
        return 2
    tsdb = make_tsdb(config)
    try:
        return _uid(tsdb, args)
    finally:
        # grep and fsck read; the rest write (ref: their flush)
        tsdb.shutdown(flush=args[0] not in ("grep", "fsck"))


def _uid(tsdb, args: list[str]) -> int:
    sub = args[0]
    kinds = ("metrics", "tagk", "tagv")
    if sub == "assign":
        if len(args) < 3:
            print("usage: tsdb uid assign <kind> <name>...",
                  file=sys.stderr)
            return 2
        registry = tsdb.uids.by_kind(args[1])
        kind = "metric" if args[1] == "metrics" else args[1]
        for name in args[2:]:
            try:
                uid = tsdb.assign_uid(kind, name)
                print(f"{name} {args[1]}: "
                      f"[{', '.join(str(b) for b in registry.int_to_uid(uid))}]")
            except Exception as e:  # noqa: BLE001 - one line a name
                print(f"{name} {args[1]}: {e}", file=sys.stderr)
        return 0
    if sub == "grep":
        kind_filter = None
        pattern_args = args[1:]
        if pattern_args and pattern_args[0] in kinds:
            kind_filter = pattern_args[0]
            pattern_args = pattern_args[1:]
        if not pattern_args:
            print("usage: tsdb uid grep [kind] <RE>", file=sys.stderr)
            return 2
        for kind in (kind_filter,) if kind_filter else kinds:
            registry = tsdb.uids.by_kind(kind)
            for name in registry.grep(pattern_args[0]):
                uid = registry.int_to_uid(registry.get_id(name))
                print(f"{kind} {name}: {uid.hex()}")
        return 0
    if sub == "rename":
        if len(args) != 4:
            print("usage: tsdb uid rename <kind> <name> <newname>",
                  file=sys.stderr)
            return 2
        tsdb.uids.by_kind(args[1]).rename(args[2], args[3])
        return 0
    if sub == "delete":
        if len(args) != 3:
            print("usage: tsdb uid delete <kind> <name>", file=sys.stderr)
            return 2
        tsdb.uids.by_kind(args[1]).delete(args[2])
        return 0
    if sub == "fsck":
        errors = _uid_fsck(tsdb)
        print(f"{errors} errors found")
        return 0 if errors == 0 else 1
    if sub == "metasync":
        count = 0
        for mid in tsdb.store.metric_ids():
            for sid in tsdb.store.series_ids_for_metric(mid):
                rec = tsdb.store.series(int(sid))
                tsdb.meta.on_datapoint(rec.metric_id, rec.tags, int(sid))
                count += 1
        print(f"synced meta for {count} timeseries")
        return 0
    if sub == "metapurge":
        # (ref: UidManager.java:208 -> MetaPurge threads)
        n_ts, n_uid = tsdb.meta.purge()
        print(f"purged {n_ts} TSMeta and {n_uid} UIDMeta entries")
        return 0
    print(f"unknown uid subcommand: {sub}", file=sys.stderr)
    return 2


def _uid_fsck(tsdb) -> int:
    """(ref: UidManager fsck) The forward and reverse maps agree."""
    errors = 0
    for kind in ("metric", "tagk", "tagv"):
        registry = tsdb.uids.by_kind(kind)
        with registry._lock:
            fwd = dict(registry._name_to_id)
            rev = dict(registry._id_to_name)
        for name, uid in fwd.items():
            if rev.get(uid) != name:
                print(f"ERROR: {kind} forward map {name}->{uid} has no "
                      f"matching reverse entry")
                errors += 1
        for uid, name in rev.items():
            if fwd.get(name) != uid:
                print(f"ERROR: {kind} reverse map {uid}->{name} has no "
                      f"matching forward entry")
                errors += 1
    return errors


def cmd_fsck(config: Config, args: list[str]) -> int:
    """(ref: Fsck.java:83) The report's lines, then the total; exit 0
    when every error found was fixed."""
    from opentsdb_tpu_torch.tools.fsck import run_fsck
    fix = "--fix" in args or "--fix-all" in args
    tsdb = make_tsdb(config)
    try:
        report = run_fsck(tsdb, fix=fix)
    finally:
        # run_fsck snapshots its own repairs
        tsdb.shutdown(flush=False)
    for line in report.lines:
        print(line)
    print(f"Total errors: {report.errors}  (fixed: {report.fixed})" if fix
          else f"Total errors: {report.errors}")
    return 0 if report.errors == report.fixed else 1


def cmd_search(config: Config, args: list[str]) -> int:
    """(ref: Search.java) ``tsdb search lookup [--use_meta] metric
    tagk=tagv...``"""
    from opentsdb_tpu_torch.search.lookup import time_series_lookup
    if not args or args[0] != "lookup":
        print("usage: tsdb search lookup [--use_meta] <query>",
              file=sys.stderr)
        return 2
    args = args[1:]
    use_meta = bool(args) and args[0] == "--use_meta"
    if use_meta:
        args = args[1:]
    metric = args[0] if args and "=" not in args[0] else "*"
    tags = [tuple(a.split("=", 1)) for a in args if "=" in a]
    tsdb = make_tsdb(config)
    try:
        out = time_series_lookup(tsdb, metric, tags, limit=2**31,
                                 use_meta=use_meta)
    finally:
        tsdb.shutdown(flush=False)
    for r in out["results"]:
        tag_str = " ".join(f"{k}={v}" for k, v in sorted(r["tags"].items()))
        print(f"{r['metric']} {tag_str}  tsuid={r['tsuid']}")
    print(f"{out['totalResults']} results")
    return 0


def cmd_treesync(config: Config, args: list[str]) -> int:
    """(ref: TreeSync.java)"""
    from opentsdb_tpu_torch.tree.tree import tree_manager
    tsdb = make_tsdb(config)
    try:
        count = tree_manager(tsdb).sync_all()
    finally:
        tsdb.shutdown(flush=False)
    print(f"Processed {count} timeseries through trees")
    return 0


def cmd_rollup(config: Config, args: list[str]) -> int:
    """Run the rollup job over ``[START, END]`` (any time the query API
    takes) into every configured tier, or the given intervals, with
    ``tsd.rollups.enable`` set; prints the points written per tier
    (ref: ``cmd_rollup``)."""
    from opentsdb_tpu_torch.rollup.job import run_rollup_job
    from opentsdb_tpu_torch.utils import datetime_util
    if len(args) < 2:
        print("usage: tsdb rollup START END [interval...]", file=sys.stderr)
        return 2
    config.override_config("tsd.rollups.enable", "true")
    tsdb = make_tsdb(config)
    try:
        start_ms = datetime_util.parse_datetime_ms(args[0])
        end_ms = datetime_util.parse_datetime_ms(args[1])
        written = run_rollup_job(tsdb, start_ms, end_ms, args[2:] or None)
    finally:
        tsdb.shutdown()
    for interval, count in written.items():
        print(f"{interval}: {count} rollup points written")
    return 0


def cmd_version(config: Config, args: list[str]) -> int:
    from opentsdb_tpu_torch.tsd.http_api import version_info
    info = version_info()
    print(f"opentsdb_tpu_torch version [{info['version']}] "
          f"built from revision {info['short_revision']}")
    return 0


def cmd_drain(config: Config, args: list[str]) -> int:
    """(ref: tools/tsddrain.py, the outage spooler)"""
    from opentsdb_tpu_torch.tools.drain import main as drain_main
    return drain_main(args)


def cmd_check(config: Config, args: list[str]) -> int:
    """(ref: tools/check_tsd, the Nagios threshold check)"""
    from opentsdb_tpu_torch.tools.check_tsd import main as check_main
    return check_main(args)


def cmd_cleancache(config: Config, args: list[str]) -> int:
    """Purge the /q graph cache (ref: tools/clean_cache.sh)."""
    import shutil
    cache_dir = config.get_string("tsd.http.cachedir")
    if os.path.isdir(cache_dir):
        n = len(os.listdir(cache_dir))
        shutil.rmtree(cache_dir, ignore_errors=True)
        print(f"removed {n} cached entries from {cache_dir}")
    else:
        print(f"no cache at {cache_dir}")
    return 0


COMMANDS = {
    "tsd": cmd_tsd,
    "query": cmd_query,
    "import": cmd_import,
    "scan": cmd_scan,
    "mkmetric": cmd_mkmetric,
    "uid": cmd_uid,
    "fsck": cmd_fsck,
    "search": cmd_search,
    "treesync": cmd_treesync,
    "rollup": cmd_rollup,
    "version": cmd_version,
    "drain": cmd_drain,
    "check": cmd_check,
    "cleancache": cmd_cleancache,
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(USAGE, file=sys.stderr)
        return 2
    command = argv[0]
    handler = COMMANDS.get(command)
    if handler is None:
        print(f"unknown command: {command}\n{USAGE}", file=sys.stderr)
        return 2
    config, rest = parse_common_args(argv[1:])
    return handler(config, rest)


if __name__ == "__main__":
    sys.exit(main())
