"""The ``tsdb`` command-line entry point of the port (ref:
``tsdb.in:65-117``, ``src/tools/TSDMain.java``).

    python -m opentsdb_tpu_torch.tools.cli tsd [--tsd.key=value ...]
    python -m opentsdb_tpu_torch.tools.cli rollup START END [INTERVAL ...]
        --tsd.storage.data_dir=DIR [--tsd.key=value ...]

``tsd`` starts the TSD server (HTTP and telnet on one port) over a TSDB
on the card; ``--tsd.torch.device=cpu`` runs it on the CPU instead.
``--tsd.network.port=0`` binds an ephemeral port. The server prints
``TSD listening on HOST:PORT`` once it is bound, logs to stderr (the
warmup's ``warmup: N classes in S s`` among its lines) and stops
cleanly on SIGINT, SIGTERM, telnet ``diediedie`` or HTTP
``/diediedie``.

``rollup`` runs the rollup job over ``[START, END]`` (any time the
query API takes: unix seconds or ms, ``yyyy/MM/dd-HH:mm:ss``,
``1h-ago``) into every configured tier, or the given intervals, with
``tsd.rollups.enable`` set, prints the points written per tier and
flushes the TSDB (a snapshot into its data_dir). The reference's other
subcommands are not ported yet and exit non-zero.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys

from opentsdb_tpu_torch.utils.config import Config

USAGE = """usage: python -m opentsdb_tpu_torch.tools.cli <command> [args]
Valid commands: tsd, rollup
"""

# the reference's other subcommands (ref: tools/cli.py USAGE)
_UNPORTED = ("fsck", "import", "mkmetric", "query", "scan", "search",
             "treesync", "uid", "version", "drain", "check", "cleancache")


def parse_common_args(argv: list[str]) -> tuple[Config, list[str]]:
    """``--tsd.key=value`` (or ``--tsd.key value``) overrides a config
    key (ref: CliOptions + ConfigArgP); the rest is returned."""
    overrides: dict[str, str] = {}
    rest: list[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--tsd."):
            if "=" in arg:
                key, val = arg[2:].split("=", 1)
            else:
                i += 1
                key, val = arg[2:], argv[i]
            overrides[key] = val
        else:
            rest.append(arg)
        i += 1
    return Config(**overrides), rest


def cmd_tsd(config: Config, args: list[str]) -> int:
    """(ref: TSDMain.java:71) Builds the TSDB first, so a card asked
    for and absent fails here, before anything listens."""
    from opentsdb_tpu_torch.core.tsdb import TSDB
    from opentsdb_tpu_torch.tsd.server import TSDServer

    # the server's log lines (the warmup's class count among them) go
    # to stderr
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s")
    tsdb = TSDB(config)
    server = TSDServer(tsdb)

    async def main():
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, server.request_shutdown)
        await server.start()
        print(f"TSD listening on {server.host}:{server.port}", flush=True)
        await server.serve_forever()

    asyncio.run(main())
    return 0


def cmd_rollup(config: Config, args: list[str]) -> int:
    """Run the rollup job over a time range (ref: ``cmd_rollup``)."""
    from opentsdb_tpu_torch.core.tsdb import TSDB
    from opentsdb_tpu_torch.rollup.job import run_rollup_job
    from opentsdb_tpu_torch.utils import datetime_util
    if len(args) < 2:
        print("usage: tsdb rollup START END [interval...]", file=sys.stderr)
        return 2
    config.override_config("tsd.rollups.enable", "true")
    tsdb = TSDB(config)
    start_ms = datetime_util.parse_datetime_ms(args[0])
    end_ms = datetime_util.parse_datetime_ms(args[1])
    written = run_rollup_job(tsdb, start_ms, end_ms, args[2:] or None)
    for interval, count in written.items():
        print(f"{interval}: {count} rollup points written")
    tsdb.shutdown()
    return 0


COMMANDS = {"tsd": cmd_tsd, "rollup": cmd_rollup}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(USAGE, file=sys.stderr)
        return 1
    command, rest = argv[0], argv[1:]
    if command not in COMMANDS:
        known = command in _UNPORTED
        print(f"tsdb {command}: "
              + ("not ported yet" if known else "unknown command"),
              file=sys.stderr)
        return 2
    config, args = parse_common_args(rest)
    return COMMANDS[command](config, args)


if __name__ == "__main__":
    sys.exit(main())
