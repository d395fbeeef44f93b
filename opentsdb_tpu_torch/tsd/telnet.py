"""Telnet line protocol (ref: ``src/tsd/TelnetRpc.java`` and
RpcManager's telnet command table: put, rollup, histogram, stats,
version, dropcaches, help, exit, diediedie).

Commands return response text, empty when there is nothing to say: a
successful ``put`` is silent, as PutDataPointRpc.java:129 writes back
only errors, and so are ``rollup`` and ``histogram``.
"""

from __future__ import annotations

import base64
from typing import Callable

from opentsdb_tpu_torch.core import tags as tags_mod
from opentsdb_tpu_torch.tsd.http_api import version_info


class TelnetServerShutdown(Exception):
    """Raised by ``diediedie`` to stop the whole TSD."""


class TelnetCloseConnection(Exception):
    """Raised by ``exit`` to close this connection."""


class TelnetRouter:
    def __init__(self, tsdb):
        self.tsdb = tsdb
        self.commands: dict[str, Callable[[list[str]], str]] = {}
        if tsdb.mode in ("rw", "wo"):
            self.commands["put"] = self._cmd_put
            self.commands["rollup"] = self._cmd_rollup
            self.commands["histogram"] = self._cmd_histogram
        self.commands.update({
            "stats": self._cmd_stats,
            "version": self._cmd_version,
            "dropcaches": self._cmd_dropcaches,
            "help": self._cmd_help,
            "exit": self._cmd_exit,
            "diediedie": self._cmd_die,
        })

    def execute(self, line: str) -> str:
        words = line.split()
        if not words:
            return ""
        cmd = self.commands.get(words[0])
        if cmd is None:
            return f"error: unknown command: {words[0]}"
        return cmd(words)

    def execute_lines(self, lines: list[str]
                      ) -> tuple[list[str], Exception | None]:
        """Process a burst of complete lines: consecutive ``put``
        commands decode as one columnar batch (:meth:`put_lines`), the
        rest run in input order. Returns ``(responses, deferred)``
        where ``deferred`` is a close or shutdown raised by a line of
        the burst; the caller writes the earlier lines' responses
        before honouring it."""
        responses: list[str] = []
        run: list[str] = []

        def flush_run() -> None:
            if run:
                responses.extend(self.put_lines(run))
                run.clear()

        batch_put = "put" in self.commands
        for line in lines:
            words = line.split()
            if batch_put and words and words[0] == "put":
                run.append(line)
                continue
            flush_run()
            try:
                r = self.execute(line)
            except (TelnetCloseConnection, TelnetServerShutdown) as e:
                return responses, e
            if r:
                responses.append(r)
        flush_run()
        return responses, None

    def put_lines(self, lines: list[str]) -> list[str]:
        """Columnar decode of a run of ``put`` lines. Returns the error
        responses (successes are silent), each exactly what the scalar
        ``put`` answers for its line.

        On the native store a burst of more than one line goes through
        ``TSDB.import_buffer`` (ref: ``TelnetRouter._put_lines_run``):
        the payloads, which are import lines once the command word is
        stripped, parse in one native pass and land by one append, and
        each line the parser rejects replays through the scalar ``put``
        at its place in the burst, after the lines before it have
        landed. So UIDs are assigned, and duplicate timestamps resolved,
        in line order, as for a client sending one line at a time.

        On the memory store each line's words go through the scalar
        parse, and the good points are grouped by series and land
        through ``TSDB.add_point_groups``.

        With a WAL the whole burst, replayed lines included, commits as
        one WAL write and one group-committed fsync before the answers
        go out."""
        with self.tsdb._wal_scope():
            if len(lines) > 1 and self.tsdb.store.backend == "native":
                return self._put_lines_native(lines)
            return self._put_lines_scalar(lines)

    def _put_lines_scalar(self, lines: list[str]) -> list[str]:
        """Each line through the scalar parse, the good points grouped
        by series into one ``add_point_groups``."""
        errors: dict[int, str] = {}     # line index -> error line
        groups: dict[tuple, tuple] = {}
        for i, line in enumerate(lines):
            words = line.split()
            if len(words) < 5:
                errors[i] = self._cmd_put(words)
                continue
            try:
                metric, ts, value, tags = self._parse_put_words(words)
            except Exception as e:  # noqa: BLE001 - per-line report
                errors[i] = f"put: {type(e).__name__}: {e}"
                continue
            key = (metric, tuple(sorted(tags.items())))
            g = groups.get(key)
            if g is None:
                g = groups[key] = (metric, tags, [], [], [])
            g[2].append(i)
            g[3].append(ts)
            g[4].append(value)

        def on_error(i: int, e: Exception) -> None:
            errors[i] = f"put: {type(e).__name__}: {e}"

        self.tsdb.add_point_groups(groups.values(), on_error=on_error)
        return [errors[i] for i in sorted(errors)]

    def _put_lines_native(self, lines: list[str]) -> list[str]:
        bodies = []
        for ln in lines:
            parts = ln.split(None, 1)
            body = parts[1] if len(parts) > 1 else ""
            if not body.strip() or body.lstrip().startswith("#"):
                # the parser skips a blank or comment line without an
                # error, but such a put must answer one: one token makes
                # the parser reject it (too few fields), so it replays
                body = "-"
            bodies.append(body)
        out: list[str] = []

        def replay(lineno: int, exc: Exception) -> None:
            r = self._cmd_put(lines[lineno - 1].split())
            if r:
                out.append(r)

        self.tsdb.import_buffer(
            ("\n".join(bodies) + "\n").encode("utf-8", "replace"),
            on_error=replay)
        return out

    # ------------------------------------------------------------------

    @staticmethod
    def _parse_put_words(words: list[str]
                         ) -> tuple[str, int, int | float, dict]:
        """The scalar parse of one ``put`` line."""
        metric = words[1]
        ts = int(words[2])
        # strict: int()/float() leniency (underscores, whitespace,
        # unicode digits) would store another number than was sent
        value = tags_mod.parse_put_value(words[3], allow_special=True)
        tags = dict(tags_mod.parse(w) for w in words[4:])
        return metric, ts, value, tags

    def _cmd_put(self, words: list[str]) -> str:
        """``put <metric> <timestamp> <value> <tagk=tagv> [...]``
        (ref: PutDataPointRpc.execute :129)"""
        if len(words) < 5:
            return ("put: illegal argument: not enough arguments "
                    f"(need least 4, got {len(words) - 1})")
        try:
            metric, ts, value, tags = self._parse_put_words(words)
            self.tsdb.add_point(metric, ts, value, tags)
            return ""  # silent on success
        except Exception as e:  # noqa: BLE001 - the error line is the answer
            return f"put: {type(e).__name__}: {e}"

    def _cmd_rollup(self, words: list[str]) -> str:
        """``rollup <interval>:<agg>[:<groupby_agg>] <metric> <ts> <value>
        <tagk=tagv> [...]``, or ``rollup <groupby_agg> ...`` for a
        pre-aggregate alone (ref: RollupDataPointRpc's telnet format,
        ``_cmd_rollup``); silent on success."""
        if len(words) < 6:
            return "rollup: illegal argument: not enough arguments"
        try:
            spec = words[1].split(":")
            if len(spec) == 1:
                interval, agg, gb_agg, is_gb = None, None, spec[0], True
            elif len(spec) == 2:
                interval, agg, gb_agg, is_gb = spec[0], spec[1], None, False
            else:
                interval, agg, gb_agg, is_gb = spec[0], spec[1], spec[2], True
            metric = words[2]
            ts = int(words[3])
            value = tags_mod.parse_put_value(words[4], allow_special=True)
            tags = dict(tags_mod.parse(w) for w in words[5:])
            self.tsdb.add_aggregate_point(metric, ts, value, tags, is_gb,
                                          interval, agg, gb_agg)
            return ""
        except Exception as e:  # noqa: BLE001 - the error line is the answer
            return f"rollup: {type(e).__name__}: {e}"

    def _cmd_histogram(self, words: list[str]) -> str:
        """``histogram <metric> <timestamp> <base64-blob> <tagk=tagv>...``
        (ref: HistogramDataPointRpc); silent on success."""
        if len(words) < 5:
            return "histogram: illegal argument: not enough arguments"
        try:
            metric = words[1]
            ts = int(words[2])
            blob = base64.b64decode(words[3])
            tags = dict(tags_mod.parse(w) for w in words[4:])
            self.tsdb.add_histogram_point(metric, ts, blob, tags)
            return ""
        except Exception as e:  # noqa: BLE001 - the error line is the answer
            return f"histogram: {type(e).__name__}: {e}"

    def _cmd_stats(self, words: list[str]) -> str:
        collector = self.tsdb.stats.collect()
        self.tsdb.collect_stats(collector)
        return "\n".join(collector.lines())

    def _cmd_version(self, words: list[str]) -> str:
        info = version_info()
        return (f"opentsdb_tpu_torch version [{info['version']}] built "
                f"from revision {info['short_revision']}")

    def _cmd_dropcaches(self, words: list[str]) -> str:
        self.tsdb.drop_caches()
        return "Caches dropped."

    def _cmd_help(self, words: list[str]) -> str:
        return "available commands: " + " ".join(sorted(self.commands))

    def _cmd_exit(self, words: list[str]) -> str:
        raise TelnetCloseConnection()

    def _cmd_die(self, words: list[str]) -> str:
        """(ref: RpcManager DieDieDie)"""
        raise TelnetServerShutdown()
