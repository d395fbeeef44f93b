"""The port's operator tools held against the JAX package's, as
``tests/test_ops_tools.py`` drives them: the drain spooler
(``tools/drain.py``: both packages' servers take the same telnet lines
and must spool the same file), the Nagios check's URL building
(``tools/check_tsd.py``: the same URL for the same flags) and the check
against a live TSD of the port (``ServerThread`` on the CPU): both
packages' ``check`` answer each case with the same exit code and the
same line. No numbers are compared but the thresholds' verdicts."""

from __future__ import annotations

import asyncio
import time

import pytest

from opentsdb_tpu.tools import check_tsd as jcheck
from opentsdb_tpu.tools.drain import DrainServer as JDrainServer
from opentsdb_tpu_torch import TSDB, Config
from opentsdb_tpu_torch.tools import check_tsd as tcheck
from opentsdb_tpu_torch.tools.drain import DrainServer
from opentsdb_tpu_torch.tsd.server import ServerThread

LINES = (b"put sys.cpu.user 1356998400 42 host=web01\n"
         b"version\n"
         b"\n"
         b"put sys.cpu.user 1356998410 43 host=web01\n"
         b"sys.cpu.user 1356998420 44 host=web02\n"
         b"exit\n")


def _drain(cls, directory) -> tuple[bytes, int]:
    async def scenario():
        server = cls(str(directory), host="127.0.0.1", port=0)
        await server.start()
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       server.bound_port)
        writer.write(LINES)
        await writer.drain()
        banner = await asyncio.wait_for(reader.readline(), 5)
        await asyncio.wait_for(reader.read(), 5)
        writer.close()
        await server.stop()
        return banner, server.lines_received

    return asyncio.run(scenario())


def test_drain_spools_put_lines(tmp_path):
    jb, jn = _drain(JDrainServer, tmp_path / "j")
    tb, tn = _drain(DrainServer, tmp_path / "t")
    assert b"drain" in jb and tb == b"opentsdb_tpu_torch drain\n"
    assert tn == jn == 3
    spool = (tmp_path / "t" / "127.0.0.1").read_text()
    assert spool == (tmp_path / "j" / "127.0.0.1").read_text()
    assert spool.splitlines() == ["sys.cpu.user 1356998400 42 host=web01",
                                  "sys.cpu.user 1356998410 43 host=web01",
                                  "sys.cpu.user 1356998420 44 host=web02"]


@pytest.mark.parametrize("argv", [
    ["-m", "sys.cpu.user", "-t", "host=web01", "-d", "600", "-a", "avg",
     "-D", "avg", "-W", "60", "-r", "-w", "50", "-N", "1357000000"],
    ["-m", "m", "-c", "1"],
    ["-H", "tsd.example", "-p", "4243", "-m", "m", "-t", "a=b", "-t", "c=*",
     "-D", "max", "-F", "zero", "-S", "-c", "3", "-N", "1357000000"]])
def test_check_tsd_url_building(argv):
    got = tcheck.build_url(tcheck.build_parser().parse_args(argv))
    assert got == jcheck.build_url(jcheck.build_parser().parse_args(argv))
    if argv[-1] == "1357000000" and "-r" in argv:
        assert got == ("http://localhost:4242/q?start=1356999400"
                       "&m=avg:60s-avg-none:rate:sys.cpu.user{host=web01}"
                       "&ascii&nagios")


@pytest.fixture(scope="module")
def live_port():
    """The port's TSD on an ephemeral port, 10 points of ``sys.load``
    over the last 5 minutes."""
    tsdb = TSDB(Config(**{"tsd.core.auto_create_metrics": "true",
                          "tsd.torch.device": "cpu",
                          "tsd.tpu.warmup": "false"}))
    now = int(time.time())
    for i in range(10):
        tsdb.add_point("sys.load", now - 300 + i * 30, 10 * (i + 1),
                       {"host": "web01"})
    st = ServerThread(tsdb).start()
    yield str(st.port)
    st.stop()


@pytest.mark.parametrize("args,code", [
    (["-m", "sys.load", "-d", "600", "-c", "1000"], 0),
    (["-m", "sys.load", "-d", "600", "-c", "50"], 2),
    (["-m", "sys.load", "-d", "600", "-w", "50", "-c", "1000"], 1),
    (["-m", "no.such.metric", "-c", "1"], 2),
    (["-m", "sys.load", "-d", "600", "-c", "1000", "-N", "900000000",
      "-E"], 0),
    (["-m", "sys.load", "-d", "600", "-c", "1000", "-N", "900000000"], 2),
    (["-m", "sys.load", "-d", "600", "-w", "95", "-P", "50"], 0)])
def test_check_tsd_against_live_port(live_port, capsys, args, code):
    """Both packages' checks against the port's TSD: one exit code and
    one verdict line, the reference's states (0 OK, 1 WARNING, 2
    CRITICAL)."""
    out = []
    for mod in (jcheck, tcheck):
        assert mod.main(["-p", live_port, *args]) == code
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert out[1].startswith(("OK", "WARNING", "CRITICAL")[code])
