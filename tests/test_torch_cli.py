"""The port's command line (``opentsdb_tpu_torch/tools/cli.py``) held
against the JAX package's (``opentsdb_tpu/tools/cli.py``), command by
command: the classes of ``tests/test_tools.py`` that drive the commands
(``TestImportQueryScan``, ``TestCliQueryGraph``,
``TestImportEdgeMatrix``, ``TestDumpRoundTrip``, ``TestUidTool``,
``TestSearchAndVersionCli``, ``TestCleanCacheCli``; ``TestFsck`` drives
``run_fsck`` and is twinned in ``test_torch_fsck.py``, beside a
``tsdb fsck`` case here), plus ``--config FILE`` against ``--tsd.*``
overrides and the usage exit codes.

Each case runs ``cli.main`` of both packages with the same arguments
(the port's with ``--tsd.torch.device=cpu --tsd.torch.dtype=float64``
added: the JAX package's tests run in x64) on data directories
of their own, written from the same lines. The exit codes must be
equal, and stdout and stderr equal line for line once each side's
directory is written ``<D>``; the import's timing line and the version
line differ by design, and there only the point count and the format
are compared. In a data line, the metric, timestamp and tags must be
equal exactly and a number within ``torch_pair.assert_rows_close``'s
tolerance: rtol 1e-9 and atol 1e-9 * max|x| over the output.
"""

from __future__ import annotations

import gzip
import re

import numpy as np
import pytest

import torch_pair  # noqa: F401 - the JAX package's private native build

from opentsdb_tpu.tools import cli as jcli
from opentsdb_tpu_torch.tools import cli as tcli

BASE = 1356998400
# the port on the CPU in float64, as the JAX package's tests run (x64)
CPU = ("--tsd.torch.device=cpu", "--tsd.torch.dtype=float64")
IMPORT_LINE = re.compile(r"^Total: imported (\d+) data points in "
                         r"[0-9.]+s \([0-9,.]+ points/s\)$")
VERSION_LINE = re.compile(r"^\S+ version \[[^\]]+\] built from revision "
                          r"\S+$")


class Sides:
    """One directory of each package under ``tmp_path``; ``<D>`` in an
    argument is the side's directory."""

    def __init__(self, tmp_path, capsys):
        self.dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
        for d in self.dirs.values():
            d.mkdir()
        self.capsys = capsys

    def write(self, name: str, text: str, gz: bool = False) -> str:
        for d in self.dirs.values():
            path = d / name
            if gz:
                with gzip.open(path, "wt") as fh:
                    fh.write(text)
            else:
                path.write_text(text)
        return f"<D>/{name}"

    def run(self, *args):
        """Both packages' ``main`` on ``args``; returns the port's
        (code, stdout, stderr) with its directory written ``<D>``,
        after holding the JAX package's to it. The JAX package's read
        commands leave their TSDB open; each is closed here after its
        output is taken (a later test file on the same worker counts
        threads)."""
        got = {}
        for side, mod in (("jax", jcli), ("port", tcli)):
            d = str(self.dirs[side])
            argv = [a.replace("<D>", d) for a in args]
            if side == "port" and argv and argv[0] not in (
                    "version", "drain", "check", "cleancache", "help",
                    "-h", "--help"):
                argv.extend(CPU)
            made = []
            real = jcli.make_tsdb
            jcli.make_tsdb = lambda config: made.append(real(config)) \
                or made[-1]
            try:
                code = mod.main(argv)
            finally:
                jcli.make_tsdb = real
            out = self.capsys.readouterr()
            for t in made:
                t.shutdown()
                pool = getattr(t, "_fanout_pool", None)
                if pool is not None:
                    pool.shutdown(wait=True)
            got[side] = (code, out.out.replace(d, "<D>"),
                         out.err.replace(d, "<D>"))
        (jc, jo, je), (tc, to, te) = got["jax"], got["port"]
        assert tc == jc, (got["port"], got["jax"])
        same_output(to, jo)
        same_output(te, je)
        return got["port"]


def _floats(text: str) -> list[float]:
    out = []
    for tok in text.split():
        try:
            out.append(abs(float(tok)))
        except ValueError:
            pass
    return [x for x in out if np.isfinite(x)]


def same_output(got: str, want: str) -> None:
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w), (got, want)
    scale = max(_floats(want), default=0.0)
    atol = 1e-9 * max(scale, 1.0)
    for a, b in zip(g, w):
        if a == b:
            continue
        ma, mb = IMPORT_LINE.match(a), IMPORT_LINE.match(b)
        if ma and mb:
            assert ma.group(1) == mb.group(1), (a, b)
            continue
        if VERSION_LINE.match(a) and VERSION_LINE.match(b):
            continue
        ta, tb = a.split(), b.split()
        assert len(ta) == len(tb), (a, b)
        for x, y in zip(ta, tb):
            if x == y:
                continue
            fx, fy = float(x), float(y)
            assert abs(fx - fy) <= atol + 1e-9 * abs(fy), (a, b)


@pytest.fixture
def sides(tmp_path, capsys):
    return Sides(tmp_path, capsys)


def dd(*rest):
    return ["--datadir", "<D>/tsdb-data", "--auto-metric", *rest]


# -- TestImportQueryScan ------------------------------------------------------

def test_import_then_query(sides):
    lines = [f"sys.cpu.user {BASE + i * 10} {i} host=web01"
             for i in range(10)] + ["# a comment"]
    f = sides.write("data.txt", "\n".join(lines) + "\n")
    code, out, _ = sides.run("import", *dd(), f)
    assert code == 0 and "imported 10 data points" in out
    code, out, _ = sides.run("query", *dd(), str(BASE), str(BASE + 200),
                             "sum:sys.cpu.user")
    rows = out.strip().split("\n")
    assert code == 0 and rows[0] == f"sys.cpu.user {BASE} 0 host=web01"
    assert len(rows) == 10


def test_import_gzip(sides):
    f = sides.write("data.txt.gz", f"m {BASE} 1 host=a\n", gz=True)
    code, out, _ = sides.run("import", *dd(), f)
    assert code == 0 and "imported 1" in out


def test_import_bad_lines(sides):
    f = sides.write("bad.txt", f"m {BASE} 1 host=a\nm notatime 2 host=a\n")
    code, _, err = sides.run("import", *dd(), f)
    assert code == 1 and "error" in err


def test_scan_formats(sides):
    f = sides.write("d.txt", f"m {BASE} 7 host=a\n")
    sides.run("import", *dd(), f)
    code, out, _ = sides.run("scan", *dd(), str(BASE - 10), str(BASE + 10),
                             "none:m")
    assert code == 0 and out.strip() == f"m {BASE * 1000} 7 {{host=a}}"
    code, out, _ = sides.run("scan", *dd(), "--import", str(BASE - 10),
                             str(BASE + 10), "none:m")
    assert code == 0 and out.strip() == f"m {BASE} 7 host=a"


# -- TestCliQueryGraph --------------------------------------------------------

def test_graph_writes_png(sides):
    """(ref: CliQuery --graph) Both draw the same chart with the same
    matplotlib: the PNGs are equal byte for byte."""
    pytest.importorskip("matplotlib")
    f = sides.write("g.txt", "\n".join(
        f"gm {BASE + i * 10} {i} host=a" for i in range(10)) + "\n")
    sides.run("import", *dd(), f)
    code, out, _ = sides.run("query", *dd(), "--graph", "<D>/chart.png",
                             str(BASE), str(BASE + 200), "sum:gm")
    assert code == 0 and "wrote" in out
    pngs = [(d / "chart.png").read_bytes() for d in sides.dirs.values()]
    assert pngs[1][:8] == b"\x89PNG\r\n\x1a\n"
    assert pngs[0] == pngs[1]


def test_graph_needs_a_path(sides):
    code, _, err = sides.run("query", *dd(), str(BASE), "sum:gm", "--graph")
    assert code == 2 and "--graph needs a PATH" in err


# -- TestImportEdgeMatrix -----------------------------------------------------

@pytest.mark.parametrize("literal,expected", [
    ("1", 1.0), ("-1", -1.0),
    ("257", 257.0), ("-257", -257.0),
    ("65537", 65537.0), ("-65537", -65537.0),
    ("4294967296", 4294967296.0),
    ("-4294967296", -4294967296.0),
    ("0.0001", 0.0001), ("-0.0001", -0.0001),
    ("4.2e3", 4200.0),
])
def test_good_values(sides, literal, expected):
    f = sides.write("m.txt", f"im.m {BASE} {literal} host=a\n")
    code, out, _ = sides.run("import", *dd(), f)
    assert code == 0 and "imported 1" in out
    _, out, _ = sides.run("query", *dd(), str(BASE - 5), str(BASE + 5),
                          "sum:im.m")
    assert float(out.split()[2]) == pytest.approx(expected, rel=1e-12)


def test_ms_timestamp(sides):
    f = sides.write("m.txt", f"im.ms {BASE * 1000 + 250} 1 host=a\n")
    code, out, _ = sides.run("import", *dd(), f)
    assert code == 0 and "imported 1" in out


def test_max_second_timestamp(sides):
    f = sides.write("m.txt", "im.max 4294967295 1 host=a\n")
    code, out, _ = sides.run("import", *dd(), f)
    assert code == 0 and "imported 1" in out


@pytest.mark.parametrize("line", [
    "im.bad 0 1 host=a",
    "im.bad -100 1 host=a",
    "im.bad notatime 1 host=a",
    f"im.bad {BASE} 1",
    f" {BASE} 1 host=a",
])
def test_bad_lines_error_but_continue(sides, line):
    f = sides.write("m.txt", "\n".join([f"im.good {BASE} 5 host=a", line,
                                        f"im.good {BASE + 10} 6 host=a"])
                    + "\n")
    code, _, err = sides.run("import", *dd(), f)
    assert code == 1 and ":2" in err
    _, out, _ = sides.run("query", *dd(), str(BASE - 5), str(BASE + 15),
                          "sum:im.good")
    assert len(out.strip().split("\n")) == 2


def test_nsu_without_autocreate(sides):
    f = sides.write("n.txt", f"never.seen {BASE} 1 host=a\n")
    code, _, err = sides.run("import", "--tsd.storage.data_dir=<D>/d", f)
    assert code == 1 and "never.seen" in err


# -- TestDumpRoundTrip --------------------------------------------------------

def test_dump_import_roundtrip(sides):
    lines = [f"rt.m {BASE + i * 10} {i * 1.5} host=web01" for i in range(5)] \
        + [f"rt.m {BASE + i * 10} {i * 7} host=web02" for i in range(5)]
    f = sides.write("seed.txt", "\n".join(lines) + "\n")
    assert sides.run("import", *dd(), f)[0] == 0
    code, dump, _ = sides.run("scan", *dd(), "--import", str(BASE - 10),
                              str(BASE + 100), "none:rt.m")
    assert code == 0
    f2 = sides.write("redump.txt", dump)
    code, _, _ = sides.run("import", "--tsd.storage.data_dir=<D>/d2",
                           "--tsd.core.auto_create_metrics=true", f2)
    assert code == 0
    code, dump2, _ = sides.run("scan", "--tsd.storage.data_dir=<D>/d2",
                               "--import", str(BASE - 10), str(BASE + 100),
                               "none:rt.m")
    assert code == 0
    assert sorted(dump.strip().split("\n")) == \
        sorted(dump2.strip().split("\n"))


# -- TestUidTool --------------------------------------------------------------

def test_assign_grep_rename_delete(sides):
    code, out, _ = sides.run("uid", *dd(), "assign", "metrics", "sys.cpu",
                             "sys.mem")
    assert code == 0 and "sys.cpu metrics" in out
    code, out, _ = sides.run("uid", *dd(), "grep", "sys")
    assert "sys.cpu" in out and "sys.mem" in out
    assert sides.run("uid", *dd(), "rename", "metrics", "sys.cpu",
                     "sys.cpu2")[0] == 0
    code, out, _ = sides.run("uid", *dd(), "grep", "cpu2")
    assert "sys.cpu2" in out
    assert sides.run("uid", *dd(), "delete", "metrics", "sys.mem")[0] == 0
    code, out, _ = sides.run("uid", *dd(), "grep", "metrics", "^sys")
    assert out == "metrics sys.cpu2: 000001\n"
    # an assigned name fails on its own line; the rest go on
    code, out, err = sides.run("uid", *dd(), "assign", "metrics",
                               "sys.cpu2", "sys.disk")
    assert code == 0 and "sys.disk metrics" in out and "sys.cpu2" in err


def test_uid_usage_and_unknown_subcommands(sides):
    for args in (["uid", *dd()], ["uid", *dd(), "assign", "metrics"],
                 ["uid", *dd(), "grep"], ["uid", *dd(), "rename", "x"],
                 ["uid", *dd(), "delete"], ["uid", *dd(), "bogus"]):
        assert sides.run(*args)[0] == 2


def test_mkmetric(sides):
    code, out, _ = sides.run("mkmetric", *dd(), "my.metric")
    assert code == 0 and "my.metric" in out


def test_uid_fsck_clean(sides):
    sides.run("mkmetric", *dd(), "m")
    code, out, _ = sides.run("uid", *dd(), "fsck")
    assert code == 0 and "0 errors" in out


def test_uid_metasync_and_metapurge(sides):
    f = sides.write("d.txt", f"m {BASE} 1 host=a\nm {BASE} 2 host=b\n")
    sides.run("import", *dd(), f)
    code, out, _ = sides.run("uid", *dd(), "metasync")
    assert code == 0 and "synced meta for 2 timeseries" in out
    code, out, _ = sides.run("uid", *dd(), "metapurge")
    assert code == 0 and out.startswith("purged ")


# -- tsdb fsck ----------------------------------------------------------------

def test_fsck_command(sides):
    f = sides.write("d.txt", "\n".join(
        f"f.m {BASE + 30 * i} {i} host=h{i % 3}" for i in range(30)) + "\n")
    sides.run("import", *dd(), f)
    for extra in ((), ("--fix",), ("--fix-all",)):
        code, out, _ = sides.run("fsck", *dd(), *extra)
        assert code == 0 and "Total errors: 0" in out


# -- TestSearchAndVersionCli --------------------------------------------------

def test_search_lookup(sides):
    f = sides.write("d.txt", f"m {BASE} 1 host=a\nm {BASE} 2 host=b\n")
    sides.run("import", *dd(), f)
    code, out, _ = sides.run("search", *dd(), "lookup", "m")
    assert code == 0 and "2 results" in out
    _, out, _ = sides.run("search", *dd(), "lookup", "m", "host=a")
    assert "1 results" in out
    _, out, _ = sides.run("search", *dd(), "lookup", "--use_meta", "m")
    assert out.endswith("results\n")
    assert sides.run("search", *dd(), "nope")[0] == 2


def test_treesync(sides):
    f = sides.write("d.txt", f"m {BASE} 1 host=a\n")
    sides.run("import", *dd(), f)
    code, out, _ = sides.run("treesync", *dd())
    assert code == 0 and out.startswith("Processed ")


def test_version(sides):
    code, out, _ = sides.run("version")
    assert code == 0 and VERSION_LINE.match(out.strip())
    assert out.startswith("opentsdb_tpu_torch version [")


def test_unknown_command(sides):
    code, _, err = sides.run("bogus")
    assert code == 2 and "unknown command" in err


@pytest.mark.parametrize("argv", [[], ["-h"], ["--help"], ["help"]])
def test_usage(sides, argv):
    code, _, err = sides.run(*argv)
    assert code == 2 and "Valid commands" in err


@pytest.mark.parametrize("command", ["query", "scan", "import", "rollup"])
def test_command_usage_exit_code(sides, command):
    code, _, err = sides.run(command, *dd())
    assert code == 2 and err.startswith(f"usage: tsdb {command}")


# -- --config FILE against --tsd.* overrides ----------------------------------

def test_config_file_and_overrides(sides):
    """A properties file sets the data_dir and auto-create (``=`` and
    ``:`` separators, ``#``/``!`` comments); a ``--tsd.*`` flag after
    it wins over the file's value."""
    conf = sides.write("tsdb.conf", "\n".join([
        "# the data", "! more comment",
        "tsd.storage.data_dir = <D>/from-file",
        "tsd.core.auto_create_metrics: true", ""]))
    for d in sides.dirs.values():
        (d / "tsdb.conf").write_text(
            (d / "tsdb.conf").read_text().replace("<D>", str(d)))
    f = sides.write("d.txt", f"cf.m {BASE} 3 host=a\n")
    g = sides.write("e.txt", f"cf.m {BASE} 4 host=a\n")
    assert sides.run("import", f"--config={conf}", f)[0] == 0
    assert sides.run("import", f"--config={conf}",
                     "--tsd.storage.data_dir=<D>/elsewhere", g)[0] == 0
    _, out, _ = sides.run("query", "--config", conf, str(BASE - 5),
                          str(BASE + 5), "sum:cf.m")
    assert out == f"cf.m {BASE} 3 host=a\n"
    _, out, _ = sides.run("query", f"--config={conf}",
                          "--tsd.storage.data_dir", "<D>/elsewhere",
                          str(BASE - 5), str(BASE + 5), "sum:cf.m")
    assert out == f"cf.m {BASE} 4 host=a\n"


def test_config_location():
    from opentsdb_tpu.utils.config import Config as JConfig
    from opentsdb_tpu_torch.utils.config import Config
    assert Config().config_location is None
    assert JConfig().config_location is None


# -- TestCleanCacheCli --------------------------------------------------------

def test_cleancache_removes_cache_dir(sides):
    for d in sides.dirs.values():
        (d / "qcache").mkdir()
        (d / "qcache" / "a.png").write_bytes(b"x")
        (d / "qcache" / "b.json").write_bytes(b"y")
    code, out, _ = sides.run("cleancache", "--tsd.http.cachedir=<D>/qcache")
    assert code == 0 and "removed 2" in out
    assert not any((d / "qcache").exists() for d in sides.dirs.values())


def test_cleancache_missing_dir_ok(sides):
    code, out, _ = sides.run("cleancache", "--tsd.http.cachedir=<D>/nothere")
    assert code == 0 and "no cache" in out


# -- Queue 3 item 29: an import into the memory store -------------------------

def test_import_on_the_memory_store_raises_where_the_reference_imports(
        sides):
    """The reference parses import lines in Python when its store is the
    memory one; the port's ``import_buffer`` parses with the native
    store's library only, so ``tsdb import`` on the memory store raises
    RuntimeError naming the key, and imports nothing."""
    f = sides.write("d.txt", f"mm.m {BASE} 1 host=a\n")
    args = ["import", *dd("--tsd.storage.backend=memory"), f]
    jd = str(sides.dirs["jax"])
    assert jcli.main([a.replace("<D>", jd) for a in args]) == 0
    assert "imported 1" in sides.capsys.readouterr().out
    td = str(sides.dirs["port"])
    with pytest.raises(RuntimeError, match="tsd.storage.backend=native"):
        tcli.main([a.replace("<D>", td) for a in args] + list(CPU))
