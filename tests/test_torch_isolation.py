"""The port stands alone: no file of ``opentsdb_tpu_torch`` nor
``chip_smoke.py`` imports ``jax`` or the JAX package, the package
imports with both made unimportable, its entry points (``TSDB`` and
the TSD command line) refuse to fall back to the CPU when a card is
asked for and absent, and the kernel
build module imports without a CUDA toolchain."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "opentsdb_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "opentsdb_tpu")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run(code: str, env=None, cwd=ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_package_imports_without_jax():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PKG.rglob("*.py"))
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'opentsdb_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.')\n"
            "               for k, v in sys.modules.items() if v)\n"
            "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda():
    from opentsdb_tpu_torch import TSDB, Config
    if torch.cuda.is_available():
        assert TSDB().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSDB()
        with pytest.raises(RuntimeError):
            TSDB(Config(**{"tsd.torch.device": "cuda"}))
    assert TSDB(Config(**{"tsd.torch.device": "cpu"})).device.type == "cpu"
    with pytest.raises(ValueError):
        TSDB(Config(**{"tsd.torch.device": "cpu",
                       "tsd.torch.dtype": "float16"}))


@pytest.mark.parametrize("role", ["shard", "router"])
def test_cluster_roles_follow_the_device_key(role):
    """A shard and a router TSD take ``tsd.torch.device`` as any TSD:
    the card by default (refused without one), the CPU when asked."""
    from opentsdb_tpu_torch import TSDB, Config
    keys = {"tsd.cluster.role": role,
            "tsd.cluster.peers": "s0=127.0.0.1:1"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSDB(Config(**keys))
    t = TSDB(Config(**keys, **{"tsd.torch.device": "cpu"}))
    assert t.device.type == "cpu"
    assert (t.cluster is not None) == (role == "router")
    t.shutdown()


def test_tsd_refuses_cuda_without_a_card():
    """The TSD entry point asked for the card (its default, and
    explicitly) on a machine without one exits non-zero with the device
    error, before it listens: it never serves on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs none")
    for extra in ([], ["--tsd.torch.device=cuda"]):
        out = subprocess.run(
            [sys.executable, "-m", "opentsdb_tpu_torch.tools.cli", "tsd",
             "--tsd.network.port=0", "--tsd.network.bind=127.0.0.1",
             *extra], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        assert out.returncode != 0
        assert "no CUDA device is available" in out.stderr
        assert "TSD listening" not in out.stdout


def test_cuda_build_imports_without_nvcc(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)   # no nvcc anywhere on it
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from opentsdb_tpu_torch.ops import _cuda_build\n"
            "import os\n"
            "if not os.path.isfile('/usr/local/cuda/bin/nvcc'):\n"
            "    try:\n"
            "        _cuda_build.find_nvcc()\n"
            "    except RuntimeError as e:\n"
            "        assert 'nvcc not found' in str(e)\n"
            "    else:\n"
            "        raise AssertionError('found an nvcc')\n"
            "assert _cuda_build.library_path().suffix == '.so'\n"
            "print('ok')\n") % str(ROOT)
    out = _run(code, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors: anything
    else that is not CUDA is refused."""
    from opentsdb_tpu_torch.ops import fused
    from opentsdb_tpu_torch.ops.pipeline import PipelineSpec
    spec = PipelineSpec(num_series=2, num_buckets=2, num_groups=1,
                        ds_function="sum", agg_name="sum")
    meta = torch.empty((2, 4), device="meta")
    gids = torch.zeros(2, dtype=torch.int32, device="meta")
    inv = torch.empty(2, device="meta")
    with pytest.raises(ValueError):
        fused.onehot_reduce(meta, None, gids, gids, inv, spec, 2, 1.0,
                            0.0)


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """No card: non-zero exit and no result line. A directory holding
    chip_smoke.py alone: the same."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal paths need none")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
