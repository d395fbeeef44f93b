"""Build and load the port's CUDA kernels.

``csrc/fused_pipeline.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``opentsdb_tpu_torch/_build/`` (listed in ``.gitignore``), named
by a hash of the source and flags so an edited source rebuilds, and
loaded with ctypes. Importing this module needs no toolchain; only
:func:`library` does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_pipeline.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# argument types of every exported function (pointers and the stream
# as c_void_p: a bare Python int would be passed as a 32-bit int)
_SIGNATURES = {
    "fused_span_reduce": (
        _P, _L, _I, _I, _I, _P, _P, _I, _P, _I, _P, _F, _F, _I, _I, _I,
        _P, _P, _P),
    "fused_onehot_reduce": (
        _P, _L, _I, _I, _I, _P, _I, _P, _F, _F, _I, _I, _I, _I, _I, _P,
        _P, _P),
    "fused_onehot_slices": (_L, _I, _I, _I),
    "fused_onehot_tile": (),
}


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``$PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME)")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"fused_pipeline_{digest[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source's library exists; returns
    its path. The library is written under a temporary name and renamed,
    so concurrent builders never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
             str(SOURCE)], capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(proc.stderr)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.fused_error_string.argtypes = [ctypes.c_int]
    lib.fused_error_string.restype = ctypes.c_char_p
    return lib
