"""Build and load the port's native store library.

``csrc/tsdbstore.cc`` is host C++ with a plain C interface. At first
use it is compiled with ``g++`` (``$CXX`` when set) into a shared
library under ``opentsdb_tpu_torch/_build/`` (listed in
``.gitignore``) and loaded with ctypes. The flags are the JAX
package's, so float results can be compared with its library bit for
bit on one host. ``-march=native`` ties the library to the host's CPU:
the file is named by a hash of the source, the flags, the compiler's
version and the CPU's model and feature flags, so a library built on
another machine is never loaded. Importing this module needs no
compiler; only :func:`library` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tsdbstore.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")


class NativeBuildError(RuntimeError):
    """The native store library could not be built or loaded."""


_P, _I, _L, _D, _S = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_double, ctypes.c_char_p)
# (restype, argtypes) of every exported function; pointers are c_void_p
_SIGNATURES = {
    "tss_create": (_P, ()),
    "tss_destroy": (None, (_P,)),
    "tss_add_series": (_L, (_P,)),
    "tss_add_series_n": (_L, (_P, _L)),
    "tss_series_count": (_L, (_P,)),
    "tss_append": (_I, (_P, _L, _L, _D, _I)),
    "tss_append_many": (_I, (_P, _L, _L, _P, _P, _P)),
    "tss_points_written": (_L, (_P,)),
    "tss_repair_series": (_L, (_P, _L, _L, _L, _I)),
    "tss_patch_value": (_I, (_P, _L, _L, _D, _I)),
    "tss_append_grid": (_L, (_P, _P, _L, _P, _L, _P, _P, _I)),
    "tss_series_length": (_L, (_P, _L)),
    "tss_delete_range": (_L, (_P, _L, _L, _L)),
    "tss_read_series": (_L, (_P, _L, _L, _P, _P, _P)),
    "tss_count_range": (_I, (_P, _P, _L, _L, _L, _P, _I)),
    "tss_fill_range": (_I, (_P, _P, _L, _L, _L, _P, _P, _P, _P, _P, _I)),
    "tss_bucket_reduce": (_I, (_P, _P, _L, _L, _L, _L, _L, _L, _P, _P, _P,
                               _P, _I)),
    "tss_fmt_fast": (_L, ()),
    "tss_format_dps": (_L, (_P, _P, _L, _I, _I, _S, _L)),
    "tss_count_lines": (_L, (_S, _L)),
    "tss_append_lines": (_L, (_P, _P, _L, _P, _P, _P)),
    "tss_parse_import": (_L, (_S, _L, _P, _P, _P, _P, _P, _P, _P, _L, _P,
                              _I)),
}


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def _compiler_version() -> str:
    try:
        proc = subprocess.run([compiler(), "--version"],
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(
            f"cannot run the C++ compiler {compiler()!r}: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(
            f"{compiler()} --version failed ({proc.returncode}):\n"
            f"{proc.stderr}")
    return proc.stdout


def _cpu_model() -> str:
    """The host CPU as ``-march=native`` sees it: the first processor's
    entry of ``/proc/cpuinfo`` (model, family, stepping, feature flags),
    without the lines that change while it runs (clock, bogomips)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        text = ""
    first = text.strip().split("\n\n", 1)[0]
    return "\n".join(
        [os.uname().machine] + [
            line for line in first.splitlines()
            if not line.lower().startswith(("cpu mhz", "bogomips"))])


def library_path() -> Path:
    """Where this source, these flags, this compiler and this CPU's
    library lives; runs ``$CXX --version``."""
    digest = hashlib.sha256(b"\0".join((
        SOURCE.read_bytes(), " ".join(CXX_FLAGS).encode(),
        _compiler_version().encode(), _cpu_model().encode()))).hexdigest()
    return BUILD_DIR / f"tsdbstore_{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. It is
    written under a temporary name and renamed, so processes that build
    at once never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                [compiler(), *CXX_FLAGS, str(SOURCE), "-o", tmp],
                capture_output=True, text=True, timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(
                f"cannot run the C++ compiler {compiler()!r}: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"{compiler()} failed ({proc.returncode}) building "
                f"{SOURCE.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


# the process's loaded library; stores are made and read from several
# threads, and the first two to arrive must not both build or load it
_LIBRARY: ctypes.CDLL | None = None
_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded native store library, built on first call. A foreign
    call through it releases the interpreter lock."""
    global _LIBRARY
    with _LIBRARY_LOCK:
        if _LIBRARY is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise NativeBuildError(f"cannot load {path}: {e}") from e
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _LIBRARY = lib
        return _LIBRARY
