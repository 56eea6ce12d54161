"""The port's native C++ helpers: built with g++ at first use, then loaded.

One artifact comes from the sources in constdb_tpu_torch/native/:
cst_ext.so, the CPython extension compiled from pyext.cpp, which includes
tables.cpp (the staging tables utils/tables.py binds) and crc64.cpp (the
CRC utils/checksum.py calls).

It is built with the reference Makefile's flags into
`constdb_tpu_torch/_build/<hash>/` (utils/build.py: one g++, under the
directory's file lock, moved into place with os.replace), where the hash
covers every file of the sources' directory, the flags, the compiler and
its version, and the Python headers; the full hash is compiled in as
CST_ABI_STAMP and checked when the module loads.  A failed build or a
failed load raises: nothing falls back to the pure-Python tables.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

from .build import build_artifacts

SRC = Path(__file__).resolve().parent.parent / "native"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
EXT_SOURCE = "pyext.cpp"
EXT_NAME = "cst_ext.so"


@dataclass
class Native:
    ext: ModuleType       # the cst_ext extension module
    path: Path            # the build directory


_lock = threading.Lock()
_loaded: dict = {}


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH; the port's native tables "
                           "and crc64 cannot be built")
    return path


def _py_include() -> str:
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"Python.h not found under {inc}; the port's "
                           "CPython extension cannot be built")
    return inc


def stamp_of(src: Path = SRC) -> str:
    """sha256 over the compiler, its version and target, the flags, the
    Python headers' path and extension suffix, and every file of `src`
    (sorted by name)."""
    cxx = _cxx()
    version = subprocess.run([cxx, "-dumpfullversion", "-dumpmachine"],
                             capture_output=True, text=True, check=True)
    h = hashlib.sha256()
    for part in (cxx, version.stdout, *CXXFLAGS, _py_include(),
                 sysconfig.get_config_var("EXT_SUFFIX") or ""):
        h.update(part.encode() + b"\0")
    for p in sorted(src.iterdir()):
        if p.is_file():
            h.update(p.name.encode() + b"\0")
            h.update(p.read_bytes())
    return h.hexdigest()


def commands(src: Path, stamp: str) -> dict:
    """artifact name -> the g++ command line that builds it (without its
    output: utils/build.py appends a temporary one)."""
    return {EXT_NAME: [_cxx(), *CXXFLAGS, "-Wno-unused-parameter",
                       f'-DCST_ABI_STAMP="{stamp}"', f"-I{_py_include()}",
                       "-shared", str(src / EXT_SOURCE)]}


def build(src: Path = SRC, root: Path = BUILD_ROOT) -> tuple[Path, str]:
    """Compile the extension unless its build directory holds it.
    -> (build directory, stamp).  Raises RuntimeError on a failed build."""
    stamp = stamp_of(src)
    out_dir = root / stamp[:16]
    build_artifacts(out_dir, commands(src, stamp), "native build")
    return out_dir, stamp


def load(src: Path = SRC, root: Path = BUILD_ROOT) -> Native:
    """Build if needed, then load the extension and check that it was
    built from these sources (its compiled-in stamp)."""
    key = (str(src), str(root))
    with _lock:
        got = _loaded.get(key)
        if got is not None:
            return got
        out_dir, stamp = build(src, root)
        spec = importlib.util.spec_from_file_location(
            "cst_ext", out_dir / EXT_NAME)
        ext = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ext)
        seen = ext.abi_stamp()
        if seen != stamp:
            raise RuntimeError(f"{out_dir / EXT_NAME} carries build stamp "
                               f"{seen[:16]!r}, the sources {stamp[:16]!r}")
        got = _loaded[key] = Native(ext, out_dir)
        return got
