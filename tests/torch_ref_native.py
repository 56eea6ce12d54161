"""The reference package's native extension, compiled from its own
sources (native/pyext.cpp) into a temporary directory, for the port's
differential tests: the reference's native parser, encoder, intake
scanner and wire packers against the port's copies.  The reference
loads a prebuilt module only; the tests build one so both sides run
their native code."""

import importlib.util
import shutil
import subprocess
import sysconfig
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def build_reference_ext(out_dir: Path):
    """g++ native/pyext.cpp -> out_dir/cst_ext_ref.so, loaded."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.fail("g++ not found: the reference extension cannot be built")
    out = out_dir / "cst_ext_ref.so"
    inc = sysconfig.get_paths()["include"]
    subprocess.run([cxx, "-O1", "-fPIC", "-std=c++17", "-shared",
                    f"-I{inc}", str(ROOT / "native" / "pyext.cpp"), "-o",
                    str(out)], check=True, capture_output=True)
    spec = importlib.util.spec_from_file_location("cst_ext", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
