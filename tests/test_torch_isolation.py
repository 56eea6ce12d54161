"""The port stands alone: importing constdb_tpu_torch (every module under
it) pulls in neither jax nor constdb_tpu, chip_smoke.py imports neither,
its C++ sources include nothing outside constdb_tpu_torch/native/ and
their build reads no file of the repository outside the port, and an
entry point whose device defaults to CUDA raises when there is no card
instead of moving to the CPU."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "constdb_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "constdb_tpu")

_PROBE = """
import importlib, json, pkgutil, sys
import constdb_tpu_torch
names = [m.name for m in pkgutil.walk_packages(constdb_tpu_torch.__path__,
                                                "constdb_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "constdb_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _forbidden(mod: str) -> bool:
    return mod.split(".")[0] in FORBIDDEN


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


def test_importing_the_port_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "constdb_tpu_torch.engine.cuda" in res["modules"]
    assert "constdb_tpu_torch.ops.kernels" in res["modules"]
    assert res["bad"] == []


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert bad == [], f"{path} imports {bad}"


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    from constdb_tpu_torch.conf import build_engine
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine
    from constdb_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchMergeEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_native_sources_include_only_their_own_directory():
    from constdb_tpu_torch.utils import native

    srcs = sorted(native.SRC.glob("*.cpp"))
    assert native.SRC == PORT / "native" and srcs
    for path in srcs:
        for inc in re.findall(r'#\s*include\s*"([^"]+)"', path.read_text()):
            assert (native.SRC / inc).is_file() and "/" not in inc, \
                f"{path.name} includes {inc}"


def test_native_build_reads_nothing_outside_the_port():
    from constdb_tpu_torch.utils import native

    assert PORT in native.BUILD_ROOT.parents
    cmds = native.commands(native.SRC, "0" * 64)
    assert set(cmds) == {native.EXT_NAME}
    for cmd in cmds.values():
        assert "-o" not in cmd   # utils/build.py names the output
        inputs = [a for a in cmd[1:] if a.endswith(".cpp")]
        assert inputs and all(Path(a).parent == PORT / "native"
                              for a in inputs)
        incs = [a[2:] for a in cmd if a.startswith("-I")]
        assert all(ROOT not in Path(i).parents for i in incs)
        for a in cmd[1:]:
            p = Path(a.split("=", 1)[-1])
            if p.is_absolute() and ROOT in p.parents:
                assert PORT in p.parents, f"build reads {a}"
