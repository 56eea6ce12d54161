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
    for name in ("cluster.slots", "cluster.migrate", "cluster.commands",
                 "client.near_cache", "chaos", "chaos.plane",
                 "chaos.cluster", "chaos.oracle", "chaos.scenario",
                 "chaos.resource", "chaos.cluster_cells",
                 "chaos.tracking_cells", "chaos.__main__"):
        assert f"constdb_tpu_torch.{name}" in res["modules"]
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
    # the multi-device entry points: the partitioned engine, its device
    # list, the rep x kv world and the entry twins
    from constdb_tpu_torch.entry import dryrun_multichip, entry
    from constdb_tpu_torch.parallel.sharded import (engine_mesh, init_world,
                                                    run_world)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchMergeEngine(devices=["cuda", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_world(0, 1, "tcp://127.0.0.1:1")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_world(1, dict)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)
    assert engine_mesh(2, device="cpu") == [torch.device("cpu")] * 2


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


def test_node_raises_without_a_card(monkeypatch):
    from constdb_tpu_torch.server.node import Node

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Node()
    assert Node(device="cpu").engine.device.type == "cpu"


def _port_copy_lines(text: str) -> tuple[list, int]:
    """A port copy's lines without its header note (the paragraph that
    starts "The port's own copy") and without its marked "port change"
    blocks, and the number of those blocks."""
    out, blocks, skip = [], 0, False
    for ln in text.splitlines():
        if "port's own copy" in ln:
            skip = True
        elif ln.strip() == "// port change: uint64 integers":
            skip, blocks = True, blocks + 1
        elif ln.strip() == "// end of port change" or \
                (skip and ln == "//"):
            skip = False
        elif not skip and ln != "//":
            out.append(ln)
    return out, blocks


def test_native_copies_and_their_entry_points():
    """The scanners (the RESP parser, the intake scanner, the wire blob
    columns and the op log's segment scanner) are the port's own copies
    of the reference's sources, included by its pyext.cpp and exported
    by its one extension.  The one change: resp.cpp's `:` integer branch
    parses a 64-bit magnitude (an HLC uuid has 19 digits, past int_line's
    18), in two marked blocks that replace the reference branch's
    scan-and-build lines; aof.cpp, unchanged, parses through it."""
    from constdb_tpu_torch.utils import native

    text = (native.SRC / "pyext.cpp").read_text()
    for name in ("resp", "intake", "wire", "aof"):
        assert f'#include "{name}.cpp"' in text
        ref = [ln for ln in (ROOT / "native" / f"{name}.cpp").read_text()
               .splitlines() if ln != "//"]
        port, blocks = _port_copy_lines(
            (native.SRC / f"{name}.cpp").read_text())
        if name == "resp":
            i = ref.index("    if (t == ':') {")
            j = ref.index("        if (!obj) return -2;", i)
            assert j - i == 6
            ref = ref[:i + 1] + ref[j:]
            assert blocks == 2
        else:
            assert blocks == 0
        assert port == ref
    ext = native.load().ext
    for fn in ("resp_parse", "resp_encode", "intake_scan",
               "wire_pack_blobs", "wire_unpack_blobs", "aof_scan"):
        assert callable(getattr(ext, fn))


def test_scanners_have_no_pure_fallback(monkeypatch, tmp_path):
    """An extension without the scanners' entry points raises: neither
    make_parser, the wire packers nor the op log's segment walk take the
    pure path for it."""
    from constdb_tpu_torch.persist import oplog
    from constdb_tpu_torch.replica import wire
    from constdb_tpu_torch.resp import codec

    class NoScanners:
        pass

    monkeypatch.setattr(codec, "_EXT_CACHE", [NoScanners()])
    parser = codec.make_parser()
    assert type(parser) is codec.NativeRespParser
    parser.feed(b"*1\r\n$4\r\nping\r\n")
    with pytest.raises(AttributeError):
        parser.next_msg()
    with pytest.raises(AttributeError):
        codec.encode_msg(codec.Bulk(b"x"))
    seg = tmp_path / "seg.log"
    seg.write_bytes(oplog.MAGIC)
    with pytest.raises(AttributeError):
        oplog.scan_segment(str(seg))
    monkeypatch.setattr(wire, "_WIRE_NATIVE_CACHE", [])
    monkeypatch.setattr("constdb_tpu_torch.utils.native.load",
                        lambda: type("N", (), {"ext": NoScanners()})())
    with pytest.raises(AttributeError):
        wire._pack_blobs(bytearray(), [b"a"])
