"""A small copy of the benchmark (BENCHMARK.json, its data files and
metric readers) in a temporary directory, at sizes a test run holds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from portbench import harness

REPO = Path(__file__).resolve().parents[2]
SMALL = {"mixed": {"n_keys": 3000, "chunk_keys": 700},
         "hash": {"n_keys": 400, "chunk_keys": 300}}
SMALL_STREAM = {"frames_per_peer": 12000, "slice_bytes": 16384,
                "warmup_slices": 2}


def small_root(tmp: Path) -> Path:
    """The benchmark's files under `tmp`, the configurations and the
    stream's stock cut to test size."""
    root = tmp / "bench"
    (root / "portbench").mkdir(parents=True)
    for d in ("metrics", "traffic", "configs"):
        shutil.copytree(REPO / "portbench" / d, root / "portbench" / d)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        p = root / c["file"]
        cfg = json.loads(p.read_text())
        cfg.update(SMALL[cfg["shape"]])
        p.write_text(json.dumps(cfg))
    p = root / "portbench" / "traffic" / "stream.json"
    t = json.loads(p.read_text())
    t.update(SMALL_STREAM)
    p.write_text(json.dumps(t))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def cells() -> list:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def run_cpu(root: Path, workload: str, seed: int = 5, trace: bool = False,
            seconds: float = 0.5) -> dict:
    return harness.run_cell(root, workload, seed, seconds, trace,
                            torch.device("cpu"), log=lambda _m: None)
