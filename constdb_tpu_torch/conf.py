"""The port's environment knobs and engine factory.

Every knob the port reads is named CONSTDB_TORCH_* and listed in
ENV_REGISTRY (the reference package's registry is its own).
`build_engine(kind)` is the twin of the reference's conf.build_engine,
without its fallbacks: asking for the CUDA engine on a host without a
usable card raises.
"""

from __future__ import annotations

import os

ENV_REGISTRY = {
    "CONSTDB_TORCH_PIPELINE": "0 = stage the merge families serially on "
                              "the main thread (default: staging pool)",
    "CONSTDB_TORCH_STAGE_WORKERS": "staging pool size (default: spare "
                                   "cores, at most 4)",
    "CONSTDB_TORCH_POOL_FLUSH_MB": "resident win-pool bytes that trigger "
                                   "an automatic flush (default 1536)",
    "CONSTDB_TORCH_RESIDENT": "steady-state micro path: auto (default: on "
                              "for a CUDA device, off for the CPU) | 1 | 0",
    "CONSTDB_TORCH_RESIDENT_WARMUP": "stable micro rounds a cold plane "
                                     "waits before it is mirrored on the "
                                     "device (default 2)",
    "CONSTDB_TORCH_TENSOR_POOL_MB": "resident tensor payload bytes above "
                                    "which the pools flush and drop "
                                    "(default 512)",
    "CONSTDB_TORCH_SHARDS": "hash shards of a ShardedKeySpace (default: "
                            "1 on <= 2 cores, else the core count, at "
                            "most 64)",
    # the node's data plane (twins of the reference's knobs, same defaults)
    "CONSTDB_TORCH_APPLY_BATCH": "replication coalescer: max frames per "
                                 "landed micro-batch; 1 = the exact "
                                 "per-frame path (default 512)",
    "CONSTDB_TORCH_APPLY_LATENCY_MS": "replication coalescer: max latency "
                                      "of a pending frame before a flush "
                                      "(default 5.0)",
    "CONSTDB_TORCH_PROTO_MAX_BULK": "largest RESP bulk length the parser "
                                    "accepts (default and ceiling 512 MiB)",
    "CONSTDB_TORCH_UNDO_WINDOW": "locally originated counter ops CNTUNDO "
                                 "can invert (default 4096)",
    "CONSTDB_TORCH_TENSOR_STRATEGY": "strategy of a tensor key created "
                                     "without one (default lww)",
    "CONSTDB_TORCH_TENSOR_MAX_ELEMS": "largest tensor a TSET may carry "
                                      "(default 4194304)",
    "CONSTDB_TORCH_MAXMEMORY": "used-memory hard watermark in bytes; 0 = "
                               "unbounded (default 0)",
    "CONSTDB_TORCH_MAXMEMORY_SOFT_PCT": "soft watermark, percent of "
                                        "MAXMEMORY, past which client "
                                        "writes are shed (default 85.0)",
}


def _env_read(name: str):
    if name not in ENV_REGISTRY:
        raise KeyError(f"unregistered environment knob {name}")
    return os.environ.get(name)


def env_int(name: str, default: int) -> int:
    v = _env_read(name)
    return default if v is None or v == "" else int(v)


def env_float(name: str, default: float) -> float:
    v = _env_read(name)
    return default if v is None or v == "" else float(v)


def env_str(name: str, default: str) -> str:
    v = _env_read(name)
    return default if v is None or v == "" else v


def env_flag(name: str, default: bool) -> bool:
    """'0' (and only '0') is false when the variable is set."""
    v = _env_read(name)
    return default if v is None or v == "" else v != "0"


def build_engine(kind: str, device=None):
    """"cuda": the resident TorchMergeEngine on the card (raises without
    one; `device` may name "cpu" to run its plain versions on the host).
    "cpu": the CPU reference engine."""
    if kind == "cuda":
        from .engine.cuda import TorchMergeEngine
        return TorchMergeEngine(resident=True, device=device)
    if kind == "cpu":
        from .engine.cpu import CpuMergeEngine
        return CpuMergeEngine()
    raise ValueError(f"unknown engine kind {kind!r} (cuda | cpu)")
