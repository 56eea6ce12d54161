#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (constdb_tpu_torch) on one GPU.

    python3 chip_smoke.py [--keys N] [--replicas R] [--seed S]

Phases, one line each; any failure raises and exits non-zero:
  1. device    torch.cuda.is_available() (else exit 2), the card's name and
               power limit from nvidia-smi;
  2. build     nvcc builds every kernel from constdb_tpu_torch/csrc;
  3. kernels   each kernel against its plain PyTorch version on the card,
               bit-equal, at the catch-up path's shapes, with CUDA-event
               median times of the kernel, the plain version and (where
               one exists) a single PyTorch library call;
  4. catch-up (auto)         make_workload(N keys, R replicas) in
               131072-key chunks, groups of 4R, resident TorchMergeEngine
               with dense_fold="auto", then flush; verified against the
               port's CpuMergeEngine oracle on a ~100k-key subsample; K4
               must launch;
  5. catch-up (device fold)  the aligned-counter shape, groups of R,
               dense_fold="cuda"; verified the same way; K1 and K2 must
               launch.
Then one JSON line of kernel records, the nvidia-smi line, and the last
line {"ok": true, "device": {...}}.

Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate (data sheet)
# no int64 rate in the data sheet's table: integer compares and adds are
# counted against the closest non-tensor peak, 67 TFLOP/s (FP32)
ALU_OPS_PER_S = 67e12
NEUTRAL_T = -(1 << 62)
CHUNK_KEYS = 131072
SPIN_CYCLES = 200_000        # ~0.1 ms at the H100's 1.98 GHz SM clock


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fns: dict, reps: int = 200, warmup_s: float = 1.0,
            flush=None) -> dict:
    """Median milliseconds of each fn() in `fns`, CUDA-event timed.  The
    fns first run untimed for `warmup_s` seconds (the clocks of an idle
    card ramp up), then are timed in turns within every round, so a clock
    or neighbour drift affects all of them alike.  Before each launch
    `flush` (untimed) runs, then a ~0.1 ms spin on the stream, so the
    host's enqueue work (the wrapper's checks and allocations) finishes
    while the card is still busy and never shows up between the events."""
    import torch
    t_end = time.perf_counter() + warmup_s
    while time.perf_counter() < t_end:
        for fn in fns.values():
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            if flush is not None:
                flush()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[name].append(a.elapsed_time(b))
    return {name: statistics.median(t) for name, t in times.items()}


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip()


def max_abs_err(kernel: str, got, want) -> int:
    """Exact largest |kernel - plain| over paired int64 outputs (Python
    ints, so no wrap); raises unless it is 0."""
    err = 0
    for a, b in zip(got, want):
        bad = a != b
        if bad.any():
            err = max(err, max(abs(x - y) for x, y in
                               zip(a[bad].tolist(), b[bad].tolist())))
    if err:
        raise AssertionError(f"{kernel} differs from its plain version "
                             f"(max abs err {err})")
    return err


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(dev, seed: int) -> dict:
    """Hold K1, K2, K4 against their plain versions at the catch-up
    shapes; -> {name: record}."""
    import torch

    from constdb_tpu_torch.ops import dense as D
    from constdb_tpu_torch.ops import kernels as KN

    g = torch.Generator(device=dev).manual_seed(seed)
    R, S = 8, 131072
    i64 = torch.int64
    # L2 is 50 MB: rewrite 128 MB between timed reps so every rep reads
    # its inputs from device memory, as the engine's fresh uploads do
    scratch = torch.empty(16 << 20, dtype=i64, device=dev)

    def flush_l2():
        scratch.fill_(1)

    def stack(lo, hi):
        return torch.randint(lo, hi, (R, S), generator=g, dtype=i64,
                             device=dev)

    def with_neutral(x):
        # ~1/8 of the cells absent (NEUTRAL_T), and whole absent columns
        m = torch.rand((R, S), generator=g, device=dev) < 0.125
        x = torch.where(m, torch.full_like(x, NEUTRAL_T), x)
        x[:, :64] = NEUTRAL_T
        return x

    recs = {}
    # K1: small stamp ranges force (t) ties and full (t, node) ties
    at = with_neutral(stack(0, 16))
    an = stack(0, 4)
    dt = stack(0, 16)
    err = max_abs_err("K1 merge_elems", KN.merge_elems(at, an, dt),
                      D.dense_merge_elems(at, an, dt))
    nbytes = 3 * R * S * 8 + 4 * S * 8
    ops = 3 * R * S * 2
    b_ms, b_by = bound_ms(nbytes, ops)
    t = time_ms({"ms": lambda: KN.merge_elems(at, an, dt),
                 "plain_ms": lambda: D.dense_merge_elems(at, an, dt)},
                flush=flush_l2)
    recs["merge_elems"] = {
        **t, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err, "shape": [R, S]}
    # K2: values below NEUTRAL_T among ties (the edge where the
    # reference's XLA twin and its Pallas kernel disagree)
    ts = with_neutral(stack(0, 16))
    vals = stack(-1000, 1000)
    vals[:, 64:128] = NEUTRAL_T - 5 - torch.arange(R, device=dev)[:, None]
    err = max_abs_err("K2 merge_counters", KN.merge_counters(vals, ts),
                      D.dense_merge_counters(vals, ts))
    nbytes = 2 * R * S * 8 + 2 * S * 8
    ops = 2 * R * S * 2
    b_ms, b_by = bound_ms(nbytes, ops)
    t = time_ms({"ms": lambda: KN.merge_counters(vals, ts),
                 "plain_ms": lambda: D.dense_merge_counters(vals, ts)},
                flush=flush_l2)
    recs["merge_counters"] = {
        **t, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err, "shape": [R, S]}
    # K4: 3.2M ids over 1M segments; segment 0 holds int64 extremes whose
    # sum wraps mod 2^64
    n, n_seg = 3_200_000, 1 << 20
    ids = torch.randint(0, n_seg, (n,), generator=g, dtype=torch.int32,
                        device=dev)
    sv = torch.randint(-(1 << 40), 1 << 40, (n,), generator=g, dtype=i64,
                       device=dev)
    ids[:4] = 0
    sv[:4] = torch.tensor([(1 << 63) - 1, (1 << 63) - 1, -(1 << 63), 7],
                          dtype=i64, device=dev)
    err = max_abs_err("K4 segment_sum", [KN.segment_sum(ids, sv, n_seg)],
                      [D.segment_sum(ids, sv, n_seg)])
    ids64 = ids.to(i64)
    out = torch.zeros(n_seg, dtype=i64, device=dev)
    nbytes = n * 4 + n * 8 + n_seg * 8
    b_ms, b_by = bound_ms(nbytes, n)
    t = time_ms({"ms": lambda: KN.segment_sum(ids, sv, n_seg),
                 "plain_ms": lambda: D.segment_sum(ids, sv, n_seg),
                 "library_ms": lambda: out.index_add_(0, ids64, sv)},
                flush=flush_l2)
    recs["segment_sum"] = {
        **t, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
        "shape": [n, n_seg]}
    del scratch
    return recs


def catchup(dev, n_keys: int, n_rep: int, seed: int, group: int,
            fold: str, aligned: bool, label: str) -> dict:
    """One streamed catch-up through TorchMergeEngine, verified against
    the CPU oracle; -> launches and timings."""
    import torch

    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine
    from constdb_tpu_torch.ops import kernels as KN
    from constdb_tpu_torch.store.keyspace import KeySpace

    t0 = time.perf_counter()
    batches = W.make_workload(n_keys, n_rep, seed=seed,
                              aligned_counters=aligned)
    chunks = W.chunk_batches(batches, CHUNK_KEYS)
    t_gen = time.perf_counter() - t0
    eng = TorchMergeEngine(resident=True, dense_fold=fold, device=dev)
    store = KeySpace()
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launches()
    t0 = time.perf_counter()
    for i in range(0, len(chunks), group):
        eng.merge_many(store, chunks[i:i + group])
    eng.flush(store)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(KN.LAUNCHES)
    eng.close()
    t0 = time.perf_counter()
    checked, mismatches = W.verify_store(store, batches, n_keys)
    t_ver = time.perf_counter() - t0
    if mismatches:
        raise AssertionError(f"{label}: {mismatches} of {checked} keys "
                             "differ from the CPU oracle")
    out = {"wall_s": wall, "keys_per_s": n_keys / wall, "folds": eng.folds,
           "launches": launches, "verified_keys": checked,
           "mismatches": mismatches, "gen_s": t_gen, "verify_s": t_ver,
           "h2d_bytes": eng.bytes_h2d, "d2h_bytes": eng.bytes_d2h,
           "family_secs": {k: round(v, 3) for k, v in eng.family_secs.items()},
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)
           if on_card else None}
    log(f"{label}: {n_keys} keys x {n_rep} replicas, {len(chunks)} chunks "
        f"in groups of {group}, dense_fold={fold}: {wall:.3f} s "
        f"({out['keys_per_s']:.0f} keys/s), folds={eng.folds}, "
        f"launches={launches}, verified {checked} keys, 0 mismatches "
        f"(gen {t_gen:.1f} s, verify {t_ver:.1f} s) {json.dumps(out)}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from constdb_tpu_torch.ops import kernels as KN
    from constdb_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; nvidia-smi name, power.limit: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    secs = KN.build()
    log(f"build: {secs:.1f} s for {len(KN.SOURCES)} libraries (nvcc, sm_90a)")
    for name, text in KN.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build[{name}]: {line.strip()}")

    recs = kernel_phase(dev, args.seed)
    log(f"kernels: SM clock, max SM clock after timing: {sm_clock()}")
    for name, r in recs.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernels: {name} {r['shape']} bit-equal to plain; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")

    rep = args.replicas
    auto = catchup(dev, args.keys, rep, args.seed, 4 * rep, "auto", False,
                   "catch-up (auto)")
    if not auto["launches"]["segment_sum"]:
        raise AssertionError("catch-up (auto) did not launch K4 segment_sum")
    fold = catchup(dev, args.keys, rep, args.seed, rep, "cuda", True,
                   "catch-up (device fold)")
    for k in ("merge_elems", "merge_counters"):
        if not fold["launches"][k]:
            raise AssertionError(f"catch-up (device fold) did not launch {k}")

    replaces = {
        "merge_elems": "constdb_tpu/ops/pallas_dense.py:105",
        "merge_counters": "constdb_tpu/ops/pallas_dense.py:152",
        "segment_sum": "constdb_tpu/ops/pallas_dense.py:433"}
    source = {"merge_elems": "constdb_tpu_torch/csrc/merge_fold.cu",
              "merge_counters": "constdb_tpu_torch/csrc/merge_fold.cu",
              "segment_sum": "constdb_tpu_torch/csrc/segment_sum.cu"}
    kernels = []
    for name, r in recs.items():
        by_path = {"catchup_auto": auto["launches"][name],
                   "catchup_fold": fold["launches"][name]}
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
