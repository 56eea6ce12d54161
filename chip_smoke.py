#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (constdb_tpu_torch) on one GPU.

    python3 chip_smoke.py [--keys N] [--replicas R] [--seed S]
                          [--frames F] [--stream-keys K]

Phases, one line each; any failure raises and exits non-zero:
  1. device    torch.cuda.is_available() (else exit 2), the card's name and
               power limit from nvidia-smi;
  2. build     nvcc builds every kernel from constdb_tpu_torch/csrc;
  3. kernels   each kernel against its plain PyTorch version on the card,
               bit-equal, at its path's shapes, with CUDA-event median
               times of the kernel, the plain version and (where one
               exists) a single PyTorch library call.  K1 fused with
               its apply (fold_apply) at phase 5's own fold widths
               (workload.fold_widths), elements and registers, each
               beside the chain the engine ran before (fold-only K1,
               then the plain bulk op), with its one-column floor and a
               read-flushed time, and untimed on every R instantiation,
               odd widths, offset views, ids beyond the state, absent
               columns, ties and its fold-only mode.  K2 at phase 5's
               shapes, [8, 2^20] and [8, 2^16], and at [8, 131072] and
               [8, 8192], with its one-column floor and a read-flushed
               (clean L2) time, and untimed on every R instantiation, odd
               widths and an offset view.  K4 fused with the base
               subtraction, on uniform random ids and on the engine's
               layout (8 ascending sweeps over 400k of 1M keys), each
               beside the subtraction-then-K4 chain, index_add_ with its
               zero fill and subtraction, a one-row floor and a clean-L2
               time, and untimed on odd lengths, offset views, ids out of
               range, the int64 wrap and grouped ids.  K3: a fused round
               with the segment rows of a phase-6 flush (timed against
               the same segments launched one at a time) and two
               one-segment cases, every row outside the ids unchanged;
               K5: sum, maxmag, trimmed-mean (f32, f64) and fused avg
               (timed against the scale -> K5 sum -> divide chain, with
               no [G, n, Kp] allocation) at the bench shape, and the
               odd-width, looped and small-n paths untimed;
  4. catch-up (auto)         make_workload(N keys, R replicas) in
               131072-key chunks, groups of 4R, resident TorchMergeEngine
               with dense_fold="auto", then flush; verified against the
               port's CpuMergeEngine oracle on a ~100k-key subsample; K4
               launched once per counter-sum re-derivation (upload, K4,
               download: family_secs["sums"]), the store's counter-kid
               layout logged; after phase 5 its re-derivation runs once
               more under the profiler: the same sums, with K4, its zero
               fill and pinned copies only (no plain subtraction, no
               pageable copy).  Its engine and store stay open for
               phase 6;
  5. catch-up (device fold)  the aligned-counter shape, groups of R,
               dense_fold="cuda"; verified the same way, K4 launched once
               per re-derivation; K1 and K2 must launch, the [R, S] of
               every K2 launch and the [R, S] and variant of every K1
               launch are logged, K1's must be phase 3's, and the
               whole fold branch of each register and element dispatch
               must launch K1 once and call no zeros_like and nothing
               of ops/bulk.py but device_full (its state's growth);
  6. steady stream           make_stream_workload(F frames over K keys
               per type prefix) in coalescer flushes of 512 frames through
               phase 4's engine and store (steady path on), a flush after
               every 64th batch and at the end; verified against a CPU
               replay on the stream's keys and re-verified on phase 4's
               subsample; every round on the device, flushes partial, K3
               launched at most once a round, every round's
               host-to-device copies exactly one for its scatter batch
               plus one per mirror column it (re)built, and no
               mask-compaction kernel in the profiled window;
  7. tensor    make_tensor_workload at bench.py --mode tensor's defaults
               (128 keys x 4096 f32 x 8 contributors, 24 rounds of 128
               rows) per strategy, every round reading all keys through
               tensor_read_many; reads and state bit-identical to the
               host leg; K5 launched once per group of every read for
               every non-lww strategy, avg included; one read round of
               each strategy profiled;
  8. catch-up (snapshot files)  phase 5's R batches, made again from
               its seed after phase 7 (not kept alive through phases
               6-7) and written (outside any span) to R snapshot files
               in a temporary directory (each file's bytes, the total,
               the write seconds and the disk's free bytes logged; the
               directory removed at the end), caught up from the files through
               workload.file_catchup into a fresh device-fold engine
               and store in groups of R: the wall runs from opening the
               files to flush and synchronize, decode_s is the demuxes'
               own share; verified like phase 5; K1, K2 and K4 must
               launch, every K1 [R, S, variant] and K2 [R, S] must be
               phase 5's, and each file's NodeMeta must read back as
               written; then a small file with raw sections loads
               through load_snapshot on the card and a copy with one
               key_ct byte flipped raises InvalidSnapshotChecksum.
               Phase 8 keeps only its store's full_state_digest;
  9. sharded catch-up         (a) phase 8's R files through the process
               shards: ShardedKeySpace(default_shards(), "process",
               engine_spec "cuda", groups of R), every worker a
               forkserver process with its own CUDA engine folding with
               K1 and K2 (dense_fold "cuda") and re-deriving
               its sums with K4, raw sections decoded by the workers, then
               each shard's export merged into a fresh serving store
               through a parent engine (workload.sharded_file_catchup).
               The pool starts outside the span; logged: its start
               seconds and shard count, snapshot_merge_keys_per_sec over
               submit -> flush and with the consolidation, the parent's
               demux share, the summed per-shard family_secs, each
               worker's peak device memory.  Checks: the oracle
               subsample, 0 mismatches; the serving store's
               full_state_digest equals phase 8's; every worker launched
               K1, K2 and K4, every K1 and K2 stack R rows; no
               shared-memory segment of the pool left after close().
               (b) phase 5's batches in memory through "local" mode
               with 4 device-fold shards: the oracle
               subsample, K1, K2 and K4 launched, and the four shards'
               digest matrices, summed, equal to phase 5's store's
               full_state_digest.
 10. replication through the node  (a) make_frame_log (bench.py --mode
               stream's frame log: F frames over K keys per prefix, the
               collection DELs included), encoded to RESP bytes outside
               the span, through workload.replay_stream into Node(
               node_id=1) on the card (the resident steady engine):
               make_parser in 1 MiB chunks, CoalescingApplier (512
               frames, 5 ms), the group encoders, barriers through the
               per-key op path, K3 rounds; logged: frames/s, sampled
               visibility latency p50/p99, coalesced flushes, barriers,
               device and host rounds, engine flushes, mirror rebuilds
               and patches, rounds and rows per family on the host twin
               and on the device, uploads, peak memory; checked:
               canonical() and the counter sums equal to the per-frame
               replay (apply_batch=1) through a CpuMergeEngine Node, one
               barrier per delset frame, K3 launches equal to the device
               rounds (> 0), no family on its host twin past the warm-up
               and no mirror rebuilt.  (b) the same
               ops in a pusher Node's repl_log, split as the push loop
               splits a drained run (workload.wire_frames: REPLBATCH runs
               of up to 512 ops, barriers and short runs as single
               frames, outside the span), through apply_wire_batch /
               apply into a fresh card Node: canonical equal to (a)'s,
               K3 launches equal to its device rounds, the same
               placement checks.
               (c) 8 peers' tset frames (128 keys x 4096 f32, 3 rounds),
               one CoalescingApplier each, then Node.tensor_read of every
               key (K5): reads bit-equal to a CPU node's (a NaN matching
               any NaN).  The phase's seconds are logged.
Every catch-up logs the tier of its store's staging tables and fails
unless all are native, and counts the read-only columns the engine
copies before pinning.  Then one JSON line of kernel records (launches
by path, phase 8's as "catchup_files", phase 9's as "sharded_process"
(the workers' and the parent's) and "sharded_local", phase 10's as
"replication" (a and c) and "wire" (b)), the run's total
seconds, the nvidia-smi line, and the last line {"ok": true, "device":
{...}}.

Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import gc
import inspect
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate (data sheet)
# no int64 rate in the data sheet's table: integer compares and adds are
# counted against the closest non-tensor peak, 67 TFLOP/s (FP32)
ALU_OPS_PER_S = 67e12
NEUTRAL_T = -(1 << 62)
# device kernels of PyTorch's boolean-mask indexing (nonzero and its
# compaction, index_put): the plain bulk ops' syncs
COMPACTION_KERNELS = ("nonzero", "DeviceSelect", "DeviceCompact",
                      "index_put", "masked_")
CHUNK_KEYS = 131072
# ~1 ms at the H100's 1.98 GHz SM clock: longer than the host takes to
# enqueue the slowest timed call (five wrapper calls), even on a busy host
SPIN_CYCLES = 2_000_000
KIND_NAMES = {0: "PAIR_SRC", 1: "PAIR", 2: "MAX1"}   # ops/bulk.py kinds


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
    `flush` (untimed) runs, then a ~1 ms spin on the stream, so the
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


def k1_cases(dev, g, R: int, widths: dict, flush_l2, clean_l2) -> dict:
    """K1 fused with its apply (ops/kernels.py fold_apply) against its
    plain version (ops/bulk.py fold_apply), at the device-fold catch-up's
    own fold widths (`widths`, workload.fold_widths: phase 5 checks that
    its launches have exactly these) and R replicas, for elements and
    registers, each timed beside the chain the engine ran before (the
    fold-only launch, then the plain bulk_elems / bulk_lww; registers
    with the zero del stack they read), a read-flushed time (clean_ms)
    and a one-column floor; plus an even element width (16-byte
    accesses; the widths above are odd but one).  Untimed: every R
    instantiation and R > 8, odd widths, offset views, ids beyond the
    state, all-absent columns, ties, and the fold-only mode.  -> the
    record, cases[0] the largest element width."""
    import torch

    from constdb_tpu_torch.ops import bulk as B
    from constdb_tpu_torch.ops import dense as D
    from constdb_tpu_torch.ops import kernels as KN

    i64 = torch.int64

    def stacks(rows, cols, has_del):
        # small stamp ranges force (t) ties and full (t, node) ties; ~1/8
        # of the cells and the first 64 columns absent (NEUTRAL_T); del_t
        # set in ~1/4 of the cells
        at = torch.randint(1, 16, (rows, cols), generator=g, dtype=i64,
                           device=dev)
        m = torch.rand((rows, cols), generator=g, device=dev) < 0.125
        at = torch.where(m, torch.full_like(at, NEUTRAL_T), at)
        at[:, :64] = NEUTRAL_T
        an = torch.randint(0, 4, (rows, cols), generator=g, dtype=i64,
                           device=dev)
        if not has_del:
            return at, an, None
        dt = torch.randint(1, 16, (rows, cols), generator=g, dtype=i64,
                           device=dev)
        dt[torch.rand((rows, cols), generator=g, device=dev) < 0.75] = 0
        return at, an, dt

    def state(size, has_del):
        # a fresh resident plane (zeros, the batch wins) with ~1/8 of the
        # rows already merged: those win some columns and tie others
        planes = [torch.zeros(size, dtype=i64, device=dev)
                  for _ in range(3 if has_del else 2)]
        old = torch.rand(size, generator=g, device=dev) < 0.125
        for p, hi in zip(planes, (16, 4, 16)):
            p[old] = torch.randint(0, hi, (int(old.sum()),), generator=g,
                                   dtype=i64, device=dev)
        return planes

    def call(fn, st, stk, idx):
        at, an, dt = stk
        return fn(at, an, idx, st[0], st[1], dt=dt,
                  st_dt=st[2] if dt is not None else None)

    def check(stk, idx, st0):
        """Kernel and plain on copies of st0 -> (max abs err, kernel's
        state planes, winners)."""
        mine = [p.clone() for p in st0]
        plain = [p.clone() for p in st0]
        w = call(KN.fold_apply, mine, stk, idx)
        wp = call(B.fold_apply, plain, stk, idx)
        err = max_abs_err("K1 fold_apply", [w.to(i64), *mine],
                          [wp.to(i64), *plain])
        return err, mine, w

    def fold_only_check(stk):
        at, an, dt = stk
        if dt is None:
            return max_abs_err("K1 merge_lww", KN.merge_lww(at, an),
                               D.dense_merge_lww(at, an))
        return max_abs_err("K1 merge_elems", KN.merge_elems(at, an, dt),
                           D.dense_merge_elems(at, an, dt))

    # (variant, width, rows of the earlier folds of its family), the
    # largest element width first
    shapes = []
    for variant, fam in (("elements", "el"), ("registers", "reg")):
        offs = [sum(widths[fam][:i]) for i in range(len(widths[fam]))]
        shapes += sorted(((variant, w, o) for w, o in
                          zip(widths[fam], offs)), key=lambda x: -x[1])
    shapes.append(("elements, even width", 1 << 19, 0))
    cases = []
    for variant, cols, off in shapes:
        has_del = variant.startswith("elements")
        # the state as the engine holds it: this fold's rows an ascending
        # run after the earlier folds' rows, in a power-of-two plane
        size = 1 << (off + cols - 1).bit_length()
        idx = torch.arange(off, off + cols, dtype=torch.int32, device=dev)
        stk = stacks(R, cols, has_del)
        st0 = state(size, has_del)
        err, after, win = check(stk, idx, st0)
        err = max(err, fold_only_check(stk))
        # bytes this run's data needs: the stacks, idx and the state rows
        # read once, the winner written, and the state words that changed
        planes = len(st0)
        wrote = sum(int((a != b).sum()) for a, b in zip(after, st0))
        nbytes = planes * R * cols * 8 + cols * 4 + planes * cols * 8 + \
            cols * 4 + wrote * 8
        b_ms, b_by = bound_ms(nbytes, planes * R * cols * 2)
        copies = {k: [p.clone() for p in st0] for k in ("ms", "chain_ms",
                                                        "plain_ms")}

        def restore():
            for cp in copies.values():
                for x, y in zip(cp, st0):
                    x.copy_(y)

        def chain(stk=stk, idx=idx, st=copies["chain_ms"]):
            # the engine before: the fold-only launch (registers: on a
            # zero del stack), then the plain bulk op
            at, an, dt = stk
            if dt is None:
                ft, fn, _, _ = KN.merge_elems(at, an, torch.zeros_like(at))
                return B.bulk_lww(st[0], st[1], idx, ft, fn)
            ft, fn, fd, _ = KN.merge_elems(at, an, dt)
            return B.bulk_elems(*st, idx, ft, fn, fd)

        fns = {"ms": lambda stk=stk, idx=idx, st=copies["ms"]:
               call(KN.fold_apply, st, stk, idx),
               "chain_ms": chain,
               "plain_ms": lambda stk=stk, idx=idx, st=copies["plain_ms"]:
               call(B.fold_apply, st, stk, idx)}
        t = time_ms(fns, flush=lambda: (restore(), flush_l2()))
        t.update(time_ms({"clean_ms": fns["ms"]},
                         flush=lambda: (restore(), clean_l2()),
                         warmup_s=0.3))
        cases.append({**t, "bound_ms": b_ms, "bound_by": b_by,
                      "max_abs_err": err, "shape": [R, cols],
                      "case": variant, "state_rows": size,
                      "batch_wins": int((win >= 0).sum()),
                      "state_words_written": wrote,
                      "width": KN._k1_width(cols, *(x for x in stk
                                                    if x is not None),
                                            idx, win)})
    # the floor of one launch: one column (launch and load latency only)
    stk1 = stacks(R, 1, True)
    st1 = state(1, True)
    idx1 = torch.zeros(1, dtype=torch.int32, device=dev)
    floor = time_ms({"floor_ms": lambda: call(KN.fold_apply, st1, stk1,
                                              idx1)},
                    flush=flush_l2, warmup_s=0.3)
    for c in cases:
        c.update(floor)
    # untimed: every R instantiation and the looped one, odd widths (W =
    # 1), even ones (W = 2), ids beyond the state (pad rows), both
    # variants and the fold-only mode, and views one element into their
    # storage (W = 1 on an even width)
    coverage = []
    for rows in (1, 2, 3, 5, 8, 9, 32):
        for cols in (1, 7, 8190, 131071):
            for has_del in (True, False):
                stk = stacks(rows, cols, has_del)
                size = cols + 5
                idx = torch.randperm(size + 9, generator=g,
                                     device=dev)[:cols].to(torch.int32)
                check(stk, idx, state(size, has_del))
                fold_only_check(stk)
                coverage.append([rows, cols, "del" if has_del else "reg"])
    cols = 8190
    for has_del in (True, False):
        stk = stacks(R, cols, has_del)
        idx = torch.randperm(cols + 9, generator=g,
                             device=dev)[:cols].to(torch.int32)
        views = []
        for x in (*(x for x in stk if x is not None), idx):
            f = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
            f[1:] = x.reshape(-1)
            views.append(f[1:].view(x.shape))
        stk_v = (views[0], views[1], views[2] if has_del else None)
        assert views[0].data_ptr() % 16 == 8
        check(stk_v, views[-1], state(cols + 4, has_del))
        fold_only_check(stk_v)
        coverage.append([R, cols, "offset 1", "del" if has_del else "reg"])
    return {**cases[0], "library_ms": None, "cases": cases,
            "coverage": coverage}


def kernel_phase(dev, seed: int, R: int, widths: dict) -> dict:
    """Hold K1, K2, K4 against their plain versions at the catch-up
    shapes (R replicas; K1's fold widths: `widths`); -> {name: record}."""
    import torch

    from constdb_tpu_torch.ops import dense as D
    from constdb_tpu_torch.ops import kernels as KN

    g = torch.Generator(device=dev).manual_seed(seed)
    S = 131072
    i64 = torch.int64
    # L2 is 50 MB: rewrite 128 MB between timed reps so every rep reads
    # its inputs from device memory, as the engine's fresh uploads do
    scratch = torch.empty(16 << 20, dtype=i64, device=dev)

    def flush_l2():
        scratch.fill_(1)

    def clean_l2():
        # a 128 MB read also evicts the L2, and leaves no dirty line whose
        # write-back the timed launch would pay for
        scratch.sum()

    recs = {"merge_elems": k1_cases(dev, g, R, widths, flush_l2, clean_l2)}

    # K2: values below NEUTRAL_T among ties (the edge where the
    # reference's XLA twin and its Pallas kernel disagree), at the
    # device-fold catch-up's two shapes (phase 5 logs them: its stacks
    # are padded to a power of two) and at [8, 131072] and [8, 8192]
    def k2_stacks(rows, cols):
        ts = torch.randint(0, 16, (rows, cols), generator=g, dtype=i64,
                           device=dev)
        m = torch.rand((rows, cols), generator=g, device=dev) < 0.125
        ts = torch.where(m, torch.full_like(ts, NEUTRAL_T), ts)
        ts[:, :min(cols, 64)] = NEUTRAL_T
        vals = torch.randint(-1000, 1000, (rows, cols), generator=g,
                             dtype=i64, device=dev)
        vals[:, 64:128] = NEUTRAL_T - 5 - \
            torch.arange(rows, device=dev)[:, None]
        if cols >= 2:
            vals[0, :2] = torch.tensor([(1 << 63) - 1, -(1 << 63)],
                                       device=dev)
        return vals, ts

    def k2_check(vals, ts):
        return max_abs_err("K2 merge_counters", KN.merge_counters(vals, ts),
                           D.dense_merge_counters(vals, ts))

    cases = []
    for cols in (1 << 20, 1 << 16, S, 8192):
        vals, ts = k2_stacks(R, cols)
        err = k2_check(vals, ts)
        b_ms, b_by = bound_ms(2 * R * cols * 8 + 2 * cols * 8,
                              2 * R * cols * 2)
        fns = {"ms": lambda: KN.merge_counters(vals, ts),
               "plain_ms": lambda: D.dense_merge_counters(vals, ts)}
        t = time_ms(fns, flush=flush_l2)
        t.update(time_ms({"clean_ms": fns["ms"]}, flush=clean_l2,
                         warmup_s=0.3))
        cases.append({**t, "bound_ms": b_ms, "bound_by": b_by,
                      "max_abs_err": err, "shape": [R, cols]})
    # the floor of one launch: [8, 1] (launch and load latency only)
    v1, t1 = k2_stacks(R, 1)
    floor = time_ms({"floor_ms": lambda: KN.merge_counters(v1, t1)},
                    flush=flush_l2, warmup_s=0.3)
    for c in cases:
        c.update(floor)
    # untimed: every R instantiation the catch-up could take and the
    # looped one, odd widths (W = 1), an even width (W = 2, looped R)
    # and a stack one element into its storage (W = 1 on an even width)
    coverage = []
    for rows in (1, 2, 3, 5, 8, 9, 32):
        for cols in (1, 7, 8190, 131071):
            k2_check(*k2_stacks(rows, cols))
            coverage.append([rows, cols])
    vals, ts = k2_stacks(R, 8190)
    flat = [torch.empty(R * 8190 + 1, dtype=i64, device=dev)
            for _ in range(2)]
    views = []
    for f, x in zip(flat, (vals, ts)):
        f[1:] = x.reshape(-1)
        views.append(f[1:].view(R, 8190))
    assert views[0].data_ptr() % 16 == 8
    k2_check(*views)
    coverage.append([R, 8190, "offset 1"])
    recs["merge_counters"] = {**cases[0], "library_ms": None,
                              "cases": cases, "coverage": coverage}

    # K4 fused with the base subtraction, on two id layouts: (a) uniform
    # random ids over 2^20 segments (each warp's atomics scatter), (b) the
    # engine's: R ascending sweeps over the 400k counter keys of 1M keys
    # (phase 4 logs its store's layout); R slots per counter key
    n = 400_000 * R

    def k4_words(m):
        return tuple(torch.randint(-(1 << 40), 1 << 40, (m,), generator=g,
                                   dtype=i64, device=dev) for _ in range(2))

    def k4_check(ids, sv, n_seg, base=None):
        return max_abs_err(
            "K4 segment_sum", [KN.segment_sum(ids, sv, n_seg, base=base)],
            [D.segment_sum(ids, sv, n_seg, base=base)])

    cases = []
    for layout, n_seg in (("random", 1 << 20), ("sweep", 1_000_000)):
        if layout == "random":
            ids = torch.randint(0, n_seg, (n,), generator=g,
                                dtype=torch.int32, device=dev)
        else:
            ids = torch.arange(n_seg * 2 // 5, dtype=torch.int32,
                               device=dev).repeat(R)
        sv, base = k4_words(n)
        err = max(k4_check(ids, sv, n_seg, base), k4_check(ids, sv, n_seg))
        b_ms, b_by = bound_ms(n * (4 + 8 + 8) + n_seg * 8, 2 * n)

        def chain(ids=ids, sv=sv, base=base, n_seg=n_seg):
            # the unfused main path: a plain subtraction, then K4
            return KN.segment_sum(ids, sv - base, n_seg)

        def library(ids=ids, sv=sv, base=base, n_seg=n_seg):
            # the same function in PyTorch calls, with its zero fill
            return torch.zeros(n_seg, dtype=i64, device=dev).index_add_(
                0, ids, sv - base)

        if not torch.equal(library(), KN.segment_sum(ids, sv, n_seg,
                                                     base=base)):
            raise AssertionError("K4 differs from index_add_")
        fns = {"ms": lambda ids=ids, sv=sv, base=base, n_seg=n_seg:
               KN.segment_sum(ids, sv, n_seg, base=base),
               "chain_ms": chain, "library_ms": library,
               "plain_ms": lambda ids=ids, sv=sv, base=base, n_seg=n_seg:
               D.segment_sum(ids, sv, n_seg, base=base)}
        t = time_ms(fns, flush=flush_l2)
        t.update(time_ms({"clean_ms": fns["ms"]}, flush=clean_l2,
                         warmup_s=0.3))
        cases.append({**t, "bound_ms": b_ms, "bound_by": b_by,
                      "max_abs_err": err, "shape": [n, n_seg],
                      "case": f"{layout} ids"})
    # the floor of one launch: one row (launch, fill and latency only)
    ids1 = torch.zeros(1, dtype=torch.int32, device=dev)
    sv1, base1 = k4_words(1)
    floor = time_ms({"floor_ms": lambda: KN.segment_sum(ids1, sv1, 1 << 20,
                                                        base=base1)},
                    flush=flush_l2, warmup_s=0.3)
    for c in cases:
        c.update(floor)
    # untimed: odd lengths (scalar head and tail, n shorter than a
    # vector), views one element into their storage (a scalar head, or
    # the scalar variant when ids and words disagree), ids out of range,
    # the int64 wrap in segment 0, grouped ids (runs fold in registers),
    # base given and absent
    coverage = []
    for m in (1, 3, 31, 33, 4097):
        for layout in ("random", "grouped"):
            ids = torch.randint(0, 97, (m,), generator=g, dtype=torch.int32,
                                device=dev)
            if layout == "grouped":
                ids = ids.sort().values
            sv, base = k4_words(m)
            if m >= 4:
                ids[:4] = 0
                sv[:4] = torch.tensor([(1 << 63) - 1, (1 << 63) - 1,
                                       -(1 << 63), 7], device=dev)
                base[:4] = torch.tensor([-(1 << 63), -1, 1, (1 << 63) - 1],
                                        device=dev)
            if m >= 31:
                ids[5::9] = -3
                ids[6::9] = 97 + ids[6::9]
            k4_check(ids, sv, 97, base)
            k4_check(ids, sv, 97)
            coverage.append([m, layout])
    m = 4097
    src = (torch.randint(0, 97, (m,), generator=g, dtype=torch.int32,
                         device=dev), *k4_words(m))
    for offs in ((1, 1, 1), (1, 0, 0), (0, 1, 0), (0, 0, 1), (2, 0, 0)):
        views = []
        for x, o in zip(src, offs):
            f = torch.empty(m + o, dtype=x.dtype, device=dev)
            f[o:] = x
            views.append(f[o:])
        k4_check(*views[:2], 97, views[2])
        coverage.append([m, f"storage offsets {list(offs)}"])
    recs["segment_sum"] = {**cases[1], "cases": cases, "coverage": coverage}
    del scratch
    return recs


def profiled(fn) -> dict:
    """Run fn() once under torch.profiler (host and CUDA activity) and
    return its wall seconds, the device's busy seconds (the sum of the
    device-side events: kernels and copies; None when the profiler
    reports none), the busy seconds of the top kernel names and every
    device event's full name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    kw = {"acc_events": True} \
        if "acc_events" in inspect.signature(profile).parameters else {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **kw) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    names = set()
    for ev in prof.key_averages():
        # host-side aten ops also carry their kernels' device time: count
        # only the device-side events, once
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            names.add(ev.key)
            by_name[ev.key[:80]] = by_name.get(ev.key[:80], 0.0) + us / 1e6
    busy = sum(by_name.values()) or None
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": None if busy is None else 1 - busy / wall,
            "top_device_s": top, "device_names": sorted(names)}


def same_bits(kernel: str, got, want) -> None:
    """Raise unless paired float outputs agree bit for bit, except that a
    NaN matches any NaN: IEEE 754 leaves a NaN result's sign and payload
    open, and the card's f64 units propagate an input NaN's payload in
    an order that depends on the instruction PyTorch picked."""
    import torch
    for a, b in zip(got, want):
        iv = torch.int64 if a.dtype == torch.float64 else torch.int32
        same = (a.contiguous().view(iv) == b.contiguous().view(iv)) | \
            (torch.isnan(a) & torch.isnan(b))
        if a.shape != b.shape or not bool(same.all()):
            raise AssertionError(
                f"{kernel} differs from its plain version at "
                f"{int((~same).sum())} elements (bit pattern)")


def typical_round(stream_keys: int, seed: int) -> list:
    """Rows of each scatter of one phase-6 round, counted on a mid-stream
    512-frame flush of make_stream_workload: the unique register keys,
    counter slots and element slots the host folds leave, and the
    element rows with a delete stamp (an upper bound of the del_t
    advances).  The stream has no counter deletes, so the counter base
    pair gets 3 rows, the delcnt rows tests/test_torch_steady.py adds to
    a flush.  -> [(kind, rows)] in the engine's launch order."""
    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.crdt import semantics as S
    from constdb_tpu_torch.ops import kernels as KN
    b = W.make_stream_workload(512 * 5, stream_keys, seed=seed)[4]
    keys = b.keys
    reg = {keys[i] for i, v in enumerate(b.reg_val)
           if v is not None and int(b.key_enc[i]) == S.ENC_BYTES}
    cnt = set(zip((keys[k] for k in b.cnt_ki.tolist()),
                  b.cnt_node.tolist()))
    el = list(zip((keys[k] for k in b.el_ki.tolist()), b.el_member))
    dels = {e for e, d in zip(el, b.el_del_t.tolist()) if d}
    return [(KN.PAIR_SRC, len(reg)), (KN.PAIR_SRC, len(cnt)),
            (KN.PAIR, 3), (KN.PAIR_SRC, len(set(el))), (KN.MAX1, len(dels))]


def steady_kernel_phase(dev, seed: int, stream_keys: int) -> dict:
    """Hold K3 and K5 against their plain versions at the steady path's
    shapes; -> {name: record with a `cases` list}."""
    import torch

    from constdb_tpu_torch.crdt import tensor as T
    from constdb_tpu_torch.ops import bulk as B
    from constdb_tpu_torch.ops import dense as D
    from constdb_tpu_torch.ops import kernels as KN

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    i64 = torch.int64
    recs = {}

    # K3: int64 planes of 2^22 rows (the cap of the 1M-key catch-up's
    # 3.2M-row counter plane), unique random rows per segment; small stamp
    # ranges force primary ties, NEUTRAL_T rows never win, int64 extremes,
    # and `base` sits at the top of the int32 range
    sp = 1 << 22

    def plane_pair():
        p0 = torch.randint(0, 8, (sp,), generator=g, dtype=i64, device=dev)
        p0[torch.rand(sp, generator=g, device=dev) < 0.1] = NEUTRAL_T
        s0 = torch.randint(-4, 4, (sp,), generator=g, dtype=i64, device=dev)
        return p0, s0

    def batch(n):
        idx = torch.randperm(sp, generator=g, device=dev)[:n].to(torch.int32)
        bp = torch.randint(0, 8, (n,), generator=g, dtype=i64, device=dev)
        bp[torch.rand(n, generator=g, device=dev) < 0.1] = NEUTRAL_T
        bs = torch.randint(-4, 4, (n,), generator=g, dtype=i64, device=dev)
        bp[:2] = torch.tensor([(1 << 63) - 1, -(1 << 63)], device=dev)
        bs[:2] = torch.tensor([-(1 << 63), (1 << 63) - 1], device=dev)
        return idx, bp, bs

    def k3_case(shape):
        """shape [(kind, n)] -> a timed, checked round on fresh planes:
        the fused launch, its plain loop, and (several segments) the same
        segments launched one at a time."""
        orig, mine, plain, segs, segs_q, nbytes = [], [], [], [], [], 0
        base_top = 1 << 31
        for kind, n in shape:
            p0, s0 = plane_pair()
            idx, bp, bs = batch(n)
            if kind == KN.PAIR_SRC:
                o = (p0, s0, torch.full((sp,), -1, dtype=torch.int32,
                                        device=dev))
                cols = (bp, bs)
                base_top -= n
                base = base_top
            else:
                o = (p0, s0) if kind == KN.PAIR else (p0,)
                cols = (bp, bs) if kind == KN.PAIR else (bp,)
                base = 0
            orig.append(o)
            mine.append(tuple(t.clone() for t in o))
            plain.append(tuple(t.clone() for t in o))
            segs.append(KN.Segment(kind, mine[-1], idx, cols, base))
            segs_q.append(KN.Segment(kind, plain[-1], idx, cols, base))
            # ids, batch columns and the target rows' plane values read
            # once; winners written below
            nbytes += n * 4 + 2 * 8 * len(cols) * n

        def restore():
            # rewrites every plane (hundreds of MB): also evicts the L2
            for o, a, b in zip(orig, mine, plain):
                for src_t, x, y in zip(o, a, b):
                    x.copy_(src_t)
                    y.copy_(src_t)

        restore()
        KN.scatter_round(segs)
        B.scatter_round(segs_q)
        torch.cuda.synchronize()
        err = max_abs_err("K3 scatter_round",
                          [t.to(i64) for a in mine for t in a],
                          [t.to(i64) for a in plain for t in a])
        wins = 0
        for (kind, n), o, a, sg in zip(shape, orig, mine, segs):
            outside = torch.ones(sp, dtype=torch.bool, device=dev)
            outside[sg.idx.to(i64)] = False
            if not all(torch.equal(x[outside], y[outside])
                       for x, y in zip(a, o)):
                raise AssertionError("K3 scatter_round wrote rows outside "
                                     "its ids")
            changed = a[0] != o[0]
            if len(a) > 1:
                changed |= a[1] != o[1]
            won = int(changed.sum())
            wins += won
            # a winning row writes every plane of its segment
            nbytes += won * sum(t.element_size() for t in a)
        rows = sum(n for _, n in shape)
        b_ms, b_by = bound_ms(nbytes, 4 * rows)
        fns = {"ms": lambda: KN.scatter_round(segs),
               "plain_ms": lambda: B.scatter_round(segs_q)}
        if len(shape) > 1:
            fns["separate_ms"] = lambda: [KN.scatter_round([sg])
                                          for sg in segs]
        tm = time_ms(fns, flush=restore)
        return {**tm, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                "shape": [sp, rows], "wins": wins,
                "segments": [[KIND_NAMES[kind], n] for kind, n in shape]}

    rnd = typical_round(stream_keys, seed)
    cases = [k3_case(rnd)]
    cases[0]["case"] = "round"
    for n in (1024, 32768):
        c = k3_case([(KN.PAIR_SRC, n)])
        c["case"] = f"one PAIR_SRC segment, n={n}"
        cases.append(c)
    recs["scatter_pair_src"] = {**cases[0], "library_ms": None,
                                "cases": cases}

    # K5: bench.py --mode tensor's read shape: G = 128 keys x n = 8
    # contributors x 4096 elements, gathered from a 1024-row pool; NaN,
    # +-0, +-inf and subnormals mixed into the payloads
    G, n, kp = 128, 8, 4096
    scratch = torch.empty(16 << 20, dtype=i64, device=dev)

    def flush_l2():
        scratch.fill_(1)

    def clean_l2():
        # a 128 MB read also evicts the L2, and leaves no dirty line whose
        # write-back the timed launch would pay for (the fill leaves the
        # L2 full of them)
        scratch.sum()

    def payloads(dtype, rows, k):
        buf = torch.randn((rows, k), generator=g, device=dev,
                          dtype=dtype) * 4
        special = torch.tensor([float("nan"), 0.0, -0.0, float("inf"),
                                -float("inf"), 1e-40 if dtype ==
                                torch.float32 else 1e-310],
                               dtype=dtype, device=dev)
        pick = torch.rand((rows, k), generator=g, device=dev) < 0.02
        which = torch.randint(0, len(special), (rows, k), generator=g,
                              device=dev)
        return torch.where(pick, special[which], buf)

    def weights(dtype, groups, nn):
        """avg's count weights [groups * nn] and their totals [groups],
        summed in canonical order in the payload dtype as the engine does."""
        w = torch.randint(1, 9, (groups, nn), generator=g,
                          device=dev).to(dtype)
        tot = w[:, 0].clone()
        for i in range(1, nn):
            tot = tot + w[:, i]
        return w.reshape(-1).contiguous(), tot

    cases = []
    for strat, dtype in ((T.STRAT_SUM, torch.float32),
                         (T.STRAT_MAXMAG, torch.float32),
                         (T.STRAT_TRIMMED, torch.float32),
                         (T.STRAT_TRIMMED, torch.float64),
                         (T.STRAT_AVG, torch.float32)):
        buf = payloads(dtype, G * n, kp)
        idx = torch.randperm(G * n, generator=g,
                             device=dev).to(torch.int32)
        div = n - 2
        avg = strat == T.STRAT_AVG
        w, tot = weights(dtype, G, n) if avg else (None, None)
        kw = {"strat": strat, "n": n, "g": G, "w": w, "tot": tot}
        got = KN.tensor_take_reduce(buf, idx, div, **kw)
        want = D.tensor_take_reduce(buf, idx, div, **kw)
        torch.cuda.synchronize()
        same_bits("K5 tensor_take_reduce", [got], [want])
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
        esz = buf.element_size()
        nbytes = G * n * 4 + G * n * kp * esz + G * kp * esz
        ops = G * kp * n * (3 if strat == T.STRAT_TRIMMED else 1)
        fns = {"ms": lambda: KN.tensor_take_reduce(buf, idx, div, **kw),
               "plain_ms": lambda: D.tensor_take_reduce(buf, idx, div, **kw)}
        extra = {}
        if avg:
            nbytes += G * n * esz + G * esz
            ops = G * kp * (2 * n + 1)
            iota = torch.arange(G * n, dtype=torch.int32, device=dev)
            tot2 = tot.reshape(G, 1)

            def chain():
                # avg as three launches: plain scale, K5 sum, plain divide
                wm = D.tensor_take_scale(buf, idx, w.reshape(G, n), n=n, g=G)
                acc = KN.tensor_take_reduce(wm.reshape(G * n, kp), iota, div,
                                            strat=T.STRAT_SUM, n=n, g=G)
                return D.tensor_div(acc, tot2)

            same_bits("K5 avg against the scale-sum-divide chain",
                      [got], [chain()])
            fns["chain_ms"] = chain
            # no [G, n, Kp] intermediate: the launch allocates only [G, Kp]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            m0 = torch.cuda.memory_allocated(dev)
            KN.tensor_take_reduce(buf, idx, div, **kw)
            torch.cuda.synchronize()
            extra["peak_extra_bytes"] = \
                torch.cuda.max_memory_allocated(dev) - m0
            if extra["peak_extra_bytes"] >= G * n * kp * esz:
                raise AssertionError("K5 avg allocated a [G, n, Kp] "
                                     "intermediate")
        b_ms, b_by = bound_ms(nbytes, ops)
        tm = time_ms(fns, flush=flush_l2)
        tm.update(time_ms({"clean_ms": fns["ms"]}, flush=clean_l2,
                          warmup_s=0.3))
        cases.append({**tm, **extra, "bound_ms": b_ms, "bound_by": b_by,
                      "max_abs_err": err, "shape": [G, n, kp],
                      "strategy": T.STRATEGY_NAMES[strat],
                      "dtype": str(dtype).replace("torch.", "")})
    # the floor of one launch in this loop: a group of one contributor of
    # four elements (launch, id and load latency, next to no bytes)
    tiny = payloads(torch.float32, 1, 4)
    tiny_idx = torch.zeros(1, dtype=torch.int32, device=dev)
    cases[0].update(time_ms({"floor_ms": lambda: KN.tensor_take_reduce(
        tiny, tiny_idx, 1, strat=T.STRAT_SUM, n=1, g=1)}, flush=flush_l2,
        warmup_s=0.3))
    # the paths the bench shape does not take, checked untimed: odd and
    # 2-aligned widths (scalar and 8-byte accesses), n > 8 (the looped
    # path), n <= 2 trimmed-mean, avg in both dtypes
    coverage = []
    for strat, dtype, gg, nn, k in (
            (T.STRAT_TRIMMED, torch.float32, 9, 11, 4095),
            (T.STRAT_AVG, torch.float32, 7, 3, 4094),
            (T.STRAT_SUM, torch.float64, 5, 1, 4095),
            (T.STRAT_AVG, torch.float64, 6, 13, 4096),
            (T.STRAT_TRIMMED, torch.float32, 4, 2, 4096),
            (T.STRAT_MAXMAG, torch.float64, 3, 17, 1027),
            (T.STRAT_TRIMMED, torch.float64, 8, 8, 2050)):
        buf = payloads(dtype, gg * nn + 3, k)
        idx = torch.randperm(gg * nn + 3, generator=g,
                             device=dev)[:gg * nn].to(torch.int32)
        div = nn if nn <= 2 else nn - 2
        w, tot = weights(dtype, gg, nn) if strat == T.STRAT_AVG \
            else (None, None)
        kw = {"strat": strat, "n": nn, "g": gg, "w": w, "tot": tot}
        same_bits("K5 tensor_take_reduce",
                  [KN.tensor_take_reduce(buf, idx, div, **kw)],
                  [D.tensor_take_reduce(buf, idx, div, **kw)])
        coverage.append([T.STRATEGY_NAMES[strat],
                         str(dtype).replace("torch.", ""), gg, nn, k])
    recs["tensor_take_reduce"] = {**cases[0], "library_ms": None,
                                  "cases": cases, "coverage": coverage}
    del scratch
    return recs


def stream_phase(dev, eng, store, catch_batches, n_keys: int, frames: int,
                 stream_keys: int, seed: int) -> dict:
    """Phase 6: the steady replication stream through the caught-up
    engine, verified against a CPU replay; -> launches and timings."""
    import torch

    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.ops import kernels as KN

    t0 = time.perf_counter()
    batches = W.make_stream_workload(frames, stream_keys, seed=seed)
    t_gen = time.perf_counter() - t0
    n_frames = sum(len(b.keys) for b in batches)  # one key row a frame
    rows = sum(b.n_rows for b in batches)
    g0 = {k: getattr(eng, k) for k in (
        "dev_rounds_resident", "host_micro_rounds", "flush_rows_downloaded",
        "flush_rows_full_equiv", "bytes_h2d", "bytes_d2h", "h2d_copies")}
    fs0 = dict(eng.family_secs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launches()
    # host-to-device copies issued by the merge rounds themselves (the
    # flushes upload their dirty-row ids apart): one packed copy for the
    # round's K3 launch, plus one per column of a family mirror the round
    # (re)built; any other count is a fault
    copies = {"round": 0, "mirror": 0, "off": []}

    def merge(b):
        c0, l0 = eng.h2d_copies, KN.LAUNCHES["scatter_pair_src"]
        fams0, rb0 = set(eng._res), dict(eng.mirror_rebuilds)
        eng.merge_many(store, [b])
        got = eng.h2d_copies - c0
        built = (set(eng._res) - fams0) | {
            f for f, v in eng.mirror_rebuilds.items() if v > rb0[f]}
        mirror = sum(len(eng._res[f]["cols"]) for f in built
                     if f in eng._res)
        copies["round"] += got
        copies["mirror"] += mirror
        if got != KN.LAUNCHES["scatter_pair_src"] - l0 + mirror:
            copies["off"].append((got, mirror))

    # the last 64 flushes run under the profiler (device busy share);
    # the rates come from the unprofiled rest
    cut = len(batches) - 64
    t0 = time.perf_counter()
    for i, b in enumerate(batches[:cut]):
        merge(b)
        if i % 64 == 63:
            eng.flush(store)
    eng.flush(store)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frames_cut = sum(len(b.keys) for b in batches[:cut])
    rows_cut = sum(b.n_rows for b in batches[:cut])

    def window():
        for b in batches[cut:]:
            merge(b)
        eng.flush(store)

    prof = profiled(window)
    launches = dict(KN.LAUNCHES)
    d = {k: getattr(eng, k) - v for k, v in g0.items()}
    t0 = time.perf_counter()
    oracle = W.replay_oracle(batches)
    keys = W.batch_keys(batches)
    bad = W.compare_canonical(store.canonical(keys=keys), oracle.canonical())
    bad += W.compare_counter_sums(store, oracle, keys)
    checked, bad_sub = W.verify_store(store, catch_batches, n_keys)
    t_ver = time.perf_counter() - t0
    if bad or bad_sub:
        raise AssertionError(f"steady stream: {bad} of {len(keys)} stream "
                             f"keys and {bad_sub} of {checked} catch-up "
                             "keys differ from the CPU oracle")
    if not d["dev_rounds_resident"] or d["host_micro_rounds"]:
        raise AssertionError(f"steady stream: rounds on the device "
                             f"{d['dev_rounds_resident']}, on the host "
                             f"{d['host_micro_rounds']}")
    if not 0 < d["flush_rows_downloaded"] < d["flush_rows_full_equiv"]:
        raise AssertionError("steady stream: flushes were not partial "
                             f"({d['flush_rows_downloaded']} of "
                             f"{d['flush_rows_full_equiv']} rows)")
    rounds = d["dev_rounds_resident"]
    if not 0 < launches["scatter_pair_src"] <= rounds:
        raise AssertionError(f"steady stream: K3 launched "
                             f"{launches['scatter_pair_src']} times in "
                             f"{rounds} device rounds")
    if copies["off"]:
        raise AssertionError(
            f"steady stream: {len(copies['off'])} rounds made other "
            "host-to-device copies than one for the scatter batch and one "
            "per mirror column built, (copies, mirror columns): "
            f"{copies['off'][:8]}")
    scatter_copies = copies["round"] - copies["mirror"]
    compaction = [k for k in prof["device_names"]
                  if any(m in k for m in COMPACTION_KERNELS)]
    if compaction:
        raise AssertionError("steady stream: the profiled window ran the "
                             f"plain ops' mask compactions: {compaction}")
    out = {"wall_s": wall, "frames": n_frames, "batches": len(batches),
           "rows": rows, "frames_per_s": frames_cut / wall,
           "rows_per_s": rows_cut / wall, "launches": launches,
           "round_h2d_copies": copies["round"],
           "mirror_h2d_copies": copies["mirror"],
           "h2d_copies_per_round": scatter_copies / rounds,
           "k3_launches_per_round": launches["scatter_pair_src"] / rounds,
           "profiled_window": {k: v for k, v in prof.items()
                               if k != "device_names"},
           "verified_stream_keys": len(keys), "verified_catchup_keys":
           checked, "mismatches": 0, "gen_s": t_gen, "verify_s": t_ver,
           **{k: v for k, v in d.items()},
           "family_secs": {k: round(v - fs0[k], 3)
                           for k, v in eng.family_secs.items()},
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    eng.close()
    log(f"steady stream: {n_frames} frames over {stream_keys} keys per "
        f"prefix in {len(batches)} flushes of 512; the first {cut} "
        f"flushes {wall:.3f} s ({out['frames_per_s']:.0f} frames/s, "
        f"{out['rows_per_s']:.0f} rows/s), the last 64 profiled: device "
        f"busy {prof['device_busy_s']} s of {prof['wall_s']:.3f} s; up {d['bytes_h2d']} B, down {d['bytes_d2h']} B, micro "
        f"{out['family_secs']['micro']} s, flush "
        f"{out['family_secs']['flush']} s, rounds on the device "
        f"{d['dev_rounds_resident']}, on the host {d['host_micro_rounds']}, "
        f"K3 launches per round {out['k3_launches_per_round']:.3f}, "
        f"host-to-device copies per round for the scatter batch "
        f"{out['h2d_copies_per_round']:.3f}, {copies['mirror']} for mirror "
        f"columns built, {d['h2d_copies'] - copies['round']} by the "
        f"flushes, "
        f"no mask compaction on the device, "
        f"flush rows {d['flush_rows_downloaded']} of "
        f"{d['flush_rows_full_equiv']}, launches={launches}, peak "
        f"{out['peak_mem_bytes']} B; verified {len(keys)} stream keys and "
        f"{checked} catch-up keys, 0 mismatches; reductions: collection "
        f"DELs (0.2% of frames) left out {json.dumps(out)}")
    return out


def tensor_phase(dev) -> dict:
    """Phase 7: tensor registers at bench.py --mode tensor's defaults,
    device leg against the host leg per strategy."""
    import numpy as np
    import torch

    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.crdt import tensor as T
    from constdb_tpu_torch.engine.cpu import CpuMergeEngine
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine
    from constdb_tpu_torch.ops import kernels as KN
    from constdb_tpu_torch.store.keyspace import KeySpace

    n_keys, elems, n_nodes, rounds, batch_rows = 128, 4096, 8, 24, 128
    kids = tuple(range(n_keys))
    launches = dict.fromkeys(KN.LAUNCHES, 0)
    legs = []
    engines = []
    for strat in ("avg", "maxmag", "trimmed-mean", "sum", "lww"):
        batches = W.make_tensor_workload(rounds, batch_rows, n_keys,
                                         n_nodes, elems, strat)
        rows = sum(len(b.tns_ki) for b in batches)
        eng = TorchMergeEngine(resident=True, steady=True, warmup=0,
                               device=dev)
        store = KeySpace()
        torch.cuda.synchronize()
        KN.reset_launches()
        t0 = time.perf_counter()
        dev_reads = []
        group_reads = 0  # K5 groups of every read, from the read cache
        for b in batches:
            eng.merge_many(store, [b])
            dev_reads.append(eng.tensor_read_many(store, kids))
            group_reads += sum(
                g[0] != T.STRAT_LWW for g in
                eng._tns_read_cache["by_kids"][kids]["groups"])
        eng.flush(store)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got_l = dict(KN.LAUNCHES)
        for k, v in got_l.items():
            launches[k] += v
        engines.append((eng, store))
        host = KeySpace()
        cpu = CpuMergeEngine()
        t0 = time.perf_counter()
        bad = 0
        for b, reads in zip(batches, dev_reads):
            cpu.merge_many(host, [b])
            for kid in range(n_keys):
                want = host.tensor_read(kid)
                got = reads[kid]
                if want is None or got is None:
                    bad += (want is None) != (got is None)
                elif want.tobytes() != np.asarray(got).tobytes():
                    bad += 1
        host_wall = time.perf_counter() - t0
        if store.canonical() != host.canonical():
            bad += 1
        if bad:
            raise AssertionError(f"tensor {strat}: {bad} reads or states "
                                 "differ from the host leg")
        if not eng.tns_dev_rows or eng.tns_host_rows:
            raise AssertionError(f"tensor {strat}: rows on the device "
                                 f"{eng.tns_dev_rows}, on the host "
                                 f"{eng.tns_host_rows}")
        # one K5 launch per group of every read (avg fused into it)
        if got_l["tensor_take_reduce"] != group_reads or \
                (strat != "lww") != (group_reads > 0):
            raise AssertionError(
                f"tensor {strat}: K5 launched {got_l['tensor_take_reduce']} "
                f"times for {group_reads} group reads")
        leg = {"strategy": strat, "wall_s": wall, "rows": rows,
               "rows_per_s": rows / wall, "reads": rounds * n_keys,
               "host_leg_s": host_wall, "tns_dev_rows": eng.tns_dev_rows,
               "launches": got_l, "family_secs":
               {k: round(v, 3) for k, v in eng.family_secs.items()}}
        legs.append(leg)
        log(f"tensor {strat}: {rounds} rounds x {batch_rows} rows "
            f"({rows} rows, {rounds * n_keys} reads of {n_keys} keys x "
            f"{elems} f32 x {n_nodes} contributors): {wall:.3f} s "
            f"({leg['rows_per_s']:.0f} rows/s; host leg with its reads "
            f"{host_wall:.3f} s), reads and state bit-identical to the "
            f"host leg, launches={got_l} {json.dumps(leg)}")

    def read_rounds():
        for eng, store in engines:
            eng.tensor_read_many(store, kids)

    # one more read round of every strategy, profiled (device busy share)
    prof = profiled(read_rounds)
    prof.pop("device_names")
    for eng, _store in engines:
        eng.close()
    log(f"tensor: one read round of each strategy, profiled: device busy "
        f"{prof['device_busy_s']} s of {prof['wall_s']:.4f} s "
        f"{json.dumps(prof)}")
    return {"legs": legs, "launches": launches, "profiled_reads": prof}


def catchup(dev, n_keys: int, n_rep: int, seed: int, group: int,
            fold: str, aligned: bool, label: str, files=None, batches=None):
    """One streamed catch-up through TorchMergeEngine, verified against
    the CPU oracle; -> (launches and timings, engine, store, batches).
    With `files` (one snapshot file per replica of `batches`) the chunks
    come from the files through workload.file_catchup; the wall span then
    runs from opening the files to the flush, and `decode_s` is the
    demuxes' own share of it."""
    import numpy as np
    import torch

    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine
    from constdb_tpu_torch.ops import bulk as B
    from constdb_tpu_torch.ops import kernels as KN
    from constdb_tpu_torch.store.keyspace import KeySpace
    from constdb_tpu_torch.utils.tables import tier

    t0 = time.perf_counter()
    if batches is None:
        batches = W.make_workload(n_keys, n_rep, seed=seed,
                                  aligned_counters=aligned)
    chunks = W.chunk_batches(batches, CHUNK_KEYS) if files is None else None
    t_gen = time.perf_counter() - t0
    eng = TorchMergeEngine(resident=True, dense_fold=fold, device=dev)
    store = KeySpace()
    tiers = {name: tier(getattr(store, name)) for name in
             ("key_index", "member_index", "el_index", "tns_index")}
    if set(tiers.values()) != {"native"}:
        raise AssertionError(f"{label}: staging tables {tiers}; every "
                             "one must be the native tier")
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launches()
    # the [R, S] of every K2 launch (the engine looks the wrapper up on
    # the module at each call)
    k2_shapes = []
    real_k2 = KN.merge_counters

    def k2_logged(vals, ts):
        k2_shapes.append(list(vals.shape))
        return real_k2(vals, ts)

    KN.merge_counters = k2_logged
    # every K1 launch's [R, S] and variant, and per reg/el fold of the
    # engine its K1 launches and its calls into ops/bulk.py (the plain
    # mask-indexed ops); the engine looks both up on their modules
    k1_shapes = []
    real_k1 = KN.fold_apply

    def k1_logged(at, an, idx, st_at, st_an, dt=None, st_dt=None):
        k1_shapes.append([*at.shape, "elements" if dt is not None
                          else "registers"])
        return real_k1(at, an, idx, st_at, st_an, dt=dt, st_dt=st_dt)

    KN.fold_apply = k1_logged
    # calls into ops/bulk.py by name, and zero fills (the del plane the
    # register fold read before K1 took a variant without one)
    bulk_calls: dict = {}
    real_bulk = {name: getattr(B, name) for name in B.__all__
                 if inspect.isfunction(getattr(B, name))}

    def counted(name, f):
        def wrapper(*a, **kw):
            bulk_calls[name] = bulk_calls.get(name, 0) + 1
            return f(*a, **kw)
        return wrapper

    for name, f in real_bulk.items():
        setattr(B, name, counted(name, f))
    real_zeros_like = torch.zeros_like
    torch.zeros_like = counted("torch.zeros_like", real_zeros_like)
    # the whole fold branch of the register and element dispatch (state
    # upload, K1, the winners' value loops, the family record): per fold,
    # (family, K1 launches, ops/bulk.py and zeros_like calls by name)
    folds = []

    def fold_counted(fam, real):
        def wrapper(store_, plan, st_):
            if not (plan and plan.get("fold")):
                return real(store_, plan, st_)
            l0, b0 = KN.LAUNCHES["merge_elems"], dict(bulk_calls)
            out = real(store_, plan, st_)
            folds.append((fam, KN.LAUNCHES["merge_elems"] - l0,
                          {k: v - b0.get(k, 0) for k, v in bulk_calls.items()
                           if v != b0.get(k, 0)}))
            return out
        return wrapper

    eng._dispatch_registers = fold_counted("reg", eng._dispatch_registers)
    eng._dispatch_elem_rows = fold_counted("el", eng._dispatch_elem_rows)
    # counter-sum re-derivations (one per whole-plane counter flush)
    rederive = []
    real_sums = eng._recompute_sums
    eng._recompute_sums = lambda st: rederive.append(1) or real_sums(st)
    # columns the engine's _h2d must copy before pinning them: read-only
    # arrays (the zero-copy views a snapshot decode yields)
    ro = {"copies": 0, "bytes": 0}
    real_h2d = eng._h2d

    def h2d_counted(arr):
        if isinstance(arr, np.ndarray) and arr.flags.c_contiguous and \
                not arr.flags.writeable:
            ro["copies"] += 1
            ro["bytes"] += arr.nbytes
        return real_h2d(arr)

    eng._h2d = h2d_counted
    real_flush = eng.flush

    def flush_marked(store_):
        span[0] = "flush"
        return real_flush(store_)

    eng.flush = flush_marked
    # host seconds of Python's cyclic garbage collector inside the merge
    # loop and inside the flush: a full collection that lands in a span
    # scans every live object of the process
    gc_s = {"merge": 0.0, "flush": 0.0}
    span = ["merge", 0.0]

    def gc_timer(phase, _info):
        if phase == "start":
            span[1] = time.perf_counter()
        else:
            gc_s[span[0]] += time.perf_counter() - span[1]

    gc.callbacks.append(gc_timer)
    try:
        t0 = time.perf_counter()
        if files is None:
            for i in range(0, len(chunks), group):
                eng.merge_many(store, chunks[i:i + group])
            eng.flush(store)
            fc = None
        else:
            fc = W.file_catchup(eng, store, files, group)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(gc_timer)
        KN.merge_counters = real_k2
        KN.fold_apply = real_k1
        for name, f in real_bulk.items():
            setattr(B, name, f)
        torch.zeros_like = real_zeros_like
        del eng._recompute_sums, eng._dispatch_registers, \
            eng._dispatch_elem_rows, eng._h2d, eng.flush
    launches = dict(KN.LAUNCHES)
    if on_card and not 1 <= launches["segment_sum"] == len(rederive):
        raise AssertionError(
            f"{label}: K4 launched {launches['segment_sum']} times in "
            f"{len(rederive)} counter-sum re-derivations")
    # device_full is the neutral fill of a resident plane that grows with
    # the keyspace (torch.full: no mask, no host sync); every other
    # ops/bulk.py function is a plain apply
    if on_card and fold == "cuda" and (
            not folds or len(folds) != len(k1_shapes) or
            any(n1 != 1 or set(calls) - {"device_full"}
                for _, n1, calls in folds)):
        raise AssertionError(
            f"{label}: reg/el fold dispatches (family, K1 launches, "
            f"ops/bulk.py and zeros_like calls): {folds} for "
            f"{len(k1_shapes)} K1 calls; each fold must launch K1 once "
            "and run no plain bulk op (only device_full may grow its "
            "state) and no zero fill")
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
           "stage_secs": {k: round(v, 3) for k, v in eng.stage_secs.items()},
           "sums_s": eng.family_secs["sums"], "gc_s": gc_s,
           "k2_shapes": k2_shapes, "k1_shapes": k1_shapes,
           "k1_folds": folds, "tables": tiers,
           "read_only_copies": ro["copies"],
           "read_only_copy_bytes": ro["bytes"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)
           if on_card else None}
    if fc is not None:
        out.update(decode_s=fc["decode_s"],
                   decode_share=fc["decode_s"] / wall, metas=fc["metas"],
                   records=fc["records"])
    n_chunks = len(chunks) if fc is None else fc["chunks"]
    log(f"{label}: {n_keys} keys x {n_rep} replicas, {n_chunks} chunks "
        f"in groups of {group}, dense_fold={fold}: {wall:.3f} s "
        f"({out['keys_per_s']:.0f} keys/s), folds={eng.folds}, "
        f"launches={launches}, flush {eng.family_secs['flush']:.4f} s of "
        f"which sums (upload, K4, download) {out['sums_s']:.4f} s in "
        f"{len(rederive)} re-derivation(s), one K4 launch each, garbage "
        f"collection {gc_s['merge']:.4f} s in the merges and "
        f"{gc_s['flush']:.4f} s in the flush, "
        f"verified {checked} keys, 0 mismatches, staging tables {tiers}, "
        f"{ro['copies']} read-only columns copied before pinning "
        f"({ro['bytes']} bytes) (gen {t_gen:.1f} s, verify {t_ver:.1f} s) "
        f"{json.dumps(out, default=str)}")
    shapes = sorted({tuple(x) for x in k2_shapes})
    log(f"{label}: K2 launches {len(k2_shapes)}, [R, S] of each: "
        f"{k2_shapes}; distinct {[list(x) for x in shapes]}")
    log(f"{label}: K1 (fold_apply) calls {len(k1_shapes)}, [R, S, "
        f"variant] of each: {k1_shapes}; per reg/el fold dispatch "
        f"(family, K1 launches, ops/bulk.py and zeros_like calls): "
        f"{folds}")
    kid = store.cnt.kid[:store.cnt.n]
    d = np.diff(kid)
    log(f"{label}: cnt.kid layout: {len(kid)} counter slots over "
        f"{store.keys.n} keys, adjacent +1 share {float((d == 1).mean())}, "
        f"adjacent equal share {float((d == 0).mean())}, descents "
        f"{int((d < 0).sum())} (R = {n_rep} ascending sweeps)")
    return out, eng, store, batches


# device events a CUDA counter-sum re-derivation may run: K4, its output's
# zero fill, the pinned upload of the slot kids and the pinned download of
# the sums
SUMS_EVENTS = ("segment_sum_kernel", "FillFunctor", "Memset",
               "Memcpy HtoD (Pinned -> Device)",
               "Memcpy DtoH (Device -> Pinned)")


def sums_profile(eng, store, label: str) -> None:
    """Run the engine's counter-sum re-derivation once more under the
    profiler: it must reproduce the sums and run K4 with no plain
    subtraction kernel and no pageable copy."""
    from constdb_tpu_torch.ops import kernels as KN
    nk = store.keys.n
    before = store.keys.cnt_sum[:nk].copy()
    l0 = KN.LAUNCHES["segment_sum"]
    prof = profiled(lambda: eng._recompute_sums(store))
    names = prof.pop("device_names")
    if not (store.keys.cnt_sum[:nk] == before).all():
        raise AssertionError(f"{label}: a second re-derivation changed the "
                             "counter sums")
    other = [k for k in names if not any(e in k for e in SUMS_EVENTS)]
    if KN.LAUNCHES["segment_sum"] != l0 + 1 or other or \
            not any("segment_sum_kernel" in k for k in names) or \
            not any("Memcpy DtoH (Device -> Pinned)" in k for k in names):
        raise AssertionError(f"{label}: the profiled counter-sum "
                             f"re-derivation ran {names}")
    log(f"{label}: profiled counter-sum re-derivation: device events "
        f"{names}; no plain subtraction, no pageable copy "
        f"{json.dumps(prof)}")


def write_files(directory: str, batches) -> list:
    """Phase 5's R batches to R snapshot files (workload.
    write_replica_files), after phase 7 and outside any timed span."""
    from constdb_tpu_torch import workload as W
    du = shutil.disk_usage(directory)
    log(f"snapshot files: {directory} before writing: total {du.total}, "
        f"used {du.used}, free {du.free} bytes")
    t0 = time.perf_counter()
    paths = W.write_replica_files(batches, directory, CHUNK_KEYS)
    secs = time.perf_counter() - t0
    sizes = [os.path.getsize(p) for p in paths]
    log(f"snapshot files: {len(paths)} files written in {secs:.3f} s, "
        f"bytes {sizes}, total {sum(sizes)}")
    return paths


def file_phase(dev, n_keys: int, n_rep: int, seed: int, fold: dict,
               paths: list, batches) -> dict:
    """Phase 8: the device-fold catch-up from phase 5's R snapshot files
    into a fresh engine and store, verified like phase 5; its K1 and K2
    shapes must be phase 5's, K1, K2 and K4 must launch, and each file's
    NodeMeta must read back as written."""
    from constdb_tpu_torch import workload as W
    label = "catch-up (snapshot files)"
    log(f"{label}: the files were written by this process, so their reads "
        "may hit the page cache")
    out, eng, store, _ = catchup(dev, n_keys, n_rep, seed, n_rep, "cuda",
                                 True, label, files=paths, batches=batches)
    eng.close()
    out["digest"] = full_state_digest(store)
    del store
    for k in ("merge_elems", "merge_counters", "segment_sum"):
        if not out["launches"][k]:
            raise AssertionError(f"{label} did not launch {k}")
    for k in ("k1_shapes", "k2_shapes"):
        if sorted(out[k]) != sorted(fold[k]):
            raise AssertionError(f"{label}: {k} {out[k]}, phase 5 ran "
                                 f"{fold[k]}")
    want = [W.replica_meta(r) for r in range(n_rep)]
    if out["metas"] != want or out["records"] != [[]] * n_rep:
        raise AssertionError(f"{label}: NodeMeta read back {out['metas']}, "
                             f"records {out['records']}; written {want}")
    log(f"{label}: {out['keys_per_s']:.0f} keys/s, decode {out['decode_s']:.3f}"
        f" s of {out['wall_s']:.3f} s ({out['decode_share']:.1%}), "
        f"family_secs {out['family_secs']}, uploads {out['h2d_bytes']} "
        f"bytes, downloads {out['d2h_bytes']} bytes, K1/K2/K4 launches "
        f"{[out['launches'][k] for k in ('merge_elems', 'merge_counters', 'segment_sum')]}, "
        f"{out['read_only_copies']} read-only columns copied before "
        f"pinning; K1 and K2 shapes equal phase 5's; NodeMeta of every "
        f"file as written")
    return out


def full_state_digest(store) -> int:
    """store/digest.py full_state_digest: the whole logical state folded
    to 64 bits, independent of the shard layout."""
    from constdb_tpu_torch.store.digest import full_state_digest as fsd
    return fsd(store)


def shm_left(names) -> list:
    """The pool's segments (created by it or handed over by a worker)
    still in /dev/shm."""
    return sorted(n for n in names if os.path.exists(f"/dev/shm/{n}"))


def sharded_phase(dev, n_keys: int, n_rep: int, paths: list, batches,
                  oracle: tuple, want_digest: int) -> dict:
    """Phase 9a: the catch-up from phase 8's R files through the process
    shards (default_shards() workers, one CUDA engine each, dense_fold
    "cuda"), then consolidated into a fresh serving store through a
    parent engine (workload.sharded_file_catchup)."""
    import torch

    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine
    from constdb_tpu_torch.ops import kernels as KN
    from constdb_tpu_torch.store.keyspace import KeySpace
    from constdb_tpu_torch.store.sharded_keyspace import (ShardedKeySpace,
                                                          default_shards)
    label = "sharded catch-up (process)"
    n = default_shards()
    t0 = time.perf_counter()
    sks = ShardedKeySpace(n_shards=n, mode="process", engine_spec="cuda",
                          group=n_rep, dense_fold="cuda", device=dev)
    try:
        # every worker up and its imports done; its CUDA context and the
        # kernels' load come with its first merge, inside the span
        pids = [s["pid"] for s in sks.host_secs_per_shard()]
        start_s = time.perf_counter() - t0
        log(f"{label}: {n} workers (default_shards(), {os.cpu_count()} "
            f"cores) up in {start_s:.3f} s, pids {pids}")
        serve, eng = KeySpace(), TorchMergeEngine(resident=True, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        KN.reset_launches()
        t0 = time.perf_counter()
        fc = W.sharded_file_catchup(sks, paths, n_rep, eng, serve)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        parent = dict(KN.LAUNCHES)
        parent_peak = torch.cuda.max_memory_allocated(dev)
        eng.close()
    finally:
        sks.close()
    left = shm_left(sks.pool.shm_names)
    if left:
        raise AssertionError(f"{label}: shared-memory segments {left} of "
                             f"{len(sks.pool.shm_names)} left after close()")
    sub_keys, want = oracle
    mism = W.compare_canonical(serve.canonical(keys=sub_keys), want)
    if mism:
        raise AssertionError(f"{label}: {mism} of {len(sub_keys)} keys "
                             "differ from the CPU oracle")
    digest = full_state_digest(serve)
    if digest != want_digest:
        raise AssertionError(f"{label}: serving store digest {digest:#x}, "
                             f"phase 8's store {want_digest:#x}")
    workers = fc["shard_secs"]
    k_names = ("merge_elems", "merge_counters", "segment_sum")
    for i, w in enumerate(workers):
        if any(w["launches"][k] < 1 for k in k_names):
            raise AssertionError(f"{label}: worker {i} launched "
                                 f"{w['launches']}; each of K1, K2 and K4 "
                                 "must launch")
        shapes = w["fold_shapes"]["merge_elems"] + \
            w["fold_shapes"]["merge_counters"]
        if any(sh[0] != n_rep for sh in shapes):
            raise AssertionError(f"{label}: worker {i} folded {shapes}; "
                                 f"every K1 and K2 stack must hold R = "
                                 f"{n_rep} rows")
    if len({w["pid"] for w in workers}) != n:
        raise AssertionError(f"{label}: replies from pids "
                             f"{[w['pid'] for w in workers]}")
    launches = {k: parent[k] + sum(w["launches"][k] for w in workers)
                for k in parent}
    fam: dict = {}
    for w in workers:
        for k, v in w["family_secs"].items():
            fam[k] = fam.get(k, 0.0) + v
    out = {"n_shards": n, "start_s": start_s, "wall_s": wall,
           "merge_s": fc["merge_s"], "demux_s": fc["demux_s"],
           "consolidate_s": fc["consolidate_s"],
           "snapshot_merge_keys_per_sec": n_keys / fc["merge_s"],
           "keys_per_s_with_consolidation":
               n_keys / (fc["merge_s"] + fc["consolidate_s"]),
           "demux_share": fc["demux_s"] / fc["merge_s"],
           "family_secs_summed": {k: round(v, 3) for k, v in fam.items()},
           "launches": launches, "parent_launches": parent,
           "worker_launches": [w["launches"] for w in workers],
           "worker_folds": [w["folds"] for w in workers],
           "worker_peak_mem_bytes": [w["peak_mem_bytes"] for w in workers],
           "parent_peak_mem_bytes": parent_peak,
           "shm_segments": len(sks.pool.shm_names),
           "verified_keys": len(sub_keys), "mismatches": mism,
           "digest": digest}
    log(f"{label}: {n_keys} keys x {n_rep} replicas from {len(paths)} "
        f"files, {fc['chunks']} raw sections in jobs of {n_rep}: "
        f"snapshot_merge_keys_per_sec {out['snapshot_merge_keys_per_sec']:.0f}"
        f" (submit -> flush {fc['merge_s']:.3f} s), "
        f"{out['keys_per_s_with_consolidation']:.0f} with consolidation "
        f"({fc['consolidate_s']:.3f} s); parent demux (read, inflate) "
        f"{fc['demux_s']:.3f} s ({out['demux_share']:.1%}); pool start "
        f"{start_s:.3f} s (outside the span); summed per-shard family_secs "
        f"{out['family_secs_summed']}; worker peak device memory "
        f"{out['worker_peak_mem_bytes']} bytes, parent "
        f"{parent_peak}; K1/K2/K4 launches per worker "
        f"{[[w['launches'][k] for k in k_names] for w in workers]}, parent "
        f"{[parent[k] for k in k_names]}; every K1/K2 stack R = {n_rep}; "
        f"verified {len(sub_keys)} keys, 0 mismatches; digest {digest:#x} "
        f"equals phase 8's; {len(sks.pool.shm_names)} shared-memory "
        f"segments, none left")
    log(f"{label}: per-worker secs "
        f"{json.dumps(workers, default=str)}")
    return out


def local_phase(dev, n_keys: int, n_rep: int, batches, oracle: tuple,
                want_digest: int) -> dict:
    """Phase 9b: phase 5's batches in memory through "local" mode
    with 4 shards (four device-fold engines in this process); the summed
    shard digests must equal phase 5's store's."""
    import numpy as np
    import torch

    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.ops import kernels as KN
    from constdb_tpu_torch.store import digest as D
    from constdb_tpu_torch.store.sharded_keyspace import ShardedKeySpace
    label = "sharded catch-up (local, 4 shards)"
    chunks = W.chunk_batches(batches, CHUNK_KEYS)
    sks = ShardedKeySpace(n_shards=4, mode="local", engine_spec="cuda",
                          group=n_rep, dense_fold="cuda", device=dev)
    try:
        torch.cuda.synchronize()
        KN.reset_launches()
        t0 = time.perf_counter()
        for c in chunks:
            sks.submit(c)
        sks.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(KN.LAUNCHES)
        shapes = KN.SHAPES["merge_elems"] + KN.SHAPES["merge_counters"]
        sub_keys, want = oracle
        mism = W.compare_canonical(sks.canonical(keys=sub_keys), want)
        mats = [D.state_digest_matrix(s, D.DIGEST_FANOUT, 1)
                for s in sks.stores]
        digest = int(D.sum_matrices(mats, D.DIGEST_FANOUT, 1).sum(
            dtype=np.uint64))
        secs = sks.host_secs_per_shard()
    finally:
        sks.close()
    if mism:
        raise AssertionError(f"{label}: {mism} of {len(sub_keys)} keys "
                             "differ from the CPU oracle")
    if digest != want_digest:
        raise AssertionError(f"{label}: summed shard digest {digest:#x}, "
                             f"phase 5's store {want_digest:#x}")
    k_names = ("merge_elems", "merge_counters", "segment_sum")
    if any(launches[k] < 4 for k in k_names) or \
            any(sh[0] != n_rep for sh in shapes):
        raise AssertionError(f"{label}: launches {launches}, K1/K2 shapes "
                             f"{shapes}; each of K1, K2 and K4 must launch "
                             f"in every shard, every stack with R = {n_rep}")
    out = {"wall_s": wall, "keys_per_s": n_keys / wall,
           "launches": launches, "folds": [x["folds"] for x in secs],
           "verified_keys": len(sub_keys), "mismatches": mism,
           "digest": digest}
    log(f"{label}: {len(chunks)} chunks in groups of {n_rep}: {wall:.3f} s "
        f"({out['keys_per_s']:.0f} keys/s), launches {launches}, folds "
        f"per shard {out['folds']}, every K1/K2 stack R = {n_rep}; "
        f"verified {len(sub_keys)} keys, 0 mismatches; summed shard "
        f"digest {digest:#x} equals phase 5's store's")
    return out


def corrupt_check(dev, directory: str, seed: int) -> None:
    """A small snapshot file with raw (uncompressed) sections loads
    through load_snapshot on the card; a copy with one byte of a bulk
    column flipped raises InvalidSnapshotChecksum."""
    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.errors import InvalidSnapshotChecksum
    from constdb_tpu_torch.persist.snapshot import (load_snapshot,
                                                    write_snapshot_file)
    from constdb_tpu_torch.store.keyspace import KeySpace
    n = 2000
    b = W.make_workload(n, 1, seed=seed)[0]
    path = os.path.join(directory, "small.snapshot")
    write_snapshot_file(path, W.replica_meta(0), [], [b], chunk_keys=1024,
                        compress_level=0)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    at = data.find(b.key_ct[:32].tobytes())
    if at < 0:
        raise AssertionError("corrupt check: key_ct column not found raw")
    data[at + 100] ^= 0x01
    bad = path + ".flipped"
    with open(bad, "wb") as f:
        f.write(data)
    ks = KeySpace()
    meta, _ = load_snapshot(path, ks, device=dev)
    checked, mism = W.verify_store(ks, [b], n)
    if meta != W.replica_meta(0) or mism:
        raise AssertionError(f"corrupt check: the clean file loaded {meta}, "
                             f"{mism} of {checked} keys off")
    try:
        load_snapshot(bad, KeySpace(), device=dev)
    except InvalidSnapshotChecksum:
        pass
    else:
        raise AssertionError("corrupt check: a flipped key_ct byte loaded "
                             "without InvalidSnapshotChecksum")
    log(f"snapshot files: a {len(data)}-byte file loads through "
        f"load_snapshot on the card ({checked} keys verified); with byte "
        f"{at + 100} (key_ct column) flipped it raises "
        "InvalidSnapshotChecksum")


def same_reads(got, want) -> bool:
    """Bit equality of two tensor reads, a NaN matching any NaN (IEEE
    leaves a result NaN's sign and payload open)."""
    import numpy as np
    if got is None or want is None:
        return got is None and want is None
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    nan = np.isnan(got) & np.isnan(want)
    ui = np.dtype(f"u{got.dtype.itemsize}")
    return bool(np.array_equal(got.view(ui)[~nan], want.view(ui)[~nan]))


def placement_shares(eng) -> dict:
    """The steady rounds and rows each family merged on its host twin
    and in place on the device ([host, device]), and the host's share of
    each family's rows."""
    rows = {f: list(v) for f, v in eng.micro_rows.items() if sum(v)}
    return {"micro_rounds": {f: list(v) for f, v in eng.micro_rounds.items()
                             if sum(v)},
            "micro_rows": rows,
            "host_row_share": {f: v[0] / sum(v) for f, v in rows.items()}}


def check_placement(label: str, eng) -> None:
    """Past the warm-up every family stays on the device: the barriers'
    writes are key-confined, so they patch the mirrors (no rebuild), and
    no family merges on its host twin in more rounds than the warm-up."""
    host = {f: v[0] for f, v in eng.micro_rounds.items()
            if v[0] > eng.warmup}
    if host or any(eng.mirror_rebuilds.values()):
        raise AssertionError(f"{label}: host rounds past the warm-up of "
                             f"{eng.warmup}: {host}, mirror rebuilds "
                             f"{eng.mirror_rebuilds}")


def replication_phase(dev, n_frames: int, stream_keys: int) -> dict:
    """Phase 10: a peer's replication stream through the port's Node on
    the card.  (a) RESP bytes -> make_parser -> CoalescingApplier (512
    frames, 5 ms) -> group encoders, barriers through the per-key op
    path -> K3 rounds, against the per-frame replay through a CPU-engine
    Node; (b) the same ops as the push loop ships them (REPLBATCH runs
    and single frames) into a fresh card Node, canonical equal to (a)'s;
    (c) tset contributions from 8 peers, then Node.tensor_read of every
    key (K5), bit-equal to a CPU node's reads."""
    import torch

    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.engine.cpu import CpuMergeEngine
    from constdb_tpu_torch.ops import kernels as KN
    from constdb_tpu_torch.replica.coalesce import CoalescingApplier
    from constdb_tpu_torch.replica.manager import ReplicaMeta
    from constdb_tpu_torch.resp.codec import RespParser, make_parser
    from constdb_tpu_torch.server.node import Node

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    frames = W.make_frame_log(n_frames, stream_keys)
    data = W.frame_log_bytes(frames)
    t_gen = time.perf_counter() - t0
    barriers_in_log = sum(f[4].val == b"delset" for f in frames)

    def timed(spent: dict, name: str, fn):
        """fn, with its seconds added to spent[name]."""
        def call(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                spent[name] += time.perf_counter() - t
        return call

    def counted_flushes(eng):
        """Count the engine's flushes (Node.ensure_flushed calls it only
        with device state unflushed)."""
        n = [0]
        real = eng.flush

        def flush(store):
            n[0] += 1
            return real(store)

        eng.flush = flush
        return n

    # (a) coalesced apply of the RESP stream
    node = Node(node_id=1)
    eng = node.engine
    if not (eng.resident and eng.steady and eng.device == dev):
        raise AssertionError("replication: Node() did not build the "
                             "resident steady engine on the card")
    flushes = counted_flushes(eng)
    # where the span's host time goes: landing the coalesced batches
    # (finalize, the env-narrow flush check, the engine's merge), the
    # barriers (their full flush and the per-key op), the rest (parse,
    # intake, the group encoders); the parse alone is timed apart
    spent = {"land": 0.0, "barrier": 0.0}
    node.merge_stream_batch = timed(spent, "land", node.merge_stream_batch)
    node.apply_replicated = timed(spent, "barrier", node.apply_replicated)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    KN.reset_launches()
    applier, wall, lat = W.replay_stream(
        data, node, W.APPLY_BATCH, 0.005, sync=torch.cuda.synchronize)
    launches_a = dict(KN.LAUNCHES)
    peak_a = torch.cuda.max_memory_allocated(dev)
    st = node.stats
    lat.sort()
    a = {"frames": n_frames, "bytes": len(data), "wall_s": wall,
         "frames_per_s": n_frames / wall,
         "lat_p50_ms": 1e3 * lat[len(lat) // 2],
         "lat_p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
         "lat_samples": len(lat),
         "repl_coalesce_flushes": st.repl_coalesce_flushes,
         "repl_apply_barriers": st.repl_apply_barriers,
         "repl_frames_coalesced": st.repl_frames_coalesced,
         "delset_in_log": barriers_in_log,
         "dev_rounds_resident": eng.dev_rounds_resident,
         "host_micro_rounds": eng.host_micro_rounds,
         "k3_launches": launches_a["scatter_pair_src"],
         "engine_flushes": flushes[0],
         "mirror_rebuilds": dict(eng.mirror_rebuilds),
         "mirror_patches": dict(eng.mirror_patches),
         **placement_shares(eng),
         "bytes_h2d": eng.bytes_h2d, "h2d_copies": eng.h2d_copies,
         "bytes_d2h": eng.bytes_d2h, "peak_mem_bytes": peak_a,
         "family_secs": {k: round(v, 3) for k, v in eng.family_secs.items()},
         "land_s": spent["land"], "barrier_s": spent["barrier"],
         "parse_intake_encode_s": wall - spent["land"] - spent["barrier"],
         "engine_merge_s": st.merge_secs, "engine_flush_s": st.flush_secs,
         "gen_s": t_gen}
    # the parse alone, native (the span's) and pure
    for key, mk in (("parse_alone_s", make_parser),
                    ("parse_pure_s", RespParser)):
        t0 = time.perf_counter()
        parser = mk()
        for off in range(0, len(data), W.REPLAY_CHUNK):
            parser.feed(data[off:off + W.REPLAY_CHUNK])
            while parser.next_msg() is not None:
                pass
        a[key] = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = Node(node_id=1, engine=CpuMergeEngine())
    W.replay_stream(data, oracle, 1, 0.005)
    want = oracle.canonical()
    got = node.canonical()
    bad = W.compare_canonical(got, want)
    keys = list(want)
    bad_sums = W.compare_counter_sums(node.ks, oracle.ks, keys)
    a["oracle_s"] = time.perf_counter() - t0
    a["verified_keys"] = len(keys)
    if bad or bad_sums or len(got) != len(want):
        raise AssertionError(f"replication: {bad} of {len(keys)} keys and "
                             f"{bad_sums} counter sums differ from the "
                             f"per-frame replay ({len(got)} keys against "
                             f"{len(want)})")
    if applier.meta.uuid_he_sent != frames[-1][3].val:
        raise AssertionError("replication: the watermark stopped at "
                             f"{applier.meta.uuid_he_sent}")
    if st.repl_apply_barriers != barriers_in_log:
        raise AssertionError(f"replication: {st.repl_apply_barriers} "
                             f"barriers for {barriers_in_log} delset frames")
    rounds = eng.dev_rounds_resident
    if not rounds or launches_a["scatter_pair_src"] != rounds:
        raise AssertionError(f"replication: K3 launched "
                             f"{launches_a['scatter_pair_src']} times in "
                             f"{rounds} device rounds")
    check_placement("replication", eng)
    del oracle
    eng.close()
    del node, eng, applier
    log(f"replication (a): {n_frames} frames ({len(data)} RESP bytes) over "
        f"{stream_keys} keys per prefix through Node(node_id=1) on the "
        f"card, 512-frame batches, 5 ms: {wall:.3f} s "
        f"({a['frames_per_s']:.0f} frames/s), visibility p50 "
        f"{a['lat_p50_ms']:.3f} ms, p99 {a['lat_p99_ms']:.3f} ms; "
        f"host time: landing {a['land_s']:.3f} s (engine merge "
        f"{a['engine_merge_s']:.3f} s), barriers {a['barrier_s']:.3f} s "
        f"(engine flushes in all {a['engine_flush_s']:.3f} s), parse, "
        f"intake and group encoders {a['parse_intake_encode_s']:.3f} s "
        f"(the parse alone {a['parse_alone_s']:.3f} s, the pure parser "
        f"{a['parse_pure_s']:.3f} s); "
        f"{a['repl_coalesce_flushes']} coalesced flushes, "
        f"{a['repl_apply_barriers']} barriers, rounds on the device "
        f"{rounds} (K3 launches {launches_a['scatter_pair_src']}), on the "
        f"host {a['host_micro_rounds']}, engine flushes "
        f"{a['engine_flushes']}, mirror rebuilds {a['mirror_rebuilds']}, "
        f"patches {a['mirror_patches']}, rounds per family [host, device] "
        f"{a['micro_rounds']}, rows {a['micro_rows']}, "
        f"up {a['bytes_h2d']} B in {a['h2d_copies']} copies, peak "
        f"{peak_a} B; {len(keys)} keys and their counter sums equal to the "
        f"per-frame CPU replay {json.dumps(a)}")

    # (b) the same ops as REPLBATCH runs and single frames
    t0 = time.perf_counter()
    pusher = Node(node_id=W.STREAM_ORIGIN, engine=CpuMergeEngine(),
                  repl_log_cap=1 << 40)
    W.push_log(pusher, frames)
    wframes, wst = W.wire_frames(pusher)
    t_build = time.perf_counter() - t0
    del pusher
    node = Node(node_id=1)
    eng = node.engine
    spent = {"land": 0.0, "barrier": 0.0}
    node.merge_stream_batch = timed(spent, "land", node.merge_stream_batch)
    node.apply_replicated = timed(spent, "barrier", node.apply_replicated)
    torch.cuda.synchronize()
    KN.reset_launches()
    applier, wall_b, decode_s = W.wire_replay(
        wframes, node, sync=torch.cuda.synchronize)
    launches_b = dict(KN.LAUNCHES)
    b = {"wall_s": wall_b, "frames_per_s": n_frames / wall_b,
         "decode_s": decode_s, "build_s": t_build, **wst,
         "land_s": spent["land"], "barrier_s": spent["barrier"],
         "engine_merge_s": node.stats.merge_secs,
         "wire_frames": len(wframes),
         "dev_rounds_resident": eng.dev_rounds_resident,
         "host_micro_rounds": eng.host_micro_rounds,
         "k3_launches": launches_b["scatter_pair_src"],
         "mirror_rebuilds": dict(eng.mirror_rebuilds),
         "mirror_patches": dict(eng.mirror_patches),
         **placement_shares(eng),
         "repl_wire_batches_in": node.stats.repl_wire_batches_in,
         "repl_apply_barriers": node.stats.repl_apply_barriers}
    if node.canonical() != got:
        raise AssertionError("replication (b): the wire replay's state "
                             "differs from (a)'s")
    if wst["batch_frames"] + wst["single_frames"] != n_frames or \
            node.stats.repl_wire_batches_in != wst["batches"]:
        raise AssertionError(f"replication (b): {wst} for {n_frames} "
                             "frames")
    if not eng.dev_rounds_resident or \
            launches_b["scatter_pair_src"] != eng.dev_rounds_resident:
        raise AssertionError(f"replication (b): K3 launched "
                             f"{launches_b['scatter_pair_src']} times in "
                             f"{eng.dev_rounds_resident} device rounds")
    check_placement("replication (b)", eng)
    eng.close()
    del node, eng, applier, got, want, frames, data, wframes
    log(f"replication (b): the ops as the push loop ships them, "
        f"{wst['batches']} REPLBATCH frames ({wst['batch_frames']} ops, "
        f"{wst['payload_bytes']} payload bytes) and "
        f"{wst['single_frames']} single frames, built in {t_build:.3f} s "
        f"outside the span, into a fresh card Node: {wall_b:.3f} s "
        f"({b['frames_per_s']:.0f} frames/s), decode {decode_s:.3f} s, "
        f"landing {b['land_s']:.3f} s (engine merge "
        f"{b['engine_merge_s']:.3f} s), barriers {b['barrier_s']:.3f} s; "
        f"rounds per family [host, device] {b['micro_rounds']}, rows "
        f"{b['micro_rows']}; canonical equal to (a)'s {json.dumps(b)}")

    # (c) tensor contributions from 8 peers, reads through the node
    n_peers, n_rounds, n_keys, elems = 8, 3, 128, 4096
    peers = W.tensor_peer_frames(n_peers, n_rounds, n_keys, elems)
    node = Node(node_id=1)
    eng = node.engine
    cpu = Node(node_id=1, engine=CpuMergeEngine())

    def feed(nd):
        aps = [CoalescingApplier(nd, ReplicaMeta(f"peer{p}:0"),
                                 max_frames=W.APPLY_BATCH, max_latency=1e9)
               for p in range(n_peers)]
        for r in range(n_rounds):
            for p, ap in enumerate(aps):
                for items in peers[p][r]:
                    ap.apply(items)
                ap.flush()

    torch.cuda.synchronize()
    KN.reset_launches()
    t0 = time.perf_counter()
    feed(node)
    kids = [node.ks.lookup(b"t%06d" % k) for k in range(n_keys)]
    reads = [node.tensor_read(kid) for kid in kids]
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    launches_c = dict(KN.LAUNCHES)
    feed(cpu)
    bad = sum(not same_reads(got, cpu.ks.tensor_read(cpu.ks.lookup(
        b"t%06d" % k))) for k, got in enumerate(reads))
    if bad or node.canonical() != cpu.canonical():
        raise AssertionError(f"replication (c): {bad} of {n_keys} tensor "
                             "reads or the state differ from the CPU node")
    if not launches_c["tensor_take_reduce"] or not eng.tns_dev_rows:
        raise AssertionError(f"replication (c): K5 launches "
                             f"{launches_c['tensor_take_reduce']}, rows "
                             f"on the device {eng.tns_dev_rows}")
    rows = n_peers * n_rounds * n_keys
    c = {"wall_s": wall_c, "rows": rows, "rows_per_s": rows / wall_c,
         "reads": n_keys, "k5_launches": launches_c["tensor_take_reduce"],
         "tns_dev_rows": eng.tns_dev_rows,
         "tns_host_rows": eng.tns_host_rows}
    eng.close()
    del node, eng, cpu, peers
    log(f"replication (c): {n_peers} peers x {n_rounds} rounds x {n_keys} "
        f"tset frames of {elems} f32 through one CoalescingApplier each, "
        f"then Node.tensor_read of every key: {wall_c:.3f} s; K5 launched "
        f"{c['k5_launches']} times; reads bit-equal to the CPU node's "
        f"{json.dumps(c)}")
    secs = time.perf_counter() - t_phase
    log(f"replication: phase {secs:.1f} s")
    launches = {"replication": {k: launches_a[k] + launches_c[k]
                                for k in launches_a},
                "wire": launches_b}
    return {"a": a, "b": b, "c": c, "launches": launches, "secs": secs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--frames", type=int, default=200_000)
    ap.add_argument("--stream-keys", type=int, default=20_000)
    args = ap.parse_args()
    t_start = time.perf_counter()

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

    from constdb_tpu_torch import workload as W
    widths = W.fold_widths(args.keys, args.seed, CHUNK_KEYS)
    recs = kernel_phase(dev, args.seed, args.replicas, widths)
    recs.update(steady_kernel_phase(dev, args.seed, args.stream_keys))
    log(f"kernels: SM clock, max SM clock after timing: {sm_clock()}")
    for name, r in recs.items():
        for c in r.get("cases", [r]):
            lib = c.get("library_ms", r["library_ms"])
            lib = "n/a" if lib is None else f"{lib:.4f}"
            what = " ".join(str(c[k]) for k in ("case", "strategy", "dtype")
                            if k in c)
            more = "".join(f", {k[:-3]} {c[k]:.4f} ms" for k in
                           ("separate_ms", "chain_ms", "clean_ms",
                            "floor_ms") if k in c)
            log(f"kernels: {name} {c['shape']} {what} bit-equal to plain; "
                f"kernel {c['ms']:.4f} ms{more}, plain {c['plain_ms']:.4f} "
                f"ms, library {lib} ms, bound {c['bound_ms']:.3g} ms "
                f"({c['bound_by']}, {c['bound_ms'] / c['ms']:.0%} of it)")

    rep = args.replicas
    auto, eng, store, catch_batches = catchup(
        dev, args.keys, rep, args.seed, 4 * rep, "auto", False,
        "catch-up (auto)")
    fold, eng2, store2, _ = catchup(
        dev, args.keys, rep, args.seed, rep, "cuda", True,
        "catch-up (device fold)")
    eng2.close()
    fold_digest = full_state_digest(store2)
    del eng2, store2, _
    for k in ("merge_elems", "merge_counters"):
        if not fold["launches"][k]:
            raise AssertionError(f"catch-up (device fold) did not launch {k}")
    want = sorted([[rep, w, "elements"] for w in widths["el"]] +
                  [[rep, w, "registers"] for w in widths["reg"]])
    if sorted(fold["k1_shapes"]) != want:
        raise AssertionError(f"catch-up (device fold): K1 ran on "
                             f"{fold['k1_shapes']}, phase 3 timed {want}")
    # after both timed catch-ups, so no profiler run precedes them;
    # phase 4's engine only: a profiler run around phase 5's engine
    # once saw no device events at all
    sums_profile(eng, store, "catch-up (auto)")
    stream = stream_phase(dev, eng, store, catch_batches, args.keys,
                          args.frames, args.stream_keys, args.seed)
    del eng, store, catch_batches
    tensor = tensor_phase(dev)
    # phase 5's batches again, from its seed: they are not kept alive
    # through phases 6-7, and the files are written after them
    fold_batches = W.make_workload(args.keys, rep, seed=args.seed,
                                   aligned_counters=True)
    file_dir = tempfile.mkdtemp(prefix="constdb_chip_smoke_")
    try:
        paths = write_files(file_dir, fold_batches)
        files = file_phase(dev, args.keys, rep, args.seed, fold, paths,
                           fold_batches)
        corrupt_check(dev, file_dir, args.seed)
        oracle = (W.subsample_keys(fold_batches[0].keys, args.keys),
                  W.oracle_canonical(fold_batches, args.keys))
        sharded = sharded_phase(dev, args.keys, rep, paths, fold_batches,
                                oracle, files["digest"])
        local = local_phase(dev, args.keys, rep, fold_batches, oracle,
                            fold_digest)
    finally:
        shutil.rmtree(file_dir, ignore_errors=True)
    del fold_batches
    repl = replication_phase(dev, args.frames, args.stream_keys)

    replaces = {
        "merge_elems": "constdb_tpu/ops/pallas_dense.py:105",
        "merge_counters": "constdb_tpu/ops/pallas_dense.py:152",
        "scatter_pair_src": "constdb_tpu/ops/pallas_dense.py:256",
        "segment_sum": "constdb_tpu/ops/pallas_dense.py:433",
        "tensor_take_reduce": "constdb_tpu/ops/pallas_dense.py:380"}
    source = {"merge_elems": "constdb_tpu_torch/csrc/merge_fold.cu",
              "merge_counters": "constdb_tpu_torch/csrc/merge_fold.cu",
              "scatter_pair_src": "constdb_tpu_torch/csrc/scatter_pair.cu",
              "segment_sum": "constdb_tpu_torch/csrc/segment_sum.cu",
              "tensor_take_reduce":
              "constdb_tpu_torch/csrc/tensor_reduce.cu"}
    kernels = []
    for name, r in recs.items():
        by_path = {"catchup_auto": auto["launches"][name],
                   "catchup_fold": fold["launches"][name],
                   "stream": stream["launches"][name],
                   "tensor": tensor["launches"][name],
                   "catchup_files": files["launches"][name],
                   "sharded_process": sharded["launches"][name],
                   "sharded_local": local["launches"][name],
                   "replication": repl["launches"]["replication"][name],
                   "wire": repl["launches"]["wire"][name]}
        rec = {
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]}
        if "cases" in r:
            rec["cases"] = r["cases"]
        kernels.append(rec)
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
