#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (constdb_tpu_torch) on one GPU.

    python3 chip_smoke.py [--keys N] [--replicas R] [--seed S]
                          [--frames F] [--stream-keys K] [--serve-ops O]
                          [--phases all|server|cluster|chaos|multi]
                          [--chaos-journal PATH]

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
 11. the server    (a) the server entry's `amain` (what python -m
               constdb_tpu_torch.bin.server runs) in a spawned process
               on the card, booted from one snapshot file of phase 5's
               replica 0 (NodeMeta(node_id=1), written during phase 8),
               serving bench.py --mode serve's traffic (O ops over 4
               pipelined connections, 64-deep, 2,000 keys each, seed 13)
               and then a tensor leg (tensor.set / tensor.merge /
               tensor.get, 5 strategies x 128 keys x 4096 f32), over
               sockets; INFO read after the traffic; SIGTERM (the final
               dump) once the GC has collected every tombstone.  The
               same traffic through a per-command CPU-engine node
               (--engine cpu, CONSTDB_TORCH_SERVE_BATCH=1) that boots
               empty, run while (a) writes its dump, is the oracle: the traffic's keys disjoint from the
               restored ones, reply hashes per connection, the written
               keys' visible values and every tensor.get reply (a NaN
               matching any NaN) equal; the restored keys' digest
               unchanged; every family on its host twin in at most the
               warm-up; K3 launches of the traffic = its device rounds
               (> 0), K5 launches = the non-lww tensor.get count, the
               restore launched K4.  Logged: requests/s, reply-window
               p50/p99, coalesced, flushes, barriers, the restore's
               seconds, peak memory, the host spans of 50 ms or more
               inside the serve window (GC sweeps, flushes, device-round
               merges, Python's collector, event-loop stalls).  (b)
               python -m constdb_tpu_torch.bin.server --snapshot on a
               copy of (a)'s dump: sample reads equal to (a)'s, INFO
               (engine cuda, the device, dev_upload_bytes), SIGTERM (the
               dump runs beside (c)), its dump's digest equal to (a)'s.
               (c) another copy as node A and an empty node B, both
               booted beside (b): MEET, the full sync (seconds, keys/s,
               A's dump bytes, the apply path), 20,000 more ops into A
               reaching B through the push loop (REPLBATCH runs), both
               SIGTERM dumps' digests equal, B's K3 launches = its
               dev_rounds_resident > 0.  Every wait bounded, every
               process killed in a finally.
 12. the op log  (a) the server entry (a spawned aof_worker) with --aof
               --aof-fsync always, booted from a copy of 11's file,
               serving 11a's traffic with CONSTDB_TORCH_AOF_REWRITE_MIN_MB
               at 0.6 of the traffic's log (one rewrite), INFO polled
               until the rewrite is done, then SIGKILL: reply hashes
               equal to 11a's, K3 = the traffic's device rounds, a base
               snapshot written, the process gone; logged: requests/s and
               reply windows beside 11a's, fsyncs, the log's and the
               base's bytes, the rewrite's seconds (polled); (b) a fresh
               server on the same directory: every traffic key's visible
               value equal to 11a's oracle's, 11a's sample reads equal,
               the replay's K3 = its device rounds; logged: INFO's
               recovery seconds, source, mode, merge rounds, recovered
               ops, seconds per GB of log; (c) six copies of (a)'s
               directory recovered by oplog.recover in spawned processes
               side by side: serial and bulk on the card with equal
               canonical() (a hash) and full_state_digest, the bulk
               replay's flushes, K3 = its device rounds and K4; the
               newest segment's last op record cut in half (aof_tail_
               truncated 1) equal to the serial replay of the copy cut at
               the record's start; and the log alone (two copies with the
               base snapshot removed, no boot snapshot: "log-only") bulk
               on the CPU engine equal to serial on the card.
 13. serve shards with the op log  CONSTDB_TORCH_SERVE_SHARDS=2, --aof
               --aof-fsync always, no rewrite: (a) booted from a copy of
               11's file fanned out to 2 workers (each a CUDA engine),
               11a's traffic and tensor leg: replies and every tensor.get
               equal to 11a's, each worker's K3 = its device rounds
               (INFO's serve_shard<i>_* gauges), K5 = the non-lww
               tensor.get over the workers; logged: requests/s, peak
               device memory per worker; SIGKILL: every process of the
               server gone within 30 s, none among nvidia-smi's compute
               apps; (b) rebooted with the same flags and
               CONSTDB_TORCH_RECOVER_SHARDS=2: recovery_mode bulk+shards2
               from the boot snapshot and the whole log, the traffic and
               tensor keys' visible values equal to 11a's oracle's (and
               the traffic keys' to (12b)'s), sample reads equal, the
               processes gone after SIGKILL.
 14. cluster mode  every group server is the server entry's `amain` in a
               spawned process on the card (cluster_worker), with
               CONSTDB_TORCH_CLUSTER=1.  (a) bench.py --mode cluster's
               traffic at its defaults (120,000 ops over 4 connections,
               64-deep, 2,000 keys each, serve batch 512, seed 13)
               partitioned by slot owner under even_split(4) onto 4
               group servers, driven concurrently: the union of the
               groups' canonical() (visible values) equal to the same
               stream's through one cluster-on, single-group CPU-engine
               node (run while (b)'s group 0 boots), every connection's
               replies put back in order equal to the oracle's, zero
               redirects, each group's K3 = its device rounds (> 0);
               logged: the envelope's and each group's requests/s, reply
               windows p50/p99, each group's peak memory.  (b) group 0
               booted from 11's 1M-key file with 2 slot groups, group 1
               empty; CLUSTER MIGRATE 0 128 <group 1> sent to group 0 and
               CLUSTER INFO polled to its end; bench.py's checks (epochs
               1 + 128 on both, 128 migrations out and in, nothing left
               migrating or importing, no GC pin, a moved key served by
               the target and MOVED on the source, the shipped bytes at
               most the range's bytes x rounds per slot x 1.5, the range
               under a quarter of the whole state), each moved slot's
               digest on the target equal to the source's before
               MIGRATE, the range's export captured before MIGRATE and
               merged by the CPU engine into an empty store equal to the
               target's canonical(), then 300 writes to moved keys on
               the target, pipelined in chunks of 50, read back (K3 = its
               device rounds, > 0);
               logged: the wall, seconds per slot split into export,
               encode, IMPORT calls (the target's merges), SLOTDIGEST
               calls and FINALIZE, the target's mirror rebuilds and
               patches, the launches.  (c) a NearCacheClient on group 0,
               around (b): another connection's write invalidates its
               cached key, its own write drops the key locally, the
               slots_lost push invalidates the key of a moved slot alone
               (flush-all never), a reconnect flushes the cache.
 15. chaos     the port's chaos certification harness
               (constdb_tpu_torch/chaos) in this process: the 8 card
               cells of matrix_cells() (engines "torch" and
               "torch-resident", wire on and off, delta on and off),
               each certify_scenario(7, cell, ops=30) with device cuda:
               three nodes in one event loop under the seeded fault
               plane (partitions, delay, reorder, duplication, a
               mid-frame cut, connection kills, a corrupt REPLBATCH,
               cold and warm restarts, clock jumps, a CPU-engine
               mixed-version peer), certified by the harness's oracle
               (canonicals equal to the CPU-engine replay of the
               journal after GC drains, digest matrices, watermark
               monotonicity, no resurrection, fault accounting).
               Checks, through wrappers of NodeSpec.build_engine, the
               scenario's OpJournal and certify_state: every fast-path
               engine a cell built (restarts included) a
               TorchMergeEngine on cuda, node 2's the CPU engine; in a
               torch-resident cell K3 = the card engines' device
               rounds > 0; in every cell some kernel launched; logged a
               line a cell (seconds, journal ops, reconnects, the
               plane's counters, launches, peak device memory, the
               certified canonical's hash).  --chaos-journal writes the
               first torch-resident cell's journal for
               scripts/chaos_ref_replay.py (the reference's oracle
               replays it on the CPU, off the card).
 16. multi     the multi-device merge on the one card: (a) the port's
               invariant lint, `python -m constdb_tpu_torch.analysis
               --baseline --json` over the checkout: exit 0, zero
               findings, its seconds; (b) phase 5's catch-up (its
               batches made again from its seed, groups of R,
               dense_fold="cuda") through TorchMergeEngine(resident=True,
               devices=[cuda:0] x 4), the kv range-partitioned engine:
               full_state_digest equal to phase 5's, the ~100k-key
               oracle subsample equal (phase 9's), every partition's
               columns on its device holding exactly its range of the
               plane (checked against the flushed host columns, pad rows
               neutral; sizes logged), K1, K2 and K4 launched in every
               partition (per-partition calls summing to the kernels'
               launch counts), the re-splits, keys/s beside phase 5's,
               peak device memory; (c) the rep x kv step
               (parallel/sharded.py) over NCCL with world size 1 at
               R = 8, S = 2^20 (env [R, S, 4]) bit-equal to the plain
               dense ops on the card, its all-reduce count, the process
               group destroyed; then entry.dryrun_multichip(1).  Logged:
               the phase's seconds (target 60).
`--phases server` runs phases 11-13 alone on phase 5's replica 0,
`--phases cluster` phase 14 alone, `--phases chaos` phase 15 alone and
`--phases multi` phase 5 then phase 16 (no kernels line, no result
line).
Every catch-up logs the tier of its store's staging tables and fails
unless all are native, and counts the read-only columns the engine
copies before pinning.  Then one JSON line of kernel records (launches
by path, phase 8's as "catchup_files", phase 9's as "sharded_process"
(the workers' and the parent's) and "sharded_local", phase 10's as
"replication" (a and c) and "wire" (b), phase 11's as "serve" (a's
traffic, c's ops into A), "restore" (the three boots from a dump),
"sync" (B since its boot), phase 12's as "aof" (a and b's servers, c's
card recoveries), phase 13's as "shards" (the servers' parents and
workers), phase 14's as "cluster" (every group server) and phase 15's
as "chaos" (the 8 cells) and phase 16's as "multi"), the run's total
seconds, the nvidia-smi
line, and the last line {"ok": true, "device": {...}}.

Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import gc
import inspect
import json
import os
import shutil
import signal
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

    def h2d_counted(arr, *args, **kw):
        if isinstance(arr, np.ndarray) and arr.flags.c_contiguous and \
                not arr.flags.writeable:
            ro["copies"] += 1
            ro["bytes"] += arr.nbytes
        return real_h2d(arr, *args, **kw)

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
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
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


# ------------------------------------------------------------- phase 11

SERVE_CONNS = 4             # bench.py --mode serve's defaults
SERVE_PIPELINE = 64
SERVE_KEYS = 2000
SERVE_SEED = 13
SERVE_WAIT_S = 120.0        # every wait of phase 11 is bounded
TENSOR_STRATS = ("sum", "maxmag", "trimmed-mean", "avg", "lww")
TENSOR_KEYS, TENSOR_ELEMS = 128, 4096   # phase 7's shape


def write_boot_file(path: str, batch) -> int:
    """Phase 5's replica 0 as one snapshot file, NodeMeta(node_id=1): the
    11a node boots from it.  -> bytes."""
    from constdb_tpu_torch.persist.snapshot import (NodeMeta,
                                                    write_snapshot_file)
    return write_snapshot_file(path, NodeMeta(node_id=1), [], [batch],
                               chunk_keys=CHUNK_KEYS)


def serve_worker(conn, argv: list, env: dict) -> None:
    """11a's server process (spawned): the port's server entry, the same
    `amain` `python -m constdb_tpu_torch.bin.server` runs.  Sends
    {"port", boot numbers} once the node serves; on SIGTERM `amain`
    writes its final dump and returns, and the worker sends the
    launches, the engine's counters, the canonical of the keys written
    after the boot and the restored keys' digest."""
    import asyncio
    import traceback

    os.environ.update(env)
    try:
        import torch

        from constdb_tpu_torch.bin.server import amain
        from constdb_tpu_torch.conf import load_config
        from constdb_tpu_torch.ops import kernels as KN
        from constdb_tpu_torch.store.digest import key_range_digest

        cfg = load_config(argv)
        cuda = cfg.engine == "cuda" and cfg.device == "cuda"
        box = {}
        t0 = time.perf_counter()

        def started(app):
            node = app.node
            # the cron's first tick and GC sweep, run here: they collect
            # the restored tombstones, so the digest below is the state
            # serving must leave unchanged
            node.hlc.tick(False)
            node.gc()
            n = node.ks.keys.n
            box["spans"], box["probe"] = host_spans(node)
            box.update(app=app, n=n, digest=key_range_digest(node.ks, 0, n),
                       boot={"launches": dict(KN.LAUNCHES),
                             "shapes": {k: list(v) for k, v in
                                        KN.SHAPES.items()}})
            conn.send({"port": app.port, "boot_s": time.perf_counter() - t0,
                       "restored_keys": n,
                       "recovery_wall_s": node.stats.extra.get(
                           "recovery_wall_s", 0.0),
                       "restore_launches": box["boot"]["launches"],
                       "boot_rounds": getattr(node.engine,
                                              "dev_rounds_resident", 0),
                       "restore_shapes": box["boot"]["shapes"]})

        asyncio.run(amain(cfg, started))
        node = box["app"].node
        eng = node.engine
        n = box["n"]
        st = node.stats
        res = {"launches": dict(KN.LAUNCHES),
               "digest": full_state_digest(node.ks),
               "keys": node.ks.n_keys(),
               "digest_before": box["digest"],
               "digest_after": key_range_digest(node.ks, 0, n),
               "canonical": node.ks.canonical(node.ks.key_bytes[n:]),
               "stats": {k: getattr(st, k) for k in (
                   "serve_msgs_coalesced", "serve_flushes", "serve_barriers",
                   "serve_reads_coalesced", "serve_read_flushes",
                   "native_intake_chunks", "native_intake_msgs",
                   "cmds_processed")},
               "read_cache": [node.read_cache.hits, node.read_cache.misses],
               "merge_s": st.merge_secs, "flush_s": st.flush_secs,
               "gc_freed": st.gc_freed, "spans": box["spans"]}
        for k in ("dev_rounds_resident", "host_micro_rounds", "tns_dev_rows",
                  "tns_host_rows", "bytes_h2d", "bytes_d2h", "h2d_copies",
                  "warmup"):
            res[k] = getattr(eng, k, None)
        for k in ("micro_rounds", "micro_rows", "mirror_rebuilds",
                  "mirror_patches", "family_secs"):
            v = getattr(eng, k, None)
            res[k] = {f: (list(x) if isinstance(x, (list, tuple)) else x)
                      for f, x in v.items()} if v is not None else None
        if cuda:
            res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        conn.send(res)
    except BaseException as e:  # the parent raises it
        conn.send({"error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()})
    finally:
        conn.close()


SPAN_MIN_S = 0.05           # host spans kept one by one from this long


def host_spans(node) -> list:
    """The 11a worker's host spans: each GC sweep, whole or planned
    flush and device-round merge of `node` (timed through its methods),
    each collection of Python's collector and each stall of the event
    loop (a 5 ms sleep that woke late).  -> (the list that fills with
    [kind, start, seconds] for every span of SPAN_MIN_S or more, the
    loop probe's task).  time.perf_counter is the same clock in every
    process of the machine."""
    import asyncio
    import gc

    out = []

    def timed(kind, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                if dt >= SPAN_MIN_S:
                    out.append([kind, t0, dt])
        return run

    for kind in ("gc", "ensure_flushed", "ensure_flushed_for",
                 "merge_serve_batch"):
        setattr(node, kind, timed(kind, getattr(node, kind)))
    started = {}

    def collector(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            dt = time.perf_counter() - started.pop("t")
            if dt >= SPAN_MIN_S:
                out.append([f"python_gc{info['generation']}",
                            time.perf_counter() - dt, dt])
    gc.callbacks.append(collector)

    async def loop_lag():
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(0.005)
            late = time.perf_counter() - t0 - 0.005
            if late >= SPAN_MIN_S:
                out.append(["loop_stall", t0, late])
    # the loop holds its tasks weakly: the caller keeps this one
    return out, asyncio.get_running_loop().create_task(loop_lag())


def span_summary(spans: list, lo: float, hi: float) -> dict:
    """Per kind, the spans that overlap [lo, hi]: count, seconds in all,
    the longest."""
    out = {}
    for kind, t0, dt in spans:
        if t0 > hi or t0 + dt < lo:
            continue
        c = out.setdefault(kind, {"n": 0, "s": 0.0, "max_s": 0.0})
        c["n"] += 1
        c["s"] += dt
        c["max_s"] = max(c["max_s"], dt)
    return out


def tensor_chunks(seed: int = 17) -> tuple:
    """The tensor leg: per strategy 128 keys x 4096 f32, a tensor.set and
    a tensor.merge each (seeded payloads), then a tensor.get of each key.
    -> (write commands, read commands, read strategies)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    writes, reads, strats = [], [], []
    for s in TENSOR_STRATS:
        for k in range(TENSOR_KEYS):
            key = b"t:%s:%03d" % (s.encode(), k)
            a, b = (rng.standard_normal((2, TENSOR_ELEMS)) * 4).astype(
                np.float32)
            writes += [(b"tensor.set", key, s.encode(), b"f32",
                        b"%d" % TENSOR_ELEMS, a.tobytes(), b"2"),
                       (b"tensor.merge", key, b.tobytes(), b"3")]
            reads.append((b"tensor.get", key))
            strats.append(s)
    return writes, reads, strats


def sample_reads(n_restored: int) -> list:
    """Reads of a sample of 11a's written keys and of the restored keys
    (the ids of make_workload's counters, registers and sets)."""
    cmds = []
    for c in range(SERVE_CONNS):
        for i in range(0, SERVE_KEYS, 97):
            k = b"c%d:%05d" % (c, i)
            cmds += [(b"get", b"r" + k), (b"get", b"c" + k),
                     (b"smembers", b"s" + k), (b"hgetall", b"h" + k)]
    for i in range(0, n_restored, max(1, n_restored // 64)):
        k = b"k%010d" % i
        cmds += [(b"get", k), (b"smembers", k)]
    return cmds


def info_of(port: int) -> dict:
    """INFO over the socket as {field: text}."""
    import asyncio

    from constdb_tpu_torch import workload as W
    txt = asyncio.run(W.request(port, [(b"info",)]))[0].val.decode()
    return dict(ln.split(":", 1) for ln in txt.split("\r\n")
                if ln and not ln.startswith("#"))


def wait_collected(port: int, label: str) -> dict:
    """Poll INFO until the GC has collected every tombstone (bounded):
    the dumps and exports compared in phase 11 must not depend on when
    each node's cron swept.  -> the last INFO."""
    t0 = time.perf_counter()
    while True:
        info = info_of(port)
        if info["pending_tombstones"] == "0":
            return info
        if time.perf_counter() - t0 > SERVE_WAIT_S:
            raise AssertionError(f"server ({label}): "
                                 f"{info['pending_tombstones']} tombstones "
                                 f"left after {SERVE_WAIT_S} s")
        time.sleep(0.1)


def info_launches(info: dict) -> dict:
    """INFO's device_kernel_launches line as {kernel: launches}."""
    return {k: int(v) for k, v in (kv.split("=") for kv in
                                   info["device_kernel_launches"].split(","))}


def dump_digest(dev, path: str) -> tuple:
    """A dump loaded into a fresh store through a resident engine on
    `dev`, then its full_state_digest (numpy, on the host).
    -> (digest, keys)."""
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine
    from constdb_tpu_torch.persist.snapshot import load_snapshot
    from constdb_tpu_torch.store.keyspace import KeySpace
    eng = TorchMergeEngine(resident=True, device=dev)
    ks = KeySpace()
    load_snapshot(path, ks, engine=eng)
    eng.flush(ks)
    out = (full_state_digest(ks), ks.n_keys())
    eng.close()
    return out


def served_leg(argv: list, env: dict, per_conn: list, tensor: tuple,
               reads: list, while_stopping=None) -> dict:
    """One 11a server (spawned serve_worker): the serve traffic, the
    tensor leg and the sample reads over sockets, then SIGTERM.
    `while_stopping()`, when given, runs while the worker writes its
    final dump; its result is returned under "while_stopping".
    -> the worker's numbers with the client's."""
    import asyncio
    import multiprocessing as mp

    from constdb_tpu_torch import workload as W
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=serve_worker, args=(child, argv, env))
    t_leg = time.perf_counter()
    proc.start()
    child.close()
    try:
        if not parent.poll(SERVE_WAIT_S):
            raise AssertionError("server (11a): not up in time")
        up = parent.recv()
        if "error" in up:
            raise AssertionError(f"server (11a): {up['error']}\n"
                                 f"{up['traceback']}")
        port = up["port"]
        t0_serve = time.perf_counter()
        rtts, hashes = asyncio.run(asyncio.wait_for(
            W.serve_drive(port, per_conn), SERVE_WAIT_S))
        wall = time.perf_counter() - t0_serve
        info_serve = info_of(port)
        writes, treads, _ = tensor
        t0 = time.perf_counter()
        tw = asyncio.run(W.request(port, writes, timeout=SERVE_WAIT_S))
        tr = asyncio.run(W.request(port, treads, timeout=SERVE_WAIT_S))
        tensor_s = time.perf_counter() - t0
        sample = asyncio.run(W.request(port, reads, timeout=SERVE_WAIT_S))
        info = wait_collected(port, "11a")
        proc.terminate()            # SIGTERM: the entry's final dump
        during = while_stopping() if while_stopping else None
        if not parent.poll(SERVE_WAIT_S):
            raise AssertionError("server (11a): no result after SIGTERM")
        res = parent.recv()
        if "error" in res:
            raise AssertionError(f"server (11a): {res['error']}\n"
                                 f"{res['traceback']}")
        proc.join(timeout=SERVE_WAIT_S)
        if proc.exitcode != 0:
            raise AssertionError(f"server (11a): exit {proc.exitcode}")
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
        parent.close()
    rtts.sort()
    res.update(up)
    res.update(leg_s=time.perf_counter() - t_leg, wall_s=wall,
               serve_window=(t0_serve, t0_serve + wall), rtts=rtts,
               hashes=hashes, tensor_writes=tw, tensor_reads=tr,
               tensor_s=tensor_s, sample=sample, info_serve=info_serve,
               info=info, while_stopping=during)
    return res


def server_phase(dev, boot_path: str, work: str, n_ops: int,
                 n_restored: int) -> dict:
    """Phase 11: the node's server on the card.  (a) 11a: the server
    entry's `amain` in a spawned process, booted from one 1M-key snapshot
    file (phase 5's replica 0), serving bench.py --mode serve's traffic
    over 4 pipelined connections and then the tensor leg, held to the
    same traffic through a per-command CPU-engine node that boots empty
    (run while 11a's worker writes its final dump); that dump is (b)
    11b's boot: `python -m constdb_tpu_torch.bin.server --snapshot`
    restarted on a copy of it, reads and INFO over the socket, its own
    SIGTERM dump's digest equal to 11a's; (c) 11c: node A on another copy
    of the same dump, booted beside 11b's node and an empty node B: MEET,
    the full sync, 20,000 more ops of the mix reaching B through the push
    loop, the two dumps' digests equal.  11b's node writes its dump while
    11c syncs; the dumps' digests are read on threads."""
    import asyncio
    from concurrent.futures import ThreadPoolExecutor

    from constdb_tpu_torch import workload as W
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    per_conn = [W.serve_workload(c, n_ops // SERVE_CONNS, SERVE_KEYS,
                                 SERVE_PIPELINE, seed=SERVE_SEED)
                for c in range(SERVE_CONNS)]
    tensor = tensor_chunks()
    dump_a = os.path.join(work, "a.snapshot")
    shutil.copy(boot_path, dump_a)
    base = ["--port", "0", "--log-level", "warning", "--node-id", "1"]
    reads = sample_reads(n_restored)

    # the oracle: the same traffic, per command, CPU engine, booted
    # empty; it runs while 11a's worker writes its final dump
    def oracle_leg():
        t0 = time.perf_counter()
        out = served_leg(base + ["--engine", "cpu", "--work-dir",
                                 os.path.join(work, "oracle")],
                         {"CONSTDB_TORCH_SERVE_BATCH": "1"}, per_conn,
                         tensor, [])
        out["oracle_s"] = time.perf_counter() - t0
        return out

    # 11a
    a = served_leg(base + ["--device", dev.type, "--snapshot", dump_a,
                           "--work-dir", os.path.join(work, "a")],
                   {}, per_conn, tensor, reads, while_stopping=oracle_leg)
    oracle = a["while_stopping"]
    oracle_s = oracle["oracle_s"]
    if a["restored_keys"] != n_restored:
        raise AssertionError(f"server (11a): {a['restored_keys']} keys "
                             f"restored of {n_restored}")
    # checks of 11a: state and replies first, the launches after
    bad_keys = [k for k in oracle["canonical"] if k.startswith(b"k")]
    if bad_keys or oracle["restored_keys"] != 0:
        raise AssertionError(f"server (11a): the traffic's keys overlap the "
                             f"restored ones: {bad_keys[:5]}")
    if a["hashes"] != oracle["hashes"]:
        raise AssertionError("server (11a): reply hashes differ from the "
                             "per-command CPU node's")
    got = W.strip_canonical_times(a["canonical"])
    want = W.strip_canonical_times(oracle["canonical"])
    if got != want:
        diff = [k for k in set(got) | set(want) if got.get(k) != want.get(k)]
        raise AssertionError(f"server (11a): {len(diff)} written keys differ "
                             f"from the per-command CPU node's, e.g. "
                             f"{sorted(diff)[:5]}")
    if a["tensor_writes"] != oracle["tensor_writes"]:
        raise AssertionError("server (11a): tensor write replies differ")
    import numpy as np
    bad_t = sum(not same_reads(np.frombuffer(g.val, np.float32),
                               np.frombuffer(w.val, np.float32))
                for g, w in zip(a["tensor_reads"], oracle["tensor_reads"]))
    if bad_t or len(a["tensor_reads"]) != len(tensor[1]):
        raise AssertionError(f"server (11a): {bad_t} tensor.get replies "
                             "differ from the CPU node's")
    if a["digest_after"] != a["digest_before"]:
        raise AssertionError("server (11a): the restored keys' digest "
                             "changed while serving")
    n_req = sum(n for c in per_conn for _, n in c)
    rt = a["rtts"]
    ra = {"requests": n_req, "wall_s": a["wall_s"],
          "requests_per_s": n_req / a["wall_s"],
          "reply_p50_ms": 1e3 * rt[len(rt) // 2],
          "reply_p99_ms": 1e3 * rt[min(len(rt) - 1, int(0.99 * len(rt)))],
          "reply_windows": len(rt), "oracle_requests_per_s":
          n_req / oracle["wall_s"], "oracle_s": oracle_s,
          "restored_keys": n_restored, "boot_s": a["boot_s"],
          "restore_s": a["recovery_wall_s"], "tensor_s": a["tensor_s"],
          "written_keys": len(got), **a["stats"],
          "read_cache_hits_misses": a["read_cache"],
          "engine_merge_s": a["merge_s"], "engine_flush_s": a["flush_s"],
          "gc_freed": a["gc_freed"], "family_secs": a["family_secs"],
          **{k: a[k] for k in ("dev_rounds_resident", "host_micro_rounds",
                               "tns_dev_rows", "tns_host_rows", "bytes_h2d",
                               "bytes_d2h", "h2d_copies", "micro_rounds",
                               "mirror_rebuilds", "mirror_patches",
                               "peak_mem_bytes") if k in a},
          "restore_launches": a["restore_launches"],
          "restore_shapes": a["restore_shapes"],
          "launches": a["launches"]}
    log(f"server (11a): {n_req} requests over {SERVE_CONNS} pipelined "
        f"connections ({SERVE_PIPELINE}-deep, {SERVE_KEYS} keys each, serve "
        f"batch 512, seed {SERVE_SEED}) into the server entry on "
        f"{dev.type}, booted from {n_restored} restored keys in "
        f"{ra['restore_s']} s: {a['wall_s']:.3f} s "
        f"({ra['requests_per_s']:.0f} requests/s), reply windows p50 "
        f"{ra['reply_p50_ms']:.3f} ms, p99 {ra['reply_p99_ms']:.3f} ms; "
        f"{ra['serve_msgs_coalesced']} messages coalesced, "
        f"{ra['serve_flushes']} flushes, {ra['serve_barriers']} barriers; "
        f"the per-command CPU node {ra['oracle_requests_per_s']:.0f} "
        f"requests/s; reply hashes, the written keys' visible values and "
        f"{len(tensor[1])} tensor.get replies equal to its; restored "
        f"digest unchanged {json.dumps(ra)}")
    # K3 and the device rounds over the serve traffic (INFO read right
    # after it, before the tensor leg): a tensor round lands its payloads
    # in the pools and scatters nothing through K3
    k3 = info_launches(a["info_serve"])["scatter_pair_src"] - \
        a["restore_launches"]["scatter_pair_src"] if cuda else 0
    rounds = int(a["info_serve"]["dev_rounds_resident"]) - a["boot_rounds"]
    k5 = a["launches"]["tensor_take_reduce"]
    non_lww = sum(s != "lww" for s in tensor[2])
    host = {f: v[0] for f, v in (a["micro_rounds"] or {}).items()
            if v[0] > a["warmup"]}
    log(f"server (11a): serve traffic: K3 {k3} launches, {rounds} device "
        f"rounds; whole run: K3 {a['launches']['scatter_pair_src']}, "
        f"{a['dev_rounds_resident']} device rounds")
    if host:
        raise AssertionError(f"server (11a): host rounds past the warm-up "
                             f"of {a['warmup']}: {host}")
    # the launch checks need the card (a CPU rehearsal launches nothing)
    if cuda and (not k3 or k3 != rounds):
        raise AssertionError(f"server (11a): K3 launched {k3} times in "
                             f"{rounds} device rounds of the traffic")
    if cuda and k5 != non_lww:
        raise AssertionError(f"server (11a): K5 launched {k5} times for "
                             f"{non_lww} non-lww tensor.get")
    if cuda and not a["restore_launches"]["segment_sum"]:
        raise AssertionError("server (11a): the restore launched no K4")
    served = {k: a["launches"][k] - a["restore_launches"][k]
              for k in a["launches"]}
    log(f"server (11a): kernels: restore {a['restore_launches']}, serving "
        f"{served}; "
        f"K3 = {k3} device rounds, K5 = {k5} non-lww tensor.get")
    spans = span_summary(a["spans"], *a["serve_window"])
    ra["host_spans"] = spans
    log(f"server (11a): host spans of {SPAN_MIN_S} s or more inside the "
        f"serve traffic's {a['wall_s']:.3f} s: {json.dumps(spans)}; reply "
        f"windows of 1 s or more: {sum(x >= 1.0 for x in rt)} of {len(rt)}")

    # 11b: the real entry restarted on a copy of 11a's dump; 11c's A on
    # another copy and its empty B boot beside it
    procs = []
    steps = {"a_with_oracle_s": a["leg_s"], "oracle_s": oracle_s}
    pool = ThreadPoolExecutor(max_workers=2)
    try:
        env = dict(os.environ)

        def spawn(name, *extra):
            p = W.spawn_server(["--port", "0", "--device", dev.type,
                                "--work-dir", os.path.join(work, name),
                                *extra], os.path.join(work, name + ".log"),
                               env=env)
            procs.append(p)
            return p

        def listening(p, name):
            addr = W.wait_listening(p, os.path.join(work, name + ".log"),
                                    SERVE_WAIT_S)
            return int(addr.rsplit(":", 1)[1]), addr

        def stopped_digest(p, label, name, path):
            """After a SIGTERM: node `name`'s exit, then its dump's
            digest.  -> (when it exited, (digest, keys))."""
            rc_p = p.wait(timeout=SERVE_WAIT_S)
            t_exit = time.perf_counter()
            if rc_p != 0:
                raise AssertionError(
                    f"server ({label}): exit code {rc_p}: "
                    f"{W.tail(os.path.join(work, name + '.log'))}")
            return t_exit, dump_digest(dev, path)

        f1, fa, fb = (os.path.join(work, n + ".snapshot")
                      for n in ("b1", "c_a", "c_b"))
        shutil.copy(dump_a, f1)
        shutil.copy(dump_a, fa)
        t_bc = time.perf_counter()
        p1 = spawn("b1", "--snapshot", f1)
        pa = spawn("c_a", "--snapshot", fa)
        pb = spawn("c_b", "--snapshot", fb, "--node-id", "2")
        port1, _ = listening(p1, "b1")
        boot_b = time.perf_counter() - t_bc
        info1 = info_of(port1)
        restore_b = info_launches(info1) if cuda else {}
        got_reads = asyncio.run(W.request(port1, reads,
                                          timeout=SERVE_WAIT_S))
        if got_reads != a["sample"]:
            raise AssertionError("server (11b): the restarted node's reads "
                                 "differ from 11a's")
        wait_collected(port1, "11b")
        t_stop_b = time.perf_counter()
        p1.send_signal(signal.SIGTERM)      # its dump runs beside 11c
        dig_b_fut = pool.submit(stopped_digest, p1, "11b", "b1", f1)

        # 11c: A on 11a's dump, and the empty node B MEETs it
        port_a, addr_a = listening(pa, "c_a")
        port_b, _ = listening(pb, "c_b")
        ia0, ib0 = info_of(port_a), info_of(port_b)
        a_boot = info_launches(ia0) if cuda else {}
        b_boot = info_launches(ib0) if cuda else {}
        b_boot_rounds = int(ib0.get("dev_rounds_resident", 0))
        keys_want = int(ia0["keys"])
        t1 = time.perf_counter()
        asyncio.run(W.request(port_b, [(b"meet", addr_a.encode())]))
        while True:
            ib = info_of(port_b)
            if int(ib["keys"]) == keys_want:
                break
            if time.perf_counter() - t1 > SERVE_WAIT_S:
                raise AssertionError(f"server (11c): B holds {ib['keys']} "
                                     f"of {keys_want} keys after "
                                     f"{SERVE_WAIT_S} s")
            time.sleep(0.2)
        sync_s = time.perf_counter() - t1
        ia = info_of(port_a)
        spill = int(ia.get("last_snapshot_z_bytes",
                           ia.get("last_snapshot_bytes", 0)))
        path = "sharded" if "sharded_ingests" in ib else "plain"
        more = [W.serve_workload(c, 20_000 // SERVE_CONNS, SERVE_KEYS,
                                 SERVE_PIPELINE, seed=SERVE_SEED + 1)
                for c in range(SERVE_CONNS)]
        t1 = time.perf_counter()
        asyncio.run(asyncio.wait_for(W.serve_drive(port_a, more),
                                     SERVE_WAIT_S))
        push_wall = time.perf_counter() - t1
        last = int(info_of(port_a)["repl_log_last_uuid"])
        while True:
            ib = info_of(port_b)
            he = [int(x.split("=")[1]) for v in ib.values()
                  for x in v.split(",") if x.startswith("he_sent=")]
            if he and max(he) >= last:
                break
            if time.perf_counter() - t1 > SERVE_WAIT_S:
                raise AssertionError("server (11c): B did not catch up "
                                     "with the pushed writes")
            time.sleep(0.1)
        push_s = time.perf_counter() - t1
        ib = wait_collected(port_b, "11c B")
        ia = wait_collected(port_a, "11c A")
        la = info_launches(ia) if cuda else {}
        lb = info_launches(ib) if cuda else {}

        # 11b's dump, written while 11c ran
        t_exit_b, (dig_b, keys_b) = dig_b_fut.result(timeout=SERVE_WAIT_S)
        procs.remove(p1)
        if (dig_b, keys_b) != (a["digest"], a["keys"]):
            raise AssertionError(f"server (11b): dump digest {dig_b:#x} "
                                 f"({keys_b} keys), 11a's "
                                 f"{a['digest']:#x} ({a['keys']} keys)")
        rb = {"boot_s": boot_b, "restore_s": float(info1["recovery_wall_s"]),
              "keys": int(info1["keys"]), "engine": info1["engine"],
              "device": info1.get("device"),
              "device_name": info1.get("device_name"),
              "dev_upload_bytes": int(info1["dev_upload_bytes"])
              if "dev_upload_bytes" in info1 else None,
              "reads": len(reads), "stop_s": t_exit_b - t_stop_b,
              "launches": restore_b, "digest": f"{dig_b:#x}"}
        if info1["engine"] != "cuda" or (cuda and (
                info1.get("device") != str(dev) or
                not rb["dev_upload_bytes"])):
            raise AssertionError(f"server (11b): INFO {rb}")
        log(f"server (11b): python -m constdb_tpu_torch.bin.server "
            f"--snapshot on 11a's dump: up in {boot_b:.3f} s beside 11c's "
            f"two nodes (restore {rb['restore_s']} s, {rb['keys']} keys), "
            f"{len(reads)} sample reads equal to 11a's, INFO on the card, "
            f"its SIGTERM dump ({rb['stop_s']:.3f} s, beside 11c's sync) "
            f"and its digest equal to 11a's {json.dumps(rb)}")

        rc = {"keys": keys_want, "sync_s": sync_s,
              "sync_keys_per_s": keys_want / sync_s, "spill_bytes": spill,
              "apply_path": path,
              "sharded_ingest_workers": ib.get("sharded_ingest_workers"),
              "b_repl_in_bytes": int(ib["repl_net_input_bytes"]),
              "pushed_ops": sum(n for c in more for _, n in c),
              "push_drive_s": push_wall, "push_visible_s": push_s,
              "a_wire_batches_out": int(ia["repl_wire_batches_out"]),
              "b_wire_batches_in": int(ib["repl_wire_batches_in"]),
              "b_dev_rounds_resident": int(ib.get("dev_rounds_resident",
                                                   0)) - b_boot_rounds,
              "b_host_micro_rounds": int(ib.get("host_micro_rounds", 0)),
              "a_boot_launches": a_boot, "a_launches": la,
              "b_boot_launches": b_boot, "b_launches": lb}
        # both SIGTERMs at once: the two final dumps run side by side, and
        # so do the reads of their digests
        t1 = time.perf_counter()
        for p in (pa, pb):
            p.send_signal(signal.SIGTERM)
        futs = [pool.submit(stopped_digest, p, label, name, f)
                for p, label, name, f in ((pa, "11c A", "c_a", fa),
                                          (pb, "11c B", "c_b", fb))]
        (ta, (dig_ca, n_ca)), (tb, (dig_cb, n_cb)) = (
            f.result(timeout=2 * SERVE_WAIT_S) for f in futs)
        procs.remove(pa)
        procs.remove(pb)
        rc["stop_s"] = max(ta, tb) - t1
        rc["digest_s"] = time.perf_counter() - max(ta, tb)
        rc["digest"] = f"{dig_ca:#x}"
        if (dig_ca, n_ca) != (dig_cb, n_cb):
            raise AssertionError(f"server (11c): A's dump {dig_ca:#x} "
                                 f"({n_ca} keys), B's {dig_cb:#x} "
                                 f"({n_cb} keys)")
        if not rc["b_wire_batches_in"]:
            raise AssertionError("server (11c): no REPLBATCH run reached B")
        steps["b_and_c_s"] = time.perf_counter() - t_bc
        # B's launches since its boot: the full sync's apply and the
        # pushed runs; each pushed run B lands is one device round, K3
        b_k3 = lb.get("scatter_pair_src", 0) - \
            b_boot.get("scatter_pair_src", 0)
        log(f"server (11c): MEET, then the full sync of {keys_want} keys in "
            f"{sync_s:.3f} s ({rc['sync_keys_per_s']:.0f} keys/s; A's dump "
            f"{spill} bytes, B read {rc['b_repl_in_bytes']} bytes, apply "
            f"path {path}); {rc['pushed_ops']} more ops into A reached B "
            f"through the push loop in {push_s:.3f} s "
            f"({rc['b_wire_batches_in']} REPLBATCH runs, B: K3 {b_k3} "
            f"launches, {rc['b_dev_rounds_resident']} device rounds); the "
            f"two SIGTERM dumps' digests equal {json.dumps(rc)}")
        if cuda and (not rc["b_dev_rounds_resident"] or
                     b_k3 != rc["b_dev_rounds_resident"]):
            raise AssertionError(f"server (11c): B launched K3 {b_k3} times "
                                 f"in {rc['b_dev_rounds_resident']} device "
                                 f"rounds")
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
        pool.shutdown(wait=True, cancel_futures=True)
    log(f"server: steps {json.dumps(steps)}")
    secs = time.perf_counter() - t_phase
    log(f"server: phase {secs:.1f} s")
    keys = list(a["launches"])
    # serve: 11a's traffic and tensor leg, and the 20,000 ops A took in
    # 11c; restore: the three boots from a dump; sync: B since its boot
    serve = {k: a["launches"][k] - a["restore_launches"][k] +
             rc["a_launches"].get(k, 0) - rc["a_boot_launches"].get(k, 0)
             for k in keys}
    restore = {k: a["restore_launches"][k] + rb["launches"].get(k, 0) +
               rc["a_boot_launches"].get(k, 0) for k in keys}
    sync = {k: rc["b_launches"].get(k, 0) - rc["b_boot_launches"].get(k, 0)
            for k in keys}
    log(f"server: kernels by path: serve {serve}, restore {restore}, "
        f"sync {sync}")
    # what phases 12-13 hold their servers to: 11a's reply hashes, sample
    # reads and tensor replies, and the oracle's visible values of the
    # keys written after the boot (the traffic's and the tensor leg's)
    ref = {"per_conn": per_conn, "tensor": tensor, "reads": reads,
           "hashes": a["hashes"], "sample": a["sample"],
           "tensor_writes": a["tensor_writes"],
           "tensor_reads": a["tensor_reads"],
           "visible": want,
           "requests_per_s": ra["requests_per_s"],
           "reply_p50_ms": ra["reply_p50_ms"],
           "reply_p99_ms": ra["reply_p99_ms"]}
    return {"a": ra, "b": rb, "c": rc, "secs": secs, "ref": ref,
            "launches": {"serve": serve, "restore": restore, "sync": sync}}


# ------------------------------------------------------------ phases 12-13

# the serve mix's op-log bytes per op (a CPU run of the port's server with
# --aof: 20,000 ops of serve_workload, 1,210,044 bytes of segments)
AOF_BYTES_PER_OP = 60.5
KILL_WAIT_S = 30.0          # a killed server's processes must be gone


def rewrite_min_mb(n_ops: int) -> int:
    """12a's CONSTDB_TORCH_AOF_REWRITE_MIN_MB: 0.6 of the traffic's log,
    so one rewrite starts part way through the traffic and a second would
    need as many bytes again."""
    return max(1, round(0.6 * AOF_BYTES_PER_OP * n_ops / (1 << 20)))


def traffic_keys(tensor=None) -> list:
    """Every key serve_workload can write (4 type prefixes per
    connection key), and the tensor leg's keys when `tensor` (its
    commands) is given."""
    keys = [p + b"c%d:%05d" % (c, i) for c in range(SERVE_CONNS)
            for i in range(SERVE_KEYS) for p in (b"r", b"c", b"s", b"h")]
    if tensor is not None:
        keys += [c[1] for c in tensor[1]]
    return keys


def differing_reads(ref: dict, sample: list) -> list:
    """11a's sample reads that `sample` answers otherwise: (command,
    got, 11a's).  A replay lands a set's or hash's element rows in
    another order than the served runs did (frame by frame on a sharded
    node, in merge rounds on a plain one), so SMEMBERS and HGETALL
    replies compare as collections."""
    if len(sample) != len(ref["sample"]):
        return [("count", len(sample), len(ref["sample"]))]
    return [(c, g, w) for c, g, w in zip(ref["reads"], sample,
                                         ref["sample"])
            if unordered(c, g) != unordered(c, w)]


def unordered(cmd: tuple, reply):
    """A reply as a value that ignores the order of a collection's
    elements: the encodings of SMEMBERS' members and of HGETALL's
    [field, value] pairs, sorted; any other reply as it is."""
    if cmd[0] in (b"smembers", b"hgetall") and \
            getattr(reply, "items", None) is not None:
        from constdb_tpu_torch.resp.codec import encode_msg
        return cmd[0], sorted(encode_msg(x) for x in reply.items)
    return reply


def without_tensors(visible: dict) -> dict:
    return {k: v for k, v in visible.items() if not k.startswith(b"t:")}


def aof_worker(conn, argv: list, env: dict, keys) -> None:
    """A phase 12-13 server (spawned): the server entry's `amain`.  Sends
    {"port", "pid", "boot_s"} once the node serves and then, when `keys`
    is given, {"visible": the visible values of those keys}
    (strip_canonical_times of the node's canonical, or of the serve
    plane's, which asks its workers).  SIGKILL ends it with no dump."""
    import asyncio
    import traceback

    os.environ.update(env)

    def fail(e):
        conn.send({"error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()})

    try:
        from constdb_tpu_torch import workload as W
        from constdb_tpu_torch.bin.server import amain
        from constdb_tpu_torch.conf import load_config

        cfg = load_config(argv)
        t0 = time.perf_counter()
        tasks = []

        async def visible(app):
            try:
                node = app.node
                if node.serve_plane is not None:
                    canon = await node.serve_plane.canonical(keys)
                else:
                    node.ensure_flushed()
                    canon = node.ks.canonical(keys)
                conn.send({"visible": W.strip_canonical_times(canon)})
            except BaseException as e:  # the parent raises it
                fail(e)

        def started(app):
            conn.send({"port": app.port, "pid": os.getpid(),
                       "boot_s": time.perf_counter() - t0})
            if keys:
                # the loop holds its tasks weakly: keep this one
                tasks.append(asyncio.get_running_loop().create_task(
                    visible(app)))

        asyncio.run(amain(cfg, started))
    except BaseException as e:  # the parent raises it
        fail(e)
    finally:
        conn.close()


def start_aof_server(argv: list, env: dict, keys, label: str) -> tuple:
    """Spawn aof_worker and wait for its node to serve.
    -> (process, pipe, its first message)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=aof_worker, args=(child, argv, env, keys))
    proc.start()
    child.close()
    try:
        up = recv_msg(parent, label, "not up")
    except BaseException:
        proc.kill()
        proc.join(timeout=10)
        raise
    return proc, parent, up


def recv_msg(conn, label: str, what: str) -> dict:
    if not conn.poll(SERVE_WAIT_S):
        raise AssertionError(f"server ({label}): {what} in "
                             f"{SERVE_WAIT_S} s")
    msg = conn.recv()
    if "error" in msg:
        raise AssertionError(f"server ({label}): {msg['error']}\n"
                             f"{msg['traceback']}")
    return msg


def descendants(pid: int) -> set:
    """`pid` and every process below it (from /proc)."""
    children: dict = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            children.setdefault(ppid, []).append(int(d))
    out, todo = set(), [pid]
    while todo:
        p = todo.pop()
        out.add(p)
        todo += children.get(p, [])
    return out


def alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def compute_apps() -> set:
    """The pids nvidia-smi lists as compute apps on the card (empty
    without nvidia-smi)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return set()
    return {int(x) for x in out.split() if x.strip().isdigit()}


def kill_server(proc, pids: set, apps_before: set, label: str) -> dict:
    """SIGKILL the server process; every process of `pids` must be gone
    (or a zombie) within KILL_WAIT_S and no pid of theirs may stay among
    the card's compute apps.  -> the numbers."""
    t0 = time.perf_counter()
    proc.kill()
    proc.join(timeout=KILL_WAIT_S)
    while left := [p for p in pids if alive(p)]:
        if time.perf_counter() - t0 > KILL_WAIT_S:
            raise AssertionError(f"server ({label}): processes {left} alive "
                                 f"{KILL_WAIT_S} s after SIGKILL")
        time.sleep(0.05)
    gone_s = time.perf_counter() - t0
    apps = compute_apps()
    if apps & pids:
        raise AssertionError(f"server ({label}): {sorted(apps & pids)} still "
                             f"compute apps on the card after SIGKILL")
    return {"pids": sorted(pids), "gone_s": gone_s,
            "compute_apps_before": sorted(apps_before),
            "compute_apps_after": sorted(apps)}


def aof_files(aof_dir: str) -> dict:
    """Bytes of the op log's segments and base snapshots."""
    segs = base = 0
    for f in os.listdir(aof_dir):
        size = os.path.getsize(os.path.join(aof_dir, f))
        if f.endswith(".log"):
            segs += size
        elif f.endswith(".base.snapshot"):
            base += size
    return {"segment_bytes": segs, "base_bytes": base}


def canon_hash(canon: dict) -> str:
    """A hash of a canonical export that does not depend on the process:
    each key's content set is sorted (bytes hash per process, so a
    frozenset's order does too).  A tensor's content is (config,
    frozenset)."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(canon):
        v = canon[k]
        c = v[-1]
        if isinstance(c, frozenset):
            c = sorted(c)
        elif isinstance(c, tuple) and c and isinstance(c[-1], frozenset):
            c = (*c[:-1], sorted(c[-1]))
        h.update(repr((k, v[:-1], c)).encode())
    return h.hexdigest()


def cut_last_op_record(aof_dir: str, half: bool) -> tuple:
    """Truncate the newest segment inside (`half`) or at the start of its
    last op-carrying record (the WMARK records after it go too).
    -> (segment, the cut offset)."""
    from constdb_tpu_torch.persist import oplog as OL
    gen = max(OL.OpLog.list_generations(aof_dir))
    path = OL.OpLog.seg_path(aof_dir, gen, 0)
    with open(path, "rb") as f:
        data = f.read()
    pos, last = len(OL.MAGIC), None
    while pos + 8 <= len(data):
        ln = int.from_bytes(data[pos:pos + 4], "little")
        if data[pos + 8] != OL.REC_WMARK:
            last = (pos, ln)
        pos += 8 + ln
    if last is None:
        raise AssertionError(f"aof (12c): no op record in {path}")
    cut = last[0] + (8 + last[1]) // 2 if half else last[0]
    with open(path, "r+b") as f:
        f.truncate(cut)
    return os.path.basename(path), cut


def recover_job(conn, aof_dir: str, boot: str, engine: str, device: str,
                bulk: bool, cut) -> None:
    """12c (spawned): one in-process recovery of a copy of 12a's op log
    through oplog.recover into Node(node_id=1) with a resident
    TorchMergeEngine on `device` ("torch") or the CPU engine ("cpu");
    `cut` "half" / "start" first truncates the
    newest segment's last op record in half / at its start.  Sends the
    RecoveryInfo, the canonical's hash, full_state_digest, the seconds,
    the kernel launches, the engine's flushes and device rounds."""
    import traceback
    try:
        import torch

        from constdb_tpu_torch.engine.cpu import CpuMergeEngine
        from constdb_tpu_torch.engine.cuda import TorchMergeEngine
        from constdb_tpu_torch.ops import kernels as KN
        from constdb_tpu_torch.persist import oplog as OL
        from constdb_tpu_torch.server.node import Node
        from constdb_tpu_torch.store.digest import full_state_digest as fsd

        out = {}
        if cut:
            out["cut"] = cut_last_op_record(aof_dir, cut == "half")
        eng = TorchMergeEngine(resident=True, device=device) \
            if engine == "torch" else CpuMergeEngine()
        cuda = engine == "torch" and device == "cuda"
        flushes = [0]
        real_flush = eng.flush

        def counted(*a, **kw):
            flushes[0] += 1
            return real_flush(*a, **kw)
        eng.flush = counted
        node = Node(node_id=1, engine=eng)
        t0 = time.perf_counter()
        info = OL.recover(node, aof_dir, boot_snapshot=boot, engine=eng,
                          bulk=bulk)
        node.ensure_flushed()
        if cuda:
            torch.cuda.synchronize()
        out["secs"] = time.perf_counter() - t0
        canon = node.canonical()
        out.update(info={k: getattr(info, k) for k in (
            "source", "mode", "frames", "batches", "batch_frames", "wmarks",
            "skipped", "tail_truncated", "truncated_bytes", "merge_rounds")},
            keys=len(canon), canon=canon_hash(canon),
            digest=f"{fsd(node.ks):#x}", launches=dict(KN.LAUNCHES),
            flushes=flushes[0],
            dev_rounds=getattr(eng, "dev_rounds_resident", 0),
            flush_rows_downloaded=getattr(eng, "flush_rows_downloaded", 0))
        conn.send(out)
    except BaseException as e:  # the parent raises it
        conn.send({"error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()})
    finally:
        conn.close()


def rewrite_poller(port: int, samples: list, stop) -> None:
    """12a: INFO's rewrite gauges every 0.25 s while the traffic runs
    (a thread): [time, aof_rewrite_in_progress, aof_rewrites]."""
    while not stop.wait(0.25):
        try:
            i = info_of(port)
        except (OSError, ConnectionError):
            continue
        samples.append([time.perf_counter(),
                        int(i["aof_rewrite_in_progress"]),
                        int(i["aof_rewrites"])])


def server_launches(info: dict, cuda: bool) -> dict:
    """A server's launches from INFO: the parent's and, on a sharded
    node, its workers' (serve_shard<i>_kernel_launches)."""
    if not cuda:
        return {}
    out = info_launches(info)
    for k, v in info.items():
        if k.startswith("serve_shard") and k.endswith("_kernel_launches"):
            for kv in v.split(","):
                name, n = kv.split("=")
                out[name] = out.get(name, 0) + int(n)
    return out


def aof_phase(dev, boot_path: str, work: str, n_ops: int, ref: dict) -> dict:
    """Phase 12: the durable op log on the card, through the server
    entry.  (a) --aof --aof-fsync always, booted from the 1M-key file,
    11a's traffic with one rewrite (CONSTDB_TORCH_AOF_REWRITE_MIN_MB),
    SIGKILL once the rewrite is done; (b) a fresh server on the same
    directory replays base + tail: every acknowledged write back;
    (c) copies recovered in spawned processes: serial and bulk on the
    card byte-identical, a torn last record (aof_tail_truncated 1) equal
    to the serial replay without it, and the log alone (the base
    removed) bulk on the CPU engine equal to serial on the card."""
    import asyncio
    import multiprocessing as mp
    import threading

    from constdb_tpu_torch import workload as W
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    d12 = os.path.join(work, "p12")
    os.makedirs(d12)
    boot = os.path.join(work, "boot12.snapshot")
    shutil.copy(boot_path, boot)
    aof_dir = os.path.join(d12, "aof")
    argv = ["--port", "0", "--log-level", "warning", "--node-id", "1",
            "--device", dev.type, "--work-dir", d12, "--snapshot", boot,
            "--aof", "--aof-fsync", "always"]
    min_mb = rewrite_min_mb(n_ops)

    # 12a
    apps0 = compute_apps()
    proc, conn, up = start_aof_server(
        argv, {"CONSTDB_TORCH_AOF_REWRITE_MIN_MB": str(min_mb)}, None, "12a")
    try:
        port = up["port"]
        i_boot = info_of(port)
        samples, stop = [], threading.Event()
        poller = threading.Thread(target=rewrite_poller,
                                  args=(port, samples, stop), daemon=True)
        poller.start()
        t0 = time.perf_counter()
        try:
            rtts, hashes = asyncio.run(asyncio.wait_for(
                W.serve_drive(port, ref["per_conn"]), SERVE_WAIT_S))
            wall = time.perf_counter() - t0
            i_serve = info_of(port)
            while True:
                i_end = info_of(port)
                if int(i_end["aof_rewrites"]) >= 1 and \
                        i_end["aof_rewrite_in_progress"] == "0":
                    break
                if time.perf_counter() - t0 > SERVE_WAIT_S:
                    raise AssertionError(
                        f"aof (12a): aof_rewrites {i_end['aof_rewrites']}, "
                        f"in progress {i_end['aof_rewrite_in_progress']} "
                        f"{SERVE_WAIT_S} s after the traffic began")
                time.sleep(0.1)
        finally:
            stop.set()
            poller.join(timeout=10)
        t_end = time.perf_counter()
        killed = kill_server(proc, {up["pid"]}, apps0, "12a")
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
        conn.close()
    if hashes != ref["hashes"]:
        raise AssertionError("aof (12a): reply hashes differ from 11a's")
    n_req = sum(n for c in ref["per_conn"] for _, n in c)
    rtts.sort()
    ks3 = "scatter_pair_src"
    k3 = server_launches(i_serve, cuda).get(ks3, 0) - \
        server_launches(i_boot, cuda).get(ks3, 0)
    rounds = int(i_serve["dev_rounds_resident"]) - \
        int(i_boot["dev_rounds_resident"])
    busy = [s for s in samples if s[1]]
    ra = {"requests": n_req, "wall_s": wall,
          "requests_per_s": n_req / wall,
          "reply_p50_ms": 1e3 * rtts[len(rtts) // 2],
          "reply_p99_ms": 1e3 * rtts[min(len(rtts) - 1,
                                         int(0.99 * len(rtts)))],
          "11a_requests_per_s": ref["requests_per_s"],
          "11a_reply_p50_ms": ref["reply_p50_ms"],
          "11a_reply_p99_ms": ref["reply_p99_ms"],
          "restore_s": float(i_boot["recovery_wall_s"]),
          "boot_s": up["boot_s"], "rewrite_min_mb": min_mb,
          "aof_fsyncs": int(i_end["aof_fsyncs"]),
          "aof_appended_ops": int(i_end["aof_appended_ops"]),
          "aof_encoded_batches": int(i_end["aof_encoded_batches"]),
          "aof_rewrites": int(i_end["aof_rewrites"]),
          "aof_size_bytes": int(i_end["aof_size_bytes"]),
          "aof_last_fsync_lag_ms": float(i_end["aof_last_fsync_lag_ms"]),
          "rewrite_seen_s": busy[-1][0] - busy[0][0] + 0.25 if busy
          else None,
          "rewrite_done_after_traffic_s": t_end - (t0 + wall),
          "serve_flushes": int(i_serve["serve_flushes"]),
          "serve_barriers": int(i_serve["serve_barriers"]),
          "dev_rounds": rounds, "k3": k3,
          "launches": server_launches(i_end, cuda), "kill": killed,
          **aof_files(aof_dir)}
    log(f"aof (12a): {n_req} requests of 11a's traffic into the server "
        f"entry with --aof --aof-fsync always on {dev.type}: "
        f"{wall:.3f} s ({ra['requests_per_s']:.0f} requests/s; 11a "
        f"{ref['requests_per_s']:.0f}), reply windows p50 "
        f"{ra['reply_p50_ms']:.3f} ms, p99 {ra['reply_p99_ms']:.3f} ms "
        f"(11a {ref['reply_p50_ms']:.3f}, {ref['reply_p99_ms']:.3f}); "
        f"{ra['aof_fsyncs']} fsyncs, {ra['aof_rewrites']} rewrite(s) "
        f"(min {min_mb} MB), log {ra['segment_bytes']} bytes + base "
        f"{ra['base_bytes']}; K3 {k3} = {rounds} device rounds; reply "
        f"hashes equal to 11a's; SIGKILL, gone in {killed['gone_s']:.3f} s "
        f"{json.dumps(ra)}")
    if ra["aof_rewrites"] < 1 or not ra["base_bytes"]:
        raise AssertionError(f"aof (12a): no rewrite base: {ra}")
    if cuda and (not k3 or k3 != rounds):
        raise AssertionError(f"aof (12a): K3 launched {k3} times in "
                             f"{rounds} device rounds")

    # copies for 12c, taken before 12b's boot repairs or appends anything;
    # the CPU engine's and its card twin's copies hold the log alone (its
    # base snapshot removed, no boot snapshot): the CPU engine's load of
    # the 1M-key base took 80-95 s
    jobs = {"serial": ("torch", False, None), "bulk": ("torch", True, None),
            "torn": ("torch", True, "half"),
            "torn_ref": ("torch", False, "start"),
            "cpu": ("cpu", True, None), "log_only": ("torch", False, None)}
    log_only = ("cpu", "log_only")
    for name in jobs:
        d = os.path.join(work, f"c12_{name}")
        shutil.copytree(aof_dir, d)
        if name in log_only:
            for f in os.listdir(d):
                if f.endswith(".base.snapshot"):
                    os.remove(os.path.join(d, f))
    ctx = mp.get_context("spawn")
    running = {}

    def start_job(name):
        engine, bulk, cut = jobs[name]
        parent, child = ctx.Pipe()
        p = ctx.Process(target=recover_job, args=(
            child, os.path.join(work, f"c12_{name}"),
            "" if name in log_only else boot, engine, dev.type, bulk, cut))
        p.start()
        child.close()
        running[name] = (p, parent)

    try:
        # 12b
        keys = traffic_keys()
        apps0 = compute_apps()
        proc, conn, up = start_aof_server(argv, {}, keys, "12b")
        try:
            port = up["port"]
            # the pipe first: the worker blocks on a full pipe, and INFO
            # would wait for its loop
            vis = recv_msg(conn, "12b", "no visible values")["visible"]
            i_b = info_of(port)
            sample = asyncio.run(W.request(port, ref["reads"],
                                           timeout=SERVE_WAIT_S))
            i_b2 = info_of(port)
            pids = descendants(up["pid"])
            killed_b = kill_server(proc, pids, apps0, "12b")
        finally:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
            conn.close()
        log_gb = ra["segment_bytes"] / 1e9
        lb = server_launches(i_b, cuda)
        rb = {"boot_s": up["boot_s"],
              "recovery_wall_s": float(i_b["recovery_wall_s"]),
              "s_per_gb_of_log": float(i_b["recovery_wall_s"]) / log_gb,
              "aof_recovery_source": i_b["aof_recovery_source"],
              "recovery_mode": i_b["recovery_mode"],
              "recovery_merge_rounds": int(i_b["recovery_merge_rounds"]),
              "aof_recovered_ops": int(i_b["aof_recovered_ops"]),
              "aof_tail_truncated": int(i_b["aof_tail_truncated"]),
              "keys": int(i_b["keys"]), "launches": lb,
              "dev_rounds": int(i_b["dev_rounds_resident"]),
              "flush_rows_downloaded": int(i_b["flush_rows_downloaded"]),
              "flush_seconds_total": float(i_b["flush_seconds_total"]),
              "visible_keys": len(vis), "kill": killed_b,
              "launches_after_reads": server_launches(i_b2, cuda)}
        log(f"aof (12b): a fresh server on 12a's directory: up in "
            f"{up['boot_s']:.3f} s, recovery {rb['recovery_wall_s']} s "
            f"({rb['s_per_gb_of_log']:.1f} s per GB of log, "
            f"{rb['aof_recovery_source']}, {rb['recovery_mode']}, "
            f"{rb['recovery_merge_rounds']} merge rounds, "
            f"{rb['aof_recovered_ops']} ops); {len(vis)} traffic keys' "
            f"visible values equal to 11a's oracle's, {len(ref['reads'])} "
            f"sample reads equal to 11a's {json.dumps(rb)}")
        want = without_tensors(ref["visible"])   # 12a ran no tensor leg
        if vis != want:
            diff = [k for k in set(vis) | set(want)
                    if vis.get(k) != want.get(k)]
            raise AssertionError(f"aof (12b): {len(diff)} traffic keys "
                                 f"differ from 11a's oracle, e.g. "
                                 f"{sorted(diff)[:5]}")
        bad = differing_reads(ref, sample)
        if bad:
            raise AssertionError(f"aof (12b): {len(bad)} sample reads "
                                 f"differ from 11a's, e.g. {bad[:4]}")
        if not rb["aof_recovery_source"].startswith("aof-base-snapshot") or \
                not rb["aof_recovered_ops"]:
            raise AssertionError(f"aof (12b): recovery {rb}")
        if cuda and lb.get(ks3, 0) != rb["dev_rounds"]:
            raise AssertionError(f"aof (12b): the replay launched K3 "
                                 f"{lb.get(ks3, 0)} times in "
                                 f"{rb['dev_rounds']} device rounds")

        # 12c: the copies, recovered side by side in spawned processes
        t_c = time.perf_counter()
        for name in jobs:
            start_job(name)
        res = {}
        for name, (p, parent) in running.items():
            res[name] = recv_msg(parent, f"12c {name}", "no result")
            p.join(timeout=SERVE_WAIT_S)
    finally:
        for p, parent in running.values():
            stop_job(p, parent)
    c_s = time.perf_counter() - t_c
    for name, twin in (("bulk", "serial"), ("cpu", "log_only")):
        if (res[name]["canon"], res[name]["digest"]) != \
                (res[twin]["canon"], res[twin]["digest"]):
            raise AssertionError(f"aof (12c): the {name} recovery differs "
                                 f"from the {twin} one: {res[name]} "
                                 f"against {res[twin]}")
    if res["cpu"]["info"]["source"] != "log-only" or \
            not res["cpu"]["info"]["frames"] + res["cpu"]["info"]["batches"]:
        raise AssertionError(f"aof (12c): the CPU engine's copy "
                             f"recovered {res['cpu']['info']}")
    if res["torn"]["info"]["tail_truncated"] != 1 or \
            res["torn_ref"]["info"]["tail_truncated"] != 0 or \
            (res["torn"]["canon"], res["torn"]["digest"]) != \
            (res["torn_ref"]["canon"], res["torn_ref"]["digest"]):
        raise AssertionError(f"aof (12c): torn tail {res['torn']} against "
                             f"the serial replay without the record "
                             f"{res['torn_ref']}")
    rc = {name: {k: v for k, v in r.items() if k != "canon"}
          for name, r in res.items()}
    rc["wall_s"] = c_s
    bulk_k3 = res["bulk"]["launches"][ks3]
    log(f"aof (12c): six recoveries of copies in {c_s:.1f} s: serial on "
        f"{dev.type} {res['serial']['secs']:.3f} s, bulk "
        f"{res['bulk']['secs']:.3f} s ({res['bulk']['info']['merge_rounds']}"
        f" merge rounds, {res['bulk']['flushes']} flushes, K3 {bulk_k3}, "
        f"{res['bulk']['dev_rounds']} device rounds, K4 "
        f"{res['bulk']['launches']['segment_sum']}): canonical and "
        f"full_state_digest equal ({res['serial']['keys']} keys, "
        f"{res['serial']['digest']}); the last op record cut in half: "
        f"aof_tail_truncated 1, equal to the serial replay without it; "
        f"the log alone (base removed): the CPU engine's bulk recovery "
        f"{res['cpu']['secs']:.3f} s equal to the serial one on "
        f"{dev.type} ({res['cpu']['keys']} keys) {json.dumps(rc)}")
    if cuda and bulk_k3 != res["bulk"]["dev_rounds"]:
        raise AssertionError(f"aof (12c): the bulk replay launched K3 "
                             f"{bulk_k3} times in "
                             f"{res['bulk']['dev_rounds']} device rounds")
    secs = time.perf_counter() - t_phase
    log(f"aof: phase {secs:.1f} s")
    keys_k = set(ra["launches"]) | set(lb)
    card_jobs = [r for n, r in res.items() if n != "cpu"] if cuda else []
    launches = {k: ra["launches"].get(k, 0) + rb["launches_after_reads"].get(
        k, 0) + sum(r["launches"].get(k, 0) for r in card_jobs)
        for k in keys_k}
    return {"a": ra, "b": rb, "c": rc, "secs": secs, "launches": launches,
            "visible": vis}


def stop_job(p, parent) -> None:
    if p.is_alive():
        p.kill()
        p.join(timeout=10)
    parent.close()


def shards_phase(dev, boot_path: str, work: str, ref: dict,
                 aof_visible: dict) -> dict:
    """Phase 13: serve shards with the op log, through the server entry
    (CONSTDB_TORCH_SERVE_SHARDS=2).  (a) booted from the 1M-key file
    fanned out to 2 workers (each a CUDA engine), 11a's traffic and its
    tensor leg: replies byte-identical to 11a's, each worker's K3 =
    its device rounds, K5 = the non-lww tensor.get; SIGKILL, and no
    process of the server left, nor among the card's compute apps;
    (b) rebooted with the same flags: the per-shard segments replay
    concurrently; the traffic keys' visible values equal 11a's oracle's
    (and so 12b's)."""
    import asyncio

    import numpy as np

    from constdb_tpu_torch import workload as W
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    d13 = os.path.join(work, "p13")
    os.makedirs(d13)
    boot = os.path.join(work, "boot13.snapshot")
    shutil.copy(boot_path, boot)
    argv = ["--port", "0", "--log-level", "warning", "--node-id", "1",
            "--device", dev.type, "--work-dir", d13, "--snapshot", boot,
            "--aof", "--aof-fsync", "always"]
    # no rewrite: 13b replays the whole per-shard log (12a rewrote)
    env = {"CONSTDB_TORCH_SERVE_SHARDS": "2",
           "CONSTDB_TORCH_AOF_REWRITE_MIN_MB": "4096"}
    n_req = sum(n for c in ref["per_conn"] for _, n in c)
    writes, treads, strats = ref["tensor"]

    # 13a
    apps0 = compute_apps()
    proc, conn, up = start_aof_server(argv, env, None, "13a")
    try:
        port = up["port"]
        i_boot = info_of(port)
        t0 = time.perf_counter()
        rtts, hashes = asyncio.run(asyncio.wait_for(
            W.serve_drive(port, ref["per_conn"]), SERVE_WAIT_S))
        wall = time.perf_counter() - t0
        i_serve = info_of(port)
        t0 = time.perf_counter()
        tw = asyncio.run(W.request(port, writes, timeout=SERVE_WAIT_S))
        tr = asyncio.run(W.request(port, treads, timeout=SERVE_WAIT_S))
        tensor_s = time.perf_counter() - t0
        i_end = info_of(port)
        pids = descendants(up["pid"])
        killed = kill_server(proc, pids, apps0, "13a")
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
        conn.close()
    if hashes != ref["hashes"]:
        raise AssertionError("shards (13a): reply hashes differ from 11a's")
    if tw != ref["tensor_writes"]:
        raise AssertionError("shards (13a): tensor write replies differ")
    bad_t = sum(not same_reads(np.frombuffer(g.val, np.float32),
                               np.frombuffer(w.val, np.float32))
                for g, w in zip(tr, ref["tensor_reads"]))
    if bad_t or len(tr) != len(ref["tensor_reads"]):
        raise AssertionError(f"shards (13a): {bad_t} tensor.get replies "
                             f"differ from 11a's")
    rtts.sort()
    workers = []
    for i in range(2):
        w = {k: i_end.get(f"serve_shard{i}_{k}") for k in (
            "keys", "dev_rounds", "device_mem_peak")}
        ls = dict(kv.split("=") for kv in
                  i_serve[f"serve_shard{i}_kernel_launches"].split(","))
        le = dict(kv.split("=") for kv in
                  i_end[f"serve_shard{i}_kernel_launches"].split(","))
        w.update(k3=int(ls["scatter_pair_src"]),
                 rounds=int(i_serve[f"serve_shard{i}_dev_rounds"]),
                 k5=int(le["tensor_take_reduce"]),
                 launches={k: int(v) for k, v in le.items()})
        workers.append(w)
    ra = {"requests": n_req, "wall_s": wall,
          "requests_per_s": n_req / wall,
          "reply_p50_ms": 1e3 * rtts[len(rtts) // 2],
          "reply_p99_ms": 1e3 * rtts[min(len(rtts) - 1,
                                         int(0.99 * len(rtts)))],
          "11a_requests_per_s": ref["requests_per_s"],
          "boot_s": up["boot_s"],
          "recovery_wall_s": float(i_boot["recovery_wall_s"]),
          "tensor_s": tensor_s, "workers": workers,
          "parent_device_mem_peak": i_end.get("device_mem_peak"),
          "aof_fsyncs": int(i_end["aof_fsyncs"]),
          "aof_segments": int(i_end["aof_segments"]),
          "aof_rewrites": int(i_end["aof_rewrites"]),
          "aof_size_bytes": int(i_end["aof_size_bytes"]),
          "serve_xshard_barriers": int(i_end.get(
              "serve_xshard_barriers", 0)),
          "launches": server_launches(i_end, cuda), "kill": killed}
    log(f"shards (13a): {n_req} requests of 11a's traffic and its tensor "
        f"leg into the server entry with 2 serve shards (--aof --aof-fsync "
        f"always) on {dev.type}, booted from the 1M-key file in "
        f"{ra['recovery_wall_s']} s: {wall:.3f} s "
        f"({ra['requests_per_s']:.0f} requests/s; 11a "
        f"{ref['requests_per_s']:.0f}), reply windows p50 "
        f"{ra['reply_p50_ms']:.3f} ms, p99 {ra['reply_p99_ms']:.3f} ms; "
        f"workers: " + "; ".join(
            f"K3 {w['k3']} = {w['rounds']} device rounds, K5 {w['k5']}, "
            f"peak {w['device_mem_peak']} bytes" for w in workers) +
        f"; replies and {len(tr)} tensor.get equal to 11a's; SIGKILL: "
        f"{len(pids)} processes gone in {killed['gone_s']:.3f} s, none "
        f"among the compute apps {json.dumps(ra)}")
    non_lww = sum(s != "lww" for s in strats)
    if cuda:
        for i, w in enumerate(workers):
            if not w["k3"] or w["k3"] != w["rounds"]:
                raise AssertionError(f"shards (13a): worker {i} launched K3 "
                                     f"{w['k3']} times in {w['rounds']} "
                                     f"device rounds")
        if sum(w["k5"] for w in workers) != non_lww:
            raise AssertionError(f"shards (13a): K5 launched "
                                 f"{[w['k5'] for w in workers]} times for "
                                 f"{non_lww} non-lww tensor.get")

    # 13b
    apps0 = compute_apps()
    proc, conn, up = start_aof_server(
        argv, {**env, "CONSTDB_TORCH_RECOVER_SHARDS": "2"},
        traffic_keys(ref["tensor"]), "13b")
    try:
        port = up["port"]
        # the pipe first: the worker blocks on a full pipe, and INFO
        # would wait for its loop
        vis = recv_msg(conn, "13b", "no visible values")["visible"]
        i_b = info_of(port)
        sample = asyncio.run(W.request(port, ref["reads"],
                                       timeout=SERVE_WAIT_S))
        i_b2 = info_of(port)
        pids = descendants(up["pid"])
        killed_b = kill_server(proc, pids, apps0, "13b")
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
        conn.close()
    rb = {"boot_s": up["boot_s"],
          "recovery_wall_s": float(i_b["recovery_wall_s"]),
          "recovery_mode": i_b["recovery_mode"],
          "recovery_shards": int(i_b["recovery_shards"]),
          "aof_recovery_source": i_b["aof_recovery_source"],
          "aof_recovered_ops": int(i_b["aof_recovered_ops"]),
          "visible_hash": canon_hash(without_tensors(vis)),
          "aof_visible_hash": canon_hash(aof_visible),
          "launches": server_launches(i_b2, cuda), "kill": killed_b}
    log(f"shards (13b): rebooted with the same flags: recovery "
        f"{rb['recovery_wall_s']} s ({rb['recovery_mode']}, "
        f"{rb['aof_recovery_source']}, {rb['aof_recovered_ops']} ops); "
        f"{len(vis)} traffic and tensor keys' visible values equal to 11a's "
        f"oracle's, the traffic keys' to 12b's, sample reads equal to "
        f"11a's {json.dumps(rb)}")
    if vis != ref["visible"] or without_tensors(vis) != aof_visible:
        diff = [k for k in set(vis) | set(ref["visible"])
                if vis.get(k) != ref["visible"].get(k)]
        raise AssertionError(f"shards (13b): {len(diff)} traffic keys "
                             f"differ from 11a's oracle, e.g. "
                             f"{sorted(diff)[:5]}")
    bad = differing_reads(ref, sample)
    if bad:
        raise AssertionError(f"shards (13b): {len(bad)} sample reads differ "
                             f"from 11a's, e.g. {bad[:4]}")
    if rb["recovery_mode"] != "bulk+shards2" or \
            rb["aof_recovery_source"] != "boot-snapshot+log" or \
            rb["aof_recovered_ops"] < n_req // 2:
        raise AssertionError(f"shards (13b): recovery {rb}")
    secs = time.perf_counter() - t_phase
    log(f"shards: phase {secs:.1f} s")
    keys_k = set(ra["launches"]) | set(rb["launches"])
    return {"a": ra, "b": rb, "secs": secs,
            "launches": {k: ra["launches"].get(k, 0) +
                         rb["launches"].get(k, 0) for k in keys_k}}


# ------------------------------------------------------------- phase 14

CLUSTER_OPS = 120_000       # bench.py --mode cluster's defaults
CLUSTER_CONNS = 4
CLUSTER_PIPELINE = 64
CLUSTER_KEYS = 2000
CLUSTER_GROUPS = 4
CLUSTER_SEED = 13
MIG_SLOTS = 128             # bench.py's migration range, slots [0, 128)
MIG_WRITES = 300            # 14b's writes to moved keys on the target,
MIG_WRITE_CHUNK = 50        # sent in pipelined chunks of this many
MIG_TIMEOUT_S = 600.0       # the migration's own bound


def cluster_worker(conn, argv: list, env: dict) -> None:
    """A phase-14 group server (spawned): the server entry's `amain`, as
    serve_worker runs it, with the migration's steps timed in this
    process (a source's slot exports and encodes and its calls to the
    target by verb; a target's IMPORT merges and digests) and a command
    pipe served on the node's loop: "stats", "pre" (a source's per-slot
    digests and the moved range's export, before MIGRATE), "slots" (a
    target's per-slot digests and canonical), "stop".  Sends {"port",
    boot numbers} once the node serves; after `amain` returns, the
    launches and, when "stop" asked for it, the canonical."""
    import asyncio
    import traceback

    os.environ.update(env)
    try:
        import numpy as np
        import torch

        from constdb_tpu_torch.bin.server import amain
        from constdb_tpu_torch.cluster import (NSLOTS, SLOT_FANOUT,
                                               SLOT_LEAVES, bucket_of_slot)
        from constdb_tpu_torch.cluster import migrate as MG
        from constdb_tpu_torch.conf import load_config
        from constdb_tpu_torch.ops import kernels as KN
        from constdb_tpu_torch.persist import snapshot as SN
        from constdb_tpu_torch.server.node import Node
        from constdb_tpu_torch.store.digest import (export_bucket_batch,
                                                    state_digest_matrix)

        cfg = load_config(argv)
        cuda = cfg.engine == "cuda" and cfg.device == "cuda"
        secs, counts, box = {}, {}, {"canon": False}

        def count(name, dt):
            secs[name] = secs.get(name, 0.0) + dt
            counts[name] = counts.get(name, 0) + 1

        def timed(name, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    count(name, time.perf_counter() - t0)
            return run

        MG.export_slot_batch = timed("export", MG.export_slot_batch)
        MG.slot_digest = timed("digest", MG.slot_digest)
        SN._encode_batch = timed("encode", SN._encode_batch)
        Node.merge_batches = timed("merge", Node.merge_batches)
        chan_call = MG._Chan.call

        async def timed_call(self, *parts):
            t0 = time.perf_counter()
            try:
                return await chan_call(self, *parts)
            finally:
                count("call_" + bytes(parts[1]).decode(),
                      time.perf_counter() - t0)
        MG._Chan.call = timed_call
        slot_range = MG.migrate_slot_range

        async def recorded(*a, **kw):
            t0 = time.perf_counter()
            box["mig"] = {"running": True}
            try:
                res = await slot_range(*a, **kw)
            except BaseException as e:
                box["mig"] = {"error": f"{type(e).__name__}: {e}"}
                raise
            box["mig"] = dict(res, wall_s=time.perf_counter() - t0)
            return res
        MG.migrate_slot_range = recorded

        def slot_digests(node, lo, hi):
            node.ensure_flushed()
            flat = state_digest_matrix(node.ks, SLOT_FANOUT,
                                       SLOT_LEAVES).reshape(-1)
            return [int(flat[bucket_of_slot(s)]) for s in range(lo, hi)]

        def encoded(node, mask):
            return bytes(SN._encode_batch(export_bucket_batch(
                node.ks, SLOT_FANOUT, SLOT_LEAVES, mask)))

        def stats(node):
            eng, cl, st = node.engine, node.cluster, node.stats
            out = {"launches": dict(KN.LAUNCHES), "secs": dict(secs),
                   "counts": dict(counts), "mig": box.get("mig"),
                   "keys": node.ks.n_keys(),
                   "cluster": dict(cl.info_pairs()), "gc_pin": cl.gc_pin(),
                   "bufs": [len(cl._import_buf), len(cl._export_buf)],
                   "stats": {k: getattr(st, k) for k in (
                       "serve_msgs_coalesced", "serve_flushes",
                       "serve_barriers", "cmds_processed")}}
            for k in ("dev_rounds_resident", "host_micro_rounds", "warmup",
                      "bytes_h2d", "h2d_copies"):
                out[k] = getattr(eng, k, None)
            for k in ("micro_rounds", "mirror_rebuilds", "mirror_patches"):
                v = getattr(eng, k, None)
                out[k] = {f: (list(x) if isinstance(x, (list, tuple))
                              else x) for f, x in v.items()} \
                    if v is not None else None
            if cuda:
                out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            return out

        def pre(node, lo, hi):
            t0 = time.perf_counter()
            dig = slot_digests(node, lo, hi)
            mask = np.zeros(NSLOTS, dtype=bool)
            mask[[bucket_of_slot(s) for s in range(lo, hi)]] = True
            payload = encoded(node, mask)
            full = len(encoded(node, np.ones(NSLOTS, dtype=bool)))
            secs.clear()
            counts.clear()
            return {"digests": dig, "range_payload": payload,
                    "full_bytes": full, "secs": time.perf_counter() - t0}

        def slots(node, lo, hi):
            node.ensure_flushed()
            return {"digests": slot_digests(node, lo, hi),
                    "canonical": node.ks.canonical(list(node.ks.key_bytes))}

        def stop(node, want_canon):
            box["canon"] = want_canon
            cfg.snapshot_path = ""      # no final dump: nothing reads it
            os.kill(os.getpid(), signal.SIGTERM)

        ops = {"stats": stats, "pre": pre, "slots": slots, "stop": stop}

        async def serve_pipe(node):
            loop = asyncio.get_running_loop()
            while True:
                op, args = await loop.run_in_executor(None, conn.recv)
                try:
                    out = ops[op](node, *args)
                except BaseException as e:
                    out = {"error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                if op == "stop":
                    return
                conn.send(out)

        t0 = time.perf_counter()

        def started(app):
            node = app.node
            # the cron's first tick and GC sweep, run here (as serve_worker
            # does): the restored tombstones are collected before any
            # digest is taken
            node.hlc.tick(False)
            node.gc()
            secs.clear()
            counts.clear()
            box["app"] = app
            box["pipe"] = asyncio.get_running_loop().create_task(
                serve_pipe(node))
            conn.send({"port": app.port, "addr": app.advertised_addr,
                       "boot_s": time.perf_counter() - t0,
                       "restored_keys": node.ks.n_keys(),
                       "recovery_wall_s": node.stats.extra.get(
                           "recovery_wall_s", 0.0),
                       "boot_launches": dict(KN.LAUNCHES)})

        asyncio.run(amain(cfg, started))
        node = box["app"].node
        res = stats(node)
        if box["canon"]:
            node.ensure_flushed()
            res["canonical"] = node.ks.canonical(list(node.ks.key_bytes))
        conn.send(res)
    except BaseException as e:  # the parent raises it
        conn.send({"error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()})
    finally:
        conn.close()


class Group:
    """The parent's handle on one cluster_worker."""

    def __init__(self, label: str, argv: list, env: dict):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.label = label
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=cluster_worker,
                                args=(child, argv, env))
        self.proc.start()
        child.close()
        self.up = None

    def wait_up(self) -> dict:
        if self.up is None:
            self.up = recv_msg(self.conn, self.label, "not up")
        return self.up

    @property
    def port(self) -> int:
        return self.wait_up()["port"]

    def call(self, op: str, *args, timeout: float = SERVE_WAIT_S):
        self.conn.send((op, args))
        if not self.conn.poll(timeout):
            raise AssertionError(f"cluster ({self.label}): no {op} reply "
                                 f"in {timeout} s")
        out = self.conn.recv()
        if "error" in out:
            raise AssertionError(f"cluster ({self.label}): {op}: "
                                 f"{out['error']}\n{out['traceback']}")
        return out

    def stop(self, want_canon: bool = False) -> dict:
        """The worker stops itself (SIGTERM in its own loop) and sends its
        last numbers."""
        self.conn.send(("stop", (want_canon,)))
        res = recv_msg(self.conn, self.label, "no result after stop")
        self.proc.join(timeout=SERVE_WAIT_S)
        if self.proc.exitcode != 0:
            raise AssertionError(f"cluster ({self.label}): exit "
                                 f"{self.proc.exitcode}")
        return res

    def close(self) -> None:
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=10)
        self.conn.close()


def reassemble(ops_per_conn: list, owner, groups_replies: list) -> list:
    """Per connection, the groups' replies put back in the connection's
    op order (a connection's ops keep their order inside each group)."""
    from constdb_tpu_torch.cluster import slot_of
    out = []
    next_conn = [0] * len(groups_replies)   # per group
    for ops in ops_per_conn:
        mine = {}
        for g, per in enumerate(groups_replies):
            if any(owner[slot_of(k)] == g for k, _ in ops):
                mine[g] = iter(per[next_conn[g]])
                next_conn[g] += 1
        out.append([next(mine[owner[slot_of(k)]]) for k, _ in ops])
    return out


def reply_hash(replies: list) -> str:
    import hashlib

    from constdb_tpu_torch.resp.codec import encode_msg
    h = hashlib.sha256()
    for m in replies:
        h.update(encode_msg(m))
    return h.hexdigest()


def pct_ms(rt: list, q: float) -> float:
    rt = sorted(rt)
    return 1e3 * rt[min(len(rt) - 1, int(q * len(rt)))] if rt else 0.0


def scaling_leg(dev, work: str) -> dict:
    """14a's traffic: bench.py --mode cluster's stream partitioned by slot
    owner over 4 group servers on the card, driven concurrently, then
    each group stopped with its canonical.  -> the raw results (the
    oracle and the checks are finish_scaling's)."""
    import asyncio

    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.cluster import even_split
    cuda = dev.type == "cuda"
    per = CLUSTER_OPS // CLUSTER_CONNS
    ops = [W.cluster_workload_ops(c, per, CLUSTER_KEYS, seed=CLUSTER_SEED)
           for c in range(CLUSTER_CONNS)]
    parts = W.partition_cluster_ops(ops, CLUSTER_GROUPS, CLUSTER_PIPELINE)
    one = W.partition_cluster_ops(ops, 1, CLUSTER_PIPELINE)[0]
    base = ["--port", "0", "--log-level", "warning"]
    env = {"CONSTDB_TORCH_CLUSTER": "1",
           "CONSTDB_TORCH_SLOT_GROUPS": str(CLUSTER_GROUPS)}
    groups = []
    try:
        t0 = time.perf_counter()
        for g in range(CLUSTER_GROUPS):
            groups.append(Group(
                f"14a g{g}", base + [
                    "--device", dev.type, "--node-id", str(g + 1),
                    "--cluster-group", str(g), "--work-dir",
                    os.path.join(work, f"a{g}")], env))
        for grp in groups:
            grp.wait_up()
        up_s = time.perf_counter() - t0
        rtts, replies, walls = [], [[] for _ in groups], [0.0] * len(groups)

        async def drive():
            t_start = time.perf_counter()

            async def one_group(g):
                r, _ = await W.serve_drive(groups[g].port, parts[g],
                                           replies=replies[g])
                walls[g] = time.perf_counter() - t_start
                rtts.extend(r)
            await asyncio.gather(*(one_group(g) for g in range(len(groups))))
            return time.perf_counter() - t_start
        wall = asyncio.run(asyncio.wait_for(drive(), SERVE_WAIT_S))
        ends = [grp.stop(want_canon=True) for grp in groups]
    finally:
        for grp in groups:
            grp.close()
    return {"ops": ops, "parts": parts, "one": one, "wall_s": wall,
            "walls": walls, "rtts": rtts, "replies": replies, "ends": ends,
            "up_s": up_s, "cuda": cuda,
            "owner": even_split(CLUSTER_GROUPS).owner}


def finish_scaling(a: dict, oracle) -> dict:
    """14a's oracle run and checks: the union of the groups' canonical()
    (visible values, bench.py's projection) equals the oracle's, every
    connection's replies put back in order equal the oracle's (their
    sha256 logged), no redirect anywhere, each group's K3 = its device
    rounds."""
    import asyncio

    from constdb_tpu_torch import workload as W
    o_replies = []
    t0 = time.perf_counter()
    asyncio.run(asyncio.wait_for(W.serve_drive(
        oracle.port, a["one"], replies=o_replies), SERVE_WAIT_S))
    o_wall = time.perf_counter() - t0
    o_end = oracle.stop(want_canon=True)
    total = sum(len(o) for o in a["ops"])
    got = reassemble(a["ops"], a["owner"], a["replies"])
    hashes = [reply_hash(r) for r in got]
    o_hashes = [reply_hash(r) for r in o_replies]
    if hashes != o_hashes:
        bad = [c for c, (x, y) in enumerate(zip(got, o_replies)) if x != y]
        raise AssertionError(f"cluster (14a): replies differ from the "
                             f"single-group oracle's on connections {bad}")
    union: dict = {}
    for end in a["ends"]:
        s = W.strip_canonical_times(end["canonical"])
        if union.keys() & s.keys():
            raise AssertionError("cluster (14a): two groups hold one key")
        union.update(s)
    want = W.strip_canonical_times(o_end["canonical"])
    if union != want:
        diff = [k for k in set(union) | set(want)
                if union.get(k) != want.get(k)]
        raise AssertionError(f"cluster (14a): {len(diff)} keys differ from "
                             f"the oracle's, e.g. {sorted(diff)[:5]}")
    redirects = [int(e["cluster"]["redirects_sent"]) for e in a["ends"]] + \
        [int(o_end["cluster"]["redirects_sent"])]
    if any(redirects):
        raise AssertionError(f"cluster (14a): redirects {redirects}")
    k3 = [e["launches"]["scatter_pair_src"] for e in a["ends"]]
    rounds = [e["dev_rounds_resident"] for e in a["ends"]]
    if a["cuda"] and (k3 != rounds or not all(k3)):
        raise AssertionError(f"cluster (14a): K3 launches {k3} against "
                             f"device rounds {rounds}")
    n_group = [sum(n for c in p for _, n in c) for p in a["parts"]]
    out = {"requests": total, "wall_s": a["wall_s"],
           "requests_per_s": total / a["wall_s"],
           "group_requests": n_group,
           "group_requests_per_s": [n / w for n, w in
                                    zip(n_group, a["walls"])],
           "reply_p50_ms": pct_ms(a["rtts"], 0.5),
           "reply_p99_ms": pct_ms(a["rtts"], 0.99),
           "reply_windows": len(a["rtts"]), "up_s": a["up_s"],
           "oracle_requests_per_s": total / o_wall,
           "keys": len(union), "reply_sha256": hashes,
           "redirects": redirects, "k3": k3, "dev_rounds": rounds,
           "peak_mem_bytes": [e.get("peak_mem_bytes") for e in a["ends"]],
           "coalesced": [e["stats"]["serve_msgs_coalesced"]
                         for e in a["ends"]]}
    log(f"cluster (14a): {total} requests of bench.py --mode cluster's "
        f"traffic ({CLUSTER_CONNS} connections, {CLUSTER_PIPELINE}-deep, "
        f"{CLUSTER_KEYS} keys each, seed {CLUSTER_SEED}) partitioned by slot "
        f"owner over {CLUSTER_GROUPS} group servers on the card: "
        f"{a['wall_s']:.3f} s ({out['requests_per_s']:.0f} requests/s "
        f"envelope; per group "
        f"{[round(x) for x in out['group_requests_per_s']]}), reply windows "
        f"p50 {out['reply_p50_ms']:.3f} ms, p99 {out['reply_p99_ms']:.3f} "
        f"ms; the union of the groups' {len(union)} keys, every "
        f"connection's replies and zero redirects equal to the single-group "
        f"CPU-engine oracle's ({out['oracle_requests_per_s']:.0f} "
        f"requests/s); K3 = device rounds per group {k3} "
        f"{json.dumps(out)}")
    out["launches"] = [e["launches"] for e in a["ends"]]
    return out


def migration_leg(dev, src, dst, t_spawn: float) -> dict:
    """14b and 14c: group 0 booted from the 1M-key file (cluster mode, 2
    slot groups), group 1 empty; a NearCacheClient on group 0 caches a
    key of the moved range and one outside it (14c: another
    connection's write and its own write drop the second), then CLUSTER
    MIGRATE 0 128 <group 1>, polled through CLUSTER INFO to its end;
    bench.py's checks, the slots' digests and the range's canonical on
    the target, writes to moved keys on the target read back, the
    slots_lost push and a reconnect's flush (14c)."""
    import asyncio

    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.client import NearCacheClient
    from constdb_tpu_torch.cluster import slot_of
    from constdb_tpu_torch.crdt import semantics as S
    from constdb_tpu_torch.engine.cpu import CpuMergeEngine
    from constdb_tpu_torch.persist.snapshot import _decode_batch
    from constdb_tpu_torch.resp.message import OK, Bulk, Err, Int
    from constdb_tpu_torch.store.keyspace import KeySpace
    cuda = dev.type == "cuda"
    up0, up1 = src.wait_up(), dst.wait_up()
    up_s = time.perf_counter() - t_spawn

    def req(grp, *cmds):
        return asyncio.run(W.request(grp.port, list(cmds),
                                     timeout=SERVE_WAIT_S))

    for grp, other in ((src, dst), (dst, src)):
        gid = 1 if other is dst else 0
        r = req(grp, (b"cluster", b"setaddr", b"%d" % gid,
                      other.up["addr"].encode()))
        if r != [OK]:
            raise AssertionError(f"cluster (14b): setaddr {r}")

    def key_in(lo, hi, tag):
        j = 0
        while not lo <= slot_of(b"nc:%s:%d" % (tag, j)) < hi:
            j += 1
        return b"nc:%s:%d" % (tag, j)
    # the range's last slot moves last, long after the client re-caches
    # its key behind MIGRATE (a CTRL command: like every CTRL command of
    # the reference's, it flushes every tracked client's cache)
    moved_k = key_in(MIG_SLOTS - 1, MIG_SLOTS, b"moved")
    stay_k = key_in(MIG_SLOTS, 8192, b"stays")

    async def wait_for(pred, what):
        t = time.perf_counter()
        while not pred():
            if time.perf_counter() - t > SERVE_WAIT_S:
                raise AssertionError(f"cluster (14c): no {what}")
            await asyncio.sleep(0.01)

    async def leg():
        nc = await NearCacheClient(up0["addr"]).connect()
        c = {}
        try:
            # 14c: fill, another connection's write, own write
            await W.request(src.port, [(b"set", moved_k, b"m1"),
                                       (b"set", stay_k, b"s1")])
            got = [await nc.get(moved_k), await nc.get(stay_k)]
            if got != [Bulk(b"m1"), Bulk(b"s1")] or \
                    await nc.get(stay_k) != Bulk(b"s1") or nc.hits != 1:
                raise AssertionError(f"cluster (14c): fill {got}")
            await W.request(src.port, [(b"set", stay_k, b"s2")])
            await wait_for(lambda: stay_k not in nc.cache,
                           "invalidation of another connection's write")
            c["other_write"] = nc.invalidations
            if await nc.get(stay_k) != Bulk(b"s2"):
                raise AssertionError("cluster (14c): stale after write")
            await nc.set(stay_k, b"s3")
            c["own_write_dropped"] = stay_k not in nc.cache
            if not c["own_write_dropped"] or \
                    await nc.get(stay_k) != Bulk(b"s3"):
                raise AssertionError("cluster (14c): own write kept")
            # 14b: the source's view before MIGRATE
            pre = await asyncio.to_thread(src.call, "pre", 0, MIG_SLOTS)
            tm = time.perf_counter()
            r = await W.request(src.port, [(
                b"cluster", b"migrate", b"0", b"%d" % MIG_SLOTS,
                up1["addr"].encode())])
            if r != [OK]:
                raise AssertionError(f"cluster (14b): MIGRATE {r}")
            await wait_for(lambda: not nc.cache, "MIGRATE's flush-all")
            c["migrate_flushes"] = nc.flushes
            got = [await nc.get(moved_k), await nc.get(stay_k)]
            # (the push the server owes for the client's own write came
            # long before MIGRATE: nothing is pending from here)
            inv = nc.invalidations
            if got != [Bulk(b"m1"), Bulk(b"s3")] or \
                    sorted(nc.cache) != sorted([moved_k, stay_k]):
                raise AssertionError(
                    f"cluster (14c): re-fill {got}, cached "
                    f"{sorted(nc.cache)}, {nc.invalidations} "
                    f"invalidations, {nc.flushes} flushes")
            # CLUSTER INFO polled on the target: on the source every poll
            # (CTRL) would flush the client's cache
            polls = 0
            while True:
                polls += 1
                info = (await W.request(dst.port, [(
                    b"cluster", b"info")]))[0].val.decode()
                ci = dict(ln.split(":", 1) for ln in info.split("\r\n")
                          if ln)
                if int(ci["migrations_in"]) >= MIG_SLOTS and \
                        ci["importing_slots"] == "0":
                    break
                if time.perf_counter() - tm > MIG_TIMEOUT_S:
                    raise AssertionError(f"cluster (14b): {ci}")
                await asyncio.sleep(0.05)
            mig_wall = time.perf_counter() - tm
            # 14c: the moved slot's invalidation, per slot
            await wait_for(lambda: moved_k not in nc.cache,
                           "slots_lost invalidation")
            c.update(slots_lost=nc.invalidations - inv,
                     flushes_after_migrate=nc.flushes - c["migrate_flushes"],
                     stay_cached=stay_k in nc.cache)
            if c["slots_lost"] != 1 or c["flushes_after_migrate"] or \
                    not c["stay_cached"]:
                raise AssertionError(f"cluster (14c): {c}")
            # 14c: a reconnect flushes the cache
            nc.writer.transport.abort()
            await wait_for(lambda: not nc._connected, "disconnect")
            c["flushed_on_disconnect"] = not nc.cache and \
                nc.flushes == c["migrate_flushes"] + 1
            await W.request(src.port, [(b"set", stay_k, b"s4")])
            await nc.connect()
            if not c["flushed_on_disconnect"] or \
                    await nc.get(stay_k) != Bulk(b"s4"):
                raise AssertionError(f"cluster (14c): reconnect {c}")
            return pre, mig_wall, polls, c
        finally:
            await nc.close()
    pre, mig_wall, polls, near = asyncio.run(
        asyncio.wait_for(leg(), MIG_TIMEOUT_S + 2 * SERVE_WAIT_S))
    s0, s1 = src.call("stats"), dst.call("stats")
    post = dst.call("slots", 0, MIG_SLOTS)
    # the moved range's export, merged by the CPU engine into an
    # empty store, is the target's state of those keys
    batch = _decode_batch(pre["range_payload"])
    ks = KeySpace()
    CpuMergeEngine().merge(ks, batch)
    want = ks.canonical(list(ks.key_bytes))
    target = post["canonical"]
    mig, cl0, cl1 = s0["mig"], s0["cluster"], s1["cluster"]
    rounds_per_slot = mig["rounds"] / max(1, mig["slots"])
    range_bytes = len(pre["range_payload"])
    # the restored keys of the range that are alive, by type
    alive = {}
    for k in batch.keys:
        kid = ks.lookup(k)
        if k != moved_k and ks.keys.ct[kid] >= ks.keys.dt[kid]:
            alive[k] = int(ks.keys.enc[kid])
    moved = list(alive)
    probe = next(k for k, e in alive.items() if e == S.ENC_BYTES)
    r_tgt, r_src = req(dst, (b"get", probe))[0], \
        req(src, (b"get", probe))[0]
    checks = {
        "slots": mig["slots"] == MIG_SLOTS,
        "epochs": int(cl0["cluster_epoch"]) ==
        int(cl1["cluster_epoch"]) == 1 + MIG_SLOTS,
        "migrations": int(cl0["migrations_out"]) ==
        int(cl1["migrations_in"]) == MIG_SLOTS,
        "settled": cl0["migrating_slots"] == cl1["importing_slots"] ==
        "0" and s0["gc_pin"] is None and s1["gc_pin"] is None and
        s0["bufs"] == [0, 0] and s1["bufs"] == [0, 0],
        "moved_serves_on_target": not isinstance(r_tgt, Err),
        "source_answers_moved": isinstance(r_src, Err) and
        r_src.val.startswith(b"MOVED %d " % slot_of(probe)),
        "shipped_bytes": mig["bytes"] <= range_bytes *
        rounds_per_slot * 1.5,
        "range_small": range_bytes < pre["full_bytes"] / 4,
        "slot_digests": post["digests"] == pre["digests"],
        "range_canonical": target == want,
    }
    if not all(checks.values()):
        raise AssertionError(f"cluster (14b): failed "
                             f"{[k for k, v in checks.items() if not v]}"
                             f"; {mig} {cl0} {cl1}")
    # writes to moved keys on the target, pipelined (serve rounds on
    # its resident planes), then read back
    cmds, expect = [], []
    for i, k in enumerate(moved[:MIG_WRITES]):
        if alive[k] == S.ENC_COUNTER:
            old = ks.counter_sum(ks.lookup(k))
            cmds += [(b"incr", k, b"7")]
            expect += [("incr", k, Int(old + 7))]
        elif alive[k] == S.ENC_BYTES:
            cmds += [(b"set", k, b"w%d" % i)]
            expect += [("set", k, Bulk(b"w%d" % i))]
        else:
            cmds += [(b"sadd", k, b"new%d" % i)]
            expect += [("sadd", k, Int(1))]
    k3_0 = s1["launches"]["scatter_pair_src"]
    r0 = s1["dev_rounds_resident"]
    # in chunks of MIG_WRITE_CHUNK: several serve rounds, past the warm-up
    wr = [x for i in range(0, len(cmds), MIG_WRITE_CHUNK)
          for x in req(dst, *cmds[i:i + MIG_WRITE_CHUNK])]
    reads = req(dst, *[(b"get", k) if op != "sadd" else
                       (b"sismember", k, b"new%d" % i)
                       for i, (op, k, _) in enumerate(expect)])
    bad = []
    for (op, k, want_r), w_r, r_r in zip(expect, wr, reads):
        if op == "incr" and (w_r != want_r or r_r != want_r):
            bad.append((k, w_r, r_r))
        elif op == "set" and (w_r != OK or r_r != want_r):
            bad.append((k, w_r, r_r))
        elif op == "sadd" and (w_r != want_r or r_r != Int(1)):
            bad.append((k, w_r, r_r))
    if bad:
        raise AssertionError(f"cluster (14b): {len(bad)} writes to moved "
                             f"keys not read back, e.g. {bad[:3]}")
    end0, end1 = src.stop(), dst.stop()
    k3_w = end1["launches"]["scatter_pair_src"] - k3_0
    rounds_w = end1["dev_rounds_resident"] - r0
    if cuda and (not k3_w or k3_w != rounds_w):
        raise AssertionError(f"cluster (14b): the writes to moved keys "
                             f"launched K3 {k3_w} times in {rounds_w} device "
                             f"rounds on the target")
    n = mig["slots"]
    per_slot = {k: s0["secs"].get(k, 0.0) / n for k in (
        "export", "encode", "call_import", "call_slotdigest",
        "call_finalize", "call_setslot")}
    per_slot.update(target_merge=s1["secs"].get("merge", 0.0) / n,
                    target_digest=s1["secs"].get("digest", 0.0) / n)
    out = {"boot_s": up0["boot_s"], "up_s": up_s, "restored_keys": up0["restored_keys"],
           "restore_s": up0["recovery_wall_s"], "wall_s": mig_wall,
           "polls": polls, "slots": n, "rounds": mig["rounds"],
           "s_per_slot": mig_wall / n, "per_slot_s": per_slot,
           "counts": s0["counts"], "target_counts": s1["counts"],
           "shipped_bytes": mig["bytes"], "range_bytes": range_bytes,
           "full_bytes": pre["full_bytes"], "moved_keys": len(moved) + 1,
           "pre_s": pre["secs"], "epoch": int(cl0["cluster_epoch"]),
           "writes": len(cmds), "k3_writes": k3_w, "rounds_writes": rounds_w,
           "target_mirror_rebuilds": end1["mirror_rebuilds"],
           "target_mirror_patches": end1["mirror_patches"],
           "source_launches": end0["launches"],
           "target_launches": end1["launches"],
           "peak_mem_bytes": [end0.get("peak_mem_bytes"),
                              end1.get("peak_mem_bytes")],
           "near_cache": near}
    log(f"cluster (14b): CLUSTER MIGRATE 0 {MIG_SLOTS} from group 0 "
        f"({up0['restored_keys']} keys restored in {up0['recovery_wall_s']} "
        f"s) to an empty group 1 on the card: {mig_wall:.3f} s "
        f"({mig_wall / n:.4f} s per slot; export "
        f"{per_slot['export']:.4f}, encode {per_slot['encode']:.4f}, IMPORT "
        f"calls {per_slot['call_import']:.4f} (the target's merges "
        f"{per_slot['target_merge']:.4f}), SLOTDIGEST calls "
        f"{per_slot['call_slotdigest']:.4f}, FINALIZE "
        f"{per_slot['call_finalize']:.4f}), {mig['rounds']} rounds, "
        f"{mig['bytes']} bytes shipped for a {range_bytes}-byte range "
        f"({pre['full_bytes']} bytes in all); epochs {out['epoch']}, "
        f"{MIG_SLOTS} migrations out and in, nothing left migrating or "
        f"importing, no GC pin, the moved keys' slot digests and canonical "
        f"on the target equal to the source's before MIGRATE, a moved key "
        f"served by the target and MOVED on the source; {len(cmds)} "
        f"writes to moved keys read back (K3 {k3_w} = {rounds_w} device "
        f"rounds on the target) {json.dumps(out)}")
    log(f"cluster (14c): a NearCacheClient on group 0: another "
        f"connection's write invalidated its key, its own write dropped "
        f"it locally, the slots_lost push invalidated the moved key alone, "
        f"a reconnect flushed the cache {json.dumps(near)}")
    return out


def cluster_phase(dev, boot_path: str, work: str) -> dict:
    """Phase 14: cluster mode on the card.  14a's traffic into its 4
    groups runs alone; its oracle's traffic then runs while 14b's group 0
    restores the 1M-key file.  -> numbers and launches."""
    t_phase = time.perf_counter()
    a = scaling_leg(dev, work)
    copy = os.path.join(work, "b_boot.snapshot")
    shutil.copy(boot_path, copy)
    base = ["--port", "0", "--log-level", "warning"]
    env = {"CONSTDB_TORCH_CLUSTER": "1", "CONSTDB_TORCH_SLOT_GROUPS": "2"}
    t_spawn = time.perf_counter()
    procs = [Group("14a oracle", base + [
        "--engine", "cpu", "--node-id", "1", "--work-dir",
        os.path.join(work, "a_oracle")],
        {"CONSTDB_TORCH_CLUSTER": "1", "CONSTDB_TORCH_SLOT_GROUPS": "1"})]
    try:
        for g, extra in ((0, ["--snapshot", copy]), (1, [])):
            procs.append(Group(f"14b g{g}", base + [
                "--device", dev.type, "--node-id", str(g + 1),
                "--cluster-group", str(g), "--work-dir",
                os.path.join(work, f"b{g}"), *extra], env))
        ra = finish_scaling(a, procs[0])
        b = migration_leg(dev, procs[1], procs[2], t_spawn)
    finally:
        for p in procs:
            p.close()
    secs = time.perf_counter() - t_phase
    names = set(b["source_launches"]) | set(b["target_launches"])
    launches = {k: sum(x.get(k, 0) for x in ra["launches"]) +
                b["source_launches"].get(k, 0) +
                b["target_launches"].get(k, 0) for k in names}
    log(f"cluster: phase {secs:.1f} s; kernels {launches}")
    if dev.type == "cuda" and not (launches.get("scatter_pair_src") and
                                   launches.get("segment_sum")):
        raise AssertionError(f"cluster: K3 and K4 must launch: {launches}")
    return {"a": ra, "b": b, "secs": secs, "launches": launches}


CHAOS_SEED = 7              # python -m constdb_tpu_torch.chaos's defaults
CHAOS_OPS = 30


def journal_lines(cell: str, journal, canon: dict) -> list:
    """A certified cell's journal as JSON lines: a header naming the cell,
    the certified canonical's hash and key count, then one line an op
    (origin, uuid, name, args as one RESP array), for an off-card replay
    through the reference's OpJournal."""
    from constdb_tpu_torch.resp.codec import encode_msg
    from constdb_tpu_torch.resp.message import Arr
    out = [json.dumps({"cell": cell, "canon_hash": canon_hash(canon),
                       "canonical_keys": len(canon),
                       "ops": len(journal.ops)})]
    for (origin, uuid), (name, args) in sorted(journal.ops.items()):
        out.append(json.dumps({"origin": origin, "uuid": uuid,
                               "name": name.hex(),
                               "args": encode_msg(Arr(args)).hex()}))
    return out


def chaos_phase(dev, journal_path: str = "") -> dict:
    """Phase 15: the port's 8 card cells of the chaos harness's matrix
    (constdb_tpu_torch/chaos), each certify_scenario(7, cell, ops=30) on
    `dev` and certified by the harness's own oracle.  The harness runs
    unchanged; this phase wraps NodeSpec.build_engine (every engine a
    cell builds, restarts included), the scenario's OpJournal and its
    certify_state (the journal and the certified canonical).  Writes the
    first torch-resident cell's journal to `journal_path` when given.
    -> per-cell results and the launches summed over the cells."""
    import torch
    from constdb_tpu_torch.chaos import (NodeSpec, certify_scenario,
                                         matrix_cells, run_scenario)
    from constdb_tpu_torch.chaos import oracle as CO
    from constdb_tpu_torch.chaos import scenario as CS
    from constdb_tpu_torch.engine.cpu import CpuMergeEngine
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine
    from constdb_tpu_torch.ops import kernels as KN

    cuda = dev.type == "cuda"
    cells = [c for c in matrix_cells(dev.type) if c.engine != "cpu"]
    if len(cells) != 8:
        raise AssertionError(f"chaos: {len(cells)} card cells, want 8")
    built: list = []
    journals: list = []
    canons: list = []
    build = NodeSpec.build_engine

    def build_engine(spec):
        eng = build(spec)
        built.append((spec.engine, eng))
        return eng

    class Journal(CO.OpJournal):
        def __init__(self):
            super().__init__()
            journals.append(self)

    async def certify(cluster, journal, timeout=30.0):
        canon = await CO.certify_state(cluster, journal, timeout)
        canons.append(canon)
        return canon

    saved = (NodeSpec.build_engine, CS.OpJournal, CS.certify_state)
    NodeSpec.build_engine = build_engine
    CS.OpJournal, CS.certify_state = Journal, certify
    results: list = []
    launches = {k: 0 for k in KN.LAUNCHES}
    t_phase = time.perf_counter()
    try:
        for cell in cells:
            built.clear()
            journals.clear()
            canons.clear()
            gc.collect()
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            mem0 = torch.cuda.memory_allocated(dev) if cuda else 0
            KN.reset_launches()
            t0 = time.perf_counter()
            stats = run_scenario(certify_scenario(CHAOS_SEED, cell,
                                                  ops=CHAOS_OPS))
            secs = time.perf_counter() - t0
            got = dict(KN.LAUNCHES)
            peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            card = [e for kind, e in built if kind != "cpu"]
            cpu = [e for kind, e in built if kind == "cpu"]
            bad = [(kind, type(e).__name__, str(getattr(e, "device", "")))
                   for kind, e in built
                   if (kind == "cpu" and type(e) is not CpuMergeEngine) or
                   (kind != "cpu" and (type(e) is not TorchMergeEngine or
                                       e.device.type != dev.type))]
            if bad or len(card) != 3 or len(cpu) != 1:
                raise AssertionError(
                    f"chaos {cell.name}: engines {bad or built}; want 3 "
                    f"TorchMergeEngines on {dev.type} (nodes 0, 1 and node "
                    f"1's cold restart) and the CPU engine of node 2")
            rounds = sum(e.dev_rounds_resident for e in card)
            if cuda and cell.engine == "torch-resident" and not (
                    got["scatter_pair_src"] == rounds > 0):
                raise AssertionError(
                    f"chaos {cell.name}: K3 launched "
                    f"{got['scatter_pair_src']} times, the card engines "
                    f"ran {rounds} device rounds (want equal, > 0)")
            if cuda and not sum(got.values()):
                raise AssertionError(f"chaos {cell.name}: no kernel "
                                     f"launched")
            if len(journals) != 1 or len(canons) != 1:
                raise AssertionError(f"chaos {cell.name}: no certified "
                                     f"canonical")
            canon = canons[0]
            gc.collect()
            mem1 = torch.cuda.memory_allocated(dev) if cuda else 0
            res = {"cell": cell.name, "secs": round(secs, 3),
                   "journal_ops": stats["journal_ops"],
                   "reconnects": stats["reconnects"],
                   "wire_demotions": stats["wire_demotions"],
                   "plane": stats["plane"], "launches": got,
                   "dev_rounds": rounds,
                   "peak_mem_bytes": peak - mem0,
                   "mem_after_bytes": mem1 - mem0,
                   "canonical_keys": len(canon),
                   "canon_hash": canon_hash(canon)}
            log(f"chaos: {json.dumps(res)}")
            results.append(res)
            for k, v in got.items():
                launches[k] += v
            if journal_path and cell.engine == "torch-resident" and \
                    not any(r.get("journal") for r in results):
                with open(journal_path, "w") as f:
                    f.write("\n".join(journal_lines(
                        cell.name, journals[0], canon)) + "\n")
                res["journal"] = journal_path
                log(f"chaos: {cell.name}'s journal ({len(journals[0].ops)}"
                    f" ops) written to {journal_path}")
    finally:
        NodeSpec.build_engine = saved[0]
        CS.OpJournal, CS.certify_state = saved[1], saved[2]
        built.clear()
    secs = time.perf_counter() - t_phase
    log(f"chaos: phase {secs:.1f} s, {len(results)}/8 card cells "
        f"certified; kernels {launches}")
    return {"cells": results, "secs": secs, "launches": launches}


def server_phases(dev, boot_path: str, work: str, n_ops: int,
                  n_keys: int) -> tuple:
    """Phases 11-13 on one boot file.  -> their results."""
    server = server_phase(dev, boot_path, work, n_ops, n_keys)
    aof = aof_phase(dev, boot_path, work, n_ops, server["ref"])
    shards = shards_phase(dev, boot_path, work, server["ref"],
                          aof["visible"])
    return server, aof, shards


# ------------------------------------------------------------- phase 16

MULTI_PARTS = 4              # range partitions of the one card (16b)
MULTI_R, MULTI_S = 8, 1 << 20   # the rep x kv step's [R, S] (16c)


def lint_phase() -> dict:
    """16a: the port's lint over this checkout, in --baseline mode: exit
    0, zero findings, no growth."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "constdb_tpu_torch.analysis",
                          "--baseline", "--json"], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    try:
        payload = json.loads(out.stdout)
    except ValueError:
        payload = None
    if out.returncode != 0 or payload is None or payload["findings"] or \
            payload["baseline"]["growth"]:
        raise AssertionError(f"lint: exit {out.returncode}, output "
                             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    log(f"multi: lint (python -m constdb_tpu_torch.analysis --baseline) "
        f"exit 0, {len(payload['findings'])} findings, "
        f"{len(payload['baseline']['growth'])} over the baseline, "
        f"{secs:.2f} s")
    return {"findings": len(payload["findings"]), "secs": secs}


def partition_check(eng, store) -> dict:
    """16b: every resident column of the partitioned engine is one tensor
    per partition, on its device, of cap / K rows, holding exactly its
    range of the flushed host column (the pad rows past the plane's
    rows neutral).  -> {family: (cap, rows, [partition sizes])}."""
    import numpy as np

    from constdb_tpu_torch.engine import cuda as C
    sizes = {}
    kk = len(eng._devs)
    for fam, res in eng._res.items():
        cap, n = res["cap"], res["n"]
        p = cap // kk
        table = C._host_table(store, fam)
        spec = C._FAMILIES[fam]
        for name, parts in res["cols"].items():
            if len(parts) != kk or any(
                    x.device != d or x.shape[0] != p
                    for x, d in zip(parts, eng._devs)):
                raise AssertionError(
                    f"multi: {fam}.{name} partitions "
                    f"{[(str(x.device), x.shape[0]) for x in parts]}, want "
                    f"{kk} of {p} rows on {[str(d) for d in eng._devs]}")
            if fam == "env":
                host = np.stack([table.col(c)[:n] for c, _ in spec], axis=-1)
                fill = 0
            else:
                host = table.col(name)[:n]
                fill = dict(spec)[name]
            for k, x in enumerate(parts):
                got = x.cpu().numpy()
                lo, hi = k * p, min(n, (k + 1) * p)
                m = max(0, hi - lo)
                if not (np.array_equal(got[:m], host[lo:hi]) and
                        (got[m:] == fill).all()):
                    raise AssertionError(
                        f"multi: {fam}.{name} partition {k} does not hold "
                        f"rows [{lo}, {lo + p}) of the plane")
        sizes[fam] = (cap, n, [min(p, max(0, n - k * p)) for k in range(kk)])
    return sizes


def partitioned_catchup(dev, n_keys: int, n_rep: int, seed: int,
                        oracle: tuple, want_digest: int,
                        phase5_kps: float) -> dict:
    """16b: phase 5's catch-up through the kv range-partitioned engine on
    MULTI_PARTS partitions of `dev`."""
    import torch

    from constdb_tpu_torch import workload as W
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine
    from constdb_tpu_torch.ops import kernels as KN
    from constdb_tpu_torch.store.keyspace import KeySpace
    label = f"multi: partitioned catch-up ({MULTI_PARTS} partitions)"
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    chunks = W.chunk_batches(W.make_workload(n_keys, n_rep, seed=seed,
                                             aligned_counters=True),
                             CHUNK_KEYS)
    t_gen = time.perf_counter() - t0
    eng = TorchMergeEngine(resident=True, dense_fold="cuda",
                           devices=[dev] * MULTI_PARTS)
    store = KeySpace()
    try:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        KN.reset_launches()
        t0 = time.perf_counter()
        for i in range(0, len(chunks), n_rep):
            eng.merge_many(store, chunks[i:i + n_rep])
        eng.flush(store)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(KN.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) if on_card else None
        del chunks
        sizes = partition_check(eng, store)
        per_part = [dict(c) for c in eng.partition_launches]
        resplits = eng.resplits
        fam_secs = {k: round(v, 3) for k, v in eng.family_secs.items()}
        stage_secs = {k: round(v, 3) for k, v in eng.stage_secs.items()}
        t0 = time.perf_counter()
        digest = full_state_digest(store)
        sub_keys, want = oracle
        mism = W.compare_canonical(store.canonical(keys=sub_keys), want)
        t_ver = time.perf_counter() - t0
    finally:
        eng.release_device_pools(store)
        eng.close()
    if mism:
        raise AssertionError(f"{label}: {mism} of {len(sub_keys)} keys "
                             "differ from the CPU oracle")
    if digest != want_digest:
        raise AssertionError(f"{label}: digest {digest:#x}, phase 5's "
                             f"store {want_digest:#x}")
    names = ("merge_elems", "merge_counters", "segment_sum")
    if any(c[k] < 1 for c in per_part for k in names):
        raise AssertionError(f"{label}: per-partition kernel calls "
                             f"{per_part}; K1, K2 and K4 must run in every "
                             "partition")
    if on_card and any(sum(c[k] for c in per_part) != launches[k]
                       for k in names):
        raise AssertionError(f"{label}: per-partition calls {per_part} do "
                             f"not sum to the launches {launches}")
    out = {"wall_s": wall, "keys_per_s": n_keys / wall,
           "phase5_keys_per_s": phase5_kps, "launches": launches,
           "per_partition": per_part, "resplits": resplits,
           "partition_rows": sizes, "peak_mem_bytes": peak,
           "verified_keys": len(sub_keys), "digest": digest,
           "gen_s": t_gen, "verify_s": t_ver, "family_secs": fam_secs,
           "stage_secs": stage_secs}
    log(f"{label}: {n_keys} keys x {n_rep} replicas, groups of {n_rep}, "
        f"dense_fold=cuda: {wall:.3f} s ({out['keys_per_s']:.0f} keys/s; "
        f"phase 5, one partition, same call: {phase5_kps:.0f} keys/s), "
        f"launches {launches}, per partition (K1 merge_elems, K2 "
        f"merge_counters, K4 segment_sum) {per_part}, re-splits "
        f"{resplits}, rows per partition (cap, rows, [per partition]) "
        f"{sizes}, peak device memory {peak} bytes, family_secs "
        f"{fam_secs}, stage_secs {stage_secs}; digest {digest:#x} "
        f"equals phase 5's; verified {len(sub_keys)} keys, 0 mismatches "
        f"(gen {t_gen:.1f} s, verify {t_ver:.1f} s)")
    return out


def collective_check(dev, seed: int) -> dict:
    """16c: the rep x kv step over a world of one rank (NCCL on the card,
    gloo on the CPU) at [MULTI_R, MULTI_S], bit-equal to the plain dense
    ops; the process group is destroyed at the end."""
    import torch
    import torch.distributed as dist

    from constdb_tpu_torch.entry import _example_arrays, merge_step
    from constdb_tpu_torch.ops.segment import NEUTRAL_T
    from constdb_tpu_torch.parallel import sharded as SH
    arrays = _example_arrays(MULTI_R, MULTI_S, seed=seed)
    SH.init_world(0, 1, f"tcp://127.0.0.1:{SH._free_port()}", dev)
    try:
        backend = dist.get_backend()
        mesh = SH.make_mesh(1, dev)
        step = SH.sharded_merge_step(mesh)
        blocks = SH.shard_batch_arrays(mesh, *arrays)
        secs = []
        for _ in range(2):   # the first call also sets up the communicator
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = step(*blocks)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        want = merge_step(*(torch.from_numpy(a).to(dev) for a in arrays))
        for name, g, w in zip(("V", "T", "AT", "AN", "DT", "WIN", "ENV"),
                              got[:7], want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"multi: rep x kv step {name} differs "
                                     "from the plain dense ops")
        touched = int((want[1] > NEUTRAL_T).sum())
        if got[7] != touched:
            raise AssertionError(f"multi: touched {got[7]}, plain {touched}")
        all_reduces = step.all_reduces
    finally:
        dist.destroy_process_group()
    log(f"multi: rep x kv step over {backend} (world 1, mesh 1x1) at "
        f"[{MULTI_R}, {MULTI_S}] (env [{MULTI_R}, {MULTI_S}, 4]) bit-equal "
        f"to the plain dense ops on the card: {all_reduces} all-reduces in "
        f"2 steps, first step {secs[0] * 1e3:.2f} ms (with the "
        f"communicator's setup), second {secs[1] * 1e3:.2f} ms, touched "
        f"{touched}; process group destroyed")
    return {"backend": backend, "all_reduces": all_reduces,
            "first_step_ms": secs[0] * 1e3, "step_ms": secs[1] * 1e3,
            "touched": touched}


def multi_phase(dev, n_keys: int, n_rep: int, seed: int, oracle: tuple,
                want_digest: int, phase5_kps: float) -> dict:
    """Phase 16: the lint, the partitioned catch-up and the collectives
    (module docstring)."""
    from constdb_tpu_torch.entry import dryrun_multichip
    from constdb_tpu_torch.ops import kernels as KN
    t_phase = time.perf_counter()
    lint = lint_phase()
    catch = partitioned_catchup(dev, n_keys, n_rep, seed, oracle,
                                want_digest, phase5_kps)
    coll = collective_check(dev, seed)
    t0 = time.perf_counter()
    KN.reset_launches()
    dry = dryrun_multichip(1, dev.type)
    dry_launches = dict(KN.LAUNCHES)
    log(f"multi: dryrun_multichip(1) {dry} in "
        f"{time.perf_counter() - t0:.2f} s, launches {dry_launches}")
    secs = time.perf_counter() - t_phase
    log(f"multi: phase {secs:.1f} s (target 60 s)")
    launches = {k: catch["launches"][k] + dry_launches[k]
                for k in catch["launches"]}
    return {"lint": lint, "catchup": catch, "collective": coll,
            "dryrun": dry, "launches": launches, "secs": secs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--frames", type=int, default=200_000)
    ap.add_argument("--stream-keys", type=int, default=20_000)
    ap.add_argument("--serve-ops", type=int, default=200_000)
    ap.add_argument("--phases", choices=["all", "server", "cluster",
                                         "chaos", "multi"],
                    default="all",
                    help="server: phases 11-13 only, cluster: phase 14 "
                         "only, chaos: phase 15 only, multi: phase 5 then "
                         "phase 16 (rehearsals; no kernels line, no "
                         "result line)")
    ap.add_argument("--chaos-journal", default="",
                    help="write phase 15's first torch-resident cell's "
                         "journal and certified canonical hash here")
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
    rep = args.replicas
    if args.phases == "chaos":
        chaos_phase(dev, args.chaos_journal)
        log(f"total: {time.perf_counter() - t_start:.1f} s (phase 15)")
        print(smi, flush=True)
        return 0
    if args.phases == "multi":
        fold, eng5, store5, batches5 = catchup(
            dev, args.keys, rep, args.seed, rep, "cuda", True,
            "catch-up (device fold)")
        eng5.close()
        digest5 = full_state_digest(store5)
        oracle = (W.subsample_keys(batches5[0].keys, args.keys),
                  W.oracle_canonical(batches5, args.keys))
        del eng5, store5, batches5
        multi_phase(dev, args.keys, rep, args.seed, oracle, digest5,
                    fold["keys_per_s"])
        log(f"total: {time.perf_counter() - t_start:.1f} s (phases 5, 16)")
        print(smi, flush=True)
        return 0
    if args.phases != "all":
        server_dir = tempfile.mkdtemp(prefix="constdb_chip_smoke_server_")
        try:
            boot_path = os.path.join(server_dir, "boot.snapshot")
            write_boot_file(boot_path, W.make_workload(
                args.keys, rep, seed=args.seed, aligned_counters=True)[0])
            if args.phases == "server":
                server_phases(dev, boot_path, server_dir, args.serve_ops,
                              args.keys)
            else:
                cluster_phase(dev, boot_path, server_dir)
        finally:
            shutil.rmtree(server_dir, ignore_errors=True)
        which = "phases 11-13" if args.phases == "server" else "phase 14"
        log(f"total: {time.perf_counter() - t_start:.1f} s ({which})")
        print(smi, flush=True)
        return 0
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

    def elapsed(what: str) -> None:
        log(f"elapsed: {time.perf_counter() - t_start:.1f} s after {what}")

    elapsed("phases 1-3")
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
    elapsed("phases 4-6")
    tensor = tensor_phase(dev)
    # phase 5's batches again, from its seed: they are not kept alive
    # through phases 6-7, and the files are written after them
    fold_batches = W.make_workload(args.keys, rep, seed=args.seed,
                                   aligned_counters=True)
    server_dir = tempfile.mkdtemp(prefix="constdb_chip_smoke_server_")
    try:
        file_dir = tempfile.mkdtemp(prefix="constdb_chip_smoke_")
        try:
            # phase 11's boot file: phase 5's replica 0, written outside
            # any span while its batches are alive
            boot_path = os.path.join(server_dir, "boot.snapshot")
            t0 = time.perf_counter()
            size = write_boot_file(boot_path, fold_batches[0])
            log(f"server: boot file (phase 5's replica 0, NodeMeta("
                f"node_id=1)) {size} bytes in "
                f"{time.perf_counter() - t0:.3f} s")
            paths = write_files(file_dir, fold_batches)
            files = file_phase(dev, args.keys, rep, args.seed, fold, paths,
                               fold_batches)
            corrupt_check(dev, file_dir, args.seed)
            oracle = (W.subsample_keys(fold_batches[0].keys, args.keys),
                      W.oracle_canonical(fold_batches, args.keys))
            sharded = sharded_phase(dev, args.keys, rep, paths,
                                    fold_batches, oracle, files["digest"])
            local = local_phase(dev, args.keys, rep, fold_batches, oracle,
                                fold_digest)
        finally:
            shutil.rmtree(file_dir, ignore_errors=True)
        del fold_batches
        elapsed("phases 7-9")
        repl = replication_phase(dev, args.frames, args.stream_keys)
        server, aof, shards = server_phases(dev, boot_path, server_dir,
                                            args.serve_ops, args.keys)
        elapsed("phases 10-13")
        cluster = cluster_phase(dev, boot_path, server_dir)
    finally:
        shutil.rmtree(server_dir, ignore_errors=True)
    elapsed("phase 14")
    chaos = chaos_phase(dev, args.chaos_journal)
    elapsed("phase 15")
    multi = multi_phase(dev, args.keys, rep, args.seed, oracle, fold_digest,
                        fold["keys_per_s"])

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
                   "wire": repl["launches"]["wire"][name],
                   "serve": server["launches"]["serve"][name],
                   "restore": server["launches"]["restore"][name],
                   "sync": server["launches"]["sync"][name],
                   "aof": aof["launches"].get(name, 0),
                   "shards": shards["launches"].get(name, 0),
                   "cluster": cluster["launches"].get(name, 0),
                   "chaos": chaos["launches"].get(name, 0),
                   "multi": multi["launches"].get(name, 0)}
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
