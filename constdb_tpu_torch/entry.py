"""Entry points of the port: the twin of the reference's __graft_entry__.py.

entry(device=None): the single-device forward step on the flagship
computation, the dense multi-family CRDT merge (counters, elements,
envelopes) behind snapshot ingest and replica catch-up, on the port's
ops/dense.py.  -> (fn, example_args).

dryrun_multichip(n, device=None): runs the port's two multi-device
paths over n devices and checks each: (1) the production merge engine
with its per-slot state range-partitioned over n partitions
(TorchMergeEngine(devices=engine_mesh(n))), fed snapshot chunks and held
canonical()-equal to the CPU engine; (2) the dense rep x kv step over an
n-rank torch.distributed world (parallel/sharded.py), held bit-equal to
the single-device dense ops.  On CUDA each partition and each rank takes
its own card, and fewer than n cards raise; device="cpu" runs both on
the CPU (gloo).

    python -m constdb_tpu_torch.entry [--n N] [--device cpu]
"""

from __future__ import annotations

import numpy as np


def _example_arrays(R: int, S: int, seed: int = 0):
    """The reference's example stacks, drawn from a seeded numpy
    generator: vals/ts [R, S] counters, at/an/dt [R, S] elements, env
    [R, S, 4] envelopes (int64)."""
    from .ops.segment import NEUTRAL_T

    rng = np.random.default_rng(seed)
    ts = np.where(rng.random((R, S)) < 0.3, NEUTRAL_T,
                  rng.integers(1, 1000, (R, S)).astype(np.int64) << 22)
    vals = rng.integers(-50, 50, (R, S)).astype(np.int64)
    at = np.where(rng.random((R, S)) < 0.3, NEUTRAL_T,
                  rng.integers(1, 500, (R, S)).astype(np.int64) << 22)
    an = rng.integers(1, 9, (R, S)).astype(np.int64)
    dt = rng.integers(0, 500, (R, S)).astype(np.int64) << 22
    env = rng.integers(0, 1000, (R, S, 4)).astype(np.int64) << 22
    return vals, ts, at, an, dt, env


def merge_step(vals, ts, at, an, dt, env):
    """The dense merge of one [R, S] group of every family:
    -> (v, t, a, n, d, win, e) per slot."""
    from .ops import dense as D

    v, t = D.dense_merge_counters(vals, ts)
    a, n, d, win = D.dense_merge_elems(at, an, dt)
    e = D.dense_max(env)
    return v, t, a, n, d, win, e


def entry(device=None):
    """-> (fn, example_args): the single-device merge step and its example
    tensors (_example_arrays(R=8, S=1024)) on `device` (None = the CUDA
    card; raises without one)."""
    import torch

    from .utils.device import resolve_device

    dev = resolve_device(device)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in _example_arrays(R=8, S=1024))
    return merge_step, args


def _gen_keyspace(seed: int, node: int, n_ops: int = 200):
    """Random op-rule-respecting CRDT state for one writer node (the
    reference entry's generator, on the port's KeySpace)."""
    import random

    from .crdt import ENC_BYTES, ENC_COUNTER, ENC_DICT, ENC_SET
    from .store.keyspace import KeySpace

    rng = random.Random(seed)
    keys = [p + b"%d" % i for p in (b"c", b"r", b"s", b"d") for i in range(8)]
    members = [b"m%d" % i for i in range(12)]
    enc_of = {b"c": ENC_COUNTER, b"r": ENC_BYTES, b"s": ENC_SET,
              b"d": ENC_DICT}
    ks = KeySpace()
    for _ in range(n_ops):
        key = rng.choice(keys)
        enc = enc_of[key[:1]]
        uuid = (rng.randrange(1, 40) << 22) | rng.randrange(0, 3)
        kid, _ = ks.get_or_create(key, enc, uuid)
        if enc == ENC_COUNTER:
            ks.counter_change(kid, node, rng.choice([1, -1]), uuid)
        elif enc == ENC_BYTES:
            ks.register_set(kid, b"v%d:%d" % (node, rng.randrange(50)),
                            uuid, node)
            continue
        elif rng.random() < 0.6:
            val = b"x%d" % rng.randrange(50) if enc == ENC_DICT else None
            ks.elem_add(kid, rng.choice(members), val, uuid, node)
        else:
            ks.elem_rem(kid, rng.choice(members), uuid)
        ks.updated_at(kid, uuid)
    return ks


def _step_rank(rank: int, world: int, device, rep: int, arrays) -> dict:
    """One rank of the dryrun's dense step: its slices of every output,
    the touched count and the collectives it issued."""
    from .parallel.sharded import (make_mesh, shard_batch_arrays,
                                   sharded_merge_step)

    mesh = make_mesh(rep, device)
    step = sharded_merge_step(mesh)
    out = step(*shard_batch_arrays(mesh, *arrays))
    return {"rep_idx": mesh.rep_idx, "kv_idx": mesh.kv_idx,
            "cols": [t.cpu().numpy() for t in out[:7]], "touched": out[7],
            "all_reduces": step.all_reduces}


def gather_step(results: list) -> tuple:
    """The rank results of a dense step (each rank's _step_rank dict) ->
    the global (V, T, AT, AN, DT, WIN, ENV, touched): each kv column's
    slice taken from its rep-row-0 rank, after checking that every rank
    of a column holds the same slice and every rank the same count."""
    kv = max(r["kv_idx"] for r in results) + 1
    by_col = {r["kv_idx"]: r for r in results if r["rep_idx"] == 0}
    for r in results:
        ref = by_col[r["kv_idx"]]
        for a, b in zip(r["cols"], ref["cols"]):
            if not np.array_equal(a, b):
                raise AssertionError("ranks of one mesh column disagree")
        if r["touched"] != ref["touched"]:
            raise AssertionError("ranks disagree on the touched count")
    cols = tuple(np.concatenate([by_col[j]["cols"][i] for j in range(kv)])
                 for i in range(7))
    return cols + (results[0]["touched"],)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run and check the port's two multi-device paths over n devices
    (module docstring); raises on any mismatch.  -> a summary dict."""
    import torch

    from .engine.base import batch_from_keyspace
    from .engine.cpu import CpuMergeEngine
    from .engine.cuda import TorchMergeEngine
    from .ops import dense as D
    from .ops.segment import NEUTRAL_T
    from .parallel.sharded import engine_mesh, run_world
    from .persist.snapshot import batch_chunks
    from .store.keyspace import KeySpace

    # ---- 1: the production engine, kv range-partitioned, vs the CPU oracle
    devices = engine_mesh(n_devices, device)
    srcs = [_gen_keyspace(seed=i, node=i + 1) for i in range(3)]
    chunks = [c for s in srcs
              for c in batch_chunks(batch_from_keyspace(s), 23)]
    cpu_store = KeySpace()
    cpu = CpuMergeEngine()
    for c in chunks:
        cpu.merge(cpu_store, c)
    part_store = KeySpace()
    eng = TorchMergeEngine(resident=True, devices=devices)
    for c in chunks:
        eng.merge(part_store, c)
    eng.flush(part_store)
    eng.close()
    if part_store.canonical() != cpu_store.canonical():
        raise AssertionError("kv range-partitioned engine diverged from the "
                             "CPU engine")
    n_keys = part_store.n_keys()

    # ---- 2: the dense rep x kv step with its collectives
    rep = 2 if n_devices % 2 == 0 else 1
    R = 4 * rep                    # divides the "rep" axis
    S = 64 * (n_devices // rep)    # divides the "kv" axis
    arrays = _example_arrays(R, S, seed=1)
    results = run_world(n_devices, _step_rank, (rep, arrays), device)
    V, T, AT, AN, DT, WIN, ENV, touched = gather_step(results)
    # against the single-device dense ops on the first device
    want = merge_step(*(torch.from_numpy(a).to(devices[0])
                        for a in arrays))
    want = [w.cpu().numpy() for w in want]
    for name, got, w in zip(("V", "T", "AT", "AN", "DT", "WIN", "ENV"),
                            (V, T, AT, AN, DT, WIN, ENV), want):
        if got.shape != w.shape or not np.array_equal(got, w):
            raise AssertionError(f"dense step {name} differs from the "
                                 "single-device dense ops")
    if touched != int(np.sum(want[1] > NEUTRAL_T)):
        raise AssertionError("dense step touched count differs")
    out = {"n": n_devices, "engine_keys": n_keys,
           "engine_resplits": eng.resplits, "rep": rep,
           "kv": n_devices // rep, "R": R, "S": S, "touched": touched,
           "all_reduces": sum(r["all_reduces"] for r in results)}
    print(f"dryrun_multichip ok: engine over {n_devices} partitions merged "
          f"{n_keys} keys equal to the CPU engine; dense mesh "
          f"{rep}x{n_devices // rep}, R={R}, S={S}, touched={touched}, "
          f"{out['all_reduces']} all-reduces", flush=True)
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None,
                    help="devices (default: every CUDA card, or 8 on the "
                         "CPU)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None)
    ns = ap.parse_args()
    import torch

    fn, ex = entry(ns.device)
    print("entry() check:", [tuple(x.shape) for x in fn(*ex)][:3])
    n = ns.n or (8 if ns.device == "cpu" else torch.cuda.device_count())
    dryrun_multichip(n, ns.device)
