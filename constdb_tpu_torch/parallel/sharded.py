"""Multi-device sharded CRDT merge over torch.distributed: the port's twin
of the reference package's parallel/sharded.py.

The reference maps the store's distributed axes onto a 2D device mesh:
  * "rep": replica parallelism.  The R axis of the dense [R, S] merge
    stacks (one row per replica snapshot, row 0 the local state) splits
    over the devices of a mesh column; the partial LWW reductions combine
    with max / min collectives.
  * "kv": keyspace parallelism.  The slot axis S is range-partitioned
    over a mesh row; slots are independent, so this axis needs no
    collective except for global statistics.

Here the mesh is a torch.distributed world of rep x kv processes, one
per device: rank r sits at (r // kv, r % kv), the reference's
`devices.reshape(rep, kv)` order.  Where the reference's shard_map step
calls lax.pmax / lax.pmin / lax.psum, this step calls
`dist.all_reduce` with MAX / MIN / SUM on the rank's column ("rep") or
row ("kv") group.  Backends: NCCL on CUDA, gloo only for device="cpu".
The reductions are plain torch ops: the reference computes them in XLA,
outside any Pallas kernel.

`engine_mesh(n)` gives the device list of TorchMergeEngine(devices=...),
the kv range-partitioned engine (engine/cuda.py).
"""

from __future__ import annotations

import os
import socket
import traceback
from typing import NamedTuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops.segment import NEUTRAL_T

_I64_MAX = (1 << 63) - 1

__all__ = ["Mesh", "engine_mesh", "init_world", "make_mesh", "run_world",
           "shard_batch_arrays", "sharded_merge_step", "ShardedMergeStep"]


def _rank_device(rank: int, device: Union[str, torch.device, None]
                 ) -> torch.device:
    """The device of `rank`: the CPU when asked for, else CUDA card
    `rank` (raises without a card, and when the host has fewer cards
    than the world needs)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the world over gloo")
    if rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank {rank} needs CUDA card {rank}, the host has "
            f"{torch.cuda.device_count()}")
    return torch.device("cuda", rank)


def init_world(rank: int, world_size: int, init_method: str,
               device: Union[str, torch.device, None] = None
               ) -> torch.device:
    """Join the default process group as `rank` of `world_size`
    (`init_method` e.g. "tcp://127.0.0.1:<port>"): NCCL with CUDA card
    `rank`, gloo with the CPU when `device` is "cpu".  -> the rank's
    device."""
    dev = _rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size)
    return dev


class Mesh(NamedTuple):
    """One rank's view of the (rep x kv) mesh."""
    rep: int                 # mesh rows: the R axis splits rep ways
    kv: int                  # mesh columns: the S axis splits kv ways
    rep_idx: int             # this rank's row
    kv_idx: int              # this rank's column
    rep_group: object        # this column's ranks: reductions over "rep"
    kv_group: object         # this row's ranks: reductions over "kv"
    device: torch.device


def make_mesh(rep: int = 1, device: Union[str, torch.device, None] = None
              ) -> Mesh:
    """This rank's (rep x kv) mesh over the initialized default group:
    kv = world // rep.  `dist.new_group` is collective, so every rank
    creates every row and column group, in the same order.  `device`:
    the rank's device (None = the current CUDA device under NCCL, the
    CPU under gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(init_world)")
    n = dist.get_world_size()
    if rep < 1 or n % rep:
        raise ValueError(f"{n} ranks do not factor into rep={rep}")
    kv = n // rep
    rank = dist.get_rank()
    rep_idx, kv_idx = divmod(rank, kv)
    rep_group = kv_group = None
    for j in range(kv):          # columns: the ranks of one "kv" index
        g = dist.new_group([i * kv + j for i in range(rep)])
        if j == kv_idx:
            rep_group = g
    for i in range(rep):         # rows: the ranks of one "rep" index
        g = dist.new_group([i * kv + j for j in range(kv)])
        if i == rep_idx:
            kv_group = g
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
    return Mesh(rep, kv, rep_idx, kv_idx, rep_group, kv_group,
                torch.device(device))


def engine_mesh(n_devices: int, device: Union[str, torch.device, None] = None
                ) -> list:
    """The device list of TorchMergeEngine(devices=...): n CUDA cards
    (raises when the host has fewer), or n times the CPU when `device`
    is "cpu".  The engine range-partitions its per-slot state over the
    list (a repeated device holds several partitions)."""
    if n_devices < 1:
        raise ValueError("n_devices must be >= 1")
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n_devices
    return [_rank_device(i, device) for i in range(n_devices)]


def shard_batch_arrays(mesh: Mesh, *arrays) -> tuple:
    """This rank's block of each [R, S] (or [R, S, C]) host array: rows
    [rep_idx * R/rep, +R/rep), slots [kv_idx * S/kv, +S/kv), on the
    rank's device."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        r, s = a.shape[0], a.shape[1]
        if r % mesh.rep or s % mesh.kv:
            raise ValueError(f"[{r}, {s}] does not split over a "
                             f"{mesh.rep} x {mesh.kv} mesh")
        rl, sl = r // mesh.rep, s // mesh.kv
        blk = np.ascontiguousarray(
            a[mesh.rep_idx * rl:(mesh.rep_idx + 1) * rl,
              mesh.kv_idx * sl:(mesh.kv_idx + 1) * sl])
        out.append(torch.from_numpy(blk).to(mesh.device))
    return tuple(out)


class ShardedMergeStep:
    """The rep x kv merge step of one mesh (the reference's
    shard_map(_local_merge)): per-rank partial reductions over the local
    R rows, combined by all-reduces over the mesh column ("rep"), plus a
    global touched-slot count summed over the mesh row ("kv").

    Inputs: this rank's blocks (shard_batch_arrays) of vals/ts [R, S]
    counters, at/an/dt [R, S] elements and env [R, S, 4] envelopes.
    -> (V, T, AT, AN, DT, WIN, ENV, touched): this rank's S/kv slice of
    each merged column (equal on every rank of a column), ENV
    [S/kv, 4], and the global touched count (an int).  `all_reduces`
    counts the collectives issued."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.all_reduces = 0

    def _reduce(self, t: torch.Tensor, op, group) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=group)
        self.all_reduces += 1
        return t

    def __call__(self, vals, ts, at, an, dt, env):
        m = self.mesh
        mx, g = dist.ReduceOp.MAX, m.rep_group
        neutral = torch.tensor(NEUTRAL_T, dtype=torch.int64,
                               device=ts.device)
        # counters: (value, uuid) LWW, max value on a uuid tie; rows off
        # the max stamp fill with NEUTRAL_T, as the reference's step does
        T = self._reduce(ts.amax(dim=0), mx, g)
        V = self._reduce(torch.where(ts == T, vals, neutral).amax(dim=0),
                         mx, g)
        # elements: lexicographic (add_t, add_node) and a max del_t
        AT = self._reduce(at.amax(dim=0), mx, g)
        AN = self._reduce(torch.where(at == AT, an, neutral).amax(dim=0),
                          mx, g)
        DT = self._reduce(dt.amax(dim=0), mx, g)
        # the winning (replica-global) row: the smallest, so that row 0,
        # the local state on rep row 0, wins exact ties
        r_local = at.shape[0]
        winner = (at == AT) & (an == AN)
        # argmax of a 0/1 column is its first winning row
        local_win = winner.to(torch.int32).argmax(dim=0).to(torch.int64)
        cand = torch.where(winner.any(dim=0),
                           m.rep_idx * r_local + local_win,
                           torch.tensor(_I64_MAX, dtype=torch.int64,
                                        device=at.device))
        WIN = self._reduce(cand, dist.ReduceOp.MIN, g)
        # envelopes: pointwise max over [R, S, 4]
        ENV = self._reduce(env.amax(dim=0), mx, g)
        # slots touched by any replica: max over "rep" (equal already),
        # then the sum over the kv partitions
        touched = (T > NEUTRAL_T).sum().reshape(1).to(torch.int64)
        self._reduce(touched, mx, g)
        self._reduce(touched, dist.ReduceOp.SUM, m.kv_group)
        return V, T, AT, AN, DT, WIN, ENV, int(touched.item())


def sharded_merge_step(mesh: Mesh) -> ShardedMergeStep:
    """The merge step of `mesh` (see ShardedMergeStep)."""
    return ShardedMergeStep(mesh)


# ---------------------------------------------------------------- worlds

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, init_method: str, device, job,
               out) -> None:
    """One rank of run_world: join the group, run the job's fn, report,
    leave.  `job` is (fn, args), or, in a spawned rank, the queue it
    arrives on (sent after every rank started, so a large argument never
    holds up the parent's start of the next rank)."""
    try:
        fn, args = job.get() if out is not None else job
        dev = init_world(rank, world, init_method, device)
        if dev.type == "cpu" and world > 1:
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        try:
            res = ("ok", fn(rank, world, dev, *args))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the caller, which raises
        res = ("err", traceback.format_exc())
    if out is None:
        return res
    out.put((rank, res))
    return None


def run_world(n: int, fn, args: tuple = (),
              device: Union[str, torch.device, None] = None,
              timeout: float = 600.0) -> list:
    """Run `fn(rank, world, device, *args)` on every rank of an n-rank
    torch.distributed world (NCCL over n CUDA cards, or gloo over the CPU
    for device="cpu") and return each rank's result in rank order.  One
    rank runs in this process; more run in spawned processes (`fn` must
    be a module-level function, its args and results picklable), which
    all exit before this returns.  Any rank's failure raises here."""
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    if n == 1:
        status, val = _rank_main(0, 1, init_method, device, (fn, args),
                                 None)
        if status != "ok":
            raise RuntimeError(f"rank 0 failed:\n{val}")
        return [val]
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    jobs, out = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, init_method, device, jobs, out),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    for _ in procs:
        jobs.put((fn, args))
    results: dict = {}
    try:
        # drain the queue before joining: a rank blocks on a full pipe
        while len(results) < n:
            try:
                rank, res = out.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"{n - len(results)} of {n} ranks silent after "
                    f"{timeout} s") from None
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    errs = [f"rank {r}:\n{v}" for r, (s, v) in sorted(results.items())
            if s != "ok"]
    if errs:
        raise RuntimeError("\n".join(errs))
    return [results[r][1] for r in range(n)]

