"""Process pool for hash-sharded merge work (store/sharded_keyspace.py
"process" mode).

N shard WORKERS, each a separate process owning one `KeySpace` and one
merge engine, so key resolution, staging, the snapshot decode and the
flush's host work scale with cores instead of sharing one interpreter:

  * workers come from a **forkserver** context: they fork from a clean
    helper process, never from the parent, which may hold a CUDA context
    and threads.  Each worker builds its engine lazily at its first merge
    and so opens its own CUDA context; the CUDA contexts of all workers
    share the card by time-slicing.  Nothing a worker imports before that
    touches CUDA;
  * batch planes cross the process boundary in **shared-memory
    segments** (one per job, holding the snapshot-codec encoding of every
    chunk of the group), not pickles; all N workers map the SAME segment
    and each extracts only its shard's rows;
  * completions stream back over per-worker pipes; the parent consumes
    them as they land (`reap`) inside a bounded in-flight window.

Control messages (flush / canonical / secs / export / ...) ride the same
pipes after a barrier, so replies never interleave with merge acks.  A
worker that fails (no card, a failed build or launch, a bad payload)
sends its traceback and the parent raises it: no worker carries on on
the CPU.  Every segment the pool creates, or is handed by a worker,
is named in `shm_names`, and none outlives `close()`.
"""

from __future__ import annotations

import os
import traceback

ENGINE_SPECS = ("cpu", "cuda", "cuda-nonresident")
MAX_INFLIGHT = 2  # groups in flight before submit_group reaps


def _attach_shm(name: str):
    """Open an existing shared-memory segment.  Forkserver children share
    the parent's resource tracker, so the attach-side registration is a
    set-level no-op and exactly one unregister fires at unlink time."""
    from multiprocessing import shared_memory

    return shared_memory.SharedMemory(name=name)


def _make_engine(spec: str, device=None, dense_fold: str = "auto"):
    """Engine by spec string: "cpu" is the port's CpuMergeEngine; "cuda"
    a resident TorchMergeEngine on `device` with `dense_fold`,
    "cuda-nonresident" the non-resident one."""
    if spec not in ENGINE_SPECS:
        raise ValueError(f"unknown shard engine spec {spec!r}")
    if spec == "cpu":
        from ..engine.cpu import CpuMergeEngine
        return CpuMergeEngine()
    from ..engine.cuda import TorchMergeEngine
    return TorchMergeEngine(resident=spec != "cuda-nonresident",
                            dense_fold=dense_fold, device=device)


def _empty_pinned_cache() -> None:
    """Return this process's cached pinned host blocks to the driver
    (blocks still in use stay).  The call moved from torch._C to
    torch.accelerator between PyTorch releases."""
    import torch

    acc = getattr(torch, "accelerator", None)
    empty = getattr(acc, "empty_host_cache", None)
    (empty or torch._C._host_emptyCache)()


def engine_secs(engine) -> dict:
    """An engine's timers and counters (one entry of
    ShardedKeySpace.host_secs_per_shard)."""
    return {"family_secs": dict(getattr(engine, "family_secs", {}) or {}),
            "stage_secs": dict(getattr(engine, "stage_secs", {}) or {}),
            "bytes_h2d": getattr(engine, "bytes_h2d", 0),
            "bytes_d2h": getattr(engine, "bytes_d2h", 0),
            "folds": getattr(engine, "folds", 0),
            "dev_rounds_resident": getattr(engine, "dev_rounds_resident", 0),
            "host_micro_rounds": getattr(engine, "host_micro_rounds", 0),
            "flush_rows_downloaded": getattr(engine,
                                             "flush_rows_downloaded", 0),
            "flush_rows_full_equiv": getattr(engine,
                                             "flush_rows_full_equiv", 0)}


def _worker_main(conn, shard: int, n_shards: int, engine_spec: str,
                 dense_fold: str, env: dict, device) -> None:
    """Shard worker loop: one KeySpace + one lazily built merge engine."""
    # the parent's knobs were captured at pool creation, which may
    # post-date the forkserver's inherited environment
    os.environ.update(env)
    from ..engine.base import batch_from_keyspace
    from ..persist.snapshot import (_decode_batch, _encode_batch,
                                    _read_bytes_list)
    from ..store.keyspace import KeySpace
    from ..store.sharded_keyspace import (extract_shard,
                                          keyspace_state_bytes, shard_ids)
    from ..utils.varint import VarintReader

    store = KeySpace()
    engine = None
    export_shm = None  # last export segment, freed on "export_free"

    def ensure_engine():
        nonlocal engine
        if engine is None:
            engine = _make_engine(engine_spec, device, dense_fold)
        return engine

    def flushed_store():
        if engine is not None and getattr(engine, "needs_flush", False):
            engine.flush(store)
        return store

    def process_secs() -> dict:
        """Engine timers plus this process's kernel launches, the [R, S]
        of each K1 and K2 launch, and its peak device memory."""
        import torch

        from ..ops import kernels as KN
        out = engine_secs(engine)
        out["launches"] = dict(KN.LAUNCHES)
        out["fold_shapes"] = {k: [list(s) for s in v]
                              for k, v in KN.SHAPES.items()}
        dev = getattr(engine, "device", None)
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev) \
            if dev is not None and dev.type == "cuda" else None
        out["pid"] = os.getpid()
        return out

    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        cmd = msg[0]
        try:
            if cmd == "merge":
                _, jid, shm_name, planes, entries = msg
                shm = _attach_shm(shm_name)
                try:
                    buf = shm.buf
                    # shared bytes planes (keys / members) decode ONCE
                    # per job, however many replica chunks reference them
                    plane_cache: dict = {}

                    def plane(pid):
                        got = plane_cache.get(pid)
                        if got is None:
                            o, ln = planes[pid]
                            r = VarintReader(bytes(buf[o:o + ln]))
                            got = _read_bytes_list(r, r.uvarint())
                            plane_cache[pid] = got
                        return got

                    sid_cache: dict = {}  # key token -> shard column
                    ex_memo: dict = {}    # extract_shard's plane memo
                    subs = []
                    for off, plen, tok_k, tok_e, hv, kpid, epid in entries:
                        b = _decode_batch(
                            bytes(buf[off:off + plen]),
                            keys=plane(kpid) if kpid >= 0 else None,
                            el_member=plane(epid) if epid >= 0 else None)
                        b.key_shape = tok_k
                        b.el_shape = tok_e
                        b.el_has_vals = hv
                        # hash once per shared key plane; the N workers
                        # hash in parallel (the parent ships only bytes)
                        sids = sid_cache.get(tok_k) if tok_k is not None \
                            else None
                        if sids is None:
                            sids = shard_ids(b.keys, n_shards)
                            if tok_k is not None:
                                sid_cache[tok_k] = sids
                        dsids = shard_ids(b.del_keys, n_shards) \
                            if b.del_keys else None
                        sub = extract_shard(b, sids, dsids, shard,
                                            memo=ex_memo)
                        if sub.n_rows or sub.del_keys:
                            subs.append(sub)
                finally:
                    shm.close()
                rows = sum(s.n_rows for s in subs)
                if subs:
                    ensure_engine().merge_many(store, subs)
                conn.send(("done", jid, {"rows": rows}))
            elif cmd == "flush":
                flushed_store()
                conn.send(("ok", None))
            elif cmd == "canonical":
                conn.send(("ok", flushed_store().canonical(keys=msg[1])))
            elif cmd == "state_bytes":
                conn.send(("ok", keyspace_state_bytes(flushed_store())))
            elif cmd == "export":
                # whole-shard columnar state (consolidation), encoded with
                # the snapshot codec into a worker-owned segment; the
                # parent copies it out, then sends "export_free", whose
                # branch below closes and unlinks it
                from multiprocessing import shared_memory
                payload = bytes(_encode_batch(
                    batch_from_keyspace(flushed_store())))
                export_shm = shared_memory.SharedMemory(
                    create=True, size=max(len(payload), 1))
                export_shm.buf[: len(payload)] = payload
                conn.send(("ok", (export_shm.name, len(payload))))
            elif cmd == "export_free":
                if export_shm is not None:
                    export_shm.close()
                    export_shm.unlink()
                    export_shm = None
                conn.send(("ok", None))
            elif cmd == "secs":
                conn.send(("ok", process_secs()))
            elif cmd == "reset":
                # the store goes with the engine: nothing to flush.  The
                # engine's pinned buffers return to this process's pinned
                # cache, which is emptied: a freed shard hands its pinned
                # memory back to the system
                if engine is not None:
                    if hasattr(engine, "discard_resident"):
                        engine.discard_resident()
                    if hasattr(engine, "close"):
                        engine.close()
                    dev = getattr(engine, "device", None)
                    if dev is not None and dev.type == "cuda":
                        _empty_pinned_cache()
                store = KeySpace()
                engine = None
                conn.send(("ok", None))
            elif cmd == "close":
                break
            else:
                raise ValueError(f"unknown pool command {cmd!r}")
        except BaseException:
            try:
                conn.send(("err", msg[1] if cmd == "merge" else None,
                           traceback.format_exc()))
            except (BrokenPipeError, OSError):  # parent already gone
                break
    conn.close()


_ENV_PREFIXES = ("CONSTDB_TORCH_", "CUDA_", "TORCH_")


def _capture_env() -> dict:
    return {k: v for k, v in os.environ.items()
            if k.startswith(_ENV_PREFIXES)}


class HostShardPool:
    """N forkserver shard workers + shared-memory job transport.

    `submit_group(planes, entries)` ships one encoded group to EVERY
    worker; each extracts its own shard.  Submission is asynchronous:
    acks drain through `reap()`, and a bounded in-flight window
    (MAX_INFLIGHT groups) holds the producer back.

    `device` and `dense_fold` go to every worker's engine ("cpu" runs
    the plain versions; None is each worker's current CUDA device).  For a CUDA
    spec on a CUDA device the parent builds the kernels, and for every
    spec the native extension, before it starts the workers, so they
    only load them."""

    def __init__(self, n_shards: int, engine_spec: str = "cuda",
                 dense_fold: str = "auto", device=None):
        import multiprocessing as mp

        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if engine_spec not in ENGINE_SPECS:
            raise ValueError(f"unknown shard engine spec {engine_spec!r}")
        self.n_shards = n_shards
        self.engine_spec = engine_spec
        self.device = None if device is None else str(device)
        from ..utils import native
        native.load()
        if engine_spec != "cpu":
            from ..utils.device import resolve_device
            if resolve_device(device).type == "cuda":
                from ..ops import kernels as KN
                KN.build()
        wenv = _capture_env()
        ctx = mp.get_context("forkserver")
        self._conns = []
        self._procs = []
        # every segment created here or handed over by a worker
        self.shm_names: set = set()
        self._closed = False
        self._next_jid = 0
        # jid -> {"acks": remaining, "shm": segment, "pins": refs}
        self._jobs: dict[int, dict] = {}
        self.rows_merged = [0] * n_shards
        for s in range(n_shards):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker_main,
                            args=(child, s, n_shards, engine_spec,
                                  dense_fold, wenv, self.device),
                            daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)

    # ------------------------------------------------------------- submit

    def submit_group(self, planes: list, entries: list,
                     pins: list = ()) -> int:
        """Ship one group.  `planes` is a list of encoded shared bytes
        planes (uvarint count + bytes-list blob), each shipped ONCE and
        referenced by index from the entries; `entries` is a list of
        (payload_bytes, tok_k, tok_e, hv, kpid, epid) where kpid/epid
        index `planes` (-1 = plane embedded in the payload).  `pins`
        holds whatever must stay alive until the job completes (token
        validity).  Blocks (reaping completions) while the in-flight
        window is full."""
        from multiprocessing import shared_memory

        while len(self._jobs) >= MAX_INFLIGHT:
            self.reap(block=True)
        total = sum(len(p) for p in planes) + \
            sum(len(e[0]) for e in entries)
        shm = shared_memory.SharedMemory(create=True, size=max(total, 1))
        self.shm_names.add(shm.name)
        try:
            # population and registration under a guard: a failure in
            # here would otherwise leak the segment until process exit;
            # from registration on, reap()/close() own the cleanup
            off = 0
            plane_spans = []
            for p in planes:
                shm.buf[off:off + len(p)] = p
                plane_spans.append((off, len(p)))
                off += len(p)
            wire = []
            for payload, tok_k, tok_e, hv, kpid, epid in entries:
                shm.buf[off:off + len(payload)] = payload
                wire.append((off, len(payload), tok_k, tok_e, hv, kpid,
                             epid))
                off += len(payload)
            jid = self._next_jid
            self._next_jid += 1
            self._jobs[jid] = {"acks": self.n_shards, "shm": shm,
                               "pins": list(pins)}
        except BaseException:
            shm.close()
            shm.unlink()
            raise
        for conn in self._conns:
            conn.send(("merge", jid, shm.name, plane_spans, wire))
        return jid

    def reap(self, block: bool = False) -> int:
        """Consume any landed completions; returns how many acks arrived.
        With `block`, waits for at least one."""
        from multiprocessing.connection import wait as conn_wait

        got = 0
        while self._jobs:
            ready = conn_wait(self._conns,
                              None if (block and got == 0) else 0)
            if not ready:
                break
            for conn in ready:
                msg = conn.recv()
                self._handle_ack(self._conns.index(conn), msg)
                got += 1
        return got

    def _handle_ack(self, shard: int, msg) -> None:
        kind = msg[0]
        if kind == "err":
            raise RuntimeError(
                f"shard worker {shard} failed:\n{msg[2]}")
        if kind != "done":
            raise RuntimeError(
                f"unexpected pool reply {msg[0]!r} from shard {shard}")
        jid = msg[1]
        self.rows_merged[shard] += msg[2].get("rows", 0)
        job = self._jobs[jid]
        job["acks"] -= 1
        if job["acks"] == 0:
            job["shm"].close()
            job["shm"].unlink()
            del self._jobs[jid]

    def barrier(self) -> None:
        """Drain every in-flight merge."""
        while self._jobs:
            self.reap(block=True)

    # ------------------------------------------------------ control calls

    def _reply(self, shard: int):
        msg = self._conns[shard].recv()
        if msg[0] == "err":
            raise RuntimeError(f"shard worker {shard} failed:\n{msg[2]}")
        return msg[1]

    def call_all(self, cmd: str, *args) -> list:
        """Barrier, then run one control command on every worker and
        collect the per-shard replies (in shard order)."""
        self.barrier()
        for conn in self._conns:
            conn.send((cmd,) + args)
        return [self._reply(s) for s in range(self.n_shards)]

    def call_one(self, shard: int, cmd: str, *args):
        self.barrier()
        self._conns[shard].send((cmd,) + args)
        return self._reply(shard)

    def _copy_export(self, shard: int, name: str, size: int) -> bytes:
        """Copy a worker's export segment out, then have the worker free
        it."""
        self.shm_names.add(name)
        shm = _attach_shm(name)
        try:
            payload = bytes(shm.buf[:size])
        finally:
            shm.close()
        self._conns[shard].send(("export_free",))
        self._reply(shard)
        return payload

    def export_shard(self, shard: int) -> bytes:
        """One shard's whole-state columnar export (snapshot codec)."""
        name, size = self.call_one(shard, "export")
        return self._copy_export(shard, name, size)

    def export_all(self) -> list:
        """Whole-state exports from EVERY shard, the worker-side encodes
        running concurrently: the command goes to all workers first, then
        each segment is copied out as its reply lands."""
        self.barrier()
        for conn in self._conns:
            conn.send(("export",))
        return [self._copy_export(s, *self._reply(s))
                for s in range(self.n_shards)]

    # ---------------------------------------------------------- lifecycle

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            try:
                conn.send(("close",))
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():  # pragma: no cover - hung worker
                p.terminate()
                p.join(timeout=10)
        for conn in self._conns:
            conn.close()
        for job in self._jobs.values():
            try:
                job["shm"].close()
                job["shm"].unlink()
            except OSError:  # pragma: no cover - already gone
                pass
        self._jobs.clear()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
