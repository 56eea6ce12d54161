"""Batched PyTorch MergeEngine: the CUDA path for bulk CRDT merges.

The bulk half of the reference package's engine/tpu.py, ported to torch
tensors on one device (CUDA, or the CPU when the caller asks for it):

  * bulk (ops/bulk.py): each batch ships as COMPACT rows (int32 slot ids
    + value columns) and folds into full per-slot device state, one
    gather -> merge -> write pass per batch.  State updates in place
    (where the reference donates buffers), uploads go through pinned
    host memory with non_blocking copies, and when every touched slot is
    brand new the initial state is made on the device.
  * aligned fold: R batches staging the very same slot rows (R replica
    snapshots of one keyspace) reduce in one [R, N] pass, on the card by
    the hand-written kernels of ops/kernels.py, then write once: K1
    fold_apply folds registers and elements and applies the winners to
    the state in the same launch; K2 merge_counters folds counter slots
    for a bulk op to write.
  * scatter (ops/segment.py): touched-slot gather + scatter-max, for
    sparse merges when state is host-resident.

**Resident mode** (`resident=True`): per-family device state persists
across merge calls, so a streamed catch-up pays row uploads only.  Win
values resolve through a device int32 `src` plane at `flush()`, which
also re-derives the counter sums on the card (K4 segment_sum over the
resident slot contributions).

**Steady state** (`steady`, on by default for a resident engine on a
CUDA device): op-stream micro-batches (the replication coalescer's
flushes, at most HOST_SCATTER_MAX rows) fold their duplicate slots on
the host and merge the unique winners IN PLACE into the resident planes:
every scatter of a batch (the LWW pairs, the counter base pair, the
element del_t max) goes up in one packed copy and runs in one K3
scatter_round launch; `flush()` then gathers and downloads only the
dirty rows.  Tensor-register payloads live in resident device pools and
batched reads (`tensor_read_many`) reduce on the card with K5
tensor_take_reduce.  With `steady` off, micro-batches take the host
round, as the reference does.

**Range partitions** (`devices=[...]`, the reference's kv mesh,
`TpuMergeEngine(mesh=...)`): every per-slot plane is padded to a power
of two and then to a multiple of K = len(devices), and partition k holds
its contiguous rows [k * Sp/K, (k+1) * Sp/K) as a tensor on devices[k]
(a device may repeat: one card can hold several partitions).  Each bulk
dispatch splits its batch rows by range and runs the same op or kernel
per partition with partition-local ids: K1 fold_apply folds and applies
registers and elements, K2 folds counters, and the counter-sum
re-derivation runs K4 per partition and adds the partial sums mod 2^64
(one key's counter slots may straddle a boundary).  When a plane grows
its boundaries move and its columns re-split (`resplits`).  As on the
reference's mesh, the bulk path always runs (no scatter strategy), and
there is no steady micro path and no device tensor path: micro-batches
and tensor rows merge on their host twins.  `partition_launches[k]`
counts the kernel wrapper calls made for partition k.

`dense_fold` picks the aligned-fold backend: "auto" = the CUDA kernels
on a CUDA device and the plain PyTorch versions on the CPU, "cuda" the
kernels (their wrappers run the plain versions only for CPU tensors),
"eager" the plain versions, "off" no folding.  Nothing falls back: a
kernel that fails to build or launch raises.

Must be semantically bit-identical to engine/cpu.py; tests/
test_torch_engine.py holds it against both the CPU engine and the
reference JAX engine.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import os
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..conf import env_flag, env_int, env_str
from ..crdt import semantics as S
from ..ops import bulk as B
from ..ops import dense as D
from ..ops import kernels as KN
from ..ops import segment as K
from ..store.keyspace import KeySpace
from ..utils import trace
from ..utils.device import resolve_device
from .base import (ColumnarBatch, MergeStats, flush_for, has_values,
                   touched_families)
from .hostbatch import HOST_MICRO_MAX

log = logging.getLogger(__name__)

_I64 = np.int64
_I32 = np.int32
# a row-tracked family's dirty mask (res["dirty"]: device-newer rows) when
# no micro round has touched it since the last flush: host == device
_CLEAN = np.zeros(0, dtype=bool)

FOLD_MODES = ("auto", "cuda", "eager", "off")
FAMILIES = ("env", "reg", "cnt", "el", "tns")
# pinned staging slots of the steady rounds' packed uploads
STAGE_RING = 4
# the host columns the round planner writes, in its order
# (native/planner.cpp plan_round)
_PLAN_KEY_COLS = ("enc", "ct", "mt", "dt", "expire", "rv_t", "rv_node",
                  "cnt_sum")
_PLAN_CNT_COLS = ("kid", "node", "val", "uuid", "base", "base_t")
_PLAN_EL_COLS = ("kid", "add_t", "add_node", "del_t")


class _Stack(NamedTuple):
    """The R equal-length host rows of one [R, n] stack: _h2d_packed
    packs them back to back, so the stack is never built on the host."""
    rows: list


class _Scatter(NamedTuple):
    """One collected scatter of a steady round, launched at the end of the
    batch: a KN segment kind, the family and plane names, host ids
    (int32) and batch columns (int64), and the src base (PAIR_SRC)."""
    kind: int
    fam: str
    names: tuple
    ids: np.ndarray
    cols: tuple
    base: int = 0


def _pad(arr: np.ndarray, size: int, fill) -> np.ndarray:
    arr = np.asarray(arr)
    if len(arr) == size:
        return arr
    out = np.empty((size,) + arr.shape[1:], dtype=arr.dtype)
    out[: len(arr)] = arr
    out[len(arr):] = fill
    return out


# family -> [(column name in the family's host table, neutral fill)]
_FAMILIES = {
    "env": [("ct", 0), ("mt", 0), ("dt", 0), ("expire", 0)],
    "reg": [("rv_t", 0), ("rv_node", 0)],
    "cnt": [("val", 0), ("uuid", K.NEUTRAL_T), ("base", 0),
            ("base_t", K.NEUTRAL_T)],
    "el": [("add_t", 0), ("add_node", 0), ("del_t", 0)],
}


# a planned round's segments (native/planner.cpp: kind, family code) ->
# (family, the planes they scatter into), in _merge_micro_resident's terms
_PLAN_SEGS = {(KN.PAIR_SRC, 0): ("reg", ("rv_t", "rv_node")),
              (KN.PAIR_SRC, 1): ("cnt", ("uuid", "val")),
              (KN.PAIR, 1): ("cnt", ("base_t", "base")),
              (KN.PAIR_SRC, 2): ("el", ("add_t", "add_node")),
              (KN.MAX1, 2): ("el", ("del_t",))}


def _host_table(store: KeySpace, fam: str):
    return store.el if fam == "el" else (store.cnt if fam == "cnt"
                                         else store.keys)


def _fam_rows(store: KeySpace, fam: str) -> int:
    return _host_table(store, fam).n


# ------------------------------------------------------- host group combine
# A group of staged batches is pre-combined ON HOST whenever that shrinks
# the bytes or the number of transfers:
#   * aligned rows (R replica snapshots of one keyspace) fold R x down with
#     vectorized numpy lex-max, so the upload drops R x;
#   * disjoint rows (consecutive chunks of ONE snapshot) concatenate into a
#     single batch: same bytes, one transfer + one pass instead of R.
# Both reductions compute exactly crdt/semantics.py (lexicographic (t, v)
# max / plain max), so device results are bit-identical either way.


def _rows_aligned(staged) -> bool:
    if len(staged) < 2:
        return False
    r0 = staged[0][0]
    return all(len(s[0]) == len(r0) and np.array_equal(s[0], r0)
               for s in staged[1:])


def _rows_disjoint_cat(staged):
    """Concatenated row array if no row repeats across entries, else None.
    Non-overlapping [min, max] ranges prove disjointness without a sort."""
    parts = [np.asarray(s[0]) for s in staged]
    nonempty = [p for p in parts if len(p)]
    if len(nonempty) < 2:
        return np.concatenate(parts) if parts else np.zeros(0, _I64)
    iv = sorted((int(p.min()), int(p.max())) for p in nonempty)
    if all(iv[i][1] < iv[i + 1][0] for i in range(len(iv) - 1)):
        return np.concatenate(parts)
    cat = np.concatenate(parts)
    if len(np.unique(cat)) == len(cat):
        return cat
    return None


def _row_sorted(entry: tuple) -> tuple:
    """A staged entry (rows first, then per-row columns, value lists and
    flags) reordered so that its rows ascend, as a range-partitioned
    dispatch splits them: rows are unique within an entry, so the order
    carries no meaning."""
    rows = np.asarray(entry[0])
    n = len(rows)
    if n < 2 or (rows[1:] >= rows[:-1]).all():
        return entry
    perm = np.argsort(rows, kind="stable")
    out = []
    for x in entry:
        if isinstance(x, np.ndarray) and x.ndim and len(x) == n:
            out.append(x[perm])
        elif isinstance(x, list) and len(x) == n:
            out.append(list(map(x.__getitem__, perm.tolist())))
        else:
            out.append(x)
    return tuple(out)


def _pad_cols(stack: np.ndarray, size: int, fill) -> np.ndarray:
    """An [R, n, ...] stack padded to [R, size, ...]."""
    out = np.full((stack.shape[0], size) + stack.shape[2:], fill,
                  dtype=stack.dtype)
    out[:, :stack.shape[1]] = stack
    return out


def _lex_fold(t_list, v_list):
    """RUNNING lexicographic (t, v) max over R same-shape arrays ->
    (t[N], v[N], win_batch[N]); ties keep the EARLIEST batch."""
    t = np.array(t_list[0], copy=True)
    v = np.array(v_list[0], copy=True)
    wb = np.zeros(len(t), dtype=_I64)
    for i in range(1, len(t_list)):
        ti = np.asarray(t_list[i])
        vi = np.asarray(v_list[i])
        win = (ti > t) | ((ti == t) & (vi > v))
        np.copyto(t, ti, where=win)
        np.copyto(v, vi, where=win)
        wb[win] = i
    return t, v, wb


def _sel_obj(lists, wb: np.ndarray) -> np.ndarray:
    """Pick lists[wb[j]][j] for every j via an object matrix.  A None entry
    in `lists` stands for an all-None value column."""
    obj = np.empty((len(lists), len(wb)), dtype=object)
    for i, v in enumerate(lists):
        obj[i, :] = v
    return obj[wb, np.arange(len(wb))]


class TorchMergeEngine:
    name = "cuda"
    # bulk when staged rows cover >= 1/BULK_FRACTION of the slot region
    # (resident mode always prefers bulk: there is no state upload to avoid)
    BULK_FRACTION = 8
    # contiguous-row batches at or above this length derive their idx
    # vector on the device (iota) instead of uploading it (tests lower it)
    IDX_IOTA_MIN = 4096
    # non-unique batches at or below this many rows merge on HOST; the
    # CPU engine routes with the same ceiling (engine/hostbatch.py)
    HOST_SCATTER_MAX = HOST_MICRO_MAX
    # win-source pool ids live in an int32 device plane; merge_many flushes
    # before staging a round that could cross this (tests lower it)
    POOL_ID_CEILING = 1 << 31
    # staging order = dispatch order = the on-store plane contract
    FAM_ORDER = ("env", "reg", "cnt", "el")

    def __init__(self, resident: bool = False, dense_fold: str = "auto",
                 pipeline: Optional[bool] = None,
                 steady: Optional[bool] = None,
                 warmup: Optional[int] = None,
                 device: Union[str, torch.device, None] = None,
                 devices: Optional[list] = None) -> None:
        """`device`: None or "cuda" = the current CUDA device (raises when
        there is none), "cpu" = the CPU with the plain versions of every
        kernel.  `devices`: range-partition the per-slot state over this
        device list (module docstring; parallel/sharded.py engine_mesh
        makes one); `device` is then devices[0], which also runs what is
        not partitioned.  None = one device, unpartitioned.  `dense_fold`:
        see the module docstring.  `pipeline`:
        stage the families' host prep on a worker pool while the main
        thread dispatches (None = on unless CONSTDB_TORCH_PIPELINE=0);
        results are byte-identical to the serial path because every stage
        touches only its own host plane.

        `steady`: the steady-state path of a resident engine (module
        docstring).  None = CONSTDB_TORCH_RESIDENT: "auto" (default) is
        on for a CUDA device and off for the CPU, "1" on, "0" off.  A
        touched plane that holds no fresh mirror is COLD and merges on
        its host twin until its host version has been stable for more
        than `warmup` micro rounds (None = CONSTDB_TORCH_RESIDENT_WARMUP,
        default 2), so op writes between rounds cannot force a whole
        mirror upload per round."""
        if dense_fold not in FOLD_MODES:
            raise ValueError(f"dense_fold must be one of {FOLD_MODES}, "
                             f"got {dense_fold!r}")
        if devices is not None:
            self._devs = [resolve_device(d) for d in devices]
            if not self._devs:
                raise ValueError("devices must name at least one device")
            if device is not None and \
                    resolve_device(device) != self._devs[0]:
                raise ValueError("device must be devices[0] when both are "
                                 "given")
            self.device = self._devs[0]
        else:
            self._devs = None
            self.device = resolve_device(device)
        self.dense_fold = dense_fold
        self.resident = resident
        if steady is None:
            mode = env_str("CONSTDB_TORCH_RESIDENT", "auto")
            steady = self.device.type == "cuda" if mode == "auto" \
                else mode != "0"
        # range partitions merge micro-batches and tensor rows on the host
        self.steady = bool(steady) and self._devs is None
        # partition boundary moves (a partitioned plane grew and its
        # columns re-split) and, per partition, the kernel wrapper calls
        # made for it (K1 merge_elems, K2 merge_counters, K4 segment_sum)
        self.resplits = 0
        self.partition_launches = [
            {"merge_elems": 0, "merge_counters": 0, "segment_sum": 0}
            for _ in (self._devs or ())]
        self.warmup = env_int("CONSTDB_TORCH_RESIDENT_WARMUP", 2) \
            if warmup is None else int(warmup)
        self._warm_streak: dict[str, tuple[int, int]] = {}
        self._fold_on = dense_fold != "off"
        self.folds = 0          # aligned folds performed (observability)
        # stale-mirror rebuilds per family (op writes between rounds)
        self.mirror_rebuilds = dict.fromkeys(FAMILIES, 0)
        # stale mirrors patched in place after key-confined op writes
        self.mirror_patches = dict.fromkeys(FAMILIES, 0)
        # steady micro rounds and rows per family: [on the host twin,
        # in place on the device]
        self.micro_rounds = {f: [0, 0] for f in ("reg", "cnt", "el", "tns")}
        self.micro_rows = {f: [0, 0] for f in ("reg", "cnt", "el", "tns")}
        # this engine's spans and counters (utils/trace.py): the timers
        # family_secs and stage_secs are views over them
        self.spans = trace.Totals()
        if pipeline is None:
            pipeline = env_flag("CONSTDB_TORCH_PIPELINE", True)
        self.pipeline = bool(pipeline)
        # micro rounds merged in place on the device / on the host
        self.dev_rounds_resident = 0
        self.host_micro_rounds = 0
        # rows flushes downloaded, and rows a whole-plane flush would have
        # downloaded at the same points (proves the flushes partial)
        self.flush_rows_downloaded = 0
        self.flush_rows_full_equiv = 0
        # resident tensor payload pools: one [cap, elems] device pool per
        # (dtype, elems) class; slot stamps stay host-authoritative, and
        # `dirty` pool slots are device-newer than the host payload list
        self._tns_pools: dict[tuple, dict] = {}
        self._tns_ver = 0
        self._tns_epoch = 0            # bumped whenever the pools drop
        self._tns_read_cache: dict = {}
        self._tns_bytes = 0            # device payload bytes resident
        self.tns_dev_rows = 0          # tensor rows merged on the device
        self.tns_host_rows = 0         # tensor rows merged on the host
        self.tns_pool_cap = env_int("CONSTDB_TORCH_TENSOR_POOL_MB",
                                    512) << 20
        self._stage_ex = None
        self._stage_pending = None
        # host<->device transfer accounting (h2d_copies: copies issued)
        self.bytes_h2d = 0
        self.bytes_d2h = 0
        self.h2d_copies = 0
        # pinned staging ring of the steady rounds' packed uploads (and of
        # the counter sums' slot kids): a slot is rewritten only after the
        # event recorded behind its last copy
        self._ring = [{"buf": None, "ev": None} for _ in range(STAGE_RING)]
        self._ring_i = 0
        # the one pinned slot of K1's fold uploads: a fold waits for its
        # winners, so its copy is done before the next fold packs, and
        # the slot grows to the largest fold once instead of every ring
        # slot growing in turn
        self._fold_slot = {"buf": None, "ev": None}
        self._res: dict[str, dict] = {}   # fam -> {cols, n, cap, ...}
        # deferred win-value resolution (resident mode): host value pool
        # the device `src` planes index into, resolved once at flush
        self._val_pool: list[tuple[int, Optional[list], dict]] = []
        # the pool segments' base ids, kept as they are added (a key
        # flush looks a few ids up among thousands of segments)
        self._pool_bases = np.zeros(64, dtype=_I64)
        self._pool_size = 0
        self._pool_bytes = 0
        # el rows whose HOST del_t advanced since the last flush
        self._el_del_touched: list[np.ndarray] = []
        self.pool_flush_bytes = env_int("CONSTDB_TORCH_POOL_FLUSH_MB",
                                        1536) << 20
        self.needs_flush = False
        self._unique_ok = True
        self._n0_keys = 0

    @property
    def family_secs(self) -> dict:
        """Cumulative host seconds per family on the critical path: the
        wait for its staging plus its dispatch; `flush` includes its
        downloads and `sums` (the device counter-sum re-derivation),
        `host` the whole-round host fallback and `micro` the steady
        rounds.  A view over this engine's spans."""
        w = self.spans.wall
        out = {f: w(f"engine.stage_wait.{f}") + w(f"engine.dispatch.{f}")
               for f in self.FAM_ORDER}
        out.update(flush=w("engine.flush"), sums=w("engine.sums"),
                   host=w("engine.host_round"), micro=w("engine.micro_round"))
        return out

    @property
    def stage_secs(self) -> dict:
        """Cumulative staging seconds per family (on the staging threads,
        beside dispatch).  A view over this engine's spans."""
        return {f: self.spans.wall(f"engine.stage.{f}")
                for f in self.FAM_ORDER}

    # ------------------------------------------------------------ transfers

    def _h2d(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """One host array to the device (`device`, default the engine's).
        CUDA: through a pinned buffer with a non_blocking copy.  CPU: a
        private copy (state tensors are updated in place and must not
        alias the host columns)."""
        dev = self.device if device is None else device
        arr = np.ascontiguousarray(arr)
        self.bytes_h2d += arr.nbytes
        self.h2d_copies += 1
        if dev.type == "cpu":
            return torch.from_numpy(arr.copy())
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr).pin_memory().to(dev, non_blocking=True)

    def _h2d_packed(self, i64: list, i32: list, slot: Optional[dict] = None,
                    device=None):
        """Several int64 and int32 host columns to the device in ONE copy:
        packed int64 first (alignment), then int32, into a pinned slot
        (`slot`, else the next of the staging ring), one non_blocking
        copy to `device` (default the engine's), an event behind it.  An
        int64 entry may be a _Stack, whose rows pack back to back into one
        [R, n] view.
        -> (int64 device views, int32 device views), in order, each of
        its host array's shape."""
        cols = []   # (host parts, view shape, torch dtype)
        for group, np_dt, dt in ((i64, _I64, torch.int64),
                                 (i32, _I32, torch.int32)):
            for c in group:
                if isinstance(c, _Stack):
                    parts = [np.ascontiguousarray(r, dtype=np_dt)
                             for r in c.rows]
                    shape = (len(parts), len(parts[0]))
                else:
                    parts = [np.ascontiguousarray(c, dtype=np_dt)]
                    shape = parts[0].shape
                cols.append((parts, shape, dt))
        nbytes = sum(p.nbytes for parts, _, _ in cols for p in parts)
        self.bytes_h2d += nbytes
        self.h2d_copies += 1
        dev_t = self.device if device is None else device
        cuda = dev_t.type == "cuda"
        if cuda:
            if slot is None:
                slot = self._ring[self._ring_i]
                self._ring_i = (self._ring_i + 1) % len(self._ring)
            if slot["ev"] is not None:
                slot["ev"].synchronize()   # its last copy has read it
            if slot["buf"] is None or slot["buf"].numel() < nbytes:
                slot["buf"] = torch.empty(K.next_pow2(max(nbytes, 1 << 16)),
                                          dtype=torch.uint8, pin_memory=True)
            host_t = slot["buf"][:nbytes]
        else:
            host_t = torch.empty(nbytes, dtype=torch.uint8)
        host = host_t.numpy()
        offs = [0]
        for parts, _, _ in cols:
            off = offs[-1]
            for p in parts:
                host[off:off + p.nbytes] = p.reshape(-1).view(np.uint8)
                off += p.nbytes
            offs.append(off)
        dev = host_t
        if cuda:
            dev = torch.empty(nbytes, dtype=torch.uint8, device=dev_t)
            dev.copy_(host_t, non_blocking=True)
            slot["ev"] = torch.cuda.Event()
            slot["ev"].record()
        views = [dev[o:e].view(dt).view(shape)
                 for (_, shape, dt), o, e in zip(cols, offs, offs[1:])]
        return views[:len(i64)], views[len(i64):]

    def _get(self, t: torch.Tensor) -> np.ndarray:
        """Blocking download of one tensor into a fresh numpy array."""
        h = t.cpu() if t.device.type != "cpu" else t.clone()
        self.bytes_d2h += h.numel() * h.element_size()
        return h.numpy()

    def _start_get(self, t: torch.Tensor) -> torch.Tensor:
        """Start a download into pinned host memory; the caller waits on
        an event recorded after it before reading the result."""
        if t.device.type == "cpu":
            return t.clone()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    def _get_pinned(self, t: torch.Tensor) -> np.ndarray:
        """One download into pinned host memory, waited on through an
        event recorded behind it (no pageable copy)."""
        h = self._start_get(t)
        if t.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            ev.synchronize()
        self.bytes_d2h += h.numel() * h.element_size()
        return h.numpy()

    def _full(self, n: int, fill: int, cols: int = 0, device=None,
              i32: bool = False) -> torch.Tensor:
        """Neutral state made on the device (cols=0 -> [n]; cols=C -> [n, C];
        i32: an int32 src plane)."""
        dev = self.device if device is None else device
        if cols:
            return torch.zeros((n, cols), dtype=torch.int64, device=dev)
        return B.device_full(n, fill, i32=i32, device=dev)

    def _grow(self, old: torch.Tensor, delta: int, fill: int,
              cols: int = 0, i32: bool = False) -> torch.Tensor:
        return torch.cat([old, self._full(delta, fill, cols, i32=i32)])

    def _sp_size(self, size: int) -> int:
        """Padded plane size: pow2, then, with range partitions, rounded
        up to a multiple of their count."""
        sp = K.next_pow2(max(size, 1))
        if self._devs is not None and sp % len(self._devs):
            sp = -(-sp // len(self._devs)) * len(self._devs)
        return sp

    # ----------------------------------------------------- range partitions
    # A partitioned plane is a list of K tensors, partition k holding the
    # plane's rows [k * P, (k+1) * P), P = cap / K, on self._devs[k].

    def _on(self, k: int):
        """Make partition k's card the current CUDA device (its kernels
        launch on that card's stream)."""
        dev = self._devs[k]
        return torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()

    def _each_part(self, rows: np.ndarray, base: int, sp: int):
        """Split sorted batch rows (plane rows, relative to `base`, of a
        plane of `sp` rows) by partition: yields (k, batch slice,
        partition base, partition size, device) for every partition that
        holds some of them, with partition k's card current."""
        rows = np.asarray(rows)
        if len(rows) > 1 and not (rows[1:] >= rows[:-1]).all():
            raise RuntimeError("partitioned dispatch needs rows sorted "
                               "ascending (the stages sort them)")
        kk = len(self._devs)
        p = sp // kk
        edges = np.searchsorted(rows - base, np.arange(kk + 1) * p)
        for k in range(kk):
            j0, j1 = int(edges[k]), int(edges[k + 1])
            if j1 > j0:
                with self._on(k):
                    yield k, slice(j0, j1), base + k * p, p, self._devs[k]

    def _put_plane(self, host: np.ndarray):
        """A padded host plane ([cap] or [cap, C]) to the device: one
        tensor, or one per partition."""
        if self._devs is None:
            return self._h2d(host)
        p = len(host) // len(self._devs)
        return [self._h2d(host[k * p:(k + 1) * p], dev)
                for k, dev in enumerate(self._devs)]

    def _full_plane(self, cap: int, fill: int, cols: int = 0,
                    i32: bool = False):
        """A neutral plane of `cap` rows made on the device(s)."""
        if self._devs is None:
            return self._full(cap, fill, cols, i32=i32)
        p = cap // len(self._devs)
        return [self._full(p, fill, cols, dev, i32) for dev in self._devs]

    def _grow_plane(self, old, old_cap: int, cap: int, fill: int,
                    cols: int = 0, i32: bool = False):
        """Extend a plane from old_cap to cap neutral-filled rows.  A
        partitioned plane re-splits: its boundaries move, so each new
        partition gathers its range from the old ones."""
        if self._devs is None:
            return self._grow(old, cap - old_cap, fill, cols, i32)
        kk = len(self._devs)
        p0, p1 = old_cap // kk, cap // kk
        out = []
        for k, dev in enumerate(self._devs):
            lo, hi = k * p1, (k + 1) * p1
            pieces = []
            for j in range(lo // p0, min(kk, -(-hi // p0))):
                a, b = max(lo, j * p0), min(hi, (j + 1) * p0)
                pieces.append(old[j][a - j * p0:b - j * p0].to(dev))
            have = sum(x.shape[0] for x in pieces)
            if have < p1:
                pieces.append(self._full(p1 - have, fill, cols, dev, i32))
            out.append(pieces[0] if have == 0 else torch.cat(pieces))
        return out

    def _plane_rows(self, col, n: int):
        """Rows [0, n) of a plane: a view, or one view per partition
        that holds any of them."""
        if self._devs is None:
            return col[:n]
        p = col[0].shape[0]
        return [part[:min(p, n - k * p)] for k, part in enumerate(col)
                if n > k * p]

    def _get_plane(self, col, n: int) -> np.ndarray:
        """Download rows [0, n) of a plane (partition by partition)."""
        if self._devs is None:
            return self._get(col[:n])
        return np.concatenate([self._get_pinned(t)
                               for t in self._plane_rows(col, n)])

    # ---------------------------------------------------------- fold backend

    def _host_combine(self) -> bool:
        """Host group pre-combine is on unless a device fold backend is
        explicitly forced or folding is off entirely."""
        return self.dense_fold == "auto"

    def _fold_backend(self) -> str:
        """"cuda" (hand-written kernels), "eager" (plain versions) or
        "off".  "auto" takes the kernels on a CUDA device and the plain
        versions only on the CPU device the caller asked for."""
        if self.dense_fold != "auto":
            return self.dense_fold
        return "cuda" if self.device.type == "cuda" else "eager"

    def _fold_apply(self, stacks, ids: np.ndarray, planes,
                    device=None) -> np.ndarray:
        """K1 with its apply: the [R, nA] stacks (t, node and, for
        elements, del_t; each given as its R host rows of nA) and the nA
        int32 state rows `ids` go up in ONE packed copy through the fold
        slot; the fold's winners land IN PLACE in the device state
        `planes` (t, node[, del_t]); the winner column comes back through
        one pinned download.  -> win [nA] int32 host array: the winning
        batch where the batch beat the state row, else -1."""
        dev, (idx,) = self._h2d_packed([_Stack(r) for r in stacks], [ids],
                                       slot=self._fold_slot, device=device)
        dt, st_dt = (dev[2], planes[2]) if len(dev) > 2 else (None, None)
        fn = KN.fold_apply if self._fold_backend() == "cuda" \
            else B.fold_apply
        win = fn(dev[0], dev[1], idx, planes[0], planes[1], dt=dt,
                 st_dt=st_dt)
        return self._get_pinned(win)

    def _fold_apply_parts(self, stacks, rows0: np.ndarray, base: int,
                          sp: int, planes) -> np.ndarray:
        """_fold_apply over range partitions: each partition holding some
        of the (sorted) rows0 runs one K1 launch on its slice of the
        stacks, with partition-local ids, into its own planes; the
        winner columns concatenate in row order."""
        wins = []
        for k, sl, b, _p, dev in self._each_part(rows0, base, sp):
            if self._fold_backend() == "cuda":
                self.partition_launches[k]["merge_elems"] += 1
            wins.append(self._fold_apply(
                [[r[sl] for r in rs] for rs in stacks],
                (rows0[sl] - b).astype(_I32),
                tuple(pl[k] for pl in planes), dev))
        return np.concatenate(wins)

    def _fold_pair(self, v_s, t_s, device=None):
        """[R, N] stacks -> per-slot (value @ time) LWW with max-value tie:
        (val[N], t[N]) on device."""
        v, t = self._h2d(v_s, device), self._h2d(t_s, device)
        if self._fold_backend() == "cuda":
            return KN.merge_counters(v, t)
        return D.dense_merge_counters(v, t)

    # ------------------------------------------------------- group combine

    def _combine_groups(self, staged, fold_fn, cat_fn):
        """Collapse a multi-batch staged list on host, hierarchically:
        entries with IDENTICAL row sets cluster and fold via `fold_fn`;
        then, if the folded survivors are pairwise disjoint, they
        concatenate into one transfer via `cat_fn`.  -> (combined,
        n_folds); the main thread applies the count."""
        if not self._host_combine() or len(staged) < 2:
            return staged, 0
        clusters: list[list] = []
        by_sig: dict = {}
        for s in staged:
            r = s[0]
            sig = (len(r), int(r[0]) if len(r) else -1,
                   int(r[-1]) if len(r) else -1)
            placed = False
            for cl in by_sig.get(sig, ()):
                r0 = cl[0][0]
                if r0 is r or np.array_equal(r0, r):
                    cl.append(s)
                    placed = True
                    break
            if not placed:
                cl = [s]
                clusters.append(cl)
                by_sig.setdefault(sig, []).append(cl)
        folded = []
        n_folds = 0
        for cl in clusters:
            if len(cl) > 1:
                n_folds += 1
                folded.append(fold_fn(cl))
            else:
                folded.append(cl[0])
        if len(folded) == 1:
            return folded, n_folds
        cat = _rows_disjoint_cat(folded)
        if cat is not None:
            return [cat_fn(folded, cat)], n_folds
        return folded, n_folds

    def _pool_add(self, vals, **cols) -> np.int32:
        """Stage one batch's winner-carried payload in the host pool and
        return its base pool id (the device derives per-row ids as
        base + iota).  `vals` = None means every value is None (a winning
        valueless row still CLEARS the slot value); `cols` are the host
        columns reconstructed at flush.  The int32 ceiling is checked
        BEFORE any pool state mutates."""
        base = self._pool_size
        n = -1
        nbytes = 0
        if vals is not None:
            vals = list(vals)
            n = len(vals)
            nbytes += 8 * n + sum(map(len, filter(None, vals)))
        for a in cols.values():
            n = len(a)
            nbytes += int(getattr(a, "nbytes", 8 * n))
        if base + n >= self.POOL_ID_CEILING:
            raise RuntimeError(
                "win-source pool would exceed int32 range within a single "
                "merge round; split the ingest into smaller merge_many "
                "calls so flush() can run between them")
        k = len(self._val_pool)
        if k == len(self._pool_bases):
            self._pool_bases = np.concatenate(
                [self._pool_bases, np.zeros(k, dtype=_I64)])
        self._pool_bases[k] = base
        self._val_pool.append((base, vals, cols))
        self._pool_size = base + n
        self._pool_bytes += nbytes
        return np.int32(base)

    def _src_state(self, fam: str, sp: int) -> torch.Tensor:
        """Device win-source plane for `fam`, grown to sp (fill -1)."""
        res = self._res.get(fam) or {}
        src = res.get("src")
        if src is None:
            return self._full_plane(sp, -1, i32=True)
        cap = src.shape[0] if self._devs is None \
            else src[0].shape[0] * len(self._devs)
        if cap < sp:
            src = self._grow_plane(src, cap, sp, -1, i32=True)
        return src

    # ------------------------------------------------------------------ API

    def merge(self, store: KeySpace, batch: ColumnarBatch) -> MergeStats:
        return self.merge_many(store, [batch])

    def merge_many(self, store: KeySpace,
                   batches: list[ColumnarBatch]) -> MergeStats:
        """Fold any number of columnar batches into the store, one device
        pass per CRDT family.  The returned MergeStats carries this call's
        transfer deltas."""
        h0, d0 = self.bytes_h2d, self.bytes_d2h
        r0, f0 = self.dev_rounds_resident, self.flush_rows_downloaded
        st = self._merge_many_impl(store, batches)
        st.dev_upload_bytes = self.bytes_h2d - h0
        st.dev_download_bytes = self.bytes_d2h - d0
        st.dev_rounds_resident = self.dev_rounds_resident - r0
        st.flush_rows_downloaded = self.flush_rows_downloaded - f0
        return st

    def _merge_many_impl(self, store: KeySpace,
                         batches: list[ColumnarBatch]) -> MergeStats:
        st = MergeStats()
        # the bulk path writes each slot once per batch, which is only a
        # merge if slots are unique within every batch
        self._unique_ok = all(b.rows_unique_per_slot for b in batches)
        self._n0_keys = store.keys.n
        self._pool_headroom(store, sum(b.n_rows for b in batches))
        resolved = self._resolve_all(store, batches, st)
        if not self._unique_ok and \
                sum(b.n_rows for b in batches) <= self.HOST_SCATTER_MAX:
            # op-stream micro-batches.  The steady placement merges warm
            # families in place into the resident planes; cold families
            # take their host twins (see _micro_placement)
            fams = set()
            for b, _ in resolved:
                fams |= touched_families(b)
            placement = self._micro_placement(store, fams)
            if placement is not None:
                self._micro_round(store, resolved, st, placement)
                return st
            # whole-round host fallback (steady off): resident mirrors of
            # the touched planes sync down first
            from .hostbatch import merge_host_batch
            for fam in list(self._res):
                self._drop_family(store, fam)
            self.host_micro_rounds += 1
            with trace.span("engine.host_round", into=self.spans):
                rows0 = st.tensor_rows
                for b, kid_of in resolved:
                    merge_host_batch(store, b, kid_of, st)
                self.tns_host_rows += st.tensor_rows - rows0
            return st
        # a src-tracked pool must resolve before a bulk branch that does
        # not track src (forced fold configs) writes into the same planes
        if self.resident and self._pool_size and not self._host_combine():
            flush_for(self, store, "pre_bulk")
        self._fold_on = self._fold_backend() != "off"
        stage = {"env": self._stage_envelopes, "reg": self._stage_registers,
                 "cnt": self._stage_counter_rows, "el": self._stage_elem_rows}
        dispatch = {"env": self._dispatch_envelopes,
                    "reg": self._dispatch_registers,
                    "cnt": self._dispatch_counter_rows,
                    "el": self._dispatch_elem_rows}
        if self.pipeline:
            # the staging pool runs the family stages (concurrently: each
            # touches only its own host plane) while the main thread
            # dispatches each plan in family order as it lands
            ex = self._staging_executor()
            futs = {f: ex.submit(self._timed_stage, f, stage[f],
                                 store, resolved, st)
                    for f in self.FAM_ORDER}
            self._stage_pending = futs
            try:
                for fam in self.FAM_ORDER:
                    with trace.span(f"engine.stage_wait.{fam}",
                                    into=self.spans):
                        plan = futs[fam].result()
                    with trace.span(f"engine.dispatch.{fam}",
                                    into=self.spans):
                        dispatch[fam](store, plan, st)
            finally:
                # a dispatch error must not leave stages mutating the store
                concurrent.futures.wait(list(futs.values()))
                self._stage_pending = None
        else:
            for fam in self.FAM_ORDER:
                with trace.span(f"engine.stage_wait.{fam}", into=self.spans):
                    plan = self._timed_stage(fam, stage[fam], store,
                                             resolved, st)
                with trace.span(f"engine.dispatch.{fam}", into=self.spans):
                    dispatch[fam](store, plan, st)
        # tensor rows (few, payload-heavy) ride the resident payload
        # pools whenever the steady path is on; the host twin otherwise
        tns_device = self.resident and self.steady
        for b, kid_of in resolved:
            if len(b.tns_ki):
                self._merge_micro_tns(store, b, kid_of, st,
                                      device=tns_device)
        for b, _ in resolved:
            for i, key in enumerate(b.del_keys):
                store.record_key_delete(key, int(b.del_t[i]))
        # slot merges bypass the incremental sum cache: re-derive it in one
        # pass; resident mode re-derives at flush instead
        if not (self.resident and self.needs_flush) and \
                any(len(b.cnt_ki) for b, _ in resolved):
            store.recompute_counter_sums()
        # bound the win pool's pinned host bytes
        if self.resident and self.needs_flush and \
                self._pool_bytes > self.pool_flush_bytes:
            flush_for(self, store, "pool_bytes")
        return st

    def _pool_headroom(self, store: KeySpace, n_rows: int) -> None:
        """Pool-id headroom: flush completed rounds BEFORE staging one that
        could cross the int32 ceiling (the round boundary is the only
        safe flush point)."""
        if self.resident and self._pool_size and \
                self._pool_size + n_rows >= self.POOL_ID_CEILING:
            log.info("win-source pool near int32 ceiling; flushing before "
                     "this merge round")
            flush_for(self, store, "pool_ceiling")

    def _resolve_all(self, store: KeySpace, batches, st) -> list:
        """[(batch, kid_of)]: replica snapshots of one keyspace share the
        key-list object (or a key_shape token when chunked), so each
        distinct one resolves once."""
        memo: dict = {}
        resolved = []
        with trace.span("engine.resolve_keys", into=self.spans):
            for b in batches:
                mk = b.key_shape if b.key_shape is not None \
                    else ("id", id(b.keys), id(b.key_enc))
                kid_of = memo.get(mk)
                if kid_of is None:
                    kid_of = self._resolve_keys(store, b, st)
                    memo[mk] = kid_of
                resolved.append((b, kid_of))
        return resolved

    def _micro_round(self, store: KeySpace, resolved, st,
                     placement: dict) -> None:
        """One steady micro round in Python, batch by batch, under
        `placement` (_micro_placement)."""
        with trace.span("engine.micro_round", into=self.spans):
            for b, kid_of in resolved:
                self._merge_micro_resident(store, b, kid_of, st, placement)
            self._count_round(placement)
        self._pool_bound(store)

    def _count_round(self, placement: dict) -> None:
        for fam, on_dev in placement.items():
            self.micro_rounds[fam][on_dev] += 1
        if any(placement.values()):
            self.dev_rounds_resident += 1
        elif placement:
            self.host_micro_rounds += 1
        # an empty placement (env-only / delete-only round) counts in
        # neither gauge: no device family was touched

    def _pool_bound(self, store: KeySpace) -> None:
        """Bound the win pool's pinned host bytes."""
        if self.needs_flush and self._pool_bytes > self.pool_flush_bytes:
            flush_for(self, store, "pool_bytes")

    # ---------------------------------------------- coalesced stream batches

    def merge_stream(self, store: KeySpace, src) -> MergeStats:
        """Land one coalesced op-stream batch.  `src` is a pending batch
        with the landing surface of replica/coalesce.py BatchBuilder (a
        replica/wire.py WireBatch has it too): `finalize()` makes its
        ColumnarBatch.  A steady round that holds no tensor rows, no cold
        family and no device env mirror is planned by one native call
        (`_merge_planned`); any other takes the Python micro round, and
        an engine off the steady path, or a batch past HOST_SCATTER_MAX
        rows, takes `merge_many`, as every landing did before.  Each
        steady round counts once: `engine.micro_planned`, or
        `engine.micro_python.<cause>` (engine/base.py
        MICRO_PYTHON_CAUSES)."""
        if not (self.steady and self.resident) or \
                src.n_rows > self.HOST_SCATTER_MAX:
            return self.merge_many(store, [src.finalize()])
        h0, d0 = self.bytes_h2d, self.bytes_d2h
        r0, f0 = self.dev_rounds_resident, self.flush_rows_downloaded
        st = MergeStats()
        self._unique_ok = False
        self._n0_keys = store.keys.n
        self._pool_headroom(store, src.n_rows)
        fams = src.touched()
        placement = self._micro_placement(store, fams)
        if "tns" in fams:
            cause = "tns"
        elif "env" in self._res:
            cause = "env_mirror"
        elif not all(placement.values()):
            cause = "cold"
        else:
            cause = None
        if cause is None:
            trace.count("engine.micro_planned", into=self.spans)
            self._merge_planned(store, src, st, placement)
        else:
            trace.count(f"engine.micro_python.{cause}", into=self.spans)
            resolved = self._resolve_all(store, [src.finalize()], st)
            self._micro_round(store, resolved, st, placement)
        st.dev_upload_bytes = self.bytes_h2d - h0
        st.dev_download_bytes = self.bytes_d2h - d0
        st.dev_rounds_resident = self.dev_rounds_resident - r0
        st.flush_rows_downloaded = self.flush_rows_downloaded - f0
        return st

    def _merge_planned(self, store: KeySpace, src, st,
                       placement: dict) -> None:
        """One steady round planned natively (native/planner.cpp
        plan_round: the key-delete rule, key, slot and row resolution and
        creation, the envelope max, the folds, the host del_t advance and
        the packed upload bytes, in one call).  What holds Python objects
        or device handles stays here: the blob side lists, a counter rank
        index that must grow, the resident planes, the value pool, the
        copy and the K3 launch.  The same winners, rows and pool ids
        as _merge_micro_resident."""
        from ..utils.native import load
        obj, columnar = src.plan_input()
        bound = src.n_rows          # no table gains more rows than this
        keys, cnt, el = store.keys, store.cnt, store.el
        with trace.span("engine.micro_round", into=self.spans):
            (packed, n64, segs, new_keys, bad, created, new_members,
             reg_vals, el_vals, counts) = load().ext.plan_round(
                obj, columnar, store.key_index.handle,
                store.member_index.handle, store.el_index.handle,
                keys.reserve(bound, _PLAN_KEY_COLS), keys.n,
                cnt.reserve(bound, _PLAN_CNT_COLS), cnt.n,
                el.reserve(bound, _PLAN_EL_COLS), el.n, store.node_rank,
                store.cnt_rank_rows, store.cnt_rank_hash,
                store.cnt_rank_live, store.rank_of, S.NEUTRAL_T,
                store.CNT_WINDOW_DENSE_FLOOR, store.CNT_WINDOW_MIN_FILL)
            n_keys, n_cnt, n_el, reg_rows, cnt_rows, el_rows = counts
            keys.set_rows(n_keys)
            if new_keys:
                store.key_bytes.extend(new_keys)
                store.reg_val.extend([None] * len(new_keys))
            cnt.set_rows(n_cnt)
            for rank, row0, kids in created:
                store.cnt_rows_assign(
                    rank, np.array(kids, dtype=_I64),
                    np.arange(row0, row0 + len(kids), dtype=_I64))
            el.set_rows(n_el)
            if new_members:
                store.el_member.extend(new_members)
                store.el_val.extend([None] * len(new_members))
            st.keys_seen += len(src.keys)
            st.keys_created += len(new_keys)
            if bad:
                for i, held, incoming in bad:
                    log.error("type conflict merging key %r: local=%s "
                              "incoming=%s", src.keys[i], held, incoming)
                st.type_conflicts += len(bad)
            st.counter_rows += cnt_rows
            st.elem_rows += el_rows
            for fam, rows in (("reg", reg_rows), ("cnt", cnt_rows),
                              ("el", el_rows)):
                if rows:
                    self.micro_rows[fam][1] += rows
            if segs:
                self._launch_planned(store, packed, n64, segs, reg_vals,
                                     el_vals)
            for key, t in src.deletes():
                store.record_key_delete(key, int(t))
            self._count_round(placement)
        self._pool_bound(store)

    def _launch_planned(self, store: KeySpace, packed, n64: int, segs,
                        reg_vals, el_vals) -> None:
        """A planned round's segments into the resident planes, as
        _micro_scatter_pair and _launch_round do for the Python round:
        each pair segment's mirror, value pool entry (PAIR_SRC) and dirty
        rows, the element del_t segment's rows queued for GC at flush;
        then the planner's packed bytes up in one copy and one K3 launch.
        A round always has a PAIR_SRC segment, whose pool entry keeps the
        packed bytes alive past the copy."""
        buf = np.frombuffer(packed, dtype=np.uint8)
        h64 = buf[:8 * n64].view(_I64)
        h32 = buf[8 * n64:].view(_I32)
        placed = []
        for kind, code, n, o64, ncols, o32 in segs:
            fam, names = _PLAN_SEGS[kind, code]
            ids = h32[o32:o32 + n]
            base = 0
            if kind == KN.MAX1:
                self._el_del_touched.append(ids.astype(_I64))
            else:
                cols, sp = self._resident_state(store, fam,
                                                _fam_rows(store, fam))
                planes = {c: cols[c] for c in names}
                if kind == KN.PAIR_SRC:
                    p, q = names
                    base = int(self._pool_add(
                        reg_vals if fam == "reg" else
                        (el_vals if fam == "el" else None),
                        **{p: h64[o64:o64 + n],
                           q: h64[o64 + n:o64 + 2 * n]}))
                    self._micro_done(fam, planes, self._src_state(fam, sp),
                                     {p: p, q: q}, set(names), ids)
                else:
                    self._micro_done(fam, planes, None, None, set(names),
                                     ids)
            placed.append((kind, fam, names, n, o64, ncols, o32, base))
        dev = self._upload_planned(buf)
        d64 = dev[:8 * n64].view(torch.int64)
        d32 = dev[8 * n64:].view(torch.int32)
        out = []
        for kind, fam, names, n, o64, ncols, o32, base in placed:
            res = self._res[fam]
            planes = tuple(res["cols"][c] for c in names)
            if kind == KN.PAIR_SRC:
                planes += (res["src"],)
            out.append(KN.Segment(
                kind, planes, d32[o32:o32 + n],
                tuple(d64[o64 + k * n:o64 + (k + 1) * n]
                      for k in range(ncols)), base))
        KN.scatter_round(out)

    def _upload_planned(self, buf: np.ndarray) -> torch.Tensor:
        """A planned round's packed bytes on the device in one copy, from
        the planner's own bytes: the value pool holds them until the
        flush, so no staging slot and no event guards them."""
        self.bytes_h2d += buf.nbytes
        self.h2d_copies += 1
        dev = torch.from_numpy(buf)
        if self.device.type == "cpu":
            return dev.clone()   # a private copy, as _h2d makes on the CPU
        return dev.to(self.device, non_blocking=True)

    # ------------------------------------------------------ stage pipeline

    def _staging_executor(self):
        """Staging pool sized to the spare cores
        (CONSTDB_TORCH_STAGE_WORKERS overrides)."""
        if self._stage_ex is None:
            n = env_int("CONSTDB_TORCH_STAGE_WORKERS",
                        max(1, min(len(self.FAM_ORDER),
                                   (os.cpu_count() or 2) - 1)))
            self._stage_ex = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(n, 1), thread_name_prefix="constdb-stage")
        return self._stage_ex

    def close(self) -> None:
        """Release the staging pool's threads and the pinned host buffers
        (idempotent)."""
        ex = self._stage_ex
        if ex is not None:
            self._stage_ex = None
            ex.shutdown(wait=False)
        self._release_pinned()

    def _release_pinned(self) -> None:
        """Drop the pinned staging ring and K1's fold slot once their last
        copies have read them; the next upload pins anew.  The blocks go
        back to PyTorch's pinned-memory cache of this process (a shard
        worker empties that cache when its shard is freed)."""
        for slot in (*self._ring, self._fold_slot):
            if slot["ev"] is not None:
                slot["ev"].synchronize()
            slot["buf"] = None
            slot["ev"] = None

    # ------------------------------------------------------- release hooks

    def release_device_pools(self, store: KeySpace) -> None:
        """Memory reclaim (the reference's hard-watermark hook): flush the
        resident state down to `store`, then drop the device mirrors, the
        win-value pool, the tensor payload pools (the tensor epoch moves
        on) and the pinned host buffers.  Everything refills lazily on
        the next merge.  Loss-free: host state is exact before anything
        drops."""
        flush_for(self, store, "release")
        self._forget_resident()

    def discard_resident(self) -> None:
        """Forget every resident device state WITHOUT a flush and clear
        `needs_flush`: only valid when the host store is discarded with it
        (a freed shard, a reset for a full resync); a fresh store's
        fam_ver could otherwise collide with a stale mirror's version."""
        self._forget_resident()
        self.needs_flush = False

    def _forget_resident(self) -> None:
        self._join_staging()
        self._res.clear()
        self._val_pool.clear()
        self._pool_size = 0
        self._pool_bytes = 0
        self._el_del_touched.clear()
        self._drop_tns_pools()
        self._tns_read_cache = {}
        self._release_pinned()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def _timed_stage(self, fam: str, fn, store, resolved, st):
        """One family's stage, timed (wall and thread CPU)."""
        with trace.span(f"engine.stage.{fam}", into=self.spans, cpu=True):
            return fn(store, resolved, st)

    def _join_staging(self) -> None:
        """Wait for in-flight family stages before any cross-plane
        mutation; their errors re-raise from future.result() in the merge
        loop."""
        futs = self._stage_pending
        if futs:
            concurrent.futures.wait(list(futs.values()))

    # ---------------------------------------------------------------- flush

    def flush(self, store: KeySpace) -> None:
        """Write resident device state back into the host keyspace
        (resident mode only; a no-op otherwise), re-derive the counter
        sums and enqueue element tombstones.  Timed in the span
        `engine.flush`; base.flush_for counts it by cause.

        Dirty-row accounting: a family whose merges since the last flush
        were all steady micro rounds carries its dirty rows, and only
        those rows are gathered on the device and downloaded, with the
        counter sums updated by the old-vs-new contribution delta of
        exactly those rows.  A bulk merge marks its plane whole
        (dirty=None): the plane downloads whole and the sums re-derive
        (K4 on the card).  An untouched family costs nothing.

        Every family's downloads start up front, into pinned host buffers
        with an event recorded after each family; then families are
        consumed one at a time, each waiting only on its own event, so
        family f's host-side application overlaps the remaining copies.
        Winner-carried columns never download: they reconstruct on host
        from the win pool through the int32 src plane."""
        if not self.needs_flush:
            return
        self._join_staging()
        with trace.span("engine.flush", into=self.spans):
            self._flush(store)

    def _flush(self, store: KeySpace) -> None:
        # fam -> (dirty rows or None for the whole plane, {name: tensor})
        pending: dict[str, tuple] = {}
        for fam, res in self._res.items():
            n = res["n"]
            if n == 0:
                continue
            dirty = res.get("dirty")
            if dirty is not None and not len(dirty):
                continue  # untouched since the last flush: host == device
            self.flush_rows_full_equiv += n
            if dirty is None:
                rows_d = None
                # a partitioned plane downloads partition by partition
                fp = {name: self._plane_rows(plane, n)
                      for name, plane in self._flush_planes(fam, res)}
                if fp:
                    self.flush_rows_downloaded += n
            else:
                # a key flush took the rows it wrote back off the mask
                rows_d = np.flatnonzero(dirty[:n])
                fp, _ = self._gather_rows(fam, res, rows_d)
            pending[fam] = (rows_d, fp)
        started: dict[str, tuple] = {}
        for fam, (rows_d, fp) in pending.items():
            hosts = {name: [self._start_get(x) for x in t]
                     if isinstance(t, list) else self._start_get(t)
                     for name, t in fp.items()}
            # one event behind the copies on each card involved
            cards = {x.device for t in fp.values()
                     for x in (t if isinstance(t, list) else (t,))
                     if x.device.type == "cuda"}
            evs = []
            for card in cards:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(card))
                evs.append(ev)
            started[fam] = (rows_d, hosts, evs)
        pending.clear()

        whole_cnt = False
        for fam, (rows_d, hosts, evs) in started.items():
            for ev in evs:
                ev.synchronize()
            res = self._res[fam]
            host = {}
            for name, h in hosts.items():
                hs = h if isinstance(h, list) else [h]
                for x in hs:
                    self.bytes_d2h += x.numel() * x.element_size()
                host[name] = hs[0].numpy() if len(hs) == 1 else \
                    np.concatenate([x.numpy() for x in hs])
            if rows_d is None:
                whole_cnt |= fam == "cnt" and bool(host)
                self._apply_whole(store, fam, res, host)
            elif len(rows_d):
                self._apply_dirty(store, fam, res, host, rows_d)
            if res.get("written") is not None:
                res["written"] = set()
            # host now equals device for this plane: src resolved, fresh
            # tracking next round
            res["src"] = None
            res["dirty"] = _CLEAN

        if self._el_del_touched:
            # host-maintained del side (el src path): with add_t now
            # reconstructed, queue rows that ended up dead
            rows = np.unique(np.concatenate(self._el_del_touched))
            self._el_del_touched.clear()
            self._enqueue_elem_garbage(
                store, rows, store.el.add_t[rows], store.el.del_t[rows],
                np.full(len(rows), -1, dtype=_I64))
        self._val_pool.clear()
        self._pool_size = 0
        self._pool_bytes = 0
        # the dirty path applied its sum deltas; a whole-plane cnt flush
        # re-derives every sum
        if whole_cnt and self._res["cnt"]["n"]:
            self._recompute_sums(store)
        self._flush_tns(store)
        self.needs_flush = False

    @staticmethod
    def _flush_planes(fam: str, res: dict) -> list:
        """[(name, device plane)] of what a flush of `fam` downloads: the
        columns written since the mirror was built, less the
        winner-carried ones that reconstruct from the value pool, and the
        src plane."""
        names = ["stack"] if fam == "env" else \
            [name for name, _ in _FAMILIES[fam]]
        written = res.get("written")
        src = res.get("src")
        recon = res.get("recon") if src is not None else None
        out = [(name, res["cols"][name]) for name in names
               if not (written is not None and name not in written)
               and not (recon and name in recon)]
        if src is not None:
            out.append(("src", src))
        return out

    def _gather_rows(self, fam: str, res: dict, rows: np.ndarray):
        """Gather `rows` (sorted unique int64) of what a flush of `fam`
        downloads (`_flush_planes`), on the device.  -> ({name: gathered
        tensor}, the uploaded row ids, None when `rows` is empty)."""
        if not len(rows):
            return {}, None
        idx = self._h2d(rows)
        self.flush_rows_downloaded += len(rows)
        return {name: B.gather_rows(plane, idx)
                for name, plane in self._flush_planes(fam, res)}, idx

    def _apply_whole(self, store: KeySpace, fam: str, res: dict,
                     host: dict) -> None:
        """Consume a whole-plane download."""
        n = res["n"]
        table = _host_table(store, fam)
        el_dt_changed = fam == "el" and "del_t" in host
        if el_dt_changed:
            old_dt = table.del_t[:n].copy()
        if fam == "env":
            if "stack" in host:
                out = host["stack"]
                for i, (name, _) in enumerate(_FAMILIES["env"]):
                    table.col(name)[:n] = out[:, i]
        else:
            for name, _ in _FAMILIES[fam]:
                if name in host:
                    table.col(name)[:n] = host[name]
        if "src" in host:
            self._apply_src(store, fam, host["src"], res)
        if el_dt_changed:
            self._enqueue_elem_garbage(store, np.arange(n), table.add_t[:n],
                                       table.del_t[:n], old_dt)

    def _apply_dirty(self, store: KeySpace, fam: str, res: dict, host: dict,
                     rows_d: np.ndarray) -> None:
        """Consume a dirty-row download (`rows_d` sorted unique).  The el
        del side is host-maintained on the micro path; its GC entries
        ride _el_del_touched."""
        table = _host_table(store, fam)
        if fam == "cnt":
            # the incremental sum delta needs the PRE-flush contributions
            # of exactly the dirty rows
            old_contrib = store.cnt.val[rows_d] - store.cnt.base[rows_d]
        if fam == "env":
            if "stack" in host:
                for i, (name, _) in enumerate(_FAMILIES["env"]):
                    table.col(name)[rows_d] = host["stack"][:, i]
        else:
            for name, _ in _FAMILIES[fam]:
                if name in host:
                    table.col(name)[rows_d] = host[name]
        if "src" in host:
            self._apply_src(store, fam, host["src"], res, rows=rows_d)
        if fam == "cnt":
            delta = store.cnt.val[rows_d] - store.cnt.base[rows_d] - \
                old_contrib
            changed = np.nonzero(delta)[0]
            if len(changed):
                np.add.at(store.keys.cnt_sum,
                          store.cnt.kid[rows_d[changed]], delta[changed])

    def _apply_src(self, store: KeySpace, fam: str, src_h: np.ndarray,
                   res: dict, rows: Optional[np.ndarray] = None) -> None:
        """Consume a downloaded src plane: (a) RECONSTRUCT the
        winner-carried int64 columns from the host pool (bit-identical to
        the device state: column and src are written under the same win
        predicate), and (b) assign deferred win VALUES.  `rows`: the
        table rows src_h's positions map to (a dirty-row flush downloads
        a gathered slice); None = src_h is the whole plane."""
        rows_all = np.nonzero(src_h >= 0)[0]
        if not len(rows_all):
            return
        pool = self._val_pool
        gids_all = src_h[rows_all].astype(_I64)
        if rows is not None:
            # sorted unique rows map through in order, so rows_all stays
            # strictly ascending (the contiguity fast path below holds)
            rows_all = rows[rows_all]
        if len(pool) == 1:
            order = np.arange(len(gids_all))
            uniq = np.zeros(1, dtype=_I64)
            starts = np.zeros(1, dtype=_I64)
            ends = np.array([len(order)])
        else:
            segs_all = np.searchsorted(self._pool_bases[:len(pool)],
                                       gids_all, side="right") - 1
            order = np.argsort(segs_all, kind="stable")
            uniq, starts = np.unique(segs_all[order], return_index=True)
            ends = np.append(starts[1:], len(order))
        # (a) column reconstruction, one pool segment at a time
        recon = res.get("recon")
        if recon:
            table = _host_table(store, fam)
            for s, lo, hi in zip(uniq.tolist(), starts.tolist(),
                                 ends.tolist()):
                sel = order[lo:hi]
                r_sel = rows_all[sel]
                off = gids_all[sel] - pool[s][0]
                cols = pool[s][2]
                for host_col, pool_col in recon.items():
                    table.col(host_col)[r_sel] = \
                        np.asarray(cols[pool_col])[off]
        # (b) win values, per segment (contiguous runs assign as one
        # list-slice write)
        if fam == "cnt":
            return  # counters carry no object values
        if fam == "reg":
            vmask = np.ones(len(rows_all), dtype=bool)
            target = store.reg_val
        else:
            vmask = np.isin(store.keys.enc[store.el.kid[rows_all]],
                            S.VALUE_ENCS)
            target = store.el_val
        for s, lo, hi in zip(uniq.tolist(), starts.tolist(), ends.tolist()):
            sel = order[lo:hi]
            m = vmask[sel]
            if not m.any():
                continue
            sel = sel[m]
            r_sel = rows_all[sel]
            b, vals, _ = pool[s]
            if vals is None:
                # all-valueless batch: winning rows CLEAR the slot value
                picked = [None] * len(r_sel)
            else:
                picked = list(map(vals.__getitem__,
                                  (gids_all[sel] - b).tolist()))
            r0 = int(r_sel[0])
            # r_sel is strictly ascending and unique by construction
            if int(r_sel[-1]) == r0 + len(r_sel) - 1:
                target[r0:r0 + len(r_sel)] = picked
            else:
                for r, v in zip(r_sel.tolist(), picked):
                    target[r] = v

    # ------------------------------------------------------ resident state

    def _resident_state(self, store: KeySpace, fam: str, n: int):
        """Device state dict for family `fam` covering rows [0, n); grows
        (neutral-filled) as the host table grows.  -> (cols, cap).

        The mirror records the host plane's write version at build time.
        After key-confined op writes (KeySpace.touch_key) it patches those
        keys' rows from the host; any other op-path write or GC to THIS
        plane forces a rebuild from host."""
        res = self._res.get(fam)
        ver = store.fam_ver[fam]
        if res is not None and res.get("ver") == ver and n <= res["cap"]:
            # fresh and wide enough: the steady rounds' common case
            res["n"] = n
            return res["cols"], res["cap"]
        patch = None
        if res is not None and res.get("ver") != ver:
            kids = store.keys_since(fam, res["ver"])
            if kids is not None:
                patch = store.rows_of_keys(fam, kids)
                if len(patch) and patch[-1] >= n:
                    patch = None
            # no row the host wrote since holds unflushed device data (the
            # caller flushes, whole or the key's rows, before every op-path
            # write); if one does, that invariant broke upstream, and a
            # rebuild or a patch would lose merges
            dirty = res.get("dirty")
            if res.get("written") and (
                    patch is None or dirty is None
                    or len(self._dirty_rows(dirty, patch))):
                raise RuntimeError(
                    f"{fam} mirror invalidated with unflushed merge data "
                    "(flush-before-touch invariant broken upstream)")
            if patch is None:
                self.mirror_rebuilds[fam] += 1
                res = None
            else:
                self.mirror_patches[fam] += 1
        cap = self._sp_size(n)
        spec = _FAMILIES[fam]
        if res is None:
            table = _host_table(store, fam)
            if fam == "env":
                host = np.stack([table.col(c)[:n] for c, _ in spec], axis=-1)
                cols = {"stack": self._put_plane(_pad(host, cap, 0))}
            else:
                cols = {c: self._put_plane(
                    _pad(table.col(c)[:n], cap, fill)) for c, fill in spec}
        elif n > res["cap"]:
            old = res["cols"]
            if self._devs is not None:
                self.resplits += 1
            if fam == "env":
                cols = {"stack": self._grow_plane(old["stack"], res["cap"],
                                                  cap, 0, cols=len(spec))}
            else:
                cols = {c: self._grow_plane(old[c], res["cap"], cap, fill)
                        for c, fill in spec}
        else:
            cols = res["cols"]
            cap = res["cap"]
        if patch is not None and len(patch):
            self._patch_rows(store, fam, cols, patch)
        # a fresh build starts clean (host == device); a reused or grown
        # mirror keeps its flush state (the micro path marks touched rows
        # between flushes, a bulk merge marks the plane whole)
        self._res[fam] = {"cols": cols, "n": n, "cap": cap, "ver": ver,
                          "src": res.get("src") if res else None,
                          "written": res.get("written", set()) if res
                          else set(),
                          "recon": res.get("recon") if res else None,
                          "dirty": res.get("dirty") if res else _CLEAN}
        return cols, cap

    @staticmethod
    def _dirty_rows(dirty: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Those of `rows` newer on the device than on the host, by a
        row-tracked family's dirty mask."""
        rows = rows[rows < len(dirty)]
        return rows[dirty[rows]]

    def _patch_rows(self, store: KeySpace, fam: str, cols: dict,
                    rows: np.ndarray) -> None:
        """Copy the host's current values of `rows` into the mirror (the
        rows a key-confined op write touched, all below the mirror's n):
        the row ids and every column in one copy."""
        table = _host_table(store, fam)
        names = [c for c, _ in _FAMILIES[fam]]
        mat = np.stack([rows] + [table.col(c)[rows]
                                 for c in names]).astype(_I64)
        if self._devs is None:
            parts = [(None, mat, self.device)]
        else:
            # partition k takes its rows, made partition-local
            p = (cols["stack"] if fam == "env" else cols[names[0]])[0]
            p = p.shape[0]
            owner = rows // p
            parts = []
            for k in np.unique(owner).tolist():
                m = mat[:, owner == k]
                m[0] -= k * p
                parts.append((k, m, self._devs[k]))
        for k, m, dev in parts:
            up = self._h2d(m, dev)
            idx = up[0]
            if fam == "env":
                plane = cols["stack"] if k is None else cols["stack"][k]
                plane[idx] = up[1:].T
                continue
            for i, c in enumerate(names):
                plane = cols[c] if k is None else cols[c][k]
                plane[idx] = up[1 + i]

    def _family_done(self, fam: str, cols: dict, n: int, cap: int,
                     src=None, written=None, recon=None) -> None:
        """Record post-merge device state of a BULK merge, which marks the
        plane whole (dirty=None: the next flush downloads it all).
        `written`: the columns the merges wrote since the mirror was
        created (None = all); flush downloads only those.  `recon`:
        winner-carried columns that reconstruct on host from the win pool
        instead."""
        prev = self._res.get(fam) or {}
        w = prev.get("written", set())
        w |= set(cols) if written is None else written
        self._res[fam] = {"cols": cols, "n": n, "cap": cap, "written": w,
                          "ver": prev.get("ver"),
                          "src": src if src is not None else prev.get("src"),
                          "recon": recon if recon is not None
                          else prev.get("recon"),
                          "dirty": None}
        self.needs_flush = True

    def _drop_family(self, store: KeySpace, fam: str) -> None:
        """A host-side (scatter) update is about to touch this family: sync
        device state down first, then forget the mirror."""
        if fam in self._res:
            flush_for(self, store, "drop_family")
            del self._res[fam]

    # ------------------------------------------------ steady micro merges
    # Op-stream micro-batches (the replication coalescer's flushes) merge
    # IN PLACE into the resident planes.  Duplicate slots fold on the host
    # with the shared reductions of engine/hostbatch.py; the unique
    # winners of every scatter of the batch (each LWW pair, the counter
    # base pair, the element del_t max) are collected, go up in one
    # packed copy and run in one K3 scatter_round launch at the end of
    # the batch.  The env plane stays host-authoritative (its merge is a
    # max into the host columns: no device bytes, and key-dt reads never
    # need a flush), and every scattered row joins the family's dirty set
    # so flush() downloads only those rows.

    def host_stale(self, families) -> bool:
        """True when any of `families` holds unflushed device-side merge
        state (its host columns lag the device).  A reader of planes
        outside that set may skip the flush; env is host-authoritative on
        the micro path, so dt reads never cost a round trip."""
        if not self.needs_flush:
            return False
        for fam in families:
            if fam == "tns":
                if any(p["dirty"] for p in self._tns_pools.values()):
                    return True
                continue
            res = self._res.get(fam)
            if res is not None and (res.get("written")
                                    or res.get("src") is not None):
                return True
        return False

    def key_dirty_rows(self, store: KeySpace, kid: int,
                       families) -> Optional[dict]:
        """The rows of key `kid` (-1: an absent key, which has none) in
        `families` that are newer on the device than on the host: {fam:
        sorted rows}, naming only families that have some (empty: the key
        reads the same from the host).  None when no key flush can serve:
        a family's whole plane is dirty (a bulk merge since the last
        flush) or tensor payloads are.  Costs the key's rows, not the
        dirty set's: each looks up the family's dirty mask."""
        out = {}
        if not self.needs_flush:
            return out
        for fam in families:
            if fam == "tns":
                if any(p["dirty"] for p in self._tns_pools.values()):
                    return None
                continue
            res = self._res.get(fam)
            if res is None or not res["n"]:
                continue
            dirty = res.get("dirty")
            if dirty is None:
                return None
            if kid < 0:
                continue
            rows = self._dirty_rows(dirty, store.rows_of_keys(fam, (kid,)))
            if len(rows):
                out[fam] = rows
        return out

    def flush_key(self, store: KeySpace, rows_by_fam: dict) -> None:
        """Write back only the given rows (a key's, from `key_dirty_rows`),
        as the dirty-row flush writes them: the downloaded columns, the
        winners rebuilt from the value pool, the counter-sum delta.  Every
        other row, the value pool and the tensor payloads stay resident
        for the next whole flush, which also queues the element garbage
        of the rows' advanced deletes (every GC pass flushes whole first).
        The rows then leave the dirty set and their src entries clear, so
        no later flush writes pool winners over what the host writes to
        them next.  Timed in the span `engine.flush_key`."""
        self._join_staging()
        with trace.span("engine.flush_key", into=self.spans):
            started = []
            for fam, rows in rows_by_fam.items():
                res = self._res[fam]
                fp, idx = self._gather_rows(fam, res, rows)
                self.flush_rows_full_equiv += res["n"]
                started.append((fam, rows, idx,
                                {name: self._start_get(t)
                                 for name, t in fp.items()}))
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self.device))
                ev.synchronize()
            for fam, rows, idx, hosts in started:
                res = self._res[fam]
                host = {}
                for name, h in hosts.items():
                    self.bytes_d2h += h.numel() * h.element_size()
                    host[name] = h.numpy()
                self._apply_dirty(store, fam, res, host, rows)
                res["dirty"][rows] = False
                src = res.get("src")
                if src is not None and idx is not None:
                    src.index_fill_(0, idx, -1)

    def _micro_placement(self, store: KeySpace, fams: set):
        """Per-family steady routing: {fam: True = in place on the device,
        False = host twin} over the device families `fams` this round
        touches (engine/base.py touched_families), or None when the
        steady path is off (the whole-round host fallback).  Families
        route independently: a warm plane (a fresh resident mirror, or a
        host version stable for more than `warmup` micro rounds) rides the
        device while a cold one merges on its host twin."""
        if not (self.steady and self.resident):
            return None
        placement = {}
        for fam in fams:
            ver = store.fam_ver[fam]
            if fam == "tns":
                # the tensor plane's mirror is its payload pool set
                if self._tns_pools and self._tns_ver == ver:
                    placement[fam] = True
                    continue
                res = None
            else:
                res = self._res.get(fam)
            if res is not None and (res.get("ver") == ver or
                                    store.keys_since(fam, res["ver"])
                                    is not None):
                # fresh, or behind only by key-confined writes that
                # _resident_state patches in
                placement[fam] = True
                continue
            last_ver, streak = self._warm_streak.get(fam, (-1, 0))
            # key-confined bumps do not reset the streak: once built, the
            # mirror patches their rows instead of re-uploading the plane
            steady = last_ver == ver or (
                last_ver >= 0 and fam != "tns" and
                store.keys_since(fam, last_ver) is not None)
            streak = streak + 1 if steady else 1
            self._warm_streak[fam] = (ver, streak)
            placement[fam] = streak > self.warmup
        return placement

    def _merge_micro_resident(self, store: KeySpace, b: ColumnarBatch,
                              kid_of: np.ndarray, st: MergeStats,
                              placement: dict) -> None:
        """Merge ONE op-stream micro-batch under the steady placement: warm
        families scatter in place into the resident planes (the device
        twin of hostbatch.merge_host_batch, fold for fold: both sides use
        the same fold_* reductions, so the scattered winners ARE the host
        path's winners), cold families take their host twins.

        The device scatters are collected into `rnd` and launched once,
        after the element family and before the tensor rows: nothing in
        between reads the device planes (a fresh mirror that
        _resident_state uploads lands before the launch, on the same
        stream), and the tensor merge may flush.  Batches never share a
        launch: two batches of one call can repeat a row."""
        from ..utils.tables import nonnull_mask
        from .hostbatch import (_apply_cnt_pair, _merge_el, _merge_env,
                                _merge_reg, _resolve_el_rows,
                                fold_pair_rows)
        if "env" in self._res:
            # a forced-fold catch-up can leave a device env mirror; the
            # micro path keeps env host-authoritative, so sync it down once
            self._drop_family(store, "env")
        rnd: list[_Scatter] = []
        valid = kid_of >= 0
        all_valid = bool(valid.all())
        if b.n_keys:
            kids = kid_of if all_valid else kid_of[valid]
            if len(kids):
                mat = np.stack([b.key_ct, b.key_mt, b.key_dt,
                                b.key_expire], axis=-1)
                _merge_env(store, kids, mat if all_valid else mat[valid])
            em = valid & (b.key_enc == S.ENC_BYTES) & \
                nonnull_mask(b.reg_val)
            idx = np.nonzero(em)[0]
            if len(idx):
                self.micro_rows["reg"][bool(placement.get("reg"))] += len(idx)
                if placement.get("reg"):
                    wk, wt, wn, srci = fold_pair_rows(
                        kid_of[idx], b.reg_t[idx], b.reg_node[idx])
                    vals = list(map(b.reg_val.__getitem__,
                                    idx[srci].tolist()))
                    self._micro_scatter_pair(store, rnd, "reg",
                                             ("rv_t", "rv_node"),
                                             wk, wt, wn, vals)
                else:
                    _merge_reg(store, kid_of[idx], b.reg_t[idx],
                               b.reg_node[idx],
                               list(map(b.reg_val.__getitem__,
                                        idx.tolist())))

        if len(b.cnt_ki):
            kid_arr = kid_of[b.cnt_ki]
            keep = np.nonzero(kid_arr >= 0)[0]
            if len(keep):
                st.counter_rows += len(keep)
                self.micro_rows["cnt"][bool(placement.get("cnt"))] += \
                    len(keep)
                sel = slice(None) if len(keep) == len(kid_arr) else keep
                rows = self._resolve_cnt_rows(store, kid_arr[sel],
                                              b.cnt_node[sel])
                bt = b.cnt_base_t[sel]
                base_neutral = bool((bt == K.NEUTRAL_T).all())
                if placement.get("cnt"):
                    # (uuid, val) pair: the winners reconstruct from the
                    # pool at flush, so the two columns never download
                    wr, wu, wv, _ = fold_pair_rows(rows, b.cnt_uuid[sel],
                                                   b.cnt_val[sel])
                    self._micro_scatter_pair(store, rnd, "cnt",
                                             ("uuid", "val"), wr, wu, wv,
                                             None)
                    if not base_neutral:
                        # base pair (counter deletes, rare): no src
                        # tracking, its dirty rows download at flush
                        wr2, wbt, wb, _ = fold_pair_rows(rows, bt,
                                                         b.cnt_base[sel])
                        self._micro_scatter_pair(store, rnd, "cnt",
                                                 ("base_t", "base"),
                                                 wr2, wbt, wb, None,
                                                 src=False)
                else:
                    _apply_cnt_pair(store, rows, b.cnt_val[sel],
                                    b.cnt_uuid[sel], "val", "uuid", 1)
                    if not base_neutral:
                        _apply_cnt_pair(store, rows, b.cnt_base[sel], bt,
                                        "base", "base_t", -1)

        if len(b.el_ki):
            kid_arr = kid_of[b.el_ki]
            keep = np.nonzero(kid_arr >= 0)[0]
            if len(keep):
                st.elem_rows += len(keep)
                self.micro_rows["el"][bool(placement.get("el"))] += len(keep)
                if len(keep) == len(kid_arr):
                    sel = slice(None)
                    members = b.el_member
                    vals = b.el_val
                else:
                    sel = keep
                    members = list(map(b.el_member.__getitem__,
                                       keep.tolist()))
                    vals = list(map(b.el_val.__getitem__, keep.tolist()))
                rows = _resolve_el_rows(store, kid_arr[sel], members)
                if not placement.get("el"):
                    _merge_el(store, rows, b.el_add_t[sel],
                              b.el_add_node[sel], b.el_del_t[sel], vals)
                else:
                    self._micro_elems(store, rnd, b, sel, rows, vals)

        self._launch_round(rnd)
        if len(b.tns_ki):
            self.micro_rows["tns"][bool(placement.get("tns"))] += \
                len(b.tns_ki)
            self._merge_micro_tns(store, b, kid_of, st,
                                  device=bool(placement.get("tns")))

        for i, key in enumerate(b.del_keys):
            store.record_key_delete(key, int(b.del_t[i]))

    def _micro_elems(self, store: KeySpace, rnd: list, b: ColumnarBatch,
                     sel, rows: np.ndarray, vals) -> None:
        """Element rows of one micro-batch on the device: the add pair
        scatters as a PAIR_SRC segment; the del side is a plain max
        applied to the HOST column with the device del_t plane advanced in
        lockstep by a MAX1 segment of the same round.  A
        host-only write would leave the mirror's del_t stale, and a later
        forced-fold bulk round (which reads and downloads del_t) would
        regress the host column and resurrect deleted elements.
        Newly-dead rows queue for GC at flush, after add_t
        reconstruction."""
        from .hostbatch import fold_el_rows
        wr, wat, wan, d_red, srci = fold_el_rows(
            rows, b.el_add_t[sel], b.el_add_node[sel], b.el_del_t[sel])
        if b.el_has_vals is False or not has_values(vals):
            wvals = None  # winning valueless adds still CLEAR the value
        else:
            wvals = list(map(vals.__getitem__, srci.tolist()))
        self._micro_scatter_pair(store, rnd, "el", ("add_t", "add_node"),
                                 wr, wat, wan, wvals)
        nz = np.flatnonzero(d_red)
        if not len(nz):
            return
        sel_r = wr[nz]
        dv = d_red[nz]
        adv = dv > store.el.del_t[sel_r]
        if not adv.any():
            return
        rows_adv = sel_r[adv]
        dv_adv = dv[adv]
        store.el.del_t[rows_adv] = dv_adv
        self._el_del_touched.append(rows_adv)
        rnd.append(_Scatter(KN.MAX1, "el", ("del_t",),
                            rows_adv.astype(_I32),
                            (np.asarray(dv_adv, dtype=_I64),)))

    def _micro_scatter_pair(self, store: KeySpace, rnd: list, fam: str,
                            pair, wr, wp, ws, vals, src: bool = True) -> None:
        """Collect one folded LWW pair for an in-place scatter into
        `fam`'s resident planes (launched with the rest of the round by
        _launch_round).  `pair` = (primary, secondary) column names; the
        win rule is lexicographic (primary, secondary) > current, exactly
        hostbatch's fold rule and ops/bulk._pair_win.  With `src` (the
        default) the segment is PAIR_SRC and the winners' pool ids land in
        the resident src plane: flush downloads the int32 src rows and
        reconstructs both columns and the win values from the host pool.
        src=False (the rare counter base pair) is a PAIR segment: it keeps
        its winner on the device and downloads its dirty rows at flush.
        The bookkeeping (dirty rows, written columns, src and recon) is
        recorded here: the planes update in place."""
        nw = len(wr)
        if not nw:
            return
        cols, sp = self._resident_state(store, fam, _fam_rows(store, fam))
        pcol, scol = pair
        planes = {pcol: cols[pcol], scol: cols[scol]}
        batch = (np.asarray(wp, dtype=_I64), np.asarray(ws, dtype=_I64))
        ids = wr.astype(_I32)
        if src:
            src_d = self._src_state(fam, sp)
            pb = self._pool_add(vals, **{pcol: wp, scol: ws})
            rnd.append(_Scatter(KN.PAIR_SRC, fam, pair, ids, batch, int(pb)))
            self._micro_done(fam, planes, src_d, {pcol: pcol, scol: scol},
                             {pcol, scol}, wr)
        else:
            rnd.append(_Scatter(KN.PAIR, fam, pair, ids, batch))
            self._micro_done(fam, planes, None, None, {pcol, scol}, wr)

    def _launch_round(self, rnd: list) -> None:
        """Upload a batch's collected scatters in one packed copy and
        apply them in one K3 scatter_round launch, on the planes the
        family records hold now."""
        if not rnd:
            return
        d64, d32 = self._h2d_packed([c for e in rnd for c in e.cols],
                                    [e.ids for e in rnd])
        segs = []
        k = 0
        for e, idx in zip(rnd, d32):
            res = self._res[e.fam]
            planes = tuple(res["cols"][c] for c in e.names)
            if e.kind == KN.PAIR_SRC:
                planes += (res["src"],)
            segs.append(KN.Segment(e.kind, planes, idx,
                                   tuple(d64[k:k + len(e.cols)]), e.base))
            k += len(e.cols)
        KN.scatter_round(segs)

    def _micro_done(self, fam: str, cols: dict, src, recon, written: set,
                    rows: np.ndarray) -> None:
        """Fold a micro scatter's results into the family record: the
        updated columns, src/recon tracking, the written columns, and the
        touched rows marked in the dirty mask (a bulk-merged plane, dirty
        None, stays whole)."""
        res = self._res[fam]
        res["cols"].update(cols)
        if src is not None:
            res["src"] = src
        if recon is not None:
            res["recon"] = dict(recon) if res.get("recon") is None \
                else {**res["recon"], **recon}
        res["written"] |= written
        m = res.get("dirty")
        if m is not None:
            if len(m) < res["cap"]:
                grown = np.zeros(res["cap"], dtype=bool)
                grown[:len(m)] = m
                res["dirty"] = m = grown
            m[np.asarray(rows)] = True
        self.needs_flush = True

    def _recompute_sums(self, store: KeySpace) -> None:
        """Counter-sum re-derivation after a whole-plane cnt flush.  With
        the CUDA fold backend the sum runs ON DEVICE over the resident
        slot columns: one K4 segment_sum launch computes val - base per
        slot and sums it per key (no separate subtraction); the slot kids
        upload as int32 through the pinned staging ring, and the [n_keys]
        sums download into pinned memory behind an event.
        Otherwise the host pass.  Both are exact int64, bit-identical to
        KeySpace.recompute_counter_sums.  K4 has no segment cap: it runs
        for any key count.  Timed in the span `engine.sums` (inside
        `engine.flush`)."""
        res = self._res.get("cnt")
        n = store.cnt.n
        nk = store.keys.n
        if not (self._fold_backend() == "cuda" and res is not None
                and res["n"] == n and n and nk):
            store.recompute_counter_sums()
            return
        cols = res["cols"]
        with trace.span("engine.sums", into=self.spans):
            if self._devs is not None:
                store.keys.cnt_sum[:nk] = self._partition_sums(store, cols,
                                                               n, nk)
                return
            _, (ids,) = self._h2d_packed([], [store.cnt.kid[:n]])
            sums = KN.segment_sum(ids, cols["val"][:n], nk,
                                  base=cols["base"][:n])
            store.keys.cnt_sum[:nk] = self._get_pinned(sums)

    def _partition_sums(self, store: KeySpace, cols: dict, n: int,
                        nk: int) -> np.ndarray:
        """The counter sums of a partitioned cnt plane: one K4 launch per
        partition holding slot rows (its slot kids up through the staging
        ring, its val - base summed per key over ALL nk keys), then the
        partial sums added mod 2^64 on the host (numpy int64 adds wrap):
        one key's slots may straddle a partition boundary."""
        vals = self._plane_rows(cols["val"], n)
        bases = self._plane_rows(cols["base"], n)
        p = cols["val"][0].shape[0]
        partial = []
        for k, (v, b) in enumerate(zip(vals, bases)):
            with self._on(k):
                _, (ids,) = self._h2d_packed(
                    [], [store.cnt.kid[k * p:k * p + v.shape[0]]],
                    device=self._devs[k])
                sums = KN.segment_sum(ids, v, nk, base=b)
                self.partition_launches[k]["segment_sum"] += 1
                partial.append(self._start_get(sums))
        for card in {d for d in self._devs[:len(partial)]
                     if d.type == "cuda"}:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(card))
            ev.synchronize()
        out = np.zeros(nk, dtype=_I64)
        for h in partial:
            self.bytes_d2h += h.numel() * h.element_size()
            out += h.numpy()
        return out

    # ---------------------------------------------------- tensor registers
    # The tensor-valued register family (crdt/tensor.py): contributor slot
    # STAMPS (uuid/cnt columns) stay host-authoritative (tiny LWW
    # compares), while the payload arrays live in resident device pools
    # keyed by (dtype, elems).  A micro round folds each batch's duplicate
    # slots on the host, wins against the host uuid column and scatters
    # ONLY the winning payloads into the pool; flush gathers and
    # downloads exactly the dirty pool slots.  Batched reads
    # (`tensor_read_many`) reduce the contributor stacks on the card with
    # K5, bit-identical to the host reference (KeySpace.tensor_read).

    def _tns_check(self, store: KeySpace) -> None:
        """Tensor-pool staleness: an op-path tensor write bumped the plane
        version, so every clean payload mirror may be stale: drop the
        pools (they refill lazily).  Dirty slots at a version bump mean
        the flush-before-touch invariant broke upstream."""
        ver = store.fam_ver["tns"]
        if self._tns_ver != ver:
            if any(p["dirty"] for p in self._tns_pools.values()):
                raise RuntimeError(
                    "tns pools invalidated with unflushed payloads "
                    "(flush-before-touch invariant broken upstream)")
            self._drop_tns_pools()
            self._tns_ver = ver

    def _drop_tns_pools(self) -> None:
        self._tns_pools.clear()
        self._tns_bytes = 0
        self._tns_epoch += 1

    def _tns_pool(self, meta) -> dict:
        """The pool of one (dtype, elems) class: a [cap, elems] device
        buffer, its slot -> store row map and its dirty slots."""
        key = (meta.dtype_code, meta.elems)
        pool = self._tns_pools.get(key)
        if pool is None:
            pool = {"buf": None, "rows": np.full(0, -1, dtype=_I64),
                    "map": {}, "n": 0, "cap": 0, "dirty": set(),
                    "elems": meta.elems, "dtype": meta.dtype}
            self._tns_pools[key] = pool
        return pool

    def _tns_slots(self, pool: dict, rows_store) -> np.ndarray:
        """Pool slots for store rows, allocating (and growing the device
        buffer with zero rows) for rows not yet resident."""
        m = pool["map"]
        need = sum(1 for r in rows_store if r not in m)
        if pool["n"] + need > pool["cap"]:
            cap = K.next_pow2(max(pool["n"] + need, 64))
            grown = np.full(cap, -1, dtype=_I64)
            grown[: len(pool["rows"])] = pool["rows"]
            pool["rows"] = grown
            dt = torch.from_numpy(np.zeros(0, pool["dtype"])).dtype
            zeros = torch.zeros((cap - pool["cap"], pool["elems"]),
                                dtype=dt, device=self.device)
            pool["buf"] = zeros if pool["buf"] is None else \
                torch.cat([pool["buf"], zeros])
            self._tns_bytes += \
                (cap - pool["cap"]) * pool["elems"] * pool["dtype"].itemsize
            pool["cap"] = cap
        out = np.empty(len(rows_store), dtype=_I64)
        for j, r in enumerate(rows_store):
            slot = m.get(r)
            if slot is None:
                slot = pool["n"]
                pool["n"] = slot + 1
                m[r] = slot
                pool["rows"][slot] = r
            out[j] = slot
        return out

    def _tns_scatter(self, pool: dict, slots: np.ndarray, mats: list,
                     dirty: bool) -> None:
        """Write payload rows into a pool in one upload and one scatter.
        `mats` are size-validated payloads (wire bytes or flat arrays of
        the pool dtype); `dirty` marks the slots device-newer than the
        host list (merge winners); uploads that mirror host payloads
        (read staging) stay clean."""
        w = len(slots)
        elems = pool["elems"]
        dt = pool["dtype"]
        # (wire payloads are little-endian; the zero-copy join needs the
        # native order to match)
        if w and np.little_endian and all(type(m) is bytes for m in mats):
            stack = np.frombuffer(b"".join(mats), dtype=dt).reshape(w, elems)
        else:
            stack = np.zeros((w, elems), dtype=dt)
            for j, m in enumerate(mats):
                arr = m if isinstance(m, np.ndarray) \
                    else np.frombuffer(m, dtype=dt.newbyteorder("<"))
                stack[j] = arr
        D.pool_scatter(pool["buf"], self._h2d(slots.astype(_I32)),
                       self._h2d(stack))
        if dirty:
            pool["dirty"].update(slots.tolist())

    def _merge_micro_tns(self, store: KeySpace, b: ColumnarBatch,
                         kid_of: np.ndarray, st: MergeStats,
                         device: bool) -> None:
        """Merge one batch's tensor rows.  `device=False` is the host
        reference (hostbatch.merge_host_tns, the per-row loop);
        `device=True` makes the same decisions in batch: fold duplicate
        slots, win against the host uuid column, scatter the winning
        payloads into the resident pools."""
        from ..crdt import tensor as T
        from .hostbatch import merge_host_tns
        if not device:
            n0 = st.tensor_rows
            merge_host_tns(store, b, kid_of, st)
            self.tns_host_rows += st.tensor_rows - n0
            return
        self._tns_check(store)
        kid_arr = kid_of[b.tns_ki]
        keep = np.nonzero(kid_arr >= 0)[0]
        if not len(keep):
            return
        st.tensor_rows += len(keep)
        self.tns_dev_rows += len(keep)
        # the count gate first, in the host reference's check order:
        # tensor_merge_row runs check_count BEFORE installing a fresh key's
        # config, so a key whose every row is count-invalid stays without
        # tns_meta on both paths
        cnt_ok = b.tns_cnt[keep] >= 1
        if not cnt_ok.all():
            log.error("skipping %d tensor rows: contribution count < 1",
                      int((~cnt_ok).sum()))
            keep = keep[cnt_ok]
            if not len(keep):
                return
        # per-key config install/validate and per-row payload checks: the
        # skip rules of KeySpace.tensor_merge_row, decided once per
        # distinct key when the whole batch shares one config
        idx_list = keep.tolist()
        metas: dict = {}
        ok = np.ones(len(keep), dtype=bool)
        cfg0 = b.tns_cfg[idx_list[0]]
        uniform = all(b.tns_cfg[i] is cfg0 or b.tns_cfg[i] == cfg0
                      for i in idx_list[1:])
        if uniform:
            bad_kids = False
            for kid in np.unique(kid_arr[keep]).tolist():
                meta = store.tns_meta.get(kid)
                try:
                    if meta is None:
                        meta = T.unpack_config(cfg0)
                        store.tns_meta[kid] = meta
                    elif T.pack_config(meta) != bytes(cfg0):
                        raise T.TensorConfigError("tensor config mismatch")
                    metas[kid] = meta
                except T.TensorConfigError as e:
                    log.error("skipping tensor rows for kid %d: %s", kid, e)
                    metas[kid] = False
                    bad_kids = True
            if bad_kids:
                ok &= np.fromiter(
                    (metas[int(k)] is not False for k in kid_arr[keep]),
                    dtype=bool, count=len(keep))
            meta_u = next((m for m in metas.values() if m is not False),
                          None)
            if meta_u is not None:
                bad_sz = np.fromiter(
                    (not T.payload_ok(meta_u, b.tns_payload[i])
                     for i in idx_list), dtype=bool, count=len(keep))
                if bad_sz.any():
                    log.error("skipping %d tensor rows: bad payload "
                              "(size/dtype)", int(bad_sz.sum()))
                    ok &= ~bad_sz
        else:
            for j, i in enumerate(idx_list):
                kid = int(kid_arr[i])
                meta = metas.get(kid)
                cfg = b.tns_cfg[i]
                if meta is None:
                    meta = store.tns_meta.get(kid)
                    try:
                        if meta is None:
                            meta = T.unpack_config(cfg)
                            store.tns_meta[kid] = meta
                        elif T.pack_config(meta) != bytes(cfg):
                            raise T.TensorConfigError(
                                "tensor config mismatch")
                    except T.TensorConfigError as e:
                        log.error("skipping tensor rows for kid %d: %s",
                                  kid, e)
                        metas[kid] = False
                        ok[j] = False
                        continue
                    metas[kid] = meta
                elif meta is False:
                    ok[j] = False
                    continue
                elif T.pack_config(meta) != bytes(cfg):
                    log.error("skipping tensor row for kid %d: config "
                              "mismatch", kid)
                    ok[j] = False
                    continue
                if not T.payload_ok(meta, b.tns_payload[i]):
                    log.error("skipping tensor row for kid %d: bad payload "
                              "(size/dtype)", kid)
                    ok[j] = False
                    continue
                store.tensor_count_merge(meta)
        keep = keep[ok]
        if not len(keep):
            return
        if uniform:
            # one gauge bump per validated delivered row, as the host
            # reference counts in tensor_merge_row
            meta0 = next((m for m in metas.values() if m is not False),
                         None)
            if meta0 is not None:
                store.tensor_count_merge(meta0, len(keep))
        kids = kid_arr[keep]
        uuids = b.tns_uuid[keep]
        cnts = b.tns_cnt[keep]
        # resolve (kid, node) -> slot rows (creates neutral rows), then
        # fold intra-batch duplicates: LWW on uuid, the FIRST occurrence
        # on exact ties (the host loop's strict > keeps the first too)
        rows = self._resolve_tns_rows(store, kids, b.tns_node[keep])
        order = np.lexsort((-np.arange(len(rows)), uuids, rows))
        r_s = rows[order]
        last = np.nonzero(np.append(r_s[1:] != r_s[:-1], True))[0]
        src = order[last]
        wr = r_s[last]
        wu = uuids[src]
        win = wu > store.tns.uuid[wr]
        if not win.any():
            return
        w_rows = wr[win]
        w_src = src[win]
        store.tns.uuid[w_rows] = wu[win]
        store.tns.cnt[w_rows] = cnts[w_src]
        # winners grouped per pool class, one scatter each; the host
        # payload entries stay stale until flush (the stamps above are
        # what later merge decisions read)
        classes: dict = {}
        for r, s_i in zip(w_rows.tolist(), w_src.tolist()):
            meta = metas[int(kids[s_i])]
            ent = classes.setdefault((meta.dtype_code, meta.elems),
                                     (meta, [], []))
            ent[1].append(r)
            ent[2].append(b.tns_payload[int(keep[s_i])])
        for meta, rws, mats in classes.values():
            pool = self._tns_pool(meta)
            self._tns_scatter(pool, self._tns_slots(pool, rws), mats,
                              dirty=True)
        self.needs_flush = True
        if self._tns_bytes > self.tns_pool_cap:
            # residency cap: sync the dirty payloads down and release the
            # pools (they refill lazily)
            log.info("tensor pools over CONSTDB_TORCH_TENSOR_POOL_MB; "
                     "flushing and dropping %d pools (%d bytes)",
                     len(self._tns_pools), self._tns_bytes)
            self._flush_tns(store)
            self._drop_tns_pools()

    def _resolve_tns_rows(self, store: KeySpace, kids: np.ndarray,
                          nodes: np.ndarray) -> np.ndarray:
        """(kid, node) -> store tensor slot rows, creating neutral slots
        for misses (the batched twin of KeySpace.tensor_slot_row)."""
        ranks = np.fromiter((store.rank_of(int(x)) for x in nodes),
                            dtype=_I64, count=len(nodes))
        combos = (kids << KeySpace.NODE_RANK_BITS) | ranks
        rn0 = store.tns.n
        rows, n_new = store.tns_index.get_or_assign_batch(combos,
                                                          next_val=rn0)
        if n_new:
            created = np.nonzero(rows >= rn0)[0]
            uniq_rows, first = np.unique(rows[created], return_index=True)
            pos = created[first]
            if len(uniq_rows) != n_new or int(uniq_rows[0]) != rn0 or \
                    int(uniq_rows[-1]) != rn0 + n_new - 1:
                span = f"[{int(uniq_rows[0])}, {int(uniq_rows[-1])}]" \
                    if len(uniq_rows) else "[]"
                raise RuntimeError(
                    f"tns combo index issued non-contiguous rows {span} "
                    f"(n={len(uniq_rows)}) for block "
                    f"[{rn0}, {rn0 + n_new - 1}]")
            store.tns.append_block(n_new, kid=kids[pos], node=nodes[pos],
                                   uuid=K.NEUTRAL_T, cnt=0)
            store.tns_payload.extend([None] * n_new)
        return rows

    def _flush_tns(self, store: KeySpace) -> None:
        """Download the dirty pool slots into the host payload list: the
        tensor half of the dirty-row flush."""
        for pool in self._tns_pools.values():
            dirty = pool["dirty"]
            if not dirty:
                continue
            slots = np.fromiter(dirty, dtype=_I64, count=len(dirty))
            slots.sort()
            self.flush_rows_full_equiv += pool["n"]
            self.flush_rows_downloaded += len(slots)
            got = self._get(B.gather_rows(pool["buf"],
                                          self._h2d(slots.astype(_I32))))
            rows = pool["rows"]
            for j, slot in enumerate(slots.tolist()):
                store.tensor_assign_payload(int(rows[slot]), got[j].copy())
            pool["dirty"] = set()

    def tensor_read_many(self, store: KeySpace, kids) -> dict:
        """Batched tensor reads: {kid: flat payload array, or None when no
        contribution landed}.  With the steady path on, contributor stacks
        reduce ON THE CARD, one K5 launch per group (avg included; lww
        picks its winner from the host stamps), and only the [G, elems]
        results download; dirty payloads never
        round-trip through the host.  Otherwise the host reference
        (KeySpace.tensor_read).

        The grouping and upload pass (contributor enumeration, pool-slot
        resolution, staging of rows not yet pooled, the device idx vector)
        is cached between calls: membership and canonical order change
        only when slot rows are created, pool slots only when the pools
        drop, and the cache stamp covers both."""
        from ..crdt import tensor as T
        if not (self.resident and self.steady):
            return {kid: store.tensor_read(kid) for kid in kids}
        self._tns_check(store)
        kids_t = tuple(kids)
        stamp = (self._tns_epoch, self._tns_ver, store.tns.n)
        rc = self._tns_read_cache
        if rc.get("stamp") != stamp:
            rc = self._tns_read_cache = {"stamp": stamp, "by_kids": {}}
        cache = rc["by_kids"].get(kids_t)
        if cache is None:
            if len(rc["by_kids"]) >= 8192:  # bound a huge-keyspace scan
                rc["by_kids"].clear()
            cache = self._tns_read_build(store, kids_t)
            rc["by_kids"][kids_t] = cache
        out = dict(cache["empty"])
        for grp in cache["groups"]:
            (strat, n, g, members, pool, idx_dev, flat_rows,
             rows_mat, nodes_mat, slots_mat) = grp
            buf = pool["buf"]
            if strat == T.STRAT_LWW:
                # winner from the host-authoritative stamps: max uuid per
                # key, the writer node breaking exact ties; the payload
                # comes from the pool (the dirty row's truth)
                u = store.tns.uuid[rows_mat]
                cand = u == u.max(axis=1, keepdims=True)
                w = np.where(cand, nodes_mat,
                             np.int64(-1) << 62).argmax(axis=1)
                idx = slots_mat[np.arange(g), w].astype(_I32)
                got = self._get(B.gather_rows(buf, self._h2d(idx)))
            else:
                # trimmed-mean divisor as a runtime value of the payload
                # dtype
                div = pool["dtype"].type(n if n <= 2 else n - 2)
                w = tot = None
                if strat == T.STRAT_AVG:
                    # K5 fuses avg: each product with its count weight
                    # rounds, the products sum in order and divide by the
                    # count totals, which accumulate on the host with the
                    # canonical sequential dtype chain; weights and totals
                    # go up in one copy
                    cnts_f = store.tns.cnt[flat_rows].astype(pool["dtype"])
                    tot_h = cnts_f[0::n].copy()
                    for i in range(1, n):
                        tot_h = tot_h + cnts_f[i::n]
                    wt = self._h2d(np.concatenate([cnts_f, tot_h]))
                    w, tot = wt[:g * n], wt[g * n:]
                red = KN.tensor_take_reduce(buf, idx_dev, div, strat=strat,
                                            n=n, g=g, w=w, tot=tot)
                got = self._get(red)
            for j, kid in enumerate(members):
                out[kid] = got[j]
        return out

    def _tns_read_build(self, store: KeySpace, kids_t: tuple) -> dict:
        """Build the cached read-group structure for one key set:
        contributor rows in canonical order per key, grouped by (dtype,
        elems, strategy, n); rows not yet pooled upload as clean mirrors;
        the flat pool-slot idx vector goes to the device once."""
        from ..crdt import tensor as T
        raw: dict = {}
        empty: dict = {}
        for kid in kids_t:
            meta = store.tns_meta.get(kid)
            rows = store.tensor_contrib_rows(kid)
            if meta is None or not rows:
                empty[kid] = None
                continue
            raw.setdefault((meta.dtype_code, meta.elems, meta.strat,
                            len(rows)), []).append((kid, meta, rows))
        groups = []
        for (_dcode, _elems, strat, n), mem in raw.items():
            pool = self._tns_pool(mem[0][1])
            flat = np.fromiter((r for _k, _m, rows in mem for r in rows),
                               dtype=_I64, count=len(mem) * n)
            missing = [r for r in dict.fromkeys(flat.tolist())
                       if r not in pool["map"]]
            if missing:
                mats = [store.tns_payload[r] for r in missing]
                self._tns_scatter(pool, self._tns_slots(pool, missing), mats,
                                  dirty=False)
            g = len(mem)
            m = pool["map"]
            slots_mat = np.fromiter((m[r] for r in flat.tolist()),
                                    dtype=_I64, count=g * n).reshape(g, n)
            groups.append((strat, n, g, [kid for kid, _m2, _r in mem], pool,
                           self._h2d(slots_mat.reshape(-1).astype(_I32)),
                           flat, flat.reshape(g, n),
                           store.tns.node[flat.reshape(g, n)], slots_mat))
        return {"empty": empty, "groups": groups}

    def _resolve_keys(self, store: KeySpace, batch: ColumnarBatch,
                      st: MergeStats) -> np.ndarray:
        """batch key position -> local kid (-1 on type conflict), shared
        with the host path (engine/hostbatch.py resolve_keys)."""
        from .hostbatch import resolve_keys
        return resolve_keys(store, batch, st, resident=self.resident)

    # --------------------------------------------------- bulk-path plumbing

    def _use_bulk(self, total_rows: int, region: int) -> bool:
        if not self._unique_ok:
            return False
        if self.resident or self._devs is not None:
            # resident: no state upload to amortize, bulk always wins;
            # range partitions: bulk is the partitioned path
            return True
        return region > 0 and total_rows * self.BULK_FRACTION >= region

    @staticmethod
    def _bulk_region(staged_rows: list[np.ndarray], n0: int, n: int
                     ) -> tuple[int, int, bool]:
        """-> (base, size, all_new): the slot region the passes operate on.
        When every staged row is brand new (>= n0) only the new block
        [n0, n) participates, and its neutral state is made on device."""
        lo = min(int(r.min()) for r in staged_rows if len(r))
        if lo >= n0:
            return n0, n - n0, True
        return 0, n, False

    def _upload_batch(self, rows: np.ndarray, base: int, sp: int,
                      cols: list[tuple[np.ndarray, int]], device=None):
        """Upload one batch: int32 ids (padded with distinct out-of-range
        slots) + padded value columns."""
        n = len(rows)
        np_ = K.next_pow2(max(n, 1))
        return [self._batch_idx(rows, base, sp, np_, device)] + \
            [self._h2d(_pad(c, np_, fill), device) for c, fill in cols]

    def _iota_r0(self, rows: np.ndarray, base: int):
        """Device-relative start when `rows` is one long contiguous run
        (the catch-up shape), else None."""
        n = len(rows)
        if n < self.IDX_IOTA_MIN:
            return None
        r0 = int(rows[0])
        if int(rows[n - 1]) - r0 + 1 != n or not (np.diff(rows) == 1).all():
            return None
        return r0 - base

    def _bulk_src_call(self, fn, fn_iota, states, rows, base: int, sp: int,
                       cols, pb):
        """One src-tracking pass: contiguous rows take the iota variant
        (no index upload, no pad mask); anything else uploads an idx.
        Over range partitions each partition holding rows runs `fn` on
        its slice (pool ids pb + the slice's first position onward) with
        an idx, which may still be derived on the device; the fused iota
        variants are single-device, as on the reference's mesh."""
        if self._devs is not None:
            for k, sl, b, p, dev in self._each_part(rows, base, sp):
                n = sl.stop - sl.start
                np_ = K.next_pow2(n)
                fn(*(st[k] for st in states),
                   self._batch_idx(rows[sl], b, p, np_, dev),
                   *(self._h2d(_pad(c[sl], np_, fill), dev)
                     for c, fill in cols), np.int32(pb + sl.start))
            return states
        n = len(rows)
        np_ = K.next_pow2(max(n, 1))
        dev = [self._h2d(_pad(c, np_, fill)) for c, fill in cols]
        r0 = self._iota_r0(rows, base)
        if r0 is not None:
            return fn_iota(*states, r0, n, *dev, pb, np_=np_)
        idx = self._batch_idx(rows, base, sp, np_)
        return fn(*states, idx, *dev, pb)

    def _batch_idx(self, rows: np.ndarray, base: int, sp: int, np_: int,
                   device=None):
        n = len(rows)
        r0 = self._iota_r0(rows, base)
        if r0 is not None:
            return B.idx_iota(r0, n, np_, sp,
                              self.device if device is None else device)
        idx = np.empty(np_, dtype=_I32)
        idx[:n] = rows - base
        if np_ > n:
            idx[n:] = sp + np.arange(np_ - n, dtype=_I32)
        return self._h2d(idx, device)

    def _state_up(self, col: np.ndarray, base: int, size: int, sp: int,
                  fill: int, all_new: bool):
        if all_new:
            return self._full_plane(sp, fill)
        return self._put_plane(_pad(col[base:base + size], sp, fill))

    @staticmethod
    def _i32_up(arr: np.ndarray, fill64: int):
        """Opportunistic int32 upload spec: halves the bytes whenever the
        column's values fit; the ops promote against the int64 state."""
        arr = np.asarray(arr)
        if len(arr) and -(1 << 31) <= int(arr.min()) and \
                int(arr.max()) < (1 << 31):
            return (arr.astype(np.int32), -1)
        return (arr, fill64)

    def _seg_call(self, fn, *arrays, n_slots: int):
        """Run one ops/segment.py reduction on device over host arrays and
        download its outputs."""
        out = fn(*(self._h2d(a) for a in arrays), n_slots)
        return [self._get(t) for t in out]

    # ---------------------------------------------------- aligned-batch fold
    # R batches staging the exact same slot rows reduce on-device in one
    # [R, N] pass, then write ONCE.

    def _fold_prep(self, staged, base: int, sp: int):
        """Common fold staging: (rows0, nA, np_, device idx)."""
        rows0 = staged[0][0]
        nA = len(rows0)
        np_ = K.next_pow2(max(nA, 1))
        self.folds += 1
        return rows0, nA, np_, self._batch_idx(rows0, base, sp, np_)

    @staticmethod
    def _stacked(staged, i: int, fill, np_: int) -> np.ndarray:
        return np.stack([_pad(s[i], np_, fill) for s in staged])

    # ------------------------------------------------------------ envelopes

    def _stage_envelopes(self, store: KeySpace, resolved, st):
        """STAGE (host-only): columnarize + group-combine the envelope
        plane as [n, 4] ct/mt/dt/expire matrices and make the placement
        decision, pre-building every host array the dispatch uploads."""
        staged = []  # (pos, [n, 4] matrix)
        for b, kid_of in resolved:
            valid = np.nonzero(kid_of >= 0)[0]
            if not len(valid):
                continue
            if len(valid) == len(kid_of):
                staged.append((kid_of, np.stack(
                    [b.key_ct, b.key_mt, b.key_dt, b.key_expire], axis=-1)))
            else:
                staged.append((kid_of[valid], np.stack(
                    [b.key_ct[valid], b.key_mt[valid], b.key_dt[valid],
                     b.key_expire[valid]], axis=-1)))
        if not staged:
            return None
        staged, folds = self._combine_groups(
            staged,
            lambda st_: (st_[0][0], np.maximum.reduce([s[1] for s in st_])),
            lambda st_, cat: (cat, np.concatenate([s[1] for s in st_])))
        if self._devs is not None:
            staged = [_row_sorted(e) for e in staged]
        plan = {"staged": staged, "folds": folds}
        if self.resident and self._host_combine() and self._unique_ok:
            plan["mode"] = "host"
            return plan
        total = sum(len(p) for p, _ in staged)
        n = store.keys.n
        base, size, all_new = self._bulk_region([p for p, _ in staged],
                                                self._n0_keys, n)
        if not self._use_bulk(total, size):
            plan["mode"] = "scatter"
            return plan
        plan["mode"] = "bulk"
        plan.update(n=n, base=base, size=size, all_new=all_new)
        plan["fold"] = self._fold_on and _rows_aligned(staged)
        if plan["fold"]:
            np_ = K.next_pow2(max(len(staged[0][0]), 1))
            plan["stack"] = np.stack([_pad(m, np_, 0) for _, m in staged])
        if not self.resident and not all_new:
            sp = self._sp_size(size)
            host = np.stack([store.keys.ct[base:n], store.keys.mt[base:n],
                             store.keys.dt[base:n],
                             store.keys.expire[base:n]], axis=-1)
            plan["state_host"] = _pad(host, sp, 0)
        return plan

    def _dispatch_envelopes(self, store: KeySpace, plan, st) -> None:
        if plan is None:
            return
        staged = plan["staged"]
        self.folds += plan["folds"]
        if plan["mode"] == "host":
            # plain per-column max straight into the host columns (rows
            # are unique per staged entry): the [N, 4] plane never
            # crosses the link
            self._drop_family(store, "env")
            keys = store.keys
            for pos, m in staged:
                for i, (name, _) in enumerate(_FAMILIES["env"]):
                    col = keys.col(name)
                    cur = col[pos]
                    np.maximum(cur, m[:, i], out=cur)
                    col[pos] = cur
            return

        if plan["mode"] == "bulk":
            n, base = plan["n"], plan["base"]
            size, all_new = plan["size"], plan["all_new"]
            if self.resident:
                cols, sp = self._resident_state(store, "env", n)
                state = cols["stack"]
                base = 0
            else:
                sp = self._sp_size(size)
                if all_new:
                    state = self._full_plane(sp, 0, cols=4)
                else:
                    state = self._put_plane(plan["state_host"])
            if self._devs is not None:
                self._env_parts(plan, state, base, sp)
            elif plan["fold"]:
                # plain max: one stacked reduction, one write
                _rows0, _nA, _np, idx = self._fold_prep(staged, base, sp)
                state = B.bulk_max(state, idx,
                                   D.dense_max(self._h2d(plan["stack"])))
            else:
                dev = [self._upload_batch(p, base, sp, [(m, 0)])
                       for p, m in staged]
                for idx, c in dev:
                    state = B.bulk_max(state, idx, c)
            if self.resident:
                self._family_done("env", {"stack": state}, n, sp)
                return
            out = self._get_plane(state, size)
            store.keys.ct[base:n] = out[:, 0]
            store.keys.mt[base:n] = out[:, 1]
            store.keys.dt[base:n] = out[:, 2]
            store.keys.expire[base:n] = out[:, 3]
            return
        # scatter path over touched slots (store gathers stay HERE:
        # _drop_family may flush a resident mirror into these columns)
        self._drop_family(store, "env")
        kv = np.concatenate([p for p, _ in staged])
        cat = np.concatenate([m for _, m in staged])
        trows, slot_idx = np.unique(kv, return_inverse=True)
        n_slots = K.next_pow2(len(trows) + 1)
        n_rows = K.next_pow2(len(kv))
        out = self._seg_call(
            K.scatter_max4,
            _pad(slot_idx.astype(_I64), n_rows, n_slots - 1),
            _pad(cat[:, 0], n_rows, K.NEUTRAL_T),
            _pad(cat[:, 1], n_rows, K.NEUTRAL_T),
            _pad(cat[:, 2], n_rows, K.NEUTRAL_T),
            _pad(cat[:, 3], n_rows, K.NEUTRAL_T),
            _pad(store.keys.ct[trows], n_slots, 0),
            _pad(store.keys.mt[trows], n_slots, 0),
            _pad(store.keys.dt[trows], n_slots, 0),
            _pad(store.keys.expire[trows], n_slots, 0),
            n_slots=n_slots)
        ct, mt, dt, exp = (a[: len(trows)] for a in out)
        store.keys.ct[trows] = ct
        store.keys.mt[trows] = mt
        store.keys.dt[trows] = dt
        store.keys.expire[trows] = exp

    def _env_parts(self, plan, state: list, base: int, sp: int) -> None:
        """The envelope bulk merge over range partitions: per partition
        holding rows, the aligned fold's max (or each batch) into its
        slice of the [Sp, 4] plane."""
        staged = plan["staged"]
        if plan["fold"]:
            rows0 = staged[0][0]
            self.folds += 1
            for k, sl, b, p, dev in self._each_part(rows0, base, sp):
                np_ = K.next_pow2(sl.stop - sl.start)
                B.bulk_max(state[k],
                           self._batch_idx(rows0[sl], b, p, np_, dev),
                           D.dense_max(self._h2d(
                               _pad_cols(plan["stack"][:, sl], np_, 0),
                               dev)))
            return
        for pos, m in staged:
            for k, sl, b, p, dev in self._each_part(pos, base, sp):
                idx, c = self._upload_batch(pos[sl], b, p, [(m[sl], 0)], dev)
                B.bulk_max(state[k], idx, c)

    def _lww_parts(self, t: list, nd: list, rows, bt, bn, base: int,
                   sp: int) -> np.ndarray:
        """bulk_lww of one batch over range partitions -> its host win
        flags, in batch order."""
        win = np.zeros(len(rows), dtype=bool)
        for k, sl, b, p, dev in self._each_part(rows, base, sp):
            idx, bt_d, bn_d = self._upload_batch(
                rows[sl], b, p, [(bt[sl], K.NEUTRAL_T),
                                 (bn[sl], K.NEUTRAL_T)], dev)
            w = B.bulk_lww(t[k], nd[k], idx, bt_d, bn_d)[2]
            win[sl] = self._get(w)[:sl.stop - sl.start]
        return win

    # ------------------------------------------------------------ registers

    def _stage_registers(self, store: KeySpace, resolved, st):
        """STAGE (host-only): select + columnarize register writes, then
        group-combine.  The eligibility mask is memoized per shared
        (kid_of, key_enc) object pair."""
        from ..utils.tables import nonnull_mask
        staged = []  # (pos=kids, t, node, vals)
        emask_memo: dict = {}
        for b, kid_of in resolved:
            if not b.n_keys:
                continue
            mk = (id(kid_of), id(b.key_enc))
            em = emask_memo.get(mk)
            if em is None:
                em = (kid_of >= 0) & (b.key_enc == S.ENC_BYTES)
                emask_memo[mk] = em
            has = nonnull_mask(b.reg_val)
            idx = np.nonzero(em & has)[0]
            if len(idx):
                staged.append((kid_of[idx], b.reg_t[idx], b.reg_node[idx],
                               list(map(b.reg_val.__getitem__,
                                        idx.tolist()))))
        if not staged:
            return None

        def _fold_reg(st_):
            t_f, n_f, wb = _lex_fold([s[1] for s in st_],
                                     [s[2] for s in st_])
            return (st_[0][0], t_f, n_f,
                    list(_sel_obj([s[3] for s in st_], wb)))

        def _cat_reg(st_, cat):
            vals_cat: list = []
            for s in st_:
                vals_cat.extend(s[3])
            return (cat, np.concatenate([s[1] for s in st_]),
                    np.concatenate([s[2] for s in st_]), vals_cat)

        staged, folds = self._combine_groups(staged, _fold_reg, _cat_reg)
        if self._devs is not None:
            staged = [_row_sorted(e) for e in staged]
        plan = {"staged": staged, "folds": folds}
        total = sum(len(p) for p, *_ in staged)
        n = store.keys.n
        base, size, all_new = self._bulk_region([p for p, *_ in staged],
                                                self._n0_keys, n)
        plan.update(n=n, base=base, size=size, all_new=all_new,
                    use_bulk=self._use_bulk(total, size), fold=False)
        if plan["use_bulk"] and not (self.resident and self._host_combine()):
            plan["fold"] = self._fold_on and _rows_aligned(staged)
        return plan

    def _dispatch_registers(self, store: KeySpace, plan, st) -> None:
        if plan is None:
            return
        staged = plan["staged"]
        self.folds += plan["folds"]
        n, base = plan["n"], plan["base"]
        size, all_new = plan["size"], plan["all_new"]

        if plan["use_bulk"]:
            if self.resident:
                cols, sp = self._resident_state(store, "reg", n)
                t, nd = cols["rv_t"], cols["rv_node"]
                base = 0
            else:
                sp = self._sp_size(size)
                t = self._state_up(store.keys.rv_t, base, size, sp, 0, all_new)
                nd = self._state_up(store.keys.rv_node, base, size, sp, 0,
                                    all_new)
            if self.resident and self._host_combine():
                # deferred win resolution: the winning row's pool id lands
                # in the resident src plane, and at flush both the values
                # and the rv_t/rv_node columns reconstruct from the pool
                src = self._src_state("reg", sp)
                for p, bt_, bn_, vals in staged:
                    pb = self._pool_add(vals, rv_t=bt_, rv_node=bn_)
                    t, nd, src = self._bulk_src_call(
                        B.bulk_lww_src, B.bulk_lww_src_iota, (t, nd, src),
                        p, base, sp, [(bt_, K.NEUTRAL_T),
                                      self._i32_up(bn_, K.NEUTRAL_T)], pb)
                self._family_done("reg", {"rv_t": t, "rv_node": nd}, n, sp,
                                  src=src,
                                  recon={"rv_t": "rv_t",
                                         "rv_node": "rv_node"})
                return
            fold = plan["fold"]
            if fold:
                # one K1 launch folds the stacks and applies the winners
                # to (t, nd) in place (one per partition holding rows)
                rows0 = staged[0][0]
                self.folds += 1
                stacks = [[s[i] for s in staged] for i in (1, 2)]
                if self._devs is not None:
                    winb = self._fold_apply_parts(stacks, rows0, base, sp,
                                                  (t, nd))
                else:
                    winb = self._fold_apply(
                        stacks, (rows0 - base).astype(_I32), (t, nd))
            elif self._devs is not None:
                wins = [self._lww_parts(t, nd, p, bt, bn, base, sp)
                        for p, bt, bn, _ in staged]
            else:
                dev = [self._upload_batch(p, base, sp,
                                          [(bt, K.NEUTRAL_T),
                                           (bn, K.NEUTRAL_T)])
                       for p, bt, bn, _ in staged]
                wins = []
                for idx, bt, bn in dev:
                    t, nd, win = B.bulk_lww(t, nd, idx, bt, bn)
                    wins.append(win)
            if self.resident:
                self._family_done("reg", {"rv_t": t, "rv_node": nd}, n, sp)
            else:
                store.keys.rv_t[base:n] = self._get_plane(t, size)
                store.keys.rv_node[base:n] = self._get_plane(nd, size)
            reg_val = store.reg_val
            if fold:
                for j in np.nonzero(winb >= 0)[0]:
                    reg_val[int(rows0[j])] = staged[int(winb[j])][3][int(j)]
                return
            for (pos, _, _, vals), win in zip(staged, wins):
                win_h = win if isinstance(win, np.ndarray) \
                    else self._get(win)[: len(pos)]
                for j in np.nonzero(win_h)[0]:
                    reg_val[int(pos[j])] = vals[int(j)]
            return
        # scatter path: registers are LWW slots, the element add-side
        # reduction with a zero del side
        self._drop_family(store, "reg")
        kids = np.concatenate([p for p, *_ in staged])
        vals: list = []
        for _, _, _, v in staged:
            vals.extend(v)
        trows, slot_idx = np.unique(kids, return_inverse=True)
        n_slots = K.next_pow2(len(trows) + 1)
        n_rows = K.next_pow2(len(kids))
        out = self._seg_call(
            K.merge_elems,
            _pad(slot_idx.astype(_I64), n_rows, n_slots - 1),
            _pad(np.concatenate([t for _, t, _, _ in staged]), n_rows,
                 K.NEUTRAL_T),
            _pad(np.concatenate([n_ for _, _, n_, _ in staged]), n_rows,
                 K.NEUTRAL_T),
            np.zeros(n_rows, dtype=_I64),
            _pad(store.keys.rv_t[trows], n_slots, 0),
            _pad(store.keys.rv_node[trows], n_slots, 0),
            np.zeros(n_slots, dtype=_I64),
            n_slots=n_slots)
        t, node, _dt, win_row = (a[: len(trows)] for a in out)
        store.keys.rv_t[trows] = t
        store.keys.rv_node[trows] = node
        reg_val = store.reg_val
        for di in np.nonzero(win_row >= 0)[0]:
            reg_val[int(trows[di])] = vals[int(win_row[di])]

    # ------------------------------------------------------------- counters

    def _stage_counter_rows(self, store: KeySpace, resolved, st):
        """STAGE (appends missing slot rows to the cnt plane itself via
        _resolve_cnt_rows; host-only otherwise): columnarize + combine
        counter slot writes."""
        n0 = store.cnt.n
        staged = []  # (rows, total, uuid, base, base_t)
        for b, kid_of in resolved:
            if not len(b.cnt_ki):
                continue
            kid_arr = kid_of[b.cnt_ki]
            keep = np.nonzero(kid_arr >= 0)[0]
            if not len(keep):
                continue
            st.counter_rows += len(keep)
            sel = slice(None) if len(keep) == len(kid_arr) else keep
            rows = self._resolve_cnt_rows(store, kid_arr[sel],
                                          b.cnt_node[sel])
            staged.append((rows, b.cnt_val[sel], b.cnt_uuid[sel],
                           b.cnt_base[sel], b.cnt_base_t[sel]))
        if not staged:
            return None

        def _fold_cnt(st_):
            # both (value @ time) pairs fold independently on host
            f_uuid, f_val, _ = _lex_fold([s[2] for s in st_],
                                         [s[1] for s in st_])
            f_bt, f_base, _ = _lex_fold([s[4] for s in st_],
                                        [s[3] for s in st_])
            return (st_[0][0], f_val, f_uuid, f_base, f_bt)

        staged, folds = self._combine_groups(
            staged, _fold_cnt,
            lambda st_, cat: (cat,) + tuple(
                np.concatenate([s[i] for s in st_]) for i in range(1, 5)))
        if self._devs is not None:
            staged = [_row_sorted(e) for e in staged]
        plan = {"staged": staged, "folds": folds, "n0": n0}
        total = sum(len(r) for r, *_ in staged)
        n = store.cnt.n
        base, size, all_new = self._bulk_region([r for r, *_ in staged],
                                                n0, n)
        plan.update(n=n, base=base, size=size, all_new=all_new,
                    use_bulk=self._use_bulk(total, size), fold=False)
        if plan["use_bulk"] and not (self.resident and self._host_combine()):
            plan["fold"] = self._fold_on and _rows_aligned(staged)
            if plan["fold"]:
                np_ = K.next_pow2(max(len(staged[0][0]), 1))
                plan["v_s"] = self._stacked(staged, 1, 0, np_)
                plan["u_s"] = self._stacked(staged, 2, K.NEUTRAL_T, np_)
                plan["b_s"] = self._stacked(staged, 3, 0, np_)
                plan["bt_s"] = self._stacked(staged, 4, K.NEUTRAL_T, np_)
        return plan

    def _dispatch_counter_rows(self, store: KeySpace, plan, st) -> None:
        if plan is None:
            return
        staged = plan["staged"]
        self.folds += plan["folds"]
        n, base = plan["n"], plan["base"]
        size, all_new = plan["size"], plan["all_new"]

        if plan["use_bulk"]:
            if self.resident:
                cols, sp = self._resident_state(store, "cnt", n)
                val, uuid = cols["val"], cols["uuid"]
                cb, cbt = cols["base"], cols["base_t"]
                base = 0
            else:
                sp = self._sp_size(size)
                val = self._state_up(store.cnt.val, base, size, sp, 0, all_new)
                uuid = self._state_up(store.cnt.uuid, base, size, sp,
                                      K.NEUTRAL_T, all_new)
                cb = self._state_up(store.cnt.base, base, size, sp, 0, all_new)
                cbt = self._state_up(store.cnt.base_t, base, size, sp,
                                     K.NEUTRAL_T, all_new)
            if self.resident and self._host_combine():
                # deferred win resolution on the val/uuid pair; the rare
                # base pair keeps its winner on device and downloads when
                # written
                src = self._src_state("cnt", sp)
                written = {"val", "uuid"}
                for r, v, u, bb, bt in staged:
                    pb = self._pool_add(None, val=v, uuid=u)
                    if (bt == K.NEUTRAL_T).all():
                        val, uuid, src = self._bulk_src_call(
                            B.bulk_counters_vu_src,
                            B.bulk_counters_vu_src_iota, (val, uuid, src),
                            r, base, sp, [self._i32_up(v, 0),
                                          (u, K.NEUTRAL_T)], pb)
                    elif self._devs is not None:
                        for k, sl, b, p, dev in self._each_part(r, base, sp):
                            B.bulk_counters_src(
                                val[k], uuid[k], cb[k], cbt[k], src[k],
                                *self._upload_batch(
                                    r[sl], b, p,
                                    [(v[sl], 0), (u[sl], K.NEUTRAL_T),
                                     (bb[sl], 0), (bt[sl], K.NEUTRAL_T)],
                                    dev), np.int32(pb + sl.start))
                        written |= {"base", "base_t"}
                    else:
                        idx, dv, du, dbb, dbt = self._upload_batch(
                            r, base, sp, [(v, 0), (u, K.NEUTRAL_T), (bb, 0),
                                          (bt, K.NEUTRAL_T)])
                        val, uuid, cb, cbt, src = B.bulk_counters_src(
                            val, uuid, cb, cbt, src, idx, dv, du, dbb, dbt,
                            pb)
                        written |= {"base", "base_t"}
                self._family_done("cnt", {"val": val, "uuid": uuid,
                                          "base": cb, "base_t": cbt}, n, sp,
                                  src=src, written=written,
                                  recon={"val": "val", "uuid": "uuid"})
                return
            if self._devs is not None:
                self._counter_parts(plan, (val, uuid, cb, cbt), base, sp)
            elif plan["fold"]:
                # aligned counter rows (the same (key, node) slots in
                # every batch): fold both (value @ time) pairs with K2,
                # write once
                _rows0, _nA, _np, idx = self._fold_prep(staged, base, sp)
                fv, fu = self._fold_pair(plan["v_s"], plan["u_s"])
                fb, fbt = self._fold_pair(plan["b_s"], plan["bt_s"])
                val, uuid, cb, cbt = B.bulk_counters(val, uuid, cb, cbt,
                                                     idx, fv, fu, fb, fbt)
            else:
                dev = []  # [(uploaded arrays, with_base)]
                for r, v, u, bb, bt in staged:
                    if self.resident and (bt == K.NEUTRAL_T).all():
                        dev.append((self._upload_batch(
                            r, base, sp, [(v, 0), (u, K.NEUTRAL_T)]), False))
                    else:
                        dev.append((self._upload_batch(
                            r, base, sp, [(v, 0), (u, K.NEUTRAL_T), (bb, 0),
                                          (bt, K.NEUTRAL_T)]), True))
                for up, with_base in dev:
                    if with_base:
                        idx, v, u, bb, bt = up
                        val, uuid, cb, cbt = B.bulk_counters(
                            val, uuid, cb, cbt, idx, v, u, bb, bt)
                    else:
                        idx, v, u = up
                        val, uuid = B.bulk_counters_vu(val, uuid, idx, v, u)
            if self.resident:
                self._family_done("cnt", {"val": val, "uuid": uuid,
                                          "base": cb, "base_t": cbt}, n, sp)
                return
            store.cnt.val[base:n] = self._get_plane(val, size)
            store.cnt.uuid[base:n] = self._get_plane(uuid, size)
            store.cnt.base[base:n] = self._get_plane(cb, size)
            store.cnt.base_t[base:n] = self._get_plane(cbt, size)
            return  # sums re-derived in one pass by merge_many

        self._drop_family(store, "cnt")
        all_rows = np.concatenate([s[0] for s in staged])
        trows, slot_idx = np.unique(all_rows, return_inverse=True)
        n_slots = K.next_pow2(len(trows) + 1)
        n_rows = K.next_pow2(len(all_rows))
        slot_ids = _pad(slot_idx.astype(_I64), n_rows, n_slots - 1)
        for vcol, tcol, vi, ti in (("val", "uuid", 1, 2),
                                   ("base", "base_t", 3, 4)):
            new_val, new_t = (a[: len(trows)] for a in self._seg_call(
                K.merge_counters,
                slot_ids,
                _pad(np.concatenate([s[vi] for s in staged]), n_rows, 0),
                _pad(np.concatenate([s[ti] for s in staged]), n_rows,
                     K.NEUTRAL_T),
                _pad(store.cnt.col(vcol)[trows], n_slots, 0),
                _pad(store.cnt.col(tcol)[trows], n_slots, K.NEUTRAL_T),
                n_slots=n_slots))
            store.cnt.col(vcol)[trows] = new_val
            store.cnt.col(tcol)[trows] = new_t
        if self.resident:
            # merge_many's sum pass is skipped while other families hold
            # unflushed device state; this path already wrote the host
            store.recompute_counter_sums()

    def _counter_parts(self, plan, state: tuple, base: int, sp: int) -> None:
        """The counter bulk merge over range partitions (the src-free
        branches): per partition holding rows, the aligned fold's two K2
        launches on its slice of the stacks and one bulk_counters, or
        each batch's bulk_counters(_vu)."""
        staged = plan["staged"]
        if plan["fold"]:
            rows0 = staged[0][0]
            self.folds += 1
            for k, sl, b, p, dev in self._each_part(rows0, base, sp):
                np_ = K.next_pow2(sl.stop - sl.start)
                idx = self._batch_idx(rows0[sl], b, p, np_, dev)
                pair = [self._fold_pair(_pad_cols(plan[vn][:, sl], np_, 0),
                                        _pad_cols(plan[tn][:, sl], np_,
                                                  K.NEUTRAL_T), dev)
                        for vn, tn in (("v_s", "u_s"), ("b_s", "bt_s"))]
                if self._fold_backend() == "cuda":
                    self.partition_launches[k]["merge_counters"] += 2
                B.bulk_counters(*(st[k] for st in state), idx, *pair[0],
                                *pair[1])
            return
        for r, v, u, bb, bt in staged:
            vu_only = self.resident and (bt == K.NEUTRAL_T).all()
            for k, sl, b, p, dev in self._each_part(r, base, sp):
                cols = [(v[sl], 0), (u[sl], K.NEUTRAL_T)]
                if vu_only:
                    B.bulk_counters_vu(state[0][k], state[1][k],
                                       *self._upload_batch(r[sl], b, p, cols,
                                                           dev))
                else:
                    cols += [(bb[sl], 0), (bt[sl], K.NEUTRAL_T)]
                    B.bulk_counters(*(st[k] for st in state),
                                    *self._upload_batch(r[sl], b, p, cols,
                                                        dev))

    def _resolve_cnt_rows(self, store: KeySpace, kids: np.ndarray,
                          nodes: np.ndarray) -> np.ndarray:
        """(kid, node) pairs -> store cnt rows via the per-rank direct
        index, one vectorized lookup per distinct origin node, with missing
        slots bulk-created as neutral (val=0, t=NEUTRAL_T)."""
        out = np.empty(len(kids), dtype=_I64)
        if not len(kids):
            return out
        first = int(nodes[0])
        if (nodes == first).all():
            groups = [(first, slice(None))]
        else:
            uniq_nodes, inv = np.unique(nodes, return_inverse=True)
            groups = [(int(nd), np.nonzero(inv == i)[0])
                      for i, nd in enumerate(uniq_nodes.tolist())]
        for node, sel in groups:
            k = kids[sel]
            got = store.cnt_rows_lookup(store.rank_of(node), k)
            miss = got < 0
            if miss.any():
                # a raw op-stream batch may repeat a (kid, node): one row
                # per unique missing kid
                mk = k[miss]
                uk = np.unique(mk)
                new_rows = store.cnt.append_block(
                    len(uk), kid=uk, node=node, val=0,
                    uuid=K.NEUTRAL_T, base=0, base_t=K.NEUTRAL_T)
                store.cnt_rows_assign(store.rank_of(node), uk, new_rows)
                got[miss] = new_rows[np.searchsorted(uk, mk)]
            out[sel] = got
        return out

    # ------------------------------------------------------------- elements

    def _stage_elem_rows(self, store: KeySpace, resolved, st):
        """STAGE (appends missing element rows to the el plane; all other
        work is host prep): resolve (kid, member) combos to rows,
        columnarize, group-combine.  Valueless batches stage vals=None."""
        n0 = store.el.n
        staged = []  # (rows, at, an, dt, vals-or-None, has_vals)
        row_memo: dict = {}
        for b, kid_of in resolved:
            if not len(b.el_ki):
                continue
            mk = (b.el_shape if b.el_shape is not None
                  else ("id", id(b.el_ki), id(b.el_member)), id(kid_of))
            cached = row_memo.get(mk)
            if cached is not None:
                rows, keep, all_kept = cached
                if rows is None:
                    continue  # nothing kept for this shape
                st.elem_rows += len(keep)
            else:
                kid_arr = kid_of[b.el_ki]
                keep = np.nonzero(kid_arr >= 0)[0]
                if not len(keep):
                    row_memo[mk] = (None, None, False)
                    continue
                st.elem_rows += len(keep)
                all_kept = len(keep) == len(b.el_ki)
                members = b.el_member if all_kept \
                    else list(map(b.el_member.__getitem__, keep.tolist()))
                mids, _ = store.member_index.get_or_insert_batch(members)
                combos = (kid_arr[keep] << KeySpace.MEMBER_BITS) | mids
                rn0 = store.el.n
                rows, n_new = store.el_index.get_or_assign_batch(
                    combos, next_val=rn0)
                if n_new:
                    created = np.nonzero(rows >= rn0)[0]
                    uniq_rows, first = np.unique(rows[created],
                                                 return_index=True)
                    pos = created[first]
                    # combo-index ids must be exactly the next el block,
                    # checked BEFORE append_block mutates the plane
                    if len(uniq_rows) != n_new or \
                            int(uniq_rows[0]) != rn0 or \
                            int(uniq_rows[-1]) != rn0 + n_new - 1:
                        span = f"[{int(uniq_rows[0])}, " \
                            f"{int(uniq_rows[-1])}]" \
                            if len(uniq_rows) else "[]"
                        raise RuntimeError(
                            f"el combo index issued non-contiguous rows "
                            f"{span} (n={len(uniq_rows)}) for block "
                            f"[{rn0}, {rn0 + n_new - 1}]")
                    store.el.append_block(
                        n_new, kid=kid_arr[keep][pos],
                        add_t=0, add_node=0, del_t=0)
                    store.el_member.extend(
                        map(members.__getitem__, pos.tolist()))
                    store.el_val.extend([None] * n_new)
                row_memo[mk] = (rows, keep, all_kept)
            # an inherited False hint is exact and skips the value scan
            if b.el_has_vals is False:
                vals, hv = None, False
            else:
                vals = b.el_val if all_kept \
                    else list(map(b.el_val.__getitem__, keep.tolist()))
                hv = has_values(vals)
                if not hv:
                    vals = None
            esel = slice(None) if all_kept else keep
            staged.append((rows, b.el_add_t[esel], b.el_add_node[esel],
                           b.el_del_t[esel], vals, hv))
        if not staged:
            return None

        def _fold_el(st_):
            f_at, f_an, wb = _lex_fold([s[1] for s in st_],
                                       [s[2] for s in st_])
            f_dt = np.maximum.reduce([s[3] for s in st_])
            hv = any(s[5] for s in st_)
            vals = list(_sel_obj([s[4] for s in st_], wb)) if hv else None
            return (st_[0][0], f_at, f_an, f_dt, vals, hv)

        def _cat_el(st_, cat):
            hv = any(s[5] for s in st_)
            if hv:
                vals_cat: list = []
                for s in st_:
                    vals_cat.extend(s[4] if s[4] is not None
                                    else [None] * len(s[0]))
            else:
                vals_cat = None
            return (cat,
                    np.concatenate([s[1] for s in st_]),
                    np.concatenate([s[2] for s in st_]),
                    np.concatenate([s[3] for s in st_]),
                    vals_cat, hv)

        staged, folds = self._combine_groups(staged, _fold_el, _cat_el)
        if self._devs is not None:
            staged = [_row_sorted(e) for e in staged]
        plan = {"staged": staged, "folds": folds, "n0": n0,
                "el_epoch": store.el_compact_epoch}
        total = sum(len(r) for r, *_ in staged)
        n = store.el.n
        base, size, all_new = self._bulk_region([r for r, *_ in staged],
                                                n0, n)
        plan.update(n=n, base=base, size=size, all_new=all_new,
                    use_bulk=self._use_bulk(total, size), fold=False)
        if plan["use_bulk"] and not (self.resident and self._host_combine()):
            plan["fold"] = self._fold_on and _rows_aligned(staged)
        return plan

    def _dispatch_elem_rows(self, store: KeySpace, plan, st) -> None:
        if plan is None:
            return
        # staged element ROW INDICES are valid only while row ids are
        # stable; a compaction in between would alias rows, so fail loudly
        if plan["el_epoch"] != store.el_compact_epoch:
            raise RuntimeError(
                "element rows were compacted between stage and dispatch "
                "(row-id stability broken: staged indices are stale)")
        staged = plan["staged"]
        self.folds += plan["folds"]
        n, base = plan["n"], plan["base"]
        size, all_new = plan["size"], plan["all_new"]

        if plan["use_bulk"]:
            if self.resident:
                cols, sp = self._resident_state(store, "el", n)
                at, an, dt = cols["add_t"], cols["add_node"], cols["del_t"]
                base, size = 0, n
                if self._host_combine():
                    # deferred win resolution; the DEL side never touches
                    # the device here: del-merge is a plain max applied
                    # straight to the host column, and newly-dead rows
                    # queue for GC at flush via _el_del_touched
                    src = self._src_state("el", sp)
                    host_dt = store.el.del_t
                    for rows_, a_, x_, d_, vals, _hv in staged:
                        x_arr = np.asarray(x_)
                        x_up = self._i32_up(x_arr, K.NEUTRAL_T)
                        pb = self._pool_add(vals, add_t=a_, add_node=x_arr)
                        at, an, src = self._bulk_src_call(
                            B.bulk_elems_src_nodt, B.bulk_elems_src_nodt_iota,
                            (at, an, src), rows_, base, sp,
                            [(a_, K.NEUTRAL_T), x_up], pb)
                        d_arr = np.asarray(d_)
                        nz = np.flatnonzero(d_arr)
                        if len(nz):
                            sel = np.asarray(rows_)[nz]
                            cur = host_dt[sel]
                            dv = d_arr[nz]
                            adv = dv > cur
                            if adv.any():
                                host_dt[sel[adv]] = dv[adv]
                                self._el_del_touched.append(sel[adv])
                    self._family_done("el", {"add_t": at, "add_node": an,
                                             "del_t": dt}, n, sp, src=src,
                                      written={"add_t", "add_node"},
                                      recon={"add_t": "add_t",
                                             "add_node": "add_node"})
                    return
            else:
                sp = self._sp_size(size)
                old_dt = (np.zeros(size, dtype=_I64) if all_new
                          else store.el.del_t[base:n].copy())
                at = self._state_up(store.el.add_t, base, size, sp, 0, all_new)
                an = self._state_up(store.el.add_node, base, size, sp, 0,
                                    all_new)
                dt = self._state_up(store.el.del_t, base, size, sp, 0, all_new)
            fold = plan["fold"]
            if fold:
                # one K1 launch folds the stacks and applies the winners
                # to (at, an, dt) in place (one per partition holding rows)
                rows0 = staged[0][0]
                self.folds += 1
                stacks = [[s[i] for s in staged] for i in (1, 2, 3)]
                if self._devs is not None:
                    winb = self._fold_apply_parts(stacks, rows0, base, sp,
                                                  (at, an, dt))
                else:
                    winb = self._fold_apply(
                        stacks, (rows0 - base).astype(_I32), (at, an, dt))
            elif self._devs is not None:
                wins = []
                for r, a, x, d, _, _ in staged:
                    win = np.zeros(len(r), dtype=bool)
                    for k, sl, b, p, dev in self._each_part(r, base, sp):
                        w = B.bulk_elems(at[k], an[k], dt[k],
                                         *self._upload_batch(
                                             r[sl], b, p,
                                             [(a[sl], K.NEUTRAL_T),
                                              (x[sl], K.NEUTRAL_T),
                                              (d[sl], 0)], dev))[3]
                        win[sl] = self._get(w)[:sl.stop - sl.start]
                    wins.append(win)
            else:
                dev = [self._upload_batch(
                    r, base, sp, [(a, K.NEUTRAL_T), (x, K.NEUTRAL_T), (d, 0)])
                    for r, a, x, d, _, _ in staged]
                wins = []
                for idx, a, x, d in dev:
                    at, an, dt, win = B.bulk_elems(at, an, dt, idx, a, x, d)
                    wins.append(win)
            if self.resident:
                self._family_done("el", {"add_t": at, "add_node": an,
                                         "del_t": dt}, n, sp)
            else:
                m_at = self._get_plane(at, size)
                m_dt = self._get_plane(dt, size)
                store.el.add_t[base:n] = m_at
                store.el.add_node[base:n] = self._get_plane(an, size)
                store.el.del_t[base:n] = m_dt
                self._enqueue_elem_garbage(store, np.arange(base, n), m_at,
                                           m_dt, old_dt)
            el_val = store.el_val
            el_kid = store.el.kid
            enc = store.keys.enc
            if fold:
                # CPU parity: the winning row's value (None included)
                # replaces the slot's; values live only on dict kids
                cand = (winb >= 0) & \
                    np.isin(enc[el_kid[rows0]], S.VALUE_ENCS)
                for j in np.nonzero(cand)[0]:
                    sv = staged[int(winb[j])][4]
                    el_val[int(rows0[j])] = None if sv is None \
                        else sv[int(j)]
                return
            for (pos, _, _, _, vals, has_vals), win in zip(staged, wins):
                win_arr = win if isinstance(win, np.ndarray) \
                    else self._get(win)[: len(pos)]
                if has_vals:
                    for j in np.nonzero(win_arr)[0]:
                        el_val[int(pos[j])] = vals[int(j)]
                else:
                    # valueless batch: winning None adds still CLEAR
                    # stored values (CPU parity)
                    cand = win_arr & np.isin(enc[el_kid[pos]], S.VALUE_ENCS)
                    for j in np.nonzero(cand)[0]:
                        el_val[int(pos[j])] = None
            return

        self._drop_family(store, "el")
        all_rows = np.concatenate([r for r, *_ in staged])
        vals_flat: list = []
        for r, _, _, _, v, _ in staged:
            vals_flat.extend(v if v is not None else [None] * len(r))
        trows, slot_idx = np.unique(all_rows, return_inverse=True)
        cur_dt = store.el.del_t[trows].copy()
        n_slots = K.next_pow2(len(trows) + 1)
        n_rows = K.next_pow2(len(all_rows))
        out = self._seg_call(
            K.merge_elems,
            _pad(slot_idx.astype(_I64), n_rows, n_slots - 1),
            _pad(np.concatenate([a for _, a, *_ in staged]), n_rows,
                 K.NEUTRAL_T),
            _pad(np.concatenate([x for _, _, x, *_ in staged]), n_rows,
                 K.NEUTRAL_T),
            _pad(np.concatenate([d for _, _, _, d, _, _ in staged]), n_rows,
                 0),
            _pad(store.el.add_t[trows], n_slots, 0),
            _pad(store.el.add_node[trows], n_slots, 0),
            _pad(cur_dt, n_slots, 0),
            n_slots=n_slots)
        kk = len(trows)
        m_at, m_an, m_dt, win_row = (a[:kk] for a in out)
        store.el.add_t[trows] = m_at
        store.el.add_node[trows] = m_an
        store.el.del_t[trows] = m_dt
        el_val = store.el_val
        for di in np.nonzero(win_row >= 0)[0]:
            el_val[int(trows[di])] = vals_flat[int(win_row[di])]
        self._enqueue_elem_garbage(store, trows, m_at, m_dt, cur_dt)

    @staticmethod
    def _enqueue_elem_garbage(store: KeySpace, rows, at, dt, old_dt) -> None:
        """Queue tombstones whose del_t advanced (one bulk heapify)."""
        newly = np.nonzero((at < dt) & (dt > old_dt))[0]
        if not len(newly):
            return
        rws = np.asarray(rows)[newly]
        kids = store.el.kid[rws].tolist()
        store.enqueue_garbage_bulk(
            np.asarray(dt)[newly].tolist(),
            list(map(store.key_bytes.__getitem__, kids)),
            list(map(store.el_member.__getitem__, rws.tolist())))

