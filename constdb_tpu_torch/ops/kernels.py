"""Hand-written Hopper kernels: build, load and launch.

Five CUDA C++ kernels replace the reference package's Pallas kernels
(constdb_tpu/ops/pallas_dense.py), on the snapshot catch-up path (K1, K2,
K4) and on the steady state (K3, K5):

  * K1 `fold_apply`     (csrc/merge_fold.cu)  <- pallas_dense.merge_elems
                        with the bulk_elems / bulk_lww apply that
                        follows it fused (`merge_elems` and `merge_lww`
                        are its fold-only mode)
  * K2 `merge_counters` (csrc/merge_fold.cu)  <- pallas_dense.merge_counters
  * K3 `scatter_round` (csrc/scatter_pair.cu)
                        <- pallas_dense.scatter_pair_src_split: every
                        in-place scatter of one steady round in one
                        launch (`scatter_pair_src` is its one-segment
                        case)
  * K4 `segment_sum`    (csrc/segment_sum.cu) <- pallas_dense.segment_sum
                        with the engine's `val - base` in front of it
                        fused (`base` optional)
  * K5 `tensor_take_reduce` (csrc/tensor_reduce.cu)
                        <- pallas_dense.tensor_reduce

Build: each source compiles with `nvcc -shared` for sm_90a into its own
shared library with a plain C interface, at first use, under
`constdb_tpu_torch/_build/<hash of sources and flags>/`; all sources
compile in parallel (one nvcc each, utils/build.py, under the build
directory's file lock).  The libraries load with ctypes and
launch on PyTorch's current stream with raw device pointers.  A failed
build or a failed launch raises: nothing falls back.

Each wrapper takes its plain PyTorch version (ops/dense.py, and
ops/bulk.py `fold_apply` for K1 and `scatter_round` for K3) only when the
tensors it was given lie on the CPU.  On CUDA tensors it launches the kernel, counts the
launch in `LAUNCHES`, or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import threading
import time
from pathlib import Path

import torch

from ..utils.build import build_artifacts
from . import bulk as B
from . import dense as D

__all__ = ["LAUNCHES", "SHAPES", "SOURCES", "build", "fold_apply",
           "merge_elems", "merge_lww",
           "merge_counters", "scatter_round", "scatter_pair_src",
           "segment_sum", "tensor_take_reduce", "reset_launches",
           "Segment", "PAIR_SRC", "PAIR", "MAX1", "MAX_SEGMENTS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
# library name -> source file; one nvcc per source
SOURCES = {"merge_fold": "merge_fold.cu", "segment_sum": "segment_sum.cu",
           "scatter_pair": "scatter_pair.cu",
           "tensor_reduce": "tensor_reduce.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launches(); K1 counts
# every launch of its template (fold_apply, merge_elems, merge_lww) and
# K3 its fused round launches, each under its reference name
LAUNCHES = {"merge_elems": 0, "merge_counters": 0, "scatter_pair_src": 0,
            "segment_sum": 0, "tensor_take_reduce": 0}
# [R, S, variant] of each fold_apply (K1) launch and [R, S] of each K2
# launch since the last reset_launches()
SHAPES: dict[str, list] = {"merge_elems": [], "merge_counters": []}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}   # library name -> nvcc's output (ptxas -v)

_P = ctypes.c_void_p
_SIGNATURES = {
    "constdb_fold_apply": [_P, _P, _P, ctypes.c_int, ctypes.c_int64,
                           ctypes.c_int, _P, _P, _P, _P, ctypes.c_int64, _P,
                           _P],
    "constdb_merge_elems": [_P, _P, _P, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_int, _P, _P, _P, _P, _P],
    "constdb_merge_counters": [_P, _P, ctypes.c_int, ctypes.c_int64,
                               ctypes.c_int, _P, _P, _P],
    "constdb_segment_sum": [_P, _P, _P, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int64, _P, _P],
    "constdb_scatter_round": [_P, _P],
    "constdb_tensor_take_reduce": [_P, _P, _P, _P, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_int64,
                                   ctypes.c_double, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, _P, _P],
}

PAIR_SRC, PAIR, MAX1 = B.PAIR_SRC, B.PAIR, B.MAX1
Segment = B.Segment
MAX_SEGMENTS = 8   # csrc/scatter_pair.cu kMaxSegments


class _Seg(ctypes.Structure):
    """csrc/scatter_pair.cu `Segment`, field for field."""
    _fields_ = [("p", _P), ("s", _P), ("src", _P), ("idx", _P), ("bp", _P),
                ("bs", _P), ("sp", ctypes.c_int64), ("start", ctypes.c_int64),
                ("base", ctypes.c_int32), ("kind", ctypes.c_int32)]


class _Round(ctypes.Structure):
    """csrc/scatter_pair.cu `Round`, passed by pointer and copied into
    the kernel's by-value parameter."""
    _fields_ = [("seg", _Seg * MAX_SEGMENTS), ("total", ctypes.c_int64),
                ("count", ctypes.c_int32)]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for v in SHAPES.values():
        v.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return path


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SOURCES.values()):
        h.update(src.encode())
        h.update((_CSRC / src).read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def build() -> float:
    """Compile every kernel library that is not built yet (one nvcc per
    source, all started together) and load them.  -> seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        if len(_libs) == len(SOURCES):
            return 0.0
        out_dir = _build_dir()
        logs = build_artifacts(
            out_dir, {f"lib{name}.so": [_nvcc(), *NVCC_FLAGS, str(_CSRC / src)]
                      for name, src in SOURCES.items()},
            "CUDA kernel build")
        BUILD_LOG.update({name: logs[f"lib{name}.so"] for name in SOURCES
                          if f"lib{name}.so" in logs})
        for name in SOURCES:
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(lib, fn):
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
            lib.constdb_cuda_error_string.argtypes = [ctypes.c_int]
            lib.constdb_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return time.perf_counter() - t0


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build()
    return _libs[name]


def _check_rc(lib: ctypes.CDLL, kernel: str, rc: int) -> None:
    if rc != 0:
        msg = lib.constdb_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"{msg} (cudaError {rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(kernel: str, *tensors: torch.Tensor, dtype=torch.int64) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{kernel}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: inputs must be contiguous")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")


def _stack_shape(kernel: str, *stacks: torch.Tensor) -> tuple[int, int]:
    shape = stacks[0].shape
    if len(shape) != 2 or shape[0] < 1:
        raise ValueError(f"{kernel}: expected [R >= 1, S] stacks, got {shape}")
    if any(s.shape != shape for s in stacks):
        raise ValueError(f"{kernel}: stack shapes differ")
    return int(shape[0]), int(shape[1])


def _k1_width(cols: int, *tensors: torch.Tensor) -> int:
    """K1's columns per thread: 2 when S is even and every int64 pointer
    is 16-byte aligned (int32 ones 8-byte), else 1 (the scalar variant)."""
    if cols % 2 == 0 and all(
            t.data_ptr() % (2 * t.element_size()) == 0 for t in tensors):
        return 2
    return 1


def fold_apply(at: torch.Tensor, an: torch.Tensor, idx: torch.Tensor,
               st_at: torch.Tensor, st_an: torch.Tensor,
               dt: torch.Tensor | None = None,
               st_dt: torch.Tensor | None = None) -> torch.Tensor:
    """K1 fused with its apply: fold the [R, S] stacks (at, an and, for
    elements, dt) as `merge_elems` does, then apply each column to the
    state row idx[s] (int32) as ops/bulk.py bulk_elems does (bulk_lww
    without dt): the planes st_at, st_an (and st_dt) of `size` rows are
    updated IN PLACE where idx[s] lies in [0, size); other ids (the pad
    rows of ops/bulk.py) write nothing.  Each slot appears at most once
    in idx.  -> win [S] int32: the winning batch row where the batch beat
    the state row, else -1."""
    if (dt is None) != (st_dt is None):
        raise ValueError("fold_apply: dt and st_dt go together")
    stacks = (at, an) if dt is None else (at, an, dt)
    planes = (st_at, st_an) if st_dt is None else (st_at, st_an, st_dt)
    if _on_cpu(*stacks, idx, *planes):
        return B.fold_apply(at, an, idx, st_at, st_an, dt=dt, st_dt=st_dt)
    _check("fold_apply", *stacks, *planes)
    _check("fold_apply", idx, dtype=torch.int32)
    rows, cols = _stack_shape("fold_apply", *stacks)
    size = int(st_at.shape[0])
    if idx.shape != (cols,) or any(p.shape != (size,) for p in planes):
        raise ValueError("fold_apply: expected idx [S] and equal-length "
                         "1-D state planes")
    win = torch.empty(cols, dtype=torch.int32, device=at.device)
    if cols:
        lib = _lib("merge_fold")
        rc = lib.constdb_fold_apply(
            at.data_ptr(), an.data_ptr(),
            None if dt is None else dt.data_ptr(), rows, cols,
            _k1_width(cols, *stacks, idx, win), idx.data_ptr(),
            st_at.data_ptr(), st_an.data_ptr(),
            None if st_dt is None else st_dt.data_ptr(), size,
            win.data_ptr(), _stream(at))
        _check_rc(lib, "fold_apply", rc)
        LAUNCHES["merge_elems"] += 1
        SHAPES["merge_elems"].append(
            (rows, cols, "registers" if dt is None else "elements"))
    return win


def _fold_only(at, an, dt):
    """K1's fold-only mode -> (at[S], an[S], dt[S] or None, win[S]
    int64) on the card."""
    stacks = (at, an) if dt is None else (at, an, dt)
    _check("merge_elems", *stacks)
    rows, cols = _stack_shape("merge_elems", *stacks)
    out = [torch.empty(cols, dtype=torch.int64, device=at.device)
           for _ in range(len(stacks) + 1)]
    if cols:
        lib = _lib("merge_fold")
        o_dt = None if dt is None else out[2].data_ptr()
        rc = lib.constdb_merge_elems(
            at.data_ptr(), an.data_ptr(),
            None if dt is None else dt.data_ptr(), rows, cols,
            _k1_width(cols, *stacks, *out), out[0].data_ptr(),
            out[1].data_ptr(), o_dt, out[-1].data_ptr(), _stream(at))
        _check_rc(lib, "merge_elems", rc)
        LAUNCHES["merge_elems"] += 1
    return out[0], out[1], None if dt is None else out[2], out[-1]


def merge_elems(at: torch.Tensor, an: torch.Tensor, dt: torch.Tensor):
    """K1, fold only: [R, S] element fold -> (at[S], an[S], dt[S],
    win[S] int64): lexicographic (add_t, add_node) max over R, the first
    row achieving it, and an independent max of del_t."""
    if _on_cpu(at, an, dt):
        return D.dense_merge_elems(at, an, dt)
    return _fold_only(at, an, dt)


def merge_lww(t: torch.Tensor, n: torch.Tensor):
    """K1's register variant, fold only: the plain (t, node) LWW fold,
    with no del plane.  -> (t[S], n[S], win[S])."""
    if _on_cpu(t, n):
        return D.dense_merge_lww(t, n)
    ft, fn, _, win = _fold_only(t, n, None)
    return ft, fn, win


def merge_counters(vals: torch.Tensor, ts: torch.Tensor):
    """K2: [R, S] counter-slot fold -> (val[S], t[S]): lexicographic
    (t, value) max over R (LWW with max-value tie)."""
    if _on_cpu(vals, ts):
        return D.dense_merge_counters(vals, ts)
    _check("merge_counters", vals, ts)
    rows, cols = _stack_shape("merge_counters", vals, ts)
    o_val = torch.empty(cols, dtype=torch.int64, device=vals.device)
    o_t = torch.empty(cols, dtype=torch.int64, device=vals.device)
    if cols:
        lib = _lib("merge_fold")
        rc = lib.constdb_merge_counters(
            vals.data_ptr(), ts.data_ptr(), rows, cols,
            _vec_width(vals, ts, o_val, o_t),
            o_val.data_ptr(), o_t.data_ptr(), _stream(vals))
        _check_rc(lib, "merge_counters", rc)
        LAUNCHES["merge_counters"] += 1
        SHAPES["merge_counters"].append((rows, cols))
    return o_val, o_t


SUM_ITEMS = 4   # csrc/segment_sum.cu kItems: rows per vector


def _sum_head(n: int, ids: torch.Tensor, *words: torch.Tensor) -> int:
    """K4's width: the number of leading rows (< SUM_ITEMS) after which
    the ids and every int64 plane are 16-byte aligned, or -1 (the scalar
    variant) when no such head exists or n is too short for a vector."""
    for head in range(SUM_ITEMS):
        if n >= head + SUM_ITEMS and \
                (ids.data_ptr() + 4 * head) % 16 == 0 and \
                all((w.data_ptr() + 8 * head) % 16 == 0 for w in words):
            return head
    return -1


def segment_sum(ids: torch.Tensor, vals: torch.Tensor, n_seg: int,
                base: torch.Tensor | None = None) -> torch.Tensor:
    """K4: per-segment int64 sums of `vals - base` (`vals` alone when
    `base` is None) over unsorted int32 `ids` in [0, n_seg), exact mod
    2^64 -> [n_seg] int64; ids outside the range are skipped."""
    words = (vals,) if base is None else (vals, base)
    # the contract holds on every device, the plain version's too
    _check("segment_sum", ids, dtype=torch.int32)
    _check("segment_sum", *words)
    if ids.dim() != 1 or any(w.shape != ids.shape for w in words):
        raise ValueError("segment_sum: ids, vals and base must be "
                         "equal-length 1-D")
    if _on_cpu(ids, *words):
        return D.segment_sum(ids, vals, n_seg, base=base)
    out = torch.zeros(n_seg, dtype=torch.int64, device=vals.device)
    n = int(ids.shape[0])
    if n and n_seg:
        lib = _lib("segment_sum")
        rc = lib.constdb_segment_sum(
            ids.data_ptr(), vals.data_ptr(),
            None if base is None else base.data_ptr(), n,
            _sum_head(n, ids, *words), n_seg, out.data_ptr(), _stream(vals))
        _check_rc(lib, "segment_sum", rc)
        LAUNCHES["segment_sum"] += 1
    return out


# planes and batch columns of each segment kind: (planes, cols)
_ARITY = {PAIR_SRC: (3, 2), PAIR: (2, 2), MAX1: (1, 1)}


def _check_segment(g: Segment) -> None:
    if g.kind not in _ARITY:
        raise ValueError(f"scatter_round: unknown segment kind {g.kind}")
    n_planes, n_cols = _ARITY[g.kind]
    if len(g.planes) != n_planes or len(g.cols) != n_cols:
        raise ValueError(f"scatter_round: kind {g.kind} takes {n_planes} "
                         f"planes and {n_cols} batch columns")
    int64_planes = g.planes[:2] if g.kind == PAIR_SRC else g.planes
    _check("scatter_round", *int64_planes, *g.cols)
    _check("scatter_round", g.idx, *g.planes[2:], dtype=torch.int32)
    p = g.planes[0]
    if p.dim() != 1 or any(t.shape != p.shape for t in g.planes):
        raise ValueError("scatter_round: planes must be equal-length 1-D")
    if g.idx.dim() != 1 or any(c.shape != g.idx.shape for c in g.cols):
        raise ValueError("scatter_round: batch columns must be n-long 1-D")
    if g.kind == PAIR_SRC and not 0 <= int(g.base) <= \
            (1 << 31) - g.idx.shape[0]:
        raise ValueError("scatter_round: base + n must fit int32")


def scatter_round(segs) -> None:
    """K3: every in-place scatter of one steady round in ONE launch.
    `segs` are ops/bulk.py Segments (at most MAX_SEGMENTS with rows), each
    on planes no other segment of the round touches, each with UNIQUE
    rows: PAIR_SRC writes (p, s) and src = base + i where (bp[i], bs[i]) >
    (p[idx[i]], s[idx[i]]) lexicographically, PAIR the same without src,
    MAX1 p = max(p, bp).  Ids outside the plane are dropped."""
    segs = [g for g in segs if g.idx.shape[0]]
    if not segs:
        return
    # the launch's contract, checked for the plain version too
    if len(segs) > MAX_SEGMENTS:
        raise ValueError(f"scatter_round: {len(segs)} segments, at most "
                         f"{MAX_SEGMENTS} per launch")
    tensors = [t for g in segs for t in (*g.planes, g.idx, *g.cols)]
    cpu = _on_cpu(*tensors)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("scatter_round: segments on different devices")
    for g in segs:
        _check_segment(g)
    planes = [t.data_ptr() for g in segs for t in g.planes]
    if len(set(planes)) != len(planes):
        raise ValueError("scatter_round: two segments share a plane")
    if cpu:
        B.scatter_round(segs)
        return
    rnd = _Round()
    start = 0
    for k, g in enumerate(segs):
        p, s, src = (*g.planes, None, None)[:3]
        rnd.seg[k] = _Seg(
            p.data_ptr(), s.data_ptr() if s is not None else None,
            src.data_ptr() if src is not None else None, g.idx.data_ptr(),
            g.cols[0].data_ptr(),
            g.cols[1].data_ptr() if len(g.cols) > 1 else None,
            p.shape[0], start, int(g.base) if g.kind == PAIR_SRC else 0,
            g.kind)
        start += g.idx.shape[0]
    rnd.total = start
    rnd.count = len(segs)
    lib = _lib("scatter_pair")
    rc = lib.constdb_scatter_round(ctypes.byref(rnd),
                                   _stream(segs[0].idx))
    _check_rc(lib, "scatter_round", rc)
    LAUNCHES["scatter_pair_src"] += 1


def scatter_pair_src(p: torch.Tensor, s: torch.Tensor, src: torch.Tensor,
                     idx: torch.Tensor, bp: torch.Tensor, bs: torch.Tensor,
                     base: int):
    """K3 with one PAIR_SRC segment: in-place gather-compare-scatter of
    one LWW pair against resident planes.  p, s [Sp] int64 (primary,
    secondary), src [Sp] int32, idx [n] int32 UNIQUE rows, bp, bs [n]
    int64; where (bp[i], bs[i]) > (p[idx[i]], s[idx[i]])
    lexicographically the pair is written and src[idx[i]] = base + i.
    -> (p, s, src), updated IN PLACE."""
    scatter_round([Segment(PAIR_SRC, (p, s, src), idx, (bp, bs), base)])
    return p, s, src


def _vec_width(*tensors: torch.Tensor) -> int:
    """Columns per access for K2 and K5: the widest of 16, 8 or 4 bytes
    that divides every row and every pointer's alignment."""
    esz = tensors[0].element_size()
    kp = int(tensors[0].shape[-1])
    for nbytes in (16, 8, 4):
        w = nbytes // esz
        if w >= 1 and kp % w == 0 and \
                all(t.data_ptr() % nbytes == 0 for t in tensors):
            return w
    return 1


def tensor_take_reduce(buf: torch.Tensor, idx: torch.Tensor, div, *,
                       strat: int, n: int, g: int, w=None,
                       tot=None) -> torch.Tensor:
    """K5: pool gather + canonical strategy reduction -> [g, Kp].  `buf`
    [C, Kp] f32 or f64 pool, `idx` [g * n] int32 pool rows in canonical
    contributor order, `div` the trimmed-mean divisor; sum, maxmag,
    trimmed-mean and avg, for which `w` [g * n] are the count weights and
    `tot` [g] the count totals, both in the payload dtype."""
    from ..crdt.tensor import (STRAT_AVG, STRAT_MAXMAG, STRAT_SUM,
                               STRAT_TRIMMED)
    avg = strat == STRAT_AVG
    if avg and (w is None or tot is None):
        raise ValueError("tensor_take_reduce: avg needs w and tot")
    extra = (w, tot) if avg else ()
    if _on_cpu(buf, idx, *extra):
        return D.tensor_take_reduce(buf, idx, div, strat=strat, n=n, g=g,
                                    w=w, tot=tot)
    if buf.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tensor_take_reduce: expected f32/f64, "
                        f"got {buf.dtype}")
    _check("tensor_take_reduce", buf, *extra, dtype=buf.dtype)
    _check("tensor_take_reduce", idx, dtype=torch.int32)
    if strat not in (STRAT_SUM, STRAT_AVG, STRAT_MAXMAG, STRAT_TRIMMED):
        raise ValueError(f"tensor_take_reduce: strategy {strat} does not "
                         "reduce in the kernel")
    if buf.dim() != 2 or idx.dim() != 1 or idx.shape[0] != g * n or \
            n < 1 or g < 0:
        raise ValueError("tensor_take_reduce: expected buf [C, Kp] and "
                         f"idx [g * n] with n >= 1; got "
                         f"{tuple(buf.shape)}, {tuple(idx.shape)}, n={n}, "
                         f"g={g}")
    if avg and (w.numel() != g * n or tot.numel() != g):
        raise ValueError("tensor_take_reduce: avg needs w [g * n] and "
                         "tot [g]")
    kp = int(buf.shape[1])
    out = torch.empty((g, kp), dtype=buf.dtype, device=buf.device)
    if g and kp:
        lib = _lib("tensor_reduce")
        rc = lib.constdb_tensor_take_reduce(
            buf.data_ptr(), idx.data_ptr(),
            w.data_ptr() if avg else None, tot.data_ptr() if avg else None,
            g, n, kp, float(div), int(strat),
            int(buf.dtype == torch.float64), _vec_width(buf, out),
            out.data_ptr(), _stream(buf))
        _check_rc(lib, "tensor_take_reduce", rc)
        LAUNCHES["tensor_take_reduce"] += 1
    return out
