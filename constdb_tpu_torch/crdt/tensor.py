"""Tensor-valued registers: the two-layer CRDT of arXiv 2605.19373.

A tensor key's state is two layers:

  * ENVELOPE (metadata): the key's ct/mt/dt/expire row (the usual
    max-merge envelope), plus a creation-fixed `TensorMeta` — strategy
    id, dtype, shape — and one contributor slot per writer node holding
    that node's latest `(uuid, count, payload)` as an LWW register.
    Envelope merges are the existing LWW/fold machinery: slot merges
    are exactly the counter-slot (value @ time) rule with the payload
    riding the winner.
  * PAYLOAD (read-time reduction): the visible tensor value is a
    REGISTERED STRATEGY applied over the live contributor payloads.
    The state itself is the delivered SET of contributions — merge is a
    pointwise slot LWW, trivially commutative/associative/idempotent —
    and the strategy is a pure function of that set, so replicas
    converge by construction (the paper's "CRDT-compliant model
    merging" decomposition: any aggregation expressible as a
    commutative reduction over stamped dense tensors rides the same
    envelope).

Canonical-order law (docs/INVARIANTS.md "Tensor registers"): float
reductions are NOT associative, so every strategy reduces contributors
in ascending `(node, uuid)` order with a FIXED sequential operation
chain.  `reduce_rows` below is the one reference implementation; the
device twins (constdb_tpu ops/dense.py `tensor_reduce`, ops/pallas_dense.py
`tensor_reduce`) unroll the exact same chain, so host and device reads
are bit-identical IEEE operation sequences — replicas cannot diverge
through summation order, whatever engine serves the read.

Strategies (ids are wire/snapshot stable — append only):

  0 lww           payload of the max-(uuid, node) contributor
  1 sum           sequential elementwise sum
  2 avg           count-weighted mean: Σ(cnt_i · p_i) / Σ cnt_i
  3 maxmag        elementwise max-magnitude pick (strict >, so the
                  earlier canonical contributor keeps exact-magnitude
                  ties)
  4 trimmed-mean  drop the elementwise min and max, mean the rest
                  (plain sequential mean below 3 contributors)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

STRAT_LWW = 0
STRAT_SUM = 1
STRAT_AVG = 2
STRAT_MAXMAG = 3
STRAT_TRIMMED = 4

STRATEGY_IDS = {"lww": STRAT_LWW, "sum": STRAT_SUM, "avg": STRAT_AVG,
                "maxmag": STRAT_MAXMAG, "trimmed-mean": STRAT_TRIMMED}
STRATEGY_NAMES = {v: k for k, v in STRATEGY_IDS.items()}

# dtype codes (wire/snapshot stable)
DTYPE_IDS = {"f32": 0, "f64": 1}
DTYPE_NAMES = {v: k for k, v in DTYPE_IDS.items()}
_DTYPES = {0: np.dtype(np.float32), 1: np.dtype(np.float64)}


class TensorConfigError(ValueError):
    """Malformed or mismatched tensor configuration."""


@dataclass(frozen=True)
class TensorMeta:
    """Creation-fixed tensor key configuration."""

    strat: int
    dtype_code: int
    shape: tuple

    @property
    def dtype(self) -> np.dtype:
        return _DTYPES[self.dtype_code]

    @property
    def elems(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.elems * self.dtype.itemsize

    @property
    def strat_name(self) -> str:
        return STRATEGY_NAMES.get(self.strat, str(self.strat))


def pack_config(meta: TensorMeta) -> bytes:
    """Wire/snapshot form: strat byte, dtype byte, ndim byte, u32le dims."""
    out = bytearray((meta.strat, meta.dtype_code, len(meta.shape)))
    for d in meta.shape:
        out += int(d).to_bytes(4, "little")
    return bytes(out)


def unpack_config(b: bytes) -> TensorMeta:
    if len(b) < 3:
        raise TensorConfigError("truncated tensor config")
    strat, dcode, ndim = b[0], b[1], b[2]
    if strat not in STRATEGY_NAMES:
        raise TensorConfigError(f"unknown tensor strategy id {strat}")
    if dcode not in _DTYPES:
        raise TensorConfigError(f"unknown tensor dtype code {dcode}")
    if len(b) != 3 + 4 * ndim:
        raise TensorConfigError("tensor config length mismatch")
    shape = tuple(int.from_bytes(b[3 + 4 * i: 7 + 4 * i], "little")
                  for i in range(ndim))
    if any(d <= 0 for d in shape) or not shape:
        raise TensorConfigError("tensor shape must be positive")
    return TensorMeta(strat, dcode, shape)


def parse_meta(strat_s: str, dtype_s: str, shape_s: str,
               default_strat: str = "lww",
               max_elems: int = 1 << 22) -> TensorMeta:
    """Client-argument form: strategy name (`-` = the configured
    default), dtype name (f32/f64), shape as `4096` or `64x64`."""
    if strat_s in ("-", ""):
        strat_s = default_strat
    strat = STRATEGY_IDS.get(strat_s)
    if strat is None:
        raise TensorConfigError(
            f"unknown tensor strategy {strat_s!r} "
            f"(one of {', '.join(sorted(STRATEGY_IDS))})")
    dcode = DTYPE_IDS.get(dtype_s)
    if dcode is None:
        raise TensorConfigError(f"unknown tensor dtype {dtype_s!r} "
                                "(f32 or f64)")
    try:
        shape = tuple(int(p) for p in shape_s.replace("*", "x").split("x"))
    except ValueError:
        raise TensorConfigError(f"bad tensor shape {shape_s!r}") from None
    meta = TensorMeta(strat, dcode, shape)
    # dims must fit the wire config's fields (pack_config: one ndim
    # byte, u32 per dim) — unbounded values would escape as raw
    # OverflowError/ValueError past the command error boundary instead
    # of a clean client error
    if len(shape) > 255:
        raise TensorConfigError("tensor rank must be <= 255")
    if any(d <= 0 or d >= (1 << 32) for d in shape) or not shape:
        raise TensorConfigError("tensor dims must be in [1, 2^32)")
    if meta.elems > max_elems:
        raise TensorConfigError(
            f"tensor too large: {meta.elems} elems > cap {max_elems} "
            "(CONSTDB_TENSOR_MAX_ELEMS)")
    return meta


def check_count(cnt: int) -> None:
    """Contribution counts weight the `avg` strategy's denominator: a
    non-positive count poisons reads with NaN/Inf (0/0) or corrupts the
    weighted mean — rejected at every intake (op commands raise, the
    serve planners demote into that raise, the merge paths skip the row
    like any other malformed contribution)."""
    if cnt < 1:
        raise TensorConfigError(
            f"tensor contribution count must be >= 1, got {cnt}")


def payload_ok(meta: TensorMeta, payload) -> bool:
    """The row-validity predicate `payload_array` enforces, without the
    normalization: wire bytes of exactly the config's byte size, or an
    ndarray of the config's dtype and element count.  The batched
    device path (engine/cuda.py) pre-filters rows with THIS predicate so
    its skip rules cannot drift from the per-row reference
    (KeySpace.tensor_merge_row → payload_array)."""
    if isinstance(payload, np.ndarray):
        return payload.dtype == meta.dtype and payload.size == meta.elems
    return len(payload) == meta.nbytes


def payload_array(meta: TensorMeta, payload) -> np.ndarray:
    """Normalize a wire payload (raw little-endian bytes) or ndarray to
    the flat [elems] array of the key's dtype.  Raises
    TensorConfigError on a size mismatch — the merge paths skip such
    rows exactly like type conflicts."""
    if isinstance(payload, np.ndarray):
        arr = payload.reshape(-1)
        if arr.dtype != meta.dtype:
            raise TensorConfigError("tensor payload dtype mismatch")
    else:
        if len(payload) != meta.nbytes:
            raise TensorConfigError(
                f"tensor payload is {len(payload)} bytes, key config "
                f"needs {meta.nbytes}")
        arr = np.frombuffer(payload, dtype=meta.dtype.newbyteorder("<"))
        if arr.dtype != meta.dtype:  # big-endian host
            arr = arr.astype(meta.dtype)
    if len(arr) != meta.elems:
        raise TensorConfigError(
            f"tensor payload has {len(arr)} elems, key config needs "
            f"{meta.elems}")
    return arr


def canonical_order(nodes: np.ndarray, uuids: np.ndarray) -> np.ndarray:
    """Contributor sort order every strategy reduces in: ascending
    (node, uuid).  One slot per node makes `node` alone total, but the
    uuid tiebreak keeps the order well-defined for any delivered set."""
    return np.lexsort((np.asarray(uuids), np.asarray(nodes)))


def reduce_rows(strat: int, mat: np.ndarray, cnts, uuids, nodes
                ) -> np.ndarray:
    """THE canonical host reduction over contributors already sorted in
    canonical (node, uuid) order: `mat` is [n, K] of the key's dtype,
    `cnts`/`uuids`/`nodes` are the aligned per-contributor columns.

    Every operation below is a fixed sequential IEEE chain — the device
    twins (constdb_tpu ops/dense.py / ops/pallas_dense.py `tensor_reduce`) unroll
    the SAME chain, so results are bit-identical across engines."""
    n = len(mat)
    dt = mat.dtype.type
    if strat == STRAT_LWW:
        w = 0
        for i in range(1, n):
            if (int(uuids[i]), int(nodes[i])) > (int(uuids[w]),
                                                 int(nodes[w])):
                w = i
        return np.array(mat[w], copy=True)
    if strat == STRAT_SUM:
        acc = np.array(mat[0], copy=True)
        for i in range(1, n):
            acc = acc + mat[i]
        return acc
    if strat == STRAT_AVG:
        # the count total accumulates in the PAYLOAD dtype, not int —
        # the device twin carries counts as a float plane, so the host
        # must run the identical float chain (identical even when a
        # pathological count total would round in f32)
        acc = mat[0] * dt(cnts[0])
        tot = dt(cnts[0])
        for i in range(1, n):
            acc = acc + mat[i] * dt(cnts[i])
            tot = tot + dt(cnts[i])
        return acc / tot
    if strat == STRAT_MAXMAG:
        acc = np.array(mat[0], copy=True)
        for i in range(1, n):
            acc = np.where(np.abs(mat[i]) > np.abs(acc), mat[i], acc)
        return acc
    if strat == STRAT_TRIMMED:
        if n <= 2:
            acc = np.array(mat[0], copy=True)
            for i in range(1, n):
                acc = acc + mat[i]
            return acc / dt(n)
        s = np.array(mat[0], copy=True)
        mn = np.array(mat[0], copy=True)
        mx = np.array(mat[0], copy=True)
        for i in range(1, n):
            s = s + mat[i]
            mn = np.minimum(mn, mat[i])
            mx = np.maximum(mx, mat[i])
        return (s - mn - mx) / dt(n - 2)
    raise TensorConfigError(f"unknown tensor strategy id {strat}")
