"""The least time of each of the port's five kernels, from their shapes.

A kernel's roofline share is the least time the card could take for the
launch, the larger of the bytes it must move to or from HBM over the
memory rate and its operations over the arithmetic rate, divided by the
kernel's time in the device trace.

Bytes: each kernel function below gives the bytes a launch reads (each
input once) and writes (each output once).  Not all of them need cross
HBM: the 50 MiB L2 may hold what the work just before the launch wrote
(the engine uploads a kernel's ids and scatters into its planes right
before it), and may keep what the launch writes.  So only what cannot fit
counts: the bytes read beyond the L2's size, and the bytes written beyond
it.  That is the least traffic any launch must make, so a share never
reads above 100% from a warm cache; where a launch's data fits the L2,
only its operations bound it.  Where the output a kernel writes depends
on the data (a state row is written only where the batch beats it), only
what every launch must move is counted.  Operations are the 64-bit
integer compares and adds the kernel must make; they are counted against
the card's non-tensor FP32 rate, the nearest rate the data sheet gives.

Peaks: NVIDIA H100 SXM5 80GB data sheet (dense): HBM3 3.35 TB/s, FP32
67 TFLOP/s, at its 700 W power limit; L2 50 MB (NVIDIA H100 Tensor Core
GPU architecture whitepaper; the card reports 52,428,800 bytes).  A card
set below that limit runs slower under load; the harness prints the
card's limit beside each share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
L2_BYTES = 52_428_800
I32, I64 = 4, 8

# the kernels' names in the device trace (csrc/*.cu)
KERNEL_NAMES = {"k1": "fold_apply_kernel", "k2": "merge_counters_kernel",
                "k3": "scatter_round_kernel", "k4": "segment_sum_kernel",
                "k5": "take_reduce_kernel"}


def hbm_bytes(read: float, written: float) -> float:
    """The least bytes a launch must move to or from HBM: what it reads
    beyond what the L2 can hold at its start, and what it writes beyond
    what the L2 can keep at its end."""
    return max(0.0, read - L2_BYTES) + max(0.0, written - L2_BYTES)


def least_s(read: float, written: float, ops: float) -> float:
    return max(hbm_bytes(read, written) / HBM_BYTES_PER_S,
               ops / ALU_OPS_PER_S)


# each kernel's function -> (bytes read, bytes written, operations)


def k1(rows: int, cols: int, elements: bool) -> tuple:
    """fold_apply: [R, S] stacks of add time, add node and, for elements,
    delete time folded per column (R - 1 lexicographic compares, R - 1
    maxima), then each column's winner compared with state row idx[s].
    Reads the stacks, idx [S] int32 and the state rows at idx; writes
    win [S] int32 (state rows only where the batch wins: not counted)."""
    k = 3 if elements else 2
    read = I64 * k * rows * cols + I32 * cols + I64 * k * cols
    ops = 2 * (rows - 1) * cols + 2 * cols
    return read, I32 * cols, ops


def k2(rows: int, cols: int) -> tuple:
    """merge_counters: [R, S] values and uuids, per column the value of
    the largest uuid (the larger value on a tie).  Reads both stacks,
    writes o_val and o_t [S]."""
    return I64 * 2 * rows * cols, I64 * 2 * cols, 2 * (rows - 1) * cols


def k3(segments: list) -> tuple:
    """scatter_round: per segment (kind, n rows), each row reads idx
    (int32) and its batch columns (int64) and the plane entries at idx it
    compares against: PAIR_SRC and PAIR two planes, MAX1 one.  Writes
    (the winners only) are not counted."""
    nbytes = ops = 0
    for kind, n in segments:
        planes = 1 if kind == "max1" else 2
        nbytes += n * (I32 + I64 * planes + I64 * planes)
        ops += n * planes
    return nbytes, 0, ops


def k4(n: int, n_seg: int, has_base: bool) -> tuple:
    """segment_sum: ids [n] int32 and vals [n] int64 (and base [n]) read,
    val - base and one add per row, sums [n_seg] int64 written."""
    return (n * (I32 + I64 * (2 if has_base else 1)), I64 * n_seg,
            n * (2 if has_base else 1))


def k5(groups: int, contributors: int, width: int, itemsize: int,
       weighted: bool) -> tuple:
    """take_reduce: per group, `contributors` pool rows of `width` items
    gathered by idx [g * n] int32 and reduced (for avg with count
    weights [g * n] and totals [g]); writes [g, width]."""
    rows = groups * contributors
    read = rows * width * itemsize + rows * I32
    if weighted:
        read += rows * itemsize + groups * itemsize
    return read, groups * width * itemsize, rows * width * (2 if weighted
                                                            else 1)


def share_pct(least_total_s: float, kernel_s: float):
    """Roofline share in %, or None when the trace holds no kernel time."""
    if not kernel_s or kernel_s <= 0 or least_total_s <= 0:
        return None
    return 100.0 * least_total_s / kernel_s
