"""Snapshot catch-up workload: generator, chunker and oracle.

The port's own copy of the reference bench's workload helpers
(bench.py make_workload, chunk_batches, subsample_keys,
subsample_workload, oracle_canonical): R replica snapshots of one mixed
N-key keyspace, 40% PN-counters, 30% LWW registers, 30% sets of
`members_per_set` members, made from a seed with numpy.

One shape is added: `aligned_counters=True` gives every replica's dump
the counter slots of all R writer nodes, the way a converged cluster's
snapshot holds them, each replica with its own view (value, uuid) of
every slot.  Counter rows then align across replicas and take the
device fold (K2 merge_counters); in the default shape each replica
carries only its own slot, so counter rows never align.
"""

from __future__ import annotations

import sys

import numpy as np

from .crdt import semantics as S
from .engine.base import ColumnarBatch
from .engine.cpu import CpuMergeEngine
from .persist.snapshot import batch_chunks
from .store.keyspace import KeySpace

_I64 = np.int64
SEQ_BITS = 22                # HLC uuid = (ms << SEQ_BITS) | seq
MS0 = 1_700_000_000_000      # fixed epoch so uuids look like real HLC values


def _uuids(rng, n, span_ms=600_000):
    ms = (rng.random(n) * span_ms).astype(_I64)
    seq = (rng.random(n) * (1 << 10)).astype(_I64)
    return ((MS0 + ms) << SEQ_BITS) | seq


def make_workload(n_keys: int, n_replicas: int, seed: int = 7,
                  members_per_set: int = 4,
                  aligned_counters: bool = False) -> list[ColumnarBatch]:
    """R snapshot batches over one mixed N-key keyspace.  Immutable
    columns (key bytes, enc, member bytes, slot layout) are built once and
    shared across batches, as replica snapshots of one keyspace share
    them.  `aligned_counters`: see the module docstring."""
    rng = np.random.default_rng(seed)
    keys = [b"k%010d" % i for i in range(n_keys)]
    enc = np.empty(n_keys, dtype=np.int8)
    n_cnt = int(n_keys * 0.4)
    n_reg = int(n_keys * 0.3)
    n_set = n_keys - n_cnt - n_reg
    enc[:n_cnt] = S.ENC_COUNTER
    enc[n_cnt:n_cnt + n_reg] = S.ENC_BYTES
    enc[n_cnt + n_reg:] = S.ENC_SET

    reg_pool = [b"v%06d" % i for i in range(1024)]
    reg_idx = rng.integers(0, len(reg_pool), n_reg)
    member_pool = [b"m%04d" % i for i in range(4096)]

    set_ki = np.repeat(np.arange(n_cnt + n_reg, n_keys, dtype=_I64),
                       members_per_set)
    member_idx = rng.integers(0, len(member_pool), len(set_ki))
    # batches declare rows_unique_per_slot: drop duplicate (key, member)
    # draws so the claim actually holds
    combo = (set_ki << 32) | member_idx
    _, first = np.unique(combo, return_index=True)
    first.sort()
    set_ki = set_ki[first]
    member_idx = member_idx[first]
    el_member = [member_pool[i] for i in member_idx]
    el_val = [None] * len(set_ki)
    if aligned_counters:
        # every dump holds all R writers' slots of every counter key
        cnt_ki = np.repeat(np.arange(n_cnt, dtype=_I64), n_replicas)
        cnt_node = np.tile(np.arange(1, n_replicas + 1, dtype=_I64), n_cnt)

    batches = []
    for r in range(n_replicas):
        b = ColumnarBatch()
        b.rows_unique_per_slot = True
        b.keys = keys
        b.key_enc = enc
        b.key_ct = _uuids(rng, n_keys)
        b.key_mt = b.key_ct + (rng.integers(0, 1000, n_keys) << SEQ_BITS)
        # ~2% of keys tombstoned later than their create time
        dt = np.where(rng.random(n_keys) < 0.02,
                      b.key_mt + (1 << SEQ_BITS), 0)
        b.key_dt = dt.astype(_I64)
        b.key_expire = np.zeros(n_keys, dtype=_I64)

        b.reg_val = [None] * n_cnt + [reg_pool[i] for i in reg_idx] + \
                    [None] * n_set
        b.reg_t = np.zeros(n_keys, dtype=_I64)
        b.reg_t[n_cnt:n_cnt + n_reg] = _uuids(rng, n_reg)
        b.reg_node = np.zeros(n_keys, dtype=_I64)
        b.reg_node[n_cnt:n_cnt + n_reg] = r + 1

        if aligned_counters:
            b.cnt_ki = cnt_ki
            b.cnt_node = cnt_node
        else:
            # each replica snapshot carries that replica's own counter slot
            b.cnt_ki = np.arange(n_cnt, dtype=_I64)
            b.cnt_node = np.full(n_cnt, r + 1, dtype=_I64)
        n_rows = len(b.cnt_ki)
        b.cnt_val = rng.integers(-1000, 1000, n_rows).astype(_I64)
        b.cnt_uuid = _uuids(rng, n_rows)
        b.cnt_base = np.zeros(n_rows, dtype=_I64)
        b.cnt_base_t = np.full(n_rows, S.NEUTRAL_T, dtype=_I64)

        b.el_ki = set_ki
        b.el_member = el_member
        b.el_val = el_val
        b.el_add_t = _uuids(rng, len(set_ki))
        b.el_add_node = np.full(len(set_ki), r + 1, dtype=_I64)
        b.el_del_t = np.where(rng.random(len(set_ki)) < 0.1,
                              _uuids(rng, len(set_ki)), 0).astype(_I64)
        batches.append(b)
    return batches


def chunk_batches(batches, chunk_keys: int) -> list[ColumnarBatch]:
    """Interleave replicas' snapshot chunks (the arrival order of a real
    multi-peer catch-up): groups of len(batches) consecutive chunks are
    slot-aligned."""
    per_replica = [list(batch_chunks(b, chunk_keys)) for b in batches]
    out = []
    for i in range(max(len(p) for p in per_replica)):
        for p in per_replica:
            if i < len(p):
                out.append(p[i])
    return out


def subsample_keys(keys, n_keys: int, target: int = 100_000) -> list:
    """Key bytes of the verification subsample: every `step`-th key."""
    step = max(1, n_keys // target)
    return [keys[i] for i in range(0, n_keys, step)]


def subsample_workload(batches, n_keys: int, target: int = 100_000):
    """Deterministic per-key filter of a workload: every `step`-th key,
    with counter/element rows remapped.  Per-key merges are independent,
    so a CPU replay of the filtered batches is an exact oracle for those
    keys in the full merged store."""
    step = max(1, n_keys // target)
    keep = np.arange(0, n_keys, step)
    sub_keys = subsample_keys(batches[0].keys, n_keys, target)
    out = []
    for b in batches:
        fb = ColumnarBatch()
        fb.rows_unique_per_slot = b.rows_unique_per_slot
        fb.keys = sub_keys
        fb.key_enc = b.key_enc[keep]
        fb.key_ct = b.key_ct[keep]
        fb.key_mt = b.key_mt[keep]
        fb.key_dt = b.key_dt[keep]
        fb.key_expire = b.key_expire[keep]
        fb.reg_val = [b.reg_val[i] for i in keep.tolist()]
        fb.reg_t = b.reg_t[keep]
        fb.reg_node = b.reg_node[keep]
        cm = (b.cnt_ki % step) == 0
        fb.cnt_ki = b.cnt_ki[cm] // step
        for col in ("cnt_node", "cnt_val", "cnt_uuid", "cnt_base",
                    "cnt_base_t"):
            setattr(fb, col, getattr(b, col)[cm])
        em = (b.el_ki % step) == 0
        rows = np.nonzero(em)[0].tolist()
        fb.el_ki = b.el_ki[em] // step
        fb.el_member = [b.el_member[i] for i in rows]
        fb.el_val = [b.el_val[i] for i in rows]
        for col in ("el_add_t", "el_add_node", "el_del_t"):
            setattr(fb, col, getattr(b, col)[em])
        out.append(fb)
    return out, sub_keys


def oracle_canonical(batches, n_keys: int, target: int = 100_000) -> dict:
    """CPU-replay a deterministic ~`target`-key subsample of the workload
    through the port's CpuMergeEngine and return its canonical state."""
    sub, _sub_keys = subsample_workload(batches, n_keys, target)
    oracle = KeySpace()
    cpu = CpuMergeEngine()
    for b in sub:
        cpu.merge(oracle, b)
    return oracle.canonical()


def compare_canonical(got: dict, want: dict) -> int:
    """Mismatch count between two canonical states (the first few are
    printed to stderr)."""
    if got == want:
        return 0
    diff = [k for k in want if got.get(k) != want[k]]
    diff += [k for k in got if k not in want]
    for k in diff[:5]:
        print(f"VERIFY MISMATCH {k!r}:\n  got={got.get(k)!r}"
              f"\n  oracle={want.get(k)!r}", file=sys.stderr)
    return len(diff)


def verify_store(store: KeySpace, batches, n_keys: int,
                 target: int = 100_000) -> tuple[int, int]:
    """Oracle check of a merged store on the subsample.
    -> (keys checked, mismatches)."""
    sub_keys = subsample_keys(batches[0].keys, n_keys, target)
    want = oracle_canonical(batches, n_keys, target)
    return len(sub_keys), compare_canonical(store.canonical(keys=sub_keys),
                                            want)
