"""The port's anti-entropy digests (constdb_tpu_torch/store/digest.py)
against the reference's (constdb_tpu/store/digest.py).

Port and reference KeySpaces are built from the same seeded op list and
the same state dumps; every digest function gives equal arrays on both.
The reference's invariants hold on the port too: the scalar digest does
not depend on the (fanout, leaves) geometry, row and merge order are
invisible, inert tombstones and same-horizon GC leave it unchanged, and
the port's hash-sharded store (every mode the tests run on the CPU)
digests equal to the plain store once the shard matrices are summed.
"""

import random

import numpy as np
import pytest

from constdb_tpu.crdt import semantics as RS
from constdb_tpu.engine.base import batch_from_keyspace as ref_dump
from constdb_tpu.engine.cpu import CpuMergeEngine as RefCpuEngine
from constdb_tpu.store import digest as RD
from constdb_tpu.store.keyspace import KeySpace as RefKeySpace
from constdb_tpu_torch import convert, workload
from constdb_tpu_torch.engine.base import batch_from_keyspace
from constdb_tpu_torch.engine.cpu import CpuMergeEngine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.store import digest as PD
from constdb_tpu_torch.store.keyspace import KeySpace
from constdb_tpu_torch.store.sharded_keyspace import ShardedKeySpace

MS0 = 1_600_000_000_000 << 22
GEOMETRIES = ((1, 1), (4, 2), (16, 8), (64, 1), (64, 4))
BATCH_COLS = ("key_enc", "key_ct", "key_mt", "key_dt", "key_expire",
              "reg_t", "reg_node", "cnt_ki", "cnt_node", "cnt_val",
              "cnt_uuid", "cnt_base", "cnt_base_t", "el_ki", "el_add_t",
              "el_add_node", "el_del_t", "del_t")
BATCH_LISTS = ("keys", "reg_val", "el_member", "el_val", "del_keys")


def _mixed_ops(n_keys=160, seed=3):
    """[(kind, key, member or value, uuid)]: registers, counters and sets
    with removes."""
    rng = random.Random(seed)
    ops, t = [], 0
    for i in range(n_keys):
        t += 1 + rng.randrange(3)
        key = b"k%04d" % i
        if i % 10 < 4:
            ops.append(("set", key, b"v%06d" % rng.randrange(10_000),
                        MS0 + (t << 10)))
        elif i % 10 < 7:
            ops.append(("cnt", key, rng.randrange(-50, 50), MS0 + (t << 10)))
        else:
            for _ in range(3):
                t += 1
                ops.append(("sadd", key, b"m%02d" % rng.randrange(8),
                            MS0 + (t << 10)))
            if rng.random() < 0.5:
                t += 1
                ops.append(("srem", key, b"m%02d" % rng.randrange(8),
                            MS0 + (t << 10)))
    return ops


def _apply_ops(ks, ops, node=7):
    """The op list through the KeySpace API, which the port copies from
    the reference (either class works)."""
    for kind, key, x, uuid in ops:
        if kind == "set":
            kid, _ = ks.get_or_create(key, RS.ENC_BYTES, uuid)
            ks.register_set(kid, x, uuid, node)
        elif kind == "cnt":
            kid, _ = ks.get_or_create(key, RS.ENC_COUNTER, uuid)
            ks.counter_change(kid, node, x, uuid)
        elif kind == "sadd":
            kid, _ = ks.get_or_create(key, RS.ENC_SET, uuid)
            ks.elem_add(kid, x, None, uuid, node)
            ks.updated_at(kid, uuid)
        elif kind == "srem":
            kid, _ = ks.get_or_create(key, RS.ENC_SET, uuid)
            ks.elem_rem(kid, x, uuid)


def _pair(seed=3, n_keys=160):
    """(reference store, port store): the same ops, a key tombstone, a
    later delete, then the same state dump of a second writer merged."""
    ref, port = RefKeySpace(), KeySpace()
    other = RefKeySpace()
    _apply_ops(other, _mixed_ops(n_keys, seed + 100), node=9)
    dump = ref_dump(other)
    for ks, eng, b in ((ref, RefCpuEngine(), dump),
                       (port, CpuMergeEngine(), convert.batch_from_dict(
                           {f: getattr(dump, f)
                            for f in convert.BATCH_FIELDS}))):
        _apply_ops(ks, _mixed_ops(n_keys, seed))
        ks.record_key_delete(b"gone", MS0 + (5 << 20))
        kid = ks.lookup(b"k0004")
        ks.set_delete_time(kid, MS0 + (1 << 30))
        ks.record_key_delete(b"k0004", MS0 + (1 << 30))
        eng.merge(ks, b)
    return ref, port


def _same_batch(got, want):
    for f in BATCH_COLS:
        assert np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(want, f))), f
    for f in BATCH_LISTS:
        assert list(getattr(got, f)) == list(getattr(want, f)), f


def _mask(fanout, leaves, seed):
    rng = np.random.default_rng(seed)
    return rng.random(fanout * leaves) < 0.3


@pytest.mark.parametrize("seed", [3, 11])
def test_digests_equal_reference(seed):
    ref, port = _pair(seed)
    assert port.canonical() == ref.canonical()
    assert PD.full_state_digest(port) == RD.full_state_digest(ref)
    for fanout, leaves in GEOMETRIES:
        got = PD.state_digest_matrix(port, fanout, leaves)
        assert got.dtype == np.uint64 and got.shape == (fanout, leaves)
        assert np.array_equal(got, RD.state_digest_matrix(ref, fanout,
                                                          leaves))
        mask = _mask(fanout, leaves, seed)
        sel = PD.bucket_key_sel(port, fanout, leaves, mask)
        assert np.array_equal(sel, RD.bucket_key_sel(ref, fanout, leaves,
                                                     mask))
        assert PD.masked_key_count(port, fanout, leaves, mask) == \
            RD.masked_key_count(ref, fanout, leaves, mask)
        assert PD.masked_key_count(port, fanout, leaves, mask,
                                   key_sel=sel) == \
            RD.masked_key_count(ref, fanout, leaves, mask)
        _same_batch(PD.export_bucket_batch(port, fanout, leaves, mask),
                    RD.export_bucket_batch(ref, fanout, leaves, mask))
        pt = PD.KeyStampTable(port, fanout, leaves, mask)
        rt = RD.KeyStampTable(ref, fanout, leaves, mask)
        assert np.array_equal(pt.crcs, rt.crcs)
        assert np.array_equal(pt.stamps, rt.stamps)
        pick = np.arange(0, len(pt.crcs), 2)
        _same_batch(pt.export_batch(port, pick), rt.export_batch(ref, pick))
        # the puller leg: a peer's table against this store, with some
        # stamps flipped and some crcs absent here
        stamps = pt.stamps.copy()
        stamps[::3] += np.uint64(1)
        crcs = np.concatenate([pt.crcs, np.array([7, 9], np.uint64)])
        stamps = np.concatenate([stamps, np.zeros(2, np.uint64)])
        assert np.array_equal(
            PD.stamp_mismatch_indices(port, crcs, stamps),
            RD.stamp_mismatch_indices(ref, crcs, stamps))
    mats = [PD.state_digest_matrix(port, 4, 2)] * 2
    assert np.array_equal(PD.sum_matrices(mats, 4, 2),
                          RD.sum_matrices(mats, 4, 2))
    with pytest.raises(ValueError, match="size mismatch"):
        PD.sum_matrices([np.zeros(3, np.uint64)], 4, 2)
    assert PD.leaves_for(1_000_000, 64, 16) == RD.leaves_for(1_000_000, 64,
                                                             16)


def test_digest_geometry_independent():
    _, port = _pair()
    want = PD.full_state_digest(port)
    for fanout, leaves in GEOMETRIES:
        assert PD.full_state_digest(port, fanout, leaves) == want
    other = KeySpace()
    _apply_ops(other, _mixed_ops())
    base = PD.full_state_digest(other)
    kid, _ = other.get_or_create(b"extra", RS.ENC_COUNTER, 77 << 22)
    other.counter_change(kid, 9, 1, 77 << 22)
    assert PD.full_state_digest(other) != base


def test_digest_order_independence_and_locality():
    """Permuted partial merges with an idempotent re-merge on top digest
    like one whole-state merge; one divergent write flags exactly its
    bucket, and that bucket's export re-converges the digests."""
    src = KeySpace()
    _apply_ops(src, _mixed_ops())
    a, b = KeySpace(), KeySpace()
    CpuMergeEngine().merge(a, batch_from_keyspace(src))
    n = src.keys.n
    perm = np.random.RandomState(7).permutation(n)
    eng = TorchMergeEngine(resident=True, device="cpu")
    for sel in (perm[n // 2:], perm[:n // 2], perm):
        eng.merge_many(b, [batch_from_keyspace(src, key_sel=sel)])
    eng.flush(b)
    assert a.canonical() == b.canonical()
    assert np.array_equal(PD.state_digest_matrix(a, 16, 8),
                          PD.state_digest_matrix(b, 16, 8))
    a.register_set(a.lookup(b"k0000"), b"DIVERGED", MS0 + (1 << 30), 9)
    da, db = PD.state_digest_matrix(a, 16, 8), PD.state_digest_matrix(b, 16,
                                                                      8)
    assert int((da != db).sum()) == 1
    CpuMergeEngine().merge(b, PD.export_bucket_batch(
        a, 16, 8, (da != db).reshape(-1)))
    assert np.array_equal(PD.state_digest_matrix(b, 16, 8), da)


def test_digest_inert_tombstone_and_gc_invariance():
    a, b = KeySpace(), KeySpace()
    for ks in (a, b):
        kid, _ = ks.get_or_create(b"s1", RS.ENC_SET, MS0 + 100)
        ks.elem_add(kid, b"m1", None, MS0 + 100, 7)
        ks.updated_at(kid, MS0 + 100)
    # an older remove on `a` only is inert: the add wins
    a.elem_merge(a.lookup(b"s1"), b"m1", MS0 + 100, 7, MS0 + 50, None)
    b.elem_merge(b.lookup(b"s1"), b"m1", MS0 + 100, 7, 0, None)
    assert a.canonical() == b.canonical()
    assert PD.full_state_digest(a) == PD.full_state_digest(b)
    ops = _mixed_ops(80, seed=11)
    for ks in (a, b):
        _apply_ops(ks, ops)
        ks.set_delete_time(ks.lookup(b"k0004"), MS0 + (2 << 30))
        ks.record_key_delete(b"k0004", MS0 + (2 << 30))
        ks.elem_rem(ks.lookup(b"k0007"), b"m01", MS0 + (2 << 30))
    assert PD.full_state_digest(a) == PD.full_state_digest(b)
    horizon = MS0 + (3 << 30)
    assert a.gc(horizon) == b.gc(horizon)
    assert not a.key_deletes
    assert PD.full_state_digest(a) == PD.full_state_digest(b)


@pytest.mark.parametrize("n,mode,spec", [(1, "local", "cuda"),
                                         (3, "local", "cuda"),
                                         (3, "local", "cpu"),
                                         (2, "process", "cuda")])
def test_sharded_store_digest_equals_plain(n, mode, spec):
    """A sharded store's summed shard matrices equal the plain store's
    matrix (the shards partition the keys); consolidated, its serving
    store has the plain store's full_state_digest."""
    chunks = workload.chunk_batches(workload.make_workload(300, 3, seed=9),
                                    100)
    plain = KeySpace()
    cpu = CpuMergeEngine()
    for c in chunks:
        cpu.merge(plain, c)
    sks = ShardedKeySpace(n_shards=n, mode=mode, engine_spec=spec, group=3,
                          device="cpu")
    try:
        for c in chunks:
            sks.submit(c)
        sks.flush()
        if sks.pool is None:
            mats = [PD.state_digest_matrix(s, 16, 8) for s in sks.stores]
            assert np.array_equal(PD.sum_matrices(mats, 16, 8),
                                  PD.state_digest_matrix(plain, 16, 8))
        serve = KeySpace()
        eng = TorchMergeEngine(resident=True, device="cpu")
        sks.consolidate_into(serve, eng)
        eng.flush(serve)
    finally:
        sks.close()
    assert PD.full_state_digest(serve) == PD.full_state_digest(plain)
