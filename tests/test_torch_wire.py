"""The port's REPLBATCH wire codec (constdb_tpu_torch/replica/wire.py,
native/wire.cpp) against the reference's: `build_wire_batch` bytes are
equal for the same repl-log entries, a decoded batch applied through
the coalescer lands as the per-frame path does (and as the reference's
node), every prefix truncation and a seeded sample of bit flips raise
in both packages, and the native blob packers equal the pure ones."""

import random

import numpy as np
import pytest

from constdb_tpu.replica import wire as RW
from constdb_tpu.replica.coalesce import CoalescingApplier as RefApplier
from constdb_tpu.replica.manager import ReplicaMeta as RefMeta
from constdb_tpu.resp import message as RM
from constdb_tpu.server.node import Node as RefNode
from constdb_tpu_torch import workload as W
from constdb_tpu_torch.engine.cpu import CpuMergeEngine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.replica import wire as PW
from constdb_tpu_torch.replica.coalesce import CoalescingApplier
from constdb_tpu_torch.replica.manager import ReplicaMeta
from constdb_tpu_torch.resp import message as PM
from constdb_tpu_torch.server.node import Node

from torch_ref_native import build_reference_ext

MS0 = 1_700_000_000_000
SEQ_BITS = 22


def u(i: int) -> int:
    return (MS0 + i) << SEQ_BITS


def tensor_cfg() -> bytes:
    from constdb_tpu_torch.crdt import tensor as T
    return T.pack_config(T.TensorMeta(T.STRATEGY_IDS["sum"], 0, (8,)))


def mixed_bodies(n: int, seed: int = 3, keys: int = 60):
    """Op bodies covering every encodable command (tensor contributions
    and deletes included) and the barrier classes."""
    rng = random.Random(seed)
    cfg = tensor_cfg()
    out = []
    for i in range(1, n + 1):
        r = rng.random()
        k = b"k%03d" % rng.randrange(keys)
        if r < 0.20:
            f = (b"set", b"r" + k, b"v%d" % i)
        elif r < 0.36:
            f = (b"cntset", b"c" + k, rng.randrange(-50, 50))
        elif r < 0.50:
            f = (b"sadd", b"s" + k, b"m%d" % rng.randrange(10),
                 b"m%d" % rng.randrange(10))
        elif r < 0.58:
            f = (b"hset", b"h" + k, b"f%d" % rng.randrange(6), b"v%d" % i)
        elif r < 0.64:
            f = (b"srem", b"s" + k, b"m%d" % rng.randrange(10))
        elif r < 0.68:
            f = (b"hdel", b"h" + k, b"f%d" % rng.randrange(6))
        elif r < 0.72:
            f = (b"lins", b"l" + k, b"p%04d" % i, b"val%d" % i)
        elif r < 0.74:
            f = (b"lremat", b"l" + k, b"p%04d" % (i - 1))
        elif r < 0.79:
            f = (b"delbytes", b"r" + k)
        elif r < 0.83:
            f = (b"delcnt", b"c" + k, 7, rng.randrange(50))
        elif r < 0.88:
            pay = np.asarray([rng.uniform(-4, 4) for _ in range(8)],
                             dtype=np.float32).tobytes()
            f = (b"tset", b"t" + k, cfg, rng.randrange(1, 5), pay)
        elif r < 0.90:
            f = (b"deltensor", b"t" + k)
        elif r < 0.95:
            f = (b"delset", b"s" + k)       # barrier: breaks runs
        else:
            f = (b"meet", b"10.9.9.%d:7%03d" % (rng.randrange(9), i % 999))
        out.append(f)
    return out


def fill_log(node, bodies, M) -> list:
    for i, body in enumerate(bodies, 1):
        args = [M.Int(a) if isinstance(a, int) else M.Bulk(a)
                for a in body[1:]]
        node.repl_log.push(u(i), body[0], args)
    return node.repl_log.run_after(0, len(bodies) + 1)


def port_node(node_id: int, steady: bool = False) -> Node:
    eng = TorchMergeEngine(device="cpu", resident=True, steady=True,
                           warmup=0) if steady else CpuMergeEngine()
    return Node(node_id=node_id, engine=eng)


def per_frame(entries, node, origin: int = 7):
    ap = CoalescingApplier(node, ReplicaMeta("oracle:1"), max_frames=1)
    prev = 0
    for e in entries:
        ap.apply([PM.Bulk(b"replicate"), PM.Int(origin), PM.Int(prev),
                  PM.Int(e.uuid), PM.Bulk(e.name), *e.args])
        prev = e.uuid
    ap.flush()
    return node


def encodable(bodies):
    return [b for b in bodies if b[0] not in (b"delset", b"meet")]


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The reference's wire codec on its own native packers (its cache
    holds the entry points) for the module's tests that ask for it."""
    ext = build_reference_ext(tmp_path_factory.mktemp("ref_ext"))
    saved = list(RW._WIRE_NATIVE_CACHE)
    RW._WIRE_NATIVE_CACHE[:] = [(ext.wire_pack_blobs,
                                 ext.wire_unpack_blobs)]
    yield ext
    RW._WIRE_NATIVE_CACHE[:] = saved


@pytest.mark.parametrize("seed", (3, 11))
def test_build_wire_batch_bytes_equal_reference(seed):
    bodies = encodable(mixed_bodies(600, seed=seed))
    p_entries = fill_log(port_node(7), bodies, PM)
    r_entries = fill_log(RefNode(node_id=7), bodies, RM)
    payload = PW.build_wire_batch(p_entries, 7)
    assert payload is not None
    assert payload == RW.build_wire_batch(r_entries, 7)
    # a run holding a barrier is declined in both
    both = mixed_bodies(40, seed=seed)
    assert any(b[0] == b"meet" for b in both) or \
        any(b[0] == b"delset" for b in both)
    assert PW.build_wire_batch(fill_log(port_node(7), both, PM), 7) is \
        RW.build_wire_batch(fill_log(RefNode(node_id=7), both, RM), 7) is None


def test_build_wire_batch_bytes_equal_native_reference(ref_native):
    bodies = encodable(mixed_bodies(300, seed=5))
    payload = PW.build_wire_batch(fill_log(port_node(7), bodies, PM), 7)
    assert payload == RW.build_wire_batch(
        fill_log(RefNode(node_id=7), bodies, RM), 7)


@pytest.mark.parametrize("steady", (False, True), ids=("cpu", "torch"))
def test_decode_and_apply_equals_per_frame(steady):
    bodies = encodable(mixed_bodies(600))
    entries = fill_log(port_node(7), bodies, PM)
    payload = PW.build_wire_batch(entries, 7)
    node = port_node(2, steady)
    ap = CoalescingApplier(node, ReplicaMeta("peer:1"), max_frames=64)
    ap.apply_wire_batch([PM.Bulk(b"replbatch"), PM.Int(7),
                         PM.Int(entries[0].prev_uuid),
                         PM.Int(entries[-1].uuid), PM.Int(len(entries)),
                         PM.Bulk(payload)])
    assert ap.meta.uuid_he_sent == entries[-1].uuid
    assert node.stats.repl_wire_batches_in == 1
    want = per_frame(entries, port_node(99)).canonical()
    assert node.canonical() == want
    # the reference's receiver of its own payload
    r_entries = fill_log(RefNode(node_id=7), bodies, RM)
    rnode = RefNode(node_id=2)
    rap = RefApplier(rnode, RefMeta("peer:1"), max_frames=64)
    rap.apply_wire_batch([RM.Bulk(b"replbatch"), RM.Int(7),
                          RM.Int(r_entries[0].prev_uuid),
                          RM.Int(r_entries[-1].uuid),
                          RM.Int(len(r_entries)),
                          RM.Bulk(RW.build_wire_batch(r_entries, 7))])
    assert rnode.canonical() == want
    if steady:
        assert node.engine.dev_rounds_resident == 1


def test_wire_replay_splits_as_the_push_loop():
    """workload.wire_frames: barriers and short runs as single frames,
    encodable runs (at most run_frames ops) as batches; the replay lands
    as the per-frame path does."""
    bodies = mixed_bodies(900, seed=8)
    pusher = port_node(7)
    entries = fill_log(pusher, bodies, PM)
    frames, st = W.wire_frames(pusher, run_frames=64)
    assert st["batch_frames"] + st["single_frames"] == len(bodies)
    assert st["batches"] and st["single_frames"]
    kinds = [f[0].val for f in frames]
    assert all(f[4].val >= 1 and f[4].val <= 64
               for f in frames if f[0].val == b"replbatch")
    singles = [f[4].val for f in frames if f[0].val == b"replicate"]
    assert {b"delset", b"meet"} <= set(singles)
    assert kinds.count(b"replbatch") == st["batches"]
    for steady in (False, True):
        node = port_node(2, steady)
        ap, _wall, _dec = W.wire_replay(frames, node)
        assert ap.meta.uuid_he_sent == entries[-1].uuid
        assert node.canonical() == \
            per_frame(entries, port_node(99)).canonical()


def payload_for_fuzz():
    bodies = encodable(mixed_bodies(40, seed=11))
    entries = fill_log(port_node(7), bodies, PM)
    r_entries = fill_log(RefNode(node_id=7), bodies, RM)
    payload = PW.build_wire_batch(entries, 7)
    assert payload == RW.build_wire_batch(r_entries, 7)
    return payload, entries[0].prev_uuid


def test_every_prefix_truncation_raises_in_both():
    payload, base = payload_for_fuzz()
    ks, rks = port_node(2).ks, RefNode(node_id=2).ks
    for cut in range(len(payload)):
        with pytest.raises(PW.WireFormatError):
            PW.decode_wire_batch(payload[:cut], ks, 7, base)
        with pytest.raises(RW.WireFormatError):
            RW.decode_wire_batch(payload[:cut], rks, 7, base)
    with pytest.raises(PW.WireFormatError):
        PW.decode_wire_batch(payload + b"x", ks, 7, base)
    with pytest.raises(RW.WireFormatError):
        RW.decode_wire_batch(payload + b"x", rks, 7, base)


def test_sampled_bit_flips_raise_in_both():
    payload, base = payload_for_fuzz()
    ks, rks = port_node(2).ks, RefNode(node_id=2).ks
    rng = random.Random(17)
    buf = bytearray(payload)
    for _ in range(300):
        pos = rng.randrange(len(buf))
        bit = 1 << rng.randrange(8)
        buf[pos] ^= bit
        with pytest.raises(PW.WireFormatError):
            PW.decode_wire_batch(bytes(buf), ks, 7, base)
        with pytest.raises(RW.WireFormatError):
            RW.decode_wire_batch(bytes(buf), rks, 7, base)
        buf[pos] ^= bit
    PW.decode_wire_batch(bytes(buf), ks, 7, base)


def blob_columns():
    rng = random.Random(23)
    cols = [[], [None], [b""], [b"a", None, b"bc"]]
    for width in (10, 300, 70_000):   # length widths 1, 2 and 4 bytes
        col = []
        for _ in range(20):
            r = rng.random()
            col.append(None if r < 0.1 else
                       bytes(rng.randrange(256)
                             for _ in range(rng.randrange(0, width)))
                       if width < 1000 else b"z" * rng.randrange(0, width))
        cols.append(col)
    return cols


@pytest.mark.parametrize("col", blob_columns(), ids=lambda c: str(len(c)))
def test_native_and_pure_packers_equal(col, ref_native):
    nat, pure, ref = bytearray(), bytearray(), bytearray()
    PW._pack_blobs(nat, col)
    PW._py_pack_blobs(pure, col)
    RW._pack_blobs(ref, col)
    assert nat == pure == ref
    # the readers: native slice, pure loop, the reference's
    buf = memoryview(bytes(nat) + b"tail")
    a, b = PW._Reader(buf), PW._Reader(buf)
    assert a.blobs(len(col)) == b.py_blobs(len(col)) == col
    assert a.pos == b.pos == len(nat)
    rr = RW._Reader(buf)
    assert rr.blobs(len(col)) == col and rr.pos == len(nat)


def test_declined_shapes_take_the_pure_packer():
    """The C packer declines off-path shapes; the pure packer then
    raises the reference's errors (a demote on the pusher)."""
    for col in ([b"a", "not bytes"], (b"a", b"b")):
        out, ref = bytearray(), bytearray()
        try:
            PW._pack_blobs(out, col)
            got = bytes(out)
        except Exception as e:  # noqa: BLE001 - compared by class name
            got = type(e).__name__
        try:
            RW._pack_blobs(ref, col)
            want = bytes(ref)
        except Exception as e:  # noqa: BLE001
            want = type(e).__name__
        assert got == want
    truncated = memoryview(bytes([1, 5]))
    with pytest.raises(PW.WireFormatError):
        PW._Reader(truncated).blobs(1)
    with pytest.raises(RW.WireFormatError):
        RW._Reader(truncated).blobs(1)
