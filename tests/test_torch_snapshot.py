"""The port's snapshot files against the reference's.

The same inputs, drawn from a seed, through the reference package
(`constdb_tpu`) and the port (`constdb_tpu_torch`): varints and the
compressed container encode to equal bytes and round-trip; the same
keyspace writes byte-equal snapshot files, plain and container, under
either checksum; files of either package load in the other, through the
reference's CpuMergeEngine and the port's TorchMergeEngine on the CPU,
with equal canonical() and equal NodeMeta / ReplicaRecords; truncated
and flipped files raise the same error class in both; and the R-file
catch-up of workload.py equals the reference's in-memory merge of the
same batches.
"""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from constdb_tpu.engine import CpuMergeEngine
from constdb_tpu.engine.tpu import TpuMergeEngine
from constdb_tpu.persist import snapshot as RS
from constdb_tpu.store import KeySpace
from constdb_tpu.utils import compressio as RZ
from constdb_tpu.utils import varint as RV
from constdb_tpu_torch import convert, workload
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.persist import snapshot as PS
from constdb_tpu_torch.store.keyspace import KeySpace as PortKeySpace
from constdb_tpu_torch.utils import compressio as PZ
from constdb_tpu_torch.utils import varint as PV

from test_merge_properties import gen_store
from test_torch_engine import _to_ref, keyspace_dict, sums

ALGS = (1, 2)   # StreamChecksum: CRC64, BLAKE2b-64


def _ints(seed):
    rng = np.random.default_rng(seed)
    edges = [0, 1, 63, 64, 16383, 16384, (1 << 30) - 1, 1 << 30,
             (1 << 63) - 1]
    rand = rng.integers(0, 1 << 63, 200, dtype=np.int64).tolist()
    small = rng.integers(0, 1 << 16, 200).tolist()
    return edges + rand + small


def test_varint_roundtrip_equals_reference():
    vals = _ints(1)
    for v in vals + [(1 << 64) - 1]:
        a, b = bytearray(), bytearray()
        RV.write_uvarint(a, v)
        PV.write_uvarint(b, v)
        assert a == b
        assert PV.read_uvarint(bytes(b), 0) == (v, len(b))
    for v in vals + [-x for x in vals] + [-(1 << 63)]:
        a, b = bytearray(), bytearray()
        RV.write_varint(a, v)
        PV.write_varint(b, v)
        assert a == b
        r = PV.VarintReader(bytes(b))
        assert r.varint() == v and r.remaining == 0
    # the same malformed inputs fail the same way
    for bad in (b"\x40\x01", b"\x80\x00\x00\x01", b"\xc1" + bytes(8),
                b"\xc0" + bytes(8), b"\x40", b"\x80\x01"):
        errs = []
        for mod in (RV, PV):
            try:
                mod.read_uvarint(bad, 0)
                errs.append(None)
            except (ValueError, IndexError) as e:
                errs.append(type(e).__name__)
        assert errs[0] is not None and errs[0] == errs[1]


def _blob(seed, n):
    """Bytes that look like snapshot sections: i64 planes and text."""
    rng = np.random.default_rng(seed)
    planes = (np.arange(n // 16, dtype=np.int64) * 977 + (1 << 52)).tobytes()
    text = b"".join(b"key%08d" % i for i in rng.integers(0, 10**8, n // 22))
    return planes + text + rng.integers(0, 256, 37, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("filt", ["none", "transpose", "auto"])
@pytest.mark.parametrize("alg", ["zlib", "lzma"])
def test_compressio_roundtrip_equals_reference(alg, filt):
    data = _blob(2, 300_000)
    a = RZ.compress_bytes(data, level=1, chunk=1 << 16, filt=filt, alg=alg)
    b = PZ.compress_bytes(data, level=1, chunk=1 << 16, filt=filt, alg=alg)
    assert a == b and PZ.is_compressed(b)
    assert PZ.decompress_bytes(a) == RZ.decompress_bytes(b) == data
    # the streaming writer and reader, read in uneven pieces
    fa, fb = io.BytesIO(), io.BytesIO()
    for mod, f in ((RZ, fa), (PZ, fb)):
        w = mod.CompressWriter(f, level=1, chunk=1 << 16, filt=filt, alg=alg)
        for lo in range(0, len(data), 70_001):
            w.write(data[lo:lo + 70_001])
        w.finish()
    assert fa.getvalue() == fb.getvalue()
    r = PZ.DecompressReader(io.BytesIO(fb.getvalue()))
    got = b"".join(iter(lambda: r.read(50_000), b""))
    assert got == data
    # a flipped byte and a truncation raise the format error in both
    for broken in (b[:-1], b[:len(b) // 2], b[:30] + bytes([b[30] ^ 1]) +
                   b[31:]):
        for mod in (RZ, PZ):
            with pytest.raises(mod.CompressFormatError):
                mod.decompress_bytes(broken)


def _stores():
    """name -> reference KeySpace: a random op-built store (every
    encoding, tensors, tombstones), and a make_workload catch-up whose
    bytes columns are all None, none None, and mixed."""
    out = {"ops": gen_store(5, 1, 300)}
    ks = KeySpace()
    eng = CpuMergeEngine()
    for b in workload.make_workload(700, 2, seed=3):
        eng.merge(ks, _to_ref(b))
    out["workload"] = ks
    return out


_STORES: dict = {}


def _store(name):
    if not _STORES:
        _STORES.update(_stores())
    return _STORES[name]


def _meta(mod):
    return mod.NodeMeta(node_id=3, alias="n3", addr="127.0.0.1:7003",
                        repl_last_uuid=(1 << 60) + 5)


def _records(mod):
    return [mod.ReplicaRecord(addr="10.0.0.%d:70" % i, node_id=i,
                              alias="r%d" % i, add_t=i << 22, del_t=0,
                              uuid_he_sent=i * 7, uuid_he_acked=i * 5)
            for i in (1, 2)]


def _write(mod, ks, alg, container, chunk_keys=64):
    f = io.BytesIO()
    w = mod.SnapshotWriter(f, compress_level=0 if container else 1,
                           alg=alg, container_level=1 if container else 0)
    w.write_node(_meta(mod))
    w.write_replicas(_records(mod))
    for c in mod.iter_keyspace_chunks(ks, chunk_keys):
        w.write_chunk(c)
    w.finish()
    return f.getvalue()


@pytest.mark.parametrize("container", [False, True],
                         ids=["plain", "container"])
@pytest.mark.parametrize("alg", ALGS)
@pytest.mark.parametrize("name", ["ops", "workload"])
def test_same_keyspace_writes_byte_equal_files(name, alg, container):
    ref = _store(name)
    port = convert.keyspace_from_dict(keyspace_dict(ref))
    a = _write(RS, ref, alg, container)
    b = _write(PS, port, alg, container)
    assert a == b
    if not container:
        assert b[8] == alg


def _asdict(x):
    return dataclasses.asdict(x)


def _load_all(path):
    """The file loaded through the reference's CpuMergeEngine and the
    port's TorchMergeEngine on the CPU: -> [(meta, records, canonical,
    sums)] for each."""
    out = []
    ks = KeySpace()
    meta, recs = RS.load_snapshot(path, ks, engine=CpuMergeEngine())
    out.append((_asdict(meta), [_asdict(r) for r in recs], ks.canonical(),
                sums(ks)))
    for fold in ("auto", "cuda"):
        pk = PortKeySpace()
        eng = TorchMergeEngine(resident=True, dense_fold=fold, device="cpu")
        meta, recs = PS.load_snapshot(path, pk, engine=eng)
        eng.close()
        out.append((_asdict(meta), [_asdict(r) for r in recs],
                    pk.canonical(), sums(pk)))
    pk = PortKeySpace()
    meta, recs = PS.load_snapshot(path, pk, device="cpu")
    out.append((_asdict(meta), [_asdict(r) for r in recs], pk.canonical(),
                sums(pk)))
    return out


@pytest.mark.parametrize("container", [0, 1], ids=["plain", "container"])
@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("name", ["ops", "workload"])
def test_files_load_across_packages(tmp_path, name, writer, container):
    ref = _store(name)
    path = str(tmp_path / "dump.snapshot")
    if writer == "reference":
        size = RS.dump_keyspace(path, ref, _meta(RS), _records(RS),
                                chunk_keys=100, container_level=container)
    else:
        port = convert.keyspace_from_dict(keyspace_dict(ref))
        size = PS.dump_keyspace(path, port, _meta(PS), _records(PS),
                                chunk_keys=100, container_level=container)
    assert size == os.path.getsize(path)
    want = (_asdict(_meta(RS)), [_asdict(r) for r in _records(RS)],
            ref.canonical(), sums(ref))
    for got in _load_all(path):
        assert got == want


def _outcome(mod, data):
    try:
        for _ in mod.SnapshotLoader(io.BytesIO(data)):
            pass
    except Exception as e:   # the class is what the test compares
        return type(e).__name__
    return None


@pytest.mark.parametrize("container", [False, True],
                         ids=["plain", "container"])
def test_truncation_and_flips_raise_the_same_errors(container):
    ref = _store("workload")
    port = convert.keyspace_from_dict(keyspace_dict(ref))
    data = _write(PS, port, 1, container, chunk_keys=200)
    assert data == _write(RS, ref, 1, container, chunk_keys=200)
    assert _outcome(PS, data) is None
    n = len(data)
    rng = np.random.default_rng(6)
    cuts = [0, 1, 8, 9, 12, n // 3, n // 2, n - 9, n - 8, n - 1] + \
        rng.integers(1, n, 10).tolist()
    seen = set()
    for cut in cuts:
        want = _outcome(RS, data[:cut])
        assert _outcome(PS, data[:cut]) == want
        # both loaders stop at the inner digest and never read the
        # container's 4-byte end marker
        assert want == (None if container and cut >= n - 4
                        else "InvalidSnapshot")
    flips = [9, 11, n // 2, n - 9, n - 1] + rng.integers(9, n, 20).tolist()
    for at in flips:
        bad = data[:at] + bytes([data[at] ^ 0x10]) + data[at + 1:]
        want = _outcome(RS, bad)
        assert _outcome(PS, bad) == want
        if container and at >= n - 4:
            assert want is None   # the unread end marker, as above
        else:
            assert want in ("InvalidSnapshot", "InvalidSnapshotChecksum")
        seen.add(want)
    assert "InvalidSnapshotChecksum" in seen or container


def test_load_snapshot_without_engine_needs_a_card(tmp_path, monkeypatch):
    path = str(tmp_path / "x.snapshot")
    PS.dump_keyspace(path, convert.keyspace_from_dict(
        keyspace_dict(_store("ops"))), _meta(PS))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.load_snapshot(path, PortKeySpace())


def test_sharded_store_gets_raw_sections(tmp_path):
    """The duck-typed sharded branch: raw BATCH payloads go to the store,
    which then flushes; no engine is built."""
    path = str(tmp_path / "x.snapshot")
    port = convert.keyspace_from_dict(keyspace_dict(_store("ops")))
    PS.dump_keyspace(path, port, _meta(PS), chunk_keys=16)

    class Sharded:
        n_shards = 2

        def __init__(self):
            self.raw, self.flushed = [], 0

        def submit(self, *_):
            raise AssertionError("decoded batches go through submit_raw")

        def submit_raw(self, payload):
            self.raw.append(payload)

        def flush(self):
            self.flushed += 1

    s = Sharded()
    meta, recs = PS.load_snapshot(path, s)
    assert meta == _meta(PS) and recs == [] and s.flushed == 1
    pk = PortKeySpace()
    eng = TorchMergeEngine(resident=False, device="cpu")
    for p in s.raw:
        eng.merge(pk, PS._decode_batch(p))
    eng.flush(pk)
    assert pk.canonical() == port.canonical()


@pytest.mark.parametrize("fold", ["cuda", "auto"])
def test_file_catchup_equals_reference_in_memory_merge(tmp_path, fold):
    """R = 4 replica files through workload.file_catchup on the CPU equal
    the reference TpuMergeEngine(dense_fold="xla")'s in-memory merge of
    the same batches in the same groups."""
    n, R, chunk = 3000, 4, 512
    bs = workload.make_workload(n, R, seed=8, aligned_counters=True)
    paths = workload.write_replica_files(bs, str(tmp_path), chunk)
    group = R if fold == "cuda" else 4 * R
    eng = TorchMergeEngine(resident=True, dense_fold=fold, device="cpu")
    pk = PortKeySpace()
    res = workload.file_catchup(eng, pk, paths, group)
    eng.close()
    assert res["metas"] == [workload.replica_meta(r) for r in range(R)]
    assert res["records"] == [[]] * R
    assert res["chunks"] == R * -(-n // chunk) and res["decode_s"] > 0
    assert eng.folds > 0

    ref_chunks = [_to_ref(c) for c in workload.chunk_batches(bs, chunk)]
    ref = TpuMergeEngine(dense_fold="xla", steady=False)
    ks = KeySpace()
    for i in range(0, len(ref_chunks), group):
        ref.merge_many(ks, ref_chunks[i:i + group])
    ref.flush(ks)
    assert pk.canonical() == ks.canonical()
    assert sums(pk) == sums(ks)
