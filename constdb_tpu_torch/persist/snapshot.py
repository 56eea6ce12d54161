"""Chunked columnar snapshot format: writer, loader, dump/restore.

The port's own copy of the reference package's persist/snapshot.py: the
same file format, byte for byte, so files written by either package load
in the other.  The body is a sequence of CHUNK sections, each holding a
`ColumnarBatch` slice of the keyspace — numeric planes as raw
little-endian i64 columns (zlib-compressed), bytes planes as
length-column + blob.  A loaded chunk goes straight into
`MergeEngine.merge` without per-row Python work on the numeric planes,
so snapshot ingest rides the batched merge path (engine/cuda.py).

File layout (all multi-byte scalars big-endian varints per utils/varint.py,
bulk columns little-endian raw):

    magic   b"CSTPU1\\n\\x00" (8 bytes)
    alg     1 byte — checksum algorithm tag (utils/checksum.StreamChecksum)
    section*:
        kind    1 byte  (1=NODE, 2=REPLICAS, 3=BATCH)
        flag    1 byte  (0=raw payload, 1=zlib payload)
        length  uvarint (stored payload bytes)
        payload
    end     1 byte 0xFF
    digest  8 bytes big-endian — checksum of every byte above (magic
            through the end marker)

The checksum covers the whole stream, so a loader that streams chunks into
an engine learns of corruption only at the end marker — callers that merge
into a live store must treat `InvalidSnapshotChecksum` as "discard the
store" (load_snapshot targets fresh keyspaces).  Truncation anywhere
raises `InvalidSnapshot` immediately.

Compressed container: a snapshot stream may be wrapped whole in the
chunked compression framing of utils/compressio.py (`container_level` on
the writer entry points).  The container is magic-tagged (b"CSTPUZ1\\n"
vs the plain b"CSTPU1\\n\\x00"), so `SnapshotLoader` sniffs the first
bytes and reads either transparently.  Whole-stream compression folds
cross-section redundancy (the columnar key/uuid planes repeat across
chunks); container dumps therefore write their inner sections raw
(compress_level=0) rather than compressing twice.

`load_snapshot` differs from the reference on purpose: with no engine it
builds a `TorchMergeEngine` on `device` (default CUDA, which raises
without a card) instead of a CPU engine.
"""

from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import IO, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..engine.base import (ColumnarBatch, batch_from_keyspace,
                           has_values)
from ..errors import InvalidSnapshot, InvalidSnapshotChecksum
from ..utils.checksum import StreamChecksum
from ..utils.compressio import (CompressFormatError, DecompressReader,
                                is_compressed)
from ..utils.varint import VarintReader, write_uvarint

_I64 = np.int64

MAGIC = b"CSTPU1\n\x00"
SEC_NODE = 1
SEC_REPLICAS = 2
SEC_BATCH = 3
SEC_END = 0xFF

# a stored section larger than this is corruption, not data (guards the
# loader against allocating on a bit-flipped length field)
_MAX_SECTION = 1 << 31

_KIND_NAMES = {SEC_NODE: "node", SEC_REPLICAS: "replicas", SEC_BATCH: "batch"}


@dataclass
class NodeMeta:
    """NODE section: the dumping node's identity + replication watermark
    ahead of the body)."""

    node_id: int = 0
    alias: str = ""
    addr: str = ""
    repl_last_uuid: int = 0


@dataclass
class ReplicaRecord:
    """One row of the REPLICAS section: membership LWW state + the pull
    watermarks a restored node resumes from (reference
    src/replica/replica.rs:131-147 ReplicaMeta, persisted subset)."""

    addr: str
    node_id: int = 0
    alias: str = ""
    add_t: int = 0
    del_t: int = 0
    uuid_he_sent: int = 0
    uuid_he_acked: int = 0


# --------------------------------------------------------------------------
# payload primitives


def _write_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    write_uvarint(out, len(b))
    out += b


def _read_str(r: VarintReader) -> str:
    return r.take(r.uvarint()).decode("utf-8", "replace")


def _write_i64_col(out: bytearray, arr: np.ndarray) -> None:
    out += np.ascontiguousarray(arr, dtype="<i8").tobytes()


def _read_i64_col(r: VarintReader, n: int) -> np.ndarray:
    return np.frombuffer(r.take(8 * n), dtype="<i8")


def _write_bytes_list(out: bytearray, items: list) -> None:
    """None-able bytes column: i32 length-plus-one per slot (0 encodes
    None, so empty bytes stay distinct — tests/test_snapshot.py
    test_none_values_roundtrip), then the concatenated blob.

    Vectorized: the original per-item numpy scalar-assignment loop cost
    ~1µs/slot, which put snapshot ENCODING on the critical path of the
    sharded merge fan-out (the parent encodes every chunk for the shard
    workers) — ~0.5s per 131k-key chunk, slower than the merge itself.
    The common all-None / no-None columns now skip per-item Python
    entirely (list.count and map(len) run at C speed)."""
    n = len(items)
    n_none = items.count(None)
    if n_none == n:
        out += b"\x00" * (4 * n)
        return
    if n_none == 0:
        lens = np.fromiter(map(len, items), dtype="<i4", count=n)
        lens += 1
        out += lens.tobytes()
        out += b"".join(items)
        return
    lens = np.fromiter((0 if b is None else len(b) + 1 for b in items),
                       dtype="<i4", count=n)
    out += lens.tobytes()
    out += b"".join(b for b in items if b is not None)


def _read_bytes_list(r: VarintReader, n: int) -> list:
    lens = np.frombuffer(r.take(4 * n), dtype="<i4")
    # reject corruption at the section: one negative slot length would walk
    # `pos` backwards below, silently mis-slicing every later value (only
    # caught — maybe — by the end-of-stream checksum); the aggregate total
    # check alone misses mixed positive/negative corruption
    if n and bool((lens < 0).any()):
        raise ValueError("negative bytes-column slot length")
    if n and not lens.any():
        return [None] * n  # all-None column: no blob, no per-item loop
    total = int(lens.sum()) - int(np.count_nonzero(lens)) if n else 0
    if total < 0:
        raise ValueError("negative bytes-column length")
    blob = r.take(total)
    out: list = []
    pos = 0
    for ln in lens.tolist():
        if ln == 0:
            out.append(None)
        else:
            end = pos + ln - 1
            out.append(blob[pos:end])
            pos = end
    return out


def _encode_node(meta: NodeMeta) -> bytearray:
    out = bytearray()
    write_uvarint(out, meta.node_id)
    _write_str(out, meta.alias)
    _write_str(out, meta.addr)
    write_uvarint(out, meta.repl_last_uuid)
    return out


def _decode_node(payload: bytes) -> NodeMeta:
    r = VarintReader(payload)
    return NodeMeta(node_id=r.uvarint(), alias=_read_str(r),
                    addr=_read_str(r), repl_last_uuid=r.uvarint())


def _encode_replicas(records: Iterable[ReplicaRecord]) -> bytearray:
    records = list(records)
    out = bytearray()
    write_uvarint(out, len(records))
    for rec in records:
        _write_str(out, rec.addr)
        write_uvarint(out, rec.node_id)
        _write_str(out, rec.alias)
        write_uvarint(out, rec.add_t)
        write_uvarint(out, rec.del_t)
        write_uvarint(out, rec.uuid_he_sent)
        write_uvarint(out, rec.uuid_he_acked)
    return out


def _decode_replicas(payload: bytes) -> List[ReplicaRecord]:
    r = VarintReader(payload)
    return [ReplicaRecord(addr=_read_str(r), node_id=r.uvarint(),
                          alias=_read_str(r), add_t=r.uvarint(),
                          del_t=r.uvarint(), uuid_he_sent=r.uvarint(),
                          uuid_he_acked=r.uvarint())
            for _ in range(r.uvarint())]


def _encode_batch(b: ColumnarBatch, skip_keys: bool = False,
                  skip_members: bool = False) -> bytearray:
    """`skip_keys` / `skip_members`: omit the key / member bytes planes
    entirely (not even length columns).  Snapshot FILES never skip — the
    on-disk format is unchanged; the sharded-merge transport
    (parallel/host_pool.py) skips planes that replica chunks share and
    ships each exactly once per job, with the decoder receiving them via
    the matching `_decode_batch` kwargs."""
    out = bytearray()
    n = b.n_keys
    write_uvarint(out, n)
    if not skip_keys:
        _write_bytes_list(out, b.keys)
    out += np.ascontiguousarray(b.key_enc, dtype=np.int8).tobytes()
    for col in (b.key_ct, b.key_mt, b.key_dt, b.key_expire, b.reg_t,
                b.reg_node):
        _write_i64_col(out, col)
    _write_bytes_list(out, b.reg_val)

    write_uvarint(out, len(b.cnt_ki))
    for col in (b.cnt_ki, b.cnt_node, b.cnt_val, b.cnt_uuid, b.cnt_base,
                b.cnt_base_t):
        _write_i64_col(out, col)

    write_uvarint(out, len(b.el_ki))
    for col in (b.el_ki, b.el_add_t, b.el_add_node, b.el_del_t):
        _write_i64_col(out, col)
    if not skip_members:
        _write_bytes_list(out, b.el_member)
    _write_bytes_list(out, b.el_val)

    write_uvarint(out, len(b.del_keys))
    _write_bytes_list(out, b.del_keys)
    _write_i64_col(out, b.del_t)
    out.append(1 if b.rows_unique_per_slot else 0)

    # tensor planes (always written — one varint when empty; decoders
    # treat an exhausted payload as zero rows, so pre-tensor snapshot
    # FILES stay loadable)
    nt = len(b.tns_ki)
    write_uvarint(out, nt)
    if nt:
        for col in (b.tns_ki, b.tns_node, b.tns_uuid, b.tns_cnt):
            _write_i64_col(out, col)
        _write_bytes_list(out, list(b.tns_cfg))
        _write_bytes_list(out, [p.tobytes() if isinstance(p, np.ndarray)
                                else p for p in b.tns_payload])
    return out


def _decode_batch(payload: bytes, keys: Optional[list] = None,
                  el_member: Optional[list] = None) -> ColumnarBatch:
    """`keys` / `el_member`: externally-supplied bytes planes for a
    payload encoded with the matching skip flag (shared planes decoded
    once per job by the shard workers).  The returned batch references
    the supplied lists directly — callers must treat them read-only."""
    r = VarintReader(payload)
    b = ColumnarBatch()
    n = r.uvarint()
    if keys is None:
        b.keys = _read_bytes_list(r, n)
    else:
        if len(keys) != n:
            raise ValueError("supplied keys plane length mismatch")
        b.keys = keys
    b.key_enc = np.frombuffer(r.take(n), dtype=np.int8)
    b.key_ct = _read_i64_col(r, n)
    b.key_mt = _read_i64_col(r, n)
    b.key_dt = _read_i64_col(r, n)
    b.key_expire = _read_i64_col(r, n)
    b.reg_t = _read_i64_col(r, n)
    b.reg_node = _read_i64_col(r, n)
    b.reg_val = _read_bytes_list(r, n)

    nc = r.uvarint()
    b.cnt_ki = _read_i64_col(r, nc)
    b.cnt_node = _read_i64_col(r, nc)
    b.cnt_val = _read_i64_col(r, nc)
    b.cnt_uuid = _read_i64_col(r, nc)
    b.cnt_base = _read_i64_col(r, nc)
    b.cnt_base_t = _read_i64_col(r, nc)

    ne = r.uvarint()
    b.el_ki = _read_i64_col(r, ne)
    b.el_add_t = _read_i64_col(r, ne)
    b.el_add_node = _read_i64_col(r, ne)
    b.el_del_t = _read_i64_col(r, ne)
    if el_member is None:
        b.el_member = _read_bytes_list(r, ne)
    else:
        if len(el_member) != ne:
            raise ValueError("supplied member plane length mismatch")
        b.el_member = el_member
    b.el_val = _read_bytes_list(r, ne)

    nd = r.uvarint()
    b.del_keys = _read_bytes_list(r, nd)
    b.del_t = _read_i64_col(r, nd)
    b.rows_unique_per_slot = bool(r.byte())
    if r.pos < len(r.buf):  # tensor planes (absent in pre-tensor files)
        nt = r.uvarint()
        if nt:
            b.tns_ki = _read_i64_col(r, nt)
            b.tns_node = _read_i64_col(r, nt)
            b.tns_uuid = _read_i64_col(r, nt)
            b.tns_cnt = _read_i64_col(r, nt)
            b.tns_cfg = _read_bytes_list(r, nt)
            b.tns_payload = _read_bytes_list(r, nt)
    return b


# --------------------------------------------------------------------------
# chunking


def batch_chunks(batch: ColumnarBatch,
                 chunk_keys: int) -> Iterator[ColumnarBatch]:
    """Split a batch into key-range chunks of at most `chunk_keys` keys.

    Chunk boundaries are positional, so chunks of same-shape batches from
    different replicas stay slot-ALIGNED (the engine's fused dense-fold
    path relies on this — engine/tpu.py merge_many).  Counter/element rows
    are routed to the chunk owning their key and re-indexed chunk-locally;
    key-level delete tombstones ride the first chunk (merge order is
    immaterial: every component merge is commutative).
    """
    n = batch.n_keys
    if chunk_keys <= 0:
        chunk_keys = max(n, 1)

    if n == 0:
        if batch.del_keys:
            c = ColumnarBatch()
            c.rows_unique_per_slot = batch.rows_unique_per_slot
            c.del_keys = list(batch.del_keys)
            c.del_t = np.asarray(batch.del_t, dtype=_I64)
            yield c
        return

    # each chunk is a searchsorted slice.  When a plane's key ids are
    # already non-decreasing (true for keyspace dumps built in kid order,
    # and the common case generally) the slice is CONTIGUOUS: columns
    # become zero-copy views and the bytes lists plain list slices —
    # otherwise one stable sort per plane fixes the order first.
    cnt_arr = np.asarray(batch.cnt_ki)
    cnt_presorted = bool(len(cnt_arr) == 0 or (np.diff(cnt_arr) >= 0).all())
    cnt_order = None if cnt_presorted else np.argsort(cnt_arr, kind="stable")
    cnt_sorted = cnt_arr if cnt_presorted else cnt_arr[cnt_order]
    el_arr = np.asarray(batch.el_ki)
    el_presorted = bool(len(el_arr) == 0 or (np.diff(el_arr) >= 0).all())
    el_order = None if el_presorted else np.argsort(el_arr, kind="stable")
    el_sorted = el_arr if el_presorted else el_arr[el_order]
    tns_arr = np.asarray(batch.tns_ki)
    tns_presorted = bool(len(tns_arr) == 0
                         or (np.diff(tns_arr) >= 0).all())
    tns_order = None if tns_presorted \
        else np.argsort(tns_arr, kind="stable")
    tns_sorted = tns_arr if tns_presorted else tns_arr[tns_order]
    # one values scan for the whole batch; chunks inherit the hint (the
    # engine otherwise rescans per chunk per replica)
    el_hv = batch.el_has_vals
    if el_hv is None:
        el_hv = has_values(batch.el_val)

    for lo in range(0, n, chunk_keys):
        hi = min(n, lo + chunk_keys)
        c = ColumnarBatch()
        c.rows_unique_per_slot = batch.rows_unique_per_slot
        # identity tokens: replica chunks sliced from SHARED plane objects
        # compare equal, so the engine resolves each shape once (the
        # parent objects stay alive through the chunk's plane views)
        c.key_shape = (id(batch.keys), id(batch.key_enc), lo, hi)
        c.el_shape = (id(batch.el_ki), id(batch.el_member), lo, hi)
        c.shape_refs = (batch.keys, batch.key_enc, batch.el_ki,
                        batch.el_member)
        c.el_has_vals = el_hv
        c.keys = batch.keys[lo:hi]
        c.key_enc = batch.key_enc[lo:hi]
        c.key_ct = batch.key_ct[lo:hi]
        c.key_mt = batch.key_mt[lo:hi]
        c.key_dt = batch.key_dt[lo:hi]
        c.key_expire = batch.key_expire[lo:hi]
        c.reg_val = batch.reg_val[lo:hi]
        c.reg_t = batch.reg_t[lo:hi]
        c.reg_node = batch.reg_node[lo:hi]

        a, z = (int(x) for x in np.searchsorted(cnt_sorted, (lo, hi)))
        rows = slice(a, z) if cnt_presorted else cnt_order[a:z]
        c.cnt_ki = cnt_arr[rows] - lo
        c.cnt_node = np.asarray(batch.cnt_node)[rows]
        c.cnt_val = np.asarray(batch.cnt_val)[rows]
        c.cnt_uuid = np.asarray(batch.cnt_uuid)[rows]
        c.cnt_base = np.asarray(batch.cnt_base)[rows]
        c.cnt_base_t = np.asarray(batch.cnt_base_t)[rows]

        a, z = (int(x) for x in np.searchsorted(el_sorted, (lo, hi)))
        if el_presorted:
            rows = slice(a, z)
            c.el_member = batch.el_member[a:z]
            c.el_val = batch.el_val[a:z]
        else:
            rows = el_order[a:z]
            idx = rows.tolist()
            c.el_member = [batch.el_member[i] for i in idx]
            c.el_val = [batch.el_val[i] for i in idx]
        c.el_ki = el_arr[rows] - lo
        c.el_add_t = np.asarray(batch.el_add_t)[rows]
        c.el_add_node = np.asarray(batch.el_add_node)[rows]
        c.el_del_t = np.asarray(batch.el_del_t)[rows]

        if len(tns_arr):
            a, z = (int(x) for x in np.searchsorted(tns_sorted, (lo, hi)))
            if tns_presorted:
                rows = slice(a, z)
                c.tns_cfg = batch.tns_cfg[a:z]
                c.tns_payload = batch.tns_payload[a:z]
            else:
                rows = tns_order[a:z]
                idx = rows.tolist()
                c.tns_cfg = [batch.tns_cfg[i] for i in idx]
                c.tns_payload = [batch.tns_payload[i] for i in idx]
            c.tns_ki = tns_arr[rows] - lo
            c.tns_node = np.asarray(batch.tns_node)[rows]
            c.tns_uuid = np.asarray(batch.tns_uuid)[rows]
            c.tns_cnt = np.asarray(batch.tns_cnt)[rows]

        if lo == 0 and batch.del_keys:
            c.del_keys = list(batch.del_keys)
            c.del_t = np.asarray(batch.del_t, dtype=_I64)
        yield c


def iter_keyspace_chunks(ks, chunk_keys: int = 1 << 16,
                         include_deletes: bool = True) -> Iterator[ColumnarBatch]:
    """Chunked columnar dump of a keyspace (the snapshot body producer —
    reference src/server.rs:183-220 walks the DB per key instead)."""
    yield from batch_chunks(batch_from_keyspace(ks, include_deletes),
                            chunk_keys)


# --------------------------------------------------------------------------
# writer


class SnapshotWriter:
    """Streams sections to any binary file object with a running checksum
    (reference src/snapshot.rs:9-69 `checksum_writter`; ours tags the
    algorithm in the header so native CRC64 and the hashlib fallback
    interoperate)."""

    def __init__(self, f: IO[bytes], compress_level: int = 1,
                 alg: Optional[int] = None, container_level: int = 0):
        self._zw = None
        if container_level > 0:
            # compressed container: the WHOLE inner stream (magic
            # through digest) rides the chunked framing; callers
            # normally pair this with compress_level=0 so sections are
            # not compressed twice (module docstring)
            from ..utils.compressio import CompressWriter
            self._zw = CompressWriter(f, level=container_level,
                                      chunk=1 << 20)
            f = self._zw
        self._f = f
        self._level = compress_level
        self._sum = StreamChecksum(alg)
        self._finished = False
        header = MAGIC + bytes([self._sum.alg])
        self._emit(header)

    def _emit(self, data: bytes) -> None:
        self._sum.update(data)
        self._f.write(data)

    def _section(self, kind: int, payload: bytearray) -> None:
        assert not self._finished, "writer already finished"
        flag = 0
        body = bytes(payload)
        if self._level > 0:
            packed = zlib.compress(body, self._level)
            if len(packed) < len(body):
                flag, body = 1, packed
        head = bytearray([kind, flag])
        write_uvarint(head, len(body))
        self._emit(bytes(head))
        self._emit(body)

    def write_node(self, meta: NodeMeta) -> None:
        self._section(SEC_NODE, _encode_node(meta))

    def write_replicas(self, records: Iterable[ReplicaRecord]) -> None:
        self._section(SEC_REPLICAS, _encode_replicas(records))

    def write_chunk(self, batch: ColumnarBatch) -> None:
        self._section(SEC_BATCH, _encode_batch(batch))

    def write_chunk_raw(self, payload: bytes) -> None:
        """A BATCH section from an already-encoded (uncompressed) batch
        payload, written without a decode/re-encode round trip (the
        reference's delta sync writes shard workers' bucket exports this
        way)."""
        self._section(SEC_BATCH, bytearray(payload))

    def finish(self) -> None:
        """End marker + digest.  The digest covers the marker, so dropping
        trailing sections can't go unnoticed.  A container writer is
        finished AFTER the digest — the whole inner stream, digest
        included, rides the validated chunk framing."""
        self._emit(bytes([SEC_END]))
        self._f.write(self._sum.digest().to_bytes(8, "big"))
        if self._zw is not None:
            self._zw.finish()
        self._finished = True


# --------------------------------------------------------------------------
# loader


class SnapshotLoader:
    """Incremental section iterator over a binary file object.

    Yields `(kind, payload)` with kind in {"node", "replicas", "batch"} and
    payload NodeMeta / list[ReplicaRecord] / ColumnarBatch.  Magic is
    validated at construction; every malformed or truncated byte raises
    `InvalidSnapshot(offset)`; the end-marker digest raises
    `InvalidSnapshotChecksum` on mismatch (reference
    src/snapshot.rs:100-301).  Batch numeric columns are zero-copy
    read-only views over the section payload — engines only read them.
    """

    def __init__(self, f: IO[bytes], raw_batches: bool = False):
        """`raw_batches`: yield BATCH sections as ("batch_raw", payload
        bytes) without decoding — the sharded ingest path ships the
        payload to worker processes, which decode in parallel (the parent
        then pays only the read + decompress)."""
        self._off = 0
        self._done = False
        self._raw = raw_batches
        # container sniff: a compressed container wraps a whole plain
        # snapshot stream — read THROUGH the validating inflater, so
        # every consumer (boot restore, sync spill apply, sharded
        # ingest) handles both formats without knowing which it got
        first = f.read(len(MAGIC))
        if len(first) == len(MAGIC) and is_compressed(first):
            try:
                self._f = DecompressReader(f, head=first)
            except CompressFormatError:
                raise InvalidSnapshot(0) from None
            first = b""
        else:
            self._f = f
        self._off = len(first)
        head = first + self._read(len(MAGIC) + 1 - len(first),
                                  checked=False)
        if head[: len(MAGIC)] != MAGIC:
            raise InvalidSnapshot(0)
        try:
            self._sum = StreamChecksum(head[len(MAGIC)])
        except ValueError:
            raise InvalidSnapshot(len(MAGIC)) from None
        self._sum.update(head)

    def _read(self, n: int, checked: bool = True) -> bytes:
        try:
            data = self._f.read(n)
        except CompressFormatError:
            # a corrupt container chunk is snapshot corruption: surface
            # it through the loader's normal quarantine class
            raise InvalidSnapshot(self._off) from None
        if len(data) != n:
            raise InvalidSnapshot(self._off + len(data))
        self._off += n
        if checked:
            self._sum.update(data)
        return data

    def _read_uvarint(self) -> int:
        first = self._read(1)
        tag = first[0] >> 6
        extra = (0, 1, 3, 8)[tag]
        buf = first + (self._read(extra) if extra else b"")
        try:
            return VarintReader(buf).uvarint()
        except (ValueError, IndexError):
            raise InvalidSnapshot(self._off) from None

    def __iter__(self) -> Iterator[Tuple[str, object]]:
        return self

    def __next__(self) -> Tuple[str, object]:
        if self._done:
            raise StopIteration
        kind = self._read(1)[0]
        if kind == SEC_END:
            try:
                digest = self._f.read(8)
            except CompressFormatError:
                raise InvalidSnapshot(self._off) from None
            if len(digest) != 8:
                raise InvalidSnapshot(self._off + len(digest))
            self._off += 8
            if int.from_bytes(digest, "big") != self._sum.digest():
                raise InvalidSnapshotChecksum()
            self._done = True
            raise StopIteration
        name = _KIND_NAMES.get(kind)
        if name is None:
            raise InvalidSnapshot(self._off - 1)
        flag = self._read(1)[0]
        length = self._read_uvarint()
        if flag not in (0, 1) or length > _MAX_SECTION:
            raise InvalidSnapshot(self._off)
        payload = self._read(length)
        try:
            if flag == 1:
                # bound the inflated size too: this format arrives over the
                # network during full sync, and zlib expands up to ~1032x —
                # a corrupt length must not OOM the node before the
                # end-of-stream digest can reject the file
                d = zlib.decompressobj()
                payload = d.decompress(payload, _MAX_SECTION)
                if d.unconsumed_tail:
                    raise ValueError("decompressed section exceeds size cap")
            if kind == SEC_NODE:
                return name, _decode_node(payload)
            if kind == SEC_REPLICAS:
                return name, _decode_replicas(payload)
            if self._raw:
                return "batch_raw", payload
            return name, _decode_batch(payload)
        except (zlib.error, ValueError, IndexError) as e:
            raise InvalidSnapshot(self._off) from e


# --------------------------------------------------------------------------
# high-level dump / restore


def _fsync_parent_dir(path: str) -> None:
    """fsync the directory holding `path`: os.replace makes the rename
    ATOMIC but not DURABLE — until the directory entry itself is synced,
    a crash can roll the rename back and the just-written snapshot is
    gone (its tmp name was already unlinked).  POSIX requires an fsync
    on the directory fd to pin the entry."""
    d = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic fs without dir-open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def dump_keyspace(path: str, ks, meta: NodeMeta,
                  replicas: Iterable[ReplicaRecord] = (),
                  chunk_keys: int = 1 << 16,
                  compress_level: int = 1,
                  fsync: bool = False,
                  container_level: int = 0) -> int:
    """Atomic whole-keyspace dump (reference src/server.rs:183-220, minus
    the fork: the columnar capture is the consistent cut).  Returns the
    file size.  `fsync`: durable like write_snapshot_file — file data
    before the rename, parent directory entry after it.
    `container_level` > 0 writes the compressed container (inner
    sections then ship raw — module docstring)."""
    if container_level > 0:
        compress_level = 0
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            w = SnapshotWriter(f, compress_level=compress_level,
                               container_level=container_level)
            w.write_node(meta)
            records = list(replicas)
            if records:
                w.write_replicas(records)
            for chunk in iter_keyspace_chunks(ks, chunk_keys):
                w.write_chunk(chunk)
            w.finish()
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            _fsync_parent_dir(path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return os.path.getsize(path)


def write_snapshot_file(path: str, meta: NodeMeta,
                        records: Iterable[ReplicaRecord],
                        captures: Iterable[ColumnarBatch],
                        chunk_keys: int = 1 << 16,
                        compress_level: int = 1,
                        fsync: bool = False,
                        container_level: int = 0) -> int:
    """Atomic snapshot dump of pre-captured columnar state: the ONE
    tmp-file + SnapshotWriter + replace recipe every dump site shares
    (in the reference: full-sync dumps, the server's background and
    shutdown dumps, the delta-sync bucket exports).  A capture may be a
    ColumnarBatch (chunked + encoded here) or pre-encoded section bytes
    (written as-is).
    Blocking file IO: call from a worker thread when on the event loop.
    Returns the file size.  `container_level` > 0 writes the compressed
    container (inner sections then ship raw — module docstring; raw
    captures keep whatever encoding their producer chose)."""
    if container_level > 0:
        compress_level = 0
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            w = SnapshotWriter(f, compress_level=compress_level,
                               container_level=container_level)
            w.write_node(meta)
            w.write_replicas(records)
            for part in captures:
                if isinstance(part, (bytes, bytearray)):
                    w.write_chunk_raw(part)
                    continue
                for chunk in batch_chunks(part, chunk_keys):
                    w.write_chunk(chunk)
            w.finish()
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            # the rename is atomic but not durable until the DIRECTORY
            # entry syncs — a crash right after os.replace could roll
            # it back, losing the dump whose bytes were just fsynced
            _fsync_parent_dir(path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return os.path.getsize(path)


class SectionDemux:
    """Split a snapshot stream into its three section kinds: `batches()`
    yields the data sections in file order while the node meta and
    replica records accumulate on the instance — the demux every
    snapshot consumer shares (the reference's full-sync applies and
    sharded boot restore; the port's R-file catch-up,
    workload.file_catchup).  Meta and replica rows are only safely readable after the generator is
    exhausted; deferring their adoption until then is load-bearing for
    the apply sites (recorded pull watermarks are only backed by state
    once every chunk has merged)."""

    __slots__ = ("_f", "_raw", "meta", "replica_rows")

    def __init__(self, f: IO[bytes], raw_batches: bool = False):
        self._f = f
        self._raw = raw_batches
        self.meta: Optional[NodeMeta] = None
        self.replica_rows: List[ReplicaRecord] = []

    def batches(self) -> Iterator:
        for kind, payload in SnapshotLoader(self._f,
                                            raw_batches=self._raw):
            if kind == "node":
                self.meta = payload
            elif kind == "replicas":
                self.replica_rows.extend(payload)
            else:
                yield payload


def load_snapshot(path: str, ks, engine=None, device=None
                  ) -> Tuple[NodeMeta, List[ReplicaRecord]]:
    """Stream a snapshot file into a keyspace through a MergeEngine (the
    boot-time restore).  Targets a FRESH keyspace: if the trailing
    checksum fails, partial merges have already been applied and the
    keyspace must be discarded.  Returns (NodeMeta, replica records).

    With no `engine`, a resident TorchMergeEngine on `device` merges the
    file and is closed after it: None or "cuda" is the card (raises
    without one), "cpu" runs the plain versions on the host.

    `ks` may also be a hash-sharded store (duck-typed on
    `submit`/`n_shards`, as the reference's ShardedKeySpace): chunks then
    go to it undecoded and it merges them itself — `engine` is ignored
    (each shard owns its own)."""
    sharded = hasattr(ks, "submit") and hasattr(ks, "n_shards")
    own = engine is None and not sharded
    if own:
        from ..engine.cuda import TorchMergeEngine
        engine = TorchMergeEngine(resident=True, device=device)
    meta = NodeMeta()
    records: List[ReplicaRecord] = []
    try:
        with open(path, "rb") as f:
            for kind, payload in SnapshotLoader(f, raw_batches=sharded):
                if kind == "node":
                    meta = payload
                elif kind == "replicas":
                    records = payload
                elif kind == "batch_raw":
                    ks.submit_raw(payload)
                else:
                    engine.merge(ks, payload)
        if sharded:
            ks.flush()
        elif getattr(engine, "needs_flush", False):
            engine.flush(ks)
    finally:
        if own:
            engine.close()
    return meta, records
