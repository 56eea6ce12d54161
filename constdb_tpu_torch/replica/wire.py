"""Columnar replication wire codec: REPLBATCH payloads.

The steady-state peer stream used to ship one RESP REPLICATE frame per
repl-log entry; the receiver paid ~8-12µs of irreducible per-frame
Python intake (parse → dup/gap → buffer → group-encode) before the
batched merge engine ever saw a row.  Op-based CRDT replication is a
stream of commuting rewrites (PAPERS.md: Semidirect Products; Approaches
to CRDTs §op-based delivery), so a RUN of consecutive encodable entries
may travel as ONE frame with per-batch delivery bookkeeping:

    *[replbatch, origin, first_prev_uuid, last_uuid, n, payload]

The payload is the run group-encoded ONCE on the pusher through the
exact machinery the receiving coalescer would have used —
server/commands.py `COLUMNAR_ENCODERS` into a `replica/coalesce.py`
`BatchBuilder` — then packed into a compact columnar byte layout.  The
receiver validates, reconstructs the ColumnarBatch with vectorized
`np.frombuffer` reads, and hands it straight to
`Node.merge_stream_batch`: no per-frame RESP parse, no per-op re-plan,
no re-encode.

Exactness: the builder rows the registered encoders produce are fully
determined by (key, uuid, origin, frame args) under five fixed patterns
— add/delete key rows, register values, cntset/delcnt counter rows,
add/remove element records, tensor rows — so the payload stores only
the irreducible content (keys, uuid deltas, values, members) and the
decoder re-derives every envelope column from the SAME rules the
encoders apply.  A builder row outside the patterns (a future encoder
the codec does not know) makes `build_wire_batch` return None and the
pusher demotes that run to ordinary per-frame REPLICATE frames — the
wire format can lag the encoder table without ever lying about it.

The element-plane key-delete rule stays RECEIVER-side: add rows carry
their dt-check mark and `WireBatch.finalize()` evaluates it against the
receiving store's live dt columns (store/coalesce semantics, byte for
byte) — a pusher-side evaluation would read the WRONG store.

Integrity: the payload opens with a crc32 of its body.  Any truncation,
bit flip, or trailing garbage raises `WireFormatError` — the receiver
never advances its cursor over a batch it could not fully decode; it
tears the link down loudly and stops advertising CAP_BATCH_STREAM to
that peer, so the redelivery window arrives per-frame
(replica/coalesce.py `apply_wire_batch`).
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from ..crdt import semantics as S
from ..errors import CstError
from ..server.commands import COLUMNAR_ENCODERS, NotColumnar
from .coalesce import BatchBuilder, apply_key_delete_rule

_I64 = np.int64

# payload magic + format version; bump on any layout change — a decoder
# seeing an unknown version demotes (WireFormatError), never guesses
MAGIC = b"CWB1"

# builder-level encoder failures that demote a run to per-frame frames
# (replica/coalesce.py _ENC_ERRORS plus the malformed-args classes the
# stub-frame construction itself can raise)
_ENC_ERRORS = (NotColumnar, CstError, IndexError, TypeError, ValueError,
               KeyError)

# key encodings the registered columnar encoders can produce; anything
# else in a payload is malformed by construction
_WIRE_ENCS = frozenset((S.ENC_COUNTER, S.ENC_BYTES, S.ENC_DICT, S.ENC_SET,
                        S.ENC_LIST, S.ENC_TENSOR))

# hard ceilings: a crafted header must not make the decoder allocate
# unboundedly before validation catches up
_MAX_ROWS = 1 << 20


class WireFormatError(CstError):
    """Malformed/corrupt REPLBATCH payload (receiver side)."""


class _PatternError(Exception):
    """Builder row outside the wire patterns (pusher side): demote."""


# ------------------------------------------------------------ primitives
# Adaptive-width columns: one width byte + the values in the smallest
# dtype covering the range.  Everything decodes with one np.frombuffer.

def _pack_ints(out: bytearray, arr: np.ndarray) -> None:
    if len(arr) == 0:
        out.append(8)
        return
    lo, hi = int(arr.min()), int(arr.max())
    for w in (1, 2, 4, 8):
        lim = 1 << (8 * w - 1)
        if -lim <= lo and hi < lim:
            out.append(w)
            out += arr.astype(f"<i{w}").tobytes()
            return
    raise _PatternError("int column out of i64 range")


_WIRE_NATIVE_CACHE: list = []


def _native_wire():
    """(pack, unpack): the blob-column entry points of the port's native
    extension (utils/native.py; a failed build raises)."""
    if not _WIRE_NATIVE_CACHE:
        from ..utils.native import load
        ext = load().ext
        _WIRE_NATIVE_CACHE.append((ext.wire_pack_blobs,
                                   ext.wire_unpack_blobs))
    return _WIRE_NATIVE_CACHE[0]


def _pack_blobs(out: bytearray, items) -> None:
    """Length-prefixed byte blobs; None entries use the width's max value
    as a sentinel (so a length can never alias it — widths widen first).
    The C packer (native/wire.cpp) DECLINES any shape off the happy
    path (non-list, non-bytes rows, over-wide blobs), so the pure packer
    keeps the reference behavior, including the _PatternError demotes,
    byte for byte."""
    if _native_wire()[0](out, items):
        return
    _py_pack_blobs(out, items)


def _py_pack_blobs(out: bytearray, items) -> None:
    """The pure packer: the declined shapes, and the tests' oracle."""
    n = len(items)
    lens = np.fromiter((len(b) if b is not None else -1 for b in items),
                       dtype=_I64, count=n)
    mx = int(lens.max()) if n else 0
    for w in (1, 2, 4):
        if mx < (1 << (8 * w)) - 1:
            break
    else:
        raise _PatternError("blob too large for the wire")
    sentinel = (1 << (8 * w)) - 1
    out.append(w)
    out += np.where(lens < 0, sentinel, lens).astype(f"<u{w}").tobytes()
    out += b"".join(b for b in items if b is not None)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.buf):
            raise WireFormatError("truncated replbatch payload")
        mv = self.buf[self.pos:self.pos + n]
        self.pos += n
        return mv

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def ints(self, n: int) -> np.ndarray:
        w = self.u8()
        if w not in (1, 2, 4, 8):
            raise WireFormatError("bad int column width")
        return np.frombuffer(self.take(n * w), dtype=f"<i{w}").astype(_I64)

    def blobs(self, n: int) -> list:
        # C fast path (native/wire.cpp): one call slices the whole
        # column.  A decline (bad width, truncation) falls through to
        # the pure reader, which raises the reference WireFormatError.
        res = _native_wire()[1](self.buf, self.pos, n)
        if res is not None:
            self.pos = res[1]
            return res[0]
        return self.py_blobs(n)

    def py_blobs(self, n: int) -> list:
        """The pure reader: the declined shapes, and the tests' oracle."""
        w = self.u8()
        if w not in (1, 2, 4):
            raise WireFormatError("bad blob length width")
        lens = np.frombuffer(self.take(n * w), dtype=f"<u{w}").astype(_I64)
        sentinel = (1 << (8 * w)) - 1
        none = lens == sentinel
        sizes = np.where(none, 0, lens)
        blob = bytes(self.take(int(sizes.sum())))
        out = []
        pos = 0
        for ln, nn in zip(sizes.tolist(), none.tolist()):
            if nn:
                out.append(None)
            else:
                out.append(blob[pos:pos + ln])
                pos += ln
        return out


# -------------------------------------------------------------- encoding

def _stub_items(entry) -> tuple:
    """Synthetic wire-frame items for the group encoders: they index
    items[5] (key) and items[6:] (args), exactly `[.., key, *rest]`."""
    return (None, None, None, None, None, *entry.args)


def build_wire_batch(entries: list, origin: int) -> Optional[bytes]:
    """Group-encode a run of consecutive ENCODABLE repl-log entries into
    one REPLBATCH payload.  Returns None when any entry rejects its
    encoder or any builder row falls outside the wire patterns — the
    caller demotes the whole run to ordinary per-frame frames (loudly;
    this never raises on bad input)."""
    from ..resp.message import as_bytes
    bb = BatchBuilder(None)
    buf: dict[bytes, list] = {}
    try:
        for e in entries:
            key = as_bytes(e.args[0])
            recs = buf.get(e.name)
            if recs is None:
                recs = buf[e.name] = []
            recs.append((key, origin, e.uuid, _stub_items(e)))
        for name, recs in buf.items():
            COLUMNAR_ENCODERS[name](bb, recs)
        return _encode_builder(bb, origin, entries[0].prev_uuid)
    except (_PatternError, *_ENC_ERRORS):
        return None


def _encode_builder(bb: BatchBuilder, origin: int, base: int) -> bytes:
    """Serialize a filled builder, verifying every row against the wire
    patterns (raises _PatternError on any deviation — the decoder
    re-derives envelope columns from these patterns, so a row they do
    not cover MUST NOT ship)."""
    n = len(bb.keys)
    mt = bb.mt
    # np.array over the builder lists, not fromiter: same values, ~2x
    # less fixed cost per column — this runs once per REPLBATCH run AND
    # once per durable-op-log batch record (persist/oplog.py)
    uuids = np.array(mt, dtype=_I64)
    ct = np.array(bb.ct, dtype=_I64)
    dt = np.array(bb.dt, dtype=_I64)
    del_mask = dt != 0
    if not np.array_equal(np.where(del_mask, 0, uuids), ct) or \
            not np.array_equal(np.where(del_mask, uuids, 0), dt):
        raise _PatternError("key envelope outside add/del patterns")
    du = uuids - base
    if n and int(du.min()) < 1:
        raise _PatternError("non-increasing uuid in run")

    reg_val: list = [None] * n
    for ki0, us, nodes, vals in bb.reg_runs:
        hi = ki0 + len(vals)
        if list(us) != mt[ki0:hi] or any(nd != origin for nd in nodes) \
                or bool(del_mask[ki0:hi].any()):
            raise _PatternError("register run outside the wire pattern")
        reg_val[ki0:hi] = vals

    c_ki, c_node, c_kind, c_pay = [], [], [], []
    for ki, node, val, u_, base_, bt in bb.cnt_rows:
        ku = mt[ki]
        if u_ == ku and base_ == 0 and bt == S.NEUTRAL_T:
            c_kind.append(0)
            c_pay.append(val)
        elif val == 0 and u_ == S.NEUTRAL_T and bt == ku:
            c_kind.append(1)
            c_pay.append(base_)
        else:
            raise _PatternError("counter row outside the wire patterns")
        c_ki.append(ki)
        c_node.append(node - origin)

    e_ki, e_flags, e_cnt, e_members, e_vals = [], [], [], [], []
    for ki, members, vals, at, an, dlt, chk in bb.el_rows:
        ku = mt[ki]
        if at == ku and an == origin and dlt == 0 and chk:
            flags = 1 | (2 if vals is not None else 0)
            if vals is not None:
                e_vals.extend(vals)
        elif at == 0 and an == 0 and dlt == ku and not chk \
                and vals is None:
            flags = 0
        else:
            raise _PatternError("element record outside the wire patterns")
        if not members:
            raise _PatternError("empty element record")
        e_ki.append(ki)
        e_flags.append(flags)
        e_cnt.append(len(members))
        e_members.extend(members)

    t_ki, t_cnt, t_cfg, t_pay = [], [], [], []
    for ki, node, u_, cnt, cfg, payload in bb.tns_rows:
        if node != origin or u_ != mt[ki]:
            raise _PatternError("tensor row outside the wire pattern")
        t_ki.append(ki)
        t_cnt.append(cnt)
        t_cfg.append(cfg)
        t_pay.append(payload)

    body = bytearray()
    body += n.to_bytes(4, "little")
    body += len(c_ki).to_bytes(4, "little")
    body += len(e_ki).to_bytes(4, "little")
    body += len(t_ki).to_bytes(4, "little")
    _pack_blobs(body, bb.keys)
    _pack_ints(body, np.array(bb.enc, dtype=_I64))
    _pack_ints(body, del_mask.astype(_I64))
    _pack_ints(body, du)
    _pack_blobs(body, reg_val)
    for col in (c_ki, c_node, c_kind, c_pay):
        _pack_ints(body, np.array(col, dtype=_I64))
    for col in (e_ki, e_flags, e_cnt):
        _pack_ints(body, np.array(col, dtype=_I64))
    _pack_blobs(body, e_members)
    _pack_blobs(body, e_vals)
    for col in (t_ki, t_cnt):
        _pack_ints(body, np.array(col, dtype=_I64))
    _pack_blobs(body, t_cfg)
    _pack_blobs(body, t_pay)
    return MAGIC + zlib.crc32(body).to_bytes(4, "little") + bytes(body)


# -------------------------------------------------------------- decoding

class WireBatch:
    """A decoded REPLBATCH payload, bound to the RECEIVING keyspace.
    Mirrors the builder surface `Node.merge_stream_batch` consumes:
    `finalize()` applies the element-plane key-delete rule against the
    live store (replica/coalesce.py semantics) and returns the batch."""

    __slots__ = ("ks", "batch", "check", "n_frames")

    def __init__(self, ks, batch, check, n_frames: int):
        self.ks = ks
        self.batch = batch
        self.check = check
        self.n_frames = n_frames

    @property
    def n_rows(self) -> int:
        return self.batch.n_rows

    def finalize(self):
        apply_key_delete_rule(self.ks, self.batch, self.check)
        return self.batch

    # the rest of the builder's landing surface (replica/coalesce.py)

    @property
    def keys(self) -> list:
        return self.batch.keys

    @property
    def del_keys(self) -> list:
        return self.batch.del_keys

    def deletes(self):
        b = self.batch
        return zip(b.del_keys, b.del_t.tolist())

    def touched(self) -> set:
        from ..engine.base import touched_families
        return touched_families(self.batch)

    def plan_input(self) -> tuple:
        """(columns, columnar) for the native round planner
        (native/planner.cpp read_columns): the int columns as int64
        arrays, the key-delete rule's row marks as a bool array."""
        b = self.batch

        def i64(a):
            return np.ascontiguousarray(a, dtype=_I64)
        check = None if self.check is None else \
            np.ascontiguousarray(self.check, dtype=bool)
        return (b.keys, i64(b.key_enc), i64(b.key_ct), i64(b.key_mt),
                i64(b.key_dt), i64(b.key_expire), b.reg_val, i64(b.reg_t),
                i64(b.reg_node), i64(b.cnt_ki), i64(b.cnt_node),
                i64(b.cnt_val), i64(b.cnt_uuid), i64(b.cnt_base),
                i64(b.cnt_base_t), i64(b.el_ki), b.el_member, b.el_val,
                i64(b.el_add_t), i64(b.el_add_node), i64(b.el_del_t), check,
                b.el_has_vals is not False), True


def decode_wire_batch(payload: bytes, ks, origin: int,
                      base: int) -> WireBatch:
    """Validate + decode one REPLBATCH payload against the receiving
    keyspace.  Raises WireFormatError on ANY defect — truncation, crc
    mismatch, out-of-range index, trailing bytes — so a batch either
    decodes whole or advances nothing."""
    try:
        return _decode(payload, ks, origin, base)
    except WireFormatError:
        raise
    except (ValueError, IndexError, OverflowError, TypeError) as e:
        raise WireFormatError(f"malformed replbatch payload: {e}") from None


def _decode(payload: bytes, ks, origin: int, base: int) -> WireBatch:
    from ..engine.base import ColumnarBatch
    if len(payload) < 8 or payload[:4] != MAGIC:
        raise WireFormatError("bad replbatch magic/version")
    crc = int.from_bytes(payload[4:8], "little")
    body = memoryview(payload)[8:]
    if zlib.crc32(body) != crc:
        raise WireFormatError("replbatch payload crc mismatch")
    r = _Reader(body)
    n = r.u32()
    nc = r.u32()
    ne = r.u32()
    nt = r.u32()
    if not (0 < n <= _MAX_ROWS) or nc > _MAX_ROWS or ne > _MAX_ROWS \
            or nt > _MAX_ROWS:
        raise WireFormatError("replbatch row counts out of range")

    b = ColumnarBatch()
    b.keys = r.blobs(n)
    if any(k is None for k in b.keys):
        raise WireFormatError("null key in replbatch")
    enc = r.ints(n)
    if not set(enc.tolist()) <= _WIRE_ENCS:
        raise WireFormatError("unknown key encoding in replbatch")
    b.key_enc = enc.astype(np.int8)
    del_mask = r.ints(n)
    if not set(del_mask.tolist()) <= {0, 1}:
        raise WireFormatError("bad key-row kind in replbatch")
    del_mask = del_mask.astype(bool)
    du = r.ints(n)
    if int(du.min()) < 1:
        raise WireFormatError("non-positive uuid delta in replbatch")
    uuid = base + du
    b.key_ct = np.where(del_mask, 0, uuid)
    b.key_mt = uuid
    b.key_dt = np.where(del_mask, uuid, 0)
    b.key_expire = np.zeros(n, dtype=_I64)
    b.reg_val = r.blobs(n)
    has_reg = np.fromiter((v is not None for v in b.reg_val),
                          dtype=bool, count=n)
    if bool((has_reg & del_mask).any()):
        raise WireFormatError("register value on a delete row")
    b.reg_t = np.where(has_reg, uuid, 0)
    b.reg_node = np.where(has_reg, origin, 0)

    c_ki = r.ints(nc)
    c_node = r.ints(nc)
    c_kind = r.ints(nc)
    c_pay = r.ints(nc)
    if nc:
        if int(c_ki.min()) < 0 or int(c_ki.max()) >= n or \
                not set(c_kind.tolist()) <= {0, 1}:
            raise WireFormatError("counter rows out of range")
        kind0 = c_kind == 0
        b.cnt_ki = c_ki
        b.cnt_node = c_node + origin
        b.cnt_val = np.where(kind0, c_pay, 0)
        b.cnt_uuid = np.where(kind0, uuid[c_ki], S.NEUTRAL_T)
        b.cnt_base = np.where(kind0, 0, c_pay)
        b.cnt_base_t = np.where(kind0, S.NEUTRAL_T, uuid[c_ki])

    e_ki = r.ints(ne)
    e_flags = r.ints(ne)
    e_cnt = r.ints(ne)
    check = None
    if ne:
        if int(e_ki.min()) < 0 or int(e_ki.max()) >= n or \
                not set(e_flags.tolist()) <= {0, 1, 3} or \
                int(e_cnt.min()) < 1 or int(e_cnt.sum()) > _MAX_ROWS:
            raise WireFormatError("element records out of range")
    n_members = int(e_cnt.sum()) if ne else 0
    members = r.blobs(n_members)
    if any(m is None for m in members):
        raise WireFormatError("null element member")
    has_vals = (e_flags & 2) != 0
    n_vals = int(e_cnt[has_vals].sum()) if ne else 0
    vals = r.blobs(n_vals)
    if any(v is None for v in vals):
        raise WireFormatError("null element value in a valued record")
    if ne:
        add_mask = (e_flags & 1) != 0
        b.el_ki = np.repeat(e_ki, e_cnt)
        add_rows = np.repeat(add_mask, e_cnt)
        row_uuid = uuid[b.el_ki]
        b.el_add_t = np.where(add_rows, row_uuid, 0)
        b.el_add_node = np.where(add_rows, origin, 0)
        b.el_del_t = np.where(add_rows, 0, row_uuid)
        check = add_rows
        b.el_member = members
        if n_vals:
            out_vals: list = []
            pos = 0
            for cnt, hv in zip(e_cnt.tolist(), has_vals.tolist()):
                if hv:
                    out_vals.extend(vals[pos:pos + cnt])
                    pos += cnt
                else:
                    out_vals.extend([None] * cnt)
            b.el_val = out_vals
        else:
            b.el_val = [None] * n_members
            b.el_has_vals = False

    t_ki = r.ints(nt)
    t_cnt = r.ints(nt)
    t_cfg = r.blobs(nt)
    t_pay = r.blobs(nt)
    if nt:
        if int(t_ki.min()) < 0 or int(t_ki.max()) >= n or \
                any(c is None for c in t_cfg) or \
                any(p is None for p in t_pay):
            raise WireFormatError("tensor rows out of range")
        b.tns_ki = t_ki
        b.tns_node = np.full(nt, origin, dtype=_I64)
        b.tns_uuid = uuid[t_ki]
        b.tns_cnt = t_cnt
        b.tns_cfg = t_cfg
        b.tns_payload = t_pay

    if r.pos != len(body):
        raise WireFormatError("trailing bytes after replbatch payload")

    if bool(del_mask.any()):
        dels: dict[bytes, int] = {}
        for k, u_, dm in zip(b.keys, uuid.tolist(), del_mask.tolist()):
            if dm and dels.get(k, -1) < u_:
                dels[k] = u_
        b.del_keys = list(dels.keys())
        b.del_t = np.fromiter(dels.values(), dtype=_I64, count=len(dels))

    b.rows_unique_per_slot = False
    return WireBatch(ks, b, check, n)
