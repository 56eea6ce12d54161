"""Anti-entropy state digests: order-independent folds over the crc32
key partition (the reference package's delta-sync negotiation,
replica/link.py, exchanges these; the port has no replica link yet and
uses `full_state_digest` as a whole-state check that does not depend on
the shard layout).  Numpy over a KeySpace, no kernel.

A digest bucket's value is a PURE FUNCTION of the logical CRDT state of
the keys it owns — any two stores holding the same logical state produce
the same matrix, whatever engine merged it, however its shards are laid
out, and in whatever order the ops arrived.  That is the whole load:
pusher and puller exchange matrices, and only buckets whose folds differ
are streamed.

Geometry: a key lands in shard `crc32(key) % fanout` (the SAME crc32
partition store/sharded_keyspace.py shards by, so a sharded node's
workers each digest their disjoint key set and the parent SUMS the
matrices) and leaf `(crc32(key) // fanout) % leaves`.  The level-0
rollup a pusher compares first is the per-shard sum over leaves — which
equals the `leaves=1` matrix, so the two levels never need to agree on
a leaf count up front.

Per-key content, all folded as unordered mod-2^64 sums of mixed 64-bit
hashes (sum ⇒ shard layout and row order are invisible):

  * envelope row:  crc32(key), enc, ct, mt, dt, expire, rv_t, rv_node.
    The register VALUE bytes are deliberately absent: an LWW register's
    (rv_t, rv_node) pair identifies the winning write, and one write has
    one value — hashing the pair is hashing the value, without an
    O(keys) Python pass over the blobs.
  * counter slot:  crc32(key), node, val, uuid, base, base_t (same
    writer-identifies-value argument would allow dropping val/base, but
    they are numeric columns — hashing them is free and belt-and-braces).
  * element row:   crc32(key), crc32(member), add_t, add_node, and
    del_t NORMALIZED to 0 when <= add_t — the same inert-tombstone rule
    KeySpace.canonical applies, so GC-timing skew between replicas does
    not flag spurious divergence.  GC-dead rows (kid < 0) are excluded.
    Element VALUES ride on (add_t, add_node), like register values.
  * key tombstone: crc32(key), delete time — the `key_deletes` record,
    which is the only trace of a delete merged for a never-seen key.

Cost model (the "incremental digest" law): the per-item Python work —
crc32 of key and member bytes — is cached on the store and maintained
incrementally in append order (KeySpace.key_crcs / member_crcs; element
compaction invalidates the member cache).  The numeric folds are a
vectorized numpy pass over the live columns at exchange time: O(state)
at memory bandwidth, run once per digest request on a path whose
alternative was shipping the whole keyspace over the wire.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..engine.base import ColumnarBatch, batch_from_keyspace
from .keyspace import KeySpace

_U64 = np.uint64
_GOLD = np.uint64(0x9E3779B97F4A7C15)
_MUL1 = np.uint64(0xBF58476D1CE4E5B9)
_MUL2 = np.uint64(0x94D049BB133111EB)

# per-plane seeds: a counter slot and an element row with coincidentally
# equal numeric columns must not cancel across planes
_SEED_ENV = np.uint64(0x1B873593A5A5A5A5)
_SEED_CNT = np.uint64(0x2545F4914F6CDD1D)
_SEED_EL = np.uint64(0x632BE59BD9B4E019)
_SEED_DEL = np.uint64(0x9E6C63D0876A9A47)
_SEED_TNS = np.uint64(0x7FEB352D243F6A88)

# the negotiated shard axis: the SAME crc32 partition
# store/sharded_keyspace.py shards by, at its maximum width, so any
# node's physical shard layout (1..64 workers) nests inside it and a
# digest request never depends on either side's worker count
DIGEST_FANOUT = 64

# largest matrix a peer may request (replica/link.py bounds requests to
# this before allocating): 2^22 buckets = 32 MB of uint64
MAX_BUCKETS = 1 << 22


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized (uint64 wraparound)."""
    x = x ^ (x >> np.uint64(30))
    x = x * _MUL1
    x = x ^ (x >> np.uint64(27))
    x = x * _MUL2
    return x ^ (x >> np.uint64(31))

def _chain(seed: np.uint64, *cols) -> np.ndarray:
    """Positional hash chain over aligned columns (order matters inside
    a row; rows themselves are folded unordered by the caller)."""
    h = None
    for c in cols:
        c = np.asarray(c).astype(_U64, copy=False)
        if h is None:
            h = _mix64(c + seed)
        else:
            h = _mix64((h * _MUL1) ^ c)
    return h


def leaves_for(n_keys: int, fanout: int, bucket_keys: int) -> int:
    """Leaf count targeting ~`bucket_keys` keys per (shard, leaf) bucket
    (pow2-rounded).  Fine buckets are what turn 1% key divergence into
    ~1% of buckets streamed instead of 100% of shards."""
    want = max(1, n_keys // max(1, fanout * max(1, bucket_keys)))
    leaves = 1
    while leaves < want and leaves * fanout < MAX_BUCKETS:
        leaves <<= 1
    return leaves


def _buckets(crc: np.ndarray, fanout: int, leaves: int) -> np.ndarray:
    shard = crc % np.uint64(fanout)
    leaf = (crc // np.uint64(fanout)) % np.uint64(leaves)
    return (shard * np.uint64(leaves) + leaf).astype(np.int64)


def _env_hashes(ks: KeySpace, kcrc: np.ndarray) -> np.ndarray:
    """One hash per key envelope row, kid-aligned."""
    return _chain(_SEED_ENV, kcrc, ks.keys.enc, ks.keys.ct, ks.keys.mt,
                  ks.keys.dt, ks.keys.expire, ks.keys.rv_t,
                  ks.keys.rv_node)


def _cnt_hashes(ks: KeySpace, kcrc: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """(owning kid, hash) per counter slot."""
    kid = ks.cnt.kid
    return kid, _chain(_SEED_CNT, kcrc[kid], ks.cnt.node, ks.cnt.val,
                       ks.cnt.uuid, ks.cnt.base, ks.cnt.base_t)


def _el_hashes(ks: KeySpace, kcrc: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """(owning kid, hash) per LIVE element row (GC-dead rows excluded,
    inert tombstones normalized — see the module docstring)."""
    live = np.nonzero(ks.el.kid >= 0)[0]
    if not len(live):
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=_U64)
    kid = ks.el.kid[live]
    add_t = ks.el.add_t[live]
    del_t = ks.el.del_t[live]
    del_norm = np.where(del_t > add_t, del_t, 0)
    return kid, _chain(_SEED_EL, kcrc[kid], ks.member_crcs()[live],
                       add_t, ks.el.add_node[live], del_norm)


def _tns_hashes(ks: KeySpace, kcrc: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """(owning kid, hash) per tensor contributor slot holding a real
    write.  Payload BYTES are deliberately absent, by the same argument
    as register values (module docstring): a slot is an LWW register
    whose (node, uuid) stamp identifies the winning write, and one
    write has one payload — hashing the stamp is hashing the payload,
    with zero O(payload) passes per exchange."""
    from ..crdt.semantics import NEUTRAL_T
    n = ks.tns.n
    if not n:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=_U64)
    live = np.nonzero(ks.tns.uuid[:n] != NEUTRAL_T)[0]
    if not len(live):
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=_U64)
    kid = ks.tns.kid[live]
    return kid, _chain(_SEED_TNS, kcrc[kid], ks.tns.node[live],
                       ks.tns.uuid[live], ks.tns.cnt[live])


def _del_hashes(ks: KeySpace) -> tuple[np.ndarray, np.ndarray]:
    """(key crc, hash) per key-tombstone record, in dict order (aligned
    with `list(ks.key_deletes)`)."""
    m = len(ks.key_deletes)
    crc32 = zlib.crc32
    dcrc = np.fromiter((crc32(k) for k in ks.key_deletes), dtype=_U64,
                       count=m)
    dts = np.fromiter(ks.key_deletes.values(), dtype=np.int64, count=m)
    return dcrc, _chain(_SEED_DEL, dcrc, dts)


def state_digest_matrix(ks: KeySpace, fanout: int,
                        leaves: int) -> np.ndarray:
    """The (fanout, leaves) uint64 digest matrix of `ks`'s logical state
    (see module docstring).  Callers owning a deferring engine must
    flush it first — the fold reads host columns."""
    flat = np.zeros(fanout * leaves, dtype=_U64)
    n = ks.keys.n
    kcrc = ks.key_crcs()
    if n:
        kb = _buckets(kcrc, fanout, leaves)
        np.add.at(flat, kb, _env_hashes(ks, kcrc))
        if ks.cnt.n:
            kid, h = _cnt_hashes(ks, kcrc)
            np.add.at(flat, kb[kid], h)
        if ks.el.n:
            kid, h = _el_hashes(ks, kcrc)
            if len(kid):
                np.add.at(flat, kb[kid], h)
        if ks.tns.n:
            kid, h = _tns_hashes(ks, kcrc)
            if len(kid):
                np.add.at(flat, kb[kid], h)
    if ks.key_deletes:
        dcrc, h = _del_hashes(ks)
        np.add.at(flat, _buckets(dcrc, fanout, leaves), h)
    return flat.reshape(fanout, leaves)


def full_state_digest(ks: KeySpace, fanout: int = 0,
                      leaves: int = 1) -> int:
    """One 64-bit digest of the whole logical state: the matrix folded
    to a scalar (mod-2^64 sum, so it is geometry-independent — every
    (fanout, leaves) layout of the same state sums to the same value).
    The chaos oracle's digest-agreement law and the resync bench both
    compare replicas through this; same flush-first caveat as
    `state_digest_matrix`."""
    if fanout <= 0:
        fanout = DIGEST_FANOUT
    m = state_digest_matrix(ks, fanout, leaves)
    return int(m.sum(dtype=_U64))


def _key_accum(ks: KeySpace) -> np.ndarray:
    """Per-kid uint64 content stamp: each live key's total contribution
    to its digest bucket (envelope row + counter slots + live element
    rows; tombstone records ride separately — `_del_hashes`).  Derived
    from the SAME row hashes `state_digest_matrix` folds, so a bucket's
    digest is exactly the sum of its keys' stamps plus its tombstone
    hashes — the digest levels cannot disagree."""
    n = ks.keys.n
    acc = np.zeros(n, dtype=_U64)
    if n:
        kcrc = ks.key_crcs()
        acc += _env_hashes(ks, kcrc)
        if ks.cnt.n:
            kid, h = _cnt_hashes(ks, kcrc)
            np.add.at(acc, kid, h)
        if ks.el.n:
            kid, h = _el_hashes(ks, kcrc)
            if len(kid):
                np.add.at(acc, kid, h)
        if ks.tns.n:
            kid, h = _tns_hashes(ks, kcrc)
            if len(kid):
                np.add.at(acc, kid, h)
    return acc


def bucket_key_sel(ks: KeySpace, fanout: int, leaves: int,
                   mask_flat: np.ndarray) -> np.ndarray:
    """Row indices (kids) of the keys owned by the masked buckets."""
    n = ks.keys.n
    if not n:
        return np.zeros(0, dtype=np.int64)
    return np.nonzero(mask_flat[_buckets(ks.key_crcs(), fanout,
                                         leaves)])[0]


def masked_key_count(ks: KeySpace, fanout: int, leaves: int,
                     mask_flat: np.ndarray, key_sel=None) -> int:
    """Upper bound on the KeyStampTable entry count for the masked
    buckets (live keys + tombstone records; crc collisions merge
    entries, so the real table is never larger).  Bucket math over the
    cached crcs only — the cheap gate replica/link.py checks BEFORE
    paying the O(keyspace) `_key_accum` pass a stamp table costs.
    `key_sel`: a precomputed `bucket_key_sel` result to reuse."""
    if key_sel is None:
        key_sel = bucket_key_sel(ks, fanout, leaves, mask_flat)
    n = len(key_sel)
    if ks.key_deletes:
        crc32 = zlib.crc32
        dcrc = np.fromiter((crc32(k) for k in ks.key_deletes),
                           dtype=_U64, count=len(ks.key_deletes))
        n += int(mask_flat[_buckets(dcrc, fanout, leaves)].sum())
    return n


def export_bucket_batch(ks: KeySpace, fanout: int, leaves: int,
                        mask_flat: np.ndarray) -> ColumnarBatch:
    """One deduplicated whole-state batch of exactly the keys (and their
    counter/element rows, and the key tombstones) owned by the masked
    buckets — the range-scoped delta a pusher streams for divergent
    buckets (replica/link.py _send_delta via
    persist/snapshot.write_snapshot_file)."""
    sel = bucket_key_sel(ks, fanout, leaves, mask_flat)
    b = batch_from_keyspace(ks, include_deletes=False, key_sel=sel)
    if ks.key_deletes:
        crc32 = zlib.crc32
        m = len(ks.key_deletes)
        dcrc = np.fromiter((crc32(k) for k in ks.key_deletes), dtype=_U64,
                           count=m)
        dsel = np.nonzero(mask_flat[_buckets(dcrc, fanout, leaves)])[0]
        if len(dsel):
            keys = list(ks.key_deletes)
            b.del_keys = [keys[i] for i in dsel]
            b.del_t = np.fromiter(ks.key_deletes.values(),
                                  dtype=np.int64, count=m)[dsel]
    return b


class KeyStampTable:
    """The per-key refinement level of the digest exchange (level 2):
    one `(crc32(key), content stamp)` entry per distinct key crc in the
    masked (divergent) buckets, where the stamp is the mod-2^64 sum of
    every local contribution hashing to that crc — live rows via
    `_key_accum`, tombstone records via `_del_hashes`.  Keying entries
    by crc (not kid) makes both sides' tables comparable without
    exchanging key bytes, and makes crc32 collisions SAFE by
    construction: colliding keys share one entry on both sides, so a
    content difference in either key flags the entry and streams them
    all — collisions can only cost bytes, never convergence.

    The pusher sends `crcs`/`stamps`; the peer replies with the entry
    indices whose stamp differs from (or is absent in) its own table
    (`stamp_mismatch_indices`), and `export_batch` then ships exactly
    those entries' keys — the whole-bucket export minus the innocent
    bystanders that merely share a bucket with a divergent key."""

    def __init__(self, ks: KeySpace, fanout: int, leaves: int,
                 mask_flat: np.ndarray, key_sel=None):
        # `key_sel`: a precomputed `bucket_key_sel` result to reuse (the
        # gate in replica/link.py already paid the bucket pass)
        sel = key_sel if key_sel is not None else \
            bucket_key_sel(ks, fanout, leaves, mask_flat)
        crcs = [ks.key_crcs()[sel]] if len(sel) else []
        stamps = [_key_accum(ks)[sel]] if len(sel) else []
        self._kids = sel
        self._del_keys: list[bytes] = []
        self._del_t = np.zeros(0, dtype=np.int64)
        if ks.key_deletes:
            dcrc, dh = _del_hashes(ks)
            dsel = np.nonzero(mask_flat[_buckets(dcrc, fanout,
                                                 leaves)])[0]
            if len(dsel):
                keys = list(ks.key_deletes)
                self._del_keys = [keys[i] for i in dsel]
                self._del_t = np.fromiter(
                    (ks.key_deletes[k] for k in self._del_keys),
                    dtype=np.int64, count=len(self._del_keys))
                crcs.append(dcrc[dsel])
                stamps.append(dh[dsel])
        allcrc = np.concatenate(crcs) if crcs else np.zeros(0, _U64)
        allstamp = np.concatenate(stamps) if stamps else \
            np.zeros(0, _U64)
        self.crcs, inv = np.unique(allcrc, return_inverse=True)
        self.stamps = np.zeros(len(self.crcs), dtype=_U64)
        np.add.at(self.stamps, inv, allstamp)
        self._kid_entry = inv[:len(self._kids)]
        self._del_entry = inv[len(self._kids):]

    def export_batch(self, ks: KeySpace,
                     selected: np.ndarray) -> ColumnarBatch:
        """The delta batch for the selected entry indices: exactly those
        entries' live keys (deduplicated whole-state rows) and tombstone
        records — `export_bucket_batch` narrowed from dirty buckets to
        divergent keys."""
        pick = np.zeros(len(self.crcs), dtype=bool)
        pick[selected] = True
        b = batch_from_keyspace(ks, include_deletes=False,
                                key_sel=self._kids[pick[self._kid_entry]])
        if self._del_keys:
            dm = pick[self._del_entry]
            if dm.any():
                b.del_keys = [k for k, m in zip(self._del_keys, dm) if m]
                b.del_t = self._del_t[dm]
        return b


def stamp_mismatch_indices(ks: KeySpace, crcs: np.ndarray,
                           stamps: np.ndarray) -> np.ndarray:
    """The puller leg of the level-2 exchange: indices of the peer's
    stamp entries whose crc has a different (or no) summed stamp on this
    store — the keys the peer must stream.  Local keys the peer did not
    list are invisible here ON PURPOSE: merge never deletes, so
    puller-only state is not this exchange's problem — it flows back
    through OUR push leg toward the peer.  A crc determines its bucket,
    so local contributions are collected keyspace-wide (any local key
    sharing a listed crc shares its bucket too)."""
    parts_c, parts_s = [], []
    if ks.keys.n:
        kcrc = ks.key_crcs()
        m = np.isin(kcrc, crcs)
        if m.any():
            idx = np.nonzero(m)[0]
            parts_c.append(kcrc[idx])
            parts_s.append(_key_accum(ks)[idx])
    if ks.key_deletes:
        dcrc, dh = _del_hashes(ks)
        dm = np.isin(dcrc, crcs)
        if dm.any():
            parts_c.append(dcrc[dm])
            parts_s.append(dh[dm])
    if not parts_c:
        return np.arange(len(crcs), dtype=np.int64)  # all absent here
    oc = np.concatenate(parts_c)
    os_ = np.concatenate(parts_s)
    uniq, inv = np.unique(oc, return_inverse=True)
    mine = np.zeros(len(uniq), dtype=_U64)
    np.add.at(mine, inv, os_)
    pos = np.searchsorted(uniq, crcs)
    posc = np.clip(pos, 0, len(uniq) - 1)
    have = uniq[posc] == crcs
    differ = ~have | (mine[posc] != stamps)
    return np.nonzero(differ)[0]


def sum_matrices(mats, fanout: int, leaves: int) -> np.ndarray:
    """Aggregate per-shard matrices (raw uint64 LE buffers or arrays)
    into one (fanout, leaves) matrix — shards partition the keys, and
    the fold is an unordered sum, so plane-wide = Σ per-worker."""
    out = np.zeros(fanout * leaves, dtype=_U64)
    for m in mats:
        arr = m if isinstance(m, np.ndarray) else np.frombuffer(m, _U64)
        if arr.size != out.size:
            raise ValueError(
                f"digest matrix size mismatch: {arr.size} != {out.size}")
        out = out + arr.reshape(-1)
    return out.reshape(fanout, leaves)
