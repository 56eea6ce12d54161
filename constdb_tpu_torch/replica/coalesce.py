"""Coalescing replication applier: batch the steady-state peer stream.

The pull loop used to apply every REPLICATE frame one key at a time on
the event loop (`node.apply_replicated`) — the last large per-key Python
loop on a hot path, and *the* hot path for serving traffic.  Under this
build's op model every steady-state write command is a pure pointwise
CRDT merge (crdt/semantics.py: op application IS the merge function), so
frames from a peer stream may be legally coalesced and applied as ONE
columnar batch through the same fused engine path snapshot ingest rides
(`node.merge_batches` → engine `merge_many`).

Shape of the machinery:

  * intake (`CoalescingApplier.apply`) does only the per-frame minimum —
    dup-skip / gap check / cursor — and buffers `(key, origin, uuid,
    frame)` records grouped by command name.  All decoding happens at
    flush, where the per-command GROUP encoders (server/commands.py
    `COLUMNAR_ENCODERS`) turn each run into columnar rows with C-speed
    list comprehensions, in the exact plane layout the snapshot writer
    serializes (engine/base.py ColumnarBatch).
  * flushes happen under a dual bound — max frames per batch
    (`CONSTDB_TORCH_APPLY_BATCH`) and max latency (`CONSTDB_TORCH_APPLY_LATENCY_MS`)
    — and additionally whenever the socket goes idle (no complete frame
    buffered), so a lone write lands with ZERO added latency; the bounds
    only engage under sustained traffic, where batching is the point.
  * non-encodable frames apply on the exact per-key path as BARRIERS.
    Membership ops never touch the keyspace and the key-scoped sweeps
    (collection deletes, expireat, mvwrite) read live rows of exactly
    their first-argument key, so they force a flush only when that key
    has pending rows; anything else non-encodable flushes
    unconditionally.  `CONSTDB_TORCH_APPLY_BATCH=1` turns every frame into a
    barrier — the exact pre-coalescing path.

Watermark discipline (docs/INVARIANTS.md): `meta.uuid_he_sent` — the
resume point requested on reconnect AND the value the push loop REPLACKs
back — advances ONLY after the covering batch has landed in the store.
A connection that dies with frames still pending simply re-receives them
after reconnect (replication is idempotent); a REPLACK beacon that
arrives while frames are pending is stashed and applied post-flush for
the same reason.  The applier keeps a separate stream CURSOR (dup-skip /
gap detection) that advances at intake — stream continuity is a
transport property, durability is not.

Exactness notes (why coalesced == per-frame, byte for byte):
  * element/register/counter writes: op application == state merge by
    design (semantics.py header), and merges are associative +
    commutative, so folding N frames and merging once equals applying
    them in order.
  * envelope times: the op path's `updated_at` is max(ct, uuid) /
    max(mt, uuid); the engine's envelope merge is the same max.  The one
    conditional case (a LOSING register write skips updated_at) is
    covered by the store invariant ct >= rv_t, which makes the
    unconditional max a no-op exactly then.
  * the element-plane key-delete rule (`sadd`/`hset`/`lins` tombstone
    their members at the key's dt when uuid < dt) reads LIVE store
    state, so it is evaluated at flush time against the then-current dt
    (KeySpace.key_delete_times) — the same values the per-key path
    would have seen, because anything that can raise dt mid-batch
    either flushes first (peer collection deletes on pending keys) or
    interleaves identically (local deletes run on the same loop, and
    scalar peer deletes ride the batch itself).

Deliberate deviations from the per-frame path, both narrow:
  * a cross-stream TYPE CONFLICT (same key, different encodings from
    different origins) is handled with snapshot-merge semantics — log
    and skip the key (engine key resolver) — instead of tearing the
    link down; a poisoned key can no longer wedge replication forever.
  * frames between the landed watermark and the stream cursor are
    redelivered after a reconnect and re-applied.  For every coalesced
    write that is an idempotent merge; for the key-scoped barrier
    sweeps it can re-run an observed-remove against newer state, an
    anomaly class concurrent delivery already exhibits on the per-frame
    path (the sweep reads local state wherever it runs).
"""

from __future__ import annotations

import logging
import time
from itertools import chain
from typing import Callable, Optional

import numpy as np

from ..engine.base import ColumnarBatch
from ..errors import CstError, ReplicateCommandsLost
from ..resp.message import as_bytes, as_int
from ..server.commands import (COLUMNAR_ENCODERS, KEY_SCOPED_BARRIERS,
                               NotColumnar, STATE_FREE_BARRIERS)
from ..server.events import EVENT_PULL_LANDED
from ..utils import trace

_I64 = np.int64

_ENC_ERRORS = (NotColumnar, CstError, IndexError)

log = logging.getLogger(__name__)


def apply_key_delete_rule(ks, b: ColumnarBatch, check) -> None:
    """The element-plane key-delete rule, against the LIVE dt of exactly
    the checked keys: an element add whose uuid predates its key's
    delete time materializes tombstoned (`sadd`/`hset`/`lins` op twin —
    see the module docstring).  `check` is the per-element-row mark the
    add-side encoders leave (None = nothing marked).  Shared by the
    coalescer's flush and the wire-batch decoder (replica/wire.py),
    which must evaluate it against the RECEIVING store."""
    if check is None or not check.any():
        return
    kis = np.unique(b.el_ki[check])
    dts = ks.key_delete_times(list(map(b.keys.__getitem__, kis.tolist())))
    if dts.any():
        dt_by_ki = np.zeros(len(b.keys), dtype=_I64)
        dt_by_ki[kis] = dts
        row_dt = dt_by_ki[b.el_ki]
        kill = check & (b.el_add_t < row_dt)
        if kill.any():
            b.el_del_t = np.where(kill, row_dt, b.el_del_t)


class BatchBuilder:
    """Columnar accumulator the group encoders write into.

    Key rows are ONE PER FRAME (no dedup — the engine's group reductions
    fold repeats, which beats a per-frame dict probe); counter/element
    rows are one per op.  The batch declares
    `rows_unique_per_slot=False`, routing the engine onto its
    duplicate-safe reductions."""

    __slots__ = ("ks", "keys", "enc", "ct", "mt", "dt", "reg_runs",
                 "_dels", "cnt_rows", "el_rows", "tns_rows",
                 "_el_has_vals", "n_rows")

    def __init__(self, ks) -> None:
        self.ks = ks
        self.keys: list[bytes] = []
        self.enc: list[int] = []
        self.ct: list[int] = []
        self.mt: list[int] = []
        self.dt: list[int] = []
        # register writes as (ki0, uuids, nodes, vals) runs — assigned
        # into the key-aligned reg plane by slice at finalize
        self.reg_runs: list[tuple] = []
        self._dels: dict[bytes, int] = {}  # key-level tombstone records
        # per-frame row records, expanded to columns at finalize
        # (np.repeat / chain do the fan-out at C speed):
        #   cnt_rows: (ki, node, total, uuid, base, base_t)
        #   el_rows:  (ki, members, vals-or-None, add_t, add_node,
        #              del_t, dt_check)
        #   tns_rows: (ki, node, uuid, cnt, cfg, payload-bytes)
        self.cnt_rows: list[tuple] = []
        self.el_rows: list[tuple] = []
        self.tns_rows: list[tuple] = []
        self._el_has_vals = False
        self.n_rows = 0

    # ------------------------------------------------------ encoder surface

    def add_keys(self, keys: list, enc: int, uuids: list) -> int:
        """A run of data-write key rows (ct=mt=uuid, dt=0 — the op
        path's get_or_create + updated_at, with repeats folded by the
        engine's envelope max).  Returns the run's first batch index."""
        ki0 = len(self.keys)
        n = len(keys)
        self.keys.extend(keys)
        self.enc.extend([enc] * n)
        self.ct.extend(uuids)
        self.mt.extend(uuids)
        self.dt.extend([0] * n)
        self.n_rows += n
        return ki0

    def add_del_keys(self, keys: list, enc: int, uuids: list) -> int:
        """A run of scalar key-level tombstones (delbytes/delcnt): dt/mt
        advance, ct does NOT (a missing key materializes
        already-tombstoned — ct=0 < dt), and each delete is recorded on
        the batch's del_keys plane so GC/tombstone accounting matches
        the per-key path (KeySpace.record_key_delete via the engine)."""
        ki0 = len(self.keys)
        n = len(keys)
        self.keys.extend(keys)
        self.enc.extend([enc] * n)
        self.ct.extend([0] * n)
        self.mt.extend(uuids)
        self.dt.extend(uuids)
        dels = self._dels
        for k, u in zip(keys, uuids):
            if dels.get(k, -1) < u:
                dels[k] = u
        self.n_rows += n
        return ki0

    def reg_run(self, ki0: int, uuids: list, nodes: list,
                vals: list) -> None:
        self.reg_runs.append((ki0, uuids, nodes, vals))

    # ------------------------------------------------------ landing surface
    # What a landing reads besides finalize() (Node.merge_stream_batch,
    # TorchMergeEngine.merge_stream; replica/wire.py WireBatch has the same
    # surface): the planned round reads the pending rows in place.

    @property
    def del_keys(self) -> list:
        return list(self._dels)

    def deletes(self):
        """(key, delete time) of every key-level tombstone, in order."""
        return self._dels.items()

    def touched(self) -> set:
        """The device families the batch merges (engine/base.py
        touched_families of what finalize() would make)."""
        fams = set()
        if any(v is not None for run in self.reg_runs for v in run[3]):
            fams.add("reg")
        if self.cnt_rows:
            fams.add("cnt")
        if any(r[1] for r in self.el_rows):
            fams.add("el")
        if self.tns_rows:
            fams.add("tns")
        return fams

    def plan_input(self) -> tuple:
        """(object, columnar) for the native round planner: the builder
        itself, read in place."""
        return self, False

    # -------------------------------------------------------------- payload

    def finalize(self) -> ColumnarBatch:
        """Materialize the pending rows as one ColumnarBatch.  The
        element-plane key-delete rule is applied HERE, against the live
        store's dt values (see module docstring)."""
        b = ColumnarBatch()
        n = len(self.keys)
        b.keys = self.keys
        b.key_enc = np.fromiter(self.enc, dtype=np.int8, count=n)
        b.key_ct = np.fromiter(self.ct, dtype=_I64, count=n)
        b.key_mt = np.fromiter(self.mt, dtype=_I64, count=n)
        b.key_dt = np.fromiter(self.dt, dtype=_I64, count=n)
        b.key_expire = np.zeros(n, dtype=_I64)
        b.reg_val = [None] * n
        b.reg_t = np.zeros(n, dtype=_I64)
        b.reg_node = np.zeros(n, dtype=_I64)
        for ki0, uuids, nodes, vals in self.reg_runs:
            hi = ki0 + len(vals)
            b.reg_val[ki0:hi] = vals
            b.reg_t[ki0:hi] = uuids
            b.reg_node[ki0:hi] = nodes

        if self.cnt_rows:
            nc = len(self.cnt_rows)
            cols = list(zip(*self.cnt_rows))  # C-speed transpose
            (b.cnt_ki, b.cnt_node, b.cnt_val, b.cnt_uuid, b.cnt_base,
             b.cnt_base_t) = (np.fromiter(c, dtype=_I64, count=nc)
                              for c in cols)

        if self.el_rows:
            recs = self.el_rows
            nr = len(recs)
            cols = list(zip(*recs))
            counts = np.fromiter(map(len, cols[1]), dtype=_I64, count=nr)
            b.el_ki = np.repeat(np.fromiter(cols[0], dtype=_I64, count=nr),
                                counts)
            b.el_member = list(chain.from_iterable(cols[1]))
            ne = len(b.el_member)
            if self._el_has_vals:
                b.el_val = list(chain.from_iterable(
                    v if v is not None else (None,) * int(c)
                    for v, c in zip(cols[2], counts)))
            else:
                b.el_val = [None] * ne
                b.el_has_vals = False
            b.el_add_t = np.repeat(
                np.fromiter(cols[3], dtype=_I64, count=nr), counts)
            b.el_add_node = np.repeat(
                np.fromiter(cols[4], dtype=_I64, count=nr), counts)
            b.el_del_t = np.repeat(
                np.fromiter(cols[5], dtype=_I64, count=nr), counts)
            check = np.repeat(
                np.fromiter(cols[6], dtype=bool, count=nr), counts)
            # the key-delete rule, against the LIVE dt of exactly the
            # checked keys (not the whole batch key list)
            apply_key_delete_rule(self.ks, b, check)
        if self.tns_rows:
            nt = len(self.tns_rows)
            cols = list(zip(*self.tns_rows))
            (b.tns_ki, b.tns_node, b.tns_uuid,
             b.tns_cnt) = (np.fromiter(c, dtype=_I64, count=nt)
                           for c in cols[:4])
            b.tns_cfg = list(cols[4])
            b.tns_payload = list(cols[5])

        if self._dels:
            b.del_keys = list(self._dels.keys())
            b.del_t = np.fromiter(self._dels.values(), dtype=_I64,
                                  count=len(self._dels))
        # raw op stream: keys and slots may repeat across frames — the
        # engine must take its duplicate-safe reductions, not the
        # one-scatter-per-slot bulk placement
        b.rows_unique_per_slot = False
        return b


class CoalescingApplier:
    """Per-connection coalescer driving one peer's replicate stream into
    the node (see module docstring for the discipline)."""

    __slots__ = ("node", "meta", "max_frames", "max_latency", "_now",
                 "cursor", "_epoch", "_buf", "_pending_keys", "_frames",
                 "_first_ts", "_pending_beacon", "_enc_has",
                 "pending_bytes")

    def __init__(self, node, meta, max_frames: Optional[int] = None,
                 max_latency: Optional[float] = None,
                 now: Callable[[], float] = time.monotonic) -> None:
        from ..conf import env_float, env_int
        self.node = node
        self.meta = meta
        self.max_frames = env_int("CONSTDB_TORCH_APPLY_BATCH", 512) \
            if max_frames is None else max_frames
        self.max_latency = (env_float("CONSTDB_TORCH_APPLY_LATENCY_MS", 5.0)
                            / 1000.0) if max_latency is None else max_latency
        self._now = now
        # stream cursor: newest uuid RECEIVED gap-free on this connection
        # (dup-skip + gap detection); meta.uuid_he_sent lags it until the
        # covering batch lands
        self.cursor = meta.uuid_he_sent
        self._epoch = node.reset_epoch
        self._buf: dict[bytes, list] = {}   # command -> [(key, origin,
        #                                     uuid, frame items)]
        self._pending_keys: set[bytes] = set()
        self._frames = 0
        self._first_ts = 0.0
        self._pending_beacon = 0
        # received-but-unlanded frame bytes, for the overload governor's
        # accounting (the pull loop registers a source reading this —
        # replica/link.py); approximate (payload bytes + a fixed
        # per-frame overhead), zeroed by every flush
        self.pending_bytes = 0
        # bound C-level membership test for the per-frame dispatch;
        # batch=1 pins the per-frame path by never consulting it
        self._enc_has = COLUMNAR_ENCODERS.__contains__ \
            if self.max_frames > 1 else (lambda _name: False)

    # ------------------------------------------------------------ inspection

    @property
    def pending(self) -> int:
        """Frames received but not yet landed in the store."""
        return self._frames

    # async twins of apply/flush: the pull loop awaits these so one code
    # path drives both this applier and the shard-routing one (which
    # genuinely awaits worker acks — server/serve_shards.py ShardApplier)

    async def aapply(self, items: list) -> None:
        self.apply(items)

    async def aabatch(self, items: list) -> None:
        self.apply_wire_batch(items)

    async def aflush(self) -> None:
        self.flush()

    # --------------------------------------------------------------- intake

    def apply(self, items: list) -> None:
        """One REPLICATE frame (`items` = the full wire frame).  Either
        buffers it for the next coalesced flush or barrier-applies it;
        dup/gap semantics match the per-frame path exactly."""
        cursor = self.cursor
        uuid = as_int(items[3])
        if uuid <= cursor:
            return  # duplicate (reconnect overlap) — idempotent skip
        if as_int(items[2]) > cursor:  # prev_uuid gap check
            # land what we have (gap-free below the cursor) before the
            # teardown: the advanced watermark shrinks the resync replay
            self.flush()
            raise ReplicateCommandsLost(
                f"{self.meta.addr}: gap {cursor} -> {as_int(items[2])}")
        name = as_bytes(items[4])
        if not self._enc_has(name) or len(items) < 6:
            self._barrier(name, items, as_int(items[1]), uuid)
            return
        key = as_bytes(items[5])
        buf = self._buf
        recs = buf.get(name)
        if recs is None:
            recs = buf[name] = []
        f = self._frames
        if not f:
            self._first_ts = self._now()
        recs.append((key, as_int(items[1]), uuid, items))
        self._pending_keys.add(key)
        sz = 48
        for it in items:
            v = getattr(it, "val", None)
            if type(v) is bytes:
                sz += len(v)
        self.pending_bytes += sz
        f += 1
        self._frames = f
        self.cursor = uuid
        # the latency bound is sampled every 32 frames, not every frame:
        # under sustained load (the only regime where the count bound has
        # not fired first) 32 frames pass in well under a millisecond,
        # and a SLOW stream is flushed by the pull loop's idle check
        # before this clause could ever matter
        if f >= self.max_frames or \
                (not f & 31 and
                 self._now() - self._first_ts >= self.max_latency):
            self.flush()

    def apply_wire_batch(self, items: list) -> None:
        """One REPLBATCH frame — a pusher-side group-encoded run of
        consecutive encodable ops (replica/wire.py).  Delivery
        bookkeeping runs ONCE for the whole run: any pending per-frame
        buffer flushes first (stream order), dup/gap checks compare the
        batch header to the cursor, the decoded ColumnarBatch lands
        through `Node.merge_stream_batch`, and the watermark advances
        over the batch only after landing (watermark-after-land).  A
        batch that overlaps the cursor (reconnect redelivery) re-merges
        whole — every op in it is an idempotent merge by the same
        argument the redelivery note in the module docstring makes.

        A payload that fails to decode is LOUD: the link tears down
        (CstError), the peer meta stops advertising CAP_BATCH_STREAM, so
        the redelivery window arrives as ordinary per-frame frames —
        demotion, never silent desync."""
        meta = self.meta
        if len(items) < 6:
            raise CstError(f"{meta.addr}: malformed replbatch frame")
        origin = as_int(items[1])
        first_prev = as_int(items[2])
        last = as_int(items[3])
        n = as_int(items[4])
        payload = as_bytes(items[5])
        if n < 1 or last <= first_prev:
            raise CstError(f"{meta.addr}: bad replbatch header")
        if self._frames:
            self.flush()  # stream order: buffered frames land first
        cursor = self.cursor
        if last <= cursor:
            return  # duplicate batch (reconnect overlap) — idempotent skip
        if first_prev > cursor:
            raise ReplicateCommandsLost(
                f"{meta.addr}: gap {cursor} -> {first_prev}")
        node = self.node
        if node.reset_epoch != self._epoch:
            # a state wipe landed since this stream was installed: these
            # ops describe pre-wipe state (see flush)
            self._pending_beacon = 0
            return
        from . import wire
        from ..utils.compressio import (CompressFormatError,
                                        decompress_bytes, is_compressed)
        try:
            if is_compressed(payload):
                # negotiated stream compression (CAP_COMPRESS): inflate
                # with per-chunk crc validation before the batch codec
                # ever sees a byte — a defect in EITHER layer demotes
                # identically below.  The inflated size is capped at the
                # largest payload an honest pusher can produce (one
                # proto-max value plus batch framing slack): a crafted
                # container cannot bomb the intake past what the plain
                # wire already admits (reject-before-allocate law).
                from ..conf import env_int
                cap = env_int("CONSTDB_TORCH_PROTO_MAX_BULK", 512 << 20) \
                    + (64 << 20)
                raw = decompress_bytes(payload, max_raw=cap)
                x = node.stats.extra
                x["repl_comp_batches_in"] = \
                    x.get("repl_comp_batches_in", 0) + 1
                payload = raw
            wb = wire.decode_wire_batch(payload, node.ks, origin,
                                        first_prev)
            if wb.n_frames != n:
                raise wire.WireFormatError(
                    f"header says {n} frames, payload holds {wb.n_frames}")
        except CompressFormatError as e:
            st = node.stats
            st.repl_wire_demotions += 1
            x = st.extra
            x["repl_compress_demotions"] = \
                x.get("repl_compress_demotions", 0) + 1
            meta.compress_wire_off = True
            log.error(
                "compressed replbatch from %s is malformed (%s); "
                "demoting this peer's stream to plain delivery and "
                "resyncing from the landed watermark", meta.addr, e)
            raise CstError(
                f"{meta.addr}: malformed compressed replbatch") from None
        except wire.WireFormatError as e:
            st = node.stats
            st.repl_wire_demotions += 1
            meta.batch_wire_off = True
            log.error(
                "replbatch from %s is malformed (%s); demoting this "
                "peer's stream to per-frame delivery and resyncing from "
                "the landed watermark", meta.addr, e)
            raise CstError(
                f"{meta.addr}: malformed replbatch payload") from None
        st = node.stats
        st.cmds_replicated += n
        st.repl_wire_batches_in += 1
        st.repl_wire_batch_frames_in += n
        node.hlc.observe(last)
        node.merge_stream_batch(wb, n)
        if node.oplog is not None:
            # the (decompressed) payload IS the columnar wire encoding
            # and was just crc-validated whole: splice it into the
            # durable op log verbatim — zero re-encode (persist/oplog.py)
            node.oplog.append_batch(origin, first_prev, last, n, payload)
        self.cursor = last
        self._advance(last, wake=True)

    def observe_beacon(self, beacon: int) -> None:
        """REPLACK drained-stream beacon: may only advance the pull
        watermark once every frame it covers has LANDED — with frames
        pending it is stashed and applied by the covering flush."""
        if self._frames:
            if beacon > max(self.cursor, self._pending_beacon):
                self._pending_beacon = beacon
                self.node.hlc.observe(beacon)
        elif beacon > self.meta.uuid_he_sent:
            self.meta.uuid_he_sent = beacon
            if beacon > self.cursor:
                self.cursor = beacon
            self.node.hlc.observe(beacon)

    def resync(self) -> None:
        """Re-anchor after an out-of-band watermark move on this SAME
        connection (FULLSYNC apply, possibly with a state wipe).  Only
        valid with nothing pending — snapshot frames are barriers."""
        self.cursor = self.meta.uuid_he_sent
        self._pending_beacon = 0
        self._epoch = self.node.reset_epoch

    # ---------------------------------------------------------------- land

    def flush(self) -> None:
        """Group-encode the buffered frames, land them through the merge
        engine, and advance the watermark over them (the load-bearing
        ORDER: merge first, watermark after — docs/INVARIANTS.md).

        A run whose group encoder rejects it (malformed frame, in-batch
        type conflict) is retried frame by frame — the builder is
        untouched on failure (parse-then-mutate contract) — and the
        leftovers replay on the exact per-key path after the merge
        (legal by commutativity), raising the exact op-path error."""
        buf, self._buf = self._buf, {}
        frames, self._frames = self._frames, 0
        self.pending_bytes = 0
        if not frames:
            return
        self._pending_keys.clear()
        node = self.node
        if node.reset_epoch != self._epoch:
            # a state wipe landed between intake and flush (another
            # link's reset snapshot): these frames describe pre-wipe
            # state and the zeroed watermark must not re-advance —
            # drop them; the wiped store is re-seeded by the resync
            self._pending_beacon = 0
            return
        if node.oplog is not None:
            # mirror the frames this flush LANDS, in uuid order, before
            # the merge: appended-but-unlanded on a crash replays as an
            # idempotent superset, while land-without-append could lose
            # an acked-upstream op (persist/oplog.py)
            allrecs = sorted(
                (r[2], r[1], name, r[3])
                for name, recs in buf.items() for r in recs)
            for uuid, origin, name, items in allrecs:
                node.oplog.append_frame(origin, uuid, name,
                                        list(items[5:]))
        bb = BatchBuilder(node.ks)
        failures: list = []
        with trace.span("replica.encode", into=node.stats.spans):
            for name, recs in buf.items():
                enc = COLUMNAR_ENCODERS[name]
                try:
                    enc(bb, recs)
                except _ENC_ERRORS:
                    for r in recs:
                        try:
                            enc(bb, [r])
                        except _ENC_ERRORS:
                            failures.append((name, r))
        # per-flush bookkeeping, not per-frame (hot path): the stats
        # total matches the per-frame path's per-apply bumps, and the
        # clock observes the batch's newest uuid exactly when its
        # effects land — the coalesced analog of observe-at-apply
        node.stats.cmds_replicated += frames - len(failures)
        node.hlc.observe(self.cursor)
        node.merge_stream_batch(bb, frames - len(failures))
        if failures:
            failures.sort(key=lambda f: f[1][2])  # uuid order
            for name, r in failures:
                # the exact per-key path raises the exact op-path error;
                # a raise here leaves the watermark at the previous
                # flush, so the whole window redelivers on reconnect
                # (idempotent) and the bad frame fails again — the
                # per-frame path's behavior for malformed frames
                node.stats.repl_apply_barriers += 1
                node.apply_replicated(name, r[3][5:], r[1], r[2],
                                      cause="barrier")
        self._advance(self.cursor, wake=frames - len(failures) >= 2)

    def _barrier(self, name: bytes, items: list, origin: int,
                 uuid: int) -> None:
        """Non-encodable frame: the exact per-key path (reference
        pull.rs:184-235 apply_his_replicates).  The pending batch
        flushes first ONLY when the frame can actually observe it:
        membership ops never touch the keyspace, and the key-scoped
        sweeps (collection deletes / expireat / mvwrite) read live rows
        of exactly their first-argument key — with that key untouched by
        the batch, the frame commutes with every pending row and may
        apply in place.  A non-flushing barrier advances only the stream
        CURSOR; the watermark keeps waiting for the covering flush
        (re-applying such a frame after a crash-replay converges — see
        the module docstring's redelivery note)."""
        node = self.node
        if self._frames:
            scoped = name in KEY_SCOPED_BARRIERS and len(items) > 5 and \
                as_bytes(items[5]) not in self._pending_keys
            if not (scoped or name in STATE_FREE_BARRIERS):
                self.flush()
        node.stats.repl_apply_barriers += 1
        node.apply_replicated(name, items[5:], origin, uuid, cause="barrier")
        if node.oplog is not None:
            node.oplog.append_frame(origin, uuid, name, list(items[5:]))
        self.cursor = uuid
        if not self._frames:
            self._advance(uuid)

    def _advance(self, uuid: int, wake: bool = False) -> None:
        """Watermark-after-land.  `wake`: this land covered a genuine
        BATCH (a multi-frame flush or a wire batch) — wake the push loop
        to REPLACK it now, one ack per covering batch.  Single-frame
        lands (barriers, trickle traffic) do NOT wake: their acks ride
        the heartbeat exactly as before, because a per-land wake there
        IS an ack per frame — the cadence this satellite removes — and
        each wake costs every link a scheduler round trip."""
        beacon, self._pending_beacon = self._pending_beacon, 0
        w = max(uuid, beacon)
        if w > self.meta.uuid_he_sent:
            self.meta.uuid_he_sent = w
            if wake:
                self.node.events.trigger(EVENT_PULL_LANDED)
        if beacon > self.cursor:
            self.cursor = beacon
