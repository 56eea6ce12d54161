"""Shard-per-core serving plane: route the client path across host cores
(the port's copy).

The hash-sharded keyspace and a forkserver worker pool accelerate the
snapshot ingest; this module turns that machinery into the SERVING
architecture.  With `CONSTDB_TORCH_SERVE_SHARDS=N` (N > 1) a node runs
N serve workers (parallel/serve_pool.py), each owning one keyspace shard
+ merge engine + repl-log segment, and the event loop becomes a ROUTER:

  * **key-hash routing** — every first-key-confined command (all data
    commands; the KEY-CONFINED lint rule pins the convention) executes
    entirely inside the worker owning `crc32(key) % N`, through the same
    ServeCoalescer machinery the single loop uses.  Pipelined chunks
    ship as one sub-chunk per shard, so the per-command pipe cost
    amortizes exactly like the per-command merge cost did.
  * **central clock** — the parent mints EVERY uuid at route time with
    the same `tick(is_write)` discipline `commands.execute` applies, in
    request order.  The uuid stream is therefore byte-identical to the
    single-loop path's, which is what makes the multi-shard differential
    suite able to demand byte-identical replies, exports, and merged
    repl logs (tests/test_torch_serve_shards.py).
  * **ordered barrier plane** — cross-shard commands (admin/CTRL,
    membership, INFO, SYNC upgrades) quiesce the chunk's outstanding
    sub-chunks, then execute on the parent loop, exactly mirroring the
    intra-connection barrier semantics of the single loop.
  * **merge-sorted peer stream** — each worker's locally-executed writes
    mirror into that shard's parent-side repl-log segment as acks land;
    `MergedReplLog` (server/repl_log.py) merge-sorts the segments back
    into one HLC-ordered stream, gated below the FLOOR (the smallest
    minted-but-unlanded write uuid) so emission order is strictly
    increasing.  Watermarks, REPLACK beacons, and the partial-resync
    decision are unchanged on the wire — an unmodified peer replicates
    from a sharded node without knowing it is sharded.

`CONSTDB_TORCH_SERVE_SHARDS=1` (the default) never constructs this plane —
the node runs the exact single-loop path, byte for byte.

Differences from the JAX package's plane: the workers run the node's own
engine kind on its device (a TorchMergeEngine node's workers each build
a resident TorchMergeEngine there, so a card node's shards merge on the
card, never silently on the CPU; a CPU-engine node's workers the CPU
engine), and each worker's kernel launches, device rounds and peak
device memory ride its acks into `serve_shard<i>_*` gauges (INFO).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from ..errors import CstError, ReplicateCommandsLost
from ..resp.codec import encode_into
from ..resp.message import Arr, Bulk, NoReply, as_bytes, as_int
from ..store.sharded_keyspace import MAX_SHARDS, shard_of
from .commands import (CMD_CTRL, CMD_REPL_ONLY, COMMANDS,
                       STATE_FREE_BARRIERS, shard_routable)
from .events import EVENT_DELETED, EVENT_PULL_LANDED, EVENT_REPLICATED
from .repl_log import MergedReplLog

log = logging.getLogger(__name__)

_STAT_GAUGES = (("msgs", "msgs"), ("flushes", "flushes"),
                ("barriers", "barriers"), ("keys", "keys"),
                ("used_bytes", "used_bytes"),
                ("reads", "reads"), ("read_flushes", "read_flushes"),
                ("cache_hits", "cache_hits"),
                ("cache_misses", "cache_misses"),
                ("cache_bytes", "cache_bytes"),
                ("kernel_launches", "launches"),
                ("dev_rounds", "dev_rounds"),
                ("device_mem_peak", "mem_peak"))


class _Sub:
    """One shard's slice of the pre-barrier run being classified."""

    __slots__ = ("msgs", "uuids", "idxs", "token")

    def __init__(self) -> None:
        self.msgs: list = []
        self.uuids: list = []
        self.idxs: list = []
        self.token: Optional[int] = None


class ServeShardPlane:
    """Parent-side router + authority for a shard-per-core serving node
    (see module docstring)."""

    def __init__(self, app, n_shards: int):
        if not 2 <= n_shards <= MAX_SHARDS:
            raise ValueError(f"serve_shards must be in [2, {MAX_SHARDS}]")
        self.app = app
        self.node = app.node
        self.n_shards = n_shards
        eng = self.node.engine
        card = getattr(eng, "name", "") == "cuda"
        self.engine_spec = "cuda" if card else "cpu"
        self.device = eng.device if card else None
        self.pool = None
        self.merged = MergedReplLog(n_shards,
                                    cap_bytes=self.node.repl_log.cap)
        self.merged.floor = self._floor
        self.merged.pending_high = self._pending_high
        # minted-but-unlanded write uuid windows: token -> [wmin, wmax].
        # Opened at MINT time (before any await can let the push loop
        # emit a newer entry), closed by the serve-ack callback AFTER
        # the worker's log entries mirrored into the segment.
        self._inflight: dict[int, list] = {}
        self._next_token = 0
        self._last_stats = [dict() for _ in range(n_shards)]
        # Serve-ack ORDERING: worker futures complete FIFO per shard,
        # but their handlers can run out of order ACROSS connections —
        # one connection's inline quiesce ack for a later window vs
        # another connection's still-queued done-callback for an
        # earlier one.  Mirroring the later window's entries into the
        # segment first would make push_many reject the earlier
        # window (uuid regression) and silently LOSE its acked writes
        # from the repl stream and the AOF.  Every dispatched
        # sub-chunk takes a per-shard ticket; handlers drain tickets
        # strictly in ticket order (worker FIFO means a later future
        # being done implies every earlier one is).
        self._ack_pend: list[dict] = [dict() for _ in range(n_shards)]
        self._ack_seq = [0] * n_shards
        self._ack_next = [0] * n_shards

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        from ..parallel.serve_pool import ServeShardPool
        node = self.node
        gov = node.governor
        self.pool = ServeShardPool(self.n_shards,
                                   engine_spec=self.engine_spec,
                                   node_id=node.node_id, alias=node.alias,
                                   serve_batch=self.app.serve_batch,
                                   # each worker governs its slice of
                                   # the node cap (serve_pool worker
                                   # main; 0 stays unlimited)
                                   maxmemory=gov.maxmemory
                                   // self.n_shards,
                                   maxmemory_soft_pct=gov.soft_pct,
                                   device=self.device)
        node.serve_plane = self
        node.repl_log = self.merged
        x = node.stats.extra
        x["serve_shards"] = self.n_shards
        x["serve_shard_map"] = f"crc32(key)%{self.n_shards}"
        x.setdefault("serve_xshard_barriers", 0)
        log.info("serve plane up: %d shard workers (engine=%s on %s)",
                 self.n_shards, self.engine_spec, self.device or "cpu")

    async def close(self) -> None:
        if self.pool is not None:
            await self.pool.close()

    # ------------------------------------------------------- floor windows

    def _floor(self) -> Optional[int]:
        if not self._inflight:
            return None
        return min(w[0] for w in self._inflight.values())

    def _pending_high(self) -> int:
        if not self._inflight:
            return 0
        return max(w[1] for w in self._inflight.values())

    def _open_window(self, uuid: int) -> int:
        tok = self._next_token
        self._next_token += 1
        self._inflight[tok] = [uuid, uuid]
        return tok

    # ------------------------------------------------------------- routing

    async def run_chunk(self, msgs: list, out: bytearray,
                        client=None) -> None:
        """Plan, route, and execute one drained chunk of client
        messages, appending every reply to `out` in request order.

        `client` is the connection's ClientConn (server/tracking.py).
        The PARENT owns every tracked subscription on a sharded node —
        invalidation streams fold through this routing plane: a routed
        write invalidates at route time (before the worker executes it,
        so invalidate-before-visible holds), a routed read feeds
        default-mode note_read, and barrier commands carry the client
        into the parent-side execute (HELLO / CLIENT TRACKING work
        unchanged)."""
        node = self.node
        tracking = node.tracking
        n = len(msgs)
        if not n:
            return
        replies: list = [b""] * n
        subs: dict[int, _Sub] = {}
        futs: list = []       # (future, idxs) of dispatched sub-chunks
        opened: set = set()   # window tokens opened by this chunk
        dispatched: set = set()
        lone = n == 1

        def dispatch() -> None:
            # synchronous by design: no suspension point may separate
            # uuid minting from the pipe write (parallel/serve_pool.py)
            for shard, sub in subs.items():
                payload = bytearray()
                for m in sub.msgs:
                    encode_into(payload, m)
                fut = self.pool.submit(
                    shard, ("serve", bytes(payload), sub.uuids,
                            len(sub.msgs)))
                if sub.token is not None:
                    dispatched.add(sub.token)
                seq = self._ack_seq[shard]
                self._ack_seq[shard] = seq + 1
                self._ack_pend[shard][seq] = (sub.token, fut)
                fut.add_done_callback(
                    lambda f, s=shard: self._on_serve_ack(s))
                futs.append((fut, sub.idxs, shard, sub.token))
            subs.clear()

        async def quiesce() -> None:
            dispatch()
            for fut, idxs, shard, token in futs:
                res = await fut
                # run the ack bookkeeping NOW, not "soon": a future that
                # resolved while this loop was awaiting an EARLIER one
                # returns from its await without yielding, with its
                # done-callback still queued behind this task's wakeup —
                # a barrier executing right after quiesce would then
                # read the merged repl_log MISSING entries whose writes
                # already replied OK (found by the overload round's
                # stress runs: REPLLOG UUIDS intermittently saw one
                # shard's sub-chunk absent).  The ticket drain is
                # idempotent, so the still-queued callback is a no-op —
                # and remains the mirror-of-record when a client
                # disconnect cancels this coroutine mid-quiesce.
                self._on_serve_ack(shard)
                sout, spans = res[0], res[1]
                prev = 0
                for j, idx in enumerate(idxs):
                    replies[idx] = sout[prev:spans[j]]
                    prev = spans[j]
            futs.clear()

        try:
            for i, msg in enumerate(msgs):
                routed = False
                items = msg.items if type(msg) is Arr else None
                cmd = None
                if items:
                    head = items[0]
                    name = head.val if type(head) is Bulk else None
                    if name is not None:
                        cmd = COMMANDS.get(name) or COMMANDS.get(name.lower())
                if cmd is not None and shard_routable(cmd) and \
                        not (cmd.flags & CMD_REPL_ONLY) and len(items) > 1:
                    try:
                        key = as_bytes(items[1])
                    except Exception:
                        key = None  # execute() raises the exact op error
                    if key is not None:
                        if tracking is not None and tracking.active:
                            if cmd.is_write:
                                tracking.invalidate_key(key)
                            elif client is not None and \
                                    client.tracking == 1:
                                tracking.note_read(client, key)
                        shard = shard_of(key, self.n_shards)
                        uuid = node.hlc.tick(cmd.is_write)
                        sub = subs.get(shard)
                        if sub is None:
                            sub = subs[shard] = _Sub()
                        if cmd.is_write:
                            if sub.token is None:
                                sub.token = self._open_window(uuid)
                                opened.add(sub.token)
                            else:
                                self._inflight[sub.token][1] = uuid
                        sub.msgs.append(msg)
                        sub.uuids.append(uuid)
                        sub.idxs.append(i)
                        routed = True
                if routed:
                    continue
                # ordered barrier plane: land this chunk's outstanding
                # routed commands, then execute on the parent loop
                had_outstanding = bool(subs) or bool(futs)
                await quiesce()
                if had_outstanding:
                    node.stats.extra["serve_xshard_barriers"] = \
                        node.stats.extra.get("serve_xshard_barriers", 0) + 1
                reply = node.execute(msg, client=client)
                if not lone:
                    node.stats.serve_barriers += 1
                if not isinstance(reply, NoReply):
                    buf = bytearray()
                    encode_into(buf, reply)
                    replies[i] = bytes(buf)
                if cmd is not None and cmd.flags & CMD_CTRL:
                    # CTRL can change the node identity the workers
                    # stamp into writes (NODE ID) — resync them
                    await self.pool.call_all("ident", node.node_id,
                                             node.alias)
            await quiesce()
        finally:
            for tok in opened - dispatched:
                self._inflight.pop(tok, None)
        for r in replies:
            out += r

    def _on_serve_ack(self, shard: int) -> None:
        """Reply-order ack bookkeeping (FIFO per shard): drain this
        shard's ack tickets strictly in dispatch order, stopping at the
        first unresolved future.  Called both inline from quiesce()
        for already-resolved futures (see the race note there) and
        from every done-callback; each ticket is processed exactly
        once, and a ticket is never processed before every earlier
        ticket of its shard — the ordering push_many and the AOF
        segment mirror both require."""
        pend = self._ack_pend[shard]
        while True:
            entry = pend.get(self._ack_next[shard])
            if entry is None or not entry[1].done():
                return
            del pend[self._ack_next[shard]]
            self._ack_next[shard] += 1
            self._ack_one(shard, entry[0], entry[1])

    def _ack_one(self, shard: int, token: Optional[int], fut) -> None:
        """Land one resolved sub-chunk: mirror the worker's log entries
        into this shard's segment (and the AOF), then release the floor
        window, then wake the pushers — that order is what keeps the
        merged stream strictly increasing."""
        if fut.cancelled() or fut.exception() is not None:
            # the worker failed mid-chunk: its entries may be missing,
            # so the window stays HELD — the peer stream stalls on this
            # shard instead of silently skipping ops (the awaiting
            # connection sees the raised error)
            log.error("serve worker %d chunk failed; holding repl floor: "
                      "%s", shard,
                      None if fut.cancelled() else fut.exception())
            return
        _out, _spans, entries, deleted, stats = fut.result()
        node = self.node
        if entries:
            self.merged.segments[shard].push_many(entries)
            if node.oplog is not None:
                # the shard's durable segment mirrors in the same ack
                # order as its repl-log segment (persist/oplog.py:
                # per-shard segment files, merged by HLC at replay)
                for uuid, name, args in entries:
                    node.oplog.append_local(uuid, name, args, seg=shard)
        if token is not None:
            self._inflight.pop(token, None)
        if entries:
            node.events.trigger(EVENT_REPLICATED, entries[-1][0])
        if deleted:
            node.events.trigger(EVENT_DELETED)
        self._fold_stats(shard, stats)

    def _fold_stats(self, shard: int, stats: dict) -> None:
        node = self.node
        last = self._last_stats[shard]
        st = node.stats
        st.cmds_processed += stats["cmds"] - last.get("cmds", 0)
        st.cmds_replicated += stats["repl"] - last.get("repl", 0)
        st.serve_msgs_coalesced += stats["msgs"] - last.get("msgs", 0)
        st.serve_flushes += stats["flushes"] - last.get("flushes", 0)
        st.serve_barriers += stats["barriers"] - last.get("barriers", 0)
        # read-plane worker deltas fold into the node totals: the stat
        # counters directly, the cache counters into the parent's cache
        # object (unused for serving in sharded mode, so its own counts
        # stay zero and the fold IS the node total)
        st.serve_reads_coalesced += stats["reads"] - last.get("reads", 0)
        st.serve_read_flushes += \
            stats["read_flushes"] - last.get("read_flushes", 0)
        rc = node.read_cache
        rc.hits += stats["cache_hits"] - last.get("cache_hits", 0)
        rc.misses += stats["cache_misses"] - last.get("cache_misses", 0)
        rc.invalidations += stats["cache_inv"] - last.get("cache_inv", 0)
        st.repl_apply_barriers += \
            stats["apply_barriers"] - last.get("apply_barriers", 0)
        st.oom_shed_writes += stats["oom_shed"] - last.get("oom_shed", 0)
        if stats.get("lat"):
            st.serve_lat.extend(stats["lat"])
        self._last_stats[shard] = stats
        x = st.extra
        for ext, key in _STAT_GAUGES:
            x[f"serve_shard{shard}_{ext}"] = stats[key]

    # -------------------------------------------------- replication (pull)

    def make_applier(self, meta, max_frames=None, max_latency=None,
                     now=time.monotonic) -> "ShardApplier":
        return ShardApplier(self, meta, max_frames=max_frames,
                            max_latency=max_latency, now=now)

    # -------------------------------------------------------- bulk / reads

    async def ingest_batches(self, batches) -> int:
        """Fan decoded snapshot batches out to the shard workers by key
        hash (the receive side of a full sync).  Awaits per batch, so
        the loop stays live between groups; returns rows applied."""
        from ..persist.snapshot import _encode_batch
        from ..store.sharded_keyspace import extract_shard, shard_ids
        applied = 0
        x = self.node.stats.extra
        tracking = self.node.tracking
        try:
            for b in batches:
                if tracking is not None and tracking.active:
                    # bulk intake (full/delta sync) mutates worker state
                    # without touching the parent command path — the
                    # tracked-invalidation fold happens here, pre-merge
                    tracking.invalidate_keys(b.keys)
                    if b.del_keys:
                        tracking.invalidate_keys(b.del_keys)
                sids = shard_ids(b.keys, self.n_shards)
                dsids = shard_ids(b.del_keys, self.n_shards) \
                    if b.del_keys else None
                futs = []
                for s in range(self.n_shards):
                    sub = extract_shard(b, sids, dsids, s)
                    if sub.n_rows or sub.del_keys:
                        payload = bytes(_encode_batch(sub))
                        futs.append((s, self.pool.submit(
                            s, ("merge", payload))))
                for s, f in futs:
                    rows, nkeys = await f
                    applied += rows
                    x[f"serve_shard{s}_keys"] = nkeys
        finally:
            # even a PARTIAL ingest invalidates the shared full-sync
            # dump: bulk-merged rows bypass the repl_log, so a cached
            # dump plus a log tail would silently omit them (the plain
            # path invalidates per merge_batches call)
            self.node._dump_stale()
        return applied

    async def export_batches(self) -> list:
        """Whole-state columnar export of every shard (quiesced +
        flushed) — the full-sync dump feed (persist/share.py)."""
        from ..persist.snapshot import _decode_batch
        payloads = await self.pool.call_all("export")
        return [_decode_batch(p) for p in payloads]

    async def key_count(self) -> int:
        """Live key total across the workers (delta-sync leaf sizing,
        replica/link.py _send_delta).  Asked of the workers directly:
        the `serve_shard<i>_keys` stat gauges only update on serve-chunk
        acks and catch-up ingests, so a node whose state arrived purely
        via the replication stream would size its digest from zero and
        collapse the leaf granularity."""
        return sum(await self.pool.call_all("n_keys"))

    async def state_digest(self, fanout: int, leaves: int):
        """The plane's (fanout, leaves) anti-entropy digest matrix
        (replica/link.py delta sync): each worker folds ITS disjoint key
        set over the negotiated crc32 partition and the parent sums the
        matrices — the fold is an unordered sum, so plane-wide = Σ
        per-worker whatever the worker count (store/digest.py)."""
        from ..store.digest import sum_matrices
        mats = await self.pool.call_all("digest", fanout, leaves)
        return sum_matrices(mats, fanout, leaves).astype("<u8")

    async def export_bucket_payloads(self, fanout: int, leaves: int,
                                     mask, chunk_keys: int = 1 << 16
                                     ) -> list:
        """Encoded BATCH-section chunks of the masked digest buckets'
        state, from every worker (the delta-sync stream's payload —
        written as-is via SnapshotWriter.write_chunk_raw, no parent-side
        decode/re-encode)."""
        import numpy as np
        parts = await self.pool.call_all(
            "digest_export", fanout, leaves,
            np.asarray(mask, dtype=bool).tobytes(), chunk_keys)
        return [p for chunks in parts for p in chunks]

    async def canonical(self, keys=None) -> dict:
        if keys is None:
            parts = await self.pool.call_all("canonical", None)
        else:
            per: list[list] = [[] for _ in range(self.n_shards)]
            for k in keys:
                per[shard_of(k, self.n_shards)].append(k)
            futs = [self.pool.submit(s, ("canonical", per[s]))
                    for s in range(self.n_shards) if per[s]]
            parts = list(await asyncio.gather(*futs))
        out: dict = {}
        for p in parts:
            out.update(p)
        return out

    async def state_bytes_per_shard(self) -> list:
        return await self.pool.call_all("state_bytes")

    async def gc(self, horizon: int) -> int:
        freed = sum(await self.pool.call_all("gc", horizon))
        self.node.stats.gc_freed += freed
        return freed

    async def reset_for_resync(self, keep_link=None) -> None:
        """The plane twin of Node.reset_for_full_resync: quiesce, wipe
        every shard worker, fence fresh segments at the pre-wipe
        watermark, and kick every other live peer connection."""
        node = self.node
        tr = node.tracking
        if tr is not None and tr.active:
            tr.flush_all()  # the wiped state invalidates EVERY near-cache
        await self.pool.barrier()
        fence = max(self.merged.last_uuid, node.hlc.current)
        await self.pool.call_all("reset")
        merged = MergedReplLog(self.n_shards, cap_bytes=self.merged.cap)
        merged.floor = self._floor
        merged.pending_high = self._pending_high
        merged.last_uuid = fence
        merged.evicted_up_to = fence
        self.merged = merged
        node.repl_log = merged
        self._inflight.clear()
        if node.oplog is not None:
            # same rule as Node.reset_for_full_resync: the log describes
            # discarded state — truncate + fence + reinstall the floor
            # on the fresh merged log (persist/oplog.py on_wipe)
            node.oplog.on_wipe(fence)
        node._kick_peers_after_wipe(keep_link)


class ShardApplier:
    """Peer-stream applier for a sharded node: intake (dup-skip / gap /
    cursor) stays on the parent loop, frames route to the worker owning
    their key and apply there on the exact per-key op path — cross-shard
    parallelism replaces in-shard coalescing.  Watermark discipline is
    identical to replica/coalesce.py: `meta.uuid_he_sent` advances only
    after the covering worker acks land, beacons are stashed while
    frames are pending, and membership frames apply in place (they never
    touch the keyspace)."""

    needs_flush_async = True

    __slots__ = ("plane", "node", "meta", "max_frames", "max_latency",
                 "_now", "cursor", "_epoch", "_bufs", "_counts", "_frames",
                 "_first_ts", "_pending_beacon")

    def __init__(self, plane: ServeShardPlane, meta, max_frames=None,
                 max_latency=None, now=time.monotonic) -> None:
        from ..conf import env_float, env_int
        self.plane = plane
        self.node = plane.node
        self.meta = meta
        self.max_frames = env_int("CONSTDB_TORCH_APPLY_BATCH", 512) \
            if max_frames is None else max_frames
        self.max_latency = (env_float("CONSTDB_TORCH_APPLY_LATENCY_MS", 5.0)
                            / 1000.0) if max_latency is None else max_latency
        self._now = now
        self.cursor = meta.uuid_he_sent
        self._epoch = plane.node.reset_epoch
        self._bufs = [bytearray() for _ in range(plane.n_shards)]
        self._counts = [0] * plane.n_shards
        self._frames = 0
        self._first_ts = 0.0
        self._pending_beacon = 0

    @property
    def pending(self) -> int:
        return self._frames

    @property
    def pending_bytes(self) -> int:
        """Buffered-but-unlanded frame bytes (overload accounting —
        the pull loop registers a governor source reading this)."""
        return sum(map(len, self._bufs))

    async def aapply(self, items: list) -> None:
        uuid = as_int(items[3])
        if uuid <= self.cursor:
            return  # duplicate (reconnect overlap)
        if as_int(items[2]) > self.cursor:
            await self.aflush()
            raise ReplicateCommandsLost(
                f"{self.meta.addr}: gap {self.cursor} -> "
                f"{as_int(items[2])}")
        name = as_bytes(items[4])
        cmd = COMMANDS.get(name) or COMMANDS.get(name.lower())
        if cmd is None or not shard_routable(cmd) or len(items) < 6:
            # membership applies in place (never touches the keyspace);
            # anything else unroutable lands what we have first, then
            # takes the exact per-key path on the parent (raising the
            # exact op error for unknown/malformed frames)
            if self._frames and name not in STATE_FREE_BARRIERS:
                await self.aflush()
            node = self.node
            node.stats.repl_apply_barriers += 1
            node.apply_replicated(name, items[5:], as_int(items[1]), uuid,
                                  cause="barrier")
            if node.oplog is not None:
                node.oplog.append_frame(as_int(items[1]), uuid, name,
                                        list(items[5:]),
                                        seg=self.plane.n_shards)
            self.cursor = uuid
            if not self._frames:
                self._advance(uuid)
            return
        key = as_bytes(items[5])
        tr = self.node.tracking
        if tr is not None and tr.active:
            # replicated write folding into a worker: invalidate on the
            # parent BEFORE the frame routes (the sharded twin of
            # apply_replicated's pre-land invalidation)
            tr.invalidate_key(key)
        shard = shard_of(key, self.plane.n_shards)
        if not self._frames:
            self._first_ts = self._now()
        encode_into(self._bufs[shard], Arr(items))
        if self.node.oplog is not None:
            self.node.oplog.append_frame(as_int(items[1]), uuid, name,
                                         list(items[5:]), seg=shard)
        self._counts[shard] += 1
        f = self._frames + 1
        self._frames = f
        self.cursor = uuid
        if f >= self.max_frames or \
                (not f & 31 and
                 self._now() - self._first_ts >= self.max_latency):
            await self.aflush()

    async def aabatch(self, items: list) -> None:
        """REPLBATCH on a sharded receiver is a protocol violation: this
        node never advertises CAP_BATCH_STREAM (replica/link.py my_caps)
        because frames apply per-key inside the worker owning their
        shard — there is no single keyspace for a decoded batch to merge
        into.  A peer that sends one anyway loses the connection loudly
        and redelivers per-frame from the landed watermark."""
        raise CstError(f"{self.meta.addr}: replbatch frame on a sharded "
                       "receiver (capability was never advertised)")

    def observe_beacon(self, beacon: int) -> None:
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
        self.cursor = self.meta.uuid_he_sent
        self._pending_beacon = 0
        self._epoch = self.node.reset_epoch

    async def aflush(self) -> None:
        frames, self._frames = self._frames, 0
        if not frames:
            return
        bufs = self._bufs
        counts = self._counts
        self._bufs = [bytearray() for _ in range(self.plane.n_shards)]
        self._counts = [0] * self.plane.n_shards
        node = self.node
        if node.reset_epoch != self._epoch:
            # a state wipe landed between intake and flush: these frames
            # describe pre-wipe state — drop them (replica/coalesce.py)
            self._pending_beacon = 0
            return
        pool = self.plane.pool
        futs = []
        for s in range(self.plane.n_shards):
            if counts[s]:
                futs.append((s, pool.submit(
                    s, ("apply", bytes(bufs[s]), counts[s]))))
        for s, f in futs:
            entries, deleted, stats = await f
            if entries:  # leftover tap from an earlier worker error
                self.plane.merged.segments[s].push_many(entries)
                if node.oplog is not None:
                    for uuid, name, args in entries:
                        node.oplog.append_local(uuid, name, args, seg=s)
            if deleted:
                node.events.trigger(EVENT_DELETED)
            self.plane._fold_stats(s, stats)
        node.hlc.observe(self.cursor)
        self._advance(self.cursor, wake=frames >= 2)

    def _advance(self, uuid: int, wake: bool = False) -> None:
        # `wake` discipline mirrors replica/coalesce.py _advance: only a
        # genuine multi-frame land wakes push loops to REPLACK it now;
        # trickle lands keep their heartbeat-cadence acks
        beacon, self._pending_beacon = self._pending_beacon, 0
        w = max(uuid, beacon)
        if w > self.meta.uuid_he_sent:
            self.meta.uuid_he_sent = w
            if wake:
                self.node.events.trigger(EVENT_PULL_LANDED)
        if beacon > self.cursor:
            self.cursor = beacon
