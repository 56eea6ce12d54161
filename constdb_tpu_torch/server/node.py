"""Node: the single-writer state of one constdb process (the port's copy).

Capability parity with the reference's `Server` struct (reference
src/server.rs:27-53): node identity, HLC uuid source, keyspace, repl-log
ring, event bus, replica membership, GC.  All mutation happens on one
thread (the reference's main-thread discipline, server.rs:128-131); bulk
merge compute lives in engine/.

One difference from the JAX package's Node: with no engine, `Node` builds
the resident `TorchMergeEngine` on `device` (default CUDA, which raises
without a card; "cpu" runs its plain versions on the host) instead of a
CPU engine.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..engine.base import flush_for
from ..store.keyspace import KeySpace
from ..utils import trace
from ..utils.hlc import HLC
from .events import EVENT_REPLICATED, EventBus
from .repl_log import ReplLog


@dataclass
class NodeStats:
    """Per-node counters folded into INFO (reference src/stats.rs)."""

    cmds_processed: int = 0
    cmds_replicated: int = 0
    net_in_bytes: int = 0
    net_out_bytes: int = 0
    # replication-link traffic, also included in the net totals (the
    # reference counts every socket byte through its buffers —
    # buf_read.rs:218-236, buf_write.rs:165-183; round 1 only counted
    # client connections, leaving the dominant flow invisible)
    repl_in_bytes: int = 0
    repl_out_bytes: int = 0
    connections_accepted: int = 0
    current_clients: int = 0
    # steady-state pull-path coalescing (replica/coalesce.py): frames
    # folded into columnar micro-batches, batches landed, and frames
    # that fell back to the exact per-key path (barriers)
    repl_frames_coalesced: int = 0
    repl_coalesce_flushes: int = 0
    repl_apply_barriers: int = 0
    # columnar wire protocol (replica/wire.py REPLBATCH): steady-state
    # stream bytes written by the push loop's aggregated flushes (frames
    # only — snapshots/acks ride repl_out_bytes), batch frames
    # sent/received with the op runs they covered, and receiver-side
    # payload decode failures (each one demotes that peer to per-frame
    # delivery, loudly)
    repl_wire_bytes_out: int = 0
    repl_wire_batches_out: int = 0
    repl_wire_batch_frames_out: int = 0
    repl_wire_batches_in: int = 0
    repl_wire_batch_frames_in: int = 0
    repl_wire_demotions: int = 0
    # broadcast plane (round 17): encode-once run cache reuse across the
    # push-loop fan-out (replica/encode_cache.py; the resident bytes
    # gauge reads node.wire_cache live), and negotiated stream
    # compression accounting — raw payload bytes vs the framed bytes
    # that actually shipped (REPLBATCH payloads over the floor; the
    # ratio rides INFO as repl_compress_ratio)
    repl_encode_cache_hits: int = 0
    repl_encode_cache_misses: int = 0
    repl_comp_raw_bytes: int = 0
    repl_comp_wire_bytes: int = 0
    # anti-entropy resyncs SENT by this node's push legs
    # (replica/link.py): digest-negotiated deltas vs full snapshots,
    # the delta payload bytes that replaced them, and digest rounds run
    repl_delta_syncs: int = 0
    repl_delta_bytes: int = 0
    repl_full_syncs: int = 0
    repl_digest_rounds: int = 0
    # replica-link connections re-established after a drop (every
    # _install beyond a link's first, dialed or adopted — replica/
    # link.py).  Per-peer counts ride the INFO replication section.
    repl_reconnects: int = 0
    # client-serving coalescing (server/serve.py): pipelined client
    # commands folded into columnar micro-batches, batches landed,
    # commands that acted as ordered barriers (reads / non-plannable
    # writes / admin inside a coalesced chunk), and a sampled ring of
    # plan→land reply latencies (seconds) surfaced as p50/p99 in INFO
    serve_msgs_coalesced: int = 0
    serve_flushes: int = 0
    serve_barriers: int = 0
    # the coalesced READ plane (round 18, server/serve.py read planner):
    # key-scoped reads served from planned read batches (batched key
    # resolution + vectorized family gathers + the versioned reply
    # cache) instead of acting as per-command barriers, and pending-run
    # lands forced by a read batch needing read-your-writes.  The reply
    # cache's own hit/miss/byte/invalidation gauges live on
    # node.read_cache (server/read_cache.py); sharded nodes fold worker
    # deltas into the parent's cache counters (server/serve_shards.py).
    serve_reads_coalesced: int = 0
    serve_read_flushes: int = 0
    # native intake stage (native/intake.cpp + server/io.py): pipelined
    # chunks split+classified by the C scanner in one call, and the
    # command frames it emitted as opcodes (CONSTDB_NATIVE_INTAKE=0 or a
    # missing extension pins both to zero — the pure path served)
    native_intake_chunks: int = 0
    native_intake_msgs: int = 0
    serve_lat: deque = field(default_factory=lambda: deque(maxlen=2048))
    # overload governance (server/overload.py + server/io.py +
    # replica/link.py): client data writes shed at the maxmemory soft
    # watermark, hard-watermark reclaim sweeps, slow-reading clients
    # disconnected at the reply-buffer cap, and push loops paused on a
    # full per-peer replication window
    oom_shed_writes: int = 0
    oom_hard_reclaims: int = 0
    client_outbuf_disconnects: int = 0
    repl_window_pauses: int = 0
    # client-assisted caching (server/tracking.py): invalidation keys
    # pushed to tracked RESP3 connections, push frames written, and
    # slow trackers demoted to untracked at the outbuf cap
    tracking_invalidations_sent: int = 0
    tracking_pushes: int = 0
    tracking_demotions: int = 0
    merges: int = 0
    merge_rows: int = 0
    gc_freed: int = 0
    start_time: float = 0.0
    extra: dict = field(default_factory=dict)
    # the spans of the node's entries (utils/trace.py): merge_secs and
    # flush_secs are views over them
    spans: trace.Totals = field(default_factory=trace.Totals)

    @property
    def merge_secs(self) -> float:
        """Seconds inside the bulk merge entries (merge_batch,
        merge_batches)."""
        return self.spans.wall("node.merge_batch") + \
            self.spans.wall("node.merge_batches")

    @property
    def flush_secs(self) -> float:
        """Seconds inside flushes that ran (ensure_flushed)."""
        return self.spans.wall("node.ensure_flushed")


class CounterUndoLog:
    """Locally-originated counter steps this node can still UNDO.

    Grounded in "The Only Undoable CRDTs are Counters" (PAPERS.md, arXiv
    2006.10494): the PN-counter is the one family whose ops admit a sound
    inverse — applying the negated delta commutes with every concurrent
    op and converges mesh-wide like any increment.  Each local INCR/DECR
    (and each CNTUNDO, so undo-of-undo is redo) records (uuid → key,
    delta) here; `CNTUNDO key [uuid]` resolves its target against this
    log and replicates the inverse as an ordinary absolute-total CNTSET.

    Node-local on purpose: a slot is a single-writer register, so only
    the op's ORIGIN can soundly invert it — a remote node undoing it
    would write someone else's slot.  Bounded (CONSTDB_TORCH_UNDO_WINDOW ops,
    FIFO eviction) and not snapshot-persisted: after eviction or a
    restart the op reports "evicted", never a wrong inverse.
    """

    __slots__ = ("cap", "_ops", "_by_key", "_order")

    def __init__(self, cap: Optional[int] = None) -> None:
        if cap is None:
            from ..conf import env_int
            cap = env_int("CONSTDB_TORCH_UNDO_WINDOW", 4096)
        self.cap = max(1, cap)
        self._ops: dict[int, list] = {}      # uuid -> [key, delta, undone]
        self._by_key: dict[bytes, list] = {}  # key -> uuid stack (newest last)
        self._order: deque[int] = deque()     # FIFO eviction order

    def record(self, uuid: int, key: bytes, delta: int,
               inverse: bool = False) -> None:
        """`inverse=True` marks the record as an undo's own inverse op:
        a BARE `CNTUNDO key` walks user ops only (two bare undos revert
        two increments, they do not ping-pong); undoing an inverse —
        redo — takes its explicit uuid."""
        self._ops[uuid] = [key, delta, False, inverse]
        self._by_key.setdefault(key, []).append(uuid)
        self._order.append(uuid)
        while len(self._order) > self.cap:
            old = self._order.popleft()
            ent = self._ops.pop(old, None)
            if ent is not None:
                stack = self._by_key.get(ent[0])
                if stack is not None:
                    try:
                        stack.remove(old)
                    except ValueError:
                        pass
                    if not stack:
                        del self._by_key[ent[0]]

    def resolve(self, key: bytes, uuid: Optional[int] = None):
        """The undo target: `(uuid, delta)` of the op to invert — the
        explicit uuid (any not-yet-undone record, inverses included:
        that is redo), or the newest not-yet-undone USER op on `key`
        (classic stack undo).  None when there is nothing to undo (the
        command surfaces the precise reason)."""
        if uuid is not None:
            ent = self._ops.get(uuid)
            if ent is None or ent[0] != key or ent[2]:
                return None
            return uuid, ent[1]
        for u in reversed(self._by_key.get(key, ())):
            ent = self._ops[u]
            if not ent[2] and not ent[3]:
                return u, ent[1]
        return None

    def known(self, uuid: int) -> bool:
        return uuid in self._ops

    def mark_undone(self, uuid: int) -> None:
        ent = self._ops.get(uuid)
        if ent is not None:
            ent[2] = True


class Node:
    def __init__(self, node_id: int = 0, alias: str = "", addr: str = "",
                 engine=None, repl_log_cap: int = ReplLog.DEFAULT_CAP,
                 clock=None, device=None):
        self.node_id = node_id
        self.alias = alias
        self.addr = addr
        self.hlc = HLC() if clock is None else HLC(clock)
        self.ks = self._make_keyspace()
        self.repl_log = ReplLog(repl_log_cap)
        self.events = EventBus()
        if engine is None:
            from ..engine.cuda import TorchMergeEngine
            from ..utils.device import resolve_device
            engine = TorchMergeEngine(resident=True,
                                      device=resolve_device(device))
        self.engine = engine
        self.stats = NodeStats()
        # undoable local counter ops (CNTUNDO — server/commands.py)
        self.undo = CounterUndoLog()
        # overload governance: memory accounting + maxmemory watermarks
        # (server/overload.py; env-configured here, ServerApp / shard
        # workers override via governor.configure)
        from .overload import OverloadGovernor
        self.governor = OverloadGovernor(self)
        from ..replica.manager import ReplicaManager
        self.replicas = ReplicaManager()
        # encode-once run cache: finished wire encodings shared across
        # the push-loop fan-out (replica/encode_cache.py; a registered
        # used_memory source — server/overload.py).  Env-configured
        # here; ServerApp overrides via wire_cache.configure.
        from ..conf import env_int
        from ..replica.encode_cache import RunEncodeCache
        self.wire_cache = RunEncodeCache(
            max(0, env_int("CONSTDB_TORCH_ENCODE_CACHE_MB", 16)) << 20)
        # versioned hot-key reply cache (server/read_cache.py): finished
        # RESP reply bytes served by the coalescer's read planner while
        # a key's state is provably unchanged.  Invalidated at every
        # mutation intake (commands.execute/apply_replicated per-op,
        # merge_batch/merge_batches for every batched path) and a
        # registered used_memory source (server/overload.py).  A shard
        # worker's Node owns its own cache — each worker invalidates
        # exactly its shard.
        from .read_cache import ReadReplyCache
        self.read_cache = ReadReplyCache(
            max(0, env_int("CONSTDB_TORCH_READ_CACHE_MB", 16)) << 20)
        # bumped by reset_for_full_resync; replica links stamp it at
        # connection install and refuse stale-epoch REPLACK beacons (a
        # beacon from a pre-wipe stream would re-advance a zeroed pull
        # watermark past ops the wipe discarded)
        self.reset_epoch = 0
        # the ServerApp driving this node's IO, when one exists
        self.app = None
        # durable op log (persist/oplog.py) when AOF is enabled — armed
        # by server/io.py AFTER boot recovery; every repl-log append
        # (replicate_cmd, the serve coalescer's push_many, the sharded
        # ack mirror) and every replicated-intake land mirrors into it
        self.oplog = None
        # the shard-per-core serving plane (server/serve_shards.py) when
        # CONSTDB_SERVE_SHARDS > 1; None = the exact single-loop path.
        # With a plane active this node's ks/engine hold NO data — every
        # data command executes inside the shard worker owning its key,
        # and self.repl_log is the plane's MergedReplLog view.
        self.serve_plane = None
        # cluster mode (cluster/slots.py ClusterState) when
        # CONSTDB_CLUSTER=1 — armed by server/io.py before serving; None
        # = the exact pre-cluster single-group node (every hot-path gate
        # is one `is None` test)
        self.cluster = None
        # RESP3 client tracking (server/tracking.py): the invalidation
        # fan-out to tracked client connections.  Always constructed
        # (empty dicts), never active until a CLIENT TRACKING on — every
        # hot-path tap gates on `.active`, one attribute test.
        from .tracking import TrackingRegistry
        self.tracking = TrackingRegistry(self)

    def _make_keyspace(self) -> KeySpace:
        """Fresh keyspace with the node's event wiring (shared by boot and
        reset_for_full_resync so the hookup cannot diverge)."""
        ks = KeySpace()
        from .events import EVENT_DELETED
        ks.on_key_delete = lambda: self.events.trigger(EVENT_DELETED)
        return ks

    # ------------------------------------------------------------ execution

    def execute(self, req, client=None, uuid=None):
        """One client command, fully (parse → run → replicate).  `uuid`:
        a pre-minted HLC uuid (shard-per-core serving — the routing
        parent is the clock authority; see commands.execute)."""
        from .commands import execute
        return execute(self, req, client, uuid=uuid)

    def apply_replicated(self, name: bytes, args: list, origin_nodeid: int,
                         uuid: int, cause: str = "read"):
        """One command from a peer's replication stream.  `cause`: why its
        whole flush of device-resident state runs (see `ensure_flushed`;
        a key-scoped barrier flushes its key's rows alone,
        `ensure_flushed_for_key`): a barrier of a coalesced stream passes
        "barrier"."""
        from .commands import apply_replicated
        return apply_replicated(self, name, args, origin_nodeid, uuid, cause)

    def replicate_cmd(self, uuid: int, name: bytes, args: list) -> None:
        """Append to the repl_log and wake pushers (reference
        src/server.rs:270-288).  The durable op log mirrors the append
        BEFORE the pusher wake: under fsync=always the emission floor
        holds the entry back until its group commit lands anyway, and
        the mirror-first order is what makes the chaos journal's
        obligation set equal the on-disk set (persist/oplog.py)."""
        self.repl_log.push(uuid, name, args)
        if self.oplog is not None:
            self.oplog.append_local(uuid, name, args)
        self.events.trigger(EVENT_REPLICATED, uuid)

    # ------------------------------------------------------------------- GC

    def gc_horizon(self) -> int:
        """Tombstones at or below this uuid are collectable: every live peer's
        stream has passed it (reference replica/replica.rs:87-89 min over
        uuid_he_sent; standalone nodes collect up to their own clock).

        A mid-flight slot migration additionally clamps the horizon at
        its start pin (cluster/slots.py pin_gc): a delete landing during
        the handoff must still be a visible TOMBSTONE in the final
        export, or the moved copy resurrects the key across the
        ownership flip (docs/INVARIANTS.md "Slot ownership laws")."""
        horizon = None
        if self.replicas is not None:
            horizon = self.replicas.min_uuid()
        if horizon is None:
            horizon = self.hlc.current
        cl = self.cluster
        if cl is not None:
            # the GC pulse doubles as the import-window staleness sweep:
            # a migration source that died after SETSLOT IMPORTING must
            # not pin this node's tombstone GC (or keep the slot's
            # partial copy serving) forever
            import time
            cl.expire_stale_imports(time.monotonic())
            pin = cl.gc_pin()
            if pin is not None and pin < horizon:
                horizon = pin
        return horizon

    def gc(self) -> int:
        self.ensure_flushed()
        freed = self.ks.gc(self.gc_horizon())
        self.stats.gc_freed += freed
        return freed

    # ------------------------------------------------------------ merge path

    def merge_batch(self, batch) -> None:
        """Bulk CRDT merge via the configured MergeEngine (snapshot ingest /
        replica catch-up — the reference's per-key db.merge_entry loop).
        With a device-resident engine, merged state stays on the device
        between calls; it flushes to the host lazily before the next read
        (`ensure_flushed`)."""
        with trace.span("node.merge_batch", into=self.stats.spans):
            self._invalidate_reads((batch,))
            st = self.engine.merge(self.ks, batch)
        self.stats.merges += 1
        self.stats.merge_rows += batch.n_rows
        self._dump_stale()
        return st

    def _invalidate_reads(self, batches) -> None:
        """Reply-cache invalidation for every BATCHED mutation intake —
        snapshot/delta ingest, coalesced replication apply, columnar
        wire batches, serve-coalescer runs, oplog replay all ride
        merge_batch/merge_batches, so hooking here (BEFORE the merge
        lands) is what makes invalidate-before-visible complete
        (server/read_cache.py) — and the tracked-client push stream
        (server/tracking.py) taps the same seam with its own gate, so
        wire invalidation is complete by the same construction."""
        tr = self.tracking
        if tr is not None and tr.active:
            for b in batches:
                tr.invalidate_keys(b.keys)
                if b.del_keys:
                    tr.invalidate_keys(b.del_keys)
        rc = self.read_cache
        if not len(rc):
            return
        for b in batches:
            rc.invalidate_keys(b.keys)
            if b.del_keys:
                rc.invalidate_keys(b.del_keys)

    def _dump_stale(self) -> None:
        """Bulk-merged state bypasses the repl_log, so a cached full-sync
        dump plus a log tail would silently omit it: force the next peer to
        get a fresh dump (persist/share.py reuse rule covers only LOGGED
        writes)."""
        app = self.app
        if app is not None and getattr(app, "shared_dump", None) is not None:
            app.shared_dump.invalidate()

    def merge_batches(self, batches: list, logged: bool = False) -> None:
        """Merge a GROUP of columnar batches in one engine call when the
        engine supports it (engine/cuda.py merge_many reduces aligned groups
        in one fused [R, N] device pass, and unaligned groups still share
        one state roundtrip per family); per-batch merges otherwise.

        A SINGLE batch also routes through merge_many when its rows may
        repeat per slot (a serve/stream coalescer flush): that is where
        both engines pick the vectorized host micro-strategy
        (engine/hostbatch.py) — the per-batch `merge` entry point is the
        CPU engine's per-row REFERENCE path, dozens of times slower at
        op-stream scale."""
        if not batches:
            return
        if not hasattr(self.engine, "merge_many") or \
                (len(batches) == 1 and batches[0].rows_unique_per_slot):
            for b in batches:
                self.merge_batch(b)
            return
        with trace.span("node.merge_batches", into=self.stats.spans):
            self._invalidate_reads(batches)
            self.engine.merge_many(self.ks, batches)
        self.stats.merges += 1
        self.stats.merge_rows += sum(b.n_rows for b in batches)
        if len(batches) > 1:
            x = self.stats.extra
            x["group_merges"] = x.get("group_merges", 0) + 1
            x["group_merge_batches"] = \
                x.get("group_merge_batches", 0) + len(batches)
        if not logged:
            # `logged` batches (the serve coalescer's runs) are appended
            # to the repl_log in full, so a cached full-sync dump plus a
            # log tail still covers them — only UNLOGGED bulk merges must
            # force the next peer onto a fresh dump (persist/share.py
            # reuse rule)
            self._dump_stale()

    def merge_stream_batch(self, builder, frames: int) -> None:
        """Land one coalesced replication micro-batch (the steady-state
        pull path, replica/coalesce.py) through the engine's stream entry
        (`_land_coalesced`).  The element-plane key-delete rule (in
        `builder.finalize()`, or in the native round planner) reads LIVE
        host dt columns, so
        unflushed device state COVERING the env plane must flush first —
        the narrow form of the flush-before-read discipline
        `apply_replicated` applies per frame.  A steady-state resident
        engine keeps env host-authoritative (engine/cuda.py micro path),
        so consecutive stream batches merge in place on device with no
        flush round-trip between them."""
        with trace.span("node.merge_stream_batch", into=self.stats.spans):
            self.ensure_flushed_for(("env",))
            self._land_coalesced(builder, logged=False)
        self.stats.repl_frames_coalesced += frames
        self.stats.repl_coalesce_flushes += 1

    def merge_serve_batch(self, builder, msgs: int) -> None:
        """Land one coalesced client-serving micro-batch (the pipelined
        RESP path, server/serve.py) through the same engine seam the
        replication coalescer rides.  Same narrow flush-before-finalize
        discipline as merge_stream_batch (`builder.finalize()` reads
        live env dt columns only; the serve planners' own reads flush
        through the coalescer's probe paths).  The run is fully
        repl-logged by the caller, so logged=True keeps the shared
        full-sync dump reusable."""
        self.ensure_flushed_for(("env",))
        self._land_coalesced(builder, logged=True)
        self.stats.serve_msgs_coalesced += msgs
        self.stats.serve_flushes += 1

    def _land_coalesced(self, builder, logged: bool) -> None:
        """One coalesced batch (a replica/coalesce.py BatchBuilder or a
        replica/wire.py WireBatch) through the engine's stream entry,
        which plans a steady round natively and finalizes the builder
        itself where it does not (engine/cuda.py merge_stream), or
        finalized through merge_batches for an engine without one."""
        land = getattr(self.engine, "merge_stream", None)
        if land is None:
            self.merge_batches([builder.finalize()], logged=logged)
            return
        with trace.span("node.merge_batches", into=self.stats.spans):
            self._invalidate_reads((builder,))
            land(self.ks, builder)
        self.stats.merges += 1
        self.stats.merge_rows += builder.n_rows
        if not logged:
            self._dump_stale()

    def reset_for_full_resync(self, keep_link=None) -> None:
        """Wipe local CRDT state and rejoin as a fresh node (the receive
        side of the fullsync `reset` flag — replica/link.py).  Used when a
        pusher excluded us from its GC horizon past its repl_log window:
        tombstones we never saw are physically gone mesh-wide, so keys we
        still hold live would resurrect through any plain merge.  Clears
        the keyspace, the repl_log (our own unsynced ops describe state
        being discarded), and every pull watermark (what we applied from
        other peers was part of the wiped store); membership survives so
        the mesh re-forms around us.

        Every OTHER live connection is kicked so its peer re-handshakes
        from the zeroed watermark (resume 0 → full or from-zero partial
        resync).  Merely zeroing is not enough: an idle surviving stream
        re-sends nothing, and its REPLACK beacon would quietly re-advance
        the zeroed watermark past ops the wipe discarded — the epoch bump
        makes links drop such stale-stream beacons (replica/link.py).
        `keep_link` (the link delivering the reset snapshot) stays up."""
        with trace.span("node.reset_for_full_resync", into=self.stats.spans):
            self._reset_for_full_resync(keep_link)

    def _reset_for_full_resync(self, keep_link) -> None:
        engine = self.engine
        if hasattr(engine, "discard_resident"):
            engine.discard_resident()
        # every cached reply describes wiped state (and its stamps hold
        # kids of the discarded keyspace object)
        self.read_cache.clear()
        # ... and so does every tracked client's near-cache: flush-all
        # push before the wipe is visible (server/tracking.py)
        tr = self.tracking
        if tr is not None and tr.active:
            tr.flush_all()
        cap = self.repl_log.cap
        fence = max(self.repl_log.last_uuid, self.hlc.current)
        self.ks = self._make_keyspace()
        self.repl_log = ReplLog(cap)
        # Fence the fresh (empty) log at the pre-wipe watermark: a peer
        # resuming below it must get a FULL snapshot of the post-reset
        # store — with last_uuid/evicted_up_to left at 0,
        # can_resume_from(old_watermark) would be true and the push loop
        # would serve a PARTSYNC of nothing, permanently omitting the
        # resynced keyspace (same rule as the boot-restore path,
        # server/io.py start_node).
        self.repl_log.last_uuid = fence
        self.repl_log.evicted_up_to = fence
        if self.oplog is not None:
            # every logged record describes discarded state; the log is
            # truncated and recovery is fenced so a crash before the
            # post-resync rewrite lands boots empty + full-syncs instead
            # of resurrecting pre-wipe keys (persist/oplog.py on_wipe —
            # it also reinstalls the emission floor on the fresh ring)
            self.oplog.on_wipe(fence)
        self._kick_peers_after_wipe(keep_link)

    def _kick_peers_after_wipe(self, keep_link=None) -> None:
        """Post-wipe peer bookkeeping shared by the single-loop reset
        above and the serve plane's reset (server/serve_shards.py):
        epoch bump (stale-beacon fence), watermark zeroing, and a kick
        for every other live connection."""
        self.reset_epoch += 1
        if self.replicas is not None:
            for m in self.replicas.peers.values():
                m.uuid_he_sent = 0
                m.uuid_he_acked = 0
                link = m.link
                if link is not None and link is not keep_link and \
                        hasattr(link, "kick"):
                    link.kick()
        self._dump_stale()

    def ensure_flushed(self, cause: str = "read") -> None:
        """Sync device-resident merge state back to the host keyspace
        before any read/write of the numeric plane.  `cause`: why
        (engine/base.py FLUSH_CAUSES: a replicated barrier's whole flush
        is "barrier", every other reader's "read")."""
        engine = self.engine
        if getattr(engine, "needs_flush", False):
            with trace.span("node.ensure_flushed", into=self.stats.spans):
                flush_for(engine, self.ks, cause)

    def ensure_flushed_for_key(self, kid: int, families,
                               cause: str = "read") -> None:
        """The flush before a key-scoped barrier (commands.py
        KEY_SCOPED_BARRIERS), which reads and writes `families` of key
        `kid` alone (-1: an absent key, which has no rows to read): only
        that key's device-newer rows write back (counter
        `engine.flushes.barrier_key`), or nothing when it has none
        (counter `engine.barriers_clean`).  The whole flush under `cause`
        when the engine has no key probe, or its probe cannot serve (a
        plane whole-dirty after a bulk merge)."""
        engine = self.engine
        if not getattr(engine, "needs_flush", False):
            return
        probe = getattr(engine, "key_dirty_rows", None)
        rows = None if probe is None else probe(self.ks, kid, families)
        if rows is None:
            self.ensure_flushed(cause)
        elif rows:
            with trace.span("node.ensure_flushed", into=self.stats.spans):
                trace.count("engine.flushes.barrier_key", into=engine.spans)
                engine.flush_key(self.ks, rows)
        else:
            trace.count("engine.barriers_clean", into=engine.spans)

    def ensure_flushed_for(self, families) -> None:
        """Flush only when unflushed device-resident state actually
        covers one of `families` — the narrow read-barrier for callers
        that provably read nothing else (docs/INVARIANTS.md
        flush-before-read law).  Engines without the staleness probe
        take the full flush."""
        engine = self.engine
        if getattr(engine, "needs_flush", False):
            stale = getattr(engine, "host_stale", None)
            if stale is None or stale(families):
                self.ensure_flushed()

    def tensor_read(self, kid: int):
        """One tensor key's strategy reduction, DEVICE-FIRST: a steady
        resident engine reduces straight from its payload pools —
        dirty payloads never round-trip through the host, which is the
        tensor family's reason to exist (the TENSOR.GET path;
        commands.execute narrows its flush for exactly this).  Other
        engines flush the tensor plane narrowly and run the host
        reference reduction."""
        engine = self.engine
        if getattr(engine, "steady", False) and \
                getattr(engine, "resident", False):
            return engine.tensor_read_many(self.ks, (kid,))[kid]
        self.ensure_flushed_for(("tns",))
        return self.ks.tensor_read(kid)

    def canonical(self) -> dict:
        self.ensure_flushed()
        return self.ks.canonical()
