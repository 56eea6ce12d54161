"""TCP server: RESP client connections + replica handshake + cron.

Capability parity with the reference's accept loop / Link scheduling / cron
(reference src/server.rs:94-146, src/link.rs), mapped onto one asyncio
event loop: the loop is the single-writer exec thread (the reference's main
thread, server.rs:128-131); per-connection coroutines are its IO threads.
Parsing happens in the connection coroutine, execution inline — the mpsc
hand-off the reference needs between thread pools simply disappears.

A client connection that sends `SYNC` is upgraded to a replica link
(reference replica.rs:16-40: sync_command steals the client's Conn).

The port's copy.  Every pipelined chunk of a coalescing connection goes
through the native intake scanner (the port has no pure intake path).  A
serve-shard node's workers run the node's engine kind on its device
(server/serve_shards.py)."""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Optional

from ..errors import CstError
from ..replica.link import ReplicaLink, SYNC
from ..replica.manager import ReplicaManager, ReplicaMeta
from ..resp.codec import RespParser, encode_into, make_parser
from ..resp.message import Arr, Bulk, Err, Int, NoReply, as_bytes, as_int
from .node import Node

log = logging.getLogger(__name__)

_READ_CHUNK = 1 << 16


class ServerApp:
    """One node's process: listener, replica links, cron, config knobs."""

    def __init__(self, node: Node, host: str = "127.0.0.1", port: int = 0,
                 advertised_addr: str = "", work_dir: str = ".",
                 heartbeat: float = 4.0,
                 reconnect_delay: Optional[float] = None,
                 reconnect_max: Optional[float] = None,
                 reconnect_factor: Optional[float] = None,
                 reconnect_jitter: Optional[float] = None,
                 handshake_timeout: float = 10.0,
                 snapshot_chunk_keys: int = 1 << 16,
                 snapshot_compress_level: int = 1,
                 gc_interval: float = 1.0,
                 snapshot_path: str = "",
                 sync_merge_group: int = 8,
                 sync_merge_budget: float = 0.1,
                 sync_initial_split: int = 1024,
                 tcp_backlog: int = 1024,
                 gc_peer_retention: float = 0.0,
                 ingest_shards: int = 0,
                 ingest_shard_min_bytes: int = 64 << 20,
                 serve_shards: Optional[int] = None,
                 apply_batch: Optional[int] = None,
                 apply_latency: Optional[float] = None,
                 wire_batch: Optional[int] = None,
                 wire_latency: Optional[float] = None,
                 wire_compress: Optional[bool] = None,
                 wire_compress_min: Optional[int] = None,
                 encode_cache_mb: Optional[int] = None,
                 bulk_compress_level: int = 6,
                 serve_batch: Optional[int] = None,
                 delta_sync: Optional[bool] = None,
                 delta_max_divergence: Optional[float] = None,
                 delta_bucket_keys: Optional[int] = None,
                 delta_stamp_min: Optional[int] = None,
                 maxmemory: Optional[int] = None,
                 maxmemory_soft_pct: Optional[float] = None,
                 client_outbuf_max: Optional[int] = None,
                 repl_window: Optional[int] = None,
                 aof: Optional[bool] = None,
                 aof_fsync: Optional[str] = None,
                 aof_rewrite_pct: Optional[int] = None,
                 aof_rewrite_min_mb: Optional[int] = None,
                 aof_dir: str = "",
                 checkpoint_secs: Optional[float] = None,
                 checkpoint_min_mb: Optional[int] = None,
                 restore_to: int = 0,
                 cluster: Optional[bool] = None,
                 cluster_group: int = 0,
                 slot_groups: Optional[int] = None,
                 migrate_batch_mb: Optional[int] = None):
        self.node = node
        node.app = self
        if node.replicas is None:
            node.replicas = ReplicaManager()
        node.replicas.on_new_peer = self.ensure_link
        self.host = host
        self.port = port
        self._advertised = advertised_addr
        self.work_dir = work_dir
        self.heartbeat = heartbeat
        # replica-link reconnect: bounded exponential backoff with
        # DETERMINISTIC jitter (replica/link.py backoff_delay) — base
        # delay, ceiling, growth factor, jitter fraction.  None = the
        # CONSTDB_TORCH_RECONNECT_* env defaults.  The jitter derives from
        # (node_id, peer addr, attempt) instead of random(), so a chaos
        # scenario's reconnect cadence replays exactly from its seed.
        from ..conf import env_float as _envf
        self.reconnect_delay = _envf("CONSTDB_TORCH_RECONNECT_BASE_MS",
                                     5000.0) / 1000.0 \
            if reconnect_delay is None else reconnect_delay
        self.reconnect_max = _envf("CONSTDB_TORCH_RECONNECT_MAX_MS",
                                   60000.0) / 1000.0 \
            if reconnect_max is None else reconnect_max
        self.reconnect_factor = _envf("CONSTDB_TORCH_RECONNECT_FACTOR", 2.0) \
            if reconnect_factor is None else reconnect_factor
        self.reconnect_jitter = _envf("CONSTDB_TORCH_RECONNECT_JITTER", 0.2) \
            if reconnect_jitter is None else reconnect_jitter
        # the seam a fault-injecting harness (constdb_tpu_torch/chaos/,
        # plane.FaultPlane.connector) installs to route EVERY inter-node
        # transport through its fault plane: an
        # async callable (host, port) -> (reader, writer).  None = a
        # plain TCP connection.  Replica links are always the DIALING
        # side of their connection (an inbound SYNC adopts a stream some
        # peer's link dialed), so wrapping dials covers the whole mesh.
        self.peer_connector = None
        self.handshake_timeout = handshake_timeout
        self.snapshot_chunk_keys = snapshot_chunk_keys
        self.snapshot_compress_level = snapshot_compress_level
        self.gc_interval = gc_interval
        self.snapshot_path = snapshot_path
        # snapshot-apply cadence: chunks per engine call (ceiling), the
        # per-call liveness budget (seconds) the adaptive controller steers
        # toward, and the sub-chunk size the ramp starts from.  The start
        # must be small enough that the FIRST call cannot wedge the loop
        # even through the per-row CPU engine on a slow box (~10k keys/s
        # single-core: 1024 keys ≈ 0.1s; 4096 measurably broke the 1s
        # client-RTT bound under full-suite heap pressure) — the ramp
        # doubles per fast call, so a fast engine reaches whole chunks
        # within a handful of calls either way
        self.sync_merge_group = sync_merge_group
        self.sync_merge_budget = sync_merge_budget
        self.sync_initial_split = sync_initial_split
        self.tcp_backlog = tcp_backlog
        # process-parallel snapshot ingest (store/sharded_keyspace.py):
        # 0 = auto (CONSTDB_TORCH_SHARDS / core count; 1 on <= 2 cores),
        # 1 = off.  Snapshots below the byte floor always take the plain
        # path — spawning shard workers costs more than they save there.
        self.ingest_shards = ingest_shards
        self.ingest_shard_min_bytes = ingest_shard_min_bytes
        # steady-state coalescing bounds for the pull path
        # (replica/coalesce.py); None = the CONSTDB_TORCH_APPLY_BATCH /
        # CONSTDB_TORCH_APPLY_LATENCY_MS env defaults.  apply_batch=1 pins a
        # node to the exact per-frame path.
        self.apply_batch = apply_batch
        self.apply_latency = apply_latency
        # batch wire protocol bounds for the push path (replica/link.py
        # + replica/wire.py): ops per REPLBATCH run and the aggregated
        # wire buffer's flush latency.  None = the CONSTDB_TORCH_WIRE_BATCH /
        # CONSTDB_TORCH_WIRE_LATENCY_MS env defaults; wire_batch=1 pins this
        # node to the byte-exact per-frame stream in BOTH directions
        # (it stops advertising CAP_BATCH_STREAM too — my_caps).
        from ..conf import env_float as _env_float, env_int as _env_int
        self.wire_batch = _env_int("CONSTDB_TORCH_WIRE_BATCH", 512) \
            if wire_batch is None else wire_batch
        self.wire_latency = \
            (_env_float("CONSTDB_TORCH_WIRE_LATENCY_MS", 5.0) / 1000.0) \
            if wire_latency is None else wire_latency
        # broadcast plane (round 17): negotiated stream/bulk compression
        # (CAP_COMPRESS — replica/link.py, utils/compressio.py) and the
        # encode-once run cache cap.  None = the CONSTDB_TORCH_WIRE_COMPRESS /
        # CONSTDB_TORCH_WIRE_COMPRESS_MIN / CONSTDB_TORCH_ENCODE_CACHE_MB env
        # defaults; wire_compress=False is the kill switch for BOTH legs
        # (no outbound compression, no CAP_COMPRESS invitation), and
        # encode_cache_mb=0 makes every push loop re-encode (the
        # pre-broadcast path).  bulk_compress_level: zlib level for the
        # FULLSYNC/DELTASYNC container (latency-insensitive, so higher
        # than the per-section stream default).
        from ..conf import env_flag as _env_flag
        self.wire_compress = _env_flag("CONSTDB_TORCH_WIRE_COMPRESS", True) \
            if wire_compress is None else wire_compress
        self.wire_compress_min = \
            _env_int("CONSTDB_TORCH_WIRE_COMPRESS_MIN", 512) \
            if wire_compress_min is None else wire_compress_min
        self.bulk_compress_level = bulk_compress_level
        if encode_cache_mb is not None:
            node.wire_cache.configure(max(0, encode_cache_mb) << 20)
        # client-path coalescing (server/serve.py): max pipelined
        # commands planned into one columnar micro-merge.  None = the
        # CONSTDB_TORCH_SERVE_BATCH env default; <= 1 pins every connection to
        # the exact per-command path (no coalescer is ever constructed).
        from ..conf import env_int
        self.serve_batch = env_int("CONSTDB_TORCH_SERVE_BATCH", 512) \
            if serve_batch is None else serve_batch
        # shard-per-core serving (server/serve_shards.py): N worker
        # processes each owning a keyspace shard + engine + repl-log
        # segment, with this loop as the router/clock authority.  1 (the
        # default) never constructs the plane — the exact single-loop
        # path, byte for byte.
        self.serve_shards = env_int("CONSTDB_TORCH_SERVE_SHARDS", 1) \
            if serve_shards is None else serve_shards
        # digest-driven delta resync (replica/link.py _send_delta, wire
        # frames digest/digestack/deltasync): enabled by default — a
        # peer without CAP_DELTA_SYNC still gets the exact full-sync
        # byte stream.  delta_max_divergence = bucket-mismatch fraction
        # past which the pusher demotes to a full snapshot;
        # delta_bucket_keys = target keys per digest leaf bucket (finer
        # buckets localize random divergence at the cost of a larger
        # digest matrix — 8-byte hash per bucket, on the wire once per
        # refined shard).
        from ..conf import env_flag, env_float
        self.delta_sync = env_flag("CONSTDB_TORCH_DELTA_SYNC", True) \
            if delta_sync is None else delta_sync
        self.delta_max_divergence = \
            env_float("CONSTDB_TORCH_DELTA_MAX_DIVERGENCE", 0.5) \
            if delta_max_divergence is None else delta_max_divergence
        self.delta_bucket_keys = \
            env_int("CONSTDB_TORCH_DELTA_BUCKET_KEYS", 8) \
            if delta_bucket_keys is None else delta_bucket_keys
        # per-key stamp refinement floor: below this many keys in the
        # divergent buckets the level-2 exchange (~12B/listed key) can
        # cost more than the whole-bucket payload it would trim
        self.delta_stamp_min = env_int("CONSTDB_TORCH_DELTA_STAMP_MIN", 4096) \
            if delta_stamp_min is None else delta_stamp_min
        # overload governance (server/overload.py + docs/INVARIANTS.md
        # "Degradation laws"): the node-level memory cap + watermarks
        # (None = the CONSTDB_TORCH_MAXMEMORY /
        # CONSTDB_TORCH_MAXMEMORY_SOFT_PCT env defaults — the governor
        # read those at Node construction, so only explicit overrides
        # reconfigure it), the per-connection
        # reply-buffer cap past which a non-reading client is
        # disconnected, and the per-peer unacked replication window the
        # push loops pause on.
        if maxmemory is not None or maxmemory_soft_pct is not None:
            node.governor.configure(maxmemory, maxmemory_soft_pct)
        self.client_outbuf_max = \
            env_int("CONSTDB_TORCH_CLIENT_OUTBUF_MAX", 128 << 20) \
            if client_outbuf_max is None else client_outbuf_max
        self.repl_window = env_int("CONSTDB_TORCH_REPL_WINDOW", 16 << 20) \
            if repl_window is None else repl_window
        # durable op log (persist/oplog.py): every repl-log append
        # mirrors into crc-framed segment files, group-committed under
        # CONSTDB_TORCH_AOF_FSYNC and compacted past
        # CONSTDB_TORCH_AOF_REWRITE_PCT.  None = the env defaults;
        # start_node runs the boot recovery (snapshot + oplog tail through
        # the real merge path) and arms node.oplog before the listener
        # opens.
        from ..conf import env_str
        self.aof = env_flag("CONSTDB_TORCH_AOF", False) \
            if aof is None else aof
        self.aof_fsync = env_str("CONSTDB_TORCH_AOF_FSYNC", "everysec") \
            if aof_fsync is None else aof_fsync
        self.aof_rewrite_pct = env_int("CONSTDB_TORCH_AOF_REWRITE_PCT", 100) \
            if aof_rewrite_pct is None else aof_rewrite_pct
        self.aof_rewrite_min_mb = \
            env_int("CONSTDB_TORCH_AOF_REWRITE_MIN_MB", 16) \
            if aof_rewrite_min_mb is None else aof_rewrite_min_mb
        self.aof_dir = aof_dir or os.path.join(work_dir, "aof")
        # incremental checkpoints: a time-triggered rewrite cadence —
        # every checkpoint_secs (once the tail exceeds checkpoint_min_mb)
        # the log cuts a fresh generation behind a consistent snapshot,
        # keeping the restart tail short.  0 = size-triggered rewrites
        # only (the CONSTDB_TORCH_AOF_REWRITE_PCT policy, unchanged).
        self.checkpoint_secs = \
            env_float("CONSTDB_TORCH_CHECKPOINT_SECS", 0.0) \
            if checkpoint_secs is None else checkpoint_secs
        self.checkpoint_min_mb = \
            env_int("CONSTDB_TORCH_CHECKPOINT_MIN_MB", 1) \
            if checkpoint_min_mb is None else checkpoint_min_mb
        # point-in-time restore: replay stops at this uuid and the log
        # re-bases on the next rewrite.  Run against a COPY of the dir.
        self.restore_to = restore_to
        # cluster mode (constdb_tpu_torch/cluster): hash-slot keyspace
        # partitioning across replication groups.  None = the
        # CONSTDB_TORCH_CLUSTER / CONSTDB_TORCH_SLOT_GROUPS /
        # CONSTDB_TORCH_MIGRATE_BATCH_MB env defaults; `cluster_group` is
        # this node's group id (the operator's --cluster-group).  Off
        # (the default) node.cluster stays None and every code path is
        # the exact pre-cluster node.
        self.cluster = env_flag("CONSTDB_TORCH_CLUSTER", False) \
            if cluster is None else cluster
        self.slot_groups = env_int("CONSTDB_TORCH_SLOT_GROUPS", 1) \
            if slot_groups is None else slot_groups
        self.migrate_batch_mb = \
            env_int("CONSTDB_TORCH_MIGRATE_BATCH_MB", 8) \
            if migrate_batch_mb is None else migrate_batch_mb
        self.cluster_group = cluster_group
        if self.cluster and node.cluster is None:
            from ..cluster.slots import ClusterState, even_split
            node.cluster = ClusterState(
                cluster_group, even_split(max(1, self.slot_groups)))
            # slot ownership moving away invalidates every tracked key
            # hashing into the moved slots (server/tracking.py
            # slots_lost — the migration half of the tracking laws)
            node.cluster.on_slots_lost = node.tracking.slots_lost
        self.serve_plane = None
        # awaited by start() AFTER the serve plane is up but BEFORE the
        # listener opens — the sharded boot restore (start_node) runs
        # here so a reconnecting peer can never observe the un-fenced
        # merged repl_log (can_resume_from(cursor) on empty segments
        # would grant a PARTSYNC that silently omits every restored
        # key), and early clients never read half-restored shards
        self._boot_restore = None
        # peers silent beyond this stop pinning the GC horizon
        self.gc_peer_retention = gc_peer_retention
        node.replicas.gc_peer_retention_ms = int(gc_peer_retention * 1000)
        self._server: Optional[asyncio.base_events.Server] = None
        self._cron_task: Optional[asyncio.Task] = None
        self._conn_tasks: set[asyncio.Task] = set()
        # live client connections (server/tracking.py ClientConn), keyed
        # by the monotonically-minted client id — CLIENT ID/LIST and the
        # tracking registry's fan-out both read this
        self.client_conns: dict[int, object] = {}
        self._next_cid = 0
        self._closing = False
        from ..persist.share import SharedDump
        self.shared_dump = SharedDump(self)

    # ------------------------------------------------------------ lifecycle

    @property
    def advertised_addr(self) -> str:
        return self._advertised or f"{self.host}:{self.port}"

    def snapshot_ingest_shards(self, size: int) -> int:
        """How many hash shards a downloaded snapshot of `size` bytes
        should fan out over (1 = plain single-keyspace path)."""
        if size < self.ingest_shard_min_bytes:
            return 1
        n = self.ingest_shards
        if n == 0:
            from ..store.sharded_keyspace import default_shards
            n = default_shards()
        return max(1, n)

    async def start(self) -> None:
        os.makedirs(self.work_dir, exist_ok=True)
        if not self.node.node_id:
            # CRDT tie-breaks hinge on distinct writer node ids; an operator
            # who skips `node_id` in the config must not get three identical
            # writers (the reference defaults to 0 for everyone — conf.rs:63)
            import random as _random
            self.node.node_id = _random.SystemRandom().randrange(1, 1 << 31)
            log.info("auto-assigned node_id %d", self.node.node_id)
        self.node.stats.start_time = time.time()
        if self.serve_shards > 1:
            # spawn the shard workers BEFORE the listener opens (they
            # need the final node_id — workers stamp it into writes)
            from .serve_shards import ServeShardPlane
            self.serve_plane = ServeShardPlane(self, self.serve_shards)
            await self.serve_plane.start()
        # bind (resolving an ephemeral port — advertised_addr is live
        # from here) but do NOT accept yet: the boot restore below must
        # land its watermark fences first
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port,
            backlog=self.tcp_backlog, start_serving=False)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.node.cluster is not None:
            # our own group's address book entry: live as soon as the
            # (possibly ephemeral) port is known, so redirects and
            # gossiped tables name a dialable address
            self.node.cluster.table.groups.setdefault(
                self.node.cluster.my_gid, self.advertised_addr)
        if self._boot_restore is not None:
            await self._boot_restore()
        await self._server.start_serving()
        self._cron_task = asyncio.create_task(self._cron())
        # reconnect links for membership restored from a snapshot
        for m in self.node.replicas.live_peers():
            self.ensure_link(m)
        log.info("node %d listening on %s", self.node.node_id,
                 self.advertised_addr)

    async def close(self) -> None:
        self._closing = True
        if self._cron_task is not None:
            self._cron_task.cancel()
        for m in list(self.node.replicas.peers.values()):
            if isinstance(m.link, ReplicaLink):
                await m.link.stop()
        # stop accepting FIRST, then cancel handlers, then wait: on Python
        # 3.12+ Server.wait_closed waits for every spawned handler, so
        # waiting before the cancel sweep deadlocks on any live client —
        # and cancelling before close() would miss a handler accepted
        # during the link-stop awaits above
        if self._server is not None:
            self._server.close()
        await asyncio.sleep(0)  # let just-accepted handlers register
        for t in list(self._conn_tasks):
            t.cancel()
        if self._server is not None:
            await self._server.wait_closed()
        # second link sweep: a connection accepted just before the
        # listener closed can reach _upgrade_to_replica AFTER the sweep
        # above, registering a fresh link whose serve/push tasks would
        # outlive this app — a zombie stream that keeps a "closed" node
        # applying its peer's ops (found while pinning the ring-falloff
        # resync fallback: the zombie kept the restarted peer secretly
        # caught up, so the full-sync path never ran)
        for m in list(self.node.replicas.peers.values()):
            if isinstance(m.link, ReplicaLink):
                await m.link.stop()
        if self.serve_plane is not None:
            await self.serve_plane.close()
        if self.node.oplog is not None:
            # final group commit + close (policy `no` drains without
            # forcing an fsync — that is its contract)
            self.node.oplog.close()

    async def serve_forever(self) -> None:
        assert self._server is not None
        await self._server.serve_forever()

    # ----------------------------------------------------------------- cron

    async def _cron(self) -> None:
        """(reference server.rs:134-146: 100ms tick — advance uuid, gc).

        The tick sleep doubles as an event wait: a key-level delete
        (EVENT_DELETED — new garbage) or an advanced ack watermark
        (EVENT_REPLICA_ACKED — the horizon moved) triggers a GC sweep at
        the next tick instead of waiting out the full gc_interval."""
        from .events import EVENT_DELETED, EVENT_REPLICA_ACKED
        consumer = self.node.events.new_consumer(
            EVENT_DELETED | EVENT_REPLICA_ACKED)
        last_gc = 0.0
        loop = asyncio.get_running_loop()
        x = self.node.stats.extra
        try:
            while True:
                t0 = loop.time()
                woke = await consumer.wait(timeout=0.1)
                self.node.hlc.tick(False)
                now = loop.time()
                if not woke:
                    # event-loop lag: how far past the tick timeout this
                    # wake actually ran — the operator's view of intake
                    # saturation (a wedged loop shows up HERE first)
                    lag_ms = max(0.0, (now - t0 - 0.1) * 1000.0)
                    x["loop_lag_ms"] = round(lag_ms, 2)
                    if lag_ms > x.get("loop_lag_ms_max", 0.0):
                        x["loop_lag_ms_max"] = round(lag_ms, 2)
                # watermark re-check each tick: replication intake and
                # pool growth move used_memory without any client write
                # ever consulting the gate (server/overload.py)
                self.node.governor.tick()
                oplog = self.node.oplog
                if oplog is not None:
                    # everysec group commits, watermark records, and the
                    # rewrite-compaction check (persist/oplog.py)
                    await oplog.cron(self)
                due = now - last_gc >= self.gc_interval
                early = woke and now - last_gc >= self.gc_interval / 4
                if due or early:
                    if self.serve_plane is not None:
                        await self.serve_plane.gc(self.node.gc_horizon())
                    else:
                        self.node.gc()
                    last_gc = now
        finally:
            consumer.close()

    # ---------------------------------------------------------------- links

    async def open_peer_connection(self, host: str, port: int):
        """Dial a replica peer (replica/link.py _dial_once).  Routed
        through `peer_connector` when one is installed (the chaos
        harness's fault plane); a plain TCP connection otherwise."""
        if self.peer_connector is not None:
            return await self.peer_connector(host, port)
        return await asyncio.open_connection(host, port)

    def ensure_link(self, meta: ReplicaMeta) -> None:
        """Spawn (or keep) the dialing link for a live peer."""
        if not meta.alive or meta.addr == self.advertised_addr:
            return
        if isinstance(meta.link, ReplicaLink):
            meta.link.start()
            return
        ReplicaLink(self, meta).start()

    async def drop_link(self, meta: ReplicaMeta) -> None:
        if isinstance(meta.link, ReplicaLink):
            await meta.link.stop()

    # ----------------------------------------------------------- connection

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        if self._closing:  # raced the listener shutdown: refuse outright
            writer.close()
            return
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        self.node.stats.connections_accepted += 1
        self.node.stats.current_clients += 1
        from .tracking import ClientConn
        self._next_cid += 1
        try:
            peer = writer.get_extra_info("peername")
            addr = f"{peer[0]}:{peer[1]}" if peer else "?"
        except (AttributeError, OSError, IndexError):  # pragma: no cover
            addr = "?"
        client = ClientConn(self._next_cid, addr, writer,
                            created=time.time())
        self.client_conns[client.cid] = client
        try:
            # bound the transport's userspace reply buffer: drain()
            # engages at the high-water mark, so one connection's
            # in-flight pipeline depth is one chunk of replies — a
            # stalled reader parks its coroutine at the mark instead of
            # growing the buffer (the outbuf cap below catches the case
            # where a single chunk's replies blow straight past it)
            writer.transport.set_write_buffer_limits(
                high=min(self.client_outbuf_max or (1 << 18), 1 << 18))
        except (AttributeError, RuntimeError):  # pragma: no cover
            pass
        parser = make_parser()
        out = bytearray()
        upgraded = False
        plane = self.serve_plane
        coal = None
        if plane is None and self.serve_batch > 1:
            # pipelined chunks are PLANNED instead of executed
            # per message (server/serve.py); serve_batch <= 1
            # (CONSTDB_TORCH_SERVE_BATCH=1) keeps the exact per-command loop.
            # With a serve PLANE active the chunk is ROUTED instead
            # (server/serve_shards.py) — the workers own the coalescers.
            from .serve import ServeCoalescer
            coal = ServeCoalescer(self.node, max_run=self.serve_batch,
                                  client=client)
        try:
            while True:
                data = await reader.read(_READ_CHUNK)
                if not data:
                    break
                self.node.stats.net_in_bytes += len(data)
                parser.feed(data)
                if coal is None and plane is None:
                    while (msg := parser.next_msg()) is not None:
                        if self._is_sync(msg):
                            # replies for commands pipelined BEFORE the
                            # SYNC must reach the client before the
                            # handshake reply takes over the stream
                            await self._aof_ack_barrier()
                            out = self._flush_out(writer, out)
                            self._upgrade_to_replica(msg, reader, writer,
                                                     parser)
                            upgraded = True
                            break
                        reply = self.node.execute(msg, client=client)
                        if not isinstance(reply, NoReply):
                            encode_into(out, reply)
                else:
                    # native intake stage: the C scanner owns every
                    # leading well-formed flat frame (split + classify
                    # in one call); whatever it stops at — partial
                    # frame, SYNC upgrade, malformed bytes, nested
                    # array — stays buffered for the drain() below,
                    # which keeps the reference behavior for those
                    # frames byte for byte.  A serve plane routes
                    # drained messages instead.
                    while coal is not None and \
                            (nat := parser.native_drain()) is not None:
                        stats = self.node.stats
                        stats.native_intake_chunks += 1
                        stats.native_intake_msgs += len(nat[0])
                        coal.run_native_chunk(nat[0], nat[1], out)
                    msgs = parser.drain()
                    for i, msg in enumerate(msgs):
                        if self._is_sync(msg):
                            # messages after the SYNC belong to the
                            # replica link's stream — hand them back
                            # before the link adopts the parser
                            parser.pushback(msgs[i + 1:])
                            if i:
                                await self._run_chunk(plane, coal,
                                                      msgs[:i], out, client)
                            await self._aof_ack_barrier()
                            out = self._flush_out(writer, out)
                            self._upgrade_to_replica(msg, reader, writer,
                                                     parser)
                            upgraded = True
                            break
                    else:
                        if msgs:
                            await self._run_chunk(plane, coal, msgs, out,
                                                  client)
                if upgraded:
                    return  # connection now owned by the replica link
                if out:
                    # fsync=always ack gate: replies reach the socket
                    # only after the group commit covering this chunk's
                    # appends lands — one fsync per pipelined chunk,
                    # riding the coalescer's end-of-chunk flush barrier
                    await self._aof_ack_barrier()
                    out = self._flush_out(writer, out)
                    if self._outbuf_overflow(writer):
                        return  # disconnected loudly; finally cleans up
                    await writer.drain()
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            pass
        except CstError as e:
            # a malformed frame mid-pipeline: replies already encoded in
            # `out` for earlier completed commands must still reach the
            # client (dropping them desyncs its pipeline accounting), and
            # messages that parsed cleanly before the bad frame still
            # execute (the parser stashed them — take_queued)
            try:
                salvaged = parser.take_queued()
                sync_at = next((i for i, m in enumerate(salvaged)
                                if self._is_sync(m)), -1)
                if sync_at >= 0:
                    # a SYNC parsed clean before the bad frame: execute
                    # the prefix, hand the rest back, and upgrade — the
                    # malformed bytes stay in the parser and surface on
                    # the link's stream (the per-command loop's behavior)
                    head, syn = salvaged[:sync_at], salvaged[sync_at]
                    parser.pushback(salvaged[sync_at + 1:])
                    salvaged = head
                if salvaged:
                    if coal is not None or plane is not None:
                        await self._run_chunk(plane, coal, salvaged, out,
                                              client)
                    else:
                        for msg in salvaged:
                            reply = self.node.execute(msg, client=client)
                            if not isinstance(reply, NoReply):
                                encode_into(out, reply)
                await self._aof_ack_barrier()
                if sync_at >= 0:
                    out = self._flush_out(writer, out)
                    self._upgrade_to_replica(syn, reader, writer, parser)
                    upgraded = True
                    return
                encode_into(out, Err(e.resp_error()))
                out = self._flush_out(writer, out)
                await writer.drain()
            except (ConnectionError, OSError):
                pass
        finally:
            self.node.stats.current_clients -= 1
            self._conn_tasks.discard(task)
            # tracking state dies with the connection (the liveness half
            # of the invalidate-before-visible law): a client's cached
            # entries are only trustworthy while the connection that
            # filled them lives, so the server forgets the subscription
            # the moment it can no longer deliver pushes on it
            if client.tracking:
                self.node.tracking.unsubscribe(client)
            client.writer = None
            self.client_conns.pop(client.cid, None)
            # an upgraded connection is owned by its replica link now
            if not upgraded and not writer.is_closing():
                writer.close()

    async def _aof_ack_barrier(self) -> None:
        """fsync=always group commit before replies flush (no-op for
        every other policy, and when nothing is pending)."""
        oplog = self.node.oplog
        if oplog is not None and oplog.ack_barrier_needed:
            await oplog.ack_barrier()

    async def _run_chunk(self, plane, coal, msgs: list,
                         out: bytearray, client=None) -> None:
        """One drained pipelined chunk, through whichever machinery this
        node runs: the shard-routing plane (serve_shards > 1) or the
        in-loop coalescer (serve_batch > 1).  `client` is the
        connection's ClientConn (HELLO / CLIENT TRACKING state) — the
        coalescer already carries it; the shared plane takes it per
        chunk."""
        if plane is not None:
            await plane.run_chunk(msgs, out, client=client)
        else:
            coal.run_chunk(msgs, out)

    def _outbuf_overflow(self, writer) -> bool:
        """Slow-client protection (CONSTDB_TORCH_CLIENT_OUTBUF_MAX): a client
        whose un-drained reply bytes pass the cap is disconnected LOUDLY
        — counted, logged, transport aborted (it is not reading; a
        graceful close would park on the very buffer being dropped) —
        instead of pinning unbounded reply memory on the loop.  The
        disconnect is connection-fatal but never state-corrupting: every
        landed write already landed; only undelivered reply bytes drop
        (docs/INVARIANTS.md "Degradation laws")."""
        cap = self.client_outbuf_max
        if not cap:
            return False
        tr = writer.transport
        if tr is None or tr.get_write_buffer_size() <= cap:
            return False
        self.node.stats.client_outbuf_disconnects += 1
        try:
            peer = writer.get_extra_info("peername")
        except (AttributeError, OSError):  # pragma: no cover
            peer = None
        log.warning(
            "client %s disconnected: reply buffer %d bytes over "
            "CONSTDB_TORCH_CLIENT_OUTBUF_MAX=%d (reader stalled)", peer,
            tr.get_write_buffer_size(), cap)
        tr.abort()
        return True

    def _flush_out(self, writer, out: bytearray) -> bytearray:
        """Queue accumulated replies on the transport and return a fresh
        buffer.  Buffer SWAP instead of bytes(out): ownership moves to
        the transport (which copies only what it cannot send
        immediately) — no reply-buffer copy per chunk.  Also used before
        a SYNC upgrade takes the stream over, so pipelined-before-SYNC
        replies are not dropped."""
        if out:
            self.node.stats.net_out_bytes += len(out)
            writer.write(out)
            out = bytearray()
        return out

    @staticmethod
    def _is_sync(msg) -> bool:
        return (isinstance(msg, Arr) and msg.items
                and isinstance(msg.items[0], Bulk)
                and msg.items[0].val.lower() == SYNC)

    def _upgrade_to_replica(self, msg, reader, writer, parser) -> None:
        """Passive handshake: register/refresh the peer, reply `sync 1`,
        hand the connection to its link."""
        if self._closing:  # the second close() sweep would stop the link,
            writer.close()  # but never adopting is cheaper and race-free
            return
        items = msg.items
        try:
            role = as_int(items[1])
            peer_id = as_int(items[2])
            peer_alias = as_bytes(items[3]).decode("utf-8", "replace")
            peer_addr = as_bytes(items[4]).decode("utf-8", "replace")
            peer_resume = as_int(items[5])
            # capability bits (replica/link.py CAP_*); a pre-capability
            # peer sends 6-item frames — tolerate, never assume support
            peer_caps = as_int(items[6]) if len(items) > 6 else 0
        except (IndexError, CstError):
            writer.write(b"-malformed sync\r\n")
            writer.close()
            return
        if role != 0 or peer_addr == self.advertised_addr:
            writer.write(b"-bad sync role or self-sync\r\n")
            writer.close()
            return
        node = self.node
        prev = node.replicas.get(peer_addr)
        if prev is not None and not prev.alive:
            # FORGET must stick: a tombstoned peer's SYNC is rejected until
            # an explicit MEET re-admits the address (Redis CLUSTER
            # FORGET-style ban).  Auto-re-adding here resurrected forgotten
            # peers across the whole mesh within one reconnect_delay.
            # structured error CODE (first token) — the dialing link matches
            # on this prefix to suspend, so an unrelated error that merely
            # mentions the word can never trip it (replica/link.py)
            writer.write(b"-FORGOTTEN removed from this mesh; "
                         b"an explicit MEET is required to rejoin\r\n")
            writer.close()
            return
        newly_met = prev is None
        meta = node.replicas.add(peer_addr, node.hlc.tick(True),
                                 node_id=peer_id, alias=peer_alias)
        if newly_met:
            # replicate the introduction so the whole mesh learns this peer
            # even when every sync is partial and no snapshot (with its
            # REPLICAS section) ever flows — the reference only propagates
            # membership through full syncs (pull.rs:136-153), which leaves
            # hub-and-spoke topologies permanently partitioned
            node.execute([Bulk(b"meet"), Bulk(peer_addr.encode())])
        from ..replica.link import my_caps
        writer.write(encode_msg_arr([
            Bulk(SYNC), Int(1), Int(node.node_id), Bulk(node.alias.encode()),
            Bulk(self.advertised_addr.encode()), Int(meta.uuid_he_sent),
            Int(my_caps(self, meta))]))
        link = meta.link if isinstance(meta.link, ReplicaLink) else \
            ReplicaLink(self, meta)
        link.adopt(reader, writer, parser, peer_resume, peer_caps=peer_caps)
        link.start()  # dial loop doubles as the reconnect supervisor


def encode_msg_arr(items) -> bytes:
    out = bytearray()
    encode_into(out, Arr(items))
    return bytes(out)


def _quarantine_snapshot(node: Node, path: str, err: BaseException) -> str:
    """Boot-resilience for a truncated/bit-flipped snapshot: rename it
    aside (`.corrupt` — evidence for the operator, and the crash-loop
    breaker: the next boot no longer sees it), log LOUDLY, and flag it
    in INFO (`boot_snapshot_quarantined`).  The node then boots EMPTY
    and rejoins the mesh as a fresh replica — degraded but alive, which
    beats a node that can never start."""
    qpath = path + ".corrupt"
    try:
        os.replace(path, qpath)
    except OSError as mv_err:  # pragma: no cover - fs-dependent
        log.error("could not quarantine corrupt snapshot %s: %s",
                  path, mv_err)
        qpath = path
    log.error("boot snapshot %s is unreadable (%s: %s); quarantined to "
              "%s — booting EMPTY", path, type(err).__name__, err, qpath)
    node.stats.extra["boot_snapshot_quarantined"] = qpath
    return qpath


# what a damaged snapshot file can surface as through the loader: framing
# and checksum failures (InvalidSnapshot*), section-decode failures the
# loader does not wrap (ValueError/KeyError/OverflowError from a
# bit-flipped length or enum), and plain IO errors
_SNAPSHOT_LOAD_ERRORS = (CstError, OSError, ValueError, KeyError,
                         IndexError, OverflowError, EOFError)


def _schedule_cache_warm(app: ServerApp) -> None:
    """Digest crc caches warm OFF the boot path: an executor thread
    fills them after the listener opens (keyspace.warm_digest_caches
    takes its own lock — the replica-link digest path uses the same
    off-loop discipline), so restart wall time measures replay, not
    cache rebuilds.  The read cache stays cold until traffic arrives."""
    node = app.node
    loop = asyncio.get_event_loop()
    t0 = time.monotonic()

    def _warm() -> None:
        try:
            node.ks.warm_digest_caches()
            node.stats.extra["digest_warm_s"] = round(
                time.monotonic() - t0, 3)
        except Exception:  # noqa: BLE001 - warming is best-effort
            log.exception("digest cache warm failed")

    loop.run_in_executor(None, _warm)


async def start_node(node: Node, **kwargs) -> ServerApp:
    """Convenience: build + start a ServerApp (optionally restoring the
    boot snapshot — a capability the reference lacks, SURVEY.md §5.4).
    Every boot restore lands its rows (a resident engine defers them to
    its whole-plane flush) before the listener opens: the boot, not the
    first client, pays for it."""
    app = ServerApp(node, **kwargs)
    if app.aof:
        # durable op log: boot recovery = chosen snapshot (the AOF base
        # when one exists, the boot snapshot otherwise) + the oplog
        # tail replayed through the REAL merge path, with torn-tail
        # repair and the watermark consistency-cut rules
        # (persist/oplog.py).  A corrupt snapshot quarantines and falls
        # back to AOF-only replay — the log is quarantined too only
        # when it is itself unreadable.
        from ..persist import oplog as oplog_mod
        if app.serve_shards > 1:
            if not node.node_id:
                nid = oplog_mod.prescan_node_id(app.aof_dir,
                                                app.snapshot_path)
                if nid:
                    node.node_id = nid

            async def _restore_aof_plane() -> None:
                t0 = time.monotonic()
                await oplog_mod.recover_into_plane(
                    app, restore_to=app.restore_to)
                node.stats.extra["recovery_wall_s"] = round(
                    time.monotonic() - t0, 3)
                if app.restore_to and node.oplog is not None:
                    # cut the fresh base NOW (arm flagged the log
                    # dirty): the tail above the restore target must
                    # never replay again
                    await node.oplog.rewrite(app)

            app._boot_restore = _restore_aof_plane
            await app.start()
            _schedule_cache_warm(app)
            return app
        t0 = time.monotonic()
        info = oplog_mod.recover(node, app.aof_dir,
                                 boot_snapshot=app.snapshot_path,
                                 engine=node.engine,
                                 restore_to=app.restore_to)
        node.ensure_flushed()
        lg = oplog_mod.arm(app, info)
        node.stats.extra["recovery_wall_s"] = round(
            time.monotonic() - t0, 3)
        await app.start()
        if app.restore_to:
            # see the sharded branch above: re-base immediately
            await lg.rewrite(app)
        _schedule_cache_warm(app)
        return app
    if app.serve_shards > 1:
        # shard-per-core node: workers ARE the store, so the boot
        # snapshot fans out to them — which requires the plane up first
        # (start()).  The snapshot's node identity is pre-scanned so the
        # workers spawn with the RESTORED node_id; the data ingest +
        # watermark fences run as start()'s boot-restore hook, after the
        # plane is up but BEFORE the listener opens — the same
        # fence-before-serving order the plain path below enforces, for
        # the same reason (see its comment: an un-fenced log grants
        # divergent PARTSYNCs).
        from ..persist.snapshot import SectionDemux, SnapshotLoader
        loop = asyncio.get_event_loop()
        restore = app.snapshot_path and os.path.exists(app.snapshot_path)
        if restore and not node.node_id:
            try:
                f = await loop.run_in_executor(None, open,
                                               app.snapshot_path, "rb")
                try:
                    for kind, payload in SnapshotLoader(f):
                        if kind == "node":
                            if payload.node_id:
                                node.node_id = payload.node_id
                            break
                finally:
                    f.close()
            except _SNAPSHOT_LOAD_ERRORS as e:
                _quarantine_snapshot(node, app.snapshot_path, e)
                restore = False
        if restore:

            async def restore_into_plane() -> None:
                t0 = time.monotonic()
                f = await loop.run_in_executor(None, open,
                                               app.snapshot_path, "rb")
                demux = SectionDemux(f)
                try:
                    await app.serve_plane.ingest_batches(demux.batches())
                except _SNAPSHOT_LOAD_ERRORS as e:
                    # a mid-file corruption can strand a PARTIAL restore
                    # in the workers: wipe them so "boots empty" is
                    # really empty, then quarantine + serve
                    await app.serve_plane.pool.call_all("reset")
                    _quarantine_snapshot(node, app.snapshot_path, e)
                    return
                finally:
                    f.close()
                if demux.meta is not None:
                    node.hlc.observe(demux.meta.repl_last_uuid)
                    node.repl_log.last_uuid = demux.meta.repl_last_uuid
                    node.repl_log.evicted_up_to = demux.meta.repl_last_uuid
                    node.replicas.merge_records(
                        demux.replica_rows, my_addr=app.advertised_addr,
                        adopt_watermarks=True)
                    # each worker lands its restored rows now (see the
                    # plain path's flush)
                    await app.serve_plane.pool.call_all("flush")
                    x = node.stats.extra
                    x["recovery_wall_s"] = round(time.monotonic() - t0, 3)
                    x["recovery_mode"] = "snapshot"
                    log.info("restored snapshot %s into %d serve shards",
                             app.snapshot_path, app.serve_shards)

            app._boot_restore = restore_into_plane
        await app.start()
        return app
    if app.snapshot_path and os.path.exists(app.snapshot_path):
        from ..persist.snapshot import load_snapshot
        t0 = time.monotonic()
        try:
            meta, records = load_snapshot(app.snapshot_path, node.ks,
                                          engine=node.engine)
        except _SNAPSHOT_LOAD_ERRORS as e:
            # a truncated/bit-flipped file can fail MID-merge: discard
            # whatever partial state landed (fresh keyspace + resident
            # mirrors) so the quarantined boot is really empty, not a
            # silent partial restore a peer would then merge against
            if hasattr(node.engine, "discard_resident"):
                node.engine.discard_resident()
            node.ks = node._make_keyspace()
            _quarantine_snapshot(node, app.snapshot_path, e)
        else:
            if meta.node_id and not node.node_id:
                node.node_id = meta.node_id
            node.hlc.observe(meta.repl_last_uuid)
            # The fresh repl_log does not cover any of the restored
            # history, so a peer resuming below the restored watermark
            # MUST get a full snapshot — with last_uuid/evicted_up_to
            # left at 0, can_resume_from(0) would be true and the push
            # loop would serve PARTSYNC that silently omits every
            # restored key (permanent divergence).  Same rule the
            # reference applies when the resume point falls outside the
            # ring (push.rs:95-110).
            node.repl_log.last_uuid = meta.repl_last_uuid
            node.repl_log.evicted_up_to = meta.repl_last_uuid
            # snapshot-backed: the restored keyspace carries the state
            # behind the recorded watermarks, so adopting them is
            # lossless (and required — see merge_records)
            node.replicas.merge_records(records,
                                        my_addr=app.advertised_addr,
                                        adopt_watermarks=True)
            # land the restored rows (a resident engine defers them to
            # its whole-plane flush) before the node serves: the boot,
            # not the first client, pays for it
            node.ensure_flushed()
            x = node.stats.extra
            x["recovery_wall_s"] = round(time.monotonic() - t0, 3)
            x["recovery_mode"] = "snapshot"
            log.info("restored snapshot %s (%d keys)", app.snapshot_path,
                     node.ks.n_keys())
    await app.start()
    return app
