"""Chaos-cluster lifecycle: nodes under the fault plane.

First-class scenario primitives: per-cell node configs (engine and
its device, capability knobs, serve shards), deterministic per-node HLC
clocks with scripted jitter, crash/restart (cold via the real snapshot/
boot paths, warm via a server rebuild over the surviving Node), and
plane-aware state reads (a shard-per-core node's canonical/digest come
from its workers).  Every node dials its peers through the plane's
connector, so the whole mesh's transport is fault-injectable.

The port's copy.  A node's engine is named, never defaulted: `Node()`
with no engine builds a TorchMergeEngine on the card (and raises without
one), so the "cpu" spec passes the port's CpuMergeEngine explicitly and
the card specs ("torch", "torch-resident") build a TorchMergeEngine on
`NodeSpec.device` ("cuda" unless the caller asks for the CPU).  A cold
restart or kill -9 retires the old engine (its device mirrors, staging
threads and pinned buffers) before the fresh Node builds its own.
"""

from __future__ import annotations

import asyncio
import os
import random
from dataclasses import dataclass, field
from typing import Optional

from ..persist.snapshot import NodeMeta, dump_keyspace, write_snapshot_file
from ..resp.codec import RespParser, encode_msg
from ..resp.message import Arr, Bulk, Msg
from ..server.io import ServerApp, start_node
from ..server.node import Node
from ..utils.hlc import now_ms
from .plane import FaultPlane

# fast-cadence server knobs for in-process meshes (the old
# cluster_util.FAST, plus the backoff bounds chaos runs need: retries
# must stay sub-second so a healed partition re-forms the mesh inside a
# convergence window, and the handshake must time out faster than a
# scenario step)
FAST = dict(heartbeat=0.15, reconnect_delay=0.2, reconnect_max=1.0,
            gc_interval=0.2, handshake_timeout=3.0)


def _retire_engine(node: Node) -> None:
    """Close a discarded Node's engine.  A card engine also drops its
    device mirrors at once (the host store goes with the Node, so no
    flush is owed): every node of the mesh and its restarts share one
    process and one card."""
    eng = node.engine
    if hasattr(eng, "discard_resident"):
        eng.discard_resident()
    if hasattr(eng, "close"):
        eng.close()


class ChaosClock:
    """Deterministic per-node HLC wall source with scripted jitter.

    The fixed-clock hook from the serve-coalescer tests (Node(clock=…)),
    grown for chaos: each call advances a private millisecond counter by
    a small seeded step (so two nodes' clocks drift apart on their own),
    and `jump()` applies scripted skew — forward leaps and BACKWARD
    steps both, since HLC monotonicity under clock regression is exactly
    the property worth certifying.  Pure function of (seed, node, call
    count, jumps): replays exactly.
    """

    def __init__(self, seed: int, node_idx: int,
                 start_ms: Optional[int] = None) -> None:
        self._ms = now_ms() if start_ms is None else start_ms
        self._skew = 0
        self._rng = random.Random((seed << 8) ^ (node_idx * 2654435761))

    def __call__(self) -> int:
        self._ms += self._rng.choice((0, 1, 1, 2))
        return self._ms + self._skew

    def jump(self, delta_ms: int) -> None:
        self._skew += delta_ms


@dataclass
class NodeSpec:
    """One node's capability-cell configuration."""

    engine: str = "cpu"            # cpu | torch | torch-resident
    device: str = "cuda"           # the card specs' device ("cpu" in
    #                                the CPU tests)
    wire_batch: Optional[int] = None   # 1 = per-frame wire (cap withheld)
    delta_sync: Optional[bool] = None  # False = full snapshots only
    wire_compress: Optional[bool] = None  # False = plain streams/dumps
    #                                       (CAP_COMPRESS withheld)
    apply_batch: Optional[int] = None
    serve_batch: Optional[int] = None
    serve_shards: int = 1
    repl_log_cap: int = 1_024_000
    # durable op log (persist/oplog.py): the fsync policy name enables
    # AOF for this node ("always" | "everysec" | "no"); None = off.
    # The cluster pins each node's aof dir to its index so kill9/cold
    # restarts recover from the node's OWN log, no harness-side dump.
    aof: Optional[str] = None
    extra: dict = field(default_factory=dict)

    def build_engine(self):
        if self.engine == "cpu":
            from ..engine.cpu import CpuMergeEngine
            return CpuMergeEngine()
        from ..engine.cuda import TorchMergeEngine
        if self.engine == "torch":
            return TorchMergeEngine(resident=True, steady=False,
                                    device=self.device)
        if self.engine == "torch-resident":
            return TorchMergeEngine(resident=True, steady=True, warmup=0,
                                    device=self.device)
        raise ValueError(f"unknown engine spec {self.engine!r}")

    def app_kwargs(self) -> dict:
        kw = dict(FAST)
        kw.update(self.extra)
        if self.wire_batch is not None:
            kw["wire_batch"] = self.wire_batch
        if self.delta_sync is not None:
            kw["delta_sync"] = self.delta_sync
        if self.wire_compress is not None:
            kw["wire_compress"] = self.wire_compress
        if self.apply_batch is not None:
            kw["apply_batch"] = self.apply_batch
        if self.serve_batch is not None:
            kw["serve_batch"] = self.serve_batch
        if self.serve_shards > 1:
            kw["serve_shards"] = self.serve_shards
        if self.aof is not None:
            kw["aof"] = True
            kw["aof_fsync"] = self.aof
        return kw


class Client:
    """Minimal RESP client (the reference's constdb-cli/test transport)."""

    def __init__(self) -> None:
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.parser = RespParser()

    async def connect(self, addr: str) -> "Client":
        host, port = addr.rsplit(":", 1)
        self.reader, self.writer = await asyncio.open_connection(host,
                                                                 int(port))
        return self

    async def cmd(self, *parts) -> Msg:
        items = [Bulk(p if isinstance(p, bytes) else str(p).encode())
                 for p in parts]
        self.writer.write(encode_msg(Arr(items)))
        await self.writer.drain()
        while True:
            msg = self.parser.next_msg()
            if msg is not None:
                return msg
            data = await asyncio.wait_for(self.reader.read(1 << 16), 10.0)
            if not data:
                raise ConnectionError("EOF")
            self.parser.feed(data)

    async def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except (ConnectionError, OSError):
                pass


class ChaosCluster:
    """N nodes wired through one FaultPlane (see module docstring)."""

    def __init__(self, work_dir: str, seed: int, specs: list[NodeSpec],
                 plane: Optional[FaultPlane] = None,
                 journal=None) -> None:
        self.work_dir = str(work_dir)
        self.seed = seed
        self.specs = specs
        self.plane = plane if plane is not None else FaultPlane(seed)
        self.journal = journal
        self.apps: list[Optional[ServerApp]] = [None] * len(specs)
        self.clocks = [ChaosClock(seed, i) for i in range(len(specs))]
        self._ports: dict[int, int] = {}  # listen port -> node index
        # bumped per restart: the oracle monitor keys watermark baselines
        # by (node, incarnation) — a cold restart legally rewinds them
        self.incarnations = [0] * len(specs)
        # fault-accounting counters banked from nodes a cold restart
        # discarded (NodeStats dies with the process; the oracle's
        # accounting laws cover the whole run)
        self.retired_stats: dict[str, int] = {}

    def stat_total(self, name: str) -> int:
        """Sum of a NodeStats counter (or stats.extra key) over every
        live node PLUS everything banked from cold-restarted ones."""
        total = self.retired_stats.get(name, 0)
        for app in self.apps:
            if app is None:
                continue
            st = app.node.stats
            total += getattr(st, name, 0) or st.extra.get(name, 0)
        return total

    def _bank_stats(self, node: Node) -> None:
        st = node.stats
        for name in ("repl_wire_demotions", "repl_reconnects",
                     "repl_full_syncs", "repl_delta_syncs"):
            self.retired_stats[name] = \
                self.retired_stats.get(name, 0) + getattr(st, name)
        for name in ("fullsync_reset_refused", "repl_delta_demotions"):
            self.retired_stats[name] = \
                self.retired_stats.get(name, 0) + st.extra.get(name, 0)

    # ----------------------------------------------------------- lifecycle

    def _resolve(self, port: int) -> Optional[int]:
        return self._ports.get(port)

    def _wire(self, i: int, app: ServerApp) -> None:
        """Install the plane connector + oracle hooks on a (re)started
        node."""
        app.peer_connector = self.plane.connector(i, self._resolve)
        self._ports[app.port] = i
        self.apps[i] = app
        if self.journal is not None:
            self.journal.hook_node(app.node)

    async def start_one(self, i: int, node: Optional[Node] = None,
                        snapshot_path: str = "") -> ServerApp:
        spec = self.specs[i]
        if node is None:
            node = Node(node_id=i + 1, alias=f"n{i + 1}",
                        engine=spec.build_engine(),
                        repl_log_cap=spec.repl_log_cap,
                        clock=self.clocks[i])
        port = self.apps[i].port if self.apps[i] is not None else 0
        kw = spec.app_kwargs()
        if spec.aof is not None:
            # stable per-node dir: a restarted node recovers from its
            # OWN durable log, the way a real process would
            kw["aof_dir"] = os.path.join(self.work_dir, f"aof.n{i}")
        app = await start_node(node, host="127.0.0.1", port=port,
                               work_dir=self.work_dir,
                               snapshot_path=snapshot_path,
                               **kw)
        self._wire(i, app)
        return app

    async def start(self) -> "ChaosCluster":
        for i in range(len(self.specs)):
            await self.start_one(i)
        return self

    async def meet_all(self) -> None:
        c = await Client().connect(self.apps[0].advertised_addr)
        try:
            for other in self.apps[1:]:
                await c.cmd("meet", other.advertised_addr)
        finally:
            await c.close()

    async def close(self) -> None:
        await self.plane.close()
        for app in self.apps:
            if app is not None:
                await app.close()
                _retire_engine(app.node)

    # ------------------------------------------------------------- crashes

    async def restart_cold(self, i: int) -> ServerApp:
        """Crash + cold boot: dump state, kill the process state, build
        a FRESH Node restored from the snapshot on the same port — the
        real io.py boot-restore path (start_node), including the merged
        repl-log watermark fences.  The undo log, reconnect ladders, and
        every in-memory watermark die with the process, exactly as a
        real crash loses them.

        AOF variant: an AOF-enabled node takes NO harness-side dump —
        the clean shutdown group-commits its own log and recovery comes
        entirely from the node's own snapshot + oplog tail (the
        durability path under certification)."""
        app = self.apps[i]
        old = app.node
        if self.specs[i].aof is not None:
            await app.close()
            _retire_engine(old)
            self._bank_stats(old)
            self.incarnations[i] += 1
            return await self.start_one(i)
        snap = os.path.join(self.work_dir, f"chaos.{old.node_id}.snapshot")
        # watermarks (meta + records) BEFORE the state export — the
        # consistency-cut rule every dump site follows (persist/
        # share.py): a record captured after the export claims pull
        # coverage the exported state lacks, and the boot restore's
        # watermark adoption then skips that window's redelivery
        # forever (this very harness found that ordering bug live)
        meta = NodeMeta(node_id=old.node_id, alias=old.alias,
                        repl_last_uuid=old.repl_log.landed_last_uuid
                        if hasattr(old.repl_log, "landed_last_uuid")
                        else old.repl_log.last_uuid)
        records = old.replicas.records()
        if old.serve_plane is not None:
            captures = await old.serve_plane.export_batches()
            write_snapshot_file(snap, meta, records, captures)
        else:
            old.ensure_flushed()
            dump_keyspace(snap, old.ks, meta, records)
        await app.close()
        _retire_engine(old)
        self._bank_stats(old)
        self.incarnations[i] += 1
        return await self.start_one(i, snapshot_path=snap)

    async def kill9(self, i: int, torn: bool = False,
                    rng: Optional[random.Random] = None) -> ServerApp:
        """`kill -9` (+ optional power loss) and cold restart from the
        node's OWN durable op log — no harness-side dump, no graceful
        group commit:

          * process death: bytes the OpLog had buffered in memory die
            with it; bytes already written survive in the page cache
            (exactly a SIGKILL's semantics) — the op log is frozen
            AS-IS before the teardown's close path could flush it.
          * `torn=True` additionally models power loss: each segment is
            truncated at a SEEDED offset inside its un-fsynced suffix —
            possibly mid-record, the torn-tail case recovery must
            repair loudly.

        After recovery the journal obligation is pruned of the node's
        never-durable ops: by the emit-only-durable law they were never
        advertised to any peer, so they cease to exist mesh-wide
        (oracle.prune_origin); fsync-acknowledged writes are below the
        durable fence and MUST therefore still converge byte-identically
        — the zero-acked-loss certification."""
        app = self.apps[i]
        old = app.node
        lg = old.oplog
        assert lg is not None, "kill9 targets AOF-enabled nodes"
        paths = [lg.seg_path(lg.dir, lg.generation, s)
                 for s in range(lg.n_segments)]
        # freeze the log exactly as the dying process leaves it: close()
        # must NOT run its final drain + group commit — and a real
        # SIGKILL stops EVERYTHING at that same instant, so no in-flight
        # serve chunk may land, ack, or journal after the freeze (a
        # graceful close would keep quiescing worker chunks whose
        # mirror the frozen log silently drops: journaled-but-never-
        # logged ops that no fence can account for).  Connections and
        # the worker pool die first, then the teardown runs.
        lg._closed = True
        for t in list(app._conn_tasks):
            t.cancel()
        if app.serve_plane is not None:
            await app.serve_plane.close()
        await app.close()
        # the durable point is read AFTER close: an in-flight group
        # commit can SETTLE during the teardown awaits (releasing the
        # emission floor — a stopping push loop may legally emit those
        # just-durable ops), so a snapshot taken before close could
        # mark emitted-and-durable bytes as torn-able and the
        # truncation would forge exactly the emitted-but-lost
        # divergence the emit-only-durable law forbids (found by the
        # everysec cell flaking under load)
        synced = list(lg.synced_sizes)
        _retire_engine(old)
        self._bank_stats(old)
        if torn:
            r = rng if rng is not None else \
                random.Random((self.seed << 4) ^ (0x70A9 + i))
            for s, path in enumerate(paths):
                if not os.path.exists(path):
                    continue
                size = os.path.getsize(path)
                lo = min(synced[s] if s < len(synced) else size, size)
                if size > lo:
                    cut = r.randrange(lo, size)
                    with open(path, "r+b") as f:
                        f.truncate(cut)
        self.incarnations[i] += 1
        app2 = await self.start_one(i)
        if self.journal is not None:
            fence = app2.node.stats.extra.get("aof_recovered_fence", 0)
            pruned = self.journal.prune_origin(app2.node.node_id, fence)
            if pruned:
                self.retired_stats["journal_pruned"] = \
                    self.retired_stats.get("journal_pruned", 0) + pruned
        return app2

    async def checkpoint_crash(self, i: int, stage: str) -> ServerApp:
        """Crash INSIDE an incremental checkpoint: arm the op log's
        injected fault at `stage` ("switch" = new generation opened,
        "snapshot" = base snapshot written, "meta" = meta committed but
        old generations not yet deleted), drive a rewrite into it, then
        kill -9 and cold-restart from whatever interleaving the fault
        left on disk.  Every stage must replay idempotently: the
        surviving generations re-merge to the same state (the
        checkpoint-cut consistency law — the oracle certifies
        convergence right after)."""
        app = self.apps[i]
        lg = app.node.oplog
        assert lg is not None, "checkpoint_crash targets AOF nodes"
        lg._ckpt_fault = stage
        await lg.rewrite(app)  # raises inside; caught + flagged dirty
        assert lg._ckpt_fault == "", \
            f"checkpoint fault {stage!r} did not fire"
        return await self.kill9(i)

    async def restart_warm(self, i: int) -> ServerApp:
        """Process hiccup: the Node object (state, undo log, repl_log)
        survives, every connection does not."""
        app = self.apps[i]
        node = app.node
        port = app.port
        await app.close()
        self.incarnations[i] += 1
        kw = self.specs[i].app_kwargs()
        if self.specs[i].aof is not None:
            kw["aof_dir"] = os.path.join(self.work_dir, f"aof.n{i}")
        app2 = ServerApp(node, host="127.0.0.1", port=port,
                         work_dir=self.work_dir, **kw)
        if self.specs[i].aof is not None:
            # the Node (and its state) survives a warm restart, but the
            # old app's close() closed its op log — re-open it, no
            # replay needed (persist/oplog.py rearm)
            from ..persist.oplog import rearm
            rearm(app2)
        await app2.start()
        self._wire(i, app2)
        return app2

    def clock_jump(self, i: int, delta_ms: int) -> None:
        self.clocks[i].jump(delta_ms)

    # ---------------------------------------------------------- state reads

    async def canonical_of(self, i: int) -> dict:
        app = self.apps[i]
        plane = app.node.serve_plane
        if plane is not None:
            return await plane.canonical()
        return app.node.canonical()

    async def digest_of(self, i: int, fanout: int = 16,
                        leaves: int = 4):
        app = self.apps[i]
        plane = app.node.serve_plane
        if plane is not None:
            return await plane.state_digest(fanout, leaves)
        from ..store.digest import state_digest_matrix
        app.node.ensure_flushed()
        return state_digest_matrix(app.node.ks, fanout, leaves)

    async def converge(self, timeout: float = 30.0,
                       poll: float = 0.1) -> dict:
        """Poll until every node's canonical CRDT state is identical;
        returns the converged canonical.  On timeout, the differing keys
        are named — with the cluster seed, that is the whole repro."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            canons = [await self.canonical_of(i)
                      for i in range(len(self.apps))]
            if all(c == canons[0] for c in canons[1:]):
                return canons[0]
            if loop.time() > deadline:
                diff = set()
                for c in canons[1:]:
                    for k in set(c) | set(canons[0]):
                        if c.get(k) != canons[0].get(k):
                            diff.add(k)
                raise AssertionError(
                    f"[chaos seed={self.seed}] no convergence after "
                    f"{timeout}s; {len(diff)} keys differ, e.g. "
                    f"{sorted(diff)[:5]}")
            await asyncio.sleep(poll)

    async def full_mesh(self, timeout: float = 20.0) -> None:
        """Wait until every node has a connected link to every other."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        want = {a.advertised_addr for a in self.apps}
        while True:
            ok = True
            for app in self.apps:
                peers = {m.addr for m in app.node.replicas.live_peers()
                         if m.link is not None and m.link.connected}
                if want - {app.advertised_addr} - peers:
                    ok = False
                    break
            if ok:
                return
            if loop.time() > deadline:
                raise AssertionError(
                    f"[chaos seed={self.seed}] mesh did not fully connect")
            await asyncio.sleep(0.05)
