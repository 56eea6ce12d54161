"""Scenario DSL + the certification schedules.

A `Scenario` is (seed, capability cell, step list).  Steps are plain
data — `("ops", n)`, `("partition", a, b, sym)`, `("crash", i, style)`,
`("clock_jump", i, ms)`, … — so a schedule prints, diffs, and replays;
every random choice (op mix, targets, fault decisions, backoff jitter)
derives from the seed, so a failing run's printed seed IS its repro.

`certify_scenario` is the acceptance schedule: one
scripted run combining partitions (full and asymmetric), frame
reorder/duplication/delay, a mid-frame truncation kill, connection
kills, cold+warm process crashes, clock jitter (forward and backward),
a targeted REPLBATCH corruption, and one mixed-version peer — ending in
the full invariant oracle (convergence to the CPU reference, digest
agreement, watermark monotonicity, no-resurrection, GC drain, fault
accounting).  `matrix_cells` enumerates the capability sweep it must
pass on: wire batch x delta sync x serve shards x resident engine.
In the port the engines are "cpu" (the CpuMergeEngine), "torch" (a
resident TorchMergeEngine with the steady path off) and "torch-resident"
(steady rounds from the first, K3 each), the last two on `Cell.device`.

`soak_scenario` generates a randomized schedule from its seed for the
slow soak; any failure reports `[chaos seed=N]` and
`run_scenario(soak_scenario(N))` replays that exact schedule.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field, replace
from typing import Optional

from ..resp.message import Arr, Int
from .cluster import ChaosCluster, Client, NodeSpec
from .oracle import (InvariantMonitor, OpJournal, certify_state,
                     check_fault_accounting)
from .plane import FaultPlane


@dataclass
class Cell:
    """One capability-matrix cell: which negotiated fast paths are ON
    for the non-legacy nodes."""

    wire: bool = True       # REPLBATCH columnar wire (CAP_BATCH_STREAM)
    delta: bool = True      # digest-driven delta resync (CAP_DELTA_SYNC)
    compress: bool = True   # negotiated wire/bulk compression
    #                         (CAP_COMPRESS)
    shards: int = 1         # serve workers per node (1 = single loop)
    engine: str = "cpu"     # cpu | torch | torch-resident
    device: str = "cuda"    # the card engines' device ("cpu" in the CPU
    #                         tests; never a fallback).  Not in the name.
    aof: Optional[str] = None  # durable op log fsync policy:
    #                            "always" | "everysec" | "no"; None =
    #                            off.  AOF cells grow kill9_mid_write +
    #                            torn_write steps — cold restarts that
    #                            recover from the node's OWN log.
    ckpt: bool = False      # crash-mid-checkpoint steps:
    #                         fault-inject each rewrite interleaving
    #                         (generation switch / snapshot / meta
    #                         commit), kill -9, certify the replay
    cluster: str = ""       # cluster-mode cell name: when
    #                         set, the cell runs a hash-slot migration
    #                         scenario (cluster_cells.CLUSTER_CELLS)
    #                         instead of the replication matrix — two
    #                         slot groups, no inter-group repl links,
    #                         the other knobs above do not apply
    tracking: str = ""      # tracking cell name: when set,
    #                         the cell drives a real NearCacheClient
    #                         through a fault-injected storm
    #                         (tracking_cells.TRACKING_CELLS) and
    #                         certifies the zero-stale law instead of
    #                         running the replication matrix

    @property
    def name(self) -> str:
        return (f"wire{int(self.wire)}-delta{int(self.delta)}"
                f"-comp{int(self.compress)}"
                f"-shards{self.shards}-{self.engine}"
                + (f"-aof-{self.aof}" if self.aof else "")
                + ("-ckpt" if self.ckpt else "")
                + (f"-cluster-{self.cluster}" if self.cluster else "")
                + (f"-{self.tracking}" if self.tracking else ""))

    def specs(self, n: int = 3, mixed_idx: Optional[int] = None
              ) -> list[NodeSpec]:
        """Node configs for this cell.  `mixed_idx` plays the
        mixed-version peer: wire batching, delta sync, and compression
        OFF, so its handshakes advertise none of the capabilities and
        every stream it touches must negotiate down correctly.
        Compression cells lower the payload floor so the scripted
        bursts' REPLBATCH frames actually compress — the corrupt
        one-shot then hits a COMPRESSED payload, certifying the
        compression-demotion law, not just the batch codec's."""
        out = []
        for i in range(n):
            if i == mixed_idx:
                out.append(NodeSpec(engine="cpu", wire_batch=1,
                                    delta_sync=False,
                                    wire_compress=False,
                                    aof=self.aof))
            else:
                out.append(NodeSpec(
                    engine=self.engine, device=self.device,
                    wire_batch=None if self.wire else 1,
                    delta_sync=None if self.delta else False,
                    wire_compress=None if self.compress else False,
                    serve_shards=self.shards,
                    aof=self.aof,
                    extra={"wire_compress_min": 64}
                    if self.compress else {}))
        return out


def matrix_cells(device: str = "cuda") -> list[Cell]:
    """The full capability sweep, the card engines' cells on `device`.
    Sharded cells collapse the wire dimension (a shard-per-core receiver
    never advertises CAP_BATCH_STREAM, and in an all-sharded mesh nobody
    does) and pin the worker engine (serve workers run the cpu spec);
    compression defaults ON across the sweep — every wire cell's
    corrupt-REPLBATCH shot then hits a compressed payload — with
    dedicated compress-OFF cells on the cpu engine pinning the plain
    negotiation both with and without the batch wire."""
    cells = []
    for engine in ("cpu", "torch", "torch-resident"):
        for wire in (True, False):
            for delta in (True, False):
                cells.append(Cell(wire=wire, delta=delta, shards=1,
                                  engine=engine))
    cells.append(Cell(wire=True, delta=True, compress=False,
                      engine="cpu"))
    cells.append(Cell(wire=False, delta=False, compress=False,
                      engine="cpu"))
    for delta in (True, False):
        cells.append(Cell(wire=False, delta=delta, shards=2,
                          engine="cpu"))
    # durability cells: every AOF cell adds kill9_mid_write +
    # torn_write cold restarts recovering from the node's own log.
    # `always` carries the zero-acked-loss law; `everysec` certifies
    # the weaker contract (durable-prefix recovery + re-convergence);
    # one sharded cell drives the per-shard segment merge.
    cells.append(Cell(aof="always"))
    cells.append(Cell(aof="everysec"))
    cells.append(Cell(wire=False, delta=False, compress=False,
                      aof="always"))
    cells.append(Cell(wire=False, shards=2, aof="always"))
    # crash-mid-checkpoint: the incremental-checkpoint cut must be
    # idempotent at every fault interleaving
    cells.append(Cell(aof="always", ckpt=True))
    # cluster mode: slot migration under partition, the ownership
    # flap, and deletes landing mid-move (cluster_cells.py)
    from .cluster_cells import CLUSTER_CELLS
    cells.extend(Cell(cluster=c) for c in CLUSTER_CELLS)
    # client-assisted caching: the near-cache invalidation laws under
    # replication, partitions, connection kills, and slot migration
    # (tracking_cells.py)
    from .tracking_cells import TRACKING_CELLS
    cells.extend(Cell(tracking=t) for t in TRACKING_CELLS)
    return [replace(c, device=device) for c in cells]


def smoke_cells(device: str = "cuda") -> list[Cell]:
    """One representative cell per negotiated fast path (the CLI's
    default set), the card engine's cell on `device`: everything-on
    (compression included — its corrupt shot hits a compressed
    REPLBATCH), everything-off (pure legacy paths, plain bytes end to
    end), the resident engine, and the sharded serving plane."""
    cells = [Cell(), Cell(wire=False, delta=False, compress=False),
             Cell(engine="torch-resident"), Cell(shards=2, wire=False),
             Cell(aof="always", ckpt=True), Cell(aof="everysec"),
             Cell(cluster="migrate-partition"),
             Cell(tracking="track-partition")]
    return [replace(c, device=device) for c in cells]


@dataclass
class Scenario:
    seed: int
    cell: Cell = field(default_factory=Cell)
    steps: list = field(default_factory=list)
    n_nodes: int = 3
    mixed_idx: Optional[int] = 2   # which node plays the legacy peer
    ops_per_burst: int = 30
    converge_timeout: float = 45.0

    @property
    def name(self) -> str:
        return f"seed={self.seed} cell={self.cell.name}"


def certify_scenario(seed: int, cell: Optional[Cell] = None,
                     ops: int = 30) -> Scenario:
    """The acceptance schedule (see module docstring).  Node 2 is the
    mixed-version peer; faults target the 0<->1 edge (both fast-path
    nodes) and the mesh around node 2."""
    cell = cell if cell is not None else Cell()
    steps = [
        ("ops", ops),
        # frame-level chaos on the fast-path edge: delay + reorder + dup
        ("faults", 0, 1, dict(delay=(0.0005, 0.004), reorder=0.25,
                              dup=0.25)),
        ("ops", ops * 2),
        # cached reads racing the faulted replication stream: planned +
        # cached replies must match the per-command reference exactly
        ("cached_reads", 0),
        ("clear_faults",),
    ]
    if cell.wire and cell.shards == 1:
        # a corrupt REPLBATCH payload must demote LOUDLY.  Injected on a
        # CALM edge (after clear_faults) and VERIFIED with bounded
        # retries ("corrupt_burst"): a consumed one-shot can still be
        # legitimately discarded WITH a dying connection (transport
        # fate-sharing — e.g. the double-dial adopt overlap closes the
        # stream the corrupted frame was written to), in which case the
        # clean redelivery is correct behavior and no demotion exists to
        # count.  The law being certified is decode-fails-loudly
        # whenever a corrupt payload REACHES a live parser — so the
        # step re-arms and re-bursts until one does (the burst runs on
        # node 0 ONLY, so its serve path logs a consecutive encodable
        # run and the 0->1 push loop group-encodes a REPLBATCH for the
        # one-shot to hit; the certify step asserts a demotion really
        # landed).
        steps += [("corrupt_burst", 0, 1, 24), ("ops", ops // 2)]
    steps += [
        # no-resurrection probe setup: the member exists mesh-wide
        # BEFORE the partition...
        ("probe_setup",),
        ("partition", 0, 2, dict(sym=False, kill=False)),  # asymmetric
        ("ops", ops),
        ("heal",),
        # ...then node 2 is FULLY isolated (both edges, connections
        # killed), the member is retired on the majority side, and node
        # 2 keeps writing — after the heal the removal must win
        # everywhere and the member must never resurrect
        ("partition", 0, 2, dict(sym=True, kill=True)),
        ("partition", 1, 2, dict(sym=True, kill=True)),
        ("probe_retire",),
        ("ops", ops),
        ("heal",),
        # mid-stream violence on a live edge
        ("truncate", 0, 1),
        ("ops", ops // 2),
        ("kill_conns", 0, 1),
        ("ops", ops // 2),
        # process deaths: cold loses everything in memory, warm loses
        # only connections
        ("crash", 1, "cold"),
        ("ops", ops),
        ("crash", 0, "warm"),
        ("ops", ops // 2),
        # clock jitter: a leap ahead, writes, a step BACK, writes
        ("clock_jump", 2, 30_000),
        ("ops", ops // 2),
        ("clock_jump", 2, -20_000),
        ("ops", ops // 2),
        # the read plane again after crashes + clock jitter (node 1 was
        # cold-restarted above — its cache refilled from recovered state)
        ("cached_reads", 1),
    ]
    if cell.aof:
        # durability primitives: kill -9 mid-firehose and a
        # torn-tail power loss, each followed by a cold restart that
        # recovers from the node's OWN op log (no harness-side dump).
        # The oracle then certifies that every fsync-acknowledged write
        # survived and the mesh re-converged byte-identically — the
        # never-durable suffix is pruned from the journal obligation
        # under the emit-only-durable law (cluster.kill9).
        steps += [
            ("kill9_mid_write", 0),
            ("ops", ops),
            ("torn_write", 1),
            ("ops", ops),
        ]
        if cell.ckpt:
            # crash-mid-checkpoint: each fault interleaving
            # of the rewrite's commit sequence leaves a different disk
            # state (new gen open / base written / meta committed with
            # the old generations still on disk) — all must cold-replay
            # to the same bytes
            for stage in ("switch", "snapshot", "meta"):
                steps += [("ckpt_crash", 0, stage), ("ops", ops // 2)]
    steps += [("certify",)]
    return Scenario(seed=seed, cell=cell, steps=steps,
                    ops_per_burst=ops)


def soak_scenario(seed: int, rounds: int = 12, ops: int = 80) -> Scenario:
    """Randomized soak: `rounds` bursts with seeded fault events drawn
    between them, always ending in the full oracle.  The schedule is a
    pure function of `seed` — rebuild with the printed seed to replay."""
    rng = random.Random(seed ^ 0x5EEDFA17)
    steps: list = [("ops", ops)]
    partitioned = False
    for _ in range(rounds):
        roll = rng.random()
        if roll < 0.18 and not partitioned:
            a, b = rng.sample(range(3), 2)
            steps.append(("partition", a, b,
                          dict(sym=rng.random() < 0.7,
                               kill=rng.random() < 0.7)))
            partitioned = True
        elif roll < 0.30 and partitioned:
            steps.append(("heal",))
            partitioned = False
        elif roll < 0.45:
            a, b = rng.sample(range(3), 2)
            steps.append(("faults", a, b,
                          dict(delay=(0.0002, 0.003),
                               reorder=rng.choice((0.0, 0.2, 0.4)),
                               dup=rng.choice((0.0, 0.2, 0.4)))))
        elif roll < 0.55:
            steps.append(("clear_faults",))
        elif roll < 0.65:
            a, b = rng.sample(range(3), 2)
            steps.append(("kill_conns", a, b))
        elif roll < 0.72:
            a, b = rng.sample(range(3), 2)
            steps.append(("truncate", a, b))
        elif roll < 0.85:
            steps.append(("crash", rng.randrange(3),
                          rng.choice(("cold", "warm"))))
        else:
            steps.append(("clock_jump", rng.randrange(3),
                          rng.choice((-15_000, 10_000, 45_000))))
        steps.append(("ops", ops))
    if partitioned:
        steps.append(("heal",))
    steps += [("ops", ops), ("certify",)]
    return Scenario(seed=seed, steps=steps, ops_per_burst=ops,
                    converge_timeout=90.0)


# ---------------------------------------------------------------- workload


class _Workload:
    """Seeded op generator with the bookkeeping the oracle probes need.

    The mix sticks to rewrites that are pure pointwise merges (the
    journal-replay reference is then exact under ANY delivery order):
    counter steps + CNTUNDO, register set/del, set add/remove, hash set.
    Deleted register keys are per-node-exclusive and never rewritten, so
    "retired stays dead" is a mesh invariant, not a race."""

    def __init__(self, seed: int, n_nodes: int) -> None:
        self.rng = random.Random(seed ^ 0xC4A05)
        self.n = n_nodes
        self.serial = 0
        self.retired_regs: list[bytes] = []
        # per-node keys with at least one undoable local counter op
        self.undoable: list[dict[str, int]] = [dict()
                                               for _ in range(n_nodes)]

    def clear_undo(self, i: int) -> None:
        self.undoable[i].clear()  # a cold restart loses the undo log

    async def pipelined_writes(self, cluster: ChaosCluster, i: int,
                               n: int) -> None:
        """One pipelined chunk of `n` writes on node `i`: the serve
        coalescer logs them as one run, so the push loops drain a
        CONSECUTIVE encodable run — the shape REPLBATCH group-encoding
        (and the corrupt_wire one-shot) needs; a request-response burst
        trickles single entries that ship per-frame."""
        from ..resp.codec import encode_msg
        from ..resp.message import Arr, Bulk
        c = await Client().connect(cluster.apps[i].advertised_addr)
        try:
            buf = bytearray()
            for j in range(n):
                self.serial += 1
                buf += encode_msg(Arr([
                    Bulk(b"set"), Bulk(b"wire%d" % (j % 8)),
                    Bulk(b"v%d" % self.serial)]))
            c.writer.write(bytes(buf))
            await c.writer.drain()
            got = 0
            while got < n:  # all n replies = the whole chunk landed
                if c.parser.next_msg() is not None:
                    got += 1
                    continue
                data = await asyncio.wait_for(c.reader.read(1 << 16),
                                              10.0)
                if not data:
                    raise ConnectionError("EOF mid-pipeline")
                c.parser.feed(data)
        finally:
            await c.close()

    def cached_read_check(self, cluster: ChaosCluster, i: int) -> None:
        """The read-plane smoke under chaos: one coalesced read chunk
        (planned batch + versioned reply cache, server/serve.py) vs the
        per-command reference on the SAME node with no await between
        the passes — both observe identical state, so any byte
        difference is a stale cached serve, a FAILURE, not a race.
        Runs twice so the second pass actually hits entries the first
        one filled (entries surviving earlier replication intake are
        exactly what the invalidation laws must have dropped).  Sharded
        nodes skip (their data lives in the workers).  On a card
        engine both passes read through the resident planes' barrier
        path."""
        node = cluster.apps[i].node
        if node.serve_plane is not None:
            return
        from ..resp.codec import encode_into
        from ..resp.message import Arr, Bulk, NoReply
        from ..server.serve import ServeCoalescer
        msgs = [Arr([Bulk(b"get"), Bulk(b"wire%d" % j)])
                for j in range(8)]
        msgs += [Arr([Bulk(b"smembers"), Bulk(b"probe:s")]),
                 Arr([Bulk(b"scnt"), Bulk(b"probe:s")]),
                 Arr([Bulk(b"sismember"), Bulk(b"probe:s"),
                      Bulk(b"probe-member")])]
        coal = ServeCoalescer(node)
        for _ in range(2):
            out = bytearray()
            coal.run_chunk(list(msgs), out)
            ref = bytearray()
            for m in msgs:
                r = node.execute(m)
                if not isinstance(r, NoReply):
                    encode_into(ref, r)
            if bytes(out) != bytes(ref):
                raise AssertionError(
                    f"node {i}: cached/planned read replies diverged "
                    f"from the per-command reference (stale serve)")

    async def burst(self, cluster: ChaosCluster, n_ops: int,
                    only: Optional[set] = None) -> None:
        rng = self.rng
        live = [i for i in range(len(cluster.apps))
                if cluster.apps[i] is not None
                and (only is None or i in only)]
        clients = {}
        try:
            for i in live:
                clients[i] = await Client().connect(
                    cluster.apps[i].advertised_addr)
            for _ in range(n_ops):
                i = rng.choice(live)
                c = clients[i]
                self.serial += 1
                die = rng.random()
                if die < 0.30:
                    k = f"cnt{rng.randrange(6)}"
                    r = await c.cmd(rng.choice(("incr", "decr")), k,
                                    rng.randrange(1, 4))
                    assert isinstance(r, Int), r
                    self.undoable[i][k] = self.undoable[i].get(k, 0) + 1
                elif die < 0.40 and self.undoable[i]:
                    k = rng.choice(sorted(self.undoable[i]))
                    r = await c.cmd("cntundo", k)
                    # an Err here is a real bug: the tracker only names
                    # keys with a recorded, not-yet-undone local op
                    assert isinstance(r, Int), (k, r)
                    left = self.undoable[i][k] - 1
                    if left:
                        self.undoable[i][k] = left
                    else:
                        del self.undoable[i][k]
                elif die < 0.60:
                    await c.cmd("set", f"reg{rng.randrange(8)}",
                                f"v{self.serial}")
                elif die < 0.75:
                    await c.cmd("sadd", f"set{rng.randrange(6)}",
                                f"m{self.serial % 40}")
                elif die < 0.85:
                    k = f"set{rng.randrange(6)}"
                    # pick drawn UNCONDITIONALLY: the rng stream must not
                    # depend on the reply, or a replay whose timing
                    # shifts one membership view would desync the whole
                    # remaining schedule from its seed
                    pick = rng.random()
                    got = await c.cmd("smembers", k)
                    if isinstance(got, Arr) and got.items:
                        ms = sorted(b.val for b in got.items)
                        await c.cmd("srem", k, ms[int(pick * len(ms))])
                elif die < 0.95:
                    await c.cmd("hset", f"h{rng.randrange(4)}",
                                f"f{rng.randrange(6)}", f"v{self.serial}")
                else:
                    # retire a per-node-exclusive register: set + del on
                    # the same node, never touched again
                    k = f"dead:{i}:{self.serial}".encode()
                    await c.cmd("set", k, "doomed")
                    r = await c.cmd("del", k)
                    assert r == Int(1), (k, r)
                    self.retired_regs.append(k)
        finally:
            for c in clients.values():
                await c.close()


# ------------------------------------------------------------------ runner


async def _corrupt_burst(sc: Scenario, cluster: ChaosCluster, plane,
                         wl: "_Workload", src: int, dst: int,
                         n: int, retries: int = 6) -> None:
    """Arm the REPLBATCH corruption one-shot on src->dst and drive a
    pipelined burst until a demotion is OBSERVED (bounded retries).  A
    consumed injection whose carrying connection died before delivery
    (fate-sharing — e.g. the double-dial adopt overlap) is re-armed and
    re-tried; an injection that reaches a live parser must demote
    within the wait window or the scenario fails loudly."""
    loop = asyncio.get_running_loop()
    demos0 = cluster.stat_total("repl_wire_demotions")
    for _attempt in range(retries):
        plane.corrupt_next_wire(src, dst)
        await wl.pipelined_writes(cluster, src, n)
        deadline = loop.time() + 3.0
        while loop.time() < deadline:
            if cluster.stat_total("repl_wire_demotions") > demos0:
                return
            await asyncio.sleep(0.05)
        # not observed: either the one-shot is still ARMED (no
        # REPLBATCH passed — e.g. the link was mid-resync) or it was
        # consumed and discarded with a dying connection.  Disarm
        # before re-arming so the retry holds exactly one pending shot.
        plane.edge(src, dst).rules.corrupt_next = False
    raise AssertionError(
        f"[chaos {sc.name}] no wire demotion after {retries} corrupt "
        f"bursts — a corrupt payload that reached a live parser was "
        f"swallowed silently")


async def _kill9_mid_write(cluster: ChaosCluster, wl: "_Workload",
                           i: int, torn: bool) -> None:
    """kill -9 (optionally with a torn-tail power loss) while a
    pipelined firehose is mid-flight on node `i`, then cold-restart
    from the node's own op log.  The firehose's unacked suffix dies
    with the connection — exactly the window the durability laws are
    about (cluster.kill9 prunes the never-durable part of the journal
    obligation)."""
    task = asyncio.create_task(wl.pipelined_writes(cluster, i, 96))
    # seeded-but-unconditional draw: the rng stream must not depend on
    # scheduling (scenario replays stay a pure function of the seed)
    await asyncio.sleep(0.004 + wl.rng.random() * 0.02)
    await cluster.kill9(i, torn=torn)
    try:
        await task
    except (ConnectionError, OSError, asyncio.TimeoutError,
            asyncio.IncompleteReadError):
        pass


async def _run_scenario_async(sc: Scenario) -> dict:
    import tempfile

    with tempfile.TemporaryDirectory(prefix="constdb-chaos-") as work:
        plane = FaultPlane(sc.seed)
        journal = OpJournal()
        cluster = ChaosCluster(work, sc.seed,
                               sc.cell.specs(sc.n_nodes, sc.mixed_idx),
                               plane=plane, journal=journal)
        await cluster.start()
        monitor = InvariantMonitor(cluster, journal).start()
        wl = _Workload(sc.seed, sc.n_nodes)
        probe_member = b"probe-member"
        stats: dict = {}
        try:
            await cluster.meet_all()
            await cluster.converge(timeout=20.0)
            for step in sc.steps:
                kind = step[0]
                if kind == "ops":
                    await wl.burst(cluster, step[1])
                elif kind == "ops_on":
                    await wl.burst(cluster, step[2], only={step[1]})
                elif kind == "wire_burst":
                    await wl.pipelined_writes(cluster, step[1], step[2])
                elif kind == "cached_reads":
                    wl.cached_read_check(cluster, step[1])
                elif kind == "corrupt_burst":
                    await _corrupt_burst(sc, cluster, plane, wl,
                                         step[1], step[2], step[3])
                elif kind == "faults":
                    plane.set_faults(step[1], step[2], **step[3])
                elif kind == "clear_faults":
                    plane.clear_faults()
                elif kind == "partition":
                    plane.partition(step[1], step[2], **step[3])
                elif kind == "heal":
                    plane.heal()
                elif kind == "kill_conns":
                    plane.kill_connections(step[1], step[2])
                elif kind == "truncate":
                    plane.truncate_next(step[1], step[2])
                elif kind == "corrupt_wire":
                    plane.corrupt_next_wire(step[1], step[2])
                elif kind == "crash":
                    i = step[1]
                    if step[2] == "cold" or \
                            cluster.apps[i].node.serve_plane is not None:
                        await cluster.restart_cold(i)
                        wl.clear_undo(i)
                    else:
                        await cluster.restart_warm(i)
                elif kind in ("kill9_mid_write", "torn_write"):
                    i = step[1]
                    await _kill9_mid_write(cluster, wl, i,
                                           torn=kind == "torn_write")
                    wl.clear_undo(i)
                elif kind == "ckpt_crash":
                    i = step[1]
                    await cluster.checkpoint_crash(i, step[2])
                    # the restarted process lost its in-memory undo
                    # window (rewrite()'s opening group commit still
                    # makes every acked op durable before the kill)
                    wl.clear_undo(i)
                elif kind == "clock_jump":
                    cluster.clock_jump(step[1], step[2])
                elif kind == "probe_setup":
                    c = await Client().connect(
                        cluster.apps[0].advertised_addr)
                    await c.cmd("sadd", "probe:s", probe_member)
                    await c.close()
                    await cluster.converge(timeout=sc.converge_timeout)
                elif kind == "probe_retire":
                    # retired on node 0 — node 2 is partitioned away and
                    # still holds the member until the heal
                    c = await Client().connect(
                        cluster.apps[0].advertised_addr)
                    await c.cmd("srem", "probe:s", probe_member)
                    await c.close()
                elif kind == "certify":
                    plane.clear_faults()
                    plane.heal()
                    if any(s[0] in ("corrupt_wire", "corrupt_burst")
                           for s in sc.steps):
                        # at least one injection must have HIT a real
                        # REPLBATCH (the targeted bursts guarantee
                        # traffic; retries may consume several)
                        assert plane.stats.get("wire_corruptions", 0) \
                            >= 1, \
                            f"[chaos {sc.name}] wire corruption armed " \
                            f"but never hit a REPLBATCH frame"
                    canon = await certify_state(
                        cluster, journal, timeout=sc.converge_timeout)
                    _check_probes(sc, cluster, wl, canon, probe_member)
                    monitor.check()
                    check_fault_accounting(cluster, plane)
                    stats["canonical_keys"] = len(canon)
                else:
                    raise ValueError(f"unknown scenario step {kind!r}")
            stats["journal_ops"] = len(journal.ops)
            stats["plane"] = dict(plane.stats)
            stats["reconnects"] = sum(
                a.node.stats.repl_reconnects for a in cluster.apps)
            # whole-run gauges the smoke cells assert on: demotions
            # (banked across cold restarts) and the native intake
            # counters — a cell that claims to exercise the C intake
            # stage must show it actually owned client chunks
            stats["wire_demotions"] = \
                cluster.stat_total("repl_wire_demotions")
            stats["native_intake_chunks"] = \
                cluster.stat_total("native_intake_chunks")
            return stats
        except AssertionError:
            raise
        except Exception as e:
            # every failure names the replay seed, whatever its type
            raise AssertionError(
                f"[chaos {sc.name}] scenario crashed: {e!r}") from e
        finally:
            monitor.stop()
            await cluster.close()


def _check_probes(sc: Scenario, cluster, wl: _Workload, canon: dict,
                  probe_member: bytes) -> None:
    """No-resurrection laws over the converged canonical export.  A
    canonical() entry is (enc, ct, mt, dt, expire, content); element
    content rows are (member, add_t, add_node, del_t, val).

    Durability interplay (AOF cells): a kill9/torn crash legally
    ERASES acked-but-never-fsynced ops under `everysec` — the oracle
    prunes them from the journal obligation (emit-only-durable) and
    the mesh converges WITHOUT them.  A retired key whose DELETE op no
    longer exists in the journal is therefore legitimately live again
    (the delete never durably happened); the law being probed —
    nothing resurrects a delete that still EXISTS — only applies while
    the journal holds it.  `certify_state` (which already ran) pins
    the canonical to the pruned journal either way."""
    def journal_has(name: bytes, key: bytes) -> bool:
        j = cluster.journal
        if j is None:
            return True
        return any(n == name and a and getattr(a[0], "val", None) == key
                   for (_o, _u), (n, a) in j.ops.items())

    for key in wl.retired_regs:
        ent = canon.get(key)
        if ent is not None and not ent[1] < ent[3] and \
                not journal_has(b"delbytes", key):
            continue  # the delete was crash-erased before any fsync
        assert ent is None or ent[1] < ent[3], \
            f"[chaos {sc.name}] retired key {key!r} resurrected: {ent}"
    s = canon.get(b"probe:s")
    if s is not None:
        members = {m for m, _at, _an, dlt, _v in s[5] if dlt == 0}
        assert probe_member not in members or \
            not journal_has(b"srem", b"probe:s"), \
            f"[chaos {sc.name}] removed member resurrected after " \
            f"partition heal: {sorted(members)}"


def run_scenario(sc: Scenario) -> dict:
    """Run one scenario to completion (sync wrapper; prints nothing —
    every failure message carries `[chaos seed=N …]`)."""
    if sc.cell.cluster:
        from .cluster_cells import run_cluster_cell
        return run_cluster_cell(sc.cell.cluster, sc.seed,
                                ops=sc.ops_per_burst)
    if sc.cell.tracking:
        from .tracking_cells import run_tracking_cell
        return run_tracking_cell(sc.cell.tracking, sc.seed,
                                 ops=sc.ops_per_burst)
    return asyncio.run(_run_scenario_async(sc))


# re-exported for the CLI and tests
__all__ = ["Cell", "Scenario", "certify_scenario", "soak_scenario",
           "matrix_cells", "smoke_cells", "run_scenario"]
