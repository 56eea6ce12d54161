"""The chaos invariant oracle: journal, reference export, continuous
monitor, and post-convergence laws.

The oracle is grounded in Certified Mergeable Replicated Data Types
(PAPERS.md, arXiv 2203.14518): instead of asserting ad-hoc end states,
it replays each family's MERGE LAWS as executable properties over the
real system under faults —

  convergence      every node's canonical export equals the CPU-engine
                   reference built by replaying the journaled origin
                   streams (any delivery order of commuting rewrites is
                   a valid merge order, so the uuid-sorted replay IS the
                   certified reference)
  monotonicity     per-link watermarks (uuid_he_sent) and REPLACK/beacon
                   progress (uuid_i_acked, uuid_he_acked) never regress
                   within a node incarnation — checked CONTINUOUSLY
                   while faults are live, not just at quiesce
  digest agreement post-convergence, every node's anti-entropy digest
                   matrix is identical (the delta-resync layer and the
                   store agree on what "same state" means)
  no resurrection  keys/members retired before a partition stay dead
                   after it heals (scenario.py drives the probes)
  loud accounting  INFO demotion/refusal/reconnect gauges match the
                   faults the plane actually injected — a silently
                   swallowed fault is itself a failure

The port's copy.  The reference node is built on the port's
CpuMergeEngine by name (a Node with no engine would be a card node), so
card nodes are always certified against the CPU engine.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..engine.cpu import CpuMergeEngine
from ..server.node import Node


class OpJournal:
    """Tap on every node's ORIGIN stream (ReplLog.on_append): the exact
    (origin, uuid, rewrite) set the mesh is obligated to converge on.
    The ring itself evicts, so only a tap taken at append time can
    reconstruct the obligation after a long run."""

    def __init__(self) -> None:
        # (origin_node_id, uuid) -> (name, args); uuids can collide
        # ACROSS origins (two nodes minting in the same millisecond)
        self.ops: dict[tuple[int, int], tuple] = {}

    def hook_node(self, node: Node) -> None:
        """(Re-)install the tap on `node`'s repl log — every segment of
        a sharded node's MergedReplLog, the single ring otherwise.
        Idempotent; the monitor re-installs each poll so a log swapped
        by reset_for_full_resync is re-tapped within one tick."""
        rl = node.repl_log
        logs = rl.segments if hasattr(rl, "segments") else [rl]
        for lg in logs:
            lg.on_append = \
                lambda uuid, name, args, _n=node: self._record(
                    _n.node_id, uuid, name, args)

    def _record(self, origin: int, uuid: int, name: bytes,
                args: list) -> None:
        self.ops.setdefault((origin, uuid), (name, args))

    def prune_origin(self, origin: int, above: int) -> int:
        """Drop `origin`'s journaled ops with uuid > `above` — the
        kill9/torn-write accounting: ops a crashed node appended but
        never made durable were, by the emit-only-durable law
        (persist/oplog.py), never advertised to any peer either, so
        they cease to exist mesh-wide and leave the convergence
        obligation.  `above` is the crashed node's recovered local
        watermark; anything it DID recover (or ever emitted) is at or
        below it and stays in the obligation.  Returns the count."""
        dead = [k for k in self.ops if k[0] == origin and k[1] > above]
        for k in dead:
            del self.ops[k]
        return len(dead)

    def reference_canonical(self, collected: bool = False) -> dict:
        """The certified reference: a fresh CPU-engine node applying
        every journaled rewrite through the REAL per-key apply path, in
        (uuid, origin) order.  The scenario workload is restricted to
        rewrites that are pure pointwise merges (set/cntset/sadd/srem/
        hset/hdel/delbytes/delcnt/…), for which every delivery order —
        including this one — is a merge order, so the reference is the
        unique fixpoint all replicas must hit.  `collected=True`
        additionally drains the reference's own GC to its
        everything-applied horizon — the state a quiesced, fully-acked
        mesh must land on."""
        ref = Node(node_id=(1 << 30) + 7, alias="oracle",
                   engine=CpuMergeEngine())
        for (origin, uuid), (name, args) in sorted(self.ops.items(),
                                                   key=lambda kv:
                                                   (kv[0][1], kv[0][0])):
            if name in (b"meet", b"forget"):
                # membership is mesh infrastructure, not keyspace state
                # — and replaying it would give the reference live peers
                # with zero watermarks, pinning its GC horizon at 0
                continue
            ref.apply_replicated(name, args, origin, uuid)
        if collected:
            for _ in range(64):
                ref.gc()
                if not ref.ks.garbage:
                    break
        return ref.canonical()


class InvariantMonitor:
    """Continuous watermark/beacon monotonicity over a live cluster.

    Samples every live node's per-peer watermarks on a short period and
    records any REGRESSION as a violation.  Baselines key on (node,
    incarnation, reset epoch, peer): a cold restart legally rewinds a
    node to its snapshot's watermarks and a state wipe legally zeroes
    them — within one incarnation, going backward is a lost-op bug of
    exactly the kind the round-5 chaos suite once caught in the push
    cursor."""

    def __init__(self, cluster, journal: Optional[OpJournal] = None,
                 period: float = 0.05) -> None:
        self.cluster = cluster
        self.journal = journal
        self.period = period
        self.violations: list[str] = []
        self._seen: dict[tuple, dict] = {}
        self._task: Optional[asyncio.Task] = None

    # one poll is cheap (attribute reads), so the monitor runs at fault
    # cadence without perturbing the system under test

    def poll_once(self) -> None:
        cluster = self.cluster
        for i, app in enumerate(cluster.apps):
            if app is None or app._closing:
                continue
            node = app.node
            inc = cluster.incarnations[i]
            for addr, m in list(node.replicas.peers.items()):
                key = (i, inc, node.reset_epoch, addr)
                cur = {"he_sent": m.uuid_he_sent,
                       "i_acked": m.uuid_i_acked,
                       "he_acked": m.uuid_he_acked}
                prev = self._seen.get(key)
                if prev is not None:
                    for name, v in cur.items():
                        if v < prev[name]:
                            self.violations.append(
                                f"node {i} peer {addr}: {name} regressed "
                                f"{prev[name]} -> {v} (incarnation {inc},"
                                f" epoch {node.reset_epoch})")
                self._seen[key] = cur
            if self.journal is not None:
                self.journal.hook_node(node)

    async def _run(self) -> None:
        while True:
            self.poll_once()
            await asyncio.sleep(self.period)

    def start(self) -> "InvariantMonitor":
        self._task = asyncio.create_task(self._run())
        return self

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def check(self) -> None:
        self.poll_once()
        if self.violations:
            raise AssertionError(
                f"[chaos seed={self.cluster.seed}] watermark/beacon "
                f"monotonicity violated: {self.violations[:5]}"
                + (f" (+{len(self.violations) - 5} more)"
                   if len(self.violations) > 5 else ""))


async def certify_state(cluster, journal: OpJournal,
                        timeout: float = 30.0) -> dict:
    """The quiesce-time oracle, as one fixpoint: every node must reach
    the CPU-engine reference's canonical export BYTE-identically, every
    pair of digest matrices must agree, and every garbage heap must
    DRAIN (with the mesh quiesced and every stream acked, the GC
    horizon passes every tombstone — collection must really run, not
    merely defer).  GC progress is intentionally part of the fixpoint:
    replicas legally collect at different times, so digests/canonicals
    are only comparable once collection has quiesced on both sides of
    each comparison — including the reference, which collects its own
    tombstones to the same everything-acked horizon."""
    import numpy as np

    await cluster.converge(timeout=timeout)
    ref = journal.reference_canonical(collected=True)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    why = "?"
    while True:
        pending = 0
        for app in cluster.apps:
            plane = app.node.serve_plane
            if plane is not None:
                await plane.gc(app.node.gc_horizon())
            else:
                app.node.gc()
                pending += len(app.node.ks.garbage)
        if pending:
            why = f"{pending} tombstones still pending collection"
        else:
            canons = [await cluster.canonical_of(i)
                      for i in range(len(cluster.apps))]
            bad = [i for i, c in enumerate(canons) if c != ref]
            if bad:
                diff = {k for k in set(canons[bad[0]]) | set(ref)
                        if canons[bad[0]].get(k) != ref.get(k)}
                why = (f"nodes {bad} diverge from the CPU-engine "
                       f"reference: {len(diff)} keys, e.g. "
                       f"{sorted(diff)[:5]}")
            else:
                mats = [await cluster.digest_of(i)
                        for i in range(len(cluster.apps))]
                bad = [i for i, m in enumerate(mats)
                       if not np.array_equal(mats[0], m)]
                if not bad:
                    return ref
                why = f"digest matrices disagree: node 0 vs nodes {bad}"
        if loop.time() > deadline:
            raise AssertionError(
                f"[chaos seed={cluster.seed}] certification never "
                f"reached its fixpoint: {why}")
        await asyncio.sleep(0.2)


def check_fault_accounting(cluster, plane) -> None:
    """Loud-accounting law: what the plane injected must show up in the
    nodes' own gauges — and what it did NOT inject must not.  Counters
    span the whole run: a cold restart banks its node's stats into the
    cluster before discarding them (ChaosCluster.stat_total)."""
    seed = cluster.seed
    demotions = cluster.stat_total("repl_wire_demotions")
    corruptions = plane.stats.get("wire_corruptions", 0)
    if corruptions == 0:
        assert demotions == 0, \
            f"[chaos seed={seed}] {demotions} wire demotions with no " \
            f"injected corruption — the codec is rejecting clean payloads"
    else:
        assert 1 <= demotions <= corruptions, \
            f"[chaos seed={seed}] injected {corruptions} wire " \
            f"corruptions but counted {demotions} demotions — a corrupt " \
            f"payload was swallowed silently"
    kills = plane.stats.get("conn_kills", 0) + \
        plane.stats.get("truncations", 0)
    if kills:
        assert cluster.stat_total("repl_reconnects") >= 1, \
            f"[chaos seed={seed}] {kills} injected connection kills but " \
            f"zero reconnects — links are not recovering"
    refused = cluster.stat_total("fullsync_reset_refused")
    assert refused == 0, \
        f"[chaos seed={seed}] {refused} fullsync-reset refusals in a " \
        f"mesh that never excludes peers from the GC horizon"
