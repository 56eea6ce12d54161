"""Cluster-mode chaos cells: slot migration under faults.

A cluster cell is a different animal from the replication matrix cells
(scenario.py): TWO nodes in TWO replication groups — deliberately no
repl link between them (that full-mesh stream is what cluster mode
removes) — splitting the 16384-slot keyspace, with a redirect-following
client driving writes and the migration channel dialed through the
fault plane's connector, so partitions hit it like any repl link.

Cells (wired into scenario.matrix_cells / smoke_cells via Cell.cluster):

  migrate-partition  a slot migration is killed mid-protocol by a full
                     partition (connections killed), the mesh keeps
                     serving, and the RETRIED migration must complete
                     and converge — a half-shipped slot never flips
  ownership-flap     a slot migrates A -> B -> A (two epoch bumps);
                     every write before/between/after must land exactly
                     once in the final owner's state
  no-resurrection    a key and a set member are deleted WHILE their
                     slots are mid-migration; the deletes must hold on
                     the new owner (the GC pin keeps the tombstones
                     alive across the handoff)

Oracle: each group's canonical export, filtered to its OWNED slots,
must equal the journal-replay reference exactly (scenario.py's
certified-MRDT argument, per slot group), and every node's per-slot
digest for its owned slots must match the reference's.  Failure
messages carry `[chaos cluster:<cell> seed=N]` — the replay handle.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..cluster import slot_of
from ..resp.message import Err, Msg
from .cluster import ChaosCluster, Client, NodeSpec
from .oracle import OpJournal
from .plane import FaultPlane

CLUSTER_CELLS = ("migrate-partition", "ownership-flap", "no-resurrection")


class RedirectClient:
    """Follows MOVED/ASK redirects, one live connection per address."""

    def __init__(self) -> None:
        self.conns: dict[str, Client] = {}
        self.redirects = 0

    async def _conn(self, addr: str) -> Client:
        c = self.conns.get(addr)
        if c is None:
            c = await Client().connect(addr)
            self.conns[addr] = c
        return c

    async def cmd(self, addr: str, *parts) -> Msg:
        for _hop in range(6):
            try:
                r = await (await self._conn(addr)).cmd(*parts)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                self.conns.pop(addr, None)
                raise
            if isinstance(r, Err) and \
                    r.val.startswith((b"MOVED ", b"ASK ")):
                addr = r.val.split()[2].decode()
                self.redirects += 1
                continue
            return r
        raise AssertionError(f"redirect loop at {addr}: {parts[:2]}")

    async def close(self) -> None:
        for c in self.conns.values():
            await c.close()
        self.conns.clear()


def _specs() -> list[NodeSpec]:
    """Two single-node groups splitting the slot space evenly."""
    return [NodeSpec(engine="cpu",
                     extra={"cluster": True, "slot_groups": 2,
                            "cluster_group": g})
            for g in range(2)]


async def _seed_addrs(cluster: ChaosCluster) -> None:
    """Each node learns the OTHER group's address (one MEET-style
    seeding per node; adopt() merges addresses from then on)."""
    for i, other in ((0, 1), (1, 0)):
        c = await Client().connect(cluster.apps[i].advertised_addr)
        try:
            await c.cmd("cluster", "setaddr", other,
                        cluster.apps[other].advertised_addr)
        finally:
            await c.close()


def _owned_keys(prefix: str, gid: int, n: int, *, suffix: bytes = b"",
                avoid: Optional[set] = None) -> list[bytes]:
    """`n` distinct keys whose FULL name (prefix+i+suffix) hashes to a
    slot the even 2-group split assigns to `gid` (group 0 owns slots
    [0, 8192)), skipping slots in `avoid`."""
    out, j = [], 0
    while len(out) < n:
        k = f"{prefix}{j}".encode() + suffix
        s = slot_of(k)
        if (s < 8192) == (gid == 0) and (avoid is None or s not in avoid):
            out.append(k)
            if avoid is not None:
                avoid.add(s)
        j += 1
    return out


async def _burst(rc: RedirectClient, cluster: ChaosCluster, keys, serial,
                 n: int) -> int:
    """`n` mixed writes over `keys`, all entered at node 0 (redirects
    find the owner); returns the advanced serial."""
    addr = cluster.apps[0].advertised_addr
    for i in range(n):
        k = keys[i % len(keys)]
        serial += 1
        if i % 3 == 0:
            r = await rc.cmd(addr, b"sadd", k + b":s",
                             b"m%d" % (serial % 16))
        elif i % 3 == 1:
            r = await rc.cmd(addr, b"hset", k + b":h",
                             b"f%d" % (serial % 4), b"v%d" % serial)
        else:
            r = await rc.cmd(addr, b"set", k, b"v%d" % serial)
        assert not isinstance(r, Err), (k, r)
    return serial


async def _migrate(cluster: ChaosCluster, src: int, slot: int,
                   target_addr: str, timeout: float = 10.0) -> bool:
    """Drive `CLUSTER MIGRATE` over the admin plane and wait for the
    flip (or the attempt's clean death).  True iff ownership flipped."""
    c = await Client().connect(cluster.apps[src].advertised_addr)
    try:
        r = await c.cmd("cluster", "migrate", slot, slot + 1, target_addr)
        assert not isinstance(r, Err), r
    finally:
        await c.close()
    cl = cluster.apps[src].node.cluster
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if not cl.owns(slot):
            return True
        if not cl.migrating and not cl._tasks:
            return not cl.owns(slot)  # attempt died cleanly
        await asyncio.sleep(0.02)
    return not cl.owns(slot)


async def _drain_gc(cluster: ChaosCluster, tag: str,
                    timeout: float = 10.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        pending = 0
        for app in cluster.apps:
            app.node.gc()
            pending += len(app.node.ks.garbage)
        if not pending:
            return
        if loop.time() > deadline:
            raise AssertionError(
                f"{tag} {pending} tombstones never collected after the "
                f"migrations settled — a stale GC pin survived a handoff")
        await asyncio.sleep(0.05)


async def _certify(tag: str, cluster: ChaosCluster,
                   journal: OpJournal) -> dict:
    """The cluster oracle (module docstring): per-owned-slot canonical
    equality against the journal reference + per-slot digest agreement.
    One replay builds both the reference canonical and its digests."""
    from ..cluster.slots import SLOT_FANOUT, SLOT_LEAVES, bucket_of_slot
    from ..engine.cpu import CpuMergeEngine
    from ..server.node import Node
    from ..store.digest import state_digest_matrix

    await _drain_gc(cluster, tag)
    ref = Node(node_id=(1 << 30) + 9, alias="cluster-oracle",
               engine=CpuMergeEngine())
    for (origin, uuid), (name, args) in sorted(
            journal.ops.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        if name in (b"meet", b"forget"):
            continue
        ref.apply_replicated(name, args, origin, uuid)
    for _ in range(64):
        ref.gc()
        if not ref.ks.garbage:
            break
    ref_canon = ref.canonical()

    tables = [a.node.cluster.table for a in cluster.apps]
    assert all(t.serialize() == tables[0].serialize() for t in tables), \
        f"{tag} slot tables diverged after the run: " \
        f"epochs {[t.epoch for t in tables]}"
    canons = [await cluster.canonical_of(i)
              for i in range(len(cluster.apps))]
    gids = [a.node.cluster.my_gid for a in cluster.apps]
    for key, ent in ref_canon.items():
        gid = tables[0].owner_of(slot_of(key))
        got = canons[gids.index(gid)].get(key)
        assert got == ent, \
            f"{tag} key {key!r} (slot {slot_of(key)}, group {gid}) " \
            f"diverges from the journal reference: {got} != {ent}"
    # no phantom state: an owner must not hold OWNED-slot keys the
    # reference lacks (a source's stale copy of a MOVED slot is fine —
    # it is no longer the owner — but invented owned state is a bug)
    for i, canon in enumerate(canons):
        for key in canon:
            if tables[0].owner_of(slot_of(key)) == gids[i]:
                assert key in ref_canon, \
                    f"{tag} node {i} holds owned key {key!r} the " \
                    f"journal reference does not"
    # per-slot digest agreement on owned slots, against the reference —
    # the same 64x256 geometry under which slot == digest bucket
    ref.ensure_flushed()
    ref_mat = state_digest_matrix(
        ref.ks, SLOT_FANOUT, SLOT_LEAVES).reshape(-1)
    for i, app in enumerate(cluster.apps):
        app.node.ensure_flushed()
        mat = state_digest_matrix(
            app.node.ks, SLOT_FANOUT, SLOT_LEAVES).reshape(-1)
        bad = [s for s in range(len(ref_mat))
               if tables[0].owner_of(s) == gids[i]
               and int(mat[bucket_of_slot(s)])
               != int(ref_mat[bucket_of_slot(s)])]
        assert not bad, \
            f"{tag} node {i} per-slot digest disagrees with the " \
            f"reference on owned slots {bad[:5]}" \
            + (f" (+{len(bad) - 5})" if len(bad) > 5 else "")
    return {"journal_ops": len(journal.ops), "ref_keys": len(ref_canon)}


async def _run_cell_async(name: str, seed: int, ops: int = 45) -> dict:
    import random
    import tempfile

    assert name in CLUSTER_CELLS, name
    rng = random.Random(seed ^ 0xC1A57E12)
    with tempfile.TemporaryDirectory(prefix="constdb-chaos-cl-") as work:
        plane = FaultPlane(seed)
        journal = OpJournal()
        cluster = ChaosCluster(work, seed, _specs(), plane=plane,
                               journal=journal)
        await cluster.start()
        rc = RedirectClient()
        tag = f"[chaos cluster:{name} seed={seed}]"
        try:
            await _seed_addrs(cluster)
            addr0 = cluster.apps[0].advertised_addr
            addr1 = cluster.apps[1].advertised_addr
            node0, node1 = cluster.apps[0].node, cluster.apps[1].node
            # background keys on both sides of the split, slot-disjoint
            # from the migration subjects so a cell's migrations move
            # exactly the keys it targets
            taken: set = set()
            subjects = _owned_keys("mig", 0, 2, avoid=taken)
            setkey = _owned_keys("mig", 0, 1, suffix=b":s", avoid=taken)[0]
            keys = _owned_keys("ck", 0, 6, avoid=taken) \
                + _owned_keys("ck", 1, 6, avoid=taken)
            serial = await _burst(rc, cluster, keys + subjects, 0, ops)

            if name == "migrate-partition":
                slot = slot_of(subjects[0])
                # slow the migration channel so the kill lands MID-
                # protocol, then cut the edge both ways
                plane.set_faults(0, 1, delay=(0.01, 0.05))
                flip = asyncio.create_task(
                    _migrate(cluster, 0, slot, addr1, timeout=6.0))
                await asyncio.sleep(0.03 + rng.random() * 0.05)
                plane.partition(0, 1, sym=True, kill=True)
                # the mesh keeps serving through the partition (clients
                # are not partitioned from either group — only the
                # inter-group migration channel is)
                serial = await _burst(rc, cluster, keys, serial, ops)
                first = await flip
                plane.heal()
                plane.clear_faults()
                if not first:
                    assert await _migrate(cluster, 0, slot, addr1), \
                        f"{tag} retried migration never completed"
                assert not node0.cluster.owns(slot) \
                    and node1.cluster.owns(slot), f"{tag} no flip"
                serial = await _burst(rc, cluster, keys + subjects,
                                      serial, ops)

            elif name == "ownership-flap":
                slot = slot_of(subjects[0])
                e0 = node0.cluster.epoch
                assert await _migrate(cluster, 0, slot, addr1), \
                    f"{tag} A->B migration failed"
                serial = await _burst(rc, cluster, keys + subjects,
                                      serial, ops)
                assert await _migrate(cluster, 1, slot, addr0), \
                    f"{tag} B->A migration failed"
                assert node0.cluster.owns(slot), \
                    f"{tag} flap did not return the slot to A"
                assert node0.cluster.epoch >= e0 + 2, \
                    f"{tag} flap bumped epoch {e0} -> " \
                    f"{node0.cluster.epoch}, want >= +2"
                serial = await _burst(rc, cluster, keys + subjects,
                                      serial, ops)

            else:  # no-resurrection
                dead = subjects[0]
                r = await rc.cmd(addr0, b"sadd", setkey,
                                 b"doomed", b"keeper")
                assert not isinstance(r, Err), r
                plane.set_faults(0, 1, delay=(0.005, 0.02))
                # delete the string WHILE its slot migrates (direct,
                # ASK-redirected, or just-flipped — all must hold; the
                # GC pin keeps the tombstone exportable)
                flip = asyncio.create_task(_migrate(
                    cluster, 0, slot_of(dead), addr1, timeout=8.0))
                await asyncio.sleep(0.01 + rng.random() * 0.03)
                r = await rc.cmd(addr0, b"del", dead)
                assert not isinstance(r, Err), (dead, r)
                assert await flip, \
                    f"{tag} string migration never completed"
                # and the set member while ITS slot migrates
                flip = asyncio.create_task(_migrate(
                    cluster, 0, slot_of(setkey), addr1, timeout=8.0))
                await asyncio.sleep(0.01 + rng.random() * 0.03)
                r = await rc.cmd(addr0, b"srem", setkey, b"doomed")
                assert not isinstance(r, Err), (setkey, r)
                assert await flip, f"{tag} set migration never completed"
                plane.clear_faults()
                serial = await _burst(rc, cluster, keys, serial, ops)
                canon = await cluster.canonical_of(1)
                ent = canon.get(dead)
                assert ent is None or ent[1] < ent[3], \
                    f"{tag} deleted key {dead!r} resurrected on the " \
                    f"new owner: {ent}"
                s = canon.get(setkey)
                assert s is not None, f"{tag} migrated set vanished"
                live = {m for m, _at, _an, dlt, _v in s[5] if dlt == 0}
                assert b"doomed" not in live and b"keeper" in live, \
                    f"{tag} removed member resurrected (or survivor " \
                    f"lost) across the move: {sorted(live)}"

            assert rc.redirects > 0, \
                f"{tag} the workload never exercised a redirect"
            stats = await _certify(tag, cluster, journal)
            stats["redirects"] = rc.redirects
            stats["epoch"] = node0.cluster.epoch
            stats["migrations"] = (node0.cluster.migrations_out
                                   + node1.cluster.migrations_out)
            stats["serial"] = serial
            return stats
        except AssertionError:
            raise
        except Exception as e:
            raise AssertionError(f"{tag} cell crashed: {e!r}") from e
        finally:
            await rc.close()
            await cluster.close()


def run_cluster_cell(name: str, seed: int, ops: int = 45) -> dict:
    """Sync entry (scenario.run_scenario dispatches here for cells with
    Cell.cluster set)."""
    return asyncio.run(_run_cell_async(name, seed, ops))


__all__ = ["CLUSTER_CELLS", "RedirectClient", "run_cluster_cell"]
