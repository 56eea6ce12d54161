"""Tracking chaos cells: the near-cache invalidation laws under faults.

A tracking cell drives a REAL NearCacheClient (client/near_cache.py)
against a fault-injected mesh: a hot-key storm fills the near-cache
while writers mutate the same keys — locally, through the peer's
replication stream, across partitions, over a killed tracked
connection, and across a cluster slot migration.  The oracle is the
zero-stale law: once the mesh quiesces, EVERY entry the near-cache
would serve must equal the serving node's own answer — a stale cached
read is a failure, not a race.

Cells (wired into scenario.matrix_cells / smoke_cells via
Cell.tracking):

  track-repl-writes   every storm write enters at the PEER: the tracked
                      node's invalidations come exclusively from the
                      replication intake seam
  track-partition     the repl link is cut (connections killed)
                      mid-storm while the peer keeps writing; the heal
                      resync must invalidate everything it lands
  track-conn-kill     the tracked connection is killed server-side
                      while an invalidation push sits in the coalescing
                      window — the frame is LOST; the reconnect-flush
                      law must restore correctness
  track-slot-migration  a slot holding tracked keys migrates away; the
                      adopt-time slots_lost hook must invalidate them
                      (writes now land on the new owner — the one-shot
                      promise could never otherwise be kept)

Failure messages carry `[chaos tracking:<cell> seed=N]` — the replay
handle, like every chaos cell.
"""

from __future__ import annotations

import asyncio

from ..client import NearCacheClient
from ..cluster import slot_of
from ..resp.message import Bulk, Err
from .cluster import ChaosCluster, Client, NodeSpec
from .plane import FaultPlane

TRACKING_CELLS = ("track-repl-writes", "track-partition",
                  "track-conn-kill", "track-slot-migration")

_HOT = [b"hot%d" % i for i in range(8)]


async def _storm(rng, nc: NearCacheClient, writers: list, n: int,
                 serial: int, write_pct: float = 0.1,
                 keys: list = _HOT) -> int:
    """A 90:10 hot-key storm: the tracked client reads hot keys
    (filling its near-cache); writes go through `writers` (plain
    untracked clients — the peers whose mutations owe pushes)."""
    for _ in range(n):
        k = keys[rng.randrange(len(keys))]
        if rng.random() < write_pct:
            serial += 1
            w = writers[rng.randrange(len(writers))]
            r = await w.cmd(b"set", k, b"v%d" % serial)
            assert not isinstance(r, Err), (k, r)
        else:
            r = await nc.get(k)
            assert not isinstance(r, Err), (k, r)
    return serial


async def _quiesce(cluster: ChaosCluster, timeout: float = 20.0) -> None:
    """Replication convergence + a beat for the push coalescing windows
    and the client reader task to drain."""
    await cluster.converge(timeout=timeout)
    await asyncio.sleep(0.1)


async def _assert_zero_stale(tag: str, nc: NearCacheClient,
                             direct: Client, timeout: float = 5.0) -> None:
    """The oracle: every entry the near-cache holds equals the serving
    node's own current answer.  Bounded polling absorbs in-flight push
    frames; entries still stale at the deadline are the failure."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        stale = []
        for k, cached in list(nc.cache.items()):
            truth = await direct.cmd(b"get", k)
            if truth != cached:
                stale.append((k, cached, truth))
        if not stale:
            break
        if loop.time() > deadline:
            raise AssertionError(
                f"{tag} near-cache would serve stale entries after "
                f"quiescence: {stale[:3]}"
                + (f" (+{len(stale) - 3})" if len(stale) > 3 else ""))
        await asyncio.sleep(0.05)
    # and the read path agrees end to end (hits and misses alike)
    for k in _HOT:
        got = await nc.get(k)
        truth = await direct.cmd(b"get", k)
        assert got == truth, \
            f"{tag} tracked read of {k!r} diverges: {got} != {truth}"


async def _repl_pair(work: str, seed: int, plane) -> ChaosCluster:
    cluster = ChaosCluster(work, seed, [NodeSpec(), NodeSpec()],
                           plane=plane)
    await cluster.start()
    await cluster.meet_all()
    await cluster.converge(timeout=20.0)
    return cluster


async def _run_repl_cell(name: str, seed: int, ops: int, rng) -> dict:
    import tempfile

    tag = f"[chaos tracking:{name} seed={seed}]"
    with tempfile.TemporaryDirectory(prefix="constdb-chaos-trk-") as work:
        plane = FaultPlane(seed)
        cluster = await _repl_pair(work, seed, plane)
        node0 = cluster.apps[0].node
        nc = await NearCacheClient(
            cluster.apps[0].advertised_addr).connect()
        local = await Client().connect(cluster.apps[0].advertised_addr)
        peer = await Client().connect(cluster.apps[1].advertised_addr)
        try:
            if name == "track-repl-writes":
                # writes ONLY through the peer: every invalidation at
                # node 0 is born at the replication intake seam
                serial = await _storm(rng, nc, [peer], ops * 4, 0,
                                      write_pct=0.2)
                await _quiesce(cluster)
                await _assert_zero_stale(tag, nc, local)
                assert nc.invalidations > 0, \
                    f"{tag} no push ever invalidated a replicated write"

            elif name == "track-partition":
                serial = await _storm(rng, nc, [local, peer], ops * 2, 0)
                plane.partition(0, 1, sym=True, kill=True)
                # the peer keeps writing into the partition; the
                # tracked client keeps reading node 0's (consistent,
                # merely old) state — near-cache vs node 0 stays exact
                serial = await _storm(rng, nc, [peer], ops * 2, serial,
                                      write_pct=0.3)
                await _assert_zero_stale(tag, nc, local)
                plane.heal()
                # the heal resync lands the peer's writes; the intake
                # taps must invalidate every affected tracked key
                serial = await _storm(rng, nc, [local, peer], ops,
                                      serial)
                await _quiesce(cluster)
                await _assert_zero_stale(tag, nc, local)
                assert nc.invalidations > 0, tag

            else:  # track-conn-kill
                serial = await _storm(rng, nc, [local, peer], ops * 2, 0)
                # park an invalidation in the coalescing window, then
                # kill the tracked connection server-side BEFORE the
                # window flushes: the push frame is lost with the
                # socket
                reg = node0.tracking
                reg.latency_s = 0.5
                victim = _HOT[rng.randrange(len(_HOT))]
                assert await nc.get(victim) is not None
                r = await local.cmd(b"set", victim, b"lost-push")
                assert not isinstance(r, Err), r
                killed = 0
                for conn in list(cluster.apps[0].client_conns.values()):
                    if conn.tracking:
                        conn.writer.transport.abort()
                        killed += 1
                assert killed == 1, f"{tag} tracked conn not found"
                deadline = asyncio.get_running_loop().time() + 5.0
                while nc._connected:
                    assert asyncio.get_running_loop().time() < deadline, \
                        f"{tag} client never noticed the kill"
                    await asyncio.sleep(0.01)
                assert not nc.cache and nc.flushes >= 1, \
                    f"{tag} reconnect-flush law broken: cache survived " \
                    f"the disconnect"
                reg.latency_s = 0.002
                await nc.connect()
                got = await nc.get(victim)
                assert got == Bulk(b"lost-push"), \
                    f"{tag} read after reconnect returned {got}, not " \
                    f"the write whose push was lost"
                serial = await _storm(rng, nc, [local, peer], ops,
                                      serial)
                await _quiesce(cluster)
                await _assert_zero_stale(tag, nc, local)

            stats = {"serial": serial, "nc_hits": nc.hits,
                     "nc_misses": nc.misses,
                     "nc_invalidations": nc.invalidations,
                     "nc_flushes": nc.flushes,
                     "pushes": node0.stats.tracking_pushes,
                     "invalidations_sent":
                         node0.stats.tracking_invalidations_sent}
            assert nc.hits > 0, f"{tag} the storm never hit the near-cache"
            assert node0.stats.tracking_demotions == 0, \
                f"{tag} unexpected outbuf demotion"
            return stats
        except AssertionError:
            raise
        except Exception as e:
            raise AssertionError(f"{tag} cell crashed: {e!r}") from e
        finally:
            await nc.close()
            await local.close()
            await peer.close()
            await cluster.close()


async def _run_migration_cell(seed: int, ops: int, rng) -> dict:
    import tempfile

    from .cluster_cells import (RedirectClient, _migrate, _owned_keys,
                                _seed_addrs, _specs)

    tag = f"[chaos tracking:track-slot-migration seed={seed}]"
    with tempfile.TemporaryDirectory(prefix="constdb-chaos-trk-") as work:
        plane = FaultPlane(seed)
        cluster = ChaosCluster(work, seed, _specs(), plane=plane)
        await cluster.start()
        rc = RedirectClient()
        nc = None
        try:
            await _seed_addrs(cluster)
            addr0 = cluster.apps[0].advertised_addr
            addr1 = cluster.apps[1].advertised_addr
            node0 = cluster.apps[0].node
            nc = await NearCacheClient(addr0).connect()
            # tracked keys owned by group 0; `moving` migrates away,
            # `staying` shares its fate only if its slot moved too (it
            # must NOT — the hook is per-slot, not flush-all)
            taken: set = set()
            moving = _owned_keys("trkmig", 0, 1, avoid=taken)[0]
            staying = _owned_keys("trkstay", 0, 1, avoid=taken)[0]
            # storm keys: group-0-owned, slot-disjoint from the subjects
            # (an unowned or just-moved key would answer MOVED)
            hot = _owned_keys("trkhot", 0, 6, avoid=taken)
            for k in hot:
                r = await rc.cmd(addr0, b"set", k, b"hv")
                assert not isinstance(r, Err), (k, r)
            for k in (moving, staying):
                r = await rc.cmd(addr0, b"set", k, b"before")
                assert not isinstance(r, Err), (k, r)
            assert await nc.get(moving) == Bulk(b"before")
            assert await nc.get(staying) == Bulk(b"before")
            drops0 = nc.invalidations + nc.flushes
            # storm on unrelated keys while the slot migrates away.
            # Two server-side paths may drop the moved entry — the
            # CLUSTER MIGRATE admin command's CTRL flush-all, and the
            # adopt-time slots_lost per-key push (pinned in isolation
            # by the tracking tests) — the LAW is that one of them
            # always does before a stale serve is possible
            mig = asyncio.create_task(
                _migrate(cluster, 0, slot_of(moving), addr1))
            serial = await _storm(rng, nc, [], ops, 0, write_pct=0.0,
                                  keys=hot)
            assert await mig, f"{tag} migration never completed"
            deadline = asyncio.get_running_loop().time() + 5.0
            while moving in nc.cache:
                assert asyncio.get_running_loop().time() < deadline, \
                    f"{tag} tracked key survived the slot handoff"
                await asyncio.sleep(0.01)
            assert nc.invalidations + nc.flushes > drops0, tag
            # the new owner takes a write this node will NEVER see — a
            # surviving near-cache entry would be permanently stale
            r = await rc.cmd(addr0, b"set", moving, b"after")
            assert not isinstance(r, Err), r
            got = await nc.get(moving)
            assert isinstance(got, Err) and got.val.startswith(b"MOVED"), \
                f"{tag} tracked read of the migrated key returned " \
                f"{got!r} instead of a MOVED redirect"
            # the new owner serves the key (which value wins is LWW
            # under the chaos clocks' skew — not this cell's law)
            r = await rc.cmd(addr0, b"get", moving)
            assert isinstance(r, Bulk), \
                f"{tag} migrated key unreadable on the new owner: {r!r}"
            assert await nc.get(staying) == Bulk(b"before")
            return {"serial": serial, "nc_hits": nc.hits,
                    "nc_invalidations": nc.invalidations,
                    "redirects": rc.redirects,
                    "epoch": node0.cluster.epoch}
        except AssertionError:
            raise
        except Exception as e:
            raise AssertionError(f"{tag} cell crashed: {e!r}") from e
        finally:
            if nc is not None:
                await nc.close()
            await rc.close()
            await cluster.close()


async def _run_cell_async(name: str, seed: int, ops: int = 30) -> dict:
    import random

    assert name in TRACKING_CELLS, name
    rng = random.Random(seed ^ 0x7AC4EDB5)
    if name == "track-slot-migration":
        return await _run_migration_cell(seed, ops, rng)
    return await _run_repl_cell(name, seed, ops, rng)


def run_tracking_cell(name: str, seed: int, ops: int = 30) -> dict:
    """Sync entry (scenario.run_scenario dispatches here for cells with
    Cell.tracking set)."""
    return asyncio.run(_run_cell_async(name, seed, ops))


__all__ = ["TRACKING_CELLS", "run_tracking_cell"]
