"""Resource-fault certification: overload governance under chaos.

The transport cells (scenario.py) certify convergence under *delivery*
faults; these cells certify the overload-governance layer (server/
overload.py, server/io.py outbuf cap, replica/link.py repl window) under
*resource* faults — and, critically, that its degradation preserves
convergence.  Three scripted scenarios, each a pure function of its
seed:

  firehose        a memory-capped node under a pipelined write firehose
                  sheds client data writes with EXACT `-OOM …` error
                  replies — never partially applied, logged, or
                  replicated — while deletes and reads stay admitted,
                  REPLICATION INTAKE keeps landing the peer's stream,
                  the accounting gauges track the injected pressure, and
                  the whole mesh still converges byte-identically to the
                  CPU-engine reference over the non-shed delivered set
                  (the shed-at-the-edge soundness law,
                  docs/INVARIANTS.md "Degradation laws").
  stalled_client  a client that stops reading is disconnected LOUDLY at
                  CONSTDB_TORCH_CLIENT_OUTBUF_MAX (counted in
                  client_outbuf_disconnects) without perturbing other
                  connections' reply streams — connection-fatal, never
                  state-corrupting.
  stalled_peer    a stalled-but-connected replica trips the
                  CONSTDB_TORCH_REPL_WINDOW pause (repl_window_pauses), the
                  ring evicts past the paused cursor, and recovery rides
                  the already-certified resync path (delta or full) to
                  byte-identical convergence once the peer drains.

`run_resource_scenario(seed)` runs all three and returns their stats;
any failure names `[chaos-resource seed=N]` — the replay handle.
Every node here runs the CPU engine, as in the reference's cells; a
shed reply is compared with the port's OOM_ERR (it names
CONSTDB_TORCH_MAXMEMORY).
"""

from __future__ import annotations

import asyncio
import tempfile

from ..resp.codec import encode_msg
from ..resp.message import Arr, Bulk, Err, Int
from ..server.overload import OOM_ERR
from .cluster import ChaosCluster, Client, NodeSpec
from .oracle import InvariantMonitor, OpJournal, certify_state
from .plane import FaultPlane


async def _pipeline(addr: str, frames: list[bytes],
                    chunk: int = 256) -> list:
    """Pipelined request/response driver: send `frames` in chunks of
    `chunk`, read every reply, return the reply list in order."""
    c = await Client().connect(addr)
    replies: list = []
    try:
        for lo in range(0, len(frames), chunk):
            part = frames[lo:lo + chunk]
            c.writer.write(b"".join(part))
            await c.writer.drain()
            got = 0
            while got < len(part):
                msg = c.parser.next_msg()
                if msg is not None:
                    replies.append(msg)
                    got += 1
                    continue
                data = await asyncio.wait_for(c.reader.read(1 << 16), 10.0)
                if not data:
                    raise ConnectionError("EOF mid-pipeline")
                c.parser.feed(data)
    finally:
        await c.close()
    return replies


def _set_frames(prefix: bytes, n: int, val_len: int,
                spread: int = 64) -> list[bytes]:
    return [encode_msg(Arr([Bulk(b"set"),
                            Bulk(b"%s%d" % (prefix, i % spread)),
                            Bulk(b"v%07d" % i + b"x" * val_len)]))
            for i in range(n)]


# ------------------------------------------------------------- firehose


async def _firehose(seed: int, work: str) -> dict:
    cap = 256_000  # bytes; the workload's footprint is several x this
    specs = [NodeSpec(engine="cpu",
                      extra={"maxmemory": cap, "maxmemory_soft_pct": 75.0}),
             NodeSpec(engine="cpu")]
    plane = FaultPlane(seed)
    journal = OpJournal()
    cluster = ChaosCluster(work, seed, specs, plane=plane, journal=journal)
    await cluster.start()
    monitor = InvariantMonitor(cluster, journal).start()
    tag = f"[chaos-resource seed={seed}] firehose:"
    try:
        await cluster.meet_all()
        await cluster.full_mesh()
        capped = cluster.apps[0]
        gov = capped.node.governor
        gov.check_every = 1  # exact watermark edges for the oracle
        addr0 = capped.advertised_addr
        addr1 = cluster.apps[1].advertised_addr

        # below the watermark everything lands
        pre = await _pipeline(addr0, _set_frames(b"pre:", 64, 64))
        assert not any(isinstance(r, Err) for r in pre), \
            f"{tag} writes shed below the soft watermark"

        # the firehose: enough SET bytes to blow far past the cap
        replies = await _pipeline(addr0, _set_frames(b"fh:", 4096, 512))
        oks = sum(1 for r in replies if not isinstance(r, Err))
        oom = [r for r in replies if isinstance(r, Err)]
        assert oom, f"{tag} cap {cap} never shed a single write"
        assert oks, f"{tag} every write shed — soft watermark at zero?"
        for r in oom:
            assert r.val == OOM_ERR, \
                f"{tag} shed reply is not the exact OOM error: {r.val!r}"
        used = gov.used_memory()
        assert used >= gov.soft_bytes, \
            f"{tag} shedding with used_memory {used} below soft " \
            f"{gov.soft_bytes}"

        # exempt traffic stays admitted while saturated
        probes = await _pipeline(addr0, [
            encode_msg(Arr([Bulk(b"set"), Bulk(b"fh:0"), Bulk(b"nope")])),
            encode_msg(Arr([Bulk(b"get"), Bulk(b"fh:0")])),
            encode_msg(Arr([Bulk(b"del"), Bulk(b"pre:0")])),
            encode_msg(Arr([Bulk(b"info"), Bulk(b"memory")])),
        ])
        assert isinstance(probes[0], Err) and probes[0].val == OOM_ERR, \
            f"{tag} saturated node admitted a data write"
        assert not isinstance(probes[1], Err), f"{tag} read shed"
        assert probes[2] == Int(1), \
            f"{tag} DEL shed under OOM (it frees memory): {probes[2]}"
        assert not isinstance(probes[3], Err), f"{tag} admin shed"
        info = bytes(probes[3].val)
        assert b"overload_state:" in info and b"used_memory:" in info, \
            f"{tag} INFO memory section lost its overload gauges"
        assert b"overload_state:ok" not in info, \
            f"{tag} INFO reports state ok while the node sheds"

        # accounting law: every shed produced exactly one error reply
        shed_stat = capped.node.stats.oom_shed_writes
        observed = len(oom) + 1  # + the probe SET above
        assert shed_stat == observed, \
            f"{tag} oom_shed_writes={shed_stat} but clients observed " \
            f"{observed} OOM replies"

        # replication intake is NEVER shed: the peer's writes must land
        # on the saturated node (convergence is the proof)
        peer = await _pipeline(addr1, _set_frames(b"peer:", 256, 256))
        assert not any(isinstance(r, Err) for r in peer), \
            f"{tag} uncapped peer shed writes"
        ref = await certify_state(cluster, journal, timeout=30.0)
        for i in range(64):
            key = b"peer:%d" % i
            assert key in ref, f"{tag} reference lost peer key {key!r}"
        monitor.check()
        return {"shed": shed_stat, "landed": oks,
                "used_memory": used, "maxmemory": cap,
                "hard_reclaims": capped.node.stats.oom_hard_reclaims,
                "canonical_keys": len(ref)}
    finally:
        monitor.stop()
        await cluster.close()


# ------------------------------------------------------- stalled client


async def _stalled_client(seed: int, work: str) -> dict:
    cap = 1 << 16
    specs = [NodeSpec(engine="cpu", extra={"client_outbuf_max": cap})]
    cluster = ChaosCluster(work, seed, specs, plane=FaultPlane(seed))
    await cluster.start()
    tag = f"[chaos-resource seed={seed}] stalled_client:"
    try:
        app = cluster.apps[0]
        addr = app.advertised_addr
        # seed a value big enough that a pipelined GET burst dwarfs the
        # cap (32KB x 64 replies = 2MB >> 64KB)
        seeded = await _pipeline(addr, [encode_msg(Arr(
            [Bulk(b"set"), Bulk(b"big"), Bulk(b"x" * (32 << 10))]))])
        assert not isinstance(seeded[0], Err), f"{tag} seed write failed"

        stalled = await Client().connect(addr)
        try:
            # 1024 x 32KB = 32MB of replies: far past anything loopback
            # kernel buffers can absorb, so the transport's un-drained
            # buffer must cross the 64KB cap
            burst = b"".join(encode_msg(Arr([Bulk(b"get"), Bulk(b"big")]))
                             for _ in range(1024))
            stalled.writer.write(burst)
            await stalled.writer.drain()
            # ... and never read.  The server must cut the connection at
            # the cap; reading now must hit EOF/reset, not data forever.
            deadline = asyncio.get_running_loop().time() + 10.0
            while app.node.stats.client_outbuf_disconnects == 0:
                assert asyncio.get_running_loop().time() < deadline, \
                    f"{tag} server never disconnected the stalled reader"
                await asyncio.sleep(0.02)
        finally:
            await stalled.close()
        assert app.node.stats.client_outbuf_disconnects == 1, \
            f"{tag} disconnect miscounted: " \
            f"{app.node.stats.client_outbuf_disconnects}"

        # other connections' reply streams are untouched
        fine = await _pipeline(addr, _set_frames(b"ok:", 128, 32) + [
            encode_msg(Arr([Bulk(b"get"), Bulk(b"ok:1")]))])
        assert not any(isinstance(r, Err) for r in fine), \
            f"{tag} a healthy connection caught errors"
        return {"outbuf_disconnects":
                app.node.stats.client_outbuf_disconnects}
    finally:
        await cluster.close()


# --------------------------------------------------------- stalled peer


async def _stalled_peer(seed: int, work: str) -> dict:
    specs = [NodeSpec(engine="cpu", repl_log_cap=24_000,
                      extra={"repl_window": 2048}),
             NodeSpec(engine="cpu")]
    plane = FaultPlane(seed)
    journal = OpJournal()
    cluster = ChaosCluster(work, seed, specs, plane=plane, journal=journal)
    await cluster.start()
    monitor = InvariantMonitor(cluster, journal).start()
    tag = f"[chaos-resource seed={seed}] stalled_peer:"
    try:
        await cluster.meet_all()
        await cluster.full_mesh()
        addr0 = cluster.apps[0].advertised_addr
        node0 = cluster.apps[0].node
        # the peer stops reading node 0's stream — connection stays up
        plane.stall(0, 1)
        replies = await _pipeline(addr0, _set_frames(b"st:", 1200, 64))
        assert not any(isinstance(r, Err) for r in replies), \
            f"{tag} writes failed on the pushing node"
        deadline = asyncio.get_running_loop().time() + 15.0
        while node0.stats.repl_window_pauses == 0:
            assert asyncio.get_running_loop().time() < deadline, \
                f"{tag} repl window never paused " \
                f"(CONSTDB_TORCH_REPL_WINDOW=2048, ~90KB backlogged)"
            await asyncio.sleep(0.05)
        # the paused cursor must fall off the byte-capped ring, so the
        # recovery below exercises the certified resync path
        deadline = asyncio.get_running_loop().time() + 15.0
        while node0.repl_log.evicted_up_to == 0:
            assert asyncio.get_running_loop().time() < deadline, \
                f"{tag} ring never evicted under the paused drain"
            await asyncio.sleep(0.05)
        resyncs0 = (node0.stats.repl_full_syncs
                    + node0.stats.repl_delta_syncs)
        plane.unstall(0, 1)
        ref = await certify_state(cluster, journal, timeout=45.0)
        resyncs = (node0.stats.repl_full_syncs
                   + node0.stats.repl_delta_syncs)
        assert resyncs > resyncs0, \
            f"{tag} eviction past the paused cursor recovered without " \
            f"a delta/full resync ({resyncs0} -> {resyncs})"
        monitor.check()
        return {"window_pauses": node0.stats.repl_window_pauses,
                "resyncs": resyncs, "canonical_keys": len(ref)}
    finally:
        monitor.stop()
        await cluster.close()


# ---------------------------------------------------------------- runner


async def _run_all(seed: int) -> dict:
    out: dict = {}
    for name, fn in (("firehose", _firehose),
                     ("stalled_client", _stalled_client),
                     ("stalled_peer", _stalled_peer)):
        with tempfile.TemporaryDirectory(
                prefix=f"constdb-chaos-res-{name}-") as work:
            out[name] = await fn(seed, work)
    return out


def run_resource_scenario(seed: int) -> dict:
    """Run the three resource-fault certification scenarios (module
    doc); returns per-scenario stats.  Failures carry
    `[chaos-resource seed=N]` — the replay handle."""
    try:
        return asyncio.run(_run_all(seed))
    except AssertionError:
        raise
    except Exception as e:
        raise AssertionError(
            f"[chaos-resource seed={seed}] scenario crashed: {e!r}") from e


__all__ = ["run_resource_scenario"]
