"""Twins of the three ChaosCluster cases of tests/test_cntundo.py on the
port's chaos harness (constdb_tpu_torch/chaos/), each on the CPU engine
and on the port's card engines run on the CPU (device="cpu"): an undo
replicates and is rejected on a replica, an undo plans through the serve
coalescer, and the undo log survives a warm restart but not a cold one.
The assertions are the reference cases' own."""

import asyncio

import pytest

from constdb_tpu_torch.chaos import ChaosCluster, NodeSpec
from constdb_tpu_torch.chaos.cluster import Client
from constdb_tpu_torch.engine.cpu import CpuMergeEngine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.resp.codec import encode_msg
from constdb_tpu_torch.resp.message import Arr, Bulk, Err, Int

KINDS = ["cpu", "torch", "torch-resident"]


def spec(kind: str) -> NodeSpec:
    return NodeSpec(engine=kind, device="cpu")


def engine_type(kind: str):
    return CpuMergeEngine if kind == "cpu" else TorchMergeEngine


@pytest.mark.parametrize("kind", KINDS)
def test_undo_replicates_and_is_remote_rejected(tmp_path, kind):
    async def main():
        cluster = ChaosCluster(str(tmp_path), seed=2,
                               specs=[spec(kind), spec(kind)])
        await cluster.start()
        try:
            a, b = cluster.apps
            assert type(a.node.engine) is engine_type(kind)
            ca = await Client().connect(a.advertised_addr)
            await ca.cmd("meet", b.advertised_addr)
            assert await ca.cmd("incr", "k", 7) == Int(7)
            await cluster.converge()
            cb = await Client().connect(b.advertised_addr)
            r = await cb.cmd("cntundo", "k")
            assert isinstance(r, Err)
            assert await ca.cmd("cntundo", "k") == Int(0)
            await cluster.converge()
            assert await cb.cmd("get", "k") == Int(0)
            await ca.close()
            await cb.close()
        finally:
            await cluster.close()
    asyncio.run(main())


@pytest.mark.parametrize("kind", KINDS)
def test_undo_plans_through_serve_coalescer(tmp_path, kind):
    async def main():
        cluster = ChaosCluster(str(tmp_path), seed=3, specs=[spec(kind)])
        await cluster.start()
        try:
            app = cluster.apps[0]
            c = await Client().connect(app.advertised_addr)
            buf = bytearray()
            for parts in ((b"incr", b"k", b"3"), (b"incr", b"k", b"4"),
                          (b"cntundo", b"k"), (b"incr", b"k", b"10")):
                buf += encode_msg(Arr([Bulk(p) for p in parts]))
            c.writer.write(bytes(buf))
            await c.writer.drain()
            replies = []
            while len(replies) < 4:
                msg = c.parser.next_msg()
                if msg is not None:
                    replies.append(msg)
                    continue
                data = await asyncio.wait_for(c.reader.read(1 << 16), 10.0)
                c.parser.feed(data)
            assert replies == [Int(3), Int(7), Int(3), Int(13)], replies
            assert await c.cmd("get", "k") == Int(13)
            assert app.node.stats.serve_msgs_coalesced >= 4
            await c.close()
        finally:
            await cluster.close()
    asyncio.run(main())


@pytest.mark.parametrize("kind", KINDS)
def test_undo_survives_warm_restart_not_cold(tmp_path, kind):
    async def main():
        cluster = ChaosCluster(str(tmp_path), seed=4, specs=[spec(kind)])
        await cluster.start()
        try:
            c = await Client().connect(cluster.apps[0].advertised_addr)
            assert await c.cmd("incr", "k", 5) == Int(5)
            await c.close()
            eng = cluster.apps[0].node.engine
            await cluster.restart_warm(0)
            assert cluster.apps[0].node.engine is eng
            c = await Client().connect(cluster.apps[0].advertised_addr)
            assert await c.cmd("cntundo", "k") == Int(0)
            assert await c.cmd("incr", "k", 9) == Int(9)
            await c.close()
            await cluster.restart_cold(0)
            assert cluster.apps[0].node.engine is not eng
            assert type(cluster.apps[0].node.engine) is engine_type(kind)
            c = await Client().connect(cluster.apps[0].advertised_addr)
            assert await c.cmd("get", "k") == Int(9)
            r = await c.cmd("cntundo", "k")
            assert isinstance(r, Err)
            await c.close()
        finally:
            await cluster.close()
    asyncio.run(main())
