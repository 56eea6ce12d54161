"""The port's chaos certification harness (constdb_tpu_torch/chaos/)
against the reference's (constdb_tpu/chaos/), on the CPU.

Differentials, each over the same seeded inputs in both packages:

  (a) the fault plane's transport units: `_Splitter.feed` cuts the same
      units (kind, payload bytes, exempt, reorderable) from RESP commands,
      REPLICATE / REPLBATCH / REPLACK frames and FULLSYNC / DELTASYNC
      headers with their raw windows, cut at every byte; `_swappable`,
      `_corrupt_replbatch` and the ChaosClock sequence (with jumps);
  (b) the schedules: certify_scenario and soak_scenario steps for
      several seeds, matrix_cells / smoke_cells names (xla -> torch);
  (c) the oracle: the same journal ops give equal reference_canonical,
      before and after the reference node's GC drain;
  (d) the reference's OpJournal replays a port run's journal to the
      canonical the port's oracle certified;
  (e) every oracle node and every "cpu" node runs the port's
      CpuMergeEngine (a Node with no engine would be a card node);
  (f) a twin of every case of tests/test_chaos.py, with the same
      assertions (the full matrix, the everysec cell and the soak slow,
      as there); the native-intake twin sets no knob and never skips:
      the port has no pure intake path;
  (g) the default cell with its fast-path nodes on the resident steady
      TorchMergeEngine (device="cpu"), plus a warm restart's next device
      round on the same engine.

Also: the cluster and tracking cells, the CLI on the CPU, and the card
default (a card cell raises without a card, never moving to the CPU)."""

import asyncio
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from constdb_tpu.chaos import cluster as ref_cluster
from constdb_tpu.chaos import oracle as ref_oracle
from constdb_tpu.chaos import plane as ref_plane
from constdb_tpu.chaos import scenario as ref_scenario
from constdb_tpu.resp import codec as RC
from constdb_tpu.resp import message as RM
from constdb_tpu_torch.chaos import (Cell, ChaosCluster, FaultPlane, NodeSpec,
                                     Scenario, certify_scenario, matrix_cells,
                                     run_resource_scenario, run_scenario,
                                     smoke_cells, soak_scenario)
from constdb_tpu_torch.chaos import cluster as port_cluster
from constdb_tpu_torch.chaos import cluster_cells as port_cluster_cells
from constdb_tpu_torch.chaos import oracle as port_oracle
from constdb_tpu_torch.chaos import plane as port_plane
from constdb_tpu_torch.chaos import scenario as port_scenario
from constdb_tpu_torch.chaos.cluster import Client
from constdb_tpu_torch.chaos.cluster_cells import CLUSTER_CELLS
from constdb_tpu_torch.chaos.tracking_cells import TRACKING_CELLS
from constdb_tpu_torch.engine.cpu import CpuMergeEngine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.resp import codec as PC
from constdb_tpu_torch.resp import message as PM
from constdb_tpu_torch.resp.message import Nil
from constdb_tpu_torch.server.node import Node

ROOT = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ helpers


def to_ref(msg):
    """A port RESP message as the reference's class of the same name."""
    if isinstance(msg, PM.Arr):
        return RM.Arr([to_ref(m) for m in msg.items])
    if isinstance(msg, PM.Nil):
        return RM.Nil()
    return getattr(RM, type(msg).__name__)(msg.val)


def frames(M, seed: int) -> bytes:
    """A replication stream of both packages' shapes from `M`'s message
    classes: a handshake, chained REPLICATE frames, REPLBATCH runs
    (chained and not), a REPLACK, a FULLSYNC and a DELTASYNC header each
    with its raw window, and client commands around them."""
    codec = RC if M is RM else PC
    rng = random.Random(seed)
    out = bytearray()

    def put(items):
        out.extend(codec.encode_msg(M.Arr(items)))

    put([M.Bulk(b"sync"), M.Int(0), M.Int(1), M.Bulk(b"n1"),
         M.Bulk(b"127.0.0.1:7001"), M.Int(0), M.Int(15)])
    uuid = 1000
    for i in range(6):
        prev, uuid = uuid, uuid + rng.randrange(1, 50)
        put([M.Bulk(b"replicate"), M.Int(1), M.Int(prev), M.Int(uuid),
             M.Bulk(b"set"), M.Bulk(b"k%d" % i), M.Bulk(b"v" * i)])
    for chained in (True, True, False, True):
        prev = uuid if chained else uuid + 7
        uuid = prev + rng.randrange(10, 90)
        payload = bytes(rng.randrange(256)
                        for _ in range(rng.randrange(1, 120)))
        put([M.Bulk(b"REPLBATCH"), M.Int(1), M.Int(prev), M.Int(uuid),
             M.Int(rng.randrange(1, 9)), M.Bulk(payload)])
    put([M.Bulk(b"replack"), M.Int(uuid), M.Int(123), M.Int(uuid),
         M.Int(-1)])
    for kind in (b"fullsync", b"deltasync"):
        raw = bytes(rng.randrange(256) for _ in range(rng.randrange(40, 90)))
        put([M.Bulk(kind), M.Int(len(raw)), M.Int(uuid), M.Int(0)])
        out.extend(raw)
        prev, uuid = uuid, uuid + 3
        put([M.Bulk(b"replicate"), M.Int(1), M.Int(prev), M.Int(uuid),
             M.Bulk(b"sadd"), M.Bulk(b"s"), M.Bulk(b"m")])
    put([M.Bulk(b"fullsync"), M.Int(0), M.Int(uuid), M.Int(1)])
    put([M.Bulk(b"set"), M.Bulk(b"plain"), M.Bulk(b"cmd")])
    put([M.Bulk(b"get"), M.Bulk(b"plain")])
    return bytes(out)


def unit_view(u) -> tuple:
    return (u.kind, u.payload, u.exempt, u.reorderable)


def split(mod, data: bytes, cuts) -> list:
    sp = mod._Splitter()
    units = []
    lo = 0
    for c in list(cuts) + [len(data)]:
        units += sp.feed(data[lo:c])
        lo = c
    return units


def pkg_journal(ops: dict, ref: bool):
    """An OpJournal of either package holding `ops` (port messages)."""
    if ref:
        j = ref_oracle.OpJournal()
        j.ops = {k: (name, [to_ref(a) for a in args])
                 for k, (name, args) in ops.items()}
    else:
        j = port_oracle.OpJournal()
        j.ops = dict(ops)
    return j


def capture_run(monkeypatch, sc: Scenario) -> tuple:
    """Run `sc` on the port, keeping its journal, the canonical the
    oracle certified and every engine its node specs built."""
    journals, canons, engines = [], [], []

    class Journal(port_oracle.OpJournal):
        def __init__(self):
            super().__init__()
            journals.append(self)

    async def certify(cluster, journal, timeout=30.0):
        canon = await port_oracle.certify_state(cluster, journal, timeout)
        canons.append(canon)
        return canon

    build = NodeSpec.build_engine

    def build_engine(spec):
        eng = build(spec)
        engines.append((spec.engine, eng))
        return eng

    monkeypatch.setattr(port_scenario, "OpJournal", Journal)
    monkeypatch.setattr(port_scenario, "certify_state", certify)
    monkeypatch.setattr(NodeSpec, "build_engine", build_engine)
    stats = run_scenario(sc)
    assert len(journals) == 1 and len(canons) == 1
    return stats, journals[0], canons[0], engines


# ------------------------------------------------- (a) the fault plane


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_splitter_cuts_the_reference_units(seed):
    ref_bytes, port_bytes = frames(RM, seed), frames(PM, seed)
    assert ref_bytes == port_bytes
    data = port_bytes
    rng = random.Random(seed)
    cut_sets = [[], list(range(1, len(data)))]       # whole, byte by byte
    cut_sets += [[c] for c in range(1, len(data))]   # every single cut
    cut_sets += [sorted(rng.sample(range(1, len(data)), 12))
                 for _ in range(20)]
    whole = None
    for cuts in cut_sets:
        want = [unit_view(u) for u in split(ref_plane, data, cuts)]
        got = [unit_view(u) for u in split(port_plane, data, cuts)]
        assert got == want, cuts[:4]
        if whole is None:
            whole = got
        assert got == whole
    kinds = [k for k, *_ in whole]
    assert kinds.count(b"fullsync") == 2 and kinds.count(b"deltasync") == 1
    assert b"".join(p for _, p, _, _ in whole) == data
    raw = [v for v in whole if v[0] in (b"fullsync", b"deltasync")][:2]
    assert all(v[2] and not v[3] for v in raw)   # atomic, never reordered


def test_swappable_and_corrupt_replbatch_equal_the_reference():
    data = frames(PM, 5)
    want = split(ref_plane, data, [])
    got = split(port_plane, data, [])
    assert len(got) == len(want)
    for a in range(len(got)):
        for b in range(len(got)):
            assert port_plane._swappable(got[a], got[b]) == \
                ref_plane._swappable(want[a], want[b]), (a, b)
    batches = [(p, r) for p, r in zip(got, want) if p.kind == b"replbatch"]
    assert len(batches) == 4
    for p, r in batches:
        pc, rc = port_plane._corrupt_replbatch(p), \
            ref_plane._corrupt_replbatch(r)
        assert pc.payload == rc.payload != p.payload
        assert (pc.kind, pc.exempt, pc.reorderable) == \
            (rc.kind, rc.exempt, rc.reorderable)


def test_fault_schedule_draws_equal_the_reference():
    """One edge's seeded decisions (dup, reorder, delay) over the same
    units: the same delivery ops in the same order."""
    data = frames(PM, 9)

    def ops_of(mod):
        plane = mod.FaultPlane(17)
        plane.set_faults(0, 1, delay=(0.001, 0.004), reorder=0.4, dup=0.3)
        conn = object.__new__(mod._ChaosConn)
        conn.plane = plane
        units = split(mod, data, [])
        out = conn._schedule((0, 1), units)
        plane.truncate_next(0, 1)
        out += conn._schedule((0, 1), split(mod, data, []))
        return out, dict(plane.stats)

    assert ops_of(port_plane) == ops_of(ref_plane)


def test_chaos_clock_sequence_equals_the_reference():
    for seed, idx in ((7, 0), (7, 2), (99, 1)):
        a = ref_cluster.ChaosClock(seed, idx, start_ms=1_700_000_000_000)
        b = port_cluster.ChaosClock(seed, idx, start_ms=1_700_000_000_000)
        seq_a, seq_b = [], []
        for step in range(300):
            if step in (40, 120, 200):
                delta = (30_000, -20_000, -15_000)[(40, 120, 200).index(step)]
                a.jump(delta)
                b.jump(delta)
            seq_a.append(a())
            seq_b.append(b())
        assert seq_a == seq_b
        assert min(seq_b[121:200]) < max(seq_b[:120])   # the backward step


# --------------------------------------------------- (b) the schedules


def test_cell_names_equal_the_reference_after_the_rename():
    rename = [c.name.replace("xla", "torch")
              for c in ref_scenario.matrix_cells()]
    assert [c.name for c in matrix_cells()] == rename
    assert len(rename) == 28
    assert sum(c.engine != "cpu" for c in matrix_cells()) == 8
    assert [c.name for c in smoke_cells()] == \
        [c.name.replace("xla", "torch") for c in ref_scenario.smoke_cells()]
    assert all(c.device == "cuda" for c in matrix_cells())
    assert all(c.device == "cpu" for c in matrix_cells("cpu"))
    assert [c.name for c in matrix_cells("cpu")] == rename


@pytest.mark.parametrize("seed", [1, 7, 11, 42])
def test_certify_steps_equal_the_reference(seed):
    for rc, pc in zip(ref_scenario.matrix_cells(), matrix_cells()):
        for ops in (25, 30):
            a = ref_scenario.certify_scenario(seed, rc, ops=ops)
            b = certify_scenario(seed, pc, ops=ops)
            assert b.steps == a.steps, pc.name
            assert (b.n_nodes, b.mixed_idx, b.ops_per_burst,
                    b.converge_timeout) == (a.n_nodes, a.mixed_idx,
                                            a.ops_per_burst,
                                            a.converge_timeout)
            assert b.name == a.name.replace("xla", "torch")


@pytest.mark.parametrize("seed", [1, 2, 3, 99, 123])
def test_soak_steps_equal_the_reference(seed):
    a, b = ref_scenario.soak_scenario(seed), soak_scenario(seed)
    assert b.steps == a.steps
    assert b.converge_timeout == a.converge_timeout == 90.0
    assert b.steps[-1] == ("certify",)


def test_node_specs_equal_the_reference():
    for rc, pc in zip(ref_scenario.matrix_cells(), matrix_cells("cpu")):
        for mixed in (None, 2):
            ra, pa = rc.specs(3, mixed), pc.specs(3, mixed)
            for r, p in zip(ra, pa):
                assert p.app_kwargs() == r.app_kwargs()
                assert p.engine == r.engine.replace("xla", "torch")
                assert p.repl_log_cap == r.repl_log_cap
                assert p.serve_shards == r.serve_shards
            if mixed is not None:
                assert pa[mixed].engine == "cpu"
                assert pa[mixed].build_engine().__class__ is CpuMergeEngine
    assert port_cluster.FAST == ref_cluster.FAST


# ---------------------------------------------------- (c) the oracle


def journal_ops(seed: int) -> dict:
    """Two origins' journaled ops from the port's CPU-engine nodes driven
    by a seeded command mix (counters, CNTUNDO, registers, DEL, sets,
    hashes), no replication between them."""
    journal = port_oracle.OpJournal()
    rng = random.Random(seed)
    for nid in (1, 2):
        node = Node(node_id=nid, alias=f"n{nid}", engine=CpuMergeEngine(),
                    clock=port_cluster.ChaosClock(seed, nid,
                                                  start_ms=1_700_000_000_000))
        journal.hook_node(node)
        for j in range(160):
            die = rng.random()
            k = b"%d" % rng.randrange(6)
            if die < 0.25:
                parts = [rng.choice((b"incr", b"decr")), b"cnt" + k,
                         b"%d" % rng.randrange(1, 4)]
            elif die < 0.32:
                parts = [b"cntundo", b"cnt" + k]
            elif die < 0.5:
                parts = [b"set", b"reg" + k, b"v%d" % j]
            elif die < 0.58:
                parts = [b"del", b"reg" + k]
            elif die < 0.72:
                parts = [b"sadd", b"set" + k, b"m%d" % (j % 9)]
            elif die < 0.82:
                parts = [b"srem", b"set" + k, b"m%d" % rng.randrange(9)]
            elif die < 0.94:
                parts = [b"hset", b"h" + k, b"f%d" % (j % 4), b"v%d" % j]
            else:
                parts = [b"hdel", b"h" + k, b"f%d" % (j % 4)]
            node.execute(PM.Arr([PM.Bulk(p) for p in parts]))
    return journal.ops


@pytest.mark.parametrize("seed", [3, 4])
def test_reference_canonical_equals_the_reference(seed):
    ops = journal_ops(seed)
    assert len(ops) > 250
    names = {name for name, _ in ops.values()}
    assert {b"set", b"sadd", b"srem", b"hset"} <= names
    for collected in (False, True):
        want = pkg_journal(ops, True).reference_canonical(collected)
        got = pkg_journal(ops, False).reference_canonical(collected)
        assert got == want
        assert len(got) > 10


def test_prune_origin_equals_the_reference():
    ops = journal_ops(5)
    ref, port = pkg_journal(ops, True), pkg_journal(ops, False)
    above = sorted(u for o, u in ops if o == 2)[40]
    assert port.prune_origin(2, above) == ref.prune_origin(2, above) > 0
    assert set(port.ops) == set(ref.ops)
    assert port.reference_canonical(True) == ref.reference_canonical(True)


# ------------------------------ (d) the reference replays a port run


def test_reference_replays_the_port_journal(monkeypatch):
    stats, journal, canon, _ = capture_run(
        monkeypatch, certify_scenario(7, Cell()))
    assert stats["journal_ops"] == len(journal.ops) > 100
    ref = pkg_journal(journal.ops, True)
    assert ref.reference_canonical(collected=True) == canon
    assert stats["canonical_keys"] == len(canon)


# ------------------------------------- (e) the CPU engines stay CPU


def test_oracle_and_cpu_nodes_run_the_cpu_engine(monkeypatch, tmp_path):
    assert type(NodeSpec(engine="cpu").build_engine()) is CpuMergeEngine
    assert type(NodeSpec(engine="cpu", device="cuda").build_engine()) \
        is CpuMergeEngine
    built = []

    class Spy(Node):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append((self.alias, type(self.engine)))

    monkeypatch.setattr(port_oracle, "Node", Spy)
    pkg_journal(journal_ops(6), False).reference_canonical(True)
    assert built == [("oracle", CpuMergeEngine)]
    # the cluster oracle imports Node where it runs
    from constdb_tpu_torch.server import node as node_mod
    monkeypatch.setattr(node_mod, "Node", Spy)
    stats = port_cluster_cells.run_cluster_cell("ownership-flap", 7, ops=12)
    assert stats["journal_ops"] > 0
    assert ("cluster-oracle", CpuMergeEngine) in built


def test_card_specs_build_the_torch_engine_on_their_device():
    a = NodeSpec(engine="torch", device="cpu").build_engine()
    b = NodeSpec(engine="torch-resident", device="cpu").build_engine()
    for eng in (a, b):
        assert type(eng) is TorchMergeEngine and eng.device.type == "cpu"
        assert eng.resident
        eng.close()
    assert not a.steady and b.steady
    with pytest.raises(ValueError):
        NodeSpec(engine="xla").build_engine()


def test_card_cell_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        NodeSpec(engine="torch-resident").build_engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(certify_scenario(7, Cell(engine="torch")))


# ------------------------------- (f) twins of tests/test_chaos.py


def test_certify_default_cell(tmp_path):
    stats = run_scenario(certify_scenario(7, Cell()))
    plane = stats["plane"]
    assert plane.get("partitions", 0) >= 3
    assert plane.get("truncations", 0) == 1
    assert plane.get("wire_corruptions", 0) >= 1
    assert stats["reconnects"] >= 1


def test_certify_native_intake_cell(tmp_path):
    """The port's intake is always the native scanner: no knob, no
    skip."""
    stats = run_scenario(certify_scenario(13, Cell()))
    corruptions = stats["plane"].get("wire_corruptions", 0)
    assert corruptions >= 1
    assert 1 <= stats["wire_demotions"] <= corruptions
    assert stats["native_intake_chunks"] > 0


def test_certify_legacy_cell(tmp_path):
    run_scenario(certify_scenario(7, Cell(wire=False, delta=False)))


def test_certify_aof_cell(tmp_path):
    stats = run_scenario(certify_scenario(7, Cell(aof="always")))
    assert stats["journal_ops"] > 0


def test_certify_checkpoint_crash_cell(tmp_path):
    stats = run_scenario(certify_scenario(7, Cell(aof="always",
                                                  ckpt=True)))
    assert stats["journal_ops"] > 0


@pytest.mark.slow
def test_certify_aof_everysec_cell(tmp_path):
    run_scenario(certify_scenario(11, Cell(aof="everysec")))


def test_certify_replays_from_seed(tmp_path):
    a = run_scenario(certify_scenario(21, Cell(wire=False, delta=False)))
    b = run_scenario(certify_scenario(21, Cell(wire=False, delta=False)))
    assert a["journal_ops"] == b["journal_ops"]
    assert a["canonical_keys"] == b["canonical_keys"]


def test_crash_styles_converge(tmp_path):
    steps = [
        ("ops", 40),
        ("crash", 1, "cold"),
        ("ops", 40),
        ("crash", 0, "warm"),
        ("ops", 40),
        ("crash", 2, "cold"),
        ("ops", 20),
        ("certify",),
    ]
    run_scenario(Scenario(seed=5, steps=steps))


def test_resource_cells_certify(tmp_path):
    stats = run_resource_scenario(7)
    assert stats["firehose"]["shed"] > 0
    assert stats["firehose"]["landed"] > 0
    assert stats["stalled_client"]["outbuf_disconnects"] == 1
    assert stats["stalled_peer"]["window_pauses"] >= 1
    assert stats["stalled_peer"]["resyncs"] >= 1


def test_resource_cells_replay_from_seed(tmp_path):
    a = run_resource_scenario(23)
    b = run_resource_scenario(23)
    assert a["firehose"]["landed"] == b["firehose"]["landed"]
    assert a["firehose"]["canonical_keys"] == \
        b["firehose"]["canonical_keys"]


def test_resource_shed_reply_is_the_ports_oom_error():
    from constdb_tpu_torch.chaos import resource
    from constdb_tpu_torch.server.overload import OOM_ERR
    assert resource.OOM_ERR is OOM_ERR
    assert b"CONSTDB_TORCH_MAXMEMORY" in OOM_ERR


@pytest.mark.slow
def test_certify_full_matrix(tmp_path):
    for cell in matrix_cells("cpu"):
        run_scenario(certify_scenario(11, cell, ops=25))


@pytest.mark.slow
def test_chaos_soak_randomized(tmp_path):
    for seed in (99, 1, 2):
        run_scenario(soak_scenario(seed))


@pytest.mark.parametrize("aof", [None, "always"], ids=["snapshot", "aof"])
def test_cold_restart_does_not_resurrect_collected_tombstones(tmp_path,
                                                              aof):
    async def main():
        cluster = ChaosCluster(str(tmp_path), seed=1,
                               specs=[NodeSpec(aof=aof),
                                      NodeSpec(aof=aof)])
        await cluster.start()
        try:
            a, b = cluster.apps
            ca = await Client().connect(a.advertised_addr)
            cb = await Client().connect(b.advertised_addr)
            await ca.cmd("meet", b.advertised_addr)
            await cluster.converge()
            await ca.cmd("sadd", "s", "gone")
            await ca.cmd("sadd", "s", "keep")
            await cluster.converge()
            await cb.cmd("srem", "s", "gone")
            await cb.close()
            await cluster.converge()
            deadline = asyncio.get_running_loop().time() + 10.0
            while True:
                for app in cluster.apps:
                    app.node.gc()
                if all(len(app.node.ks.garbage) == 0 and
                       app.node.ks.el_row(app.node.ks.lookup(b"s"),
                                          b"gone") < 0
                       for app in cluster.apps):
                    break
                assert asyncio.get_running_loop().time() < deadline, \
                    "tombstone never collected"
                await asyncio.sleep(0.1)
            assert a.node.repl_log.first_uuid <= a.node.repl_log.last_uuid
            await cluster.restart_cold(1)
            await cluster.converge(timeout=15.0)
            for app in cluster.apps:
                c = await Client().connect(app.advertised_addr)
                got = await c.cmd("smembers", "s")
                members = ({i.val for i in got.items}
                           if not isinstance(got, Nil) else set())
                assert members == {b"keep"}, (app.port, members)
                await c.close()
            await ca.close()
        finally:
            await cluster.close()
    asyncio.run(main())


def test_coverage_gates_third_party_tombstone_collection(tmp_path):
    async def main():
        plane = FaultPlane(3)
        cluster = ChaosCluster(str(tmp_path), seed=3,
                               specs=[NodeSpec()] * 3, plane=plane)
        await cluster.start()
        try:
            a, b, c = cluster.apps
            cl = await Client().connect(a.advertised_addr)
            await cl.cmd("meet", b.advertised_addr)
            await cl.cmd("meet", c.advertised_addr)
            await cl.close()
            await cluster.converge()
            cc = await Client().connect(c.advertised_addr)
            await cc.cmd("sadd", "s", "m")
            await cluster.converge()
            plane.partition(0, 2)
            await cc.cmd("srem", "s", "m")
            await cc.close()

            def b_has_tombstone():
                ks = b.node.ks
                kid = ks.lookup(b"s")
                row = ks.el_row(kid, b"m") if kid >= 0 else -1
                return row >= 0 and \
                    int(ks.el.del_t[row]) > int(ks.el.add_t[row])

            deadline = asyncio.get_running_loop().time() + 10.0
            while not b_has_tombstone():
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.05)
            ca = await Client().connect(a.advertised_addr)
            for i in range(5):
                await ca.cmd("set", "tick", f"v{i}")
                await asyncio.sleep(0.2)
                b.node.gc()
                assert b_has_tombstone(), \
                    "B collected a third-party tombstone A never saw"
            await ca.close()
            plane.heal()
            await cluster.converge(timeout=20.0)
            deadline = asyncio.get_running_loop().time() + 10.0
            while b_has_tombstone():
                b.node.gc()
                assert asyncio.get_running_loop().time() < deadline, \
                    "B never collected after full coverage"
                await asyncio.sleep(0.1)
        finally:
            await cluster.close()
    asyncio.run(main())


def test_backoff_delay_deterministic_and_bounded():
    from constdb_tpu.replica.link import backoff_delay as ref_backoff
    from constdb_tpu_torch.replica.link import backoff_delay

    raw = [backoff_delay(0.2, 2.0, 5.0, 0.0, 1, "a:1", n)
           for n in range(12)]
    assert raw == sorted(raw)
    assert raw[0] == 0.2 and raw[-1] == 5.0
    jit = [backoff_delay(0.2, 2.0, 5.0, 0.2, 1, "a:1", n)
           for n in range(12)]
    assert jit == [backoff_delay(0.2, 2.0, 5.0, 0.2, 1, "a:1", n)
                   for n in range(12)]
    assert all(0.8 * r <= j <= 1.2 * r + 1e-9
               for r, j in zip(raw, jit))
    assert backoff_delay(1, 2, 60, 0.2, 1, "a:1", 3) != \
        backoff_delay(1, 2, 60, 0.2, 2, "a:1", 3)
    assert jit == [ref_backoff(0.2, 2.0, 5.0, 0.2, 1, "a:1", n)
                   for n in range(12)]


def test_info_reports_link_state_and_reconnects(tmp_path):
    async def main():
        plane = FaultPlane(5)
        cluster = ChaosCluster(str(tmp_path), seed=5,
                               specs=[NodeSpec(), NodeSpec()],
                               plane=plane)
        await cluster.start()
        try:
            a, b = cluster.apps
            c = await Client().connect(a.advertised_addr)
            await c.cmd("meet", b.advertised_addr)
            await cluster.full_mesh()
            assert plane.kill_connections(0, 1) >= 1
            deadline = asyncio.get_running_loop().time() + 15.0
            while a.node.stats.repl_reconnects + \
                    b.node.stats.repl_reconnects < 1:
                assert asyncio.get_running_loop().time() < deadline, \
                    "no reconnect counted after a connection kill"
                await asyncio.sleep(0.05)
            await cluster.full_mesh(timeout=15.0)
            info = (await c.cmd("info", "replication")).val.decode()
            assert "repl_link_state" in info
            assert "state=connected" in info
            assert "reconnects=" in info
            stats = (await c.cmd("info", "stats")).val.decode()
            assert "repl_reconnects:" in stats
            await c.close()
        finally:
            await cluster.close()
    asyncio.run(main())


def test_replack_carries_cluster_coverage(tmp_path):
    async def main():
        cluster = ChaosCluster(str(tmp_path), seed=4,
                               specs=[NodeSpec(), NodeSpec()])
        await cluster.start()
        try:
            a, b = cluster.apps
            cl = await Client().connect(a.advertised_addr)
            await cl.cmd("meet", b.advertised_addr)
            await cl.cmd("set", "k", "v")
            await cl.close()
            await cluster.converge()
            deadline = asyncio.get_running_loop().time() + 10.0
            while True:
                covs = [m.coverage
                        for app in cluster.apps
                        for m in app.node.replicas.peers.values()]
                if covs and all(c >= 0 for c in covs):
                    break
                assert asyncio.get_running_loop().time() < deadline, covs
                await asyncio.sleep(0.05)
        finally:
            await cluster.close()
    asyncio.run(main())


# ------------------------------ (g) the card engines, on the CPU


@pytest.mark.parametrize("engine", ["torch-resident", "torch"])
def test_certify_default_cell_on_torch_engines(monkeypatch, engine):
    """The acceptance schedule with the fast-path nodes on the port's
    TorchMergeEngine (device="cpu": every kernel's plain version), the
    mixed-version peer on the CPU engine, and the reference replaying
    the journal to the certified canonical."""
    stats, journal, canon, engines = capture_run(
        monkeypatch, certify_scenario(7, Cell(engine=engine, device="cpu")))
    plane = stats["plane"]
    assert plane.get("partitions", 0) >= 3
    assert plane.get("truncations", 0) == 1
    assert plane.get("wire_corruptions", 0) >= 1
    assert stats["reconnects"] >= 1
    card = [e for kind, e in engines if kind == engine]
    cpu = [e for kind, e in engines if kind == "cpu"]
    # nodes 0 and 1 plus node 1's cold restart; node 2 is the CPU peer
    assert len(card) == 3 and len(cpu) == 1
    assert all(type(e) is TorchMergeEngine and e.device.type == "cpu"
               for e in card)
    assert type(cpu[0]) is CpuMergeEngine
    rounds = sum(e.dev_rounds_resident for e in card)
    assert (rounds > 0) == (engine == "torch-resident")
    assert pkg_journal(journal.ops, True).reference_canonical(True) == canon


def test_warm_restart_keeps_the_resident_engine(tmp_path):
    """A warm restart keeps the Node and its resident steady engine under
    a new ServerApp: the next writes run device rounds on the SAME
    engine's mirrors, and the mesh certifies against the CPU oracle."""
    async def main():
        journal = port_oracle.OpJournal()
        cluster = ChaosCluster(
            str(tmp_path), seed=9, journal=journal,
            specs=[NodeSpec(engine="torch-resident", device="cpu"),
                   NodeSpec(engine="cpu")])
        await cluster.start()
        try:
            await cluster.meet_all()
            await cluster.full_mesh()
            wl = port_scenario._Workload(9, 2)
            await wl.burst(cluster, 60)
            await wl.pipelined_writes(cluster, 0, 24)
            eng = cluster.apps[0].node.engine
            before = eng.dev_rounds_resident
            assert before > 0
            await cluster.restart_warm(0)
            assert cluster.apps[0].node.engine is eng
            await wl.pipelined_writes(cluster, 0, 24)
            await wl.burst(cluster, 60)
            assert eng.dev_rounds_resident > before
            wl.cached_read_check(cluster, 0)
            canon = await port_oracle.certify_state(cluster, journal)
            assert canon == await cluster.canonical_of(0)
            await cluster.restart_cold(0)
            assert cluster.apps[0].node.engine is not eng
            assert type(cluster.apps[0].node.engine) is TorchMergeEngine
        finally:
            await cluster.close()
    asyncio.run(main())


# ------------------------------------- cluster and tracking cells


@pytest.mark.parametrize("name", CLUSTER_CELLS + TRACKING_CELLS)
def test_cluster_and_tracking_cells_certify(name):
    cell = Cell(cluster=name) if name in CLUSTER_CELLS else \
        Cell(tracking=name)
    stats = run_scenario(certify_scenario(7, cell))
    if name in CLUSTER_CELLS:
        assert stats["redirects"] > 0 and stats["journal_ops"] > 0
    else:
        assert stats["nc_hits"] > 0


def test_cli_lists_the_matrix_and_runs_a_cell_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "constdb_tpu_torch.chaos", "--list"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [c.name for c in matrix_cells()]
    out = subprocess.run(
        [sys.executable, "-m", "constdb_tpu_torch.chaos", "--device", "cpu",
         "--cells", "wire1-delta1-comp1-shards1-torch-resident", "--ops",
         "12"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "1/1 cells green" in out.stdout
