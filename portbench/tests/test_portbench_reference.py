"""The reference: it imports nothing of the program, agrees with the port's
CPU engine and per-operation path at small sizes, and its control (one
guarantee broken) fails the comparison."""

import ast
import json

import numpy as np
import pytest

from portbench import control, gen
from portbench.readout import keyspace_state
from portbench.reference import compare, join, replay
from portbench.tests.helpers import REPO, SMALL, cells, small_root

CONFIGS = {n: json.loads((REPO / "portbench" / "configs" / f"{n}.json")
                         .read_text()) for n in ("mixed-r8", "hash-r8")}
MIX = json.loads((REPO / "portbench" / "traffic" / "stream.json").read_text())
FORBIDDEN = {"constdb_tpu_torch", "constdb_tpu", "jax", "jaxlib", "flax"}


def test_reference_imports_nothing_of_the_program():
    for path in sorted((REPO / "portbench" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.mark.parametrize("name", ["mixed-r8", "hash-r8"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_join_equals_the_ports_cpu_engine(name, seed):
    from constdb_tpu_torch.engine.cpu import CpuMergeEngine
    from constdb_tpu_torch.store.keyspace import KeySpace

    from portbench import feed

    cfg = dict(CONFIGS[name], **SMALL[CONFIGS[name]["shape"]])
    snap = gen.snapshots(cfg, seed)
    store, eng = KeySpace(), CpuMergeEngine()
    for b in feed.replica_batches(snap):
        eng.merge(store, b)
    got = keyspace_state(store)
    assert compare.compare(got, join.snapshot_join(snap)) == \
        dict.fromkeys(compare.FAMILIES, 0)


@pytest.mark.parametrize("seed", [4, 2 ** 32 + 1])
def test_replay_equals_the_ports_per_operation_path(seed):
    """Every frame through Node.apply_replicated (the port's exact
    per-key path, CPU engine), peers interleaved frame by frame."""
    from constdb_tpu_torch.engine.cpu import CpuMergeEngine
    from constdb_tpu_torch.resp.codec import make_parser
    from constdb_tpu_torch.resp.message import as_bytes, as_int
    from constdb_tpu_torch.server.node import Node

    node = Node(node_id=1, engine=CpuMergeEngine())
    peers, msgs = [], []
    for p in range(3):
        ops = gen.peer_ops(MIX, 4000, [seed, p])
        data, _end = gen.encode_frames(ops, MIX, p + 2)
        parser = make_parser()
        parser.feed(data)
        out = []
        while (m := parser.next_msg()) is not None:
            out.append(m.items)
        peers.append((p + 2, ops))
        msgs.append(out)
    for f in range(4000):
        for items in (m[f] for m in msgs):
            node.apply_replicated(as_bytes(items[4]), items[5:],
                                  as_int(items[1]), as_int(items[3]))
    got = keyspace_state(node.ks)
    assert compare.compare(got, replay.stream_replay(peers, MIX)) == \
        dict.fromkeys(compare.FAMILIES, 0)


def test_rem_only_member_delete_time_is_a_range():
    """A member no frame added: its delete time may lie anywhere from its
    own removes' latest to the key's latest delset, and nowhere else."""
    want = {"e_add_t": np.array([0]), "e_del_t": np.array([10]),
            "e_del_hi": np.array([20])}

    def rows(dt):
        got = {"e_add_t": np.array([0]), "e_del_t": np.array([dt])}
        return compare._rows(np.array([0]), np.array([1]), got,
                             np.array([0]), np.array([1]), want, (),
                             del_range=True)
    assert [rows(d) for d in (9, 10, 15, 20, 21)] == [1, 0, 0, 0, 1]


@pytest.mark.parametrize("workload", cells())
def test_control_fails_the_comparison(workload, tmp_path):
    root = small_root(tmp_path)
    for seed in (1, 2, 3):
        r = control.readings(root, workload, seed, frames_per_peer=3000)
        assert sum(r.values()) > 0, r
