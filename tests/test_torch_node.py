"""The port's Node and command table (constdb_tpu_torch/server/) against
the reference's: one scripted command stream through `execute` (client
commands) and `apply_replicated` (a peer's ops), on nodes with the same
fixed clock, gives byte-equal replies, equal repl_log entries and equal
canonical() in both packages, with the port's node over CpuMergeEngine
and over the resident steady TorchMergeEngine on the CPU.  Also: `Node()`
with no engine builds the resident engine on `device` and raises without
a card."""

import numpy as np
import pytest
import torch

from constdb_tpu.resp import codec as RC
from constdb_tpu.resp import message as RM
from constdb_tpu.server import commands as ref_commands
from constdb_tpu.server.node import Node as RefNode
from constdb_tpu_torch.engine.cpu import CpuMergeEngine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.resp import codec as PC
from constdb_tpu_torch.resp import message as PM
from constdb_tpu_torch.server import commands as port_commands
from constdb_tpu_torch.server.node import Node

MS0 = 1_700_000_000_000
SEQ_BITS = 22


def f32(*v) -> bytes:
    return np.asarray(v, dtype=np.float32).tobytes()


# (kind, name, args): kind "c" runs through execute, "r" through
# apply_replicated from origin 5 at a uuid after every local one so far
SCRIPT = [
    ("c", b"set", (b"k1", b"v1")),
    ("c", b"get", (b"k1",)),
    ("c", b"set", (b"k1", b"v2")),
    ("c", b"get", (b"k1",)),
    ("c", b"get", (b"nokey",)),
    ("c", b"incr", (b"c1",)),
    ("c", b"incr", (b"c1", b"41")),
    ("c", b"decr", (b"c1", b"2")),
    ("c", b"decr", (b"c1",)),
    ("c", b"get", (b"c1",)),
    ("c", b"cntundo", (b"c1",)),
    ("c", b"get", (b"c1",)),
    ("c", b"cntundo", (b"c1",)),
    ("c", b"cntundo", (b"nocnt",)),
    ("c", b"sadd", (b"s1", b"a", b"b", b"c")),
    ("c", b"sadd", (b"s1", b"c", b"d")),
    ("c", b"srem", (b"s1", b"a", b"zz")),
    ("c", b"smembers", (b"s1",)),
    ("c", b"scnt", (b"s1",)),
    ("c", b"sismember", (b"s1", b"b")),
    ("c", b"hset", (b"h1", b"f1", b"x", b"f2", b"y")),
    ("c", b"hset", (b"h1", b"f2", b"z")),
    ("c", b"hget", (b"h1", b"f2")),
    ("c", b"hget", (b"h1", b"nof")),
    ("c", b"hgetall", (b"h1",)),
    ("c", b"hdel", (b"h1", b"f1")),
    ("c", b"hgetall", (b"h1",)),
    ("c", b"hlen", (b"h1",)),
    ("c", b"rpush", (b"l1", b"x", b"y")),
    ("c", b"lpush", (b"l1", b"w")),
    ("c", b"lrange", (b"l1", b"0", b"-1")),
    ("c", b"llen", (b"l1",)),
    ("r", b"lins", (b"l2", b"p0100", b"one")),
    ("r", b"lins", (b"l2", b"p0200", b"two")),
    ("r", b"lins", (b"l2", b"p0150", b"mid")),
    ("c", b"lrange", (b"l2", b"0", b"-1")),
    ("r", b"lremat", (b"l2", b"p0150")),
    ("c", b"lrange", (b"l2", b"0", b"-1")),
    ("c", b"lrem", (b"l1", b"1", b"x")),
    ("c", b"lrange", (b"l1", b"0", b"-1")),
    ("c", b"mvset", (b"mv1", b"first")),
    ("c", b"mvget", (b"mv1",)),
    ("c", b"mvset", (b"mv1", b"second")),
    ("c", b"mvget", (b"mv1",)),
    ("c", b"tensor.set", (b"t1", b"sum", b"f32", b"4", f32(1, 2, 3, 4),
                          b"2")),
    ("r", b"tset", None),       # a peer's contribution to t1, below
    ("c", b"tensor.get", (b"t1",)),
    ("c", b"tensor.stat", (b"t1",)),
    ("r", b"set", (b"k2", b"peer")),
    ("r", b"cntset", (b"c2", 77)),
    ("r", b"sadd", (b"s2", b"p", b"q")),
    ("r", b"hset", (b"h2", b"f", b"v")),
    ("c", b"get", (b"k2",)),
    ("c", b"get", (b"c2",)),
    ("c", b"smembers", (b"s2",)),
    ("r", b"delset", (b"s2",)),
    ("c", b"smembers", (b"s2",)),
    ("c", b"del", (b"k1",)),
    ("c", b"get", (b"k1",)),
    ("c", b"del", (b"s1", b"h1", b"nokey")),
    ("c", b"smembers", (b"s1",)),
    ("c", b"hgetall", (b"h1",)),
    ("c", b"expire", (b"k2", b"100")),
    ("c", b"ttl", (b"k2",)),
    ("c", b"desc", (b"c1",)),
    # error replies
    ("c", b"get", ()),
    ("c", b"set", (b"k3",)),
    ("c", b"incr", (b"s2",)),
    ("c", b"get", (b"s2",)),
    ("c", b"sadd", (b"k2", b"m")),
    ("c", b"incr", (b"c1", b"notanint")),
    ("c", b"nosuchcmd", (b"x",)),
    ("c", b"lins", (b"l3", b"p", b"v")),
    ("c", b"tensor.set", (b"t2", b"sum", b"f32", b"4", b"short")),
    ("c", b"tensor.get", (b"k2",)),
    ("c", b"GET", (b"k2",)),
    ("c", b"repllog", (b"at", b"0")),
]


def run_script(node, M, encode) -> tuple:
    """-> (encoded replies, repl_log entries)."""
    from_ms = MS0 + 10_000
    replies = []
    peer_u = (from_ms << SEQ_BITS) + 1
    for kind, name, args in SCRIPT:
        if name == b"tset":
            from constdb_tpu.crdt import tensor as T
            cfg = T.pack_config(T.TensorMeta(T.STRATEGY_IDS["sum"], 0, (4,)))
            args = (b"t1", cfg, 3, f32(0.5, -1, 8, 0.25))
        items = [M.Int(a) if isinstance(a, int) else M.Bulk(a)
                 for a in args]
        if kind == "c":
            reply = node.execute(M.Arr([M.Bulk(name), *items]))
        else:
            peer_u += 1 << SEQ_BITS
            try:
                reply = node.apply_replicated(name, items, 5, peer_u)
            except Exception as e:  # noqa: BLE001 - compared by class
                reply = M.Err(f"{type(e).__name__}: {e}".encode())
        replies.append(encode(reply))
    log = [(e.uuid, e.prev_uuid, e.name,
            [encode(a) for a in e.args])
           for e in node.repl_log.run_after(0, 1 << 20)]
    return replies, log


def fixed_clock():
    return MS0


@pytest.fixture(scope="module")
def reference_run():
    """The reference node's run; its commands' wall clock (EXPIRE, TTL)
    reads the same fixed time as the port's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_commands, "now_ms", fixed_clock)
        node = RefNode(node_id=1, clock=fixed_clock)
        replies, log = run_script(node, RM, RC.encode_msg)
        return replies, log, node.canonical()


@pytest.mark.parametrize("kind", ("cpu", "torch"))
def test_script_equals_reference(reference_run, kind, monkeypatch):
    monkeypatch.setattr(port_commands, "now_ms", fixed_clock)
    eng = CpuMergeEngine() if kind == "cpu" else TorchMergeEngine(
        device="cpu", resident=True, steady=True, warmup=0)
    node = Node(node_id=1, clock=fixed_clock, engine=eng)
    replies, log = run_script(node, PM, PC.encode_msg)
    want_replies, want_log, want_state = reference_run
    for (k, name, _a), got, want in zip(SCRIPT, replies, want_replies):
        assert got == want, (k, name)
    assert len(replies) == len(want_replies)
    assert log == want_log
    assert node.canonical() == want_state
    # the script reaches errors, replies of every kind and the repl_log
    assert sum(r.startswith(b"-") for r in replies) >= 10
    assert {r[:1] for r in replies} >= {b"+", b"-", b":", b"$", b"*"}
    assert len(log) >= 20


def test_node_builds_the_resident_engine_on_its_device(monkeypatch):
    node = Node(node_id=3, device="cpu")
    eng = node.engine
    assert isinstance(eng, TorchMergeEngine)
    assert eng.resident and eng.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Node(node_id=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        Node(node_id=4, device="cuda")
