"""The port's coalescing replication applier (constdb_tpu_torch/replica/
coalesce.py) through its Node, against the reference's: the reference
test's mixed stream (every encodable command, every barrier class)
through the port's applier over CpuMergeEngine and over the resident
steady TorchMergeEngine on the CPU lands byte-identically to the
reference's per-frame and coalesced nodes (the coalesced one on
TpuMergeEngine(resident=True, dense_fold="xla"); its Pallas-interpret
folds fail in this JAX, ROADMAP queue 3).  Then the applier's delivery
rules, each against the reference's behaviour: a barrier on a key whose
rows are resident on the device, the scoped-barrier skip, the watermark
after land, duplicates and gaps, the latency bound on a fake clock and a
malformed frame raising the same op error."""

import numpy as np
import pytest

from constdb_tpu.errors import WrongArity as RefWrongArity
from constdb_tpu.replica.coalesce import CoalescingApplier as RefApplier
from constdb_tpu.replica.manager import ReplicaMeta as RefMeta
from constdb_tpu.server.node import Node as RefNode
from constdb_tpu_torch import workload as W
from constdb_tpu_torch.engine.cpu import CpuMergeEngine
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.errors import ReplicateCommandsLost, WrongArity
from constdb_tpu_torch.ops import kernels as KN
from constdb_tpu_torch.replica.coalesce import CoalescingApplier
from constdb_tpu_torch.replica.manager import ReplicaMeta
from constdb_tpu_torch.resp import message as PM
from constdb_tpu_torch.server.node import Node

from test_coalesce_apply import frame as ref_frame
from test_coalesce_apply import mixed_stream, u

ENGINES = ("cpu", "torch")


def engine(kind: str):
    if kind == "cpu":
        return CpuMergeEngine()
    return TorchMergeEngine(device="cpu", resident=True, steady=True,
                            warmup=0)


def to_port(items) -> list:
    """A reference frame's items as the port's message objects."""
    return [PM.Int(x.val) if type(x).__name__ == "Int" else PM.Bulk(x.val)
            for x in items]


def frame(prev: int, uuid: int, name: bytes, *args) -> list:
    return to_port(ref_frame(prev, uuid, name, *args))


def drive(node, frames, max_frames=64, max_latency=999.0,
          applier=CoalescingApplier, meta=ReplicaMeta):
    ap = applier(node, meta("peer:1"), max_frames=max_frames,
                 max_latency=max_latency)
    for f in frames:
        ap.apply(f)
    ap.flush()
    return ap


@pytest.fixture(scope="module")
def reference_states():
    """The reference's per-frame node and its coalesced node on the XLA
    resident engine, over the mixed stream."""
    from constdb_tpu.engine.tpu import TpuMergeEngine

    frames, last = mixed_stream(1500, seed=11)
    per = RefNode(node_id=2)
    drive(per, frames, max_frames=1, applier=RefApplier, meta=RefMeta)
    co = RefNode(node_id=1, engine=TpuMergeEngine(resident=True,
                                                  dense_fold="xla"))
    drive(co, frames, max_frames=128, applier=RefApplier, meta=RefMeta)
    return frames, last, per, co


@pytest.mark.parametrize("kind", ENGINES)
def test_mixed_stream_equals_reference(reference_states, kind):
    frames, last, ref_per, ref_co = reference_states
    want = ref_per.canonical()
    assert ref_co.canonical() == want
    pframes = [to_port(f) for f in frames]
    node = Node(node_id=1, engine=engine(kind))
    ap = drive(node, pframes, max_frames=128)
    assert node.canonical() == want
    assert ap.meta.uuid_he_sent == last
    per = Node(node_id=2, engine=engine(kind))
    drive(per, pframes, max_frames=1)
    assert per.canonical() == want
    # the same delivery accounting as the reference's coalesced node
    for k in ("cmds_replicated", "repl_apply_barriers",
              "repl_frames_coalesced", "repl_coalesce_flushes"):
        assert getattr(node.stats, k) == getattr(ref_co.stats, k), k
    assert per.stats.repl_apply_barriers == len(frames)
    assert per.stats.merges == 0
    # GC at the same horizon frees the same entries either way
    horizon = last + (1 << 22)
    assert node.ks.gc(horizon) == per.ks.gc(horizon) > 0
    assert node.canonical() == per.canonical()
    if kind == "torch":
        eng = node.engine
        assert eng.dev_rounds_resident > 0 and not eng.host_micro_rounds


def _barrier_on_a_resident_key(monkeypatch, warmup):
    """A key's set rows resident on the device, a `delset` barrier on
    that key from link A (it flushes, then writes the members' del_t on
    the host between rounds), then a second link's `srem` of one of those
    members with an older uuid, landed as its own round, and more `sadd`s:
    the state equals the per-frame path's and the reference's.  The
    barrier's writes are confined to its key, so the rounds after it
    patch that key's rows into the element mirror instead of rebuilding
    it, and the element rows stay on the device past the warm-up.  The
    flush's max with the host's del_t would hide a stale mirror's
    pre-delete del_t in the state, so the mirror itself is held to the
    host columns."""
    rounds = []
    real = KN.scatter_round
    monkeypatch.setattr(KN, "scatter_round",
                        lambda segs: (rounds.append(len(segs)),
                                      real(segs))[1])
    events = []          # (link, name, args, uuid)
    i = 0
    for r in range(3):
        for m in range(6):
            i += 1
            events.append(("a", b"sadd", (b"s1", b"m%d" % (m + r)), u(i)))
            i += 1
            events.append(("a", b"sadd", (b"s2", b"m%d" % m), u(i)))
        i += 1
        events.append(("a", b"delset", (b"s1",), u(i)))
        # older than the delete: per frame its del_t loses to the dt
        events.append(("b", b"srem", (b"s1", b"m%d" % (r + 2)), u(i) - 1))
        i += 1
        events.append(("a", b"srem", (b"s2", b"m%d" % r), u(i)))

    def run(node, max_frames, A, M, mk):
        links = {k: A(node, M(f"{k}:1"), max_frames=max_frames,
                      max_latency=999.0) for k in "ab"}
        prev = dict.fromkeys("ab", 0)
        for link, name, args, uuid in events:
            ap = links[link]
            ap.apply(mk(prev[link], uuid, name, *args))
            prev[link] = uuid
            if link == "b":
                ap.flush()     # the pull loop's idle flush: its own round
        for ap in links.values():
            ap.flush()
        return node

    eng = TorchMergeEngine(device="cpu", resident=True, steady=True,
                           warmup=warmup)
    node = Node(node_id=1, engine=eng)
    run(node, 100, CoalescingApplier, ReplicaMeta, frame)
    assert eng.dev_rounds_resident >= 6 - eng.warmup
    assert len(rounds) == eng.dev_rounds_resident
    # every delset after the mirror's first build patches it: all three
    # at warm-up 0, the last two at 2 (the first lands on the host twin)
    assert eng.mirror_patches["el"] == (3 if eng.warmup == 0 else 2)
    assert not eng.mirror_rebuilds["el"]
    assert eng.micro_rounds["el"][0] == eng.warmup
    node.ensure_flushed()
    res, el = eng._res["el"], node.ks.el
    for c in ("add_t", "add_node", "del_t"):
        assert np.array_equal(res["cols"][c][:el.n].numpy(), el.col(c)[:el.n])
    per = run(Node(node_id=2, engine=CpuMergeEngine()), 1,
              CoalescingApplier, ReplicaMeta, frame)
    ref = run(RefNode(node_id=2), 1, RefApplier, RefMeta, ref_frame)
    assert node.canonical() == per.canonical() == ref.canonical()
    last_del = max(e[3] for e in events if e[1] == b"delset")
    assert int(node.ks.keys.dt[node.ks.lookup(b"s1")]) == last_del


def test_barrier_on_a_resident_key(monkeypatch):
    _barrier_on_a_resident_key(monkeypatch, warmup=0)


def test_barrier_on_a_resident_key_at_default_warmup(monkeypatch):
    """The same at the card's warm-up (CONSTDB_TORCH_RESIDENT_WARMUP's
    default): only the first rounds merge elements on the host."""
    monkeypatch.delenv("CONSTDB_TORCH_RESIDENT_WARMUP", raising=False)
    _barrier_on_a_resident_key(monkeypatch, warmup=None)


def test_mirror_patch_after_key_confined_writes():
    """Every plane's mirror patches exactly the rows of the keys that
    key-confined writes touched (KeySpace.touch_key) and equals its host
    columns after; a whole-plane bump in between forces a rebuild."""
    from constdb_tpu_torch.engine.cuda import _FAMILIES, _host_table

    node = Node(node_id=1, engine=engine("torch"))
    ks, eng = node.ks, node.engine
    for k in range(3):
        for cmd in ((b"set", b"r%d" % k, b"v"), (b"incr", b"c%d" % k),
                    (b"sadd", b"s%d" % k, b"m1", b"m2")):
            node.execute(PM.Arr([PM.Bulk(x) for x in cmd]))

    def mirror_equals_host():
        for fam, spec in _FAMILIES.items():
            table = _host_table(ks, fam)
            cols, _ = eng._resident_state(ks, fam, table.n)
            for i, (c, _) in enumerate(spec):
                dev = cols["stack"][:, i] if fam == "env" else cols[c]
                assert np.array_equal(dev[:table.n].numpy(),
                                      table.col(c)[:table.n]), (fam, c)

    mirror_equals_host()
    s1, r1, c1 = (ks.lookup(k) for k in (b"s1", b"r1", b"c1"))
    ks.elem_rem(s1, b"m1", u(50))
    ks.elem_rem(s1, b"m9", u(51))          # a new tombstone row
    ks.keys.dt[s1] = u(51)
    ks.touch_key(s1, "env", "el")
    ks.keys.rv_t[r1] = u(52)
    ks.touch_key(r1, "reg")
    ks.counter_change(c1, 1, 5, u(53))
    ks.touch_key(c1, "cnt")
    mirror_equals_host()
    assert eng.mirror_patches == {"env": 1, "reg": 1, "cnt": 1, "el": 1,
                                  "tns": 0}
    assert not any(eng.mirror_rebuilds.values())
    ks.elem_rem(s1, b"m2", u(54))
    ks.touch_key(s1, "el")
    ks.touch("el")
    mirror_equals_host()
    assert eng.mirror_rebuilds["el"] == 1 and eng.mirror_patches["el"] == 1


@pytest.mark.parametrize("kind", ENGINES)
def test_scoped_barrier_skips_the_flush(kind):
    node = Node(node_id=1, engine=engine(kind))
    ap = CoalescingApplier(node, ReplicaMeta("p:1"), max_frames=100,
                           max_latency=999.0)
    ap.apply(frame(0, u(1), b"sadd", b"s1", b"m"))
    # a delset of a key the batch does not touch applies in place; the
    # batch stays pending and the watermark stays put
    ap.apply(frame(u(1), u(2), b"delset", b"zzz"))
    assert ap.pending == 1 and node.stats.merges == 0
    assert node.stats.repl_apply_barriers == 1
    assert ap.meta.uuid_he_sent == 0
    # membership is state-free: no flush either
    ap.apply(frame(u(2), u(3), b"meet", b"10.0.0.1:7001"))
    assert ap.pending == 1 and node.stats.merges == 0
    assert node.replicas.get("10.0.0.1:7001") is not None
    # a delset of the pending key flushes first
    ap.apply(frame(u(3), u(4), b"delset", b"s1"))
    assert ap.pending == 0 and node.stats.merges == 1
    assert ap.meta.uuid_he_sent == u(4)
    assert int(node.ks.keys.dt[node.ks.lookup(b"s1")]) == u(4)


@pytest.mark.parametrize("kind", ENGINES)
def test_watermark_after_land(kind):
    node = Node(node_id=1, engine=engine(kind))
    meta = ReplicaMeta("p:1")
    ap = CoalescingApplier(node, meta, max_frames=100, max_latency=999.0)
    for i in range(1, 6):
        ap.apply(frame(u(i - 1) if i > 1 else 0, u(i), b"set",
                       b"k%d" % i, b"v"))
    assert ap.pending == 5 and meta.uuid_he_sent == 0
    assert ap.cursor == u(5)
    ap.observe_beacon(u(9))        # stashed: frames are pending
    assert meta.uuid_he_sent == 0
    ap.flush()
    assert meta.uuid_he_sent == u(9)
    assert node.ks.lookup(b"k5") >= 0
    ap.observe_beacon(u(12))       # nothing pending: advances at once
    assert meta.uuid_he_sent == u(12)


@pytest.mark.parametrize("kind", ENGINES)
def test_dup_skip_and_gap(kind):
    node = Node(node_id=1, engine=engine(kind))
    ap = CoalescingApplier(node, ReplicaMeta("p:1"), max_frames=100,
                           max_latency=999.0)
    f1 = frame(0, u(1), b"set", b"k", b"v1")
    ap.apply(f1)
    ap.apply(f1)
    assert ap.pending == 1
    with pytest.raises(ReplicateCommandsLost):
        ap.apply(frame(u(7), u(8), b"set", b"k", b"v2"))
    assert ap.meta.uuid_he_sent == u(1)
    assert node.ks.lookup(b"k") >= 0


def test_latency_bound_on_a_fake_clock():
    clock = [0.0]
    node = Node(node_id=1, engine=engine("torch"))
    ap = CoalescingApplier(node, ReplicaMeta("p:1"), max_frames=1 << 30,
                           max_latency=0.005, now=lambda: clock[0])
    ap.apply(frame(0, u(1), b"set", b"k1", b"v"))
    clock[0] = 0.050
    prev = u(1)
    for i in range(2, 40):
        ap.apply(frame(prev, u(i), b"set", b"k%d" % i, b"v"))
        prev = u(i)
    # the bound is sampled every 32 frames: it fired at frame 32
    assert node.stats.repl_coalesce_flushes == 1
    assert ap.meta.uuid_he_sent == u(32)
    assert ap.pending == 39 - 32


def test_frame_log_is_the_bench_log():
    """workload.make_frame_log is bench.py make_frame_log draw for draw:
    the same RESP bytes, the collection DELs included."""
    import bench
    from constdb_tpu.resp.codec import encode_msg
    from constdb_tpu.resp.message import Arr

    want = b"".join(encode_msg(Arr(f)) for f in bench.make_frame_log(4000,
                                                                    300))
    got = W.frame_log_bytes(W.make_frame_log(4000, 300))
    assert got == want and b"delset" in got


def test_replay_stream_latencies_on_a_fake_clock():
    """workload.replay_stream drives the applier with the injected clock:
    a clock that never moves lands batches only at the count bound, and
    every sampled latency is 0."""
    frames = W.make_frame_log(3000, 200)
    data = W.frame_log_bytes(frames)
    node = Node(node_id=1, engine=engine("torch"))
    ap, wall, lat = W.replay_stream(data, node, 256, 0.005, now=lambda: 1.0)
    assert wall == 0.0 and lat and set(lat) == {0.0}
    assert ap.meta.uuid_he_sent == frames[-1][3].val
    assert node.stats.repl_apply_barriers == \
        sum(f[4].val == b"delset" for f in frames)
    oracle = Node(node_id=1, engine=CpuMergeEngine())
    W.replay_stream(data, oracle, 1, 0.005)
    assert node.canonical() == oracle.canonical()


def test_malformed_frame_raises_the_same_op_error():
    """An arity-broken frame inside a run: every other frame lands and
    the bad one raises the op path's error at flush, as in the
    reference."""
    bodies = [(b"sadd", b"s1", b"m1"), (b"sadd", b"s2"),
              (b"sadd", b"s3", b"m3")]
    errs = []
    for A, M, N, mk, kw in (
            (CoalescingApplier, ReplicaMeta, Node, frame,
             {"engine": engine("torch")}),
            (RefApplier, RefMeta, RefNode, ref_frame, {})):
        node = N(node_id=1, **kw)
        ap = A(node, M("p:1"), max_frames=100, max_latency=999.0)
        prev = 0
        for i, body in enumerate(bodies, 1):
            ap.apply(mk(prev, u(i), *body))
            prev = u(i)
        with pytest.raises((WrongArity, RefWrongArity)) as ei:
            ap.flush()
        errs.append((type(ei.value).__name__, str(ei.value)))
        assert node.ks.lookup(b"s1") >= 0 and node.ks.lookup(b"s3") >= 0
        assert ap.meta.uuid_he_sent == 0
    assert errs[0] == errs[1]
