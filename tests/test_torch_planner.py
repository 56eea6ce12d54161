"""The native round planner (constdb_tpu_torch/native/planner.cpp, driven by
TorchMergeEngine.merge_stream) on the steady path of a resident engine on
the CPU, held against two oracles on the same frames:

  * the port's Python micro round (the same engine with the planner
    bypassed): identical host columns, side lists, native tables, counter
    rank index, resident planes, src planes, dirty rows, value pool and
    stats after every landing;
  * the JAX package's Node and CoalescingApplier with the same batch
    bounds: equal `canonical()` after the final flush.

The cases cover repeated keys and members in one batch (the fold's ties),
new keys and members, type conflicts, counter deletes (base pairs, several
and new counter nodes), the element key-delete rule across two links,
key-level deletes riding the batch, a rejected row that must leave the
tables unchanged, the reference's mixed stream with every barrier class,
and a REPLBATCH payload (the planner's columnar reader).  Then
check-then-mutate: a batch that fails validation leaves the keyspace as
it was."""

import random

import numpy as np
import pytest

from constdb_tpu.replica.coalesce import CoalescingApplier as RefApplier
from constdb_tpu.replica.manager import ReplicaMeta as RefMeta
from constdb_tpu.resp import message as RM
from constdb_tpu.server.node import Node as RefNode
from constdb_tpu_torch.engine.cuda import TorchMergeEngine
from constdb_tpu_torch.replica import wire as PW
from constdb_tpu_torch.replica.coalesce import BatchBuilder, CoalescingApplier
from constdb_tpu_torch.replica.manager import ReplicaMeta
from constdb_tpu_torch.resp import message as PM
from constdb_tpu_torch.server.node import Node

from test_coalesce_apply import mixed_stream
from test_torch_wire import encodable, fill_log, mixed_bodies

MS0 = 1_700_000_000_000
SEQ_BITS = 22


def u(i: int) -> int:
    return (MS0 + i) << SEQ_BITS


def steady_node(node_id: int = 1, planned: bool = True) -> Node:
    """A node on the steady resident engine; `planned` False bypasses the
    planner, so every landing takes the Python micro round."""
    eng = TorchMergeEngine(device="cpu", resident=True, steady=True,
                           warmup=0)
    if not planned:
        eng.merge_stream = lambda store, src: \
            eng.merge_many(store, [src.finalize()])
    return Node(node_id=node_id, engine=eng)


def items(M, origin: int, prev: int, uuid: int, name: bytes, args) -> list:
    return [M.Bulk(b"replicate"), M.Int(origin), M.Int(prev), M.Int(uuid),
            M.Bulk(name)] + [M.Int(a) if isinstance(a, int) else M.Bulk(a)
                             for a in args]


# --------------------------------------------------------------- the cases
# A case is (links, steps, max_frames[, dense floor]): steps are (link,
# uuid, name, args) fed in order to one applier per link (origin =
# links[link]); the floor, where given, replaces the port keyspace's
# CNT_WINDOW_DENSE_FLOOR.


def _auto(bodies):
    """One link's steps, uuids rising frame by frame."""
    return [(0, u(i), b[0], b[1:]) for i, b in enumerate(bodies, 1)]


def case_repeats():
    """Few keys hit many times in a batch; duplicate members and fields
    inside one frame (equal (add_t, node): the later row wins)."""
    rng = random.Random(5)
    out = []
    for i in range(1, 401):
        k = rng.randrange(4)
        r = rng.random()
        if r < 0.25:
            body = (b"set", b"r%d" % k, b"v%d" % i)
        elif r < 0.5:
            body = (b"cntset", b"c%d" % k, rng.randrange(-30, 30))
        elif r < 0.7:
            m = b"m%d" % rng.randrange(3)
            body = (b"sadd", b"s%d" % k, m, m, b"m%d" % rng.randrange(3))
        elif r < 0.9:
            f = b"f%d" % rng.randrange(2)
            body = (b"hset", b"h%d" % k, f, b"a%d" % i, f, b"b%d" % i)
        else:
            body = (b"srem", b"s%d" % k, b"m%d" % rng.randrange(3))
        out.append(body)
    return [7], _auto(out), 64


def case_fresh():
    """Every frame a new key, new members and fields."""
    out = []
    for i in range(1, 301):
        r = i % 4
        if r == 0:
            out.append((b"set", b"nr%04d" % i, b"v%d" % i))
        elif r == 1:
            out.append((b"cntset", b"nc%04d" % i, i))
        elif r == 2:
            out.append((b"sadd", b"ns%04d" % i, b"x%d" % i, b"y%d" % i))
        else:
            out.append((b"hset", b"nh%04d" % i, b"f%d" % i, b"v%d" % i))
    return [7], _auto(out), 100


def case_conflicts():
    """Keys written under several types, in one batch and across
    batches: the later type's rows are rejected."""
    rng = random.Random(9)
    out = []
    for i in range(1, 301):
        k = b"x%02d" % rng.randrange(12)
        r = rng.random()
        if r < 0.3:
            out.append((b"set", k, b"v%d" % i))
        elif r < 0.55:
            out.append((b"cntset", k, rng.randrange(-9, 9)))
        elif r < 0.8:
            out.append((b"sadd", k, b"m%d" % i, b"m%d" % (i % 5)))
        else:
            out.append((b"hset", k, b"f%d" % (i % 3), b"v%d" % i))
    return [7], _auto(out), 32


def case_counter_deletes():
    """Counter totals and deletes whose base pairs name several counter
    nodes, some the node has never ranked."""
    rng = random.Random(13)
    out = []
    for i in range(1, 301):
        k = b"c%02d" % rng.randrange(10)
        if rng.random() < 0.6:
            out.append((b"cntset", k, rng.randrange(-50, 50)))
        else:
            pairs = []
            for nd in rng.sample((7, 11, 13, 4242, 99991), 3):
                pairs += [nd, rng.randrange(50)]
            out.append((b"delcnt", k, *pairs))
    return [7], _auto(out), 48


def case_sparse_counters():
    """Counter keys spread thin over many keys, under a lowered dense
    floor: their ranks' kid -> row indexes turn into hashes, and later
    slots land in the hash; other ranks' windows grow as keys arrive."""
    out = []
    for i in range(1, 2401):
        if i % 30 == 0:
            out.append((b"cntset", b"c%05d" % i, i))
        elif i % 30 == 15:
            out.append((b"delcnt", b"c%05d" % (i - 15), 3, i, 9, 2 * i))
        else:
            out.append((b"set", b"r%05d" % i, b"v"))
    for i in range(30, 2401, 30):
        out.append((b"cntset", b"c%05d" % i, -i))
    return [7], _auto(out), 128, 1024


def case_key_delete_rule():
    """Link A's element adds wait in its batch while link B's delsets,
    deldicts and delbytes with later uuids land first: A's adds that
    predate their key's delete land tombstoned."""
    steps = []
    rng = random.Random(17)
    for rnd in range(4):
        base = rnd * 1000
        keys = [b"s%d_%d" % (rnd, j) for j in range(6)]
        hkeys = [b"h%d_%d" % (rnd, j) for j in range(3)]
        for j in range(40):
            i = base + 100 + j
            if j % 3:
                steps.append((0, u(i), b"sadd",
                              (rng.choice(keys), b"m%d" % (j % 7))))
            else:
                steps.append((0, u(i), b"hset",
                              (rng.choice(hkeys), b"f%d" % (j % 4),
                               b"v%d" % i)))
        for j, k in enumerate(keys):
            steps.append((1, u(base + 500 + 2 * j), b"sadd", (k, b"z")))
            if j % 2:
                steps.append((1, u(base + 501 + 2 * j), b"delset", (k,)))
        for j, k in enumerate(hkeys):
            steps.append((1, u(base + 600 + j), b"deldict", (k,)))
        steps.append((1, u(base + 700), b"set", (b"r%d" % rnd, b"v")))
        steps.append((1, u(base + 701), b"delbytes", (b"r%d" % rnd,)))
    # each link's uuids must rise along its own stream
    return [3, 5], steps, 64


def case_rejected():
    """An element row of a key held as a counter: rejected, so none of its
    members is interned and no element row is made."""
    out = [(b"cntset", b"q", 5), (b"sadd", b"s", b"m0")]
    for i in range(3, 40):
        out.append((b"sadd", b"q", b"never%d" % i) if i % 4 == 0
                   else (b"sadd", b"s", b"m%d" % (i % 6)))
    return [7], _auto(out), 16


def case_mixed():
    """The reference's mixed stream: every encodable command and every
    barrier class."""
    frames, _ = mixed_stream(1200, seed=23)
    steps = []
    for f in frames:
        args = [a.val for a in f[5:]]
        steps.append((0, f[3].val, f[4].val, args))
    return [7], steps, 128


CASES = {"repeats": case_repeats, "fresh": case_fresh,
         "conflicts": case_conflicts,
         "counter_deletes": case_counter_deletes,
         "sparse_counters": case_sparse_counters,
         "key_delete_rule": case_key_delete_rule,
         "rejected": case_rejected, "mixed": case_mixed}


def drive(node, case, M=PM, applier=CoalescingApplier, meta=ReplicaMeta,
          on_land=None):
    """Feed a case's steps; `on_land` after every landing of the node."""
    links, steps, max_frames = case[:3]
    if len(case) > 3 and M is PM:
        node.ks.CNT_WINDOW_DENSE_FLOOR = case[3]
    if on_land is not None:
        real = node.merge_stream_batch

        def landing(b, frames):
            real(b, frames)
            on_land()
        node.merge_stream_batch = landing
    aps = [applier(node, meta(f"peer{o}:1"), max_frames=max_frames,
                   max_latency=999.0) for o in links]
    prev = [0] * len(links)
    for link, uuid, name, args in steps:
        aps[link].apply(items(M, links[link], prev[link], uuid, name, args))
        prev[link] = uuid
    for ap in aps:
        ap.flush()
    return node


# ------------------------------------------------------------- the states


def tables(ks) -> dict:
    """The keyspace's native tables, read through every id they hold."""
    keys = list(ks.key_bytes)
    members = [ks.member_index.bytes_of(i)
               for i in range(len(ks.member_index))]
    el_mid = ks.member_index.lookup_batch(list(ks.el_member))
    combos = (ks.el.kid.astype(np.int64) << ks.MEMBER_BITS) | el_mid
    ranks = {}
    for node, rank in ks.node_rank.items():
        kids = ks.cnt.kid[ks.cnt.node == node]
        ranks[node] = (rank, ks.cnt_rows_lookup(rank, kids).tolist(),
                       "hash" if rank in ks.cnt_rank_hash else "window")
    return {"key_ids": ks.key_index.lookup_batch(keys).tolist(),
            "n_key_ids": len(ks.key_index), "members": members,
            "el_rows": ks.el_index.lookup_batch(combos).tolist(),
            "n_el_index": len(ks.el_index), "ranks": ranks,
            "windows": {r: (b, a.tolist())
                        for r, (b, a) in ks.cnt_rank_rows.items()},
            "live": dict(ks.cnt_rank_live), "node_ids": list(ks.node_ids)}


def host(ks) -> dict:
    out = {}
    for name, cols in (("keys", ks.keys), ("cnt", ks.cnt), ("el", ks.el)):
        for c in cols._spec:
            out[f"{name}.{c}"] = cols.col(c).tolist()
    out.update(key_bytes=list(ks.key_bytes), reg_val=list(ks.reg_val),
               el_member=list(ks.el_member), el_val=list(ks.el_val),
               key_deletes=dict(ks.key_deletes),
               garbage=sorted(ks.garbage), blob_bytes=ks.blob_bytes)
    return out


def device(eng) -> dict:
    out = {}
    for fam, res in eng._res.items():
        for c, t in res["cols"].items():
            out[f"{fam}.{c}"] = t[:res["n"]].tolist()
        src = res.get("src")
        out[f"{fam}.src"] = None if src is None else src[:res["n"]].tolist()
        dirty = res.get("dirty")
        out[f"{fam}.dirty"] = None if dirty is None \
            else np.flatnonzero(dirty).tolist()
        out[f"{fam}.written"] = sorted(res["written"])
        out[f"{fam}.recon"] = res.get("recon")
    out["pool"] = [(b, v, {k: np.asarray(a).tolist() for k, a in c.items()})
                   for b, v, c in eng._val_pool]
    out.update(pool_size=eng._pool_size, pool_bytes=eng._pool_bytes,
               del_touched=[np.asarray(a).tolist()
                            for a in eng._el_del_touched],
               micro_rows={f: list(v) for f, v in eng.micro_rows.items()},
               micro_rounds={f: list(v)
                             for f, v in eng.micro_rounds.items()},
               dev_rounds=eng.dev_rounds_resident,
               needs_flush=eng.needs_flush)
    return out


def state(node) -> dict:
    ks = node.ks
    return {"host": host(ks), "tables": tables(ks),
            "device": device(node.engine),
            "stats": (node.stats.merges, node.stats.merge_rows,
                      node.stats.repl_frames_coalesced)}


def assert_same(a: dict, b: dict, where: str) -> None:
    for part in a:
        if a[part] != b[part]:
            for k in a[part] if isinstance(a[part], dict) else (None,):
                x = a[part] if k is None else a[part][k]
                y = b[part] if k is None else b[part].get(k)
                assert x == y, f"{where}: {part}.{k} differs"
            assert a[part] == b[part], f"{where}: {part} differs"


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("name", sorted(CASES))
def test_planner_equals_python_micro_path(name):
    """Landing by landing, the planner leaves what the Python micro round
    leaves: host tables, native tables, resident planes, src ids, dirty
    rows and the value pool; then the same flushed keyspace."""
    case = CASES[name]()
    planned = steady_node(1)
    python = steady_node(1, planned=False)
    seen = []
    drive(planned, case, on_land=lambda: seen.append(state(planned)))
    i = iter(range(len(seen)))

    def check():
        k = next(i)
        assert_same(seen[k], state(python), f"{name} landing {k}")
    drive(python, case, on_land=check)
    assert next(i, None) is None
    assert_same(state(planned), state(python), f"{name} end")
    eng = planned.engine
    assert eng.spans.value("engine.micro_planned") == len(seen) > 0
    assert not any(k.startswith("engine.micro_python")
                   for k in eng.spans.counters)
    planned.ensure_flushed()
    python.ensure_flushed()
    assert planned.canonical() == python.canonical()
    assert_same(state(planned), state(python), f"{name} flushed")


@pytest.mark.parametrize("name", sorted(CASES))
def test_planner_equals_reference_node(name):
    """The planned node against the JAX package's node and applier fed the
    same frames under the same batch bounds."""
    case = CASES[name]()
    node = drive(steady_node(1), case)
    ref = drive(RefNode(node_id=1), case, M=RM, applier=RefApplier,
                meta=RefMeta)
    assert node.canonical() == ref.canonical()
    assert node.engine.spans.value("engine.micro_planned") > 0
    if name == "rejected":
        ks = node.ks
        assert ks.member_index.lookup_batch(
            [b"never%d" % i for i in range(3, 40, 4)]).max() == -1
        assert not any(m.startswith(b"never") for m in ks.el_member)
    if name == "key_delete_rule":
        ks = node.ks
        kid = ks.lookup(b"s0_1")
        dead = [m for m, at, _n, dlt, _v in ks.elem_all(kid) if dlt > at]
        assert dead   # an add older than its key's delete landed dead


def wire_payload():
    bodies = [b for b in encodable(mixed_bodies(500, seed=29))
              if b[0] not in (b"tset", b"deltensor")]
    entries = fill_log(steady_node(7), bodies, PM)
    r_entries = fill_log(RefNode(node_id=7), bodies, RM)
    return entries, PW.build_wire_batch(entries, 7), r_entries


def land_wire(node, entries, payload, M=PM, applier=CoalescingApplier,
              meta=ReplicaMeta):
    ap = applier(node, meta("peer:1"), max_frames=64)
    ap.apply_wire_batch([M.Bulk(b"replbatch"), M.Int(7),
                         M.Int(entries[0].prev_uuid),
                         M.Int(entries[-1].uuid), M.Int(len(entries)),
                         M.Bulk(payload)])
    return node


def test_wire_batch_planned_equals_python_and_reference():
    """A REPLBATCH payload lands through the planner's columnar reader as
    the Python micro round lands it, and as the reference's receiver."""
    entries, payload, r_entries = wire_payload()
    assert payload is not None
    planned = land_wire(steady_node(2), entries, payload)
    python = land_wire(steady_node(2, planned=False), entries, payload)
    assert planned.engine.spans.value("engine.micro_planned") == 1
    assert_same(state(planned), state(python), "wire")
    ref = land_wire(RefNode(node_id=2), r_entries,
                    PW.build_wire_batch(entries, 7), M=RM,
                    applier=RefApplier, meta=RefMeta)
    assert planned.canonical() == ref.canonical()


def _builder(node, with_bad_member: bool):
    bb = BatchBuilder(node.ks)
    ki0 = bb.add_keys([b"a", b"b", b"s"], 3, [u(1), u(2), u(3)])
    bb.reg_run(ki0, [u(1), u(2)], [7, 7], [b"x", b"y"])
    bb.enc[2] = 5
    member = "not bytes" if with_bad_member else b"m"
    bb.el_rows.append((ki0 + 2, [b"m0", member], None, u(3), 7, 0, True))
    bb.n_rows += 2
    return bb


def test_a_batch_that_fails_validation_changes_nothing():
    """Check-then-mutate: a member that is not bytes fails the whole
    landing before any table or column changes; the same batch with a
    good member then lands."""
    node = steady_node(1)
    drive(node, CASES["repeats"]())
    before = state(node)
    with pytest.raises(TypeError):
        node.merge_stream_batch(_builder(node, True), 1)
    after = state(node)
    after["stats"] = before["stats"]
    assert_same(before, after, "rejected batch")
    node.merge_stream_batch(_builder(node, False), 1)
    kid = node.ks.lookup(b"s")
    assert {m for m, *_ in node.ks.elem_all(kid)} == {b"m0", b"m"}
