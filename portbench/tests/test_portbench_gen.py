"""The generators: the same seed gives the same inputs, the mixed shape is
the program's own generator draw for draw, and the frame stock's bytes
are the RESP the program's encoder writes for the same frames."""

import json

import numpy as np
import pytest

from portbench import gen
from portbench.tests.helpers import REPO

MIX = json.loads((REPO / "portbench" / "traffic" / "stream.json").read_text())
MIXED = json.loads((REPO / "portbench" / "configs" /
                    "mixed-r8.json").read_text())
HASH = json.loads((REPO / "portbench" / "configs" /
                   "hash-r8.json").read_text())


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
         else a[k] == b[k]) for k in a)


@pytest.mark.parametrize("cfg", [MIXED, HASH], ids=["mixed", "hash"])
def test_snapshots_are_deterministic_per_seed(cfg):
    cfg = dict(cfg, n_keys=500)
    big = 2 ** 31 + 12345
    assert _same(gen.snapshots(cfg, big), gen.snapshots(cfg, big))
    assert not np.array_equal(gen.snapshots(cfg, big)["ct"],
                              gen.snapshots(cfg, big + 1)["ct"])


def test_peer_ops_and_bytes_are_deterministic_per_seed():
    a = gen.encode_frames(gen.peer_ops(MIX, 3000, [2 ** 33, 1]), MIX, 3)
    b = gen.encode_frames(gen.peer_ops(MIX, 3000, [2 ** 33, 1]), MIX, 3)
    c = gen.encode_frames(gen.peer_ops(MIX, 3000, [2 ** 33, 2]), MIX, 3)
    assert a[0] == b[0] and np.array_equal(a[1], b[1])
    assert a[0] != c[0]


def test_mixed_shape_is_the_programs_generator_draw_for_draw():
    from constdb_tpu_torch import workload as W

    cfg = dict(MIXED, n_keys=2000)
    snap = gen.snapshots(cfg, 7)
    want = W.make_workload(2000, cfg["n_replicas"], seed=7)
    for r, b in enumerate(want):
        assert snap["keys"] == b.keys
        for mine, theirs in (("ct", "key_ct"), ("mt", "key_mt"),
                             ("dt", "key_dt"), ("reg_t", "reg_t"),
                             ("reg_node", "reg_node"), ("cnt_ki", "cnt_ki"),
                             ("cnt_node", "cnt_node"),
                             ("cnt_val", "cnt_val"), ("cnt_uuid", "cnt_uuid"),
                             ("el_add_t", "el_add_t"),
                             ("el_add_node", "el_add_node"),
                             ("el_del_t", "el_del_t")):
            assert np.array_equal(snap[mine][r], getattr(b, theirs)), mine
        vals = [None if i < 0 else snap["reg_pool"][i]
                for i in snap["reg_val"][r]]
        assert vals == b.reg_val
        assert [snap["member_pool"][i] for i in snap["el_member"]] == \
            b.el_member
        assert np.array_equal(snap["el_ki"], b.el_ki)
        assert np.array_equal(snap["enc"], b.key_enc)


def _frame_items(ops, f, origin):
    """Frame f as make_frame_log lays it out (the program's message
    types), for the program's encoder."""
    from constdb_tpu_torch.resp.message import Bulk, Int
    c = gen.CLASSES[ops["cls"][f]]
    i = int(ops["i"][f])
    args = [Bulk(gen.PREFIX[c] + b"%06d" % ops["key"][f])]
    if c == "set":
        args.append(Bulk(b"v%08d" % i))
    elif c == "cntset":
        args.append(Int(int(ops["total"][f])))
    elif c == "sadd":
        args += [Bulk(b"m%03d" % m) for m in ops["members"][f]]
    elif c == "srem":
        args.append(Bulk(b"m%03d" % ops["members"][f, 0]))
    elif c == "hset":
        for j, fld in enumerate(ops["fields"][f]):
            args += [Bulk(b"f%02d" % fld), Bulk(b"v%07d%d" % (i, j))]
    elif c == "hdel":
        args.append(Bulk(b"f%02d" % ops["fields"][f, 0]))
    return [Bulk(b"replicate"), Int(origin), Int(int(ops["prev"][f])),
            Int(int(ops["uuid"][f])), Bulk(c.encode()), *args]


def test_frame_bytes_are_the_programs_encoding_and_parse_back():
    from constdb_tpu_torch.resp.codec import encode_into, make_parser
    from constdb_tpu_torch.resp.message import Arr

    ops = gen.peer_ops(MIX, 6000, 99)
    data, end = gen.encode_frames(ops, MIX, 5)
    want = bytearray()
    for f in range(len(ops["cls"])):
        encode_into(want, Arr(_frame_items(ops, f, 5)))
    assert data == bytes(want)
    assert end[-1] == len(data)
    parser = make_parser()
    parser.feed(data)
    n = 0
    while (msg := parser.next_msg()) is not None:
        n += 1
    assert n == len(ops["cls"])
    # every class of the mix is present
    assert set(np.unique(ops["cls"]).tolist()) == set(range(len(gen.CLASSES)))
