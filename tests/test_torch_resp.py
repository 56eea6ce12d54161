"""The port's RESP codec (constdb_tpu_torch/resp/) and its native
scanners (constdb_tpu_torch/native/resp.cpp, intake.cpp) against the
reference's (constdb_tpu/resp/, native/): a seeded message corpus
encodes byte for byte alike, a stream fed in random splits parses to
equal messages through the port's native and pure parsers and the
reference's native and pure parsers, the intake scanner's opcodes and
payloads are equal, and malformed input raises the same error class.

The reference's native parser runs on its own extension, built from
native/pyext.cpp for these tests (tests/torch_ref_native.py)."""

import random

import pytest

from constdb_tpu.errors import InvalidRequestMsg as RefInvalid
from constdb_tpu.resp import codec as RC
from constdb_tpu.resp import message as RM
from constdb_tpu_torch.errors import InvalidRequestMsg as PortInvalid
from constdb_tpu_torch.resp import codec as PC
from constdb_tpu_torch.resp import message as PM

from torch_ref_native import build_reference_ext

INT_EDGES = (0, 1, -1, 7, 1023, 1024, -1024, (1 << 31) - 1, -(1 << 31),
             (1 << 62), (1 << 63) - 1, -(1 << 63), 1 << 63, -(1 << 63) - 1,
             10 ** 18, 10 ** 19 - 1, 10 ** 19, (1 << 64) - 1, 1 << 64,
             -(1 << 64), 1 << 70)


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory, request):
    """The reference codec switched onto its native extension for the
    module's tests (its caches hold the entry points)."""
    ext = build_reference_ext(tmp_path_factory.mktemp("ref_ext"))
    saved = (list(RC._EXT_CACHE), list(RC._ENC_CACHE),
             list(RC._INTAKE_CACHE))
    RC._EXT_CACHE[:] = [ext]
    RC._ENC_CACHE[:] = [ext.resp_encode]
    RC._INTAKE_CACHE[:] = [ext.intake_scan]
    yield ext
    RC._EXT_CACHE[:], RC._ENC_CACHE[:], RC._INTAKE_CACHE[:] = saved


def rand_msg(rng: random.Random, M, depth: int = 0):
    """A random message tree of package M's classes: every type, RESP3
    Push at any depth, nesting, Nil, empty arrays and the int edges."""
    r = rng.random()
    if depth < 3 and r < 0.25:
        cls = M.Push if rng.random() < 0.2 else M.Arr
        return cls([rand_msg(rng, M, depth + 1)
                    for _ in range(rng.randrange(0, 6))])
    if r < 0.45:
        return M.Bulk(bytes(rng.randrange(256)
                            for _ in range(rng.randrange(0, 40))))
    if r < 0.65:
        return M.Int(rng.choice(INT_EDGES + (rng.randrange(-10**6, 10**6),)))
    if r < 0.80:
        return M.Simple(bytes(rng.choice(b"abcXYZ 09_-") for _ in range(8)))
    if r < 0.92:
        return M.Err(b"ERR " + bytes(rng.choice(b"abcdef")
                                     for _ in range(6)))
    return M.NIL


def corpus(M, n: int = 400, seed: int = 1234) -> list:
    rng = random.Random(seed)
    return [rand_msg(rng, M) for _ in range(n)]


def norm(m):
    """A package-free form of a message (the two packages' classes never
    compare equal to each other)."""
    if isinstance(m, (list, tuple)):
        return [norm(x) for x in m]
    name = type(m).__name__
    if name in ("Arr", "Push"):
        return (name, [norm(x) for x in m.items])
    if name in ("Bulk", "Simple", "Err", "Int"):
        return (name, m.val)
    if name in ("Nil", "NoReply"):
        return (name,)
    return m


def feed_split(parser, wire: bytes, seed: int, n_msgs: int) -> list:
    rng = random.Random(seed)
    got = []
    pos = 0
    while pos < len(wire) or len(got) < n_msgs:
        step = rng.randrange(1, 64)
        parser.feed(wire[pos:pos + step])
        pos += step
        while (m := parser.next_msg()) is not None:
            got.append(m)
        assert pos < len(wire) + 64 * 4
    return got


def test_corpus_encodes_byte_equal(ref_native):
    port, ref = corpus(PM), corpus(RM)
    assert norm(port) == norm(ref)
    for p, r in zip(port, ref):
        want = RC.encode_msg(r)
        assert PC.encode_msg(p) == want
        pure = bytearray()
        PC._py_encode_into(pure, p)
        assert bytes(pure) == want
        ref_pure = bytearray()
        RC._py_encode_into(ref_pure, r)
        assert bytes(ref_pure) == want
    # the small-int replies, the NoReply sentinel and arrays of them
    for v in range(-2, 1100, 37):
        assert PC.encode_msg(PM.Int(v)) == RC.encode_msg(RM.Int(v))
    assert PC.encode_msg(PM.NO_REPLY) == RC.encode_msg(RM.NO_REPLY) == b""


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_random_splits_parse_equal(ref_native, seed):
    msgs = corpus(RM, 300, seed=99 + seed)
    wire = b"".join(RC.encode_msg(m) for m in msgs)
    want = norm(msgs)
    parsers = {"port-native": PC.make_parser(), "port-pure": PC.RespParser(),
               "ref-native": RC.NativeRespParser(),
               "ref-pure": RC.RespParser()}
    assert type(parsers["port-native"]) is PC.NativeRespParser
    for name, parser in parsers.items():
        got = feed_split(parser, wire, seed, len(msgs))
        assert norm(got) == want, name
    # drain: the whole buffer in one call
    p = PC.make_parser()
    p.feed(wire)
    assert norm(p.drain()) == want


# (wire line, parsed in C): a `:` integer of up to 20 digits whose
# magnitude fits 64 bits (INT64_MIN at most, when negative) parses in the
# port's C scanner; past that it defers to the pure parser
UINT_LINES = (
    (b"1700000000000000000", True),       # a 19-digit HLC uuid
    (b"9223372036854775808", True),       # 2^63
    (b"18446744073709551615", True),      # 2^64 - 1
    (b"+18446744073709551615", True),
    (b"00000000000000000001", True),      # 20 digits, leading zeros
    (b"-9223372036854775808", True),      # INT64_MIN
    (b"-0", True),
    (b"18446744073709551616", False),     # 2^64
    (b"99999999999999999999", False),
    (b"000000000000000000001", False),    # 21 digits
    (b"-9223372036854775809", False),     # below INT64_MIN
)


@pytest.mark.parametrize("line,in_c", UINT_LINES,
                         ids=[x[0].decode() for x in UINT_LINES])
def test_uint64_integers_parse_in_c(ref_native, line, in_c):
    """The port's scanner takes a 64-bit `:` integer itself (a REPLICATE
    frame's uuid) and defers only past 64 bits; every parser, the
    reference's included, gives the same message."""
    frame = (b"*4\r\n$9\r\nreplicate\r\n:7\r\n:" + line +
             b"\r\n$3\r\nset\r\n")
    for wire in (b":" + line + b"\r\n", frame):
        msgs, pos, fallback = PC._ext().resp_parse(
            bytearray(wire), 0, PM.Arr, PM.Bulk, PM.Int, PM.Simple,
            PM.Err, PM.NIL, 1024, 512 << 20)
        assert (len(msgs), pos, bool(fallback)) == \
            ((1, len(wire), False) if in_c else (0, 0, True))
        want = []
        for cls in (RC.RespParser, RC.NativeRespParser):
            p = cls()
            p.feed(wire)
            want.append(norm(p.next_msg()))
        for cls in (PC.RespParser, PC.make_parser):
            p = cls()
            p.feed(wire)
            want.append(norm(p.next_msg()))
        if in_c:
            want.append(norm(msgs[0]))
        assert all(w == want[0] for w in want)
        assert int(line) in _ints(want[0])


def _ints(m) -> list:
    """Every integer in a normalized message."""
    if isinstance(m, tuple) and m and m[0] == "Int":
        return [m[1]]
    if isinstance(m, (tuple, list)):
        return [v for x in m for v in _ints(x)]
    return []


def rand_command(rng: random.Random, M):
    """A client-shaped command: plannable names with good and broken
    arity, barriers, uppercase names, binary keys, an int item."""
    names = (b"set", b"incr", b"decr", b"sadd", b"srem", b"hset", b"hdel",
             b"get", b"scnt", b"sismember", b"smembers", b"hget",
             b"hgetall", b"llen", b"hlen", b"del", b"SET", b"INCR",
             b"mvget", b"zmystery")
    nm = rng.choice(names)
    items = [M.Bulk(nm)] + [
        M.Bulk(bytes(rng.randrange(256) for _ in range(rng.randrange(0, 12))))
        for _ in range(rng.randrange(0, 5))]
    if rng.random() < 0.1:
        items.append(M.Int(rng.randrange(-100, 100)))
    return M.Arr(items)


def intake_all(parser, wire: bytes, seed: int) -> list:
    """Feed at random boundaries; every native_drain's (ops, payloads) and
    every fallback message, in order."""
    rng = random.Random(seed)
    out = []
    pos = 0
    while pos < len(wire):
        step = rng.randrange(1, 80)
        parser.feed(wire[pos:pos + step])
        pos += step
        while (nat := parser.native_drain()) is not None:
            out.append(("nat", list(nat[0]), norm(list(nat[1]))))
        rest = parser.drain()
        if rest:
            out.append(("msgs", norm(rest)))
    return out


def test_intake_scan_equal(ref_native):
    rng_p, rng_r = random.Random(2024), random.Random(2024)
    port = [rand_command(rng_p, PM) for _ in range(500)]
    ref = [rand_command(rng_r, RM) for _ in range(500)]
    wire = b"".join(RC.encode_msg(m) for m in ref)
    assert b"".join(PC.encode_msg(m) for m in port) == wire
    got = intake_all(PC.make_parser(), wire, 7)
    want = intake_all(RC.NativeRespParser(), wire, 7)
    assert got == want
    ops = {op for e in got if e[0] == "nat" for op in e[1]}
    assert 0 in ops and len(ops) > 8   # OP_OTHER and plannable opcodes
    # the scanner itself, called on one buffer with both packages' classes
    buf = bytearray(wire)
    p_ops, p_pay, p_pos = PC._intake()(
        buf, 0, PM.Arr, PM.Bulk, PM.Int, PM.Simple, PM.Err, PM.NIL,
        PC.max_bulk_len())
    r_ops, r_pay, r_pos = ref_native.intake_scan(
        buf, 0, RM.Arr, RM.Bulk, RM.Int, RM.Simple, RM.Err, RM.NIL,
        RC.max_bulk_len())
    assert (list(p_ops), norm(list(p_pay)), p_pos) == \
        (list(r_ops), norm(list(r_pay)), r_pos)


BAD = (
    b"!bogus\r\n",                      # unknown type byte
    b"$-2\r\n",                         # negative non-nil bulk length
    b"*-2\r\n",                         # negative non-nil array length
    b":12x\r\n",                        # non-integer int line
    b"$x\r\n",                          # non-integer bulk length
    b"*1\r\n$3\r\nabcXY",               # bulk missing its CRLF
    b"$2000000000000\r\n",              # bulk too large
    b"$536870913\r\n",                  # one past the 512 MiB ceiling
    b"*99999999\r\n",                   # absurd array header
    b">-2\r\n",                         # negative push length
    b">99999999\r\n",                   # absurd push header
    b">x\r\n",                          # non-integer push length
)


@pytest.mark.parametrize("bad", BAD, ids=lambda b: repr(b)[2:14])
def test_malformed_input_raises_the_same_error(ref_native, bad):
    """The same error class and text in every parser, after the same
    clean prefix; drain() stashes that prefix for the error path."""
    def run(parser_cls, M, E):
        good = M.Arr([M.Bulk(b"set"), M.Bulk(b"k"), M.Bulk(b"v")])
        parser = parser_cls()
        parser.feed(RC.encode_msg(RM.Arr([RM.Bulk(b"set"), RM.Bulk(b"k"),
                                          RM.Bulk(b"v")])) + bad)
        first = parser.next_msg()
        with pytest.raises(E) as ei:
            while parser.next_msg() is not None:
                pass
        parser = parser_cls()
        parser.feed(RC.encode_msg(RM.Arr([RM.Bulk(b"set"), RM.Bulk(b"k"),
                                          RM.Bulk(b"v")])) + bad)
        with pytest.raises(E):
            parser.drain()
        assert norm(parser.take_queued()) == norm([good])
        return norm(first), str(ei.value)

    want = run(RC.NativeRespParser, RM, RefInvalid)
    assert run(RC.RespParser, RM, RefInvalid) == want
    assert run(PC.NativeRespParser, PM, PortInvalid) == want
    assert run(PC.RespParser, PM, PortInvalid) == want


def test_configured_bulk_cap_is_enforced_alike(ref_native):
    """A below-default max_bulk is enforced at header parse time by the
    port's native parser as by the reference's."""
    wire = b"*2\r\n$3\r\nset\r\n$40\r\n" + b"x" * 40 + b"\r\n"
    for cls, E in ((PC.NativeRespParser, PortInvalid),
                   (RC.NativeRespParser, RefInvalid),
                   (PC.RespParser, PortInvalid)):
        p = cls(max_bulk=16)
        p.feed(wire)
        with pytest.raises(E):
            p.next_msg()
        p = cls(max_bulk=64)
        p.feed(wire)
        assert norm(p.next_msg()) == ("Arr", [("Bulk", b"set"),
                                              ("Bulk", b"x" * 40)])
