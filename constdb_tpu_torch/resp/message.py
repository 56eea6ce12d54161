"""RESP message model.

Capability parity with the reference's `Message` enum and helpers
(reference src/resp.rs:35-43 enum, 100-129 size accounting, 133-145 mkcmd!).

Messages are small immutable objects:
  Simple(b)  -> +b\r\n          Err(b) -> -b\r\n        Int(i) -> :i\r\n
  Bulk(b)    -> $len\r\n b \r\n  Arr([..]) -> *len\r\n ...
  NIL        -> $-1\r\n          NO_REPLY -> nothing on the wire
"""

from __future__ import annotations

from typing import Iterable, Union

from ..errors import InvalidRequestMsg
from ..utils.bytesutil import bytes2i64, bytes2u64, i64_to_bytes


class Msg:
    __slots__ = ()


class Nil(Msg):
    __slots__ = ()

    def __repr__(self) -> str:
        return "Nil"

    def __eq__(self, other) -> bool:
        return isinstance(other, Nil)

    def __hash__(self) -> int:
        return hash("Nil")


class NoReply(Msg):
    """Maps to the reference's Message::None: nothing is written back."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "NoReply"

    def __eq__(self, other) -> bool:
        return isinstance(other, NoReply)

    def __hash__(self) -> int:
        return hash("NoReply")


class _BytesMsg(Msg):
    __slots__ = ("val",)

    def __init__(self, val: Union[bytes, str]):
        self.val = val.encode() if isinstance(val, str) else bytes(val)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.val!r})"

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other.val == self.val

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.val))


class Simple(_BytesMsg):
    __slots__ = ()


class Err(_BytesMsg):
    __slots__ = ()


class Bulk(_BytesMsg):
    __slots__ = ()


class Int(Msg):
    __slots__ = ("val",)

    def __init__(self, val: int):
        self.val = int(val)

    def __repr__(self) -> str:
        return f"Int({self.val})"

    def __eq__(self, other) -> bool:
        return type(other) is Int and other.val == self.val

    def __hash__(self) -> int:
        return hash(("Int", self.val))


class Arr(Msg):
    __slots__ = ("items",)

    def __init__(self, items: Iterable[Msg]):
        self.items = list(items)

    def __repr__(self) -> str:
        return f"Arr({self.items!r})"

    def __eq__(self, other) -> bool:
        return type(other) is Arr and other.items == self.items

    def __hash__(self) -> int:
        return hash(("Arr", tuple(self.items)))


class Push(Arr):
    """RESP3 push frame: >len\r\n ... — an out-of-band server-initiated
    message (invalidation broadcasts, server/tracking.py).  Subclasses
    Arr so every item-walking consumer works unchanged, but compares as
    its own type: a Push is NOT equal to an Arr with the same items
    (the wire type byte differs)."""

    __slots__ = ()

    def __repr__(self) -> str:
        return f"Push({self.items!r})"

    def __eq__(self, other) -> bool:
        return type(other) is Push and other.items == self.items

    def __hash__(self) -> int:
        return hash(("Push", tuple(self.items)))


NIL = Nil()
NO_REPLY = NoReply()
OK = Simple(b"OK")


def msg_size(m: Msg) -> int:
    """Payload size accounting for the repl-log byte cap (parity:
    reference src/resp.rs:100-110 `Message::size`)."""
    if isinstance(m, (Simple, Err, Bulk)):
        return len(m.val)
    if isinstance(m, Int):
        return 8
    if isinstance(m, Arr):
        return sum(msg_size(x) for x in m.items)
    return 0


def mkcmd(*parts) -> Arr:
    """Build a command Arr of Bulk strings from mixed str/bytes/int parts
    (parity: reference mkcmd! macro, src/resp.rs:133-145)."""
    out = []
    for p in parts:
        if isinstance(p, bytes):
            out.append(Bulk(p))
        elif isinstance(p, str):
            out.append(Bulk(p.encode()))
        elif isinstance(p, int):
            out.append(Bulk(i64_to_bytes(p)))
        elif isinstance(p, Msg):
            out.append(p)
        else:
            raise TypeError(f"mkcmd: unsupported part {p!r}")
    return Arr(out)


# --- argument coercion (parity: reference NextArg trait, src/cmd.rs:348-397) ---

def as_bytes(m: Msg) -> bytes:
    # exact-type fast path first: Bulk is ~every argument on the wire,
    # and these coercions sit on the per-frame replication hot path.
    # Plain bytes pass through: the native AOF scanner's raw mode hands
    # bulk-replay frames their arguments unwrapped (persist/oplog.py).
    if type(m) is Bulk or isinstance(m, (Simple, Err, Bulk)):
        return m.val
    if type(m) is bytes:
        return m
    if isinstance(m, Int):
        return i64_to_bytes(m.val)
    raise InvalidRequestMsg("should be non-array type")


def as_int(m: Msg) -> int:
    if type(m) is Int or isinstance(m, Int):
        return m.val
    if type(m) is bytes:
        v = bytes2i64(m)
        if v is None:
            raise InvalidRequestMsg("string should be an integer")
        return v
    if isinstance(m, (Simple, Bulk)):
        v = bytes2i64(m.val)
        if v is None:
            raise InvalidRequestMsg("string should be an integer")
        return v
    raise InvalidRequestMsg("argument should be Integer or String")


def as_uint(m: Msg) -> int:
    if isinstance(m, Int):
        if m.val < 0:
            raise InvalidRequestMsg("argument should be an unsigned integer")
        return m.val
    if type(m) is bytes:
        v = bytes2u64(m)
        if v is None:
            raise InvalidRequestMsg("string should be an unsigned integer")
        return v
    if isinstance(m, (Simple, Bulk)):
        v = bytes2u64(m.val)
        if v is None:
            raise InvalidRequestMsg("string should be an unsigned integer")
        return v
    raise InvalidRequestMsg("argument should be Integer or String")
