"""Deterministic fault plane over the inter-node transport.

Every replica connection in the mesh is DIALED by some node's link
(an inbound SYNC adopts the stream the dialer created — server/io.py),
so wrapping the dial seam (`ServerApp.peer_connector`) puts both
directions of every inter-node byte through this plane.  The wrapped
stream is split into protocol UNITS — one RESP frame each, with a
FULLSYNC/DELTASYNC header fused to its whole raw payload window so a
reorder can never tear a raw byte range apart — and each directed edge
(src_node -> dst_node) applies its current fault rules per unit:

  * blocked      — partition: new dials on the edge are refused, and
                   traffic hitting a blocked direction drops WITH its
                   connection (transport fate-sharing — see _schedule)
  * delay        — deliver after a seeded pause (FIFO preserved)
  * reorder      — swap adjacent deliverable units with probability p
  * duplicate    — deliver the unit twice (dup-skip discipline food)
  * truncate     — one-shot: deliver a PREFIX of the next unit, then
                   hard-kill the connection (mid-frame cut)
  * corrupt_wire — one-shot: flip a byte inside the next REPLBATCH
                   payload (the codec's crc must demote LOUDLY, never
                   apply garbage)

Handshake `sync` frames and raw-window units are exempt from reorder/
duplication (reordering a handshake is not a network behavior TCP can
produce — within one connection TCP only delays, dies, or delivers in
order; the frame-level faults model what the MESH can produce across
teardown/redial/overlap races, plus the adversarial dup/reorder the
CRDT layer claims to absorb).  Every decision is drawn from a per-edge
`random.Random` seeded from the plane seed, so a scenario's fault
schedule is a pure function of (seed, traffic shape) and failures
replay from the printed seed.

The plane also counts what it actually injected (`stats`) — the oracle
checks INFO demotion/refusal/reconnect gauges against these.

The port's copy: pure host code over the port's RESP codec, cutting the
reference's units byte for byte.
"""

from __future__ import annotations

import asyncio
import random
from typing import Optional

from ..errors import CstError
from ..resp.codec import encode_msg, make_parser
from ..resp.message import Arr, Bulk, as_bytes, as_int

_RAW_KINDS = (b"fullsync", b"deltasync")
# never reordered/duplicated/corrupted: connection setup and raw windows
_EXEMPT_KINDS = (b"sync",)
# additionally never REORDERED (duplication stays fair game): a REPLACK
# drained-beacon delivered AHEAD of the stream frame it followed would
# fast-forward the receiver's watermark over an undelivered op — a fault
# TCP cannot produce (in-order-or-die within a connection), and one the
# beacon's soundness argument explicitly assumes away
# (docs/INVARIANTS.md "Transport assumptions").  Swapping two stream
# frames IS modeled: the gap check detects it and the link pays a
# teardown + resync, which is the recovery being certified.
_ORDERED_KINDS = (b"replack",)


class _Unit:
    """One schedulable transport unit (see module docstring)."""

    __slots__ = ("kind", "payload", "msg", "atomic")

    def __init__(self, kind: Optional[bytes], payload: bytes,
                 msg=None, atomic: bool = False):
        self.kind = kind
        self.payload = payload
        self.msg = msg
        self.atomic = atomic

    @property
    def exempt(self) -> bool:
        return self.atomic or self.kind in _EXEMPT_KINDS

    @property
    def reorderable(self) -> bool:
        return not self.exempt and self.kind not in _ORDERED_KINDS


class _Splitter:
    """Byte stream -> units.  Frames re-encode byte-identically (every
    wire frame is produced by encode_msg, which this reuses); a raw
    payload window is buffered until complete and fused to its header."""

    def __init__(self) -> None:
        self._parser = make_parser()
        self._raw_need = 0
        self._raw_head = b""
        self._raw_kind = b""
        self._raw_buf = bytearray()

    def feed(self, data: bytes) -> list[_Unit]:
        self._parser.feed(data)
        units: list[_Unit] = []
        while True:
            if self._raw_need:
                got = self._parser.take_raw(self._raw_need)
                if not got:
                    break
                self._raw_buf += got
                self._raw_need -= len(got)
                if self._raw_need:
                    break
                units.append(_Unit(self._raw_kind,
                                   self._raw_head + bytes(self._raw_buf),
                                   atomic=True))
                self._raw_head = b""
                self._raw_buf = bytearray()
                continue
            msg = self._parser.next_msg()
            if msg is None:
                break
            payload = encode_msg(msg)
            kind = None
            items = msg.items if isinstance(msg, Arr) else None
            if items and isinstance(items[0], Bulk):
                kind = items[0].val.lower()
            if kind in _RAW_KINDS and len(items) > 1:
                size = as_int(items[1])
                if size > 0:
                    self._raw_need = size
                    self._raw_head = payload
                    self._raw_kind = kind
                    continue
            units.append(_Unit(kind, payload, msg))
        return units


class EdgeRules:
    """Mutable fault configuration of one directed edge."""

    __slots__ = ("blocked", "delay", "reorder", "dup",
                 "truncate_next", "corrupt_next", "stall")

    def __init__(self) -> None:
        self.blocked = False
        self.delay: Optional[tuple[float, float]] = None
        self.reorder = 0.0
        self.dup = 0.0
        self.truncate_next = False
        self.corrupt_next = False
        # stalled reader: delivery on this direction PARKS (the pumps
        # stop moving bytes — crucially the inbound pump stops READING
        # the real socket, so TCP backpressure reaches the sender) until
        # unstalled.  Transport-sound: a peer that stops draining its
        # receive buffer is exactly this, and TCP neither drops nor
        # reorders while it lasts — the resource fault the replication
        # window (CONSTDB_TORCH_REPL_WINDOW) exists to govern.
        self.stall = False

    def clear(self) -> None:
        self.delay = None
        self.reorder = 0.0
        self.dup = 0.0
        self.stall = False


class _Edge:
    __slots__ = ("rules", "rng")

    def __init__(self, seed: int, src: int, dst: int) -> None:
        self.rules = EdgeRules()
        # a per-edge stream so one edge's traffic volume cannot shift
        # another edge's decision sequence
        self.rng = random.Random((seed << 16) ^ (src << 8) ^ dst)


class FaultPlane:
    def __init__(self, seed: int) -> None:
        self.seed = seed
        self._edges: dict[tuple[int, int], _Edge] = {}
        self._conns: list[_ChaosConn] = []
        self.stats: dict[str, int] = {}

    # ------------------------------------------------------------- controls

    def edge(self, src: int, dst: int) -> _Edge:
        e = self._edges.get((src, dst))
        if e is None:
            e = self._edges[(src, dst)] = _Edge(self.seed, src, dst)
        return e

    def count(self, what: str, n: int = 1) -> None:
        self.stats[what] = self.stats.get(what, 0) + n

    def set_faults(self, a: int, b: int, delay=None, reorder: float = 0.0,
                   dup: float = 0.0, sym: bool = True) -> None:
        for src, dst in ((a, b), (b, a)) if sym else ((a, b),):
            r = self.edge(src, dst).rules
            r.delay = delay
            r.reorder = reorder
            r.dup = dup

    def clear_faults(self) -> None:
        for e in self._edges.values():
            e.rules.clear()

    def partition(self, a: int, b: int, sym: bool = True,
                  kill: bool = True) -> None:
        """Stop delivery on a->b (and b->a when `sym`).  `kill` tears
        the edge's live connections down immediately; with kill=False
        they die lazily, on the first frame that hits the blocked
        direction (see _schedule — either way a partitioned connection
        DIES rather than silently dropping, preserving the transport's
        fate-sharing contract).  New dials on the edge are refused
        until `heal`."""
        self.count("partitions")
        for src, dst in ((a, b), (b, a)) if sym else ((a, b),):
            self.edge(src, dst).rules.blocked = True
        if kill:
            self.kill_connections(a, b)

    def heal(self, a: Optional[int] = None, b: Optional[int] = None) -> None:
        for (src, dst), e in self._edges.items():
            if a is None or (src in (a, b) and dst in (a, b)):
                e.rules.blocked = False

    def kill_connections(self, a: Optional[int] = None,
                         b: Optional[int] = None) -> int:
        """Hard-kill live connections on the (a, b) edge — or all of
        them (None).  Mid-stream: whatever was in flight is gone."""
        n = 0
        for c in list(self._conns):
            if c.closed:
                continue
            if a is None or (c.src in (a, b) and c.dst in (a, b)):
                c.kill()
                n += 1
        if n:
            self.count("conn_kills", n)
        return n

    def stall(self, src: int, dst: int) -> None:
        """Stalled reader on src->dst: delivery parks (and the inbound
        pump stops reading the carrying socket, so the sender feels real
        TCP backpressure) until `unstall`.  The connection stays ALIVE —
        this is the stalled-but-connected peer the replication window
        governs, not a partition."""
        self.count("stalls")
        self.edge(src, dst).rules.stall = True

    def unstall(self, src: int, dst: int) -> None:
        self.edge(src, dst).rules.stall = False

    def truncate_next(self, src: int, dst: int) -> None:
        """One-shot mid-frame cut on src->dst: the next unit delivers a
        prefix, then the connection dies."""
        self.edge(src, dst).rules.truncate_next = True

    def corrupt_next_wire(self, src: int, dst: int) -> None:
        """One-shot byte flip inside the next REPLBATCH payload on
        src->dst (crc-guarded demotion food)."""
        self.edge(src, dst).rules.corrupt_next = True

    def live_connections(self, a: int, b: int) -> int:
        return sum(1 for c in self._conns
                   if not c.closed and c.src in (a, b) and c.dst in (a, b))

    async def close(self) -> None:
        for c in list(self._conns):
            c.kill()
        self._conns.clear()

    # ------------------------------------------------------------ connector

    def connector(self, src: int, resolve):
        """The `ServerApp.peer_connector` for node `src`.  `resolve` maps
        a dialed port to the destination node index (the cluster's port
        registry); unknown ports dial straight through (a peer outside
        the harness)."""
        async def dial(host: str, port: int):
            dst = resolve(port)
            if dst is None:
                return await asyncio.open_connection(host, port)
            if self.edge(src, dst).rules.blocked or \
                    self.edge(dst, src).rules.blocked:
                self.count("dials_refused")
                raise ConnectionRefusedError(
                    f"chaos: edge {src}<->{dst} partitioned")
            reader, writer = await asyncio.open_connection(host, port)
            conn = _ChaosConn(self, src, dst, reader, writer)
            self._conns.append(conn)
            self._conns = [c for c in self._conns if not c.closed]
            return conn.reader, conn.writer
        return dial


# ---------------------------------------------------------------- transport


class _ChaosReader:
    """StreamReader stand-in fed by the inbound pump."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._eof = False
        self._wake = asyncio.Event()

    def _feed(self, data: bytes) -> None:
        self._buf += data
        self._wake.set()

    def _feed_eof(self) -> None:
        self._eof = True
        self._wake.set()

    async def read(self, n: int) -> bytes:
        while not self._buf and not self._eof:
            self._wake.clear()
            await self._wake.wait()
        if self._buf:
            out = bytes(self._buf[:n])
            del self._buf[:n]
            return out
        return b""


class _ChaosWriter:
    """StreamWriter stand-in: write() hands bytes to the outbound pump
    synchronously (fault decisions happen in write order — the
    deterministic part); delivery happens on the pump task."""

    def __init__(self, conn: "_ChaosConn") -> None:
        self._conn = conn

    def write(self, data: bytes) -> None:
        self._conn.feed_out(bytes(data))

    async def drain(self) -> None:
        if self._conn.closed:
            raise ConnectionResetError("chaos connection killed")
        await self._conn.real_writer.drain()

    def close(self) -> None:
        self._conn.close_out()

    def is_closing(self) -> bool:
        return self._conn.closed

    async def wait_closed(self) -> None:
        try:
            await self._conn.real_writer.wait_closed()
        except (ConnectionError, OSError):
            pass


class _ChaosConn:
    """One dialed inter-node connection under the plane: two directed
    pumps (src->dst rides the wrapped writer, dst->src rides a task
    reading the real socket), each splitting its byte stream into units
    and applying its edge's fault rules."""

    def __init__(self, plane: FaultPlane, src: int, dst: int,
                 reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.plane = plane
        self.src = src
        self.dst = dst
        self.real_reader = reader
        self.real_writer = writer
        self.closed = False
        self.reader = _ChaosReader()
        self.writer = _ChaosWriter(self)
        self._out_split = _Splitter()
        self._in_split = _Splitter()
        self._outq: asyncio.Queue = asyncio.Queue()
        self._out_task = asyncio.create_task(self._out_pump())
        self._in_task = asyncio.create_task(self._in_pump())

    # -------------------------------------------------------------- faults

    def _schedule(self, direction: tuple[int, int],
                  units: list[_Unit]) -> list:
        """Apply the edge's rules to a batch of units, in order.
        Returns delivery ops: ("data", bytes, delay) / ("kill",)."""
        plane = self.plane
        edge = plane.edge(*direction)
        r = edge.rules
        rng = edge.rng
        ops: list = []
        deliver: list[_Unit] = []
        # the corrupt one-shot and reorder are mutually exclusive on an
        # edge while the one-shot is ARMED or firing: a reorder-induced
        # gap teardown — in this batch or one still in the delivery
        # pipeline — kills the connection before the corrupted REPLBATCH
        # is decoded, silently swallowing the injection and spuriously
        # failing the oracle's demotions==corruptions accounting law.
        # Reorder is exercised plentifully whenever no corruption is
        # pending (the certify schedule runs its reorder window first).
        reorder_ok = not r.corrupt_next
        for u in units:
            if r.blocked:
                # transport-sound partition: traffic on a blocked
                # direction is dropped AND kills the carrying connection
                # (the retransmit-timeout analog).  TCP can delay, die,
                # or deliver in order — it can NEVER silently drop a
                # frame and then deliver later ones on the same
                # connection; modeling that would "refute" the REPLACK
                # drained-beacon, whose soundness argument assumes
                # connection fate-sharing (docs/INVARIANTS.md).
                plane.count("frames_dropped")
                ops.append(("kill",))
                return ops
            if r.truncate_next:
                r.truncate_next = False
                plane.count("truncations")
                cut = max(1, len(u.payload) // 2)
                ops.append(("data", u.payload[:cut], 0.0))
                ops.append(("kill",))
                # everything after the cut is gone with the connection
                return ops
            if r.corrupt_next and u.kind == b"replbatch" and u.msg is not None:
                r.corrupt_next = False
                plane.count("wire_corruptions")
                u = _corrupt_replbatch(u)
            if not u.exempt and r.dup and rng.random() < r.dup:
                plane.count("frames_duplicated")
                deliver.append(u)
            deliver.append(u)
        if r.reorder and reorder_ok and len(deliver) > 1:
            i = 0
            while i + 1 < len(deliver):
                if deliver[i].reorderable and deliver[i + 1].reorderable \
                        and _swappable(deliver[i], deliver[i + 1]) \
                        and rng.random() < r.reorder:
                    deliver[i], deliver[i + 1] = deliver[i + 1], deliver[i]
                    self.plane.count("frames_reordered")
                    i += 2
                else:
                    i += 1
        for u in deliver:
            delay = rng.uniform(*r.delay) if r.delay else 0.0
            if delay:
                plane.count("frames_delayed")
            ops.append(("data", u.payload, delay))
        return ops

    # --------------------------------------------------------------- pumps

    def feed_out(self, data: bytes) -> None:
        if self.closed:
            return
        for op in self._schedule((self.src, self.dst),
                                 self._out_split.feed(data)):
            self._outq.put_nowait(op)

    def close_out(self) -> None:
        if not self.closed:
            self._outq.put_nowait(("eof",))

    async def _stall_gate(self, direction: tuple[int, int]) -> None:
        """Park while the direction's stalled-reader fault is armed
        (EdgeRules.stall) — polling, no rng draws, so the plane's
        seeded decision streams are untouched."""
        rules = self.plane.edge(*direction).rules
        while rules.stall and not self.closed:
            await asyncio.sleep(0.02)

    async def _out_pump(self) -> None:
        try:
            while True:
                op = await self._outq.get()
                if op[0] == "kill":
                    self.kill()
                    return
                if op[0] == "eof":
                    self.real_writer.close()
                    return
                _, data, delay = op
                if delay:
                    await asyncio.sleep(delay)
                await self._stall_gate((self.src, self.dst))
                self.real_writer.write(data)
                await self.real_writer.drain()
        except (ConnectionError, OSError, asyncio.CancelledError):
            pass

    async def _in_pump(self) -> None:
        try:
            while True:
                # the stall gate sits BEFORE the socket read: a stalled
                # reader stops draining its receive buffer, so the
                # sender's kernel/userspace buffers fill and its
                # replication window (not a timeout) is what reacts
                await self._stall_gate((self.dst, self.src))
                data = await self.real_reader.read(1 << 16)
                if not data:
                    break
                for op in self._schedule((self.dst, self.src),
                                         self._in_split.feed(data)):
                    if op[0] == "kill":
                        self.kill()
                        return
                    _, payload, delay = op
                    if delay:
                        await asyncio.sleep(delay)
                    self.reader._feed(payload)
        except (ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            return
        self.reader._feed_eof()

    def kill(self) -> None:
        """Hard-kill: both endpoints see the connection die NOW."""
        if self.closed:
            return
        self.closed = True
        tr = self.real_writer.transport
        if tr is not None:
            tr.abort()
        self.reader._feed_eof()
        for t in (self._out_task, self._in_task):
            if t is not None and not t.done() and \
                    t is not asyncio.current_task():
                t.cancel()


_STREAM_KINDS = (b"replicate", b"replbatch")


def _swappable(a: _Unit, b: _Unit) -> bool:
    """May units a, b swap without forging an UNDETECTABLE skip?

    The fault model injects only faults the protocol claims to detect
    and recover from.  Two stream frames whose prev chain LINKS them
    (b.prev == a.uuid) are swappable: the receiver's gap check fires on
    the out-of-order frame and the link pays a teardown + resync — the
    recovery being certified.  Two stream frames that are NOT chained
    (adjacent frames from different segments of a sharded pusher's
    merged log) carry no continuity contract a receiver could check —
    swapping them forges a silent dup-skip of the later frame, a fault
    no in-order-or-die transport can produce (docs/INVARIANTS.md
    "Transport assumptions"; found live by this harness: a sharded
    cell's certify run lost exactly one cross-segment frame).  Frames
    outside the replication stream (digest negotiation, partsync) have
    no ordering contract and swap freely."""
    if a.kind not in _STREAM_KINDS or b.kind not in _STREAM_KINDS:
        return True
    if a.msg is None or b.msg is None:
        return False
    try:
        return as_int(b.msg.items[2]) == as_int(a.msg.items[3])
    except (CstError, IndexError):
        return False


def _corrupt_replbatch(u: _Unit) -> _Unit:
    """Flip one byte in the middle of a REPLBATCH payload (items[5]) and
    re-encode — structurally valid RESP, semantically corrupt payload."""
    items = list(u.msg.items)
    payload = bytearray(as_bytes(items[5]))
    if not payload:
        return u
    payload[len(payload) // 2] ^= 0xFF
    items[5] = Bulk(bytes(payload))
    msg = Arr(items)
    return _Unit(u.kind, encode_msg(msg), msg)
