"""Hybrid-logical-clock uuid generation.

Behavior parity with reference src/server.rs:156-177 (`next_uuid`): a uuid is
`(unix_ms << 22) | seq` — 41 bits of wall-clock milliseconds and a 22-bit
per-millisecond sequence.  It doubles as the HLC timestamp that totally orders
writes across the cluster (ties across nodes are resolved by CRDT tie-break
rules, see crdt/semantics.py).

Deliberate fixes over the reference:
  * monotonic under wall-clock regression (the reference emits a smaller uuid
    if the OS clock steps back);
  * sequence overflow rolls into the millisecond field instead of wrapping.
"""

from __future__ import annotations

import time

SEQ_BITS = 22
SEQ_MASK = (1 << SEQ_BITS) - 1
UUID_MAX = (1 << 63) - 1


def now_ms() -> int:
    return time.time_ns() // 1_000_000


def now_secs() -> int:
    return int(time.time())


def uuid_ms(uuid: int) -> int:
    return uuid >> SEQ_BITS


def uuid_seq(uuid: int) -> int:
    return uuid & SEQ_MASK


class HLC:
    """Monotonic uuid/timestamp source for one node.

    `tick(is_write)` parities reference `Server::next_uuid`: a write always
    receives a strictly greater uuid than any previously issued one; reads
    re-observe the clock without consuming sequence numbers.
    """

    __slots__ = ("_uuid", "_clock")

    def __init__(self, clock=now_ms):
        self._uuid = 1
        self._clock = clock

    @property
    def current(self) -> int:
        return self._uuid

    def observe(self, remote_uuid: int) -> None:
        """Advance past a remote uuid (keeps local write uuids fresh even when
        a peer's clock is ahead)."""
        if remote_uuid > self._uuid:
            self._uuid = remote_uuid

    def tick(self, is_write: bool) -> int:
        prev_ms, seq = self._uuid >> SEQ_BITS, self._uuid & SEQ_MASK
        now = self._clock()
        if now > prev_ms:
            ms, seq = now, 0
        else:
            # clock stalled or stepped back: stay on prev_ms, bump seq on write
            ms = prev_ms
            if is_write:
                seq += 1
                if seq > SEQ_MASK:
                    ms, seq = ms + 1, 0
        if not is_write and ms == prev_ms:
            # a read never needs a fresh sequence number
            return self._uuid
        nxt = (ms << SEQ_BITS) | seq
        if is_write and nxt <= self._uuid:
            nxt = self._uuid + 1
        self._uuid = nxt
        return self._uuid
