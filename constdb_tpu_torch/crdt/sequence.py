"""Ordered-sequence CRDT: dense position identifiers + element tombstones.

Capability completion for the reference's `Sequence`/`List` scaffold
(reference src/crdt/list.rs:4-43): there it is an ordered-insert linked
list keyed by u128 ids, wired to nothing (SURVEY.md §2.5).  This is a
WORKING replicated list: every element gets a position identifier drawn
between its neighbors' (LSEQ-style path of (digit, node) pairs, so
identifiers from concurrent inserts at the same spot order
deterministically by writer node), deletes tombstone by identifier, and
merge is a keyed LWW union — commutative, associative, idempotent.
"""

from __future__ import annotations

import bisect
from typing import Optional

# each path digit is (slot, node); slot space per level
_BASE = 1 << 16


class Sequence:
    __slots__ = ("items",)

    def __init__(self) -> None:
        # sorted by position id: [(pos, value, add_t, del_t)]
        self.items: list[list] = []

    # ----------------------------------------------------------- positions

    @staticmethod
    def _between(lo: Optional[tuple], hi: Optional[tuple], node: int) -> tuple:
        """A fresh position strictly between lo and hi."""
        lo = lo or ()
        hi = hi or ()
        path = []
        level = 0
        while True:
            lo_d = lo[level] if level < len(lo) else (0, 0)
            hi_d = hi[level] if level < len(hi) else (_BASE, 0)
            if hi_d[0] - lo_d[0] > 1:
                path.append(((lo_d[0] + hi_d[0]) // 2, node))
                return tuple(path)
            path.append(lo_d)
            level += 1

    # ----------------------------------------------------------------- ops

    def _live(self) -> list:
        return [it for it in self.items if it[2] >= it[3]]

    def insert(self, index: int, value: bytes, node: int, uuid: int) -> tuple:
        """Insert before live index `index`; returns the position id."""
        live = self._live()
        lo = live[index - 1][0] if 0 < index <= len(live) else None
        hi = live[index][0] if index < len(live) else None
        pos = self._between(lo, hi, node)
        self.apply_insert(pos, value, uuid)
        return pos

    def apply_insert(self, pos: tuple, value: bytes, uuid: int) -> None:
        """Keyed add-side LWW write (replication entry point)."""
        i = bisect.bisect_left([it[0] for it in self.items], pos)
        if i < len(self.items) and self.items[i][0] == pos:
            it = self.items[i]
            if uuid > it[2]:
                it[1], it[2] = value, uuid
        else:
            self.items.insert(i, [pos, value, uuid, 0])

    def delete(self, index: int, uuid: int) -> Optional[tuple]:
        live = self._live()
        if not 0 <= index < len(live):
            return None
        pos = live[index][0]
        self.apply_delete(pos, uuid)
        return pos

    def apply_delete(self, pos: tuple, uuid: int) -> None:
        i = bisect.bisect_left([it[0] for it in self.items], pos)
        if i < len(self.items) and self.items[i][0] == pos:
            if uuid > self.items[i][3]:
                self.items[i][3] = uuid
        else:
            # delete for a not-yet-seen insert: tombstone placeholder
            self.items.insert(i, [pos, None, 0, uuid])

    def read(self) -> list[bytes]:
        return [it[1] for it in self._live()]

    # ---------------------------------------------------------------- merge

    def merge(self, other: "Sequence") -> None:
        for pos, value, add_t, del_t in other.items:
            if add_t:
                self.apply_insert(pos, value, add_t)
            if del_t:
                self.apply_delete(pos, del_t)

    def state(self) -> frozenset:
        return frozenset((it[0], it[1], it[2], it[3]) for it in self.items)


# ------------------------------------------------- wire/member serialization
# A list entry is stored as an ELEMENT ROW whose member bytes are its
# position id serialized as fixed-width big-endian digits — byte-lex order
# of members IS position order, so sorting live members reads the list and
# element-plane merges (both engines, snapshots, GC) apply unchanged.

_DIGIT_BYTES = 2 + 8  # slot (16-bit) + writer node (64-bit)


def pos_to_bytes(pos: tuple) -> bytes:
    out = bytearray()
    for slot, node in pos:
        out += slot.to_bytes(2, "big") + node.to_bytes(8, "big")
    return bytes(out)


def pos_from_bytes(b: bytes) -> tuple:
    return tuple((int.from_bytes(b[i:i + 2], "big"),
                  int.from_bytes(b[i + 2:i + _DIGIT_BYTES], "big"))
                 for i in range(0, len(b), _DIGIT_BYTES))


def pos_between_bytes(lo: Optional[bytes], hi: Optional[bytes],
                      node: int) -> bytes:
    """A fresh serialized position strictly between two serialized ones."""
    return pos_to_bytes(Sequence._between(
        pos_from_bytes(lo) if lo else None,
        pos_from_bytes(hi) if hi else None, node))
