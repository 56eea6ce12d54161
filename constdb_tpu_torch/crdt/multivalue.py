"""Multi-value register: vector-clock concurrent-write semantics.

Capability completion for the reference's `VClock`/`MiniMap`/`MultiValue`
scaffold (reference src/crdt/vclock.rs:3-45): the README there advertises a
MultiValueRegister but the type is never wired to an encoding or command
(SURVEY.md §2.5 "vestigial").  This is a WORKING implementation: reads
return every causally-concurrent value (siblings), writes carry the vector
clock the writer observed, and merge keeps exactly the causal frontier.

Unlike the LWW types, no write is silently lost — concurrent writes
surface to the reader (Dynamo-style) for application-level resolution.

Columnar note: sibling sets are tiny (bounded by the number of
concurrently-writing nodes), so this stays a host-side structure; the bulk
engines treat multi-value payloads as opaque bytes.
"""

from __future__ import annotations

from typing import Iterable, Optional


class VClock:
    """node_id -> counter map with the usual partial order
    (the reference's sorted-vec MiniMap, vclock.rs:3-38)."""

    __slots__ = ("c",)

    def __init__(self, c: Optional[dict] = None):
        self.c: dict[int, int] = dict(c or {})

    def bump(self, node: int) -> "VClock":
        out = VClock(self.c)
        out.c[node] = out.c.get(node, 0) + 1
        return out

    def merge(self, other: "VClock") -> "VClock":
        out = VClock(self.c)
        for n, v in other.c.items():
            if v > out.c.get(n, 0):
                out.c[n] = v
        return out

    def dominates(self, other: "VClock") -> bool:
        """self >= other pointwise (a write with clock `self` has SEEN one
        with clock `other`)."""
        return all(self.c.get(n, 0) >= v for n, v in other.c.items())

    def concurrent(self, other: "VClock") -> bool:
        return not self.dominates(other) and not other.dominates(self)

    def __eq__(self, other) -> bool:
        return isinstance(other, VClock) and self.c == other.c

    def __hash__(self) -> int:
        return hash(frozenset(self.c.items()))

    def __repr__(self) -> str:
        return f"VClock({self.c})"


class MultiValue:
    """The register: a set of (value, VClock) siblings on the causal
    frontier."""

    __slots__ = ("siblings",)

    def __init__(self) -> None:
        self.siblings: list[tuple[bytes, VClock]] = []

    # ------------------------------------------------------------------ ops

    def read(self) -> list[bytes]:
        return [v for v, _ in self.siblings]

    def context(self) -> VClock:
        """The clock a reader should attach to its next write (join of all
        siblings — writing with it supersedes everything read)."""
        out = VClock()
        for _, vc in self.siblings:
            out = out.merge(vc)
        return out

    def write(self, value: bytes, node: int,
              context: Optional[VClock] = None) -> VClock:
        """Write `value` having observed `context` (defaults to this
        replica's current frontier).  Returns the write's clock."""
        ctx = context if context is not None else self.context()
        wc = ctx.bump(node)
        self.siblings = [(v, vc) for v, vc in self.siblings
                         if not wc.dominates(vc)]
        self.siblings.append((value, wc))
        return wc

    # ---------------------------------------------------------------- merge

    def merge(self, other: "MultiValue") -> None:
        """Keep exactly the union's causal frontier — commutative,
        associative, idempotent."""
        self.siblings = self._frontier(self.siblings + other.siblings)

    @staticmethod
    def _frontier(pairs: Iterable[tuple[bytes, VClock]]
                  ) -> list[tuple[bytes, VClock]]:
        pairs = list(pairs)
        out: list[tuple[bytes, VClock]] = []
        for i, (v, vc) in enumerate(pairs):
            dominated = False
            for j, (v2, vc2) in enumerate(pairs):
                if i == j:
                    continue
                if vc2.dominates(vc) and not (vc.dominates(vc2) and i < j):
                    # strictly dominated, or an equal-clock duplicate keeps
                    # only its first occurrence
                    dominated = True
                    break
            if not dominated and (v, vc) not in out:
                out.append((v, vc))
        return out

    def state(self) -> frozenset:
        return frozenset((v, frozenset(vc.c.items())) for v, vc in self.siblings)


# ------------------------------------------------- wire/member serialization
# A sibling is stored as an ELEMENT ROW whose member bytes are the write's
# canonical clock serialization: deterministic, so the same write interns to
# the same member on every replica and element-plane merges (both engines,
# snapshots, GC) apply unchanged.

def clock_to_bytes(vc: VClock) -> bytes:
    """Canonical ascii form `node:count,node:count` sorted by node."""
    return b",".join(b"%d:%d" % (n, c) for n, c in sorted(vc.c.items()))


def clock_from_bytes(b: bytes) -> VClock:
    out = VClock()
    if b:
        for part in b.split(b","):
            n, _, c = part.partition(b":")
            out.c[int(n)] = int(c)
    return out


def frontier_of(pairs: list) -> list:
    """Prune causally-dominated entries from [(member, value, clock), ...]
    (read-time view; dominated rows may linger until a later write
    tombstones them)."""
    out = []
    for i, (m, v, vc) in enumerate(pairs):
        dominated = False
        for j, (m2, _v2, vc2) in enumerate(pairs):
            if i != j and vc2.dominates(vc) and not (vc.dominates(vc2)
                                                     and i < j):
                dominated = True
                break
        if not dominated:
            out.append((m, v, vc))
    return out
