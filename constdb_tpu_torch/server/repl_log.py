"""Replication log: byte-capped ring of locally-executed write commands.

Capability parity with the reference's repl_log (reference
src/server.rs:35-38 ring + cap, 270-288 push/evict, 290-379 queries with
binary search by uuid).  Entries are only ever appended with strictly
increasing uuids (the HLC guarantees this for local writes), so lookups are
binary searches over a deque of sorted uuids.

The ring additionally tracks `evicted_up_to` — the uuid of the newest entry
ever evicted — so partial-resync eligibility is exact: a peer resuming from
uuid `u` can be served incrementally iff `u >= evicted_up_to` (the reference
infers this more loosely in push.rs:95-110).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import deque
from itertools import islice
from typing import Optional

from ..resp.message import Arr, Bulk, Msg, msg_size


class ReplEntry:
    __slots__ = ("uuid", "prev_uuid", "name", "args", "size")

    def __init__(self, uuid: int, prev_uuid: int, name: bytes, args: list, size: int):
        self.uuid = uuid
        self.prev_uuid = prev_uuid
        self.name = name
        self.args = args
        self.size = size


class ReplLog:
    # parity: reference src/server.rs:81 (size-based cap, 1_024_000 bytes)
    DEFAULT_CAP = 1_024_000

    def __init__(self, cap_bytes: int = DEFAULT_CAP):
        self.cap = cap_bytes
        self._entries: deque[ReplEntry] = deque()
        self._uuids: deque[int] = deque()  # parallel, for bisect
        self._bytes = 0
        self.evicted_up_to = 0  # uuid of the newest evicted entry (0 = none)
        self.last_uuid = 0      # newest uuid ever pushed (survives eviction)
        # observer: called with (uuid, name, args) as each entry lands —
        # the chaos oracle's op journal taps the origin stream here
        # (constdb_tpu_torch/chaos/oracle.py); the ring's eviction makes the
        # log itself useless as a post-hoc record.  None = no observer.
        self.on_append = None
        # emission floor: None, or a callable returning the smallest
        # uuid the push stream may NOT emit yet (entries with
        # uuid >= floor() are invisible to next_after/run_after — the
        # MergedReplLog floor discipline, here for the plain ring).
        # The durable op log installs its fsync horizon here
        # (persist/oplog.py: emit-only-durable law), so a peer can
        # never hold an op a torn tail could still lose.  `last_uuid`
        # stays the true newest on purpose: the drained-beacon check
        # (cursor >= last_uuid) must keep failing below the floor, or a
        # REPLACK beacon would let peers skip the gated window.
        self.floor = None

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def total_bytes(self) -> int:
        return self._bytes

    @property
    def first_uuid(self) -> int:
        return self._uuids[0] if self._uuids else 0

    def push(self, uuid: int, name: bytes, args: list) -> None:
        if uuid <= self.last_uuid:
            raise ValueError(f"repl_log uuids must be increasing: {uuid} <= {self.last_uuid}")
        # args are almost always Bulk; avoid the recursive msg_size call on
        # the op hot path
        size = len(name)
        for a in args:
            v = getattr(a, "val", None)
            size += len(v) if type(v) is bytes else msg_size(a)
        self._entries.append(ReplEntry(uuid, self.last_uuid, name, args, size))
        self._uuids.append(uuid)
        self._bytes += size
        self.last_uuid = uuid
        if self.on_append is not None:
            self.on_append(uuid, name, args)
        while self._bytes > self.cap and len(self._entries) > 1:
            ev = self._entries.popleft()
            self._uuids.popleft()
            self._bytes -= ev.size
            self.evicted_up_to = ev.uuid

    def push_many(self, cmds: list) -> None:
        """Append a planned run of `(uuid, name, args)` tuples in one pass
        (the serve coalescer's flush — server/serve.py).  Semantically
        identical to looping `push` (pinned by tests/test_serve_coalesce),
        but the ring makes ONE eviction sweep at the end instead of one
        per entry, and the hot-loop attribute churn collapses to locals.
        Uuids must be strictly increasing, like every push."""
        if not cmds:
            return
        entries = self._entries
        uuids = self._uuids
        prev = self.last_uuid
        added = 0
        for uuid, name, args in cmds:
            if uuid <= prev:
                raise ValueError(
                    f"repl_log uuids must be increasing: {uuid} <= {prev}")
            size = len(name)
            for a in args:
                # Bulk is ~every argument; dodge the getattr probe
                if type(a) is Bulk:
                    size += len(a.val)
                else:
                    v = getattr(a, "val", None)
                    size += len(v) if type(v) is bytes else msg_size(a)
            entries.append(ReplEntry(uuid, prev, name, args, size))
            uuids.append(uuid)
            added += size
            prev = uuid
        self._bytes += added
        self.last_uuid = prev
        if self.on_append is not None:
            for uuid, name, args in cmds:
                self.on_append(uuid, name, args)
        while self._bytes > self.cap and len(entries) > 1:
            ev = entries.popleft()
            uuids.popleft()
            self._bytes -= ev.size
            self.evicted_up_to = ev.uuid

    def can_resume_from(self, uuid: int) -> bool:
        """Is an incremental stream starting after `uuid` gap-free?
        (partial vs full sync decision — reference push.rs:95-110)."""
        return uuid >= self.evicted_up_to

    def next_after(self, uuid: int) -> Optional[ReplEntry]:
        """The oldest VISIBLE entry with uuid > `uuid` (the next frame
        to push; entries at/above the emission floor are invisible)."""
        i = bisect_right(self._uuids, uuid)
        if i >= len(self._entries):
            return None
        e = self._entries[i]
        if self.floor is not None:
            f = self.floor()
            if f is not None and e.uuid >= f:
                return None
        return e

    def run_after(self, uuid: int, max_n: int,
                  max_bytes: Optional[int] = None) -> list:
        """The RUN of up to `max_n` consecutive entries after `uuid` —
        the batch wire protocol's drain unit (replica/link.py push
        loop).  Equivalent to `max_n` chained `next_after` calls, in one
        O(i + max_n) slice instead of `max_n` bisects; entries in a run
        are gap-free by construction (the ring only evicts from the
        left, and this snapshot is taken synchronously).  `max_bytes`
        additionally cuts the run once the cumulative entry sizes pass
        it (always keeping at least one entry) so a backlog of huge
        values cannot balloon one wire frame — the transport
        backpressure bound the per-frame path got from its 64-frame
        drain cadence."""
        entries = self._entries
        n = len(entries)
        i = bisect_right(self._uuids, uuid)
        if i >= n:
            return []
        # rotate instead of islice-from-zero: a steady-state cursor sits
        # at the TAIL of the ring, where islice would walk the whole
        # deque per call; rotation costs O(min(i, n - i)) — cheap at
        # both ends, where every real cursor lives
        entries.rotate(-i)
        # cap at n - i: the rotation parks the first i entries at the
        # BACK, and an uncapped islice would wrap onto them
        run = list(islice(entries, 0, min(max_n, n - i)))
        entries.rotate(i)
        if self.floor is not None:
            f = self.floor()
            if f is not None:
                for k, e in enumerate(run):
                    if e.uuid >= f:
                        del run[k:]
                        break
        if max_bytes is not None:
            total = 0
            for k, e in enumerate(run):
                total += e.size
                if total > max_bytes and k:
                    del run[k:]
                    break
        return run

    def at(self, uuid: int) -> Optional[ReplEntry]:
        """Exact-uuid lookup (REPLLOG AT — reference server.rs:318-350)."""
        i = bisect_left(self._uuids, uuid)
        if i < len(self._uuids) and self._uuids[i] == uuid:
            return self._entries[i]
        return None

    def uuids(self) -> list[int]:
        return list(self._uuids)

    def entry_as_msg(self, e: ReplEntry) -> Msg:
        """The stored command as a RESP array (REPLLOG AT reply)."""
        from ..resp.message import Bulk
        return Arr([Bulk(e.name), *e.args])


class MergedReplLog:
    """One HLC-ordered view over per-shard repl-log SEGMENTS (the
    shard-per-core serving plane, server/serve_shards.py).

    Each serve worker owns a keyspace shard; its locally-executed writes
    append to that shard's segment (mirrored parent-side in ack order,
    so every segment's uuids are strictly increasing).  Uuids are minted
    centrally by the parent HLC at ROUTE time, so the sorted union of
    the segments is exactly the uuid sequence a single-loop node would
    have produced — the push loop merge-sorts the segments back into
    one stream and the replication protocol (watermarks, REPLACK
    beacons, partial-resync decisions) is unchanged on the wire.

    Emission gating: an entry is VISIBLE only below the floor — the
    smallest write uuid minted but not yet landed (acked) by its shard
    worker.  A later ack can never introduce an entry below the floor
    (workers land their routed commands in mint order), so the merged
    stream is strictly increasing by construction; `pending_high` keeps
    `last_uuid` covering in-flight writes so the push loop never
    declares the stream drained (and never sends a REPLACK beacon the
    peer could fast-forward over un-landed ops).

    The parent's own barrier-plane writes (MEET/FORGET and any other
    loop-executed command) land synchronously in `self.local` — segment
    index n_shards — through the normal `push` entry point."""

    def __init__(self, n_shards: int, cap_bytes: int = ReplLog.DEFAULT_CAP):
        self.cap = cap_bytes
        self.segments = [ReplLog(cap_bytes) for _ in range(n_shards + 1)]
        self.local = self.segments[n_shards]
        # plane callbacks, installed by ServeShardPlane: floor() -> the
        # smallest minted-but-unlanded write uuid (None = nothing in
        # flight); pending_high() -> the NEWEST such uuid (0 = none)
        self.floor = lambda: None
        self.pending_high = lambda: 0
        # watermark fences (boot-restore / reset_for_full_resync set
        # these through the same attribute names ReplLog exposes)
        self._fence_last = 0
        self._fence_evicted = 0

    # ----------------------------------------------------- ReplLog surface

    def __len__(self) -> int:
        return sum(len(s) for s in self.segments)

    @property
    def total_bytes(self) -> int:
        return sum(s.total_bytes for s in self.segments)

    @property
    def first_uuid(self) -> int:
        firsts = [s.first_uuid for s in self.segments if len(s)]
        return min(firsts) if firsts else 0

    @property
    def landed_last_uuid(self) -> int:
        """Newest uuid actually LANDED in a segment (or fenced): what a
        full-sync dump may record as its watermark — unlike `last_uuid`
        it excludes minted-but-in-flight writes, whose effects are not
        yet in any exportable state."""
        return max(max(s.last_uuid for s in self.segments),
                   self._fence_last)

    @property
    def last_uuid(self) -> int:
        """Newest uuid this node has COMMITTED to its stream: landed
        entries, fences, and minted-but-in-flight writes (the push loop
        must not consider the stream drained below those)."""
        return max(self.landed_last_uuid, self.pending_high())

    @last_uuid.setter
    def last_uuid(self, uuid: int) -> None:
        self._fence_last = uuid

    @property
    def evicted_up_to(self) -> int:
        """A resume below ANY segment's eviction horizon is gappy in the
        merged stream, so the merged horizon is the max."""
        return max(max(s.evicted_up_to for s in self.segments),
                   self._fence_evicted)

    @evicted_up_to.setter
    def evicted_up_to(self, uuid: int) -> None:
        self._fence_evicted = uuid

    def push(self, uuid: int, name: bytes, args: list) -> None:
        """Barrier-plane write (executed on the parent loop)."""
        self.local.push(uuid, name, args)

    def can_resume_from(self, uuid: int) -> bool:
        return uuid >= self.evicted_up_to

    def _visible(self, uuid: int) -> bool:
        f = self.floor()
        return f is None or uuid < f

    def next_after(self, uuid: int) -> Optional[ReplEntry]:
        """Merge-sort step: the smallest VISIBLE uuid > `uuid` across
        all segments.  `prev_uuid` stays the per-segment chain — in the
        merged stream a segment's prev is always <= the merged cursor
        (it was emitted earlier), so the peer's gap check only fires on
        true eviction gaps, exactly as on a single-segment stream."""
        best: Optional[ReplEntry] = None
        for s in self.segments:
            e = s.next_after(uuid)
            if e is not None and (best is None or e.uuid < best.uuid):
                best = e
        if best is not None and not self._visible(best.uuid):
            return None
        return best

    def run_after(self, uuid: int, max_n: int,
                  max_bytes: Optional[int] = None) -> list:
        """The maximal SINGLE-SEGMENT run after `uuid` that preserves
        the merged HLC order: start at the globally smallest visible
        uuid > `uuid`, extend within that entry's segment while every
        further entry stays below BOTH the floor and every other
        segment's next pending uuid.  Concatenated runs therefore
        replay to exactly the per-op merged stream (`next_after`
        repeated) — the property the batch wire protocol's run tests
        pin — while shard-per-core serving feeds whole per-shard runs
        to the batch path without re-sorting per op."""
        cands = []
        for s in self.segments:
            e = s.next_after(uuid)
            if e is not None:
                cands.append((e.uuid, s))
        if not cands:
            return []
        cands.sort(key=lambda c: c[0])
        best_seg = cands[0][1]
        bound = cands[1][0] if len(cands) > 1 else None
        f = self.floor()
        if f is not None:
            bound = f if bound is None else min(bound, f)
        run = best_seg.run_after(uuid, max_n, max_bytes)
        if bound is not None:
            for k, e in enumerate(run):
                if e.uuid >= bound:
                    return run[:k]
        return run

    def at(self, uuid: int) -> Optional[ReplEntry]:
        for s in self.segments:
            e = s.at(uuid)
            if e is not None:
                return e
        return None

    def uuids(self) -> list[int]:
        out: list[int] = []
        for s in self.segments:
            out.extend(s.uuids())
        out.sort()
        return out

    def entry_as_msg(self, e: ReplEntry) -> Msg:
        return Arr([Bulk(e.name), *e.args])
