"""Overload governor: bounded memory with convergence-preserving shedding.

Every buffer and byte a node holds is accounted here and compared
against two watermarks derived from `CONSTDB_TORCH_MAXMEMORY`:

  soft (`CONSTDB_TORCH_MAXMEMORY_SOFT_PCT`, default 85%) — client DATA writes
      shed with a clean `-OOM …` error.  Reads, admin, deletes/expiry
      (they free memory), and **all replication intake** stay admitted.
  hard (100%) — additionally: flush device-resident merge state, drop
      warm-path caches (digest crc caches, device tensor pools), and
      force a GC sweep (which compacts the element table when dead rows
      dominate) — rate-limited so a node pinned at the ceiling is not
      re-flushing per write.

The admission asymmetry is the convergence-soundness law
(docs/INVARIANTS.md "Degradation laws"): shedding happens at the CLIENT
edge, before an op is applied, logged, or replicated — a shed write
simply never existed, so the delivered-set the mesh must converge on is
unchanged.  Shedding *replication* intake instead would hold back ops
the origin already considers delivered, and the mesh would diverge
(or stall its GC horizon forever).  Replicated ops always land.

Accounting sources (`used_memory`):
  * the keyspace — live numeric rows + incrementally-tracked blob and
    tensor payload bytes (`KeySpace.used_bytes`; BlobList keeps the
    blob gauge exact through every engine path)
  * the repl-log ring (`total_bytes`; a MergedReplLog sums segments)
  * device pools — the engine's pinned win-value and tensor payload
    bytes (`_pool_bytes`/`_tns_bytes`)
  * the encode-once run cache (`node.wire_cache` — the broadcast
    plane's published wire encodings, replica/encode_cache.py)
  * registered extra sources (per-connection applier buffers register a
    callable here, as does the shared-dump compression writer's working
    buffer; they unregister on teardown)

The check is cheap (a few dozen attribute reads) but not free, so the
gate caches its verdict for `check_every` writes; the server cron calls
`tick()` each interval so a quiet node still observes pressure changes.
The watermark is therefore an approximation by design — a handful of
writes may land past the exact byte boundary — but every *shed* write
produced exactly one clean error and zero state, which is the invariant
the chaos oracle certifies.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)

# the exact error reply a shed write receives (Redis-style leading code;
# chaos/resource.py asserts shed replies byte-match this)
OOM_ERR = (b"OOM write rejected: node over CONSTDB_TORCH_MAXMEMORY soft "
           b"watermark (reads, deletes, and replication stay admitted)")

STATE_OK, STATE_SOFT, STATE_HARD = 0, 1, 2
_STATE_NAMES = {STATE_OK: "ok", STATE_SOFT: "soft", STATE_HARD: "hard"}

# min seconds between hard-watermark reclaim sweeps (flush + cache drop
# + GC): a node pinned at the ceiling must not re-flush per check
_HARD_ACTION_PERIOD = 1.0


class OverloadGovernor:
    """Per-node memory accounting + watermark decisions (module doc)."""

    __slots__ = ("node", "maxmemory", "soft_pct", "soft_bytes", "sources",
                 "check_every", "reclaim_gc", "_state", "_countdown",
                 "_used", "_last_hard", "_now")

    def __init__(self, node, maxmemory: Optional[int] = None,
                 soft_pct: Optional[float] = None,
                 now: Callable[[], float] = time.monotonic) -> None:
        self.node = node
        self.sources: list[Callable[[], int]] = []
        self.check_every = 64
        # may the hard-watermark reclaim run this node's OWN gc()?
        # False on shard-worker nodes (parallel/serve_pool.py): a
        # worker's ReplicaManager has no peers, so Node.gc_horizon()
        # would fall back to the local clock and collect tombstones no
        # peer has acked — the resurrection class the coverage-gated
        # horizon (docs/INVARIANTS.md) exists to prevent.  Worker GC is
        # parent-driven with the real cluster horizon (the cron's
        # serve_plane.gc), so the reclaim only skips the sweep, not
        # collection itself.
        self.reclaim_gc = True
        self._state = STATE_OK
        self._countdown = 0
        self._used = 0
        self._last_hard = 0.0
        self._now = now
        if maxmemory is None or soft_pct is None:
            from ..conf import env_float, env_int
            if maxmemory is None:
                maxmemory = env_int("CONSTDB_TORCH_MAXMEMORY", 0)
            if soft_pct is None:
                soft_pct = env_float("CONSTDB_TORCH_MAXMEMORY_SOFT_PCT", 85.0)
        self.configure(maxmemory, soft_pct)

    def configure(self, maxmemory: Optional[int] = None,
                  soft_pct: Optional[float] = None) -> None:
        """(Re)set the cap — ServerApp overrides the env defaults, shard
        workers install their per-shard slice of the node cap."""
        if maxmemory is not None:
            self.maxmemory = max(0, int(maxmemory))
        if soft_pct is not None:
            self.soft_pct = float(soft_pct)
        self.soft_bytes = int(self.maxmemory * self.soft_pct / 100.0)
        self._countdown = 0

    # ---------------------------------------------------------- accounting

    def register_source(self, fn: Callable[[], int]) -> None:
        self.sources.append(fn)

    def unregister_source(self, fn: Callable[[], int]) -> None:
        try:
            self.sources.remove(fn)
        except ValueError:
            pass

    def used_memory(self) -> int:
        """Governed total, from the incrementally-maintained gauges —
        O(sources), no table walks."""
        node = self.node
        eng = node.engine
        # getattr: a serve worker's repl_log is the plane's _TapLog
        # (drained into the parent's segments per ack — the parent's
        # MergedReplLog accounts those bytes)
        wire_cache = getattr(node, "wire_cache", None)
        read_cache = getattr(node, "read_cache", None)
        total = node.ks.used_bytes() \
            + (getattr(node.repl_log, "total_bytes", 0) or 0) \
            + (getattr(eng, "_pool_bytes", 0) or 0) \
            + (getattr(eng, "_tns_bytes", 0) or 0) \
            + (wire_cache.used_bytes() if wire_cache is not None else 0) \
            + (read_cache.used_bytes() if read_cache is not None else 0)
        for fn in self.sources:
            total += fn()
        return total

    # ----------------------------------------------------------- decisions

    @property
    def state(self) -> int:
        return self._state

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self._state]

    @property
    def last_used(self) -> int:
        """used_memory at the last refresh (INFO; 0 until one ran)."""
        return self._used

    def shed_writes(self, weight: int = 1) -> bool:
        """The write-path gate (commands.execute / the serve planners):
        True = shed this client data write with OOM_ERR.  Re-evaluates
        the watermarks every `check_every` WRITES of pressure; stale
        verdicts in between are the documented approximation.  `weight`:
        how many writes this one decision covers — the serve coalescer
        gates once per pipelined CHUNK, so it weighs the whole chunk
        (an unweighted per-chunk decrement would stretch the refresh
        window to check_every * chunk_size writes; on a shard worker,
        which has no cron tick, pressure could go unseen for tens of
        thousands of writes)."""
        if not self.maxmemory:
            return False
        self._countdown -= weight
        if self._countdown < 0:
            self._refresh()
        return self._state != STATE_OK

    def tick(self) -> None:
        """Cron hook: re-evaluate now (a quiet node must still see
        pressure from replication intake / pool growth) and run the
        hard-watermark reclaim if due."""
        if self.maxmemory:
            self._refresh()

    def _refresh(self) -> None:
        used = self._used = self.used_memory()
        self._countdown = self.check_every
        prev = self._state
        if used >= self.maxmemory:
            self._state = STATE_HARD
            self._on_hard()
        elif used >= self.soft_bytes:
            self._state = STATE_SOFT
        else:
            self._state = STATE_OK
        if self._state != prev:
            lvl = logging.WARNING if self._state else logging.INFO
            log.log(lvl, "overload state %s -> %s (used_memory=%d, "
                    "maxmemory=%d, soft=%d)", _STATE_NAMES[prev],
                    self.state_name, used, self.maxmemory, self.soft_bytes)
            x = self.node.stats.extra
            x["oom_state_changes"] = x.get("oom_state_changes", 0) + 1

    def _on_hard(self) -> None:
        """Hard-watermark reclaim: flush device-resident state down to
        the host, release device pools, drop rebuildable warm caches,
        and force a GC sweep (which compacts the element table when dead
        rows dominate).  Rate-limited; never touches live CRDT state, so
        it degrades speed, never convergence."""
        now = self._now()
        if now - self._last_hard < _HARD_ACTION_PERIOD:
            return
        self._last_hard = now
        node = self.node
        st = node.stats
        st.oom_hard_reclaims += 1
        node.ensure_flushed()
        eng = node.engine
        release = getattr(eng, "release_device_pools", None)
        if release is not None:
            release(node.ks)
        node.ks.release_warm_caches()
        wire_cache = getattr(node, "wire_cache", None)
        if wire_cache is not None:
            # the encode-once cache is exactly a rebuildable warm cache:
            # dropping it costs re-encodes, never correctness
            wire_cache.clear()
        read_cache = getattr(node, "read_cache", None)
        if read_cache is not None:
            # likewise the reply cache: dropping it costs re-reads only
            read_cache.clear()
        if self.reclaim_gc:
            # gc() re-flushes (a no-op now) and compacts when dead rows
            # dominate; collection is bounded by the cluster horizon
            # (shard workers skip this — see reclaim_gc above)
            node.gc()
        log.warning("hard watermark: flushed + dropped warm caches "
                    "(used_memory=%d, maxmemory=%d)",
                    self.used_memory(), self.maxmemory)
