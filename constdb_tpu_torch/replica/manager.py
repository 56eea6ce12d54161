"""Replica membership + progress watermarks.

Capability parity with the reference's `ReplicaManager`
(reference src/replica/replica.rs:16-128): membership is itself a CRDT —
an add/del LWW map keyed by peer address — so MEET/FORGET replicate and
merge like any other write, and snapshot REPLICAS sections from different
peers converge.  Each row also carries the four progress watermarks that
drive partial-resync decisions and the GC horizon.

Watermarks (reference ReplicaMeta, replica/replica.rs:131-147):
  uuid_i_sent  — newest entry of MY repl_log I have pushed to this peer
  uuid_i_acked — newest of MY uuids this peer has REPLACKed
  uuid_he_sent — newest of HIS uuids I have applied (my pull progress;
                 doubles as the resume point I request on reconnect)
  uuid_he_acked — newest of his uuids I last REPLACKed back to him

GC horizon: the reference uses min(uuid_he_sent) (replica/replica.rs:87-89),
which only proves peer CLOCKS advanced.  We take
min(uuid_i_acked, uuid_he_sent) per live peer: uuid_i_acked proves the peer
actually holds my stream — including my tombstones — past the horizon, so
physically dropping those tombstones is safe; uuid_he_sent keeps the bound
conservative for tombstones I merged from third parties.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from ..persist.snapshot import ReplicaRecord


@dataclass
class ReplicaMeta:
    addr: str
    node_id: int = 0
    alias: str = ""
    add_t: int = 0
    del_t: int = 0
    uuid_i_sent: int = 0
    uuid_i_acked: int = 0
    uuid_he_sent: int = 0
    uuid_he_acked: int = 0
    # runtime attachment (not replicated): the live link driving this peer
    link: object = field(default=None, repr=False, compare=False)
    # runtime flag (not replicated): set when this peer rejected our SYNC
    # as "forgotten" — we are the expelled node; stop dialing until an
    # inbound connection (someone re-MET us) clears it.  Kept out of the
    # add_t/del_t LWW so it never corrupts replicated membership.
    dial_suspended: bool = field(default=False, compare=False)
    # runtime liveness (not replicated): wall-ms of the last frame received
    # from this peer; 0 = never.  Drives the GC-horizon retention rule.
    last_seen_ms: int = field(default=0, compare=False)
    # flag (not replicated): this peer was excluded from the GC horizon
    # at least once, so tombstones it never saw may have been physically
    # collected.  While the repl_log still covers its resume point,
    # partial replay redelivers the delete OPS losslessly; past that, the
    # pusher forces a STATE-CLEARING full resync (link.py sends the
    # fullsync reset flag, the peer wipes keyspace + repl_log before the
    # merge) so the peer's stale keys cannot resurrect mesh-wide.
    needs_full: bool = field(default=False, compare=False)
    # runtime flag (not replicated): this peer once sent us a REPLBATCH
    # payload we could not decode (replica/coalesce.py apply_wire_batch)
    # — stop advertising CAP_BATCH_STREAM to it, so every re-handshake
    # delivers the redelivery window (and everything after) as ordinary
    # per-frame REPLICATE frames.  Sticky for the process lifetime: a
    # peer that ships one malformed batch will ship another.
    batch_wire_off: bool = field(default=False, compare=False)
    # runtime flag (not replicated): this peer once sent us a compressed
    # frame (REPLBATCH payload or bulk window) we could not validate
    # (utils/compressio.py) — stop advertising CAP_COMPRESS to it, so
    # the redelivery window (and everything after) arrives as the plain
    # byte stream.  Same loud-demotion discipline as batch_wire_off;
    # sticky for the process lifetime.
    compress_wire_off: bool = field(default=False, compare=False)
    # runtime (not replicated): the peer's self-reported CLUSTER
    # COVERAGE — a uuid L such that the peer holds EVERY origin's ops
    # <= L (REPLACK item 5; -1 = legacy peer, never reported).  Gates
    # the GC horizon for THIRD-PARTY tombstones: uuid_i_acked only
    # proves the peer holds MY stream past the horizon, which says
    # nothing about a tombstone another origin minted — collecting on
    # acks alone lets a peer that is partitioned from that origin adopt
    # my watermarks from a later state transfer and silently skip the
    # delete's op replay forever (found by the chaos harness: the
    # removed member resurrected on exactly one node, mesh-wide
    # watermarks all caught up).
    coverage: int = field(default=-1, compare=False)

    @property
    def alive(self) -> bool:
        return self.add_t >= self.del_t

    def record(self) -> ReplicaRecord:
        return ReplicaRecord(self.addr, self.node_id, self.alias, self.add_t,
                             self.del_t, self.uuid_he_sent, self.uuid_he_acked)


class ReplicaManager:
    def __init__(self) -> None:
        self.peers: dict[str, ReplicaMeta] = {}
        # hook: called with (addr, meta) when a NEW live peer appears through
        # a merge (transitive mesh join — reference pull.rs:136-153)
        self.on_new_peer: Optional[Callable[[ReplicaMeta], None]] = None
        # a peer silent beyond this stops pinning min_uuid (0 = never —
        # the default and the reference's behavior, where one dead peer
        # pins GC forever, replica/replica.rs:87-89).  Opt-in via config;
        # ServerApp wires the value.  An excluded peer is forced through
        # a state-clearing full resync on return (link.py reset flag).
        self.gc_peer_retention_ms: int = 0

    # ------------------------------------------------------------ membership

    def get(self, addr: str) -> Optional[ReplicaMeta]:
        return self.peers.get(addr)

    def add(self, addr: str, uuid: int, node_id: int = 0,
            alias: str = "") -> ReplicaMeta:
        """MEET: (re-)register a peer at time `uuid` (add-side LWW)."""
        m = self.peers.get(addr)
        if m is None:
            from ..utils.hlc import now_ms
            # the retention clock starts at registration: a peer we never
            # hear from gets exactly one retention window before it stops
            # pinning the GC horizon (a 0 stamp would exempt restored-dead
            # peers forever)
            m = ReplicaMeta(addr, node_id=node_id, alias=alias, add_t=uuid,
                            last_seen_ms=now_ms())
            self.peers[addr] = m
        else:
            if uuid > m.add_t:
                m.add_t = uuid
            if node_id:
                m.node_id = node_id
            if alias:
                m.alias = alias
        if m.alive:
            m.dial_suspended = False  # explicit (re-)MEET re-admits
        return m

    def forget(self, addr: str, uuid: int) -> bool:
        """FORGET: tombstone a peer (del-side LWW).  Registered as a real
        command, unlike the reference (replica.rs:77-86 defines `forget` but
        never registers it — SURVEY.md §"Known reference defects")."""
        m = self.peers.get(addr)
        if m is None:
            m = ReplicaMeta(addr)
            self.peers[addr] = m
        if uuid > m.del_t:
            m.del_t = uuid
            return True
        return False

    def live_peers(self) -> list[ReplicaMeta]:
        return [m for m in self.peers.values() if m.alive]

    def merge_records(self, rows: Iterable[ReplicaRecord],
                      my_addr: str = "",
                      adopt_watermarks: bool = False) -> list[ReplicaMeta]:
        """Merge a REPLICAS snapshot section (LWW per addr); returns peers
        that became live-and-new (candidates for transitive MEET).

        `adopt_watermarks=True` additionally max-merges each record's
        PULL WATERMARK (uuid_he_sent).  That is ONLY lossless when the
        caller merges the snapshot's full keyspace state in the same
        operation — ops below the recorded watermark are then already
        reflected locally, so resuming from it skips nothing.  The two
        snapshot-backed call sites (replica/link.py full-sync apply,
        server/io.py boot restore) pass True; a bare membership merge
        (e.g. a future gossip-style exchange) MUST NOT — adopting
        watermarks without the backing state silently skips op
        re-delivery (ADVICE.md round 5: the coupling was previously
        enforced by comment only).  For the snapshot-backed sites,
        adopting is itself a convergence requirement, not merely a
        saving: a cold-restarted node dialing with resume 0 makes peers
        replay their whole ring — re-delivering ADDS whose tombstones
        the mesh already GC-collected, resurrecting deleted members with
        no surviving delete op to kill them again (round-5 chaos
        suite)."""
        fresh = []
        for r in rows:
            if r.addr == my_addr:
                continue
            m = self.peers.get(addr := r.addr)
            if m is None:
                from ..utils.hlc import now_ms
                m = ReplicaMeta(addr, last_seen_ms=now_ms())
                self.peers[addr] = m
                is_new = True
            else:
                is_new = not m.alive
            if r.add_t > m.add_t:
                m.add_t = r.add_t
            if r.del_t > m.del_t:
                m.del_t = r.del_t
            if r.node_id:
                m.node_id = r.node_id
            if r.alias and not m.alias:
                m.alias = r.alias
            if adopt_watermarks and r.uuid_he_sent > m.uuid_he_sent:
                m.uuid_he_sent = r.uuid_he_sent
            if is_new and m.alive:
                fresh.append(m)
        for m in fresh:
            if self.on_new_peer is not None:
                self.on_new_peer(m)
        return fresh

    def records(self) -> list[ReplicaRecord]:
        """Membership dump for the snapshot REPLICAS section."""
        return [m.record() for m in self.peers.values()]

    # -------------------------------------------------------------- horizon

    def min_uuid(self) -> Optional[int]:
        """GC tombstone horizon (see module docstring); None when no live
        peers (standalone nodes collect up to their own clock).

        Retention rule: a live peer SILENT for longer than
        `gc_peer_retention_ms` stops pinning the horizon — otherwise one
        crashed peer freezes tombstone collection mesh-wide forever.  The
        tradeoff is bounded: a returning excluded peer is lossless while
        the repl_log still covers its resume point (delete OPS replay even
        after their tombstones were physically collected); only past BOTH
        windows can its stale keys resurrect (see ReplicaMeta.needs_full)."""
        from ..utils.hlc import now_ms
        live = self.live_peers()
        if not live:
            return None
        retention = self.gc_peer_retention_ms
        now = now_ms()
        pinning = []
        for m in live:
            if retention and now - m.last_seen_ms > retention:
                m.needs_full = True
                continue
            pinning.append(m)
        if not pinning:
            return None
        horizon = None
        for m in pinning:
            pin = min(m.uuid_i_acked, m.uuid_he_sent)
            if m.coverage >= 0:
                # coverage-aware horizon: a third-party tombstone is
                # collectable only once this peer holds EVERY origin's
                # stream past it — the property that makes snapshot/
                # delta watermark ADOPTION sound (see ReplicaMeta.
                # coverage).  Legacy peers (-1) keep the ack-only bound.
                pin = min(pin, m.coverage)
            horizon = pin if horizon is None else min(horizon, pin)
        return horizon

    def cluster_coverage(self) -> int:
        """The uuid L this node may advertise as held across EVERY
        origin stream: min over live peers of the applied pull watermark
        (uuid_he_sent); our own stream is trivially held.  Advertised in
        every REPLACK (replica/link.py) so peers' GC horizons can gate
        third-party tombstone collection on it."""
        live = self.live_peers()
        if not live:
            return 0
        return min(m.uuid_he_sent for m in live)

    # ------------------------------------------------------------- REPLICAS

    def describe(self) -> list[tuple[str, ReplicaMeta]]:
        """Rows for the REPLICAS command (reference
        replica/replica.rs:63-85)."""
        return sorted(self.peers.items())
