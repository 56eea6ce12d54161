"""CRDT conflict-resolution semantics — the single spec both merge engines
(engine/cpu.py and engine/cuda.py) implement bit-identically.

Derived from the reference's rules (SURVEY.md §2.5):
  * uuid = (unix_ms << 22) | seq, minted per executed command
    (reference src/server.rs:159-173); it is the HLC timestamp that orders
    writes.  uuids are NOT globally unique — two nodes can mint the same one.
  * Register (bytes): last-write-wins on write-time
    (reference src/object.rs:63-77).
  * Counter: per-node (value, uuid) LWW, max(value) on uuid tie; read = Σ
    (reference src/type_counter.rs:59-91).
  * Set/Dict element: visible iff add_time >= del_time — add wins on tie
    (reference src/crdt/lwwhash.rs:32-44); merge = pointwise max of
    (add_time, del_time).
  * Key envelope: alive iff create_time >= delete_time; envelope times merge
    as pointwise max.
  * GC: tombstones are physically removed only once every replica's ack
    watermark has passed them (reference src/server.rs:257-263, db.rs:82-119).

Deliberate fixes over the reference (its merges are order-dependent or
broken — SURVEY.md §"Known reference defects"):
  * every LWW decision that the reference resolves by application order
    (register value on equal create_time, element value on equal add_time)
    is resolved here by the total order on (time, writer_node_id): larger
    wins.  Writer node ids are carried with every register/dict-field write
    for this purpose.  Within one node uuids are strictly monotonic, so
    (time, node) uniquely identifies a write and the tie-break is
    deterministic, commutative and associative.
  * Dict merge is implemented (the reference's panics, lwwhash.rs:176-181).
  * Counter.change advances the stored per-node uuid (the reference never
    does after first insert, type_counter.rs:37-51).
  * Counter slots are cumulative-total registers, not deltas: a slot holds
    the writer node's LIFETIME total as an LWW register (total @ uuid), and
    counter deletes record the delete-observed total as a second LWW
    register (base @ delete-uuid, max-base on exact ties); the visible
    value is Σ over slots of (total - base).  Every component is an LWW
    assignment, so replication is idempotent, reorder-safe, and identical
    to state merges.  (The reference's `delcnt` replays negated deltas —
    cmd.rs:233-254 — which requires exactly-once in-order delivery and
    still diverges when a delete and concurrent increments interleave
    differently on different replicas.)
  * element add/rem are pure pointwise ops — adds always LWW-merge into the
    add side and dels always max into the del side — instead of the
    reference's drop-if-older gates (lwwhash.rs:87-128), so the op path and
    the state-merge path compute the same function and replicas that saw
    different interleavings converge bit-identically.
  * envelope times (ct/mt/dt) merge as max for ALL encodings (the reference
    only does so for Bytes, keeping first-merged otherwise).
  * expire times merge as max (latest expiry wins) — the reference's
    expire_at is last-applied-wins and thus divergent.
"""

from __future__ import annotations

# Encoding tags — wire-compatible with the reference's snapshot enc byte
# (reference src/object.rs:19-22).  6/7 are new: the reference advertises a
# MultiValueRegister and scaffolds a List (README.md:10, vclock.rs, list.rs)
# but never assigns them encodings — this build completes them on the
# element plane (crdt/multivalue.py, crdt/sequence.py docstrings).
ENC_NONE = -1
ENC_COUNTER = 0
ENC_BYTES = 3
ENC_DICT = 4
ENC_SET = 5
ENC_MV = 6
ENC_LIST = 7
# 8 is new: tensor-valued registers (crdt/tensor.py) — dense float
# arrays whose merge is a per-node contributor-slot LWW and whose read
# is a registered strategy reduction (arXiv 2605.19373 two-layer CRDT)
ENC_TENSOR = 8

ENC_NAMES = {ENC_COUNTER: "Counter", ENC_BYTES: "Bytes", ENC_DICT: "LWWDict",
             ENC_SET: "LWWSet", ENC_MV: "MultiValue", ENC_LIST: "List",
             ENC_TENSOR: "Tensor"}

# encodings whose element rows carry value bytes (dict fields, multi-value
# siblings, list entries); set members are valueless
VALUE_ENCS = (ENC_DICT, ENC_MV, ENC_LIST)

# "never written" timestamp sentinel: loses to every real timestamp (real
# uuids are >= 0).  Single definition shared by the store layer and the
# device kernels (ops/segment.py re-exports it).
NEUTRAL_T = -(1 << 62)


def lww_wins(t_a: int, node_a: int, t_b: int, node_b: int) -> bool:
    """True iff write A beats write B under the (time, writer-node) total
    order.  Strict: equal (t, node) pairs mean the same write."""
    return (t_a, node_a) > (t_b, node_b)


def elem_alive(add_t: int, del_t: int) -> bool:
    """Element visibility: add wins on tie (reference lwwhash.rs:32-44)."""
    return add_t >= del_t


def key_alive(ct: int, dt: int) -> bool:
    """Key-level tombstone rule (reference object.rs:50-53)."""
    return ct >= dt


def merge_envelope(ct_a: int, mt_a: int, dt_a: int,
                   ct_b: int, mt_b: int, dt_b: int) -> tuple[int, int, int]:
    return max(ct_a, ct_b), max(mt_a, mt_b), max(dt_a, dt_b)


def merge_counter_slot(val_a: int, t_a: int, val_b: int, t_b: int) -> tuple[int, int]:
    """Per-(key, node) counter slot LWW; max value on uuid tie
    (reference type_counter.rs:59-91)."""
    if t_a > t_b:
        return val_a, t_a
    if t_b > t_a:
        return val_b, t_b
    return max(val_a, val_b), t_a


def merge_register(val_a: bytes, t_a: int, node_a: int,
                   val_b: bytes, t_b: int, node_b: int) -> tuple[bytes, int, int]:
    if lww_wins(t_a, node_a, t_b, node_b):
        return val_a, t_a, node_a
    return val_b, t_b, node_b


def merge_elem(add_a: int, anode_a: int, del_a: int,
               add_b: int, anode_b: int, del_b: int):
    """-> (add_t, add_node, del_t, a_value_wins).  Value follows the winning
    add-side write; del side is a plain max."""
    if lww_wins(add_a, anode_a, add_b, anode_b):
        return add_a, anode_a, max(del_a, del_b), True
    return add_b, anode_b, max(del_a, del_b), False


def updated_at(ct: int, mt: int, dt: int, uuid: int) -> tuple[int, int, int]:
    """Envelope bump on a data write (local or replicated).

    Redesigned from the reference's resurrect-only rule (object.rs:34-48,
    `ct = uuid` iff ct < dt <= uuid), which is order-dependent: replicas that
    interleave the same write/delete ops differently end with different
    create_times.  Here ct is simply the max over all data-write uuids and dt
    the max over all delete uuids, so `alive = ct >= dt` becomes the
    element-level add-wins rule lifted to keys and every envelope component
    is a plain max — commutative, associative, idempotent, and identical
    between the op path and the state-merge path (merge_envelope)."""
    return max(ct, uuid), max(mt, uuid), dt
