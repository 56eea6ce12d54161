"""Command dispatch table and handlers — the node's client API surface.

Capability parity with the reference's command layer (reference src/cmd.rs
static COMMANDS table + Cmd::exec, src/type_counter.rs, src/type_set.rs,
src/type_hash.rs), over the columnar KeySpace instead of per-key heap
objects.

Dispatch contract (reference src/cmd.rs:43-63):
  * client commands mint a fresh HLC uuid; replicated commands run with the
    ORIGINATOR's (nodeid, uuid) and are never re-replicated.
  * on success, WRITE commands without NO_REPLICATE are appended verbatim to
    the repl_log; NO_REPLICATE handlers may push rewritten commands
    themselves (DEL rewrites into delcnt/delbytes/delset/deldict —
    reference src/cmd.rs:220-296).
  * REPL_ONLY commands are rejected from clients; CLIENT_ONLY commands are
    rejected from the replication stream (an enforcement the reference
    documents but does not code — src/cmd.rs:220 comment).

Deliberate fixes over the reference (documented in crdt/semantics.py):
  * SPOP replicates the deterministic rewrite `srem key <member>` instead of
    replaying the random pop on every replica (reference type_set.rs:85-117
    would diverge).
  * uuid minting is write-only (the reference's `flags | COMMAND_WRITE > 0`
    precedence bug makes every command a write — src/cmd.rs:49).
  * applying a replicated command advances the local HLC past the origin
    uuid, so later local writes sort after everything already seen.
  * EXPIRE/EXPIREAT/TTL exist (the reference ships the expiry machinery with
    no command — SURVEY.md §"Known reference defects"); expiry merges as
    max, so EXPIRE extends but never shortens a TTL.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Optional, TYPE_CHECKING

from ..crdt import semantics as S
from ..errors import (CstError, InvalidRequestMsg, UnknownCmd, UnknownSubCmd,
                      WrongArity)
from ..resp.message import (Arr, Bulk, Err, Int, Msg, NIL, NO_REPLY, OK,
                            as_bytes, as_int, as_uint)
from ..store.keyspace import FAMILIES as ALL_FAMILIES
from ..utils.hlc import now_ms, SEQ_BITS

if TYPE_CHECKING:
    from .node import Node

# --- command flags (parity: reference src/cmd.rs:80-85) ---
CMD_READONLY = 1
CMD_WRITE = 2
CMD_CTRL = 4
CMD_NO_REPLICATE = 8
CMD_NO_REPLY = 16
CMD_REPL_ONLY = 32
CMD_CLIENT_ONLY = 64
# data-GROWING client writes: shed with a clean -OOM error past the
# maxmemory soft watermark (server/overload.py).  Deletes/removals/
# expiry are deliberately NOT flagged (they free memory), admin and
# membership never are, and the replication path never consults the
# flag at all — replicated ops must always land or the mesh diverges
# (docs/INVARIANTS.md "Degradation laws").
CMD_DENYOOM = 128


class Command:
    __slots__ = ("name", "handler", "flags", "families")

    def __init__(self, name: bytes, handler: Callable, flags: int,
                 families: tuple = ALL_FAMILIES):
        self.name = name
        self.handler = handler
        self.flags = flags
        # CRDT planes a write can touch — scopes the keyspace version bump
        # so a resident merge engine only drops the device mirrors this
        # command could actually have invalidated (engine/cuda.py)
        self.families = families

    @property
    def is_write(self) -> bool:
        return bool(self.flags & CMD_WRITE)


COMMANDS: dict[bytes, Command] = {}


def register(name: str, flags: int, families: tuple = ALL_FAMILIES):
    def deco(fn):
        cmd = Command(name.encode(), fn, flags, families)
        COMMANDS[cmd.name] = cmd
        return fn
    return deco


# --------------------------------------------------------------------
# read plane classification (server/serve.py read planner + the
# dispatch-time narrow flush below).
# --------------------------------------------------------------------

class ReadSpec:
    """How the serve coalescer's read planner executes one key-scoped
    read command as part of a batched read run (server/serve.py
    _run_read_batch): `kind` selects the vectorized gather + reply
    shape, `enc` the required key encoding (None = get's own dispatch),
    `families` the CRDT planes the read observes (its narrow
    flush-before-read set), `arity` the exact frame length the planner
    accepts (anything else falls back to the per-command path, which
    raises the exact arity/type error)."""

    __slots__ = ("kind", "enc", "families", "arity")

    def __init__(self, kind: str, enc, families: tuple, arity: int):
        self.kind = kind
        self.enc = enc
        self.families = families
        self.arity = arity


SERVE_READS: dict[bytes, ReadSpec] = {}

# Which CRDT planes each READONLY command observes — the dispatch-time
# narrow read barrier: execute() flushes ONLY these families for a
# listed read (ensure_flushed_for), so a device-resident engine whose
# listed planes are clean serves the read with ZERO flush downloads
# (the TENSOR.GET device-first pattern from round 13, generalized to
# the scalar families).  Reads not listed here (desc, INFO-adjacent
# probes) keep the blanket flush.  The tensor reads observe only the
# env plane on host — their payload truth stays in the resident device
# pools (Node.tensor_read); see the note at the old TENSOR_DEVICE_READS
# site in the dispatch body.
READ_FLUSH_FAMILIES: dict[bytes, tuple] = {
    b"get": ("env", "reg", "cnt"),
    b"smembers": ("env", "el"),
    b"scnt": ("env", "el"),
    b"sismember": ("env", "el"),
    b"hget": ("env", "el"),
    b"hgetall": ("env", "el"),
    b"hlen": ("env", "el"),
    b"lrange": ("env", "el"),
    b"llen": ("env", "el"),
    b"mvget": ("env", "el"),
    b"ttl": ("env",),
    b"tensor.get": ("env",),
    b"tensor.stat": ("env",),
}


def serve_read(name: str, kind: str, enc=None, arity: int = 2):
    """Register the command `name` with the serve-path READ planner
    (stacked ABOVE @register so the command exists when this runs).
    Planned reads are served from batched gathers + the versioned reply
    cache instead of acting as per-command barriers; the family set the
    plan flushes comes from READ_FLUSH_FAMILIES (one source for the
    lone-read and batched-read narrow barriers), and the KEY-CONFINED
    lint rule statically checks the decorated handler like it does the
    write planners' (constdb_tpu/analysis/rules.py) — the read planner
    routes and caches by the FIRST argument alone."""
    def deco(fn):
        cmd = COMMANDS[name.encode()]
        assert cmd.flags & CMD_READONLY, name
        SERVE_READS[cmd.name] = ReadSpec(
            kind, enc, READ_FLUSH_FAMILIES[cmd.name], arity)
        return fn
    return deco


class ArgIter:
    """Arity-checked argument cursor (parity: reference NextArg,
    src/cmd.rs:348-397)."""

    __slots__ = ("items", "pos", "cmd")

    def __init__(self, items: list, cmd: str = ""):
        self.items = items
        self.pos = 0
        self.cmd = cmd

    def _next(self) -> Msg:
        if self.pos >= len(self.items):
            cmd = self.cmd
            if isinstance(cmd, bytes):
                cmd = cmd.decode("utf-8", "replace")
            raise WrongArity(cmd)
        m = self.items[self.pos]
        self.pos += 1
        return m

    def next_bytes(self) -> bytes:
        return as_bytes(self._next())

    def next_int(self) -> int:
        return as_int(self._next())

    def next_uint(self) -> int:
        return as_uint(self._next())

    def next_str(self) -> str:
        return self.next_bytes().decode("utf-8", "replace")

    @property
    def has_more(self) -> bool:
        return self.pos < len(self.items)

    def rest_bytes(self) -> list[bytes]:
        out = []
        while self.has_more:
            out.append(self.next_bytes())
        return out


class ExecCtx:
    """Per-execution context: who wrote, at what HLC time, via which path."""

    __slots__ = ("uuid", "nodeid", "from_repl", "client")

    def __init__(self, uuid: int, nodeid: int, from_repl: bool, client=None):
        self.uuid = uuid
        self.nodeid = nodeid
        self.from_repl = from_repl
        self.client = client


def execute(node: "Node", req, client=None, uuid=None) -> Msg:
    """Client-path dispatch (reference Cmd::exec, src/cmd.rs:43-53).

    `uuid`: a pre-minted HLC uuid for this command (shard-per-core
    serving, server/serve_shards.py — the PARENT process is the clock
    authority and mints at route time with the same tick(is_write)
    discipline this function applies, so the uuid a worker receives is
    exactly the one a single-loop node would have minted here).  None =
    mint locally (the default, and the only path on shards=1)."""
    items = req.items if isinstance(req, Arr) else list(req)
    if not items:
        return Err(b"empty command")
    head = items[0]
    name = head.val if type(head) is Bulk else None
    if name is None:
        try:
            name = as_bytes(head)
        except CstError as e:
            return Err(e.resp_error())
    cmd = COMMANDS.get(name)
    if cmd is None:
        # commands usually arrive lowercase already; pay for .lower() only
        # on the miss
        name = name.lower()
        cmd = COMMANDS.get(name)
        if cmd is None:
            return Err(UnknownCmd(name.decode("utf-8", "replace")).resp_error())
    if cmd.flags & CMD_REPL_ONLY:
        return Err(b"this command can only be sent by replicas")
    node.stats.cmds_processed += 1
    cl = node.cluster
    if cl is not None and len(items) > 1 and shard_routable(cmd):
        # slot routing (cluster/slots.py): every data command is FIRST-
        # KEY-CONFINED (the KEY-CONFINED lint convention), so the slot
        # decision needs only items[1].  A redirect mints NO uuid,
        # touches NO state, and replicates NOTHING — to this node the
        # command never happened.  The replication path never routes:
        # replicated ops are already group-scoped by construction (the
        # writer routed), and must always land (apply_replicated).
        try:
            redirect = cl.route(as_bytes(items[1]), cmd.is_write)
        except CstError:
            redirect = None  # unkeyable arg: the handler's exact error
        if redirect is not None:
            return redirect
    if cmd.flags & CMD_DENYOOM and node.governor.shed_writes():
        # maxmemory shed, at the CLIENT edge only: nothing was applied,
        # logged, or replicated — this write never existed, so the
        # mesh's delivered set (and its convergence) is untouched.  The
        # replication path (apply_replicated) never gates: replicated
        # ops must always land (server/overload.py module doc).
        node.stats.oom_shed_writes += 1
        from .overload import OOM_ERR
        return Err(OOM_ERR)
    fams = READ_FLUSH_FAMILIES.get(name)
    if fams is not None:
        # narrow read barrier: a listed read observes only `fams`, so a
        # resident engine flushes nothing when those planes are clean.
        # The tensor reads additionally serve DEVICE-FIRST
        # (Node.tensor_read): they touch only the env plane on host and
        # the host-authoritative slot stamps — the payload truth stays
        # in the resident pools, so the blanket flush would force the
        # very dirty-row round-trip the steady tensor path exists to
        # avoid.
        node.ensure_flushed_for(fams)
    else:
        node.ensure_flushed()  # device merge results become readable
    if uuid is None:
        uuid = node.hlc.tick(cmd.is_write)
    ctx = ExecCtx(uuid, node.node_id, False, client)
    args = ArgIter(items[1:], name)
    try:
        reply = cmd.handler(node, ctx, args)
    except CstError as e:
        if cmd.is_write:
            _invalidate_read_cache(node, cmd, items[1:])
        return Err(e.resp_error())
    if cmd.is_write:
        _touch_written(node, cmd, items)
        # invalidate-before-visible: the reply cache drops this key's
        # entries before any later read can observe the write
        # (server/read_cache.py; every data command is first-key-
        # confined, the KEY-CONFINED convention — element writes
        # member-scoped on this success path)
        _invalidate_read_cache(node, cmd, items[1:], scoped=True)
        if not (cmd.flags & CMD_NO_REPLICATE):
            node.replicate_cmd(uuid, name, items[1:])
    elif client is not None and client.tracking == 1 and \
            fams is not None and len(items) > 1:
        # default-mode client tracking (server/tracking.py): record the
        # key this tracked connection just read — the listed key-scoped
        # reads (READ_FLUSH_FAMILIES) are exactly the first-key-confined
        # data reads, so items[1] is the one key the reply observes
        try:
            node.tracking.note_read(client, as_bytes(items[1]))
        except CstError:
            pass
    return reply


def _touch_written(node: "Node", cmd: Command, items: list) -> None:
    """Bump the planes a client write changed.  Every data command's
    writes are confined to the key in its first argument (the KEY-CONFINED
    convention), so the bump names that key: a resident engine then
    patches the key's rows into its mirrors instead of rebuilding whole
    planes (the serve coalescer's barriers, the isolated writes and DELs,
    land between device rounds).  Every row belongs to a key, so a write
    whose key does not exist afterwards (a DEL of an absent key) wrote no
    row and bumps nothing.  A write without a key argument bumps whole."""
    if len(items) > 1 and cmd.families and not cmd.flags & CMD_CTRL:
        try:
            kid = node.ks.lookup(as_bytes(items[1]))
        except CstError:
            kid = None
        if kid is not None:
            if kid >= 0:
                node.ks.touch_key(kid, *cmd.families)
            return
    node.ks.touch(*cmd.families)


# element writes whose touched members are exactly their args —
# member-scoped reply-cache invalidation (sismember/hget entries for
# OTHER members survive; read_cache.invalidate_key_members).  The value
# is the arg stride (hset interleaves field/value pairs).
_MEMBER_WRITE_STRIDE = {b"sadd": 1, b"srem": 1, b"hdel": 1, b"hset": 2}


def _invalidate_read_cache(node: "Node", cmd: Command, args: list,
                           scoped: bool = False) -> None:
    """Reply-cache intake hook for the per-command write paths (client
    dispatch + per-frame replication apply).  Membership commands
    (empty `families`) touch no keyspace state; CTRL takes subcommands,
    not keys, so it clears outright rather than mis-scope; everything
    else is first-key-confined — and element writes additionally
    member-scoped when `scoped` (the SUCCESS path only: an errored
    handler gets the conservative whole-key drop).  Invalidating on the
    ERROR path too is deliberate — a handler that raised mid-mutation
    must not leave a stale cached reply behind.

    The tracked-client push stream (server/tracking.py) taps the same
    seam under its own gate: tracking is key-granular on the wire, so
    member-scoped writes still push the whole key."""
    tr = node.tracking
    if tr is not None and tr.active:
        if cmd.flags & CMD_CTRL or not cmd.families:
            if cmd.flags & CMD_CTRL:
                tr.flush_all()
        else:
            try:
                tr.invalidate_key(as_bytes(args[0]) if args else b"")
            except CstError:
                tr.flush_all()
    rc = node.read_cache
    if not len(rc):
        return
    if cmd.flags & CMD_CTRL or not cmd.families:
        if cmd.flags & CMD_CTRL:
            rc.clear()
        return
    if args:
        try:
            key = as_bytes(args[0])
            stride = _MEMBER_WRITE_STRIDE.get(cmd.name) if scoped else None
            if stride is not None:
                rc.invalidate_key_members(
                    key, [as_bytes(a) for a in args[1::stride]])
            else:
                rc.invalidate_key(key)
            return
        except CstError:
            pass
    rc.clear()


def apply_replicated(node: "Node", name: bytes, args: list, origin_nodeid: int,
                     uuid: int, cause: str = "read") -> Msg:
    """Replication-path dispatch with the originator's identity
    (reference Cmd::exec_detail with repl=false, pull.rs:184-235).
    `cause`: why the whole flush before it runs (Node.ensure_flushed).
    A key-scoped barrier flushes the rows of its key alone, none when
    the key is absent (Node.ensure_flushed_for_key): it reads nothing
    else."""
    cmd = COMMANDS.get(name)
    if cmd is None:
        cmd = COMMANDS.get(name.lower())
        if cmd is None:
            raise UnknownCmd(name.decode("utf-8", "replace"))
    if cmd.flags & CMD_CLIENT_ONLY:
        raise InvalidRequestMsg(f"'{name.decode()}' cannot come from a replica")
    node.stats.cmds_replicated += 1
    key = None
    if cmd.name in KEY_SCOPED_BARRIERS and args:
        try:
            key = as_bytes(args[0])
        except CstError:
            pass
    if key is not None:
        node.ensure_flushed_for_key(node.ks.lookup(key), cmd.families, cause)
    else:
        node.ensure_flushed(cause)
    node.hlc.observe(uuid)
    ctx = ExecCtx(uuid, origin_nodeid, True, None)
    if cmd.is_write:
        # replication intake invalidates BEFORE the op lands: a cached
        # hot-key reply must never outlive a peer's write to that key
        # (the per-frame twin of merge_batches' batched invalidation).
        # Member-scoping is safe pre-land: the op can only touch the
        # members it names, landed or not.
        _invalidate_read_cache(node, cmd, args, scoped=True)
    reply = cmd.handler(node, ctx, ArgIter(args, name))
    if cmd.is_write:
        kid = node.ks.lookup(as_bytes(args[0])) \
            if cmd.name in KEY_SCOPED_BARRIERS and args else -1
        if kid >= 0:
            # confined to that key's rows: a resident engine patches
            # them into its mirrors instead of rebuilding the planes
            node.ks.touch_key(kid, *cmd.families)
        else:
            node.ks.touch(*cmd.families)
    return reply


# ====================================================================
# generic commands (reference src/cmd.rs:141-346)
# ====================================================================

@serve_read("get", "get")
@register("get", CMD_READONLY)
def get_command(node, ctx, args):
    key = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0 or not ks.alive(kid):
        return NIL
    enc = ks.enc_of(kid)
    if enc == S.ENC_COUNTER:
        return Int(ks.counter_sum(kid))
    if enc == S.ENC_BYTES:
        v = ks.register_get(kid)
        return Bulk(v if v is not None else b"")
    raise _invalid_type()


def _invalid_type():
    from ..errors import InvalidType
    return InvalidType()


@register("set", CMD_WRITE | CMD_DENYOOM, families=("env", "reg"))
def set_command(node, ctx, args):
    key = args.next_bytes()
    val = args.next_bytes()
    kid, _created = node.ks.get_or_create(key, S.ENC_BYTES, ctx.uuid)
    if node.ks.register_set(kid, val, ctx.uuid, ctx.nodeid):
        return OK
    return Int(0)  # stale write ignored (reference cmd.rs:199-201)


@register("desc", CMD_READONLY)
def desc_command(node, ctx, args):
    key = args.next_bytes()
    kid = node.ks.query(key, ctx.uuid)
    if kid < 0:
        return NIL
    d = node.ks.describe(kid)
    return Arr([Bulk(f"{k}: {v}") for k, v in d.items()])


@register("del", CMD_WRITE | CMD_NO_REPLICATE | CMD_CLIENT_ONLY, families=("env", "cnt", "el"))
def del_command(node, ctx, args):
    """Rewrites itself into type-specific REPL_ONLY tombstone commands
    (reference src/cmd.rs:220-296)."""
    key = args.next_bytes()
    ks = node.ks
    uuid = ctx.uuid
    kid = ks.query(key, uuid)
    if kid < 0:
        return Int(0)
    enc = ks.enc_of(kid)
    ct, mt, dt = ks.envelope(kid)
    deleted = 0
    if enc in (S.ENC_COUNTER, S.ENC_BYTES, S.ENC_TENSOR):
        # no deletion while unseen later modifications exist (reference
        # policy for client-originated deletes, cmd.rs:232-235)
        if mt <= uuid and ct >= dt:
            ks.keys.dt[kid] = uuid
            ks.keys.mt[kid] = uuid
            ks.record_key_delete(key, uuid)
            deleted = 1
            if enc == S.ENC_COUNTER:
                # record the observed totals as per-slot bases (absolute
                # assignments — the reference's negated-delta scheme,
                # cmd.rs:233-254, diverges when the delete and concurrent
                # increments interleave differently across replicas)
                rep = [Bulk(key)]
                for slot_node, total, _t, _b, _bt in ks.counter_slots(kid):
                    ks.counter_set_base(kid, slot_node, total, uuid)
                    rep.append(Int(slot_node))
                    rep.append(Int(total))
                node.replicate_cmd(uuid, b"delcnt", rep)
            elif enc == S.ENC_TENSOR:
                node.replicate_cmd(uuid, b"deltensor", [Bulk(key)])
            else:
                node.replicate_cmd(uuid, b"delbytes", [Bulk(key)])
    elif enc in _DEL_COLLECTION_CMD:
        members = [m for m, *_ in ks.elem_all(kid)]
        for m in members:
            ks.elem_rem(kid, m, uuid)
        if ct >= dt and uuid > ct:
            deleted = 1
        ks.set_delete_time(kid, uuid)
        ks.record_key_delete(key, uuid)
        node.replicate_cmd(uuid, _DEL_COLLECTION_CMD[enc], [Bulk(key)])
    return Int(deleted)


# element-plane encodings delete alike: tombstone every member + the key
_DEL_COLLECTION_CMD = {S.ENC_SET: b"delset", S.ENC_DICT: b"deldict",
                       S.ENC_MV: b"delmv", S.ENC_LIST: b"dellist"}


@register("delbytes", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env",))
def delbytes_command(node, ctx, args):
    key = args.next_bytes()
    ks = node.ks
    kid = ks.lookup(key)
    if kid < 0:
        # unlike the reference (cmd.rs:298-317 creates a LIVE empty key),
        # an unknown key materializes already-tombstoned: ct=0 < dt=uuid
        kid = ks.create_key(key, S.ENC_BYTES, 0)
    elif ks.enc_of(kid) != S.ENC_BYTES:
        raise _invalid_type()
    ks.set_delete_time(kid, ctx.uuid)
    ks.record_key_delete(key, ctx.uuid)
    return NO_REPLY


@register("node", CMD_CTRL)
def node_command(node, ctx, args):
    sub = args.next_bytes().lower()
    if sub == b"id":
        if not args.has_more:
            return Int(node.node_id)
        v = args.next_int()
        if v <= 0:
            return Err(b"id must be greater than 0")
        node.node_id = v
        return OK
    if sub == b"alias":
        if not args.has_more:
            return Bulk(node.alias.encode())
        node.alias = args.next_str()
        return OK
    return Err(b"unsupported command")


@register("repllog", CMD_CTRL)
def repllog_command(node, ctx, args):
    sub = args.next_str().lower()
    if sub == "at":
        e = node.repl_log.at(args.next_uint())
        return node.repl_log.entry_as_msg(e) if e else NIL
    if sub == "uuids":
        return Arr([Int(u) for u in node.repl_log.uuids()])
    raise UnknownSubCmd(sub, "REPLLOG")


@register("hello", CMD_CTRL)
def hello_command(node, ctx, args):
    """HELLO [protover] — RESP protocol negotiation (Redis 6 shape,
    flattened to a RESP2 key/value array either way).  `HELLO 3` arms
    RESP3 on the connection: the server may then write out-of-band push
    frames (server/tracking.py invalidation broadcasts).  Connections
    that never say HELLO 3 stay byte-exact RESP2 — no push frame is
    ever emitted toward them.  Dropping back to HELLO 2 turns tracking
    off first (a RESP2 stream cannot carry the pushes)."""
    c = ctx.client
    if args.has_more:
        try:
            ver = args.next_int()
        except CstError:
            return Err(b"NOPROTO unsupported protocol version")
        if ver not in (2, 3):
            return Err(b"NOPROTO unsupported protocol version")
        if c is not None:
            if ver == 2 and c.tracking:
                node.tracking.unsubscribe(c)
            c.resp3 = ver == 3
    proto = 3 if c is not None and c.resp3 else 2
    return Arr([Bulk(b"server"), Bulk(b"constdb"),
                Bulk(b"version"), Bulk(b"1"),
                Bulk(b"proto"), Int(proto),
                Bulk(b"id"), Int(c.cid if c is not None else 0),
                Bulk(b"mode"),
                Bulk(b"cluster" if node.cluster is not None
                     else b"standalone")])


@register("client", CMD_CTRL)
def client_command(node, ctx, args):
    sub = args.next_str().lower()
    if sub == "threadid":
        return Bulk(str(threading.get_ident()).encode())
    if sub == "id":
        # unique per-connection id (Redis CLIENT ID); 0 for executions
        # with no connection (tests, replication, internal)
        return Int(ctx.client.cid if ctx.client is not None else 0)
    if sub == "list":
        app = getattr(node, "app", None)
        conns = list(app.client_conns.values()) \
            if app is not None and getattr(app, "client_conns", None) \
            else ([ctx.client] if ctx.client is not None else [])
        lines = "".join(c.describe() + "\n"
                        for c in sorted(conns, key=lambda c: c.cid))
        return Bulk(lines.encode())
    if sub == "tracking":
        # CLIENT TRACKING on|off [BCAST] [PREFIX p]... (server/tracking.py)
        mode = args.next_str().lower()
        bcast = False
        prefixes: list = []
        while args.has_more:
            opt = args.next_str().lower()
            if opt == "bcast":
                bcast = True
            elif opt == "prefix":
                prefixes.append(args.next_bytes())
            else:
                raise UnknownSubCmd(opt, "CLIENT TRACKING")
        c = ctx.client
        if mode == "off":
            if c is not None and c.tracking:
                node.tracking.unsubscribe(c)
            return OK
        if mode != "on":
            raise UnknownSubCmd(mode, "CLIENT TRACKING")
        if c is None:
            return Err(b"CLIENT TRACKING requires a client connection")
        if not c.resp3:
            return Err(b"CLIENT TRACKING requires the RESP3 protocol "
                       b"(say HELLO 3 first)")
        if prefixes and not bcast:
            return Err(b"PREFIX requires BCAST mode")
        node.tracking.subscribe(c, bcast=bcast, prefixes=tuple(prefixes))
        return OK
    raise UnknownSubCmd(sub, "CLIENT")


# ====================================================================
# counter commands (reference src/type_counter.rs:142-205)
# ====================================================================

def _counter_step(node, ctx, args, delta: int) -> Msg:
    """INCR/DECR: bump the local slot's lifetime total and replicate the
    new ABSOLUTE total (idempotent LWW assignment on the wire — see
    KeySpace.counter_change).  An optional amount argument scales the
    step (Redis INCRBY/DECRBY folded in; the reference steps by exactly 1
    — type_counter.rs:169-189)."""
    key = args.next_bytes()
    if args.has_more:
        delta *= args.next_int()
    kid, _ = node.ks.get_or_create(key, S.ENC_COUNTER, ctx.uuid)
    v, total = node.ks.counter_change(kid, ctx.nodeid, delta, ctx.uuid)
    node.ks.updated_at(kid, ctx.uuid)
    if not ctx.from_repl:
        # locally-originated steps are undoable (CNTUNDO); replicated
        # ones are not ours to invert (single-writer slots)
        node.undo.record(ctx.uuid, key, delta)
    node.replicate_cmd(ctx.uuid, b"cntset", [Bulk(key), Int(total)])
    return Int(v)


@register("incr", CMD_WRITE | CMD_NO_REPLICATE | CMD_DENYOOM, families=("env", "cnt"))
def incr_command(node, ctx, args):
    return _counter_step(node, ctx, args, 1)


@register("decr", CMD_WRITE | CMD_NO_REPLICATE | CMD_DENYOOM, families=("env", "cnt"))
def decr_command(node, ctx, args):
    return _counter_step(node, ctx, args, -1)


@register("cntset", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env", "cnt"))
def cntset_command(node, ctx, args):
    """Replicated counter write: assign the originator's lifetime total."""
    key = args.next_bytes()
    total = args.next_int()
    kid, _ = node.ks.get_or_create(key, S.ENC_COUNTER, ctx.uuid)
    node.ks.counter_set_total(kid, ctx.nodeid, total, ctx.uuid)
    node.ks.updated_at(kid, ctx.uuid)
    return NO_REPLY


@register("cntundo", CMD_WRITE | CMD_NO_REPLICATE | CMD_CLIENT_ONLY | CMD_DENYOOM, families=("env", "cnt"))
def cntundo_command(node, ctx, args):
    """`CNTUNDO key [uuid]` — sound inverse-op undo for the PN-counter
    family only (PAPERS.md, "The Only Undoable CRDTs are Counters"):
    undo THIS node's counter op `uuid` (or, without one, its newest
    not-yet-undone local op on `key`) by applying the negated delta as a
    fresh write.  The inverse replicates as an ordinary absolute-total
    CNTSET, so it rides every negotiated fast path — coalesced apply,
    serve planning, the columnar wire, snapshots, digests — like any
    increment.  The undo is itself recorded, so undoing an undo redoes.
    Non-counter keys are rejected cleanly: no other family's ops admit a
    sound inverse (an element re-add is a NEW add, not an un-remove)."""
    key = args.next_bytes()
    uuid = args.next_uint() if args.has_more else None
    ks = node.ks
    kid = ks.lookup(key)
    if kid >= 0 and ks.enc_of(kid) != S.ENC_COUNTER:
        raise CstError("UNDO is only sound for counters "
                       "(arXiv 2006.10494); this key is not one")
    target = node.undo.resolve(key, uuid)
    if target is None:
        if uuid is not None and node.undo.known(uuid):
            raise CstError("op already undone or key mismatch")
        raise CstError("unknown, remote, or evicted counter op: only "
                       "this node's recent local steps are undoable")
    t_uuid, delta = target
    kid, _ = ks.get_or_create(key, S.ENC_COUNTER, ctx.uuid)
    v, total = ks.counter_change(kid, ctx.nodeid, -delta, ctx.uuid)
    ks.updated_at(kid, ctx.uuid)
    node.undo.mark_undone(t_uuid)
    node.undo.record(ctx.uuid, key, -delta, inverse=True)
    node.replicate_cmd(ctx.uuid, b"cntset", [Bulk(key), Int(total)])
    return Int(v)


@register("delcnt", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env", "cnt"))
def delcnt_command(node, ctx, args):
    """Counter delete: tombstone the key and assign each listed slot's
    delete-observed base (visible value becomes total - base)."""
    key = args.next_bytes()
    ks = node.ks
    kid = ks.lookup(key)
    if kid < 0:
        # materialize already-tombstoned (ct=0 < dt) so bases still register
        kid = ks.create_key(key, S.ENC_COUNTER, 0)
    elif ks.enc_of(kid) != S.ENC_COUNTER:
        raise _invalid_type()
    ks.set_delete_time(kid, ctx.uuid)
    ks.record_key_delete(key, ctx.uuid)
    while args.has_more:
        slot_node = args.next_uint()
        base = args.next_int()
        ks.counter_set_base(kid, slot_node, base, ctx.uuid)
    return NO_REPLY


# ====================================================================
# set commands (reference src/type_set.rs)
# ====================================================================

@register("sadd", CMD_WRITE | CMD_DENYOOM, families=("env", "el"))
def sadd_command(node, ctx, args):
    key = args.next_bytes()
    members = args.rest_bytes()
    if not members:
        raise WrongArity("sadd")
    ks = node.ks
    kid, _ = ks.get_or_create(key, S.ENC_SET, ctx.uuid)
    cnt = sum(ks.elem_add(kid, m, None, ctx.uuid, ctx.nodeid) for m in members)
    dt = int(ks.keys.dt[kid])
    if ctx.uuid < dt:
        # a concurrent key-level delete from another replica wins
        # (reference type_set.rs:35-39)
        for m in members:
            ks.elem_rem(kid, m, dt)
        cnt = 0
    ks.updated_at(kid, ctx.uuid)
    return Int(cnt)


@register("srem", CMD_WRITE, families=("env", "el"))
def srem_command(node, ctx, args):
    key = args.next_bytes()
    members = args.rest_bytes()
    if not members:
        raise WrongArity("srem")
    ks = node.ks
    kid, _ = ks.get_or_create(key, S.ENC_SET, ctx.uuid)
    cnt = sum(ks.elem_rem(kid, m, ctx.uuid) for m in members)
    ks.updated_at(kid, ctx.uuid)
    return Int(cnt)


@serve_read("smembers", "members", enc=S.ENC_SET)
@register("smembers", CMD_READONLY)
def smembers_command(node, ctx, args):
    key = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0:
        return NIL
    if ks.enc_of(kid) != S.ENC_SET:
        raise _invalid_type()
    return Arr([Bulk(m) for m, _v, _t in ks.elem_live(kid)])


@serve_read("scnt", "card", enc=S.ENC_SET)
@register("scnt", CMD_READONLY)
def scnt_command(node, ctx, args):
    """SCNT key — live member count (the reference's set-cardinality
    probe; Redis SCARD).  Mirrors SMEMBERS' visibility exactly: the
    key-level tombstone is NOT consulted — a dead key's count is simply
    the count of its live members (normally 0, but add-wins members
    newer than the delete stay visible)."""
    key = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0:
        return Int(0)
    if ks.enc_of(kid) != S.ENC_SET:
        raise _invalid_type()
    return Int(sum(1 for _ in ks.elem_live(kid)))


@serve_read("sismember", "ismember", enc=S.ENC_SET, arity=3)
@register("sismember", CMD_READONLY)
def sismember_command(node, ctx, args):
    """SISMEMBER key member — 1 iff the member is visible (same
    element-liveness rule as SMEMBERS, one combo probe instead of a
    full scan)."""
    key = args.next_bytes()
    member = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0:
        return Int(0)
    if ks.enc_of(kid) != S.ENC_SET:
        raise _invalid_type()
    row = ks.el_row(kid, member)
    if row < 0:
        return Int(0)
    el = ks.el
    return Int(1 if S.elem_alive(int(el.add_t[row]), int(el.del_t[row]))
               else 0)


@register("spop", CMD_WRITE | CMD_NO_REPLICATE, families=("env", "el"))
def spop_command(node, ctx, args):
    key = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0:
        return NIL
    if ks.enc_of(kid) != S.ENC_SET:
        raise _invalid_type()
    live = [m for m, _v, _t in ks.elem_live(kid)]
    if not live:
        return NIL
    member = live[random.randrange(len(live))]
    ks.elem_rem(kid, member, ctx.uuid)
    ks.updated_at(kid, ctx.uuid)
    # deterministic rewrite so every replica pops the SAME member
    node.replicate_cmd(ctx.uuid, b"srem", [Bulk(key), Bulk(member)])
    return Bulk(member)


def _del_collection(node, ctx, args, enc: int) -> Msg:
    key = args.next_bytes()
    ks = node.ks
    kid = ks.lookup(key)
    if kid < 0:
        kid = ks.create_key(key, enc, 0)
    elif ks.enc_of(kid) != enc:
        raise _invalid_type()
    for m, *_ in list(ks.elem_all(kid)):
        ks.elem_rem(kid, m, ctx.uuid)
    ks.set_delete_time(kid, ctx.uuid)
    ks.record_key_delete(key, ctx.uuid)
    return NO_REPLY


@register("delset", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env", "el"))
def delset_command(node, ctx, args):
    return _del_collection(node, ctx, args, S.ENC_SET)


# ====================================================================
# hash commands (reference src/type_hash.rs)
# ====================================================================

@register("hset", CMD_WRITE | CMD_DENYOOM, families=("env", "el"))
def hset_command(node, ctx, args):
    key = args.next_bytes()
    kvs = []
    while args.has_more:
        f = args.next_bytes()
        kvs.append((f, args.next_bytes()))
    if not kvs:
        raise WrongArity("hset")
    ks = node.ks
    kid, _ = ks.get_or_create(key, S.ENC_DICT, ctx.uuid)
    cnt = sum(ks.elem_add(kid, f, v, ctx.uuid, ctx.nodeid) for f, v in kvs)
    dt = int(ks.keys.dt[kid])
    if ctx.uuid < dt:
        # concurrent key-level delete wins (reference type_hash.rs:38-43)
        for f, _v in kvs:
            ks.elem_rem(kid, f, dt)
        cnt = 0
    ks.updated_at(kid, ctx.uuid)
    return Int(cnt)


@serve_read("hget", "elemget", enc=S.ENC_DICT, arity=3)
@register("hget", CMD_READONLY)
def hget_command(node, ctx, args):
    key = args.next_bytes()
    field = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0:
        return NIL
    if ks.enc_of(kid) != S.ENC_DICT:
        raise _invalid_type()
    v = ks.elem_get(kid, field)
    return Bulk(v) if v is not None else NIL


@serve_read("hgetall", "pairs", enc=S.ENC_DICT)
@register("hgetall", CMD_READONLY)
def hgetall_command(node, ctx, args):
    key = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0:
        return NIL
    if ks.enc_of(kid) != S.ENC_DICT:
        raise _invalid_type()
    return Arr([Arr([Bulk(f), Bulk(v if v is not None else b"")])
                for f, v, _t in ks.elem_live(kid)])


@serve_read("hlen", "card", enc=S.ENC_DICT)
@register("hlen", CMD_READONLY)
def hlen_command(node, ctx, args):
    """HLEN key — live field count (the hash twin of SCNT/LLEN; Redis
    HLEN).  Mirrors HGETALL's visibility exactly: the key-level
    tombstone is NOT consulted — a dead key's count is the count of its
    live fields (normally 0, but add-wins fields newer than the delete
    stay visible)."""
    key = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0:
        return Int(0)
    if ks.enc_of(kid) != S.ENC_DICT:
        raise _invalid_type()
    return Int(sum(1 for _ in ks.elem_live(kid)))


@register("hdel", CMD_WRITE, families=("env", "el"))
def hdel_command(node, ctx, args):
    key = args.next_bytes()
    fields = args.rest_bytes()
    if not fields:
        raise WrongArity("hdel")
    ks = node.ks
    kid, _ = ks.get_or_create(key, S.ENC_DICT, ctx.uuid)
    cnt = sum(ks.elem_rem(kid, f, ctx.uuid) for f in fields)
    ks.updated_at(kid, ctx.uuid)
    return Int(cnt)


@register("deldict", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env", "el"))
def deldict_command(node, ctx, args):
    return _del_collection(node, ctx, args, S.ENC_DICT)


# ====================================================================
# multi-value register commands (capability completion: the reference
# advertises a MultiValueRegister — README.md:10 — but its VClock scaffold
# is wired to nothing, src/crdt/vclock.rs.  Siblings live as element rows
# whose member bytes are the write's canonical clock; dominated siblings
# are tombstoned by later writes and pruned at read time.)
# ====================================================================

def _mv_live(ks, kid):
    from ..crdt.multivalue import clock_from_bytes
    return [(m, v, clock_from_bytes(m)) for m, v, _t in ks.elem_live(kid)]


def _mv_apply(ks, kid, clock_bytes, wc, val, uuid, nodeid) -> None:
    """Insert the sibling and tombstone every live sibling the write's
    clock dominates — deterministic from the clocks alone, so replicas
    applying this replicated write converge."""
    live = _mv_live(ks, kid)
    ks.elem_add(kid, clock_bytes, val, uuid, nodeid)
    for m, _v, vc in live:
        if m != clock_bytes and wc.dominates(vc):
            ks.elem_rem(kid, m, uuid)
    dt = int(ks.keys.dt[kid])
    if uuid < dt:
        # concurrent key-level delete from another replica wins
        ks.elem_rem(kid, clock_bytes, dt)
    ks.updated_at(kid, uuid)


@register("mvset", CMD_WRITE | CMD_NO_REPLICATE | CMD_DENYOOM, families=("env", "el"))
def mvset_command(node, ctx, args):
    """MVSET key value [context-token].  The token (from MVGET) is the
    causal context the writer observed; writing with it supersedes exactly
    what was read.  Replicates as the positional `mvwrite`."""
    from ..crdt.multivalue import VClock, clock_from_bytes, clock_to_bytes

    key = args.next_bytes()
    val = args.next_bytes()
    token = args.next_bytes() if args.has_more else None
    ks = node.ks
    kid, _ = ks.get_or_create(key, S.ENC_MV, ctx.uuid)
    if token is not None:
        ctx_vc = clock_from_bytes(token)
    else:
        ctx_vc = VClock()
        for _m, _v, vc in _mv_live(ks, kid):
            ctx_vc = ctx_vc.merge(vc)
    wc = ctx_vc.bump(ctx.nodeid)
    wb = clock_to_bytes(wc)
    _mv_apply(ks, kid, wb, wc, val, ctx.uuid, ctx.nodeid)
    node.replicate_cmd(ctx.uuid, b"mvwrite", [Bulk(key), Bulk(wb), Bulk(val)])
    return Bulk(wb)


@register("mvwrite", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env", "el"))
def mvwrite_command(node, ctx, args):
    from ..crdt.multivalue import clock_from_bytes

    key = args.next_bytes()
    wb = args.next_bytes()
    val = args.next_bytes()
    ks = node.ks
    kid, _ = ks.get_or_create(key, S.ENC_MV, ctx.uuid)
    _mv_apply(ks, kid, wb, clock_from_bytes(wb), val, ctx.uuid, ctx.nodeid)
    return NO_REPLY


@register("mvget", CMD_READONLY)
def mvget_command(node, ctx, args):
    """-> [[sibling values...], context-token].  Concurrent writes all
    surface (Dynamo-style); pass the token to MVSET to supersede them."""
    from ..crdt.multivalue import VClock, clock_to_bytes, frontier_of

    key = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0 or not ks.alive(kid):
        return NIL
    if ks.enc_of(kid) != S.ENC_MV:
        raise _invalid_type()
    live = frontier_of(_mv_live(ks, kid))
    token = VClock()
    for _m, _v, vc in live:
        token = token.merge(vc)
    return Arr([Arr([Bulk(v if v is not None else b"") for _m, v, _vc in live]),
                Bulk(clock_to_bytes(token))])


@register("delmv", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env", "el"))
def delmv_command(node, ctx, args):
    return _del_collection(node, ctx, args, S.ENC_MV)


# ====================================================================
# list commands (capability completion: the reference scaffolds an ordered
# list — src/crdt/list.rs — wired to nothing.  Entries live as element rows
# whose member bytes are LSEQ position ids; byte-lex member order IS list
# order, so reads sort live members and merges are the element merge.)
# ====================================================================

def _list_live(ks, kid) -> list:
    """[(pos_bytes, value)] in list order."""
    return sorted((m, v) for m, v, _t in ks.elem_live(kid))


def _list_kid(node, ctx, key, for_write: bool):
    ks = node.ks
    if for_write:
        kid, _ = ks.get_or_create(key, S.ENC_LIST, ctx.uuid)
        return kid
    kid = ks.query(key, ctx.uuid)
    if kid < 0 or not ks.alive(kid):
        return -1
    if ks.enc_of(kid) != S.ENC_LIST:
        raise _invalid_type()
    return kid


def _list_insert(node, ctx, key, index: int, values: list) -> int:
    """Insert `values` before live index `index` (clamped); returns the new
    live length.  Each insert replicates as the positional `lins`."""
    from ..crdt.sequence import pos_between_bytes

    ks = node.ks
    kid = _list_kid(node, ctx, key, for_write=True)
    live = _list_live(ks, kid)
    index = max(0, min(index, len(live)))
    lo = live[index - 1][0] if index > 0 else None
    hi = live[index][0] if index < len(live) else None
    rep = [Bulk(key)]
    dt = int(ks.keys.dt[kid])
    for v in values:
        pos = pos_between_bytes(lo, hi, ctx.nodeid)
        ks.elem_add(kid, pos, v, ctx.uuid, ctx.nodeid)
        if ctx.uuid < dt:
            ks.elem_rem(kid, pos, dt)
        rep.append(Bulk(pos))
        rep.append(Bulk(v))
        lo = pos  # subsequent values land after the one just placed
    ks.updated_at(kid, ctx.uuid)
    # ONE replicated frame for the whole insert (repl_log uuids are unique)
    node.replicate_cmd(ctx.uuid, b"lins", rep)
    return len(_list_live(ks, kid))


@register("linsert", CMD_WRITE | CMD_NO_REPLICATE | CMD_DENYOOM, families=("env", "el"))
def linsert_command(node, ctx, args):
    key = args.next_bytes()
    index = args.next_int()
    values = args.rest_bytes()
    if not values:
        raise WrongArity("linsert")
    return Int(_list_insert(node, ctx, key, index, values))


@register("lpush", CMD_WRITE | CMD_NO_REPLICATE | CMD_DENYOOM, families=("env", "el"))
def lpush_command(node, ctx, args):
    key = args.next_bytes()
    values = args.rest_bytes()
    if not values:
        raise WrongArity("lpush")
    # redis convention: LPUSH k a b c pushes one at a time to the HEAD, so
    # the list reads c, b, a.  _list_insert places values consecutively, so
    # feed it the reversed order.
    return Int(_list_insert(node, ctx, key, 0, list(reversed(values))))


@register("rpush", CMD_WRITE | CMD_NO_REPLICATE | CMD_DENYOOM, families=("env", "el"))
def rpush_command(node, ctx, args):
    key = args.next_bytes()
    values = args.rest_bytes()
    if not values:
        raise WrongArity("rpush")
    return Int(_list_insert(node, ctx, key, 1 << 40, values))


@register("lins", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env", "el"))
def lins_command(node, ctx, args):
    """Positional replicated insert: `lins key pos1 val1 [pos2 val2 ...]`."""
    key = args.next_bytes()
    ks = node.ks
    kid, _ = ks.get_or_create(key, S.ENC_LIST, ctx.uuid)
    dt = int(ks.keys.dt[kid])
    while args.has_more:
        pos = args.next_bytes()
        val = args.next_bytes()
        ks.elem_add(kid, pos, val, ctx.uuid, ctx.nodeid)
        if ctx.uuid < dt:
            ks.elem_rem(kid, pos, dt)
    ks.updated_at(kid, ctx.uuid)
    return NO_REPLY


@register("lrem", CMD_WRITE | CMD_NO_REPLICATE, families=("env", "el"))
def lrem_command(node, ctx, args):
    """LREM key index — delete the element at live index; replicates as the
    positional `lremat` so every replica removes the SAME element."""
    key = args.next_bytes()
    index = args.next_int()
    ks = node.ks
    kid = _list_kid(node, ctx, key, for_write=False)
    if kid < 0:
        return Int(0)
    live = _list_live(ks, kid)
    if not 0 <= index < len(live):
        return Int(0)
    pos = live[index][0]
    ks.elem_rem(kid, pos, ctx.uuid)
    ks.updated_at(kid, ctx.uuid)
    node.replicate_cmd(ctx.uuid, b"lremat", [Bulk(key), Bulk(pos)])
    return Int(1)


@register("lremat", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env", "el"))
def lremat_command(node, ctx, args):
    key = args.next_bytes()
    pos = args.next_bytes()
    ks = node.ks
    kid, _ = ks.get_or_create(key, S.ENC_LIST, ctx.uuid)
    ks.elem_rem(kid, pos, ctx.uuid)
    ks.updated_at(kid, ctx.uuid)
    return NO_REPLY


@serve_read("lrange", "lrange", enc=S.ENC_LIST, arity=4)
@register("lrange", CMD_READONLY)
def lrange_command(node, ctx, args):
    """LRANGE key start stop — redis-style inclusive range with negative
    indices."""
    key = args.next_bytes()
    start = args.next_int()
    stop = args.next_int()
    kid = _list_kid(node, ctx, key, for_write=False)
    if kid < 0:
        return Arr([])
    vals = [v for _m, v in _list_live(node.ks, kid)]
    n = len(vals)
    if start < 0:
        start += n
    if stop < 0:
        stop += n
    start = max(0, start)
    if stop < start:
        return Arr([])
    return Arr([Bulk(v if v is not None else b"")
                for v in vals[start:stop + 1]])


@serve_read("llen", "llen", enc=S.ENC_LIST)
@register("llen", CMD_READONLY)
def llen_command(node, ctx, args):
    key = args.next_bytes()
    kid = _list_kid(node, ctx, key, for_write=False)
    if kid < 0:
        return Int(0)
    return Int(len(_list_live(node.ks, kid)))


@register("dellist", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env", "el"))
def dellist_command(node, ctx, args):
    return _del_collection(node, ctx, args, S.ENC_LIST)


# ====================================================================
# tensor-valued registers (crdt/tensor.py — the two-layer CRDT of
# arXiv 2605.19373): dense float arrays whose merge is a per-node
# contributor-slot LWW and whose read is a registered strategy
# reduction in canonical (node, uuid) order.  Shape/dtype/strategy are
# FIXED at key creation; contributions replicate as the absolute
# rewrite `tset` (idempotent LWW assignment on the wire, like cntset).
# ====================================================================


def _tensor_error(e) -> CstError:
    return InvalidRequestMsg(str(e))


def _tensor_knobs() -> tuple[str, int]:
    from ..conf import env_int, env_str
    return (env_str("CONSTDB_TORCH_TENSOR_STRATEGY", "lww"),
            env_int("CONSTDB_TORCH_TENSOR_MAX_ELEMS", 1 << 22))


@register("tensor.set", CMD_WRITE | CMD_NO_REPLICATE | CMD_DENYOOM, families=("env", "tns"))
def tensor_set_command(node, ctx, args):
    """TENSOR.SET key strategy dtype shape payload [count] — create the
    key (fixing strategy/dtype/shape) and assign this node's
    contributor slot.  `strategy` may be `-` for the configured default
    (CONSTDB_TORCH_TENSOR_STRATEGY); `shape` is `4096` or `64x64`; `payload`
    is the raw little-endian array bytes; `count` weights the `avg`
    strategy (default 1)."""
    from ..crdt import tensor as T

    key = args.next_bytes()
    strat_s = args.next_str()
    dtype_s = args.next_str()
    shape_s = args.next_str()
    payload = args.next_bytes()
    cnt = args.next_int() if args.has_more else 1
    default_strat, max_elems = _tensor_knobs()
    if node.ks.lookup(key) >= 0:
        # the size cap guards key CREATION only — config is
        # creation-fixed, so writes to an existing key must keep
        # working after the knob is lowered (README Tuning row)
        max_elems = 1 << 62
    try:
        T.check_count(cnt)
        meta = T.parse_meta(strat_s, dtype_s, shape_s,
                            default_strat=default_strat,
                            max_elems=max_elems)
        cfg = T.pack_config(meta)
        arr = T.payload_array(meta, payload)
        kid = node.ks.tensor_get_or_create(key, cfg, ctx.uuid)
    except T.TensorConfigError as e:
        raise _tensor_error(e) from None
    node.ks.tensor_count_merge(meta)
    node.ks.tensor_slot_set(kid, ctx.nodeid, ctx.uuid, cnt, arr)
    node.ks.updated_at(kid, ctx.uuid)
    node.replicate_cmd(ctx.uuid, b"tset",
                       [Bulk(key), Bulk(cfg), Int(cnt), Bulk(payload)])
    return OK


@register("tensor.merge", CMD_WRITE | CMD_NO_REPLICATE | CMD_DENYOOM, families=("env", "tns"))
def tensor_merge_command(node, ctx, args):
    """TENSOR.MERGE key payload [count] — contribute a payload to an
    EXISTING tensor key (the config came from its creation)."""
    from ..crdt import tensor as T

    key = args.next_bytes()
    payload = args.next_bytes()
    cnt = args.next_int() if args.has_more else 1
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0:
        raise InvalidRequestMsg("no such tensor key (TENSOR.SET creates)")
    if ks.enc_of(kid) != S.ENC_TENSOR:
        raise _invalid_type()
    meta = ks.tensor_meta_of(kid)
    if meta is None:
        # a tensor key can exist config-less (a replicated `deltensor`
        # for a never-seen key materializes the tombstoned row only):
        # without a creation-fixed config there is nothing to validate
        # the payload against — same error as an absent key
        raise InvalidRequestMsg("no such tensor key (TENSOR.SET creates)")
    try:
        T.check_count(cnt)
        arr = T.payload_array(meta, payload)
    except T.TensorConfigError as e:
        raise _tensor_error(e) from None
    ks.tensor_count_merge(meta)
    ks.tensor_slot_set(kid, ctx.nodeid, ctx.uuid, cnt, arr)
    ks.updated_at(kid, ctx.uuid)
    node.replicate_cmd(ctx.uuid, b"tset",
                       [Bulk(key), Bulk(T.pack_config(meta)), Int(cnt),
                        Bulk(payload)])
    return OK


@register("tensor.get", CMD_READONLY)
def tensor_get_command(node, ctx, args):
    """TENSOR.GET key — the strategy reduction over the live contributor
    set, as raw little-endian bytes (reshape client-side via STAT)."""
    key = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0 or not ks.alive(kid):
        return NIL
    if ks.enc_of(kid) != S.ENC_TENSOR:
        raise _invalid_type()
    out = node.tensor_read(kid)  # device-first (resident pools)
    if out is None:
        return NIL
    return Bulk(out.tobytes())


@register("tensor.stat", CMD_READONLY)
def tensor_stat_command(node, ctx, args):
    """TENSOR.STAT key — config + contributor stamps: [strategy, dtype,
    shape, n_contributors, total_count, [node uuid count]...]."""
    from ..crdt import tensor as T

    key = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0 or not ks.alive(kid):
        return NIL
    if ks.enc_of(kid) != S.ENC_TENSOR:
        raise _invalid_type()
    meta = ks.tensor_meta_of(kid)
    if meta is None:
        return NIL
    contribs = ks.tensor_contribs(kid)
    return Arr([
        Bulk(meta.strat_name.encode()),
        Bulk(T.DTYPE_NAMES[meta.dtype_code].encode()),
        Bulk("x".join(str(d) for d in meta.shape).encode()),
        Int(len(contribs)),
        Int(sum(c for _n, _u, c, _p in contribs)),
        Arr([Arr([Int(n_), Int(u), Int(c)])
             for n_, u, c, _p in contribs]),
    ])


@register("tset", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env", "tns"))
def tset_command(node, ctx, args):
    """Replicated tensor contribution: absolute (cfg, count, payload)
    assignment of the originator's slot at the frame uuid."""
    key = args.next_bytes()
    cfg = args.next_bytes()
    cnt = args.next_int()
    payload = args.next_bytes()
    kid, _created = node.ks.get_or_create(key, S.ENC_TENSOR, ctx.uuid)
    # snapshot-merge semantics on config/payload problems: log + skip
    # (tensor_merge_row), exactly like the engine paths
    node.ks.tensor_merge_row(kid, ctx.nodeid, ctx.uuid, cnt, cfg, payload)
    node.ks.updated_at(kid, ctx.uuid)
    return NO_REPLY


@register("deltensor", CMD_WRITE | CMD_REPL_ONLY | CMD_NO_REPLICATE | CMD_NO_REPLY, families=("env",))
def deltensor_command(node, ctx, args):
    """Tensor key delete: an envelope-level tombstone (add-wins — a
    later contribution resurrects the key with its full contributor
    set, like registers; slots are never swept)."""
    key = args.next_bytes()
    ks = node.ks
    kid = ks.lookup(key)
    if kid < 0:
        kid = ks.create_key(key, S.ENC_TENSOR, 0)
    elif ks.enc_of(kid) != S.ENC_TENSOR:
        raise _invalid_type()
    ks.set_delete_time(kid, ctx.uuid)
    ks.record_key_delete(key, ctx.uuid)
    return NO_REPLY


# ====================================================================
# expiry (capability completion: the reference ships the machinery with no
# command — SURVEY.md §"Known reference defects"; db.rs:53-71)
# ====================================================================

@register("expire", CMD_WRITE | CMD_NO_REPLICATE, families=("env",))
def expire_command(node, ctx, args):
    key = args.next_bytes()
    secs = args.next_uint()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0 or not ks.alive(kid):
        return Int(0)
    exp_uuid = (now_ms() + secs * 1000) << SEQ_BITS
    ks.expire_at(key, exp_uuid)
    # replicate the ABSOLUTE expiry so replicas agree on the deadline
    node.replicate_cmd(ctx.uuid, b"expireat", [Bulk(key), Int(exp_uuid)])
    return Int(1)


@register("expireat", CMD_WRITE, families=("env",))
def expireat_command(node, ctx, args):
    key = args.next_bytes()
    exp_uuid = args.next_uint()
    ks = node.ks
    kid = ks.lookup(key)
    if kid < 0:
        return Int(0)
    ks.expire_at(key, exp_uuid)
    return Int(1)


@register("ttl", CMD_READONLY)
def ttl_command(node, ctx, args):
    key = args.next_bytes()
    ks = node.ks
    kid = ks.query(key, ctx.uuid)
    if kid < 0 or not ks.alive(kid):
        return Int(-2)
    exp = int(ks.keys.expire[kid])
    if exp == 0:
        return Int(-1)
    return Int(max(0, (exp >> SEQ_BITS) - now_ms()) // 1000)


# ====================================================================
# columnar encoders — the steady-state coalescing seam
# (replica/coalesce.py).  Each encoder translates ONE replicated frame
# into rows of the same columnar plane layout the snapshot writer
# serializes (persist/snapshot.py _encode_batch over engine/base.py
# ColumnarBatch), so a run of peer frames can fold through the batched
# merge engine instead of the per-key op path.  Only commands whose op
# handler is a pure pointwise CRDT merge are encodable — everything
# else (deletes, expiry, membership, MV sibling pruning) stays on the
# exact per-key path as a coalescer BARRIER.  An encoder raising
# NotColumnar or any CstError makes the coalescer fall back to that
# same per-key path, so error behavior is byte-identical too.
#
# This table is ALSO the batch wire protocol's vocabulary: the push
# loop group-encodes runs of consecutive entries whose names appear
# here into REPLBATCH frames (replica/wire.py), and the wire codec
# re-derives every envelope column from the row patterns these
# encoders emit.  A new encoder whose rows fall outside those patterns
# still replicates correctly — the codec demotes its runs to per-frame
# frames, loudly — but extend replica/wire.py alongside it to keep the
# batched path's coverage.
# ====================================================================

class NotColumnar(Exception):
    """This frame cannot ride the columnar fast path; apply per-key."""


COLUMNAR_ENCODERS: dict[bytes, Callable] = {}

# Barrier scoping for the coalescer's NON-encodable frames.  A frame in
# KEY_SCOPED_BARRIERS reads/sweeps live state of exactly the key in its
# first argument (collection-delete member sweeps, expireat's
# exists-check, mvwrite's sibling pruning) — it must flush the pending
# batch ONLY when that key has pending rows; otherwise it commutes with
# the whole batch and applies per-key without landing it.  STATE_FREE
# frames never touch the keyspace at all (membership).  Everything else
# non-encodable flushes unconditionally (unknown semantics).
KEY_SCOPED_BARRIERS = frozenset(
    (b"delset", b"deldict", b"delmv", b"dellist", b"expireat", b"mvwrite"))
STATE_FREE_BARRIERS = frozenset((b"meet", b"forget"))

# Tensor reads skip execute()'s blanket flush via READ_FLUSH_FAMILIES
# (defined with the read-plane tables near the top of this module):
# everything they read is env (narrow-flushed) or host-authoritative
# tensor stamps, and TENSOR.GET reduces from the resident device pools
# (Node.tensor_read) — the family's whole point is that reads do not
# force payload round-trips.  The scalar read families narrow the same
# way now (round 18).


def columnar(name: str):
    """Register `fn(builder, recs)` as the columnar GROUP encoder for the
    command registered under `name`.  `recs` is the coalescer's buffered
    run of frames for that command — tuples `(key, origin, uuid, items)`
    with `items` the RAW wire frame — and the encoder turns the whole
    run into columnar rows with C-speed list comprehensions (the
    per-frame python this replaces was the measured ceiling of the
    steady-state pull path).

    Contract: encoders PARSE BEFORE MUTATING the builder — every raise
    must happen before the first builder mutation, so a failing run
    leaves the batch untouched and the coalescer can retry rec-by-rec,
    barrier-replaying only the genuinely malformed frames (which then
    raise the exact op-path error).  Even a contract slip is safe:
    every encodable write is an idempotent merge, so a replay over
    half-encoded rows converges."""
    def deco(fn):
        assert name.encode() in COMMANDS, name
        COLUMNAR_ENCODERS[name.encode()] = fn
        return fn
    return deco


@columnar("set")
def _enc_set(bb, recs: list) -> None:
    # op twin: get_or_create + register_set (LWW) + updated_at-on-win;
    # the unconditional envelope max is identical because ct >= rv_t
    # holds invariantly, so a losing write's max(ct, uuid) is a no-op
    vals = [v if type(v := r[3][6]) is bytes else as_bytes(v)
            for r in recs]
    uuids = [r[2] for r in recs]
    ki0 = bb.add_keys([r[0] for r in recs], S.ENC_BYTES, uuids)
    bb.reg_run(ki0, uuids, [r[1] for r in recs], vals)


@columnar("cntset")
def _enc_cntset(bb, recs: list) -> None:
    rows = [(r[1], as_int(r[3][6]), r[2]) for r in recs]  # (node, tot, u)
    ki0 = bb.add_keys([r[0] for r in recs], S.ENC_COUNTER,
                      [r[2] for r in recs])
    bb.cnt_rows.extend(
        (ki0 + i, node, total, u, 0, S.NEUTRAL_T)
        for i, (node, total, u) in enumerate(rows))
    bb.n_rows += len(rows)


# sadd (valueless members) / hset / lins (member+value pairs): element
# add-side LWW writes.  `dt_check=True` marks the rows for the
# coalescer's flush-time key-delete rule (op twin: `if uuid <
# keys.dt[kid]: elem_rem(member, dt)` — evaluated against the LIVE dt
# when the batch lands, which is when the per-key path would have
# evaluated it had the frames applied there).

def _members_of(items: list) -> list:
    if len(items) < 7:
        raise NotColumnar("bad arity")  # the handler raises WrongArity
    if type(items[6]) is bytes:
        # raw-scanned replay record (persist/oplog.py scan raw mode):
        # arguments are plain bytes, all-or-nothing — skip the
        # coercion map on the replay hot path
        return list(items[6:])
    return list(map(as_bytes, items[6:]))


def _genc_elem_adds(bb, recs, enc, with_vals: bool) -> None:
    if with_vals:
        pairs = []
        for r in recs:
            it = r[3]
            if len(it) < 8 or len(it) & 1:
                raise NotColumnar("bad arity")
            if type(it[6]) is bytes:   # raw-scanned: all-bytes args
                pairs.append((list(it[6::2]), list(it[7::2])))
            else:
                pairs.append((list(map(as_bytes, it[6::2])),
                              list(map(as_bytes, it[7::2]))))
    else:
        pairs = [(_members_of(r[3]), None) for r in recs]
    ki0 = bb.add_keys([r[0] for r in recs], enc, [r[2] for r in recs])
    el = bb.el_rows
    n = 0
    for i, r in enumerate(recs):
        m, v = pairs[i]
        el.append((ki0 + i, m, v, r[2], r[1], 0, True))
        n += len(m)
    bb.n_rows += n
    if with_vals:
        bb._el_has_vals = True


@columnar("sadd")
def _enc_sadd(bb, recs):
    _genc_elem_adds(bb, recs, S.ENC_SET, with_vals=False)


@columnar("hset")
def _enc_hset(bb, recs):
    _genc_elem_adds(bb, recs, S.ENC_DICT, with_vals=True)


@columnar("lins")
def _enc_lins(bb, recs):
    _genc_elem_adds(bb, recs, S.ENC_LIST, with_vals=True)


# srem/hdel/lremat: del-side max.  A missing member row materializes
# with add_t=0/add_node=0 on both paths (KeySpace.elem_rem vs the
# engine's neutral-row creation), so encoding (0, 0, uuid) is exact.

def _genc_elem_rems(bb, recs, enc) -> None:
    members = [_members_of(r[3]) for r in recs]
    ki0 = bb.add_keys([r[0] for r in recs], enc, [r[2] for r in recs])
    el = bb.el_rows
    n = 0
    for i, r in enumerate(recs):
        m = members[i]
        el.append((ki0 + i, m, None, 0, 0, r[2], False))
        n += len(m)
    bb.n_rows += n


@columnar("srem")
def _enc_srem(bb, recs):
    _genc_elem_rems(bb, recs, S.ENC_SET)


@columnar("hdel")
def _enc_hdel(bb, recs):
    _genc_elem_rems(bb, recs, S.ENC_DICT)


@columnar("lremat")
def _enc_lremat(bb, recs):
    poss = [(as_bytes(r[3][6]),) for r in recs]
    ki0 = bb.add_keys([r[0] for r in recs], S.ENC_LIST,
                      [r[2] for r in recs])
    bb.el_rows.extend(
        (ki0 + i, poss[i], None, 0, 0, r[2], False)
        for i, r in enumerate(recs))
    bb.n_rows += len(recs)


# Scalar DELETE rewrites coalesce too: delbytes/delcnt are pure
# tombstone + LWW-pair writes, so they commute with everything a pending
# batch can hold (unlike the collection deletes delset/deldict/delmv/
# dellist, whose member sweep READS live rows — those stay barriers).

@columnar("delbytes")
def _enc_delbytes(bb, recs) -> None:
    bb.add_del_keys([r[0] for r in recs], S.ENC_BYTES,
                    [r[2] for r in recs])


@columnar("tset")
def _enc_tset(bb, recs) -> None:
    """Tensor contributions: pure slot LWW assignments — they commute
    with everything a pending batch can hold.  Payloads stay raw bytes
    in the batch (the engine normalizes via the row's cfg at merge)."""
    rows = [(as_bytes(r[3][6]), as_int(r[3][7]), as_bytes(r[3][8]))
            for r in recs]  # (cfg, cnt, payload) — parse before mutate
    ki0 = bb.add_keys([r[0] for r in recs], S.ENC_TENSOR,
                      [r[2] for r in recs])
    bb.tns_rows.extend(
        (ki0 + i, r[1], r[2], cnt, cfg, payload)
        for i, (r, (cfg, cnt, payload)) in enumerate(zip(recs, rows)))
    bb.n_rows += len(rows)


@columnar("deltensor")
def _enc_deltensor(bb, recs) -> None:
    bb.add_del_keys([r[0] for r in recs], S.ENC_TENSOR,
                    [r[2] for r in recs])


@columnar("delcnt")
def _enc_delcnt(bb, recs) -> None:
    """Counter delete: key tombstone + each listed slot's delete-observed
    base as an LWW assignment (base @ delete-uuid); the slot's total
    pair rides along neutral (val=0 @ NEUTRAL_T never beats a written
    slot, and ties with an unwritten one at its own value)."""
    slot_runs = []
    for r in recs:
        it = r[3]
        if len(it) & 1:
            raise NotColumnar("bad arity")  # key + (node, base) pairs
        pairs = []
        for i in range(6, len(it), 2):
            node = as_int(it[i])
            if node < 0:
                raise NotColumnar("bad node id")  # handler uses next_uint
            pairs.append((node, as_int(it[i + 1])))
        slot_runs.append(pairs)
    ki0 = bb.add_del_keys([r[0] for r in recs], S.ENC_COUNTER,
                          [r[2] for r in recs])
    for i, r in enumerate(recs):
        for node, base in slot_runs[i]:
            bb.cnt_rows.append((ki0 + i, node, 0, S.NEUTRAL_T, base, r[2]))
            bb.n_rows += 1


# ====================================================================
# serve planners — the client-path coalescing seam (server/serve.py).
# Pipelined client chunks are planned instead of executed per message:
# each planner below translates ONE client command into (a) its
# replication rewrite — buffered for the columnar GROUP encoders above
# and for repl_log.push_many — and (b) its reply, computed from the
# landed store plus the pending run's tracked deltas (which is exactly
# the state the per-command path would have seen, because the run lands
# before anything else can read it: reads and non-plannable commands
# are ordered barriers that flush first, and the whole chunk runs
# synchronously on the single-writer loop).  Only commands whose
# handler is a pure pointwise CRDT write with a reply derivable from
# (pre-state, args) are plannable; everything else — reads, DEL and the
# other read-modify rewrites, expiry, membership, admin — executes on
# the exact per-command path as a barrier.
# ====================================================================

SERVE_PLANNERS: dict[bytes, Callable] = {}

# --------------------------------------------------------------------
# shard routing classification (server/serve_shards.py).  Every DATA
# command's keyspace effects are confined to the key in its FIRST
# argument — the convention PR 5's barrier scoping already relies on
# and the KEY-CONFINED lint rule (constdb_tpu/analysis/rules.py) pins
# statically for the planner/encoder families.  Commands that touch
# GLOBAL state instead (membership, admin/CTRL, observability) execute
# on the parent's ordered barrier plane.  `PLANE_COMMANDS` lists the
# keyless non-CTRL commands structurally indistinguishable from data
# commands (their `families` default to ALL); `shard_routable` is the
# one classifier both the client router and the replication-apply
# router consult.
# --------------------------------------------------------------------

PLANE_COMMANDS = frozenset((b"info", b"replicas", b"meet", b"forget"))


def shard_routable(cmd: Command) -> bool:
    """True iff this command executes inside the shard worker owning
    its first-argument key; False = ordered barrier plane (parent)."""
    return not (cmd.flags & CMD_CTRL) and bool(cmd.families) \
        and cmd.name not in PLANE_COMMANDS

# Flush-time group encoders for the serve path: `fn(bb, recs, nodeid)`
# over the compact per-command records the planners buffered.  Unlike
# the replication COLUMNAR_ENCODERS (which parse raw wire frames at
# flush), these receive arguments the planner ALREADY coerced during
# validation — flush is pure C-speed list comprehension, no re-parse,
# and nothing here can raise on a planner-built record.  Row layouts
# are identical to the replication encoders', with one deliberate
# difference: element adds carry dt_check=False — a client write's
# fresh HLC uuid is strictly newer than any landed key-delete time (the
# clock has observed every landed write), and barriers flush before
# anything can raise a pending key's dt, so the flush-time key-delete
# rule is provably inert and its batched dt lookup is skipped.
SERVE_ENCODERS: dict[bytes, Callable] = {}


def _senc_set(bb, recs, nodeid):
    uuids = [r[1] for r in recs]
    ki0 = bb.add_keys([r[0] for r in recs], S.ENC_BYTES, uuids)
    bb.reg_run(ki0, uuids, [nodeid] * len(recs), [r[2] for r in recs])


def _senc_cntset(bb, recs, nodeid):
    ki0 = bb.add_keys([r[0] for r in recs], S.ENC_COUNTER,
                      [r[1] for r in recs])
    bb.cnt_rows.extend((ki0 + i, nodeid, r[2], r[1], 0, S.NEUTRAL_T)
                       for i, r in enumerate(recs))
    bb.n_rows += len(recs)


def _senc_elem_adds(enc: int, with_vals: bool):
    def enc_fn(bb, recs, nodeid):
        ki0 = bb.add_keys([r[0] for r in recs], enc, [r[1] for r in recs])
        el = bb.el_rows
        n = 0
        for i, r in enumerate(recs):
            el.append((ki0 + i, r[2], r[3] if with_vals else None,
                       r[1], nodeid, 0, False))
            n += len(r[2])
        bb.n_rows += n
        if with_vals:
            bb._el_has_vals = True
    return enc_fn


def _senc_elem_rems(enc: int):
    def enc_fn(bb, recs, nodeid):
        ki0 = bb.add_keys([r[0] for r in recs], enc, [r[1] for r in recs])
        el = bb.el_rows
        n = 0
        for i, r in enumerate(recs):
            el.append((ki0 + i, r[2], None, 0, 0, r[1], False))
            n += len(r[2])
        bb.n_rows += n
    return enc_fn


def _senc_tset(bb, recs, nodeid):
    ki0 = bb.add_keys([r[0] for r in recs], S.ENC_TENSOR,
                      [r[1] for r in recs])
    bb.tns_rows.extend((ki0 + i, nodeid, r[1], r[3], r[2], r[4])
                       for i, r in enumerate(recs))
    bb.n_rows += len(recs)


SERVE_ENCODERS[b"set"] = _senc_set
SERVE_ENCODERS[b"cntset"] = _senc_cntset
SERVE_ENCODERS[b"tset"] = _senc_tset
SERVE_ENCODERS[b"sadd"] = _senc_elem_adds(S.ENC_SET, with_vals=False)
SERVE_ENCODERS[b"hset"] = _senc_elem_adds(S.ENC_DICT, with_vals=True)
SERVE_ENCODERS[b"srem"] = _senc_elem_rems(S.ENC_SET)
SERVE_ENCODERS[b"hdel"] = _senc_elem_rems(S.ENC_DICT)

# Reads that observe exactly the key in their first argument (and touch
# no global state — not the repl_log, not membership, not stats).  With
# a run pending, such a read is a NON-FLUSHING barrier when its key has
# no pending rows: it commutes with every buffered write, so it may
# execute per-command in place while the run keeps filling — the serve
# twin of the replication coalescer's KEY_SCOPED_BARRIERS.  Anything
# else non-plannable flushes first (writes also push the repl_log,
# whose uuids must stay ordered with the pending run's).
SERVE_KEY_SCOPED_READS = frozenset(
    (b"get", b"smembers", b"scnt", b"sismember", b"hget", b"hgetall",
     b"lrange", b"llen", b"ttl", b"desc", b"mvget", b"tensor.get",
     b"tensor.stat"))

_INT0 = Int(0)


def serve_plan(name: str):
    """Register `fn(coal, items) -> Msg | None` as the serve-path planner
    for the client command `name` (`items` = the raw client frame,
    `[name, args...]`; `coal` = the connection's ServeCoalescer).  A
    planner either buffers the command's replication rewrite into the
    pending run and returns the reply, or returns None to DEMOTE the
    command to the exact per-command path (arity/coercion errors, type
    conflicts — node.execute raises the exact op error there).

    Contract (the planner twin of the encoders' parse-then-mutate rule):
    every demotion happens BEFORE the first mutation of coalescer state
    or the node HLC — a demoted command re-executes on the per-command
    path, which must mint the next uuid itself and see the store exactly
    as if the planner had never looked."""
    def deco(fn):
        cmd = COMMANDS[name.encode()]
        assert cmd.is_write and not (cmd.flags & CMD_REPL_ONLY), name
        SERVE_PLANNERS[cmd.name] = fn
        return fn
    return deco


@serve_plan("set")
def _plan_set(coal, items):
    # op twin: get_or_create + register_set (LWW) + replicate verbatim.
    # The win test runs against the pending run's register state when the
    # key was already written this run, else the landed (rv_t, rv_node) —
    # a fresh client uuid beats both in practice (the HLC has observed
    # every landed write), but the comparison stays exact regardless.
    if len(items) < 3:
        return None
    try:
        key = as_bytes(items[1])
        val = as_bytes(items[2])
    except CstError:
        return None
    kid = coal.resolve_key(key, S.ENC_BYTES)
    if kid is coal.CONFLICT:
        return None
    uuid = coal.tick()
    st = coal.regs.get(key)
    if st is None:
        st = (int(coal.ks.keys.rv_t[kid]), int(coal.ks.keys.rv_node[kid])) \
            if kid >= 0 else (0, 0)
    won = not S.lww_wins(st[0], st[1], uuid, coal.nodeid)
    if won:
        coal.regs[key] = (uuid, coal.nodeid)
    coal.add(b"set", (key, uuid, val), items[1:])
    return OK if won else _INT0


def _plan_counter_step(coal, items, sign):
    # op twin: _counter_step — bump our slot's lifetime total, reply the
    # new visible sum, replicate the ABSOLUTE total as `cntset`.  Both
    # numbers need the pre-run state once per key (landed sum + our
    # slot's landed total); later steps in the run are dict arithmetic.
    if len(items) < 2:
        return None
    try:
        key = as_bytes(items[1])
        delta = sign if len(items) < 3 else sign * as_int(items[2])
    except CstError:
        return None
    kid = coal.resolve_key(key, S.ENC_COUNTER)
    if kid is coal.CONFLICT:
        return None
    uuid = coal.tick()
    st = coal.cnts.get(key)
    if st is None:
        ks = coal.ks
        st = [ks.counter_sum(kid),
              ks.counter_slot_total(kid, coal.nodeid)] if kid >= 0 \
            else [0, 0]
        coal.cnts[key] = st
    st[0] += delta
    st[1] += delta
    coal.node.undo.record(uuid, key, delta)  # the op twin's CNTUNDO hook
    coal.add(b"cntset", (key, uuid, st[1]), [items[1], Int(st[1])])
    return Int(st[0])


@serve_plan("incr")
def _plan_incr(coal, items):
    return _plan_counter_step(coal, items, 1)


@serve_plan("decr")
def _plan_decr(coal, items):
    return _plan_counter_step(coal, items, -1)


@serve_plan("cntundo")
def _plan_cntundo(coal, items):
    # op twin: cntundo_command — the inverse step is just a counter step
    # whose delta comes from the undo log, so it plans exactly like
    # INCR/DECR once the target resolves.  Every rejection (non-counter
    # key, unknown/undone/evicted op) demotes BEFORE any mutation, and
    # the per-command path raises the exact error.
    n = len(items)
    if n < 2 or n > 3:
        return None
    try:
        key = as_bytes(items[1])
        uuid = as_uint(items[2]) if n > 2 else None
    except CstError:
        return None
    kid = coal.resolve_key(key, S.ENC_COUNTER)
    if kid is coal.CONFLICT:
        return None
    undo = coal.node.undo
    target = undo.resolve(key, uuid)
    if target is None:
        return None  # exact op error per-command
    t_uuid, delta = target
    new_uuid = coal.tick()
    st = coal.cnts.get(key)
    if st is None:
        ks = coal.ks
        st = [ks.counter_sum(kid),
              ks.counter_slot_total(kid, coal.nodeid)] if kid >= 0 \
            else [0, 0]
        coal.cnts[key] = st
    st[0] -= delta
    st[1] -= delta
    undo.mark_undone(t_uuid)
    undo.record(new_uuid, key, -delta, inverse=True)
    coal.add(b"cntset", (key, new_uuid, st[1]), [items[1], Int(st[1])])
    return Int(st[0])


def _plan_elem_update(coal, items, name, enc, add):
    # op twin: sadd/srem — the reply counts members whose VISIBILITY
    # flipped (elem_add/elem_rem return values), evaluated against the
    # landed element rows overlaid with the run's tracked flips.  A
    # fresh client uuid always wins the add-side LWW and the del-side
    # max, so visibility after the op is simply `add`.
    if len(items) < 3:
        return None
    try:
        key = as_bytes(items[1])
        members = [as_bytes(m) for m in items[2:]]
    except CstError:
        return None
    kid = coal.resolve_key(key, enc)
    if kid is coal.CONFLICT:
        return None
    uuid = coal.tick()
    cnt = coal.count_elem_flips(key, kid, members, add)
    coal.add(name, (key, uuid, members), items[1:])
    return Int(cnt)


@serve_plan("sadd")
def _plan_sadd(coal, items):
    return _plan_elem_update(coal, items, b"sadd", S.ENC_SET, True)


@serve_plan("srem")
def _plan_srem(coal, items):
    return _plan_elem_update(coal, items, b"srem", S.ENC_SET, False)


@serve_plan("hdel")
def _plan_hdel(coal, items):
    return _plan_elem_update(coal, items, b"hdel", S.ENC_DICT, False)


def _plan_tensor_common(coal, items, key, cfg, meta, payload, cnt):
    """Shared tail of the tensor planners (callers hold the validated
    meta): the payload-size check is the last demote gate; everything
    after mutates (tick + buffer)."""
    if len(payload) != meta.nbytes:
        return None  # per-command path raises the exact op error
    uuid = coal.tick()
    coal.add(b"tset", (key, uuid, cfg, cnt, payload),
             [items[1], Bulk(cfg), Int(cnt), Bulk(payload)])
    return OK


@serve_plan("tensor.set")
def _plan_tensor_set(coal, items):
    # op twin: tensor_set_command — config parse/validation and the
    # payload-size check all demote (the per-command path raises the
    # exact error); a run-created key's config lands in the run overlay
    # (coal.tns) so later SET/MERGE in the same run validate against it
    from ..crdt import tensor as T
    n = len(items)
    if n < 6 or n > 7:
        return None
    try:
        key = as_bytes(items[1])
        strat_s = as_bytes(items[2]).decode("utf-8", "replace")
        dtype_s = as_bytes(items[3]).decode("utf-8", "replace")
        shape_s = as_bytes(items[4]).decode("utf-8", "replace")
        payload = as_bytes(items[5])
        cnt = as_int(items[6]) if n > 6 else 1
    except CstError:
        return None
    if cnt < 1:
        return None  # per-command path raises the exact count error
    default_strat, max_elems = _tensor_knobs()
    try:
        # cap applied below, only when the key is genuinely NEW — the
        # op twin exempts existing keys (config is creation-fixed)
        meta = T.parse_meta(strat_s, dtype_s, shape_s,
                            default_strat=default_strat,
                            max_elems=1 << 62)
    except T.TensorConfigError:
        return None
    cfg = T.pack_config(meta)
    kid = coal.resolve_key(key, S.ENC_TENSOR)
    if kid is coal.CONFLICT:
        return None
    if kid < 0 and key not in coal.tns and meta.elems > max_elems:
        return None  # new key over the cap: exact op error per-command
    if kid >= 0:
        landed = coal.ks.tensor_meta_of(kid)
        if landed is None or T.pack_config(landed) != cfg:
            return None  # config mismatch: exact op error per-command
    else:
        prev = coal.tns.get(key)
        if prev is not None and prev != cfg:
            return None
        if len(payload) != meta.nbytes:
            return None  # demote BEFORE recording the run overlay
        coal.tns[key] = cfg
    return _plan_tensor_common(coal, items, key, cfg, meta, payload, cnt)


@serve_plan("tensor.merge")
def _plan_tensor_merge(coal, items):
    # op twin: tensor_merge_command — the key must already exist as a
    # tensor (landed, or created earlier in this run)
    from ..crdt import tensor as T
    n = len(items)
    if n < 3 or n > 4:
        return None
    try:
        key = as_bytes(items[1])
        payload = as_bytes(items[2])
        cnt = as_int(items[3]) if n > 3 else 1
    except CstError:
        return None
    if cnt < 1:
        return None  # per-command path raises the exact count error
    kid = coal.resolve_key(key, S.ENC_TENSOR)
    if kid is coal.CONFLICT:
        return None
    if kid >= 0:
        meta = coal.ks.tensor_meta_of(kid)
        if meta is None:
            return None
        cfg = T.pack_config(meta)
    else:
        cfg = coal.tns.get(key)
        if cfg is None:
            return None  # absent key: exact no-such-key error
        meta = T.unpack_config(cfg)
    return _plan_tensor_common(coal, items, key, cfg, meta, payload, cnt)


@serve_plan("hset")
def _plan_hset(coal, items):
    # op twin: hset — reply counts fields that became visible; values
    # ride the add-side LWW (overwriting a live field counts 0).
    n = len(items)
    if n < 4 or n & 1:
        return None  # key + (field, value) pairs — WrongArity otherwise
    try:
        key = as_bytes(items[1])
        fields = [as_bytes(f) for f in items[2::2]]
        vals = [as_bytes(v) for v in items[3::2]]
    except CstError:
        return None
    kid = coal.resolve_key(key, S.ENC_DICT)
    if kid is coal.CONFLICT:
        return None
    uuid = coal.tick()
    cnt = coal.count_elem_flips(key, kid, fields, True)
    coal.add(b"hset", (key, uuid, fields, vals), items[1:])
    return Int(cnt)


# membership + observability commands register themselves against this table
from ..replica import commands as _replica_commands  # noqa: E402,F401
from . import info as _info_commands  # noqa: E402,F401
from ..cluster import commands as _cluster_commands  # noqa: E402,F401
