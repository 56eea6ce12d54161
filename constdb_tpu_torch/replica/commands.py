"""Cluster-membership commands: MEET / FORGET / REPLICAS.

Capability parity with the reference's replica ops (reference
src/replica.rs:16-93).  Differences, both deliberate:
  * MEET and FORGET are replicating writes — membership changes ride the
    normal op stream in addition to snapshot REPLICAS sections, so the
    transitive mesh join does not depend on a full sync happening.
  * FORGET is actually registered (the reference defines it but never adds
    it to the COMMANDS table — SURVEY.md §"Known reference defects").

`SYNC` has no handler here: it is a connection upgrade, intercepted by the
IO layer before dispatch (server/io.py), mirroring the reference's
sync_command stealing the client connection (replica.rs:16-40).
"""

from __future__ import annotations

import asyncio

from ..resp.message import Arr, Bulk, Err, Int, OK
from ..server.commands import CMD_READONLY, CMD_WRITE, register


def _app(node):
    return getattr(node, "app", None)


@register("meet", CMD_WRITE, families=())
def meet_command(node, ctx, args):
    """(reference replica.rs:49-75)"""
    addr = args.next_str()
    if ":" not in addr:
        return Err(b"address must be host:port")
    app = _app(node)
    if app is not None and addr == app.advertised_addr:
        return OK  # my own address: peers still learn it via replication
    meta = node.replicas.add(addr, ctx.uuid)
    if app is not None:
        app.ensure_link(meta)
    return OK


@register("forget", CMD_WRITE, families=())
def forget_command(node, ctx, args):
    """(reference replica.rs:77-86, unregistered there)"""
    addr = args.next_str()
    app = _app(node)
    if app is not None and addr == app.advertised_addr:
        return OK  # cannot forget myself; the rest of the mesh will
    changed = node.replicas.forget(addr, ctx.uuid)
    meta = node.replicas.get(addr)
    if changed and app is not None and meta is not None and meta.link is not None:
        asyncio.ensure_future(app.drop_link(meta))
    return Int(1 if changed else 0)


@register("replicas", CMD_READONLY)
def replicas_command(node, ctx, args):
    """(reference replica/replica.rs:63-85 generate_replicas_reply)"""
    rows = []
    for addr, m in node.replicas.describe():
        rows.append(Arr([
            Bulk(addr.encode()), Int(m.node_id), Bulk(m.alias.encode()),
            Bulk(b"alive" if m.alive else b"forgotten"),
            Int(m.uuid_i_sent), Int(m.uuid_i_acked),
            Int(m.uuid_he_sent), Int(m.uuid_he_acked)]))
    return Arr(rows)
