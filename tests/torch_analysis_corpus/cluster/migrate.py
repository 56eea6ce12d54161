"""Seeded SLOT-EPOCH violation: slot-table state cached across an
await and then used to guard an ownership mutation.

`flip_bad` snapshots the epoch from ``node.cluster`` before awaiting;
a FINALIZE or CLUSTERTAB adoption interleaving at that await bumps the
live epoch, so the stale comparison lets an outdated table through —
exactly one finding, token ``epoch``.  `flip_fixed` re-reads
``cl.epoch`` at the guard (attribute deref reads fresh state), and
`flip_pinned` declares the snapshot deliberate — both stay silent.
The file lives under ``cluster/`` so only the specialized rule (not
the general AWAIT-ATOMICITY) covers it.
"""


async def flip_bad(node, slot, table):
    cl = node.cluster
    epoch = cl.epoch
    await node.events.wait()
    if epoch == table.epoch:
        cl.table = table
        cl.migrating.pop(slot, None)


async def flip_fixed(node, slot, table):
    cl = node.cluster
    await node.events.wait()
    if cl.epoch < table.epoch:
        cl.table = table
        cl.migrating.pop(slot, None)


async def flip_pinned(node, slot, table):
    cl = node.cluster
    epoch = cl.epoch  # lint: pin[epoch]
    await node.events.wait()
    if epoch == table.epoch:
        cl.table = table
        cl.migrating.pop(slot, None)
