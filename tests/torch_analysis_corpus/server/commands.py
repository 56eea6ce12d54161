"""Seeded NATIVE-CONTRACT violation, checked against the port's own
marker table (constdb_tpu_torch/native/intake.cpp): a command registered
for coalescing that the table does not cover.  `zadd` is
decorated @serve_plan but appears in none of the marker table's rows
(native / native-reads / python-only), so the C scanner would demote it
to OTHER silently — exactly one finding, on the decorator.  The handler
itself is first-key-confined, so KEY-CONFINED stays quiet; `sadd`
mirrors a real covered command and may not fire anything.

Also seeds the cluster routability direction: `smembers` IS in the
intake table's native-reads row, but registering it CMD_CTRL makes the
slot router skip it while the C scanner still fast-paths it — exactly
one `smembers:unroutable` finding on the decorator.

`tensor.set` is registered for coalescing AND listed in the table's
python-only row (the port plans tensor writes in Python): covered, so
it stays silent."""

CMD_READONLY = 1
CMD_CTRL = 4


def register(name, flags=0, families=()):
    def deco(fn):
        return fn
    return deco


def serve_plan(name):
    def deco(fn):
        return fn
    return deco


def serve_read(name, kind, enc=None, arity=2):
    def deco(fn):
        return fn
    return deco


@register("zadd")
def zadd_command(node, ctx, args):
    key = args.next_bytes()
    score = args.next_int()
    member = args.next_bytes()
    kid, _created = node.ks.get_or_create(key, 2, ctx.uuid)
    node.ks.elem_add(kid, member, score, ctx.uuid, ctx.nodeid)
    return kid


@serve_plan("zadd")
def _plan_zadd(coal, items):
    return None


@register("sadd")
def sadd_command(node, ctx, args):
    key = args.next_bytes()
    member = args.next_bytes()
    kid, _created = node.ks.get_or_create(key, 2, ctx.uuid)
    node.ks.elem_add(kid, member, None, ctx.uuid, ctx.nodeid)
    return kid


@serve_plan("sadd")
def _plan_sadd(coal, items):
    return None


@register("smembers", CMD_READONLY | CMD_CTRL)
def smembers_command(node, ctx, args):
    key = args.next_bytes()
    return node.ks.members(key)


@register("tensor.set")
def tensor_set_command(node, ctx, args):
    key = args.next_bytes()
    kid, _created = node.ks.get_or_create(key, 9, ctx.uuid)
    return kid


@serve_plan("tensor.set")
def _plan_tensor_set(coal, items):
    return None
