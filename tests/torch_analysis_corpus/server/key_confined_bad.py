"""Seeded KEY-CONFINED violations: coalesced commands that are not
first-key-confined.  `badswap` resolves a key taken as its SECOND
argument (the shard router would execute it in the wrong worker);
`nokey` never binds a first-argument key at all; `goodcmd` is the clean
shape (first next_bytes is the key, only that name is resolved) and a
delegating `goodstep` mirrors the incr/_counter_step hop — neither may
fire."""


def register(name, flags=0, families=()):
    def deco(fn):
        return fn
    return deco


def serve_plan(name):
    def deco(fn):
        return fn
    return deco


def columnar(name):
    def deco(fn):
        return fn
    return deco


@register("badswap")
def badswap_command(node, ctx, args):
    field = args.next_bytes()
    key = args.next_bytes()  # the key is the SECOND argument
    kid, _created = node.ks.get_or_create(key, 1, ctx.uuid)
    return kid, field


@serve_plan("badswap")
def _plan_badswap(coal, items):
    return None


@register("nokey")
def nokey_command(node, ctx, args):
    idx = args.next_int()
    return node.ks.lookup(b"static-key"), idx


@columnar("nokey")
def _enc_nokey(bb, recs):
    return None


@register("goodcmd")
def goodcmd_command(node, ctx, args):
    key = args.next_bytes()
    member = args.next_bytes()
    kid, _created = node.ks.get_or_create(key, 2, ctx.uuid)
    node.ks.elem_add(kid, member, None, ctx.uuid, ctx.nodeid)
    return kid


@serve_plan("goodcmd")
def _plan_goodcmd(coal, items):
    return None


def _step_helper(node, ctx, args, delta):
    key = args.next_bytes()
    kid, _created = node.ks.get_or_create(key, 3, ctx.uuid)
    return kid + delta


@register("goodstep")
def goodstep_command(node, ctx, args):
    return _step_helper(node, ctx, args, 1)


@columnar("goodstep")
def _enc_goodstep(bb, recs):
    return None
