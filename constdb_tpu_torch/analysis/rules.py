"""The port's invariants, one Rule per defect class, over the
constdb_tpu_torch sources.

The thirteen rules and their names are the reference package's
(docs/INVARIANTS.md has the rule <-> defect map).  Three are redesigned
for the port: STAGE-PURE checks the device surface of engine/cuda.py
(torch, the kernel module KN and the engine's transfer and state
helpers) instead of the JAX engine's; ENV-REGISTRY checks the port's
own registry (constdb_tpu_torch/conf.py ENV_REGISTRY, CONSTDB_TORCH_*);
NATIVE-CONTRACT reads the marker tables of the port's own native
sources (constdb_tpu_torch/native/intake.cpp and aof.cpp).  The other
ten keep the reference's logic.

Adding a rule is ~30 lines: subclass `Rule`, scope it in `applies`,
emit via `self.finding`, append to ALL_RULES, drop a seeded violation
under tests/torch_analysis_corpus/<mirrored-dir>/, and re-run
`python -m constdb_tpu_torch.analysis --write-baseline` if the live
tree has pre-existing findings worth tracking instead of fixing.
"""

from __future__ import annotations

import ast

from . import flow
from .cfg import awaits_in
from .core import FileContext, Rule, dotted, own_nodes


def _scoped(ctx: FileContext, *dirs: str) -> bool:
    return any(d in ctx.parts[:-1] for d in dirs)


def _native_dir() -> str:
    """The port's native sources: constdb_tpu_torch/native/."""
    import os
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")


class AsyncBlockRule(Rule):
    """ASYNC-BLOCK: no blocking calls on the event loop.

    The asyncio loop IS the single-writer exec thread (server/io.py
    module header): one blocking call stalls every client, every replica
    link, and the cron.  The chaos suite once found a blocking replica
    path wedging exactly this way.  Flags `time.sleep`, sync socket
    construction, builtin file IO, `Future.result()` and subprocess
    waits inside `async def` — and inside sync helpers NESTED in an
    async def, which run on the loop when called."""

    name = "ASYNC-BLOCK"
    hint = ("move the blocking work to loop.run_in_executor(...), an "
            "async API, or a worker process; bounded local spill-file "
            "IO may be baselined with a note instead")

    BLOCKING = {
        "time.sleep": "blocks the loop for the full sleep",
        "socket.socket": "sync socket on the event loop",
        "socket.create_connection": "sync connect blocks the loop",
        "open": "sync file IO on the event loop",
        "os.system": "blocks until the child exits",
        "os.popen": "blocks on the child's pipe",
        "subprocess.run": "blocks until the child exits",
        "subprocess.call": "blocks until the child exits",
        "subprocess.check_call": "blocks until the child exits",
        "subprocess.check_output": "blocks until the child exits",
    }

    def applies(self, ctx: FileContext) -> bool:
        return _scoped(ctx, "server", "replica")

    def check(self, ctx: FileContext):
        for qual, fn, is_async, async_ctx in ctx.functions:
            if not (is_async or async_ctx):
                continue
            where = "async def" if is_async else \
                "sync helper nested in an async def (runs on the loop)"
            for node in own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted(node.func)
                why = self.BLOCKING.get(name)
                if why is not None:
                    yield self.finding(
                        ctx, node, qual, name,
                        f"blocking call {name}() inside {where}: {why}")
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "result" and not node.args:
                    yield self.finding(
                        ctx, node, qual, ".result()",
                        f".result() inside {where} blocks the loop until "
                        "the future resolves")


class StagePureRule(Rule):
    """STAGE-PURE: the static twin of the runtime stage/dispatch epoch
    guard (engine/cuda.py `_dispatch_elem_rows`).

    merge_many splits every CRDT family into STAGE (host-only prep, runs
    on the staging pool, possibly concurrently) and DISPATCH (device
    calls + pool bookkeeping, main thread, family order).  A `_stage_*`
    function touching torch or device state races the main thread's
    dispatch; a `_dispatch_*` function doing heavy host staging
    (`_stacked`, `_combine_groups`, `np.stack`) burns the critical path
    the pipeline exists to hide.

    The device surface is engine/cuda.py's: the name `torch`, the kernel
    module imported as `KN` (ops/kernels.py), and the engine's helpers
    that copy, launch, allocate or hold device state (DEVICE_MARKERS;
    each is a method of TorchMergeEngine)."""

    name = "STAGE-PURE"
    hint = ("STAGE runs on the staging pool: keep it numpy+store-plane "
            "only.  Heavy host prep in DISPATCH belongs in the matching "
            "_stage_* step (returned via the plan dict)")

    DEVICE_MARKERS = {
        # transfers: pinned uploads, downloads
        "_h2d", "_h2d_packed", "_get", "_get_pinned",
        # device allocation and the resident planes
        "_full", "_grow", "_resident_state", "_src_state",
        # launches: K3's steady round, K1 with its apply
        "_launch_round", "_fold_apply",
        # dispatch-only bookkeeping of device state and the win pool
        "_family_done", "_pool_add", "flush",
    }
    DEVICE_NAMES = {"torch", "KN"}
    HEAVY_STAGE_CALLS = {"self._stacked", "self._combine_groups",
                         "np.stack", "numpy.stack"}

    def applies(self, ctx: FileContext) -> bool:
        return _scoped(ctx, "engine")

    def check(self, ctx: FileContext):
        for qual, fn, _is_async, _actx in ctx.functions:
            base = qual.rsplit(".", 1)[-1]
            if base.startswith("_stage"):
                for node in own_nodes(fn):
                    if isinstance(node, ast.Attribute) and \
                            isinstance(node.value, ast.Name) and \
                            node.value.id == "self" and \
                            node.attr in self.DEVICE_MARKERS:
                        yield self.finding(
                            ctx, node, qual, f"self.{node.attr}",
                            f"STAGE step touches device state "
                            f"self.{node.attr} — stages run on the "
                            "staging pool and must stay host-pure")
                    elif isinstance(node, ast.Name) and \
                            node.id in self.DEVICE_NAMES:
                        yield self.finding(
                            ctx, node, qual, node.id,
                            f"STAGE step references {node.id} — device "
                            "work belongs in the _dispatch_* twin")
            elif base.startswith("_dispatch"):
                for node in own_nodes(fn):
                    if isinstance(node, ast.Call) and \
                            dotted(node.func) in self.HEAVY_STAGE_CALLS:
                        yield self.finding(
                            ctx, node, qual, dotted(node.func),
                            f"DISPATCH step calls {dotted(node.func)} — "
                            "heavy host staging on the critical path the "
                            "pipeline exists to overlap")


class CheckThenMutateRule(Rule):
    """CHECK-THEN-MUTATE: ceilings/invariants are checked BEFORE pool or
    table state mutates — the `_pool_add` bug class (the int32 src-plane
    ceiling was once checked AFTER appending, leaving a half-merged round
    + orphaned pool entry on overflow).

    In engine code, any `raise` OR `assert` that follows (in source
    order) a mutation of `self._pool_*` / `self._win_*` / the win value
    pool / a store-plane `append_block` within the same function is an
    error: the raise path strands partially-mutated state mid-round.
    `assert` counts double — it is a raise path AND `python -O` strips
    it (the codebase's own rule: a real raise, not an assert, guards
    data loss — engine/cuda.py `_resident_state`)."""

    name = "CHECK-THEN-MUTATE"
    hint = ("compute the expected outcome and raise BEFORE mutating "
            "(the fix applied to _pool_add), or flush/roll back "
            "before raising")

    def applies(self, ctx: FileContext) -> bool:
        return _scoped(ctx, "engine")

    @staticmethod
    def _mutation(node: ast.AST) -> str:
        """Non-empty description when `node` mutates guarded state."""
        def _pool_attr(t: ast.AST) -> str:
            if isinstance(t, ast.Subscript):
                t = t.value
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self" \
                    and (t.attr.startswith("_pool_")
                         or t.attr.startswith("_win_")
                         or t.attr == "_val_pool"):
                return f"self.{t.attr}"
            return ""

        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                got = _pool_attr(t)
                if got:
                    return got
        elif isinstance(node, ast.Call):
            name = dotted(node.func)
            if name.endswith(".append_block"):
                return name
            if name in ("self._val_pool.append", "self._pool_add"):
                return name
        return ""

    def check(self, ctx: FileContext):
        for qual, fn, _is_async, _actx in ctx.functions:
            first_mut = None   # (lineno, what)
            events = []        # (lineno, kind, node, what)
            for node in own_nodes(fn):
                what = self._mutation(node)
                if what:
                    events.append((node.lineno, "mut", node, what))
                elif isinstance(node, (ast.Raise, ast.Assert)):
                    kind = "assert" if isinstance(node, ast.Assert) \
                        else "raise"
                    events.append((node.lineno, kind, node, ""))
            events.sort(key=lambda e: e[0])
            for lineno, kind, node, what in events:
                if kind == "mut":
                    if first_mut is None:
                        first_mut = (lineno, what)
                elif first_mut is not None:
                    extra = " (and python -O strips asserts entirely)" \
                        if kind == "assert" else ""
                    yield self.finding(
                        ctx, node, qual, kind,
                        f"{kind} path at line {lineno} follows the "
                        f"mutation of {first_mut[1]} at line "
                        f"{first_mut[0]}: failing here strands "
                        f"partially-mutated engine state{extra}")


class EnvRegistryRule(Rule):
    """ENV-REGISTRY: every `CONSTDB_*` env read inside the package goes
    through `conf.py`'s registry helpers and is documented.

    Tuning knobs read ad hoc across modules once made the README table
    drift immediately.  The port's conf.ENV_REGISTRY
    (constdb_tpu_torch/conf.py, CONSTDB_TORCH_* names) is the one place
    a knob is declared: the helpers (env_str / env_int / env_float /
    env_flag) raise on unregistered names at runtime, and a
    project-level check pins the registry into the README tuning
    table."""

    name = "ENV-REGISTRY"
    hint = ("declare the variable in constdb_tpu_torch/conf.py "
            "ENV_REGISTRY, read it via conf.env_str/env_int/env_float/"
            "env_flag, and add it to the README Tuning table")

    READS = {"os.environ.get", "environ.get", "os.getenv",
             "os.environ.setdefault", "environ.setdefault"}
    HELPERS = {"env_str", "env_int", "env_float", "env_flag", "env_raw"}

    def __init__(self) -> None:
        self._registry: set | None = None

    def applies(self, ctx: FileContext) -> bool:
        return ctx.basename != "conf.py"

    def registry(self) -> set:
        if self._registry is None:
            from .. import conf
            self._registry = set(conf.ENV_REGISTRY)
        return self._registry

    @staticmethod
    def _const_env_name(node: ast.AST) -> str:
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith("CONSTDB_"):
            return node.value
        return ""

    def check(self, ctx: FileContext):
        # qualname stays "" for this rule: the env-var name IS the
        # stable identity (path + token), wherever in the file it moves
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and node.args:
                name = dotted(node.func)
                env = self._const_env_name(node.args[0])
                if not env:
                    continue
                if name in self.READS:
                    yield self.finding(
                        ctx, node, "", env,
                        f"direct {name}({env!r}) bypasses the conf.py "
                        "env registry")
                elif name.rsplit(".", 1)[-1] in self.HELPERS and \
                        env not in self.registry():
                    yield self.finding(
                        ctx, node, "", f"{env}:unregistered",
                        f"{env} is read via a conf helper but missing "
                        "from conf.ENV_REGISTRY")
            elif isinstance(node, ast.Subscript) and \
                    dotted(node.value) in ("os.environ", "environ"):
                env = self._const_env_name(node.slice)
                if env:
                    yield self.finding(
                        ctx, node, "", env,
                        f"os.environ[{env!r}] subscript bypasses the "
                        "conf.py env registry")


class ShmLifecycleRule(Rule):
    """SHM-LIFECYCLE: every `SharedMemory(create=True)` is close()d AND
    unlink()ed on all paths.

    A leaked /dev/shm segment survives the process on Linux — N leaked
    merge-job segments at snapshot scale fill the tmpfs and take the box
    down.  The creating function must reference <name>.close() and
    <name>.unlink() from a try handler/finally; creations whose
    ownership legitimately transfers (e.g. the worker export segment,
    freed by the parent's export_free round-trip) carry an inline
    `# lint: ignore[SHM-LIFECYCLE]` with the reason on the spot."""

    name = "SHM-LIFECYCLE"
    hint = ("wrap the segment's population + hand-off in try/except "
            "BaseException: close()+unlink()+raise, or document the "
            "ownership transfer with # lint: ignore[SHM-LIFECYCLE]")

    def applies(self, ctx: FileContext) -> bool:
        return _scoped(ctx, "parallel")

    def check(self, ctx: FileContext):
        for qual, fn, _a, _c in ctx.functions:
            creations = []  # (node, var)
            trys = []
            for node in own_nodes(fn):
                if isinstance(node, ast.Try):
                    trys.append(node)
                if not isinstance(node, ast.Assign) or \
                        not isinstance(node.value, ast.Call):
                    continue
                call = node.value
                if not dotted(call.func).endswith("SharedMemory"):
                    continue
                if not any(kw.arg == "create"
                           and isinstance(kw.value, ast.Constant)
                           and kw.value.value is True
                           for kw in call.keywords):
                    continue
                t = node.targets[0]
                var = t.id if isinstance(t, ast.Name) else \
                    getattr(t, "attr", "?")
                creations.append((node, var))
            if not creations:
                continue

            def protected(var: str) -> bool:
                want = {f"{var}.close", f"{var}.unlink",
                        f"self.{var}.close", f"self.{var}.unlink"}
                for t in trys:
                    bodies = list(t.finalbody)
                    for h in t.handlers:
                        bodies.extend(h.body)
                    seen = set()
                    for stmt in bodies:
                        for n in ast.walk(stmt):
                            if isinstance(n, ast.Call):
                                seen.add(dotted(n.func))
                    if {f"{var}.close", f"self.{var}.close"} & seen and \
                            {f"{var}.unlink", f"self.{var}.unlink"} & seen:
                        return True
                return False

            for node, var in creations:
                if not protected(var):
                    yield self.finding(
                        ctx, node, qual, var,
                        f"SharedMemory(create=True) assigned to {var!r} "
                        "has no try handler/finally calling both "
                        f"{var}.close() and {var}.unlink() — an error "
                        "between creation and hand-off leaks the "
                        "/dev/shm segment")


class BareExceptRule(Rule):
    """BARE-EXCEPT-SWALLOW: no `except Exception: pass` in the
    replication/apply paths.

    A backend probe caching its failures forever and the close-window
    zombie link both once hid behind broad swallowed excepts.  In replica/, server/, parallel/ and persist/, a bare /
    Exception / BaseException handler whose body is only `pass` is an
    error — narrow it to the exceptions the cleanup can actually raise,
    or at minimum log.  `__del__` is exempt (raising there is worse)."""

    name = "BARE-EXCEPT-SWALLOW"
    hint = ("narrow to the concrete exceptions (e.g. OSError for fs "
            "cleanup) or log the swallowed error")

    def applies(self, ctx: FileContext) -> bool:
        return _scoped(ctx, "replica", "server", "parallel", "persist")

    @staticmethod
    def _broad(h: ast.ExceptHandler) -> bool:
        t = h.type
        if t is None:
            return True
        names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
        return any(isinstance(n, ast.Name)
                   and n.id in ("Exception", "BaseException")
                   for n in names)

    @staticmethod
    def _swallows(h: ast.ExceptHandler) -> bool:
        return all(isinstance(s, ast.Pass)
                   or (isinstance(s, ast.Expr)
                       and isinstance(s.value, ast.Constant))
                   for s in h.body)

    def check(self, ctx: FileContext):
        for qual, fn, _a, _c in ctx.functions:
            if qual.rsplit(".", 1)[-1] == "__del__":
                continue
            for node in own_nodes(fn):
                if isinstance(node, ast.ExceptHandler) and \
                        self._broad(node) and self._swallows(node):
                    yield self.finding(
                        ctx, node, qual, "except-pass",
                        "broad except swallowing every error in a "
                        "replication/apply path hides real failures "
                        "(the cached-probe / zombie-link bug class)")


class ForkCaptureRule(Rule):
    """FORK-CAPTURE: callables crossing the process-pool boundary are
    module-level functions, and their args are plain data.

    host_pool workers are forkserver children: a lambda / closure /
    bound method as `target=` either fails to pickle or — worse —
    drags a captured KeySpace / engine / event loop across the fork,
    where its native tables and device handles are garbage (the module
    contract: only shard ids and plane payloads cross the boundary)."""

    name = "FORK-CAPTURE"
    hint = ("make the worker entry a module-level function; ship shard "
            "ids + encoded plane bytes, never live store/engine/loop "
            "objects")

    SUSPECT_ARGS = {"store", "ks", "keyspace", "engine", "eng", "node",
                    "app", "loop", "server", "self"}

    def applies(self, ctx: FileContext) -> bool:
        return _scoped(ctx, "parallel")

    def check(self, ctx: FileContext):
        module_defs = {n.name for n in ast.iter_child_nodes(ctx.tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
        for qual, fn, _a, _c in ctx.functions:
            nested_defs = {n.name for n in own_nodes(fn)
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))}
            for node in own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted(node.func)
                if not (name == "Process" or name.endswith(".Process")):
                    continue
                for kw in node.keywords:
                    if kw.arg == "target":
                        v = kw.value
                        if isinstance(v, ast.Lambda):
                            yield self.finding(
                                ctx, v, qual, "lambda",
                                "lambda as a process target captures its "
                                "defining scope across the fork")
                        elif isinstance(v, ast.Attribute):
                            yield self.finding(
                                ctx, v, qual, dotted(v) or v.attr,
                                "bound method / attribute as a process "
                                "target drags its instance across the "
                                "fork")
                        elif isinstance(v, ast.Name) and \
                                v.id in nested_defs and \
                                v.id not in module_defs:
                            yield self.finding(
                                ctx, v, qual, v.id,
                                f"nested function {v.id!r} as a process "
                                "target is a closure over the enclosing "
                                "frame")
                    elif kw.arg == "args" and \
                            isinstance(kw.value, (ast.Tuple, ast.List)):
                        for el in kw.value.elts:
                            if isinstance(el, ast.Attribute) and \
                                    isinstance(el.value, ast.Name) and \
                                    el.value.id == "self":
                                yield self.finding(
                                    ctx, el, qual, dotted(el),
                                    f"{dotted(el)} shipped as a worker "
                                    "arg: instance state must not cross "
                                    "the process boundary")
                            elif isinstance(el, ast.Name) and \
                                    el.id in self.SUSPECT_ARGS:
                                yield self.finding(
                                    ctx, el, qual, el.id,
                                    f"{el.id!r} shipped as a worker arg "
                                    "looks like a live store/engine/"
                                    "loop object — only shard ids and "
                                    "plane payloads cross the boundary")


class KeyConfinedRule(Rule):
    """KEY-CONFINED: every command registered for coalescing
    (SERVE_PLANNERS via @serve_plan, COLUMNAR_ENCODERS via @columnar,
    SERVE_READS via @serve_read — the read planner routes, flushes, and
    caches by the first argument alone) must be statically
    first-key-confined.

    Three subsystems silently rely on the convention that a data
    command's keyspace effects are confined to the key in its FIRST
    argument: the barrier scoping (a barrier invalidates only its
    first-arg key's cached probes), the replication coalescer's
    key-scoped barrier commutes, and the serve shards' routing (the whole
    command executes inside the worker owning `crc32(items[1]) % N`).
    A handler that resolves a key it did not take as its first argument
    would silently corrupt all three.  The check: the handler's first
    `args.next_bytes()` binding is THE key — every keyspace key
    resolution (`lookup` / `query` / `get_or_create` / `create_key`)
    must take exactly that name as its first argument, and a handler
    with no such binding cannot be proven confined at all.  One level
    of helper delegation (`incr` → `_counter_step(node, ctx, args, 1)`)
    is followed."""

    name = "KEY-CONFINED"
    hint = ("derive the key from the handler's FIRST args.next_bytes() "
            "and resolve only that name — or keep the command off the "
            "coalescing tables (it stays an exact per-command barrier)")

    KEY_RESOLVERS = {"lookup", "query", "get_or_create", "create_key"}
    COALESCE_DECOS = {"serve_plan", "columnar", "serve_read"}

    def applies(self, ctx: FileContext) -> bool:
        return _scoped(ctx, "server")

    @staticmethod
    def _deco_str_arg(deco: ast.AST, names: set) -> str:
        if isinstance(deco, ast.Call) and \
                dotted(deco.func).rsplit(".", 1)[-1] in names and \
                deco.args and isinstance(deco.args[0], ast.Constant) and \
                isinstance(deco.args[0].value, str):
            return deco.args[0].value
        return ""

    def check(self, ctx: FileContext):
        coalesced: set[str] = set()
        handlers: dict[str, tuple] = {}   # cmd name -> (qualname, fn)
        module_fns: dict[str, tuple] = {}  # fn name -> (qualname, fn)
        for qual, fn, _a, _c in ctx.functions:
            if "." not in qual:
                module_fns[qual] = (qual, fn)
            for deco in getattr(fn, "decorator_list", ()):
                got = self._deco_str_arg(deco, self.COALESCE_DECOS)
                if got:
                    coalesced.add(got)
                got = self._deco_str_arg(deco, {"register"})
                if got:
                    handlers[got] = (qual, fn)
        for cmd in sorted(coalesced):
            ent = handlers.get(cmd)
            if ent is None:
                continue  # registered elsewhere; runtime assert covers it
            yield from self._check_fn(ctx, cmd, *ent, module_fns, hops=2)

    def _check_fn(self, ctx: FileContext, cmd: str, qual: str, fn: ast.AST,
                  module_fns: dict, hops: int):
        key_var = None
        nodes = sorted(own_nodes(fn),
                       key=lambda n: getattr(n, "lineno", 0))
        for node in nodes:
            if key_var is None and isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    dotted(node.value.func) == "args.next_bytes" and \
                    node.targets and isinstance(node.targets[0], ast.Name):
                key_var = node.targets[0].id
                continue
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    f.attr in self.KEY_RESOLVERS and node.args:
                a0 = node.args[0]
                if key_var is None:
                    yield self.finding(
                        ctx, node, qual, cmd,
                        f"coalesced command {cmd!r} resolves a key via "
                        f".{f.attr}(...) before any args.next_bytes() "
                        "binding — first-key confinement is not "
                        "statically derivable")
                elif not (isinstance(a0, ast.Name) and a0.id == key_var):
                    yield self.finding(
                        ctx, node, qual, cmd,
                        f"coalesced command {cmd!r} resolves "
                        f"{ast.unparse(a0)!r} "
                        f"via .{f.attr}(...) but its first-argument key "
                        f"binding is {key_var!r} — the shard router and "
                        "barrier scoping both assume first-key "
                        "confinement")
        if key_var is not None or hops <= 0:
            return
        # no key binding in this body: follow one delegation hop — a
        # call passing `args` through to a module-level helper
        for node in nodes:
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id in module_fns and \
                    any(isinstance(a, ast.Name) and a.id == "args"
                        for a in node.args):
                dq, dfn = module_fns[node.func.id]
                yield from self._check_fn(ctx, cmd, dq, dfn, module_fns,
                                          hops - 1)
                return
        yield self.finding(
            ctx, fn, qual, cmd,
            f"coalesced command {cmd!r} has no args.next_bytes() key "
            "binding and no args-delegating helper — first-key "
            "confinement is not statically derivable")


class AwaitAtomicityRule(Rule):
    """AWAIT-ATOMICITY: a shared-state read cached across an await must
    not guard a mutation — the bug class behind three shipped races
    (the close-window link sweep, the consistency cut, the quiesce
    done-callback).

    Flow-sensitive (analysis/cfg.py + analysis/flow.py): the dataflow
    engine tracks which locals are derived from shared node/link/plane
    state and marks them stale at every await point the CFG says can
    interleave before their use.  The rule fires only on the high-signal
    shape: a STALE local in a guard position (an `if`/`while` test or a
    `for` iterable) over a suite that mutates shared state.  Re-reading
    after the await clears the fact; a deliberate pre-await snapshot
    (the consistency-cut fix captures the cut FIRST on purpose) is
    declared with
    `# lint: pin[name]` on the capture line."""

    name = "AWAIT-ATOMICITY"
    hint = ("re-read the shared state after the await (other tasks ran "
            "there), or declare a deliberate pre-await snapshot with "
            "# lint: pin[name] on the capture line")

    def applies(self, ctx: FileContext) -> bool:
        return _scoped(ctx, "server", "replica", "persist", "parallel")

    def check(self, ctx: FileContext):
        pins = flow.pins_by_line(ctx.source)
        for qual, fn, is_async, _actx in ctx.functions:
            if not is_async:
                continue
            if not any(isinstance(n, ast.Await) for n in own_nodes(fn)):
                continue
            fa = flow.FunctionFlow(fn, pins)
            for node in own_nodes(fn):
                if isinstance(node, (ast.If, ast.While)):
                    env = fa.env_at.get(id(node.test))
                    if env is None:
                        continue
                    suites = list(node.body) + list(node.orelse)
                    yield from self._guard(ctx, qual, node, node.test,
                                           env, suites, "test")
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    env = fa.env_at.get(id(node))
                    if env is None:
                        continue
                    yield from self._guard(ctx, qual, node, node.iter,
                                           env, list(node.body), "iterable")

    def _guard(self, ctx, qual, node, expr, env, suites, where):
        muts = None
        # only VALUE usages can be stale: locals are task-private, so
        # deref bases and `is None` binding tests read fresh state
        for nm in sorted(flow.value_used_names(expr)):
            st = env.get(nm)
            if st is None or not st.sources or not st.stale:
                continue
            if muts is None:
                muts = flow.shared_mutations(suites, env)
            if not muts:
                return
            src = ", ".join(sorted(st.sources)[:2])
            mut_what = muts[0][1]
            yield self.finding(
                ctx, node, qual, nm,
                f"local {nm!r} (from {src}, line {st.line}) is read in "
                f"this {where} after the await at line {st.stale_line} "
                f"and guards a mutation of {mut_what} — tasks "
                "interleaving at that await can invalidate the cached "
                "view (the close-window / quiesce-callback race shape)")


class SlotEpochRule(AwaitAtomicityRule):
    """SLOT-EPOCH: AWAIT-ATOMICITY specialized to the slot table.

    Slot ownership is epoch-versioned and every migration await is an
    ownership-flap window: the peer can FINALIZE, gossip a newer table,
    or the local node can adopt one over CLUSTERTAB while a coroutine
    sleeps.  A local derived from ``*.cluster`` / slot-table state that
    goes stale across an await must therefore not guard a mutation —
    the handler has to re-read ``cl.epoch`` (or compare against the
    live table) after the await before it flips ownership, pops a
    migrating/importing entry, or adopts a watermark.  Same dataflow
    engine as AWAIT-ATOMICITY; this rule narrows the sources to the
    cluster plane and extends coverage to ``cluster/``, which the
    general rule deliberately leaves to this specialization."""

    name = "SLOT-EPOCH"
    hint = ("re-validate the slot-table epoch after the await "
            "(compare cl.epoch, not a pre-await copy) before mutating "
            "ownership; a deliberate pre-handoff snapshot is declared "
            "with # lint: pin[name] on the capture line")

    def applies(self, ctx: FileContext) -> bool:
        return _scoped(ctx, "cluster", "server", "replica")

    def _guard(self, ctx, qual, node, expr, env, suites, where):
        muts = None
        for nm in sorted(flow.value_used_names(expr)):
            st = env.get(nm)
            if st is None or not st.sources or not st.stale:
                continue
            if not any("cluster" in s for s in st.sources):
                continue
            if muts is None:
                muts = flow.shared_mutations(suites, env)
            if not muts:
                return
            src = ", ".join(sorted(st.sources)[:2])
            mut_what = muts[0][1]
            yield self.finding(
                ctx, node, qual, nm,
                f"local {nm!r} caches slot-table state ({src}, line "
                f"{st.line}) across the await at line {st.stale_line} "
                f"and guards a mutation of {mut_what} — a FINALIZE or "
                "CLUSTERTAB adoption interleaving there bumps the epoch "
                "and invalidates the cached ownership view")


class LockDisciplineRule(Rule):
    """LOCK-DISCIPLINE: lock windows and the event loop don't mix.

    Two directions, one per lock flavor:
    * a SYNC `with <...>_lock:` body containing an `await` parks the
      thread lock across an arbitrary number of scheduler turns — every
      other thread contending on it (the keyspace `_crc_lock` protects
      merge-worker CRC reads) stalls for as long as the loop pleases,
      and re-entry through the same coroutine path self-deadlocks;
    * an ASYNC `with <...>_lock:` body making blocking sync calls
      (file IO, sleeps, `.result()`) wedges the loop while holding the
      lock, so every waiter behind it (the `_stream_lock` serializes
      snapshot streams against spill downloads) is wedged too — spill
      IO belongs in run_in_executor, like link._stream_file does."""

    name = "LOCK-DISCIPLINE"
    hint = ("keep thread-lock bodies synchronous (snapshot the data, "
            "release, then await), and move blocking IO under asyncio "
            "locks to loop.run_in_executor(...)")

    def applies(self, ctx: FileContext) -> bool:
        return _scoped(ctx, "server", "replica", "store", "persist",
                       "parallel")

    @staticmethod
    def _lock_names(node: ast.AST) -> list[str]:
        out = []
        for item in node.items:
            name = dotted(item.context_expr)
            if name and name.rsplit(".", 1)[-1].endswith("_lock"):
                out.append(name)
        return out

    def check(self, ctx: FileContext):
        for qual, fn, _is_async, _actx in ctx.functions:
            for node in own_nodes(fn):
                if isinstance(node, ast.With):
                    for lock in self._lock_names(node):
                        hits = [a for s in node.body for a in awaits_in(s)]
                        if hits:
                            yield self.finding(
                                ctx, hits[0], qual, lock,
                                f"await inside the sync `with {lock}:` "
                                "window parks the thread lock across "
                                "scheduler turns — contending threads "
                                "stall and re-entry self-deadlocks")
                elif isinstance(node, ast.AsyncWith):
                    for lock in self._lock_names(node):
                        yield from self._blocking_in(ctx, qual, lock,
                                                     node.body)

    def _blocking_in(self, ctx, qual, lock, body):
        stack = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                continue
            stack.extend(ast.iter_child_nodes(node))
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name in AsyncBlockRule.BLOCKING:
                yield self.finding(
                    ctx, node, qual, f"{lock}:{name}",
                    f"blocking call {name}() while holding the "
                    f"asyncio lock {lock} wedges the loop AND every "
                    "waiter queued on the lock — run it in an "
                    "executor")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "result" and not node.args:
                yield self.finding(
                    ctx, node, qual, f"{lock}:.result()",
                    f".result() while holding the asyncio lock "
                    f"{lock} blocks the loop with the lock held")


class CutOrderingRule(Rule):
    """CUT-ORDERING: watermark/record capture precedes any awaited state
    export in the same function — the INVARIANTS "consistency cuts" law
    (a digest once awaited BEFORE the replication watermark was read
    described a cut no replica could ever converge to, because writes
    landing during the await advanced the watermark past the digest).

    Must-analysis over the CFG (analysis/flow.py cut_violations): an
    awaited export (`export_batches`, `state_digest`, `key_count`, ...)
    is flagged when some path reaches it with NO prior capture of
    `last_uuid`/`landed_last_uuid`/`.records()`.  Functions that never
    capture a watermark are not building a cut and stay out of scope."""

    name = "CUT-ORDERING"
    hint = ("capture the watermark/record cut into locals FIRST, then "
            "await the derived exports (the consistency-cut fix "
            "ordering: "
            "watermarks first, digest after)")

    def applies(self, ctx: FileContext) -> bool:
        return _scoped(ctx, "server", "replica", "persist", "bin")

    def check(self, ctx: FileContext):
        for qual, fn, is_async, _actx in ctx.functions:
            if not is_async:
                continue
            for aw, term in flow.cut_violations(fn):
                yield self.finding(
                    ctx, aw, qual, term,
                    f"awaited export {term}() is reachable before the "
                    "watermark/record capture in this function — writes "
                    "landing during the await advance the watermark "
                    "past the exported state, describing a cut no "
                    "replica can converge to")


class NativeContractRule(Rule):
    """NATIVE-CONTRACT: the C intake stage's command table and the Python
    serve registries never drift apart.

    The port's native/intake.cpp (constdb_tpu_torch/native/, the port's
    own copy of the C sources, which carries the marker blocks)
    classifies client commands by a frozen opcode
    table; server/serve.py dispatches those opcodes straight into the
    planners.  A command registered for coalescing (@serve_plan /
    @serve_read) that the C table does not know silently loses its fast
    path (OTHER opcode, per-command execution inside a planned run —
    correct but quietly slow, the exact drift the table froze);
    worse, a table entry with no runtime planner would mean the C side
    claims a command serve.py cannot plan.  Both directions are checked
    against the marker block intake.cpp carries for this purpose
    (NATIVE-INTAKE-TABLE-BEGIN/END): every decorated command name must
    appear in the table's `native`/`native-reads` rows or be listed
    `python-only` with a reason; every `native`/`native-reads` entry
    must exist in the runtime SERVE_PLANNERS/COLUMNAR_ENCODERS/
    SERVE_READS registries."""

    name = "NATIVE-CONTRACT"
    hint = ("add the command to the native/intake.cpp marker table "
            "(native:/native-reads: if the C scanner classifies it, "
            "python-only: with the opcode left to the pure path "
            "otherwise) and keep the C classify() switch in step — or "
            "drop the stale table entry")

    DECOS = {"serve_plan", "serve_read"}

    @staticmethod
    def _register_info(deco: ast.AST):
        """(name, is_ctrl, keyless) for an ``@register("x", FLAGS,
        families=...)`` decorator, else None.  is_ctrl: the flags
        expression names CMD_CTRL.  keyless: families is declared an
        EMPTY tuple/list (default = all families = first-key-confined,
        so only an explicit () opts a command out of key routing)."""
        if not (isinstance(deco, ast.Call)
                and isinstance(deco.func, ast.Name)
                and deco.func.id == "register"
                and deco.args
                and isinstance(deco.args[0], ast.Constant)
                and isinstance(deco.args[0].value, str)):
            return None
        is_ctrl = any(isinstance(n, ast.Name) and n.id == "CMD_CTRL"
                      for a in deco.args[1:]
                      for n in ast.walk(a))
        fam = None
        if len(deco.args) > 2:
            fam = deco.args[2]
        for kw in deco.keywords:
            if kw.arg == "families":
                fam = kw.value
        keyless = isinstance(fam, (ast.Tuple, ast.List)) and not fam.elts
        return deco.args[0].value, is_ctrl, keyless

    def __init__(self) -> None:
        self._table: tuple | None = None
        self._registry: set | None = None
        self._aof_table: tuple | None = None

    def applies(self, ctx: FileContext) -> bool:
        if ctx.basename == "commands.py" and _scoped(ctx, "server"):
            return True
        return ctx.basename == "oplog.py" and _scoped(ctx, "persist")

    def table(self) -> tuple:
        """(found, native, native_reads, python_only) from the marker
        block in the port's native/intake.cpp — resolved from the real
        source tree, constdb_tpu_torch/native/ beside this package (the
        table is repo state, like conf.ENV_REGISTRY for ENV-REGISTRY),
        so corpus mirrors are checked against the same contract the live
        tree is."""
        if self._table is None:
            import os
            import re
            path = os.path.join(_native_dir(), "intake.cpp")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    src = f.read()
            except OSError:
                src = ""
            m = re.search(r"NATIVE-INTAKE-TABLE-BEGIN(.*?)"
                          r"NATIVE-INTAKE-TABLE-END", src, re.S)
            sets: dict[str, set] = {"native": set(), "native-reads": set(),
                                    "python-only": set()}
            if m:
                for line in m.group(1).splitlines():
                    line = line.strip().lstrip("/").strip()
                    for label, dst in sets.items():
                        if line.startswith(label + ":"):
                            dst.update(line[len(label) + 1:].split())
            self._table = (m is not None, sets["native"],
                           sets["native-reads"], sets["python-only"])
        return self._table

    def registry(self) -> set:
        """Runtime command names (str) across the three coalescing
        registries, imported lazily like ENV-REGISTRY's conf read."""
        if self._registry is None:
            from ..server import commands as C
            self._registry = {k.decode() for k in C.SERVE_PLANNERS} | \
                {k.decode() for k in C.COLUMNAR_ENCODERS} | \
                {k.decode() for k in C.SERVE_READS}
        return self._registry

    def aof_table(self) -> tuple:
        """(found, {record-name: int}) from the NATIVE-AOF-TABLE marker
        block in the port's native/aof.cpp (the disk-format twin of the
        intake command table)."""
        if self._aof_table is None:
            import os
            import re
            path = os.path.join(_native_dir(), "aof.cpp")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    src = f.read()
            except OSError:
                src = ""
            m = re.search(r"NATIVE-AOF-TABLE-BEGIN(.*?)"
                          r"NATIVE-AOF-TABLE-END", src, re.S)
            types: dict[str, int] = {}
            if m:
                for line in m.group(1).splitlines():
                    line = line.strip().lstrip("/").strip()
                    if line.startswith("record-types:"):
                        for pair in line[len("record-types:"):].split():
                            name, _, val = pair.partition("=")
                            if name and val.isdigit():
                                types[name] = int(val)
            self._aof_table = (m is not None, types)
        return self._aof_table

    @staticmethod
    def _rec_constants(ctx: FileContext) -> dict[str, tuple[int, ast.AST]]:
        """Module-level `REC_<NAME> = <int>` bindings of the checked
        file, keyed by the lowercased record name."""
        out: dict[str, tuple[int, ast.AST]] = {}
        for node in ast.iter_child_nodes(ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id.startswith("REC_") \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, int):
                name = node.targets[0].id[len("REC_"):].lower()
                out[name] = (node.value.value, node)
        return out

    def _check_aof(self, ctx: FileContext):
        found, types = self.aof_table()
        if not found:
            yield self.finding(
                ctx, ctx.tree, "", "aof-table-missing",
                "native/aof.cpp has no NATIVE-AOF-TABLE marker block — "
                "the C record-type contract cannot be checked")
            return
        consts = self._rec_constants(ctx)
        # direction 1: every Python record type the C table knows, with
        # the same wire value
        for name, (val, node) in sorted(consts.items()):
            if name not in types:
                yield self.finding(
                    ctx, node, "", f"aof:{name}:missing-from-table",
                    f"REC_{name.upper()}={val} has no entry in the "
                    "native/aof.cpp record-type table — the C scanner's "
                    "crc gate rejects the record as corruption")
            elif types[name] != val:
                yield self.finding(
                    ctx, node, "", f"aof:{name}:drift",
                    f"REC_{name.upper()}={val} but native/aof.cpp "
                    f"declares {name}={types[name]} — the two sides "
                    "would classify each other's records as corrupt")
        # direction 2: every C record type has a Python twin
        for name, val in sorted(types.items()):
            if name not in consts:
                yield self.finding(
                    ctx, ctx.tree, "", f"aof:{name}:unknown-record-type",
                    f"native/aof.cpp record type {name}={val} has no "
                    f"REC_{name.upper()} constant here — the Python "
                    "decoder cannot replay what the C scanner emits")

    def check(self, ctx: FileContext):
        if ctx.basename == "oplog.py":
            yield from self._check_aof(ctx)
            return
        found, native, reads, pyonly = self.table()
        if not found:
            yield self.finding(
                ctx, ctx.tree, "", "intake-table-missing",
                "native/intake.cpp has no NATIVE-INTAKE-TABLE marker "
                "block — the C intake contract cannot be checked")
            return
        covered = native | reads | pyonly
        # direction 1: every command THIS file registers for coalescing
        # is accounted for in the C table
        for qual, fn, _a, _c in ctx.functions:
            for deco in getattr(fn, "decorator_list", ()):
                got = KeyConfinedRule._deco_str_arg(deco, self.DECOS)
                if got and got not in covered:
                    yield self.finding(
                        ctx, deco, qual, got,
                        f"command {got!r} is registered for coalescing "
                        "but absent from the native/intake.cpp table — "
                        "the C scanner demotes it to OTHER silently "
                        "(declare it native/native-reads with a C "
                        "classify() arm, or python-only with a reason)")
        # direction 2: every command the C table claims to classify has
        # a runtime planner/encoder/read-spec behind its opcode
        for entry in sorted(native | reads):
            if entry not in self.registry():
                yield self.finding(
                    ctx, ctx.tree, "", f"{entry}:stale",
                    f"native/intake.cpp table lists {entry!r} but no "
                    "runtime planner/encoder/read-spec is registered "
                    "under that name — the C scanner would emit an "
                    "opcode serve.py cannot plan")
        # direction 3 (cluster): every native-table command must be
        # slot-routable.  The router keys off the first argument
        # (shard_routable: not CMD_CTRL, non-empty families), and the
        # native fast path trusts that the redirect demotion in
        # serve.py can always extract that key from the scanned
        # payload.  A native/native-reads entry registered CMD_CTRL or
        # with families=() would take the C fast path yet be invisible
        # to the router — in cluster mode the two planes disagree on
        # where the command runs.
        for qual, fn, _a, _c in ctx.functions:
            for deco in getattr(fn, "decorator_list", ()):
                info = self._register_info(deco)
                if info is None:
                    continue
                nm, is_ctrl, keyless = info
                if nm in (native | reads) and (is_ctrl or keyless):
                    why = "CMD_CTRL" if is_ctrl else "families=()"
                    yield self.finding(
                        ctx, deco, qual, f"{nm}:unroutable",
                        f"command {nm!r} is in the native/intake.cpp "
                        f"fast-path table but registered {why} — the "
                        "slot router (cluster/slots.py) skips it while "
                        "the C scanner still classifies it, so cluster "
                        "mode would execute it on a non-owner (move it "
                        "to python-only:, or make it first-key-"
                        "confined)")


ALL_RULES: list[Rule] = [
    AsyncBlockRule(),
    StagePureRule(),
    CheckThenMutateRule(),
    EnvRegistryRule(),
    ShmLifecycleRule(),
    BareExceptRule(),
    ForkCaptureRule(),
    KeyConfinedRule(),
    NativeContractRule(),
    AwaitAtomicityRule(),
    SlotEpochRule(),
    LockDisciplineRule(),
    CutOrderingRule(),
]
