"""Flow-sensitive facts over the CFGs from :mod:`cfg`.

Two small dataflow analyses, each one lattice and one transfer function:

* **Staleness** (may-analysis, powers AWAIT-ATOMICITY): for every local
  name, track whether its value was *derived from shared state* (an
  attribute chain rooted at ``self`` or a node/link/plane-style
  parameter) and whether an ``await`` has interleaved since the value was
  captured.  After an await every shared-derived local is *stale*: the
  loop may have run other tasks that mutated the source, so the cached
  view no longer guards anything.  Re-binding from a fresh read clears
  the fact; an explicit ``# lint: pin[name]`` on the capture line opts a
  deliberate snapshot out (the consistency-cut fix pattern — capture the
  cut FIRST, on purpose, then await).

* **Cut ordering** (must-analysis, powers CUT-ORDERING): a boolean
  "watermark captured" fact.  Joins take AND, so an awaited state export
  is only blessed when a capture happened on EVERY path reaching it —
  the INVARIANTS "consistency cuts" law (watermarks first, derived state
  after) as a call-order property.

Both are intraprocedural and deliberately approximate: attribute chains
are matched syntactically, awaits inside one statement are treated as
happening before the statement's binding, and unreachable blocks carry
no facts.  The rules consuming these facts only *fire* on high-signal
shapes (a stale name in a guard position over a shared mutation), which
is what keeps the live-tree false-positive rate at zero.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field, replace
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from .cfg import CFG, Block, awaits_in, build_cfg, is_header

# Parameter names that conventionally carry shared runtime state in this
# codebase (server/replica/persist signatures).  ``self`` is always
# shared.  A local *assignment* to one of these names overrides the
# convention — the env tracks it like any other alias from then on.
SHARED_PARAM_ROOTS = {
    "self", "node", "app", "plane", "link", "server", "srv",
    "ks", "store", "eng", "shard",
}

_PIN_RE = re.compile(r"#\s*lint:\s*pin\[([A-Za-z0-9_*,\s]+)\]")


def pins_by_line(source: str) -> Dict[int, Set[str]]:
    """``# lint: pin[name, ...]`` comments: line -> pinned local names."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _PIN_RE.search(line)
        if m:
            out[i] = {s.strip() for s in m.group(1).split(",") if s.strip()}
    return out


@dataclass(frozen=True)
class VarState:
    """What the analysis knows about one local name.

    ``sources`` empty means "explicitly not shared-derived" (a kill —
    distinct from absent, which falls back to the parameter-name
    convention for chain roots)."""

    sources: FrozenSet[str] = frozenset()
    line: int = 0           # where the value was captured
    stale: bool = False     # an await interleaved since capture
    stale_line: int = 0     # the first such await


Env = Dict[str, VarState]


def _join_states(a: VarState, b: VarState) -> VarState:
    return VarState(
        sources=a.sources | b.sources,
        line=min(x for x in (a.line, b.line) if x) if (a.line or b.line)
        else 0,
        stale=a.stale or b.stale,
        stale_line=min(x for x in (a.stale_line, b.stale_line) if x)
        if (a.stale_line or b.stale_line) else 0,
    )


def join_env(a: Env, b: Env) -> Env:
    out = dict(a)
    for k, v in b.items():
        out[k] = _join_states(out[k], v) if k in out else v
    return out


def _iter_own(node: ast.AST) -> Iterator[ast.AST]:
    """Walk an expression/statement without entering nested scopes."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def _dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


def shared_chains(expr: ast.AST, env: Env) -> FrozenSet[str]:
    """Shared-state sources an expression's value may derive from:
    attribute chains rooted at ``self``/shared params, plus the sources
    of any alias local the expression reads."""
    out: Set[str] = set()
    for node in _iter_own(expr):
        if isinstance(node, ast.Attribute):
            d = _dotted(node)
            if not d:
                continue
            root = d.split(".", 1)[0]
            if root in env:
                out |= env[root].sources
            elif root in SHARED_PARAM_ROOTS:
                out.add(d)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id in env:
                out |= env[node.id].sources
            elif node.id in SHARED_PARAM_ROOTS and node.id != "self":
                # bare shared param used as a value (e.g. passed along)
                # does not taint by itself — only attribute reads do.
                pass
    return frozenset(out)


def load_names(expr: ast.AST) -> Set[str]:
    return {n.id for n in _iter_own(expr)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def value_used_names(expr: ast.AST) -> Set[str]:
    """Names whose *value* the expression consumes.

    Locals are task-private: the binding itself cannot change across an
    await, only data derived from shared state goes stale.  So two
    usage shapes are exempt:

    * the base of an attribute deref (``meta.needs_full`` reads shared
      state afresh at evaluation time — the local is just a route);
    * ``x is None`` / ``x is not None`` (tests the binding, which no
      interleaved task can touch).

    Everything else — truthiness, comparisons, arithmetic, call
    arguments, subscripting — consumes the possibly-stale value."""
    parent: Dict[int, ast.AST] = {}
    for node in _iter_own(expr):
        for ch in ast.iter_child_nodes(node):
            parent[id(ch)] = node
    out: Set[str] = set()
    for node in _iter_own(expr):
        if not (isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)):
            continue
        p = parent.get(id(node))
        if isinstance(p, ast.Attribute) and p.value is node:
            continue
        if isinstance(p, ast.Compare):
            comps = [p.left] + list(p.comparators)
            if all(isinstance(o, (ast.Is, ast.IsNot)) for o in p.ops) \
                    and any(isinstance(c, ast.Constant)
                            and c.value is None for c in comps):
                continue
        out.add(node.id)
    return out


class FunctionFlow:
    """Staleness dataflow for one (async) function.

    After construction, ``env_at[id(node)]`` holds the environment in
    force just before evaluating ``node``, for every top-level statement,
    every ``if``/``while`` test expression, and every ``for`` header —
    the positions the AWAIT-ATOMICITY rule interrogates."""

    def __init__(self, fn: ast.AST, pins: Optional[Dict[int, Set[str]]]
                 = None) -> None:
        self.fn = fn
        # pins are FUNCTION-scoped: a `# lint: pin[name]` anywhere in
        # the function body pins the name throughout.  Rebinding a
        # deliberately-owned local (a send cursor, an accumulated
        # progress value) happens at many sites; per-line pins would
        # just be the same declaration N times.
        self.pins: Set[str] = set()
        if pins:
            lo = getattr(fn, "lineno", 0)
            hi = getattr(fn, "end_lineno", None) or lo
            for ln, names in pins.items():
                if lo <= ln <= hi:
                    self.pins |= names
        self.cfg = build_cfg(fn)
        self.env_at: Dict[int, Env] = {}
        self._record = False
        self._solve()

    # -- pinning ---------------------------------------------------------

    def _pinned(self, name: str, line: int) -> bool:
        return "*" in self.pins or name in self.pins

    # -- transfer --------------------------------------------------------

    def _stale_all(self, env: Env, line: int) -> Env:
        out: Env = {}
        for k, v in env.items():
            if v.sources and not v.stale:
                out[k] = replace(v, stale=True, stale_line=line)
            else:
                out[k] = v
        return out

    def _apply_awaits(self, node: ast.AST, env: Env) -> Env:
        hits = awaits_in(node)
        if hits:
            env = self._stale_all(env, min(a.lineno for a in hits))
        return env

    def _bind(self, env: Env, target: ast.AST, srcs: FrozenSet[str],
              line: int) -> Env:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                env = self._bind(env, el, srcs, line)
            return env
        if isinstance(target, ast.Starred):
            return self._bind(env, target.value, srcs, line)
        if not isinstance(target, ast.Name):
            return env  # attribute/subscript targets are mutations,
            #             not local bindings — the rules look at those.
        env = dict(env)
        if srcs and not self._pinned(target.id, line):
            env[target.id] = VarState(sources=srcs, line=line)
        else:
            env[target.id] = VarState()  # explicit kill / pinned
        return env

    def _transfer_stmt(self, stmt: ast.stmt, env: Env) -> Env:
        if is_header(stmt):
            node = stmt.node
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if self._record:
                    self.env_at[id(node)] = dict(env)
                srcs = shared_chains(node.iter, env)
                env = self._apply_awaits(node.iter, env)
                if isinstance(node, ast.AsyncFor):
                    env = self._stale_all(env, node.lineno)
                return self._bind(env, node.target, srcs, node.lineno)
            if isinstance(node, (ast.With, ast.AsyncWith)):
                if self._record:
                    self.env_at[id(node)] = dict(env)
                for item in node.items:
                    srcs = shared_chains(item.context_expr, env)
                    env = self._apply_awaits(item.context_expr, env)
                    if isinstance(node, ast.AsyncWith):
                        env = self._stale_all(env, node.lineno)
                    if item.optional_vars is not None:
                        env = self._bind(env, item.optional_vars, srcs,
                                         node.lineno)
                return env
            if isinstance(node, ast.ExceptHandler):
                if node.name:
                    env = self._bind(env, ast.Name(id=node.name,
                                                   ctx=ast.Store()),
                                     frozenset(), node.lineno)
                return env
            return env

        if self._record:
            self.env_at[id(stmt)] = dict(env)
        if isinstance(stmt, ast.Assign):
            srcs = shared_chains(stmt.value, env)
            env = self._apply_awaits(stmt, env)
            for t in stmt.targets:
                env = self._bind(env, t, srcs, stmt.lineno)
            return env
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            srcs = shared_chains(stmt.value, env)
            env = self._apply_awaits(stmt, env)
            return self._bind(env, stmt.target, srcs, stmt.lineno)
        if isinstance(stmt, ast.AugAssign):
            # x += ... keeps x's provenance; sources may widen.
            env2 = self._apply_awaits(stmt, env)
            if isinstance(stmt.target, ast.Name):
                extra = shared_chains(stmt.value, env)
                cur = env2.get(stmt.target.id)
                if cur is not None and (cur.sources or extra):
                    env2 = dict(env2)
                    env2[stmt.target.id] = replace(
                        cur, sources=cur.sources | extra)
                elif extra:
                    env2 = dict(env2)
                    env2[stmt.target.id] = VarState(sources=extra,
                                                    line=stmt.lineno)
            return env2
        return self._apply_awaits(stmt, env)

    def _transfer_block(self, blk: Block, env: Env) -> Env:
        for stmt in blk.stmts:
            env = self._transfer_stmt(stmt, env)
        if blk.test is not None:
            if self._record:
                self.env_at[id(blk.test)] = dict(env)
            env = self._apply_awaits(blk.test, env)
        return env

    # -- fixpoint --------------------------------------------------------

    def _solve(self) -> None:
        order = self.cfg.rpo()
        in_env: Dict[int, Env] = {self.cfg.entry.bid: {}}
        changed = True
        rounds = 0
        while changed and rounds < 64:
            changed = False
            rounds += 1
            for blk in order:
                if blk.bid not in in_env:
                    continue
                out = self._transfer_block(blk, in_env[blk.bid])
                for succ in blk.succs:
                    merged = join_env(in_env.get(succ, {}), out) \
                        if succ in in_env else out
                    if merged != in_env.get(succ):
                        in_env[succ] = merged
                        changed = True
        # recording pass at the fixpoint
        self._record = True
        for blk in order:
            if blk.bid in in_env:
                self._transfer_block(blk, in_env[blk.bid])
        self._record = False


# ------------------------------------------------------------- cut ordering

# A "capture" pins the consistency cut: reading the replication
# watermark or the replica record table into a local.
CAPTURE_ATTRS = {"last_uuid", "landed_last_uuid"}
CAPTURE_CALLS = {"records"}

# An "export" derives state that must be consistent WITH that cut; when
# awaited, other tasks can advance the watermark mid-derivation, so the
# capture must already be in hand.
EXPORT_CALLS = {
    "export_batches", "export_batch", "state_digest", "_local_digest",
    "local_digest", "key_count", "export_frames", "collect_digest",
}


def is_capture_stmt(stmt: ast.AST) -> bool:
    if not isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
        return False
    value = getattr(stmt, "value", None)
    if value is None:
        return False
    for node in _iter_own(value):
        if isinstance(node, ast.Attribute) and node.attr in CAPTURE_ATTRS:
            return True
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name and name.rsplit(".", 1)[-1] in CAPTURE_CALLS:
                return True
    return False


def export_awaits(node: ast.AST) -> List[Tuple[ast.Await, str]]:
    out: List[Tuple[ast.Await, str]] = []
    for aw in awaits_in(node):
        v = aw.value
        if isinstance(v, ast.Call):
            name = _dotted(v.func)
            term = name.rsplit(".", 1)[-1] if name else \
                getattr(v.func, "attr", "")
            if term in EXPORT_CALLS:
                out.append((aw, term))
    return out


def cut_violations(fn: ast.AST) -> List[Tuple[ast.Await, str]]:
    """Export-awaits reachable on SOME path with no prior watermark /
    record capture.  Empty when the function has no capture at all (it
    is not building a cut) or no awaited export."""
    own = list(_iter_own_body(fn))
    has_capture = any(is_capture_stmt(s) for s in own)
    has_export = any(export_awaits(s)
                     for s in own if not isinstance(s, ast.Await))
    if not has_capture or not has_export:
        return []

    cfg = build_cfg(fn)
    order = cfg.rpo()
    # must-analysis: True = "capture happened on every path here"
    in_f: Dict[int, bool] = {b.bid: True for b in order}
    in_f[cfg.entry.bid] = False
    reachable = {cfg.entry.bid}

    def block_nodes(blk: Block) -> List[ast.AST]:
        nodes: List[ast.AST] = []
        for stmt in blk.stmts:
            nodes.append(stmt.node if is_header(stmt) else stmt)
        if blk.test is not None:
            nodes.append(blk.test)
        return nodes

    changed = True
    rounds = 0
    while changed and rounds < 64:
        changed = False
        rounds += 1
        for blk in order:
            if blk.bid not in reachable:
                continue
            fact = in_f[blk.bid]
            for node in block_nodes(blk):
                if is_capture_stmt(node):
                    fact = True
            for succ in blk.succs:
                if succ not in reachable:
                    reachable.add(succ)
                    changed = True
                if in_f[succ] and not fact:
                    in_f[succ] = False
                    changed = True

    violations: List[Tuple[ast.Await, str]] = []
    seen: Set[int] = set()
    for blk in order:
        if blk.bid not in reachable:
            continue
        fact = in_f[blk.bid]
        for node in block_nodes(blk):
            capture = is_capture_stmt(node)
            if not fact and not capture:
                for aw, term in export_awaits(node):
                    if id(aw) not in seen:
                        seen.add(id(aw))
                        violations.append((aw, term))
            if capture:
                fact = True
    violations.sort(key=lambda v: v[0].lineno)
    return violations


def _iter_own_body(fn: ast.AST) -> Iterator[ast.AST]:
    stack = list(getattr(fn, "body", []))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


# -------------------------------------------------------- mutation shapes

# Method names whose call on a shared chain mutates it.  Kept to
# unambiguous container/state mutators: the AWAIT-ATOMICITY rule only
# consults this inside a suite guarded by a stale read, so precision
# here directly bounds the false-positive rate.
MUTATOR_METHODS = {
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "popleft", "remove", "discard", "clear",
    "put_nowait", "push", "set_result", "set_exception",
}


def shared_mutations(stmts: List[ast.stmt], env: Env
                     ) -> List[Tuple[ast.AST, str]]:
    """Mutations of shared state inside a suite: assignments /
    deletions whose target chain is shared-rooted, and mutator-method
    calls on shared chains."""
    out: List[Tuple[ast.AST, str]] = []

    def chain_of(t: ast.AST) -> str:
        while isinstance(t, ast.Subscript):
            t = t.value
        d = _dotted(t)
        if not d or "." not in d:
            return ""
        root = d.split(".", 1)[0]
        if root in SHARED_PARAM_ROOTS:
            return d
        st = env.get(root)
        if st is not None and st.sources:
            return d
        return ""

    for stmt in stmts:
        for node in _iter_own(stmt):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    got = chain_of(t)
                    if got:
                        out.append((node, got))
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    got = chain_of(t)
                    if got:
                        out.append((node, got))
            elif isinstance(node, ast.Call):
                name = _dotted(node.func)
                if name and "." in name:
                    base, _, meth = name.rpartition(".")
                    if meth in MUTATOR_METHODS and chain_of(node.func):
                        out.append((node, name))
    return out
