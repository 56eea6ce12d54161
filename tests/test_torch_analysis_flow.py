"""The flow-sensitive half of the port's lint (analysis/cfg.py +
analysis/flow.py), twin of tests/test_analysis_flow.py: each test builds
the CFG or the dataflow facts of the same source with both packages and
compares them, then checks the port's result as the reference test
checks the reference's."""

import ast
import dataclasses
import textwrap

from constdb_tpu.analysis import flow as ref_flow
from constdb_tpu.analysis.cfg import awaits_in as ref_awaits_in
from constdb_tpu.analysis.cfg import build_cfg as ref_build_cfg
from constdb_tpu_torch.analysis import flow
from constdb_tpu_torch.analysis.cfg import awaits_in, build_cfg


def _fn(src: str) -> ast.AST:
    tree = ast.parse(textwrap.dedent(src))
    for node in ast.walk(tree):
        if isinstance(node, (ast.AsyncFunctionDef, ast.FunctionDef)):
            return node
    raise AssertionError("no function in snippet")


def _cfg_shape(cfg):
    """Block by block in reverse post-order: id, statement lines, test
    line, successors; plus the entry and exit ids."""
    return ([(b.bid, [s.lineno for s in b.stmts],
              getattr(b.test, "lineno", None), list(b.succs))
             for b in cfg.rpo()], cfg.entry.bid, cfg.exit.bid)


def _env_facts(fa):
    """FunctionFlow facts keyed by the (shared) AST node id."""
    return {k: {name: dataclasses.astuple(st) for name, st in env.items()}
            for k, env in fa.env_at.items()}


def _flows(src: str, pins=None):
    """(port flow, reference flow) over ONE parsed function, after
    checking their facts are equal."""
    fn = _fn(src)
    fa = flow.FunctionFlow(fn, pins)
    fr = ref_flow.FunctionFlow(fn, pins)
    assert _env_facts(fa) == _env_facts(fr)
    return fa, fr


def _cuts(fn, mod):
    return [(aw.lineno, term) for aw, term in mod.cut_violations(fn)]


def _same_cuts(fn):
    got = _cuts(fn, flow)
    assert got == _cuts(fn, ref_flow)
    return [term for _line, term in got]


# ------------------------------------------------------------------ cfg

def test_cfg_straight_line_and_branches():
    fn = _fn("""
    async def f(self, x):
        a = 1
        if x:
            b = 2
        else:
            b = 3
        while b:
            b -= 1
        return b
    """)
    cfg = build_cfg(fn)
    assert _cfg_shape(cfg) == _cfg_shape(ref_build_cfg(fn))
    order = cfg.rpo()
    assert order[0] is cfg.entry
    reach = {cfg.exit.bid}
    for blk in reversed(order):
        if any(s in reach for s in blk.succs):
            reach.add(blk.bid)
    assert cfg.entry.bid in reach


def test_cfg_await_points_found():
    fn = _fn("""
    async def f(self):
        await self.a()
        async with self.lk:
            pass
        async for x in self.it:
            await self.b(x)
    """)
    got = [(a.lineno, a.col_offset) for a in awaits_in(fn)]
    assert got == [(a.lineno, a.col_offset) for a in ref_awaits_in(fn)]
    assert len(got) == 2


def test_cfg_nested_defs_opaque():
    fn = _fn("""
    async def f(self):
        def g():
            return self._links
        await self.h(g)
    """)
    assert len(awaits_in(fn)) == len(ref_awaits_in(fn)) == 1
    assert _cfg_shape(build_cfg(fn)) == _cfg_shape(ref_build_cfg(fn))


# ----------------------------------------------------------- staleness

def test_snapshot_goes_stale_across_await():
    fa, _ = _flows("""
    async def f(self):
        links = list(self._links)
        await self.close()
        if links:
            self._links.clear()
    """)
    test_envs = [env for env in fa.env_at.values() if "links" in env]
    assert test_envs, "snapshot local never tracked"
    final = max(test_envs, key=lambda e: e["links"].stale)
    st = final["links"]
    assert st.sources == frozenset({"self._links"})
    assert st.stale and st.stale_line > st.line


def test_rebind_after_await_clears_staleness():
    fa, _ = _flows("""
    async def f(self):
        links = list(self._links)
        await self.close()
        links = list(self._links)
        if links:
            self._links.clear()
    """)
    guard = [n for n in ast.walk(fa.fn) if isinstance(n, ast.If)][0]
    assert not fa.env_at[id(guard.test)]["links"].stale


def test_pin_is_function_scoped():
    src = """
    async def f(self):
        doomed = list(self._links)  # lint: pin[doomed]
        await self.close()
        doomed = list(self._links)
        if doomed:
            self._links.clear()
    """
    pins = flow.pins_by_line(textwrap.dedent(src))
    assert pins == ref_flow.pins_by_line(textwrap.dedent(src))
    fa, _ = _flows(src, pins)
    assert all("doomed" not in env or not env["doomed"].sources
               for env in fa.env_at.values())


def test_loop_back_edge_joins_staleness():
    fa, _ = _flows("""
    async def f(self):
        snap = dict(self._warm)
        while True:
            if snap:
                self._warm.clear()
            await self.tick()
    """)
    guard = [n for n in ast.walk(fa.fn) if isinstance(n, ast.If)][0]
    assert fa.env_at[id(guard.test)]["snap"].stale


def test_value_used_names_exemptions():
    expr = ast.parse("meta.needs_full or coal is None or cursor > 0",
                     mode="eval").body
    names = flow.value_used_names(expr)
    assert names == ref_flow.value_used_names(expr) == {"cursor"}


# -------------------------------------------------------- cut ordering

def test_cut_violation_and_fix():
    bad = _fn("""
    async def f(self):
        d = await self._local_digest(self.node)
        last = self.node.repl_log.last_uuid
        return d, last
    """)
    assert _same_cuts(bad) == ["_local_digest"]
    fixed = _fn("""
    async def f(self):
        last = self.node.repl_log.last_uuid
        d = await self._local_digest(self.node)
        return d, last
    """)
    assert _same_cuts(fixed) == []


def test_cut_requires_both_halves():
    no_capture = _fn("""
    async def f(self):
        return await self.node.serve_plane.key_count()
    """)
    assert _same_cuts(no_capture) == []
    no_export = _fn("""
    async def f(self):
        last = self.node.repl_log.last_uuid
        await self.flush()
        return last
    """)
    assert _same_cuts(no_export) == []


def test_cut_some_path_semantics():
    branchy = _fn("""
    async def f(self):
        if self.app.fast:
            last = self.node.repl_log.last_uuid
        return await self.node.serve_plane.key_count()
    """)
    assert _same_cuts(branchy) == ["key_count"]
    dominated = _fn("""
    async def f(self):
        last = self.node.repl_log.last_uuid
        if self.app.fast:
            return await self.node.serve_plane.key_count()
        return last
    """)
    assert _same_cuts(dominated) == []
