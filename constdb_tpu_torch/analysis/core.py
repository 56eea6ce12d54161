"""Invariant lint engine: AST rule framework + baseline machinery.

Every major defect the reviews of the store surfaced was a *discipline*
violation, not a logic error — `_pool_add` mutated pool state before its
ceiling check, a blocking call stalled the asyncio loop, a stray env read
bypassed `conf.py`.  Those disciplines lived only in comments and
postmortems; this package checks them mechanically, before runtime (the
"convergence checked before runtime" stance of Certified MRDTs,
arxiv 2203.14518 — see PAPERS.md).

Moving parts:
  * `Finding` — one violation: rule, severity, file:line, the enclosing
    function's qualname, a stable `token`, a message and a fix hint.
    `key` (rule:path:qualname:token — NO line number) is the identity
    baselining uses, so pre-existing findings survive unrelated edits.
  * `Rule` — subclass per invariant (see rules.py).  `applies(ctx)`
    scopes by path parts (e.g. ASYNC-BLOCK only looks under `server/` +
    `replica/`), which is also how the seeded-violation corpus under
    tests/torch_analysis_corpus/ mirrors the package layout.
  * `FileContext` — parsed source shared by every rule: the AST, an
    indexed function list (qualnames + async ancestry), per-line
    `# lint: ignore[RULE]` sets, and helpers (`own_nodes`, `dotted`).
  * Baseline — `baseline.json` records pre-existing finding keys with
    counts and per-key notes; `--baseline` mode fails only on GROWTH
    (a new key, or more findings than the recorded count for a key).

Escape hatch: append `# lint: ignore[RULE-NAME]` (comma-separate for
several rules, `*` for all) on the offending line.  Use it for findings
that are correct-by-design AND documented on the spot — everything else
belongs in the baseline with a tracking note, or fixed.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

SEVERITIES = ("note", "warning", "error")

_IGNORE_RE = re.compile(r"#\s*lint:\s*ignore\[([A-Za-z0-9_*,\- ]+)\]")


@dataclass
class Finding:
    rule: str
    severity: str
    path: str           # posix relpath from the scan root
    line: int
    qualname: str       # enclosing function/class dotted name ("" = module)
    token: str          # stable signature element (offending call/attr name)
    message: str
    hint: str = ""

    @property
    def key(self) -> str:
        """Line-number-free identity: survives unrelated edits above the
        finding.  Multiple same-token findings in one function are
        handled by COUNT in the baseline, not by distinct keys."""
        return f"{self.rule}:{self.path}:{self.qualname}:{self.token}"

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        who = f" in {self.qualname}" if self.qualname else ""
        out = f"{where}: [{self.severity}] {self.rule}{who}: {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


class FileContext:
    """One parsed source file, shared by every rule."""

    def __init__(self, relpath: str, source: str, tree: ast.AST):
        self.relpath = relpath
        self.parts = tuple(relpath.split("/"))
        self.basename = self.parts[-1]
        self.source = source
        self.tree = tree
        # line -> set of rule names ignored there ("*" = all)
        self.ignores: dict[int, set[str]] = {}
        for i, line in enumerate(source.splitlines(), 1):
            m = _IGNORE_RE.search(line)
            if m:
                self.ignores[i] = {s.strip()
                                   for s in m.group(1).split(",") if s.strip()}
        # (qualname, node, is_async, async_ancestor)
        self.functions: list[tuple[str, ast.AST, bool, bool]] = []
        self._index(tree, "", False)

    def _index(self, node: ast.AST, prefix: str, async_ctx: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}.{child.name}" if prefix else child.name
                is_async = isinstance(child, ast.AsyncFunctionDef)
                self.functions.append((q, child, is_async, async_ctx))
                self._index(child, q, async_ctx or is_async)
            elif isinstance(child, ast.ClassDef):
                q = f"{prefix}.{child.name}" if prefix else child.name
                self._index(child, q, async_ctx)
            else:
                self._index(child, prefix, async_ctx)

    def ignored(self, rule: str, line: int) -> bool:
        """The escape hatch matches on the finding's line or the line
        immediately above it (a trailing comment on multi-line
        statements would fight the line-length limit)."""
        for ln in (line, line - 1):
            got = self.ignores.get(ln)
            if got and ("*" in got or rule in got):
                return True
        return False


def own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Every node in `fn`'s body EXCLUDING nested function/class bodies
    (nested defs are yielded themselves — so a rule can see that a
    closure exists — but never descended into; they get their own
    FileContext.functions entry)."""
    stack = list(getattr(fn, "body", []))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def dotted(node: ast.AST) -> str:
    """Best-effort dotted name for a call target / attribute chain
    ('time.sleep', 'self._pool_add', 'os.environ.get'); '' when the base
    is an expression (then match on the terminal attr instead)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


class Rule:
    """One invariant.  Subclasses set `name`/`severity`/`hint`/`doc` and
    implement `check(ctx)` (a generator of Findings — emit via
    `self.finding(...)` so ignore comments are honored uniformly)."""

    name = ""
    severity = "error"
    hint = ""
    doc = ""

    def applies(self, ctx: FileContext) -> bool:
        return True

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def finding(self, ctx: FileContext, node: ast.AST, qualname: str,
                token: str, message: str) -> Optional[Finding]:
        line = getattr(node, "lineno", 1)
        if ctx.ignored(self.name, line):
            return None
        return Finding(self.name, self.severity, ctx.relpath, line,
                       qualname, token, message, self.hint)


# ------------------------------------------------------------------ engine

def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith(".")
                                     and d != "__pycache__")
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        yield os.path.join(dirpath, f)
        elif p.endswith(".py"):
            yield p


def analyze_paths(paths: Iterable[str], root: str,
                  rules: Optional[list[Rule]] = None) -> list[Finding]:
    """Run `rules` (default: rules.ALL_RULES) over every .py file under
    `paths`; relpaths (rule scoping + finding identity) are taken from
    `root`, so the corpus can mirror the package layout under any dir."""
    if rules is None:
        from .rules import ALL_RULES
        rules = ALL_RULES
    findings: list[Finding] = []
    for path in iter_py_files(paths):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            findings.append(Finding(
                "PARSE-ERROR", "error", rel, e.lineno or 1, "", "syntax",
                f"file does not parse: {e.msg}"))
            continue
        ctx = FileContext(rel, source, tree)
        for rule in rules:
            if rule.applies(ctx):
                findings.extend(f for f in rule.check(ctx) if f is not None)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# ---------------------------------------------------------------- baseline

def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: Optional[str] = None) -> dict:
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return {"version": 1, "findings": {}, "notes": {}}
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def baseline_payload(findings: list[Finding], notes: dict) -> dict:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.key] = counts.get(f.key, 0) + 1
    return {"version": 1,
            "findings": dict(sorted(counts.items())),
            "notes": dict(sorted(notes.items()))}


def compare_to_baseline(findings: list[Finding], baseline: dict
                        ) -> tuple[list[Finding], list[str]]:
    """-> (growth, stale): `growth` is every finding beyond its key's
    baselined count (fails the gate); `stale` lists baseline keys whose
    live count DROPPED (fixed findings — prune them with
    --write-baseline; informational only)."""
    allowed = dict(baseline.get("findings", {}))
    by_key: dict[str, list[Finding]] = {}
    for f in findings:
        by_key.setdefault(f.key, []).append(f)
    growth: list[Finding] = []
    for key, fs in by_key.items():
        fs.sort(key=lambda f: f.line)
        growth.extend(fs[allowed.get(key, 0):])
    growth.sort(key=lambda f: (f.path, f.line, f.rule))
    stale = sorted(k for k, n in allowed.items()
                   if len(by_key.get(k, ())) < n)
    return growth, stale
