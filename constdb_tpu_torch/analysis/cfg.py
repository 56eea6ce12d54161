"""Control-flow graphs over (async) function bodies.

The per-node rules in :mod:`constdb_tpu_torch.analysis.rules` see one statement at
a time, which is exactly the granularity where every shipped race hid: the
replica link's close window, the consistency cut and the quiesce callback
were all "read before an ``await``, trusted after it".  To reason about that
we need path information — which statements can execute between a read and
its use, and whether an await point sits on that path.

This module builds a deliberately small CFG:

* one :class:`Block` is a maximal run of statements with no internal branch;
* edges follow Python's structured control flow (``if``/``while``/``for``/
  ``try``/``with``/``match``, plus ``break``/``continue``/``return``/``raise``);
* nested ``def``/``class`` bodies are opaque — the analysis is
  intraprocedural, matching the engine's per-function reporting unit;
* await *partitioning* happens downstream: blocks carry raw statements and
  :func:`awaits_in` tells the dataflow engine where the interleaving points
  are inside each statement.

``try`` is approximated conservatively: every handler is reachable from the
start of the protected body *and* after each of its statements, so facts
that may be torn mid-body survive into the handler.  That over-approximates
reachability, which is the safe direction for a may-staleness analysis.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def awaits_in(node: ast.AST) -> List[ast.Await]:
    """Await expressions syntactically inside ``node``, own scope only
    (nested def/lambda/class bodies are opaque).  Passing a function
    node searches that function's own body."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node)) \
        if isinstance(node, _SCOPES) else [node]
    hits: List[ast.Await] = []
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Await):
            hits.append(n)
        if isinstance(n, _SCOPES):
            continue
        stack.extend(ast.iter_child_nodes(n))
    hits.sort(key=lambda a: (a.lineno, a.col_offset))
    return hits


def has_await(node: ast.AST) -> bool:
    return bool(awaits_in(node))


@dataclass
class Block:
    """A straight-line run of statements.

    ``stmts`` holds the statements executed when control passes through the
    block.  Branch tests (``if``/``while`` conditions, ``for`` iterables)
    are recorded as ``test`` so the dataflow engine can evaluate their
    reads exactly once per traversal of the block.
    """

    bid: int
    stmts: List[ast.stmt] = field(default_factory=list)
    test: Optional[ast.expr] = None
    succs: List[int] = field(default_factory=list)

    def link(self, other: "Block") -> None:
        if other.bid not in self.succs:
            self.succs.append(other.bid)


class CFG:
    def __init__(self, fn: ast.AST) -> None:
        self.fn = fn
        self.blocks: Dict[int, Block] = {}
        self.entry = self._new()
        self.exit = self._new()

    def _new(self) -> Block:
        blk = Block(bid=len(self.blocks))
        self.blocks[blk.bid] = blk
        return blk

    def succ(self, blk: Block) -> Iterator[Block]:
        for bid in blk.succs:
            yield self.blocks[bid]

    def rpo(self) -> List[Block]:
        """Reverse post-order from entry — a good worklist seed order."""
        seen: set[int] = set()
        order: List[Block] = []

        stack: List[Tuple[Block, Iterator[Block]]] = [
            (self.entry, self.succ(self.entry))
        ]
        seen.add(self.entry.bid)
        while stack:
            blk, it = stack[-1]
            advanced = False
            for nxt in it:
                if nxt.bid not in seen:
                    seen.add(nxt.bid)
                    stack.append((nxt, self.succ(nxt)))
                    advanced = True
                    break
            if not advanced:
                order.append(blk)
                stack.pop()
        order.reverse()
        return order


class _Builder:
    """Structured-statement walk that threads a "current block" cursor."""

    def __init__(self, cfg: CFG) -> None:
        self.cfg = cfg
        # (continue_target, break_target) stack for loops
        self.loops: List[Tuple[Block, Block]] = []

    def build(self, body: List[ast.stmt]) -> None:
        cur = self._seq(body, self.cfg.entry)
        if cur is not None:
            cur.link(self.cfg.exit)

    # -- helpers ---------------------------------------------------------

    def _seq(self, body: List[ast.stmt], cur: Optional[Block]) -> Optional[Block]:
        for stmt in body:
            if cur is None:
                # dead code after return/raise/break — still build it so
                # the rules can look at it, but leave it unreachable.
                cur = self.cfg._new()
            cur = self._stmt(stmt, cur)
        return cur

    def _stmt(self, stmt: ast.stmt, cur: Block) -> Optional[Block]:
        if isinstance(stmt, (ast.If,)):
            return self._if(stmt, cur)
        if isinstance(stmt, (ast.While,)):
            return self._while(stmt, cur)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._for(stmt, cur)
        if isinstance(stmt, (ast.Try,)):
            return self._try(stmt, cur)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._with(stmt, cur)
        if isinstance(stmt, ast.Match):
            return self._match(stmt, cur)
        if isinstance(stmt, (ast.Return, ast.Raise)):
            cur.stmts.append(stmt)
            cur.link(self.cfg.exit)
            return None
        if isinstance(stmt, ast.Break):
            cur.stmts.append(stmt)
            if self.loops:
                cur.link(self.loops[-1][1])
            else:
                cur.link(self.cfg.exit)
            return None
        if isinstance(stmt, ast.Continue):
            cur.stmts.append(stmt)
            if self.loops:
                cur.link(self.loops[-1][0])
            else:
                cur.link(self.cfg.exit)
            return None
        # Plain statement (incl. nested def/class — opaque to the analysis).
        cur.stmts.append(stmt)
        return cur

    def _if(self, stmt: ast.If, cur: Block) -> Optional[Block]:
        head = self.cfg._new()
        cur.link(head)
        head.test = stmt.test
        join = self.cfg._new()

        then_entry = self.cfg._new()
        head.link(then_entry)
        then_end = self._seq(stmt.body, then_entry)
        if then_end is not None:
            then_end.link(join)

        if stmt.orelse:
            else_entry = self.cfg._new()
            head.link(else_entry)
            else_end = self._seq(stmt.orelse, else_entry)
            if else_end is not None:
                else_end.link(join)
        else:
            head.link(join)
        return join

    def _while(self, stmt: ast.While, cur: Block) -> Optional[Block]:
        head = self.cfg._new()
        cur.link(head)
        head.test = stmt.test
        after = self.cfg._new()

        body_entry = self.cfg._new()
        head.link(body_entry)
        self.loops.append((head, after))
        body_end = self._seq(stmt.body, body_entry)
        self.loops.pop()
        if body_end is not None:
            body_end.link(head)

        if stmt.orelse:
            else_entry = self.cfg._new()
            head.link(else_entry)
            else_end = self._seq(stmt.orelse, else_entry)
            if else_end is not None:
                else_end.link(after)
        else:
            head.link(after)
        return after

    def _for(self, stmt: ast.stmt, cur: Block) -> Optional[Block]:
        # The iterable is evaluated once; the header re-binds the target
        # each iteration.  Model the header as a test block carrying the
        # whole For node so the dataflow can see iter + target together.
        head = self.cfg._new()
        cur.link(head)
        head.stmts.append(stmt_header(stmt))
        after = self.cfg._new()

        body_entry = self.cfg._new()
        head.link(body_entry)
        self.loops.append((head, after))
        body_end = self._seq(stmt.body, body_entry)
        self.loops.pop()
        if body_end is not None:
            body_end.link(head)

        if stmt.orelse:
            else_entry = self.cfg._new()
            head.link(else_entry)
            else_end = self._seq(stmt.orelse, else_entry)
            if else_end is not None:
                else_end.link(after)
        else:
            head.link(after)
        return after

    def _try(self, stmt: ast.Try, cur: Block) -> Optional[Block]:
        join = self.cfg._new()

        body_entry = self.cfg._new()
        cur.link(body_entry)

        handler_entries: List[Block] = []
        for handler in stmt.handlers:
            h_entry = self.cfg._new()
            handler_entries.append(h_entry)
            # Entered from the start of the body (fact may tear anywhere).
            body_entry.link(h_entry)

        body_cur: Optional[Block] = body_entry
        for s in stmt.body:
            if body_cur is None:
                body_cur = self.cfg._new()
            body_cur = self._stmt(s, body_cur)
            if body_cur is not None:
                for h_entry in handler_entries:
                    body_cur.link(h_entry)

        else_end: Optional[Block] = body_cur
        if stmt.orelse:
            else_end = self._seq(stmt.orelse, body_cur)

        ends: List[Optional[Block]] = [else_end]
        for handler, h_entry in zip(stmt.handlers, handler_entries):
            if handler.type is not None:
                h_entry.stmts.append(stmt_header(handler))
            ends.append(self._seq(handler.body, h_entry))

        if stmt.finalbody:
            fin_entry = self.cfg._new()
            for end in ends:
                if end is not None:
                    end.link(fin_entry)
            fin_end = self._seq(stmt.finalbody, fin_entry)
            if fin_end is not None:
                fin_end.link(join)
            else:
                return None
        else:
            linked = False
            for end in ends:
                if end is not None:
                    end.link(join)
                    linked = True
            if not linked:
                return None
        return join

    def _with(self, stmt: ast.stmt, cur: Block) -> Optional[Block]:
        # Context-manager enter/exit is modelled as a header statement
        # (async with = an await point) followed by the body inline.
        cur.stmts.append(stmt_header(stmt))
        return self._seq(stmt.body, cur)

    def _match(self, stmt: ast.Match, cur: Block) -> Optional[Block]:
        head = self.cfg._new()
        cur.link(head)
        head.test = stmt.subject
        join = self.cfg._new()
        for case in stmt.cases:
            c_entry = self.cfg._new()
            head.link(c_entry)
            c_end = self._seq(case.body, c_entry)
            if c_end is not None:
                c_end.link(join)
        # No case may match.
        head.link(join)
        return join


class _Header(ast.stmt):
    """Synthetic statement wrapping a compound node's header.

    Lets the dataflow engine evaluate a ``for`` target/iter, ``with``
    items or ``except`` clause without re-walking the suite it guards
    (the suite's statements already live in their own blocks).
    """

    _fields = ("node",)

    def __init__(self, node: ast.AST) -> None:
        super().__init__()
        self.node = node
        self.lineno = getattr(node, "lineno", 0)
        self.col_offset = getattr(node, "col_offset", 0)


def stmt_header(node: ast.AST) -> _Header:
    return _Header(node)


def is_header(stmt: ast.stmt) -> bool:
    return isinstance(stmt, _Header)


def build_cfg(fn: ast.AST) -> CFG:
    """Build a CFG for a FunctionDef / AsyncFunctionDef body."""
    cfg = CFG(fn)
    _Builder(cfg).build(list(getattr(fn, "body", [])))
    return cfg
