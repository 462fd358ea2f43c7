"""AST node definitions — the paper's intermediate representation (§3.4).

Every node carries the source line for diagnostics; the tree mirrors the
constructs in the paper's Fig. 5 (Dynamic SSSP AST): function roots,
declarations, assignments, if/while/do-while, forall (with optional
filter), fixedPoint, Batch, OnAdd/OnDelete, and the ``<a,b,c> = <...>``
atomic multi-assignment that carries the Min/Max constructs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Node:
    line: int = dataclasses.field(default=0, kw_only=True)


# --- types -----------------------------------------------------------------

@dataclasses.dataclass
class Type(Node):
    name: str                      # 'int' | 'bool' | ... | 'propNode' | ...
    arg: Optional[str] = None      # element type or graph name

    def __str__(self):
        return f"{self.name}<{self.arg}>" if self.arg else self.name

    @property
    def is_prop(self) -> bool:
        return self.name in ("propNode", "propEdge")


# --- expressions -------------------------------------------------------------

@dataclasses.dataclass
class Expr(Node):
    pass


@dataclasses.dataclass
class Num(Expr):
    value: float
    is_float: bool = False


@dataclasses.dataclass
class Bool(Expr):
    value: bool


@dataclasses.dataclass
class Inf(Expr):
    pass


@dataclasses.dataclass
class Name(Expr):
    ident: str


@dataclasses.dataclass
class Attr(Expr):
    obj: Expr
    name: str                      # v.dist, e.weight, u.source


@dataclasses.dataclass
class Call(Expr):
    func: Expr                     # Name or Attr (method call)
    args: List[Expr]


@dataclasses.dataclass
class Unary(Expr):
    op: str                        # '!' | '-'
    operand: Expr


@dataclasses.dataclass
class Binary(Expr):
    op: str
    left: Expr
    right: Expr


@dataclasses.dataclass
class MinMax(Expr):
    """Min(a, b) / Max(a, b) — the paper's atomic compare-assign carrier."""
    op: str                        # 'Min' | 'Max'
    args: List[Expr]


@dataclasses.dataclass
class Kwarg(Expr):
    """name = value inside a call: g.attachNodeProperty(dist=INF, ...)."""
    name: str
    value: Expr


# --- statements ---------------------------------------------------------------

@dataclasses.dataclass
class Stmt(Node):
    pass


@dataclasses.dataclass
class Block(Stmt):
    stmts: List[Stmt]


@dataclasses.dataclass
class Decl(Stmt):
    type: Type
    name: str
    init: Optional[Expr]


@dataclasses.dataclass
class Assign(Stmt):
    target: Expr                   # Name or Attr
    op: str                        # '=' | '+=' | '-='
    value: Expr


@dataclasses.dataclass
class MultiAssign(Stmt):
    """<t1, t2, ...> = <e1, e2, ...>;  (atomic; e1 may be Min/Max)."""
    targets: List[Expr]
    values: List[Expr]


@dataclasses.dataclass
class If(Stmt):
    cond: Expr
    then: Block
    orelse: Optional[Block]


@dataclasses.dataclass
class While(Stmt):
    cond: Expr
    body: Block


@dataclasses.dataclass
class DoWhile(Stmt):
    body: Block
    cond: Expr


@dataclasses.dataclass
class ForAll(Stmt):
    """forall/for (var in iter[.filter(cond)]) { body }

    parallel=True for ``forall``; ``for`` is a sequential neighbor
    iteration in the paper (we keep the distinction for the analysis,
    both vectorize identically on TPU).
    """
    var: str
    iter: Expr                     # g.nodes() / g.neighbors(v) / batch expr
    filter: Optional[Expr]
    body: Block
    parallel: bool


@dataclasses.dataclass
class FixedPoint(Stmt):
    """fixedPoint until (flagvar : convergence-expr) { body }"""
    flag: str
    cond: Expr
    body: Block


@dataclasses.dataclass
class BatchStmt(Stmt):
    """Batch(updates : batchSize) { body }"""
    updates: str
    batch_size: str
    body: Block


@dataclasses.dataclass
class OnUpdate(Stmt):
    """OnAdd/OnDelete (e in updates.currentBatch()) { body }"""
    kind: str                      # 'add' | 'delete'
    var: str
    source: Expr
    body: Block


@dataclasses.dataclass
class CallStmt(Stmt):
    call: Call


@dataclasses.dataclass
class Return(Stmt):
    value: Expr


# --- functions ------------------------------------------------------------------

@dataclasses.dataclass
class Param(Node):
    type: Type
    name: str


@dataclasses.dataclass
class FuncDef(Node):
    kind: str                      # 'Static' | 'Dynamic' | 'Incremental' | ...
    name: str                      # Incremental/Decremental may be anonymous
    params: List[Param]
    body: Block


@dataclasses.dataclass
class ProgramAST(Node):
    funcs: List[FuncDef]

    def func(self, name: str) -> FuncDef:
        for f in self.funcs:
            if f.name == name:
                return f
        raise KeyError(name)


def walk(node):
    """Yield every AST node under ``node`` (pre-order)."""
    yield node
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, Node):
            yield from walk(v)
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, Node):
                    yield from walk(item)
