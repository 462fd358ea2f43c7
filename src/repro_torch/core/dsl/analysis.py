"""Semantic analysis: symbol tables, read/write sets, race → combiner.

This mirrors the paper's §2/§4 program analyses:

  * symbol table per function (params, locals, attached properties) with
    type checking of prop element types;
  * read/write-set computation per ``forall`` — which vertex/edge
    properties each aggregate op touches.  The paper uses this to place
    cudaMemcpys and RMA windows; our backends use it to decide which
    property arrays the distributed engine all-gathers and which the
    Pallas engine keeps resident;
  * race detection inside parallel loops: a write to ``nbr.p`` (or to the
    outer vertex from a pull loop) from many edge lanes is a race.  The
    paper inserts atomics / `omp critical`; we *infer the combiner*
    (min / max / sum / or / argmin) from the write idiom and re-associate
    the update into a deterministic segment reduction — strictly stronger
    synchronization (DESIGN.md §2).

Idioms recognized as combiners (RaceInfo.kind):
  <x.p, x.f, x.q> = <Min(x.p, e), True, v>   →  min + or + argmin
  if (x.p > e) { x.p = e; x.q = v; }         →  min + argmin
  x.f = True / x.f = expr(bool)              →  or
  x.p += e / local += e                      →  sum
Anything else that races is a compile error — same contract as the
paper's "analysis fails → reject program".
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.dsl import ast_nodes as A

PRIM_ELEM = {"int": "int", "long": "int", "float": "float",
             "double": "float", "bool": "bool"}


class SemanticError(Exception):
    pass


@dataclasses.dataclass
class Symbol:
    name: str
    type: A.Type
    is_param: bool = False


@dataclasses.dataclass
class RaceInfo:
    """One racy write inside a forall, with its inferred combiner."""
    target: str                 # property name
    kind: str                   # min | max | sum | or | argmin
    line: int
    of: Optional[str] = None    # argmin: the property whose min it rides


@dataclasses.dataclass
class SweepInfo:
    """Read/write sets + races for one (possibly nested) forall."""
    line: int
    orientation: str            # 'push' (neighbors) | 'pull' (nodes_to) |
                                # 'vertex' | 'wedge' | 'batch'
    reads: Set[str] = dataclasses.field(default_factory=set)
    writes: Set[str] = dataclasses.field(default_factory=set)
    races: List[RaceInfo] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class FuncInfo:
    name: str
    kind: str
    symbols: Dict[str, Symbol]
    node_props: Dict[str, str]      # prop name -> elem type
    edge_props: Dict[str, str]
    sweeps: List[SweepInfo]
    returns: Optional[str] = None   # return expression's rough type


def _iter_kind(it: A.Expr) -> Tuple[str, Optional[str]]:
    """Classify a forall iterator expr: ('nodes'|'neighbors'|'nodes_to'|
    'batch', base-object-name)."""
    if isinstance(it, A.Call) and isinstance(it.func, A.Attr):
        m = it.func.name
        if m == "nodes":
            return "nodes", None
        if m == "neighbors":
            return "neighbors", _name_of(it.args[0]) if it.args else None
        if m == "nodes_to":
            return "nodes_to", _name_of(it.args[0]) if it.args else None
        if m == "currentBatch":
            return "batch", None
    if isinstance(it, A.Name):
        return "batch", it.ident       # updates<g>-typed local (addBatch)
    raise SemanticError(f"line {it.line}: unsupported forall iterator")


def _name_of(e: A.Expr) -> Optional[str]:
    return e.ident if isinstance(e, A.Name) else None


def _collect_props(func: A.FuncDef) -> Tuple[Dict[str, str], Dict[str, str]]:
    nprops, eprops = {}, {}
    for node in A.walk(func):
        if isinstance(node, (A.Decl, A.Param)) and node.type.is_prop:
            name = node.name
            elem = PRIM_ELEM.get(node.type.arg)
            if elem is None:
                raise SemanticError(
                    f"line {node.line}: bad prop element {node.type.arg}")
            if node.type.name == "propNode":
                nprops[name] = elem
            else:
                eprops[name] = elem
    return nprops, eprops


def _analyze_sweep(fa: A.ForAll, node_props: Dict[str, str],
                   outer_var: Optional[str] = None) -> SweepInfo:
    kind, base = _iter_kind(fa.iter)
    if kind == "nodes":
        orientation = "vertex"
    elif kind == "neighbors":
        orientation = "push"
    elif kind == "nodes_to":
        orientation = "pull"
    else:
        orientation = "batch"

    # nested neighbor loop upgrades a vertex sweep to an edge sweep; two
    # nested neighbor loops (or batch+neighbors) make a wedge sweep.
    inner = [s for s in fa.body.stmts if isinstance(s, A.ForAll)]
    if orientation in ("vertex", "batch") and inner:
        ik, _ = _iter_kind(inner[0].iter)
        if ik in ("neighbors", "nodes_to"):
            sub = [s for s in inner[0].body.stmts if isinstance(s, A.ForAll)]
            if sub or (orientation == "batch"):
                orientation = "wedge"
            else:
                orientation = "push" if ik == "neighbors" else "pull"

    info = SweepInfo(line=fa.line, orientation=orientation)
    loop_vars = {fa.var} | {s.var for s in inner}

    for node in A.walk(fa):
        if isinstance(node, A.Attr) and node.name in node_props:
            info.reads.add(node.name)
    for node in A.walk(fa):
        if isinstance(node, A.Assign) and isinstance(node.target, A.Attr):
            tname = node.target.name
            if tname in node_props:
                info.writes.add(tname)
        if isinstance(node, A.MultiAssign):
            for tgt, val in zip(node.targets, node.values):
                if isinstance(tgt, A.Attr) and tgt.name in node_props:
                    info.writes.add(tgt.name)
                    if isinstance(val, A.MinMax):
                        info.races.append(RaceInfo(
                            target=tgt.name,
                            kind="min" if val.op == "Min" else "max",
                            line=node.line))
                    elif isinstance(val, A.Bool):
                        info.races.append(RaceInfo(
                            target=tgt.name, kind="or", line=node.line))
                    elif isinstance(val, A.Name) and val.ident in loop_vars:
                        info.races.append(RaceInfo(
                            target=tgt.name, kind="argmin", line=node.line))
    return info


# Attributes the runtime provides without a declaration: edge weight and
# the endpoints of an update-batch entry.
_BUILTIN_ATTRS = {"weight", "source", "destination"}


def _validate_names(func: A.FuncDef, symbols: Dict[str, Symbol],
                    nprops: Dict[str, str], eprops: Dict[str, str],
                    func_names: Set[str]) -> None:
    """Reject undeclared properties and undeclared-variable reads.

    The paper's contract: analysis failure rejects the program.  Two
    checks: (1) every ``x.p`` attribute access names a declared
    propNode/propEdge (or a builtin like ``e.weight``/``u.source``);
    (2) every bare identifier read is a declared symbol, a loop
    variable, a property (the ``filter(modified == True)`` shorthand),
    or a function name.
    """
    loop_vars = {n.var for n in A.walk(func)
                 if isinstance(n, (A.ForAll, A.OnUpdate))}
    flag_vars = {n.flag for n in A.walk(func) if isinstance(n, A.FixedPoint)}
    known = (set(symbols) | loop_vars | flag_vars | set(nprops)
             | set(eprops) | func_names | {"abs"})
    call_funcs = {id(n.func) for n in A.walk(func) if isinstance(n, A.Call)}
    for node in A.walk(func):
        if isinstance(node, A.Attr) and id(node) not in call_funcs:
            if node.name not in nprops and node.name not in eprops \
                    and node.name not in _BUILTIN_ATTRS:
                raise SemanticError(
                    f"line {node.line}: undeclared property "
                    f"'{node.name}' (declare a propNode/propEdge)")
        if isinstance(node, A.Name) and node.ident not in known:
            raise SemanticError(
                f"line {node.line}: read of undeclared name "
                f"'{node.ident}'")


def _validate_init_order(func: A.FuncDef) -> None:
    """Reject reads of a primitive local before its first assignment.

    Path-sensitive where it matters: an assignment inside a conditional
    branch only initializes the variable if every branch assigns it; a
    while/forall body may run zero times, so its assignments never
    initialize anything for the code after the loop; a do-while body
    always runs once, so its assignments do (and the body is scanned
    *before* the loop condition is checked).
    """

    def check_expr(e: Optional[A.Expr], uninit: Set[str]):
        if e is None:
            return
        for n in A.walk(e):
            if isinstance(n, A.Name) and n.ident in uninit:
                raise SemanticError(
                    f"line {n.line}: '{n.ident}' is read before it is "
                    f"written")

    def scan(stmts, uninit: Set[str]):
        for st in stmts:
            if isinstance(st, A.Decl):
                check_expr(st.init, uninit)
                if st.init is None and not st.type.is_prop and \
                        st.type.name in ("int", "long", "float", "double",
                                         "bool"):
                    uninit.add(st.name)
                else:
                    uninit.discard(st.name)
            elif isinstance(st, A.Assign):
                check_expr(st.value, uninit)
                if isinstance(st.target, A.Name):
                    if st.op == "=":
                        uninit.discard(st.target.ident)
                    elif st.target.ident in uninit:
                        raise SemanticError(
                            f"line {st.line}: '{st.target.ident}' is "
                            f"updated before it is written")
                else:
                    check_expr(st.target, uninit)
            elif isinstance(st, A.MultiAssign):
                for v in st.values:
                    check_expr(v, uninit)
            elif isinstance(st, A.If):
                check_expr(st.cond, uninit)
                u_then = set(uninit)
                scan(st.then.stmts, u_then)
                if st.orelse is not None:
                    u_else = set(uninit)
                    scan(st.orelse.stmts, u_else)
                    # initialized only if assigned on *both* paths
                    uninit.clear()
                    uninit.update(u_then | u_else)
                # no else: the skip path keeps everything uninitialized
            elif isinstance(st, A.DoWhile):
                scan(st.body.stmts, uninit)      # body runs before cond
                check_expr(st.cond, uninit)
            elif isinstance(st, A.While):
                check_expr(st.cond, uninit)
                scan(st.body.stmts, set(uninit))  # may run zero times
            elif isinstance(st, A.ForAll):
                check_expr(st.filter, uninit)
                scan(st.body.stmts, set(uninit))
            elif isinstance(st, (A.FixedPoint, A.BatchStmt, A.OnUpdate)):
                scan(st.body.stmts, set(uninit))
            elif isinstance(st, A.CallStmt):
                check_expr(st.call, uninit)
            elif isinstance(st, A.Return):
                check_expr(st.value, uninit)

    scan(func.body.stmts, set())


def analyze(prog: A.ProgramAST) -> Dict[str, FuncInfo]:
    """Build per-function symbol tables + sweep analyses; validate."""
    infos: Dict[str, FuncInfo] = {}
    func_names = {f.name for f in prog.funcs}
    for func in prog.funcs:
        symbols: Dict[str, Symbol] = {}
        for p in func.params:
            symbols[p.name] = Symbol(p.name, p.type, is_param=True)
        for node in A.walk(func):
            if isinstance(node, A.Decl):
                symbols.setdefault(node.name, Symbol(node.name, node.type))
        nprops, eprops = _collect_props(func)
        _validate_names(func, symbols, nprops, eprops, func_names)
        _validate_init_order(func)
        sweeps = []
        for node in A.walk(func):
            if isinstance(node, A.ForAll):
                sweeps.append(_analyze_sweep(node, nprops))
        ret = None
        for node in A.walk(func):
            if isinstance(node, A.Return):
                ret = "scalar"
        if func.name in infos:
            raise SemanticError(f"duplicate function {func.name}")
        infos[func.name] = FuncInfo(
            name=func.name, kind=func.kind, symbols=symbols,
            node_props=nprops, edge_props=eprops, sweeps=sweeps, returns=ret)
    return infos
