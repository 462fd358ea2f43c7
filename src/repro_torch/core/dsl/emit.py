"""Emit the lowering report — our analogue of the paper's generated C++.

StarPlat's compiler writes OpenMP/MPI/CUDA source files; our staged
backend has no source artifact, so ``emit_report`` renders what the code
generator *decided* per construct for each backend: the aggregate-op
lowering, inferred combiners (the race analysis result), read/write
sets (the transfer/RMA-window analysis result), and the backend-specific
synchronization each engine will use.
"""
from __future__ import annotations

from typing import List

from repro_torch.core.dsl import ast_nodes as A
from repro_torch.core.dsl.analysis import analyze, FuncInfo

_BACKEND_SYNC = {
    "torch": "segment min/max/or by scatter_reduce, integer sums by "
             "index_add_, float sums by the lane-ordered segment sum "
             "(csrc/segment.cu on the card) over the flat edge lanes "
             "(plain tensor reference; OpenMP analogue)",
    "cuda": "the torch backend's segment reductions (DSL sweeps declare "
            "no gather_form, so no row kernel runs); each add batch "
            "merged into the diff pool by merge_pool_sorted "
            "(csrc/repair.cu; CUDA analogue)",
    "cuda_chained": "the torch backend's segment reductions and its "
                    "scatter path for add batches",
}


def emit_report(prog, backend: str = "torch") -> str:
    """Human-readable lowering report for every function in ``prog``."""
    infos = prog.infos
    out: List[str] = []
    out.append(f"== StarPlat-Dynamic lowering report (backend={backend}) ==")
    out.append(f"synchronization: {_BACKEND_SYNC.get(backend, '?')}")
    for fname, info in infos.items():
        out.append("")
        out.append(f"{info.kind} {fname}:")
        if info.node_props:
            out.append(f"  node props: "
                       f"{', '.join(f'{k}:{v}' for k, v in sorted(info.node_props.items()))}")
        if info.edge_props:
            out.append(f"  edge props: "
                       f"{', '.join(f'{k}:{v}' for k, v in sorted(info.edge_props.items()))}")
        func = prog.ast.func(fname)
        _emit_block(func.body, out, infos[fname], indent=2)
    return "\n".join(out)


def _emit_block(block: A.Block, out: List[str], info: FuncInfo, indent: int):
    pad = " " * indent
    for st in block.stmts:
        if isinstance(st, A.ForAll):
            _emit_forall(st, out, info, indent)
        elif isinstance(st, A.FixedPoint):
            out.append(f"{pad}fixedPoint(!{_fmt(st.cond)}) → "
                       f"engine.fixed_point(cond=any({_fmt(st.cond)[1:]}))")
            _emit_block(st.body, out, info, indent + 2)
        elif isinstance(st, (A.While, A.DoWhile)):
            k = "while" if isinstance(st, A.While) else "do-while"
            out.append(f"{pad}{k}({_fmt(st.cond)}) → engine.fixed_point"
                       f"(cond staged from scalar accumulators/counters)")
            _emit_block(st.body, out, info, indent + 2)
        elif isinstance(st, A.BatchStmt):
            out.append(f"{pad}Batch({st.updates}:{st.batch_size}) → host "
                       f"loop over UpdateStream.batches()")
            _emit_block(st.body, out, info, indent + 2)
        elif isinstance(st, A.OnUpdate):
            op = "OnAdd" if st.kind == "add" else "OnDelete"
            out.append(f"{pad}{op}({st.var}) → masked scatter over batch "
                       f"lanes / batch_edge_flags")
        elif isinstance(st, A.CallStmt):
            name = _callee(st.call)
            low = {"updateCSRAdd": "engine.update_add (diff-CSR insert)",
                   "updateCSRDel": "engine.update_del (tombstone)",
                   "propagateNodeFlags": "engine.propagate_flags "
                                         "(or-combine BFS fixed point)",
                   "attachNodeProperty": "engine.full per property",
                   "attachEdgeProperty": "lane-array alloc"}.get(name)
            if low:
                out.append(f"{pad}{name} → {low}")
            else:
                out.append(f"{pad}call {name}(...)")


def _emit_forall(fa: A.ForAll, out: List[str], info: FuncInfo, indent: int):
    pad = " " * indent
    sw = next((s for s in info.sweeps if s.line == fa.line), None)
    inner = [s for s in fa.body.stmts if isinstance(s, A.ForAll)]
    shape = sw.orientation if sw else "?"
    line = f"{pad}forall({fa.var} in {_fmt(fa.iter)}"
    if fa.filter is not None:
        line += f" filter {_fmt(fa.filter)}"
    line += f") → {shape} sweep"
    out.append(line)
    if sw:
        if sw.reads:
            out.append(f"{pad}  reads  {{{', '.join(sorted(sw.reads))}}}  "
                       f"(gather/window set)")
        if sw.writes:
            out.append(f"{pad}  writes {{{', '.join(sorted(sw.writes))}}}")
        for r in sw.races:
            of = f" of={r.of}" if r.of else ""
            out.append(f"{pad}  race on '{r.target}' → Reduce"
                       f"({r.kind}{of})  [atomics re-associated]")
    for s in inner:
        _emit_forall(s, out, info, indent + 2)


def _callee(c: A.Call) -> str:
    if isinstance(c.func, A.Attr):
        return c.func.name
    if isinstance(c.func, A.Name):
        return c.func.ident
    return "?"


def _fmt(e: A.Expr) -> str:
    if isinstance(e, A.Name):
        return e.ident
    if isinstance(e, A.Num):
        return str(e.value)
    if isinstance(e, A.Bool):
        return str(e.value)
    if isinstance(e, A.Inf):
        return "INF"
    if isinstance(e, A.Unary):
        return f"{e.op}{_fmt(e.operand)}"
    if isinstance(e, A.Binary):
        return f"{_fmt(e.left)} {e.op} {_fmt(e.right)}"
    if isinstance(e, A.Attr):
        return f"{_fmt(e.obj)}.{e.name}"
    if isinstance(e, A.Call):
        args = ", ".join(_fmt(a) for a in e.args)
        return f"{_fmt(e.func)}({args})"
    if isinstance(e, A.MinMax):
        return f"{e.op}({', '.join(_fmt(a) for a in e.args)})"
    if isinstance(e, A.Kwarg):
        return f"{e.name}={_fmt(e.value)}"
    return type(e).__name__
