"""Aggregate-op lowering: forall / fixedPoint / Batch bodies → engine ops
(counterpart of ``repro.core.dsl.lowering``, staged onto torch tensors).

The pattern grammar recognized here is exactly the shape of the paper's
appendix programs (and their natural variations):

  vertex sweep   forall (v in g.nodes().filter(F)) { elementwise body }
  edge sweep     forall (v ...) { [locals] forall (nbr in g.neighbors(v)
                 | g.nodes_to(v)) { racy writes } [elementwise tail] }
  wedge sweep    forall (v) { forall (u in N(v)) { forall (w in N(v))
                 {...} } }   |   forall (upd in batch) { forall (v3 in
                 N(v1)) {...} }
  loops          fixedPoint / do-while / while around one core sweep plus
                 elementwise post statements

Racy writes inside edge sweeps are matched to combiner idioms
(analysis.py) and staged as :class:`repro_torch.core.ir.Reduce` entries;
the rest of the body is interpreted by a *masked vectorizing interpreter*
(``vexec``) that turns straight-line code with ifs into ``torch.where``
chains — the moral equivalent of the paper emitting guarded CUDA/OpenMP
bodies.  Python scalars meeting tensors take the dtypes JAX's weak types
give them (``_result_dtype``); the reference's ``lax.while_loop`` over a
vertex sweep is a host loop that reads its condition once an iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dsl import ast_nodes as A
from repro_torch.core.ir import EdgeSweep, Reduce
from repro_torch.graph.csr import INT, INF_W
from repro_torch.graph.diffcsr import BOOL
from repro_torch.tensors import set_drop

F32 = torch.float32
_BIG = 1 << 30


class LowerError(Exception):
    pass


# ---------------------------------------------------------------------------
# vec values
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SideMarker:
    """Edge-sweep view handle: 's' (edge source) or 'd' (destination)."""
    side: str


@dataclasses.dataclass
class IdLane:
    """Node ids as a lane array (vertex / wedge / scatter contexts).

    ``identity=True`` marks the iota lane of a vertex sweep — reads skip
    the gather and writes become where-merges instead of scatters.
    """
    idx: Any
    identity: bool = False


@dataclasses.dataclass
class EdgeSym:
    """edge e = g.get_edge(a, b) inside a sweep: symbolic endpoints."""
    a: Any
    b: Any
    weight: Any = None


def _as_raw(v):
    if isinstance(v, IdLane):
        return v.idx
    return v


# ---------------------------------------------------------------------------
# JAX's typing of Python scalars, on torch tensors
# ---------------------------------------------------------------------------

def _dtype_of(x) -> Tuple[torch.dtype, bool]:
    """(dtype, weak): a tensor's own dtype, or a Python scalar's as JAX
    types it (weakly: bool, int32, float32)."""
    if isinstance(x, torch.Tensor):
        return x.dtype, False
    if isinstance(x, (bool, np.bool_)):
        return BOOL, True
    if isinstance(x, (int, np.integer)):
        return INT, True
    if isinstance(x, (float, np.floating)):
        return F32, True
    raise LowerError(f"cannot stage a value of type {type(x).__name__}")


def _kind(dt: torch.dtype) -> int:
    return 0 if dt == BOOL else (2 if dt.is_floating_point else 1)


def _result_dtype(a, b) -> torch.dtype:
    """The dtype JAX gives a binary op of ``a`` and ``b``: a weak scalar
    takes the tensor's dtype unless it is of a higher kind."""
    (da, wa), (db, wb) = _dtype_of(a), _dtype_of(b)
    if wa and not wb:
        return db if _kind(db) >= _kind(da) else da
    if wb and not wa:
        return da if _kind(da) >= _kind(db) else db
    return torch.promote_types(da, db)


def _device(*xs, default=None):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return default


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.tensor(x, dtype=dtype, device=device)


def _select(mask, a, b) -> torch.Tensor:
    """``where(mask, a, b)`` in the dtype of ``_result_dtype``."""
    dt, dev = _result_dtype(a, b), _device(mask, a, b)
    return torch.where(mask, _as_tensor(a, dt, dev), _as_tensor(b, dt, dev))


def _where(mask, new, old) -> torch.Tensor:
    """``mask ? new : old`` in ``old``'s dtype."""
    dt, dev = _dtype_of(old)[0], _device(mask, new, old)
    return torch.where(mask, _as_tensor(new, dt, dev),
                       _as_tensor(old, dt, dev))


def _minmax(op: str, a, b):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return min(a, b) if op == "Min" else max(a, b)
    dt, dev = _result_dtype(a, b), _device(a, b)
    f = torch.minimum if op == "Min" else torch.maximum
    return f(_as_tensor(a, dt, dev), _as_tensor(b, dt, dev))


def _abs(x):
    return torch.abs(x) if isinstance(x, torch.Tensor) else abs(x)


def _scatter(arr: torch.Tensor, idx, value, mask, n_pad: int):
    """``arr.at[where(mask, idx, n_pad)].set(value, mode="drop")``; lanes
    that write different values to one vertex leave the last one, as
    XLA's scatter does on the CPU."""
    tgt = torch.where(mask, idx, n_pad)
    lanes = isinstance(value, torch.Tensor) and value.ndim > 0
    val = _as_tensor(value, arr.dtype, arr.device).expand(idx.shape)
    return set_drop(arr, tgt, val, last_wins=lanes)


def _binop_vec(op, a, b):
    a, b = _as_raw(a), _as_raw(b)
    import repro_torch.core.dsl.codegen as CG
    return CG._binop(op, a, b)


# ---------------------------------------------------------------------------
# masked vectorizing interpreter
# ---------------------------------------------------------------------------

class VecCtx:
    """Hooks for attribute reads/writes + accumulators in vec contexts."""

    def __init__(self, ex, frame):
        self.ex = ex
        self.frame = frame
        self.accums: Dict[str, Any] = {}
        self.changed = None           # while-flag tracking
        self.flag_name: Optional[str] = None

    # overridden per context ------------------------------------------------
    def read_attr(self, obj, name, env):
        raise LowerError(f"attribute {name} not readable here")

    def write_attr(self, obj, name, value, mask, env):
        raise LowerError(f"attribute {name} not writable here")

    def call(self, e: A.Call, env, mask):
        raise LowerError(f"call not supported here (line {e.line})")

    def multi_assign(self, st: A.MultiAssign, env, mask):
        raise LowerError(f"line {st.line}: multi-assignment not "
                         f"supported in this context")

    # shared ------------------------------------------------------------------
    def host(self, name):
        return self.frame.lookup(name)


def veval(e: A.Expr, env: Dict[str, Any], ctx: VecCtx, mask=None):
    if isinstance(e, A.Num):
        return e.value
    if isinstance(e, A.Bool):
        return e.value
    if isinstance(e, A.Inf):
        return INF_W
    if isinstance(e, A.Name):
        if e.ident in env:
            return env[e.ident]
        v = ctx.host(e.ident)
        import repro_torch.core.dsl.codegen as CG
        if isinstance(v, CG.PropRef):
            return v                      # whole-array reference
        if isinstance(v, CG.NodeIdx):
            return v.idx
        return v
    if isinstance(e, A.Unary):
        v = _as_raw(veval(e.operand, env, ctx, mask))
        if e.op == "!":
            return ~v if hasattr(v, "dtype") else (not v)
        return -v
    if isinstance(e, A.Binary):
        a = veval(e.left, env, ctx, mask)
        b = veval(e.right, env, ctx, mask)
        return _binop_vec(e.op, a, b)
    if isinstance(e, A.MinMax):
        vals = [_as_raw(veval(a, env, ctx, mask)) for a in e.args]
        out = vals[0]
        for v in vals[1:]:
            out = _minmax(e.op, out, v)
        return out
    if isinstance(e, A.Attr):
        obj = veval(e.obj, env, ctx, mask)
        return ctx.read_attr(obj, e.name, env)
    if isinstance(e, A.Call):
        return ctx.call(e, env, mask)
    raise LowerError(f"line {e.line}: cannot stage {type(e).__name__}")


def vexec(stmts: List[A.Stmt], env: Dict[str, Any], ctx: VecCtx, mask):
    """Masked sequential execution of straight-line code with ifs."""
    for st in stmts:
        if isinstance(st, A.Decl):
            init = veval(st.init, env, ctx, mask) if st.init is not None \
                else (0 if st.type.name != "bool" else False)
            if st.type.name == "node" and not isinstance(init, IdLane):
                init = IdLane(_as_raw(init))
            env[st.name] = init
        elif isinstance(st, A.Assign) and isinstance(st.target, A.Name):
            name = st.target.ident
            val = veval(st.value, env, ctx, mask)
            if st.op in ("+=", "-="):
                if name in ctx.accums:
                    contrib = _as_raw(val)
                    contrib = _select(mask, contrib, 0) if st.op == "+=" \
                        else _select(mask, -contrib, 0)
                    ctx.accums[name] = ctx.accums[name] + contrib
                    continue
                cur = env.get(name, ctx.host(name))
                val = _binop_vec("+" if st.op == "+=" else "-", cur, val)
            if name == ctx.flag_name:
                # `finished = False` inside the loop body: convergence ride
                if isinstance(st.value, A.Bool) and not st.value.value:
                    ctx.changed = mask if ctx.changed is None \
                        else (ctx.changed | mask)
                continue
            if name in ctx.accums:
                # `sum = sum + expr` accumulation spelling
                if isinstance(st.value, A.Binary) and \
                        _mentions(st.value, name):
                    contrib = _strip_self(st.value, name, env, ctx, mask)
                    ctx.accums[name] = ctx.accums[name] + \
                        _select(mask, _as_raw(contrib), 0)
                    continue
            cur = env.get(name)
            if cur is None:
                env[name] = val
            else:
                if isinstance(cur, IdLane) or isinstance(val, IdLane):
                    env[name] = IdLane(_where(mask, _as_raw(val),
                                              _as_raw(cur)))
                else:
                    env[name] = _where(mask, _as_raw(val), _as_raw(cur))
        elif isinstance(st, A.Assign) and isinstance(st.target, A.Attr):
            obj = veval(st.target.obj, env, ctx, mask)
            val = veval(st.value, env, ctx, mask)
            ctx.write_attr(obj, st.target.name, val, mask, env)
        elif isinstance(st, A.MultiAssign):
            ctx.multi_assign(st, env, mask)
        elif isinstance(st, A.If):
            c = _as_raw(veval(st.cond, env, ctx, mask))
            m_then = mask & c
            vexec(st.then.stmts, env, ctx, m_then)
            if st.orelse is not None:
                vexec(st.orelse.stmts, env, ctx, mask & ~c)
        elif isinstance(st, A.CallStmt):
            ctx.call(st.call, env, mask)
        else:
            raise LowerError(f"line {st.line}: unsupported statement in "
                             f"parallel body: {type(st).__name__}")


def _mentions(e: A.Expr, name: str) -> bool:
    return any(isinstance(n, A.Name) and n.ident == name for n in A.walk(e))


def _strip_self(e: A.Binary, name: str, env, ctx, mask):
    """sum = sum + expr  →  expr (the self operand removed)."""
    if isinstance(e.left, A.Name) and e.left.ident == name and e.op == "+":
        return veval(e.right, env, ctx, mask)
    if isinstance(e.right, A.Name) and e.right.ident == name and e.op == "+":
        return veval(e.left, env, ctx, mask)
    raise LowerError(f"line {e.line}: unsupported accumulation form")


# ---------------------------------------------------------------------------
# forall classification
# ---------------------------------------------------------------------------

def _iter_info(ex, it: A.Expr, frame):
    """('nodes'|'neighbors'|'nodes_to'|'batch', base-arg)"""
    import repro_torch.core.dsl.codegen as CG
    if isinstance(it, A.Call) and isinstance(it.func, A.Attr):
        m = it.func.name
        if m == "nodes":
            return "nodes", None
        if m in ("neighbors", "nodes_to"):
            return m, it.args[0]
        if m == "currentBatch":
            base = ex.eval_host(it, frame)
            return "batch", base
    if isinstance(it, A.Name):
        v = frame.lookup(it.ident)
        if isinstance(v, CG.UpdatesRef):
            return "batch", v
    raise LowerError(f"line {it.line}: unsupported forall iterator")


def classify_forall(ex, fa: A.ForAll, frame) -> str:
    kind, _ = _iter_info(ex, fa.iter, frame)
    inner = [s for s in fa.body.stmts if isinstance(s, A.ForAll)]
    if kind == "nodes":
        if not inner:
            return "vertex"
        ik, _ = _iter_info(ex, inner[0].iter, frame)
        sub = [s for s in inner[0].body.stmts if isinstance(s, A.ForAll)]
        if sub:
            return "wedge_static"
        return "edge"
    if kind == "batch":
        if inner:
            return "wedge_batch"
        return "scatter"
    raise LowerError(f"line {fa.line}: forall over {kind} at "
                     f"statement level")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _real_mask(engine):
    return torch.arange(engine.n_pad, dtype=INT,
                        device=engine.device) < engine.n_real


def _needs_outdeg(node: A.Node) -> bool:
    return any(isinstance(n, A.Call) and isinstance(n.func, A.Attr)
               and n.func.name == "count_outNbrs" for n in A.walk(node))


def _gather_props(ex, frame, extra: Optional[Dict[str, Any]] = None):
    props = dict(frame.props_arrays())
    props["_real"] = _real_mask(ex.engine)
    if extra:
        props.update(extra)
    return props


def _write_back(frame, props: Dict[str, Any]):
    frame.write_back({k: v for k, v in props.items()
                      if not k.startswith("_")})


# ===========================================================================
# vertex sweeps
# ===========================================================================

class VertexCtx(VecCtx):
    """Elementwise sweep over vertices; obj values are IdLane indices."""

    def __init__(self, ex, frame, props: Dict[str, Any], n_pad: int):
        super().__init__(ex, frame)
        self.props = props
        self.n_pad = n_pad

    def read_attr(self, obj, name, env):
        import repro_torch.core.dsl.codegen as CG
        if isinstance(obj, IdLane):
            arr = self.props[name]
            if obj.identity:
                return arr
            return arr[obj.idx.clamp(0, self.n_pad - 1)]
        if isinstance(obj, CG.PropRef):
            return self.props[obj.name]
        raise LowerError(f"cannot read .{name}")

    def write_attr(self, obj, name, value, mask, env):
        if not isinstance(obj, IdLane):
            raise LowerError(f"cannot write .{name}")
        arr = self.props[name]
        value = _as_raw(value)
        # identity index → where-merge; general index → masked scatter
        if obj.identity:
            self.props[name] = _where(mask, value, arr)
        else:
            self.props[name] = _scatter(arr, obj.idx, value, mask,
                                        self.n_pad)

    def call(self, e: A.Call, env, mask):
        if isinstance(e.func, A.Name) and e.func.ident == "abs":
            return _abs(_as_raw(veval(e.args[0], env, self, mask)))
        if isinstance(e.func, A.Attr) and e.func.name == "count_outNbrs":
            x = veval(e.args[0], env, self, mask)
            return self.props["_outdeg"][_as_raw(x).clamp(0,
                                                           self.n_pad - 1)]
        raise LowerError(f"line {e.line}: unsupported call in vertex sweep")


class _Iota:
    pass


def make_vertex_fn(ex, fa: A.ForAll, frame,
                   flag_name: Optional[str] = None) -> Callable:
    """Stage ``forall (v in g.nodes().filter(F)) { body }`` into an
    elementwise fn(props) -> props (with '_changed' when flag-tracked)."""
    engine = ex.engine
    n_pad = engine.n_pad

    def fn(props: Dict[str, Any]) -> Dict[str, Any]:
        ctx = VertexCtx(ex, frame, dict(props), n_pad)
        ctx.flag_name = flag_name
        lane = IdLane(torch.arange(n_pad, dtype=INT,
                                   device=engine.device), identity=True)
        env = {fa.var: lane}
        mask = props["_real"]
        if fa.filter is not None:
            fmask = _as_raw(veval(fa.filter, _FilterEnv(env, ctx, fa.var),
                                  ctx))
            mask = mask & fmask
        vexec(fa.body.stmts, env, ctx, mask)
        out = ctx.props
        if flag_name is not None:
            ch = ctx.changed if ctx.changed is not None \
                else torch.zeros((n_pad,), dtype=BOOL,
                                 device=engine.device)
            out["_changed"] = ch
        return out

    return fn


class _FilterEnv(dict):
    """filter(modified == True): bare prop names refer to the loop var's
    own attributes (paper shorthand)."""

    def __init__(self, base, ctx, var):
        super().__init__(base)
        self._ctx = ctx
        self._var = var

    def __missing__(self, key):
        if key in self._ctx.props:
            return self._ctx.props[key]
        raise KeyError(key)

    def __contains__(self, key):
        return super().__contains__(key) or key in self._ctx.props


# ===========================================================================
# edge sweeps
# ===========================================================================

@dataclasses.dataclass
class MinGroup:
    prop: str
    cand: A.Expr                    # candidate value expression
    guards: List[A.Expr]            # extra eligibility conjuncts
    kind: str = "min"               # 'min' | 'max'
    argmin: Optional[str] = None    # prop assigned the winning source id
    or_rides: List[str] = dataclasses.field(default_factory=list)
    changed: bool = False           # `finished = False` rides the update


@dataclasses.dataclass
class OrGroup:
    prop: str
    guards: List[A.Expr]


@dataclasses.dataclass
class AccumGroup:
    local: str                      # local scalar accumulated in the loop
    value: A.Expr


@dataclasses.dataclass
class EdgePlan:
    orientation: str                # 'push' | 'pull'
    outer: str
    inner: str
    filter: Optional[A.Expr]
    mins: List[MinGroup]
    ors: List[OrGroup]
    accums: List[AccumGroup]
    edge_vars: Dict[str, Tuple[A.Expr, A.Expr]]
    pre_stmts: List[A.Stmt]         # outer-body decls before the inner loop
    post_stmts: List[A.Stmt]        # outer-body stmts after the inner loop
    line: int = 0


def plan_edge_sweep(ex, fa: A.ForAll, frame,
                    flag_name: Optional[str]) -> EdgePlan:
    inner = next(s for s in fa.body.stmts if isinstance(s, A.ForAll))
    i = fa.body.stmts.index(inner)
    pre = fa.body.stmts[:i]
    post = fa.body.stmts[i + 1:]
    ik, _ = _iter_info(ex, inner.iter, frame)
    orientation = "push" if ik == "neighbors" else "pull"
    plan = EdgePlan(orientation=orientation, outer=fa.var, inner=inner.var,
                    filter=fa.filter, mins=[], ors=[], accums=[],
                    edge_vars={}, pre_stmts=pre, post_stmts=post,
                    line=fa.line)
    src_var = fa.var if orientation == "push" else inner.var
    dst_var = inner.var if orientation == "push" else fa.var

    # accumulators: scalar locals declared in pre (float sum = 0.0)
    accum_names = {s.name for s in pre if isinstance(s, A.Decl)
                   and not s.type.is_prop and s.type.name != "node"}

    def scan(stmts, guards):
        for st in stmts:
            if isinstance(st, A.Decl) and st.type.name == "edge":
                if isinstance(st.init, A.Call) and \
                        isinstance(st.init.func, A.Attr) and \
                        st.init.func.name == "get_edge":
                    plan.edge_vars[st.name] = (st.init.args[0],
                                               st.init.args[1])
                continue
            if isinstance(st, A.MultiAssign):
                _plan_multi(plan, st, guards, src_var, dst_var)
                continue
            if isinstance(st, A.Assign) and isinstance(st.target, A.Name):
                name = st.target.ident
                if name in accum_names:
                    val = st.value
                    if st.op == "+=":
                        plan.accums.append(AccumGroup(name, val))
                    elif isinstance(val, A.Binary):
                        if isinstance(val.left, A.Name) \
                                and val.left.ident == name:
                            plan.accums.append(AccumGroup(name, val.right))
                        else:
                            plan.accums.append(AccumGroup(name, val.left))
                    continue
                raise LowerError(f"line {st.line}: scalar write {name} in "
                                 f"edge body is not an accumulation")
            if isinstance(st, A.Assign) and isinstance(st.target, A.Attr):
                # standalone bool set: d.flag = True  → or-combine
                if isinstance(st.value, A.Bool) and st.value.value:
                    tgt = st.target
                    if _varname(tgt.obj) == dst_var:
                        plan.ors.append(OrGroup(tgt.name, list(guards)))
                        continue
                raise LowerError(f"line {st.line}: unsupported racy write")
            if isinstance(st, A.If):
                g2 = guards + [st.cond]
                hit = _plan_guarded_min(plan, st, guards, src_var, dst_var,
                                        flag_name)
                if hit:
                    continue
                scan(st.then.stmts, g2)
                if st.orelse is not None:
                    neg = A.Unary(op="!", operand=st.cond, line=st.line)
                    scan(st.orelse.stmts, guards + [neg])
                continue
            raise LowerError(f"line {st.line}: unsupported statement in "
                             f"edge body: {type(st).__name__}")

    scan(inner.body.stmts, [])
    if inner.filter is not None:
        for g in plan.mins + plan.ors:
            g.guards.append(inner.filter)
    return plan


def _varname(e: A.Expr) -> Optional[str]:
    return e.ident if isinstance(e, A.Name) else None


def _plan_multi(plan: EdgePlan, st: A.MultiAssign, guards,
                src_var: str, dst_var: str):
    """<d.p, d.f, d.q> = <Min(d.p, cand), True, v>"""
    grp: Optional[MinGroup] = None
    rides: List[Tuple[A.Expr, A.Expr]] = []
    for tgt, val in zip(st.targets, st.values):
        if isinstance(val, A.MinMax):
            if not isinstance(tgt, A.Attr):
                raise LowerError(f"line {st.line}: Min target not a "
                                 f"property")
            cand = None
            for a in val.args:
                if isinstance(a, A.Attr) and a.name == tgt.name and \
                        _varname(a.obj) == _varname(tgt.obj):
                    continue
                cand = a
            if cand is None:
                raise LowerError(f"line {st.line}: cannot find Min "
                                 f"candidate")
            grp = MinGroup(prop=tgt.name, cand=cand, guards=list(guards),
                           kind="min" if val.op == "Min" else "max")
        else:
            rides.append((tgt, val))
    if grp is None:
        raise LowerError(f"line {st.line}: multi-assignment without "
                         f"Min/Max")
    for tgt, val in rides:
        if not isinstance(tgt, A.Attr):
            raise LowerError(f"line {st.line}: bad ride target")
        if isinstance(val, A.Bool) and val.value:
            grp.or_rides.append(tgt.name)
        elif isinstance(val, A.Name) and val.ident == src_var:
            grp.argmin = tgt.name
        else:
            raise LowerError(f"line {st.line}: unsupported ride value")
    plan.mins.append(grp)


def _plan_guarded_min(plan: EdgePlan, st: A.If, guards, src_var, dst_var,
                      flag_name) -> bool:
    """if (d.p > cand) { d.p = cand; d.q = src; finished = False; }"""
    conj = _conjuncts(st.cond)
    min_prop, cand, kind = None, None, None
    extra = []
    for c in conj:
        if isinstance(c, A.Binary) and c.op in (">", "<") and \
                isinstance(c.left, A.Attr) and \
                _varname(c.left.obj) == dst_var:
            min_prop = c.left.name
            cand = c.right
            kind = "min" if c.op == ">" else "max"
        else:
            extra.append(c)
    if min_prop is None or st.orelse is not None:
        return False
    # the body must assign exactly that prop (same candidate), optional
    # argmin ride, optional flag ride
    grp = MinGroup(prop=min_prop, cand=cand, guards=list(guards) + extra,
                   kind=kind)
    matched = False
    for s in st.then.stmts:
        if isinstance(s, A.Assign) and isinstance(s.target, A.Attr) and \
                s.target.name == min_prop and \
                _varname(s.target.obj) == dst_var:
            matched = True
        elif isinstance(s, A.Assign) and isinstance(s.target, A.Attr) and \
                isinstance(s.value, A.Name) and s.value.ident == src_var:
            grp.argmin = s.target.name
        elif isinstance(s, A.Assign) and isinstance(s.target, A.Attr) and \
                isinstance(s.value, A.Bool) and s.value.value:
            grp.or_rides.append(s.target.name)
        elif isinstance(s, A.Assign) and isinstance(s.target, A.Name) and \
                s.target.ident == flag_name and \
                isinstance(s.value, A.Bool) and not s.value.value:
            grp.changed = True
        else:
            return False
    if not matched:
        return False
    plan.mins.append(grp)
    return True


def _conjuncts(e: A.Expr) -> List[A.Expr]:
    if isinstance(e, A.Binary) and e.op == "&&":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


class EdgeFnCtx(VecCtx):
    """Evaluation context inside edge_fn: s/d views + lane weight."""

    def __init__(self, ex, frame, plan: EdgePlan, s, d, w):
        super().__init__(ex, frame)
        self.plan = plan
        self.s, self.d, self.w = s, d, w

    def _view(self, side):
        return self.s if side == "s" else self.d

    def read_attr(self, obj, name, env):
        if isinstance(obj, SideMarker):
            return self._view(obj.side)[name]
        if isinstance(obj, EdgeSym):
            if name == "weight":
                return self.w
            raise LowerError(f"edge property .{name} unavailable inside an "
                             f"edge sweep (use weight)")
        import repro_torch.core.dsl.codegen as CG
        if isinstance(obj, CG.PropRef):
            raise LowerError(f"whole-property read .{name}")
        raise LowerError(f"cannot read .{name} in edge fn")

    def call(self, e: A.Call, env, mask):
        if isinstance(e.func, A.Name) and e.func.ident == "abs":
            return _abs(_as_raw(veval(e.args[0], env, self, mask)))
        if isinstance(e.func, A.Attr):
            if e.func.name == "count_outNbrs":
                x = veval(e.args[0], env, self, mask)
                if isinstance(x, SideMarker):
                    return self._view(x.side)["_outdeg"]
            if e.func.name == "get_edge":
                return EdgeSym(a=e.args[0], b=e.args[1])
        raise LowerError(f"line {e.line}: unsupported call in edge sweep")


def build_edge_sweep(ex, plan: EdgePlan, frame,
                     track_changed: bool) -> Tuple[EdgeSweep, bool]:
    """EdgePlan → EdgeSweep (+ whether '_changed' is produced)."""
    engine = ex.engine
    outer_side = "s" if plan.orientation == "push" else "d"
    inner_side = "d" if plan.orientation == "push" else "s"

    def bind(ctx):
        env = {plan.outer: SideMarker(outer_side),
               plan.inner: SideMarker(inner_side)}
        for name, (a, b) in plan.edge_vars.items():
            env[name] = EdgeSym(a=a, b=b)
        return env

    def outer_mask_edge(ctx, env):
        view = ctx._view(outer_side)
        m = view["_real"]
        if plan.filter is not None:
            fenv = _SideFilterEnv(env, view)
            m = m & _as_raw(veval(plan.filter, fenv, ctx))
        return m

    def edge_fn(s, d, w):
        ctx = EdgeFnCtx(ex, frame, plan, s, d, w)
        env = bind(ctx)
        base = outer_mask_edge(ctx, env)
        out = {}
        for g in plan.mins:
            m = base
            for gd in g.guards:
                m = m & _as_raw(veval(gd, env, ctx))
            out[g.prop] = (_as_raw(veval(g.cand, env, ctx)), m)
        for g in plan.ors:
            m = base
            for gd in g.guards:
                m = m & _as_raw(veval(gd, env, ctx))
            out[g.prop] = (m, m)
        for g in plan.accums:
            val = _as_raw(veval(g.value, env, ctx))
            out["_red_" + g.local] = (val, base)
        return out

    reduces: Dict[str, Reduce] = {}
    for g in plan.mins:
        reduces[g.prop] = Reduce(g.kind)
        if g.argmin is not None:
            reduces[g.argmin] = Reduce("argmin", of=g.prop)
    for g in plan.ors:
        reduces[g.prop] = Reduce("or")
    for g in plan.accums:
        reduces["_red_" + g.local] = Reduce("sum")

    has_changed = track_changed and (any(g.changed for g in plan.mins)
                                     or bool(plan.ors))

    def post_fn(p, red, hit):
        props = dict(p)
        n_pad = props["_real"].shape[0]
        dev = props["_real"].device
        changed = torch.zeros((n_pad,), dtype=BOOL, device=dev)
        for g in plan.mins:
            cur = props[g.prop]
            if g.kind == "min":
                better = hit[g.prop] & (red[g.prop] < cur)
            else:
                better = hit[g.prop] & (red[g.prop] > cur)
            props[g.prop] = torch.where(better, red[g.prop], cur)
            if g.argmin is not None:
                props[g.argmin] = _where(better, red[g.argmin],
                                         props[g.argmin])
            for f in g.or_rides:
                props[f] = props[f] | better
            if g.changed:
                changed = changed | better
        for g in plan.ors:
            newly = red[g.prop] & ~props[g.prop]
            props[g.prop] = props[g.prop] | red[g.prop]
            changed = changed | newly
        # post-inner elementwise tail (PR: val / diff / pageRank_nxt)
        if plan.post_stmts or plan.accums:
            ctx = VertexCtx(ex, frame, props, n_pad)
            env = {plan.outer: IdLane(torch.arange(n_pad, dtype=INT,
                                                   device=dev),
                                      identity=True)}
            mask = props["_real"]
            if plan.filter is not None:
                mask = mask & _as_raw(veval(plan.filter,
                                            _FilterEnv(env, ctx, plan.outer),
                                            ctx))
            for g in plan.accums:
                env[g.local] = red["_red_" + g.local]
            # function-scope scalar accumulators (diff) become _acc_ arrays
            ctx.accums = {k[5:]: torch.zeros((n_pad,), dtype=F32,
                                             device=dev)
                          for k in props if k.startswith("_acc_")}
            vexec(plan.post_stmts, env, ctx, mask)
            props = ctx.props
            for name, arr in ctx.accums.items():
                props["_acc_" + name] = arr
        if has_changed:
            props["_changed"] = changed
        return props

    return EdgeSweep(edge_fn=edge_fn, reduces=reduces, post_fn=post_fn), \
        has_changed


class _SideFilterEnv(dict):
    def __init__(self, base, view):
        super().__init__(base)
        self._view = view

    def __missing__(self, key):
        return self._view[key]

    def __contains__(self, key):
        if super().__contains__(key):
            return True
        try:
            self._view[key]
            return True
        except Exception:
            return False


# ===========================================================================
# loops (fixedPoint / do-while / while)
# ===========================================================================

def _find_accum_names(stmts: List[A.Stmt], frame) -> List[str]:
    """Function-scope scalars reset + accumulated inside the loop (diff)."""
    out = []
    for st in stmts:
        if isinstance(st, A.Assign) and isinstance(st.target, A.Name) \
                and st.op == "=" and isinstance(st.value, A.Num):
            out.append(st.target.ident)
    return out


def _find_counters(stmts: List[A.Stmt]) -> List[str]:
    """x = x + 1 loop counters → mapped to the iteration index."""
    out = []
    for st in stmts:
        if isinstance(st, A.Assign) and isinstance(st.target, A.Name):
            v = st.value
            if isinstance(v, A.Binary) and v.op == "+" and \
                    isinstance(v.left, A.Name) and \
                    v.left.ident == st.target.ident and \
                    isinstance(v.right, A.Num) and v.right.value == 1:
                out.append(st.target.ident)
    return out


def run_loop(ex, stmts: List[A.Stmt], frame, kind: str,
             flag: Optional[str] = None, cond: Optional[A.Expr] = None):
    """Lower fixedPoint / do-while / while around one core sweep."""
    engine = ex.engine
    foralls = [s for s in stmts if isinstance(s, A.ForAll)]
    if not foralls:
        raise LowerError("loop without aggregate body is not lowerable")

    flag_name = flag
    if kind == "while" and isinstance(cond, A.Unary) and cond.op == "!" \
            and isinstance(cond.operand, A.Name):
        flag_name = cond.operand.ident

    kinds = [ex.staged(("kind", id(fa)),
                       lambda fa=fa: classify_forall(ex, fa, frame))
             for fa in foralls]
    core_idx = kinds.index("edge") if "edge" in kinds else 0
    core = foralls[core_idx]
    core_kind = kinds[core_idx]

    accum_names = _find_accum_names(stmts, frame)
    counters = _find_counters(stmts)

    # trailing post items: statements after the core forall
    core_pos = stmts.index(core)
    post_items = [s for s in stmts[core_pos + 1:]
                  if not (isinstance(s, A.Assign)
                          and isinstance(s.target, A.Name)
                          and (s.target.ident in counters
                               or s.target.ident == flag_name))]

    needs_outdeg = _needs_outdeg(core)
    extra: Dict[str, Any] = {}
    if needs_outdeg:
        extra["_outdeg"] = engine.out_degrees(frame.graph().box.value) \
            .to(F32)
    for name in accum_names:
        extra["_acc_" + name] = torch.zeros((engine.n_pad,), dtype=F32,
                                            device=engine.device)

    if core_kind == "vertex":
        _run_vertex_loop(ex, core, frame, flag_name, extra)
        return

    plan = ex.staged(("plan", id(core), flag_name),
                     lambda: plan_edge_sweep(ex, core, frame, flag_name))
    sweep, has_changed = build_edge_sweep(ex, plan, frame,
                                          track_changed=kind == "while")

    post_closures = _stage_post_items(ex, post_items, frame)
    if post_closures:
        base_post = sweep.post_fn

        def post_fn(p, red, hit):
            props = base_post(p, red, hit)
            for c in post_closures:
                props = c(props)
            return props
        sweep = EdgeSweep(edge_fn=sweep.edge_fn, reduces=sweep.reduces,
                          post_fn=post_fn, gather_form=sweep.gather_form)

    if has_changed:
        extra["_changed"] = torch.zeros((engine.n_pad,), dtype=BOOL,
                                        device=engine.device)

    cond_fn = _make_cond(ex, frame, kind, flag_name, cond, accum_names,
                         counters, has_changed)

    props = _gather_props(ex, frame, extra)
    gref = frame.graph()
    props = engine.fixed_point(gref.box.value, sweep, props, cond_fn,
                               max_iter=_BIG)
    _write_back(frame, props)


def _make_cond(ex, frame, kind, flag_name, cond, accum_names, counters,
               has_changed):
    if kind == "fixedPoint":
        # fixedPoint until (f : !p) — converged when p is False everywhere
        if isinstance(cond, A.Unary) and cond.op == "!" and \
                isinstance(cond.operand, A.Name):
            prop = cond.operand.ident
            return lambda p, it, col: col.any(p[prop])
        raise LowerError("fixedPoint condition must be !<boolean prop>")
    if kind == "while":
        # while (!finished) with change-tracked sweep
        if has_changed:
            return lambda p, it, col: (it == 0) | col.any(p["_changed"])
        return lambda p, it, col: (it == 0)
    # do-while: scalar condition over accumulators / counters
    def cond_fn(p, it, col):
        def ev(e: A.Expr):
            if isinstance(e, A.Num):
                return e.value
            if isinstance(e, A.Name):
                if e.ident in accum_names:
                    return col.sum(p["_acc_" + e.ident])
                if e.ident in counters:
                    return it             # it bodies completed == counter
                return frame.lookup(e.ident)
            if isinstance(e, A.Binary):
                import repro_torch.core.dsl.codegen as CG
                return CG._binop(e.op, ev(e.left), ev(e.right))
            if isinstance(e, A.Unary):
                v = ev(e.operand)
                return ~v if e.op == "!" else -v
            raise LowerError("unsupported do-while condition term")
        return (it == 0) | ev(cond)
    return cond_fn


def _run_vertex_loop(ex, fa: A.ForAll, frame, flag_name, extra):
    """while(!f){ f=True; forall(vertex...) } → vertex_map + a host loop
    that reads ``any(_changed)`` once an iteration (the reference's
    ``lax.while_loop``)."""
    engine = ex.engine
    fn = make_vertex_fn(ex, fa, frame, flag_name=flag_name)

    def outer(props):
        st = dict(props)
        st["_changed"] = torch.ones((engine.n_pad,), dtype=BOOL,
                                    device=engine.device)
        while bool(st["_changed"].any()):
            st = dict(st)
            st["_changed"] = torch.zeros((engine.n_pad,), dtype=BOOL,
                                         device=engine.device)
            st = fn(st)
        st.pop("_changed")
        return st

    props = _gather_props(ex, frame, extra)
    gref = frame.graph()
    props = engine.vertex_map(gref.box.value, outer, props)
    _write_back(frame, props)


def _stage_post_items(ex, items: List[A.Stmt], frame) -> List[Callable]:
    """Trailing loop statements → closures(props)->props run in post_fn."""
    out = []
    engine = ex.engine
    import repro_torch.core.dsl.codegen as CG
    for st in items:
        if isinstance(st, A.Assign) and isinstance(st.target, A.Name):
            # whole-prop copy: modified = modified_nxt
            tgt = st.target.ident
            ref = frame.lookup(tgt)
            if isinstance(ref, CG.PropRef) and isinstance(st.value, A.Name):
                src = st.value.ident

                def copy(props, tgt=tgt, src=src):
                    props = dict(props)
                    props[tgt] = props[src]
                    return props
                out.append(copy)
                continue
            raise LowerError(f"line {st.line}: unsupported loop tail "
                             f"assignment")
        if isinstance(st, A.CallStmt):
            c = st.call
            if isinstance(c.func, A.Attr) and c.func.name in (
                    "attachNodeProperty", "attachEdgeProperty"):
                sets = []
                for kw in c.args:
                    ref = frame.lookup(kw.name)
                    val = ex.eval_host(kw.value, frame) \
                        if not isinstance(kw.value, (A.Bool, A.Num, A.Inf)) \
                        else None
                    cval = kw.value
                    if isinstance(cval, A.Bool):
                        val = cval.value
                    elif isinstance(cval, A.Num):
                        val = cval.value
                    elif isinstance(cval, A.Inf):
                        val = INF_W
                    sets.append((kw.name, val, ref.dtype))

                def attach(props, sets=sets):
                    props = dict(props)
                    # size off the carry's own vertex length, not the
                    # engine's n_pad: under dist's shard_map the props
                    # in flight are (block,)-local shards
                    real = props["_real"]
                    for name, val, dt in sets:
                        props[name] = torch.full(real.shape, val, dtype=dt,
                                                 device=real.device)
                    return props
                out.append(attach)
                continue
            raise LowerError(f"line {st.line}: unsupported loop tail call")
        if isinstance(st, A.ForAll):
            if classify_forall(ex, st, frame) != "vertex":
                raise LowerError(f"line {st.line}: only vertex foralls may "
                                 f"follow the core sweep")
            fn = make_vertex_fn(ex, st, frame)
            out.append(lambda props, fn=fn: fn(props))
            continue
        raise LowerError(f"line {st.line}: unsupported loop statement "
                         f"{type(st).__name__}")
    return out


# ===========================================================================
# host-level forall
# ===========================================================================

def run_forall(ex, fa: A.ForAll, frame):
    engine = ex.engine
    kind = ex.staged(("kind", id(fa)),
                     lambda: classify_forall(ex, fa, frame))
    if kind == "vertex":
        extra = {}
        if _needs_outdeg(fa):
            extra["_outdeg"] = engine.out_degrees(
                frame.graph().box.value).to(F32)
        fn = make_vertex_fn(ex, fa, frame)
        props = _gather_props(ex, frame, extra)
        props = engine.vertex_map(frame.graph().box.value, fn, props)
        _write_back(frame, props)
        return
    if kind == "edge":
        extra = {}
        if _needs_outdeg(fa):
            extra["_outdeg"] = engine.out_degrees(
                frame.graph().box.value).to(F32)
        plan = ex.staged(("plan", id(fa), None),
                         lambda: plan_edge_sweep(ex, fa, frame,
                                                 flag_name=None))
        sweep, _ = build_edge_sweep(ex, plan, frame, track_changed=False)
        props = _gather_props(ex, frame, extra)
        props = engine.sweep(frame.graph().box.value, sweep, props)
        _write_back(frame, props)
        return
    if kind in ("wedge_static", "wedge_batch"):
        run_wedge(ex, fa, frame, kind)
        return
    raise LowerError(f"line {fa.line}: cannot lower forall kind {kind}")


# ===========================================================================
# wedges (triangle counting)
# ===========================================================================

class WedgeVecCtx(VecCtx):
    """pair_fn body context: ids x/y/z + edge-flag resolution."""

    def __init__(self, ex, frame, wctx, bindings: Dict[str, str],
                 eprops: Dict[str, Any], accum_names):
        super().__init__(ex, frame)
        self.wctx = wctx                 # engine WedgeCtx
        self.bindings = bindings         # DSL var -> 'x' | 'y' | 'z'
        self.eprops = eprops
        self.accums = {n: 0 for n in accum_names}

    def resolve(self, e: A.Expr, env):
        v = env.get(_varname(e)) if _varname(e) else None
        if isinstance(v, IdLane):
            return v.idx
        return _as_raw(veval(e, env, self))

    def read_attr(self, obj, name, env):
        if isinstance(obj, EdgeSym):
            a_role = self.bindings.get(_varname(obj.a), None)
            b_role = self.bindings.get(_varname(obj.b), None)
            if name == "weight":
                raise LowerError("edge weight unavailable in wedge sweep")
            if (a_role, b_role) == ("x", "z"):
                return self.wctx.nbr_flag(name)
            if (a_role, b_role) == ("y", "z"):
                return self.wctx.edge_flag(name, self._id("y", env),
                                           self._id("z", env))
            if (a_role, b_role) == ("x", "y"):
                return self.wctx.lane_flag(name)
            raise LowerError(f"cannot resolve edge flag .{name} for "
                             f"({a_role},{b_role})")
        raise LowerError(f"cannot read .{name} in wedge body")

    def _id(self, role, env):
        for var, r in self.bindings.items():
            if r == role:
                return env[var].idx
        raise LowerError(f"no {role} binding")

    def call(self, e: A.Call, env, mask):
        if isinstance(e.func, A.Attr) and e.func.name == "is_an_edge":
            a = self.resolve(e.args[0], env)
            b = self.resolve(e.args[1], env)
            return self.wctx.is_edge(a, b)
        if isinstance(e.func, A.Attr) and e.func.name == "get_edge":
            return EdgeSym(a=e.args[0], b=e.args[1])
        if isinstance(e.func, A.Name) and e.func.ident == "abs":
            return _abs(_as_raw(veval(e.args[0], env, self, mask)))
        raise LowerError(f"line {e.line}: unsupported call in wedge body")


def _accum_targets(fa: A.ForAll, frame) -> List[str]:
    """Function-scope scalars '+=' -accumulated inside the wedge body."""
    import repro_torch.core.dsl.codegen as CG
    names = []
    for n in A.walk(fa):
        if isinstance(n, A.Assign) and n.op in ("+=",) and \
                isinstance(n.target, A.Name):
            try:
                v = frame.lookup(n.target.ident)
            except CG.CodegenError:
                continue
            if not isinstance(v, (CG.PropRef, CG.GraphRef)):
                names.append(n.target.ident)
    seen = []
    for n in names:
        if n not in seen:
            seen.append(n)
    return seen


def run_wedge(ex, fa: A.ForAll, frame, kind: str):
    engine = ex.engine
    import repro_torch.core.dsl.codegen as CG
    g = frame.graph().box.value
    accum_names = ex.staged(("wedge_accums", id(fa)),
                            lambda: _accum_targets(fa, frame))
    if not accum_names:
        raise LowerError(f"line {fa.line}: wedge loop without counters")

    lane_flags: Dict[str, Any] = {}
    # every propEdge visible in the frame rides along as lane flags
    f = frame
    while f is not None:
        for k, v in f.env.items():
            if isinstance(v, CG.PropRef) and v.is_edge and \
                    v.box.value is not None and k not in lane_flags:
                lane_flags[k] = v.box.value
        f = f.parent

    if kind == "wedge_static":
        def _shape_static():
            inner1 = next(s for s in fa.body.stmts
                          if isinstance(s, A.ForAll))
            inner2 = next(s for s in inner1.body.stmts
                          if isinstance(s, A.ForAll))
            bindings = {fa.var: "x", inner1.var: "y", inner2.var: "z"}
            filters = [e for e in (inner1.filter, inner2.filter)
                       if e is not None]
            return bindings, filters, inner2.body.stmts
        bindings, filters, body = ex.staged(("wedge", id(fa)),
                                            _shape_static)
    else:
        # batch iteration: v1 = u.source; v2 = u.destination; forall v3 ...
        ups = _iter_info(ex, fa.iter, frame)[1]
        batch = frame.current_batch
        if batch is None:
            raise LowerError(f"line {fa.line}: batch wedge outside Batch")
        sel = ups.selector if isinstance(ups, CG.UpdatesRef) else "both"
        if sel == "del":
            it_flags = engine.batch_edge_flags(
                g, batch.del_src, batch.del_dst, batch.del_mask)
        elif sel == "add":
            it_flags = engine.batch_edge_flags(
                g, batch.add_src, batch.add_dst, batch.add_mask)
        else:
            fa_ = engine.batch_edge_flags(
                g, batch.add_src, batch.add_dst, batch.add_mask)
            fd_ = engine.batch_edge_flags(
                g, batch.del_src, batch.del_dst, batch.del_mask)
            it_flags = fa_ | fd_
        lane_flags["_iter"] = it_flags

        def _shape_batch():
            inner1 = next(s for s in fa.body.stmts
                          if isinstance(s, A.ForAll))
            bindings = {fa.var: None, inner1.var: "z"}
            # resolve v1/v2 decls
            for st in fa.body.stmts:
                if isinstance(st, A.Decl) and st.type.name == "node" and \
                        isinstance(st.init, A.Attr):
                    if st.init.name == "source":
                        bindings[st.name] = "x"
                    elif st.init.name == "destination":
                        bindings[st.name] = "y"
            filters = [inner1.filter] if inner1.filter is not None else []
            return bindings, filters, inner1.body.stmts
        bindings, filters, body = ex.staged(("wedge", id(fa)),
                                            _shape_batch)

    def pair_fn(x, y, z, z_ok, wctx):
        ctx = WedgeVecCtx(ex, frame, wctx, bindings, lane_flags,
                          accum_names)
        env: Dict[str, Any] = {}
        for var, role in bindings.items():
            if role == "x":
                env[var] = IdLane(x)
            elif role == "y":
                env[var] = IdLane(y)
            elif role == "z":
                env[var] = IdLane(z)
        mask = z_ok
        if kind == "wedge_batch":
            mask = mask & wctx.lane_flag("_iter")
        for fe in filters:
            mask = mask & _as_raw(veval(fe, env, ctx))
        zero = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
        for n in accum_names:
            ctx.accums[n] = torch.zeros_like(zero)
        vexec(body, env, ctx, mask)
        return tuple(ctx.accums[n] for n in accum_names)

    out_example = tuple(torch.zeros((), dtype=torch.int32,
                                    device=engine.device)
                        for _ in accum_names)
    totals = engine.count_wedges(g, pair_fn, lane_flags=lane_flags,
                                 out_example=out_example)
    if not isinstance(totals, tuple):
        totals = (totals,)
    from repro_torch.core.dsl.codegen import _set_env
    for name, total in zip(accum_names, totals):
        cur = frame.lookup(name)
        _set_env(frame, name, cur + total)


# ===========================================================================
# OnAdd / OnDelete scatters
# ===========================================================================

class ScatterCtx(VecCtx):
    """OnUpdate body: lanes are batch entries; writes scatter to props
    (or mark edge-flag lanes via batch_edge_flags)."""

    def __init__(self, ex, frame, props, n_pad, upd_kind, batch):
        super().__init__(ex, frame)
        self.props = props
        self.n_pad = n_pad
        self.upd_kind = upd_kind
        self.batch = batch
        self.edge_flag_writes: List[Tuple[str, Any, Any, Any]] = []

    def read_attr(self, obj, name, env):
        import repro_torch.core.dsl.codegen as CG
        if isinstance(obj, IdLane):
            arr = self.props.get(name)
            if arr is None:
                ref = self.frame.lookup(name)
                arr = ref.box.value
            return arr[obj.idx.clamp(0, self.n_pad - 1)]
        if isinstance(obj, _UpdateLane):
            if name == "source":
                return IdLane(self.batch.add_src if self.upd_kind == "add"
                              else self.batch.del_src)
            if name == "destination":
                return IdLane(self.batch.add_dst if self.upd_kind == "add"
                              else self.batch.del_dst)
            raise LowerError(f"update has no attribute .{name}")
        if isinstance(obj, EdgeSym):
            if name == "weight":
                if self.upd_kind == "add":
                    return self.batch.add_w
                raise LowerError("deleted edges carry no weight")
            # edge-prop read on the update edge
            ref = self.frame.lookup(name)
            import repro_torch.core.dsl.codegen as CG2
            if isinstance(ref, CG2.PropRef) and ref.is_edge:
                raise LowerError("edge-prop reads in OnUpdate are not "
                                 "supported")
        raise LowerError(f"cannot read .{name} in OnUpdate body")

    def write_attr(self, obj, name, value, mask, env):
        import repro_torch.core.dsl.codegen as CG
        if isinstance(obj, IdLane):
            self.props[name] = _scatter(self.props[name], obj.idx,
                                        _as_raw(value), mask, self.n_pad)
            return
        if isinstance(obj, EdgeSym):
            # e.modified = True on the update edge → lane flags
            if not (isinstance(value, (bool, np.bool_)) and value) and \
                    not (hasattr(value, "dtype") and bool(value.all())):
                raise LowerError("edge-prop writes must set True")
            a = env.get(_varname(obj.a))
            b = env.get(_varname(obj.b))
            self.edge_flag_writes.append((name, a.idx, b.idx, mask))
            return
        raise LowerError(f"cannot write .{name} in OnUpdate body")

    def call(self, e: A.Call, env, mask):
        if isinstance(e.func, A.Attr) and e.func.name == "get_edge":
            return EdgeSym(a=e.args[0], b=e.args[1])
        if isinstance(e.func, A.Name) and e.func.ident == "abs":
            return _abs(_as_raw(veval(e.args[0], env, self, mask)))
        raise LowerError(f"line {e.line}: unsupported call in OnUpdate")


class _UpdateLane:
    pass


def run_onupdate(ex, st: A.OnUpdate, frame):
    engine = ex.engine
    batch = frame.current_batch
    if batch is None:
        raise LowerError(f"line {st.line}: OnAdd/OnDelete outside Batch")
    props = _gather_props(ex, frame)
    ctx = ScatterCtx(ex, frame, props, engine.n_pad, st.kind, batch)
    env = {st.var: _UpdateLane()}
    mask = batch.add_mask if st.kind == "add" else batch.del_mask
    vexec(st.body.stmts, env, ctx, mask)
    _write_back(frame, ctx.props)
    # apply edge-flag lane writes
    import repro_torch.core.dsl.codegen as CG
    g = frame.graph().box.value
    for name, qs, qd, m in ctx.edge_flag_writes:
        ref = frame.lookup(name)
        flags = engine.batch_edge_flags(g, qs, qd, m)
        if ref.box.value is None:
            ref.box.value = flags
        else:
            ref.box.value = ref.box.value | flags
