"""Code generation: analysed AST → staged torch programs on the Engine API
(counterpart of ``repro.core.dsl.codegen``).

This is the paper's backend (§4): where StarPlat emits OpenMP / MPI /
CUDA C++, we *stage* the same aggregate constructs into the engine
interface (`repro_torch.core.engine.Engine`), so one compiled Program
runs on any of the port's backends ('torch' | 'cuda' | 'cuda_chained').
Values are torch tensors on the engine's device; Python scalars keep the
dtypes JAX gives them (bool, int32, float32), and loops the reference
stages as ``lax.while_loop`` run on the host, reading their condition
once per iteration.

Lowering map (paper construct → engine op):

  forall (v in g.nodes())           elementwise    → engine.vertex_map
  forall(v) { forall(nbr in
      g.neighbors/nodes_to(v)) }    edge sweep     → EdgeSweep + reduces
  nested wedge loops / batch+nbr    wedge sweep    → engine.count_wedges
  fixedPoint until (f : !p)         iteration      → engine.fixed_point
  do {...} while (scalar-cond)      iteration      → engine.fixed_point
  while (!f) { f=True; forall... }  iteration      → fixed_point / while
  Batch(U : bs)                     host loop over UpdateStream batches
  OnAdd/OnDelete                    masked scatters / batch_edge_flags
  g.updateCSRAdd/Del                engine.update_add/del (diff-CSR)
  g.propagateNodeFlags(p)           engine.propagate_flags
  <x.a,x.b,x.c> = <Min(..),True,v>  Reduce(min) + or-ride + argmin
  if (x.p > e) { x.p = e; x.q = v }  Reduce(min) + argmin   (race→combiner)

Races are *re-associated* into deterministic segment reductions rather
than guarded by atomics (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
import pathlib
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dsl import ast_nodes as A
from repro_torch.core.dsl.analysis import analyze
from repro_torch.core.dsl.parser import parse
from repro_torch.core.engine import Engine
from repro_torch.graph.csr import CSR, INT, INF_W
from repro_torch.graph.diffcsr import BOOL
from repro_torch.graph.updates import UpdateStream, UpdateBatch
from repro_torch.tensors import clamp_index, set_drop, to_device

F32 = torch.float32
_DTYPES = {"int": INT, "long": INT, "float": F32, "double": F32,
           "bool": BOOL}


class CodegenError(Exception):
    pass


# ---------------------------------------------------------------------------
# Runtime value wrappers
# ---------------------------------------------------------------------------

class Box:
    """Mutable cell so props passed to callees reflect writes back."""

    __slots__ = ("value",)

    def __init__(self, value=None):
        self.value = value


@dataclasses.dataclass
class PropRef:
    """A vertex- or edge-property binding (name local to this frame)."""
    name: str
    elem: str                  # 'int' | 'float' | 'bool'
    box: Box
    is_edge: bool = False

    @property
    def dtype(self):
        return _DTYPES[self.elem]


@dataclasses.dataclass
class GraphRef:
    box: Box                   # engine graph handle


@dataclasses.dataclass
class UpdatesRef:
    stream: Optional[UpdateStream]
    selector: str = "both"     # 'both' | 'del' | 'add'


@dataclasses.dataclass
class NodeIdx:
    """A node-typed value: a scalar index or a lane array of indices."""
    idx: Any


@dataclasses.dataclass
class EdgeRef:
    """edge e = g.get_edge(a, b): endpoints remembered symbolically."""
    a: Any
    b: Any
    weight: Any = None         # bound lane weights where known


@dataclasses.dataclass
class RunResult:
    g: Any
    props: Dict[str, np.ndarray]
    value: Any = None


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

class Frame:
    """Per-function environment; shares engine/graph with its caller."""

    def __init__(self, engine: Engine, parent: Optional["Frame"] = None):
        self.engine = engine
        self.env: Dict[str, Any] = {}
        self.parent = parent
        self.current_batch: Optional[UpdateBatch] = None
        self.ret = None
        if parent is not None:
            self.current_batch = parent.current_batch

    def lookup(self, name: str):
        f: Optional[Frame] = self
        while f is not None:
            if name in f.env:
                return f.env[name]
            f = f.parent
        raise CodegenError(f"undefined name {name!r}")

    def graph(self) -> GraphRef:
        for v in self.env.values():
            if isinstance(v, GraphRef):
                return v
        if self.parent:
            return self.parent.graph()
        raise CodegenError("no graph in scope")

    # -- prop helpers -------------------------------------------------------
    def node_props(self) -> Dict[str, PropRef]:
        out = {}
        f: Optional[Frame] = self
        while f is not None:
            for k, v in f.env.items():
                if isinstance(v, PropRef) and not v.is_edge and k not in out:
                    out[k] = v
            f = f.parent
        return out

    def props_arrays(self) -> Dict[str, torch.Tensor]:
        return {k: v.box.value for k, v in self.node_props().items()
                if v.box.value is not None}

    def write_back(self, props: Dict[str, torch.Tensor]):
        refs = self.node_props()
        for k, arr in props.items():
            if k in refs:
                refs[k].box.value = arr


def _is_int(x) -> bool:
    if isinstance(x, bool):
        return False
    if isinstance(x, int):
        return True
    if isinstance(x, torch.Tensor):
        return not x.dtype.is_floating_point and x.dtype != torch.bool
    if hasattr(x, "dtype"):
        return np.issubdtype(x.dtype, np.integer)
    return False


def _gather(arr: torch.Tensor, idx) -> torch.Tensor:
    """``arr[idx]`` as a JAX gather takes it (indices clamped into range);
    a scalar index gives a 0-d tensor."""
    i = torch.as_tensor(idx, device=arr.device).to(torch.int64)
    return arr[clamp_index(i, arr.shape[0])]


def _binop(op: str, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if _is_int(a) and _is_int(b):
            return a // b
        return a / b
    if op == "%":
        return a % b
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    if op == ">=":
        return a >= b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "&&":
        return a & b if hasattr(a, "dtype") or hasattr(b, "dtype") \
            else (a and b)
    if op == "||":
        return a | b if hasattr(a, "dtype") or hasattr(b, "dtype") \
            else (a or b)
    raise CodegenError(f"bad operator {op}")


# ===========================================================================
# Program
# ===========================================================================

class Program:
    """A compiled DSL program; run any function on any engine.

    ``stage(func, engine)`` is the bind-time half: it builds (and caches,
    per engine instance) a :class:`StagedFunc` holding the executor and
    its lowering caches, so repeat calls skip host-side AST
    pattern-matching and reuse the engine's jitted executables.
    ``Program.run`` remains as a deprecated one-shot shim over it — new
    code should go through :mod:`repro_torch.api` sessions.
    """

    def __init__(self, source: str):
        self.source = source
        self.ast = parse(source)
        self.infos = analyze(self.ast)

    # -- public API ----------------------------------------------------------
    def stage(self, func_name: str, engine: Engine) -> "StagedFunc":
        """Bind ``func_name`` to ``engine``: returns a fresh executable
        wrapper.  Callers that want the bind-time caches to pay off
        (``repro_torch.api.Session``) hold on to it — a StagedFunc references
        its engine, so its lifetime is the owner's, not the Program's."""
        return StagedFunc(self, func_name, engine)

    def run(self, func_name: str, engine: Engine, csr: CSR,
            args: Optional[Dict[str, Any]] = None,
            diff_capacity: int = 64) -> RunResult:
        """Deprecated one-shot execution (prepare + run + host readback).

        Kept as a thin shim over :meth:`stage` for existing callers; use
        ``repro_torch.api.compile(...).bind(...)`` instead — a Session keeps
        the graph device-resident across calls, while this shim
        re-``prepare``s the graph and syncs every property to host numpy
        on each invocation.
        """
        warnings.warn(
            "Program.run is deprecated; use repro_torch.api.compile(...)"
            ".bind(csr, backend=...) sessions instead",
            DeprecationWarning, stacklevel=2)
        g = engine.prepare(csr, diff_capacity=diff_capacity)
        g, props, ret = self.stage(func_name, engine).call(g, args)
        host = {k: v.cpu().numpy()[: engine.n_real]
                for k, v in props.items()}
        return RunResult(g=g, props=host, value=ret)


class StagedFunc:
    """One DSL function bound to one engine instance.

    The split mirrors what the paper's generated C++ gets for free from
    compilation: everything derivable from the AST alone (parameter
    binding plan, forall classification, edge-sweep plans) is computed
    once here and cached on the executor; per-call work is only the
    actual staged execution against a graph handle.
    """

    def __init__(self, program: Program, func_name: str, engine: Engine):
        self.program = program
        self.func_name = func_name
        self.func = program.ast.func(func_name)
        self.engine = engine
        self.executor = Executor(program, engine)
        # params an *armed* run may omit: the update stream itself plus
        # the batch-size names the (bypassed) Batch statements read
        self._armable = {st.batch_size for st in A.walk(self.func.body)
                         if isinstance(st, A.BatchStmt)}

    # -- parameter binding ---------------------------------------------------
    def bind_frame(self, g, args: Optional[Dict[str, Any]],
                   armed: bool = False) -> Tuple["Frame", Box]:
        args = dict(args or {})
        frame = Frame(self.engine)
        gbox = Box(g)
        for p in self.func.params:
            t = p.type
            if t.name == "Graph":
                frame.env[p.name] = GraphRef(gbox)
            elif t.is_prop:
                frame.env[p.name] = PropRef(
                    p.name, _elem(t), Box(None), is_edge=t.name == "propEdge")
            elif t.name == "updates":
                stream = args.pop(p.name, None)
                if isinstance(stream, UpdatesRef):
                    frame.env[p.name] = stream
                else:
                    frame.env[p.name] = UpdatesRef(stream)
                if stream is None and not armed:
                    raise CodegenError(
                        f"{self.func_name}: missing updates arg {p.name!r}")
            elif p.name in args:
                frame.env[p.name] = args.pop(p.name)
            elif armed and p.name in self._armable:
                frame.env[p.name] = None
            else:
                raise CodegenError(
                    f"{self.func_name}: missing arg {p.name!r}")
        if args:
            raise CodegenError(f"unused args: {sorted(args)}")
        return frame, gbox

    # -- call-time execution -------------------------------------------------
    def call(self, g, args: Optional[Dict[str, Any]] = None):
        """One-shot execution against an existing handle ``g``; returns
        ``(new_handle, device_props, return_value)`` — no host syncs."""
        frame, gbox = self.bind_frame(g, args)
        self.executor.exec_block(self.func.body, frame)
        return gbox.value, frame.props_arrays(), frame.ret

    def begin(self, g, args: Optional[Dict[str, Any]] = None) -> "ArmedRun":
        """Incremental execution: run the prologue (everything before the
        ``Batch`` statement), then hand back an :class:`ArmedRun` whose
        ``apply(batch)`` executes the Batch body one ΔG batch at a time
        against the live frame — the long-lived streaming-consumer mode.
        """
        frame, gbox = self.bind_frame(g, args, armed=True)
        stmts = self.func.body.stmts
        batch_idx = next((i for i, s in enumerate(stmts)
                          if isinstance(s, A.BatchStmt)), None)
        if batch_idx is None:
            raise CodegenError(
                f"{self.func_name} has no Batch statement; use call()")
        for st in stmts[:batch_idx]:
            if frame.ret is not None:
                break
            self.executor.exec_stmt(st, frame)
        return ArmedRun(self, frame, gbox, stmts[batch_idx],
                        stmts[batch_idx + 1:])


class ArmedRun:
    """A Dyn* function paused at its ``Batch`` loop, state held live.

    ``apply`` replays exactly what ``Executor.exec_batch`` does for one
    batch, so N applies are bit-identical to a one-shot run over the
    same N batches.  ``snapshot``/``restore`` save and roll back every
    mutable cell (graph box, property boxes, host scalars) — the
    grow-on-overflow backstop in ``repro_torch.api.Session`` uses them to
    replay a batch after growing the diff pool.
    """

    def __init__(self, staged: StagedFunc, frame: "Frame", gbox: Box,
                 batch_stmt: A.BatchStmt, epilogue: List[A.Stmt]):
        self.staged = staged
        self.frame = frame
        self.gbox = gbox
        self.batch_stmt = batch_stmt
        self.epilogue = epilogue

    @property
    def returned(self) -> bool:
        """True once a batch body hit a ``return`` — the Batch loop is
        over, exactly as ``exec_batch`` would have stopped it."""
        return self.frame.ret is not None

    def apply(self, batch: UpdateBatch) -> None:
        if self.returned:
            raise CodegenError(f"{self.staged.func_name} already returned; "
                               f"no further batches can be applied")
        inner = Frame(self.staged.engine, parent=self.frame)
        inner.current_batch = batch
        self.staged.executor.exec_block(self.batch_stmt.body, inner)
        if inner.ret is not None:
            self.frame.ret = inner.ret

    def value(self):
        """The function's return value as of the current state.  The
        post-Batch epilogue is evaluated under a snapshot/restore, so
        reading it never disturbs the live state — even for epilogues
        with assignments or property writes."""
        if self.frame.ret is not None:
            return self.frame.ret
        if not self.epilogue:
            return None
        snap = self.snapshot()
        try:
            child = Frame(self.staged.engine, parent=self.frame)
            for st in self.epilogue:
                if child.ret is not None:
                    break
                self.staged.executor.exec_stmt(st, child)
            return child.ret
        finally:
            self.restore(snap)

    def device_props(self) -> Dict[str, Any]:
        return self.frame.props_arrays()

    # -- rollback support ----------------------------------------------------
    def snapshot(self):
        boxes = {}
        f: Optional[Frame] = self.frame
        envs = []
        while f is not None:
            envs.append((f, dict(f.env)))
            for v in f.env.values():
                if isinstance(v, PropRef):
                    boxes[v.box] = v.box.value
            f = f.parent
        return envs, boxes, self.gbox.value, self.frame.ret

    def restore(self, snap) -> None:
        envs, boxes, g, ret = snap
        for f, env in envs:
            f.env.clear()
            f.env.update(env)
        for box, val in boxes.items():
            box.value = val
        self.gbox.value = g
        self.frame.ret = ret

    # -- durable form (DESIGN.md §5: armed-frame serialization) --------------
    def serialize(self) -> Tuple[Dict[str, Any], dict]:
        """The armed loop position as ``(arrays, meta)``: a flat dict of
        array leaves plus JSON-able metadata describing every frame
        binding by kind.  ``deserialize`` rebuilds the paused loop from
        this WITHOUT re-running the prologue — the durable counterpart
        of ``snapshot()`` (which holds live Python objects)."""
        arrays: Dict[str, Any] = {}
        env_meta: Dict[str, dict] = {}
        for name, v in self.frame.env.items():
            if isinstance(v, GraphRef):
                env_meta[name] = {"kind": "graph"}
            elif isinstance(v, UpdatesRef):
                if v.stream is not None:
                    raise CodegenError(
                        f"armed frame binds a live update stream "
                        f"{name!r}; only stream-less (armed) frames "
                        f"serialize")
                env_meta[name] = {"kind": "updates", "selector": v.selector}
            elif isinstance(v, PropRef):
                env_meta[name] = {"kind": "prop", "elem": v.elem,
                                  "is_edge": v.is_edge,
                                  "bound": v.box.value is not None}
                if v.box.value is not None:
                    arrays[f"prop_{name}"] = v.box.value
            elif isinstance(v, NodeIdx):
                if hasattr(v.idx, "dtype"):
                    arrays[f"node_{name}"] = v.idx
                    env_meta[name] = {"kind": "node_array"}
                else:
                    env_meta[name] = {"kind": "node", "value": int(v.idx)}
            elif v is None:
                env_meta[name] = {"kind": "none"}
            elif isinstance(v, (bool, int, float, str)):
                env_meta[name] = {"kind": "py", "value": v}
            elif hasattr(v, "dtype"):
                arrays[f"val_{name}"] = v
                env_meta[name] = {"kind": "array"}
            else:
                raise CodegenError(
                    f"cannot serialize armed binding {name!r} of type "
                    f"{type(v).__name__}")
        ret = self.frame.ret
        if ret is None:
            ret_meta = {"kind": "none"}
        elif hasattr(ret, "dtype"):
            arrays["__ret__"] = ret
            ret_meta = {"kind": "array"}
        else:
            ret_meta = {"kind": "py", "value": ret}
        meta = {"func": self.staged.func_name,
                "batch_idx": self.staged.func.body.stmts.index(
                    self.batch_stmt),
                "env": env_meta, "ret": ret_meta}
        return arrays, meta

    @classmethod
    def deserialize(cls, staged: StagedFunc, g, arrays: Dict[str, Any],
                    meta: dict) -> "ArmedRun":
        """Rebuild a paused Batch loop from ``serialize()`` output.  The
        prologue is NOT re-executed — the frame env is repopulated
        directly, and the graph box wraps the caller's restored handle
        ``g`` (shared with the owning session)."""
        if meta["func"] != staged.func_name:
            raise CodegenError(
                f"checkpoint armed {meta['func']!r}, staged function is "
                f"{staged.func_name!r}")
        frame = Frame(staged.engine)
        gbox = Box(g)
        put = lambda a: to_device(a, staged.engine.device)
        for name, m in meta["env"].items():
            kind = m["kind"]
            if kind == "graph":
                frame.env[name] = GraphRef(gbox)
            elif kind == "updates":
                frame.env[name] = UpdatesRef(None, m.get("selector", "both"))
            elif kind == "prop":
                ref = PropRef(name, m["elem"], Box(None),
                              is_edge=m["is_edge"])
                if m["bound"]:
                    ref.box.value = put(arrays[f"prop_{name}"]).to(
                        ref.dtype)
                frame.env[name] = ref
            elif kind == "node":
                frame.env[name] = NodeIdx(m["value"])
            elif kind == "node_array":
                frame.env[name] = NodeIdx(put(arrays[f"node_{name}"]))
            elif kind == "none":
                frame.env[name] = None
            elif kind == "py":
                frame.env[name] = m["value"]
            elif kind == "array":
                frame.env[name] = put(arrays[f"val_{name}"])
            else:
                raise CodegenError(f"unknown serialized binding kind "
                                   f"{kind!r} for {name!r}")
        rm = meta["ret"]
        frame.ret = (None if rm["kind"] == "none" else
                     put(arrays["__ret__"]) if rm["kind"] == "array"
                     else rm["value"])
        stmts = staged.func.body.stmts
        bi = meta["batch_idx"]
        if not (0 <= bi < len(stmts) and isinstance(stmts[bi], A.BatchStmt)):
            raise CodegenError(
                f"checkpoint batch_idx {bi} does not name a Batch "
                f"statement in {staged.func_name!r} — program source "
                f"changed since the save")
        return cls(staged, frame, gbox, stmts[bi], stmts[bi + 1:])


def _elem(t: A.Type) -> str:
    return {"int": "int", "long": "int", "float": "float",
            "double": "float", "bool": "bool"}[t.arg]


def compile_source(source_or_path: str) -> Program:
    """Compile DSL text (or a path to a .sp file) into a Program."""
    p = pathlib.Path(str(source_or_path))
    if str(source_or_path).endswith(".sp") and p.exists():
        source_or_path = p.read_text()
    return Program(str(source_or_path))


# ===========================================================================
# Executor: host-level statement interpretation
# ===========================================================================

class Executor:
    def __init__(self, prog: Program, engine: Engine):
        self.prog = prog
        self.engine = engine
        # bind-time lowering cache: AST-only analyses (forall
        # classification, edge-sweep plans, wedge shapes) keyed on node
        # identity — repeat calls through one StagedFunc skip the
        # pattern-matching interpretation entirely.
        self.stage_cache: Dict[Any, Any] = {}

    def staged(self, key, build: Callable[[], Any]):
        """Memoize an AST-only lowering artifact under ``key``."""
        try:
            return self.stage_cache[key]
        except KeyError:
            val = self.stage_cache[key] = build()
            return val

    # -- blocks / statements --------------------------------------------------
    def exec_block(self, block: A.Block, frame: Frame):
        for st in block.stmts:
            if frame.ret is not None:
                return
            self.exec_stmt(st, frame)

    def exec_stmt(self, st: A.Stmt, frame: Frame):
        if isinstance(st, A.Decl):
            self.exec_decl(st, frame)
        elif isinstance(st, A.Assign):
            self.exec_assign(st, frame)
        elif isinstance(st, A.CallStmt):
            self.eval_host(st.call, frame)
        elif isinstance(st, A.Return):
            frame.ret = self.eval_host(st.value, frame)
        elif isinstance(st, A.If):
            cond = self.eval_host(st.cond, frame)
            if bool(cond):
                self.exec_block(st.then, frame)
            elif st.orelse is not None:
                self.exec_block(st.orelse, frame)
        elif isinstance(st, A.ForAll):
            run_forall(self, st, frame)
        elif isinstance(st, A.FixedPoint):
            run_loop(self, st.body.stmts, frame, kind="fixedPoint",
                     flag=st.flag, cond=st.cond)
        elif isinstance(st, A.DoWhile):
            run_loop(self, st.body.stmts, frame, kind="do", cond=st.cond)
        elif isinstance(st, A.While):
            run_loop(self, st.body.stmts, frame, kind="while", cond=st.cond)
        elif isinstance(st, A.BatchStmt):
            self.exec_batch(st, frame)
        elif isinstance(st, A.OnUpdate):
            run_onupdate(self, st, frame)
        else:
            raise CodegenError(f"line {st.line}: unsupported statement "
                               f"{type(st).__name__}")

    def exec_decl(self, st: A.Decl, frame: Frame):
        t = st.type
        if t.is_prop:
            frame.env[st.name] = PropRef(st.name, _elem(t), Box(None),
                                         is_edge=t.name == "propEdge")
        elif t.name == "updates":
            v = self.eval_host(st.init, frame) if st.init else None
            frame.env[st.name] = v
        elif t.name == "node":
            v = self.eval_host(st.init, frame) if st.init else 0
            frame.env[st.name] = NodeIdx(v) if not isinstance(v, NodeIdx) \
                else v
        elif t.name == "edge":
            frame.env[st.name] = self.eval_host(st.init, frame)
        else:
            v = self.eval_host(st.init, frame) if st.init is not None else 0
            if t.name in ("float", "double"):
                v = float(v) if not hasattr(v, "dtype") else v.to(F32)
            frame.env[st.name] = v

    def exec_assign(self, st: A.Assign, frame: Frame):
        if isinstance(st.target, A.Name):
            name = st.target.ident
            cur = None
            try:
                cur = frame.lookup(name)
            except CodegenError:
                pass
            val = self.eval_host(st.value, frame)
            if isinstance(cur, PropRef):
                # whole-property copy: pageRank = pageRank_nxt
                if isinstance(val, PropRef):
                    val = val.box.value
                cur.box.value = val
                return
            if st.op == "+=":
                val = _binop("+", cur, val)
            elif st.op == "-=":
                val = _binop("-", cur, val)
            _set_env(frame, name, val)
            return
        if isinstance(st.target, A.Attr):
            # host-level scatter: src.modified = True (src: scalar node)
            obj = self.eval_host(st.target.obj, frame)
            pname = st.target.name
            ref = frame.lookup(pname)
            if not isinstance(ref, PropRef):
                raise CodegenError(f"line {st.line}: {pname} not a property")
            idx = obj.idx if isinstance(obj, NodeIdx) else obj
            val = self.eval_host(st.value, frame)
            if isinstance(val, NodeIdx):
                val = val.idx
            arr = ref.box.value
            i = torch.as_tensor(idx, device=arr.device).to(torch.int64)
            ref.box.value = set_drop(arr, i.reshape(-1),
                                     _as_tensor(val, arr.dtype, arr.device))
            return
        raise CodegenError(f"line {st.line}: bad assignment")

    def exec_batch(self, st: A.BatchStmt, frame: Frame):
        ups = frame.lookup(st.updates)
        if not isinstance(ups, UpdatesRef):
            raise CodegenError(f"line {st.line}: {st.updates} is not "
                               f"an updates<g> value")
        bs = frame.lookup(st.batch_size)
        for batch in ups.stream.batches(int(bs),
                                        device=self.engine.device):
            inner = Frame(self.engine, parent=frame)
            inner.current_batch = batch
            self.exec_block(st.body, inner)
            if inner.ret is not None:
                frame.ret = inner.ret
                return

    # -- host expression evaluation -----------------------------------------
    def eval_host(self, e: A.Expr, frame: Frame):
        if isinstance(e, A.Num):
            return e.value
        if isinstance(e, A.Bool):
            return e.value
        if isinstance(e, A.Inf):
            return INF_W
        if isinstance(e, A.Name):
            return frame.lookup(e.ident)
        if isinstance(e, A.Unary):
            v = self.eval_host(e.operand, frame)
            return (not v) if e.op == "!" else (-v)
        if isinstance(e, A.Binary):
            a = self.eval_host(e.left, frame)
            b = self.eval_host(e.right, frame)
            if isinstance(a, NodeIdx):
                a = a.idx
            if isinstance(b, NodeIdx):
                b = b.idx
            return _binop(e.op, a, b)
        if isinstance(e, A.MinMax):
            vals = [self.eval_host(a, frame) for a in e.args]
            return min(vals) if e.op == "Min" else max(vals)
        if isinstance(e, A.Attr):
            obj = self.eval_host(e.obj, frame)
            if isinstance(obj, NodeIdx):
                ref = frame.lookup(e.name)
                if isinstance(ref, PropRef):
                    return _gather(ref.box.value, obj.idx)
            raise CodegenError(f"line {e.line}: bad attribute {e.name}")
        if isinstance(e, A.Call):
            return self.eval_call(e, frame)
        raise CodegenError(f"line {e.line}: cannot evaluate "
                           f"{type(e).__name__}")

    def eval_call(self, e: A.Call, frame: Frame):
        eng = self.engine
        # method calls g.X(...) / updates.currentBatch(...)
        if isinstance(e.func, A.Attr):
            base = self.eval_host(e.func.obj, frame)
            m = e.func.name
            if isinstance(base, GraphRef):
                return self.graph_method(base, m, e, frame)
            if isinstance(base, UpdatesRef) and m == "currentBatch":
                sel = "both"
                if e.args:
                    sel = "del" if self.eval_host(e.args[0], frame) == 0 \
                        else "add"
                return UpdatesRef(base.stream, selector=sel)
            raise CodegenError(f"line {e.line}: unknown method {m}")
        # free functions
        assert isinstance(e.func, A.Name)
        fname = e.func.ident
        if fname == "abs":
            return _abs(self.eval_host(e.args[0], frame))
        if fname in self.prog.infos:
            return self.call_function(fname, e.args, frame)
        raise CodegenError(f"line {e.line}: unknown function {fname}")

    def graph_method(self, gref: GraphRef, m: str, e: A.Call, frame: Frame):
        eng = self.engine
        if m == "num_nodes":
            return eng.n_real
        if m == "count_outNbrs":
            x = self.eval_host(e.args[0], frame)
            idx = x.idx if isinstance(x, NodeIdx) else x
            return _gather(eng.out_degrees(gref.box.value), idx)
        if m in ("attachNodeProperty", "attachEdgeProperty"):
            for kw in e.args:
                if not isinstance(kw, A.Kwarg):
                    raise CodegenError(f"line {e.line}: attach* takes "
                                       f"name=value arguments")
                ref = frame.lookup(kw.name)
                val = self.eval_host(kw.value, frame)
                if isinstance(val, NodeIdx):
                    val = val.idx
                if ref.is_edge:
                    if val not in (False, 0):
                        raise CodegenError(f"line {e.line}: edge props "
                                           f"initialize to False")
                    # empty query → an all-False lane array in whatever
                    # lane layout this engine uses (sharded for dist)
                    z = torch.zeros((1,), dtype=INT, device=eng.device)
                    ref.box.value = eng.batch_edge_flags(
                        gref.box.value, z, z, z.to(BOOL))
                else:
                    ref.box.value = eng.full(val, ref.dtype)
            return None
        if m == "updateCSRDel":
            gref.box.value = eng.update_del(gref.box.value,
                                            self._cur_batch(frame, e))
            return None
        if m == "updateCSRAdd":
            gref.box.value = eng.update_add(gref.box.value,
                                            self._cur_batch(frame, e))
            return None
        if m == "propagateNodeFlags":
            flag = e.args[0]
            assert isinstance(flag, A.Name)
            ref = frame.lookup(flag.ident)
            props = frame.props_arrays()
            props = eng.propagate_flags(gref.box.value, props, flag.ident)
            frame.write_back(props)
            return None
        if m == "get_edge":
            a = self.eval_host(e.args[0], frame)
            b = self.eval_host(e.args[1], frame)
            return EdgeRef(a=a, b=b)
        raise CodegenError(f"line {e.line}: unsupported graph method {m}")

    def _cur_batch(self, frame: Frame, e) -> UpdateBatch:
        b = frame.current_batch
        if b is None:
            raise CodegenError(f"line {e.line}: updateCSR* outside Batch")
        return b

    # -- user function calls ---------------------------------------------------
    def call_function(self, fname: str, arg_exprs: List[A.Expr],
                      frame: Frame):
        func = self.prog.ast.func(fname)
        if len(arg_exprs) != len(func.params):
            raise CodegenError(f"call {fname}: arity mismatch")
        callee = Frame(self.engine)
        callee.current_batch = frame.current_batch
        for p, ae in zip(func.params, arg_exprs):
            val = self.eval_host(ae, frame)
            if p.type.is_prop:
                if not isinstance(val, PropRef):
                    raise CodegenError(
                        f"call {fname}: param {p.name} expects a property")
                # rebind under the callee's name, sharing the Box
                callee.env[p.name] = PropRef(p.name, val.elem, val.box,
                                             val.is_edge)
            elif p.type.name == "Graph":
                callee.env[p.name] = val
            elif p.type.name == "updates":
                callee.env[p.name] = val
            elif p.type.name == "node":
                callee.env[p.name] = val if isinstance(val, NodeIdx) \
                    else NodeIdx(val)
            else:
                callee.env[p.name] = val
        self.exec_block(func.body, callee)
        return callee.ret


def _set_env(frame: Frame, name: str, val):
    f: Optional[Frame] = frame
    while f is not None:
        if name in f.env:
            f.env[name] = val
            return
        f = f.parent
    frame.env[name] = val


# the sweep/loop/wedge/onupdate lowerings live in a sibling module to keep
# file sizes reviewable; import at the bottom to avoid cycles.
from repro_torch.core.dsl.lowering import (    # noqa: E402
    _abs, _as_tensor, run_forall, run_loop, run_onupdate)
