"""Device control flow for stream steps — the port's ``lax.while_loop`` and
``lax.cond`` — and the captured stream segment that runs them on the card
(counterpart of the reference's ``lax.scan`` over a segment,
``repro/core/engine.py:_stream_scan``).

* Outside a capture, :func:`while_loop` reads its predicate on the host
  before every trip and :func:`cond` reads its predicate once: a Python
  loop and a Python branch, one host sync per read.
* Inside :func:`capture` on a CUDA device, each becomes device control
  flow in the graph being captured: a WHILE node whose body is captured
  once, and two IF nodes for the branches of ``cond``.  A one-thread
  kernel reads the predicate tensor and sets the node's condition
  (``kernels/graph_cond.py``); nothing reads it on the host.  Bodies are
  captured from side streams; what they allocate comes from a memory pool
  kept for the graph's life, what the capture stream allocates from the
  graph's own pool.
* Inside a capture on the CPU (a *dry* capture: the tests use it to find
  host reads left in step bodies) a loop body runs once and ``cond`` runs
  both branches and selects; no predicate is read.

State: a loop carries a tree (dict, tuple, list, frozen dataclass) whose
tensor leaves keep their shapes and dtypes from trip to trip (Python
scalars in it become 0-d tensors in a capture); ``cond``'s branches both
return a tree shaped like its operand.  In a capture that state lives in
buffers the loop owns (fixed addresses), and each trip copies its result
into them.

Launch counts: a kernel wrapper bumps its ``LAUNCHES`` entry when Python
calls it, which in a capture happens once.  A :class:`Capture` keeps what
each conditional body launched and counts on the device how many times
each body ran; :class:`SegmentGraph` adds the whole tally on every
replay, so ``LAUNCHES`` counts what the card ran.  The tallies cover
every table in ``kernels._build.LAUNCH_TABLES``, where each kernel module
registers its own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Callable

import torch

from repro_torch.kernels import graph_cond as GC
from repro_torch.kernels._build import LAUNCH_TABLES
from repro_torch.kernels.graph_cond import IF, WHILE

MAX_NODES = 4096         # conditional nodes in one captured segment
MAX_DEPTH = 2            # nesting of conditional bodies

_LOCAL = threading.local()
_STREAMS = {}            # device -> (capture stream, side streams)


def active():
    """The capture under way in this thread, or None."""
    return getattr(_LOCAL, "cap", None)


def capturing() -> bool:
    return active() is not None


@contextlib.contextmanager
def capture(cap: "Capture"):
    """Run the block with ``cap`` as this thread's capture: the loops and
    branches it reaches become conditional nodes (or, on the CPU, dry
    runs)."""
    prev = active()
    _LOCAL.cap = cap
    try:
        yield cap
    finally:
        _LOCAL.cap = prev


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------

def _is_dc(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the matching leaves
    of ``rest``); other leaves (a dataclass's ``n``, None) stay."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        if len({len(tree), *(len(r) for r in rest)}) != 1:
            raise ValueError("loop state changed its structure")
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if _is_dc(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return tree


def tensors(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _lift(tree, device):
    """Python scalars in a loop state (outside dataclasses) as 0-d
    tensors, so that the state can live on the device."""
    if isinstance(tree, bool):
        return torch.full((), tree, dtype=torch.bool, device=device)
    if isinstance(tree, int):
        return torch.full((), tree, dtype=torch.int32, device=device)
    if isinstance(tree, float):
        return torch.full((), tree, dtype=torch.float32, device=device)
    if isinstance(tree, dict):
        return {k: _lift(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_lift(v, device) for v in tree)
    return tree


def own(tree):
    """A copy of every tensor leaf: buffers at addresses of their own."""
    return tree_map(lambda t: t.clone(), tree)


def assign(bufs, new) -> list:
    """Copy ``new`` into ``bufs`` leaf by leaf (a leaf that is already its
    buffer is skipped; one that shares storage with any buffer is copied
    out first, so no copy reads a buffer written before it).  Returns the
    buffers written."""
    pairs = []

    def pair(b, x):
        if b.shape != x.shape or b.dtype != x.dtype:
            raise ValueError(f"loop state leaf changed from {b.dtype}"
                             f"{tuple(b.shape)} to {x.dtype}{tuple(x.shape)}")
        if x is not b:
            pairs.append((b, x))
        return b

    tree_map(pair, bufs, new)
    held = {t.untyped_storage().data_ptr() for t in tensors(bufs)}
    pairs = [(b, x.clone() if x.untyped_storage().data_ptr() in held else x)
             for b, x in pairs]
    for b, x in pairs:
        b.copy_(x)
    return [b for b, _ in pairs]


def _pred(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        return torch.full((), bool(x), dtype=torch.bool, device=device)
    return x.to(torch.bool).reshape(()).contiguous()


# ---------------------------------------------------------------------------
# launch tallies
# ---------------------------------------------------------------------------

def _read() -> dict:
    return {m: dict(t) for m, t in LAUNCH_TABLES.items()}


def _since(before: dict) -> dict:
    """{module: {kernel: launches}} since ``before`` (a table registered
    after it counts from 0)."""
    out = {}
    for m, t in LAUNCH_TABLES.items():
        b = before.get(m, {})
        d = {k: v - b.get(k, 0) for k, v in t.items() if v != b.get(k, 0)}
        if d:
            out[m] = d
    return out


def _reset(before: dict) -> None:
    for m, t in LAUNCH_TABLES.items():
        b = before.get(m, {})
        t.update({k: b.get(k, 0) for k in t})


def add_tally(tally: dict, times: int = 1) -> None:
    for m, d in tally.items():
        t = LAUNCH_TABLES[m]
        for k, v in d.items():
            t[k] = t.get(k, 0) + v * times


def tally_names(tally: dict) -> dict:
    """A tally as one {kernel: launches} dict."""
    return {k: v for d in tally.values() for k, v in d.items()}


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

class Capture:
    """What a capture keeps besides its kernels: a device counter of the
    runs of each conditional body (``trips``), and what each body
    launched in one run (``bodies``)."""

    def __init__(self, device, side_streams=()):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.trips = torch.zeros((MAX_NODES,), dtype=torch.int32,
                                 device=self.device)
        self.nodes = 0
        self.bodies = []          # (node, {table: launches} per table)
        self._side = list(side_streams)
        self._depth = 0

    def _node(self, kind: int, pred, negate: bool, run: Callable) -> None:
        """``run()`` as the body of a new conditional node: captured into
        the node's body graph on the card, run once inline on the CPU.
        A WHILE body's ``run`` returns the predicate of the next trip."""
        slot = self.nodes
        if slot >= MAX_NODES:
            raise RuntimeError(f"a captured segment holds at most "
                               f"{MAX_NODES} loops and branches")
        self.nodes += 1
        before = _read()
        if not self.cuda:
            run()
            self.trips[slot:slot + 1].add_(1)
        else:
            self._capture_body(slot, kind, pred, negate, run)
        self.bodies.append((slot, _since(before)))
        _reset(before)

    def _capture_body(self, slot, kind, pred, negate, run) -> None:
        if self._depth >= len(self._side):
            raise RuntimeError(f"conditional bodies nest at most "
                               f"{len(self._side)} deep")
        parent = torch.cuda.current_stream(self.device)
        side = self._side[self._depth]
        handle = GC.handle(parent)
        GC.set_condition(handle, pred, negate, parent)
        body, node = GC.add_node(parent, handle, kind)
        GC.body_begin(side, body)
        self._depth += 1
        try:
            with torch.cuda.stream(side):
                nxt = run()
                self.trips[slot:slot + 1].add_(1)
                if kind == WHILE:
                    GC.set_condition(handle, nxt, False, side)
        finally:
            self._depth -= 1
            GC.body_end(side)
        GC.node_end(parent, node)


def while_loop(cond_fn: Callable, body_fn: Callable, state):
    """``while cond_fn(state): state = body_fn(state)``; see the module
    docstring for the three modes."""
    cap = active()
    if cap is None:
        while bool(cond_fn(state)):
            state = body_fn(state)
        return state
    bufs = own(_lift(state, cap.device))
    pred = _pred(cond_fn(bufs), cap.device)

    def trip():
        assign(bufs, body_fn(bufs))
        return _pred(cond_fn(bufs), cap.device)

    cap._node(WHILE, pred, False, trip)
    return bufs


def cond(pred, true_fn: Callable, false_fn: Callable, operand):
    """``true_fn(operand)`` if ``pred`` else ``false_fn(operand)``; both
    return a tree shaped like ``operand``."""
    cap = active()
    if cap is None:
        return true_fn(operand) if bool(pred) else false_fn(operand)
    pred = _pred(pred, cap.device)
    if not cap.cuda:
        out = {}
        cap._node(IF, pred, False,
                  lambda: out.update(t=true_fn(operand)))
        cap._node(IF, pred, True,
                  lambda: out.update(f=false_fn(operand)))
        return tree_map(lambda a, b: torch.where(pred, a, b),
                        out["t"], out["f"])
    out = tree_map(torch.empty_like, operand)
    cap._node(IF, pred, False, lambda: assign(out, true_fn(operand)))
    cap._node(IF, pred, True, lambda: assign(out, false_fn(operand)))
    return out


# ---------------------------------------------------------------------------
# stream segments
# ---------------------------------------------------------------------------

def _streams(device: torch.device):
    """One capture stream and MAX_DEPTH side streams per device, made once
    (distinct streams of torch's pool, taken together)."""
    key = torch.device(device)
    if key not in _STREAMS:
        made = [torch.cuda.Stream(device=key) for _ in range(MAX_DEPTH + 1)]
        _STREAMS[key] = (made[0], made[1:])
    return _STREAMS[key]


@contextlib.contextmanager
def _no_host_reads():
    """Inside a capture a host read (``bool()``, ``.item()``, a copy to
    the host) must raise before it reaches the driver: a sync on a
    capturing stream may be recorded with garbage or abort the process.
    torch's sync debug mode "error" makes every such call raise."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class EagerSegment:
    """A segment run batch by batch from the host, then one read of the
    pool counters: every segment on the CPU, and a segment's first use on
    the card (see :class:`SegmentGraph`)."""

    graph = None

    def __init__(self, body: Callable, counters_fn: Callable):
        self.body = body
        self.counters_fn = counters_fn

    def __call__(self, handle, carry, batches):
        handle, carry = self.body(handle, carry, batches)
        return handle, carry, tuple(
            int(x) for x in self.counters_fn(handle).tolist())


class SegmentGraph:
    """One stream segment ``body(handle, carry, batches) -> (handle,
    carry)`` as a CUDA graph.  Its first call runs the body uncaptured
    (:class:`EagerSegment`): a capture costs 0.5-1.5 s on an H100 at RMAT
    scale 22 (PERF.md), which one use of a segment shape never repays.  The second call captures the
    graph and replays it; later calls replay it.

    The graph reads buffers of its own (a copy of the second call's
    handle, carry and batches; the ``static`` leaves, which no step
    writes, are shared, not copied) and writes its results back into
    them, so every replay sees the same addresses.  A call copies its
    inputs into those buffers (D2D) and returns copies of the results, so
    no handle a caller holds is ever written: a rollback to the handle a
    segment started from needs no snapshot.

    The graph ends by gathering the pool counters and the trip counts of
    its conditional nodes into one small tensor, which a call reads once
    (one host sync) and uses to add what the card ran to ``LAUNCHES``.
    Capture or replay errors raise: nothing falls back to the eager path.
    """

    def __init__(self, body: Callable, counters_fn: Callable,
                 device: torch.device, static=()):
        self.body = body
        self.counters_fn = counters_fn
        self.device = torch.device(device)
        self.first = EagerSegment(body, counters_fn)
        self.used = False
        # leaves no step writes (the main region): shared with the
        # handles, never copied; a handle with other ones needs another
        # graph
        self.static = tuple(static)
        self._keep = {id(t) for t in self.static}
        self.graph = None
        self.capture_s = None
        self.replays = 0
        self.copy_bytes = 0
        self.last_trips = ()

    def _capture(self, handle, carry, batches) -> None:
        from repro_torch.kernels import _build
        _build.load()                    # every kernel built before capture
        t0 = time.perf_counter()
        self.h_in = self._copy(handle)
        self.copy_bytes = sum(t.numel() * t.element_size()
                              for t in tensors(self.h_in)
                              if id(t) not in self._keep)
        self.c_in, self.b_in = own(carry), own(batches)
        cstream, side = _streams(self.device)
        pool = torch.cuda.graph_pool_handle()
        # the bodies' allocations (side streams): a pool of their own,
        # kept as long as the graph; the capture stream's go to the
        # graph's pool, whose routing is matched first
        self.body_pool = torch.cuda.MemPool()
        graph = torch.cuda.CUDAGraph()
        cap = Capture(self.device, side)
        before = _read()
        # the collector must not free an older graph (or its pools) while
        # this one is captured: a graph's reset there aborts the process
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=cstream):
                with torch.cuda.use_mem_pool(self.body_pool):
                    cap.trips.zero_()
                    with capture(cap), _no_host_reads():
                        h, c = self.body(self.h_in, self.c_in, self.b_in)
                    written = assign(self.h_in, h)
                    assign(self.c_in, c)
                    self.readout = torch.cat([
                        self.counters_fn(self.h_in).to(torch.int32),
                        cap.trips[:cap.nodes]])
            self.tally = _since(before)
        finally:
            if collecting:
                gc.enable()
            _reset(before)
        if any(id(t) in self._keep for t in written):
            raise RuntimeError("a stream step wrote a leaf of the main "
                               "region in place")
        self.cap, self.pool, self.graph = cap, pool, graph
        self.bodies = tuple(cap.bodies)
        self.capture_s = time.perf_counter() - t0

    def _copy(self, handle):
        return tree_map(lambda t: t if id(t) in self._keep else t.clone(),
                        handle)

    def __call__(self, handle, carry, batches):
        if self.graph is None and not self.used:
            self.used = True
            return self.first(handle, carry, batches)
        if self.graph is None:
            self._capture(handle, carry, batches)
        else:
            assign(self.h_in, handle)
            assign(self.c_in, carry)
            assign(self.b_in, batches)
        self.graph.replay()
        vals = self.readout.tolist()
        self.replays += 1
        self.last_trips = tuple(vals[3:])
        add_tally(self.tally)
        for slot, tally in self.bodies:
            add_tally(tally, vals[3 + slot])
        return self._copy(self.h_in), own(self.c_in), tuple(vals[:3])

    def launches_per_replay(self) -> dict:
        """{kernel: launches} of the last replay: the straight-line tally
        plus each body's tally times its runs."""
        out = dict(tally_names(self.tally))
        for slot, tally in self.bodies:
            for k, v in tally_names(tally).items():
                out[k] = out.get(k, 0) + v * self.last_trips[slot]
        return out
