"""Execution engines: one algorithm spec → several backends (counterpart
of ``repro.core.engine``).

* :class:`TorchEngine` — the plain tensor reference (``torch``), the
  counterpart of ``JnpEngine``: every edge sweep is a segment reduction
  over the flat edge lanes.
* ``CudaEngine`` (``core/cuda_engine.py``) — the hand-kernel backend.

Data-dependent loops (a fixed point, a wedge walk) go through
``core/device_loop.py``: called directly they read their condition on the
host once a trip; inside a captured stream segment they are conditional
graph nodes.  ``TorchEngine.run_stream`` is the reference's fused stream
executor: each segment of batches runs as one captured CUDA graph
(``device_loop.SegmentGraph``) on the card, batch by batch on the CPU, and
the pool counters are read once per segment.  ``Engine.run_stream`` is the
reference's per-batch baseline.  Wedge enumeration (``count_wedges``,
triangle counting) loops over a region's max degree; outside a capture
that bound is read from the card once per offsets tensor and cached on the
tensor's identity, inside one it stays on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core import device_loop
from repro_torch.core.ir import EdgeSweep, Reduce
from repro_torch.graph import diffcsr
from repro_torch.graph.csr import CSR, INT, build_csr
from repro_torch.graph.diffcsr import BOOL, DynGraph
from repro_torch.graph.updates import UpdateBatch
from repro_torch.runtime import faults as _faults
from repro_torch.tensors import (clamp_index, in_range, resolve_device,
                                 segment_max, segment_min, set_drop, take,
                                 to_device)

Props = Dict[str, torch.Tensor]

class Collectives:
    """Global reductions handed to fixed-point conditions (single device:
    plain tensor reductions)."""

    def any(self, x):
        return x.any()

    def sum(self, x):
        return x.sum()

    def max(self, x):
        return x.max()


def edge_lane_flags(g: DynGraph, qs, qd, mask=None) -> torch.Tensor:
    """Boolean flags over the (E+D,) edge lanes for a batch of edges."""
    if mask is None:
        mask = torch.ones(qs.shape, dtype=BOOL, device=qs.device)
    E, D = g.main_capacity, g.diff_capacity
    p1, f1 = diffcsr._locate_main(g, qs, qd)
    p2, f2 = diffcsr._locate_diff(g, qs, qd)
    flags = torch.zeros((E + D,), dtype=BOOL, device=g.device)
    flags = set_drop(flags, torch.where(f1 & mask, p1, E + D), True)
    return set_drop(flags, torch.where(f2 & mask & ~f1, E + p2, E + D), True)


class _StreamView:
    """Engine facade handed to stream steps inside ``run_stream``.

    Semantics are the wrapped engine's; ``count_wedges`` gets the
    segment's static bounds (``bounds``), so inside a captured segment it
    reads no max degree on the host.  Engines whose interactive paths are
    host-driven (FrontierEngine's direction optimisation) subclass it to
    swap in their dense lowering."""

    def __init__(self, engine: "Engine", bounds=None):
        self._engine = engine
        self._bounds = bounds

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def count_wedges(self, handle, pair_fn, lane_flags, out_example,
                     bounds=None):
        return self._engine.count_wedges(
            handle, pair_fn, lane_flags, out_example,
            bounds=bounds if bounds is not None else self._bounds)


class WedgeCtx:
    """Per-iteration context handed to wedge pair functions (TC)."""

    def __init__(self, g: DynGraph, lane_flags: Dict[str, torch.Tensor],
                 nbr_lane: torch.Tensor, is_edge_fn, edge_flag_fn):
        self.g = g
        self._lane_flags = lane_flags
        self._nbr_lane = nbr_lane
        self.is_edge = is_edge_fn          # (qs, qd) -> bool lanes
        self.edge_flag = edge_flag_fn      # (name, qs, qd) -> bool lanes

    def nbr_flag(self, name: str) -> torch.Tensor:
        fl = self._lane_flags[name]
        return fl[self._nbr_lane.clamp(0, fl.shape[0] - 1)]

    def lane_flag(self, name: str) -> torch.Tensor:
        return self._lane_flags[name]


class Engine:
    """Backend-neutral interface (the 'generated program' surface)."""

    name = "base"
    # True when the session admits batches unchecked (admission="off"):
    # ids outside [0, n) may then sit in the pool, and sweeps treat them
    # as JAX does (gathers clamp them, reductions drop them)
    raw_ids = False

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._n = None
        # max-degree bounds of count_wedges, keyed by region: (offsets
        # tensor, value); an update that rebuilds an offsets tensor
        # invalidates its entry by identity
        self._deg_cache: Dict[str, tuple] = {}
        # host reads of a max degree (one sync each), for the tests and
        # the smoke's sync counts
        self.deg_syncs = 0
        # segment runners of the fused stream executor, keyed by
        # (step_fn, bounds, handle shapes, batch size, batches, carry)
        self._stream_cache: Dict[Any, Any] = {}

    # -- construction ------------------------------------------------------
    def prepare(self, csr: CSR, diff_capacity: int) -> Any:
        raise NotImplementedError

    def merge(self, handle) -> Any:
        raise NotImplementedError

    @property
    def n_pad(self) -> int:
        raise NotImplementedError

    @property
    def n_real(self) -> int:
        return self._n

    def full(self, value, dtype) -> torch.Tensor:
        """Allocate a vertex property (paper: attachNodeProperty)."""
        return torch.full((self.n_pad,), value, dtype=dtype,
                          device=self.device)

    def read_props(self, props: Props) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy()[: self._n] for k, v in props.items()}

    # -- aggregate ops -----------------------------------------------------
    def sweep(self, handle, sw: EdgeSweep, props: Props) -> Props:
        raise NotImplementedError

    def fixed_point(self, handle, sw: EdgeSweep, props: Props,
                    cond_fn: Callable, max_iter: int) -> Props:
        raise NotImplementedError

    def vertex_map(self, handle, fn: Callable, props: Props) -> Props:
        raise NotImplementedError

    def count_wedges(self, handle, pair_fn, lane_flags, out_example,
                     bounds=None):
        raise NotImplementedError

    def _max_deg(self, region: str, offsets: torch.Tensor) -> int:
        """A region's max row length: one host read per offsets tensor,
        cached on the tensor's identity (updates keep ``offsets`` and
        rebuild ``d_offsets`` only when they append to the pool)."""
        cached = self._deg_cache.get(region)
        if cached is None or cached[0] is not offsets:
            deg = offsets[1:] - offsets[:-1]
            self.deg_syncs += 1
            cached = (offsets, int(deg.max()) if deg.numel() else 0)
            self._deg_cache[region] = cached
        return cached[1]

    def propagate_flags(self, handle, props: Props, flag: str,
                        max_iter: int = 1_000_000) -> Props:
        """paper: g.propagateNodeFlags — BFS-spread a boolean property to
        everything reachable from the flagged set (an ``or`` sweep to a
        fixed point)."""
        sw = EdgeSweep(
            edge_fn=lambda s, d, w: {flag: (s[flag], s[flag])},
            reduces={flag: Reduce("or")},
            post_fn=lambda p, red, hit: {
                **p,
                flag: p[flag] | red[flag],
                "_changed": red[flag] & ~p[flag],
            },
        )
        props = dict(props)
        props["_changed"] = props[flag]
        props = self.fixed_point(
            handle, sw, props,
            cond_fn=lambda p, it, col: col.any(p["_changed"]),
            max_iter=max_iter)
        props.pop("_changed")
        return props

    # -- dynamic updates ---------------------------------------------------
    def update_del(self, handle, batch: UpdateBatch):
        raise NotImplementedError

    def update_add(self, handle, batch: UpdateBatch):
        raise NotImplementedError

    def batch_edge_flags(self, handle, qs, qd, mask) -> torch.Tensor:
        raise NotImplementedError

    # -- stream executor ---------------------------------------------------
    # A stream step is the engine-neutral per-batch body
    #     step_fn(engine, handle, batch, carry) -> (handle, carry)

    def handle_graph(self, handle) -> DynGraph:
        """The DynGraph inside an engine handle (identity for raw graphs)."""
        return handle

    def handle_counters(self, handle) -> torch.Tensor:
        """(overflow, used, dead) pool counters, on device."""
        return diffcsr.pool_counters(self.handle_graph(handle))

    def grow(self, handle, factor: float = 2.0):
        """Host-side merge with grown diff capacity — the one numpy exit,
        reserved for true pool overflow."""
        raise NotImplementedError

    def compact_handle(self, handle):
        """Device-side reclamation of tombstoned diff slots."""
        raise NotImplementedError

    def update_stacked(self, handle, batch, mapped: bool = True):
        """Deletes then adds with no host read, the body that
        ``serve.batch`` maps over a session axis (``torch.func.vmap``,
        ``mapped=True``) or runs member by member.  Returns ``(staged,
        counters, repack)``: what :meth:`finish_stacked` finishes, the
        (overflow, used, dead) triple, and a 0-d bool, the host branch
        that a solo ``update_add`` takes (false here: nothing is left)."""
        h = self.update_add(self.update_del(handle, batch), batch)
        return (h, self.handle_counters(h),
                torch.zeros((), dtype=BOOL, device=self.device))

    def finish_stacked(self, staged, batch, repack: bool):
        """The handle from :meth:`update_stacked`'s ``staged``, once the
        host has read its ``repack`` flag (mapped over a group's unflagged
        members by ``serve.batch``)."""
        return staged

    def stream_view(self, bounds=None) -> "Engine":
        """The engine facade handed to stream steps (see _StreamView)."""
        return _StreamView(self, bounds)

    def static_wedge_bounds(self, handle):
        """Host-static (max main degree, diff capacity) bounds of a
        segment's wedge loops: the main offsets change only at merge and
        grow (segment boundaries); the diff region is bounded by its
        capacity.  Unlike the reference's, they read nothing on the host:
        None unless the max-degree cache already holds this main region
        (so SSSP and PageRank segments read no degree; a captured wedge
        loop without bounds computes the main region's max degree on the
        device instead)."""
        g = self.handle_graph(handle)
        cached = self._deg_cache.get("main")
        if cached is None or cached[0] is not g.offsets:
            return None
        return cached[1], g.diff_capacity

    def _static_leaves(self, handle) -> tuple:
        """The handle's leaves that no stream step writes: the main
        region's offsets, sources and destinations (deletes and revivals
        write ``alive`` and ``w``; adds go to the pool)."""
        g = self.handle_graph(handle)
        return (g.offsets, g.src, g.dst)

    def _diff_capacity(self, handle) -> int:
        return self.handle_graph(handle).diff_capacity

    def _counters(self, handle) -> Tuple[int, int, int]:
        return tuple(int(x) for x in self.handle_counters(handle).tolist())

    def _handle_shape_key(self, handle) -> tuple:
        """The handle's capacities (E_cap, D_cap): the part of a segment
        runner's key that ``grow`` invalidates."""
        g = self.handle_graph(handle)
        return (g.main_capacity, g.diff_capacity)

    def _evict_stream_cache(self, shape_key: tuple) -> None:
        """Drop the segment runners (and their captured graphs) of
        ``shape_key``: after ``grow`` they can never run again."""
        for k in [k for k in self._stream_cache if shape_key in k]:
            self._stream_cache.pop(k)

    def _stream_scan(self, step_fn, bounds, shape_key, batch_size: int,
                     count: int, carry_key: tuple, static=()):
        """The runner of one segment of ``count`` batches: a
        ``device_loop.SegmentGraph`` on the card (uncaptured at its first
        call, captured at its second), a ``device_loop.EagerSegment`` on
        the CPU.  Cached per (step_fn, bounds, handle shapes, batch size,
        count, carry shapes, main region); a new main region replaces the
        runners of the old one."""
        base = (step_fn, bounds, shape_key, batch_size, count, carry_key)
        key = base + (tuple(id(t) for t in static),)
        run = self._stream_cache.get(key)
        if run is None:
            for k in [k for k in self._stream_cache if k[:-1] == base]:
                self._stream_cache.pop(k)
            view = self.stream_view(bounds)

            def body(handle, carry, batches):
                for j in range(count):
                    handle, carry = step_fn(view, handle, batches.row(j),
                                            carry)
                return handle, carry

            if self.device.type == "cuda":
                run = device_loop.SegmentGraph(
                    body, self.handle_counters, self.device, static)
            else:
                run = device_loop.EagerSegment(body, self.handle_counters)
            self._stream_cache[key] = run
        return run

    def _segment_runner(self, step_fn, handle, carry, batch_size: int,
                        count: int):
        carry_key = tuple((tuple(t.shape), t.dtype)
                          for t in device_loop.tensors(carry))
        return self._stream_scan(
            step_fn, self.static_wedge_bounds(handle),
            self._handle_shape_key(handle), batch_size, count, carry_key,
            self._static_leaves(handle))

    def _run_stream_fused(self, handle, stream, batch_size: int, step_fn,
                          carry, segment_size: int, compact_frac: float):
        """The fused stream driver: cut the stream into segments of
        padded batches, run each through ``_segment_runner`` (on the card
        one captured graph, no host round trip between batches), and read
        the pool counters once per segment: overflow rolls the segment
        back, grows the pool (the one numpy exit) and replays it; heavy
        tombstoning compacts the pool at the segment's end."""
        nb = stream.num_batches(batch_size)
        if nb == 0:
            return handle, carry
        seg = max(1, min(segment_size or nb, nb))
        of0 = self._counters(handle)[0]
        i = 0
        while i < nb:
            k = min(seg, nb - i)
            # stacked once; a grow-and-replay reuses it
            stacked = stream.stacked(batch_size, i, k, device=self.device)
            while True:
                run = self._segment_runner(step_fn, handle, carry,
                                           batch_size, k)
                # no runner writes the handle it is given
                snap = (handle, carry)
                _faults.fire("segment_scan", engine=self.name, start=i,
                             count=k)
                handle, carry, (of, _used, dead) = run(handle, carry,
                                                       stacked)
                if of > of0:
                    # adds were dropped inside the segment: roll back,
                    # grow the pool, replay on the larger shapes
                    handle, carry = self.grow(snap[0]), snap[1]
                    of0 = 0
                    continue
                break
            of0 = of
            if dead > compact_frac * max(self._diff_capacity(handle), 1):
                handle = self.compact_handle(handle)
            i += k
        return handle, carry

    def run_stream(self, handle, stream, batch_size: int, step_fn, carry,
                   segment_size: int = 8, compact_frac: float = 0.5):
        """The reference's per-batch baseline: one counter read per batch
        (``segment_size`` has no effect, every batch is its own segment);
        overflow rolls the batch back, grows the pool and replays it.
        ``TorchEngine`` and its subclasses run the fused executor
        instead; this stays callable as ``Engine.run_stream(engine,
        ...)`` to compare the two."""
        view = self.stream_view()
        of0 = self._counters(handle)[0]
        for i in range(stream.num_batches(batch_size)):
            batch = stream.batch(i, batch_size, device=self.device)
            snap = (handle, carry)
            _faults.fire("segment_scan", engine=self.name, start=i, count=1)
            handle, carry = step_fn(view, handle, batch, carry)
            of, _used, dead = self._counters(handle)
            while of > of0:
                handle, carry = self.grow(snap[0]), snap[1]
                of0 = 0
                snap = (handle, carry)
                handle, carry = step_fn(view, handle, batch, carry)
                of, _used, dead = self._counters(handle)
            of0 = of
            if dead > compact_frac * max(self._diff_capacity(handle), 1):
                handle = self.compact_handle(handle)
        return handle, carry

    # -- durable state -----------------------------------------------------
    state_kind = "none"

    def pack_state(self, handle) -> Tuple[Dict[str, Any], dict]:
        raise NotImplementedError

    def unpack_state(self, tree: Dict[str, Any], meta: dict):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Durable-state helpers shared by every backend
# ---------------------------------------------------------------------------

_DYN_FIELDS = tuple(f.name for f in dataclasses.fields(DynGraph)
                    if f.name != "n")


def dyn_state(g: DynGraph) -> Dict[str, torch.Tensor]:
    """A DynGraph's array leaves as a flat dict (the 'dyn' tree layout)."""
    return {f: getattr(g, f) for f in _DYN_FIELDS}


def dyn_from_state(tree: Dict[str, Any], n: int, device) -> DynGraph:
    """The inverse of ``dyn_state``; leaves may be numpy arrays (as the
    reference's ``pack_state`` gives them) or tensors."""
    return DynGraph(**{f: to_device(tree[f], device) for f in _DYN_FIELDS},
                    n=n)


def state_to_csr(tree: Dict[str, Any], meta: dict,
                 device=None) -> Tuple[CSR, int]:
    """Collapse a packed state of kind 'dist', 'dyn', 'pallas' or
    'frontier' to ``(CSR, diff_capacity)``: the alive edge set survives
    exactly, the pool layout resets."""
    kind, n = meta["kind"], meta["n"]
    if kind == "dist":
        src, dst, w = (np.asarray(tree[k]) for k in ("src", "dst", "w"))
        cap = int(meta["diff_capacity"])
    elif kind in ("dyn", "pallas", "frontier"):
        g = dyn_from_state(tree if kind == "dyn" else tree["g"], n, "cpu")
        es, ed, ew, ea = (x.numpy() for x in g.edge_arrays())
        src, dst, w = es[ea], ed[ea], ew[ea]
        cap = g.diff_capacity
    else:
        raise ValueError(f"unknown packed-state kind {kind!r}")
    edges = np.stack([src, dst], axis=1) if len(src) else \
        np.zeros((0, 2), np.int64)
    return build_csr(n, edges, w, device=device), max(cap, 1)


def props_from_numpy(props: Dict[str, Any], device=None) -> Props:
    """Vertex properties from host arrays (e.g. the reference's
    ``to_host()``) onto ``device``, keeping their dtypes."""
    dev = resolve_device(device)
    return {k: to_device(v, dev) for k, v in props.items()}


# ===========================================================================
# TorchEngine — the plain tensor reference
# ===========================================================================

class TorchEngine(Engine):
    name = "torch"

    # -- construction ------------------------------------------------------
    def prepare(self, csr: CSR, diff_capacity: int) -> DynGraph:
        self._n = csr.n
        return diffcsr.from_csr(csr.to(self.device), diff_capacity)

    def merge(self, g: DynGraph) -> DynGraph:
        return diffcsr.merge(g)

    @property
    def n_pad(self) -> int:
        return self._n

    def out_degrees(self, g: DynGraph) -> torch.Tensor:
        return g.out_degrees()

    # -- durable state -----------------------------------------------------
    state_kind = "dyn"

    def pack_state(self, g: DynGraph):
        return dyn_state(g), {"kind": "dyn", "n": g.n}

    def unpack_state(self, tree, meta) -> DynGraph:
        self._n = meta["n"]
        return dyn_from_state(tree, meta["n"], self.device)

    # -- core sweep --------------------------------------------------------
    def _run_sweep(self, g: DynGraph, sw: EdgeSweep, props: Props) -> Props:
        esrc, edst, ew, ealive = g.edge_arrays()
        n = self.n_pad
        if self.raw_ids:
            gsrc, gdst = clamp_index(esrc, n), clamp_index(edst, n)
            seg, num = in_range(edst, n), n + 1
        else:
            gsrc, gdst, seg, num = esrc, edst, edst, n
        s = _View(props, gsrc)
        d = _View(props, gdst)
        out = sw.edge_fn(s, d, ew)
        reduced, hit = {}, {}
        # value reductions first, arg-reductions second (two-pass argmin)
        for target, red in sw.reduces.items():
            if red.kind == "argmin":
                continue
            val, elig = out[target]
            elig = elig & ealive
            v = torch.where(elig, val, red.identity(val.dtype))
            reduced[target] = red.segment(v, seg, num)[:n]
            hit[target] = segment_max(elig.to(INT), seg, num)[:n] > 0
        for target, red in sw.reduces.items():
            if red.kind != "argmin":
                continue
            val, elig = out[red.of]
            achieved = elig & ealive & (val == reduced[red.of][gdst])
            reduced[target] = segment_min(torch.where(achieved, esrc, n),
                                          seg, num)[:n]
            hit[target] = hit[red.of]
        return sw.post_fn(props, reduced, hit)

    def sweep(self, g: DynGraph, sw: EdgeSweep, props: Props) -> Props:
        return self._run_sweep(g, sw, props)

    def fixed_point(self, g, sw: EdgeSweep, props: Props,
                    cond_fn: Callable, max_iter: int) -> Props:
        """The reference's ``lax.while_loop`` through ``device_loop``: one
        host read of the condition per sweep, or a WHILE node inside a
        captured segment."""
        col = Collectives()
        _, props = device_loop.while_loop(
            lambda s: (s[0] < max_iter) & cond_fn(s[1], s[0], col),
            lambda s: (s[0] + 1, self._run_sweep(g, sw, s[1])),
            (0, props))
        return props

    def vertex_map(self, g, fn: Callable, props: Props) -> Props:
        return fn(props)

    # -- wedges (triangle counting) ----------------------------------------
    def count_wedges(self, g: DynGraph, pair_fn: Callable,
                     lane_flags: Dict[str, torch.Tensor], out_example,
                     bounds=None):
        """Sum ``pair_fn(x, y, z, z_ok, ctx)`` over every wedge x→y, x→z:
        each edge lane (x, y) walks x's row j = 0, 1, ... in the main
        region, then in the diff pool, up to the region's max degree.
        Outside a capture that bound comes from the cache (a host loop
        with no empty iteration); inside one, a WHILE node runs to the
        max degree computed on the device.  The reference's static
        ``bounds`` (max main degree, diff capacity) run the pool's loop to
        its capacity; the iterations past its max degree add zeros, so
        the counts are the same.  Here ``bounds[0]`` sets the main region's
        search rounds in a capture; the pool's come from its max degree on
        the device.  ``out_example`` is a 0-d tensor or a tuple of them, and
        each sum keeps its dtype: partial sums stay int32 where the
        reference's do (``torch.sum`` of int32 would give int64)."""
        esrc, edst, ew, ealive = g.edge_arrays()
        E, D = g.main_capacity, g.diff_capacity
        on_device = device_loop.capturing()
        # no row is longer than its region's max degree L, so a search in
        # it settles after L.bit_length() rounds; the reference runs 32,
        # and the rounds after a search settles change nothing.  In a
        # capture the main region's L is the static bound; the pool grows
        # inside the segment, so its searches loop on the device to the
        # bit length of its max degree there
        if on_device:
            max_main = max_diff = None
            rounds = (min(int(bounds[0]).bit_length(), 32)
                      if bounds is not None else
                      _device_rounds(_max_degree(g.offsets)),
                      _device_rounds(_max_degree(g.d_offsets)))
        else:
            max_main = self._max_deg("main", g.offsets)
            max_diff = self._max_deg("diff", g.d_offsets)
            rounds = (min(max_main.bit_length(), 32),
                      min(max_diff.bit_length(), 32))

        def is_edge_fn(qs, qd):
            return diffcsr.is_edge(g, qs, qd, rounds)

        def edge_flag_fn(name, qs, qd):
            fl = lane_flags[name]
            p1, f1 = diffcsr._locate_main(g, qs, qd, rounds[0])
            p2, f2 = diffcsr._locate_diff(g, qs, qd, rounds[1])
            r = torch.zeros(qs.shape, dtype=BOOL, device=qs.device)
            r = torch.where(f1 & g.alive[p1], fl[p1.clamp(0, E + D - 1)], r)
            return torch.where(f2 & g.d_alive[p2] & ~f1,
                               fl[(E + p2).clamp(0, E + D - 1)], r)

        single = not isinstance(out_example, tuple)
        total = tuple(torch.zeros((), dtype=x.dtype, device=self.device)
                      for x in ((out_example,) if single else out_example))
        for count, offsets, dst, alive, cap, base in (
                (max_main, g.offsets, g.dst, g.alive, E, 0),
                (max_diff if D else 0, g.d_offsets, g.d_dst, g.d_alive, D,
                 E)):
            if count == 0:
                continue
            # the row bounds of every lane's source, hoisted out of the loop
            start = take(offsets, esrc)
            end = take(offsets, esrc.to(torch.int64) + 1)

            def walk(j, tot, start=start, end=end, dst=dst, alive=alive,
                     cap=cap, base=base):
                pos = start + j
                ok = pos < end
                safe = pos.clamp(0, max(cap - 1, 0))
                z = dst[safe]
                z_ok = ok & alive[safe]
                ctx = WedgeCtx(g, lane_flags, base + safe, is_edge_fn,
                               edge_flag_fn)
                contrib = pair_fn(esrc, edst, z, z_ok & ealive, ctx)
                return tuple(t + c.sum(dtype=t.dtype) for t, c in
                             zip(tot, (contrib,) if single else contrib))

            if on_device:
                deg_max = _max_degree(offsets)
                _, total = device_loop.while_loop(
                    lambda s: s[0] < deg_max,
                    lambda s, walk=walk: (s[0] + 1, walk(s[0], s[1])),
                    (0, total))
            else:
                for j in range(count):
                    total = walk(j, total)
        return total[0] if single else total

    # -- updates -----------------------------------------------------------
    def update_del(self, g: DynGraph, batch: UpdateBatch) -> DynGraph:
        return diffcsr.update_csr_del(g, batch.del_src, batch.del_dst,
                                      batch.del_mask)

    def update_add(self, g: DynGraph, batch: UpdateBatch) -> DynGraph:
        return diffcsr.update_csr_add(g, batch.add_src, batch.add_dst,
                                      batch.add_w, batch.add_mask)

    def batch_edge_flags(self, g: DynGraph, qs, qd, mask) -> torch.Tensor:
        return edge_lane_flags(g, qs, qd, mask)

    def src_flags_from_dst(self, g: DynGraph, dst_mask) -> torch.Tensor:
        """Mark sources having an alive out-edge into the flagged dst set
        (the push-repair boundary)."""
        esrc, edst, ew, ealive = g.edge_arrays()
        n = self.n_pad
        hit = ealive & (edst < n) & dst_mask[edst.clamp(0, n - 1)]
        return set_drop(torch.zeros((n,), dtype=BOOL, device=g.device),
                        torch.where(hit, esrc, n), True)

    # -- stream executor hooks ---------------------------------------------
    def grow(self, g: DynGraph, factor: float = 2.0) -> DynGraph:
        _faults.fire("pool_merge", engine=self.name,
                     diff_capacity=g.diff_capacity)
        # the old capacity's captured segments can never run again
        self._evict_stream_cache((g.main_capacity, g.diff_capacity))
        cap = max(int(g.diff_capacity * factor), g.diff_capacity + 16)
        return diffcsr.merge(g, diff_capacity=cap)

    def compact_handle(self, g: DynGraph) -> DynGraph:
        return diffcsr.compact(g)

    def run_stream(self, handle, stream, batch_size: int, step_fn, carry,
                   segment_size: int = 8, compact_frac: float = 0.5):
        """The device-resident stream executor: every segment of batches
        is one captured CUDA graph on the card (``Engine._run_stream_fused``);
        ``Engine.run_stream`` is the per-batch baseline."""
        return self._run_stream_fused(handle, stream, batch_size, step_fn,
                                      carry, segment_size, compact_frac)


def _max_degree(offsets: torch.Tensor) -> torch.Tensor:
    """A region's max row length, on the device (0-d)."""
    return (offsets[1:] - offsets[:-1]).max()


def _device_rounds(deg_max: torch.Tensor) -> Callable:
    """``row_searchsorted``'s rounds as a device loop: ``deg_max``'s bit
    length (a count of the shifts that leave it nonzero) read by a WHILE
    node, no host read."""
    bits = ((deg_max >> torch.arange(31, device=deg_max.device)) > 0).sum()

    def loop(step, state):
        return device_loop.while_loop(
            lambda s: s[0] < bits, lambda s: (s[0] + 1, step(s[1])),
            (0, state))[1]
    return loop


class _View:
    """Gathered endpoint view (no read-logging on the hot path)."""

    __slots__ = ("_p", "_i")

    def __init__(self, props, idx):
        self._p = props
        self._i = idx

    def __getitem__(self, k):
        return self._p[k][self._i]
