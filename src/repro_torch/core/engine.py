"""Execution engines: one algorithm spec → several backends (counterpart
of ``repro.core.engine``).

* :class:`TorchEngine` — the plain tensor reference (``torch``), the
  counterpart of ``JnpEngine``: every edge sweep is a segment reduction
  over the flat edge lanes.
* ``CudaEngine`` (``core/cuda_engine.py``) — the hand-kernel backend.

Control flow runs on the host: a fixed point checks its condition with
one host sync per sweep, and ``run_stream`` reads the pool counters once
per segment of batches, as the reference's stream executor does (its
``lax.scan`` over a segment waits for CUDA graphs).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.ir import EdgeSweep, Reduce
from repro_torch.graph import diffcsr
from repro_torch.graph.csr import CSR, INT, build_csr
from repro_torch.graph.diffcsr import BOOL, DynGraph
from repro_torch.graph.updates import UpdateBatch
from repro_torch.tensors import (clamp_index, in_range, resolve_device,
                                 segment_max, segment_min, set_drop,
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
    def fixed_point(self, handle, sw: EdgeSweep, props: Props,
                    cond_fn: Callable, max_iter: int) -> Props:
        raise NotImplementedError

    def vertex_map(self, handle, fn: Callable, props: Props) -> Props:
        raise NotImplementedError

    def count_wedges(self, handle, pair_fn, lane_flags, out_example,
                     bounds=None):
        raise NotImplementedError(
            "wedge enumeration comes with triangle counting "
            "(ROADMAP Queue 1 item 7)")

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

    def _diff_capacity(self, handle) -> int:
        return self.handle_graph(handle).diff_capacity

    def _counters(self, handle) -> Tuple[int, int, int]:
        return tuple(int(x) for x in self.handle_counters(handle).tolist())

    def run_stream(self, handle, stream, batch_size: int, step_fn, carry,
                   segment_size: int = 8, compact_frac: float = 0.5):
        """The reference's segmented stream executor, dispatched batch by
        batch: the stream is cut into segments of ``segment_size``
        batches, and the pool counters are read once per segment.
        Overflow rolls the segment back to its start, grows the pool and
        replays it; heavy tombstoning compacts the pool at the segment's
        end.  (The reference runs each segment as one ``lax.scan``; a
        captured CUDA graph waits for ROADMAP Queue 1 item 9.)"""
        nb = stream.num_batches(batch_size)
        if nb == 0:
            return handle, carry
        seg = max(1, min(segment_size or nb, nb))
        of0 = self._counters(handle)[0]
        i = 0
        while i < nb:
            k = min(seg, nb - i)
            batches = [stream.batch(i + j, batch_size, device=self.device)
                       for j in range(k)]
            while True:
                snap = (handle, carry)
                for batch in batches:
                    handle, carry = step_fn(self, handle, batch, carry)
                of, _used, dead = self._counters(handle)
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

    def _stream_scan(self, *args, **kwargs):
        raise NotImplementedError(
            "the fused stream executor waits for CUDA graphs (ROADMAP "
            "Queue 1 item 9)")

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
    """Collapse a packed state of kind 'dyn' or 'pallas' to
    ``(CSR, diff_capacity)``: the alive edge set survives exactly, the
    pool layout resets."""
    kind, n = meta["kind"], meta["n"]
    if kind not in ("dyn", "pallas"):
        raise ValueError(f"unknown packed-state kind {kind!r}")
    g = dyn_from_state(tree if kind == "dyn" else tree["g"], n, "cpu")
    es, ed, ew, ea = (x.numpy() for x in g.edge_arrays())
    edges = np.stack([es[ea], ed[ea]], axis=1)
    return build_csr(n, edges, ew[ea], device=device), \
        max(g.diff_capacity, 1)


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

    def fixed_point(self, g, sw: EdgeSweep, props: Props,
                    cond_fn: Callable, max_iter: int) -> Props:
        """The reference's ``lax.while_loop``: one host sync per sweep to
        read the condition."""
        col = Collectives()
        it = 0
        while it < max_iter and bool(cond_fn(props, it, col)):
            props = self._run_sweep(g, sw, props)
            it += 1
        return props

    def vertex_map(self, g, fn: Callable, props: Props) -> Props:
        return fn(props)

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
        cap = max(int(g.diff_capacity * factor), g.diff_capacity + 16)
        return diffcsr.merge(g, diff_capacity=cap)

    def compact_handle(self, g: DynGraph) -> DynGraph:
        return diffcsr.compact(g)


class _View:
    """Gathered endpoint view (no read-logging on the hot path)."""

    __slots__ = ("_p", "_i")

    def __init__(self, props, idx):
        self._p = props
        self._i = idx

    def __getitem__(self, k):
        return self._p[k][self._i]
