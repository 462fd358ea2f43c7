"""FrontierEngine — work-efficient sparse-frontier sweeps (counterpart of
``repro.core.frontier_engine``).

Dense sweeps pay O(E) per fixed-point iteration whatever the frontier's
size.  This engine restores work efficiency with Ligra-style direction
optimisation:

* the graph keeps a push-oriented row-split ELL
  (``kernels/ell.pack_push_ell``): an active vertex maps to its out-edge
  rows, each holding at most K destinations;
* each fixed-point iteration reads the number of active rows on the host
  (one small sync, the host-driven loop of the paper's OpenMP backend):
    - more than ``sparse_frac``·R → a chunk of at most ``DENSE_CHUNK``
      dense sweeps (the ``torch`` backend's segment lowering);
    - else → a sparse step: gather the active rows (capacity the next
      power of two), compute the candidates, and scatter-min/-max them
      into the property, O(|frontier|·K + n) work instead of O(E);
* sweeps opt in by declaring ``frontier`` (the boolean source-side
  property) and a min or max ``gather_form``; every other sweep takes the
  dense lowering, so the whole algorithm suite runs unchanged.

The scatter-min combines in another order than the dense path's segment
min, and integer min is exact in any order, so results are identical.
Inside a fused stream segment the host cannot be read, so
``stream_view()`` hands steps the dense fixed point (``_DenseStreamView``)
as the reference does.  The engine launches no kernel of ``csrc/``: its
sweeps are tensor ops, as the reference's (a ``JnpEngine``) are XLA ops.
``steps`` counts the sparse steps and dense chunks it ran.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core import device_loop
from repro_torch.core.cuda_engine import StagedAdd
from repro_torch.core.engine import (Collectives, Props, TorchEngine,
                                     _StreamView, dyn_from_state, dyn_state)
from repro_torch.core.ir import EdgeSweep
from repro_torch.graph import diffcsr
from repro_torch.graph.csr import CSR, INT
from repro_torch.graph.diffcsr import DynGraph
from repro_torch.graph.updates import UpdateBatch
from repro_torch.kernels.ell import (Ell, ell_apply_add, ell_apply_del,
                                     ell_from_state, ell_revive, ell_state,
                                     pack_push_ell, pool_moved)
from repro_torch.runtime import faults as _faults

DENSE_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class FrontierHandle:
    g: DynGraph
    push: Ell


def _next_pow2(x: int) -> int:
    p = 16
    while p < x:
        p <<= 1
    return p


class _DenseStreamView(_StreamView):
    """Stream-segment facade for the FrontierEngine: the same semantics,
    but fixed points run the dense loop (no host read of the frontier)
    instead of the direction-optimised one."""

    def fixed_point(self, h, sw: EdgeSweep, props: Props, cond_fn,
                    max_iter: int) -> Props:
        return TorchEngine.fixed_point(self._engine, h, sw, props, cond_fn,
                                       max_iter)


class FrontierEngine(TorchEngine):
    name = "frontier"

    def __init__(self, k: int = 8, sparse_frac: float = 0.05, device=None):
        super().__init__(device)
        self.k = k
        self.sparse_frac = sparse_frac
        self._repack = functools.partial(pack_push_ell, k=k)
        self.steps = {"sparse": 0, "dense_chunks": 0}

    def _handle(self, g: DynGraph) -> FrontierHandle:
        return FrontierHandle(g=g, push=pack_push_ell(g, self.k))

    # -- construction / updates (repack after structural change) -----------
    def prepare(self, csr: CSR, diff_capacity: int) -> FrontierHandle:
        return self._handle(super().prepare(csr, diff_capacity))

    def merge(self, h: FrontierHandle) -> FrontierHandle:
        return self._handle(diffcsr.merge(h.g))

    def out_degrees(self, h: FrontierHandle) -> torch.Tensor:
        return h.g.out_degrees()

    # -- durable state -----------------------------------------------------
    # The push pack travels raw, so a resume keeps the saved run's slots.
    state_kind = "frontier"

    def pack_state(self, h: FrontierHandle):
        return ({"g": dyn_state(h.g), "push": ell_state(h.push)},
                {"kind": "frontier", "n": h.g.n, "k": self.k})

    def unpack_state(self, tree, meta) -> FrontierHandle:
        if meta["k"] != self.k:
            raise ValueError(
                f"checkpoint was saved with k={meta['k']} lanes per row; "
                f"this engine has k={self.k} — bind the restoring engine "
                f"with the same k (or restore cross-backend)")
        self._n = meta["n"]
        return FrontierHandle(
            g=dyn_from_state(tree["g"], meta["n"], self.device),
            push=ell_from_state(tree["push"], meta["n"], self.device))

    def update_del(self, h: FrontierHandle, batch: UpdateBatch):
        g = super().update_del(h.g, batch)
        push = ell_apply_del(h.push, h.g, batch.del_src, batch.del_dst,
                             batch.del_mask)
        return FrontierHandle(g=g, push=push)

    def update_add(self, h: FrontierHandle, batch: UpdateBatch):
        g = super().update_add(h.g, batch)
        # push layout: slots hold DESTINATIONS
        push = ell_apply_add(h.push, h.g, g, batch.add_src, batch.add_dst,
                             batch.add_w, batch.add_mask,
                             slot_value=batch.add_dst, repack=self._repack,
                             branch=device_loop.cond)
        return FrontierHandle(g=g, push=push)

    def update_stacked(self, h: FrontierHandle, batch: UpdateBatch,
                       mapped: bool = True):
        """``update_add``'s host branch left to the caller (the serving
        pool reads a group's flags in one sync): deletes first, then the
        adds into the graph; ``repack`` is the pool-moved flag."""
        h1 = self.update_del(h, batch)
        g = TorchEngine.update_add(self, h1.g, batch)
        return (StagedAdd(g=g, pre=h1), diffcsr.pool_counters(g),
                pool_moved(h1.g, g))

    def finish_stacked(self, staged: StagedAdd, batch: UpdateBatch,
                       repack: bool) -> FrontierHandle:
        """A moved pool rebuilds the push pack; otherwise the revivals,
        resolved against the pre-add graph, are patched in place (push
        slots hold destinations)."""
        if repack:
            return self._handle(staged.g)
        push = ell_revive(staged.pre.push, staged.pre.g, batch.add_src,
                          batch.add_dst, batch.add_w, batch.add_mask,
                          slot_value=batch.add_dst)
        return FrontierHandle(g=staged.g, push=push)

    def batch_edge_flags(self, h: FrontierHandle, qs, qd, mask):
        return super().batch_edge_flags(h.g, qs, qd, mask)

    def count_wedges(self, h: FrontierHandle, pair_fn, lane_flags,
                     out_example, bounds=None):
        return super().count_wedges(h.g, pair_fn, lane_flags, out_example,
                                    bounds=bounds)

    # -- stream executor hooks ---------------------------------------------
    def handle_graph(self, h: FrontierHandle) -> DynGraph:
        return h.g

    def grow(self, h: FrontierHandle, factor: float = 2.0) -> FrontierHandle:
        return self._handle(super().grow(h.g, factor))

    def compact_handle(self, h: FrontierHandle) -> FrontierHandle:
        return self._handle(diffcsr.compact(h.g))

    def stream_view(self, bounds=None):
        # the direction-optimised fixed point reads the frontier's size on
        # the host every iteration; a fused segment must stay on the
        # device, so its steps get the dense loop
        return _DenseStreamView(self, bounds)

    def sweep(self, h, sw: EdgeSweep, props: Props) -> Props:
        return self._run_sweep(h, sw, props)

    def _run_sweep(self, h, sw: EdgeSweep, props: Props) -> Props:
        g = h.g if isinstance(h, FrontierHandle) else h
        return super()._run_sweep(g, sw, props)

    # -- sparse push step --------------------------------------------------
    def _sparse_step(self, h: FrontierHandle, sw: EdgeSweep, props: Props,
                     frontier_mask, cap: int) -> Props:
        """One frontier-compacted iteration of a min/max sweep."""
        push = h.push
        n, R = self.n_pad, push.R
        row_src = push.row2dst                      # (R,) the row's SOURCE
        row_active = (row_src < n) & frontier_mask[row_src.clamp(max=n - 1)]
        rows = torch.nonzero_static(row_active, size=cap,
                                    fill_value=R)[:, 0]
        safe = rows.clamp(max=R - 1)
        srcs = torch.where(rows < R, row_src[safe], n)      # (cap,)
        dsts = push.ell_src[safe]                           # (cap, K)
        ws = push.ell_w[safe]

        (target, red), = [(t, r) for t, r in sw.reduces.items()
                          if r.kind in ("min", "max")]
        vec_fn, use_w = sw.gather_form[target]
        vec = vec_fn(props)                                 # (n,) at sources
        ident = red.identity(vec.dtype)
        vec1 = torch.cat([vec, vec.new_full((1,), ident)])
        cand = vec1[srcs.clamp(max=n)][:, None]
        if use_w:
            cand = cand + ws
        valid = (dsts < n) & (srcs < n)[:, None]
        cand = torch.where(valid, cand, ident).reshape(-1)
        tgt = torch.where(valid, dsts, n).reshape(-1).to(torch.int64)

        old = props[target]
        buf = torch.full((n + 1,), ident, dtype=old.dtype, device=old.device)
        buf.scatter_reduce_(0, tgt, cand.to(old.dtype),
                            "amin" if red.kind == "min" else "amax")
        reduced = {target: buf[:n]}
        hit = {target: buf[:n] != ident}

        # argmin ride: the smallest source reaching the reduced value
        for t2, r2 in sw.reduces.items():
            if r2.kind != "argmin":
                continue
            ach = valid.reshape(-1) & (
                cand == reduced[r2.of][dsts.clamp(max=n - 1)].reshape(-1))
            sid = torch.where(ach, srcs[:, None].expand(dsts.shape)
                              .reshape(-1), n).to(INT)
            abuf = torch.full((n + 1,), n, dtype=INT, device=old.device)
            reduced[t2] = abuf.scatter_reduce_(0, tgt, sid, "amin")[:n]
            hit[t2] = hit[r2.of]
        return sw.post_fn(props, reduced, hit)

    def _sparse_capable(self, sw: EdgeSweep) -> bool:
        if sw.frontier is None or sw.gather_form is None:
            return False
        kinds = sorted(r.kind for r in sw.reduces.values())
        return kinds in (["min"], ["argmin", "min"], ["max"])

    # -- direction-optimised fixed point -----------------------------------
    def fixed_point(self, h, sw: EdgeSweep, props: Props,
                    cond_fn: Callable, max_iter: int) -> Props:
        if not self._sparse_capable(sw):
            return super().fixed_point(h, sw, props, cond_fn, max_iter)
        col = Collectives()
        n, R = self.n_pad, h.push.R
        row_src = h.push.row2dst
        it = 0
        while it < max_iter:
            if not bool(cond_fn(props, it, col)):
                break
            fmask = props[sw.frontier]
            # active out-edge rows: one scalar host read per direction
            # check, the paper's host-driven OpenMP loop
            f_rows = int((fmask[row_src.clamp(max=n - 1)]
                          & (row_src < n)).sum())
            if f_rows > self.sparse_frac * R:
                # a big frontier: a chunk of dense sweeps, then check the
                # direction again (Ligra's dense mode)
                props = super().fixed_point(
                    h, sw, props, cond_fn,
                    max_iter=min(DENSE_CHUNK, max_iter - it))
                self.steps["dense_chunks"] += 1
                it += DENSE_CHUNK
            else:
                cap = _next_pow2(max(f_rows, 1))
                _faults.fire("kernel_launch", engine=self.name,
                             op="sparse_step", cap=cap)
                props = self._sparse_step(h, sw, props, fmask, cap)
                self.steps["sparse"] += 1
                it += 1
        return props
