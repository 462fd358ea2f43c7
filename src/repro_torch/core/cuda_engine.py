"""CudaEngine — the hand-kernel backend, the counterpart of
``repro.core.pallas_engine.PallasEngine``, in its two regimes:

* fused (``cuda``, the default): a sweep that declares a ``gather_form``
  with a min (plus argmin) reduction runs as ONE ``fused_relax_rows``
  launch over the ELL pack, a sum sweep (PageRank) as one
  ``fused_spmv_rows`` launch (``kernels/repair.py``); ``update_add``
  folds the admitted batch into the sorted diff pool with the
  ``merge_pool_sorted`` kernel.
* chained (``cuda_chained``, ``fused=False``): the per-op kernel chain
  of ``kernels/csr_relax.py`` — ``relax_rowmin`` → vertex combine →
  ``relax_rowargmin`` for SSSP, ``spmv_rowsum`` for PageRank — and the
  TorchEngine's scatter path for ``update_add``.

Every other sweep takes the TorchEngine's segment reductions, as in the
reference: the DSL's sweeps declare no ``gather_form``
(``core/dsl/lowering.py: build_edge_sweep``), so they all go there.
Wedge enumeration (triangle counting) runs the TorchEngine's on the
handle's graph; it launches no kernel.  The ELL pack stays resident
across batches: deletions and revivals patch their slots, only appends
to the diff pool rebuild it.

On CPU tensors the kernel wrappers run their plain versions, which is
how the tests hold this engine against the reference without a card.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import device_loop
from repro_torch.core.engine import (Props, TorchEngine, dyn_from_state,
                                     dyn_state)
from repro_torch.core.ir import EdgeSweep
from repro_torch.graph import diffcsr
from repro_torch.graph.csr import CSR, INT
from repro_torch.graph.diffcsr import DynGraph
from repro_torch.graph.updates import UpdateBatch
from repro_torch.kernels import ops as kops
from repro_torch.kernels import repair as FK
from repro_torch.kernels.ell import (Ell, ell_apply_add, ell_apply_del,
                                     ell_from_state, ell_revive, ell_state,
                                     pack_ell, pool_moved)
from repro_torch.runtime import faults as _faults
from repro_torch.tensors import in_range, segment_max


@dataclasses.dataclass(frozen=True)
class CudaHandle:
    g: DynGraph
    ell: Ell


@dataclasses.dataclass(frozen=True)
class StagedAdd:
    """A batch staged by ``update_stacked`` (``CudaEngine``,
    ``FrontierEngine``): the graph after its adds, and the handle (graph
    and pack) after its deletes."""
    g: DynGraph
    pre: object


class CudaEngine(TorchEngine):
    name = "cuda"

    def __init__(self, k: int = 8, fused: bool = True, device=None,
                 autotune: bool = False):
        super().__init__(device)
        self.k = k
        self.fused = fused
        self.autotune = autotune     # measure the row blocks vs. heuristic
        self._repack = functools.partial(pack_ell, k=k)

    def _config(self, g: DynGraph) -> FK.RepairConfig:
        return FK.repair_config(g.n, g.main_capacity + g.diff_capacity,
                                self.k, measure=self.autotune,
                                device=self.device)

    def _handle(self, g: DynGraph) -> CudaHandle:
        return CudaHandle(g=g, ell=pack_ell(g, self.k))

    # -- construction / updates --------------------------------------------
    def prepare(self, csr: CSR, diff_capacity: int) -> CudaHandle:
        return self._handle(super().prepare(csr, diff_capacity))

    def merge(self, h: CudaHandle) -> CudaHandle:
        return self._handle(diffcsr.merge(h.g))

    def out_degrees(self, h: CudaHandle) -> torch.Tensor:
        return h.g.out_degrees()

    # -- durable state -----------------------------------------------------
    # The Ell pack is saved raw: repacking would reassign slots.  The tree
    # layout is the reference PallasEngine's, so state crosses over.
    state_kind = "pallas"

    def pack_state(self, h: CudaHandle):
        return ({"g": dyn_state(h.g), "ell": ell_state(h.ell)},
                {"kind": "pallas", "n": h.g.n, "k": self.k})

    def unpack_state(self, tree, meta) -> CudaHandle:
        if meta["k"] != self.k:
            raise ValueError(
                f"checkpoint was saved with k={meta['k']} lanes per row; "
                f"this engine has k={self.k} — bind the restoring engine "
                f"with the same k (or restore cross-backend)")
        self._n = meta["n"]
        return CudaHandle(g=dyn_from_state(tree["g"], meta["n"], self.device),
                          ell=ell_from_state(tree["ell"], meta["n"],
                                             self.device))

    def update_del(self, h: CudaHandle, batch: UpdateBatch) -> CudaHandle:
        g = super().update_del(h.g, batch)
        ell = ell_apply_del(h.ell, h.g, batch.del_src, batch.del_dst,
                            batch.del_mask)
        return CudaHandle(g=g, ell=ell)

    def _add_graph(self, g: DynGraph, batch: UpdateBatch, pool_merge):
        # both regimes launch kernels here (fused: the merge-path pool
        # fold; chained: the ELL pack update after it), so the chaos seam
        # sits above the branch; ctx carries `fused` for targeting
        _faults.fire("kernel_launch", engine=self.name, fused=self.fused,
                     op="update_add")
        if self.fused:
            # one merge-path launch folds the admitted batch into the pool
            return diffcsr.update_csr_add(g, batch.add_src, batch.add_dst,
                                          batch.add_w, batch.add_mask,
                                          pool_merge=pool_merge)
        return super().update_add(g, batch)

    def update_add(self, h: CudaHandle, batch: UpdateBatch) -> CudaHandle:
        g = self._add_graph(h.g, batch, FK.merge_pool_sorted)
        # pull layout: slots hold SOURCES
        ell = ell_apply_add(h.ell, h.g, g, batch.add_src, batch.add_dst,
                            batch.add_w, batch.add_mask,
                            slot_value=batch.add_src, repack=self._repack,
                            branch=device_loop.cond)
        return CudaHandle(g=g, ell=ell)

    def update_stacked(self, h: CudaHandle, batch: UpdateBatch,
                       mapped: bool = True):
        """``update_add``'s host branch left to the caller: ``staged``
        holds the graph after the adds and the handle before them, and
        ``repack`` is the pool-moved flag.  Mapped over a session axis,
        the merge goes through its custom op (``FK.merge_pool_sorted_op``,
        whose vmap rule launches the batched kernel once for the axis);
        member by member, through the solo wrapper (a custom op's first
        direct call imports torch's compiler stack)."""
        h1 = self.update_del(h, batch)
        g = self._add_graph(h1.g, batch, FK.merge_pool_sorted_op if mapped
                            else FK.merge_pool_sorted)
        return (StagedAdd(g=g, pre=h1), diffcsr.pool_counters(g),
                pool_moved(h1.g, g))

    def finish_stacked(self, staged: StagedAdd, batch: UpdateBatch,
                       repack: bool) -> CudaHandle:
        """A moved pool is repacked; otherwise only now are the revivals
        resolved against the pre-add graph and patched, so no member
        whose pack is rebuilt pays for them."""
        if repack:
            return self._handle(staged.g)
        ell = ell_revive(staged.pre.ell, staged.pre.g, batch.add_src,
                         batch.add_dst, batch.add_w, batch.add_mask,
                         slot_value=batch.add_src)
        return CudaHandle(g=staged.g, ell=ell)

    def batch_edge_flags(self, h: CudaHandle, qs, qd, mask):
        return super().batch_edge_flags(h.g, qs, qd, mask)

    def count_wedges(self, h: CudaHandle, pair_fn, lane_flags, out_example,
                     bounds=None):
        return super().count_wedges(h.g, pair_fn, lane_flags, out_example,
                                    bounds=bounds)

    def sweep(self, h: CudaHandle, sw: EdgeSweep, props: Props) -> Props:
        return self._run_sweep(h, sw, props)

    # -- stream executor hooks ---------------------------------------------
    def handle_graph(self, h: CudaHandle) -> DynGraph:
        return h.g

    def grow(self, h: CudaHandle, factor: float = 2.0) -> CudaHandle:
        return self._handle(super().grow(h.g, factor))

    def compact_handle(self, h: CudaHandle) -> CudaHandle:
        return self._handle(diffcsr.compact(h.g))

    # -- kernelized sweep ----------------------------------------------------
    def _kernel_compatible(self, sw: EdgeSweep) -> bool:
        if sw.gather_form is None:
            return False
        kinds = sorted(r.kind for r in sw.reduces.values())
        return kinds in (["min"], ["argmin", "min"], ["sum"])

    def _run_sweep(self, h, sw: EdgeSweep, props: Props) -> Props:
        if not isinstance(h, CudaHandle):
            raise TypeError(f"CudaEngine sweeps take a CudaHandle (graph "
                            f"plus ELL pack), got {type(h).__name__}")
        if not self._kernel_compatible(sw):
            return super()._run_sweep(h.g, sw, props)
        _faults.fire("kernel_launch", engine=self.name, fused=self.fused,
                     op="sweep")
        if self.fused:
            return self._run_sweep_fused(h, sw, props)
        return self._run_sweep_chained(h, sw, props)

    def _run_sweep_fused(self, h: CudaHandle, sw: EdgeSweep,
                         props: Props) -> Props:
        """One fused launch per sweep: min/argmin/hit (or sum/hit) come
        out of a single kernel with in-kernel frontier compaction."""
        cfg = self._config(h.g)
        reduced, hit, parents = {}, {}, {}
        for target, red in sw.reduces.items():
            if red.kind == "argmin":
                continue
            vec_fn, use_w = sw.gather_form[target]
            vals_n1 = _pad_identity(vec_fn(props), red)
            if red.kind == "min":
                assert use_w
                reduced[target], parents[target], hit[target] = \
                    kops.vertex_relax_fused(h.ell, vals_n1,
                                            block=cfg.row_block)
            else:  # sum
                reduced[target], hit[target] = kops.vertex_spmv_fused(
                    h.ell, vals_n1, block=cfg.row_block)
        for target, red in sw.reduces.items():
            if red.kind == "argmin":
                reduced[target] = parents[red.of]
                hit[target] = hit[red.of]
        return sw.post_fn(props, reduced, hit)

    def _run_sweep_chained(self, h: CudaHandle, sw: EdgeSweep,
                           props: Props) -> Props:
        """The per-op kernel chain: rowmin → vertex combine → hit →
        rowargmin, or rowsum → vertex combine."""
        ell = h.ell
        n = self.n_pad
        reduced, hit, gathered = {}, {}, {}
        for target, red in sw.reduces.items():
            if red.kind == "argmin":
                continue
            vec_fn, use_w = sw.gather_form[target]
            vals_n1 = gathered[target] = _pad_identity(vec_fn(props), red)
            if red.kind == "min":
                assert use_w
                reduced[target] = kops.vertex_min_plus(ell, vals_n1)
                hit[target] = reduced[target] < red.identity(vals_n1.dtype)
            else:  # sum
                reduced[target] = kops.vertex_spmv(ell, vals_n1)
                # the reference's segment_max: a vertex without rows gets
                # the int32 minimum, which is True as a bool
                hit[target] = segment_max((ell.row2dst < n).to(INT),
                                          in_range(ell.row2dst, n),
                                          n + 1)[:n].to(torch.bool)
        for target, red in sw.reduces.items():
            if red.kind != "argmin":
                continue
            # the min's own vector: its identity at slot n is INF_W
            reduced[target] = kops.vertex_argmin_src(
                ell, gathered[red.of], reduced[red.of])
            hit[target] = hit[red.of]
        return sw.post_fn(props, reduced, hit)


def _pad_identity(vec: torch.Tensor, red) -> torch.Tensor:
    """(n+1,): the property vector with the reduction's identity at slot
    n, which the ELL's empty slots gather."""
    return torch.cat([vec, vec.new_full((1,), red.identity(vec.dtype))])


def CudaChainedEngine(**kw) -> CudaEngine:
    """Registry factory for the chained regime (``cuda_chained``): the
    same engine with per-op kernel chains instead of fused launches."""
    kw.setdefault("fused", False)
    return CudaEngine(**kw)
