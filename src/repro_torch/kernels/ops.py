"""Vertex-level graph ops over the ELL row kernels (counterpart of
``repro.kernels.ops``): the chained ops over ``kernels/csr_relax.py``
and the fused ones over ``kernels/repair.py``.  Rows combine into
vertices by segment reductions over ``row2dst``; rows are grouped by
vertex, so a float sum adds a vertex's rows in row order.  A row of a
negative destination (only an unchecked, admission="off" graph has one)
is dropped, as ``jax.ops.segment_*`` drops it."""
from __future__ import annotations

import torch

from repro_torch.graph.csr import INF_W
from repro_torch.kernels import csr_relax as K
from repro_torch.kernels import repair as FK
from repro_torch.kernels.ell import Ell
from repro_torch.kernels.segment import segment_sum_sorted
from repro_torch.tensors import in_range, segment_min, set_drop


def _combine_rows(row_vals, ell: Ell, kind: str) -> torch.Tensor:
    """Rows → vertices; vertices without rows keep JAX's empty-segment
    value (the dtype's max for min, 0 for sum).  A float sum adds each
    vertex's rows ``[offsets[v], offsets[v+1])`` in row order."""
    if kind == "sum":
        return segment_sum_sorted(row_vals, None, ell.offsets)
    return segment_min(row_vals, in_range(ell.row2dst, ell.n),
                       ell.n + 1)[:ell.n]


def vertex_min_plus(ell: Ell, vals_n1: torch.Tensor) -> torch.Tensor:
    """out[v] = min over in-edges (u,v) of vals[u] + w(u,v); INF if none."""
    return _combine_rows(K.relax_rowmin(ell.ell_src, ell.ell_w, vals_n1),
                         ell, "min")


def vertex_spmv(ell: Ell, vals_n1: torch.Tensor) -> torch.Tensor:
    """out[v] = sum over in-edges (u,v) of vals[u]  (PageRank pull)."""
    return _combine_rows(K.spmv_rowsum(ell.ell_src, vals_n1), ell, "sum")


def vertex_argmin_src(ell: Ell, vals_n1: torch.Tensor,
                      vertex_min: torch.Tensor) -> torch.Tensor:
    """Smallest source achieving vertex_min[v] (deterministic parent)."""
    n = ell.n
    tgt_full = torch.cat([vertex_min, vertex_min.new_full((1,), INF_W)])
    row_tgt = tgt_full[in_range(ell.row2dst, n)]
    rows = K.relax_rowargmin(ell.ell_src, ell.ell_w, vals_n1, row_tgt, n=n)
    return _combine_rows(rows, ell, "min")


# ---------------------------------------------------------------------------
# fused repair path (kernels/repair.py): one launch per sweep
# ---------------------------------------------------------------------------

def _frontier_hit(ell: Ell, front_rows: torch.Tensor) -> torch.Tensor:
    """Scatter the in-kernel compacted frontier rows to a vertex mask —
    O(frontier) writes instead of a dense reduction over R."""
    n = ell.n
    safe = front_rows.clamp(max=ell.R - 1)
    dsts = torch.where(front_rows < ell.R, ell.row2dst[safe].clamp(max=n), n)
    hit = torch.zeros((n + 1,), dtype=torch.bool, device=front_rows.device)
    return set_drop(hit, dsts, True)[:n]


def vertex_relax_fused(ell: Ell, vals_n1: torch.Tensor, *, block=None):
    """(vertex_min, parent, hit) from ONE fused relax launch.

    The vertex min is the min of its row mins; the parent is the smallest
    row argmin among the rows reaching it (rows that do not contribute
    the sentinel n); a vertex is hit iff one of its rows improved on the
    identity.  Vertices without rows keep JAX's empty-segment value, the
    int32 max."""
    n = ell.n
    row_min, row_arg, front_rows, _ = FK.fused_relax_rows(
        ell.ell_src, ell.ell_w, vals_n1, block=block or FK.ROW_TILE)
    seg = in_range(ell.row2dst, n)
    vmin = segment_min(row_min, seg, n + 1)[:n]
    tgt_full = torch.cat([vmin, vmin.new_full((1,), INF_W)])
    contrib = torch.where(row_min == tgt_full[seg], row_arg, n)
    parent = segment_min(contrib, seg, n + 1)[:n]
    return vmin, parent, _frontier_hit(ell, front_rows)


def vertex_spmv_fused(ell: Ell, vals_n1: torch.Tensor, *, block=None):
    """(vertex_sum, hit) from one fused SpMV launch; hit marks vertices
    owning a materialized ELL row."""
    row_sum, front_rows, _ = FK.fused_spmv_rows(
        ell.ell_src, ell.row2dst, vals_n1, block=block or FK.ROW_TILE)
    return _combine_rows(row_sum, ell, "sum"), _frontier_hit(ell, front_rows)
