"""Vertex-level graph ops over the fused relax kernel (counterpart of
``repro.kernels.ops``)."""
from __future__ import annotations

import torch

from repro_torch.graph.csr import INF_W
from repro_torch.kernels import repair as FK
from repro_torch.kernels.ell import Ell
from repro_torch.tensors import segment_min, set_drop


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
    seg = ell.row2dst.clamp(max=n)
    vmin = segment_min(row_min, seg, n + 1)[:n]
    tgt_full = torch.cat([vmin, vmin.new_full((1,), INF_W)])
    contrib = torch.where(row_min == tgt_full[seg], row_arg, n)
    parent = segment_min(contrib, seg, n + 1)[:n]
    return vmin, parent, _frontier_hit(ell, front_rows)
