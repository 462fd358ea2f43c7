"""diff-CSR: the paper's dynamic graph representation (counterpart of
``repro.graph.diffcsr``, where the design is written down).

* the main region keeps its allocation forever; a deletion clears an
  ``alive`` bit, which keeps rows sorted;
* re-adding a deleted edge revives its slot in place;
* fresh edges go to a fixed-capacity diff pool kept sorted by
  (src, dst), vacant rows (src == n) sunk to the end;
* adds that find no room bump the ``overflow`` counter, and the host
  answers with ``merge`` into a larger pool.

Every function returns a new :class:`DynGraph` and leaves its input
untouched, so a caller can roll back to the graph it passed in.  Arrays
keep the reference's dtypes (int32 ids/weights/offsets, bool masks), so
a graph crosses between the two packages slot for slot.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.graph.csr import CSR, INF_W, INT, build_csr, row_searchsorted
from repro_torch.tensors import (cumsum32, in_range, segment_sum, set_drop,
                                 take)

BOOL = torch.bool


@dataclasses.dataclass(frozen=True)
class DynGraph:
    """Dynamic graph = main CSR region + diff region, both fixed-shape."""

    # --- main region (rows sorted by dst within each src row) ---
    offsets: torch.Tensor      # (n+1,) int32
    src: torch.Tensor          # (E,) int32
    dst: torch.Tensor          # (E,) int32
    w: torch.Tensor            # (E,) int32
    alive: torch.Tensor        # (E,) bool
    # --- diff region (globally sorted by (src,dst); empty slots src=n) ---
    d_offsets: torch.Tensor    # (n+1,) int32
    d_src: torch.Tensor        # (D,) int32
    d_dst: torch.Tensor        # (D,) int32
    d_w: torch.Tensor          # (D,) int32
    d_alive: torch.Tensor      # (D,) bool
    # --- bookkeeping ---
    overflow: torch.Tensor     # () int32 — adds dropped for lack of capacity
    n: int

    @property
    def main_capacity(self) -> int:
        return int(self.src.shape[0])

    @property
    def diff_capacity(self) -> int:
        return int(self.d_src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    # Flat edge view used by every ``forall (e in g.edges)`` lowering.
    def edge_arrays(self) -> Tuple[torch.Tensor, ...]:
        esrc = torch.cat([self.src, self.d_src.clamp(max=self.n - 1)])
        edst = torch.cat([self.dst, self.d_dst])
        ew = torch.cat([self.w, self.d_w])
        ealive = torch.cat([self.alive, self.d_alive & (self.d_src < self.n)])
        return esrc, edst, ew, ealive

    def out_degrees(self) -> torch.Tensor:
        # a negative source (an unchecked, admission="off" pool) is dropped
        esrc, _, _, ealive = self.edge_arrays()
        return segment_sum(ealive.to(INT), in_range(esrc, self.n),
                           self.n + 1)[:self.n]


def from_csr(csr: CSR, diff_capacity: int) -> DynGraph:
    d = max(int(diff_capacity), 1)
    n = csr.n
    dev = csr.device
    z = lambda size, dt=INT: torch.zeros(size, dtype=dt, device=dev)
    pool = dict(d_offsets=z((n + 1,)),
                d_src=torch.full((d,), n, dtype=INT, device=dev),
                d_dst=z((d,)), d_w=z((d,)), d_alive=z((d,), BOOL),
                overflow=z(()), n=n)
    if csr.num_edges == 0:
        # keep ≥1 (dead) lane so gathers stay well-formed on empty graphs
        return DynGraph(offsets=csr.offsets, src=z((1,)), dst=z((1,)),
                        w=torch.ones((1,), dtype=INT, device=dev),
                        alive=z((1,), BOOL), **pool)
    return DynGraph(offsets=csr.offsets, src=csr.src, dst=csr.dst, w=csr.w,
                    alive=torch.ones((csr.num_edges,), dtype=BOOL,
                                     device=dev), **pool)


# ---------------------------------------------------------------------------
# Lookup helpers
# ---------------------------------------------------------------------------

def _locate(offsets, dst, qs, qd, rounds: int = 32):
    lo = take(offsets, qs)
    hi = take(offsets, qs.to(torch.int64) + 1)
    pos = row_searchsorted(dst, lo, hi, qd, rounds)
    cap = dst.shape[0]
    if not cap:
        return pos, torch.zeros(qs.shape, dtype=BOOL, device=qs.device)
    safe = pos.clamp(0, cap - 1)
    return safe, (pos < hi) & (dst[safe] == qd)


def _locate_main(g: DynGraph, qs, qd, rounds: int = 32):
    """(pos, found) of (qs->qd) in the main region, ignoring alive bit;
    ``rounds`` as for ``row_searchsorted``."""
    return _locate(g.offsets, g.dst, qs, qd, rounds)


def _locate_diff(g: DynGraph, qs, qd, rounds: int = 32):
    return _locate(g.d_offsets, g.d_dst, qs, qd, rounds)


def update_lanes(g: DynGraph, qs, qd, mask):
    """(lane, active) of batch edges in the E+D lane space of ``g`` —
    the addressing used to patch ELL packs in place."""
    E, D = g.main_capacity, g.diff_capacity
    p1, f1 = _locate_main(g, qs, qd)
    p2, f2 = _locate_diff(g, qs, qd)
    in_main = f1 & mask
    in_diff = f2 & mask & ~f1
    lane = torch.where(in_main, p1, torch.where(in_diff, E + p2, E + D))
    return lane, in_main | in_diff


def _pair_searchsorted(a_src, a_dst, q_src, q_dst, iters: int):
    """Branchless lexicographic searchsorted: for each query pair, the
    first index i with (a_src[i], a_dst[i]) >= (q_src, q_dst).  The key
    arrays must be sorted by (src, dst)."""
    dev = q_src.device
    lo = torch.zeros(q_src.shape, dtype=INT, device=dev)
    hi = torch.full(q_src.shape, a_src.shape[0], dtype=INT, device=dev)
    cap = max(int(a_src.shape[0]) - 1, 0)
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) // 2
        safe = mid.clamp(0, cap)
        ms, md = a_src[safe], a_dst[safe]
        pred = (ms < q_src) | ((ms == q_src) & (md < q_dst))
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo


def _log2_iters(length: int) -> int:
    it = 1
    while (1 << it) < length + 1:
        it += 1
    return it + 1


def is_edge(g: DynGraph, qs, qd, rounds=(32, 32)) -> torch.Tensor:
    """Vectorized alive-edge membership (u->v); ``rounds`` of the main
    and the diff region's searches as for ``row_searchsorted``."""
    p1, f1 = _locate_main(g, qs, qd, rounds[0])
    p2, f2 = _locate_diff(g, qs, qd, rounds[1])
    return (f1 & g.alive[p1]) | (f2 & g.d_alive[p2])


def edge_weight(g: DynGraph, qs, qd) -> torch.Tensor:
    """Weight of alive edge u->v, INF_W where there is none."""
    p1, f1 = _locate_main(g, qs, qd)
    p2, f2 = _locate_diff(g, qs, qd)
    w = torch.full_like(qs, INF_W)
    w = torch.where(f2 & g.d_alive[p2], g.d_w[p2], w)
    return torch.where(f1 & g.alive[p1], g.w[p1], w)


# ---------------------------------------------------------------------------
# updateCSRDel — tombstone deletions (paper §3.5)
# ---------------------------------------------------------------------------

def update_csr_del(g: DynGraph, del_src, del_dst, mask=None) -> DynGraph:
    if mask is None:
        mask = torch.ones(del_src.shape, dtype=BOOL, device=del_src.device)
    p1, f1 = _locate_main(g, del_src, del_dst)
    p2, f2 = _locate_diff(g, del_src, del_dst)
    kill1 = f1 & mask
    kill2 = f2 & mask & ~f1
    # masked-out lanes aim past the end and are dropped; duplicates are
    # idempotent
    E, D = g.main_capacity, g.diff_capacity
    alive = set_drop(g.alive, torch.where(kill1, p1, E), False)
    d_alive = set_drop(g.d_alive, torch.where(kill2, p2, D), False)
    return dataclasses.replace(g, alive=alive, d_alive=d_alive)


# ---------------------------------------------------------------------------
# updateCSRAdd — revive vacant slots, overflow into diff-CSR (paper §3.5)
# ---------------------------------------------------------------------------

def _lexsort(dst, src):
    """Stable order by (src, dst): two stable sorts, minor key first."""
    order = torch.argsort(dst, stable=True)
    return order[torch.argsort(src[order], stable=True)]


def update_csr_add(g: DynGraph, add_src, add_dst, add_w=None, mask=None, *,
                   pool_merge=None) -> DynGraph:
    """``pool_merge`` plugs a backend merge kernel into step 3: called as
    ``pool_merge(d_src, d_dst, d_w, d_alive, f_src, f_dst, f_w, f_alive,
    n=g.n)`` with both lists sorted by (src, dst) and sentinel rows
    (src == n) sunk to the end, it returns the merged
    ``(d_src, d_dst, d_w, d_alive)`` — bit-exact against the default
    scatter path."""
    dev = add_src.device
    if add_w is None:
        add_w = torch.ones(add_src.shape, dtype=INT, device=dev)
    if mask is None:
        mask = torch.ones(add_src.shape, dtype=BOOL, device=dev)
    E, D = g.main_capacity, g.diff_capacity
    n = g.n

    # 1) revive / update in the main region (vacant-slot reuse).  A batch
    #    that revives one edge twice keeps its last weight.
    p1, f1 = _locate_main(g, add_src, add_dst)
    rev1 = f1 & mask
    idx1 = torch.where(rev1, p1, E)
    alive = set_drop(g.alive, idx1, True)
    w = set_drop(g.w, idx1, add_w, last_wins=True)

    # 2) revive / update in the diff region.
    p2, f2 = _locate_diff(g, add_src, add_dst)
    rev2 = f2 & mask & ~f1
    idx2 = torch.where(rev2, p2, D)
    d_alive = set_drop(g.d_alive, idx2, True)
    d_w = set_drop(g.d_w, idx2, add_w, last_wins=True)

    # 3) append the rest to the diff pool; keep the first fresh lane of
    #    each repeated (src, dst) key.
    fresh = mask & ~f1 & ~f2
    B = add_src.shape[0]
    order = _lexsort(add_dst, add_src)
    s_src, s_dst, s_w = add_src[order], add_dst[order], add_w[order]
    s_fresh = fresh[order]
    first = torch.cat([torch.ones((1,), dtype=BOOL, device=dev),
                       (s_src[1:] != s_src[:-1]) | (s_dst[1:] != s_dst[:-1])])
    grp = cumsum32(first.to(INT)) - 1
    idx = torch.arange(B, dtype=INT, device=dev)
    first_fresh = torch.full((B,), B, dtype=INT, device=dev).scatter_reduce(
        0, grp.to(torch.int64), torch.where(s_fresh, idx, B), "amin")
    s_fresh = s_fresh & (idx == first_fresh[grp])

    used = (g.d_src < n).sum(dtype=INT)
    fresh_rank = cumsum32(s_fresh.to(INT)) - 1
    fits = s_fresh & (used + fresh_rank < D)
    overflow = g.overflow + (s_fresh & ~fits).sum(dtype=INT)
    # compact the admitted fresh edges into a sorted (B,)-padded list
    ftgt = torch.where(fits, fresh_rank, B)
    f_src = set_drop(torch.full((B,), n, dtype=INT, device=dev), ftgt, s_src)
    f_dst = set_drop(torch.zeros((B,), dtype=INT, device=dev), ftgt, s_dst)
    f_w = set_drop(torch.zeros((B,), dtype=INT, device=dev), ftgt, s_w)
    if pool_merge is not None:
        # admitted ranks are a dense prefix, so alive = prefix mask
        f_alive = idx < fits.sum(dtype=INT)
        d_src, d_dst, d_wn, d_al = pool_merge(
            g.d_src, g.d_dst, d_w, d_alive, f_src, f_dst, f_w, f_alive, n=n)
    else:
        # merged position of each pool row / each admitted edge: its own
        # rank plus the count of keys below it in the other sorted list
        cnt_f = _pair_searchsorted(f_src, f_dst, g.d_src, g.d_dst,
                                   _log2_iters(B))
        cnt_p = _pair_searchsorted(g.d_src, g.d_dst, s_src, s_dst,
                                   _log2_iters(D))
        pool_pos = torch.where(
            g.d_src < n, torch.arange(D, dtype=INT, device=dev) + cnt_f, D)
        fresh_pos = torch.where(fits, fresh_rank + cnt_p, D)

        def fill(init, pool_vals, fresh_vals):
            return set_drop(set_drop(init, pool_pos, pool_vals), fresh_pos,
                            fresh_vals)

        d_src = fill(torch.full((D,), n, dtype=INT, device=dev), g.d_src,
                     s_src)
        d_dst = fill(torch.zeros((D,), dtype=INT, device=dev), g.d_dst,
                     s_dst)
        d_wn = fill(torch.zeros((D,), dtype=INT, device=dev), d_w, s_w)
        d_al = fill(torch.zeros((D,), dtype=BOOL, device=dev), d_alive, True)
    d_offsets = _pool_offsets(d_src, n)
    return dataclasses.replace(
        g, alive=alive, w=w, d_src=d_src, d_dst=d_dst, d_w=d_wn,
        d_alive=d_al, d_offsets=d_offsets, overflow=overflow)


def _pool_offsets(d_src, n: int) -> torch.Tensor:
    return torch.searchsorted(
        d_src, torch.arange(n + 1, dtype=INT, device=d_src.device),
        side="left", out_int32=True)


# ---------------------------------------------------------------------------
# compact — on-device reclamation of tombstoned diff slots
# ---------------------------------------------------------------------------

def compact(g: DynGraph) -> DynGraph:
    """Drop dead diff-pool rows, keeping shapes fixed: a stable
    left-compaction of the alive rows, so the pool stays sorted by
    (src, dst) and ``d_offsets`` stays exact."""
    d = g.diff_capacity
    n = g.n
    dev = g.device
    keep = g.d_alive & (g.d_src < n)
    tgt = torch.where(keep, cumsum32(keep.to(INT)) - 1, d)
    d_src = set_drop(torch.full((d,), n, dtype=INT, device=dev), tgt,
                     g.d_src)
    d_dst = set_drop(torch.zeros((d,), dtype=INT, device=dev), tgt, g.d_dst)
    d_w = set_drop(torch.zeros((d,), dtype=INT, device=dev), tgt, g.d_w)
    d_alive = set_drop(torch.zeros((d,), dtype=BOOL, device=dev), tgt, True)
    return dataclasses.replace(g, d_src=d_src, d_dst=d_dst, d_w=d_w,
                               d_alive=d_alive,
                               d_offsets=_pool_offsets(d_src, n))


def pool_counters(g: DynGraph) -> torch.Tensor:
    """(overflow, used, dead) int32 triple — the merge-pressure counters
    the stream executor reads once per batch."""
    used = (g.d_src < g.n).sum(dtype=INT)
    dead = ((g.d_src < g.n) & ~g.d_alive).sum(dtype=INT)
    return torch.stack([g.overflow, used, dead])


# ---------------------------------------------------------------------------
# merge — compaction of the diff chain back into a clean CSR (host-side)
# ---------------------------------------------------------------------------

def merge(g: DynGraph, diff_capacity: int | None = None,
          slack: float = 0.0) -> DynGraph:
    """Rebuild a clean CSR out of all alive edges (paper's periodic merge).
    Host-side numpy: the one shape-changing operation."""
    esrc, edst, ew, ealive = (x.cpu().numpy() for x in g.edge_arrays())
    edges = np.stack([esrc[ealive], edst[ealive]], axis=1)
    csr = build_csr(g.n, edges, ew[ealive], dedupe=True, device=g.device)
    if diff_capacity is None:
        diff_capacity = max(g.diff_capacity, 1)
    cap = int(diff_capacity * (1.0 + slack)) or 1
    return from_csr(csr, cap)
