"""Static CSR graph representation + generators (counterpart of
``repro.graph.csr``).

The layout is the reference's: ``offsets`` (n+1), the sorted-COO ``src``
and ``dst`` arrays, and ``w``, all int32, rows sorted by destination so
edge membership is a branchless binary search (``row_searchsorted``).
The CSR is built on the host with numpy and then placed on one device.

The generators stay numpy and draw exactly the reference's sequence from
the same seed, so both packages build the same graphs.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.tensors import resolve_device

INT = torch.int32
# Weight used for missing/invalid lookups.
INF_W = int(np.iinfo(np.int32).max // 2)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Immutable static CSR (host-built, device tensors)."""

    n: int                      # static vertex count
    offsets: torch.Tensor       # (n+1,) int32, row starts
    src: torch.Tensor           # (E,) int32 sorted by (src, dst)
    dst: torch.Tensor           # (E,) int32
    w: torch.Tensor             # (E,) int32 edge weights

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def to(self, device) -> "CSR":
        return CSR(n=self.n, offsets=self.offsets.to(device),
                   src=self.src.to(device), dst=self.dst.to(device),
                   w=self.w.to(device))


def build_csr(n: int, edges, weights=None, dedupe: bool = True,
              device=None) -> CSR:
    """Build a CSR from a (E, 2) int array of directed edges.

    Host-side (numpy) sort and deduplication, then one copy to
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64)
    if edges.size == 0:
        edges = edges.reshape(0, 2)
    if weights is None:
        weights = np.ones((edges.shape[0],), dtype=np.int32)
    weights = np.asarray(weights, dtype=np.int32)
    key = edges[:, 0] * np.int64(n) + edges[:, 1]
    order = np.argsort(key, kind="stable")
    edges, weights, key = edges[order], weights[order], key[order]
    if dedupe and edges.shape[0]:
        keep = np.ones(edges.shape[0], dtype=bool)
        keep[1:] = key[1:] != key[:-1]
        edges, weights = edges[keep], weights[keep]
    src = edges[:, 0].astype(np.int32)
    dst = edges[:, 1].astype(np.int32)
    offsets = np.zeros(n + 1, dtype=np.int32)
    offsets[1:] = np.cumsum(np.bincount(src, minlength=n), dtype=np.int32)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return CSR(n=n, offsets=put(offsets), src=put(src), dst=put(dst),
               w=put(weights))


# ---------------------------------------------------------------------------
# Branchless per-row binary search (vectorized over queries).
# ---------------------------------------------------------------------------

def row_searchsorted(sorted_vals: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, queries: torch.Tensor,
                     rounds=32) -> torch.Tensor:
    """For each query q_i, first index in sorted_vals[lo_i:hi_i] >= q_i.

    The reference's ``lax.fori_loop`` of 32 gather rounds becomes a Python
    loop of the same fixed count: no host sync, enough for any row
    length up to 2^31.  A caller that knows every row is at most L long
    passes ``rounds=L.bit_length()``, after which the loop changes
    nothing.  ``rounds`` may also be a function ``rounds(step, state)``
    that applies ``step`` to the (lo, hi) state as many times as it
    decides (a loop on the device, in a captured stream segment)."""
    cap = max(int(sorted_vals.shape[0]) - 1, 0)

    def step(state):
        lo, hi = state
        active = lo < hi
        mid = (lo + hi) // 2
        v = (sorted_vals[mid.clamp(0, cap)] if sorted_vals.shape[0]
             else torch.zeros_like(mid))
        pred = v < queries
        return (torch.where(active & pred, mid + 1, lo),
                torch.where(active & ~pred, mid, hi))

    state = (lo.to(INT), hi.to(INT))
    if callable(rounds):
        return rounds(step, state)[0]
    for _ in range(rounds):
        state = step(state)
    return state[0]


# ---------------------------------------------------------------------------
# Generators (paper Table 1 mix: social/skew = RMAT, road = grid, uniform).
# numpy, with the reference's draw order; ``device=`` returns the arrays
# as tensors on that device instead.
# ---------------------------------------------------------------------------

def _place(n, edges, w, device):
    if device is None:
        return n, edges, w
    dev = resolve_device(device)
    return n, torch.from_numpy(edges).to(dev), torch.from_numpy(w).to(dev)


def rmat_graph(n_log2: int, avg_deg: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               max_w: int = 100, device=None) -> Tuple[int, object, object]:
    """RMAT generator with the paper's SNAP parameters (a,b,c,d)."""
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    m = n * avg_deg
    srcs = np.zeros(m, dtype=np.int64)
    dsts = np.zeros(m, dtype=np.int64)
    for bit in range(n_log2):
        r = rng.random(m)
        # quadrant probabilities: a (0,0), b (0,1), c (1,0), d (1,1)
        src_bit = (r >= a + b).astype(np.int64)
        r2 = rng.random(m)
        dst_bit = np.where(src_bit == 0, (r2 >= a / (a + b)).astype(np.int64),
                           (r2 >= c / (1 - a - b)).astype(np.int64))
        srcs = (srcs << 1) | src_bit
        dsts = (dsts << 1) | dst_bit
    edges = np.stack([srcs, dsts], axis=1)
    w = rng.integers(1, max_w, size=m).astype(np.int32)
    return _place(n, edges, w, device)


def uniform_graph(n: int, avg_deg: int, seed: int = 0, max_w: int = 100,
                  device=None):
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    edges = rng.integers(0, n, size=(m, 2)).astype(np.int64)
    w = rng.integers(1, max_w, size=m).astype(np.int32)
    return _place(n, edges, w, device)


def grid_graph(side: int, seed: int = 0, max_w: int = 100, device=None):
    """Road-network-like: 2D grid, degree ~4, large diameter (paper US/GR)."""
    rng = np.random.default_rng(seed)
    n = side * side
    idx = np.arange(n).reshape(side, side)
    e = []
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1))
    e.append(np.stack([idx[:, 1:].ravel(), idx[:, :-1].ravel()], 1))
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1))
    e.append(np.stack([idx[1:, :].ravel(), idx[:-1, :].ravel()], 1))
    edges = np.concatenate(e, axis=0).astype(np.int64)
    w = rng.integers(1, max_w, size=edges.shape[0]).astype(np.int32)
    return _place(n, edges, w, device)
