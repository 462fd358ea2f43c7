"""Pure-python/numpy oracles for the three paper algorithms.

These implement the textbook *static* algorithms from scratch; every
dynamic result must equal the oracle run on the post-update edge set
(the paper's own correctness criterion: dynamic == static-on-new-graph).
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np

INF = np.int64(np.iinfo(np.int32).max // 2)


def edges_after_updates(n: int, edges: np.ndarray, weights: np.ndarray,
                        adds: np.ndarray, dels: np.ndarray):
    """Apply Δ to an edge set host-side (dedup, delete-then-add per batch
    order is irrelevant for the final set as adds are fresh edges)."""
    ew: Dict[Tuple[int, int], int] = {}
    for (u, v), w in zip(edges.tolist(), weights.tolist()):
        ew[(u, v)] = w
    for u, v in dels.tolist():
        ew.pop((u, v), None)
    for u, v, w in adds.tolist():
        ew[(u, v)] = w
    if not ew:
        return np.zeros((0, 2), np.int64), np.zeros((0,), np.int32)
    e = np.array(sorted(ew), dtype=np.int64)
    w = np.array([ew[tuple(x)] for x in e.tolist()], dtype=np.int32)
    return e, w


def sssp_oracle(n: int, edges: np.ndarray, weights: np.ndarray,
                source: int) -> np.ndarray:
    """Bellman-Ford (no negative weights here, so it converges)."""
    dist = np.full(n, INF, dtype=np.int64)
    dist[source] = 0
    src = edges[:, 0] if len(edges) else np.zeros(0, np.int64)
    dst = edges[:, 1] if len(edges) else np.zeros(0, np.int64)
    w = weights.astype(np.int64)
    for _ in range(n):
        cand = dist[src] + w
        nd = dist.copy()
        np.minimum.at(nd, dst, np.where(dist[src] < INF, cand, INF))
        if np.array_equal(nd, dist):
            break
        dist = nd
    return np.minimum(dist, INF)


def pagerank_oracle(n: int, edges: np.ndarray, beta: float = 1e-3,
                    delta: float = 0.85, max_iter: int = 100) -> np.ndarray:
    pr = np.full(n, 1.0 / n, dtype=np.float64)
    src = edges[:, 0] if len(edges) else np.zeros(0, np.int64)
    dst = edges[:, 1] if len(edges) else np.zeros(0, np.int64)
    outdeg = np.zeros(n, dtype=np.int64)
    np.add.at(outdeg, src, 1)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    for _ in range(max_iter):
        acc = np.zeros(n, dtype=np.float64)
        np.add.at(acc, dst, pr[src] * inv[src])
        val = (1.0 - delta) / n + delta * acc
        diff = np.abs(val - pr).sum()
        pr = val
        if diff <= beta:
            break
    return pr


def tc_oracle(n: int, edges: np.ndarray) -> int:
    """Paper's node-iterator count on a symmetrized edge set."""
    nbrs: List[Set[int]] = [set() for _ in range(n)]
    eset = set(map(tuple, edges.tolist()))
    for u, v in edges.tolist():
        nbrs[u].add(v)
    count = 0
    for v in range(n):
        for u in nbrs[v]:
            if u >= v:
                continue
            for w in nbrs[v]:
                if w <= v:
                    continue
                if (u, w) in eset:
                    count += 1
    return count


def symmetrize(edges: np.ndarray, weights: np.ndarray):
    e2 = np.concatenate([edges, edges[:, ::-1]], axis=0)
    w2 = np.concatenate([weights, weights], axis=0)
    key = e2[:, 0] * (e2.max() + 1) + e2[:, 1]
    _, idx = np.unique(key, return_index=True)
    return e2[idx], w2[idx]
