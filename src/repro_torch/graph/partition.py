"""Row partitioners for the sharded DynGraph (``repro_torch.shard``; a
copy of ``repro.graph.partition``, numpy only).

The sharded engine keeps TWO ownership notions deliberately separate:

* **property ownership** is always block-identity — vertex ``v``'s
  property slot lives on shard ``v // block`` (``block = ceil(n / P)``).
  This is forced by the shard seam: an ``(n_pad,)`` vertex array splits
  into equal ``(block,)`` slices, and every algorithm in
  ``repro_torch.algos`` indexes properties by *global* vertex id (SSSP's
  ``parent`` values are global ids), so the identity layout is the only
  one that keeps the single-device algorithm text valid.

* **row ownership** — which shard stores and processes the out-edges of
  vertex ``u`` — is the schedule knob this module provides (GraphIt's
  algorithm/schedule split: the partitioner is a schedule choice, not a
  DSL change).  Both partitioners emit CONTIGUOUS vertex ranges, so the
  in-kernel owner test is a ``searchsorted`` over a tiny ``(P+1,)``
  boundary table.

``block`` reproduces DistEngine's layout (row owner == property owner:
only destination endpoints ever need ghost slots); ``degree`` balances
out-degree mass across shards, which skew-heavy graphs need — its cost
is that source endpoints of displaced rows become ghosts too.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PARTITIONERS = ("block", "degree")


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Contiguous row-ownership ranges: shard ``p`` owns the out-rows of
    vertices ``[starts[p], starts[p+1])``."""

    kind: str
    n: int
    P: int
    block: int                 # property-block width ceil(n / P)
    starts: np.ndarray         # (P+1,) int64, starts[0] == 0, starts[P] == n

    def owner_of(self, v) -> np.ndarray:
        """Row-owner shard of each vertex in ``v`` (host-side)."""
        v = np.asarray(v)
        return np.searchsorted(self.starts, v, side="right") - 1

    @property
    def assign(self) -> np.ndarray:
        """Dense (n,) row-owner table — test/debug surface."""
        return self.owner_of(np.arange(self.n))


def _prop_block(n: int, P: int) -> int:
    return -(-max(n, 1) // P)


def block_partition(n: int, P: int) -> RowPartition:
    """Equal vertex ranges — DistEngine's layout (row owner == property
    owner), so only cut destinations become ghosts."""
    block = _prop_block(n, P)
    starts = np.minimum(np.arange(P + 1, dtype=np.int64) * block, n)
    return RowPartition("block", n, P, block, starts)


def degree_partition(n: int, P: int, src) -> RowPartition:
    """Contiguous ranges balancing out-degree mass: boundary ``p`` is
    placed where the degree prefix sum first reaches ``p/P`` of the
    total.  Each shard's mass overshoots the ideal ``total/P`` by at
    most one vertex's degree.  Falls back to ``block`` on an edgeless
    graph (every prefix target is zero)."""
    src = np.asarray(src)
    deg = np.bincount(src, minlength=n) if n else np.zeros(0, np.int64)
    total = int(deg.sum())
    if total == 0:
        part = block_partition(n, P)
        return dataclasses.replace(part, kind="degree")
    cum = np.cumsum(deg)
    targets = (total * np.arange(1, P, dtype=np.float64)) / P
    cuts = np.searchsorted(cum, targets, side="left") + 1
    starts = np.concatenate([[0], np.minimum(cuts, n), [n]]).astype(np.int64)
    starts = np.maximum.accumulate(starts)
    return RowPartition("degree", n, P, _prop_block(n, P), starts)


def make_partition(kind: str, n: int, P: int, src=None) -> RowPartition:
    if kind == "block":
        return block_partition(n, P)
    if kind == "degree":
        return degree_partition(n, P, src if src is not None else ())
    raise ValueError(
        f"unknown partitioner {kind!r}; expected one of {PARTITIONERS}")
