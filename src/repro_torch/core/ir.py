"""The aggregate-op IR the engines consume (counterpart of
``repro.core.ir``).

* every write inside a ``forall (e in g.edges)`` is declared as a
  :class:`Reduce` (min/sum/max/or/argmin), which each backend lowers to
  its own synchronization;
* :class:`EdgeSweep` is one such forall with its reductions and its
  element-wise ``post_fn``; an optional ``gather_form`` lets the kernel
  backend run it on the ELL relax kernel;
* :class:`PropView` records which vertex properties an ``edge_fn``
  reads — the paper's read-set analysis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import torch

from repro_torch.graph.csr import INF_W
from repro_torch.tensors import segment_max, segment_min, segment_sum

# ---------------------------------------------------------------------------
# Reductions (the paper's Min / += / |= constructs)
# ---------------------------------------------------------------------------

_IDENTITIES = {
    "min": lambda dt: INF_W if not dt.is_floating_point else float("inf"),
    "max": lambda dt: -INF_W if not dt.is_floating_point else float("-inf"),
    "sum": lambda dt: 0,
    "or": lambda dt: False,
}

_SEGMENT = {
    "min": segment_min,
    "max": segment_max,
    "sum": segment_sum,
    # segment_max fills empty segments with dtype-min, so 'or' compares > 0
    "or": lambda v, s, num: segment_max(v.to(torch.int32), s, num) > 0,
}


@dataclasses.dataclass(frozen=True)
class Reduce:
    """Declared combiner for one property written inside a forall-edges.

    kind='argmin' picks, per destination vertex, the smallest source id
    among edges achieving the min of the ``of`` target — the paper's
    ``nbr.parent = v`` riding along its ``Min``, made deterministic.
    """

    kind: str  # 'min' | 'sum' | 'max' | 'or' | 'argmin'
    of: str | None = None

    def identity(self, dtype):
        """The identity as a Python scalar of ``dtype``'s kind."""
        return _IDENTITIES[self.kind](dtype)

    def segment(self, values, segids, num_segments):
        return _SEGMENT[self.kind](values, segids, num_segments)


# ---------------------------------------------------------------------------
# Property views + read-set analysis
# ---------------------------------------------------------------------------

class PropView(Mapping):
    """Read-only view of vertex properties gathered at one edge endpoint;
    records every key it serves."""

    def __init__(self, props: Dict[str, torch.Tensor], idx: torch.Tensor,
                 read_log: set | None = None):
        self._props = props
        self._idx = idx
        self._log = read_log

    def __getitem__(self, k: str) -> torch.Tensor:
        if self._log is not None:
            self._log.add(k)
        return self._props[k][self._idx]

    def __iter__(self):
        return iter(self._props)

    def __len__(self):
        return len(self._props)


def trace_read_set(edge_fn: Callable, props: Dict[str, torch.Tensor]) -> set:
    """Run edge_fn on one-lane inputs to recover its read set (eager
    PyTorch has no abstract evaluation; one lane costs nothing)."""
    log: set = set()
    one = {k: v[:1] for k, v in props.items()}
    dev = next(iter(props.values())).device if props else None
    idx = torch.zeros((1,), dtype=torch.int64, device=dev)
    w = torch.zeros((1,), dtype=torch.int32, device=dev)
    try:
        edge_fn(PropView(one, idx, log), PropView(one, idx, log), w)
    except Exception:
        # a failure here falls back to gathering everything (always sound)
        return set(props)
    return log


# ---------------------------------------------------------------------------
# Aggregate ops
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EdgeSweep:
    """One ``forall (e in g.edges)`` with declared reductions.

    edge_fn(src_view, dst_view, w) -> {target: (value, eligible_mask)}
    reduces: {target: Reduce}
    post_fn(props, reduced, hit) -> new props
    gather_form: {target: (vec_fn(props)->(n,), use_w)} declares the sweep
      as cand(e=(u,v)) = vec[u] (+ w(e)), which the kernel backend runs on
      the ELL relax kernel; other sweeps take segment reductions.
    frontier: name of the boolean source-side property gating the sweep.
    """

    edge_fn: Callable
    reduces: Dict[str, Reduce]
    post_fn: Callable
    gather_form: Dict[str, Tuple[Callable, bool]] | None = None
    frontier: str | None = None

    def read_set(self, props: Dict[str, torch.Tensor]) -> set:
        return trace_read_set(self.edge_fn, props)
