"""ELL packing: row-split ELLPACK of the alive edge set (counterpart of
``repro.kernels.ell``, where the layout is written down).

* edges are grouped by destination; each destination's in-edges fill
  rows of K slots; ``row2dst`` maps a row back to its vertex (sentinel
  n for unused rows), empty slots hold the sentinel src == n;
* R = n + ceil((E+D)/K), rounded up to 128 rows, so a pack is
  slot-for-slot the reference's; ``offsets`` (the port's own) keeps each
  vertex's first row, for the vertex combine of float row sums;
* ``lane2slot`` maps every edge lane to its flat slot, so deletions and
  revivals patch the pack in place; only appends to the diff pool, which
  shift diff lanes, rebuild it;
* ``pack_push_ell`` is the same layout grouped by source (the frontier
  engine's push pack).

Property vectors handed to the kernels are padded to n+1 with the
reduction identity at slot n, so empty slots gather the identity.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.graph.csr import INT
from repro_torch.graph.diffcsr import DynGraph, update_lanes
from repro_torch.tensors import (clamp_index, cumsum32, in_range, set_drop,
                                 to_device)


@dataclasses.dataclass(frozen=True)
class Ell:
    ell_src: torch.Tensor    # (R, K) int32, sentinel n
    ell_w: torch.Tensor      # (R, K) int32
    row2dst: torch.Tensor    # (R,) int32, sentinel n
    # (E+D,) flat slot index (< R*K) of every materialized edge lane,
    # sentinel R*K for unmaterialized diff rows
    lane2slot: torch.Tensor
    n: int
    # (n+1,) int32: vertex v owns rows [offsets[v], offsets[v+1]).  Derived
    # from row2dst, so it is not part of the saved state.
    offsets: torch.Tensor = dataclasses.field(metadata={"derived": True})

    @property
    def R(self) -> int:
        return int(self.ell_src.shape[0])

    @property
    def K(self) -> int:
        return int(self.ell_src.shape[1])


_ELL_FIELDS = tuple(f.name for f in dataclasses.fields(Ell)
                    if f.name != "n" and not f.metadata.get("derived"))


def ell_state(e: Ell) -> dict:
    """An Ell pack's array leaves as a flat dict (saved raw, so a restore
    keeps the exact slot layout)."""
    return {f: getattr(e, f) for f in _ELL_FIELDS}


def ell_from_state(tree: dict, n: int, device) -> Ell:
    fields = {f: to_device(tree[f], device) for f in _ELL_FIELDS}
    # rows are grouped by vertex in order, the unused ones (n) last
    bounds = torch.arange(n + 1, dtype=INT, device=device)
    offsets = torch.searchsorted(fields["row2dst"], bounds, out_int32=True)
    return Ell(**fields, n=n, offsets=offsets)


def ell_capacity(n: int, e_cap: int, k: int, row_tile: int = 128) -> int:
    r = n + -(-e_cap // k)
    return -(-r // row_tile) * row_tile


def _materialized(g: DynGraph) -> torch.Tensor:
    """Lanes that own a pack slot: every main lane (dead ones keep their
    slot for a later revival) + occupied diff rows."""
    return torch.cat([torch.ones((g.main_capacity,), dtype=torch.bool,
                                 device=g.device), g.d_src < g.n])


def pack_ell(g: DynGraph, k: int = 8, row_tile: int = 128) -> Ell:
    """Repack the edge set (main + diff regions) into row-split ELL
    grouped by DESTINATION (pull layout — the relax kernel)."""
    esrc, edst, ew, ealive = g.edge_arrays()
    return _pack(g.n, esrc, edst, ew, _materialized(g), ealive, k, row_tile)


def pack_push_ell(g: DynGraph, k: int = 8, row_tile: int = 128) -> Ell:
    """Row-split ELL grouped by SOURCE (push layout, the frontier
    engine's sparse steps): active vertices map to their out-edge rows,
    so a step touches O(|frontier|·K) slots instead of all E lanes.
    Field names keep the Ell convention with roles swapped: ``row2dst``
    holds the row's SOURCE vertex and ``ell_src`` the DESTINATIONS."""
    esrc, edst, ew, ealive = g.edge_arrays()
    return _pack(g.n, edst, esrc, ew, _materialized(g), ealive, k, row_tile)


def _pack(n, eother, egroup, ew, emat, ealive, k, row_tile) -> Ell:
    """Group materialized lanes by ``egroup``; slots hold ``eother``
    endpoints for alive lanes and the sentinel n for tombstoned ones."""
    dev = egroup.device
    E = egroup.shape[0]
    R = ell_capacity(n, E, k, row_tile)

    # sort materialized lanes by the grouping endpoint; unmaterialized
    # lanes sink to a sentinel group
    sdst = torch.where(emat, egroup, n)
    order = torch.argsort(sdst, stable=True)
    sdst = sdst[order]
    salive = ealive[order]
    ssrc = torch.where(salive, eother[order], n)
    sw = torch.where(salive, ew[order], 0)
    # rank within the destination group
    start = torch.searchsorted(sdst, sdst, side="left", out_int32=True)
    rank = torch.arange(E, dtype=INT, device=dev) - start
    # row base per vertex: exclusive cumsum of ceil(indeg/K)
    # ids outside [0, n] are dropped, as by the reference's segment_sum;
    # an index_add (not bincount, which reads its input's max on the
    # host) keeps the pack free of host syncs
    indeg = torch.zeros((n + 2,), dtype=INT, device=dev).index_add_(
        0, in_range(sdst, n + 1).to(torch.int64),
        torch.ones_like(sdst, dtype=INT))[:n + 1]
    segs = -(-indeg // k)
    base = torch.cat([torch.zeros((1,), dtype=INT, device=dev),
                      cumsum32(segs[:n])])
    row = base[clamp_index(sdst.clamp(max=n), n + 1)] + rank // k
    col = rank % k
    valid = sdst < n
    flat = torch.where(valid, row * k + col, R * k)

    ell_src = set_drop(torch.full((R * k,), n, dtype=INT, device=dev), flat,
                       ssrc)
    ell_w = set_drop(torch.zeros((R * k,), dtype=INT, device=dev), flat, sw)
    row2dst = set_drop(torch.full((R,), n, dtype=INT, device=dev),
                       torch.where(valid, row, R), sdst.clamp(max=n))
    lane2slot = torch.empty((E,), dtype=INT, device=dev)
    lane2slot[order] = flat
    return Ell(ell_src=ell_src.reshape(R, k), ell_w=ell_w.reshape(R, k),
               row2dst=row2dst, lane2slot=lane2slot, n=n, offsets=base)


# ---------------------------------------------------------------------------
# In-place maintenance: revive / tombstone without repacking
# ---------------------------------------------------------------------------

def _lane_slots(ell: Ell, lane, active):
    cap = ell.lane2slot.shape[0]
    slot = ell.lane2slot[lane.clamp(0, max(cap - 1, 0))]
    return torch.where(active & (lane < cap), slot, ell.R * ell.K)


def patch_ell_tombstone(ell: Ell, lane, mask) -> Ell:
    """Clear the slots of tombstoned edge lanes (set sentinel src = n);
    the slot stays reserved for a later revival."""
    slot = _lane_slots(ell, lane, mask)
    src = set_drop(ell.ell_src.reshape(-1), slot, ell.n)
    return dataclasses.replace(ell, ell_src=src.reshape(ell.R, ell.K))


def patch_ell_revive(ell: Ell, lane, value, w, mask) -> Ell:
    """Re-arm the slots of revived lanes with their source and weight; a
    lane revived twice in one batch keeps its last weight."""
    slot = _lane_slots(ell, lane, mask)
    src = set_drop(ell.ell_src.reshape(-1), slot, value)
    ww = set_drop(ell.ell_w.reshape(-1), slot, w, last_wins=True)
    return dataclasses.replace(ell, ell_src=src.reshape(ell.R, ell.K),
                               ell_w=ww.reshape(ell.R, ell.K))


def ell_apply_del(ell: Ell, g_prev: DynGraph, src, dst, mask) -> Ell:
    """A deletion batch against the pack: tombstones only flip slots in
    place, so no repack is ever needed."""
    lane, active = update_lanes(g_prev, src, dst, mask)
    return patch_ell_tombstone(ell, lane, active)


def pool_moved(g_prev: DynGraph, g_new: DynGraph) -> torch.Tensor:
    """0-d bool: fresh edges were appended to the diff pool, so its lane
    positions moved and the pack must be rebuilt."""
    return (g_new.d_offsets != g_prev.d_offsets).any()


def ell_revive(ell: Ell, g_prev: DynGraph, src, dst, w, mask,
               slot_value) -> Ell:
    """The revivals of an addition batch, resolved against the
    PRE-update graph and patched in place."""
    lane, active = update_lanes(g_prev, src, dst, mask)
    return patch_ell_revive(ell, lane, slot_value, w, active)


def _host_branch(pred, true_fn, false_fn, operand):
    return true_fn(operand) if bool(pred) else false_fn(operand)


def ell_apply_add(ell: Ell, g_prev: DynGraph, g_new: DynGraph,
                  src, dst, w, mask, slot_value, repack,
                  branch=_host_branch) -> Ell:
    """An addition batch against the pack: ``repack(g_new)`` when the
    pool moved, else the revivals patched in place.  The reference's
    ``lax.cond`` is ``branch(pred, true_fn, false_fn, operand)``: by
    default a host branch (one host sync per batch); the engines hand in
    the stream executor's (``core/device_loop.cond``), and the serving
    pool reads a whole group's flags in one (``serve/batch.py``)."""
    return branch(
        pool_moved(g_prev, g_new), lambda _: repack(g_new),
        lambda e: ell_revive(e, g_prev, src, dst, w, mask, slot_value), ell)
