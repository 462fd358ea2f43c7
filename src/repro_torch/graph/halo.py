"""Halo (ghost-region) plan for the sharded DynGraph (a copy of
``repro.graph.halo``, numpy only).

A shard's **halo** is the set of vertices whose property values its
edge rows read or reduce into but whose property slots live on another
shard (the pyop2/firedrake diagonal-vs-off-process split, applied to
vertex properties instead of matrix nonzeros).  This module computes
the ghost sets host-side at ``prepare`` time and freezes them into
static-shape exchange tables, so that at run time one packed
``all_to_all`` per direction moves *only* boundary property values —
no dynamic shapes, no host round-trips.

Table layout (``P`` shards, ``H`` = padded ghosts/shard, ``Hs`` =
padded ghosts per (owner, reader) pair):

* ``ghosts``   (P, H)    — sorted global ids of shard ``p``'s ghosts,
                           padded with ``n_pad`` (sorted ⇒ in-kernel
                           resolution is a searchsorted).
* ``send_idx`` (P, P, Hs) — ``send_idx[q, p]``: local slots (offsets
                           into owner ``q``'s property block) that ``q``
                           sends to reader ``p``; pad ``block`` (folded
                           scatters use ``mode="drop"``).
* ``recv_tgt`` (P, P, Hs) — ``recv_tgt[p, q]``: halo slots on reader
                           ``p`` filled by owner ``q``'s packet; pad
                           ``H``.  Both tables describe the SAME
                           (owner q → reader p) packet, so the forward
                           refresh and the reverse fold reuse one plan.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    P: int
    block: int                 # property-block width per shard
    n_pad: int                 # block * P — ghost-table pad value
    H: int                     # padded halo width per shard
    Hs: int                    # padded packet width per (owner, reader) pair
    ghosts: np.ndarray         # (P, H) int32, sorted, pad n_pad
    counts: np.ndarray         # (P,) real ghost count per shard
    send_idx: np.ndarray       # (P, P, Hs) int32, pad block
    recv_tgt: np.ndarray       # (P, P, Hs) int32, pad H


def ghost_sets(src, dst, row_owner, block: int, P: int,
               hints=None) -> list[np.ndarray]:
    """Per-shard sorted ghost ids: endpoints of a shard's rows whose
    property owner (``v // block``) is another shard.  ``hints`` (extra
    global ids, e.g. from a halo-miss replay) are added to every shard
    they are foreign to — host-side we cannot know which shard's future
    rows will touch them."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    row_owner = np.asarray(row_owner)
    out = []
    for p in range(P):
        sel = row_owner == p
        ends = np.concatenate([src[sel], dst[sel]])
        if hints is not None and len(hints):
            ends = np.concatenate([ends, np.asarray(hints, dtype=np.int64)])
        ends = np.unique(ends)
        out.append(ends[(ends // block) != p])
    return out


def build_plan(gsets: Sequence[np.ndarray], P: int, block: int,
               n_pad: int) -> HaloPlan:
    counts = np.array([len(g) for g in gsets], dtype=np.int64)
    H = max(1, int(counts.max()) if P else 1)
    ghosts = np.full((P, H), n_pad, dtype=np.int32)
    seg = np.zeros((P, P + 1), dtype=np.int64)
    bounds = np.arange(P + 1, dtype=np.int64) * block
    for p, gh in enumerate(gsets):
        gh = np.asarray(gh, dtype=np.int64)
        ghosts[p, : len(gh)] = gh
        # ghosts are sorted, so each owner's slice is contiguous
        seg[p] = np.searchsorted(gh, bounds)
    pair = seg[:, 1:] - seg[:, :-1]          # pair[p, q] = |ghosts of p owned by q|
    Hs = max(1, int(pair.max()) if P else 1)
    send_idx = np.full((P, P, Hs), block, dtype=np.int32)
    recv_tgt = np.full((P, P, Hs), H, dtype=np.int32)
    for p in range(P):
        gh = np.asarray(gsets[p], dtype=np.int64)
        for q in range(P):
            c = int(pair[p, q])
            if not c:
                continue
            s = int(seg[p, q])
            ids = gh[s : s + c]
            send_idx[q, p, :c] = (ids - q * block).astype(np.int32)
            recv_tgt[p, q, :c] = np.arange(s, s + c, dtype=np.int32)
    return HaloPlan(P=P, block=block, n_pad=n_pad, H=H, Hs=Hs,
                    ghosts=ghosts, counts=counts,
                    send_idx=send_idx, recv_tgt=recv_tgt)
