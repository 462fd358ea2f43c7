"""ShardedEngine — the graph itself partitioned (counterpart of
``repro.shard.engine``).

``DistEngine`` (``core/dist.py``) gives each shard the out-edges of its
property block.  This engine makes row ownership a schedule knob and
keeps the rest local:

* **row ownership**: each shard stores the out-edge rows of its
  partition range (``graph/partition.py``: ``block`` or
  degree-balanced); property ownership stays block-identity, so the
  algorithms' global-id-indexed properties stay valid;
* **halo region**: each shard keeps ghost property slots for the foreign
  endpoints of its rows (``graph/halo.py``);
* **halo exchange**: a sweep does one packed ``all_to_all`` per
  direction per dtype group: owners push boundary values into ghosts
  (forward), ghost-side partial reductions fold back into owners
  (reverse), over static-shape tables;
* **halo misses ride the overflow lane**: an insert whose endpoint the
  tables cannot resolve records the id in a per-shard miss buffer and
  bumps a counter folded into the overflow counter the stream drivers
  poll; their rollback → grow → replay loop then rebuilds the partition
  with the missed ids as ghost hints at the same capacity.  A sweep drops
  unresolved edges only inside a segment that is sure to be replayed.

The per-shard bodies run over the leading local-shard axis of
``core/dist.py``'s seam (``StackedComm`` or ``GroupComm``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core import device_loop
from repro_torch.core.dist import (DistEngine, DistGraph, _all_reduce,
                                   _edge_arrays, _RowView, _segments)
from repro_torch.core.engine import Props, _StreamView
from repro_torch.core.ir import EdgeSweep
from repro_torch.graph import diffcsr
from repro_torch.graph.csr import CSR, INT
from repro_torch.graph.diffcsr import DynGraph
from repro_torch.graph.halo import build_plan
from repro_torch.graph.partition import PARTITIONERS, make_partition
from repro_torch.graph.updates import UpdateBatch
from repro_torch.runtime import faults as _faults
from repro_torch.tensors import cumsum32, segment_max, segment_min, set_drop

_DYN = tuple(f.name for f in dataclasses.fields(DynGraph) if f.name != "n")
_HALO = ("row_starts", "ghosts", "send_idx", "recv_tgt", "hmiss", "miss_buf")


@dataclasses.dataclass(frozen=True)
class ShardGraph(DistGraph):
    """A DistGraph plus the halo-exchange tables and the miss channel,
    all on the leading local-shard axis."""

    row_starts: torch.Tensor  # (L, P+1) row-ownership boundaries
    ghosts: torch.Tensor      # (L, H)   sorted ghost ids, pad n_pad
    send_idx: torch.Tensor    # (L, P, Hs) owner-local slots per reader, pad blk
    recv_tgt: torch.Tensor    # (L, P, Hs) halo slots per owner packet, pad H
    hmiss: torch.Tensor       # (L,)     cumulative halo-miss counter
    miss_buf: torch.Tensor    # (L, K)   missed global ids (ghost hints)


@dataclasses.dataclass(frozen=True)
class LocalShard:
    """One shard's view: its DynGraph plus its halo tables.  Reads of
    DynGraph attributes fall through to ``g``."""

    g: DynGraph
    row_starts: torch.Tensor  # (P+1,)
    ghosts: torch.Tensor      # (H,)
    send_idx: torch.Tensor    # (P, Hs)  what I (owner) send to each reader
    recv_tgt: torch.Tensor    # (P, Hs)  where each owner's packet lands
    hmiss: torch.Tensor       # ()
    miss_buf: torch.Tensor    # (K,)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "g"), name)


def _pack_dtype(dt: torch.dtype) -> torch.dtype:
    """Exchange-buffer dtype: ints and bools pack as int32, floats keep
    theirs (int32 weights like INF_W exceed float32's exact range)."""
    return dt if dt.is_floating_point else INT


def _dtype_groups(dtypes: Dict[str, torch.dtype]):
    groups: Dict[torch.dtype, list] = {}
    for k in sorted(dtypes):
        groups.setdefault(_pack_dtype(dtypes[k]), []).append(k)
    return sorted(groups.items(), key=lambda kv: str(kv[0]))


def _spread_pads(table: torch.Tensor, width: int) -> torch.Tensor:
    """An exchange table's slots (int64) with its pad lanes (== width)
    spread over a spare range ``[width, 2 * width)`` by lane index: the
    scatter then drops them without piling every pad on one address."""
    lane = torch.arange(table.shape[-1], device=table.device) % max(width, 1)
    return torch.where(table < width, table.long(), width + lane)


class ShardedEngine(DistEngine):
    """Backend ``dist_sharded``: partitioned diff-CSR + halo exchange."""

    name = "dist_sharded"
    # the miss buffer's floor; it holds at least two ids an add lane of
    # the pool's capacity (a segment's fresh adds fit the pool, else it
    # overflows), so one rebuild learns every id a segment missed.  At
    # the reference's fixed 256 a stream of 65,536-edge batches learns at
    # most 256 ids a shard a rebuild, one host merge each
    MISS_SLOTS = 256

    def __init__(self, num_shards: int | None = None, comm: str | None = None,
                 device=None, partitioner: str = "block"):
        super().__init__(num_shards=num_shards, comm=comm, device=device)
        if partitioner not in PARTITIONERS:
            raise ValueError(
                f"unknown partitioner {partitioner!r}; "
                f"expected one of {PARTITIONERS}")
        self.partitioner = partitioner
        self._partition = None
        self._plan = None
        # ghost hints accumulate across halo-miss rebuilds: the rebuild of
        # a rolled-back snapshot cannot see the inserts that missed, so
        # their ids are added as ghosts everywhere and kept (rebuild rounds
        # must not forget each other's ids, or more than the miss buffer's
        # distinct misses could livelock the replay loop)
        self._ghost_hints: np.ndarray | None = None
        self._last_miss = None
        # grows served: halo-only rebuilds and pool growths
        self.rebuilds = {"halo": 0, "pool": 0}

    # -- per-shard views ---------------------------------------------------
    def _local(self, h, l: int) -> LocalShard:
        g = DynGraph(**{f: getattr(h, f)[l] for f in _DYN}, n=h.n)
        return LocalShard(g=g, **{f: getattr(h, f)[l] for f in _HALO})

    def _leaves(self, loc: LocalShard) -> dict:
        out = {f: getattr(loc.g, f) for f in _DYN}
        out.update({f: getattr(loc, f) for f in _HALO})
        return out

    def _graph(self, loc: LocalShard) -> DynGraph:
        return loc.g

    def _compact_local(self, loc: LocalShard) -> LocalShard:
        return dataclasses.replace(loc, g=diffcsr.compact(loc.g))

    # -- construction ------------------------------------------------------
    def _ghost_sets(self, csr: CSR, starts: np.ndarray) -> list:
        """``halo.ghost_sets`` on the device: per shard, the sorted
        endpoints of its rows (and the ghost hints) whose property block
        is another shard's."""
        blk, dev = self._block, self.device
        cuts = csr.offsets[torch.as_tensor(starts, device=dev)].cpu() \
            .numpy().astype(np.int64)
        hints = (torch.as_tensor(self._ghost_hints, dtype=torch.int64,
                                 device=dev)
                 if self._ghost_hints is not None else
                 torch.zeros(0, dtype=torch.int64, device=dev))
        out = []
        for p in range(self.P):
            a, b = int(cuts[p]), int(cuts[p + 1])
            ends = torch.cat([csr.src[a:b].long(), csr.dst[a:b].long(),
                              hints])
            ends = torch.unique(ends[(ends // blk) != p])
            out.append(ends.cpu().numpy())
        return out

    def prepare(self, csr: CSR, diff_capacity: int) -> ShardGraph:
        n = self._n = csr.n
        blk = self._block = -(-n // self.P)
        csr = csr.to(self.device)
        src = (csr.src.cpu().numpy() if self.partitioner == "degree"
               else None)
        part = make_partition(self.partitioner, n, self.P, src)
        self._partition = part
        leaves = self._stack_shards(csr, part.starts, diff_capacity)
        plan = build_plan(self._ghost_sets(csr, part.starts), self.P, blk,
                          self.n_pad)
        self._plan = plan
        ids = self.comm.shard_ids
        L, dev = self.L, self.device
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return ShardGraph(
            **leaves,
            row_starts=put(np.tile(part.starts.astype(np.int32)[None],
                                   (L, 1))),
            ghosts=put(plan.ghosts[ids]),
            send_idx=put(plan.send_idx[ids]),
            recv_tgt=put(plan.recv_tgt[ids]),
            hmiss=torch.zeros((L,), dtype=INT, device=dev),
            miss_buf=torch.full(
                (L, max(self.MISS_SLOTS, 2 * int(diff_capacity))),
                self.n_pad, dtype=INT, device=dev),
            n=n)

    # -- durable state -----------------------------------------------------
    # the "dist" snapshot; the restoring engine re-partitions with ITS
    # partitioner (a schedule choice, not graph state)
    def pack_state(self, sg: ShardGraph):
        tree, meta = super().pack_state(sg)
        meta["partitioner"] = self.partitioner
        return tree, meta

    # -- streaming executor hooks ------------------------------------------
    def handle_counters(self, sg: ShardGraph) -> torch.Tensor:
        """(overflow + halo misses, used, dead): the miss count in the
        overflow lane makes the drivers' rollback-grow-replay loop serve
        halo rebuilds unchanged.  Outside a capture the post-run miss
        state is kept for ``grow``."""
        if not device_loop.capturing():
            self._last_miss = (sg.hmiss, sg.miss_buf, sg.overflow)
        cnt = super().handle_counters(sg)
        return torch.cat([cnt[:1] + _all_reduce(self.comm, sg.hmiss,
                                                "sum")[0:1], cnt[1:]])

    def _segment_runner(self, step_fn, handle, carry, batch_size: int,
                        count: int):
        run = super()._segment_runner(step_fn, handle, carry, batch_size,
                                      count)

        def stash(h, c, b):
            h, c, counters = run(h, c, b)
            self._last_miss = (h.hmiss, h.miss_buf, h.overflow)
            return h, c, counters
        return stash

    def grow(self, sg: ShardGraph, factor: float = 2.0) -> ShardGraph:
        """Rollback service: a pure halo miss rebuilds the partition at
        the SAME capacity with the missed ids as ghost hints; a pool
        overflow grows the capacity.  One host read of the gathered
        post-run and pre-run counters."""
        cap = int(sg.d_src.shape[1])
        _faults.fire("pool_merge", engine=self.name, diff_capacity=cap)
        self._evict_stream_cache(self._handle_shape_key(sg))
        stash, self._last_miss = self._last_miss, None
        halo_only = False
        if stash is not None:
            c = self.comm
            post_hm, post_buf, post_of = (c.all_gather(x) for x in stash)
            pre_hm, pre_of = c.all_gather(sg.hmiss), c.all_gather(sg.overflow)
            host = torch.cat([post_buf.reshape(-1), torch.stack([
                post_hm.sum(), post_of.sum(), pre_hm.sum(), pre_of.sum()])
                .to(post_buf.dtype)]).cpu().numpy()
            ids = host[:-4]
            ids = ids[(ids >= 0) & (ids < self.n_pad)]
            if ids.size:
                prev = (self._ghost_hints if self._ghost_hints is not None
                        else ids[:0])
                self._ghost_hints = np.union1d(prev, ids)
            s_post_hm, s_post_of, s_pre_hm, s_pre_of = host[-4:]
            halo_only = s_post_hm > s_pre_hm and s_post_of <= s_pre_of
        self.rebuilds["halo" if halo_only else "pool"] += 1
        new_cap = cap if halo_only else max(int(cap * factor), cap + 16)
        return self.merge(sg, diff_capacity=new_cap)

    def _handle_shape_key(self, sg: ShardGraph) -> tuple:
        return (int(sg.src.shape[1]), int(sg.d_src.shape[1]),
                int(sg.ghosts.shape[1]), int(sg.send_idx.shape[2]))

    def _static_leaves(self, sg: ShardGraph) -> tuple:
        return (sg.offsets, sg.src, sg.dst, sg.row_starts, sg.ghosts,
                sg.send_idx, sg.recv_tgt)

    def static_wedge_bounds(self, sg: ShardGraph):
        """(max main degree, diff capacity): one host read per main
        region (cached on its offsets tensor)."""
        return self._max_degree("main", sg.offsets), int(sg.d_src.shape[1])

    def stream_view(self, bounds=None):
        # the sharded stream counts wedges (with the segment's static
        # bounds), which plain dist's view refuses
        return _StreamView(self, bounds)

    # -- halo exchange -----------------------------------------------------
    def _halo_forward(self, sg: ShardGraph, vals: Props) -> Props:
        """Owner → ghost refresh: ``vals`` (L, block) per name; for each
        dtype group one (L, P, Hs, C) buffer of the boundary values each
        reader needs, one ``all_to_all``, scattered into the (L, H) halo
        strip.  Pad lanes land on ``recv_tgt`` pads (== H) and drop."""
        if not vals:
            return {}
        L, blk = self.L, self._block
        H = int(sg.ghosts.shape[1])
        rows = torch.arange(L, device=self.device)[:, None, None]
        idx = sg.send_idx.clamp(0, max(blk - 1, 0)).long()
        tgt = _spread_pads(sg.recv_tgt, H)
        out = {}
        for dt, names in _dtype_groups({k: v.dtype for k, v in vals.items()}):
            sbuf = torch.stack([vals[k][rows, idx].to(dt) for k in names],
                               -1)                          # (L, P, Hs, C)
            rbuf = self.comm.all_to_all(sbuf)
            hbuf = torch.zeros((L, 2 * H, len(names)), dtype=dt,
                               device=self.device).index_put(
                (rows.expand(tgt.shape), tgt), rbuf)
            for c, k in enumerate(names):
                out[k] = hbuf[:, :H, c].to(vals[k].dtype)
        return out

    def _halo_reverse(self, sg: ShardGraph, items: dict) -> dict:
        """Ghost partials → owner fold.  ``items`` maps a name to
        ``(ghost (L, H), base (L, block), fold, ident)``; returns the
        folded (L, block) owner values.  The plan runs backwards: readers
        send their ghost partials at ``recv_tgt``, owners fold the packets
        into their block at ``send_idx`` (pads, == block, drop).  Float
        sums fold one packet after another in shard order, so the adds
        into one slot keep a fixed order."""
        if not items:
            return {}
        L, blk, P = self.L, self._block, self.P
        H = int(sg.ghosts.shape[1])
        rows = torch.arange(L, device=self.device)[:, None, None]
        safe = sg.recv_tgt.clamp(0, max(H - 1, 0)).long()
        valid = sg.recv_tgt < H
        si = _spread_pads(sg.send_idx, blk)
        out = {}
        for dt, names in _dtype_groups({k: v[1].dtype
                                        for k, v in items.items()}):
            cols = []
            for k in names:
                ghost, base, fold, ident = items[k]
                cols.append(torch.where(valid, ghost[rows, safe].to(dt),
                                        ident))
            rbuf = self.comm.all_to_all(torch.stack(cols, -1))
            for c, k in enumerate(names):
                ghost, base, fold, ident = items[k]
                col = rbuf[..., c].to(base.dtype)            # (L, P, Hs)
                ext = torch.cat([base, base.new_zeros((L, blk))], 1)
                if fold == "add" and base.dtype.is_floating_point:
                    r2 = rows[:, :, 0]
                    for j in range(P):
                        ext = ext.index_put((r2.expand(si[:, j].shape),
                                             si[:, j]), col[:, j],
                                            accumulate=True)
                elif fold == "add":
                    ext = ext.scatter_add(1, si.reshape(L, -1),
                                          col.reshape(L, -1))
                else:
                    ext = ext.scatter_reduce(
                        1, si.reshape(L, -1), col.reshape(L, -1),
                        "amin" if fold == "min" else "amax")
                out[k] = ext[:, :blk]
        return out

    # -- core sweep --------------------------------------------------------
    def _sweep_local(self, sg: ShardGraph, sw: EdgeSweep, lp: Props,
                     read_set) -> Props:
        """One sweep over (L·block,) local properties.  Edge endpoints
        resolve into the (block + halo) strip: owned ids into the block,
        foreign ids by a search of the sorted ghost table.  Reductions
        land in (block + H + 1) lanes per shard whose ghost part folds
        back to the owners through the reverse exchange.  Unresolved
        endpoints (only edges inserted after the tables were built) drop
        out: their inserts already bumped the miss counter, so the driver
        replays the segment on rebuilt tables."""
        _faults.fire("kernel_launch", engine=self.name, op="sweep")
        L, blk, n_pad = self.L, self._block, self.n_pad
        H = int(sg.ghosts.shape[1])
        drop = blk + H
        me = self.comm.shard_index()[:, None]
        es, ed, ew, ea = _edge_arrays(sg)

        def resolve(v):
            owned = (v // blk) == me
            slot = torch.searchsorted(sg.ghosts, v).clamp(0, max(H - 1, 0))
            found = sg.ghosts.gather(1, slot) == v
            ref = torch.where(owned, v - me * blk,
                              torch.where(found, blk + slot, drop))
            return ref, owned | found

        sref, s_ok = resolve(es)
        dref, d_ok = resolve(ed)
        ok = s_ok & d_ok & ea
        gs = sref.clamp(0, drop - 1)
        gd = dref.clamp(0, drop - 1)

        local = {k: v.view(L, blk) for k, v in lp.items()}
        halo = self._halo_forward(sg, {k: local[k] for k in read_set
                                       if k in local})
        comb = {k: torch.cat([local[k], halo[k]], 1) for k in halo}
        out = sw.edge_fn(_RowView(comb, gs), _RowView(comb, gd), ew)

        seg, num = _segments(ok, dref, drop + 1)
        keep = L * (drop + 1)
        items, post_or = {}, set()
        for target, red in sw.reduces.items():
            if red.kind == "argmin":
                continue
            val, elig = out[target]
            elig = elig & ok
            ident = red.identity(val.dtype)
            v = torch.where(elig, val, ident)
            dense = red.segment(v.reshape(-1), seg, num)[:keep] \
                .view(L, drop + 1)
            if red.kind == "or":
                dense = dense.to(INT)
                items["v:" + target] = (dense[:, blk:drop], dense[:, :blk],
                                        "max", 0)
                post_or.add(target)
            elif red.kind == "sum":
                items["v:" + target] = (dense[:, blk:drop], dense[:, :blk],
                                        "add", 0)
            else:
                items["v:" + target] = (dense[:, blk:drop], dense[:, :blk],
                                        red.kind, ident)
            h = segment_max(elig.to(INT).reshape(-1), seg, num)[:keep] \
                .view(L, drop + 1)
            items["h:" + target] = (h[:, blk:drop], h[:, :blk], "max", 0)
        folded = self._halo_reverse(sg, items)
        reduced, hit = {}, {}
        for target, red in sw.reduces.items():
            if red.kind == "argmin":
                continue
            r = folded["v:" + target]
            reduced[target] = (r > 0) if target in post_or else r
            hit[target] = folded["h:" + target] > 0

        amins = {t: r for t, r in sw.reduces.items() if r.kind == "argmin"}
        if amins:
            # second pass: forward the folded minima so every shard can
            # test achievement, then min-fold the achieving GLOBAL source
            # ids (the single-device smallest-source tie-break)
            ofs = sorted({r.of for r in amins.values()})
            fwd = self._halo_forward(sg, {of: reduced[of] for of in ofs})
            cof = {of: torch.cat([reduced[of], fwd[of]], 1) for of in ofs}
            aitems = {}
            for target, red in amins.items():
                val, elig = out[red.of]
                achieved = elig & ok & (val == cof[red.of].gather(1, gd))
                dense = segment_min(torch.where(achieved, es, n_pad)
                                    .reshape(-1), seg, num)[:keep] \
                    .view(L, drop + 1)
                aitems["a:" + target] = (dense[:, blk:drop], dense[:, :blk],
                                         "min", n_pad)
            afold = self._halo_reverse(sg, aitems)
            for target, red in amins.items():
                reduced[target] = afold["a:" + target]
                hit[target] = hit[red.of]
        return sw.post_fn(lp, {k: v.reshape(-1) for k, v in reduced.items()},
                          {k: v.reshape(-1) for k, v in hit.items()})

    # -- dynamic updates (row-ownership-masked, miss-recording) ------------
    def _row_owner(self, loc: LocalShard, v):
        return torch.searchsorted(loc.row_starts, v.to(INT).contiguous(),
                                  right=True) - 1

    def _covered(self, loc: LocalShard, v, p: int):
        H = int(loc.ghosts.shape[0])
        owned = (v // self._block) == p
        slot = torch.searchsorted(loc.ghosts, v.contiguous()).clamp(
            0, max(H - 1, 0))
        return owned | (loc.ghosts[slot] == v)

    def _note_misses(self, loc: LocalShard, ids, mask, p: int) -> LocalShard:
        """Record endpoints the halo tables cannot resolve.  The counter
        is cumulative (a replayed segment re-counts from the snapshot's
        value) and rides the overflow lane; the buffer keeps the first
        ids its width holds as ghost hints for the rebuild."""
        K = int(loc.miss_buf.shape[0])
        miss = (mask & ~self._covered(loc, ids, p)).to(INT)
        pos = loc.hmiss + cumsum32(miss) - 1
        pos = torch.where((miss > 0) & (pos < K), pos, K)
        buf = set_drop(loc.miss_buf, pos, ids.to(INT))
        return dataclasses.replace(loc, hmiss=loc.hmiss + miss.sum(dtype=INT),
                                   miss_buf=buf)

    def _update_del_local(self, p: int, loc: LocalShard, b: UpdateBatch):
        own = self._row_owner(loc, b.del_src) == p
        # deletes tombstone resident rows: no new endpoints, no halo growth
        return dataclasses.replace(loc, g=diffcsr.update_csr_del(
            loc.g, b.del_src, b.del_dst, b.del_mask & own))

    def _update_add_local(self, p: int, loc: LocalShard, b: UpdateBatch):
        m = b.add_mask & (self._row_owner(loc, b.add_src) == p)
        loc = dataclasses.replace(loc, g=diffcsr.update_csr_add(
            loc.g, b.add_src, b.add_dst, b.add_w, m))
        ids = torch.cat([b.add_src, b.add_dst]).to(INT)
        return self._note_misses(loc, ids, torch.cat([m, m]), p)
