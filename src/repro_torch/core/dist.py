"""DistEngine — the MPI backend analogue (counterpart of ``repro.core.dist``).

The reference's distributed design (paper §3.6/§5.2), on a shard seam of
its own instead of ``shard_map``:

* **vertex ownership**: vertices are block-partitioned, ``block =
  ceil(n / P)``; each shard holds its own out-edges as a full DynGraph
  (CSR and diff-CSR), padded to the largest shard's edge count;
* **distributed diff-CSR**: every shard sees each update batch and
  applies the updates whose source it owns (``update_csr_add/del``);
* **RMA windows → all_gather**: a sweep gathers only the properties its
  edge function reads (the read set);
* **MPI_Accumulate(MIN/SUM) → all_reduce**: each shard reduces its edges
  into an ``n_pad``-long buffer, combined across shards by one
  deterministic reduction;
* **TC's remote-neighbourhood queries**: query all_gathers plus a max
  combine per wedge step, the paper's admitted MPI bottleneck, kept.

The seam.  Each engine method's per-shard body is written once, over a
leading local-shard axis of length L, against a small communicator:

* :class:`StackedComm` — all P shards in this process on one device
  (L = P): ``all_gather`` is a reshape, a reduction runs over axis 0,
  ``all_to_all`` is a transpose.  The default without a process group.
* :class:`GroupComm` — one shard a ``torch.distributed`` rank (L = 1):
  NCCL on the card, gloo on the CPU.  Chosen by ``comm="group"`` or by an
  initialised default group; it never falls back to a stacked run.

Vertex properties cross the engine's surface as whole ``(n_pad,)``
tensors (every rank holds all of them under ``GroupComm``); inside a
method each shard works on its ``(block,)`` slice.  Per-shard local work
(the updates, compaction, lane flags, the wedge walk's searches) loops
over the L shards; no sweep or update reads the host.  ``run_stream``
runs the fused executor on ``StackedComm`` (one captured segment on the
card) and the per-batch driver on ``GroupComm``.  No kernel of
``csrc/`` is on this path, as no Pallas kernel is on the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core import device_loop
from repro_torch.core.engine import (Collectives, Engine, Props, WedgeCtx,
                                     _StreamView, _View, edge_lane_flags)
from repro_torch.core.ir import EdgeSweep, Reduce
from repro_torch.graph import diffcsr
from repro_torch.graph.csr import CSR, INT, build_csr
from repro_torch.graph.diffcsr import BOOL, DynGraph
from repro_torch.graph.updates import UpdateBatch
from repro_torch.runtime import faults as _faults
from repro_torch.tensors import segment_max, segment_min

_DYN = tuple(f.name for f in dataclasses.fields(DynGraph) if f.name != "n")


# ---------------------------------------------------------------------------
# the shard seam
# ---------------------------------------------------------------------------

class StackedComm:
    """Every shard in this process, stacked on axis 0 (L = P)."""

    kind = "stacked"

    def __init__(self, P: int, device):
        self.P = self.L = int(P)
        self.device = torch.device(device)
        self.shard_ids = list(range(self.P))

    def shard_index(self) -> torch.Tensor:
        return torch.arange(self.P, device=self.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) per-shard pieces → the (P, ...) stack of all of them."""
        return x

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """(L, ...) → (L, ...), each shard holding the reduction over all
        P shards (``op``: min, max or sum; sums add shard 0 first)."""
        if op == "sum":
            out = x[0]
            for p in range(1, self.P):
                out = out + x[p]
        elif op == "min":
            out = x.amin(0)
        elif op == "max":
            out = x.amax(0)
        else:
            raise ValueError(op)
        return out.unsqueeze(0).expand(x.shape)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(L, P, ...): ``x[l, j]`` goes to shard j; returns (L, P, ...)
        with ``out[l, j]`` what shard j sent to shard l."""
        return x.transpose(0, 1)

    def to_local(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def to_global(self, v: torch.Tensor) -> torch.Tensor:
        return v


class GroupComm:
    """One shard a rank of a ``torch.distributed`` group (L = 1)."""

    kind = "group"

    def __init__(self, group, device):
        import torch.distributed as tdist
        self._d = tdist
        self.group = group
        self.P = tdist.get_world_size(group)
        self.rank = tdist.get_rank(group)
        self.L = 1
        self.device = torch.device(device)
        self.shard_ids = [self.rank]
        self._gather = getattr(tdist, "all_gather_single", None) or \
            tdist.all_gather_into_tensor

    def shard_index(self) -> torch.Tensor:
        return torch.full((1,), self.rank, dtype=torch.int64,
                          device=self.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == BOOL:
            return self.all_gather(x.view(torch.uint8)).view(BOOL)
        x = x.contiguous()
        out = x.new_empty((self.P,) + tuple(x.shape[1:]))
        self._gather(out, x, group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        ops = {"min": self._d.ReduceOp.MIN, "max": self._d.ReduceOp.MAX,
               "sum": self._d.ReduceOp.SUM}
        out = x.clone(memory_format=torch.contiguous_format)
        self._d.all_reduce(out, ops[op], group=self.group)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        src = x[0].contiguous()
        out = torch.empty_like(src)
        self._d.all_to_all_single(out, src, group=self.group)
        return out.unsqueeze(0)

    def to_local(self, v: torch.Tensor) -> torch.Tensor:
        blk = v.shape[0] // self.P
        return v[self.rank * blk:(self.rank + 1) * blk]

    def to_global(self, v: torch.Tensor) -> torch.Tensor:
        return self.all_gather(v.unsqueeze(0)).reshape(-1)


def _all_reduce(comm, x: torch.Tensor, op: str) -> torch.Tensor:
    """``comm.all_reduce`` for any dtype: bools combine as int32 (``or`` is
    a max), the result cast back."""
    if x.dtype == BOOL:
        return comm.all_reduce(x.to(INT), "max") > 0
    return comm.all_reduce(x, op)


def _pcombine(comm, red: Reduce, x: torch.Tensor) -> torch.Tensor:
    if red.kind in ("min", "argmin"):
        return _all_reduce(comm, x, "min")
    if red.kind == "max":
        return _all_reduce(comm, x, "max")
    if red.kind == "sum":
        return _all_reduce(comm, x, "sum")
    if red.kind == "or":
        return _all_reduce(comm, x, "max")
    raise ValueError(red.kind)


def _segments(live: torch.Tensor, tgt: torch.Tensor, width: int):
    """Segment ids of (L, M) lanes for per-shard reductions into ``width``
    lanes each: a live lane's ``tgt`` in its shard's range; a dead lane
    (a shard's padding, a vacant pool slot, an unresolved endpoint) in a
    spare range of ``width`` segments after them, spread by lane index.
    Returns ``(ids, segments)``; reduce into ``segments`` and keep the
    first ``L * width``.  The dead lanes would add only the identity,
    but all on one vertex (padding and vacant slots point at 0), and a
    segment that long serialises the card's atomics and the float sum's
    in-order walk."""
    L, M = tgt.shape
    num = L * width
    base = (torch.arange(L, device=tgt.device) * width)[:, None]
    spare = num + torch.arange(M, device=tgt.device) % width
    ids = torch.where(live, tgt.long() + base, spare)
    return ids.reshape(-1), num + width


def _host_fetch(t: torch.Tensor) -> np.ndarray:
    """ONE device-to-host copy (the seam the tests count): ``pack_state``
    and ``merge`` harvest every shard's edges through one call, not one
    per shard."""
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# handles
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DistGraph:
    """The local shards' DynGraphs stacked on a leading axis of length L."""

    offsets: torch.Tensor   # (L, n+1)
    src: torch.Tensor       # (L, Emax)
    dst: torch.Tensor
    w: torch.Tensor
    alive: torch.Tensor
    d_offsets: torch.Tensor
    d_src: torch.Tensor     # (L, D)
    d_dst: torch.Tensor
    d_w: torch.Tensor
    d_alive: torch.Tensor
    overflow: torch.Tensor  # (L,)
    n: int


def _edge_arrays(h) -> tuple:
    """``DynGraph.edge_arrays`` of every local shard: (L, Emax + D)."""
    n = h.n
    return (torch.cat([h.src, h.d_src.clamp(max=n - 1)], 1),
            torch.cat([h.dst, h.d_dst], 1),
            torch.cat([h.w, h.d_w], 1),
            torch.cat([h.alive, h.d_alive & (h.d_src < n)], 1))


class DistCollectives(Collectives):
    """Fixed-point conditions over (L·block,) local properties: each
    shard reduces its block, the shards combine through the seam."""

    def __init__(self, comm):
        self.comm = comm

    def _per_shard(self, x):
        return x.reshape(self.comm.L, -1)

    def any(self, x):
        return _all_reduce(self.comm, self._per_shard(x).any(1), "max")[0]

    def sum(self, x):
        return _all_reduce(self.comm, self._per_shard(x).sum(1), "sum")[0]

    def max(self, x):
        return _all_reduce(self.comm, self._per_shard(x).amax(1), "max")[0]


class _RowView:
    """Per-shard gathered endpoint view: ``props[k]`` is (L, width),
    ``idx`` (L, M)."""

    __slots__ = ("_p", "_i")

    def __init__(self, props, idx):
        self._p = props
        self._i = idx

    def __getitem__(self, k):
        return self._p[k].gather(1, self._i)


class _DistWedgeCtx(WedgeCtx):
    """WedgeCtx over (L, E+D) lanes: lane flags are per shard."""

    def nbr_flag(self, name: str) -> torch.Tensor:
        fl = self._lane_flags[name]
        return fl.gather(1, self._nbr_lane.clamp(0, fl.shape[1] - 1))


class _DistStreamView(_StreamView):
    """The engine facade handed to stream steps.  As the reference's, it
    has no ``src_flags_from_dst`` (decremental repair takes its dense
    seed) and refuses wedge enumeration inside the fused stream."""

    def count_wedges(self, handle, pair_fn, lane_flags, out_example,
                     bounds=None):
        raise NotImplementedError(
            "wedge enumeration (TC) is not supported inside DistEngine's "
            "fused stream; use the per-batch dyn_tc path on dist")


# ---------------------------------------------------------------------------
# DistEngine
# ---------------------------------------------------------------------------

class DistEngine(Engine):
    name = "dist"

    # shared_engine keys instances of mesh-bound engines by their shard
    # count (registry._mesh_token)
    mesh_scoped = True

    def __init__(self, num_shards: int | None = None, comm: str | None = None,
                 device=None):
        """``comm``: "stacked" (P = ``num_shards`` shards in this process)
        or "group" (one shard a rank of the default process group); None
        takes the group when one is initialised."""
        import torch.distributed as tdist
        grouped = tdist.is_available() and tdist.is_initialized()
        if comm not in (None, "stacked", "group"):
            raise ValueError(f"comm must be 'stacked' or 'group', "
                             f"got {comm!r}")
        if comm == "group" or (comm is None and grouped):
            if not grouped:
                raise RuntimeError(
                    "comm='group' needs an initialised torch.distributed "
                    "process group")
            world = tdist.get_world_size()
            if num_shards not in (None, world):
                raise ValueError(
                    f"num_shards={num_shards} but the process group has "
                    f"{world} ranks (one shard a rank)")
            if device is None and torch.cuda.is_available():
                device = f"cuda:{tdist.get_rank() % torch.cuda.device_count()}"
            super().__init__(device)
            self.comm = GroupComm(None, self.device)
        else:
            super().__init__(device)
            self.comm = StackedComm(num_shards or 1, self.device)
        self.P = self.comm.P
        self._block = None
        self._wedge_max: Dict[str, tuple] = {}

    # ------------------------------------------------------------------ #
    @property
    def n_pad(self) -> int:
        return self._block * self.P

    @property
    def block(self) -> int:
        return self._block

    @property
    def L(self) -> int:
        return self.comm.L

    def _take_block(self, x: torch.Tensor) -> torch.Tensor:
        """(L, n_pad) with every row a global vector → each shard's own
        block, flattened to (L·block,)."""
        L = self.L
        rows = torch.arange(L, device=x.device)
        return x.reshape(L, self.P, self._block)[
            rows, self.comm.shard_index()].reshape(-1)

    # -- per-shard views ---------------------------------------------------
    def _local(self, h, l: int):
        return DynGraph(**{f: getattr(h, f)[l] for f in _DYN}, n=h.n)

    def _leaves(self, loc) -> dict:
        return {f: getattr(loc, f) for f in _DYN}

    def _map_shards(self, h, fn):
        """``fn(p, local) -> local`` over the L local shards (p the global
        shard id), restacked; a leaf no shard changed keeps its tensor."""
        before = [self._local(h, l) for l in range(self.L)]
        after = [fn(p, loc) for p, loc in zip(self.comm.shard_ids, before)]
        b = [self._leaves(x) for x in before]
        a = [self._leaves(x) for x in after]
        changed = {k: torch.stack([x[k] for x in a]) for k in a[0]
                   if any(x[k] is not y[k] for x, y in zip(a, b))}
        return dataclasses.replace(h, **changed) if changed else h

    # -- construction ------------------------------------------------------
    def _stack_shards(self, csr: CSR, starts: np.ndarray,
                      diff_capacity: int) -> dict:
        """Each local shard's out-edges as a DynGraph's leaves, stacked.
        Shard p owns the rows ``[starts[p], starts[p+1])``: a slice of the
        CSR, which is sorted by (src, dst) as the reference's per-shard
        ``build_csr`` leaves it; padded to the largest shard's count."""
        n = csr.n
        dev = self.device
        csr = csr.to(dev)
        cuts = csr.offsets[torch.as_tensor(starts, device=dev)].cpu() \
            .numpy().astype(np.int64)
        emax = max(1, int((cuts[1:] - cuts[:-1]).max()))
        D = max(int(diff_capacity), 1)
        rows = {f: [] for f in ("offsets", "src", "dst", "w", "alive")}
        for p in self.comm.shard_ids:
            a, b = int(cuts[p]), int(cuts[p + 1])
            k, pad = b - a, emax - (b - a)
            z = lambda size, dt=INT: torch.zeros(size, dtype=dt, device=dev)
            rows["offsets"].append(csr.offsets.clamp(a, b) - a)
            rows["src"].append(torch.cat([csr.src[a:b], z(pad)]))
            rows["dst"].append(torch.cat([csr.dst[a:b], z(pad)]))
            rows["w"].append(torch.cat([csr.w[a:b], torch.ones(
                pad, dtype=INT, device=dev)]))
            rows["alive"].append(torch.cat([torch.ones(k, dtype=BOOL,
                                                       device=dev),
                                            z(pad, BOOL)]))
        L = self.L
        out = {f: torch.stack(v) for f, v in rows.items()}
        out.update(
            d_offsets=torch.zeros((L, n + 1), dtype=INT, device=dev),
            d_src=torch.full((L, D), n, dtype=INT, device=dev),
            d_dst=torch.zeros((L, D), dtype=INT, device=dev),
            d_w=torch.zeros((L, D), dtype=INT, device=dev),
            d_alive=torch.zeros((L, D), dtype=BOOL, device=dev),
            overflow=torch.zeros((L,), dtype=INT, device=dev))
        return out

    def prepare(self, csr: CSR, diff_capacity: int) -> DistGraph:
        self._n = csr.n
        self._block = -(-csr.n // self.P)
        starts = np.minimum(np.arange(self.P + 1) * self._block, csr.n)
        leaves = self._stack_shards(csr, starts, diff_capacity)
        return DistGraph(**leaves, n=csr.n)

    def _gather_edges(self, h):
        """The global alive edge set ``(src, dst, w)`` in shard-major
        ``[main, diff]`` lane order: the shards' lanes gathered, the dead
        ones dropped on the device, then ONE host copy (``_host_fetch``)."""
        es, ed, ew, ea = _edge_arrays(h)
        lanes = self.comm.all_gather(torch.stack([es, ed, ew, ea.to(INT)],
                                                 1))          # (P, 4, M)
        lanes = lanes.transpose(0, 1).reshape(4, -1)
        host = _host_fetch(lanes[:3, lanes[3] > 0])
        return host[0], host[1], host[2]

    def merge(self, h, diff_capacity: int | None = None):
        """Gather the alive edges, rebuild on the host, re-partition."""
        src, dst, w = self._gather_edges(h)
        csr = build_csr(h.n, np.stack([src, dst], 1), w, device=self.device)
        if diff_capacity is None:
            diff_capacity = max(int(h.d_src.shape[1]), 1)
        return self.prepare(csr, diff_capacity=diff_capacity)

    def out_degrees(self, h) -> torch.Tensor:
        es, _, _, ea = _edge_arrays(h)
        L, n_pad = self.L, self.n_pad
        seg, num = _segments(ea, es, n_pad)
        dense = torch.zeros((num,), dtype=INT, device=es.device).index_add_(
            0, seg, ea.to(INT).reshape(-1))[:L * n_pad].view(L, n_pad)
        dense = _all_reduce(self.comm, dense, "sum")
        return self.comm.to_global(self._take_block(dense))

    def per_shard_bytes(self, h) -> int:
        """Resident bytes of ONE shard (the memory-scaling metric: one
        DynGraph holds the whole edge set, a shard its rows plus, on
        ``dist_sharded``, the halo tables)."""
        total = 0
        for f in dataclasses.fields(h):
            a = getattr(h, f.name)
            if isinstance(a, torch.Tensor):
                total += (int(np.prod(a.shape[1:], dtype=np.int64))
                          if a.dim() > 1 else 1) * a.element_size()
        return total

    # -- durable state -----------------------------------------------------
    # The canonical global edge list, not the (P, ...) shard leaves: a
    # restore re-partitions onto the restoring engine's P, so a session
    # can come back on another shard count (value-exact for integer
    # results; float sums may re-associate).
    state_kind = "dist"

    def pack_state(self, h):
        src, dst, w = self._gather_edges(h)
        tree = {"src": torch.from_numpy(src), "dst": torch.from_numpy(dst),
                "w": torch.from_numpy(w)}
        meta = {"kind": "dist", "n": h.n,
                "diff_capacity": int(h.d_src.shape[1]),
                "num_shards": self.P}
        return tree, meta

    def unpack_state(self, tree, meta):
        src, dst, w = (np.asarray(tree[k]) for k in ("src", "dst", "w"))
        csr = build_csr(meta["n"], np.stack([src, dst], 1), w,
                        device=self.device)
        # prepare() blocks over THIS engine's P: the re-mesh happens here
        return self.prepare(csr,
                            diff_capacity=max(int(meta["diff_capacity"]), 1))

    # -- streaming executor hooks ------------------------------------------
    def handle_counters(self, h) -> torch.Tensor:
        """(overflow, used, dead): overflow summed over shards, pool
        occupancy as the worst shard (capacity is per shard)."""
        mat = h.d_src < h.n
        used = mat.sum(1, dtype=INT)
        dead = (mat & ~h.d_alive).sum(1, dtype=INT)
        return torch.cat([
            _all_reduce(self.comm, h.overflow, "sum")[:1],
            _all_reduce(self.comm, torch.stack([used, dead], 1),
                        "max")[0]])

    def grow(self, h, factor: float = 2.0):
        cap = int(h.d_src.shape[1])
        _faults.fire("pool_merge", engine=self.name, diff_capacity=cap)
        self._evict_stream_cache(self._handle_shape_key(h))
        return self.merge(h, diff_capacity=max(int(cap * factor), cap + 16))

    def compact_handle(self, h):
        return self._map_shards(h, lambda p, loc: self._compact_local(loc))

    def _compact_local(self, loc):
        return diffcsr.compact(loc)

    def _graph(self, loc) -> DynGraph:
        """The DynGraph of a local shard's view."""
        return loc

    def _diff_capacity(self, h) -> int:
        return int(h.d_src.shape[1])

    def _handle_shape_key(self, h) -> tuple:
        return (int(h.src.shape[1]), int(h.d_src.shape[1]))

    def _static_leaves(self, h) -> tuple:
        return (h.offsets, h.src, h.dst)

    def static_wedge_bounds(self, h):
        return None

    def stream_view(self, bounds=None):
        return _DistStreamView(self, bounds)

    def run_stream(self, handle, stream, batch_size: int, step_fn, carry,
                   segment_size: int = 8, compact_frac: float = 0.5):
        """Stacked: the fused executor (on the card one captured segment
        of batches).  One shard a rank: the per-batch driver."""
        if self.comm.kind == "stacked":
            return self._run_stream_fused(handle, stream, batch_size,
                                          step_fn, carry, segment_size,
                                          compact_frac)
        return Engine.run_stream(self, handle, stream, batch_size, step_fn,
                                 carry, segment_size, compact_frac)

    # -- core sweep ----------------------------------------------------------
    def _sweep_local(self, h, sw: EdgeSweep, lp: Props, read_set) -> Props:
        """One sweep over (L·block,) local properties: gather the read
        set, reduce each shard's edges into n_pad lanes, combine across
        shards, the argmin pass, then each shard's block."""
        _faults.fire("kernel_launch", engine=self.name, op="sweep")
        c, L, blk, n_pad = self.comm, self.L, self._block, self.n_pad
        full = {k: c.all_gather(v.view(L, blk)).reshape(-1)
                for k, v in lp.items() if k in read_set}
        es, ed, ew, ea = _edge_arrays(h)
        out = sw.edge_fn(_View(full, es), _View(full, ed), ew)
        seg, num = _segments(ea, ed, n_pad)
        keep = L * n_pad
        reduced, hit = {}, {}
        for target, red in sw.reduces.items():
            if red.kind == "argmin":
                continue
            val, elig = out[target]
            elig = elig & ea
            v = torch.where(elig, val, red.identity(val.dtype))
            dense = red.segment(v.reshape(-1), seg, num)[:keep]
            reduced[target] = _pcombine(c, red, dense.view(L, n_pad))
            hh = segment_max(elig.to(INT).reshape(-1), seg, num)[:keep]
            hit[target] = _all_reduce(c, hh.view(L, n_pad), "max") > 0
        for target, red in sw.reduces.items():
            if red.kind != "argmin":
                continue
            val, elig = out[red.of]
            achieved = elig & ea & (val == reduced[red.of].gather(
                1, ed.long()))
            dense = segment_min(torch.where(achieved, es, n_pad)
                                .reshape(-1), seg, num)[:keep].view(L, n_pad)
            reduced[target] = _all_reduce(c, dense, "min")
            hit[target] = hit[red.of]
        return sw.post_fn(lp, {k: self._take_block(v)
                               for k, v in reduced.items()},
                          {k: self._take_block(v) for k, v in hit.items()})

    def sweep(self, h, sw: EdgeSweep, props: Props) -> Props:
        read_set = frozenset(sw.read_set(props))
        c = self.comm
        lp = {k: c.to_local(v) for k, v in props.items()}
        out = self._sweep_local(h, sw, lp, read_set)
        return {k: c.to_global(v) for k, v in out.items()}

    def fixed_point(self, h, sw: EdgeSweep, props: Props,
                    cond_fn: Callable, max_iter: int) -> Props:
        """The reference's ``lax.while_loop`` through ``device_loop`` (a
        host read of the condition a trip, or a WHILE node in a captured
        segment); the condition combines across shards."""
        read_set = frozenset(sw.read_set(props))
        c = self.comm
        col = DistCollectives(c)
        lp = {k: c.to_local(v) for k, v in props.items()}
        _, lp = device_loop.while_loop(
            lambda s: (s[0] < max_iter) & cond_fn(s[1], s[0], col),
            lambda s: (s[0] + 1, self._sweep_local(h, sw, s[1], read_set)),
            (0, lp))
        return {k: c.to_global(v) for k, v in lp.items()}

    def vertex_map(self, h, fn: Callable, props: Props) -> Props:
        # every shard gathers the whole properties, applies fn and keeps
        # its block; the properties here are already whole
        return fn(props)

    # -- wedges (triangle counting) ------------------------------------------
    def _max_degree(self, region: str, offsets: torch.Tensor) -> int:
        """A region's max row length over every shard: one host read per
        offsets tensor, cached on its identity."""
        cached = self._wedge_max.get(region)
        if cached is None or cached[0] is not offsets:
            deg = (offsets[:, 1:] - offsets[:, :-1]).amax(1)
            self.deg_syncs += 1
            cached = (offsets, int(_all_reduce(self.comm, deg, "max")[0]))
            self._wedge_max[region] = cached
        return cached[1]

    def _device_degree(self, offsets: torch.Tensor) -> torch.Tensor:
        deg = (offsets[:, 1:] - offsets[:, :-1]).amax(1)
        return _all_reduce(self.comm, deg, "max")[0]

    def count_wedges(self, g, pair_fn: Callable,
                     lane_flags: Dict[str, torch.Tensor], out_example,
                     bounds=None):
        """Each shard walks its own lanes' wedges; an ``is_edge`` or
        ``edge_flag`` query is all-gathered, answered by every shard
        against its graph, max-combined and handed back (the paper's MPI
        TC).  Outside a capture the loops run to the max degree read once
        per offsets tensor; inside one they are WHILE nodes over the
        degree on the device.  Partial sums are per shard, summed across
        shards at the end."""
        c, L = self.comm, self.L
        es, ed, ew, ea = _edge_arrays(g)
        E, D = int(g.src.shape[1]), int(g.d_src.shape[1])
        graphs = [DynGraph(**{f: getattr(g, f)[l] for f in _DYN}, n=g.n)
                  for l in range(L)]
        rows = torch.arange(L, device=es.device)
        me = c.shard_index()
        on_device = device_loop.capturing()
        if on_device:
            counts = (None, None)
            rounds = (32, 32)
        else:
            counts = (self._max_degree("main", g.offsets),
                      self._max_degree("diff", g.d_offsets) if D else 0)
            rounds = tuple(min(x.bit_length(), 32) for x in counts)

        def answer(q, fn):
            """q (L, 2, M) → every shard's answer for every query, max
            over shards, each shard's own rows back: (L, M) bool."""
            qg = c.all_gather(q)                       # (P, 2, M)
            P, M = qg.shape[0], qg.shape[2]
            qs, qd = qg[:, 0].reshape(-1), qg[:, 1].reshape(-1)
            ans = torch.stack([fn(l, graphs[l], qs, qd).view(P, M)
                               for l in range(L)]).to(INT)
            return _all_reduce(c, ans, "max")[rows, me] > 0

        def is_edge_fn(qs, qd):
            return answer(torch.stack([qs, qd], 1),
                          lambda l, gl, a, b: diffcsr.is_edge(gl, a, b,
                                                              rounds))

        def edge_flag_fn(name, qs, qd):
            fl = lane_flags[name]

            def one(l, gl, a, b):
                p1, f1 = diffcsr._locate_main(gl, a, b, rounds[0])
                p2, f2 = diffcsr._locate_diff(gl, a, b, rounds[1])
                f = fl[l]
                r = torch.where(f1 & gl.alive[p1],
                                f[p1.clamp(0, E + D - 1)], False)
                return torch.where(f2 & gl.d_alive[p2] & ~f1,
                                   f[(E + p2).clamp(0, E + D - 1)], r)
            return answer(torch.stack([qs, qd], 1), one)

        single = not isinstance(out_example, tuple)
        total = tuple(torch.zeros((L,), dtype=x.dtype, device=self.device)
                      for x in ((out_example,) if single else out_example))
        for count, offsets, dst, alive, cap, base in (
                (counts[0], g.offsets, g.dst, g.alive, E, 0),
                (counts[1], g.d_offsets, g.d_dst, g.d_alive, D, E)):
            if count == 0 or cap == 0:
                continue
            start = offsets.gather(1, es.long())
            end = offsets.gather(1, es.long() + 1)

            def walk(j, tot, start=start, end=end, dst=dst, alive=alive,
                     cap=cap, base=base):
                pos = start + j
                ok = pos < end
                safe = pos.clamp(0, cap - 1).long()
                z = dst.gather(1, safe)
                z_ok = ok & alive.gather(1, safe)
                ctx = _DistWedgeCtx(g, lane_flags, base + safe, is_edge_fn,
                                    edge_flag_fn)
                contrib = pair_fn(es, ed, z, z_ok & ea, ctx)
                return tuple(t + x.reshape(L, -1).sum(1, dtype=t.dtype)
                             for t, x in zip(tot, (contrib,) if single
                                             else contrib))

            if on_device:
                deg_max = self._device_degree(offsets)
                _, total = device_loop.while_loop(
                    lambda s: s[0] < deg_max,
                    lambda s, walk=walk: (s[0] + 1, walk(s[0], s[1])),
                    (0, total))
            else:
                for j in range(count):
                    total = walk(j, total)
        total = tuple(_all_reduce(c, t, "sum")[0] for t in total)
        return total[0] if single else total

    # -- updates (each shard applies the updates whose source it owns) ------
    def _update_del_local(self, p: int, loc, b: UpdateBatch):
        own = (b.del_src // self._block) == p
        return diffcsr.update_csr_del(loc, b.del_src, b.del_dst,
                                      b.del_mask & own)

    def _update_add_local(self, p: int, loc, b: UpdateBatch):
        own = (b.add_src // self._block) == p
        return diffcsr.update_csr_add(loc, b.add_src, b.add_dst, b.add_w,
                                      b.add_mask & own)

    def update_del(self, h, batch: UpdateBatch):
        return self._map_shards(
            h, lambda p, loc: self._update_del_local(p, loc, batch))

    def update_add(self, h, batch: UpdateBatch):
        _faults.fire("kernel_launch", engine=self.name, op="update_add")
        return self._map_shards(
            h, lambda p, loc: self._update_add_local(p, loc, batch))

    def batch_edge_flags(self, h, qs, qd, mask) -> torch.Tensor:
        """(L, E+D) flags, each shard's over its own lanes."""
        return torch.stack([edge_lane_flags(self._graph(self._local(h, l)),
                                            qs, qd, mask)
                            for l in range(self.L)])
