"""The fused repair kernels of the ΔG hot path (counterpart of
``repro.kernels.pallas_repair``), each beside its plain PyTorch version.

``fused_relax_rows`` — one launch per SSSP sweep: per ELL row the
min-plus candidate, the smallest source reaching it, the frontier flag,
and the frontier row ids compacted inside each block of ``block`` rows
(sentinel R after each block's count), plus per-block counts.

``fused_spmv_rows`` — one launch per PageRank sweep: per ELL row the
float sum of ``vals[src]`` (K lanes added left to right), and the ids of
the rows that belong to a vertex (``row2dst < n``) compacted per block.

``merge_pool_sorted`` — the ΔG sorted merge for ``update_csr_add``: folds
the sorted admitted batch into the sorted diff pool along the merge path;
the pool wins ties.  The plain version runs one binary search per output
slot; the kernel merges tiles of ``MERGE_TILE`` output slots, one a block,
staged in shared memory.

``merge_pool_sorted_batched`` — S such merges of S sessions stacked along
a leading axis, in one launch of the same kernel (a grid row a session):
the counterpart of the reference pool's ``vmap`` over the Pallas merge.
``merge_pool_sorted_op`` is the solo merge as a ``torch.library`` custom
op whose vmap rule calls the batched entry, so ``torch.func.vmap`` over
an engine's update (``serve/batch.py``) launches it once for the group.

The row kernels gather ``vals`` (n+1,) as a JAX gather does: a source id
outside [0, n] (only an unchecked, admission="off" pool holds one) counts
from the end or clamps (``tensors.take``).

A wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel in ``csrc/repair.cu`` (built on first
use by ``_build``) or raises.  ``LAUNCHES`` counts kernel launches, and
only those.

Cost rules (``launch/op_cost.counted``: what each entry records into an
active ``CostCounter``; on meta tensors an entry returns empty outputs):
no FLOPs (no matrix product); bytes the slots, ``vals`` (n+1) read once
(the gathers' re-reads are the tiling's, not the function's), the other
inputs, and the outputs written once: ``fused_relax_rows`` src, w, vals,
row_min, row_arg, rows and counts; ``fused_spmv_rows`` src, row2dst,
vals, row_sum, rows and counts; the merges every pool and batch array
read and the merged pool written.

``repair_config`` keeps the reference's row-block heuristic keyed on
(n, E_cap, K), or with ``measure=True`` times the row candidates that
divide R and keeps the fastest.  The merge kernel has no block knob (its
tile is a constant of ``csrc/repair.cu``, ``kMergeTile``, repeated here
as ``MERGE_TILE``), so ``RepairConfig`` holds the row block alone.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Tuple

import torch

from repro_torch.graph.csr import INT
from repro_torch.kernels import _build
from repro_torch.kernels._build import check, cuda_device, ptr, raise_on
from repro_torch.kernels._build import stream as _stream
from repro_torch.kernels.ell import ell_capacity
from repro_torch.launch.op_cost import counted, nbytes
from repro_torch.tensors import resolve_device, take

ROW_TILE = 128          # ELL row rounding; a block size that always divides R
DEFAULT_BLOCK = 256     # rows per CUDA block of fused_relax_rows
MERGE_TILE = 1024       # output slots per CUDA block of merge_pool_sorted

LAUNCHES = _build.launch_table(__name__, "fused_relax_rows",
                                "fused_spmv_rows", "merge_pool_sorted",
                                "merge_pool_sorted_batched")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# fused relax: gather → relax → frontier-flag → compact, one launch
# ---------------------------------------------------------------------------

def _relax_block(R: int, block: int) -> int:
    return block if R % block == 0 else ROW_TILE


def _row_block(name: str, R: int, block: int) -> int:
    bt = _relax_block(R, block)
    if R % bt or bt % 32 or not 32 <= bt <= 1024:
        raise ValueError(f"{name}: R={R} needs a block of a multiple of 32 "
                         f"rows that divides it, got {bt}")
    return bt


def warp_loads(ell_src, ell_w=None) -> bool:
    """Whether the fused row kernels take their warp-loaded path for these
    slots (``ell_w`` for relax; spmv streams ``ell_src`` only): K = 8 and
    16-byte aligned arrays, the test the C entry points make (the
    wrappers' tiles are whole warps that divide R).  Other launches load
    and gather slot by slot."""
    return ell_src.shape[1] == 8 and all(
        x.data_ptr() % 16 == 0 for x in (ell_src, ell_w) if x is not None)


def _compact_rows(hit: torch.Tensor, R: int, bt: int):
    """The in-block compaction of both fused kernels: the ids of hit rows
    packed to the front of each block of ``bt`` rows (sentinel R after the
    block's count), and the per-block counts."""
    hit = hit.reshape(R // bt, bt)
    pos = torch.cumsum(hit, dim=1, dtype=INT) - 1
    rowid = torch.arange(R, dtype=INT, device=hit.device).reshape(R // bt, bt)
    tiles = torch.full((R // bt, bt + 1), R, dtype=INT, device=hit.device)
    tiles.scatter_(1, torch.where(hit, pos, bt).to(torch.int64), rowid)
    return tiles[:, :bt].reshape(R), hit.sum(dim=1, dtype=INT)


def fused_relax_rows_plain(ell_src, ell_w, vals, block: int):
    """The plain version: same outputs, same per-block compaction."""
    R, _ = ell_src.shape
    n = vals.shape[0] - 1
    bt = _relax_block(R, block)
    cand = take(vals, ell_src) + ell_w
    rmin = cand.min(dim=1).values
    rarg = torch.where(cand == rmin[:, None], ell_src, n).min(dim=1).values
    rows, counts = _compact_rows(rmin < vals[n], R, bt)
    return rmin, rarg, rows, counts


def _rows_out(R: int, block: int, *dtypes, device):
    """Empty (R,) outputs of ``dtypes`` and the (R // bt,) counts."""
    return (*(torch.empty((R,), dtype=dt, device=device) for dt in dtypes),
            torch.empty((R // _relax_block(R, block),), dtype=INT,
                        device=device))


def _relax_rows_cost(ell_src, ell_w, vals, *, block: int = DEFAULT_BLOCK):
    R = ell_src.shape[0]
    return 0, nbytes(ell_src, ell_w, vals) + 4 * (
        3 * R + R // _relax_block(R, block)), INT


def _relax_rows_meta(ell_src, ell_w, vals, *, block: int = DEFAULT_BLOCK):
    return _rows_out(ell_src.shape[0], block, INT, INT, INT,
                     device=vals.device)


@counted("fused_relax_rows", _relax_rows_cost, _relax_rows_meta)
def fused_relax_rows(ell_src, ell_w, vals, *, block: int = DEFAULT_BLOCK):
    """(row_min, row_arg, compacted frontier rows, per-block counts)."""
    R, K = ell_src.shape
    if vals.device.type == "cpu":
        return fused_relax_rows_plain(ell_src, ell_w, vals, block)
    dev = cuda_device("fused_relax_rows", vals)
    check("fused_relax_rows", dev, ell_src=(ell_src, INT),
          ell_w=(ell_w, INT), vals=(vals, INT))
    if ell_w.shape != ell_src.shape:
        raise ValueError("fused_relax_rows: ell_w must match ell_src's shape")
    bt = _row_block("fused_relax_rows", R, block)
    n = vals.shape[0] - 1
    lib = _build.load()
    row_min = torch.empty((R,), dtype=INT, device=dev)
    row_arg = torch.empty((R,), dtype=INT, device=dev)
    rows = torch.empty((R,), dtype=INT, device=dev)
    counts = torch.empty((R // bt,), dtype=INT, device=dev)
    err = lib.repro_fused_relax_rows(
        ptr(ell_src), ptr(ell_w), ptr(vals), ptr(row_min), ptr(row_arg),
        ptr(rows), ptr(counts), R, K, n, bt, _stream(dev))
    raise_on(err, "fused_relax_rows")
    LAUNCHES["fused_relax_rows"] += 1
    return row_min, row_arg, rows, counts


# ---------------------------------------------------------------------------
# fused SpMV: gather → row sum → materialized-row flag → compact, one launch
# ---------------------------------------------------------------------------

def row_sum_plain(ell_src, vals):
    """``sum_k vals[src[r, k]]`` with the K lanes added left to right by
    explicit adds, the order the kernels keep (``sum(dim=1)`` fixes
    none)."""
    g = take(vals, ell_src)
    acc = g[:, 0]
    for k in range(1, g.shape[1]):
        acc = acc + g[:, k]
    return acc


def fused_spmv_rows_plain(ell_src, row2dst, vals, block: int):
    """The plain version: same outputs, same per-block compaction."""
    R, _ = ell_src.shape
    n = vals.shape[0] - 1
    rows, counts = _compact_rows(row2dst < n, R, _relax_block(R, block))
    return row_sum_plain(ell_src, vals), rows, counts


def _spmv_rows_cost(ell_src, row2dst, vals, *, block: int = DEFAULT_BLOCK):
    R = ell_src.shape[0]
    return 0, nbytes(ell_src, row2dst, vals) + 4 * (
        2 * R + R // _relax_block(R, block)), torch.float32


def _spmv_rows_meta(ell_src, row2dst, vals, *, block: int = DEFAULT_BLOCK):
    return _rows_out(ell_src.shape[0], block, torch.float32, INT,
                     device=vals.device)


@counted("fused_spmv_rows", _spmv_rows_cost, _spmv_rows_meta)
def fused_spmv_rows(ell_src, row2dst, vals, *, block: int = DEFAULT_BLOCK):
    """(row_sum, compacted materialized rows, per-block counts): per ELL
    row the float sum of ``vals[src]`` over its K slots, and the ids of
    the rows that belong to a vertex (``row2dst < n``)."""
    R, K = ell_src.shape
    if vals.device.type == "cpu":
        return fused_spmv_rows_plain(ell_src, row2dst, vals, block)
    dev = cuda_device("fused_spmv_rows", vals)
    check("fused_spmv_rows", dev, ell_src=(ell_src, INT),
          row2dst=(row2dst, INT), vals=(vals, torch.float32))
    if row2dst.shape != (R,):
        raise ValueError("fused_spmv_rows: row2dst must be (R,)")
    bt = _row_block("fused_spmv_rows", R, block)
    n = vals.shape[0] - 1
    lib = _build.load()
    row_sum = torch.empty((R,), dtype=torch.float32, device=dev)
    rows = torch.empty((R,), dtype=INT, device=dev)
    counts = torch.empty((R // bt,), dtype=INT, device=dev)
    err = lib.repro_fused_spmv_rows(
        ptr(ell_src), ptr(row2dst), ptr(vals), ptr(row_sum), ptr(rows),
        ptr(counts), R, K, n, bt, _stream(dev))
    raise_on(err, "fused_spmv_rows")
    LAUNCHES["fused_spmv_rows"] += 1
    return row_sum, rows, counts


# ---------------------------------------------------------------------------
# ΔG sorted merge: diff pool + admitted batch, one merge-path launch
# ---------------------------------------------------------------------------

def _merge_iters(length: int) -> int:
    it = 1
    while (1 << it) < length + 1:
        it += 1
    return it + 1


def merge_pool_sorted_plain(d_src, d_dst, d_w, d_alive, f_src, f_dst, f_w,
                            f_alive, n: int):
    """The plain version: the same merge-path search, for all slots at once."""
    D, B = d_src.shape[0], f_src.shape[0]
    j = torch.arange(D, dtype=INT, device=d_src.device)
    lo = (j - D).clamp(min=0)
    hi = j.clamp(max=B)
    for _ in range(_merge_iters(B)):
        active = lo < hi
        mid = (lo + hi) // 2
        mi = mid.clamp(0, B - 1)
        pi = (j - 1 - mid).clamp(0, D - 1)
        ms, md = f_src[mi], f_dst[mi]
        qs, qd = d_src[pi], d_dst[pi]
        less = (ms < qs) | ((ms == qs) & (md < qd))
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    a = lo
    ip = j - a
    a_ok, p_ok = a < B, ip < D
    a_safe, p_safe = a.clamp(0, B - 1), ip.clamp(0, D - 1)
    fs, fd = f_src[a_safe], f_dst[a_safe]
    qs, qd = d_src[p_safe], d_dst[p_safe]
    take_f = a_ok & (~p_ok | (fs < qs) | ((fs == qs) & (fd < qd)))

    def pick(f, p, fill):
        return torch.where(take_f, f, torch.where(p_ok, p, fill))

    return (pick(fs, qs, n), pick(fd, qd, 0),
            pick(f_w[a_safe], d_w[p_safe], 0),
            pick(f_alive[a_safe], d_alive[p_safe], False))


def _launch_merge(name: str, pool, batch, dims: int):
    """The merge kernel's one entry point, checked and counted under
    ``name``: ``pool`` four (D,) or (S, D) tensors, ``batch`` four (B,)
    or (S, B) (``dims`` 1 or 2; a single merge is S = 1).  Returns the
    merged pools, shaped as ``pool``."""
    d_src, d_dst, d_w, d_alive = pool
    f_src, f_dst, f_w, f_alive = batch
    if d_src.dim() != dims or f_src.dim() != dims:
        raise ValueError(f"{name}: pools and batches must have {dims} "
                         f"dimension(s)")
    *lead, D = (int(x) for x in d_src.shape)
    S, B = (lead[0] if lead else 1), int(f_src.shape[-1])
    dev = cuda_device(name, d_src)
    b = torch.bool
    check(name, dev, d_src=(d_src, INT), d_dst=(d_dst, INT), d_w=(d_w, INT),
          d_alive=(d_alive, b), f_src=(f_src, INT), f_dst=(f_dst, INT),
          f_w=(f_w, INT), f_alive=(f_alive, b))
    if any(t.shape != d_src.shape for t in pool) or \
            any(t.shape != (*lead, B) for t in batch):
        raise ValueError(f"{name}: pool arrays must be "
                         f"{'(S, D)' if lead else '(D,)'} and batch arrays "
                         f"{'(S, B)' if lead else '(B,)'}")
    if D < 1 or B < 1 or S < 1:
        raise ValueError(f"{name}: needs D, B, S >= 1, got {D}, {B}, {S}")
    lib = _build.load()
    out = [torch.empty(d_src.shape, dtype=INT, device=dev)
           for _ in range(3)]
    out.append(torch.empty(d_src.shape, dtype=b, device=dev))
    err = lib.repro_merge_pool_sorted_batched(
        *(ptr(t) for t in (*pool, *batch, *out)), D, B, S, _stream(dev))
    raise_on(err, name)
    LAUNCHES[name] += 1
    return tuple(out)


def _merge_cost(d_src, d_dst, d_w, d_alive, f_src, f_dst, f_w, f_alive, *,
                n: int):
    pool = (d_src, d_dst, d_w, d_alive)
    return 0, 2 * nbytes(*pool) + nbytes(f_src, f_dst, f_w, f_alive), INT


def _merge_meta(d_src, d_dst, d_w, d_alive, f_src, f_dst, f_w, f_alive, *,
                n: int):
    return tuple(torch.empty_like(t) for t in (d_src, d_dst, d_w, d_alive))


@counted("merge_pool_sorted", _merge_cost, _merge_meta)
def merge_pool_sorted(d_src, d_dst, d_w, d_alive, f_src, f_dst, f_w,
                      f_alive, *, n: int):
    """Merge the sorted diff pool with the sorted admitted batch.

    Both lists are sorted by (src, dst) with sentinel rows (src == n,
    dst == 0, w == 0, dead) at the end; returns the merged pool
    ``(d_src, d_dst, d_w, d_alive)`` with the same (D,) shape."""
    if d_src.device.type == "cpu":
        return merge_pool_sorted_plain(d_src, d_dst, d_w, d_alive, f_src,
                                       f_dst, f_w, f_alive, n)
    return _launch_merge("merge_pool_sorted", (d_src, d_dst, d_w, d_alive),
                         (f_src, f_dst, f_w, f_alive), 1)


def merge_pool_sorted_batched_plain(d_src, d_dst, d_w, d_alive, f_src,
                                    f_dst, f_w, f_alive, n: int):
    """The plain version: the solo plain merge, session by session."""
    outs = [merge_pool_sorted_plain(*(x[s] for x in (
        d_src, d_dst, d_w, d_alive, f_src, f_dst, f_w, f_alive)), n)
        for s in range(d_src.shape[0])]
    return tuple(torch.stack(col) for col in zip(*outs))


@counted("merge_pool_sorted_batched", _merge_cost, _merge_meta)
def merge_pool_sorted_batched(d_src, d_dst, d_w, d_alive, f_src, f_dst,
                              f_w, f_alive, *, n: int):
    """S independent merges in one launch: pools (S, D), batches (S, B),
    each session's lists sorted as for :func:`merge_pool_sorted`; returns
    the merged pools, four (S, D) tensors."""
    if d_src.device.type == "cpu":
        return merge_pool_sorted_batched_plain(d_src, d_dst, d_w, d_alive,
                                               f_src, f_dst, f_w, f_alive, n)
    return _launch_merge("merge_pool_sorted_batched",
                         (d_src, d_dst, d_w, d_alive),
                         (f_src, f_dst, f_w, f_alive), 2)


@torch.library.custom_op("repro_torch::merge_pool_sorted", mutates_args=())
def merge_pool_sorted_op(d_src: torch.Tensor, d_dst: torch.Tensor,
                         d_w: torch.Tensor, d_alive: torch.Tensor,
                         f_src: torch.Tensor, f_dst: torch.Tensor,
                         f_w: torch.Tensor, f_alive: torch.Tensor,
                         n: int) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor, torch.Tensor]:
    """:func:`merge_pool_sorted` as a custom op: called directly it
    launches the solo merge; under ``torch.func.vmap`` its vmap rule
    launches :func:`merge_pool_sorted_batched` once for the whole axis."""
    return merge_pool_sorted(d_src, d_dst, d_w, d_alive, f_src, f_dst, f_w,
                             f_alive, n=n)


@merge_pool_sorted_op.register_vmap
def _merge_pool_sorted_vmap(info, in_dims, *args):
    *tensors, n = args
    size = info.batch_size

    def stacked(x, dim):
        x = x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)
        return x.contiguous()

    out = merge_pool_sorted_batched(
        *(stacked(x, d) for x, d in zip(tensors, in_dims)), n=n)
    return out, (0, 0, 0, 0)


# ---------------------------------------------------------------------------
# block config keyed on (n, E_cap, K), cached per handle shape
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RepairConfig:
    row_block: int      # fused relax rows per block (divides R)


_ROW_CANDIDATES = (512, 256, 128)
_TUNE_LOCK = threading.Lock()
_TUNE_CACHE: dict = {}  # (n, E_cap, K, measured on) -> RepairConfig
# (n, E_cap, K, device) -> {row block: best of 3 ms} of each measured shape
TUNE_TIMES: dict = {}


def clear_tune_cache() -> None:
    with _TUNE_LOCK:
        _TUNE_CACHE.clear()
        TUNE_TIMES.clear()


def repair_config(n: int, e_cap: int, k: int, *, measure: bool = False,
                  device=None) -> RepairConfig:
    """Block config for a handle shape, decided once per (n, E_cap, K):
    the heuristic's (the largest candidate that divides R and leaves at
    least two blocks; ROW_TILE always divides R), or with ``measure`` the
    fastest candidate that divides R, each timed by
    ``fused_relax_rows`` on synthetic data of the keyed shape on
    ``device`` (the card by default: CUDA events; ``"cpu"``: the plain
    version).  Measured and heuristic configs are cached apart; the lock
    makes the first tuner of a shape the one that decides it."""
    dev = resolve_device(device) if measure else None
    key = (int(n), int(e_cap), int(k), dev)
    with _TUNE_LOCK:
        cfg = _TUNE_CACHE.get(key)
        if cfg is None:
            cfg = _measure_config(*key) if measure else \
                _heuristic_config(*key[:3])
            _TUNE_CACHE[key] = cfg
    return cfg


def _heuristic_config(n: int, e_cap: int, k: int) -> RepairConfig:
    R = ell_capacity(n, e_cap, k)
    for cand in _ROW_CANDIDATES:
        if R % cand == 0 and R // cand >= 2:
            return RepairConfig(row_block=cand)
    return RepairConfig(row_block=ROW_TILE)


def _time_rows(src, w, vals, bt: int) -> float:
    """Best of 3 ms of one ``fused_relax_rows`` at row block ``bt``, after
    a warm call (CUDA events on the card, the host clock on the CPU)."""
    run = lambda: fused_relax_rows(src, w, vals, block=bt)
    run()
    best = float("inf")
    for _ in range(3):
        if vals.device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            run()
            ev[1].record()
            ev[1].synchronize()
            best = min(best, ev[0].elapsed_time(ev[1]))
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _measure_config(n: int, e_cap: int, k: int, dev) -> RepairConfig:
    """Time the row candidates that divide R on synthetic slots (seed 0)."""
    R = ell_capacity(n, e_cap, k)
    gen = torch.Generator().manual_seed(0)
    src = torch.randint(0, n + 1, (R, k), generator=gen, dtype=INT)
    w = torch.randint(1, 50, (R, k), generator=gen, dtype=INT)
    vals = torch.cat([torch.randint(0, 1000, (n,), generator=gen,
                                    dtype=INT),
                      torch.tensor([2 ** 30], dtype=INT)])
    src, w, vals = (t.to(dev) for t in (src, w, vals))
    rows = [bt for bt in _ROW_CANDIDATES if R % bt == 0] or [ROW_TILE]
    times = {bt: _time_rows(src, w, vals, bt) for bt in rows}
    TUNE_TIMES[(n, e_cap, k, str(dev))] = times
    return RepairConfig(row_block=min(rows, key=times.__getitem__))
