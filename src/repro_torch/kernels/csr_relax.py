"""The chained row kernels over the ELL pack (counterpart of
``repro.kernels.csr_relax``), each beside its plain PyTorch version.

``relax_rowmin``    : ``out[r] = min_k vals[src[r,k]] + w[r,k]``   (SSSP)
``spmv_rowsum``     : ``out[r] = sum_k vals[src[r,k]]``            (PageRank)
``relax_rowargmin`` : ``out[r] = min_k {src | vals[src]+w == row_targets[r]}``,
                      sentinel n  (deterministic parent for SSSP)

``vals`` is (n+1,) with the reduction identity at slot n, so empty slots
(src == n) gather the identity; a source id outside [0, n] is gathered
as a JAX gather takes it (``tensors.take``).  Integer adds wrap as int32 does; the K
float lanes of ``spmv_rowsum`` are added left to right.

A wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel in ``csrc/csr_relax.cu`` or raises.
``warp_loads`` says which launches of the three load their slots by the
warp.
``LAUNCHES`` counts kernel launches, and only those.  They are the
``cuda_chained`` engine's sweep; the ``cuda`` engine runs the fused
kernels of ``kernels/repair.py`` instead.

Cost rules (``launch/op_cost.counted``; on meta tensors an entry returns
an empty (R,) output): no FLOPs; bytes every input read once (``vals``
(n+1) once, not per gather) and the (R,) output written once.
"""
from __future__ import annotations

import torch

from repro_torch.graph.csr import INT
from repro_torch.kernels import _build
from repro_torch.kernels._build import check, cuda_device, ptr, raise_on
from repro_torch.kernels._build import stream as _stream
from repro_torch.kernels.repair import row_sum_plain
from repro_torch.launch.op_cost import counted, nbytes
from repro_torch.tensors import take

LAUNCHES = _build.launch_table(__name__, "relax_rowmin", "spmv_rowsum",
                                "relax_rowargmin")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _shape(name: str, ell_src):
    R, K = ell_src.shape
    if not 1 <= K <= 32:
        raise ValueError(f"{name}: rows of 1-32 slots, got K={K}")
    return R, K


def warp_loads(ell_src, ell_w=None) -> bool:
    """Whether ``spmv_rowsum`` (``ell_src`` only) or ``relax_rowmin`` and
    ``relax_rowargmin`` (``ell_w`` too) take their warp-loaded path for
    these slots: K = 8, R a multiple of 32 (whole warps of rows) and
    16-byte aligned arrays, the test the C entry points make.  Other
    launches load slot by slot."""
    R, K = ell_src.shape
    return K == 8 and R % 32 == 0 and all(
        x.data_ptr() % 16 == 0 for x in (ell_src, ell_w) if x is not None)


def _cand(ell_src, ell_w, vals):
    return take(vals, ell_src) + ell_w


def relax_rowmin_plain(ell_src, ell_w, vals):
    return _cand(ell_src, ell_w, vals).min(dim=1).values


def spmv_rowsum_plain(ell_src, vals):
    return row_sum_plain(ell_src, vals)


def relax_rowargmin_plain(ell_src, ell_w, vals, row_targets, n: int):
    achieved = _cand(ell_src, ell_w, vals) == row_targets[:, None]
    return torch.where(achieved, ell_src, n).min(dim=1).values


def _row_rule(dtype):
    """The chained kernels' cost rule and meta outputs: every input read
    once, one (R,) output of ``dtype`` written."""
    def cost(ell_src, *ins, n=None):
        return 0, nbytes(ell_src, *ins) + 4 * ell_src.shape[0], dtype

    def meta(ell_src, *ins, n=None):
        return torch.empty((ell_src.shape[0],), dtype=dtype,
                           device=ell_src.device)
    return cost, meta


@counted("relax_rowmin", *_row_rule(INT))
def relax_rowmin(ell_src, ell_w, vals):
    """vals: (n+1,) int32 with the identity (INF_W) at slot n."""
    if vals.device.type == "cpu":
        return relax_rowmin_plain(ell_src, ell_w, vals)
    dev = cuda_device("relax_rowmin", vals)
    check("relax_rowmin", dev, ell_src=(ell_src, INT), ell_w=(ell_w, INT),
          vals=(vals, INT))
    if ell_w.shape != ell_src.shape:
        raise ValueError("relax_rowmin: ell_w must match ell_src's shape")
    R, K = _shape("relax_rowmin", ell_src)
    out = torch.empty((R,), dtype=INT, device=dev)
    err = _build.load().repro_relax_rowmin(
        ptr(ell_src), ptr(ell_w), ptr(vals), ptr(out), R, K, vals.shape[0],
        _stream(dev))
    raise_on(err, "relax_rowmin")
    LAUNCHES["relax_rowmin"] += 1
    return out


@counted("spmv_rowsum", *_row_rule(torch.float32))
def spmv_rowsum(ell_src, vals):
    """vals: (n+1,) float32 with 0.0 at slot n."""
    if vals.device.type == "cpu":
        return spmv_rowsum_plain(ell_src, vals)
    dev = cuda_device("spmv_rowsum", vals)
    check("spmv_rowsum", dev, ell_src=(ell_src, INT),
          vals=(vals, torch.float32))
    R, K = _shape("spmv_rowsum", ell_src)
    out = torch.empty((R,), dtype=torch.float32, device=dev)
    err = _build.load().repro_spmv_rowsum(
        ptr(ell_src), ptr(vals), ptr(out), R, K, vals.shape[0], _stream(dev))
    raise_on(err, "spmv_rowsum")
    LAUNCHES["spmv_rowsum"] += 1
    return out


@counted("relax_rowargmin", *_row_rule(INT))
def relax_rowargmin(ell_src, ell_w, vals, row_targets, *, n: int):
    """row_targets: (R,) the already-combined per-row target value."""
    if vals.device.type == "cpu":
        return relax_rowargmin_plain(ell_src, ell_w, vals, row_targets, n)
    dev = cuda_device("relax_rowargmin", vals)
    check("relax_rowargmin", dev, ell_src=(ell_src, INT),
          ell_w=(ell_w, INT), vals=(vals, INT),
          row_targets=(row_targets, INT))
    R, K = _shape("relax_rowargmin", ell_src)
    if ell_w.shape != ell_src.shape or row_targets.shape != (R,):
        raise ValueError("relax_rowargmin: ell_w must match ell_src's "
                         "shape and row_targets must be (R,)")
    out = torch.empty((R,), dtype=INT, device=dev)
    err = _build.load().repro_relax_rowargmin(
        ptr(ell_src), ptr(ell_w), ptr(vals), ptr(row_targets), ptr(out), R,
        K, n, vals.shape[0], _stream(dev))
    raise_on(err, "relax_rowargmin")
    LAUNCHES["relax_rowargmin"] += 1
    return out
