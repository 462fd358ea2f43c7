"""Tensor helpers shared by the port: device resolution and the few JAX
idioms PyTorch has no single call for.

* ``resolve_device`` — every entry point takes ``device=``; ``None``
  means the card, and asking for the card where there is none raises
  (the port never falls back to the CPU on its own).
* ``set_drop`` — ``x.at[idx].set(v, mode="drop")``: lanes whose index
  lies outside ``[-len, len)`` are dropped, and negative ones count from
  the end, as in JAX.  The scatter goes into a buffer
  one slot longer and the extra slot is sliced away.
* ``segment_min`` / ``segment_max`` / ``segment_sum`` — ``jax.ops.segment_*``
  with JAX's fill for empty segments (the dtype's max / min / zero).
  Integer min, max and sum are exact in any order, so the atomics the
  card uses for ``scatter_reduce`` / ``index_add_`` stay deterministic.
  Float sums are not: they add each segment's lanes in lane order
  (``kernels/segment.py``), after a stable sort by segment id.
* ``cumsum32`` — ``torch.cumsum`` promotes int32 to int64; cast back.
* ``take`` / ``clamp_index`` — a JAX gather ``x[i]``: negative indices
  count from the end and the rest are clamped into range, where torch
  would raise (and the card would trap).
* ``in_range`` — segment ids with those outside ``[0, num)`` sent to a
  spare segment ``num``: reduce into ``num + 1`` segments and drop the
  last, as ``jax.ops.segment_*`` drops such ids.  Only a session with
  ``admission="off"`` lets such ids into a graph.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def set_drop(buf: torch.Tensor, idx: torch.Tensor, vals,
             last_wins: bool = False) -> torch.Tensor:
    """A new tensor: ``buf`` with ``buf[idx] = vals``, dropping lanes whose
    index is out of range (negative indices count from the end).

    With ``last_wins`` a duplicated index takes the value of its LAST lane
    (what XLA's scatter does on the CPU); the card's ``index_put_`` picks
    no fixed winner, so the losing lanes are redirected to the dropped
    slot first (a sort of the lanes, not a pass over ``buf``).  Callers
    whose duplicate lanes carry equal values leave it off."""
    L = buf.shape[0]
    idx = idx.to(torch.int64)
    idx = torch.where((idx >= -L) & (idx < L), torch.remainder(idx, L), L)
    if last_wins and idx.numel():
        # lanes sorted stably by index: an index's last lane ends its run
        idx, order = torch.sort(idx, stable=True)
        last = torch.cat([idx[1:] != idx[:-1],
                          torch.ones((1,), dtype=torch.bool,
                                     device=idx.device)])
        idx = torch.where(last, idx, L)
        if isinstance(vals, torch.Tensor) and vals.dim():
            vals = vals[order]
    out = torch.cat([buf, buf.new_zeros(1)])
    # out of place, so that ``torch.func.vmap`` can batch a scatter of
    # batched lanes into a fresh buffer (serve/batch.py); a Python scalar
    # is filled in, never copied to the device (a copy from host memory
    # is a host sync)
    if isinstance(vals, torch.Tensor):
        return out.index_put((idx,), vals)[:L]
    return out.index_fill(0, idx, vals)[:L]


def _segment(vals, seg, num, reduce: str, fill):
    out = torch.full((num,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg.to(torch.int64), vals, reduce)


def segment_min(vals: torch.Tensor, seg: torch.Tensor,
                num: int) -> torch.Tensor:
    fill = (torch.iinfo(vals.dtype).max if not vals.dtype.is_floating_point
            else float("inf"))
    return _segment(vals, seg, num, "amin", fill)


def segment_max(vals: torch.Tensor, seg: torch.Tensor,
                num: int) -> torch.Tensor:
    fill = (torch.iinfo(vals.dtype).min if not vals.dtype.is_floating_point
            else float("-inf"))
    return _segment(vals, seg, num, "amax", fill)


def segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                num: int) -> torch.Tensor:
    """``jax.ops.segment_sum``.  A float sum adds each segment's lanes in
    lane order, after a stable sort of the lanes by segment id."""
    if vals.dtype.is_floating_point:
        from repro_torch.kernels.segment import segment_sum_sorted
        order = torch.argsort(seg, stable=True)
        bounds = torch.arange(num + 1, dtype=seg.dtype, device=seg.device)
        offsets = torch.searchsorted(seg[order], bounds, out_int32=True)
        return segment_sum_sorted(vals.contiguous(), order.to(torch.int32),
                                  offsets)
    out = torch.zeros((num,), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg.to(torch.int64), vals)


def in_range(seg: torch.Tensor, num: int) -> torch.Tensor:
    return torch.remainder(seg.clamp(-1, num), num + 1)


def clamp_index(i: torch.Tensor, L: int) -> torch.Tensor:
    """Indices into a length-``L`` axis as a JAX gather takes them: the
    ones in [-L, 0) count from the end, the rest clamp into [0, L)."""
    return torch.remainder(i.clamp(-L, L - 1), L)


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return x[clamp_index(i.to(torch.int64), x.shape[0])]


def to_device(x, device) -> torch.Tensor:
    """A tensor or host array (numpy, or anything ``np.array`` takes) on
    ``device``; host arrays are copied, so read-only buffers are fine."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


def cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=torch.int32)
