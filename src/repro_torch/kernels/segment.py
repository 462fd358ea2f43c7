"""Deterministic float segment sums: the same inputs give the same bits
on every run, on the card and on the CPU.

``jax.ops.segment_sum`` adds floats in lane order on the CPU; on the card
``index_add_`` adds them with atomics, in whatever order they land.  Here
the lanes are laid out grouped by segment (``order``, a stable sort by
segment id, or none where the ids are already grouped, as ELL rows are)
and each segment is added up in lane order from 0.0, one thread per
segment (``csrc/segment.cu``).  A segment of L lanes is L dependent adds,
so the hubs of a skewed graph bound the kernel's time.

``segment_sum_sorted`` takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.  ``LAUNCHES``
counts kernel launches.

Cost rule (``launch/op_cost.counted``; on meta tensors the entry returns
an empty (num,) output): no FLOPs (adds are elementwise); bytes ``vals``,
``order`` and ``offsets`` read once and the (num,) sums written once.
"""
from __future__ import annotations

import torch

from repro_torch.graph.csr import INT
from repro_torch.kernels import _build
from repro_torch.kernels._build import check, cuda_device, ptr, raise_on
from repro_torch.kernels._build import stream as _stream
from repro_torch.launch.op_cost import counted, nbytes

LAUNCHES = _build.launch_table(__name__, "segment_sum_sorted")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def segment_sum_sorted_plain(vals, order, offsets):
    """Segment s adds ``vals[order[i]]`` for i in
    ``[offsets[s], offsets[s+1])`` in that order, from 0.0.  Step j adds
    the j-th lane of every segment longer than j; segments are visited
    longest first, so the active ones are a prefix."""
    x = vals if order is None else vals[order.to(torch.int64)]
    start = offsets[:-1].to(torch.int64)
    length = offsets[1:].to(torch.int64) - start
    by_len = torch.argsort(length, descending=True, stable=True)
    start, length = start[by_len], length[by_len]
    acc = torch.zeros(length.shape, dtype=vals.dtype, device=vals.device)
    longest = int(length[0]) if length.numel() else 0
    # active[j]: how many segments are longer than j
    active = torch.searchsorted(-length, -torch.arange(
        longest, device=vals.device))
    for j in range(longest):
        m = int(active[j])
        acc[:m] = acc[:m] + x[start[:m] + j]
    out = torch.empty_like(acc)
    out[by_len] = acc
    return out


def _cost(vals, order, offsets):
    ins = (vals, offsets) if order is None else (vals, order, offsets)
    return 0, nbytes(*ins) + 4 * (offsets.shape[0] - 1), torch.float32


def _meta(vals, order, offsets):
    return torch.empty((offsets.shape[0] - 1,), dtype=torch.float32,
                       device=vals.device)


@counted("segment_sum_sorted", _cost, _meta)
def segment_sum_sorted(vals, order, offsets):
    """(num,) float32 sums: segment s adds ``vals[order[i]]`` (``vals[i]``
    if ``order`` is None) for i in ``[offsets[s], offsets[s+1])``, in that
    order, from 0.0."""
    if vals.device.type == "cpu":
        return segment_sum_sorted_plain(vals, order, offsets)
    dev = cuda_device("segment_sum_sorted", vals)
    check("segment_sum_sorted", dev, vals=(vals, torch.float32),
          offsets=(offsets, INT))
    if order is not None:
        check("segment_sum_sorted", dev, order=(order, INT))
    num = offsets.shape[0] - 1
    out = torch.empty((num,), dtype=torch.float32, device=dev)
    err = _build.load().repro_segment_sum_sorted(
        ptr(vals), None if order is None else ptr(order), ptr(offsets),
        ptr(out), num, _stream(dev))
    raise_on(err, "segment_sum_sorted")
    LAUNCHES["segment_sum_sorted"] += 1
    return out
