"""Update batches: the ``updates<g>`` / ``Batch(allUpdates:batchSize)`` DSL
objects from the paper, as fixed-shape tensors (counterpart of
``repro.graph.updates``).

An :class:`UpdateStream` holds the whole Δ on the host;
``batch(i, batch_size, device=...)`` slices one padded
:class:`UpdateBatch` (add/del lanes plus validity masks) onto a device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.graph.csr import CSR
from repro_torch.tensors import resolve_device


@dataclasses.dataclass(frozen=True)
class UpdateBatch:
    add_src: torch.Tensor   # (B,) int32
    add_dst: torch.Tensor
    add_w: torch.Tensor
    add_mask: torch.Tensor  # (B,) bool
    del_src: torch.Tensor   # (B,) int32
    del_dst: torch.Tensor
    del_mask: torch.Tensor

    @property
    def size(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.add_src.device

    def row(self, j: int) -> "UpdateBatch":
        """Batch ``j`` of a stacked (count, B)-leaved batch (views)."""
        return UpdateBatch(**{f.name: getattr(self, f.name)[j]
                              for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class UpdateStream:
    """Host-side container for the whole Δ; slices into UpdateBatches."""

    adds: np.ndarray      # (A, 3) src, dst, w
    dels: np.ndarray      # (Dl, 2) src, dst

    @property
    def num_adds(self) -> int:
        return int(self.adds.shape[0])

    @property
    def num_dels(self) -> int:
        return int(self.dels.shape[0])

    def num_batches(self, batch_size: int) -> int:
        longest = max(self.num_adds, self.num_dels, 1)
        return -(-longest // batch_size)

    def batch(self, i: int, batch_size: int, device=None) -> UpdateBatch:
        dev = resolve_device(device)

        def pad_slice(arr: np.ndarray, width: int):
            lo = i * batch_size
            chunk = arr[lo:lo + batch_size]
            k = chunk.shape[0]
            out = np.zeros((batch_size, width), dtype=np.int32)
            # NaN/Inf rows int-cast silently here BY DESIGN: admission
            # validates the raw host arrays before any batch is trusted
            with np.errstate(invalid="ignore"):
                out[:k] = chunk
            mask = np.zeros((batch_size,), dtype=bool)
            mask[:k] = True
            return out, mask

        a, am = pad_slice(self.adds, 3)
        d, dm = pad_slice(self.dels, 2)
        put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return UpdateBatch(
            add_src=put(a[:, 0]), add_dst=put(a[:, 1]),
            add_w=put(np.maximum(a[:, 2], 1)), add_mask=put(am),
            del_src=put(d[:, 0]), del_dst=put(d[:, 1]), del_mask=put(dm))

    def stacked(self, batch_size: int, start: int = 0,
                count: int | None = None, device=None) -> UpdateBatch:
        """A (count, B)-leaved UpdateBatch: batches ``[start, start +
        count)`` stacked, lane for lane the reference's ``stacked`` (the
        segment a fused ``run_stream`` runs).  The seven leaves cross to
        the device as one int32 block from pinned memory, without a host
        sync; the masks are cast back to bool there."""
        dev = resolve_device(device)
        if count is None:
            count = self.num_batches(batch_size) - start
        block = np.zeros((7, count, batch_size), dtype=np.int32)
        for j in range(count):
            lo = (start + j) * batch_size
            for arr, rows in ((self.adds, slice(0, 3)),
                              (self.dels, slice(4, 6))):
                chunk = arr[lo:lo + batch_size]
                with np.errstate(invalid="ignore"):
                    block[rows, j, :chunk.shape[0]] = chunk.T
                block[rows.stop, j, :chunk.shape[0]] = 1
        block[2] = np.maximum(block[2], 1)
        host = torch.from_numpy(block)
        if dev.type == "cuda":
            host = host.pin_memory()
        t = host.to(dev, non_blocking=True)
        return UpdateBatch(add_src=t[0], add_dst=t[1], add_w=t[2],
                           add_mask=t[3].bool(), del_src=t[4],
                           del_dst=t[5], del_mask=t[6].bool())

    def batches(self, batch_size: int, device=None) -> Iterator[UpdateBatch]:
        for i in range(self.num_batches(batch_size)):
            yield self.batch(i, batch_size, device)

    def window(self, batch_size: int, start: int,
               count: int) -> "UpdateStream":
        """A sub-stream covering batches ``[start, start+count)`` at this
        ``batch_size``; ``window(bs, i, k).batch(j, bs)`` is lane-identical
        to ``self.batch(i + j, bs)``."""
        lo = start * batch_size
        hi = (start + count) * batch_size
        return UpdateStream(adds=self.adds[lo:hi], dels=self.dels[lo:hi])


def random_updates(csr: CSR, percent: float, seed: int = 0,
                   max_w: int = 100, add_frac: float = 0.5) -> UpdateStream:
    """Sample Δ as the paper does: ``percent`` of |E| updates, split between
    deletions of existing edges and additions of fresh edges.

    Draws the reference's exact ``rng`` sequence, so both packages give
    the same stream from one seed.  Membership against the base edges is
    a ``searchsorted`` over their sorted int64 keys ``src·n+dst`` (the
    CSR is sorted by (src, dst)) instead of a Python set of every edge,
    which at tens of millions of edges costs gigabytes and minutes."""
    rng = np.random.default_rng(seed)
    n = csr.n
    e = csr.num_edges
    total = max(int(e * percent / 100.0), 1)
    n_add = int(total * add_frac)
    n_del = total - n_add

    src = csr.src.cpu().numpy()
    dst = csr.dst.cpu().numpy()
    del_idx = rng.choice(e, size=min(n_del, e), replace=False)
    dels = np.stack([src[del_idx], dst[del_idx]], axis=1).astype(np.int32)

    keys = src.astype(np.int64) * n + dst.astype(np.int64)
    added = set()
    adds = []
    while len(adds) < n_add:
        cand = rng.integers(0, n, size=(2 * (n_add - len(adds)) + 8, 2))
        ck = cand[:, 0] * np.int64(n) + cand[:, 1]
        pos = np.minimum(np.searchsorted(keys, ck), max(e - 1, 0))
        in_base = (keys[pos] == ck) if e else np.zeros(len(ck), bool)
        for (u, v), k, old in zip(cand.tolist(), ck.tolist(),
                                  in_base.tolist()):
            if not old and k not in added and u != v:
                adds.append((u, v, int(rng.integers(1, max_w))))
                added.add(k)
                if len(adds) >= n_add:
                    break
    adds = np.asarray(adds, dtype=np.int32).reshape(-1, 3)
    return UpdateStream(adds=adds, dels=dels)
