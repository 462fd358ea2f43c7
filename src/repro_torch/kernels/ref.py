"""Plain oracles (counterpart of ``repro/kernels/ref.py``): the O(S²)
attention the flash kernel is checked against."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import NEG, check_window, scaled


def flash_ref(q, k, v, *, causal=True, softcap=None, window=None):
    """O(S²) oracle for the flash kernel. q,k,v: (BH, S, dh); ``window``
    masks keys ``window`` or more behind the row (causal only)."""
    check_window(causal, window)
    BH, S, dh = q.shape
    s = torch.einsum("bqd,bkd->bqk", scaled(q, dh ** -0.5), k).float()
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        if window is not None:
            mask = mask & ~torch.tril(mask, diagonal=-window)
        s = torch.where(mask[None], s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v).to(q.dtype)
