"""Flash-attention forward: the LM stack's prefill kernel.

``flash_attention(q, k, v, causal=..., softcap=..., window=...)`` takes
q, k, v of shape (BH, S, dh), float32 or bf16, with the kv heads already
repeated, and returns (BH, S, dh) in q's type — the contract of the
reference's Pallas kernel (``repro/kernels/flash_attention.py``): q
scaled by dh**-0.5 in q's type, float32 scores, an optional tanh softcap,
causal masking by absolute index with -1e30, an online softmax with
float32 running max, denominator and accumulator, ``p`` cast to v's type
before the P·V product, and ``acc / max(l, 1e-20)`` cast to q's type.
The Pallas kernel has no window; the reference model's chunked attention
does (``repro/models/layers.py:flash_attention``, local attention): with
``window=W`` a causal score s_ij is also masked where ``i - j >= W``,
after the softcap.  A window needs ``causal=True``.

On a CUDA tensor it launches the hand-written kernel
(``csrc/flash_attention.cu``: bf16 with dh 64 or 128 on the tensor cores
through a TMA ring and ``wgmma``, 128 q rows by 128-key tiles; every
other case on the CUDA cores) or raises; only a tensor on the CPU takes
the plain version, ``flash_attention_plain``: the same blockwise online
softmax in PyTorch, with the same float32 state and cast points, over KV
blocks of ``bk`` keys (the Pallas default, 512).  ``LAUNCHES`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cuda_device, ptr, raise_on
from repro_torch.kernels._build import stream as _stream

NEG = -1e30
BK = 512
LAUNCHES = _build.launch_table(__name__, "flash_attention")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (on the host: no device copy)."""
    return float(torch.tensor(value, dtype=dtype))


def scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x * scale`` in x's type with the scalar first rounded to it, as a
    JAX array times a Python float computes it (torch would keep the
    scalar in float32).  The product of the rounded scalar and x is exact
    in float32, so torch's one rounding to x's type matches JAX's."""
    return x * rounded(scale, x.dtype)


def check_window(causal: bool, window) -> None:
    if window is None:
        return
    if not causal:
        raise ValueError("a window masks keys behind a row: it needs "
                         "causal=True, as in the reference")
    if isinstance(window, bool) or not isinstance(window, int) or window < 1:
        raise ValueError(f"window must be a positive int, got {window!r}")


def flash_attention_plain(q, k, v, *, causal=True, softcap=None, window=None,
                          bk=BK):
    """The plain version: one pass per block of ``bk`` keys over every q
    row at once (causal blocks wholly in a row's future add exactly 0; so
    do a window's blocks wholly behind a row, after its first real max)."""
    check_window(causal, window)
    BH, S, dh = q.shape
    f32 = torch.float32
    qs = scaled(q, dh ** -0.5).to(f32)
    m = torch.full((BH, S), NEG, dtype=f32, device=q.device)
    l = torch.zeros((BH, S), dtype=f32, device=q.device)
    acc = torch.zeros((BH, S, dh), dtype=f32, device=q.device)
    qi = torch.arange(S, device=q.device)
    for k0 in range(0, S, bk):
        kb = k[:, k0:k0 + bk].to(f32)
        s = qs @ kb.transpose(1, 2)
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        if causal:
            kj = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            ok = qi[:, None] >= kj[None, :]
            if window is not None:
                ok &= qi[:, None] - kj[None, :] < window
            s = torch.where(ok, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + \
            p.to(v.dtype).to(f32) @ v[:, k0:k0 + bk].to(f32)
        m = m_new
    return (acc / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, softcap=None, window=None):
    """(BH, S, dh) attention forward in q's type; see the module doc."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, softcap=softcap,
                                     window=window)
    check_window(causal, window)
    name = "flash_attention"
    dev = cuda_device(name, q)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q has dtype {q.dtype}, expected float32 "
                        f"or bfloat16")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one (BH, S, dh) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _build.check(name, dev, q=(q, q.dtype), k=(k, q.dtype), v=(v, q.dtype))
    BH, S, dh = q.shape
    if not 0 < dh <= 256 or S > 65535 * 16:
        raise ValueError(f"{name}: the kernel takes dh <= 256 and S <= "
                         f"1,048,560, got dh={dh}, S={S}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{name}: softcap must be positive, got {softcap}")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    scale = rounded(dh ** -0.5, q.dtype)
    err = _build.load().repro_flash_attention(
        ptr(q), ptr(k), ptr(v), ptr(o), BH, S, dh,
        int(q.dtype == torch.bfloat16), int(causal), min(window or 0, S),
        scale, float(softcap or 0.0), _stream(dev))
    raise_on(err, name)
    LAUNCHES[name] += 1
    return o
