"""Flash attention, forward and backward: the LM stack's prefill kernel
and, for training, its gradient.

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
(``csrc/flash_attention.cu``: bf16 with dh 64, 128 or 256 on the tensor
cores through a TMA ring and ``wgmma``, 128 q rows by 128-key tiles, 64-key
at dh 256; every other case on the CUDA cores) or raises; only a tensor
on the CPU takes
the plain version, ``flash_attention_plain``: the same blockwise online
softmax in PyTorch, with the same float32 state and cast points, over KV
blocks of ``bk`` keys (the Pallas default, 512).  ``LAUNCHES`` counts
kernel launches.  With ``return_lse=True`` both also give each row's
float32 log-sum-exp ``m + log(l)`` over its (softcapped, masked) scores,
(BH, S): what the backward recomputes the softmax from.

``flash_attention_backward(q, k, v, o, lse, do, ...)`` returns dq, dk, dv
of the forward's function: the reference has no Pallas backward, but its
model differentiates this attention with XLA, and the port's training
step needs the same gradient.  The math, in float32, per row i and key j
(scores s_ij of the scaled q, P_ij = exp(softcap(s_ij) - lse_i), masked
entries 0):
    D_i   = sum_d do_id * o_id
    dV_j  = sum_i round(P_ij) do_i            (P in v's type, as the forward)
    dS_ij = P_ij (do_i . v_j - D_i) (1 - tanh^2(s_ij / cap) with a softcap)
    dK_j  = sum_i round(dS_ij) qs_i           (qs: q * scale in q's type)
    dQ_i  = scale * sum_j round(dS_ij) k_j
with round() to q's type (a no-op in float32).  On a CUDA tensor it
launches ``csrc/flash_attention_bwd.cu`` (in one call: D, then dK/dV over
each KV tile, then dQ over each q tile; bf16 with dh 64 or 128 on the
tensor cores, first writing q * scale into a scratch copy; no atomics, so
two calls on the same inputs agree bit for bit) or raises; a CPU tensor
takes ``flash_attention_backward_plain``, the same math blockwise over
keys.  ``BWD_LAUNCHES`` counts its calls.  ``FlashAttention`` is the
``torch.autograd.Function`` over the two: its forward saves q, k, v, o
and lse.

Cost rules (``launch/op_cost.counted``; on meta tensors an entry returns
empty outputs of the right shapes): the function's work, not the
kernel's tiling.  The forward does 4 · dh · BH · pairs FLOPs in q's type,
``pairs`` the unmasked (i, j) pairs (``pairs``: S(S+1)/2 causal, the band
with a window, S^2 without a mask); the backward 5 · 2 · dh · BH · pairs
(five products).  Bytes: every input read once, every output written
once (the forward q, k, v, o and with ``return_lse`` the lse; the
backward q, k, v, o, lse, do, dq, dk, dv).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import cuda_device, ptr, raise_on
from repro_torch.kernels._build import stream as _stream
from repro_torch.launch.op_cost import counted, nbytes

NEG = -1e30
BK = 512
LAUNCHES = _build.launch_table(__name__, "flash_attention")
BWD_LAUNCHES = _build.launch_table(__name__ + ".backward",
                                   "flash_attention_backward")
# launches by route, as the library dispatches them: {kernel: {route: n}}
# (not a launch table: the same launches, counted once more by route)
ROUTES = {name: {"tensor_cores": 0, "cuda_cores": 0}
          for name in ("flash_attention", "flash_attention_backward")}


def reset_launches() -> None:
    for table in (LAUNCHES, BWD_LAUNCHES, *ROUTES.values()):
        for k in table:
            table[k] = 0


def _route(fn, dh: int, bf16: bool) -> str:
    return "tensor_cores" if fn(dh, int(bf16)) else "cuda_cores"


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


def _mask(S, k0, kn, causal, window, device):
    """(S, kn) True where row i may see key k0 + j, or None (no mask)."""
    if not causal:
        return None
    qi = torch.arange(S, device=device)
    kj = torch.arange(k0, k0 + kn, device=device)
    ok = qi[:, None] >= kj[None, :]
    if window is not None:
        ok &= qi[:, None] - kj[None, :] < window
    return ok


def flash_attention_plain(q, k, v, *, causal=True, softcap=None, window=None,
                          bk=BK, return_lse=False):
    """The plain version: one pass per block of ``bk`` keys over every q
    row at once (causal blocks wholly in a row's future add exactly 0; so
    do a window's blocks wholly behind a row, after its first real max).
    ``return_lse``: also each row's log-sum-exp, float32 (BH, S)."""
    check_window(causal, window)
    BH, S, dh = q.shape
    f32 = torch.float32
    qs = scaled(q, dh ** -0.5).to(f32)
    m = torch.full((BH, S), NEG, dtype=f32, device=q.device)
    l = torch.zeros((BH, S), dtype=f32, device=q.device)
    acc = torch.zeros((BH, S, dh), dtype=f32, device=q.device)
    for k0 in range(0, S, bk):
        kb = k[:, k0:k0 + bk].to(f32)
        s = qs @ kb.transpose(1, 2)
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        ok = _mask(S, k0, kb.shape[1], causal, window, q.device)
        if ok is not None:
            s = torch.where(ok, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + \
            p.to(v.dtype).to(f32) @ v[:, k0:k0 + bk].to(f32)
        m = m_new
    den = torch.clamp(l, min=1e-20)
    o = (acc / den[..., None]).to(q.dtype)
    return (o, m + torch.log(den)) if return_lse else o


def _check_inputs(name, q, k, v, softcap):
    """The device, dtype, shape, alignment and softcap the kernels take;
    returns the device."""
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
    return dev


def pairs(S: int, causal: bool, window=None) -> int:
    """The (i, j) pairs of S rows and S keys that no mask removes."""
    if not causal:
        return S * S
    W = S if window is None else min(window, S)
    return W * (W + 1) // 2 + (S - W) * W


def _fwd_cost(q, k, v, *, causal=True, softcap=None, window=None,
              return_lse=False):
    BH, S, dh = q.shape
    lse = 4 * BH * S if return_lse else 0
    return (4 * dh * BH * pairs(S, causal, window),
            nbytes(q, k, v, q) + lse, q.dtype)


def _fwd_meta(q, k, v, *, causal=True, softcap=None, window=None,
              return_lse=False):
    o = torch.empty_like(q)
    if not return_lse:
        return o
    return o, torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)


@counted("flash_attention", _fwd_cost, _fwd_meta)
def flash_attention(q, k, v, *, causal=True, softcap=None, window=None,
                    return_lse=False):
    """(BH, S, dh) attention forward in q's type, and with ``return_lse``
    each row's float32 log-sum-exp (BH, S); see the module doc."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, softcap=softcap,
                                     window=window, return_lse=return_lse)
    check_window(causal, window)
    name = "flash_attention"
    dev = _check_inputs(name, q, k, v, softcap)
    BH, S, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=dev) \
        if return_lse else None
    if q.numel() == 0:
        return (o, lse) if return_lse else o
    scale = rounded(dh ** -0.5, q.dtype)
    lib, bf16 = _build.load(), q.dtype == torch.bfloat16
    err = lib.repro_flash_attention(
        ptr(q), ptr(k), ptr(v), ptr(o), None if lse is None else ptr(lse),
        BH, S, dh, int(bf16), int(causal), min(window or 0, S), scale,
        float(softcap or 0.0), _stream(dev))
    raise_on(err, name)
    LAUNCHES[name] += 1
    ROUTES[name][_route(lib.repro_flash_route, dh, bf16)] += 1
    return (o, lse) if return_lse else o


def flash_attention_backward_plain(q, k, v, o, lse, do, *, causal=True,
                                   softcap=None, window=None, bk=BK):
    """The backward's plain version: (dq, dk, dv) in q's type, one pass
    per block of ``bk`` keys over every q row, float32 state, the casts of
    the module doc."""
    check_window(causal, window)
    BH, S, dh = q.shape
    f32 = torch.float32
    scale = rounded(dh ** -0.5, q.dtype)
    qs = scaled(q, dh ** -0.5).to(f32)
    dof = do.to(f32)
    delta = (dof * o.to(f32)).sum(-1)                        # D: (BH, S)
    dq = torch.zeros((BH, S, dh), dtype=f32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, S, bk):
        kb, vb = k[:, k0:k0 + bk].to(f32), v[:, k0:k0 + bk].to(f32)
        p, ds = _p_ds(qs, kb, vb, dof, lse, delta, softcap,
                      _mask(S, k0, kb.shape[1], causal, window, q.device))
        p, ds = p.to(v.dtype).to(f32), ds.to(q.dtype).to(f32)
        dv[:, k0:k0 + bk] = (p.transpose(1, 2) @ dof).to(v.dtype)
        dk[:, k0:k0 + bk] = (ds.transpose(1, 2) @ qs).to(k.dtype)
        dq += ds @ kb
    return (dq * scale).to(q.dtype), dk, dv


def _p_ds(qs, kb, vb, dof, lse, delta, softcap, ok):
    """P and dS (float32) of one block of keys, 0 where ``ok`` is False."""
    s = qs @ kb.transpose(1, 2)
    if softcap is not None:
        th = torch.tanh(s / softcap)
        s = th * softcap
    p = torch.exp(s - lse[..., None])
    ds = p * (dof @ vb.transpose(1, 2) - delta[..., None])
    if softcap is not None:
        ds = ds * (1.0 - th * th)
    if ok is not None:
        p, ds = torch.where(ok, p, 0.0), torch.where(ok, ds, 0.0)
    return p, ds


def _bwd_cost(q, k, v, o, lse, do, *, causal=True, softcap=None,
              window=None):
    BH, S, dh = q.shape
    return (5 * 2 * dh * BH * pairs(S, causal, window),
            nbytes(q, k, v, o, lse, do, q, k, v), q.dtype)


def _bwd_meta(q, k, v, o, lse, do, *, causal=True, softcap=None,
              window=None):
    return tuple(torch.empty_like(t) for t in (q, k, v))


@counted("flash_attention_backward", _bwd_cost, _bwd_meta)
def flash_attention_backward(q, k, v, o, lse, do, *, causal=True,
                             softcap=None, window=None):
    """(dq, dk, dv) of the forward at q, k, v given its output ``o``, its
    ``lse`` and the output's gradient ``do``; see the module doc."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, o, lse, do, causal=causal, softcap=softcap,
            window=window)
    check_window(causal, window)
    name = "flash_attention_backward"
    dev = _check_inputs(name, q, k, v, softcap)
    _build.check(name, dev, o=(o, q.dtype), do=(do, q.dtype),
                 lse=(lse, torch.float32))
    BH, S, dh = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (BH, S):
        raise ValueError(f"{name}: o and do must be {tuple(q.shape)} and "
                         f"lse {(BH, S)}, got {tuple(o.shape)}, "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    for arg, t in (("o", o), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    lib, bf16 = _build.load(), q.dtype == torch.bfloat16
    route = _route(lib.repro_flash_bwd_route, dh, bf16)
    delta = torch.empty((BH, S), dtype=torch.float32, device=dev)
    qs = torch.empty_like(q) if route == "tensor_cores" else None
    err = lib.repro_flash_attention_bwd(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(do), ptr(dq), ptr(dk),
        ptr(dv), ptr(delta), None if qs is None else ptr(qs), BH, S, dh,
        int(bf16), int(causal), min(window or 0, S),
        rounded(dh ** -0.5, q.dtype), float(softcap or 0.0), _stream(dev))
    raise_on(err, name)
    BWD_LAUNCHES[name] += 1
    ROUTES[name][route] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """The flash forward with the hand-written backward as its gradient:
    ``FlashAttention.apply(q, k, v, causal, softcap, window)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap, window):
        o, lse = flash_attention(q, k, v, causal=causal, softcap=softcap,
                                 window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, softcap=softcap, window=window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse,
                                              do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None
