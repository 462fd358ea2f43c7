"""Transformer layers (counterpart of ``repro/models/layers.py``): norms,
RoPE, GQA attention (flash for prefill, cache attention for decode,
either windowed for local attention), cross-attention to a source's k
and v, the SwiGLU MLP, the capacity-based top-k MoE, parameter init.

Conventions as in the reference: activations (B, S, D); attention heads
(B, S, H, dh); every sublayer is pre-norm residual; a sublayer's weights
sit in an ``nn.ParameterDict`` under the reference's names.  On one card
the reference's sharding constraints are the identity, so no ``shard``
argument is threaded through.

``flash_attention`` takes the backend:

* ``"torch"`` computes the reference's chunked schedule: blocks of
  ``KV_BLOCK`` keys with a running (max, denominator, accumulator), the
  accumulator in q's type;
* ``"cuda"`` hands (B·H, S, dh) to the flash kernel
  (``kernels/flash_attention.py``), the lowering of the same function
  (as the Pallas kernel is on the TPU), with a float32 accumulator.  On a
  CPU tensor the kernel's wrapper runs its plain version.  Where autograd
  records (training), it goes through ``FlashAttention``, whose backward
  is the hand-written backward kernel; serving, under ``no_grad``, calls
  the forward alone, as before.

Parameters are trainable (``requires_grad``); serving runs under
``torch.no_grad``.

``cache_attend``, ``cross_attention``, the projections and the MoE are
plain tensor code; the reference computes them outside any kernel too.
The MoE dispatches as the active ``Tuning`` says (``models/tuning.py``):
``'scatter'`` (the baseline) or ``'gather'``, the reference's two
single-device forms; ``'shard_map'`` falls back to ``'gather'`` with no
device mesh, as the reference's does (the mesh form waits for the
sharding item, ROADMAP Queue 1 item 14f).  Decode writes the new token's
k and v into the cache in place (the reference's ``dynamic_update_slice``
makes a new cache each step); with a window and the ``window_slice``
knob (on in the default ``OPTIMIZED``) it reads only the window's slice
of a longer cache, else full-length logits, masked.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.archs import ArchConfig
from repro_torch.kernels import flash_attention as FK
from repro_torch.kernels.flash_attention import scaled
from repro_torch.models.tuning import get_tuning

F32 = torch.float32
KV_BLOCK = 1024
NEG = -1e30
BACKENDS = ("cuda", "torch")


def rms_norm(x, scale, eps=1e-6):
    var = torch.mean(torch.square(x.to(F32)), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * (1.0 + scale)


def rope(x, positions, theta):
    """x: (..., S, H, dh); positions: (..., S)"""
    dh = x.shape[-1]
    half = dh // 2
    # log(theta) in float32, as the reference takes it, on the host
    log_theta = float(torch.log(torch.tensor(theta, dtype=F32)))
    freqs = torch.exp(-log_theta * torch.arange(half, dtype=F32,
                                                device=x.device) / half)
    ang = positions[..., :, None].to(F32) * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :].to(x.dtype)
    sin = torch.sin(ang)[..., :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def softcap(logits, cap: Optional[float]):
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def qkv_project(p, x, cfg: ArchConfig):
    B, S, D = x.shape
    H, kv, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, kv, dh)
    v = (x @ p["wv"]).reshape(B, S, kv, dh)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(H, dh)
        k = k + p["bk"].reshape(kv, dh)
        v = v + p["bv"].reshape(kv, dh)
    return q, k, v


def _flash_body(q, k, v, mask, cap):
    """One KV block: q (B,S,H,dh), k/v (B,Kb,H,dh), mask (S,Kb) or None."""
    logits = torch.einsum("bshd,bthd->bhst", q, k).to(F32)
    logits = softcap(logits, cap)
    if mask is not None:
        logits = torch.where(mask[None, None], logits, NEG)
    m = torch.amax(logits, dim=-1)                            # (B,H,S)
    p = torch.exp(logits - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhst,bthd->bshd", p.to(v.dtype), v)
    return m, l, acc


def flash_attention(q, k, v, cfg: ArchConfig, positions, causal: bool,
                    scale: float, backend: str = "cuda", window=None):
    """Chunked-softmax attention; q,k,v: (B,S,H,dh) (kv already repeated).

    ``positions`` is ``arange(S)`` on every caller; the kernel masks by
    absolute index, which is the same thing.  ``window`` (local attention)
    also masks keys ``window`` or more behind the row (causal only)."""
    if backend == "cuda":
        return _flash_kernel(q, k, v, cfg, causal, scale, window)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    B, S, H, dh = q.shape
    q = scaled(q, scale)
    Kb = min(KV_BLOCK, S)
    if S % Kb:               # non-power-of-two source lengths: one block
        Kb = S
    qpos = positions                                            # (S,)
    m = torch.full((B, H, S), NEG, dtype=F32, device=q.device)
    l = torch.zeros((B, H, S), dtype=F32, device=q.device)
    acc = torch.zeros((B, S, H, dh), dtype=q.dtype, device=q.device)
    for k0 in range(0, S, Kb):
        kpos = k0 + torch.arange(Kb, device=q.device)
        mask = None
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
        m1, l1, a1 = _flash_body(q, k[:, k0:k0 + Kb], v[:, k0:k0 + Kb],
                                 mask, cfg.attn_softcap)
        mn = torch.maximum(m, m1)
        c0 = torch.exp(m - mn)
        c1 = torch.exp(m1 - mn)
        l = l * c0 + l1 * c1
        acc = acc * c0.transpose(1, 2)[..., None].to(acc.dtype) \
            + a1 * c1.transpose(1, 2)[..., None].to(a1.dtype)
        m = mn
    denom = torch.clamp(l, min=1e-20).transpose(1, 2)[..., None]
    return (acc / denom.to(acc.dtype)).to(q.dtype)


def to_heads(x):
    """(B, S, H, dh) -> the flash kernel's contiguous (B * H, S, dh)."""
    B, S, H, dh = x.shape
    return x.transpose(1, 2).reshape(B * H, S, dh).contiguous()


def _flash_kernel(q, k, v, cfg: ArchConfig, causal, scale, window):
    B, S, H, dh = q.shape
    if scale != dh ** -0.5:
        raise ValueError(f"the flash kernel scales q by dh**-0.5, "
                         f"got scale={scale}")
    q, k, v = to_heads(q), to_heads(k), to_heads(v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        o = FK.FlashAttention.apply(q, k, v, causal, cfg.attn_softcap,
                                    window)
    else:
        o = FK.flash_attention(q, k, v, causal=causal,
                               softcap=cfg.attn_softcap, window=window)
    return o.reshape(B, H, S, dh).transpose(1, 2)


def repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    B, S, kv, dh = k.shape
    return k[:, :, :, None].expand(B, S, kv, n_rep, dh) \
        .reshape(B, S, kv * n_rep, dh)


def attention_full(p, x, cfg: ArchConfig, positions, causal=True,
                   backend="cuda", window=None):
    """Attention over the whole sequence: (out, k, v), with k and v after
    RoPE and before ``repeat_kv`` (what prefill puts in the cache)."""
    B, S, D = x.shape
    H, kv, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    q, k, v = qkv_project(p, x, cfg)
    if causal:  # encoders (bidir) skip rope to mimic abs-pos (stub choice)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, repeat_kv(k, H // kv), repeat_kv(v, H // kv), cfg,
                        positions, causal, scale=dh ** -0.5, backend=backend,
                        window=window)
    return o.reshape(B, S, H * dh) @ p["wo"], k, v


def attention_train(p, x, cfg: ArchConfig, positions, causal=True,
                    window=None, backend="cuda"):
    return attention_full(p, x, cfg, positions, causal, backend, window)[0]


def attention_decode(p, x, cfg: ArchConfig, cache_k, cache_v, pos: int,
                     window=None):
    """x: (B,1,D); cache_k/v: (B,kv,S,dh), written at ``pos`` in place."""
    B, _, D = x.shape
    H, kv, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    q, k, v = qkv_project(p, x, cfg)
    posv = torch.full((1,), pos, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    cache_k[:, :, pos:pos + 1] = k.to(cache_k.dtype).transpose(1, 2)
    cache_v[:, :, pos:pos + 1] = v.to(cache_v.dtype).transpose(1, 2)
    out = cache_attend(q, cache_k, cache_v, cfg, pos, window)
    return out.reshape(B, 1, H * dh) @ p["wo"], cache_k, cache_v


def cache_attend(q, cache_k, cache_v, cfg: ArchConfig, pos: int,
                 window=None):
    """q: (B,1,H,dh); cache: (B,kv,S,dh) -> (B,1,H,dh); keys past ``pos``
    masked, and with a window those ``window`` or more behind it.  Under
    the ``window_slice`` knob a cache longer than the window is read only
    in its window-sized slice from ``clip(pos - window + 1, 0, S -
    window)``: ``pos`` is a host int, so the slice is a view."""
    B, _, H, dh = q.shape
    kv = cache_k.shape[1]
    rep = H // kv
    qh = scaled(q.reshape(B, kv, rep, dh), dh ** -0.5)
    S = cache_k.shape[2]
    base = 0
    if window is not None and get_tuning().window_slice and S > window:
        base = min(max(pos - window + 1, 0), S - window)
        cache_k = cache_k[:, :, base:base + window]
        cache_v = cache_v[:, :, base:base + window]
        S = window
    logits = torch.einsum("bkrd,bksd->bkrs", qh, cache_k).to(F32)
    logits = softcap(logits, cfg.attn_softcap)
    jpos = base + torch.arange(S, device=q.device)
    ok = jpos <= pos
    if window is not None:
        ok &= jpos > pos - window
    logits = torch.where(ok[None, None, None], logits, NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrs,bksd->bkrd", p.to(cache_v.dtype), cache_v)
    return out.reshape(B, 1, H, dh)


def cross_attention(p, x, src_k, src_v, cfg: ArchConfig):
    """x: (B,S,D) attending to precomputed source k/v (B,kv,T,dh): no
    mask, no softcap, no RoPE, as in the reference."""
    B, S, D = x.shape
    H, kv, dh = cfg.n_heads, cfg.n_kv, cfg.dh
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    qh = scaled(q.reshape(B, S, kv, H // kv, dh), dh ** -0.5)
    logits = torch.einsum("bskrd,bktd->bskrt", qh, src_k).to(F32)
    pr = torch.softmax(logits, dim=-1)
    out = torch.einsum("bskrt,bktd->bskrd", pr.to(src_v.dtype), src_v)
    return out.reshape(B, S, H * dh) @ p["wo"]


def xattn_kv(p, src, cfg: ArchConfig):
    """Cross-attention k/v (B,kv,T,dh) from source embeddings (B,T,D)."""
    B, T, D = src.shape
    kv, dh = cfg.n_kv, cfg.dh
    k = (src @ p["wk"]).reshape(B, T, kv, dh)
    v = (src @ p["wv"]).reshape(B, T, kv, dh)
    return k.transpose(1, 2), v.transpose(1, 2)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def mlp(p, x):
    g = x @ p["w_gate"]
    h = g * torch.sigmoid(g) * (x @ p["w_up"])
    return h @ p["w_down"]


class Route(NamedTuple):
    """The MoE's dispatch of T tokens' top-K (token, expert) pairs, sorted
    by expert (stably, so a token's pairs keep their top-k order within an
    expert's group): ``order`` the sort's permutation of the (T * K,)
    pairs, ``eid_s``/``tok_s``/``gate_s`` the sorted experts, tokens and
    renormalised gates; ``keep`` marks a pair within its expert's
    capacity C, ``slot`` its row of the (E * C) buffer (E * C when
    dropped), ``tok_for_slot`` (E * C,) each row's token (T when empty)."""
    order: torch.Tensor
    eid_s: torch.Tensor
    tok_s: torch.Tensor
    gate_s: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    tok_for_slot: torch.Tensor


def moe_route(router, xt, E: int, K: int, C: int) -> Route:
    """Top-K routing of xt (T, D) over E experts of capacity C, as the
    reference's ``moe`` routes: a float32 router (the activations cast up
    to it, as jnp promotes them), softmax, the K best scores (ties to the
    lower expert, as ``lax.top_k``) renormalised, a stable sort by expert,
    each pair's rank in its expert's group (the group's start by a
    left-side search) and the pairs of rank C or more dropped."""
    T = xt.shape[0]
    scores = torch.softmax(xt.to(F32) @ router, dim=-1)        # (T, E)
    top_s, top_e = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_s, top_e = top_s[:, :K], top_e[:, :K]
    top_s = top_s / top_s.sum(-1, keepdim=True)
    eid = top_e.reshape(T * K)
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    tok_s = torch.div(order, K, rounding_mode="floor")   # the pair's token
    rank = torch.arange(T * K, device=xt.device) - \
        torch.searchsorted(eid_s, eid_s, side="left")
    keep = rank < C
    slot = torch.where(keep, eid_s * C + rank, E * C)
    tok_for_slot = torch.full((E * C + 1,), T, dtype=torch.int32,
                              device=xt.device)
    tok_for_slot[slot] = tok_s.to(torch.int32)    # every drop lands on E * C
    return Route(order, eid_s, tok_s, top_s.reshape(T * K)[order], keep,
                 slot, tok_for_slot[:E * C])


MOE_DISPATCHES = ("scatter", "gather", "shard_map")


def moe(p, x, cfg: ArchConfig):
    """Capacity-based top-k MoE on one device: each expert's rows in a
    static (E, C, D) buffer (overflowing pairs dropped), the SwiGLU
    experts as batched products, and each token's kept outputs weighted
    by their gates and added in ascending expert order (the order of the
    reference's scatter-add over the sorted pairs) with no atomics.  The
    buffer is filled as the ``moe_dispatch`` knob says: ``'scatter'``
    writes each kept pair's row at its slot, ``'gather'`` (and
    ``'shard_map'`` without a mesh) gathers each slot's row by
    ``tok_for_slot``; both give the same buffer."""
    mc = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = mc.n_experts, mc.top_k
    C = max(int(T * K / E * mc.capacity_factor), 8)
    dispatch = get_tuning().moe_dispatch
    if dispatch not in MOE_DISPATCHES:
        raise ValueError(f"unknown moe_dispatch {dispatch!r}; one of "
                         f"{MOE_DISPATCHES}")
    xt = x.reshape(T, D)
    r = moe_route(p["router"], xt, E, K, C)
    if dispatch == "scatter":
        xe = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
        xe[r.slot] = xt[r.tok_s]          # every dropped pair lands on E * C
        xe = xe[:E * C]
    else:
        xe = torch.where((r.tok_for_slot < T)[:, None],
                         xt[torch.clamp(r.tok_for_slot, max=T - 1)],
                         torch.zeros((), dtype=x.dtype, device=x.device))
    xe = xe.reshape(E, C, D)
    g = torch.bmm(xe, p["w_gate"])
    ye = torch.bmm(g * torch.sigmoid(g) * torch.bmm(xe, p["w_up"]),
                   p["w_down"]).reshape(E * C, D)
    contrib = ye[torch.clamp(r.slot, max=E * C - 1)] * \
        (r.gate_s * r.keep).to(ye.dtype)[:, None]
    # each token's K pairs by their place in the sorted list: ascending
    # expert, since a token's K experts differ
    where = torch.empty_like(r.order)
    where[r.order] = torch.arange(T * K, device=x.device)
    where = torch.sort(where.reshape(T, K), dim=1).values
    y = contrib[where[:, 0]]
    for k in range(1, K):
        y = y + contrib[where[:, k]]
    return y.reshape(B, S, D)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


def _init(shape, generator, device, scale=None, dtype=torch.bfloat16):
    """Normal weights times ``scale`` (default fan-in**-0.5), drawn in
    float32 from ``generator`` and cast; with no generator the tensor is
    left uninitialised, for a caller that loads weights into it."""
    if generator is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    scale = scale if scale is not None else (1.0 / max(shape[0], 1)) ** 0.5
    return _param((torch.randn(shape, generator=generator, dtype=F32,
                               device=device) * scale).to(dtype))


def _zeros(shape, dtype, device):
    return _param(torch.zeros(shape, dtype=dtype, device=device))


def init_attn(cfg: ArchConfig, dtype, device, generator) -> nn.ParameterDict:
    H, kv, dh, D = cfg.n_heads, cfg.n_kv, cfg.dh, cfg.d_model
    p = nn.ParameterDict({
        "ln": _zeros((D,), dtype, device),
        "wq": _init((D, H * dh), generator, device, dtype=dtype),
        "wk": _init((D, kv * dh), generator, device, dtype=dtype),
        "wv": _init((D, kv * dh), generator, device, dtype=dtype),
        "wo": _init((H * dh, D), generator, device, dtype=dtype),
    })
    if cfg.qkv_bias:
        p["bq"] = _zeros((H * dh,), dtype, device)
        p["bk"] = _zeros((kv * dh,), dtype, device)
        p["bv"] = _zeros((kv * dh,), dtype, device)
    if cfg.attn_softcap is not None:
        p["post_ln"] = _zeros((D,), dtype, device)
    return p


def init_mlp(cfg: ArchConfig, dtype, device, generator) -> nn.ParameterDict:
    D, F = cfg.d_model, cfg.d_ff
    return nn.ParameterDict({
        "ln": _zeros((D,), dtype, device),
        "w_gate": _init((D, F), generator, device, dtype=dtype),
        "w_up": _init((D, F), generator, device, dtype=dtype),
        "w_down": _init((F, D), generator, device, dtype=dtype),
    })


def init_moe(cfg: ArchConfig, dtype, device, generator) -> nn.ParameterDict:
    """The router is float32 in every model, as the reference's."""
    D, E, F = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff
    return nn.ParameterDict({
        "ln": _zeros((D,), dtype, device),
        "router": _init((D, E), generator, device, dtype=F32),
        "w_gate": _init((E, D, F), generator, device, dtype=dtype),
        "w_up": _init((E, D, F), generator, device, dtype=dtype),
        "w_down": _init((E, F, D), generator, device, dtype=dtype),
    })
