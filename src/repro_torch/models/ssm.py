"""State-space and recurrent mixers (counterpart of ``repro/models/ssm.py``):
Mamba (jamba's mixer), mLSTM and sLSTM (xlstm's).

Each has a train form over the whole sequence (what prefill runs) and a
decode form that carries an explicit recurrent state one token at a
time: the state takes the place of a KV cache.  Arithmetic follows the
reference: the recurrent states and the gates are float32 whatever the
model's dtype (Mamba's ``A_log`` parameter too), everything else is in
the model's dtype.

The reference computes these mixers in plain jnp, outside any Pallas
kernel, and so does the port in plain PyTorch:

* Mamba's scan over a chunk of ``CHUNK`` positions is a doubling scan
  (log2(T) rounds of ``h_t = a_t * h_{t-d} + b_t``) in float32; the
  reference's ``lax.associative_scan`` adds in another tree order, so the
  two agree to float32 rounding, not bit for bit.
* mLSTM is the reference's chunkwise linear attention: a masked quadratic
  form inside a chunk, the carried matrix memory across chunks.
* sLSTM is sequential: a Python loop over the positions, with the input
  projection of every position computed in one product before it.

A sequence longer than ``CHUNK`` must split into ``S // CHUNK`` equal
chunks, as the reference's reshape requires.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.archs import ArchConfig
from repro_torch.models.layers import _init, _param, _zeros

F32 = torch.float32
CHUNK = 64  # sequence chunk of the train forms (memory bound)


def _chunks(S: int) -> tuple:
    """(number of chunks, chunk length) of a sequence of S positions."""
    nchunk = max(S // CHUNK, 1)
    csz = S // nchunk
    if nchunk * csz != S:
        raise ValueError(f"a sequence of {S} positions does not split into "
                         f"{nchunk} chunks of {csz}")
    return nchunk, csz


# ---------------------------------------------------------------------------
# Mamba (selective SSM, diagonal A): jamba's mixer
# ---------------------------------------------------------------------------

def init_mamba(cfg: ArchConfig, dtype, device, generator) -> nn.ParameterDict:
    D = cfg.d_model
    mc = cfg.mamba
    E, N = mc.expand * D, mc.d_state
    return nn.ParameterDict({
        "ln": _zeros((D,), dtype, device),
        "in_proj": _init((D, 2 * E), generator, device, dtype=dtype),
        "conv_w": _init((mc.d_conv, E), generator, device, dtype=dtype),
        "conv_b": _zeros((E,), dtype, device),
        "x_bc": _init((E, 2 * N), generator, device, dtype=dtype),
        "x_dt": _init((E, 1), generator, device, dtype=dtype),
        "dt_bias": _zeros((E,), dtype, device),
        "A_log": _zeros((E, N), F32, device),     # float32 in every model
        "skip_d": _param(torch.ones((E,), dtype=dtype, device=device)),
        "out_proj": _init((E, D), generator, device, dtype=dtype),
    })


def _mamba_select(p, u):
    """The data-dependent B, C (..., N) and Δ (..., E) of u (..., E).  The
    reference's Δ einsum ``...e,eo->...e`` sums over the size-1 axis o,
    so Δ's projection is elementwise."""
    Bm, Cm = (u @ p["x_bc"]).chunk(2, dim=-1)
    dt = F.softplus(u * p["x_dt"][:, 0] + p["dt_bias"])
    return Bm, Cm, dt


def _mamba_scan_chunk(h0, a, bu):
    """h_t = a_t * h_{t-1} + bu_t over a chunk; a/bu: (B, T, E, N)
    float32, h0: (B, E, N).  Returns every h_t and the last.

    Each doubling round is one addcmul and one mul.  Where autograd
    records, they build the round's a and bu with ``torch.cat`` (no
    in-place write); serving writes them into fresh buffers with ``out=``
    instead, which moves each round's bytes once, not twice, and gives the
    same bits."""
    T = a.shape[1]
    buffered = not (torch.is_grad_enabled() and
                    (a.requires_grad or bu.requires_grad or
                     h0.requires_grad))
    d = 1
    while d < T:
        if buffered:
            nb, na = torch.empty_like(bu), torch.empty_like(a)
            nb[:, :d], na[:, :d] = bu[:, :d], a[:, :d]
            torch.addcmul(bu[:, d:], a[:, d:], bu[:, :-d], out=nb[:, d:])
            torch.mul(a[:, d:], a[:, :-d], out=na[:, d:])
            a, bu = na, nb
        else:
            bu = torch.cat([bu[:, :d], torch.addcmul(bu[:, d:], a[:, d:],
                                                     bu[:, :-d])], 1)
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    h = a * h0[:, None] + bu
    return h, h[:, -1]


def mamba_train(p, x, cfg: ArchConfig):
    """x: (B,S,D) -> (B,S,D); the scan chunk by chunk over S."""
    B, S, D = x.shape
    mc = cfg.mamba
    E, N = mc.expand * D, mc.d_state
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    # depthwise causal conv (kernel d_conv), products added left to right
    pad = F.pad(xin, (0, 0, mc.d_conv - 1, 0))
    conv = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(mc.d_conv))
    u = F.silu(conv + p["conv_b"])
    Bm, Cm, dt = _mamba_select(p, u)
    A = -torch.exp(p["A_log"])                               # (E, N)
    nchunk, csz = _chunks(S)
    h = torch.zeros((B, E, N), dtype=F32, device=x.device)
    ys = []
    for c in range(0, S, csz):
        dtc, uc = dt[:, c:c + csz], u[:, c:c + csz]
        a = torch.exp(dtc[..., None].to(F32) * A)            # (B,T,E,N)
        bu = (dtc * uc)[..., None].to(F32) * Bm[:, c:c + csz, None, :]
        hs, h = _mamba_scan_chunk(h, a, bu)
        y = torch.einsum("bten,btn->bte", hs, Cm[:, c:c + csz].to(F32))
        ys.append(y.to(x.dtype))
    y = (torch.cat(ys, 1) + u * p["skip_d"]) * F.silu(z)
    return y @ p["out_proj"]


def mamba_init_state(cfg: ArchConfig, B, dtype, device=None) -> dict:
    mc = cfg.mamba
    E, N = mc.expand * cfg.d_model, mc.d_state
    return {"h": torch.zeros((B, E, N), dtype=F32, device=device),
            "conv": torch.zeros((B, mc.d_conv - 1, E), dtype=dtype,
                                device=device)}


def mamba_decode(p, x, state, cfg: ArchConfig):
    """x: (B,1,D); state: {'h': (B,E,N), 'conv': (B,d_conv-1,E)}."""
    xin, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)
    hist = torch.cat([state["conv"], xin[:, None]], 1)
    conv = torch.einsum("bke,ke->be", hist, p["conv_w"])
    u = F.silu(conv + p["conv_b"])
    Bv, Cv, dt = _mamba_select(p, u)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None].to(F32) * A)
    h = a * state["h"] + (dt * u)[..., None].to(F32) * Bv[:, None, :]
    y = torch.einsum("ben,bn->be", h, Cv.to(F32)).to(x.dtype)
    y = (y + u * p["skip_d"]) * F.silu(z)
    return (y @ p["out_proj"])[:, None], {"h": h, "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory; chunkwise linear-attention train form)
# ---------------------------------------------------------------------------

def init_mlstm(cfg: ArchConfig, dtype, device, generator) -> nn.ParameterDict:
    D, H = cfg.d_model, cfg.n_heads
    E = 2 * D
    w = lambda shape: _init(shape, generator, device, dtype=dtype)
    return nn.ParameterDict({
        "ln": _zeros((D,), dtype, device),
        "wq": w((D, E)), "wk": w((D, E)), "wv": w((D, E)),
        "wi": w((D, H)),                    # input gate (per head)
        "wf": w((D, H)),                    # forget gate
        "wo_gate": w((D, E)),
        "out_proj": w((E, D)),
    })


def _mlstm_heads(cfg: ArchConfig):
    """(heads, head width): the width is 2 * d_model / heads, not cfg.dh."""
    return cfg.n_heads, 2 * cfg.d_model // cfg.n_heads


def _mlstm_project(p, x, cfg: ArchConfig):
    """q, k (scaled by dh**-0.5), v: (..., H, dh); the input and forget
    gates (..., H) in float32."""
    H, dh = _mlstm_heads(cfg)
    heads = lambda t: t.reshape(*t.shape[:-1], H, dh)
    q = heads(x @ p["wq"])
    k = heads(x @ p["wk"]) * dh ** -0.5
    v = heads(x @ p["wv"])
    i_g = torch.sigmoid((x @ p["wi"]).to(F32))
    f_g = torch.sigmoid((x @ p["wf"]).to(F32))
    return q, k, v, i_g, f_g


def _mlstm_out(p, x, y):
    return (torch.sigmoid(x @ p["wo_gate"]) * y) @ p["out_proj"]


def mlstm_train(p, x, cfg: ArchConfig):
    """Chunkwise linear attention with per-head scalar decay gates."""
    B, S, D = x.shape
    H, dh = _mlstm_heads(cfg)
    q, k, v, i_g, f_g = _mlstm_project(p, x, cfg)
    nchunk, csz = _chunks(S)
    mask = torch.ones((csz, csz), dtype=torch.bool, device=x.device).tril()
    Cmem = torch.zeros((B, H, dh, dh), dtype=F32, device=x.device)
    nmem = torch.zeros((B, H, dh), dtype=F32, device=x.device)
    ys = []
    for c in range(0, S, csz):
        qq, kk, vv, ii, ff = (t[:, c:c + csz] for t in (q, k, v, i_g, f_g))
        # intra-chunk: masked quadratic attention with decay weights
        cumf = torch.cumsum(torch.log(ff + 1e-8), 1)             # (B,T,H)
        dmat = cumf[:, :, None] - cumf[:, None, :]               # (B,T,T',H)
        # the upper triangle of exp(dmat) can be inf: select, not multiply
        # the upper triangle of exp(dmat) can be inf: select, not multiply
        w = torch.where(mask[None, :, :, None], torch.exp(dmat), 0.0) * \
            ii[:, None]
        att = torch.einsum("bthd,bshd->btsh", qq, kk).to(F32)
        vf = vv.to(F32)
        intra = torch.einsum("btsh,bshd->bthd", att * w, vf)
        norm = torch.einsum("btsh,btsh->bth", att, w)
        if c:
            # inter-chunk: the carried matrix memory, decayed to each t
            # (zero before the second chunk, so the first skips it)
            decay_to_t = torch.exp(cumf)
            qf = qq.to(F32)
            intra = intra + torch.einsum("bthd,bhde->bthe", qf, Cmem) * \
                decay_to_t[..., None]
            norm = torch.einsum("bthd,bhd->bth", qf, nmem) * decay_to_t + \
                norm
        y = intra / torch.clamp(norm.abs(), min=1.0)[..., None]
        # the memory at the chunk's end
        tot = cumf[:, -1]                                         # (B,H)
        kf = kk.to(F32)
        gate = torch.exp(tot[:, None] - cumf) * ii                # (B,T,H)
        Cmem = Cmem * torch.exp(tot)[..., None, None] + \
            torch.einsum("bshd,bshe->bhde", kf * gate[..., None], vf)
        nmem = nmem * torch.exp(tot)[..., None] + \
            torch.einsum("bshd,bsh->bhd", kf, gate)
        ys.append(y.to(x.dtype))
    return _mlstm_out(p, x, torch.cat(ys, 1).reshape(B, S, H * dh))


def mlstm_init_state(cfg: ArchConfig, B, dtype, device=None) -> dict:
    H, dh = _mlstm_heads(cfg)
    return {"C": torch.zeros((B, H, dh, dh), dtype=F32, device=device),
            "n": torch.zeros((B, H, dh), dtype=F32, device=device)}


def mlstm_decode(p, x, state, cfg: ArchConfig):
    B = x.shape[0]
    H, dh = _mlstm_heads(cfg)
    xt = x[:, 0]
    q, k, v, i_g, f_g = _mlstm_project(p, xt, cfg)
    kf = k.to(F32)
    C = state["C"] * f_g[..., None, None] + \
        torch.einsum("bhd,bhe->bhde", kf * i_g[..., None], v.to(F32))
    n = state["n"] * f_g[..., None] + kf * i_g[..., None]
    qf = q.to(F32)
    y = torch.einsum("bhd,bhde->bhe", qf, C)
    norm = torch.einsum("bhd,bhd->bh", qf, n)
    y = (y / torch.clamp(norm.abs(), min=1.0)[..., None]).to(x.dtype)
    return _mlstm_out(p, xt, y.reshape(B, H * dh))[:, None], \
        {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory; sequential)
# ---------------------------------------------------------------------------

def init_slstm(cfg: ArchConfig, dtype, device, generator) -> nn.ParameterDict:
    D = cfg.d_model
    return nn.ParameterDict({
        "ln": _zeros((D,), dtype, device),
        "w": _init((D, 4 * D), generator, device, dtype=dtype),
        "r": _init((D, 4 * D), generator, device, dtype=dtype),
        "b": _zeros((4 * D,), dtype, device),
        "out_proj": _init((D, D), generator, device, dtype=dtype),
    })


def _slstm_cell(p, wx, h, c):
    """One step from the input's projection ``wx`` = x_t @ w: the gates
    summed in the model's dtype, then float32 (h in the model's dtype, c
    float32)."""
    gates = wx + h @ p["r"] + p["b"]
    i, f, z, o = gates.to(F32).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(z)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h.to(wx.dtype), c


def slstm_train(p, x, cfg: ArchConfig):
    B, S, D = x.shape
    wx = x @ p["w"]                                     # (B, S, 4D)
    h = torch.zeros((B, D), dtype=x.dtype, device=x.device)
    c = torch.zeros((B, D), dtype=F32, device=x.device)
    hs = []
    for t in range(S):
        h, c = _slstm_cell(p, wx[:, t], h, c)
        hs.append(h)
    return torch.stack(hs, 1) @ p["out_proj"]


def slstm_init_state(cfg: ArchConfig, B, dtype, device=None) -> dict:
    D = cfg.d_model
    return {"h": torch.zeros((B, D), dtype=dtype, device=device),
            "c": torch.zeros((B, D), dtype=F32, device=device)}


def slstm_decode(p, x, state, cfg: ArchConfig):
    h, c = _slstm_cell(p, x[:, 0] @ p["w"], state["h"], state["c"])
    return (h @ p["out_proj"])[:, None], {"h": h, "c": c}
