"""Backbone assembly (counterpart of ``repro/models/transformer.py``):
init, the encoder pass, the full-sequence pass (prefill) and the
one-token pass (decode) over a cache.

The reference stacks each pattern position's weights over the repeat
axis and ``lax.scan``s the unit; here the layers are an ``nn.ModuleList``
run by a Python loop, unit r's pattern position i at index
``r * len(pattern) + i``.  Each layer is an ``nn.ModuleDict`` with a
``"mixer"`` and (unless the ffn is ``"none"``) an ``"ffn"``
``ParameterDict``.

Mixers: ``attn`` (causal), ``attn_local`` (causal within
``cfg.local_window`` keys), ``attn_bidir`` (the encoder's: not causal, no
RoPE), ``xattn`` (cross-attention to the source: the encoder's output
in prefill; in decode the raw ``src``, as the reference's ``serve_step``
passes it), and the recurrent ``mamba``, ``mlstm`` and ``slstm``
(``models/ssm.py``).  Ffns: ``mlp``, ``moe`` or ``none``.  ``long_mode``
decode windows the global layers of an arch with an attention softcap
too (the reference's long-context path).  An arch with ``enc_layers``
has an encoder of that many ``attn_bidir`` + ``mlp`` layers
(``Params.enc_layers``) and its final norm (``Params.enc_norm``).

Cache (decode): a list with one entry per layer:
  attn / attn_local : {"k", "v"}: (B, kv, S, dh)
  mamba             : {"h": (B, E, N) float32, "conv": (B, d_conv-1, E)}
  mlstm             : {"C": (B, H, dh, dh), "n": (B, H, dh)}, float32
  slstm             : {"h": (B, D), "c": (B, D) float32}
  xattn, attn_bidir : {}
Prefill fills the attention entries and, as the reference does, leaves
every recurrent mixer's entry at the zero state: decode after a prefill
starts the SSM layers from zero, not from the prompt's final state
(``repro/models/transformer.py``'s ``_mamba_final_state`` placeholder).

Training: ``backbone_full(..., use_remat=True)`` and ``encoder_pass(...,
use_remat=True)`` run each unit of the pattern under
``torch.utils.checkpoint`` (non-reentrant), as the reference wraps each
scan body in ``jax.checkpoint``: a unit's activations are recomputed in
the backward.  ``leaf_groups`` lists the parameters as the leaves of the
reference's params tree (what the optimizers and the checkpoints walk).
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.archs import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm

ATTN = ("attn", "attn_local", "attn_bidir")
SSM = ("mamba", "mlstm", "slstm")
MIXERS = ATTN + ("xattn",) + SSM
FFNS = ("mlp", "moe", "none")
ENC_SPEC = {"mixer": "attn_bidir", "ffn": "mlp"}


def check_spec(spec: dict) -> None:
    """Raise unless the layer's mixer and ffn are known kinds."""
    for part, ok in (("mixer", MIXERS), ("ffn", FFNS)):
        if spec[part] not in ok:
            raise ValueError(f"unknown {part} {spec[part]!r}; one of {ok}")


def layer_specs(cfg: ArchConfig) -> tuple:
    return tuple(cfg.pattern) * cfg.repeat


class Params(nn.Module):
    """The reference's params pytree as a module: ``embed``,
    ``final_norm``, ``lm_head`` (unless tied), ``layers`` and, with an
    encoder, ``enc_layers`` (the reference's ``enc_units``) and
    ``enc_norm``."""

    def __init__(self, embed, final_norm, layers, lm_head=None,
                 enc_layers=None, enc_norm=None):
        super().__init__()
        self.embed = embed
        self.final_norm = final_norm
        self.layers = layers
        self.lm_head = lm_head
        self.enc_layers = enc_layers
        self.enc_norm = enc_norm


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(spec: dict, cfg: ArchConfig, dtype, device,
               generator) -> nn.ModuleDict:
    check_spec(spec)
    m, f = spec["mixer"], spec["ffn"]
    init = getattr(ssm, "init_" + m) if m in SSM else L.init_attn
    p = nn.ModuleDict({"mixer": init(cfg, dtype, device, generator)})
    if f != "none":
        p["ffn"] = getattr(L, "init_" + f)(cfg, dtype, device, generator)
    return p


def init_unit(pattern, cfg: ArchConfig, dtype, device, generator) -> list:
    return [init_layer(spec, cfg, dtype, device, generator)
            for spec in pattern]


def init_params(cfg: ArchConfig, dtype=torch.bfloat16, device=None,
                generator=None) -> Params:
    """Weights drawn from ``generator`` (None: uninitialised, to load)."""
    D, V = cfg.d_model, cfg.vocab
    embed = L._init((V, D), generator, device, scale=0.02, dtype=dtype)
    layers = nn.ModuleList(
        layer for _ in range(cfg.repeat)
        for layer in init_unit(cfg.pattern, cfg, dtype, device, generator))
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = L._init((D, V), generator, device, scale=0.02, dtype=dtype)
    enc_layers = enc_norm = None
    if cfg.enc_layers:
        enc_layers = nn.ModuleList(
            init_layer(ENC_SPEC, cfg, dtype, device, generator)
            for _ in range(cfg.enc_layers))
        enc_norm = L._zeros((D,), dtype, device)
    return Params(embed, L._zeros((D,), dtype, device), layers, lm_head,
                  enc_layers, enc_norm)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _ffn(p, spec, x, cfg: ArchConfig):
    f = spec["ffn"]
    if f == "none":
        return x
    pf = p["ffn"]
    h = L.rms_norm(x, pf["ln"])
    return x + (L.moe(pf, h, cfg) if f == "moe" else L.mlp(pf, h))


def _cross(pm, x, cfg: ArchConfig, src):
    """x plus the cross-attention of its norm to ``src`` (B, T, D)."""
    if src is None:
        raise ValueError(f"{cfg.name}'s xattn layers need the source "
                         f"embeddings: pass src")
    sk, sv = L.xattn_kv(pm, src, cfg)
    return x + L.cross_attention(pm, L.rms_norm(x, pm["ln"]), sk, sv, cfg)


def apply_layer_full(p, spec, x, cfg: ArchConfig, positions, backend: str,
                     collect_cache: bool, src=None):
    """Returns (x, cache_entry)."""
    m = spec["mixer"]
    pm = p["mixer"]
    cache = {}
    if m in ATTN:
        window = cfg.local_window if m == "attn_local" else None
        att, k, v = L.attention_full(pm, L.rms_norm(x, pm["ln"]), cfg,
                                     positions, m != "attn_bidir", backend,
                                     window)
        if collect_cache:
            cache = {"k": k.transpose(1, 2).contiguous(),
                     "v": v.transpose(1, 2).contiguous()}
        if "post_ln" in pm:
            att = L.rms_norm(att, pm["post_ln"])
        x = x + att
    elif m in SSM:
        x = x + getattr(ssm, m + "_train")(pm, L.rms_norm(x, pm["ln"]), cfg)
        if collect_cache:              # the zero state, as the reference's
            cache = getattr(ssm, m + "_init_state")(cfg, x.shape[0],
                                                    x.dtype, x.device)
    else:                                                      # xattn
        x = _cross(pm, x, cfg, src)
    return _ffn(p, spec, x, cfg), cache


def apply_layer_decode(p, spec, x, cfg: ArchConfig, cache, pos: int,
                       src=None, long_mode: bool = False):
    m = spec["mixer"]
    pm = p["mixer"]
    if m in ("attn", "attn_local"):
        window = cfg.local_window if (
            m == "attn_local" or (long_mode and cfg.attn_softcap is not None)
        ) else None
        att, ck, cv = L.attention_decode(pm, L.rms_norm(x, pm["ln"]), cfg,
                                         cache["k"], cache["v"], pos, window)
        if "post_ln" in pm:
            att = L.rms_norm(att, pm["post_ln"])
        x = x + att
        cache = {"k": ck, "v": cv}
    elif m == "xattn":
        x = _cross(pm, x, cfg, src)
    elif m in SSM:
        y, cache = getattr(ssm, m + "_decode")(pm, L.rms_norm(x, pm["ln"]),
                                               cache, cfg)
        x = x + y
    return _ffn(p, spec, x, cfg), cache


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def init_cache_entry(spec, cfg: ArchConfig, B, S, dtype, device):
    check_spec(spec)
    m = spec["mixer"]
    if m in SSM:
        return getattr(ssm, m + "_init_state")(cfg, B, dtype, device)
    if m not in ("attn", "attn_local"):
        return {}
    kv, dh = cfg.n_kv, cfg.dh
    return {"k": torch.zeros((B, kv, S, dh), dtype=dtype, device=device),
            "v": torch.zeros((B, kv, S, dh), dtype=dtype, device=device)}


def init_cache(cfg: ArchConfig, B, S, dtype=torch.bfloat16,
               device=None) -> List[dict]:
    return [init_cache_entry(spec, cfg, B, S, dtype, device)
            for spec in layer_specs(cfg)]


# ---------------------------------------------------------------------------
# backbone passes
# ---------------------------------------------------------------------------

def _remat_units(layers, pattern, x, cfg: ArchConfig, positions,
                 backend: str, src):
    """x through ``layers``, one checkpointed unit of ``pattern`` at a
    time (no cache)."""
    n = len(pattern)

    def unit(r):
        def run(h):
            for p, spec in zip(layers[r * n:(r + 1) * n], pattern):
                h, _ = apply_layer_full(p, spec, h, cfg, positions, backend,
                                        False, src)
            return h
        return run

    for r in range(len(layers) // n):
        x = checkpoint(unit(r), x, use_reentrant=False)
    return x


def encoder_pass(cfg: ArchConfig, params: Params, src_embeds, backend: str,
                 use_remat: bool = False):
    """The encoder over the source embeddings (B, T, D): ``enc_layers``
    bidirectional attention + MLP layers, then ``enc_norm``."""
    positions = torch.arange(src_embeds.shape[1], device=src_embeds.device)
    x = src_embeds
    if use_remat:
        x = _remat_units(params.enc_layers, (ENC_SPEC,), x, cfg, positions,
                         backend, None)
    else:
        for p in params.enc_layers:
            x, _ = apply_layer_full(p, ENC_SPEC, x, cfg, positions, backend,
                                    False)
    return L.rms_norm(x, params.enc_norm)


def backbone_full(cfg: ArchConfig, params: Params, x, backend: str,
                  collect_cache: bool, src=None, use_remat: bool = False):
    """Full-sequence pass (prefill; training with ``use_remat``, which
    collects no cache). x: (B,S,D) embedded; ``src`` (B,T,D) for the xattn
    layers."""
    positions = torch.arange(x.shape[1], device=x.device)
    caches = []
    if use_remat:
        if collect_cache:
            raise ValueError("a rematerialised pass collects no cache")
        x = _remat_units(params.layers, cfg.pattern, x, cfg, positions,
                         backend, src)
        return L.rms_norm(x, params.final_norm), caches
    for p, spec in zip(params.layers, layer_specs(cfg)):
        x, c = apply_layer_full(p, spec, x, cfg, positions, backend,
                                collect_cache, src)
        caches.append(c)
    return L.rms_norm(x, params.final_norm), caches


def backbone_decode(cfg: ArchConfig, params: Params, x, cache, pos: int,
                    src=None, long_mode: bool = False):
    """Single-token pass. x: (B,1,D); one cache entry per layer."""
    new_cache = []
    for p, spec, c in zip(params.layers, layer_specs(cfg), cache):
        x, nc = apply_layer_decode(p, spec, x, cfg, c, pos, src, long_mode)
        new_cache.append(nc)
    return L.rms_norm(x, params.final_norm), new_cache


# ---------------------------------------------------------------------------
# the reference's params tree
# ---------------------------------------------------------------------------

class Leaf(NamedTuple):
    """One leaf of the reference's params tree: its path (a top-level key,
    or ``(key, unit position, part, name)``), the port's tensors it holds
    (each unit's, in repeat order) and whether the reference stacks them
    over the repeat axis."""
    path: tuple
    tensors: list
    stacked: bool


def leaf_groups(cfg: ArchConfig, params: Params) -> List[Leaf]:
    """The parameters as the leaves of the reference's ``init_params``
    tree, in its flattening order (dict keys sorted, unit positions in
    order)."""
    top = {"embed": params.embed, "final_norm": params.final_norm}
    if params.lm_head is not None:
        top["lm_head"] = params.lm_head
    stacks = {"units": (params.layers, cfg.pattern)}
    if params.enc_layers is not None:
        top["enc_norm"] = params.enc_norm
        stacks["enc_units"] = (params.enc_layers, (ENC_SPEC,))
    leaves = []
    for key in sorted(set(top) | set(stacks)):
        if key in top:
            leaves.append(Leaf((key,), [top[key]], False))
            continue
        layers, pattern = stacks[key]
        n = len(pattern)
        for i in range(n):
            for part in sorted(layers[i].keys()):
                for name in sorted(layers[i][part].keys()):
                    leaves.append(Leaf(
                        (key, i, part, name),
                        [layers[r * n + i][part][name]
                         for r in range(len(layers) // n)], True))
    return leaves
