"""Backbone assembly (counterpart of ``repro/models/transformer.py``) for
attention + MLP models: init, the full-sequence pass (prefill) and the
one-token pass (decode) over a KV cache.

The reference stacks each pattern position's weights over the repeat
axis and ``lax.scan``s the unit; here the layers are an ``nn.ModuleList``
run by a Python loop, unit r's pattern position i at index
``r * len(pattern) + i``.  Each layer is an ``nn.ModuleDict`` with a
``"mixer"`` and (unless the ffn is ``"none"``) an ``"ffn"``
``ParameterDict``.

Cache (decode): a list with one ``{"k", "v"}`` entry per layer, each
(B, kv, S, dh).

The slice ports mixer ``attn`` and ffn ``mlp``; every other mixer or ffn
raises ``NotImplementedError`` naming the ROADMAP item it waits for.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from repro_torch.configs.archs import ArchConfig
from repro_torch.models import layers as L

WAITING = {
    "attn_local": "windowed attention (ROADMAP Queue 1 item 14b)",
    "moe": "mixture-of-experts layers (ROADMAP Queue 1 item 14c)",
    "mamba": "the SSM mixers (ROADMAP Queue 1 item 14d)",
    "mlstm": "the SSM mixers (ROADMAP Queue 1 item 14d)",
    "slstm": "the SSM mixers (ROADMAP Queue 1 item 14d)",
    "attn_bidir": "encoders and cross-attention (ROADMAP Queue 1 item 14e)",
    "xattn": "encoders and cross-attention (ROADMAP Queue 1 item 14e)",
}


def check_spec(spec: dict) -> None:
    """Raise unless the layer's mixer and ffn are ported."""
    for part, ok in (("mixer", ("attn",)), ("ffn", ("mlp", "none"))):
        kind = spec[part]
        if kind not in ok:
            if kind in WAITING:
                raise NotImplementedError(
                    f"{part} {kind!r} is not ported yet: it waits for "
                    f"{WAITING[kind]}")
            raise ValueError(kind)


def layer_specs(cfg: ArchConfig) -> tuple:
    return tuple(cfg.pattern) * cfg.repeat


class Params(nn.Module):
    """The reference's params pytree as a module: ``embed``,
    ``final_norm``, ``lm_head`` (unless tied) and ``layers``."""

    def __init__(self, embed, final_norm, layers, lm_head=None):
        super().__init__()
        self.embed = embed
        self.final_norm = final_norm
        self.layers = layers
        self.lm_head = lm_head


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(spec: dict, cfg: ArchConfig, dtype, device,
               generator) -> nn.ModuleDict:
    check_spec(spec)
    p = nn.ModuleDict({"mixer": L.init_attn(cfg, dtype, device, generator)})
    if spec["ffn"] == "mlp":
        p["ffn"] = L.init_mlp(cfg, dtype, device, generator)
    return p


def init_unit(pattern, cfg: ArchConfig, dtype, device, generator) -> list:
    return [init_layer(spec, cfg, dtype, device, generator)
            for spec in pattern]


def init_params(cfg: ArchConfig, dtype=torch.bfloat16, device=None,
                generator=None) -> Params:
    """Weights drawn from ``generator`` (None: uninitialised, to load)."""
    if cfg.enc_layers:
        raise NotImplementedError(
            f"the encoder of {cfg.name} is not ported yet: it waits for "
            f"{WAITING['attn_bidir']}")
    D, V = cfg.d_model, cfg.vocab
    embed = L._init((V, D), generator, device, scale=0.02, dtype=dtype)
    layers = nn.ModuleList(
        layer for _ in range(cfg.repeat)
        for layer in init_unit(cfg.pattern, cfg, dtype, device, generator))
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = L._init((D, V), generator, device, scale=0.02, dtype=dtype)
    return Params(embed, L._zeros((D,), dtype, device), layers, lm_head)


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _ffn(p, spec, x):
    if spec["ffn"] == "mlp":
        pf = p["ffn"]
        x = x + L.mlp(pf, L.rms_norm(x, pf["ln"]))
    return x


def apply_layer_full(p, spec, x, cfg: ArchConfig, positions, backend: str,
                     collect_cache: bool):
    """Returns (x, cache_entry)."""
    pm = p["mixer"]
    att, k, v = L.attention_full(pm, L.rms_norm(x, pm["ln"]), cfg, positions,
                                 True, backend)
    cache = {}
    if collect_cache:
        cache = {"k": k.transpose(1, 2).contiguous(),
                 "v": v.transpose(1, 2).contiguous()}
    if "post_ln" in pm:
        att = L.rms_norm(att, pm["post_ln"])
    return _ffn(p, spec, x + att), cache


def apply_layer_decode(p, spec, x, cfg: ArchConfig, cache, pos: int):
    pm = p["mixer"]
    h = L.rms_norm(x, pm["ln"])
    att, ck, cv = L.attention_decode(pm, h, cfg, cache["k"], cache["v"],
                                     pos)
    if "post_ln" in pm:
        att = L.rms_norm(att, pm["post_ln"])
    return _ffn(p, spec, x + att), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def init_cache_entry(spec, cfg: ArchConfig, B, S, dtype, device):
    check_spec(spec)
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

def backbone_full(cfg: ArchConfig, params: Params, x, backend: str,
                  collect_cache: bool):
    """Full-sequence pass (prefill). x: (B,S,D) embedded."""
    positions = torch.arange(x.shape[1], device=x.device)
    caches = []
    for p, spec in zip(params.layers, layer_specs(cfg)):
        x, c = apply_layer_full(p, spec, x, cfg, positions, backend,
                                collect_cache)
        caches.append(c)
    return L.rms_norm(x, params.final_norm), caches


def backbone_decode(cfg: ArchConfig, params: Params, x, cache, pos: int):
    """Single-token pass. x: (B,1,D); one cache entry per layer."""
    new_cache = []
    for p, spec, c in zip(params.layers, layer_specs(cfg), cache):
        x, nc = apply_layer_decode(p, spec, x, cfg, c, pos)
        new_cache.append(nc)
    return L.rms_norm(x, params.final_norm), new_cache
