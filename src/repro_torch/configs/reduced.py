"""Reduced (smoke-test) variants of every assigned architecture.

Same family, pattern and code paths; tiny dims so a forward/train step
runs on CPU in seconds.  The FULL configs are only ever exercised via the
dry-run (ShapeDtypeStruct, no allocation), per the brief.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.archs import ArchConfig, MoECfg, MambaCfg, REGISTRY


def reduced(cfg: ArchConfig) -> ArchConfig:
    moe = None
    if cfg.moe is not None:
        moe = MoECfg(n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff=64,
                     capacity_factor=2.0)
    return dataclasses.replace(
        cfg,
        n_layers=len(cfg.pattern) * min(cfg.repeat, 2),
        d_model=64,
        n_heads=4,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv < cfg.n_heads else 4,
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab=256,
        repeat=min(cfg.repeat, 2),
        moe=moe,
        mamba=MambaCfg(d_state=4, d_conv=4, expand=2) if cfg.mamba else None,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_seq=16 if cfg.enc_seq else 0,
        n_img_tokens=8 if cfg.n_img_tokens else 0,
        local_window=8,
    )


def get_reduced(name: str) -> ArchConfig:
    return reduced(REGISTRY[name])
