"""Assigned architecture pool: 10 architectures × their input shapes.

Every config below is the exact assignment from the brief (sources in
brackets there).  ``pattern`` is the repeating *unit* of layers the
forward pass scans over; ``repeat × len(pattern) == n_layers``.

Layer dicts:  {"mixer": ..., "ffn": ...}
  mixer ∈ attn | attn_local | attn_bidir | xattn | mamba | mlstm | slstm
  ffn   ∈ mlp | moe | none
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int                 # per-expert hidden
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    pattern: Tuple[dict, ...]
    repeat: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    local_window: int = 4096          # for attn_local
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    moe: Optional[MoECfg] = None
    mamba: Optional[MambaCfg] = None
    # encoder-decoder (audio): encoder pattern scanned separately
    enc_layers: int = 0
    enc_seq: int = 0                  # fixed source length (frames/patches)
    n_img_tokens: int = 0             # vlm: stubbed patch-embedding count
    tie_embeddings: bool = False
    optimizer: str = "adamw"          # adamw | adafactor (big archs)
    attn_shard: str = "head"          # 'head' (H%tp==0) | 'dh' (fallback)
    # long-context support: sub-quadratic decode path exists
    long_context: bool = False
    # how many pattern entries express ONE published layer (whisper's
    # decoder layer = self-attn + cross-attn+mlp => 2 sublayer groups)
    pattern_entries_per_layer: int = 1

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline terms)."""
        D, V = self.d_model, self.vocab
        total = V * D * (1 if self.tie_embeddings else 2)
        def layer_params(layer):
            p = 0
            m = layer["mixer"]
            if m in ("attn", "attn_local", "attn_bidir", "xattn"):
                p += D * self.n_heads * self.dh          # q
                p += 2 * D * self.n_kv * self.dh         # k, v
                p += self.n_heads * self.dh * D          # o
                if m == "xattn":
                    p += D * self.n_heads * self.dh      # extra gate proj
            elif m == "mamba":
                e = self.mamba.expand * D
                p += D * 2 * e + e * self.mamba.d_conv
                p += e * (2 * self.mamba.d_state + 2) + e * D
            elif m == "mlstm":
                e = 2 * D
                p += D * 3 * e                    # q, k, v
                p += 2 * D * self.n_heads         # per-head i/f gates
                p += D * e + e * D                # output gate + out_proj
            elif m == "slstm":
                p += 4 * D * D + 4 * D * D + D * D
            f = layer["ffn"]
            if f == "mlp":
                p += 3 * D * self.d_ff                    # gate/up/down
            elif f == "moe":
                p += D * self.moe.n_experts
                p += self.moe.n_experts * 3 * D * self.moe.d_ff
            return p
        per_unit = sum(layer_params(l) for l in self.pattern)
        total += per_unit * self.repeat
        if self.enc_layers:
            enc_unit = {"mixer": "attn_bidir", "ffn": "mlp"}
            total += layer_params(enc_unit) * self.enc_layers
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        dense = self.param_count()
        n_moe_layers = sum(1 for l in self.pattern if l["ffn"] == "moe") \
            * self.repeat
        all_experts = n_moe_layers * self.moe.n_experts * 3 * self.d_model \
            * self.moe.d_ff
        active = n_moe_layers * self.moe.top_k * 3 * self.d_model \
            * self.moe.d_ff
        return dense - all_experts + active


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "decode"),
}


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    return REGISTRY[name]


def _attn(ffn="mlp"):
    return {"mixer": "attn", "ffn": ffn}


# --- the ten assigned architectures -----------------------------------------

register(ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192, vocab=202_048,
    moe=MoECfg(n_experts=128, top_k=1, d_ff=8192),
    pattern=({"mixer": "attn", "ffn": "moe"},), repeat=48,
    optimizer="adafactor", attn_shard="dh",          # 40 heads % 16 != 0
))

register(ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, d_ff=1536, vocab=151_936,
    moe=MoECfg(n_experts=128, top_k=8, d_ff=1536),
    pattern=({"mixer": "attn", "ffn": "moe"},), repeat=94,
    optimizer="adafactor", attn_shard="head",
))

register(ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv=1, d_ff=24_576, vocab=49_152,
    pattern=(_attn(),), repeat=52, attn_shard="head",
))

register(ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27_392, vocab=152_064,
    qkv_bias=True, pattern=(_attn(),), repeat=64, attn_shard="dh",
))

register(ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv=4, d_ff=18_432, vocab=49_152,
    pattern=(_attn(),), repeat=32, attn_shard="dh",
))

register(ArchConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv=8, d_ff=14_336, vocab=256_000,
    head_dim=256, attn_softcap=50.0, final_softcap=30.0, local_window=4096,
    pattern=({"mixer": "attn_local", "ffn": "mlp"},
             {"mixer": "attn", "ffn": "mlp"}), repeat=21,
    attn_shard="head", tie_embeddings=True,
    long_context=True,   # local/global alternation; global layers windowed
))                       # over the cache in long mode (DESIGN.md §4)

register(ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=14_336, vocab=128_256,
    n_img_tokens=1024,
    pattern=(_attn(), _attn(), _attn(), _attn(),
             {"mixer": "xattn", "ffn": "mlp"}), repeat=8,
    attn_shard="head",
))

register(ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14_336, vocab=65_536,
    moe=MoECfg(n_experts=16, top_k=2, d_ff=14_336),
    mamba=MambaCfg(),
    pattern=(
        {"mixer": "mamba", "ffn": "mlp"},
        {"mixer": "mamba", "ffn": "moe"},
        {"mixer": "mamba", "ffn": "mlp"},
        {"mixer": "mamba", "ffn": "moe"},
        {"mixer": "attn", "ffn": "mlp"},
        {"mixer": "mamba", "ffn": "moe"},
        {"mixer": "mamba", "ffn": "mlp"},
        {"mixer": "mamba", "ffn": "moe"},
    ), repeat=4,
    optimizer="adafactor", attn_shard="head", long_context=True,
))

register(ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=0, vocab=50_304,
    pattern=({"mixer": "slstm", "ffn": "none"},
             {"mixer": "mlstm", "ffn": "none"},
             {"mixer": "mlstm", "ffn": "none"},
             {"mixer": "mlstm", "ffn": "none"}), repeat=3,
    attn_shard="dh", long_context=True, tie_embeddings=True,
))

register(ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv=20, d_ff=5120,
    vocab=51_872,        # padded from 51866 to a multiple of 32 for TP
    enc_layers=32, enc_seq=1500,
    pattern=({"mixer": "attn", "ffn": "none"},
             {"mixer": "xattn", "ffn": "mlp"}), repeat=32,
    attn_shard="dh", pattern_entries_per_layer=2,
))
# whisper decoder layer = self-attn + cross-attn + mlp; we express it as a
# 2-entry unit (self-attn, then cross-attn+mlp) so n_layers=32 decoder
# layers => repeat=32 units of 2 sublayer-groups.


def long_500k_supported(cfg: ArchConfig) -> bool:
    return cfg.long_context


def cells(include_skips: bool = False):
    """All (arch × shape) dry-run cells; long_500k only where sub-quadratic."""
    out = []
    for name, cfg in REGISTRY.items():
        for sname, shape in SHAPES.items():
            if sname == "long_500k" and not cfg.long_context:
                if include_skips:
                    out.append((name, sname, "SKIP: full attention is "
                                "quadratic at 512k; no sub-quadratic path "
                                "in the published config"))
                continue
            out.append((name, sname))
    return out
