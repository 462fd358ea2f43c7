"""Model facade (counterpart of ``repro/models/model.py``) for serving:
``init``, ``prefill_step`` and ``serve_step`` of any registered arch's
language model on one device: attention, recurrent (Mamba, mLSTM,
sLSTM) or hybrid mixers, MLP or MoE ffns, with an encoder or
cross-attention to a source (``src``: image-token or audio-frame
embeddings, (B, T, D)) where the arch has them.

The reference's step functions take the params pytree; here ``Model`` is
an ``nn.Module`` that holds them (``init`` draws them from an explicit
``torch.Generator``, ``params_from_jax`` loads the reference's).  On one
card the reference's sharding ``Policy`` is the identity and its
``Tuning`` knobs steer only SPMD layouts, so neither is ported.

Backends, as in the graph port: ``"cuda"`` (the default) runs prefill
attention through the hand-written flash kernel; ``"torch"`` computes the
reference's chunked attention in plain PyTorch.  Entry points run on the
card unless ``device="cpu"`` is passed, and raise where there is none.
Training (``train_step``, the loss, the optimizers) waits for ROADMAP
Queue 1 item 14a.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.archs import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tensors import resolve_device

F32 = torch.float32


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16, device=None,
                 backend: str = "cuda"):
        super().__init__()
        if backend not in L.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of "
                             f"{L.BACKENDS}")
        for spec in cfg.pattern:
            T.check_spec(spec)
        self.cfg, self.dtype, self.backend = cfg, dtype, backend
        self.device = resolve_device(device)
        self.params = None

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> T.Params:
        """Random weights from ``generator`` (one on the model's device)."""
        self.params = T.init_params(self.cfg, self.dtype, self.device,
                                    generator)
        return self.params

    # ------------------------------------------------------------ embeddings
    def _embed(self, tokens):
        return self.params.embed[tokens].to(self.dtype)

    def _head(self):
        if self.cfg.tie_embeddings:
            return self.params.embed.T
        return self.params.lm_head

    def _logits(self, h):
        logits = (h @ self._head()).to(F32)
        return L.softcap(logits, self.cfg.final_softcap)

    def _src(self, src):
        return None if src is None else src.to(self.device).to(self.dtype)

    # ---------------------------------------------------------- prefill step
    @torch.no_grad()
    def prefill_step(self, tokens, src=None):
        """tokens: (B, P) int; src: (B, T, D) source embeddings, read by a
        vlm or audio arch (the encoder's input where it has one) ->
        (last-position logits (B, V) float32, the cache: one {"k", "v"} of
        (B, kv, P, dh) per attention layer, the zero state per recurrent
        one, as the reference's prefill leaves it, {} per cross-attention
        one)."""
        cfg = self.cfg
        x = self._embed(tokens.to(self.device))
        src = self._src(src) if cfg.family in ("vlm", "audio") else None
        if cfg.enc_layers:
            if src is None:
                raise ValueError(f"{cfg.name}'s encoder needs src")
            src = T.encoder_pass(cfg, self.params, src, self.backend)
        h, caches = T.backbone_full(cfg, self.params, x, self.backend,
                                    collect_cache=True, src=src)
        return self._logits(h[:, -1:, :])[:, 0], caches

    # ------------------------------------------------------------ serve step
    @torch.no_grad()
    def serve_step(self, cache, token, pos: int, src=None,
                   long_mode: bool = False):
        """token: (B, 1) int; pos: the write index.  The cache is updated
        in place and returned.  The xattn layers attend to ``src`` as it
        is given, not to the encoder's output: the reference's
        ``serve_step`` does the same.  ``long_mode`` windows the global
        layers of an arch with an attention softcap too."""
        x = self._embed(token.to(self.device))
        h, cache = T.backbone_decode(self.cfg, self.params, x, cache, pos,
                                     self._src(src), long_mode)
        return self._logits(h)[:, 0], cache


def params_from_jax(cfg: ArchConfig, tree, dtype=None, device=None,
                    backend: str = "cuda") -> Model:
    """A ``Model`` holding the reference's ``init_params`` pytree ``tree``
    (numpy leaves; each unit position's leaves stacked over the repeat
    axis, as ``T.init_params`` stacks them).  ``dtype`` defaults to the
    embedding's; bf16 leaves (ml_dtypes) pass through float32 exactly.
    Each leaf takes the dtype of the port's parameter, so Mamba's
    ``A_log`` and the MoE's ``router`` stay float32 in a bf16 model, as
    in the reference's tree."""
    host = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    if dtype is None:
        dtype = torch.bfloat16 if np.asarray(tree["embed"]).dtype.name == \
            "bfloat16" else torch.float32
    model = Model(cfg, dtype=dtype, device=device, backend=backend)
    params = T.init_params(cfg, dtype, model.device, generator=None)

    def put(param, arr, what):
        src = host(arr)
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{what}: shape {tuple(src.shape)}, expected "
                             f"{tuple(param.shape)}")
        param.copy_(src.to(param.dtype))

    want = {"embed", "final_norm", "units"} | (
        set() if cfg.tie_embeddings else {"lm_head"}) | (
        {"enc_units", "enc_norm"} if cfg.enc_layers else set())
    if set(tree) != want:
        raise KeyError(f"params tree has {sorted(tree)}, expected "
                       f"{sorted(want)}")
    with torch.no_grad():
        put(params.embed, tree["embed"], "embed")
        put(params.final_norm, tree["final_norm"], "final_norm")
        if not cfg.tie_embeddings:
            put(params.lm_head, tree["lm_head"], "lm_head")
        stacks = [("units", params.layers, cfg.repeat)]
        if cfg.enc_layers:
            put(params.enc_norm, tree["enc_norm"], "enc_norm")
            stacks.append(("enc_units", params.enc_layers, cfg.enc_layers))
        for key, layers, repeat in stacks:
            units = tree[key]
            n = len(units)
            for r in range(repeat):
                for i in range(n):
                    layer = layers[r * n + i]
                    for part, leaves in units[i].items():
                        if set(leaves) != set(layer[part].keys()):
                            raise KeyError(f"{key}[{i}][{part!r}] has "
                                           f"{sorted(leaves)}, expected "
                                           f"{sorted(layer[part].keys())}")
                        for name, arr in leaves.items():
                            put(layer[part][name], np.asarray(arr)[r],
                                f"{key}[{i}][{part!r}][{name!r}][{r}]")
    model.params = params
    return model
