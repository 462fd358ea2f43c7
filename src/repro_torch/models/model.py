"""Model facade (counterpart of ``repro/models/model.py``) for serving:
``init``, ``prefill_step`` and ``serve_step`` of an attention + MLP
language model on one device.

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

    # ---------------------------------------------------------- prefill step
    @torch.no_grad()
    def prefill_step(self, tokens):
        """tokens: (B, P) int -> (last-position logits (B, V) float32, the
        cache: one {"k", "v"} of (B, kv, P, dh) per layer)."""
        x = self._embed(tokens.to(self.device))
        h, caches = T.backbone_full(self.cfg, self.params, x, self.backend,
                                    collect_cache=True)
        return self._logits(h[:, -1:, :])[:, 0], caches

    # ------------------------------------------------------------ serve step
    @torch.no_grad()
    def serve_step(self, cache, token, pos: int):
        """token: (B, 1) int; pos: the write index.  The cache is updated
        in place and returned."""
        x = self._embed(token.to(self.device))
        h, cache = T.backbone_decode(self.cfg, self.params, x, cache, pos)
        return self._logits(h)[:, 0], cache


def params_from_jax(cfg: ArchConfig, tree, dtype=None, device=None,
                    backend: str = "cuda") -> Model:
    """A ``Model`` holding the reference's ``init_params`` pytree ``tree``
    (numpy leaves; each unit position's leaves stacked over the repeat
    axis, as ``T.init_params`` stacks them).  ``dtype`` defaults to the
    embedding's; bf16 leaves (ml_dtypes) pass through float32 exactly."""
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
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(tree) != want:
        raise KeyError(f"params tree has {sorted(tree)}, expected "
                       f"{sorted(want)}")
    with torch.no_grad():
        put(params.embed, tree["embed"], "embed")
        put(params.final_norm, tree["final_norm"], "final_norm")
        if not cfg.tie_embeddings:
            put(params.lm_head, tree["lm_head"], "lm_head")
        units = tree["units"]
        n = len(cfg.pattern)
        for r in range(cfg.repeat):
            for i in range(n):
                layer = params.layers[r * n + i]
                for part, leaves in units[i].items():
                    if set(leaves) != set(layer[part].keys()):
                        raise KeyError(f"units[{i}][{part!r}] has "
                                       f"{sorted(leaves)}, expected "
                                       f"{sorted(layer[part].keys())}")
                    for name, arr in leaves.items():
                        put(layer[part][name], np.asarray(arr)[r],
                            f"units[{i}][{part!r}][{name!r}][{r}]")
    model.params = params
    return model
