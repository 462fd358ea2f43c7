"""Model facade (counterpart of ``repro/models/model.py``) for serving:
``init``, ``prefill_step`` and ``serve_step`` of any registered arch's
language model on one device: attention, recurrent (Mamba, mLSTM,
sLSTM) or hybrid mixers, MLP or MoE ffns, with an encoder or
cross-attention to a source (``src``: image-token or audio-frame
embeddings, (B, T, D)) where the arch has them.

The reference's step functions take the params pytree; here ``Model`` is
an ``nn.Module`` that holds them (``init`` draws them from an explicit
``torch.Generator``, ``params_from_jax`` loads the reference's).  On one
card the reference's sharding ``Policy`` is the identity, so it is not
ported.  ``tuning`` (``models/tuning.py``, default ``OPTIMIZED``) is bound
by each step function as the reference binds it: on one card it chooses
the MoE dispatch and the windowed cache read.

Backends, as in the graph port: ``"cuda"`` (the default) runs prefill
attention through the hand-written flash kernel; ``"torch"`` computes the
reference's chunked attention in plain PyTorch.  Entry points run on the
card unless ``device="cpu"`` is passed, and raise where there is none.

Training: ``init_opt()`` and ``train_step(opt_state, step, batch) ->
(opt_state, {"loss", "grad_norm"})``, the reference's step: the embedded
tokens (and the encoder over ``batch["src"]`` where the arch has one)
through the backbone with each unit rematerialised, the chunked
cross-entropy ``_ce_loss``, the gradient by autograd (on ``cuda`` the
flash kernel's backward is the hand-written one), then the arch's
optimizer (``optim/opt.py``) with global-norm clipping.  The step
updates the Model's parameters in place (the PyTorch idiom; the
reference returns new params).  ``params_to_jax`` / ``opt_state_to_jax``
give the reference's trees (each unit position's leaves stacked over the
repeat axis) and ``load_params`` / ``opt_state_from_jax`` take them back,
so a checkpoint of either package resumes in the port.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.archs import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.tuning import OPTIMIZED, Tuning, use_tuning
from repro_torch.optim.opt import make_optimizer
from repro_torch.tensors import resolve_device

F32 = torch.float32
CE_CHUNK = 512


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype=torch.bfloat16, device=None,
                 backend: str = "cuda", lr=None, tuning: Tuning = OPTIMIZED):
        super().__init__()
        if backend not in L.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of "
                             f"{L.BACKENDS}")
        for spec in cfg.pattern:
            T.check_spec(spec)
        self.cfg, self.dtype, self.backend = cfg, dtype, backend
        self.tuning = tuning
        self.device = resolve_device(device)
        self.params = None
        self.optimizer = make_optimizer(cfg.optimizer, lr)

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

    # ------------------------------------------------------------ training
    def leaves(self) -> list:
        """The parameters as the reference's tree's leaves (``T.Leaf``)."""
        return T.leaf_groups(self.cfg, self.params)

    def init_opt(self):
        return self.optimizer.init(self.leaves())

    def _aux(self, batch):
        if self.cfg.family in ("vlm", "audio") and "src" in batch:
            return self._src(_tensor(batch["src"]))
        return None

    def _ce_chunk(self, h, labels):
        logits = self._logits(h)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.sum(lse - gold)

    def _ce_loss(self, h, labels):
        """Chunked cross-entropy over the sequence: chunks of ``CE_CHUNK``
        positions, each under a checkpoint, so that the backward holds one
        chunk's (B, chunk, V) float32 logits at a time."""
        B, S, D = h.shape
        n_chunk = max(S // CE_CHUNK, 1)
        csz = S // n_chunk
        if n_chunk * csz != S:
            raise ValueError(f"a sequence of {S} positions does not split "
                             f"into {n_chunk} chunks of {csz}")
        labels = labels.long()
        tot = torch.zeros((), dtype=F32, device=h.device)
        for c in range(0, S, csz):
            tot = tot + checkpoint(self._ce_chunk, h[:, c:c + csz],
                                   labels[:, c:c + csz], use_reentrant=False)
        return tot / (B * S)

    def loss(self, batch):
        """The mean cross-entropy of ``batch`` ("tokens", "labels": (B, S)
        ints; "src" where the arch reads one), through the rematerialised
        backbone."""
        with use_tuning(self.tuning):
            return self._loss(batch)

    def _loss(self, batch):
        cfg = self.cfg
        x = self._embed(_tensor(batch["tokens"]).to(self.device))
        src = self._aux(batch)
        if cfg.enc_layers:
            if src is None:
                raise ValueError(f"{cfg.name}'s encoder needs batch['src']")
            src = T.encoder_pass(cfg, self.params, src, self.backend,
                                 use_remat=True)
        h, _ = T.backbone_full(cfg, self.params, x, self.backend,
                               collect_cache=False, src=src, use_remat=True)
        return self._ce_loss(h, _tensor(batch["labels"]).to(self.device))

    def loss_and_grad(self, batch) -> torch.Tensor:
        """The loss, with every parameter's ``.grad`` set to its gradient."""
        for p in self.parameters():
            p.grad = None
        with torch.enable_grad(), use_tuning(self.tuning):
            loss = self._loss(batch)
            loss.backward()       # the remat recompute runs under it too
        return loss.detach()

    def train_step(self, opt_state, step: int, batch):
        """One optimizer step on ``batch``: the parameters are updated in
        place; returns (opt_state, {"loss", "grad_norm"})."""
        loss = self.loss_and_grad(batch)
        opt_state, gnorm = self.optimizer.update(self.leaves(), opt_state,
                                                 step)
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    # ---------------------------------------------------------- prefill step
    @torch.no_grad()
    def prefill_step(self, tokens, src=None):
        """tokens: (B, P) int; src: (B, T, D) source embeddings, read by a
        vlm or audio arch (the encoder's input where it has one) ->
        (last-position logits (B, V) float32, the cache: one {"k", "v"} of
        (B, kv, P, dh) per attention layer, the zero state per recurrent
        one, as the reference's prefill leaves it, {} per cross-attention
        one)."""
        with use_tuning(self.tuning):
            return self._prefill_step(tokens, src)

    def _prefill_step(self, tokens, src):
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
        with use_tuning(self.tuning):
            h, cache = T.backbone_decode(self.cfg, self.params, x, cache,
                                         pos, self._src(src), long_mode)
        return self._logits(h)[:, 0], cache


def _tensor(a) -> torch.Tensor:
    """A batch entry or a tree leaf as a tensor (numpy arrays wrapped)."""
    return a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))


def _host(a) -> torch.Tensor:
    """A leaf in float32 on the host: a tensor, or a numpy array (bf16
    leaves of ml_dtypes pass through float32 exactly)."""
    if torch.is_tensor(a):
        return a.detach().to("cpu", F32)
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(cfg: ArchConfig, tree, dtype=None, device=None,
                    backend: str = "cuda") -> Model:
    """A ``Model`` holding the reference's ``init_params`` pytree ``tree``
    (numpy or tensor leaves; each unit position's leaves stacked over the
    repeat axis, as ``T.init_params`` stacks them).  ``dtype`` defaults to
    the embedding's; bf16 leaves pass through float32 exactly.  Each leaf
    takes the dtype of the port's parameter, so Mamba's ``A_log`` and the
    MoE's ``router`` stay float32 in a bf16 model, as in the reference's
    tree."""
    if dtype is None:
        emb = tree["embed"]
        name = str(emb.dtype) if torch.is_tensor(emb) else \
            np.asarray(emb).dtype.name
        dtype = torch.bfloat16 if "bfloat16" in name else torch.float32
    model = Model(cfg, dtype=dtype, device=device, backend=backend)
    model.params = T.init_params(cfg, dtype, model.device, generator=None)
    load_params(model, tree)
    return model


def load_params(model: Model, tree) -> None:
    """Copy the reference's params tree ``tree`` into ``model``'s
    parameters in place (shapes and keys checked)."""
    cfg, params = model.cfg, model.params

    def put(param, arr, what):
        src = _host(arr)
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
                            put(layer[part][name], arr[r],
                                f"{key}[{i}][{part!r}][{name!r}][{r}]")


def _tree(leaves, values) -> dict:
    """The reference's tree with one value per leaf of ``leaves``."""
    tree = {}
    for leaf, val in zip(leaves, values):
        if not leaf.stacked:
            tree[leaf.path[0]] = val
            continue
        key, i, part, name = leaf.path
        tree.setdefault(key, {}).setdefault(i, {}).setdefault(
            part, {})[name] = val
    for key in ("units", "enc_units"):
        if key in tree:
            tree[key] = tuple(tree[key][i] for i in sorted(tree[key]))
    return tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _stacked(leaf, per_layer) -> torch.Tensor:
    """One leaf's per-layer host tensors as the reference holds it."""
    ts = [t.detach().cpu() for t in per_layer]
    return torch.stack(ts) if leaf.stacked else ts[0]


def _split(leaf, arr, device) -> list:
    """A leaf of the reference's tree as float32 per-layer tensors."""
    t = _host(arr).to(device)
    return list(t.unbind(0)) if leaf.stacked else [t]


def params_to_jax(model: Model) -> dict:
    """The reference's params tree of ``model``: host tensors in the
    parameters' dtypes, each unit position's stacked over the repeat
    axis (``.numpy()`` of a float32 leaf gives what the reference
    takes)."""
    leaves = model.leaves()
    return _tree(leaves, [_stacked(leaf, leaf.tensors) for leaf in leaves])


def opt_state_to_jax(model: Model, state) -> dict:
    """The reference's optimizer state tree of ``state`` (float32 host
    tensors): AdamW's {"m": tree, "v": tree}, Adafactor's tree of
    {"r", "c"} or {"v"} per leaf."""
    leaves = model.leaves()
    if model.cfg.optimizer == "adamw":
        return {k: _tree(leaves, [_stacked(leaf, ts) for leaf, ts in
                                  zip(leaves, state[k])])
                for k in ("m", "v")}
    return _tree(leaves, [{k: _stacked(leaf, [s[k] for s in ss])
                           for k in ss[0]}
                          for leaf, ss in zip(leaves, state)])


def opt_state_from_jax(model: Model, tree):
    """The port's optimizer state from the reference's tree (AdamW's
    stacked ``m`` / ``v``, Adafactor's ``r`` / ``c`` / ``v``, numpy or
    tensor leaves), split per layer onto the model's device."""
    leaves, dev = model.leaves(), model.device
    if model.cfg.optimizer == "adamw":
        return {k: [_split(leaf, _at(tree[k], leaf.path), dev)
                    for leaf in leaves] for k in ("m", "v")}
    state = []
    for leaf in leaves:
        node = _at(tree, leaf.path)
        parts = {k: _split(leaf, node[k], dev) for k in sorted(node)}
        state.append([{k: parts[k][r] for k in parts}
                      for r in range(len(leaf.tensors))])
    return state
