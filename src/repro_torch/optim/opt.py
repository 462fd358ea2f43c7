"""Optimizers (counterpart of ``repro/optim/opt.py``): AdamW and
Adafactor, with global-norm clipping.

The reference maps its params pytree, each unit position's leaves stacked
over the repeat axis (R, ...); the port holds one tensor a layer.  So the
optimizers here take the parameters as *leaves*: one per leaf of the
reference's tree, in its order (``models/transformer.leaf_groups``), each
with ``tensors`` (the port's parameters the reference stacks into it, or
the one tensor of an unstacked leaf) and ``stacked``.  AdamW is
elementwise, so a leaf is only bookkeeping.  Adafactor factors its second
moment over the trailing two dimensions, per layer in both packages, and
decides whether to factor by the stacked leaf's shape, as the reference
does; its update clip takes the RMS over the whole stacked leaf, so here
over all of a leaf's tensors.

``update(leaves, state, step)`` reads each parameter's ``.grad`` (None
counts as zeros), writes the parameter in place (the reference returns
new params; an in-place update keeps one copy of the weights) and clears
``.grad``.  It returns the new state and the gradient's global norm
before clipping.  The arithmetic is the reference's: the update in
float32, cast back to the parameter's dtype (a bf16 parameter is rounded
to bf16 each step, as there); the step count and the bias corrections in
float32 (``torch.pow`` of float32 tensors, where Python floats would
round otherwise).  ``state_specs`` belongs to sharding (ROADMAP item
14f) and is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

F32 = torch.float32


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tensors))


def clip_by_global_norm(tensors, max_norm):
    """(tensors scaled to a global norm of at most ``max_norm``, in their
    dtypes; the norm before)."""
    g = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return [(x.to(F32) * scale).to(x.dtype) for x in tensors], g


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable      # leaves -> state
    update: Callable    # (leaves, state, step) -> (state, grad norm)


def _grads(leaves) -> list:
    """Each leaf's gradients (zeros where a parameter has none)."""
    return [[torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaf.tensors] for leaf in leaves]


def _clipped(leaves, max_grad_norm):
    grads = _grads(leaves)
    flat, gnorm = clip_by_global_norm([g for gs in grads for g in gs],
                                      max_grad_norm)
    out, at = [], 0
    for gs in grads:
        out.append(flat[at:at + len(gs)])
        at += len(gs)
    for leaf in leaves:
        for p in leaf.tensors:
            p.grad = None
    return out, gnorm


def _step_f32(step, device) -> torch.Tensor:
    """``step.astype(float32) + 1.0``, on the parameters' device."""
    return torch.tensor(int(step), dtype=F32, device=device) + 1.0


def adamw(lr: float = 3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
          max_grad_norm=1.0) -> Optimizer:
    def init(leaves):
        z = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"m": [[z(p) for p in leaf.tensors] for leaf in leaves],
                "v": [[z(p) for p in leaf.tensors] for leaf in leaves]}

    @torch.no_grad()
    def update(leaves, state, step):
        grads, gnorm = _clipped(leaves, max_grad_norm)
        t = _step_f32(step, leaves[0].tensors[0].device)
        c1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
        c2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
        new_m, new_v = [], []
        for leaf, gs, ms, vs in zip(leaves, grads, state["m"], state["v"]):
            new_m.append([])
            new_v.append([])
            for p, g, m, v in zip(leaf.tensors, gs, ms, vs):
                g = g.to(F32)
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                u = (m / c1) / (torch.sqrt(v / c2) + eps) + wd * p.to(F32)
                p.copy_((p.to(F32) - lr * u).to(p.dtype))
                new_m[-1].append(m)
                new_v[-1].append(v)
        return {"m": new_m, "v": new_v}, gnorm

    return Optimizer(init, update)


def adafactor(lr: float = 1e-3, eps=1e-30, clip_thresh=1.0, wd=0.0,
              max_grad_norm=1.0, min_dim_factored=128) -> Optimizer:
    """Factored second moment over the trailing two dims (>= 2-D leaves)."""

    def factored(leaf) -> bool:
        p = leaf.tensors[0]
        shape = ((len(leaf.tensors),) if leaf.stacked else ()) + \
            tuple(p.shape)
        f = len(shape) >= 2 and shape[-1] >= min_dim_factored \
            and shape[-2] >= min_dim_factored
        if f and p.dim() < 2:
            raise NotImplementedError(
                f"the stacked leaf {shape} factors across the repeat axis, "
                f"which per-layer tensors cannot hold")
        return f

    def init(leaves):
        def st(p, f):
            if f:
                return {"r": torch.zeros(p.shape[:-1], dtype=F32,
                                         device=p.device),
                        "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                         dtype=F32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}
        return [[st(p, factored(leaf)) for p in leaf.tensors]
                for leaf in leaves]

    @torch.no_grad()
    def update(leaves, state, step):
        grads, gnorm = _clipped(leaves, max_grad_norm)
        t = _step_f32(step, leaves[0].tensors[0].device)
        beta = 1.0 - torch.pow(t, -0.8)
        new_state = []
        for leaf, gs, ss in zip(leaves, grads, state):
            us, ns = [], []
            for g, s in zip(gs, ss):
                g = g.to(F32)
                g2 = g * g + eps
                if "r" in s:
                    r = beta * s["r"] + (1 - beta) * torch.mean(g2, dim=-1)
                    c = beta * s["c"] + (1 - beta) * torch.mean(g2, dim=-2)
                    denom = torch.sqrt(
                        r[..., None] / torch.mean(r, dim=-1,
                                                  keepdim=True)[..., None]
                        * c[..., None, :])
                    us.append(g / torch.clamp(denom, min=1e-30))
                    ns.append({"r": r, "c": c})
                else:
                    v = beta * s["v"] + (1 - beta) * g2
                    us.append(g / torch.sqrt(v))
                    ns.append({"v": v})
            # the RMS over the reference's whole (stacked) leaf
            n = sum(u.numel() for u in us)
            rms = torch.sqrt(sum(torch.sum(u * u) for u in us) / n)
            div = torch.clamp(rms / clip_thresh, min=1.0)
            for p, u in zip(leaf.tensors, us):
                newp = p.to(F32) - lr * (u / div + wd * p.to(F32))
                p.copy_(newp.to(p.dtype))
            new_state.append(ns)
        return new_state, gnorm

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float | None = None) -> Optimizer:
    if name == "adamw":
        return adamw(lr or 3e-4)
    if name == "adafactor":
        return adafactor(lr or 1e-3)
    raise ValueError(name)
