"""The batched multi-graph execution path: N sessions, one launch
(counterpart of ``repro.serve.batch``).

A pool of same-shape sessions is one stacked tree of tensors: every
handle leaf gains a leading session axis, and ``torch.func.vmap`` runs
the engine's deletes-then-adds body (``Engine.update_stacked``) over it.
The per-tenant semantics are untouched, so the contract this module is
tested against is **bit-exactness**: a mega-call gives the same handle
bits as N solo ``apply``s.

* **the merge** — on ``cuda`` the body folds adds into the sorted diff
  pool through ``kernels.repair.merge_pool_sorted_op``, a custom op whose
  vmap rule launches ``merge_pool_sorted_batched`` once for the whole
  session axis: one kernel launch a group round, where N solo applies
  launch N.
* **the host branch** — a solo ``update_add`` asks the host whether the
  pool moved (and the ELL pack must be rebuilt), the reference's
  ``lax.cond``; that read does not vmap.  The body returns the flag
  instead, and the group's flags come back with its stacked
  ``(N, 3)`` pool counters in ONE host read.  Then the flagged members
  are repacked and the others' revivals patched
  (``Engine.finish_stacked``, mapped over those members at once).  A
  round costs one sync where N solo applies cost 2N (a counter read and
  the branch each).
* **no padding** — the reference pads a group up to the next power of
  two to bound its compile count (``next_pow2``); eager PyTorch compiles
  nothing, so the port stacks the real members only.

``"scan"`` runs the members' bodies one after another on one stream,
with no stacking (no session-axis memory), reads their counters and
flags in one sync, and finishes them one by one; its merge launches
once per member.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import numpy as np
import torch

BATCH_MODES = ("vmap", "scan", "off")


def _leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a handle or batch (nested frozen dataclasses
    of tensors and static ints), in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out: List[torch.Tensor] = []
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
            out += _leaves(v)
    return out


def _rebuild(template, leaves):
    """``template``'s structure and static fields with ``leaves`` (an
    iterator, consumed in ``_leaves`` order) as its tensors."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    kw = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
            kw[f.name] = _rebuild(v, leaves)
        else:
            kw[f.name] = v
    return type(template)(**kw)


def _structure(tree):
    """Everything but the tensors: types and static fields, nested."""
    if isinstance(tree, torch.Tensor):
        return "T"
    return (type(tree).__name__,) + tuple(
        (f.name, _structure(getattr(tree, f.name))
         if isinstance(getattr(tree, f.name), torch.Tensor)
         or dataclasses.is_dataclass(getattr(tree, f.name))
         else getattr(tree, f.name))
        for f in dataclasses.fields(tree))


def tree_stack(trees: List[Any]):
    """Stack same-structure trees along a new leading axis."""
    stacked = [torch.stack(xs) for xs in zip(*(_leaves(t) for t in trees))]
    return _rebuild(trees[0], iter(stacked))


def tree_index(tree: Any, i: int):
    """Slice one element back out of a stacked tree."""
    return _rebuild(tree, iter([x[i] for x in _leaves(tree)]))


def next_pow2(n: int) -> int:
    """The reference's bucket for a group of ``n`` (its compile count);
    kept for its API, the port does not pad."""
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def group_key(engine, handle, batch) -> Tuple:
    """What must match for sessions to share one mega-call: the engine
    instance (its program and its host-side state), the handle's
    structure and every leaf's shape and dtype (stackability), and the
    ΔG batch's lane width."""
    return (id(engine), _structure(handle),
            tuple((tuple(x.shape), str(x.dtype)) for x in _leaves(handle)),
            batch.size)


class MegaBatcher:
    """Runs a group's ΔG batches as one mega-call.

    ``mode="vmap"`` maps the engine's body over a stacked session axis
    (one batched merge launch); ``"scan"`` runs the members one after
    another with no stacking (the reference's memory-saving fallback);
    ``"off"`` is handled by the pool (never calls here)."""

    def __init__(self, mode: str = "vmap"):
        if mode not in BATCH_MODES:
            raise ValueError(f"batch_mode must be one of {BATCH_MODES}, "
                             f"got {mode!r}")
        self.mode = mode

    def run(self, engine, handles: List[Any], batches: List[Any]
            ) -> Tuple[List[Any], np.ndarray]:
        """Apply ``batches[i]`` to ``handles[i]`` for all i.  Returns the
        new handles and the host-side ``(len(handles), 3)`` pool-counter
        array, read with the repack flags in one sync."""
        if self.mode == "vmap":
            sb = tree_stack(batches)
            staged, counters, repack = _vmap(
                engine.update_stacked, tree_stack(handles), sb)
        else:
            rows = [engine.update_stacked(h, b, mapped=False)
                    for h, b in zip(handles, batches)]
            counters = torch.stack([r[1] for r in rows])
            repack = torch.stack([r[2] for r in rows])
        k = len(handles)
        host = torch.cat([counters.reshape(-1).to(torch.int64),
                          repack.reshape(-1).to(torch.int64)]).cpu().numpy()
        flags = host[3 * k:]
        patch = [i for i in range(k) if not flags[i]]
        if self.mode == "vmap":
            members = [tree_index(staged, i) for i in range(k)]
            if patch:
                # the unflagged members' revivals, patched at once
                sub = ((staged, sb) if len(patch) == k else
                       (tree_stack([members[i] for i in patch]),
                        tree_stack([batches[i] for i in patch])))
                done, = _vmap(lambda st, b: (
                    engine.finish_stacked(st, b, False),), *sub)
                for j, i in enumerate(patch):
                    members[i] = tree_index(done, j)
        else:
            members = [r[0] for r in rows]
            for i in patch:
                members[i] = engine.finish_stacked(members[i], batches[i],
                                                   False)
        new = [engine.finish_stacked(m, b, True) if flags[i] else m
               for i, (m, b) in enumerate(zip(members, batches))]
        return new, host[:3 * k].reshape(k, 3)


def _vmap(fn, *stacked):
    """``torch.func.vmap`` of ``fn`` (trees in, a tuple of trees out)
    over the leading axis of the ``stacked`` trees: vmap maps tensors,
    so the trees cross it as their leaves."""
    outs = []   # the output trees, for their structure

    def flat(*leaves):
        out = fn(*(_rebuild(t, iter(x)) for t, x in zip(stacked, leaves)))
        outs.append(out)
        return tuple(tuple(_leaves(x)) for x in out)

    res = torch.func.vmap(flat)(*(tuple(_leaves(t)) for t in stacked))
    return tuple(_rebuild(t, iter(x)) for t, x in zip(outs[0], res))
