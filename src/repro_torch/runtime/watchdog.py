"""Divergence watchdog: cheap on-device NaN/Inf probe over property state
(counterpart of ``repro.runtime.watchdog``).

A poisoned float property (one NaN relaxation) silently infects every
subsequent batch; by the time a caller reads results, the provenance is
gone.  The watchdog reduces each *floating-point* property tensor to a
single any-non-finite device scalar (integer lanes — dist, parent,
modified masks — are skipped: they cannot hold NaN) and syncs one bool
per probed tensor.  Sessions call it after each ``run_stream`` and on
demand via ``session.check_divergence()``; a hit raises
:class:`DivergenceError` naming the offending properties.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

from repro_torch.runtime.errors import DivergenceError


def _is_inexact(arr) -> bool:
    dtype = getattr(arr, "dtype", None)
    return isinstance(dtype, torch.dtype) and (dtype.is_floating_point
                                               or dtype.is_complex)


def probe(named_arrays: Iterable[Tuple[str, object]]) -> List[str]:
    """Return the names of tensors containing NaN/Inf.  One reduction
    per floating-point tensor, one scalar readback each; integer tensors
    are skipped entirely (zero device work)."""
    bad: List[str] = []
    flags: Dict[str, object] = {}
    for name, arr in named_arrays:
        if _is_inexact(arr):
            # stage all reductions before any sync
            flags[name] = (~torch.isfinite(arr)).any()
    for name, flag in flags.items():
        if bool(flag):
            bad.append(name)
    return bad


def check(named_arrays: Iterable[Tuple[str, object]], *,
          where: str = "stream segment", health=None) -> None:
    """Probe and raise :class:`DivergenceError` on a hit."""
    if health is not None:
        health.divergence_probes += 1
    bad = probe(named_arrays)
    if bad:
        err = DivergenceError(
            f"non-finite values in propert{'y' if len(bad) == 1 else 'ies'} "
            f"{', '.join(bad)} after {where}", props=bad)
        if health is not None:
            health.record_error(err)
        raise err
