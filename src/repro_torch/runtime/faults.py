"""Chaos-injection harness: named fault seams on the runtime hot path
(a copy of ``repro.runtime.faults``, importing the port's
:class:`KernelFailure`).

Generalizes the ``ckpt._crash_point`` test seam from the checkpoint
commit protocol into a registry any host-side boundary can consult.
Production cost is one truthiness check on an empty dict per seam
crossing; nothing fires unless a test armed an injector.

    from repro_torch.runtime import faults

    with faults.inject("kernel_launch", KernelFailure("boom"),
                       match=lambda ctx: ctx.get("engine") == "cuda"):
        sess.apply(batch)          # raises at the cuda launch seam

Seams are *host-side* boundaries.  Where the port runs eagerly a seam
fires on EVERY crossing: an ``after=`` / ``times=`` schedule counts
each batch's launch.  Inside a stream segment that the card replays as
a captured CUDA graph (``core/device_loop.SegmentGraph``) the seams of
the step body (``kernel_launch``) fire when the segment runs uncaptured
(on the CPU, and a segment's first use on the card) and while it is
captured, and not on its replays; ``segment_scan`` sits in the driver
and fires once per segment every time.  (In ``repro`` a seam inside a
jitted function fires only while it is traced, so the same schedule
counts compiles there; compare end states across the packages, not
``fired`` counts.)

Named seams (instrumented call sites):

  * ``kernel_launch``    — ``CudaEngine.update_add`` (above the
                           fused/chained branch) and the kernelized
                           sweep dispatch; ctx ``engine``, ``fused``,
                           ``op`` ("update_add" or "sweep"); the dist
                           engines' sweep and update_add dispatch (ctx
                           ``engine`` "dist" / "dist_sharded", ``op``)
  * ``pool_merge``       — host-side diff-pool grow/merge
                           (``TorchEngine.grow``)
  * ``checkpoint_write`` — every commit-protocol point in ckpt.save
                           (ctx: ``point`` in shard/manifest/committed/
                           renamed, beside ``_crash_point``)
  * ``counter_sync``     — the per-attempt (overflow, used, dead) pool
                           counter readback in the session layer and the
                           pool's one read per group round
  * ``segment_scan``     — per-segment dispatch in ``Engine.run_stream``
                           (per batch) and the fused executor
                           (``Engine._run_stream_fused``, per segment)
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional

from repro_torch.runtime.errors import KernelFailure

SEAMS = ("kernel_launch", "pool_merge", "checkpoint_write",
         "counter_sync", "segment_scan")

_lock = threading.Lock()
_injectors: Dict[str, List["Injector"]] = {}


class Injector:
    """One armed fault: raises ``exc`` at a seam, ``times`` times, after
    skipping the first ``after`` matching crossings.  ``match`` filters
    on the seam's context kwargs (e.g. engine name, commit point)."""

    def __init__(self, seam: str, exc: Optional[BaseException] = None,
                 after: int = 0, times: Optional[int] = 1,
                 match: Optional[Callable[[dict], bool]] = None):
        if seam not in SEAMS:
            raise ValueError(f"unknown fault seam {seam!r}; "
                             f"known: {', '.join(SEAMS)}")
        self.seam = seam
        self.exc = exc
        self.after = after
        self.times = times          # None = every matching crossing
        self.match = match
        self.fired = 0              # observability for tests
        self.seen = 0

    def _consider(self, ctx: dict) -> Optional[BaseException]:
        if self.match is not None and not self.match(ctx):
            return None
        self.seen += 1
        if self.seen <= self.after:
            return None
        if self.times is not None and self.fired >= self.times:
            return None
        self.fired += 1
        if self.exc is not None:
            return self.exc
        return KernelFailure(f"injected fault at seam {self.seam!r}",
                             backend=ctx.get("engine"), seam=self.seam)


def fire(seam: str, **ctx) -> None:
    """Cross a named seam.  No-op (one dict truthiness check) unless a
    test armed an injector for it."""
    if not _injectors:
        return
    injs = _injectors.get(seam)
    if not injs:
        return
    with _lock:
        for inj in list(injs):
            exc = inj._consider(ctx)
            if exc is not None:
                raise exc


@contextlib.contextmanager
def inject(seam: str, exc: Optional[BaseException] = None, *,
           after: int = 0, times: Optional[int] = 1,
           match: Optional[Callable[[dict], bool]] = None):
    """Arm a fault at ``seam`` for the duration of the with-block and
    yield the :class:`Injector` (tests read ``.fired``).  ``exc=None``
    raises a fresh :class:`KernelFailure` per crossing."""
    inj = Injector(seam, exc, after=after, times=times, match=match)
    with _lock:
        _injectors.setdefault(seam, []).append(inj)
    try:
        yield inj
    finally:
        with _lock:
            _injectors[seam].remove(inj)
            if not _injectors[seam]:
                del _injectors[seam]


def reset() -> None:
    """Disarm everything (test teardown safety net)."""
    with _lock:
        _injectors.clear()


def active() -> Dict[str, int]:
    """Armed injector count per seam (diagnostics)."""
    with _lock:
        return {k: len(v) for k, v in _injectors.items()}
