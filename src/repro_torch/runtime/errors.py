"""Typed fault taxonomy for the streaming runtime (counterpart of
``repro.runtime.errors``; DESIGN.md §6).

Every failure mode the runtime can survive — or must report — gets a
distinct type carrying machine-readable context, so callers (the elastic
loop, the failover chain, a serving layer's SLO logic) can branch on
*what* went wrong instead of parsing ``RuntimeError`` strings.

All types derive from :class:`RuntimeFault` (itself a ``RuntimeError``
so existing ``except RuntimeError`` retry loops keep working) and expose
``describe()`` — a JSON-able dict mirrored into ``session.health``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence


class RuntimeFault(RuntimeError):
    """Base of the typed fault taxonomy."""

    def describe(self) -> Dict[str, Any]:
        return {"kind": type(self).__name__, "message": str(self)}


class AdmissionError(RuntimeFault):
    """A ΔG batch failed admission under the ``reject`` policy.

    ``reasons`` is the machine-readable violation list (see
    :class:`repro_torch.runtime.admission.Violation`)."""

    def __init__(self, message: str, reasons: Sequence = (),
                 batch_index: Optional[int] = None):
        super().__init__(message)
        self.reasons = tuple(reasons)
        self.batch_index = batch_index

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d["reasons"] = [r.as_dict() for r in self.reasons]
        if self.batch_index is not None:
            d["batch_index"] = self.batch_index
        return d


class PoolOverflowError(RuntimeFault):
    """The grow-and-replay loop hit its attempt cap: a batch kept
    overflowing the diff pool even after bounded capacity doubling.
    Carries the offending batch and the pool stats at give-up time, so
    the batch can be quarantined or split instead of growing the pool
    until OOM."""

    def __init__(self, message: str, batch=None, attempts: int = 0,
                 diff_capacity: int = 0, counters=()):
        super().__init__(message)
        self.batch = batch
        self.attempts = attempts
        self.diff_capacity = diff_capacity
        self.counters = tuple(int(c) for c in counters)  # (overflow, used, dead)

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d.update(attempts=self.attempts, diff_capacity=self.diff_capacity,
                 counters=list(self.counters),
                 batch_size=getattr(self.batch, "size", None))
        return d


class KernelFailure(RuntimeFault):
    """A backend kernel failed to compile or launch.  Raised by the
    chaos harness at the ``kernel_launch`` seam, and used to wrap the
    original backend exception when the failover chain is exhausted."""

    def __init__(self, message: str, backend: Optional[str] = None,
                 seam: Optional[str] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.backend = backend
        self.seam = seam
        if cause is not None:
            self.__cause__ = cause

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d.update(backend=self.backend, seam=self.seam,
                 cause=repr(self.__cause__) if self.__cause__ else None)
        return d


class CheckpointCorrupt(RuntimeFault):
    """A committed checkpoint failed to parse or restore — truncated
    manifest, leaf-count mismatch, unreadable shard.  Distinct from
    ``FileNotFoundError`` (no checkpoint at all): corrupt means the
    commit protocol's invariant was violated after the marker."""

    def __init__(self, message: str, path: Optional[str] = None,
                 step: Optional[int] = None):
        super().__init__(message)
        self.path = str(path) if path is not None else None
        self.step = step

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d.update(path=self.path, step=self.step)
        return d


class PoolSaturatedError(RuntimeFault):
    """The session pool's bounded request queue is full and the overload
    policy is ``reject``: the submit was refused before touching any
    session state.  Carries the queue shape at refusal time so a client
    (or load balancer) can back off per tenant instead of parsing
    strings."""

    def __init__(self, message: str, tenant: Optional[str] = None,
                 pending: int = 0, max_pending: int = 0,
                 policy: str = "reject",
                 depths: Optional[Dict[str, int]] = None):
        super().__init__(message)
        self.tenant = tenant
        self.pending = int(pending)
        self.max_pending = int(max_pending)
        self.policy = policy
        self.depths = dict(depths or {})

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d.update(tenant=self.tenant, pending=self.pending,
                 max_pending=self.max_pending, policy=self.policy,
                 depths=dict(self.depths))
        return d


class DivergenceError(RuntimeFault):
    """The on-device divergence probe found NaN/Inf in a property array
    after a stream segment — numerically diverged state that would
    otherwise propagate silently through every later batch."""

    def __init__(self, message: str, props: Sequence[str] = ()):
        super().__init__(message)
        self.props = tuple(props)

    def describe(self) -> Dict[str, Any]:
        d = super().describe()
        d["props"] = list(self.props)
        return d
