"""Session health: the observability substrate for the fault runtime
(counterpart of ``repro.runtime.health``).

Every admission decision, overflow retry, pool grow, failover hop and
divergence probe increments a counter here; ``session.health`` exposes
the live object and ``as_dict()`` the JSON-able snapshot a serving
layer's SLO logic would scrape.  Counters are plain ints mutated from
the session's own thread — no locking, matching the single-session
threading model everywhere else in ``repro_torch.api``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class SessionHealth:
    # admission
    admitted: int = 0          # batches applied (incl. clamped ones)
    clamped: int = 0           # batches sanitized before admission
    quarantined: int = 0       # batches diverted to the dead-letter buffer
    rejected: int = 0          # batches refused under the reject policy
    empty_skipped: int = 0     # zero-lane batches short-circuited host-side
    conflicts: int = 0         # add+del same-edge lanes (counted, not blocked
                               # under clamp: delete-before-add order applies)
    # pool pressure
    overflow_retries: int = 0  # grow-and-replay attempts
    pool_grows: int = 0        # successful capacity doublings
    # degradation
    failovers: int = 0         # backend hops taken
    reprobes: int = 0          # attempts to return to the preferred backend
    kernel_failures: int = 0   # kernel compile/launch failures observed
    # watchdog
    divergence_probes: int = 0
    # identity / last fault
    backend: Optional[str] = None            # currently bound registry name
    preferred_backend: Optional[str] = None  # what bind() originally asked for
    last_error: Optional[str] = None
    last_error_kind: Optional[str] = None
    dead_letter: Any = None    # the session's DeadLetterBuffer (or None)

    def record_error(self, exc: BaseException) -> None:
        self.last_error = str(exc)
        self.last_error_kind = type(exc).__name__

    @property
    def degraded(self) -> bool:
        return (self.backend is not None
                and self.preferred_backend is not None
                and self.backend != self.preferred_backend)

    def as_dict(self) -> Dict[str, Any]:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "dead_letter"}
        d["degraded"] = self.degraded
        if self.dead_letter is not None:
            d["dead_letter"] = {
                "held": len(self.dead_letter),
                "total": self.dead_letter.total,
                "evicted": self.dead_letter.evicted,
            }
        else:
            d["dead_letter"] = None
        return d


@dataclasses.dataclass
class PoolHealth:
    """Pool-level counters, one per serving pool (the reference's
    ``repro.serve.SessionPool``).

    Per-tenant fault counters stay in each session's
    :class:`SessionHealth`; this layer tracks what only the pool can
    see — queueing, batching, eviction, and shed/reject pressure.
    Mutated under the pool's lock (the pool's request queue IS
    multi-threaded, unlike single sessions)."""

    tenants: int = 0             # tenants ever bound (live + evicted)
    resident: int = 0            # sessions currently holding device state
    # request flow
    submitted: int = 0           # requests accepted into the queue
    applied: int = 0             # ΔG batches executed (any path)
    rejected: int = 0            # submits refused (reject policy)
    shed: int = 0                # queued requests dropped (shed policy)
    queue_peak: int = 0          # high-water mark of pending requests
    # batching
    mega_calls: int = 0          # batched multi-graph launches
    mega_sessions: int = 0       # sessions served by those launches
    sequential_fallbacks: int = 0  # armed/singleton/overflow per-session runs
    # eviction
    evictions: int = 0           # sessions spilled via Session.save
    restores: int = 0            # lazy restore_session revivals

    def as_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}
