"""Backend failover policy: sticky degradation with periodic re-probe
(a copy of ``repro.runtime.failover``).

When a backend's kernels fail to build or launch, the session hops
down its failover chain (``cuda → cuda_chained → torch`` by default;
see :func:`repro_torch.core.registry.failover_chain`) carrying graph state
across via the cross-backend ``state_to_csr`` path.  Degradation is
*sticky* — the session keeps serving on the surviving backend — but a
re-probe timer (shared exponential backoff with the elastic launcher)
periodically attempts to convert back to the preferred backend; a
failed probe re-degrades and doubles the wait.

This module is pure policy/bookkeeping: no engine imports, no device
work.  The session layer owns the actual state migration.
"""
from __future__ import annotations

import random
import time
from typing import List, Optional, Sequence


def backoff_delay(attempt: int, base: float = 0.5, cap: float = 30.0,
                  jitter: float = 0.5,
                  rng: Optional[random.Random] = None) -> float:
    """Exponential backoff with decorrelating jitter: ``base * 2**attempt``
    capped at ``cap``, then scaled by a uniform factor in
    ``[1 - jitter, 1]``.  Shared by the elastic restart loop and the
    failover re-probe timer so both degrade pressure the same way."""
    if base <= 0:
        return 0.0
    d = min(float(base) * (2.0 ** max(int(attempt), 0)), float(cap))
    if jitter > 0:
        r = rng.random() if rng is not None else random.random()
        d *= 1.0 - float(jitter) * r
    return d


class FailoverPolicy:
    """Bookkeeping for one session's degradation state.

    * ``preferred`` — the registry name ``bind()`` originally asked for.
    * ``chain``     — remaining fallbacks, in order, *excluding* whatever
      is currently bound.
    * re-probe: ``should_probe(now)`` turns true once the backoff window
      since the last failure has elapsed; ``probe_failed(now)`` doubles
      the window, ``recovered()`` resets it.
    """

    def __init__(self, preferred: str, chain: Sequence[str],
                 probe_base_s: float = 0.5, probe_cap_s: float = 30.0,
                 rng: Optional[random.Random] = None):
        self.preferred = preferred
        self.chain: List[str] = [c for c in chain if c != preferred]
        self.probe_base_s = probe_base_s
        self.probe_cap_s = probe_cap_s
        self._rng = rng
        self._failures = 0         # consecutive preferred-backend failures
        self._next_probe_t: Optional[float] = None

    # -- degradation ---------------------------------------------------------
    def candidates(self, current: str) -> List[str]:
        """Backends left to try after ``current`` failed, preserving
        chain order."""
        if current == self.preferred:
            return list(self.chain)
        if current in self.chain:
            i = self.chain.index(current)
            return self.chain[i + 1:]
        return list(self.chain)

    def degraded_from(self, now: Optional[float] = None) -> None:
        """Record a failure of the preferred backend (or of a probe) and
        schedule the next re-probe."""
        now = time.monotonic() if now is None else now
        self._failures += 1
        self._next_probe_t = now + backoff_delay(
            self._failures - 1, self.probe_base_s, self.probe_cap_s,
            rng=self._rng)

    # -- re-probe ------------------------------------------------------------
    def should_probe(self, now: Optional[float] = None) -> bool:
        if self._next_probe_t is None:
            return False
        now = time.monotonic() if now is None else now
        return now >= self._next_probe_t

    def probe_failed(self, now: Optional[float] = None) -> None:
        self.degraded_from(now)

    def recovered(self) -> None:
        self._failures = 0
        self._next_probe_t = None
