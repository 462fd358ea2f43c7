"""Elastic execution + straggler policy (a copy of
``repro.launch.elastic``; it imports no framework).

Failure model at 1000+ nodes (DESIGN.md §5):

  * **Node loss.**  A dead host surfaces as a collective timeout /
    RuntimeError in the step function.  Policy: tear down, rebuild the
    mesh from surviving hosts (shrinking the ``data`` axis — parameter
    specs are *named*, so restore re-shards onto the new mesh without any
    per-device bookkeeping), resume from the latest committed checkpoint.
    ``run_elastic`` implements exactly this loop; at host scale the
    "re-mesh" is a no-op but the restart/restore path is fully real.

  * **Stragglers.**  Synchronous SPMD means the step time is the max over
    hosts.  Mitigations wired into the launcher:
      - deterministic host-sharded input pipeline (no data-server tail),
      - async dispatch (host k+1 work is enqueued before step k ends),
      - checkpoint writes on a background thread (no step-time spike),
      - the cross-pod gradient reduction is hierarchical
        (reduce-scatter intra-pod → all-reduce inter-pod → all-gather),
        so one slow DCI link only serializes its own pod's shard.
    For persistent stragglers the policy is eviction-and-rebalance:
    identical to node loss above, triggered by a step-time SLO.

  * **Preemption.**  SIGTERM → final checkpoint save → clean exit;
    the atomic-rename commit protocol guarantees a restartable state
    even if the save itself is interrupted.
"""
from __future__ import annotations

import time

from repro_torch.runtime.failover import backoff_delay


def run_elastic(train_fn, args, max_restarts: int = 3,
                backoff_s: float = 0.5, backoff_cap_s: float = 30.0):
    """Retry loop: restart `train_fn` from the latest checkpoint after a
    transient failure, rebuilding device state each attempt.  Restarts
    back off exponentially with jitter (``backoff_delay``, shared with
    the failover re-probe timer) so a cluster of restarting hosts does
    not stampede the coordinator in lockstep."""
    attempt = 0
    while True:
        try:
            return train_fn(args)
        except (RuntimeError, OSError) as e:
            attempt += 1
            if attempt > max_restarts:
                raise
            print(f"[elastic] failure: {e!r}; restart {attempt}/"
                  f"{max_restarts} from latest checkpoint")
            # A real cluster would re-query the coordinator for surviving
            # hosts here and rebuild the mesh with a smaller 'data' axis.
            if getattr(args, "fail_at", None) is not None:
                args.fail_at = None          # injected faults fire once
            time.sleep(backoff_delay(attempt - 1, base=backoff_s,
                                     cap=backoff_cap_s))


def run_elastic_session(make_session, work_fn, max_restarts: int = 3,
                        backoff_s: float = 0.5, backoff_cap_s: float = 30.0):
    """Tear-down → re-mesh → restore loop for ``repro_torch.api`` sessions.

    ``make_session(attempt)`` builds the session for the given attempt —
    typically ``attempt == 0`` binds fresh and every retry calls
    ``repro_torch.api.restore_session(ckpt_dir, ...)``, which re-partitions
    dist state onto whatever devices survived (the re-mesh).
    ``work_fn(session)`` must be resumable: consult
    ``session.stream_cursor`` to skip already-applied ΔG batches.  On a
    transient failure (RuntimeError/OSError — collective timeout, lost
    host) the session is dropped and rebuilt from the latest committed
    checkpoint; the atomic-rename commit protocol guarantees one exists.

    Both elastic loops share the exponential-backoff-with-jitter policy
    (the old ``backoff_s=0.0`` default here was a hot restart loop: a
    persistent fault re-bound the session as fast as the device could
    re-prepare it).
    """
    attempt = 0
    while True:
        sess = make_session(attempt)
        try:
            return work_fn(sess)
        except (RuntimeError, OSError) as e:
            attempt += 1
            if attempt > max_restarts:
                raise
            print(f"[elastic] failure: {e!r}; rebuilding session "
                  f"{attempt}/{max_restarts} from latest checkpoint")
            time.sleep(backoff_delay(attempt - 1, base=backoff_s,
                                     cap=backoff_cap_s))
