"""SessionPool: thousands of live graphs multiplexed over one process
(counterpart of ``repro.serve.pool``).

The serving story the paper's Batch-loop driver implies but never
builds: one compiled program × one backend, N independent tenant graphs
resident at once.  The pool owns

* **binding** — tenants bind through
  :func:`repro_torch.core.registry.shared_engine`, so every same-scope
  tenant shares ONE engine instance (and its caches) on the pool's
  device;
* **the batched execution path** — queued ΔG batches from same-shape
  sessions are stacked and applied in one vmapped mega-call
  (:mod:`repro_torch.serve.batch`; on ``cuda`` one batched merge
  launch for the group), bit-exact vs per-session ``apply``;
* **backpressure** — a bounded request queue with per-tenant FIFOs and
  round-robin fairness; at the bound, ``overload="reject"`` raises the
  typed :class:`~repro_torch.runtime.errors.PoolSaturatedError` and
  ``"shed"`` drops the oldest request of the deepest queue into a
  dead-letter buffer of QuarantineRecords (the admission taxonomy,
  reused one level up);
* **eviction** — beyond ``max_resident`` live sessions, the
  least-recently-used idle tenant is spilled via ``Session.save`` and
  transparently revived on next touch by ``restore_session`` onto the
  SAME shared engine (``engine=``), so a revived tenant rejoins its
  batching group.

Per-tenant fault counters stay in each session's ``SessionHealth``;
``pool.health`` adds the queue/batching/eviction counters only the pool
can see.
"""
from __future__ import annotations

import collections
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.registry import shared_engine
from repro_torch.graph.csr import CSR
from repro_torch.graph.updates import UpdateBatch
from repro_torch.runtime import faults as _faults
from repro_torch.runtime.admission import (DEFAULT_MAX_BATCH, AdmissionGuard,
                                           DeadLetterBuffer,
                                           QuarantineRecord, Violation)
from repro_torch.runtime.errors import PoolSaturatedError
from repro_torch.runtime.health import PoolHealth
from repro_torch.serve.batch import BATCH_MODES, MegaBatcher, group_key
from repro_torch.tensors import resolve_device

OVERLOAD_POLICIES = ("reject", "shed")


class SessionPool:
    """Serve many independent graph sessions from one compiled program.

    ``program=None`` pools algorithm-agnostic ``bind_graph``-style
    sessions (hand-staged drivers); passing a
    :class:`~repro_torch.api.CompiledProgram` pools DSL sessions, including
    armed Batch loops (armed applies run per-session — the armed frame
    is host-side state — but still share the engine's executables).

    The request path is ``submit(tenant, batch)`` → ``drain()``; the
    blocking convenience ``apply(tenant, batch)`` does both.  All entry
    points are thread-safe behind one reentrant lock: device work is
    serialized (sessions share engines and one stream), threads only
    ever wait, never corrupt.  Sessions live on ``device`` (default: the
    card).  ``solo_runs`` names, in order, the tenants of the batched
    modes that ran solo after all, with why: ``"singleton"`` (alone in
    their group) or ``"overflow"`` (their pool overflowed inside the
    mega-call and was replayed with grow-and-replay).
    """

    def __init__(self, program=None, backend: str = "cuda", *,
                 batch_mode: str = "vmap",
                 max_pending: int = 256,
                 overload: str = "reject",
                 max_resident: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 admission: Optional[str] = "clamp",
                 max_batch: int = DEFAULT_MAX_BATCH,
                 dead_letter: int = 64,
                 shed_letter: int = 64,
                 device=None,
                 **engine_opts):
        if batch_mode not in BATCH_MODES:
            raise ValueError(f"batch_mode must be one of {BATCH_MODES}, "
                             f"got {batch_mode!r}")
        if overload not in OVERLOAD_POLICIES:
            raise ValueError(f"overload must be one of "
                             f"{OVERLOAD_POLICIES}, got {overload!r}")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.program = program
        self.backend = backend
        self.batch_mode = batch_mode
        self.max_pending = int(max_pending)
        self.overload = overload
        self.max_resident = max_resident
        self._spill_root = spill_dir
        self._admission = admission
        self._max_batch = int(max_batch)
        self._dead_letter = int(dead_letter)
        self._engine_opts = dict(engine_opts)
        self.device = resolve_device(device)

        self._lock = threading.RLock()
        self._sessions: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()          # LRU order: oldest first
        self._evicted: Dict[str, str] = {}     # tenant -> spill dir
        self._queues: Dict[str, collections.deque] = {}
        self._order: List[str] = []            # round-robin cursor basis
        self._rr = 0
        self._pending = 0
        self._batcher = MegaBatcher(batch_mode if batch_mode != "off"
                                    else "vmap")
        # tenants in the currently-executing round: restoring one round
        # member must never evict another (its admitted-but-unapplied
        # session would be spilled pre-apply and the apply lost)
        self._pinned: frozenset = frozenset()
        self.shed_records = DeadLetterBuffer(shed_letter)
        self.health = PoolHealth()
        self.solo_runs: List[Tuple[str, str]] = []

    # -- binding -------------------------------------------------------------
    def bind(self, tenant: str, csr: CSR, **session_kw):
        """Bind ``tenant`` to its own graph on the pool's shared engine.
        ``session_kw`` overrides the pool-level session defaults
        (``capacity``, ``admission``, ``max_batch``, ``dead_letter``)."""
        from repro_torch.api import GraphSession, Session   # circular
        with self._lock:
            if tenant in self._sessions or tenant in self._evicted:
                raise ValueError(f"tenant {tenant!r} is already bound")
            engine = self._shared_engine(csr.n)
            kw = {"admission": self._admission,
                  "max_batch": self._max_batch,
                  "dead_letter": self._dead_letter}
            kw.update(session_kw)
            capacity = kw.pop("capacity", "auto")
            if self.program is not None:
                sess = Session(self.program, engine, csr, capacity,
                               backend_name=self.backend, **kw)
            else:
                sess = GraphSession(engine, csr, capacity,
                                    backend_name=self.backend, **kw)
            self._sessions[tenant] = sess
            self._queues[tenant] = collections.deque()
            self._order.append(tenant)
            self.health.tenants += 1
            self.health.resident += 1
            self._maybe_evict(keep=(tenant,))
            return sess

    def _shared_engine(self, n: int):
        """The pool's one engine per graph scale, on the pool's device.
        ``scope`` carries the vertex count because engines keep
        per-graph host state (``_n``); see
        :func:`repro_torch.core.registry.shared_engine`."""
        return shared_engine(self.backend, scope=(self.program, n),
                             device=self.device, **self._engine_opts)

    def session(self, tenant: str):
        """The tenant's live session, transparently restoring it from
        its spill checkpoint if it was evicted."""
        with self._lock:
            sess = self._sessions.get(tenant)
            if sess is not None:
                self._sessions.move_to_end(tenant)      # LRU touch
                return sess
            spill = self._evicted.get(tenant)
            if spill is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            return self._restore(tenant, spill)

    def tenants(self) -> List[str]:
        with self._lock:
            return list(self._order)

    # -- request queue -------------------------------------------------------
    def submit(self, tenant: str, batch: UpdateBatch) -> None:
        """Enqueue one ΔG batch for ``tenant``.  At ``max_pending`` the
        overload policy decides: ``reject`` raises
        :class:`PoolSaturatedError` (the submit is refused, no state
        touched); ``shed`` drops the oldest request of the deepest
        queue into ``shed_records`` and accepts this one."""
        with self._lock:
            if tenant not in self._queues:
                raise KeyError(f"unknown tenant {tenant!r}")
            if self._pending >= self.max_pending:
                if self.overload == "reject":
                    self.health.rejected += 1
                    raise PoolSaturatedError(
                        f"pool queue full ({self._pending}/"
                        f"{self.max_pending} pending); submit for "
                        f"{tenant!r} refused", tenant=tenant,
                        pending=self._pending,
                        max_pending=self.max_pending, policy="reject",
                        depths=self._depths())
                self._shed_one(tenant)
            self._queues[tenant].append(batch)
            self._pending += 1
            self.health.submitted += 1
            self.health.queue_peak = max(self.health.queue_peak,
                                         self._pending)

    def _depths(self) -> Dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if q}

    def _shed_one(self, incoming: str) -> None:
        """Drop the oldest request of the deepest queue — pressure comes
        off the tenant most responsible for it, and the victim keeps its
        FIFO order.  The dropped request lands in ``shed_records`` as a
        QuarantineRecord so a client can replay it later."""
        victim = max(self._queues, key=lambda t: len(self._queues[t]))
        dropped = self._queues[victim].popleft()
        self._pending -= 1
        self.health.shed += 1
        sess = self._sessions.get(victim)
        cursor = sess.stream_cursor if sess is not None else -1
        self.shed_records.push(QuarantineRecord(
            reasons=(Violation("pool_saturated", 1,
                               f"queue full ({self.max_pending}); shed "
                               f"oldest of {victim!r} on submit from "
                               f"{incoming!r}"),),
            cursor=cursor, index=None,
            n_adds=int(dropped.add_mask.sum()),
            n_dels=int(dropped.del_mask.sum()),
            batch=dropped))

    def pending(self) -> int:
        with self._lock:
            return self._pending

    # -- execution -----------------------------------------------------------
    def apply(self, tenant: str, batch: UpdateBatch):
        """Submit one batch and drain the queue: the blocking
        single-tenant path.  Returns the tenant's session."""
        self.submit(tenant, batch)
        self.drain()
        return self.session(tenant)

    def apply_many(self, requests) -> int:
        """Submit ``(tenant, batch)`` pairs, then drain — the batched
        ingest path a front-end uses once per service tick."""
        for tenant, batch in requests:
            self.submit(tenant, batch)
        return self.drain()

    def drain(self) -> int:
        """Apply every queued request.  Each round takes at most one
        request per tenant (round-robin starting after last round's
        first server, so no tenant owns the front of every round), then
        executes the round with same-shape sessions grouped into one
        mega-call each.  Returns the number of batches executed."""
        applied = 0
        with self._lock:
            while self._pending:
                round_ = []
                order = self._order[self._rr:] + self._order[:self._rr]
                if self._order:
                    self._rr = (self._rr + 1) % len(self._order)
                for tenant in order:
                    q = self._queues.get(tenant)
                    if q:
                        round_.append((tenant, q.popleft()))
                        self._pending -= 1
                applied += self._run_round(round_)
        return applied

    def _run_round(self, round_: List[Tuple[str, UpdateBatch]]) -> int:
        """One fairness round: admit every request through its session's
        own guard (exactly the solo-``apply`` admission code), group the
        admitted survivors by stackability, and run each group through
        the mega-call — falling back per-session on armed loops,
        singleton groups, ``batch_mode="off"``, and pool overflow."""
        applied = 0
        groups: Dict[Tuple, List[Tuple[Any, UpdateBatch]]] = {}
        self._pinned = frozenset(t for t, _ in round_)
        try:
            applied = self._run_round_pinned(round_, groups)
        finally:
            self._pinned = frozenset()
        # the round may have restored more tenants than max_resident
        # allows to coexist; with the pins lifted, re-enforce the bound
        self._maybe_evict()
        return applied

    def _run_round_pinned(self, round_, groups) -> int:
        applied = 0
        for tenant, batch in round_:
            sess = self.session(tenant)
            if getattr(sess, "_armed", None) is not None:
                # armed Batch loops interpret the batch through a paused
                # host-side frame — per-session by construction
                sess.apply(batch)
                self.health.sequential_fallbacks += 1
                self.health.applied += 1
                applied += 1
                continue
            admitted = sess._admit_for_apply(batch)
            if admitted is None:       # quarantined / empty: consumed
                self.health.applied += 1
                applied += 1
                continue
            if self.batch_mode == "off":
                sess._apply_admitted(admitted)
                self.health.sequential_fallbacks += 1
                self.health.applied += 1
                applied += 1
                continue
            key = group_key(sess._engine, sess._handle, admitted)
            groups.setdefault(key, []).append((sess, admitted))
        for members in groups.values():
            applied += self._run_group(members)
        return applied

    def _run_group(self, members: List[Tuple[Any, UpdateBatch]]) -> int:
        """Run one stackable group.  The mega-call is adopted per
        session only when its pool did NOT overflow; an overflowing
        session discards its slot and replays through the solo
        grow-and-replay path (``_apply_admitted``), which the other
        sessions never see."""
        if len(members) == 1:
            sess, admitted = members[0]
            self.solo_runs.append((self._tenant_of(sess), "singleton"))
            sess._apply_admitted(admitted)
            self.health.sequential_fallbacks += 1
            self.health.applied += 1
            return 1
        engine = members[0][0]._engine
        handles = [s._handle for s, _ in members]
        batches = [b for _, b in members]
        new_handles, counters = self._batcher.run(engine, handles, batches)
        _faults.fire("counter_sync", engine=self.backend)
        self.health.mega_calls += 1
        for (sess, admitted), handle, (of, _, _) in zip(members,
                                                        new_handles,
                                                        counters):
            if int(of) > sess._of_base:
                # this tenant's diff pool overflowed inside the
                # mega-call: its stacked result silently dropped adds.
                # Its own handle is untouched (the mega-call is
                # functional), so replay solo with grow-and-replay.
                self.health.sequential_fallbacks += 1
                self.solo_runs.append((self._tenant_of(sess), "overflow"))
                sess._apply_admitted(admitted)
            else:
                sess._handle = handle
                sess._of_base = int(of)
                sess._cursor += 1
                self.health.mega_sessions += 1
            self.health.applied += 1
        return len(members)

    def _tenant_of(self, sess) -> str:
        return next(t for t, s in self._sessions.items() if s is sess)

    # -- eviction ------------------------------------------------------------
    def evict(self, tenant: str) -> str:
        """Spill ``tenant`` to its checkpoint directory (``Session.save``
        — atomic-commit protocol) and free its device state.  Returns
        the spill path; the next ``session()``/``submit``+``drain``
        touch restores it transparently."""
        with self._lock:
            sess = self._sessions.get(tenant)
            if sess is None:
                if tenant in self._evicted:
                    return self._evicted[tenant]   # already spilled
                raise KeyError(f"unknown tenant {tenant!r}")
            if self._queues[tenant]:
                raise ValueError(f"tenant {tenant!r} has queued requests; "
                                 f"drain before evicting")
            path = os.path.join(self._spill_dir(), tenant)
            sess.save(path)
            del self._sessions[tenant]
            self._evicted[tenant] = path
            self.health.evictions += 1
            self.health.resident -= 1
            return path

    def _spill_dir(self) -> str:
        if self._spill_root is None:
            self._spill_root = tempfile.mkdtemp(prefix="repro-torch-pool-")
        os.makedirs(self._spill_root, exist_ok=True)
        return self._spill_root

    def _maybe_evict(self, keep: Tuple[str, ...] = ()) -> None:
        """Enforce ``max_resident`` by spilling least-recently-used
        tenants (skipping ``keep`` and anyone with queued work)."""
        if self.max_resident is None:
            return
        while self.health.resident > self.max_resident:
            victim = next((t for t in self._sessions
                           if t not in keep and t not in self._pinned
                           and not self._queues[t]),
                          None)
            if victim is None:
                return
            self.evict(victim)

    def _restore(self, tenant: str, spill: str):
        """Revive an evicted tenant onto the SAME shared engine (the
        ``engine=`` restore path), so it rejoins its executable-sharing
        group; then re-arm the pool's admission guard — guard config is
        pool policy, not checkpointed state (dead-letter records do not
        survive eviction; ``shed_records`` is the pool-level ledger)."""
        from repro_torch.api import restore_session
        from repro_torch.ckpt import checkpoint as ckpt
        step = ckpt.latest_step(spill)
        meta = ckpt.read_manifest(spill, step)["extra"]
        engine = self._shared_engine(int(meta["n"]))
        sess = restore_session(spill, engine=engine)
        sess._backend_name = self.backend
        sess._health.backend = self.backend
        sess._health.preferred_backend = self.backend
        sess._guard = AdmissionGuard(self._admission,
                                     max_batch=self._max_batch,
                                     dead_letter=self._dead_letter,
                                     health=sess._health)
        sess._health.dead_letter = sess._guard.buffer
        engine.raw_ids = sess._guard.policy == "off"
        self._sessions[tenant] = sess
        del self._evicted[tenant]
        self.health.restores += 1
        self.health.resident += 1
        self._maybe_evict(keep=(tenant,))
        return sess

    # -- observability -------------------------------------------------------
    def tenant_health(self, tenant: str):
        """The tenant's live ``SessionHealth`` (restores it if evicted)."""
        return self.session(tenant).health

    def stats(self) -> Dict[str, Any]:
        """One JSON-able snapshot: pool counters + queue depths + shed
        ledger summary."""
        with self._lock:
            d = self.health.as_dict()
            d["pending"] = self._pending
            d["depths"] = self._depths()
            d["evicted"] = sorted(self._evicted)
            d["shed_records"] = {"held": len(self.shed_records),
                                 "total": self.shed_records.total,
                                 "evicted": self.shed_records.evicted}
            return d
