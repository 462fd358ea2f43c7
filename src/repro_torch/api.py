"""The public session API for hand-staged algorithms (counterpart of the
``bind_graph`` half of ``repro.api``).

    import repro_torch
    from repro_torch.algos import sssp

    csr = repro_torch.build_csr(n, edges, w)              # on the card
    sess = repro_torch.bind_graph(csr, backend="cuda",
                                  capacity=2 * stream.num_adds)
    props = sess.call(sssp.static_sssp, 0)
    props = sess.run_stream(stream, 65536, sssp.stream_step, props)
    sess.to_host()["dist"]                                 # explicit sync

PageRank runs the same way (``algos.pagerank.static_pr`` and
``make_stream_step``); ``backend`` is ``"cuda"``, ``"cuda_chained"`` or
``"torch"``.

A session owns one engine and its device-resident graph handle.  Every
ΔG batch passes the admission guard first (default ``clamp``); a batch
that overflows the diff pool rolls back, grows the pool and replays.
Entry points run on the card unless ``device="cpu"`` is asked for.

Checkpoints (``save``/``restore``), backend failover and the divergence
watchdog wait for later slices; ``failover=`` other than ``None``
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Union

from repro_torch.core.engine import Engine, props_from_numpy
from repro_torch.core.registry import (available_backends, make_engine,
                                       register_engine)
from repro_torch.graph.csr import CSR
from repro_torch.graph.updates import UpdateBatch, UpdateStream
from repro_torch.runtime.admission import DEFAULT_MAX_BATCH, AdmissionGuard
from repro_torch.runtime.errors import (AdmissionError, DivergenceError,
                                        PoolOverflowError)
from repro_torch.runtime.health import SessionHealth

__all__ = [
    "GraphSession", "bind_graph", "PropertyView", "register_engine",
    "available_backends", "props_from_numpy", "AdmissionError",
    "PoolOverflowError", "SessionHealth",
]

_DEFAULT_CAPACITY = 64


def bind_graph(csr: CSR, backend: str = "cuda",
               capacity: Union[str, int] = "auto",
               admission: Optional[str] = "clamp",
               max_batch: int = DEFAULT_MAX_BATCH,
               dead_letter: int = 64,
               failover=None,
               device=None,
               **backend_opts) -> "GraphSession":
    """An algorithm-agnostic session: a device-resident graph handle for
    hand-staged ``repro_torch.algos`` code, on ``device`` (default: the
    card; the CSR is copied there if it lives elsewhere)."""
    if failover is not None:
        raise NotImplementedError(
            "backend failover waits for a later slice (ROADMAP Queue 1 "
            "item 11)")
    engine = make_engine(backend, device=device, **backend_opts)
    return GraphSession(engine, csr, capacity, backend_name=backend,
                        admission=admission, max_batch=max_batch,
                        dead_letter=dead_letter)


def _auto_capacity(stream: Optional[UpdateStream] = None,
                   batch: Optional[UpdateBatch] = None) -> int:
    """Diff-pool size from the bound stream/batch: every add may land in
    the pool, doubled for headroom; floored at ``_DEFAULT_CAPACITY``,
    which is also the size when neither is in sight."""
    if stream is not None:
        return max(_DEFAULT_CAPACITY, 2 * stream.num_adds)
    if batch is not None:
        return max(_DEFAULT_CAPACITY, 8 * batch.size)
    return _DEFAULT_CAPACITY


class PropertyView(Mapping):
    """Lazy view over a session's vertex properties: indexing returns the
    device tensor; ``to_host()`` / ``host(name)`` copy to numpy, sliced
    to the real vertex count — the one place the API syncs."""

    def __init__(self, arrays: Dict[str, Any], n_real: int):
        self._arrays = arrays
        self._n = n_real

    def __getitem__(self, name: str):
        return self._arrays[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._arrays)

    def __len__(self) -> int:
        return len(self._arrays)

    def host(self, name: str):
        return self._arrays[name].cpu().numpy()[: self._n]

    def to_host(self):
        return {k: self.host(k) for k in self._arrays}

    def __repr__(self):
        return (f"PropertyView({sorted(self._arrays)}, "
                f"n={self._n}, device-resident)")


class GraphSession:
    """Owns one engine instance and its device-resident graph handle.

    ``prepare`` runs once per session, lazily, so ``capacity='auto'`` can
    size the diff pool from the first stream or batch it sees."""

    # grow-and-replay attempts before _retry_on_overflow gives up
    _max_grow_attempts = 8

    def __init__(self, engine: Engine, csr: CSR,
                 capacity: Union[str, int] = "auto", *,
                 backend_name: Optional[str] = None,
                 admission: Optional[str] = "clamp",
                 max_batch: int = DEFAULT_MAX_BATCH,
                 dead_letter: int = 64):
        if not (capacity == "auto" or isinstance(capacity, int)):
            raise ValueError(f"capacity must be 'auto' or an int, "
                             f"got {capacity!r}")
        self._engine = engine
        self._csr = csr
        self._capacity = capacity
        self._handle = None
        self._props: Dict[str, Any] = {}
        # last host-observed overflow counter (see _retry_on_overflow)
        self._of_base = 0
        # ΔG batches applied through apply()/run_stream()
        self._cursor = 0
        self._backend_name = backend_name or engine.name
        self._health = SessionHealth(backend=self._backend_name,
                                     preferred_backend=self._backend_name)
        self._guard = AdmissionGuard(admission, max_batch=max_batch,
                                     dead_letter=dead_letter,
                                     health=self._health)
        self._health.dead_letter = self._guard.buffer
        engine.raw_ids = self._guard.policy == "off"

    # -- resident state ------------------------------------------------------
    @property
    def engine(self) -> Engine:
        return self._engine

    @property
    def backend(self) -> str:
        return self._engine.name

    @property
    def backend_name(self) -> str:
        return self._backend_name

    @property
    def device(self):
        return self._engine.device

    @property
    def health(self) -> SessionHealth:
        return self._health

    @property
    def dead_letter(self):
        """Quarantined-batch records (bounded; oldest evicted first)."""
        return self._guard.buffer.records()

    @property
    def handle(self):
        """The device-resident graph handle (prepared on first access)."""
        self._ensure_prepared()
        return self._handle

    @property
    def prepared(self) -> bool:
        return self._handle is not None

    @property
    def stream_cursor(self) -> int:
        return self._cursor

    def _ensure_prepared(self, stream: Optional[UpdateStream] = None,
                         batch: Optional[UpdateBatch] = None) -> None:
        if self._handle is not None:
            return
        cap = self._capacity if isinstance(self._capacity, int) \
            else _auto_capacity(stream, batch)
        self._handle = self._engine.prepare(self._csr, diff_capacity=cap)

    @property
    def props(self) -> PropertyView:
        """Current vertex properties, device-resident."""
        if self._handle is None:
            return PropertyView({}, 0)
        return PropertyView(dict(self._props), self._engine.n_real)

    def _sync_counters(self) -> tuple:
        """ONE host readback of the (overflow, used, dead) pool triple."""
        return self._engine._counters(self._handle)

    def _n_vertices(self) -> int:
        return self._engine.n_real if self._handle is not None \
            else self._csr.n

    def _retry_on_overflow(self, attempt: Callable[[], None],
                           regrow: Callable[[], None], batch=None,
                           rollback: Optional[Callable[[], None]] = None
                           ) -> None:
        """Run ``attempt()``; while it raised the overflow counter,
        ``regrow()`` (roll back + grow the pool) and replay, at most
        ``_max_grow_attempts`` times, after which ``rollback()`` restores
        the pre-batch state and :class:`PoolOverflowError` is raised.
        ``rollback()`` also runs if an attempt raises.  One counter sync
        per attempt."""
        def run_attempt():
            try:
                attempt()
            except BaseException:
                if rollback is not None:
                    rollback()
                raise

        run_attempt()
        of = self._sync_counters()[0]
        grows = 0
        while of > self._of_base:
            self._health.overflow_retries += 1
            if grows >= self._max_grow_attempts:
                if rollback is not None:
                    rollback()
                counters = self._sync_counters()
                cap = self._engine._diff_capacity(self._handle)
                err = PoolOverflowError(
                    f"batch still overflows the diff pool after "
                    f"{grows} grow-and-replay attempts "
                    f"(capacity now {cap}); state rolled back to the "
                    f"pre-batch graph", batch=batch, attempts=grows,
                    diff_capacity=cap, counters=counters)
                self._health.record_error(err)
                raise err
            regrow()
            grows += 1
            self._health.pool_grows += 1
            self._of_base = 0  # grow merges the pool, clearing counters
            run_attempt()
            of = self._sync_counters()[0]
        self._of_base = of

    def _guarded(self, op: Callable[[], Any]):
        """Run ``op``, counting backend faults in ``health``; the typed
        data-plane faults pass through."""
        try:
            return op()
        except (AdmissionError, PoolOverflowError, DivergenceError):
            raise
        except Exception as exc:   # noqa: BLE001 — health bookkeeping
            self._health.kernel_failures += 1
            self._health.record_error(exc)
            raise

    # -- structural updates --------------------------------------------------
    def apply(self, batch: UpdateBatch) -> "GraphSession":
        """Apply one ΔG batch structurally (deletes then adds) after
        admission, growing the diff pool and replaying on overflow."""
        self._ensure_prepared(batch=batch)
        admitted = self._guard.admit(batch, self._n_vertices(),
                                     cursor=self._cursor)
        if admitted is not None and self._guard.policy != "off" and not (
                bool(admitted.add_mask.any())
                or bool(admitted.del_mask.any())):
            # zero active lanes: skip the launch entirely
            self._health.empty_skipped += 1
            admitted = None
        if admitted is not None:
            self._guarded(lambda: self._apply_admitted(admitted))
        self._cursor += 1
        return self

    def _apply_admitted(self, admitted: UpdateBatch) -> None:
        base = self._handle

        def attempt():
            h = self._engine.update_del(base, admitted)
            self._handle = self._engine.update_add(h, admitted)

        def regrow():
            nonlocal base
            base = self._handle = self._engine.grow(base)

        def rollback():
            self._handle = base

        self._retry_on_overflow(attempt, regrow, batch=admitted,
                                rollback=rollback)

    # -- hand-staged drivers -------------------------------------------------
    def call(self, fn: Callable, *args, **kwargs):
        """Run a hand-staged driver ``fn(engine, handle, *args)``.  A
        ``(new_handle, result)`` return is adopted into the session;
        anything else passes through untouched."""
        self._ensure_prepared()
        ret = {}

        def work():
            base = self._handle

            def attempt():
                self._handle = base
                out = fn(self._engine, base, *args, **kwargs)
                if isinstance(out, tuple) and len(out) == 2 and \
                        type(out[0]) is type(base):
                    self._handle, result = out
                    if isinstance(result, dict):
                        self._props = dict(result)
                    ret["value"] = result
                else:
                    ret["value"] = out

            def regrow():
                nonlocal base
                base = self._engine.grow(base)

            def rollback():
                self._handle = base

            self._retry_on_overflow(attempt, regrow, rollback=rollback)

        self._guarded(work)
        return ret["value"]

    def run_stream(self, stream: UpdateStream, batch_size: int,
                   step_fn: Callable, carry, **kw):
        """Drive a stream through the engine's executor; the updated
        handle stays resident and the final carry is returned.

        Admission is ONE vectorized host pass over the raw stream arrays
        before any device work; poison batches are resolved one by one
        per policy and the clean ranges between them run unchanged."""
        self._ensure_prepared(stream=stream)
        nb = stream.num_batches(batch_size)
        poison = self._guard.inspect_stream(stream, batch_size,
                                            self._n_vertices())
        if poison:
            carry = self._run_stream_guarded(stream, batch_size, step_fn,
                                             carry, poison, **kw)
        else:
            if self._guard.policy != "off":
                self._health.admitted += nb
            self._handle, carry = self._guarded(
                lambda: self._engine.run_stream(self._handle, stream,
                                                batch_size, step_fn, carry,
                                                **kw))
            # the executor may have grown the pool — resync the base
            self._of_base = self._sync_counters()[0]
            self._cursor += nb
        if isinstance(carry, dict):
            self._props = dict(carry)
        return carry

    def _apply_step(self, batch: UpdateBatch, step_fn: Callable, carry):
        """One stream step for a single admitted batch, with the bounded
        grow-and-replay backstop."""
        out = {}
        base = [self._handle]

        def attempt():
            h, c = step_fn(self._engine, base[0], batch, carry)
            self._handle = h
            out["carry"] = c

        def regrow():
            base[0] = self._handle = self._engine.grow(base[0])

        def rollback():
            self._handle = base[0]

        self._retry_on_overflow(attempt, regrow, batch=batch,
                                rollback=rollback)
        return out["carry"]

    def _run_stream_guarded(self, stream: UpdateStream, batch_size: int,
                            step_fn: Callable, carry, poison, **kw):
        """Poison batches present: under ``reject`` fail before any device
        work; otherwise run the clean ranges through the executor and
        resolve each poison batch (clamp → sanitize + one step;
        quarantine → dead-letter + skip, the cursor still advancing)."""
        n = self._n_vertices()
        nb = stream.num_batches(batch_size)
        if self._guard.policy == "reject":
            first = min(poison)
            self._guard.resolve(stream.batch(first, batch_size, self.device),
                                poison[first], self._cursor, first, n)
        i = 0
        while i < nb:
            if i in poison:
                admitted = self._guard.resolve(
                    stream.batch(i, batch_size, self.device), poison[i],
                    self._cursor, i, n)
                if admitted is not None:
                    carry = self._guarded(
                        lambda b=admitted, c=carry:
                        self._apply_step(b, step_fn, c))
                self._cursor += 1
                i += 1
            else:
                j = i
                while j < nb and j not in poison:
                    j += 1
                sub = stream.window(batch_size, i, j - i)
                self._health.admitted += j - i
                self._handle, carry = self._guarded(
                    lambda s=sub, c=carry: self._engine.run_stream(
                        self._handle, s, batch_size, step_fn, c, **kw))
                self._cursor += j - i
                i = j
        self._of_base = self._sync_counters()[0]
        return carry

    def to_host(self):
        return self.props.to_host()
