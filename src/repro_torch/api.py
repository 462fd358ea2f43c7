"""The public API: compile a DSL program once, bind it to a backend, keep
graph state resident on the card across calls (counterpart of
``repro.api``).

    import repro_torch
    from repro_torch import dsl_programs

    prog = repro_torch.compile(dsl_programs.path("sssp"))
    sess = prog.bind(csr, backend="cuda")
    res = sess.run("DynSSSP", updateBatch=stream, batchSize=65536, src=0)
    res.props["dist"]          # device tensor, no host sync
    res.to_host()["dist"]      # explicit numpy readback

    # armed: omit the stream, then feed ΔG batches as they arrive
    sess = prog.bind(csr, backend="cuda")
    sess.run("DynSSSP", batchSize=65536, src=0)
    for batch in live_feed:
        sess.apply(batch)
    sess.save(ckpt_dir)        # restore_session(ckpt_dir) resumes it

Hand-staged algorithms (``repro_torch.algos``) ride the same sessions
through ``bind_graph``:

    from repro_torch.algos import sssp

    csr = repro_torch.build_csr(n, edges, w)              # on the card
    sess = repro_torch.bind_graph(csr, backend="cuda",
                                  capacity=2 * stream.num_adds)
    props = sess.call(sssp.static_sssp, 0)
    props = sess.run_stream(stream, 65536, sssp.stream_step, props)
    sess.to_host()["dist"]                                 # explicit sync

PageRank and triangle counting run the same way (``algos.pagerank``,
``algos.triangles``); ``backend`` is ``"cuda"``, ``"cuda_chained"``,
``"frontier"`` (direction-optimised sparse steps) or ``"torch"``.
``run_stream`` runs each segment of batches as one captured CUDA graph on
the card (``Engine.run_stream`` is the per-batch baseline).

A session owns one engine and its device-resident graph handle.  Every
ΔG batch passes the admission guard first (default ``clamp``); a batch
that overflows the diff pool rolls back, grows the pool and replays.
Entry points run on the card unless ``device="cpu"`` is asked for.
Checkpoints share ``repro``'s layout and state kinds: a checkpoint that
``repro`` wrote names its backend ``jnp``, ``pallas`` or ``frontier``, so
``restore_session`` takes ``backend="torch"``, ``"cuda"`` or
``"frontier"`` for it.

Backend failover is opt-in: ``bind_graph(csr, backend="cuda",
failover=True)`` (or an explicit tuple of registry names) arms the chain
``cuda → cuda_chained → torch``.  A kernel that fails to build or
launch (or a fault planted at a ``runtime.faults`` seam) rolls the batch
back, moves the graph to the next backend on the same device (packed
state → host → ``state_to_csr`` → ``prepare``) and replays the batch
there; a backoff timer re-probes the preferred backend.
``session.health`` counts every hop (``failovers``, ``kernel_failures``,
``reprobes``, ``degraded``, ``backend``), and an exhausted chain raises
:class:`KernelFailure`.  Without ``failover=`` a kernel fault raises
after the rollback.  Failover recovers from faults that raise and leave
the CUDA context usable: a kernel that fails to build, a launch error
that the wrapper reports (``kernels/_build.py: raise_on``), a planted
fault.  A sticky fault (an illegal address, a device-side assert)
poisons the context for every backend on that card, so no hop can
recover from it and none is tried: the error it leaves surfaces at the
next call, from whichever backend makes it.
"""
from __future__ import annotations

import functools
import pathlib
import threading
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.dsl.codegen import (ArmedRun, CodegenError, Program,
                                          compile_source)
from repro_torch.core.engine import Engine, props_from_numpy, state_to_csr
from repro_torch.core.registry import (available_backends, failover_chain,
                                       make_engine, register_engine)
from repro_torch.graph.csr import CSR
from repro_torch.graph.updates import UpdateBatch, UpdateStream
from repro_torch.runtime import faults as _faults
from repro_torch.runtime import watchdog as _watchdog
from repro_torch.runtime.admission import DEFAULT_MAX_BATCH, AdmissionGuard
from repro_torch.runtime.errors import (AdmissionError, DivergenceError,
                                        KernelFailure, PoolOverflowError)
from repro_torch.runtime.failover import FailoverPolicy
from repro_torch.runtime.health import SessionHealth
from repro_torch.tensors import resolve_device, to_device

__all__ = [
    "compile", "CompiledProgram", "Session", "GraphSession", "bind_graph",
    "SessionResult", "PropertyView", "register_engine",
    "available_backends", "restore_session", "props_from_numpy",
    "AdmissionError", "PoolOverflowError", "KernelFailure",
    "DivergenceError", "SessionHealth",
]

_DEFAULT_CAPACITY = 64

# a compile miss is not atomic: two threads binding the same program
# would race compile_source and get two CompiledPrograms; serialize misses
_COMPILE_LOCK = threading.Lock()


@functools.lru_cache(maxsize=256)
def _compile_once(source_or_path: str, stamp) -> "CompiledProgram":
    return CompiledProgram(compile_source(source_or_path))


def compile(source_or_path: str) -> "CompiledProgram":
    """Compile DSL text (or a path to a ``.sp`` file) once; the result
    is cached per source (``.sp`` cache entries key on the file's
    mtime, so on-disk edits recompile)."""
    s = str(source_or_path)
    stamp = None
    if s.endswith(".sp"):
        p = pathlib.Path(s)
        if p.exists():
            stamp = p.stat().st_mtime_ns
    with _COMPILE_LOCK:
        return _compile_once(s, stamp)


def _dedupe_chain(names) -> tuple:
    """Order-preserving dedupe of a failover candidate list, so a chain
    that re-lists a backend constructs (and reports) it once."""
    seen = set()
    out = []
    for name in names:
        if name not in seen:
            seen.add(name)
            out.append(name)
    return tuple(out)


def _make_engine_failover(backend: str, failover, device=None,
                          **backend_opts):
    """Instantiate ``backend`` on ``device``; with failover enabled, a
    factory that raises falls down the chain at bind time.  Returns
    ``(engine, bound_registry_name)``.  The device is resolved first: a
    missing card is no backend fault, and no hop moves to the CPU."""
    if not failover:
        return make_engine(backend, device=device, **backend_opts), backend
    device = resolve_device(device)
    chain = failover_chain(backend) if failover is True else tuple(failover)
    last = None
    for name in _dedupe_chain((backend, *chain)):
        try:
            # backend_opts are engine-specific (e.g. cuda k=): only the
            # requested backend gets them; every candidate gets the device
            opts = backend_opts if name == backend else {}
            return make_engine(name, device=device, **opts), name
        except Exception as e:       # noqa: BLE001 — bind-time failover
            last = e
    raise KernelFailure(
        f"no backend in {_dedupe_chain((backend, *chain))} could be "
        f"constructed", backend=backend, cause=last)


def _post_bind_failover(sess: "GraphSession", requested: str, bound: str,
                        failover) -> None:
    """Record a bind-time degradation (the requested backend's factory
    failed and a fallback was bound instead)."""
    if bound == requested or not failover:
        return
    chain = failover_chain(requested) if failover is True \
        else _dedupe_chain(failover)
    sess._failover = FailoverPolicy(requested, chain)
    sess._failover.degraded_from()
    sess._health.preferred_backend = requested
    sess._health.backend = bound
    sess._health.failovers += 1


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
    card; the CSR is copied there if it lives elsewhere).
    ``failover=True`` (or an explicit chain of registry names) arms
    backend degradation (module docstring)."""
    engine, bound = _make_engine_failover(backend, failover, device=device,
                                          **backend_opts)
    sess = GraphSession(engine, csr, capacity, backend_name=bound,
                        admission=admission, max_batch=max_batch,
                        dead_letter=dead_letter, failover=failover)
    _post_bind_failover(sess, backend, bound, failover)
    return sess


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


def _tree_spec(tree):
    """Per-leaf ``[shape, numpy dtype name]`` mirror of a nested-dict
    tensor tree — JSON-able, enough to rebuild an example tree for
    ``ckpt.restore``; the names are numpy's, so ``repro`` reads them."""
    if isinstance(tree, dict):
        return {k: _tree_spec(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        np_dtype = torch.empty(0, dtype=tree.dtype).numpy().dtype
        return [list(tree.shape), str(np_dtype)]
    arr = np.asarray(tree)
    return [list(arr.shape), str(arr.dtype)]


def _example_from_spec(spec):
    if isinstance(spec, dict):
        return {k: _example_from_spec(v) for k, v in spec.items()}
    shape, dtype = spec
    return np.zeros(tuple(shape), np.dtype(dtype))


def _fit_pad(arr, n_real: int, n_pad: int, device) -> torch.Tensor:
    """A saved vertex array refitted to the restoring engine's padding on
    ``device`` (dist's n_pad = block·P changes with the shard count).
    The pad region is dead to the lowerings (they mask ``idx < n_real``),
    so it is filled from the saved pad value when there is one, else
    zero."""
    arr = to_device(arr, device)
    if arr.dim() == 0 or arr.shape[0] == n_pad:
        return arr
    body = arr[:n_real]
    if n_pad == n_real:
        return body
    fill = arr[n_real] if arr.shape[0] > n_real else arr.new_zeros(())
    return torch.cat([body, fill.expand(n_pad - n_real)])


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


class SessionResult:
    """What ``Session.run`` returns: device-resident props and the DSL
    return value.  ``to_host()`` is the explicit sync point."""

    def __init__(self, session: "GraphSession", props: PropertyView,
                 value: Any = None):
        self.session = session
        self.props = props
        self.value = value

    @property
    def graph(self):
        return self.session.handle

    def to_host(self) -> Dict[str, np.ndarray]:
        return self.props.to_host()

    def __repr__(self):
        return (f"SessionResult(props={sorted(self.props)}, "
                f"value={self.value!r})")


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
                 dead_letter: int = 64,
                 failover=None):
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
        # engines share Engine.name across registry entries (cuda and
        # cuda_chained are both "cuda"), so the chain keys on the
        # registry name the session was bound under
        if failover:
            chain = failover_chain(self._backend_name) if failover is True \
                else _dedupe_chain(failover)
            self._failover: Optional[FailoverPolicy] = FailoverPolicy(
                self._backend_name, chain)
        else:
            self._failover = None

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
        """Live fault-runtime counters; ``health.as_dict()`` is the
        JSON-able snapshot."""
        self._health.backend = self._backend_name
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
        _faults.fire("counter_sync", engine=self._backend_name)
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

    # -- backend degradation -------------------------------------------------
    def _guarded(self, op: Callable[[], Any]):
        """Run ``op`` with backend failover: a kernel fault hops down the
        failover chain (migrating the graph through ``state_to_csr``) and
        replays ``op`` on the survivor.  The typed data-plane faults
        (admission, pool overflow, divergence) pass through: they are the
        stream's fault, not the backend's.  ``op`` must read
        ``self._engine`` / ``self._handle`` fresh so a replay sees the
        migrated state.  Without a chain a fault is counted and raised."""
        if self._failover is None:
            try:
                return op()
            except (AdmissionError, PoolOverflowError, DivergenceError):
                raise
            except Exception as exc:   # noqa: BLE001 — health bookkeeping
                self._health.kernel_failures += 1
                self._health.record_error(exc)
                raise
        self._maybe_reprobe()
        try:
            return op()
        except (AdmissionError, PoolOverflowError, DivergenceError):
            raise
        except Exception as exc:       # noqa: BLE001 — failover boundary
            return self._degrade_and_retry(op, exc)

    def _degrade_and_retry(self, op: Callable[[], Any], exc: Exception):
        self._health.kernel_failures += 1
        self._health.record_error(exc)
        last = exc
        for name in self._failover.candidates(self._backend_name):
            try:
                self._migrate(name)
            except Exception as mexc:  # noqa: BLE001 — try next in chain
                last = mexc
                continue
            self._failover.degraded_from()
            self._health.failovers += 1
            try:
                return op()
            except (AdmissionError, PoolOverflowError, DivergenceError):
                raise
            except Exception as nexc:  # noqa: BLE001 — keep degrading
                self._health.kernel_failures += 1
                self._health.record_error(nexc)
                last = nexc
        err = KernelFailure(
            f"backend {self._failover.preferred!r} and its failover "
            f"chain {tuple(self._failover.chain)} all failed",
            backend=self._backend_name, cause=last)
        self._health.record_error(err)
        raise err

    def _maybe_reprobe(self) -> None:
        """Sticky degradation with periodic re-probe: once the backoff
        window since the last failure elapses, move back to the preferred
        backend; a failed probe doubles the window."""
        if (self._backend_name == self._failover.preferred
                or not self._failover.should_probe()):
            return
        self._health.reprobes += 1
        try:
            self._migrate(self._failover.preferred)
        except Exception as exc:       # noqa: BLE001 — probe failed
            self._failover.probe_failed()
            self._health.record_error(exc)
        else:
            self._failover.recovered()

    def _migrate(self, name: str) -> None:
        """Re-bind the graph onto backend ``name`` on the same device:
        ``pack_state`` (pure data access, so it works while the old
        backend's kernels are broken) → ``state_to_csr`` (on the host) →
        ``prepare`` on the new engine.  Value-preserving; the pool layout
        resets.  Properties are refitted to the new engine's padding
        (``dist``'s n_pad is a multiple of its shard count)."""
        self._ensure_prepared()
        old = self._engine
        n = old.n_real
        tree, hmeta = old.pack_state(self._handle)
        csr, cap = state_to_csr(tree, hmeta, device=old.device)
        engine = make_engine(name, device=old.device)
        engine.raw_ids = old.raw_ids
        handle = engine.prepare(csr, diff_capacity=cap)
        self._engine = engine
        self._handle = handle
        self._backend_name = name
        self._health.backend = name
        self._props = {k: _fit_pad(v, n, engine.n_pad, engine.device)
                       for k, v in self._props.items()}
        self._of_base = self._sync_counters()[0]

    # -- divergence watchdog -------------------------------------------------
    def _watch(self, arrays: Dict[str, Any], where: str) -> None:
        if self._guard.policy != "off":
            _watchdog.check(arrays.items(), where=where,
                            health=self._health)

    def check_divergence(self) -> None:
        """On-demand NaN/Inf probe over the resident property tensors;
        raises :class:`DivergenceError` naming the poisoned ones."""
        _watchdog.check(self._props.items(), where="check_divergence",
                        health=self._health)

    # -- structural updates --------------------------------------------------
    def apply(self, batch: UpdateBatch) -> "GraphSession":
        """Apply one ΔG batch structurally (deletes then adds) after
        admission, growing the diff pool and replaying on overflow."""
        admitted = self._admit_for_apply(batch)
        if admitted is not None:
            self._apply_admitted(admitted)
        return self

    def _admit_for_apply(self, batch: UpdateBatch) -> Optional[UpdateBatch]:
        """The admission half of :meth:`apply`: guard the batch and do the
        cursor bookkeeping of a batch consumed without device work
        (quarantined, or no active lane).  Returns the admitted batch or
        None.  The serving pool admits through here and executes through
        its batched path."""
        self._ensure_prepared(batch=batch)
        admitted = self._guard.admit(batch, self._n_vertices(),
                                     cursor=self._cursor)
        if admitted is None:           # quarantined: consumed, not applied
            self._cursor += 1
            return None
        if self._guard.policy != "off" and not (
                bool(admitted.add_mask.any())
                or bool(admitted.del_mask.any())):
            # zero active lanes: skip the launch entirely
            self._health.empty_skipped += 1
            self._cursor += 1
            return None
        return admitted

    def _apply_admitted(self, admitted: UpdateBatch) -> None:
        """The execution half of :meth:`apply`: deletes then adds under
        the failover guard, with the bounded grow-and-replay backstop."""

        def work():
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

        self._guarded(work)
        self._cursor += 1

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
            self._watch(carry, where="run_stream")
        return carry

    def _apply_step(self, batch: UpdateBatch, step_fn: Callable, carry):
        """One stream step for a single admitted batch, with the bounded
        grow-and-replay backstop."""
        out = {}
        base = [self._handle]

        def attempt():
            h, c = step_fn(self._engine.stream_view(), base[0], batch,
                           carry)
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

    # -- durability (DESIGN.md §5) -------------------------------------------
    def state_tree(self):
        """Everything a durable restore needs, as one ``(nested-dict
        tensor tree, JSON-able meta)`` pair: the packed graph handle,
        the resident property tensors and the stream cursor."""
        self._ensure_prepared()
        handle_tree, handle_meta = self._engine.pack_state(self._handle)
        tree = {"handle": handle_tree, "props": dict(self._props)}
        meta = {"version": 1, "kind": "graph",
                "backend": self._engine.name,
                "n": self._engine.n_real, "n_pad": self._engine.n_pad,
                "handle": handle_meta, "cursor": self._cursor}
        return tree, meta

    def save(self, ckpt_dir, step: Optional[int] = None, keep: int = 3):
        """Durably checkpoint the session (atomic-rename commit protocol,
        see ``repro_torch.ckpt.checkpoint``).  ``step`` defaults to the
        stream cursor; returns the committed step directory."""
        tree, meta = self.state_tree()
        meta["tree_spec"] = _tree_spec(tree)
        step = self._cursor if step is None else int(step)
        return ckpt.save(ckpt_dir, step, tree, extra=meta, keep=keep)

    @staticmethod
    def restore(ckpt_dir, backend: Optional[str] = None,
                step: Optional[int] = None, **backend_opts):
        """Rebuild a session from ``save()`` output — see
        :func:`restore_session`."""
        return restore_session(ckpt_dir, backend=backend, step=step,
                               **backend_opts)


class Session(GraphSession):
    """A CompiledProgram bound to one backend and one graph.

    Two modes per DSL function:

    * **one-shot** — ``run("DynSSSP", updateBatch=stream, ...)`` executes
      the whole function (prologue, Batch loop over the given stream,
      epilogue) against the resident handle; bit-identical to the
      deprecated ``Program.run``, with no re-prepare and no host readback.
    * **armed** — omit the ``updates<g>`` argument and ``run`` executes
      only the prologue (e.g. the static algorithm), leaving the Batch
      loop armed: each ``apply(batch)`` then executes one loop body
      against the live state, and ``run_stream(stream, batch_size)``
      folds a whole stream through it.  N applies are bit-identical to
      one one-shot run over the same N batches.
    """

    def __init__(self, compiled: "CompiledProgram", engine: Engine,
                 csr: CSR, capacity: Union[str, int] = "auto", **runtime_kw):
        super().__init__(engine, csr, capacity, **runtime_kw)
        self.compiled = compiled
        self._armed: Optional[ArmedRun] = None
        # the staged executable per function: repeat calls and armed
        # applies skip host-side AST pattern interpretation
        self._staged_funcs: Dict[str, Any] = {}

    # -- DSL execution -------------------------------------------------------
    def _staged(self, func: str):
        st = self._staged_funcs.get(func)
        if st is None:
            st = self._staged_funcs[func] = \
                self.compiled.program.stage(func, self._engine)
        return st

    def _batch_size_hint(self, staged, args) -> Optional[int]:
        """The batch size a one-shot run will use, when the caller's
        args name it (Batch statements read a scalar param such as
        ``batchSize``); None when it cannot be told host-side (admission
        then admits the one-shot path unchecked)."""
        sizes = set()
        for name in staged._armable:
            v = args.get(name) if isinstance(name, str) else name
            if isinstance(v, bool):
                continue
            if isinstance(v, (int, np.integer)):
                sizes.add(int(v))
        return sizes.pop() if len(sizes) == 1 else None

    def _arm(self, func: str, args) -> None:
        armed = self._staged(func).begin(self._handle, args)
        self._armed = armed
        self._handle = armed.gbox.value
        self._props = armed.device_props()

    def run(self, func: str, **args) -> SessionResult:
        """Execute DSL function ``func`` against the resident graph.

        Scalars and the update stream are passed by parameter name, as
        keyword arguments.  If the function takes an ``updates<g>``
        parameter and it is omitted (or None), the session arms the
        Batch loop instead of running it (see class docstring)."""
        program = self.compiled.program
        fnode = program.ast.func(func)   # raises early on unknown names
        upd_params = [p.name for p in fnode.params
                      if p.type.name == "updates"]
        streams = [args[p] for p in upd_params
                   if args.get(p) is not None]
        staged = self._staged(func)
        self._ensure_prepared(stream=streams[0] if streams else None)

        if upd_params and not streams:
            self._guarded(lambda: self._arm(func, args))
            return SessionResult(self, self.props, value=None)

        if streams and self._guard.policy != "off":
            res = self._run_oneshot_guarded(func, staged, args, upd_params)
            if res is not None:
                return res

        out = {}

        def op():
            st = self._staged(func)
            base = self._handle

            def attempt():
                g, props, ret = st.call(base, args)
                self._handle = g
                out["props"], out["ret"] = props, ret

            def regrow():
                # adds were dropped: grow the pool and replay the whole
                # run from the pre-run graph
                nonlocal base
                base = self._engine.grow(base)

            def rollback():
                self._handle = base

            self._retry_on_overflow(attempt, regrow, rollback=rollback)

        self._guarded(op)
        # disarm only now: a run that raised (bad args, lowering error)
        # leaves a previously armed loop intact
        self._armed = None
        self._props = out["props"]
        self._watch(self._props, where=f"run({func})")
        return SessionResult(self, self.props, value=out["ret"])

    def _run_oneshot_guarded(self, func: str, staged, args,
                             upd_params) -> Optional[SessionResult]:
        """Admission for one-shot runs: inspect the stream host-side
        before execution.  A clean stream returns None and the caller
        takes the one-shot path.  With poison batches, ``reject`` raises;
        clamp/quarantine arm the Batch loop and feed guarded per-batch
        applies (bit-identical to one-shot over the same batches)."""
        if len(upd_params) != 1:
            return None
        pname = upd_params[0]
        stream = args[pname]
        bs = self._batch_size_hint(staged, args)
        if bs is None or not isinstance(stream, UpdateStream):
            return None
        poison = self._guard.inspect_stream(stream, bs, self._n_vertices())
        if not poison:
            self._health.admitted += stream.num_batches(bs)
            return None
        arm_args = {k: v for k, v in args.items() if k != pname}
        self._guarded(lambda: self._arm(func, arm_args))
        self._armed_stream_loop(stream, bs)
        value = self._armed.value()
        self._armed = None
        self._watch(self._props, where=f"run({func})")
        return SessionResult(self, self.props, value=value)

    @property
    def armed(self) -> bool:
        return self._armed is not None

    def call(self, fn: Callable, *args, **kwargs):
        out = super().call(fn, *args, **kwargs)
        # a hand-staged driver that advanced the handle would leave an
        # armed frame's graph box stale: it supersedes the armed loop
        self._armed = None
        return out

    @property
    def value(self):
        """The DSL return value as of the current state (armed sessions
        evaluate the post-Batch epilogue without disturbing state)."""
        if self._armed is not None:
            return self._armed.value()
        raise CodegenError("no armed function; use the SessionResult "
                           "returned by run()")

    # -- incremental updates -------------------------------------------------
    def apply(self, batch: UpdateBatch) -> "Session":
        """Feed one ΔG batch to the armed Batch loop (a structural update
        when nothing is armed).  On diff-pool overflow the state rolls
        back, the pool grows, and the batch replays."""
        if self._armed is None:
            super().apply(batch)
            return self
        if self._armed.returned:
            return self    # a batch body returned: the Batch loop is
                           # over, exactly as in a one-shot run
        admitted = self._guard.admit(batch, self._n_vertices(),
                                     cursor=self._cursor)
        if admitted is None:          # quarantined: batch consumed
            self._cursor += 1
            return self
        self._apply_armed(admitted)
        return self

    def _apply_armed(self, batch: UpdateBatch) -> None:
        """One admitted batch through the armed loop body, with snapshot
        rollback for the overflow regrow-and-replay."""

        def op():
            armed = self._armed
            snap = [armed.snapshot()]

            def attempt():
                armed.apply(batch)
                self._handle = armed.gbox.value

            def regrow():
                armed.restore(snap[0])
                armed.gbox.value = self._engine.grow(armed.gbox.value)
                self._handle = armed.gbox.value
                snap[0] = armed.snapshot()

            def rollback():
                armed.restore(snap[0])
                self._handle = armed.gbox.value

            self._retry_on_overflow(attempt, regrow, batch=batch,
                                    rollback=rollback)

        self._guarded(op)
        self._props = self._armed.device_props()
        self._cursor += 1

    def _armed_stream_loop(self, stream: UpdateStream, bs: int) -> None:
        """Fold a stream through the armed loop with stream-level
        admission: poison batches are located on the raw host rows first
        (``UpdateStream.batch`` int-casts what it pads) and resolved per
        policy as the loop reaches them."""
        n = self._n_vertices()
        poison = self._guard.inspect_stream(stream, bs, n)
        if poison and self._guard.policy == "reject":
            first = min(poison)
            self._guard.resolve(stream.batch(first, bs, self.device),
                                poison[first], self._cursor, first, n)
        for i in range(stream.num_batches(bs)):
            if self._armed.returned:
                break            # a batch body returned: stop, like the
            batch = stream.batch(i, bs, self.device)   # one-shot loop
            if i in poison:
                batch = self._guard.resolve(batch, poison[i],
                                            self._cursor, i, n)
                if batch is None:         # quarantined: batch consumed
                    self._cursor += 1
                    continue
            elif self._guard.policy != "off":
                self._health.admitted += 1
            self._apply_armed(batch)

    # -- failover ------------------------------------------------------------
    def _migrate(self, name: str) -> None:
        """Backend migration with the armed Batch loop carried across: the
        paused frame is serialized on the failing backend (pure data
        access), the graph moves through the alive-edge list, and the
        frame is re-staged and deserialized on the survivor."""
        armed_state = None
        if self._armed is not None:
            arrays, armed_meta = self._armed.serialize()
            for pname, m in armed_meta["env"].items():
                if m["kind"] == "prop" and m.get("bound") and m["is_edge"]:
                    raise KernelFailure(
                        f"cannot fail over to {name!r}: armed edge "
                        f"property {pname!r} is bound to the "
                        f"{self._backend_name!r} pool layout",
                        backend=name)
            armed_state = (arrays, armed_meta)
        n = self._engine.n_real
        super()._migrate(name)
        # staged executables hold the old engine
        self._staged_funcs.clear()
        if armed_state is not None:
            self._rearm(armed_state[1], armed_state[0], n)

    def _rearm(self, armed_meta: dict, arrays: dict, n: int) -> None:
        """Re-stage an armed Batch loop on the current engine and rebuild
        its paused frame from serialized arrays (failover migration and
        ``restore_session``); its vertex properties are refitted to the
        engine's padding (``n`` real vertices)."""
        for pname, m in armed_meta["env"].items():
            if m["kind"] == "prop" and m.get("bound") and not m["is_edge"]:
                arrays[f"prop_{pname}"] = _fit_pad(
                    arrays[f"prop_{pname}"], n, self._engine.n_pad,
                    self._engine.device)
        staged = self._staged(armed_meta["func"])
        self._armed = ArmedRun.deserialize(staged, self._handle, arrays,
                                           armed_meta)
        self._handle = self._armed.gbox.value
        self._props = self._armed.device_props()

    # -- durability ----------------------------------------------------------
    def state_tree(self):
        """Adds the program source and (when armed) the serialized
        Batch-loop position to the GraphSession snapshot."""
        tree, meta = super().state_tree()
        meta["kind"] = "session"
        meta["source"] = self.compiled.program.source
        if self._armed is not None:
            arrays, armed_meta = self._armed.serialize()
            tree["armed"] = arrays
            meta["armed"] = armed_meta
        return tree, meta

    def run_stream(self, stream: UpdateStream, batch_size: Optional[int] =
                   None, step_fn: Optional[Callable] = None, carry=None,
                   **kw):
        """Armed sessions: fold a whole update stream through the armed
        Batch loop, one ``apply`` per batch; returns a
        :class:`SessionResult`.  With an explicit ``step_fn`` this is the
        GraphSession (hand-staged) path and returns the final carry."""
        if step_fn is not None:
            out = super().run_stream(stream, batch_size, step_fn, carry,
                                     **kw)
            # hand-staged streaming supersedes any armed DSL loop
            self._armed = None
            return out
        if self._armed is None:
            raise CodegenError("run_stream without step_fn needs an armed "
                               "function; call run(func, ...) without its "
                               "updates argument first")
        if carry is not None or kw:
            raise TypeError(
                f"run_stream on an armed session takes only (stream, "
                f"batch_size); carry/{sorted(kw)} belong to the step_fn "
                f"(hand-staged) path")
        bs = batch_size
        if bs is None:
            # the batchSize the function was armed with, if any
            try:
                bs = self._armed.frame.lookup(
                    self._armed.batch_stmt.batch_size)
            except CodegenError:
                bs = None
        if bs is None:
            raise CodegenError("no batch size: pass run_stream(..., "
                               "batch_size=N) or batchSize= at arm time")
        self._ensure_prepared(stream=stream)
        self._armed_stream_loop(stream, int(bs))
        self._watch(self._props, where="run_stream(armed)")
        return SessionResult(self, self.props, value=self._armed.value())


class CompiledProgram:
    """A compiled DSL program, backend-agnostic; ``bind`` picks the
    backend by registry name and yields a :class:`Session`."""

    def __init__(self, program: Program):
        self.program = program

    @property
    def functions(self):
        """Names of the functions this program defines."""
        return [f.name for f in self.program.ast.funcs]

    def bind(self, csr: CSR, backend: str = "cuda",
             capacity: Union[str, int] = "auto",
             admission: str = "clamp",
             max_batch: int = DEFAULT_MAX_BATCH,
             dead_letter: int = 64,
             failover=None,
             device=None,
             **backend_opts) -> Session:
        """Bind to a graph on a named backend, on ``device`` (default:
        the card).  ``capacity`` sizes the diff-CSR pool: an int is
        explicit; ``"auto"`` derives it from the stream of the first
        one-shot run (armed sessions start at the default size), with
        grow-on-overflow as the backstop either way.  ``admission`` is
        the ΔG validation policy (``reject | clamp | quarantine |
        off``) and ``failover`` the degradation chain, as for
        :func:`bind_graph`; a backend that fails to construct at bind
        time leaves the session degraded on the first survivor."""
        engine, bound = _make_engine_failover(backend, failover,
                                              device=device, **backend_opts)
        sess = Session(self, engine, csr, capacity, backend_name=bound,
                       admission=admission, max_batch=max_batch,
                       dead_letter=dead_letter, failover=failover)
        _post_bind_failover(sess, backend, bound, failover)
        return sess

    def __repr__(self):
        return f"CompiledProgram(functions={self.functions})"


def restore_session(ckpt_dir, backend: Optional[str] = None,
                    step: Optional[int] = None,
                    engine: Optional[Engine] = None,
                    **backend_opts) -> GraphSession:
    """Reconstruct a session from a checkpoint directory written by
    ``Session.save`` / ``GraphSession.save`` (of this package or of
    ``repro``).

    ``step=None`` picks the latest committed step.  ``backend=None``
    restores onto the backend that saved (a ``repro`` checkpoint names
    ``jnp`` or ``pallas``, which this package does not have: pass
    ``torch`` or ``cuda``).  Same state kind (``torch`` ↔ ``dyn``,
    ``cuda`` ↔ ``pallas``): **bit-exact**, the raw handle leaves (diff
    pool, tombstones, ELL pack) are restored.  The dist backends
    (``dist``, ``dist_sharded``, kind ``dist``) re-partition their
    canonical edge list onto the restoring engine, so a session saved on
    P shards comes back on ``num_shards=M``; the properties are refitted
    to its padding.  Another kind converts through the alive-edge list
    and re-``prepare``s (value-preserving, pool layout reset).  An armed
    Batch loop resumes where it paused; the prologue is not re-run.  ``backend_opts`` (``device=`` among
    them) go to the engine; ``engine=`` restores onto an engine already
    built instead."""
    if step is None:
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {ckpt_dir}")
    meta = ckpt.read_manifest(ckpt_dir, step)["extra"]
    if engine is not None:
        if backend is not None or backend_opts:
            raise ValueError("restore_session: pass either engine= or "
                             "backend=/**backend_opts, not both")
    else:
        engine = make_engine(backend or meta["backend"], **backend_opts)
    tree, _ = ckpt.restore(ckpt_dir, step,
                           _example_from_spec(meta["tree_spec"]))

    hmeta = meta["handle"]
    exact = engine.state_kind == hmeta["kind"]
    if exact:
        handle = engine.unpack_state(tree["handle"], hmeta)
    else:
        csr, cap = state_to_csr(tree["handle"], hmeta, device=engine.device)
        handle = engine.prepare(csr, diff_capacity=cap)

    if meta["kind"] == "session":
        sess: GraphSession = Session(compile(meta["source"]), engine,
                                     csr=None)
    else:
        sess = GraphSession(engine, csr=None)
    # edge-lane state survives only where the pool layout does: a dist
    # restore re-partitions even within its kind
    lanes_ok = exact and hmeta["kind"] != "dist"

    sess._handle = handle
    n = int(meta["n"])
    sess._props = {k: _fit_pad(v, n, engine.n_pad, engine.device)
                   for k, v in tree.get("props", {}).items()}
    sess._cursor = int(meta["cursor"])

    armed_meta = meta.get("armed")
    if armed_meta is not None:
        arrays = dict(tree.get("armed") or {})
        for name, m in armed_meta["env"].items():
            if m["kind"] == "prop" and m.get("bound") and m["is_edge"] \
                    and not lanes_ok:
                raise ValueError(
                    f"armed edge property {name!r} is bound to the "
                    f"saved pool layout; it cannot survive a "
                    f"cross-backend restore or a dist re-mesh — restore "
                    f"onto the saving backend's state kind, or disarm "
                    f"before saving")
        sess._rearm(armed_meta, arrays, n)
    # one triple read pins the overflow base for the restored pool
    sess._of_base = sess._sync_counters()[0]
    return sess
