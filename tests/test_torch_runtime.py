"""The port's fault runtime on the CPU, held against ``repro``: backend
failover (``cuda → cuda_chained → torch`` against the reference's
``pallas → pallas_chained → jnp``), the chaos seams, the re-probe back
to the preferred backend, and copies of the injector, the chain dedupe,
the backoff and the elastic loops.

Each failover case runs one schedule through both packages with the
same planted fault and compares the end states: every array of the
packed handle bit for bit, ``dist`` where there is one, and the
``SessionHealth`` fields with the backend names mapped.  ``Injector``
counts are not compared: a seam inside a jitted function of ``repro``
fires while it is traced, the port's on every crossing.  ``repro``'s
runs go through one worker thread, in order (its fault registry is
process-wide), while the port's run in the test thread."""
import concurrent.futures
import random

import numpy as np
import pytest

import repro
import repro.api as r_api
import repro_torch
import repro_torch.api as t_api
from repro.runtime import faults as r_faults
from repro_torch import dsl_programs
from repro_torch.core import registry as t_registry
from repro_torch.core.engine import state_to_csr
from repro_torch.graph.updates import UpdateStream
from repro_torch.launch import elastic
from repro_torch.runtime import faults
from repro_torch.runtime.errors import (AdmissionError, CheckpointCorrupt,
                                        DivergenceError, KernelFailure,
                                        PoolOverflowError, RuntimeFault)
from repro_torch.runtime.failover import FailoverPolicy, backoff_delay

# the reference's backend names → the port's
NAMES = {"pallas": "cuda", "pallas_chained": "cuda_chained", "jnp": "torch"}
HEALTH = ("failovers", "kernel_failures", "reprobes", "overflow_retries",
          "pool_grows", "admitted", "degraded", "backend",
          "preferred_backend", "last_error_kind")


@pytest.fixture(autouse=True)
def _clean_seams():
    faults.reset()
    yield
    faults.reset()


class Port:
    """One package's names, so a case runs the same code on both."""
    api, faults = t_api, faults
    fast, chained, plain = "cuda", "cuda_chained", "torch"
    kernel_engine = "cuda"       # Engine.name of both hand-kernel backends
    kw = {"device": "cpu"}

    @staticmethod
    def csr(n, edges, w=None):
        return repro_torch.build_csr(n, edges, w, device="cpu")

    @staticmethod
    def batch(stream, i, size):
        return stream.batch(i, size, device="cpu")

    @staticmethod
    def stream(adds):
        return UpdateStream(adds=np.asarray(adds, np.int64),
                            dels=np.zeros((0, 2), np.int64))

    @staticmethod
    def program():
        return repro_torch.compile(dsl_programs.path("sssp"))


class Ref(Port):
    api, faults = r_api, r_faults
    fast, chained, plain = "pallas", "pallas_chained", "jnp"
    kernel_engine = "pallas"
    kw = {}

    @staticmethod
    def csr(n, edges, w=None):
        return repro.graph.build_csr(n, edges, w)

    @staticmethod
    def batch(stream, i, size):
        return stream.batch(i, size)

    @staticmethod
    def stream(adds):
        return repro.graph.updates.UpdateStream(
            adds=np.asarray(adds, np.int64), dels=np.zeros((0, 2), np.int64))

    @staticmethod
    def program():
        from repro.dsl_programs import path
        return r_api.compile(path("sssp"))


def _graph(P, n=32):
    edges = np.array([(i, (i + 1) % n) for i in range(n)] +
                     [(0, 5), (3, 9)])
    return P.csr(n, edges)


ROWS = ((1, 7, 3), (2, 8, 1), (4, 11, 2), (5, 12, 1))
BIG = [(i % 30, (i * 7 + 1) % 31, 1) for i in range(24)]


def _step(view, h, batch, carry):
    h = view.update_del(h, batch)
    h = view.update_add(h, batch)
    return h, carry


def _no_reprobe(sess):
    """Pin the re-probe window shut: otherwise whether a probe falls
    between two batches depends on how long each package takes."""
    sess._failover.probe_base_s = 3600.0
    return sess


def _on_kernels(P):
    return lambda ctx: ctx.get("engine") == P.kernel_engine


def _host(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: _host(tree)}


def summary(P, sess, **extra):
    """What a case's end state is compared on."""
    tree, meta = sess.engine.pack_state(sess.handle)
    h = sess.health.as_dict()
    health = {k: h[k] for k in HEALTH}
    for k in ("backend", "preferred_backend"):
        health[k] = NAMES.get(health[k], health[k])
    out = {"backend": NAMES.get(sess.backend_name, sess.backend_name),
           "kind": meta["kind"], "state": _flat(tree), "health": health,
           "cursor": sess.stream_cursor}
    if "dist" in sess.props:
        out["dist"] = sess.props.host("dist")
    out.update(extra)
    return out


# ---------------------------------------------------------------------------
# the failover cases (tests/test_runtime_faults.py's, on both packages)
# ---------------------------------------------------------------------------

def case_kernel_launch(P):
    sess = P.api.bind_graph(_graph(P), backend=P.fast, failover=True, **P.kw)
    with P.faults.inject("kernel_launch", times=None,
                         match=_on_kernels(P)):
        sess.run_stream(P.stream(ROWS), 2, _step, None)
    return summary(P, sess)


def case_segment_scan(P):
    sess = P.api.bind_graph(_graph(P), backend=P.fast, failover=True, **P.kw)
    with P.faults.inject("segment_scan", times=1, match=_on_kernels(P)):
        sess.run_stream(P.stream(ROWS), 2, _step, None)
    return summary(P, sess)


def case_pool_merge(P):
    sess = P.api.bind_graph(_graph(P), backend=P.fast, capacity=8,
                            failover=True, **P.kw)
    with P.faults.inject("pool_merge", times=1, match=_on_kernels(P)):
        sess.run_stream(P.stream(BIG), 8, _step, None)
    return summary(P, sess)


def case_chained_start(P):
    """A session bound on the chained backend falls straight to the
    plain one."""
    sess = _no_reprobe(P.api.bind_graph(_graph(P), backend=P.chained,
                                        failover=True, **P.kw))
    with P.faults.inject("kernel_launch", times=None,
                         match=_on_kernels(P)):
        for i in range(2):
            sess.apply(P.batch(P.stream(ROWS), i, 2))
    return summary(P, sess)


def case_no_failover(P):
    stream = P.stream(ROWS)
    sess = P.api.bind_graph(_graph(P), backend=P.fast, **P.kw)
    sess.apply(P.batch(stream, 0, 2))
    before = _flat(sess.engine.pack_state(sess.handle)[0])
    with P.faults.inject("kernel_launch", times=None, match=_on_kernels(P)):
        with pytest.raises(KernelFailure if P is Port else
                           repro.runtime.errors.KernelFailure):
            sess.apply(P.batch(stream, 1, 2))
    after = _flat(sess.engine.pack_state(sess.handle)[0])
    rolled_back = all(np.array_equal(before[k], after[k]) for k in before)
    sess.apply(P.batch(stream, 1, 2))          # seam clear: still serving
    return summary(P, sess, rolled_back=rolled_back)


def case_chain_exhausted(P):
    stream = P.stream(ROWS)
    sess = P.api.bind_graph(_graph(P), backend=P.fast, failover=True, **P.kw)
    sess.apply(P.batch(stream, 0, 2))
    err_cls = KernelFailure if P is Port else repro.runtime.errors.KernelFailure
    with P.faults.inject("kernel_launch", times=None), \
            P.faults.inject("counter_sync", times=None,
                            exc=RuntimeError("sync dead"),
                            match=lambda ctx: ctx.get("engine") == P.plain):
        with pytest.raises(err_cls) as ei:
            sess.apply(P.batch(stream, 1, 2))
    h = sess.health.as_dict()
    return {"message": "failover chain" in str(ei.value),
            "kernel_failures": h["kernel_failures"],
            "failovers": h["failovers"],
            "last_error_kind": h["last_error_kind"]}


def case_armed(P):
    csr, stream = _graph(P), P.stream(ROWS)
    prog = P.program()
    sess = _no_reprobe(prog.bind(csr, backend=P.fast, failover=True,
                                 **P.kw))
    sess.run("DynSSSP", batchSize=2, src=0)                # arm
    with P.faults.inject("kernel_launch", times=None, match=_on_kernels(P)):
        res = sess.run_stream(stream, 2)
    return summary(P, sess, armed=sess.armed,
                   result_dist=res.props.host("dist"))


def case_reprobe(P):
    sess = P.api.bind_graph(_graph(P), backend=P.fast, failover=True, **P.kw)
    sess._failover.probe_base_s = 0.0           # probe immediately
    with P.faults.inject("kernel_launch", times=None, match=_on_kernels(P)):
        sess.run_stream(P.stream(ROWS), 2, _step, None)
    degraded = sess.health.degraded
    sess.apply(P.batch(P.stream([[6, 13, 1]]), 0, 2))
    return summary(P, sess, was_degraded=degraded)


CASES = {f.__name__[5:]: f for f in (
    case_kernel_launch, case_segment_scan, case_pool_merge,
    case_chained_start, case_no_failover, case_chain_exhausted, case_armed,
    case_reprobe)}


@pytest.fixture(scope="module", autouse=True)
def ref_cases():
    """repro's run of every case, started at the module's first test on
    one worker thread (the comparisons come last in the module, so the
    port's own tests run meanwhile)."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def run_all():
        out = {}
        for name, fn in CASES.items():
            r_faults.reset()
            out[name] = fn(Ref)
        r_faults.reset()
        return out

    fut = pool.submit(run_all)
    yield fut
    pool.shutdown(wait=True)


def _undisturbed_edges(adds, batch):
    sess = t_api.bind_graph(_graph(Port), backend="torch", device="cpu")
    sess.run_stream(Port.stream(adds), batch, _step, None)
    return _alive_edges(sess)


def _alive_edges(sess):
    tree, meta = sess.engine.pack_state(sess.handle)
    c, _ = state_to_csr(tree, meta, device="cpu")
    return sorted(zip(c.src.tolist(), c.dst.tolist(), c.w.tolist()))


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        if k == "state":
            assert sorted(got[k]) == sorted(want[k])
            for leaf in got[k]:
                np.testing.assert_array_equal(got[k][leaf], want[k][leaf],
                                              err_msg=leaf)
        elif isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_kernel_launch_failover_hops_twice_bit_exact():
    sess = t_api.bind_graph(_graph(Port), backend="cuda", failover=True,
                            device="cpu")
    with faults.inject("kernel_launch", times=None, match=_on_kernels(Port)):
        sess.run_stream(Port.stream(ROWS), 2, _step, None)
    h = sess.health
    assert sess.backend_name == "torch"
    assert h.degraded and h.failovers == 2 and h.kernel_failures == 2
    assert _alive_edges(sess) == _undisturbed_edges(ROWS, 2)


def test_fused_only_fault_stops_on_chained():
    """A fault that only the fused regime meets leaves the session on
    ``cuda_chained``, whose kernels then carry the stream."""
    sess = t_api.bind_graph(_graph(Port), backend="cuda", failover=True,
                            device="cpu")
    with faults.inject("kernel_launch", times=None,
                       match=lambda ctx: ctx.get("fused") is True):
        sess.run_stream(Port.stream(ROWS), 2, _step, None)
    assert sess.backend_name == "cuda_chained"
    assert sess.engine.name == "cuda" and not sess.engine.fused
    assert sess.health.failovers == 1
    assert _alive_edges(sess) == _undisturbed_edges(ROWS, 2)


def test_pool_merge_failover_bit_exact():
    sess = t_api.bind_graph(_graph(Port), backend="cuda", capacity=8,
                            failover=True, device="cpu")
    with faults.inject("pool_merge", times=1, match=_on_kernels(Port)):
        sess.run_stream(Port.stream(BIG), 8, _step, None)
    assert sess.health.failovers >= 1
    assert _alive_edges(sess) == _undisturbed_edges(BIG, 8)


def test_compiled_program_bind_fails_over_at_bind_time():
    """``CompiledProgram.bind(failover=...)`` comes up degraded when the
    requested backend cannot be constructed, on the requested device."""
    def broken(**kw):
        raise RuntimeError("no kernels here")

    t_registry.register_engine("broken_cuda", broken, overwrite=True)
    try:
        sess = Port.program().bind(_graph(Port), backend="broken_cuda",
                                   failover=("cuda_chained", "torch"),
                                   device="cpu")
        assert sess.backend_name == "cuda_chained"
        assert sess.device.type == "cpu"
        assert sess.health.degraded and sess.health.failovers == 1
        sess.run("DynSSSP", batchSize=2, src=0)
        sess.apply(Port.batch(Port.stream(ROWS), 0, 2))
        assert sess.armed
    finally:
        t_registry.unregister_engine("broken_cuda")


def test_bind_failover_chain_dedupes_order_preserving():
    calls = []

    def flaky_factory(**kw):
        calls.append("flaky_dup")
        raise RuntimeError("accelerator missing")

    t_registry.register_engine("flaky_dup", flaky_factory, overwrite=True)
    try:
        csr = _graph(Port)
        sess = t_api.bind_graph(
            csr, backend="flaky_dup",
            failover=("flaky_dup", "torch", "flaky_dup", "torch"),
            device="cpu")
        assert sess.backend_name == "torch"
        assert calls == ["flaky_dup"]
        assert sess.health.preferred_backend == "flaky_dup"
        calls.clear()
        with pytest.raises(KernelFailure) as ei:
            t_api.bind_graph(csr, backend="flaky_dup",
                             failover=("flaky_dup", "flaky_dup"),
                             device="cpu")
        assert calls == ["flaky_dup"]
        assert str(ei.value).count("flaky_dup") == 1
    finally:
        t_registry.unregister_engine("flaky_dup")


def test_dedupe_chain_order_preserving():
    assert t_api._dedupe_chain(("a", "b", "a", "c", "b")) == ("a", "b", "c")
    assert t_api._dedupe_chain(()) == ()
    assert t_api._dedupe_chain(("a", "b", "a")) == \
        r_api._dedupe_chain(("a", "b", "a"))


def test_failover_chain_mirrors_repro():
    from repro.core import registry as r_registry
    for ref, port in NAMES.items():
        want = tuple(NAMES[x] for x in r_registry.failover_chain(ref))
        assert t_registry.failover_chain(port) == want
    assert t_registry.failover_chain("custom") == ("torch",)


def test_migration_keeps_the_device_and_the_admission_mode():
    sess = t_api.bind_graph(_graph(Port), backend="cuda", failover=True,
                            admission="off", device="cpu")
    sess._migrate("torch")
    assert sess.engine.device.type == "cpu" and sess.engine.raw_ids


# ---------------------------------------------------------------------------
# harness mechanics and typed errors (copies of the reference's tests)
# ---------------------------------------------------------------------------

def test_injector_counts_and_scopes():
    with faults.inject("counter_sync", exc=RuntimeError("boom"),
                       after=1, times=1) as inj:
        faults.fire("counter_sync")            # skipped (after=1)
        with pytest.raises(RuntimeError):
            faults.fire("counter_sync")
        faults.fire("counter_sync")            # exhausted (times=1)
        assert inj.fired == 1 and inj.seen == 3
    faults.fire("counter_sync")
    assert faults.active() == {}
    assert faults.SEAMS == r_faults.SEAMS


def test_injector_match_and_unknown_seam():
    with pytest.raises(ValueError):
        faults.inject("not_a_seam").__enter__()
    with faults.inject("kernel_launch",
                       match=lambda ctx: ctx.get("engine") == "cuda"):
        faults.fire("kernel_launch", engine="torch")       # no match
        with pytest.raises(KernelFailure):
            faults.fire("kernel_launch", engine="cuda")


def test_eager_seam_fires_on_every_crossing():
    """The port has no trace step: ``after=2`` skips exactly two launch
    crossings of the update path, then every later one fires."""
    sess = t_api.bind_graph(_graph(Port), backend="cuda", device="cpu")
    stream = Port.stream(ROWS)
    with faults.inject("kernel_launch", times=None, after=2,
                       match=lambda c: c.get("op") == "update_add") as inj:
        sess.apply(Port.batch(stream, 0, 1))
        sess.apply(Port.batch(stream, 1, 1))
        with pytest.raises(KernelFailure):
            sess.apply(Port.batch(stream, 2, 1))
    assert inj.seen == 3 and inj.fired == 1


def test_error_taxonomy_roots():
    for cls in (AdmissionError, PoolOverflowError, KernelFailure,
                CheckpointCorrupt, DivergenceError):
        assert issubclass(cls, RuntimeFault)
        assert issubclass(cls, RuntimeError)


def test_pool_overflow_bounded_and_rolled_back():
    sess = t_api.bind_graph(_graph(Port), backend="torch", capacity=4,
                            device="cpu")
    sess.apply(Port.batch(Port.stream(ROWS), 0, 4))
    before = _alive_edges(sess)
    sess._max_grow_attempts = 3
    sess.engine.grow = lambda g, factor=2.0: g
    big = Port.stream([(i % 30, (i * 7 + 1) % 31, 1) for i in range(64)])
    with pytest.raises(PoolOverflowError) as ei:
        sess.apply(Port.batch(big, 0, 64))
    err = ei.value
    assert err.attempts == 3 and err.batch is not None
    assert len(err.counters) == 3
    assert sess.health.overflow_retries >= 3
    assert sess.health.last_error_kind == "PoolOverflowError"
    assert _alive_edges(sess) == before


def test_checkpoint_write_seam_and_corrupt_manifest(tmp_path):
    from repro_torch.ckpt import checkpoint as ckpt
    sess = t_api.bind_graph(_graph(Port), backend="torch", device="cpu")
    sess.apply(Port.batch(Port.stream(ROWS), 0, 4))
    with faults.inject("checkpoint_write", exc=OSError("disk gone"),
                       match=lambda ctx: ctx.get("point") == "manifest"):
        with pytest.raises(OSError):
            sess.save(tmp_path)
    assert ckpt.latest_step(tmp_path) is None
    sess.save(tmp_path)
    step = ckpt.latest_step(tmp_path)
    assert step is not None
    (tmp_path / f"step_{step:08d}" / "manifest.json").write_text("{ no")
    with pytest.raises(CheckpointCorrupt) as ei:
        t_api.restore_session(tmp_path, device="cpu")
    assert ei.value.step == step


def test_backoff_delay_shape():
    rng = random.Random(7)
    d0 = backoff_delay(0, base=0.5, cap=30.0, rng=rng)
    d4 = backoff_delay(4, base=0.5, cap=30.0, rng=rng)
    assert 0.25 <= d0 <= 0.5
    assert 4.0 <= d4 <= 8.0
    assert backoff_delay(50, base=0.5, cap=30.0, rng=rng) <= 30.0
    assert backoff_delay(3, base=0.0) == 0.0
    from repro.runtime.failover import backoff_delay as r_backoff
    for a in range(6):
        assert backoff_delay(a, rng=random.Random(a)) == \
            r_backoff(a, rng=random.Random(a))


def test_failover_policy_probe_windows():
    pol = FailoverPolicy("cuda", ("cuda_chained", "torch"),
                         probe_base_s=10.0)
    assert pol.candidates("cuda") == ["cuda_chained", "torch"]
    assert pol.candidates("cuda_chained") == ["torch"]
    assert pol.candidates("torch") == []
    pol.degraded_from(now=100.0)
    assert not pol.should_probe(now=101.0)
    assert pol.should_probe(now=100.0 + 3600.0)
    pol.probe_failed(now=200.0)
    assert not pol.should_probe(now=209.0)
    pol.recovered()
    assert not pol.should_probe(now=1e9)


def test_run_elastic_backs_off_and_restarts(monkeypatch):
    sleeps = []
    monkeypatch.setattr(elastic.time, "sleep", sleeps.append)
    calls = {"n": 0}

    def flaky(args):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "done"

    assert elastic.run_elastic(flaky, None, max_restarts=3,
                               backoff_s=0.5) == "done"
    assert len(sleeps) == 2 and all(s > 0 for s in sleeps)


def test_run_elastic_session_backs_off(monkeypatch):
    sleeps = []
    monkeypatch.setattr(elastic.time, "sleep", sleeps.append)
    made = []

    def make_session(attempt):
        made.append(attempt)
        return t_api.bind_graph(_graph(Port), backend="torch", device="cpu")

    def work(sess):
        if len(made) < 2:
            raise RuntimeError("lost host")
        sess.apply(Port.batch(Port.stream(ROWS), 0, 4))
        return "ok"

    assert elastic.run_elastic_session(make_session, work,
                                       max_restarts=2) == "ok"
    assert made == [0, 1]
    assert len(sleeps) == 1 and sleeps[0] > 0


# ---------------------------------------------------------------------------
# the public names of the package roots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ("", ".runtime", ".algos"))
def test_public_names_match_repro(module):
    """``repro_torch``, ``repro_torch.runtime`` and ``repro_torch.algos``
    export every name ``repro``'s do, and each resolves."""
    import importlib
    port = importlib.import_module("repro_torch" + module)
    ref = importlib.import_module("repro" + module)
    assert set(ref.__all__) <= set(port.__all__), \
        sorted(set(ref.__all__) - set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    if module == ".algos":
        assert sorted(port.STREAM_STEPS) == sorted(ref.STREAM_STEPS)
        assert port.STREAM_STEPS["sssp"] is port.sssp.stream_step


# ---------------------------------------------------------------------------
# the failover cases against repro's (last: repro's thread runs meanwhile)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_failover_case_matches_repro(name, ref_cases):
    got = CASES[name](Port)
    assert got.get("rolled_back", True)
    _assert_same(got, ref_cases.result()[name])
