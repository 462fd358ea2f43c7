"""Checkpoints of the port on the CPU: the commit protocol under a crash
at each of its points, checkpoints crossing between repro and the port
in both directions (``jnp`` ↔ ``torch``, ``pallas`` ↔ ``cuda``: the same
state kinds, so the restore is exact), and armed sessions that resume
without re-running their prologue."""
import concurrent.futures

import numpy as np
import pytest

import repro
import repro_torch
from repro_torch import dsl_programs
from repro_torch.api import restore_session
from repro_torch.ckpt import checkpoint as t_ckpt
from repro_torch.core.dsl import codegen as t_codegen
from repro_torch.core.engine import TorchEngine
from repro_torch.core.registry import UnknownBackendError
from conformance import digraph_scenario, sym_scenario

SC = "del_then_readd"          # three batches of one update each
KINDS = [("jnp", "torch"), ("pallas", "cuda")]


def leaves(tree, prefix=""):
    """A nested dict of arrays / tensors as {path: numpy array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.cpu().numpy() if hasattr(tree, "cpu")
            else np.asarray(tree)}


def assert_same(a, b):
    a, b = leaves(a), leaves(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def port_batches(sc):
    stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                      dels=sc.stream.dels)
    return list(stream.batches(sc.batch_size, device="cpu"))


def port_armed(sc, backend, batches):
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    sess = repro_torch.compile(dsl_programs.path("sssp")).bind(
        csr, backend=backend, capacity=sc.diff_capacity, device="cpu")
    sess.run("DynSSSP", batchSize=sc.batch_size, src=sc.src)
    for b in batches:
        sess.apply(b)
    return sess


def ref_armed(sc, backend, k=None):
    from conformance import program
    csr = repro.graph.build_csr(sc.n, sc.edges, sc.w)
    sess = program("sssp").bind(csr, backend=backend,
                                capacity=sc.diff_capacity)
    sess.run("DynSSSP", batchSize=sc.batch_size, src=sc.src)
    for b in list(sc.stream.batches(sc.batch_size))[:k]:
        sess.apply(b)
    return sess


def ref_state(sess):
    """dist and the packed handle of a repro session, as numpy."""
    tree, _ = sess.engine.pack_state(sess.handle)
    return sess.props.host("dist"), leaves(tree)


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """For each reference backend: its uninterrupted armed run, and a
    checkpoint it saved after the first batch."""
    sc = digraph_scenario(SC)

    def full(backend):
        return ref_state(ref_armed(sc, backend))

    def saved(backend, d):
        ref_armed(sc, backend, k=1).save(d)
        return d

    refs = [r for r, _ in KINDS]
    # the directories come first, from this thread: pytest's temporary
    # directory factory is not safe to call from several threads at once
    dirs = [tmp_path_factory.mktemp(f"ref_{r}") for r in refs]
    with concurrent.futures.ThreadPoolExecutor(2 * len(refs)) as pool:
        fulls = [pool.submit(full, r) for r in refs]
        saves = [pool.submit(saved, r, d) for r, d in zip(refs, dirs)]
        return {r: (f.result(), d.result())
                for r, f, d in zip(refs, fulls, saves)}


@pytest.mark.parametrize("ref,port", KINDS)
def test_reference_checkpoint_finishes_in_the_port(ref_runs, ref, port):
    sc = digraph_scenario(SC)
    (want_dist, want_tree), d = ref_runs[ref]
    with pytest.raises(UnknownBackendError, match="cuda_chained"):
        restore_session(d, device="cpu")
    sess = restore_session(d, backend=port, device="cpu")
    assert sess.armed and sess.stream_cursor == 1
    for b in port_batches(sc)[1:]:
        sess.apply(b)
    np.testing.assert_array_equal(sess.props.host("dist"), want_dist)
    tree, _ = sess.engine.pack_state(sess.handle)
    got = leaves(tree)
    for k, v in want_tree.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got[k].dtype == v.dtype, k


@pytest.mark.parametrize("ref,port", KINDS)
def test_port_checkpoint_finishes_in_the_reference(ref_runs, tmp_path, ref,
                                                   port):
    import repro.api as api
    sc = digraph_scenario(SC)
    batches = port_batches(sc)
    port_armed(sc, port, batches[:1]).save(tmp_path)
    full = port_armed(sc, port, batches)
    sess = api.restore_session(tmp_path, backend=ref)
    assert sess.armed and sess.stream_cursor == 1
    for b in list(sc.stream.batches(sc.batch_size))[1:]:
        sess.apply(b)
    dist, tree = ref_state(sess)
    np.testing.assert_array_equal(dist, full.props.host("dist"))
    np.testing.assert_array_equal(dist, ref_runs[ref][0][0])
    want = leaves(full.engine.pack_state(full.handle)[0])
    for k, v in tree.items():
        np.testing.assert_array_equal(want[k], v, err_msg=k)


@pytest.mark.parametrize("point", ["shard", "manifest", "committed",
                                   "renamed"])
def test_crash_at_each_commit_point(tmp_path, point):
    """A kill at any point of the commit protocol leaves the last
    committed step restorable (the rename is the commit: after it the
    new step is the last)."""
    sc = digraph_scenario(SC)
    batches = port_batches(sc)
    sess = port_armed(sc, "cuda", batches[:1])
    sess.save(tmp_path)
    first = sess.props.to_host()
    sess.apply(batches[1])
    second = sess.props.to_host()

    def crash(p):
        if p == point:
            raise KeyboardInterrupt(p)

    t_ckpt._crash_point = crash
    try:
        with pytest.raises(KeyboardInterrupt):
            sess.save(tmp_path)
    finally:
        t_ckpt._crash_point = None
    step = t_ckpt.latest_step(tmp_path)
    assert step == (2 if point == "renamed" else 1)
    back = restore_session(tmp_path, device="cpu")
    want = second if point == "renamed" else first
    for k, v in want.items():
        np.testing.assert_array_equal(back.props.host(k), v, err_msg=k)
    # the survivor finishes the stream as the uninterrupted session does
    for b in batches[back.stream_cursor:]:
        back.apply(b)
    full = port_armed(sc, "cuda", batches)
    assert_same(back.engine.pack_state(back.handle)[0],
                full.engine.pack_state(full.handle)[0])


def test_armed_resume_skips_the_prologue(tmp_path, monkeypatch):
    """restore_session rebuilds the paused Batch loop from the saved
    frame: no prologue statement and no sweep runs before the first
    apply, and the run ends as the uninterrupted one."""
    sc = digraph_scenario(SC)
    batches = port_batches(sc)
    port_armed(sc, "torch", batches[:1]).save(tmp_path)
    full = port_armed(sc, "torch", batches)

    def forbidden(*a, **k):
        raise AssertionError("the prologue ran again")

    with monkeypatch.context() as m:
        m.setattr(t_codegen.StagedFunc, "begin", forbidden)
        m.setattr(t_codegen.Executor, "exec_stmt", forbidden)
        m.setattr(TorchEngine, "fixed_point", forbidden)
        sess = restore_session(tmp_path, device="cpu")
    assert sess.armed and sess.stream_cursor == 1
    for b in batches[1:]:
        sess.apply(b)
    for k, v in full.props.to_host().items():
        np.testing.assert_array_equal(sess.props.host(k), v, err_msg=k)


@pytest.mark.parametrize("prog,func,backend", [
    ("pagerank", "DynPR", "cuda"), ("tc", "DynTC", "torch")])
def test_armed_save_restore_is_bit_exact(tmp_path, prog, func, backend):
    """Floats too: a same-backend restore keeps the pool and ELL layout,
    so PageRank resumes bit for bit; TC's armed frame carries its count
    and its (unbound) edge properties."""
    if prog == "tc":
        sc = sym_scenario("sym_del_readd")
        args = {"batchSize": sc.batch_size}
    else:
        sc = digraph_scenario("batch1")
        args = {"batchSize": sc.batch_size, "beta": 1e-4, "delta": 0.85,
                "maxIter": 100}
    batches = port_batches(sc)
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    compiled = repro_torch.compile(dsl_programs.path(prog))

    def armed(bs):
        sess = compiled.bind(csr, backend=backend, capacity=sc.diff_capacity,
                             device="cpu")
        sess.run(func, **args)
        for b in bs:
            sess.apply(b)
        return sess

    k = len(batches) // 2
    armed(batches[:k]).save(tmp_path)
    full = armed(batches)
    sess = restore_session(tmp_path, device="cpu")
    for b in batches[k:]:
        sess.apply(b)
    if prog == "tc":
        assert int(sess.value) == int(full.value)
        assert sess.value.dtype == full.value.dtype
    else:
        for k_, v in full.props.to_host().items():
            np.testing.assert_array_equal(sess.props.host(k_), v,
                                          err_msg=k_)
    assert_same(sess.engine.pack_state(sess.handle)[0],
                full.engine.pack_state(full.handle)[0])
