"""The conformance check of tests/conformance.py for the port's DSL
sessions, with repro's Session as a fifth leg, on the CPU:

    repro_torch Session  ==  its deprecated Program.run shim (bit-exact)
                         ==  the numpy oracle
                         ==  the port's hand-staged algorithm
                         ==  repro's Session on the same program

for SSSP, PageRank and TC on the ``torch``, ``cuda`` (kernel wrappers on
their plain versions) and ``frontier`` backends, and on ``dist`` and
``dist_sharded`` (stacked shards) over ``DIST_FAST``.  Integers are bit-exact; PageRank
meets the conformance tolerances against the oracle and rtol 1e-5
against repro.  An armed session fed the stream batch by batch equals
the one-shot run bit for bit."""
import concurrent.futures
import warnings

import numpy as np
import pytest
import torch

import repro_torch
from repro.algos import oracles
from repro.graph import build_csr as r_build_csr
from repro_torch import dsl_programs
from repro_torch.algos import pagerank as t_pr
from repro_torch.algos import sssp as t_sssp
from repro_torch.algos import triangles as t_tc
from repro_torch.core.registry import make_engine
from conformance import digraph_scenario, program, sym_scenario

BACKENDS = ["torch", "cuda", "frontier"]
PR_KNOBS = {"beta": 1e-4, "delta": 0.85, "maxIter": 100}
# (algorithm, program, function, scenario); the cells repro's per-batch
# DSL runs can afford on the CPU
CELLS = [("sssp", "sssp", "DynSSSP", s)
         for s in ("batch8", "batch64", "empty", "del_then_readd")] + \
        [("pagerank", "pagerank", "DynPR", s)
         for s in ("batch8", "del_then_readd")] + \
        [("tc", "tc", "DynTC", s) for s in ("sym_batch16", "sym_del_readd")]
OUT = {"sssp": "dist", "pagerank": "pageRank"}
# the distributed backends run a fast subset, as repro's matrix keeps
# DIST_FAST: one SSSP, one PageRank and one TC cell each (the cells of
# CELLS, so repro's sessions are computed once)
DIST_BACKENDS = {"dist": {"num_shards": 2},
                 "dist_sharded": {"num_shards": 3}}
DIST_FAST = [CELLS[0], CELLS[4], CELLS[6]]


def scenario(algo, name):
    return sym_scenario(name) if algo == "tc" else digraph_scenario(name)


def run_args(algo, sc, stream):
    args = {"updateBatch": stream, "batchSize": sc.batch_size}
    if algo == "sssp":
        args["src"] = sc.src
    elif algo == "pagerank":
        args.update(PR_KNOBS)
    return args


def run_ref(cell):
    """repro's Session on the jnp backend: (props as numpy, value)."""
    algo, prog, func, name = cell
    sc = scenario(algo, name)
    csr = r_build_csr(sc.n, sc.edges, sc.w)
    sess = program(prog).bind(csr, backend="jnp", capacity=sc.diff_capacity)
    res = sess.run(func, **run_args(algo, sc, sc.stream))
    value = None if res.value is None else (int(res.value),
                                            str(res.value.dtype))
    return res.to_host(), value


@pytest.fixture(scope="module")
def refs():
    # XLA compiles outside the interpreter lock: the cells overlap
    with concurrent.futures.ThreadPoolExecutor(len(CELLS)) as pool:
        return dict(zip(CELLS, pool.map(run_ref, CELLS)))


def oracle(algo, sc):
    e2, w2 = oracles.edges_after_updates(sc.n, sc.edges, sc.w,
                                         sc.stream.adds, sc.stream.dels)
    if algo == "sssp":
        return oracles.sssp_oracle(sc.n, e2, w2, sc.src)
    if algo == "pagerank":
        return oracles.pagerank_oracle(sc.n, e2, beta=PR_KNOBS["beta"],
                                       delta=PR_KNOBS["delta"],
                                       max_iter=PR_KNOBS["maxIter"])
    return oracles.tc_oracle(sc.n, e2)


def hand_staged(algo, sc, backend, csr, stream):
    sess = repro_torch.bind_graph(csr, backend=backend,
                                  capacity=sc.diff_capacity, device="cpu")
    if algo == "sssp":
        sess.call(t_sssp.dyn_sssp, sc.src, stream, sc.batch_size)
        return sess.props.host("dist")
    if algo == "pagerank":
        sess.call(t_pr.dyn_pr, stream, sc.batch_size,
                  beta=PR_KNOBS["beta"], delta=PR_KNOBS["delta"],
                  max_iter=PR_KNOBS["maxIter"])
        return sess.props.host("pr")
    return int(sess.call(t_tc.dyn_tc, stream, sc.batch_size))


def check(algo, got, want, what, rtol=5e-2, atol=1e-4):
    if algo == "sssp":
        np.testing.assert_array_equal(
            np.minimum(got.astype(np.int64), oracles.INF),
            np.minimum(want.astype(np.int64), oracles.INF), err_msg=what)
    elif algo == "pagerank":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)
    else:
        assert got == want, what


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[3]}")
def test_session_conformance(refs, cell, backend):
    _conformance(refs, cell, backend)


@pytest.mark.parametrize("backend", DIST_BACKENDS)
@pytest.mark.parametrize("cell", DIST_FAST, ids=lambda c: f"{c[0]}-{c[3]}")
def test_dist_session_conformance(refs, cell, backend):
    """The distributed backends on the fast subset, their sessions on
    stacked shards."""
    _conformance(refs, cell, backend, **DIST_BACKENDS[backend])


def _conformance(refs, cell, backend, **opts):
    algo, prog, func, name = cell
    sc = scenario(algo, name)
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                      dels=sc.stream.dels)
    compiled = repro_torch.compile(dsl_programs.path(prog))
    sess = compiled.bind(csr, backend=backend, capacity=sc.diff_capacity,
                         device="cpu", **opts)
    res = sess.run(func, **run_args(algo, sc, stream))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        # the shim's engine is on one shard, as repro's matrix builds it:
        # Program.run has no overflow backstop (in either package), so a
        # halo miss of dist_sharded on more shards would go unserviced
        shim = compiled.program.run(func, make_engine(backend, device="cpu"),
                                    csr, args=run_args(algo, sc, stream),
                                    diff_capacity=sc.diff_capacity)
    ref_props, ref_value = refs[cell]
    want = oracle(algo, sc)
    if algo == "tc":
        got = int(res.value)
        assert res.value.dtype == torch.int32 and res.value.shape == ()
        assert (got, "int32") == ref_value, "session != repro's session"
        assert int(shim.value) == got, "session != Program.run shim"
    else:
        got = res.to_host()[OUT[algo]]
        if algo == "pagerank" and opts.get("num_shards", 1) > 1:
            # sums over other shard counts re-associate
            np.testing.assert_allclose(got, shim.props[OUT[algo]],
                                       rtol=1e-5, atol=0,
                                       err_msg="session != Program.run shim")
        else:
            np.testing.assert_array_equal(
                got, shim.props[OUT[algo]],
                err_msg="session != Program.run shim")
        assert got.dtype == ref_props[OUT[algo]].dtype
        if algo == "sssp":
            for k in ("dist", "parent"):
                np.testing.assert_array_equal(
                    res.to_host()[k], ref_props[k],
                    err_msg=f"session {k} != repro's session")
        else:
            np.testing.assert_allclose(got, ref_props["pageRank"],
                                       rtol=1e-5, atol=0,
                                       err_msg="session != repro's session")
    check(algo, got, want, "session != oracle")
    check(algo, hand_staged(algo, sc, backend, csr, stream), want,
          "hand-staged != oracle")

    # armed: the prologue, then one apply per batch == the one-shot run
    armed = compiled.bind(csr, backend=backend, capacity=sc.diff_capacity,
                          device="cpu", **opts)
    args = run_args(algo, sc, None)
    del args["updateBatch"]
    armed.run(func, **args)
    assert armed.armed
    for batch in stream.batches(sc.batch_size, device="cpu"):
        armed.apply(batch)
    if algo == "tc":
        assert int(armed.value) == got and armed.value.dtype == torch.int32
    else:
        for k, v in res.to_host().items():
            np.testing.assert_array_equal(armed.props.host(k), v,
                                          err_msg=f"armed {k} != one-shot")
    assert armed.stream_cursor == stream.num_batches(sc.batch_size)


@pytest.mark.parametrize("backend", BACKENDS)
def test_armed_session_grows_the_pool(backend):
    """An armed DynSSSP whose batch overflows a 4-slot pool rolls its
    frame back, grows the pool and replays the batch: it ends as a run
    with room to spare does, and oracle-exact."""
    sc = digraph_scenario("batch8")
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                      dels=sc.stream.dels)
    compiled = repro_torch.compile(dsl_programs.path("sssp"))
    roomy = compiled.bind(csr, backend=backend, capacity=64, device="cpu")
    want = roomy.run("DynSSSP", **run_args("sssp", sc, stream)).to_host()
    armed = compiled.bind(csr, backend=backend, capacity=4, device="cpu")
    armed.run("DynSSSP", batchSize=sc.batch_size, src=sc.src)
    for batch in stream.batches(sc.batch_size, device="cpu"):
        armed.apply(batch)
    assert armed.health.pool_grows >= 1
    assert armed.engine.handle_graph(armed.handle).diff_capacity > 4
    for k in ("dist", "parent"):
        np.testing.assert_array_equal(armed.props.host(k), want[k],
                                      err_msg=k)
    check("sssp", want["dist"], oracle("sssp", sc), "grown run != oracle")
