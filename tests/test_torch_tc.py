"""Triangle counting in the port held against repro on the CPU: the
hand-staged ``static_tc``, ``dyn_tc`` and ``dyn_tc_stream`` of
``repro_torch.algos.triangles`` on the ``torch``, ``cuda`` and
``cuda_chained`` backends (kernel wrappers on their plain versions)
against repro's ``jnp`` and ``pallas`` backends and the numpy oracle, on
the TC scenarios of tests/conformance.py.  Counts are compared in value
and in dtype (int32, the reference's).  repro's counts come from its
stream executor, whose jitted segments compile once; its per-batch
``dyn_tc`` recompiles its wedge loops every batch and agrees with it
(tests/test_conformance.py)."""
import concurrent.futures

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.algos import oracles
from repro.algos import triangles as r_tc
from repro_torch.algos import triangles as t_tc
from repro_torch.core.registry import make_engine
from conformance import digraph_scenario, sym_scenario

TC_SCENARIOS = ["sym_batch2", "sym_batch16", "sym_empty", "sym_del_readd"]
BACKENDS = ["torch", "cuda", "cuda_chained"]


def run_ref(name, backend):
    """repro's (static count, final count) with their dtypes."""
    import jax.numpy as jnp
    sc = sym_scenario(name)
    csr = repro.graph.build_csr(sc.n, sc.edges, sc.w)
    sess = repro.bind_graph(csr, backend=backend, capacity=sc.diff_capacity)
    c0 = sess.call(r_tc.static_tc)
    count = sess.run_stream(sc.stream, sc.batch_size, r_tc.stream_step,
                            jnp.asarray(c0, jnp.int32), segment_size=4)
    return (int(c0), str(c0.dtype)), (int(count), str(count.dtype))


@pytest.fixture(scope="module")
def refs():
    cells = [(n, b) for n in TC_SCENARIOS for b in ("jnp", "pallas")]
    # XLA compiles outside the interpreter lock: the cells overlap
    with concurrent.futures.ThreadPoolExecutor(len(cells)) as pool:
        return dict(zip(cells, pool.map(lambda c: run_ref(*c), cells)))


def port_session(sc, backend):
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    return repro_torch.bind_graph(csr, backend=backend,
                                  capacity=sc.diff_capacity, device="cpu")


def port_stream(sc):
    return repro_torch.UpdateStream(adds=sc.stream.adds, dels=sc.stream.dels)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", TC_SCENARIOS)
def test_tc_matches_reference(refs, name, backend):
    sc = sym_scenario(name)
    e2, _ = oracles.edges_after_updates(sc.n, sc.edges, sc.w,
                                        sc.stream.adds, sc.stream.dels)
    final = oracles.tc_oracle(sc.n, e2)
    base = oracles.tc_oracle(sc.n, sc.edges)
    for ref in ("jnp", "pallas"):
        (c0, d0), (c1, d1) = refs[(name, ref)]
        assert (c0, c1, d0, d1) == (base, final, "int32", "int32"), ref

    sess = port_session(sc, backend)
    static = sess.call(t_tc.static_tc)
    dyn = sess.call(t_tc.dyn_tc, port_stream(sc), sc.batch_size)
    # the stream executor, with dyn_tc_stream's own static count
    streamed = port_session(sc, backend).call(
        t_tc.dyn_tc_stream, port_stream(sc), sc.batch_size, segment_size=4)
    for got, want in ((static, base), (dyn, final), (streamed, final)):
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == want


def _engine_and_graph(backend, name="sym_batch16"):
    """An engine and its graph, with a pool of 32 slots for the
    scenario's 16 adds a batch."""
    sc = sym_scenario(name)
    eng = make_engine(backend, device="cpu")
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    return sc, eng, eng.prepare(csr, 32)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sssp_and_pagerank_streams_read_no_degree(backend):
    """Only wedge enumeration reads a max degree: SSSP and PageRank
    streams, through the engine's stream executor and through a
    session's ``run_stream``, make no such host read."""
    from repro_torch.algos import pagerank as t_pr
    from repro_torch.algos import sssp as t_sssp
    sc = digraph_scenario("batch8")
    stream = port_stream(sc)
    eng = make_engine(backend, device="cpu")
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    t_sssp.dyn_sssp_stream(eng, eng.prepare(csr, sc.diff_capacity), 0,
                           stream, sc.batch_size, segment_size=4)
    t_pr.dyn_pr_stream(eng, eng.prepare(csr, sc.diff_capacity), stream,
                       sc.batch_size, segment_size=4)
    assert eng.deg_syncs == 0
    sess = port_session(sc, backend)
    props = sess.call(t_sssp.static_sssp, 0)
    sess.run_stream(stream, sc.batch_size, t_sssp.stream_step, props)
    assert sess._engine.deg_syncs == 0


def test_degree_cache_reads_the_host_once_per_offsets_tensor():
    """One host read per offsets tensor: repeated counts on one handle
    read nothing; a deletion keeps both offsets tensors; an add batch
    rebuilds d_offsets only, which costs one read."""
    sc, eng, g = _engine_and_graph("torch")
    t_tc.static_tc(eng, g)
    assert eng.deg_syncs == 2                   # main, diff
    t_tc.static_tc(eng, g)
    assert eng.deg_syncs == 2
    batch = port_stream(sc).batch(0, sc.batch_size, device="cpu")
    g = eng.update_del(g, batch)
    t_tc.static_tc(eng, g)
    assert eng.deg_syncs == 2
    g = eng.update_add(g, batch)
    t_tc.static_tc(eng, g)
    assert eng.deg_syncs == 3
    # a whole stream step: the pre-deletion count reads nothing new, the
    # post-addition count reads the new pool once
    batch = port_stream(sc).batch(0, sc.batch_size, device="cpu")
    before = eng.deg_syncs
    g, _ = t_tc.stream_step(eng, g, batch, torch.zeros((), dtype=torch.int32))
    assert eng.deg_syncs == before + 1
