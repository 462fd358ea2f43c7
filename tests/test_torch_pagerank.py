"""Slice 2 — dynamic PageRank through ``bind_graph`` — held against repro
on the CPU: repro_torch's ``cuda`` backend (kernel wrappers on their
plain versions) against repro's ``pallas`` (Pallas in interpret mode),
the port's ``torch`` against repro's ``jnp``, and the chained regime
``cuda_chained`` against ``cuda``, on the PageRank scenarios of
tests/conformance.py with the conformance knobs (beta 1e-4, delta 0.85,
100 sweeps at most).

Float sums follow another association in each package (the Pallas
kernel's row reduction, XLA's segment sums), so port and reference agree
to rtol 1e-5 / atol 1e-6, not bit for bit.  Inside the port the order is
fixed: two runs, and the fused and chained regimes (the same row sums
through the same segment sum), are bit-identical.  Every backend meets
the oracle at the conformance tolerances (rtol 5e-2, atol 1e-4)."""
import concurrent.futures

import jax
import numpy as np
import pytest
import torch

import repro
from repro.algos import pagerank as r_pr
import repro_torch
from repro_torch.algos import oracles
from repro_torch.algos import pagerank as t_pr
from repro_torch.core.engine import props_from_numpy
from conformance import digraph_scenario

PR_SCENARIOS = ["batch1", "batch8", "batch64", "del_then_readd"]
KNOBS = (1e-4, 0.85, 100)            # beta, delta, max_iter
PAIRS = {"cuda": "pallas", "torch": "jnp"}
RTOL, ATOL = 1e-5, 1e-6


def port_stream(sc, stream=None):
    s = sc.stream if stream is None else stream
    return repro_torch.UpdateStream(adds=s.adds, dels=s.dels)


def halves(sc):
    half = sc.stream.num_batches(sc.batch_size) // 2 + 1
    return (sc.stream.window(sc.batch_size, 0, half),
            sc.stream.window(sc.batch_size, half, 1 << 20))


def run_ref(name, backend, split=False):
    """repro's pr; with ``split`` the stream runs in two halves (one batch
    per segment) and the packed state and props between them come back
    too."""
    sc = digraph_scenario(name)
    sess = repro.bind_graph(repro.graph.build_csr(sc.n, sc.edges, sc.w),
                            backend=backend, capacity=sc.diff_capacity)
    props = sess.call(r_pr.static_pr, *KNOBS)
    step, mid = r_pr.make_stream_step(*KNOBS), None
    for i, part in enumerate(halves(sc) if split else (sc.stream,)):
        props = sess.run_stream(part, sc.batch_size, step, props,
                                segment_size=1 if split else 8)
        if split and i == 0:
            tree, meta = sess.engine.pack_state(sess.handle)
            mid = (jax.tree_util.tree_map(np.asarray, tree), meta,
                   {k: np.asarray(v) for k, v in props.items()})
    return np.asarray(props["pr"]), mid


def run_port(name, backend):
    sc = digraph_scenario(name)
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    sess = repro_torch.bind_graph(csr, backend=backend,
                                  capacity=sc.diff_capacity, device="cpu")
    props = sess.call(t_pr.static_pr, *KNOBS)
    props = sess.run_stream(port_stream(sc), sc.batch_size,
                            t_pr.make_stream_step(*KNOBS), props)
    return props["pr"].numpy()


@pytest.fixture(scope="module")
def refs():
    """repro's pr per (scenario, backend); batch1 on pallas runs its stream
    in two halves and also keeps the state between them.  XLA compiles
    outside the interpreter lock, so threads overlap the compilations."""
    jobs = [(name, backend) for name in PR_SCENARIOS
            for backend in PAIRS.values()]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        out = pool.map(lambda j: run_ref(*j, split=j == ("batch1", "pallas")),
                       jobs)
        return dict(zip(jobs, out))


@pytest.fixture(scope="module")
def ports():
    return {(name, backend): run_port(name, backend)
            for name in PR_SCENARIOS
            for backend in ("cuda", "cuda_chained", "torch")}


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("name", PR_SCENARIOS)
def test_pagerank_matches_reference(refs, ports, name, backend):
    want, _ = refs[(name, PAIRS[backend])]
    got = ports[(name, backend)]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", PR_SCENARIOS)
def test_pagerank_chained_equals_fused(ports, name):
    """Both regimes sum the same row sums through the same segment sum."""
    assert np.array_equal(ports[(name, "cuda_chained")],
                          ports[(name, "cuda")])


@pytest.mark.parametrize("backend", ["cuda", "cuda_chained", "torch"])
@pytest.mark.parametrize("name", PR_SCENARIOS)
def test_pagerank_matches_oracle(ports, name, backend):
    sc = digraph_scenario(name)
    edges, _ = oracles.edges_after_updates(sc.n, sc.edges, sc.w,
                                           sc.stream.adds, sc.stream.dels)
    want = oracles.pagerank_oracle(sc.n, edges, *KNOBS)
    np.testing.assert_allclose(ports[(name, backend)], want, rtol=5e-2,
                               atol=1e-4)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_pagerank_runs_are_bit_identical(ports, backend):
    assert np.array_equal(run_port("batch8", backend),
                          ports[("batch8", backend)])


def test_pagerank_state_carries_over(refs):
    """repro's pallas runs the first half of batch1's stream and packs its
    state; the port's cuda engine unpacks it (numpy leaves) with the float
    props and finishes the stream within rtol 1e-5 of repro's run over the
    whole stream."""
    sc = digraph_scenario("batch1")
    want, (tree, meta, host_props) = refs[("batch1", "pallas")]
    engine = repro_torch.make_engine("cuda", device="cpu")
    assert engine.state_kind == meta["kind"] == "pallas"
    handle = engine.unpack_state(tree, meta)
    props = props_from_numpy(host_props, device="cpu")
    assert props["pr"].dtype == torch.float32
    _, props = engine.run_stream(handle, port_stream(sc, halves(sc)[1]),
                                 sc.batch_size, t_pr.make_stream_step(*KNOBS),
                                 props)
    np.testing.assert_allclose(props["pr"].numpy(), want, rtol=RTOL,
                               atol=ATOL)


def test_stream_step_is_cached():
    assert t_pr.make_stream_step(*KNOBS) is t_pr.make_stream_step(*KNOBS)


@pytest.mark.parametrize("ref_backend,port_backend", [("pallas", "cuda"),
                                                      ("jnp", "torch")])
def test_admission_off_out_of_range_ids_pagerank(ref_backend, port_backend):
    """PageRank with ``admission="off"``: adds and deletes with ids past
    n, equal to n and negative (the add from -5 enters the diff pool, the
    one to -3 lands in the pack with a negative destination) reach the
    engines unchecked.  The port gives the reference's pr, to the float
    tolerance of this file, and its graph and pack bit for bit."""
    from test_torch_sssp import assert_tree_equal, host_tree
    sc = digraph_scenario("batch8")
    n = sc.n
    bad_adds = np.array([[n + 3, 1, 5], [1, n + 3, 5], [-2, 1, 5],
                         [2, n, 5], [n, 2, 5], [3, -3, 7], [-5, 2, 1]],
                        np.int32)
    bad_dels = np.array([[n + 1, 0], [0, -1], [n, 3], [5, n]], np.int32)
    adds = np.insert(sc.stream.adds, [1, 2, 3, 5, 6, 8, 8], bad_adds,
                     axis=0)
    dels = np.insert(sc.stream.dels, [0, 3, 5, 8], bad_dels, axis=0)
    r_sess = repro.bind_graph(repro.graph.build_csr(n, sc.edges, sc.w),
                              backend=ref_backend, capacity=32,
                              admission="off")
    t_sess = repro_torch.bind_graph(
        repro_torch.build_csr(n, sc.edges, sc.w, device="cpu"),
        backend=port_backend, capacity=32, admission="off", device="cpu")
    r_p = r_sess.run_stream(sc.stream.__class__(adds=adds, dels=dels), 4,
                            r_pr.make_stream_step(*KNOBS),
                            r_sess.call(r_pr.static_pr, *KNOBS))
    t_p = t_sess.run_stream(repro_torch.UpdateStream(adds=adds, dels=dels),
                            4, t_pr.make_stream_step(*KNOBS),
                            t_sess.call(t_pr.static_pr, *KNOBS))
    np.testing.assert_allclose(t_p["pr"].numpy(), np.asarray(r_p["pr"]),
                               rtol=RTOL, atol=ATOL)
    assert_tree_equal(host_tree(r_sess.handle), host_tree(t_sess.handle))
