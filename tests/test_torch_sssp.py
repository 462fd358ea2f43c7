"""The whole slice — dynamic SSSP through ``bind_graph`` — held against
repro on the CPU: repro's ``pallas`` backend (Pallas in interpret mode)
against repro_torch's ``cuda`` backend (kernel wrappers on their plain
versions) and ``torch`` backend, on the conformance scenarios of
tests/conformance.py and on a pool overflow.  dist, parent, every
DynGraph array and the ELL pack are compared bit for bit, and dist
against the numpy oracle."""
import concurrent.futures
import dataclasses

import numpy as np
import jax
import pytest
import torch

import repro
from repro.algos import sssp as r_sssp
import repro_torch
from repro_torch.algos import oracles
from repro_torch.algos import sssp as t_sssp
from repro_torch.core.engine import props_from_numpy
from conformance import Scenario, digraph_scenario

SCENARIOS = ["batch1", "batch8", "batch64", "empty", "self_loops",
             "dup_in_batch", "del_then_readd", "overflow"]
HANDLE = ("g", "ell")


def scenario(name):
    if name == "overflow":
        # a 4-slot pool for ~9 fresh adds: grow-and-replay mid-stream
        return dataclasses.replace(digraph_scenario("batch8"),
                                   name="overflow", diff_capacity=4)
    return digraph_scenario(name)


def host_tree(obj):
    """Dataclass fields (recursively) as numpy arrays, ints as ints; the
    port's derived fields (the ELL's vertex row offsets, which repro's
    pack does not keep) are left out."""
    if dataclasses.is_dataclass(obj):
        return {f.name: host_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if not f.metadata.get("derived")}
    if isinstance(obj, torch.Tensor):
        return obj.cpu().numpy()
    return obj if isinstance(obj, int) else np.array(obj)


def port_stream(sc):
    return repro_torch.UpdateStream(adds=sc.stream.adds, dels=sc.stream.dels)


def halves(sc):
    """The stream cut after its first half of batches (reference type)."""
    half = sc.stream.num_batches(sc.batch_size) // 2 + 1
    return (sc.stream.window(sc.batch_size, 0, half),
            sc.stream.window(sc.batch_size, half, 1 << 20))


def run_ref(sc, backend="pallas", split=False):
    """repro's run; with ``split`` the stream runs in two halves and the
    packed state and props between them (numpy leaves) come back too."""
    csr = repro.graph.build_csr(sc.n, sc.edges, sc.w)
    sess = repro.bind_graph(csr, backend=backend, capacity=sc.diff_capacity)
    props = sess.call(r_sssp.static_sssp, sc.src)
    mid = None
    for i, part in enumerate(halves(sc) if split else (sc.stream,)):
        # a split run scans one batch per segment: one compile, not two
        props = sess.run_stream(part, sc.batch_size, r_sssp.stream_step,
                                props, segment_size=1 if split else 8)
        if split and i == 0:
            tree, meta = sess.engine.pack_state(sess.handle)
            mid = (jax.tree_util.tree_map(np.asarray, tree), meta,
                   {k: np.asarray(v) for k, v in props.items()})
    return {k: np.asarray(v) for k, v in props.items()}, \
        host_tree(sess.handle), mid


def run_port(sc, backend):
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    sess = repro_torch.bind_graph(csr, backend=backend,
                                  capacity=sc.diff_capacity, device="cpu")
    props = sess.call(t_sssp.static_sssp, sc.src)
    props = sess.run_stream(port_stream(sc), sc.batch_size,
                            t_sssp.stream_step, props)
    return {k: v.numpy() for k, v in props.items()}, \
        host_tree(sess.handle)


def segment_scenario(kind):
    """Eight batches of 4 fresh adds and 4 deletes on batch8's graph: one
    segment of the reference's stream executor (``segment_size=8``).

    * ``overflow``: a 14-slot pool; batches 0-2 fill 12 slots and batch 3
      overflows it, mid-segment.
    * ``compact``: batches 0-1 delete base edges and batch k >= 2 deletes
      batch k-2's adds, so 4(k-1) pool rows are dead after batch k; with
      36 slots that crosses ``compact_frac`` (18) in batch 6,
      mid-segment."""
    base = digraph_scenario("batch8")
    n, e = base.n, base.edges
    rng = np.random.default_rng(31)
    taken, fresh = set(map(tuple, e.tolist())), []
    while len(fresh) < 32:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        if u != v and (u, v) not in taken:
            taken.add((u, v))
            fresh.append((u, v))
    fresh = np.asarray(fresh)
    adds = np.concatenate([fresh, rng.integers(1, 50, (32, 1))], axis=1)
    if kind == "overflow":
        dels, cap = e[rng.choice(len(e), 32, replace=False)], 14
    else:
        dels = np.concatenate([e[rng.choice(len(e), 8, replace=False)],
                               fresh[:24]])
        cap = 36
    stream = type(base.stream)(adds=adds.astype(np.int32),
                               dels=dels.astype(np.int32))
    return Scenario(f"segment_{kind}", n, e, base.w, stream, batch_size=4,
                    diff_capacity=cap)


SEGMENT_KINDS = ["overflow", "compact"]


@pytest.fixture(scope="module")
def segment_refs():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return dict(zip(SEGMENT_KINDS, pool.map(
            lambda kind: run_ref(segment_scenario(kind)), SEGMENT_KINDS)))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("kind", SEGMENT_KINDS)
def test_stream_executor_keeps_segments(segment_refs, kind, backend):
    """An overflow or a compaction that falls due inside a segment of 8
    batches is handled at the segment's end, as the reference's executor
    does: the pool and ELL layouts and dist/parent agree bit for bit."""
    sc = segment_scenario(kind)
    want_props, want_handle, _ = segment_refs[kind]
    props, handle = run_port(sc, backend)
    for k in ("dist", "parent", "modified"):
        assert np.array_equal(props[k], want_props[k]), k
    assert_tree_equal(want_handle if backend == "cuda" else
                      want_handle["g"], handle)
    g = handle if backend == "torch" else handle["g"]
    if kind == "overflow":
        assert g["d_src"].shape[0] > sc.diff_capacity


@pytest.fixture(scope="module")
def refs():
    """repro's pallas-backend results, once per scenario; batch1 runs its
    stream in two halves and keeps the state between them.  XLA compiles
    outside the interpreter lock, so four threads overlap the scenarios'
    compilations."""
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        out = pool.map(lambda name: run_ref(scenario(name),
                                            split=name == "batch1"),
                       SCENARIOS)
        return dict(zip(SCENARIOS, out))


def assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, int):
        assert a == b, path
    else:
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_slice_matches_reference(refs, name, backend):
    sc = scenario(name)
    want_props, want_handle, _ = refs[name]
    props, handle = run_port(sc, backend)
    for k in ("dist", "parent", "modified"):
        assert np.array_equal(props[k], want_props[k]), k
    # the cuda handle is the pallas one (graph + ELL pack); the torch
    # handle is the bare graph
    assert_tree_equal(want_handle if backend == "cuda" else
                      want_handle["g"], handle)
    edges, w = oracles.edges_after_updates(sc.n, sc.edges, sc.w,
                                           sc.stream.adds, sc.stream.dels)
    assert np.array_equal(props["dist"],
                          oracles.sssp_oracle(sc.n, edges, w, sc.src))


CHAINED_SCENARIOS = ["batch8", "del_then_readd", "overflow"]


@pytest.fixture(scope="module")
def chained_refs():
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        return dict(zip(CHAINED_SCENARIOS, pool.map(
            lambda name: run_ref(scenario(name), backend="pallas_chained"),
            CHAINED_SCENARIOS)))


@pytest.mark.parametrize("name", CHAINED_SCENARIOS)
def test_chained_matches_reference(chained_refs, name):
    """cuda_chained (relax_rowmin → vertex combine → relax_rowargmin, the
    scatter path for adds) against repro's pallas_chained, bit for bit."""
    want_props, want_handle, _ = chained_refs[name]
    props, handle = run_port(scenario(name), "cuda_chained")
    for k in ("dist", "parent", "modified"):
        assert np.array_equal(props[k], want_props[k]), k
    assert_tree_equal(want_handle, handle)


def test_overflow_scenario_grows_the_pool():
    """The overflow case really exercises grow-and-replay."""
    sc = scenario("overflow")
    _, handle = run_port(sc, "cuda")
    assert handle["g"]["d_src"].shape[0] > sc.diff_capacity


@pytest.mark.parametrize("kinds", [("jnp", "torch"), ("pallas", "cuda")])
def test_state_carries_over(refs, kinds):
    """repro prepares and updates a graph and packs its state; the port
    unpacks it (numpy leaves) and continues the stream; both end slot for
    slot alike."""
    ref_backend, port_backend = kinds
    sc = scenario("batch1")
    want_props, want_handle, mid = (
        refs["batch1"] if ref_backend == "pallas" else
        run_ref(sc, backend=ref_backend, split=True))
    tree, meta, host_props = mid
    engine = repro_torch.make_engine(port_backend, device="cpu")
    assert engine.state_kind == meta["kind"]
    handle = engine.unpack_state(tree, meta)
    rest = halves(sc)[1]
    handle, props = engine.run_stream(
        handle, repro_torch.UpdateStream(adds=rest.adds, dels=rest.dels),
        sc.batch_size, t_sssp.stream_step,
        props_from_numpy(host_props, device="cpu"))
    for k in ("dist", "parent"):
        assert np.array_equal(props[k].numpy(), want_props[k]), k
    assert_tree_equal(want_handle, host_tree(handle))
    if port_backend == "cuda":
        with pytest.raises(ValueError, match="k=4"):
            engine.unpack_state(tree, dict(meta, k=4))


def test_session_paths_match():
    """``apply`` batch by batch, and ``run_stream`` over a stream with a
    poison batch that the default ``clamp`` guard sanitizes (an
    out-of-range id and a negative weight), give the reference's graph,
    properties and health counters (the session layer is backend-neutral:
    ``jnp`` against ``torch``)."""
    sc = scenario("batch8")
    adds = sc.stream.adds.copy()
    adds[5] = (sc.n + 3, 1, 5)            # batch 1 of 4-lane batches
    adds[6, 2] = -4
    poisoned = (sc.stream.__class__(adds=adds, dels=sc.stream.dels),
                repro_torch.UpdateStream(adds=adds, dels=sc.stream.dels))
    r_csr = repro.graph.build_csr(sc.n, sc.edges, sc.w)
    t_csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    r_sess = repro.bind_graph(r_csr, backend="jnp", capacity=16)
    t_sess = repro_torch.bind_graph(t_csr, backend="torch", capacity=16,
                                    device="cpu")
    r_p = r_sess.call(r_sssp.static_sssp, sc.src)
    t_p = t_sess.call(t_sssp.static_sssp, sc.src)
    r_p = r_sess.run_stream(poisoned[0], 4, r_sssp.stream_step, r_p)
    t_p = t_sess.run_stream(poisoned[1], 4, t_sssp.stream_step, t_p)
    for k in ("dist", "parent"):
        assert np.array_equal(np.asarray(r_p[k]), t_p[k].numpy()), k
    assert_tree_equal(host_tree(r_sess.handle), host_tree(t_sess.handle))
    for k in ("admitted", "clamped", "quarantined", "pool_grows"):
        assert getattr(r_sess.health, k) == getattr(t_sess.health, k), k
    assert t_sess.health.clamped == 1
    # structural apply, one batch at a time (deletes then adds)
    for i in range(sc.stream.num_batches(4)):
        r_sess.apply(sc.stream.batch(i, 4))
        t_sess.apply(port_stream(sc).batch(i, 4, device="cpu"))
    assert_tree_equal(host_tree(r_sess.handle), host_tree(t_sess.handle))
    assert r_sess.stream_cursor == t_sess.stream_cursor


def test_engine_helpers_match():
    """The engine surface around the sweep: out-degrees, batch edge
    flags, the host merge, read_props, state_to_csr and the read set."""
    from repro.core import engine as r_engine
    from repro_torch.core import engine as t_engine
    sc = scenario("self_loops")
    r = repro.core.registry.make_engine("jnp")
    t = repro_torch.make_engine("torch", device="cpu")
    g_r = r.prepare(repro.graph.build_csr(sc.n, sc.edges, sc.w), 8)
    g_t = t.prepare(repro_torch.build_csr(sc.n, sc.edges, sc.w,
                                          device="cpu"), 8)
    assert np.array_equal(np.asarray(r.out_degrees(g_r)),
                          t.out_degrees(g_t).numpy())
    q = sc.edges[::3][:8].astype(np.int32)
    mask = np.arange(len(q)) % 3 != 0
    assert np.array_equal(
        np.asarray(r.batch_edge_flags(g_r, q[:, 0], q[:, 1], mask)),
        t.batch_edge_flags(g_t, torch.from_numpy(q[:, 0].copy()),
                           torch.from_numpy(q[:, 1].copy()),
                           torch.from_numpy(mask)).numpy())
    assert_tree_equal(host_tree(r.merge(g_r)), host_tree(t.merge(g_t)))
    tree, meta = r.pack_state(g_r)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    csr_r, cap_r = r_engine.state_to_csr(tree, meta)
    csr_t, cap_t = t_engine.state_to_csr(tree, meta, device="cpu")
    assert cap_r == cap_t
    assert_tree_equal(host_tree(csr_r), host_tree(csr_t))
    props = t_sssp.init_props(t, sc.src)
    assert t.read_props(props)["dist"].shape == (sc.n,)
    want = r_sssp._relax_sweep().read_set(r_sssp.init_props(r, sc.src))
    assert t_sssp._relax_sweep().read_set(props) == want == {"dist",
                                                             "modified"}


def test_cuda_engine_sweep_refuses_a_bare_graph():
    """The cuda engine sweeps only over its handle (graph plus ELL pack):
    a bare DynGraph raises instead of taking the plain segment path."""
    sc = scenario("batch1")
    e = repro_torch.make_engine("cuda", device="cpu")
    h = e.prepare(repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu"),
                  8)
    props = t_sssp.init_props(e, sc.src)
    with pytest.raises(TypeError, match="CudaHandle"):
        e._run_sweep(h.g, t_sssp._relax_sweep(), props)
    assert e._run_sweep(h, t_sssp._relax_sweep(), props)["dist"].shape == \
        (sc.n,)


@pytest.mark.parametrize("ref_backend,port_backend", [("pallas", "cuda"),
                                                      ("jnp", "torch")])
def test_admission_off_out_of_range_ids(ref_backend, port_backend):
    """With ``admission="off"`` no guard masks bad ids, so the engines see
    them: adds and deletes with ids past n, equal to n (the pool's vacant
    sentinel) and negative, spread over the batches; the add from -5 enters
    the diff pool, so the pack holds a negative source that the row kernels
    gather.  The port gives the reference's dist, parent, graph and pack.
    (Before the fix the torch engine raised on an add with dst == n: its
    segment reductions and gathers indexed out of range where JAX drops
    and clamps.)"""
    sc = scenario("batch8")
    n = sc.n
    bad_adds = np.array([[n + 3, 1, 5], [1, n + 3, 5], [-2, 1, 5],
                         [2, n, 5], [n, 2, 5], [3, -1, 7], [-5, 2, 1]],
                        np.int32)
    bad_dels = np.array([[n + 1, 0], [0, -1], [n, 3], [5, n]], np.int32)
    adds = np.insert(sc.stream.adds, [1, 2, 3, 5, 6, 8, 8], bad_adds,
                     axis=0)
    dels = np.insert(sc.stream.dels, [0, 3, 5, 8], bad_dels, axis=0)
    stream = sc.stream.__class__(adds=adds, dels=dels)
    r_csr = repro.graph.build_csr(n, sc.edges, sc.w)
    t_csr = repro_torch.build_csr(n, sc.edges, sc.w, device="cpu")
    r_sess = repro.bind_graph(r_csr, backend=ref_backend, capacity=32,
                              admission="off")
    t_sess = repro_torch.bind_graph(t_csr, backend=port_backend, capacity=32,
                                    admission="off", device="cpu")
    r_p = r_sess.run_stream(stream, 4, r_sssp.stream_step,
                            r_sess.call(r_sssp.static_sssp, sc.src))
    t_p = t_sess.run_stream(
        repro_torch.UpdateStream(adds=adds, dels=dels), 4,
        t_sssp.stream_step, t_sess.call(t_sssp.static_sssp, sc.src))
    for k in ("dist", "parent"):
        assert np.array_equal(np.asarray(r_p[k]), t_p[k].numpy()), k
    assert_tree_equal(host_tree(r_sess.handle), host_tree(t_sess.handle))


@pytest.mark.parametrize("admission,raw", [("off", True), (None, True),
                                           ("clamp", False),
                                           ("reject", False),
                                           ("quarantine", False)])
def test_raw_id_semantics_follow_admission(admission, raw):
    """Only a session that admits batches unchecked gets JAX's out-of-range
    semantics in its sweeps (and pays for them); a checked one keeps the
    plain gathers and reductions."""
    sc = scenario("batch1")
    sess = repro_torch.bind_graph(
        repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu"),
        backend="torch", admission=admission, device="cpu")
    assert sess.engine.raw_ids is raw
