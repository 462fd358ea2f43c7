"""The port's fused stream executor on the CPU, against repro's fused
``run_stream`` (one jitted ``lax.scan`` per segment):

* ``UpdateStream.stacked`` leaf for leaf against repro's;
* fused ``run_stream`` on ``torch``, ``cuda`` (kernel wrappers on their
  plain versions) and ``frontier`` against repro's on ``jnp``: SSSP and TC
  bit for bit, PageRank within rtol 1e-5, with segments of 1, 3 and 8
  batches giving the same bits;
* overflow inside a segment (a tiny pool): rolled back, grown and replayed
  equal to repro with the same capacities, the old shape's segment runner
  evicted; a compaction at a segment's end; the ``segment_scan`` seam
  crossed once per segment;
* graph safety: one segment body run with ``device_loop`` in its capture
  mode under a dispatch mode that fails on any host read
  (``aten._local_scalar_dense``) or dynamic shape (``aten.nonzero``).

On the CPU a segment runs batch by batch (``device_loop.EagerSegment``),
the body that the card captures as one graph.  repro's runs go through
one worker thread at the file's first test."""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro
import repro_torch
from repro.algos import pagerank as r_pr
from repro.algos import sssp as r_sssp
from repro.algos import triangles as r_tc
from repro_torch.algos import pagerank as t_pr
from repro_torch.algos import sssp as t_sssp
from repro_torch.algos import triangles as t_tc
from repro_torch.core import device_loop
from repro_torch.core.engine import Engine
from repro_torch.kernels import segment as t_segment
from repro_torch.runtime import faults
from conformance import sym_scenario

BATCH = 8
SEG = 3
PR_KNOBS = (1e-4, 0.85, 100)
BACKENDS = ["torch", "cuda", "frontier"]
FIELDS = ("add_src", "add_dst", "add_w", "add_mask", "del_src", "del_dst",
          "del_mask")
DYN = ("offsets", "src", "dst", "w", "alive", "d_offsets", "d_src", "d_dst",
       "d_w", "d_alive", "overflow")
TINY = 4                   # a diff pool that overflows in the first segment


def rmat():
    n, edges, w = repro_torch.rmat_graph(7, 8, seed=0)
    csr = repro_torch.build_csr(n, edges, w, device="cpu")
    return n, edges, w, repro_torch.random_updates(csr, percent=5, seed=1)


def compact_stream(n, edges):
    """Three batches of 8: fresh edges F added in batch 0 are deleted in
    batch 1 (tombstones in the pool), G added in 1 deleted in 2."""
    rng = np.random.default_rng(5)
    have = set(map(tuple, edges.tolist()))
    fresh = []
    while len(fresh) < 24:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        if u != v and (u, v) not in have:
            have.add((u, v))
            fresh.append((u, v))
    fresh = np.asarray(fresh, np.int32)
    adds = np.concatenate([fresh, rng.integers(1, 50, (24, 1))], 1)
    dels = np.concatenate([edges[:8], fresh[:16]]).astype(np.int32)
    return repro_torch.UpdateStream(adds=adds.astype(np.int32), dels=dels)


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def r_stream(stream):
    return repro.graph.UpdateStream(adds=stream.adds, dels=stream.dels)


def ref_sssp(cap=None, compact=False, **kw):
    n, edges, w, stream = rmat()
    if compact:
        stream = compact_stream(n, edges)
    sess = repro.bind_graph(repro.graph.build_csr(n, edges, w),
                            backend="jnp",
                            capacity=cap or 2 * stream.num_adds)
    p = sess.call(r_sssp.static_sssp, 0)
    p = sess.run_stream(r_stream(stream), BATCH, r_sssp.stream_step, p,
                        segment_size=2 if compact else SEG, **kw)
    return ({k: host(p[k]) for k in ("dist", "parent")},
            {f: host(getattr(sess.handle, f)) for f in DYN})


def run_ref():
    out = {"sssp": ref_sssp(), "overflow": ref_sssp(cap=TINY),
           "compact": ref_sssp(compact=True, compact_frac=0.0)}
    n, edges, w, stream = rmat()
    sess = repro.bind_graph(repro.graph.build_csr(n, edges, w),
                            backend="jnp", capacity=2 * stream.num_adds)
    p = sess.call(r_pr.static_pr, *PR_KNOBS)
    p = sess.run_stream(r_stream(stream), BATCH,
                        r_pr.make_stream_step(*PR_KNOBS), p,
                        segment_size=SEG)
    out["pagerank"] = host(p["pr"])
    sc = sym_scenario("sym_batch16")
    sess = repro.bind_graph(repro.graph.build_csr(sc.n, sc.edges, sc.w),
                            backend="jnp", capacity=sc.diff_capacity)
    c = sess.call(r_tc.static_tc)
    c = sess.run_stream(sc.stream, 4, r_tc.stream_step, c, segment_size=SEG)
    out["tc"] = (int(c), str(c.dtype))
    return out


@pytest.fixture(scope="module")
def ref():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(run_ref).result()


def port_session(backend, cap=None):
    n, edges, w, stream = rmat()
    csr = repro_torch.build_csr(n, edges, w, device="cpu")
    sess = repro_torch.bind_graph(csr, backend=backend,
                                  capacity=cap or 2 * stream.num_adds,
                                  device="cpu")
    return sess, stream


@pytest.mark.parametrize("bs,start,count", [(5, 0, None), (5, 1, 3),
                                            (7, 2, 2), (4, 0, 6)])
def test_stacked_matches_reference(bs, start, count):
    rng = np.random.default_rng(bs + start)
    adds = np.concatenate([rng.integers(0, 50, (23, 2)),
                           rng.integers(-3, 100, (23, 1))], 1).astype(
        np.int32)
    dels = rng.integers(0, 50, (17, 2)).astype(np.int32)
    t = repro_torch.UpdateStream(adds=adds, dels=dels)
    got = t.stacked(bs, start, count, device="cpu")
    want = repro.graph.UpdateStream(adds=adds, dels=dels).stacked(
        bs, start, count)
    for f in FIELDS:
        g, w = host(getattr(got, f)), host(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for j in range(got.add_src.shape[0]):
        one = t.batch(start + j, bs, device="cpu")
        for f in FIELDS:
            assert torch.equal(getattr(got.row(j), f), getattr(one, f)), f


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_sssp_bit_exact_for_every_segment_size(ref, backend):
    want, want_g = ref["sssp"]
    for seg in (1, 3, 8):
        sess, stream = port_session(backend)
        p = sess.call(t_sssp.static_sssp, 0)
        p = sess.run_stream(stream, BATCH, t_sssp.stream_step, p,
                            segment_size=seg)
        for k in want:
            np.testing.assert_array_equal(host(p[k]), want[k],
                                          err_msg=f"{k} segment {seg}")
        g = sess.engine.handle_graph(sess.handle)
        for f in DYN:
            np.testing.assert_array_equal(host(getattr(g, f)), want_g[f],
                                          err_msg=f"g.{f} segment {seg}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_pagerank_within_rtol_for_every_segment_size(ref, backend):
    got = []
    for seg in (1, 3, 8):
        sess, stream = port_session(backend)
        p = sess.call(t_pr.static_pr, *PR_KNOBS)
        p = sess.run_stream(stream, BATCH, t_pr.make_stream_step(*PR_KNOBS),
                            p, segment_size=seg)
        np.testing.assert_allclose(host(p["pr"]), ref["pagerank"],
                                   rtol=1e-5, atol=0)
        got.append(p["pr"])
    assert all(torch.equal(got[0], x) for x in got[1:])


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_tc_bit_exact_for_every_segment_size(ref, backend):
    sc = sym_scenario("sym_batch16")
    stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                      dels=sc.stream.dels)
    for seg in (1, 3, 8):
        csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
        sess = repro_torch.bind_graph(csr, backend=backend,
                                      capacity=sc.diff_capacity,
                                      device="cpu")
        c = sess.call(t_tc.static_tc)
        c = sess.run_stream(stream, 4, t_tc.stream_step, c,
                            segment_size=seg)
        assert (int(c), str(host(c).dtype)) == ref["tc"], seg


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_overflow_rolls_back_grows_and_replays(ref, backend):
    """A pool of TINY slots overflows inside the first segment: the
    segment rolls back to its start, the pool grows, the segment replays;
    every array equals repro's with the same capacities, and the runner of
    the old shape is gone."""
    want, want_g = ref["overflow"]
    sess, stream = port_session(backend, cap=TINY)
    p = sess.call(t_sssp.static_sssp, 0)
    eng = sess.engine
    shapes = []
    grow = eng.grow

    def spy(h, *a, **kw):
        shapes.append(eng._handle_shape_key(h))
        return grow(h, *a, **kw)

    eng.grow = spy
    p = sess.run_stream(stream, BATCH, t_sssp.stream_step, p,
                        segment_size=SEG)
    assert shapes and shapes[0][1] == TINY
    for k in want:
        np.testing.assert_array_equal(host(p[k]), want[k], err_msg=k)
    g = eng.handle_graph(sess.handle)
    assert g.diff_capacity > TINY
    for f in DYN:
        np.testing.assert_array_equal(host(getattr(g, f)), want_g[f],
                                      err_msg=f)
    for key in eng._stream_cache:
        assert not any(s in key for s in shapes), key


def test_compaction_at_segment_end(ref):
    """Tombstones in the pool at a segment's end compact it there (two
    segments of two and one batches, two compactions), as in repro."""
    want, want_g = ref["compact"]
    n, edges, w, _ = rmat()
    stream = compact_stream(n, edges)
    sess, _ = port_session("cuda", cap=2 * stream.num_adds)
    p = sess.call(t_sssp.static_sssp, 0)
    eng = sess.engine
    calls = []
    compact = eng.compact_handle
    eng.compact_handle = lambda h: calls.append(1) or compact(h)
    p = sess.run_stream(stream, BATCH, t_sssp.stream_step, p,
                        segment_size=2, compact_frac=0.0)
    assert len(calls) == 2
    for k in want:
        np.testing.assert_array_equal(host(p[k]), want[k], err_msg=k)
    for f in DYN:
        np.testing.assert_array_equal(host(getattr(sess.handle.g, f)),
                                      want_g[f], err_msg=f)


@pytest.mark.parametrize("seg", [1, 3, 8])
def test_segment_scan_seam_once_per_segment(seg):
    sess, stream = port_session("cuda")
    p = sess.call(t_sssp.static_sssp, 0)
    nb = stream.num_batches(BATCH)
    with faults.inject("segment_scan", times=0) as seam:
        sess.run_stream(stream, BATCH, t_sssp.stream_step, p,
                        segment_size=seg)
    assert seam.seen == -(-nb // seg)


def test_per_batch_baseline_equals_fused():
    """``Engine.run_stream``, the reference's per-batch baseline, gives
    the fused executor's bits (no overflow here)."""
    sess, stream = port_session("cuda")
    p0 = sess.call(t_sssp.static_sssp, 0)
    eng, h0 = sess.engine, sess.handle
    he, pe = Engine.run_stream(eng, h0, stream, BATCH, t_sssp.stream_step,
                               p0)
    hf, pf = eng.run_stream(h0, stream, BATCH, t_sssp.stream_step, p0)
    for k in pe:
        assert torch.equal(pe[k], pf[k]), k
    for f in DYN:
        assert torch.equal(getattr(he.g, f), getattr(hf.g, f)), f


class NoHostReads(TorchDispatchMode):
    """Fails on any op that reads a tensor on the host or makes a shape
    from data: what a captured graph cannot hold."""

    BANNED = (torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.nonzero.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED:
            raise AssertionError(f"host read in a step body: {func}")
        return func(*args, **(kwargs or {}))


def _sum_no_reads(vals, order, offsets):
    """The float segment sum without the plain version's host loop (its
    kernel has none); order of adds aside, the same sums."""
    x = vals if order is None else vals[order.to(torch.int64)]
    num = offsets.shape[0] - 1
    # lanes past offsets[num] (unused ELL rows) land in a spare segment
    seg = torch.searchsorted(offsets[1:], torch.arange(
        x.shape[0], dtype=offsets.dtype), right=True)
    return torch.zeros(num + 1, dtype=vals.dtype).index_add_(
        0, seg, x)[:num]


@pytest.mark.parametrize("algo,backend", [
    ("sssp", "torch"), ("sssp", "cuda"), ("sssp", "cuda_chained"),
    ("sssp", "frontier"), ("pagerank", "cuda"), ("pagerank", "torch"),
    ("tc", "torch"), ("tc", "cuda")])
def test_segment_body_is_graph_safe(monkeypatch, algo, backend):
    """Run one segment body as a capture does (every loop and branch
    through ``device_loop`` in its capture mode) and fail on any host
    read: a ``bool()``, ``.item()`` or data-dependent shape left in a
    step body would stop a CUDA graph capture on the card."""
    monkeypatch.setattr(t_segment, "segment_sum_sorted_plain",
                        _sum_no_reads)
    if algo == "tc":
        sc = sym_scenario("sym_batch16")
        stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                          dels=sc.stream.dels)
        csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
        sess = repro_torch.bind_graph(csr, backend=backend,
                                      capacity=sc.diff_capacity,
                                      device="cpu")
        carry, step, bs = sess.call(t_tc.static_tc), t_tc.stream_step, 4
    else:
        sess, stream = port_session(backend)
        bs = BATCH
        if algo == "sssp":
            carry, step = sess.call(t_sssp.static_sssp, 0), \
                t_sssp.stream_step
        else:
            carry = sess.call(t_pr.static_pr, *PR_KNOBS)
            step = t_pr.make_stream_step(*PR_KNOBS)
    eng, handle = sess.engine, sess.handle
    k = min(SEG, stream.num_batches(bs))
    run = eng._segment_runner(step, handle, carry, bs, k)
    batches = stream.stacked(bs, 0, k, device="cpu")
    cap = device_loop.Capture("cpu")
    with device_loop.capture(cap), NoHostReads():
        h, c = run.body(handle, carry, batches)
    assert cap.nodes > 0
    assert type(h) is type(handle)
    for a, b in zip(device_loop.tensors(carry), device_loop.tensors(c)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_while_loop_and_cond_modes():
    """Eager: the host loop and branch.  Dry capture (CPU): each body once,
    the branch selected on the device, no host read."""
    st = (0, torch.arange(4))
    cond_fn = lambda s: s[1].sum() < 50
    body_fn = lambda s: (s[0] + 1, s[1] * 2 + 1)
    i, v = device_loop.while_loop(cond_fn, body_fn, st)
    assert i == 3 and v.tolist() == [7, 15, 23, 31]
    assert device_loop.cond(v.sum() > 7, lambda o: o + 1, lambda o: o - 1,
                            v).tolist() == [8, 16, 24, 32]
    cap = device_loop.Capture("cpu")
    with device_loop.capture(cap), NoHostReads():
        i, v = device_loop.while_loop(cond_fn, body_fn, st)
        o = device_loop.cond(v.sum() > 7, lambda o: o + 1, lambda o: o - 1,
                             v)
    assert cap.nodes == 3 and cap.trips[:3].tolist() == [1, 1, 1]
    assert int(i) == 1 and v.tolist() == [1, 3, 5, 7]
    assert o.tolist() == [2, 4, 6, 8]


def test_assign_copies_through_aliases():
    """A loop state whose new leaves alias other buffers (a swap) is
    copied through temporaries, so no leaf reads an overwritten one."""
    a, b = torch.arange(3), torch.arange(3, 6)
    bufs = {"a": a, "b": b}
    written = device_loop.assign(bufs, {"a": b, "b": a})
    assert bufs["a"].tolist() == [3, 4, 5] and bufs["b"].tolist() == [0, 1, 2]
    assert len(written) == 2
    with pytest.raises(ValueError, match="changed"):
        device_loop.assign(bufs, {"a": torch.zeros(2), "b": b})
    batch = repro_torch.UpdateStream(
        adds=np.zeros((2, 3), np.int32),
        dels=np.zeros((2, 2), np.int32)).stacked(2, device="cpu")
    assert [f.name for f in dataclasses.fields(batch)] == list(FIELDS)


def test_every_kernel_module_registers_its_launch_counts():
    """Each kernel module's ``LAUNCHES`` is its table in
    ``_build.LAUNCH_TABLES``, the one list that the captured segments'
    tallies read: a launch counted in any of them shows in a tally."""
    import importlib
    import pkgutil

    import repro_torch.kernels as kernels
    from repro_torch.kernels import _build
    mods = [importlib.import_module(f"repro_torch.kernels.{m.name}")
            for m in pkgutil.iter_modules(kernels.__path__)]
    with_counts = [m for m in mods if hasattr(m, "LAUNCHES")]
    assert len(with_counts) == 5
    for m in with_counts:
        assert _build.LAUNCH_TABLES[m.__name__] is m.LAUNCHES
        name = next(iter(m.LAUNCHES))
        before = device_loop._read()
        m.LAUNCHES[name] += 2
        tally = device_loop._since(before)
        device_loop._reset(before)
        assert tally == {m.__name__: {name: 2}}
        assert device_loop.tally_names(tally) == {name: 2}
        assert m.LAUNCHES == before[m.__name__]


@pytest.mark.parametrize("row_max", [0, 1, 5, 64])
def test_device_loop_search_rounds_match_fixed_rounds(row_max):
    """A captured wedge walk searches the diff pool in a device loop of
    bit_length(max degree) rounds (``engine._device_rounds``); run on the
    host it gives the fixed-round search's positions, and loops exactly
    that many times."""
    from repro_torch.core.engine import _device_rounds, _max_degree
    from repro_torch.graph.csr import row_searchsorted
    rng = np.random.default_rng(row_max)
    deg = rng.integers(0, row_max + 1, 40)
    deg[7] = row_max
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])).int()
    vals = torch.from_numpy(np.concatenate(
        [np.sort(rng.integers(0, 50, d)) for d in deg]).astype(np.int32))
    rows = torch.from_numpy(rng.integers(0, 40, 300)).int()
    lo, hi = offsets[rows.long()], offsets[rows.long() + 1]
    q = torch.from_numpy(rng.integers(-2, 53, 300)).int()
    want = row_searchsorted(vals, lo, hi, q, row_max.bit_length())
    loop = _device_rounds(_max_degree(offsets))
    trips = []
    got = row_searchsorted(
        vals, lo, hi, q,
        lambda step, st: loop(lambda s: trips.append(1) or step(s), st))
    assert torch.equal(got, want)
    assert torch.equal(want, row_searchsorted(vals, lo, hi, q, 32))
    assert len(trips) == row_max.bit_length()
