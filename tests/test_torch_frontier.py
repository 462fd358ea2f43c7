"""The port's ``frontier`` backend on the CPU, against repro's ``frontier``:

* ``pack_push_ell`` slot for slot, fresh and after each batch of deletes
  and adds (revivals patched in place, pool appends repacked);
* SSSP (static and stream) and TC bit for bit, PageRank within rtol 1e-5;
  on this graph SSSP's static fixed point takes both sparse steps and
  dense chunks, counted through the ``kernel_launch`` seam and the
  engine's ``steps``;
* ``pack_state`` / ``unpack_state``, the refusal of another ``k``, and
  checkpoints crossing to and from repro's ``frontier`` engine;
* the failover chain ``frontier -> torch``.

repro's runs go through one worker thread at the file's first test."""
import concurrent.futures

import numpy as np
import pytest
import torch

import repro
import repro.api
import repro_torch
from repro.algos import pagerank as r_pr
from repro.algos import sssp as r_sssp
from repro.algos import triangles as r_tc
from repro.core.frontier_engine import FrontierEngine as RFrontier
from repro_torch.algos import pagerank as t_pr
from repro_torch.algos import sssp as t_sssp
from repro_torch.algos import triangles as t_tc
from repro_torch.api import restore_session
from repro_torch.core.frontier_engine import FrontierEngine
from repro_torch.core.registry import available_backends, failover_chain
from repro_torch.runtime import faults
from conformance import digraph_scenario, sym_scenario

BATCH = 16
PR_KNOBS = (1e-4, 0.85, 100)
PUSH_FIELDS = ("ell_src", "ell_w", "row2dst", "lane2slot")
DYN = ("offsets", "src", "dst", "w", "alive", "d_offsets", "d_src", "d_dst",
       "d_w", "d_alive", "overflow")


def rmat():
    n, edges, w = repro_torch.rmat_graph(7, 8, seed=0)
    csr = repro_torch.build_csr(n, edges, w, device="cpu")
    stream = repro_torch.random_updates(csr, percent=5, seed=1)
    return n, edges, w, stream


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ref_stream(stream):
    return repro.graph.UpdateStream(adds=stream.adds, dels=stream.dels)


def run_ref():
    """repro's frontier runs: SSSP static and stream, PageRank, TC."""
    n, edges, w, stream = rmat()
    csr = repro.graph.build_csr(n, edges, w)
    cap = 2 * stream.num_adds
    out = {}
    sess = repro.bind_graph(csr, backend="frontier", capacity=cap)
    p = sess.call(r_sssp.static_sssp, 0)
    out["static"] = {k: host(p[k]) for k in ("dist", "parent")}
    p = sess.run_stream(ref_stream(stream), BATCH, r_sssp.stream_step, p)
    out["stream"] = {k: host(p[k]) for k in ("dist", "parent")}
    out["stream_g"] = {f: host(getattr(sess.handle.g, f)) for f in DYN}
    sess = repro.bind_graph(csr, backend="frontier", capacity=cap)
    p = sess.call(r_pr.static_pr, *PR_KNOBS)
    p = sess.run_stream(ref_stream(stream), BATCH,
                        r_pr.make_stream_step(*PR_KNOBS), p)
    out["pr"] = host(p["pr"])
    sc = sym_scenario("sym_batch16")
    sess = repro.bind_graph(repro.graph.build_csr(sc.n, sc.edges, sc.w),
                            backend="frontier", capacity=sc.diff_capacity)
    c = sess.call(r_tc.static_tc)
    out["tc_static"] = int(c)
    c = sess.run_stream(sc.stream, sc.batch_size, r_tc.stream_step, c)
    out["tc"] = (int(c), str(c.dtype))
    return out


@pytest.fixture(scope="module")
def ref():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(run_ref).result()


def port_session(n, edges, w, stream, **kw):
    csr = repro_torch.build_csr(n, edges, w, device="cpu")
    return repro_torch.bind_graph(csr, backend="frontier",
                                  capacity=2 * stream.num_adds,
                                  device="cpu", **kw)


def test_frontier_is_registered_and_fails_over_to_torch():
    assert "frontier" in available_backends()
    assert failover_chain("frontier") == ("torch",)
    eng = repro_torch.make_engine("frontier", device="cpu")
    assert isinstance(eng, FrontierEngine) and eng.k == 8
    assert eng.stream_view().fixed_point.__qualname__.startswith(
        "_DenseStreamView")


@pytest.mark.parametrize("scenario", ["del_then_readd", "batch8"])
def test_push_pack_matches_reference_through_patches(scenario):
    """The push pack fresh, then after each batch's deletes (tombstones
    patched) and adds (revivals patched, appends repacked)."""
    sc = digraph_scenario(scenario)
    r_eng, t_eng = RFrontier(), FrontierEngine(device="cpu")
    rh = r_eng.prepare(repro.graph.build_csr(sc.n, sc.edges, sc.w),
                       sc.diff_capacity)
    th = t_eng.prepare(repro_torch.build_csr(sc.n, sc.edges, sc.w,
                                             device="cpu"), sc.diff_capacity)
    stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                      dels=sc.stream.dels)

    def same(tag):
        for f in PUSH_FIELDS:
            np.testing.assert_array_equal(host(getattr(th.push, f)),
                                          host(getattr(rh.push, f)),
                                          err_msg=f"{tag}: {f}")

    same("fresh")
    moved = []
    for i in range(stream.num_batches(sc.batch_size)):
        rb = sc.stream.batch(i, sc.batch_size)
        tb = stream.batch(i, sc.batch_size, device="cpu")
        rh, th = r_eng.update_del(rh, rb), t_eng.update_del(th, tb)
        same(f"batch {i} deletes")
        g0 = th.g
        rh, th = r_eng.update_add(rh, rb), t_eng.update_add(th, tb)
        moved.append(bool((th.g.d_offsets != g0.d_offsets).any()))
        same(f"batch {i} adds")
    # an append repacks; del_then_readd also revives in place
    assert any(moved)
    assert scenario != "del_then_readd" or not all(moved)


def test_sssp_static_and_stream_bit_exact(ref):
    n, edges, w, stream = rmat()
    sess = port_session(n, edges, w, stream)
    with faults.inject("kernel_launch", times=0,
                       match=lambda c: c.get("op") == "sparse_step") as seam:
        p = sess.call(t_sssp.static_sssp, 0)
    steps = dict(sess.engine.steps)
    # this graph's static fixed point runs both directions
    assert steps["sparse"] > 0 and steps["dense_chunks"] > 0
    assert seam.seen == steps["sparse"]
    for k in ("dist", "parent"):
        np.testing.assert_array_equal(host(p[k]), ref["static"][k], err_msg=k)
    p = sess.run_stream(stream, BATCH, t_sssp.stream_step, p)
    # stream steps take the dense fixed point (_DenseStreamView)
    assert sess.engine.steps == steps
    for k in ("dist", "parent"):
        np.testing.assert_array_equal(host(p[k]), ref["stream"][k], err_msg=k)
    for f in DYN:
        np.testing.assert_array_equal(host(getattr(sess.handle.g, f)),
                                      ref["stream_g"][f], err_msg=f)


def test_sparse_step_fault_seam_raises():
    n, edges, w, stream = rmat()
    sess = port_session(n, edges, w, stream)
    with faults.inject("kernel_launch",
                       match=lambda c: c.get("op") == "sparse_step") as seam:
        with pytest.raises(repro_torch.runtime.errors.KernelFailure):
            sess.call(t_sssp.static_sssp, 0)
    assert seam.fired == 1


def test_sparse_and_dense_directions_agree():
    """sparse_frac 0 forces dense chunks only, 1 sparse steps only: the
    same distances and parents either way."""
    n, edges, w, stream = rmat()
    got = []
    for frac in (0.0, 1.0):
        sess = port_session(n, edges, w, stream, sparse_frac=frac)
        p = sess.call(t_sssp.static_sssp, 0)
        got.append((p, dict(sess.engine.steps)))
    (p0, s0), (p1, s1) = got
    assert s0["sparse"] == 0 and s0["dense_chunks"] > 0
    assert s1["sparse"] > 0 and s1["dense_chunks"] == 0
    for k in ("dist", "parent"):
        assert torch.equal(p0[k], p1[k]), k


def test_pagerank_within_rtol(ref):
    n, edges, w, stream = rmat()
    sess = port_session(n, edges, w, stream)
    p = sess.call(t_pr.static_pr, *PR_KNOBS)
    p = sess.run_stream(stream, BATCH, t_pr.make_stream_step(*PR_KNOBS), p)
    np.testing.assert_allclose(host(p["pr"]), ref["pr"], rtol=1e-5, atol=0)


def test_tc_bit_exact(ref):
    sc = sym_scenario("sym_batch16")
    csr = repro_torch.build_csr(sc.n, sc.edges, sc.w, device="cpu")
    sess = repro_torch.bind_graph(csr, backend="frontier",
                                  capacity=sc.diff_capacity, device="cpu")
    c = sess.call(t_tc.static_tc)
    assert int(c) == ref["tc_static"]
    stream = repro_torch.UpdateStream(adds=sc.stream.adds,
                                      dels=sc.stream.dels)
    c = sess.run_stream(stream, sc.batch_size, t_tc.stream_step, c)
    assert (int(c), str(host(c).dtype)) == ref["tc"]


def test_pack_state_round_trip_and_k_mismatch():
    n, edges, w, stream = rmat()
    sess = port_session(n, edges, w, stream)
    p = sess.call(t_sssp.static_sssp, 0)
    sess.run_stream(stream, BATCH, t_sssp.stream_step, p)
    tree, meta = sess.engine.pack_state(sess.handle)
    assert meta == {"kind": "frontier", "n": n, "k": 8}
    back = FrontierEngine(device="cpu").unpack_state(tree, meta)
    for f in DYN:
        assert torch.equal(getattr(back.g, f), getattr(sess.handle.g, f)), f
    for f in PUSH_FIELDS + ("offsets",):
        assert torch.equal(getattr(back.push, f),
                           getattr(sess.handle.push, f)), f
    with pytest.raises(ValueError, match="k=8"):
        FrontierEngine(k=4, device="cpu").unpack_state(tree, meta)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: host(tree)}


def test_checkpoints_cross_both_ways(tmp_path):
    """A frontier session saved after its first half restores in the
    other package and finishes its second half equal, leaf for leaf, to
    the uninterrupted run."""
    n, edges, w, stream = rmat()
    half = stream.num_batches(BATCH) // 2
    first = stream.window(BATCH, 0, half)
    rest = stream.window(BATCH, half, stream.num_batches(BATCH) - half)

    full = port_session(n, edges, w, stream)
    p = full.call(t_sssp.static_sssp, 0)
    p = full.run_stream(stream, BATCH, t_sssp.stream_step, p)
    want = _leaves(full.engine.pack_state(full.handle)[0])
    want_dist = host(p["dist"])

    # port -> repro
    sess = port_session(n, edges, w, stream)
    p = sess.call(t_sssp.static_sssp, 0)
    sess.run_stream(first, BATCH, t_sssp.stream_step, p)
    sess.save(tmp_path / "port")
    rsess = repro.api.restore_session(tmp_path / "port")
    assert rsess.engine.name == "frontier"
    rp = {k: rsess.props[k] for k in ("dist", "parent", "modified")}
    rp = rsess.run_stream(ref_stream(rest), BATCH, r_sssp.stream_step, rp)
    np.testing.assert_array_equal(host(rp["dist"])[:n], want_dist)
    got = _leaves(rsess.engine.pack_state(rsess.handle)[0])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # repro -> port
    rsess = repro.bind_graph(repro.graph.build_csr(n, edges, w),
                             backend="frontier",
                             capacity=2 * stream.num_adds)
    rp = rsess.call(r_sssp.static_sssp, 0)
    rsess.run_stream(ref_stream(first), BATCH, r_sssp.stream_step, rp)
    rsess.save(tmp_path / "ref")
    sess = restore_session(tmp_path / "ref", device="cpu")
    assert sess.backend_name == "frontier"
    p = {k: sess.props[k] for k in ("dist", "parent", "modified")}
    p = sess.run_stream(rest, BATCH, t_sssp.stream_step, p)
    np.testing.assert_array_equal(host(p["dist"]), want_dist)
    got = _leaves(sess.engine.pack_state(sess.handle)[0])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
