"""The flash kernel's plain version (``repro_torch.kernels.flash_attention``)
and the port's O(S²) oracle against repro's Pallas flash kernel
(interpret mode) and ``repro.kernels.ref.flash_ref`` on the CPU, at the
shapes and tolerances of tests/test_kernels.py (float32 1e-5, bf16 3e-2,
softcap rtol 1e-4 / atol 1e-5), and at the tensor-core kernel's tiling
(128 q rows by 128 keys).  The CUDA kernel against the plain
version on the card: tests/test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as TF
from repro_torch.kernels.ref import flash_ref

CASES = [(128, 64, True, "float32"), (256, 128, True, "float32"),
         (256, 128, False, "float32"), (512, 64, True, "bfloat16"),
         (128, 256, True, "float32")]


def inputs(seed, S, dh, dtype):
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((2, S, dh)).astype(np.float32)
           for _ in range(3)]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(x).astype(jd) for x in qkv],
            [torch.from_numpy(x).to(td) for x in qkv])


def err(got, want):
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want.astype(jnp.float32)))))


@pytest.mark.parametrize("S,dh,causal,dtype", CASES)
def test_flash_plain_matches_pallas_and_ref(S, dh, causal, dtype):
    (jq, jk, jv), (q, k, v) = inputs(S + dh, S, dh, dtype)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    pallas = pallas_flash(jq, jk, jv, causal=causal, bq=128, bk=128)
    ref = R.flash_ref(jq, jk, jv, causal=causal)
    got = TF.flash_attention(q, k, v, causal=causal)      # CPU: plain
    assert got.dtype == q.dtype and got.shape == q.shape
    assert err(got, pallas) < tol
    assert err(got, ref) < tol
    assert err(flash_ref(q, k, v, causal=causal), ref) < tol


def test_flash_plain_softcap():
    (jq, jk, jv), (q, k, v) = inputs(0, 256, 128, "float32")
    pallas = pallas_flash(jq, jk, jv, causal=True, bq=128, bk=128,
                          softcap=30.0)
    got = TF.flash_attention_plain(q, k, v, causal=True, softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        flash_ref(q, k, v, causal=True, softcap=30.0).numpy(),
        np.asarray(R.flash_ref(jq, jk, jv, causal=True, softcap=30.0)),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal,bk", [(True, 512), (False, 512),
                                       (True, 64)])
def test_flash_plain_ragged_length(causal, bk):
    """S = 200 is no multiple of the tile: the Pallas grid (S // bq)
    would leave the tail rows unwritten, so only the oracle is held."""
    (jq, jk, jv), (q, k, v) = inputs(7, 200, 64, "float32")
    got = TF.flash_attention_plain(q, k, v, causal=causal, bk=bk)
    assert err(got, R.flash_ref(jq, jk, jv, causal=causal)) < 1e-5


def test_flash_wrapper_on_cpu_counts_no_launch():
    (_, _, _), (q, k, v) = inputs(1, 64, 32, "float32")
    TF.reset_launches()
    TF.flash_attention(q, k, v)
    assert TF.LAUNCHES == {"flash_attention": 0}


def test_flash_plain_at_kernel_tile_matches_pallas():
    """The plain version over KV blocks of 128 keys, the tensor-core
    kernel's KV tile, against the Pallas kernel at bq = bk = 128 in bf16."""
    (jq, jk, jv), (q, k, v) = inputs(11, 256, 128, "bfloat16")
    pallas = pallas_flash(jq, jk, jv, causal=True, bq=128, bk=128)
    got = TF.flash_attention_plain(q, k, v, causal=True, bk=128)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert err(got, pallas) < 3e-2


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 3e-2),
                                       ("float32", 1e-5)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_at_kernel_tile_ragged(dtype, tol, causal):
    """S = 200 over KV blocks of 128 keys: a full tile and a ragged one,
    held to the O(S^2) oracle (the Pallas grid leaves the tail unwritten)."""
    (jq, jk, jv), (q, k, v) = inputs(13, 200, 128, dtype)
    got = TF.flash_attention_plain(q, k, v, causal=causal, bk=128)
    assert err(got, R.flash_ref(jq, jk, jv, causal=causal)) < tol


# ---------------------------------------------------------------------------
# the window (local attention).  The Pallas kernel has none, so the plain
# version and the O(S^2) oracle are held to the reference model's chunked
# attention, ``repro.models.layers.flash_attention(..., window=W)``, which
# masks i - j >= W inside its causal branch, after the softcap.
# ---------------------------------------------------------------------------

def model_flash(jq, jk, jv, window, softcap, causal=True):
    """repro's chunked attention on (BH, S, dh) inputs, as (1, S, BH, dh)."""
    import dataclasses
    from repro.configs.archs import get_arch
    from repro.models import layers as RL
    cfg = dataclasses.replace(get_arch("gemma2-9b"), attn_softcap=softcap)
    heads = lambda x: jnp.swapaxes(x, 0, 1)[None]
    S, dh = jq.shape[1], jq.shape[2]
    o = RL.flash_attention(heads(jq), heads(jk), heads(jv), cfg,
                           jnp.arange(S), causal, window, scale=dh ** -0.5)
    return jnp.swapaxes(o[0], 0, 1)


# S, dh, window, softcap, plain's block: W = 1; W equal to and one past a
# block; W >= S; a softcap; at S = 384 and W = 128 the rows past 254 have
# their whole first block (and more) masked, and row 383 its first two
WINDOW_CASES = [(200, 32, 1, None, 64), (256, 32, 128, None, 128),
                (256, 32, 129, None, 128), (200, 32, 200, None, 64),
                (130, 32, 500, None, 512), (256, 64, 100, 30.0, 128),
                (384, 32, 128, None, 128), (384, 32, 128, 50.0, 64)]


@pytest.mark.parametrize("S,dh,window,cap,bk", WINDOW_CASES)
def test_flash_plain_window_matches_model_attention(S, dh, window, cap, bk):
    (jq, jk, jv), (q, k, v) = inputs(S + window, S, dh, "float32")
    want = model_flash(jq, jk, jv, window, cap)
    kw = dict(causal=True, softcap=cap, window=window)
    got = TF.flash_attention(q, k, v, **kw)             # CPU: plain
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    for out in (got, TF.flash_attention_plain(q, k, v, bk=bk, **kw),
                flash_ref(q, k, v, **kw)):
        assert err(out, want) < 1e-5


def test_flash_plain_window_bf16_and_no_op_window():
    """bf16 within 3e-2 of the model's attention; a window of S or more
    changes no bit of the causal result."""
    (jq, jk, jv), (q, k, v) = inputs(5, 256, 64, "bfloat16")
    got = TF.flash_attention_plain(q, k, v, window=64, bk=128)
    assert err(got, model_flash(jq, jk, jv, 64, None)) < 3e-2
    for w in (256, 257, 10 ** 6):
        assert torch.equal(TF.flash_attention_plain(q, k, v, window=w),
                           TF.flash_attention_plain(q, k, v))


def test_flash_window_refused_without_causal_or_positive_int():
    (_, _, _), (q, k, v) = inputs(1, 16, 16, "float32")
    for fn in (TF.flash_attention, TF.flash_attention_plain, flash_ref):
        with pytest.raises(ValueError, match="causal"):
            fn(q, k, v, causal=False, window=4)
        for bad in (0, -1, 2.0, True):
            with pytest.raises(ValueError, match="positive int"):
                fn(q, k, v, window=bad)


# tools/flash_variants.py against the flash kernels' sources as they
# stand (the forward's tables on flash_attention.cu, the backward's on
# flash_attention_bwd.cu, each with the headers they include): every
# planted fault and design copy must match once and change a file, so a
# tool left behind by a change to a kernel fails here, not on the card.
def _flash_variants():
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "flash_variants", root / "tools" / "flash_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FV = _flash_variants()


@pytest.mark.parametrize("mode,name", [
    (mode, name) for mode in ("faults", "ablations")
    for name in FV.TABLES[mode][1]] + [
    (mode, name) for mode in ("faults-bwd", "ablations-bwd")
    for name in FV.TABLES[mode][1]])
def test_flash_variant_applies_to_the_current_source(mode, name):
    source, table = FV.TABLES[mode]
    subs = table[name]
    copy, original = FV.variant(source, subs), FV.variant(source, [])
    assert copy.keys() == original.keys()
    changed = {f for f in copy if copy[f] != original[f]}
    assert changed == {s[0] if len(s) == 3 else source for s in subs}


# ---------------------------------------------------------------------------
# the backward (training).  The reference has no Pallas backward: its model
# differentiates the chunked attention above with XLA.  The plain backward
# (what a CPU tensor takes, and what the card's kernel is held to) against
# jax.vjp of that attention and against autograd of the plain forward, in
# float32 within 1e-5 of each gradient's largest magnitude; the forward's
# lse against jax's logsumexp of the same scores.
# ---------------------------------------------------------------------------

# S, dh, causal, window, softcap, the plain backward's key block: dh 16
# and 64; S a multiple of the block and not (200, 300); full, causal,
# windowed, softcapped
BWD_CASES = [(128, 16, True, None, None, 64), (200, 64, True, None, None, 64),
             (200, 16, False, None, None, 64),
             (256, 64, True, None, 30.0, 128),
             (200, 16, True, 50, None, 64), (300, 64, True, 100, 50.0, 128),
             (96, 64, False, None, 30.0, 512)]


def grad_err(got, want) -> float:
    w = np.asarray(want, dtype=np.float32)
    return err(got, want) / max(float(np.abs(w).max()), 1e-30)


@pytest.mark.parametrize("S,dh,causal,window,cap,bk", BWD_CASES)
def test_flash_backward_plain_matches_jax_grad(S, dh, causal, window, cap,
                                               bk):
    import jax
    (jq, jk, jv), (q, k, v) = inputs(S + dh + 1, S, dh, "float32")
    do = np.random.default_rng(S).standard_normal((2, S, dh)) \
        .astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: model_flash(a, b, c, window, cap,
                                                 causal), jq, jk, jv)
    want = vjp(jnp.asarray(do))
    kw = dict(causal=causal, softcap=cap, window=window)
    o, lse = TF.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = TF.flash_attention_backward_plain(q, k, v, o, lse,
                                            torch.from_numpy(do), bk=bk,
                                            **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    TF.flash_attention_plain(*leaves, **kw).backward(torch.from_numpy(do))
    for g, w, a in zip(got, want, leaves):
        assert g.dtype == q.dtype and g.shape == q.shape
        assert grad_err(g, w) < 1e-5
        assert grad_err(g, a.grad.numpy()) < 1e-5


@pytest.mark.parametrize("causal,window,cap", [(True, None, None),
                                               (False, None, 30.0),
                                               (True, 40, 50.0)])
def test_flash_plain_lse_matches_logsumexp(causal, window, cap):
    import jax
    S, dh = 200, 32
    (jq, jk, _), (q, k, v) = inputs(3, S, dh, "float32")
    s = jnp.einsum("bsd,btd->bst", jq * dh ** -0.5, jk)
    if cap is not None:
        s = jnp.tanh(s / cap) * cap
    if causal:
        i, j = jnp.arange(S)[:, None], jnp.arange(S)[None, :]
        ok = i >= j if window is None else (i >= j) & (i - j < window)
        s = jnp.where(ok, s, -1e30)
    want = jax.nn.logsumexp(s, axis=-1)
    for bk in (64, 512):
        o, lse = TF.flash_attention_plain(q, k, v, causal=causal,
                                          softcap=cap, window=window, bk=bk,
                                          return_lse=True)
        assert lse.dtype == torch.float32 and lse.shape == (2, S)
        assert err(lse, want) < 1e-5
        assert torch.equal(o, TF.flash_attention_plain(
            q, k, v, causal=causal, softcap=cap, window=window, bk=bk))


def test_flash_autograd_function_on_cpu_runs_the_plain_versions():
    """FlashAttention on CPU tensors: the plain forward, the plain
    backward, no launch counted; bf16 gradients keep bf16."""
    for dtype in ("float32", "bfloat16"):
        (_, _, _), (q, k, v) = inputs(4, 96, 32, dtype)
        do = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, 96, 32)).astype(np.float32)).to(q.dtype)
        TF.reset_launches()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = TF.FlashAttention.apply(*leaves, True, 30.0, 40)
        o.backward(do)
        kw = dict(causal=True, softcap=30.0, window=40)
        o2, lse = TF.flash_attention_plain(q, k, v, return_lse=True, **kw)
        assert torch.equal(o.detach(), o2)
        for a, w in zip(leaves, TF.flash_attention_backward(
                q, k, v, o2, lse, do, **kw)):
            assert a.grad.dtype == q.dtype and torch.equal(a.grad, w)
        assert TF.LAUNCHES == {"flash_attention": 0}
        assert TF.BWD_LAUNCHES == {"flash_attention_backward": 0}
