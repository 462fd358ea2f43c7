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
