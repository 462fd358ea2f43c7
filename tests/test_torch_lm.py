"""The port's LM serving path (``repro_torch.models``, ``launch.serve``)
against repro's ``Model.prefill_step`` / ``serve_step`` on the CPU, with
the reference's weights carried over by ``params_from_jax`` and the
prompts made with numpy from a seed.

* float32: prefill logits within 1e-4 of the reference, then 8 greedy
  decode steps with identical tokens and logits within 1e-4 (both
  backends: ``torch`` computes the reference's chunked attention,
  ``cuda`` on the CPU runs the flash kernel's plain version; readings
  are ~4e-7).  With the reduced configs' window of 8 keys, a prompt of
  12 windows gemma2's local layers in prefill, and decode past position
  8 reads the window's slice of the cache (``long_mode``: the global
  layers too); whisper runs its encoder over a source of 16 frames and
  llama-3.2-vision cross-attends to 8 image tokens, each ``src`` drawn
  with numpy from a seed.
* bf16: logits within 2e-2.  The two frameworks round bf16 at other
  points (XLA fuses elementwise chains in float32, PyTorch rounds each
  op), and ``cuda`` keeps a float32 attention accumulator where the
  reference's chunked schedule keeps q's type; readings are 5e-3-9e-3 on
  logits of std ~0.15.  Near-ties can then pick another token, so decode
  feeds both the reference's tokens (teacher forcing).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.archs import get_arch as r_get_arch
from repro.configs.reduced import reduced as r_reduced
from repro.models.model import Model as RModel
from repro_torch.configs.archs import REGISTRY, get_arch
from repro_torch.configs.reduced import reduced
from repro_torch.kernels import flash_attention as TF
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model, params_from_jax

B, P, G = 2, 12, 8
_REF = {}


def source(cfg):
    """The source embeddings (B, T, D) of a vlm or audio arch, else None."""
    T = {"vlm": cfg.n_img_tokens, "audio": cfg.enc_seq}.get(cfg.family)
    if T is None:
        return None
    return np.random.default_rng(5).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def reference(arch, dtype, long_mode=False):
    """repro's prefill logits, then G - 1 greedy serve steps: (params as
    numpy, prompts, src, [logits per step], [token per step])."""
    key = (arch, dtype, long_mode)
    if key not in _REF:
        cfg = r_reduced(r_get_arch(arch))
        model = RModel(cfg=cfg, dtype=getattr(jnp, dtype))
        params = model.init(jax.random.PRNGKey(1))
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, (B, P)).astype(np.int32)
        src = source(cfg)
        batch = {"tokens": jnp.asarray(prompts)}
        if src is not None:
            batch["src"] = jnp.asarray(src)
        logits, caches = jax.jit(model.prefill_step)(params, batch)
        caches = jax.tree.map(lambda x: jnp.pad(
            x, ((0, 0),) * 3 + ((0, G),) + ((0, 0),)), caches)
        jsrc = None if src is None else jnp.asarray(src)
        step = jax.jit(lambda p, c, t, pos: model.serve_step(
            p, c, t, pos, src=jsrc, long_mode=long_mode))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out_l, out_t = [np.asarray(logits)], [np.asarray(tok)]
        for i in range(G - 1):
            logits, caches = step(params, caches, tok, jnp.asarray(P + i))
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out_l.append(np.asarray(logits))
            out_t.append(np.asarray(tok))
        _REF[key] = (jax.tree.map(np.asarray, params), prompts, src, out_l,
                     out_t)
    return _REF[key]


def check_serving_f32(arch, backend, long_mode=False):
    tree, prompts, src, ref_l, ref_t = reference(arch, "float32", long_mode)
    model = params_from_jax(reduced(get_arch(arch)), tree, device="cpu",
                            backend=backend)
    assert model.dtype == torch.float32
    src = None if src is None else torch.from_numpy(src)
    logits, caches = tserve.prefill(model, torch.from_numpy(prompts), P + G,
                                    src)
    np.testing.assert_allclose(logits.numpy(), ref_l[0], rtol=0, atol=1e-4)
    empty = TT.init_cache(model.cfg, B, P + G, torch.float32, "cpu")
    assert [{n: x.shape for n, x in c.items()} for c in empty] == \
        [{n: x.shape for n, x in c.items()} for c in caches]
    toks = tserve.decode(model, logits, caches, P, G, src, long_mode).numpy()
    np.testing.assert_array_equal(toks, np.concatenate(ref_t, axis=1))
    # the same steps once more, each step's logits against the reference
    logits, caches = tserve.prefill(model, torch.from_numpy(prompts), P + G,
                                    src)
    for i in range(G - 1):
        logits, caches = model.serve_step(
            caches, torch.from_numpy(toks[:, i:i + 1]), P + i, src,
            long_mode)
        np.testing.assert_allclose(logits.numpy(), ref_l[i + 1], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen1.5-32b",
                                  "gemma2-9b", "whisper-large-v3",
                                  "llama-3.2-vision-11b"])
def test_serving_matches_reference_f32(arch, backend):
    check_serving_f32(arch, backend)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_long_mode_serving_matches_reference_f32(backend):
    """gemma2's long_mode decode: its global layers (softcapped) read the
    window's slice of the cache too."""
    check_serving_f32("gemma2-9b", backend, long_mode=True)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_serving_matches_reference_bf16(backend):
    tree, prompts, _, ref_l, ref_t = reference("starcoder2-7b", "bfloat16")
    model = params_from_jax(reduced(get_arch("starcoder2-7b")), tree,
                            device="cpu", backend=backend)
    assert model.dtype == torch.bfloat16
    logits, caches = tserve.prefill(model, torch.from_numpy(prompts), P + G)
    np.testing.assert_allclose(logits.numpy(), ref_l[0], rtol=0, atol=2e-2)
    for i in range(G - 1):
        logits, caches = model.serve_step(
            caches, torch.tensor(ref_t[i], dtype=torch.long), P + i)
        np.testing.assert_allclose(logits.numpy(), ref_l[i + 1], rtol=0,
                                   atol=2e-2)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen1.5-32b"])
def test_attention_train_matches_reference(arch, backend):
    """The full-sequence attention sublayer (the one prefill runs) on the
    reference's float32 weights, q/k/v biases made nonzero: within 1e-4
    of repro's ``attention_train``."""
    from repro.models import layers as RL
    from repro_torch.models import layers as TL
    cfg = r_reduced(r_get_arch(arch))
    rng = np.random.default_rng(3)
    p = RL.init_attn(jax.random.PRNGKey(2), cfg, jnp.float32)
    p = {k: np.asarray(v) + (0.1 * rng.standard_normal(v.shape).astype(
        np.float32) if k.startswith("b") else 0) for k, v in p.items()}
    assert cfg.qkv_bias == (arch == "qwen1.5-32b") == ("bq" in p)
    x = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    want = RL.attention_train({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), cfg, jnp.arange(P),
                              lambda a, *_: a)
    got = TL.attention_train({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), reduced(get_arch(arch)),
                             torch.arange(P), backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_cuda_backend_on_cpu_runs_the_plain_kernel():
    """The cuda backend on CPU tensors goes through the kernel's wrapper,
    which runs the plain version and counts no launch."""
    cfg = reduced(get_arch("starcoder2-7b"))
    model = Model(cfg, dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    calls = []
    real = TF.flash_attention_plain
    TF.reset_launches()
    try:
        TF.flash_attention_plain = lambda *a, **k: calls.append(1) or \
            real(*a, **k)
        model.prefill_step(torch.zeros((1, 5), dtype=torch.long))
    finally:
        TF.flash_attention_plain = real
    assert len(calls) == cfg.n_layers
    assert TF.LAUNCHES == {"flash_attention": 0}


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_layers_outside_the_slice_raise(arch):
    """Every registered arch builds and initialises (reduced), its cache
    too: every mixer and ffn kind is ported.  A kind outside them raises
    ValueError, naming the kinds there are."""
    cfg = reduced(get_arch(arch))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert len(params.layers) == cfg.n_layers
    assert len(TT.init_cache(cfg, 1, 4, device="cpu")) == cfg.n_layers
    for part in ("mixer", "ffn"):
        spec = dict(cfg.pattern[0], **{part: "unknown"})
        with pytest.raises(ValueError, match=f"unknown {part}"):
            TT.init_layer(spec, cfg, torch.float32, "cpu", None)


def test_serve_cli_on_cpu():
    args = tserve.parser().parse_args(
        ["--arch", "starcoder2-7b", "--reduced", "--f32", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    out = tserve.serve(args)
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 256)).all()
    again = tserve.serve(args)
    np.testing.assert_array_equal(out["tokens"], again["tokens"])


def test_serve_needs_a_card_or_cpu_and_no_graph_mode():
    args = tserve.parser().parse_args(["--reduced", "--gen", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.serve(args)
    # --graph serves the graph-session pool now (test_torch_serve.py); it
    # too needs a card or device="cpu"
    small = ["--graph", "--tenants", "2", "--ticks", "2", "--scale", "6"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.serve(tserve.parser().parse_args(small))
    args = tserve.parser().parse_args(small + ["--device", "cpu"])
    assert tserve.serve(args)["stats"]["applied"] == 4
