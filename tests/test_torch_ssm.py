"""The port's recurrent mixers (``repro_torch.models.ssm``: Mamba, mLSTM,
sLSTM) and the archs that use them (xlstm-125m, jamba-v0.1-52b) against
repro's on the CPU, in float32, with the reference's weights and inputs
drawn with numpy from a seed.

* Each mixer's train form within 1e-4 of the reference's over sequences
  of 128 positions (two 64-position chunks) and 100 (one chunk), and its
  decode form, outputs and states, within 1e-4 over 4 steps from a drawn
  state.  The mixers' float32 sums run in other orders than XLA's (the
  doubling scan against ``lax.associative_scan``, the einsums' and
  cumsum's orders); train readings are 2e-7 (sLSTM) to 1.1e-5 (mLSTM,
  one chunk of 100) on outputs of std 0.2-0.5.
* The train and decode forms compute the same recurrence: the port's
  train outputs against its own decode steps from the zero state, 1e-4.
* Whole models (reduced): prefill logits within 1e-4 of the reference,
  then 8 greedy steps with identical tokens and logits within 1e-4, as
  tests/test_torch_lm.py holds the attention archs.  The reference's
  cache is padded as ``repro/launch/serve.py`` pads it (the 5-d leaves
  whose axis 3 is the prompt length); the prompt of 128 differs from the
  reduced mLSTM head width of 32, whose ``C`` leaf that test would pad.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.archs import get_arch as r_get_arch
from repro.configs.reduced import reduced as r_reduced
from repro.models import ssm as RS
from repro.models.model import Model as RModel
from repro_torch.configs.archs import get_arch
from repro_torch.configs.reduced import reduced
from repro_torch.kernels import flash_attention as TF
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.model import params_from_jax

B, P, G = 2, 128, 8
ATOL = 1e-4
MIXER_ARCH = {"mamba": "jamba-v0.1-52b", "mlstm": "xlstm-125m",
              "slstm": "xlstm-125m"}
noshard = lambda a, *_: a
_REF = {}


def mixer_params(kind, seed=2, near_zero_forget=False):
    """The reference's init of one mixer in float32, its zero and one
    leaves (biases, A_log, skip) drawn instead so that they count; as
    numpy."""
    cfg = r_reduced(r_get_arch(MIXER_ARCH[kind]))
    p = getattr(RS, "init_" + kind)(jax.random.PRNGKey(seed), cfg,
                                    jnp.float32)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in p.items():
        v = np.asarray(v)
        if k in ("conv_b", "dt_bias", "A_log", "skip_d", "b"):
            v = v + 0.3 * rng.standard_normal(v.shape).astype(np.float32)
        out[k] = v
    if near_zero_forget:
        # forget gates ~1e-22: log(f + 1e-8) ~ -18.4 a step, so exp of the
        # decay matrix's upper triangle overflows to inf inside a chunk
        out["wf"] = -np.ones_like(out["wf"])
    return cfg, out


def state_arrays(kind, cfg, rng):
    """A drawn decode state of the reference's shapes and dtypes."""
    st = getattr(RS, kind + "_init_state")(cfg, B, jnp.float32)
    return {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in st.items()}


def jx(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def tx(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("S", [128, 100])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_train_matches_reference(kind, S):
    cfg, p = mixer_params(kind)
    x = np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want = getattr(RS, kind + "_train")(jx(p), jnp.asarray(x), cfg, noshard)
    got = getattr(TS, kind + "_train")(tx(p), torch.from_numpy(x),
                                       reduced(get_arch(MIXER_ARCH[kind])))
    close(got, want)


def test_mlstm_train_with_overflowing_decay_matches_reference():
    """Forget gates near zero: exp(dmat) is inf above the diagonal, and
    the port selects it away (no inf * 0 = NaN)."""
    cfg, p = mixer_params("mlstm", near_zero_forget=True)
    x = np.abs(np.random.default_rng(7).standard_normal(
        (B, P, cfg.d_model))).astype(np.float32)
    want = RS.mlstm_train(jx(p), jnp.asarray(x), cfg, noshard)
    got = TS.mlstm_train(tx(p), torch.from_numpy(x),
                         reduced(get_arch("xlstm-125m")))
    assert bool(torch.isfinite(got).all())
    close(got, want)


@pytest.mark.parametrize("kind", ["mamba", "mlstm"])
def test_mixer_train_refuses_a_ragged_sequence(kind):
    """131 positions split into no whole number of chunks: the reference's
    reshape fails, and the port raises."""
    cfg, p = mixer_params(kind)
    x = np.zeros((1, 131, cfg.d_model), np.float32)
    with pytest.raises(TypeError):
        getattr(RS, kind + "_train")(jx(p), jnp.asarray(x), cfg, noshard)
    with pytest.raises(ValueError, match="chunks"):
        getattr(TS, kind + "_train")(tx(p), torch.from_numpy(x),
                                     reduced(get_arch(MIXER_ARCH[kind])))


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_decode_matches_reference(kind):
    cfg, p = mixer_params(kind)
    tcfg = reduced(get_arch(MIXER_ARCH[kind]))
    rng = np.random.default_rng(11)
    st = state_arrays(kind, cfg, rng)
    rst, tst = jx(st), tx(st)
    for _ in range(4):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, rst = getattr(RS, kind + "_decode")(jx(p), jnp.asarray(x),
                                                  rst, cfg)
        got, tst = getattr(TS, kind + "_decode")(tx(p), torch.from_numpy(x),
                                                 tst, tcfg)
        close(got, want)
        assert set(tst) == set(rst)
        for name in rst:
            assert tst[name].dtype == torch.float32
            close(tst[name], rst[name])


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_mixer_train_equals_its_decode_recurrence(kind):
    """The train form over 128 positions against 128 decode steps from the
    zero state (the port's own two forms of one recurrence)."""
    _, p = mixer_params(kind)
    cfg = reduced(get_arch(MIXER_ARCH[kind]))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, P, cfg.d_model)).astype(np.float32))
    tp = tx(p)
    want = getattr(TS, kind + "_train")(tp, x, cfg)
    state = getattr(TS, kind + "_init_state")(cfg, B, torch.float32)
    steps = []
    for t in range(P):
        y, state = getattr(TS, kind + "_decode")(tp, x[:, t:t + 1], state,
                                                 cfg)
        steps.append(y)
    close(torch.cat(steps, 1), want.numpy())


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def serve_reference(arch, dtype="float32", gen=G):
    """repro's prefill logits, its cache padded as repro/launch/serve.py
    pads it, then gen - 1 greedy serve steps: (params as numpy, prompts,
    [logits per step], [token per step])."""
    k = (arch, dtype, gen)
    if k not in _REF:
        cfg = r_reduced(r_get_arch(arch))
        model = RModel(cfg=cfg, dtype=getattr(jnp, dtype))
        params = model.init(jax.random.PRNGKey(1))
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, (B, P)).astype(np.int32)
        logits, caches = jax.jit(model.prefill_step)(
            params, {"tokens": jnp.asarray(prompts)})

        def pad(x):
            if x.ndim == 5 and x.shape[3] == P:        # (R,B,kv,P,dh)
                return jnp.pad(x, ((0, 0),) * 3 + ((0, gen),) + ((0, 0),))
            return x

        caches = jax.tree.map(pad, caches)
        step = jax.jit(lambda p, c, t, pos: model.serve_step(p, c, t, pos))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out_l, out_t = [np.asarray(logits)], [np.asarray(tok)]
        for i in range(gen - 1):
            logits, caches = step(params, caches, tok,
                                  jnp.asarray(P + i))
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            out_l.append(np.asarray(logits))
            out_t.append(np.asarray(tok))
        _REF[k] = (jax.tree.map(np.asarray, params), prompts, out_l, out_t)
    return _REF[k]


def check_model_f32(arch, backend):
    """The port's prefill and greedy decode of ``arch`` (reduced, float32)
    on the reference's weights: logits within 1e-4 each step, tokens
    equal, the cache's entries of init_cache's shapes."""
    tree, prompts, ref_l, ref_t = serve_reference(arch)
    model = params_from_jax(reduced(get_arch(arch)), tree, device="cpu",
                            backend=backend)
    assert model.dtype == torch.float32
    logits, caches = tserve.prefill(model, torch.from_numpy(prompts), P + G)
    close(logits, ref_l[0])
    empty = TT.init_cache(model.cfg, B, P + G, torch.float32, "cpu")
    assert [{n: (x.shape, x.dtype) for n, x in c.items()} for c in empty] \
        == [{n: (x.shape, x.dtype) for n, x in c.items()} for c in caches]
    toks = tserve.decode(model, logits, caches, P, G).numpy()
    np.testing.assert_array_equal(toks, np.concatenate(ref_t, axis=1))
    logits, caches = tserve.prefill(model, torch.from_numpy(prompts), P + G)
    for i in range(G - 1):
        logits, caches = model.serve_step(
            caches, torch.from_numpy(toks[:, i:i + 1]), P + i)
        close(logits, ref_l[i + 1])


def test_xlstm_serving_matches_reference_f32():
    check_model_f32("xlstm-125m", "torch")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_jamba_serving_matches_reference_f32(backend):
    check_model_f32("jamba-v0.1-52b", backend)


def test_prefill_pads_only_attention_kv():
    """serve.prefill pads each attention layer's k and v to the decode
    length and hands every recurrent state on as prefill made it: the
    zero state, as the reference's prefill leaves it."""
    cfg = reduced(get_arch("jamba-v0.1-52b"))
    model = params_from_jax(cfg, serve_reference("jamba-v0.1-52b")[0],
                            device="cpu", backend="torch")
    prompts = torch.zeros((B, 70), dtype=torch.long)
    raw = model.prefill_step(prompts)[1]
    _, caches = tserve.prefill(model, prompts, 75)
    mamba = TS.mamba_init_state(cfg, B, torch.float32)
    for spec, c, r in zip(TT.layer_specs(cfg), caches, raw):
        if spec["mixer"] == "attn":
            for n in ("k", "v"):
                assert c[n].shape == (B, cfg.n_kv, 75, cfg.dh)
                assert torch.equal(c[n][:, :, :70], r[n])
                assert not bool(c[n][:, :, 70:].any())
        else:
            assert spec["mixer"] == "mamba"
            assert {n: (x.shape, x.dtype) for n, x in c.items()} == \
                {n: (x.shape, x.dtype) for n, x in mamba.items()}
            assert not any(bool(x.any()) for x in c.values())


def test_params_from_jax_keeps_float32_leaves_in_bf16():
    """The reference's bf16 jamba keeps A_log and the MoE router in
    float32; the port's init does too, so loading rounds neither."""
    tree = serve_reference("jamba-v0.1-52b", "bfloat16", gen=2)[0]
    model = params_from_jax(reduced(get_arch("jamba-v0.1-52b")), tree,
                            device="cpu")
    assert model.dtype == torch.bfloat16
    layers = model.params.layers
    n = len(tree["units"])
    seen = set()
    for r in range(model.cfg.repeat):
        for i, unit in enumerate(tree["units"]):
            for part, name in (("mixer", "A_log"), ("ffn", "router")):
                if name not in unit.get(part, {}):
                    continue
                want = np.asarray(unit[part][name])[r]
                assert want.dtype == np.float32
                got = layers[r * n + i][part][name]
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.detach().numpy(), want)
                seen.add(name)
            assert layers[r * n + i]["mixer"]["ln"].dtype == torch.bfloat16
    assert seen == {"A_log", "router"}


def test_xlstm_prefill_launches_no_kernel():
    """xlstm has no attention layer: its prefill and decode on the cuda
    backend never reach the flash kernel's wrapper."""
    tree, prompts, _, _ = serve_reference("xlstm-125m")
    model = params_from_jax(reduced(get_arch("xlstm-125m")), tree,
                            device="cpu")
    calls = []
    real = TF.flash_attention
    TF.flash_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        logits, caches = tserve.prefill(
            model, torch.from_numpy(prompts[:, :64]), 66)
        tserve.decode(model, logits, caches, 64, 2)
    finally:
        TF.flash_attention = real
    assert calls == []


def test_mamba_scan_serving_form_equals_the_training_form():
    """The doubling scan without autograd (fresh buffers written with
    ``out=``, no ``torch.cat``) and with it (``torch.cat``): the same
    addcmul and mul in the same order, so the same bits."""
    from repro_torch.launch.op_cost import CostCounter
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 64, 16, 4), generator=g)
    bu = torch.randn((2, 64, 16, 4), generator=g)
    h0 = torch.randn((2, 16, 4), generator=g)
    with torch.no_grad(), CostCounter() as served:
        h, last = TS._mamba_scan_chunk(h0, a, bu)
    with CostCounter() as trained:
        ht, lastt = TS._mamba_scan_chunk(h0, a.clone().requires_grad_(), bu)
    assert torch.equal(h, ht.detach()) and torch.equal(last, lastt.detach())
    assert "cat" not in served.bytes_by_op and "cat" in trained.bytes_by_op
