"""The encdec family (seamless-m4t-medium's smoke config) against the JAX
package: the cross-attention pieces of `models/layers.py`, the encoder, the
loss and its gradients, prefill and greedy decode, and the train step.

Weights cross from the JAX `init` through `params_from_jax`.  The frames
are seeded random arrays, never zeros: zero frames leave every encoder layer
at 0 (rmsnorm(0) = 0, so q = k = v = 0; mlp(0) = 0), the memory 0, and the
cross-attention's k and v 0, so it adds exactly 0, and a check fed zeros
would pass with no encoder and no cross-attention at all (the test below
that says so holds it).

Tolerances: layer pieces rtol = atol = 1e-5 (f32; XLA and PyTorch sum in
other orders: ~1e-6 seen); per-row losses 1e-5 relative; prefill and decode
logits rtol = atol = 1e-5 (~3e-6 seen against logits up to ~4) and greedy
tokens equal; gradients and the train step as tests/test_torch_train.py
holds every arch (gradients 1e-4 of each leaf's max; k equal, ce 1e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.checkpoint import convert, params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.tree import leaves_with_path  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from test_torch_train import (  # noqa: E402
    both_batches, check_loss_gradients, check_per_row_loss, check_train_step, frontend_inputs)

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, DECODE_STEPS = 2, 8


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def attn():
    """One attention's parameters (JAX config, port config, JAX, port)."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = jlayers.attention_init(jax.random.PRNGKey(5), jcfg)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def weights():
    """(JAX model with use_pallas, JAX params, port model, port params)."""
    jmodel = jax_build_model(jax_smoke_config(ARCH).replace(use_pallas=True))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return (jmodel, jparams, build_model(get_smoke_config(ARCH), device="cpu"),
            params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))


def test_qkv_projects_k_and_v_from_the_memory(attn):
    jcfg, cfg, jp, tp = attn
    x, mem = _rand(BATCH, 16, cfg.d_model, seed=1), _rand(BATCH, 40, cfg.d_model, seed=2)
    want = jlayers._qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(mem))
    got = layers._qkv(tp, cfg, torch.from_numpy(x), torch.from_numpy(mem))
    assert [tuple(g.shape) for g in got] == [(BATCH, 16, 4, 64), (BATCH, 40, 4, 64), (BATCH, 40, 4, 64)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("t", [32, 128])
@pytest.mark.parametrize("which", ["cross", "encoder"])
def test_attention_full_cross_and_bidirectional(attn, which, t):
    """Cross-attention (kv_x: no RoPE, no mask) and the encoder's causal=False
    self-attention; at T = 128 neither may take the kernel."""
    jcfg, cfg, jp, tp = attn
    x, mem = _rand(BATCH, t, cfg.d_model, seed=3), _rand(BATCH, 48, cfg.d_model, seed=4)
    kw = dict(causal=False) if which == "encoder" else dict(causal=False, kv_x=mem)
    pos = np.arange(t)
    want = jlayers.attention_full(jp, jcfg.replace(use_pallas=True), jnp.asarray(x), jnp.asarray(pos),
                                  **{k: jnp.asarray(v) if k == "kv_x" else v for k, v in kw.items()})
    got = layers.attention_full(tp, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                                **{k: torch.from_numpy(v) if k == "kv_x" else v for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_decode_and_attention_decode_leave_the_cache(attn):
    jcfg, cfg, jp, tp = attn
    x, mem = _rand(BATCH, 1, cfg.d_model, seed=5), _rand(BATCH, 48, cfg.d_model, seed=6)
    want = jlayers._cross_decode(jp, jcfg, jnp.asarray(x), jnp.asarray(mem))
    got = layers._cross_decode(tp, cfg, torch.from_numpy(x), torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ck, cv = torch.zeros(BATCH, 8, 4, 64), torch.zeros(BATCH, 8, 4, 64)
    y, ck2, cv2 = layers.attention_decode(tp, cfg, torch.from_numpy(x), ck, cv, 3, kv_x=torch.from_numpy(mem))
    assert ck2 is ck and cv2 is cv and not ck.any() and not cv.any()
    np.testing.assert_allclose(y.numpy(), got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("kvh", [4, 1])
def test_sdpa_decode_grouped_without_a_mask(kvh):
    """The decode path of the cross-attention: one query row over every key."""
    q, k, v = _rand(BATCH, 1, 4, 64, seed=7), _rand(BATCH, 48, kvh, 64, seed=8), _rand(BATCH, 48, kvh, 64, seed=9)
    want = jlayers._sdpa_decode_grouped(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, kvh, 4 // kvh, 64)
    got = layers._sdpa_decode_grouped(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), None, kvh,
                                      4 // kvh, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_matches_the_reference_encoder(weights):
    """`Model.encode` against the reference's `build_model.encode`
    (model.py:114-123), which its Model does not expose: the same pieces."""
    jmodel, jparams, model, params = weights
    jcfg = jmodel.cfg
    frames = _rand(BATCH, jcfg.encoder_frames, jcfg.d_model, seed=10)
    x, _ = jtransformer.run_stack_full(jparams["encoder"], jcfg.replace(family="dense"), jnp.asarray(frames),
                                       jnp.arange(frames.shape[1]), causal=False, n_layers=jcfg.encoder_layers)
    want = jlayers.rmsnorm(jparams["enc_norm"], x)
    got = model.encode(params, torch.from_numpy(frames))
    assert tuple(got.shape) == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_zero_frames_make_the_cross_attention_inert(weights):
    """Why every check here feeds random frames: with zero frames the
    memory is 0 and the decoder's output is the one it gives with no
    memory at all."""
    _, _, model, params = weights
    tokens = torch.from_numpy(np.random.default_rng(11).integers(0, 512, (BATCH, 32)))
    frames = torch.zeros(BATCH, model.cfg.encoder_frames, model.cfg.d_model)
    assert not model.encode(params, frames).any()
    with_zeros, _ = model.prefill(params, {"tokens": tokens, "frames": frames})
    without, _ = model.prefill(params, {"tokens": tokens})
    assert torch.equal(with_zeros, without)
    with_random, _ = model.prefill(params, {"tokens": tokens, "frames": torch.from_numpy(frontend_inputs(
        model.cfg, BATCH, 0)["frames"])})
    assert (with_random - without).abs().max() > 1e-2


@pytest.mark.parametrize("t", [32, 128])
def test_per_row_loss_matches_reference(t):
    check_per_row_loss(ARCH, t, None)


def test_weighted_loss_gradients_match_jax_grad():
    check_loss_gradients(ARCH, 32, False)


def _jax_serve(jmodel, jparams, prompts, frames):
    """examples/serve_decode.py's loop with frames: prefill, pad the cache,
    greedy decode with the frames passed to every step."""
    t = prompts.shape[1]
    batch = {"tokens": jnp.asarray(prompts), "frames": jnp.asarray(frames)}
    logits, cache = jax.jit(lambda p, bt: jmodel.prefill(p, bt))(jparams, batch)
    prefill = np.asarray(logits)
    cache = {kk: jnp.pad(c, ((0, 0), (0, 0), (0, DECODE_STEPS + 1), (0, 0), (0, 0))) for kk, c in cache.items()}
    decode = jax.jit(lambda p, tok, c, pos, fr: jmodel.decode_step(p, tok, c, pos, frames=fr))
    token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    tokens, step_logits = [np.asarray(token)], []
    for i in range(DECODE_STEPS):
        logits, cache = decode(jparams, token, cache, jnp.asarray(t + i, jnp.int32), batch["frames"])
        token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        step_logits.append(np.asarray(logits))
        tokens.append(np.asarray(token))
    return prefill, np.stack(step_logits), np.concatenate(tokens, axis=1)


@pytest.mark.parametrize("t", [32, 128])
def test_prefill_and_greedy_decode_match_jax(weights, t):
    """At T = 128 the decoder's self-attention takes the kernel (Pallas in
    interpret mode on the JAX side, the wrapper's plain version here).  The
    port's `serve.generate` encodes once; the reference re-encodes the
    frames at every decode step, with the same memory."""
    jmodel, jparams, model, params = weights
    prompts = np.random.default_rng(t).integers(0, 512, (BATCH, t)).astype(np.int32)
    frames = frontend_inputs(model.cfg, BATCH, t)["frames"]
    prefill, step_logits, tokens = _jax_serve(jmodel, jparams, prompts, frames)
    res = serve.generate(model, params, torch.from_numpy(prompts), DECODE_STEPS + 1, frames=torch.from_numpy(frames))
    np.testing.assert_allclose(res.prefill_logits.numpy(), prefill, **TOL)
    np.testing.assert_array_equal(res.tokens.numpy(), tokens)
    # the decode logits, step by step, from the port's prefill cache
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(prompts), "frames": torch.from_numpy(frames)})
    cache = serve._grow_kv_cache(model, cache, BATCH, t + DECODE_STEPS + 1, 0)
    enc_out = model.encode(params, torch.from_numpy(frames))
    for i in range(DECODE_STEPS):
        logits, cache = model.decode_step(params, torch.from_numpy(tokens[:, i:i + 1]), cache, t + i, enc_out=enc_out)
        np.testing.assert_allclose(logits.numpy(), step_logits[i], **TOL)


def test_memory_given_equals_frames_encoded(weights):
    """decode_step(enc_out=encode(frames)) is decode_step(frames=), and
    prefill(enc_out=) is prefill with the frames in the batch, bit for bit."""
    _, _, model, params = weights
    tokens = torch.from_numpy(np.random.default_rng(12).integers(0, 512, (BATCH, 32)))
    frames = torch.from_numpy(frontend_inputs(model.cfg, BATCH, 1)["frames"])
    enc_out = model.encode(params, frames)
    lg_f, cache_f = model.prefill(params, {"tokens": tokens, "frames": frames})
    lg_e, cache_e = model.prefill(params, {"tokens": tokens}, enc_out=enc_out)
    assert torch.equal(lg_f, lg_e) and all(torch.equal(cache_f[k], cache_e[k]) for k in cache_f)
    cache_f, cache_e = (serve._grow_kv_cache(model, c, BATCH, 40, 0) for c in (cache_f, cache_e))
    token = lg_f.argmax(-1)[:, None]
    step_f, _ = model.decode_step(params, token, cache_f, 32, frames=frames)
    step_e, _ = model.decode_step(params, token, cache_e, 32, enc_out=enc_out)
    assert torch.equal(step_f, step_e) and torch.equal(cache_f["k"], cache_e["k"])


def test_init_draws_the_reference_tree(weights):
    """`convert.init` draws the tree `params_from_jax` carries across: the
    decoder's xattn and ln_x leaves, the encoder stack and enc_norm, with the
    reference's shapes and dtypes."""
    _, _, model, params = weights
    drawn = convert.init(model.cfg, torch.Generator().manual_seed(0), "cpu")
    got = [(p, tuple(a.shape), a.dtype) for p, a in leaves_with_path(drawn)]
    assert got == [(p, tuple(a.shape), a.dtype) for p, a in leaves_with_path(params)]
    names = [p for p, _, _ in got]
    assert "['layers']['xattn']['wq']" in names and "['encoder']['attn']['wq']" in names
    assert "['enc_norm']['scale']" in names and not any(p.startswith("['encoder']['xattn']") for p in names)


def test_train_step_matches_reference():
    check_train_step(ARCH, "sync", 1, "sgd")


@pytest.mark.parametrize("mode", ["kasync", "kbatch"])
def test_async_modes_refuse_frames(weights, mode):
    """Both packages' async modes take tokens/targets batches only."""
    from repro.core import controller as jctl
    from repro.core import straggler as jstr
    from repro.optim import optimizers as jopt
    from repro_torch.core import controller as tctl
    from repro_torch.core import straggler as tstr
    from repro_torch.data import TokenStream
    from repro_torch.optim import optimizers as topt

    jmodel, jparams, model, params = weights
    jbatch, tbatch = both_batches(model.cfg, *TokenStream(512, 16, 4, device="cpu").batch_at(0))
    jo, jc = jopt.sgd(0.1), jctl.FixedKController(n_workers=4, k=2)
    jstate = jsteps.init_train_state(jmodel, jo, jc, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="tokens/targets batches only"):
        jsteps.make_train_step(jmodel, jo, jc, jstr.Exponential(1.0), 4, mode=mode)(
            jstate, jbatch, jax.random.PRNGKey(1))
    to, tc = topt.sgd(0.1), tctl.FixedKController(n_workers=4, k=2)
    step = steps.make_train_step(model, to, tc, tstr.Exponential(1.0), 4, mode=mode)
    with pytest.raises(ValueError, match="tokens/targets batches only"):
        step(steps.init_train_state(to, tc, params), tbatch, prng.PRNGKey(1))
