"""The vlm family (paligemma-3b's smoke config: MQA, one kv head for four
query heads) against the JAX package: the loss over the token positions
after the patch prefix, prefill with the patches before the prompt, decode
at position P + T + i, and the train step.

Weights cross from the JAX `init` through `params_from_jax`; the patches
are seeded random arrays, never zeros (zero patches are a prefix that
still moves the logits, but random ones exercise every width of it).  With
the smoke config's P = 16 patches, a prompt of 112 makes P + T = 128, which
takes the kernel (Pallas in interpret mode on the JAX side, the wrapper's
plain version here), and 128 makes 144, which does not.

Tolerances: per-row losses 1e-5 relative; prefill logits and caches and
decode logits rtol = atol = 1e-5 (~3e-6 seen against logits up to ~3.2)
and greedy tokens equal; gradients and the train step as
tests/test_torch_train.py holds every arch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from test_torch_train import (  # noqa: E402
    both_batches, check_loss_gradients, check_per_row_loss, check_train_step, frontend_inputs)

ARCH = "paligemma-3b"
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, DECODE_STEPS = 2, 8


@pytest.fixture(scope="module")
def weights():
    """(JAX model with use_pallas, JAX params, port model, port params)."""
    jmodel = jax_build_model(jax_smoke_config(ARCH).replace(use_pallas=True))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return (jmodel, jparams, build_model(get_smoke_config(ARCH), device="cpu"),
            params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))


@pytest.mark.parametrize("t", [32, 112, 128])
def test_per_row_loss_matches_reference(t):
    check_per_row_loss(ARCH, t, None)


def test_weighted_loss_gradients_match_jax_grad():
    check_loss_gradients(ARCH, 32, False)


def _jax_serve(jmodel, jparams, prompts, patches):
    """examples/serve_decode.py's loop with patches: prefill, pad the cache
    to P + T + the new tokens, greedy decode at position P + T + i."""
    t, npfx = prompts.shape[1], patches.shape[1]
    batch = {"tokens": jnp.asarray(prompts), "patches": jnp.asarray(patches)}
    logits, cache = jax.jit(lambda p, bt: jmodel.prefill(p, bt))(jparams, batch)
    prefill = (np.asarray(logits), {k: np.asarray(v) for k, v in cache.items()})
    cache = {kk: jnp.pad(c, ((0, 0), (0, 0), (0, DECODE_STEPS + 1), (0, 0), (0, 0))) for kk, c in cache.items()}
    decode = jax.jit(lambda p, tok, c, pos: jmodel.decode_step(p, tok, c, pos))
    token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    tokens, step_logits = [np.asarray(token)], []
    for i in range(DECODE_STEPS):
        logits, cache = decode(jparams, token, cache, jnp.asarray(t + npfx + i, jnp.int32))
        token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        step_logits.append(np.asarray(logits))
        tokens.append(np.asarray(token))
    return prefill, np.stack(step_logits), np.concatenate(tokens, axis=1)


@pytest.fixture(scope="module", params=[112, 128], ids=lambda t: f"P_plus_T{16 + t}")
def case(request, weights):
    jmodel, jparams, model, params = weights
    t = request.param
    prompts = np.random.default_rng(t).integers(0, 512, (BATCH, t)).astype(np.int32)
    patches = frontend_inputs(model.cfg, BATCH, t)["patches"]
    prefill, step_logits, tokens = _jax_serve(jmodel, jparams, prompts, patches)
    return dict(prompts=prompts, patches=patches, jax_prefill=prefill, jax_step_logits=step_logits,
                jax_tokens=tokens, model=model, params=params)


def _batch(case):
    return {"tokens": torch.from_numpy(case["prompts"]), "patches": torch.from_numpy(case["patches"])}


def test_prefill_logits_and_cache_match_jax(case):
    logits, cache = case["model"].prefill(case["params"], _batch(case))
    np.testing.assert_allclose(logits.numpy(), case["jax_prefill"][0], **TOL)
    assert sorted(cache) == ["k", "v"]
    p_plus_t = case["patches"].shape[1] + case["prompts"].shape[1]
    for kk in cache:
        assert cache[kk].shape[2] == p_plus_t  # the patches' positions come first
        np.testing.assert_allclose(cache[kk].numpy(), case["jax_prefill"][1][kk], **TOL)


def test_decode_at_prefix_plus_prompt_matches_jax(case):
    """Decode step i at pos = P + T + i, from the prefill's cache, logits
    step by step and the greedy tokens of `serve.generate`."""
    model, params = case["model"], case["params"]
    p_plus_t = case["patches"].shape[1] + case["prompts"].shape[1]
    logits, cache = model.prefill(params, _batch(case))
    cache = serve._grow_kv_cache(model, cache, BATCH, p_plus_t + DECODE_STEPS + 1, 0)
    token = torch.argmax(logits, dim=-1)[:, None]
    for i in range(DECODE_STEPS):
        logits, cache = model.decode_step(params, token, cache, p_plus_t + i)
        np.testing.assert_allclose(logits.numpy(), case["jax_step_logits"][i], **TOL)
        token = torch.argmax(logits, dim=-1)[:, None]
    res = serve.generate(model, params, torch.from_numpy(case["prompts"]), DECODE_STEPS + 1,
                         patches=torch.from_numpy(case["patches"]))
    np.testing.assert_array_equal(res.tokens.numpy(), case["jax_tokens"])


def test_kernel_takes_every_layer_when_patches_and_prompt_fill_tiles(case, monkeypatch):
    """Every prefill layer's attention goes through the kernel wrapper
    exactly when P + T is a multiple of 128, as layers.py:250 of the JAX
    package decides on the sequence it is given."""
    calls = []
    real = attn_ops.flash_attention

    def spy(*a, **kw):
        calls.append(tuple(a[0].shape))
        return real(*a, **kw)

    monkeypatch.setattr(attn_ops, "flash_attention", spy)
    case["model"].prefill(case["params"], _batch(case))
    p_plus_t = case["patches"].shape[1] + case["prompts"].shape[1]
    cfg = case["model"].cfg
    want = [(BATCH, p_plus_t, cfg.n_heads, cfg.resolved_head_dim)] * cfg.n_layers if p_plus_t % 128 == 0 else []
    assert calls == want


def test_train_step_matches_reference():
    check_train_step(ARCH, "sync", 1, "sgd")


@pytest.mark.parametrize("mode", ["kasync", "kbatch"])
def test_async_modes_refuse_patches(weights, mode):
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
