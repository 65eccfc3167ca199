"""The port's rwkv6-3b serving path (RWKV-6 time-mix, channel-mix, the ssm
layer stack, prefill and state decode) against the JAX package, with the
same weights.

Weights come from the JAX `model.init` of the smoke config and cross through
`params_from_jax`.  With `use_pallas=True` the JAX side runs the Pallas wkv
kernel (interpret mode on the CPU) in every prefill layer of more than one
token, and the port, with `use_kernels=True`, its wkv wrapper (plain version
on the CPU).

Tolerance: rtol = atol = 1e-4 on f32 logits, cache leaves and block outputs
(XLA and PyTorch sum in other orders, and the two wkv scans round their
intra-chunk scores differently), and exact equality of greedy tokens.
Measured: logits at most 1.3e-5 off in prefill and decode, cache leaves
1.9e-5 (the f32 state), time-mix 2.5e-6 (state 4.5e-6), channel-mix 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.wkv import ops as wkv_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, linear_scan, rwkv  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402

ARCH = "rwkv6-3b"
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, DECODE_STEPS = 2, 8
PROMPT_LENS = [16, 64, 128]


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH).replace(use_pallas=True)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, tparams


def _jax_serve(jmodel, jparams, prompts):
    """examples/serve_decode.py's loop for the ssm family: prefill, then
    greedy decode against the prefill state as it is."""
    t = prompts.shape[1]
    logits, cache = jax.jit(lambda p, bt: jmodel.prefill(p, bt))(jparams, {"tokens": jnp.asarray(prompts)})
    prefill = (np.asarray(logits), {k: np.asarray(v) for k, v in cache.items()})
    decode = jax.jit(jmodel.decode_step)
    token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    tokens, step_logits = [np.asarray(token)], []
    for i in range(DECODE_STEPS):
        logits, cache = decode(jparams, token, cache, jnp.asarray(t + i, jnp.int32))
        token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        step_logits.append(np.asarray(logits))
        tokens.append(np.asarray(token))
    final = {k: np.asarray(v) for k, v in cache.items()}
    return prefill, np.stack(step_logits), np.concatenate(tokens, axis=1), final


@pytest.fixture(scope="module", params=PROMPT_LENS, ids=lambda t: f"T{t}")
def case(request, weights):
    t = request.param
    jmodel, jparams, tparams = weights
    prompts = np.random.default_rng(t).integers(0, 512, (BATCH, t)).astype(np.int32)
    prefill, step_logits, tokens, final = _jax_serve(jmodel, jparams, prompts)
    model = build_model(get_smoke_config(ARCH), device="cpu")
    return dict(prompts=prompts, jax_prefill=prefill, jax_step_logits=step_logits, jax_tokens=tokens,
                jax_final_cache=final, model=model, params=tparams)


def test_prefill_logits_match_jax(case):
    logits, _ = case["model"].prefill(case["params"], {"tokens": torch.from_numpy(case["prompts"])})
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, 512)
    np.testing.assert_allclose(logits.numpy(), case["jax_prefill"][0], **TOL)


def test_prefill_cache_matches_jax(case):
    _, cache = case["model"].prefill(case["params"], {"tokens": torch.from_numpy(case["prompts"])})
    jcache = case["jax_prefill"][1]
    assert sorted(cache) == sorted(jcache) == ["s", "x_att", "x_ffn"]
    for kk in cache:
        assert tuple(cache[kk].shape) == jcache[kk].shape
        assert str(cache[kk].dtype).split(".")[-1] == str(jcache[kk].dtype)
        np.testing.assert_allclose(cache[kk].numpy(), jcache[kk], **TOL)


def test_decode_logits_tokens_and_state_match_jax(case):
    model, params = case["model"], case["params"]
    t = case["prompts"].shape[1]
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(case["prompts"])})
    token = torch.argmax(logits, dim=-1)[:, None]
    tokens = [token]
    for i in range(DECODE_STEPS):
        logits, cache = model.decode_step(params, token, cache, t + i)
        np.testing.assert_allclose(logits.numpy(), case["jax_step_logits"][i], **TOL)
        token = torch.argmax(logits, dim=-1)[:, None]
        tokens.append(token)
    np.testing.assert_array_equal(torch.cat(tokens, 1).numpy(), case["jax_tokens"])
    for kk, a in cache.items():
        np.testing.assert_allclose(a.numpy(), case["jax_final_cache"][kk], **TOL)


def test_generate_matches_jax_serving_loop(case):
    """The port's serving entry point decodes against the prefill state as
    it is, and gives the JAX loop's greedy tokens."""
    res = serve.generate(case["model"], case["params"], torch.from_numpy(case["prompts"]), DECODE_STEPS + 1)
    np.testing.assert_array_equal(res.tokens.numpy(), case["jax_tokens"])
    np.testing.assert_allclose(res.prefill_logits.numpy(), case["jax_prefill"][0], **TOL)


def test_window_has_no_effect_on_the_ssm_family(weights):
    model = build_model(get_smoke_config(ARCH), device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (BATCH, 32)))
    full = serve.generate(model, weights[2], prompts, 5)
    windowed = serve.generate(model, weights[2], prompts, 5, window=8)
    np.testing.assert_array_equal(windowed.tokens.numpy(), full.tokens.numpy())
    np.testing.assert_array_equal(windowed.prefill_logits.numpy(), full.prefill_logits.numpy())


def _block_inputs(cfg, t, seed):
    rng = np.random.default_rng(seed)
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    return (rng.standard_normal((BATCH, t, d), dtype=np.float32),
            rng.standard_normal((BATCH, d), dtype=np.float32),
            rng.standard_normal((BATCH, h, hd, hd), dtype=np.float32) * 0.2)


@pytest.mark.parametrize("carry", [False, True], ids=["no_carry", "carry"])
@pytest.mark.parametrize("t", [64, 1])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_time_mix_matches_jax(weights, use_kernels, t, carry):
    """Layer 0's time-mix: prefill (T=64) and a T=1 step, with and without
    the token-shift and state carries."""
    jcfg = jax_smoke_config(ARCH).replace(use_pallas=use_kernels)
    cfg = get_smoke_config(ARCH).replace(use_kernels=use_kernels)
    jp = jax.tree.map(lambda a: a[0], weights[1]["layers"]["tmix"])
    tp = layer_params(weights[2]["layers"], 0)["tmix"]
    x, x_prev, s0 = _block_inputs(cfg, t, seed=t + carry)
    jargs = (jnp.asarray(x_prev), jnp.asarray(s0)) if carry else ()
    targs = (torch.from_numpy(x_prev), torch.from_numpy(s0)) if carry else ()
    jy, jxp, js = jax_rwkv.time_mix(jp, jcfg, jnp.asarray(x), *jargs)
    y, xp, s = rwkv.time_mix(tp, cfg, torch.from_numpy(x), *targs)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("carry", [False, True], ids=["no_carry", "carry"])
@pytest.mark.parametrize("t", [64, 1])
def test_channel_mix_matches_jax(weights, t, carry):
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = jax.tree.map(lambda a: a[1], weights[1]["layers"]["cmix"])
    tp = layer_params(weights[2]["layers"], 1)["cmix"]
    x, x_prev, _ = _block_inputs(cfg, t, seed=10 + t + carry)
    jy, jxp = jax_rwkv.channel_mix(jp, jcfg, jnp.asarray(x), jnp.asarray(x_prev) if carry else None)
    y, xp = rwkv.channel_mix(tp, cfg, torch.from_numpy(x), torch.from_numpy(x_prev) if carry else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp))


@pytest.mark.parametrize("t,kernel_calls,step_calls", [(64, 2, 0), (16, 2, 0), (1, 0, 2)])
@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernels", "plain"])
def test_prefill_wkv_dispatch(monkeypatch, weights, use_kernels, t, kernel_calls, step_calls):
    """With use_kernels every prefill layer calls ops.wkv6 (chunk 32), with
    it off none does; a one-token prefill takes the step path, as
    rwkv.py:86-99 of the JAX package."""
    calls = {"kernel": [], "chunked": 0, "step": 0}
    real_kernel, real_chunked, real_step = wkv_ops.wkv6, linear_scan.wkv6_chunked, linear_scan.wkv6_step

    def spy_kernel(*a, **kw):
        calls["kernel"].append(kw["chunk"])
        return real_kernel(*a, **kw)

    def spy_chunked(*a, **kw):
        calls["chunked"] += 1
        return real_chunked(*a, **kw)

    def spy_step(*a, **kw):
        calls["step"] += 1
        return real_step(*a, **kw)

    monkeypatch.setattr(wkv_ops, "wkv6", spy_kernel)
    monkeypatch.setattr(linear_scan, "wkv6_chunked", spy_chunked)
    monkeypatch.setattr(linear_scan, "wkv6_step", spy_step)
    cfg = get_smoke_config(ARCH).replace(use_kernels=use_kernels)
    build_model(cfg, device="cpu").prefill(weights[2], {"tokens": torch.zeros((1, t), dtype=torch.long)})
    assert calls["kernel"] == ([cfg.wkv_chunk] * kernel_calls if use_kernels else [])
    # the model calls the chunked scan itself only with use_kernels off
    assert calls["chunked"] == (0 if use_kernels else kernel_calls)
    assert calls["step"] == step_calls


def test_init_draws_the_jax_tree():
    """convert.init gives the JAX init's tree: names, shapes, dtypes, and its
    constant leaves exactly."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jtree = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    from repro_torch.checkpoint import convert

    tree = convert.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(jtree)[0]}

    def walk(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", v

    flat_t = dict(walk(tree))
    assert sorted(flat_t) == sorted(flat_j)
    for name, a in flat_t.items():
        assert tuple(a.shape) == flat_j[name].shape, name
        assert str(a.dtype).split(".")[-1] == str(flat_j[name].dtype), name
    tm, cm = tree["layers"]["tmix"], tree["layers"]["cmix"]
    assert bool((tm["mu"] == 0.5).all()) and bool((cm["mu_c"] == 0.5).all())
    assert bool((tm["decay_w0"] == -1.0).all()) and bool((tm["ln_out"] == 1.0).all())
    # N(0, 1/fan_in): fan-in d for the projections and a1, 64 for a2, hd for u
    d, hd = cfg.d_model, cfg.resolved_head_dim
    for leaf, fan_in in ((tm["wr"], d), (tm["decay_a1"], d), (tm["decay_a2"], 64), (tm["bonus_u"], hd),
                         (cm["w_out"], cfg.d_ff)):
        assert abs(leaf.float().std().item() * np.sqrt(fan_in) - 1.0) < 0.1
