"""The port's serving path (prefill + cache decode of the smoke configs of
llama3.2-3b, granite-moe-1b-a400m, qwen3-moe-30b-a3b, hymba-1.5b,
qwen1.5-110b and nemotron-4-340b) against the JAX package, with the same
weights.  The vlm and encdec archs' serving is held in tests/test_torch_vlm.py
and tests/test_torch_encdec.py.

Weights come from the JAX `model.init` and cross through `params_from_jax`.
At T=128 the JAX side runs the Pallas flash-attention kernel (interpret mode
on the CPU) and the port its wrapper (plain version on the CPU); T=32 takes
the non-kernel dispatch on both sides; window=64 (hymba: its sliding window
32) the ring cache.  hymba's cache also holds the SSM state.

Tolerance: rtol = atol = 1e-4 on f32 logits and caches (XLA and PyTorch sum
in other orders through two layers and a 512-way vocab projection: ~1e-6
seen), and exact equality of greedy tokens.  Prefill against decode within
the reference's own bounds (rtol 2e-3, atol 2e-4), the MoE archs at
capacity factor 4.0, where no token is dropped in either path, as
tests/test_models.py::test_prefill_decode_consistency_moe_no_drop holds them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config, list_archs  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "llama3.2-3b"
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, DECODE_STEPS = 2, 8
NEW_ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "hymba-1.5b"]
# dense archs at other shapes: QKV bias and a group of 4 (qwen1.5-110b's
# smoke config); squared ReLU, hd 48 and a group of 4 (nemotron-4-340b's)
DENSE_ARCHS = ["qwen1.5-110b", "nemotron-4-340b"]
# (arch, prompt length, window); llama3.2-3b's ids stay "T{t}_window{w}"
CASES = [(ARCH, 128, 0), (ARCH, 128, 64), (ARCH, 32, 0)] + [
    (arch, t, w) for arch in NEW_ARCHS + DENSE_ARCHS
    for t, w in ((128, 0), (128, 32 if arch == "hymba-1.5b" else 64), (32, 0))]
_WEIGHTS = {}


def _weights(arch):
    """(JAX model with use_pallas, JAX params, port params), once per arch."""
    if arch not in _WEIGHTS:
        jcfg = jax_smoke_config(arch).replace(use_pallas=True)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
        _WEIGHTS[arch] = jmodel, jparams, tparams
    return _WEIGHTS[arch]


@pytest.fixture(scope="module")
def weights():
    return _weights(ARCH)


def _jax_serve(jmodel, jparams, prompts, window):
    """examples/serve_decode.py's loop: prefill, pad the cache, greedy decode."""
    t = prompts.shape[1]
    logits, cache = jax.jit(lambda p, bt: jmodel.prefill(p, bt, window=window))(
        jparams, {"tokens": jnp.asarray(prompts)}
    )
    prefill = (np.asarray(logits), {k: np.asarray(v) for k, v in cache.items()})
    if not window:
        pad = t + DECODE_STEPS + 1 - cache["k"].shape[2]
        cache = {kk: jnp.pad(c, ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0))) if kk in ("k", "v") else c
                 for kk, c in cache.items()}
    decode = jax.jit(lambda p, tok, c, pos: jmodel.decode_step(p, tok, c, pos, window=window))
    token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    tokens, step_logits = [np.asarray(token)], []
    for i in range(DECODE_STEPS):
        logits, cache = decode(jparams, token, cache, jnp.asarray(t + i, jnp.int32))
        token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        step_logits.append(np.asarray(logits))
        tokens.append(np.asarray(token))
    return prefill, np.stack(step_logits), np.concatenate(tokens, axis=1)


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: (f"{c[0]}_" if c[0] != ARCH else "") + f"T{c[1]}_window{c[2]}")
def case(request):
    arch, t, window = request.param
    jmodel, jparams, tparams = _weights(arch)
    prompts = np.random.default_rng(t + window).integers(0, 512, (BATCH, t)).astype(np.int32)
    prefill, step_logits, tokens = _jax_serve(jmodel, jparams, prompts, window)
    model = build_model(get_smoke_config(arch), device="cpu")
    return dict(window=window, prompts=prompts, jax_prefill=prefill, jax_step_logits=step_logits,
                jax_tokens=tokens, model=model, params=tparams)


def test_prefill_logits_match_jax(case):
    logits, _ = case["model"].prefill(case["params"], {"tokens": torch.from_numpy(case["prompts"])},
                                      window=case["window"])
    assert logits.dtype == torch.float32 and logits.shape == (BATCH, 512)
    np.testing.assert_allclose(logits.numpy(), case["jax_prefill"][0], **TOL)


def test_prefill_cache_matches_jax(case):
    _, cache = case["model"].prefill(case["params"], {"tokens": torch.from_numpy(case["prompts"])},
                                     window=case["window"])
    assert sorted(cache) == sorted(case["jax_prefill"][1])
    for kk in cache:
        assert tuple(cache[kk].shape) == case["jax_prefill"][1][kk].shape
        np.testing.assert_allclose(cache[kk].numpy(), case["jax_prefill"][1][kk], **TOL)


def test_decode_logits_and_tokens_match_jax(case):
    model, params, window = case["model"], case["params"], case["window"]
    t = case["prompts"].shape[1]
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(case["prompts"])}, window=window)
    if not window:
        full = model.init_cache(BATCH, t + DECODE_STEPS + 1)
        for kk in ("k", "v"):
            full[kk][:, :, :t] = cache[kk]
        cache = {**cache, "k": full["k"], "v": full["v"]}
    token = torch.argmax(logits, dim=-1)[:, None]
    tokens = [token]
    for i in range(DECODE_STEPS):
        logits, cache = model.decode_step(params, token, cache, t + i, window=window)
        np.testing.assert_allclose(logits.numpy(), case["jax_step_logits"][i], **TOL)
        token = torch.argmax(logits, dim=-1)[:, None]
        tokens.append(token)
    np.testing.assert_array_equal(torch.cat(tokens, 1).numpy(), case["jax_tokens"])


def test_generate_matches_jax_serving_loop(case):
    """The port's serving entry point (launch/serve.generate) gives the JAX
    example's greedy tokens, and its first token from the prefill logits."""
    res = serve.generate(case["model"], case["params"], torch.from_numpy(case["prompts"]),
                         DECODE_STEPS + 1, window=case["window"])
    np.testing.assert_array_equal(res.tokens.numpy(), case["jax_tokens"])
    np.testing.assert_allclose(res.prefill_logits.numpy(), case["jax_prefill"][0], **TOL)


@pytest.mark.parametrize("t,expected", [(128, 2), (256, 2), (32, 0), (130, 0)])
def test_prefill_attention_dispatch(monkeypatch, weights, t, expected):
    """Every layer's attention goes through the kernel wrapper exactly when
    the prompt length is a multiple of 128, as layers.py:250 of the JAX package."""
    calls = []
    real = attn_ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(attn_ops, "flash_attention", spy)
    model = build_model(get_smoke_config(ARCH), device="cpu")
    prompts = torch.zeros((1, t), dtype=torch.long)
    model.prefill(weights[2], {"tokens": prompts})
    assert len(calls) == expected
    if expected:
        model_plain = build_model(get_smoke_config(ARCH).replace(use_kernels=False), device="cpu")
        calls.clear()
        model_plain.prefill(weights[2], {"tokens": prompts})
        assert not calls


def test_window_wider_than_the_run_equals_full_attention(weights):
    """With window >= prompt + new tokens no key ever expires, so greedy
    tokens equal the window=0 run.  (The JAX example cannot be the reference
    here: its cache stays prompt-long and dynamic_update_slice clamps every
    decode write onto the last prompt slot; see ROADMAP.md Queue 3.)"""
    model = build_model(get_smoke_config(ARCH), device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(9).integers(0, 512, (BATCH, 32)))
    full = serve.generate(model, weights[2], prompts, 9)
    wide = serve.generate(model, weights[2], prompts, 9, window=64)
    np.testing.assert_array_equal(wide.tokens.numpy(), full.tokens.numpy())


def test_decode_past_the_cache_end_raises(weights):
    model = build_model(get_smoke_config(ARCH), device="cpu")
    _, cache = model.prefill(weights[2], {"tokens": torch.zeros((1, 32), dtype=torch.long)})
    with pytest.raises(ValueError, match="past the cache length"):
        model.decode_step(weights[2], torch.zeros((1, 1), dtype=torch.long), cache, 32)


@pytest.mark.parametrize("which", ["full", "smoke"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-3b", "qwen1.5-0.5b"] + NEW_ARCHS + DENSE_ARCHS
                         + ["seamless-m4t-medium", "paligemma-3b"])
def test_config_is_a_copy_of_the_jax_config(arch, which):
    """Field for field the JAX package's config, with use_pallas renamed use_kernels."""
    port = get_config(arch) if which == "full" else get_smoke_config(arch)
    ref = jax_get_config(arch) if which == "full" else jax_smoke_config(arch)
    pd, rd = dataclasses.asdict(port), dataclasses.asdict(ref)
    assert pd.pop("use_kernels") is True and rd.pop("use_pallas") is False
    assert pd == rd
    assert (port.padded_vocab, port.resolved_head_dim, port.q_groups) == (
        ref.padded_vocab, ref.resolved_head_dim, ref.q_groups)


def test_registry_lists_only_ported_archs():
    """Every arch of the JAX package is ported: the two registries list the
    same ten, and each family's model builds."""
    from repro.configs import list_archs as jax_list_archs
    from repro_torch.models import transformer

    assert list_archs() == sorted(jax_list_archs()) == [
        "granite-moe-1b-a400m", "hymba-1.5b", "llama3.2-3b", "nemotron-4-340b", "paligemma-3b", "qwen1.5-0.5b",
        "qwen1.5-110b", "qwen3-moe-30b-a3b", "rwkv6-3b", "seamless-m4t-medium"]
    assert {get_config(arch).family for arch in list_archs()} == set(transformer.PORTED_FAMILIES)
    with pytest.raises(ValueError, match="unknown arch"):
        get_smoke_config("gpt-2")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(get_smoke_config(ARCH).replace(family="rnn"), device="cpu")


def test_params_from_jax_keeps_bf16_bits():
    x = np.asarray(jnp.asarray(np.linspace(-3, 3, 11, dtype=np.float32), jnp.bfloat16))
    out = params_from_jax({"a": {"b": x}}, device="cpu")["a"]["b"]
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.view(torch.int16).numpy(), x.view(np.int16))


@pytest.mark.parametrize("arch,window,cf", [
    ("granite-moe-1b-a400m", 0, 4.0), ("qwen3-moe-30b-a3b", 0, 4.0), ("hymba-1.5b", 0, None),
    ("hymba-1.5b", 16, None)])
def test_prefill_decode_consistency(arch, window, cf):
    """The port's counterpart of tests/test_models.py::_prefill_decode_consistency:
    the prefill logits of T tokens equal a prefill of T - 1 and one decode
    step (the MoE archs at capacity factor 4.0, where neither path drops)."""
    cfg = get_smoke_config(arch)
    if cf is not None:
        cfg = cfg.replace(capacity_factor=cf)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    t = 32
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, t)))
    full, _ = model.prefill(params, {"tokens": toks}, window=window)
    _, cache = model.prefill(params, {"tokens": toks[:, :t - 1]}, window=window)
    if not window:
        grown = model.init_cache(BATCH, t)
        for kk in ("k", "v"):
            grown[kk][:, :, :t - 1] = cache[kk]
        cache = {**cache, "k": grown["k"], "v": grown["v"]}
    else:
        assert cache["k"].shape[2] == window  # the ring cache
    step, _ = model.decode_step(params, toks[:, t - 1:], cache, t - 1, window=window)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_generate_grows_only_the_kv_cache(arch):
    """serve.generate copies k and v into the decode horizon and hands
    hymba's SSM state to the first decode step as prefill left it."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (BATCH, 32)))
    _, cache = model.prefill(params, {"tokens": prompts})
    grown = serve._grow_kv_cache(model, cache, BATCH, 40, 0)
    assert sorted(grown) == sorted(cache) and grown["k"].shape[2] == 40
    for kk in cache:
        if kk in ("k", "v"):
            assert torch.equal(grown[kk][:, :, :32], cache[kk]) and not grown[kk][:, :, 32:].any()
        else:
            assert grown[kk] is cache[kk]
