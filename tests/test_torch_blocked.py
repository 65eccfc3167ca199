"""Blocked attention (`layers._sdpa_blocked`, ``attention_impl="blocked"``)
against the JAX package's `_sdpa_blocked` and the port's naive path.

The reference's own cases (tests/test_perf_features.py): llama3.2-3b smoke,
x (2, 64, D) * 0.1, (causal, window, blk) in {(T, 0, 16), (T, 8, 16),
(T, 0, 64), (F, 0, 32)}; the port's blocked path within 1e-5 of the
reference's blocked path and of the port's naive path.  Then the model's
loss and gradients with blocked attention against the naive ones (1e-5),
the single-block fallback when blk does not divide S, bf16, and the
per-block recomputation in the backward pass.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-5
ARCH = "llama3.2-3b"
T = 64


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _attention_pair():
    """The reference's attention parameters (PRNGKey(0)) in both packages,
    and a seeded input x (2, T, D) * 0.1."""
    jcfg = jax_smoke_config(ARCH)
    jp = jl.attention_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, T, jcfg.d_model), dtype=np.float32) * 0.1
    return jcfg, jp, tp, x


@pytest.mark.parametrize("causal,window,blk", [(True, 0, 16), (True, 8, 16), (True, 0, 64), (False, 0, 32)])
def test_blocked_attention_matches_the_reference_and_naive(causal, window, blk):
    jcfg, jp, tp, x = _attention_pair()
    cfg = get_smoke_config(ARCH).replace(use_kernels=False)
    pos = np.arange(T)
    y_ref = jl.attention_full(jp, jcfg.replace(attention_impl="blocked", attention_block=blk), jnp.asarray(x),
                              jnp.asarray(pos), causal=causal, window=window)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    y_b = tl.attention_full(tp, cfg.replace(attention_impl="blocked", attention_block=blk), tx, tpos, causal=causal,
                            window=window)
    y_n = tl.attention_full(tp, cfg, tx, tpos, causal=causal, window=window)
    np.testing.assert_allclose(_np(y_b), _np(y_ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(y_b), _np(y_n), rtol=0, atol=ATOL)


@pytest.mark.parametrize("s,blk", [(48, 32), (64, 24), (40, 1024)])
def test_blocked_falls_back_to_one_block_when_blk_does_not_divide_s(s, blk):
    """``blk = min(attention_block, S)``, and S itself when that does not
    divide S: the same output as the reference's at every such shape,
    with GQA (6 q heads on 2 kv heads) and a shorter query than key axis."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 16, 6, 64), dtype=np.float32)
    k, v = (rng.standard_normal((2, s, 2, 64), dtype=np.float32) for _ in range(2))
    jcfg = jax_smoke_config(ARCH).replace(attention_block=blk)
    cfg = get_smoke_config(ARCH).replace(attention_block=blk)
    want = jl._sdpa_blocked(jcfg, *(jnp.asarray(a) for a in (q, k, v)), causal=True, window=0)
    got = tl._sdpa_blocked(cfg, *(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)


def test_blocked_attention_in_bf16_follows_the_reference():
    """bf16 q, k, v: the scores and the running sums stay f32, p is cast to
    bf16 for its product with v, as the reference does; the output lands
    within a bf16 ulp of the reference's (2^-8 of its scale)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, T, 6, 64), dtype=np.float32) for _ in range(3))
    jcfg = jax_smoke_config(ARCH).replace(attention_block=16)
    cfg = get_smoke_config(ARCH).replace(attention_block=16)
    want = jl._sdpa_blocked(jcfg, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True, window=8)
    got = tl._sdpa_blocked(cfg, *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), causal=True, window=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def _model_case():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 32))
    batch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(np.roll(toks, -1, 1))}
    return jcfg, jparams, params, batch


def _grads(model, params, batch):
    leaves = {k: v for k, v in params.items()}
    flat, spec = torch.utils._pytree.tree_flatten(leaves)
    xs = [p.detach().requires_grad_() for p in flat]
    loss = model.loss_fn(torch.utils._pytree.tree_unflatten(xs, spec), batch)[0].sum()
    return torch.autograd.grad(loss, xs)


def test_blocked_model_loss_and_gradients_match_naive_and_the_reference():
    jcfg, jparams, params, batch = _model_case()
    cfg = get_smoke_config(ARCH)
    naive, blocked = build_model(cfg, "cpu"), build_model(cfg.replace(attention_impl="blocked", attention_block=16),
                                                          "cpu")
    l_n, _ = naive.loss_fn(params, batch)
    l_b, _ = blocked.loss_fn(params, batch)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    l_ref, _ = jax_build_model(jcfg.replace(attention_impl="blocked", attention_block=16)).loss_fn(jparams, jbatch)
    np.testing.assert_allclose(_np(l_b), _np(l_n), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(l_b), np.asarray(l_ref), rtol=0, atol=ATOL)
    err = max(float((a - b).abs().max()) for a, b in zip(_grads(naive, params, batch), _grads(blocked, params, batch)))
    assert err < ATOL, err


def test_blocked_bodies_are_recomputed_in_the_backward_pass(monkeypatch):
    """Each key block's body goes through `torch.utils.checkpoint` under
    grad mode (the reference's `jax.checkpoint`), and runs as it is
    without grad or under a `torch.func` transform."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    cfg = get_smoke_config(ARCH).replace(attention_block=16)
    q, k, v = (torch.randn(1, T, 2, 16, generator=torch.Generator().manual_seed(i)) for i in range(3))
    with torch.enable_grad():
        q.requires_grad_()
        out = tl._sdpa_blocked(cfg, q, k, v, causal=True, window=0)
        out.sum().backward()
    assert calls == ["body"] * (T // 16)
    with torch.no_grad():
        tl._sdpa_blocked(cfg, q, k, v, causal=True, window=0)
    g = torch.func.grad(lambda qq: tl._sdpa_blocked(cfg, qq, k, v, causal=True, window=0).sum())(q.detach())
    assert calls == ["body"] * (T // 16)
    np.testing.assert_allclose(_np(g), _np(q.grad), rtol=1e-5, atol=1e-6)
