"""The port's layers (repro_torch.models.layers / transformer) against the JAX
package's, on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCH = "llama3.2-3b"
# f32 on both sides; the reductions (mean of squares, dot products, softmax
# sums) run in another order in XLA and in PyTorch: a few ulp.
F32 = dict(rtol=1e-5, atol=1e-6)
# bf16 products and roundings land on different sides of a bf16 ulp (2^-8).
BF16 = dict(rtol=2e-2, atol=2e-2)


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(x, dtype="float32"):
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = _rng(0)
    x = rng.standard_normal((2, 5, 384), dtype=np.float32) * 3
    scale = rng.standard_normal(384).astype(np.float32)
    jx, tx = _pair(x, dtype)
    out_j = jl.rmsnorm({"scale": jnp.asarray(scale)}, jx)
    out_t = tl.rmsnorm({"scale": torch.from_numpy(scale)}, tx)
    assert out_t.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("offset", [0, 1000])
def test_rope(offset):
    """Half-split rotation with theta 5e5.  Angles reach ~1000 rad at offset
    1000, where a 1-ulp difference in the frequency (pow in XLA vs PyTorch)
    moves the angle by ~6e-5 rad: hence atol 1e-4 there."""
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 3, 64), dtype=np.float32)
    pos = np.arange(offset, offset + 7, dtype=np.int32)
    jx, tx = _pair(x)
    out_j = jl.rope(jx, jnp.asarray(pos), 500_000.0)
    out_t = tl.rope(tx, torch.from_numpy(pos), 500_000.0)
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=1e-5, atol=1e-4 if offset else 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_sdpa_prefill(dtype, window):
    rng = _rng(2)
    q = rng.standard_normal((2, 16, 6, 64), dtype=np.float32)
    k = rng.standard_normal((2, 16, 2, 64), dtype=np.float32)
    v = rng.standard_normal((2, 16, 2, 64), dtype=np.float32)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    out_j = jl._sdpa(jax_smoke_config(ARCH), jq, jk, jv, jl.causal_window_mask(16, 16, 0, window))
    out_t = tl._sdpa(get_smoke_config(ARCH), tq, tk, tv, tl.causal_window_mask(16, 16, 0, window))
    np.testing.assert_allclose(_np(out_t), _np(out_j), **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_decode_grouped(dtype):
    """One query against a 24-slot cache of which 10 are valid, through
    `_sdpa` (t == 1 dispatches to the grouped form) and directly."""
    rng = _rng(3)
    q = rng.standard_normal((2, 1, 6, 64), dtype=np.float32)
    k = rng.standard_normal((2, 24, 2, 64), dtype=np.float32)
    v = rng.standard_normal((2, 24, 2, 64), dtype=np.float32)
    valid = np.arange(24) <= 9
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    jm, tm = jnp.asarray(valid)[None, None, None, :], torch.from_numpy(valid)[None, None, None, :]
    tol = F32 if dtype == "float32" else BF16
    out_j = jl._sdpa_decode_grouped(jq, jk, jv, jm, 2, 3, 64)
    out_t = tl._sdpa_decode_grouped(tq, tk, tv, tm, 2, 3, 64)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **tol)
    via_sdpa = tl._sdpa(get_smoke_config(ARCH), tq, tk, tv, tm)
    np.testing.assert_array_equal(_np(via_sdpa), _np(out_t))


@pytest.mark.parametrize("activation", ["silu_glu", "sq_relu", "gelu"])
def test_mlp(activation):
    rng = _rng(4)
    jcfg = jax_smoke_config(ARCH).replace(activation=activation)
    tcfg = get_smoke_config(ARCH).replace(activation=activation)
    d, f = jcfg.d_model, jcfg.d_ff
    x = rng.standard_normal((2, 5, d), dtype=np.float32)
    names = ("w_gate", "w_in", "w_out") if activation == "silu_glu" else ("w_in", "w_out")
    shapes = {"w_gate": (d, f), "w_in": (d, f), "w_out": (f, d)}
    w = {n: (rng.standard_normal(shapes[n]) / np.sqrt(shapes[n][0])).astype(np.float32) for n in names}
    out_j = jl.mlp({n: jnp.asarray(a) for n, a in w.items()}, jcfg, jnp.asarray(x))
    out_t = tl.mlp({n: torch.from_numpy(a) for n, a in w.items()}, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=1e-5, atol=1e-5)


def test_mlp_rejects_unknown_activation():
    with pytest.raises(ValueError, match="unknown activation"):
        tl.mlp({}, get_smoke_config(ARCH).replace(activation="relu6"), torch.zeros(1, 1, 4))


@pytest.mark.parametrize("case", [(0, 5), (2, 5), (3, 0)], ids=["window0", "offset2_window5", "offset3"])
def test_causal_window_mask(case):
    offset, window = case
    out_j = jl.causal_window_mask(6, 9, offset, window)
    out_t = tl.causal_window_mask(6, 9, offset, window)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("t,window", [(12, 5), (12, 0), (4, 5), (10, 5)])
def test_kv_to_ring_cache(t, window):
    x = _rng(5).standard_normal((2, t, 2, 8), dtype=np.float32)
    out_j = jt._kv_to_ring_cache(jnp.asarray(x), window)
    out_t = tt._kv_to_ring_cache(torch.from_numpy(x), window)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_embed_and_logits():
    """Embedding gather and the unmasked padded-vocab logits, untied and tied."""
    rng = _rng(6)
    for tied in (False, True):
        jcfg = jax_smoke_config(ARCH).replace(tie_embeddings=tied)
        tcfg = get_smoke_config(ARCH).replace(tie_embeddings=tied)
        emb = rng.standard_normal((jcfg.padded_vocab, jcfg.d_model), dtype=np.float32)
        head = rng.standard_normal((jcfg.d_model, jcfg.padded_vocab), dtype=np.float32)
        tokens = rng.integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
        jp = {"embed": jnp.asarray(emb), "lm_head": jnp.asarray(head)}
        tp = {"embed": torch.from_numpy(emb), "lm_head": torch.from_numpy(head)}
        xj = jl.embed(jp, jcfg, jnp.asarray(tokens))
        xt = tl.embed(tp, tcfg, torch.from_numpy(tokens).long())
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        lj, lt = jl.logits(jp, jcfg, xj), tl.logits(tp, tcfg, xt)
        assert lt.shape[-1] == jcfg.padded_vocab and lt.dtype == torch.float32
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5, atol=1e-4)
