"""The port's Hymba pieces against the JAX package on the CPU: the
Mamba2-style SSM scan (`linear_scan.ssm_chunked`, `ssm_step`) and the
parallel attention + SSM mix (`hybrid.hymba_mix_full`,
`hymba_mix_decode`) at hymba-1.5b's smoke width, with seeded numpy inputs
and the same weights through `params_from_jax`.

Tolerances: the scans and the mix within rtol = atol = 1e-5 of the
reference (f32 throughout; XLA and torch sum the chunk products in other
orders: ~1e-7 seen); the chunked scan against stepping token by token
within 1e-4 (tests/test_models.py's bound for the same comparison).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import linear_scan as jscan  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import hybrid, linear_scan  # noqa: E402

ARCH = "hymba-1.5b"
TOL = dict(rtol=1e-5, atol=1e-5)
B, T, H, P, N = 2, 64, 3, 8, 4


def _ssm_inputs(seed=0, t=T, decay=1.0):
    """x (B,T,H,P), dt (B,T,H) > 0, a (H,) < 0, b and c (B,T,H,N), s0 (B,H,N,P):
    decays exp(a dt) from ~0.05 to ~0.9 at decay=1."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(B, t, H))).astype(np.float32)  # softplus
    a = (-np.exp(f(H) * 0.5) * decay).astype(np.float32)
    return f(B, t, H, P), dt, a, f(B, t, H, N), f(B, t, H, N), f(B, H, N, P) * 0.3


def _t(xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _j(xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssm_chunked_matches_reference(chunk, with_s0):
    x, dt, a, bm, cm, s0 = _ssm_inputs()
    s0 = s0 if with_s0 else None
    jy, js = jscan.ssm_chunked(*_j((x, dt, a, bm, cm, s0)), chunk=chunk)
    y, s = linear_scan.ssm_chunked(*_t((x, dt, a, bm, cm, s0)), chunk=chunk)
    assert y.dtype == s.dtype == torch.float32 and tuple(s.shape) == (B, H, N, P)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_ssm_chunked_under_strong_decay_stays_finite():
    """Decays down to exp(-40) a step: the masked future exponents of the
    pairwise decay would overflow exp without the `where` before it."""
    x, dt, a, bm, cm, _ = _ssm_inputs(seed=1, decay=20.0)
    jy, js = jscan.ssm_chunked(*_j((x, dt, a, bm, cm)), chunk=32)
    y, s = linear_scan.ssm_chunked(*_t((x, dt, a, bm, cm)), chunk=32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_ssm_step_matches_reference():
    x, dt, a, bm, cm, s0 = _ssm_inputs(seed=2)
    jy, js = jscan.ssm_step(*_j((x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], s0)))
    y, s = linear_scan.ssm_step(*_t((x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], s0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssm_chunked_equals_stepping(chunk):
    x, dt, a, bm, cm, s0 = _t(_ssm_inputs(seed=3))
    s, ys = s0, []
    for t in range(T):
        y, s = linear_scan.ssm_step(x[:, t], dt[:, t], a, bm[:, t], cm[:, t], s)
        ys.append(y)
    yc, sc = linear_scan.ssm_chunked(x, dt, a, bm, cm, s0, chunk=chunk)
    np.testing.assert_allclose(yc.numpy(), torch.stack(ys, 1).numpy(), atol=1e-4)
    np.testing.assert_allclose(sc.numpy(), s.numpy(), atol=1e-4)


def test_ssm_chunked_refuses_a_ragged_sequence():
    x, dt, a, bm, cm, _ = _t(_ssm_inputs(t=40))
    with pytest.raises(ValueError, match="not divisible"):
        linear_scan.ssm_chunked(x, dt, a, bm, cm, chunk=32)


@pytest.fixture(scope="module")
def mix():
    """(JAX cfg, JAX params, port cfg, port params) of one smoke hymba mix,
    with the zero-initialised dt bias and log-decay and the unit skip and
    norm scales replaced by random values, so each of them is exercised."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = jhybrid.hymba_mix_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(11)
    for path in (("ssm", "dt_bias"), ("ssm", "a_log"), ("ssm", "skip_d"), ("norm_attn",), ("norm_ssm",)):
        node = jp
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = jnp.asarray(
            np.asarray(node[path[-1]]) + 0.3 * rng.standard_normal(node[path[-1]].shape).astype(np.float32))
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("t,window,pallas", [(64, 0, False), (64, 16, False), (128, 32, True)])
def test_hymba_mix_full_matches_reference(mix, t, window, pallas):
    """At T = 128 the JAX side runs the Pallas kernel (interpret mode) and the
    port its wrapper (the plain version on the CPU)."""
    jcfg, jp, tcfg, tp = mix
    x = (np.random.default_rng(t + window).standard_normal((B, t, jcfg.d_model)) * 0.5).astype(np.float32)
    jy, js, (jk, jv) = jhybrid.hymba_mix_full(jp, jcfg.replace(use_pallas=pallas), jnp.asarray(x),
                                              jnp.arange(t), window=window, return_kv=True)
    y, s, (k, v) = hybrid.hymba_mix_full(tp, tcfg, torch.from_numpy(x), torch.arange(t), window=window,
                                         return_kv=True)
    for got, want in ((y, jy), (s, js), (k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    y2, s2 = hybrid.hymba_mix_full(tp, tcfg, torch.from_numpy(x), torch.arange(t), window=window)
    assert torch.equal(y2, y) and torch.equal(s2, s)


@pytest.mark.parametrize("window", [0, 16])
def test_hymba_mix_decode_matches_reference(mix, window):
    """Four decode steps against a cache filled by a 32-token prefill; the
    port writes its kv cache in place and returns the new SSM state."""
    jcfg, jp, tcfg, tp = mix
    t, steps = 32, 4
    rng = np.random.default_rng(20 + window)
    x = (rng.standard_normal((B, t + steps, jcfg.d_model)) * 0.5).astype(np.float32)
    _, js, (jk, jv) = jhybrid.hymba_mix_full(jp, jcfg, jnp.asarray(x[:, :t]), jnp.arange(t), window=window,
                                             return_kv=True)
    length = window if window else t + steps
    if window:  # the ring of the last `window` keys, slot = pos % window
        perm = (t - window + np.arange(window)) % window
        jk = jnp.zeros((B, window) + jk.shape[2:]).at[:, perm].set(jk[:, t - window:])
        jv = jnp.zeros((B, window) + jv.shape[2:]).at[:, perm].set(jv[:, t - window:])
    else:
        pad = ((0, 0), (0, length - t), (0, 0), (0, 0))
        jk, jv = jnp.pad(jk, pad), jnp.pad(jv, pad)
    tk, tv, ts = torch.from_numpy(np.array(jk)), torch.from_numpy(np.array(jv)), torch.from_numpy(np.array(js))
    for i in range(steps):
        xi = x[:, t + i:t + i + 1]
        jy, jk, jv, js = jhybrid.hymba_mix_decode(jp, jcfg, jnp.asarray(xi), jk, jv, js,
                                                  jnp.asarray(t + i, jnp.int32), window=window)
        y, tk2, tv2, ts = hybrid.hymba_mix_decode(tp, tcfg, torch.from_numpy(xi), tk, tv, ts, t + i, window=window)
        assert tk2 is tk and tv2 is tv
        for got, want in ((y, jy), (tk, jk), (tv, jv), (ts, js)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssm_branch_decode_starts_from_zero_state(mix):
    jcfg, jp, tcfg, tp = mix
    x = (np.random.default_rng(5).standard_normal((B, 1, jcfg.d_model)) * 0.5).astype(np.float32)
    jy, js = jhybrid.ssm_branch(jp["ssm"], jcfg, jnp.asarray(x))
    y, s = hybrid.ssm_branch(tp["ssm"], tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_hymba_init_keeps_the_reference_tree():
    """Leaf names, shapes and dtypes of the port's init equal the reference's
    (bare (D,) branch-norm scales, an f32 step-size projection)."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = jhybrid.hymba_mix_init(jax.random.PRNGKey(0), jcfg)
    tp = hybrid.hymba_mix_init(torch.Generator().manual_seed(0), tcfg, "cpu", (3,))
    jflat = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}['{k}']")
            else:
                tflat[f"{prefix}['{k}']"] = v

    walk(tp, "")
    assert sorted(jflat) == sorted(tflat)
    for name, a in jflat.items():
        assert tuple(tflat[name].shape) == (3,) + a.shape, name
        assert str(tflat[name].dtype).removeprefix("torch.") == str(a.dtype), name
