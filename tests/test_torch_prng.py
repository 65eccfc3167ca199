"""The port's threefry (repro_torch.core.prng) against jax.random, in both of
JAX's threefry modes: keys, splits, fold_in, bits, uniforms, integers,
Bernoulli and Rademacher draws bit for bit; normal draws within 64 ulp
(torch's erfinv and XLA's differ by up to ~63 ulp)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402

MODES = {"partitionable": True, "legacy": False}
SHAPES = [(), (1,), (5,), (7,), (4, 3), (2, 3, 5)]


@pytest.fixture(params=list(MODES))
def mode(request):
    """Both packages in one threefry mode for the test, restored after."""
    flag = MODES[request.param]
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", flag)
    try:
        with prng.threefry_mode(flag):
            yield flag
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def _t(key):
    return prng.as_key(np.asarray(key))


def _same(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a.astype(b.dtype) if a.dtype.kind in "ui" else a, b)


@pytest.mark.parametrize("seed", [0, 1, 1234, 2**31 - 1, 2**31, 2**32 + 5, -1])
def test_prng_key(seed):
    _same(jax.random.PRNGKey(seed), prng.PRNGKey(seed))


@pytest.mark.parametrize("num", [2, 3, 5, (2, 3)])
def test_split(mode, num):
    k = jax.random.PRNGKey(42)
    _same(jax.random.split(k, num), prng.split(prng.PRNGKey(42), num))


def test_split_nested_and_batched(mode):
    k = jax.random.PRNGKey(7)
    ks = jax.random.split(k, 4)
    # a batch of keys, each split in two, then one of them split in three
    _same(jax.vmap(jax.random.split)(ks), prng.split(_t(ks)))
    inner = jax.random.split(jax.random.split(ks[2])[1], 3)
    _same(inner, prng.split(prng.split(_t(ks)[2])[1], 3))


@pytest.mark.parametrize("data", [0, 1, 17, 2**32 - 1])
def test_fold_in(mode, data):
    k = jax.random.PRNGKey(3)
    _same(jax.random.fold_in(k, data), prng.fold_in(prng.PRNGKey(3), data))


def test_fold_in_rejects_non_uint32():
    with pytest.raises(OverflowError):
        prng.fold_in(prng.PRNGKey(3), -5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits(mode, shape):
    _same(jax.random.bits(jax.random.PRNGKey(11), shape), prng.random_bits(prng.PRNGKey(11), shape))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform(mode, shape):
    _same(jax.random.uniform(jax.random.PRNGKey(5), shape), prng.uniform(prng.PRNGKey(5), shape))


def test_uniform_range_and_batched_keys(mode):
    ks = jax.random.split(jax.random.PRNGKey(9), 3)
    _same(jax.vmap(lambda k: jax.random.uniform(k, (6,), minval=-2.0, maxval=3.0))(ks),
          prng.uniform(_t(ks), (6,), -2.0, 3.0))


@pytest.mark.parametrize("bounds", [(1, 11), (1, 101), (0, 2), (-5, 5), (0, 2**16), (-(2**31), 2**31 - 1), (3, 3)])
def test_randint(mode, bounds):
    lo, hi = bounds
    _same(jax.random.randint(jax.random.PRNGKey(2), (4, 5), lo, hi), prng.randint(prng.PRNGKey(2), (4, 5), lo, hi))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_bernoulli(mode, p):
    _same(jax.random.bernoulli(jax.random.PRNGKey(4), p, (3, 7)), prng.bernoulli(prng.PRNGKey(4), p, (3, 7)))


@pytest.mark.parametrize("shape", [(8,), (3, 5), (100,)], ids=str)
def test_rademacher(mode, shape):
    _same(jax.random.rademacher(jax.random.PRNGKey(1234), shape, dtype=jnp.float32),
          prng.rademacher(prng.PRNGKey(1234), shape))


@pytest.mark.parametrize("shape", [(1000,), (20, 30)], ids=str)
def test_normal_within_64_ulp(mode, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(8), shape))
    got = prng.normal(prng.PRNGKey(8), shape).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1e-30)).astype(np.float32))
    assert np.all(np.abs(got - want) <= 64 * ulp), float(np.max(np.abs(got - want) / ulp))


def test_mode_switch_restores():
    assert prng.is_partitionable()
    k = prng.PRNGKey(0)
    with prng.threefry_mode(False):
        assert not prng.is_partitionable()
        legacy = prng.split(k)
    assert prng.is_partitionable()
    assert not torch.equal(legacy, prng.split(k))
    with pytest.raises(RuntimeError):
        with prng.threefry_mode(False):
            raise RuntimeError("the mode is restored on the way out")
    assert prng.is_partitionable()


def test_draws_under_vmap_match_batched_keys():
    ks = prng.split(prng.PRNGKey(21), 5)
    mapped = torch.func.vmap(lambda k: prng.uniform(prng.split(k)[1], (4,)))(ks)
    assert torch.equal(mapped, prng.uniform(prng.split(ks)[:, 1], (4,)))
