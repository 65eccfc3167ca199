"""Threefry-2x32: the `jax.random` calls the engine makes, bit for bit, in torch.

A key is an int64 tensor of shape (..., 2) whose two entries hold uint32
values (torch has `torch.uint32` but no add or shift for it, so the hash is
carried in int64 and masked to 32 bits after each add and shift).  Every
function takes a batch of keys in the leading dimensions and returns one
result per key, and also runs under `torch.func.vmap` on a single (2,) key.

JAX has two ways to turn a key into counters, chosen by its flag
`jax_threefry_partitionable`; both are here:

* partitionable (the default, as in JAX >= 0.5): element i of a draw of
  shape S hashes the 64-bit counter i, as (hi, lo) words
  (`jax._src.prng.iota_2x32_shape`); `split` hashes counter j for key j, and
  random bits are the XOR of the two output words;
* legacy: the counters 0..N-1 are hashed in two
  halves, (x[i], x[i + N/2]), and the outputs concatenated
  (`_threefry_split_original`, `_threefry_random_bits_original`).

The module's mode selects between them: `set_partitionable`, or the
`threefry_mode` context manager, as `jax.config.update(
"jax_threefry_partitionable", ...)` does for JAX.

Integer and uniform draws are exact.  `normal` goes through `erfinv`, whose
torch and XLA versions differ by a few tens of ulp.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence

import numpy as np
import torch

__all__ = [
    "PRNGKey",
    "as_key",
    "split",
    "fold_in",
    "random_bits",
    "uniform",
    "normal",
    "randint",
    "bernoulli",
    "rademacher",
    "set_partitionable",
    "is_partitionable",
    "threefry_mode",
]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

_partitionable = True


def set_partitionable(flag: bool) -> None:
    """Set the module's mode (JAX's `jax_threefry_partitionable`)."""
    global _partitionable
    _partitionable = bool(flag)


def is_partitionable() -> bool:
    return _partitionable


@contextlib.contextmanager
def threefry_mode(partitionable: bool) -> Iterator[None]:
    """Run a block in one mode and restore the previous one."""
    before = _partitionable
    set_partitionable(partitionable)
    try:
        yield
    finally:
        set_partitionable(before)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` with 32-bit JAX: (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def as_key(keys, device=None) -> torch.Tensor:
    """Keys from JAX (numpy uint32 (..., 2)) or from this module, as int64."""
    if isinstance(keys, torch.Tensor):
        out = keys.to(torch.int64)
    else:
        out = torch.from_numpy(np.asarray(keys).astype(np.int64))
    if out.shape[-1:] != (2,):
        raise ValueError(f"keys must have a trailing dimension of 2, got shape {tuple(out.shape)}")
    return out if device is None else out.to(device)


def _hash(k0, k1, x0, x1):
    """The Threefry-2x32 hash of counters (x0, x1) under key (k0, k1), 20
    rounds (`jax._src.prng._threefry2x32_lowering`); broadcasting."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def _key_words(key: torch.Tensor, ndim: int):
    """The key's two words, with `ndim` trailing axes to broadcast over."""
    tail = (1,) * ndim
    return key[..., 0].reshape(key.shape[:-1] + tail), key[..., 1].reshape(key.shape[:-1] + tail)


def _counter_hash(key: torch.Tensor, shape: tuple):
    """Partitionable mode: both output words for the 64-bit counters
    0..prod(shape)-1 laid out in `shape` (hi word 0 below 2^32)."""
    size = math.prod(shape)
    if size >= 2**32:
        raise NotImplementedError("draws of 2^32 values or more")
    lo = torch.arange(size, dtype=torch.int64, device=key.device).reshape(shape)
    k0, k1 = _key_words(key, len(shape))
    return _hash(k0, k1, torch.zeros_like(lo), lo)


def _legacy_hash(key: torch.Tensor, size: int) -> torch.Tensor:
    """Legacy mode: `threefry_2x32(key, iota(size))`: the counters hashed in
    two halves (padded with a 0 when odd), outputs concatenated, (..., size)."""
    if size >= 2**32:
        raise NotImplementedError("draws of 2^32 values or more")
    half = (size + 1) // 2
    idx = torch.arange(half, dtype=torch.int64, device=key.device)
    x1 = torch.where(idx + half < size, idx + half, 0)
    k0, k1 = _key_words(key, 1)
    y0, y1 = _hash(k0, k1, idx, x1)
    return torch.cat([y0, y1], dim=-1)[..., :size]


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """`jax.random.split`: (..., *num, 2) new keys (num an int or a shape)."""
    shape = _shape(num)
    if _partitionable:
        b0, b1 = _counter_hash(key, shape)
        return torch.stack([b0, b1], dim=-1)
    flat = _legacy_hash(key, 2 * math.prod(shape))
    return flat.reshape(key.shape[:-1] + shape + (2,))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in` (the same in both modes): the hash of (0, data)."""
    data = int(data)
    if not 0 <= data <= MASK:
        raise OverflowError(f"fold_in data {data} is not a uint32")
    k0, k1 = key[..., 0], key[..., 1]
    y0, y1 = _hash(k0, k1, torch.zeros_like(k0), torch.full_like(k0, data))
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)`: (..., *shape) int64 in [0, 2^32)."""
    shape = _shape(shape)
    if _partitionable:
        b0, b1 = _counter_hash(key, shape)
        return b0 ^ b1
    return _legacy_hash(key, math.prod(shape)).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform` in float32: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape)
    # (1 + m 2^-23) - 1 == m 2^-23 exactly, so this is JAX's bitcast, bit for bit
    floats = (bits >> 9).to(torch.float32) * 2.0**-23
    lo, hi = np.float32(minval), np.float32(maxval)
    if lo == 0.0 and hi == 1.0:
        return floats  # JAX's `floats * 1 + 0`, max(0, .), change no bit
    # XLA fuses `floats * (hi - lo) + lo` into one FMA: the product is exact
    # in float64, so one rounding of the float64 sum gives the FMA's float32
    # on every device (but for double rounding of sums that need > 53 bits)
    scaled = (floats.to(torch.float64) * float(hi - lo) + float(lo)).to(torch.float32)
    return torch.clamp_min(scaled, float(lo))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.normal` in float32: sqrt(2) erfinv(u), u uniform in
    (-1, 1).  torch's erfinv differs from XLA's by up to a few tens of ulp."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return float(np.float32(np.sqrt(2))) * torch.erfinv(u)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """`jax.random.randint` with int32 output: two 32-bit draws reduced
    modulo the span (JAX's `_randint`), as int32 in [minval, maxval)."""
    lo, hi = int(minval), int(maxval)
    if not (-(2**31) <= lo < 2**31 and -(2**31) <= hi < 2**31):
        raise OverflowError(f"randint bounds [{lo}, {hi}) outside int32")
    span = 1 if hi <= lo else (hi - lo) & MASK
    k = split(key)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    mult = (2**16) % span
    mult = (mult * mult & MASK) % span
    offset = (((higher % span) * mult & MASK) + (lower % span) & MASK) % span
    return (lo + offset).to(torch.int32)


def bernoulli(key: torch.Tensor, p: float = 0.5, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.bernoulli` with a scalar float32 p: uniform < p."""
    return uniform(key, shape) < float(np.float32(p))


def rademacher(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """`jax.random.rademacher`: 2 * bernoulli(0.5) - 1, in `dtype`."""
    b = bernoulli(key, 0.5, shape).to(dtype)
    return (2 * b - 1).to(dtype)
