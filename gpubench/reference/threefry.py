"""Threefry-2x32 in plain torch, a frozen copy for the references.

JAX's partitionable counter scheme (the default since JAX 0.5): element i
of a draw of shape S hashes the 64-bit counter i; ``split`` hashes counter
j for key j; random bits are the XOR of the two output words.  A key is an
int64 tensor (..., 2) holding two uint32 words.  This copy is the
benchmark's own: the program under test has its own implementation, and
the two are compared bit for bit through what the program produces.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _hash(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, of counters (x0, x1) under key (k0, k1)."""
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


def _counters(key: torch.Tensor, n: int):
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    k0 = key[..., 0, None]
    k1 = key[..., 1, None]
    return _hash(k0, k1, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., num, 2) new keys."""
    b0, b1 = _counters(key, num)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) uint32 values in int64."""
    b0, b1 = _counters(key, n)
    return b0 ^ b1


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) float32 in [0, 1): the top 23 bits as a mantissa."""
    return (random_bits(key, n) >> 9).to(torch.float32) * 2.0**-23


def exponential_times(key: torch.Tensor, n: int, rate: float = 1.0) -> torch.Tensor:
    """(..., n) Exponential(rate) response times from one key: the first
    half of a split gives u, the time is log1p(-u) * (-1/rate)."""
    u = uniform(split(key)[..., 0, :], n)
    return torch.log1p(-u) * float(torch.tensor(-1.0 / rate, dtype=torch.float32))


def fastest_k(times: torch.Tensor, k: torch.Tensor):
    """(mask of the k smallest times, ties to the lower index; the k-th
    smallest time) along the last axis; k broadcasts over the leading axes."""
    n = times.shape[-1]
    order = torch.sort(times, dim=-1, stable=True).indices
    ranks = torch.sort(order, dim=-1, stable=True).indices
    k = k.to(torch.int64)[..., None]
    mask = (ranks < k).to(times.dtype)
    kth = torch.gather(torch.sort(times, dim=-1, stable=True).values, -1, (k - 1).clamp(0, n - 1))[..., 0]
    return mask, kth
