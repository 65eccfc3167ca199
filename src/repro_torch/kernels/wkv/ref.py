"""Plain PyTorch versions of the wkv6 kernels' function.

`wkv6_ref` is the chunked linear scan in `repro_torch.models.linear_scan`, as
`repro/kernels/wkv/ref.py` re-exports the JAX package's: the plain version
that the wrapper runs on CPU tensors and that the kernels are held to.

`wkv6_split_tf32` repeats the arithmetic of the tensor-core kernel
(`csrc/wkv6_sm90.cu`) in plain PyTorch, so that the CPU tests can hold that
algorithm to the JAX kernel before it runs on a card: sub-chunks of 32 (16
where 32 does not divide the chunk), the decays as products of w instead of
exponentials of log sums, the straddle-boundary levels with unmasked factor
vectors and the pair mask on the product, and every product as
lo*hi + hi*lo + hi*hi of TF32 halves (cut, not rounded) with f32
sums.  It is not used outside
the tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.linear_scan import wkv6_chunked as wkv6_ref  # noqa: F401
from repro_torch.models.linear_scan import wkv6_step  # noqa: F401


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x cut to TF32: its top 11 significant bits, the low 13 bits of the
    f32 pattern zeroed."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from TF32 halves, as the kernel's split: hi = tf32(x), lo =
    tf32(x - hi); lo*hi + hi*lo + hi*hi, each product exact in f32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def wkv6_split_tf32(
    r: torch.Tensor,  # (B, T, H, K)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, T, H, V)
    w: torch.Tensor,  # (B, T, H, K) f32
    u: torch.Tensor,  # (H, K) f32
    s0: Optional[torch.Tensor] = None,  # (B, H, K, V) f32
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core kernel's arithmetic.  Returns (y (B,T,H,V) f32, s_T (B,H,K,V) f32)."""
    b, t, h, kdim = r.shape
    vdim = v.shape[-1]
    sub = 32 if chunk % 32 == 0 else 16
    f32 = torch.float32
    # (B, H, T, K): one scan per (b, h), as one block runs it
    r, k, v, w = (x.to(f32).transpose(1, 2) for x in (r, k, v, w))
    s = torch.zeros((b, h, kdim, vdim), dtype=f32) if s0 is None else s0.to(f32).clone()
    pos = torch.arange(sub)
    diag = torch.eye(sub, dtype=torch.bool)
    ys = []
    for c0 in range(0, t, sub):
        rc, kc, vc = r[:, :, c0:c0 + sub], k[:, :, c0:c0 + sub], v[:, :, c0:c0 + sub]
        d = torch.clamp(w[:, :, c0:c0 + sub], min=1e-20)  # P over each position's own h-block
        e = torch.ones_like(d)  # P[start of its h-block, p)
        f = torch.ones_like(d)  # P(p, end of its h-block]
        scores = torch.zeros((b, h, sub, sub), dtype=f32)
        lev = 1
        while lev < sub:
            q = ((pos // lev) % 2 == 1)[:, None]
            fac = torch.where(q, rc * e, kc * f)
            pair = ((pos[:, None] // (2 * lev) == pos[None, :] // (2 * lev)) & q
                    & ((pos[None, :] // lev) % 2 == 0))
            scores = torch.where(pair, _mm3(fac, fac.transpose(-1, -2)), scores)
            sib = d.unflatten(-2, (sub // (2 * lev), 2, lev)).flip(-3).flatten(-4, -2)  # the sibling block's
            e = torch.where(q, e * sib, e)
            f = torch.where(q, f, f * sib)
            d = d * sib
            lev *= 2
        bonus = torch.einsum("bhtk,hk,bhtk->bht", rc, u.to(f32), kc)
        scores = torch.where(diag, torch.diag_embed(bonus), scores)
        y = _mm3(rc * e, s) + _mm3(scores, vc)
        s = d[:, :, :1].transpose(-1, -2) * s + _mm3((kc * f).transpose(-1, -2), vc)
        ys.append(y)
    return torch.cat(ys, dim=2).transpose(1, 2).contiguous(), s
