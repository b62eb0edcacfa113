"""Radix-2 transforms and the low-degree extension, in plain PyTorch.

`ntt` is the textbook decimation in time on bit-reversed input, so it gives
v[k] = sum_j c_j root^(j k), as the reference's `best_fft` does
(`fri/src/fft.rs:150-193, 327-357`). `lde` interpolates n values on the
subgroup of g1 = g2^b and evaluates the polynomial on the b n points of g2's
subgroup, one radix-2 transform for each of the b cosets g2^r <g1>.
"""

from __future__ import annotations

import torch

from benchmark.ref.field import L, Field


def bitrev(logn: int, device) -> torch.Tensor:
    n = 1 << logn
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def ntt(F: Field, x: torch.Tensor, root: int) -> torch.Tensor:
    """(10, B, n) Montgomery values -> their transforms at `root`, a
    primitive n-th root of unity."""
    n = x.shape[-1]
    logn = n.bit_length() - 1
    B = x.shape[1]
    x = x[:, :, bitrev(logn, x.device)]
    if n == 1:
        return x
    tw = F.powers(root, n // 2)
    for s in range(logn):
        m = 1 << s
        w = tw[:, :: n // (2 * m)][:, :m].reshape(L, 1, 1, m)
        x = x.reshape(L, B, n // (2 * m), 2, m)
        u, v = x[:, :, :, 0], x[:, :, :, 1]
        t = F.mul(v, w)
        x = F.reduce(torch.stack([F.add(u, t), F.sub(u, t)], dim=3))
    return x.reshape(L, B, n)


def intt(F: Field, x: torch.Tensor, root: int) -> torch.Tensor:
    """The inverse of `ntt` at `root` (`fft.rs:284-309, 360-379`)."""
    n = x.shape[-1]
    y = ntt(F, x, pow(root, F.p - 2, F.p))
    return F.mul(y, F.const(pow(n, F.p - 2, F.p)).view(L, 1, 1))


def lde(F: Field, vals: torch.Tensor, g1: int, g2: int, xs: torch.Tensor) -> torch.Tensor:
    """(10, n) values on <g1> -> (10, b n) evaluations on <g2>, where
    g1 = g2^b and `xs` holds the powers g2^0 .. g2^(b n - 1)."""
    n = vals.shape[-1]
    N = xs.shape[-1]
    b = N // n
    coeffs = intt(F, vals.reshape(L, 1, n), g1)  # (10, 1, n)
    j = torch.arange(n, device=vals.device)
    r = torch.arange(b, device=vals.device)
    shifts = xs[:, (r[:, None] * j[None, :]) % N]  # g2^(r j): (10, b, n)
    out = ntt(F, F.mul(coeffs, shifts), g1)  # (10, b, n): out[r, q] = f(g2^(b q + r))
    return out.transpose(1, 2).reshape(L, N).contiguous()
