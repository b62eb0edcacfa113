"""The Fiat-Shamir transcript and the small polynomials, on host integers
(`commitment/src/utils.rs:82-109`, `r1cs-stark/src/utils.rs:51-57, 272-290`,
`fri/src/poly_utils.rs`)."""

from __future__ import annotations

import hashlib


def blake(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


def mk_seed(parts: list[bytes]) -> int:
    """blake of the concatenation, read big-endian."""
    return int.from_bytes(blake(b"".join(parts)), "big")


def pseudorandom_indices(seed: bytes, modulus: int, count: int, exclude_multiples_of: int = 0):
    assert modulus < 2**24
    data = bytearray(seed)
    while len(data) < 4 * count:
        data.extend(blake(bytes(data[-32:])))
    vals = [int.from_bytes(data[i : i + 4], "big") for i in range(0, 4 * count, 4)]
    if exclude_multiples_of == 0:
        return [v % modulus for v in vals]
    real = modulus * (exclude_multiples_of - 1) // exclude_multiples_of
    return [v % real + 1 + (v % real) // (exclude_multiples_of - 1) for v in vals]


def random_field_values(seed: bytes, modulus: int, size: int, p: int) -> list[int]:
    """Eight sampled u32 a value, packed big-endian, read little-endian mod p."""
    rand = pseudorandom_indices(seed, modulus, 8 * size)
    return [int.from_bytes(b"".join(v.to_bytes(4, "big") for v in rand[8 * c : 8 * c + 8]),
                           "little") % p for c in range(size)]


def eval_poly(poly: list[int], x: int, p: int) -> int:
    return sum(c * pow(x, i, p) for i, c in enumerate(poly)) % p


def lagrange_interp(xs: list[int], ys: list[int], p: int) -> list[int]:
    """Coefficients, low first, of the polynomial through (xs, ys): Z(x) =
    prod (x - x_j) once, then Z / (x - x_i) by synthetic division a point."""
    z = [1]
    for xj in xs:
        z = [((z[k - 1] if k else 0) - xj * (z[k] if k < len(z) else 0)) % p
             for k in range(len(z) + 1)]
    out = [0] * len(xs)
    for xi, yi in zip(xs, ys):
        num = [0] * len(xs)  # z / (x - xi), low coefficients first
        acc = 0
        for k in range(len(xs), 0, -1):
            acc = (z[k] + acc * xi) % p
            num[k - 1] = acc
        scale = yi * pow(eval_poly(num, xi, p), p - 2, p) % p
        out = [(o + c * scale) % p for o, c in zip(out, num)]
    return out
