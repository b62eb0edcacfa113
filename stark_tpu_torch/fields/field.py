"""Prime-field specifications and host-side (python-int) field codecs.

The port's own copy of `stark_tpu/fields/field.py` (the port imports nothing
of the JAX package); `tests/test_torch_imports.py` holds the two equal.

A re-design of the reference's field layer
(`packages/ff_utils/src/fp.rs:8-77`, `f7.rs:7-64`,
`ff_utils.rs:3-14`): instead of a 4xu64 Montgomery struct per element, a field
is described by a static :class:`FieldSpec` and bulk data lives in planar
uint32 limb arrays (16-bit limbs) processed by the vectorized kernels in
:mod:`stark_tpu_torch.ops.modmath`.

Host-side helpers here replicate the reference's byte codecs exactly, since
the Fiat-Shamir transcript depends on them:

* ``to_bytes_be``/``to_bytes_le``: fixed-width canonical big/little-endian
  bytes (width = the ff `Repr` size, 32 bytes for BN254 Fr, 8 for F7) --
  `fp.rs:35-44`, `f7.rs:34-43`.
* ``from_bytes_be``/``from_bytes_le``: arbitrary-length bytes -> integer ->
  reduced mod p (ff's `from_str_vartime` walks decimal digits *in the field*,
  so out-of-range values wrap around) -- `fp.rs:70-77`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field, hashable (a cache key)."""

    name: str
    p: int
    generator: int  # multiplicative generator of the full group
    repr_bytes: int  # byte width of the canonical fixed-width codec

    @property
    def bits(self) -> int:
        return self.p.bit_length()

    @property
    def num_limbs(self) -> int:
        """Number of 16-bit limbs (L). R = 2**(16*L) for Montgomery."""
        return -(-self.bits // LIMB_BITS)

    # --- Montgomery constants (R = 2**(16*L)) ---

    @property
    def r_bits(self) -> int:
        return LIMB_BITS * self.num_limbs

    @functools.cached_property
    def r_mod_p(self) -> int:
        return (1 << self.r_bits) % self.p

    @functools.cached_property
    def r2_mod_p(self) -> int:
        return pow(self.r_mod_p, 2, self.p)

    @functools.cached_property
    def n0(self) -> int:
        """-p^{-1} mod 2^16 (per-limb Montgomery factor)."""
        return (-pow(self.p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @functools.cached_property
    def p_limbs(self) -> tuple[int, ...]:
        return int_to_limbs(self.p, self.num_limbs)

    @functools.cached_property
    def two_adicity(self) -> int:
        """2-adicity of p-1; equals the reference's `calc_max_log_precision`
        (`r1cs-stark/src/utils.rs:138-162`, byte-wise trailing-zero count)."""
        n = self.p - 1
        s = 0
        while n % 2 == 0:
            n //= 2
            s += 1
        return s

    # --- host codecs (byte-exact with the reference) ---

    def to_bytes_be(self, x: int) -> bytes:
        return int(x % self.p).to_bytes(self.repr_bytes, "big")

    def to_bytes_le(self, x: int) -> bytes:
        return int(x % self.p).to_bytes(self.repr_bytes, "little")

    def from_bytes_be(self, b: bytes) -> int:
        return int.from_bytes(b, "big") % self.p

    def from_bytes_le(self, b: bytes) -> int:
        return int.from_bytes(b, "little") % self.p

    def encode_hex(self, x: int) -> str:
        """0x-less fixed-width lowercase hex (`fp.rs:14-19`)."""
        return self.to_bytes_be(x).hex()

    # --- small host field ops ---

    def inv(self, x: int) -> int:
        return pow(x % self.p, self.p - 2, self.p)

    def pow(self, x: int, e: int) -> int:
        return pow(x % self.p, e, self.p)

    def root_of_unity(self, order: int) -> int:
        """order-th root of unity: generator ** ((p-1)/order).

        Mirrors the prover's g2 derivation (`prove.rs:71-82`)."""
        assert (self.p - 1) % order == 0
        return pow(self.generator, (self.p - 1) // order, self.p)


def int_to_limbs(x: int, num_limbs: int) -> tuple[int, ...]:
    return tuple((x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(num_limbs))


def limbs_to_int(limbs) -> int:
    out = 0
    for i, v in enumerate(limbs):
        out |= int(v) << (LIMB_BITS * i)
    return out


# The production field: BN254/circom scalar field Fr (`fp.rs:8-12`).
BN254_FR = FieldSpec(
    name="bn254_fr",
    p=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=7,
    repr_bytes=32,
)

# Toy mod-7 field used by the reference's FFT/poly unit tests (`f7.rs:7-11`).
F7 = FieldSpec(name="f7", p=7, generator=3, repr_bytes=8)

# BLS12-381 scalar field, used by the Poseidon digest (`poseidon.rs:2,40-47`).
BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    p=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
    repr_bytes=32,
)
