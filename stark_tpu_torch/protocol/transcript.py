"""Host-side Fiat-Shamir transcript helpers (byte-exact with the reference).

Every challenge in the protocol is derived from Blake2s digests through the
exact byte/string paths of the reference; any deviation changes all
challenges, so these run on host with python ints:

* `blake`: Blake2s-256 (`commitment/src/utils.rs:5-10`).
* `get_pseudorandom_indices`: blake-chain expansion of a seed, big-endian
  u32s reduced mod `modulus`, with the `exclude_multiples_of` remapping
  (`commitment/src/utils.rs:82-109`).
* `mk_seed`: blake of concatenated messages, rendered as a DECIMAL string of
  the big-endian integer (`r1cs-stark/src/utils.rs:51-57`) -- the reference
  feeds this to `Fp::from_str`, i.e. reduces the integer mod p.
* `get_random_ff_values`: 8 sampled u32s packed big-endian then read
  little-endian mod p (`r1cs-stark/src/utils.rs:272-290`).
"""

from __future__ import annotations

import hashlib

from stark_tpu_torch.fields.field import FieldSpec


def blake(message: bytes) -> bytes:
    return hashlib.blake2s(message).digest()


def get_pseudorandom_indices(
    seed: bytes, modulus: int, count: int, exclude_multiples_of: int = 0
) -> list[int]:
    assert modulus < 2**24
    data = bytearray(seed)
    while len(data) < 4 * count:
        data.extend(blake(bytes(data[-32:])))
    if exclude_multiples_of == 0:
        return [
            int.from_bytes(data[i : i + 4], "big") % modulus
            for i in range(0, count * 4, 4)
        ]
    real_modulus = modulus * (exclude_multiples_of - 1) // exclude_multiples_of
    out = []
    for i in range(0, count * 4, 4):
        v = int.from_bytes(data[i : i + 4], "big") % real_modulus
        out.append(v + 1 + v // (exclude_multiples_of - 1))
    return out


def mk_seed(messages: list[bytes]) -> str:
    joined = b"".join(messages)
    return str(int.from_bytes(blake(joined), "big"))


def seed_to_field(spec: FieldSpec, messages: list[bytes]) -> int:
    """T::from_str(&mk_seed(...)): decimal parse reduces mod p."""
    return int(mk_seed(messages)) % spec.p


def u32s_to_be_bytes(values: list[int]) -> bytes:
    # r1cs-stark/src/utils.rs:29-38
    return b"".join(int(v).to_bytes(4, "big") for v in values)


def get_random_ff_values(
    spec: FieldSpec, seed: bytes, modulus: int, size: int, exclude_multiples_of: int = 0
) -> list[int]:
    randomness = get_pseudorandom_indices(seed, modulus, size * 8, exclude_multiples_of)
    out = []
    for i in range(0, size * 8, 8):
        packed = u32s_to_be_bytes(randomness[i : i + 8])
        out.append(spec.from_bytes_le(packed))
    return out
