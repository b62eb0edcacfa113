"""Device-side Fiat-Shamir transcript, byte-exact with the host transcript.

Counterpart of `stark_tpu/protocol/device_transcript.py:43-147`: every
challenge (r, the k coefficients, spot-check positions, FRI special_x and
query indices) is derived on the device from the (8,) digest words of the
committed roots, so the prover needs no host sync until the end. Byte
orders follow `stark_tpu/protocol/transcript.py`: the sampler reads the
blake chain as big-endian u32s (device digest words are little-endian, so
each sampled word is byte-swapped); `mk_seed` reads a digest big-endian mod
p; `get_random_ff_values` packs 8 big-endian u32s and reads them
little-endian mod p; FRI's special_x reads a root little-endian mod p.

Words are int32 bit patterns; unsigned arithmetic on them widens to int64.
A value X < 2^256 enters Montgomery form as mmul(X, R^2 mod p), valid since
X * R^2 < R * p.
"""

from __future__ import annotations

import torch

from stark_tpu_torch.fields.field import FieldSpec, int_to_limbs
from stark_tpu_torch.ops import blake2s as b2
from stark_tpu_torch.ops import modmath as mm

_M32 = 0xFFFFFFFF


def _u32(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & _M32


def bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte swap of int64 values < 2^32."""
    return (
        ((x & 0xFF) << 24) | ((x & 0xFF00) << 8) | ((x >> 8) & 0xFF00) | (x >> 24)
    )


def _pad32(words8: torch.Tensor) -> torch.Tensor:
    """(8,) digest words -> (16, 1) padded block of a 32-byte message."""
    return torch.cat([words8, torch.zeros_like(words8)]).reshape(16, 1)


def chain_words(seed_words8: torch.Tensor, count: int) -> torch.Tensor:
    """The sampler's blake chain: seed, then blake(last 32 bytes) until
    `count` words exist. Returns int32 words in byte order."""
    out = [seed_words8]
    state = seed_words8
    have = 8
    while have < count:
        state = b2.blake2s_words(_pad32(state), 32)[:, 0]
        out.append(state)
        have += 8
    return torch.cat(out)[:count]


def pseudorandom_indices(seed_words8, modulus: int, count: int,
                         exclude_multiples_of: int = 0) -> torch.Tensor:
    """`get_pseudorandom_indices`: (count,) int64 indices."""
    if modulus >= 2**24:
        raise ValueError("modulus must be < 2^24")
    vals = bswap32(_u32(chain_words(seed_words8, count)))
    if exclude_multiples_of == 0:
        return vals % modulus
    real_modulus = modulus * (exclude_multiples_of - 1) // exclude_multiples_of
    v = vals % real_modulus
    return v + 1 + v // (exclude_multiples_of - 1)


def _le_bytes_to_mont(spec: FieldSpec, le_bytes32: torch.Tensor) -> torch.Tensor:
    """(32,) int64 byte values, little-endian -> (L, 1) Montgomery of the
    value mod p."""
    L = spec.num_limbs
    limbs = (le_bytes32[0::2] + (le_bytes32[1::2] << 8))[:L].to(torch.int32)
    r2 = torch.tensor(int_to_limbs(spec.r2_mod_p, L), dtype=torch.int32,
                      device=limbs.device)
    return mm.mmul(spec, limbs.reshape(L, 1), r2.reshape(L, 1))


def _words_to_le_bytes(words: torch.Tensor, order: str) -> torch.Tensor:
    """(W,) words -> (4W,) byte values; 'le': word k holds bytes 4k..4k+3
    little-endian (device digests); 'be': big-endian within each word."""
    w = _u32(words)
    sh = (0, 8, 16, 24) if order == "le" else (24, 16, 8, 0)
    return torch.stack([(w >> s) & 0xFF for s in sh], dim=1).reshape(-1)


def digest_le_int_mont(spec: FieldSpec, digest_words8) -> torch.Tensor:
    """FRI special_x: digest bytes read little-endian, mod p, Montgomery."""
    return _le_bytes_to_mont(spec, _words_to_le_bytes(digest_words8, "le"))


def digest_be_int_mont(spec: FieldSpec, digest_words8) -> torch.Tensor:
    """mk_seed -> from_str: digest bytes read big-endian, mod p, Montgomery."""
    return _le_bytes_to_mont(spec, _words_to_le_bytes(digest_words8, "le").flip(0))


def random_ff_mont(spec: FieldSpec, seed_words8, modulus: int, size: int,
                   exclude_multiples_of: int = 0) -> torch.Tensor:
    """`get_random_ff_values`: (L, size) Montgomery values."""
    idx = pseudorandom_indices(seed_words8, modulus, size * 8, exclude_multiples_of)
    cols = [
        _le_bytes_to_mont(spec, _words_to_le_bytes(idx[8 * c : 8 * c + 8], "be"))
        for c in range(size)
    ]
    return torch.cat(cols, dim=1)


def k_coeffs_mont(spec: FieldSpec, m_root_words8) -> torch.Tensor:
    """k0..k10: k0 = 1, k_i = from_str(mk_seed(m_root || [i])) for the
    one-byte i = 1..10, as (L, 11) Montgomery columns."""
    dev = m_root_words8.device
    msgs = [
        torch.cat([
            m_root_words8,
            torch.tensor([i], dtype=torch.int32, device=dev),
            torch.zeros(7, dtype=torch.int32, device=dev),
        ])
        for i in range(1, 11)
    ]
    digests = b2.blake2s_words(torch.stack(msgs, dim=1).contiguous(), 33)  # (8, 10)
    cols = [mm.mont_consts(spec, [1], dev)] + [
        digest_be_int_mont(spec, digests[:, i]) for i in range(10)
    ]
    return torch.cat(cols, dim=1)
