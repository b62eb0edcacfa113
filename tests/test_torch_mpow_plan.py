"""How `field_cuda.mpow_scalar` plans its launch, on the CPU: pure planning,
no product computed.

The kernel squares on one warp and multiplies on `MPOW_STREAMS` others.
The host recodes the exponent into fixed windows (`mpow_digits`) and deals
the digits to the multiply warps (`mpow_streams`): the streams must be
disjoint and sum to e, every digit must fit its window, and the top digits
(e's top bit among them) stay with warp 0, which folds the others' products
in; its starting value (`mpow_start`) cancels the factor the radix-2^29
squarings (R' = 2^261) leave on each power. Tensors on the `meta` device
take the wrapper's card route past the field checks to "no kernel for
device meta". Exact checks.
"""

import random

import pytest
import torch

from stark_tpu_torch.fields.field import BLS12_381_FR, BN254_FR
from stark_tpu_torch.ops import field_cuda as fc

NAMED = {f"{name} {label}": e
         for name, p in (("bn254", BN254_FR.p), ("bls12_381", BLS12_381_FR.p))
         for label, e in (("0", 0), ("1", 1), ("2", 2), ("3", 3), ("p-2", p - 2),
                          ("p-1", p - 1))}
NAMED.update({"2^255": 1 << 255, "2^256-1": (1 << 256) - 1})
SEEDED = [random.Random(20261017).getrandbits(random.Random(i).randint(1, 256))
          for i in range(200)]


def check_plan(e: int, window: int, streams: int, tail: int) -> None:
    digits = fc.mpow_digits(e, window)
    assert sum(d << pos for pos, d in digits) == e
    positions = [pos for pos, _ in digits]
    assert positions == sorted(set(positions))
    for pos, d in digits:
        assert pos % window == 0 and 0 < d < 1 << window
    parts = fc.mpow_streams(e, streams, window, tail)
    assert len(parts) == streams and sum(parts) == e
    for i, x in enumerate(parts):
        assert x >= 0
        for y in parts[i + 1:]:
            assert x & y == 0
    # whole digits only, and the top `tail` in stream 0
    for j, (pos, d) in enumerate(digits):
        owners = [m for m, x in enumerate(parts) if (x >> pos) & ((1 << window) - 1)]
        assert owners == ([0] if j >= len(digits) - tail else [j % streams])
        assert (parts[owners[0]] >> pos) & ((1 << window) - 1) == d
    if e:
        assert parts[0].bit_length() == e.bit_length()


@pytest.mark.parametrize("e", list(NAMED.values()), ids=list(NAMED))
def test_named_exponents(e):
    check_plan(e, fc.MPOW_WINDOW, fc.MPOW_STREAMS, fc.MPOW_TAIL)


def test_seeded_exponents():
    for e in SEEDED:
        check_plan(e, fc.MPOW_WINDOW, fc.MPOW_STREAMS, fc.MPOW_TAIL)


@pytest.mark.parametrize("window,streams,tail", [(1, 1, 1), (1, 3, 2), (3, 2, 1), (5, 3, 3)])
def test_other_plans(window, streams, tail):
    for e in SEEDED[:50] + list(NAMED.values()):
        check_plan(e, window, streams, tail)


@pytest.mark.parametrize("spec", [BN254_FR, BLS12_381_FR], ids=["bn254", "bls12_381"])
def test_chain_headroom(spec):
    """The squarings work modulo R' = 2^261 and leave values below 2p when
    4p < R': every field the kernels take (2p < 2^256) has that headroom,
    BLS12-381's included, so no field needs a canonical chain."""
    assert 2 * spec.p < 1 << 256
    assert 4 * spec.p < 1 << 257 <= 1 << fc.MPOW_R_BITS


@pytest.mark.parametrize("e", [0, 1, 2, 3, (1 << 256) - 1] + SEEDED[:20])
@pytest.mark.parametrize("spec", [BN254_FR, BLS12_381_FR], ids=["bn254", "bls12_381"])
def test_start_cancels_the_squares_factor(spec, e):
    """With R' = 2^261 the square handed over for bit i is x_i 2^(-5 (2^i - 1))
    (x_i the R = 2^256 Montgomery form of a^(2^i)); warp 1's start makes the
    product of those over e's bits, taken with R = 2^256 Montgomery
    products, the Montgomery form of a^e. Checked on integers."""
    p, R = spec.p, 1 << 256
    a = 0x1234567 % p
    acc = fc.mpow_start(spec, e)
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            z = pow(a, 1 << i, p) * R * pow(2, -5 * ((1 << i) - 1), p) % p
            acc = acc * z * pow(R, -1, p) % p
    assert acc == pow(a, e, p) * R % p


@pytest.mark.parametrize("spec", [BN254_FR, BLS12_381_FR], ids=["bn254", "bls12_381"])
def test_card_route_takes_field(spec):
    a = torch.zeros((16, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fc.mpow_scalar(spec, a, spec.p - 2)
