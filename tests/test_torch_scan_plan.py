"""`prefix_prod` and `multi_inv` of the port at every length the JAX package
takes, and the plan of `scan_prod` launches behind them.

The JAX package's composed route (`stark_tpu/ops/modmath.py prefix_prod`,
the one it runs on the CPU) takes a length n exactly when its power-of-two
block `_block_size(n)` divides n; that rule is copied here. The port's plan
(`modmath.scan_levels`) is a pure function of n: it is checked for every
such n up to 2^16 without a product computed, and then `prefix_prod`
(forward and reversed) and `multi_inv` with zeros go through both packages
at lengths that are no power of two, and at 4096. Inputs are numpy arrays
from a seed. Tolerance: exact equality of the uint32 values (integer field
arithmetic with canonical outputs).
"""

import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.ops import field_cuda as fc
from stark_tpu_torch.ops import modmath as mm
from torch_fused_inputs import cols, eq as _eq, t as _t

torch.set_num_threads(2)

LENGTHS = [48, 80, 96, 160, 192, 320, 4096]


def _cols(seed: int, width: int, zeros=()):
    """A (16, width) Montgomery plane from a numpy seed: 0, p - 1 and 1
    first, then random values, with 0 at the columns `zeros`."""
    (v,) = cols(seed, width=width, edge=True)
    v = v.copy()
    v[:, list(zeros)] = 0
    return v


def _jax_block_size(n: int) -> int:
    """`stark_tpu/ops/modmath.py _block_size`, copied."""
    b = 1
    while b * b < n:
        b *= 2
    return min(b, 1024)


def _jax_takes(n: int) -> bool:
    return n % _jax_block_size(n) == 0


def _check_plan(n: int, levels) -> None:
    assert levels, n
    width = n
    for B, C in levels:
        assert B >= 1 and C >= 1 and B * C == width, (n, levels)
        width = C
    assert width == 1, (n, levels)


def test_plan_covers_every_length_the_jax_package_takes():
    taken = [n for n in range(1, (1 << 16) + 1) if _jax_takes(n)]
    assert len(taken) > 300 and 80 in taken and 100 not in taken
    for n in taken:
        _check_plan(n, mm.scan_levels(n))


def test_plan_rows_stay_short():
    """Every level with more than one column scans at most SCAN_MAX_ROWS
    rows (the plain version loops over them); only a length with no
    divisor in [2, SCAN_MAX_ROWS] is one long level."""
    for n in list(range(1, 5000)) + [1 << 17, 1 << 20, 3 * (1 << 18), 10**6]:
        levels = mm.scan_levels(n)
        _check_plan(n, levels)
        for B, C in levels:
            if B > mm.SCAN_MAX_ROWS:
                assert C == 1 and all(B % d for d in range(2, mm.SCAN_MAX_ROWS + 1)), (
                    n, levels)


def test_plan_launches_what_the_kernel_takes():
    """Every level of every plan gets a team the CUDA launcher accepts:
    powers of two, T <= B, at most SCAN_BLOCK threads a block; wide
    levels get one thread a column."""
    assert mm.scan_levels(1 << 20) == mm.scan_levels(1 << 20)  # a pure function
    for n in list(range(1, 2000)) + [1 << 12, 1 << 17, 1 << 18, 1 << 20, 10**6]:
        for B, C in mm.scan_levels(n):
            T, CB = fc.scan_team(B, C)
            assert T & (T - 1) == 0 and CB & (CB - 1) == 0, (B, C, T, CB)
            assert 1 <= T <= B and T * CB <= fc.SCAN_BLOCK, (B, C, T, CB)
            assert T == 1 or C < fc.SCAN_WIDE, (B, C, T)
            assert mm.scan_products(B, C) >= C * (B - 1)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reversed"])
def test_prefix_prod_matches_jax_at_every_taken_length(n, reverse):
    v = _cols(30 + n, n, zeros=(n // 3,))
    _eq(mm.prefix_prod(tspec, _t(v), reverse), jmm.prefix_prod(spec, v, reverse))


@pytest.mark.parametrize("n", LENGTHS)
def test_multi_inv_matches_jax_at_every_taken_length(n):
    v = _cols(50 + n, n, zeros=(0, n // 2, n - 1))
    got = mm.multi_inv(tspec, _t(v))
    _eq(got, jmm.multi_inv(spec, v))
    assert not got[:, [0, n // 2, n - 1]].any()


@pytest.mark.parametrize("n", [100, 1000, 257])
def test_lengths_the_jax_package_refuses_give_the_products(n):
    """The port takes any n >= 1 (the JAX package asserts on 100 and
    1000): the values are those of the plain row-by-row scan."""
    v = _cols(70 + n, n)
    want = fc.scan_prod_plain(tspec, _t(v).reshape(16, n, 1)).reshape(16, n)
    assert torch.equal(mm.prefix_prod(tspec, _t(v)), want)
