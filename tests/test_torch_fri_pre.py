"""`fri_fold_pre` against the JAX package's Pallas kernel itself, run in
interpret mode on the CPU, at a q that is neither a power of two nor a
multiple of the kernel's tile, with 0, p - 1 and 1 among the x.

The port's kernel returns the TPU kernel's second output, the Lagrange
denominators, and not its first, the four vanishing cubics of each row;
`torch_fused_inputs.fold_cubics` rebuilds those in plain PyTorch for
`test_torch_fri_post.py`, and is held here against the TPU kernel's. The
same numpy-seeded inputs go through the port's wrapper, which on a CPU
tensor runs the plain PyTorch version. Tolerance: exact equality of the
uint32 values. (`fri_fold_post` has its own file: interpret mode takes
most of a minute per kernel.)
"""

import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.protocol import pallas_kernels as jpk
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.protocol import fused_kernels as fk
from torch_fused_inputs import (cols as _cols, eq as _eq, fold_cubics, no_launch as _no_launch,
                                t as _t)

torch.set_num_threads(2)

Q = 12


@pytest.fixture(scope="module")
def pallas_pre():
    """x (16, 4, Q), and the TPU kernel's (cubics, denominators) of them."""
    (xs,) = _cols(60, width=4 * Q, edge=True)
    xs4 = xs.reshape(16, 4, Q)
    return xs4, jpk.fri_fold_pre(spec, xs4)


def test_fri_fold_pre_matches_pallas(pallas_pre):
    xs4, (_, jdens) = pallas_pre
    dens = _no_launch(fk.fri_fold_pre, _t(xs4))
    assert dens.shape == (16, 4, Q)
    _eq(dens, jdens)


def test_cubic_helper_matches_pallas(pallas_pre):
    xs4, (jeqs, jdens) = pallas_pre
    eqs, e = fold_cubics(tspec, _t(xs4))
    _eq(eqs, jeqs)
    _eq(e, jdens)
