"""The plain version of `fri_fold_pre` against the JAX package's Pallas kernel
itself, run in interpret mode on the CPU, at a q that is neither a power of
two nor a multiple of the kernel's tile, with 0, p - 1 and 1 among the x.
The same numpy-seeded inputs go through the port's wrapper, which on a CPU
tensor runs the plain PyTorch version. Tolerance: exact equality of the
uint32 values. (`fri_fold_post` has its own file: interpret mode takes most
of a minute per kernel.)
"""

import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.protocol import pallas_kernels as jpk
from stark_tpu_torch.protocol import fused_kernels as fk
from torch_fused_inputs import cols as _cols, eq as _eq, no_launch as _no_launch, t as _t

torch.set_num_threads(2)

Q = 12


def test_fri_fold_pre_matches_pallas():
    (xs,) = _cols(60, width=4 * Q, edge=True)
    xs4 = xs.reshape(16, 4, Q)
    jeqs, jdens = jpk.fri_fold_pre(spec, xs4)
    eqs, dens = _no_launch(fk.fri_fold_pre, _t(xs4))
    assert eqs.shape == (16, 16, Q) and dens.shape == (16, 4, Q)
    _eq(eqs, jeqs)
    _eq(dens, jdens)
