"""The plain version of `fri_fold_post` against the JAX package's Pallas
kernel itself, run in interpret mode on the CPU, at a q that is neither a
power of two nor a multiple of the kernel's tile. The cubics and the inverted
denominators come from the port's `fri_fold_pre` and `multi_inv` on
numpy-seeded x (0, p - 1 and 1 among the x and the y) and go to both as the
same uint32 values. Tolerance: exact equality. (`fri_fold_pre` has its own
file: interpret mode takes most of a minute per kernel.)
"""

import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.protocol import pallas_kernels as jpk
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_to_numpy
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import fused_kernels as fk
from torch_fused_inputs import cols as _cols, eq as _eq, no_launch as _no_launch, t as _t

torch.set_num_threads(2)

Q = 12


def test_fri_fold_post_matches_pallas():
    xs, ys = _cols(61, width=4 * Q, count=2, edge=True)
    (sx,) = _cols(62, width=1)
    ys4 = ys.reshape(16, 4, Q)
    eqs, dens = fk.fri_fold_pre(tspec, _t(xs.reshape(16, 4, Q)))
    invs = mm.multi_inv(tspec, dens.reshape(16, 4 * Q)).reshape(16, 4, Q)
    want = jpk.fri_fold_post(spec, sx, planes_to_numpy(eqs), ys4, planes_to_numpy(invs))
    got = _no_launch(fk.fri_fold_post, _t(sx), eqs, _t(ys4), invs)
    assert got.shape == (16, Q)
    _eq(got, want)
