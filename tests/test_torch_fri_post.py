"""`fri_fold_post` against the JAX package's Pallas kernel itself, run in
interpret mode on the CPU, at a q that is neither a power of two nor a
multiple of the kernel's tile.

The port's kernel takes the x of each row where the TPU's takes the four
vanishing cubics of those x; the TPU kernel is fed the cubics of the same x,
built in plain PyTorch by `torch_fused_inputs.fold_cubics` (held to the
TPU's `fri_fold_pre` in `test_torch_fri_pre.py`), so this file runs one
Pallas kernel. The inverted denominators come from the port's
`fri_fold_pre` and `multi_inv` on numpy-seeded x, with 0, p - 1 and 1 among
the x and the y, a row with two equal x (its denominators and their
inverses 0) and sx equal to one of a row's x. Tolerance: exact equality.
"""

import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.protocol import pallas_kernels as jpk
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_to_numpy
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import fused_kernels as fk
from torch_fused_inputs import (cols as _cols, eq as _eq, fold_cubics, no_launch as _no_launch,
                                t as _t)

torch.set_num_threads(2)

Q = 12


def test_fri_fold_post_matches_pallas():
    xs, ys = _cols(61, width=4 * Q, count=2, edge=True)
    xs4, ys4 = _t(xs.reshape(16, 4, Q)), _t(ys.reshape(16, 4, Q))
    xs4[:, 2, 5] = xs4[:, 0, 5]  # row 5: two equal x
    sx = xs4[:, 3, 7:8].clone()  # row 7's last x
    dens = fk.fri_fold_pre(tspec, xs4)
    assert not dens[:, 0, 5].any() and not dens[:, 2, 5].any()
    invs = mm.multi_inv(tspec, dens.reshape(16, 4 * Q)).reshape(16, 4, Q)
    eqs, _ = fold_cubics(tspec, xs4)
    want = jpk.fri_fold_post(spec, planes_to_numpy(sx), planes_to_numpy(eqs),
                             planes_to_numpy(ys4), planes_to_numpy(invs))
    got = _no_launch(fk.fri_fold_post, sx, xs4, ys4, invs)
    assert got.shape == (16, Q)
    _eq(got, want)
    assert torch.equal(got[:, 7], ys4[:, 3, 7])
