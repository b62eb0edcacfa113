"""`fri_fold_post` against the JAX package's plain XLA reference of the
Lagrange fold, on the CPU, at a q that is neither a power of two nor a
multiple of the TPU kernel's tile.

The TPU pair (`stark_tpu/protocol/pallas_kernels.py:433 fri_fold_pre`,
`:478 fri_fold_post`) is held against `quartic.multi_interp_4` +
`eval_quartic_batch` by the JAX package's own
`tests/test_pallas_protocol.py::test_fri_fold_pre_post_matches_quartic`;
this file holds the port's `fri_fold_post` against the same reference, so
it needs no interpret-mode Pallas run (which took most of a minute). The
reference interpolates each row's four points with the cubics of the
row's x, one batched `multi_inv` of their denominators and the combination
the TPU kernel makes, so it is the TPU kernel's formula at every row, the
degenerate ones too.

The inverted denominators come from the port's `fri_fold_pre` and
`multi_inv` on numpy-seeded x, with 0, p - 1 and 1 among the x and the y,
a row with two equal x (its denominators and their inverses 0) and sx
equal to one of a row's x. Tolerance: exact equality.
"""

import jax.numpy as jnp
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import quartic as jquartic
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_to_numpy
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import fused_kernels as fk
from torch_fused_inputs import cols as _cols, eq as _eq, no_launch as _no_launch, t as _t

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
    got = _no_launch(fk.fri_fold_post, sx, xs4, ys4, invs)
    assert got.shape == (16, Q)
    jx, jy = (jnp.moveaxis(jnp.asarray(planes_to_numpy(a)), 1, 2) for a in (xs4, ys4))
    polys = jquartic.multi_interp_4(spec, jx, jy)
    _eq(got, jquartic.eval_quartic_batch(
        spec, polys, jnp.broadcast_to(jnp.asarray(planes_to_numpy(sx)), (16, Q))))
    assert torch.equal(got[:, 7], ys4[:, 3, 7])
