"""`fri_fold_pre` against the JAX package's plain XLA reference of the
Lagrange fold, on the CPU, at a q that is neither a power of two nor a
multiple of the TPU kernel's tile, with 0, p - 1 and 1 among the x.

The TPU kernel (`stark_tpu/protocol/pallas_kernels.py:433 fri_fold_pre`)
is held against that reference by the JAX package's own
`tests/test_pallas_protocol.py::test_fri_fold_pre_post_matches_quartic`
(`quartic.multi_interp_4` + `eval_quartic_batch`, the route its fold takes
below 2^14 rows), so this file holds the port against the same reference
and needs no interpret-mode Pallas run (which took most of a minute):

* each denominator the port's kernel returns, e_j = eq_j(x_j), equals the
  product of x_j - x_m over the row's other three x, formed with the JAX
  package's `modmath` (eq_j is the monic cubic with those roots);
* `torch_fused_inputs.fold_cubics`, the TPU kernel's first output rebuilt in
  plain PyTorch for `test_torch_fri_post.py`, gives monic cubics that the
  JAX package's `quartic.eval_quartic_batch` finds zero at the row's other
  three x and equal to e_j at x_j, which fixes them;
* the composition pre -> `multi_inv` -> post equals `multi_interp_4` +
  `eval_quartic_batch` at a special x.

The same numpy-seeded inputs go through the port's wrapper, which on a CPU
tensor runs the plain PyTorch version. Tolerance: exact equality of the
uint32 values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.ops import quartic as jquartic
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_to_numpy
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import fused_kernels as fk
from torch_fused_inputs import (cols as _cols, eq as _eq, fold_cubics, no_launch as _no_launch,
                                t as _t)

torch.set_num_threads(2)

Q = 12


@pytest.fixture(scope="module")
def rows():
    """x (16, 4, Q) with 0, p - 1 and 1 among them, and the XLA
    reference's denominators: prod over m != j of (x_j - x_m)."""
    (xs,) = _cols(60, width=4 * Q, edge=True)
    xs4 = xs.reshape(16, 4, Q)
    dens = []
    for j in range(4):
        acc = None
        for m in range(4):
            if m != j:
                diff = jmm.msub(spec, xs4[:, j], xs4[:, m])
                acc = diff if acc is None else jmm.mmul(spec, acc, diff)
        dens.append(np.asarray(acc))
    return xs4, np.stack(dens, axis=1)


def test_fri_fold_pre_matches_pallas(rows):
    xs4, jdens = rows
    dens = _no_launch(fk.fri_fold_pre, _t(xs4))
    assert dens.shape == (16, 4, Q)
    _eq(dens, jdens)
    # the pair against the reference test_pallas_protocol.py holds the TPU
    # pair to: multi_interp_4 + eval_quartic_batch at a special x
    (ys,) = _cols(62, width=4 * Q, edge=True)
    ys4 = ys.reshape(16, 4, Q)
    (sxv,) = _cols(63, width=1)
    invs = mm.multi_inv(tspec, dens.reshape(16, 4 * Q)).reshape(16, 4, Q)
    got = _no_launch(fk.fri_fold_post, _t(sxv), _t(xs4), _t(ys4), invs)
    polys = jquartic.multi_interp_4(spec, jnp.moveaxis(xs4, 1, 2), jnp.moveaxis(ys4, 1, 2))
    _eq(got, jquartic.eval_quartic_batch(spec, polys, jnp.broadcast_to(sxv, (16, Q))))


def test_cubic_helper_matches_pallas(rows):
    xs4, jdens = rows
    eqs, e = fold_cubics(tspec, _t(xs4))
    _eq(e, jdens)
    eqs = planes_to_numpy(eqs)
    one = np.asarray(jmm.mont_one(spec)).reshape(16, 1)
    for j in range(4):
        cubic = jnp.asarray(np.moveaxis(eqs[:, 4 * j : 4 * j + 4], 1, 2))  # (16, Q, 4)
        assert (eqs[:, 4 * j + 3] == one).all()  # monic
        for m in range(4):
            at = np.asarray(jquartic.eval_quartic_batch(spec, cubic, xs4[:, m]))
            assert np.array_equal(at, jdens[:, j] if m == j else np.zeros_like(at)), (j, m)
