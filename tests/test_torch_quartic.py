"""The composed form of FRI's Lagrange fold, `ops/quartic.py`, and the plain
versions of the two fold kernels, on the CPU.

* `quartic.multi_interp_4` / `eval_quartic_batch` against
  `stark_tpu/ops/quartic.py` and against the host interpolation
  (`utils/poly_host.py`);
* `fri_fold_pre` -> `multi_inv` -> `fri_fold_post` (their plain versions: the
  tensors lie on the CPU) against `quartic.multi_interp_4` +
  `eval_quartic_batch`, with 0, p - 1 and 1 among the inputs, at a q that is
  no power of two; each cubic is monic and vanishes where it must;
* a negated 0 stays 0;
* what the wrappers refuse.

Inputs come from a numpy seed. Tolerance: exact equality (integer field
arithmetic with canonical outputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import quartic as jquartic
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.ops import quartic
from stark_tpu_torch.protocol import fused_kernels as fk
from stark_tpu_torch.utils import poly_host as ph
from torch_fused_inputs import cols as _cols, eq as _eq, t as _t

torch.set_num_threads(2)


def _rows(seed: int, q: int, edge: bool = False):
    """xs4, ys4 as (16, 4, q) uint32 Montgomery arrays; with `edge`, 0, p - 1
    and 1 among the first x and y (the x of a row stay distinct)."""
    xs, ys = _cols(seed, width=4 * q, count=2, edge=edge)
    return xs.reshape(16, 4, q), ys.reshape(16, 4, q)


def _sx(seed: int):
    return _cols(seed, width=1)[0]


def _ints(mont) -> list[int]:
    flat = mont.reshape(16, -1).contiguous()
    return mm.limbs_to_ints_np(mm.from_mont(tspec, flat).numpy().view(np.uint32), tspec)


# --- the two kernels' plain versions ------------------------------------------


@pytest.mark.parametrize("q", [12, 32])
def test_fold_kernels_match_quartic(q):
    xs4, ys4 = (_t(a) for a in _rows(40, q, edge=True))
    sx = _t(_sx(41))
    eqs, dens = fk.fri_fold_pre(tspec, xs4)
    invs = mm.multi_inv(tspec, dens.reshape(16, 4 * q)).reshape(16, 4, q)
    got = fk.fri_fold_post(tspec, sx, eqs, ys4, invs)
    polys = quartic.multi_interp_4(tspec, xs4.transpose(1, 2), ys4.transpose(1, 2))
    assert torch.equal(got, quartic.eval_quartic_batch(tspec, polys, sx))
    # eq_j is monic and vanishes at the row's other three x
    one = mm.mont_one(tspec, "cpu").expand(16, q)
    for j in range(4):
        assert torch.equal(eqs[:, 4 * j + 3], one)
        eq_j = eqs[:, 4 * j : 4 * j + 4].transpose(1, 2)
        for other in range(4):
            at = quartic.eval_quartic_batch(tspec, eq_j, xs4[:, other])
            assert torch.equal(at, dens[:, j]) if other == j else not at.any()


def test_negation_keeps_zero():
    """A row with x = 0 among the other three: c0 = -0 must be 0, not p."""
    xs4 = _t(_rows(42, 8)[0])
    xs4[:, 1, 0] = 0
    eqs, _ = fk.fri_fold_pre(tspec, xs4)
    for j in (0, 2, 3):
        assert not eqs[:, 4 * j, 0].any()
    xs4[:, 2, 0] = 0  # two zeros: e.g. eq_0's c1 = x1*x2 + x1*x3 + x2*x3 = 0 too
    xs4[:, 3, 0] = 0  # three: eq_0 = x^3, so c2 = -(0) = 0
    eqs, _ = fk.fri_fold_pre(tspec, xs4)
    assert not eqs[:, 0:3, 0].any()


@pytest.mark.parametrize("which", ["pre", "post"])
def test_fold_wrappers_refuse_what_the_kernels_do_not_take(which):
    q = 8
    xs4, ys4 = (_t(a) for a in _rows(43, q))
    sx = _t(_sx(44))
    eqs, dens = fk.fri_fold_pre(tspec, xs4)
    if which == "pre":
        call = lambda x: fk.fri_fold_pre(tspec, x)  # noqa: E731
    else:
        call = lambda y: fk.fri_fold_post(tspec, sx, eqs, y, dens)  # noqa: E731
    wide = _t(_rows(45, 2 * q)[0])
    with pytest.raises(ValueError, match="contiguous"):
        call(wide[:, :, ::2])
    with pytest.raises(TypeError):
        call(xs4.to(torch.int64))
    with pytest.raises(ValueError, match="must be"):
        call(xs4.reshape(16, 4 * q))
    if which == "post":
        with pytest.raises(ValueError, match="must be"):
            call(wide)  # eqs and invs have another q
        with pytest.raises(ValueError, match=r"\(16, 1\)"):
            fk.fri_fold_post(tspec, _t(_cols(46, width=2)[0]), eqs, ys4, dens)


# --- ops/quartic.py ------------------------------------------------------------


def test_quartic_matches_jax_and_host():
    Q = 6
    xs, ys = _cols(50, width=4 * Q, count=2, edge=True)
    xsets, ysets = xs.reshape(16, Q, 4), ys.reshape(16, Q, 4)
    at = _cols(51, width=Q)[0]
    jpolys = jquartic.multi_interp_4(spec, jnp.asarray(xsets), jnp.asarray(ysets))
    polys = quartic.multi_interp_4(tspec, _t(xsets), _t(ysets))
    _eq(polys, jpolys)
    for x in (at, _sx(52)):  # a point per set, and one (16, 1) point for all
        _eq(quartic.eval_quartic_batch(tspec, polys, _t(x)),
            jquartic.eval_quartic_batch(spec, jpolys, jnp.asarray(x)))
    xi, yi, pi = _ints(_t(xsets)), _ints(_t(ysets)), _ints(polys)
    ai = _ints(_t(at))
    vi = _ints(quartic.eval_quartic_batch(tspec, polys, _t(at)))
    for s in range(Q):
        want = ph.lagrange_interp(tspec, xi[4 * s : 4 * s + 4], yi[4 * s : 4 * s + 4])
        assert pi[4 * s : 4 * s + 4] == want
        assert vi[s] == ph.eval_quartic(tspec, want, ai[s])
