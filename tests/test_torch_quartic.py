"""The composed form of FRI's Lagrange fold, `ops/quartic.py`, and the plain
versions of the two fold kernels, on the CPU.

* `quartic.multi_interp_4` / `eval_quartic_batch` against
  `stark_tpu/ops/quartic.py` and against the host interpolation
  (`utils/poly_host.py`);
* `fri_fold_pre` -> `multi_inv` -> `fri_fold_post` (their plain versions: the
  tensors lie on the CPU) against `quartic.multi_interp_4` +
  `eval_quartic_batch`, with 0, p - 1 and 1 among the inputs, at a q that is
  no power of two; each denominator equals the TPU pair's eq_j(x_j)
  (`torch_fused_inputs.fold_cubics`);
* a zero among a row's x keeps every difference canonical;
* a row with two equal x, and sx at one of a row's x, against the TPU
  pair's composition (cubics, `multi_inv`, combination: `old_fold`) on
  BN254's and BLS12-381's scalar fields;
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
from stark_tpu_torch.fields.field import BLS12_381_FR, BN254_FR as tspec
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.ops import quartic
from stark_tpu_torch.protocol import fused_kernels as fk
from stark_tpu_torch.utils import poly_host as ph
from torch_fused_inputs import cols as _cols, eq as _eq, fold_cubics, old_fold, t as _t

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


def _field_rows(field, seed: int, q: int):
    """xs4, ys4 (16, 4, q) and sx (16, 1) as Montgomery tensors of `field`."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % field.p for _ in range(8 * q + 1)]
    planes = mm.mont_consts(field, vals, "cpu")
    xs4, ys4 = (planes[:, k * 4 * q : (k + 1) * 4 * q].reshape(16, 4, q).contiguous()
                for k in range(2))
    return xs4, ys4, planes[:, 8 * q :].contiguous()


def _fold(field, sx, xs4, ys4):
    q = xs4.shape[2]
    dens = fk.fri_fold_pre(field, xs4)
    invs = mm.multi_inv(field, dens.reshape(16, 4 * q)).reshape(16, 4, q)
    return dens, invs, fk.fri_fold_post(field, sx, xs4, ys4, invs)


# --- the two kernels' plain versions ------------------------------------------


@pytest.mark.parametrize("q", [12, 32])
def test_fold_kernels_match_quartic(q):
    xs4, ys4 = (_t(a) for a in _rows(40, q, edge=True))
    sx = _t(_sx(41))
    dens, _, got = _fold(tspec, sx, xs4, ys4)
    polys = quartic.multi_interp_4(tspec, xs4.transpose(1, 2), ys4.transpose(1, 2))
    assert torch.equal(got, quartic.eval_quartic_batch(tspec, polys, sx))
    # dens[:, j] is the TPU pair's eq_j(x_j), eq_j monic with its roots at
    # the row's other three x
    eqs, e = fold_cubics(tspec, xs4)
    assert torch.equal(dens, e)
    for j in range(4):
        eq_j = eqs[:, 4 * j : 4 * j + 4].transpose(1, 2)
        for other in range(4):
            at = quartic.eval_quartic_batch(tspec, eq_j, xs4[:, other])
            assert torch.equal(at, dens[:, j]) if other == j else not at.any()


def test_negation_keeps_zero():
    """Zeros among a row's x: each difference 0 - x is p - x, and 0 - 0 is
    0, not p, so the denominators are canonical and those of the zero
    members 0 once two are zero."""
    xs4 = _t(_rows(42, 8)[0])
    xs4[:, 1, 0] = 0
    assert torch.equal(fk.fri_fold_pre(tspec, xs4), fold_cubics(tspec, xs4)[1])
    xs4[:, 2, 0] = 0
    xs4[:, 3, 0] = 0
    dens = fk.fri_fold_pre(tspec, xs4)
    assert torch.equal(dens, fold_cubics(tspec, xs4)[1])
    assert not dens[:, 1:, 0].any() and dens[:, 0, 0].any()
    assert all(v < tspec.p for v in _ints(dens))


@pytest.mark.parametrize("field", [tspec, BLS12_381_FR], ids=lambda f: f.name)
def test_equal_x_in_a_row(field):
    """A row with two equal x: their denominators are 0, so are their
    inverses, and the fold equals the TPU pair's on every row."""
    q = 6
    xs4, ys4, sx = _field_rows(field, 43, q)
    xs4[:, 3, 2] = xs4[:, 1, 2]
    dens, invs, got = _fold(field, sx, xs4, ys4)
    for j in range(4):
        assert bool(dens[:, j, 2].any()) == (j in (0, 2))
        assert bool(invs[:, j, 2].any()) == (j in (0, 2))
    assert torch.equal(got, old_fold(field, sx, xs4, ys4))


@pytest.mark.parametrize("field", [tspec, BLS12_381_FR], ids=lambda f: f.name)
def test_sx_at_a_row_x(field):
    """sx equal to member k of a row, whose x are distinct: the fold of that
    row is y_k; every row equals the TPU pair's."""
    q = 6
    xs4, ys4, _ = _field_rows(field, 44, q)
    for row, k in ((1, 0), (4, 3)):
        sx = xs4[:, k, row : row + 1].clone()
        got = _fold(field, sx, xs4, ys4)[2]
        assert torch.equal(got[:, row], ys4[:, k, row])
        assert torch.equal(got, old_fold(field, sx, xs4, ys4))


@pytest.mark.parametrize("which", ["pre", "post"])
def test_fold_wrappers_refuse_what_the_kernels_do_not_take(which):
    q = 8
    xs4, ys4 = (_t(a) for a in _rows(43, q))
    sx = _t(_sx(44))
    dens = fk.fri_fold_pre(tspec, xs4)
    if which == "pre":
        call = lambda x: fk.fri_fold_pre(tspec, x)  # noqa: E731
    else:
        call = lambda y: fk.fri_fold_post(tspec, sx, xs4, y, dens)  # noqa: E731
    wide = _t(_rows(45, 2 * q)[0])
    with pytest.raises(ValueError, match="contiguous"):
        call(wide[:, :, ::2])
    with pytest.raises(TypeError):
        call(xs4.to(torch.int64))
    with pytest.raises(ValueError, match="must be"):
        call(xs4.reshape(16, 4 * q))
    if which == "post":
        with pytest.raises(ValueError, match="must be"):
            call(wide)  # xs4 and invs have another q
        for x in (wide, wide[:, :, ::2]):  # the x: another q, not contiguous
            with pytest.raises(ValueError, match="must be"):
                fk.fri_fold_post(tspec, sx, x, ys4, dens)
        with pytest.raises(ValueError, match=r"\(16, 1\)"):
            fk.fri_fold_post(tspec, _t(_cols(46, width=2)[0]), xs4, ys4, dens)


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
