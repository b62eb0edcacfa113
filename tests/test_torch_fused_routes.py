"""The port's fused route against the JAX package's composed branch on the
CPU, at the sizes and shapes a tiny interpret-mode run cannot show.

* the shifted-index stages at n = 2048 with `skips = 8` and `kshift = 40`
  (the JAX package's composed branch, `STARK_TPU_PALLAS=0`);
* `prefix_prod` through the recursive `scan_prod` stitching at 4096 and
  2^13, forward and reversed, and `multi_inv` with zeros;
* `mpow`'s routing: a 2-D operand of at most `MPOW_LANES` columns goes to
  `mpow_scalar` whatever the exponent, a wider or 3-D one does not;
* the Shoup-pattern stages at n = 2048, with the (16, 8) pattern pair the
  prover's stages build and with a pattern wider than a block, against the
  composed JAX branch on the Montgomery table;
* `leaves_to_words` against the JAX package's `_leaves_to_words` for 1 and
  8 columns.

Inputs come from a numpy seed. Tolerance: exact equality of the uint32
values (integer field arithmetic with canonical outputs).
"""

import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.parallel.prove_sharded import _leaves_to_words
from stark_tpu.protocol import kernels as jk
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.ops import field_cuda as fc
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import core
from stark_tpu_torch.protocol import kernels as k

torch.set_num_threads(2)

N = 2048


def _cols(seed: int, width: int = N, count: int = 1, zeros=()):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        by = rng.integers(0, 256, size=(width, 32), dtype=np.uint8)
        by[:, 31] &= 0x1F  # below 2^253 < p: canonical
        for z in zeros:
            by[z] = 0
        limbs = jmm.bytes_le_to_limbs_np(by, spec)
        out.append(np.asarray(jmm.to_mont(spec, limbs)))
    return out


def _t(a):
    return planes_from_numpy(np.asarray(a), "cpu")


def _eq(port, jax_arr):
    assert np.array_equal(planes_to_numpy(port), np.asarray(jax_arr))


@pytest.fixture
def composed(monkeypatch):
    """The JAX package on its composed (non-Pallas) branch."""
    monkeypatch.setenv("STARK_TPU_PALLAS", "0")


# --- the shifted-index stages at n = 2048 ---------------------------------------


def test_q1_shifted_matches_composed_jax(composed):
    s, kk, p, f0, f1 = _cols(1, count=5)
    _eq(k.q1_eval(tspec, *map(_t, (s, kk, p, f0, f1)), 8),
        jk.q1_eval(spec, s, kk, p, f0, f1, 8))


def test_q2_shifted_matches_composed_jax(composed):
    p, f2 = _cols(2, count=2)
    _eq(k.q2_eval(tspec, _t(p), _t(f2), 40), jk.q2_eval(spec, p, f2, 40))


def test_q3_shifted_matches_composed_jax(composed):
    a, vn, vd = _cols(3, count=3)
    _eq(k.q3_eval(tspec, _t(a), _t(vn), _t(vd), 8), jk.q3_eval(spec, a, vn, vd, 8))


def test_shifts_wrap_like_roll():
    """A shift beyond the domain, or a negative one, wraps as `roll` does."""
    p, f2, a, vn, vd = map(_t, _cols(4, width=64, count=5))
    assert torch.equal(k.q2_eval(tspec, p, f2, 40), k.q2_eval(tspec, p, f2, 40 + 64))
    assert torch.equal(k.q3_eval(tspec, a, vn, vd, -3), k.q3_eval(tspec, a, vn, vd, 61))


def test_stages_take_views_and_make_them_contiguous(composed):
    """`protocol/kernels.py` copies strided operands before the wrappers,
    which refuse them; the values are those of the contiguous operand."""
    wide_a, wide_b, wide_c = _cols(5, width=2 * N, count=3)
    a, b, c = (np.ascontiguousarray(x[:, ::2]) for x in (wide_a, wide_b, wide_c))
    got = k.sub_mul_ev(tspec, _t(wide_a)[:, ::2], _t(wide_b)[:, ::2], _t(wide_c)[:, ::2])
    _eq(got, jk.sub_mul_ev(spec, a, b, c))
    one = mm.mont_one(tspec, "cpu")
    _eq(k.sub_mul_ev(tspec, _t(a), one, _t(c)),
        jk.sub_mul_ev(spec, a, np.broadcast_to(np.asarray(jmm.mont_one(spec)), a.shape), c))


# --- prefix products through the recursion -----------------------------------------


def test_scan_levels():
    """The team scan's plan: one level up to SCAN_MAX_ROWS rows, beyond that
    the cheapest chunking under `modmath`'s model of a level."""
    assert mm.scan_levels(1) == [(1, 1)]
    assert mm.scan_levels(64) == [(64, 1)]
    assert mm.scan_levels(100) == [(100, 1)]  # refused by the first plan
    assert mm.scan_levels(4096) == [(16, 256), (256, 1)]
    assert mm.scan_levels(1 << 13) == [(32, 256), (256, 1)]
    assert mm.scan_levels(1 << 17) == [(16, 1 << 13), (32, 256), (256, 1)]
    assert mm.scan_levels(1 << 20) == [(16, 1 << 16), (256, 256), (256, 1)]
    with pytest.raises(ValueError):
        mm.scan_levels(0)


@pytest.mark.parametrize("n", [4096, 1 << 13])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reversed"])
def test_prefix_prod_recursion_matches_jax(n, reverse, monkeypatch):
    (v,) = _cols(6, width=n)
    seen = []
    real = fc.scan_prod
    monkeypatch.setattr(fc, "scan_prod",
                        lambda s, x: seen.append(tuple(x.shape[1:])) or real(s, x))
    got = mm.prefix_prod(tspec, _t(v), reverse)
    assert seen == mm.scan_levels(n)  # one scan per level of the recursion
    _eq(got, jmm.prefix_prod(spec, v, reverse))


def test_prefix_prod_with_a_zero_stays_zero_after_it():
    (v,) = _cols(7, width=4096, zeros=(1000,))
    got = planes_to_numpy(mm.prefix_prod(tspec, _t(v)))
    assert got[:, :1000].any(axis=0).all() and not got[:, 1000:].any()
    _eq(mm.prefix_prod(tspec, _t(v)), jmm.prefix_prod(spec, v))


def test_multi_inv_with_zeros_matches_jax():
    (v,) = _cols(8, width=4096, zeros=(0, 63, 64, 4095))
    got = mm.multi_inv(tspec, _t(v))
    _eq(got, jmm.multi_inv(spec, v))
    assert not planes_to_numpy(got)[:, [0, 63, 64, 4095]].any()


# --- mpow's routing ---------------------------------------------------------------------


@pytest.mark.parametrize("width,e,routed", [
    (8, spec.p - 2, True), (1, 1 << 31, True), (9, spec.p - 2, True),
    (8, 0xFFFF, True), (8, (1 << 31) - 1, True), (fc.MPOW_LANES, 5, True),
    (fc.MPOW_LANES + 1, spec.p - 2, False), (8, 0, True),
], ids=["8 lanes p-2", "1 lane 2^31", "9 lanes", "16-bit e", "31-bit e",
        "32 lanes", "33 lanes", "e=0"])
def test_mpow_routing(width, e, routed, monkeypatch):
    calls = []
    real = fc.mpow_scalar_plain
    monkeypatch.setattr(fc, "mpow_scalar_plain",
                        lambda s, a, ex: calls.append(tuple(a.shape)) or real(s, a, ex))
    (a,) = _cols(9, width=width)
    got = mm.mpow(tspec, _t(a), e)
    assert calls == ([(16, width)] if routed else [])
    _eq(got, jmm.mpow(spec, a, e))


def test_mpow_three_dimensional_operand_is_composed(monkeypatch):
    monkeypatch.setattr(fc, "mpow_scalar", None)  # would raise if it were called
    (a,) = _cols(10, width=8)
    a3 = a.reshape(16, 2, 4)
    _eq(mm.mpow(tspec, _t(a3), 1 << 40), jmm.mpow(spec, a3, 1 << 40))


# --- periodic constants as Shoup patterns -----------------------------------------


def _pattern(seed: int, t: int):
    """t plain constants (0, 1 and p - 1 among them), their Shoup pattern
    pair for the port and for the JAX package, and their Montgomery table
    tiled to N columns."""
    rng = np.random.default_rng(seed)
    vals = [0, 1, spec.p - 1] + [
        int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(t - 3)
    ]
    table = np.tile(np.asarray(jmm.mont_consts(spec, vals)), (1, N // t))
    return mm.shoup_consts(tspec, vals, "cpu"), jmm.shoup_consts(spec, vals), table


@pytest.mark.parametrize("t", [8, 1024])
def test_shoup_consts_match_jax(t):
    pats, jpats, _ = _pattern(12, t)
    for got, want in zip(pats, jpats):
        assert got.is_contiguous()
        _eq(got, want)


@pytest.mark.parametrize("t", [8, 1024])
def test_mmul_periodic_const_patterns_match_composed_jax(t, composed):
    pats, _, table = _pattern(13, t)
    (q,) = _cols(14)
    _eq(k.mmul_periodic_const(tspec, _t(q), None, pats),
        jk.mmul_periodic_const(spec, q, table))


def test_linear_combination_patterns_match_composed_jax(composed):
    pats, _, table = _pattern(15, 8)
    cols = _cols(16, count=8)
    (kk,) = _cols(17, width=11)
    _eq(k.linear_combination(tspec, _t(kk), None, *map(_t, cols), x2s_pats=pats),
        jk.linear_combination(spec, kk, table, *cols))


def test_pattern_width_must_divide_the_domain():
    pats, _, _ = _pattern(18, 8)
    (q,) = _cols(19, width=20)
    with pytest.raises(ValueError):
        k.mmul_periodic_const(tspec, _t(q), None, pats)


# --- leaf packing ----------------------------------------------------------------------------


@pytest.mark.parametrize("ncols", [1, 8])
def test_leaves_to_words_matches_jax(ncols):
    cols = _cols(11, width=64, count=ncols)
    want = np.asarray(_leaves_to_words(spec, cols))
    got = core.leaves_to_words(tspec, [_t(c) for c in cols])
    assert got.is_contiguous() and got.shape == (16 * max(1, (ncols + 1) // 2), 64)
    _eq(got, want)
    if ncols == 1:
        assert not planes_to_numpy(got)[8:].any()  # zero padding to one blake block
