"""Elementwise prover stages over (L, precision) Montgomery planes.

Counterpart of `stark_tpu/protocol/kernels.py:47-236`, with its names and
signatures. Where the JAX package chooses between a fused Pallas kernel and
a composition of limb ops by backend, size and environment, each stage here
hands its operands, made contiguous, to its wrapper in
`protocol/fused_kernels.py`: a CUDA tensor goes to the hand-written kernel,
a CPU tensor to the composed plain version beside it (`q1_eval_plain`,
...), and nothing else decides.

As in the JAX package, `mmul_periodic_const` and `linear_combination` take
the periodic constants (Z^-1, x^steps) either as a Shoup pattern pair, which
the prover's stages always pass, or as the full (L, N) Montgomery table.
`accumulator_mini` composes the scan and power kernels of
`ops/field_cuda.py`.
"""

from __future__ import annotations

import torch

from stark_tpu_torch.fields.field import FieldSpec
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import fused_kernels as fk


def _c(*ts: torch.Tensor):
    """Operands as the kernels take them: views (slices of a stage's output,
    expanded constants) become contiguous copies, the rest pass untouched."""
    return [t.contiguous() for t in ts]


def sub_mul_ev(spec: FieldSpec, a, b, c):
    """(a - b) * c elementwise: the boundary quotients B2/B3. b may be one
    (L, 1) column."""
    return fk.sub_mul(spec, *_c(a, b, c))


def mmul_periodic_const(spec: FieldSpec, q, mont_table, shoup_pats=None):
    """q * a periodic per-domain constant (Z^-1): through the Shoup pattern
    pair of `modmath.shoup_consts` where one is given, which never reads a
    table, else by the full (L, N) Montgomery table."""
    if shoup_pats is not None:
        return fk.shoup_mul_periodic(spec, *_c(*shoup_pats, q))
    return mm.mmul(spec, q, mont_table)


def rand_combination(spec: FieldSpec, r_mont, idx_ev, perm_ev, s_ev):
    """val_nmr/val_dnm = r0 + r1*idx|perm + r2*S; r_mont: (L, 3)."""
    return fk.rand_combination(spec, *_c(r_mont, idx_ev, perm_ev, s_ev))


def accumulator_mini(spec: FieldSpec, val_nmr, val_dnm):
    """A(j) = prod(nmr)/prod(dnm) prefix ratios: one forward scan (nmr), one
    suffix scan (dnm), one Fermat inversion of the total."""
    L = val_nmr.shape[0]
    acc_nmr = mm.prefix_prod(spec, val_nmr)
    suf_inc = mm.prefix_prod(spec, val_dnm, reverse=True)
    total_inv = mm.minv(spec, suf_inc[:, :1])  # suf_inc[:, 0] = prod(all)
    one = mm.mont_one(spec, val_nmr.device).expand(L, 1)
    suf_exc = torch.cat([suf_inc[:, 1:], one], dim=1)
    inv_prefix = mm.mmul(spec, total_inv, suf_exc)
    return mm.mmul(spec, acc_nmr, inv_prefix)


def q1_eval(spec: FieldSpec, s_ev, k_ev, p_ev, f0_ev, f1_ev, skips: int):
    """Q1 = F0*(P - F1*P_prev - K*S)."""
    return fk.q1_eval(spec, *_c(s_ev, k_ev, p_ev, f0_ev, f1_ev), skips)


def q2_eval(spec: FieldSpec, p_ev, f2_ev, kshift: int):
    """Q2 = F2*(P(+2k) - P*P(+k))."""
    return fk.q2_eval(spec, *_c(p_ev, f2_ev), kshift)


def q3_eval(spec: FieldSpec, a_ev, val_nmr_big, val_dnm_big, skips: int):
    """Q3 = A*val_dnm - A_prev*val_nmr."""
    return fk.q3_eval(spec, *_c(a_ev, val_nmr_big, val_dnm_big), skips)


def horner_eval(spec: FieldSpec, coeffs_mont, xs_full):
    """Evaluate a low-degree polynomial (L, deg+1) on the whole domain."""
    return fk.horner_eval(spec, *_c(coeffs_mont, xs_full))


def vanishing_eval(spec: FieldSpec, xs_full, points_mont):
    """Zb(x) = prod_i (x - x_i); points_mont: (L, n_points)."""
    return fk.vanishing_eval(spec, *_c(xs_full, points_mont))


def linear_combination(spec: FieldSpec, k_mont, x_to_steps, p_ev, a_ev, s_ev,
                       d1, d2, d3, b2, b3, x2s_pats=None):
    """L = k0*D1 + k1*D2 + k2*D3 + k3*P + k4*P*x^steps + k5*B2
    + k6*B2*x^steps + k7*B3 + k8*B3*x^steps + k9*A + k10*S; k_mont: (L, 11).
    x^steps comes as the Shoup pattern pair `x2s_pats` where one is given
    (`x_to_steps` is then not read and may be None), else as the full (L, N)
    table `x_to_steps`."""
    if x2s_pats is not None:
        return fk.linear_combination_shoup(
            spec, *_c(k_mont, *x2s_pats, p_ev, a_ev, s_ev, d1, d2, d3, b2, b3)
        )
    return fk.linear_combination(
        spec, *_c(k_mont, x_to_steps, p_ev, a_ev, s_ev, d1, d2, d3, b2, b3)
    )
