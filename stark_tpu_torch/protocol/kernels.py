"""Elementwise prover stages over (L, precision) Montgomery planes.

Counterpart of `stark_tpu/protocol/kernels.py:47-236` on its composed
branches (the ones the JAX package runs when its fused Pallas protocol
kernels are off): each stage is a composition of `mmul` (the CUDA kernel on
a card), `madd`/`msub` and rolls. The fused protocol kernels
(`stark_tpu/protocol/pallas_kernels.py`) are later ports.
"""

from __future__ import annotations

import torch

from stark_tpu.fields.field import FieldSpec
from stark_tpu_torch.ops import modmath as mm


def sub_mul_ev(spec: FieldSpec, a, b, c):
    """(a - b) * c elementwise: the boundary quotients B2/B3."""
    return mm.mmul(spec, mm.msub(spec, a, b), c)


def mmul_periodic_const(spec: FieldSpec, q, mont_table):
    """q * a per-domain constant given as a full (L, N) Montgomery table."""
    return mm.mmul(spec, q, mont_table)


def rand_combination(spec: FieldSpec, r_mont, idx_ev, perm_ev, s_ev):
    """val_nmr/val_dnm = r0 + r1*idx|perm + r2*S; r_mont: (L, 3)."""
    r0, r1, r2 = r_mont[:, 0:1], r_mont[:, 1:2], r_mont[:, 2:3]
    r2s = mm.mmul(spec, r2, s_ev)
    nmr = mm.madd(spec, r0, mm.madd(spec, mm.mmul(spec, r1, idx_ev), r2s))
    dnm = mm.madd(spec, r0, mm.madd(spec, mm.mmul(spec, r1, perm_ev), r2s))
    return nmr, dnm


def accumulator_mini(spec: FieldSpec, val_nmr, val_dnm):
    """A(j) = prod(nmr)/prod(dnm) prefix ratios: one forward scan (nmr), one
    suffix scan (dnm), one Fermat inversion of the total."""
    L = val_nmr.shape[0]
    acc_nmr = mm.prefix_prod(spec, val_nmr)
    suf_inc = mm.prefix_prod(spec, val_dnm.flip(1)).flip(1)
    total_inv = mm.minv(spec, suf_inc[:, :1])  # suf_inc[:, 0] = prod(all)
    one = mm.mont_one(spec, val_nmr.device).expand(L, 1)
    suf_exc = torch.cat([suf_inc[:, 1:], one], dim=1)
    inv_prefix = mm.mmul(spec, total_inv, suf_exc)
    return mm.mmul(spec, acc_nmr, inv_prefix)


def q1_eval(spec: FieldSpec, s_ev, k_ev, p_ev, f0_ev, f1_ev, skips: int):
    """Q1 = F0*(P - F1*P_prev - K*S)."""
    p_prev = torch.roll(p_ev, skips, dims=1)
    return mm.mmul(
        spec,
        f0_ev,
        mm.msub(
            spec,
            p_ev,
            mm.madd(spec, mm.mmul(spec, f1_ev, p_prev), mm.mmul(spec, k_ev, s_ev)),
        ),
    )


def q2_eval(spec: FieldSpec, p_ev, f2_ev, kshift: int):
    """Q2 = F2*(P(+2k) - P*P(+k))."""
    p_plus_w = torch.roll(p_ev, -kshift, dims=1)
    p_plus_2w = torch.roll(p_ev, -2 * kshift, dims=1)
    return mm.mmul(spec, f2_ev, mm.msub(spec, p_plus_2w, mm.mmul(spec, p_ev, p_plus_w)))


def q3_eval(spec: FieldSpec, a_ev, val_nmr_big, val_dnm_big, skips: int):
    """Q3 = A*val_dnm - A_prev*val_nmr."""
    a_prev = torch.roll(a_ev, skips, dims=1)
    return mm.msub(
        spec, mm.mmul(spec, a_ev, val_dnm_big), mm.mmul(spec, a_prev, val_nmr_big)
    )


def horner_eval(spec: FieldSpec, coeffs_mont, xs_full):
    """Evaluate a low-degree polynomial (L, deg+1) on the whole domain."""
    out = torch.zeros_like(xs_full)
    for i in range(coeffs_mont.shape[1] - 1, -1, -1):
        out = mm.madd(spec, mm.mmul(spec, out, xs_full), coeffs_mont[:, i : i + 1])
    return out


def vanishing_eval(spec: FieldSpec, xs_full, points_mont):
    """Zb(x) = prod_i (x - x_i); points_mont: (L, n_points)."""
    acc = mm.mont_one(spec, xs_full.device).expand(xs_full.shape)
    for i in range(points_mont.shape[1]):
        acc = mm.mmul(spec, acc, mm.msub(spec, xs_full, points_mont[:, i : i + 1]))
    return acc


def linear_combination(spec: FieldSpec, k_mont, x_to_steps, p_ev, a_ev, s_ev,
                       d1, d2, d3, b2, b3):
    """L = k0*D1 + k1*D2 + k2*D3 + k3*P + k4*P*x^steps + k5*B2
    + k6*B2*x^steps + k7*B3 + k8*B3*x^steps + k9*A + k10*S, with the full
    (L, N) x^steps table; k_mont: (L, 11)."""
    km = [k_mont[:, i : i + 1] for i in range(11)]
    mulx = lambda col: mm.mmul(spec, col, x_to_steps)  # noqa: E731
    terms = [
        mm.mmul(spec, km[0], d1),
        mm.mmul(spec, km[1], d2),
        mm.mmul(spec, km[2], d3),
        mm.mmul(spec, km[3], p_ev),
        mm.mmul(spec, km[4], mulx(p_ev)),
        mm.mmul(spec, km[5], b2),
        mm.mmul(spec, km[6], mulx(b2)),
        mm.mmul(spec, km[7], b3),
        mm.mmul(spec, km[8], mulx(b3)),
        mm.mmul(spec, km[9], a_ev),
        mm.mmul(spec, km[10], s_ev),
    ]
    out = terms[0]
    for t in terms[1:]:
        out = mm.madd(spec, out, t)
    return out
