"""Batched degree-4 Lagrange interpolation and evaluation (FRI row ops).

Counterpart of `stark_tpu/ops/quartic.py`: `multi_interp_4` interpolates Q
independent 4-point sets with one shared batched inversion and
`eval_quartic_batch` evaluates the resulting cubics. Planes are limbs-first
Montgomery int32: xsets and ysets are (L, Q, 4).

This is the composed form of the Lagrange FRI fold, over `modmath`'s
`mmul`/`madd`/`msub`/`multi_inv`. The prover's fold runs the two kernels
`fused_kernels.fri_fold_pre` / `fri_fold_post` instead; this module is the
second reference they are held against.
"""

from __future__ import annotations

import torch

from stark_tpu_torch.fields.field import FieldSpec
from stark_tpu_torch.ops import modmath as mm


def eval_quartic_batch(spec: FieldSpec, polys: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """polys: (L, Q, 4), coefficients low to high; x: (L, Q) or (L, 1).
    Returns (L, Q)."""
    if x.dim() == 2 and x.shape[1] == 1:
        x = x.expand(x.shape[0], polys.shape[1])
    xsq = mm.mmul(spec, x, x)
    xcb = mm.mmul(spec, xsq, x)
    acc = polys[:, :, 0]
    acc = mm.madd(spec, acc, mm.mmul(spec, polys[:, :, 1], x))
    acc = mm.madd(spec, acc, mm.mmul(spec, polys[:, :, 2], xsq))
    acc = mm.madd(spec, acc, mm.mmul(spec, polys[:, :, 3], xcb))
    return acc


def multi_interp_4(spec: FieldSpec, xsets: torch.Tensor, ysets: torch.Tensor) -> torch.Tensor:
    """Batched 4-point Lagrange interpolation, (L, Q, 4) -> (L, Q, 4): per
    set, the four cubics eq_i vanishing at the other three xs, each evaluated
    at its own x, all 4Q denominators inverted at once, then combined."""
    L, Q, _ = xsets.shape
    x = [xsets[:, :, j] for j in range(4)]
    y = [ysets[:, :, j] for j in range(4)]
    mul = lambda a, b: mm.mmul(spec, a, b)  # noqa: E731
    add = lambda a, b: mm.madd(spec, a, b)  # noqa: E731
    zero = torch.zeros((L, Q), dtype=torch.int32, device=xsets.device)
    neg = lambda a: mm.msub(spec, zero, a)  # noqa: E731
    one = mm.mont_one(spec, xsets.device).expand(L, Q)

    x01, x02, x03 = mul(x[0], x[1]), mul(x[0], x[2]), mul(x[0], x[3])
    x12, x13, x23 = mul(x[1], x[2]), mul(x[1], x[3]), mul(x[2], x[3])

    def eq(xab, xac, xbc, xa, xb, xc, xabc):
        # the monic cubic with roots {xa, xb, xc}, low to high
        c0 = neg(xabc)
        c1 = add(add(xab, xac), xbc)
        c2 = neg(add(add(xa, xb), xc))
        return torch.stack([c0, c1, c2, one], dim=-1)  # (L, Q, 4)

    eqs = [
        eq(x12, x13, x23, x[1], x[2], x[3], mul(x12, x[3])),
        eq(x02, x03, x23, x[0], x[2], x[3], mul(x02, x[3])),
        eq(x01, x03, x13, x[0], x[1], x[3], mul(x01, x[3])),
        eq(x01, x02, x12, x[0], x[1], x[2], mul(x01, x[2])),
    ]
    denoms = torch.stack(
        [eval_quartic_batch(spec, eqs[j], x[j]) for j in range(4)], dim=-1
    ).reshape(L, 4 * Q)
    invs = mm.multi_inv(spec, denoms).reshape(L, Q, 4)

    out = torch.zeros((L, Q, 4), dtype=torch.int32, device=xsets.device)
    for j, eqj in enumerate(eqs):
        w = mul(y[j], invs[:, :, j])  # (L, Q)
        out = add(out, mul(eqj, w[:, :, None]))
    return out
