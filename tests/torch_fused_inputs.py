"""Inputs and comparisons shared by the `test_torch_fused*.py` files: the
same numpy-seeded Montgomery planes go to the JAX package as uint32 arrays
and to the port as int32 CPU tensors; results must be bit-identical."""

import numpy as np
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol.fused_kernels import _OTHERS, _mul

N = 16
EDGE = [0, spec.p - 1, 1]


def cols(seed: int, width: int = N, count: int = 1, edge: bool = False):
    """`count` (16, width) Montgomery planes from a numpy seed; with `edge`
    the first values are 0, p - 1 and 1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        vals = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(width)]
        if edge:
            vals[: min(width, len(EDGE))] = EDGE[:width]
        out.append(np.asarray(jmm.to_mont(spec, jmm.ints_to_limbs_np(vals, spec))))
    return out


def t(a):
    return planes_from_numpy(np.asarray(a), "cpu")


def eq(port, jax_arr):
    assert np.array_equal(planes_to_numpy(port), np.asarray(jax_arr))


def no_launch(wrapper, *args):
    """Call a wrapper on CPU tensors: it must run its plain version and
    leave its launch counter alone."""
    before = wrapper.launches
    out = wrapper(tspec, *args)
    assert wrapper.launches == before
    return out


# --- FRI's Lagrange fold as the TPU pair splits it -----------------------------
#
# `stark_tpu/protocol/pallas_kernels.py` carries the four vanishing cubics
# eq_j of each row from `fri_fold_pre` to `fri_fold_post`; the port's pair
# trades them for the x. These rebuild that split in plain PyTorch, so that
# the TPU's `fri_fold_post` can be fed the cubics of the port's x and the
# port's fold held against the old composition.

def fold_cubics(field, xs4):
    """(16, 4, q) x -> (eqs (16, 16, q), e (16, 4, q)): coefficient k (low to
    high) of the monic cubic eq_j with roots at the row's other three x at
    eqs[:, 4j + k], and e[:, j] = eq_j(x_j) by Horner, as the TPU's
    `fri_fold_pre` makes both."""
    L, _, q = xs4.shape
    x = [xs4[:, j] for j in range(4)]
    zero = torch.zeros_like(x[0])
    eqs = torch.empty((L, 16, q), dtype=torch.int32)
    e = torch.empty_like(xs4)
    for j, (a, b, c) in enumerate(_OTHERS):
        xab = _mul(field, x[a], x[b])
        c0 = mm.msub(field, zero, _mul(field, xab, x[c]))
        c1 = mm.madd(field, mm.madd(field, xab, _mul(field, x[a], x[c])),
                     _mul(field, x[b], x[c]))
        c2 = mm.msub(field, zero, mm.madd(field, mm.madd(field, x[a], x[b]), x[c]))
        for k, ck in enumerate((c0, c1, c2, mm.mont_one(field, "cpu").expand(L, q))):
            eqs[:, 4 * j + k] = ck
        acc = mm.madd(field, x[j], c2)
        acc = mm.madd(field, _mul(field, acc, x[j]), c1)
        e[:, j] = mm.madd(field, _mul(field, acc, x[j]), c0)
    return eqs, e


def fold_from_cubics(field, sx, eqs, ys4, invs):
    """The TPU's `fri_fold_post`: poly_k = sum_j eqs[:, 4j + k] * ys4[:, j] *
    invs[:, j], then Horner at the (16, 1) point sx."""
    poly = [None] * 4
    for j in range(4):
        w = _mul(field, ys4[:, j], invs[:, j])
        for k in range(4):
            term = _mul(field, eqs[:, 4 * j + k], w)
            poly[k] = term if poly[k] is None else mm.madd(field, poly[k], term)
    acc = poly[3]
    for k in (2, 1, 0):
        acc = mm.madd(field, _mul(field, acc, sx), poly[k])
    return acc


def old_fold(field, sx, xs4, ys4):
    """The whole Lagrange fold of the TPU pair's split: the cubics and their
    denominators, `multi_inv`, the combination at sx."""
    eqs, e = fold_cubics(field, xs4)
    q = xs4.shape[2]
    invs = mm.multi_inv(field, e.reshape(16, 4 * q)).reshape(16, 4, q)
    return fold_from_cubics(field, sx, eqs, ys4, invs)
