"""Distributed four-step (Bailey) NTT over the 1-D mesh.

Counterpart of `stark_tpu/parallel/ntt4.py`. The domain is sharded
contiguously over the d ranks and the transform decomposes as

    N = d * M   (d ranks, M points a rank)
    x[n1*M + n2],  X[k1 + d*k2]
    X = DFT_M over n2 ( w_N^{n2*k1} * DFT_d over n1 (x) )

with the n1-axis DFT made local by an all-to-all, the twiddle product and
the M-point DFT local, and a last all-to-all restoring the natural
contiguous sharding. The products run on the `mmul` kernel. The local
M-point DFT (step 5) runs on either LDE engine (`make_tables`'
`lde_engine`): on the port's butterfly kernels (`ops/ntt.py run`: a DIF
plan at root w_N^d, natural in, bit-reversed out) followed by the bit
reversal that `_ntt_core` applies (`stark_tpu/ops/ntt.py:169-174`), since
the next all-to-all needs natural order; or, as the JAX body's `m_plan`
routes it (`ntt4.py:80-84`), on the CRT matrix-product engine
(`ops/mxu_ntt.py ntt_mxu`: the `residues_in`, `matmul_fold` and
`reconstruct` kernels), which is natural in and out. The collectives and
the layout are the same on either, so are the bytes between ranks. M must
be a multiple of d (N >= d^2).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from stark_tpu_torch.fields.field import FieldSpec
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.ops import mxu_ntt
from stark_tpu_torch.ops import ntt as nttm


@dataclass
class Ntt4Tables:
    """One rank's tables for an order-n sharded transform at `root`
    (`make_tables`): the d-point DFT's roots, this rank's twiddles and the
    local M-point DFT's: a butterfly plan and the bit reversal, or a CRT
    plan (`m_plan`, the JAX body's)."""

    w_d_half: torch.Tensor  # (L, max(d/2, 1)): powers of w_N^M, the order-d root
    w_m: int  # w_N^d, the order-M root of the local DFT
    tw: torch.Tensor  # (L, d, M/d): w_N^(n2*k1) for this rank's n2 chunk
    plan: nttm.NttPlan | None  # DIF plan of the local M-point DFT at w_m
    bitrev: torch.Tensor | None  # (M,) int64: the bit-reversal permutation
    m_plan: mxu_ntt.MxuNttPlan | None = None  # CRT plan of that DFT, natural in and out


def bitrev_perm(n: int, device) -> torch.Tensor:
    """i -> its log2(n)-bit reversal, as an int64 tensor."""
    bits = n.bit_length() - 1
    i = torch.arange(n, dtype=torch.int64, device=device)
    out = torch.zeros_like(i)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def make_tables(spec: FieldSpec, root: int, n: int, d: int, rank: int,
                inverse: bool = False, device="cuda",
                block: int = nttm.FUSED_BLOCK, lde_engine: str = "butterfly") -> Ntt4Tables:
    """Rank `rank`'s tables for an order-n sharded (i)NTT over d ranks
    (`stark_tpu/parallel/ntt4.py:97-116`, which builds every rank's twiddles
    on the host; here each rank makes its own chunk on its device). For the
    inverse pass inverse=True: tables of root^-1 (the caller multiplies by
    n^-1). `lde_engine` names the engine of the local M-point DFT:
    "butterfly", or "crt", whose plan is `mxu_ntt.make_ntt_plan_cached` at
    w_N^d, natural order in and out, no scale (the JAX package's
    `prove_sharded.py:173-182`)."""
    nttm.check_lde_engine(lde_engine)
    p = spec.p
    m = n // d
    if m % d or n % d:
        raise ValueError(f"the four-step NTT needs n >= d^2: n={n}, d={d}")
    r = spec.inv(root) if inverse else root % p
    w_d, w_m = pow(r, m, p), pow(r, d, p)
    # tw[k1, n2] = r^(n2*k1) for this rank's n2 = rank*m/d + j:
    # r^(k1*n2_0) * (r^k1)^j, a power table a row
    n2_0 = rank * (m // d)
    rows = [mm.mmul(spec, mm.power_table(spec, pow(r, k1, p), m // d, device),
                    mm.mont_const(spec, pow(r, k1 * n2_0, p), device))
            for k1 in range(d)]
    crt = lde_engine == "crt"
    return Ntt4Tables(
        w_d_half=mm.power_table(spec, w_d, max(d // 2, 1), device),
        w_m=w_m,
        tw=torch.stack(rows, dim=1),
        plan=None if crt else nttm.NttPlan(spec, w_m, m, "dif", device, block),
        bitrev=None if crt else bitrev_perm(m, device),
        m_plan=mxu_ntt.make_ntt_plan_cached(spec, w_m, m, device) if crt else None,
    )


def small_dft(spec: FieldSpec, a: torch.Tensor, w_d_half: torch.Tensor) -> torch.Tensor:
    """DFT of size d along axis 1 of (L, d, B), natural order in and out
    (`_small_dft_axis1`): radix-2 DIF stages on whole (L, B) rows, each
    product by a root on the `mmul` kernel (none by w^0 = 1, which leaves a
    canonical value as it is), then the rows in bit-reversed order."""
    d = a.shape[1]
    if d == 1:
        return a
    rows = [a[:, j] for j in range(d)]
    h = d // 2
    while h >= 1:
        for s in range(0, d, 2 * h):
            for j in range(h):
                u, v = rows[s + j], rows[s + j + h]
                rows[s + j] = mm.madd(spec, u, v)
                diff = mm.msub(spec, u, v)
                e = j * (d // (2 * h))
                rows[s + j + h] = diff if e == 0 else mm.mmul(spec, diff, w_d_half[:, e : e + 1])
        h //= 2
    order = bitrev_perm(d, "cpu").tolist()
    return torch.stack([rows[i] for i in order], dim=1)


def ntt_sharded_local(spec: FieldSpec, x_local: torch.Tensor, mesh, tables: Ntt4Tables,
                      n_inv_mont=None) -> torch.Tensor:
    """This rank's body of the four-step NTT (`ntt4.py:38-94`).
    x_local: (L, M), the rank's contiguous chunk of the (L, N) input;
    n_inv_mont: optional (L, 1) Montgomery 1/N for the inverse transform.
    Returns (L, M): the rank's chunk of the DFT in natural order."""
    L, M = x_local.shape
    d = mesh.size
    # 1: bring the n1 (rank) axis local for this rank's n2 chunk; axis 1 is
    # now the source rank n1, axis 2 the local n2 offset
    a = mesh.all_to_all(x_local.reshape(L, d, M // d))
    # 2: d-point DFT over n1 -> k1
    a = small_dft(spec, a, tables.w_d_half)
    # 3: twiddle w_N^(n2*k1)
    a = mm.mmul(spec, a, tables.tw)
    # 4: regroup so that each rank owns one k1 row with every n2 (axis 1
    # becomes the source rank q, and n2 = q*(M/d) + j)
    a = mesh.all_to_all(a).reshape(L, M)
    # 5: M-point DFT over n2 -> k2, natural order
    if tables.m_plan is not None:
        a = mxu_ntt.ntt_mxu(tables.m_plan, a)
    else:
        a = nttm.run(spec, a, tables.plan)[:, tables.bitrev]
    # 6: restore the natural contiguous sharding of X[k1 + d*k2]: axis 1 is
    # the source k1, axis 2 the k2 offset j; the local index is j*d + k1
    a = mesh.all_to_all(a.reshape(L, d, M // d))
    a = a.transpose(1, 2).reshape(L, M)
    if n_inv_mont is not None:
        a = mm.mmul(spec, a, n_inv_mont)
    return a
