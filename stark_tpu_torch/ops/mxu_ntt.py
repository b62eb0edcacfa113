"""Four-step NTT as CRT modular matrix products.

Counterpart of `stark_tpu/ops/mxu_ntt.py`. `DFT_n` with `n = n1*n2`
(j = j1*n2 + j2, k = k1 + n1*k2):

    A1[k1, j2] = sum_j1 W1[k1, j1] * x[j1, j2]      W1 = (w^n2)^(k1*j1)
    A2[k1, j2] = A1[k1, j2] * T[k1, j2]             T  = w^(k1*j2)
    X[k1, k2]  = sum_j2 W2[k2, j2] * A2[k1, j2]     W2 = (w^n1)^(k2*j2)

Both sums are `crt.crt_matmul` calls (step B takes T as a residue-space
pre-table); the output laid out as (k2, k1) reshapes directly to the
natural-order flat DFT, with no bit reversal anywhere. The transpose between
the steps and the reshapes of the three-level plan are plain torch ops.

The LDE (inverse transform, zero-pad, forward transform) becomes: small
four-step iNTT (scale n^-1 folded into its W2) -> natural-order coefficients
-> the (nz1, n2) view of the zero-padded vector is the coefficient array
itself -> big NTT whose step A contracts only the nz1 = steps/n2 nonzero
rows.

Plans hold their tables as tensors on one device: the constant matrices'
digit planes as int8, the twiddle pre-tables as int16 (every prime is below
2^14; at n = 2^20 the table is 57 x 2^20 values). The host build of a plan
is cached on disk as an `.npz` under `ops/plan_cache.py CACHE_DIR`, which a
deployment sets before its first plan; the port never reads a file the JAX
package wrote.

`lde_mxu_sharded` is the LDE on a mesh (`parallel/distributed.py
DomainMesh`): each rank runs the matrix products on its share of the batch
axes, and the (n1, n2) transposes between the two products of a transform
are the all-to-alls between ranks.
"""

from __future__ import annotations

import hashlib
import os
import warnings
import zipfile

import numpy as np
import torch

from stark_tpu_torch.fields.field import FieldSpec
from stark_tpu_torch.ops import crt, plan_cache

_PLAN_KEYS = ("bits_a", "bits_b", "aw0", "aw1", "bw0", "bw1", "tw")


def _pow_matrix(base: int, rows: int, cols: int, p: int, scale: int = 1):
    """[[scale * base^(r*c) mod p]] as a list of row lists (python ints)."""
    out = []
    cur_row_base = 1  # base^r
    for _ in range(rows):
        row = []
        v = scale % p
        for _ in range(cols):
            row.append(v)
            v = v * cur_row_base % p
        out.append(row)
        cur_row_base = cur_row_base * base % p
    return out


def _power_rows_residues(w: int, n1: int, n2: int, p: int, qs) -> np.ndarray:
    """Residues (P+1, n1*n2) of w^(k1*j2), k1 < n1 the slow index."""
    flat = []
    wk1 = 1
    for _ in range(n1):
        v = 1
        for _ in range(n2):
            flat.append(v)
            v = v * wk1 % p
        wk1 = wk1 * w % p
    return crt.residues_of_ints_np(crt.ints_to_bytes_np(flat), qs)


def _twiddle_residues(w: int, n1: int, n2: int, p: int, qs) -> np.ndarray:
    """T[k1, j2] = w^(k1*j2) laid out as (P+1, j2, k1) residues int16 (the
    step-B pre-table: data arrives transposed as (n2, n1))."""
    res = _power_rows_residues(w, n1, n2, p, qs)
    res = res.reshape(len(qs), n1, n2).transpose(0, 2, 1)
    return np.ascontiguousarray(res.astype(np.int16))


def _split(n: int, n1, n2):
    if n1 is None:
        logn = n.bit_length() - 1
        n1 = 1 << ((logn + 1) // 2)
        n2 = n // n1
    return n1, n2


class MxuNttPlan:
    """Tables for one (root, n, n1, n2[, scale, nz1]) transform on a device."""

    def __init__(self, spec: FieldSpec, root: int, n: int, device, n1=None, n2=None,
                 scale: int = 1, nz1=None, stepa_pre: bool = False):
        p = spec.p
        n1, n2 = _split(n, n1, n2)
        assert n1 * n2 == n and max(n1, n2) <= 1024, (
            "the digit sums stay below 2^24 only for contractions <= 1024"
        )
        self.n, self.n1, self.n2 = n, n1, n2
        self.nz1 = nz1 if nz1 is not None else n1
        assert 1 <= self.nz1 <= n1
        w1 = pow(root, n2, p)
        w2 = pow(root, n1, p)
        # a step-A pre-table (three-level mid twiddle) adds a factor p
        bits_a = (
            (self.nz1 - 1).bit_length()
            + (3 if stepa_pre else 2) * p.bit_length() + 2
        )
        bits_b = (n2 - 1).bit_length() + 3 * p.bit_length() + 2
        self.basis_a = crt.CrtBasis(spec, bits_a)
        self.basis_b = crt.CrtBasis(spec, bits_b)
        wa = _pow_matrix(w1, n1, self.nz1, p)  # W1[k1, j1], j1 < nz1
        self.plan_a = crt.CrtMatmulPlan(self.basis_a, wa, device)
        wb = _pow_matrix(w2, n2, n2, p, scale=scale)  # W2[k2, j2] * scale
        self.plan_b = crt.CrtMatmulPlan(self.basis_b, wb, device)
        self.twiddle = torch.from_numpy(
            _twiddle_residues(root, n1, n2, p, self.basis_b.qs_host)
        ).to(device)


def ntt_mxu(plan: MxuNttPlan, x: torch.Tensor) -> torch.Tensor:
    """Natural-order DFT of (L, m) canonical/Montgomery limb planes, where
    m = nz1*n2 (m = n without zero-padding structure). Returns (L, n)."""
    L = x.shape[0]
    xv = x.reshape(L, plan.nz1, plan.n2)
    a1 = crt.crt_matmul(plan.basis_a, plan.plan_a, xv)  # (L, n1, n2)
    a1t = a1.transpose(1, 2).contiguous()  # (L, n2, n1)
    out = crt.crt_matmul(plan.basis_b, plan.plan_b, a1t, pre=plan.twiddle)
    return out.reshape(L, plan.n)  # (L, n2out, n1) = X[k2, k1]


class MxuNttPlan3:
    """Three-level four-step plan for n = n1 * m (m = inner n up to 2^20,
    n1 <= 1024): step A contracts n1, a full-size twiddle scales, and the
    inner transform is a batched two-level `MxuNttPlan` applied across the
    n1 rows."""

    def __init__(self, spec: FieldSpec, root: int, n: int, device, scale: int = 1, n1=None):
        p = spec.p
        logn = n.bit_length() - 1
        if n1 is None:
            assert logn > 20, "use MxuNttPlan for n <= 2^20"
            n1 = 1 << (logn - 20)
        assert n1 <= 1024, "n too large for the three-level split"
        m = n // n1
        assert n1 * m == n
        self.n, self.n1, self.m = n, n1, m
        w1 = pow(root, m, p)  # order n1
        bits_a = (n1 - 1).bit_length() + 2 * p.bit_length() + 2
        self.basis_a = crt.CrtBasis(spec, bits_a)
        self.plan_a = crt.CrtMatmulPlan(self.basis_a, _pow_matrix(w1, n1, n1, p), device)
        # mid twiddle W[k1, j23] = root^(k1*j23) as residues of the INNER
        # plan's step-A basis (applied as its pre-table); the inner plan's
        # own twiddle then applies inside as usual.
        self.inner = make_ntt_plan_cached(
            spec, pow(root, n1, p), m, device, scale=scale, stepa_pre=True
        )
        qa = self.inner.basis_a.qs_host
        self.mid = torch.from_numpy(_twiddle_mid_residues(root, n1, m, p, qa)).to(device)


def _twiddle_mid_residues(w, n1, m, p, qs) -> np.ndarray:
    """T[k1, j23] = w^(k1*j23) for the inner step-A pre-table, laid out as
    (P+1, n1*m) int16, viewed later as (P+1, n1, inner_n1, inner_n2)."""
    return np.ascontiguousarray(_power_rows_residues(w, n1, m, p, qs).astype(np.int16))


def ntt_mxu3(plan: MxuNttPlan3, x: torch.Tensor) -> torch.Tensor:
    """Natural-order DFT via the three-level plan. The n1 outer rows ride
    the B (batch) axis of the inner plan's two products."""
    L = x.shape[0]
    n1 = plan.n1
    inner = plan.inner
    in1, in2 = inner.n1, inner.n2
    xv = x.reshape(L, n1, plan.m)
    a1 = crt.crt_matmul(plan.basis_a, plan.plan_a, xv)  # (L, n1, m)
    # inner step A across all n1 rows: contraction over j2 (= inner rows),
    # mid twiddle w^(k1*j23) folded in as the pre-table
    av = a1.reshape(L, n1, in1, in2).transpose(1, 2).reshape(L, in1, n1 * in2)
    p1 = plan.mid.shape[0]
    pre = plan.mid.reshape(p1, n1, in1, in2).transpose(1, 2).reshape(p1, in1, n1 * in2)
    b1 = crt.crt_matmul(inner.basis_a, inner.plan_a, av.contiguous(), pre=pre.contiguous())
    # b1: (L, in1out, n1*in2); inner step B: contraction over j3
    bv = b1.reshape(L, in1, n1, in2).permute(0, 3, 2, 1).reshape(L, in2, n1 * in1)
    pre2 = inner.twiddle  # (P+1, in2, in1)
    pre2 = pre2[:, :, None, :].expand(pre2.shape[0], in2, n1, in1).reshape(
        pre2.shape[0], in2, n1 * in1
    )
    out = crt.crt_matmul(inner.basis_b, inner.plan_b, bv.contiguous(), pre=pre2.contiguous())
    # out: (L, in2out=k2', n1*in1) with trailing dims (k1, k1'); overall
    # flat k = k1 + n1*(k1' + in1*k2')
    ov = out.reshape(L, in2, n1, in1).permute(0, 1, 3, 2)  # (L, k2', k1', k1)
    return ov.reshape(L, plan.n)


def _plan_cache_path(spec, root, n, n1, n2, scale, nz1, stepa_pre) -> str:
    key = f"v1:{spec.p}:{root}:{n}:{n1}:{n2}:{scale}:{nz1}:{stepa_pre}:int8:int16"
    h = hashlib.sha256(key.encode()).hexdigest()[:24]
    d = os.path.expanduser(plan_cache.CACHE_DIR)
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"ntt_{h}.npz")


def make_ntt_plan_cached(spec: FieldSpec, root: int, n: int, device, n1=None, n2=None,
                         scale: int = 1, nz1=None, stepa_pre: bool = False) -> MxuNttPlan:
    """`MxuNttPlan` with an on-disk cache of its host-built tables, in
    `plan_cache.CACHE_DIR`. A file that is missing, truncated, not an `.npz` or short
    of a table counts as a miss: the tables are built and the file written
    anew."""
    n1, n2 = _split(n, n1, n2)
    path = _plan_cache_path(spec, root, n, n1, n2, scale, nz1, stepa_pre)
    try:
        with np.load(path) as npz:
            data = {name: npz[name] for name in _PLAN_KEYS}
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        data = None
    if data is not None:
        plan = object.__new__(MxuNttPlan)
        plan.n, plan.n1, plan.n2 = n, n1, n2
        plan.nz1 = nz1 if nz1 is not None else n1
        plan.basis_a = crt.CrtBasis(spec, int(data["bits_a"]))
        plan.basis_b = crt.CrtBasis(spec, int(data["bits_b"]))
        plan.plan_a = crt.CrtMatmulPlan.from_digits(data["aw0"], data["aw1"], device)
        plan.plan_b = crt.CrtMatmulPlan.from_digits(data["bw0"], data["bw1"], device)
        plan.twiddle = torch.from_numpy(data["tw"]).to(device)
        return plan
    plan = MxuNttPlan(spec, root, n, device, n1=n1, n2=n2, scale=scale, nz1=nz1,
                      stepa_pre=stepa_pre)
    try:
        tmp = f"{path}.tmp{os.getpid()}.npz"
        np.savez(
            tmp,
            bits_a=plan.basis_a.bound_bits,
            bits_b=plan.basis_b.bound_bits,
            aw0=plan.plan_a.W0.cpu().numpy(),
            aw1=plan.plan_a.W1.cpu().numpy(),
            bw0=plan.plan_b.W0.cpu().numpy(),
            bw1=plan.plan_b.W1.cpu().numpy(),
            tw=plan.twiddle.cpu().numpy(),
        )
        os.replace(tmp, path)
    except OSError as e:
        # best-effort plan cache: a read-only/full disk must not break the
        # prover, but anything else (shape/dtype bugs) should surface
        warnings.warn(f"plan cache write failed: {e}")
    return plan


def make_lde_plans(spec: FieldSpec, g1: int, g2: int, steps: int, precision: int, device):
    """(iNTT plan at g1^-1 with n^-1 scale, big NTT plan at g2 with
    zero-structure), the pair of transforms of one LDE.

    precision <= 2^20 fits the two-level plan (both contractions <= 1024);
    above that the big transform gets the three-level `MxuNttPlan3` (outer
    n1 = precision/2^20 rides the batch axis; inner contractions stay
    1024)."""
    inv_plan = make_ntt_plan_cached(
        spec, spec.inv(g1) % spec.p, steps, device, scale=spec.inv(steps)
    )
    if precision > 1 << 20:
        big_plan = MxuNttPlan3(spec, g2, precision, device, n1=precision >> 20)
        return inv_plan, big_plan
    n1, n2 = _split(precision, None, None)
    if steps % n2:
        raise ValueError(
            f"the CRT engine needs steps to be a multiple of {n2} at precision "
            f"{precision}, got {steps}"
        )
    big_plan = make_ntt_plan_cached(
        spec, g2, precision, device, n1=n1, n2=n2, nz1=steps // n2
    )
    return inv_plan, big_plan


def lde_mxu(inv_plan: MxuNttPlan, big_plan, trace: torch.Tensor) -> torch.Tensor:
    """(L, steps) -> (L, precision) low-degree extension. With a two-level
    big plan the zero-pad between the transforms is a pure reshape
    (natural-order coefficients ARE the nonzero rows of the padded (n1, n2)
    view); the three-level plan takes the explicitly padded coefficient
    vector."""
    coeffs = ntt_mxu(inv_plan, trace)  # natural-order coefficients * n^-1
    if isinstance(big_plan, MxuNttPlan3):
        L = coeffs.shape[0]
        pad = coeffs.new_zeros((L, big_plan.n - coeffs.shape[1]))
        return ntt_mxu3(big_plan, torch.cat([coeffs, pad], dim=1))
    return ntt_mxu(big_plan, coeffs)


def lde_mxu_many(inv_plan: MxuNttPlan, big_plan, traces) -> list:
    """LDE a list of (L, steps) columns, one after the other (there is no
    traced module to share: peak memory is one column's working set)."""
    return [lde_mxu(inv_plan, big_plan, t) for t in traces]


def _exchange(mesh, x: torch.Tensor) -> torch.Tensor:
    """(L, d, A, C): block q of axis 1 goes to rank q -> (L, d, A, C) whose
    block s came from rank s (`DomainMesh.all_to_all`)."""
    L, d, A, C = x.shape
    return mesh.all_to_all(x.reshape(L, d, A * C)).reshape(L, d, A, C)


def _ntt_mxu_cols(plan: MxuNttPlan, x: torch.Tensor, mesh) -> torch.Tensor:
    """`ntt_mxu`'s two products on a mesh: x (L, nz1, n2/d) is every row of
    the rank's chunk of n2 columns. Step A on it, the transpose as an
    all-to-all (the rank gets every j2 of its chunk of n1/d k1), step B with
    that chunk of the twiddle pre-table. -> (L, n2, n1/d): X[k2, k1] for the
    rank's k1."""
    L, d, r = x.shape[0], mesh.size, mesh.rank
    c1, c2 = plan.n1 // d, plan.n2 // d
    a1 = crt.crt_matmul(plan.basis_a, plan.plan_a, x.contiguous())  # (L, n1, n2/d)
    a1 = a1.transpose(1, 2).reshape(L, c2, d, c1).transpose(1, 2)  # (L, d, n2/d, n1/d)
    b = _exchange(mesh, a1).reshape(L, plan.n2, c1)
    pre = plan.twiddle[:, :, r * c1 : (r + 1) * c1].contiguous()
    return crt.crt_matmul(plan.basis_b, plan.plan_b, b, pre=pre)


def lde_mxu_sharded(mesh, inv_plan: MxuNttPlan, big_plan, trace_local: torch.Tensor):
    """The rank's contiguous chunk of `lde_mxu(inv_plan, big_plan, trace)`
    from its contiguous (L, steps/d) chunk of the trace
    (`stark_tpu/ops/mxu_ntt.py:387-410`, where GSPMD shards the batch axes).
    Both transforms run their products on the rank's share of the batch
    axes: an all-to-all gives each rank every row of its columns, one more
    is the transpose between the products. The steps-domain coefficients
    are all-gathered, as `parallel/prove_sharded.py lde_local` does, and each
    rank takes its columns of the zero-padded (nz1, n2) view; a last
    all-to-all restores the natural contiguous chunks. No rank holds more
    of a precision-domain column than its chunk's worth. Every collective
    is counted in `mesh.stats`. Two-level plans only, with every n1 and n2
    a multiple of d."""
    d, r = mesh.size, mesh.rank
    if not isinstance(big_plan, MxuNttPlan):
        raise ValueError("lde_mxu_sharded takes the two-level plan (precision <= 2^20)")
    if any(k % d for k in (inv_plan.n1, inv_plan.n2, big_plan.n1, big_plan.n2)):
        raise ValueError(
            f"lde_mxu_sharded needs the plans' n1 and n2 to be multiples of d = {d}: "
            f"({inv_plan.n1}, {inv_plan.n2}) and ({big_plan.n1}, {big_plan.n2})")
    L, m = trace_local.shape
    steps, n1i, n2i = m * d, inv_plan.n1, inv_plan.n2
    if steps != inv_plan.n or big_plan.nz1 * big_plan.n2 != steps:
        raise ValueError(f"a trace chunk of {m} columns does not fit the plans over {d} ranks")
    # the iNTT: every j1 of the rank's j2 chunk
    x = trace_local.reshape(L, n1i // d, d, n2i // d).transpose(1, 2)
    x = _exchange(mesh, x).reshape(L, n1i, n2i // d)
    coeff = _ntt_mxu_cols(inv_plan, x, mesh)  # (L, n2i, n1i/d): c = k1 + n1i k2
    coeffs = mesh.all_gather_stack(coeff).permute(1, 2, 0, 3).reshape(L, steps)
    # the forward transform on the rank's n2 chunk of the (nz1, n2) view
    c2 = big_plan.n2 // d
    x = coeffs.reshape(L, big_plan.nz1, big_plan.n2)[:, :, r * c2 : (r + 1) * c2]
    out = _ntt_mxu_cols(big_plan, x, mesh)  # (L, n2, n1/d)
    out = _exchange(mesh, out.reshape(L, d, c2, big_plan.n1 // d))
    return out.transpose(1, 2).reshape(L, big_plan.n // d)
