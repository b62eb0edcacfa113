"""Lossless carriage of state between numpy (and so JAX) and the port.

The system has no weights: its state is the circuit-static device arrays
and the (L, n) Montgomery limb planes that flow between prover stages. JAX
holds them as uint32; the port holds the same bit patterns as int32
(`torch.uint32` lacks add, shift and compare on the CPU). These casts are
bit-exact both ways, so a test can feed one stage's inputs to the JAX
function and to its port and compare the outputs.

The CRT engine's tables travel the same way: `crt_basis_from_numpy`,
`crt_plan_from_numpy` and `mxu_plan_from_numpy` turn the leaves of the JAX
package's `CrtBasis`, `CrtMatmulPlan` and `MxuNttPlan` (numpy arrays plus the
static fields) into the port's objects, so a test can run both packages on
the same tables; the port also builds its own from its own host code.
"""

from __future__ import annotations

import numpy as np
import torch


def planes_from_numpy(arr, device) -> torch.Tensor:
    """uint32 (or int32) array -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(arr)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        raise TypeError(f"expected a uint32/int32 array, got {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def planes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 array with the same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def tree_from_numpy(obj, device):
    """Dicts, lists and tuples of arrays -> the same structure of tensors:
    uint32/int32 arrays become int32 planes, other arrays keep their dtype."""
    if isinstance(obj, dict):
        return {k: tree_from_numpy(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_from_numpy(v, device) for v in obj)
    if isinstance(obj, np.ndarray):
        if obj.dtype in (np.uint32, np.int32):
            return planes_from_numpy(obj, device)
        return torch.from_numpy(np.ascontiguousarray(obj).copy()).to(device)
    return obj


def tree_to_numpy(obj):
    """Inverse of `tree_from_numpy`: int32 tensors come back as uint32."""
    if isinstance(obj, dict):
        return {k: tree_to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_to_numpy(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.int32:
            return planes_to_numpy(obj)
        return obj.detach().cpu().numpy()
    return obj


# ---------------------------------------------------------------------------
# the CRT engine's tables
# ---------------------------------------------------------------------------

_BASIS_TABLES = ("qs", "deltas", "C0", "C1", "G", "negM_dig", "NB", "PB")
_BASIS_STATIC = ("p", "bound_bits", "P", "qr", "qs_host", "t_host", "M", "minv_qr",
                 "delta_r", "dmax_bits", "p_limbs16")


def crt_basis_from_numpy(spec, static: dict, tables: dict):
    """The port's `CrtBasis` from a basis' static fields (`_BASIS_STATIC`)
    and its tables (`_BASIS_TABLES`) as numpy arrays of any float or integer
    dtype (every entry is a small integer)."""
    from stark_tpu_torch.ops import crt

    missing = [k for k in _BASIS_STATIC if k not in static] + [
        k for k in _BASIS_TABLES if k not in tables
    ]
    if missing:
        raise KeyError(f"basis fields missing: {missing}")
    return crt.CrtBasis.from_tables(
        spec, {k: static[k] for k in _BASIS_STATIC},
        {k: np.asarray(tables[k], np.float64) for k in _BASIS_TABLES},
    )


def crt_plan_from_numpy(w0, w1, device):
    """The port's `CrtMatmulPlan` from the two (P+1, Kout, K) digit planes of
    a constant matrix, values in [-64, 63] in any dtype."""
    from stark_tpu_torch.ops import crt

    w0, w1 = (np.asarray(w, np.float64) for w in (w0, w1))
    for w in (w0, w1):
        if w.shape != w0.shape or w.ndim != 3 or np.abs(w).max() > 64 or (w % 1).any():
            raise ValueError("digit planes must be two same-shape (P+1, Kout, K) integer arrays")
    return crt.CrtMatmulPlan.from_digits(w0.astype(np.int8), w1.astype(np.int8), device)


def mxu_plan_from_numpy(static: dict, basis_a, basis_b, plan_a, plan_b, twiddle, device):
    """The port's `MxuNttPlan` from its static fields (n, n1, n2, nz1), two
    bases and two matrix plans of the port, and the (P+1, n2, n1) twiddle
    residues (any integer dtype; stored as int16)."""
    from stark_tpu_torch.ops import mxu_ntt

    plan = object.__new__(mxu_ntt.MxuNttPlan)
    plan.n, plan.n1, plan.n2, plan.nz1 = (int(static[k]) for k in ("n", "n1", "n2", "nz1"))
    plan.basis_a, plan.basis_b, plan.plan_a, plan.plan_b = basis_a, basis_b, plan_a, plan_b
    tw = np.asarray(twiddle)
    if tw.shape != (len(basis_b.qs_host), plan.n2, plan.n1) or tw.max() >= 1 << 14:
        raise ValueError(f"twiddle residues of shape {tw.shape} do not fit the plan")
    plan.twiddle = torch.from_numpy(np.ascontiguousarray(tw.astype(np.int16))).to(device)
    return plan
