"""The plain versions of the port's three kernels with a run-time loop against
the JAX package's Pallas kernels themselves, run in interpret mode on the
CPU: `horner_eval` (one coefficient and several, up to one past a group of
four of the CUDA kernel's), `vanishing_eval` (one point and several,
likewise) and `mpow_scalar` (e = p - 2, p - 1, 0, 1, a 33-bit exponent and
2^256 - 1 on BN254's scalar field, p - 2 on BLS12-381's).

Each Pallas kernel is called directly (`pallas_kernels.horner_eval(spec,
...)`, `pallas_field.mpow_scalar`) at a tiny width: n = 16, and (16, 4) for
the power. The same numpy-seeded inputs go through the port's wrapper, which on a CPU
tensor runs the plain PyTorch version. Tolerance: exact equality of the
uint32 values (integer field arithmetic with canonical outputs). Interpret
mode takes seconds per kernel, so the thirteen kernels are spread over
`test_torch_fused.py`, `test_torch_fused_loops.py`, `test_torch_fused_scan.py`,
`test_torch_fused_lincomb.py` and `test_torch_fused_shoup.py`, each under a
minute on one worker.
"""

import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BLS12_381_FR as jbls
from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.ops import pallas_field as jpf
from stark_tpu.protocol import pallas_kernels as jpk
from stark_tpu_torch.fields.field import BLS12_381_FR as tbls
from stark_tpu_torch.interop import planes_to_numpy
from stark_tpu_torch.ops import field_cuda as fc
from stark_tpu_torch.protocol import fused_kernels as fk
from torch_fused_inputs import cols as _cols, eq as _eq, no_launch as _no_launch, t as _t

torch.set_num_threads(2)


@pytest.mark.parametrize("d", [1, 3, 5])
def test_horner_matches_pallas(d):
    (coeffs,) = _cols(8, width=d)
    (xs,) = _cols(9)
    _eq(_no_launch(fk.horner_eval, _t(coeffs), _t(xs)), jpk.horner_eval(spec, coeffs, xs))


@pytest.mark.parametrize("npts", [1, 3, 5])
def test_vanishing_matches_pallas(npts):
    (pts,) = _cols(10, width=npts)
    (xs,) = _cols(11)
    _eq(_no_launch(fk.vanishing_eval, _t(xs), _t(pts)), jpk.vanishing_eval(spec, xs, pts))


def _bls_cols(seed: int, width: int):
    """(16, width) Montgomery planes of BLS12-381's scalar field: 0, p - 1,
    1, then values from a numpy seed."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % jbls.p for _ in range(width)]
    vals[:3] = [0, jbls.p - 1, 1]
    return np.asarray(jmm.to_mont(jbls, jmm.ints_to_limbs_np(vals, jbls)))


@pytest.mark.parametrize(
    "field,e",
    [("bn254", spec.p - 2), ("bn254", spec.p - 1), ("bn254", 0), ("bn254", 1),
     ("bn254", 2**32 + 5), ("bn254", 2**256 - 1), ("bls12_381", jbls.p - 2)],
    ids=["p-2", "p-1", "0", "1", "2^32+5", "2^256-1", "bls12_381-p-2"])
def test_mpow_scalar_matches_pallas(field, e):
    if field == "bn254":
        (a,) = _cols(16, width=4, edge=True)  # lanes: 0, p - 1, 1, random
        jspec, port = spec, lambda x: _no_launch(fc.mpow_scalar, x, e)
    else:
        a = _bls_cols(16, 4)
        jspec, port = jbls, lambda x: fc.mpow_scalar(tbls, x, e)
    got = port(_t(a))
    _eq(got, jpf.mpow_scalar(jspec, a, e))
    if e > 0:
        assert not planes_to_numpy(got)[:, 0].any()  # 0 -> 0, as minv relies on
    else:
        _eq(got, np.broadcast_to(np.asarray(jmm.mont_one(spec)), a.shape))
