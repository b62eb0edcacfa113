"""The plain versions of the port's two Shoup-form stages against the JAX
package: `pallas_kernels.shoup_mul_periodic` itself, run in interpret mode
on the CPU, and, for `linear_combination_shoup`, the plain XLA reference
that the JAX package's own
`tests/test_pallas_protocol.py::test_linear_combination_shoup` holds that
TPU kernel (`stark_tpu/protocol/pallas_kernels.py:319`) against:
`protocol/kernels.py linear_combination` with the x^steps constants tiled
to the domain (the interpret-mode kernel took half a minute).

Both run at a tiny width, n = 16, with a (16, 8) pattern pair of
`modmath.shoup_consts` (0, 1 and p - 1 among the plain constants, 0, p - 1
and 1 among the data). The same numpy-seeded inputs go through the port's
wrappers, which on a CPU tensor run the plain PyTorch versions. Tolerance:
exact equality of the uint32 values (integer field arithmetic with canonical
outputs). The other kernels' files are `test_torch_fused.py`,
`test_torch_fused_loops.py`, `test_torch_fused_scan.py` and
`test_torch_fused_lincomb.py`.
"""

import numpy as np
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.protocol import kernels as jkernels
from stark_tpu.protocol import pallas_kernels as jpk
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import fused_kernels as fk
from torch_fused_inputs import N, cols as _cols, eq as _eq, no_launch as _no_launch, t as _t

torch.set_num_threads(2)

T = 8


def _consts(seed: int):
    rng = np.random.default_rng(seed)
    return [0, 1, spec.p - 1] + [
        int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(T - 3)
    ]


def test_shoup_mul_periodic_matches_pallas():
    vals = _consts(20)
    (x,) = _cols(21, edge=True)
    got = _no_launch(fk.shoup_mul_periodic, *mm.shoup_consts(tspec, vals, "cpu"), _t(x))
    _eq(got, jpk.shoup_mul_periodic(spec, *jmm.shoup_consts(spec, vals), x))
    # and both are x times the constants, in Montgomery form
    want = [a * vals[i % T] % spec.p
            for i, a in enumerate(jmm.limbs_to_ints_np(jmm.from_mont(spec, x), spec))]
    _eq(mm.from_mont(tspec, got), jmm.ints_to_limbs_np(want, spec))


def test_linear_combination_shoup_matches_pallas():
    vals = _consts(22)
    (km,) = _cols(23, width=11)
    cols = _cols(24, count=8, edge=True)
    got = _no_launch(fk.linear_combination_shoup, _t(km),
                     *mm.shoup_consts(tspec, vals, "cpu"), *map(_t, cols))
    x2s = np.tile(np.asarray(jmm.mont_consts(spec, vals)), (1, N // T))
    _eq(got, jkernels.linear_combination(spec, km, x2s, *cols))
