"""The plain version of the port's linear combination against the JAX
package's Pallas kernel itself, run in interpret mode on the CPU.

`pallas_kernels.linear_combination(spec, ...)` is called directly at a tiny
width, n = 16. The same numpy-seeded inputs go through the port's wrapper, which on a CPU
tensor runs the plain PyTorch version. Tolerance: exact equality of the
uint32 values (integer field arithmetic with canonical outputs). Interpret
mode takes seconds per kernel, so the thirteen kernels are spread over
`test_torch_fused.py`, `test_torch_fused_loops.py`, `test_torch_fused_scan.py`,
`test_torch_fused_lincomb.py` and `test_torch_fused_shoup.py`, each under a
minute on one worker.
"""

import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.protocol import pallas_kernels as jpk
from stark_tpu_torch.protocol import fused_kernels as fk
from torch_fused_inputs import cols as _cols, eq as _eq, no_launch as _no_launch, t as _t

torch.set_num_threads(2)


def test_linear_combination_matches_pallas():
    (km,) = _cols(6, width=11)
    cols = _cols(7, count=9)
    _eq(_no_launch(fk.linear_combination, _t(km), *map(_t, cols)),
        jpk.linear_combination(spec, km, *cols))
