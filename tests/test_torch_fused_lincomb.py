"""The plain version of the port's linear combination against the JAX
package's plain XLA reference of the TPU kernel, on the CPU.

The TPU kernel (`stark_tpu/protocol/pallas_kernels.py:190
linear_combination`) is held against `protocol/kernels.py
linear_combination` on its XLA route by the JAX package's own
`tests/test_pallas_protocol.py::test_linear_combination`; this file holds
the port against the same reference at a tiny width, n = 16, and so runs no
interpret-mode Pallas kernel (which took half a minute). The same
numpy-seeded inputs go through the port's wrapper, which on a CPU tensor
runs the plain PyTorch version. Tolerance: exact equality of the
uint32 values (integer field arithmetic with canonical outputs). The
thirteen kernels' comparisons are spread over
`test_torch_fused.py`, `test_torch_fused_loops.py`, `test_torch_fused_scan.py`,
`test_torch_fused_lincomb.py` and `test_torch_fused_shoup.py`, each under a
minute on one worker.
"""

import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.protocol import kernels as jkernels
from stark_tpu_torch.protocol import fused_kernels as fk
from torch_fused_inputs import cols as _cols, eq as _eq, no_launch as _no_launch, t as _t

torch.set_num_threads(2)


def test_linear_combination_matches_pallas():
    (km,) = _cols(6, width=11)
    cols = _cols(7, count=9)
    _eq(_no_launch(fk.linear_combination, _t(km), *map(_t, cols)),
        jkernels.linear_combination(spec, km, *cols))
