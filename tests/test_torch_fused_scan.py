"""The plain version of the port's prefix-product scan against the JAX
package's Pallas kernel itself, run in interpret mode on the CPU, and what
the two field wrappers refuse.

`pallas_field.scan_prod` is called directly at a tiny width: (16, 8, 8) and
two ragged shapes. The same numpy-seeded inputs go through the port's wrapper, which on a CPU
tensor runs the plain PyTorch version. Tolerance: exact equality of the
uint32 values (integer field arithmetic with canonical outputs). Interpret
mode takes seconds per kernel, so the thirteen kernels are spread over
`test_torch_fused.py`, `test_torch_fused_loops.py`, `test_torch_fused_scan.py`,
`test_torch_fused_lincomb.py` and `test_torch_fused_shoup.py`, each under a
minute on one worker.
"""

import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import pallas_field as jpf
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.ops import field_cuda as fc
from torch_fused_inputs import cols as _cols, eq as _eq, no_launch as _no_launch, t as _t

torch.set_num_threads(2)


def test_scan_prod_matches_pallas():
    (x,) = _cols(14, width=64, edge=True)
    x3 = x.reshape(16, 8, 8)
    _eq(_no_launch(fc.scan_prod, _t(x3)), jpf.scan_prod(spec, x3))


@pytest.mark.parametrize("shape", [(5, 3), (1, 7)])
def test_scan_prod_ragged_shapes_match_pallas(shape):
    """B need not be a multiple of 8 and C need not be a lane multiple."""
    B, C = shape
    (x,) = _cols(15, width=B * C)
    x3 = x.reshape(16, B, C)
    _eq(fc.scan_prod(tspec, _t(x3)), jpf.scan_prod(spec, x3))


def test_field_wrappers_refuse_bad_operands():
    (x,) = _cols(20, width=64)
    x3 = _t(x.reshape(16, 8, 8))
    with pytest.raises(ValueError):
        fc.scan_prod(tspec, x3.transpose(1, 2))  # a view
    with pytest.raises(ValueError):
        fc.scan_prod(tspec, _t(x))  # not (16, B, C)
    with pytest.raises(ValueError):
        fc.mpow_scalar(tspec, _t(x), 3)  # 64 lanes
    with pytest.raises(ValueError):
        fc.mpow_scalar(tspec, _t(x)[:, :4].contiguous(), 1 << 256)
    with pytest.raises(ValueError):
        fc.mpow_scalar(tspec, _t(x)[:, :4], 3)  # a view
