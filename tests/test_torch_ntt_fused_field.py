"""Which fields `ops/ntt.butterfly_fused` takes on the card, on the CPU.

The CUDA kernel's lazy butterflies keep values below 4p and its products'
running sums below (a + p) 2^32, so it serves fields with 5p < 2^256 only.
The wrapper refuses any other field with a `ValueError` before it reaches
the card; tensors on the `meta` device take the wrapper's non-CPU route
without one. A CPU tensor runs the plain version for every field, held
here against the stage-by-stage plain route. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch.fields.field import BLS12_381_FR, BN254_FR
from stark_tpu_torch.ops import ntt

torch.set_num_threads(2)

BLOCK = 8


def _planes(spec, n, device):
    return torch.zeros((spec.num_limbs, n), dtype=torch.int32, device=device)


def test_card_refuses_field_without_lazy_headroom():
    assert 5 * BLS12_381_FR.p >= 1 << 256
    a, tw = _planes(BLS12_381_FR, 16, "meta"), _planes(BLS12_381_FR, BLOCK - 1, "meta")
    with pytest.raises(ValueError, match=r"5p < 2\^256"):
        ntt.butterfly_fused(BLS12_381_FR, a, tw, BLOCK, "dit")


def test_card_route_takes_bn254():
    assert 5 * BN254_FR.p < 1 << 256
    a, tw = _planes(BN254_FR, 16, "meta"), _planes(BN254_FR, BLOCK - 1, "meta")
    # past the field check, the meta device has no kernel
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ntt.butterfly_fused(BN254_FR, a, tw, BLOCK, "dif")


@pytest.mark.parametrize("kind", ["dit", "dif"])
def test_cpu_route_serves_bls12_381(kind):
    spec = BLS12_381_FR
    n = 32
    plan = ntt.NttPlan(spec, spec.root_of_unity(n), n, kind, "cpu", block=BLOCK)
    rng = np.random.default_rng(7)
    vals = [int(v) ** 5 % spec.p for v in rng.integers(0, 1 << 62, n)]
    a = torch.tensor([[(v >> (16 * i)) & 0xFFFF for v in vals]
                      for i in range(spec.num_limbs)], dtype=torch.int32)
    got = ntt.butterfly_fused(spec, a, plan.fused_tw, BLOCK, kind)
    want = a
    for l in ntt.fused_ls(BLOCK, kind):
        want = ntt.butterfly_stage(spec, want, plan.fused_tw[:, l - 1 : 2 * l - 1].contiguous(),
                                   n // (2 * l), l, kind)
    assert torch.equal(got, want)
