"""Which fields `ops/ntt.butterfly_fused` takes on the card, on the CPU.

The CUDA kernel has two builds of the fused pass, and the field picks one
(`ntt.fused_lazy`): Harvey's lazy butterflies (values below 4p, products'
running sums below (a + p) 2^32) for fields with 5p < 2^256, as BN254's
scalar field; the canonical build (every value below p) for the others, as
BLS12-381's. A field with 2p >= 2^256 reaches no kernel of the port
(`field_cuda.cuda_args`). Tensors on the `meta` device take the wrapper's
non-CPU route past the field checks and stop at "no kernel for device meta".
A CPU tensor runs the plain version for every field, held here against the
stage-by-stage plain route and against the JAX package's Pallas kernel
(`stark_tpu.ops.pallas_field.butterfly_fused`, interpret mode) on BLS12-381.
Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BLS12_381_FR as jspec
from stark_tpu.ops import pallas_field as jpf
from stark_tpu_torch.fields.field import BLS12_381_FR, BN254_FR, FieldSpec
from stark_tpu_torch.interop import planes_to_numpy
from stark_tpu_torch.ops import ntt

torch.set_num_threads(2)

BLOCK = 8
N = 32


def _planes(spec, n, device):
    return torch.zeros((spec.num_limbs, n), dtype=torch.int32, device=device)


def test_field_picks_the_build():
    assert ntt.fused_lazy(BN254_FR) and 5 * BN254_FR.p < 1 << 256
    assert not ntt.fused_lazy(BLS12_381_FR)
    assert 4 * BLS12_381_FR.p > 1 << 256 > 2 * BLS12_381_FR.p


@pytest.mark.parametrize("spec", [BLS12_381_FR, BN254_FR], ids=["bls12_381", "bn254"])
def test_card_route_takes_field(spec):
    a, tw = _planes(spec, 16, "meta"), _planes(spec, BLOCK - 1, "meta")
    # past the field checks, the meta device has no kernel
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ntt.butterfly_fused(spec, a, tw, BLOCK, "dit")


def test_card_route_refuses_field_without_headroom():
    wide = FieldSpec(name="p256", p=(1 << 256) - 189, generator=2, repr_bytes=32)
    assert wide.num_limbs == 16
    a, tw = _planes(wide, 16, "meta"), _planes(wide, BLOCK - 1, "meta")
    with pytest.raises(ValueError, match=r"2p < 2\^256"):
        ntt.butterfly_fused(wide, a, tw, BLOCK, "dif")


def _bls_case(kind):
    spec = BLS12_381_FR
    plan = ntt.NttPlan(spec, spec.root_of_unity(N), N, kind, "cpu", block=BLOCK)
    rng = np.random.default_rng(7)
    vals = [int(v) ** 5 % spec.p for v in rng.integers(0, 1 << 62, N)]
    vals[:3] = [0, 1, spec.p - 1]
    a = torch.tensor([[(v >> (16 * i)) & 0xFFFF for v in vals]
                      for i in range(spec.num_limbs)], dtype=torch.int32)
    return spec, plan, a


@pytest.mark.parametrize("kind", ["dit", "dif"])
def test_cpu_route_serves_bls12_381(kind):
    spec, plan, a = _bls_case(kind)
    got = ntt.butterfly_fused(spec, a, plan.fused_tw, BLOCK, kind)
    want = a
    for l in ntt.fused_ls(BLOCK, kind):
        want = ntt.butterfly_stage(spec, want, plan.fused_tw[:, l - 1 : 2 * l - 1].contiguous(),
                                   N // (2 * l), l, kind)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["dit", "dif"])
def test_bls12_381_matches_pallas(kind):
    """The port's `fused_tw` (stage l at columns l-1 .. 2l-2) becomes the
    JAX kernel's `stage_ls` (execution order) and period-2l `tw_rows`."""
    spec, plan, a = _bls_case(kind)
    got = ntt.butterfly_fused(spec, a, plan.fused_tw, BLOCK, kind)
    cat = planes_to_numpy(plan.fused_tw)
    ls = ntt.fused_ls(BLOCK, kind)
    rows = jpf.make_fused_rows(jspec, ls, [cat[:, l - 1 : 2 * l - 1] for l in ls], BLOCK)
    want = jpf.butterfly_fused(jspec, planes_to_numpy(a), rows, ls, BLOCK, kind)
    assert np.array_equal(planes_to_numpy(got), np.asarray(want))
