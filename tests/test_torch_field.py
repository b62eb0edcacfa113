"""The port's field layer against `stark_tpu.ops.modmath` on the CPU.

Inputs come from a numpy seed and go through the JAX function (its XLA
route) and the port's counterpart (the kernels' plain PyTorch versions,
since the tensors lie on the CPU). Tolerance: exact equality -- integer
field arithmetic with canonical outputs.
"""

import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch import device as devmod
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.ops import field_cuda as fc
from stark_tpu_torch.ops import modmath as mm

torch.set_num_threads(2)

N = 64
EDGE = [0, 1, 2, spec.p - 1, spec.p - 2, (spec.p - 1) // 2]


def _values(seed: int, n: int = N) -> list[int]:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(n)]
    vals[: len(EDGE)] = EDGE
    return vals


def _mont_np(vals) -> np.ndarray:
    return np.asarray(jmm.to_mont(spec, jmm.ints_to_limbs_np(vals, spec)))


def _t(arr) -> torch.Tensor:
    return planes_from_numpy(np.asarray(arr), "cpu")


def _eq(port: torch.Tensor, jax_arr) -> None:
    assert np.array_equal(planes_to_numpy(port), np.asarray(jax_arr))


def test_limb_codecs_match_jax():
    vals = _values(1)
    assert np.array_equal(mm.ints_to_limbs_np(vals, tspec), jmm.ints_to_limbs_np(vals, spec))
    limbs = jmm.ints_to_limbs_np(vals, spec)
    assert mm.limbs_to_ints_np(limbs, tspec) == vals
    by = jmm.limbs_to_bytes_le_np(limbs, spec)
    assert np.array_equal(mm.limbs_to_bytes_le_np(limbs, tspec), by)
    assert np.array_equal(mm.bytes_le_to_limbs_np(by, tspec), limbs)
    _eq(mm.bytes_le_to_limbs(tspec, torch.from_numpy(by)), limbs)


def test_mont_roundtrip_matches_jax():
    canon = jmm.ints_to_limbs_np(_values(2), spec)
    want = _mont_np(_values(2))
    got = mm.to_mont(tspec, _t(canon))
    _eq(got, want)
    _eq(mm.from_mont(tspec, got), canon)
    _eq(mm.mont_consts(tspec, _values(2), "cpu"), want)
    _eq(mm.mont_const(tspec, 12345, "cpu"), np.asarray(jmm.mont_const(spec, 12345)))


@pytest.mark.parametrize("op", ["mmul", "madd", "msub"])
def test_binary_ops_match_jax(op):
    a, b = _mont_np(_values(3)), _mont_np(_values(4)[::-1])
    want = getattr(jmm, op)(spec, a, b)
    port = {"mmul": fc.mmul_plain, "madd": mm.madd, "msub": mm.msub}[op]
    _eq(port(spec, _t(a), _t(b)), want)


@pytest.mark.parametrize("op", ["mmul", "madd", "msub"])
def test_broadcast_operands(op):
    """(L, 1) and (L, m, 1) operands broadcast as `mm.mmul` accepts them."""
    a = _mont_np(_values(5))
    c = _mont_np([7])  # (L, 1)
    want = getattr(jmm, op)(spec, a, np.broadcast_to(c, a.shape))
    _eq(getattr(mm, op)(spec, _t(a), _t(c)), want)
    a3 = a.reshape(16, 8, 8)
    c3 = np.asarray(a)[:, :8].reshape(16, 8, 1)
    want3 = getattr(jmm, op)(spec, a3, np.broadcast_to(c3, a3.shape))
    _eq(getattr(mm, op)(spec, _t(a3), _t(c3)), want3)


def test_wrapper_runs_plain_on_cpu_tensors():
    a, b = _t(_mont_np(_values(6))), _t(_mont_np(_values(7)))
    before = fc.mmul.launches
    assert torch.equal(fc.mmul(tspec, a, b), fc.mmul_plain(tspec, a, b))
    assert fc.mmul.launches == before  # the counter counts kernel launches only


def test_wrapper_rejects_bad_planes():
    a = _t(_mont_np(_values(8)))
    with pytest.raises(TypeError):
        fc.mmul(tspec, a.to(torch.int64), a.to(torch.int64))
    with pytest.raises(ValueError):
        fc.mmul(tspec, a[:, ::2], a[:, ::2])
    with pytest.raises(ValueError):
        fc.mmul(tspec, a, a[:, :32].contiguous())


@pytest.mark.parametrize("e", [0, 1, 2, 5, 2**64 + 3, spec.p - 2])
def test_mpow_matches_jax(e):
    a = _mont_np(_values(9, 8))
    _eq(mm.mpow(tspec, _t(a), e), jmm.mpow(spec, a, e))


def test_minv_matches_jax_and_inverts():
    a = _mont_np(_values(10, 8))
    inv = mm.minv(tspec, _t(a))
    _eq(inv, jmm.minv(spec, a))
    prod = mm.from_mont(tspec, fc.mmul_plain(tspec, inv, _t(a)))
    ints = mm.limbs_to_ints_np(planes_to_numpy(prod), tspec)
    assert ints == [0 if v == 0 else 1 for v in _values(10, 8)]


@pytest.mark.parametrize("n", [1, 2, 64, 1024])
@pytest.mark.parametrize("reverse", [False, True])
def test_prefix_prod_matches_jax(n, reverse):
    v = _mont_np(_values(11, max(n, 8))[:n])
    _eq(mm.prefix_prod(tspec, _t(v), reverse), jmm.prefix_prod(spec, v, reverse))


def test_multi_inv_matches_jax_with_zeros():
    v = _mont_np(_values(12))  # holds 0 (skipped, maps to 0), 1 and p-1
    _eq(mm.multi_inv(tspec, _t(v)), jmm.multi_inv(spec, v))


@pytest.mark.parametrize("n", [1, 2, 256])
def test_power_table_matches_jax(n):
    g = spec.root_of_unity(512)
    _eq(mm.power_table(tspec, g, n, "cpu"), jmm.power_table(spec, g, n))


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error path cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        devmod.resolve("cuda")
    assert devmod.resolve("cpu") == torch.device("cpu")
