"""The plain versions of the three CRT wrappers (`ops/crt_cuda.py`) against
the JAX package's Pallas kernels themselves (`stark_tpu/ops/pallas_crt.py`),
run in interpret mode on the CPU as `tests/test_crt.py` runs them
(`STARK_TPU_PALLAS=force`, `STARK_TPU_CRT_FUSED=force`): `residues_in` with
and without a pre-table, `matmul_fold`, `reconstruct`, and the three chained.
The same numpy-seeded inputs go through the port's wrappers, which on CPU
tensors run the plain PyTorch versions and launch nothing. The port's digit
planes are int8 packed four contraction rows to a word: they are unpacked
and compared with the JAX planes as integers. Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import crt as jcrt
from stark_tpu.ops import pallas_crt
from stark_tpu_torch import interop
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.ops import crt, crt_cuda

torch.set_num_threads(2)

P = spec.p
K, B, KOUT = 128, 16, 128  # K*B = 2048 = the residue kernel's lane tile


@pytest.fixture(scope="module")
def case():
    """Bases, one constant matrix as a plan of each package, limb planes
    with 0 and p - 1 among them, and a pre-table with residues q - 1."""
    jb, tb = jcrt.CrtBasis(spec, 770), crt.CrtBasis(tspec, 770)
    rng = np.random.default_rng(11)
    w = [[int(rng.integers(0, 2**63)) ** 3 % P for _ in range(K)] for _ in range(KOUT)]
    x = rng.integers(0, 1 << 16, size=(16, K, B)).astype(np.uint32)
    x[:, 0, 0] = 0
    x[:, 0, 1] = [(P - 1 >> 16 * i) & 0xFFFF for i in range(16)]
    qs = np.asarray(jb.qs_host)[:, None, None]
    pre = rng.integers(0, qs, size=(len(jb.qs_host), K, B)).astype(np.uint32)
    pre[:, 1, 0] = qs[:, 0, 0] - 1
    return jb, tb, jcrt.CrtMatmulPlan(jb, w), crt.CrtMatmulPlan(tb, w, "cpu"), x, pre


@pytest.fixture(autouse=True)
def forced_pallas(monkeypatch):
    monkeypatch.setenv("STARK_TPU_PALLAS", "force")
    monkeypatch.setenv("STARK_TPU_CRT_FUSED", "force")


def no_launch(wrapper, *args):
    before = wrapper.launches
    out = wrapper(*args)
    assert wrapper.launches == before
    return out


def jax_digits(jb, x, pre):
    p1 = len(jb.qs_host)
    x0, x1 = pallas_crt.residues_in(
        jb, jnp.asarray(x.reshape(16, K * B)),
        None if pre is None else jnp.asarray(pre.reshape(p1, K * B)))
    return x0.reshape(p1, K, B), x1.reshape(p1, K, B)


def port_digits(tb, x, pre):
    return no_launch(
        crt_cuda.residues_in, tb, interop.planes_from_numpy(x, "cpu"),
        None if pre is None else torch.from_numpy(pre.astype(np.int16)))


@pytest.mark.parametrize("with_pre", [False, True], ids=["plain", "pre"])
def test_residues_in_matches_pallas(case, with_pre):
    jb, tb, _, _, x, pre = case
    pre = pre if with_pre else None
    want = jax_digits(jb, x, pre)
    got = port_digits(tb, x, pre)
    for g, w in zip(got, want):
        assert g.shape == (len(tb.qs_host), K // 4, B) and g.dtype == torch.int32
        digits = crt.unpack_k4(g, K).numpy()
        assert digits.min() >= 0  # unsigned 7-bit digits in int8
        assert np.array_equal(digits.astype(np.int64),
                              np.asarray(w.astype(jnp.float32)).astype(np.int64))


def test_matmul_fold_matches_pallas(case):
    jb, tb, jplan, tplan, x, pre = case
    jx0, jx1 = jax_digits(jb, x, pre)
    want = np.asarray(pallas_crt.matmul_fold(jb, jplan, jx0, jx1))
    x0, x1 = port_digits(tb, x, pre)
    got = no_launch(crt_cuda.matmul_fold, tb, tplan, x0, x1)
    assert got.shape == (len(tb.qs_host), KOUT, B)
    assert np.array_equal(interop.planes_to_numpy(got), want)
    assert (want < np.asarray(jb.qs_host)[:, None, None]).all()  # canonical residues


def test_reconstruct_matches_pallas(case):
    jb, tb = case[0], case[1]
    rng = np.random.default_rng(12)
    s = rng.integers(0, 15300, (jb.P + 1, pallas_crt.TILE)).astype(np.uint32)
    s[:, 0] = 0
    s[:, 1] = np.asarray(jb.qs_host) - 1
    want = np.asarray(pallas_crt.reconstruct(jb, jnp.asarray(s)))
    got = no_launch(crt_cuda.reconstruct, tb, interop.planes_from_numpy(s, "cpu"))
    assert np.array_equal(interop.planes_to_numpy(got), want)


@pytest.mark.parametrize("with_pre", [False, True], ids=["plain", "pre"])
def test_crt_matmul_matches_fused_pipeline(case, with_pre):
    """The three Pallas kernels chained (`crt_matmul_fused`) against the
    port's `crt_matmul`, which chains the three wrappers."""
    jb, tb, jplan, tplan, x, pre = case
    pre = pre if with_pre else None
    want = np.asarray(pallas_crt.crt_matmul_fused(
        jb, jplan, jnp.asarray(x), None if pre is None else jnp.asarray(pre)))
    got = crt.crt_matmul(tb, tplan, interop.planes_from_numpy(x, "cpu"),
                         None if pre is None else torch.from_numpy(pre.astype(np.int16)))
    assert np.array_equal(interop.planes_to_numpy(got), want)
