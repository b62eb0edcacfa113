"""The layout of a `CrtMatmulPlan`'s digit planes, on the CPU.

The plan keeps both planes in one (2, P+1, Kout, kp) int8 tensor `W` whose
rows are padded with zero columns to kp, K rounded up to `crt.K_ALIGN` =
16 bytes (`matmul_fold`'s kernel loads the rows with TMA, which needs
16-byte row strides). `W0` and `W1` are its unpadded views. Held here: the
views equal `crt.matrix_digits_np` and the JAX package's plan for
contraction lengths on either side of each 16-byte step, the padded tail is all zero,
a plan whose K is a multiple of 16 has no padding and contiguous planes,
and `from_digits` and the plan cache of `ops/mxu_ntt.py` rebuild the same
tensor. Tolerance: exact equality (integer tables).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import crt as jcrt
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.ops import crt, mxu_ntt, plan_cache

torch.set_num_threads(2)

P = spec.p


@pytest.fixture(scope="module")
def bases():
    return jcrt.CrtBasis(spec, 770), crt.CrtBasis(tspec, 770)


def _matrix(kout, k, seed):
    rng = np.random.default_rng(seed)
    w = [[int(rng.integers(0, 1 << 62)) ** 5 % P for _ in range(k)] for _ in range(kout)]
    w[0][0], w[-1][-1] = P - 1, 1
    return w


def _check_layout(plan, w0, w1):
    p1, kout, k = w0.shape
    kp = -(-k // crt.K_ALIGN) * crt.K_ALIGN
    assert (plan.kout, plan.k, plan.kp) == (kout, k, kp)
    assert plan.W.dtype == torch.int8 and plan.W.is_contiguous()
    assert tuple(plan.W.shape) == (2, p1, kout, kp)
    assert torch.equal(plan.W0, torch.from_numpy(w0))
    assert torch.equal(plan.W1, torch.from_numpy(w1))
    assert not plan.W[..., k:].any()
    assert plan.W0.data_ptr() == plan.W.data_ptr()  # views, not copies
    if k == kp:
        assert plan.W0.is_contiguous() and plan.W1.is_contiguous()


def test_padded_planes_match_digits(bases):
    _, tb = bases
    for k in (1, 6, 15, 16, 17, 33, 64):  # either side of each 16-byte step
        w = _matrix(3, k, seed=k)
        w0, w1 = crt.matrix_digits_np(tb, w)
        _check_layout(crt.CrtMatmulPlan(tb, w, "cpu"), w0, w1)
        _check_layout(crt.CrtMatmulPlan.from_digits(w0, w1, "cpu"), w0, w1)


@pytest.mark.parametrize("kout,k", [(5, 6), (4, 100), (2, 16)])
def test_padded_planes_match_jax_plan(bases, kout, k):
    jb, tb = bases
    w = _matrix(kout, k, seed=100 + k)
    jplan = jcrt.CrtMatmulPlan(jb, w)
    j0, j1 = (np.asarray(jnp.asarray(x).astype(jnp.float32)).astype(np.int8)
              for x in (jplan.W0, jplan.W1))
    _check_layout(crt.CrtMatmulPlan(tb, w, "cpu"), j0, j1)


def test_plan_cache_keeps_the_layout(tmp_path, monkeypatch):
    monkeypatch.setattr(plan_cache, "CACHE_DIR", str(tmp_path))
    n = 64
    root = tspec.root_of_unity(n)
    first = mxu_ntt.make_ntt_plan_cached(tspec, root, n, "cpu", nz1=3)
    again = mxu_ntt.make_ntt_plan_cached(tspec, root, n, "cpu", nz1=3)
    for a, b in ((first.plan_a, again.plan_a), (first.plan_b, again.plan_b)):
        assert torch.equal(a.W, b.W)
        _check_layout(b, a.W0.numpy(), a.W1.numpy())
    assert first.plan_a.k == 3 and first.plan_a.kp == crt.K_ALIGN
