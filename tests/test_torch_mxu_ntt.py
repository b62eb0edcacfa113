"""The port's four-step NTT on CRT matrix products (`ops/mxu_ntt.py`) against
`stark_tpu.ops.mxu_ntt` and against the port's own butterfly NTT, on the CPU.

* `ntt_mxu` at n = 64 and at the uneven split 128 = 16 x 8, `lde_mxu` at
  64 -> 512 and 2^11 -> 2^14, and the three-level plan at 2^12 with n1 = 4
  (as a transform and as the big transform of an LDE): each equals the JAX
  function on the same numpy-seeded Montgomery planes, and the port's
  butterfly `run` / `lde`;
* the port builds the JAX plan's tables from its own host code, and runs to
  the same values on the JAX plan's tables carried over by `interop`;
* the plan cache lives in the directory it is given (a `tmp_path` here; the
  JAX package's is pointed at another): a second build loads the file and
  gives equal tables.

Tolerance: exact equality (integer field arithmetic, canonical outputs).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.ops import mxu_ntt as jmxu
from stark_tpu_torch import interop
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.ops import mxu_ntt, ntt, plan_cache

torch.set_num_threads(2)

P = spec.p


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    """Both packages' plan caches in this test's own directories."""
    monkeypatch.setenv("STARK_TPU_PLANS_CACHE", str(tmp_path / "jax_plans"))
    monkeypatch.setattr(plan_cache, "CACHE_DIR", str(tmp_path / "plans"))
    return tmp_path / "plans"


def rand_mont(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    vals[:3] = [0, P - 1, 1]
    return np.asarray(jmm.to_mont(spec, jmm.ints_to_limbs_np(vals, spec)))


def t(a):
    return interop.planes_from_numpy(np.asarray(a), "cpu")


def bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    return np.array([int(format(i, f"0{bits}b")[::-1], 2) for i in range(n)])


def butterfly_dft(x: np.ndarray, root: int) -> np.ndarray:
    """Natural-order DFT through the port's butterfly plan (DIF leaves the
    output bit-reversed)."""
    n = x.shape[1]
    out = ntt.run(tspec, t(x), ntt.NttPlan(tspec, root, n, "dif", "cpu", block=16))
    return interop.planes_to_numpy(out)[:, bitrev(n)]


def lde_plans(steps, precision):
    g2 = spec.root_of_unity(precision)
    return pow(g2, precision // steps, P), g2


def assert_tables_equal(jplan, plan):
    for name in ("n", "n1", "n2", "nz1"):
        assert getattr(jplan, name) == getattr(plan, name)
    for jm, m in ((jplan.plan_a, plan.plan_a), (jplan.plan_b, plan.plan_b)):
        for jw, w in ((jm.W0, m.W0), (jm.W1, m.W1)):
            assert np.array_equal(np.asarray(jw.astype(jnp.float32)).astype(np.int8), w.numpy())
    assert plan.twiddle.dtype == torch.int16
    assert np.array_equal(np.asarray(jplan.twiddle).astype(np.int16), plan.twiddle.numpy())
    assert jplan.basis_a.qs_host == plan.basis_a.qs_host
    assert jplan.basis_b.qs_host == plan.basis_b.qs_host


@pytest.mark.parametrize("n,split", [(64, (None, None)), (128, (16, 8))],
                         ids=["64", "128=16x8"])
def test_ntt_mxu_matches(n, split):
    root = spec.root_of_unity(n)
    x = rand_mont(n, n)
    jplan = jmxu.MxuNttPlan(spec, root, n, n1=split[0], n2=split[1])
    plan = mxu_ntt.MxuNttPlan(tspec, root, n, "cpu", n1=split[0], n2=split[1])
    assert_tables_equal(jplan, plan)
    want = np.asarray(jmxu.ntt_mxu(jplan, jnp.asarray(x)))
    got = interop.planes_to_numpy(mxu_ntt.ntt_mxu(plan, t(x)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, butterfly_dft(x, root))


def test_ntt_mxu_on_the_jax_plans_tables():
    """The JAX plan's leaves through `interop` into the port's objects."""
    n = 64
    root = spec.root_of_unity(n)
    x = rand_mont(1, n)
    jplan = jmxu.MxuNttPlan(spec, root, n)

    def basis(jb):
        return interop.crt_basis_from_numpy(
            tspec, {k: getattr(jb, k) for k in interop._BASIS_STATIC},
            {k: np.asarray(getattr(jb, k).astype(jnp.float32)) for k in interop._BASIS_TABLES})

    def matrix(jm):
        return interop.crt_plan_from_numpy(
            *(np.asarray(w.astype(jnp.float32)) for w in (jm.W0, jm.W1)), "cpu")

    plan = interop.mxu_plan_from_numpy(
        {k: getattr(jplan, k) for k in ("n", "n1", "n2", "nz1")},
        basis(jplan.basis_a), basis(jplan.basis_b), matrix(jplan.plan_a),
        matrix(jplan.plan_b), np.asarray(jplan.twiddle), "cpu")
    want = np.asarray(jmxu.ntt_mxu(jplan, jnp.asarray(x)))
    assert np.array_equal(interop.planes_to_numpy(mxu_ntt.ntt_mxu(plan, t(x))), want)


@pytest.mark.parametrize("steps,precision", [(64, 512), (1 << 11, 1 << 14)],
                         ids=["64->512", "2^11->2^14"])
def test_lde_mxu_matches(steps, precision, caches):
    g1, g2 = lde_plans(steps, precision)
    tr = rand_mont(2, steps)
    jinv, jbig = jmxu.make_lde_plans(spec, g1, g2, steps, precision)
    want = np.asarray(jmxu.lde_mxu(jinv, jbig, jnp.asarray(tr)))
    inv, big = mxu_ntt.make_lde_plans(tspec, g1, g2, steps, precision, "cpu")
    assert_tables_equal(jinv, inv)
    assert_tables_equal(jbig, big)
    got = mxu_ntt.lde_mxu(inv, big, t(tr))
    assert np.array_equal(interop.planes_to_numpy(got), want)
    ref = ntt.lde(tspec, t(tr), ntt.make_lde_plan(tspec, g1, g2, steps, precision, "cpu"))
    assert torch.equal(got, ref)
    many = mxu_ntt.lde_mxu_many(inv, big, [t(tr), t(tr)])
    assert len(many) == 2 and torch.equal(many[1], ref)
    # the engine behind `make_best_lde`, its tables from the cache this time
    assert len(os.listdir(caches)) == 2
    best = ntt.make_best_lde(tspec, g1, g2, steps, precision, "cpu", "crt")
    assert torch.equal(best(t(tr)), ref)
    assert len(os.listdir(caches)) == 2


def test_three_level_plan_matches():
    """Outer product, mid twiddle and the batched inner four-step at
    n = 2^12 with n1 = 4 (inner 1024 = 32 x 32)."""
    n = 1 << 12
    root = spec.root_of_unity(n)
    x = rand_mont(4, n)
    want = np.asarray(jmxu.ntt_mxu3(jmxu.MxuNttPlan3(spec, root, n, n1=4), jnp.asarray(x)))
    plan = mxu_ntt.MxuNttPlan3(tspec, root, n, "cpu", n1=4)
    got = interop.planes_to_numpy(mxu_ntt.ntt_mxu3(plan, t(x)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, butterfly_dft(x, root))


def test_lde_through_the_three_level_plan():
    """The precision > 2^20 route of `lde_mxu`, built at 2^9 -> 2^12."""
    steps, precision = 1 << 9, 1 << 12
    g1, g2 = lde_plans(steps, precision)
    tr = rand_mont(6, steps)
    jinv = jmxu.make_ntt_plan_cached(spec, spec.inv(g1), steps, scale=spec.inv(steps))
    want = np.asarray(jmxu.lde_mxu(jinv, jmxu.MxuNttPlan3(spec, g2, precision, n1=4),
                                   jnp.asarray(tr)))
    inv = mxu_ntt.make_ntt_plan_cached(tspec, spec.inv(g1), steps, "cpu",
                                       scale=spec.inv(steps))
    got = mxu_ntt.lde_mxu(inv, mxu_ntt.MxuNttPlan3(tspec, g2, precision, "cpu", n1=4), t(tr))
    assert np.array_equal(interop.planes_to_numpy(got), want)
    ref = ntt.lde(tspec, t(tr), ntt.make_lde_plan(tspec, g1, g2, steps, precision, "cpu"))
    assert torch.equal(got, ref)


def test_plan_cache_lives_where_it_is_told(tmp_path, caches, monkeypatch):
    n = 256
    root = spec.root_of_unity(n)
    mine = tmp_path / "named"
    monkeypatch.setattr(plan_cache, "CACHE_DIR", str(mine))
    first = mxu_ntt.make_ntt_plan_cached(tspec, root, n, "cpu")
    files = os.listdir(mine)
    assert len(files) == 1 and files[0].endswith(".npz")
    assert not os.path.exists(caches)  # the directory set before was not touched
    again = mxu_ntt.make_ntt_plan_cached(tspec, root, n, "cpu")
    assert os.listdir(mine) == files
    for a, b in ((first.plan_a, again.plan_a), (first.plan_b, again.plan_b)):
        assert torch.equal(a.W0, b.W0) and torch.equal(a.W1, b.W1)
    assert torch.equal(first.twiddle, again.twiddle)
    assert first.basis_b.qs_host == again.basis_b.qs_host
    x = t(rand_mont(7, n))
    assert torch.equal(mxu_ntt.ntt_mxu(first, x), mxu_ntt.ntt_mxu(again, x))
    other = mxu_ntt.make_ntt_plan_cached(tspec, root, n, "cpu", scale=3)
    assert len(os.listdir(mine)) == 2  # another key, another file
    assert not torch.equal(other.plan_b.W0, first.plan_b.W0)


@pytest.mark.parametrize("damage", ["truncated", "not_a_zip", "missing_table"])
def test_damaged_plan_cache_file_is_a_miss(caches, damage):
    """A cache file damaged from outside is rebuilt, not raised on."""
    n = 64
    root = spec.root_of_unity(n)
    first = mxu_ntt.make_ntt_plan_cached(tspec, root, n, "cpu")
    (name,) = os.listdir(caches)
    path = os.path.join(caches, name)
    if damage == "truncated":
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[: len(blob) // 2])
    elif damage == "not_a_zip":
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 these are not tables")
    else:
        with np.load(path) as npz:
            kept = {k: npz[k] for k in npz.files if k != "tw"}
        np.savez(path, **kept)
    again = mxu_ntt.make_ntt_plan_cached(tspec, root, n, "cpu")
    assert torch.equal(first.twiddle, again.twiddle)
    assert torch.equal(first.plan_b.W1, again.plan_b.W1)
    with np.load(path) as npz:  # and the file is whole again
        assert set(npz.files) == set(mxu_ntt._PLAN_KEYS)


def test_engine_refuses_what_it_cannot_split():
    g1, g2 = lde_plans(2, 16)
    with pytest.raises(ValueError, match="multiple"):
        mxu_ntt.make_lde_plans(tspec, g1, g2, 2, 16, "cpu")
    with pytest.raises(ValueError, match="lde_engine"):
        ntt.make_best_lde(tspec, g1, g2, 2, 16, "cpu", "mxu")
