"""The port's protocol layer against the JAX package on the CPU.

* each `protocol/kernels.py` function against its JAX counterpart (the
  composed XLA branch, which the JAX package runs on the CPU);
* the device transcript against the host transcript
  (`stark_tpu/protocol/transcript.py`);
* the prover stages `wit_traces`, `a_root`, `r`, `acc`, `columns` (LDEs,
  `rest_a`), `commit_chain` and `pos_gather` against JAX
  `build_proof_stages` on the `compute` fixture, each stage fed the JAX
  stage's own inputs, carried across by `interop`
  (`torch_stage_check.py`; the ragged circuit is in
  `test_torch_protocol_ragged.py`, to keep each file's compile time short).

Inputs come from a numpy seed or the fixtures. Tolerance: exact equality
(integer field arithmetic with canonical outputs; the JAX package's Shoup
kernels are off on the CPU, the port's stages take Z^-1 and x^steps as Shoup
pattern pairs and run the plain versions of their kernels).
"""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.protocol import device_transcript as jdt
from stark_tpu.protocol import kernels as jk
from stark_tpu.protocol import transcript as ts
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import device_transcript as dt
from stark_tpu_torch.protocol import kernels as k
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness
from torch_stage_check import check_stages_match_jax

torch.set_num_threads(2)

N = 64
FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _cols(seed: int, width: int = N, count: int = 1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        vals = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(width)]
        out.append(np.asarray(jmm.to_mont(spec, jmm.ints_to_limbs_np(vals, spec))))
    return out


def _t(a):
    return planes_from_numpy(np.asarray(a), "cpu")


def _eq(port, jax_arr):
    assert np.array_equal(planes_to_numpy(port), np.asarray(jax_arr))


# --- protocol/kernels.py ----------------------------------------------------


def test_rand_combination_and_accumulator():
    (r,) = _cols(2, width=3)  # (L, 3) randomness columns
    idx, perm, s = _cols(3, count=3)
    jn, jd = jk.rand_combination(spec, r, idx, perm, s)
    tn, td = k.rand_combination(tspec, _t(r), _t(idx), _t(perm), _t(s))
    _eq(tn, jn)
    _eq(td, jd)
    _eq(k.accumulator_mini(tspec, tn, td), jk.accumulator_mini(spec, jn, jd))


@pytest.mark.parametrize("skips", [1, 8])
def test_quotients(skips):
    s, kk, p, f0, f1, f2, a, vn, vd = _cols(4, count=9)
    _eq(k.q1_eval(tspec, _t(s), _t(kk), _t(p), _t(f0), _t(f1), skips),
        jk.q1_eval(spec, s, kk, p, f0, f1, skips))
    _eq(k.q2_eval(tspec, _t(p), _t(f2), 3 * skips), jk.q2_eval(spec, p, f2, 3 * skips))
    _eq(k.q3_eval(tspec, _t(a), _t(vn), _t(vd), skips), jk.q3_eval(spec, a, vn, vd, skips))


def test_horner_vanishing_sub_mul_periodic():
    xs, a, b, c, table = _cols(5, count=5)
    (coeffs,) = _cols(6, width=5)
    (pts,) = _cols(7, width=3)
    _eq(k.horner_eval(tspec, _t(coeffs), _t(xs)), jk.horner_eval(spec, coeffs, xs))
    _eq(k.vanishing_eval(tspec, _t(xs), _t(pts)), jk.vanishing_eval(spec, xs, pts))
    _eq(k.sub_mul_ev(tspec, _t(a), _t(b), _t(c)), jk.sub_mul_ev(spec, a, b, c))
    _eq(k.mmul_periodic_const(tspec, _t(a), _t(table)),
        jk.mmul_periodic_const(spec, a, table))


def test_linear_combination():
    (km,) = _cols(8, width=11)
    x2s, p, a, s, d1, d2, d3, b2, b3 = _cols(9, count=9)
    args = (p, a, s, d1, d2, d3, b2, b3)
    _eq(k.linear_combination(tspec, _t(km), _t(x2s), *map(_t, args)),
        jk.linear_combination(spec, km, x2s, *args))


# --- device transcript --------------------------------------------------------

SEEDS = [hashlib.blake2s(bytes([i])).digest() for i in range(3)]


def _words(seed: bytes) -> torch.Tensor:
    return planes_from_numpy(np.frombuffer(seed, "<u4"), "cpu")


def _ints(mont) -> list[int]:
    return mm.limbs_to_ints_np(planes_to_numpy(mm.from_mont(tspec, mont)), tspec)


@pytest.mark.parametrize("seed", SEEDS, ids=range(len(SEEDS)))
def test_transcript_matches_host(seed):
    for modulus, count, excl in [(2048, 80, 8), (65536, 40, 8), (7, 5, 0), (2**20, 24, 0)]:
        got = dt.pseudorandom_indices(_words(seed), modulus, count, excl).tolist()
        assert got == ts.get_pseudorandom_indices(seed, modulus, count, excl)
    assert _ints(dt.random_ff_mont(tspec, _words(seed), 2**20, 3)) == \
        ts.get_random_ff_values(spec, seed, 2**20, 3)
    assert _ints(dt.k_coeffs_mont(tspec, _words(seed))) == [1] + [
        ts.seed_to_field(spec, [seed, bytes([i])]) for i in range(1, 11)
    ]
    assert _ints(dt.digest_le_int_mont(tspec, _words(seed))) == [spec.from_bytes_le(seed)]
    jw = jnp.asarray(np.frombuffer(seed, "<u4").copy())
    _eq(dt.digest_be_int_mont(tspec, _words(seed)), jdt.digest_be_int_mont(spec, jw))


# --- prover stages ------------------------------------------------------------


def test_stages_match_jax_compute():
    with open(os.path.join(FIX, "compute.r1cs"), "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(os.path.join(FIX, "compute.wtns"), "rb") as f:
        witness = read_witness(f.read())
    check_stages_match_jax(r1cs, witness)
