"""The Shoup-twiddle form of the port's NTT (`ops/ntt.py`: `shoup_stage_tables`,
`butterfly_stage_shoup_plain`, `butterfly_pass_shoup`, `butterfly_fused_shoup`,
`NttPlan(shoup=True)`, `make_lde_plan(shoup=True)`) on the CPU, where the
wrappers run their plain versions.

* `shoup_stage_tables` equals the JAX package's `_shoup_stage_tables`
  (`stark_tpu/ops/ntt.py:74-103`) word for word, on BN254's and
  BLS12-381's scalar fields.
* A stage against python ints on both fields, inputs covering 0, 1,
  R mod p, p - 1, p and 2p - 1: every output below 2p (below p with
  `canon`) and the field's butterfly modulo p.
* The plan: a Shoup plan's passes and fused run hold the stage tables as
  `pack_shoup_words`, and `run` equals the default plan's canonical output
  in DIT and agrees with it modulo p, below 2p, in DIF, with passes
  (block 16) and without, on both fields.
* The Shoup LDE equals the default LDE on both fields, at
  `tests/test_mxu_ntt.py:94`'s sizes (steps 16, precision 128) with and
  without passes, and at steps 32, precision 256; at steps 16, precision
  128 it equals the JAX package's default LDE too, to which
  `test_mxu_ntt.py::test_shoup_butterfly_lde_matches_default` holds the JAX
  Shoup LDE (its Pallas kernels in interpret mode, 61 s on one worker), so
  the port's equals that as well.
* The wrappers on CPU tensors launch nothing, and refuse a table of the
  wrong shape; a Shoup plan refuses a field of other than 16 limbs.

`test_torch_ntt_shoup_jax.py` holds the butterflies against the JAX
package's arithmetic, `test_torch_ntt_shoup_pallas.py` the fused run against the
TPU's `butterfly_fused(shoup=True)` kernel itself. Inputs come from numpy
seeds. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BLS12_381_FR as jbls
from stark_tpu.fields.field import BN254_FR as jbn
from stark_tpu.ops import modmath as jmm
from stark_tpu.ops import ntt as jntt
from stark_tpu_torch.fields.field import BLS12_381_FR, BN254_FR, F7
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.ops import ntt

torch.set_num_threads(2)

FIELDS = {"bn254": (BN254_FR, jbn), "bls12_381": (BLS12_381_FR, jbls)}


def _lazy_ints(field, seed: int, n: int) -> list[int]:
    """n values in [0, 2p), the first 0, 1, R mod p, p - 1, p and 2p - 1."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % (2 * field.p) for _ in range(n)]
    edge = [0, 1, field.r_mod_p, field.p - 1, field.p, 2 * field.p - 1]
    vals[: len(edge)] = edge[:n]
    return vals


def _raw(vals) -> torch.Tensor:
    """ints below 2^256 -> (16, n) int32 limb planes, unreduced."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return planes_from_numpy(np.frombuffer(buf, "<u2").reshape(len(vals), 16).T
                             .astype(np.uint32), "cpu")


def _ints(planes) -> list[int]:
    a = planes_to_numpy(planes).astype(np.uint64)
    return [sum(int(a[i, j]) << (16 * i) for i in range(16)) for j in range(a.shape[1])]


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_shoup_stage_tables_match_jax(name):
    field, jfield = FIELDS[name]
    n = 64
    root = field.root_of_unity(n)
    got = ntt.shoup_stage_tables(field, root, n)
    want = jntt._shoup_stage_tables(jfield, root, n)
    assert [t.shape[1] for t in got] == [1 << s for s in range(6)]
    for g, w in zip(got, want):
        assert np.array_equal(planes_to_numpy(g), np.asarray(w))


def _stage(field, seed: int, m: int, l: int):
    """A lazy (16, 2ml) plane and the (2L, l) Shoup table of an order-2l
    root's stage."""
    a = _raw(_lazy_ints(field, seed, 2 * m * l))
    tw2 = ntt.shoup_stage_tables(field, field.root_of_unity(4 * l), 4 * l)[-1][:, ::2]
    return a, tw2.contiguous()


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("kind", ["dif", "dit"])
def test_stage_against_ints(name, kind):
    field = FIELDS[name][0]
    p = field.p
    m, l = 2, 8
    for canon in (False, True):
        a, tw2 = _stage(field, 5, m, l)
        got = _ints(ntt.butterfly_stage_shoup_plain(field, a, tw2, m, l, kind, canon))
        x, w = _ints(a), _ints(tw2[:16])
        assert max(got) < (p if canon else 2 * p)
        for g in range(m):
            for k in range(l):
                u, v = x[2 * g * l + k], x[2 * g * l + l + k]
                y = ((u + v, (u - v) * w[k]) if kind == "dif"
                     else (u + v * w[k], u - v * w[k]))
                assert [got[2 * g * l + k] % p, got[2 * g * l + l + k] % p] == [
                    y[0] % p, y[1] % p]


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("block", [16, 2048])
def test_plan_runs_equal_the_default(name, block):
    field = FIELDS[name][0]
    n = 256
    root = field.root_of_unity(n)
    x = mm.mont_consts(field, _lazy_ints(field, 7, n), "cpu")
    tables = ntt.shoup_stage_tables(field, root, n)
    for kind in ("dit", "dif"):
        plain = ntt.NttPlan(field, root, n, kind, "cpu", block)
        shoup = ntt.NttPlan(field, root, n, kind, "cpu", block, shoup=True)
        assert [(l0, r) for l0, r, _ in shoup.passes] == [(l0, r) for l0, r, _ in plain.passes]
        for l0, r, tw in shoup.passes:
            assert torch.equal(ntt.unpack_shoup_words(tw), tables[(l0 << (r - 1)).bit_length() - 1])
        cut = min(n, block) - 1
        assert torch.equal(ntt.unpack_shoup_words(shoup.fused_tw),
                           torch.cat(tables, dim=1)[:, :cut])
        want = ntt.run(field, x, plain)
        got = ntt.run(field, x, shoup)
        if kind == "dit":
            assert torch.equal(got, want)
        else:
            ints = _ints(got)
            assert max(ints) < 2 * field.p
            assert [v % field.p for v in ints] == _ints(want)


@pytest.mark.parametrize("name", sorted(FIELDS))
@pytest.mark.parametrize("steps,precision,block", [(16, 128, 2048), (16, 128, 8), (32, 256, 16)])
def test_shoup_lde_equals_the_default(name, steps, precision, block):
    field = FIELDS[name][0]
    g2 = field.root_of_unity(precision)
    g1 = pow(g2, precision // steps, field.p)
    tr = mm.mont_consts(field, _lazy_ints(field, 9, steps), "cpu")
    plans = [ntt.make_lde_plan(field, g1, g2, steps, precision, "cpu", block, shoup=s)
             for s in (False, True)]
    assert torch.equal(ntt.lde(field, tr, plans[1]), ntt.lde(field, tr, plans[0]))


def test_wrappers_run_plain_on_the_cpu_and_refuse_bad_tables():
    field = BN254_FR
    n, l0, r = 64, 4, 3
    root = field.root_of_unity(n)
    a = _raw(_lazy_ints(field, 11, n))
    tables = ntt.shoup_stage_tables(field, root, n)
    tw = ntt.pack_shoup_words(tables[(l0 << (r - 1)).bit_length() - 1])
    before = (ntt.butterfly_pass_shoup.launches, ntt.butterfly_fused_shoup.launches)
    out = ntt.butterfly_pass_shoup(field, a, tw, l0, r, "dit", True)
    assert torch.equal(out, ntt.butterfly_pass_shoup_plain(field, a, tw, l0, r, "dit", True))
    fused_tw = ntt.pack_shoup_words(torch.cat(tables[:2], dim=1))
    out = ntt.butterfly_fused_shoup(field, a, fused_tw, 4, "dif")
    assert torch.equal(out, ntt.butterfly_fused_shoup_plain(field, a, fused_tw, 4, "dif"))
    assert (ntt.butterfly_pass_shoup.launches, ntt.butterfly_fused_shoup.launches) == before
    with pytest.raises(ValueError, match="Shoup twiddles"):
        ntt.butterfly_pass_shoup(field, a, tw[:, :8].contiguous(), l0, r, "dit")
    with pytest.raises(ValueError, match="Shoup twiddles"):
        ntt.butterfly_fused_shoup(field, a, fused_tw[:2].contiguous(), 4, "dit")
    with pytest.raises(ValueError, match="16-limb"):
        ntt.NttPlan(F7, 6, 2, "dit", "cpu", shoup=True)


def test_shoup_lde_equals_the_jax_lde():
    field, jfield = FIELDS["bn254"]
    p = field.p
    steps, precision = 16, 128
    g2 = field.root_of_unity(precision)
    g1 = pow(g2, precision // steps, p)
    rng = np.random.default_rng(6)
    vals = [int(rng.integers(0, 1 << 62)) ** 5 % p for _ in range(steps)]
    got = ntt.lde(field, mm.mont_consts(field, vals, "cpu"),
                  ntt.make_lde_plan(field, g1, g2, steps, precision, "cpu", shoup=True))
    jtr = jmm.to_mont(jfield, jmm.ints_to_limbs_np(vals, jfield))
    want = jntt.lde(jfield, jtr, jntt.make_lde_plan(jfield, g1, g2, steps, precision))
    assert np.array_equal(planes_to_numpy(got), np.asarray(want))
