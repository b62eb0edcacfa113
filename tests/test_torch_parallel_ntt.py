"""The four-step NTT, the rolls and the LDE on a mesh of d = 2 and 4 CPU
ranks (`tests/torch_mesh.py`: gloo, one process a rank).

* `ntt4.ntt_sharded_local` forward (root w) and back (root w^-1, times
  1/n) at n = 512 equals the JAX package's `ntt4.ntt_sharded_local` under
  `shard_map` on the same d devices of the 8-device CPU mesh
  (`tests/test_parallel.py:27-59`), and the back transform returns the
  input;
* `ntt4.make_tables`: each rank's d-point roots and twiddle chunk equal
  the JAX tables (its twiddles the rank's slice of `tw_global`), and the
  local DFT's root gives JAX's `w_m_half`;
* `roll_sharded` equals `torch.roll` of the whole column at shifts 0, 1,
  skips, kshift, -kshift, M and N - 1;
* `lde_local` equals the single-device `ntt.lde`.

Tolerance: exact.
"""

import functools
import random

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.parallel import ntt4 as jntt4
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.ops import ntt as nttm

import torch_mesh
from torch_mesh import tspec

torch.set_num_threads(2)

N = 512
STEPS, EXT = 64, 8  # the LDE's trace and blow-up: precision 512
SKIPS, KSHIFT = 8, 168  # a prover's shifts at this precision (original steps 63)


def _jax_ntt(d: int, x: np.ndarray, root: int, inverse: bool) -> np.ndarray:
    mesh = Mesh(np.array(jax.devices()[:d]), ("d",))
    w_d, w_m, tw = jntt4.make_tables(spec, root, N, d, inverse=inverse)
    n_inv = jmm.mont_const(spec, spec.inv(N)) if inverse else None
    body = functools.partial(jntt4.ntt_sharded_local, spec, axis_name="d", n_devices=d,
                             n_inv_mont=n_inv)
    fn = shard_map(
        lambda a, b, c, e: body(a, w_d_half=b, w_m_half=c, tw_local=e), mesh=mesh,
        in_specs=(P(None, "d"), P(None, None), P(None, None), P(None, None, "d")),
        out_specs=P(None, "d"), check_vma=False,
    )
    return np.asarray(jax.jit(fn)(jax.device_put(x, NamedSharding(mesh, P(None, "d"))),
                                  w_d, w_m, tw))


@pytest.fixture(scope="module")
def inputs():
    rng = random.Random(20261018)
    vals = jmm.to_mont(spec, jmm.ints_to_limbs_np([rng.randrange(spec.p) for _ in range(N)],
                                                    spec))
    trace = jmm.to_mont(spec, jmm.ints_to_limbs_np(
        [rng.randrange(spec.p) for _ in range(STEPS)], spec))
    return np.asarray(vals), np.asarray(trace)


@pytest.mark.parametrize("d", [2, 4])
def test_four_step_ntt_rolls_and_lde(inputs, d):
    vals, trace = inputs
    root = spec.root_of_unity(N)
    shifts = [0, 1, SKIPS, KSHIFT, -KSHIFT, N // d, N - 1]
    ranks = torch_mesh.run_procs(torch_mesh.ntt_body, d, vals, root, shifts, trace, EXT)
    whole = lambda key: np.concatenate([r[key] for r in ranks], axis=1)  # noqa: E731

    fwd = _jax_ntt(d, vals, root, inverse=False)
    assert np.array_equal(whole("fwd"), fwd)
    back = _jax_ntt(d, fwd, root, inverse=True)
    assert np.array_equal(whole("back"), back)
    assert np.array_equal(back, vals)

    j_wd, j_wm, j_tw = (np.asarray(a) for a in jntt4.make_tables(spec, root, N, d))
    m = N // d
    for rank, r in enumerate(ranks):
        assert np.array_equal(r["w_d_half"], j_wd)
        assert np.array_equal(r["tw"], j_tw[:, :, rank * (m // d) : (rank + 1) * (m // d)])
        assert np.array_equal(planes_to_numpy(mm.power_table(tspec, r["w_m"], m // 2, "cpu")),
                              j_wm)

    x = planes_from_numpy(vals, "cpu")
    for i, s in enumerate(shifts):
        got = np.concatenate([r["rolls"][i] for r in ranks], axis=1)
        assert np.array_equal(got, planes_to_numpy(torch.roll(x, s, 1))), s

    g2 = tspec.root_of_unity(STEPS * EXT)
    plan = nttm.make_lde_plan(tspec, pow(g2, EXT, tspec.p), g2, STEPS, STEPS * EXT, "cpu",
                              torch_mesh.BLOCK)
    want = nttm.lde(tspec, planes_from_numpy(trace, "cpu"), plan)
    assert np.array_equal(whole("lde"), planes_to_numpy(want))
