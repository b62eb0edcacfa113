"""The Shoup-twiddle form of the port's NTT against the JAX package's, on the
CPU, without an interpret-mode Pallas run.

* A stage's butterflies (`ops/ntt.py butterfly_stage_shoup_plain`) equal
  the TPU kernels' arithmetic, `stark_tpu/ops/pallas_field.py:407
  _butterfly_pair_shoup` run eagerly on the same rows, value for value
  (lazy values in [0, 2p) included), on BN254, both kinds, with and
  without `canon`; inputs cover 0, 1, R mod p, p - 1, p and 2p - 1.
* On BLS12-381 (4p > 2^256) the TPU's lazy sum drops its carry out of bit
  256 and leaves a wrong value; the port's keeps it (`ops/ntt.py`'s
  docstring, ROADMAP Queue 3).

The LDE against the JAX package's is in `test_torch_ntt_shoup.py`.

Inputs come from numpy seeds. Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.ops import pallas_field as pf
from stark_tpu_torch.interop import planes_to_numpy
from stark_tpu_torch.ops import ntt
from test_torch_ntt_shoup import FIELDS, _ints, _raw, _stage

torch.set_num_threads(2)

M, LW = 4, 8  # a stage's groups and width: 32 butterflies


def _rows(x):
    return [jnp.asarray(x[i].reshape(-1)) for i in range(x.shape[0])]


def _tpu_stage(jfield, a, tw2, kind: str, canon: bool) -> np.ndarray:
    """`_butterfly_pair_shoup` over the stage (M, 2, LW) of `a`."""
    v4 = planes_to_numpy(a).reshape(16, M, 2, LW)
    tw = np.broadcast_to(planes_to_numpy(tw2).reshape(32, 1, LW), (32, M, LW))
    y0, y1 = pf._butterfly_pair_shoup(jfield, kind, _rows(v4[:, :, 0]), _rows(v4[:, :, 1]),
                                      _rows(tw[:16]), _rows(tw[16:]), canon)
    return np.stack([np.stack([np.asarray(r) for r in y]).reshape(16, M, LW)
                     for y in (y0, y1)], axis=2).reshape(16, -1)


@pytest.mark.parametrize("kind", ["dif", "dit"])
@pytest.mark.parametrize("canon", [False, True])
def test_stage_equals_the_tpu_butterfly(kind, canon):
    field, jfield = FIELDS["bn254"]
    a, tw2 = _stage(field, 3 + canon, M, LW)
    got = planes_to_numpy(ntt.butterfly_stage_shoup_plain(field, a, tw2, M, LW, kind, canon))
    assert np.array_equal(got, _tpu_stage(jfield, a, tw2, kind, canon))


def test_bls12_381_lazy_sum_keeps_its_carry():
    field, jfield = FIELDS["bls12_381"]
    p = field.p
    assert 4 * p > 1 << 256 > 2 * p
    a, tw2 = _stage(field, 13, M, LW)
    u, v = 2 * p - 1, 2 * p - 2  # u + v > 2^256: the first butterfly's pair
    vals = _ints(a)
    vals[0], vals[LW] = u, v
    a = _raw(vals)
    got = _ints(ntt.butterfly_stage_shoup_plain(field, a, tw2, M, LW, "dif"))
    assert got[0] == (u + v) % (2 * p)
    jy0 = _ints(torch.from_numpy(_tpu_stage(jfield, a, tw2, "dif", False).view(np.int32)))[0]
    assert jy0 % p != (u + v) % p  # the TPU arithmetic's dropped carry
