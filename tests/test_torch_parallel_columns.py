"""The sharded columns on a mesh of d = 2 and 4 CPU ranks
(`tests/torch_mesh.py`: gloo, one process a rank):
`prove_sharded.columns_body` on `squaring_chain(44)` (steps 256, precision
2048): the ranks' chunks of the 8 m-tree columns, the divisibility flags
and the Zb2^-1 chunks equal the single-device `columns` stage and
`inv_zb2` table of `core.build_proof_stages` on the same inputs (the JAX
package's `make_example_inputs`). The JAX package's sharded body is held
against the port in `test_torch_parallel_jax_d*.py`, the sharded trees in
`test_torch_parallel_tree.py`.

Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.protocol.core import build_proof_stages

import torch_mesh
import torch_mesh_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def chain44():
    return torch_mesh_jax.example(44)


@pytest.fixture(scope="module")
def single(chain44):
    (steps, precision, original_steps), (traces, r, _, i2, pubx) = chain44
    T = build_proof_stages(tspec, steps, precision, original_steps, "blake2s", "cpu",
                           block=torch_mesh.BLOCK)
    pl = lambda a: planes_from_numpy(a, "cpu")  # noqa: E731
    inv_zb2 = T["inv_zb2"](pl(pubx))
    cols, bad = T["columns"]({k: pl(v) for k, v in traces.items()}, pl(r), pl(i2), inv_zb2)
    return {k: planes_to_numpy(v) for k, v in cols.items()}, bad.numpy(), planes_to_numpy(
        inv_zb2)


@pytest.mark.parametrize("d", [2, 4])
def test_columns_body_matches_the_single_device_stage(chain44, single, d):
    shape, (traces, r, _, i2, pubx) = chain44
    ranks = torch_mesh.run_procs(torch_mesh.columns_body, d, shape, traces, r, i2, pubx)
    cols, bad, inv_zb2 = single
    for name, want in cols.items():
        assert np.array_equal(np.concatenate([rk[0][name] for rk in ranks], axis=1), want), name
    for rk in ranks:
        assert np.array_equal(rk[1], bad) and not bad.any()
    assert np.array_equal(np.concatenate([rk[2] for rk in ranks], axis=1), inv_zb2)
