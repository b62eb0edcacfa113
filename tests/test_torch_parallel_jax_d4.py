"""The port's sharded prover core and its CRT engine on d = 4 CPU ranks
against the JAX package's on 4 devices, in one run of the ranks:

* on `squaring_chain(5)` (steps 16, precision 128): `columns_body`'s 8
  column chunks and flags, `sharded_prover_core`'s m- and l-roots and l
  column, and each rank's Zb2^-1 and Zb3^-1 chunks (the port's batch
  inversion over the chunk) against `mm.minv` of the same chunk; a
  prover's inputs come from its `make_example_inputs`;
* the four-step NTT at n = 64 with its local DFT on the CRT engine
  (`ntt4.make_tables(lde_engine="crt")`) against the JAX body's with
  `m_plan` (`stark_tpu/parallel/ntt4.py:80-84`), and back to its input;
* `mxu_ntt.lde_mxu_sharded` at steps 64, precision 512
  (`tests/test_parallel.py:174`'s case) against the JAX package's
  `lde_mxu` on one device on the same trace, to which that test holds its
  `lde_mxu_sharded`; and the bytes each rank exchanged.

The JAX side runs as `tests/torch_mesh_jax.py` says. The d = 2 run is
`test_torch_parallel_jax_d2.py` (one d a file keeps each under a minute).

Tolerance: exact.
"""

import pytest
import torch

import torch_mesh_jax

torch.set_num_threads(2)

D = 4


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    return torch_mesh_jax.run(D, str(tmp_path_factory.mktemp("plans")))


def test_sharded_core_matches_the_jax_package(res):
    torch_mesh_jax.check_core(res)


def test_crt_local_dft_matches_the_jax_package(res):
    torch_mesh_jax.check_crt_dft(res)


def test_lde_mxu_sharded_matches_the_jax_package(res):
    torch_mesh_jax.check_lde_mxu_sharded(res, D)
