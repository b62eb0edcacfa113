"""The port's sharded prover core on d = 4 CPU ranks against the JAX
package's on 4 devices, on `squaring_chain(5)` (steps 16, precision 128):
`columns_body`'s 8 column chunks and flags, `sharded_prover_core`'s m- and
l-roots and l column, and each rank's Zb2^-1 and Zb3^-1 chunks (the port's
batch inversion over the chunk) against `mm.minv` of the same chunk. The
JAX side runs as `tests/torch_mesh_jax.py` says; a prover's inputs come
from its `make_example_inputs`. The d = 2 run is
`test_torch_parallel_jax_d2.py` (one d a file keeps each under a minute).

Tolerance: exact.
"""

import torch

import torch_mesh_jax

torch.set_num_threads(2)


def test_sharded_core_matches_the_jax_package():
    torch_mesh_jax.check_core(4)
