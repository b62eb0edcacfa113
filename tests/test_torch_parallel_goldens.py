"""The `compute` goldens on a mesh of CPU ranks (`tests/torch_mesh.py`:
gloo, one OS process a rank).

* the `compute` fixture, proved from its files by
  `prove_full.prove_files_sharded` on `distributed.run_ranks` (OS
  processes, as the JAX package's `tests/test_multihost.py:55` runs its
  two) at d = 2 on the `dft` fold and d = 4 on `lagrange`: every rank's proof equals the
  committed golden (`compute_proof_golden.json`);
* the same at d = 2 under digest="poseidon" (the l-tree sharded on the
  Poseidon pair, FRI's trees replicated): every rank's proof equals the
  committed golden (`compute_proof_poseidon_golden.json`).

`prove_many(mesh=)` is in `test_torch_parallel_prove_many.py`.

Tolerance: exact (byte-identical JSON).
"""

import os

import pytest
import torch

from stark_tpu_torch.parallel import prove_full

import torch_mesh

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.mark.parametrize("d,fri_fold,digest,golden", [
    (2, "dft", "blake2s", "compute_proof_golden.json"),
    (4, "lagrange", "blake2s", "compute_proof_golden.json"),
    (2, "dft", "poseidon", "compute_proof_poseidon_golden.json"),
])
def test_ranks_prove_the_compute_golden_from_files(d, fri_fold, digest, golden):
    with open(os.path.join(FIX, golden)) as f:
        want = f.read()
    proofs = torch_mesh.run_procs(prove_full.prove_files_sharded, d,
                                  os.path.join(FIX, "compute.r1cs"),
                                  os.path.join(FIX, "compute.wtns"), digest, fri_fold)
    assert proofs == [want] * d
