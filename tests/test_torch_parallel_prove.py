"""Whole proofs on a mesh of d = 2 and 4 CPU ranks (`tests/torch_mesh.py`:
gloo, one OS process a rank, as `stark_tpu`'s `tests/test_multihost.py:55`
runs its two processes).

`squaring_chain(44)` (steps 256, precision 2048) on both FRI fold routes:
every rank's proof JSON equals the single-device prover's, and the port's
verifier accepts it. Each rank's tracer records the single-device prove's
top-level phases, and its sharded stage set's `resident_bytes()` counts
the rank's chunk of the domain tables. The `compute` goldens on a mesh (Poseidon too) are
in `test_torch_parallel_goldens.py`, `prove_many(mesh=)` in
`test_torch_parallel_prove_many.py`.

Tolerance: exact (byte-identical JSON).
"""

import pytest
import torch

from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.synth import squaring_chain

import torch_mesh

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def single():
    """The single-device proof of squaring_chain(44), verified."""
    r1cs, witness = squaring_chain(44)
    proof = runner.prove_with_witness(r1cs, witness, device="cpu")
    assert runner.verify_with_witness(r1cs, witness[:2], proof, device="cpu")
    return proof_mod.to_json(proof)


@pytest.mark.parametrize("d", [2, 4])
def test_mesh_proof_equals_the_single_device_proof(single, d):
    jobs = [(44, 3, "blake2s", "dft"), (44, 3, "blake2s", "lagrange")]
    phases = ["arithmetize", "traces", "a_tree", "columns", "commits", "branches", "fri",
              "materialize"]
    chunk = 16 * 4 * 2048 // d  # one (L, precision / d) int32 table
    for proofs, names, resident in torch_mesh.run_procs(torch_mesh.chain_proofs_body, d, jobs,
                                                        bodies=len(jobs)):
        assert proofs == [single, single]
        assert names == phases
        assert resident["xs_full"] == resident["domain_tables"] == chunk
        assert resident["shoup_patterns"] > 0 and resident["ntt_plan_tables"] > 0
