"""`runner.prove_many(mesh=)` on a mesh of d = 2 CPU ranks
(`tests/torch_mesh.py`: gloo, one OS process a rank) over three witnesses
of `squaring_chain(5)` at pipeline depth 2: every rank's proofs equal
single proves on one device, in order.

Tolerance: exact (byte-identical JSON).
"""

import torch

from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.synth import squaring_chain

import torch_mesh

torch.set_num_threads(2)

X0S = (3, 5, 7)


def test_prove_many_on_a_mesh_equals_single_proves():
    singles = [proof_mod.to_json(runner.prove_with_witness(*squaring_chain(5, x0=x0),
                                                           device="cpu")) for x0 in X0S]
    assert len(set(singles)) == 3
    for proofs in torch_mesh.run_procs(torch_mesh.prove_many_body, 2, 5, X0S, 2,
                                       bodies=len(X0S)):
        assert proofs == singles
