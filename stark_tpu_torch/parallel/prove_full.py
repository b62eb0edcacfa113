"""Mesh-sharded prover entry points: the same prover as on one device.

Counterpart of `stark_tpu/parallel/prove_full.py`. `protocol/prove.py`
takes a `mesh` argument and runs one orchestration for every geometry
(`core.build_proof_stages` shards the precision domain where d > 1); these
are thin entry points over it, each rank's call on its mesh's device. Every
rank returns the same proof, byte-identical to the single-device prover's.
`prove_files_sharded` is a rank body for `distributed.run_ranks`.
"""

from __future__ import annotations

from stark_tpu_torch.fields.field import FieldSpec
from stark_tpu_torch.parallel.distributed import DomainMesh
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.protocol.proof import StarkProof
from stark_tpu_torch.protocol.prove import mk_r1cs_proof
from stark_tpu_torch.r1cs.arithmetize import Arithmetization
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness


def mk_r1cs_proof_sharded(spec: FieldSpec, arith: Arithmetization, public_wires,
                          n_constraints: int, n_wires: int, mesh: DomainMesh,
                          digest: str = "blake2s", fri_fold: str = "dft") -> StarkProof:
    """`mk_r1cs_proof` over the mesh, on this rank's device."""
    return mk_r1cs_proof(spec, arith, public_wires, n_constraints, n_wires, mesh=mesh,
                         digest=digest, device=mesh.device, fri_fold=fri_fold)


def prove_with_witness_sharded(r1cs, witness: list[bytes], mesh: DomainMesh,
                               digest: str = "blake2s", fri_fold: str = "dft") -> StarkProof:
    """`runner.prove_with_witness` over the mesh (run.rs:310-452): the same
    header checks and arithmetization, on this rank's device."""
    return runner.prove_with_witness(r1cs, witness, mesh=mesh, digest=digest,
                                     device=mesh.device, fri_fold=fri_fold)


def prove_files_sharded(mesh: DomainMesh, r1cs_path: str, witness_path: str,
                        digest: str = "blake2s", fri_fold: str = "dft") -> str:
    """Rank body for `run_ranks`: prove the circuit of a .r1cs and a .wtns
    file on the mesh; returns the proof's JSON."""
    with open(r1cs_path, "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(witness_path, "rb") as f:
        witness = read_witness(f.read())
    return proof_mod.to_json(prove_with_witness_sharded(r1cs, witness, mesh, digest, fri_fold))
