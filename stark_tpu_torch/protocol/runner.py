"""Top-level prove/verify entry points over parsed circuits.

Counterpart of `stark_tpu/protocol/runner.py:43, 233, 298-323`. Every entry
point takes `device=` ("cuda" by default; "cpu" runs the plain PyTorch
versions of the kernels). The prover always derives S and P on the device
from the witness; the circuit-static arithmetization comes from the C++
host library when it builds, from the pure-Python arithmetizer otherwise.
"""

from __future__ import annotations

import numpy as np

from stark_tpu_torch import native
from stark_tpu_torch.fields.field import BN254_FR, FieldSpec
from stark_tpu_torch.r1cs.arithmetize import Arithmetization, arithmetize, slot_wire_ids_np
from stark_tpu_torch.r1cs.reader import R1csContents, read_r1cs, read_witness
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol.prove import mk_r1cs_proof
from stark_tpu_torch.protocol.verify import verify_r1cs_proof

# the BN254/circom scalar field is the only one the reference accepts
_BN254_PRIME_LE = BN254_FR.p.to_bytes(32, "little")


def _spec_for(r1cs: R1csContents) -> FieldSpec:
    if r1cs.header.prime_number != _BN254_PRIME_LE:
        raise ValueError("only the BN254/circom scalar field is supported")
    return BN254_FR


def _n_pub(r1cs: R1csContents) -> int:
    h = r1cs.header
    return 1 + h.n_public_inputs + h.n_public_outputs


def _static_arith(spec: FieldSpec, r1cs: R1csContents) -> Arithmetization:
    """The witness-less arithmetization (K, flags, permutation, public
    indices) plus the per-slot wire ids, cached on the parsed circuit."""
    arith = getattr(r1cs, "_torch_arith_cache", None)
    if arith is not None:
        return arith
    flat = native.flat_from_contents(r1cs)
    n_pub = _n_pub(r1cs)
    if native.available():
        fa = native.arithmetize_flat(flat, None, spec.p.to_bytes(32, "little"), n_pub)
        arith = Arithmetization(
            witness_trace=None,
            computational_trace=None,
            coefficients=fa.k,
            flag0=np.ones(fa.original_steps, dtype=np.uint8),
            flag1=fa.flag1,
            flag2=fa.flag2,
            permuted_indices=fa.permuted_indices,
            public_first_indices=fa.public_first_indices,
            last_coeff_list=fa.last_coeff_list,
        )
    else:
        h = r1cs.header
        arith = arithmetize(spec, r1cs.constraints, None, h.n_wires, n_pub)
    arith.slot_wire_ids = slot_wire_ids_np(flat.ncoeffs, flat.wire_ids, flat.n_wires)
    r1cs._torch_arith_cache = arith
    return arith


def prove_with_witness(r1cs: R1csContents, witness_bytes: list[bytes], mesh=None,
                       digest: str = "blake2s", device="cuda"):
    """run.rs:310-452 -> a StarkProof."""
    spec = _spec_for(r1cs)
    h = r1cs.header
    public_wires = [spec.from_bytes_le(w) for w in witness_bytes[: _n_pub(r1cs)]]
    if public_wires[0] != 1:
        raise ValueError("witness[0] must be 1")
    arith = _static_arith(spec, r1cs)
    wit_np = np.zeros((h.n_wires, 32), np.uint8)
    for i, wb in enumerate(witness_bytes):
        wit_np[i, : len(wb[:32])] = np.frombuffer(wb[:32], np.uint8)
    arith.witness_le = wit_np
    return mk_r1cs_proof(spec, arith, public_wires, h.n_constraints, h.n_wires,
                         mesh=mesh, digest=digest, device=device)


def verify_with_witness(r1cs: R1csContents, public_wires_bytes: list[bytes], proof,
                        digest: str = "blake2s", device="cuda") -> bool:
    spec = _spec_for(r1cs)
    h = r1cs.header
    public_wires = [spec.from_bytes_le(w) for w in public_wires_bytes]
    if public_wires[0] != 1:
        raise ValueError("public wire 0 must be 1")
    arith = _static_arith(spec, r1cs)
    return verify_r1cs_proof(
        spec, proof, public_wires, arith.public_first_indices,
        arith.permuted_indices, arith.coefficients, arith.flag0, arith.flag1,
        arith.flag2, h.n_constraints, h.n_wires, digest=digest, device=device,
    )


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def prove_with_file_path(r1cs_path, witness_path, proof_json_path,
                         digest: str = "blake2s", device="cuda") -> None:
    r1cs = read_r1cs(_read(r1cs_path))
    proof = prove_with_witness(r1cs, read_witness(_read(witness_path)),
                               digest=digest, device=device)
    with open(proof_json_path, "w") as f:
        f.write(proof_mod.to_json(proof))


def verify_with_file_path(r1cs_path, witness_path, proof_json_path,
                          digest: str = "blake2s", device="cuda") -> None:
    r1cs = read_r1cs(_read(r1cs_path))
    witness = read_witness(_read(witness_path))
    with open(proof_json_path) as f:
        proof = proof_mod.from_json(f.read())
    if not verify_with_witness(r1cs, witness[: _n_pub(r1cs)], proof,
                               digest=digest, device=device):
        raise ValueError("proof rejected")


def run_with_file_path(r1cs_path, witness_path, proof_json_path,
                       digest: str = "blake2s", device="cuda") -> None:
    """Prove, write the JSON, verify (run.rs:590-625)."""
    prove_with_file_path(r1cs_path, witness_path, proof_json_path, digest, device)
    verify_with_file_path(r1cs_path, witness_path, proof_json_path, digest, device)
