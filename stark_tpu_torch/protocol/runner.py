"""Top-level prove/verify entry points over parsed circuits.

Counterpart of `stark_tpu/protocol/runner.py:43, 88, 233, 298-323`. Every
entry point takes `device=` ("cuda" by default; "cpu" runs the plain PyTorch
versions of the kernels), and the proving ones `fri_fold=` ("dft" by
default, or "lagrange": FRI's fold route, the JAX package's
`STARK_TPU_FRI_LAGRANGE`; the proof is the same on either) and
`lde_engine=` ("butterfly" by default, or "crt": the engine of the LDEs, the
JAX package's `STARK_TPU_MXU`; the proof is the same on either, and the
verifying entry points take it too). Every entry point takes `digest=`
("blake2s" by default, or "poseidon": the l-tree's and FRI's tree digest,
the reference's `H: Digest`). The proving ones take `mesh=` (a
`parallel/distributed.py DomainMesh`: the proof on d ranks, each rank's
call on its mesh's device; `stark_tpu/protocol/runner.py:43-83, 88-162`).
`verify_with_witness` keeps the 6
circuit-static public-column LDEs on the parsed circuit for its next verify
when they fit 512 MiB (`stark_tpu/protocol/runner.py:258-276`);
`verify_cache=False` keeps nothing. The prover
always derives S and P on the device from the witness; the circuit-static
arithmetization comes from the C++ host library when it builds, from the
pure-Python arithmetizer otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch import device as devmod
from stark_tpu_torch import native
from stark_tpu_torch.fields.field import BN254_FR, FieldSpec
from stark_tpu_torch.protocol.params import derive_params
from stark_tpu_torch.r1cs.arithmetize import Arithmetization, arithmetize, slot_wire_ids_np
from stark_tpu_torch.r1cs.reader import R1csContents, read_r1cs, read_witness
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol.prove import (
    enqueue_r1cs_proof,
    materialize_r1cs_proof,
    mk_r1cs_proof,
)
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


def _public_wires(spec: FieldSpec, r1cs: R1csContents, witness_bytes) -> list[int]:
    public_wires = [spec.from_bytes_le(w) for w in witness_bytes[: _n_pub(r1cs)]]
    if public_wires[0] != 1:
        raise ValueError("witness[0] must be 1")
    return public_wires


def _witness_rows(r1cs: R1csContents, witness_bytes) -> np.ndarray:
    """The witness as (n_wires, 32) uint8 little-endian rows."""
    wit_np = np.zeros((r1cs.header.n_wires, 32), np.uint8)
    for i, wb in enumerate(witness_bytes):
        wit_np[i, : len(wb[:32])] = np.frombuffer(wb[:32], np.uint8)
    return wit_np


def prove_with_witness(r1cs: R1csContents, witness_bytes: list[bytes], mesh=None,
                       digest: str = "blake2s", device="cuda", fri_fold: str = "dft",
                       lde_engine: str = "butterfly"):
    """run.rs:310-452 -> a StarkProof."""
    spec = _spec_for(r1cs)
    h = r1cs.header
    public_wires = _public_wires(spec, r1cs, witness_bytes)
    arith = _static_arith(spec, r1cs)
    arith.witness_le = _witness_rows(r1cs, witness_bytes)
    return mk_r1cs_proof(spec, arith, public_wires, h.n_constraints, h.n_wires,
                         mesh=mesh, digest=digest, device=device, fri_fold=fri_fold,
                         lde_engine=lde_engine)


def prove_many(r1cs: R1csContents, witness_bytes_list, pipeline: int = 2, mesh=None,
               digest: str = "blake2s", device="cuda", fri_fold: str = "dft",
               lde_engine: str = "butterfly") -> list:
    """Prove many witnesses of ONE circuit, for a proving service.

    The circuit is arithmetized once. Each proof is enqueued as one chain of
    device work without a host synchronise (`enqueue_r1cs_proof`), and at
    most `pipeline` chains are in flight: the oldest is materialized (one
    blocking transfer, then host formatting) only after the next has been
    enqueued, so the device works on proof i+1 while the host waits for and
    formats proof i. Each in-flight chain holds O(precision) device arrays.

    On a card the next witness is uploaded one proof ahead: from pinned
    memory, `non_blocking`, on a side stream, with an event that the proving
    stream waits on before it reads the tensor. On the CPU the same loop
    runs without streams. On a mesh (`mesh=`, a `DomainMesh` on `device`)
    nothing is uploaded ahead (`stark_tpu/protocol/runner.py:144`): each
    rank hands the prover the host rows, and every rank returns the same
    proofs. Returns the proofs in the witnesses' order.
    """
    if pipeline < 1:
        raise ValueError(f"pipeline must be at least 1, got {pipeline}")
    spec = _spec_for(r1cs)
    h = r1cs.header
    dev = devmod.resolve(device)
    arith = _static_arith(spec, r1cs)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" and mesh is None else None

    def upload(i):
        """Witness i as a tensor on the device and the event that says it has
        arrived (None on the CPU). The pinned source may go out of scope at
        once: PyTorch's host allocator holds a pinned block until the copies
        that read it are done. On a mesh: the host rows."""
        if mesh is not None:
            return _witness_rows(r1cs, witness_bytes_list[i]), None
        rows = torch.from_numpy(_witness_rows(r1cs, witness_bytes_list[i]))
        if side is None:
            return rows, None
        with torch.cuda.stream(side):
            on_dev = rows.pin_memory().to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return on_dev, ready

    proofs: list = []
    in_flight: list = []
    nxt = upload(0) if witness_bytes_list else None
    for i, witness_bytes in enumerate(witness_bytes_list):
        public_wires = _public_wires(spec, r1cs, witness_bytes)
        on_dev, ready = nxt
        if ready is not None:
            main = torch.cuda.current_stream(dev)
            main.wait_event(ready)
            on_dev.record_stream(main)  # allocated on the side stream, read here
        # `arith` is shared and `witness_le` is one slot on it: the enqueued
        # chain has put the tensor into its launches before the slot is reset
        arith.witness_le = on_dev
        in_flight.append(enqueue_r1cs_proof(
            spec, arith, public_wires, h.n_constraints, h.n_wires, mesh=mesh,
            digest=digest, device=dev, fri_fold=fri_fold, lde_engine=lde_engine))
        arith.witness_le = None
        del on_dev
        if i + 1 < len(witness_bytes_list):
            nxt = upload(i + 1)
        if len(in_flight) >= pipeline:
            proofs.append(materialize_r1cs_proof(spec, in_flight.pop(0)))
    while in_flight:
        proofs.append(materialize_r1cs_proof(spec, in_flight.pop(0)))
    return proofs


def verify_cache_fits(spec: FieldSpec, precision: int) -> bool:
    """The JAX runner's size gate: 6 (L, precision) int32 planes within 512
    MiB (402 MB at precision 2^20)."""
    return 6 * spec.num_limbs * 4 * precision <= 512 << 20


def verify_with_witness(r1cs: R1csContents, public_wires_bytes: list[bytes], proof,
                        digest: str = "blake2s", device="cuda",
                        lde_engine: str = "butterfly",
                        verify_cache: bool = True) -> bool:
    spec = _spec_for(r1cs)
    h = r1cs.header
    public_wires = [spec.from_bytes_le(w) for w in public_wires_bytes]
    if public_wires[0] != 1:
        raise ValueError("public wire 0 must be 1")
    arith = _static_arith(spec, r1cs)
    ev_cache = None
    if verify_cache and verify_cache_fits(
            spec, derive_params(spec, arith.original_steps).precision):
        ev_cache = getattr(r1cs, "_torch_ev_cache", None)
        if ev_cache is None:
            ev_cache = r1cs._torch_ev_cache = {}
    return verify_r1cs_proof(
        spec, proof, public_wires, arith.public_first_indices,
        arith.permuted_indices, arith.coefficients, arith.flag0, arith.flag1,
        arith.flag2, h.n_constraints, h.n_wires, digest=digest, device=device,
        lde_engine=lde_engine, ev_cache=ev_cache,
    )


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def prove_with_file_path(r1cs_path, witness_path, proof_json_path,
                         digest: str = "blake2s", device="cuda",
                         fri_fold: str = "dft", lde_engine: str = "butterfly") -> None:
    r1cs = read_r1cs(_read(r1cs_path))
    proof = prove_with_witness(r1cs, read_witness(_read(witness_path)),
                               digest=digest, device=device, fri_fold=fri_fold,
                               lde_engine=lde_engine)
    with open(proof_json_path, "w") as f:
        f.write(proof_mod.to_json(proof))


def verify_with_file_path(r1cs_path, witness_path, proof_json_path,
                          digest: str = "blake2s", device="cuda",
                          lde_engine: str = "butterfly") -> None:
    r1cs = read_r1cs(_read(r1cs_path))
    witness = read_witness(_read(witness_path))
    with open(proof_json_path) as f:
        proof = proof_mod.from_json(f.read())
    if not verify_with_witness(r1cs, witness[: _n_pub(r1cs)], proof,
                               digest=digest, device=device, lde_engine=lde_engine):
        raise ValueError("proof rejected")


def run_with_file_path(r1cs_path, witness_path, proof_json_path,
                       digest: str = "blake2s", device="cuda",
                       fri_fold: str = "dft", lde_engine: str = "butterfly") -> None:
    """Prove, write the JSON, verify (run.rs:590-625)."""
    prove_with_file_path(r1cs_path, witness_path, proof_json_path, digest, device,
                         fri_fold, lde_engine)
    verify_with_file_path(r1cs_path, witness_path, proof_json_path, digest, device,
                          lde_engine)
