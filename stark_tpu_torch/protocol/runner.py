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

The file-path entry points take the native route where the host library
has built (`read_circuit`, `read_witness_rows`): the C++ readers hand
`prove_with_rows` the flat circuit (`native.FlatR1cs`) and the witness as
(n_wires, 32) rows, as `stark_tpu/protocol/runner.py:215-230, 298-342`
does, and the verifying ones arithmetize that flat circuit too. Without the
library they take the Python route (`read_r1cs`, `read_witness`). The
proof and the verdict do not depend on how the files were parsed, under
either digest. Both routes refuse the same files, each with `ValueError`:
a bad magic, version or section layout, a file that ends early, a field
size other than 32 bytes, a prime other than BN254's, a wire id past the
circuit's wires (the C++ arithmetizer's code 11, checked ahead of the
pure-Python arithmetizer by `_check_wire_ids`), a witness with another
wire count than the circuit's or whose wire 0 is not 1; all before any
device work.

Each entry point and route opens the tracer's phases (`utils/tracing.py`)
that the JAX package's same entry and route opens, in its order: a prove
`arithmetize` (`parse+arithmetize` on the native file route under
blake2s), then the prover's seven; a verify `v_arithmetize`, then the
verifier's three; `prove_many` only the prover's.
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
from stark_tpu_torch.utils.tracing import phase

# the BN254/circom scalar field is the only one the reference accepts
_BN254_PRIME_LE = BN254_FR.p.to_bytes(32, "little")


def _header(circuit):
    """The header fields of a parsed circuit: `R1csContents.header`, or the
    `native.FlatR1cs` itself, which carries the same names."""
    return getattr(circuit, "header", circuit)


def _spec_for(circuit) -> FieldSpec:
    h = _header(circuit)
    if h.field_size != 32 or h.prime_number != _BN254_PRIME_LE:
        raise ValueError("only the BN254/circom scalar field is supported")
    return BN254_FR


def _n_pub(circuit) -> int:
    h = _header(circuit)
    return 1 + h.n_public_inputs + h.n_public_outputs


def _flat_arith(spec: FieldSpec, flat: native.FlatR1cs, constraints=None) -> Arithmetization:
    """The witness-less arithmetization (K, flags, permutation, public
    indices) plus the per-slot wire ids of a flat circuit: through the C++
    arithmetizer where the host library has built, else through the
    pure-Python one over `constraints`, the parsed tree's (a flat circuit
    read from a file exists only where the library has built)."""
    n_pub = _n_pub(flat)
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
        _check_wire_ids(flat)
        arith = arithmetize(spec, constraints, None, flat.n_wires, n_pub)
    arith.slot_wire_ids = slot_wire_ids_np(flat.ncoeffs, flat.wire_ids, flat.n_wires)
    return arith


def _static_arith(spec: FieldSpec, circuit) -> Arithmetization:
    """`_flat_arith` of a parsed circuit (`R1csContents`) or a flat one
    (`native.FlatR1cs`), cached on that object."""
    arith = getattr(circuit, "_torch_arith_cache", None)
    if arith is None:
        if isinstance(circuit, native.FlatR1cs):
            arith = _flat_arith(spec, circuit)
        else:
            arith = _flat_arith(spec, native.flat_from_contents(circuit), circuit.constraints)
        circuit._torch_arith_cache = arith
    return arith


def _public_wires(spec: FieldSpec, circuit, witness) -> list[int]:
    """The public wires from the first entries of `witness`: LE byte strings
    or (n_wires, 32) uint8 rows."""
    public_wires = [spec.from_bytes_le(bytes(w)) for w in witness[: _n_pub(circuit)]]
    if public_wires[0] != 1:
        raise ValueError("witness[0] must be 1")
    return public_wires


def _check_wire_count(circuit, n_witness: int) -> None:
    n_wires = _header(circuit).n_wires
    if n_witness != n_wires:
        raise ValueError(f"the witness has {n_witness} wires, the circuit {n_wires}")


def _check_wire_ids(flat: native.FlatR1cs) -> None:
    """Every wire id of the circuit below its wire count: what the C++
    arithmetizer refuses with its code 11, and what the pure-Python one
    would index past its wire table on."""
    if flat.wire_ids.size and int(flat.wire_ids.max()) >= flat.n_wires:
        raise ValueError(f"the circuit names wire {int(flat.wire_ids.max())}, past its "
                         f"{flat.n_wires} wires")


def _witness_rows(circuit, witness_bytes) -> np.ndarray:
    """The witness as (n_wires, 32) uint8 little-endian rows."""
    _check_wire_count(circuit, len(witness_bytes))
    wit_np = np.zeros((len(witness_bytes), 32), np.uint8)
    for i, wb in enumerate(witness_bytes):
        wit_np[i, : len(wb[:32])] = np.frombuffer(wb[:32], np.uint8)
    return wit_np


def _rows_inputs(circuit, rows: np.ndarray):
    """The prover's inputs from the witness rows: the checks of the prime,
    the wire count and wire 0, the public wires, and the circuit-static
    arithmetization with the rows as its witness."""
    spec = _spec_for(circuit)
    _check_wire_count(circuit, rows.shape[0])
    public_wires = _public_wires(spec, circuit, rows)
    arith = _static_arith(spec, circuit)
    arith.witness_le = rows
    return spec, public_wires, arith


def _prove_inputs(circuit, inputs, mesh, digest, device, fri_fold, lde_engine):
    spec, public_wires, arith = inputs
    h = _header(circuit)
    return mk_r1cs_proof(spec, arith, public_wires, h.n_constraints, h.n_wires,
                         mesh=mesh, digest=digest, device=device, fri_fold=fri_fold,
                         lde_engine=lde_engine)


def prove_with_rows(circuit, rows: np.ndarray, mesh=None, digest: str = "blake2s",
                    device="cuda", fri_fold: str = "dft", lde_engine: str = "butterfly"):
    """A StarkProof of `circuit`, a parsed `R1csContents` or a
    `native.FlatR1cs`, from its witness as (n_wires, 32) uint8 LE rows, which
    go to the prover as they are: the counterpart of
    `stark_tpu/protocol/runner.py:215-230 prove_with_witness_native`, under
    either digest. A wrong prime, wire count or wire 0 raises `ValueError`
    before any device work. The checks and the arithmetization run in the
    tracer's `arithmetize` phase."""
    with phase("arithmetize"):
        inputs = _rows_inputs(circuit, rows)
    return _prove_inputs(circuit, inputs, mesh, digest, device, fri_fold, lde_engine)


def prove_with_witness(r1cs: R1csContents, witness_bytes: list[bytes], mesh=None,
                       digest: str = "blake2s", device="cuda", fri_fold: str = "dft",
                       lde_engine: str = "butterfly"):
    """run.rs:310-452 -> a StarkProof: `prove_with_rows` on the witness's
    rows, made in the same `arithmetize` phase."""
    with phase("arithmetize"):
        inputs = _rows_inputs(r1cs, _witness_rows(r1cs, witness_bytes))
    return _prove_inputs(r1cs, inputs, mesh, digest, device, fri_fold, lde_engine)


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
    proofs. Returns the proofs in the witnesses' order. A witness with
    another wire count than the circuit's raises `ValueError` before any
    device work (the JAX package pads a short one with zeros).
    """
    if pipeline < 1:
        raise ValueError(f"pipeline must be at least 1, got {pipeline}")
    for witness_bytes in witness_bytes_list:
        _check_wire_count(r1cs, len(witness_bytes))
    spec = _spec_for(r1cs)
    h = _header(r1cs)
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
    """`r1cs` may also be a `native.FlatR1cs` and the public wires (n_pub,
    32) uint8 rows: the static arithmetization and the LDE cache hang on
    whichever object is given."""
    spec = _spec_for(r1cs)
    h = _header(r1cs)
    public_wires = [spec.from_bytes_le(bytes(w)) for w in public_wires_bytes]
    if public_wires[0] != 1:
        raise ValueError("public wire 0 must be 1")
    with phase("v_arithmetize"):
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


def read_circuit(path: str):
    """A `.r1cs` file parsed on the native route (`native.FlatR1cs`, the C++
    reader) where the host library has built, else on the Python route
    (`R1csContents`)."""
    data = _read(path)
    return native.read_r1cs_flat(data) if native.available() else read_r1cs(data)


def read_witness_rows(path: str, circuit) -> np.ndarray:
    """A `.wtns` file of `circuit` as (n_wires, 32) uint8 LE rows, by the
    route `read_circuit` takes: the C++ reader's rows as they are, or the
    Python reader's values padded by `_witness_rows`. A field size other
    than 32 bytes or a wire count other than the circuit's raises
    `ValueError` on both."""
    data = _read(path)
    if not native.available():
        return _witness_rows(circuit, read_witness(data))
    rows = native.read_witness_flat(data)
    if rows.shape[1] != 32:
        raise ValueError(f"the .wtns holds {rows.shape[1]}-byte field elements: "
                         f"only 32-byte ones (BN254's Fr) are read")
    _check_wire_count(circuit, rows.shape[0])
    return rows


def write_proof(proof, proof_json_path) -> str:
    text = proof_mod.to_json(proof)
    with open(proof_json_path, "w") as f:
        f.write(text)
    return text


def _verify_rows(circuit, rows, proof, digest, device, lde_engine) -> None:
    if not verify_with_witness(circuit, rows[: _n_pub(circuit)], proof, digest=digest,
                               device=device, lde_engine=lde_engine):
        raise ValueError("proof rejected")


def _file_inputs(r1cs_path, witness_path, digest: str):
    """The circuit, the witness rows and the prover's inputs from the files.
    On the native route under blake2s the reads and the arithmetization run
    in one `parse+arithmetize` phase, where the JAX package's file route
    takes `prove_with_witness_native`; otherwise the reads run outside any
    phase and the arithmetization in `arithmetize`, as the JAX package's
    `prove_with_witness` does (`stark_tpu/protocol/runner.py:298-342`)."""
    if native.available() and digest == "blake2s":
        with phase("parse+arithmetize"):
            circuit = read_circuit(r1cs_path)
            rows = read_witness_rows(witness_path, circuit)
            return circuit, rows, _rows_inputs(circuit, rows)
    circuit = read_circuit(r1cs_path)
    rows = read_witness_rows(witness_path, circuit)
    with phase("arithmetize"):
        return circuit, rows, _rows_inputs(circuit, rows)


def prove_with_file_path(r1cs_path, witness_path, proof_json_path,
                         digest: str = "blake2s", device="cuda",
                         fri_fold: str = "dft", lde_engine: str = "butterfly") -> None:
    circuit, _, inputs = _file_inputs(r1cs_path, witness_path, digest)
    write_proof(_prove_inputs(circuit, inputs, None, digest, device, fri_fold, lde_engine),
                proof_json_path)


def verify_with_file_path(r1cs_path, witness_path, proof_json_path,
                          digest: str = "blake2s", device="cuda",
                          lde_engine: str = "butterfly") -> None:
    circuit = read_circuit(r1cs_path)
    rows = read_witness_rows(witness_path, circuit)
    with open(proof_json_path) as f:
        proof = proof_mod.from_json(f.read())
    _verify_rows(circuit, rows, proof, digest, device, lde_engine)


def run_with_file_path(r1cs_path, witness_path, proof_json_path,
                       digest: str = "blake2s", device="cuda",
                       fri_fold: str = "dft", lde_engine: str = "butterfly") -> None:
    """Prove, write the JSON, verify (run.rs:590-625): each file read once,
    the prove and the verify sharing the parsed circuit."""
    circuit, rows, inputs = _file_inputs(r1cs_path, witness_path, digest)
    text = write_proof(_prove_inputs(circuit, inputs, None, digest, device, fri_fold,
                                     lde_engine), proof_json_path)
    _verify_rows(circuit, rows, proof_mod.from_json(text), digest, device, lde_engine)
