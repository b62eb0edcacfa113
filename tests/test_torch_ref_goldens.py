"""The benchmark's plain reference (`benchmark/ref/`, plain PyTorch, nothing
of the port) on the reference prover's real circom circuits, on the CPU:

* `poseidon3_test` (234 constraints, padded widths up to 61, 2,228 slots a
  region): its whole proof is `poseidon3_proof_golden.json`, byte for byte;
* `bits` (1,061 constraints, the widest of width 1,061): its
  arithmetization (K, S, the running sum P, the flags, the copy
  permutation and the public wires' first slots) equals the port's
  python-int arithmetizer's (`stark_tpu_torch/r1cs/arithmetize.py`, held to
  the JAX package's in `test_torch_imports.py`); and, marked slow, its
  whole proof is `bits_proof_golden.json`, byte for byte (about 125 s on
  one CPU worker, 100 s of it the boundary of its 1,060 public wires, a
  product and a Horner step a point over the 2^17-point domain).

`test_torch_ref_golden_pedersen.py` holds the `pedersen_test` golden.
Tolerance: exact (the proof's JSON text, integers).
"""

import os

import pytest
import torch

from benchmark.ref import r1cs as rr
from benchmark.ref.field import BN254_P, Field
from benchmark.ref.prover import Prover
from stark_tpu_torch.fields.field import BN254_FR
from stark_tpu_torch.r1cs import arithmetize as tarith
from stark_tpu_torch.r1cs import reader

torch.set_num_threads(2)
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _read(name: str) -> bytes:
    with open(os.path.join(FIX, name), "rb") as f:
        return f.read()


def test_the_reference_proves_the_poseidon3_golden():
    r1cs = rr.read_r1cs(_read("poseidon3_test.r1cs"))
    assert int(r1cs["factor_lens"].max()) == 61
    rows = rr.read_wtns(_read("poseidon3_test.wtns"))
    assert Prover(r1cs, "cpu", "blake2s").prove(rows) == _read(
        "poseidon3_proof_golden.json").decode().strip()


def test_the_reference_arithmetizes_bits_as_the_port():
    data, wtns = _read("bits.r1cs"), _read("bits.wtns")
    r1cs = rr.read_r1cs(data)
    assert int(r1cs["factor_lens"].max()) == 1061
    F = Field(BN254_P)
    ref = rr.arithmetize(F, r1cs, F.from_bytes(torch.from_numpy(rr.read_wtns(wtns).copy())))
    parsed = reader.read_r1cs(data)
    h = parsed.header
    n_pub = 1 + h.n_public_inputs + h.n_public_outputs
    witness = [BN254_FR.from_bytes_le(w) for w in reader.read_witness(wtns)]
    port = tarith.arithmetize(BN254_FR, parsed.constraints, witness, h.n_wires, n_pub)
    assert ref["original_steps"] == port.original_steps == 3 * 3181
    assert F.to_ints(ref["coeff"]) == list(port.coefficients)
    assert F.to_ints(ref["witness"]) == list(port.witness_trace)
    assert F.to_ints(ref["trace"]) == list(port.computational_trace)
    assert ref["flag1"].tolist() == list(port.flag1)
    assert ref["flag2"].tolist() == list(port.flag2)
    assert ref["permuted"].tolist() == list(port.permuted_indices)
    assert ref["public_first"] == [tuple(x) for x in port.public_first_indices]
    assert ref["n_pub"] == n_pub == 1062


@pytest.mark.slow
def test_the_reference_proves_the_bits_golden():
    r1cs = rr.read_r1cs(_read("bits.r1cs"))
    rows = rr.read_wtns(_read("bits.wtns"))
    assert Prover(r1cs, "cpu", "blake2s").prove(rows) == _read(
        "bits_proof_golden.json").decode().strip()
