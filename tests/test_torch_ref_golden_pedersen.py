"""The benchmark's plain reference (`benchmark/ref/`) proves the reference
prover's `pedersen_test` circuit (1,996 constraints, padded widths up to
257, 7,852 slots a region, a 2^15-step trace) as
`pedersen_proof_golden.json`, byte for byte, on the CPU (about 40 s on one
worker). Tolerance: exact (the proof's JSON text).
"""

import os

import torch

from benchmark.ref import r1cs as rr
from benchmark.ref.prover import Prover

torch.set_num_threads(2)
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _read(name: str) -> bytes:
    with open(os.path.join(FIX, name), "rb") as f:
        return f.read()


def test_the_reference_proves_the_pedersen_golden():
    r1cs = rr.read_r1cs(_read("pedersen_test.r1cs"))
    assert int(r1cs["factor_lens"].max()) == 257
    rows = rr.read_wtns(_read("pedersen_test.wtns"))
    assert Prover(r1cs, "cpu", "blake2s").prove(rows) == _read(
        "pedersen_proof_golden.json").decode().strip()
