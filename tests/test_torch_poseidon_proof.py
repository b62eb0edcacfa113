"""Proofs under `digest="poseidon"` through the port's runner, on the CPU.

The l-tree and every FRI tree are Poseidon trees (the m-tree, the a-tree
and the transcript stay blake2s), as in the JAX package
(`stark_tpu/protocol/core.py:288-300`): the port's `compute` proof on both
of FRI's fold routes is byte-identical to the committed
`compute_proof_poseidon_golden.json`, which `tests/test_digest_poseidon.py`
holds the JAX package to (precision 2^7: an l-tree of 128 leaves and one
FRI tree of 32, the permutation on its plain PyTorch version). Tolerance:
exact (byte-identical JSON).
"""

import os

import pytest
import torch

from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.mark.parametrize("fri_fold", ["dft", "lagrange"])
def test_poseidon_proof_matches_golden(fri_fold):
    with open(os.path.join(FIX, "compute.r1cs"), "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(os.path.join(FIX, "compute.wtns"), "rb") as f:
        witness = read_witness(f.read())
    proof = runner.prove_with_witness(r1cs, witness, digest="poseidon", device="cpu",
                                      fri_fold=fri_fold)
    with open(os.path.join(FIX, "compute_proof_poseidon_golden.json")) as f:
        assert proof_mod.to_json(proof) == f.read()
