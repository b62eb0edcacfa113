"""The port's verifier on Poseidon proofs, on the CPU, as
`tests/test_digest_poseidon.py` holds the JAX package's: the committed
`compute_proof_poseidon_golden.json` verifies under `digest="poseidon"`,
each digest's verifier rejects the other's proof, and a tampered Poseidon
proof is rejected. The l-tree's and FRI's branches are walked with the
host Poseidon hash; FRI's last-round root is recomputed with the plain
permutation. The CLI's `verify --digest poseidon` accepts the golden too.
Tolerance: exact (accept or reject).
"""

import os

import pytest
import torch

from stark_tpu_torch import cli
from stark_tpu_torch.merkle.tree import MerkleProof
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module")
def compute():
    with open(os.path.join(FIX, "compute.r1cs"), "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(os.path.join(FIX, "compute.wtns"), "rb") as f:
        witness = read_witness(f.read())
    return r1cs, witness[: runner._n_pub(r1cs)]


def _proof(name: str):
    with open(os.path.join(FIX, name)) as f:
        return proof_mod.from_json(f.read())


def test_poseidon_golden_verifies(compute):
    r1cs, pub = compute
    assert runner.verify_with_witness(r1cs, pub, _proof("compute_proof_poseidon_golden.json"),
                                      digest="poseidon", device="cpu")


def test_blake_verifier_rejects_poseidon_proof(compute):
    r1cs, pub = compute
    with pytest.raises((ValueError, AssertionError)):
        runner.verify_with_witness(r1cs, pub, _proof("compute_proof_poseidon_golden.json"),
                                   device="cpu")


def test_poseidon_verifier_rejects_blake_proof(compute):
    r1cs, pub = compute
    with pytest.raises((ValueError, AssertionError)):
        runner.verify_with_witness(r1cs, pub, _proof("compute_proof_golden.json"),
                                   digest="poseidon", device="cpu")


def test_poseidon_proof_tamper_rejected(compute):
    r1cs, pub = compute
    proof = _proof("compute_proof_poseidon_golden.json")
    b = proof.linear_comb_branches[0]
    proof.linear_comb_branches[0] = MerkleProof(bytes([b.leaf[0] ^ 1]) + b.leaf[1:],
                                                list(b.nodes))
    with pytest.raises(ValueError, match="merkle"):
        runner.verify_with_witness(r1cs, pub, proof, digest="poseidon", device="cpu")


def test_cli_verifies_the_poseidon_golden(capsys):
    args = [os.path.join(FIX, "compute.r1cs"), os.path.join(FIX, "compute.wtns"),
            os.path.join(FIX, "compute_proof_poseidon_golden.json"), "--device", "cpu"]
    assert cli.main(["verify", *args, "--digest", "poseidon"]) == 0
    assert "Done proof verification" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["verify", *args, "--digest", "sha256"])
