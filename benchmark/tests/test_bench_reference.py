"""The plain reference against the reference's goldens and against the
port's proofs at a tiny precision, and the comparison that decides
`correct` refusing a proof with one byte changed."""

from __future__ import annotations

import json
import os
import random

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.circuits import squaring_chain as sc
from benchmark.ref import r1cs as rr
from benchmark.ref.prover import Prover
from benchmark.tests.bench_tiny import REPO

FIX = os.path.join(REPO, "tests", "fixtures")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("digest,golden", [("blake2s", "compute_proof_golden.json"),
                                           ("poseidon", "compute_proof_poseidon_golden.json")])
def test_reference_equals_the_golden(digest, golden):
    with open(os.path.join(FIX, "compute.r1cs"), "rb") as f:
        r1cs = rr.read_r1cs(f.read())
    with open(os.path.join(FIX, "compute.wtns"), "rb") as f:
        rows = rr.read_wtns(f.read())
    with open(os.path.join(FIX, golden)) as f:
        assert Prover(r1cs, "cpu", digest).prove(rows) == f.read().strip()


@pytest.mark.parametrize("digest", ["blake2s", "poseidon"])
def test_reference_equals_the_port_on_a_chain(tmp_path, digest):
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner

    path = str(tmp_path / "c.r1cs")
    sizes = {"n_constraints": 30}
    sc.write_r1cs(path, sizes)
    rows = sc.witness(sizes, random.Random(2**32 + 15))
    ported = proof_mod.to_json(runner.prove_with_rows(runner.read_circuit(path), rows,
                                                      digest=digest, device="cpu"))
    config = {"digest": digest}
    numbers = check.compare(path, [rows], [0], {0: [ported]}, config, "cpu")
    assert numbers["mismatched_proofs"]["value"] == 0 and numbers["compared"]["value"] == 1
    # one byte of the proof changed: refused
    obj = json.loads(ported)
    obj["fri_proof"][0]["Middle"]["column_branches"][3]["nodes"][1][7] ^= 1
    bad = json.dumps(obj, separators=(",", ":"))
    numbers = check.compare(path, [rows], [0], {0: [ported, bad]}, config, "cpu")
    assert numbers["mismatched_proofs"]["value"] == 1 and numbers["compared"]["value"] == 2


def test_the_control_is_refused(tmp_path):
    """The reference with its committed values left in [0, 2p) (the lazy
    form) put in the program's place: every output mismatches."""
    path = str(tmp_path / "c.r1cs")
    sizes = {"n_constraints": 30}
    sc.write_r1cs(path, sizes)
    rows = sc.witness(sizes, random.Random(99))
    with open(path, "rb") as f:
        lazy = Prover(rr.read_r1cs(f.read()), "cpu", "blake2s", lazy=True).prove(rows)
    numbers = check.compare(path, [rows], [0], {0: [lazy] * 3}, {"digest": "blake2s"}, "cpu")
    assert numbers["mismatched_proofs"]["value"] == 3


def test_field_and_ntt_against_python_ints():
    from benchmark.ref.field import BLS12_381_P, BN254_P, Field
    from benchmark.ref.ntt import lde, ntt

    rng = random.Random(5)
    for p in (BN254_P, BLS12_381_P):
        F = Field(p)
        xs = [rng.randrange(p) for _ in range(64)] + [0, 1, p - 1]
        ys = [rng.randrange(p) for _ in range(67)]
        a, b = F.consts(xs), F.consts(ys)
        assert F.to_ints(F.mul(a, b)) == [x * y % p for x, y in zip(xs, ys)]
        assert F.to_ints(F.mul(F.sub(F.sub(a, b), b), F.reduce(a))) == [
            (x - 2 * y) * x % p for x, y in zip(xs, ys)]
        assert F.to_ints(F.batch_inv(a)) == [pow(x, p - 2, p) if x else 0 for x in xs]
        raw = torch.tensor(np.array([list(x.to_bytes(32, "little")) for x in xs], np.uint8))
        assert F.to_ints(F.from_bytes(raw)) == xs and torch.equal(F.to_bytes(a), raw)
    p = BN254_P
    F = Field(p)
    n = 16
    g = pow(7, (p - 1) // n, p)
    vals = [rng.randrange(p) for _ in range(n)]
    out = F.to_ints(ntt(F, F.consts(vals).view(10, 1, n), g).view(10, n))
    assert out == [sum(v * pow(g, j * k, p) for j, v in enumerate(vals)) % p for k in range(n)]
    g2 = pow(7, (p - 1) // (8 * n), p)
    e = F.to_ints(lde(F, F.consts(vals), pow(g2, 8, p), g2, F.powers(g2, 8 * n)))
    assert e[::8] == vals
