"""The benchmark's circuit family `benchmark/circuits/poseidon_tree.py`
(the root of a Merkle tree of the reference's compiled circom Poseidon,
`poseidon3_test`), on the CPU:

* its copy of the fixture is `tests/fixtures/poseidon3_test.r1cs`, byte for
  byte, and its solver, from the fixture's two inputs alone, gives the
  fixture's `.wtns`, wire for wire;
* at depths 1 to 3 each copy's constraints in the written `.r1cs`, read by
  the port's reader, are the fixture's, term for term, under the copy's
  wire map, and the header names one public output and 2^depth private
  inputs;
* a witness drawn from a seed satisfies every constraint, in python ints,
  and its root is the hash of its two children;
* the configuration `benchmark/configs/ragged-2p23-blake2s.json` keeps the
  trace at 2^20 steps and precision 2^23 (the fixture's widths alone, no
  file): 282,956 slots a region, 505,460 pad slots, 759,714 slots where
  the P scan carries, and the counts of its `what`.

Tolerance: exact (bytes and integers).
"""

import json
import os
import random

import numpy as np
import pytest

from benchmark.circuits import poseidon_tree as pt
from stark_tpu_torch.fields.field import BN254_FR
from stark_tpu_torch.protocol.params import derive_params
from stark_tpu_torch.r1cs import reader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
CONFIG = os.path.join(ROOT, "benchmark", "configs", "ragged-2p23-blake2s.json")


def _sizes(depth: int) -> dict:
    return {"n_constraints": ((1 << depth) - 1) * 234, "depth": depth}


def _ints(rows) -> list:
    return [int.from_bytes(bytes(r), "little") for r in rows]


def test_the_copy_is_the_fixture_and_the_solver_gives_its_witness():
    with open(os.path.join(FIX, "poseidon3_test.r1cs"), "rb") as f:
        assert f.read() == open(pt.FIXTURE, "rb").read()
    with open(os.path.join(FIX, "poseidon3_test.wtns"), "rb") as f:
        want = _ints(reader.read_witness(f.read()))
    assert len(want) == 237 and pt.hash_wires(want[2], want[3]) == want


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_each_copy_is_the_fixture_under_its_wire_map(tmp_path, depth):
    path = str(tmp_path / "tree.r1cs")
    pt.write_r1cs(path, _sizes(depth))
    with open(path, "rb") as f:
        got = reader.read_r1cs(f.read())
    with open(pt.FIXTURE, "rb") as f:
        fixture = reader.read_r1cs(f.read())
    h = got.header
    leaves = 1 << depth
    assert (h.n_public_outputs, h.n_public_inputs, h.n_private_inputs) == (1, 0, leaves)
    assert h.n_constraints == (leaves - 1) * 234 == len(got.constraints)
    maps = pt._wire_maps(_sizes(depth))
    assert h.n_wires == int(maps.max()) + 1
    # every wire but wire 0 belongs to one copy, or is a leaf
    own = maps[:, pt.FIRST_OWN:].reshape(-1).tolist() + maps[:, pt.OUT].tolist()
    assert sorted(own + list(range(2, 2 + leaves))) == list(range(1, h.n_wires))
    for c in range(leaves - 1):
        for mine, theirs in zip(got.constraints[234 * c: 234 * (c + 1)], fixture.constraints):
            for f, g in zip(mine.factors, theirs.factors):
                assert [(t.wire_id, t.value) for t in f.coefficients] == [
                    (int(maps[c, t.wire_id]), t.value) for t in g.coefficients]


def test_a_drawn_witness_satisfies_every_constraint(tmp_path):
    sizes = _sizes(3)
    rows = pt.witness(sizes, random.Random(2**35 + 11))
    vals = _ints(rows)
    p = pt.BN254_P
    assert vals[0] == 1 and len(set(vals[2:10])) == 8
    path = str(tmp_path / "tree.r1cs")
    pt.write_r1cs(path, sizes)
    with open(path, "rb") as f:
        constraints = reader.read_r1cs(f.read()).constraints
    for c in constraints:
        a, b, out = (sum(int.from_bytes(t.value, "little") * vals[t.wire_id]
                         for t in f.coefficients) % p for f in c.factors)
        assert a * b % p == out
    maps = pt._wire_maps(sizes)
    root = maps[-1]
    assert root[pt.OUT] == 1
    assert vals[1] == pt.hash_wires(vals[root[pt.LEFT]], vals[root[pt.RIGHT]])[pt.OUT]


def test_the_configuration_keeps_the_largest_trace():
    with open(CONFIG) as f:
        config = json.load(f)
    sizes = config["circuit"]["sizes"]
    with open(pt.FIXTURE, "rb") as f:
        fixture = reader.read_r1cs(f.read())
    terms = np.array([[f.n_coefficient for f in c.factors] for c in fixture.constraints])
    width = terms.max(axis=1)
    copies = (1 << sizes["depth"]) - 1
    a_len = copies * int(width.sum())
    assert a_len == 282_956 and copies * int(terms.sum()) == 343_408
    params = derive_params(BN254_FR, 3 * a_len)
    assert (params.steps, params.precision) == (config["steps"], config["precision"])
    assert (params.steps, params.precision) == (2**20, 2**23)
    assert config["n_constraints"] == sizes["n_constraints"] == copies * len(width)
    assert config["n_wires"] == int(pt._wire_maps(sizes).max()) + 1 == 29_847
    assert 3 * a_len - copies * int(terms.sum()) == 505_460  # pad slots
    assert 3 * copies * int((width - 1).sum()) == 759_714  # slots past a constraint's first
    assert int(width.max()) == 61
    uses0 = sum(t.wire_id == 0 for c in fixture.constraints for f in c.factors
                for t in f.coefficients)
    assert copies * uses0 == 10_668
    assert config["source_circuit"] == {
        "n_constraints": len(width), "n_wires": fixture.header.n_wires,
        "n_public_outputs": 1, "n_public_inputs": 2, "n_private_inputs": 0}
