"""The benchmark's NumPy `.r1cs` writer and its witnesses against the
port's own synthesis and readers, and the reference's readers."""

from __future__ import annotations

import random

import numpy as np

from benchmark.circuits import squaring_chain as sc
from benchmark.ref import r1cs as rr


def test_writer_bytes_equal_the_ports_synthesis(tmp_path):
    from stark_tpu_torch.r1cs import reader, synth

    n = 57
    ours, theirs = tmp_path / "ours.r1cs", tmp_path / "theirs.r1cs"
    sc.write_r1cs(str(ours), {"n_constraints": n})
    rows = sc.witness({"n_constraints": n}, random.Random(2**33 + 1))
    sc.write_wtns(str(tmp_path / "ours.wtns"), rows)
    circuit, witness = synth.squaring_chain(n, x0=int.from_bytes(bytes(rows[2]), "little"))
    synth.write_circuit_files(circuit, witness, str(theirs), str(tmp_path / "theirs.wtns"))
    assert ours.read_bytes() == theirs.read_bytes()
    assert (tmp_path / "ours.wtns").read_bytes() == (tmp_path / "theirs.wtns").read_bytes()
    parsed = reader.read_r1cs(ours.read_bytes())
    assert parsed.header == circuit.header and parsed.constraints == circuit.constraints


def test_read_back_through_the_ports_file_route(tmp_path):
    from stark_tpu_torch.protocol import runner

    n = 33
    path = str(tmp_path / "c.r1cs")
    sc.write_r1cs(path, {"n_constraints": n})
    rows = sc.witness({"n_constraints": n}, random.Random(7))
    sc.write_wtns(str(tmp_path / "c.wtns"), rows)
    circuit = runner.read_circuit(path)
    assert np.array_equal(runner.read_witness_rows(str(tmp_path / "c.wtns"), circuit), rows)


def test_reference_readers(tmp_path):
    n = 21
    path = tmp_path / "c.r1cs"
    sc.write_r1cs(str(path), {"n_constraints": n})
    r = rr.read_r1cs(path.read_bytes())
    assert r["n_constraints"] == n and r["n_wires"] == n + 2
    assert (r["factor_lens"] == 1).all()
    assert list(r["wires"][:6]) == [2, 2, 3, 3, 3, 4]
    assert list(r["wires"][-3:]) == [n + 1, n + 1, 1]
    rows = sc.witness({"n_constraints": n}, random.Random(3))
    sc.write_wtns(str(tmp_path / "c.wtns"), rows)
    assert np.array_equal(rr.read_wtns((tmp_path / "c.wtns").read_bytes()), rows)
    x = [int.from_bytes(bytes(rows[i]), "little") for i in range(n + 2)]
    assert x[0] == 1 and x[3] == x[2] ** 2 % sc.BN254_P and x[1] == x[n + 1] ** 2 % sc.BN254_P
