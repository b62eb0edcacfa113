"""The port against the benchmark's plain reference (`benchmark/ref/`,
plain PyTorch, nothing of the port) on a ragged circuit of the port's
generator (`synth.ragged_mix`), on the CPU, under Blake2s: 60 constraints of padded widths 1 to 32,
so pad slots, coefficients other than 1, long copy cycles and segments of
up to 32 slots over which the P scan carries. Two witnesses drawn from
seeds go through `runner.prove_with_rows(runner.read_circuit(path), rows)`
and `proof.to_json`, and `benchmark/check.py compare`, the comparison that
decides a run's `correct`, holds both to the reference's proofs; a proof
with one bit flipped, and the control (`benchmark/control.py`'s lazy
reference), are refused. Tolerance: exact (the proof's JSON text).
"""

import json

import numpy as np
import torch

from benchmark import check
from benchmark.ref import r1cs as rr
from benchmark.ref.prover import Prover
from stark_tpu_torch.protocol import runner
from torch_ragged import SIXTY, lens, port_json, witnesses, write_circuit

torch.set_num_threads(2)
CONFIG = {"digest": "blake2s"}


def test_the_port_equals_the_plain_reference(tmp_path):
    terms = lens(SIXTY)
    width = terms.max(axis=1)
    assert width.max() == 32 and (width == 1).any() and (terms.min(axis=1) < width).any()
    path = write_circuit(tmp_path, SIXTY)
    pool = witnesses(SIXTY)
    assert not np.array_equal(pool[0], pool[1])
    circuit = runner.read_circuit(path)
    outputs = {j: [port_json(circuit, rows)] for j, rows in enumerate(pool)}
    numbers = check.compare(path, pool, [0, 1], outputs, CONFIG, "cpu")
    assert numbers["mismatched_proofs"]["value"] == 0 and numbers["compared"]["value"] == 2
    # the first byte of the first spot check's P value flipped, and the
    # control (the reference with its committed values left in [0, 2p)):
    # both refused
    obj = json.loads(outputs[0][0])
    obj["main_branches"][0]["leaf"][0] ^= 1
    bad = json.dumps(obj, separators=(",", ":"))
    with open(path, "rb") as f:
        lazy = Prover(rr.read_r1cs(f.read()), "cpu", "blake2s", lazy=True).prove(pool[0])
    numbers = check.compare(path, pool, [0], {0: [bad, lazy]}, CONFIG, "cpu")
    assert numbers["mismatched_proofs"]["value"] == 2 and numbers["compared"]["value"] == 2
