"""The port against the benchmark's plain reference on a ragged circuit of
the port's generator (`synth.ragged_mix`) under `digest="poseidon"`, on
the CPU: 8 constraints of padded widths 1, 3 and 31, a 128-step trace (the
plain Poseidon permutation makes a proof of the port here cost about 10 s
at that size; `test_torch_ragged_reference.py` holds 60 constraints under
Blake2s). Two witnesses drawn from seeds; `benchmark/check.py compare`
holds the port's JSON to the reference's proofs, and refuses a copy with
one bit of a FRI branch flipped. Tolerance: exact (the proof's JSON text).
"""

import json

import numpy as np
import torch

from benchmark import check
from stark_tpu_torch.protocol import runner
from torch_ragged import EIGHT, lens, port_json, witnesses, write_circuit

torch.set_num_threads(2)


def test_the_port_equals_the_plain_reference_under_poseidon(tmp_path):
    terms = lens(EIGHT)
    assert terms.max() == 31 and (terms.min(axis=1) < terms.max(axis=1)).any()
    path = write_circuit(tmp_path, EIGHT)
    pool = witnesses(EIGHT)
    assert not np.array_equal(pool[0], pool[1])
    circuit = runner.read_circuit(path)
    texts = [port_json(circuit, rows, "poseidon") for rows in pool]
    obj = json.loads(texts[1])
    obj["fri_proof"][0]["Middle"]["column_branches"][0]["nodes"][0][5] ^= 1
    bad = json.dumps(obj, separators=(",", ":"))
    # the flipped copy differs from the port's text, so one mismatch of
    # three means both of the port's texts are the reference's
    numbers = check.compare(path, pool, [0, 1], {0: [texts[0]], 1: [texts[1], bad]},
                            {"digest": "poseidon"}, "cpu")
    assert numbers["mismatched_proofs"]["value"] == 1 and numbers["compared"]["value"] == 3
