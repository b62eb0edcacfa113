"""Small ragged circuits of the port's generator (`stark_tpu_torch/r1cs/
synth.py ragged_mix`: mixed widths, each constraint defining one fresh
wire, input wire 2) for the CPU tests, witnesses for inputs drawn from
seeds, and the port's proof of one as the JSON text the benchmark
compares."""

import random

import numpy as np

from stark_tpu_torch.fields.field import BN254_FR
from stark_tpu_torch.r1cs import synth

# structure seed 19 gives 60 constraints of padded widths 1 to 32 (six of
# 8 or more): 198 slots a region, a 1,024-step trace; seed 159 gives 20
# constraints with one of width 20 and one of 32: a 256-step trace; seed 20
# gives 8 constraints of widths 1, 3 and 31: a 128-step trace
SIXTY = {"n_constraints": 60, "structure_seed": 19, "max_width": 32}
TWENTY = {"n_constraints": 20, "structure_seed": 159, "max_width": 32}
EIGHT = {"n_constraints": 8, "structure_seed": 20, "max_width": 32}
WITNESS_SEEDS = (2**33 + 5, 2**40 + 17)


def circuit(sizes):
    return synth.ragged_mix(sizes["n_constraints"], seed=sizes["structure_seed"],
                            max_width=sizes["max_width"])[0]


def lens(sizes) -> np.ndarray:
    """(n_constraints, 3): each factor's term count."""
    return np.array([[f.n_coefficient for f in c.factors] for c in circuit(sizes).constraints])


def write_circuit(tmp_path, sizes) -> str:
    path = str(tmp_path / "ragged.r1cs")
    r1cs, witness = synth.ragged_mix(sizes["n_constraints"], seed=sizes["structure_seed"],
                                     max_width=sizes["max_width"])
    synth.write_circuit_files(r1cs, witness, path, str(tmp_path / "ragged.wtns"))
    return path


def evaluate(sizes, x: int) -> np.ndarray:
    """The witness with input wire 2 = x, each constraint's output wire
    A * B, as (n_wires, 32) uint8 little-endian rows."""
    p = BN254_FR.p
    r1cs = circuit(sizes)
    vals = [0] * r1cs.header.n_wires
    vals[0], vals[2] = 1, x % p

    def value(factor):
        return sum(int.from_bytes(c.value, "little") * vals[c.wire_id]
                   for c in factor.coefficients) % p

    for c in r1cs.constraints:
        vals[c.factors[2].coefficients[0].wire_id] = value(c.factors[0]) * value(c.factors[1]) % p
    blob = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(blob, dtype=np.uint8).reshape(len(vals), 32).copy()


def witnesses(sizes, seeds=WITNESS_SEEDS) -> list:
    return [evaluate(sizes, random.Random(s).randrange(2, BN254_FR.p)) for s in seeds]


def port_json(circuit, rows, digest: str = "blake2s") -> str:
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner

    return proof_mod.to_json(runner.prove_with_rows(circuit, rows, digest=digest,
                                                    device="cpu"))
