"""Synthetic R1CS circuit generators (benchmarking / multi-chip dry runs).

The reference benches only on fixed circom fixtures; for scaling studies we
need circuits of arbitrary size. `squaring_chain(n)` builds the classic
x_{i+1} = x_i^2 chain: n constraints, n+2 wires, witness generated from a
seed -- every constraint is satisfied by construction.
`write_circuit_files` writes a circuit and its witness as the `.r1cs` and
`.wtns` files that the readers and the file-path entry points take.
"""

from __future__ import annotations

import struct

from stark_tpu_torch.fields.field import BN254_FR, FieldSpec
from stark_tpu_torch.r1cs.reader import Coefficient, Constraint, Factor, Header, R1csContents

_ONE_LE = (1).to_bytes(32, "little")


def _factor(wire_id: int, value: bytes = _ONE_LE) -> Factor:
    return Factor(1, [Coefficient(wire_id, value)])


def squaring_chain(
    n_constraints: int, x0: int = 3, spec: FieldSpec = BN254_FR
) -> tuple[R1csContents, list[bytes]]:
    """R1CS + witness for x_{i+1} = x_i * x_i, i < n.

    Wires: [0]=1 (constant), [1]=x_n (public output), [2]=x_0, [3..]=x_1..
    Returns (R1csContents, witness_bytes) in the same shapes the file
    readers produce."""
    p = spec.p
    xs = [x0 % p]
    for _ in range(n_constraints):
        xs.append(xs[-1] * xs[-1] % p)
    # wire layout: w0=1, w1=x_n, w2..w_{n+1}=x_0..x_{n-1}
    wires = [1, xs[-1]] + xs[:-1]

    def wire_of(i: int) -> int:  # wire holding x_i
        return 1 if i == n_constraints else 2 + i

    constraints = []
    for i in range(n_constraints):
        constraints.append(
            Constraint(
                [
                    _factor(wire_of(i)),
                    _factor(wire_of(i)),
                    _factor(wire_of(i + 1)),
                ]
            )
        )

    header = Header(
        field_size=32,
        prime_number=p.to_bytes(32, "little"),
        n_wires=len(wires),
        n_public_outputs=1,
        n_public_inputs=0,
        n_private_inputs=1,
        n_labels=len(wires),
        n_constraints=n_constraints,
    )
    witness = [
        v.to_bytes(max(1, (v.bit_length() + 7) // 8), "little") for v in wires
    ]
    return R1csContents(1, header, constraints), witness


def ragged_mix(
    n_constraints: int,
    seed: int = 7,
    max_width: int = 32,
    spec: FieldSpec = BN254_FR,
) -> tuple[R1csContents, list[bytes]]:
    """sha256_2-class synthetic circuit: MIXED-WIDTH constraints with
    scattered wire locality.

    The reference's scale story is `sha256_2_test` (
    `packages/r1cs-stark/README.md:19-25,50` -- its .r1cs is absent from the
    snapshot, `.MISSING_LARGE_BLOBS:1`), a real memory-bound circuit whose
    constraints are NOT uniform-width: bit recompositions are ~32-term
    linear combinations, boolean checks are width 1, and mixing steps are
    short products. This generator reproduces that shape so the ragged
    arithmetization paths (per-constraint n_coeff = max(|A|,|B|,|C|),
    run.rs:140; pad slots; cross-window copy permutation) are exercised at
    arbitrary scale:

    * ~55%% width-1 squarings x*x = y (boolean-check shaped),
    * ~30%% medium products (2-4 term A and B) over a 256-wire window,
    * ~15%% wide recombinations (8..max_width-term A) * 1 = y.

    Every constraint defines one fresh wire, so the witness satisfies the
    system by construction. Deterministic in (n_constraints, seed)."""
    import numpy as np

    p = spec.p
    rng = np.random.default_rng(seed)
    wires = [1, 0, 3 % p]  # w0=1, w1=public output (patched), w2=input
    constraints = []

    def coeff_bytes(c: int) -> bytes:
        return int(c).to_bytes(32, "little")

    def pick(k: int) -> list[int]:
        # wires >= 2 only: w1 is the public output, written by the LAST
        # constraint (it must appear in a constraint so the verifier's
        # public_first_indices finds its first slot, run.rs:390-419)
        lo = max(2, len(wires) - 256)
        return [int(v) for v in rng.integers(lo, len(wires), size=k)]

    for i in range(n_constraints):
        kind = rng.random()
        if kind < 0.55:
            w = pick(1)[0]
            a_terms = [(w, 1)]
            b_terms = [(w, 1)]
        elif kind < 0.85:
            ka, kb = int(rng.integers(2, 5)), int(rng.integers(2, 5))
            a_terms = [(w, int(rng.integers(1, 1000))) for w in pick(ka)]
            b_terms = [(w, int(rng.integers(1, 1000))) for w in pick(kb)]
        else:
            ka = int(rng.integers(8, max_width + 1))
            a_terms = [(w, pow(2, j, p)) for j, w in enumerate(pick(ka))]
            b_terms = [(0, 1)]  # * constant 1
        av = sum(c * wires[w] for w, c in a_terms) % p
        bv = sum(c * wires[w] for w, c in b_terms) % p
        if i == n_constraints - 1:
            out_wire = 1
            wires[1] = av * bv % p
        else:
            out_wire = len(wires)
            wires.append(av * bv % p)
        constraints.append(
            Constraint(
                [
                    Factor(
                        len(a_terms),
                        [Coefficient(w, coeff_bytes(c)) for w, c in a_terms],
                    ),
                    Factor(
                        len(b_terms),
                        [Coefficient(w, coeff_bytes(c)) for w, c in b_terms],
                    ),
                    Factor(1, [Coefficient(out_wire, _ONE_LE)]),
                ]
            )
        )
    header = Header(
        field_size=32,
        prime_number=p.to_bytes(32, "little"),
        n_wires=len(wires),
        n_public_outputs=1,
        n_public_inputs=0,
        n_private_inputs=1,
        n_labels=len(wires),
        n_constraints=n_constraints,
    )
    witness = [
        int(v).to_bytes(max(1, (int(v).bit_length() + 7) // 8), "little")
        for v in wires
    ]
    return R1csContents(1, header, constraints), witness


def write_circuit_files(r1cs: R1csContents, witness, r1cs_path: str, wtns_path: str) -> None:
    """A parsed circuit and its witness as iden3 `.r1cs` and circom `.wtns`
    files, the inverse of `stark_tpu_torch/r1cs/reader.py` (and of the C++
    readers): the `.r1cs` has its three sections, the third the identity
    map of `n_labels` wire labels (u64), as circom's tools write it; the
    `.wtns` is version 2, with each value padded to the field size."""
    h = r1cs.header
    header = struct.pack("<I", h.field_size) + h.prime_number + struct.pack(
        "<IIIIQI", h.n_wires, h.n_public_outputs, h.n_public_inputs,
        h.n_private_inputs, h.n_labels, h.n_constraints)
    body = bytearray()
    for constraint in r1cs.constraints:
        for factor in constraint.factors:
            body += struct.pack("<I", len(factor.coefficients))
            for c in factor.coefficients:
                body += struct.pack("<I", c.wire_id) + c.value.ljust(32, b"\0")
    labels = struct.pack(f"<{h.n_labels}Q", *range(h.n_labels))
    with open(r1cs_path, "wb") as f:
        f.write(b"r1cs" + struct.pack("<II", r1cs.version, 3))
        for kind, section in ((1, header), (2, bytes(body)), (3, labels)):
            f.write(struct.pack("<IQ", kind, len(section)) + section)
    with open(wtns_path, "wb") as f:
        # version 2, two sections: the header (id 1), then the values (id 2)
        f.write(b"wtns" + struct.pack("<IIIQ", 2, 2, 1, 8 + h.field_size))
        f.write(struct.pack("<I", h.field_size) + h.prime_number)
        f.write(struct.pack("<I", len(witness)))
        f.write(struct.pack("<IQ", 2, len(witness) * h.field_size))
        for w in witness:
            f.write(w.ljust(h.field_size, b"\0"))
