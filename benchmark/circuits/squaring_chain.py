"""The squaring chain x_{i+1} = x_i^2 over BN254's Fr, the circuit of the
repository's earlier benchmarks: n constraints [x_i] * [x_i] = [x_{i+1}],
each coefficient 1. Wire 0 is 1, wire 1 the public output x_n, wires 2..
hold x_0 .. x_{n-1}. The `.r1cs` is the iden3 binary layout with its three
sections (header, constraints, the identity map of wire labels), written
with NumPy; the witness starts from an x_0 drawn from the run's seed."""

from __future__ import annotations

import struct

import numpy as np

BN254_P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ONE_LE = (1).to_bytes(32, "little")


def write_r1cs(path: str, sizes: dict) -> None:
    n = sizes["n_constraints"]
    n_wires = n + 2
    header = struct.pack("<I", 32) + BN254_P.to_bytes(32, "little") + struct.pack(
        "<IIIIQI", n_wires, 1, 0, 1, n_wires, n)
    term = np.dtype([("n", "<u4"), ("wire", "<u4"), ("value", "V32")])
    body = np.zeros((n, 3), dtype=term)
    wire_of = np.arange(n + 1, dtype=np.uint32) + 2
    wire_of[n] = 1
    body["n"] = 1
    body["wire"][:, 0] = wire_of[:n]
    body["wire"][:, 1] = wire_of[:n]
    body["wire"][:, 2] = wire_of[1:]
    body["value"] = np.void(ONE_LE)
    labels = np.arange(n_wires, dtype="<u8").tobytes()
    with open(path, "wb") as f:
        f.write(b"r1cs" + struct.pack("<II", 1, 3))
        for kind, section in ((1, header), (2, body.tobytes()), (3, labels)):
            f.write(struct.pack("<IQ", kind, len(section)))
            f.write(section)


def witness(sizes: dict, rng) -> np.ndarray:
    n = sizes["n_constraints"]
    x = rng.randrange(2, BN254_P)
    xs = [x]
    for _ in range(n):
        x = x * x % BN254_P
        xs.append(x)
    wires = [1, xs[-1]] + xs[:-1]
    blob = b"".join(v.to_bytes(32, "little") for v in wires)
    return np.frombuffer(blob, dtype=np.uint8).reshape(n + 2, 32).copy()


def write_wtns(path: str, rows: np.ndarray) -> None:
    """(n_wires, 32) rows as a version-2 `.wtns`."""
    n = rows.shape[0]
    with open(path, "wb") as f:
        f.write(b"wtns" + struct.pack("<IIIQ", 2, 2, 1, 8 + 32))
        f.write(struct.pack("<I", 32) + BN254_P.to_bytes(32, "little") + struct.pack("<I", n))
        f.write(struct.pack("<IQ", 2, n * 32))
        f.write(np.ascontiguousarray(rows, dtype=np.uint8).tobytes())
