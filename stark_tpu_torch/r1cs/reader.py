"""Parsers for circom `.r1cs` and `.wtns` binary files.

Host-side I/O replacing the reference's `circom2bellman_core`
(`packages/circom2bellman_core/src/reader.rs:4-89`) and
witness reader (`r1cs-stark/src/reader.rs:7-42`). The data model mirrors the
reference's serde structs (`r1csfile.rs:4-58`) so the golden-file JSON test
(`compute.r1cs.json`) can be checked field-for-field.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


@dataclass
class Coefficient:
    wire_id: int
    value: bytes  # 32 bytes little-endian


@dataclass
class Factor:
    n_coefficient: int
    coefficients: list[Coefficient]


@dataclass
class Constraint:
    factors: list[Factor]  # exactly 3: A, B, C


@dataclass
class Header:
    field_size: int
    prime_number: bytes  # 32 bytes little-endian
    n_wires: int
    n_public_outputs: int
    n_public_inputs: int
    n_private_inputs: int
    n_labels: int
    n_constraints: int


@dataclass
class R1csContents:
    version: int
    header: Header
    constraints: list[Constraint] = field(default_factory=list)


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.data, self.pos)
        self.pos += 8
        return v

    def take(self, n: int) -> bytes:
        v = self.data[self.pos : self.pos + n]
        self.pos += n
        return v


def read_r1cs(data: bytes) -> R1csContents:
    """iden3 .r1cs format, matching the reference's assumptions
    (version 1, exactly 3 sections, header then constraints; the
    wire2label section is ignored -- reader.rs:71-81)."""
    c = _Cursor(data)
    magic = c.u32()
    assert magic == int.from_bytes(b"r1cs", "little"), "bad r1cs magic"
    version = c.u32()
    assert version == 1, "unsupported r1cs version"
    n_section = c.u32()
    assert n_section == 3, "expected 3 sections"

    section_type = c.u32()
    assert section_type == 1, "expected header section"
    c.u64()  # section size
    field_size = c.u32()
    prime_number = c.take(32)
    n_wires = c.u32()
    n_public_outputs = c.u32()
    n_public_inputs = c.u32()
    n_private_inputs = c.u32()
    n_labels = c.u64()
    n_constraints = c.u32()
    header = Header(
        field_size=field_size,
        prime_number=prime_number,
        n_wires=n_wires,
        n_public_outputs=n_public_outputs,
        n_public_inputs=n_public_inputs,
        n_private_inputs=n_private_inputs,
        n_labels=n_labels,
        n_constraints=n_constraints,
    )

    section_type = c.u32()
    assert section_type == 2, "expected constraint section"
    c.u64()  # section size
    constraints = []
    for _ in range(n_constraints):
        factors = []
        for _ in range(3):
            n_coeff = c.u32()
            coeffs = []
            for _ in range(n_coeff):
                wire_id = c.u32()
                value = c.take(32)
                coeffs.append(Coefficient(wire_id, value))
            factors.append(Factor(n_coeff, coeffs))
        constraints.append(Constraint(factors))

    return R1csContents(version=version, header=header, constraints=constraints)


def read_witness(data: bytes) -> list[bytes]:
    """circom .wtns: magic 'wtns', field-size-prefixed LE limbs per wire.

    Returns minimal-length little-endian byte strings per wire, exactly like
    the reference (BigUint::to_bytes_le -- r1cs-stark/src/reader.rs:38)."""
    c = _Cursor(data)
    magic = c.u32()
    assert magic == 1936618615, "bad wtns magic"  # reader.rs:11
    for _ in range(5):
        c.u32()
    field_size = c.u32()
    c.take(field_size)  # field order (unused beyond advancing)
    n_wires = c.u32()
    c.u32()  # n_constraints slot
    c.u32()
    c.u32()
    out = []
    for _ in range(n_wires):
        raw = c.take(field_size)
        val = int.from_bytes(raw, "little")
        nbytes = max(1, (val.bit_length() + 7) // 8)
        out.append(val.to_bytes(nbytes, "little"))
    return out
