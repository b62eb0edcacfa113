"""Parsers for circom `.r1cs` and `.wtns` binary files.

Host-side I/O replacing the reference's `circom2bellman_core`
(`packages/circom2bellman_core/src/reader.rs:4-89`) and
witness reader (`r1cs-stark/src/reader.rs:7-42`). The data model mirrors the
reference's serde structs (`r1csfile.rs:4-58`) so the golden-file JSON test
(`compute.r1cs.json`) can be checked field-for-field.

Both readers refuse what the C++ readers of `native/stark_host.cpp` refuse,
each with `ValueError`: a bad magic, version or section layout, a file that
ends before its last value, and a field size other than 32 bytes. (The JAX
package's copies return short values from a file that ends early and read
any field size.)
"""

from __future__ import annotations

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

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def take(self, n: int) -> bytes:
        v = self.data[self.pos : self.pos + n]
        if len(v) != n:
            raise ValueError(f"the file ends at byte {len(self.data)}, inside a value "
                             f"at byte {self.pos}")
        self.pos += n
        return v


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _field_size(c: _Cursor) -> int:
    field_size = c.u32()
    _expect(field_size == 32, f"field size {field_size}: only 32-byte field elements "
            "(BN254's Fr) are read")
    return field_size


def read_r1cs(data: bytes) -> R1csContents:
    """iden3 .r1cs format, matching the reference's assumptions
    (version 1, exactly 3 sections, header then constraints; the
    wire2label section is ignored -- reader.rs:71-81)."""
    c = _Cursor(data)
    _expect(c.u32() == int.from_bytes(b"r1cs", "little"), "bad r1cs magic")
    version = c.u32()
    _expect(version == 1, "unsupported r1cs version")
    _expect(c.u32() == 3, "expected 3 sections")

    _expect(c.u32() == 1, "expected header section")
    c.u64()  # section size
    field_size = _field_size(c)
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

    _expect(c.u32() == 2, "expected constraint section")
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
    _expect(c.u32() == 1936618615, "bad wtns magic")  # reader.rs:11
    for _ in range(5):
        c.u32()
    field_size = _field_size(c)
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
