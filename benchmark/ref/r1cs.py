"""circom `.r1cs` and `.wtns` files: the plain reference's readers and its
arithmetization. They follow `circom2bellman_core/src/reader.rs:4-89` and
`r1cs-stark/src/run.rs:109-308, 390-419`, vectorized with NumPy: one slot a
term, a constraint taking max(|A|, |B|, |C|) slots in each region, padded
with the last wire at coefficient 0; P the running sum of coefficient times
witness within a constraint; the copy permutation chains each wire's uses
in the order constraint, region, term.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from benchmark.ref.field import Field


def read_r1cs(data: bytes) -> dict:
    if data[:4] != b"r1cs" or struct.unpack_from("<II", data, 4) != (1, 3):
        raise ValueError("not a version-1 .r1cs of three sections")
    off, sections = 12, {}
    for _ in range(3):
        kind, size = struct.unpack_from("<IQ", data, off)
        sections[kind] = (off + 12, size)
        off += 12 + size
    h = sections[1][0]
    (field_size,) = struct.unpack_from("<I", data, h)
    prime = data[h + 4 : h + 36]
    n_wires, n_out, n_in, n_priv, n_labels, n_constraints = struct.unpack_from(
        "<IIIIQI", data, h + 36)
    # one (offset, length) a factor, in file order
    off, size = sections[2]
    buf = np.frombuffer(data, dtype=np.uint8)
    nf = 3 * n_constraints
    width = (size // nf - 4) // 36 if nf and size % nf == 0 else -1
    starts = off + 4 + np.arange(nf, dtype=np.int64) * (4 + 36 * width)
    if width >= 0 and (buf[starts[:, None] - 4 + np.arange(4)].view("<u4") == width).all():
        lens = np.full(nf, width, np.int64)  # every factor of one width: no walk
    else:
        starts, lens = np.empty(nf, np.int64), np.empty(nf, np.int64)
        frm = int.from_bytes
        for f in range(nf):
            k = frm(data[off : off + 4], "little")
            starts[f], lens[f] = off + 4, k
            off += 4 + 36 * k
    term_fac = np.repeat(np.arange(3 * n_constraints), lens)
    first = np.cumsum(lens) - lens
    term_pos = starts[term_fac] + 36 * (np.arange(len(term_fac)) - first[term_fac])
    wires = buf[term_pos[:, None] + np.arange(4)].view("<u4").reshape(-1).astype(np.int64)
    values = buf[term_pos[:, None] + 4 + np.arange(32)]
    return {"field_size": field_size, "prime": prime, "n_wires": n_wires,
            "n_public_outputs": n_out, "n_public_inputs": n_in, "n_constraints": n_constraints,
            "factor_lens": lens.reshape(n_constraints, 3), "factor_first": first.reshape(
                n_constraints, 3), "wires": wires, "values": values}


def read_wtns(data: bytes) -> np.ndarray:
    """(n_wires, 32) uint8 rows of a version-2 `.wtns` with 32-byte values."""
    if data[:4] != b"wtns":
        raise ValueError("not a .wtns")
    (size,) = struct.unpack_from("<I", data, 24)
    (n,) = struct.unpack_from("<I", data, 28 + size)
    start = 28 + size + 4 + 12
    return np.frombuffer(data, dtype=np.uint8, count=32 * n, offset=start).reshape(n, 32)


def arithmetize(F: Field, r1cs: dict, witness: torch.Tensor) -> dict:
    """witness: (10, n_wires) Montgomery. Returns the trace columns as
    (10, 3 a) tensors and the host-side permutation and public indices."""
    lens, first = r1cs["factor_lens"], r1cs["factor_first"]
    n_wires, nc = r1cs["n_wires"], r1cs["n_constraints"]
    ncoeff = lens.max(axis=1)
    end = np.cumsum(ncoeff)
    base = end - ncoeff
    a_len = int(end[-1])
    slot_c = np.repeat(np.arange(nc), ncoeff)
    slot_k = np.arange(a_len) - base[slot_c]
    wire = np.empty((3, a_len), np.int64)
    term = np.full((3, a_len), -1, np.int64)
    for r in range(3):
        has = slot_k < lens[slot_c, r]
        term[r, has] = first[slot_c[has], r] + slot_k[has]
        wire[r] = np.where(has, r1cs["wires"][np.maximum(term[r], 0)], n_wires - 1)
    dev = witness.device
    wire_flat = torch.from_numpy(wire.reshape(-1)).to(dev)
    w = witness[:, wire_flat]
    vals = np.zeros((3 * a_len, 32), np.uint8)
    has = term.reshape(-1) >= 0
    vals[has] = r1cs["values"][term.reshape(-1)[has]]
    coeff = F.from_bytes(torch.from_numpy(vals).to(dev))
    prod = F.mul(coeff, w)
    trace = prod
    k_flat = torch.from_numpy(np.tile(slot_k, 3)).to(dev)
    for d in range(1, int(ncoeff.max())):
        # running sum within the constraint: slot s adds the product d back
        add = torch.zeros_like(prod)
        add[:, d:] = prod[:, :-d]
        trace = F.reduce(trace + add * (k_flat >= d).to(torch.int64))
    # the copy permutation: each wire's uses in the order (constraint,
    # region, term); a use points at the one before, the first at the last
    glob = (np.arange(3)[:, None] * a_len + np.arange(a_len)[None, :]).reshape(-1)
    c3 = np.tile(slot_c, 3)
    r3 = np.repeat(np.arange(3), a_len)
    order = np.lexsort((np.tile(slot_k, 3), r3, c3, wire.reshape(-1)))
    sw = wire.reshape(-1)[order]
    sg = glob[order]
    start = np.r_[True, sw[1:] != sw[:-1]]
    group_end = np.r_[np.nonzero(start)[0][1:], len(sw)] - 1
    gid = np.cumsum(start) - 1
    prev = np.r_[sg[-1], sg[:-1]]
    prev[start] = sg[group_end[gid[start]]]
    permuted = np.empty(3 * a_len, np.int64)
    permuted[sg] = prev
    flag1 = np.ones(3 * a_len, np.int64)
    k1 = end % a_len  # (last + 1) % a_len of each constraint
    for r in range(3):
        flag1[k1 + r * a_len] = 0
    flag2 = np.zeros(3 * a_len, np.int64)
    flag2[end - 1] = 1
    n_pub = 1 + r1cs["n_public_inputs"] + r1cs["n_public_outputs"]
    firsts = sg[start]
    public_first = [(int(wv), int(g)) for wv, g in zip(sw[start], firsts) if wv < n_pub]
    return {"witness": w, "trace": trace, "coeff": coeff, "flag1": flag1, "flag2": flag2,
            "permuted": permuted, "public_first": public_first, "n_pub": n_pub,
            "original_steps": 3 * a_len}
