"""The root of a binary Merkle tree of Poseidon hashes over BN254's Fr, built
from the reference's compiled circom Poseidon circuit `poseidon3_test`
(`poseidon3_test.r1cs` beside this file, a copy of the reference's test
fixture): 234 constraints of padded widths 1 to 61, two inputs (its wires
2 and 3) and one output (its wire 1). The tree has 2^depth leaves, the
private inputs, and 2^depth - 1 copies of that circuit: each copy hashes
two leaves or the outputs of two copies of the level below, and the root's
output is the one public wire. Every constraint is the fixture's, term for
term; only the wire ids change.

Wires: 0 is 1, 1 the root, 2 .. 2^depth + 1 the leaves; then each copy
below the root has 234 of its own (its output, then the fixture's wires 4
to 236 in order), and the root the fixture's wires 4 to 236. The copies
come level by level from the leaves up, so the constraints are in the
order they are solved.

The witness: leaves drawn from the run's seed, then each copy's wires
solved from its constraints alone, with no witness calculator of circom's
(`_plan`): on the fixture's own inputs this gives its `.wtns`, wire for
wire."""

from __future__ import annotations

import functools
import os
import struct

import numpy as np

# every family has `write_wtns`: the worker mix writes its pool as .wtns files
from benchmark.circuits.squaring_chain import BN254_P, write_wtns  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "poseidon3_test.r1cs")
OUT, LEFT, RIGHT, FIRST_OWN = 1, 2, 3, 4  # the fixture's output, inputs, first own wire


@functools.lru_cache(maxsize=1)
def fixture():
    """(n_wires, constraints): each constraint three factors of (wire,
    coefficient) terms, read from the fixture's `.r1cs`."""
    with open(FIXTURE, "rb") as f:
        data = f.read()
    off, sections = 12, {}
    for _ in range(3):
        kind, size = struct.unpack_from("<IQ", data, off)
        sections[kind] = off + 12
        off += 12 + size
    h = sections[1]
    n_wires, n_out, n_in, _, _, n = struct.unpack_from("<IIIIQI", data, h + 36)
    assert (n_out, n_in) == (1, 2), "the fixture hashes two inputs into one output"
    off, constraints = sections[2], []
    for _ in range(n):
        factors = []
        for _ in range(3):
            (k,) = struct.unpack_from("<I", data, off)
            off += 4
            terms = []
            for _ in range(k):
                (w,) = struct.unpack_from("<I", data, off)
                terms.append((w, int.from_bytes(data[off + 4 : off + 36], "little")))
                off += 36
            factors.append(tuple(terms))
        constraints.append(tuple(factors))
    return n_wires, tuple(constraints)


def _sizes(sizes: dict) -> tuple[int, int]:
    """(copies, leaves), checking `n_constraints` against the depth."""
    leaves = 1 << sizes["depth"]
    copies = leaves - 1
    n_wires, constraints = fixture()
    if sizes["n_constraints"] != copies * len(constraints):
        raise ValueError(f"depth {sizes['depth']} gives {copies * len(constraints)} "
                         f"constraints, not {sizes['n_constraints']}")
    return copies, leaves


def _wire_maps(sizes: dict) -> np.ndarray:
    """(copies, fixture wires) global wire ids, copy by copy as the file
    orders them: copy c of level l hashes the outputs (or leaves) 2c and 2c + 1
    of the level below."""
    copies, leaves = _sizes(sizes)
    n_own = fixture()[0] - FIRST_OWN
    maps = np.zeros((copies, fixture()[0]), np.int64)
    below = np.arange(leaves) + 2  # the level below's outputs: the leaves
    nxt, c = 2 + leaves, 0
    while len(below) > 1:
        outs = []
        for j in range(len(below) // 2):
            root = len(below) == 2
            maps[c, LEFT], maps[c, RIGHT] = below[2 * j], below[2 * j + 1]
            if root:
                maps[c, OUT] = 1
            else:
                maps[c, OUT] = nxt
                nxt += 1
            maps[c, FIRST_OWN:] = np.arange(nxt, nxt + n_own)
            nxt += n_own
            outs.append(maps[c, OUT])
            c += 1
        below = np.array(outs)
    return maps


def write_r1cs(path: str, sizes: dict) -> None:
    copies, leaves = _sizes(sizes)
    maps = _wire_maps(sizes)
    n_w = int(maps.max()) + 1
    _, constraints = fixture()
    n = copies * len(constraints)
    header = struct.pack("<I", 32) + BN254_P.to_bytes(32, "little") + struct.pack(
        "<IIIIQI", n_w, 1, 0, leaves, n_w, n)
    one = bytearray()
    for factors in constraints:  # one copy's constraints with the fixture's wire ids
        for terms in factors:
            one += struct.pack("<I", len(terms))
            for w, c in terms:
                one += struct.pack("<I", w) + c.to_bytes(32, "little")
    words = np.frombuffer(bytes(one), dtype=np.uint8)
    # the byte offsets of the wire ids: after each factor's count, every 36 bytes
    at, off = [], 0
    for factors in constraints:
        for terms in factors:
            at += [off + 4 + 36 * t for t in range(len(terms))]
            off += 4 + 36 * len(terms)
    at = np.array(at)
    local = words[at[:, None] + np.arange(4)].view("<u4").reshape(-1).astype(np.int64)
    body = np.tile(words, (copies, 1))
    ids = np.ascontiguousarray(maps[:, local], "<u4").view(np.uint8).reshape(copies, len(at), 4)
    body[:, at[:, None] + np.arange(4)] = ids
    labels = np.arange(n_w, dtype="<u8").tobytes()
    with open(path, "wb") as f:
        f.write(b"r1cs" + struct.pack("<II", 1, 3))
        for kind, section in ((1, header), (2, body.tobytes()), (3, labels)):
            f.write(struct.pack("<IQ", kind, len(section)))
            f.write(section)


@functools.lru_cache(maxsize=1)
def _plan():
    """(order, inverse): how one copy's wires follow from its inputs. Each
    constraint i reads t_i = A_i * B_i = C_i, and C_i is linear in the
    wires; the fixture has as many constraints as wires to find, so with
    C's coefficients on those wires inverted, each wire is a fixed linear
    combination of the t_i (`inverse`: wire -> {i: coefficient}), and t_i
    is known once the wires of A_i and B_i are. `order` lists ("t", i) and
    ("w", wire) steps in an order where each step's inputs come first."""
    n_w, constraints = fixture()
    known = {0, LEFT, RIGHT}
    wires = [w for w in range(n_w) if w not in known]
    col = {w: j for j, w in enumerate(wires)}
    if len(wires) != len(constraints):
        raise ValueError("the fixture's constraints do not fix its wires")
    # rows of [C on the unknown wires | the identity], reduced to [I | C^-1]
    rows = []
    for i, (_, _, c) in enumerate(constraints):
        row = {}
        for w, v in c:
            if w in col:
                row[col[w]] = (row.get(col[w], 0) + v) % BN254_P
        rows.append((row, {i: 1}))
    free, pivot = set(range(len(rows))), {}
    for j in range(len(wires)):
        k = min((k for k in free if rows[k][0].get(j)),
                key=lambda k: len(rows[k][0]) + len(rows[k][1]))
        free.discard(k)
        inv = pow(rows[k][0][j], -1, BN254_P)
        rows[k] = tuple({c: v * inv % BN254_P for c, v in part.items()} for part in rows[k])
        for k2, other in enumerate(rows):
            f = other[0].get(j)
            if k2 == k or not f:
                continue
            for mine, theirs in zip(rows[k], other):
                for c, v in mine.items():
                    x = (theirs.get(c, 0) - f * v) % BN254_P
                    if x:
                        theirs[c] = x
                    else:
                        theirs.pop(c, None)
        pivot[j] = k
    inverse = {w: rows[pivot[j]][1] for w, j in col.items()}
    needs = [{w for f in factors[:2] for w, _ in f} - known for factors in constraints]
    order, have, done = [], set(known), set()
    while len(order) < 2 * len(wires):
        before = len(order)
        for i, need in enumerate(needs):
            if i not in done and need <= have:
                done.add(i)
                order.append(("t", i))
        for w in wires:
            if w not in have and inverse[w].keys() <= done:
                have.add(w)
                order.append(("w", w))
        if len(order) == before:
            raise ValueError("the fixture's wires depend on each other in a cycle")
    return tuple(order), inverse


def hash_wires(left: int, right: int) -> list:
    """Every wire of one copy of the fixture, hashing left and right."""
    p = BN254_P
    n_w, constraints = fixture()
    order, inverse = _plan()
    vals = [None] * n_w
    vals[0], vals[LEFT], vals[RIGHT] = 1, left % p, right % p
    t = {}
    for kind, x in order:
        if kind == "t":
            a, b, c = constraints[x]
            t[x] = (sum(v * vals[w] for w, v in a) * sum(v * vals[w] for w, v in b)
                    - sum(v * vals[w] for w, v in c if w in (0, LEFT, RIGHT))) % p
        else:
            vals[x] = sum(v * t[i] for i, v in inverse[x].items()) % p
    return vals


def witness(sizes: dict, rng) -> np.ndarray:
    """Leaves drawn from `rng`, the tree hashed from them, as (n_wires, 32)
    uint8 little-endian rows."""
    copies, leaves = _sizes(sizes)
    maps = _wire_maps(sizes)
    out = [0] * (int(maps.max()) + 1)
    out[0] = 1
    for j in range(leaves):
        out[2 + j] = rng.randrange(BN254_P)
    for c in range(copies):
        vals = hash_wires(out[maps[c, LEFT]], out[maps[c, RIGHT]])
        for w, g in enumerate(maps[c].tolist()):
            if w:
                out[g] = vals[w]
    blob = b"".join(v.to_bytes(32, "little") for v in out)
    return np.frombuffer(blob, dtype=np.uint8).reshape(len(out), 32).copy()
