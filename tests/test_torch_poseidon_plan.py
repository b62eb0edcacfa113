"""The arithmetic and the lane plan of `csrc/poseidon.cu`'s two forms,
modelled on the CPU in Python integers: no kernel runs here.

Both forms run the permutation's optimized form over `ops/poseidon.py`'s
`kernel_table` (decoded here from its limbs) in the radix-2^29 form
(`csrc/field.cuh`): every value 9 limbs of 29 bits, Montgomery for R' =
2^261; a product or a row's sum of products and of values shifted up 261
bits accumulates in 64-bit columns and one reduction (`redc29`,
`mont_sqr29`) leaves (t + m p) / 2^261, m < 2^261 the unique multiple that
clears the low limbs; no subtraction but the digest's one. The model holds
each value exactly as the kernel does, not only its residue mod p, and
beside it a worst-case bound carried through every operation from the
bounds of its operands (inputs any 256-bit value, constants below p),
asserting what the kernel relies on: every value below 2^261 (its 9 limbs),
every column below 2^64 (`redc29_limbs`, limb by limb), the digest below 2p
before its subtraction. On BLS12-381's Fr (p ~ 0.453 * 2^256, 2^261 =
70.66p) the largest is 58.9p: state[1] and state[2] of the thread form
across the partial rounds, each of which adds col0 x0 / R' + p to them.

The thread form (a thread a hash) is modelled round by round
(`thread_digest`, with its products and squarings counted: those of
`chip_smoke.POSEIDON_*_PRODUCTS`); `tests/test_torch_poseidon.py` holds it
against the host hash and the JAX package. The lane form (a group of 4
lanes a hash, 8 hashes a warp) is modelled lane by lane (`lane_level`):
which lane holds which state element, the entry each lane reads, each
shuffle's source lane and limb, the loads and stores of live groups only,
for 1, 3, 5, 8 and 33 hashes (a ragged last group and warp), against the
thread form and the plain PyTorch version. Exact equality throughout.
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch.fields.field import BLS12_381_FR as BLS
from stark_tpu_torch.fields.field import BN254_FR as BN
from stark_tpu_torch.ops import poseidon as pos

torch.set_num_threads(2)

P = BLS.p
NL = pos.LIMBS
M29 = (1 << 29) - 1
RP = 1 << 261  # R'
LANES, WARP = 4, 32
THREADS = 128  # the kernel's block: 32 lane groups, or 128 threads
EDGES = [0, 1, BN.p - 1, BLS.p - 1]
PINV = pow(P, -1, RP)
IN_MAX = (1 << 256) - 1  # an input word column: any 256-bit value


def limbs(x: int) -> list[int]:
    assert 0 <= x < RP
    return [(x >> 29 * i) & M29 for i in range(NL)]


def entries() -> list[int]:
    """`kernel_table`'s entries decoded from their limbs (padding zero)."""
    tab = pos.kernel_table()
    w = pos.ENTRY_WORDS
    assert len(tab) == w * pos.TABLE_ENTRIES
    rows = [tab[w * k : w * k + w] for k in range(pos.TABLE_ENTRIES)]
    assert all(all(x == 0 for x in r[NL:]) and all(x <= M29 for x in r[:NL]) for r in rows)
    return [sum(x << 29 * i for i, x in enumerate(r[:NL])) for r in rows]


def redc_value(t: int) -> int:
    """(t + m p) / 2^261, m < 2^261 the multiple that clears t's low 261 bits."""
    return (t + (-t * PINV % RP) * P) >> 261


class V:
    """A value as the kernel holds it, and its worst-case bound."""

    def __init__(self, v: int, top: int):
        assert 0 <= v <= top < RP
        self.v, self.top = v, top


def const(v: int) -> V:
    return V(v, P - 1)


class Arith:
    """The kernel's operations on exact values and their bounds, counting
    products and squarings; `worst` keeps the largest bound of each kind."""

    def __init__(self):
        self.products = self.squarings = 0
        self.worst: dict[str, int] = {}

    def note(self, kind: str, x: V) -> V:
        self.worst[kind] = max(self.worst.get(kind, 0), x.top)
        return x

    @staticmethod
    def reduce(t: int, t_top: int) -> V:
        """`redc29` of a column sum t (at most t_top)."""
        return V(redc_value(t), (t_top + (RP - 1) * P) >> 261)

    def mul(self, a: V, b: V, square: bool = False) -> V:
        if square:
            assert a is b
            self.squarings += 1
        else:
            self.products += 1
        return self.reduce(a.v * b.v, a.top * b.top)

    def sbox(self, x: V) -> V:
        """`mont_sqr29` twice, then the product by x."""
        y = self.mul(x, x, square=True)
        z = self.mul(y, y, square=True)
        return self.note("sbox", self.mul(z, x))

    def row(self, terms, shifted) -> V:
        """A row's sum: `terms` (table entry, value) products, `shifted`
        values times 2^261, reduced once."""
        t = sum(c * y.v for c, y in terms) + sum(k.v << 261 for k in shifted)
        t_top = sum((P - 1) * y.top for _, y in terms) + sum(k.top << 261 for k in shifted)
        for c, _ in terms:
            assert 0 <= c < P
        assert len(terms) <= 3  # a column: <= 27 products, 9 of the reduction
        self.products += len(terms)
        return self.note("row", self.reduce(t, t_top))

    def digest(self, x: V) -> int:
        """The digest below 2p, less p where it is not below: canonical."""
        assert self.note("digest", x).top < 2 * P
        return x.v - P if x.v >= P else x.v


def redc29_limbs(t: list[int]) -> list[int]:
    """`redc29` limb by limb on 18 columns, each asserted below 2^64."""
    t = list(t)
    p29 = limbs(P)
    np29 = -pow(P, -1, 1 << 29) % (1 << 29)
    for i in range(NL):
        m = (t[i] * np29) & M29
        for j in range(NL):
            t[i + j] += m * p29[j]
            assert t[i + j] < 1 << 64
        t[i + 1] += t[i] >> 29
        assert t[i + 1] < 1 << 64
    c, r = 0, []
    for i in range(NL):
        c += t[NL + i]
        r.append(c & M29)
        c >>= 29
    assert c == 0
    return r


def round0_input(x: int, c: int) -> V:
    """An input word column plus round 0's constant, lazy."""
    assert 0 <= x <= IN_MAX
    return V(x + c, IN_MAX + P - 1)


def thread_digest(left: int, right: int, leaf: bool, ar: Arith | None = None) -> int:
    """`poseidon_kernel<PAIRS, false>`: one thread, the rounds in order."""
    e = entries()
    ar = ar or Arith()
    xs = [ar.sbox(round0_input(left, e[pos.E_IN]))]
    if not leaf:
        xs.append(ar.sbox(round0_input(right, e[pos.E_IN + 1])))
    c0 = pos.E_C0L if leaf else pos.E_C0P
    s = [ar.row([(e[pos.E_K0 + 2 * j + i], x) for i, x in enumerate(xs)], [const(e[c0 + j])])
         for j in range(3)]

    def full(s, m, nx):
        x = [ar.sbox(v) for v in s]
        return [ar.row([(e[m + 3 * j + i], x[i]) for i in range(3)], [const(e[nx + j])])
                for j in range(3)]

    for r in (1, 2, 3):
        s = full(s, pos.E_PRE if r == 3 else pos.E_MDS, pos.E_NXT1 + 3 * (r - 1))
    for r in range(pos.HALF, pos.LAST_PARTIAL + 1):
        b = pos.E_PART + len(pos.PART_SLOTS) * (r - pos.HALF)
        last = r == pos.LAST_PARTIAL
        x0 = ar.sbox(s[0])
        s = [ar.row([(e[b], x0), (e[b + 1], s[1]), (e[b + 2], s[2])], [const(e[b + 5])]),
             ar.row([(e[b + 3], x0)], [s[1]] + ([const(e[pos.E_NXT2 + 1])] if last else [])),
             ar.row([(e[b + 4], x0)], [s[2]] + ([const(e[pos.E_NXT2 + 2])] if last else []))]
        ar.note("state12", s[1])
        ar.note("state12", s[2])
    for r in range(pos.LAST_PARTIAL + 1, pos.LAST_ROUND):
        s = full(s, pos.E_MDS, pos.E_NXT2 + 3 * (r - pos.LAST_PARTIAL))
    x = [ar.sbox(v) for v in s]
    return ar.digest(ar.row([(e[pos.E_OUT + i], x[i]) for i in range(3)], []))


class Warp:
    """One warp of `poseidon_kernel<PAIRS, true>`: 8 groups of 4 lanes, lane
    L in group L / 4 as member L % 4; member i < 3 holds state[i], member 3
    repeats member 0. Every lane runs every step (one instruction stream);
    `shfl` is `__shfl_sync(FULL, v, src, 4)` limb by limb, logged."""

    def __init__(self, first_hash: int, n: int):
        self.members = [lane % LANES for lane in range(WARP)]
        self.rows = [0 if m == 3 else m for m in self.members]
        self.hashes = [first_hash + lane // LANES for lane in range(WARP)]
        self.live = [h < n for h in self.hashes]
        self.log: list[tuple[int, int, int]] = []  # (lane, source lane, limb)

    def shfl(self, vals: list[V], src: int) -> list[V]:
        out = []
        for lane in range(WARP):
            source = (lane & ~(LANES - 1)) | src
            ls = limbs(vals[source].v)
            for k in range(NL):
                self.log.append((lane, source, k))
            out.append(V(sum(x << 29 * i for i, x in enumerate(ls)), vals[source].top))
        return out


def lane_level(cols: list[int], n: int, pairs: bool) -> tuple[list[int], dict]:
    """A level of n hashes in the lane form over the input columns `cols`
    (2n for pairs, n leaves): the n digests, and what the model saw (reads,
    writes, shuffles, the state each live member held after round 0, and the
    worst bounds)."""
    e = entries()
    ar = Arith()
    digest_words = [[None] * 8 for _ in range(n)]
    seen = {"reads": [], "writes": [], "shuffles": [], "round0": {}}
    warps = -(-n // (WARP // LANES))
    blocks = -(-n // (THREADS // LANES))
    assert warps <= blocks * THREADS // WARP  # the grid's warps past n return at once
    for wi in range(warps):
        wp = Warp(wi * WARP // LANES, n)

        def read(col: int) -> int:
            assert 0 <= col < len(cols)
            seen["reads"].append(col)
            return cols[col]

        # round 0: members 1 (and 2 for pairs) of live groups load and add
        # their constant; the others S-box 0
        v = []
        for lane in range(WARP):
            m, h = wp.members[lane], wp.hashes[lane]
            if wp.live[lane] and (m == 1 or (pairs and m == 2)):
                v.append(round0_input(read(2 * h + m - 1 if pairs else h), e[pos.E_IN + m - 1]))
            else:
                v.append(V(0, 0))
        x = [ar.sbox(a) for a in v]
        ys = [wp.shfl(x, 1)] + ([wp.shfl(x, 2)] if pairs else [])
        c0 = pos.E_C0P if pairs else pos.E_C0L
        s = [ar.row([(e[pos.E_K0 + 2 * wp.rows[lane] + i], y[lane]) for i, y in enumerate(ys)],
                    [const(e[c0 + wp.rows[lane]])]) for lane in range(WARP)]
        for lane in range(WARP):
            if wp.live[lane]:
                seen["round0"][(wp.hashes[lane], wp.members[lane])] = s[lane].v

        def full(s, m, nx):
            x = [ar.sbox(a) for a in s]
            y = [wp.shfl(x, i) for i in range(3)]
            return [ar.row([(e[m + 3 * wp.rows[lane] + i], y[i][lane]) for i in range(3)],
                           [const(e[nx + wp.rows[lane]])]) for lane in range(WARP)]

        for r in (1, 2, 3):
            s = full(s, pos.E_PRE if r == 3 else pos.E_MDS, pos.E_NXT1 + 3 * (r - 1))
        for r in range(pos.HALF, pos.LAST_PARTIAL + 1):
            b = pos.E_PART + len(pos.PART_SLOTS) * (r - pos.HALF)
            last = r == pos.LAST_PARTIAL
            x = [ar.sbox(a) for a in s]
            u = [x[lane] if wp.rows[lane] == 0 else s[lane] for lane in range(WARP)]
            y = [wp.shfl(u, i) for i in range(3)]
            new = []
            for lane in range(WARP):
                row = wp.rows[lane]
                ent = ([b, b + 1, b + 2] if row == 0 else
                       [b + 2 + row] + ([pos.E_ONE, pos.E_ZERO] if row == 1
                                        else [pos.E_ZERO, pos.E_ONE]))
                nxt = b + 5 if row == 0 else (pos.E_NXT2 + row if last else pos.E_ZERO)
                new.append(ar.row([(e[ent[i]], y[i][lane]) for i in range(3)],
                                  [const(e[nxt])]))
            s = new
        for r in range(pos.LAST_PARTIAL + 1, pos.LAST_ROUND):
            s = full(s, pos.E_MDS, pos.E_NXT2 + 3 * (r - pos.LAST_PARTIAL))
        x = [ar.sbox(a) for a in s]
        y = [wp.shfl(x, i) for i in range(3)]
        out = [ar.digest(ar.row([(e[pos.E_OUT + i], y[i][lane]) for i in range(3)], []))
               for lane in range(WARP)]
        # member m of a live group stores digest words 2m and 2m + 1
        for lane in range(WARP):
            if wp.live[lane]:
                h, m = wp.hashes[lane], wp.members[lane]
                for w in (2 * m, 2 * m + 1):
                    seen["writes"].append((h, w))
                    digest_words[h][w] = (out[lane] >> 32 * w) & 0xFFFFFFFF
        seen["shuffles"] += wp.log
    seen["worst"] = ar.worst
    return [sum(w << 32 * k for k, w in enumerate(ws)) for ws in digest_words], seen


def _values(n: int, seed: int, bound: int) -> list[int]:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % bound for _ in range(n)]
    return (EDGES + vals)[:n] if n > 1 else vals


def _plain(left: list[int], right: list[int]) -> list[int]:
    """`poseidon_hash_pairs_plain` on the values (any below 2^256)."""
    L = BLS.num_limbs

    def planes(vals):
        return torch.tensor([[(v >> 16 * k) & 0xFFFF for v in vals] for k in range(L)],
                            dtype=torch.int32)

    out = pos.poseidon_hash_pairs_plain(BLS, planes(left), planes(right))
    return [sum(int(out[k, i]) << 16 * k for k in range(L)) for i in range(len(left))]


@pytest.mark.parametrize("n", [1, 3, 5, 8, 33])
@pytest.mark.parametrize("pairs", [True, False], ids=["pairs", "leaves"])
def test_lane_form_models_the_thread_form(n, pairs):
    cols = _values(2 * n if pairs else n, 40 + n, BLS.p if pairs else BN.p)
    got, seen = lane_level(cols, n, pairs)
    if pairs:
        want = [thread_digest(cols[2 * i], cols[2 * i + 1], False) for i in range(n)]
    else:
        want = [thread_digest(v, 0, True) for v in cols]
    assert got == want
    # each input column read once, by its own group; each output word written once
    assert sorted(seen["reads"]) == list(range(len(cols)))
    assert sorted(seen["writes"]) == [(h, w) for h in range(n) for w in range(8)]
    # every shuffle reads a lane of its own group holding state 0-2, all 9 limbs
    for lane, source, _ in seen["shuffles"]:
        assert source // LANES == lane // LANES and source % LANES < 3
    assert {k for _, _, k in seen["shuffles"]} == set(range(NL))
    # after round 0, member i of a hash holds state[i] (the thread form's)
    e = entries()
    for h in range(n):
        left, right = (cols[2 * h], cols[2 * h + 1]) if pairs else (cols[h], 0)
        ar = Arith()
        xs = [ar.sbox(round0_input(left, e[pos.E_IN]))]
        if pairs:
            xs.append(ar.sbox(round0_input(right, e[pos.E_IN + 1])))
        c0 = pos.E_C0P if pairs else pos.E_C0L
        for j in range(3):
            want0 = ar.row([(e[pos.E_K0 + 2 * j + i], x) for i, x in enumerate(xs)],
                           [const(e[c0 + j])])
            assert seen["round0"][(h, j)] == want0.v
        assert seen["round0"][(h, 3)] == seen["round0"][(h, 0)]
    assert max(seen["worst"].values()) < 4 * P  # the lane form's rows keep no growth


def test_both_forms_take_non_canonical_inputs_as_the_plain_version():
    """Inputs at and above p (up to 2^256 - 1) reduce as the plain version's
    product by R^2 reduces them."""
    left = [P, 2 * P - 1, (1 << 256) - 1, 2 * P + 5]
    right = [(1 << 256) - 1, P + 1, 0, 3]
    want = _plain(left, right)
    assert [thread_digest(a, b, False) for a, b in zip(left, right)] == want
    got, _ = lane_level([v for ab in zip(left, right) for v in ab], 4, True)
    assert got == want


def test_lazy_bounds_on_bls12_381():
    """Worst-case bounds over any inputs (the thread form's, carried through
    every operation from 256-bit inputs and constants below p): every value
    below 2^261, the digest below 2p; and the columns of the largest sum,
    three products of all-ones limbs and a shifted value, below 2^64 through
    `redc29` (here with constants below p, as the table's are)."""
    ar = Arith()
    thread_digest(IN_MAX, IN_MAX, False, ar)
    worst = {k: v / P for k, v in ar.worst.items()}
    assert RP / P > 70.66 and worst["state12"] < 58.9 and worst["digest"] < 1.05
    assert max(ar.worst.values()) < RP
    assert 4 * P > 1 << 256  # no BN254 headroom: p is 0.45 * 2^256
    # the columns: 3 terms of 9 x 9 limb products, a shifted value, REDC
    t = [0] * (2 * NL)
    for _ in range(3):
        c, y = limbs(P - 1), [M29] * NL
        for i in range(NL):
            for j in range(NL):
                t[i + j] += c[i] * y[j]
    for i in range(NL):
        t[NL + i] += M29 >> 1
    assert max(t) < 1 << 63
    got = redc29_limbs(t)
    value = sum(x << 29 * i for i, x in enumerate(got))
    assert value == redc_value(sum(x << 29 * i for i, x in enumerate(t)))


def test_redc29_limbs_is_the_value_model():
    """`redc29` limb by limb equals the model's (t + m p) / 2^261 on seeded
    sums of three products and a shifted value."""
    rng = np.random.default_rng(7)
    for _ in range(50):
        vals = [int.from_bytes(rng.bytes(33), "little") % (40 * P) for _ in range(7)]
        t = [0] * (2 * NL)
        total = 0
        for c, y in zip(vals[:3], vals[3:6]):
            c %= P
            total += c * y
            lc, ly = limbs(c), limbs(y)
            for i in range(NL):
                for j in range(NL):
                    t[i + j] += lc[i] * ly[j]
        k = vals[6] % P
        total += k << 261
        for i, x in enumerate(limbs(k)):
            t[NL + i] += x
        got = redc29_limbs(t)
        assert sum(x << 29 * i for i, x in enumerate(got)) == redc_value(total)


def test_counts_and_entries():
    """The thread form's products and squarings are `chip_smoke`'s bound's;
    the table's entries are canonical and the identity entries what the lane
    form's partial rounds need."""
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    chip_smoke = importlib.import_module("chip_smoke")
    for leaf, want in ((False, chip_smoke.POSEIDON_PAIR_PRODUCTS),
                       (True, chip_smoke.POSEIDON_LEAF_PRODUCTS)):
        ar = Arith()
        thread_digest(5, 0 if leaf else 7, leaf, ar)
        assert (ar.products, ar.squarings) == want
    e = entries()
    assert all(0 <= v < P for v in e)
    assert e[pos.E_ONE] == RP % P and e[pos.E_ZERO] == 0
    assert pos.TABLE_ENTRIES * pos.ENTRY_WORDS * 4 <= 48 * 1024  # static shared memory


def test_kernel_source_mirrors_the_layout():
    """`csrc/poseidon.cu`'s constants of the table's layout and of the lane
    form are `ops/poseidon.py`'s."""
    import os
    import re

    path = os.path.join(os.path.dirname(pos.__file__), os.pardir, "csrc", "poseidon.cu")
    with open(path) as f:
        src = f.read()
    consts = dict(re.findall(r"\b([A-Z][A-Z0-9_]*) = (\d+)\b", src))
    for name in ("E_IN", "E_K0", "E_C0P", "E_C0L", "E_MDS", "E_PRE", "E_NXT1", "E_NXT2",
                 "E_PART", "ENTRY_WORDS", "LANES"):
        assert int(consts[name]) == getattr(pos, name), name
    assert int(consts["PART_SLOTS"]) == len(pos.PART_SLOTS)
    assert int(consts["THREADS"]) == THREADS
    assert "E_ONE = E_OUT + T, E_ZERO = E_ONE + 1, ENTRIES = E_ZERO + 1" in src
    assert pos.E_OUT == pos.E_PART + len(pos.PART_SLOTS) * pos.PARTIAL_ROUNDS


def test_width_constant_picks_the_form(monkeypatch):
    """The wrappers launch the lane form below `LANE_FORM_BELOW` hashes and
    the thread form at and above it (the C entry point's `lanes` argument),
    counting either launch; the launch goes to a stand-in library."""
    from stark_tpu_torch.ops import build, field_cuda

    calls = []

    class Lib:
        def __getattr__(self, name):
            def entry(src, out, n, ld, table, lanes, words, np32, stream):
                calls.append((name, n, ld, lanes))
                return 0
            return entry

    monkeypatch.setattr(build, "load", lambda: Lib())
    monkeypatch.setattr(field_cuda, "cuda_args", lambda spec, t: (None, 0, 0))
    monkeypatch.setattr(pos, "_device_table", lambda device: torch.empty(0))
    w = pos.LANE_FORM_BELOW
    before = (pos.poseidon_pairs.launches, pos.poseidon_leaves.launches)
    for n in (1, w - 1, w, 2 * w):
        pos.poseidon_pairs(torch.empty((8, 2 * n), dtype=torch.int32, device="meta"))
        pos.poseidon_leaves(torch.empty((16, n), dtype=torch.int32, device="meta"))
    assert calls == [c for n in (1, w - 1, w, 2 * w) for c in (
        ("stark_poseidon_pairs", n, 2 * n, int(n < w)),
        ("stark_poseidon_leaves", n, n, int(n < w)))]
    assert (pos.poseidon_pairs.launches - before[0],
            pos.poseidon_leaves.launches - before[1]) == (4, 4)
    assert [pos.lane_form(n) for n in (1, w - 1, w)] == [True, True, False]
