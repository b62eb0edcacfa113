"""A model of `csrc/ntt.cu butterfly_fused_shoup_kernel` on the CPU, where no
kernel runs: its schedule in numpy and its values on python ints, held to
`ops/ntt.py butterfly_fused_shoup_plain`, which `test_torch_ntt_shoup*.py`
hold to the JAX package.

- The schedule (`Schedule`): a cluster of two CTAs a block (one CTA of 512
  threads for a block of 2), each CTA's h = block / cs elements in two
  word-major exchange buffers at the XOR-swizzled columns `fb_col`; each
  thread's 4 elements in registers, two stages a round (l-ascending rounds
  of stages 2^s0, 2^(s0+1), the last a single stage when log2(h) is odd),
  then the stage of stride h across the pair. Each round reads every
  element once and writes every element once; a warp's accesses to a word
  plane are free of bank conflicts.
- The staged table: the table of stage ls = h / 2 (rows ls - 1 .. 2 ls - 2
  of the (block - 1, 16) table) in the radix-2^29 layout, five planes of
  16 bytes at `tw_pos` (104 KB a CTA with the buffers at block 2048, two
  CTAs an SM); stage l reads tw_l[k] as entry k (ls / l). Each
  quarter-warp's 16-byte loads of every stage fall into distinct bank
  groups or share an address; in the round of l = 1, 2, where the kernel
  takes the twiddle 1 without a product, every lane of a warp reads the
  same entry.
- The values: the exact Shoup quotient on python ints, the product by the
  twiddle 1 as the kernel takes it (x - p where x >= c1, else x), sums and
  differences lazy in [0, 2p) with their carry, `canon` on the last stage
  in execution order. Every intermediate value is asserted below 2p. The
  model equals the plain version on BN254's and BLS12-381's scalar fields
  at blocks 2, 4, 16, 1024 and 2048, dit and dif, canon on and off, on two
  blocks of values from a numpy seed with 0, 1, R mod p, p - 1, p and
  2p - 1 among them.
- The arithmetic limb by limb: `shoup_mul29` (the 17 columns of wp x
  normalised, q from their bits 256 up, the 9 low columns of
  w x + q (2^261 - p)), every column asserted below 2^64, and the word
  form's `shoup_mul_chain` (the probe script's yardstick: a 9-word window
  of rows for q, the low-half products as triangular carry chains, one
  subtraction) as its PTX states it, every dropped carry asserted 0, both
  equal to the exact Shoup product on edge and random operands; the
  host's `div_pow2_256` bit by bit, giving wp1 = floor(2^256 / p) and
  c1 = ceil(2^256 / wp1); the product by 1 equal to the Shoup product for
  every x below 2p, around c1 too.

Tolerance: exact equality.
"""

import os
import re

import numpy as np
import pytest
import torch

from stark_tpu_torch.fields.field import BLS12_381_FR, BN254_FR
from stark_tpu_torch.ops import ntt

torch.set_num_threads(2)

FIELDS = {"bn254": BN254_FR, "bls12_381": BLS12_381_FR}
NTT_CU = os.path.join(os.path.dirname(ntt.__file__), os.pardir, "csrc", "ntt.cu")
M32 = (1 << 32) - 1
NW = 8
FB_EPT = 4       # `csrc/ntt.cu`: elements a thread
FB_THREADS = 512  # threads of a block's CTAs together
WARP = 32


def test_constants_match_the_source():
    src = open(NTT_CU).read()
    consts = dict(re.findall(r"constexpr int (FB_\w+) = ([^;]+);", src))
    assert consts["FB_EPT"].split()[0] == str(FB_EPT)
    assert consts["FB_MAX_LOG"].split()[0] == "11"
    assert consts["FB_THREADS"] == "(1 << FB_MAX_LOG) / FB_EPT"
    assert "return e ^ (((e >> 3) ^ (e >> 6)) & 7);" in src  # tw_pos
    assert "return i ^ (((i >> 5) & 1) * 5) ^ (((i >> 6) & 1) * 26);" in src  # fb_col


def fb_col(i):
    return i ^ (((i >> 5) & 1) * 5) ^ (((i >> 6) & 1) * 26)


def tw_pos(e):
    return e ^ (((e >> 3) ^ (e >> 6)) & 7)


# ---------------------------------------------------------------------------
# the schedule (numpy)
# ---------------------------------------------------------------------------


class Schedule:
    """`butterfly_fused_shoup_kernel`'s plan for one block size: cs CTAs of
    nt threads a block, h elements and the staged stage ls a CTA, and the
    rounds in execution order, ("local", s0, R) or ("cross",)."""

    def __init__(self, block: int, kind: str):
        self.log_block = block.bit_length() - 1
        self.cs = 2 if block >= 4 else 1
        self.h = block // self.cs
        self.log_h = self.log_block - (self.cs > 1)
        self.ls, self.log_ls = self.h // 2, self.log_h - 1
        self.nt = FB_THREADS // self.cs
        nl = (self.log_h + 1) // 2
        rounds = [("local", 2 * ri, 1 if ri == nl - 1 and self.log_h & 1 else 2)
                  for ri in range(nl)] + ([("cross",)] if self.cs > 1 else [])
        self.rounds = rounds if kind == "dit" else rounds[::-1]

    def local(self, s0: int, R: int):
        """(threads, idx, stages) of a local round: the active threads' ids,
        their elements (threads, 2^R) in the CTA's h, and each stage in
        execution order as a list of (u column in idx, v column, staged
        entry per thread) for the round's l ascending (dit) or descending."""
        E, Q, L = 1 << R, FB_EPT >> R, 1 << s0
        pairs = self.h >> R
        p = (np.arange(self.nt)[None, :] + self.nt * np.arange(Q)[:, None]).ravel()
        p = p[p < pairs]
        lo, hi = p & (L - 1), p >> s0
        idx = (hi << (s0 + R))[:, None] + np.arange(E)[None, :] * L + lo[:, None]
        stages = []
        for r in range(R):
            bf = []
            for j in range(E):
                if j & (1 << r):
                    continue
                k = (j & ((1 << r) - 1)) * L + lo
                bf.append((j, j + (1 << r), k << (self.log_ls - s0 - r)))
            stages.append(bf)
        return p, idx, stages


@pytest.mark.parametrize("block", [2, 4, 16, 1024, 2048])
@pytest.mark.parametrize("kind", ["dit", "dif"])
def test_rounds_cover_every_stage_once(block, kind):
    """The rounds run stages 1 .. block / 2 once each in execution order;
    each local round's sets hold every element of the CTA's half once, and
    each of its stages pairs the elements of width l = 2^s that the
    whole-array stage pairs, with entry k (ls / l) of the staged table."""
    sch = Schedule(block, kind)
    order = []
    for rd in sch.rounds:
        if rd[0] == "cross":
            order.append(sch.h)
            continue
        _, s0, R = rd
        p, idx, stages = sch.local(s0, R)
        assert np.array_equal(np.sort(idx.ravel()), np.arange(sch.h))
        assert len(p) * (1 << R) == sch.h and len(set(p.tolist())) == len(p)
        ls = [1 << (s0 + r) for r in range(R)]
        order += ls if kind == "dit" else ls[::-1]
        for r, bf in enumerate(stages):
            l = 1 << (s0 + r)
            for ju, jv, e in bf:
                u, v = idx[:, ju], idx[:, jv]
                assert np.array_equal(v, u + l) and ((u % (2 * l)) < l).all()
                assert np.array_equal(e, (u % l) * (sch.ls // l)) and (e < sch.ls).all()
    assert order == ntt.fused_ls(block, kind)


def conflict_free_words(cols: np.ndarray) -> bool:
    """A warp's 32 lanes on one 4-byte word plane: distinct banks or the
    same word."""
    by_bank = {}
    for c in cols.tolist():
        by_bank.setdefault(c % 32, set()).add(c)
    return all(len(s) == 1 for s in by_bank.values())


def conflict_free_16(entries: np.ndarray) -> bool:
    """A quarter-warp's 8 lanes loading 16 bytes each from one plane of the
    staged table: distinct bank groups (16 bytes each, 8 a row) or the same
    entry."""
    by_group = {}
    for e in entries.tolist():
        by_group.setdefault(tw_pos(e) % 8, set()).add(e)
    return all(len(s) == 1 for s in by_group.values())


@pytest.mark.parametrize("kind", ["dit", "dif"])
def test_accesses_free_of_bank_conflicts(kind):
    """At block 2048 (h = 1024, 256 threads a CTA): every warp's reads and
    writes of the exchange buffers and the coalesced copies, and every
    quarter-warp's staged-twiddle loads, at every stage."""
    sch = Schedule(2048, kind)
    cols = fb_col(np.arange(sch.h))
    for w in range(0, sch.h, WARP):  # the copies: element i to thread i mod 256
        assert conflict_free_words(cols[w : w + WARP])
    # the cross round: thread p's two elements at column fb_col(k), k = rank h/2 + p
    for rank in range(2):
        k = rank * (sch.h // 2) + np.arange(sch.h // 2)
        for w in range(0, len(k), WARP):
            assert conflict_free_words(fb_col(k[w : w + WARP]))
    for rd in sch.rounds:
        if rd[0] == "cross":
            continue
        p, idx, stages = sch.local(*rd[1:])
        for w in range(0, len(p), WARP):
            lanes = slice(w, w + WARP)
            assert (p[lanes] // sch.nt == p[w] // sch.nt).all()  # one set a warp
            for j in range(idx.shape[1]):
                assert conflict_free_words(fb_col(idx[lanes, j])), (rd, w, j)
            for bf in stages:
                for _, _, e in bf:
                    for qw in range(w, min(w + WARP, len(p)), 8):
                        assert conflict_free_16(e[qw : qw + 8]), (rd, qw)


VECS = 5  # `Limbs29Layout::VECS`: 16-byte vectors a staged entry


def test_staged_table_fits_two_ctas_an_sm():
    """Two exchange buffers of h elements and ls entries of 5 vectors of 16
    bytes (w's and wp's 9 limbs and 2 words of padding): 104 KB a CTA at
    block 2048, two CTAs in an SM's 228 KB (1 KB a CTA reserved); tw_pos a
    permutation of each plane."""
    src = open(NTT_CU).read()
    assert "static constexpr int VECS = 5;" in src
    assert "s[2 * stark::NL29] = s[2 * stark::NL29 + 1] = 0;" in src  # 18 limbs + 2 pad
    sch = Schedule(2048, "dit")
    smem = 2 * sch.h * NW * 4 + sch.ls * VECS * 16
    assert smem == 104 * 1024 and 2 * (smem + 1024) <= 228 * 1024
    assert sorted(tw_pos(e) for e in range(sch.ls)) == list(range(sch.ls))


@pytest.mark.parametrize("block", [16, 1024, 2048])
def test_round_of_ones_reads_one_entry_a_stage(block):
    """In the round of l = 1, 2 (s0 = 0; blocks of 2 and 4 have a round of
    l = 1 alone, which the kernel runs without the skip) every lane reads
    the same staged entry at each butterfly, the twiddle 1 at l = 1 and at
    l = 2's first butterfly: a warp takes the skip, or not, as a whole."""
    sch = Schedule(block, "dit")
    assert sch.rounds[0] == ("local", 0, 2)
    _, _, stages = sch.local(0, 2)
    for r, bf in enumerate(stages):
        for j, (_, _, e) in enumerate(bf):
            assert (e == e[0]).all()
            assert (e[0] == 0) == (r == 0 or j == 0)


# ---------------------------------------------------------------------------
# the values (python ints)
# ---------------------------------------------------------------------------


def shoup_one(p: int) -> tuple[int, int]:
    wp1 = (1 << 256) // p
    return wp1, -(-(1 << 256) // wp1)


class Values:
    """The kernel's butterflies on python ints, every bound asserted."""

    def __init__(self, spec):
        self.p = spec.p
        self.wp1, self.c1 = shoup_one(spec.p)

    def mul(self, w: int, wp: int, x: int) -> int:
        p = self.p
        assert x < 2 * p and w < p
        q = (wp * x) >> 256
        r = w * x - q * p
        assert 0 <= r < 2 * p and r == (w * x - q * p) % (1 << 256)
        if w == 1 and wp == self.wp1:  # the kernel's product by 1
            assert r == (x - p if x >= self.c1 else x)
        return r

    def add(self, a: int, b: int) -> int:
        s = a + b
        s = s - 2 * self.p if s >= 2 * self.p else s
        assert s < 2 * self.p
        return s

    def sub(self, a: int, b: int) -> int:
        assert b < 2 * self.p
        return self.add(a, 2 * self.p - b)

    def butterfly(self, dit: bool, u: int, v: int, w: int, wp: int, canon: bool):
        assert u < 2 * self.p and v < 2 * self.p
        if dit:
            t = self.mul(w, wp, v)
            u, v = self.add(u, t), self.sub(u, t)
        else:
            t = self.sub(u, v)
            u, v = self.add(u, v), self.mul(w, wp, t)
        if canon:
            u, v = (y - self.p if y >= self.p else y for y in (u, v))
        return u, v


def fused_shoup_model(spec, x: list[int], tw: list[tuple[int, int]], block: int, kind: str,
                      canon: bool) -> list[int]:
    """`butterfly_fused_shoup_kernel` block by block: the CTAs' exchange
    buffers (python lists indexed by `fb_col`), the staged table (four
    planes of 16 bytes at `tw_pos`), the rounds in execution order, the
    stride-h round across the pair through both CTAs' buffers."""
    sch, vals, dit = Schedule(block, kind), Values(spec), kind == "dit"
    h, ls, cs = sch.h, sch.ls, sch.cs
    planes = [[None] * ls for _ in range(4)]  # the staged table, as the kernel holds it
    for e in range(ls):
        w, wp = tw[ls - 1 + e]
        for c in range(4):
            planes[c][tw_pos(e)] = ((w, wp), c)

    def staged(e: int):
        parts = [planes[c][tw_pos(e)] for c in range(4)]
        assert [c for _, c in parts] == [0, 1, 2, 3] and len({v for v, _ in parts}) == 1
        return parts[0][0]

    out = [None] * len(x)
    for base in range(0, len(x), block):
        bufs = [[[None] * h, [None] * h] for _ in range(cs)]  # [rank][buffer][column]
        cur = 0
        if dit:
            for rank in range(cs):
                for i in range(h):
                    bufs[rank][0][fb_col(i)] = x[base + rank * h + i]
        for rr, rd in enumerate(sch.rounds):
            last = canon and rr == len(sch.rounds) - 1
            if rd[0] == "cross":
                buf = cur if dit else cur ^ 1
                for k in range(h // 2 * cs):  # rank k // (h/2) takes butterfly k
                    c = fb_col(k)
                    if dit:
                        u, v = bufs[0][buf][c], bufs[1][buf][c]
                    else:
                        u, v = x[base + k], x[base + h + k]
                    u, v = vals.butterfly(dit, u, v, *tw[h - 1 + k], last)
                    if dit:
                        out[base + k], out[base + h + k] = u, v
                    else:
                        bufs[0][buf][c], bufs[1][buf][c] = u, v
                if not dit:
                    cur ^= 1
                continue
            _, s0, R = rd
            from_global, to_global = not dit and rr == 0, dit and rr == len(sch.rounds) - 1
            p, idx, stages = sch.local(s0, R)
            for rank in range(cs):
                src, dst = bufs[rank][cur], bufs[rank][cur ^ 1]
                lbase = base + rank * h
                regs = [[x[lbase + i] if from_global else src[fb_col(i)] for i in row]
                        for row in idx.tolist()]
                for st, bf in enumerate(stages if dit else stages[::-1]):
                    for ju, jv, e in bf:
                        for t, et in enumerate(e.tolist()):
                            w, wp = staged(et)
                            regs[t][ju], regs[t][jv] = vals.butterfly(
                                dit, regs[t][ju], regs[t][jv], w, wp, last and st == R - 1)
                for row, vs in zip(idx.tolist(), regs):
                    for i, v in zip(row, vs):
                        if to_global:
                            out[lbase + i] = v
                        else:
                            dst[fb_col(i)] = v
            if not to_global:
                cur ^= 1
        if not dit:
            for rank in range(cs):
                for i in range(h):
                    out[base + rank * h + i] = bufs[rank][cur][fb_col(i)]
    assert all(v is not None and v < 2 * spec.p for v in out)
    return out


def lazy_ints(spec, n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % (2 * spec.p) for _ in range(n)]
    edge = [0, 1, spec.r_mod_p, spec.p - 1, spec.p, 2 * spec.p - 1]
    vals[: len(edge)] = edge[:n]
    vals[-len(edge):] = edge[::-1][-n:]
    return vals


def to_planes(vals) -> torch.Tensor:
    limbs = [[(v >> (16 * i)) & 0xFFFF for v in vals] for i in range(16)]
    return torch.tensor(limbs, dtype=torch.int32)


def from_planes(planes) -> list[int]:
    a = (planes.to(torch.int64) & 0xFFFF).tolist()
    return [sum(a[i][c] << (16 * i) for i in range(16)) for c in range(len(a[0]))]


def table_ints(tw_words) -> list[tuple[int, int]]:
    w = (tw_words.to(torch.int64) & M32).tolist()
    val = lambda ws: sum(x << (32 * i) for i, x in enumerate(ws))  # noqa: E731
    return [(val(row[:8]), val(row[8:])) for row in w]


@pytest.mark.parametrize("canon", [False, True])
@pytest.mark.parametrize("kind", ["dit", "dif"])
@pytest.mark.parametrize("block", [2, 4, 16, 1024, 2048])
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_model_equals_the_plain_version(field, block, kind, canon):
    spec = FIELDS[field]
    n = 2 * block
    plan = ntt.NttPlan(spec, spec.root_of_unity(n), n, kind, "cpu", block, shoup=True)
    x = lazy_ints(spec, n, seed=block + 7 * (kind == "dit") + 3 * canon)
    got = fused_shoup_model(spec, x, table_ints(plan.fused_tw), block, kind, canon)
    want = ntt.butterfly_fused_shoup_plain(spec, to_planes(x), plan.fused_tw, block, kind, canon)
    assert got == from_planes(want)


# ---------------------------------------------------------------------------
# the arithmetic word by word
# ---------------------------------------------------------------------------


def words(x: int) -> list[int]:
    assert 0 <= x < 1 << 256
    return [(x >> (32 * i)) & M32 for i in range(NW)]


def value(ws) -> int:
    return sum(w << (32 * i) for i, w in enumerate(ws))


def mad_lo_row(t, a, b):
    """`mad_lo_row`: t[0..7] += lo(a[j] b), the carry into t[8]."""
    c = 0
    for j in range(NW):
        s = t[j] + ((a[j] * b) & M32) + c
        t[j], c = s & M32, s >> 32
    s = t[NW] + c
    assert s >> 32 == 0
    t[NW] = s


def mad_hi_row(t, a, b):
    """`mad_hi_row`: t[1..8] += hi(a[j] b), no carry out of t[8]."""
    c = 0
    for j in range(NW):
        s = t[j + 1] + ((a[j] * b) >> 32) + c
        t[j + 1], c = s & M32, s >> 32
    assert c == 0


def mac_lo_words(a, b):
    """`mac_lo_words` from s = 0: row i's chains of low halves from word i
    and high halves from word i + 1, each stopping at word 7."""
    s = [0] * NW
    for i in range(NW):
        for off, part in ((0, lambda v: v & M32), (1, lambda v: v >> 32)):
            c = 0
            for j in range(NW - i - off):
                v = s[i + j + off] + part(a[j] * b[i]) + c
                s[i + j + off], c = v & M32, v >> 32
    return s


def sub_words(a, b):
    d, borrow = [], 0
    for j in range(NW):
        v = a[j] - b[j] - borrow
        d.append(v & M32)
        borrow = int(v < 0)
    return d, borrow


def shoup_mul_chain(spec, w, wp, x) -> int:
    t = [0] * (NW + 1)
    for i in range(NW):
        mad_lo_row(t, words(wp), words(x)[i])
        mad_hi_row(t, words(wp), words(x)[i])
        assert value(t) < (1 << 256) + wp * (1 << 32)
        t = t[1:] + [0]
    q = value(t[:NW])
    assert q == (wp * x) >> 256
    wx, qp = mac_lo_words(words(w), words(x)), mac_lo_words(words(q), words(spec.p))
    assert value(wx) == w * x % (1 << 256) and value(qp) == q * spec.p % (1 << 256)
    r, _ = sub_words(wx, qp)
    return value(r)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_chain_product_is_the_exact_shoup_product(field):
    spec = FIELDS[field]
    p = spec.p
    rng = np.random.default_rng(19)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(6)]
    xs = [0, 1, p - 1, p, 2 * p - 1, (1 << 256) - 1] + rand
    ws = [0, 1, 2, p - 1] + [v % p for v in rand[:3]]
    for w in ws:
        wp = (w << 256) // p
        for x in xs:
            q = (wp * x) >> 256
            want = w * x - q * p
            assert 0 <= want < 2 * p
            assert shoup_mul_chain(spec, w, wp, x) == want


def div_pow2_256(d: int) -> tuple[int, bool]:
    """The host's `div_pow2_256` bit by bit: floor(2^256 / d) and whether a
    remainder is left."""
    assert 2 <= d < 1 << 256
    r, q = 0, 0
    for b in range(256, -1, -1):
        r = 2 * r + (b == 256)
        assert r < 1 << 257
        if r >= d:
            r -= d
            assert b < 256
            q |= 1 << b
    return q, r != 0


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_product_by_one_is_exact_below_2p(field):
    spec = FIELDS[field]
    p = spec.p
    wp1, rem = div_pow2_256(p)
    c1, rem1 = div_pow2_256(wp1)
    c1 += rem1
    assert (wp1, c1) == shoup_one(p) and rem == ((1 << 256) % p != 0)
    assert p <= c1 < 2 * p
    rng = np.random.default_rng(23)
    xs = [0, 1, p - 1, p, p + 1, c1 - 1, c1, c1 + 1, 2 * p - 1]
    xs += [int.from_bytes(rng.bytes(32), "little") % (2 * p) for _ in range(64)]
    for x in xs:
        q = (wp1 * x) >> 256
        assert x - q * p == (x - p if x >= c1 else x)


MASK29 = (1 << 29) - 1


def limbs29(x: int) -> list[int]:
    """`to_limbs29`: 9 limbs of 29 bits."""
    assert 0 <= x < 1 << 256
    return [(x >> (29 * i)) & MASK29 for i in range(9)]


def shoup_mul29(spec, w: int, wp: int, x: int) -> int:
    """`shoup_mul29` on python ints, column by column as the kernel sums
    them (each column asserted below 2^64)."""
    xl, wl, wpl = limbs29(x), limbs29(w), limbs29(wp)
    pn = limbs29_wide((1 << 261) - spec.p)
    cols = [0] * 17
    for i in range(9):
        for j in range(9):
            cols[i + j] += wpl[i] * xl[j]
    assert max(cols) < 9 << 58
    L, carry = [], 0
    for k in range(17):
        v = cols[k] + carry
        assert v < 1 << 64
        L.append(v & MASK29)
        carry = v >> 29
    assert carry < 1 << 19
    L += [carry, 0]
    q = [((L[8 + m] >> 24) | (L[9 + m] << 5)) & MASK29 for m in range(9)]
    assert sum(v << (29 * m) for m, v in enumerate(q)) == (wp * x) >> 256
    d = [0] * 9
    for i in range(9):
        for j in range(9 - i):
            d[i + j] += wl[i] * xl[j] + q[i] * pn[j]
    assert max(d) < 18 << 58
    rl, carry = [], 0
    for k in range(9):
        v = d[k] + carry
        assert v < 1 << 64
        rl.append(v & MASK29)
        carry = v >> 29
    r = sum(v << (29 * k) for k, v in enumerate(rl))
    assert r < 1 << 256  # `from_limbs29`'s bound
    return r


def limbs29_wide(x: int) -> list[int]:
    """The host's 29-bit limbs of a value below 2^261 (2^261 - p)."""
    assert 0 <= x < 1 << 261
    return [(x >> (29 * i)) & MASK29 for i in range(9)]


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_radix29_product_is_the_exact_shoup_product(field):
    spec = FIELDS[field]
    p = spec.p
    rng = np.random.default_rng(29)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(6)]
    xs = [0, 1, p - 1, p, 2 * p - 1, (1 << 256) - 1] + rand
    ws = [0, 1, 2, p - 1] + [v % p for v in rand[:3]]
    for w in ws:
        wp = (w << 256) // p
        for x in xs:
            assert shoup_mul29(spec, w, wp, x) == w * x - ((wp * x) >> 256) * p
