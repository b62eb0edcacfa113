"""The integer plans of `residues_in` and `reconstruct` in
`stark_tpu_torch/csrc/crt.cu`, modelled in numpy thread by thread on the
CPU, held exactly against the plain versions (`ops/crt_cuda.py`) and, for
one case, against the JAX package's Pallas kernels in interpret mode
(`stark_tpu/ops/pallas_crt.py`, as `tests/test_torch_crt_kernels.py` runs
them).

Both kernels form their table products with the int8 tensor-core
instruction `mma.sync.m16n8k32.s32.s8.u8.s32`; `mma` below takes its
fragments in the PTX ISA's register layout and decodes them to matrices, so
the model checks the kernels' fragment packing, not only their arithmetic:

* `residues_in`: a warp tile of 4 contraction rows x 16 lanes, the lane
  order of its 8 n-tiles, the B fragments built from 16-byte limb loads and
  one shuffle, the A fragments read from `kernel_table`, the epilogue
  (Barrett steps, pre-table product, digits) and its word packing;
* `reconstruct`: the B fragments packed from four prime rows, G's A
  fragments (`CrtBasis.rec_frags`), the column sums through the
  shared-memory layout, the 32-bit wrap count, the carries into words and
  the word-wise REDC.

Every bound the designs rely on is asserted where the model passes it. The
bases are those the CRT engine builds for the 2^17 and 2^20 transforms of
an LDE at steps 2^17 and the 770-bit one of the other tests; inputs are
numpy-seeded, with 0, p - 1 and all-0xFFFF limb columns, pre-table and
residue columns of q - 1, and ragged K and B. Tolerance: exact equality.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import crt as jcrt
from stark_tpu.ops import pallas_crt
from stark_tpu_torch import interop
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.ops import crt, crt_cuda, mxu_ntt

torch.set_num_threads(2)

P = spec.p
M32 = (1 << 32) - 1
LANE = np.arange(32)
G_, T_ = LANE // 4, LANE % 4  # group and thread in group of a warp lane
BYTE = np.arange(4)


def engine_bits(n: int, nz1=None):
    """The bound bits of the two bases of `mxu_ntt.MxuNttPlan` for a
    transform of size n (the formulas of its __init__, no pre-tables in
    step A)."""
    n1, n2 = mxu_ntt._split(n, None, None)
    nz1 = n1 if nz1 is None else nz1
    return ((nz1 - 1).bit_length() + 2 * P.bit_length() + 2,
            (n2 - 1).bit_length() + 3 * P.bit_length() + 2)


# the LDE at steps 2^17, precision 2^20: the inverse transform's two bases,
# the big transform's (step A contracts the 2^17 / 1024 nonzero rows)
BASES = {
    "inv2^17 A": engine_bits(1 << 17)[0],
    "inv2^17 B": engine_bits(1 << 17)[1],
    "big2^20 A": engine_bits(1 << 20, nz1=(1 << 17) // 1024)[0],
    "big2^20 B": engine_bits(1 << 20, nz1=(1 << 17) // 1024)[1],
    "770": 770,
}
@functools.cache
def basis(name: str) -> crt.CrtBasis:
    return crt.CrtBasis(tspec, BASES[name])


# --- the instruction ---------------------------------------------------------


def mma(a, b, c):
    """d = A (16 x 32, s8) @ B (32 x 8, u8) + C from m16n8k32 fragments:
    a (..., 32, 4), b (..., 32, 2) uint32 registers of the 32 lanes, c
    (..., 32, 4) int64; d in c's layout. Each accumulator must stay in s32."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    lead = np.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    ab = np.broadcast_to(a, lead + (32, 4)).copy().view(np.int8).reshape(lead + (32, 4, 4))
    bb = np.broadcast_to(b, lead + (32, 2)).copy().view(np.uint8).reshape(lead + (32, 2, 4))
    A = np.zeros(lead + (16, 32), np.int64)
    for reg in range(4):
        rows = (G_ + 8 * (reg % 2))[:, None] + 0 * BYTE
        cols = (16 * (reg // 2) + 4 * T_)[:, None] + BYTE
        A[..., rows, cols] = ab[..., reg, :]
    Bm = np.zeros(lead + (32, 8), np.int64)
    for reg in range(2):
        rows = (16 * reg + 4 * T_)[:, None] + BYTE
        cols = G_[:, None] + 0 * BYTE
        Bm[..., rows, cols] = bb[..., reg, :]
    D = A @ Bm
    out = np.empty(lead + (32, 4), np.int64)
    for e in range(4):
        out[..., e] = D[..., G_ + 8 * (e // 2), 2 * T_ + e % 2]
    out += c
    assert (np.abs(out) < 1 << 31).all()
    return out


def test_mma_fragments_round_trip():
    """`crt.mma_a_fragments` and the B packing decode, through `mma`, to the
    matrices they were built from: the product equals numpy's."""
    rng = np.random.default_rng(1)
    a = rng.integers(-128, 128, size=(32, 64))
    bm = rng.integers(0, 256, size=(64, 8))
    frags = crt.mma_a_fragments(a)  # (2, 2, 32, 4)
    for mt in range(2):
        d = np.zeros((32, 4), np.int64)
        for ks in range(2):
            bk = bm[32 * ks: 32 * ks + 32]
            breg = np.stack([
                (bk[4 * T_[:, None] + 16 * r + BYTE, G_[:, None]].astype(np.uint32)
                 << (8 * BYTE)).sum(axis=1) for r in range(2)], axis=-1)
            d = mma(frags[mt, ks], breg, d)
        want = a[16 * mt: 16 * mt + 16] @ bm
        for e in range(4):
            assert np.array_equal(d[:, e], want[G_ + 8 * (e // 2), 2 * T_ + e % 2])


# --- the scalar steps ----------------------------------------------------------


def barrett(v, q, m):
    """v mod q for v < 2^32 with m = floor(2^32 / q): one high product, one
    conditional subtraction (rows with q = 0, the padding primes, pass v)."""
    v = np.asarray(v, np.int64)
    q = np.asarray(q, np.int64)
    assert ((v >= 0) & (v < 1 << 32)).all()
    hi = (v.astype(np.uint64) * np.asarray(m, np.int64).astype(np.uint64)) >> np.uint64(32)
    r = v - hi.astype(np.int64) * q
    live = q > 0
    assert ((r >= 0) & ((r < 2 * q) | ~live)).all()
    return np.where(r >= q, r - q, r)


# --- residues_in -----------------------------------------------------------------


def model_residues_in(b: crt.CrtBasis, x: np.ndarray, pre):
    """residues_in_kernel for every warp tile at once: x (16, K, B) limbs,
    pre (p1, K, B) residues or None -> the two (p1, ceil(K/4), B) int32
    digit planes."""
    _, K, B = x.shape
    p1 = len(b.qs_host)
    K4, TB, mtiles = -(-K // 4), -(-B // 16), -(-p1 // 16)
    tab = np.zeros((16 * mtiles, crt.TABLE_ROW), np.int64)
    tab[:p1] = b.kernel_table.view(np.uint32)
    k4 = np.repeat(np.arange(K4), TB)  # tile -> (k4, b0), b fastest
    b0 = np.tile(np.arange(TB), K4) * 16
    c, par = G_ // 2, G_ % 2
    x = x.astype(np.int64)

    def load(plane, k, cols, live):
        """x[plane, k, cols] with zeros where !live or cols >= B."""
        ok = live & (cols < B)
        return np.where(ok, x[plane, np.minimum(k, K - 1), np.minimum(cols, B - 1)], 0)

    # B fragments: bf[j][h] (tiles, 32, 2)
    bf = [[np.zeros((len(k4), 32, 2), np.int64) for _ in range(2)] for _ in range(4)]
    for j in range(4):
        k = (4 * k4 + j)[:, None, None]
        for r in range(2):
            plane = (2 * (T_ + 4 * r) + par)[None, :, None]
            cols = b0[:, None, None] + 4 * c[None, :, None] + BYTE
            v = load(plane, k, cols, k < K)  # (tiles, 32, 4)
            v0, v1, v2, v3 = (v[..., e] for e in range(4))
            send = (np.where(par, v0, v1) & 0xFFFF) | (np.where(par, v2, v3) << 16)
            recv = send[:, LANE ^ 4]
            bf[j][0][..., r] = np.where(par, (recv & 0xFFFF) | (v1 << 16),
                                        (v0 & 0xFFFF) | (recv << 16)) & M32
            bf[j][1][..., r] = np.where(par, (recv >> 16) | (v3 << 16),
                                        (v2 & 0xFFFF) | (recv & 0xFFFF0000)) & M32
    # the lane order: column g of n-tile (j, h) is lane (4k4 + j, b0 + 4(g/2)
    # + 2h + g%2), and its registers are words t and t + 4 of that element
    for j in range(4):
        for h in range(2):
            k = (4 * k4 + j)[:, None]
            col = b0[:, None] + 4 * c + 2 * h + par
            for r in range(2):
                word = (T_ + 4 * r)[None, :]
                lo = load(2 * word, k, col, k < K)
                hi = load(2 * word + 1, k, col, k < K)
                assert np.array_equal(bf[j][h][..., r], lo | (hi << 16))

    o = [np.zeros((p1, K4, B), np.int64) for _ in range(2)]
    stored = np.zeros((p1, K4, B), np.int64)
    for mt in range(mtiles):
        i = [16 * mt + G_, 16 * mt + G_ + 8]
        a = [np.stack([tab[i[0], 8 * pl + T_], tab[i[1], 8 * pl + T_],
                       tab[i[0], 8 * pl + T_ + 4], tab[i[1], 8 * pl + T_ + 4]], axis=-1)
             for pl in range(2)]
        q = [tab[i[ps], 16] for ps in range(2)]
        m = [tab[i[ps], 17] for ps in range(2)]
        pw = {}
        if pre is not None:
            for j in range(4):
                k = (4 * k4 + j)[:, None, None]
                for ps in range(2):
                    cols = b0[:, None, None] + 4 * T_[None, :, None] + BYTE
                    ip = i[ps][None, :, None]
                    ok = (ip < p1) & (k < K) & (cols < B)
                    h16 = np.where(ok, pre[np.minimum(ip, p1 - 1), np.minimum(k, K - 1),
                                           np.minimum(cols, B - 1)], 0)
                    pw[j, ps] = [h16[..., 2 * h] | (h16[..., 2 * h + 1] << 16)
                                 for h in range(2)]
        w = [np.zeros((len(k4), 32, 2, 4), np.int64) for _ in range(2)]
        for j in range(4):
            for h in range(2):
                init = np.stack([q[0] << 14, q[0] << 14, q[1] << 14, q[1] << 14], axis=-1)
                d0 = mma(a[0], bf[j][h], init)
                d1 = mma(a[1], bf[j][h], 0)
                raw = d0 - init + 128 * d1
                # |raw| < 2^26 <= q * 2^14: the first Barrett input is in (0, 2^32)
                assert (np.abs(raw) < 1 << 26).all()
                for e in range(4):
                    ps, col = e // 2, e % 2
                    v = d0[..., e] + 128 * d1[..., e]
                    r = barrett(v, q[ps], m[ps])
                    if pre is not None:
                        tw = pw[j, ps][h]
                        t16 = np.where(col, tw >> 16, tw & 0xFFFF)
                        assert (r * t16 < 1 << 28).all()
                        r = barrett(r * t16, q[ps], m[ps])
                    w[0][..., ps, 2 * h + col] |= (r & 127) << (8 * j)
                    w[1][..., ps, 2 * h + col] |= (r >> 7) << (8 * j)
        for ps in range(2):
            ip = np.broadcast_to(i[ps][None, :, None], (len(k4), 32, 4))
            cols = b0[:, None, None] + 4 * T_[None, :, None] + BYTE
            kk = np.broadcast_to(k4[:, None, None], ip.shape)
            ok = (ip < p1) & (cols < B)
            for pl in range(2):
                o[pl][ip[ok], kk[ok], cols[ok]] = w[pl][..., ps, :][ok]
            np.add.at(stored, (ip[ok], kk[ok], cols[ok]), 1)
    assert (stored == 1).all()  # every output word written once
    return tuple(np.asarray(v, np.int64).astype(np.uint32).view(np.int32) for v in o)


def limb_planes(rng, K, B):
    """(16, K, B) uint32 limbs of random field elements, with 0, p - 1 and
    2^256 - 1 (every byte 255, the largest raw sum) among them."""
    vals = rng.integers(0, 1 << 16, size=(16, K * B)).astype(np.int64)
    vals[15] %= (P >> 240)
    vals[:, 0] = 0
    if K * B > 1:
        vals[:, 1] = [(P - 1 >> 16 * i) & 0xFFFF for i in range(16)]
    if K * B > 2:
        vals[:, -1] = 0xFFFF
    return vals.reshape(16, K, B).astype(np.uint32)


def pre_table(rng, b, K, B):
    qs = np.asarray(b.qs_host)[:, None, None]
    pre = rng.integers(0, qs, size=(len(b.qs_host), K, B))
    pre[:, -1, -1] = (qs - 1)[:, 0, 0]
    return pre


SHAPES = [(16, 64), (6, 5), (100, 70), (13, 36)]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{k}x{b}" for k, b in SHAPES])
@pytest.mark.parametrize("with_pre", [False, True], ids=["plain", "pre"])
@pytest.mark.parametrize("name", list(BASES))
def test_residues_in_plan(name, with_pre, shape):
    b = basis(name)
    K, B = shape
    rng = np.random.default_rng(K * 1000 + B + 7 * with_pre)
    x = limb_planes(rng, K, B)
    pre = pre_table(rng, b, K, B) if with_pre else None
    got = model_residues_in(b, x, pre)
    want = crt_cuda.residues_in_plain(
        b, interop.planes_from_numpy(x, "cpu"),
        None if pre is None else torch.from_numpy(pre.astype(np.int16)))
    for g, w in zip(got, want):
        assert np.array_equal(g, w.numpy())


# --- reconstruct -----------------------------------------------------------------


def field_words():
    return [(P >> 32 * i) & M32 for i in range(8)], (-pow(P, -1, 1 << 32)) % (1 << 32)


def model_reconstruct(b: crt.CrtBasis, s: np.ndarray) -> np.ndarray:
    """reconstruct_kernel for every round of 32 lanes at once: s (P+1, n)
    residues -> (16, n) int32 limbs."""
    Pn, n = b.P, s.shape[1]
    s = s.astype(np.int64)
    assert (s < 1 << 14).all()  # the digit packing: two 7-bit digits a residue
    frags = b.rec_frags.view(np.uint32).astype(np.int64)  # (3, 2, 32, 4)
    rounds = -(-n // 32)
    l0 = np.arange(rounds) * 32
    lanes = l0[:, None] + LANE  # (rounds, 32)
    s_r = np.where(lanes < n, s[Pn, np.minimum(lanes, n - 1)], 0).reshape(-1)[:n]
    sh = np.full((rounds, 32, 44), -1 << 40, np.int64)  # one warp's shared memory
    for nt in range(4):
        # thread (g, t): lane l0 + 8 nt + g; register r of k-step ks holds the
        # digits of primes 32 ks + 16 r + 4 t .. + 3, loaded as four rows
        col = l0[:, None] + 8 * nt + G_  # (rounds, 32)
        breg = np.zeros((2, 2, rounds, 32, 2), np.int64)  # [plane][ks] registers
        for ks in range(2):
            for r in range(2):
                prime = 32 * ks + 16 * r + 4 * T_[:, None] + BYTE  # (32, 4)
                ok = (prime < Pn)[None] & (col < n)[..., None]
                v = np.where(ok, s[np.minimum(prime, Pn - 1)[None],
                                   np.minimum(col, n - 1)[..., None]], 0)
                v0, v1, v2, v3 = (v[..., i] for i in range(4))
                u02, u13 = v0 | (v2 << 16), v1 | (v3 << 16)
                breg[0, ks, ..., r] = (u02 & 0x007F007F) | ((u13 & 0x007F007F) << 8)
                breg[1, ks, ..., r] = ((u02 >> 7) & 0x007F007F) | (((u13 >> 7) & 0x007F007F) << 8)
                # bytes in prime order: digits of primes 4t + i, i = 0..3
                for plane, dig in ((0, v & 127), (1, v >> 7)):
                    assert np.array_equal(breg[plane, ks, ..., r],
                                          (dig << (8 * BYTE)).sum(axis=-1))
        for mt in range(3):
            d = [np.zeros((rounds, 32, 4), np.int64) for _ in range(2)]
            for ks in range(2):
                for plane in range(2):
                    d[plane] = mma(frags[mt, ks], breg[plane, ks], d[plane])
            assert all((np.abs(x) < 1 << 20).all() for x in d)
            for e in range(4):
                row = 16 * mt + G_ + 8 * (e // 2)
                keep = row < crt.ND + 2
                lane_local = 8 * nt + 2 * T_ + e % 2
                sh[:, lane_local[keep], row[keep]] = (d[0] + 128 * d[1])[:, keep, e]
    es = sh[:, :, : crt.ND + 2].reshape(rounds * 32, crt.ND + 2)[:n]
    assert (np.abs(es) < 1 << 27).all()  # also: every sum was written

    # the digit sums are D0 + 128 D1 of the JAX body: G (s & 127), G (s >> 7)
    G = b.G.astype(np.int64)
    assert np.array_equal(es, (G @ (s[:Pn] & 127) + 128 * (G @ (s[:Pn] >> 7))).T)

    qr, minv = b.qr, b.minv_qr
    mr = (1 << 32) // qr
    off = qr << 14
    e0 = barrett(es[:, crt.ND] + off, qr, mr)
    e1 = barrett(es[:, crt.ND + 1] + off, qr, mr)
    kd_in = e0 + 128 * e1 + qr - s_r
    assert (kd_in < 1 << 22).all()
    kd = barrett(kd_in, qr, mr)
    assert (kd * minv < 1 << 28).all()
    k = barrett(kd * minv, qr, mr)
    grr = np.array([(b.M // q) % qr for q in b.qs_host[:-1]], dtype=object)
    want_k = (((grr[:, None] * s[:Pn].astype(object)).sum(axis=0) - s[Pn]) * minv) % qr
    assert np.array_equal(k, want_k.astype(np.int64))

    cols = es[:, : crt.ND] + k[:, None] * b.negm_digits[None, :].astype(np.int64)
    assert (np.abs(cols) < 1 << 31).all()
    y = np.zeros((n, 10), np.int64)
    acc = np.zeros(n, np.int64)
    for wd in range(9):
        for i in range(4):
            if 4 * wd + i < crt.ND:
                acc = acc + (cols[:, 4 * wd + i] << (8 * i))
                assert (np.abs(acc) < 1 << 62).all()
        y[:, wd] = acc & M32
        acc >>= 32
    assert (acc == 0).all()  # Y >= 0 and Y < 2^288
    Y = [sum(int(y[j, w]) << (32 * w) for w in range(9)) for j in range(n)]
    assert max(Y) < 1 << 275

    # word-wise REDC, 8 rounds, one conditional subtraction
    pw, npi = field_words()
    y = y.astype(np.uint64)
    u32 = np.uint64(32)
    mask = np.uint64(M32)
    for _ in range(8):
        mm = (y[:, 0] * np.uint64(npi)) & mask
        cc = (mm * np.uint64(pw[0]) + y[:, 0]) >> u32
        for j in range(1, 8):
            v = mm * np.uint64(pw[j]) + y[:, j] + cc
            y[:, j - 1] = v & mask
            cc = v >> u32
        v = y[:, 8] + cc
        y[:, 7] = v & mask
        v = y[:, 9] + (v >> u32)
        y[:, 8] = v & mask
        y[:, 9] = 0
    u = [sum(int(y[j, w]) << (32 * w) for w in range(9)) for j in range(n)]
    assert max(u) < 2 * P
    u = [v - P if v >= P else v for v in u]
    return np.array([[(v >> 16 * i) & 0xFFFF for v in u] for i in range(16)],
                    np.int64).astype(np.int32)


def residues(rng, b, n):
    """(P+1, n) residues: random, a column of 0, one of q - 1, one of a
    value's true residues (t-scaled: the CRT sum of p - 1)."""
    qs = np.asarray(b.qs_host)
    s = rng.integers(0, qs[:, None], size=(len(qs), n))
    s[:, 0] = 0
    s[:, 1] = qs - 1
    X = b.M - 1
    s[:-1, 2] = [(X % q) * t % q for q, t in zip(b.qs_host[:-1], b.t_host)]
    s[-1, 2] = X % b.qr
    return s


@pytest.mark.parametrize("n", [96, 77])
@pytest.mark.parametrize("name", list(BASES))
def test_reconstruct_plan(name, n):
    b = basis(name)
    s = residues(np.random.default_rng(n + b.P), b, n)
    got = model_reconstruct(b, s)
    want = crt_cuda.reconstruct_plain(b, torch.from_numpy(s.astype(np.int32)))
    assert np.array_equal(got, want.numpy())


# --- the worst cases of the bounds, from the tables ------------------------------


@pytest.mark.parametrize("name", list(BASES))
def test_bounds_from_tables(name):
    """The bounds the kernels rely on, at their worst over all inputs:
    |raw| < 2^26 < q * 2^14 (every byte 255 on the larger-signed side), the
    residues' 7-bit digits < 128, |D| < 2^20 and |E| < 2^27 (every digit
    127), q * 2^14 + 2^26 < 2^32, and the fold inputs of the wrap count."""
    b = basis(name)
    Cb = b.C0.astype(np.int64) + 128 * b.C1.astype(np.int64)
    worst_raw = np.maximum(np.where(Cb > 0, Cb, 0).sum(1), -np.where(Cb < 0, Cb, 0).sum(1))
    assert (255 * worst_raw < 1 << 26).all()
    qs = np.asarray(b.qs_host, np.int64)
    assert (qs << 14 > 1 << 26).all() and ((qs << 14) + (1 << 26) < 1 << 32).all()
    assert qs.max() < 1 << 14  # s >> 7 < 128
    G = np.abs(b.G.astype(np.int64))
    assert b.P <= crt.REC_PRIMES and b.G.shape[0] == crt.ND + 2 <= crt.REC_ROWS
    assert (127 * G.sum(1) < 1 << 20).all()  # |D0|, |D1|
    assert (129 * 127 * G.sum(1) < 1 << 27).all()  # |E| = |D0 + 128 D1|
    assert (b.qr << 14) > 1 << 27 and (b.qr << 14) + (1 << 27) < 1 << 32
    assert b.qr + 128 * b.qr + b.qr < 1 << 22 and b.qr * b.qr < 1 << 28
    assert (np.abs(b.negm_digits) <= 128).all()
    assert (1 << 27) + 128 * b.qr < 1 << 31  # a column with k * negM_d


def test_rec_fragments_decode_to_G():
    """`CrtBasis.rec_frags` decodes, lane by lane, to G padded to 48 x 64."""
    b = basis("big2^20 B")
    fr = b.rec_frags.view(np.uint32)
    ab = fr.copy().view(np.int8).reshape(3, 2, 32, 4, 4)
    A = np.zeros((48, 64), np.int64)
    for mt in range(3):
        for ks in range(2):
            for reg in range(4):
                rows = 16 * mt + G_ + 8 * (reg % 2)
                cols = 32 * ks + 16 * (reg // 2) + 4 * T_
                A[rows[:, None], cols[:, None] + BYTE] = ab[mt, ks, :, reg]
    want = np.zeros((48, 64), np.int64)
    want[: crt.ND + 2, : b.P] = b.G
    assert np.array_equal(A, want)


# --- one case against the Pallas kernels --------------------------------------------


@pytest.fixture
def forced_pallas(monkeypatch):
    monkeypatch.setenv("STARK_TPU_PALLAS", "force")
    monkeypatch.setenv("STARK_TPU_CRT_FUSED", "force")


def test_plans_match_pallas(forced_pallas):
    """The modelled kernels against `pallas_crt.residues_in` (with a
    pre-table) and `pallas_crt.reconstruct`, on the 770-bit basis at the
    Pallas kernels' lane tile."""
    jb, tb = jcrt.CrtBasis(spec, 770), basis("770")
    K, B = 128, 16
    rng = np.random.default_rng(13)
    x = limb_planes(rng, K, B)
    pre = pre_table(rng, tb, K, B)
    p1 = len(tb.qs_host)
    want = pallas_crt.residues_in(jb, jnp.asarray(x.reshape(16, K * B)),
                                  jnp.asarray(pre.reshape(p1, K * B).astype(np.uint32)))
    got = model_residues_in(tb, x, pre)
    for g, w in zip(got, want):
        digits = crt.unpack_k4(torch.from_numpy(g), K).numpy().astype(np.int64)
        assert np.array_equal(digits, np.asarray(w.astype(jnp.float32)).astype(np.int64)
                              .reshape(p1, K, B))
    s = residues(rng, tb, pallas_crt.TILE)
    want = np.asarray(pallas_crt.reconstruct(jb, jnp.asarray(s.astype(np.uint32))))
    assert np.array_equal(interop.planes_from_numpy(want, "cpu").numpy(),
                          model_reconstruct(tb, s))


def test_reconstruct_kernel_refuses_more_primes():
    """The kernel's two k-steps take at most REC_PRIMES primes: a basis past
    that is refused before the launch (a `meta` tensor takes the card's
    route without a card); its plain version still runs on the CPU."""
    b = crt.CrtBasis(tspec, 900)
    assert b.P > crt.REC_PRIMES
    with pytest.raises(ValueError, match="at most 64 primes"):
        crt_cuda.reconstruct(b, torch.empty((b.P + 1, 8), dtype=torch.int32, device="meta"))
    s = residues(np.random.default_rng(5), b, 8)
    assert crt_cuda.reconstruct(b, torch.from_numpy(s.astype(np.int32))).shape == (16, 8)
