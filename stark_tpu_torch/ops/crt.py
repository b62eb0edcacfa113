"""CRT modular linear algebra: `(W @ x) mod p` as products of 7-bit digits.

Counterpart of `stark_tpu/ops/crt.py`. Every big linear map of the prover
(the DFT steps of the four-step NTT) is a product with a constant mod-p
matrix; this module computes it through residues modulo ~14-bit primes q_i:

1. reduce-in: 16-bit limb planes -> residues mod every q_i (one product with
   the (P+1, 32) table of 256^l mod q_i and a short fold chain,
   2^14 = delta_i mod q_i), optionally times a residue pre-table;
2. main product: the constant's residues as two balanced 7-bit digit planes,
   the data's as two unsigned ones, four digit products per prime, all sums
   below 2^24;
3. recombine the four sums mod q_i;
4. reconstruct: the wrap count k of the CRT sum from a redundant prime, the
   mod-p value from a digit product with (M/q_i) mod p, and the division by
   R = 2^256 as a Montgomery reduction, one conditional subtraction.

Constant matrices are pre-scaled by R mod p, so Montgomery-form inputs give
Montgomery-form outputs.

The three fused passes (`residues_in`, `matmul_fold`, `reconstruct`) are the
wrappers of `stark_tpu_torch/ops/crt_cuda.py`: hand-written CUDA on a CUDA
tensor. The composed code here is their plain PyTorch version and the route
of a CPU tensor. Tensors are int32 with the JAX package's uint32 values
(int64 inside, where a value can pass 2^31); digit products run in float32,
which is exact for these sums in any order of summation. Dropped from the
JAX module: the pytree registrations, the backend switch of the matrix
dtype, the lane blocking of wide 2-D dots and the debug switches read from
the environment.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.fields.field import FieldSpec

QBITS = 14
QBASE = 1 << QBITS
CHUNK = 7  # residue chunk bits for the main products
R256 = 1 << 256
ND = 35  # base-256 digits in the reconstruction sum (bound < 2^(8*35))
TEMP_BYTES = 2 << 30  # default budget of the plain product for its four float32 buffers
# words of one prime's row in `CrtBasis.kernel_table`: 8 + 8 packed digit words
# of 256^l mod q, then q, floor(2^32 / q), 0 (unused) and delta = 2^14 - q
TABLE_ROW = 20
# `reconstruct`'s kernel: G's ND + 2 rows padded to REC_ROWS and its primes
# to REC_PRIMES, the tensor cores' tiles (three m-tiles of 16, two k-steps of 32)
REC_ROWS = 48
REC_PRIMES = 64


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for sp in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % sp == 0:
            return n == sp
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def select_primes(bound_bits: int, qmax: int = 16128):
    """Descending primes <= qmax whose product exceeds 2^bound_bits, plus
    one extra as the redundant reconstruction lane (last entry)."""
    qs, bits, q = [], 0.0, qmax
    while bits <= bound_bits:
        if _is_prime(q):
            qs.append(q)
            bits += np.log2(q)
        q -= 1
    while not _is_prime(q):
        q -= 1
    qs.append(q)  # redundant lane
    return qs


def _balanced_digits(v: int, base: int, n: int):
    out = []
    for _ in range(n):
        d = v % base
        if d >= base // 2:
            d -= base
        out.append(d)
        v = (v - d) // base
    assert v == 0, "digit overflow in balanced recoding"
    return out


def _fold_count(bound_bits: int, dmax_bits: int = 10) -> int:
    """Folds of x -> (x>>14)*delta + (x & (2^14-1)) to get below 2^16.

    The two conditional subtracts after the fold chain can only
    canonicalize values below ~3q, so a chain that fails to converge must
    fail loudly here (at basis-construction time), not produce silently
    wrong residues downstream."""
    b, c = bound_bits, 0
    while b >= 16:
        nb = max(b - QBITS + dmax_bits, QBITS) + 1
        if nb >= b:
            raise ValueError(
                f"CRT fold chain does not converge: bound 2^{bound_bits} "
                f"stuck at 2^{b} after {c} folds (dmax_bits={dmax_bits})"
            )
        b, c = nb, c + 1
    return c


def _pack_i8(digits: np.ndarray) -> np.ndarray:
    """(..., 4k) signed digits in [-128, 127] -> (..., k) int32 words, digit
    4w + e in byte e of word w (little-endian)."""
    return np.ascontiguousarray(digits.astype(np.int8)).view("<i4")


def _check_exact_matmul(t: torch.Tensor) -> None:
    """The plain version's float32 products must be exact on the card too:
    refuse a reduced-precision matmul setting."""
    if t.device.type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "the CRT digit products need full float32 matmuls: unset "
            "torch.backends.cuda.matmul.allow_tf32 / set_float32_matmul_precision"
        )


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, K) @ (K, N) -> (m, N) float32, exact (integer sums < 2^24)."""
    _check_exact_matmul(b)
    return a.to(torch.float32) @ b.to(torch.float32)


def mma_a_fragments(a: np.ndarray) -> np.ndarray:
    """A (16m, 32k) int8 matrix -> its m16n8k32 A fragments, (m, k, 32, 4)
    int32: for lane (g, t) = (lane // 4, lane % 4) of a warp, register 0
    holds row g, columns 4t .. 4t+3 of the tile (one byte each, the lowest
    first), register 1 row g + 8, registers 2 and 3 the same rows at columns
    16 + 4t .. (the PTX ISA's layout)."""
    rows, cols = a.shape
    assert rows % 16 == 0 and cols % 32 == 0 and -128 <= a.min() and a.max() < 128
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    out = np.zeros((rows // 16, cols // 32, 32, 4, 4), np.int8)
    for mt in range(rows // 16):
        for ks in range(cols // 32):
            for reg in range(4):
                r = 16 * mt + g + 8 * (reg % 2)
                c = 32 * ks + 16 * (reg // 2) + 4 * t
                out[mt, ks, :, reg] = a[r[:, None], c[:, None] + np.arange(4)]
    return np.ascontiguousarray(out.view("<i4")[..., 0])


def rec_fragments(G: np.ndarray) -> np.ndarray:
    """G (ND + 2, P) balanced digits -> the A fragments of `reconstruct`'s
    kernel, (3, k, 32, 4) int32: rows padded with zeros to REC_ROWS, primes
    to REC_PRIMES or the next multiple of 32 past P (the kernel takes
    P <= REC_PRIMES, two k-steps)."""
    a = np.zeros((REC_ROWS, max(REC_PRIMES, -(-G.shape[1] // 32) * 32)), np.int64)
    a[: G.shape[0], : G.shape[1]] = G
    return mma_a_fragments(a)


class CrtBasis:
    """CRT basis for one (field, magnitude-bound) pair: host tables as numpy
    arrays, their tensors made per device by `on(device)`."""

    def __init__(self, spec: FieldSpec, bound_bits: int):
        p = spec.p
        qs_all = select_primes(bound_bits)
        self.spec = spec
        self.p = p
        self.bound_bits = bound_bits
        self.P = len(qs_all) - 1
        self.qr = qs_all[-1]
        qs = qs_all[:-1]
        self.qs_host = qs_all
        M = 1
        for q in qs:
            M *= q
        assert M > 1 << bound_bits
        self.M = M
        self.t_host = [pow(M // q, -1, q) for q in qs]
        gp = [(M // q) % p for q in qs]
        grr = [(M // q) % self.qr for q in qs]
        self.minv_qr = pow(M % self.qr, -1, self.qr)
        self.delta_r = QBASE - self.qr

        qa = np.array(qs_all, np.int64)[:, None]
        self.qs = qa.astype(np.int32)
        self.deltas = (QBASE - qa).astype(np.int32)
        self.dmax_bits = int(np.ceil(np.log2(max(1, int((QBASE - qa).max())))))

        # reduce-in rows: balanced 7-bit digit pair of (256^l mod q), l the
        # byte's place in the 256-bit value (no permutation: the bytes are
        # taken in their natural order here)
        C = np.array([[pow(256, l, q) for l in range(32)] for q in qs_all], np.int64)
        Cb = np.where(C > qa // 2, C - qa, C)
        c0 = ((Cb + 64) % 128) - 64
        c1 = (Cb - c0) >> 7
        assert np.abs(c1).max() < 64
        self.C0 = c0.astype(np.float32)
        self.C1 = c1.astype(np.float32)

        # reconstruction: G rows = balanced base-256 digits of gp_i;
        # two extra rows = balanced 7-bit digit pair of grr_i (for k)
        G = np.zeros((ND + 2, self.P), np.int64)
        for i, g in enumerate(gp):
            G[:ND, i] = _balanced_digits(g, 256, ND)
        grr_b = [x - self.qr if x > self.qr // 2 else x for x in grr]
        for i, g in enumerate(grr_b):
            d0 = ((g + 64) % 128) - 64
            G[ND, i] = d0
            G[ND + 1, i] = (g - d0) >> 7
        assert np.abs(G[ND + 1]).max() < 64
        self.G = G.astype(np.float32)
        negM = (-M) % p
        self.negM_dig = np.array(_balanced_digits(negM, 256, ND), np.float32)[:, None]

        # REDC bands: N' = -p^-1 mod R, p; balanced base-256 digits
        npi = (-pow(p, -1, R256)) % R256
        nd = _balanced_digits(npi, 256, 33)[:32]  # mod R: low 32 digits
        pd = _balanced_digits(p, 256, 33)
        NB = np.zeros((32, 32), np.int64)
        for c in range(32):
            for a in range(c + 1):
                NB[c, a] = nd[c - a]
        PB = np.zeros((65, 32), np.int64)
        for c in range(65):
            for a in range(32):
                if 0 <= c - a < 33:
                    PB[c, a] = pd[c - a]
        self.NB = NB.astype(np.float32)
        self.PB = PB.astype(np.float32)
        self.p_limbs16 = tuple((p >> (16 * i)) & 0xFFFF for i in range(16))
        self._kernel_tables()

    @classmethod
    def from_tables(cls, spec: FieldSpec, static: dict, tables: dict) -> "CrtBasis":
        """A basis from its static fields (p, bound_bits, P, qr, qs_host,
        t_host, M, minv_qr, delta_r, dmax_bits, p_limbs16) and its tables
        (qs, deltas, C0, C1, G, negM_dig, NB, PB) as numpy arrays, e.g. the
        leaves of the JAX package's basis. The kernels' tables are derived
        from these."""
        b = object.__new__(cls)
        b.spec = spec
        for name, value in static.items():
            setattr(b, name, value)
        b.qs_host, b.t_host = list(b.qs_host), list(b.t_host)
        for name in ("qs", "deltas"):
            setattr(b, name, np.ascontiguousarray(tables[name], np.int32))
        for name in ("C0", "C1", "G", "negM_dig", "NB", "PB"):
            setattr(b, name, np.ascontiguousarray(tables[name], np.float32))
        b._kernel_tables()
        return b

    def _kernel_tables(self) -> None:
        """The kernels' tables from the digit tables: `kernel_table` (see
        TABLE_ROW); for `reconstruct`, G's int8 tensor-core fragments
        (`rec_fragments`) and the digits of -M mod p as int32."""
        qa = self.qs.astype(np.int64)
        c0, c1 = self.C0.astype(np.int64), self.C1.astype(np.int64)
        self.kernel_table = np.concatenate(
            [_pack_i8(c0), _pack_i8(c1), qa, (1 << 32) // qa, np.zeros_like(qa),
             QBASE - qa],
            axis=1,
        ).astype(np.int32)
        assert self.kernel_table.shape == (len(self.qs_host), TABLE_ROW)
        self.rec_frags = rec_fragments(self.G.astype(np.int64))
        self.negm_digits = self.negM_dig[:, 0].astype(np.int32)
        self._on: dict = {}

    def on(self, device) -> dict:
        """The tables as tensors on `device` (made once per device)."""
        dev = torch.device(device)
        hit = self._on.get(dev)
        if hit is None:
            hit = {
                name: torch.from_numpy(getattr(self, name)).to(dev)
                for name in ("qs", "deltas", "C0", "C1", "G", "negM_dig", "NB", "PB",
                             "kernel_table", "rec_frags")
            }
            self._on[dev] = hit
        return hit

    # -- residue helpers ---------------------------------------------------

    def fold(self, v: torch.Tensor, bound_bits: int) -> torch.Tensor:
        """v (P+1, N) in [0, 2^bound_bits) -> int64 in [0, q). Per-prime fold
        chain + two conditional subtracts."""
        t = self.on(v.device)
        d = t["deltas"].to(torch.int64)
        q = t["qs"].to(torch.int64)
        x = v.to(torch.int64)
        for _ in range(_fold_count(bound_bits, self.dmax_bits)):
            x = (x >> QBITS) * d + (x & (QBASE - 1))
        for _ in range(2):
            x = torch.where(x >= q, x - q, x)
        return x

    def fold_signed(self, v: torch.Tensor, bound_bits: int) -> torch.Tensor:
        """Signed variant: add a multiple of q first. |v| < 2^bound_bits,
        bound_bits <= 31."""
        shift = bound_bits - QBITS + 1
        off_q = self.on(v.device)["qs"].to(torch.int64) << shift  # >= 2^bound
        return self.fold(v.to(torch.int64) + off_q, min(bound_bits + 2, 32))

    def reduce_in(self, limbs: torch.Tensor) -> torch.Tensor:
        """(L, N) int32 16-bit limb planes -> (P+1, N) int32 residues."""
        t = self.on(limbs.device)
        L, n = limbs.shape
        by = torch.stack([limbs & 0xFF, limbs >> 8], dim=1).reshape(2 * L, n)
        D0 = _dot(t["C0"], by)
        D1 = _dot(t["C1"], by)
        raw = D0.to(torch.int64) + (D1.to(torch.int64) << 7)
        return self.fold_signed(raw, 27).to(torch.int32)

    def chunk(self, r: torch.Tensor):
        """Residues [0, q) -> two unsigned 7-bit digit planes (int8)."""
        return (r & 127).to(torch.int8), (r >> 7).to(torch.int8)

    def reconstruct(self, s: torch.Tensor) -> torch.Tensor:
        """(P+1, N) residues of X (< M; last row plain mod q_r) ->
        (16, N) int32 canonical limbs of X * R^-1 mod p: the kernel on a
        CUDA tensor, `_reconstruct_math` on a CPU tensor."""
        from stark_tpu_torch.ops import crt_cuda

        return crt_cuda.reconstruct(self, s)


def _fold_r_free(x, bound_bits, qr_i, delta_r_i, dmax_bits):
    b = bound_bits
    while b >= 16:
        x = (x >> QBITS) * delta_r_i + (x & (QBASE - 1))
        b = max(b - QBITS + dmax_bits, QBITS) + 1
    for _ in range(2):
        x = torch.where(x >= qr_i, x - qr_i, x)
    return x


def _reconstruct_math(basis: CrtBasis, s: torch.Tensor) -> torch.Tensor:
    """The reconstruction in base-256 digit columns, as the JAX package
    composes it. s: (P+1, T) int32; returns (16, T) int32 canonical limbs of
    X*R^-1 mod p."""
    t = basis.on(s.device)
    P, qr_i, delta_r_i = basis.P, basis.qr, basis.delta_r
    G = t["G"]
    s = s.to(torch.int64)
    D0 = _dot(G, s[:P] & 127).to(torch.int64)  # (ND+2, T), exact
    D1 = _dot(G, s[:P] >> 7).to(torch.int64)
    # wrap count k via the redundant lane
    ssum = D0[ND] + ((D0[ND + 1] + D1[ND]) << 7) + delta_r_i * D1[ND + 1]
    kraw = ssum - s[P] + (1 << 16) * qr_i
    kred = _fold_r_free(kraw, 31, qr_i, delta_r_i, basis.dmax_bits)
    k = _fold_r_free(kred * basis.minv_qr, 28, qr_i, delta_r_i, basis.dmax_bits)
    # digit sum: cols = G@s0 + 128*(G@s1) + k*digits(-M mod p)
    Dk = t["negM_dig"].to(torch.int64) * k[None, :]
    cols = D0[:ND] + (D1[:ND] << 7) + Dk
    y = _carry_digits(cols, ND + 1)  # (ND+1, T) bytes of Y >= 0
    # REDC: m = (Y mod R)*N' mod R; u = (Y + m*p) / R
    m = _carry_digits(_dot(t["NB"], y[:32]).to(torch.int64), 32)
    u_pb = _dot(t["PB"], m).to(torch.int64)
    u_pb[: ND + 1] += y
    u = _carry_digits(u_pb, 66)
    limbs = u[32:64:2] + (u[33:65:2] << 8)
    return _cond_sub_p(limbs, basis.p_limbs16).to(torch.int32)


def _carry_digits(cols: torch.Tensor, n_out: int) -> torch.Tensor:
    """Signed base-256 digit columns -> canonical bytes (n_out, N); carries
    past the last row are dropped (mod 256^n_out)."""
    out = torch.empty((n_out, cols.shape[1]), dtype=torch.int64, device=cols.device)
    carry = torch.zeros_like(cols[0])
    for c in range(n_out):
        v = cols[c] + carry if c < cols.shape[0] else carry
        out[c] = v & 255
        carry = v >> 8  # arithmetic shift: floor division for negatives
    return out


def _cond_sub_p(limbs: torch.Tensor, p_limbs) -> torch.Tensor:
    L = limbs.shape[0]
    diff = torch.empty_like(limbs)
    c = torch.ones_like(limbs[0])
    for i in range(L):
        v = limbs[i] + (0xFFFF - p_limbs[i]) + c
        diff[i] = v & 0xFFFF
        c = v >> 16
    return torch.where((c > 0)[None], diff, limbs)


# ---------------------------------------------------------------------------
# the digit planes between `residues_in` and `matmul_fold`
# ---------------------------------------------------------------------------


def pack_k4(d: torch.Tensor) -> torch.Tensor:
    """(P+1, K, B) int8 digits -> (P+1, ceil(K/4), B) int32 words holding the
    digits of rows 4w .. 4w+3 in bytes 0 .. 3 (zeros past K): the layout the
    product kernel's operand registers take, four contraction steps a word."""
    p1, K, B = d.shape
    k4 = -(-K // 4)
    if k4 * 4 != K:
        d = torch.cat([d, d.new_zeros((p1, k4 * 4 - K, B))], dim=1)
    by = d.reshape(p1, k4, 4, B).permute(0, 1, 3, 2).contiguous()
    return by.reshape(p1, k4, 4 * B).view(torch.int32)  # fresh strides, also for B = 1


def unpack_k4(w: torch.Tensor, K: int) -> torch.Tensor:
    """Inverse of `pack_k4`: (P+1, K4, B) int32 -> (P+1, K, B) int8."""
    p1, k4, B = w.shape
    d = w.contiguous().unsqueeze(-1).view(torch.int8)  # (P+1, K4, B, 4)
    return d.permute(0, 1, 3, 2).reshape(p1, 4 * k4, B)[:, :K]


# ---------------------------------------------------------------------------
# constant-matrix plans
# ---------------------------------------------------------------------------


def residues_of_ints_np(vals_bytes: np.ndarray, qs) -> np.ndarray:
    """(32, N) u8 byte array (LE) -> (len(qs), N) residues, via one f64
    matmul (host-side table building)."""
    qa = np.asarray(qs, np.int64)[:, None]
    pow256 = np.array(
        [[pow(256, l, int(q)) for l in range(32)] for q in np.asarray(qs)],
        np.int64,
    )
    # f64 matmul hits BLAS (int64 matmul does not) and is exact here:
    # values <= 32 * 255 * 2^14 < 2^27 << 2^53; the mod runs as exact f64
    # floor-division
    acc = pow256.astype(np.float64) @ vals_bytes.astype(np.float64)
    qf = qa.astype(np.float64)
    acc -= np.floor(acc / qf) * qf
    return acc.astype(np.int64)


def ints_to_bytes_np(vals) -> np.ndarray:
    """list of N ints (< 2^256) -> (32, N) u8."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, np.uint8).reshape(-1, 32).T.copy()


def matrix_digits_np(basis: CrtBasis, w_ints, mont_fix: bool = True):
    """The two balanced 7-bit digit planes (P+1, Kout, K) int8 of a constant
    matrix's residues, t-scaled per prime (t = 1 on the redundant lane)."""
    p = basis.p
    Kout, K = len(w_ints), len(w_ints[0])
    scale = (R256 % p) if mont_fix else 1
    flat = [int(w) * scale % p for row in w_ints for w in row]
    res = residues_of_ints_np(ints_to_bytes_np(flat), basis.qs_host)  # (P+1, Kout*K)
    # t-scale + balance + chunk in exact f64 / i32
    ts = np.array(basis.t_host + [1], np.float64)[:, None]
    qf = np.array(basis.qs_host, np.float64)[:, None]
    rf = res.astype(np.float64) * ts  # < 2^28, exact
    rf -= np.floor(rf / qf) * qf
    rb = np.where(rf > qf // 2, rf - qf, rf).astype(np.int32)
    c0 = ((rb + 64) & 127) - 64
    c1 = (rb - c0) >> 7
    assert np.abs(c1).max() < 64
    sh = (len(basis.qs_host), Kout, K)
    return c0.astype(np.int8).reshape(sh), c1.astype(np.int8).reshape(sh)


# The digit planes' rows are padded with zero columns to a multiple of this
# many bytes: `matmul_fold`'s kernel loads them with TMA, which needs row
# strides of 16 bytes. Zeros change no sum.
K_ALIGN = 16


class CrtMatmulPlan:
    """Digit planes of one constant matrix W (mod p) on a device. With
    mont_fix, W is pre-scaled by R so reconstruct's R^-1 cancels and the
    call computes exactly (W @ x) mod p, Montgomery-domain preserving.

    `W` holds both planes as one (2, P+1, Kout, kp) int8 tensor whose rows
    are padded with zeros to kp = K rounded up to `K_ALIGN`; `W0` and `W1`
    are its (P+1, Kout, K) views, the JAX package's planes."""

    def __init__(self, basis: CrtBasis, w_ints, device, mont_fix: bool = True):
        w0, w1 = matrix_digits_np(basis, w_ints, mont_fix)
        self._set(w0, w1, device)

    @classmethod
    def from_digits(cls, w0: np.ndarray, w1: np.ndarray, device) -> "CrtMatmulPlan":
        """A plan from its two (P+1, Kout, K) int8 digit planes."""
        plan = object.__new__(cls)
        plan._set(w0, w1, device)
        return plan

    def _set(self, w0: np.ndarray, w1: np.ndarray, device) -> None:
        p1, self.kout, self.k = w0.shape
        self.kp = -(-self.k // K_ALIGN) * K_ALIGN
        w = np.zeros((2, p1, self.kout, self.kp), np.int8)
        w[0, ..., : self.k] = w0
        w[1, ..., : self.k] = w1
        self.W = torch.from_numpy(w).to(device)
        self.W0 = self.W[0, ..., : self.k]
        self.W1 = self.W[1, ..., : self.k]


def _bdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P, m, k) @ (P, k, n) -> (P, m, n) float32, prime-batched, exact."""
    _check_exact_matmul(b)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def crt_matmul(basis: CrtBasis, plan: CrtMatmulPlan, x_limbs: torch.Tensor,
               pre=None) -> torch.Tensor:
    """(W @ x) mod p. x_limbs: (16, K, B) int32 canonical 16-bit limb planes;
    pre: optional (P+1, K, B) int16 residue table multiplied in pointwise
    before the product (implied integer < p). Returns (16, Kout, B) int32.

    residues_in -> matmul_fold -> reconstruct: three kernel launches on a
    CUDA tensor, their plain versions on a CPU tensor, at every size. The
    kernels hold no product buffers, so only the plain product splits a wide
    batch (`crt_cuda.matmul_fold_plain`)."""
    from stark_tpu_torch.ops import crt_cuda

    L, K, B = x_limbs.shape
    if K != plan.k:
        raise ValueError(f"x has {K} rows, the plan contracts {plan.k}")
    x0, x1 = crt_cuda.residues_in(basis, x_limbs, pre)
    s = crt_cuda.matmul_fold(basis, plan, x0, x1)
    out = crt_cuda.reconstruct(basis, s.reshape(s.shape[0], plan.kout * B))
    return out.reshape(L, plan.kout, B)
