"""Poseidon digest over BLS12-381 Fr: the host hash, the plain PyTorch
permutation and the tree kernels.

Counterpart of `stark_tpu/ops/poseidon.py`, bit-compatible with neptune
5.1.0 as that module is: arity 2 (t = 3), 8 full and 55 partial rounds,
Merkle-tree domain tag 3, Grain-LFSR round constants and the Cauchy MDS
matrix M[i][j] = 1/(i + t + j). A message of at most 64 bytes is
zero-padded to a multiple of 32, each 32-byte chunk read little-endian as a
canonical Fr element; the digest is the 32-byte little-endian `state[1]`
after the rounds.

Three implementations share the constants:

* the host hash (`poseidon_digest`) on python ints, which the verifier's
  branch walk uses (a copy of the JAX package's);
* the plain PyTorch permutation (`poseidon_permute_plain`,
  `poseidon_hash_pairs_plain`) over (16, n) Montgomery limb planes, round
  for round the JAX package's batched device path (`poseidon.py:147-213`),
  on the plain field product `field_cuda.mmul_plain`;
* the tree wrappers `poseidon_leaves` and `poseidon_pairs` on packed (8, n)
  int32 digest words, the layout of the blake2s trees. On a CUDA tensor
  they launch `csrc/poseidon.cu`, which runs the permutation's optimized
  form (`sparse_form`) over `kernel_table`: a thread a hash, or a group of
  4 lanes a hash for a level of fewer than `LANE_FORM_BELOW` hashes. On a
  CPU tensor they run `poseidon_leaves_plain` / `poseidon_pairs_plain`. The
  JAX package has no Pallas kernel here: its permutation is an XLA
  `lax.scan`.
"""

from __future__ import annotations

import functools
import types

import torch

from stark_tpu_torch.fields.field import BLS12_381_FR, FieldSpec, int_to_limbs
from stark_tpu_torch.ops import build, field_cuda, ntt
from stark_tpu_torch.ops import modmath as mm

T = 3  # arity 2 + 1
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 55
DOMAIN_TAG = 3  # neptune HashType::MerkleTree for arity 2: 2^2 - 1


class _Grain:
    """80-bit Grain LFSR from the Poseidon reference implementation."""

    def __init__(self, field: int, sbox: int, n: int, t: int, r_f: int, r_p: int):
        bits: list[int] = []
        for val, width in ((field, 2), (sbox, 4), (n, 12), (t, 12), (r_f, 10), (r_p, 10)):
            bits += [(val >> (width - 1 - i)) & 1 for i in range(width)]
        bits += [1] * 30
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._clock()

    def _clock(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def next_bit(self) -> int:
        # self-shrinking filter: emit y of each (x, y) pair only when x == 1
        while True:
            x = self._clock()
            y = self._clock()
            if x:
                return y

    def next_field(self, n_bits: int, p: int) -> int:
        while True:
            v = 0
            for _ in range(n_bits):
                v = (v << 1) | self.next_bit()
            if v < p:
                return v


@functools.lru_cache(maxsize=None)
def round_constants(
    t: int = T,
    r_f: int = FULL_ROUNDS,
    r_p: int = PARTIAL_ROUNDS,
    p: int = BLS12_381_FR.p,
) -> tuple[int, ...]:
    """t*(R_F+R_P) Grain round constants, in consumption order."""
    g = _Grain(1, 1, 255, t, r_f, r_p)
    return tuple(g.next_field(255, p) for _ in range(t * (r_f + r_p)))


@functools.lru_cache(maxsize=None)
def mds_matrix(t: int = T, p: int = BLS12_381_FR.p) -> tuple[tuple[int, ...], ...]:
    """Cauchy MDS with x_i = i, y_j = t + j (symmetric: 1/(i + t + j))."""
    return tuple(tuple(pow(i + t + j, p - 2, p) for j in range(t)) for i in range(t))


def _is_partial(rnd: int) -> bool:
    half = FULL_ROUNDS // 2
    return half <= rnd < half + PARTIAL_ROUNDS


def _permute_host(state: list[int], p: int) -> list[int]:
    rc = round_constants(p=p)
    mds = mds_matrix(p=p)
    off = 0
    for rnd in range(FULL_ROUNDS + PARTIAL_ROUNDS):
        state = [(s + rc[off + i]) % p for i, s in enumerate(state)]
        off += T
        if _is_partial(rnd):
            state[0] = pow(state[0], 5, p)
        else:
            state = [pow(s, 5, p) for s in state]
        state = [sum(mds[i][j] * state[i] for i in range(T)) % p for j in range(T)]
    return state


def poseidon_digest(message: bytes, spec: FieldSpec = BLS12_381_FR) -> bytes:
    """`PoseidonDigest::hash`: a message of 1-64 bytes -> its 32-byte
    little-endian digest. Raises on an oversize or empty message and on a
    non-canonical chunk, where the reference panics."""
    n = len(message)
    if n > 64:
        raise ValueError(f"poseidon digest input must be <= 64 bytes, got {n}")
    if n == 0:
        raise ValueError("poseidon digest input must be non-empty")
    padded = message + b"\x00" * ((((n - 1) // 32) + 1) * 32 - n)
    state = [DOMAIN_TAG, 0, 0]
    for i, off in enumerate(range(0, len(padded), 32)):
        v = int.from_bytes(padded[off : off + 32], "little")
        if v >= spec.p:
            raise ValueError("chunk is not a canonical BLS12-381 Fr element")
        state[1 + i] = v
    state = _permute_host(state, spec.p)
    return spec.to_bytes_le(state[1])


# ---------------------------------------------------------------------------
# the plain PyTorch permutation over (16, n) Montgomery limb planes
# ---------------------------------------------------------------------------


def _sbox5_plain(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    x2 = field_cuda.mmul_plain(spec, x, x)
    x4 = field_cuda.mmul_plain(spec, x2, x2)
    return field_cuda.mmul_plain(spec, x4, x)


def poseidon_permute_plain(spec: FieldSpec, state: list[torch.Tensor]) -> list[torch.Tensor]:
    """The permutation of `state`, three (L, n) Montgomery limb planes, in
    plain PyTorch. Per round: add the round constants, the S-box x^5 (on
    state[0] alone in the partial rounds) and the MDS product, its nine
    products as one batched plain product."""
    L = spec.num_limbs
    dev = state[0].device
    rc = mm.mont_consts(spec, round_constants(p=spec.p), dev)  # (L, 3 * rounds)
    mds = mds_matrix(p=spec.p)
    mds_m = mm.mont_consts(spec, [mds[i][j] for i in range(T) for j in range(T)], dev)
    st = torch.stack(state, dim=1)  # (L, 3, n)
    n = st.shape[2]
    for rnd in range(FULL_ROUNDS + PARTIAL_ROUNDS):
        st = mm.madd(spec, st, rc[:, T * rnd : T * (rnd + 1), None])
        if _is_partial(rnd):
            st = torch.cat([_sbox5_plain(spec, st[:, 0]).unsqueeze(1), st[:, 1:]], dim=1)
        else:
            st = _sbox5_plain(spec, st.reshape(L, T * n)).reshape(L, T, n)
        # terms[:, i, j] = mds[i][j] * state[i]
        terms = field_cuda.mmul_plain(
            spec,
            mds_m.reshape(L, T, T, 1).expand(L, T, T, n).contiguous(),
            st.unsqueeze(2).expand(L, T, T, n).contiguous(),
        )
        acc = mm.madd(spec, mm.madd(spec, terms[:, 0], terms[:, 1]), terms[:, 2])
        st = acc.contiguous()
    return [st[:, i].contiguous() for i in range(T)]


def poseidon_hash_pairs_plain(spec: FieldSpec, left: torch.Tensor,
                              right: torch.Tensor) -> torch.Tensor:
    """Poseidon(tag, left, right): (L, n) canonical limb planes -> the (L, n)
    canonical digests (`state[1]`)."""
    n = left.shape[1]
    r2 = torch.tensor(int_to_limbs(spec.r2_mod_p, spec.num_limbs), dtype=torch.int32,
                      device=left.device).reshape(-1, 1).expand(-1, n).contiguous()
    tag = mm.mont_const(spec, DOMAIN_TAG, left.device).expand(-1, n).contiguous()
    state = [tag, field_cuda.mmul_plain(spec, left, r2),
             field_cuda.mmul_plain(spec, right, r2)]
    one = torch.zeros_like(r2)
    one[0] = 1
    return field_cuda.mmul_plain(spec, poseidon_permute_plain(spec, state)[1], one)


# ---------------------------------------------------------------------------
# the tree's plain versions on packed digest words
# ---------------------------------------------------------------------------


def _to_limbs(words: torch.Tensor) -> torch.Tensor:
    """(8, n) int32 little-endian words -> (16, n) 16-bit limbs."""
    return ntt.unpack_words(words.t())


def _to_words(limbs: torch.Tensor) -> torch.Tensor:
    """(16, n) 16-bit limbs -> (8, n) int32 words."""
    return ntt.pack_words(limbs).t().contiguous()


def poseidon_leaves_plain(leaf_words: torch.Tensor) -> torch.Tensor:
    """Rows 0-7 of a (W, N) leaf buffer (the 32-byte values; the rest is
    blake block padding) -> the (8, N) words of Poseidon(tag, v, 0)."""
    left = _to_limbs(leaf_words[:8])
    return _to_words(poseidon_hash_pairs_plain(BLS12_381_FR, left, torch.zeros_like(left)))


def poseidon_pairs_plain(layer: torch.Tensor) -> torch.Tensor:
    """An (8, 2m) digest layer -> the (8, m) words of Poseidon(tag, layer
    column 2i, column 2i + 1)."""
    return _to_words(poseidon_hash_pairs_plain(
        BLS12_381_FR, _to_limbs(layer[:, 0::2]), _to_limbs(layer[:, 1::2])))


# ---------------------------------------------------------------------------
# the kernels: the permutation's optimized form and its table
# ---------------------------------------------------------------------------

HALF = FULL_ROUNDS // 2  # 4: the first partial round
LAST_PARTIAL = HALF + PARTIAL_ROUNDS - 1  # 58
LAST_ROUND = FULL_ROUNDS + PARTIAL_ROUNDS - 1  # 62
# Levels of fewer hashes than this run the lane form (LANES lanes a hash,
# lane i < 3 holding state[i]); wider ones a thread a hash. Both are builds
# of one source over one table. Set from the two forms' times at each width
# on an H100 (`scripts/poseidon_kernels_cuda.py`, PERF.md row P).
LANE_FORM_BELOW = 1 << 14
LANES = 4
# The kernels' values are 9 limbs of 29 bits in Montgomery form for
# R' = 2^261 (`csrc/field.cuh`'s radix-2^29 form); a table entry is its 9
# limbs and 3 words of padding
RADIX_BITS, LIMBS, ENTRY_WORDS = 29, 9, 12
# `kernel_table`'s layout, in entries (`csrc/poseidon.cu` mirrors it)
E_IN = 0  # c[0][1], c[0][2] (plain): round 0's constants on the input lanes
E_K0 = 2  # round 0's matrix on lanes 1 and 2: row j at E_K0 + 2j
E_C0P = 8  # round 0's fixed lanes (the tag) and round 1's constants, a row each
E_C0L = 11  # the same for a leaf, whose lane 2 (0) is fixed too
E_MDS = 14  # the full rounds' matrix, row by row
E_PRE = 23  # round 3's matrix (the pre-matrix)
E_NXT1 = 32  # the constants rounds 1-3 add for the next round, 3 a round
E_NXT2 = 41  # the same for rounds 58-61
E_PART = 53  # partial round r at E_PART + 6 (r - 4): PART_SLOTS
PART_SLOTS = ("a00", "row0_0", "row0_1", "col0_0", "col0_1", "next0")
E_OUT = E_PART + len(PART_SLOTS) * PARTIAL_ROUNDS  # the last round's output row
E_ONE = E_OUT + T  # R' mod p: the lane form's product that keeps a lane
E_ZERO = E_ONE + 1
TABLE_ENTRIES = E_ZERO + 1


@functools.lru_cache(maxsize=None)
def sparse_form():
    """The permutation over BLS12-381's Fr in its optimized form (Grassi et
    al., "Poseidon", USENIX Security 2021, Appendix B) as (c, A, pre,
    sparse), with x <- A x and A[j][i] = M[i][j]: `c` the round constants
    with each partial round's constants but state[0]'s moved into the next
    round's (A applied to them); `sparse[r]` = (a00, row0, col0) of each
    partial round r, from the last back, whose matrix is factored as S D
    with S = [[a00, row0], [col0, I]] sparse and D = diag(1, Â), which
    commutes with the partial S-box and goes into the round before; `pre`,
    round 3's matrix, takes the last D."""
    t, p = T, BLS12_381_FR.p
    rc = round_constants(p=p)
    c = [list(rc[t * r : t * r + t]) for r in range(LAST_ROUND + 1)]
    mds = mds_matrix(p=p)
    A = [[mds[i][j] for i in range(t)] for j in range(t)]

    def apply(m, v):
        return [sum(m[j][i] * v[i] for i in range(t)) % p for j in range(t)]

    def matmul(x, y):
        return [[sum(x[j][k] * y[k][i] for k in range(t)) % p for i in range(t)]
                for j in range(t)]

    for r in range(HALF, LAST_PARTIAL + 1):
        moved = apply(A, [0] + c[r][1:])
        c[r + 1] = [(a + b) % p for a, b in zip(c[r + 1], moved)]
        c[r][1:] = [0] * (t - 1)
    sparse, cur = {}, A
    for r in range(LAST_PARTIAL, HALF - 1, -1):
        (a, b), (d, e) = cur[1][1:], cur[2][1:]
        det_inv = pow((a * e - b * d) % p, -1, p)
        inv = [[e * det_inv % p, -b * det_inv % p], [-d * det_inv % p, a * det_inv % p]]
        row0 = [sum(cur[0][1 + k] * inv[k][i] for k in range(2)) % p for i in range(2)]
        sparse[r] = (cur[0][0], tuple(row0), (cur[1][0], cur[2][0]))
        cur = matmul([[1, 0, 0], [0, a, b], [0, d, e]], A)
    return (tuple(map(tuple, c)), tuple(map(tuple, A)), tuple(map(tuple, cur)),
            types.MappingProxyType(sparse))


@functools.lru_cache(maxsize=None)
def kernel_entries() -> tuple[int, ...]:
    """The kernel's TABLE_ENTRIES constants (the layout above), each below p.

    A state value is held in Montgomery form for R' = 2^261 (x R' mod p), as
    is an S-box's output, so a matrix entry is A R': the reduction of the
    row's sum (a division by R') leaves the next state in that form. The
    constants of the next round are added to the sum times R' (x R',
    shifted up 261 bits). Round 0 S-boxes the plain inputs (v + c, whose
    S-box output is v^5 R'^-4), so its matrix is A R'^6; the tag lane, and a
    leaf's lane 2 (0), give constants. The last round's output row is A[1]
    (the reduction leaves the plain digest)."""
    p = BLS12_381_FR.p
    R = (1 << LIMBS * RADIX_BITS) % p
    c, A, pre, sparse = sparse_form()

    def sbox(x: int) -> int:
        return pow(x % p, 5, p)

    e = [0] * TABLE_ENTRIES
    e[E_IN], e[E_IN + 1] = c[0][1], c[0][2]
    tag_box = sbox(DOMAIN_TAG + c[0][0])
    for j in range(T):
        for i in (1, 2):
            e[E_K0 + 2 * j + i - 1] = A[j][i] * pow(R, 6, p) % p
        fixed = A[j][0] * tag_box + c[1][j]
        e[E_C0P + j] = fixed * R % p
        e[E_C0L + j] = (fixed + A[j][2] * sbox(c[0][2])) * R % p
        for i in range(T):
            e[E_MDS + T * j + i] = A[j][i] * R % p
            e[E_PRE + T * j + i] = pre[j][i] * R % p
        e[E_OUT + j] = A[1][j]
        for k, r in enumerate((1, 2, 3)):
            e[E_NXT1 + T * k + j] = c[r + 1][j] * R % p
        for k, r in enumerate(range(LAST_PARTIAL, LAST_ROUND)):
            e[E_NXT2 + T * k + j] = c[r + 1][j] * R % p
    for r in range(HALF, LAST_PARTIAL + 1):
        a00, row0, col0 = sparse[r]
        base = E_PART + len(PART_SLOTS) * (r - HALF)
        e[base : base + len(PART_SLOTS)] = [
            v * R % p for v in (a00, row0[0], row0[1], col0[0], col0[1], c[r + 1][0])]
    e[E_ONE], e[E_ZERO] = R, 0
    return tuple(e)


@functools.lru_cache(maxsize=None)
def kernel_table() -> tuple[int, ...]:
    """`kernel_entries` as ENTRY_WORDS uint32 words an entry: the 9 limbs of
    29 bits, least significant first, then 3 zero words."""
    mask = (1 << RADIX_BITS) - 1
    return tuple((v >> RADIX_BITS * i) & mask if i < LIMBS else 0
                 for v in kernel_entries() for i in range(ENTRY_WORDS))


@functools.lru_cache(maxsize=None)
def _device_table(device: torch.device) -> torch.Tensor:
    """`kernel_table` on `device` as int32 (every word below 2^29), made once a
    device; each block of a launch stages it in shared memory."""
    return torch.tensor(kernel_table(), dtype=torch.int32, device=device)


def lane_form(n: int) -> bool:
    """Whether a level of n hashes runs the lane form (`LANE_FORM_BELOW`)."""
    return n < LANE_FORM_BELOW


def _check_words(what: str, t: torch.Tensor, rows: int) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what} takes a contiguous 2-D int32 tensor")
    if t.shape[0] < rows:
        raise ValueError(f"{what} needs at least {rows} word rows, got {t.shape[0]}")


def _launch(entry: str, src: torch.Tensor, n: int) -> torch.Tensor:
    """(8, n) output words of the kernel entry point `entry` over `src`, in
    the form `lane_form(n)` picks."""
    words, np32, stream = field_cuda.cuda_args(BLS12_381_FR, src)
    out = torch.empty((8, n), dtype=torch.int32, device=src.device)
    rc = getattr(build.load(), entry)(
        src.data_ptr(), out.data_ptr(), n, src.shape[1], _device_table(src.device).data_ptr(),
        int(lane_form(n)), words, np32, stream,
    )
    build.check(rc, entry)
    return out


def poseidon_leaves(leaf_words: torch.Tensor) -> torch.Tensor:
    """(W >= 8, N) int32 leaf words -> (8, N) int32 digest words of
    Poseidon(tag, v, 0), v the leaf's value in rows 0-7."""
    _check_words("poseidon_leaves", leaf_words, 8)
    if leaf_words.device.type == "cpu":
        return poseidon_leaves_plain(leaf_words)
    out = _launch("stark_poseidon_leaves", leaf_words, leaf_words.shape[1])
    poseidon_leaves.launches += 1
    return out


poseidon_leaves.launches = 0


def poseidon_pairs(layer: torch.Tensor) -> torch.Tensor:
    """(8, 2m) int32 digest words -> (8, m): Poseidon(tag, column 2i,
    column 2i + 1)."""
    _check_words("poseidon_pairs", layer, 8)
    if layer.shape[0] != 8 or layer.shape[1] % 2:
        raise ValueError(f"poseidon_pairs takes an (8, 2m) layer, got {tuple(layer.shape)}")
    if layer.device.type == "cpu":
        return poseidon_pairs_plain(layer)
    out = _launch("stark_poseidon_pairs", layer, layer.shape[1] // 2)
    poseidon_pairs.launches += 1
    return out


poseidon_pairs.launches = 0
