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
  they launch `csrc/poseidon.cu` (one thread a hash), on a CPU tensor they
  run `poseidon_leaves_plain` / `poseidon_pairs_plain`. The JAX package has
  no Pallas kernel here: its permutation is an XLA `lax.scan`.
"""

from __future__ import annotations

import functools

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
# the kernels
# ---------------------------------------------------------------------------


def _words8(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


@functools.lru_cache(maxsize=None)
def kernel_table(spec: FieldSpec = BLS12_381_FR) -> tuple[int, ...]:
    """The kernel's constants as 8 little-endian uint32 words an element, in
    Montgomery form (x R mod p): the 189 round constants in consumption
    order, the 9 MDS entries row by row (entry 3i + j is M[i][j]), R^2 mod p
    (the factor that takes an input into Montgomery form, as a plain value),
    then the domain tag."""
    p, R = spec.p, spec.r_mod_p
    mds = mds_matrix(p=p)
    vals = ([c * R % p for c in round_constants(p=p)]
            + [mds[i][j] * R % p for i in range(T) for j in range(T)]
            + [spec.r2_mod_p, DOMAIN_TAG * R % p])
    return tuple(w for v in vals for w in _words8(v))


@functools.lru_cache(maxsize=None)
def _device_table(device: torch.device) -> torch.Tensor:
    """`kernel_table` as int32 bit patterns on `device`, made once a device:
    each launch copies it into the kernel's constant memory on its stream."""
    words = [w - (1 << 32) if w >= 1 << 31 else w for w in kernel_table()]
    return torch.tensor(words, dtype=torch.int32, device=device)


def _check_words(what: str, t: torch.Tensor, rows: int) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what} takes a contiguous 2-D int32 tensor")
    if t.shape[0] < rows:
        raise ValueError(f"{what} needs at least {rows} word rows, got {t.shape[0]}")


def _launch(entry: str, src: torch.Tensor, n: int) -> torch.Tensor:
    """(8, n) output words of the kernel entry point `entry` over `src`."""
    words, np32, stream = field_cuda.cuda_args(BLS12_381_FR, src)
    out = torch.empty((8, n), dtype=torch.int32, device=src.device)
    rc = getattr(build.load(), entry)(
        src.data_ptr(), out.data_ptr(), n, src.shape[1], _device_table(src.device).data_ptr(),
        words, np32, stream,
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
