"""The field kernels and their plain versions: the elementwise Montgomery
multiply, the scalar-lane power and the prefix-product scan (the JAX package
keeps the three in `ops/pallas_field.py`).

All take int32 limb planes, limbs first (16-bit limbs, Montgomery form,
R = 2^256, the JAX package's layout and bit patterns). On a CUDA tensor
`mmul` launches `csrc/mmul.cu` (which replaces
`stark_tpu/ops/pallas_field.py:174`), `mpow_scalar` and `scan_prod` launch
`csrc/fieldops.cu` (`:573` and `:626`), or raise; on a CPU tensor each runs
its `*_plain` version. Nothing else chooses the route: no size gate, no
environment variable, no fallback on error.

`mmul_plain` is the same function in plain PyTorch (16x16-bit schoolbook
columns and REDC in int64); `mpow_scalar_plain` and `scan_prod_plain` are
loops of it. They also hold the kernels to account on the card. The power's
kernel takes e recoded on the host (`mpow_streams`, `mpow_start`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from stark_tpu_torch.fields.field import LIMB_BITS, FieldSpec, int_to_limbs
from stark_tpu_torch.ops import build

_MASK = (1 << LIMB_BITS) - 1
_SKEW_MAX = 1 << 23  # int64 elements (64 MiB) of `mul_cols`' one-product form


def _words8(x: int) -> list[int]:
    """A 256-bit integer as 8 little-endian uint32 words."""
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


@functools.lru_cache(maxsize=None)
def _consts(spec: FieldSpec):
    """Host constants: p as 16-bit limbs, n' = -p^-1 mod R as limbs, and the
    kernels' (8 x uint32 words of p then 8 of R mod p, -p^-1 mod 2^32)."""
    L = spec.num_limbs
    R = 1 << spec.r_bits
    n_prime = (-pow(spec.p, -1, R)) % R
    words = (ctypes.c_uint32 * 16)(*_words8(spec.p), *_words8(spec.r_mod_p))
    np32 = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    return int_to_limbs(spec.p, L), int_to_limbs(n_prime, L), words, np32


def _col(limbs, like: torch.Tensor) -> torch.Tensor:
    """Limb tuple -> (L, 1) int64 column on `like`'s device."""
    return torch.tensor(limbs, dtype=torch.int64, device=like.device).reshape(-1, 1)


def normalize(cols: torch.Tensor):
    """(K, N) int64 deferred-carry columns (any sign, |column| < 2^46) ->
    exact 16-bit limbs and the carry out of the top column (negative on a
    borrow). The carry runs over 32-bit digits, two columns each (a lone top
    column is a digit of 16 bits), so the loop takes half as many steps."""
    K = cols.shape[0]
    digits = cols[0::2].clone()
    digits[: K // 2] += cols[1::2] << LIMB_BITS
    out = torch.empty_like(digits)
    c = torch.zeros_like(cols[0])
    for k in range(digits.shape[0]):
        v = digits[k] + c
        out[k] = v
        c = v >> (2 * LIMB_BITS if 2 * k + 1 < K else LIMB_BITS)
    limbs = torch.stack([out & _MASK, (out >> LIMB_BITS) & _MASK], dim=1)
    return limbs.reshape(-1, cols.shape[1])[:K], c


def mul_cols(a: torch.Tensor, b: torch.Tensor, ncols: int) -> torch.Tensor:
    """Columns 0..ncols-1 of the limb product a*b (no carries): out[k] =
    sum_{i+j=k} a_i*b_j. a: (La, N), b: (Lb, N) or (Lb, 1), int64 limbs.
    Up to `_SKEW_MAX` elements, every a_i*b_j at once, row i shifted i
    columns by a padded reshape, then summed (a few ops at any La: what a
    narrow product costs is its number of ops); above it, a row at a time."""
    La, Lb, n = a.shape[0], b.shape[0], a.shape[1]
    if La * (La + Lb) * n <= _SKEW_MAX:
        prod = F.pad((a[:, None] * b[None]).expand(La, Lb, n), (0, 0, 0, La))
        cols = prod.reshape(-1, n)[: La * (La + Lb - 1)].reshape(La, La + Lb - 1, n).sum(0)
        return F.pad(cols[:ncols], (0, 0, 0, max(0, ncols - cols.shape[0])))
    out = torch.zeros((ncols, n), dtype=torch.int64, device=a.device)
    for i in range(a.shape[0]):
        hi = min(b.shape[0], ncols - i)
        if hi <= 0:
            break
        out[i : i + hi] += a[i] * b[:hi]
    return out


def cond_sub_p(spec: FieldSpec, limbs: torch.Tensor, top: torch.Tensor):
    """Value = top*R + limbs (< 2p) -> subtract p where value >= p."""
    d, borrow = normalize(limbs - _col(_consts(spec)[0], limbs))
    return torch.where(((borrow == 0) | (top != 0))[None], d, limbs)


def mmul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p of same-shape (L, ...) int32 planes
    (full REDC: t = a*b, m = (t mod R)*n' mod R, (t + m*p)/R)."""
    L = spec.num_limbs
    p_limbs, np_limbs, _, _ = _consts(spec)
    shape = a.shape
    A = a.reshape(L, -1).to(torch.int64)
    B = b.reshape(L, -1).to(torch.int64)
    t, _ = normalize(mul_cols(A, B, 2 * L))
    m, _ = normalize(mul_cols(t[:L], _col(np_limbs, A), L))
    u, top = normalize(mul_cols(m, _col(p_limbs, A), 2 * L) + t)
    return cond_sub_p(spec, u[L:], top).to(torch.int32).reshape(shape)


def check_planes(spec: FieldSpec, *ts: torch.Tensor) -> None:
    """The kernels take contiguous int32 (L, n) planes on one device."""
    L = spec.num_limbs
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"limb planes must be torch.int32, got {t.dtype}")
        if t.dim() != 2 or t.shape[0] != L:
            raise ValueError(f"limb planes must be ({L}, n), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("limb planes must be contiguous")
        if t.device != ts[0].device:
            raise ValueError("limb planes must share one device")


def cuda_args(spec: FieldSpec, t: torch.Tensor):
    """(field words, n', stream) for a launch on t's device; raises where
    the kernels cannot run: the field first (16 limbs, and 2p < 2^256, which
    `csrc/field.cuh` asks of every field), then the device."""
    if spec.num_limbs != 16:
        raise NotImplementedError(
            f"the CUDA field kernels are built for 16-limb (256-bit R) fields, "
            f"not {spec.name}"
        )
    if 2 * spec.p >= 1 << 256:
        raise ValueError(f"the CUDA field kernels need 2p < 2^256, not {spec.name}")
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    _, _, words, np32 = _consts(spec)
    return words, np32, torch.cuda.current_stream(t.device).cuda_stream


def mmul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product of two (16, n) int32 planes."""
    check_planes(spec, a, b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.device.type == "cpu":
        return mmul_plain(spec, a, b)
    words, np32, stream = cuda_args(spec, a)
    out = torch.empty_like(a)
    rc = build.load().stark_mmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1], words, np32,
        stream,
    )
    build.check(rc, "mmul")
    mmul.launches += 1
    return out


mmul.launches = 0


def _one_like(spec: FieldSpec, like: torch.Tensor) -> torch.Tensor:
    """Montgomery one broadcast to `like`'s shape (limbs first)."""
    one = torch.tensor(int_to_limbs(spec.r_mod_p, spec.num_limbs), dtype=torch.int32,
                       device=like.device)
    return one.reshape((-1,) + (1,) * (like.dim() - 1)).expand(like.shape).contiguous()


def mpow_scalar_plain(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e of a (16, k) plane, MSB-first square-and-multiply from Montgomery
    one: 0 -> 0 for e > 0, and e = 0 gives one."""
    acc = _one_like(spec, a)
    for i in range(max(e.bit_length(), 1) - 1, -1, -1):
        acc = mmul_plain(spec, acc, acc)
        if (e >> i) & 1:
            acc = mmul_plain(spec, acc, a)
    return acc


MPOW_LANES = 32  # columns of one `mpow_scalar` launch: a lane of each warp
MPOW_STREAMS = 2  # its multiply warps beside the squaring one (`csrc/fieldops.cu`)
MPOW_WINDOW = 4  # bits of a digit, the unit of e dealt to a multiply warp
MPOW_TAIL = 2  # digits at the top of e that stream 0 keeps


def mpow_digits(e: int, window: int = MPOW_WINDOW) -> list[tuple[int, int]]:
    """e in fixed windows: (position, digit) of each nonzero `window`-bit
    digit, lowest first, so that e = sum(d << pos) with 0 < d < 2^window and
    every position a multiple of `window`."""
    mask = (1 << window) - 1
    return [(pos, (e >> pos) & mask) for pos in range(0, e.bit_length(), window)
            if (e >> pos) & mask]


def mpow_streams(e: int, streams: int = MPOW_STREAMS, window: int = MPOW_WINDOW,
                 tail: int = MPOW_TAIL) -> list[int]:
    """e recoded for the kernel: one exponent for each of its `streams`
    multiply warps, disjoint and summing to e. The digits (`mpow_digits`)
    are dealt round robin, lowest first, but the top `tail` go to stream 0,
    whose warp folds the others' products in before its first digit above
    theirs: after the last squaring one product is left."""
    digits = mpow_digits(e, window)
    out = [0] * streams
    for j, (pos, d) in enumerate(digits):
        out[0 if j >= len(digits) - tail else j % streams] |= d << pos
    return out


MPOW_R_BITS = 261  # R' of the kernel's squarings: 9 limbs of 29 bits


def mpow_start(spec: FieldSpec, e: int) -> int:
    """Stream 0's starting value: the kernel squares with R' = 2^261,
    so the value it hands over for bit i is x_i 2^(-5 (2^i - 1)) (x_i the
    power a^(2^i) in Montgomery form); over the bits of e the factors come
    to 2^(-5 (e - popcount e)), which a start of R 2^(5 (e - popcount e))
    mod p cancels (R = 2^256 makes it Montgomery one for e = 0)."""
    shift = MPOW_R_BITS - spec.r_bits
    return spec.r_mod_p * pow(2, shift * (e - bin(e).count("1")), spec.p) % spec.p


def mpow_words(spec: FieldSpec, e: int, parts: list[int]):
    """The kernel's exponent argument: each stream's 8 words, then the 8
    words of `mpow_start`."""
    words = [w for x in parts + [mpow_start(spec, e)] for w in _words8(x)]
    return (ctypes.c_uint32 * len(words))(*words)


def mpow_scalar(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise for a small (16, k <= MPOW_LANES) Montgomery plane and an
    exponent 0 <= e < 2^256, the whole chain in one launch: a warp squares,
    `MPOW_STREAMS` warps multiply in the powers `mpow_streams` gives them."""
    check_planes(spec, a)
    if not 0 <= e < 1 << 256:
        raise ValueError("the exponent must lie in [0, 2^256)")
    if a.shape[1] > MPOW_LANES:
        raise ValueError(
            f"mpow_scalar takes at most {MPOW_LANES} lanes, got {a.shape[1]}"
        )
    if a.device.type == "cpu":
        return mpow_scalar_plain(spec, a, e)
    words, np32, stream = cuda_args(spec, a)
    out = torch.empty_like(a)
    parts = mpow_streams(e)
    rc = build.load().stark_mpow_scalar(
        a.data_ptr(), out.data_ptr(), a.shape[1], mpow_words(spec, e, parts),
        len(parts), max(e.bit_length(), 1), words, np32, stream,
    )
    build.check(rc, "mpow_scalar")
    mpow_scalar.launches += 1
    return out


mpow_scalar.launches = 0


def _check_scan(spec: FieldSpec, x: torch.Tensor) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"limb planes must be torch.int32, got {x.dtype}")
    if x.dim() != 3 or x.shape[0] != spec.num_limbs:
        raise ValueError(f"scan_prod takes ({spec.num_limbs}, B, C), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("limb planes must be contiguous")


def scan_prod_plain(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product along axis 1 of (16, B, C), row by row."""
    out = torch.empty_like(x)
    run = _one_like(spec, x[:, 0])
    for b in range(x.shape[1]):
        run = mmul_plain(spec, run, x[:, b].contiguous())
        out[:, b] = run
    return out


SCAN_BLOCK = 256  # most threads of a scan block, `csrc/fieldops.cu SCAN_BLOCK`
SCAN_WIDE = 1 << 14  # columns from which one thread a column keeps the card busy
SCAN_THREADS = 1 << 15  # threads a launch on fewer columns aims at


def scan_team(B: int, C: int) -> tuple[int, int]:
    """(T, CB) of a `scan_prod` launch on (16, B, C): T threads share each
    column and a block holds CB columns of T segments (powers of two, at
    most SCAN_BLOCK threads). Every product costs a warp the same time on
    its SM's integer units whether it waits on the one before or not, so a
    team pays for its second pass over the rows and its combining steps in
    products. From SCAN_WIDE columns T is 1; on fewer, T grows until the
    launch holds SCAN_THREADS threads, with segments of at least 4 rows
    once the launch holds more than 4096 threads (where products, not the
    chain, set its time). CB is as wide as 32 columns and the block allow,
    and no wider than C needs."""
    T = 1
    if C < SCAN_WIDE:
        while 2 * T <= min(B, SCAN_BLOCK) and T * C < SCAN_THREADS:
            T *= 2
        while T > 1 and T * C > 4096 and 4 * T > B:
            T //= 2
    CB = 1
    while 2 * CB * T <= SCAN_BLOCK and CB < 32 and CB < C:
        CB *= 2
    return T, CB


def scan_prod(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product along axis 1 of a (16, B, C) Montgomery
    array, independently per column c; any B, any C. On a card each column
    is scanned by a team of threads (`scan_team`)."""
    _check_scan(spec, x)
    if x.device.type == "cpu":
        return scan_prod_plain(spec, x)
    words, np32, stream = cuda_args(spec, x)
    out = torch.empty_like(x)
    B, C = x.shape[1], x.shape[2]
    T, CB = scan_team(B, C)
    rc = build.load().stark_scan_prod(
        x.data_ptr(), out.data_ptr(), B, C, T, CB, words, np32, stream,
    )
    build.check(rc, "scan_prod")
    scan_prod.launches += 1
    return out


scan_prod.launches = 0
