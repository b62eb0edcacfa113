"""Modular bigint arithmetic on (L, ...) int32 limb planes (PyTorch).

Counterpart of `stark_tpu/ops/modmath.py`, same layout: limbs first, L = 16
limbs of 16 bits, little-endian, Montgomery form with R = 2^256. Planes are
`torch.int32` holding the JAX package's uint32 bit patterns (limbs are
< 2^16, so signedness never shows); arithmetic widens to int64.

Every field product goes through `field_cuda.mmul` (the CUDA kernel on a
card, its plain version on the CPU). `madd`/`msub` are plain PyTorch, as
their JAX counterparts are XLA and not Pallas. `mpow` sends operands of a
few lanes to `field_cuda.mpow_scalar`, and `prefix_prod` (so
`multi_inv`) stitches `field_cuda.scan_prod` launches recursively, as the
JAX package does on its accelerator (`modmath.py:287-308, 351-381`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stark_tpu_torch.fields.field import LIMB_BITS, FieldSpec, int_to_limbs
from stark_tpu_torch.ops import field_cuda
from stark_tpu_torch.ops.field_cuda import cond_sub_p, normalize

# ---------------------------------------------------------------------------
# host <-> limb conversion (numpy, canonical form, limbs-first)
# ---------------------------------------------------------------------------


def ints_to_limbs_np(values, spec: FieldSpec) -> np.ndarray:
    """Iterable of python ints -> (L, N) uint32 canonical limbs."""
    vals = [int(v) % spec.p for v in values]
    L = spec.num_limbs
    if not vals:
        return np.empty((L, 0), dtype=np.uint32)
    buf = b"".join(v.to_bytes(2 * L, "little") for v in vals)
    by = np.frombuffer(buf, np.uint8).reshape(len(vals), 2 * L).astype(np.uint32)
    return np.ascontiguousarray((by[:, 0::2] | (by[:, 1::2] << 8)).T)


def limbs_to_ints_np(arr, spec: FieldSpec) -> list[int]:
    flat = np.asarray(arr).astype(np.uint32).reshape(spec.num_limbs, -1)
    return [
        sum(int(flat[i, n]) << (LIMB_BITS * i) for i in range(spec.num_limbs))
        for n in range(flat.shape[1])
    ]


def bytes_le_to_limbs_np(data: np.ndarray, spec: FieldSpec) -> np.ndarray:
    """(N, nbytes <= 2L) uint8 little-endian canonical bytes -> (L, N) uint32."""
    data = np.asarray(data, dtype=np.uint8)
    n, nb = data.shape[0], spec.num_limbs * 2
    buf = np.zeros((n, nb), dtype=np.uint8)
    w = min(nb, data.shape[1])
    buf[:, :w] = data[:, :w]
    pairs = buf.reshape(n, spec.num_limbs, 2).astype(np.uint32)
    return (pairs[:, :, 0] | (pairs[:, :, 1] << 8)).T.copy()


def limbs_to_bytes_le_np(arr, spec: FieldSpec) -> np.ndarray:
    """(L, N) uint32 canonical -> (N, repr_bytes) uint8 little-endian."""
    a = np.asarray(arr).astype(np.uint32).reshape(spec.num_limbs, -1).T
    n = a.shape[0]
    inter = np.stack([a & 0xFF, (a >> 8) & 0xFF], axis=-1).astype(np.uint8)
    inter = inter.reshape(n, spec.num_limbs * 2)
    out = np.zeros((n, spec.repr_bytes), dtype=np.uint8)
    w = min(spec.repr_bytes, spec.num_limbs * 2)
    out[:, :w] = inter[:, :w]
    return out


def bytes_le_to_limbs(spec: FieldSpec, data: torch.Tensor) -> torch.Tensor:
    """Device twin of `bytes_le_to_limbs_np`: (N, 2L) uint8 -> (L, N) int32."""
    pairs = data.reshape(data.shape[0], spec.num_limbs, 2).to(torch.int32)
    return (pairs[:, :, 0] | (pairs[:, :, 1] << 8)).T.contiguous()


def _planes(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.uint32).view(np.int32)).to(
        device
    )


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------


def mont_const(spec: FieldSpec, x: int, device) -> torch.Tensor:
    """Host int -> Montgomery-form (L, 1) constant."""
    v = (int(x) % spec.p) * spec.r_mod_p % spec.p
    return torch.tensor(int_to_limbs(v, spec.num_limbs), dtype=torch.int32,
                        device=device).reshape(-1, 1)


def mont_one(spec: FieldSpec, device) -> torch.Tensor:
    return mont_const(spec, 1, device)


def mont_consts(spec: FieldSpec, xs, device) -> torch.Tensor:
    """Host ints -> Montgomery-form (L, N)."""
    vals = [(int(x) % spec.p) * spec.r_mod_p % spec.p for x in xs]
    return _planes(ints_to_limbs_np(vals, spec), device)


def shoup_consts(spec: FieldSpec, xs, device):
    """Host ints -> the Shoup constant-multiplier pair: (L, N) limb planes of
    the plain (non-Montgomery) values w and of their companions
    floor(w * 2^r_bits / p). w * (xR) = (w*x)R, so a plain constant keeps
    Montgomery data in Montgomery form. The companions range over
    [0, 2^r_bits) and are not reduced mod p."""
    R = 1 << spec.r_bits
    nbytes = 2 * spec.num_limbs
    plain = [int(x) % spec.p for x in xs]

    def raw_limbs(vals):
        buf = b"".join(v.to_bytes(nbytes, "little") for v in vals)
        return _planes(np.frombuffer(buf, "<u2").reshape(len(vals), -1).T, device)

    return raw_limbs(plain), raw_limbs([v * R // spec.p for v in plain])


# ---------------------------------------------------------------------------
# add / sub (plain PyTorch) and the multiply (kernel)
# ---------------------------------------------------------------------------


def madd(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p; valid in canonical and Montgomery form."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    L = spec.num_limbs
    s, top = normalize(a.reshape(L, -1).to(torch.int64) + b.reshape(L, -1).to(torch.int64))
    return cond_sub_p(spec, s, top).to(torch.int32).reshape(shape)


def msub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p: limb-wise difference, p added back on a borrow."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    L = spec.num_limbs
    d, borrow = normalize(a.reshape(L, -1).to(torch.int64) - b.reshape(L, -1).to(torch.int64))
    p_col = torch.tensor(spec.p_limbs, dtype=torch.int64, device=d.device).reshape(-1, 1)
    fixed, _ = normalize(d + p_col)
    return torch.where((borrow < 0)[None], fixed, d).to(torch.int32).reshape(shape)


def mmul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of broadcastable (L, ...) planes via the kernel:
    operands are expanded to one shape and made contiguous (L, n) first."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    L = spec.num_limbs
    out = field_cuda.mmul(
        spec, a.contiguous().reshape(L, -1), b.contiguous().reshape(L, -1)
    )
    return out.reshape(shape)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    r2 = torch.tensor(int_to_limbs(spec.r2_mod_p, spec.num_limbs),
                      dtype=torch.int32, device=a.device)
    return mmul(spec, a, r2.reshape((-1,) + (1,) * (a.dim() - 1)))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    one = torch.zeros((spec.num_limbs,) + (1,) * (a.dim() - 1), dtype=torch.int32,
                      device=a.device)
    one[0] = 1
    return mmul(spec, a, one)


# ---------------------------------------------------------------------------
# pow / inverse
# ---------------------------------------------------------------------------


def mpow(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise (Montgomery in/out), MSB-first square-and-multiply.
    A (L, k) operand of at most `field_cuda.MPOW_LANES` columns is one
    `mpow_scalar` launch whatever the exponent (one launch beats the two
    `mmul` launches per bit at any length; the JAX package's gate of 8 lanes
    and 32 bits, `stark_tpu/ops/modmath.py:296`, weighs a TPU compile);
    a wider or higher-rank operand is the loop of `mmul` launches."""
    if a.dim() == 2 and a.shape[1] <= field_cuda.MPOW_LANES:
        return field_cuda.mpow_scalar(spec, a.contiguous(), e)
    nbits = max(e.bit_length(), 1)
    acc = mont_one(spec, a.device).reshape((-1,) + (1,) * (a.dim() - 1)).expand(a.shape)
    for i in range(nbits):
        acc = mmul(spec, acc, acc)
        if (e >> (nbits - 1 - i)) & 1:
            acc = mmul(spec, acc, a)
    return acc.contiguous()


def minv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Elementwise inverse via Fermat (a^(p-2)). Montgomery in/out; 0 -> 0."""
    return mpow(spec, a, spec.p - 2)


# ---------------------------------------------------------------------------
# prefix products and batched inversion (recursive scans)
# ---------------------------------------------------------------------------

# The plan's model of a level's device time on one H100, in microseconds
# (fitted to `scripts/scan_kernels_cuda.py`'s sweep): the `scan_prod` launch
# takes the longer of its products at the rate its threads sustain and its
# threads' sequential products at one step each; where C > 1 the glue
# around it (transposing copy, chunk totals, combine multiply) adds a few
# launches and a time an element, least where B is 16: PyTorch's copies of
# a (C, B) transposed view ran fastest with 64-byte rows (the sweep's
# `prefix_prod` plans at 2^17 and 2^20). A product holds a warp's SM
# partition about as long as its chain takes, so the card's rate grows with
# the warps each of its 528 partitions holds: 1 - 0.52^w of its peak at w.
LAUNCH_US = 3.0
PEAK_PRODUCTS_PER_US = 19000.0  # field products a microsecond, all partitions full
PARTITIONS = 4 * 132  # SM sub-partitions (schedulers) of an H100 SXM
STEP_US = 1.5  # one product of one warp in a launch that fills the card
GLUE_US = 5.0
GLUE_US_PER_ELEM = 3.1e-4
GLUE_US_PER_ELEM_16 = 2.6e-4  # where B is 16
# Most rows of a level (the plain version's loop on the CPU is a vectorized
# product a row); only a length with no divisor in [2, SCAN_MAX_ROWS] goes
# past it, as one level of all its rows.
SCAN_MAX_ROWS = 256


def scan_chain(B: int, C: int) -> int:
    """Products one thread of a (16, B, C) `scan_prod` launch issues one
    after another: its segment's rows but the first, the team's log2 T
    combining steps and, in a team, its rows again times the segments
    before it (a warp issues in order, and a product holds its SM's integer
    units about as long as its chain takes, so those independent products
    queue like the dependent ones)."""
    T, _ = field_cuda.scan_team(B, C)
    S = -(-B // T)
    return S - 1 + T.bit_length() - 1 + (S if T > 1 else 0)


def scan_products(B: int, C: int) -> int:
    """Field products of one (16, B, C) `scan_prod` launch: B - T a column
    in the segments, the rows past the first segment again, and the
    Kogge-Stone steps' T log2 T - T + 1."""
    T, _ = field_cuda.scan_team(B, C)
    if T == 1:
        return C * (B - 1)
    return C * (B - T + B - B // T + T * (T.bit_length() - 1) - T + 1)


def _scan_us(B: int, C: int) -> float:
    """The model's time of one (16, B, C) `scan_prod` launch."""
    T, _ = field_cuda.scan_team(B, C)
    rate = PEAK_PRODUCTS_PER_US * (1 - 0.52 ** (C * T / 32 / PARTITIONS))
    return LAUNCH_US + max(scan_products(B, C) / rate, (scan_chain(B, C) + 1) * STEP_US)


def _level_us(B: int, C: int) -> float:
    """The model's time of one level of `prefix_prod`: its scan and, where
    C > 1, its glue."""
    us = _scan_us(B, C)
    if C > 1:
        us += GLUE_US + B * C * (GLUE_US_PER_ELEM_16 if B == 16 else GLUE_US_PER_ELEM)
    return us


@functools.lru_cache(maxsize=None)
def _plan(n: int) -> tuple[float, tuple[tuple[int, int], ...]]:
    """The cheapest plan of a length-n scan under the model: one level of
    (n, 1), or a first level of n // B chunks of B rows and the plan of the
    chunk totals."""
    best = []
    if n <= SCAN_MAX_ROWS:
        best.append((_level_us(n, 1), ((n, 1),)))
    for B in range(2, min(SCAN_MAX_ROWS, n - 1) + 1):
        if n % B == 0:
            us, rest = _plan(n // B)
            best.append((_level_us(B, n // B) + us, ((B, n // B),) + rest))
    return min(best) if best else (_level_us(n, 1), ((n, 1),))


def scan_levels(n: int) -> list[tuple[int, int]]:
    """The (B, C) shapes of the `scan_prod` launches that `prefix_prod`
    makes for a length-n array, outermost first: a pure function of n >= 1,
    the cheapest under the model above among the plans whose levels of
    more than one column have at most SCAN_MAX_ROWS rows. A length with no
    divisor in [2, SCAN_MAX_ROWS] is scanned as one level of n rows."""
    if n < 1:
        raise ValueError(f"prefix_prod needs a length of at least 1, got {n}")
    return list(_plan(n)[1])


def prefix_prod(spec: FieldSpec, v: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix product along axis 1 of a (L, N) Montgomery array
    (`stark_tpu/ops/modmath.py:351-381`): contiguous chunks of B elements
    ride the rows of one `scan_prod` launch with the chunks side by side on
    the columns, the chunk totals recurse, and one combine multiply stitches
    them (`scan_levels`). Any N >= 1: the JAX package takes N only where its
    block divides it, and asserts on others such as 100 and 1000, where the
    port returns the products. Prefix products are canonical field values,
    so the chunking does not change a bit of the result. Each
    intermediate is dropped after its last read: at a large N the copies
    around the scan, not the scan, set the memory it takes."""
    if reverse:
        return prefix_prod(spec, v.flip(1)).flip(1)
    L, n = v.shape
    device = v.device
    B, C = scan_levels(n)[0]
    vb = v.reshape(L, C, B).transpose(1, 2).contiguous()  # chunks on the columns
    del v
    pref = field_cuda.scan_prod(spec, vb)  # (L, B, C), inclusive per chunk
    del vb
    if C == 1:
        return pref.reshape(L, n)
    ctot_inc = prefix_prod(spec, pref[:, B - 1, :])  # (L, C)
    ctot_exc = torch.cat([mont_one(spec, device), ctot_inc[:, :-1]], dim=1)
    pref_t = pref.transpose(1, 2).contiguous()
    del pref
    return mmul(spec, pref_t, ctot_exc[:, :, None]).reshape(L, n)


def multi_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Batched inversion along axis 1 of (L, N); zeros map to 0. One Fermat
    inversion of the running total, prefix and suffix products for the
    rest. The products are canonical, so their order is free: the prefix
    side is finished and its running products dropped before the suffix
    scan starts, so that fewer (L, N) intermediates are live at once."""
    one = mont_one(spec, a.device)
    z = (a == 0).all(dim=0)[None]
    v = torch.where(z, one, a)
    pre_inc = prefix_prod(spec, v)
    total_inv = minv(spec, pre_inc[:, -1:])
    left = mmul(spec, total_inv, torch.cat([one, pre_inc[:, :-1]], dim=1))
    del pre_inc
    suf_inc = prefix_prod(spec, v, reverse=True)
    del v
    out = mmul(spec, left, torch.cat([suf_inc[:, 1:], one], dim=1))
    return out.masked_fill_(z, 0)


# ---------------------------------------------------------------------------
# power tables
# ---------------------------------------------------------------------------


def power_table(spec: FieldSpec, g: int, n: int, device) -> torch.Tensor:
    """[1, g, ..., g^(n-1)] Montgomery form, (L, n), n a power of two, by
    log-depth doubling."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"power_table needs a power-of-two length, got {n}")
    table = mont_one(spec, device)
    cur = mont_const(spec, g, device)  # g^(table width)
    while table.shape[1] < n:
        table = torch.cat([table, mmul(spec, table, cur)], dim=1)
        cur = mmul(spec, cur, cur)
    return table
