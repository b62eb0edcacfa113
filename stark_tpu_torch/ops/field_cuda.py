"""Elementwise Montgomery multiply: the CUDA kernel and its plain version.

`mmul` takes (16, n) int32 limb planes (16-bit limbs, Montgomery form,
R = 2^256, the JAX package's layout and bit patterns). On a CUDA tensor it
launches `csrc/mmul.cu` (which replaces `stark_tpu/ops/pallas_field.py:174`)
or raises; on a CPU tensor it runs `mmul_plain`. Nothing else chooses the
route: no environment variable, no fallback on error.

`mmul_plain` is the same function in plain PyTorch (16x16-bit schoolbook
columns and REDC in int64), also used to hold the kernel to account on the
card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from stark_tpu.fields.field import LIMB_BITS, FieldSpec, int_to_limbs
from stark_tpu_torch.ops import build

_MASK = (1 << LIMB_BITS) - 1


@functools.lru_cache(maxsize=None)
def _consts(spec: FieldSpec):
    """Host constants: p as 16-bit limbs, n' = -p^-1 mod R as limbs, and the
    kernels' (8 x uint32 words of p, -p^-1 mod 2^32)."""
    L = spec.num_limbs
    R = 1 << spec.r_bits
    n_prime = (-pow(spec.p, -1, R)) % R
    words = (ctypes.c_uint32 * 8)(*[(spec.p >> (32 * i)) & 0xFFFFFFFF for i in range(8)])
    np32 = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    return int_to_limbs(spec.p, L), int_to_limbs(n_prime, L), words, np32


def _col(limbs, like: torch.Tensor) -> torch.Tensor:
    """Limb tuple -> (L, 1) int64 column on `like`'s device."""
    return torch.tensor(limbs, dtype=torch.int64, device=like.device).reshape(-1, 1)


def normalize(cols: torch.Tensor):
    """(K, N) int64 deferred-carry columns (any sign) -> exact 16-bit limbs
    and the carry out of the top column (negative on a borrow)."""
    out = torch.empty_like(cols)
    c = torch.zeros_like(cols[0])
    for k in range(cols.shape[0]):
        v = cols[k] + c
        out[k] = v & _MASK
        c = v >> LIMB_BITS
    return out, c


def mul_cols(a: torch.Tensor, b: torch.Tensor, ncols: int) -> torch.Tensor:
    """Columns 0..ncols-1 of the limb product a*b (no carries): out[k] =
    sum_{i+j=k} a_i*b_j. a: (La, N), b: (Lb, N) or (Lb, 1), int64 limbs."""
    out = torch.zeros((ncols, a.shape[1]), dtype=torch.int64, device=a.device)
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
    """(p words, n', stream) for a launch on t's device; raises where the
    kernels cannot run."""
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    if spec.num_limbs != 16:
        raise NotImplementedError(
            f"the CUDA field kernels are built for 16-limb (256-bit R) fields, "
            f"not {spec.name}"
        )
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
