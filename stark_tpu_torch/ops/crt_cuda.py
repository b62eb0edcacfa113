"""The three fused passes of the CRT product and their plain versions.

    residues_in   limb planes -> the two 7-bit digit planes of their residues
                  mod every prime of a basis, optionally after a pointwise
                  product with a residue pre-table
                  (`stark_tpu/ops/pallas_crt.py:106`)
    matmul_fold   per prime, the four digit products W{0,1} @ x{0,1},
                  recombined and folded to (W @ x) mod q (`:176`)
    reconstruct   residues -> X * R^-1 mod p as canonical limbs (`:254`)

On a CUDA tensor each launches its kernel of `csrc/crt.cu` or raises; on a
CPU tensor it runs its `*_plain` version, composed of `ops/crt.py`. Nothing
else chooses the route: no size gate, no environment variable, no fallback
on error. The kernels take every shape the engine produces, (K, B) = (8, 8)
as well as (1024, 1024).

The digit planes are an interface inside the port: (P+1, ceil(K/4), B) int32
words, the digits of contraction rows 4w .. 4w+3 in the bytes of word w
(`crt.pack_k4`), so that `residues_in` writes whole words and
`matmul_fold`'s kernel moves four contraction steps with each 4-byte copy
into its K-major tensor-core tiles. The plan's W planes are one (2, P+1,
kout, kp) tensor, rows padded with zeros to 16 bytes for the kernel's TMA
loads (`crt.K_ALIGN`). `crt.unpack_k4` gives
the JAX package's (P+1, K, B) planes back as integers.
"""

from __future__ import annotations

import ctypes

import torch

from stark_tpu_torch.ops import build, crt
from stark_tpu_torch.ops import field_cuda as fc

# matmul_fold's recombination stays inside 32 bits up to this contraction
MAX_K = 1024


def _p1(basis: crt.CrtBasis) -> int:
    return len(basis.qs_host)


def _check(t: torch.Tensor, dtype, shape, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _stream(basis: crt.CrtBasis, *ts: torch.Tensor):
    """The launch stream after the checks a launch needs: one CUDA device,
    16-byte aligned storage, a 16-limb field."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("the operands must share one device")
        if t.data_ptr() % 16:
            raise ValueError("the kernels need 16-byte aligned tensors")
    return fc.cuda_args(basis.spec, ts[0])


# ---------------------------------------------------------------------------
# residues_in
# ---------------------------------------------------------------------------


def residues_in_plain(basis: crt.CrtBasis, x_limbs: torch.Tensor, pre=None):
    L, K, B = x_limbs.shape
    p1 = _p1(basis)
    r = basis.reduce_in(x_limbs.reshape(L, K * B))
    if pre is not None:
        prod = r.to(torch.int64) * pre.reshape(p1, K * B).to(torch.int64)  # < 2^28
        r = basis.fold(prod, 28)
    x0, x1 = basis.chunk(r)
    return crt.pack_k4(x0.reshape(p1, K, B)), crt.pack_k4(x1.reshape(p1, K, B))


def residues_in(basis: crt.CrtBasis, x_limbs: torch.Tensor, pre=None):
    """(16, K, B) int32 limb planes (values < 2^256, canonical 16-bit limbs)
    -> two (P+1, ceil(K/4), B) int32 packed digit planes of the residues,
    times `pre` ((P+1, K, B) int16 residues) where given."""
    if x_limbs.dim() != 3:
        raise ValueError(f"limb planes must be (16, K, B), got {tuple(x_limbs.shape)}")
    L, K, B = x_limbs.shape
    _check(x_limbs, torch.int32, (16, K, B), "limb planes")
    p1 = _p1(basis)
    if pre is not None:
        _check(pre, torch.int16, (p1, K, B), "the pre-table")
        if pre.device != x_limbs.device:
            raise ValueError("the operands must share one device")
    if x_limbs.device.type == "cpu":
        return residues_in_plain(basis, x_limbs, pre)
    _, _, stream = _stream(basis, x_limbs, *([] if pre is None else [pre]))
    k4 = -(-K // 4)
    x0 = torch.empty((p1, k4, B), dtype=torch.int32, device=x_limbs.device)
    x1 = torch.empty_like(x0)
    rc = build.load().stark_crt_residues_in(
        x_limbs.data_ptr(), basis.on(x_limbs.device)["kernel_table"].data_ptr(),
        None if pre is None else pre.data_ptr(), x0.data_ptr(), x1.data_ptr(),
        p1, K, B, stream,
    )
    build.check(rc, "residues_in")
    residues_in.launches += 1
    return x0, x1


residues_in.launches = 0


# ---------------------------------------------------------------------------
# matmul_fold
# ---------------------------------------------------------------------------


def matmul_fold_plain(basis: crt.CrtBasis, plan: crt.CrtMatmulPlan, x0, x1,
                      temp_bytes: int = crt.TEMP_BYTES):
    """The batch axis is independent per lane (only K is contracted), so when
    the four float32 product buffers would exceed `temp_bytes` the products
    run over contiguous B-chunks."""
    B = x0.shape[2]
    est = 4 * _p1(basis) * plan.kout * B * 4
    nc = 1
    while est // nc > temp_bytes and nc * 2 <= B and B % (nc * 2) == 0:
        nc *= 2
    if nc > 1:
        return torch.cat([
            _matmul_fold_plain(basis, plan, a.contiguous(), b.contiguous())
            for a, b in zip(x0.chunk(nc, dim=2), x1.chunk(nc, dim=2))
        ], dim=2)
    return _matmul_fold_plain(basis, plan, x0, x1)


def _matmul_fold_plain(basis: crt.CrtBasis, plan: crt.CrtMatmulPlan, x0, x1):
    d = basis.on(x0.device)["deltas"].to(torch.int64)[:, :, None]
    x0, x1 = (crt.unpack_k4(x, plan.k) for x in (x0, x1))
    S00 = crt._bdot(plan.W0, x0).to(torch.int64)
    S01 = crt._bdot(plan.W0, x1)
    S10 = crt._bdot(plan.W1, x0)
    s11 = crt._bdot(plan.W1, x1).to(torch.int64)  # |.| <= K*64*127 < 2^23
    s11 = (s11 >> crt.QBITS) * d + (s11 & (crt.QBASE - 1))  # ~2^20, = S11 mod q
    sm = (S01 + S10).to(torch.int64)  # |.| <= 2^24
    sm = (sm >> crt.QBITS) * d + (sm & (crt.QBASE - 1))  # ~2^20
    raw = S00 + (sm << 7) + d * s11  # |.| < 2^30
    s = basis.fold_signed(raw.reshape(raw.shape[0], -1), 30)
    return s.to(torch.int32).reshape(raw.shape)


def matmul_fold(basis: crt.CrtBasis, plan: crt.CrtMatmulPlan, x0: torch.Tensor,
                x1: torch.Tensor) -> torch.Tensor:
    """Packed digit planes (P+1, ceil(K/4), B) of x -> (P+1, kout, B) int32
    canonical residues of (W @ x) mod q per prime, W the plan's matrix."""
    p1 = _p1(basis)
    K, kout = plan.k, plan.kout
    if K > MAX_K:
        raise ValueError(f"contraction {K} > {MAX_K}: the digit sums would pass 2^24")
    if x0.dim() != 3:
        raise ValueError(f"digit planes must be (P+1, K/4, B), got {tuple(x0.shape)}")
    B = x0.shape[2]
    k4 = -(-K // 4)
    for x in (x0, x1):
        _check(x, torch.int32, (p1, k4, B), "digit planes")
    _check(plan.W, torch.int8, (2, p1, kout, plan.kp), "the plan's digit planes")
    if x0.device.type == "cpu":
        return matmul_fold_plain(basis, plan, x0, x1)
    _, _, stream = _stream(basis, x0, x1, plan.W)
    out = torch.empty((p1, kout, B), dtype=torch.int32, device=x0.device)
    rc = build.load().stark_crt_matmul_fold(
        plan.W.data_ptr(), x0.data_ptr(), x1.data_ptr(),
        basis.on(x0.device)["kernel_table"].data_ptr(), out.data_ptr(),
        p1, kout, K, plan.kp, B, stream,
    )
    build.check(rc, "matmul_fold")
    matmul_fold.launches += 1
    return out


matmul_fold.launches = 0


# ---------------------------------------------------------------------------
# reconstruct
# ---------------------------------------------------------------------------


def reconstruct_plain(basis: crt.CrtBasis, s: torch.Tensor) -> torch.Tensor:
    return crt._reconstruct_math(basis, s)


def reconstruct(basis: crt.CrtBasis, s: torch.Tensor) -> torch.Tensor:
    """(P+1, N) int32 residues of X (< M; last row plain mod q_r) ->
    (16, N) int32 canonical limbs of X * R^-1 mod p."""
    if s.dim() != 2:
        raise ValueError(f"residues must be (P+1, N), got {tuple(s.shape)}")
    _check(s, torch.int32, (_p1(basis), s.shape[1]), "residues")
    if s.device.type == "cpu":
        return reconstruct_plain(basis, s)
    if basis.P > crt.REC_PRIMES:
        raise ValueError(
            f"the reconstruct kernel takes at most {crt.REC_PRIMES} primes, not {basis.P}")
    words, np32, stream = _stream(basis, s)
    out = torch.empty((16, s.shape[1]), dtype=torch.int32, device=s.device)
    rc = build.load().stark_crt_reconstruct(
        s.data_ptr(), basis.on(s.device)["rec_frags"].data_ptr(), out.data_ptr(),
        basis.P, s.shape[1], basis.qr, basis.minv_qr,
        basis.negm_digits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), words, np32,
        stream,
    )
    build.check(rc, "reconstruct")
    reconstruct.launches += 1
    return out


reconstruct.launches = 0
