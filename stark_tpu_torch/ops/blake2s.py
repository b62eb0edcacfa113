"""Batched Blake2s-256: the CUDA kernel and its plain version.

`blake2s_words(msgs, msg_len)` hashes N equal-length messages given as a
(W, N) int32 tensor of little-endian message words (W = 16 * nblocks,
zero-padded blocks) and returns (8, N) int32 digest words. Words use all 32
bits, so compare them as bit patterns. On a CUDA tensor it launches
`csrc/blake2s.cu` (replacing `stark_tpu/ops/pallas_blake2s.py:84`); on a CPU
tensor it runs `blake2s_words_plain`. Standard unkeyed Blake2s-256, identical
to `hashlib.blake2s`.
"""

from __future__ import annotations

import numpy as np
import torch

from stark_tpu_torch.ops import build

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
_GI = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)
_M32 = 0xFFFFFFFF


def nblocks_for(msg_len: int) -> int:
    return max(1, (msg_len + 63) // 64)


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress(h, m, t: int, last: bool):
    """h: 8 (N,) int64 words < 2^32; m: 16 (N,) int64 words."""
    v = list(h) + [torch.full_like(h[0], iv) for iv in IV]
    v[12] = v[12] ^ (t & _M32)
    v[13] = v[13] ^ ((t >> 32) & _M32)
    if last:
        v[14] = v[14] ^ _M32
    for r in range(10):
        s = SIGMA[r]
        for i, (a, b, c, d) in enumerate(_GI):
            x, y = m[s[2 * i]], m[s[2 * i + 1]]
            v[a] = (v[a] + v[b] + x) & _M32
            v[d] = _rotr(v[d] ^ v[a], 16)
            v[c] = (v[c] + v[d]) & _M32
            v[b] = _rotr(v[b] ^ v[c], 12)
            v[a] = (v[a] + v[b] + y) & _M32
            v[d] = _rotr(v[d] ^ v[a], 8)
            v[c] = (v[c] + v[d]) & _M32
            v[b] = _rotr(v[b] ^ v[c], 7)
    return [h[i] ^ v[i] ^ v[8 + i] for i in range(8)]


def blake2s_words_plain(msgs: torch.Tensor, msg_len: int) -> torch.Tensor:
    """Plain PyTorch Blake2s over (W, N) int32 words (int64 arithmetic)."""
    nblocks = nblocks_for(msg_len)
    w = msgs.to(torch.int64) & _M32
    n = msgs.shape[1]
    h = [torch.full((n,), iv, dtype=torch.int64, device=msgs.device) for iv in IV]
    h[0] = h[0] ^ 0x01010020  # depth=1, fanout=1, digest length 32
    for blk in range(nblocks):
        last = blk == nblocks - 1
        t = msg_len if last else (blk + 1) * 64
        h = _compress(h, [w[blk * 16 + i] for i in range(16)], t, last)
    out = torch.stack(h)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def blake2s_words(msgs: torch.Tensor, msg_len: int) -> torch.Tensor:
    """(W, N) int32 message words -> (8, N) int32 digest words."""
    if msgs.dtype != torch.int32 or msgs.dim() != 2 or not msgs.is_contiguous():
        raise ValueError("blake2s_words takes a contiguous (W, N) int32 tensor")
    nblocks = nblocks_for(msg_len)
    if msgs.shape[0] != 16 * nblocks:
        raise ValueError(
            f"{msg_len}-byte messages need {16 * nblocks} word rows, got "
            f"{msgs.shape[0]}"
        )
    if msgs.device.type == "cpu":
        return blake2s_words_plain(msgs, msg_len)
    if msgs.device.type != "cuda":
        raise ValueError(f"no kernel for device {msgs.device}")
    n = msgs.shape[1]
    out = torch.empty((8, n), dtype=torch.int32, device=msgs.device)
    rc = build.load().stark_blake2s_words(
        msgs.data_ptr(), out.data_ptr(), n, nblocks, msg_len,
        torch.cuda.current_stream(msgs.device).cuda_stream,
    )
    build.check(rc, "blake2s_words")
    blake2s_words.launches += 1
    return out


blake2s_words.launches = 0


def digest_words_to_bytes_np(words) -> np.ndarray:
    """(8, N) uint32/int32 digest words -> (N, 32) uint8."""
    w = np.ascontiguousarray(np.asarray(words).astype("<u4").T)
    return w.view(np.uint8).reshape(w.shape[0], 32)


def bytes_to_words_np(data: np.ndarray, msg_len: int) -> np.ndarray:
    """(N, msg_len) uint8 -> (W, N) uint32 words, zero-padded to blocks."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    buf = np.zeros((data.shape[0], nblocks_for(msg_len) * 64), dtype=np.uint8)
    buf[:, :msg_len] = data
    return np.ascontiguousarray(buf.view("<u4").T)
