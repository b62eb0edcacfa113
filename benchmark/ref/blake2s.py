"""Blake2s-256 (RFC 7693), unkeyed, over many equal-length messages at once,
in plain PyTorch on int64 tensors holding 32-bit words."""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]
# the four column steps, then the four diagonal steps, as (a, b, c, d) rows
_COLS = ([0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11], [12, 13, 14, 15])
_DIAG = ([0, 1, 2, 3], [5, 6, 7, 4], [10, 11, 8, 9], [15, 12, 13, 14])


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def _g(v, rows, x, y):
    a, b, c, d = (v[r] for r in rows)
    a = (a + b + x) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    for r, val in zip(rows, (a, b, c, d)):
        v[r] = val


def compress(h: torch.Tensor, m: torch.Tensor, t: int, last: bool) -> torch.Tensor:
    """h: (8, n) chaining words, m: (16, n) message words, t the byte count so
    far, `last` the final block's flag."""
    iv = torch.tensor(IV, dtype=torch.int64, device=h.device).view(8, 1).expand_as(h)
    v = torch.cat([h, iv]).clone()
    v[12] ^= t & M32
    v[13] ^= (t >> 32) & M32
    if last:
        v[14] ^= M32
    for rnd in range(10):
        s = SIGMA[rnd]
        _g(v, _COLS, m[s[0:8:2]], m[s[1:8:2]])
        _g(v, _DIAG, m[s[8:16:2]], m[s[9:16:2]])
    return h ^ v[:8] ^ v[8:]


def words_of(msgs: torch.Tensor) -> torch.Tensor:
    """(n, k) uint8 -> (16 blocks, n) int64 LE words, zero-padded to whole
    64-byte blocks."""
    n, k = msgs.shape
    blocks = max(1, -(-k // 64))
    b = torch.zeros(n, 64 * blocks, dtype=torch.int64, device=msgs.device)
    b[:, :k] = msgs.to(torch.int64)
    b = b.view(n, 16 * blocks, 4)
    w = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    return w.T.contiguous()


def hash_words(words: torch.Tensor, length: int) -> torch.Tensor:
    """(16 * blocks, n) message words of `length` bytes each -> (8, n) digest
    words."""
    n = words.shape[1]
    blocks = max(1, -(-length // 64))
    h0 = list(IV)
    h0[0] ^= 0x01010000 ^ 32
    h = torch.tensor(h0, dtype=torch.int64, device=words.device).view(8, 1).expand(8, n)
    for i in range(blocks):
        last = i == blocks - 1
        h = compress(h, words[16 * i : 16 * (i + 1)], length if last else 64 * (i + 1), last)
    return h


def digest_bytes(h: torch.Tensor) -> torch.Tensor:
    """(8, n) digest words -> (n, 32) uint8."""
    parts = [(h >> (8 * k)) & 0xFF for k in range(4)]
    return torch.stack(parts, dim=-1).permute(1, 0, 2).reshape(h.shape[1], 32).to(torch.uint8)
