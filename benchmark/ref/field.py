"""Prime-field arithmetic on int64 limb tensors, in plain PyTorch.

An element is 10 limbs of 26 bits along dimension 0 of an int64 tensor,
(10, *shape), in Montgomery form with R = 2^260. The arithmetic is lazy:
a product returns a value below 2p, a sum of two is below 4p + 2^240, a
difference is taken as a + 4p - b, and limbs may carry a few bits past 26
or be negative. `reduce` brings a value below 16p back below 2p + 2^240 by
the top limb alone, and `canonical` gives the exact residue. Bounds, for
p < 2^255 and R = 2^260: a product's output is below A * B / R + p, so
below 2p where A * B < p * R (both factors reduced, or one below 16p on
BN254's p < 2^254); limbs below 2^30 keep the column sums below 2^63.

Shared by nothing of the measured program: a field is built from its prime
alone.
"""

from __future__ import annotations

import torch

L = 10
BITS = 26
MASK = (1 << BITS) - 1
R_BITS = L * BITS

BN254_P = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BLS12_381_P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def int_to_limbs(x: int) -> list[int]:
    return [(x >> (BITS * i)) & MASK for i in range(L)]


class Field:
    """Arithmetic modulo `p` on `device`."""

    def __init__(self, p: int, device="cpu"):
        assert p.bit_length() <= 255
        self.p = p
        self.device = torch.device(device)
        self.R = (1 << R_BITS) % p
        self.R2 = (1 << (2 * R_BITS)) % p
        self.pinv = (-pow(p, -1, 1 << BITS)) % (1 << BITS)
        self._p = self.const_limbs(p)
        self._4p = self.const_limbs(4 * p)
        # (k p, the top limb from which a value surely reaches k p): after
        # two carry passes the limbs below the top one hold less than 2^236
        self._steps = [(self.const_limbs(k * p), ((k * p + (1 << 238)) >> (BITS * (L - 1))) + 1)
                       for k in (8, 4, 2)]

    # --- constants and conversions ---

    def const_limbs(self, x: int) -> torch.Tensor:
        """(10, 1) limbs of the plain integer x (no Montgomery factor)."""
        return torch.tensor(int_to_limbs(x), dtype=torch.int64, device=self.device).view(L, 1)

    def consts(self, values) -> torch.Tensor:
        """(10, k) Montgomery limbs of the integers `values`."""
        vals = [int_to_limbs(v % self.p * self.R % self.p) for v in values]
        return torch.tensor(vals, dtype=torch.int64, device=self.device).T.contiguous()

    def const(self, value: int) -> torch.Tensor:
        return self.consts([value])

    def to_ints(self, x: torch.Tensor) -> list[int]:
        """The residues of a (10, n) Montgomery tensor, on the host."""
        c = self.canonical(self.from_mont(x)).cpu().tolist()
        n = len(c[0])
        return [sum(c[i][j] << (BITS * i) for i in range(L)) for j in range(n)]

    def from_bytes(self, b: torch.Tensor) -> torch.Tensor:
        """(n, 32) uint8 little-endian integers below p -> (10, n) Montgomery."""
        n = b.shape[0]
        w = torch.zeros(n, 37, dtype=torch.int64, device=b.device)
        w[:, :32] = b.to(torch.int64)
        limbs = []
        for i in range(L):
            bit = BITS * i
            j, o = bit // 8, bit % 8
            v = w[:, j] | (w[:, j + 1] << 8) | (w[:, j + 2] << 16) | (w[:, j + 3] << 24) \
                | (w[:, j + 4] << 32)
            limbs.append((v >> o) & MASK)
        plain = torch.stack(limbs).to(self.device)
        return self.to_mont(plain)

    def to_bytes(self, x: torch.Tensor) -> torch.Tensor:
        """(10, n) Montgomery -> (n, 32) uint8 canonical little-endian."""
        c = self.canonical(self.from_mont(x))
        n = c.shape[1]
        out = torch.empty(32, n, dtype=torch.int64, device=c.device)
        for k in range(32):
            i, o = (8 * k) // BITS, (8 * k) % BITS
            v = c[i] >> o
            if o + 8 > BITS and i + 1 < L:
                v = v | (c[i + 1] << (BITS - o))
            out[k] = v & 0xFF
        return out.T.to(torch.uint8).contiguous()

    def to_mont(self, plain: torch.Tensor) -> torch.Tensor:
        return self.mul(plain, self.const_limbs(self.R2).view((L,) + (1,) * (plain.dim() - 1)))

    def from_mont(self, x: torch.Tensor) -> torch.Tensor:
        one = torch.zeros((L,) + (1,) * (x.dim() - 1), dtype=torch.int64, device=x.device)
        one[0] = 1
        return self.mul(x, one)

    # --- normal forms ---

    @staticmethod
    def carry(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
        """One parallel carry pass: limbs 0-8 into [0, 2^26) plus the carry
        of the limb below; the top limb keeps what it holds."""
        c = x[: L - 1] >> BITS
        y = x if inplace else x.clone()
        y[: L - 1] &= MASK
        y[1:] += c
        return y

    def reduce(self, x: torch.Tensor, below: int = 16) -> torch.Tensor:
        """A value in [0, below p), below at most 16 -> the same residue
        below 2p + 2^240, limbs normal up to a few units."""
        x = self.carry(self.carry(x), inplace=True)
        view = (L,) + (1,) * (x.dim() - 1)
        for (kp, top), k in zip(self._steps, (8, 4, 2)):
            if k < below:
                big = (x[L - 1] >= top).to(torch.int64)
                x = self.carry(x - big * kp.view(view), inplace=True)
        return x

    def canonical(self, x: torch.Tensor) -> torch.Tensor:
        """The exact residue in [0, p) with limbs in [0, 2^26), from a value
        in [0, 4p)."""
        x = x.clone()
        for i in range(L - 1):  # exact sequential carry
            x[i + 1] += x[i] >> BITS
            x[i] &= MASK
        pv = self._p.view((L,) + (1,) * (x.dim() - 1))
        for _ in range(4):
            y = x - pv
            for i in range(L - 1):
                y[i + 1] += y[i] >> BITS
                y[i] &= MASK
            keep = (y[L - 1] < 0).unsqueeze(0)
            x = torch.where(keep, x, y)
        return x

    # --- arithmetic ---

    def add(self, a, b):
        return a + b

    def sub(self, a, b):
        """a - b + 4p: b must be below 4p."""
        return a + self._4p.view((L,) + (1,) * (a.dim() - 1)) - b

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a * b / R mod p, below 2p, limbs normal."""
        shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        a = a.expand((L,) + shape)
        b = b.expand((L,) + shape)
        t = torch.zeros((2 * L,) + shape, dtype=torch.int64, device=a.device)
        for i in range(L):
            t[i : i + L].addcmul_(b, a[i : i + 1])
        pv = self._p.view((L,) + (1,) * len(shape))
        for i in range(L):
            # the product wraps past 2^63; its low 26 bits are exact
            m = (t[i] * self.pinv) & MASK
            t[i : i + L].addcmul_(pv.expand((L,) + shape), m.unsqueeze(0))
            t[i + 1] += t[i] >> BITS
        return self.carry(self.carry(t[L:], inplace=True), inplace=True)

    # --- vector helpers ---

    def powers(self, g: int, n: int) -> torch.Tensor:
        """(10, n) Montgomery g^0 .. g^(n-1), by doubling."""
        out = self.const(1)
        k = 1
        while k < n:
            step = self.const(pow(g, k, self.p))
            out = torch.cat([out, self.mul(out, step)], dim=1)
            k *= 2
        return out[:, :n].contiguous()

    def prefix_prod(self, x: torch.Tensor) -> torch.Tensor:
        """Inclusive prefix products along the last dimension (Hillis-Steele)."""
        y = x
        n = x.shape[-1]
        d = 1
        while d < n:
            z = y.clone()
            z[..., d:] = self.mul(y[..., d:], y[..., :-d])
            y = z
            d *= 2
        return y

    def batch_inv(self, x: torch.Tensor) -> torch.Tensor:
        """Inverses along the last dimension of a (10, n) tensor; a zero maps
        to zero (the reference's `multi_inv`)."""
        c = self.canonical(x)
        zero = (c == 0).all(dim=0)
        one = self.const(1).expand_as(x)
        x = torch.where(zero.unsqueeze(0), one, x)
        pre = self.prefix_prod(x)
        total = self.to_ints(pre[:, -1:])[0]
        inv_total = self.const(pow(total, self.p - 2, self.p))
        # suffix products: prefix products of the reversed vector
        suf = self.prefix_prod(x.flip(-1)).flip(-1)
        ones = self.const(1)
        left = torch.cat([ones, pre[:, :-1]], dim=1)  # prod of x[:j]
        right = torch.cat([suf[:, 1:], ones], dim=1)  # prod of x[j+1:]
        inv = self.mul(self.mul(left, right), inv_total)
        return torch.where(zero.unsqueeze(0), torch.zeros_like(inv), inv)
