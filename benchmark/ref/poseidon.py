"""Poseidon over BLS12-381's Fr as a Merkle digest, in plain PyTorch.

The reference's `H: Digest` alternative (`commitment/src/poseidon.rs`),
which follows neptune: width 3 (arity 2), x^5, 8 full and 55 partial
rounds, the Merkle-tree domain tag 3 in the first state word, round
constants from the Poseidon paper's Grain LFSR, and the Cauchy MDS matrix
M[i][j] = 1 / (i + j + 3). A leaf of 32 bytes hashes the state (3, v, 0), a
pair of digests (3, left, right); the digest is state word 1, 32 bytes
little-endian. Each round adds its constants, applies x^5 to all three
words (full rounds) or to word 0 (the 55 middle rounds), then the MDS.
"""

from __future__ import annotations

import functools

import torch

from benchmark.ref.field import BLS12_381_P, L, Field

T = 3
FULL = 8
PARTIAL = 55
TAG = 3


def _grain_constants(p: int, count: int) -> list[int]:
    """The Poseidon paper's round-constant generator: an 80-bit LFSR seeded
    with (field 1, s-box 1, 255 bits, t, R_F, R_P) and thirty ones, 160
    clocks discarded, bits taken through the self-shrinking filter, and
    255-bit candidates kept when below p."""
    state = []
    for val, width in ((1, 2), (1, 4), (255, 12), (T, 12), (FULL, 10), (PARTIAL, 10)):
        state += [(val >> (width - 1 - i)) & 1 for i in range(width)]
    state += [1] * 30

    def clock():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        del state[0]
        state.append(new)
        return new

    for _ in range(160):
        clock()

    def bit():
        while True:
            x, y = clock(), clock()
            if x:
                return y

    out = []
    while len(out) < count:
        v = 0
        for _ in range(255):
            v = (v << 1) | bit()
        if v < p:
            out.append(v)
    return out


@functools.lru_cache(maxsize=None)
def constants(p: int = BLS12_381_P):
    rc = _grain_constants(p, T * (FULL + PARTIAL))
    mds = [[pow(i + j + T, p - 2, p) for j in range(T)] for i in range(T)]
    return rc, mds


def _partial(rnd: int) -> bool:
    return FULL // 2 <= rnd < FULL // 2 + PARTIAL


def permute_host(state: list[int], p: int = BLS12_381_P) -> list[int]:
    rc, mds = constants(p)
    for rnd in range(FULL + PARTIAL):
        state = [(s + rc[T * rnd + i]) % p for i, s in enumerate(state)]
        if _partial(rnd):
            state[0] = pow(state[0], 5, p)
        else:
            state = [pow(s, 5, p) for s in state]
        state = [sum(mds[i][j] * state[i] for i in range(T)) % p for j in range(T)]
    return state


def digest_host(message: bytes, p: int = BLS12_381_P) -> bytes:
    """A message of 32 or 64 bytes -> its 32-byte digest."""
    words = [int.from_bytes(message[i : i + 32], "little") for i in range(0, len(message), 32)]
    assert len(words) in (1, 2) and all(w < p for w in words)
    state = [TAG] + words + [0] * (2 - len(words))
    return permute_host(state, p)[1].to_bytes(32, "little")


class Permutation:
    """The permutation over (10, 3, n) Montgomery state tensors of `F`."""

    def __init__(self, F: Field):
        rc, mds = constants(F.p)
        self.F = F
        self.rc = F.consts(rc).view(L, FULL + PARTIAL, T, 1)
        # mds_t[j, i] = M[i][j]: word j of the output sums M[i][j] * word i
        self.mds = F.consts([mds[i][j] for j in range(T) for i in range(T)]).view(L, T, T, 1)
        self.tag = F.const(TAG)
        self._graphs: dict = {}

    def _sbox(self, x):
        F = self.F
        x2 = F.mul(x, x)
        return F.mul(F.mul(x2, x2), x)

    def __call__(self, st: torch.Tensor) -> torch.Tensor:
        F = self.F
        for rnd in range(FULL + PARTIAL):
            # below 3p: x^5's first square takes it (9p < 2^260)
            st = F.add(st, self.rc[:, rnd])
            if _partial(rnd):
                st = torch.cat([self._sbox(st[:, :1]), st[:, 1:]], dim=1)
            else:
                st = self._sbox(st)
            terms = F.mul(self.mds, st.unsqueeze(1))  # (10, 3 out, 3 in, n)
            st = F.reduce(terms[:, :, 0] + terms[:, :, 1] + terms[:, :, 2], below=6)
        return st

    def hash(self, left: torch.Tensor, right: torch.Tensor | None = None) -> torch.Tensor:
        """(10, n) Montgomery words -> (10, n) digests, state (3, left,
        right or 0). On a card a narrow level replays a CUDA graph of the
        permutation at its width: its thousands of small launches cost the
        host more than the card."""
        n = left.shape[-1]
        right = torch.zeros_like(left) if right is None else right
        if left.is_cuda and n <= GRAPH_BELOW:
            return self._replay(left, right)
        return self._hash(left, right)

    def _hash(self, left, right):
        tag = self.tag.expand(L, left.shape[-1])
        return self(torch.stack([tag, left, right], dim=1))[:, 1]

    def _replay(self, left, right):
        n = left.shape[-1]
        entry = self._graphs.get(n)
        if entry is None:
            sl, sr = torch.zeros_like(left), torch.zeros_like(right)
            side = torch.cuda.Stream(left.device)
            side.wait_stream(torch.cuda.current_stream(left.device))
            with torch.cuda.stream(side):
                self._hash(sl, sr)  # the warm-up the capture asks for
            torch.cuda.current_stream(left.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self._hash(sl, sr)
            entry = self._graphs[n] = (graph, sl, sr, out)
        graph, sl, sr, out = entry
        sl.copy_(left)
        sr.copy_(right)
        graph.replay()
        return out.clone()


GRAPH_BELOW = 1 << 14


@functools.lru_cache(maxsize=None)
def permutation(device: str) -> Permutation:
    """One permutation a device, so that its graphs serve every tree."""
    return Permutation(Field(BLS12_381_P, device))
