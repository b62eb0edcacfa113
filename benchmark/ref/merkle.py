"""Merkle trees over equal-length leaves, Blake2s or Poseidon, in plain
PyTorch (`commitment/src/merkle_tree.rs:25-43`): layer 0 hashes each leaf,
layer k+1 each pair of layer k, and a branch is the leaf with its siblings
from the bottom up."""

from __future__ import annotations

import torch

from benchmark.ref import blake2s as b2
from benchmark.ref import poseidon as ps

CHUNK = 1 << 20  # leaves hashed at a time, so that the words fit


class Tree:
    def __init__(self, leaves: torch.Tensor, digest: str = "blake2s"):
        """leaves: (n, k) uint8, n a power of two; Poseidon takes 32-byte
        leaves, each a canonical element of BLS12-381's Fr."""
        n, k = leaves.shape
        assert n & (n - 1) == 0
        self.leaves = leaves
        self.digest = digest
        if digest == "blake2s":
            h = torch.cat([b2.hash_words(b2.words_of(leaves[i : i + CHUNK]), k)
                           for i in range(0, n, CHUNK)], dim=1)
        elif digest == "poseidon":
            assert k == 32
            self.perm = ps.permutation(str(leaves.device))
            self.F = self.perm.F
            h = torch.cat([self.perm.hash(self.F.from_bytes(leaves[i : i + CHUNK]))
                           for i in range(0, n, CHUNK)], dim=-1)
        else:
            raise ValueError(digest)
        self.layers = [h]
        while h.shape[-1] > 1:
            h = self._pairs(h)
            self.layers.append(h)

    def _pairs(self, h):
        if self.digest == "blake2s":
            return b2.hash_words(torch.cat([h[:, 0::2], h[:, 1::2]]), 64)
        return self.perm.hash(h[:, 0::2].contiguous(), h[:, 1::2].contiguous())

    def _bytes(self, nodes) -> torch.Tensor:
        if self.digest == "blake2s":
            return b2.digest_bytes(nodes)
        return self.F.to_bytes(nodes)

    @property
    def root(self) -> bytes:
        return bytes(self._bytes(self.layers[-1]).cpu().numpy()[0].tobytes())

    def branches(self, indices: list[int]) -> list[dict]:
        """{"leaf": [...], "nodes": [[...], ...]} of each index, as the
        proof's JSON holds them."""
        idx = torch.tensor(indices, dtype=torch.int64, device=self.leaves.device)
        leaves = self.leaves[idx].cpu().tolist()
        levels = []
        t = idx
        for layer in self.layers[:-1]:
            levels.append(self._bytes(layer[:, t ^ 1]).cpu().tolist())
            t = t >> 1
        return [{"leaf": leaves[j], "nodes": [lv[j] for lv in levels]}
                for j in range(len(indices))]
