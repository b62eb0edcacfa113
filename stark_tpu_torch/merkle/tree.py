"""Blake2s Merkle trees with every layer on the device.

Counterpart of `stark_tpu/merkle/tree.py` (blake2s only): leaves are (W, N)
int32 word rows, layer k+1 hashes the concatenated digest pairs of layer k
with the `blake2s_words` kernel, and the host sees only roots and the
gathered branch columns. Tree shape: power-of-two leaf count;
layer0[i] = blake2s(leaf_i), layer_{k+1}[i] = blake2s(layer_k[2i] ||
layer_k[2i+1]). Branches are bottom-up sibling lists checked by the
index-parity walk (`validate_proof`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stark_tpu_torch.protocol.transcript import blake
from stark_tpu_torch.ops import blake2s as b2


@dataclass
class MerkleProof:
    """= reference `Proof { leaf, nodes }`."""

    leaf: bytes
    nodes: list[bytes]


def build_layers(leaf_words: torch.Tensor, leaf_bytes: int) -> list[torch.Tensor]:
    """(W, N) leaf words -> [(8, N), (8, N/2), ..., (8, 1)] digest layers."""
    h = b2.blake2s_words(leaf_words, leaf_bytes)
    layers = [h]
    while h.shape[1] > 1:
        m = h.shape[1] // 2
        pair = h.reshape(8, m, 2)
        msg = torch.cat([pair[:, :, 0], pair[:, :, 1]], dim=0).contiguous()
        h = b2.blake2s_words(msg, 64)
        layers.append(h)
    return layers


def gather_flat(leaf_words, layers, idx: torch.Tensor) -> torch.Tensor:
    """Leaves and sibling paths of `idx`, stacked row-wise:
    (W + 8 * depth, k), leaf words first, then one 8-row node per level."""
    idx = idx.to(torch.int64)
    gathered = [leaf_words[:, idx]]
    t = idx
    for layer in layers:
        gathered.append(layer[:, t ^ 1])
        t = t // 2
    return torch.cat(gathered, dim=0)


class DeviceMerkleTree:
    """Tree whose leaf words and digest layers stay on the device."""

    def __init__(self, leaf_words: torch.Tensor, leaf_bytes: int, layers):
        self.leaf_words = leaf_words  # (W, N) int32 LE words of the leaves
        self.leaf_bytes = leaf_bytes
        self.layers = list(layers)  # (8, n_i) int32 digest words
        self._W = int(leaf_words.shape[0])

    @property
    def root(self) -> bytes:
        return self.layers[-1][:, 0].cpu().numpy().astype("<i4").tobytes()

    def gather(self, indices: torch.Tensor) -> torch.Tensor:
        return gather_flat(self.leaf_words, self.layers[:-1], indices)

    def proofs_from_flat(self, flat: np.ndarray, k: int) -> list[MerkleProof]:
        """flat: (W + 8 * depth, k) uint32 as returned by `gather`."""
        W = self._W
        flat = flat.astype("<u4")
        depth = (flat.shape[0] - W) // 8
        return [
            MerkleProof(
                flat[:W, j].tobytes()[: self.leaf_bytes],
                [flat[W + 8 * d : W + 8 * (d + 1), j].tobytes() for d in range(depth)],
            )
            for j in range(k)
        ]


def commit_words(leaf_words: torch.Tensor, leaf_bytes: int) -> DeviceMerkleTree:
    n = leaf_words.shape[1]
    if n & (n - 1):
        raise ValueError("power-of-two leaf count required")
    return DeviceMerkleTree(leaf_words, leaf_bytes, build_layers(leaf_words, leaf_bytes))


def commit_root(leaves: list[bytes], device) -> bytes:
    """Root of a tree over equal-length byte leaves (power-of-two count),
    hashed on `device`."""
    arr = np.frombuffer(b"".join(leaves), dtype=np.uint8).reshape(len(leaves), -1)
    n, leaf_bytes = arr.shape
    if n & (n - 1):
        raise ValueError("power-of-two leaf count required")
    words = torch.from_numpy(b2.bytes_to_words_np(arr, leaf_bytes).view(np.int32))
    return commit_words(words.to(device), leaf_bytes).root


def validate_proof(proof: MerkleProof, root: bytes, index: int) -> bytes:
    """Index-parity sibling walk on the host; raises on failure."""
    current = blake(proof.leaf)
    t = index
    for node in proof.nodes:
        current = blake(current + node) if t % 2 == 0 else blake(node + current)
        t //= 2
    if current != root:
        raise ValueError("merkle proof validation failed")
    return proof.leaf


def verify_multi_branch(root: bytes, indices, proofs: list[MerkleProof]) -> list[bytes]:
    return [validate_proof(p, root, int(i)) for i, p in zip(indices, proofs)]
