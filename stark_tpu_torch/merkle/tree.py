"""Merkle trees with every layer on the device, blake2s or Poseidon.

Counterpart of `stark_tpu/merkle/tree.py`: leaves are (W, N) int32 word
rows, layer k+1 hashes the digest pairs of layer k, and the host sees only
roots and the gathered branch columns. Tree shape: power-of-two leaf count;
layer0[i] = H(leaf_i), layer_{k+1}[i] = H(layer_k[2i] || layer_k[2i+1]).
Blake2s layers come from the `blake2s_words` kernel; Poseidon layers
(`digest="poseidon"`, 32-byte value leaves only) from `poseidon_leaves` and
`poseidon_pairs`, in the same (8, n) word layout, so gathers, branches and
roots do not depend on the digest. Branches are bottom-up sibling lists
checked by the index-parity walk (`validate_proof`) on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stark_tpu_torch.protocol.transcript import blake
from stark_tpu_torch.ops import blake2s as b2
from stark_tpu_torch.ops import poseidon as pos

DIGESTS = ("blake2s", "poseidon")


def check_digest(digest: str) -> str:
    if digest not in DIGESTS:
        raise ValueError(f"unknown digest {digest!r}: one of {DIGESTS}")
    return digest


@dataclass
class MerkleProof:
    """= reference `Proof { leaf, nodes }`."""

    leaf: bytes
    nodes: list[bytes]


def node_layers(h: torch.Tensor, digest: str = "blake2s") -> list[torch.Tensor]:
    """The layers above the (8, n) node layer h, up to the (8, 1) root: a
    `blake2s_words` launch a level over the pairs' 64 bytes, or under
    Poseidon a `poseidon_pairs` launch."""
    check_digest(digest)
    layers = []
    while h.shape[1] > 1:
        if digest == "poseidon":
            h = pos.poseidon_pairs(h)
        else:
            pair = h.reshape(8, h.shape[1] // 2, 2)
            msg = torch.cat([pair[:, :, 0], pair[:, :, 1]], dim=0).contiguous()
            h = b2.blake2s_words(msg, 64)
        layers.append(h)
    return layers


def build_layers(leaf_words: torch.Tensor, leaf_bytes: int) -> list[torch.Tensor]:
    """(W, N) leaf words -> [(8, N), (8, N/2), ..., (8, 1)] digest layers."""
    h = b2.blake2s_words(leaf_words, leaf_bytes)
    return [h] + node_layers(h)


def build_layers_digest(leaf_words: torch.Tensor, leaf_bytes: int,
                        digest: str = "blake2s") -> list[torch.Tensor]:
    """`build_layers` under either digest. Poseidon takes 32-byte value
    leaves only (rows 0-7 of the leaf words): its input is capped at 64
    bytes and must be canonical in BLS12-381's Fr, which holds for the
    canonical BN254 values of the l-tree and the FRI trees. One
    `poseidon_leaves` launch, then one `poseidon_pairs` launch a level."""
    if check_digest(digest) == "blake2s":
        return build_layers(leaf_words, leaf_bytes)
    if leaf_bytes != 32:
        raise ValueError(f"poseidon trees take 32-byte value leaves, got {leaf_bytes}")
    h = pos.poseidon_leaves(leaf_words)
    return [h] + node_layers(h, "poseidon")


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

    def release_device(self) -> None:
        """Drop the device tensors once every gather against the tree is
        enqueued (`stark_tpu/merkle/tree.py:160-183`): the gathers' outputs
        hold what they read, and the allocator frees the rest in the
        stream's order (at precision 2^23 the m-tree's leaf words alone are
        2 GiB). `proofs_from_flat` needs only `leaf_bytes` and W, so it
        keeps working."""
        self.leaf_words = None
        self.layers = None

    @property
    def root_words(self) -> torch.Tensor:
        """The root as (8,) int32 words on the device."""
        return self.layers[-1][:, 0]

    @property
    def root(self) -> bytes:
        return self.root_words.cpu().numpy().astype("<i4").tobytes()

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


def commit_root(leaves: list[bytes], device, digest: str = "blake2s") -> bytes:
    """Root of a tree over equal-length byte leaves (power-of-two count),
    hashed on `device` with `digest`."""
    arr = np.frombuffer(b"".join(leaves), dtype=np.uint8).reshape(len(leaves), -1)
    n, leaf_bytes = arr.shape
    if n & (n - 1):
        raise ValueError("power-of-two leaf count required")
    words = torch.from_numpy(b2.bytes_to_words_np(arr, leaf_bytes).view(np.int32))
    words = words.to(device)
    return DeviceMerkleTree(words, leaf_bytes,
                            build_layers_digest(words, leaf_bytes, digest)).root


def _host_digest(digest: str):
    return blake if check_digest(digest) == "blake2s" else pos.poseidon_digest


def validate_proof(proof: MerkleProof, root: bytes, index: int,
                   digest: str = "blake2s") -> bytes:
    """Index-parity sibling walk on the host; raises on failure."""
    h = _host_digest(digest)
    current = h(proof.leaf)
    t = index
    for node in proof.nodes:
        current = h(current + node) if t % 2 == 0 else h(node + current)
        t //= 2
    if current != root:
        raise ValueError("merkle proof validation failed")
    return proof.leaf


def verify_multi_branch(root: bytes, indices, proofs: list[MerkleProof],
                        digest: str = "blake2s") -> list[bytes]:
    return [validate_proof(p, root, int(i), digest) for i, p in zip(indices, proofs)]
