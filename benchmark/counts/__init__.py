"""The work a phase of a proof needs at a cell's sizes, one module a phase:
`work(sizes) -> (operations, bytes)`, counted from the algorithm and not
from the launches that happen to run, so that fusing, splitting or
re-routing kernels leaves the count as it is. `sizes` holds `steps` (the
trace's power-of-two length), `precision` (the evaluation domain, 8
steps), `public_points` and `digest`.

The unit prices are the kernel table's (PERF.md): 136 32-bit integer
operations a Montgomery product of 8-word values, 960 a Blake2s
compression, and a Poseidon permutation of width 3 in its optimized form
412 products and 154 squarings (108 operations each) for a leaf, 416 and
156 for a pair. A field element moves as its 32 bytes."""

from __future__ import annotations

MONT = 136
SQUARE = 108
BLAKE2S = 960
POSEIDON_LEAF = 412 * MONT + 154 * SQUARE
POSEIDON_PAIR = 416 * MONT + 156 * SQUARE
ELEM = 32


def log2(n: int) -> int:
    return n.bit_length() - 1


def butterflies(n: int, stages: int | None = None) -> int:
    """Radix-2 butterflies (one product each) of `stages` stages of a
    transform of n points; all log2(n) by default."""
    return (n // 2) * (log2(n) if stages is None else stages)


def lde_products(n: int, blowup: int) -> int:
    """Products of a low-degree extension of n values to blowup * n points:
    the inverse transform and its 1/n, then one transform of n points for
    each coset with its shift. The least a blowup needs: a zero-padded
    transform of blowup * n points would take log2(blowup) more stages."""
    return butterflies(n) + n + blowup * (butterflies(n) + n)


def blake2s_compressions(n: int, msg_bytes: int) -> int:
    return n * max(1, -(-msg_bytes // 64))


def tree_ops(n_leaves: int, leaf_bytes: int, digest: str) -> int:
    """A Merkle tree's hashing: each leaf, then n - 1 pairs."""
    if digest == "poseidon":
        return n_leaves * POSEIDON_LEAF + (n_leaves - 1) * POSEIDON_PAIR
    return (blake2s_compressions(n_leaves, leaf_bytes) + n_leaves - 1) * BLAKE2S
