"""The `commits` phase: the m-tree over the eight committed columns
(256-byte leaves, Blake2s), the ten coefficients k from its root, the
linear combination L (seven products a point: L = D1 + k1 D2 + k2 D3 +
(k3 + k4 x^s) P + (k5 + k6 x^s) B2 + (k7 + k8 x^s) B3 + k9 A + k10 S,
where x^s takes eight values, so each k + k' x^s is one of eight constants) and the l-tree over L's
32-byte values under the cell's digest. Bytes: the eight columns read, L
written, and both trees' digest layers (2N digests each) written."""

from __future__ import annotations

from benchmark.counts import ELEM, MONT, tree_ops


def work(sizes: dict) -> tuple[float, float]:
    N = sizes["precision"]
    ops = tree_ops(N, 8 * ELEM, "blake2s") + 7 * N * MONT + tree_ops(N, ELEM, sizes["digest"])
    nbytes = (8 * N + N + 4 * N) * ELEM
    return ops, nbytes
