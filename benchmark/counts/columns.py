"""The `columns` phase: from the trace columns of one witness to the eight
committed columns P, A, S, D1-D3, B2, B3 on the 8x domain.

Counted: the three extensions that depend on the witness (S, P and the
accumulator A); the accumulator over the steps (three products a step for
the random combinations, two prefix products, a batch inverse at three
products an element, the quotient); at each of the N points the quotients
Q1 (3 products), Q2 (2), Q3 (5), D = Q / Z (3), B2 (1, plus a product
for each public point past the first) and B3 (1). Bytes: the witness's two
trace columns read, the six circuit-static extensions (K, the flags, the
indices and their permutation) read, the eight columns written.

Not counted, since they are the circuit's and not the witness's: the
extensions of K, F0-F2, the indices and the permutation, Z^-1, Zb2^-1 and
Zb3^-1. The program recomputes the six extensions each proof; the sum of
its kernels' bounds (the kernel table's rows 2-3, 6-10, 14-15) is larger
by those six and by the zero-padded stages."""

from __future__ import annotations

from benchmark.counts import ELEM, MONT, lde_products


def work(sizes: dict) -> tuple[float, float]:
    S, N = sizes["steps"], sizes["precision"]
    products = 3 * lde_products(S, N // S) + 9 * S
    products += N * (3 + 2 + 5 + 3 + 1 + (sizes["public_points"] - 1) + 1)
    nbytes = (2 * S + 6 * N + 8 * N) * ELEM
    return products * MONT, nbytes
