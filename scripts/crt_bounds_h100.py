#!/usr/bin/env python3
"""Reckon the least time an NVIDIA H100 could take for the three CRT-engine
kernels of the JAX package that the PyTorch/CUDA port does not have yet.

    python3 scripts/crt_bounds_h100.py [--precision 1048576]

Nothing runs on a card and nothing is measured: the script counts bytes and
operations from the JAX package's code (`stark_tpu/ops/pallas_crt.py:106`,
`:176`, `:254`, `ops/crt.py`, `ops/mxu_ntt.py`) at the shapes one LDE of
`precision` points gives those kernels, and divides by the card's rates as
`chip_smoke.py` states them. It prints one JSON object. When the three
kernels are ported, `chip_smoke.py` computes their bounds from the inputs it
runs them on and this script goes. Needs neither JAX nor a card.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the card's rates)
from stark_tpu_torch.fields.field import BN254_FR  # noqa: E402


def reckon_crt_bounds(spec, precision: int) -> dict:
    """Bounds of the three CRT-engine kernels that are not ported yet
    (`stark_tpu/ops/pallas_crt.py:106`, `:176`, `:254`), reckoned from that
    code at the largest call a `precision`-point LDE would make of each: the
    second contraction of the big transform (`ops/mxu_ntt.py:142 ntt_mxu`:
    n1 = n2 = 1024 at 2^20, the twiddle pre-multiplied). Nothing is run.

    The basis holds P primes of 14 bits whose product exceeds 2^bits_b
    (`crt.select_primes`, `mxu_ntt.py:113`) and one redundant lane. Bytes:
    each input read once, each output written once (limbs and residues in
    4 bytes, digit planes in 2). Matrix products at the card's 989e12 bf16
    operations a second, the integer folds and carries at `chip_smoke.INT_OPS_PER_S`,
    a fold as 4 operations, a conditional subtraction as 3, a carried digit
    row as 3."""
    def is_prime(q):
        return q > 1 and all(q % d for d in range(2, int(q ** 0.5) + 1))

    def folds(bits, dmax_bits=10):  # crt._fold_count
        count = 0
        while bits >= 16:
            bits, count = max(bits - 14 + dmax_bits, 14) + 1, count + 1
        return count

    N = precision
    n1 = 1 << ((N.bit_length()) // 2)
    n2 = N // n1
    bits_b = (n2 - 1).bit_length() + 3 * spec.p.bit_length() + 2
    P, logs, q = 0, 0.0, 16128
    while logs <= bits_b:
        if is_prime(q):
            P, logs = P + 1, logs + float(np.log2(q))
        q -= 1
    P1, ND, TENSOR = P + 1, 35, 989e12

    def bound(nbytes, tensor_ops, int_ops):
        times = {"bytes": nbytes / chip_smoke.BYTES_PER_S * 1e3,
                 "operations": (tensor_ops / TENSOR + int_ops / chip_smoke.INT_OPS_PER_S) * 1e3}
        by = max(times, key=times.get)
        return {"bytes": nbytes, "tensor_ops": tensor_ops, "int_ops": int_ops,
                "bound_ms": times[by], "bound_by": by}

    return {
        "case": f"n={N} n1={n1} n2={n2} primes={P}+1 (reckoned, not run)",
        "residues_in": bound(
            64 * N + 4 * P1 * N + 2 * 2 * P1 * N, 2 * (2 * P1) * 32 * N,
            P1 * N * (5 + 4 * (folds(29) + folds(28)) + 4 * 3 + 1 + 2)),
        "matmul_fold": bound(
            2 * 2 * P1 * n2 * n2 + 2 * 2 * P1 * n2 * n1 + 4 * P1 * N,
            4 * 2 * P1 * n2 * n2 * n1,
            P1 * N * (2 * 4 + 6 + 4 * folds(32) + 2 * 3)),
        "reconstruct": bound(
            4 * P1 * N + 64 * N,
            (2 * 2 * (ND + 2) * P + 2 * 32 * 32 + 2 * 65 * 32) * N,
            N * (2 * 3 * P1 + 4 * ND + 3 * (ND + 1 + 32 + 66) + 16 * 3 + 64)),
    }


if __name__ == "__main__":
    precision = int(sys.argv[sys.argv.index("--precision") + 1]) if "--precision" in sys.argv \
        else 1 << 20
    print(json.dumps(reckon_crt_bounds(BN254_FR, precision), indent=1))
