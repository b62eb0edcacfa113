"""Host-side polynomial algebra over python ints (mod p).

Replicates the reference's `fri/src/poly_utils.rs` and the recursive FFT of
`fri/src/fft.rs:64-142` for the *small* protocol pieces (boundary
interpolants, FRI direct-check base case); everything O(domain)-sized runs on
device via :mod:`stark_tpu_torch.ops.ntt` instead. Polynomials are lists of ints,
coefficient order low-to-high.

The port's own copy of `stark_tpu/utils/poly_host.py`.
"""

from __future__ import annotations

from stark_tpu_torch.fields.field import FieldSpec


def eval_poly_at(spec: FieldSpec, poly, x: int) -> int:
    # poly_utils.rs:93-102 (power accumulation; Horner is equivalent)
    p = spec.p
    acc = 0
    for c in reversed(poly):
        acc = (acc * x + c) % p
    return acc


def add_polys(spec: FieldSpec, a, b):
    n = max(len(a), len(b))
    return [
        ((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % spec.p
        for i in range(n)
    ]


def sub_polys(spec: FieldSpec, a, b):
    n = max(len(a), len(b))
    return [
        ((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % spec.p
        for i in range(n)
    ]


def mul_by_const(spec: FieldSpec, a, s: int):
    return [c * s % spec.p for c in a]


def mul_polys(spec: FieldSpec, a, b):
    # schoolbook (poly_utils.rs:203-212)
    out = [0] * (len(a) + len(b) - 1)
    for i, ca in enumerate(a):
        if ca == 0:
            continue
        for j, cb in enumerate(b):
            out[i + j] = (out[i + j] + ca * cb) % spec.p
    return out


def div_polys(spec: FieldSpec, a, b):
    # long division dropping leading zero divisor coeffs (poly_utils.rs:235-262)
    nz = len(b)
    while nz > 0 and b[nz - 1] == 0:
        nz -= 1
    b = b[:nz]
    assert len(a) >= len(b)
    c = list(a)
    out = []
    apos = len(a) - 1
    bpos = len(b) - 1
    binv = spec.inv(b[bpos])
    for d in range(apos - bpos, -1, -1):
        quot = c[apos] * binv % spec.p
        out.append(quot)
        for i in range(bpos, -1, -1):
            c[d + i] = (c[d + i] - b[i] * quot) % spec.p
        apos -= 1
    out.reverse()
    return out


def reduction_poly(spec: FieldSpec, a, n: int):
    # fold coefficients mod (X^n - 1) (poly_utils.rs:178-185)
    out = [0] * n
    for i, c in enumerate(a):
        out[i % n] = (out[i % n] + c) % spec.p
    return out


def mod_polys(spec: FieldSpec, a, b):
    # remainder of a / b, length len(b)-1 (poly_utils.rs:291-295)
    rem = sub_polys(spec, a, mul_polys(spec, b, div_polys(spec, a, b)))
    return rem[: len(b) - 1]


def sparse(spec: FieldSpec, coeff_dict):
    # dense polynomial from {degree: coeff} (poly_utils.rs:330-336)
    out = [0] * (max(coeff_dict) + 1)
    for k, v in coeff_dict.items():
        out[k] = v % spec.p
    return out


def poly_scale(spec: FieldSpec, a, n: int):
    # multiply by X^n (poly_utils.rs:228-232)
    return [0] * n + list(a)


def zpoly(spec: FieldSpec, xs):
    # vanishing polynomial prod (X - x_i) (poly_utils.rs:362-373)
    root = [1]
    for x in xs:
        root.append(0)
        for j in range(len(root) - 2, -1, -1):
            root[j + 1] = (root[j + 1] - root[j] * x) % spec.p
    root.reverse()
    return root


def lagrange_interp(spec: FieldSpec, xs, ys):
    # poly_utils.rs:409-439
    root = zpoly(spec, xs)
    assert len(root) == len(ys) + 1
    nums = [div_polys(spec, root, [(-x) % spec.p, 1]) for x in xs]
    denoms = [eval_poly_at(spec, nums[i], xs[i]) for i in range(len(xs))]
    out = [0] * len(ys)
    for i in range(len(xs)):
        yslice = ys[i] * spec.inv(denoms[i]) % spec.p
        for j in range(len(ys)):
            out[j] = (out[j] + nums[i][j] * yslice) % spec.p
    return out


def eval_quartic(spec: FieldSpec, p4, x: int) -> int:
    # poly_utils.rs:442-446
    xsq = x * x % spec.p
    return (p4[0] + p4[1] * x + p4[2] * xsq + p4[3] * xsq * x) % spec.p


# --- reference-parity FFT helpers for arbitrary (non-power-of-two) orders ---
# Used only by unit tests / small host paths, like the reference's
# `_simple_ft`/`_fft` (`fft.rs:64-142`).

def simple_ft(spec: FieldSpec, values, roots):
    m = len(roots)
    vals = list(values) + [0] * max(0, m - len(values))
    return [
        sum(vals[j] * roots[(i * j) % m] for j in range(m)) % spec.p
        for i in range(m)
    ]


def fft_recursive(spec: FieldSpec, values, roots):
    if len(values) <= 4:
        return simple_ft(spec, values, roots)
    vals = list(values)
    if len(vals) % 2 == 1:
        vals.append(0)
    even = fft_recursive(spec, vals[0::2], roots[0::2])
    odd = fft_recursive(spec, vals[1::2], roots[0::2])
    m = len(roots)
    out = [0] * (2 * len(even))
    for i in range(len(even)):
        y_t = odd[i] * roots[i % m] % spec.p
        out[i] = (even[i] + y_t) % spec.p
        out[i + len(even)] = (even[i] - y_t) % spec.p
    return out


def expand_root_of_unity(spec: FieldSpec, root: int):
    # fft.rs:5-14 (host, small orders only)
    out = [1]
    cur = root % spec.p
    while cur != 1:
        out.append(cur)
        cur = cur * root % spec.p
    return out
