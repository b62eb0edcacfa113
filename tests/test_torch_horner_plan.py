"""The grouped arithmetic of `horner_eval` and `vanishing_eval` in
`csrc/protocol.cu`, modelled on the CPU in Python integers: no kernel runs
here.

Both kernels evaluate at each x in groups of G terms, G a build in
`fused_kernels.GROUPS`:
- Horner's rule in x^G: the powers x^2 .. x^G by CIOS products, then from
  the highest group down acc <- REDC(acc*x^G + sum_(0<j<G) c_j x^j +
  c_0*2^256), the highest group short and without acc (one coefficient:
  that coefficient);
- the vanishing product by spans of 32 points: each span's monic product
  x^s + sum_(j<s) e_j x^j (`vanishing_coeffs`, a warp a span, lane j
  holding e_j) valued by the same Horner in x^G with its leading 1 in the
  highest group (x^t*2^256 there, x^G*2^256 in the next group when the 1
  is alone), and multiplied into the accumulator by a CIOS product from
  the second span on; G = 1 is the product of the differences.
The model runs the wide sums word by word as the PTX states them
(`mac_wide`, `redc_wide` of `test_torch_lincomb_plan.py`, and the carry
chain of `add_shifted`), in the kernels' order of tiles and groups, and
asserts the bound of `fused_kernels.group_fits` on every reduction.

Checks, exact throughout, on BN254 and BLS12-381's scalar fields (the two
fields the CUDA kernels take), at 16 points x with 0, 1 and p - 1 among
them and among the coefficients and points:
- the model of every build at d in {0, 1, 2, 3, G - 1, G, G + 1, 2G + 1,
  1,062} and as many points (and 32, 33 + G), against Python integers;
- the port's plain versions against Python integers at the same counts;
- the JAX package's composed `horner_eval` and `vanishing_eval`
  (`stark_tpu/protocol/kernels.py`, the branch it runs on the CPU) against
  Python integers up to 33 terms (their loops unroll at trace time, so
  1,062 terms stay with the integers);
- the span coefficients of `vanishing_coeffs_plain` against the model of
  the pre-pass kernel and against the JAX package's host `zpoly` of each
  span, at 1, 31, 33 and 1,061 points, and, through the JAX
  package's own functions, a span's polynomial by `horner_eval` against
  `vanishing_eval` of its points;
- the wide-sum bound with every operand p - 1 at each build and at the
  largest G the field allows.
"""

import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BLS12_381_FR as jbls
from stark_tpu.fields.field import BN254_FR as jbn
from stark_tpu.ops import modmath as jmm
from stark_tpu.protocol import kernels as jk
from stark_tpu.utils import poly_host as jph
from stark_tpu_torch.fields.field import BLS12_381_FR, BN254_FR
from stark_tpu_torch.protocol import fused_kernels as fk
from test_torch_lincomb_plan import M32, NW, WIDE, ints, mac_wide, planes, redc_wide, value, words

torch.set_num_threads(2)

SPAN = fk.SPAN

FIELDS = {"bn254": (BN254_FR, jbn), "bls12_381": (BLS12_381_FR, jbls)}
SMALL_TILE = 128  # protocol.cu: columns of a small operand staged at once
LONG = 1062  # the `bits` golden's public wires
JAX_MAX = 33
# the largest G `group_fits` allows (a group, one with a leading 1), as
# protocol.cu states
LIMITS = {"bn254": (31, 27), "bls12_381": (13, 12)}


def counts(g: int, spans: bool = False) -> list[int]:
    """Term counts on each side of g's groups (and, with `spans`, of a span)."""
    out = {0, 1, 2, 3, g - 1, g, g + 1, 2 * g + 1, LONG} | ({SPAN, SPAN + g + 1} if spans else set())
    return sorted(out - {-1})


def mont(spec, a: int, b: int) -> int:
    return a * b * pow(1 << 256, -1, spec.p) % spec.p


def add_shifted(acc, c):
    """`add_shifted`: acc[8..15] += c with a carry chain into acc[16]."""
    cf = 0
    for j in range(NW):
        s = acc[NW + j] + c[j] + cf
        acc[NW + j], cf = s & M32, s >> 32
    acc[2 * NW] += cf
    assert acc[2 * NW] <= M32


def redc_canonical(spec, acc) -> int:
    """`redc_canonical`: REDC, then 4p, 2p, p taken away where not below."""
    redc_wide(spec, acc)
    t = value(acc[NW:])
    assert t < 8 * spec.p
    for s in (2, 1, 0):
        if t >= spec.p << s:
            t -= spec.p << s
    return t


def tile_of(g: int) -> int:
    return SMALL_TILE // g * g


def powers(spec, x: int, m: int) -> list[int]:
    """xp[k] = x^(k+1) in Montgomery form for k < max(m, 1)."""
    xp = [x]
    for _ in range(1, m):
        xp.append(mont(spec, xp[-1], x))
    return xp


def horner_group(spec, g, xp, c, first, acc) -> int:
    if first and len(c) == 1:
        return c[0]
    assert first or len(c) == g  # only the highest group may be short
    w = [0] * WIDE
    if not first:
        mac_wide(w, words(acc), words(xp[g - 1]))
    for j in range(1, len(c)):
        mac_wide(w, words(c[j]), words(xp[j - 1]))
    add_shifted(w, words(c[0]))
    return redc_canonical(spec, w)


def horner_model(spec, g: int, c: list[int], x: int) -> int:
    """`horner_kernel<g>` at one x: Montgomery ints in and out."""
    d, tile = len(c), tile_of(g)
    xp = powers(spec, x, min(g, d - 1))
    acc, first, hi = 0, True, d
    while hi > 0:
        base = (hi - 1) // tile * tile
        top = hi - base
        while top > 0:
            lo = (top - 1) // g * g
            acc = horner_group(spec, g, xp, c[base + lo : base + top], first, acc)
            first, top = False, lo
        hi = base
    return acc


def span_value(spec, g, xp, e) -> int:
    """`span_value<g>`: the span's monic product x^s + sum e_j x^j at x."""
    s = len(e)
    lo, t = s // g * g, s % g
    v = None
    if t == 1:
        v = (xp[0] + e[lo]) % spec.p
    elif t > 1:
        w = [0] * WIDE
        add_shifted(w, words(e[lo]))
        for j in range(1, g):
            if j < t:
                mac_wide(w, words(e[lo + j]), words(xp[j - 1]))
            elif j == t:
                add_shifted(w, words(xp[j - 1]))
        v = redc_canonical(spec, w)
    for top in range(lo, 0, -g):
        w = [0] * WIDE
        if top == s:
            add_shifted(w, words(xp[g - 1]))
        else:
            mac_wide(w, words(v), words(xp[g - 1]))
        for j in range(1, g):
            mac_wide(w, words(e[top - g + j]), words(xp[j - 1]))
        add_shifted(w, words(e[top - g]))
        v = redc_canonical(spec, w)
    return v


def vanishing_model(spec, g: int, es: list[int], x: int) -> int:
    """`vanishing_kernel<g>` at one x; es: the points for g = 1, else the
    spans' coefficients."""
    npts, step = len(es), 1 if g == 1 else SPAN
    xp = powers(spec, x, min(g, npts))
    acc, first = (1 << 256) % spec.p, True
    for base in range(0, npts, SMALL_TILE):
        count = min(SMALL_TILE, npts - base)
        for lo in range(0, count, step):
            if g == 1:
                v = (x - es[base + lo]) % spec.p
            else:
                v = span_value(spec, g, xp, es[base + lo : base + min(lo + SPAN, count)])
            acc = v if first else mont(spec, acc, v)
            first = False
    return acc


def coeffs_model(spec, pts: list[int]) -> list[int]:
    """`vanishing_coeffs_kernel`: each span's e_0 .. e_(s-1), lane j of its
    warp holding c_j, from x - q_0; each step takes c_(j-1) from the lane
    below (0 in lane 0) and forms c_(j-1) - q_k*c_j."""
    p, one, out = spec.p, (1 << 256) % spec.p, []
    for lo in range(0, len(pts), SPAN):
        q = pts[lo : lo + SPAN]
        c = [-q[0] % p, one] + [0] * (SPAN - 2)
        for k in range(1, len(q)):
            below = [0] + c[:-1]
            c = [(below[j] - mont(spec, q[k], c[j])) % p for j in range(SPAN)]
        out += c[: len(q)]
    return out


def values(spec, seed: int, count: int) -> list[int]:
    """Montgomery ints: 0, 1 and p - 1 (plain) first, then numpy-seeded."""
    rng = np.random.default_rng(seed)
    r = 1 << 256
    plain = [0, 1, spec.p - 1] + [int.from_bytes(rng.bytes(32), "little") % spec.p
                                   for _ in range(max(count - 3, 0))]
    return [v * r % spec.p for v in plain[:count]]


def horner_truth(spec, c, x) -> int:
    r, p = 1 << 256, spec.p
    ri = pow(r, -1, p)
    xv = x * ri % p
    return sum(ci * ri * pow(xv, i, p) for i, ci in enumerate(c)) % p * r % p


def vanishing_truth(spec, pts, x) -> int:
    r, p = 1 << 256, spec.p
    ri, out = pow(r, -1, p), r % p
    for q in pts:
        out = out * (x - q) * ri % p
    return out


XS = {name: values(spec, 1, 16) for name, (spec, _) in FIELDS.items()}


def coeffs_of(name, d):
    return values(FIELDS[name][0], 100 + d, d)


def points_of(name, npts):
    return values(FIELDS[name][0], 5000 + npts, npts)


def _np_planes(vals) -> np.ndarray:
    return planes(vals).numpy().view(np.uint32)


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("g", fk.GROUPS)
def test_horner_model(name, g):
    spec = FIELDS[name][0]
    for d in counts(g):
        c = coeffs_of(name, d)
        for x in XS[name]:
            assert horner_model(spec, g, c, x) == horner_truth(spec, c, x), (d, x)


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("g", fk.GROUPS)
def test_vanishing_model(name, g):
    spec = FIELDS[name][0]
    for npts in counts(g, spans=True):
        pts = points_of(name, npts)
        es = pts if g == 1 else coeffs_model(spec, pts)
        for x in XS[name]:
            assert vanishing_model(spec, g, es, x) == vanishing_truth(spec, pts, x), (npts, x)


def all_counts():
    return sorted({n for g in fk.GROUPS for n in counts(g)})


@pytest.mark.parametrize("name", FIELDS)
def test_plain_versions_against_ints(name):
    spec = FIELDS[name][0]
    xs = planes(XS[name])
    for d in all_counts():
        c = coeffs_of(name, d)
        got = ints(fk.horner_eval_plain(spec, planes(c) if d else xs[:, :0], xs))
        assert got == [horner_truth(spec, c, x) for x in XS[name]], d
        pts = points_of(name, d)
        got = ints(fk.vanishing_eval_plain(spec, xs, planes(pts) if d else xs[:, :0]))
        assert got == [vanishing_truth(spec, pts, x) for x in XS[name]], d


@pytest.mark.parametrize("name", FIELDS)
def test_jax_against_ints(name):
    spec, jspec = FIELDS[name]
    xs = _np_planes(XS[name])
    for d in [n for n in all_counts() if 1 <= n <= JAX_MAX] + [JAX_MAX]:
        c, pts = coeffs_of(name, d), points_of(name, d)
        got = jmm.limbs_to_ints_np(np.asarray(jk.horner_eval(jspec, _np_planes(c), xs)), jspec)
        assert got == [horner_truth(spec, c, x) for x in XS[name]], d
        got = jmm.limbs_to_ints_np(np.asarray(jk.vanishing_eval(jspec, xs, _np_planes(pts))),
                                   jspec)
        assert got == [vanishing_truth(spec, pts, x) for x in XS[name]], d


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("npts", [1, SPAN - 1, SPAN + 1, LONG - 1])
def test_span_coeffs(name, npts):
    spec, jspec = FIELDS[name]
    ri = pow(1 << 256, -1, spec.p)
    pts = points_of(name, npts)
    e = ints(fk.vanishing_coeffs_plain(spec, planes(pts)))
    assert e == coeffs_model(spec, pts)
    for lo in range(0, npts, SPAN):
        q = [v * ri % spec.p for v in pts[lo : lo + SPAN]]
        assert [v * ri % spec.p for v in e[lo : lo + SPAN]] == jph.zpoly(jspec, q)[:-1]


@pytest.mark.parametrize("name", FIELDS)
def test_span_polynomial_through_jax(name):
    """A span's coefficients with the leading 1, through the JAX package's
    `horner_eval`, equal its `vanishing_eval` of the span's points."""
    spec, jspec = FIELDS[name]
    pts = points_of(name, 9)
    e = coeffs_model(spec, pts)
    xs = _np_planes(XS[name])
    one = (1 << 256) % spec.p
    want = np.asarray(jk.vanishing_eval(jspec, xs, _np_planes(pts)))
    got = np.asarray(jk.horner_eval(jspec, _np_planes(e + [one]), xs))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", FIELDS)
def test_wide_sum_bound(name):
    spec = FIELDS[name][0]
    top = spec.p - 1
    h_max, v_max = LIMITS[name]
    assert [g for g in range(1, 64) if fk.group_fits(spec, g)][-1] == h_max
    assert [g for g in range(1, 64) if fk.group_fits(spec, g, lead=True)][-1] == v_max
    assert not fk.group_fits(spec, h_max + 1)
    assert not fk.group_fits(spec, v_max + 1, lead=True)
    for g in sorted(set(fk.GROUPS) | {v_max}):
        assert fk.group_fits(spec, g) and fk.group_fits(spec, g, lead=True)
        xp = [top] * g
        # a full group after the first: acc, the powers, every coefficient p - 1
        assert horner_group(spec, g, xp, [top] * g, False, top) < spec.p
        if g > 1:
            # a span's highest group with g - 1 coefficients and its leading 1,
            # a lone 1 then a full group, and a full group with acc
            for s in (g - 1, g, 2 * g):
                assert span_value(spec, g, xp, [top] * s) < spec.p
    # every build the wrappers choose stays within both bounds
    for count in range(0, 80):
        assert fk.group_fits(spec, fk.horner_group(spec, count))
        for n in (1 << 10, 1 << 20):
            g = fk.vanishing_group(spec, count, n)
            assert fk.group_fits(spec, g) and fk.group_fits(spec, g, lead=True)
