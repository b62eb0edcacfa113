"""The arithmetic of the two kernels `csrc/protocol.cu` redesigned for the
H100, modelled on the CPU in Python integers, and the host's plan of
`q2_eval`'s order: no kernel runs here.

`linear_combination_shoup` (and the table form, `linear_combination`) sums
8 products wide and reduces once: each plane times its coefficient (k_j, or
k3 + k4*x, k5 + k6*x, k7 + k8*x for P, B2 and B3, the x^steps terms folded
in), accumulated in 17 words by rows of two 32-bit carry chains with the
carry past a row's ninth word deferred (`mac_row`), one Montgomery
reduction by the same rows (`redc_wide`), then subtractions of 4p, 2p and
p. The model runs those word operations as the PTX states them, asserts
the bounds `protocol.cu`'s header states on both fields the CUDA kernels
take (BN254 and BLS12-381's Fr), and must equal the plain PyTorch versions
bit for bit, at random values and at edges (every k_j and term p - 1,
zeros, raw ones, Montgomery ones).

`q2_eval`'s plan (`fused_kernels.q2_plan`), through the kernel's own
formulas for the output of each thread, must give every output exactly
once for the prover's shapes and for shifts of 0, 1, n - 1, n + 5 and one
coprime to n; `q2_eval_plain` computed in the plan's order, with the reads
the kernel makes, must equal the straight order. Exact
checks throughout; the Pallas-against-plain tests of both kernels are in
`test_torch_fused.py` and `test_torch_fused_shoup.py`.
"""

import random

import pytest
import torch

from stark_tpu_torch.fields.field import BLS12_381_FR, BN254_FR
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import fused_kernels as fk

torch.set_num_threads(2)

M32 = (1 << 32) - 1
NW, WIDE = 8, 17
FIELDS = {"bn254": BN254_FR, "bls12_381": BLS12_381_FR}
# the plane order of the C entry points and each plane's coefficient: k index,
# or the x coefficient w (k[3 + 2w] + k[4 + 2w]*x)
PLANES = ("p", "a", "s", "d1", "d2", "d3", "b2", "b3")
COEF = {"p": ("x", 0), "a": ("k", 9), "s": ("k", 10), "d1": ("k", 0), "d2": ("k", 1),
        "d3": ("k", 2), "b2": ("x", 1), "b3": ("x", 2)}
# the header's bounds: the lazy sum's words, and T = REDC(sum) below this many p
HEADER = {"bn254": (16, 2.52), "bls12_381": (17, 4.63)}


def words(x: int, n: int = NW) -> list[int]:
    return [(x >> 32 * i) & M32 for i in range(n)]


def value(ws) -> int:
    return sum(w << 32 * i for i, w in enumerate(ws))


def mac_row(acc, pend, c, v, b):
    """`mac_row<B>`: acc[b..b+7] += lo(c*v), acc[b+8] += pend and the carry,
    acc[b+1..b+8] += hi(c*v); returns the carry owed at word b + 9."""
    cf = 0
    for j in range(NW):
        s = acc[b + j] + ((c[j] * v) & M32) + cf
        acc[b + j], cf = s & M32, s >> 32
    s = acc[b + NW] + pend + cf
    acc[b + NW], pend = s & M32, s >> 32
    cf = 0
    for j in range(NW):
        s = acc[b + 1 + j] + ((c[j] * v) >> 32) + cf
        acc[b + 1 + j], cf = s & M32, s >> 32
    pend += cf
    assert pend <= 2
    return pend


def mac_wide(acc, c, v):
    pend = 0
    for b in range(NW):
        pend = mac_row(acc, pend, c, v[b], b)
    acc[2 * NW] += pend
    assert acc[2 * NW] <= M32


def redc_wide(spec, acc):
    np32 = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    pw, pend = words(spec.p), 0
    for b in range(NW):
        pend = mac_row(acc, pend, pw, (acc[b] * np32) & M32, b)
        assert acc[b] == 0
    acc[2 * NW] += pend
    assert acc[2 * NW] <= M32


def shoup(spec, w: int, x: int) -> int:
    """`field.cuh shoup_mul` then `cond_sub_p`: w*x mod p for plain w."""
    wp = (w << 256) // spec.p
    r = w * x - ((wp * x) >> 256) * spec.p
    assert 0 <= r < 2 * spec.p
    return r - spec.p if r >= spec.p else r


def mont(spec, a: int, b: int) -> int:
    return a * b * pow(1 << 256, -1, spec.p) % spec.p


def lincomb_model(spec, k, xcoef, cols, j):
    """L at element j as the kernel forms it, from Montgomery ints; returns
    (L, the lazy sum, T before the subtractions)."""
    p = spec.p
    xs = [(k[3 + 2 * w] + xcoef(k[4 + 2 * w])) % p for w in range(3)]
    acc = [0] * WIDE
    for name in PLANES:
        kind, idx = COEF[name]
        c = xs[idx] if kind == "x" else k[idx]
        mac_wide(acc, words(c), words(cols[name][j]))
    wide = value(acc)
    redc_wide(spec, acc)
    t = value(acc[NW:])
    assert t < 1 << 288 and t < 8 * p
    r = t
    for s in (2, 1, 0):
        if r >= p << s:
            r -= p << s
    assert r < p
    return r, wide, t


def ints(planes: torch.Tensor) -> list[int]:
    limbs = planes.to(torch.int64).tolist()
    return [sum(limbs[r][c] << 16 * r for r in range(16)) for c in range(planes.shape[1])]


def planes(vals) -> torch.Tensor:
    return torch.tensor([[(v >> 16 * r) & 0xFFFF for v in vals] for r in range(16)],
                        dtype=torch.int32)


def cases(spec, seed: int, n: int = 16, t: int = 8):
    """(k (11 ints), x pattern (t plain ints), 8 columns of n Montgomery ints):
    random, then the edges."""
    rng = random.Random(seed)
    p = spec.p
    rand = lambda: rng.randrange(p)  # noqa: E731
    out = [("random", [rand() for _ in range(11)], [0, 1, p - 1] + [rand() for _ in range(t - 3)],
            {name: [rand() for _ in range(n)] for name in PLANES})]
    r = (1 << 256) % p
    for label, v in (("p-1", p - 1), ("zeros", 0), ("raw ones", 1), ("mont ones", r)):
        out.append((label, [v] * 11, [v % p] * t, {name: [v] * n for name in PLANES}))
    return out


@pytest.mark.parametrize("field", FIELDS)
def test_lincomb_shoup_model(field):
    spec = FIELDS[field]
    for label, k, pat, cols in cases(spec, 31):
        n, t = len(cols["p"]), len(pat)
        got = [lincomb_model(spec, k, lambda kv, j=j: shoup(spec, pat[j % t], kv), cols, j)[0]
               for j in range(n)]
        w_pat, wp_pat = mm.shoup_consts(spec, pat, "cpu")
        want = fk.linear_combination_shoup_plain(spec, planes(k), w_pat, wp_pat,
                                                 *[planes(cols[c]) for c in PLANES])
        assert got == ints(want), label


@pytest.mark.parametrize("field", FIELDS)
def test_lincomb_table_model(field):
    spec = FIELDS[field]
    for label, k, _, cols in cases(spec, 32):
        n = len(cols["p"])
        x = [random.Random(33 + j).randrange(spec.p) for j in range(n)]
        got = [lincomb_model(spec, k, lambda kv, j=j: mont(spec, kv, x[j]), cols, j)[0]
               for j in range(n)]
        want = fk.linear_combination_plain(spec, planes(k), planes(x),
                                           *[planes(cols[c]) for c in PLANES])
        assert got == ints(want), label


@pytest.mark.parametrize("field", FIELDS)
def test_lincomb_header_bounds(field):
    """The worst case (every coefficient and term p - 1) and the header's
    numbers: the sum fits its words, T its multiple of p, for any field the
    CUDA kernels take (2p < 2^256) within 5p."""
    spec = FIELDS[field]
    p = spec.p
    sum_words, t_over_p = HEADER[field]
    assert 8 * p * p < 1 << 32 * sum_words
    assert 8 * p * p >= 1 << 32 * (sum_words - 1)
    assert 8 * p * p / (1 << 256) + p < t_over_p * p <= 5 * p
    assert 2 * p < 1 << 256
    k = [p - 1] * 11
    cols = {name: [p - 1] for name in PLANES}
    _, wide, t = lincomb_model(spec, k, lambda kv: shoup(spec, p - 1, kv), cols, 0)
    assert wide < 8 * p * p and t < t_over_p * p


def prover_shapes():
    """(n, kshift) of the prover at steps 2^10 .. 2^17, skips 8."""
    return [(8 * steps, steps // 3 * 8) for steps in (1 << e for e in range(10, 18))]


def other_shapes(n: int):
    return [(n, 0), (n, 1), (n, n - 1), (n, n + 5), (n, 12345)]


def kernel_outputs(n: int, kshift: int) -> torch.Tensor:
    """The output each thread of `q2_eval`'s kernel writes, by the kernel's
    own formulas, in thread order (threads that write nothing left out)."""
    k1, _, span = fk.q2_plan(n, kshift)
    grouped = (span + 31) // 32 * 96
    t = torch.arange(grouped + n - 3 * span)
    g = t // 96 * 32 + t % 32
    i = torch.where(t < grouped, g + (t % 96) // 32 * k1, t - grouped + 3 * span)
    return i[torch.where(t < grouped, g < span, i < n)]


@pytest.mark.parametrize("n,kshift", prover_shapes() + other_shapes(1 << 13) + other_shapes(192),
                         ids=lambda v: str(v))
def test_q2_plan_bijection(n, kshift):
    k1, k2, span = fk.q2_plan(n, kshift)
    assert (k1, k2) == (kshift % n, 2 * kshift % n)
    order = kernel_outputs(n, kshift)
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    assert span == 0 or 3 * span <= n


@pytest.mark.parametrize("steps", [1 << e for e in range(10, 18)])
def test_q2_plan_groups_the_prover(steps):
    """The prover's shift is grouped, and a slice's last two reads are its
    first two 8*(steps mod 3) elements back."""
    n, kshift = 8 * steps, steps // 3 * 8
    k1, _, span = fk.q2_plan(n, kshift)
    assert span == k1 == kshift
    assert n - 3 * k1 == 8 * (steps % 3)


def q2_in_plan_order(spec, p, f2, kshift):
    """Q2 with the reads and writes of the kernel's threads in the plan's
    order (P at i, i + k1 and i + k2, each wrapped once); outputs never
    written stay -1."""
    n = p.shape[1]
    k1, k2, _ = fk.q2_plan(n, kshift)
    i = kernel_outputs(n, kshift)
    i1, i2 = i + k1, i + k2
    i1, i2 = torch.where(i1 < n, i1, i1 - n), torch.where(i2 < n, i2, i2 - n)
    out = torch.full_like(p, -1)
    out[:, i] = fk._mul(spec, f2[:, i], mm.msub(spec, p[:, i2], fk._mul(spec, p[:, i], p[:, i1])))
    return out


@pytest.mark.parametrize("n,kshift", [(8 * 1024, 1024 // 3 * 8), (8 * 128, 128 // 3 * 8)]
                         + other_shapes(1 << 10) + other_shapes(192), ids=lambda v: str(v))
def test_q2_plan_order_values(n, kshift):
    gen = torch.Generator().manual_seed(n + kshift)
    p = mm.to_mont(BN254_FR, torch.randint(0, 1 << 16, (16, n), generator=gen,
                                           dtype=torch.int32) % 4096)
    f2 = torch.roll(p, 7, dims=1).flip(1).contiguous()
    got = q2_in_plan_order(BN254_FR, p, f2, kshift)
    assert torch.equal(got, fk.q2_eval_plain(BN254_FR, p, f2, kshift))
