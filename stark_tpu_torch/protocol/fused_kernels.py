"""The prover's elementwise protocol stages, one CUDA launch each.

Counterpart of `stark_tpu/protocol/pallas_kernels.py` for its kernels
`rand_combination` (`:98`), `q1_eval` (`:118`), `q2_eval` (`:137`),
`q3_eval` (`:154`), `linear_combination` (`:190`), `horner_eval` (`:214`),
`vanishing_eval` (`:236`), `shoup_mul_periodic` (`:268`),
`linear_combination_shoup` (`:319`), `sub_mul` (`:353`),
`from_mont_pack_words` (`:373`), `fri_fold_pre` (`:433`) and `fri_fold_post`
(`:478`), with the same signatures but for the fold pair, which passes the
x in place of the TPU pair's (16, 16, q) cubics. `vanishing_coeffs` is the
pre-pass of `vanishing_eval`: each span of points' monic product.
`fri_fold_dft` is the port's own: a whole round of FRI's default fold
route, special_x included, where the JAX package has XLA glue
(`stark_tpu/fri/fri.py:121 _fold_j`). The kernels are `csrc/protocol.cu`
and, for FRI's folds, `csrc/fri.cu`; each header says what bounds its
kernels on an H100 and what the design does about it.

Every wrapper takes contiguous (16, n) int32 Montgomery planes on one device
(`field_cuda.check_planes` refuses anything else, views included: the
callers in `protocol/kernels.py` make their operands contiguous); the fold
kernels take contiguous (16, 4, q) arrays. On a CUDA tensor it launches its
kernel or raises; on a CPU tensor it runs the `*_plain` function beside
it. Nothing else chooses: no size gate, no environment variable, no
fallback on error.

The `*_plain` functions are the compositions the JAX package runs when its
Pallas kernels are off (`stark_tpu/protocol/kernels.py`), in plain PyTorch
throughout: `mmul_plain`, `madd`, `msub`, `torch.roll`. The plain versions
of the two Shoup kernels turn the pattern's plain constants into a
Montgomery table and multiply by it, without the companions. They also hold
the kernels to account on the card.
"""

from __future__ import annotations

import ctypes

import torch

from stark_tpu_torch.fields.field import FieldSpec, int_to_limbs
from stark_tpu_torch.ops import build
from stark_tpu_torch.ops import field_cuda as fc
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol import device_transcript as dt


def _mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain Montgomery product of broadcastable (16, n) / (16, 1) planes."""
    a, b = torch.broadcast_tensors(a, b)
    return fc.mmul_plain(spec, a.contiguous(), b.contiguous())


def _check(spec: FieldSpec, planes, small=()) -> None:
    """Same-shape contiguous planes and contiguous small (16, k) operands on
    one device."""
    fc.check_planes(spec, *planes, *small)
    for t in planes:
        if t.shape != planes[0].shape:
            raise ValueError(
                f"operands must share the domain width: {[tuple(x.shape) for x in planes]}"
            )


def _launch(wrapper, spec: FieldSpec, like: torch.Tensor, call) -> None:
    """Run `call(lib, field words, n', stream)` for one kernel launch on
    `like`'s device and count it."""
    words, np32, stream = fc.cuda_args(spec, like)
    build.check(call(build.load(), words, np32, stream), wrapper.__name__)
    wrapper.launches += 1


# --- rand_combination: nmr/dnm = r0 + r1*idx|perm + r2*S -------------------


def rand_combination_plain(spec, r_mont, idx_ev, perm_ev, s_ev):
    r0, r1, r2 = r_mont[:, 0:1], r_mont[:, 1:2], r_mont[:, 2:3]
    r2s = _mul(spec, r2, s_ev)
    nmr = mm.madd(spec, r0, mm.madd(spec, _mul(spec, r1, idx_ev), r2s))
    dnm = mm.madd(spec, r0, mm.madd(spec, _mul(spec, r1, perm_ev), r2s))
    return nmr, dnm


def rand_combination(spec: FieldSpec, r_mont, idx_ev, perm_ev, s_ev):
    """r_mont: (16, 3) -> (val_nmr, val_dnm), each (16, n)."""
    _check(spec, (idx_ev, perm_ev, s_ev), (r_mont,))
    if r_mont.shape[1] != 3:
        raise ValueError(f"r_mont must be (16, 3), got {tuple(r_mont.shape)}")
    if s_ev.device.type == "cpu":
        return rand_combination_plain(spec, r_mont, idx_ev, perm_ev, s_ev)
    nmr, dnm = torch.empty_like(s_ev), torch.empty_like(s_ev)
    _launch(rand_combination, spec, s_ev, lambda lib, w, np32, st: lib.stark_rand_combination(
        r_mont.data_ptr(), idx_ev.data_ptr(), perm_ev.data_ptr(), s_ev.data_ptr(),
        nmr.data_ptr(), dnm.data_ptr(), s_ev.shape[1], w, np32, st))
    return nmr, dnm


# --- Q1 = F0*(P - F1*P_prev - K*S), P_prev = roll(P, skips) ----------------


def q1_eval_plain(spec, s_ev, k_ev, p_ev, f0_ev, f1_ev, skips: int):
    p_prev = torch.roll(p_ev, skips, dims=1)
    inner = mm.madd(spec, _mul(spec, f1_ev, p_prev), _mul(spec, k_ev, s_ev))
    return _mul(spec, f0_ev, mm.msub(spec, p_ev, inner))


def q1_eval(spec: FieldSpec, s_ev, k_ev, p_ev, f0_ev, f1_ev, skips: int):
    _check(spec, (s_ev, k_ev, p_ev, f0_ev, f1_ev))
    if s_ev.device.type == "cpu":
        return q1_eval_plain(spec, s_ev, k_ev, p_ev, f0_ev, f1_ev, skips)
    n = s_ev.shape[1]
    out = torch.empty_like(s_ev)
    _launch(q1_eval, spec, s_ev, lambda lib, w, np32, st: lib.stark_q1_eval(
        s_ev.data_ptr(), k_ev.data_ptr(), p_ev.data_ptr(), f0_ev.data_ptr(),
        f1_ev.data_ptr(), out.data_ptr(), n, skips % max(n, 1), w, np32, st))
    return out


# --- Q2 = F2*(P(+2k) - P*P(+k)) ---------------------------------------------


def q2_eval_plain(spec, p_ev, f2_ev, kshift: int):
    p_k = torch.roll(p_ev, -kshift, dims=1)
    p_2k = torch.roll(p_ev, -2 * kshift, dims=1)
    return _mul(spec, f2_ev, mm.msub(spec, p_2k, _mul(spec, p_ev, p_k)))


def q2_plan(n: int, kshift: int) -> tuple[int, int, int]:
    """The order in which `q2_eval`'s kernel takes the outputs, one a
    thread: (k1, k2, span), k1 and k2 the shifts kshift and 2*kshift mod n.
    Where 0 < k1 and 3*k1 <= n, span = k1 and the outputs [0, 3*span) go in
    slices of three warps: warp j of slice s takes g + j*k1 for its lane's
    g = 32*s + lane < span. The slice then reads P at g .. g + 4*k1, each
    line from two or three of its warps at once; the prover's shift makes
    3*k1 = n - 8*(steps mod 3), so g + 3*k1 and g + 4*k1 are g and g + k1 a
    few elements back, read by the slice before. The other outputs (from
    3*span on; all of them when span = 0) take one thread each in order."""
    if n <= 0:
        return 0, 0, 0
    k1 = kshift % n
    return k1, 2 * kshift % n, k1 if 0 < k1 and 3 * k1 <= n else 0


def q2_eval(spec: FieldSpec, p_ev, f2_ev, kshift: int):
    _check(spec, (p_ev, f2_ev))
    if p_ev.device.type == "cpu":
        return q2_eval_plain(spec, p_ev, f2_ev, kshift)
    n = p_ev.shape[1]
    out = torch.empty_like(p_ev)
    k1, k2, span = q2_plan(n, kshift)
    _launch(q2_eval, spec, p_ev, lambda lib, w, np32, st: lib.stark_q2_eval(
        p_ev.data_ptr(), f2_ev.data_ptr(), out.data_ptr(), n, k1, k2, span, w, np32, st))
    return out


# --- Q3 = A*dnm - A_prev*nmr, A_prev = roll(A, skips) -----------------------


def q3_eval_plain(spec, a_ev, val_nmr_big, val_dnm_big, skips: int):
    a_prev = torch.roll(a_ev, skips, dims=1)
    return mm.msub(spec, _mul(spec, a_ev, val_dnm_big), _mul(spec, a_prev, val_nmr_big))


def q3_eval(spec: FieldSpec, a_ev, val_nmr_big, val_dnm_big, skips: int):
    _check(spec, (a_ev, val_nmr_big, val_dnm_big))
    if a_ev.device.type == "cpu":
        return q3_eval_plain(spec, a_ev, val_nmr_big, val_dnm_big, skips)
    n = a_ev.shape[1]
    out = torch.empty_like(a_ev)
    _launch(q3_eval, spec, a_ev, lambda lib, w, np32, st: lib.stark_q3_eval(
        a_ev.data_ptr(), val_nmr_big.data_ptr(), val_dnm_big.data_ptr(),
        out.data_ptr(), n, skips % max(n, 1), w, np32, st))
    return out


# --- the linear combination L -----------------------------------------------


def linear_combination_plain(spec, k_mont, x_to_steps, p_ev, a_ev, s_ev,
                             d1, d2, d3, b2, b3):
    mulx = lambda col: _mul(spec, col, x_to_steps)  # noqa: E731
    terms = (d1, d2, d3, p_ev, mulx(p_ev), b2, mulx(b2), b3, mulx(b3), a_ev, s_ev)
    out = None
    for j, term in enumerate(terms):
        t = _mul(spec, k_mont[:, j : j + 1], term)
        out = t if out is None else mm.madd(spec, out, t)
    return out


def linear_combination(spec: FieldSpec, k_mont, x_to_steps, p_ev, a_ev, s_ev,
                       d1, d2, d3, b2, b3):
    """L = k0*D1 + k1*D2 + k2*D3 + k3*P + k4*P*x^steps + k5*B2
    + k6*B2*x^steps + k7*B3 + k8*B3*x^steps + k9*A + k10*S with the full
    (16, n) x^steps table; k_mont: (16, 11)."""
    cols = (x_to_steps, p_ev, a_ev, s_ev, d1, d2, d3, b2, b3)
    _check(spec, cols, (k_mont,))
    if k_mont.shape[1] != 11:
        raise ValueError(f"k_mont must be (16, 11), got {tuple(k_mont.shape)}")
    if s_ev.device.type == "cpu":
        return linear_combination_plain(spec, k_mont, *cols)
    out = torch.empty_like(s_ev)
    ptrs = (ctypes.c_void_p * 9)(*[c.data_ptr() for c in cols])
    _launch(linear_combination, spec, s_ev,
            lambda lib, w, np32, st: lib.stark_linear_combination(
                k_mont.data_ptr(), ptrs, out.data_ptr(), s_ev.shape[1], w, np32, st))
    return out


# --- periodic plain constants in Shoup form ---------------------------------


def _pattern_table(spec: FieldSpec, w_pat: torch.Tensor, n: int) -> torch.Tensor:
    """The (16, t) plain constants as a (16, n) Montgomery table, repeated."""
    r2 = torch.tensor(int_to_limbs(spec.r2_mod_p, spec.num_limbs), dtype=torch.int32,
                      device=w_pat.device).reshape(-1, 1)
    return _mul(spec, w_pat, r2).repeat(1, n // w_pat.shape[1])


def _check_pattern(w_pat, wp_pat, n: int) -> None:
    t = w_pat.shape[1]
    if wp_pat.shape != w_pat.shape or t < 1 or n % t:
        raise ValueError(
            f"a Shoup pattern pair must be two (16, t) planes with t dividing "
            f"{n}, got {tuple(w_pat.shape)} and {tuple(wp_pat.shape)}"
        )


def shoup_mul_periodic_plain(spec, w_pat, wp_pat, x):
    return _mul(spec, x, _pattern_table(spec, w_pat, x.shape[1]))


def shoup_mul_periodic(spec: FieldSpec, w_pat, wp_pat, x):
    """x[i] * w[i mod t] for Montgomery x and the (16, t) pattern pair of
    `modmath.shoup_consts` (plain constants and their companions), t
    dividing n; canonical output."""
    _check(spec, (x,), (w_pat, wp_pat))
    _check_pattern(w_pat, wp_pat, x.shape[1])
    if x.device.type == "cpu":
        return shoup_mul_periodic_plain(spec, w_pat, wp_pat, x)
    out = torch.empty_like(x)
    _launch(shoup_mul_periodic, spec, x, lambda lib, w, np32, st: lib.stark_shoup_mul_periodic(
        w_pat.data_ptr(), wp_pat.data_ptr(), w_pat.shape[1], x.data_ptr(),
        out.data_ptr(), x.shape[1], w, np32, st))
    return out


def linear_combination_shoup_plain(spec, k_mont, xw_pat, xwp_pat, p_ev, a_ev, s_ev,
                                   d1, d2, d3, b2, b3):
    x_to_steps = _pattern_table(spec, xw_pat, s_ev.shape[1])
    return linear_combination_plain(spec, k_mont, x_to_steps, p_ev, a_ev, s_ev,
                                    d1, d2, d3, b2, b3)


def linear_combination_shoup(spec: FieldSpec, k_mont, xw_pat, xwp_pat, p_ev, a_ev,
                             s_ev, d1, d2, d3, b2, b3):
    """`linear_combination` with x^steps as a (16, t) Shoup pattern pair
    instead of the (16, n) table."""
    cols = (p_ev, a_ev, s_ev, d1, d2, d3, b2, b3)
    _check(spec, cols, (k_mont, xw_pat, xwp_pat))
    _check_pattern(xw_pat, xwp_pat, s_ev.shape[1])
    if k_mont.shape[1] != 11:
        raise ValueError(f"k_mont must be (16, 11), got {tuple(k_mont.shape)}")
    if s_ev.device.type == "cpu":
        return linear_combination_shoup_plain(spec, k_mont, xw_pat, xwp_pat, *cols)
    out = torch.empty_like(s_ev)
    ptrs = (ctypes.c_void_p * 8)(*[c.data_ptr() for c in cols])
    _launch(linear_combination_shoup, spec, s_ev,
            lambda lib, w, np32, st: lib.stark_linear_combination_shoup(
                k_mont.data_ptr(), xw_pat.data_ptr(), xwp_pat.data_ptr(),
                xw_pat.shape[1], ptrs, out.data_ptr(), s_ev.shape[1], w, np32, st))
    return out


# --- boundary helpers: groups of G terms, each summed wide, reduced once ----
#
# Both kernels evaluate at each x in groups of G terms (`csrc/protocol.cu`):
# Horner's rule in x^G, over the coefficients, and over each span of SPAN
# points' monic product (`vanishing_coeffs`), whose values are multiplied.
# GROUPS are the builds of G; a call takes the cheapest build that the
# field's bound allows, by the cost model below.

GROUPS = (1, 2, 4, 8)
SPAN = 32  # points a span of the vanishing product covers: a warp a span
# SM clocks a thread at full occupancy on an H100 80GB HBM3 at 700 W
# (scripts/horner_kernels_cuda.py): a CIOS product, a wide product, a
# group's reduction (REDC and the subtractions of 4p, 2p, p), a modular
# subtraction
_COST = {"cios": 7.4, "wide": 2.8, "redc": 4.8, "sub": 0.5}
# the pre-pass's device time on the same card, microseconds: a launch, a
# step (one product's latency: it runs a warp a span), and each span but the
# first; and the card's SM clocks in a microsecond (132 SMs at 1,980 MHz),
# to spread that time over the main kernel's elements
_PREPASS_US = {"launch": 5.0, "step": 0.95, "span": 0.45}
_CARD_CLOCKS_PER_US = 132 * 1980


def group_fits(spec: FieldSpec, g: int, lead: bool = False) -> bool:
    """Whether a group of g terms keeps the kernels' wide sum in bounds on
    this field: with every operand p - 1 and the reduction's multiple of p
    at its largest, T = (W + (2^256 - 1) p) / 2^256 < 8p, which the three
    subtractions (4p, 2p, p) make canonical. W: g products below p^2 (the
    accumulator by x^G, g - 1 coefficients) and one coefficient times
    2^256; with `lead`, a group holding a monic polynomial's leading 1: g - 1
    products and two values times 2^256."""
    p, r = spec.p, 1 << 256
    if lead:
        w = (g - 1) * (p - 1) ** 2 + 2 * (p - 1) * r
    else:
        w = g * (p - 1) ** 2 + (p - 1) * r
    return (w + (r - 1) * p) // r < 8 * p


def horner_ops(d: int, g: int) -> dict:
    """What `horner_kernel<g>` does a thread for d coefficients: min(g, d - 1)
    - 1 CIOS products (the powers of x); for the highest group, of
    d - g*floor((d - 1)/g) coefficients, nothing (one) or that many less one
    wide products and a reduction; for each group below it g wide products
    and a reduction."""
    if d <= 1:
        return {"cios": 0, "wide": 0, "redc": 0, "sub": 0}
    top, full = d - (d - 1) // g * g, (d - 1) // g
    return {"cios": min(g, d - 1) - 1, "wide": full * g + top - 1,
            "redc": full + (top > 1), "sub": 0}


def vanishing_ops(npts: int, g: int) -> dict:
    """What `vanishing_kernel<g>` does a thread for npts points. g = 1: a
    subtraction a point and a CIOS product for each point but the first.
    g > 1: min(g, npts) - 1 CIOS products (the powers), one more for each
    span but the first; for each span of s points, t = s mod g and
    f = floor(s/g): a subtraction (t = 1) or t - 1 wide products and a
    reduction (t > 1) for its highest group, and f groups of g wide
    products (one fewer after a lone leading 1) and a reduction."""
    if g == 1:
        return {"cios": max(npts - 1, 0), "wide": 0, "redc": 0, "sub": npts}
    spans = [SPAN] * (npts // SPAN) + ([npts % SPAN] if npts % SPAN else [])
    ops = {"cios": max(min(g, npts) - 1 + len(spans) - 1, 0), "wide": 0, "redc": 0,
           "sub": 0}
    for s in spans:
        t, f = s % g, s // g
        ops["sub"] += t == 1
        ops["wide"] += (t - 1 if t > 1 else 0) + f * g - (t == 0)
        ops["redc"] += (t > 1) + f
    return ops


def prepass_cost(npts: int, n: int) -> float:
    """Modelled SM clocks a thread of `vanishing_kernel` that the pre-pass
    for npts points adds at n elements: its device time on the whole card,
    spread over the n."""
    spans = -(-npts // SPAN)
    us = (_PREPASS_US["launch"] + _PREPASS_US["step"] * (min(npts, SPAN) - 1)
          + _PREPASS_US["span"] * (spans - 1))
    return us * _CARD_CLOCKS_PER_US / max(n, 1)


def ops_cost(ops: dict) -> float:
    """Modelled SM clocks a thread of a count from `horner_ops` or
    `vanishing_ops`."""
    return sum(_COST[k] * v for k, v in ops.items())


def horner_group(spec: FieldSpec, d: int) -> int:
    """The build of `horner_kernel` for d coefficients: the cheapest by the
    cost model within the field's bound, the smallest on a tie."""
    return min((g for g in GROUPS if group_fits(spec, g)),
               key=lambda g: ops_cost(horner_ops(d, g)))


def vanishing_group(spec: FieldSpec, npts: int, n: int) -> int:
    """The build of `vanishing_kernel` for npts points at n elements, as
    `horner_group` (its groups take both forms of `group_fits`), the
    pre-pass that every build but G = 1 runs counted in."""
    return min((g for g in GROUPS if group_fits(spec, g) and group_fits(spec, g, lead=True)),
               key=lambda g: ops_cost(vanishing_ops(npts, g))
               + (prepass_cost(npts, n) if g > 1 and npts else 0.0))


def horner_eval_plain(spec, coeffs_mont, xs_full):
    out = torch.zeros_like(xs_full)
    for i in range(coeffs_mont.shape[1] - 1, -1, -1):
        out = mm.madd(spec, _mul(spec, out, xs_full), coeffs_mont[:, i : i + 1])
    return out


def horner_eval(spec: FieldSpec, coeffs_mont, xs_full):
    """A polynomial, coefficients (16, d) low to high, at every x of the
    domain; d is a run-time bound."""
    _check(spec, (xs_full,), (coeffs_mont,))
    if xs_full.device.type == "cpu":
        return horner_eval_plain(spec, coeffs_mont, xs_full)
    d = coeffs_mont.shape[1]
    g = horner_group(spec, d)
    out = torch.empty_like(xs_full)
    _launch(horner_eval, spec, xs_full, lambda lib, w, np32, st: lib.stark_horner_eval(
        coeffs_mont.data_ptr(), d, g, xs_full.data_ptr(), out.data_ptr(),
        xs_full.shape[1], w, np32, st))
    return out


def vanishing_coeffs_plain(spec, points_mont):
    """Each span's coefficients as the kernel's warp forms them, every span
    at once: lane j of a span holds c_j, from x - q_0 (c_1 = 1, the rest
    0); multiplying in x - q_k, c_j <- c_(j-1) - q_k*c_j (c_(-1) = 0), for
    the spans that have a point k."""
    L, npts = points_mont.shape
    spans = -(-npts // SPAN)
    q = torch.zeros((L, spans * SPAN), dtype=points_mont.dtype, device=points_mont.device)
    q[:, :npts] = points_mont
    q = q.reshape(L, spans, SPAN)
    sizes = torch.full((spans,), SPAN, device=q.device)
    sizes[-1:] = npts - (spans - 1) * SPAN
    c = torch.zeros_like(q)
    c[:, :, 0] = mm.msub(spec, torch.zeros_like(q[:, :, 0]), q[:, :, 0])
    c[:, :, 1:2] = mm.mont_one(spec, q.device)[:, :, None]
    for k in range(1, min(npts, SPAN)):
        below = torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]], dim=2)
        prod = _mul(spec, q[:, :, k : k + 1].expand_as(c).reshape(L, -1), c.reshape(L, -1))
        step = mm.msub(spec, below.reshape(L, -1), prod).reshape(c.shape)
        c = torch.where((sizes > k)[None, :, None], step, c)
    return c.reshape(L, -1)[:, :npts].contiguous()


def vanishing_coeffs(spec: FieldSpec, points_mont):
    """(16, npts) points -> (16, npts) coefficients of each span of SPAN
    points' monic product (the last span short): column SPAN*i + j holds e_j
    of span i, prod_k (x - q_k) = x^s + sum_(j<s) e_j x^j."""
    _check(spec, (points_mont,))
    if points_mont.device.type == "cpu":
        return vanishing_coeffs_plain(spec, points_mont)
    out = torch.empty_like(points_mont)
    _launch(vanishing_coeffs, spec, points_mont,
            lambda lib, w, np32, st: lib.stark_vanishing_coeffs(
                points_mont.data_ptr(), points_mont.shape[1], out.data_ptr(), w, np32, st))
    return out


def vanishing_eval_plain(spec, xs_full, points_mont):
    acc = mm.mont_one(spec, xs_full.device).expand(xs_full.shape)
    for i in range(points_mont.shape[1]):
        acc = _mul(spec, acc, mm.msub(spec, xs_full, points_mont[:, i : i + 1]))
    return acc.contiguous()


def vanishing_eval(spec: FieldSpec, xs_full, points_mont):
    """Zb(x) = prod_i (x - x_i) at every x; points_mont: (16, n_points)."""
    _check(spec, (xs_full,), (points_mont,))
    if xs_full.device.type == "cpu":
        return vanishing_eval_plain(spec, xs_full, points_mont)
    npts = points_mont.shape[1]
    g = vanishing_group(spec, npts, xs_full.shape[1])
    es = points_mont if g == 1 else vanishing_coeffs(spec, points_mont)
    out = torch.empty_like(xs_full)
    _launch(vanishing_eval, spec, xs_full,
            lambda lib, w, np32, st: lib.stark_vanishing_eval(
                es.data_ptr(), npts, g, xs_full.data_ptr(), out.data_ptr(),
                xs_full.shape[1], w, np32, st))
    return out


# --- (a - b) * c -------------------------------------------------------------


def sub_mul_plain(spec, a, b, c):
    return _mul(spec, mm.msub(spec, a, b), c)


def sub_mul(spec: FieldSpec, a, b, c):
    """(a - b)*c elementwise; b is a (16, n) plane or one (16, 1) column
    subtracted from every element."""
    b_is_col = b.dim() == 2 and b.shape[1] == 1 and a.shape[1] != 1
    _check(spec, (a, c) if b_is_col else (a, b, c), (b,) if b_is_col else ())
    if a.device.type == "cpu":
        return sub_mul_plain(spec, a, b, c)
    out = torch.empty_like(a)
    _launch(sub_mul, spec, a, lambda lib, w, np32, st: lib.stark_sub_mul(
        a.data_ptr(), b.data_ptr(), int(b_is_col), c.data_ptr(), out.data_ptr(),
        a.shape[1], w, np32, st))
    return out


# --- from_mont + word packing for Merkle leaves -------------------------------


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values < 2^32 -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def from_mont_pack_words_plain(spec, col):
    one = torch.zeros((spec.num_limbs, 1), dtype=torch.int32, device=col.device)
    one[0] = 1
    canon = _mul(spec, col, one).to(torch.int64)
    return _i32(canon[0::2] | (canon[1::2] << 16))


def from_mont_pack_words(spec: FieldSpec, col, out=None):
    """(16, n) Montgomery -> (8, n) int32 holding the little-endian uint32
    words of the canonical 32-byte encodings. `out` may name 8 whole rows of
    a contiguous (W, n) leaf buffer to be filled in place."""
    _check(spec, (col,))
    n = col.shape[1]
    if out is None:
        out = torch.empty((spec.num_limbs // 2, n), dtype=torch.int32, device=col.device)
    elif (out.shape != (spec.num_limbs // 2, n) or out.dtype != torch.int32
          or not out.is_contiguous() or out.device != col.device):
        raise ValueError("out must be a contiguous (8, n) int32 tensor on col's device")
    if col.device.type == "cpu":
        out.copy_(from_mont_pack_words_plain(spec, col))
        return out
    _launch(from_mont_pack_words, spec, col,
            lambda lib, w, np32, st: lib.stark_from_mont_pack_words(
                col.data_ptr(), out.data_ptr(), n, w, np32, st))
    return out


# --- FRI's Lagrange fold: two kernels around the shared batched inversion -----
#
# A round's n = 4q points as (16, 4, q) planes: member j of row i at
# [:, j, i], the view `xs.reshape(16, 4, q)` of the flat (16, n) plane.

# for member j of a row, the other three
_OTHERS = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


def _check_rows(spec: FieldSpec, like: torch.Tensor, **arrays) -> None:
    """`name=(tensor, rows)`: each a contiguous int32 (16, rows, q) array on
    `like`'s device, with `like`'s q."""
    for name, (t, rows) in arrays.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
        want = (spec.num_limbs, rows, like.shape[-1])
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != like.device:
            raise ValueError("limb planes must share one device")


def fri_fold_pre_plain(spec, xs4):
    x = [xs4[:, j] for j in range(4)]
    dens = torch.empty_like(xs4)
    for j, (a, b, c) in enumerate(_OTHERS):
        da, db, dc = (mm.msub(spec, x[j], x[m]) for m in (a, b, c))
        dens[:, j] = _mul(spec, _mul(spec, da, db), dc)
    return dens


def fri_fold_pre(spec: FieldSpec, xs4):
    """xs4: (16, 4, q), the four x of each row -> dens (16, 4, q), the
    Lagrange denominators dens[:, j] = prod_(m != j) (x_j - x_m)."""
    _check_rows(spec, xs4, xs4=(xs4, 4))
    if xs4.device.type == "cpu":
        return fri_fold_pre_plain(spec, xs4)
    q = xs4.shape[2]
    dens = torch.empty_like(xs4)
    _launch(fri_fold_pre, spec, xs4, lambda lib, w, np32, st: lib.stark_fri_fold_pre(
        xs4.data_ptr(), dens.data_ptr(), q, w, np32, st))
    return dens


def fri_fold_post_plain(spec, sx, xs4, ys4, invs):
    d = [mm.msub(spec, sx, xs4[:, m]) for m in range(4)]
    out = None
    for j, (a, b, c) in enumerate(_OTHERS):
        w = _mul(spec, ys4[:, j], invs[:, j])
        term = _mul(spec, w, _mul(spec, _mul(spec, d[a], d[b]), d[c]))
        out = term if out is None else mm.madd(spec, out, term)
    return out


def fri_fold_post(spec: FieldSpec, sx, xs4, ys4, invs):
    """The folded column (16, q): each row's interpolant through its four
    points (xs4[:, j], ys4[:, j]) at the one (16, 1) point sx,
    sum_j ys4[:, j] * invs[:, j] * prod_(m != j) (sx - xs4[:, m]), with invs
    the inverted denominators of `fri_fold_pre`."""
    _check_rows(spec, ys4, ys4=(ys4, 4), xs4=(xs4, 4), invs=(invs, 4))
    fc.check_planes(spec, sx)
    if sx.shape[1] != 1 or sx.device != ys4.device:
        raise ValueError(f"sx must be (16, 1) on ys4's device, got {tuple(sx.shape)}")
    if ys4.device.type == "cpu":
        return fri_fold_post_plain(spec, sx, xs4, ys4, invs)
    q = ys4.shape[2]
    out = torch.empty((spec.num_limbs, q), dtype=torch.int32, device=ys4.device)
    _launch(fri_fold_post, spec, ys4, lambda lib, w, np32, st: lib.stark_fri_fold_post(
        sx.data_ptr(), xs4.data_ptr(), ys4.data_ptr(), invs.data_ptr(),
        out.data_ptr(), q, w, np32, st))
    return out


# --- FRI's fold on its radix-4 inverse-DFT route, special_x included ----------


def fri_fold_dft_plain(spec, root_words, values, xs):
    n = values.shape[1]
    xs = xs[:, :: xs.shape[1] // n]
    sx = dt.digest_le_int_mont(spec, root_words)
    quarter = n // 4
    v0, v1, v2, v3 = (values[:, j * quarter : (j + 1) * quarter] for j in range(4))
    i_root = xs[:, quarter : quarter + 1]  # I = g^(n/4)
    a = mm.madd(spec, v0, v2)
    b = mm.madd(spec, v1, v3)
    c = mm.msub(spec, v0, v2)
    e = mm.mmul(spec, i_root, mm.msub(spec, v3, v1))
    u0 = mm.madd(spec, a, b)
    u2 = mm.msub(spec, a, b)
    u1 = mm.madd(spec, c, e)
    u3 = mm.msub(spec, c, e)
    xinv = torch.cat([xs[:, :1], xs[:, n - quarter + 1 :].flip(1)], dim=1)
    t = mm.mmul(spec, sx, xinv)
    acc = mm.madd(spec, mm.mmul(spec, u3, t), u2)
    acc = mm.madd(spec, mm.mmul(spec, acc, t), u1)
    acc = mm.madd(spec, mm.mmul(spec, acc, t), u0)
    inv4 = mm.mont_const(spec, pow(4, spec.p - 2, spec.p), values.device)
    return mm.mmul(spec, inv4, acc)


def _r2_words(spec: FieldSpec):
    """R^2 mod p as the kernel's 8 little-endian uint32 words."""
    return (ctypes.c_uint32 * 8)(*((spec.r2_mod_p >> (32 * k)) & 0xFFFFFFFF for k in range(8)))


def fri_fold_dft(spec: FieldSpec, root_words, values, xs):
    """One round of FRI's 4x fold, the folded column (16, n/4), at special_x,
    the previous tree's root: `root_words` (8,) int32, read as a
    little-endian integer mod p (`device_transcript.digest_le_int_mont`).
    values (16, n) holds the round's evaluations; xs (16, m), m a multiple
    of n, is a power table whose every (m/n)-th point is the round's
    domain: the whole domain's table serves every round. Row i of the
    column interpolates the values at the four points x_j = xs-point
    j*n/4 + i, a coset of the 4th roots of unity, by the radix-4 inverse
    DFT: (1/4) sum_k u_k t^k with u_k = sum_j v_j I^(-jk), I = g^(n/4),
    t = special_x x_0^-1, x_0^-1 = the point (n - i) mod n."""
    fc.check_planes(spec, values, xs)
    n = values.shape[1]
    if n % 4 or n == 0 or xs.shape[1] % n:
        raise ValueError(f"values must be (16, n) with 4 | n and xs (16, k*n), got "
                         f"{tuple(values.shape)} and {tuple(xs.shape)}")
    if root_words.dtype != torch.int32:
        raise TypeError(f"root_words must be torch.int32, got {root_words.dtype}")
    if tuple(root_words.shape) != (8,) or not root_words.is_contiguous():
        raise ValueError(f"root_words must be contiguous (8,), got {tuple(root_words.shape)}")
    if root_words.device != values.device:
        raise ValueError("root_words must lie on the planes' device")
    if values.device.type == "cpu":
        return fri_fold_dft_plain(spec, root_words, values, xs)
    out = torch.empty((spec.num_limbs, n // 4), dtype=torch.int32, device=values.device)
    _launch(fri_fold_dft, spec, values, lambda lib, w, np32, st: lib.stark_fri_fold_dft(
        root_words.data_ptr(), values.data_ptr(), xs.data_ptr(), out.data_ptr(), n // 4,
        xs.shape[1] // n, w, _r2_words(spec), np32, st))
    return out


for _wrapper in (rand_combination, q1_eval, q2_eval, q3_eval, linear_combination,
                 shoup_mul_periodic, linear_combination_shoup, horner_eval,
                 vanishing_coeffs, vanishing_eval, sub_mul, from_mont_pack_words,
                 fri_fold_pre, fri_fold_post, fri_fold_dft):
    _wrapper.launches = 0
