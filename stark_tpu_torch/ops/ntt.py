"""Radix-2 NTT and the low-degree extension over (16, n) limb planes.

Counterpart of `stark_tpu/ops/ntt.py` on its Pallas plan (`NttPlan`
`:231-262`, `_run_pallas :304-330`, `lde :522-555`), on every device:
per-stage twiddle tables tw_k = root^(k*m) (k < l) shared by both
directions; the stages with 2l > block (the plan's `singles`, which the TPU
runs one at a time) run in passes of up to `PASS_STAGES` consecutive
stages through `butterfly_pass`, the run of stages with 2l <= block in one
`butterfly_fused` pass. Neither split changes a value: `block` is a plan
argument, and a pass equals its stages run one by one.

The butterfly wrappers launch `csrc/ntt.cu` on a CUDA tensor (replacing
`stark_tpu/ops/pallas_field.py:446 butterfly_stage`, as the single stage
and as the multi-stage pass, and `:518 butterfly_fused`) and run their
plain PyTorch versions on a CPU tensor.
`make_best_lde` picks the LDE engine by name: these butterflies, or the CRT
matrix-product engine of `ops/mxu_ntt.py`.

A plan built with `shoup=True` is the JAX package's Shoup-twiddle form
(`NttPlan.shoup`, which its `STARK_TPU_SHOUP` turns on; `_shoup_stage_tables
:74-103`, `_run_pallas :304-330`): plain twiddles w with their companions
floor(w 2^256 / p) (`shoup_stage_tables`), values lazy in [0, 2p) between
stages (`_butterfly_pair_shoup`, `pallas_field.py:407`), and a DIT plan's
last stage canonical. Its passes run `butterfly_pass_shoup` and
`butterfly_fused_shoup`, the Shoup forms of the TPU's `butterfly_stage`
and `butterfly_fused` bodies (`pallas_field.py:427 _single_stage_kernel`,
`:483 _fused_kernel` with `shoup=True`). The product's quotient is exact
(`csrc/field.cuh shoup_mul`), where the TPU's drops the partial product's
low columns and may come out one short, which its extra subtraction of 2p
absorbs; and a lazy sum keeps its carry out of bit 256, which the TPU's
drops. So every canonical value is the JAX package's, a lazy value may
differ from it by p, and the form needs only 2p < 2^256 (BLS12-381's scalar
field too, where the TPU's lazy sums overflow). Nothing above this module
builds a Shoup plan: the prover's default is the JAX package's.
"""

from __future__ import annotations

import torch

from stark_tpu_torch.fields.field import FieldSpec, int_to_limbs
from stark_tpu_torch.ops import build
from stark_tpu_torch.ops import field_cuda as fc
from stark_tpu_torch.ops import modmath as mm

# Elements a fused pass keeps together: the TPU kernel's block, 2 * TILE =
# 2048, is also the largest the CUDA kernel takes (a pair of CTAs shares a
# block, each with 64 KB of exchange buffers and 32 KB of twiddles, two CTAs
# an SM).
FUSED_BLOCK = 2048
# Outer stages a `butterfly_pass` runs at most: groups of 2^3 elements, each
# read and written once
PASS_STAGES = 3

_KINDS = ("dif", "dit")


# ---------------------------------------------------------------------------
# butterfly stages: plain versions and kernel wrappers
# ---------------------------------------------------------------------------


def butterfly_stage_plain(spec: FieldSpec, a, tw, m: int, l: int, kind: str):
    """One stage on flat (L, n) `a` viewed as (L, m, 2, l); tw: (L, l).
    dif: y0 = u + v, y1 = (u - v) * tw;  dit: t = v * tw, y0 = u + t,
    y1 = u - t."""
    L, n = a.shape
    v4 = a.reshape(L, m, 2, l)
    u, v = v4[:, :, 0], v4[:, :, 1]
    w = tw.reshape(L, 1, l).expand(L, m, l)
    if kind == "dif":
        y0 = mm.madd(spec, u, v)
        y1 = fc.mmul_plain(spec, mm.msub(spec, u, v), w.contiguous())
    else:
        t = fc.mmul_plain(spec, v.contiguous(), w.contiguous())
        y0 = mm.madd(spec, u, t)
        y1 = mm.msub(spec, u, t)
    return torch.stack([y0, y1], dim=2).reshape(L, n)


def fused_ls(block: int, kind: str) -> list[int]:
    """The stage widths of the fused run, in execution order."""
    ls = [1 << s for s in range(block.bit_length() - 1)]
    return ls if kind == "dit" else ls[::-1]


def butterfly_fused_plain(spec: FieldSpec, a, tw_cat, block: int, kind: str):
    """Every stage with 2l <= block, in order (dit: l ascending, dif: l
    descending). tw_cat: (L, block - 1), stage l's table at columns
    l-1 .. 2l-2. Groups of 2l never cross a block, so each stage is the
    whole-array stage."""
    n = a.shape[1]
    for l in fused_ls(block, kind):
        a = butterfly_stage_plain(
            spec, a, tw_cat[:, l - 1 : 2 * l - 1], n // (2 * l), l, kind
        )
    return a


def _check_kind(kind: str):
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")


def butterfly_stage(spec: FieldSpec, a, tw, m: int, l: int, kind: str):
    """One radix-2 stage (see `butterfly_stage_plain`) on a (16, n) plane."""
    _check_kind(kind)
    fc.check_planes(spec, a, tw)
    if a.shape[1] != 2 * m * l or tw.shape[1] != l:
        raise ValueError(
            f"stage shapes: a {tuple(a.shape)}, tw {tuple(tw.shape)}, m={m}, l={l}"
        )
    if a.device.type == "cpu":
        return butterfly_stage_plain(spec, a, tw, m, l, kind)
    words, np32, stream = fc.cuda_args(spec, a)
    out = torch.empty_like(a)
    rc = build.load().stark_butterfly_stage(
        a.data_ptr(), tw.data_ptr(), out.data_ptr(), a.shape[1], l,
        int(kind == "dit"), words, np32, stream,
    )
    build.check(rc, "butterfly_stage")
    butterfly_stage.launches += 1
    return out


butterfly_stage.launches = 0


def fused_lazy(spec: FieldSpec) -> bool:
    """Which build of `csrc/ntt.cu`'s fused pass serves the field: the lazy
    one (Harvey's butterflies, values below 4p) iff 5p < 2^256, as for
    BN254's scalar field; else the canonical one (every value below p), as
    for BLS12-381's."""
    return 5 * spec.p < 1 << 256


def butterfly_fused(spec: FieldSpec, a, tw_cat, block: int, kind: str):
    """The fused run of small stages (see `butterfly_fused_plain`). On a
    CUDA tensor block is at most `FUSED_BLOCK` and the field picks the
    kernel's build (`fused_lazy`); every field of `field_cuda.cuda_args`
    (16 limbs, 2p < 2^256) has one."""
    _check_kind(kind)
    fc.check_planes(spec, a, tw_cat)
    n = a.shape[1]
    if block < 2 or block & (block - 1) or n % block or tw_cat.shape[1] != block - 1:
        raise ValueError(
            f"fused shapes: a {tuple(a.shape)}, tw_cat {tuple(tw_cat.shape)}, "
            f"block={block}"
        )
    if a.device.type == "cpu":
        return butterfly_fused_plain(spec, a, tw_cat, block, kind)
    words, np32, stream = fc.cuda_args(spec, a)
    out = torch.empty_like(a)
    rc = build.load().stark_butterfly_fused(
        a.data_ptr(), tw_cat.data_ptr(), out.data_ptr(), n, block,
        int(kind == "dit"), int(fused_lazy(spec)), words, np32, stream,
    )
    build.check(rc, "butterfly_fused")
    butterfly_fused.launches += 1
    return out


butterfly_fused.launches = 0


def pass_ls(l0: int, r: int, kind: str) -> list[int]:
    """The stage widths of a pass of r stages from l0, in execution order."""
    ls = [l0 << s for s in range(r)]
    return ls if kind == "dit" else ls[::-1]


def pack_words(planes):
    """(16, k) limb planes -> (k, 8) packed words, element by element (the
    int32 bit patterns of limb 2i | limb 2i+1 << 16): the layout a pass
    reads its twiddles in, 32 bytes an element."""
    lo, hi = planes[0::2].to(torch.int64), planes[1::2].to(torch.int64)
    w = (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).t().contiguous()


def unpack_words(words):
    """Inverse of `pack_words`: (k, 8) -> (16, k)."""
    w = words.t().to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(-1, w.shape[1]).to(torch.int32)


def butterfly_pass_plain(spec: FieldSpec, a, tw_words, l0: int, r: int, kind: str):
    """r consecutive stages, l = l0 .. l0 2^(r-1) (dit ascending, dif
    descending), each a whole-array `butterfly_stage_plain`. tw_words:
    (l0 2^(r-1), 8), the largest stage's table as `pack_words`; stage l's
    table is its every (l0 2^(r-1) / l)-th element, since tw_l[k] =
    root^(k n / 2l) = tw_2l[2k]."""
    n = a.shape[1]
    tw = unpack_words(tw_words)
    top = l0 << (r - 1)
    for l in pass_ls(l0, r, kind):
        a = butterfly_stage_plain(
            spec, a, tw[:, :: top // l].contiguous(), n // (2 * l), l, kind
        )
    return a


def butterfly_pass(spec: FieldSpec, a, tw_words, l0: int, r: int, kind: str):
    """A pass of r <= `PASS_STAGES` outer stages (see
    `butterfly_pass_plain`) on a (16, n) plane. On a CUDA tensor each group
    of 2^r elements (stride l0) is read once, its r stages run in shared
    memory and it is written once; the field picks the kernel's build
    (`fused_lazy`), and the output is canonical."""
    _check_kind(kind)
    fc.check_planes(spec, a)
    n = a.shape[1]
    if (not 1 <= r <= PASS_STAGES or l0 < 1 or l0 & (l0 - 1) or n % (l0 << r)
            or tw_words.shape != (l0 << (r - 1), 8) or tw_words.dtype != torch.int32
            or not tw_words.is_contiguous() or tw_words.device != a.device):
        raise ValueError(
            f"pass shapes: a {tuple(a.shape)}, tw_words {tuple(tw_words.shape)} "
            f"{tw_words.dtype} on {tw_words.device}, l0={l0}, r={r}"
        )
    if a.device.type == "cpu":
        return butterfly_pass_plain(spec, a, tw_words, l0, r, kind)
    words, np32, stream = fc.cuda_args(spec, a)
    out = torch.empty_like(a)
    rc = build.load().stark_butterfly_pass(
        a.data_ptr(), tw_words.data_ptr(), out.data_ptr(), n, l0, r,
        int(kind == "dit"), int(fused_lazy(spec)), words, np32, stream,
    )
    build.check(rc, "butterfly_pass")
    butterfly_pass.launches += 1
    return out


butterfly_pass.launches = 0


# ---------------------------------------------------------------------------
# the Shoup-twiddle form: plain versions and kernel wrappers
# ---------------------------------------------------------------------------


def _less_2p(spec: FieldSpec, limbs, top):
    """value = top 2^256 + limbs (int64 16-bit limbs, value < 4p) -> value
    - 2p where value >= 2p, else value."""
    d, borrow = fc.normalize(limbs - fc._col(int_to_limbs(2 * spec.p, spec.num_limbs), limbs))
    return torch.where(((borrow == 0) | (top != 0))[None], d, limbs)


def _add_lazy(spec: FieldSpec, a, b):
    """a + b for a, b < 2p, less 2p where the sum reaches it: [0, 2p)
    (`_add_rows_lazy`, with the carry out of bit 256 kept)."""
    return _less_2p(spec, *fc.normalize(a + b))


def _sub_lazy(spec: FieldSpec, a, b):
    """a - b + 2p for a, b < 2p, less 2p where it reaches it: [0, 2p)
    (`_sub_rows_lazy`, with the carry kept)."""
    two_p = fc._col(int_to_limbs(2 * spec.p, spec.num_limbs), a)
    return _less_2p(spec, *fc.normalize(a + two_p - b))


def _shoup_mul(spec: FieldSpec, w, wp, x):
    """w x mod p up to one p, in [0, 2p), for a plain w < p with its
    companion wp = floor(w 2^256 / p) and any x < 2^256: q = floor(wp x /
    2^256) exactly, r = w x - q p (`csrc/field.cuh shoup_mul`). int64 limb
    planes of one shape (L, k)."""
    L = spec.num_limbs
    t, _ = fc.normalize(fc.mul_cols(wp, x, 2 * L))
    wx, _ = fc.normalize(fc.mul_cols(w, x, L))
    qp, _ = fc.normalize(fc.mul_cols(t[L:], fc._col(spec.p_limbs, x), L))
    r, _ = fc.normalize(wx - qp)
    return r


def butterfly_stage_shoup_plain(spec: FieldSpec, a, tw2, m: int, l: int, kind: str,
                                canon: bool = False):
    """One Shoup stage on flat (L, n) `a` viewed as (L, m, 2, l), values in
    [0, 2p); tw2: (2L, l), the plain twiddles' limbs over their companions'
    (`shoup_stage_tables`). `_butterfly_pair_shoup`: dif: y0 = u + v,
    y1 = (u - v) w; dit: t = v w, y0 = u + t, y1 = u - t; every value in
    [0, 2p), and canonical with `canon`."""
    L, n = a.shape
    v4 = a.reshape(L, m, 2, l).to(torch.int64)
    u, v = v4[:, :, 0].reshape(L, -1), v4[:, :, 1].reshape(L, -1)
    w = tw2[:L].to(torch.int64).reshape(L, 1, l).expand(L, m, l).reshape(L, -1)
    wp = tw2[L:].to(torch.int64).reshape(L, 1, l).expand(L, m, l).reshape(L, -1)
    if kind == "dif":
        y0 = _add_lazy(spec, u, v)
        y1 = _shoup_mul(spec, w, wp, _sub_lazy(spec, u, v))
    else:
        t = _shoup_mul(spec, w, wp, v)
        y0 = _add_lazy(spec, u, t)
        y1 = _sub_lazy(spec, u, t)
    if canon:
        y0, y1 = (fc.cond_sub_p(spec, y, torch.zeros_like(y[0])) for y in (y0, y1))
    out = torch.stack([y0.reshape(L, m, l), y1.reshape(L, m, l)], dim=2)
    return out.reshape(L, n).to(torch.int32)


def pack_shoup_words(tw2):
    """(2L, k) Shoup planes -> (k, 16) words: an element's 8 packed words of
    w, then 8 of its companion (`pack_words` of each half): the layout the
    Shoup kernels read a twiddle in, 64 bytes."""
    L = tw2.shape[0] // 2
    return torch.cat([pack_words(tw2[:L]), pack_words(tw2[L:])], dim=1).contiguous()


def unpack_shoup_words(words):
    """Inverse of `pack_shoup_words`: (k, 16) -> (2L, k)."""
    return torch.cat([unpack_words(words[:, :8].contiguous()),
                      unpack_words(words[:, 8:].contiguous())], dim=0)


def butterfly_pass_shoup_plain(spec: FieldSpec, a, tw_words, l0: int, r: int, kind: str,
                               canon: bool = False):
    """r consecutive Shoup stages, l = l0 .. l0 2^(r-1) (dit ascending, dif
    descending), each a whole-array `butterfly_stage_shoup_plain`, the last
    canonical with `canon`. tw_words: (l0 2^(r-1), 16), the largest stage's
    table as `pack_shoup_words`."""
    n = a.shape[1]
    tw = unpack_shoup_words(tw_words)
    top = l0 << (r - 1)
    ls = pass_ls(l0, r, kind)
    for i, l in enumerate(ls):
        a = butterfly_stage_shoup_plain(spec, a, tw[:, :: top // l].contiguous(),
                                        n // (2 * l), l, kind, canon and i == len(ls) - 1)
    return a


def butterfly_fused_shoup_plain(spec: FieldSpec, a, tw_words, block: int, kind: str,
                                canon: bool = False):
    """Every Shoup stage with 2l <= block, in order (dit: l ascending, dif:
    l descending), the last canonical with `canon`. tw_words: (block - 1,
    16), stage l's table at rows l-1 .. 2l-2 (`pack_shoup_words`)."""
    n = a.shape[1]
    tw = unpack_shoup_words(tw_words)
    ls = fused_ls(block, kind)
    for i, l in enumerate(ls):
        a = butterfly_stage_shoup_plain(spec, a, tw[:, l - 1 : 2 * l - 1].contiguous(),
                                        n // (2 * l), l, kind, canon and i == len(ls) - 1)
    return a


def _check_shoup_words(a, tw_words, rows: int):
    if (tw_words.shape != (rows, 16) or tw_words.dtype != torch.int32
            or not tw_words.is_contiguous() or tw_words.device != a.device):
        raise ValueError(
            f"Shoup twiddles: ({rows}, 16) contiguous int32 words on {a.device}, got "
            f"{tuple(tw_words.shape)} {tw_words.dtype} on {tw_words.device}"
        )


def butterfly_pass_shoup(spec: FieldSpec, a, tw_words, l0: int, r: int, kind: str,
                         canon: bool = False):
    """A pass of r <= `PASS_STAGES` outer Shoup stages (see
    `butterfly_pass_shoup_plain`) on a (16, n) plane of values in [0, 2p).
    On a CUDA tensor each group of 2^r elements (stride l0) is read once,
    its r stages run in shared memory and it is written once."""
    _check_kind(kind)
    fc.check_planes(spec, a)
    n = a.shape[1]
    if not 1 <= r <= PASS_STAGES or l0 < 1 or l0 & (l0 - 1) or n % (l0 << r):
        raise ValueError(f"pass shapes: a {tuple(a.shape)}, l0={l0}, r={r}")
    _check_shoup_words(a, tw_words, l0 << (r - 1))
    if a.device.type == "cpu":
        return butterfly_pass_shoup_plain(spec, a, tw_words, l0, r, kind, canon)
    words, np32, stream = fc.cuda_args(spec, a)
    out = torch.empty_like(a)
    rc = build.load().stark_butterfly_pass_shoup(
        a.data_ptr(), tw_words.data_ptr(), out.data_ptr(), n, l0, r,
        int(kind == "dit"), int(canon), words, np32, stream,
    )
    build.check(rc, "butterfly_pass_shoup")
    butterfly_pass_shoup.launches += 1
    return out


butterfly_pass_shoup.launches = 0


def butterfly_fused_shoup(spec: FieldSpec, a, tw_words, block: int, kind: str,
                          canon: bool = False):
    """The fused run of small Shoup stages (see `butterfly_fused_shoup_plain`)
    on a (16, n) plane of values in [0, 2p). On a CUDA tensor block is at
    most `FUSED_BLOCK`, and the table is a plan's (`shoup_stage_tables`):
    the kernel reads each stage below block / 4 as a stride of that stage's
    table (tw_l[k] = tw_2l[2k]), as `butterfly_pass_shoup` does."""
    _check_kind(kind)
    fc.check_planes(spec, a)
    n = a.shape[1]
    if block < 2 or block & (block - 1) or n % block:
        raise ValueError(f"fused shapes: a {tuple(a.shape)}, block={block}")
    _check_shoup_words(a, tw_words, block - 1)
    if a.device.type == "cpu":
        return butterfly_fused_shoup_plain(spec, a, tw_words, block, kind, canon)
    words, np32, stream = fc.cuda_args(spec, a)
    out = torch.empty_like(a)
    rc = build.load().stark_butterfly_fused_shoup(
        a.data_ptr(), tw_words.data_ptr(), out.data_ptr(), n, block,
        int(kind == "dit"), int(canon), words, np32, stream,
    )
    build.check(rc, "butterfly_fused_shoup")
    butterfly_fused_shoup.launches += 1
    return out


butterfly_fused_shoup.launches = 0


def shoup_stage_tables(spec: FieldSpec, root: int, n: int, device="cpu") -> list:
    """The Shoup form's stage tables (`stark_tpu/ops/ntt.py:74-103
    _shoup_stage_tables`): for each stage, l ascending (1, 2, .., n/2), a
    (2L, l) int32 plane of the plain twiddles root^(k n / 2l), k < l, over
    their companions floor(w 2^256 / p), as 16-bit limbs. Every stage's
    table is a stride of the largest's."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"NTT size must be a power of two >= 2, got {n}")
    p = spec.p
    tws, v = [], 1
    for _ in range(n // 2):
        tws.append(v)
        v = v * root % p
    top = torch.cat(mm.shoup_consts(spec, tws, device), dim=0)
    return [top[:, :: (n // 2) // l].contiguous() for l in
            (1 << s for s in range(n.bit_length() - 1))]


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


class NttPlan:
    """Twiddle tables for one (root, n, direction): "dif" natural ->
    bit-reversed, "dit" bit-reversed -> natural. With `shoup` the tables are
    the Shoup form's (`shoup_stage_tables`: each stage's (2L, l) plane; the
    fused run's and each pass's as `pack_shoup_words`), which a 16-limb
    field takes (the JAX package's `NttPlan.shoup`)."""

    def __init__(self, spec: FieldSpec, root: int, n: int, direction: str,
                 device, block: int = FUSED_BLOCK, shoup: bool = False):
        _check_kind(direction)
        if n < 1 or n & (n - 1):
            raise ValueError(f"NTT size must be a power of two, got {n}")
        if shoup and (spec.num_limbs != 16 or n < 2):
            raise ValueError(
                f"the Shoup form takes 16-limb fields and n >= 2, not {spec.name} at n={n}")
        self.n = n
        self.direction = direction
        self.block = min(n, block)
        self.shoup = shoup
        if shoup:
            tws = shoup_stage_tables(spec, root, n, device)
        else:
            w_half = mm.power_table(spec, root, max(n // 2, 1), device)
            tws = [w_half[:, :: n // (2 << s)][:, : 1 << s].contiguous()
                   for s in range(n.bit_length() - 1)]
        # (m, l, tw), l ascending
        stages = [(n // (2 << s), 1 << s, tw) for s, tw in enumerate(tws)]
        pack = pack_shoup_words if shoup else pack_words
        fused = [s for s in stages if 2 * s[1] <= self.block]
        self.singles = [s for s in stages if 2 * s[1] > self.block]
        if direction == "dif":  # dif runs l descending
            self.singles.reverse()
        self.fused_tw = (
            torch.cat([tw for (_, _, tw) in fused], dim=1) if fused else None
        )
        if shoup and self.fused_tw is not None:
            self.fused_tw = pack(self.fused_tw)
        # (l0, r, the table of width l0 2^(r-1) as packed words, which the
        # pass reads)
        tables = {l: tw for (_, l, tw) in stages}
        self.passes = [(l0, r, pack(tables[l0 << (r - 1)]))
                       for l0, r in pass_plan(n, self.block, direction)]


def outer_ls(n: int, block: int, kind: str) -> list[int]:
    """The widths of the stages with 2l > min(n, block), the plan's
    singles, in execution order (dit ascending, dif descending)."""
    ls = [1 << s for s in range(n.bit_length() - 1) if 2 << s > min(n, block)]
    return ls if kind == "dit" else ls[::-1]


def pass_plan(n: int, block: int, kind: str) -> list[tuple[int, int]]:
    """(l0, r) of each pass: `outer_ls` in execution order, cut into runs
    of `PASS_STAGES` consecutive stages (the last shorter where the count is
    not a multiple); l0 is a run's smallest width."""
    ls = outer_ls(n, block, kind)
    runs = [ls[i : i + PASS_STAGES] for i in range(0, len(ls), PASS_STAGES)]
    return [(min(run), len(run)) for run in runs]


def run(spec: FieldSpec, a, plan: NttPlan):
    """Execute a plan: the passes and the fused run in direction order. A
    Shoup plan (`_run_pallas`) leaves values in [0, 2p), but for a DIT
    plan's last stage, which is canonical (`_dit_fast` asks for it, and
    `_dif_fast` does not: the LDE's n^-1 product takes lazy coefficients)."""
    kind = plan.direction

    def fused(a, canon):
        if plan.fused_tw is None:
            return a
        if plan.shoup:
            return butterfly_fused_shoup(spec, a, plan.fused_tw, plan.block, kind, canon)
        return butterfly_fused(spec, a, plan.fused_tw, plan.block, kind)

    def passes(a, canon):
        for i, (l0, r, tw) in enumerate(plan.passes):
            if plan.shoup:
                a = butterfly_pass_shoup(spec, a, tw, l0, r, kind,
                                         canon and i == len(plan.passes) - 1)
            else:
                a = butterfly_pass(spec, a, tw, l0, r, kind)
        return a

    if kind == "dif":
        return fused(passes(a, False), False)
    canon = plan.shoup  # the DIT plan's last stage
    return passes(fused(a, canon and not plan.passes), canon)


class LdePlan:
    """Plans for one (g1, g2, steps, precision) LDE shape; `shoup` builds
    both in the Shoup form."""

    def __init__(self, spec: FieldSpec, g1: int, g2: int, steps: int,
                 precision: int, device, block: int = FUSED_BLOCK, shoup: bool = False):
        self.steps = steps
        self.precision = precision
        self.small_dif = NttPlan(spec, spec.inv(g1), steps, "dif", device, block, shoup)
        self.big_dit = NttPlan(spec, g2, precision, "dit", device, block, shoup)
        self.n_inv = mm.mont_const(spec, spec.inv(steps), device)


def make_lde_plan(spec: FieldSpec, g1: int, g2: int, steps: int, precision: int,
                  device, block: int = FUSED_BLOCK, shoup: bool = False) -> LdePlan:
    """The LDE's plans; shoup=False is the JAX package's default (its
    `STARK_TPU_SHOUP` turns the Shoup form on)."""
    return LdePlan(spec, g1, g2, steps, precision, device, block, shoup)


def lde(spec: FieldSpec, trace, plan: LdePlan):
    """Low-degree extension: interpolate the (L, steps) trace on the g1
    domain (DIF iNTT -> bit-reversed coefficients, times steps^-1), then
    evaluate on the g2 domain of size `precision` (interleaved zero-pad of
    the bit-reversed coefficients, DIT NTT). No bit reversal is ever
    materialized (`stark_tpu/ops/ntt.py:522-555`)."""
    L, steps = trace.shape
    precision = plan.precision
    if steps != plan.steps or precision % steps:
        raise ValueError(f"trace width {steps} does not fit the plan")
    ratio = precision // steps
    coeffs_rev = trace if steps == 1 else run(spec, trace, plan.small_dif)
    coeffs_rev = mm.mmul(spec, coeffs_rev, plan.n_inv)
    if ratio == 1:
        padded = coeffs_rev
    else:
        padded = torch.zeros((L, steps, ratio), dtype=torch.int32, device=trace.device)
        padded[:, :, 0] = coeffs_rev
        padded = padded.reshape(L, precision)
    return run(spec, padded, plan.big_dit)


# ---------------------------------------------------------------------------
# the LDE engine
# ---------------------------------------------------------------------------

LDE_ENGINES = ("butterfly", "crt")


def check_lde_engine(name: str) -> str:
    if name not in LDE_ENGINES:
        raise ValueError(f"lde_engine must be one of {LDE_ENGINES}, got {name!r}")
    return name


def make_best_lde(spec: FieldSpec, g1: int, g2: int, steps: int, precision: int,
                  device, lde_engine: str = "butterfly", block: int = FUSED_BLOCK):
    """lde_fn(trace (L, steps)) -> (L, precision) on the named engine
    (`stark_tpu/ops/ntt.py:504`, where the environment chooses): "butterfly"
    is `lde` on an `LdePlan`; "crt" is the CRT matrix-product engine of
    `ops/mxu_ntt.py` at every size it supports (the JAX package's
    `STARK_TPU_MXU=force`). Both give the same field values. The function's
    `plans` holds the engine's plans, whose tensors it keeps on the device."""
    if check_lde_engine(lde_engine) == "crt":
        from stark_tpu_torch.ops import mxu_ntt

        inv_plan, big_plan = mxu_ntt.make_lde_plans(spec, g1, g2, steps, precision, device)
        fn = lambda t: mxu_ntt.lde_mxu(inv_plan, big_plan, t.contiguous())  # noqa: E731
        fn.plans = (inv_plan, big_plan)
        return fn
    plan = make_lde_plan(spec, g1, g2, steps, precision, device, block)
    fn = lambda t: lde(spec, t, plan)  # noqa: E731
    fn.plans = (plan,)
    return fn
