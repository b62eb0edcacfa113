"""The multi-stage pass of the port's NTT plan (`ops/ntt.py`
`butterfly_pass`, `pass_plan`) on the CPU: no kernel runs here.

- The plan: for every n from 2 to 2^23 and every block from 2 to 2048 the
  passes cover each outer stage (2l > block) exactly once, in execution
  order, at most `PASS_STAGES` consecutive stages a pass; the outer widths
  follow the JAX plan's rule (`stark_tpu/ops/ntt.py:231-262`), and at
  n = 2^12, 2^13 equal the JAX plan's own singles (`STARK_TPU_PALLAS=1`),
  tables included, which the port's `singles` keep.
- `run` on passes equals the JAX package's XLA NTT cores (`_dif_core`,
  `_dit_core`) at n up to 2^12 with blocks 4 and 16 (1-4 passes, short
  last ones), both directions, on BN254's and BLS12-381's scalar fields.
- A model of `csrc/ntt.cu butterfly_pass_kernel`: its index map in numpy
  (CTA -> group and first k of its tile; thread -> the two elements it
  loads and stores, and at each stage its butterfly's two tile elements
  and twiddle index in the largest table), checked against the
  whole-array stages, and its butterflies word by word as the PTX carry
  chains state them (`mont_mul_lazy`, `sub_words`, `add_words`), asserting
  the bounds the kernel's header states: on BN254 the lazy build (DIT
  values below 4p, DIF below 2p, a product's running sum below a + p
  after each row, so within nine words, no carry dropped, every sum below
  2^256), on BLS12-381 the canonical one; run over
  passes of 1-3 stages, it must equal the stage-by-stage plain run.
Inputs come from numpy seeds, with 0, 1, R mod p and p - 1 among them.
Tolerance: exact equality.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BLS12_381_FR as jbls
from stark_tpu.fields.field import BN254_FR as jbn
from stark_tpu.ops import modmath as jmm
from stark_tpu.ops import ntt as jntt
from stark_tpu_torch.fields.field import BLS12_381_FR, BN254_FR
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.ops import ntt

torch.set_num_threads(2)

FIELDS = {"bn254": (BN254_FR, jbn), "bls12_381": (BLS12_381_FR, jbls)}
M32 = (1 << 32) - 1
NW = 8


def _jax_outer_ls(n: int, kind: str) -> list[int]:
    """The JAX plan's singles (`stark_tpu/ops/ntt.py:241-256`): the stages
    l = 1, 2, .. < n with 2l > block = min(n, block), l descending for dif."""
    return ntt.outer_ls(n, ntt.FUSED_BLOCK, kind)


@pytest.mark.parametrize("block", [1 << b for b in range(1, 12)])
def test_passes_cover_outer_stages(block):
    for log_n in range(1, 24):
        n = 1 << log_n
        for kind in ("dit", "dif"):
            ls = [1 << s for s in range(log_n) if 2 << s > min(n, block)]
            assert ntt.outer_ls(n, block, kind) == (ls if kind == "dit" else ls[::-1])
            run = [l for l0, r in ntt.pass_plan(n, block, kind)
                   for l in ntt.pass_ls(l0, r, kind)]
            assert run == ntt.outer_ls(n, block, kind)  # each once, in order
            passes = ntt.pass_plan(n, block, kind)
            assert all(1 <= r <= ntt.PASS_STAGES for _, r in passes)
            assert all(r == ntt.PASS_STAGES for _, r in passes[:-1])  # only the last short
            assert all(n % (l0 << r) == 0 for l0, r in passes)


def test_headline_passes():
    """Precision 2^20 and steps 2^17 at the default block: 3 + 2 passes,
    where the singles are 9 + 6 stages."""
    assert ntt.pass_plan(1 << 20, ntt.FUSED_BLOCK, "dit") == [(1 << 11, 3), (1 << 14, 3),
                                                                (1 << 17, 3)]
    assert ntt.pass_plan(1 << 17, ntt.FUSED_BLOCK, "dif") == [(1 << 14, 3), (1 << 11, 3)]
    assert ntt.pass_plan(1 << 21, ntt.FUSED_BLOCK, "dit")[-1] == (1 << 20, 1)


@pytest.mark.parametrize("kind", ["dit", "dif"])
@pytest.mark.parametrize("log_n", [12, 13])
def test_singles_match_jax_plan(log_n, kind, monkeypatch):
    monkeypatch.setenv("STARK_TPU_PALLAS", "1")
    n = 1 << log_n
    root = jbn.root_of_unity(n)
    jplan = jntt.NttPlan(jbn, root, n, kind)
    plan = ntt.NttPlan(BN254_FR, root, n, kind, "cpu")
    assert [l for _, l, _ in jplan.singles] == _jax_outer_ls(n, kind)
    assert [(m, l) for m, l, _ in plan.singles] == [(m, l) for m, l, _ in jplan.singles]
    for (_, _, tw), (_, _, jtw) in zip(plan.singles, jplan.singles):
        assert np.array_equal(planes_to_numpy(tw), np.asarray(jtw))
    # each pass reads its largest stage's table, as packed words
    tables = {l: tw for _, l, tw in plan.singles}
    for l0, r, words in plan.passes:
        assert words.shape == (l0 << (r - 1), 8) and words.is_contiguous()
        assert torch.equal(ntt.unpack_words(words), tables[l0 << (r - 1)])


def _random_mont(jspec, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % jspec.p for _ in range(n)]
    vals[:4] = [0, 1, jspec.p - 1, jspec.p - 2]
    return np.asarray(jmm.to_mont(jspec, jmm.ints_to_limbs_np(vals, jspec)))


@functools.lru_cache(maxsize=None)
def _jax_case(field: str, n: int, kind: str):
    """(input, JAX output) for one field, size and direction, computed once."""
    jspec = FIELDS[field][1]
    w_half = jmm.power_table(jspec, jspec.root_of_unity(n), n // 2)
    core = jntt._dif_core if kind == "dif" else jntt._dit_core
    x = _random_mont(jspec, n, seed=n + (kind == "dit") + 7 * (field == "bls12_381"))
    return x, np.asarray(jax.jit(lambda a, w: core(jspec, a, w))(x, w_half))


RUN_CASES = [("bn254", 1 << 6), ("bn254", 1 << 9), ("bn254", 1 << 12),
             ("bls12_381", 1 << 9), ("bls12_381", 1 << 12)]


@pytest.mark.parametrize("block", [4, 16])
@pytest.mark.parametrize("kind", ["dif", "dit"])
@pytest.mark.parametrize("field,n", RUN_CASES)
def test_run_on_passes_matches_jax(field, n, kind, block):
    spec, jspec = FIELDS[field]
    x, want = _jax_case(field, n, kind)
    plan = ntt.NttPlan(spec, jspec.root_of_unity(n), n, kind, "cpu", block=block)
    assert 1 <= len(plan.passes) <= 4
    got = ntt.run(spec, planes_from_numpy(x, "cpu"), plan)
    assert np.array_equal(planes_to_numpy(got), want)


def test_words_round_trip():
    rng = np.random.default_rng(3)
    planes = torch.from_numpy(rng.integers(0, 1 << 16, (16, 40)).astype(np.int32))
    words = ntt.pack_words(planes)
    assert words.shape == (40, 8) and words.dtype == torch.int32
    assert torch.equal(ntt.unpack_words(words), planes)
    # element c's word q holds limbs 2q and 2q + 1
    v = words[5, 3].item() & M32
    assert v == planes[6, 5].item() | planes[7, 5].item() << 16


def test_pass_wrapper_checks_shapes():
    x = torch.zeros((16, 64), dtype=torch.int32)
    tw = torch.zeros((16, 8), dtype=torch.int32)
    ntt.butterfly_pass(BN254_FR, x, tw, 4, 3, "dit")  # 64 = 2 groups of 8 x 4
    with pytest.raises(ValueError):
        ntt.butterfly_pass(BN254_FR, x, tw, 4, 4, "dit")  # more than PASS_STAGES
    with pytest.raises(ValueError):
        ntt.butterfly_pass(BN254_FR, x, tw, 8, 3, "dit")  # tw not the widest table
    with pytest.raises(ValueError):
        ntt.butterfly_pass(BN254_FR, x, tw[:12], 3, 3, "dit")  # l0 not 2^k
    with pytest.raises(ValueError):
        ntt.butterfly_pass(BN254_FR, x, tw.t().contiguous(), 4, 3, "dit")  # planes, not words
    with pytest.raises(ValueError):
        ntt.butterfly_pass(BN254_FR, x, tw, 4, 3, "fft")


def test_run_walks_passes_not_stages(monkeypatch):
    """`run` launches one `butterfly_pass` a pass and no single stage."""
    n, block = 1 << 9, 4
    plan = ntt.NttPlan(BN254_FR, BN254_FR.root_of_unity(n), n, "dit", "cpu", block=block)
    x = planes_from_numpy(_random_mont(jbn, n, seed=21), "cpu")
    want = ntt.run(BN254_FR, x, plan)
    calls = []
    real_pass = ntt.butterfly_pass

    def counted(*args):
        calls.append(args[3:5])
        return real_pass(*args)

    def refuse(*args):
        raise AssertionError("run launched a single stage")

    monkeypatch.setattr(ntt, "butterfly_pass", counted)
    monkeypatch.setattr(ntt, "butterfly_stage", refuse)
    assert torch.equal(ntt.run(BN254_FR, x, plan), want)
    assert calls == [(l0, r) for l0, r, _ in plan.passes] == [(4, 3), (32, 3), (256, 1)]


def test_chip_smoke_names_the_pass():
    """`chip_smoke.py` holds the pass as the kernel that replaces
    `pallas_field.py:446` on the path, and keeps the single stage off it."""
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    chip_smoke = importlib.import_module("chip_smoke")
    assert chip_smoke.KERNELS["butterfly_pass"] == (
        "stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_field.py:446")
    assert "butterfly_stage" in chip_smoke.OFF_PATH
    assert "butterfly_pass" not in chip_smoke.OFF_PATH
    wrap = chip_smoke.wrappers()
    assert list(wrap) == list(chip_smoke.KERNELS)
    assert wrap["butterfly_pass"] is ntt.butterfly_pass


def test_pass_launch_counter_counts_kernels_only():
    x = torch.zeros((16, 64), dtype=torch.int32)
    before = ntt.butterfly_pass.launches
    ntt.butterfly_pass(BN254_FR, x, torch.zeros((16, 8), dtype=torch.int32), 4, 3, "dif")
    assert ntt.butterfly_pass.launches == before


# ---------------------------------------------------------------------------
# the kernel's model: index map (numpy), then its word operations (Python)
# ---------------------------------------------------------------------------


PASS_TILE = 512  # `csrc/ntt.cu PASS_TILE`: the elements a CTA of the pass holds


class Tile:
    """`butterfly_pass_kernel`'s index map for a pass of r stages from l0
    over n elements, in numpy. CTA b holds the 2^r rows of one group g at
    K = min(l0, PASS_TILE / 2^r) consecutive k from k0; its tile element e
    (row e / K, column e mod K) lies at `addr`; thread t loads and stores
    elements 2t and 2t + 1 as one 8-byte access at `col`; a stage's
    butterflies are those of `stage`."""

    def __init__(self, n: int, l0: int, r: int):
        self.n, self.l0, self.r = n, l0, r
        log_l0 = l0.bit_length() - 1
        self.K = K = min(l0, PASS_TILE >> r)
        log_k = K.bit_length() - 1
        self.threads = (K << r) // 2
        b = np.arange(n // (K << r), dtype=np.int64)
        self.k0 = (b << log_k) & (l0 - 1)
        base = ((b >> (log_l0 - log_k)) << (log_l0 + r)) + self.k0
        e = np.arange(K << r, dtype=np.int64)
        self.addr = base[:, None] + (e >> log_k)[None, :] * l0 + (e & (K - 1))[None, :]
        self.col = self.addr[:, 0::2]

    def stage(self, s: int):
        """(iu, iv, twiddle index in the largest table), each (threads,):
        the tile elements and the twiddle of every thread's butterfly at
        stage s, the twiddle index relative to k0."""
        t = np.arange(self.threads, dtype=np.int64)
        c, jj = t & (self.K - 1), t // self.K
        j = ((jj >> s) << (s + 1)) | (jj & ((1 << s) - 1))
        iu = j * self.K + c
        iv = iu + (self.K << s)
        return iu, iv, c + (j & ((1 << s) - 1)) * self.l0

    def twiddle(self, b: int, rel, s: int):
        return (self.k0[b] + rel) << (self.r - 1 - s)


@pytest.mark.parametrize("n,l0,r", [(1 << 11, 2, 3), (1 << 11, 4, 2), (1 << 11, 8, 1),
                                    (1 << 11, 64, 3), (1 << 12, 256, 3), (1 << 12, 512, 2),
                                    (1 << 12, 1024, 1), (1 << 12, 1, 1)])
def test_tile_map_is_the_stage_run(n, l0, r):
    tile = Tile(n, l0, r)
    assert tile.threads <= PASS_TILE // 2
    # every element in exactly one tile; each thread's two elements side by
    # side in the planes, at an even column (the 8-byte accesses)
    assert np.array_equal(np.sort(tile.addr.ravel()), np.arange(n))
    assert np.array_equal(tile.addr[:, 1::2], tile.col + 1) and (tile.col % 2 == 0).all()
    # a warp's loads: 32 threads on 64 consecutive elements of a row
    if tile.K >= 64:
        assert (np.diff(tile.col[:, :32], axis=1) == 2).all()
    top = l0 << (r - 1)
    for s in range(r):
        l = l0 << s
        iu, iv, rel = tile.stage(s)
        # each tile element in exactly one butterfly of the stage
        assert np.array_equal(np.sort(np.concatenate([iu, iv])), np.arange(tile.K << r))
        for b in range(len(tile.k0)):
            u, v = tile.addr[b, iu], tile.addr[b, iv]
            # the whole-array stage of width l pairs u with u + l in its group of 2l
            assert np.array_equal(v, u + l) and ((u % (2 * l)) < l).all()
            # its twiddle tw_l[u mod l] = tw_top[(u mod l) (top / l)]
            ti = tile.twiddle(b, rel, s)
            assert np.array_equal(ti, (u % l) * (top // l)) and (ti < top).all()
        # a warp's butterflies on consecutive columns (no bank conflicts)
        if tile.K >= 32:
            assert (np.diff(iu[:32]) == 1).all() and (np.diff(iv[:32]) == 1).all()


def words(x: int) -> list[int]:
    assert 0 <= x < 1 << 256
    return [(x >> 32 * i) & M32 for i in range(NW)]


def value(ws) -> int:
    return sum(w << 32 * i for i, w in enumerate(ws))


class Model:
    """`csrc/ntt.cu`'s butterflies as the PTX carry chains compute them.
    Every carry or borrow that the PTX drops is asserted to be 0, and the
    bounds of each value on the way are asserted as the header states."""

    def __init__(self, spec, lazy: bool):
        self.p = spec.p
        self.lazy = lazy
        self.np = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
        self.one = (1 << 256) % spec.p
        self.P, self.P2 = words(spec.p), words(2 * spec.p)

    def mad_lo_row(self, t, a, b):
        c = 0
        for j in range(NW):
            s = t[j] + ((a[j] * b) & M32) + c
            t[j], c = s & M32, s >> 32
        s = t[NW] + c  # addc.u32: no carry out
        assert s >> 32 == 0
        t[NW] = s

    def mad_hi_row(self, t, a, b):
        c = 0
        for j in range(NW):
            s = t[j + 1] + ((a[j] * b) >> 32) + c
            t[j + 1], c = s & M32, s >> 32
        assert c == 0  # madc.hi.u32 into t[8]: no carry out

    def mont_mul_lazy(self, a, b):
        assert value(a) < 4 * self.p and value(b) < self.p
        t = [0] * (NW + 1)
        for i in range(NW):
            self.mad_lo_row(t, a, b[i])
            self.mad_hi_row(t, a, b[i])
            m = (t[0] * self.np) & M32
            self.mad_lo_row(t, self.P, m)
            assert t[0] == 0
            self.mad_hi_row(t, self.P, m)
            t = t[1:] + [0]
            assert value(t) < value(a) + self.p  # so a row's sums stay in nine words
        r = t[:NW]
        assert value(r) < 2 * self.p
        assert value(r) % self.p == value(a) * value(b) * pow(2, -256, self.p) % self.p
        return r

    @staticmethod
    def sub_words(a, b):
        d, borrow = [], 0
        for j in range(NW):
            s = a[j] - b[j] - borrow
            d.append(s & M32)
            borrow = int(s < 0)
        return d, borrow

    @staticmethod
    def add_words(a, b):
        r, c = [], 0
        for j in range(NW):
            s = a[j] + b[j] + c
            r.append(s & M32)
            c = s >> 32
        assert c == 0  # addc.u32: the sum stays below 2^256
        return r

    def sub_if_ge(self, a, m):
        d, borrow = self.sub_words(a, m)
        return a if borrow else d

    def add_diff(self, a, m, b):
        d, borrow = self.sub_words(m, b)
        assert borrow == 0  # b <= m
        return self.add_words(a, d)

    def product(self, v, w):
        """A product by w, skipped where w is Montgomery one."""
        if value(w) == self.one:
            return list(v)
        return self.mont_mul_lazy(v, w)

    def butterfly(self, dit: bool, u, v, w):
        """`fused_butterfly<DIT, LAZY>`: in place, returns (u, v)."""
        p, P, P2 = self.p, self.P, self.P2
        if not self.lazy:
            assert value(u) < p and value(v) < p
            if dit:
                t = self.sub_if_ge(self.product(v, w), P)
                v = self.sub_if_ge(self.add_diff(u, P, t), P)
                u = self.sub_if_ge(self.add_words(u, t), P)
            else:
                t = self.sub_if_ge(self.add_diff(u, P, v), P)
                u = self.sub_if_ge(self.add_words(u, v), P)
                v = self.sub_if_ge(self.product(t, w), P)
            assert value(u) < p and value(v) < p
            return u, v
        if dit:
            assert value(u) < 4 * p and value(v) < 4 * p
            u = self.sub_if_ge(u, P2)
            t = self.sub_if_ge(v, P2) if value(w) == self.one else self.mont_mul_lazy(v, w)
            assert value(t) < 2 * p
            v = self.add_diff(u, P2, t)
            u = self.add_words(u, t)
            assert value(u) < 4 * p and value(v) < 4 * p
        else:
            assert value(u) < 2 * p and value(v) < 2 * p
            t = self.add_diff(u, P2, v)
            u = self.sub_if_ge(self.add_words(u, v), P2)
            v = self.sub_if_ge(t, P2) if value(w) == self.one else self.mont_mul_lazy(t, w)
            assert value(u) < 2 * p and value(v) < 2 * p
        return u, v

    def canonical(self, dit: bool, x):
        """`fused_canonical<DIT, LAZY>`."""
        if not self.lazy:
            return x
        if dit:
            x = self.sub_if_ge(x, self.P2)
        x = self.sub_if_ge(x, self.P)
        assert value(x) < self.p
        return x


def ints(planes: torch.Tensor) -> list[int]:
    a = planes.to(torch.int64).tolist()
    return [sum((a[i][c] & 0xFFFF) << (16 * i) for i in range(len(a))) for c in range(len(a[0]))]


def from_ints(vals) -> torch.Tensor:
    return torch.tensor([[(v >> (16 * i)) & 0xFFFF for v in vals] for i in range(16)],
                        dtype=torch.int32)


def pass_model(model: Model, x: list[int], tw: list[int], l0: int, r: int, kind: str):
    """`butterfly_pass_kernel` on Python integers, CTA by CTA: the tile
    loaded, each stage's butterflies run word by word between barriers,
    the tile stored canonical."""
    dit = kind == "dit"
    tile = Tile(len(x), l0, r)
    out = [None] * len(x)
    for b, addrs in enumerate(tile.addr.tolist()):
        xs = [words(x[a]) for a in addrs]
        for st in range(r):
            s = st if dit else r - 1 - st
            iu, iv, rel = tile.stage(s)
            for u, v, ti in zip(iu.tolist(), iv.tolist(), tile.twiddle(b, rel, s).tolist()):
                xs[u], xs[v] = model.butterfly(dit, xs[u], xs[v], words(tw[ti]))
        for a, v in zip(addrs, xs):
            out[a] = value(model.canonical(dit, v))
    return out


def _edge_column(spec, n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(n)]
    one = (1 << 256) % spec.p
    vals[:6] = [0, 1, one, spec.p - 1, spec.p - 1, 0]
    vals[-8:] = [spec.p - 1] * 8  # a whole group of p - 1 at l0 = 1
    return vals


@pytest.mark.parametrize("kind", ["dit", "dif"])
@pytest.mark.parametrize("field", ["bn254", "bls12_381"])
def test_kernel_model_matches_stage_run(field, kind):
    spec = FIELDS[field][0]
    lazy = field == "bn254"
    assert ntt.fused_lazy(spec) == lazy
    n = 1 << 9
    plan = ntt.NttPlan(spec, spec.root_of_unity(n), n, kind, "cpu", block=2)
    model = Model(spec, lazy)
    x = _edge_column(spec, n, seed=11 + (kind == "dit"))
    cases = plan.passes + [(l0, 2, tw) for l0, _, tw in plan.passes[:1]] + [
        (l0 << (r - 1), 1, tw) for l0, r, tw in plan.passes[:1]]
    for l0, r, words in cases:
        full = ntt.unpack_words(words)
        tw = full[:, :: (full.shape[1] // (l0 << (r - 1)))].contiguous()
        got = pass_model(model, x, ints(tw), l0, r, kind)
        want = ntt.butterfly_pass_plain(spec, from_ints(x), ntt.pack_words(tw), l0, r, kind)
        assert got == ints(want), (l0, r)


@pytest.mark.parametrize("kind", ["dit", "dif"])
def test_lazy_butterfly_bounds_at_extremes(kind):
    """The lazy butterfly's stated input bounds (DIT below 4p, DIF below 2p)
    at their largest values, against every kind of twiddle: the outputs stay
    within the same bounds and agree with the field's butterfly mod p."""
    spec = BN254_FR
    p, dit = spec.p, kind == "dit"
    model = Model(spec, lazy=True)
    hi = 4 * p - 1 if dit else 2 * p - 1
    rinv = pow(2, -256, p)
    rng = np.random.default_rng(5)
    tws = [p - 1, 1, model.one, int.from_bytes(rng.bytes(32), "little") % p]
    for u in (0, p - 1, p, 2 * p - 1, hi):
        for v in (0, p - 1, p, 2 * p - 1, hi):
            for w in tws:
                y0, y1 = model.butterfly(dit, words(u), words(v), words(w))
                if dit:
                    t = v * w * rinv
                    assert (value(y0) - (u + t)) % p == 0 and (value(y1) - (u - t)) % p == 0
                else:
                    assert (value(y0) - (u + v)) % p == 0
                    assert (value(y1) - (u - v) * w * rinv) % p == 0
