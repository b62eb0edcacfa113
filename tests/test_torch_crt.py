"""The port's CRT product (`stark_tpu_torch/ops/crt.py`) against
`stark_tpu.ops.crt` on its XLA path, on the CPU.

* the port builds the JAX package's tables from its own host code: basis
  (primes, fold constants, digit tables) and constant-matrix plans; the
  kernels' integer tables are the same whether derived from the port's
  basis or from the JAX basis' leaves through `interop`;
* `reduce_in`, `reconstruct` and `crt_matmul` (with and without a
  pre-table, chunked over the batch or not) give the JAX package's values
  on the same numpy-seeded inputs, the edge values of `tests/test_crt.py`
  included (0, 1, p - 1, dense limbs, pre-table residues q - 1), and the
  product is the python-int one, Montgomery form in and out.

On CPU tensors the three wrappers of `ops/crt_cuda.py` run their plain
versions, so `crt_matmul` here is the composed plain path. Tolerance: exact
equality (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import crt as jcrt
from stark_tpu_torch import interop
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.ops import crt, crt_cuda

torch.set_num_threads(2)

P = spec.p
R256 = 1 << 256
TABLES = ("qs", "deltas", "C0", "C1", "G", "negM_dig", "NB", "PB")
EDGE = [0, 1, P - 1, P - 2, (1 << 254) % P, int("f" * 63, 16) % P,
        0x8000800080008000800080008000800080008000800080008000800080008000 % P,
        P // 2]


def limbs_np(vals):
    a = np.zeros((16, len(vals)), np.uint32)
    for t, v in enumerate(vals):
        for i in range(16):
            a[i, t] = (v >> (16 * i)) & 0xFFFF
    return a


def ints_of(arr):
    arr = np.asarray(arr)
    return [sum(int(arr[i, t]) << (16 * i) for i in range(16)) for t in range(arr.shape[1])]


def rand_field(rng, n):
    return [int(rng.integers(0, 1 << 62)) ** 5 % P for _ in range(n)]


def x_planes(xs):
    """Rows of python ints -> (16, K, B) uint32 limb planes."""
    x = np.zeros((16, len(xs), len(xs[0])), np.uint32)
    for j, row in enumerate(xs):
        x[:, j, :] = limbs_np(row)
    return x


def pre_residues(basis, tvals):
    return np.array([[[t % q for t in row] for row in tvals] for q in basis.qs_host],
                    np.uint32)


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def bases():
    # bound for K=8 products with a pre-table: 8 * p^3 < 2^766
    return jcrt.CrtBasis(spec, 770), crt.CrtBasis(tspec, 770)


def both_matmuls(bases, w, x, pre=None):
    """The same matrix, data and pre-table through both packages."""
    jb, tb = bases
    jplan, tplan = jcrt.CrtMatmulPlan(jb, w), crt.CrtMatmulPlan(tb, w, "cpu")
    want = np.asarray(jcrt.crt_matmul(
        jb, jplan, jnp.asarray(x), pre=None if pre is None else jnp.asarray(pre)))
    got = crt.crt_matmul(
        tb, tplan, interop.planes_from_numpy(x, "cpu"),
        pre=None if pre is None else torch.from_numpy(pre.astype(np.int16)))
    return interop.planes_to_numpy(got), want


# --- tables -----------------------------------------------------------------------


@pytest.mark.parametrize("bound_bits", [520, 770])
def test_basis_tables_equal(bound_bits):
    jb, tb = jcrt.CrtBasis(spec, bound_bits), crt.CrtBasis(tspec, bound_bits)
    for name in ("p", "bound_bits", "P", "qr", "qs_host", "t_host", "M", "minv_qr",
                 "delta_r", "dmax_bits", "p_limbs16"):
        assert getattr(jb, name) == getattr(tb, name), name
    for name in TABLES:
        assert np.array_equal(f32(getattr(jb, name)), getattr(tb, name).astype(np.float32)), name
    assert jcrt.select_primes(300) == crt.select_primes(300)
    assert [jcrt._fold_count(b, 10) for b in (16, 28, 32)] == \
        [crt._fold_count(b, 10) for b in (16, 28, 32)]


def test_kernel_tables_from_jax_leaves(bases):
    """`interop.crt_basis_from_numpy` on the JAX basis' leaves gives the
    kernels the tables the port's own basis gives them, and those tables hold
    the plain integers: 256^l mod q, (M/q_i) mod p in G's tensor-core
    fragments with (M/q_i) mod q_r, and -M mod p."""
    jb, tb = bases
    other = interop.crt_basis_from_numpy(
        tspec, {k: getattr(jb, k) for k in interop._BASIS_STATIC},
        {k: f32(getattr(jb, k)) for k in interop._BASIS_TABLES})
    for name in ("kernel_table", "rec_frags", "negm_digits") + TABLES:
        assert np.array_equal(getattr(other, name), getattr(tb, name)), name
    table = tb.kernel_table
    digits = table[:, :16].copy().view(np.int8).reshape(-1, 2, 32).astype(np.int64)
    for i, q in enumerate(tb.qs_host):
        cb = digits[i, 0] + 128 * digits[i, 1]
        assert [int(c) % q for c in cb] == [pow(256, l, q) for l in range(32)]
        assert table[i, 16] == q and table[i, 17] == (1 << 32) // q
        assert table[i, 18] == 0 and table[i, 19] == (1 << 14) - q
    # rec_frags: lane (g, t) register r of tile (mt, ks) holds rows 16mt + g
    # (+8 for odd r), columns 32ks + 16(r // 2) + 4t .. + 3 of G
    frag = tb.rec_frags.copy().view(np.int8).reshape(3, 2, 32, 4, 4).astype(np.int64)
    g_pad = np.zeros((crt.REC_ROWS, crt.REC_PRIMES), np.int64)
    for mt in range(3):
        for ks in range(2):
            for lane in range(32):
                for r in range(4):
                    row = 16 * mt + lane // 4 + 8 * (r % 2)
                    col = 32 * ks + 16 * (r // 2) + 4 * (lane % 4)
                    g_pad[row, col:col + 4] = frag[mt, ks, lane, r]
    assert not g_pad[crt.ND + 2:].any() and not g_pad[:, tb.P:].any()
    qs = tb.qs_host[:-1]
    vals = [sum(int(g_pad[d, i]) << (8 * d) for d in range(crt.ND)) for i in range(tb.P)]
    assert vals == [(tb.M // q) % P for q in qs]
    grr = g_pad[crt.ND, : tb.P] + 128 * g_pad[crt.ND + 1, : tb.P]
    assert [int(g) % tb.qr for g in grr] == [(tb.M // q) % tb.qr for q in qs]
    assert sum(int(d) << (8 * k) for k, d in enumerate(tb.negm_digits)) == (-tb.M) % P


def test_plan_tables_equal(bases):
    jb, tb = bases
    rng = np.random.default_rng(7)
    w = [rand_field(rng, 6) for _ in range(5)]
    w[0][:3] = [0, 1, P - 1]
    for mont_fix in (True, False):
        jplan = jcrt.CrtMatmulPlan(jb, w, mont_fix)
        tplan = crt.CrtMatmulPlan(tb, w, "cpu", mont_fix)
        assert (tplan.kout, tplan.k) == (jplan.kout, jplan.k) == (5, 6)
        assert tplan.W0.dtype == torch.int8
        for jw, tw in ((jplan.W0, tplan.W0), (jplan.W1, tplan.W1)):
            assert np.array_equal(f32(jw), tw.numpy().astype(np.float32))
    other = interop.crt_plan_from_numpy(f32(jplan.W0), f32(jplan.W1), "cpu")
    assert torch.equal(other.W0, tplan.W0) and torch.equal(other.W1, tplan.W1)


def test_pack_k4_round_trip():
    rng = np.random.default_rng(8)
    for K in (1, 4, 6, 9):
        d = torch.from_numpy(rng.integers(-64, 128, size=(3, K, 5)).astype(np.int8))
        w = crt.pack_k4(d)
        assert w.shape == (3, -(-K // 4), 5) and w.dtype == torch.int32
        assert torch.equal(crt.unpack_k4(w, K), d)
        padded = crt.unpack_k4(w, 4 * w.shape[1])
        assert not padded[:, K:].any()  # zeros past K
        assert int(w[1, 0, 2]) & 0xFF == int(d[1, 0, 2]) & 0xFF  # row 4w in byte 0


# --- the composed functions -------------------------------------------------------


def test_reduce_in_matches(bases):
    jb, tb = bases
    rng = np.random.default_rng(0)
    x = limbs_np(EDGE + rand_field(rng, 9))
    x = np.concatenate([x, np.full((16, 1), 0xFFFF, np.uint32)], axis=1)  # 2^256 - 1
    want = np.asarray(jb.reduce_in(jnp.asarray(x)))
    got = interop.planes_to_numpy(tb.reduce_in(interop.planes_from_numpy(x, "cpu")))
    assert np.array_equal(got, want)
    vals = ints_of(x)
    for i, q in enumerate(tb.qs_host):
        assert got[i].tolist() == [v % q for v in vals]


def test_reconstruct_matches(bases):
    jb, tb = bases
    rng = np.random.default_rng(1)
    vals = rand_field(rng, 7) + [0, 1, P - 1]
    qs = np.array(tb.qs_host, np.int64)[:, None]
    ts = np.array(tb.t_host + [1], np.int64)[:, None]
    s = (np.array([[v % q for v in vals] for q in tb.qs_host], np.int64) * ts) % qs
    # residues of no small X: every residue q - 1 (the largest wrap count), and 0
    s = np.concatenate([s, qs - 1, np.zeros_like(qs)], axis=1).astype(np.uint32)
    want = np.asarray(jb.reconstruct(jnp.asarray(s)))
    got = interop.planes_to_numpy(tb.reconstruct(interop.planes_from_numpy(s, "cpu")))
    assert np.array_equal(got, want)
    rinv = pow(R256, -1, P)
    assert ints_of(got)[: len(vals)] == [v * rinv % P for v in vals]


@pytest.mark.parametrize("with_pre", [False, True], ids=["plain", "pre"])
def test_crt_matmul_matches(bases, with_pre):
    rng = np.random.default_rng(2 + with_pre)
    kout, k, b = 5, 8, 6
    w = [rand_field(rng, k) for _ in range(kout)]
    xs = [rand_field(rng, b) for _ in range(k)]
    tvals = [rand_field(rng, b) for _ in range(k)] if with_pre else None
    pre = pre_residues(bases[1], tvals) if with_pre else None
    got, want = both_matmuls(bases, w, x_planes(xs), pre)
    assert np.array_equal(got, want)
    for kk in range(kout):
        row = ints_of(got[:, kk, :])
        for bb in range(b):
            terms = (w[kk][j] * xs[j][bb] * (tvals[j][bb] if with_pre else 1)
                     for j in range(k))
            assert row[bb] == sum(terms) % P


def test_crt_matmul_chunks_over_the_batch(bases):
    """A byte budget below the four product buffers splits the batch axis of
    the plain product; the values do not change."""
    rng = np.random.default_rng(4)
    kout, k, b = 3, 4, 8
    w = [rand_field(rng, k) for _ in range(kout)]
    xs = [rand_field(rng, b) for _ in range(k)]
    pre = pre_residues(bases[1], [rand_field(rng, b) for _ in range(k)])
    whole, want = both_matmuls(bases, w, x_planes(xs), pre)
    assert np.array_equal(whole, want)
    tb = bases[1]
    plan = crt.CrtMatmulPlan(tb, w, "cpu")
    x0, x1 = crt_cuda.residues_in(tb, interop.planes_from_numpy(x_planes(xs), "cpu"),
                                  torch.from_numpy(pre.astype(np.int16)))
    budget = 4 * len(tb.qs_host) * kout * 2 * 4  # two lanes of the batch a chunk
    s = crt_cuda.matmul_fold_plain(tb, plan, x0, x1, temp_bytes=budget)
    assert torch.equal(s, crt_cuda.matmul_fold_plain(tb, plan, x0, x1))
    chunked = crt_cuda.reconstruct(tb, s.reshape(s.shape[0], kout * b)).reshape(16, kout, b)
    assert np.array_equal(interop.planes_to_numpy(chunked), want)


def test_montgomery_domain_preserved(bases):
    """Montgomery-form inputs yield Montgomery-form outputs."""
    rng = np.random.default_rng(5)
    k = 4
    w = [rand_field(rng, k) for _ in range(k)]
    xs = rand_field(rng, k)
    xm = [[v * (R256 % P) % P] for v in xs]
    got, want = both_matmuls(bases, w, x_planes(xm))
    assert np.array_equal(got, want)
    for kk in range(k):
        expect = sum(w[kk][j] * xs[j] for j in range(k)) % P
        assert ints_of(got[:, kk, :])[0] == expect * (R256 % P) % P


def test_crt_matmul_edge_values(bases):
    """Extremes (0, 1, p-1, dense-limb patterns) stress the fold bounds,
    digit boundaries and the wrap-count recovery."""
    k = 8
    w = [[EDGE[(i + j) % len(EDGE)] for j in range(k)] for i in range(k)]
    xs = [[EDGE[(3 * i + b) % len(EDGE)] for b in range(4)] for i in range(k)]
    got, want = both_matmuls(bases, w, x_planes(xs))
    assert np.array_equal(got, want)
    for kk in range(k):
        assert ints_of(got[:, kk, :]) == [
            sum(w[kk][j] * xs[j][bb] for j in range(k)) % P for bb in range(4)]


def test_crt_matmul_pre_edge_values(bases):
    """Pre-table at q-1 extremes with near-p data."""
    k, b = 4, 4
    w = [[P - 1 - i * 7 - j for j in range(k)] for i in range(k)]
    tvals = [[P - 1 - 13 * t - i for t in range(b)] for i in range(k)]
    xs = [[P - 1 - 29 * t - 3 * i for t in range(b)] for i in range(k)]
    pre = pre_residues(bases[1], tvals)
    pre[:, 0, 0] = np.array(bases[1].qs_host, np.uint32) - 1
    got, want = both_matmuls(bases, w, x_planes(xs), pre)
    assert np.array_equal(got, want)
    for kk in range(k):
        row = ints_of(got[:, kk, :])
        for bb in range(1, b):
            assert row[bb] == sum(w[kk][j] * tvals[j][bb] * xs[j][bb] for j in range(k)) % P


def test_wrappers_refuse_wrong_operands(bases):
    _, tb = bases
    x = torch.zeros((16, 4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        crt_cuda.residues_in(tb, x.to(torch.int64))
    with pytest.raises(ValueError):
        crt_cuda.residues_in(tb, x, pre=torch.zeros((3, 4, 2), dtype=torch.int16))
    with pytest.raises(ValueError):
        crt_cuda.reconstruct(tb, torch.zeros((5, 8), dtype=torch.int32))
    plan = crt.CrtMatmulPlan(tb, [[1, 2, 3, 4]], "cpu")
    with pytest.raises(ValueError):
        crt.crt_matmul(tb, plan, torch.zeros((16, 5, 2), dtype=torch.int32))
    before = [f.launches for f in (crt_cuda.residues_in, crt_cuda.matmul_fold,
                                   crt_cuda.reconstruct)]
    crt.crt_matmul(tb, plan, x)  # CPU tensors: the plain versions, no launch
    assert before == [f.launches for f in (crt_cuda.residues_in, crt_cuda.matmul_fold,
                                           crt_cuda.reconstruct)]
