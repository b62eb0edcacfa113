"""The plain versions of the port's fused-route kernels against the JAX
package's Pallas kernels themselves, run in interpret mode on the CPU: the
randomized combination, the three quotients, `sub_mul` and the leaf
packing; and what every fused wrapper refuses.

Each Pallas kernel is called directly (`pallas_kernels.q1_eval(spec, ...)`)
at a tiny width, n = 16. The same numpy-seeded inputs go through the port's wrapper, which on a CPU
tensor runs the plain PyTorch version. Tolerance: exact equality of the
uint32 values (integer field arithmetic with canonical outputs). Interpret
mode takes seconds per kernel, so the thirteen kernels are spread over
`test_torch_fused.py`, `test_torch_fused_loops.py`, `test_torch_fused_scan.py`,
`test_torch_fused_lincomb.py` and `test_torch_fused_shoup.py`, each under a
minute on one worker.
"""

import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BN254_FR as spec
from stark_tpu.ops import modmath as jmm
from stark_tpu.protocol import pallas_kernels as jpk
from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.protocol import fused_kernels as fk
from torch_fused_inputs import N, cols as _cols, eq as _eq, no_launch as _no_launch, t as _t

torch.set_num_threads(2)


def test_rand_combination_matches_pallas():
    (r,) = _cols(1, width=3)
    idx, perm, s = _cols(2, count=3)
    jn, jd = jpk.rand_combination(spec, r, idx, perm, s)
    tn, td = _no_launch(fk.rand_combination, _t(r), _t(idx), _t(perm), _t(s))
    _eq(tn, jn)
    _eq(td, jd)


@pytest.mark.parametrize("skips", [3])
def test_q1_matches_pallas(skips):
    s, k, p, f0, f1 = _cols(3, count=5)
    _eq(_no_launch(fk.q1_eval, *map(_t, (s, k, p, f0, f1)), skips),
        jpk.q1_eval(spec, s, k, p, f0, f1, skips))


@pytest.mark.parametrize("kshift", [5])
def test_q2_matches_pallas(kshift):
    p, f2 = _cols(4, count=2)
    _eq(_no_launch(fk.q2_eval, _t(p), _t(f2), kshift), jpk.q2_eval(spec, p, f2, kshift))


@pytest.mark.parametrize("skips", [3])
def test_q3_matches_pallas(skips):
    a, vn, vd = _cols(5, count=3)
    _eq(_no_launch(fk.q3_eval, _t(a), _t(vn), _t(vd), skips),
        jpk.q3_eval(spec, a, vn, vd, skips))


def test_sub_mul_matches_pallas_plane_and_column():
    a, b, c = _cols(12, count=3, edge=True)
    want = jpk.sub_mul(spec, a, b, c)
    _eq(_no_launch(fk.sub_mul, _t(a), _t(b), _t(c)), want)
    one = np.asarray(jmm.mont_one(spec))  # (16, 1): the column form of b
    want_col = jpk.sub_mul(spec, a, np.broadcast_to(one, a.shape), c)
    _eq(_no_launch(fk.sub_mul, _t(a), _t(one), _t(c)), want_col)


def test_from_mont_pack_words_matches_pallas():
    (col,) = _cols(13, edge=True)
    want = np.asarray(jpk.from_mont_pack_words(spec, col))
    assert (want >> 31).any()  # words with bit 31 set: negative as int32
    _eq(_no_launch(fk.from_mont_pack_words, _t(col)), want)
    buf = torch.full((16, N), -1, dtype=torch.int32)
    got = fk.from_mont_pack_words(tspec, _t(col), out=buf[8:16])
    assert got.data_ptr() == buf[8:16].data_ptr()
    _eq(buf[8:16], want)
    assert (buf[:8] == -1).all()  # the other rows of the leaf buffer are untouched


WRAPPER_ARGS = {
    "rand_combination": lambda c: (c(3), c(N), c(N), c(N)),
    "q1_eval": lambda c: (c(N), c(N), c(N), c(N), c(N), 1),
    "q2_eval": lambda c: (c(N), c(N), 1),
    "q3_eval": lambda c: (c(N), c(N), c(N), 1),
    "linear_combination": lambda c: (c(11), *[c(N) for _ in range(9)]),
    "horner_eval": lambda c: (c(2), c(N)),
    "vanishing_eval": lambda c: (c(N), c(2)),
    "sub_mul": lambda c: (c(N), c(N), c(N)),
    "from_mont_pack_words": lambda c: (c(N),),
}


@pytest.mark.parametrize("name", sorted(WRAPPER_ARGS))
def test_wrappers_refuse_what_the_kernels_do_not_take(name):
    """A view, a wrong type or a mismatched width raises before any route is
    chosen: the wrappers never copy behind the caller's back."""
    wrapper = getattr(fk, name)
    make = lambda w: _t(_cols(17, width=w)[0])  # noqa: E731
    args = list(WRAPPER_ARGS[name](make))
    plane = next(i for i, a in enumerate(args) if torch.is_tensor(a) and a.shape[1] == N)
    bad = list(args)
    bad[plane] = _t(_cols(18, width=2 * N)[0])[:, ::2]  # a strided view
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(tspec, *bad)
    bad = list(args)
    bad[plane] = args[plane].to(torch.int64)
    with pytest.raises(TypeError):
        wrapper(tspec, *bad)
    if sum(torch.is_tensor(a) and a.shape[1] == N for a in args) > 1:
        bad = list(args)
        bad[plane] = _t(_cols(19, width=2 * N)[0])
        with pytest.raises(ValueError, match="width"):
            wrapper(tspec, *bad)
