"""The roofline counts against the kernel table's bounds at 2^20 (PERF.md),
and each phase's count at the cells' sizes."""

from __future__ import annotations

import pytest

from benchmark import counts
from benchmark.counts import columns, commits
from benchmark.peaks import roofline_s


def ms(ops=0, nbytes=0):
    return 1e3 * roofline_s(ops, nbytes)


def test_row_4_blake2s_leaves():
    # 2^20 leaves of 256 bytes: 0.2404 ms of operations
    assert ms(counts.blake2s_compressions(2**20, 256) * counts.BLAKE2S) == pytest.approx(
        0.2404, abs=5e-5)


def test_row_3_fused_butterflies():
    # 2^20 points, block 2048: 11 stages, 0.0468 ms of operations
    assert ms(counts.butterflies(2**20, 11) * counts.MONT) == pytest.approx(0.0468, abs=5e-5)


def test_row_2_pass_run_bytes():
    # 3 passes over a (16, 2^20) int32 column read and written, 18.3 MiB of tables
    assert ms(nbytes=3 * 2 * 2**20 * 64 + 18.3 * 2**20) == pytest.approx(0.1259, abs=5e-5)


def test_row_p_poseidon_leaves():
    assert ms(2**20 * counts.POSEIDON_LEAF) == pytest.approx(4.549, abs=5e-4)


def test_phase_counts_at_the_cells_sizes():
    b23 = {"steps": 2**20, "precision": 2**23, "public_points": 1, "digest": "blake2s"}
    p22 = {"steps": 2**19, "precision": 2**22, "public_points": 1, "digest": "poseidon"}
    # columns: operations bound (about 3.6 ms at 2^23)
    ops, nbytes = columns.work(b23)
    assert ops / 16.75e12 > nbytes / 3.35e12
    assert 3.0 < ms(ops, nbytes) < 4.5
    # commits: Blake2s trees about 4 ms at 2^23; Poseidon's l-tree leads at 2^22
    assert 3.5 < ms(*commits.work(b23)) < 4.5
    assert 35 < ms(*commits.work(p22)) < 40
    # a larger LDE costs more, and the count is independent of the digest
    assert columns.work(p22)[0] < columns.work(b23)[0]
