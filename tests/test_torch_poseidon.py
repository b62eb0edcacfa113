"""The port's Poseidon digest and its trees against the JAX package's.

`stark_tpu_torch/ops/poseidon.py` against `stark_tpu/ops/poseidon.py`: the
round constants and the MDS matrix, the host hash on the reference's four
known-answer messages, the plain permutation (what `poseidon_leaves` and
`poseidon_pairs` run on a CPU tensor) against `poseidon_hash_pairs`; the
tree layers of `merkle/tree.py build_layers_digest` against
`stark_tpu.merkle.tree._build_layers_poseidon` word for word, and branches
through the host walk. The CUDA kernel's constant table and round order are
modelled on python ints and held against the host hash, and so is the
permutation's optimized form (sparse partial rounds), whose products and
squarings `chip_smoke.py`'s operations bound counts. Inputs come from a
numpy seed, with 0, 1, BN254's r - 1 and BLS12-381's p - 1 among them.
Tolerance: exact equality (digests are bit patterns).
"""

import numpy as np
import pytest
import torch

from stark_tpu.fields.field import BLS12_381_FR as JBLS
from stark_tpu.merkle import tree as jmt
from stark_tpu.ops import modmath as jmm
from stark_tpu.ops import poseidon as jpos
from stark_tpu_torch.fields.field import BLS12_381_FR as BLS
from stark_tpu_torch.fields.field import BN254_FR as BN
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.merkle import tree as mt
from stark_tpu_torch.ops import blake2s as b2
from stark_tpu_torch.ops import poseidon as pos

torch.set_num_threads(2)

# `tests/test_poseidon.py`'s known answers: bytes(range(n)) zero-padded to 64
KATS = [
    (3, "b3a1a3cfaebc3a557d52dd3e25076f7f7b51f2bf46f5289d66c389b51477ec25"),
    (32, "0e67a788ec648e60632957f8d10b71f12fba0050a7688bdad9de2e78dbf5495b"),
    (63, "ddae0004ffee05d6da43777af82faa1f0c6ac08d7048f9a4ddf6d2b259f7075e"),
    (64, "93bde2916aec7310f6e07faa70f14ed0c173832adcc03aeaed230f94540f0632"),
]
EDGES = [0, 1, BN.p - 1, BLS.p - 1]


def _values(n: int, seed: int, bound: int) -> list[int]:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % bound for _ in range(n)]
    return (EDGES + vals)[:n] if n > 1 else vals


def _leaf_words(values: list[int]) -> np.ndarray:
    """32-byte little-endian leaves -> (16, n) uint32 words (blake padding)."""
    rows = np.frombuffer(b"".join(BN.to_bytes_le(v) for v in values), np.uint8)
    return b2.bytes_to_words_np(rows.reshape(len(values), 32), 32)


def test_constants_equal_the_jax_package():
    assert pos.round_constants() == jpos.round_constants()
    assert pos.mds_matrix() == jpos.mds_matrix()
    assert (pos.T, pos.FULL_ROUNDS, pos.PARTIAL_ROUNDS, pos.DOMAIN_TAG) == (
        jpos.T, jpos.FULL_ROUNDS, jpos.PARTIAL_ROUNDS, jpos.DOMAIN_TAG)


@pytest.mark.parametrize("n,want", KATS)
def test_host_digest_matches_the_kats_and_the_jax_package(n, want):
    msg = bytes(range(n)) + b"\x00" * (64 - n)
    assert pos.poseidon_digest(msg).hex() == want
    assert pos.poseidon_digest(msg[:n]) == jpos.poseidon_digest(msg[:n])


def test_host_digest_refuses_what_the_reference_panics_on():
    for msg in (b"", bytes(65), BLS.to_bytes_le(0)[:31] + b"\xff"):
        with pytest.raises(ValueError):
            pos.poseidon_digest(msg)
        with pytest.raises(ValueError):
            jpos.poseidon_digest(msg)


@pytest.mark.parametrize("n", [1, 5, 64])
def test_hash_pairs_plain_matches_the_jax_package(n):
    left, right = _values(n, 10 + n, BLS.p), _values(n, 20 + n, BLS.p)[::-1]
    ln, rn = jmm.ints_to_limbs_np(left, JBLS), jmm.ints_to_limbs_np(right, JBLS)
    want = np.asarray(jpos.poseidon_hash_pairs(JBLS, ln, rn))
    got = pos.poseidon_hash_pairs_plain(BLS, planes_from_numpy(ln, "cpu"),
                                        planes_from_numpy(rn, "cpu"))
    assert np.array_equal(planes_to_numpy(got), want)
    host = pos.poseidon_digest(BLS.to_bytes_le(left[0]) + BLS.to_bytes_le(right[0]))
    assert jmm.limbs_to_ints_np(want[:, :1], JBLS)[0] == int.from_bytes(host, "little")


@pytest.fixture(scope="module")
def tree16():
    """16 BN254 leaves, edge values first: the port's Poseidon layers and the
    JAX package's."""
    values = _values(16, 7, BN.p)
    words = _leaf_words(values)
    layers = mt.build_layers_digest(planes_from_numpy(words, "cpu"), 32, "poseidon")
    jlayers = jmt._build_layers_poseidon(words)
    return values, words, layers, jlayers


def test_layers_match_the_jax_package_word_for_word(tree16):
    values, words, layers, jlayers = tree16
    assert len(layers) == len(jlayers) == 5
    for got, want in zip(layers, jlayers):
        assert np.array_equal(planes_to_numpy(got), np.asarray(want))
    # the leaf layer is the host hash of each 32-byte leaf, as LE words
    leaf0 = pos.poseidon_digest(BN.to_bytes_le(values[3]))
    assert planes_to_numpy(layers[0])[:, 3].astype("<u4").tobytes() == leaf0


def test_branches_round_trip_through_the_host_walk(tree16):
    values, words, layers, _ = tree16
    leaves = [BN.to_bytes_le(v) for v in values]
    tree = mt.DeviceMerkleTree(planes_from_numpy(words, "cpu"), 32, layers)
    idx = [0, 3, 5, 15]
    flat = planes_to_numpy(tree.gather(torch.tensor(idx)))
    proofs = tree.proofs_from_flat(flat, len(idx))
    got = mt.verify_multi_branch(tree.root, idx, proofs, digest="poseidon")
    assert got == [leaves[i] for i in idx]
    assert mt.commit_root(leaves, "cpu", "poseidon") == tree.root
    with pytest.raises(ValueError):
        mt.validate_proof(proofs[1], tree.root, 2, digest="poseidon")  # wrong index
    with pytest.raises(ValueError):  # the blake walk on a Poseidon tree
        mt.verify_multi_branch(tree.root, idx, proofs)


def test_kernel_table_and_round_order_model_the_host_hash():
    """`csrc/poseidon.cu`'s thread form on python ints
    (`test_torch_poseidon_plan.thread_digest`): the optimized permutation's
    table decoded from `kernel_table`'s words, run in the kernel's order for
    leaves and pairs, against the host hash, the JAX package's host hash and
    its batched `poseidon_hash_pairs`; its products and squarings are
    `chip_smoke`'s bound's."""
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    chip_smoke = importlib.import_module("chip_smoke")
    from test_torch_poseidon_plan import Arith, thread_digest

    lefts = EDGES + _values(4, 31, BLS.p)
    rights = EDGES[::-1] + _values(4, 32, BLS.p)
    ln, rn = jmm.ints_to_limbs_np(lefts, JBLS), jmm.ints_to_limbs_np(rights, JBLS)
    batched = jmm.limbs_to_ints_np(np.asarray(jpos.poseidon_hash_pairs(JBLS, ln, rn)), JBLS)
    zeros = jmm.ints_to_limbs_np([0] * len(lefts), JBLS)
    batched_leaves = jmm.limbs_to_ints_np(
        np.asarray(jpos.poseidon_hash_pairs(JBLS, ln, zeros)), JBLS)
    for i, (left, right) in enumerate(zip(lefts, rights)):
        ar = Arith()
        got = thread_digest(left, right, False, ar)
        msg = BLS.to_bytes_le(left) + BLS.to_bytes_le(right)
        assert got == int.from_bytes(pos.poseidon_digest(msg), "little") == batched[i]
        assert pos.poseidon_digest(msg) == jpos.poseidon_digest(msg)
        assert (ar.products, ar.squarings) == chip_smoke.POSEIDON_PAIR_PRODUCTS
        ar = Arith()
        got = thread_digest(left, 0, True, ar)
        leaf = BLS.to_bytes_le(left)
        assert got == int.from_bytes(pos.poseidon_digest(leaf), "little") == batched_leaves[i]
        assert pos.poseidon_digest(leaf) == jpos.poseidon_digest(leaf)
        assert (ar.products, ar.squarings) == chip_smoke.POSEIDON_LEAF_PRODUCTS


def _counted_hash(left: int, right: int, leaf: bool, form) -> tuple[int, dict]:
    """Poseidon(tag, left, right)'s digest in the optimized form on python
    ints, counting products and squarings: round 0's S-box and matrix terms
    of the lanes that are the same in every hash (the tag, a leaf's 0) are
    constants, the last round's matrix makes the output lane alone."""
    p = BLS.p
    c, A, pre, sparse = form
    count = {"products": 0, "squarings": 0}

    def mul(a, b):
        count["products"] += 1
        return a * b % p

    def sbox(x):
        count["squarings"] += 2
        x4 = (x * x % p) ** 2 % p
        return mul(x4, x)

    def full(s, r, m):
        s = [sbox((x + k) % p) for x, k in zip(s, c[r])]
        return [sum(mul(m[j][i], s[i]) for i in range(3)) % p for j in range(3)]

    fixed = (0, 2) if leaf else (0,)
    s = [(x + k) % p for x, k in zip([pos.DOMAIN_TAG, left, 0 if leaf else right], c[0])]
    s = [pow(x, 5, p) if i in fixed else sbox(x) for i, x in enumerate(s)]
    s = [sum(A[j][i] * s[i] if i in fixed else mul(A[j][i], s[i]) for i in range(3)) % p
         for j in range(3)]
    for r in range(1, 4):
        s = full(s, r, pre if r == 3 else A)
    for r in range(4, 59):
        x0 = sbox((s[0] + c[r][0]) % p)
        a00, row0, col0 = sparse[r]
        s = [(mul(a00, x0) + mul(row0[0], s[1]) + mul(row0[1], s[2])) % p,
             (mul(col0[0], x0) + s[1]) % p, (mul(col0[1], x0) + s[2]) % p]
    for r in range(59, 62):
        s = full(s, r, A)
    s = [sbox((x + k) % p) for x, k in zip(s, c[62])]
    return sum(mul(A[1][i], s[i]) for i in range(3)) % p, count


def test_bound_counts_the_optimized_permutation():
    """`chip_smoke.py`'s operations bound counts the products and squarings
    of the optimized form; the form is the same permutation."""
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    chip_smoke = importlib.import_module("chip_smoke")
    form = pos.sparse_form()
    for leaf, want in ((False, chip_smoke.POSEIDON_PAIR_PRODUCTS),
                       (True, chip_smoke.POSEIDON_LEAF_PRODUCTS)):
        for left, right in [(0, 0), (1, BLS.p - 1), (BN.p - 1, 5), (123456789, 987654321)]:
            right = 0 if leaf else right
            got, count = _counted_hash(left, right, leaf, form)
            msg = BLS.to_bytes_le(left) + (BLS.to_bytes_le(right) if right else b"")
            assert got == int.from_bytes(pos.poseidon_digest(msg), "little")
            assert (count["products"], count["squarings"]) == want


def test_leaf_and_pair_wrappers_on_packed_words():
    values = _values(4, 3, BN.p)
    words = planes_from_numpy(_leaf_words(values), "cpu")
    leaves = pos.poseidon_leaves(words)
    assert leaves.shape == (8, 4) and leaves.dtype == torch.int32
    want = [pos.poseidon_digest(BN.to_bytes_le(v)) for v in values]
    assert [planes_to_numpy(leaves)[:, i].astype("<u4").tobytes() for i in range(4)] == want
    pairs = pos.poseidon_pairs(leaves)
    assert planes_to_numpy(pairs)[:, 1].astype("<u4").tobytes() == \
        pos.poseidon_digest(want[2] + want[3])
    assert torch.equal(pos._to_words(pos._to_limbs(leaves)), leaves)


def test_wrappers_and_trees_refuse_what_they_do_not_take():
    with pytest.raises(ValueError):
        pos.poseidon_pairs(torch.zeros((8, 3), dtype=torch.int32))  # odd width
    with pytest.raises(ValueError):
        pos.poseidon_leaves(torch.zeros((8, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        pos.poseidon_leaves(torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):  # no kernel and no plain version off the CPU
        pos.poseidon_pairs(torch.zeros((8, 4), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        mt.build_layers_digest(torch.zeros((16, 4), dtype=torch.int32), 40, "poseidon")
    with pytest.raises(ValueError):
        mt.build_layers_digest(torch.zeros((16, 4), dtype=torch.int32), 32, "sha256")
