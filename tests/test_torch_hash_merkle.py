"""The port's Blake2s and Merkle trees against hashlib and the JAX package.

`blake2s_words_plain` (what the wrapper runs on a CPU tensor) is held
against `hashlib.blake2s` and `stark_tpu.ops.blake2s.blake2s_words` for 1-4
block messages, including the 40-byte a-tree leaves; the port's tree
layers, branch gathers and `verify_multi_branch` against
`stark_tpu.merkle.tree`. Inputs come from a numpy seed. Tolerance: exact
equality (hash digests and gathered words are bit patterns).
"""

import hashlib

import numpy as np
import pytest
import torch

from stark_tpu.merkle import tree as jmt
from stark_tpu.ops import blake2s as jb2
from stark_tpu_torch.interop import planes_from_numpy, planes_to_numpy
from stark_tpu_torch.merkle import tree as mt
from stark_tpu_torch.ops import blake2s as b2

torch.set_num_threads(2)


def _msgs(n: int, msg_len: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, msg_len), dtype=np.uint8)


@pytest.mark.parametrize("msg_len", [0, 4, 32, 33, 40, 64, 65, 128, 200, 256])
def test_blake2s_matches_hashlib_and_jax(msg_len):
    msgs = _msgs(24, msg_len, seed=msg_len)
    words = b2.bytes_to_words_np(msgs, msg_len)
    assert np.array_equal(words, jb2.bytes_to_words_np(msgs, msg_len))
    got = b2.blake2s_words(planes_from_numpy(words, "cpu"), msg_len)
    assert np.array_equal(planes_to_numpy(got), np.asarray(jb2.blake2s_words(words, msg_len)))
    digests = b2.digest_words_to_bytes_np(planes_to_numpy(got))
    for i in range(msgs.shape[0]):
        assert digests[i].tobytes() == hashlib.blake2s(msgs[i].tobytes()).digest()


def test_blake2s_wrapper_checks_rows():
    with pytest.raises(ValueError):
        b2.blake2s_words(torch.zeros((16, 4), dtype=torch.int32), 65)  # needs 32 rows
    with pytest.raises(ValueError):
        b2.blake2s_words(torch.zeros((16, 4), dtype=torch.int64), 32)


@pytest.mark.parametrize("leaf_bytes", [32, 40, 256])
def test_layers_gather_and_branches_match_jax(leaf_bytes):
    n = 64
    leaves = _msgs(n, leaf_bytes, seed=100 + leaf_bytes)
    words = b2.bytes_to_words_np(leaves, leaf_bytes)
    jlayers = jmt._build_layers(words, leaf_bytes)
    layers = mt.build_layers(planes_from_numpy(words, "cpu"), leaf_bytes)
    assert len(layers) == len(jlayers)
    for got, want in zip(layers, jlayers):
        assert np.array_equal(planes_to_numpy(got), np.asarray(want))

    idx = np.random.default_rng(7).integers(0, n, size=20)
    jflat = np.asarray(
        jmt._gather_flat_j(words, tuple(jlayers[:-1]), np.asarray(idx, np.int32))
    )
    flat = mt.gather_flat(planes_from_numpy(words, "cpu"), layers[:-1], torch.from_numpy(idx))
    assert np.array_equal(planes_to_numpy(flat), jflat)

    tree = mt.commit_words(planes_from_numpy(words, "cpu"), leaf_bytes)
    jtree = jmt.commit_np(leaves)
    assert tree.root == jtree.root
    assert mt.commit_root([bytes(r) for r in leaves], "cpu") == jtree.root
    proofs = tree.proofs_from_flat(planes_to_numpy(tree.gather(torch.from_numpy(idx))), len(idx))
    jproofs = jtree.gen_proofs(idx)
    assert [(p.leaf, p.nodes) for p in proofs] == [(p.leaf, p.nodes) for p in jproofs]
    assert mt.verify_multi_branch(tree.root, idx, proofs) == jmt.verify_multi_branch(
        jtree.root, idx, jproofs
    )


def test_verify_multi_branch_rejects_tampering():
    leaves = _msgs(16, 32, seed=9)
    tree = mt.commit_words(planes_from_numpy(b2.bytes_to_words_np(leaves, 32), "cpu"), 32)
    (proof,) = tree.proofs_from_flat(planes_to_numpy(tree.gather(torch.tensor([5]))), 1)
    with pytest.raises(ValueError):
        mt.verify_multi_branch(tree.root, [4], [proof])  # wrong index
    bad = mt.MerkleProof(bytes([proof.leaf[0] ^ 1]) + proof.leaf[1:], proof.nodes)
    with pytest.raises(ValueError):
        mt.verify_multi_branch(tree.root, [5], [bad])
