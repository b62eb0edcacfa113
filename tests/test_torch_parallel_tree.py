"""`ShardedMerkleTree` on a mesh of d = 2 and 4 CPU ranks
(`tests/torch_mesh.py`: gloo, one process a rank): the root and `gather` at
indices on the chunks' edges (0, N - 1, the first and last leaf of every
chunk) and inside them equal `tree.build_layers_digest` and
`tree.gather_flat` on the whole tree: 256-byte leaves under blake2s (the
m-tree), 32-byte leaves under blake2s and Poseidon (the l-tree).

Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch.fields.field import BN254_FR as tspec
from stark_tpu_torch.interop import planes_to_numpy
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.protocol.core import leaves_to_words

import torch_mesh

torch.set_num_threads(2)

LEAVES = 64


def _words(seed: int, n_cols: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    cols = [mm.mont_consts(tspec, [int(v) for v in rng.integers(0, 1 << 62, LEAVES)], "cpu")
            for _ in range(n_cols)]
    return planes_to_numpy(leaves_to_words(tspec, cols))


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_tree_root_and_branches(d):
    m = LEAVES // d
    edges = [i for r in range(d) for i in (r * m, r * m + m - 1)]
    idx = np.array(edges + [LEAVES - 1, 0, 5, m + 3, LEAVES - 2], dtype=np.int64)
    jobs = [(_words(1, 8), 256, "blake2s"), (_words(2, 1), 32, "blake2s"),
            (_words(3, 1), 32, "poseidon")]
    ranks = torch_mesh.run_procs(torch_mesh.tree_body, d, jobs, idx)
    for j, (words, leaf_bytes, digest) in enumerate(jobs):
        root, flat = torch_mesh.whole_tree(words, leaf_bytes, digest, idx)
        for rk in ranks:
            assert np.array_equal(rk[j][0], root), digest
            assert np.array_equal(rk[j][1], flat), digest
