"""The `compute` goldens on a mesh of CPU ranks (`tests/torch_mesh.py`:
gloo, one OS process a rank), one run of the ranks a mesh size
(`torch_mesh.golden_proofs_body`):

* the `compute` fixture, proved from its files by
  `prove_full.prove_files_sharded` on `distributed.run_ranks` (OS
  processes, as the JAX package's `tests/test_multihost.py:55` runs its
  two) at d = 2 on the `dft` fold and d = 4 on `lagrange`: every rank's proof equals the
  committed golden (`compute_proof_golden.json`);
* the same at d = 2 under digest="poseidon" (the l-tree sharded on the
  Poseidon pair, FRI's trees replicated): every rank's proof equals the
  committed golden (`compute_proof_poseidon_golden.json`);
* at d = 2 with `lde_engine="crt"` through `runner.prove_with_witness(mesh=)`
  (the local DFTs of the four-step transforms on the CRT engine, the JAX
  package's `_use_mesh_mxu` route): every rank's proof equals the
  single-device proof and the golden.

`prove_many(mesh=)` is in `test_torch_parallel_prove_many.py`.

Tolerance: exact (byte-identical JSON).
"""

import functools
import os
import tempfile

import pytest
import torch

from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness

import torch_mesh

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
JOBS = {  # d -> (digest, fri_fold, lde_engine) of each proof of its run
    2: [("blake2s", "dft", "butterfly"), ("poseidon", "dft", "butterfly"),
        ("blake2s", "dft", "crt")],
    4: [("blake2s", "lagrange", "butterfly")],
}


@functools.lru_cache(maxsize=None)
def _proofs(d: int) -> dict:
    """(digest, fri_fold, lde_engine) -> every rank's proof JSON, from one
    run of d ranks."""
    with tempfile.TemporaryDirectory() as cache:
        ranks = torch_mesh.run_procs(torch_mesh.golden_proofs_body, d,
                                     os.path.join(FIX, "compute.r1cs"),
                                     os.path.join(FIX, "compute.wtns"), JOBS[d], cache,
                                     bodies=len(JOBS[d]))
    return {job: [rk[i] for rk in ranks] for i, job in enumerate(JOBS[d])}


def _golden(name: str) -> str:
    with open(os.path.join(FIX, name)) as f:
        return f.read()


@pytest.mark.parametrize("d,fri_fold,digest,golden", [
    (2, "dft", "blake2s", "compute_proof_golden.json"),
    (4, "lagrange", "blake2s", "compute_proof_golden.json"),
    (2, "dft", "poseidon", "compute_proof_poseidon_golden.json"),
])
def test_ranks_prove_the_compute_golden_from_files(d, fri_fold, digest, golden):
    assert _proofs(d)[(digest, fri_fold, "butterfly")] == [_golden(golden)] * d


def test_crt_on_a_mesh_proves_the_single_device_proof(tmp_path, monkeypatch):
    from stark_tpu_torch.ops import plan_cache

    monkeypatch.setattr(plan_cache, "CACHE_DIR", str(tmp_path))
    with open(os.path.join(FIX, "compute.r1cs"), "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(os.path.join(FIX, "compute.wtns"), "rb") as f:
        witness = read_witness(f.read())
    single = proof_mod.to_json(runner.prove_with_witness(r1cs, witness, device="cpu",
                                                         lde_engine="crt"))
    assert single == _golden("compute_proof_golden.json")
    assert _proofs(2)[("blake2s", "dft", "crt")] == [single] * 2
