"""What the mesh refuses, each with a clear error and nothing run:

* `mesh=` that is not a `DomainMesh`: TypeError (the two refusals of
  `test_torch_e2e.py` and `test_torch_prove_many.py` that expected
  NotImplementedError before the mesh was ported now expect this);
* a mesh whose size is not a power of two, and steps < d^2 (the
  four-step NTT's least size, `stark_tpu/protocol/prove.py:190-194`):
  ValueError;
* `lde_engine="crt"` on a mesh outside the JAX package's gate
  (`stark_tpu/parallel/prove_sharded.py:143-160 _use_mesh_mxu`, where it
  runs butterflies instead): a local precision/d above 2^20 or steps/d
  below 4, ValueError naming the limit, before any work;
* a mesh on another device than the prove's `device`: ValueError;
* "nccl" with more ranks than cards, or a rank not on its own card
  (cuda:rank), refused by `initialize` before any group is made (with a
  faked card count where the host has none); an unknown backend, a rank
  outside the mesh, a several-rank mesh without a rendezvous;
* `run_ranks` raises the exception of a rank that fails, with its
  traceback, and stops the others (blocked in a collective) at once.

The refused meshes are `DomainMesh` objects with no group: every refusal
comes before the first collective.
"""

import os

import pytest
import torch

from stark_tpu_torch.parallel import distributed
from stark_tpu_torch.parallel.distributed import DomainMesh
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness

import torch_mesh

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module")
def compute():
    with open(os.path.join(FIX, "compute.r1cs"), "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(os.path.join(FIX, "compute.wtns"), "rb") as f:
        return r1cs, read_witness(f.read())


def _mesh(size: int, device="cpu") -> DomainMesh:
    return DomainMesh(0, size, torch.device(device), None, "gloo", False)


@pytest.mark.parametrize("entry", ["prove_with_witness", "prove_many"])
def test_a_non_mesh_object_is_a_type_error(compute, entry):
    r1cs, witness = compute
    args = (r1cs, witness) if entry == "prove_with_witness" else (r1cs, [witness])
    with pytest.raises(TypeError, match="DomainMesh"):
        getattr(runner, entry)(*args, mesh=object(), device="cpu")


@pytest.mark.parametrize("size,match", [(3, "power of two"), (16, r"steps >= d\^2")])
def test_mesh_sizes_the_prover_refuses(compute, size, match):
    with pytest.raises(ValueError, match=match):
        runner.prove_with_witness(*compute, mesh=_mesh(size), device="cpu")


@pytest.mark.parametrize("steps,precision,match", [
    (1 << 19, 1 << 22, r"precision/d <= 2\^20"),
    (4, 32, r"steps/d >= 4"),
])
def test_crt_on_a_mesh_outside_the_gate_names_the_limit(steps, precision, match):
    from stark_tpu_torch.fields.field import BN254_FR
    from stark_tpu_torch.protocol.core import build_proof_stages

    with pytest.raises(ValueError, match=match):
        build_proof_stages(BN254_FR, steps, precision, steps - 1, "blake2s", "cpu",
                           lde_engine="crt", mesh=_mesh(2))


def test_the_mesh_device_must_be_the_prove_device(compute, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="cuda:0"):
        runner.prove_with_witness(*compute, mesh=_mesh(2), device="cuda")


@pytest.mark.parametrize("cards,rank,device,match", [
    (1, 0, "cuda:0", "a card a rank"),
    (2, 1, "cuda:0", "runs on cuda:1"),
])
def test_nccl_needs_a_card_a_rank(monkeypatch, cards, rank, device, match):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(ValueError, match=match):
        distributed.initialize(rank, 2, "tcp://127.0.0.1:1", backend="nccl", device=device)


@pytest.mark.parametrize("kwargs,match", [
    ({"backend": "mpi"}, "backend"),
    ({"rank": 2}, "outside"),
    ({}, "init_method or group"),
    ({"init_method": "env://"}, "tcp://host:port"),
])
def test_initialize_refuses(kwargs, match):
    args = {"rank": 0, "world_size": 2, "device": "cpu", **kwargs}
    with pytest.raises(ValueError, match=match):
        distributed.initialize(**args)


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        torch_mesh.run_procs(torch_mesh.failing_body, 2)
