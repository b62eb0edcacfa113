"""The verifier's LDE cache on the CPU, on the `compute` fixture.

The 6 circuit-static public-column LDEs (K, F0, F1, F2, idx, perm) depend on
the circuit alone, so `verify_with_witness` keeps them on the parsed circuit
for the next verify, as the JAX runner does (`stark_tpu/protocol/runner.py:
258-276`; the port takes `verify_cache=` where the JAX package reads
`STARK_TPU_VERIFY_CACHE`):

* a second verify of one circuit makes no `lde_many` call (counted through
  the stage set the verifier takes), and still rejects a tampered proof and
  wrong public inputs;
* `verify_cache=False` keeps nothing and extends the columns every time;
* the cache is keyed by device: an entry for another device is not used;
* the size gate is the JAX package's (6 planes within 512 MiB).

Tolerance: exact (the verifier's accept or reject).
"""

import os

import pytest
import torch

from stark_tpu_torch import device as devmod
from stark_tpu_torch.fields.field import BN254_FR as spec
from stark_tpu_torch.merkle.tree import MerkleProof
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import prove, runner
from stark_tpu_torch.protocol.params import derive_params
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness

torch.set_num_threads(2)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _circuit():
    """A freshly parsed `compute` circuit (no cache on it yet), its public
    wires and the golden proof."""
    with open(os.path.join(FIX, "compute.r1cs"), "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(os.path.join(FIX, "compute.wtns"), "rb") as f:
        witness = read_witness(f.read())
    with open(os.path.join(FIX, "compute_proof_golden.json")) as f:
        golden = f.read()
    return r1cs, witness[: runner._n_pub(r1cs)], golden


@pytest.fixture
def lde_calls(monkeypatch):
    """Counts the calls of the verifier's `lde_many`, in the stage set it
    takes for `compute` on the CPU."""
    r1cs, _, _ = _circuit()
    arith = runner._static_arith(spec, r1cs)
    params = derive_params(spec, arith.original_steps)
    stages = prove._stages_cached(spec, params.steps, params.precision,
                                  arith.original_steps, "blake2s",
                                  devmod.resolve("cpu"), "butterfly")
    calls = []
    inner = stages["lde_many"]

    def counted(ts):
        calls.append(len(ts))
        return inner(ts)

    monkeypatch.setitem(stages, "lde_many", counted)
    return calls


def test_second_verify_makes_no_lde_call(lde_calls):
    r1cs, pub, golden = _circuit()
    proof = proof_mod.from_json(golden)
    assert runner.verify_with_witness(r1cs, pub, proof, device="cpu")
    assert lde_calls == [6]
    assert list(r1cs._torch_ev_cache) == ["cpu"]
    assert runner.verify_with_witness(r1cs, pub, proof, device="cpu")
    assert lde_calls == [6]


def test_warm_cache_still_rejects(lde_calls):
    r1cs, pub, golden = _circuit()
    assert runner.verify_with_witness(r1cs, pub, proof_mod.from_json(golden), device="cpu")
    tampered = proof_mod.from_json(golden)
    b = tampered.linear_comb_branches[0]
    tampered.linear_comb_branches[0] = MerkleProof(bytes([b.leaf[0] ^ 1]) + b.leaf[1:],
                                                   list(b.nodes))
    with pytest.raises((ValueError, AssertionError)):
        runner.verify_with_witness(r1cs, pub, tampered, device="cpu")
    # the checks that read the cached columns: the boundary at the public wires
    wrong = list(pub)
    wrong[1] = spec.to_bytes_le((spec.from_bytes_le(pub[1]) + 1) % spec.p)
    with pytest.raises(AssertionError, match="B2"):
        runner.verify_with_witness(r1cs, wrong, proof_mod.from_json(golden), device="cpu")
    assert lde_calls == [6]


def test_verify_cache_false_keeps_nothing(lde_calls):
    r1cs, pub, golden = _circuit()
    for _ in range(2):
        assert runner.verify_with_witness(r1cs, pub, proof_mod.from_json(golden),
                                          device="cpu", verify_cache=False)
    assert lde_calls == [6, 6]
    assert getattr(r1cs, "_torch_ev_cache", None) is None


def test_cache_is_keyed_by_device(lde_calls):
    r1cs, pub, golden = _circuit()
    r1cs._torch_ev_cache = {"cuda:0": None, "meta": ["not the CPU's columns"]}
    assert runner.verify_with_witness(r1cs, pub, proof_mod.from_json(golden), device="cpu")
    assert lde_calls == [6]
    assert r1cs._torch_ev_cache["meta"] == ["not the CPU's columns"]
    assert len(r1cs._torch_ev_cache["cpu"]) == 6


@pytest.mark.parametrize("log_precision,fits", [(7, True), (20, True), (21, False)])
def test_size_gate_is_the_jax_runners(log_precision, fits):
    # 6 * 16 limbs * 4 bytes * precision <= 512 MiB: 402 MB at 2^20
    assert runner.verify_cache_fits(spec, 1 << log_precision) is fits
