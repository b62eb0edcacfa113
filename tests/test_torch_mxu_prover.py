"""The prover, the verifier and the worker on the CRT LDE engine
(`lde_engine="crt"`), on the CPU at the small scale.

* `squaring_chain(20)` proved on "crt" equals the butterfly proof, and the
  `compute` fixture proved on "crt" equals its committed golden, the JAX
  package's proof (`tests/test_e2e.py` makes it; `test_torch_e2e.py` holds
  the butterfly route to it), as JSON text; the JAX package's own
  `tests/test_mxu_prover.py` holds its engine's proof to its butterflies';
* the `compute` golden is byte-identical on "crt", through the runner, the
  CLI and `prove_many`;
* the verifier on "crt" accepts the proof and rejects one with a flipped
  byte;
* an unknown engine name raises before any work at every entry point;
* the worker takes `lde_engine`: warmup, prove and verify run on it.

The engine's plan cache goes in a `tmp_path`. Tolerance: exact
(byte-identical JSON).
"""

import io
import json
import os

import pytest
import torch

from stark_tpu_torch import cli, serve
from stark_tpu_torch.ops import plan_cache
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import prove, runner
from stark_tpu_torch.protocol.params import derive_params
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness
from stark_tpu_torch.r1cs.synth import squaring_chain

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
R1CS = os.path.join(FIX, "compute.r1cs")
WTNS = os.path.join(FIX, "compute.wtns")


@pytest.fixture(autouse=True)
def caches(tmp_path_factory, monkeypatch):
    """The engine's plan cache in a directory of this test run."""
    base = tmp_path_factory.getbasetemp()
    monkeypatch.setattr(plan_cache, "CACHE_DIR", str(base / "plans"))


@pytest.fixture(scope="module")
def compute():
    with open(R1CS, "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(WTNS, "rb") as f:
        witness = read_witness(f.read())
    with open(os.path.join(FIX, "compute_proof_golden.json")) as f:
        golden = f.read()
    return r1cs, witness, golden


def test_crt_proof_equals_butterfly_and_jax(compute):
    r1cs, witness = squaring_chain(20)
    base = proof_mod.to_json(runner.prove_with_witness(r1cs, witness, device="cpu"))
    crt = proof_mod.to_json(
        runner.prove_with_witness(r1cs, witness, device="cpu", lde_engine="crt"))
    assert crt == base
    assert prove._stages_cached.cache_info().currsize >= 2  # one stage set per engine
    c_r1cs, c_witness, golden = compute
    assert proof_mod.to_json(runner.prove_with_witness(
        c_r1cs, c_witness, device="cpu", lde_engine="crt")) == golden
    proof = proof_mod.from_json(crt)
    assert runner.verify_with_witness(r1cs, witness[:2], proof, device="cpu",
                                      lde_engine="crt")
    assert runner.verify_with_witness(r1cs, witness[:2], proof, device="cpu")


def test_compute_golden_on_crt(compute, tmp_path):
    r1cs, witness, golden = compute
    proof = runner.prove_with_witness(r1cs, witness, device="cpu", lde_engine="crt")
    assert proof_mod.to_json(proof) == golden
    many = runner.prove_many(r1cs, [witness, witness], device="cpu", lde_engine="crt",
                             fri_fold="lagrange")
    assert [proof_mod.to_json(p) for p in many] == [golden, golden]
    out = str(tmp_path / "proof.json")
    assert cli.main(["run", R1CS, WTNS, out, "--device", "cpu", "--lde-engine", "crt"]) == 0
    with open(out) as f:
        assert f.read() == golden
    assert cli.main(["verify", R1CS, WTNS, out, "--device", "cpu", "--lde-engine", "crt"]) == 0
    with pytest.raises(SystemExit):
        cli.main(["prove", R1CS, WTNS, out, "--device", "cpu", "--lde-engine", "mxu"])


def test_verifier_on_crt_rejects_a_flipped_byte(compute):
    r1cs, witness, golden = compute
    n_pub = runner._n_pub(r1cs)
    good = proof_mod.from_json(golden)
    assert runner.verify_with_witness(r1cs, witness[:n_pub], good, device="cpu",
                                      lde_engine="crt")
    bad = proof_mod.from_json(golden)
    leaf = bytearray(bad.main_branches[0].leaf)
    leaf[5] ^= 1
    bad.main_branches[0].leaf = bytes(leaf)
    with pytest.raises((ValueError, AssertionError)):
        runner.verify_with_witness(r1cs, witness[:n_pub], bad, device="cpu",
                                   lde_engine="crt")
    wrong_public = [witness[0], bytes([7]) + witness[1][1:]] + list(witness[2:n_pub])
    with pytest.raises((ValueError, AssertionError)):
        runner.verify_with_witness(r1cs, wrong_public, good, device="cpu", lde_engine="crt")


@pytest.mark.parametrize("entry", ["prove_with_witness", "prove_many", "verify_with_witness",
                                   "serve", "build_proof_stages"])
def test_unknown_engine_raises(compute, entry):
    r1cs, witness, golden = compute
    with pytest.raises(ValueError, match="lde_engine"):
        if entry == "prove_with_witness":
            runner.prove_with_witness(r1cs, witness, device="cpu", lde_engine="mxu")
        elif entry == "prove_many":
            runner.prove_many(r1cs, [witness], device="cpu", lde_engine="mxu")
        elif entry == "verify_with_witness":
            runner.verify_with_witness(r1cs, witness[:2], proof_mod.from_json(golden),
                                       device="cpu", lde_engine="mxu")
        elif entry == "serve":
            serve.serve(io.StringIO(""), io.StringIO(), device="cpu", lde_engine="mxu")
        else:
            from stark_tpu_torch.fields.field import BN254_FR
            from stark_tpu_torch.protocol.core import build_proof_stages

            build_proof_stages(BN254_FR, 16, 128, 15, "blake2s", "cpu", lde_engine="mxu")


def test_worker_takes_the_engine(compute, tmp_path):
    golden = compute[2]
    pj = str(tmp_path / "worker.json")
    files = {"r1cs": R1CS, "wtns": WTNS}
    requests = [
        {"id": 1, "method": "warmup", "params": {"r1cs": R1CS}},
        {"id": 2, "method": "prove", "params": {**files, "inline": True}},
        {"id": 3, "method": "run", "params": {**files, "proof_json": pj}},
        {"id": 4, "method": "verify", "params": {**files, "proof_json": pj}},
        {"id": 5, "method": "shutdown"},
    ]
    out = io.StringIO()
    stdin = io.StringIO("\n".join(json.dumps(r) for r in requests) + "\n")
    assert serve.serve(stdin, out, device="cpu", lde_engine="crt") == 0
    replies = [json.loads(line[4:]) for line in out.getvalue().splitlines()]
    by_id = {r["id"]: r for r in replies[1:]}
    assert by_id[1]["result"]["steps"] == 16 and by_id[1]["result"]["warmed"] > 0
    assert by_id[2]["result"]["proof"] == golden
    assert by_id[3]["result"]["verified"] is True
    assert by_id[4]["result"]["verified"] is True
    with open(pj) as f:
        assert f.read() == golden
    spec = runner._spec_for(compute[0])
    arith = runner._static_arith(spec, compute[0])
    params = derive_params(spec, arith.original_steps)
    hits = prove._stages_cached.cache_info().hits
    stages = prove._stages_cached(spec, params.steps, params.precision, arith.original_steps,
                                  "blake2s", torch.device("cpu"), "crt")
    assert stages["lde_engine"] == "crt"
    assert prove._stages_cached.cache_info().hits == hits + 1  # the worker's stage set
