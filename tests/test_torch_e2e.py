"""End to end through the port's runner on the CPU.

* the port's prove of the `compute` fixture is byte-identical to the
  committed golden (`compute_proof_golden.json`);
* the port's verifier accepts the golden and rejects tampered proofs (the
  mutation kinds of `tests/test_adversarial.py`);
* the port's proof codec round-trips the golden;
* importing every `stark_tpu_torch` module loads no `jax`;
* `device="cuda"` without a card raises RuntimeError: nothing falls back
  to the CPU by itself.

Tolerance: exact (byte-identical JSON).
"""

import os
import subprocess
import sys

import pytest
import torch

from stark_tpu_torch import cli
from stark_tpu_torch.fields.field import BN254_FR as spec
from stark_tpu_torch.fri.fri import FriLast, FriMiddle
from stark_tpu_torch.merkle.tree import MerkleProof
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
GOLDEN = os.path.join(FIX, "compute_proof_golden.json")


@pytest.fixture(scope="module")
def compute():
    with open(os.path.join(FIX, "compute.r1cs"), "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(os.path.join(FIX, "compute.wtns"), "rb") as f:
        witness = read_witness(f.read())
    with open(GOLDEN) as f:
        golden = f.read()
    n_pub = 1 + r1cs.header.n_public_inputs + r1cs.header.n_public_outputs
    return r1cs, witness[:n_pub], golden


def test_cli_prove_matches_golden(tmp_path):
    out = str(tmp_path / "proof.json")
    assert cli.main(["run", os.path.join(FIX, "compute.r1cs"),
                     os.path.join(FIX, "compute.wtns"), out, "--device", "cpu"]) == 0
    with open(out) as f, open(GOLDEN) as g:
        assert f.read() == g.read()


def test_codec_roundtrips_golden(compute):
    assert proof_mod.to_json(proof_mod.from_json(compute[2])) == compute[2]


def test_verifier_accepts_golden(compute):
    r1cs, pub, golden = compute
    assert runner.verify_with_witness(r1cs, pub, proof_mod.from_json(golden), device="cpu")


def _flip(b: bytes, i: int = 0) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1 :]


def _m_root(p):
    p.m_root = _flip(p.m_root)


def _leaf(p):
    b = p.main_branches[0]
    p.main_branches[0] = MerkleProof(_flip(b.leaf), list(b.nodes))


def _swap(p):
    lc = p.linear_comb_branches
    lc[0], lc[1] = lc[1], lc[0]


def _short_root(p):
    p.a_root = p.a_root[:31]


def _truncated_branches(p):
    del p.main_branches[17]


def _sibling_size(p):
    b = p.linear_comb_branches[0]
    p.linear_comb_branches[0] = MerkleProof(b.leaf, [b.nodes[0][:31]] + list(b.nodes[1:]))


def _short_path(p):
    b = p.linear_comb_branches[0]
    p.linear_comb_branches[0] = MerkleProof(b.leaf, list(b.nodes[:-1]))


def _fri_rounds(p):
    p.fri_proof = [FriMiddle(b"\x00" * 32, [], [])] + p.fri_proof


def _fri_last_value(p):
    last = p.fri_proof[-1]
    p.fri_proof[-1] = FriLast(list(last.last[:5]) + [_flip(last.last[5])] + list(last.last[6:]))


def _fri_noncanonical(p):
    last = p.fri_proof[-1]
    big = (spec.from_bytes_le(last.last[0]) + spec.p).to_bytes(32, "little")
    p.fri_proof[-1] = FriLast([big] + list(last.last[1:]))


def _fri_column_branch(p):
    mid = p.fri_proof[0]
    b = mid.column_branches[3]
    mid.column_branches[3] = MerkleProof(_flip(b.leaf, 7), list(b.nodes))


TAMPERS = [_m_root, _leaf, _swap, _short_root, _truncated_branches, _sibling_size,
           _short_path, _fri_rounds, _fri_last_value, _fri_noncanonical,
           _fri_column_branch]


@pytest.mark.parametrize("tamper", TAMPERS, ids=[t.__name__.lstrip("_") for t in TAMPERS])
def test_verifier_rejects_tampered(compute, tamper):
    r1cs, pub, golden = compute
    proof = proof_mod.from_json(golden)
    tamper(proof)
    with pytest.raises((ValueError, AssertionError)):
        runner.verify_with_witness(r1cs, pub, proof, device="cpu")


def test_verifier_rejects_wrong_public_wires(compute):
    r1cs, pub, golden = compute
    bad = list(pub)
    bad[-1] = (int.from_bytes(pub[-1], "little") + 1).to_bytes(32, "little")
    with pytest.raises((ValueError, AssertionError)):
        runner.verify_with_witness(r1cs, bad, proof_mod.from_json(golden), device="cpu")


def test_malformed_json_rejected():
    with pytest.raises(ValueError, match="malformed proof JSON"):
        proof_mod.from_json('{"m_root": [0]}')


def test_port_never_imports_jax():
    code = (
        "import pkgutil, importlib, sys, stark_tpu_torch\n"
        "for m in pkgutil.walk_packages(stark_tpu_torch.__path__, 'stark_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_without_card_raises(compute):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error path cannot be shown")
    r1cs, pub, golden = compute
    with pytest.raises(RuntimeError, match="cuda"):
        runner.verify_with_witness(r1cs, pub, proof_mod.from_json(golden))
    with pytest.raises(RuntimeError, match="cuda"):
        runner.prove_with_witness(r1cs, read_witness(open(
            os.path.join(FIX, "compute.wtns"), "rb").read()), device="cuda")


def test_out_of_scope_arguments_raise(compute):
    r1cs, pub, golden = compute
    with open(os.path.join(FIX, "compute.wtns"), "rb") as f:
        witness = read_witness(f.read())
    # an unknown digest, as `stark_tpu/merkle/tree.py:310` refuses it
    with pytest.raises(ValueError, match="digest"):
        runner.prove_with_witness(r1cs, witness, digest="sha256", device="cpu")
    with pytest.raises(ValueError, match="digest"):
        runner.verify_with_witness(r1cs, pub, proof_mod.from_json(golden), digest="sha256",
                                   device="cpu")
    # mesh= takes a DomainMesh (stark_tpu_torch/parallel/distributed.py)
    with pytest.raises(TypeError, match="DomainMesh"):
        runner.prove_with_witness(r1cs, witness, mesh=object(), device="cpu")
