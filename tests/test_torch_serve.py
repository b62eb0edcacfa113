"""The proving worker's path as a whole, on the CPU at the `compute` scale:
`prove_with_witness` on the Lagrange fold route and `serve.serve`
(`prove_many`: `test_torch_prove_many.py`).

* the Lagrange-route proof of `compute` is byte-identical to the committed
  golden (the golden holds both routes), through the runner and the CLI;
* the worker, driven over `io.StringIO`: ready, ping, warmup, prove inline,
  run to a file, verify, an unknown method and malformed lines answered
  as errors with the worker still serving, a Poseidon prove equal to the
  committed Poseidon golden and its verify, shutdown; its replies carry the
  keys the JAX package's worker gives for the same requests;
* what is refused: an unknown fold route, and `device="cuda"` without a
  card (nothing falls back to the CPU).

Tolerance: exact (byte-identical JSON).
"""

import io
import json
import os

import pytest
import torch

from stark_tpu import serve as jserve
from stark_tpu_torch import cli, serve
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import runner
from stark_tpu_torch.r1cs.reader import read_r1cs, read_witness

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
R1CS = os.path.join(FIX, "compute.r1cs")
WTNS = os.path.join(FIX, "compute.wtns")


@pytest.fixture(scope="module")
def compute():
    with open(R1CS, "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(WTNS, "rb") as f:
        witness = read_witness(f.read())
    with open(os.path.join(FIX, "compute_proof_golden.json")) as f:
        golden = f.read()
    return r1cs, witness, golden


# --- the fold route through the entry points -------------------------------------


def test_lagrange_route_matches_golden(compute):
    r1cs, witness, golden = compute
    proof = runner.prove_with_witness(r1cs, witness, device="cpu", fri_fold="lagrange")
    assert proof_mod.to_json(proof) == golden


def test_cli_run_on_the_lagrange_route(tmp_path, compute):
    out = str(tmp_path / "proof.json")
    assert cli.main(["run", R1CS, WTNS, out, "--device", "cpu",
                     "--fri-fold", "lagrange"]) == 0
    with open(out) as f:
        assert f.read() == compute[2]
    with pytest.raises(SystemExit):
        cli.main(["prove", R1CS, WTNS, out, "--device", "cpu", "--fri-fold", "nonsense"])


@pytest.mark.parametrize("entry", ["prove_with_witness", "prove_many", "serve"])
def test_unknown_fold_route_raises(compute, entry):
    r1cs, witness, _ = compute
    with pytest.raises(ValueError, match="fri_fold"):
        if entry == "prove_with_witness":
            runner.prove_with_witness(r1cs, witness, device="cpu", fri_fold="nonsense")
        elif entry == "prove_many":
            runner.prove_many(r1cs, [witness], device="cpu", fri_fold="nonsense")
        else:
            serve.serve(io.StringIO(""), io.StringIO(), device="cpu", fri_fold="nonsense")


@pytest.mark.parametrize("entry", ["prove_many", "serve", "cli serve"])
def test_cuda_without_card_raises(compute, entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error path cannot be shown")
    r1cs, witness, _ = compute
    out = io.StringIO()
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "prove_many":
            runner.prove_many(r1cs, [witness])
        elif entry == "serve":
            serve.serve(io.StringIO('{"id":1,"method":"ping"}\n'), out)
        else:
            cli.main(["serve"])
    assert out.getvalue() == ""  # not even the ready event


# --- the worker ---------------------------------------------------------------------


def _drive(worker, requests, **kwargs):
    """Feed request objects (or raw lines) to a worker; its replies by line."""
    lines = [r if isinstance(r, str) else json.dumps(r) for r in requests]
    out = io.StringIO()
    assert worker(io.StringIO("\n".join(lines) + "\n"), out, **kwargs) == 0
    replies = []
    for line in out.getvalue().splitlines():
        assert line.startswith("RPC ")
        replies.append(json.loads(line[4:]))
    return replies


def _requests(tmp_path, tag):
    pj = str(tmp_path / f"{tag}.json")
    files = {"r1cs": R1CS, "wtns": WTNS}
    return [
        {"id": 1, "method": "ping"},
        {"id": 2, "method": "prove", "params": {**files, "inline": True}},
        {"id": 3, "method": "run", "params": {**files, "proof_json": pj}},
        {"id": 4, "method": "verify", "params": {**files, "proof_json": pj}},
        {"id": 5, "method": "verify", "params": files},
        {"id": 6, "method": "frobnicate"},
        "this is not JSON",
        {"id": 7, "method": "prove", "params": {"r1cs": R1CS}},
        {"id": 8, "method": "ping"},
        {"id": 9, "method": "shutdown"},
        {"id": 10, "method": "ping"},  # never read
    ], pj


@pytest.fixture(scope="module")
def port_replies(tmp_path_factory):
    reqs, pj = _requests(tmp_path_factory.mktemp("port"), "port")
    return _drive(serve.serve, reqs, device="cpu", fri_fold="lagrange"), pj


def test_worker_answers_every_request(port_replies, compute):
    replies, pj = port_replies
    golden = compute[2]
    assert replies[0] == {"id": None, "result": {"ok": True, "event": "ready"}}
    assert [r["id"] for r in replies[1:]] == [1, 2, 3, 4, 5, 6, None, 7, 8, 9]
    assert len(replies) == 11  # nothing after the shutdown was read
    by_id = {r["id"]: r for r in replies[1:]}
    assert by_id[1]["result"]["ok"] is True
    assert by_id[2]["result"]["proof"] == golden
    assert by_id[2]["result"]["proof_bytes"] == len(golden)
    assert "proof" not in by_id[3]["result"]
    assert by_id[3]["result"]["verified"] is True
    assert by_id[3]["result"]["proof_bytes"] == len(golden)
    with open(pj) as f:
        assert f.read() == golden
    assert by_id[4]["result"]["verified"] is True
    assert "proof_bytes" not in by_id[4]["result"]
    for i in (1, 2, 3, 4, 8):
        assert by_id[i]["result"]["seconds"] >= 0
    assert by_id[9] == {"id": 9, "result": {"ok": True}}


def test_worker_survives_bad_requests(port_replies):
    by_id = {r["id"]: r for r in port_replies[0][1:]}
    assert by_id[6]["error"]["type"] == "ValueError"
    assert "frobnicate" in by_id[6]["error"]["message"]
    assert by_id[None]["error"]["type"] == "JSONDecodeError"
    assert by_id[5]["error"]["type"] == "KeyError"  # a verify names its proof
    assert by_id[7]["error"]["type"] == "KeyError"
    assert by_id[8]["result"]["ok"] is True  # still serving after four errors


def test_worker_matches_the_jax_worker_key_for_key(port_replies, tmp_path):
    """The same requests through `stark_tpu.serve`: the same ids in the same
    order, results and errors with the same keys and error types."""
    reqs, _ = _requests(tmp_path, "jax")
    want = _drive(jserve.serve, reqs)
    got = port_replies[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["id"] == w["id"] and sorted(g) == sorted(w)
        if "error" in w:
            assert sorted(g["error"]) == sorted(w["error"])
            assert g["error"]["type"] == w["error"]["type"]
        else:
            assert sorted(g["result"]) == sorted(w["result"])
            for key in ("ok", "verified", "proof", "proof_bytes", "event"):
                assert g["result"].get(key) == w["result"].get(key)


def test_worker_warmup_and_poseidon(compute, tmp_path):
    files = {"r1cs": R1CS, "wtns": WTNS}
    proof_json = str(tmp_path / "poseidon.json")
    replies = _drive(serve.serve, [
        {"id": 1, "method": "warmup", "params": {"r1cs": R1CS}},
        {"id": 2, "method": "prove", "params": {**files, "digest": "poseidon",
                                                 "inline": True, "proof_json": proof_json}},
        {"id": 3, "method": "verify", "params": {**files, "digest": "poseidon",
                                                  "proof_json": proof_json}},
        {"id": 4, "method": "warmup", "params": {"r1cs": "no/such/file.r1cs"}},
        {"id": 5, "method": "prove", "params": {**files, "inline": True}},
    ], device="cpu")
    by_id = {r["id"]: r for r in replies[1:]}
    # the keys `stark_tpu/serve.py` answers a warmup with
    assert sorted(by_id[1]["result"]) == ["ok", "seconds", "steps", "warmed"]
    assert by_id[1]["result"]["steps"] == 16 and by_id[1]["result"]["warmed"] > 0
    with open(os.path.join(FIX, "compute_proof_poseidon_golden.json")) as f:
        assert by_id[2]["result"]["proof"] == f.read()
    assert by_id[3]["result"]["verified"] is True
    assert by_id[4]["error"]["type"] == "FileNotFoundError"
    assert by_id[5]["result"]["proof"] == compute[2]  # the default route, after EOF-less errors


def test_circuit_cache_keys_on_path_mtime_and_size(tmp_path):
    path = str(tmp_path / "c.r1cs")
    with open(R1CS, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data)
    cache = serve._CircuitCache(max_entries=2)
    first = cache.get(path)
    assert cache.get(path) is first
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    assert cache.get(path) is not first  # a touched file is parsed again
    cache.get(R1CS)
    assert len(cache._d) == 2  # the oldest entry made room
