"""Persistent proving worker: line-delimited JSON-RPC over stdio.

Counterpart of `stark_tpu/serve.py`, with the same line protocol: one
long-lived process holds the built kernel library, the parsed-circuit
cache, the circuit-static arithmetizations and the prover's stage sets (the
domain tables on the device), so repeat calls pay only the proof itself.

Protocol (one JSON object per line on stdin; one `RPC {...}` line per
response on stdout: the prefix keeps stray library prints from corrupting
the stream). The first line out is the ready event,
`RPC {"id": null, "result": {"ok": true, "event": "ready"}}`.

    {"id": 1, "method": "prove",
     "params": {"r1cs": "c.r1cs", "wtns": "w.wtns", "proof_json": "p.json"}}
    -> RPC {"id": 1, "result": {"ok": true, "proof_bytes": 3649501,
                                "seconds": 0.25}}

Methods: ping, prove, verify, run (prove+verify), warmup, shutdown.
`prove` accepts "inline": true to return the proof JSON in the response
instead of (or beside) writing a file; `prove`/`verify`/`run` accept
"digest" ("blake2s", the default, or "poseidon"). A verify keeps the
circuit's 6 public-column LDEs on the cached circuit (the runner's size
gate), so repeat verifies of one circuit skip them. Errors come back as
{"id", "error": {"type", "message"}}: the worker never dies on a bad
request.

Circuits and witnesses are read on the runner's native route where the
host library has built (`runner.read_circuit`, `runner.read_witness_rows`:
the C++ readers), on the Python route otherwise; the replies are the same.

`warmup` takes {"r1cs": path}. The JAX worker compiles its executables
there; this one has none to compile. It builds and loads the CUDA kernel
library (on a card), parses and arithmetizes the circuit, and builds the
stage set for its size (power tables, NTT plans, pattern pairs on the
device; on the "crt" LDE engine also that engine's residue tables, from its
disk cache where they have been built before), and answers {"ok", "warmed",
"steps"} with `warmed` the number of stages made ready. The device, FRI's
fold route and the LDE engine are the worker's, fixed when it starts:
`python -m stark_tpu_torch.cli serve --device cuda --fri-fold dft
--lde-engine butterfly`. Its requests run in the tracer's phases
(`utils/tracing.py`): the runner's, and the worker's own top-level
`read_witness` (the `.wtns` read) and `to_json` (the proof's JSON text; the
file write and the reply stay outside). `cli serve --trace` prints their
reports to stderr, so that stdout carries only the protocol's lines.
"""

from __future__ import annotations

import json
import os
import sys
import time

from stark_tpu_torch import device as devmod
from stark_tpu_torch.fri.fri import check_fold_route
from stark_tpu_torch.ops import build
from stark_tpu_torch.ops.ntt import check_lde_engine
from stark_tpu_torch.protocol import proof as proof_mod
from stark_tpu_torch.protocol import prove, runner
from stark_tpu_torch.protocol.params import derive_params
from stark_tpu_torch.utils.tracing import phase


class _CircuitCache:
    """Parsed circuits keyed by (path, mtime, size): flat ones
    (`native.FlatR1cs`, read in C++) where the host library has built, else
    parsed trees (`runner.read_circuit`). The runner attaches the static
    arithmetization and the verifier's LDE cache to the cached object, so
    repeat requests for one circuit skip parsing and arithmetizing."""

    def __init__(self, max_entries: int = 8):
        self._d: dict = {}
        self._max = max_entries

    def get(self, path: str):
        st = os.stat(path)
        key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
        hit = self._d.get(key)
        if hit is not None:
            return hit
        r1cs = runner.read_circuit(path)
        if len(self._d) >= self._max:
            self._d.pop(next(iter(self._d)))
        self._d[key] = r1cs
        return r1cs


def _warmup(r1cs, dev, lde_engine: str) -> dict:
    if dev.type == "cuda":
        build.load()
    spec = runner._spec_for(r1cs)
    arith = runner._static_arith(spec, r1cs)
    params = derive_params(spec, arith.original_steps)
    stages = prove._stages_cached(spec, params.steps, params.precision,
                                  arith.original_steps, "blake2s", dev, lde_engine)
    warmed = sum(callable(stage) for name, stage in stages.items() if name != "resident_bytes")
    return {"ok": True, "warmed": warmed, "steps": params.steps}


def serve(stdin=None, stdout=None, device="cuda", fri_fold: str = "dft",
          lde_engine: str = "butterfly") -> int:
    """Blocking request loop; returns on EOF or the shutdown method. Raises
    before the ready event if `device` cannot be had, `fri_fold` names no
    route or `lde_engine` no engine."""
    dev = devmod.resolve(device)
    check_fold_route(fri_fold)
    check_lde_engine(lde_engine)
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    circuits = _CircuitCache()

    def _emit(obj):
        stdout.write("RPC " + json.dumps(obj, separators=(",", ":")) + "\n")
        stdout.flush()

    _emit({"id": None, "result": {"ok": True, "event": "ready"}})

    for line in stdin:
        line = line.strip()
        if not line:
            continue
        req_id = None
        try:
            req = json.loads(line)
            req_id = req.get("id")
            method = req.get("method")
            prm = req.get("params") or {}
            t0 = time.time()

            if method == "ping":
                result = {"ok": True}

            elif method == "shutdown":
                _emit({"id": req_id, "result": {"ok": True}})
                return 0

            elif method == "warmup":
                result = _warmup(circuits.get(prm["r1cs"]), dev, lde_engine)

            elif method in ("prove", "verify", "run"):
                digest = prm.get("digest", "blake2s")
                r1cs = circuits.get(prm["r1cs"])
                with phase("read_witness"):
                    rows = runner.read_witness_rows(prm["wtns"], r1cs)
                result = {"ok": True}
                if method in ("prove", "run"):
                    proof = runner.prove_with_rows(
                        r1cs, rows, digest=digest, device=dev, fri_fold=fri_fold,
                        lde_engine=lde_engine,
                    )
                    with phase("to_json"):
                        pj = proof_mod.to_json(proof)
                    result["proof_bytes"] = len(pj)
                    if prm.get("inline"):
                        result["proof"] = pj
                    if prm.get("proof_json"):
                        with open(prm["proof_json"], "w") as f:
                            f.write(pj)
                if method in ("verify", "run"):
                    if method == "verify":
                        with open(prm["proof_json"]) as f:
                            proof = proof_mod.from_json(f.read())
                    ok = runner.verify_with_witness(
                        r1cs, rows[: runner._n_pub(r1cs)], proof, digest=digest,
                        device=dev, lde_engine=lde_engine,
                    )
                    result["verified"] = bool(ok)

            else:
                raise ValueError(f"unknown method {method!r}")

            result["seconds"] = round(time.time() - t0, 3)
            _emit({"id": req_id, "result": result})
        except Exception as e:  # keep serving; report the failure
            _emit(
                {
                    "id": req_id,
                    "error": {
                        "type": type(e).__name__,
                        "message": str(e)[:2000],
                    },
                }
            )
    return 0
