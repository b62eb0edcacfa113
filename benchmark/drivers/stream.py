"""Back-to-back proves of one circuit in this process: the prover call of a
proving service, `runner.prove_with_rows(circuit, rows)` on the circuit read
once in set-up (`runner.read_circuit`) and the next witness's (n_wires, 32)
rows. The entry points' defaults except the configuration's digest; the
proofs of the sampled witnesses are kept as objects and serialized after
the window."""

from __future__ import annotations

import time
import traceback

from benchmark.drivers import KEEP, closed_loop


class Driver:
    def __init__(self, r1cs_path, pool, config, traffic, device, keep):
        self.r1cs_path, self.pool, self.device, self.keep = r1cs_path, pool, device, keep
        self.digest = config["digest"]
        self.kept = {i: [] for i in keep}

    def setup(self):
        from stark_tpu_torch.protocol import runner

        self.runner = runner
        self.circuit = runner.read_circuit(self.r1cs_path)
        for i in range(2):  # cold, then warm
            rec = self.call(i)
            if not rec["ok"]:
                raise RuntimeError(f"set-up call failed: {rec['error']}")
        self.kept = {i: [] for i in self.keep}

    def call(self, i: int) -> dict:
        j = i % len(self.pool)
        start = time.perf_counter()
        try:
            proof = self.runner.prove_with_rows(self.circuit, self.pool[j], digest=self.digest,
                                                device=self.device)
        except Exception:  # a failed call is counted, not fatal
            return {"start": start, "end": time.perf_counter(), "ok": False, "witness": j,
                    "error": traceback.format_exc(limit=3)[-600:]}
        end = time.perf_counter()
        if j in self.kept and len(self.kept[j]) < KEEP:
            self.kept[j].append(proof)
        return {"start": start, "end": end, "ok": True, "witness": j}

    def window(self, seconds: float):
        return closed_loop(self.call, seconds)

    def execute(self, fn):
        return fn()

    def in_program_thread(self, fn):
        return fn()

    def outputs(self) -> dict:
        from stark_tpu_torch.protocol import proof as proof_mod

        return {j: [proof_mod.to_json(p) for p in ps] for j, ps in self.kept.items()}

    def close(self):
        self.circuit = None
