#!/usr/bin/env python3
"""Prove and verify R1CS circuits with the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line with its seconds; any failure exits
non-zero and no phase's error is swallowed:

1. device: a CUDA card must be present (its name and power limit are
   printed as `nvidia-smi --query-gpu=name,power.limit` gives them);
2. build: the kernel library is built with nvcc from stark_tpu_torch/csrc;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the prover's shapes for 43,690 constraints (steps 2^17, precision
   2^20), inputs from a numpy seed; tolerance: exact equality (integer
   field arithmetic with canonical outputs), with median times of both;
4. goldens: the `compute` and `poseidon3_test` proofs must be byte-identical
   to the committed goldens and the `ragged_mix(120)` proof must match its
   committed sha256; the port's verifier must accept each;
5. real size: `squaring_chain(43690)` proved twice (cold and warm) and
   verified; every kernel's launch counter must be > 0 for the proving run.

The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. `--out DIR` also writes every phase record
to DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
REAL_CONSTRAINTS = 43690
SEED = 20261016

KERNELS = {
    # wrapper name -> (source in the repo, the TPU kernel it replaces)
    "mmul": ("stark_tpu_torch/csrc/mmul.cu", "stark_tpu/ops/pallas_field.py:174"),
    "butterfly_stage": (
        "stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_field.py:446",
    ),
    "butterfly_fused": (
        "stark_tpu_torch/csrc/ntt.cu", "stark_tpu/ops/pallas_field.py:518",
    ),
    "blake2s_words": (
        "stark_tpu_torch/csrc/blake2s.cu", "stark_tpu/ops/pallas_blake2s.py:84",
    ),
}

RECORDS: list[dict] = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def wrappers():
    from stark_tpu_torch.ops import blake2s, field_cuda, ntt

    return {
        "mmul": field_cuda.mmul,
        "butterfly_stage": ntt.butterfly_stage,
        "butterfly_fused": ntt.butterfly_fused,
        "blake2s_words": blake2s.blake2s_words,
    }


def random_planes(rng, spec, n: int, device) -> torch.Tensor:
    """(16, n) canonical limb planes: a top limb below p's keeps every value
    below p."""
    L = spec.num_limbs
    limbs = rng.integers(0, 1 << 16, size=(L, n), dtype=np.int64)
    limbs[L - 1] = rng.integers(0, spec.p_limbs[L - 1], size=n)
    return torch.from_numpy(limbs.astype(np.int32)).to(device)


def random_words(rng, rows: int, n: int, device) -> torch.Tensor:
    w = rng.integers(0, 1 << 32, size=(rows, n), dtype=np.int64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


def median_ms(fn, reps: int) -> float:
    """Median device time of fn() over reps runs, after one warm run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest difference of the uint32 values (0 when bit-identical)."""
    g = got.to(torch.int64) & 0xFFFFFFFF
    w = want.to(torch.int64) & 0xFFFFFFFF
    return int((g - w).abs().max().item())


def compare(name: str, kernel_fn, plain_fn, cases: dict, reps=(10, 3)) -> dict:
    """Run kernel and plain version on each case: exact equality required;
    times are the medians over the cases' per-call medians."""
    per_case, err = {}, 0
    for label, args in cases.items():
        got = kernel_fn(*args)
        want = plain_fn(*args)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} [{label}]: kernel != plain (max abs err {e})")
        err = max(err, e)
        per_case[label] = {"ms": median_ms(lambda: kernel_fn(*args), reps[0]),
                           "plain_ms": median_ms(lambda: plain_fn(*args), reps[1])}
    return {"max_abs_err": err,
            "ms": statistics.median(c["ms"] for c in per_case.values()),
            "plain_ms": statistics.median(c["plain_ms"] for c in per_case.values()),
            "cases": per_case}


def phase_kernels(spec, device, steps: int, precision: int) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    from stark_tpu_torch.ops import blake2s as b2
    from stark_tpu_torch.ops import field_cuda as fc
    from stark_tpu_torch.ops import ntt

    rng = np.random.default_rng(SEED)
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, precision // steps, spec.p)
    big = ntt.NttPlan(spec, g2, precision, "dit", device)
    small = ntt.NttPlan(spec, spec.inv(g1), steps, "dif", device)
    x_big = random_planes(rng, spec, precision, device)
    x_small = random_planes(rng, spec, steps, device)
    out = {}
    out["mmul"] = compare(
        "mmul",
        lambda a, b: fc.mmul(spec, a, b),
        lambda a, b: fc.mmul_plain(spec, a, b),
        {f"(16,{precision})": (x_big, random_planes(rng, spec, precision, device))},
    )
    stage_cases = {
        f"{kind} n={n} m={m} l={l}": (x, tw, m, l, kind)
        for kind, n, x, plan in (("dit", precision, x_big, big), ("dif", steps, x_small, small))
        for (m, l, tw) in plan.singles
    }
    out["butterfly_stage"] = compare(
        "butterfly_stage",
        lambda x, tw, m, l, kind: ntt.butterfly_stage(spec, x, tw, m, l, kind),
        lambda x, tw, m, l, kind: ntt.butterfly_stage_plain(spec, x, tw, m, l, kind),
        stage_cases,
        reps=(10, 2),
    )
    out["butterfly_fused"] = compare(
        "butterfly_fused",
        lambda x, tw, kind: ntt.butterfly_fused(spec, x, tw, big.block, kind),
        lambda x, tw, kind: ntt.butterfly_fused_plain(spec, x, tw, big.block, kind),
        {f"dit n={precision} block={big.block}": (x_big, big.fused_tw, "dit"),
         f"dif n={precision} block={big.block}": (x_big, big.fused_tw, "dif")},
        reps=(10, 2),
    )
    out["blake2s_words"] = compare(
        "blake2s_words",
        b2.blake2s_words,
        b2.blake2s_words_plain,
        {f"(64,{precision}) 256-byte leaves": (random_words(rng, 64, precision, device), 256),
         f"(16,{precision // 2}) 64-byte nodes": (random_words(rng, 16, precision // 2, device), 64)},
        reps=(10, 2),
    )
    return out


def _fixture(name: str):
    from stark_tpu.r1cs.reader import read_r1cs, read_witness

    with open(os.path.join(FIXTURES, f"{name}.r1cs"), "rb") as f:
        r1cs = read_r1cs(f.read())
    with open(os.path.join(FIXTURES, f"{name}.wtns"), "rb") as f:
        witness = read_witness(f.read())
    return r1cs, witness


def prove_and_check(name, r1cs, witness, device, golden_text=None, golden_sha=None):
    from stark_tpu_torch.protocol import proof as proof_mod
    from stark_tpu_torch.protocol import runner

    t0 = time.time()
    text = proof_mod.to_json(runner.prove_with_witness(r1cs, witness, device=device))
    prove_s = time.time() - t0
    if golden_text is not None and text != golden_text:
        raise AssertionError(f"{name}: proof JSON differs from the golden")
    sha = hashlib.sha256(text.encode()).hexdigest()
    if golden_sha is not None and sha != golden_sha:
        raise AssertionError(f"{name}: proof sha256 {sha} != golden {golden_sha}")
    n_pub = 1 + r1cs.header.n_public_inputs + r1cs.header.n_public_outputs
    t0 = time.time()
    if not runner.verify_with_witness(r1cs, witness[:n_pub], proof_mod.from_json(text),
                                      device=device):
        raise AssertionError(f"{name}: the verifier rejected the proof")
    return {"circuit": name, "prove_s": prove_s, "verify_s": time.time() - t0,
            "proof_bytes": len(text), "sha256": sha}


def phase_goldens(device) -> list[dict]:
    from stark_tpu.r1cs.synth import ragged_mix

    out = []
    for name, golden in (("compute", "compute_proof_golden.json"),
                         ("poseidon3_test", "poseidon3_proof_golden.json")):
        with open(os.path.join(FIXTURES, golden)) as f:
            want = f.read()
        out.append(prove_and_check(name, *_fixture(name), device, golden_text=want))
    with open(os.path.join(FIXTURES, "ragged120_proof_sha256.txt")) as f:
        sha = f.read().strip()
    out.append(prove_and_check("ragged_mix(120)", *ragged_mix(120), device, golden_sha=sha))
    return out


def phase_real(device, n_constraints: int) -> dict:
    """Cold and warm prove plus verify at full size; launch counts of the
    cold proving run."""
    from stark_tpu.protocol.params import derive_params
    from stark_tpu.fields.field import BN254_FR as spec
    from stark_tpu.r1cs.synth import squaring_chain
    from stark_tpu_torch.protocol import runner

    r1cs, witness = squaring_chain(n_constraints)
    wrap = wrappers()
    for fn in wrap.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    proof = runner.prove_with_witness(r1cs, witness, device=device)
    cold_s = time.time() - t0
    launches = {name: fn.launches for name, fn in wrap.items()}
    peak_cold = torch.cuda.max_memory_allocated()
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the proving run: {missing}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    proof_warm = runner.prove_with_witness(r1cs, witness, device=device)
    warm_s = time.time() - t0
    peak_warm = torch.cuda.max_memory_allocated()
    if proof_warm != proof:
        raise AssertionError("warm proof differs from the cold proof")
    t0 = time.time()
    if not runner.verify_with_witness(r1cs, witness[:2], proof, device=device):
        raise AssertionError("the verifier rejected the real-size proof")
    verify_s = time.time() - t0
    arith = runner._static_arith(spec, r1cs)
    params = derive_params(spec, arith.original_steps)
    return {
        "constraints": n_constraints, "steps": params.steps,
        "precision": params.precision, "prove_cold_s": cold_s,
        "prove_warm_s": warm_s, "verify_s": verify_s,
        "peak_bytes_cold": peak_cold, "peak_bytes_warm": peak_warm,
        "launches": launches,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every phase record to DIR/chip_smoke.json")
    args = ap.parse_args(argv)

    t0 = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from stark_tpu.fields.field import BN254_FR as spec
    from stark_tpu.protocol.params import derive_params
    from stark_tpu_torch.ops import build

    device = "cuda"
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.time() - t0})

    t0 = time.time()
    so = build.library_path()
    build.load()
    with open(os.path.join(os.path.dirname(so), "build.log")) as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "library": os.path.relpath(so, ROOT), "ptxas": ptxas,
          "seconds": time.time() - t0})

    # a squaring chain fills one slot of each of the 3 regions per constraint
    params = derive_params(spec, 3 * REAL_CONSTRAINTS)
    t0 = time.time()
    kstats = phase_kernels(spec, device, params.steps, params.precision)
    emit({"phase": "kernels", "steps": params.steps, "precision": params.precision,
          "tolerance": "exact (torch.equal)", "results": kstats,
          "seconds": time.time() - t0})

    t0 = time.time()
    goldens = phase_goldens(device)
    emit({"phase": "goldens", "results": goldens, "seconds": time.time() - t0})

    t0 = time.time()
    real = phase_real(device, REAL_CONSTRAINTS)
    emit({"phase": "real_size", **real, "seconds": time.time() - t0})

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": real["launches"][name],
         "max_abs_err": kstats[name]["max_abs_err"],
         "ms": kstats[name]["ms"], "plain_ms": kstats[name]["plain_ms"]}
        for name, (src, rep) in KERNELS.items()
    ]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"records": RECORDS, "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
