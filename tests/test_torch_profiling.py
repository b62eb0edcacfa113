"""The port's profiling readers (`stark_tpu_torch/utils/profiling.py`) and
the stage set's `resident_bytes`, on the CPU:

* `phase_walls` equals the JAX package's on the same tree (both tracers on
  one patched clock), top level and flattened;
* `parse_device_trace` on small Chrome traces written here: the union of
  overlapping device events, the newest file read, the hand-written and
  tensor-core kernels picked by name, each device event given to the
  innermost named phase whose device-side range holds it, or (in a trace
  without such ranges) cut at the sync barriers in `exit_log` order, one
  event outside every phase; the phases and `(outside phases)` sum to
  `device_busy_s`;
* (a real CPU-only profiler run: `tests/test_torch_profile_cpu.py`, whose
  one prove's trace takes ~25 s to record, write and read;)
* `phase_memory_peaks` resets and reads the peak at each top-level phase
  only inside its own run (the CUDA calls stubbed), and refuses the CPU;
* `resident_bytes()` of a small stage set on both engines against the
  bytes of the same tensors built apart.

Tolerance: exact (integers; seconds from integer nanoseconds).
"""

import json
import os
import time

import pytest
import torch

from stark_tpu.utils import profiling as jprofiling
from stark_tpu.utils import tracing as jtracing
from stark_tpu_torch.fields.field import BN254_FR as spec
from stark_tpu_torch.ops import modmath as mm
from stark_tpu_torch.ops import ntt, plan_cache
from stark_tpu_torch.protocol import core
from stark_tpu_torch.utils import profiling, tracing

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("STARK_TPU_TRACE", "STARK_TPU_PROFILE", "STARK_TPU_SYNC_PHASES",
                 "STARK_TPU_RSS"):
        monkeypatch.delenv(name, raising=False)
    previous = tracing.configure()
    tracing.reset()
    jtracing.reset()
    yield
    tracing.configure(**previous)
    tracing.reset()
    jtracing.reset()


def test_phase_walls_equal_the_jax_package(monkeypatch):
    for mod in (tracing, jtracing):
        ticks = iter(range(1000))
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) ** 2 * 1e-3)
        with mod.phase("arithmetize"):
            pass
        with mod.phase("columns"):
            with mod.phase("lde"):
                pass
            with mod.phase("lde"):
                pass
        with mod.phase("fri"):
            with mod.phase("columns"):  # a nested name that is also a top-level one
                pass
    for top_only in (True, False):
        assert profiling.phase_walls(top_only) == jprofiling.phase_walls(top_only)
    assert list(profiling.phase_walls()) == ["arithmetize", "columns", "fri"]


HAND = "void (anonymous namespace)::mmul_kernel<16>(int const*, int const*, int*, long long)"
TENSOR = "void (anonymous namespace)::matmul_fold_kernel(CUtensorMap, int const*, int*)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >(int)"


def _x(name, cat, ts, dur, pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid,
            "tid": tid}


def _write(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": [{"ph": "M", "name": "process_name", "pid": 0,
                                    "args": {"name": "GPU 0"}}] + events}, f)


DEVICE_EVENTS = [
    _x(HAND, "kernel", 10.0, 20.0),                      # traces
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 25.0, 10.0, tid=9),  # traces, overlaps
    _x(TENSOR, "kernel", 110.0, 40.0),                   # columns
    _x(TORCH, "kernel", 160.0, 5.5),                     # columns (its nested lde range: no)
    _x("Memset (Device)", "gpu_memset", 210.0, 1.25),    # fri
    _x(HAND, "kernel", 400.0, 3.0),                      # outside every phase
]


def test_parse_device_trace_by_annotations(tmp_path):
    _write(tmp_path / f"{1:020d}_1_old.trace.json", [_x(HAND, "kernel", 0.0, 999.0)])
    annotations = [
        _x("prove", "gpu_user_annotation", 0.0, 300.0),  # not among the phase names
        _x("traces", "gpu_user_annotation", 10.0, 25.0),
        _x("columns", "gpu_user_annotation", 110.0, 55.5),
        _x("lde", "gpu_user_annotation", 111.0, 2.0),     # named, holds no whole event
        _x("fri", "gpu_user_annotation", 210.0, 1.25),
        _x("traces", "user_annotation", 0.0, 50.0),      # a host range: ignored
    ]
    _write(tmp_path / f"{2:020d}_1_prove.trace.json", DEVICE_EVENTS + annotations)
    got = profiling.parse_device_trace(str(tmp_path),
                                       ["traces", "columns", "lde", "fri"])
    assert got["trace"].endswith("_prove.trace.json")
    busy_ns = 25_000 + 40_000 + 5_500 + 1_250 + 3_000  # the two overlapping: 10..35
    assert got["device_busy_s"] == busy_ns / 1e9
    assert got["hand_kernel_s"] == (20_000 + 40_000 + 3_000) / 1e9
    assert got["tensor_core_kernel_s"] == 40_000 / 1e9
    assert got["device_events"] == 6
    assert got["top_kernels_ms"] == {"matmul_fold_kernel": 0.04, "mmul_kernel": 0.023,
                                     "Memcpy HtoD": 0.01,
                                     "at::native::vectorized_elementwise_kernel": 0.0055,
                                     "Memset": 0.00125}
    assert got["phase_attribution"] == "device annotations"
    assert got["phase_device_s"] == {"columns": 45.5e-6, "traces": 25e-6,
                                     profiling.OUTSIDE: 3e-6, "fri": 1.25e-6}
    assert sum(round(v * 1e9) for v in got["phase_device_s"].values()) == busy_ns


def test_parse_device_trace_by_barriers(tmp_path):
    barriers = [_x(tracing.BARRIER_NAME, "user_annotation", ts, 1.0, pid=1)
                for ts in (40.0, 90.0, 200.0, 300.0)]
    _write(tmp_path / f"{5:020d}_1_prove.trace.json", DEVICE_EVENTS + barriers)
    # an exit log: a host phase's barrier (no device work) among the device ones
    got = profiling.parse_device_trace(str(tmp_path),
                                       ["traces", "arithmetize", "columns", "fri"])
    assert got["phase_attribution"] == "sync barriers"
    assert got["phase_device_s"] == {"columns": 45.5e-6, "traces": 25e-6,
                                     profiling.OUTSIDE: 3e-6, "fri": 1.25e-6}
    assert profiling.parse_device_trace(str(tmp_path / "none")) is None


def test_phase_memory_peaks_resets_only_inside_its_run(monkeypatch):
    state = {"live": 0, "peak": 0, "resets": 0, "syncs": 0}

    def alloc(n):
        state["live"] += n
        state["peak"] = max(state["peak"], state["live"])

    def reset(device=None):
        state["peak"], state["resets"] = state["live"], state["resets"] + 1

    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: state.__setitem__("syncs", state["syncs"] + 1))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: state["peak"])
    tracing.configure(trace=False, rss=False)

    def run():
        assert tracing._sync_phases
        with tracing.phase("traces"):
            alloc(100)
            with tracing.phase("inner"):
                alloc(50)
                alloc(-50)
        with tracing.phase("columns"):
            alloc(1000)
            alloc(-1000)
        with tracing.phase("traces"):
            alloc(-100)
        return "proof"

    peaks, value = profiling.phase_memory_peaks(run, "cuda:0")
    assert value == "proof" and peaks == {"traces": 150, "columns": 1100}
    assert state["resets"] == 3  # one a top-level entry
    assert not tracing._sync_phases and tracing._watch is None
    with pytest.raises(ValueError, match="CUDA"):
        profiling.phase_memory_peaks(run, "cpu")


@pytest.mark.parametrize("engine", ["butterfly", "crt"])
def test_resident_bytes_groups(engine, tmp_path, monkeypatch):
    monkeypatch.setattr(plan_cache, "CACHE_DIR", str(tmp_path))
    steps, precision, original_steps = 16, 128, 15
    stages = core.build_proof_stages(spec, steps, precision, original_steps, "blake2s", "cpu",
                                     lde_engine=engine)
    got = stages["resident_bytes"]()
    L, skips = spec.num_limbs, precision // steps
    g2 = spec.root_of_unity(precision)
    g1 = pow(g2, skips, spec.p)
    assert got["xs_full"] == stages["xs_full"].nbytes == L * precision * 4
    assert got["domain_tables"] == L * precision * 4  # Zb3^-1
    pats = mm.shoup_consts(spec, list(range(1, skips + 1)), "cpu")
    assert got["shoup_patterns"] == 2 * core.tensor_bytes(pats)
    plans = ntt.make_best_lde(spec, g1, g2, steps, precision, "cpu", engine).plans
    assert got["ntt_plan_tables"] == core.tensor_bytes(plans) > 0
    if engine == "butterfly":
        plan = plans[0]
        assert got["ntt_plan_tables"] == core.tensor_bytes(plan.small_dif, plan.big_dit,
                                                           plan.n_inv)
