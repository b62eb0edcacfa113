"""What a benchmark reads of a prove: its phases' walls, their host-sync
counts and counters, a profiled prove's device timeline and each phase's
peak device memory.

Counterpart of what `bench.py:151-290` reads from
`stark_tpu/utils/profiling.py`: `phase_walls`, `parse_device_trace` and, in
place of `stage_memory_peaks` (the compiler's estimate a compiled stage),
`phase_memory_peaks` (measured on the card a phase). The stage set's
resident bytes are `core.build_proof_stages(...)["resident_bytes"]()`.
`phase_cost_sums`, `PEAK_FLOPS` and `PEAK_HBM` are XLA's compile-time
estimates and a TPU's peaks, and have no counterpart here.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re

from stark_tpu_torch.utils import tracing

OUTSIDE = "(outside phases)"
# the device's events in a Chrome trace of torch.profiler (Kineto)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# rows 20-22: the CRT engine's kernels, the only ones on the tensor cores
TENSOR_CORE_KERNELS = ("residues_in_kernel", "matmul_fold_kernel", "reconstruct_kernel")


def phase_walls(top_only: bool = True) -> dict:
    """{phase_name: seconds} from the tracing tree.

    top_only sums only the root's direct children (the prover's phases);
    a parent phase's elapsed already contains its children, so flattening
    every level would double-count nested spans."""
    phases: dict = {}

    def walk(node):
        for c in node.children.values():
            phases[c.name] = phases.get(c.name, 0.0) + c.elapsed
            if not top_only:
                walk(c)

    walk(tracing._root)
    return phases


def phase_counts() -> dict:
    """{phase_name: host-blocking CUDA calls} from the tracing tree
    (`tracing` module docstring), each name's nodes summed at every depth
    and the calls outside every phase under OUTSIDE. A node counts only the
    calls made while it was the innermost open phase, so the values add up
    to the whole count. Phases that counted none are left out: the dict is
    empty where nothing was counted (no card, or `sync_phases` off)."""
    counts: dict = {}

    def walk(node, name):
        if node.host_syncs:
            counts[name] = counts.get(name, 0) + node.host_syncs
        for c in node.children.values():
            walk(c, c.name)

    walk(tracing._root, OUTSIDE)
    return counts


def phase_counters() -> dict:
    """{phase_name: {counter: total}} of the tracing tree's `tracing.count`
    counters, each name's nodes summed at every depth and the root's under
    OUTSIDE; phases that counted nothing are left out."""
    counters: dict = {}

    def walk(node, name):
        for k, v in node.counters.items():
            mine = counters.setdefault(name, {})
            mine[k] = mine.get(k, 0) + v
        for c in node.children.values():
            walk(c, c.name)

    walk(tracing._root, OUTSIDE)
    return counters


def hand_kernel_name(name: str) -> str | None:
    """The short name (`mmul_kernel`, ...) of a kernel of `csrc/`, or None
    for any other: the hand-written kernels sit in anonymous namespaces,
    outside `at::`."""
    if "at::" in name or "anonymous namespace" not in name:
        return None
    found = re.search(r"\w+_kernel\b", name)
    return found.group(0) if found else None


def short_kernel_name(name: str) -> str:
    hand = hand_kernel_name(name)
    if hand is not None:
        return hand
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name[5:] if name.startswith("void ") else name)[0].strip()[:80]


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy


def latest_trace(outdir: str) -> str | None:
    """The newest Chrome trace the tracer wrote into `outdir` (its names
    start with the time in nanoseconds)."""
    paths = sorted(glob.glob(os.path.join(outdir, "*.trace.json"))
                   + glob.glob(os.path.join(outdir, "*.trace.json.gz")),
                   key=os.path.basename)
    return paths[-1] if paths else None


def _ns(us) -> int:
    return round(float(us) * 1000)


def parse_device_trace(outdir: str, phase_names=None) -> dict | None:
    """The device timeline of the newest Chrome trace in `outdir`
    (`tracing.configure(profile_dir=outdir)`), or None where there is none:

    - `device_busy_s`: the union of the device's kernels, copies and sets;
    - `top_kernels_ms`: the 12 largest kernels' summed device time, by short
      name (`short_kernel_name`);
    - `hand_kernel_s`: the summed time of the kernels of `csrc/` (the JAX
      package's `mxu_kernel_s` counted its MXU kernels);
    - `tensor_core_kernel_s`: of those, rows 20-22's (0 on the butterflies);
    - `sync_barriers`, `host_phases`: the count of barrier ranges, and the
      host ranges of `record_function` (the phases) in the order they began;
    - with `phase_names`, `phase_device_s`: the busy time by phase. A device
      event belongs to the innermost of the named phases whose device-side
      range (the profiler's `gpu_user_annotation` of its
      `record_function`) holds it; in a trace without such ranges, to the
      phase whose `sync_phases` barrier (`tracing.BARRIER_NAME`) is the
      first to end after it starts, the barriers taken in
      `phase_names`' order (pass `tracing.exit_log()`), as the JAX package
      does. Other events go under `OUTSIDE`. Each stretch of the union
      goes to the phase of the event that first covers it, so the phases
      and `OUTSIDE` sum to `device_busy_s`.

    Times are summed in integer nanoseconds."""
    path = latest_trace(outdir)
    if path is None:
        return None
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    device, annotations, barriers, host = [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        start, dur = _ns(e.get("ts", 0)), _ns(e.get("dur", 0))
        if cat in DEVICE_CATEGORIES:
            device.append((start, start + dur, e.get("name", "?"), cat))
        elif cat == "gpu_user_annotation":
            annotations.append((start, start + dur, e.get("name", "")))
        elif e.get("name") == tracing.BARRIER_NAME:
            barriers.append(start + dur)
        elif cat == "user_annotation":
            host.append((start, e.get("name", "")))
    kernels: dict = {}
    hand = tensor_core = 0
    for start, end, name, cat in device:
        k = short_kernel_name(name)
        kernels[k] = kernels.get(k, 0) + end - start
        if cat == "kernel" and hand_kernel_name(name) is not None:
            hand += end - start
            tensor_core += (end - start) * (k in TENSOR_CORE_KERNELS)
    out = {
        "trace": os.path.basename(path),
        "device_busy_s": union_length((s, e) for s, e, _, _ in device) / 1e9,
        "hand_kernel_s": hand / 1e9,
        "tensor_core_kernel_s": tensor_core / 1e9,
        "device_events": len(device),
        "sync_barriers": len(barriers),
        "host_phases": [name for _, name in sorted(host)],
        "top_kernels_ms": {k: v / 1e6 for k, v in
                           sorted(kernels.items(), key=lambda kv: -kv[1])[:12]},
    }
    if phase_names:
        out.update(_by_phase(device, annotations, sorted(barriers), list(phase_names)))
    return out


def _by_phase(device, annotations, barriers, phase_names) -> dict:
    named = set(phase_names)
    ranges = [(s, e, n) for s, e, n in annotations if n in named]
    if ranges:
        def owner(start, end):
            inside = [(e - s, n) for s, e, n in ranges if s <= start and end <= e]
            return min(inside)[1] if inside else OUTSIDE
        how = "device annotations"
    else:
        names = phase_names[: len(barriers)]

        def owner(start, end):
            for i, barrier in enumerate(barriers[: len(names)]):
                if start < barrier:
                    return names[i]
            return OUTSIDE
        how = "sync barriers" if barriers else "none"
    per: dict = {}
    reach = None
    for start, end, _, _ in sorted(device):
        lo = start if reach is None else max(start, reach)
        if end > lo:
            name = owner(start, end)
            per[name] = per.get(name, 0) + end - lo
        reach = end if reach is None else max(reach, end)
    return {"phase_attribution": how,
            "phase_device_s": {k: v / 1e9 for k, v in
                               sorted(per.items(), key=lambda kv: -kv[1])}}


def phase_memory_peaks(run, device):
    """Run `run()` (one prove, say) once with the phases synced and return
    ({top-level phase: peak device bytes within it}, run's value). Each
    top-level phase starts from a synchronized device and a reset peak
    (`torch.cuda.reset_peak_memory_stats`) and reads
    `torch.cuda.max_memory_allocated` at its synced exit: measured, where
    the JAX package's `stage_memory_peaks` is the compiler's estimate a
    stage. This helper is the only code of the port that resets the peak,
    and only inside its own run, so a caller's whole-prove peak survives
    tracing. Needs a CUDA device."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"device memory peaks are read on a CUDA device, not {dev}")
    peaks: dict = {}

    def watch(node, event, top, _device):
        if not top:
            return
        torch.cuda.synchronize(dev)
        if event == "enter":
            torch.cuda.reset_peak_memory_stats(dev)
        else:
            peaks[node.name] = max(peaks.get(node.name, 0),
                                   torch.cuda.max_memory_allocated(dev))

    previous = tracing.configure()
    tracing.configure(**{**previous, "sync_phases": True})
    saved, tracing._watch = tracing._watch, watch
    try:
        value = run()
    finally:
        tracing._watch = saved
        tracing.configure(**previous)
    return peaks, value
