"""The traced run's two parts and the reading of the profiler's trace.

Part one runs `n` calls under the program's tracer with a profile
directory and one top-level phase around them (`stark_tpu_torch.utils.
tracing`), so one Chrome trace of `torch.profiler` holds every device event
of the calls and each program phase's range on the host and on the device.
Part two runs `n` more calls with the phases synced (a device barrier at
each phase's exit) and reads each phase's wall (`utils/profiling.py
phase_walls`). Each part divides by its own `n`.

The arithmetic over the trace is this file's: a copy of what the program's
`utils/profiling.py` does (`union_length`, the kernels' short names, the
device events a phase's device-side range holds), kept here so that the
yardstick does not move with the program.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import shutil

WRAP = "bench_window"
PHASES = ("arithmetize", "parse+arithmetize", "traces", "a_tree", "columns", "commits",
          "branches", "fri", "materialize")
OUTSIDE = "(outside phases)"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def traced_parts(run, n: int, dev, trace_dir: str):
    import torch
    from stark_tpu_torch.utils import profiling, tracing

    cuda = dev.type == "cuda"
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.makedirs(trace_dir)
    prev = run.in_program_thread(lambda: tracing.configure(profile_dir=trace_dir))
    stack = contextlib.ExitStack()
    run.in_program_thread(lambda: stack.enter_context(tracing.phase(WRAP, device=dev)))
    try:
        profiled = [run.call(i) for i in range(n)]
    finally:
        run.in_program_thread(stack.close)  # stops the profiler, writes the trace
        run.in_program_thread(lambda: tracing.configure(**prev))

    def synced_on():
        tracing.reset()
        tracing.configure(**{**prev, "sync_phases": True})

    run.in_program_thread(synced_on)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        synced = [run.call(n + i) for i in range(n)]
        walls = run.in_program_thread(profiling.phase_walls)
    finally:
        run.in_program_thread(lambda: tracing.configure(**prev))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    paths = sorted(glob.glob(os.path.join(trace_dir, "*.trace.json")))
    with open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    shutil.rmtree(trace_dir, ignore_errors=True)
    # a run on the CPU (the tests) has no device: its operators stand in
    layer = read_trace(events, n, DEVICE_CATEGORIES if cuda else ("cpu_op",))
    layer.update({
        "peak_bytes": peak,
        "phase_wall_s": {k: v / n for k, v in walls.items() if k in PHASES},
        "call_wall_s": sum(c["end"] - c["start"] for c in synced) / n,
    })
    return profiled + synced, layer


def union_length(spans) -> int:
    busy, end = 0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy


def short_name(name: str) -> str:
    found = re.search(r"\w+_kernel\b", name) if "anonymous namespace" in name else None
    if found and "at::" not in name:
        return found.group(0)
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return re.split(r"[<(]", name)[0].strip()[:60] or "?"


def _ns(us) -> int:
    return round(float(us) * 1000)


def read_trace(events, n: int, device_categories=DEVICE_CATEGORIES) -> dict:
    """Per-call device figures of a trace whose top-level range is WRAP."""
    device, dev_ranges, host_ranges, window = [], [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        start, dur = _ns(e.get("ts", 0)), _ns(e.get("dur", 0))
        name = e.get("name", "")
        if cat in device_categories:
            device.append((start, start + dur, name))
        elif cat == "gpu_user_annotation" and name in PHASES:
            dev_ranges.append((start, start + dur, name))
        elif cat == "user_annotation":
            if name == WRAP:
                window = (start, start + dur)
            elif name in PHASES:
                host_ranges.append((start, start + dur, name))
    if window is None or not device:
        raise RuntimeError("the trace holds no window or no device event")
    lo, hi = window
    device = [(max(s, lo), min(e, hi), k) for s, e, k in device if e > lo and s < hi]
    busy = union_length((s, e) for s, e, _ in device)
    # each stretch of the union goes to the innermost phase range holding
    # the event that first covers it
    per_phase: dict = {}
    reach = None
    for s, e, _ in sorted(device):
        a = s if reach is None else max(s, reach)
        if e > a:
            inside = [(r1 - r0, nm) for r0, r1, nm in dev_ranges if r0 <= s and e <= r1]
            owner = min(inside)[1] if inside else OUTSIDE
            per_phase[owner] = per_phase.get(owner, 0) + e - a
        reach = e if reach is None else max(reach, e)
    kernels: dict = {}
    for s, e, k in device:
        short = short_name(k)
        kernels[short] = kernels.get(short, 0) + e - s
    # idle stretches inside the window, by the host phase at their start
    gaps: dict = {}
    cursor = lo
    for s, e in _merged((s, e) for s, e, _ in device) + [(hi, hi)]:
        if s > cursor:
            inside = [(r1 - r0, nm) for r0, r1, nm in host_ranges if r0 <= cursor < r1]
            owner = min(inside)[1] if inside else OUTSIDE
            gaps[owner] = gaps.get(owner, 0) + s - cursor
        cursor = max(cursor, e)
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {
        "n": n,
        "busy_s": busy / 1e9,
        "window_s": (hi - lo) / 1e9,
        "device_events": len(device),
        "phase_device_s": {k: v / 1e9 / n for k, v in per_phase.items()},
        "breakdown": {"device_ops": top(kernels), "idle_gaps": top(gaps)},
    }


def _merged(spans) -> list:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]
