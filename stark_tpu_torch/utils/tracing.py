"""Nested named phases: wall times in a tree, a text report, and on demand a
profiler trace of each top-level span, a device barrier at each phase's
exit and the process's RSS per phase.

Counterpart of `stark_tpu/utils/tracing.py`, under the same phase names at
the same sites: the prover's `traces`, `a_tree`, `columns`, `commits`,
`branches`, `fri`, `materialize` (`protocol/prove.py`), the verifier's
`v_fri`, `v_branches`, `v_lde` (`protocol/verify.py`) and the runner's
`arithmetize`, `v_arithmetize` and, on the native file route,
`parse+arithmetize` (`protocol/runner.py`). The JAX package reads its
switches from the environment; here `configure` sets them:

  trace         print the report of each top-level span at its exit, to
                `out` (default `sys.stdout`; the worker passes `sys.stderr`,
                since its stdout carries the protocol)
  profile_dir   run each top-level span under `torch.profiler.profile`
                (CPU activity, and CUDA activity where a card is) and write
                its Chrome trace into the directory; every phase runs inside
                `torch.profiler.record_function(name)`, so the trace holds
                the phases' ranges on the host and on the device
                (`utils/profiling.py parse_device_trace` reads them)
  sync_phases   synchronize the phase's device at every exit and append the
                phase's name to `exit_log()`. CUDA work is enqueued
                asynchronously, so without the barrier the report gives the
                device time to whichever phase waits first (`materialize`).
                Where a card is present, also count the program's
                host-blocking CUDA calls a phase (`host_syncs`, below).
                Diagnostic only: the barriers stop the host from running
                ahead of the device, so a synced prove is a little slower
  rss           record the process's VmRSS at each exit and its growth

A phase records its wall and its calls whatever the switches. With every
switch off it costs two `perf_counter` calls and a dict lookup: it does not
synchronize, touch the profiler or read `/proc`. Each process keeps one
tree, so each rank of a mesh keeps its own.

The host-sync count: while `sync_phases` is on and a card is present,
torch's sync debug mode is "warn" (`torch.cuda.set_sync_debug_mode`), so
every CUDA call that blocks the host until the device has drained (a
pageable `.to(cuda)` or `torch.tensor(..., device=cuda)`, `.cpu()`,
`.item()`, a stream synchronize) raises torch's warning "called a
synchronizing CUDA operation". A hook on `warnings.showwarning` counts each
one into the innermost open phase's `host_syncs` (the root's outside every
phase) and passes every other warning on as before. Neither
`torch.cuda.synchronize` nor `Event.synchronize` raises the warning, so
the tracer's own barriers go uncounted, and the port's one call of
`torch.cuda.synchronize` outside the tracer, before each collective of a
mesh (`parallel/distributed.py`), counts itself (`count_sync`).
`configure(sync_phases=False)` restores the previous debug mode and
warning handling. `utils/profiling.py phase_counts` reads the counts.

Usage::

    from stark_tpu_torch.utils import tracing
    tracing.configure(trace=True, sync_phases=True)
    with tracing.phase("prove", device=dev):
        ...
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import time
from dataclasses import dataclass, field


@dataclass
class _Node:
    name: str
    elapsed: float = 0.0
    calls: int = 0
    children: dict = field(default_factory=dict)
    rss_end_kb: int = 0  # VmRSS at last exit (rss runs)
    rss_delta_kb: int = 0  # summed enter->exit VmRSS growth
    host_syncs: int = 0  # host-blocking CUDA calls while innermost (sync_phases runs)


def _vmrss_kb() -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


_root = _Node("root")
_stack = [_root]
_exit_log: list = []  # phase names in barrier order (sync_phases runs)

_trace = False
_profile_dir: str | None = None
_sync_phases = False
_rss = False
_out = None
# a callable (node, "enter" or "exit", top, device) run at each phase's
# entry and exit; set only by `profiling.phase_memory_peaks` for its run
_watch = None
# (warnings.catch_warnings, previous sync debug mode) while syncs are counted
_sync_count = None

BARRIER_NAME = "stark_phase_barrier"
# the text of torch's warning in sync debug mode "warn" (c10/cuda/CUDAFunctions.cpp)
SYNC_WARNING = "called a synchronizing CUDA operation"


def configure(trace: bool = False, profile_dir: str | None = None,
              sync_phases: bool = False, rss: bool = False, out=None) -> dict:
    """Set the switches (see the module docstring); returns the previous
    ones, so `configure(**previous)` restores them."""
    global _trace, _profile_dir, _sync_phases, _rss, _out
    previous = {"trace": _trace, "profile_dir": _profile_dir,
                "sync_phases": _sync_phases, "rss": _rss, "out": _out}
    _trace, _profile_dir, _sync_phases, _rss, _out = (
        bool(trace), profile_dir or None, bool(sync_phases), bool(rss), out)
    if _sync_phases != (_sync_count is not None):
        _count_syncs(_sync_phases)
    return previous


def _count_syncs(on: bool) -> None:
    """Start counting host-blocking CUDA calls (where a card is present),
    or stop and restore the sync debug mode and warning handling that the
    start found."""
    global _sync_count
    import warnings

    import torch

    if not on:
        caught, mode = _sync_count
        _sync_count = None
        torch.cuda.set_sync_debug_mode(mode)
        caught.__exit__(None, None, None)
        return
    if not torch.cuda.is_available():
        return
    caught = warnings.catch_warnings()
    caught.__enter__()
    shown = warnings.showwarning

    def count(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            _stack[-1].host_syncs += 1
        else:
            shown(message, category, filename, lineno, file, line)

    warnings.filterwarnings("always", message=re.escape(SYNC_WARNING))
    warnings.showwarning = count
    _sync_count = (caught, torch.cuda.get_sync_debug_mode())
    torch.cuda.set_sync_debug_mode("warn")


def count_sync() -> None:
    """Count one host-blocking call that torch's debug mode does not flag
    (`torch.cuda.synchronize`) into the innermost open phase, while syncs
    are counted."""
    if _sync_count is not None:
        _stack[-1].host_syncs += 1


def enabled() -> bool:
    return _trace


@contextlib.contextmanager
def phase(name: str, sync=None, device=None):
    """Time a named phase (nested). `sync`: optional tensors whose device
    work is waited for before the clock stops, so that it counts in this
    phase. `device`: the device the phase's work runs on, which the
    `sync_phases` barrier synchronizes (none on the CPU or where None)."""
    parent = _stack[-1]
    node = parent.children.get(name)
    if node is None:
        node = parent.children[name] = _Node(name)
    _stack.append(node)
    top = parent is _root
    prof = rec = None
    if _profile_dir is not None:
        from torch.profiler import record_function

        if top:
            prof = _start_profiler()
        rec = record_function(name)
        rec.__enter__()
    rss0 = _vmrss_kb() if _rss else None
    if _watch is not None:
        _watch(node, "enter", top, device)
    t0 = time.perf_counter()
    try:
        yield node
    finally:
        if sync is not None:
            sync_point(sync)
        elif _sync_phases:
            _device_barrier(device)
            _exit_log.append(name)  # one barrier per exit, in device order
        node.elapsed += time.perf_counter() - t0
        node.calls += 1
        if _watch is not None:
            _watch(node, "exit", top, device)
        if rss0 is not None:
            node.rss_end_kb = _vmrss_kb()
            node.rss_delta_kb += node.rss_end_kb - rss0
        if rec is not None:
            rec.__exit__(None, None, None)
        _stack.pop()
        if prof is not None:
            _stop_profiler(prof, name, device)
        if top and _trace:
            print(report(node), file=_out if _out is not None else sys.stdout, flush=True)


def _is_cuda(device) -> bool:
    return device is not None and getattr(device, "type", None) == "cuda"


def _device_barrier(device) -> None:
    """Block until the device work enqueued so far on `device` completes
    (the JAX package blocks on a named jit, `stark_phase_barrier`). Under
    the profiler every exit's barrier, a host phase's too, runs inside
    `record_function(BARRIER_NAME)`, so a trace without device-side phase
    ranges can be cut at the exits in `exit_log()`'s order."""
    import torch

    if _profile_dir is None:
        if _is_cuda(device):
            torch.cuda.synchronize(device)
        return
    with torch.profiler.record_function(BARRIER_NAME):  # one range every exit
        if _is_cuda(device):
            torch.cuda.synchronize(device)


def sync_point(value):
    """Block on the device work that produces `value` (a tensor, or a list,
    tuple or dict of them) inside a phase: an explicit attribution point."""
    import torch

    items = value.values() if isinstance(value, dict) else (
        value if isinstance(value, (list, tuple)) else [value])
    for item in items:
        if torch.is_tensor(item) and item.is_cuda:
            torch.cuda.synchronize(item.device)
    return value


def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profiler(prof, name: str, device) -> None:
    """Stop a top-level span's profiler once its device work is done and
    write its Chrome trace as `<time_ns>_<pid>_<name>.trace.json`."""
    if _is_cuda(device):
        import torch

        torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    os.makedirs(_profile_dir, exist_ok=True)
    safe = "".join(c if c.isalnum() or c in "+-_" else "_" for c in name)
    prof.export_chrome_trace(os.path.join(
        _profile_dir, f"{time.time_ns():020d}_{os.getpid()}_{safe}.trace.json"))


def report(node: _Node | None = None, indent: int = 0) -> str:
    """Render the phase tree as an aligned text table."""
    if node is None:
        node = _root
        lines = []
    else:
        rss = (
            f"  rss {node.rss_end_kb / 1024:8.0f} MB ({node.rss_delta_kb / 1024:+.0f})"
            if node.rss_end_kb
            else ""
        )
        syncs = f"  syncs {node.host_syncs}" if node.host_syncs else ""
        lines = [
            f"{'  ' * indent}{node.name:<{max(28 - 2 * indent, 1)}s}"
            f" {node.elapsed * 1e3:10.1f} ms  x{node.calls}{syncs}{rss}"
        ]
    for child in node.children.values():
        lines.append(report(child, indent + 1))
    return "\n".join(lines)


def top_names() -> list:
    """The root's direct children, in the order they were first opened."""
    return list(_root.children)


def exit_log() -> list:
    """Phase names in the order their sync barriers fired (one each)."""
    return list(_exit_log)


def reset():
    global _root, _stack
    _root = _Node("root")
    _stack = [_root]
    _exit_log.clear()
