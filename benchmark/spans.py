"""What the program's tracer (`stark_tpu_torch/utils/tracing.py`) holds
after the traced run's synced part (`benchmark/devtrace.py`): that part
resets the tree, turns `sync_phases` on for its `n` calls and leaves the
tree as those calls made it. The readers of `benchmark/metrics/` that read
a span nested in a phase, a span of the worker's, or the host-sync count
read it here, per call. A tree that lacks the span or the count (a program
without it; the CPU, where nothing is counted) gives None."""

from __future__ import annotations


def span_ms(ctx, name: str):
    """The span `name`'s synced wall a call, in ms, summed wherever it sits
    in the tree."""
    from stark_tpu_torch.utils import profiling

    wall = profiling.phase_walls(top_only=False).get(name)
    return None if wall is None else wall / ctx["layer"]["n"] * 1e3


def host_syncs(ctx):
    """The host-blocking CUDA calls a call, every phase's and the root's."""
    from stark_tpu_torch.utils import profiling

    counts = profiling.phase_counts() if hasattr(profiling, "phase_counts") else {}
    return sum(counts.values()) / ctx["layer"]["n"] if counts else None
