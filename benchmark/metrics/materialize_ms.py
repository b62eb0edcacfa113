"""orchestration layer: the program's `materialize` phase a call (the one
transfer of the proof's arrays and the host's formatting), synced."""

from benchmark.metrics import phase_ms


def read(ctx):
    return phase_ms(ctx, "materialize")
