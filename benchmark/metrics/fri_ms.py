"""protocol stages layer: the program's `fri` phase a call, synced."""

from benchmark.metrics import phase_ms


def read(ctx):
    return phase_ms(ctx, "fri")
