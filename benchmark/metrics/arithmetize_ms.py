"""entry layer: the program's `arithmetize` phase a call (the checks, the
public wires, the cached static arithmetization), synced."""

from benchmark.metrics import phase_ms


def read(ctx):
    return phase_ms(ctx, "arithmetize", "parse+arithmetize")
