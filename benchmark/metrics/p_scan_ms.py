"""protocol stages layer: the `p_scan` span inside `traces`, the gated scan
that builds the P column from K times S (`protocol/core.py wit_traces`), a
call, synced."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms(ctx, "p_scan")
