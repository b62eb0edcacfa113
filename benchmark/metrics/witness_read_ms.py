"""entry layer: the worker's `read_witness` span (the `.wtns` file read
into rows), a call, synced."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms(ctx, "read_witness")
