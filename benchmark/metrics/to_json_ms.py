"""entry layer: the worker's `to_json` span (the proof's JSON text), a call,
synced."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms(ctx, "to_json")
