"""entry layer: the `trace_inputs` span inside `traces`, the host's build
and upload of a proof's trace inputs (the permutation's words, the wire
ids, the witness, K's bytes and the flags) before the device
arithmetization, a call, synced."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms(ctx, "trace_inputs")
