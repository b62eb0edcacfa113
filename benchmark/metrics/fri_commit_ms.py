"""hash layer: the `fri_commit` span inside `fri` (each round's column
leaves, tree and root), a call, synced."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms(ctx, "fri_commit")
