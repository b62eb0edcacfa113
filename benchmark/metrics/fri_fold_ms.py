"""field layer: the `fri_fold` span inside `fri` (special_x and the 4x fold,
every round), a call, synced."""

from benchmark.spans import span_ms


def read(ctx):
    return span_ms(ctx, "fri_fold")
