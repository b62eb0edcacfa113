"""device layer: the share of the profiled window in which no kernel, copy
or memset ran on the card."""


def read(ctx):
    layer = ctx["layer"]
    return 100.0 * (1.0 - layer["busy_s"] / layer["window_s"])
