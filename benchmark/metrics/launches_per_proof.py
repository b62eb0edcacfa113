"""device layer: kernels, copies and memsets on the card a call in the
profiled part, counted exactly from the trace."""


def read(ctx):
    layer = ctx["layer"]
    return layer["device_events"] / layer["n"]
