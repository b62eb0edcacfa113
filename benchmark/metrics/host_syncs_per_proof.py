"""field layer: the program's host-blocking CUDA calls a call in the synced
part (`tracing.py`'s count: the field ops' constant uploads lead it), every
phase's and those outside the phases."""

from benchmark.spans import host_syncs


def read(ctx):
    return host_syncs(ctx)
