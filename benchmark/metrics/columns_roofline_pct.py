"""LDE engine layer: the `columns` phase's least time on the card
(`benchmark/counts/columns.py` at the H100's peaks) over its device time a
call in the profiled part."""

from benchmark.counts import columns
from benchmark.metrics import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "columns", columns.work)
