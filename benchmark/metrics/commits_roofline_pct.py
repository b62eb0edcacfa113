"""hash layer: the `commits` phase's least time on the card
(`benchmark/counts/commits.py`, under the cell's digest, at the H100's
peaks) over its device time a call in the profiled part."""

from benchmark.counts import commits
from benchmark.metrics import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "commits", commits.work)
