"""Peaks of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W power limit, as
the repository's kernel table (PERF.md) states them: HBM at 3.35 TB/s and
32-bit integer operations at 16.75e12 a second (132 SMs x 64 lanes at
1.98 GHz, rounded up), from NVIDIA's data sheet and the card's clocks."""

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 16.75e12


def roofline_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at the peak bandwidth."""
    return max(ops / INT_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
