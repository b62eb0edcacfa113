"""Traffic drivers, one module a kind of traffic, each a `Driver` class that
a mix names under `driver` (`benchmark/traffic/<mix>.json`): `setup()`,
`call(i)` (one closed-loop call on pool witness i mod the pool's size, a
record of its host-clock start and end), `window(seconds)`, `execute(fn)`
(run fn with the program in its own thread), `in_program_thread(fn)`,
`outputs()` (the kept outputs of the sampled witnesses as JSON text) and
`close()`. Each driver keeps the first `KEEP` outputs of each sampled
witness; a window of these cells holds 12-16 a witness."""

from __future__ import annotations

import time

KEEP = 64  # outputs kept for the check a sampled witness: the first ones


def closed_loop(call, seconds: float):
    """Calls back to back from t0 until `seconds` have passed; the window
    ends when the last call started inside it returns."""
    calls = []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        calls.append(call(i))
        i += 1
    return calls, calls[-1]["end"] - t0
