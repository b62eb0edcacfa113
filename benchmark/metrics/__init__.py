"""Per-layer metrics, one module a metric, named as in `BENCHMARK.json`:
`read(ctx) -> float | None`. `ctx["layer"]` is what the traced run read
(`benchmark/devtrace.py`): per call, the synced phases' walls
(`phase_wall_s`), the synced calls' host wall (`call_wall_s`), the
profiled part's device time by phase (`phase_device_s`), its busy and
window seconds and its device events over `n` calls. A reader that finds
nothing to read returns None and the metric is left out of the line."""

from __future__ import annotations


def sizes(ctx) -> dict:
    """The proof's sizes from the configuration (`benchmark/counts`)."""
    c = ctx["config"]
    return {"steps": c["steps"], "precision": c["precision"],
            "public_points": c["public_points"], "digest": c["digest"]}


def phase_ms(ctx, *names):
    walls = ctx["layer"]["phase_wall_s"]
    found = [walls[n] for n in names if n in walls]
    return sum(found) * 1e3 if found else None


def roofline_pct(ctx, phase: str, work):
    from benchmark.peaks import roofline_s

    device_s = ctx["layer"]["phase_device_s"].get(phase)
    if not device_s:
        return None
    return 100.0 * roofline_s(*work(sizes(ctx))) / device_s
