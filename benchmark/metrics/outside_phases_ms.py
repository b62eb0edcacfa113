"""entry layer: a call's host wall (synced phases) less the program's phases
inside it: the witness reader, `to_json`, the file write and the reply in
the worker; the harness's call alone in a stream."""


def read(ctx):
    layer = ctx["layer"]
    return (layer["call_wall_s"] - sum(layer["phase_wall_s"].values())) * 1e3
