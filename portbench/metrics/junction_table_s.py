"""Seconds of span `junction_table` (junctions/table.py, host), mean over
the passes."""


def read(ctx):
    vals = [p["span_s"].get("junction_table") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
