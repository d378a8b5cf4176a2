"""Seconds of span `graph_upload` (host packing and the copy to the card),
mean over the passes."""


def read(ctx):
    vals = [p["span_s"].get("graph_upload") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
