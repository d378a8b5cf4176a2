"""Seconds of span `lcb_bundles` inside `lcb_engine`: the pass's bundle
list (`make_bundles_device`, in `fused.run_fused`).  Mean over the passes;
nothing where the program has no such span."""


def read(ctx):
    vals = [p["span_s"].get("lcb_bundles") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
