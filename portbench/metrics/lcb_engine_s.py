"""Seconds of span `lcb_engine` (the fused LCB engine with its bundle list,
seeding, K7 runs, decode and the serial commit), mean over the passes."""


def read(ctx):
    vals = [p["span_s"].get("lcb_engine") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
