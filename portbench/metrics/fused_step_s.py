"""Counter `fused_step_s`: host seconds of the K7 runs' launches and reads
in one pass, mean over the passes."""


def read(ctx):
    vals = [p["counters"].get("fused_step_s") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
