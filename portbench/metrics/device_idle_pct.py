"""Share of a pass's wall time in which no kernel, copy or fill ran on the
card (the union of the trace's device intervals), mean over the passes."""


def read(ctx):
    vals = [p["trace"]["idle_pct"] for p in ctx["passes"]]
    return sum(vals) / len(vals)
