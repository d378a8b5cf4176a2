"""Counter `fused_host_syncs`: the fused engine's reads of device results
by the host in one pass, mean over the passes."""


def read(ctx):
    vals = [p["counters"].get("fused_host_syncs") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
