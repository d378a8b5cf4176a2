"""Counter `fused_sync_wait_s`: the host's seconds blocked in the fused
engine's reads of the card (the `.cpu()` of `step.fetch`, which the
seeding's and K7's runs' reads take, and of the decode's compact fetches):
the card's queued work and the copies.  Mean over the passes."""


def read(ctx):
    vals = [p["counters"].get("fused_sync_wait_s") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
