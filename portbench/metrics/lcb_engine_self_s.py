"""Seconds of span `lcb_engine` that no child names: the span less its
child span `lcb_bundles`, its summed child spans `lcb_seed`, `lcb_decode`,
`lcb_oracle` and `lcb_commit` (counters `<name>_s`) and the counter
`fused_step_s` (K7's launches and reads, which no span covers): the fused
engine's own loop, tier ladder and flags.  Mean over the passes; nothing
where any of them is absent."""

SUMMED = ("lcb_seed_s", "lcb_decode_s", "lcb_oracle_s", "lcb_commit_s", "fused_step_s")


def of_pass(p):
    """One pass's self seconds, or None."""
    spans, counters = p["span_s"], p["counters"]
    if "lcb_engine" not in spans or "lcb_bundles" not in spans or any(
            c not in counters for c in SUMMED):
        return None
    return spans["lcb_engine"] - spans["lcb_bundles"] - sum(counters[c] for c in SUMMED)


def read(ctx):
    vals = [of_pass(p) for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
