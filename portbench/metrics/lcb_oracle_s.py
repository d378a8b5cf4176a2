"""Seconds of the summed span `lcb_oracle` inside `lcb_engine` (counter
`lcb_oracle_s`, utils/metrics `Metrics.summed`): the lanes the host oracle re-runs (`eng.process` in
`process_phase_fused`), summed over the
pass.  Mean over the passes; nothing where the program has no such
counter."""


def read(ctx):
    vals = [p["counters"].get("lcb_oracle_s") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
