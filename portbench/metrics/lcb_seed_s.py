"""Seconds of the summed span `lcb_seed` inside `lcb_engine` (counter
`lcb_seed_s`, utils/metrics `Metrics.summed`): each phase's table refresh (`_device_tables`) and each lane set's
seeding, its overflow read and its carry (`_run_tier`), summed over the
pass.  Mean over the passes; nothing where the program has no such
counter."""


def read(ctx):
    vals = [p["counters"].get("lcb_seed_s") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
