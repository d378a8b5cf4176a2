"""Seconds of the summed span `lcb_commit` inside `lcb_engine` (counter
`lcb_commit_s`, utils/metrics `Metrics.summed`): each phase's serial validate and commit loop, its Python
re-runs included (`LcbEngine.run`), summed over the
pass.  Mean over the passes; nothing where the program has no such
counter."""


def read(ctx):
    vals = [p["counters"].get("lcb_commit_s") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
