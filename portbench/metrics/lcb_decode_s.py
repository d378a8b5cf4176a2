"""Seconds of the summed span `lcb_decode` inside `lcb_engine` (counter
`lcb_decode_s`, utils/metrics `Metrics.summed`): the result slabs' compact fetches and their instances
(`resident.decode` in `process_phase_fused`), summed over the
pass.  Mean over the passes; nothing where the program has no such
counter."""


def read(ctx):
    vals = [p["counters"].get("lcb_decode_s") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
