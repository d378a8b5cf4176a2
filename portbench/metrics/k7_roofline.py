"""K7 `lcb_step`'s share of its roofline in a pass: the least time the card
could take for the work K7 counted in its blocks (the `k7_*` counters and
`fused_lane_occ_steps`; portbench/lib/k7_bound.py) at the card's published
peaks, over the device time of `lcb_step_kernel` in the trace.  Mean over
the passes; nothing where the counters are absent or K7 did not run."""

from portbench.lib import k7_bound, roofline
from portbench.lib.devtrace import kernel_ms


def read(ctx):
    vals = []
    for p in ctx["passes"]:
        w = k7_bound.work(p["counters"])
        ms = kernel_ms(p["trace"], ("lcb_step_kernel",))
        if w is None or not ms:
            return None
        vals.append(roofline.share_pct(k7_bound.bound_s(w), ms / 1e3))
    return sum(vals) / len(vals)
