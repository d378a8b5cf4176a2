"""K7 `lcb_step`'s chain floor as a share of its device time in a pass:
over the pass's runs, the longest lane's occurrence steps
(`fused_longest_occ_steps`) x 0.1474 us plus its steps
(`fused_longest_steps`) x 1.6861 us (the chain probes; k7_bound.py), over
the device time of `lcb_step_kernel` in the trace.  The longest lane is
the one of the most steps (then pushes) that `fused_longest_steps` picks,
not the lane that maximises the sum, as PERF.md's K7 row takes it, so the
floor can read a little under that one.  Mean over the passes; nothing
where the counters are absent or K7 did not run."""

from portbench.lib import k7_bound, roofline
from portbench.lib.devtrace import kernel_ms


def read(ctx):
    vals = []
    for p in ctx["passes"]:
        occ = p["counters"].get("fused_longest_occ_steps")
        steps = p["counters"].get("fused_longest_steps")
        ms = kernel_ms(p["trace"], ("lcb_step_kernel",))
        if occ is None or steps is None or not ms:
            return None
        vals.append(roofline.share_pct(k7_bound.chain_floor_s(occ, steps), ms / 1e3))
    return sum(vals) / len(vals)
