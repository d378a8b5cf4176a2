"""K2 `class_analysis`'s share of its roofline: its bytes for the pass's
sorted rows, one a position (counter `graph_positions`;
roofline.k2_bytes), at the card's published HBM rate, over the device
time of its two kernels (`class_tile_kernel`, `class_fixup_kernel`) in the
trace; mean over the passes; nothing where K2 did not run."""

from portbench.lib import roofline
from portbench.lib.devtrace import kernel_ms


def read(ctx):
    vals = []
    for p in ctx["passes"]:
        ms = kernel_ms(p["trace"], ("class_tile_kernel", "class_fixup_kernel"))
        n = p["counters"].get("graph_positions")
        if not ms or not n:
            return None
        vals.append(roofline.share_pct(
            roofline.bound_s(roofline.k2_bytes(int(n), ctx["cfg"]["k"])), ms / 1e3))
    return sum(vals) / len(vals)
