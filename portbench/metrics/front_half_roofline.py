"""K1 `front_half`'s share of its roofline: its bytes and operations for the
pass's positions (counter `graph_positions`; roofline.k1_bytes, k1_ops)
at the card's published peaks, over its device time in the trace; mean
over the passes; nothing where K1 did not run."""

from portbench.lib import roofline
from portbench.lib.devtrace import kernel_ms


def read(ctx):
    vals = []
    for p in ctx["passes"]:
        ms = kernel_ms(p["trace"], ("front_half_kernel",))
        n = p["counters"].get("graph_positions")
        if not ms or not n:
            return None
        k = ctx["cfg"]["k"]
        vals.append(roofline.share_pct(
            roofline.bound_s(roofline.k1_bytes(int(n), k), roofline.k1_ops(int(n), k)), ms / 1e3))
    return sum(vals) / len(vals)
