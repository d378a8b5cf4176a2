"""Device milliseconds of K7 `lcb_step_kernel` in one pass, from the
profiler's trace, mean over the passes; nothing where K7 did not run."""

from portbench.lib.devtrace import kernel_ms


def read(ctx):
    vals = [kernel_ms(p["trace"], ("lcb_step_kernel",)) for p in ctx["passes"]]
    return sum(vals) / len(vals) if all(vals) else None
