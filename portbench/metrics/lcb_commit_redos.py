"""Counter `lcb_commit_redos`: bundles the serial commit found in conflict
with an earlier commit of their phase and re-ran in Python (`LcbEngine.run`,
inside span `lcb_commit`), mean over the passes."""


def read(ctx):
    vals = [p["counters"].get("lcb_commit_redos") for p in ctx["passes"]]
    return None if None in vals else sum(vals) / len(vals)
