"""Seconds of the graph stage's device spans, each ending in a
synchronise: `graph_front_half` (K1), `graph_sort`, `graph_class_analysis`
(K2), `graph_ids_fetch`; mean over the passes."""

SPANS = ("graph_front_half", "graph_sort", "graph_class_analysis", "graph_ids_fetch")


def read(ctx):
    vals = []
    for p in ctx["passes"]:
        if not all(s in p["span_s"] for s in SPANS):
            return None
        vals.append(sum(p["span_s"][s] for s in SPANS))
    return sum(vals) / len(vals)
