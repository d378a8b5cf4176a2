"""Seconds a pass spends in the CLI's own work: the pass's wall time less
the graph stage's spans, `junction_table` and `lcb_engine` (FASTA read,
trim and render, the GFF and graph writes); mean over the passes."""

GRAPH = ("graph_upload", "graph_front_half", "graph_sort", "graph_class_analysis",
         "graph_ids_fetch")


def read(ctx):
    vals = [p["end"] - p["start"] - sum(p["span_s"].get(s, 0.0) for s in
                                         GRAPH + ("junction_table", "lcb_engine"))
            for p in ctx["passes"]]
    return sum(vals) / len(vals)
