"""The readers of the fused LCB engine's spans and counters and of K7's
work, on synthetic passes: the engine's self time is the outer span less
its children and K7's runs, K7's roofline share is the bound of its
counted work over its device time, and every reader gives nothing where
its span or counter is absent (a program that does not record them)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.lib import k7_bound, registry, roofline  # noqa: E402

NEW = ("lcb_bundles_s", "lcb_seed_s", "lcb_decode_s", "lcb_oracle_s", "lcb_commit_s",
       "lcb_engine_self_s", "lcb_commit_redos", "fused_sync_wait_s", "k7_roofline",
       "k7_chain_floor")
CHILDREN = {"lcb_bundles": 0.5, "lcb_seed": 1.25, "lcb_decode": 0.75, "lcb_oracle": 0.125,
            "lcb_commit": 3.0}
WORK = {"k7_lanes": 610 * 256, "k7_stepped_lanes": 40_000, "k7_slab_moves": 90_000,
        "k7_slab_ic": 90_000 * 64, "k7_slab_pc": 90_000 * 128, "k7_pushes": 2_000_000,
        "fused_lane_occ_steps": 4_000_000, "k7_score_terms": 9_000_000, "k7_voters": 7_000_000,
        "k7_windows": 5_000_000, "k7_slots": 50_000_000, "k7_entries": 45_000_000}


def a_pass(scale=1.0, k7_ms=1666.0):
    """A pass of the program: `lcb_bundles` a stage (a span), the other
    children summed spans (counters `<name>_s`)."""
    span_s = {"lcb_bundles": CHILDREN["lcb_bundles"] * scale, "lcb_engine": 9.0 * scale}
    summed = {f"{k}_s": v * scale for k, v in CHILDREN.items() if k != "lcb_bundles"}
    counters = {**summed, "fused_step_s": 2.0 * scale, "lcb_commit_redos": 400.0,
                "fused_sync_wait_s": 1.5 * scale, "fused_longest_occ_steps": 500_000.0,
                "fused_longest_steps": 120_000.0, **WORK}
    return {"span_s": span_s, "counters": counters,
            "trace": {"kernel_ns": {"lcb_step_kernel": int(k7_ms * 1e6), "other": 5}}}


def read(name, passes):
    return registry.reader(name)({"passes": passes})


def test_self_time_is_the_span_less_its_children_and_k7():
    passes = [a_pass(1.0), a_pass(2.0)]
    want = [9.0 * s - sum(CHILDREN.values()) * s - 2.0 * s for s in (1.0, 2.0)]
    assert read("lcb_engine_self_s", passes) == pytest.approx(sum(want) / 2)
    # each child and fused_step_s add back to lcb_engine
    for p in passes:
        got = read("lcb_engine_self_s", [p]) + sum(read(f"{c}_s", [p]) for c in CHILDREN)
        assert got + p["counters"]["fused_step_s"] == pytest.approx(p["span_s"]["lcb_engine"])


def test_self_time_is_never_negative_on_nested_spans():
    """Nested spans, as the program records them: the children inside the
    outer span one after another, K7's runs between them, 1 s of the outer
    span in none."""
    t = 2.0  # lcb_bundles
    counters = {"fused_step_s": 0.0}
    for phase in range(5):
        for name, dur in (("lcb_seed", 3), ("run", 7), ("lcb_decode", 2), ("lcb_oracle", 1),
                          ("lcb_commit", 4)):
            key = "fused_step_s" if name == "run" else f"{name}_s"
            counters[key] = counters.get(key, 0.0) + dur
            t += dur
    p = {"span_s": {"lcb_bundles": 2.0, "lcb_engine": t + 1.0}, "counters": counters}
    assert read("lcb_engine_self_s", [p]) == pytest.approx(1.0)


def test_child_spans_and_counters_are_means_over_the_passes():
    passes = [a_pass(1.0), a_pass(3.0)]
    for name, value in CHILDREN.items():
        assert read(f"{name}_s", passes) == pytest.approx(2 * value)
    assert read("lcb_commit_redos", passes) == 400.0
    assert read("fused_sync_wait_s", passes) == pytest.approx(3.0)


def test_k7_roofline_is_the_formula():
    p = a_pass(k7_ms=1600.0)
    w = dict(WORK)
    nbytes = (74 * w["k7_slab_ic"] + 16 * w["k7_slab_pc"] + 72 * w["k7_slab_moves"]
              + 2 * (9 + 62) * w["k7_stepped_lanes"] + 88 * w["k7_lanes"]
              + 73 * w["k7_pushes"] + 147 * w["fused_lane_occ_steps"]
              + 24 * w["k7_score_terms"] + 16 * w["k7_voters"] + 32 * w["k7_windows"]
              + 17 * w["k7_slots"])
    ops = (150 * w["fused_lane_occ_steps"] + 12 * w["k7_score_terms"] + 70 * w["k7_slots"]
           + 20 * w["k7_entries"])
    assert k7_bound.k7_bytes(w) == nbytes and k7_bound.k7_ops(w) == ops
    bound = max(nbytes / 3.35e12, ops / (132 * 64 * 1.98e9))
    assert read("k7_roofline", [p]) == pytest.approx(100 * bound / 1.6)
    assert bound == roofline.bound_s(nbytes, ops)


def test_k7_chain_floor_is_the_formula():
    p = a_pass(k7_ms=2000.0)
    floor_us = 500_000 * 0.1474 + 120_000 * 1.6861
    assert read("k7_chain_floor", [p]) == pytest.approx(100 * floor_us / 2e6)


@pytest.mark.parametrize("name", NEW)
def test_nothing_where_the_input_is_absent(name):
    """A pass of a program without the new spans and counters (the fused
    engine's older counters and lcb_engine still there), and a pass where
    K7 did not run: nothing to read."""
    old = a_pass()
    old["span_s"] = {"lcb_engine": 9.0, "junction_table": 0.05}
    old["counters"] = {"fused_step_s": 2.0, "fused_longest_steps": 1.0,
                       "fused_lane_occ_steps": 10.0, "fused_host_syncs": 1190.0}
    assert read(name, [a_pass(), old]) is None
    if name.startswith("k7_"):
        idle = a_pass()
        idle["trace"] = {"kernel_ns": {}}
        assert read(name, [idle]) is None
    else:
        assert read(name, [a_pass()]) is not None


def test_the_new_metrics_are_declared_for_the_fused_cell():
    bench = registry.load_benchmark()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = by_name[name]
        assert m["moves"] == "gff_mbp_s" and m["workloads"] == ["example-k25.fused"]
        assert m["layer"] == ("kernel K7 lcb_step" if name.startswith("k7_")
                              else "fused LCB engine")
