"""K7 `lcb_step`'s roofline bound and chain floor, from the counters the
fused LCB engine keeps of a pass (`_LaneRun.read`, lcb/fused.py: the
rows K7 writes for each lane, summed over the pass's runs).

The bound counts what the function must move, as chip_smoke.py's
`k7_bound` counts one run: each lane that steps has its live slab, best
score and snapshot flag and its 13 registers read once and written once;
every lane launched its result rows written; a rewind slab written for
each lane whose best score rose and a result slab for each whose best
score rose above 0; and the table words of every step, the walks' (a
push, an occurrence step, a score term) and the votes' (a voting
instance's end words, a window's more at the lane's path end, an
evaluated slot's position, junction id and used flag); against the
operations of the occurrence steps, score terms, slots and alive entries.
The counter `k7_slab_moves` is each run's slabs moved (two a stepping
lane, and its rewind and result slabs), `k7_slab_ic` / `k7_slab_pc` the
same weighted by the run's instance and path slab widths, so that the
bytes need no tier.

The byte and operation constants are copied from chip_smoke.py (lines
285-314, the K5, K6 and K7 constants of phases 16-18); the peaks are
roofline.py's.  The chain floor's probe times are those in PERF.md §6's
K7 row (one walk occurrence step on the "warp" probe, one vote of one
window round on the "vote" probe, NVIDIA H100 80GB HBM3 at 700 W).
"""

from __future__ import annotations

from typing import Dict, Optional

from portbench.lib import roofline

# chip_smoke.py: K5_PUSH_BYTES, K5_STEP_BYTES, K5_SCORE_BYTES
K5_PUSH_BYTES, K5_STEP_BYTES, K5_SCORE_BYTES = 73, 147, 24
# K5_INSTANCE_BYTES, K5_PATH_BYTES, K5_REGISTER_BYTES: a lane slab's column
# of instances, of the path, and its nine registers
K5_INSTANCE_BYTES, K5_PATH_BYTES, K5_REGISTER_BYTES = 74, 16, 72
K5_OPS_PER_STEP, K5_OPS_PER_SCORE_TERM = 150, 12
K5_BEST_BYTES = 8 + 1
# K6_END_BYTES, K6_WINDOW_BYTES, K6_SLOT_BYTES; K6_OPS_PER_SLOT, K6_OPS_PER_ENTRY
K6_END_BYTES, K6_WINDOW_BYTES, K6_SLOT_BYTES = 2 * 8, 4 * 8, 8 + 8 + 1
K6_OPS_PER_SLOT, K6_OPS_PER_ENTRY = 70, 20
# K7_REGISTER_BYTES, K7_RESULT_BYTES: a lane's 13 registers, its 11 int64
# result rows
K7_REGISTER_BYTES, K7_RESULT_BYTES = 7 * 8 + 6, 11 * 8

# the chain floor's probes, us (PERF.md §6, the K7 row)
WALK_STEP_US, VOTE_US = 0.1474, 1.6861

COUNTERS = ("k7_lanes", "k7_stepped_lanes", "k7_slab_moves", "k7_slab_ic", "k7_slab_pc",
            "k7_pushes", "fused_lane_occ_steps", "k7_score_terms", "k7_voters", "k7_windows",
            "k7_slots", "k7_entries")


def work(counters: Dict[str, float]) -> Optional[Dict[str, int]]:
    """The counters the bound reads, as ints, or None where one is absent
    (a program that does not count K7's work)."""
    if any(c not in counters for c in COUNTERS):
        return None
    return {c: int(counters[c]) for c in COUNTERS}


def k7_bytes(w: Dict[str, int]) -> int:
    return (K5_INSTANCE_BYTES * w["k7_slab_ic"] + K5_PATH_BYTES * w["k7_slab_pc"]
            + K5_REGISTER_BYTES * w["k7_slab_moves"]
            + 2 * (K5_BEST_BYTES + K7_REGISTER_BYTES) * w["k7_stepped_lanes"]
            + K7_RESULT_BYTES * w["k7_lanes"]
            + K5_PUSH_BYTES * w["k7_pushes"] + K5_STEP_BYTES * w["fused_lane_occ_steps"]
            + K5_SCORE_BYTES * w["k7_score_terms"]
            + K6_END_BYTES * w["k7_voters"] + K6_WINDOW_BYTES * w["k7_windows"]
            + K6_SLOT_BYTES * w["k7_slots"])


def k7_ops(w: Dict[str, int]) -> int:
    return (K5_OPS_PER_STEP * w["fused_lane_occ_steps"] + K5_OPS_PER_SCORE_TERM
            * w["k7_score_terms"] + K6_OPS_PER_SLOT * w["k7_slots"]
            + K6_OPS_PER_ENTRY * w["k7_entries"])


def bound_s(w: Dict[str, int]) -> float:
    """The least time the card could take for this work (roofline.bound_s)."""
    return roofline.bound_s(k7_bytes(w), k7_ops(w))


def chain_floor_s(longest_occ_steps: float, longest_steps: float) -> float:
    """The runs' serial chains: over the runs, each run's longest lane's
    occurrence steps x one walk step plus its steps x one vote."""
    return (longest_occ_steps * WALK_STEP_US + longest_steps * VOTE_US) / 1e6
