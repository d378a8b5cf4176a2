"""The measured window: passes back to back, and the rate over them."""

from __future__ import annotations

import time
from typing import Callable, Dict, List


def run_window(run_pass: Callable[[int], Dict], seconds: float,
               clock: Callable[[], float] = time.time) -> List[Dict]:
    """Run passes back to back from now until `seconds` have passed; the
    last pass that starts before the deadline runs to its end and counts.
    `run_pass(i)` returns a dict; "start" and "end" are set here."""
    passes: List[Dict] = []
    deadline = None
    while deadline is None or clock() < deadline:
        t0 = clock()
        if deadline is None:
            deadline = t0 + seconds
        p = run_pass(len(passes))
        p["start"], p["end"] = t0, clock()
        passes.append(p)
    return passes


def rate_mbp_s(passes: List[Dict], bases_a_pass: int) -> float:
    """Input bases of every pass completed in the window, in Mbp, over the
    wall time from the first pass's start to the last pass's end."""
    done = [p for p in passes if not p.get("failed")]
    wall = passes[-1]["end"] - passes[0]["start"]
    return len(done) * bases_a_pass / 1e6 / wall


class StampedTimings(list):
    """A stand-in for the program's list of stage timings that also keeps
    each stage's host end time (the time it was appended): spans
    (name, start, end) for the trace's labels."""

    def __init__(self):
        super().__init__()
        self.ends: List[float] = []

    def append(self, item) -> None:
        self.ends.append(time.time())
        super().append(item)

    def spans(self):
        return [(t["stage"], e - t["seconds"], e) for t, e in zip(self, self.ends)]


def span_seconds(timings) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for t in timings:
        out[t["stage"]] = out.get(t["stage"], 0.0) + t["seconds"]
    return out
