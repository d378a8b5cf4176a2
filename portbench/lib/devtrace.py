"""Reduction of a torch.profiler trace of the window to device numbers.

The profiler runs over the whole window (CPU and CUDA activity); its
events are read in memory (`kineto_results.events()`), never written out.
Device intervals are the events on the CUDA device: kernels, copies and
fills.  Host times (time.time()) map onto the trace's clock through an
anchor event that the harness opens at a known host time.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Interval = Tuple[int, int]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Merged, sorted, non-overlapping intervals."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(merged: Sequence[Interval], lo: int, hi: int) -> int:
    """Length of [lo, hi) that merged intervals cover."""
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in merged if b > lo and a < hi)


def gaps(merged: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of [lo, hi) that no interval covers."""
    out, at = [], lo
    for a, b in merged:
        if b <= lo or a >= hi:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    out, depth = [], 0
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def device_events(prof) -> Tuple[List[Tuple[str, int, int]], Dict[str, int]]:
    """(device events as (name, start ns, end ns), {annotation: start ns}):
    the kernels, copies and fills on the card; the harness's own
    annotations (which the trace also draws on the device's timeline)
    are anchors, not device work."""
    dev, anchors = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("portbench_"):
            if not str(e.device_type()).endswith("CUDA"):
                anchors[name] = e.start_ns()
        elif (str(e.device_type()).endswith("CUDA")
              and not getattr(e, "is_user_annotation", lambda: False)()):
            dev.append((short_name(name), e.start_ns(), e.start_ns() + e.duration_ns()))
    return dev, anchors


def label_of(spans: Sequence[Tuple[str, float, float]], t: float) -> str:
    """The program span the host was in at time t, else the CLI's own I/O."""
    for name, a, b in spans:
        if a <= t < b:
            return name
    return "cli_io"


def reduce(dev, to_ns, passes: Sequence[Dict], top: int = 10) -> Dict:
    """Per pass: device seconds busy, idle share, device ms by kernel name;
    over the window: busy seconds, the device operations of most time and
    the longest idle gaps, each named by the span the host was in.

    dev: (name, start ns, end ns); to_ns(host time) -> trace ns; passes:
    dicts with "start", "end" (host times) and "spans" [(name, start, end)]."""
    merged = union([(a, b) for _, a, b in dev])
    by_name: Dict[str, int] = {}
    for name, a, b in dev:
        by_name[name] = by_name.get(name, 0) + (b - a)
    lo, hi = to_ns(passes[0]["start"]), to_ns(passes[-1]["end"])
    per_pass = []
    idle: List[Tuple[str, float]] = []
    for p in passes:
        a, b = to_ns(p["start"]), to_ns(p["end"])
        busy = covered(merged, a, b)
        kernels: Dict[str, int] = {}
        for name, s, e in dev:
            if s >= a and s < b:
                kernels[name] = kernels.get(name, 0) + (e - s)
        per_pass.append({"busy_s": busy / 1e9, "wall_s": (b - a) / 1e9,
                         "idle_pct": 100.0 * (1 - busy / (b - a)), "kernel_ns": kernels})
        spans = [(n, to_ns(s), to_ns(e)) for n, s, e in p["spans"]]
        for g0, g1 in gaps(merged, a, b):
            idle.append((label_of(spans, (g0 + g1) / 2), (g1 - g0) / 1e9))
    idle.sort(key=lambda x: -x[1])
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    return {"busy_s": covered(merged, lo, hi) / 1e9, "window_s": (hi - lo) / 1e9,
            "passes": per_pass,
            "device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, s] for n, s in idle[:top]]}


def kernel_ms(per_pass: Dict, substrings: Sequence[str]) -> float:
    """Device ms of one pass's kernels whose name holds any of `substrings`."""
    return sum(ns for name, ns in per_pass["kernel_ns"].items()
               if any(s in name for s in substrings)) / 1e6
