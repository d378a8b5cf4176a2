"""Structured stage timing, counters, and profiler hooks.

The reference's observability is a 50-dot progress bar and two stdout lines
(SURVEY.md §5); here every pipeline stage reports into a process-wide
registry that can be dumped as JSON, and device work can be wrapped in a
`torch.profiler` trace (`SIBELIAZ_TPU_PROFILE=<dir>`).

How it differs from sibeliaz_tpu/utils/metrics.py: `device_trace` runs
`torch.profiler.profile` (CPU activity, and CUDA activity where a card is
visible) in place of `jax.profiler.trace`, writes one Chrome trace file a
call into the directory, and yields the profiler (None when the variable
is unset), whose `key_averages()` give the kernels' device times.  The
variable keeps the JAX package's name, so that the same command lines run
on both.

A stage is a span: its record gives `start` and `end` (ns on the
`time.time_ns()` clock, which a torch.profiler trace shares), `seconds`
(their difference) and `parent` (the enclosing open stage of the same
thread, or None).  A span that a run repeats hundreds of times (a phase's
or a lane set's part of the LCB engine) is `summed` instead: its seconds
go to the counter `<name>_s` and it appends no record: a trace reader
that names each idle gap of the device by the records holding it pays for
every record (~131k gaps a pass of the upstream example at k=25).  While a torch profiler
runs, either also opens a `torch.profiler.record_function` of its name,
so that it stands on the trace's own timeline; with none running none is
made (a record_function costs ~15 us, the check ~0.1 us).  `timings` and
`counters` are looked up at every call and a record is appended once, at
the stage's end: a caller may replace either attribute between calls.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional


def _annotation(name: str):
    """An entered torch.profiler.record_function of `name` while a torch
    profiler runs (never where torch is not imported), else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return None
    from torch.profiler import record_function

    span = record_function(name)
    span.__enter__()
    return span


class Metrics:
    def __init__(self) -> None:
        self.timings: List[Dict] = []
        self.counters: Dict[str, float] = {}
        self._open = threading.local()

    @contextlib.contextmanager
    def stage(self, name: str, **attrs) -> Iterator[None]:
        stack = self._open.__dict__.setdefault("names", [])
        parent = stack[-1] if stack else None
        stack.append(name)
        span = _annotation(name)
        start = time.time_ns()
        try:
            yield
        finally:
            end = time.time_ns()
            if span is not None:
                span.__exit__(None, None, None)
            stack.pop()
            self.timings.append({"stage": name, "seconds": (end - start) / 1e9, "start": start,
                                 "end": end, "parent": parent, **attrs})

    @contextlib.contextmanager
    def summed(self, name: str) -> Iterator[None]:
        """A span repeated many times a run: its seconds added to the
        counter `<name>_s`, on the profiler's timeline as a stage is, no
        record."""
        span = _annotation(name)
        start = time.time_ns()
        try:
            yield
        finally:
            end = time.time_ns()
            if span is not None:
                span.__exit__(None, None, None)
            self.count(f"{name}_s", (end - start) / 1e9)

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set(self, name: str, value: float) -> None:
        self.counters[name] = value

    def report(self) -> str:
        return json.dumps(
            {"timings": self.timings, "counters": self.counters}, indent=2
        )

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.report())


GLOBAL = Metrics()


@contextlib.contextmanager
def device_trace(name: str) -> Iterator[Optional[object]]:
    """Wrap device work in a torch.profiler trace when SIBELIAZ_TPU_PROFILE
    names a trace directory (the trace goes to
    `<dir>/<name>.<pid>.<n>.pt.trace.json`); either way a timing stage."""
    trace_dir = os.environ.get("SIBELIAZ_TPU_PROFILE")
    if not trace_dir:
        with GLOBAL.stage(name):
            yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with GLOBAL.stage(name):
            yield prof
    n = sum(f.startswith(f"{name}.{os.getpid()}.") for f in os.listdir(trace_dir))
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.{os.getpid()}.{n}.pt.trace.json"))
