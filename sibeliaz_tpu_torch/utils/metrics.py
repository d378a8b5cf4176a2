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
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional


class Metrics:
    def __init__(self) -> None:
        self.timings: List[Dict] = []
        self.counters: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, **attrs) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.timings.append(
                {"stage": name, "seconds": time.time() - t0, **attrs}
            )

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
