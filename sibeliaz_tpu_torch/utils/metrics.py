"""Structured stage timing and counters.

The reference's observability is a 50-dot progress bar and two stdout lines
(SURVEY.md §5); here every pipeline stage reports into a process-wide
registry that can be dumped as JSON."""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, Iterator, List


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
