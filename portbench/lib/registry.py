"""Finds a cell's files by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration, whose file the
`configs` entry gives (`portbench/configs/<name>.json`: the program's
flags and the warm-up), and a traffic mix
(`portbench/traffic/<name>.json`: a generator's kind and its parameters;
the generator is `portbench/generators/<kind>.py`, see genomes.py).  A
per-layer metric `<name>` is read by `portbench/metrics/<name>.py`, whose
`read(ctx)` returns a number or None (nothing to read in this run).  Adding a cell, a configuration, a mix, a
generator or a metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # portbench/
ROOT = os.path.dirname(HERE)  # the checkout


def load_benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: Dict, workload: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"portbench: no workload named {workload!r} in BENCHMARK.json; "
                     f"the workloads are {[w['name'] for w in bench['workloads']]}")


def config(bench: Dict, name: str, root: str = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise SystemExit(f"portbench: no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, here: str = HERE) -> Dict:
    with open(os.path.join(here, "traffic", f"{name}.json")) as f:
        return json.load(f)


def per_layer_of(bench: Dict, workload: str) -> List[Dict]:
    """The per-layer metrics this cell reports: those whose `workloads`
    name it, and those without `workloads`."""
    return [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]


def _load(here: str, folder: str, name: str, attr: str) -> Callable:
    path = os.path.join(here, folder, f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: no file {folder}/{name}.py in {here}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


def reader(name: str, here: str = HERE) -> Callable:
    """A per-layer metric's reader: `portbench/metrics/<name>.py`'s `read`."""
    return _load(here, "metrics", name, "read")


def generator(kind: str, here: str = HERE) -> Callable:
    """A traffic kind's generator: `portbench/generators/<kind>.py`'s
    `generate(rng, params, seed)`."""
    return _load(here, "generators", kind, "generate")
