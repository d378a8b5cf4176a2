"""utils/metrics on the CPU: device_trace under SIBELIAZ_TPU_PROFILE
writes a torch.profiler trace file into that directory and records the
stage, as the JAX package's device_trace records it; without the variable
the stage alone is recorded and nothing is written.  A stage is a span
(start, end, parent), a summed span a counter of its seconds, each on the
profiler's timeline only while a profiler runs; records and counts go to
whatever `timings` and `counters` the caller has put in place."""

import json
import time

import pytest
import torch

from sibeliaz_tpu.utils import metrics as jax_metrics
from sibeliaz_tpu_torch.utils import metrics


def test_device_trace_writes_a_trace(tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("SIBELIAZ_TPU_PROFILE", str(trace_dir))
    metrics.GLOBAL.timings.clear()
    for _ in range(2):
        with metrics.device_trace("lcb_phase") as prof:
            torch.arange(1000).cumsum(0)
        assert prof is not None
        assert any("cumsum" in e.key for e in prof.key_averages())
    files = sorted(p.name for p in trace_dir.iterdir())
    assert len(files) == 2 and all(f.startswith("lcb_phase.") and f.endswith(".json")
                                   for f in files)
    assert json.loads((trace_dir / files[0]).read_text())["traceEvents"]
    assert [t["stage"] for t in metrics.GLOBAL.timings] == ["lcb_phase"] * 2


def test_device_trace_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("SIBELIAZ_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    metrics.GLOBAL.timings.clear()
    jax_metrics.GLOBAL.timings.clear()
    with metrics.device_trace("graph") as prof:
        torch.ones(4).sum()
    with jax_metrics.device_trace("graph"):
        pass
    assert prof is None
    assert list(tmp_path.iterdir()) == []
    got, want = metrics.GLOBAL.timings, jax_metrics.GLOBAL.timings
    assert [t["stage"] for t in got] == [t["stage"] for t in want] == ["graph"]
    assert got[0]["seconds"] >= 0


def test_a_stage_is_a_span_with_its_parent():
    """Each record has its start and end (ns on time.time_ns()), seconds
    their difference, and the enclosing open stage as its parent; records
    are appended at each stage's end, the innermost first."""
    m = metrics.Metrics()
    t0 = time.time_ns()
    with m.stage("lcb_engine", engine="tpu-fused"):
        with m.stage("lcb_seed"):
            pass
        with m.stage("lcb_commit"):
            with m.stage("inner"):
                pass
    t1 = time.time_ns()
    got = {t["stage"]: t for t in m.timings}
    assert [t["stage"] for t in m.timings] == ["lcb_seed", "inner", "lcb_commit", "lcb_engine"]
    assert {n: t["parent"] for n, t in got.items()} == {
        "lcb_engine": None, "lcb_seed": "lcb_engine", "lcb_commit": "lcb_engine",
        "inner": "lcb_commit"}
    for t in m.timings:
        assert t0 <= t["start"] <= t["end"] <= t1
        assert t["seconds"] == (t["end"] - t["start"]) / 1e9
    assert got["lcb_engine"]["engine"] == "tpu-fused"
    outer = got["lcb_engine"]
    assert all(outer["start"] <= t["start"] and t["end"] <= outer["end"] for t in m.timings)


def test_a_stage_that_raises_is_recorded_and_closed():
    m = metrics.Metrics()
    try:
        with m.stage("outer"):
            with m.stage("failing"):
                raise ValueError("x")
    except ValueError:
        pass
    with m.stage("after"):
        pass
    assert [(t["stage"], t["parent"]) for t in m.timings] == [
        ("failing", "outer"), ("outer", None), ("after", None)]


def test_stages_on_the_profilers_timeline():
    """Under a CPU torch.profiler each stage is a record_function event of
    its name whose start lies within 2 ms of the span's start."""
    m = metrics.Metrics()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with m.stage("lcb_seed"):
            torch.arange(1000).cumsum(0)
            with m.stage("lcb_decode"):
                time.sleep(0.005)
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    for t in m.timings:
        (e,) = events[t["stage"]]
        assert e.is_user_annotation()
        assert abs(e.start_ns() - t["start"]) < 2_000_000, t["stage"]


def test_no_record_function_without_a_profiler(monkeypatch):
    calls = []

    def record_function(name):
        calls.append(name)
        raise AssertionError("record_function with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    m = metrics.Metrics()
    with m.stage("lcb_engine"):
        with m.stage("lcb_seed"):
            pass
    assert calls == [] and len(m.timings) == 2


def test_a_summed_span_counts_its_seconds_and_appends_no_record(monkeypatch):
    """`summed` adds each span's seconds to the counter `<name>_s`, appends
    no record, and makes a record_function only while a profiler runs."""
    m = metrics.Metrics()
    with m.stage("lcb_engine"):
        for _ in range(3):
            with m.summed("lcb_seed"):
                time.sleep(0.002)
    assert [t["stage"] for t in m.timings] == ["lcb_engine"]
    assert 0.006 <= m.counters["lcb_seed_s"] <= m.timings[0]["seconds"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with m.summed("lcb_decode"):
            time.sleep(0.002)
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "lcb_decode"]
    assert e.is_user_annotation()
    assert e.duration_ns() / 1e9 == pytest.approx(m.counters["lcb_decode_s"], abs=2e-3)

    def record_function(name):
        raise AssertionError("record_function with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    with m.summed("lcb_decode"):
        pass


class Stamped(list):
    """A list that notes each append, as a benchmark's stand-in does."""

    def __init__(self):
        super().__init__()
        self.appends = 0

    def append(self, item):
        self.appends += 1
        super().append(item)


def test_timings_and_counters_replaced_between_calls_capture_every_span():
    """A caller may replace `timings` and `counters` by assignment, even
    while a stage is open: every stage and count goes to the objects in
    place when it ends, each stage appended once."""
    m = metrics.Metrics()
    m.count("before")
    with m.stage("outer"):
        m.timings, m.counters = Stamped(), {}
        with m.stage("inner"):
            m.count("k7_pushes", 3)
        m.count("k7_pushes", 2)
    first = m.timings
    assert [t["stage"] for t in first] == ["inner", "outer"] and first.appends == 2
    assert m.counters == {"k7_pushes": 5.0}
    m.timings, m.counters = Stamped(), {}
    with m.stage("next"):
        pass
    assert [t["stage"] for t in m.timings] == ["next"] and m.timings.appends == 1
    assert [t["stage"] for t in first] == ["inner", "outer"]
