"""utils/metrics.device_trace on the CPU: under SIBELIAZ_TPU_PROFILE a
torch.profiler trace file is written into that directory and the stage
is recorded, as the JAX package's device_trace records it; without the
variable the stage alone is recorded and nothing is written."""

import json

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
