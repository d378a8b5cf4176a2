"""The benchmark's arithmetic, on the CPU: the kernels' bytes, the idle
share from device intervals, the window's rate, and a cell, configuration,
mix and metric found by their files."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.lib import devtrace, genomes, registry, roofline, window  # noqa: E402


def test_k1_bytes_one_and_two_limbs():
    # 0.375 B in and 12 B out a position at k <= 31, 20 B out at k >= 33
    assert roofline.k1_bytes(8_000_000, 25) == 8_000_000 * 12.375
    assert roofline.k1_bytes(8_000_000, 33) == 8_000_000 * 20.375
    assert roofline.k1_bytes(9, 15) == 3 + 2 + 9 * 12  # the packed inputs round up
    assert roofline.k1_ops(10, 15) == 300 and roofline.k1_ops(10, 61) == 600


def test_k2_bytes_one_and_two_limbs():
    assert roofline.k2_bytes(1000, 15) == 21_000
    assert roofline.k2_bytes(1000, 33) == 29_000


def test_bound_takes_the_longer_and_the_share():
    n = 16_000_015
    t = roofline.bound_s(roofline.k1_bytes(n, 15), roofline.k1_ops(n, 15))
    assert t == pytest.approx(roofline.k1_bytes(n, 15) / 3.35e12)  # bytes bound it
    assert roofline.bound_s(0, 1e12) == pytest.approx(1e12 / (132 * 64 * 1.98e9))
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None


def test_idle_share_from_overlapping_intervals():
    # a pass over [0, 100) ns: kernels [10, 30), [20, 40) overlap, a copy
    # [50, 60), a kernel [95, 120) running past the pass's end
    dev = [("k_a", 10, 30), ("k_b", 20, 40), ("memcpy", 50, 60), ("k_a", 95, 120)]
    passes = [{"start": 0.0, "end": 100e-9,
               "spans": [("lcb_engine", 0.0, 45e-9), ("junction_table", 45e-9, 90e-9)]}]
    red = devtrace.reduce(dev, lambda t: int(round(t * 1e9)), passes)
    p = red["passes"][0]
    assert p["busy_s"] == pytest.approx(45e-9)  # 30 + 10 + 5
    assert p["idle_pct"] == pytest.approx(55.0)
    assert red["busy_s"] == pytest.approx(45e-9) and red["window_s"] == pytest.approx(100e-9)
    # idle [0, 10) in lcb_engine, [40, 50) and [60, 95) in junction_table
    # (each gap named by the span at its midpoint), the longest first
    gaps = [(n, round(s * 1e9)) for n, s in red["idle_gaps"]]
    assert gaps[0] == ("junction_table", 35)
    assert sorted(gaps[1:]) == [("junction_table", 10), ("lcb_engine", 10)]
    assert devtrace.kernel_ms(p, ("k_a",)) == pytest.approx(45e-6)  # 20 + 25 ns, by start
    assert red["device_ops"][0] == ["k_a", pytest.approx(45e-9)]


def test_union_and_gaps():
    m = devtrace.union([(5, 7), (1, 3), (2, 4), (7, 8)])
    assert m == [(1, 4), (5, 8)]
    assert devtrace.gaps(m, 0, 10) == [(0, 1), (4, 5), (8, 10)]
    assert devtrace.covered(m, 2, 6) == 3


def test_window_counts_the_pass_that_crosses_the_deadline():
    clock = {"t": 100.0}

    def run_pass(i):
        clock["t"] += 4.0  # each pass takes 4 s
        return {}

    passes = window.run_window(run_pass, 10.0, clock=lambda: clock["t"])
    # passes start at 100, 104, 108 (< 110) and the third ends at 112
    assert [(p["start"], p["end"]) for p in passes] == [(100, 104), (104, 108), (108, 112)]
    assert window.rate_mbp_s(passes, 6_000_000) == pytest.approx(3 * 6.0 / 12.0)


def test_a_failed_pass_counts_no_bases():
    passes = [{"start": 0.0, "end": 2.0}, {"start": 2.0, "end": 4.0, "failed": True}]
    assert window.rate_mbp_s(passes, 1_000_000) == pytest.approx(0.25)


def test_stamped_timings_keep_span_ends():
    t = window.StampedTimings()
    t.append({"stage": "lcb_engine", "seconds": 0.5})
    (name, a, b), = t.spans()
    assert name == "lcb_engine" and b - a == pytest.approx(0.5)
    assert window.span_seconds(t + [{"stage": "lcb_engine", "seconds": 0.25}]) == {"lcb_engine": 0.75}


def test_new_files_are_found_without_editing_any(tmp_path):
    """A cell, its configuration, its mix and a per-layer metric added as
    files and entries, in a copy of the benchmark: found by name."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = root / "portbench"
    (pb / "configs" / "tiny-k15.json").write_text(json.dumps({"k": 15, "a": 150}))
    (pb / "traffic" / "tiny.json").write_text(json.dumps({"kind": "strains", "strains": 2,
                                                         "length": 500, "divergence": 0.01,
                                                         "inversion_every": 3}))
    (pb / "metrics" / "tiny_metric.py").write_text("def read(ctx):\n    return 7.0\n")
    bench["configs"].append({"name": "tiny-k15", "source": "https://example.org",
                             "file": "portbench/configs/tiny-k15.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny.fused", "config": "tiny-k15", "traffic": "tiny",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "tiny_metric", "unit": "s", "better": "lower",
                               "source": "program_span", "layer": "device",
                               "moves": "gff_mbp_s", "workloads": ["tiny.fused"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = registry.load_benchmark(str(root))
    cell = registry.cell(loaded, "tiny.fused")
    assert registry.config(loaded, cell["config"], str(root)) == {"k": 15, "a": 150}
    assert registry.traffic(cell["traffic"], str(pb))["length"] == 500
    names = [m["name"] for m in registry.per_layer_of(loaded, "tiny.fused")]
    assert "tiny_metric" in names and "device_idle_pct" in names
    assert "tiny_metric" not in [m["name"] for m in
                                 registry.per_layer_of(loaded, "example-k25.fused")]
    assert registry.reader("tiny_metric", str(pb))({}) == 7.0


def test_a_new_generator_is_found_without_editing_any(tmp_path):
    """A traffic kind added as a file of portbench/generators/, in a copy
    of the benchmark: a mix naming it is generated from the seed."""
    pb = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (pb / "generators" / "tandem.py").write_text(
        "from portbench.lib.genomes import decode\n\n\n"
        "def generate(rng, p, seed):\n"
        "    unit = decode(rng.integers(0, 4, size=p['unit']).astype('uint8'))\n"
        "    return [[(f'g{g}.c1', unit.repeat(1).reshape(1, -1).repeat(p['copies'], 0).ravel())]\n"
        "            for g in range(p['genomes'])]\n")
    (pb / "traffic" / "tandem.json").write_text(json.dumps(
        {"kind": "tandem", "unit": 30, "copies": 5, "genomes": 3}))
    mix = registry.traffic("tandem", str(pb))
    gs = genomes.generate(mix, 2**31 + 1, here=str(pb))
    assert [n for g in gs for n, _ in g] == ["g0.c1", "g1.c1", "g2.c1"]
    assert all(len(g[0][1]) == 150 for g in gs)
    again = genomes.generate(mix, 2**31 + 1, here=str(pb))
    assert all((a[0][1] == b[0][1]).all() for a, b in zip(gs, again))
    with pytest.raises(SystemExit):
        genomes.generate(dict(mix, kind="absent"), 1, here=str(pb))


def test_every_metric_has_its_reader():
    bench = registry.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(registry.reader(m["name"]))
    for w in bench["workloads"]:
        registry.config(bench, w["config"])
        assert callable(registry.generator(registry.traffic(w["traffic"])["kind"]))
