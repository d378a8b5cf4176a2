"""The comparison that decides `correct`, at sizes a test run holds: the
reference agrees with the program on the CPU; the control (the reference
with a short k-mer hash in the program's place) fails it; and a run of
the harness with the timed path broken underneath reads not correct, once
for each fault a cell can have on one card (the exchange between cards is
not on this path).  The control at the cells' own sizes runs on the card
(portbench/control.py)."""

import json
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.lib import genomes, registry  # noqa: E402
from portbench.reference import check, junctions  # noqa: E402

TINY = {"kind": "chromosomes", "genomes": 2, "chromosomes": 2, "chromosome_length": 8000,
        "divergence": 0.04, "inversions": 2, "inversion_min": 200, "inversion_max": 2000,
        "deletions": 8, "deletion_min": 20, "deletion_max": 200}
TINY_STRAINS = {"kind": "strains", "strains": 5, "length": 6000, "divergence": 0.01,
                "inversion_every": 3, "repeats": [{"length": 400, "copies": 2,
                                                    "divergence": 0.005}]}


# the strain cells' flags (k=15 for bacteria, the defaults otherwise)
STRAINS_K15 = {"k": 15, "a": 150, "b": 200, "m": 50, "t": 4, "lcb_engine": "tpu-fused"}


def cfg_of(name, **kw):
    """A configuration file of portbench/configs/, some keys replaced."""
    if name == "strains-k15":
        return dict(STRAINS_K15, **kw)
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return dict(json.load(f), **kw)


def names_seqs(traffic, seed):
    gs = genomes.generate(traffic, seed)
    return [n for g in gs for n, _ in g], [s for g in gs for _, s in g]


def tiny_run(traffic, cfg, seed, tmp_path, seconds=0.5):
    import portbench.run as run

    return run.measure("tiny", cfg, traffic, seed, seconds, False, "cpu", 1, [],
                       str(tmp_path), time.time())


def test_junctions_equal_the_ports_oracle():
    from sibeliaz_tpu_torch.graph import oracle

    rng = np.random.default_rng(3)
    base = genomes.decode(rng.integers(0, 4, 2500).astype(np.uint8))
    seqs = []
    for g in range(3):
        s = base.copy()
        m = np.flatnonzero(rng.random(len(s)) < 0.02)
        s[m] = genomes.decode(rng.integers(0, 4, len(m)).astype(np.uint8))
        if g == 1:
            s[500:900] = genomes.reverse_complement(s[500:900])
        if g == 2:
            s[100:120] = ord("N")
        seqs.append(s)
    for k in (5, 15, 25, 31):
        want = oracle.enumerate_junctions(seqs, k)
        got = junctions.enumerate_junctions(seqs, k)
        assert check.records_diff(got, [(w.pos, w.ids) for w in want]) == 0


@pytest.mark.parametrize("traffic,config,seed", [
    (TINY, "sibeliaz-example-k25", 2**31 + 3),
    (TINY_STRAINS, "strains-k15", 2**31 + 4),
])
def test_sound_run_is_correct_and_the_control_is_not(traffic, config, seed, tmp_path):
    cfg = cfg_of(config, warmup_bp=2000)
    res = tiny_run(traffic, cfg, seed, tmp_path)
    assert res["correct"], res["check"]
    assert all(c["value"] == 0 for c in res["check"].values())
    names, seqs = names_seqs(traffic, seed)
    ref = check.reference(seqs, names, cfg, workers=2)
    assert ref["about"]["blocks"] > 0
    # 24-bit keys collide at this size as 32-bit ones do at the cells'
    got = check.compare(check.control(seqs, names, cfg, key_bits=24), ref)
    assert got["graph_diff"] > 0 and got["table_diff"] > 0, got


def broken(monkeypatch, kind):
    from sibeliaz_tpu_torch import cli
    from sibeliaz_tpu_torch.graph import construct
    from sibeliaz_tpu_torch.output import gff

    if kind == "state_unchanged":  # a pass after the warm-up writes nothing
        real, calls = cli.run, []

        def run(argv):
            calls.append(argv)
            return real(argv) if len(calls) == 1 else 0
        monkeypatch.setattr(cli, "run", run)
    elif kind == "half_left_out":  # the graph of half the sequences only
        real = construct.build_junctions

        def build(seqs, *a, **kw):
            recs = real(seqs, *a, **kw)
            return recs[: len(recs) // 2] + [type(r)(pos=r.pos[:0], ids=r.ids[:0])
                                              for r in recs[len(recs) // 2:]]
        monkeypatch.setattr(construct, "build_junctions", build)
    elif kind in ("answer_altered", "last_answer_altered"):
        # the first (last) block's instance on its first sequence one base longer
        real = gff.render_gff
        pick = min if kind == "answer_altered" else max

        def render(blocks, names, lengths):
            blocks = list(blocks)
            i = pick(range(len(blocks)), key=lambda j: (blocks[j].block_id, -blocks[j].chr))
            b = blocks[i]
            blocks[i] = type(b)(b.signed_id, b.chr, b.start, min(b.end + 1, lengths[b.chr]))
            if blocks[i].end == b.end:
                blocks[i] = type(b)(b.signed_id, b.chr, b.start + 1, b.end)
            return real(blocks, names, lengths)
        monkeypatch.setattr(gff, "render_gff", render)


@pytest.mark.parametrize("kind,number", [
    ("state_unchanged", "passes_differ"),
    ("half_left_out", "graph_diff"),
    ("answer_altered", "lcb_diff"),
    ("last_answer_altered", "lcb_diff"),
])
def test_a_broken_timed_path_reads_not_correct(kind, number, monkeypatch, tmp_path):
    broken(monkeypatch, kind)
    cfg = cfg_of("sibeliaz-example-k25", warmup_bp=2000)
    res = tiny_run(TINY, cfg, 2**31 + 11, tmp_path)
    assert not res["correct"]
    assert res["check"][number]["value"] > 0, res["check"]


@pytest.mark.parametrize("workers", [1, 3])
def test_reference_gff_is_the_programs_byte_for_byte(workers, tmp_path):
    """The reference's whole GFF, on one process or on forked explorers,
    is the file the program writes, row for row."""
    import portbench.run as run
    from sibeliaz_tpu_torch import cli

    cfg = cfg_of("sibeliaz-example-k25")
    names, seqs = names_seqs(TINY, 2**31 + 5)
    paths = []
    for g, genome in enumerate(genomes.generate(TINY, 2**31 + 5)):
        paths.append(str(tmp_path / f"g{g}.fa"))
        genomes.write_fasta(paths[-1], genome)
    got_names, got_seqs = check.read_fasta(paths)
    assert got_names == names and all((a == b).all() for a, b in zip(got_seqs, seqs))
    out = str(tmp_path / "out")
    cli.run(run.program_argv(cfg, paths, out, os.path.join(out, "graph.dbg"), "cpu"))
    want = (tmp_path / "out" / "blocks_coords.gff").read_text()
    ref = check.reference(seqs, names, cfg, workers=workers)
    assert ref["about"]["blocks"] > 10
    assert ref["gff"] == want


@pytest.mark.gpu
def test_a_run_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    import portbench.run as run

    cfg = cfg_of("sibeliaz-example-k25", warmup_bp=2000)
    res = run.measure("tiny", cfg, TINY, 2**31 + 21, 1.0, True, "cuda", 1,
                      registry.load_benchmark()["per_layer"], str(tmp_path), time.time())
    assert res["correct"], res["check"]
    assert res["device"]["busy_s"] > 0 and "k7_device_ms" in res["metrics"]
    json.dumps(res)
