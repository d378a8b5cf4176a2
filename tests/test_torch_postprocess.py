"""The port's post-processing tools against the JAX package's, on the CPU:
twins of tests/test_postprocess.py and tests/test_synteny_properties.py.

Each case runs through both packages' functions on the same MAF or GFF
(written by the port's pipeline) and requires byte-equal output: GFA text
and glued genomes, XMFA text, every file synteny.run writes, parse_stages
results, and tools.main's output for each subcommand.  No tolerance: all
comparisons are exact."""

import io
import os

import numpy as np
import pytest

from sibeliaz_tpu.postprocess import gfa as jax_gfa
from sibeliaz_tpu.postprocess import synteny as jax_synteny
from sibeliaz_tpu.postprocess import xmfa as jax_xmfa
from sibeliaz_tpu.tools import main as jax_tools_main
from sibeliaz_tpu_torch import pipeline
from sibeliaz_tpu_torch.align import msa
from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.io import fasta
from sibeliaz_tpu_torch.postprocess import gfa, synteny, xmfa
from sibeliaz_tpu_torch.tools import main as tools_main

from reference_oracle import random_related_genomes
from test_synteny_properties import gen

# tests/test_postprocess.py's inputs: seed 40 with an inversion, 41, 42
CASES = {40: dict(rearrange=True), 41: {}, 42: {}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per seed: the genomes, the port's result, and its MAF, GFF and FASTA."""
    out = {}
    for seed, kwargs in CASES.items():
        d = tmp_path_factory.mktemp(f"run{seed}")
        seqs, names = random_related_genomes(seed, length=2500, mut=0.02, **kwargs)
        res = pipeline.find_blocks(seqs, names, Config(k=15), device="cpu")
        maf, gff, fa = str(d / "alignment.maf"), str(d / "blocks_coords.gff"), str(d / "g.fa")
        msa.align_blocks_to_maf(res.blocks, seqs, names, maf, cmd="t", device="cpu")
        with open(gff, "w") as f:
            f.write(res.gff)
        fasta.write_fasta(fa, [fasta.FastaRecord(n, s) for n, s in zip(names, seqs)])
        out[seed] = dict(seqs=seqs, names=names, res=res, maf=maf, gff=gff, fa=fa)
    return out


def as_tuples(occs):
    return [(o.block, o.chr, o.start, o.end) for o in occs]


def tree(root):
    """Every file under `root` by relative path, with its bytes."""
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            files[os.path.relpath(p, root)] = open(p, "rb").read()
    return files


@pytest.mark.parametrize("seed", sorted(CASES))
def test_gfa_and_glue_match_jax(runs, tmp_path, seed):
    r = runs[seed]
    genomes = dict(zip(r["names"], r["seqs"]))
    out, jax_out = io.StringIO(), io.StringIO()
    gfa.maf_to_gfa(r["maf"], genomes, out)
    jax_gfa.maf_to_gfa(r["maf"], genomes, jax_out)
    assert out.getvalue() == jax_out.getvalue()
    path = tmp_path / "g.gfa"
    path.write_text(out.getvalue())
    glued = gfa.glue(str(path))
    assert glued == jax_gfa.glue(str(path))
    for n, s in zip(r["names"], r["seqs"]):
        assert glued[n] == alphabet.seq_to_str(s), f"round-trip failed for {n}"


@pytest.mark.parametrize("seed", sorted(CASES))
def test_xmfa_matches_jax(runs, seed):
    out, jax_out = io.StringIO(), io.StringIO()
    xmfa.maf_to_xmfa(runs[seed]["maf"], out)
    jax_xmfa.maf_to_xmfa(runs[seed]["maf"], jax_out)
    assert out.getvalue() == jax_out.getvalue()
    assert out.getvalue().startswith("#FormatVersion Mauve1\n")
    assert out.getvalue().count("=\n") == runs[seed]["res"].blocks_found


@pytest.mark.parametrize("schedule", ["fine", "loose"])
@pytest.mark.parametrize("source", ["gff", "maf"])
@pytest.mark.parametrize("seed", sorted(CASES))
def test_synteny_run_matches_jax(runs, tmp_path, seed, source, schedule):
    path = runs[seed][source]
    stages = synteny.parse_stages(schedule)
    synteny.run(path, str(tmp_path / "port"), [100, 1000], stages=stages)
    jax_synteny.run(path, str(tmp_path / "jax"), [100, 1000], stages=stages)
    got = tree(tmp_path / "port")
    assert got == tree(tmp_path / "jax")
    assert sorted(got) == [f"{b}/{f}" for b in (100, 1000) for f in (
        "blocks_coords.txt", "coverage_report.txt", "genomes_permutations.txt")]
    assert b"Block #1" in got["100/blocks_coords.txt"]


@pytest.mark.parametrize("min_block", [500, 1000, 5000])
@pytest.mark.parametrize("schedule", ["FINE_STAGES", "LOOSE_STAGES"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_build_synteny_matches_jax(seed, schedule, min_block):
    """test_synteny_properties.py's generator, both schedules."""
    occs, sizes = gen(seed)
    jax_occs = [jax_synteny.Occ(o.block, o.chr, o.start, o.end) for o in occs]
    got = synteny.build_synteny(occs, len(sizes), min_block, getattr(synteny, schedule))
    want = jax_synteny.build_synteny(jax_occs, len(sizes), min_block,
                                     getattr(jax_synteny, schedule))
    assert got and as_tuples(got) == as_tuples(want)


# test_postprocess.py's hand-laid cases: (occurrences, chromosomes, min_block)
HAND_LAID = {
    "bulge_skip_and_inversion": ([
        (1, 0, 0, 2000), (4, 0, 2010, 2050), (2, 0, 2060, 4060), (3, 0, 4100, 6100),
        (1, 1, 0, 2000), (2, 1, 2030, 4030), (-3, 1, 4100, 6100),
        (1, 2, 0, 2000), (5, 2, 2010, 2045), (2, 2, 2055, 4055)], 3, 1000),
    "terminal_occurrence": ([(1, 0, 0, 6000), (2, 0, 6000, 12000), (1, 1, 0, 6000)], 2, 100),
    "true_bulge": ([
        (1, 0, 0, 5000), (9, 0, 5100, 5900), (2, 0, 6000, 11000),
        (1, 1, 0, 5000), (2, 1, 5030, 10030), (1, 2, 0, 5000), (2, 2, 5040, 10040)], 3, 2000),
    "gap_bound": ([
        (1, 0, 0, 5000), (9, 0, 5100, 45000), (2, 0, 45100, 50100),
        (1, 1, 0, 5000), (2, 1, 5030, 10030)], 2, 2000),
    "noise_absorbed": ([
        (1, c, 0, 4000) for c in range(2)] + [(900 + c, c, 4005, 4055) for c in range(2)]
        + [(2, c, 4060, 9000) for c in range(2)], 2, 5000),
}


@pytest.mark.parametrize("case", sorted(HAND_LAID))
def test_build_synteny_hand_laid_matches_jax(case):
    rows, n_chr, min_block = HAND_LAID[case]
    got = synteny.build_synteny([synteny.Occ(*r) for r in rows], n_chr, min_block)
    want = jax_synteny.build_synteny([jax_synteny.Occ(*r) for r in rows], n_chr, min_block)
    assert got and as_tuples(got) == as_tuples(want)


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 7, 11])
def test_random_backbone_matches_jax(seed):
    """TestSyntenyProperties._random_case's backbone with per-genome
    indels and inversions, at three scales."""
    rng = np.random.default_rng(seed)
    rows = []
    for c in range(3):
        pos = 0
        for bid in range(1, 13):
            ln, gap = int(rng.integers(200, 3000)), int(rng.integers(0, 120))
            strand = -1 if rng.random() < 0.15 else 1
            if rng.random() < 0.8:
                rows.append((strand * bid, c, pos, pos + ln))
                pos += ln + gap
    for mbs in (200, 1000, 4000):
        got = synteny.build_synteny([synteny.Occ(*r) for r in rows], 3, mbs)
        want = jax_synteny.build_synteny([jax_synteny.Occ(*r) for r in rows], 3, mbs)
        assert as_tuples(got) == as_tuples(want)


@pytest.mark.parametrize("text", [
    "# custom schedule\n30 10\n\n200 500  # wide\n",
    "30 10\n500 1000\n",
    "30\n",
    "# nothing\n",
])
def test_parse_stages_matches_jax(tmp_path, text):
    path = tmp_path / "stages.txt"
    path.write_text(text)
    assert synteny.parse_stages("fine") == jax_synteny.parse_stages("fine") == synteny.FINE_STAGES
    assert synteny.parse_stages("loose") == jax_synteny.parse_stages("loose")
    assert synteny.LOOSE_STAGES[: len(synteny.FINE_STAGES)] == synteny.FINE_STAGES
    results = []
    for parse in (synteny.parse_stages, jax_synteny.parse_stages):
        try:
            results.append(parse(str(path)))
        except ValueError as e:
            results.append(("ValueError", str(e)))
    assert results[0] == results[1]


def tools_output(main, argv, capsys, monkeypatch, stdin=None):
    if stdin is not None:
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["maf2gfa", "glue", "maf2xmfa", "maf2xmfa-stdin", "synteny"])
def test_tools_main_matches_jax(runs, tmp_path, capsys, monkeypatch, cmd):
    r = runs[40]
    stdin = None
    if cmd == "maf2gfa":
        argv = ["maf2gfa", r["maf"], r["fa"]]
    elif cmd == "glue":
        graph = tmp_path / "g.gfa"
        assert tools_main(["maf2gfa", r["maf"], r["fa"]]) == 0
        graph.write_text(capsys.readouterr().out)
        argv = ["glue", str(graph)]
    elif cmd == "maf2xmfa":
        argv = ["maf2xmfa", r["maf"]]
    elif cmd == "maf2xmfa-stdin":
        argv, stdin = ["maf2xmfa"], open(r["maf"]).read()
    else:
        argv = ["synteny", r["gff"], "-b", "100", "5000", "-s", "loose"]
    got = tools_output(tools_main, argv + (["-o", str(tmp_path / "port")] if cmd == "synteny" else []),
                       capsys, monkeypatch, stdin)
    want = tools_output(jax_tools_main, argv + (["-o", str(tmp_path / "jax")] if cmd == "synteny" else []),
                        capsys, monkeypatch, stdin)
    assert got == want
    if cmd == "synteny":
        assert tree(tmp_path / "port") == tree(tmp_path / "jax")
        assert (tmp_path / "port" / "100" / "blocks_coords.txt").exists()
    else:
        assert got
    if cmd == "glue":
        genomes = dict(line.split("\n") for line in got[1:].rstrip("\n").split("\n>"))
        assert genomes == {n: alphabet.seq_to_str(s) for n, s in zip(r["names"], r["seqs"])}


def test_tools_prog_is_the_ports(capsys):
    with pytest.raises(SystemExit) as e:
        tools_main(["--help"])
    assert e.value.code == 0
    assert capsys.readouterr().out.startswith("usage: sibeliaz-tpu-torch-tools")
