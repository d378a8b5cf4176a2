"""The benchmark's copies of the repository's two genome generators write
the same bytes as the originals."""

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench.lib import genomes  # noqa: E402

TRAFFIC = os.path.join(ROOT, "portbench", "traffic")

# tests/test_examples_dir.py::LARGE_SHA: examples/large/make_large_example.py's
# FASTA files at its SEED 33
LARGE_SHA = {
    "genome1.fa": "f44bc27bba29089c1f142796f0a4631131a8668908d83fb149aac67868e0c6cc",
    "genome2.fa": "ea148275a6a76583ddd7eff23a66fb1d48c33a4d8110d51aa770de11f2d52a89",
}
# SHA-256 of bench.py's make_input() sequences (seed 2024), their bytes one
# after another in strain order, taken once on the CPU from bench.py itself
STRAINS_SHA = "b2a836458a3ecf8c87d1e5535213e9c89dba63694506e8cb9839da6ae4fbe62e"


# the mixes of the strain cells (PERF.md, Open questions): bench.py's
# strains, and the same with two shared repeat families a strain
STRAINS16 = {"kind": "strains", "strains": 16, "length": 1000000, "divergence": 0.01,
             "inversion_every": 3}
STRAINS16_REPEATS = dict(STRAINS16, repeats=[
    {"length": 5000, "copies": 4, "divergence": 0.005},
    {"length": 1300, "copies": 4, "divergence": 0.005}])


def traffic(name):
    with open(os.path.join(TRAFFIC, f"{name}.json")) as f:
        return json.load(f)


def test_example_copy_writes_the_large_examples_fasta(tmp_path):
    mix = traffic("example-large")
    del mix["content_seed"]  # the seed draws the content itself
    for g, genome in enumerate(genomes.generate(mix, 33), start=1):
        path = tmp_path / f"genome{g}.fa"
        genomes.write_fasta(str(path), genome)
        assert hashlib.sha256(path.read_bytes()).hexdigest() == LARGE_SHA[f"genome{g}.fa"]


def test_strains_copy_is_bench_make_input():
    gs = genomes.generate(STRAINS16, 2024)
    assert [n for g in gs for n, _ in g] == [f"Strain{i + 1}.Chr1" for i in range(16)]
    h = hashlib.sha256()
    for g in gs:
        h.update(g[0][1].tobytes())
    assert h.hexdigest() == STRAINS_SHA


def test_repeats_keep_the_strains_and_share_the_families():
    plain = genomes.generate(STRAINS16, 2**31 + 9)
    rep_t = STRAINS16_REPEATS
    rep = genomes.generate(rep_t, 2**31 + 9)
    extra = sum(f["length"] * f["copies"] for f in rep_t["repeats"])
    for (_, a), (_, b) in zip((g[0] for g in plain), (g[0] for g in rep)):
        assert len(b) == len(a) + extra
    # the same seed, the same bytes; another seed, others
    again = genomes.generate(rep_t, 2**31 + 9)
    assert all((a[0][1] == b[0][1]).all() for a, b in zip(rep, again))
    other = genomes.generate(rep_t, 2**31 + 10)
    assert any(len(a[0][1]) != len(b[0][1]) or (a[0][1] != b[0][1]).any()
               for a, b in zip(rep, other))


def test_content_seed_fixes_the_genomes_and_the_seed_their_order():
    mix = traffic("example-large")
    assert mix["content_seed"] == 33
    plain = dict(mix)
    del plain["content_seed"]
    golden = {n: s for g in genomes.generate(plain, 33) for n, s in g}
    orders = set()
    for seed in (1, 2, 3, 2**31 + 5, 2**33 + 7):
        gs = genomes.generate(mix, seed)
        assert sorted(n for g in gs for n, _ in g) == sorted(golden)
        assert all((s == golden[n]).all() for g in gs for n, s in g)
        assert all(len({n.split(".")[0] for n, _ in g}) == 1 for g in gs)  # genomes stay whole
        orders.add(tuple(n for g in gs for n, _ in g))
    assert len(orders) > 1


def test_large_seeds_are_taken():
    small = dict(traffic("example-large"), chromosome_length=30_000)
    gs = genomes.generate(small, 2**33 + 5)
    assert len(gs) == 2 and len(gs[0]) == 4
