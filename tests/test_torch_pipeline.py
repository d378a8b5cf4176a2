"""The port's pipeline and CLI against the JAX package and the committed
golden GFF: byte-equal output (and MAF bodies without -n), records that
cross between the packages in either direction, and the CLI's refusals."""

import os

import numpy as np
import pytest
import torch

from sibeliaz_tpu import pipeline as jax_pipeline
from sibeliaz_tpu.cli import run as jax_run
from sibeliaz_tpu.config import Config as JaxConfig
from sibeliaz_tpu.graph import construct as jax_construct
from sibeliaz_tpu.io import dbg as jax_dbg
from sibeliaz_tpu_torch import pipeline
from sibeliaz_tpu_torch.cli import run
from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.graph import construct
from sibeliaz_tpu_torch.io import dbg, fasta

from reference_oracle import random_related_genomes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
GOLDEN = os.path.join(EXAMPLES, "sibeliaz_out", "blocks_coords.gff")
EXAMPLE_FASTAS = [os.path.join(EXAMPLES, f"genome{g}.fa") for g in (1, 2)]


def write_inputs(tmp_path, seqs, names):
    fa = tmp_path / "genomes.fa"
    fasta.write_fasta(
        str(fa), [fasta.FastaRecord(n, s) for n, s in zip(names, seqs)]
    )
    return str(fa)


def test_examples_gff_matches_golden():
    recs = fasta.read_many(EXAMPLE_FASTAS)
    res = pipeline.find_blocks(
        [r.seq for r in recs], [r.name for r in recs], Config(k=15),
        device="cpu",
    )
    with open(GOLDEN) as f:
        assert res.gff == f.read()
    assert res.blocks_found == 11


@pytest.mark.parametrize(
    "seed,kwargs",
    [
        (60, dict(length=3000, mut=0.01)),
        (61, dict(length=2500, mut=0.02, rearrange=True, n_prob=0.002)),
        (62, dict(n_genomes=3, n_chr=2, length=1500, mut=0.015, rearrange=True)),
    ],
)
def test_gff_matches_jax_pipeline(seed, kwargs):
    seqs, names = random_related_genomes(seed, **kwargs)
    want = jax_pipeline.find_blocks(seqs, names, JaxConfig(k=15))
    got = pipeline.find_blocks(seqs, names, Config(k=15), device="cpu")
    assert got.gff == want.gff
    assert got.blocks_found == want.blocks_found > 0


def test_cross_feed_records_and_dbg(tmp_path):
    seqs, names = random_related_genomes(63, length=2500, mut=0.02, rearrange=True)
    jax_records = jax_construct.build_junctions(seqs, 15)
    port_records = construct.build_junctions(seqs, 15, "cpu")
    want = jax_pipeline.find_blocks(seqs, names, JaxConfig(k=15), records=jax_records)
    # JAX records through the port's table, LCB engine and writers
    got = pipeline.find_blocks(seqs, names, Config(k=15), records=jax_records)
    assert got.gff == want.gff
    # .dbg files written by each package read back by the other
    jax_path, port_path = str(tmp_path / "jax.dbg"), str(tmp_path / "port.dbg")
    jax_dbg.write_dbg(jax_path, jax_records)
    dbg.write_dbg(port_path, port_records)
    assert open(jax_path, "rb").read() == open(port_path, "rb").read()
    for a, b in zip(dbg.read_dbg(jax_path), jax_dbg.read_dbg(port_path)):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)


def maf_body(path):
    return [l for l in path.read_text().splitlines() if not l.startswith("# cmd=")]


@pytest.mark.parametrize("align", [False, True], ids=["noalign", "maf"])
def test_cli_matches_jax_cli(tmp_path, align):
    seqs, names = random_related_genomes(64, length=2000, mut=0.02, rearrange=True)
    fa = write_inputs(tmp_path, seqs, names)
    out_j, out_p = tmp_path / "jax", tmp_path / "port"
    common = ["-k", "15", "--legacy-chunks", "3"] + ([] if align else ["-n"])
    assert jax_run(common + ["-o", str(out_j), fa]) == 0
    assert run(common + ["--device", "cpu", "-o", str(out_p), fa]) == 0
    for name in ["blocks_coords.gff", "0.tmp", "1.tmp", "2.tmp"]:
        assert (out_p / name).read_bytes() == (out_j / name).read_bytes(), name
    assert (out_p / "alignment.maf").exists() == align
    if align:
        body = maf_body(out_p / "alignment.maf")
        assert body == maf_body(out_j / "alignment.maf")
        assert "a" in body


def test_cli_graph_checkpoint_roundtrip(tmp_path):
    out1, out2, g = tmp_path / "o1", tmp_path / "o2", tmp_path / "g.dbg"
    common = ["-k", "15", "-n", "--device", "cpu"]
    assert run(common + ["-o", str(out1), "--dump-graph", str(g), *EXAMPLE_FASTAS]) == 0
    assert run(common + ["-o", str(out2), "--graph", str(g), *EXAMPLE_FASTAS]) == 0
    golden = open(GOLDEN, "rb").read()
    assert (out1 / "blocks_coords.gff").read_bytes() == golden
    assert (out2 / "blocks_coords.gff").read_bytes() == golden


def test_cli_help(capsys):
    with pytest.raises(SystemExit) as e:
        run(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize(
    "extra",
    [
        ["-n", "--lcb-engine", "resident"],
        ["-n", "--align-engine", "cuda"],
    ],
)
def test_cli_refuses(tmp_path, capsys, extra):
    """Engine names the JAX package's CLI does not take (`resident` is a
    name its pipeline takes, as the port's does): refused, as there."""
    with pytest.raises(SystemExit) as e:
        run(["-k", "15", "--device", "cpu", "-o", str(tmp_path), *extra,
             *EXAMPLE_FASTAS])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        jax_run(["-k", "15", "-o", str(tmp_path), *extra, *EXAMPLE_FASTAS])
    assert e.value.code == 2


def test_find_blocks_refuses_an_unknown_engine():
    recs = fasta.read_many(EXAMPLE_FASTAS)
    with pytest.raises(NotImplementedError, match="no such engine"):
        pipeline.find_blocks([r.seq for r in recs], [r.name for r in recs], Config(k=15),
                             engine="bogus", device="cpu")


def test_cli_refuses_cuda_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(SystemExit) as e:
        run(["-k", "15", "-n", "-o", str(tmp_path), *EXAMPLE_FASTAS])
    assert "no CUDA device" in str(e.value.code)


def test_cli_refuses_wide_k(tmp_path):
    """k = 63 is past two limbs: Config refuses it, as the JAX package's."""
    with pytest.raises(ValueError, match=r"\[3, 61\]"):
        run(["-k", "63", "-n", "--device", "cpu", "-o", str(tmp_path),
             *EXAMPLE_FASTAS])
    with pytest.raises(ValueError, match=r"\[3, 61\]"):
        JaxConfig(k=63)


def test_cli_wide_k_matches_jax_cli(tmp_path):
    """tests/test_cli.py::test_cli_wide_k_cross_engine's input at k=33
    (two-limb keys): the port's GFF byte-equal to the JAX package's."""
    seqs, names = random_related_genomes(52, length=2500, mut=0.02)
    fa = write_inputs(tmp_path, seqs, names)
    out_j, out_p = tmp_path / "jax", tmp_path / "port"
    assert jax_run(["-k", "33", "-n", "-o", str(out_j), fa]) == 0
    assert run(["-k", "33", "-n", "--device", "cpu", "-o", str(out_p), fa]) == 0
    gff = (out_p / "blocks_coords.gff").read_bytes()
    assert gff == (out_j / "blocks_coords.gff").read_bytes()
    assert b"SO:0000856" in gff
