"""The port's alignment stage against the JAX package and the committed
golden MAF: the native POA engine compiled by path, MAF assembly with
overflow blocks, and the CLI without -n on both POA engines."""

import os

import numpy as np
import pytest

from sibeliaz_tpu.align import msa as jax_msa
from sibeliaz_tpu.cli import run as jax_run
from sibeliaz_tpu.lcb.blocks import Block as JaxBlock
from sibeliaz_tpu_torch.align import msa
from sibeliaz_tpu_torch.cli import run
from sibeliaz_tpu_torch.io import fasta
from sibeliaz_tpu_torch.lcb.blocks import Block
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from reference_oracle import random_related_genomes
from torch_cases import ACGT, rand_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
EXAMPLE_FASTAS = [os.path.join(EXAMPLES, f"genome{g}.fa") for g in (1, 2)]


def maf_body(path):
    # drop the '# cmd=' provenance line (argv differs by construction)
    return "\n".join(
        l for l in path.read_text().splitlines() if not l.startswith("# cmd=")
    )


@pytest.mark.parametrize("seed", range(4))
def test_native_poa_matches_jax(seed):
    rng = np.random.default_rng(40 + seed)
    blocks = [
        rand_block(rng, int(rng.integers(30, 700)), int(rng.integers(2, 6)),
                   mut=float(rng.choice([0.02, 0.1])))
        for _ in range(5)
    ]
    want = jax_msa.poa_msa_batch(blocks, threads=2)
    assert msa.poa_msa_batch(blocks, threads=2) == want
    # a budget too small for the larger blocks marks them None in both
    assert (msa.poa_msa_batch(blocks, budget_bytes=40_000)
            == jax_msa.poa_msa_batch(blocks, budget_bytes=40_000))


def test_align_blocks_to_maf_matches_jax(tmp_path):
    """MAF assembly byte for byte: chunk fan-out order, reverse-strand rows
    and the overflow blocks written to blocks/<id>.fa."""
    rng = np.random.default_rng(12)
    seqs = [ACGT[rng.integers(0, 4, size=900)] for _ in range(3)]
    seqs[1][100:400] = seqs[0][200:500]
    seqs[2][500:800] = seqs[0][200:500]
    names = ["chrA", "chrB", "chrC"]
    rows = [(1, 0, 200, 500), (1, 1, 100, 400), (-1, 2, 500, 800),
            (2, 0, 600, 640), (-2, 1, 700, 760), (3, 2, 0, 300),
            (3, 1, 500, 820)]
    out = {}
    for pkg, block_cls, mod in (("jax", JaxBlock, jax_msa), ("port", Block, msa)):
        d = tmp_path / pkg
        d.mkdir()
        blocks = [block_cls(*r) for r in rows]
        overflow = mod.align_blocks_to_maf(
            blocks, seqs, names, str(d / "alignment.maf"), cmd="x",
            chunks=2, budget_bytes=15_000,
        )
        out[pkg] = (overflow, d)
    assert out["port"][0] == out["jax"][0] == [1, 3]
    for name in ("alignment.maf", os.path.join("blocks", "1.fa"),
                 os.path.join("blocks", "3.fa")):
        assert ((out["port"][1] / name).read_bytes()
                == (out["jax"][1] / name).read_bytes()), name


def test_examples_maf_matches_golden(tmp_path):
    out = tmp_path / "out"
    assert run(["-k", "15", "--device", "cpu", "-o", str(out),
                *EXAMPLE_FASTAS]) == 0
    golden = os.path.join(EXAMPLES, "sibeliaz_out", "alignment.maf")
    assert maf_body(out / "alignment.maf") == maf_body(
        type(out)(golden)
    )


@pytest.mark.parametrize(
    "flags", [["--align-engine", "tpu"], ["--poa-ties", "last"]],
    ids=["device_engine", "ties_last"],
)
def test_cli_maf_matches_jax_cli(tmp_path, flags):
    seqs, names = random_related_genomes(53, length=1200, mut=0.02)
    fa = tmp_path / "genomes.fa"
    fasta.write_fasta(
        str(fa), [fasta.FastaRecord(n, s) for n, s in zip(names, seqs)]
    )
    out_j, out_p = tmp_path / "jax", tmp_path / "port"
    assert jax_run(["-k", "15", *flags, "-o", str(out_j), str(fa)]) == 0
    before = metrics.counters.get("poa_blocks_dispatched", 0)
    assert run(["-k", "15", *flags, "--device", "cpu", "-o", str(out_p),
                str(fa)]) == 0
    dispatched = metrics.counters.get("poa_blocks_dispatched", 0) - before
    assert (dispatched > 0) == (flags[0] == "--align-engine")
    body = maf_body(out_p / "alignment.maf")
    assert body == maf_body(out_j / "alignment.maf")
    assert "\na\n" in body
