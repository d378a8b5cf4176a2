"""The port's LCB oracle engine and bundle enumeration against the JAX
package's, on the CPU.

Every comparison is exact: bundle lists field by field (vid, ch, count,
rank, resolve) and in order, block lists equal, GFFs byte-equal."""

import os

import numpy as np
import pytest
import torch

from sibeliaz_tpu import pipeline as jax_pipeline
from sibeliaz_tpu.config import Config as JaxConfig
from sibeliaz_tpu.lcb.device_bundles import make_bundles_device as jax_make_bundles_device
from sibeliaz_tpu.lcb.oracle import LcbEngine as JaxLcbEngine
from sibeliaz_tpu_torch import pipeline
from sibeliaz_tpu_torch.cli import run
from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.io import fasta
from sibeliaz_tpu_torch.io.dbg import JunctionChr
from sibeliaz_tpu_torch.junctions.table import JunctionTable
from sibeliaz_tpu_torch.lcb import device_bundles
from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
from sibeliaz_tpu_torch.lcb.oracle import LcbEngine

from reference_oracle import random_related_genomes
from torch_cases import BUNDLE_CASES, bundle_fields, related_genomes, tied_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
GOLDEN = os.path.join(EXAMPLES, "sibeliaz_out", "blocks_coords.gff")
EXAMPLE_FASTAS = [os.path.join(EXAMPLES, f"genome{g}.fa") for g in (1, 2)]


def engine(table, cls=LcbEngine, cfg=Config(k=15)):
    return cls(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking)


@pytest.mark.parametrize("seed,kwargs", BUNDLE_CASES)
def test_related_genomes_is_the_reference_oracles(seed, kwargs):
    """torch_cases.related_genomes (used where JAX is absent) draws the
    same genomes as reference_oracle.random_related_genomes."""
    seqs, names = related_genomes(seed, **kwargs)
    want_seqs, want_names = random_related_genomes(seed, **kwargs)
    assert names == want_names
    assert all(np.array_equal(a, b) for a, b in zip(seqs, want_seqs))


@pytest.mark.parametrize("seed,kwargs", BUNDLE_CASES)
def test_bundles_match_jax_and_oracle(seed, kwargs):
    """tests/test_device_bundles.py's four cases: the port's bundle list
    equals the JAX package's make_bundles_device and the port's oracle."""
    seqs, names = random_related_genomes(seed, **kwargs)
    table = pipeline.build_table(seqs, names, Config(k=15), device="cpu")
    jax_table = jax_pipeline.build_table(seqs, names, JaxConfig(k=15))
    got = bundle_fields(make_bundles_device(table, "cpu"))
    assert got, "no bundles"
    assert got == bundle_fields(engine(table).make_bundles())
    assert got == bundle_fields(jax_make_bundles_device(jax_table))
    assert got == bundle_fields(engine(jax_table, JaxLcbEngine).make_bundles())


def test_bundles_with_ties_take_the_gxx_branch():
    """A hand-laid table with tied (count, rank, resolve) keys: the gxx_sort
    residue equals the oracle's and the JAX package's, and it is not the
    stable order (so the branch decides the order)."""
    table = tied_table(0)
    want = bundle_fields(engine(table).make_bundles())
    keys = [w[2:] for w in want]
    assert len(set(keys)) < len(keys), "no ties"
    got = bundle_fields(make_bundles_device(table, "cpu"))
    assert got == want
    assert got == bundle_fields(jax_make_bundles_device(table))
    assert got == bundle_fields(engine(table, JaxLcbEngine).make_bundles())
    enumeration = sorted(want, key=lambda w: (w[0], w[1]))  # v ascending, then ch
    stable = sorted(enumeration, key=lambda w: (-w[2], w[3], w[4]))
    assert got != stable


@pytest.mark.parametrize("n_records", [0, 1, 2])
def test_bundles_of_tiny_tables(n_records):
    """The empty table (no upload, no sort), one occurrence (two rows, no
    bundle) and two occurrences of one vertex."""
    seqs, names = related_genomes(7, length=300)
    pos = np.array([20, 140][:n_records], np.uint32)
    ids = np.array([3, 3][:n_records], np.int64)
    empty = JunctionChr(pos=np.zeros(0, np.uint32), ids=np.zeros(0, np.int64))
    table = JunctionTable.build([JunctionChr(pos=pos, ids=ids), empty], seqs, names, 15, 150)
    assert len(table.occ_chr) == n_records
    got = bundle_fields(make_bundles_device(table, "cpu"))
    assert got == bundle_fields(engine(table).make_bundles())
    assert got == bundle_fields(jax_make_bundles_device(table))
    if n_records < 2:
        assert got == []


def test_bundle_rows_sort_is_stable():
    """sort_rows keeps equal keys in their input order, and the payload
    follows the key: a non-stable sort would change `rank`."""
    rng = np.random.default_rng(3)
    n = 5000
    rows = np.stack([rng.integers(0, 8, n), np.arange(n), rng.integers(0, 3, n),
                     rng.integers(0, 2, n)]).astype(np.int64)
    got = device_bundles.sort_rows(torch.from_numpy(rows)).numpy()
    order = np.argsort(rows[0], kind="stable")
    assert np.array_equal(got, rows[:, order])


def test_bundles_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    seed, kwargs = BUNDLE_CASES[0]
    seqs, names = random_related_genomes(seed, **kwargs)
    table = pipeline.build_table(seqs, names, Config(k=15), device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        make_bundles_device(table)


def test_run_takes_the_device_bundle_list():
    """LcbEngine.run(bundles=make_bundles_device(...)) gives the blocks of
    run() and of the JAX package's oracle."""
    seed, kwargs = BUNDLE_CASES[1]
    seqs, names = random_related_genomes(seed, **kwargs)
    table = pipeline.build_table(seqs, names, Config(k=15), device="cpu")
    want = engine(table).run()
    table = pipeline.build_table(seqs, names, Config(k=15), device="cpu")
    got = engine(table).run(bundles=make_bundles_device(table, "cpu"))
    jax_table = jax_pipeline.build_table(seqs, names, JaxConfig(k=15))
    jax_blocks = engine(jax_table, JaxLcbEngine).run()
    assert want, "no blocks"
    assert got == want
    assert [tuple(vars(b).values()) for b in got] == [tuple(vars(b).values()) for b in jax_blocks]


@pytest.mark.parametrize(
    "seed,kwargs,k",
    [
        (60, dict(length=3000, mut=0.01), 15),
        (61, dict(length=2500, mut=0.02, rearrange=True, n_prob=0.002), 15),
        (62, dict(n_genomes=3, n_chr=2, length=1500, mut=0.015, rearrange=True), 15),
        # tests/test_cli.py::test_cli_wide_k_cross_engine's input, two-limb k
        (52, dict(length=2500, mut=0.02), 33),
    ],
)
def test_oracle_gff_matches_jax_and_native(seed, kwargs, k):
    seqs, names = random_related_genomes(seed, **kwargs)
    got = pipeline.find_blocks(seqs, names, Config(k=k), engine="oracle", device="cpu")
    want = jax_pipeline.find_blocks(seqs, names, JaxConfig(k=k), engine="oracle")
    native = pipeline.find_blocks(seqs, names, Config(k=k), device="cpu")
    assert "SO:0000856" in got.gff
    assert got.gff == want.gff
    assert got.gff == native.gff


def test_cli_oracle_matches_golden(tmp_path):
    out = tmp_path / "out"
    assert run(["-k", "15", "-n", "--lcb-engine", "oracle", "--device", "cpu",
                "-o", str(out), *EXAMPLE_FASTAS]) == 0
    assert (out / "blocks_coords.gff").read_bytes() == open(GOLDEN, "rb").read()


def test_cli_oracle_on_a_fasta_written_by_the_port(tmp_path):
    """The twin of tests/test_cli.py::test_cli_wide_k_cross_engine: at
    k=33 (two-limb keys) the native and oracle engines' CLI runs write the
    same GFF."""
    seqs, names = random_related_genomes(52, length=2500, mut=0.02)
    fa = tmp_path / "genomes.fa"
    fasta.write_fasta(str(fa), [fasta.FastaRecord(n, s) for n, s in zip(names, seqs)])
    gffs = []
    for eng in ("native", "oracle"):
        out = tmp_path / eng
        assert run(["-k", "33", "-n", "--lcb-engine", eng, "--device", "cpu", "-o", str(out),
                    str(fa)]) == 0
        gffs.append((out / "blocks_coords.gff").read_bytes())
    assert gffs[0] == gffs[1]
