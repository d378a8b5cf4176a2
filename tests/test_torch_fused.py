"""The fused LCB engine (lcb/fused.py, `--lcb-engine tpu-fused`) against the
JAX package's and the host oracle, on the CPU: a phase's instance lists
equal to the JAX package's `process_phase_fused` and to `eng.process`,
bundle by bundle, through tier escalation, hard-capacity lanes and lane
compaction; GFFs byte-equal to the JAX package's `run_fused` and to the
native engine, and through the CLI.  (The phase step's carry is held to
the JAX package's in test_torch_fused_parts.py.)"""

import functools
import os

import pytest
import torch

from sibeliaz_tpu.lcb import fused as jax_fused
from sibeliaz_tpu.output import gff as jax_gff
from sibeliaz_tpu.output import trim as jax_trim
from sibeliaz_tpu_torch import pipeline
from sibeliaz_tpu_torch.cli import run
from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.io import fasta
from sibeliaz_tpu_torch.lcb import fused
from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from reference_oracle import random_related_genomes
from test_torch_fused_parts import engines, related
from torch_cases import repeat_genomes

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


@pytest.fixture(autouse=True)
def one_thread():
    """Lane tensors here are small: one intra-op thread a test process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inst_key(insts):
    return [(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]


@functools.lru_cache(maxsize=None)
def phase_case(case):
    """(port engine, bundles, the JAX package's process_phase_fused on
    them at its defaults): the JAX side is computed once a case."""
    if case == "repeat":
        # the related genomes, and a chromosome with 520 copies of a unit
        seqs, names = random_related_genomes(520, length=1200, mut=0.03, rearrange=True)
        rseqs, _ = repeat_genomes(3, 520, n_genomes=1)
        eng, jeng = engines(seqs + rseqs, names + ["Repeat"], abundance=1000)
        t = eng.t
        bundles = make_bundles_device(t, "cpu")
        related_only = [b for b in bundles if (
            t.occ_chr[t.occ_off[abs(b.vid)]:t.occ_off[abs(b.vid) + 1]] < len(seqs)).all()]
        bundles = [b for b in bundles if b.count > fused.I_CAP] + related_only[:15]
    else:
        eng, jeng = related()
        bundles = make_bundles_device(eng.t, "cpu")[:32]
    return eng, bundles, jax_fused.process_phase_fused(jeng, bundles)


@pytest.mark.parametrize("kind", ["plain", "escalate", "hard_capacity", "step_bound",
                                  "compaction", "walk_chunk"])
def test_process_phase_matches_jax_and_oracle(monkeypatch, kind):
    """process_phase_fused per bundle, equal to the JAX package's and to
    eng.process: escalation (a 3-instance narrow tier that overflows, and
    a tiny vote budget: 8 lanes a call), hard-capacity lanes to the oracle
    (a repeat whose 520-occurrence bundle passes I_CAP, beside bundles of
    related genomes; MAX_STEPS 4), compaction (COMPACT_MIN 8), and
    walks spanning outer steps (WALK_CHUNK 2).  The JAX package's results
    do not depend on these settings (its lanes are exact at every tier, and
    its own tests hold it so), so it runs at its defaults."""
    patch = {"escalate": {"SMALL_CAP": 3, "VOTE_BUDGET": 1 << 14},
             "step_bound": {"MAX_STEPS": 4}, "walk_chunk": {"WALK_CHUNK": 2},
             "compaction": {"COMPACT_MIN": 8}}.get(kind, {})
    for name, value in patch.items():
        monkeypatch.setattr(fused, name, value)
    eng, bundles, want = phase_case("repeat" if kind == "hard_capacity" else "related")
    metrics.counters.clear()
    got = fused.process_phase_fused(eng, bundles, device="cpu")
    for b, bundle in enumerate(bundles):
        assert inst_key(got[b]) == inst_key(want[b]) == inst_key(eng.process(bundle)), b
    counters = metrics.counters
    assert counters["fused_phases"] == 1 and counters["fused_host_syncs"] > 0
    if kind == "escalate":
        assert counters["fused_lanes_tier1"] > 0 and counters["fused_steps_tier1"] > 0
    if kind == "hard_capacity":
        assert counters["fused_oracle_lanes"] == sum(b.count > fused.I_CAP for b in bundles) > 0
    elif kind == "step_bound":
        assert counters["fused_oracle_lanes"] > 0
    else:
        assert counters["fused_oracle_lanes"] == 0
    if kind == "compaction":
        assert counters.get("fused_compactions", 0) > 0
    assert any(got), "no bundle found instances"


def gff_of(seqs, names, k, raw):
    lengths = [len(s) for s in seqs]
    blocks, _ = jax_trim.trim_blocks(raw, lengths, Config(k=k).min_block_size)
    return jax_gff.render_gff(blocks, names, lengths)


@pytest.mark.parametrize("k", [15, 33])
def test_run_fused_gff_matches_jax_and_native(k):
    """run_fused's GFF byte-equal to the JAX package's run_fused and to the
    native engine (tests/test_fused_lcb.py's genomes)."""
    seqs, names = random_related_genomes(521, length=1200, mut=0.03, rearrange=True)
    eng, jeng = engines(seqs, names, k=k)
    got = gff_of(seqs, names, k, fused.run_fused(eng, device="cpu"))
    assert got == gff_of(seqs, names, k, jax_fused.run_fused(jeng))
    native = pipeline.find_blocks(seqs, names, Config(k=k), device="cpu")
    assert got == native.gff and native.blocks_found > 0


@pytest.mark.parametrize("seed,kwargs", [
    (520, dict(length=1200, mut=0.03, rearrange=True)),
    (522, dict(length=1200, mut=0.03, rearrange=True)),
    (523, dict(length=1000, mut=0.03)),
    (524, dict(length=1000, mut=0.03)),
    (62, dict(n_genomes=3, n_chr=2, length=1500, mut=0.015, rearrange=True)),
    (61, dict(length=2500, mut=0.02, rearrange=True, n_prob=0.002)),
])
@pytest.mark.parametrize("k", [15, 33])
def test_tpu_fused_gff_matches_native(seed, kwargs, k):
    """pipeline.find_blocks with engine="tpu-fused" on the CPU: the native
    engine's GFF on tests/test_fused_lcb.py's other genomes, on three
    genomes of two chromosomes each, and on genomes with N runs."""
    seqs, names = random_related_genomes(seed, **kwargs)
    got = pipeline.find_blocks(seqs, names, Config(k=k), engine="tpu-fused", device="cpu")
    want = pipeline.find_blocks(seqs, names, Config(k=k), device="cpu")
    assert got.gff == want.gff and got.blocks_found == want.blocks_found > 0


def test_vote_budget_from_bytes_matches_jax():
    for gb in (0, 1, 8, 80, 1000):
        assert fused.vote_budget_from_bytes(gb << 30) == jax_fused.vote_budget_from_bytes(gb << 30)


def test_tpu_fused_refuses_cuda_without_card(tmp_path):
    """No card: the CLI's default --device cuda and run_fused's default
    device raise, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(SystemExit, match="no CUDA device"):
        run(["-k", "15", "-n", "--lcb-engine", "tpu-fused", "-o", str(tmp_path),
             os.path.join(EXAMPLES, "genome1.fa")])
    eng, _ = related()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused.run_fused(eng)
    assert not eng.blocks


def test_cli_tpu_fused_matches_native(tmp_path):
    """`-n --lcb-engine tpu-fused --device cpu` writes the native engine's
    GFF, byte for byte, and counts its phases."""
    seqs, names = random_related_genomes(64, length=2000, mut=0.02, rearrange=True)
    fa = tmp_path / "genomes.fa"
    fasta.write_fasta(str(fa), [fasta.FastaRecord(n, s) for n, s in zip(names, seqs)])
    common = ["-k", "15", "-n", "--device", "cpu"]
    assert run(common + ["--lcb-engine", "native", "-o", str(tmp_path / "native"), str(fa)]) == 0
    metrics.counters.clear()
    assert run(common + ["--lcb-engine", "tpu-fused", "-f", "1", "-o", str(tmp_path / "fused"),
                         str(fa)]) == 0
    want = (tmp_path / "native" / "blocks_coords.gff").read_bytes()
    assert (tmp_path / "fused" / "blocks_coords.gff").read_bytes() == want
    assert want.count(b"\n") > 5
    assert metrics.counters["fused_phases"] >= 1
