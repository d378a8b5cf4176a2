"""The port's sharded graph stage (sibeliaz_tpu_torch/parallel/sharded.py)
over CPU shards against the JAX package's build_junctions_sharded on the
virtual CPU devices of tests/conftest.py and against the port's monolithic
stage: records exactly equal (pos, ids; tolerance 0).  Also the device
POA engine's batch spread over CPU devices against its one-device run and
poa_ref."""

import jax
import numpy as np
import pytest

from sibeliaz_tpu.parallel import sharded as jax_sharded
from sibeliaz_tpu_torch.align import device_poa, poa_ref
from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.dryrun import dryrun_inputs
from sibeliaz_tpu_torch.graph import construct
from sibeliaz_tpu_torch.parallel import sharded
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from torch_cases import SHARD_EDGE_KINDS, shard_edge_case


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.pos, y.pos)
        assert np.array_equal(x.ids, y.ids)


def random_genomes(seed, n_chr, lo, hi, n_prob=0.0):
    """tests/test_sharded.py's generator (the same draws)."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_chr):
        L = int(rng.integers(lo, hi))
        seq = alphabet.decode(rng.integers(0, 4, size=L).astype(np.uint8))
        if n_prob:
            seq[rng.random(L) < n_prob] = ord("N")
        seqs.append(seq)
    return seqs


def related(seed, length, rc=True):
    """test_sharded.py's related genomes: a base, a 1% mutant and (rc) the
    base's reverse complement."""
    rng = np.random.default_rng(seed)
    base = alphabet.decode(rng.integers(0, 4, size=length).astype(np.uint8))
    g2 = base.copy()
    for p in np.flatnonzero(rng.random(len(g2)) < 0.01):
        g2[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
    return [base, g2, alphabet.reverse_complement(base)] if rc else [base, g2]


# test_sharded.py's cases, then one shard and three (uneven) shards
CASES = {
    "seed0_k7": (lambda: random_genomes(0, 3, 200, 2000), 7, 8),
    "seed1_k15_with_n": (lambda: random_genomes(1, 3, 200, 2000, 0.01), 15, 8),
    "seed2_k11": (lambda: random_genomes(2, 3, 200, 2000), 11, 8),
    "related_k15": (lambda: related(5, 3000), 15, 8),
    "two_devices_k9": (lambda: random_genomes(9, 2, 300, 700), 9, 2),
    "two_limbs_k33": (lambda: related(31, 2500), 33, 8),
    "two_limbs_k61": (lambda: related(31, 2500), 61, 8),
    "one_shard_k15": (lambda: random_genomes(1, 3, 200, 2000, 0.01), 15, 1),
    "three_shards_k15": (lambda: random_genomes(1, 3, 200, 2000, 0.01), 15, 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_jax_and_monolithic(case):
    make, k, n = CASES[case]
    seqs = make()
    mono = construct.build_junctions(seqs, k, "cpu")
    assert sum(len(r.pos) for r in mono) > 0
    got = sharded.build_junctions_sharded(seqs, k, devices=["cpu"] * n)
    assert_same(got, mono)
    devices = jax.devices()
    assert len(devices) >= n, "conftest should provide 8 virtual CPU devices"
    assert_same(got, jax_sharded.build_junctions_sharded(seqs, k, devices=devices[:n]))


def jax_halo_fits(seqs, k, n):
    """Whether the JAX package's sharded step takes this input: its right
    halo is the first k + 1 bytes of the neighbour's shard, whose length
    comes from its power-of-two bucket."""
    total = -(-(1 + sum(len(s) + 1 for s in seqs)) // n) * n
    bucket = -(-(1 << (total - 1).bit_length()) // n) * n
    return bucket // n >= k + 1


@pytest.mark.parametrize("k", [15, 33])
@pytest.mark.parametrize("kind", SHARD_EDGE_KINDS)
def test_sharded_at_shard_edges(kind, k):
    """Shard edges on an N, on a separator, and next to a junction; a class
    with rows on every shard; one owner taking most rows; shards shorter
    than k + 1 or empty; whole shards of N: equal to the monolithic stage,
    and to the JAX package's at k=15 where its halo takes the input."""
    seqs, n, junction = shard_edge_case(kind)
    mono = construct.build_junctions(seqs, k, "cpu")
    if junction is not None:
        assert junction in set(mono[0].pos.tolist())
    assert_same(sharded.build_junctions_sharded(seqs, k, devices=["cpu"] * n), mono)
    if k == 15 and jax_halo_fits(seqs, k, n):
        assert_same(jax_sharded.build_junctions_sharded(seqs, k, devices=jax.devices()[:n]),
                    mono)


def test_skewed_owner_and_stage_names():
    """The poly-A case sends most rows to one owner; every step is a
    metrics stage."""
    seqs, n, _ = shard_edge_case("poly_a_skew")
    metrics.timings.clear()
    metrics.counters.clear()
    sharded.build_junctions_sharded(seqs, 15, devices=["cpu"] * n)
    stages = {t["stage"] for t in metrics.timings}
    assert stages == {"graph_upload", "graph_front_half", "graph_shard_rows", "graph_exchange",
                      "graph_sort", "graph_class_analysis", "graph_exchange_back",
                      "graph_gather_ids"}
    assert metrics.counters["graph_shards"] == n
    codes = sharded.joined_codes(seqs)
    bounds = sharded.shard_bounds(len(codes), n)
    owners = np.zeros(n, np.int64)
    for s in range(n):
        counts, _fields = sharded.local_rows(codes, bounds[s], bounds[s + 1], 15, n, "cpu",
                                             lambda name: metrics.stage(name))
        owners += counts
    assert owners.max() > 0.5 * owners.sum()


def test_unfitting_shard_raises(monkeypatch):
    """The guard counts every row on the owners of one device (the worst
    case), and raises before any upload."""
    seqs = random_genomes(0, 2, 500, 600)
    n_total = 1 + sum(len(s) + 1 for s in seqs)
    bounds = sharded.shard_bounds(n_total, 4)
    local = [bounds[s + 1] - bounds[s] + 15 + 2 for s in range(4)]
    need = sharded.need_bytes(local, n_total, 15)
    assert need >= n_total * (construct.PEAK_BYTES_PER_POS + sharded.OWNER_EXTRA_BYTES_PER_ROW)
    monkeypatch.setattr(construct, "device_budget", lambda device, budget: need - 1)
    uploads = []
    monkeypatch.setattr(construct, "pack_codes_host", lambda codes: uploads.append(codes))
    with pytest.raises(MemoryError, match=f"need up to {need} bytes"):
        sharded.build_junctions_sharded(seqs, 15, devices=["cpu"] * 4)
    assert not uploads
    monkeypatch.undo()
    monkeypatch.setattr(construct, "device_budget", lambda device, budget: need)
    assert_same(sharded.build_junctions_sharded(seqs, 15, devices=["cpu"] * 4),
                construct.build_junctions(seqs, 15, "cpu"))


def test_owner_past_int32_ranks_raises(monkeypatch):
    seqs = random_genomes(0, 1, 500, 600)
    monkeypatch.setattr(sharded, "MAX_OWNER_ROWS", 100)
    with pytest.raises(ValueError, match="insertion ranks are int32"):
        sharded.build_junctions_sharded(seqs, 15, devices=["cpu"] * 2)


def test_no_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sharded.build_junctions_sharded(random_genomes(0, 1, 50, 60), 15)


@pytest.mark.parametrize("n", [2, 3])
def test_poa_spread_over_devices(n):
    """The dry run's seeded blocks (96-150 bp), each dispatch cut into n
    contiguous slices: the MSAs of the one-device run and of poa_ref."""
    _seqs, blocks = dryrun_inputs(4)
    one = device_poa.poa_msa_batch_tpu(blocks, device="cpu")
    metrics.counters.clear()
    spread = device_poa.poa_msa_batch_tpu(blocks, devices=["cpu"] * n)
    assert metrics.counters["poa_device_slices"] == n * metrics.counters["poa_dispatches"]
    assert spread == one
    assert all(m == poa_ref.poa_msa(rows) for rows, m in zip(blocks, spread))
