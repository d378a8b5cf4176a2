"""The port's graph stage (build_junctions on the CPU path) against the JAX
package's build_junctions and the brute-force oracle, on the cases of
tests/test_graph.py::TestConstructParity and ::TestWideK (two-limb keys,
33 <= k <= 61); and its routing to the streamed stage under a memory
budget."""

import numpy as np
import pytest

import test_graph

from sibeliaz_tpu.graph import construct as jax_construct
from sibeliaz_tpu.graph import oracle as jax_oracle
from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.graph import construct, oracle
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from test_graph import mutate, random_genomes


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.pos.dtype == y.pos.dtype and x.ids.dtype == y.ids.dtype
        assert np.array_equal(x.pos, y.pos)
        assert np.array_equal(x.ids, y.ids)


def check_all(seqs, k):
    got = construct.build_junctions(seqs, k, "cpu")
    assert_same(jax_construct.build_junctions(seqs, k), got)
    assert_same(oracle.enumerate_junctions(seqs, k), got)
    assert_same(jax_oracle.enumerate_junctions(seqs, k), got)


@pytest.mark.parametrize("seed,k,n_prob", [(0, 5, 0.0), (1, 7, 0.02),
                                           (2, 9, 0.0), (3, 15, 0.01),
                                           (4, 25, 0.0), (5, 3, 0.05),
                                           (6, 31, 0.01)])
def test_random_parity(seed, k, n_prob):
    rng = np.random.default_rng(seed)
    check_all(random_genomes(rng, 3, 50, 400, n_prob), k)


def test_related_genomes_parity():
    rng = np.random.default_rng(7)
    base = random_genomes(rng, 2, 500, 800)[0]
    g2 = mutate(rng, base, 0.01)
    g3 = alphabet.reverse_complement(mutate(rng, base, 0.005))
    check_all([base, g2, g3], 11)


def test_repeat_heavy_parity():
    rng = np.random.default_rng(11)
    unit = alphabet.decode(rng.integers(0, 4, size=40).astype(np.uint8))
    seq = np.concatenate([unit] * 6 + [alphabet.reverse_complement(unit)] * 2)
    check_all([seq], 9)


def test_short_input():
    recs = construct.build_junctions([alphabet.str_to_seq("ACG")], 5, "cpu")
    assert len(recs) == 1 and len(recs[0].pos) == 0
    assert construct.build_junctions([], 5, "cpu") == []


@pytest.mark.parametrize("k", [33, 45, 61])
def test_wide_k_parity(k):
    check_all(test_graph.TestWideK._pair(None), k)


def test_limb_boundary_parity():
    """k=31 (the last one-limb k) and k=33 (the first two-limb k) on the
    same input."""
    seqs = test_graph.TestWideK._pair(None, seed=9, n=6000)
    for k in (31, 33):
        check_all(seqs, k)


def test_wide_k_is_refused():
    seq = alphabet.str_to_seq("ACGT" * 30)
    with pytest.raises(NotImplementedError, match="k <= 61"):
        construct.build_junctions([seq], 63, "cpu")


def route(seqs, k, budget):
    """build_junctions at `budget` bytes: (records, whether the streamed
    stage ran)."""
    metrics.timings.clear()
    recs = construct.build_junctions(seqs, k, "cpu", memory_budget_bytes=budget)
    return recs, "graph_scan" in {t["stage"] for t in metrics.timings}


def test_memory_guard_refuses():
    """One byte under the monolithic stage's peak, the streamed stage runs
    (the guard no longer refuses), with the monolithic stage's records."""
    seqs = test_graph.TestWideK._pair(None)
    need = (sum(len(s) for s in seqs) + len(seqs) - 1) * construct.PEAK_BYTES_PER_POS
    want, streamed_ran = route(seqs, 15, need)
    assert not streamed_ran and sum(len(r.pos) for r in want) > 0
    got, streamed_ran = route(seqs, 15, need - 1)
    assert streamed_ran
    assert_same(want, got)


def test_memory_guard_refuses_wide_k():
    """Two-limb keys take their own per-position peak, and route the same
    way."""
    assert construct.PEAK_BYTES_PER_POS_WIDE > construct.PEAK_BYTES_PER_POS
    seqs = test_graph.TestWideK._pair(None)
    need = (sum(len(s) for s in seqs) + len(seqs) - 1) * construct.PEAK_BYTES_PER_POS_WIDE
    want, streamed_ran = route(seqs, 33, need)
    assert not streamed_ran and sum(len(r.pos) for r in want) > 0
    got, streamed_ran = route(seqs, 33, need - 1)
    assert streamed_ran
    assert_same(want, got)
