"""The port's device POA engine against the JAX package on the CPU, exactly:
K3's plain version against `_dp_tb_batch` on the same arrays, the engine's
MSAs against the JAX engine and the spec, and the three faults of
tpu_poa.py that the port does not copy."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sibeliaz_tpu.align import poa_ref as jax_poa_ref
from sibeliaz_tpu.align import tpu_poa
from sibeliaz_tpu_torch.align import device_poa, kernels, poa_ref
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from torch_cases import (ACGT, POA_KINDS, edge_band_round, poa_case, poa_round,
                         rand_block, spread_slots, tie_heavy_block)


def port_plan(band_min):
    return functools.partial(device_poa._plan_windows, band_min=band_min)


def run_jax(arrays, n_max, W, P):
    dev = [jnp.asarray(a) for a in arrays]
    return [np.asarray(x) for x in
            tpu_poa._dp_tb_batch(*dev[:6], n_max, W, P, dev[6])]


def run_plain(arrays, n_max, W, P):
    t = [torch.from_numpy(a) for a in arrays]
    return [x.numpy() for x in
            kernels.poa_dp_tb_plain(*t[:6], n_max, W, P, t[6])]


def assert_outputs_equal(got, want):
    for name, g, w in zip(("out_r", "out_i", "tcount", "best_sc"), got, want):
        assert g.dtype == np.int32 and g.shape == w.shape, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("case", POA_KINDS)
def test_plain_matches_jax_dp_tb(case, monkeypatch):
    blocks, band_min = poa_case(case)
    monkeypatch.setenv("SZ_POA_BAND_MIN", str(band_min))
    args = poa_round(blocks, jax_poa_ref.PoaGraph, tpu_poa._extract_arrays,
                     tpu_poa._plan_windows)
    arrays, n_max, W, P, s0s = args
    want = run_jax(arrays, n_max, W, P)
    assert_outputs_equal(run_plain(arrays, n_max, W, P), want)
    if case in ("unbanded", "odd_w"):
        assert s0s == [None] * len(blocks)
    else:
        assert all(s is not None for s in s0s)
    pred_idx, pred_ok = arrays[3], arrays[4]
    if case == "far_pred":  # further back than any shared-memory ring holds
        back = np.arange(n_max)[None, :, None] - pred_idx
        assert int(np.where(pred_ok & (pred_idx < n_max), back, 0).max()) > 300
    if case == "many_preds":
        assert int(pred_ok.sum(axis=2).max()) >= 5
    if case == "odd_w":
        assert len(blocks) == 1 and W % 2 == 1 and W == arrays[0].shape[1] - W
        assert int(np.flatnonzero(pred_ok[0].any(axis=1)).max()) + 1 < n_max // 4
    if case == "pass2":
        # pass 1 does not certify; pass 2 re-bands at the achieved score
        assert int(want[3][0]) < s0s[0]
        arrays, n_max, W, P, _ = poa_round(
            blocks, jax_poa_ref.PoaGraph, tpu_poa._extract_arrays,
            tpu_poa._plan_windows, band_S=[int(want[3][0])],
        )
        assert_outputs_equal(run_plain(arrays, n_max, W, P),
                             run_jax(arrays, n_max, W, P))


@pytest.mark.parametrize("case", ["tie_heavy", "many_preds"])
def test_plain_matches_jax_with_holes_in_the_slot_mask(case, monkeypatch):
    """Unused slots between used ones count as NEG at their place in slot
    order, in the plain version as in `_dp_tb_batch`."""
    blocks, band_min = poa_case(case)
    monkeypatch.setenv("SZ_POA_BAND_MIN", str(band_min))
    arrays, n_max, W, P, _ = poa_round(
        blocks, jax_poa_ref.PoaGraph, tpu_poa._extract_arrays, tpu_poa._plan_windows)
    arrays = list(arrays)
    arrays[3], arrays[4] = spread_slots(arrays[3], arrays[4], n_max)
    assert arrays[4][..., 1].any() and not arrays[4][..., 0].any()
    assert_outputs_equal(run_plain(arrays, n_max, W, P), run_jax(arrays, n_max, W, P))


@pytest.mark.parametrize("W", [13, 261, 263])
def test_plain_matches_jax_on_a_band_that_rides_the_window_edge(W):
    """A window that moves on by one row per rank at a width that is no
    multiple of the kernel's columns per thread, with the alignment in the
    window's last column."""
    arrays, n_max, W, P = edge_band_round(W)
    want = run_jax(arrays, n_max, W, P)
    assert_outputs_equal(run_plain(arrays, n_max, W, P), want)
    n = int(arrays[1][0])
    assert np.all(want[2] == n)  # one step per rank: the diagonal, no gap
    assert np.all(want[3] > 3 * n)  # and most of it matches
    ranks, rows = want[0][0, :n], want[1][0, :n] + 1
    cols = rows - arrays[6][0, ranks]
    assert np.all(cols[ranks >= W] == W - 1)  # block 0: in the last column


@pytest.mark.parametrize("W", [1, 65, 128, 512, 513, 1025, 2048, 4096, 4097,
                               8192, 8193, 65537])
def test_launch_config_is_a_shape_the_kernel_takes(W):
    """What the K3 wrapper asks csrc/poa_dp_tb.cu for: 1, 2, 4 or 8 columns
    per thread, whole warps, a ring that fits a block's shared memory and
    only an unchunked window, every column covered."""
    cfg = kernels.launch_config(W)
    cols, threads, depth = cfg["cols"], cfg["threads"], cfg["depth"]
    assert cols in (1, 2, 4, 8)
    assert threads % 32 == 0 and 32 <= threads <= kernels.MAX_THREADS
    chunks = -(-W // (cols * threads))
    assert chunks == 1 or depth == 0
    assert (cols * threads < W + 32 * cols) or chunks > 1 or threads == 32
    staged = 2 * kernels.REC_TILE * kernels.REC_WORDS + 32
    assert 4 * (staged + depth * cols * threads) <= 227 * 1024
    if W <= 8192:  # the engine's usual widths run with the ring
        assert chunks == 1 and depth >= 1
    forced = kernels.launch_config(W, cols=1)
    assert forced["cols"] == 1
    assert (forced["depth"] == 0) == (W > forced["threads"])


def test_plain_matches_on_port_arrays(monkeypatch):
    """The port's _extract_arrays/_plan_windows give the JAX package's
    arrays."""
    blocks, band_min = poa_case("banded")
    monkeypatch.setenv("SZ_POA_BAND_MIN", str(band_min))
    port = poa_round(blocks, poa_ref.PoaGraph, device_poa._extract_arrays,
                     port_plan(band_min))
    ref = poa_round(blocks, jax_poa_ref.PoaGraph, tpu_poa._extract_arrays,
                    tpu_poa._plan_windows)
    for a, b in zip(port[0], ref[0]):
        assert np.array_equal(a, b)
    assert port[1:] == ref[1:]


def engines_agree(blocks, monkeypatch, band_min=256):
    monkeypatch.setenv("SZ_POA_BAND_MIN", str(band_min))
    expect = [poa_ref.poa_msa(b) for b in blocks]
    got = device_poa.poa_msa_batch_tpu(blocks, device="cpu",
                                       band_min=band_min)
    assert got == expect
    assert tpu_poa.poa_msa_batch_tpu(blocks) == expect
    return got


@pytest.mark.parametrize("seed", range(6))
def test_matches_spec(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    blocks = [
        rand_block(rng, int(rng.integers(20, 80)), int(rng.integers(2, 5)))
        for _ in range(3)
    ]
    engines_agree(blocks, monkeypatch)


def test_mixed_copy_counts(monkeypatch):
    rng = np.random.default_rng(100)
    blocks = [rand_block(rng, 40, 2), rand_block(rng, 50, 5),
              rand_block(rng, 30, 3)]
    engines_agree(blocks, monkeypatch)


def test_oversized_single_block_falls_back():
    """A block whose one-block scratch exceeds the budget returns None (the
    caller aligns it natively) instead of a dispatch that cannot fit.
    Unrelated 3 kbp copies take 18 MB of H + dirs at the routing estimate, so
    an 8 MB budget never dispatches; a 32 MB one runs the banded pass 1,
    whose score does not certify, and the re-band at the achieved score
    falls back at the dispatch-time re-check."""
    rng = np.random.default_rng(5)
    rows = [ACGT[rng.integers(0, 4, size=3000)] for _ in range(2)]
    before = dict(metrics.counters)
    assert device_poa.poa_msa_batch_tpu(
        [rows], budget_bytes=8 << 20, device="cpu") == [None]
    assert metrics.counters.get("poa_dispatches", 0) == before.get("poa_dispatches", 0)
    assert device_poa.poa_msa_batch_tpu(
        [rows], budget_bytes=32 << 20, device="cpu") == [None]
    assert metrics.counters["poa_band_pass2"] == before.get("poa_band_pass2", 0) + 1
    assert metrics.counters["poa_dispatches"] == before.get("poa_dispatches", 0) + 1


def test_budget_splits_rounds_into_dispatches():
    """A budget that holds one block at full width makes each round several
    dispatches, each filled until the next block would not fit; the MSAs
    stay the spec's and no block falls back."""
    rng = np.random.default_rng(12)
    blocks = [rand_block(rng, int(rng.integers(280, 320)), 3, mut=0.04)
              for _ in range(5)]
    L = device_poa._bucket_L(max(len(s) for b in blocks for s in b))
    budget = device_poa._per_block_bytes(L + 1, device_poa._n_max_for(L)) + 1
    before = metrics.counters.get("poa_dispatches", 0)
    got = device_poa.poa_msa_batch_tpu(blocks, budget_bytes=budget, device="cpu")
    assert got == [poa_ref.poa_msa(b) for b in blocks]
    # without the cap the two rounds would be two dispatches
    assert metrics.counters["poa_dispatches"] - before > 2


def test_banded_pass2_certification(monkeypatch):
    blocks, band_min = poa_case("pass2")
    before = metrics.counters.get("poa_band_pass2", 0)
    engines_agree(blocks, monkeypatch, band_min)
    assert metrics.counters.get("poa_band_pass2", 0) > before


def test_banded_tie_heavy_low_complexity(monkeypatch):
    blocks = [tie_heavy_block(np.random.default_rng(9))]
    before = metrics.counters.get("poa_blocks_dispatched", 0)
    engines_agree(blocks, monkeypatch, band_min=16)
    assert metrics.counters.get("poa_blocks_dispatched", 0) > before


def test_depth_ranges_brute_force():
    """_depth_ranges equals the definitional per-node recurrences and the
    JAX package's."""
    rng = np.random.default_rng(0)
    g = poa_ref.PoaGraph()
    base = ACGT[rng.integers(0, 4, size=150)]
    g.add_first(base)
    for _ in range(3):
        q = base.copy()
        for p in np.flatnonzero(rng.random(len(q)) < 0.06):
            q[p] = ACGT[rng.integers(0, 4)]
        cut = int(rng.integers(5, len(q) - 10))
        q = np.delete(q, slice(cut, cut + 3))
        g.add_sequence(q)
    n_max = 512
    topo, nc, pi, po, sink = device_poa._extract_arrays(g, n_max)
    N = len(topo)
    got = device_poa._depth_ranges(pi, po, sink, N, n_max)
    BIG = 1 << 50
    bm = np.empty(N, np.int64)
    bM = np.empty(N, np.int64)
    for r in range(N):
        if po[r, 0] and pi[r, 0] == n_max:
            bm[r] = bM[r] = 1
        else:
            ps = pi[r][po[r]]
            bm[r] = bm[ps].min() + 1
            bM[r] = bM[ps].max() + 1
    sm = np.where(sink[:N], 0, BIG).astype(np.int64)
    sM = np.where(sink[:N], 0, -BIG).astype(np.int64)
    for r in range(N - 1, -1, -1):
        if not (po[r, 0] and pi[r, 0] == n_max):
            for p in pi[r][po[r]]:
                sm[p] = min(sm[p], sm[r] + 1)
                sM[p] = max(sM[p], sM[r] + 1)
    for a, b in zip(got, (bm, bM, sm, sM)):
        assert np.array_equal(a, b)
    for a, b in zip(got, tpu_poa._depth_ranges(pi, po, sink, N, n_max)):
        assert np.array_equal(a, b)


# ---- the faults of tpu_poa.py the port does not copy -----------------------


def test_empty_graph_falls_back():
    """An empty first copy leaves an empty graph: the port falls the block
    back; tpu_poa._extract_arrays raises on it."""
    assert device_poa._extract_arrays(poa_ref.PoaGraph(), 64) is None
    with pytest.raises(ValueError):
        tpu_poa._extract_arrays(jax_poa_ref.PoaGraph(), 64)
    block = [np.zeros(0, np.uint8), ACGT[[0, 1, 2, 3, 0, 1]]]
    assert device_poa.poa_msa_batch_tpu([block], device="cpu") == [None]


def test_out_of_range_traceback_rank_falls_back(monkeypatch):
    """A traceback that names a rank outside the graph marks the block for
    the native fallback; tpu_poa.py clips the rank into range instead."""
    real = kernels.poa_dp_tb

    def corrupt(*args):
        out_r, out_i, tcount, best_sc = real(*args)
        out_r[:, 0] = args[6] - 1  # n_max - 1: padding, past the graph
        return out_r, out_i, tcount, best_sc

    monkeypatch.setattr(kernels, "poa_dp_tb", corrupt)
    rng = np.random.default_rng(3)
    blocks = [rand_block(rng, 40, 3), rand_block(rng, 50, 2)]
    assert device_poa.poa_msa_batch_tpu(blocks, device="cpu") == [None, None]


def test_singleton_small_bucket_eligible_by_memory():
    """Eligibility is the memory test alone: a lone 3 kbp block is eligible
    on any budget that holds its scratch.  tpu_poa.py's latency test counts
    members per pre-merge bucket and sends it to native."""
    rng = np.random.default_rng(8)
    blocks = [rand_block(rng, 3000, 2, mut=0.02)]
    assert device_poa.device_budget_eligible(blocks, 1 << 30) == [True]
    assert tpu_poa.device_budget_eligible(blocks) == [False]
    # the memory test still routes what does not fit
    assert device_poa.device_budget_eligible(blocks, 1 << 20) == [False]
