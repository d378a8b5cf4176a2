"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`: on a machine without a CUDA card every test skips (decided in
the fixture, not at import).  On the card: `python -m pytest -m gpu
tests/test_torch_cuda.py`."""

import functools

import numpy as np
import pytest
import torch

from sibeliaz_tpu_torch import pipeline
from sibeliaz_tpu_torch.align import device_poa, poa_ref
from sibeliaz_tpu_torch.align import kernels as align_kernels
from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.dryrun import dryrun_inputs
from sibeliaz_tpu_torch.graph import construct, kernels, oracle, streamed
from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
from sibeliaz_tpu_torch.lcb.kernels import LaneSteps
from sibeliaz_tpu_torch.parallel import multihost, sharded
from sibeliaz_tpu_torch.utils import cudabuild
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from torch_cases import (BUNDLE_CASES, CLASS_RUN_KINDS, K1_KINDS, LIMB_SPLITS, ROUND_ROW_KINDS,
                         SEED_CASES, SHARD_EDGE_KINDS, STEP_CASES, VOTE_CASES, bundle_fields,
                         class_case, class_runs, codes_with_n_runs, edge_band_round, k1_case,
                         poa_case, poa_round, rand_block, related_genomes, repeat_genomes,
                         round_rows, seed_case, shard_edge_case, split_limbs, spread_slots,
                         state_apart, state_diff, step_case, tied_table, vote_case, walk_args,
                         walk_genomes, walk_lanes, walk_tensors, with_sentinel_rows)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def upload(codes, device):
    pk_host, nm_host = construct.pack_codes_host(codes)
    return (torch.from_numpy(pk_host).to(device),
            torch.from_numpy(nm_host).to(device))


@pytest.mark.parametrize("k", [3, 15, 25, 31])
@pytest.mark.parametrize("n", [1000, 200_003])
def test_front_half_matches_plain(cuda, k, n):
    codes = codes_with_n_runs(k, n, n // 500, n_at_ends=True)
    codes2, nmask = upload(codes, cuda)
    before = kernels.LAUNCHES["front_half"]
    (key,), packed = kernels.front_half(codes2, nmask, n, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["front_half"] == before + 1
    (want_key,), want_packed = kernels.front_half_plain(codes2, nmask, n, k)
    assert torch.equal(key, want_key)
    assert torch.equal(packed, want_packed)


def assert_front_half_matches_plain(codes2, nmask, n, k):
    """K1 twice in a row on the same inputs, each equal to the plain
    version."""
    want_keys, want_packed = kernels.front_half_plain(codes2, nmask, n, k)
    assert len(want_keys) == (1 if k <= 31 else 2)
    before = kernels.LAUNCHES["front_half"]
    for _ in range(2):
        keys, packed = kernels.front_half(codes2, nmask, n, k)
        torch.cuda.synchronize()
        assert len(keys) == len(want_keys)
        assert all(torch.equal(a, b) for a, b in zip(keys, want_keys))
        assert torch.equal(packed, want_packed)
    assert kernels.LAUNCHES["front_half"] == before + 2


T1 = kernels.K1_TILE_POSITIONS


@pytest.mark.parametrize("k,n", sorted({
    (k, n) for k in (1, 2, 16, 31)
    for n in (1, k - 1, k, k + 1, T1 - 1, T1, T1 + 1, 3 * T1 + 5, (1 << 22) + 3) if n >= 1}))
def test_front_half_at_tile_edges_and_tiny_n(cuda, k, n):
    codes2, nmask = upload(codes_with_n_runs(k + n, n, n // 300, n_at_ends=n > 8), cuda)
    assert_front_half_matches_plain(codes2, nmask, n, k)


@pytest.mark.parametrize("k", [1, 16, 31])
@pytest.mark.parametrize("kind", K1_KINDS)
def test_front_half_on_inputs_the_engine_never_makes(cuda, kind, k):
    n = 5 * T1 + 3
    codes2, nmask = (torch.from_numpy(a).to(cuda) for a in k1_case(kind, n, T1))
    assert_front_half_matches_plain(codes2, nmask, n, k)


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("n", [3 * T1 + 5, (1 << 20) + 7])
def test_front_half_takes_views_off_alignment(cuda, offset, n):
    """Views at a storage offset: the kernel's byte-load instance."""
    codes2, nmask = (torch.from_numpy(a).to(cuda) for a in k1_case("random_bytes", n + 64, T1))
    view2, viewm = codes2[offset:], nmask[offset:]
    assert view2.data_ptr() % 4 and viewm.data_ptr() % 4
    assert_front_half_matches_plain(view2, viewm, n, 25)


# the two-limb instance: n around k, the tile, and the 64-position halo
# (tile 1 is the first edge-free tile from n = 2 T1 + 64 on); k=32 is its
# tightest case: one base in the high limb and a run of 0 past the first 32
@pytest.mark.parametrize("k,n", sorted({
    (k, n) for k in (32, 33, 45, 61)
    for n in (1, k - 1, k, k + 1, T1 - 1, T1, T1 + 1, 2 * T1 + 63, 2 * T1 + 64,
              2 * T1 + 65, 3 * T1 + 5, (1 << 22) + 3)}))
def test_front_half_two_limbs_at_tile_edges_and_tiny_n(cuda, k, n):
    codes2, nmask = upload(codes_with_n_runs(k + n, n, n // 300, n_at_ends=n > 8), cuda)
    assert_front_half_matches_plain(codes2, nmask, n, k)


@pytest.mark.parametrize("k", [32, 33, 45, 61])
@pytest.mark.parametrize("kind", K1_KINDS)
def test_front_half_two_limbs_on_inputs_the_engine_never_makes(cuda, kind, k):
    n = 5 * T1 + 3
    codes2, nmask = (torch.from_numpy(a).to(cuda) for a in k1_case(kind, n, T1))
    assert_front_half_matches_plain(codes2, nmask, n, k)


@pytest.mark.parametrize("offset", [1, 3])
def test_front_half_two_limbs_take_views_off_alignment(cuda, offset):
    n = (1 << 20) + 7
    codes2, nmask = (torch.from_numpy(a).to(cuda) for a in k1_case("random_bytes", n + 64, T1))
    assert_front_half_matches_plain(codes2[offset:], nmask[offset:], n, 45)


def test_front_half_tile_is_the_kernels(cuda):
    """The tests lay their N runs out by the kernel's own tile."""
    assert cudabuild.load().sz_front_half_tile_positions() == T1


@pytest.mark.parametrize("case", ["repeat_heavy", "poly_a", "n_separated"])
def test_class_analysis_matches_plain(cuda, case):
    codes = class_case(case)
    codes2, nmask = upload(codes, cuda)
    keys, packed = kernels.front_half(codes2, nmask, len(codes), 15)
    keys_s, order = construct.sort_keys(list(keys))
    packed_s, pos_s = packed[order], order.to(torch.int32)
    before = kernels.LAUNCHES["class_analysis"]
    got = kernels.class_analysis(keys_s, packed_s, pos_s)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["class_analysis"] == before + 1
    want = kernels.class_analysis_plain(keys_s, packed_s, pos_s)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def assert_class_analysis_matches_plain(keys_s, packed_s, pos_s):
    """K2 twice in a row on the same rows (the tile counter and status words
    are reset per call), each equal to the plain version."""
    want = kernels.class_analysis_plain(keys_s, packed_s, pos_s)
    for _ in range(2):
        got = kernels.class_analysis(keys_s, packed_s, pos_s)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def run_rows(kind, n, tile, device, split=None):
    """class_runs' rows on `device` as (keys, packed, pos); with `split`,
    the keys over two limbs (torch_cases.split_limbs)."""
    key, packed, pos = class_runs(kind, n, tile)
    keys = (key,) if split is None else split_limbs(key, split)
    return (tuple(torch.from_numpy(a).to(device) for a in keys),
            torch.from_numpy(packed).to(device), torch.from_numpy(pos).to(device))


T = kernels.K2_TILE_ROWS


@pytest.mark.parametrize("n", [1, T - 1, T, T + 1, 3 * T + 5, 1 << 22])
@pytest.mark.parametrize("kind", CLASS_RUN_KINDS)
def test_class_analysis_matches_plain_on_hand_laid_runs(cuda, kind, n):
    before = kernels.LAUNCHES["class_analysis"]
    assert_class_analysis_matches_plain(*run_rows(kind, n, T, cuda))
    assert kernels.LAUNCHES["class_analysis"] == before + 2


@pytest.mark.parametrize("n", [1, T + 1, 3 * T + 5, 1 << 22])
@pytest.mark.parametrize("split", LIMB_SPLITS)
@pytest.mark.parametrize("kind", CLASS_RUN_KINDS)
def test_class_analysis_two_limbs_on_hand_laid_runs(cuda, kind, split, n):
    """Run boundaries on the high limb only, the low limb only, or both."""
    before = kernels.LAUNCHES["class_analysis"]
    assert_class_analysis_matches_plain(*run_rows(kind, n, T, cuda, split))
    assert kernels.LAUNCHES["class_analysis"] == before + 2


@pytest.mark.parametrize("kind", ["tile_edges", "invalid_middle", "one_run"])
def test_class_analysis_two_limbs_off_16_byte_alignment(cuda, kind):
    (hi, lo), packed, pos = run_rows(kind, 3 * T + 6, T, cuda, "both")
    assert_class_analysis_matches_plain((hi[1:], lo[1:]), packed[1:], pos[1:])


def test_class_analysis_tile_is_the_kernels(cuda):
    """The hand-laid runs are laid out by the kernel's own tile."""
    assert cudabuild.load().sz_class_tile_rows() == T


@pytest.mark.parametrize("kind", ["tile_edges", "invalid_middle", "one_run"])
def test_class_analysis_takes_rows_off_16_byte_alignment(cuda, kind):
    (key,), packed, pos = run_rows(kind, 3 * T + 6, T, cuda)
    assert_class_analysis_matches_plain((key[1:],), packed[1:], pos[1:])


@pytest.mark.parametrize("rows", [T - 1, T, T + 1])
def test_class_analysis_when_the_hot_class_fills_a_tile(cuda, rows):
    codes = class_case("poly_a_rows", rows=rows, k=15)
    codes2, nmask = upload(codes, cuda)
    keys, packed = kernels.front_half(codes2, nmask, len(codes), 15)
    keys_s, order = construct.sort_keys(list(keys))
    assert int((keys_s[0] == 0).sum()) == rows
    assert_class_analysis_matches_plain(keys_s, packed[order], order.to(torch.int32))


def test_class_analysis_two_limbs_poly_a_class(cuda):
    """A poly-A class of T + 1 rows at k=45 (key (0, 0)) through K1."""
    codes = class_case("poly_a_rows", rows=T + 1, k=45)
    codes2, nmask = upload(codes, cuda)
    keys, packed = kernels.front_half(codes2, nmask, len(codes), 45)
    keys_s, order = construct.sort_keys(list(keys))
    assert int(((keys_s[0] == 0) & (keys_s[1] == 0)).sum()) == T + 1
    assert_class_analysis_matches_plain(keys_s, packed[order], order.to(torch.int32))


def test_build_junctions_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    seqs = [
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=5000)]
        for _ in range(3)
    ]
    seqs[1][1000:1200] = seqs[0][3000:3200]
    seqs[2][100:140] = ord("N")
    got = construct.build_junctions(seqs, 15, cuda)
    want = construct.build_junctions(seqs, 15, "cpu")
    for a, b in zip(got, want):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)


def wide_pair(seed=3, n=12000):
    """tests/test_graph.py::TestWideK._pair, without JAX: a random genome
    with an N run, and a copy with 2% substitutions and an inversion."""
    rng = np.random.default_rng(seed)
    base = alphabet.decode(rng.integers(0, 4, size=n).astype(np.uint8))
    mut = base.copy()
    for p in np.flatnonzero(rng.random(len(mut)) < 0.02):
        mut[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
    mut[2000:3000] = alphabet.reverse_complement(mut[2000:3000])
    base[100:130] = ord("N")
    return [base, mut]


@pytest.mark.parametrize("k", [33, 61])
def test_build_junctions_two_limbs_cuda_matches_oracle(cuda, k):
    seqs = wide_pair()
    before = dict(kernels.LAUNCHES)
    got = construct.build_junctions(seqs, k, cuda)
    assert {name: kernels.LAUNCHES[name] - before[name] for name in before} == {
        "front_half": 1, "class_analysis": 1, "round_append": 0}
    for a, b in zip(got, oracle.enumerate_junctions(seqs, k)):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)


T4 = kernels.K4_TILE_ROWS


def assert_round_append_matches_plain(chunks, r0, n_rounds, G, cap, device, start=0,
                                      offset=0):
    """K4 over `chunks` (numpy (keys, packed, gpos0) each, appended in turn)
    against its plain version on the same card tensors: every buffer entry
    (unwritten ones hold -7), the cursors and the overflow flag equal.  With
    `offset`, each input is a view that starts `offset` rows into its
    storage.  Returns the cursors and the flag."""
    limbs = len(chunks[0][0])
    runs = []
    for fn in (kernels.round_append, kernels.round_append_plain):
        buf_keys = tuple(torch.full((G, cap), -7, dtype=torch.int64, device=device)
                         for _ in range(limbs))
        buf_payload = torch.full((G, cap), -7, dtype=torch.int64, device=device)
        cursors = torch.full((G,), start, dtype=torch.int64, device=device)
        overflow = torch.zeros(1, dtype=torch.int32, device=device)
        for keys, packed, gpos0 in chunks:
            pad = lambda a: torch.from_numpy(  # noqa: E731
                np.concatenate([np.zeros(offset, a.dtype), a])).to(device)[offset:]
            fn(tuple(pad(x) for x in keys), pad(packed), gpos0, r0, n_rounds, buf_keys,
               buf_payload, cursors, overflow)
        torch.cuda.synchronize()
        runs.append((*buf_keys, buf_payload, cursors, overflow))
    for got, want in zip(*runs):
        assert torch.equal(got, want)
    return runs[0][-2], runs[0][-1]


def round_chunks(kind, limbs, sizes, gpos0=1, hot=0):
    chunks = []
    for c, m in enumerate(sizes):
        keys, packed = round_rows(kind, m, limbs, seed=c, hot=hot, tile=T4)
        chunks.append((keys, packed, gpos0))
        gpos0 += m
    return chunks


@pytest.mark.parametrize("limbs", [1, 2])
@pytest.mark.parametrize("kind", ROUND_ROW_KINDS)
@pytest.mark.parametrize("r0,n_rounds,G", [(0, 1, 1), (0, 8, 8), (3, 8, 1), (5, 8, 3),
                                           (0, 64, 64), (30, 100, 64)])
def test_round_append_matches_plain(cuda, kind, limbs, r0, n_rounds, G):
    """Every round taking rows (random), one round taking all (one_class),
    none kept (all_invalid), rounds fed from every tile (repeats), the
    pass's first round in every 5th tile alone (sparse: the look-back walks
    past tiles with no kept row) and in runs on tile boundaries and one row
    either side (tile_runs), every round in every tile (all_rounds); G from
    1 to the kernel's maximum; chunks one row short of, at, and past tile
    multiples, and one of 12 tiles."""
    before = kernels.LAUNCHES["round_append"]
    chunks = round_chunks(kind, limbs, (T4 - 1, T4, T4 + 1, 3 * T4, 3 * T4 + 5, 1, 11 * T4 + 3),
                          hot=r0)
    cap = sum(len(c[1]) for c in chunks)
    cursors, overflow = assert_round_append_matches_plain(chunks, r0, n_rounds, G, cap, cuda)
    assert kernels.LAUNCHES["round_append"] == before + len(chunks)
    assert int(overflow) == 0
    if kind == "all_invalid":
        assert int(cursors.sum()) == 0
    if kind == "one_class" and (r0, n_rounds, G) == (0, 1, 1):
        assert int(cursors[0]) == cap


@pytest.mark.parametrize("limbs", [1, 2])
@pytest.mark.parametrize("G", [1, 8])
def test_round_append_full_size_chunks(cuda, limbs, G):
    """Chunks of the streamed stage's size (2^22 rows, and one of 2^22 + 3),
    K1's outputs on random codes with N runs, three in a row."""
    k = 25 if limbs == 1 else 33
    chunks, gpos0 = [], 1
    for c, m in enumerate((1 << 22, (1 << 22) + 3, 1 << 22)):
        codes2, nmask = upload(codes_with_n_runs(c, m + k + 2, m // 500), cuda)
        keys, packed = kernels.front_half(codes2, nmask, m + k + 2, k)
        chunks.append((tuple(x[1 : m + 1].cpu().numpy() for x in keys),
                       packed[1 : m + 1].cpu().numpy(), gpos0))
        gpos0 += m
    cap = gpos0 if G == 1 else gpos0 // 6
    assert_round_append_matches_plain(chunks, 0 if G == 8 else 5, 8, G, cap, cuda)


def test_round_append_max_rounds_is_the_kernels(cuda):
    lib = cudabuild.load()
    assert lib.sz_round_max_rounds() == kernels.MAX_ROUNDS_PER_LAUNCH >= 16
    assert lib.sz_round_tile_rows() == T4


def test_round_append_scratch_is_the_plans(cuda):
    """streamed.plan reserves kernels.round_scratch_bytes for K4's scratch:
    the kernel takes exactly that."""
    lib = cudabuild.load()
    for m in (1, T4 - 1, T4, T4 + 1, 3 * T4 + 5, 1 << 22, (1 << 22) + 3):
        for G in (1, 2, 3, 8, 33, 64):
            assert lib.sz_round_scratch_bytes(m, G) == kernels.round_scratch_bytes(m, G), (m, G)


@pytest.mark.parametrize("limbs", [1, 2])
@pytest.mark.parametrize("kind", ["random", "repeats", "one_class"])
def test_round_append_cursors_just_under_the_cap(cuda, kind, limbs):
    """Cursors 5 rows under the cap: the flag is set, the rows that fit are
    written and none past the cap (the buffers equal the plain version's,
    whose -7s stand), the cursors advance by every kept row."""
    chunks = round_chunks(kind, limbs, (3 * T4 + 7,))
    cursors, overflow = assert_round_append_matches_plain(chunks, 0, 4, 4, 1000, cuda,
                                                          start=995)
    assert int(overflow) == 1 and int(cursors.max()) > 1000


@pytest.mark.parametrize("limbs", [1, 2])
@pytest.mark.parametrize("offset", [1, 3])
def test_round_append_takes_views_off_16_byte_alignment(cuda, limbs, offset):
    chunks = round_chunks("random", limbs, (3 * T4 + 5, T4))
    assert_round_append_matches_plain(chunks, 1, 4, 2, 4 * T4 + 5, cuda, offset=offset)


def streamed_seqs():
    rng = np.random.default_rng(41)
    base = alphabet.decode(rng.integers(0, 4, size=20000).astype(np.uint8))
    mut = base.copy()
    idx = np.flatnonzero(rng.random(len(mut)) < 0.01)
    mut[idx] = alphabet.decode(rng.integers(0, 4, size=len(idx)).astype(np.uint8))
    mut[5000:5004] = ord("N")
    return [base, mut, alphabet.reverse_complement(base)]


@pytest.mark.parametrize("k", [15, 33, 61])
@pytest.mark.parametrize("kw", [{"chunk_size": 4096, "n_rounds": 3},
                                {"chunk_size": 1024, "n_rounds": 2, "round_slack": 0.2},
                                {"chunk_size": 2048, "n_rounds": 8, "passes": 3}],
                         ids=["rounds3", "overflow_retry", "three_passes"])
def test_streamed_stage_cuda_matches_cpu(cuda, k, kw):
    """The streamed stage on the card against its CPU run (the plain K1, K2
    and K4), with launches of all three kernels; `passes`: a budget that
    holds 3 of 8 round buffers."""
    seqs = streamed_seqs()
    kw = dict(kw)
    if kw.pop("passes", None):
        n = 1 + sum(len(s) + 1 for s in seqs)
        p = streamed.plan(n, k, kw["chunk_size"], 1.25, None, kw.pop("n_rounds"))
        kw["memory_budget_bytes"] = p.fixed_bytes + p.cap * (p.epilogue_bytes + 3 * p.row_bytes)
    before = dict(kernels.LAUNCHES)
    got = streamed.build_junctions_streamed_resident(seqs, k, cuda, **kw)
    assert all(kernels.LAUNCHES[name] > before[name] for name in before)
    want = streamed.build_junctions_streamed_resident(seqs, k, "cpu", **kw)
    for a, b in zip(got, want):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)
    for a, b in zip(want, construct.build_junctions(seqs, k, "cpu")):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)


@pytest.mark.parametrize("limbs", [1, 2])
@pytest.mark.parametrize("kind", ["random", "tile_runs"])
def test_round_append_past_2_32(cuda, kind, limbs):
    """Chunks whose global positions straddle 2^32: the payloads keep every
    bit of the position, as the plain version's do."""
    m = 3 * T4 + 5
    chunks = round_chunks(kind, limbs, (m, T4 + 1), gpos0=(1 << 32) - m // 2)
    cap = sum(len(c[1]) for c in chunks)
    assert_round_append_matches_plain(chunks, 0, 4, 4, cap, cuda)


def poly_a_seq():
    """tests/test_torch_streamed.py's class that outgrows every round: a
    poly-A run of 5,000 bases after 3,000 random ones."""
    rng = np.random.default_rng(3)
    seq = alphabet.decode(rng.integers(0, 4, size=3000).astype(np.uint8))
    return [np.concatenate([seq, np.full(5000, ord("A"), np.uint8)])]


@pytest.mark.parametrize("k", [15, 33])
def test_host_rounds_cuda_matches_cpu(cuda, k):
    """The host-bucketed rounds on the card against their CPU run: K1 and K2
    launched, K4 not."""
    seqs = streamed_seqs()
    before = dict(kernels.LAUNCHES)
    got = streamed.build_junctions_streamed(seqs, k, cuda, chunk_size=4096, n_rounds=5)
    launched = {name: kernels.LAUNCHES[name] - before[name] for name in before}
    assert launched["front_half"] > 0 and launched["class_analysis"] > 0
    assert launched["round_append"] == 0
    want = streamed.build_junctions_streamed(seqs, k, "cpu", chunk_size=4096, n_rounds=5)
    for a, b in zip(got, want):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)
    for a, b in zip(want, construct.build_junctions(seqs, k, "cpu")):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)


def test_overflow_hand_over_cuda_matches_cpu(cuda):
    """A class that outgrows every round: the resident rounds hand over to
    the host-bucketed rounds at 64 rounds on the card as on the CPU."""
    kw = {"chunk_size": 1024, "n_rounds": 1, "round_slack": 0.5}
    metrics.counters.clear()
    got = streamed.build_junctions_streamed_resident(poly_a_seq(), 15, cuda, **kw)
    assert metrics.counters["graph_host_rounds"] == 64
    want = streamed.build_junctions_streamed_resident(poly_a_seq(), 15, "cpu", **kw)
    for a, b in zip(got, want):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)


def test_launches_go_to_the_tensors_device(cuda):
    """K1, K2 and K4 on cuda:1 while cuda:0 is current: the streamed stage's
    records equal its CPU run's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    seqs = streamed_seqs()
    before = dict(kernels.LAUNCHES)
    with torch.cuda.device(0):
        got = streamed.build_junctions_streamed_resident(
            seqs, 15, torch.device("cuda:1"), chunk_size=4096, n_rounds=3)
    assert all(kernels.LAUNCHES[name] > before[name] for name in before)
    want = streamed.build_junctions_streamed_resident(seqs, 15, "cpu", chunk_size=4096,
                                                      n_rounds=3)
    for a, b in zip(got, want):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)


def poa_args(case, scale, device, holes=False):
    """K3's arguments for one seeded case, on `device`; with `holes`, the
    predecessor slots spread so that unused ones lie between used ones."""
    blocks, band_min = poa_case(case, scale)
    plan = lambda *a: device_poa._plan_windows(*a, band_min=band_min)  # noqa: E731
    arrays, n_max, W, P, _ = poa_round(
        blocks, poa_ref.PoaGraph, device_poa._extract_arrays, plan)
    arrays = list(arrays)
    if holes:
        arrays[3], arrays[4] = spread_slots(arrays[3], arrays[4], n_max)
    t = [torch.from_numpy(a).to(device) for a in arrays]
    return (*t[:6], n_max, W, P, t[6])


@pytest.mark.parametrize("case", ["unbanded", "banded", "tie_heavy", "far_pred",
                                  "many_preds", "odd_w"])
@pytest.mark.parametrize("scale", [1, 8])
def test_poa_dp_tb_matches_plain(cuda, case, scale):
    args = poa_args(case, scale, cuda)
    before = align_kernels.LAUNCHES["poa_dp_tb"]
    got = align_kernels.poa_dp_tb(*args)
    torch.cuda.synchronize()
    assert align_kernels.LAUNCHES["poa_dp_tb"] == before + 1
    want = align_kernels.poa_dp_tb_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)


@pytest.mark.parametrize("case", ["banded", "tie_heavy", "many_preds"])
def test_poa_dp_tb_takes_holes_in_the_slot_mask(cuda, case):
    args = poa_args(case, 2, cuda, holes=True)
    got = align_kernels.poa_dp_tb(*args)
    torch.cuda.synchronize()
    want = align_kernels.poa_dp_tb_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("config", [
    {"cols": 1, "threads": 64, "depth": 0},  # the window in chunks of 64
    {"cols": 2, "threads": 32, "depth": 0},
    {"cols": 8, "threads": 32, "depth": 0},  # one chunk (two for odd_w), no ring
    {"cols": 8, "threads": 64, "depth": 3},  # a ring shorter than the far preds
    {"cols": 4, "threads": 1024, "depth": 8},  # most threads past the window
], ids=lambda c: "-".join(str(v) for v in c.values()))
@pytest.mark.parametrize("case", ["banded", "far_pred", "many_preds", "odd_w"])
def test_poa_dp_tb_launch_shapes(cuda, case, config):
    """Every launch shape gives the plain version's outputs, not only the
    one launch_config picks for the window."""
    args = poa_args(case, 1, cuda)
    got = align_kernels.poa_dp_tb(*args, config=config)
    torch.cuda.synchronize()
    want = align_kernels.poa_dp_tb_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("W, config", [
    (261, None), (263, None), (518, None),  # launch_config's 4 columns
    (13, {"cols": 8, "threads": 32, "depth": 2}),
    (250, {"cols": 8, "threads": 32, "depth": 1}),
    (63, {"cols": 2, "threads": 32, "depth": 2}),
], ids=str)
def test_poa_dp_tb_band_rides_the_window_edge(cuda, W, config):
    """A moving window whose width is no multiple of the columns per thread,
    the alignment in its last column: the thread that straddles the window's
    end keeps the right sequence byte under it from rank to rank."""
    arrays, n_max, W, P = edge_band_round(W)
    t = [torch.from_numpy(a).to(cuda) for a in arrays]
    args = (*t[:6], n_max, W, P, t[6])
    got = align_kernels.poa_dp_tb(*args, config=config)
    torch.cuda.synchronize()
    want = align_kernels.poa_dp_tb_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_poa_dp_tb_window_wider_than_one_chunk(cuda):
    """An unbanded 8.3 kbp copy runs at W 16384, which launch_config cuts
    into two chunks of 8 columns x 1,024 threads."""
    blocks = [rand_block(np.random.default_rng(17), 8300, 2, mut=0.03)]
    plan = functools.partial(device_poa._plan_windows, band=False)
    arrays, n_max, W, P, _ = poa_round(
        blocks, poa_ref.PoaGraph, device_poa._extract_arrays, plan)
    cfg = align_kernels.launch_config(W)
    assert W == 16384 and cfg["depth"] == 0 and cfg["cols"] * cfg["threads"] == 8192
    t = [torch.from_numpy(a).to(cuda) for a in arrays]
    args = (*t[:6], n_max, W, P, t[6])
    got = align_kernels.poa_dp_tb(*args)
    torch.cuda.synchronize()
    want = align_kernels.poa_dp_tb_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", [*range(len(BUNDLE_CASES)), "ties"])
def test_bundles_cuda_matches_cpu(cuda, case):
    """make_bundles_device's sort on the card gives the CPU's bundle list,
    field by field and in order, on tests/test_device_bundles.py's four
    seeded tables and on the hand-laid table with tied keys."""
    if case == "ties":
        table = tied_table(0)
    else:
        seed, kwargs = BUNDLE_CASES[case]
        seqs, names = related_genomes(seed, **kwargs)
        table = pipeline.build_table(seqs, names, Config(k=15), device="cpu")
    got = bundle_fields(make_bundles_device(table, "cuda"))
    assert got and got == bundle_fields(make_bundles_device(table, "cpu"))


def assert_same_records(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids)


@pytest.mark.parametrize("k", [15, 33])
@pytest.mark.parametrize("kind", [*SHARD_EDGE_KINDS, "related"])
def test_sharded_cuda_matches_cpu(cuda, kind, k):
    """The sharded graph stage with every shard on cuda:0 (one shard a list
    entry): the monolithic stage's records on the CPU, through K1 and K2."""
    if kind == "related":
        seqs, n = related_genomes(5, n_genomes=3, n_chr=2, length=1500, rearrange=True)[0], 4
    else:
        seqs, n, _junction = shard_edge_case(kind)
    before = dict(kernels.LAUNCHES)
    got = sharded.build_junctions_sharded(seqs, k, ["cuda:0"] * n)
    assert kernels.LAUNCHES["front_half"] == before["front_half"] + n
    # K2 launches on each owner that receives rows (none where no window fits)
    assert (kernels.LAUNCHES["class_analysis"] > before["class_analysis"]) == (
        max(len(s) for s in seqs) >= k)
    assert_same_records(got, construct.build_junctions(seqs, k, "cpu"))


def test_sharded_nccl_world_size_1(cuda, tmp_path):
    """build_junctions_multihost over an NCCL group of one rank (its own
    file store): the exchange and the gather through NCCL, the monolithic
    records at k=15 and 33."""
    import torch.distributed as dist

    seqs = related_genomes(5, n_genomes=3, n_chr=2, length=1500, rearrange=True)[0]
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            world_size=1, rank=0)
    try:
        for k in (15, 33):
            got = multihost.build_junctions_multihost(seqs, k, device="cuda:0")
            assert_same_records(got, construct.build_junctions(seqs, k, "cpu"))
    finally:
        dist.destroy_process_group()


def test_poa_spread_cuda_matches_one_device(cuda):
    """The dry run's seeded blocks, each dispatch cut over [cuda:0, cuda:0]:
    the one-device run's MSAs and poa_ref's."""
    _seqs, blocks = dryrun_inputs(4)
    before = align_kernels.LAUNCHES["poa_dp_tb"]
    one = device_poa.poa_msa_batch_tpu(blocks, device="cuda")
    mid = align_kernels.LAUNCHES["poa_dp_tb"]
    spread = device_poa.poa_msa_batch_tpu(blocks, devices=["cuda:0", "cuda:0"])
    assert align_kernels.LAUNCHES["poa_dp_tb"] - mid == 2 * (mid - before)
    assert spread == one
    assert all(m == poa_ref.poa_msa(rows) for rows, m in zip(blocks, spread))


def test_sharded_on_two_cards(cuda):
    """Shards on cuda:0 and cuda:1 (the rows cross by peer copies): the
    monolithic records."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    seqs = related_genomes(5, n_genomes=3, n_chr=2, length=1500, rearrange=True)[0]
    for devices in (["cuda:0", "cuda:1"], ["cuda:0", "cuda:1"] * 2):
        assert_same_records(sharded.build_junctions_sharded(seqs, 15, devices),
                            construct.build_junctions(seqs, 15, "cpu"))


def fused_case(k=15):
    from sibeliaz_tpu_torch.lcb.oracle import LcbEngine

    seqs, names = related_genomes(520, length=1200, mut=0.03, rearrange=True)
    cfg = Config(k=k)
    table = pipeline.build_table(seqs, names, cfg, device="cpu")
    return LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking)


@pytest.mark.parametrize("steps", [3, "end"])
@pytest.mark.parametrize("tier", [(64, 32, 64, 128), (512, 16, 512, 1024)])
def test_fused_carry_cuda_matches_cpu(cuda, tier, steps):
    """The fused state machine from the same seeded lanes run 3 outer steps
    and to the phase's end on the card (its votes through K6, its walk
    chunks through K5, one launch each a step) and on the CPU (through
    their plain versions): every field of the carry equal, and the
    counters but the seconds, at the narrow and the wide tier."""
    from sibeliaz_tpu_torch.lcb import fused, kernels, resident

    eng = fused_case()
    bundles = make_bundles_device(eng.t, "cpu")[:32]
    CAP, W, IC, PC = tier
    limit = fused.MAX_STEPS if steps == "end" else steps
    carries, counters = [], []
    for dev in ("cuda", "cpu"):
        tb = resident._device_tables(eng, dev)
        ln, _, ovf = resident._seed_lanes_device(tb, bundles, 32, IC, PC)
        st = resident.seed_state(ln)  # as the engines seed it: K5 walks it in place
        active = (torch.arange(32, device=dev) < len(bundles)) & ~ovf
        launches = dict(kernels.LAUNCHES)
        metrics.counters.clear()
        carry, reading = fused._phase_fused_seg(
            CAP, W, IC >= fused.I_CAP, tb, fused._init_carry(st, active, 32), eng.depth, eng.m,
            eng.b, eng.flank, eng.b * 2, limit)
        for name in ("lcb_walk", "lcb_vote"):  # one walk and one vote a step
            assert kernels.LAUNCHES[name] - launches[name] == (
                carry["steps"] if dev == "cuda" else 0)
        if steps == "end":
            assert reading[0] == 0 and carry["steps"] > 20
        else:
            assert reading[0] > 0 and carry["steps"] == steps
        carries.append(carry)
        counters.append({k: v for k, v in metrics.counters.items() if not k.endswith("_s")})
    assert not state_diff(*carries)
    assert counters[0] == counters[1] and counters[0]["fused_lane_occ_steps"] > 0


@functools.lru_cache(maxsize=None)
def walk_engine(kind):
    """The LCB engine of a K5 case's genomes: the related pair, a 300-copy
    repeat, or genomes where a walk outgrows the narrow slab."""
    from sibeliaz_tpu_torch.lcb.oracle import LcbEngine

    if kind == "related":
        return fused_case()
    seqs, names = repeat_genomes(3, 300) if kind == "repeat" else walk_genomes(3)
    cfg = Config(k=15, abundance_threshold=1000)
    table = pipeline.build_table(seqs, names, cfg, device="cpu")
    return LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking)


# tests/test_torch_lcb_walk.py's cases: genomes, slab widths, push limit
# (fused.WALK_CHUNK, resident._MAX_WALK, 2)
WALK_CASES = {
    "narrow": ("related", (64, 128), 16),
    "wide": ("related", (512, 1024), 2048),
    "bounded": ("related", (64, 128), 2),
    "many_occurrences": ("repeat", (512, 1024), 2048),
    "overflow": ("overflow", (64, 128), 16),
}


def walk_inputs(case, rows_given, again, widths=None, device="cuda"):
    """A K5 case on the card: (engine, tables, state, per-row arguments
    rows, c, i, s, fwd, tvid, active, last, limit).  Without `rows_given`
    the rows are every lane in order (the fused engine's form: lanes with
    no walk inactive, with its padding), else the walking lanes shuffled
    with sentinel rows (the resident engine's form).  With `again` the
    state is that after a first walk (rewind and result slabs apart from
    the live one, best scores set) and new walks start from it.  The state
    is seeded as the engines seed it, each of its tensors its own, at the
    case's slab widths or at `widths`, on `device`."""
    from sibeliaz_tpu_torch.lcb import kernels
    from sibeliaz_tpu_torch.lcb.batched_push_device import BIG

    kind, (IC, PC), limit = WALK_CASES[case]
    IC, PC = widths or (IC, PC)
    eng = walk_engine(kind)
    tb, st, n_lanes = walk_lanes(eng, 32, IC, PC, device, apart=True)
    rng = np.random.default_rng(11)
    args = walk_args(eng, st, n_lanes, rng)
    if again:
        rows, c, i, s, fwd, tvid = walk_tensors(args, device)
        on = torch.ones_like(fwd)
        st = state_apart(kernels.lcb_walk_plain(tb, st, rows, c, i, s, fwd, tvid, on, ~on,
                                                eng.m, eng.b, eng.flank, limit).st)
        args = walk_args(eng, st, n_lanes, np.random.default_rng(12))
    if rows_given:
        rows, c, i, s, fwd, tvid = walk_tensors(with_sentinel_rows(args, 32, rng), device)
        active = torch.ones_like(fwd)
        last = torch.from_numpy(rng.random(len(rows)) < 0.5).to(device)
        return eng, tb, st, (rows, c, i, s, fwd, tvid, active, last), limit
    lane_args = [np.zeros(32, np.int64), np.zeros(32, np.int64), np.ones(32, np.int64),
                 np.zeros(32, bool), np.full(32, BIG, np.int64)]
    for q, a in enumerate(args[1:]):
        lane_args[q][args[0]] = a
    active = np.zeros(32, bool)
    active[args[0]] = rng.random(len(args[0])) < 0.9
    c, i, s, fwd, tvid = walk_tensors(lane_args, device)
    last = torch.from_numpy(rng.random(32) < 0.5).to(device)
    return eng, tb, st, (None, c, i, s, fwd, tvid, torch.from_numpy(active).to(device), last), \
        limit


def test_lcb_walk_engines_never_run_the_plain_walk_on_the_card(cuda, monkeypatch):
    """Both device LCB engines on the card walk on the card alone: with the
    plain walk made to raise, a phase of 32 bundles through each engine
    gives eng.process's instance lists; the resident engine launches K5,
    the fused engine K7 (whose blocks walk by K5's algorithm) and no K5."""
    from sibeliaz_tpu_torch.lcb import fused, kernels, resident

    def refuse(*args):
        raise AssertionError("the plain walk ran on the card")

    monkeypatch.setattr(kernels, "lcb_walk_plain", refuse)
    eng = fused_case()
    bundles = make_bundles_device(eng.t, "cpu")[:32]
    want = [[(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]
            for insts in (eng.process(b) for b in bundles)]
    for fn, walks in ((fused.process_phase_fused, "lcb_step"),
                      (resident.process_phase_resident, "lcb_walk")):
        launches = dict(kernels.LAUNCHES)
        got = fn(eng, bundles, device="cuda")
        assert [[(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]
                for insts in got] == want
        assert kernels.LAUNCHES[walks] > launches[walks]
        if walks == "lcb_step":
            assert kernels.LAUNCHES["lcb_walk"] == launches["lcb_walk"]


def walk_checked(eng, tb, st, args, limit):
    """One K5 call on the card against the plain version on a copy of the
    state taken first: every output exact (the state's 68 tensors in every
    column and the ten per-row results), one launch, the state walked in
    place (the call returns the tensors it was given) with no allocation
    but its results (the caching allocator's 512-byte granules), the lanes
    no walking row names unchanged bit for bit.  Returns (K5's Walk, the
    state before the walk)."""
    from sibeliaz_tpu_torch.lcb import kernels
    from sibeliaz_tpu_torch.lcb.batched_push_device import _state_leaves

    before = state_apart(st)
    want = kernels.lcb_walk_plain(tb, before, *args, eng.m, eng.b, eng.flank, limit)
    A = args[1].shape[0]
    dev = st.ln.chr.device
    launches = kernels.LAUNCHES["lcb_walk"]
    torch.cuda.synchronize(dev)
    allocated = torch.cuda.memory_allocated(dev)
    got = kernels.lcb_walk(tb, st, *args, eng.m, eng.b, eng.flank, limit)
    assert torch.cuda.memory_allocated(dev) - allocated <= -(-10 * A * 8 // 512) * 512
    torch.cuda.synchronize(dev)
    assert kernels.LAUNCHES["lcb_walk"] == launches + 1
    assert all(x is y for x, y in zip(_state_leaves(got.st), _state_leaves(st)))
    assert not state_diff(got._asdict(), want._asdict())
    L = st.ln.chr.shape[0]
    rows = torch.arange(L, device=dev) if args[0] is None else args[0]
    walked = set(rows[got.pushes > 0].tolist())
    quiet = torch.tensor([q for q in range(L) if q not in walked], dtype=torch.int64,
                         device=dev)
    for x, y in zip(_state_leaves(st), _state_leaves(before)):
        assert torch.equal(x[quiet], y[quiet])
    return got, before


@pytest.mark.parametrize("again", [False, True])
@pytest.mark.parametrize("rows_given", [True, False])
@pytest.mark.parametrize("case", list(WALK_CASES))
def test_lcb_walk_matches_plain(cuda, case, rows_given, again):
    """K5 against its plain version on the card (walk_checked: every output
    exact, the state walked in place with no allocation but the results,
    the lanes no walking row names, sentinels' included, unchanged): the
    narrow and the full slab widths, mixed directions, at WALK_CHUNK,
    _MAX_WALK and a limit of 2 pushes, a vertex of hundreds of occurrences
    (the repeat), lanes that overflow their slab mid-walk; rows given with
    sentinels among them or every lane in order; from the seeded state and
    from the state after a first walk."""
    eng, tb, st, args, limit = walk_inputs(case, rows_given, again)
    got, before = walk_checked(eng, tb, st, args, limit)
    assert int(got.pushes.max()) >= 1 and bool(state_diff(st, before))
    if case == "overflow" and not again:
        assert bool((got.overflow & (got.pushes > 0)).any())


def test_lcb_walk_allocates_only_its_results(cuda):
    """A walk call of 32 rows (every lane in order) allocates its [10, 32]
    results and nothing else: 2,560 bytes, five whole granules of the
    caching allocator."""
    from sibeliaz_tpu_torch.lcb import kernels

    eng, tb, st, args, limit = walk_inputs("wide", False, False)
    assert args[1].shape[0] == 32
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    got = kernels.lcb_walk(tb, st, *args, eng.m, eng.b, eng.flank, limit)
    assert torch.cuda.memory_allocated() - allocated <= 10 * 32 * 8
    torch.cuda.synchronize()
    assert int(got.pushes.max()) >= 1


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("widths", [(60, 100), (61, 101), (64, 128)])
def test_lcb_walk_at_other_widths(cuda, widths, offset):
    """Slab widths the engines never use, whose byte rows (IC 60, 61) or
    int64 rows (IC 61, PC 101) are no multiple of 16 bytes, and every
    state tensor a view one element past a 16-byte boundary (offset 1): the
    rows that bulk copies cannot take go by the vectorised loop, exact as
    walk_checked holds them, rows given with sentinels and every lane in
    order."""
    from sibeliaz_tpu_torch.lcb.batched_push_device import _state_from_leaves, _state_leaves

    for rows_given in (True, False):
        eng, tb, st, args, limit = walk_inputs("narrow", rows_given, False, widths)
        if offset:
            def shifted(x):
                home = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
                view = home[offset:].view(x.shape)
                view.copy_(x)
                return view

            st = _state_from_leaves([shifted(x) for x in _state_leaves(st)])
            assert st.ln.chr.data_ptr() % 16 == 8
        got, _ = walk_checked(eng, tb, st, args, limit)
        assert int(got.pushes.max()) >= 1


def test_lcb_walk_on_the_tensors_device(cuda):
    """K5 on cuda:1 while cuda:0 is current: the plain version's outputs
    (walk_checked), rows given with sentinels and every lane in order."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    for rows_given in (True, False):
        eng, tb, st, args, limit = walk_inputs("wide", rows_given, False, device="cuda:1")
        with torch.cuda.device(0):
            got, _ = walk_checked(eng, tb, st, args, limit)
        assert int(got.pushes.max()) >= 1


def test_lcb_walk_refuses_an_overlapping_state(cuda):
    """A state whose slabs share their tensors (ln = rw = sn) is refused on
    the card before any launch, with the leaves named; nothing falls back."""
    from sibeliaz_tpu_torch.lcb import kernels

    eng = walk_engine("related")
    tb, st, n_lanes = walk_lanes(eng, 32, 64, 128, "cuda")
    rows, c, i, s, fwd, tvid = walk_tensors(walk_args(eng, st, n_lanes, np.random.default_rng(11)),
                                            "cuda")
    on = torch.ones_like(fwd)
    launches = kernels.LAUNCHES["lcb_walk"]
    with pytest.raises(ValueError, match="overlaps"):
        kernels.lcb_walk(tb, st, rows, c, i, s, fwd, tvid, on, ~on, eng.m, eng.b, eng.flank, 16)
    assert kernels.LAUNCHES["lcb_walk"] == launches


@pytest.mark.parametrize("patch", [{}, {"SMALL_CAP": 3, "VOTE_BUDGET": 1 << 14},
                                   {"COMPACT_MIN": 8}])
def test_fused_phase_cuda_matches_cpu(cuda, monkeypatch, patch):
    """process_phase_fused on the card: the CPU's instance lists, lane by
    lane, and eng.process's; with a narrow tier that overflows (the lanes
    escalate to the wide tier) and with compaction."""
    from sibeliaz_tpu_torch.lcb import fused

    for name, value in patch.items():
        monkeypatch.setattr(fused, name, value)
    eng = fused_case()
    bundles = make_bundles_device(eng.t, "cpu")[:32]
    metrics.counters.clear()
    got = fused.process_phase_fused(eng, bundles, device="cuda")
    if "SMALL_CAP" in patch:
        assert metrics.counters["fused_lanes_tier1"] > 0
    want = fused.process_phase_fused(eng, bundles, device="cpu")

    def keys(results):
        return [[(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]
                for insts in results]

    assert keys(got) == keys(want) == keys(eng.process(b) for b in bundles)
    assert any(got)


@pytest.mark.parametrize("k", [15, 33])
def test_run_fused_gff_cuda_matches_cpu(cuda, k):
    """--lcb-engine tpu-fused through the pipeline on the card: the CPU
    run's GFF and the native engine's."""
    seqs, names = related_genomes(521, length=1200, mut=0.03, rearrange=True)
    got = pipeline.find_blocks(seqs, names, Config(k=k), engine="tpu-fused", device="cuda")
    cpu = pipeline.find_blocks(seqs, names, Config(k=k), engine="tpu-fused", device="cpu")
    native = pipeline.find_blocks(seqs, names, Config(k=k), device="cpu")
    assert got.gff == cpu.gff == native.gff and got.blocks_found > 0


@pytest.mark.parametrize("tiers", [None, ((64, 2), (512, 2), (512, 256)),
                                   ((64, 14), (512, 14), (512, 14))])
def test_resident_phase_cuda_matches_cpu(cuda, monkeypatch, tiers):
    """process_phase_resident on the card: the CPU's instance lists, lane by
    lane, and eng.process's, on a 32-bundle phase; with the first tiers'
    windows cut (votes retry at the last tier) and with every window cut
    (lanes go to the host oracle)."""
    from sibeliaz_tpu_torch.lcb import resident

    if tiers:
        monkeypatch.setattr(resident, "VOTE_TIERS", tiers)
    eng = fused_case()
    bundles = make_bundles_device(eng.t, "cpu")[:32]
    counters = []
    runs = []
    for dev in ("cuda", "cpu"):
        metrics.counters.clear()
        runs.append(resident.process_phase_resident(eng, bundles, device=dev))
        counters.append({k: v for k, v in metrics.counters.items()
                         if k.startswith("resident_") and not k.endswith("_s")})

    def keys(results):
        return [[(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]
                for insts in results]

    assert keys(runs[0]) == keys(runs[1]) == keys(eng.process(b) for b in bundles)
    assert counters[0] == counters[1] and counters[0]["resident_rounds"] > 0
    assert any(runs[0])


def fused_devices_check(devices):
    """process_phase_fused with the lanes over `devices`: the one-device
    run's instance lists on the card and eng.process's, lane by lane; the
    tables cached once a card ("cuda" shares "cuda:0"'s copy)."""
    from sibeliaz_tpu_torch.lcb import fused

    eng = fused_case()
    bundles = make_bundles_device(eng.t, "cpu")[:32]
    metrics.counters.clear()
    got = fused.process_phase_fused(eng, bundles, devices=devices)
    assert metrics.counters["fused_slices"] == len(devices)
    one = fused.process_phase_fused(eng, bundles, device="cuda")

    def keys(results):
        return [[(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]
                for insts in results]

    assert keys(got) == keys(one) == keys(eng.process(b) for b in bundles)
    assert any(got)
    assert sorted(map(str, eng._fused_tb)) == sorted(set(devices))


def test_fused_devices_cuda_matches_one_device(cuda):
    fused_devices_check(["cuda:0", "cuda:0"])


def test_fused_devices_on_two_cards(cuda):
    """The lanes over cuda:0 and cuda:1 (the tables on both cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    fused_devices_check(["cuda:0", "cuda:1"])


@pytest.mark.parametrize("k", [15, 33])
def test_junction_analysis_cuda_matches_cpu(cuda, k):
    """junction_analysis on the card (the codes packed there, one K1 and
    one K2 launch) equal to its CPU run, N runs included."""
    codes = torch.from_numpy(codes_with_n_runs(k, 200_003, 400, n_at_ends=True))
    before = dict(kernels.LAUNCHES)
    got = construct.junction_analysis(codes.to(cuda), k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["front_half"] == before["front_half"] + 1
    assert kernels.LAUNCHES["class_analysis"] == before["class_analysis"] + 1
    want = construct.junction_analysis(codes, k)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert want[0].any()
    flags, first = construct.junction_analysis_packed(codes.to(cuda), k)
    want_flags, want_first = construct.junction_analysis_packed(codes, k)
    assert torch.equal(flags.cpu(), want_flags) and torch.equal(first.cpu(), want_first)


def vote_checked(case, retry, device="cuda"):
    """One K6 call of a VOTE_CASES case on `device` against the plain
    version on the CPU: best_vid, best_cnt and overflow in every row, the
    origin columns where a winner exists, one launch.  Returns (K6's six
    outputs on the host, the rows' workspace flags)."""
    from sibeliaz_tpu_torch.lcb import kernels, vote

    tb, ln, rows, CAP, W, depth, b, n_max = vote_case(case, "cpu")
    plain = vote.vote_retry_plain if retry else vote.vote_plain
    want = [x.numpy() for x in plain(CAP, W, tb, ln, *rows, depth, b, n_max)]
    tb, ln, rows, *_ = vote_case(case, device)
    spilled = torch.full((rows[0].shape[0],), -1, dtype=torch.int64, device=device)
    launches = kernels.LAUNCHES["lcb_vote"]
    got = kernels.lcb_vote(CAP, W, tb, ln, *rows, depth, b, n_max, retry=retry, spilled=spilled)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["lcb_vote"] == launches + 1
    got = [x.cpu().numpy() for x in got]
    for a, w in zip(got[:2] + got[5:], want[:2] + want[5:]):
        assert np.array_equal(a, w)
    win = want[0] != 0
    for a, w in zip(got[2:5], want[2:5]):
        assert np.array_equal(a[win], w[win])
    assert win.any()
    return got, spilled.cpu().numpy()


@pytest.mark.parametrize("retry", [False, True])
@pytest.mark.parametrize("case", list(VOTE_CASES))
def test_lcb_vote_matches_plain(cuda, case, retry):
    """K6 against its plain version (tests/torch_cases.py's VOTE_CASES:
    mid-phase lanes over a (CAP, W) grid with window overflows and lanes
    past CAP, rows repeated, out of order and invalid; the hand-laid
    tie-breaks, path rows, used slots and table end; a row that spills to
    the workspace, and 16 rows that take its 8 slices in turn; the
    300-copy repeat at CAP 512, W 256), with and without the used-retry:
    exact, one launch; only the spill cases' valid rows take the
    workspace."""
    got, spilled = vote_checked(case, retry)
    want = [1, 1, 0] * (len(spilled) // 3) if case.startswith("spill") else [0] * len(spilled)
    assert list(spilled) == want


@pytest.mark.parametrize("retry", [False, True])
def test_lcb_vote_spill_rows_wait_for_one_slice(cuda, monkeypatch, retry):
    """With the workspace's pool cut to one slice, the spilling rows take
    it in turn (a row waits while another holds it): exact, and each valid
    row through the workspace."""
    from sibeliaz_tpu_torch.lcb import kernels

    monkeypatch.setattr(kernels, "VOTE_POOL", 1)
    got, spilled = vote_checked("spill: 16 of 24 rows, more than the workspace's slices", retry)
    assert list(spilled) == [1, 1, 0] * 8


def test_lcb_vote_workspace_is_kept(cuda):
    """The spill workspace is allocated once a device and kept: a second
    spilling call takes the same tensor.  It holds the lock words and at
    most VOTE_POOL slices, whatever the rows of the call, and its lock
    words are zero after each call."""
    from sibeliaz_tpu_torch.lcb import kernels
    from sibeliaz_tpu_torch.utils import cudabuild

    kernels._WORKSPACE.clear()
    vote_checked("spill: 16 of 24 rows, more than the workspace's slices", False)
    ws = kernels._WORKSPACE[torch.device("cuda", torch.cuda.current_device())]
    words = cudabuild.load().sz_lcb_vote_workspace_words(16, 64, 64)
    assert ws.numel() == kernels._VOTE_LOCKS + kernels.VOTE_POOL * words
    vote_checked("spill: 2,496 vertices in a row", True)
    assert kernels._WORKSPACE[torch.device("cuda", torch.cuda.current_device())] is ws
    assert not ws[:kernels._VOTE_LOCKS].any()


def test_lcb_vote_refuses_bad_arguments(cuda):
    """A wrong dtype, tensors on two devices and a non-contiguous lane
    column are refused before any launch; nothing falls back."""
    import dataclasses

    from sibeliaz_tpu_torch.lcb import kernels

    tb, ln, rows, CAP, W, depth, b, n_max = vote_case("mid CAP 64 W 32", "cuda")
    idx, valid, forward, try_used = rows
    launches = kernels.LAUNCHES["lcb_vote"]
    with pytest.raises(ValueError, match="idx must be a contiguous torch.int64"):
        kernels.lcb_vote(CAP, W, tb, ln, idx.int(), valid, forward, try_used, depth, b)
    with pytest.raises(ValueError, match="forward must be a contiguous torch.bool"):
        kernels.lcb_vote(CAP, W, tb, ln, idx, valid, forward.long(), try_used, depth, b)
    with pytest.raises(ValueError, match="several devices"):
        kernels.lcb_vote(CAP, W, tb, ln, idx.cpu(), valid, forward, try_used, depth, b)
    strided = torch.empty(tuple(reversed(ln.chr.shape)), dtype=torch.int64, device="cuda").t()
    strided.copy_(ln.chr)
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="ln.chr must be a contiguous"):
        kernels.lcb_vote(CAP, W, tb, dataclasses.replace(ln, chr=strided), idx, valid, forward,
                         try_used, depth, b)
    bad_tb = dataclasses.replace(tb, jpos=tb.jpos.int())
    with pytest.raises(ValueError, match="tables.jpos must be"):
        kernels.lcb_vote(CAP, W, bad_tb, ln, idx, valid, forward, try_used, depth, b)
    assert kernels.LAUNCHES["lcb_vote"] == launches


def test_lcb_vote_on_the_tensors_device(cuda):
    """K6 on cuda:1 while cuda:0 is current: the plain version's outputs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    with torch.cuda.device(0):
        vote_checked("mid CAP 64 W 32", True, "cuda:1")


def test_lcb_vote_engines_never_run_the_plain_vote_on_the_card(cuda, monkeypatch):
    """Both device LCB engines on the card vote on the card alone: with the
    plain votes made to raise, a phase of 32 bundles through each engine
    gives eng.process's instance lists; the resident engine launches K6
    once a vote call, the fused engine K7 once a run (its blocks vote by
    K6's algorithm) and no K6."""
    from sibeliaz_tpu_torch.lcb import fused, kernels, resident

    def refuse(*args):
        raise AssertionError("the plain vote ran on the card")

    monkeypatch.setattr(kernels, "vote_plain", refuse)
    monkeypatch.setattr(kernels, "vote_retry_plain", refuse)
    eng = fused_case()
    bundles = make_bundles_device(eng.t, "cpu")[:32]
    want = [[(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]
            for insts in (eng.process(b) for b in bundles)]
    for fn, kernel, counter in ((fused.process_phase_fused, "lcb_step", "fused_runs"),
                                (resident.process_phase_resident, "lcb_vote",
                                 "resident_vote_calls")):
        launches = dict(kernels.LAUNCHES)
        metrics.counters.clear()
        got = fn(eng, bundles, device="cuda")
        assert [[(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]
                for insts in got] == want
        calls = metrics.counters[counter]
        assert kernels.LAUNCHES[kernel] - launches[kernel] == calls > 0
        if kernel == "lcb_step":
            assert kernels.LAUNCHES["lcb_vote"] == launches["lcb_vote"]


# ---- K7 lcb_step ----------------------------------------------------------------


# LaneSteps' rows that the plain version gives (the spill flag is the card's)
LANE_ROWS = [r for r in LaneSteps._fields[1:] if r != "spilled"]


def step_checked(tb_cpu, carry_cpu, tb, carry, a):
    """One K7 call on the card against the plain version on the CPU from
    the same carry: the state's 68 tensors and the 13 registers in every
    column, and each lane's steps, pushes, occurrence steps and the work
    of its steps, exact; one launch and no K5 or K6 launch; the carry
    stepped in place.  Returns (the card's LaneSteps, the plain
    version's)."""
    from sibeliaz_tpu_torch.lcb import kernels

    args = (a["CAP"], a["W"], a["slab_max"])
    rest = (a["depth"], a["m"], a["b"], a["flank"], a["min_run"], a["steps_limit"],
            a["walk_chunk"], a["compact_min"])
    want = kernels.lcb_step(*args, tb_cpu, carry_cpu, *rest)
    launches = dict(kernels.LAUNCHES)
    leaves = [carry[r] for r in kernels.CARRY_REGISTERS] + list(state_leaves(carry["st"]))
    got = kernels.lcb_step(*args, tb, carry, *rest)
    torch.cuda.synchronize(carry["active"].device)
    assert {k: kernels.LAUNCHES[k] - launches[k] for k in launches} == {
        "lcb_walk": 0, "lcb_vote": 0, "lcb_step": 1, "lcb_seed": 0}
    assert all(x is y for x, y in zip(
        [got.carry[r] for r in kernels.CARRY_REGISTERS] + list(state_leaves(got.carry["st"])),
        leaves))
    assert not state_diff(got.carry, want.carry)
    for name in LANE_ROWS:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    return got, want


def state_leaves(st):
    from sibeliaz_tpu_torch.lcb.batched_push_device import _state_leaves

    return _state_leaves(st)


@pytest.mark.parametrize("steps", [1, 2, 5, 20, "end"])
@pytest.mark.parametrize("tier", [(64, 32, 64, 128), (512, 16, 512, 1024)])
def test_lcb_step_cuda_matches_cpu(cuda, tier, steps):
    """K7 from the seeded lanes of 32 bundles, run 1, 2, 5 and 20 outer
    steps and to the phase's end, at the narrow and the wide tier: the
    plain version's carry and lane counts (step_checked)."""
    from sibeliaz_tpu_torch.lcb import fused, resident

    eng = fused_case()
    bundles = make_bundles_device(eng.t, "cpu")[:32]
    CAP, W, IC, PC = tier
    carries = {}
    for dev in ("cuda", "cpu"):
        tb = resident._device_tables(eng, dev)
        ln, _, ovf = resident._seed_lanes_device(tb, bundles, 32, IC, PC)
        active = (torch.arange(32, device=dev) < len(bundles)) & ~ovf
        carries[dev] = (tb, fused._init_carry(resident.seed_state(ln), active, 32))
    a = dict(CAP=CAP, W=W, slab_max=IC >= fused.I_CAP, depth=eng.depth, m=eng.m, b=eng.b,
             flank=eng.flank, min_run=eng.b * 2,
             steps_limit=fused.MAX_STEPS if steps == "end" else steps,
             walk_chunk=fused.WALK_CHUNK, compact_min=fused.COMPACT_MIN)
    got, _ = step_checked(*carries["cpu"], *carries["cuda"], a)
    if steps == "end":
        assert not bool(got.carry["active"].any()) and int(got.steps.max()) > 20
    else:
        assert bool(got.carry["active"].any()) and int(got.steps.max()) == steps


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_lcb_step_hand_laid_cuda_matches_cpu(cuda, name):
    """K7 on torch_cases' hand-laid K7 cases: the plain version's carry and
    lane counts, and what each case is laid for: the spilling vote (the
    lane's spill flag), lanes retiered by the vote cap, lanes to hostfb by
    a slab overflow, walks of many chunks, lanes still active at a limit
    of 3 steps, lanes run to their end at the widest tier (CAP 512, W 256,
    IC 512, PC 1024: the resident layout at its largest, two blocks an
    SM)."""
    tb_cpu, carry_cpu, a = step_case(name, "cpu")
    tb, carry, _ = step_case(name, "cuda")
    got, _ = step_checked(tb_cpu, carry_cpu, tb, carry, a)
    c = got.carry
    if name == "spill":
        assert int(got.spilled[0]) == 1
    elif name == "cap_overflow":
        assert bool(c["retier"].any())
    elif name == "slab_overflow":
        assert bool(c["hostfb"].any())
    elif name == "long_walks":
        assert int(got.pushes.max()) > 2 * a["walk_chunk"]
    elif name == "wide":
        from sibeliaz_tpu_torch.lcb import kernels

        assert c["st"].ln.chr.shape[1] == 512 and not bool(c["active"].any())
        assert kernels.step_blocks_per_sm(512, 1024, a["CAP"], a["W"])[0] == 2
    else:
        assert int(got.steps.max()) == 3 and bool(c["active"].any())


def test_lcb_step_counts_its_work_on_the_recorded_phase(cuda, monkeypatch):
    """examples/' first phase (256 bundles, k=15) through the fused engine
    on the card, its K7 runs recorded with their carries: on runs 1 and 2
    (tiers 0 and 1) K7's rows equal the host loop's on the card (the plain
    version, K6 and K5 a step) exactly; on run 2 the bytes that
    portbench/lib/k7_bound.py counts from the counters the run's read
    added equal chip_smoke.py's k7_bound's, which counts the host loop's
    calls (LoopTerms); the run's read is one host sync."""
    import os
    import sys

    from sibeliaz_tpu_torch.io import fasta
    from sibeliaz_tpu_torch.lcb import fused, step
    from sibeliaz_tpu_torch.lcb import kernels as lcb_kernels
    from sibeliaz_tpu_torch.lcb.oracle import LcbEngine

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke
    from portbench.lib import k7_bound

    recs = fasta.read_many([os.path.join(repo, "examples", f"genome{g}.fa") for g in (1, 2)])
    cfg = Config(k=15)
    table = pipeline.build_table([r.seq for r in recs], [r.name for r in recs], cfg,
                                 device="cuda")
    eng = LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking,
                    cfg.looking_depth)
    bundles = make_bundles_device(table, "cuda")[:256]
    deltas = []
    real_read = fused._LaneRun.read

    def read(run):
        before = dict(metrics.counters)
        real_read(run)
        deltas.append({k: v - before.get(k, 0) for k, v in metrics.counters.items()})

    monkeypatch.setattr(fused._LaneRun, "read", read)
    metrics.counters.clear()
    with chip_smoke.StepRecorder(lcb_kernels) as rec:
        fused.process_phase_fused(eng, bundles, device="cuda")
    assert len(rec.calls) == len(deltas) >= 2
    for q in (0, 1):
        args, got = rec.calls[q]
        CAP, W, slab_max, tb, before, *rest = args
        with chip_smoke.LoopTerms(torch, lcb_kernels) as terms:
            loop = step.lcb_step_plain(CAP, W, slab_max, tb,
                                       step.carry_map(lambda x: x.clone(), before), *rest)
        for name in LANE_ROWS:
            assert torch.equal(getattr(got, name), getattr(loop, name)), (q, name)
        assert deltas[q]["fused_host_syncs"] == 1
        walk, vote = terms.totals()
        w = k7_bound.work(deltas[q])
        assert (w["k7_pushes"], w["fused_lane_occ_steps"], w["k7_score_terms"], w["k7_voters"],
                w["k7_windows"], w["k7_slots"], w["k7_entries"]) == walk + vote
        if q == 1:
            assert before["st"].ln.chr.shape[1] == fused.I_CAP
            _, _, want = chip_smoke.k7_bound(args, got, walk, vote, 16.7e12)
            assert k7_bound.k7_bytes(w) == want > 0


def test_lcb_step_on_the_tensors_device(cuda):
    """K7 on cuda:1 while cuda:0 is current: the plain version's carry and
    lane counts (step_checked), at the narrow tier and at the widest."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    for name in ("long_walks", "wide"):
        tb_cpu, carry_cpu, a = step_case(name, "cpu")
        tb, carry, _ = step_case(name, "cuda:1")
        with torch.cuda.device(0):
            got, _ = step_checked(tb_cpu, carry_cpu, tb, carry, a)
        assert int(got.pushes.sum()) > 0


def test_lcb_step_refusals_on_the_card(cuda):
    """K7 steps the carry in place: a carry two of whose registers share
    storage, or a register of the wrong type, raises before the launch; so
    does a carry whose slabs (IC 2048, PC 2048) with the vote's region
    pass the 227 KB of shared memory a block may opt in to."""
    from sibeliaz_tpu_torch.lcb import kernels

    tb, carry, a = step_case("step_limit", "cuda")
    rest = (a["depth"], a["m"], a["b"], a["flank"], a["min_run"], a["steps_limit"],
            a["walk_chunk"], a["compact_min"])
    launches = kernels.LAUNCHES["lcb_step"]
    tier = (a["CAP"], a["W"], a["slab_max"], tb)
    with pytest.raises(ValueError, match="writes the carry in place"):
        kernels.lcb_step(*tier, dict(carry, retier=carry["hostfb"]), *rest)
    with pytest.raises(ValueError, match="stage"):
        kernels.lcb_step(*tier, dict(carry, stage=carry["stage"].int()), *rest)
    from sibeliaz_tpu_torch.lcb import fused, resident

    eng = fused_case()
    tb_wide = resident._device_tables(eng, "cuda")
    ln, _, _ = resident._seed_lanes_device(tb_wide, make_bundles_device(eng.t, "cpu")[:1], 8,
                                           2048, 2048)
    wide = fused._init_carry(resident.seed_state(ln), torch.ones(8, dtype=torch.bool,
                                                                  device="cuda"), 8)
    with pytest.raises(ValueError, match="a block may opt in to"):
        kernels.lcb_step(512, 32, True, tb_wide, wide, *rest)
    assert kernels.LAUNCHES["lcb_step"] == launches


# ---- K8 lcb_seed -------------------------------------------------------------


def seeded_on_card(eng, seeds, L, IC, PC):
    """K8 on the card (one launch, counted) into an allocation that held
    0xA5 in every byte (a column K8 did not write would show): (carry,
    ovf)."""
    from sibeliaz_tpu_torch.lcb import kernels, resident

    tb = resident._device_tables(eng, "cuda")
    with kernels._seed_pool(torch.device("cuda")):  # K8's outputs come from its own pool
        junk = torch.full((kernels.seed_plan(L, IC, PC).nbytes,), 0xA5, dtype=torch.uint8,
                          device="cuda")
    del junk  # the pool hands its block to K8's allocation
    launches = dict(kernels.LAUNCHES)
    got = kernels.lcb_seed(tb, seeds, L, IC, PC)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - launches[k] for k in launches} == {
        "lcb_walk": 0, "lcb_vote": 0, "lcb_step": 0, "lcb_seed": 1}
    return got


@pytest.mark.parametrize("name", sorted(SEED_CASES))
def test_lcb_seed_matches_plain(cuda, name):
    """K8 on the card against its plain version on the CPU from the same
    lanes and tables (tests/torch_cases.py's SEED_CASES: examples/large's
    first phase at IC 64 and 512, 8, 32, 200 and 256 lanes with padding,
    origins past IC 64, used slots): the carry's 81 tensors and the
    seed-overflow row bit for bit, in one launch; its outputs disjoint
    views of one allocation, which kernels.overlapping (K7's check)
    passes."""
    from sibeliaz_tpu_torch.lcb import kernels, resident

    eng, bundles, L, IC, PC, seeds = seed_case(name, "cuda")
    want, want_ovf = kernels.lcb_seed(resident._device_tables(eng, "cpu"), seeds, L, IC, PC)
    got, ovf = seeded_on_card(eng, seeds, L, IC, PC)
    assert not state_diff(got, want)
    assert torch.equal(ovf.cpu(), want_ovf)
    outs = state_leaves(got["st"]) + [got[r] for r in kernels.CARRY_REGISTERS] + [ovf]
    assert len({t.untyped_storage().data_ptr() for t in outs}) == 1
    assert kernels.overlapping(outs) is None
    if name in ("overflow", "lanes200"):
        assert bool(ovf.any())


def test_lcb_seed_into_kept_outputs(cuda):
    """K8 into outputs it wrote before (the engine keeps one a shape for a
    run), after K7 stepped that carry in place, for other lanes: the plain
    version's carry and overflow row for the new lanes, bit for bit, in
    the same tensors."""
    from sibeliaz_tpu_torch.lcb import fused, kernels, resident, step

    eng, bundles, L, IC, PC, seeds = seed_case("lanes32", "cuda")
    tb = resident._device_tables(eng, "cuda")
    kept = kernels.SeedOutputs(L, IC, PC, "cuda")
    first, _ = kernels.lcb_seed(tb, seeds[::-1], L, IC, PC, into=kept)
    ran = kernels.lcb_step(IC, 32, IC >= fused.I_CAP, tb, first, eng.depth, eng.m, eng.b,
                           eng.flank, eng.b * 2, fused.MAX_STEPS, fused.WALK_CHUNK,
                           fused.COMPACT_MIN)
    assert int(ran.pushes.sum()) > 0
    got, ovf = kernels.lcb_seed(tb, seeds[:12], L, IC, PC, into=kept)
    want, want_ovf = kernels.lcb_seed(resident._device_tables(eng, "cpu"), seeds[:12], L, IC, PC)
    torch.cuda.synchronize()
    assert not state_diff(got, want) and torch.equal(ovf.cpu(), want_ovf)
    assert all(x is y for x, y in zip(step.leaves(got), step.leaves(kept.carry)))
    assert ovf is kept.ovf


@pytest.mark.parametrize("name", ["large_narrow", "lanes32", "overflow"])
def test_lcb_step_from_k8_carry(cuda, name):
    """K7 run to its end from K8's carry and from the carry of the seeding
    K8 replaced (resident._seed_lanes_device, seed_state, init_carry), on
    the card, from the same lanes: the same carry and the same lane rows."""
    from sibeliaz_tpu_torch.lcb import fused, kernels, resident

    eng, bundles, L, IC, PC, seeds = seed_case(name, "cuda")
    tb = resident._device_tables(eng, "cuda")
    ln, _, ovf = resident._seed_lanes_device(tb, bundles, L, IC, PC)
    active = (torch.arange(L, device="cuda") < len(bundles)) & ~ovf
    old = fused._init_carry(resident.seed_state(ln), active, L)
    new, _ = seeded_on_card(eng, seeds, L, IC, PC)
    outs = [kernels.lcb_step(IC, 32, IC >= fused.I_CAP, tb, carry, eng.depth, eng.m, eng.b,
                             eng.flank, eng.b * 2, fused.MAX_STEPS, fused.WALK_CHUNK,
                             fused.COMPACT_MIN) for carry in (old, new)]
    torch.cuda.synchronize()
    assert not state_diff(outs[0].carry, outs[1].carry)
    for row in LaneSteps._fields[1:]:
        assert torch.equal(getattr(outs[0], row), getattr(outs[1], row)), row
    assert int(outs[1].pushes.sum()) > 0


def test_fused_seeding_is_one_copy_and_one_launch(cuda, monkeypatch):
    """Every seeding of a fused phase on the card (examples/' related
    genomes, the narrow tier overflowing into the wide one) queues one
    copy from the host and one K8 launch and nothing else on the card, and
    makes no host read (torch's sync debug mode raises on one); the
    phase's instances are eng.process's."""
    from torch.profiler import ProfilerActivity, profile

    from sibeliaz_tpu_torch.lcb import fused, kernels

    monkeypatch.setattr(fused, "SMALL_CAP", 3)
    eng = fused_case()
    bundles = make_bundles_device(eng.t, "cpu")[:32]
    real = kernels.lcb_seed
    seen = []

    def seed(*args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = real(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        seen.append([e.name() for e in prof.profiler.kineto_results.events()
                     if str(e.device_type()).endswith("CUDA")
                     and not getattr(e, "is_user_annotation", lambda: False)()])
        return out

    monkeypatch.setattr(kernels, "lcb_seed", seed)
    metrics.counters.clear()
    got = fused.process_phase_fused(eng, bundles, device="cuda")
    assert len(seen) == metrics.counters["fused_runs"] >= 2
    assert metrics.counters["fused_host_syncs"] == metrics.counters["fused_runs"]
    for names in seen:
        assert len(names) == 2, names
        assert sum(n.startswith("Memcpy HtoD") for n in names) == 1, names
        assert sum("lcb_seed_kernel" in n for n in names) == 1, names

    def keys(results):
        return [[(x.c, x.s, x.fi, x.bi, x.fdist, x.bdist, x.cmp, x.ffin, x.bfin) for x in insts]
                for insts in results]

    assert keys(got) == keys(eng.process(b) for b in bundles)
