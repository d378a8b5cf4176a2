"""K6 lcb_vote's CPU path (lcb/kernels.py: on CPU tensors the plain version,
lcb/vote.py) against the JAX package's vote, sibeliaz_tpu/lcb/resident.py's
_vote_gathered (jitted there as _vote_round), exactly: all six outputs,
the origin columns where a winner exists (elsewhere both packages leave
them unspecified).  A mid-phase lane state after 12 fused steps (the
port's, which test_torch_fused_parts.py holds to the JAX package's carry),
every 7th junction used, over a (CAP, W) grid with window overflows and
lanes cut by n_max or past CAP;
hand-laid lanes whose winners turn on each tie-break, the path row, the
used test on both strands and the table's end; a row whose vertices
outgrow K6's shared hash table; the 300-copy repeat at W 256; and the
fused engine's used-retry (`retry=True`) against the JAX composition of
sibeliaz_tpu/lcb/fused.py:241-260.  The same cases run on the card in
tests/test_torch_cuda.py (K6 against this plain version)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sibeliaz_tpu.lcb import batched_push_device as jax_bpd
from sibeliaz_tpu.lcb import resident as jax_resident
from sibeliaz_tpu_torch.lcb import fused, kernels, resident, vote
from sibeliaz_tpu_torch.lcb.batched_push_device import LANE_FIELDS
from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device

from test_torch_fused_parts import NARROW, engines, related
from torch_cases import (VOTE_HAND, hand_laid_vote_case, repeat_genomes, spill_vote_case,
                         state_arrays, vote_rows)


@pytest.fixture(autouse=True)
def one_thread():
    """Lane tensors here are small: one intra-op thread a test process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_tables(fields, k):
    return jax_bpd.DeviceTables(**{f: jnp.asarray(v) for f, v in fields.items()}, k=k)


def jax_lanes(fields):
    return jax_bpd.DeviceLanes(**{f: jnp.asarray(fields[f]) for f in LANE_FIELDS})


def jax_vote(CAP, W, jtb, jln, rows, depth, b, retry=False):
    """The JAX package's vote on numpy rows; with `retry` the fused
    engine's composition (sibeliaz_tpu/lcb/fused.py:241-260), the second
    vote's count replacing the first's too."""
    idx, valid, forward, try_used = (jnp.asarray(x) for x in rows)
    depth, b = jnp.int64(depth), jnp.int64(b)
    first = jax_resident._vote_round(CAP, W, jtb, jln, idx, valid, forward, try_used, depth, b)
    first = [np.asarray(x).astype(np.int64) for x in first]
    if not retry:
        return first
    need = np.asarray(valid) & np.asarray(forward) & (first[0] == 0) & (first[5] == 0)
    again = jax_resident._vote_round(CAP, W, jtb, jln, idx, jnp.asarray(need), forward,
                                     jnp.asarray(need), depth, b)
    again = [np.asarray(x).astype(np.int64) for x in again]
    out = [np.where(need, y, x) for x, y in zip(first[:5], again[:5])]
    return out + [first[5] | (need & (again[5] > 0))]


def port_vote(CAP, W, tb, ln, rows, depth, b, n_max=None, retry=False):
    """kernels.lcb_vote on CPU tensors: no launch."""
    before = dict(kernels.LAUNCHES)
    got = kernels.lcb_vote(CAP, W, tb, ln, *(torch.from_numpy(np.asarray(x)) for x in rows),
                           depth, b, n_max, retry=retry)
    assert kernels.LAUNCHES == before
    return [x.numpy() for x in got]


def assert_same_vote(got, want):
    """Six outputs equal; the origin columns where a winner exists."""
    for a, w in zip(got[:2] + got[5:], want[:2] + want[5:]):
        assert np.array_equal(a, w)
    win = want[0] != 0
    for a, w in zip(got[2:5], want[2:5]):
        assert np.array_equal(a[win], w[win])
    return win


@functools.lru_cache(maxsize=None)
def mid_phase():
    """The port's and the JAX package's tables (every 7th junction used)
    and one lane state, after 12 fused steps of the related genomes' first
    32 bundles at the narrow tier (the port's steps, which
    test_torch_fused_parts.py holds to the JAX package's carry)."""
    eng, jeng = related()
    eng.t.used_flat[::7] = 1
    jeng.t.used_flat[::7] = 1
    tb = resident._device_tables(eng, "cpu")
    CAP, W, IC, PC = NARROW
    ln, _, ovf = resident._seed_lanes_device(tb, make_bundles_device(eng.t, "cpu")[:32], 32, IC,
                                             PC)
    carry = fused._init_carry(resident.seed_state(ln), ~ovf, 32)
    carry, _ = fused._phase_fused_seg(CAP, W, False, tb, carry, eng.depth, eng.m, eng.b,
                                      eng.flank, eng.b * 2, 12)
    ln = carry["st"].ln
    return eng, tb, ln, jax_resident._device_tables(jeng), jax_lanes(state_arrays(ln))


@pytest.mark.parametrize("CAP,W", [(64, 32), (2, 4), (16, 256), (64, 3)])
def test_vote_matches_jax_mid_phase(CAP, W):
    """Mixed directions and try_used, 48 rows over 32 lanes out of order,
    repeated and a fifth invalid; W 4 and 3 overflow windows, CAP 2 and 16
    leave lanes with n > CAP; and the same call with the columns cut to
    the valid rows' largest count (n_max), as the engines call it."""
    eng, tb, ln, jtb, jln = mid_phase()
    rows = vote_rows(np.random.default_rng(CAP + W), 32, 48)
    want = jax_vote(CAP, W, jtb, jln, rows, eng.depth, eng.b)
    n_max = int(ln.n.numpy()[rows[0][rows[1]]].max())
    for cut in (None, n_max):
        win = assert_same_vote(port_vote(CAP, W, tb, ln, rows, eng.depth, eng.b, cut), want)
        assert win.sum() >= 8
    if W < 8:
        assert want[5].any()
    if CAP == 2:
        assert (ln.n.numpy()[rows[0][rows[1]]] > CAP).any()


@pytest.mark.parametrize("retry", [False, True])
def test_vote_hand_laid_matches_jax(retry):
    """The hand-laid lanes (torch_cases.hand_laid_vote_case), each row's
    winner as laid: the count, its final entry the later arrival; a count
    tie broken by the origin key, then by the arrival; a path row sorted
    past pn with entries that are not BIG; the used slot of a minus-strand
    step (flat - 1) stopping a window unless try_used, and none read at
    index 0; a window leaving the last chromosome; good instances only;
    order sequences outside [0, 2^40), which K6 ranks.  With `retry` the
    forward rows with no winner vote again with try_used."""
    fields, lane_fields, rows = hand_laid_vote_case()
    CAP, W, depth, b, k = (VOTE_HAND[x] for x in ("CAP", "W", "depth", "b", "k"))
    tb = fused.tables_from_numpy(fields, k, "cpu")
    ln = resident.lanes_from_numpy(lane_fields, "cpu")
    want = jax_vote(CAP, W, jax_tables(fields, k), jax_lanes(lane_fields), rows, depth, b, retry)
    got = port_vote(CAP, W, tb, ln, rows, depth, b, retry=retry)
    assert_same_vote(got, want)
    # the rows of lanes 0-8, forward, as the case lays them out, then the
    # others (hand_laid_vote_case's idx)
    n = 9
    assert list(got[0][:n]) == [201, 211, 221, 231, 0, -412 if retry else 0, 421, 241, 201]
    assert list(got[1][:n]) == [2, 1, 1, 1, 0, 1 if retry else 0, 1, 1, 2]
    origin = [(got[2][r], got[3][r], got[4][r]) for r in (0, 8)]
    assert origin == [(0, 5, 1), (1, 5, 1)]  # the later arrival's instance
    assert got[5][n + 2] == 1 and got[0][n + 3] == -412  # lane 5 backward overflows; try_used


def test_vote_spill_case_matches_jax():
    """A row meeting 2,496 distinct vertices (more than K6's shared table
    holds; it takes the workspace route on the card), forward and
    backward, and an invalid row."""
    fields, lane_fields, rows, W = spill_vote_case()
    tb = fused.tables_from_numpy(fields, 15, "cpu")
    ln = resident.lanes_from_numpy(lane_fields, "cpu")
    want = jax_vote(64, W, jax_tables(fields, 15), jax_lanes(lane_fields), rows, 64, 10_000)
    assert_same_vote(port_vote(64, W, tb, ln, rows, 64, 10_000), want)
    assert list(want[0]) == [5001, 5039, 0]
    w = vote._windows(64, W, tb, ln, *(torch.from_numpy(x) for x in rows), 64, 10_000, None)
    distinct = len(set(w["vid"][0][w["alive"][0]].tolist()))
    assert distinct == 64 * 39


def test_vote_repeat_matches_jax():
    """The 300-copy repeat's bundle at the last tier (CAP 512, W 256):
    300 voting instances, 2,568 alive entries forward (372 vertices),
    both directions, with retry."""
    eng, jeng = engines(*repeat_genomes(3, 300), abundance=1000)
    bundles = [bd for bd in make_bundles_device(eng.t, "cpu") if bd.count == 300]
    tb = resident._device_tables(eng, "cpu")
    ln, n, _ = resident._seed_lanes_device(tb, bundles, 2, 512, 1024)
    assert int(n[0]) == 300
    jtb = jax_resident._device_tables(jeng)
    jln = jax_lanes(state_arrays(ln))
    rows = (np.zeros(3, np.int64), np.ones(3, bool), np.array([True, False, True]),
            np.array([False, False, True]))
    for retry in (False, True):
        want = jax_vote(512, 256, jtb, jln, rows, eng.depth, eng.b, retry)
        got = port_vote(512, 256, tb, ln, rows, eng.depth, eng.b, 300, retry)
        assert assert_same_vote(got, want).all()
    lengths = vote.window_lengths(512, 256, tb, ln, *(torch.from_numpy(x) for x in rows),
                                  eng.depth, eng.b)
    assert int((lengths[0] >= 0).sum()) == 300 and int(lengths[0].clamp(min=0).sum()) == 2568


def test_vote_retry_matches_jax_mid_phase():
    """`retry=True` on the mid-phase state at the fused engine's narrow
    tier, as _phase_step calls it (try_used all false, every lane a row,
    a third not voting): the JAX composition's outputs; some rows
    retried."""
    eng, tb, ln, jtb, jln = mid_phase()
    rng = np.random.default_rng(3)
    rows = (np.arange(32, dtype=np.int64), rng.random(32) < 0.67, rng.random(32) < 0.7,
            np.zeros(32, bool))
    want = jax_vote(64, 32, jtb, jln, rows, eng.depth, eng.b, retry=True)
    first = jax_vote(64, 32, jtb, jln, rows, eng.depth, eng.b)
    assert_same_vote(port_vote(64, 32, tb, ln, rows, eng.depth, eng.b, retry=True), want)
    assert (want[0] != first[0]).any()


def test_vote_routes_by_device():
    """CPU tensors run the plain version and launch nothing; tensors on
    the meta device, or on several devices, raise; resident._vote_gathered
    is the plain version (re-exported)."""
    eng, tb, ln, _, _ = mid_phase()
    rows = [torch.from_numpy(x) for x in vote_rows(np.random.default_rng(1), 32, 8)]
    before = dict(kernels.LAUNCHES)
    got = kernels.lcb_vote(64, 32, tb, ln, *rows, eng.depth, eng.b)
    want = vote.vote_plain(64, 32, tb, ln, *rows, eng.depth, eng.b)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert resident._vote_gathered is vote.vote_plain
    meta = [x.to("meta") for x in rows]
    meta_ln = type(ln)(*(getattr(ln, f).to("meta") for f in LANE_FIELDS))
    meta_tb = type(tb)(**{f: getattr(tb, f).to("meta") for f in kernels.TABLE_FIELDS},
                       **{f: getattr(tb, f) for f in ("occ_ch", "occ_revch", "k")})
    with pytest.raises(ValueError, match="no kernel for device type 'meta'"):
        kernels.lcb_vote(64, 32, meta_tb, meta_ln, *meta, eng.depth, eng.b)
    with pytest.raises(ValueError, match="several devices"):
        kernels.lcb_vote(64, 32, tb, meta_ln, *rows, eng.depth, eng.b)
    with pytest.raises(ValueError, match="several devices"):
        kernels.lcb_vote(64, 32, tb, ln, rows[0], meta[1], *rows[2:], eng.depth, eng.b)
    assert kernels.LAUNCHES == before
