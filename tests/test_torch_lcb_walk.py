"""K5 lcb_walk (lcb/kernels.py) on the CPU, through its plain version: the
per-lane independence the kernel's design rests on (the lockstep walk of
L lanes equals each lane walked alone), the engines' push counters, the
wrapper's routing, and inputs left as they were when the three slabs
share their tensors.  The kernel itself is held to the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 16)."""

import functools

import numpy as np
import pytest
import torch

from sibeliaz_tpu_torch import pipeline
from sibeliaz_tpu_torch.config import Config
from sibeliaz_tpu_torch.lcb import fused, kernels, resident
from sibeliaz_tpu_torch.lcb.oracle import LcbEngine
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from test_torch_fused_parts import related
from test_torch_resident import L, jax_walk, nested, seeded, vote_walks
from torch_cases import (repeat_genomes, state_arrays, state_diff, walk_args, walk_genomes,
                         walk_lanes, walk_tensors, with_sentinel_rows)

NARROW, WIDE = (64, 128), (fused.I_CAP, fused.P_CAP)
# case -> (genomes, slab widths, the walk's push limit)
CASES = {
    "narrow": ("related", NARROW, "WALK_CHUNK"),
    "wide": ("related", WIDE, "_MAX_WALK"),
    "bounded": ("related", NARROW, 2),
    "many_occurrences": ("repeat", WIDE, "_MAX_WALK"),
    "overflow": ("overflow", NARROW, "WALK_CHUNK"),
    "protocol": ("protocol", WIDE, "_MAX_WALK"),
}


@pytest.fixture(autouse=True)
def one_thread():
    """Lane tensors here are small: one intra-op thread a test process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def port_engine(kind):
    """The port's engine on the case's genomes: the related pair of the
    fused and resident tests, a 300-copy repeat (kept: the abundance
    threshold raised past it), or genomes where a walk outgrows the narrow
    slab (torch_cases.walk_genomes)."""
    if kind == "related":
        return related()[0]
    seqs, names = repeat_genomes(3, 300) if kind == "repeat" else walk_genomes(3)
    cfg = Config(k=15, abundance_threshold=1000)
    table = pipeline.build_table(seqs, names, cfg, device="cpu")
    return LcbEngine(table, cfg.min_block_size, cfg.max_branch_size, cfg.flanking)


@functools.lru_cache(maxsize=None)
def walk_case(case):
    """(engine, tables, state, walk tensors [rows, c, i, s, fwd, tvid], the
    push limit) of a case, with sentinel rows among the rows and lane L-1
    beside one.  `protocol` starts from the JAX package's seeded lanes after
    a round of forward votes and walks (rewind and result slabs apart from
    the live one, best scores set), with the winners of votes in mixed
    directions; the others from the port's seeded lanes (the three slabs
    one set of tensors), each lane walked 1 to 4 junctions on in a random
    direction."""
    genomes, (IC, PC), limit = CASES[case]
    rng = np.random.default_rng(11)
    if genomes == "protocol":
        eng, jeng = related()
        tb, jtb, jst = seeded(eng, jeng)
        jst = jax_walk(jeng, jtb, jst, vote_walks(jeng, jtb, jst, np.ones(L, bool)))[0]
        fwd = rng.random(L) < 0.5
        args = vote_walks(jeng, jtb, jst, fwd)
        if L - 1 not in args[0]:
            fwd[L - 1] = not fwd[L - 1]
            args = vote_walks(jeng, jtb, jst, fwd)
        st = resident.state_from_numpy(nested(jst), "cpu")
    else:
        eng = port_engine(genomes)
        tb, st, n_lanes = walk_lanes(eng, L, IC, PC, "cpu")
        args = walk_args(eng, st, n_lanes, rng)
        if genomes == "repeat":  # the last lanes' walks: each row alone costs ~0.3 s here
            args = [a[-8:] for a in args]
    args = with_sentinel_rows(args, L, rng)
    limit = getattr(fused if limit == "WALK_CHUNK" else resident, limit) \
        if isinstance(limit, str) else limit
    return eng, tb, st, walk_tensors(args, "cpu"), limit


def plain(case, q=slice(None)):
    """The plain walk of a case's rows q (all by default)."""
    eng, tb, st, (rows, c, i, s, fwd, tvid), limit = walk_case(case)
    on = torch.ones_like(fwd[q])
    return kernels.lcb_walk_plain(tb, st, rows[q], c[q], i[q], s[q], fwd[q], tvid[q], on, ~on,
                                  eng.m, eng.b, eng.flank, limit)


def lane_row(st, lane):
    return [x[lane] for x in resident._state_leaves(st)]


@pytest.mark.parametrize("case", list(CASES))
def test_lockstep_walk_equals_each_lane_walked_alone(case):
    """The lockstep walk of all rows, row by row, equals each row walked
    alone from the same state: its results, and its lane's every field in
    the live, rewind and result slabs and the best-score registers; lanes
    no row names are left as they were.  A sentinel's results are those of
    lane L-1 as it was.  At the narrow and the full slab widths, mixed
    directions, at WALK_CHUNK, at _MAX_WALK and at a limit of 2 pushes,
    pushes of a vertex with hundreds of occurrences, and lanes that
    overflow their slab mid-walk."""
    _, _, st, (rows, _, _, _, fwd, _), limit = walk_case(case)
    got = plain(case)
    for r in range(len(rows)):
        alone = plain(case, slice(r, r + 1))
        for name in kernels.Walk._fields[1:]:
            assert torch.equal(getattr(got, name)[r:r + 1], getattr(alone, name)), (r, name)
        lane = int(rows[r])
        if lane < L:
            for a, b in zip(lane_row(got.st, lane), lane_row(alone.st, lane)):
                assert torch.equal(a, b), (r, lane)
    named = set(rows.tolist())
    for lane in range(L):
        if lane not in named:
            for a, b in zip(lane_row(got.st, lane), lane_row(st, lane)):
                assert torch.equal(a, b), lane
    assert bool(fwd[rows < L].any()) and not bool(fwd[rows < L].all())
    assert int(got.pushes.max()) >= (1 if case == "protocol" else 2)
    assert bool(got.at_target.any())
    walked = got.pushes > 0
    if case == "bounded":
        assert bool(((got.pushes == limit) & ~got.at_target).any())
    if case == "many_occurrences":
        assert int(got.occ_steps[got.pushes == 1].max()) >= 200
    if case == "overflow":
        assert bool((got.overflow & walked).any()) and int(got.n.max()) == NARROW[0]
    else:
        assert not bool(got.overflow.any())
    if case == "protocol":
        assert int(got.last.sum()) >= 8


def count_pushes(monkeypatch):
    """Counts the calls of _push_score_snap, one a lockstep push."""
    calls = []
    real = kernels._push_score_snap

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(kernels, "_push_score_snap", counted)
    return calls


@pytest.mark.parametrize("case", ["wide", "many_occurrences"])
def test_resident_walk_counts(monkeypatch, case):
    """_walk_device counts `resident_pushes` as the lockstep loop's pushes,
    the largest row's count, and `resident_lane_occ_steps` as the sum of
    the rows' counts, each row's count that of the row walked alone; the
    call reads the device once."""
    eng, tb, st, (rows, c, i, s, fwd, tvid), _ = walk_case(case)
    alone = [plain(case, slice(r, r + 1)) for r in range(len(rows))]
    calls = count_pushes(monkeypatch)
    metrics.counters.clear()
    resident._walk_device(tb, st, rows, c, i, s, fwd, tvid, eng.m, eng.b, eng.flank)
    counters = metrics.counters
    assert counters["resident_pushes"] == len(calls) == max(int(w.pushes) for w in alone) >= 2
    assert counters["resident_lane_occ_steps"] == sum(int(w.occ_steps) for w in alone)
    assert counters["resident_host_syncs"] == 1


def test_fused_walk_counts(monkeypatch):
    """The fused engine's host loop (_phase_fused_seg) makes one walk
    chunk a step, whose lockstep pushes are its largest lane count, and
    counts `fused_lane_occ_steps` as the chunks' lanes' counts, summed
    (read once at the end); one read a step besides.  (`fused_pushes`, the
    chunks' lockstep pushes summed, went with K7, which steps each lane
    alone.)"""
    eng = port_engine("related")
    tb, st, n_lanes = walk_lanes(eng, L, *NARROW, "cpu")
    chunks = []
    real = kernels.lcb_walk

    def recorded(*a):
        w = real(*a)
        chunks.append((int(w.pushes.max()), int(w.occ_steps.sum())))
        return w

    monkeypatch.setattr(kernels, "lcb_walk", recorded)
    calls = count_pushes(monkeypatch)
    metrics.counters.clear()
    carry = fused._init_carry(st, torch.arange(L) < n_lanes, L)
    carry, _ = fused._phase_fused_seg(64, 32, False, tb, carry, eng.depth, eng.m, eng.b,
                                      eng.flank, eng.b * 2, 12)
    counters = metrics.counters
    assert carry["steps"] == len(chunks) == 12
    assert len(calls) == sum(p for p, _ in chunks) > 0
    assert counters["fused_lane_occ_steps"] == sum(o for _, o in chunks)
    assert counters["fused_host_syncs"] >= 13


def test_wrapper_routes_by_device():
    """CPU tensors run the plain version and launch nothing; tensors on
    the meta device, or on several devices, raise."""
    eng, tb, st, (rows, c, i, s, fwd, tvid), limit = walk_case("narrow")
    before = dict(kernels.LAUNCHES)
    on = torch.ones_like(fwd)
    got = kernels.lcb_walk(tb, st, rows, c, i, s, fwd, tvid, on, ~on, eng.m, eng.b, eng.flank,
                           limit)
    assert kernels.LAUNCHES == before
    assert not state_diff(got._asdict(), plain("narrow")._asdict())
    meta = [x.to("meta") for x in (rows, c, i, s, fwd, tvid, on)]
    meta_st = resident._state_from_leaves([x.to("meta") for x in resident._state_leaves(st)])
    meta_tb = type(tb)(**{f: getattr(tb, f).to("meta") for f in kernels.TABLE_FIELDS},
                       **{f: getattr(tb, f) for f in ("occ_ch", "occ_revch", "k")})
    with pytest.raises(ValueError, match="no kernel for device type 'meta'"):
        kernels.lcb_walk(meta_tb, meta_st, *meta[:6], meta[6], ~meta[6], eng.m, eng.b,
                         eng.flank, limit)
    with pytest.raises(ValueError, match="several devices"):
        kernels.lcb_walk(tb, meta_st, rows, c, i, s, fwd, tvid, on, ~on, eng.m, eng.b,
                         eng.flank, limit)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("case", ["narrow", "wide"])
def test_no_input_is_written(case):
    """With the live, rewind and result slabs one set of tensors (as both
    engines seed them), the walk leaves every input as it was and returns
    a state that shares no tensor with it."""
    _, _, st, _, _ = walk_case(case)
    assert st.ln is st.rw is st.sn
    before = state_arrays(st)
    got = plain(case)
    assert not state_diff(st, before)
    assert state_diff(got.st, st) and state_diff(got.st.rw, got.st.ln)
    ins = {id(x) for x in resident._state_leaves(st)}
    changed = {id(x) for x, y in zip(resident._state_leaves(got.st), resident._state_leaves(st))
               if not torch.equal(x, y)}
    assert changed and not changed & ins


def test_kernels_module_loads_no_engine():
    """lcb/kernels.py sits below both engines: importing it loads neither
    lcb.resident nor lcb.fused (what the plain walk needs lives in
    lcb/batched_push_device.py, which resident.py re-exports)."""
    import subprocess
    import sys

    code = ("import sys; import sibeliaz_tpu_torch.lcb.kernels; "
            "print(sorted(m for m in sys.modules if m.startswith('sibeliaz_tpu_torch.lcb.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = eval(out)
    assert "sibeliaz_tpu_torch.lcb.kernels" in loaded
    assert "sibeliaz_tpu_torch.lcb.resident" not in loaded
    assert "sibeliaz_tpu_torch.lcb.fused" not in loaded
    assert resident.ResidentState is kernels.ResidentState
    assert resident._push_score_snap is kernels._push_score_snap


def test_overlapping_flags_shared_storage():
    """The wrapper's host-side overlap check, from data pointers and sizes:
    it flags the slabs sharing their tensors (ln = rw = sn, and the seeding
    kernel's fi = bi = cmp within ln), an input overlapping a leaf and two
    leaves that are overlapping views of one buffer; it passes the engines'
    seeded state (`seed_state`), disjoint views of one buffer, and inputs
    that overlap only each other."""
    _, tb, st, (rows, c, *_), _ = walk_case("narrow")
    leaves = resident._state_leaves(st)
    n = len(kernels.LANE_FIELDS)

    def shared(state):
        got = kernels.overlapping(resident._state_leaves(state))
        return got and [resident._state_leaves(state)[q].data_ptr() for q in got]

    a, b = shared(st)
    assert a == b  # one tensor twice: rw and sn are ln, and fi is bi within it
    copies = [resident.DeviceLanes(*(x.clone() for x in leaves[q * n:(q + 1) * n]))
              for q in (1, 2)]
    a, b = shared(resident.ResidentState(st.ln, *copies, st.best_score, st.has_snap))
    assert a == b  # fi is bi, fdist is bdist within the seeding kernel's ln
    apart = resident.seed_state(st.ln)
    ok = resident._state_leaves(apart)
    assert kernels.overlapping(ok) is None
    assert kernels.overlapping(ok, [rows, c, c[1:], tb.jid]) is None
    assert kernels.overlapping(ok, [rows, ok[5][1:]]) == (5, len(ok) + 1)
    home = torch.zeros(2 * ok[0].numel(), dtype=torch.int64).view(2, *ok[0].shape)
    assert kernels.overlapping([home[0], home[1]]) is None
    assert kernels.overlapping([home[0], home.view(-1)[1:1 + ok[0].numel()]]) == (0, 1)
