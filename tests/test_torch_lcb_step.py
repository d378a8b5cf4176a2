"""K7 lcb_step (lcb/kernels.py) on the CPU, through its plain version
(lcb/step.py's host loop): equal to the JAX package's `_phase_fused_seg`
from one bridged carry, the lanes' counts against the host loop's, the
step limit's lanes sent to the host oracle, the hand-laid cases showing
what they are laid for, and the wrapper's refusals.  The kernel itself is
held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 18)."""

import dataclasses

import numpy as np
import pytest
import torch

from sibeliaz_tpu_torch.lcb import fused, kernels, resident, step, vote
from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

from test_torch_fused_parts import NARROW, WIDE, jax_carry_after, nested, related
from torch_cases import STEP_CASES, state_diff, step_case


@pytest.fixture(autouse=True)
def one_thread():
    """Lane tensors here are small: one intra-op thread a test process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def lcb_step(tier, tb, carry, eng, limit, compact_min=fused.COMPACT_MIN):
    CAP, W, IC, _ = tier
    return kernels.lcb_step(CAP, W, IC >= fused.I_CAP, tb, carry, eng.depth, eng.m, eng.b,
                            eng.flank, eng.b * 2, limit, fused.WALK_CHUNK, compact_min)


@pytest.mark.parametrize("tier,start,steps", [(NARROW, 0, 1), (NARROW, 0, 5), (NARROW, 0, "end"),
                                              (NARROW, 2, 5), (WIDE, 0, 1), (WIDE, 0, 5),
                                              (WIDE, 0, "end")])
def test_lcb_step_matches_jax(tier, start, steps):
    """From the JAX package's seeded carry (after `start` steps), bridged,
    kernels.lcb_step on CPU tensors equals the JAX package's
    _phase_fused_seg at the same step limit: every field of the state and
    every register; the run's step count is the carry's plus the lanes'
    largest count.  Compaction runs down to 8 lanes."""
    eng, jeng = related()
    limit = fused.MAX_STEPS if steps == "end" else steps
    begin, _ = jax_carry_after(eng, jeng, tier, 32, start)
    want, _ = jax_carry_after(eng, jeng, tier, 32, limit)
    carry = fused.carry_from_numpy(nested(begin), "cpu")
    got = lcb_step(tier, resident._device_tables(eng, "cpu"), carry, eng, limit, compact_min=8)
    assert got.carry["steps"] == start
    assert start + int(got.steps.max()) == int(want["steps"])
    assert not state_diff(dict(got.carry, steps=int(want["steps"])), want)
    assert not bool(got.spilled.any())
    if steps == "end":
        assert not bool(got.carry["active"].any()) and int(want["steps"]) > 20
    else:
        assert bool(got.carry["active"].any())


def vote_lens(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max, retry):
    """A vote's window lengths (vote.window_lengths), a retried row's the
    longer of its two votes', the retried rows found by the first vote's
    plain version (as chip_smoke.py's vote_lens)."""
    lens = vote.window_lengths(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max)
    if retry:
        first = vote.vote_plain(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max)
        need = valid & forward & (first[0] == 0) & (first[5] == 0)
        again = vote.window_lengths(CAP, W, tb, ln, idx, need, forward, need, depth, b, n_max)
        lens = torch.where(need[:, None], lens.maximum(again), lens)
    return lens


@pytest.mark.parametrize("tier", [NARROW, WIDE])
def test_lane_counts_match_the_host_loop(monkeypatch, tier):
    """Each lane's steps are the steps it was active in, its pushes and
    occurrence steps those of the walk chunks' rows, summed; their largest
    step count is the host loop's, with compaction and without it.  The
    work rows are what the K5 and K6 calls give, counted as chip_smoke.py's
    LoopTerms counts them: score terms a chunk's pushes times the row's
    instance count; of the vote's window lengths, the voting instances,
    the windows, the evaluated slots and the alive entries; and a lane
    whose best score rose (above 0) stepped."""
    eng, jeng = related()
    begin, _ = jax_carry_after(eng, jeng, tier, 32, 0)
    tb = resident._device_tables(eng, "cpu")
    chunks, actives, votes = [], [], []
    real_walk, real_vote, real_step = kernels.lcb_walk, kernels.lcb_vote, step.phase_step

    def walk(*a):
        w = real_walk(*a)
        chunks.append(torch.stack([w.pushes, w.occ_steps, w.pushes * w.n]))
        return w

    def voted(CAP, W, tb_, ln, idx, valid, forward, try_used, depth, b, n_max=None,
              retry=False, spilled=None):
        lens = vote_lens(CAP, W, tb_, ln, idx, valid, forward, try_used, depth, b, n_max, retry)
        windows = lens >= 0
        row = torch.zeros((4, ln.n.shape[0]), dtype=torch.int64)
        row[:, idx] = torch.stack([(lens != -1).sum(dim=1), windows.sum(dim=1),
                                   torch.where(windows, (lens + 1).clamp(max=W), 0).sum(dim=1),
                                   torch.where(windows, lens, 0).sum(dim=1)])
        votes.append(row)
        return real_vote(CAP, W, tb_, ln, idx, valid, forward, try_used, depth, b, n_max,
                         retry=retry, spilled=spilled)

    def one_step(CAP, W, slab_max, tb_, carry, *rest):
        actives.append(carry["active"].clone())
        return real_step(CAP, W, slab_max, tb_, carry, *rest)

    monkeypatch.setattr(kernels, "lcb_walk", walk)
    monkeypatch.setattr(kernels, "lcb_vote", voted)
    monkeypatch.setattr(step, "phase_step", one_step)
    loop, _ = fused._phase_fused_seg(tier[0], tier[1], tier[2] >= fused.I_CAP, tb,
                                     fused.carry_from_numpy(nested(begin), "cpu"), eng.depth,
                                     eng.m, eng.b, eng.flank, eng.b * 2, fused.MAX_STEPS)
    want = torch.stack(chunks).sum(dim=0)
    want_votes = torch.stack(votes).sum(dim=0)
    steps = torch.stack(actives).long().sum(dim=0)
    assert len(chunks) == len(votes) == loop["steps"] > 20
    monkeypatch.setattr(kernels, "lcb_walk", real_walk)
    monkeypatch.setattr(kernels, "lcb_vote", real_vote)
    best0 = fused.carry_from_numpy(nested(begin), "cpu")["st"].best_score
    for compact_min in (8, 32):
        got = lcb_step(tier, tb, fused.carry_from_numpy(nested(begin), "cpu"), eng,
                       fused.MAX_STEPS, compact_min)
        assert int(got.steps.max()) == loop["steps"]
        assert torch.equal(got.steps, steps)
        assert torch.equal(got.pushes, want[0]) and torch.equal(got.occ_steps, want[1])
        assert torch.equal(got.score_terms, want[2])
        for r, name in enumerate(("voters", "windows", "slots", "entries")):
            assert torch.equal(getattr(got, name), want_votes[r]), name
        best = got.carry["st"].best_score
        rose = (steps > 0) & (best > best0)
        assert torch.equal(got.rose, rose.long())
        assert torch.equal(got.rose_positive, (rose & (best > 0)).long())
        assert int(got.rose_positive.sum()) > 0 and int(want_votes[3].sum()) > 0
        assert int(got.pushes.sum()) > 0 and not state_diff(dict(got.carry, steps=0),
                                                           dict(loop, steps=0))


def test_step_limit_sends_active_lanes_to_the_oracle(monkeypatch):
    """A run cut at MAX_STEPS: its one read finds the lanes still active
    and _finish sends them to hostfb (the host oracle), beside the lanes
    that hit a hard capacity; the run's steps are the limit."""
    monkeypatch.setattr(fused, "MAX_STEPS", 3)
    eng, _ = related()
    tier = (fused.SMALL_CAP, 32, 64, 128)
    tb = resident._device_tables(eng, "cpu")
    bundles = make_bundles_device(eng.t, "cpu")[:32]
    ln, _, ovf = resident._seed_lanes_device(tb, bundles, 32, 64, 128)
    seed_ovf = ovf.numpy()
    run = fused._LaneRun(eng, tier, tb, ln, seed_ovf, len(bundles))
    metrics.counters.clear()
    fused._lockstep([run])
    _, _, retier, hostfb, steps = fused._finish(run, seed_ovf, False)
    active = run.out.carry["active"].numpy()
    assert steps == 3 and active.any()
    assert np.array_equal(hostfb, active | run.out.carry["hostfb"].numpy())
    assert not (retier & active).any()
    counters = metrics.counters
    assert counters["fused_runs"] == 1 and counters["fused_host_syncs"] >= 1
    assert counters["fused_longest_steps"] == 3


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_hand_laid_cases_show_what_they_are_laid_for(monkeypatch, name):
    """Each hand-laid K7 case, through the plain version: lanes retiered
    by the vote cap, lanes to hostfb by a slab overflow, walks that span
    steps, lanes still active at the step limit, a lane whose first vote
    meets more vertices than K6's shared table holds, lanes run to their
    end at the widest tier."""
    tb, carry, a = step_case(name, "cpu")
    mid_walk = []
    real = step.phase_step

    def one_step(*args):
        out, w, votes = real(*args)
        mid_walk.append(bool((out["in_walk"] & out["active"]).any()))
        return out, w, votes

    monkeypatch.setattr(step, "phase_step", one_step)
    # the spill lane's first vote: the vertices its windows search
    vids, searched = vote.searched_slots(a["CAP"], a["W"], tb, carry["st"].ln, torch.arange(1),
                                         carry["active"][:1], torch.ones(1, dtype=torch.bool),
                                         torch.zeros(1, dtype=torch.bool), a["depth"], a["b"])
    got = kernels.lcb_step(a["CAP"], a["W"], a["slab_max"], tb, carry, a["depth"], a["m"],
                           a["b"], a["flank"], a["min_run"], a["steps_limit"], a["walk_chunk"],
                           a["compact_min"])
    c = got.carry
    if name == "spill":  # K6 spills past half its 2,048 shared slots
        assert len(torch.unique(vids[searched])) > 1024
        assert int(got.steps[0]) >= 2 and int(got.pushes[0]) > 0
    elif name == "cap_overflow":
        assert bool(c["retier"].any())
    elif name == "slab_overflow":
        assert bool(c["hostfb"].any())
    elif name == "long_walks":
        assert sum(mid_walk) >= 5 and int(got.pushes.max()) > 2 * a["walk_chunk"]
    elif name == "wide":
        assert (a["CAP"], a["W"], carry["st"].ln.chr.shape[1]) == (512, 256, 512)
        assert not bool(c["active"].any()) and int(got.pushes.sum()) > 0
        assert int(got.steps.max()) > 20
    else:
        assert int(got.steps.max()) == 3 and bool(c["active"].any())


def test_wrapper_refusals(monkeypatch):
    """lcb_step takes a carry of the fused engine's types and shapes on one
    device: a register of the wrong type or length, a slab of the wrong
    width, the meta device and tensors on two devices raise before any
    step; the overlap check the card's launch runs flags a carry whose
    registers share storage and passes init_carry's.  On the card's route
    (routed there by a stub, and the kernel library a stub: no card here),
    a shape whose resident slab and vote region the library refuses (past
    the 227 KB a block may opt in to) raises ValueError before the launch,
    and nothing falls back to the plain version."""
    tb, carry, a = step_case("step_limit", "cpu")
    args = (a["depth"], a["m"], a["b"], a["flank"], a["min_run"], 3, a["walk_chunk"],
            a["compact_min"])

    def call(c, tables=tb):
        return kernels.lcb_step(a["CAP"], a["W"], a["slab_max"], tables, c, *args)

    before = dict(kernels.LAUNCHES)
    for reg, bad in (("stage", carry["stage"].int()), ("active", carry["active"].long()),
                     ("wi", carry["wi"][:-1])):
        with pytest.raises(ValueError, match=reg):
            call(dict(carry, **{reg: bad}))
    st = carry["st"]
    narrow = dataclasses.replace(st, rw=dataclasses.replace(st.rw, chr=st.rw.chr[:, :-1]))
    with pytest.raises(ValueError, match="rw.chr"):
        call(dict(carry, st=narrow))
    meta = step.carry_map(lambda x: x.to("meta"), carry)
    meta_tb = type(tb)(**{f: getattr(tb, f).to("meta") for f in kernels.TABLE_FIELDS},
                       **{f: getattr(tb, f) for f in ("occ_ch", "occ_revch", "k")})
    with pytest.raises(ValueError, match="no kernel for device type 'meta'"):
        call(meta, meta_tb)
    with pytest.raises(ValueError, match="several devices"):
        call(dict(carry, wt=carry["wt"].to("meta")))
    assert kernels.LAUNCHES == before
    regs = [carry[r] for r in kernels.CARRY_REGISTERS]
    leaves = resident._state_leaves(carry["st"]) + regs
    assert kernels.overlapping(leaves) is None
    shared = dict(carry, retier=carry["hostfb"])
    pair = kernels.overlapping(resident._state_leaves(shared["st"])
                               + [shared[r] for r in kernels.CARRY_REGISTERS])
    n = len(resident._state_leaves(carry["st"]))
    assert pair == (n + kernels.CARRY_REGISTERS.index("retier"),
                    n + kernels.CARRY_REGISTERS.index("hostfb"))

    asked = []

    class Library:  # the kernel library refusing the shape, as past the opt-in
        def sz_lcb_step_workspace_words(self, *shape):
            asked.append(shape)
            return -1

    def launched(*args):
        raise AssertionError("launched")

    real = kernels._routed
    monkeypatch.setattr(kernels, "_routed",
                        lambda tb_, tensors, specs: (torch.device("cuda"), real(tb_, tensors,
                                                                                specs)[1]))
    monkeypatch.setattr(kernels.cudabuild, "load", lambda defines=(): Library())
    monkeypatch.setattr(kernels, "_launch_step", launched)
    monkeypatch.setattr(step, "lcb_step_plain", launched)
    with pytest.raises(ValueError, match="more than the 232,448 bytes a block may opt in to"):
        call(carry)
    assert asked == [(64, 128, a["CAP"], a["W"])]
    assert kernels.LAUNCHES == before
