"""K7 lcb_step's plain version: the fused LCB engine's outer step loop in
torch ops, below lcb/kernels.py (which routes a CPU call of `lcb_step`
here) and above K6 `lcb_vote` and K5 `lcb_walk`, whose wrappers each step
calls.

It also holds K8 lcb_seed's plain version (`lcb_seed_plain`): a lane set
seeded, and the carry `init_carry` makes of it.

One outer step (`phase_step`, the JAX package's fused.py::_phase_step):
one vote for every lane not mid-walk (with the forward-only used-retry,
one K6 call with `retry`) and up to `walk_chunk` walk pushes for every
mid-walk lane (one K5 call); the protocol registers (blocksfinder.h:
252-306) advance for lanes whose extend attempt completed, and a forward
sweep's end rewinds the live slab from the rewind slab.  `run_steps` is the
host loop over it (the JAX package's while_loop at fused.py:326): it reads
(the active lanes, their largest instance count) after every step, stops
when no lane is active or the step limit is reached, and, given
`compact_min`, gathers the active lanes into a smaller power-of-two lane
bucket once they are half the lanes or fewer (lanes never talk to each
other, so compaction is a permutation).  It keeps each lane's steps,
pushes and occurrence steps, and the work that K7 counts in its blocks:
the walks' score terms (a chunk's pushes times the lane's instance count
after it) and the votes' terms (vote.vote_terms), and whether the lane's
best score rose, and rose above 0.

The loop is device-agnostic: on CPU tensors K5's and K6's wrappers run
their plain versions, and `lcb_step_plain` is K7's plain version, the spec
the kernel is held to; on CUDA tensors they launch K5 and K6 once a step,
which is the host-loop route the fused engine took before K7
(`fused._phase_fused_seg`, chip_smoke.py's phases 16-18).  Every read of
the device adds one to `fused_host_syncs`, and the host's seconds blocked
in it to `fused_sync_wait_s`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sibeliaz_tpu_torch.lcb import kernels, vote
from sibeliaz_tpu_torch.lcb.batched_push_device import (
    BIG,
    LANE_FIELDS,
    ResidentState,
    _lanes_where,
    _state_from_leaves,
    _state_leaves,
    seed_state,
)
from sibeliaz_tpu_torch.lcb.kernels import CARRY_REGISTERS, LaneSteps
from sibeliaz_tpu_torch.lcb.resident import _seed_lanes_device_impl
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics


def fetch(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host: one counted host sync, and the seconds
    the host waits in it (`fused_sync_wait_s`: on the card, for the work
    queued before the copy and the copy)."""
    metrics.count("fused_host_syncs")
    t0 = time.perf_counter()
    out = t.cpu().numpy()
    metrics.count("fused_sync_wait_s", time.perf_counter() - t0)
    return out


def init_carry(st: ResidentState, active0, L: int):
    """The state machine's carry: the ResidentState, the protocol
    registers, the mid-walk registers that let a walk span outer steps,
    and the host's step count."""
    dev = active0.device

    def z(dtype=torch.int64):
        return torch.zeros(L, dtype=dtype, device=dev)

    return dict(
        st=st, stage=z(), positive=z(torch.bool), prev_len=z(), score=z(),
        active=active0, retier=z(torch.bool), hostfb=z(torch.bool),
        in_walk=z(torch.bool), wc=z(), wi=z(), ws=torch.ones(L, dtype=torch.int64, device=dev),
        wt=torch.full((L,), BIG, dtype=torch.int64, device=dev), wlast=z(torch.bool),
        steps=0,
    )


def lcb_seed_plain(tb, lanes, nb: int, IC: int, PC: int):
    """Plain PyTorch K8: a lane set seeded as the fused engine seeded it
    before K8, in torch ops on the device of `lanes` ([2, L] int64: the
    signed origin vids, 0 for an inert lane, and the out-chars):
    resident._seed_lanes_device_impl, seed_state and init_carry, the first
    nb lanes active unless their origin's occurrence count passes IC.
    Returns (carry, ovf [L] bool, the lanes whose count passes IC)."""
    L = lanes.shape[1]
    ln, _, ovf = _seed_lanes_device_impl(L, IC, PC, tb, lanes[0], lanes[1])
    active = (torch.arange(L, device=lanes.device) < nb) & ~ovf
    return init_carry(seed_state(ln), active, L), ovf


def phase_step(CAP: int, W: int, slab_max: bool, tb, carry, depth: int, m: int, b: int,
               flank: int, min_run: int, n_max, walk_chunk: int):
    """One outer step: one vote for every lane not mid-walk (+ the
    forward-only used-retry) and up to walk_chunk walk pushes for every
    mid-walk lane; the protocol registers (blocksfinder.h:252-306) advance
    for lanes whose extend attempt completed this step (the vote came back
    empty, or the walk reached its target).  `n_max` bounds the active
    lanes' instance counts (the votes' columns).  Returns the new carry,
    the walk chunk's Walk (its rows' pushes, occurrence steps and instance
    counts) and the vote's terms ([4, L], vote.vote_terms)."""
    st = carry["st"]
    stage, positive, prev_len = carry["stage"], carry["positive"], carry["prev_len"]
    score_reg, active, retier = carry["score"], carry["active"], carry["retier"]
    hostfb, in_walk = carry["hostfb"], carry["in_walk"]
    wc, wi, ws, wt, wlast = carry["wc"], carry["wi"], carry["ws"], carry["wt"], carry["wlast"]
    L = active.shape[0]
    rows = torch.arange(L, device=active.device)
    fwd = stage == 0

    # ---- vote (+ forward-only used-retry, blocksfinder.h:780-785), for
    # lanes not mid-walk ----
    voting = active & ~in_walk
    cap_ovf = voting & (st.ln.n > CAP)
    votable = voting & ~cap_ovf
    no_used = torch.zeros_like(votable)
    bvid, _, ochr, oidx, ostr, wovf = kernels.lcb_vote(
        CAP, W, tb, st.ln, rows, votable, fwd, no_used, depth, b, n_max, retry=True)
    votes = vote.vote_terms(CAP, W, tb, st.ln, rows, votable, fwd, no_used, depth, b, n_max,
                            retry=True)
    vote_ovf = cap_ovf | (votable & (wovf > 0))
    retier = retier | vote_ovf
    active = active & ~vote_ovf
    voted = votable & ~vote_ovf
    start_walk = voted & (bvid != 0)
    no_winner = voted & (bvid == 0)

    # fresh walks load their registers and join the walking set
    wc = torch.where(start_walk, ochr, wc)
    wi = torch.where(start_walk, oidx, wi)
    ws = torch.where(start_walk, ostr, ws)
    wt = torch.where(start_walk, bvid, wt)
    wlast = wlast & ~start_walk
    in_walk = (in_walk & active) | start_walk

    # ---- one chunk of walk pushes for every walking lane ----
    w = kernels.lcb_walk(tb, st, None, wc, wi, torch.where(in_walk, ws, 1), fwd,
                         torch.where(in_walk, wt, BIG), in_walk, wlast, m, b, flank, walk_chunk)
    st, wi, wlast, wscore, at_target = w.st, w.i, w.last, w.score, w.at_target
    push_ovf = in_walk & st.ln.overflow
    if slab_max:
        hostfb = hostfb | push_ovf
    else:  # narrow instance/path slab: replay from seed, wider tier
        retier = retier | push_ovf
    active = active & ~push_ovf
    walk_done = in_walk & at_target & ~push_ovf
    in_walk = in_walk & ~at_target & ~push_ovf
    score_reg = torch.where(walk_done, wscore, score_reg)
    ret = walk_done & wlast

    # ---- protocol registers (blocksfinder.h:252-306), applied only to
    # lanes whose extend attempt completed this step ----
    fin = no_winner | walk_done
    middle = st.ln.right_flank - st.ln.left_flank
    cont = ret & (middle - prev_len <= min_run)
    positive = positive | (fwd & cont & (score_reg > 0))
    brk = active & fin & ~cont
    outer_cont = torch.where(fwd, ret & positive, ret & (score_reg > 0))
    new_outer = brk & outer_cont
    prev_len = torch.where(new_outer, middle, prev_len)
    positive = positive & ~(new_outer & fwd)
    to_bwd = brk & ~outer_cont & fwd
    done = brk & ~outer_cont & ~fwd
    active = active & ~done

    # fwd -> bwd: best-prefix rewind as a masked slab restore
    st = ResidentState(ln=_lanes_where(to_bwd, st.rw, st.ln), rw=st.rw, sn=st.sn,
                       best_score=st.best_score, has_snap=st.has_snap)
    stage = torch.where(to_bwd, 1, stage)
    score_reg = torch.where(to_bwd, 0, score_reg)
    positive = positive & ~to_bwd
    prev_len = torch.where(to_bwd, st.ln.right_flank - st.ln.left_flank, prev_len)
    return dict(st=st, stage=stage, positive=positive, prev_len=prev_len, score=score_reg,
                active=active, retier=retier, hostfb=hostfb, in_walk=in_walk, wc=wc, wi=wi,
                ws=ws, wt=wt, wlast=wlast, steps=carry["steps"] + 1), w, votes


def read(carry):
    """(active lanes, their largest instance count): one fetch."""
    active = carry["active"]
    n = torch.where(active, carry["st"].ln.n, 0)
    return tuple(fetch(torch.stack([active.sum(), n.max()])).tolist())


def leaves(carry) -> list:
    """The carry's lane-leading tensors, in a fixed order."""
    return _state_leaves(carry["st"]) + [carry[r] for r in CARRY_REGISTERS]


def from_leaves(leaves, steps: int):
    n = 3 * len(LANE_FIELDS) + 2
    return dict(st=_state_from_leaves(leaves[:n]), steps=steps,
                **dict(zip(CARRY_REGISTERS, leaves[n:])))


def carry_map(fn, carry):
    """fn applied to every lane-leading tensor of a carry."""
    return from_leaves([fn(x) for x in leaves(carry)], carry["steps"])


def carry_fold(stash, carry, idx):
    """The full-size stash with rows idx replaced by the carry's first
    len(idx) rows (out of place)."""
    k = idx.shape[0]
    return from_leaves([f.index_copy(0, idx, p[:k])
                        for f, p in zip(leaves(stash), leaves(carry))], stash["steps"])


def run_steps(CAP: int, W: int, slab_max: bool, tb, carry, depth: int, m: int, b: int,
              flank: int, min_run: int, steps_limit: int, walk_chunk: int, compact_min=None,
              reading=None):
    """Advance the state machine until no lane is active or the carry's
    step count reaches steps_limit, reading the carry after every step
    (`reading`, where the caller has it, saves the first read).  With
    `compact_min`, once the active lanes are half the current lanes or
    fewer (and more than compact_min lanes step), they are gathered into a
    power-of-two bucket of at least compact_min lanes and stepping goes on
    there; finished lanes' terminal state is stashed full-size and the rows
    fold back at the end.  Returns (LaneSteps, reading, the step count):
    the LaneSteps' carry (in the original lane order) keeps the given
    `steps`; its counts are each lane's steps, pushes and occurrence steps,
    no spill (0), and the work of its steps (the walks' score terms, the
    votes' terms) and whether its best score rose, and rose above 0."""
    L = carry["active"].shape[0]
    dev = carry["active"].device
    # steps, pushes, occurrence steps, score terms, then vote_terms' four
    counts = torch.zeros((8, L), dtype=torch.int64, device=dev)
    best0 = carry["st"].best_score.clone()  # K5 on the card walks the state in place
    reading = reading or read(carry)
    cur, stash, gmap = carry, None, None  # gmap: current row -> original lane
    while reading[0] and cur["steps"] < steps_limit:
        was = cur["active"]
        cur, w, votes = phase_step(CAP, W, slab_max, tb, cur, depth, m, b, flank, min_run,
                                   reading[1], walk_chunk)
        add = torch.cat([torch.stack([was.long(), w.pushes, w.occ_steps, w.pushes * w.n]),
                         votes])
        if gmap is None:
            counts = counts + add
        else:
            counts = counts.index_add(1, gmap, add[:, :gmap.shape[0]])
        reading = read(cur)
        cur_L = cur["active"].shape[0]
        if (compact_min is None or not reading[0] or cur["steps"] >= steps_limit
                or cur_L <= compact_min or reading[0] > cur_L // 2):
            continue
        act = np.flatnonzero(fetch(cur["active"]))
        L2 = max(compact_min, 1 << max(0, len(act) - 1).bit_length())
        if L2 >= cur_L or not len(act):
            continue
        act_t = torch.from_numpy(act).to(dev)
        if stash is None:
            stash, gmap = cur, act_t
        else:
            # fold the current rows into the full-size stash, then narrow
            # the map to the still-active rows
            stash = carry_fold(stash, cur, gmap)
            gmap = gmap[act_t]
        idx_pad = torch.cat([act_t, torch.zeros(L2 - len(act), dtype=act_t.dtype, device=dev)])
        cur = carry_map(lambda x: x.index_select(0, idx_pad), cur)
        cur["active"] = cur["active"] & (torch.arange(L2, device=dev) < len(act))
        metrics.count("fused_compactions")
    steps = cur["steps"]
    if stash is not None:
        cur = carry_fold(stash, cur, gmap)
    out = dict(cur, steps=carry["steps"])
    best = out["st"].best_score
    rose = (counts[0] > 0) & (best > best0)
    return (LaneSteps(out, *counts[:3], torch.zeros_like(counts[0]), *counts[3:], rose.long(),
                      (rose & (best > 0)).long()), reading, steps)


def lcb_step_plain(CAP: int, W: int, slab_max: bool, tb, carry, depth: int, m: int, b: int,
                   flank: int, min_run: int, steps_limit: int, walk_chunk: int,
                   compact_min: int) -> LaneSteps:
    """Plain PyTorch K7: every lane of the carry stepped to its end or the
    step limit by the host loop, with compaction (run_steps); out of place,
    so the carry's slabs may share tensors.  Returns the LaneSteps."""
    return run_steps(CAP, W, slab_max, tb, carry, depth, m, b, flank, min_run, steps_limit,
                     walk_chunk, compact_min)[0]
