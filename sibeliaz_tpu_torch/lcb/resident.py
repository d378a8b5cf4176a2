"""Resident device LCB engine (`--lcb-engine tpu`), and the snapshots,
vote, seeding and result decode that it shares with the fused engine
(lcb/fused.py), in torch ops.

The whole phase's lane state lives on one device:

  * `ResidentState` = current lanes + two snapshot slabs + best-score
    registers, seeded by `seed_state` with each tensor its own (K5 walks
    it in place on the card);
  * `_push_score_snap` applies PointPushBack + Score + best-snapshot and
    rewind-slab maintenance (copy-on-improve): K5's plain push step.  Both
    live in lcb/batched_push_device.py, below lcb/kernels.py, and are
    re-exported here;
  * the vote, MostPopularVertex over the lanes' instance slabs with
    per-lane direction and window overflow, is one call of K6 `lcb_vote`
    (lcb/kernels.py; its plain version `vote_plain` in lcb/vote.py, which
    the fused engine shares, re-exported here as `_vote_gathered`);
  * the reference's best-prefix rewind (blocksfinder.h:271-284) is a masked
    slab restore: replaying the successful-push prefix from the seed
    against the phase-frozen `used` snapshot reproduces the state at the
    improving push exactly, so snapshotting at each improvement IS the
    replay result;
  * the per-lane protocol (forward minRun sweeps, rewind, backward sweeps
    with the stray-';' semantics, blocksfinder.h:228-310) stays a host
    generator a lane (`_protocol`) that touches only mirror scalars; each
    round `process_phase_resident` gathers the lanes' requests into one
    vote call a tier, one walk call and one rewind call.

Lanes exceeding a capacity (instances I_CAP, path P_CAP, the last vote
tier's window) go to the host oracle for that bundle (`eng.process`): the
JAX package's capacity policy, not a device fallback.  The serial
validate/commit loop stays in LcbEngine.run.

A port of sibeliaz_tpu/lcb/resident.py.  How it differs:

  * a vote call (`_vote_round`) is one call of K6 `lcb_vote`: on the card
    one launch, a thread block a row; on the CPU its plain version
    (lcb/vote.py, where the port's sorts and scans stand for the JAX
    package's `jax.lax.sort` and `associative_scan`).  Where no entry
    votes the origin columns are unspecified in both packages (the caller
    reads them only under a winner);
  * `_walk_device` is one call of K5 `lcb_walk` (lcb/kernels.py, which
    the fused engine's walk chunks share) in place of a jitted
    `while_loop`: on the card one thread block walks each row, in place,
    with no read of the card between pushes; on the CPU its plain version, the
    lockstep host loop of torch ops, reads each push's (any lane active,
    the largest occurrence count) from the device.  The walk ends after
    `_MAX_WALK` pushes without a flag, as the JAX loop does.  It returns
    its per-row scalars on the host, read in one fetch with the rows' push
    counts.  It and `_rewind_rows` take `rows` with the sentinel L, as the
    JAX functions do; a sentinel reads lane L-1 and writes nothing back
    (`_rewind_rows` drops it onto a scratch row past the lanes,
    `mode="drop"`);
  * `process_phase_resident` and `run_resident` take the device ("cuda"
    unless the caller passes "cpu").  Nothing is compiled per shape, so
    the vote and walk rows are not padded to a power of two: each call
    takes exactly the lanes that asked, a vote's instance columns are cut
    to their largest count (`lcb_vote`'s `n_max`), and the host's
    arguments of a call go to the device in one copy.  Every read of the
    device is one fetch (a vote call's six results, a walk's six and its
    rows' push and occurrence-step counts, a rewind's three flank and
    count rows, the seed counts and flags); the
    result slabs come back through the compact fetch (`decode`), where the
    JAX engine fetches the whole slab;
  * what `SZ_RESIDENT_STATS` printed are `utils/metrics` counters:
    `resident_phases`, `resident_rounds`, `resident_vote_calls` (one a
    vote call, where the JAX engine counts rounds with votes),
    `resident_vote_retries` (lanes sent on to the last tier),
    `resident_vote_s`, `resident_walk_calls`, `resident_walk_s`,
    `resident_pushes` (a walk call's largest push count of a row, which
    is the lockstep loop's pushes), `resident_lane_occ_steps` (the rows'
    occurrence steps, summed: the pushed vertices' occurrence counts;
    the lockstep loop's steps, a push's largest count, cannot be rebuilt
    from the rows' counts and are not counted), `resident_rewind_s`,
    `resident_oracle_lanes` and `resident_host_syncs` (one a read of the
    device; the plain walk's own reads on the CPU are not counted); the
    seconds are the host's, and each ends in a read of the
    device, so each holds its device work;
  * `_device_tables` caches the tables on the engine, one copy a device;
  * `_seed_lanes_device` returns the seed counts and overflow flags on the
    device, for the caller to read in one fetch;
  * `_seed_lanes` (the host seeding of the fused lanes over a device list)
    takes the device its lanes go to;
  * `lanes_from_numpy` and `state_from_numpy` take lane state as numpy
    arrays (for example the JAX package's, fetched with np.asarray), so
    that tests can start both engines from one state.

Left out: `_push_round`, a jitted single-direction push round that nothing
calls (a grep of the JAX package, its tests and its benchmarks finds no
caller).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sibeliaz_tpu_torch.junctions.table import JunctionTable
from sibeliaz_tpu_torch.lcb.batched import seed_batch
from sibeliaz_tpu_torch.lcb import kernels
from sibeliaz_tpu_torch.lcb.batched_push_device import (  # noqa: F401 (re-exported)
    BIG,
    I_CAP,
    INSTANCE_FIELDS,
    LANE_FIELDS,
    P_CAP,
    DeviceLanes,
    DeviceTables,
    ResidentState,
    _clip,
    _lanes_where,
    _push_score_snap,
    _scatter_rows,
    _score_of,
    _state_from_leaves,
    _state_leaves,
    seed_state,
)
from sibeliaz_tpu_torch.lcb.oracle import Bundle, Instance, LcbEngine
from sibeliaz_tpu_torch.lcb.vote import vote_plain as _vote_gathered  # noqa: F401 (re-exported)
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

PHASE_LANES = 256
VOTE_TIERS = ((64, 16), (I_CAP, 16), (I_CAP, 256))  # (instance cap, window)
_MAX_WALK = 2048  # safety bound; walks are <= the vote window by design


def _fetch(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host: one counted host sync."""
    metrics.count("resident_host_syncs")
    return t.cpu().numpy()


def check_device(device, who: str) -> None:
    """Raise where `device` is a CUDA device and none is visible: nothing
    falls back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} on {device}: no CUDA device is visible; pass "
                           'device="cpu" to run the torch ops on the host')


# --------------------------------------------------------------------------
# walk round: one K5 call
# --------------------------------------------------------------------------


def _walk_device(tb: DeviceTables, st: ResidentState, rows, c, i0, s, fwd, tvid,
                 m: int, b: int, flank: int):
    """Walk each gathered lane from its vote origin to the winner: one K5
    call (lcb/kernels.py, its plain version on the CPU; at most _MAX_WALK
    pushes a lane), each push's edge from edge_of, the mixed-direction push
    + score + snapshot applied per push.  Returns the state and, per row,
    (last-push success, current score, n, right flank, left flank,
    overflow), on the host: the only scalars the host protocol needs
    (path-end vertices live in the rv/lv lane registers), fetched with the
    rows' push and occurrence-step counts in the call's one read.

    `rows` is [A] with sentinel L for padding (its lane is inert, its row
    dropped on the way back); (c, i0, s) is the vote's origin iterator,
    tvid the winning vertex (blocksfinder.h:770-895)."""
    w = kernels.lcb_walk(tb, st, rows, c, i0, s, fwd, tvid, torch.ones_like(fwd),
                         torch.zeros_like(fwd), m, b, flank, _MAX_WALK)
    h = _fetch(torch.stack([w.last.long(), w.score, w.n, w.right_flank, w.left_flank,
                            w.overflow.long(), w.pushes, w.occ_steps]))
    metrics.count("resident_pushes", int(h[6].max(initial=0)))
    metrics.count("resident_lane_occ_steps", int(h[7].sum()))
    last, score, n, rfl, lfl, ovf = (torch.from_numpy(x) for x in h[:6])
    return w.st, last.bool(), score, n, rfl, lfl, ovf.bool()


def _rewind_rows(st: ResidentState, rows) -> ResidentState:
    """Masked slab restore for the gathered lanes (sentinel rows dropped)."""
    take = _clip(rows, st.ln.chr.shape[0] - 1)
    ln = DeviceLanes(*(_scatter_rows(getattr(st.ln, f), rows,
                                     getattr(st.rw, f).index_select(0, take))
                       for f in LANE_FIELDS))
    return ResidentState(ln=ln, rw=st.rw, sn=st.sn, best_score=st.best_score,
                         has_snap=st.has_snap)


# --------------------------------------------------------------------------
# seeding: Path.Init for a phase, on the host (SeedBatch -> DeviceLanes)
# --------------------------------------------------------------------------


def _seed_lanes(table: JunctionTable, bundles: Sequence[Bundle], L: int, device
                ) -> Tuple[DeviceLanes, np.ndarray, np.ndarray]:
    """Build the phase's initial full-width lanes ([L, I_CAP] instances,
    [L, P_CAP] path) on the host and upload them to `device`.  Returns
    (lanes, n, overflow), the last two numpy: a lane whose seeded instance
    count passes I_CAP is flagged (its lane keeps the first I_CAP)."""
    sb = seed_batch(table, bundles)
    nb = len(bundles)
    cap = sb.chr.shape[1] if nb else 0
    ccap = min(cap, I_CAP)

    chr_ = np.full((L, I_CAP), -1, np.int64)
    s = np.zeros((L, I_CAP), np.int64)
    idx = np.zeros((L, I_CAP), np.int64)
    if nb:
        chr_[:nb, :ccap] = sb.chr[:, :ccap]
        s[:nb, :ccap] = sb.strand[:, :ccap]
        idx[:nb, :ccap] = sb.idx[:, :ccap]
    n = np.zeros(L, np.int64)
    n[:nb] = np.minimum(sb.n, I_CAP)
    overflow = np.zeros(L, bool)
    overflow[:nb] = sb.n > I_CAP
    col = np.arange(I_CAP, dtype=np.int64)[None, :]
    live = col < n[:, None]
    chr_ = np.where(live, chr_, -1)
    pvid = np.full((L, P_CAP), BIG, np.int64)
    origin_vid = np.zeros(L, np.int64)
    for lane, bd in enumerate(bundles):
        pvid[lane, 0] = bd.vid
        origin_vid[lane] = bd.vid
    pn = np.zeros(L, np.int64)
    pn[:nb] = 1
    zeros = np.zeros((L, I_CAP), np.int64)
    no = np.zeros((L, I_CAP), bool)
    zl = np.zeros(L, np.int64)
    host = dict(
        chr=chr_, s=np.where(live, s, 0), fi=np.where(live, idx, 0),
        bi=np.where(live, idx, 0), fdist=zeros, bdist=zeros, cmp=np.where(live, idx, 0),
        ffin=no, bfin=no, good_seq=np.full((L, I_CAP), -1, np.int64),
        insert_seq=np.where(live, col, 0), n=n, next_good=zl, next_insert=n, right_flank=zl,
        left_flank=zl, overflow=overflow, pvid=pvid, pdist=np.zeros((L, P_CAP), np.int64),
        pn=pn, rv=origin_vid, lv=origin_vid)
    # a copy a field: no two fields, and neither returned array, share memory
    ln = DeviceLanes(*(torch.from_numpy(host[f].copy()).to(device) for f in LANE_FIELDS))
    return ln, n, overflow


# --------------------------------------------------------------------------
# seeding: Path.Init for a phase, on the device
# --------------------------------------------------------------------------


def _seed_lanes_device_impl(L: int, IC: int, PC: int, tb: DeviceTables, vids, chs):
    """Vectorized Path.Init on the device: per lane, gather the origin
    vertex's occurrence window, apply the strand-aware used-slot and
    annotation-char filters, and left-compact the survivors.  vids[L]
    signed origin ids (0 = inert lane); chs[L] the bundle out-chars.
    Returns (DeviceLanes, n[L], overflow[L]); a lane whose occurrence COUNT
    exceeds the IC slab width is flagged overflow (a wider slab or the host
    oracle re-runs it)."""
    dev = vids.device
    v = vids.abs()
    lo = tb.occ_off[_clip(v, tb.occ_off.shape[0] - 2)]
    cnt = tb.occ_off[_clip(v + 1, tb.occ_off.shape[0] - 1)] - lo
    col = torch.arange(IC, device=dev)[None, :]
    in_occ = (col < cnt[:, None]) & (vids != 0)[:, None]
    rows = _clip(lo[:, None] + col, tb.occ_chr.shape[0] - 1)
    cs = tb.occ_chr[rows]
    is_ = tb.occ_idx[rows]
    flat = _clip(tb.chr_off[_clip(cs, tb.chr_off.shape[0] - 2)] + is_, tb.jid.shape[0] - 1)
    stored = tb.jid[flat]
    one = torch.ones_like(stored)
    s = torch.where(stored == vids[:, None], one, -one)
    # strand-aware used slot: + uses its own slot, - uses idx-1 (idx 0 on
    # the minus strand is never used)
    slot = torch.where(s > 0, flat, flat - 1)
    usable = ~((s > 0) | (is_ > 0)) | (tb.used[_clip(slot, tb.used.shape[0] - 1)] == 0)
    charv = torch.where(s > 0, tb.occ_ch[rows].long(), tb.occ_revch[rows].long())
    keep = in_occ & usable & (charv == chs[:, None])
    # left-compact survivors, preserving occurrence order (keys unique)
    order = torch.sort(torch.where(keep, col, IC + col), dim=1).indices
    cs2, is2, s2 = cs.gather(1, order), is_.gather(1, order), s.gather(1, order)
    n = keep.sum(dim=1)
    live = col < n[:, None]
    zero = torch.zeros((L, IC), dtype=torch.int64, device=dev)
    idx2 = torch.where(live, is2, 0)
    has = vids != 0
    pvid = torch.full((L, PC), BIG, dtype=torch.int64, device=dev)
    pvid = torch.cat([torch.where(has, vids, BIG)[:, None], pvid[:, 1:]], dim=1)
    origin = torch.where(has, vids, 0)
    nofin = torch.zeros((L, IC), dtype=torch.bool, device=dev)
    zl = torch.zeros(L, dtype=torch.int64, device=dev)
    ln = DeviceLanes(
        chr=torch.where(live, cs2, -1), s=torch.where(live, s2, 0), fi=idx2, bi=idx2,
        fdist=zero, bdist=zero, cmp=idx2, ffin=nofin, bfin=nofin,
        good_seq=torch.full((L, IC), -1, dtype=torch.int64, device=dev),
        insert_seq=torch.where(live, col, 0), n=n, next_good=zl, next_insert=n,
        right_flank=zl, left_flank=zl, overflow=torch.zeros(L, dtype=torch.bool, device=dev),
        pvid=pvid, pdist=torch.zeros((L, PC), dtype=torch.int64, device=dev),
        pn=has.long(), rv=origin, lv=origin,
    )
    return ln, n, cnt > IC


def _seed_lanes_device(tb: DeviceTables, bundles: Sequence[Bundle], L: int,
                       IC: int = I_CAP, PC: int = P_CAP):
    """Device seeding entry: ships two scalars per lane to the device.
    Returns (lanes, n, overflow), the last two on the device."""
    vids = np.zeros(L, np.int64)
    chs = np.zeros(L, np.int64)
    for i, bd in enumerate(bundles):
        vids[i] = bd.vid
        chs[i] = bd.ch
    dev = tb.jid.device
    return _seed_lanes_device_impl(L, IC, PC, tb, torch.from_numpy(vids).to(dev),
                                   torch.from_numpy(chs).to(dev))


# --------------------------------------------------------------------------
# tables, decode
# --------------------------------------------------------------------------


def _device_tables(eng: LcbEngine, device) -> DeviceTables:
    """DeviceTables cached on the engine, one copy for each device; only
    `used` and `used_pfx` change between phases (at commit time), so a
    later call for a device refreshes those of its copy.  "cuda" is the
    current card, so it shares that card's copy with "cuda:<index>"."""
    cache = eng.__dict__.setdefault("_fused_tb", {})
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in cache:
        tb = DeviceTables.build(eng.t, dev)
        cache[dev] = tb
        return tb
    tb = cache[dev]
    used_all = eng.t.used_flat
    # pad to the cached table's pow2 bucket (cumsum over trailing zeros
    # keeps the prefix's final value, so the pad rows stay semantics-free)
    n_pad = tb.used.shape[0]
    if len(used_all) < n_pad:
        used_all = np.concatenate([used_all, np.zeros(n_pad - len(used_all), np.uint8)])
    used, pfx = _used_prefix(torch.from_numpy(np.ascontiguousarray(used_all)).to(dev))
    tb = dataclasses.replace(tb, used=used, used_pfx=pfx)
    cache[dev] = tb
    return tb


def _used_prefix(used_u8):
    """The flags and their exclusive prefix sum (int64), on their device."""
    pfx = torch.cat([torch.zeros(1, dtype=torch.int64, device=used_u8.device),
                     used_u8.long().cumsum(0)])
    return used_u8, pfx


def _pad_pow2(m: int, lo: int = 8) -> int:
    return max(lo, 1 << (m - 1).bit_length()) if m > 1 else lo


_SNAP_FIELDS = ("chr", "s", "fi", "bi", "fdist", "bdist", "cmp", "ffin", "bfin",
                "good_seq", "n")
# the compact columns after the key: the instance fields an Instance takes
_COMPACT_FIELDS = INSTANCE_FIELDS[:9]


def snapshot_to_host(sn: DeviceLanes, fetch=None) -> Dict[str, np.ndarray]:
    """Fetch the result-slab fields needed to decode Instances, in one read
    (`fetch`, where given, is the caller's counted read)."""
    fetch = fetch or (lambda t: t.cpu().numpy())
    L, IC = sn.chr.shape
    fields = [getattr(sn, f).long() for f in _SNAP_FIELDS[:-1]]
    h = fetch(torch.stack(fields + [sn.n.long()[:, None].expand(L, IC)]))
    return {**{f: h[q] for q, f in enumerate(_SNAP_FIELDS[:-1])}, "n": h[-1, :, 0]}


def _snap_compact_impl(M_CAP: int, sn: DeviceLanes, want):
    """Compact the result slab's good-instance rows on the device.

    Returns (count, [10, M_CAP] columns: key, then the nine fields of
    _COMPACT_FIELDS) with rows sorted by key = lane*(IC+1)+good_seq, i.e.
    by (lane, good_seq): the host receives ~count*80 bytes instead of the
    full [L, IC] x 11 slab."""
    L, IC = sn.chr.shape
    dev = sn.chr.device
    col = torch.arange(IC, device=dev)[None, :]
    lane = torch.arange(L, device=dev)[:, None]
    good = want[:, None] & (col < sn.n[:, None]) & (sn.good_seq >= 0)
    count = good.sum()
    key = torch.where(good, lane * (IC + 1) + sn.good_seq, BIG).reshape(-1)
    key_s, perm = torch.sort(key, stable=True)
    cols = torch.stack([key_s[:M_CAP]] + [
        getattr(sn, f).long().reshape(-1)[perm[:M_CAP]] for f in _COMPACT_FIELDS])
    return count, cols


def instances_from_compact(sn: DeviceLanes, decode_rows, L: int, fetch=None
                           ) -> Optional[Dict[int, List[Instance]]]:
    """Decode the wanted lanes' Instance lists through the compact fetch;
    None if the compact buffer overflowed (the caller then fetches the full
    snapshot).  Returns {lane row -> [Instance]}.  `fetch` moves a tensor to
    a numpy array (the caller's counted host read)."""
    fetch = fetch or (lambda t: t.cpu().numpy())
    IC = sn.chr.shape[1]
    M_CAP = min(16 * L, L * IC)
    want = np.zeros(L, bool)
    want[decode_rows] = True
    count_t, cols_t = _snap_compact_impl(
        M_CAP, sn, torch.from_numpy(want).to(sn.chr.device))
    count = int(fetch(count_t))
    if count > M_CAP:
        return None
    cols = fetch(cols_t[:, :count])
    lanes = cols[0] // (IC + 1)
    out: Dict[int, List[Instance]] = {int(j): [] for j in decode_rows}
    for r in range(count):
        inst = Instance(int(cols[1][r]), int(cols[2][r]), 0, 0)
        inst.fi = int(cols[3][r])
        inst.bi = int(cols[4][r])
        inst.fdist = int(cols[5][r])
        inst.bdist = int(cols[6][r])
        inst.cmp = int(cols[7][r])
        inst.ffin = bool(cols[8][r])
        inst.bfin = bool(cols[9][r])
        out[int(lanes[r])].append(inst)
    return out


def instances_from_snapshot(h: Dict[str, np.ndarray], i: int) -> List[Instance]:
    """Decode lane i's result slab into the oracle's Instance list (good
    instances in good_seq order: the snapshot order of Path.good)."""
    ni = int(h["n"][i])
    gs = h["good_seq"][i][:ni]
    rows = np.flatnonzero(gs >= 0)
    rows = rows[np.argsort(gs[rows])]
    out: List[Instance] = []
    for q in rows:
        inst = Instance(int(h["chr"][i][q]), int(h["s"][i][q]), 0, 0)
        inst.fi = int(h["fi"][i][q])
        inst.bi = int(h["bi"][i][q])
        inst.fdist = int(h["fdist"][i][q])
        inst.bdist = int(h["bdist"][i][q])
        inst.cmp = int(h["cmp"][i][q])
        inst.ffin = bool(h["ffin"][i][q])
        inst.bfin = bool(h["bfin"][i][q])
        out.append(inst)
    return out


def decode(parts, want, fetch) -> Dict[int, List[Instance]]:
    """{lane -> instances} for the lanes where `want` is set, from the
    result slabs [(slab, its first lane, its lanes)]: a compact fetch a
    slab (~80 B per good instance instead of the full [lanes, IC] x 11
    slab), the full slab where the compact buffer overflows.  `fetch` is
    the caller's counted read."""
    out: Dict[int, List[Instance]] = {}
    for sn, lo, lanes in parts:
        rows = [int(j) for j in np.flatnonzero(want[lo:lo + lanes])]
        if not rows:
            continue
        comp = instances_from_compact(sn, rows, lanes, fetch)
        if comp is None:
            h = snapshot_to_host(sn, fetch)
            comp = {j: instances_from_snapshot(h, j) for j in rows}
        out.update((lo + j, insts) for j, insts in comp.items())
    return out


# --------------------------------------------------------------------------
# per-lane protocol generator (pure control flow; all path state on device)
# --------------------------------------------------------------------------


class _Lane:
    """Host-visible scalars of one lane, refreshed from device returns."""

    __slots__ = ("score", "right_flank", "left_flank", "n")

    def __init__(self, n: int) -> None:
        self.score = 0
        self.right_flank = 0
        self.left_flank = 0
        self.n = n


def _protocol(eng: LcbEngine, lane: _Lane):
    """Process() control flow; yields primitive requests.

    Requests: ("vote", forward, try_used) -> (vid, origin_it | None, cnt)
              ("walk", forward, origin_it, target_vid)
                  -> (success, score, right_flank, left_flank)
              ("rewind",) -> (right_flank, left_flank, score)

    The path itself (instances, end vertices, flanks, best snapshots) lives
    entirely on device; the generator only sequences vote/walk/rewind and
    applies the minRun/positivity rules (blocksfinder.h:228-310).  The
    oracle's mir.score-after-last-successful-push equals the lane's current
    score (failed pushes do not mutate), so the walk's returned score is
    exact."""
    min_run = eng.b * 2

    def middle_length():
        return lane.right_flank - lane.left_flank

    def extend(forward):
        vid, origin, _ = yield ("vote", forward, False)
        if forward and vid == 0:
            vid, origin, _ = yield ("vote", True, True)
        success = False
        if vid != 0:
            res = yield ("walk", forward, origin, vid)
            success, lane.score, lane.right_flank, lane.left_flank = res
        return success

    # forward sweep (blocksfinder.h:252-284)
    while True:
        positive = False
        prev_len = middle_length()
        while True:
            ret = yield from extend(True)
            if not (ret and middle_length() - prev_len <= min_run):
                break
            positive = positive or (lane.score > 0)
        if not ret or not positive:
            break
    # rewind to best prefix: device slab restore
    lane.right_flank, lane.left_flank, lane.score = yield ("rewind",)
    # backward sweep with the stray-';' semantics (blocksfinder.h:292-306)
    while True:
        prev_len = middle_length()
        while True:
            ret = yield from extend(False)
            if not (ret and middle_length() - prev_len <= min_run):
                break
        positive = lane.score > 0
        if not ret or not positive:
            break
    return None


# --------------------------------------------------------------------------
# phase driver
# --------------------------------------------------------------------------


def process_phase_resident(eng: LcbEngine, bundles: Sequence[Bundle], device="cuda"
                           ) -> List[List[Instance]]:
    """Explore every bundle of a phase with its lane state resident on
    `device`.  Each round gathers the lanes' pending requests: the votes
    go out in one call a tier (a window overflow retries at the last tier,
    and an overflow there sends the lane to the host oracle), the walks in
    one call, the rewinds in one call."""
    nb = len(bundles)
    if nb == 0:
        return []
    metrics.count("resident_phases")
    L = PHASE_LANES if nb > 32 else _pad_pow2(nb, 32)
    tb = _device_tables(eng, device)
    dev = tb.jid.device

    ln, n_t, ovf_t = _seed_lanes_device(tb, bundles, L)
    n_host, seed_ovf = _fetch(torch.stack([n_t, ovf_t.long()]))
    st = seed_state(ln)
    lanes = [_Lane(int(n_host[i])) for i in range(nb)]
    fallback = [bool(seed_ovf[i]) for i in range(nb)]
    gens: List[Optional[object]] = []
    pending: List[Optional[tuple]] = [None] * nb

    def start(i):
        if fallback[i]:
            gens.append(None)
            return
        g = _protocol(eng, lanes[i])
        gens.append(g)
        try:
            pending[i] = g.send(None)
        except StopIteration:
            gens[i] = None

    def resume(i, value):
        try:
            pending[i] = gens[i].send(value)
        except StopIteration:
            pending[i] = None
            gens[i] = None

    def kill(i):
        """Capacity overflow: abandon the lane, host oracle takes over."""
        fallback[i] = True
        pending[i] = None
        gens[i] = None

    def upload(*cols):
        """A call's host arguments as one [len(cols), A] int64 copy."""
        return torch.from_numpy(np.array(cols, np.int64).reshape(len(cols), -1)).to(dev)

    for i in range(nb):
        start(i)

    while any(g is not None for g in gens):
        metrics.count("resident_rounds")
        votes: List[int] = []
        walks: List[int] = []
        rewinds: List[int] = []
        for i, p in enumerate(pending):
            if p is None or gens[i] is None:
                continue
            if p[0] == "vote":
                votes.append(i)
            elif p[0] == "walk":
                walks.append(i)
            else:
                rewinds.append(i)

        # ---- votes: gathered read-only vote with tier escalation ----
        group = votes
        tier = 0
        t0 = time.perf_counter()
        while group:
            max_n = max(lanes[i].n for i in group)
            while VOTE_TIERS[tier][0] < max_n:
                tier += 1
            CAP, W = VOTE_TIERS[tier]
            idx, fwd, tu = upload(group, [pending[i][1] for i in group],
                                  [pending[i][2] for i in group])
            out = kernels.lcb_vote(CAP, W, tb, st.ln, idx, torch.ones_like(fwd, dtype=torch.bool),
                                   fwd.bool(), tu.bool(), eng.depth, eng.b, max_n)
            metrics.count("resident_vote_calls")
            bvid, bcnt, ochr, oidx, ostr, ovf = _fetch(torch.stack(out))
            retry: List[int] = []
            last = tier == len(VOTE_TIERS) - 1
            for j, i in enumerate(group):
                if ovf[j]:
                    if last:
                        kill(i)
                    else:
                        retry.append(i)
                elif bvid[j] == 0:
                    resume(i, (0, None, 0))
                else:
                    origin = (int(ochr[j]), int(oidx[j]), int(ostr[j]))
                    resume(i, (int(bvid[j]), origin, int(bcnt[j])))
            metrics.count("resident_vote_retries", len(retry))
            group = retry
            tier = len(VOTE_TIERS) - 1  # overflow: jump to the big window
        if votes:
            metrics.count("resident_vote_s", time.perf_counter() - t0)

        # ---- walks: one call, mixed directions ----
        if walks:
            t0 = time.perf_counter()
            req = [pending[i] for i in walks]
            rows, wc, wi, ws, wf, wt = upload(
                walks, *zip(*(p[2] for p in req)), [p[1] for p in req], [p[3] for p in req])
            st, *res = _walk_device(tb, st, rows, wc, wi, ws, wf.bool(), wt, eng.m, eng.b,
                                    eng.flank)
            last, score, n_w, rfl, lfl, ovf = (x.numpy() for x in res)
            for j, i in enumerate(walks):
                if ovf[j]:
                    kill(i)
                else:
                    lanes[i].n = int(n_w[j])
                    resume(i, (bool(last[j]), int(score[j]), int(rfl[j]), int(lfl[j])))
            metrics.count("resident_walk_calls")
            metrics.count("resident_walk_s", time.perf_counter() - t0)

        # ---- rewinds: masked slab restore ----
        if rewinds:
            t0 = time.perf_counter()
            rows = upload(rewinds)[0]
            st = _rewind_rows(st, rows)
            nn, rfl, lfl = _fetch(torch.stack([st.ln.n, st.ln.right_flank,
                                               st.ln.left_flank])[:, rows])
            for j, i in enumerate(rewinds):
                lanes[i].n = int(nn[j])
                resume(i, (int(rfl[j]), int(lfl[j]), 0))
            metrics.count("resident_rewind_s", time.perf_counter() - t0)

    # ---- collect results: the snapshot flags, then the compact fetch ----
    snap = _fetch(st.has_snap)[:nb] & ~np.array(fallback)
    decoded = decode([(st.sn, 0, L)], snap, _fetch)
    oracle = [i for i in range(nb) if fallback[i]]
    metrics.count("resident_oracle_lanes", len(oracle))
    return [eng.process(bundles[i]) if fallback[i] else decoded.get(i, []) for i in range(nb)]


def run_resident(eng: LcbEngine, device="cuda"):
    """Full LCB run with resident-device phase exploration on `device`."""
    from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device

    check_device(device, "run_resident")
    return eng.run(
        process_batch_fn=functools.partial(process_phase_resident, device=device),
        bundles=make_bundles_device(eng.t, device),
    )


# --------------------------------------------------------------------------
# state from numpy arrays (the JAX package's state, fetched as numpy)
# --------------------------------------------------------------------------


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a if a.dtype == bool else a.astype(np.int64)).to(device)


def lanes_from_numpy(fields, device="cuda") -> DeviceLanes:
    """DeviceLanes from a mapping of field name -> array."""
    return DeviceLanes(*(_tensor(fields[f], device) for f in LANE_FIELDS))


def state_from_numpy(fields, device="cuda") -> ResidentState:
    """A ResidentState from a mapping: "ln", "rw", "sn" -> lane-field
    mappings, "best_score", "has_snap" -> arrays."""
    return ResidentState(*(lanes_from_numpy(fields[q], device) for q in ("ln", "rw", "sn")),
                         best_score=_tensor(fields["best_score"], device),
                         has_snap=_tensor(fields["has_snap"], device))
