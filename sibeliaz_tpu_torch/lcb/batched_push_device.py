"""Lane state and PointPushBack/Front over a batch of lanes, in torch ops
(the fused LCB engine's tables, lane slabs and push).

Lane state lives in padded [lanes, IC] tensors (instances sorted by the
(chr, cmp) key) plus a sorted (vid -> distance) path-membership table of
width PC.  One call applies push_back (fwd[l]) or push_front to every
valid lane l:

  * membership test + path-table insert: per-lane searchsorted + masked
    shift,
  * a host loop over the occurrence index j (the reference processes a
    vertex's occurrences in order, and later steps observe earlier
    mutations, so j is the sequential axis and lanes the vector axis),
  * per step: upper_bound by searchsorted, the Within test, the
    strand-dependent candidate pick, the compatibility test with
    used-between as a range query over the phase-frozen used prefix sums,
    the branch-bound adjacency escape, and either an in-place ChangeBack or
    a masked-shift insert.

On the card the walk's pushes run inside K5 `lcb_walk` (lcb/kernels.py,
csrc/lcb_walk.cu); `_push_impl_traced` is the push of K5's plain version,
the CPU path and the spec the kernel is held to.

How it differs from sibeliaz_tpu/lcb/batched_push_device.py: the tables
and lanes are plain dataclasses of tensors on one device (no pytree
registration); `DeviceTables.build` takes the device; the occurrence loop's
bound is a host int that the caller read from the card (the JAX package's
traced `fori_loop` bound); the complement table is built once per device.
Every op here is out of place, so lane tensors may be shared between
slabs; K5's kernel walks the state in place, so the engines seed the three
slabs as tensors of their own (`seed_state`).  Below the push: the lane
state both device engines keep (`ResidentState`, its leaves, the row
scatter) and K5's plain push step (`_push_score_snap`, `_score_of`), here
so that lcb/kernels.py imports no engine.
Left out: the host LaneState round trip (`from_host`, `to_host`,
`_pad_lanes`, `_run_push`, `push_*_batch_device`), the test-only slices
that lead to it (ROADMAP "Do not port"), and `I_CAP`'s module
(`lcb/batched_push.py`): its constant is copied here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sibeliaz_tpu_torch.junctions.table import JunctionTable
from sibeliaz_tpu_torch.lcb.oracle import NEG_INF_SCORE

I_CAP = 512  # instances per lane (sibeliaz_tpu/lcb/batched_push.py:30)
P_CAP = 1024  # path vertices per lane
BIG = 1 << 60


def _padded(a: np.ndarray, fill, lo: int = 1024) -> np.ndarray:
    """Pad a 1-D array to the next power-of-two length (min `lo`)."""
    n = len(a)
    m = lo if n <= 1 else max(lo, 1 << (n - 1).bit_length())
    if m == n:
        return a
    out = np.full(m, fill, a.dtype)
    out[:n] = a
    return out


@dataclasses.dataclass
class DeviceTables:
    """Flat device copies of the junction table + phase-frozen used prefix.

    Every flat array is padded to a power-of-two bucket (the JAX package's
    compile-cache buckets, kept so that both engines see identical tables):
    offset-style arrays pad with their last value, data arrays with 0 or
    'N'.  Every consumer clips its indices to the padded length."""

    chr_off: torch.Tensor  # [n_chr+1]
    chr_len: torch.Tensor  # [n_chr]
    jpos: torch.Tensor  # [total]
    jid: torch.Tensor  # [total]
    used_pfx: torch.Tensor  # [total+1] exclusive prefix of used flags
    used: torch.Tensor  # [total] uint8, the frozen flags themselves
    seq_off: torch.Tensor  # [n_chr+1]
    seq: torch.Tensor  # [sum len] uint8
    occ_off: torch.Tensor  # [V+1]
    occ_chr: torch.Tensor
    occ_idx: torch.Tensor
    occ_ch: torch.Tensor  # [n_occ] uint8 annotation char (+ strand)
    occ_revch: torch.Tensor  # [n_occ] uint8 annotation char (- strand)
    k: int

    @classmethod
    def build(cls, table: JunctionTable, device="cuda") -> "DeviceTables":
        chr_off = table.chr_off
        used_all = table.used_flat
        pfx = np.zeros(len(used_all) + 1, np.int64)
        np.cumsum(used_all, out=pfx[1:])
        seq_off = table.seq_off

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(
            chr_off=put(_padded(chr_off, chr_off[-1], lo=4)),
            chr_len=put(_padded(np.diff(chr_off), 0, lo=4)),
            jpos=put(_padded(table.jpos_flat, 0)),
            jid=put(_padded(table.jid_flat, 0)),
            used_pfx=put(_padded(pfx, pfx[-1])),
            used=put(_padded(used_all, 0)),
            seq_off=put(_padded(seq_off, seq_off[-1], lo=4)),
            seq=put(_padded(table.seq_flat, ord("N"))),
            occ_off=put(_padded(table.occ_off.astype(np.int64), table.occ_off[-1])),
            occ_chr=put(_padded(table.occ_chr.astype(np.int64), 0)),
            occ_idx=put(_padded(table.occ_idx.astype(np.int64), 0)),
            occ_ch=put(_padded(table.occ_ch, 0)),
            occ_revch=put(_padded(table.occ_revch, 0)),
            k=table.k,
        )


# instance-slab fields [L, IC], then per-lane registers [L], then the path
# table [L, PC], in the JAX package's field order
INSTANCE_FIELDS = ("chr", "s", "fi", "bi", "fdist", "bdist", "cmp", "ffin", "bfin",
                   "good_seq", "insert_seq")
LANE_FIELDS = INSTANCE_FIELDS + (
    "n", "next_good", "next_insert", "right_flank", "left_flank", "overflow",
    "pvid", "pdist", "pn", "rv", "lv")


@dataclasses.dataclass
class DeviceLanes:
    """Batched lane state on one device (instance slabs + path table)."""

    chr: torch.Tensor  # [L, IC] int64, -1 pad (sorted with cmp key)
    s: torch.Tensor  # [L, IC] int64 (+-1)
    fi: torch.Tensor
    bi: torch.Tensor
    fdist: torch.Tensor
    bdist: torch.Tensor
    cmp: torch.Tensor
    ffin: torch.Tensor  # bool
    bfin: torch.Tensor  # bool
    good_seq: torch.Tensor  # int64, -1 = not good
    insert_seq: torch.Tensor
    n: torch.Tensor  # [L]
    next_good: torch.Tensor  # [L]
    next_insert: torch.Tensor  # [L]
    right_flank: torch.Tensor  # [L]
    left_flank: torch.Tensor  # [L]
    overflow: torch.Tensor  # [L] bool
    pvid: torch.Tensor  # [L, PC] int64 sorted, BIG pad
    pdist: torch.Tensor  # [L, PC] int64
    pn: torch.Tensor  # [L]
    # path-end vertex registers (oracle.py Path.right_vertex/left_vertex):
    # updated on successful pushes, snapshotted/restored with the slab
    rv: torch.Tensor  # [L] int64 signed vid at the path's right end
    lv: torch.Tensor  # [L] int64 signed vid at the path's left end


_COMP_TBL = np.array(
    [0] * 65 + [ord("T")] + [0] * 1 + [ord("G")] + [0] * 3
    + [ord("C")] + [0] * 12 + [ord("A")] + [0] * 171,
    dtype=np.int64,
)
_COMP_ON = {}


def comp_table(device) -> torch.Tensor:
    """The 256-entry complement table (0 for non-ACGT), once per device."""
    key = str(torch.device(device))
    if key not in _COMP_ON:
        _COMP_ON[key] = torch.from_numpy(_COMP_TBL).to(device)
    return _COMP_ON[key]


def _clip(x, hi):
    return x.clamp(0, max(hi, 0))


def edge_of(tb: DeviceTables, c, i, s, fwd):
    """Twin of LcbEngine.out_edge/in_edge (oracle.py:180-208;
    junctionstorage.h:191-227): the edge at iterator (chr c, idx i, strand
    s) in direction fwd, as (u, v, ch, rev, length) int64 vectors.  All
    inputs are [L] vectors; out-of-range neighbor indices are clipped (the
    caller only uses rows whose walk is in range, exactly like the
    reference only builds edges between consecutive junctions)."""
    nj = tb.jid.shape[0] - 1
    base = tb.chr_off[_clip(c, tb.chr_off.shape[0] - 2)]
    nbr = torch.where(fwd, i + s, i - s)  # the other junction of the edge
    idx_self = _clip(base + i, nj)
    idx_nbr = _clip(base + nbr, nj)
    id_self = tb.jid[idx_self]
    id_nbr = tb.jid[idx_nbr]
    u = torch.where(fwd, s * id_self, s * id_nbr)
    v = torch.where(fwd, s * id_nbr, s * id_self)
    p_self = tb.jpos[idx_self]
    p_nbr = tb.jpos[idx_nbr]
    length = (p_nbr - p_self).abs()
    p_start = torch.where(fwd, p_self, p_nbr)  # the edge's start junction
    p_end = torch.where(fwd, p_nbr, p_self)
    sq_off = tb.seq_off[_clip(c, tb.seq_off.shape[0] - 2)]
    sq_len = tb.seq_off[_clip(c + 1, tb.seq_off.shape[0] - 1)] - sq_off
    tbl = comp_table(c.device)

    def byte_at(p):
        return tb.seq[_clip(sq_off + p, tb.seq.shape[0] - 1)].long()

    def comp_at(p):  # complement(seq[p-1]), 'N' at the chromosome edge
        cb = tbl[byte_at(p - 1)]
        return torch.where((p > 0) & (cb > 0), cb, ord("N"))

    zero = torch.zeros_like(p_start)
    # label char: + strand reads the start junction's successor byte,
    # - strand the complement of its predecessor (oracle.py:180-208)
    ch = torch.where(
        s > 0,
        torch.where(p_start + tb.k < sq_len, byte_at(p_start + tb.k), zero),
        comp_at(p_start),
    )
    # rc label: + strand reads complement at the end junction; - strand
    # reads seq[p_self + k] in BOTH directions (the oracle/reference read
    # it at the iterator itself: out_edge's start, in_edge's end)
    rev = torch.where(
        s > 0,
        comp_at(p_end),
        torch.where(p_self + tb.k < sq_len, byte_at(p_self + tb.k), zero),
    )
    return u, v, ch, rev, length


def _row_insert(arr, p, val):
    """Insert val at column p of every row (shift right); arr is [..., L,
    CAP], p [L], val [..., L]."""
    col = torch.arange(arr.shape[-1], device=arr.device)
    shifted = torch.cat([arr[..., :1], arr[..., :-1]], dim=-1)
    pc = p[:, None]
    return torch.where(col < pc, arr, torch.where(col == pc, val[..., None], shifted))


def _searchsorted(rows, q, right=False):
    """Per-row searchsorted: rows [L, C] sorted, q [L] -> [L]."""
    return torch.searchsorted(rows.contiguous(), q[:, None].contiguous(), right=right)[:, 0]


def _push_impl_traced(max_occ: int, fwd, tb: DeviceTables, ln: DeviceLanes,
                      eu, ev, ech, elen, evalid, m: int, b: int):
    """Apply push_back (fwd[l]=True) or push_front per lane, mixed in one
    call.  Direction differences (pushed vertex = edge end vs start,
    distance sign, candidate polarity, compatibility endpoint roles, which
    end of the instance mutates) are selects.  `max_occ` bounds the
    occurrence loop: the largest occurrence count of a valid lane's pushed
    vertex (steps past a lane's own count are inert)."""
    L, IC = ln.chr.shape
    PC = ln.pvid.shape[1]  # path-slab width (tiered; P_CAP is the max)
    dev = ln.chr.device
    col = torch.arange(IC, device=dev)[None, :]
    vtx = torch.where(fwd, ev, eu)

    # ---- membership + path-table insert ----
    pp = _searchsorted(ln.pvid, vtx)
    at_pp = ln.pvid.gather(1, _clip(pp, PC - 1)[:, None])[:, 0]
    member = (at_pp == vtx) & (pp < ln.pn)
    success = evalid & ~member & ~ln.overflow
    dval = torch.where(fwd, ln.right_flank + elen, ln.left_flank - elen)
    path = _row_insert(torch.stack([ln.pvid, ln.pdist]), pp, torch.stack([vtx, dval]))
    path = torch.where(success[:, None], path, torch.stack([ln.pvid, ln.pdist]))
    pvid, pdist = path[0], path[1]
    pn = torch.where(success, ln.pn + 1, ln.pn)
    poverflow = ln.overflow | (success & (ln.pn >= PC - 1))

    av = vtx.abs()
    occ_lo = tb.occ_off[_clip(av, tb.occ_off.shape[0] - 2)]
    occ_cnt = tb.occ_off[_clip(av + 1, tb.occ_off.shape[0] - 1)] - occ_lo

    st = {f: getattr(ln, f) for f in INSTANCE_FIELDS}
    st.update(n=ln.n, next_good=ln.next_good, next_insert=ln.next_insert,
              overflow=poverflow)
    one = torch.ones_like(vtx)
    tbl = comp_table(dev)
    nj, npfx, nseq = tb.jid.shape[0] - 1, tb.used_pfx.shape[0] - 1, tb.seq.shape[0] - 1
    n_off = tb.chr_off.shape[0] - 2
    k = tb.k

    for j in range(max_occ):
        act = success & (j < occ_cnt) & ~st["overflow"]
        oi = _clip(occ_lo + j, tb.occ_chr.shape[0] - 1)
        c = tb.occ_chr[oi]
        i = tb.occ_idx[oi]
        base = tb.chr_off[_clip(c, n_off)]
        stored = tb.jid[_clip(base + i, nj)]
        s_ = torch.where(stored == vtx, one, -one)

        keys = torch.where(col < st["n"][:, None], (st["chr"] << 40) | st["cmp"], BIG)
        kq = (c << 40) | i
        p = _searchsorted(keys, kq, right=True)

        def gather(f, q):
            return st[f].gather(1, _clip(q, IC - 1)[:, None])[:, 0]

        in_chr = (p < st["n"]) & (gather("chr", p) == c)
        fi_p, bi_p = gather("fi", p), gather("bi", p)
        within = in_chr & (torch.minimum(fi_p, bi_p) <= i) & (i <= torch.maximum(fi_p, bi_p))

        use_prev = torch.where(fwd, s_ > 0, s_ < 0)
        cand = torch.where(use_prev, p - 1, p)
        prev_ok = (p - 1 >= 0) & (gather("chr", p - 1) == c)
        cand_ok = torch.where(use_prev, prev_ok, in_chr)

        # ---- compatibility ----
        cc = gather("chr", cand)
        cs = gather("s", cand)
        # cand's mutable end: back on forward pushes, front on backward
        cend = torch.where(fwd, gather("bi", cand), gather("fi", cand))
        same_strand = cs == s_
        # strand-aware used-slot range between start and end iterators
        # forward: start = cand.back, end = seq_it; backward: swapped
        start_i = torch.where(fwd, cend, i)
        end_i = torch.where(fwd, i, cend)
        lo_slot = torch.where(s_ > 0, start_i, end_i)
        hi_slot = torch.where(s_ > 0, end_i, start_i)
        cbase = tb.chr_off[_clip(cc, n_off)]
        qlo = _clip(cbase + lo_slot, npfx)
        qhi = _clip(cbase + hi_slot, npfx)
        used_between = (hi_slot > lo_slot) & (tb.used_pfx[qhi] - tb.used_pfx[qlo] > 0)
        kshift = torch.where(s_ < 0, k, 0)
        pos_start = tb.jpos[_clip(cbase + start_i, nj)] + kshift
        pos_end = tb.jpos[_clip(cbase + end_i, nj)] + kshift
        real_diff = pos_end - pos_start
        # ancestral diff = dist[end.vid] - dist[start.vid]
        cvid = cs * tb.jid[_clip(cbase + cend, nj)]
        cp = _searchsorted(pvid, cvid)
        cdist = pdist.gather(1, _clip(cp, PC - 1)[:, None])[:, 0]
        anc_diff = torch.where(fwd, dval - cdist, cdist - dval)
        dir_ok = torch.where(s_ > 0, real_diff >= 0, -real_diff >= 0)
        over = (real_diff.abs() > b) | (anc_diff > b)
        # adjacency escape: start.Next() == end, chars match, next vid == ev
        nxt_i = start_i + s_
        nxt_valid = (nxt_i >= 0) & (nxt_i < tb.chr_len[_clip(cc, tb.chr_len.shape[0] - 1)])
        spos_abs = tb.jpos[_clip(cbase + start_i, nj)]
        sq_off = tb.seq_off[_clip(cc, tb.seq_off.shape[0] - 2)]
        sq_len = tb.seq_off[_clip(cc + 1, tb.seq_off.shape[0] - 1)] - sq_off
        ch_plus = torch.where(spos_abs + k < sq_len,
                              tb.seq[_clip(sq_off + spos_abs + k, nseq)].long(), 0)
        prev_comp = tbl[tb.seq[_clip(sq_off + spos_abs - 1, nseq)].long()]
        ch_minus = torch.where((spos_abs > 0) & (prev_comp > 0), prev_comp, ord("N"))
        start_char = torch.where(s_ > 0, ch_plus, ch_minus)
        nvid = s_ * tb.jid[_clip(cbase + nxt_i.clamp(min=0), nj)]
        end_is_next = nxt_i == end_i
        escape = nxt_valid & (start_char == ech) & end_is_next & (nvid == ev)
        compat = cand_ok & same_strand & ~used_between & dir_ok & (~over | escape)

        do_update = act & ~within & compat & (cvid != vtx)
        cfin = torch.where(fwd, gather("bfin", cand), gather("ffin", cand))
        do_change = do_update & ~cfin
        uslot = torch.where(s_ > 0, base + i, base + i - 1)
        u = ((s_ > 0) | (i > 0)) & (tb.used[_clip(uslot, tb.used.shape[0] - 1)] > 0)

        c_other = torch.where(fwd, gather("fi", cand), gather("bi", cand))
        jp_other = tb.jpos[_clip(cbase + c_other, nj)]
        jp_end_old = tb.jpos[_clip(cbase + cend, nj)]
        was_good = (jp_other - jp_end_old).abs() >= m
        jp_end_new = tb.jpos[_clip(base + i, nj)]
        now_good = (jp_other - jp_end_new).abs() >= m

        at_cand = col == _clip(cand, IC - 1)[:, None]

        def set_at(f, val, mask):
            return torch.where(at_cand & mask[:, None], val[:, None], st[f])

        st["bi"] = set_at("bi", i, do_change & fwd)
        st["bdist"] = set_at("bdist", dval, do_change & fwd)
        st["fi"] = set_at("fi", i, do_change & ~fwd)
        st["fdist"] = set_at("fdist", dval, do_change & ~fwd)
        cmp_strand = torch.where(fwd, cs > 0, cs < 0)
        st["cmp"] = set_at("cmp", i, do_change & cmp_strand)
        newly_good = do_change & ~was_good & now_good
        st["good_seq"] = set_at("good_seq", st["next_good"], newly_good)
        st["next_good"] = torch.where(newly_good, st["next_good"] + 1, st["next_good"])
        true = torch.ones_like(success)
        st["bfin"] = set_at("bfin", true, do_change & u & fwd)
        st["ffin"] = set_at("ffin", true, do_change & u & ~fwd)

        do_insert = act & ~within & ~u & ~(compat & (cvid != vtx))
        room = st["n"] < IC
        ins = do_insert & room
        st["overflow"] = st["overflow"] | (do_insert & ~room)
        # the instance fields, stacked: one masked shift inserts them all
        slab = torch.stack([st[f].long() for f in INSTANCE_FIELDS])
        vals = torch.stack([c, s_, i, i, dval, dval, i, torch.zeros_like(i),
                            torch.zeros_like(i), -one, st["next_insert"]])
        slab = torch.where(ins[:, None], _row_insert(slab, p, vals), slab)
        for f, row in zip(INSTANCE_FIELDS, slab.unbind(0)):
            st[f] = row.bool() if f in ("ffin", "bfin") else row
        st["n"] = torch.where(ins, st["n"] + 1, st["n"])
        st["next_insert"] = torch.where(ins, st["next_insert"] + 1, st["next_insert"])

    out = DeviceLanes(
        **{f: st[f] for f in INSTANCE_FIELDS},
        n=st["n"], next_good=st["next_good"], next_insert=st["next_insert"],
        right_flank=torch.where(success & fwd, dval, ln.right_flank),
        left_flank=torch.where(success & ~fwd, dval, ln.left_flank),
        overflow=st["overflow"], pvid=pvid, pdist=pdist, pn=pn,
        rv=torch.where(success & fwd, ev, ln.rv),
        lv=torch.where(success & ~fwd, eu, ln.lv),
    )
    return out, success


# --------------------------------------------------------------------------
# the lane state of both device engines, and the push + score + snapshot
# step of K5's plain version (lcb/kernels.py)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ResidentState:
    ln: DeviceLanes  # live lane state
    rw: DeviceLanes  # rewind slab: state at the best forward prefix
    sn: DeviceLanes  # result slab: good list at the best positive score
    best_score: torch.Tensor  # [L] int64
    has_snap: torch.Tensor  # [L] bool: ever improved with positive score


def _lanes_where(mask, a: DeviceLanes, b: DeviceLanes) -> DeviceLanes:
    def sel(x, y):
        return torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y)

    return DeviceLanes(*(sel(getattr(a, f), getattr(b, f)) for f in LANE_FIELDS))


def _state_leaves(st: ResidentState) -> list:
    """The state's lane-leading tensors, in a fixed order."""
    return ([getattr(lanes, f) for lanes in (st.ln, st.rw, st.sn) for f in LANE_FIELDS]
            + [st.best_score, st.has_snap])


def _state_from_leaves(leaves) -> ResidentState:
    n = len(LANE_FIELDS)
    return ResidentState(*(DeviceLanes(*leaves[q * n:(q + 1) * n]) for q in range(3)),
                         best_score=leaves[3 * n], has_snap=leaves[3 * n + 1])


def _scatter_rows(full, rows, part):
    """`full` with its rows `rows` replaced by the rows of `part` (out of
    place); a row index of len(full) or more is dropped (JAX's
    `.at[rows].set(..., mode="drop")`): it lands on a scratch row past the
    end."""
    L = full.shape[0]
    return torch.cat([full, full[:1]]).index_copy(0, rows.clamp(max=L), part)[:L]


def seed_state(ln: DeviceLanes) -> ResidentState:
    """A phase's or tier's state from its seeded lanes: the live, rewind and
    result slabs copies of ln, each of the 68 tensors its own (K5 walks the
    state in place, so no two may share storage), best scores 0, no
    snapshot."""
    L = ln.chr.shape[0]
    dev = ln.chr.device

    def copy():
        return DeviceLanes(*(getattr(ln, f).clone() for f in LANE_FIELDS))

    return ResidentState(ln=copy(), rw=copy(), sn=copy(),
                         best_score=torch.zeros(L, dtype=torch.int64, device=dev),
                         has_snap=torch.zeros(L, dtype=torch.bool, device=dev))


def _score_of(tb: DeviceTables, ln: DeviceLanes, flank: int):
    col = torch.arange(ln.chr.shape[1], device=ln.chr.device)[None, :]
    live = (col < ln.n[:, None]) & (ln.good_seq >= 0)
    nj = tb.jpos.shape[0] - 1
    base = tb.chr_off[_clip(ln.chr, tb.chr_off.shape[0] - 2)]
    jf = tb.jpos[_clip(base + ln.fi, nj)]
    jb = tb.jpos[_clip(base + ln.bi, nj)]
    real = (jf - jb).abs()
    right_pen = ln.right_flank[:, None] - ln.bdist
    left_pen = -ln.left_flank[:, None] + ln.fdist
    bad = live & ((left_pen >= flank) | (right_pen >= flank))
    contrib = torch.where(live, real - (right_pen + left_pen) ** 2, 0)
    total = contrib.sum(dim=1)
    return torch.where(bad.any(dim=1), NEG_INF_SCORE, total)


def _push_score_snap(max_occ: int, fwd, tb: DeviceTables, st: ResidentState,
                     eu, ev, ech, elen, evalid, m: int, b: int, flank: int):
    """One mixed-direction push + score + snapshot maintenance; fwd is a
    per-lane bool vector."""
    out, success = _push_impl_traced(max_occ, fwd, tb, st.ln, eu, ev, ech, elen, evalid, m, b)
    score = _score_of(tb, out, flank)
    improved = success & (score > st.best_score)
    best_score = torch.where(improved, score, st.best_score)
    # forward pushes only happen during the forward sweep (the rewind is a
    # slab restore, not a replay), so copy-on-improve maintains the rewind
    # slab exactly at `best_right` (blocksfinder.h:271-284 semantics)
    rw = _lanes_where(improved & fwd, out, st.rw)
    snap = improved & (score > 0)
    sn = _lanes_where(snap, out, st.sn)
    new_st = ResidentState(ln=out, rw=rw, sn=sn, best_score=best_score,
                           has_snap=st.has_snap | snap)
    return new_st, success, score, improved, out.n, out.overflow
