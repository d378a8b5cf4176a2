"""The LCB vote's plain PyTorch version (MostPopularVertex over gathered
lanes), below lcb/kernels.py: K6 `lcb_vote`'s CPU path and the spec the
kernel is held to on the card.

A port of sibeliaz_tpu/lcb/resident.py::_vote_gathered.  How it differs:

  * `jax.lax.sort` on several keys: the group-by runs one stable
    `torch.sort` of the vote keys after ordering each lane's instances by
    their arrival sequence (the arrival key is unique among the entries
    that vote, so the order equals the two-key sort's); the winner is a
    lexicographic minimum over (-count, origin key, arrival), which is the
    three-key sort's column 0.  Where no entry votes the origin columns are
    unspecified in both packages (the caller reads them only under a
    winner);
  * `vmap(searchsorted)` is `torch.searchsorted` on [L, C] rows;
    `associative_scan` is `cummin`/`cumsum`/`cummax`;
  * `n_max` cuts the instance columns to the valid rows' largest count;
  * `vote_retry_plain` is the fused engine's vote with its forward-only
    used-retry (sibeliaz_tpu/lcb/fused.py:241-260), two plain votes;
  * `window_lengths` reports each voting instance's alive window, and
    `searched_slots` the window slots whose path search the vote needs,
    which chip_smoke.py counts K6's bound from; `vote_terms` counts each
    row's work as K7 counts it in its blocks (lcb/step.py's rows).
"""

from __future__ import annotations

import torch

from sibeliaz_tpu_torch.lcb.batched_push_device import BIG, DeviceLanes, DeviceTables, _clip

_I64_MAX = torch.iinfo(torch.int64).max


def vote_columns(CAP: int, IC: int, n_max=None) -> int:
    """The instance columns a vote reads: CAP, cut to n_max where given
    (at least 1), and to the slab width IC."""
    if n_max is not None:
        CAP = max(1, min(CAP, n_max))
    return min(CAP, IC)


def _windows(CAP: int, W: int, tb: DeviceTables, ln: DeviceLanes, idx, valid, forward,
             try_used, depth: int, b: int, n_max):
    """The gathered rows' voting instances and their windows: a dict of
    [A, CAPx] columns and the [A, CAPx, W] alive entries and their vids."""
    dev = ln.chr.device
    CAP = vote_columns(CAP, ln.chr.shape[1], n_max)

    def take(a):
        return a.index_select(0, idx)

    start_vid = torch.where(valid, torch.where(forward, take(ln.rv), take(ln.lv)), BIG)
    chr_ = take(ln.chr[:, :CAP])
    s = take(ln.s[:, :CAP])
    fi = take(ln.fi[:, :CAP])
    bi = take(ln.bi[:, :CAP])
    good_seq = take(ln.good_seq[:, :CAP])
    insert_seq = take(ln.insert_seq[:, :CAP])
    n = torch.where(valid, take(ln.n), 0)
    pvid = take(ln.pvid)
    pn = take(ln.pn)

    L = chr_.shape[0]
    CAPx = chr_.shape[1]
    col = torch.arange(CAPx, device=dev)[None, :]
    live = col < n[:, None]

    good = good_seq >= 0
    n_good = (good & live).sum(dim=1)
    use_good = n_good >= 2
    in_list = torch.where(use_good[:, None], good & live, live)
    order_seq = torch.where(use_good[:, None], good_seq, insert_seq)

    nj = tb.jpos.shape[0] - 1
    end_i = torch.where(forward[:, None], bi, fi)
    base = tb.chr_off[_clip(chr_, tb.chr_off.shape[0] - 2)]
    end_vid = s * tb.jid[_clip(base + end_i, nj)]
    at_end = in_list & (end_vid == start_vid[:, None])

    jf = tb.jpos[_clip(base + fi, nj)]
    jb = tb.jpos[_clip(base + bi, nj)]
    weight = (jf - jb).abs() + 1
    kshift = torch.where(s < 0, tb.k, 0)
    opos = tb.jpos[_clip(base + end_i, nj)] + kshift
    okey = ((s > 0).long() << 62) | (chr_ << 40) | end_i

    d = torch.arange(1, W + 1, device=dev)  # [W]
    dirn = torch.where(forward[:, None, None], d[None, None, :], -d[None, None, :])
    it_i = end_i[:, :, None] + s[:, :, None] * dirn
    clen = tb.chr_len[_clip(chr_, tb.chr_len.shape[0] - 1)]
    in_range = (it_i >= 0) & (it_i < clen[:, :, None])
    flat = _clip(base[:, :, None] + it_i, nj)
    pos = tb.jpos[flat] + kshift[:, :, None]
    within = (d[None, None, :] < depth) | ((pos - opos[:, :, None]).abs() <= b)
    vid = s[:, :, None] * tb.jid[flat]
    q = vid.reshape(L, -1)
    pp = torch.searchsorted(pvid.contiguous(), q)
    padded = torch.cat([pvid, torch.full((L, 1), BIG, dtype=pvid.dtype, device=dev)], dim=1)
    hit = padded.gather(1, pp) == q
    in_path = (hit & (pp < pn[:, None])).reshape(vid.shape)
    uslot = torch.where(s[:, :, None] > 0, flat, flat - 1)
    used = ((s[:, :, None] > 0) | (it_i > 0)) & (
        tb.used[_clip(uslot, tb.used.shape[0] - 1)] > 0)
    ok_used = ~used | try_used[:, None, None]
    cont = at_end[:, :, None] & in_range & within & ~in_path & ok_used
    alive = cont.to(torch.int8).cummin(dim=2).values.bool()
    # a window's slot d is evaluated where its slots before d are alive,
    # and searched in the path where it is also in range and within
    evaluated = torch.cat([at_end[:, :, None], alive[:, :, :-1]], dim=2)
    return dict(chr=chr_, s=s, end_i=end_i, in_list=in_list, at_end=at_end, weight=weight,
                okey=okey, order_seq=order_seq, col=col, d=d, vid=vid, alive=alive,
                searched=evaluated & in_range & within)


def vote_plain(CAP: int, W: int, tb: DeviceTables, ln: DeviceLanes, idx, valid, forward,
               try_used, depth: int, b: int, n_max=None):
    """Vote for the gathered lanes idx (read-only; invalid rows inert).

    Per-lane `forward`/`try_used`, so one call serves mixed directions.
    The start vertex is the lane's own path-end register (rv forward, lv
    backward).  Returns (best_vid, best_cnt, origin chr/idx/strand,
    window-overflow) per gathered row.  `n_max`, a bound on the valid
    rows' instance counts where the caller knows one, trims the instance
    columns to it: the columns past a lane's count take no part in the
    vote."""
    w = _windows(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max)
    alive, vid, d, col = w["alive"], w["vid"], w["d"], w["col"]
    order_seq = w["order_seq"]
    L, CAPx = w["chr"].shape
    dev = vid.device
    overflow = alive[:, :, W - 1].any(dim=1).to(torch.int64)

    # order-free winner reduction (docs/design.md §3), per lane: entries
    # in arrival order (instances by their order sequence, d ascending
    # within one), then grouped by vid with one stable sort
    qord = torch.sort(order_seq, dim=1, stable=True).indices
    CW = CAPx * W

    def by_arrival(x):  # [L, CAP, W] or [L, CAP] -> [L, CW] in arrival order
        x = x if x.dim() == 3 else x[:, :, None].expand(-1, -1, W)
        return x.gather(1, qord[:, :, None].expand(-1, -1, W)).reshape(L, CW)

    keyv = by_arrival(torch.where(alive, vid, BIG))
    arr = by_arrival(order_seq[:, :, None] * W + (d - 1)[None, None, :])
    key_s, perm = torch.sort(keyv, dim=1, stable=True)
    a2 = arr.gather(1, perm)
    o2 = by_arrival(w["okey"]).gather(1, perm)
    w2 = by_arrival(w["weight"]).gather(1, perm)
    sl2 = by_arrival(col.expand(L, -1)).gather(1, perm)

    ridx = torch.arange(CW, device=dev)[None, :].expand(L, -1)
    ones_col = torch.ones((L, 1), dtype=torch.bool, device=dev)
    seg_start = torch.cat([ones_col, key_s[:, 1:] != key_s[:, :-1]], dim=1)
    seg_end = torch.cat([seg_start[:, 1:], ones_col], dim=1)
    wcum = w2.cumsum(dim=1)
    start_rank = torch.where(seg_start, ridx, -1).cummax(dim=1).values
    base_at = (wcum - w2).gather(1, start_rank.clamp(min=0))
    final_cnt = wcum - base_at
    is_final = seg_end & (key_s < BIG)

    # the winner: most votes first, then origin-iterator order, then
    # arrival, among the final-count events (a lexicographic minimum)
    # (the origin key's strand bit, 1 << 62, lies above BIG: the rows left
    # out of a minimum take the largest int64)
    neg = torch.where(is_final, -final_cnt, BIG)
    pick = neg == neg.min(dim=1, keepdim=True).values
    o_m = torch.where(pick, o2, _I64_MAX)
    pick &= o_m == o_m.min(dim=1, keepdim=True).values
    win = torch.where(pick, a2, _I64_MAX).argmin(dim=1, keepdim=True)
    has = neg.gather(1, win)[:, 0] < 0
    best_vid = torch.where(has, key_s.gather(1, win)[:, 0], 0)
    best_cnt = torch.where(has, -neg.gather(1, win)[:, 0], 0)
    slot_c = _clip(sl2.gather(1, win), CAPx - 1)
    ochr = w["chr"].gather(1, slot_c)[:, 0]
    oidx = w["end_i"].gather(1, slot_c)[:, 0]
    ostr = w["s"].gather(1, slot_c)[:, 0]
    return best_vid, best_cnt, ochr, oidx, ostr, overflow


def vote_retry_plain(CAP: int, W: int, tb: DeviceTables, ln: DeviceLanes, idx, valid, forward,
                     try_used, depth: int, b: int, n_max=None):
    """The vote with the fused engine's forward-only used-retry
    (blocksfinder.h:780-785): the valid forward rows whose vote found no
    winner and no window overflow vote again with try_used set, and their
    results replace the first vote's; the overflow flag is the first
    vote's, or the retry's where a row retried."""
    first = vote_plain(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max)
    need = valid & forward & (first[0] == 0) & (first[5] == 0)
    if not bool(need.any()):  # the JAX package's lax.cond
        return first
    again = vote_plain(CAP, W, tb, ln, idx, need, forward, need, depth, b, n_max)
    out = [torch.where(need, y, x) for x, y in zip(first[:5], again[:5])]
    return (*out, first[5] | (need & (again[5] > 0)).long())


def window_lengths(CAP: int, W: int, tb: DeviceTables, ln: DeviceLanes, idx, valid, forward,
                   try_used, depth: int, b: int, n_max=None) -> torch.Tensor:
    """[A, CAPx] int64: each voting instance's alive window length (0 to W);
    -2 for a voting instance that is not at the lane's path end (it has no
    window), -1 for a column that does not vote."""
    w = _windows(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max)
    return torch.where(w["at_end"], w["alive"].sum(dim=2), torch.where(w["in_list"], -2, -1))


def searched_slots(CAP: int, W: int, tb: DeviceTables, ln: DeviceLanes, idx, valid, forward,
                   try_used, depth: int, b: int, n_max=None):
    """([A, CAPx, W] vids, [A, CAPx, W] bool): the window slots whose path
    search (torch.searchsorted over the row's whole pvid row) the vote
    needs, each a window's slot up to its first failure that is in range
    and within, and the vids searched there."""
    w = _windows(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max)
    return w["vid"], w["searched"]


def vote_terms(CAP: int, W: int, tb: DeviceTables, ln: DeviceLanes, idx, valid, forward,
               try_used, depth: int, b: int, n_max=None, retry: bool = False) -> torch.Tensor:
    """[4, A] int64: each row's voting instances, those at the lane's path
    end (a window each), evaluated window slots (a window's alive slots and
    the slot that ends it, W at most) and alive window entries.  With
    `retry`, a row that retries (vote_retry_plain's rows: valid, forward,
    no winner and no overflow) counts its retry's slots and entries: the
    retry's windows are the longer, since they also take used junctions.
    What K7 counts of a vote in its block."""
    w = _windows(CAP, W, tb, ln, idx, valid, forward, try_used, depth, b, n_max)
    alive = w["alive"]
    if retry:
        winner = (alive & (w["vid"] < BIG)).flatten(1).any(dim=1)
        need = valid & forward & ~winner & ~alive[:, :, W - 1].any(dim=1)
        if bool(need.any()):
            again = _windows(CAP, W, tb, ln, idx, need, forward, need, depth, b, n_max)["alive"]
            alive = torch.where(need[:, None, None], again, alive)
    at_end = w["at_end"]
    lens = torch.where(at_end, alive.sum(dim=2), 0)
    return torch.stack([w["in_list"].sum(dim=1), at_end.sum(dim=1),
                        torch.where(at_end, (lens + 1).clamp(max=W), 0).sum(dim=1),
                        lens.sum(dim=1)])
