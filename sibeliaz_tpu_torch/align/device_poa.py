"""Batched partial-order alignment on the card: the device POA engine.

The counterpart of sibeliaz_tpu/align/tpu_poa.py (whose name says TPU; this
module runs on a CUDA card, or on the CPU through the kernel's plain
version).  The POA DP recurrence for sequence-vs-DAG global alignment with
linear gaps

    H[i][r] = max( max_p H[i-1][pred_p] + s(seq_i, char_r),   # match
                   max_p H[i][pred_p]   - 8,                  # deletion
                   H[i-1][r]            - 8 )                 # insertion

runs, with its traceback, in K3 `poa_dp_tb` (align/kernels.py,
csrc/poa_dp_tb.cu): one thread block per POA block, topological ranks in
a loop inside it, the insertion chain as a damped running maximum.  Graph
maintenance (threading the alignment, topological order, MSA emission)
reuses the spec's PoaGraph on the host; only the O(N*W) DP and the
traceback run on the device.

Certificate-exact banding (the native engine's scheme,
align/native/poa.cpp): per topo rank r the host computes static depth
ranges [mind, maxd] (source side) and [mins, maxs] (sink side), giving a
concave piecewise-linear upper bound on the score of any complete
alignment through cell (i, r).  Restricting the DP to the interval of i
with bound >= S — for an achieved score S <= S_opt — reproduces the FULL
DP's traceback byte-for-byte: every cell on any co-optimal path (and of
such a cell's optimal prefix) has bound >= S_opt >= S so it is computed
exactly; excluded cells read as NEG and can never win or tie a comparison.
Each rank gets a WINDOW [off[r], off[r]+W) of the sequence axis, so the H
scratch is [n_max+1, W] per block instead of [n_max+1, L+1].  Pass 1
bands at a guess S0 = sink_ub - slack; if its achieved score certifies
(>= S0) the result is final, otherwise the block re-runs banded at the
achieved score (certified unconditionally) or, with no finite score, at
full width.  The unbanded case is the same kernel with off = 0 and
W = n+1.

Scores and tie-breaks mirror align/poa_ref.py exactly (match > deletion >
insertion, first arg-max over predecessors, smallest-rank sink).  Blocks
whose graphs outgrow the padded node budget or predecessor fan-in, or
whose scratch exceeds the memory budget, fall back to the native host
engine (the caller, align/msa.py, runs them).

What differs from tpu_poa.py: routing is the memory test alone (the TPU's
per-scan-step latency test is gone); the budget is the kernel's own
H + dirs scratch, not a model of an XLA allocation plan; banding is set by
keyword arguments instead of environment variables; the counts and the
seconds of each host phase and of K3 (poa_*, poa_*_s) go to
utils/metrics.GLOBAL; batches are not padded to a power of two (nothing is
compiled per shape); a round extracts and plans blocks only until its
dispatch is full (assemble_round), not every waiting block; an empty
graph and an out-of-range traceback rank fall the block back instead of
raising or clipping.
"""

from __future__ import annotations

import functools
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from sibeliaz_tpu_torch.align import kernels
from sibeliaz_tpu_torch.align.poa_ref import PoaGraph
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

MAX_PREDS = kernels.MAX_PREDS
# a bucket of padded length L holds graphs of up to 1.75 L nodes, in
# multiples of 8 (tpu_poa.py's defaults, so that both packages bucket and
# route alike)
NODE_BUDGET_FACTOR = 1.75
_TILE = 8

# Default scratch budget on the card: this share of the device memory that
# is free when the alignment stage starts.  K3's H + dirs is the whole of
# what a dispatch allocates beyond its inputs (O(n_max * 8) per block), so
# half the free memory leaves the rest for those and the caching allocator.
CARD_SHARE = 0.5
# Default budget of the plain version on the CPU (host memory).
CPU_BUDGET = 1 << 30


def default_budget(device) -> int:
    """Scratch budget in bytes when -f is not given."""
    device = torch.device(device)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free * CARD_SHARE)
    return CPU_BUDGET


class _BlockState:
    def __init__(self, seqs: List[np.ndarray]):
        self.seqs = seqs
        self.graph = PoaGraph()
        self.graph.add_first(seqs[0])
        self.next = 1
        self.fallback = False
        # banding pass-2 state for the CURRENT sequence: None = fresh
        # (pass 1 at the slack guess); an int = re-band at that achieved
        # score (certified unconditionally); "full" = full-width re-run
        self.band_S: Optional[object] = None

    @property
    def done(self) -> bool:
        return self.fallback or self.next >= len(self.seqs)


def _extract_arrays(g: PoaGraph, n_max: int):
    """Topo-rank-space arrays for the device DP, or None if the graph is
    empty or over budget (the block then falls back)."""
    topo = g.topo_nodes()
    N = len(topo)
    if N == 0 or N > n_max:
        return None
    # predecessor SLOT ORDER is semantic (first-argmax tie-breaks) and is
    # preserved: the flat concat walks g.preds[nid] lists in order
    topo_a = np.asarray(topo, dtype=np.int64)
    preds = g.preds
    degs = np.fromiter((len(preds[nid]) for nid in topo), np.int64, N)
    if int(degs.max()) > MAX_PREDS:
        return None
    rank_of = np.full(len(g.char), n_max, dtype=np.int32)
    rank_of[topo_a] = np.arange(N, dtype=np.int32)
    node_char = np.zeros(n_max, dtype=np.uint8)
    node_char[:N] = np.asarray(g.char, dtype=np.uint8)[topo_a]
    pred_idx = np.full((n_max, MAX_PREDS), n_max, dtype=np.int32)
    pred_ok = np.zeros((n_max, MAX_PREDS), dtype=bool)
    total = int(degs.sum())
    flat = np.fromiter(
        (p for nid in topo for p in preds[nid]), np.int64, total
    )
    rows = np.repeat(np.arange(N, dtype=np.int64), degs)
    cols = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([np.zeros(1, np.int64), np.cumsum(degs)[:-1]]), degs
    )
    pred_idx[rows, cols] = rank_of[flat]
    pred_ok[rows, cols] = True
    no_pred = np.flatnonzero(degs == 0)
    pred_idx[no_pred, 0] = n_max  # virtual source
    pred_ok[no_pred, 0] = True
    sink = np.zeros(n_max, dtype=bool)
    succs = g.succs
    sink[:N] = np.fromiter(
        (not succs[nid] for nid in topo), bool, N
    )
    return topo, node_char, pred_idx, pred_ok, sink


# ---------------------------------------------------------------------------
# Host-side band computation (the native engine's certificate, vectorized;
# align/native/poa.cpp "exact banding" block)
# ---------------------------------------------------------------------------

_BIG = np.int64(1) << 50


def _depth_ranges(pred_idx, pred_ok, sink, N, n_max):
    """Per real rank r < N: [mind, maxd] = min/max source->r path depth
    (in nodes, source-adjacent = 1) and [mins, maxs] = min/max r->sink
    remaining depth.  Chain runs (single pred = r-1, the linear backbone)
    are filled vectorized; only branch/source ranks loop in Python."""
    ranks = np.arange(N)
    npred = pred_ok[:N].sum(axis=1)
    first = pred_idx[:N, 0]
    is_src = pred_ok[:N, 0] & (first == n_max)
    chain = (npred == 1) & ~is_src & (first == ranks - 1)
    branch = np.flatnonzero(~chain)

    mind = np.empty(N, np.int64)
    maxd = np.empty(N, np.int64)
    prev = 0
    for r in branch:
        if r > prev:  # chain run [prev, r): pred of i is i-1
            ar = np.arange(1, r - prev + 1)
            mind[prev:r] = mind[prev - 1] + ar
            maxd[prev:r] = maxd[prev - 1] + ar
        if is_src[r]:
            mind[r] = maxd[r] = 1
        else:
            ps = pred_idx[r][pred_ok[r]]
            mind[r] = mind[ps].min() + 1
            maxd[r] = maxd[ps].max() + 1
        prev = r + 1
    if prev < N:
        ar = np.arange(1, N - prev + 1)
        mind[prev:N] = mind[prev - 1] + ar
        maxd[prev:N] = maxd[prev - 1] + ar

    mins = np.where(sink[:N], 0, _BIG).astype(np.int64)
    maxs = np.where(sink[:N], 0, -_BIG).astype(np.int64)
    prev = N
    for r in branch[::-1]:
        if prev > r + 1:
            # chain run [r+1, prev): all external relaxations into its
            # members came from higher (already processed) ranks, so
            # in-run propagation is a reversed damped cummin/cummax
            a, b = r + 1, prev
            ar = np.arange(a, b)
            v = np.minimum.accumulate((mins[a:b] + ar)[::-1])[::-1]
            mins[a:b] = v - ar
            v = np.maximum.accumulate((maxs[a:b] + ar)[::-1])[::-1]
            maxs[a:b] = v - ar
            mins[r] = min(mins[r], mins[a] + 1)
            maxs[r] = max(maxs[r], maxs[a] + 1)
        if not is_src[r]:
            ps = pred_idx[r][pred_ok[r]]
            np.minimum.at(mins, ps, mins[r] + 1)
            np.maximum.at(maxs, ps, maxs[r] + 1)
        prev = r
    return mind, maxd, mins, maxs


def _side_bound(c, dmin, dmax):
    """Upper bound on aligning `c` chars against a path segment of depth
    in [dmin, dmax]: 5*min(c, depth) - 8*|c - depth| at the best depth."""
    return np.where(
        c < dmin, 13 * c - 8 * dmin,
        np.where(c > dmax, 13 * dmax - 8 * c, 5 * c),
    )


def _rank_windows(ranges, n, S):
    """Allowed-i interval per rank at threshold S.  bound(i, r) is concave
    piecewise-linear in i, so the allowed set is one interval: locate the
    max over its <=6 breakpoint candidates, then bisect both sides.
    Returns (ia, ib, reachable) with degenerate [0, 0] for never-allowed
    ranks (their window contents are guarded underestimates either way)."""
    mind, maxd, mins, maxs = ranges

    def bound(i):
        return _side_bound(i, mind, maxd) + _side_bound(n - i, mins, maxs)

    cands = np.stack([
        np.zeros_like(mind), np.full_like(mind, n),
        np.clip(mind, 0, n), np.clip(maxd, 0, n),
        np.clip(n - maxs, 0, n), np.clip(n - mins, 0, n),
    ])
    vals = _side_bound(cands, mind, maxd) + _side_bound(
        n - cands, mins, maxs
    )
    kbest = np.argmax(vals, axis=0)
    ibest = np.take_along_axis(cands, kbest[None], axis=0)[0]
    vbest = np.take_along_axis(vals, kbest[None], axis=0)[0]
    allowed = vbest >= S

    lo = np.zeros_like(ibest)
    hi = ibest.copy()
    for _ in range(int(n).bit_length() + 1):
        mid = (lo + hi) >> 1
        ok = bound(mid) >= S
        hi = np.where(ok, mid, hi)
        lo = np.where(ok, lo, mid + 1)
    ia = lo
    lo = ibest.copy()
    hi = np.full_like(ibest, n)
    for _ in range(int(n).bit_length() + 1):
        mid = (lo + hi + 1) >> 1
        ok = bound(mid) >= S
        lo = np.where(ok, mid, lo)
        hi = np.where(ok, hi, mid - 1)
    ib = lo
    ia = np.where(allowed, ia, 0)
    ib = np.where(allowed, ib, 0)
    return ia, ib, allowed


def _plan_windows(ex, n, L, n_max, band_S, band=True, band_min=256):
    """Per-round banding plan for one block: (off [n_max+1] int32, wneed,
    S0 or None).  S0 None means unbanded (always certified).  An
    UNBANDED block still only needs W = n + 1 window columns (its DP
    cells live in rows 0..n; off = 0 covers them all exactly), so short
    blocks absorbed into a large-L bucket never pay the bucket's full
    width."""
    topo, node_char, pred_idx, pred_ok, sink = ex
    N = len(topo)
    full = np.zeros(n_max + 1, np.int32)
    if (
        not band
        or band_S == "full"
        or n < band_min
        or N < band_min
        # NEG-floor guard: true scores must stay far above NEG so a
        # guarded read can never win/tie (native poa.cpp uses the same
        # 2^28 margin against its 2^29 floor)
        or 8 * (n + N) >= (1 << 28)
    ):
        return full, n + 1, None
    ranges = _depth_ranges(pred_idx, pred_ok, sink, N, n_max)
    sink_ub = int(
        np.max(np.where(sink[:N], _side_bound(n, ranges[0], ranges[1]),
                        -_BIG))
    )
    if band_S is None:
        S0 = sink_ub - 13 * (64 + n // 32)
    else:
        S0 = int(band_S)  # pass 2: certified unconditionally (S <= S_opt)
    ia, ib, _ = _rank_windows(ranges, n, S0)
    wneed = int((ib - ia + 1).max())
    if 4 * wneed >= 3 * (n + 1):  # band nearly full-width: skip overhead
        return full, n + 1, None
    off = np.zeros(n_max + 1, np.int32)
    off[:N] = ia.astype(np.int32)
    return off, wneed, S0


def _per_block_bytes(W: int, n_max: int) -> int:
    """K3's scratch for one block: H [n_max+1, W] int32 + dirs [n_max, W]
    uint8 (the +1 column is tpu_poa.py's model, kept so that both packages
    size the same buckets)."""
    return (n_max + 1) * (W + 1) * 4 + n_max * (W + 1)


def _n_max_for(L: int) -> int:
    return -(-int(L * NODE_BUDGET_FACTOR) // _TILE) * _TILE


def _west_estimate(L: int, dlen: int) -> int:
    """Routing-time band width estimate (slack 13*(64+L/32) spans
    ~2*(64+L/32) sequence rows at the 13/row falloff, plus the length
    mismatch shifts the diagonal by dlen).  Only used to decide device
    vs native routing; the dispatch-time plan uses the real band."""
    return min(L + 1, 2 * (64 + L // 32) + 2 * dlen + 128)


def _bucket_L(max_len: int) -> int:
    return max(64, 1 << (max_len - 1).bit_length())


def _block_west(lens, L: int, band: bool, band_min: int) -> int:
    mx, mn = max(lens), min(lens)
    if band and mx >= band_min:
        return _west_estimate(L, mx - mn)
    return mx + 1  # unbanded runs at its own width


def device_budget_eligible(
    blocks_seqs: Sequence[Sequence[np.ndarray]],
    budget_bytes: int,
    band: bool = True,
    band_min: int = 256,
) -> List[bool]:
    """Per block: does its (L, n_max) bucket's H + dirs scratch at the
    ESTIMATED band width fit the budget?  Ineligible blocks go to the
    native engine, concurrently with the device dispatches;
    poa_msa_batch_tpu re-checks with the real band."""
    out = []
    for seqs in blocks_seqs:
        lens = [len(s) for s in seqs]
        L = _bucket_L(max(lens))
        n_max = _n_max_for(L)
        west = _block_west(lens, L, band, band_min)
        out.append(_per_block_bytes(min(west, L + 1), n_max) <= budget_bytes)
    return out


def poa_msa_batch_tpu(
    blocks_seqs: Sequence[Sequence[np.ndarray]],
    budget_bytes: Optional[int] = None,
    device="cuda",
    band: bool = True,
    band_min: int = 256,
) -> List[Optional[List[bytes]]]:
    """MSA per block computed with the device DP; None for blocks that fell
    back (caller should route those to the native engine).

    Blocks are bucketed by padded sequence length so a 100 bp block never
    pays a 16 kbp block's (L, n_max) pad, and each bucket's dispatches are
    capped so the per-block H + dirs scratch fits `budget_bytes` (default:
    default_budget(device))."""
    if not blocks_seqs:
        return []
    device = torch.device(device)
    budget = default_budget(device) if budget_bytes is None else budget_bytes
    t0 = time.perf_counter()
    all_states = [_BlockState([np.asarray(s, dtype=np.uint8) for s in seqs])
                  for seqs in blocks_seqs]
    metrics.count("poa_graph_init_s", time.perf_counter() - t0)
    buckets: dict = {}
    for b, st in enumerate(all_states):
        L = _bucket_L(max(len(s) for s in st.seqs))
        buckets.setdefault(L, []).append(b)
    # Merge small buckets upward: fewer, fuller dispatches.  Greedy
    # smallest-first: absorb a bucket into the next one whenever the
    # combined block count still fits one dispatch at the larger shape
    # (banded width estimate — the dispatch-time cap uses the real band).
    def _cap_at(L: int) -> int:
        n_max = _n_max_for(L)
        west = _west_estimate(L, 0) if L >= band_min else L + 1
        return int(budget // max(_per_block_bytes(west, n_max), 1))

    merged: dict = {}
    pend_members: list = []
    items = sorted(buckets.items())
    for idx, (L, members) in enumerate(items):
        pend_members += members
        if idx + 1 < len(items):
            nxt_L, nxt_members = items[idx + 1]
            if len(pend_members) + len(nxt_members) <= _cap_at(nxt_L):
                continue  # absorb into the next (larger) bucket
        merged.setdefault(L, []).extend(pend_members)
        pend_members = []
    for L, members in sorted(merged.items()):
        n_max = _n_max_for(L)
        keep = []
        for b in members:
            lens = [len(s) for s in all_states[b].seqs]
            west = _block_west(lens, L, band, band_min)
            if _per_block_bytes(min(west, L + 1), n_max) > budget:
                # even ONE such block does not fit: route it to the
                # native fallback instead of a doomed dispatch.  The
                # dispatch-time plan re-checks with the REAL band width.
                all_states[b].fallback = True
            else:
                keep.append(b)
        if keep:
            _run_bucket(all_states, keep, L, n_max, budget, device,
                        band, band_min)
    t0 = time.perf_counter()
    out = [None if st.fallback else st.graph.msa() for st in all_states]
    metrics.count("poa_msa_s", time.perf_counter() - t0)
    return out


def _round_pow2(x: int, lo: int) -> int:
    return max(lo, 1 << (int(x) - 1).bit_length())


def pack_round(items, L: int, n_max: int, W: int):
    """Batch arrays of one dispatch, in K3's layout (align/kernels.py).

    items: per block (seq uint8 [n], (topo, node_char, pred_idx, pred_ok,
    sink) from _extract_arrays, off [n_max+1] from _plan_windows)."""
    B = len(items)
    seq_b = np.zeros((B, L + 1 + W), dtype=np.uint8)
    len_b = np.zeros(B, dtype=np.int32)
    char_b = np.zeros((B, n_max), dtype=np.uint8)
    pi_b = np.full((B, n_max, MAX_PREDS), n_max, dtype=np.int32)
    po_b = np.zeros((B, n_max, MAX_PREDS), dtype=bool)
    sink_b = np.zeros((B, n_max), dtype=bool)
    off_b = np.zeros((B, n_max + 1), dtype=np.int32)
    for j, (s, (_topo, nc, pi, po, sk), off) in enumerate(items):
        seq_b[j, 1 : 1 + len(s)] = s
        len_b[j] = len(s)
        char_b[j] = nc
        pi_b[j] = pi
        po_b[j] = po
        sink_b[j] = sk
        off_b[j] = off
    return seq_b, len_b, char_b, pi_b, po_b, sink_b, off_b


def _window_width(wneed: int, L: int) -> int:
    """W of a dispatch whose widest block needs `wneed` window columns."""
    return min(_round_pow2(wneed, 128), L + 1)


def assemble_round(states: List[_BlockState], waiting: Sequence[int], L: int,
                   n_max: int, budget: int, plan, extract=_extract_arrays):
    """The inputs of one K3 dispatch of an (L, n_max) bucket: the next copy
    of each of the first waiting blocks against its graph, as many blocks
    as fit `budget` at the widest window among them.

    plan(ex, n, L, n_max, band_S) -> (off, wneed, S0) is _plan_windows with
    the banding keywords bound.  A block whose graph cannot go to the card,
    or whose own window does not fit `budget`, is marked for fallback.
    Blocks are extracted and planned one at a time until the next one
    would not fit, so that a bucket of many blocks under a small cap does
    not re-plan every waiting block for each dispatch.  Returns (plans,
    host arrays in K3's argument order, W, P), plans[j] = (b, ex, off,
    wneed, S0) for batch row j, or None if no block is left."""
    plans, W, t_ex, t_plan = [], 0, 0.0, 0.0
    for b in waiting:
        st = states[b]
        t0 = time.perf_counter()
        ex = extract(st.graph, n_max)
        t1 = time.perf_counter()
        t_ex += t1 - t0
        if ex is None:
            st.fallback = True
            continue
        off, wneed, S0 = plan(ex, len(st.seqs[st.next]), L, n_max, st.band_S)
        t_plan += time.perf_counter() - t1
        w = _window_width(wneed, L)
        if _per_block_bytes(w, n_max) > budget:
            st.fallback = True  # even alone this block does not fit
            continue
        if plans and (len(plans) + 1) * _per_block_bytes(max(W, w), n_max) > budget:
            break  # the dispatch is full; this block waits for the next
        plans.append((b, ex, off, wneed, S0))
        W = max(W, w)
    metrics.count("poa_extract_s", t_ex)
    metrics.count("poa_plan_s", t_plan)
    if not plans:
        return None
    host = pack_round(
        [(states[b].seqs[states[b].next], ex, off)
         for b, ex, off, _w, _S0 in plans],
        L, n_max, W,
    )
    return plans, host, W, L + n_max + 2


def _run_bucket(states: List[_BlockState], members: List[int], L: int,
                n_max: int, budget: int, device: torch.device,
                band: bool, band_min: int) -> None:
    """Drive one (L, n_max) bucket's blocks to completion."""
    plan = functools.partial(_plan_windows, band=band, band_min=band_min)
    while any(not states[b].done for b in members):
        active = [b for b in members if not states[b].done]
        rnd = assemble_round(states, active, L, n_max, budget, plan)
        if rnd is None:
            continue
        plans, host, W, P = rnd
        t2 = time.perf_counter()
        seq_b, len_b, char_b, pi_b, po_b, sink_b, off_b = (
            torch.from_numpy(a).to(device) for a in host
        )
        if device.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        out_r, out_i, tcount, best_sc = kernels.poa_dp_tb(
            seq_b, len_b, char_b, pi_b, po_b, sink_b, n_max, W, P, off_b,
        )
        if device.type == "cuda":
            ev[1].record()
        # fetch the traceback registers only up to the longest USED path:
        # P = L + n_max + 2 rows are allocated but paths use ~L(1+overlap)
        tcount = tcount.cpu().numpy()
        t_used = int(tcount.max())
        if 0 < t_used < P:
            T_pad = min(P, _round_pow2(t_used, 128))
            out_r = out_r[:, :T_pad]
            out_i = out_i[:, :T_pad]
        out_r = out_r.cpu().numpy()
        out_i = out_i.cpu().numpy()
        best_sc = best_sc.cpu().numpy()
        t3 = time.perf_counter()
        metrics.count("poa_dispatch_s", t3 - t2)
        if device.type == "cuda":
            metrics.count("poa_kernel_s", ev[0].elapsed_time(ev[1]) / 1e3)
        metrics.count("poa_dispatches")
        metrics.count("poa_blocks_dispatched", len(plans))
        for j, (b, (topo, *_rest), off, _w, S0) in enumerate(plans):
            st = states[b]
            if S0 is not None:
                if int(best_sc[j]) < S0 and st.band_S is None:
                    # pass 1 uncertified: re-run banded at the achieved
                    # score (<= S_opt, so certified), or full-width if no
                    # finite in-band path survived
                    metrics.count("poa_band_pass2")
                    sc = int(best_sc[j])
                    st.band_S = sc if sc > -(1 << 28) else "full"
                    if st.band_S == "full":
                        metrics.count("poa_band_full")
                    continue
            s = st.seqs[st.next]
            t = int(tcount[j])
            rr = out_r[j, :t][::-1].astype(np.int64)
            ii = out_i[j, :t][::-1].astype(np.int64)
            topo_a = np.asarray(topo, dtype=np.int64)
            # a well-formed DP never fills the registers or names a rank
            # outside the graph; if it does, never trust the path
            if t >= P or (rr >= topo_a.size).any():
                st.fallback = True
                continue
            nids = np.where(rr >= 0, topo_a[np.maximum(rr, 0)], -1)
            st.graph.add_alignment_arrays(nids, ii, s)
            st.next += 1
            st.band_S = None
        metrics.count("poa_thread_s", time.perf_counter() - t3)
