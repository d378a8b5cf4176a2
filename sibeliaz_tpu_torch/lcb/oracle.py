"""Reference-exact LCB construction engine (pure-Python oracle).

This module is the executable *specification* of the LCB stage: every
decision rule of the reference's BlocksFinder/Path machinery
(SibeliaZ-LCB/blocksfinder.h, path.h) is reproduced, including its
load-bearing quirks, so that faster engines (the native C++ engine and the
batched TPU path) can be differential-tested against it — and it in turn is
differential-tested against a build of the actual reference binary.

Replicated decision rules (citations into the reference's SibeliaZ-LCB/
sources):

  * bundle enumeration and ordering: (count desc, rank asc, resolve asc)
    with size_t wrap-around in rank (blocksfinder.h:182-209, 461-517),
  * phase protocol: 256 bundles explored against the previous phase's used
    snapshot, then serially validated/committed in bundle order; conflicts
    (any used junction, pre-filtered by the invalid-chromosome set) trigger
    a sequential re-run (blocksfinder.h:334-433),
  * greedy bidirectional extension with minRun = 2*maxBranchSize and
    best-prefix rewind (blocksfinder.h:228-310); the backward loop's stray
    ';' makes its `positive` check read the *last* score once per outer
    iteration rather than accumulating (blocksfinder.h:297-299) — kept,
  * forward extension retries allowing used junctions, backward does not
    (blocksfinder.h:780-785 vs 843-848),
  * vote-based next-vertex selection with instance-length weights and
    iterator-order tie-break (blocksfinder.h:708-768),
  * instance tracking in per-chromosome multisets keyed by a mutable
    compare index (path.h:53-181, 499-566) — mutations provably preserve
    ordering, so a sorted list models the reference's in-place key updates,
  * compatibility test with the adjacent-edge escape hatch (path.h:380-428),
  * scoring: sum of good-instance real lengths minus squared flank
    penalties, -INT32_MAX on flank overflow (path.h:604-628).

A copy of sibeliaz_tpu/lcb/oracle.py; it differs in its imports, in
naming the reference's sources without a path, and in `run`: each phase's
serial validate/commit loop is the summed span `lcb_commit` (counter
`lcb_commit_s`, utils/metrics) and each bundle it re-runs counts
`lcb_commit_redos`, and there is no `SZ_LCB_PROGRESS` printing.
"""

from __future__ import annotations

import dataclasses
from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

from sibeliaz_tpu_torch.core.gxxsort import gxx_sort
from sibeliaz_tpu_torch.junctions.table import JunctionTable
from sibeliaz_tpu_torch.core.alphabet import _COMPLEMENT_TABLE
from sibeliaz_tpu_torch.lcb.blocks import Block
from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

SIZE_MAX = 2**64 - 1
_U64 = 2**64
NEG_INF_SCORE = -(2**31 - 1)  # -INT32_MAX (path.h:616)


@dataclasses.dataclass
class Bundle:
    vid: int
    ch: int
    count: int
    rank: int
    resolve: Tuple[int, int]

    def less(self, other: "Bundle") -> bool:
        if self.count != other.count:
            return self.count > other.count
        if self.rank != other.rank:
            return self.rank < other.rank
        return self.resolve < other.resolve


class Instance:
    __slots__ = ("c", "s", "fi", "bi", "fdist", "bdist", "cmp", "ffin", "bfin")

    def __init__(self, c: int, s: int, idx: int, dist: int):
        self.c = c
        self.s = s
        self.fi = idx
        self.bi = idx
        self.fdist = dist
        self.bdist = dist
        self.cmp = idx
        self.ffin = False
        self.bfin = False

    def within(self, idx: int) -> bool:
        lo, hi = (self.fi, self.bi) if self.fi <= self.bi else (self.bi, self.fi)
        return lo <= idx <= hi

    def snapshot(self) -> "Instance":
        t = Instance(self.c, self.s, 0, 0)
        t.fi, t.bi = self.fi, self.bi
        t.fdist, t.bdist = self.fdist, self.bdist
        t.cmp, t.ffin, t.bfin = self.cmp, self.ffin, self.bfin
        return t


Edge = Tuple[int, int, int, int, int]  # (u, v, ch, rev_ch, length)
It = Tuple[int, int, int]  # (chr, idx, strand)


class LcbEngine:
    """Single-host, single-thread oracle engine (deterministic by design —
    the reference's speculative scheduler is observationally equivalent to
    this sequential phase protocol for any thread count)."""

    def __init__(
        self,
        table: JunctionTable,
        min_block_size: int,
        max_branch_size: int,
        max_flanking_size: int,
        looking_depth: int = 8,
    ):
        self.t = table
        self.k = table.k
        self.m = min_block_size
        self.b = max_branch_size
        self.flank = max_flanking_size
        self.depth = looking_depth
        self.blocks: List[Block] = []
        self.blocks_found = 0
        self.failures = 0

    # ---- iterator helpers (JunctionSequentialIterator semantics) ----

    def valid(self, it: It) -> bool:
        c, i, _ = it
        return 0 <= i < len(self.t.jpos[c])

    def vid(self, it: It) -> int:
        c, i, s = it
        return s * int(self.t.jid[c][i])

    def pos(self, it: It) -> int:
        c, i, s = it
        p = int(self.t.jpos[c][i])
        return p if s > 0 else p + self.k

    def abs_pos(self, it: It) -> int:
        c, i, _ = it
        return int(self.t.jpos[c][i])

    def nxt(self, it: It) -> It:
        c, i, s = it
        return (c, i + s, s)

    def prv(self, it: It) -> It:
        c, i, s = it
        return (c, i - s, s)

    def it_char(self, it: It) -> int:
        c, i, s = it
        p = int(self.t.jpos[c][i])
        seq = self.t.seqs[c]
        if s > 0:
            return int(seq[p + self.k]) if p + self.k < len(seq) else 0
        # reference reads seq[p-1]; p==0 is UB there — we define it as 'N'
        if p > 0:
            return int(_COMPLEMENT_TABLE[seq[p - 1]])
        return ord("N")

    def is_used(self, it: It) -> bool:
        c, i, s = it
        if s > 0:
            return bool(self.t.used[c][i])
        return bool(self.t.used[c][i - 1]) if i > 0 else False

    def mark_used(self, it: It) -> None:
        c, i, s = it
        if s > 0:
            self.t.used[c][i] = 1
        elif i > 0:
            self.t.used[c][i - 1] = 1

    def it_lt(self, a: It, b: It) -> bool:
        # (positive-strand flag, chr, idx); negative strand orders first
        pa, pb = a[2] > 0, b[2] > 0
        if pa != pb:
            return pa < pb
        if a[0] != b[0]:
            return a[0] < b[0]
        return a[1] < b[1]

    def out_edge(self, it: It) -> Edge:
        c, i, s = it
        jid, jpos, seq = self.t.jid[c], self.t.jpos[c], self.t.seqs[c]
        if s > 0:
            np_, xp = int(jpos[i]), int(jpos[i + 1])
            ch = int(seq[np_ + self.k])
            rev = int(_COMPLEMENT_TABLE[seq[xp - 1]])
            return (int(jid[i]), int(jid[i + 1]), ch, rev, xp - np_)
        np_, xp = int(jpos[i]), int(jpos[i - 1])
        ch = int(_COMPLEMENT_TABLE[seq[np_ - 1]])
        rev = int(seq[np_ + self.k]) if np_ + self.k < len(seq) else 0
        return (-int(jid[i]), -int(jid[i - 1]), ch, rev, np_ - xp)

    def in_edge(self, it: It) -> Edge:
        c, i, s = it
        jid, jpos, seq = self.t.jid[c], self.t.jpos[c], self.t.seqs[c]
        if s > 0:
            np_, pp = int(jpos[i]), int(jpos[i - 1])
            ch = int(seq[pp + self.k])
            rev = int(_COMPLEMENT_TABLE[seq[np_ - 1]])
            return (int(jid[i - 1]), int(jid[i]), ch, rev, np_ - pp)
        np_, pp = int(jpos[i]), int(jpos[i + 1])
        ch = int(_COMPLEMENT_TABLE[seq[pp - 1]])
        rev = int(seq[np_ + self.k]) if np_ + self.k < len(seq) else 0
        return (-int(jid[i + 1]), -int(jid[i]), ch, rev, pp - np_)

    def occurrences(self, vid: int):
        """Yield (chr, idx, strand) per occurrence of |vid|, (chr,idx) order;
        strand is + iff the stored id equals the signed query
        (junctionstorage.h:408-411)."""
        v = abs(vid)
        lo, hi = int(self.t.occ_off[v]), int(self.t.occ_off[v + 1])
        for j in range(lo, hi):
            c = int(self.t.occ_chr[j])
            i = int(self.t.occ_idx[j])
            s = 1 if int(self.t.jid[c][i]) == vid else -1
            yield c, i, s, j

    def occ_char(self, j: int, s: int) -> int:
        return int(self.t.occ_ch[j]) if s > 0 else int(self.t.occ_revch[j])

    # ---- Path ----

    class Path:
        def __init__(self, eng: "LcbEngine"):
            self.e = eng
            self.isets: List[List[Instance]] = [[] for _ in range(eng.t.n_chr)]
            self.all: List[Instance] = []
            self.good: List[Instance] = []
            self.dist: Dict[int, int] = {}
            self.left_body: List[Tuple[Edge, int]] = []
            self.right_body: List[Tuple[Edge, int]] = []
            self.left_flank = 0
            self.right_flank = 0
            self.origin = 0

        def init(self, vid: int, ch: int) -> None:
            self.origin = vid
            self.dist[vid] = 0
            self.left_flank = self.right_flank = 0
            for c, i, s, j in self.e.occurrences(vid):
                it = (c, i, s)
                if not self.e.is_used(it) and ch == self.e.it_char(it):
                    self._insert(Instance(c, s, i, 0))

        def _insert(self, inst: Instance) -> None:
            iset = self.isets[inst.c]
            p = bisect_right(iset, inst.cmp, key=lambda x: x.cmp)
            iset.insert(p, inst)
            self.all.append(inst)

        def clear(self) -> None:
            for e, _ in self.left_body:
                self.dist.pop(e[0], None)
            for e, _ in self.right_body:
                self.dist.pop(e[1], None)
            self.left_body.clear()
            self.right_body.clear()
            self.dist.pop(self.origin, None)
            for c in range(len(self.isets)):
                self.isets[c].clear()
            self.all.clear()
            self.good.clear()

        def is_in(self, vid: int) -> bool:
            return vid in self.dist

        def left_distance(self) -> int:
            return -self.left_flank

        def right_distance(self) -> int:
            return self.right_flank

        def middle_length(self) -> int:
            return self.left_distance() + self.right_distance()

        def right_vertex(self) -> int:
            return self.right_body[-1][0][1] if self.right_body else self.origin

        def left_vertex(self) -> int:
            return self.left_body[-1][0][0] if self.left_body else self.origin

        def real_length(self, inst: Instance) -> int:
            jpos = self.e.t.jpos[inst.c]
            return abs(int(jpos[inst.fi]) - int(jpos[inst.bi]))

        def is_good(self, inst: Instance) -> bool:
            return self.real_length(inst) >= self.e.m

        def front_it(self, inst: Instance) -> It:
            return (inst.c, inst.fi, inst.s)

        def back_it(self, inst: Instance) -> It:
            return (inst.c, inst.bi, inst.s)

        def compatible(self, start: It, end: It, edge: Edge) -> bool:
            e = self.e
            if (start[2] > 0) != (end[2] > 0):
                return False
            it = start
            guard = 0
            while it != end:
                if e.is_used(it):
                    return False
                it = e.nxt(it)
                guard += 1
                if guard > len(e.t.jpos[start[0]]) + 2:
                    raise RuntimeError("compatible scan diverged")
            real_diff = e.pos(end) - e.pos(start)
            anc_diff = self.dist[e.vid(end)] - self.dist[e.vid(start)]
            if start[2] > 0:
                if real_diff < 0:
                    return False
            else:
                if -real_diff < 0:
                    return False
            if abs(real_diff) > e.b or anc_diff > e.b:
                s1 = e.nxt(start)
                if (
                    not e.valid(s1)
                    or e.it_char(start) != edge[2]
                    or end != s1
                    or e.vid(s1) != edge[1]
                ):
                    return False
            return True

        def change_back(self, inst: Instance, it: It, dist: int) -> None:
            inst.bi = it[1]
            inst.bdist = dist
            if inst.s > 0:
                inst.cmp = inst.bi

        def change_front(self, inst: Instance, it: It, dist: int) -> None:
            inst.fi = it[1]
            inst.fdist = dist
            if inst.s < 0:
                inst.cmp = inst.fi

        def push_back(self, edge: Edge) -> bool:
            e = self.e
            vertex = edge[1]
            if vertex in self.dist:
                return False
            start_d = self.right_flank
            end_d = start_d + edge[4]
            self.dist[vertex] = end_d
            # worker (path.h:499-566)
            for c, i, s, j in e.occurrences(vertex):
                seq_it = (c, i, s)
                iset = self.isets[c]
                p = bisect_right(iset, i, key=lambda x: x.cmp)
                if p < len(iset) and iset[p].within(i):
                    continue
                cand: Optional[Instance] = None
                if s > 0:
                    if p > 0 and self.compatible(
                        self.back_it(iset[p - 1]), seq_it, edge
                    ):
                        cand = iset[p - 1]
                else:
                    if p < len(iset) and self.compatible(
                        self.back_it(iset[p]), seq_it, edge
                    ):
                        cand = iset[p]
                if cand is not None and e.vid(self.back_it(cand)) != vertex:
                    if not cand.bfin:
                        was_good = self.is_good(cand)
                        self.change_back(cand, seq_it, end_d)
                        if not was_good and self.is_good(cand):
                            self.good.append(cand)
                        if e.is_used(seq_it):
                            cand.bfin = True
                elif not e.is_used(seq_it):
                    self._insert(Instance(c, s, i, end_d))
            self.right_body.append((edge, start_d))
            self.right_flank = end_d
            return True

        def push_front(self, edge: Edge) -> bool:
            e = self.e
            vertex = edge[0]
            if vertex in self.dist:
                return False
            end_d = self.left_flank
            start_d = end_d - edge[4]
            self.dist[vertex] = start_d
            # worker (path.h:430-497)
            for c, i, s, j in e.occurrences(vertex):
                seq_it = (c, i, s)
                iset = self.isets[c]
                p = bisect_right(iset, i, key=lambda x: x.cmp)
                if p < len(iset) and iset[p].within(i):
                    continue
                cand: Optional[Instance] = None
                if s > 0:
                    if p < len(iset) and self.compatible(
                        seq_it, self.front_it(iset[p]), edge
                    ):
                        cand = iset[p]
                else:
                    if p > 0 and self.compatible(
                        seq_it, self.front_it(iset[p - 1]), edge
                    ):
                        cand = iset[p - 1]
                if cand is not None and e.vid(self.front_it(cand)) != vertex:
                    if not cand.ffin:
                        was_good = self.is_good(cand)
                        self.change_front(cand, seq_it, start_d)
                        if not was_good and self.is_good(cand):
                            self.good.append(cand)
                        if e.is_used(seq_it):
                            cand.ffin = True
                elif not e.is_used(seq_it):
                    self._insert(Instance(c, s, i, start_d))
            self.left_body.append((edge, start_d))
            self.left_flank = start_d
            return True

        def score(self) -> int:
            ret = 0
            for inst in self.good:
                sc = self.real_length(inst)
                right_pen = self.right_distance() - inst.bdist
                left_pen = self.left_distance() + inst.fdist
                if left_pen >= self.e.flank or right_pen >= self.e.flank:
                    ret = NEG_INF_SCORE
                    break
                sc -= (right_pen + left_pen) * (right_pen + left_pen)
                ret += sc
            return ret

    # ---- extension (blocksfinder.h:708-895) ----

    def most_popular(
        self, path: "LcbEngine.Path", forward: bool, try_used: bool
    ) -> Tuple[int, Optional[It], int]:
        best_vid = 0
        best_count = 0
        best_origin: Optional[It] = None
        count: Dict[int, int] = {}
        start_vid = path.right_vertex() if forward else path.left_vertex()
        inst_list = path.good if len(path.good) >= 2 else path.all
        for inst in inst_list:
            now_it = path.back_it(inst) if forward else path.front_it(inst)
            if self.vid(now_it) != start_vid:
                continue
            weight = path.real_length(inst) + 1
            origin = now_it
            it = self.nxt(origin) if forward else self.prv(origin)
            d = 1
            while self.valid(it) and (
                d < self.depth
                or abs(self.pos(it) - self.pos(origin)) <= self.b
            ):
                v = self.vid(it)
                if not path.is_in(v) and (not self.is_used(it) or try_used):
                    # the reference accumulates votes in uint32
                    # (blocksfinder.h:341,733) — the wrap at 2^32 is
                    # well-defined unsigned arithmetic and load-bearing
                    # for byte parity on extreme inputs
                    count[v] = (count.get(v, 0) + weight) & 0xFFFFFFFF
                    if count[v] > best_count or (
                        count[v] == best_count
                        and best_origin is not None
                        and self.it_lt(origin, best_origin)
                    ):
                        best_count = count[v]
                        best_origin = origin
                        best_vid = v
                else:
                    break
                it = self.nxt(it) if forward else self.prv(it)
                d += 1
        return best_vid, best_origin, best_count

    def extend_forward(self, path, state) -> bool:
        success = False
        best_vid, origin, _ = self.most_popular(path, True, False)
        if best_vid == 0:
            best_vid, origin, _ = self.most_popular(path, True, True)
        if best_vid != 0:
            it = origin
            while self.vid(it) != best_vid:
                success = path.push_back(self.out_edge(it))
                if success:
                    state["score"] = path.score()
                    if state["score"] > state["best_score"]:
                        state["best_score"] = state["score"]
                        state["best_right"] = len(path.right_body) + 1
                        if state["score"] > 0:
                            state["best_instance"] = [
                                i.snapshot() for i in path.good
                            ]
                it = self.nxt(it)
        return success

    def extend_backward(self, path, state) -> bool:
        success = False
        best_vid, origin, _ = self.most_popular(path, False, False)
        # NOTE: the reference's backward retry with used junctions is
        # commented out (blocksfinder.h:846-848) — no retry here.
        if best_vid != 0:
            it = origin
            while self.vid(it) != best_vid:
                success = path.push_front(self.in_edge(it))
                if success:
                    state["score"] = path.score()
                    if state["score"] > state["best_score"]:
                        state["best_score"] = state["score"]
                        state["best_left"] = len(path.left_body) + 1
                        if state["score"] > 0:
                            state["best_instance"] = [
                                i.snapshot() for i in path.good
                            ]
                it = self.prv(it)
        return success

    # ---- per-bundle processing (blocksfinder.h:228-310) ----

    def process(self, bundle: Bundle) -> List[Instance]:
        path = LcbEngine.Path(self)
        path.init(bundle.vid, bundle.ch)
        state = {
            "score": 0,
            "best_score": 0,
            "best_right": 1,
            "best_left": 1,
            "best_instance": [],
        }
        min_run = self.b * 2
        # forward
        while True:
            positive = False
            prev_len = path.middle_length()
            while True:
                ret = self.extend_forward(path, state)
                if not (ret and path.middle_length() - prev_len <= min_run):
                    break
                positive = positive or (state["score"] > 0)
            if not ret or not positive:
                break
        # rewind to best prefix
        best_edges = [path.right_body[i][0] for i in range(state["best_right"] - 1)]
        path.clear()
        path.init(bundle.vid, bundle.ch)
        for e in best_edges:
            path.push_back(e)
        # backward — note the reference's stray ';' (blocksfinder.h:297-299):
        # the while loop has an empty body and `positive` is evaluated ONCE
        # from the last score after the loop exits.
        while True:
            prev_len = path.middle_length()
            while True:
                ret = self.extend_backward(path, state)
                if not (ret and path.middle_length() - prev_len <= min_run):
                    break
            positive = state["score"] > 0
            if not ret or not positive:
                break
        return state["best_instance"]

    # ---- bundle enumeration + phase protocol (blocksfinder.h:453-530) ----

    def make_bundles(self) -> List[Bundle]:
        bundles: List[Bundle] = []
        V = self.t.n_vertices
        for v in range(-V + 1, V):
            occs = list(self.occurrences(v))
            if not occs:
                continue
            good = set()
            cnt: Dict[int, int] = {}
            for c, i, s, j in occs:
                ch = self.occ_char(j, s)
                if s > 0:
                    good.add(ch)
                cnt[ch] = cnt.get(ch, 0) + 1
            for ch in sorted(cnt):  # std::map iterates in key order
                if cnt[ch] > 1 and ch in good:
                    rank = 0
                    base = 1
                    resolve = (SIZE_MAX, SIZE_MAX)
                    for c, i, s, j in occs:
                        if self.occ_char(j, s) == ch:
                            rank = (rank + c * base) % _U64
                            base = (base * 31) % _U64
                            if s > 0:
                                res = (int(self.t.jpos[c][i]), c)
                                if res < resolve:
                                    resolve = res
                    bundles.append(Bundle(v, ch, cnt[ch], rank, resolve))
        gxx_sort(bundles, lambda a, b: a.less(b))
        return bundles

    @staticmethod
    def _used_range(inst: Instance):
        """The contiguous used-slot index range touched by the sequential
        walk front->back (exclusive): on + the walk visits i = fi..bi-1
        marking slot i; on - it visits i = fi..bi+1 marking slot i-1, i.e.
        slots bi..fi-1 — both are one half-open slice."""
        return (inst.fi, inst.bi) if inst.s > 0 else (inst.bi, inst.fi)

    def range_is_used(self, inst: Instance) -> bool:
        """Vectorized twin of the front->back is_used scan (run's conflict
        check); equality with the iterator walk is unit-tested."""
        lo, hi = self._used_range(inst)
        return bool(self.t.used[inst.c][lo:hi].any())

    def finalize(self, instances: List[Instance], invalid: set) -> None:
        self.blocks_found += 1
        bid = self.blocks_found
        for inst in instances:
            invalid.add(inst.c)
            front = (inst.c, inst.fi, inst.s)
            back = (inst.c, inst.bi, inst.s)
            if inst.s > 0:
                self.blocks.append(
                    Block(bid, inst.c, self.pos(front), self.pos(back) + self.k)
                )
            else:
                self.blocks.append(
                    Block(-bid, inst.c, self.pos(back) - self.k, self.pos(front))
                )
            lo, hi = self._used_range(inst)
            self.t.used[inst.c][lo:hi] = 1

    def run(
        self,
        process_batch_fn=None,
        phase_size: int = 256,
        bundles: Optional[List[Bundle]] = None,
    ) -> List[Block]:
        """Full phase/commit protocol.  `process_batch_fn(eng, bundles)` may
        replace the per-bundle exploration (e.g. the resident device engine,
        lcb/resident.py); the serial validate/commit loop — which defines the
        deterministic result — always runs here.  `phase_size` is the
        speculation window (reference: 256, blocksfinder.h:519); tests and
        the multi-chip dryrun shrink it to exercise the cross-phase commit
        protocol on tiny inputs.  `bundles` may inject a precomputed work
        list (e.g. lcb.device_bundles.make_bundles_device — identical to
        make_bundles, enumerated on device)."""
        if bundles is None:
            bundles = self.make_bundles()
        metrics.count("lcb_commit_redos", 0)  # a run without re-runs reads 0
        phase = 0
        while phase < len(bundles):
            limit = min(phase + phase_size, len(bundles))
            if process_batch_fn is None:
                results = [self.process(bundles[i]) for i in range(phase, limit)]
            else:
                results = process_batch_fn(self, bundles[phase:limit])
            with metrics.summed("lcb_commit"):
                invalid: set = set()
                for idx in range(phase, limit):
                    instances = results[idx - phase]
                    if len(instances) > 1:
                        is_good = True
                        for inst in instances:
                            if inst.c not in invalid:
                                continue
                            if self.range_is_used(inst):
                                is_good = False
                                break
                        if is_good:
                            self.finalize(instances, invalid)
                        else:
                            self.failures += 1
                            metrics.count("lcb_commit_redos")
                            instances = self.process(bundles[idx])
                            if len(instances) > 1:
                                self.finalize(instances, invalid)
            phase = limit
        return self.blocks
