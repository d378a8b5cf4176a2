"""Plain Python LCB stage: the LCB engine's reference, over every phase.

The table, the bundles, the exploration of a bundle and the phase protocol
are SibeliaZ-LCB's, as the port's executable specification states them
(BlocksFinder/Path: bundles ordered by (count desc, rank asc, resolve
asc); phases of 256 bundles explored against the used marks at the
phase's start, then validated and committed in bundle order, a bundle
whose instances meet marks of its own phase explored again; the greedy
vote-driven extension with its best-prefix rewind).  The exploration is
that specification's code, with its iterators unrolled into list reads;
the table and the bundle list are worked out here from the reference's own
junction records, in NumPy.

`LcbEngine.run` runs the protocol from no marks over every bundle; a
phase's explorations are independent of each other, so it hands them to
forked worker processes, which read the used marks from memory the commit
writes.  `trim` is the output stage (BlocksFinder::GenerateOutput):
it trims and renumbers the raw blocks, whose order it depends on through
g++'s unstable sort (gxxsort.py).
"""

from __future__ import annotations

import dataclasses
import mmap
import multiprocessing
from bisect import bisect_right
from operator import attrgetter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .gxxsort import gxx_sort

NEG_INF_SCORE = -(2**31 - 1)  # -INT32_MAX
PHASE = 256

_COMPLEMENT_TABLE = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in ((b"A", b"T"), (b"T", b"A"), (b"C", b"G"), (b"G", b"C")):
    _COMPLEMENT_TABLE[ord(_a)] = ord(_b)


@dataclasses.dataclass(frozen=True)
class Block:
    """A raw or trimmed block instance: signed id (its sign the strand),
    sequence index, [start, end) in bases."""
    signed_id: int
    chr: int
    start: int
    end: int

    @property
    def block_id(self) -> int:
        return abs(self.signed_id)


@dataclasses.dataclass
class Table:
    """The junction table: records whose vertex occurs fewer than
    `abundance` times, per sequence in position order, and each vertex's
    occurrences in (sequence, index) order with their two flanking
    characters; `ch` and `rv` are each record's following character and
    the complement of its preceding one (0 and N past the ends)."""
    k: int
    seqs: List[np.ndarray]
    jpos: List[np.ndarray]
    jid: List[np.ndarray]
    n_vertices: int
    occ_off: np.ndarray
    occ_chr: np.ndarray
    occ_idx: np.ndarray
    occ_ch: np.ndarray
    occ_revch: np.ndarray
    ch: List[np.ndarray]
    rv: List[np.ndarray]

    @property
    def n_chr(self) -> int:
        return len(self.seqs)

    @property
    def n_records(self) -> int:
        return int(sum(len(p) for p in self.jpos))


def build_table(records, seqs: Sequence[np.ndarray], k: int, abundance: int) -> Table:
    ids_all = np.concatenate([r[1] for r in records]) if records else np.zeros(0, np.int64)
    n_vertices = int(np.abs(ids_all).max()) + 1 if len(ids_all) else 1
    count = np.bincount(np.abs(ids_all), minlength=n_vertices)
    jpos, jid = [], []
    for c in range(len(seqs)):
        pos, ids = (records[c] if c < len(records)
                    else (np.zeros(0, np.uint32), np.zeros(0, np.int64)))
        keep = count[np.abs(ids)] < abundance
        jpos.append(pos[keep].astype(np.int64))
        jid.append(ids[keep].astype(np.int64))
    vv = np.concatenate([np.abs(i) for i in jid])
    cc = np.concatenate([np.full(len(i), c, np.int32) for c, i in enumerate(jid)])
    ii = np.concatenate([np.arange(len(i), dtype=np.int64) for i in jid])
    ch, rv = [], []
    for c, seq in enumerate(seqs):
        p, L = jpos[c], len(seq)
        ch.append(np.where(p + k < L, seq[np.minimum(p + k, L - 1)], 0).astype(np.uint8))
        rv.append(np.where(p > 0, _COMPLEMENT_TABLE[seq[np.maximum(p - 1, 0)]],
                           ord("N")).astype(np.uint8))
    order = np.argsort(vv, kind="stable")
    occ_off = np.zeros(n_vertices + 1, dtype=np.int64)
    np.add.at(occ_off, vv + 1, 1)
    return Table(k=k, seqs=[np.asarray(s, np.uint8) for s in seqs], jpos=jpos, jid=jid,
                 n_vertices=n_vertices, occ_off=np.cumsum(occ_off), occ_chr=cc[order],
                 occ_idx=ii[order], occ_ch=np.concatenate(ch)[order],
                 occ_revch=np.concatenate(rv)[order], ch=ch, rv=rv)


@dataclasses.dataclass
class Bundle:
    vid: int
    ch: int
    count: int
    rank: int
    resolve: Tuple[int, int]


def make_bundles(t: Table) -> List[Bundle]:
    """Every (signed vertex, character) whose occurrences read that
    character more than once, one of them on the positive strand; ordered
    by count desc, rank asc (the sum of the occurrences' sequence indices
    times 31^j, wrapping at 2^64), resolve asc (the least (position,
    sequence) of a positive one).  No two bundles tie on all three."""
    off = t.occ_off
    n = int(off[-1])
    if n == 0:
        return []
    v = np.repeat(np.arange(t.n_vertices, dtype=np.int64), np.diff(off))
    stored = np.concatenate(t.jid)[
        np.concatenate([[0], np.cumsum([len(j) for j in t.jid])])[t.occ_chr] + t.occ_idx]
    rows = []
    for q in (1, -1):  # the query +v, then -v
        s = np.where(stored == q * v, 1, -1)
        ch = np.where(s > 0, t.occ_ch, t.occ_revch)
        rows.append((q * v, ch, s, np.arange(n)))
    qv = np.concatenate([r[0] for r in rows])
    ch = np.concatenate([r[1] for r in rows]).astype(np.int64)
    s = np.concatenate([r[2] for r in rows])
    occ = np.concatenate([r[3] for r in rows])
    order = np.lexsort((occ, ch, qv))  # groups, each in (sequence, index) order
    qv, ch, s, occ = qv[order], ch[order], s[order], occ[order]
    start = np.flatnonzero(np.concatenate([[True], (qv[1:] != qv[:-1]) | (ch[1:] != ch[:-1])]))
    size = np.diff(np.append(start, len(qv)))
    j = np.arange(len(qv)) - np.repeat(start, size)
    pow31 = np.array([pow(31, i, 1 << 64) for i in range(int(size.max()))], dtype=np.uint64)
    c = t.occ_chr[occ].astype(np.uint64)
    rank = np.add.reduceat(c * pow31[j], start)
    good = np.logical_or.reduceat(s > 0, start)
    pos = np.concatenate(t.jpos)[
        np.concatenate([[0], np.cumsum([len(p) for p in t.jpos])])[t.occ_chr[occ]]
        + t.occ_idx[occ]]
    big = np.int64(1) << np.int64(62)
    res = np.where(s > 0, pos * np.int64(1 << 16) + t.occ_chr[occ], big)
    resolve = np.minimum.reduceat(res, start)
    ok = (size > 1) & good
    start, size, rank, resolve = start[ok], size[ok], rank[ok], resolve[ok]
    sort = np.lexsort((resolve, rank, -size))
    return [Bundle(int(qv[start[i]]), int(ch[start[i]]), int(size[i]), int(rank[i]),
                   (int(resolve[i]) >> 16, int(resolve[i]) & 0xFFFF)) for i in sort]



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


_CMP = attrgetter("cmp")

Edge = Tuple[int, int, int, int, int]  # (u, v, ch, rev_ch, length)
It = Tuple[int, int, int]  # (chr, idx, strand)
Ends = Tuple[int, int, int, int]  # an instance as committed: (chr, strand, front, back)

_WORK = None  # (engine, bundles) for the forked explorers


def _explore(i: int) -> List[Ends]:
    eng, bundles = _WORK
    return [(x.c, x.s, x.fi, x.bi) for x in eng.process(bundles[i])]


class LcbEngine:
    """The exploration of one bundle, and the phase protocol's commit.

    A record is (sequence c, index i); an iterator over it adds a strand s,
    and reads the record's signed id times s.  The table is held as lists
    (record ids, positions, flanking characters, each vertex's
    occurrences), and the used marks as one shared byte map a sequence, so
    that forked explorers read the marks the commit writes."""

    def __init__(
        self,
        table: Table,
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
        self.jid = [a.tolist() for a in table.jid]
        self.jpos = [a.tolist() for a in table.jpos]
        self.ch = [a.tolist() for a in table.ch]
        self.rv = [a.tolist() for a in table.rv]
        self.occ_off = table.occ_off.tolist()
        self.occ_chr = table.occ_chr.tolist()
        self.occ_idx = table.occ_idx.tolist()
        self.occ_sid = [self.jid[c][i] for c, i in zip(self.occ_chr, self.occ_idx)]
        self.used = [mmap.mmap(-1, max(len(p), 1)) for p in self.jpos]
        self.blocks: List[Block] = []
        self.blocks_found = 0
        self.failures = 0

    # ---- iterator helpers (JunctionSequentialIterator semantics) ----

    def is_used(self, c: int, i: int, s: int) -> int:
        u = self.used[c]
        if s > 0:
            return u[i]
        return u[i - 1] if i > 0 else 0

    def it_char(self, c: int, i: int, s: int) -> int:
        # the reference reads seq[p-1] on the negative strand; p == 0 is UB
        # there, defined here as 'N' (Table.rv)
        return self.ch[c][i] if s > 0 else self.rv[c][i]

    def out_edge(self, c: int, i: int, s: int) -> Edge:
        jid, jpos = self.jid[c], self.jpos[c]
        if s > 0:
            return (jid[i], jid[i + 1], self.ch[c][i], self.rv[c][i + 1], jpos[i + 1] - jpos[i])
        return (-jid[i], -jid[i - 1], self.rv[c][i], self.ch[c][i], jpos[i] - jpos[i - 1])

    def in_edge(self, c: int, i: int, s: int) -> Edge:
        jid, jpos = self.jid[c], self.jpos[c]
        if s > 0:
            return (jid[i - 1], jid[i], self.ch[c][i - 1], self.rv[c][i], jpos[i] - jpos[i - 1])
        return (-jid[i + 1], -jid[i], self.rv[c][i + 1], self.ch[c][i], jpos[i + 1] - jpos[i])

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
            e = self.e
            self.origin = vid
            self.dist[vid] = 0
            self.left_flank = self.right_flank = 0
            v = abs(vid)
            for j in range(e.occ_off[v], e.occ_off[v + 1]):
                c, i = e.occ_chr[j], e.occ_idx[j]
                s = 1 if e.occ_sid[j] == vid else -1
                if not e.is_used(c, i, s) and ch == e.it_char(c, i, s):
                    self._insert(Instance(c, s, i, 0))

        def _insert(self, inst: Instance) -> None:
            iset = self.isets[inst.c]
            iset.insert(bisect_right(iset, inst.cmp, key=_CMP), inst)
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

        def middle_length(self) -> int:
            return self.right_flank - self.left_flank

        def right_vertex(self) -> int:
            return self.right_body[-1][0][1] if self.right_body else self.origin

        def left_vertex(self) -> int:
            return self.left_body[-1][0][0] if self.left_body else self.origin

        def real_length(self, inst: Instance) -> int:
            jpos = self.e.jpos[inst.c]
            return abs(jpos[inst.fi] - jpos[inst.bi])

        def compatible(self, c: int, si: int, ss: int, ei: int, es: int, edge: Edge) -> bool:
            """From (c, si, ss) to (c, ei, es) along the strand: no used
            record on the way, forward in position and on the path, and a
            stretch longer than b only as the edge's own step."""
            e = self.e
            if (ss > 0) != (es > 0):
                return False
            u = e.used[c]
            n = len(e.jid[c])
            if ss > 0:
                if ei >= si:
                    if u.find(b"\x01", si, ei) >= 0:
                        return False
                elif u.find(b"\x01", si, n) >= 0:
                    return False
                else:
                    raise RuntimeError("compatible scan diverged")
            elif ei <= si:
                if u.find(b"\x01", ei, si) >= 0:
                    return False
            elif u.find(b"\x01", 0, si) >= 0:
                return False
            else:
                raise RuntimeError("compatible scan diverged")
            jid, jpos = e.jid[c], e.jpos[c]
            real_diff = jpos[ei] - jpos[si]
            anc_diff = self.dist[es * jid[ei]] - self.dist[ss * jid[si]]
            if ss > 0:
                if real_diff < 0:
                    return False
            else:
                if -real_diff < 0:
                    return False
            if abs(real_diff) > e.b or anc_diff > e.b:
                s1 = si + ss
                if (
                    not 0 <= s1 < n
                    or e.it_char(c, si, ss) != edge[2]
                    or ei != s1
                    or ss * jid[s1] != edge[1]
                ):
                    return False
            return True

        def push_back(self, edge: Edge) -> bool:
            e = self.e
            vertex = edge[1]
            if vertex in self.dist:
                return False
            start_d = self.right_flank
            end_d = start_d + edge[4]
            self.dist[vertex] = end_d
            m = e.m
            v = abs(vertex)
            # worker (path.h:499-566)
            for j in range(e.occ_off[v], e.occ_off[v + 1]):
                c, i = e.occ_chr[j], e.occ_idx[j]
                s = 1 if e.occ_sid[j] == vertex else -1
                iset = self.isets[c]
                p = bisect_right(iset, i, key=_CMP)
                if p < len(iset) and iset[p].within(i):
                    continue
                cand: Optional[Instance] = None
                if s > 0:
                    if p > 0:
                        x = iset[p - 1]
                        if self.compatible(c, x.bi, x.s, i, s, edge):
                            cand = x
                elif p < len(iset):
                    x = iset[p]
                    if self.compatible(c, x.bi, x.s, i, s, edge):
                        cand = x
                if cand is not None and cand.s * e.jid[c][cand.bi] != vertex:
                    if not cand.bfin:
                        was_good = self.real_length(cand) >= m
                        cand.bi = i
                        cand.bdist = end_d
                        if cand.s > 0:
                            cand.cmp = i
                        if not was_good and self.real_length(cand) >= m:
                            self.good.append(cand)
                        if e.is_used(c, i, s):
                            cand.bfin = True
                elif not e.is_used(c, i, s):
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
            m = e.m
            v = abs(vertex)
            # worker (path.h:430-497)
            for j in range(e.occ_off[v], e.occ_off[v + 1]):
                c, i = e.occ_chr[j], e.occ_idx[j]
                s = 1 if e.occ_sid[j] == vertex else -1
                iset = self.isets[c]
                p = bisect_right(iset, i, key=_CMP)
                if p < len(iset) and iset[p].within(i):
                    continue
                cand: Optional[Instance] = None
                if s > 0:
                    if p < len(iset):
                        x = iset[p]
                        if self.compatible(c, i, s, x.fi, x.s, edge):
                            cand = x
                elif p > 0:
                    x = iset[p - 1]
                    if self.compatible(c, i, s, x.fi, x.s, edge):
                        cand = x
                if cand is not None and cand.s * e.jid[c][cand.fi] != vertex:
                    if not cand.ffin:
                        was_good = self.real_length(cand) >= m
                        cand.fi = i
                        cand.fdist = start_d
                        if cand.s < 0:
                            cand.cmp = i
                        if not was_good and self.real_length(cand) >= m:
                            self.good.append(cand)
                        if e.is_used(c, i, s):
                            cand.ffin = True
                elif not e.is_used(c, i, s):
                    self._insert(Instance(c, s, i, start_d))
            self.left_body.append((edge, start_d))
            self.left_flank = start_d
            return True

        def score(self) -> int:
            ret = 0
            flank = self.e.flank
            right, left = self.right_flank, -self.left_flank
            for inst in self.good:
                sc = self.real_length(inst)
                right_pen = right - inst.bdist
                left_pen = left + inst.fdist
                if left_pen >= flank or right_pen >= flank:
                    return NEG_INF_SCORE
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
        best_key = None
        count: Dict[int, int] = {}
        start_vid = path.right_vertex() if forward else path.left_vertex()
        inst_list = path.good if len(path.good) >= 2 else path.all
        dist = path.dist
        depth, b = self.depth, self.b
        for inst in inst_list:
            c, s = inst.c, inst.s
            jid, jpos, u = self.jid[c], self.jpos[c], self.used[c]
            i0 = inst.bi if forward else inst.fi
            if s * jid[i0] != start_vid:
                continue
            weight = abs(jpos[inst.fi] - jpos[inst.bi]) + 1
            p0 = jpos[i0]
            # the origin's order: negative strand first, then (sequence, index)
            key = (s > 0, c, i0)
            step = s if forward else -s
            n = len(jid)
            i = i0 + step
            d = 1
            while 0 <= i < n and (d < depth or abs(jpos[i] - p0) <= b):
                v = s * jid[i]
                if v not in dist and (
                    try_used or not (u[i] if s > 0 else (u[i - 1] if i > 0 else 0))
                ):
                    # the reference accumulates votes in uint32
                    # (blocksfinder.h:341,733) — the wrap at 2^32 is
                    # well-defined unsigned arithmetic and load-bearing
                    # for byte parity on extreme inputs
                    cv = (count.get(v, 0) + weight) & 0xFFFFFFFF
                    count[v] = cv
                    if cv > best_count or (
                        cv == best_count and best_key is not None and key < best_key
                    ):
                        best_count = cv
                        best_origin = (c, i0, s)
                        best_key = key
                        best_vid = v
                else:
                    break
                i += step
                d += 1
        return best_vid, best_origin, best_count

    def _pushed(self, path, state, side: str, n_body: int) -> None:
        state["score"] = path.score()
        if state["score"] > state["best_score"]:
            state["best_score"] = state["score"]
            state[side] = n_body + 1
            if state["score"] > 0:
                state["best_instance"] = [i.snapshot() for i in path.good]

    def extend_forward(self, path, state) -> bool:
        success = False
        best_vid, origin, _ = self.most_popular(path, True, False)
        if best_vid == 0:
            best_vid, origin, _ = self.most_popular(path, True, True)
        if best_vid != 0:
            c, i, s = origin
            jid = self.jid[c]
            while s * jid[i] != best_vid:
                success = path.push_back(self.out_edge(c, i, s))
                if success:
                    self._pushed(path, state, "best_right", len(path.right_body))
                i += s
        return success

    def extend_backward(self, path, state) -> bool:
        success = False
        best_vid, origin, _ = self.most_popular(path, False, False)
        # NOTE: the reference's backward retry with used junctions is
        # commented out (blocksfinder.h:846-848) — no retry here.
        if best_vid != 0:
            c, i, s = origin
            jid = self.jid[c]
            while s * jid[i] != best_vid:
                success = path.push_front(self.in_edge(c, i, s))
                if success:
                    self._pushed(path, state, "best_left", len(path.left_body))
                i -= s
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

    @staticmethod
    def _used_range(c: int, s: int, fi: int, bi: int) -> Tuple[int, int]:
        return (fi, bi) if s > 0 else (bi, fi)

    def range_is_used(self, ends: Ends) -> bool:
        c, s, fi, bi = ends
        lo, hi = self._used_range(c, s, fi, bi)
        return self.used[c].find(b"\x01", lo, hi) >= 0

    def finalize(self, instances: List[Ends], invalid: set) -> None:
        self.blocks_found += 1
        bid = self.blocks_found
        k = self.k
        for c, s, fi, bi in instances:
            invalid.add(c)
            jpos = self.jpos[c]
            if s > 0:
                self.blocks.append(Block(bid, c, jpos[fi], jpos[bi] + k))
            else:
                self.blocks.append(Block(-bid, c, jpos[bi], jpos[fi] + k))
            lo, hi = self._used_range(c, s, fi, bi)
            if hi > lo:
                self.used[c][lo:hi] = b"\x01" * (hi - lo)

    def run(self, bundles: List[Bundle], workers: int = 1) -> List[Block]:
        """The phase protocol from no marks over every bundle; a phase's
        explorations, each against the marks at the phase's start, on
        `workers` forked processes."""
        global _WORK
        n = len(bundles)
        pool = None
        if workers > 1 and n > 1:
            _WORK = (self, bundles)
            pool = multiprocessing.get_context("fork").Pool(workers)
        try:
            for phase in range(0, n, PHASE):
                limit = min(phase + PHASE, n)
                if pool is not None:
                    results = pool.map(_explore, range(phase, limit), chunksize=4)
                else:
                    results = [[(x.c, x.s, x.fi, x.bi) for x in self.process(bundles[i])]
                               for i in range(phase, limit)]
                invalid: set = set()
                for idx in range(phase, limit):
                    instances = results[idx - phase]
                    if len(instances) > 1:
                        if any(x[0] in invalid and self.range_is_used(x) for x in instances):
                            self.failures += 1
                            instances = [(x.c, x.s, x.fi, x.bi)
                                         for x in self.process(bundles[idx])]
                            if len(instances) > 1:
                                self.finalize(instances, invalid)
                        else:
                            self.finalize(instances, invalid)
        finally:
            if pool is not None:
                pool.close()
                pool.join()
            _WORK = None
        return self.blocks


def trim(raw: Sequence[Block], chr_lengths: Sequence[int], m: int) -> List[Block]:
    """The output stage: the raw blocks sorted by (copies desc, id asc)
    with g++'s unstable sort, so that a group's instances come in the
    order that sort leaves them; each instance shrunk past bases that
    earlier kept instances cover and kept if m or more bases remain; a
    group that keeps one instance or none dropped and its bases uncovered;
    kept groups numbered 1, 2, ...; the result sorted by (id, sequence,
    start)."""
    covered = [np.zeros(L + 1, dtype=bool) for L in chr_lengths]
    copies: Dict[int, int] = {}
    for b in raw:
        copies[b.block_id] = copies.get(b.block_id, 0) + 1

    def mult_less(a: Block, b: Block) -> bool:
        ma, mb = copies[a.block_id], copies[b.block_id]
        if ma != mb:
            return ma > mb
        return a.block_id < b.block_id

    work = list(raw)
    gxx_sort(work, mult_less)
    out: List[Block] = []
    bid = 1
    i = 0
    while i < len(work):
        j = i
        while j < len(work) and not mult_less(work[i], work[j]):
            j += 1
        buffer = []
        for b in work[i:j]:
            cov = covered[b.chr]
            start, end = b.start, b.end
            while cov[start] and start < end:
                start += 1
            while cov[end] and end > start:
                end -= 1
            if end - start >= m:
                buffer.append(Block(bid if b.signed_id > 0 else -bid, b.chr, start, end))
                cov[start:end] = True
        if len(buffer) > 1:
            bid += 1
            out.extend(buffer)
        else:
            for b in buffer:
                covered[b.chr][b.start:b.end] = False
        i = j
    gxx_sort(out, lambda a, b: (a.block_id, a.chr, a.start) < (b.block_id, b.chr, b.start))
    return out
