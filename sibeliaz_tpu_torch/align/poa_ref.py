"""Partial-order alignment (POA) — executable specification.

Replaces the reference pipeline's external `spoa` stage (invoked as
`spoa <block.fa> -l 1 -r 1 -e -8`, SibeliaZ-LCB/sibeliaz:67: global
Needleman-Wunsch mode, MSA output, gap-extend -8).  With spoa's defaults
(match +5, mismatch -4, gap-open -8) and extend forced to -8, the affine
model degenerates to linear gaps of -8/char, which is what we implement.

Algorithm (Lee-Grasso-Sharlow POA):
  * the growing MSA is a DAG; aligned alternatives of one column form a
    "group" (spoa's aligned-nodes ring),
  * each new sequence is aligned to the DAG with global DP over a
    group-coherent topological order, then threaded into the graph: matches
    reuse nodes, mismatches add a node to the matched column's group,
    insertions add fresh columns,
  * MSA columns = groups in topological order; each sequence's row places
    its node characters in their columns.

Deterministic tie-breaking (fixed here, mirrored by the native engine):
DP traceback prefers match/mismatch, then deletion (graph advance), then
insertion; end node = highest score, then smallest topo rank; group
readiness resolved smallest-group-id-first.

This pure-Python version is the differential-test oracle for the native
C++ engine (align/native/poa.cpp) and the batched TPU path.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

MATCH = 5
MISMATCH = -4
GAP = -8
NEG = -(10**15)


class PoaGraph:
    def __init__(self) -> None:
        self.char: List[int] = []
        self.preds: List[List[int]] = []
        self.succs: List[List[int]] = []
        self.group_of: List[int] = []
        self.groups: List[List[int]] = []
        self.paths: List[List[int]] = []
        self._topo_cache: Optional[List[int]] = None

    def _new_node(self, ch: int, group: Optional[int]) -> int:
        self._topo_cache = None
        nid = len(self.char)
        self.char.append(ch)
        self.preds.append([])
        self.succs.append([])
        if group is None:
            group = len(self.groups)
            self.groups.append([])
        self.group_of.append(group)
        self.groups[group].append(nid)
        return nid

    def _add_edge(self, u: int, v: int) -> None:
        self._topo_cache = None
        if u not in self.preds[v]:
            self.preds[v].append(u)
            self.succs[u].append(v)

    def add_first(self, seq) -> None:
        prev = None
        path = []
        for ch in seq:
            nid = self._new_node(int(ch), None)
            if prev is not None:
                self._add_edge(prev, nid)
            path.append(nid)
            prev = nid
        self.paths.append(path)

    def topo_groups(self) -> List[int]:
        """Group ids in topological order (group ready when every member's
        predecessors are all in already-emitted groups); ties by group id.

        The heap order is byte-semantic (it is the MSA column order), so
        it is computed exactly and CACHED between graph mutations — the
        device engine re-reads the topology once per threading round, and
        the Python Kahn pass was its largest remaining host term.  The
        cached list is shared; callers must not mutate it."""
        if self._topo_cache is not None:
            return self._topo_cache
        n_groups = len(self.groups)
        indeg = [0] * n_groups
        emitted = [False] * len(self.char)
        for g in range(n_groups):
            for nid in self.groups[g]:
                indeg[g] += len(self.preds[nid])
        remaining = [0] * n_groups
        for g in range(n_groups):
            remaining[g] = indeg[g]
        ready = [g for g in range(n_groups) if remaining[g] == 0]
        heapq.heapify(ready)
        order: List[int] = []
        while ready:
            g = heapq.heappop(ready)
            order.append(g)
            for nid in self.groups[g]:
                emitted[nid] = True
            # decrement consumers
            seen = set()
            for nid in self.groups[g]:
                for v in self.succs[nid]:
                    gv = self.group_of[v]
                    remaining[gv] -= 1
                    if remaining[gv] == 0 and gv not in seen:
                        heapq.heappush(ready, gv)
                        seen.add(gv)
        if len(order) != n_groups:
            raise RuntimeError("POA graph has a cycle")
        self._topo_cache = order
        return order

    def topo_nodes(self) -> List[int]:
        return [nid for g in self.topo_groups() for nid in self.groups[g]]

    def align(
        self, seq, census: Optional[dict] = None, alt_ties: bool = False
    ) -> List[Tuple[Optional[int], Optional[int]]]:
        """Global DP of seq against the graph; returns [(node|None, pos|None)].

        `census`, if given, accumulates tie statistics: census["ties"] is
        incremented once per traceback decision (and end-node selection)
        where MORE THAN ONE choice attains the optimal score.  A sequence
        addition with zero ties has a unique optimal alignment under the
        spoa scoring (-l 1 -r 1 -e -8, sibeliaz:67), i.e. its outcome is
        forced by the scoring and cannot diverge between implementations;
        only tie-carrying decisions are exposed to implementation-specific
        tie-break order (the unmounted spoa binary's vs ours).

        `alt_ties=True` applies the OPPOSITE tie preferences (insertion
        before deletion before match; predecessors scanned in reverse;
        end node = largest rank) — still an optimal traceback, used to
        measure how much the output actually depends on tie-break order."""
        topo = self.topo_nodes()
        rank = {nid: r for r, nid in enumerate(topo)}
        N = len(topo)
        L = len(seq)
        # Column-vectorized fill (exact integer DP, same recurrence as the
        # naive double loop, which survives as the traceback's cell
        # re-derivation below).  Per topo rank r the full column H[:, r]
        # follows from its predecessor columns: with
        #   D[i] = max(diag_i, dele_i)   (pred columns only, vectorized)
        # the insertion chain H[i][r] = max(D[i], H[i-1][r] + GAP) unrolls
        # to a running maximum: H[i][r] = cummax(D - GAP*i)[i] + GAP*i
        # (GAP < 0), one numpy accumulate per column instead of L Python
        # steps.  The fill was the quadratic-Python bottleneck that made
        # block-scale tie censuses infeasible.
        seq_np = np.asarray(
            bytearray(seq) if isinstance(seq, (bytes, bytearray)) else seq,
            dtype=np.int64,
        )
        H = np.full((L + 1, N), NEG, dtype=np.int64)
        src = GAP * np.arange(L + 1, dtype=np.int64)  # virtual source col
        drift = GAP * np.arange(L + 1, dtype=np.int64)

        def pred_ranks(nid):
            ps = self.preds[nid]
            return [rank[p] for p in ps] if ps else None

        for r, nid in enumerate(topo):
            prs = pred_ranks(nid)
            s = np.where(seq_np == self.char[nid], MATCH, MISMATCH)
            if prs is None:
                diag = src[:-1] + s          # rows 1..L
                dele = src[1:] + GAP
            else:
                pred_best = H[:, prs[0]].copy()
                for pr in prs[1:]:
                    np.maximum(pred_best, H[:, pr], out=pred_best)
                diag = pred_best[:-1] + s
                dele = pred_best[1:] + GAP
            D = np.empty(L + 1, dtype=np.int64)
            D[0] = (src[0] if prs is None else pred_best[0]) + GAP
            np.maximum(diag, dele, out=D[1:])
            # insertion chain: running max with GAP drift
            np.subtract(D, drift, out=D)
            np.maximum.accumulate(D, out=D)
            np.add(D, drift, out=D)
            H[:, r] = D

        # end at a sink node (no successors) with max score; smallest rank
        # on ties (largest under alt_ties)
        sinks = [r for r, nid in enumerate(topo) if not self.succs[nid]]
        if alt_ties:
            best_r = max(sinks, key=lambda r: (H[L][r], r))
        else:
            best_r = max(sinks, key=lambda r: (H[L][r], -r))
        if census is not None:
            n_best = sum(1 for r in sinks if H[L][r] == H[L][best_r])
            if n_best > 1:
                census["ties"] = census.get("ties", 0) + 1

        # traceback: collect every choice attaining H[i][r], count ties,
        # then apply the preference order (default: match > deletion >
        # insertion, predecessors in list order — mirrored by the native
        # engine; alt_ties reverses both)
        aln: List[Tuple[Optional[int], Optional[int]]] = []
        i, r = L, best_r
        while i > 0 or r is not None:
            if r is None:
                aln.append((None, i - 1))
                i -= 1
                continue
            nid = topo[r]
            ch = int(seq[i - 1]) if i > 0 else -1
            s = MATCH if (i > 0 and self.char[nid] == ch) else MISMATCH
            prs = pred_ranks(nid)
            h = H[i][r]
            # options: ("m", pred|None) consume seq char + node,
            #          ("d", pred|None) consume node only,
            #          ("i",) consume seq char only
            opts: List[tuple] = []
            if i > 0:
                if prs is None:
                    if h == src[i - 1] + s:
                        opts.append(("m", None))
                else:
                    for pr in prs:
                        if h == H[i - 1][pr] + s:
                            opts.append(("m", pr))
            if prs is None:
                if h == src[i] + GAP:
                    opts.append(("d", None))
            else:
                for pr in prs:
                    if h == H[i][pr] + GAP:
                        opts.append(("d", pr))
            if i > 0 and h == H[i - 1][r] + GAP:
                opts.append(("i",))
            if census is not None and len(opts) > 1:
                census["ties"] = census.get("ties", 0) + 1
            pick = opts[-1] if alt_ties else opts[0]
            if pick[0] == "m":
                aln.append((nid, i - 1))
                i, r = i - 1, pick[1]
            elif pick[0] == "d":
                aln.append((nid, None))
                r = pick[1]
            else:
                aln.append((None, i - 1))
                i -= 1
        aln.reverse()
        return aln

    def add_alignment(self, aln, seq) -> None:
        n = len(aln)
        nids = np.fromiter(
            (x if x is not None else -1 for x, _ in aln), np.int64, n
        )
        iis = np.fromiter(
            (x if x is not None else -1 for _, x in aln), np.int64, n
        )
        self.add_alignment_arrays(nids, iis, seq)

    def add_alignment_arrays(self, nids, iis, seq) -> None:
        """add_alignment over int64 arrays with -1 as the None sentinel —
        the same decision procedure, restructured so the ~97%-of-rows
        common case (aligned to an existing node with a matching char)
        runs as list ops on pre-extracted locals instead of attribute
        lookups.  Exactness note: every per-row decision depends only on
        the PRE-call graph state — a traceback path visits each column
        group at most once (groups are topologically ordered and edges
        connect distinct groups), so nodes created for earlier rows of
        this same alignment are never group-search candidates for later
        rows."""
        char = self.char
        groups = self.groups
        group_of = self.group_of
        preds = self.preds
        succs = self.succs
        keep = iis >= 0  # deletion rows contribute nothing
        kn = nids[keep].tolist()
        if isinstance(seq, (bytes, bytearray)):
            seq_np = np.frombuffer(bytes(seq), dtype=np.uint8)
        else:
            seq_np = np.asarray(seq)
        kch = seq_np[iis[keep]].astype(np.int64).tolist()
        prev = None
        path: List[int] = []
        for nid, ch in zip(kn, kch):
            if nid >= 0:
                if char[nid] == ch:
                    node = nid
                else:
                    node = None
                    for cand in groups[group_of[nid]]:
                        if char[cand] == ch:
                            node = cand
                            break
                    if node is None:
                        node = self._new_node(ch, group_of[nid])
            else:
                node = self._new_node(ch, None)
            if prev is not None and prev not in preds[node]:
                self._topo_cache = None
                preds[node].append(prev)
                succs[prev].append(node)
            path.append(node)
            prev = node
        self.paths.append(path)

    def add_sequence(self, seq) -> None:
        if not self.char:
            self.add_first(seq)
        else:
            self.add_alignment(self.align(seq), seq)

    def msa(self) -> List[bytes]:
        order = self.topo_groups()
        ncols = len(order)
        col_of_group = np.zeros(len(self.groups), dtype=np.int64)
        col_of_group[np.asarray(order, dtype=np.int64)] = np.arange(ncols)
        col_of_node = col_of_group[np.asarray(self.group_of, dtype=np.int64)]
        char_arr = np.asarray(self.char, dtype=np.uint8)
        rows = []
        for path in self.paths:
            p = np.asarray(path, dtype=np.int64)
            row = np.full(ncols, ord("-"), dtype=np.uint8)
            row[col_of_node[p]] = char_arr[p]
            rows.append(row.tobytes())
        return rows


def poa_msa(seqs: List) -> List[bytes]:
    """MSA of sequences (uint8 arrays / bytes), rows in input order."""
    g = PoaGraph()
    for s in seqs:
        g.add_sequence(s)
    return g.msa()


def poa_msa_with_census(seqs: List) -> Tuple[List[bytes], int]:
    """poa_msa plus the block's tie census: the number of DP decisions
    across all sequence additions where more than one traceback choice
    attains the optimum.  ties == 0 means this block's optimal alignment
    is UNIQUE under the spoa scoring, so its MSA cannot depend on
    implementation tie-break order — the quantitative basis for the spoa
    output-parity risk bound (the spoa binary itself is an unmounted
    submodule, reference .gitmodules:1-9)."""
    g = PoaGraph()
    census = {"ties": 0}
    for s in seqs:
        if not g.char:
            g.add_first(s)
        else:
            g.add_alignment(g.align(s, census=census), s)
    return g.msa(), census["ties"]


def poa_msa_alt_ties(seqs: List) -> List[bytes]:
    """poa_msa under the OPPOSITE tie-break preferences — every choice is
    still score-optimal, so diffing against poa_msa measures how much the
    MSA bytes actually depend on tie order (the spoa-divergence risk)."""
    g = PoaGraph()
    for s in seqs:
        if not g.char:
            g.add_first(s)
        else:
            g.add_alignment(g.align(s, alt_ties=True), s)
    return g.msa()
