"""Brute-force junction enumeration oracle (host, dict-based).

This module *defines* the junction semantics of the graph-construction stage
for the whole framework; the TPU implementation (graph/construct.py) must
match it exactly, and unit tests enforce that.  The semantics reconstruct
TwoPaCo's observable contract (the submodule is not mounted; see SURVEY.md §0
mount caveat) from the interchange format (common/junctionapi.h), the way
sibeliaz-lcb consumes records (junctionstorage.h:572-649), and the published
algorithm description (README.md:280-292):

  * vertices are k-mers over {A,C,G,T}; a k-mer and its reverse complement
    are one vertex (k odd excludes palindromic self-RC k-mers),
  * an occurrence's sign is + when the forward k-mer is lexicographically
    smaller than its reverse complement (the canonical orientation;
    dnachar.cpp:98-114),
  * a vertex is a *junction* iff, over all occurrences on both strands of
    all genomes, it has >= 2 distinct outgoing extension characters or >= 2
    distinct incoming extension characters (in canonical orientation), OR
    any occurrence sits at the first/last valid k-mer position of a maximal
    ACGT run (sequence/contig ends must break paths),
  * junction ids are assigned 1,2,3,... by order of first occurrence in
    (chromosome, position) order; the emitted stream is every occurrence of
    every junction vertex as (chr, pos, signed id) sorted by (chr, pos) —
    exactly what JunctionPositionWriter produces.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.io.dbg import JunctionChr


def enumerate_junctions(
    seqs: Sequence[np.ndarray], k: int
) -> List[JunctionChr]:
    """Return per-chromosome junction records for ASCII sequences."""
    # occurrence lists per canonical k-mer string
    occ: Dict[bytes, List[Tuple[int, int, bool]]] = {}
    right_ext: Dict[bytes, set] = {}
    left_ext: Dict[bytes, set] = {}
    boundary: Dict[bytes, bool] = {}

    per_chr_valid: List[np.ndarray] = []
    for c, seq in enumerate(seqs):
        L = len(seq)
        definite = alphabet.is_definite(seq)
        n = L - k + 1
        valid = np.zeros(max(n, 0), dtype=bool)
        if n > 0:
            run = np.convolve(definite.astype(np.int32), np.ones(k, np.int32), "valid")
            valid = run == k
        per_chr_valid.append(valid)
        for p in range(max(n, 0)):
            if not valid[p]:
                continue
            fwd = bytes(seq[p : p + k])
            rc = bytes(alphabet.reverse_complement(seq[p : p + k]))
            positive = fwd < rc
            canon = fwd if positive else rc
            occ.setdefault(canon, []).append((c, p, positive))
            right_ext.setdefault(canon, set())
            left_ext.setdefault(canon, set())
            boundary.setdefault(canon, False)
            nxt = seq[p + k] if p + k < L and definite[p + k] else None
            prv = seq[p - 1] if p - 1 >= 0 and definite[p - 1] else None
            comp = lambda ch: int(alphabet.complement_char(np.uint8(ch)))
            if positive:
                if nxt is not None:
                    right_ext[canon].add(int(nxt))
                if prv is not None:
                    left_ext[canon].add(int(prv))
            else:
                if prv is not None:
                    right_ext[canon].add(comp(prv))
                if nxt is not None:
                    left_ext[canon].add(comp(nxt))
            at_start = p == 0 or not valid[p - 1]
            at_end = p + 1 >= n or not valid[p + 1]
            if at_start or at_end:
                boundary[canon] = True

    # junction classes in first-occurrence order
    is_junction = {
        canon: len(right_ext[canon]) > 1 or len(left_ext[canon]) > 1 or boundary[canon]
        for canon in occ
    }
    junction_canons = [c for c in occ if is_junction[c]]
    junction_canons.sort(key=lambda canon: occ[canon][0])  # (chr, pos) of first occ
    ids = {canon: i + 1 for i, canon in enumerate(junction_canons)}

    out = [JunctionChr(pos=np.zeros(0, np.uint32), ids=np.zeros(0, np.int64)) for _ in seqs]
    records: List[List[Tuple[int, int]]] = [[] for _ in seqs]
    for canon in junction_canons:
        for c, p, positive in occ[canon]:
            records[c].append((p, ids[canon] if positive else -ids[canon]))
    for c, rec in enumerate(records):
        rec.sort()
        if rec:
            out[c] = JunctionChr(
                pos=np.array([p for p, _ in rec], dtype=np.uint32),
                ids=np.array([i for _, i in rec], dtype=np.int64),
            )
    return out
