"""Plain NumPy junction enumeration: the graph stage's reference.

The semantics are TwoPaCo's as the port states them: a vertex is a k-mer
and its reverse complement (k odd); an occurrence is positive where the
forward k-mer is the lexicographically smaller; a vertex is a junction
where its occurrences, in canonical orientation, show two or more distinct
following characters or two or more distinct preceding ones, or where one
of them is the first or last whole k-mer of a run of ACGT; junction ids
are 1, 2, ... in the order of each vertex's first occurrence in (sequence,
position) order, signed by the occurrence's orientation.  Returns, per
sequence, the junction occurrences as (uint32 positions, int64 signed
ids), in position order: the records of the `.dbg` stream.

`key_bits` below 64 keys each vertex by that many bits of a multiplicative
hash of its code in place of the code itself, so that distinct k-mers
collide as under any short hash: the control's broken guarantee.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i

Records = List[Tuple[np.ndarray, np.ndarray]]


def _windows(code: np.ndarray, k: int):
    """Forward and reverse-complement codes of every k-window (2 bits a
    base, first base highest), and whether the window is all ACGT."""
    n = len(code) - k + 1
    bad = np.concatenate([[0], np.cumsum(code == 4, dtype=np.int64)])
    valid = (bad[k:] - bad[:-k]) == 0
    c = np.where(code == 4, 0, code).astype(np.uint64)
    fwd = np.zeros(n, dtype=np.uint64)
    rc = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | c[j:j + n]
        rc |= (np.uint64(3) - c[j:j + n]) << np.uint64(2 * j)
    return fwd, rc, valid


def enumerate_junctions(seqs: Sequence[np.ndarray], k: int, key_bits: int = 64) -> Records:
    if k % 2 == 0 or not 3 <= k <= 31:
        raise ValueError("the reference takes odd k from 3 to 31")
    keys, pos_l, chr_l, right_l, left_l, edge_l, posit_l = [], [], [], [], [], [], []
    for ci, seq in enumerate(seqs):
        code = CODE[np.asarray(seq, dtype=np.uint8)]
        n = len(code) - k + 1
        if n <= 0:
            continue
        fwd, rc, valid = _windows(code, k)
        p = np.flatnonzero(valid)
        positive = fwd[p] < rc[p]
        canon = np.where(positive, fwd[p], rc[p])
        if key_bits < 64:
            canon = (canon * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(64 - key_bits)
        L = len(code)
        nxt = np.full(len(p), 4, dtype=np.uint8)
        has = p + k < L
        nxt[has] = code[p[has] + k]
        prv = np.full(len(p), 4, dtype=np.uint8)
        has = p >= 1
        prv[has] = code[p[has] - 1]
        comp = np.array([3, 2, 1, 0, 4], dtype=np.uint8)
        right = np.where(positive, nxt, comp[prv])
        left = np.where(positive, prv, comp[nxt])
        vpad = np.concatenate([[False], valid, [False]])
        edge = ~vpad[p] | ~vpad[p + 2]
        keys.append(canon)
        pos_l.append(p)
        chr_l.append(np.full(len(p), ci, dtype=np.int64))
        right_l.append(right)
        left_l.append(left)
        edge_l.append(edge)
        posit_l.append(positive)
    out: Records = [(np.zeros(0, np.uint32), np.zeros(0, np.int64)) for _ in seqs]
    if not keys:
        return out
    canon = np.concatenate(keys)
    pos = np.concatenate(pos_l)
    chrs = np.concatenate(chr_l)
    bit = np.array([1, 2, 4, 8, 0], dtype=np.uint8)
    rmask = bit[np.concatenate(right_l)]
    lmask = bit[np.concatenate(left_l)]
    edge = np.concatenate(edge_l)
    positive = np.concatenate(posit_l)
    del keys, pos_l, chr_l, right_l, left_l, edge_l, posit_l

    order = np.argsort(canon, kind="stable")  # a class's rows in genome order
    cs = canon[order]
    start = np.flatnonzero(np.concatenate([[True], cs[1:] != cs[:-1]]))
    del cs
    rm = np.bitwise_or.reduceat(rmask[order], start)
    lm = np.bitwise_or.reduceat(lmask[order], start)
    ed = np.logical_or.reduceat(edge[order], start)
    pop = np.array([bin(i).count("1") for i in range(16)])
    junction = (pop[rm] > 1) | (pop[lm] > 1) | ed
    first = order[start]  # the class's first occurrence, a row in genome order
    jcls = np.flatnonzero(junction)
    ids = np.zeros(len(start), dtype=np.int64)
    ids[jcls[np.argsort(first[jcls], kind="stable")]] = np.arange(1, len(jcls) + 1)
    sizes = np.diff(np.append(start, len(order)))
    row_ids = np.empty(len(order), dtype=np.int64)
    row_ids[order] = np.repeat(ids, sizes)
    keep = row_ids > 0
    signed = np.where(positive, row_ids, -row_ids)[keep]
    kpos, kchr = pos[keep], chrs[keep]
    bounds = np.searchsorted(kchr, np.arange(len(seqs) + 1))
    for ci in range(len(seqs)):
        a, b = bounds[ci], bounds[ci + 1]
        out[ci] = (kpos[a:b].astype(np.uint32), signed[a:b].astype(np.int64))
    return out
