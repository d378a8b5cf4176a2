"""Bundle enumeration with its row sort on the card (the LCB stage's work
list, as sibeliaz_tpu/lcb/device_bundles.py enumerates it).

The LCB stage's work list is the bundle set: one (signed vertex, out-char)
task per combination with >= 2 occurrences and a positive-strand witness,
ordered by (count desc, rank asc, resolve asc) where `rank` is a
size_t-wrapping base-31 chromosome hash and `resolve` the minimum
(position, chromosome) over positive-strand members
(reference blocksfinder.h:461-517).

Design: each (occurrence, query-sign) pair becomes one row; one stable
sort on the card groups rows by (sign, vertex, char) in exactly the
reference's enumeration order (negative queries first in ascending signed
id, i.e. |v| descending); all per-bundle aggregates then fall out of
numpy reduceat segment arithmetic — the wrapping base-31 rank uses the
modular inverse of 31 (odd, hence invertible mod 2^64) so per-row weights
are global-prefix products divided by the segment start's prefix.

The final gxx introsort stays on the host: its unstable-tie residue is part
of the byte-level output contract.  Exactness is tested against the Python
oracle's make_bundles.

How it differs from the JAX package's module: the jitted variadic
`jax.lax.sort` (`_bundle_rows`) becomes `sort_rows`, one stable
`torch.sort` of the key and an `index_select` of the payload rows by its
permutation; the rows go to `device` in one upload and come back in one
copy.  `make_bundles_device` takes that `device` ("cuda" by default; "cpu"
runs the same code on the host, and a CUDA device without a card raises).
The host numpy before the sort (`bundle_rows`) and after it
(`bundles_of_sorted_rows`: the uint64 rank arithmetic, the lexsort, the
gxx fallback) is the JAX package's, unchanged but cut into two functions.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from sibeliaz_tpu_torch.core.gxxsort import gxx_sort
from sibeliaz_tpu_torch.junctions.table import JunctionTable
from sibeliaz_tpu_torch.lcb.oracle import SIZE_MAX, Bundle

_U64 = 2**64
_INV31 = pow(31, -1, _U64)


def sort_rows(rows: torch.Tensor) -> torch.Tensor:
    """Stable sort of the columns of `rows` (int64 [1 + P, n]) by row 0,
    the composite bundle key: the sorted key, then the P payload rows
    gathered by the sort's permutation."""
    key_s, perm = torch.sort(rows[0], stable=True)
    return torch.cat([key_s[None], rows[1:].index_select(1, perm)])


def make_bundles_device(table: JunctionTable, device="cuda") -> List[Bundle]:
    """Bundle list identical to LcbEngine.make_bundles (tested)."""
    if len(table.occ_chr) == 0:
        return []
    rows = torch.from_numpy(bundle_rows(table)).to(device)
    return bundles_of_sorted_rows(sort_rows(rows).cpu().numpy(), table.n_vertices)


def bundle_rows(table: JunctionTable) -> np.ndarray:
    """The unsorted row table (int64 [4, 2M] for M > 0 occurrences): the
    composite bundle key, position, chromosome and positive-strand flag."""
    M = len(table.occ_chr)
    occ_chr = table.occ_chr.astype(np.int64)
    occ_idx = table.occ_idx.astype(np.int64)
    counts = np.diff(table.occ_off)
    vid_abs = np.repeat(np.arange(table.n_vertices, dtype=np.int64), counts)

    chr_off = np.zeros(table.n_chr + 1, dtype=np.int64)
    for c in range(table.n_chr):
        chr_off[c + 1] = chr_off[c] + len(table.jid[c])
    jid_all = (
        np.concatenate(table.jid) if table.n_chr else np.zeros(0, np.int64)
    )
    jpos_all = (
        np.concatenate(table.jpos) if table.n_chr else np.zeros(0, np.int64)
    )
    flat = chr_off[occ_chr] + occ_idx
    stored_pos = jid_all[flat] > 0
    pos = jpos_all[flat]

    # two rows per occurrence: query sign -1 then +1 (the reference
    # enumerates v = -V+1 .. V-1, so negative queries come first with |v|
    # DESCENDING; positives with |v| ascending)
    V = table.n_vertices
    vv = np.concatenate([vid_abs, vid_abs])
    qpos = np.concatenate([np.zeros(M, bool), np.ones(M, bool)])
    sp = np.concatenate([stored_pos, stored_pos])
    positive = sp == qpos  # + strand occurrence for this query sign
    chv = np.where(
        positive,
        np.concatenate([table.occ_ch, table.occ_ch]),
        np.concatenate([table.occ_revch, table.occ_revch]),
    ).astype(np.int64)
    vid_order = np.where(qpos, vv, V - vv)  # negative side: |v| descending
    key = (
        (qpos.astype(np.int64) << 41)
        | (vid_order << 9)
        | chv
    )
    c2 = np.concatenate([occ_chr, occ_chr])
    p2 = np.concatenate([pos, pos])

    return np.stack([key, p2, c2, positive.astype(np.int64)])


def bundles_of_sorted_rows(sorted_rows: np.ndarray, V: int) -> List[Bundle]:
    """The ordered bundle list from `bundle_rows`' table sorted by
    `sort_rows`, for a table of V vertex slots."""
    key_s, pos_s, chr_s, pos_flag_s = sorted_rows
    pos_flag_s = pos_flag_s > 0
    # vv needs recovering per segment: carry via key decomposition
    n = len(key_s)

    # segment boundaries
    starts = np.concatenate([[0], np.flatnonzero(key_s[1:] != key_s[:-1]) + 1])
    seg_counts = np.diff(np.concatenate([starts, [n]]))
    has_pos = np.add.reduceat(pos_flag_s.astype(np.int64), starts) > 0

    # wrapping base-31 rank: weight[t] = 31^(t - seg_start) mod 2^64
    with np.errstate(over="ignore"):
        pow31 = np.empty(n, dtype=np.uint64)
        pow31[0] = 1
        if n > 1:
            np.multiply.accumulate(
                np.full(n - 1, 31, dtype=np.uint64), out=pow31[1:]
            )
        invpow = np.empty(n, dtype=np.uint64)
        invpow[0] = 1
        if n > 1:
            np.multiply.accumulate(
                np.full(n - 1, np.uint64(_INV31), dtype=np.uint64),
                out=invpow[1:],
            )
        seg_start_of = np.repeat(starts, seg_counts)
        weight = pow31 * invpow[seg_start_of]
        rank_terms = chr_s.astype(np.uint64) * weight
        ranks = np.add.reduceat(rank_terms, starts)

    # resolve: min (pos, chr) over positive members; composite 64-bit key
    res_key = np.where(
        pos_flag_s,
        (pos_s.astype(np.uint64) << np.uint64(20)) | chr_s.astype(np.uint64),
        np.uint64(0xFFFFFFFFFFFFFFFF),
    )
    res_min = np.minimum.reduceat(res_key, starts)

    # vectorized bundle-field extraction (the Python loop over ALL segments
    # was minutes at Mbp scale)
    sel = np.flatnonzero((seg_counts > 1) & has_pos)
    kseg = key_s[starts[sel]]
    q_is_pos = (kseg >> 41) & 1
    vid_ord = (kseg >> 9) & ((1 << 32) - 1)
    vsel = np.where(q_is_pos > 0, vid_ord, V - vid_ord)
    vid_signed = np.where(q_is_pos > 0, vsel, -vsel)
    ch_sel = kseg & 0x1FF
    cnt_sel = seg_counts[sel]
    rank_sel = ranks[sel]  # uint64, already mod 2^64
    rm = res_min[sel]
    no_res = rm == np.uint64(0xFFFFFFFFFFFFFFFF)
    res0 = np.where(no_res, np.uint64(SIZE_MAX), rm >> np.uint64(20))
    res1 = np.where(
        no_res, np.uint64(SIZE_MAX), rm & np.uint64((1 << 20) - 1)
    )

    # ordering = (count desc, rank asc, resolve asc); when every key tuple
    # is distinct, std::sort's result is the total order independent of its
    # unstable pivoting, so one lexsort suffices.  Ties (possible only for
    # same-vertex char pairs with identical occurrence sets) fall back to
    # the exact introsort residue.
    order = np.lexsort((res1, res0, rank_sel, -cnt_sel.astype(np.int64)))
    tup = np.stack(
        [
            cnt_sel[order].astype(np.uint64),
            rank_sel[order],
            res0[order],
            res1[order],
        ]
    )
    distinct = not (
        tup.shape[1] > 1 and bool(np.any(np.all(tup[:, 1:] == tup[:, :-1], axis=0)))
    )

    def mk(i):
        return Bundle(
            int(vid_signed[i]),
            int(ch_sel[i]),
            int(cnt_sel[i]),
            int(rank_sel[i]),
            (int(res0[i]), int(res1[i])),
        )

    if distinct:
        return [mk(i) for i in order]
    bundles = [mk(i) for i in range(len(sel))]
    gxx_sort(bundles, lambda a, b: a.less(b))
    return bundles
