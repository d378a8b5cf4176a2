"""Shared host-side record assembly for all junction-enumeration paths.

Every builder (monolithic, streamed, streamed-resident, sharded,
multi-host) ends with the same two steps: signed ids = dense ascending
ranks of class first-occurrence positions (+1, sign = orientation —
junctionstorage/TwoPaCo numbering), then a split of the separator-joined
global positions back into per-chromosome records.  This is the single
copy of that contract.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from sibeliaz_tpu_torch.io.dbg import JunctionChr


def assign_ids(first: np.ndarray, positive: np.ndarray) -> np.ndarray:
    """Signed ids from class-first positions and orientation flags."""
    uniq = np.unique(first)
    ids = np.searchsorted(uniq, first) + 1
    return np.where(positive, ids, -ids).astype(np.int64)


def split_chromosomes(
    gpos: np.ndarray,
    signed: np.ndarray,
    lengths: Sequence[int],
    lead_sep: int = 1,
) -> List[JunctionChr]:
    """Split ascending global positions into per-chromosome records.

    `lead_sep` is the number of separator bytes before the first
    chromosome in the joined stream (1 for the builders that prepend an
    'N', 0 for the monolithic join)."""
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    offsets[0] = lead_sep
    for i, L in enumerate(lengths):
        offsets[i + 1] = offsets[i] + L + 1
    out: List[JunctionChr] = []
    for c in range(len(lengths)):
        lo, hi = offsets[c], offsets[c] + lengths[c]
        a, b = np.searchsorted(gpos, (lo, hi))
        out.append(
            JunctionChr(
                pos=(gpos[a:b] - lo).astype(np.uint32), ids=signed[a:b]
            )
        )
    return out
