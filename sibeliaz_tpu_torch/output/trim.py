"""Block trimming, renumbering, and coverage accounting.

Reproduces BlocksFinder::GenerateOutput (blocksfinder.h:605-670):

  * group raw block instances by (copy count desc, id asc) — an *unstable*
    std::sort whose equal-key residue matters, so we use gxx_sort,
  * per group: shrink each instance past already-covered positions; keep it
    iff the remainder is >= minBlockSize; groups that keep <= 1 instance are
    dropped and their coverage rolled back,
  * survivors are renumbered 1.. in group order and finally sorted by
    (|id|, chr, start).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from sibeliaz_tpu_torch.core.gxxsort import gxx_sort
from sibeliaz_tpu_torch.lcb.blocks import Block


def trim_blocks(
    raw: Sequence[Block],
    chr_lengths: Sequence[int],
    min_block_size: int,
) -> Tuple[List[Block], int]:
    """Return (trimmed blocks, block count)."""
    covered = [np.zeros(L + 1, dtype=bool) for L in chr_lengths]
    copies = {}
    for b in raw:
        copies[b.block_id] = copies.get(b.block_id, 0) + 1

    work = list(raw)

    def mult_less(a: Block, b: Block) -> bool:
        ma, mb = copies[a.block_id], copies[b.block_id]
        if ma != mb:
            return ma > mb
        return a.block_id < b.block_id

    gxx_sort(work, mult_less)

    trimmed: List[Block] = []
    trimmed_id = 1
    i = 0
    while i < len(work):
        j = i
        while j < len(work) and not mult_less(work[i], work[j]):
            j += 1
        buffer: List[Block] = []
        for t in range(i, j):
            b = work[t]
            cov = covered[b.chr]
            start, end = b.start, b.end
            while cov[start] and start < end:
                start += 1
            while cov[end] and end > start:
                end -= 1
            if end - start >= min_block_size:
                buffer.append(Block(b.sign * trimmed_id, b.chr, start, end))
                cov[start:end] = True
        if len(buffer) > 1:
            trimmed_id += 1
            trimmed.extend(buffer)
        else:
            for b in buffer:
                covered[b.chr][b.start : b.end] = False
        i = j

    gxx_sort(trimmed, lambda a, b: a.sort_key() < b.sort_key())
    return trimmed, trimmed_id - 1


def coverage(blocks: Sequence[Block], chr_lengths: Sequence[int]) -> float:
    total = sum(chr_lengths)
    covered = sum(b.length for b in blocks)
    return covered / total if total else 0.0
