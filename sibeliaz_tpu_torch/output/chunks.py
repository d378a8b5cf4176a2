"""Legacy chunked block-sequence emitter (.tmp files).

Byte-compatible re-implementation of BlocksFinder::ListBlocksSequences
(blocksfinder.h:533-582) so users can keep external POA/alignment tooling
that consumes the reference's chunk files: blocks are grouped by id and
round-robined over `<outdir>/<i>.tmp`; each group is ONE line of
concatenated records `"> name;start;len;strand;chrSize@SEQ@"`, where a
negative-strand record carries the reverse complement and
start = chrSize - end."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.core.gxxsort import gxx_sort
from sibeliaz_tpu_torch.lcb.blocks import Block


def write_chunks(
    blocks: Sequence[Block],
    seqs: Sequence[np.ndarray],
    names: Sequence[str],
    out_dir: str,
    chunks: int = 256,
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    handles = [
        open(os.path.join(out_dir, f"{i}.tmp"), "w") for i in range(chunks)
    ]
    try:
        # GroupBy (blocksfinder.h:101-110) re-sorts by |id| with the
        # UNSTABLE std::sort before grouping; the within-group record
        # order is that introsort's residue over the incoming
        # (id, chr, start) order — required for byte equality at >16
        # instances (below that libstdc++ insertion sort is stable)
        blocks = list(blocks)
        gxx_sort(blocks, lambda a, b: a.block_id < b.block_id)
        groups: Dict[int, List[Block]] = {}
        order: List[int] = []
        for b in blocks:
            if b.block_id not in groups:
                groups[b.block_id] = []
                order.append(b.block_id)
            groups[b.block_id].append(b)
        now = 0
        for bid in order:
            out = handles[now]
            for b in groups[bid]:
                chr_size = len(seqs[b.chr])
                if b.signed_id > 0:
                    frag = seqs[b.chr][b.start : b.end]
                    start = b.start
                    strand = "+"
                else:
                    frag = alphabet.reverse_complement(seqs[b.chr][b.start : b.end])
                    start = chr_size - b.end
                    strand = "-"
                out.write(
                    f"> {names[b.chr]};{start};{b.length};{strand};{chr_size}@"
                    + alphabet.seq_to_str(frag)
                    + "@"
                )
            out.write("\n")
            now = (now + 1) % chunks
    finally:
        for h in handles:
            h.close()
