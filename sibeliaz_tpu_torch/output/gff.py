"""GFF3 writer, byte-compatible with the reference
(BlocksFinder::ListBlocksIndicesGFF, blocksfinder.cpp:141-174)."""

from __future__ import annotations

from typing import List, Sequence

from sibeliaz_tpu_torch.core.gxxsort import gxx_sort
from sibeliaz_tpu_torch.lcb.blocks import Block


def render_gff(
    blocks: Sequence[Block],
    names: Sequence[str],
    chr_lengths: Sequence[int],
) -> str:
    rows = list(blocks)
    # compareById looks at |id| only; ties keep the introsort residue of the
    # incoming (id, chr, start) order — required for byte equality.
    gxx_sort(rows, lambda a, b: a.block_id < b.block_id)
    out: List[str] = ["##gff-version 3.1.26\n"]
    for name, L in zip(names, chr_lengths):
        out.append(f"##sequence-region {name} 1 {L}\n")
    for b in rows:
        out.append(
            "\t".join(
                (
                    names[b.chr],
                    "SibeliaZ",
                    "SO:0000856",
                    str(b.start + 1),
                    str(b.end),
                    ".",
                    "+" if b.signed_id > 0 else "-",
                    ".",
                    f"ID={b.block_id}",
                )
            )
            + "\n"
        )
    return "".join(out)


def write_gff(
    path: str,
    blocks: Sequence[Block],
    names: Sequence[str],
    chr_lengths: Sequence[int],
) -> None:
    with open(path, "w") as f:
        f.write(render_gff(blocks, names, chr_lengths))
