"""MAF -> XMFA (Mauve) conversion, no BioPython needed (the reference's
maf_to_xmfa.py is an 11-line AlignIO shim; this reproduces AlignIO's
"mauve" writer layout: per alignment, one `> id:start-end ± name` header per
row with 1-based inclusive + strand coordinates, 80-column wrapped bodies,
and an `=` terminator)."""

from __future__ import annotations

from typing import TextIO

from sibeliaz_tpu_torch.postprocess.maf import parse_maf


def maf_to_xmfa(maf_path: str, out: TextIO, wrap: int = 80) -> None:
    names: dict = {}

    def seq_id(name: str) -> int:
        if name not in names:
            names[name] = len(names) + 1
        return names[name]

    out.write("#FormatVersion Mauve1\n")
    for block in parse_maf(maf_path):
        for r in block:
            sid = seq_id(r.seq_name)
            if r.strand == "+":
                start = r.start + 1
                end = r.start + r.size
            else:
                start = r.seq_size - (r.start + r.size) + 1
                end = r.seq_size - r.start
            out.write(f"> {sid}:{start}-{end} {r.strand} {r.seq_name}\n")
            for i in range(0, len(r.body), wrap):
                out.write(r.body[i : i + wrap] + "\n")
        out.write("=\n")
