"""MAF -> GFA1 pangenome-graph export, plus the glue-back validator.

Python-3 redesign of the reference's experimental helper pair
(maf_to_gfa1.py, glue_gfa1.py; documented README.md:259-273).  Semantics:

  * every MAF block is decomposed into sub-blocks whose rows are *identical
    strings*: first cut at every change of gap pattern, then split
    non-homogeneous single columns by character (maf_to_gfa1.py:80-130),
  * genome stretches not covered by any block become singleton segments
    (:135-163),
  * GFA1 emission: S per distinct sub-block (1-based ids), L for each
    adjacency (deduplicated by (from,strand,to,strand)), P per genome
    spelling the ordered, oriented segment walk (:172-218),
  * `glue(gfa)` reconstructs every genome from its P line — the round-trip
    identity is this exporter's correctness oracle (glue_gfa1.py:4-6).
"""

from __future__ import annotations

from typing import Dict, List, TextIO, Tuple

import numpy as np

from sibeliaz_tpu_torch.core import alphabet
from sibeliaz_tpu_torch.postprocess.maf import MafBlock, MafRecord, parse_maf


def _split_block(block: MafBlock) -> List[MafBlock]:
    """Decompose one MAF block into identical-string sub-blocks."""
    out: List[MafBlock] = []
    width = len(block[0].body)
    n = len(block)
    bodies = [r.body for r in block]
    # per-strand genome positions advance per non-gap char
    pos = [r.start for r in block]

    col = 0
    while col < width:
        # extend a run of columns with the same gap pattern
        pattern = tuple(b[col] == "-" for b in bodies)
        end = col
        while end < width and tuple(b[end] == "-" for b in bodies) == pattern:
            end += 1
        # split [col, end) into maximal homogeneous-character ranges
        sub = col
        while sub < end:
            chars = {b[sub] for b in bodies if b[sub] != "-"}
            if len(chars) > 1:
                # heterogeneous column: one sub-block per character
                shift = [sum(1 for c in bodies[i][col:sub] if c != "-") for i in range(n)]
                groups: Dict[str, List[int]] = {}
                for i in range(n):
                    if bodies[i][sub] != "-":
                        groups.setdefault(bodies[i][sub], []).append(i)
                for ch in sorted(groups):
                    out.append(
                        [
                            MafRecord(
                                seq_name=block[i].seq_name,
                                start=pos[i] + shift[i],
                                size=1,
                                strand=block[i].strand,
                                seq_size=block[i].seq_size,
                                body=ch,
                            )
                            for i in groups[ch]
                        ]
                    )
                sub += 1
            else:
                run = sub
                while run < end:
                    cs = {b[run] for b in bodies if b[run] != "-"}
                    if len(cs) > 1:
                        break
                    run += 1
                if run > sub:
                    shift = [
                        sum(1 for c in bodies[i][col:sub] if c != "-")
                        for i in range(n)
                    ]
                    rows = [
                        MafRecord(
                            seq_name=block[i].seq_name,
                            start=pos[i] + shift[i],
                            size=run - sub,
                            strand=block[i].strand,
                            seq_size=block[i].seq_size,
                            body=bodies[i][sub:run],
                        )
                        for i in range(n)
                        if bodies[i][sub] != "-"
                    ]
                    if rows:
                        out.append(rows)
                sub = run
        for i in range(n):
            pos[i] += sum(1 for c in bodies[i][col:end] if c != "-")
        col = end
    return out


def maf_to_gfa(
    maf_path: str,
    fasta_seqs: Dict[str, np.ndarray],
    out: TextIO,
) -> None:
    """Write a GFA1 graph covering every input genome completely."""
    blocks: List[MafBlock] = []
    for block in parse_maf(maf_path):
        blocks.extend(_split_block(block))

    # occurrence lists per genome: (plus-strand start, block idx, record)
    walks: Dict[str, List[Tuple[int, int, MafRecord]]] = {
        name: [] for name in fasta_seqs
    }
    covered = {name: np.zeros(len(s), dtype=bool) for name, s in fasta_seqs.items()}
    for b, rows in enumerate(blocks):
        for r in rows:
            ps = r.pos_start()
            walks[r.seq_name].append((ps, b, r))
            covered[r.seq_name][ps : ps + r.size] = True

    # fill uncovered stretches with singleton + strand segments
    for name, cov in covered.items():
        seq = fasta_seqs[name]
        i = 0
        L = len(cov)
        while i < L:
            if not cov[i]:
                j = i
                while j < L and not cov[j]:
                    j += 1
                blocks.append(
                    [
                        MafRecord(
                            seq_name=name,
                            start=i,
                            size=j - i,
                            strand="+",
                            seq_size=L,
                            body=alphabet.seq_to_str(seq[i:j]),
                        )
                    ]
                )
                walks[name].append((i, len(blocks) - 1, blocks[-1][0]))
                i = j
            else:
                i += 1

    # segment bodies: spell in + orientation (row strand '+' keeps body,
    # '-' rows store the - strand string; normalize from the first row)
    out.write("H\tVN:Z:1.0\n")
    emitted = set()
    links = set()

    def seg_body(b: int) -> str:
        r = blocks[b][0]
        return r.body

    def emit_segment(b: int) -> None:
        if b not in emitted:
            out.write(f"S\t{b + 1}\t{seg_body(b)}\n")
            emitted.add(b)

    lines_P = []
    for name in sorted(walks):
        walk = sorted(walks[name], key=lambda t: t[0])
        for i in range(len(walk) - 1):
            s1, b1, r1 = walk[i]
            s2, b2, r2 = walk[i + 1]
            emit_segment(b1)
            emit_segment(b2)
            if s1 + r1.size != s2:
                # overlapping/non-adjacent rows: the reference script
                # prints "FAIL ..." and skips the link
                # (maf_to_gfa1.py:193); we do the same but to stderr so
                # the emitted GFA stream stays well-formed
                import sys

                print(
                    f"FAIL {name} {s1} {r1.size} {s2}", file=sys.stderr
                )
                continue
            key = (b1, r1.strand, b2, r2.strand)
            if key not in links:
                links.add(key)
                out.write(
                    f"L\t{b1 + 1}\t{r1.strand}\t{b2 + 1}\t{r2.strand}\t*\n"
                )
        if walk:
            emit_segment(walk[-1][1])
        lines_P.append(
            "P\t"
            + name
            + "\t"
            + ",".join(f"{b + 1}{r.strand}" for _, b, r in walk)
            + "\n"
        )
    for line in lines_P:
        out.write(line)


def glue(gfa_path: str) -> Dict[str, str]:
    """Reconstruct genomes from a GFA produced by maf_to_gfa.

    Segment bodies are alignment-frame strings; a '-' oriented path step
    contributes the reverse complement (glue_gfa1.py:20-26)."""
    segments: Dict[int, str] = {}
    paths: Dict[str, List[Tuple[int, str]]] = {}
    with open(gfa_path) as f:
        for line in f:
            p = line.rstrip("\n").split("\t")
            if not p or not p[0]:
                continue
            if p[0] == "S":
                sid = int(p[1])
                if sid in segments:
                    raise ValueError("Segment duplicate!")
                segments[sid] = p[2]
            elif p[0] == "P":
                steps = []
                for tok in p[2].split(","):
                    steps.append((int(tok[:-1]), tok[-1]))
                paths[p[1]] = steps

    def rc(s: str) -> str:
        return alphabet.seq_to_str(
            alphabet.reverse_complement(alphabet.str_to_seq(s))
        )

    out = {}
    for name, steps in paths.items():
        parts = []
        for sid, strand in steps:
            body = segments[sid]
            parts.append(body if strand == "+" else rc(body))
        out[name] = "".join(parts)
    return out
