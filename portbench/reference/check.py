#!/usr/bin/env python3
"""The comparison that decides a run's `correct`.

The reference side is worked out here from the genomes alone (the FASTA
files that the program reads too): the junction records (junctions.py),
the junction table, the bundle list, every phase of the LCB stage and the
output stage's trimming (lcb.py), rendered as the GFF.  The program side
is what the timed pass wrote: its `.dbg` graph file, its
`blocks_coords.gff`, and three of its counters.  Each number compared is
a count of differences, held to 0:

- `passes_differ` (counted by the harness): passes whose two files are
  not byte for byte those of the pass drawn from the seed, or that failed.
- `graph_diff`: junction records (sequence, position, signed id) in one
  side's graph and not in the other's; every record of the run.
- `table_diff`: |vertices| + |records kept under the abundance limit| +
  |LCB phases| (the bundle list's length over 256), program against
  reference; the whole table and bundle list.
- `lcb_diff`: blocks of the GFF whose rows, in the order written, differ
  from the reference's (a block missing on either side counts), plus one
  if the header differs; one if nothing else differs and the files are
  not equal byte for byte.  Every block of the file.

Run as a script, it judges one pass in a process of its own (so that the
forked LCB explorers start from a process that holds no device state):

    python3 portbench/reference/check.py <job.json>

where the job names the FASTA files, the configuration, the pass's two
files and its counters; it prints one JSON line, the numbers and what the
reference found.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from portbench.reference import junctions, lcb
else:
    from . import junctions, lcb

LIMITS = {"passes_differ": 0, "graph_diff": 0, "table_diff": 0, "lcb_diff": 0}


def read_fasta(paths: Sequence[str]) -> Tuple[List[str], List[np.ndarray]]:
    """Every record of the files in order: (names, uint8 ASCII sequences);
    a name is the header's first word."""
    names, seqs = [], []
    for path in paths:
        with open(path, "rb") as f:
            for rec in f.read().split(b">")[1:]:
                head, _, body = rec.partition(b"\n")
                names.append(head.split()[0].decode("ascii"))
                seqs.append(np.frombuffer(body.replace(b"\n", b"").replace(b"\r", b""),
                                          dtype=np.uint8).copy())
    return names, seqs


def reference(seqs: Sequence[np.ndarray], names: Sequence[str], cfg: Dict,
              key_bits: int = 64, workers: int = 1) -> Dict:
    """The reference's records, table sizes and GFF; `key_bits` < 64 is
    the control (junctions.enumerate_junctions)."""
    t0 = time.time()
    k = cfg["k"]
    records = junctions.enumerate_junctions(seqs, k, key_bits=key_bits)
    t1 = time.time()
    table = lcb.build_table(records, seqs, k, cfg["a"])
    bundles = lcb.make_bundles(table)
    t2 = time.time()
    eng = lcb.LcbEngine(table, cfg["m"], cfg["b"], cfg["b"], 8)
    raw = eng.run(bundles, workers)
    lengths = [len(s) for s in seqs]
    blocks = lcb.trim(raw, lengths, cfg["m"])
    t3 = time.time()
    return {
        "records": records,
        "counters": {"vertices": table.n_vertices, "junction_records": table.n_records,
                     "fused_phases": -(-len(bundles) // lcb.PHASE)},
        "gff": render_gff(blocks, names, lengths),
        "about": {"bundles": len(bundles), "raw_blocks": eng.blocks_found,
                  "blocks": len({b.block_id for b in blocks}), "failures": eng.failures,
                  "workers": workers, "graph_s": t1 - t0, "table_s": t2 - t1,
                  "lcb_s": t3 - t2},
    }


def read_dbg(path: str):
    """The program's graph file: (uint32 position, int64 id) pairs, a
    (0xFFFFFFFF, INT64_MAX) pair moving on to the next sequence."""
    rec = np.fromfile(path, dtype=np.dtype([("pos", "<u4"), ("id", "<i8")]))
    sep = (rec["pos"] == 0xFFFFFFFF) | (rec["id"] == np.iinfo(np.int64).max)
    chr_of = np.cumsum(sep) - sep
    rec, chr_of = rec[~sep], chr_of[~sep]
    n = int(chr_of[-1]) + 1 if len(rec) else 0
    return [(rec["pos"][chr_of == c].copy(), rec["id"][chr_of == c].copy()) for c in range(n)]


def render_gff(blocks: Sequence[lcb.Block], names: Sequence[str], lengths: Sequence[int]) -> str:
    """SibeliaZ's GFF (blocksfinder.cpp ListBlocksIndicesGFF): the rows
    sorted by block id with g++'s unstable sort."""
    rows = list(blocks)
    lcb.gxx_sort(rows, lambda a, b: a.block_id < b.block_id)
    out = ["##gff-version 3.1.26\n"]
    out += [f"##sequence-region {n} 1 {L}\n" for n, L in zip(names, lengths)]
    for b in rows:
        out.append("\t".join((names[b.chr], "SibeliaZ", "SO:0000856", str(b.start + 1),
                              str(b.end), ".", "+" if b.signed_id > 0 else "-", ".",
                              f"ID={b.block_id}")) + "\n")
    return "".join(out)


def gff_rows(text: str):
    """(header lines, {block id: its rows in the order written})."""
    header: List[str] = []
    rows: Dict[int, List[str]] = {}
    for line in text.splitlines():
        if line.startswith("#"):
            header.append(line)
        elif line:
            rows.setdefault(int(line.rsplit("ID=", 1)[1]), []).append(line)
    return header, rows


def gff_diff(got: str, want: str) -> int:
    gh, gr = gff_rows(got)
    wh, wr = gff_rows(want)
    n = int(gh != wh) + sum(gr.get(b) != wr.get(b) for b in set(gr) | set(wr))
    return n if n or got == want else 1


def records_diff(got, want) -> int:
    """Records in one list and not in the other."""
    n = 0
    for c in range(max(len(got), len(want))):
        gp, gi = got[c] if c < len(got) else (np.zeros(0), np.zeros(0))
        wp, wi = want[c] if c < len(want) else (np.zeros(0), np.zeros(0))
        if len(gp) == len(wp) and np.array_equal(gp, wp) and np.array_equal(gi, wi):
            continue
        a = set(zip(np.asarray(gp).tolist(), np.asarray(gi).tolist()))
        b = set(zip(np.asarray(wp).tolist(), np.asarray(wi).tolist()))
        n += len(a ^ b)
    return n


def compare(program: Dict, ref: Dict) -> Dict[str, int]:
    """program: {"records": per-sequence (positions, ids), "gff": text,
    "counters": {vertices, junction_records, fused_phases}}."""
    table_diff = sum(abs(int(program["counters"].get(k, -1)) - int(v))
                     for k, v in ref["counters"].items())
    return {"graph_diff": records_diff(program["records"], ref["records"]),
            "table_diff": table_diff, "lcb_diff": gff_diff(program["gff"], ref["gff"])}


def control(seqs: Sequence[np.ndarray], names: Sequence[str], cfg: Dict, key_bits: int = 32,
            workers: int = 1) -> Dict:
    """The control in the program's place: the reference with k-mer codes
    cut to `key_bits` bits (distinct k-mers collide: the exact de Bruijn
    graph is the guarantee it breaks)."""
    c = reference(seqs, names, cfg, key_bits=key_bits, workers=workers)
    return {"records": c["records"], "gff": c["gff"], "counters": c["counters"]}


def workers_here(cap: int = 8) -> int:
    return max(1, min(cap, len(os.sched_getaffinity(0))))


def judge_job(job: Dict) -> Dict:
    """One pass against the reference: {"numbers": ..., "about": ...}."""
    names, seqs = read_fasta(job["fastas"])
    with open(job["gff"]) as f:
        gff = f.read()
    program = {"records": read_dbg(job["dbg"]), "gff": gff, "counters": job["counters"]}
    ref = reference(seqs, names, job["cfg"], workers=job.get("workers", 1))
    return {"numbers": compare(program, ref), "about": ref["about"]}


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(json.dumps(judge_job(json.load(f))), flush=True)
