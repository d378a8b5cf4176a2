"""Binary junction-stream (.dbg) interchange format.

This is the wire contract between graph construction and LCB analysis
(reference: SibeliaZ-LCB/common/junctionapi.h).  The stream is a flat
little-endian sequence of (uint32 pos, int64 bifId) pairs in chromosome
order; a chromosome boundary is a separator pair
(pos=0xFFFFFFFF, bifId=INT64_MAX) emitted once per skipped chromosome
(junctionapi.h:117-131).  Keeping this format checkpointable lets our graph
stage interoperate with reference-produced graphs and vice versa
(SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

SEPARATOR_POS = np.uint32(0xFFFFFFFF)
SEPARATOR_ID = np.int64(2**63 - 1)

_REC = np.dtype([("pos", "<u4"), ("id", "<i8")], align=False)
assert _REC.itemsize == 12


@dataclasses.dataclass
class JunctionChr:
    """All junction records of one chromosome, in position order."""

    pos: np.ndarray  # uint32
    ids: np.ndarray  # int64, signed vertex ids


def write_dbg(path: str, chrs: Sequence[JunctionChr]) -> None:
    parts = []
    now_chr = 0
    for chr_idx, ch in enumerate(chrs):
        n = len(ch.pos)
        if n == 0:
            continue
        while chr_idx > now_chr:
            sep = np.zeros(1, dtype=_REC)
            sep["pos"] = SEPARATOR_POS
            sep["id"] = SEPARATOR_ID
            parts.append(sep)
            now_chr += 1
        rec = np.zeros(n, dtype=_REC)
        rec["pos"] = ch.pos.astype(np.uint32)
        rec["id"] = ch.ids.astype(np.int64)
        parts.append(rec)
    with open(path, "wb") as f:
        for p in parts:
            f.write(p.tobytes())


def read_dbg(path: str) -> List[JunctionChr]:
    """Read a .dbg stream into per-chromosome arrays.

    Mirrors the reader semantics (junctionapi.h:80-98): a separator advances
    the current chromosome counter by one; records inherit the counter.
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) % _REC.itemsize != 0:
        # The reference reader silently stops at a truncated trailing record;
        # we do the same.
        data = data[: len(data) - len(data) % _REC.itemsize]
    rec = np.frombuffer(data, dtype=_REC)
    # the reference keeps a pair only when BOTH fields differ from the
    # sentinels (junctionapi.h:93) — EITHER matching makes it a separator
    is_sep = (rec["pos"] == SEPARATOR_POS) | (rec["id"] == SEPARATOR_ID)
    chr_of = np.cumsum(is_sep) - is_sep  # separators advance subsequent records
    keep = ~is_sep
    rec = rec[keep]
    chr_of = chr_of[keep]
    n_chr = int(chr_of[-1]) + 1 if len(rec) else 0
    out: List[JunctionChr] = []
    for c in range(n_chr):
        m = chr_of == c
        out.append(
            JunctionChr(
                pos=np.ascontiguousarray(rec["pos"][m]).astype(np.uint32),
                ids=np.ascontiguousarray(rec["id"][m]).astype(np.int64),
            )
        )
    return out
