"""FASTA input, vectorized.

Behavioral contract follows the reference parser
(SibeliaZ-LCB/common/streamfastaparser.{h,cpp}):

  * record name = first whitespace-separated token of the header line
    (streamfastaparser.cpp:43-55),
  * sequence characters are uppercased — soft-masking is NOT respected
    (streamfastaparser.cpp:80-87, reference README.md:244-249),
  * any character outside "ACGTURYKMSWBDHWNXV" raises an error,
  * whitespace inside the sequence body is skipped.

Unlike the reference's char-at-a-time stream (1 MiB buffer), we read whole
files and process them with numpy — the host-side cost is one pass of table
lookups, which keeps ingest off the critical path before device transfer.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List

import numpy as np

from sibeliaz_tpu_torch.core import alphabet


@dataclasses.dataclass
class FastaRecord:
    name: str  # first token of the header
    seq: np.ndarray  # uint8 ASCII, uppercase


class FastaError(ValueError):
    pass


def _parse_buffer(data: bytes, path: str) -> List[FastaRecord]:
    records: List[FastaRecord] = []
    if not data:
        return records
    arr = np.frombuffer(data, dtype=np.uint8)
    # Find header line starts: '>' at position 0 or right after a newline.
    gt = arr == ord(">")
    at_line_start = np.empty(len(arr), dtype=bool)
    at_line_start[0] = True
    at_line_start[1:] = arr[:-1] == ord("\n")
    starts = np.flatnonzero(gt & at_line_start)
    if len(starts) == 0 or starts[0] != 0:
        first = chr(arr[0])
        raise FastaError(
            f"{path}: The FASTA header should start with a '>', started with '{first}'"
        )
    bounds = np.append(starts, len(arr))
    newlines = np.flatnonzero(arr == ord("\n"))
    for i, s in enumerate(starts):
        e = bounds[i + 1]
        # Header line ends at the first newline after s (or at record end).
        j = np.searchsorted(newlines, s)
        hdr_end = newlines[j] if j < len(newlines) and newlines[j] < e else e
        header = data[s + 1 : hdr_end].decode("ascii", errors="replace")
        name = header.split()[0] if header.split() else ""
        body = arr[hdr_end:e]
        body = alphabet.to_upper(body)
        # Drop all whitespace (space, \t, \n, \r, \v, \f).
        ws = (
            (body == ord(" "))
            | (body == ord("\t"))
            | (body == ord("\n"))
            | (body == ord("\r"))
            | (body == 0x0B)
            | (body == 0x0C)
        )
        seq = body[~ws]
        bad = ~alphabet.is_valid(seq)
        if bad.any():
            ch = chr(seq[np.argmax(bad)])
            raise FastaError(
                f"{path}: Found an invalid character '{ch}' in sequence {name}"
            )
        records.append(FastaRecord(name=name, seq=np.ascontiguousarray(seq)))
    return records


def read_fasta(path: str) -> List[FastaRecord]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":  # gzip magic — .fa.gz inputs just work
        import gzip

        data = gzip.decompress(data)
    return _parse_buffer(data, path)


def read_many(paths: Iterable[str]) -> List[FastaRecord]:
    """Read several FASTA files; records keep file order then record order,
    matching the reference's global chromosome numbering
    (junctionstorage.h:620-633)."""
    out: List[FastaRecord] = []
    for p in paths:
        out.extend(read_fasta(p))
    return out


def write_fasta(path: str, records: Iterable[FastaRecord], width: int = 80) -> None:
    with open(path, "wb") as f:
        for r in records:
            f.write(b">" + r.name.encode("ascii") + b"\n")
            s = r.seq.tobytes()
            for i in range(0, len(s), width):
                f.write(s[i : i + width] + b"\n")
