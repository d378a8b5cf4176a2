"""MAF parsing/writing shared by the post-processing tools (behavioral
contract: the `s`-line tuple layout used throughout the reference's helper
scripts, maf_to_gfa1.py:9-35)."""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, TextIO


@dataclasses.dataclass
class MafRecord:
    seq_name: str
    start: int
    size: int
    strand: str
    seq_size: int
    body: str

    def pos_start(self) -> int:
        """+ strand start of the interval this record covers."""
        if self.strand == "+":
            return self.start
        return self.seq_size - (self.start + self.size)


MafBlock = List[MafRecord]


def parse_maf(path: str) -> Iterator[MafBlock]:
    group: MafBlock = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line[0] == "a":
                if group:
                    yield group
                group = []
            elif line[0] == "s":
                p = line.split()
                group.append(
                    MafRecord(
                        seq_name=p[1],
                        start=int(p[2]),
                        size=int(p[3]),
                        strand=p[4],
                        seq_size=int(p[5]),
                        body=p[6],
                    )
                )
    if group:
        yield group


def write_maf(blocks, handle: TextIO, header: bool = True) -> None:
    if header:
        handle.write("##maf version=1\n")
    for group in blocks:
        handle.write("\na\n")
        for r in group:
            handle.write(
                f"s\t{r.seq_name}\t{r.start}\t{r.size}\t{r.strand}\t"
                f"{r.seq_size}\t{r.body}\n"
            )
