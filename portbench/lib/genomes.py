"""Genome generators of the benchmark's traffic, numpy only.

A traffic file (`portbench/traffic/<name>.json`) names a generator by its
`kind` and gives its parameters; the generator is the file
`portbench/generators/<kind>.py`, whose `generate(rng, params, seed)`
returns a list of genomes, each a list of (record name, uint8 ASCII
sequence).  The run's `--seed` seeds it, and the same seed gives the same
genomes byte for byte.  A new kind is a new file there.

A mix with `content_seed` makes the same genomes for every run seed (from
`content_seed`) and lets the run seed choose only their order: the
genomes' order and one order of the sequences within every genome.  The
work a pass does then depends little on the seed (PERF.md, Open questions:
on this pipeline the genomes' content moved a pass's time 3x).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from portbench.lib import registry

DEFINITE = np.frombuffer(b"ACGT", dtype=np.uint8)
COMPLEMENT = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in ((b"A", b"T"), (b"T", b"A"), (b"C", b"G"), (b"G", b"C")):
    COMPLEMENT[ord(_a)] = ord(_b)

Genome = List[Tuple[str, np.ndarray]]


def decode(codes) -> np.ndarray:
    return DEFINITE[codes]


def reverse_complement(seq: np.ndarray) -> np.ndarray:
    return COMPLEMENT[seq][::-1]


def generate(traffic: Dict, seed: int, here: str = registry.HERE) -> List[Genome]:
    make = registry.generator(traffic["kind"], here)
    content = traffic.get("content_seed", seed)
    genomes = make(np.random.default_rng(content), traffic, content)
    if "content_seed" in traffic:
        order = np.random.default_rng([seed, 3])
        within = order.permutation(max(len(g) for g in genomes))
        genomes = [[g[i] for i in within if i < len(g)] for g in genomes]
        genomes = [genomes[i] for i in order.permutation(len(genomes))]
    return genomes


def write_fasta(path: str, genome: Genome, width: int = 80) -> None:
    """One FASTA file a genome, `width` bases a line."""
    with open(path, "wb") as f:
        for name, seq in genome:
            f.write(b">" + name.encode("ascii") + b"\n")
            s = seq.tobytes()
            for i in range(0, len(s), width):
                f.write(s[i:i + width] + b"\n")
