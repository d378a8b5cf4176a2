"""Traffic kind `strains`: the strain collection of `bench.py::make_input`
(its seed is 2024): one random base, each strain a copy with point
mutations and an inversion in every third strain; optional `repeats` then
insert copies of shared repeat families into every strain from a second
stream of the same seed, so the strains themselves are those of the plain
mix."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.lib.genomes import Genome, decode, reverse_complement


def generate(rng: np.random.Generator, p: Dict, seed: int) -> List[Genome]:
    n, length, mut = p["strains"], p["length"], p["divergence"]
    base = decode(rng.integers(0, 4, size=length).astype(np.uint8))
    seqs = []
    for g in range(n):
        s = base.copy()
        pos = np.flatnonzero(rng.random(length) < mut)
        # one draw a mutated base, in position order: bench.py's stream
        s[pos] = decode(rng.integers(0, 4, size=len(pos)).astype(np.uint8))
        if g % p["inversion_every"] == 1:
            lo = int(rng.integers(0, length // 2))
            hi = lo + int(rng.integers(length // 8, length // 4))
            s[lo:hi] = reverse_complement(s[lo:hi])
        seqs.append(s)
    if p.get("repeats"):
        seqs = insert_repeats(np.random.default_rng([seed, 1]), seqs, p["repeats"])
    return [[(f"Strain{g + 1}.Chr1", s)] for g, s in enumerate(seqs)]


def insert_repeats(rng: np.random.Generator, seqs: List[np.ndarray], families) -> List[np.ndarray]:
    """Insert into every sequence `copies` copies of each family, each at a
    point and on a strand of its own, each copy `divergence` of its
    family's consensus (that many bases drawn anew, at distinct
    positions); the consensus is the same in every sequence."""
    consensus = [decode(rng.integers(0, 4, size=f["length"]).astype(np.uint8))
                 for f in families]
    out = []
    for s in seqs:
        pieces = []
        for f, cons in zip(families, consensus):
            for _ in range(f["copies"]):
                c = cons.copy()
                n_mut = int(f["divergence"] * len(c))
                pos = rng.choice(len(c), size=n_mut, replace=False)
                c[pos] = decode(rng.integers(0, 4, size=n_mut).astype(np.uint8))
                if rng.random() < 0.5:
                    c = reverse_complement(c)
                pieces.append(c)
        # distinct insertion points, so no two copies overlap
        points = np.sort(rng.choice(len(s) + 1, size=len(pieces), replace=False))
        order = rng.permutation(len(pieces))
        parts, last = [], 0
        for pt, i in zip(points, order):
            parts += [s[last:pt], pieces[i]]
            last = pt
        parts.append(s[last:])
        out.append(np.concatenate(parts))
    return out
