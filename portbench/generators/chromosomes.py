"""Traffic kind `chromosomes`: the repository's large example
(`examples/large/make_large_example.py`, whose SEED is 33): random
ancestral chromosomes, each genome a copy of them with point mutations,
inversions, and deletions on the genomes after the first.  Same draws in
the same order as that script, so seed 33 writes its FASTA bytes."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from portbench.lib.genomes import Genome, decode, reverse_complement


def generate(rng: np.random.Generator, p: Dict, seed: int) -> List[Genome]:
    n_chr, chr_len, mut = p["chromosomes"], p["chromosome_length"], p["divergence"]
    inv_n, inv_lo, inv_hi = p["inversions"], p["inversion_min"], p["inversion_max"]
    del_n, del_lo, del_hi = p["deletions"], p["deletion_min"], p["deletion_max"]
    ancestors = [decode(rng.integers(0, 4, size=chr_len).astype(np.uint8))
                 for _ in range(n_chr)]
    genomes = []
    for g in range(p["genomes"]):
        recs = []
        for c, anc in enumerate(ancestors):
            s = anc.copy()
            pos = np.flatnonzero(rng.random(len(s)) < mut)
            s[pos] = decode(rng.integers(0, 4, size=len(pos)).astype(np.uint8))
            for _ in range(inv_n):
                lo = int(rng.integers(0, len(s) - inv_hi))
                hi = lo + int(rng.integers(inv_lo, inv_hi))
                s[lo:hi] = reverse_complement(s[lo:hi])
            if g > 0 and del_n:
                cuts = sorted(rng.integers(0, len(s), size=del_n))
                parts, last = [], 0
                for ct in cuts:
                    parts.append(s[last:ct])
                    last = ct + int(rng.integers(del_lo, del_hi))
                parts.append(s[last:] if last < len(s) else s[:0])
                s = np.concatenate(parts)
            recs.append((f"genome{g + 1}.chr{c + 1}", s))
        genomes.append(recs)
    return genomes
