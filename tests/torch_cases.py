"""Seeded numpy inputs shared by the port's tests (no JAX, so the card's
tests can use them where JAX is not installed)."""

import numpy as np

BAD_CODE = 255  # alphabet.BAD_CODE: a position that is not A, C, G or T


def codes_with_n_runs(seed, n, n_runs, n_at_ends=False):
    """Random 2-bit codes with `n_runs` runs of BAD_CODE (1-39 long)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    for _ in range(n_runs):
        lo = int(rng.integers(0, n))
        codes[lo : lo + int(rng.integers(1, 40))] = BAD_CODE
    if n_at_ends:
        codes[:3] = BAD_CODE
        codes[-2:] = BAD_CODE
    return codes


def class_case(name):
    """Code streams that stress the class analysis: tandem repeats, a
    poly-A/poly-T class of thousands of rows, N-separated chromosomes."""
    rng = np.random.default_rng(3)
    if name == "repeat_heavy":
        unit = rng.integers(0, 4, size=40).astype(np.uint8)
        rc = (3 - unit)[::-1]
        return np.concatenate([unit] * 30 + [rc] * 10 + [unit[:17]] * 5)
    if name == "poly_a":
        return np.concatenate(
            [
                rng.integers(0, 4, size=500).astype(np.uint8),
                np.zeros(3000, np.uint8),  # one class of ~3000 rows
                rng.integers(0, 4, size=500).astype(np.uint8),
                np.full(800, 3, np.uint8),  # poly-T: the same class, rc
            ]
        )
    if name != "n_separated":
        raise ValueError(name)
    parts = []
    for _ in range(4):
        chrom = rng.integers(0, 4, size=int(rng.integers(300, 900))).astype(np.uint8)
        chrom[rng.random(len(chrom)) < 0.02] = BAD_CODE
        parts += [chrom, np.full(1, BAD_CODE, np.uint8)]
    shared = parts[0][:200].copy()
    return np.concatenate(parts + [shared])
