"""Seeded numpy inputs shared by the port's tests and chip_smoke.py (no
JAX, so the card's tests and the smoke run can use them where JAX is not
installed)."""

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


ACGT = np.frombuffer(b"ACGT", np.uint8)


def rand_block(rng, base_len, n_copies, mut=0.08, indel=True):
    """Copies of one random base sequence with substitutions and, in most
    copies, a short deletion (tests/test_tpu_poa.py::rand_block)."""
    base = ACGT[rng.integers(0, 4, size=base_len)]
    seqs = [base]
    for _ in range(n_copies - 1):
        seq = base.copy()
        for p in np.flatnonzero(rng.random(len(seq)) < mut):
            seq[p] = ACGT[rng.integers(0, 4)]
        if indel and rng.random() < 0.6:
            cut = int(rng.integers(0, len(seq) - 4))
            seq = np.delete(seq, slice(cut, cut + int(rng.integers(1, 4))))
        seqs.append(seq)
    return seqs


def tie_heavy_block(rng, reps=30):
    """A low-complexity repeat of `reps` 10-mers and copies with one
    deletion each: the DP meets ties at almost every cell."""
    base = np.frombuffer(b"ACACACACAT" * reps, np.uint8).copy()
    seqs = [base]
    for _ in range(3):
        cut = int(rng.integers(10, len(base) - 20))
        seqs.append(np.delete(base, slice(cut, cut + int(rng.integers(2, 12)))))
    return seqs


def poa_case(name, scale=1):
    """(blocks, band_min) of one K3 dispatch: each block's last copy is
    aligned to the graph of the others.  `scale` stretches the sequences
    (the card's tests use longer ones)."""
    rng = np.random.default_rng({"unbanded": 1, "banded": 2, "pass2": 3,
                                 "tie_heavy": 4}[name])
    if name == "unbanded":  # under the default band gate of 256
        return [rand_block(rng, int(rng.integers(60, 200)) * scale,
                           int(rng.integers(2, 5))) for _ in range(3)], 256
    if name == "banded":
        return [rand_block(rng, int(rng.integers(300, 400)) * scale,
                           int(rng.integers(2, 5)), mut=0.05)
                for _ in range(3)], 16
    if name == "pass2":  # unrelated copies: pass 1 does not certify
        return [[ACGT[rng.integers(0, 4, size=300 * scale)],
                 ACGT[rng.integers(0, 4, size=280 * scale)]]], 16
    if name != "tie_heavy":
        raise ValueError(name)
    return [tie_heavy_block(rng) for _ in range(2)], 16


def poa_round(blocks, graph_cls, extract, plan, band_S=None):
    """K3's inputs for aligning each block's last copy to the graph of its
    other copies, built with the given package's PoaGraph, _extract_arrays
    and _plan_windows(ex, n, L, n_max, band_S), through the device engine's
    own round assembly (device_poa.assemble_round).

    Returns (numpy arrays in K3's argument order, n_max, W, P, S0 per block)."""
    from sibeliaz_tpu_torch.align import device_poa

    states = []
    for j, seqs in enumerate(blocks):
        st = device_poa._BlockState(seqs)
        st.graph = graph_cls()
        for s in seqs[:-1]:
            st.graph.add_sequence(s)
        st.next = len(seqs) - 1
        st.band_S = band_S[j] if band_S is not None else None
        states.append(st)
    L = device_poa._bucket_L(max(len(s) for b in blocks for s in b))
    n_max = device_poa._n_max_for(L)
    plans, arrays, W, P = device_poa.assemble_round(
        states, range(len(states)), L, n_max, 1 << 62, plan, extract)
    assert len(plans) == len(blocks), "a block fell back"
    return arrays, n_max, W, P, [p[4] for p in plans]
