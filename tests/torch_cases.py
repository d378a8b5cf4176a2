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


def class_case(name, rows=None, k=15):
    """Code streams that stress the class analysis: tandem repeats, a
    poly-A/poly-T class of thousands of rows, N-separated chromosomes; and
    `poly_a_rows`: a poly-A and a poly-T run whose all-A windows of k (key 0,
    so rows 0.. of the sorted stream) number exactly `rows`."""
    rng = np.random.default_rng(3)
    if name == "poly_a_rows":
        a = rows // 2 + k - 1  # a run of L gives L - k + 1 windows
        t = rows - rows // 2 + k - 1
        flanks = [rng.integers(0, 4, size=400).astype(np.uint8) for _ in range(3)]
        for f in flanks:  # no flank base next to a run extends it
            f[[0, -1]] = 1
        return np.concatenate([flanks[0], np.zeros(a, np.uint8), flanks[1],
                               np.full(t, 3, np.uint8), flanks[2]])
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


K1_KINDS = ("tile_edge_runs", "all_n", "no_n", "n_every_other", "random_bytes",
            "long_tail")


def k1_case(kind, n, tile, seed=0):
    """K1's raw inputs as its signature allows them, not only as
    pack_codes_host makes them: N runs laid against a tile of `tile`
    positions (a whole tile of N from one edge to the next, runs of 33 that
    end or start at an edge: `tile_edge_runs`); no definite position; no N;
    an N every other position; random bytes as codes2 with N runs, so that
    code bits are set under indefinite positions (`random_bytes`); the same
    with codes2 and nmask longer than needed and garbage in the tail
    (`long_tail`).  The validity bits past n are always random.

    Returns (codes2, nmask) uint8 numpy arrays: >= ceil(n/4) and ceil(n/8)
    bytes."""
    rng = np.random.default_rng([seed, K1_KINDS.index(kind), n, tile])
    size = -(-n // 8) * 8
    definite = rng.random(size) < 0.5  # the part past n is garbage
    definite[:n] = True
    if kind == "tile_edge_runs":
        for m, edge in enumerate(range(tile, n, tile)):
            if m % 3 == 0:
                definite[edge : min(n, edge + tile)] = False
            elif m % 3 == 1:
                definite[edge - 33 : edge] = False
            else:
                definite[edge : min(n, edge + 33)] = False
    elif kind == "all_n":
        definite[:n] = False
    elif kind == "n_every_other":
        definite[1:n:2] = False
    elif kind in ("random_bytes", "long_tail"):
        for _ in range(max(1, n // 200)):
            lo = int(rng.integers(0, n))
            definite[lo : min(n, lo + int(rng.integers(1, 40)))] = False
    codes = rng.integers(0, 4, size=-(-n // 4) * 4)
    if kind not in ("random_bytes", "long_tail"):
        codes[:n][~definite[:n]] = 0  # as pack_codes_host leaves them
    quads = codes.reshape(-1, 4)
    codes2 = (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
              | (quads[:, 3] << 6)).astype(np.uint8)
    nmask = np.packbits(definite, bitorder="little")
    if kind == "long_tail":
        codes2 = np.concatenate([codes2, rng.integers(0, 256, size=37).astype(np.uint8)])
        nmask = np.concatenate([nmask, rng.integers(0, 256, size=19).astype(np.uint8)])
    return codes2, nmask


def k1_codes(codes2, nmask, n):
    """The per-position codes K1's inputs stand for, BAD_CODE where not
    definite: the JAX package's front half takes these."""
    q = np.arange(n)
    definite = (nmask[q >> 3] >> (q & 7)) & 1
    code = (codes2[q >> 2] >> ((q & 3) * 2)) & 3
    return np.where(definite > 0, code, BAD_CODE).astype(np.uint8)


INVALID_CANON = 1 << 62  # kernels.INVALID_CANON
CLASS_RUN_KINDS = ("tile_edges", "tile_start", "invalid_middle", "one_run",
                   "one_run_plain", "all_distinct", "geometric")


def _run_lengths(kind, n, tile, rng):
    if kind == "one_run" or kind == "one_run_plain":
        return np.array([n])
    if kind == "all_distinct":
        return np.ones(n, np.int64)
    if kind == "geometric":  # heavy-tailed: mostly short, some of many tiles
        lengths = np.minimum(rng.zipf(1.4, size=n), 5 * tile)
    else:
        cycle = {
            "tile_edges": [tile - 1, tile, tile + 1, 2 * tile + 1, 1, 2],
            # every second boundary falls exactly on a tile start
            "tile_start": [tile, 2 * tile, tile - 5, 5, 3 * tile + 1, tile - 1],
            "invalid_middle": [3, tile + 7, 1, 2 * tile, 40, tile - 1],
        }[kind]
        lengths = np.resize(np.array(cycle), n // sum(cycle) * len(cycle) + len(cycle))
    ends = np.cumsum(lengths)
    cut = int(np.searchsorted(ends, n)) + 1
    lengths = lengths[:cut].copy()
    lengths[-1] -= int(ends[cut - 1]) - n
    return lengths[lengths > 0]


def class_runs(kind, n, tile, seed=0):
    """Hand-laid rows for K2, given as runs of equal keys (its classes), laid
    out against a tile of `tile` rows: runs of tile - 1, tile, tile + 1 and
    2 tile + 1 rows (`tile_edges`); runs that start exactly at tile starts
    (`tile_start`); invalid-key runs between valid ones (`invalid_middle`:
    the keys are then no longer sorted, only adjacent); the whole input as
    one run, a junction by its last row (`one_run`) or no junction
    (`one_run_plain`); every row distinct; heavy-tailed lengths.  Keys grow
    by 1, by 2^32 (equal low words) or by a random step; packed words carry
    one right and one left extension each, the run's own or, in every
    other run, random ones (so the first run is a junction), rare boundary
    bits, and random bits the verdict ignores.

    Returns (key int64, packed int32, pos int32) numpy arrays of n rows."""
    rng = np.random.default_rng([seed, CLASS_RUN_KINDS.index(kind), n, tile])
    lengths = _run_lengths(kind, n, tile, rng)
    runs = len(lengths)
    steps = rng.choice(np.array([1, 1 << 32, 0]), size=runs)
    steps[steps == 0] = rng.integers(1, 1 << 30, size=int((steps == 0).sum()))
    run_key = np.cumsum(steps).astype(np.int64)
    if kind == "invalid_middle":
        run_key[2::3] = INVALID_CANON
    key = np.repeat(run_key, lengths)
    # each run's extensions, and how often its rows take random ones
    right = np.repeat(rng.integers(0, 5, size=runs), lengths)
    left = np.repeat(rng.integers(0, 5, size=runs), lengths)
    mixed = np.repeat(np.resize(np.array([0.5, 0.0, 0.01, 0.0]), runs), lengths)
    if kind in ("one_run", "one_run_plain"):
        mixed[:] = 0.0
    odd = rng.random(n) < mixed
    right[odd] = rng.integers(0, 5, size=int(odd.sum()))
    left[odd] = rng.integers(0, 5, size=int(odd.sum()))
    if kind == "one_run":  # the verdict turns at the class's last row
        right[:] = right[0] % 4
        right[-1] = (right[0] + 1) % 4
    packed = (1 << right) | (1 << (left + 5))
    if kind not in ("one_run", "one_run_plain"):
        packed |= (rng.random(n) < 2e-4).astype(np.int64) << 10
    packed |= rng.integers(0, 2, size=n) << 11  # orientation
    packed |= (rng.random(n) < 0.1) * (rng.integers(0, 1 << 19, size=n) << 12)
    pos = rng.integers(0, 1 << 31, size=n)
    return key, packed.astype(np.int32), pos.astype(np.int32)


ROUND_ROW_KINDS = ("random", "repeats", "one_class", "all_invalid", "sparse", "tile_runs",
                   "all_rounds")
# the round hash's multipliers (kernels.MIX, MIX2) as unsigned 64-bit
# numbers, and the inverse of MIX modulo 2^64
_MIX, _MIX2 = 0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F
_MIX_INV = pow(_MIX, -1, 1 << 64)


def keys_of_bucket(values, limbs, rng):
    """Random valid key limbs whose round hash, before the modulo, is each
    of `values` (< 2^31): bits 32-62 of key * MIX (two limbs: hi * MIX xor
    lo * MIX2), so that the round of row i is values[i] % n_rounds.  The
    product is inverted modulo 2^64, with random other bits, until the
    (high) limb is a valid key.  Returns a (limbs, len(values)) int64
    array."""
    values = np.asarray(values, np.uint64)
    out = np.zeros((limbs, len(values)), np.int64)
    todo = np.arange(len(values))
    while len(todo):
        h = ((rng.integers(0, 2, size=len(todo)).astype(np.uint64) << np.uint64(63))
             | (values[todo] << np.uint64(32))
             | rng.integers(0, 1 << 32, size=len(todo)).astype(np.uint64))
        lo = rng.integers(0, INVALID_CANON, size=len(todo)).astype(np.uint64)
        if limbs == 2:
            h = h ^ (lo * np.uint64(_MIX2))
        hi = h * np.uint64(_MIX_INV)
        ok = hi < np.uint64(INVALID_CANON)
        out[0, todo[ok]] = hi[ok].astype(np.int64)
        if limbs == 2:
            out[1, todo[ok]] = lo[ok].astype(np.int64)
        todo = todo[~ok]
    return out


def round_rows(kind, m, limbs, seed=0, hot=0, tile=None):
    """One chunk's rows for K4 (round_append): `limbs` int64 key limbs and
    an int32 word per row.  `random`: random valid keys, about one row in 16
    invalid (key (INVALID_CANON, 0)); `repeats`: keys drawn from 37 values,
    so that each round takes rows from every tile; `one_class`: one key
    throughout, so that one round takes every row; `all_invalid`: no row is
    kept.  Words carry random bits above the 12 the payload keeps.

    Three kinds lay rounds out by the kernel's tile (`tile` rows: pass
    kernels.K4_TILE_ROWS) and the round hash value `hot` (before the
    modulo: pass the test's r0, and the hot rows fall in its first round
    whatever n_rounds is): `sparse`: the
    hot round's rows (and random ones) in every 5th tile only, every row of
    the tiles between invalid, so that a look-back walks past tiles with no
    kept row; `tile_runs`: the hot round's rows in runs around odd tiles,
    each starting and ending on a tile boundary, one row before it or one
    row after it, the other rows of hash values hot + 1 .. hot + 4;
    `all_rounds`: hash values hot .. hot + 63, each in every tile (every
    round of a pass of G = 64 rounds in every tile).

    Returns (tuple of key limbs, packed) as numpy arrays of m rows."""
    rng = np.random.default_rng([seed, ROUND_ROW_KINDS.index(kind), m, limbs])
    invalid = np.zeros((limbs, 1), np.int64)
    invalid[0] = INVALID_CANON
    if kind == "random":
        key = rng.integers(0, INVALID_CANON, size=(limbs, m))
        invalid = rng.random(m) < 1 / 16
        key[0, invalid] = INVALID_CANON
        key[1:, invalid] = 0
    elif kind == "repeats":
        key = rng.integers(0, INVALID_CANON, size=(limbs, 37))[:, rng.integers(0, 37, size=m)]
    elif kind == "one_class":
        key = np.repeat(rng.integers(0, INVALID_CANON, size=(limbs, 1)), m, axis=1)
    elif kind == "sparse":
        key = np.repeat(invalid, m, axis=1)
        hot_keys = keys_of_bucket(np.full(8, hot), limbs, rng)
        for lo in range(0, m, 5 * tile):
            n = min(tile, m - lo)
            rows = rng.integers(0, INVALID_CANON, size=(limbs, n))
            is_hot = rng.random(n) < 0.5
            rows[:, is_hot] = hot_keys[:, rng.integers(0, 8, size=int(is_hot.sum()))]
            rows[:, rng.random(n) < 1 / 16] = invalid
            key[:, lo : lo + n] = rows
    elif kind == "tile_runs":
        others = keys_of_bucket(hot + 1 + np.arange(8) % 4, limbs, rng)
        key = others[:, rng.integers(0, 8, size=m)]
        hot_keys = keys_of_bucket(np.full(3, hot), limbs, rng)
        edges = ((0, 0), (-1, 1), (1, -1), (0, 1), (-1, 0), (1, 0), (0, -1))
        for j, t in enumerate(range(1, -(-m // tile), 2)):
            start, end = edges[j % len(edges)]
            lo, hi = max(0, t * tile + start), min(m, (t + 1) * tile + end)
            key[:, lo:hi] = hot_keys[:, rng.integers(0, 3, size=hi - lo)]
    elif kind == "all_rounds":
        values = np.concatenate([hot + rng.permutation(np.arange(min(tile, m - lo)) % 64)
                                 for lo in range(0, m, tile)])
        key = keys_of_bucket(values, limbs, rng)
    else:
        key = np.repeat(invalid, m, axis=1)
    packed = rng.integers(0, 1 << 31, size=m).astype(np.int32)
    return tuple(np.ascontiguousarray(key[i], dtype=np.int64) for i in range(limbs)), packed


LIMB_SPLITS = ("hi", "lo", "both")


def split_limbs(key, split):
    """One-limb keys as two-limb keys (hi, lo) with the same runs: the runs
    change on the high limb alone (`hi`: lo is 0 throughout), on the low
    limb alone (`lo`: hi is 0 on every valid row) or on both (`both`: the
    low 20 bits in lo, the rest in hi, so class_runs' steps of 1 change lo,
    of 2^32 hi, and random steps mostly both).  An invalid key stays
    invalid: (INVALID_CANON, 0)."""
    valid = key != INVALID_CANON
    hi, lo = {"hi": (key, np.zeros_like(key)),
              "lo": (np.zeros_like(key), key),
              "both": (key >> 20, key & ((1 << 20) - 1))}[split]
    return np.where(valid, hi, INVALID_CANON), np.where(valid, lo, 0)


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


def far_pred_block(rng, base_len, cut_len):
    """A base with a poly-A stretch of `cut_len` between A-free flanks, a
    copy without the stretch (under linear gaps only such a deletion stays
    in one piece: the rank after it gets a predecessor `cut_len` ranks back)
    and a mutated copy to align."""
    base = ACGT[rng.integers(1, 4, size=base_len)]
    cut = int(rng.integers(base_len // 8, base_len // 2))
    base[cut : cut + cut_len] = ACGT[0]
    last = base.copy()
    for p in np.flatnonzero(rng.random(base_len) < 0.04):
        last[p] = ACGT[rng.integers(0, 4)]
    return [base, np.delete(base, slice(cut, cut + cut_len)), last]


def many_preds_block(rng, base_len):
    """Seven copies that diverge at the columns `cols`: the three other
    letters at the column and deletions of one, two and three bases ending
    there, so the rank after each column has seven predecessor slots, several
    of them scoring alike; then a mutated copy to align."""
    base = ACGT[rng.integers(0, 4, size=base_len)]
    cols = range(base_len // 6, base_len - 8, base_len // 6)
    seqs = [base]
    for k in range(1, 4):
        seq = base.copy()
        for c in cols:
            seq[c] = ACGT[(int(np.flatnonzero(ACGT == base[c])[0]) + k) % 4]
        seqs.append(seq)
    for k in range(1, 4):
        keep = np.ones(base_len, bool)
        for c in cols:
            keep[c - k + 1 : c + 1] = False
        seqs.append(base[keep])
    last = base.copy()
    for p in np.flatnonzero(rng.random(base_len) < 0.05):
        last[p] = ACGT[rng.integers(0, 4)]
    for c in cols:  # the aligned copy meets every divergence with a mismatch
        last[c] = ACGT[rng.integers(0, 4)]
    return seqs + [last]


POA_KINDS = ("unbanded", "banded", "pass2", "tie_heavy", "far_pred",
             "many_preds", "odd_w")


def poa_case(name, scale=1):
    """(blocks, band_min) of one K3 dispatch: each block's last copy is
    aligned to the graph of the others.  `scale` stretches the sequences
    (the card's tests use longer ones)."""
    rng = np.random.default_rng(POA_KINDS.index(name) + 1)
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
    if name == "tie_heavy":
        return [tie_heavy_block(rng) for _ in range(2)], 16
    if name == "far_pred":  # a predecessor hundreds of ranks back
        return [far_pred_block(rng, 900 * scale, 300 * scale),
                far_pred_block(rng, 700 * scale, 40)], 16
    if name == "many_preds":  # ranks with seven predecessor slots, and ties
        return [many_preds_block(rng, 200 * scale) for _ in range(2)], 16
    if name != "odd_w":
        raise ValueError(name)
    # one unbanded block whose aligned copy is exactly the bucket's L long
    # (a power of two), so W = L + 1 is odd, against a graph of few ranks
    return [[ACGT[rng.integers(0, 4, size=60 * scale)],
             ACGT[rng.integers(0, 4, size=256 * scale)]]], 1 << 30


def spread_slots(pred_idx, pred_ok, n_max):
    """The first four predecessor slots moved to slots 1, 3, 5 and 7 (the
    others dropped): a slot mask with holes, which K3's contract takes."""
    idx = np.full_like(pred_idx, n_max)
    ok = np.zeros_like(pred_ok)
    idx[..., 1::2] = pred_idx[..., :4]
    ok[..., 1::2] = pred_ok[..., :4]
    return idx, ok


def edge_band_round(W):
    """K3's inputs laid out by hand, for windows the engine's band plan never
    cuts this close: two chain graphs of n = max(300, 2 W) ranks, each
    aligned to a mutated copy of itself, whose windows move on by one row
    per rank so that the alignment's diagonal stays in the window's last
    column (block 0) and in its middle (block 1).  A wrong cell on the
    window's edge changes the score and the traceback.

    Returns (numpy arrays in K3's argument order, n_max, W, P)."""
    rng = np.random.default_rng(W)
    n = max(300, 2 * W)
    n_max = -(-(n + n // 4) // 8) * 8
    seq_b = np.zeros((2, n + 1 + W), np.uint8)
    len_b = np.full(2, n, np.int32)
    char_b = np.zeros((2, n_max), np.uint8)
    pi_b = np.full((2, n_max, 8), n_max, np.int32)
    po_b = np.zeros((2, n_max, 8), bool)
    sink_b = np.zeros((2, n_max), bool)
    off_b = np.zeros((2, n_max + 1), np.int32)
    for b, col in enumerate((W - 1, W // 2)):
        chars = ACGT[rng.integers(0, 4, size=n)]
        seq = chars.copy()
        for p in np.flatnonzero(rng.random(n) < 0.05):
            seq[p] = ACGT[rng.integers(0, 4)]
        seq_b[b, 1 : 1 + n] = seq
        char_b[b, :n] = chars
        pi_b[b, 1:n, 0] = np.arange(n - 1)
        po_b[b, :n, 0] = True
        sink_b[b, n - 1] = True
        # rank r pairs with sequence row r + 1, which is column `col`
        off_b[b, :n] = np.clip(np.arange(n) + 1 - col, 0, None)
    arrays = (seq_b, len_b, char_b, pi_b, po_b, sink_b, off_b)
    return arrays, n_max, W, n + n_max + 2


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


# tests/test_device_bundles.py's four seeded inputs (seed + 400 and the
# keyword arguments of reference_oracle.random_related_genomes), at k=15
BUNDLE_CASES = (
    (400, dict(length=2000, mut=0.02)),
    (401, dict(length=1500, mut=0.05, rearrange=True)),
    (402, dict(length=2500, mut=0.01, n_genomes=3)),
    (403, dict(length=1000, mut=0.03, n_chr=2, n_prob=0.01)),
)


def bundle_fields(bundles):
    """A bundle list as the tuples compared exactly: (vid, ch, count, rank,
    resolve), in order."""
    return [(b.vid, b.ch, b.count, b.rank, b.resolve) for b in bundles]


def related_genomes(seed, n_genomes=2, n_chr=1, length=3000, mut=0.01,
                    rearrange=False, n_prob=0.0):
    """reference_oracle.random_related_genomes through the port's alphabet
    (the same draws, the same genomes), for where JAX is absent."""
    from sibeliaz_tpu_torch.core import alphabet

    rng = np.random.default_rng(seed)
    ancestors = [alphabet.decode(rng.integers(0, 4, size=length).astype(np.uint8))
                 for _ in range(n_chr)]
    flat, names = [], []
    for g in range(n_genomes):
        for c, anc in enumerate(ancestors):
            seq = anc.copy()
            for p in np.flatnonzero(rng.random(len(seq)) < mut):
                seq[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
            if rearrange and g > 0:
                lo = int(rng.integers(0, len(seq) // 2))
                hi = lo + int(rng.integers(len(seq) // 4, len(seq) // 2))
                seq[lo:hi] = alphabet.reverse_complement(seq[lo:hi])
            if n_prob:
                seq[rng.random(len(seq)) < n_prob] = ord("N")
            flat.append(seq)
            names.append(f"Genome{g + 1}.Chr{c + 1}")
    return flat, names


def tied_table(seed, n_chr=2, length=2000, n_vertices=40, k=15):
    """A hand-laid junction table whose bundle list has ties in (count,
    rank, resolve), so that the bundle sort takes its gxx_sort branch.

    Every junction record comes twice, at one position with one signed id;
    the first copy's out-char is A and its in-char G, the second's C and T.
    So each vertex's A and C bundles have the same occurrences' chromosomes
    in the same order (equal count and rank) and the same positive-strand
    positions (equal resolve).  No graph stage makes such a table."""
    from sibeliaz_tpu_torch.core import alphabet
    from sibeliaz_tpu_torch.io.dbg import JunctionChr
    from sibeliaz_tpu_torch.junctions.table import JunctionTable

    rng = np.random.default_rng(seed)
    seqs = [alphabet.decode(rng.integers(0, 4, size=length).astype(np.uint8))
            for _ in range(n_chr)]
    records = []
    for _ in range(n_chr):
        pos = np.sort(rng.choice(np.arange(1, length - k - 1), size=length // 20, replace=False))
        ids = rng.integers(1, n_vertices, size=len(pos)) * rng.choice([-1, 1], size=len(pos))
        records.append(JunctionChr(pos=np.repeat(pos, 2).astype(np.uint32),
                                   ids=np.repeat(ids, 2).astype(np.int64)))
    table = JunctionTable.build(records, seqs, [f"chr{c}" for c in range(n_chr)], k, 1 << 30)
    second = table.occ_idx % 2 == 1
    table.occ_ch[:] = np.where(second, ord("C"), ord("A"))
    table.occ_revch[:] = np.where(second, ord("T"), ord("G"))
    return table


SHARD_EDGE_KINDS = ("n_on_edges", "separator_on_edges", "edge_before_junction",
                    "edge_on_junction", "edge_after_junction", "class_on_every_shard",
                    "poly_a_skew", "shorter_than_k", "more_shards_than_positions",
                    "all_n_shards")


def shard_edge_case(kind, seed=0):
    """(seqs as ASCII uint8 arrays, n_shards, junction) laid out against the
    sharded graph stage's shard edges (parallel/sharded.shard_bounds: shard
    s of n starts at s * n_total // n in 'N' + seq_0 + 'N' + ... + 'N', so
    chromosome position p of one chromosome is global position p + 1).
    `junction` is a chromosome-0 position that must be a junction, or None.

    n_on_edges: 'N' at the first shard edge and one byte either side of the
    others; separator_on_edges: chromosome separators on two edges;
    edge_before/on/after_junction: a 64 bp unit copied twice into random
    flanks whose last bases differ, so that the window at the second copy's
    start is a junction, with a shard edge one position before it, on it,
    or one after it; class_on_every_shard: the unit copied
    into each quarter (the last copy reverse-complemented); poly_a_skew: a
    3 kbp poly-A and a (CATTC)n array, so that one owner gets most rows;
    shorter_than_k: 8 shards of ~5 positions; more_shards_than_positions:
    8 shards of 7 positions in all; all_n_shards: two whole shards of
    'N'."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)]

    if kind == "n_on_edges":  # n_total 401: edges 100, 200, 300
        seq = rand(399)
        seq[[99, 198, 300]] = ord("N")
        return [seq], 4, None
    if kind == "separator_on_edges":  # separators at 100, 200 (and 400)
        return [rand(99), rand(99), rand(199)], 4, None
    unit = rand(64)
    if kind.startswith("edge_"):
        d = {"edge_before_junction": -1, "edge_on_junction": 0, "edge_after_junction": 1}[kind]
        r1, r2 = rand(200), rand(200)
        r1[-1], r2[-1] = ord("A"), ord("C")  # two left extensions of the unit's first window
        u1 = len(r1) + len(unit) + len(r2)  # the second copy's start
        # two shards: the edge n_total // 2 at global u1 + 1 + d
        seq = np.concatenate([r1, unit, r2, unit, rand(u1 + 2 * d - len(unit))])
        return [seq], 2, u1
    if kind == "class_on_every_shard":
        rc = np.frombuffer(b"TGCA", np.uint8)[
            np.searchsorted(np.frombuffer(b"ACGT", np.uint8), unit)][::-1]
        parts = []
        for q in range(4):
            parts += [rand(200 + 7 * q), unit if q < 3 else rc, rand(236 - 7 * q)]
        return [np.concatenate(parts)], 4, None
    if kind == "poly_a_skew":
        return [np.concatenate([rand(500), np.full(3000, ord("A"), np.uint8), rand(500),
                                np.frombuffer(b"CATTC" * 300, np.uint8), rand(300)])], 4, None
    if kind == "shorter_than_k":
        base = rand(20)
        return [np.concatenate([base, base[:14], rand(6)])], 8, None
    if kind == "more_shards_than_positions":
        return [rand(5)], 8, None
    if kind == "all_n_shards":  # n_total 1202: shards [300, 601), [601, 901) all N
        return [np.concatenate([rand(250), np.full(700, ord("N"), np.uint8), rand(250)])], 4, None
    raise ValueError(kind)


def repeat_genomes(seed, copies, unit=100, spacer=40, n_genomes=2):
    """Genomes that share `copies` exact copies of one random unit, each
    copy between random spacers: the unit's first and last k-mers are
    junctions with `copies` occurrences, one bundle each (`copies` past the
    fused engine's slab widths sends the bundle to a wider slab, or past
    I_CAP to the host oracle).  The copies are spread over the genomes, so
    the bundle's instances span chromosomes."""
    from sibeliaz_tpu_torch.core import alphabet

    rng = np.random.default_rng(seed)

    def rand(n):
        return alphabet.decode(rng.integers(0, 4, size=n).astype(np.uint8))

    motif = rand(unit)
    seqs = []
    for g in range(n_genomes):
        parts = [rand(spacer)]
        for _ in range(copies // n_genomes + (g < copies % n_genomes)):
            parts += [motif, rand(spacer)]
        seqs.append(np.concatenate(parts))
    return seqs, [f"Genome{g + 1}" for g in range(n_genomes)]


def state_arrays(x, prefix=""):
    """Any nesting of dicts and dataclasses over arrays (torch tensors,
    numpy or JAX arrays, ints) as {dotted path: numpy array}: the fused
    LCB engine's tables, lanes and carry, from either package."""
    import dataclasses

    if isinstance(x, dict):
        items = x.items()
    elif dataclasses.is_dataclass(x):
        items = ((f.name, getattr(x, f.name)) for f in dataclasses.fields(x))
    else:
        if hasattr(x, "detach"):
            x = x.detach().cpu()
        return {prefix: np.asarray(x)}
    out = {}
    for key, value in items:
        out.update(state_arrays(value, f"{prefix}.{key}" if prefix else key))
    return out


def state_diff(a, b):
    """The paths at which two state_arrays differ (or exist in one only)."""
    fa, fb = state_arrays(a), state_arrays(b)
    return sorted(set(fa) ^ set(fb)) + [
        key for key in fa if key in fb and not np.array_equal(fa[key], fb[key])]


# ---- K5 lcb_walk: lane states and walk arguments from the port alone -------


def walk_genomes(seed, copies=100, unit=80, spacer=50):
    """Genomes in which a walk outgrows a narrow instance slab: a segment X
    occurs twice in the first genome, once followed by a unit W, and W
    occurs `copies` times in the second, between random spacers.  A lane at
    X's end that pushes W's first junction meets W's other copies far from
    its instances, and each of them is one instance more."""
    from sibeliaz_tpu_torch.core import alphabet

    rng = np.random.default_rng(seed)

    def rand(n):
        return alphabet.decode(rng.integers(0, 4, size=n).astype(np.uint8))

    x, w = rand(60), rand(unit)
    first = np.concatenate([rand(200), x, w, rand(200), x, rand(200)])
    parts = [rand(spacer)]
    for _ in range(copies):
        parts += [w, rand(spacer)]
    return [first, np.concatenate(parts)], ["Genome1", "Genome2"]


def walk_lanes(eng, L, IC, PC, device, bundles=None):
    """Lanes seeded at (IC, PC) by resident._seed_lanes_device from the
    first L bundles whose vertex's occurrences fit IC (or `bundles`), as a
    ResidentState whose three slabs share their tensors, as both engines
    seed them.  Returns (tables, state, the seeded lanes' count)."""
    import torch

    from sibeliaz_tpu_torch.lcb import resident
    from sibeliaz_tpu_torch.lcb.device_bundles import make_bundles_device

    if bundles is None:
        occ = np.diff(eng.t.occ_off)
        bundles = [bd for bd in make_bundles_device(eng.t, "cpu") if occ[abs(bd.vid)] <= IC][:L]
    tb = resident._device_tables(eng, device)
    ln, _, ovf = resident._seed_lanes_device(tb, bundles, L, IC, PC)
    assert not bool(ovf.any())
    zero = torch.zeros(L, dtype=torch.int64, device=device)
    return tb, resident.ResidentState(ln, ln, ln, zero, zero.bool()), len(bundles)


def walk_args(eng, st, n_lanes, rng, reach=4):
    """Walk arguments [rows, c, i, s, fwd, tvid] (numpy) for every seeded
    lane with an instance: from its first instance, in a random direction,
    to the vertex 1 to `reach` junctions on (where the chromosome holds
    one): walks of several pushes, which the protocol's votes rarely
    make."""
    t = eng.t
    chr_, idx, strand = (getattr(st.ln, f)[:, 0].cpu().numpy() for f in ("chr", "bi", "s"))
    n = st.ln.n.cpu().numpy()
    out = []
    for lane in np.flatnonzero(n[:n_lanes] > 0):
        c, i, s = int(chr_[lane]), int(idx[lane]), int(strand[lane])
        fwd = bool(rng.random() < 0.5)
        step = s if fwd else -s
        for d in rng.permutation(np.arange(reach, 0, -1)):
            j = i + step * int(d)
            if 0 <= j < t.chr_off[c + 1] - t.chr_off[c]:
                out.append((lane, c, i, s, fwd, s * int(t.jid_flat[t.chr_off[c] + j])))
                break
    return [np.array(col, dtype=np.bool_ if q == 4 else np.int64)
            for q, col in enumerate(zip(*out))]


def with_sentinel_rows(args, L, rng):
    """The walk arguments [rows, c, i, s, fwd, tvid] shuffled, with
    sentinel rows (row L, as the engines pad them) first, last and right
    after lane L-1's row, which must be among them."""
    rows = args[0]
    assert L - 1 in rows
    pad = [L, 0, 0, 1, False, 1 << 60]
    order = list(rng.permutation(len(rows)))
    at = order.index(int(np.flatnonzero(rows == L - 1)[0]))
    order[at + 1:at + 1] = [-1]
    order[:0] = [-1]
    order.append(-1)
    return [np.array([a[q] if q >= 0 else p for q in order], dtype=np.asarray(a).dtype)
            for a, p in zip(args, pad)]


def walk_tensors(args, device):
    """Walk arguments as the wrapper takes them: rows, c, i, s, fwd, tvid
    on `device`."""
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in args]
