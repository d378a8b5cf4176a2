"""On-card smoke run of the PyTorch/CUDA port (sibeliaz_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a machine with one CUDA card
    python3 chip_smoke.py --k3-replay DIR    # K3's development loop, see k3_replay
    python3 chip_smoke.py --k3-time KINDS    # K3's wrapper alone, see k3_time
    python3 chip_smoke.py --k2-time          # K2's wrapper alone, see k2_vs_plain
    python3 chip_smoke.py --k1-time          # K1's wrapper alone, see k1_vs_plain
    python3 chip_smoke.py --k4-time [OLDER.cu]  # K4's wrapper (and an older one), see k4_time

Phases, in order; any failure raises and the exit code is non-zero:
  1. device: the card's name and power limit, and the peak rates the
     kernels' bounds are taken against;
  2. build: compile the CUDA kernels from csrc/ (printing nvcc's register,
     shared-memory and spill report) and the native LCB and POA engines;
  3. kernels: K1 front_half and K2 class_analysis against their plain
     PyTorch versions on the card, exact, with CUDA-event times beside the
     plain versions', the sorts' (one pass, and two passes for two-limb
     keys) and each kernel's roofline bound; K1 on ten full-size input sets
     (2^24 random positions at k=15, 25, 31 and, two limbs, 33, 45, 61, the
     strains workload's positions, an N every other position at k=25 and
     61, random bytes as codes), K2 on ten full-size row sets (k=25
     random, poly-A stress, one class, all distinct, the strains workload's
     own rows; two limbs: k=33 and 61 random, the k=33 classes with hi
     equal throughout and with lo equal throughout, poly-A stress at
     k=45), each launched twice in a row;
  4. POA kernel: K3 poa_dp_tb against its plain version on eight seeded
     buckets (unbanded, banded, tie-heavy, a far predecessor, seven
     predecessor slots, an odd window of 4097, a window of 8192, a window
     of 16384 that runs in two chunks; tests/torch_cases.py's generators),
     exact, with times, the split into pre-pass, DP and traceback, the
     bound and the chain floor; three of them again cut into small chunks;
  5. small graphs: build_junctions on the card against the brute-force
     oracle on the graph tests' fixture shapes, k 3 to 61;
  6. goldens: the CLI with -n on examples/ (k=15) and on the regenerated
     reference-scale examples/large pair (k=25), byte-equal to the committed
     GFFs, and on examples/large at k=33 (two-limb keys), whose GFF's
     SHA-256 must be the JAX package's (LARGE_K33_GFF_SHA); each large run
     is a main-path run whose K1, K2 and K3 launches count (K3: none, the
     runs stop before the alignment);
  7. golden MAFs: the CLI without -n on examples/ with the native and the
     device POA engine, both byte-equal to the committed MAF; the device run
     is the main-path run whose K1, K2 and K3 launches count, and K3 is
     then held against its plain version on that run's own dispatch;
  8. examples/large alignment at the CLI's budget: the device engine's MSAs
     against the native engine's on every block of the large pair, and K3
     against its plain version on the run's largest dispatch;
  9. timed pass: the CLI on the 16 x 1 Mbp strain workload (k=15, twice;
     then once at k=33), with the graph stage's steps, LCB and total
     seconds, input Mbp/s and the peak device bytes per position;
 10. streamed graph stage: (a) K4 round_append against its plain version,
     exact, on hand-laid chunks (tests/torch_cases.py's round_rows, every
     kind, one and two limbs, G 1, 8 and 64) and on
     K1's outputs for 2^22-position chunks (one and two limbs; G = 1 and 8
     of 8, and the main paths' shapes at their plans' caps: G = 2 of 8 and
     4 of 4), with times and bounds; (b) examples/large through the pipeline
     at a budget that cuts it into 8 rounds, 2 a pass, at k=25 and k=33,
     each GFF held to its golden, the peak to the budget and one round's
     epilogue to its per-row constant; (c) the CLI with -k 33 -n -f 1 on
     the strains, whose 1 GB budget routes them to the streamed stage: the
     GFF equal to phase 9's k=33 GFF; (d) full size through
     construct.build_junctions: 2 x 512 Mbp at k=25 streamed (a budget of
     4 passes) against monolithic, and 2 x 1.1 Gbp at k=25 (2.2e9
     positions, past 2^31), which routes to the streamed stage by itself,
     each with its stage seconds, passes, rounds, junctions and peak bytes
     per position; (e) past 2^32 positions: examples/large's eight
     chromosomes, one of 2^32 N and the eight again (4.32e9 positions)
     through construct.build_junctions, which routes them to the resident
     rounds, both copies' records equal to the monolithic records of
     examples/large alone (the ids keep their ranks: every class's first
     occurrence stays in the first copy) and the filler's empty, with the
     host's available memory; (f) a class that outgrows every round:
     examples/large and a 24 Mbp (CATTC)n array at k=25, through the
     resident rounds from 8 rounds, which overflow up to 512 and hand over
     to the host-bucketed rounds, and through the host-bucketed rounds
     alone at 512 (K4 not launched), both equal to the monolithic records.
The last two lines are a JSON summary of the kernels (time, plain time,
bound, launches per main path; K1's and K2's "ms" are their one-limb
instances' and "by_limbs" holds both instances'; K4's "ms" is its shape on
the examples/large streamed passes, named in "shape", and "by_shape" holds
its eight timed shapes) and {"ok": true, "device": {...}}.  It
imports neither jax nor sibeliaz_tpu.
"""

import ctypes
import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(REPO, "examples")
LARGE_SHA = {  # tests/test_examples_dir.py LARGE_SHA
    "genome1.fa": "f44bc27bba29089c1f142796f0a4631131a8668908d83fb149aac67868e0c6cc",
    "genome2.fa": "ea148275a6a76583ddd7eff23a66fb1d48c33a4d8110d51aa770de11f2d52a89",
}
# SHA-256 of the JAX package's blocks_coords.gff at k=33 on examples/large
# (5,262 blocks): `python -m sibeliaz_tpu -k 33 -n -o OUT
# examples/large/genome1.fa examples/large/genome2.fa` after
# examples/large/make_large_example.py, on the CPU backend
LARGE_K33_GFF_SHA = "a5e711b8685569b9322b15e0e964ba578b86df6fd96619adf92204ca50120f08"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# the graph stage's measured peaks on examples/large (k=25, and k=33 with
# two-limb keys); not to rise
PEAK_B_PER_POSITION = 52.2
PEAK_B_PER_POSITION_WIDE = 68.2
SMS, INT32_LANES_PER_SM = 132, 64  # H100 SXM: 64 int32 lanes on each of 132 SMs
# What K4's function needs per row: the round hash (a 64-bit multiply as
# three 32-bit multiply-adds; two limbs: two and an XOR), its shift and
# mask (2), the modulo by n_rounds (about 12 as a multiply by the inverse
# and a correction) and the keep test (4); per kept row: its rank among its
# round's rows (a match and a population count, 4) and the payload (3).
K4_OPS_PER_ROW = 21
K4_OPS_PER_ROW_WIDE = 29
K4_OPS_PER_KEPT_ROW = 7
# clocks the card spins before K4's timed calls (cuda_ms's `ahead`): ~10 ms
AHEAD_CYCLES = 20_000_000
# the full-size pairs of phase 10d: bases per copy
PAIR_512M, PAIR_1100M = 512_000_000, 1_100_000_000
# phase 10e: the all-N chromosome between the two copies of examples/large
FILLER_N = 1 << 32
# phase 10f: the satellite array after examples/large, (CATTC)n like the
# human satellite III, and the round count its resident rounds start from
SATELLITE_UNIT, SATELLITE_BP, SATELLITE_ROUNDS = b"CATTC", 24_000_000, 8


# the graph kernels of the monolithic stage's path (K4 runs on the streamed
# stage's alone)
MONOLITHIC_KERNELS = ("front_half", "class_analysis")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(title):
    print(f"\n== {title} ==", flush=True)


def cuda_ms(torch, fn, reps, ahead=False):
    """Mean milliseconds per call of `fn` on the card, after one warm-up.
    With `ahead`, the card first spins for AHEAD_CYCLES clocks
    (torch.cuda._sleep) while the host enqueues every call, so that the time
    is the card's alone and not the host's rate of enqueueing calls shorter
    than its own overhead; the host's microseconds a call are printed beside
    it, and a host that did not finish its enqueueing within the spin fails
    the check."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin = torch.cuda.Event(enable_timing=True)
    if ahead:
        spin.record()
        torch.cuda._sleep(AHEAD_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    if ahead:
        spun = spin.elapsed_time(start)
        check(host * 1e3 < spun, f"the host took {host * 1e3:.3f} ms to enqueue {reps} calls, "
                                 f"longer than the card's spin of {spun:.3f} ms")
        print(f"  (host {host / reps * 1e6:.1f} us a call, card spun {spun:.3f} ms ahead)")
    return start.elapsed_time(end) / reps


# ---- inputs, rebuilt from the seeds the repo's own generators use -------


def random_genomes(alphabet, rng, n_chr, lo, hi, n_prob=0.0):
    """tests/test_graph.py::random_genomes."""
    seqs = []
    for _ in range(n_chr):
        L = int(rng.integers(lo, hi))
        seq = alphabet.decode(rng.integers(0, 4, size=L).astype(np.uint8))
        if n_prob:
            seq[rng.random(L) < n_prob] = ord("N")
        seqs.append(seq)
    return seqs


def mutate(alphabet, rng, seq, rate):
    """tests/test_graph.py::mutate."""
    seq = seq.copy()
    for p in np.flatnonzero(rng.random(len(seq)) < rate):
        seq[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
    return seq


def build_large(alphabet, fasta):
    """examples/large/make_large_example.py::build (seed 33, 2 x 4 x 1.5 Mbp)."""
    rng = np.random.default_rng(33)
    ancestors = [
        alphabet.decode(rng.integers(0, 4, size=1_500_000).astype(np.uint8))
        for _ in range(4)
    ]
    genomes = []
    for g in range(2):
        recs = []
        for c, anc in enumerate(ancestors):
            s = anc.copy()
            pos = np.flatnonzero(rng.random(len(s)) < 0.04)
            s[pos] = alphabet.decode(
                rng.integers(0, 4, size=len(pos)).astype(np.uint8)
            )
            for _ in range(10):
                lo = int(rng.integers(0, len(s) - 20000))
                hi = lo + int(rng.integers(2000, 20000))
                s[lo:hi] = alphabet.reverse_complement(s[lo:hi])
            if g == 1:
                cuts = sorted(rng.integers(0, len(s), size=8))
                parts, last = [], 0
                for ct in cuts:
                    parts.append(s[last:ct])
                    last = ct + int(rng.integers(200, 2000))
                parts.append(s[last:] if last < len(s) else s[:0])
                s = np.concatenate(parts)
            recs.append(fasta.FastaRecord(f"genome{g + 1}.chr{c + 1}", s))
        genomes.append(recs)
    return genomes


def bench_strains(alphabet, fasta):
    """bench.py::make_input: 16 strains x 1 Mbp, ~1% divergence, inversions."""
    length = 1_000_000
    rng = np.random.default_rng(2024)
    base = alphabet.decode(rng.integers(0, 4, size=length).astype(np.uint8))
    recs = []
    for g in range(16):
        s = base.copy()
        for p in np.flatnonzero(rng.random(length) < 0.01):
            s[p] = alphabet.decode(np.uint8(rng.integers(0, 4)))
        if g % 3 == 1:
            lo = int(rng.integers(0, length // 2))
            hi = lo + int(rng.integers(length // 8, length // 4))
            s[lo:hi] = alphabet.reverse_complement(s[lo:hi])
        recs.append(fasta.FastaRecord(f"Strain{g + 1}.Chr1", s))
    return recs


# What K1's function needs per position, whatever k: a window's 2k bits lie
# side by side in the packed stream, so the forward code is a funnel shift
# of two 64-bit words and a mask (8 32-bit operations), the reverse
# complement its complement with the bit pairs reversed (two bit reversals,
# a pair swap and a shift, 10), the canonical choice a 64-bit compare and
# select (4), validity a funnel shift and a population count of the validity
# map (4), the extension and boundary bits 4.  This is the function's need,
# not the kernel's instruction count: front_half.cu takes each window that
# way, with no step per base, plus the staging and masking it needs.
K1_OPS_PER_POSITION = 30
# Two limbs (k >= 32): each limb of fwd and of rc is its own funnel shift and
# mask (16) or bit-pair reversal (10 each, two), the canonical choice a
# two-limb compare and two selects (8), validity two runs (8), the
# extension and boundary bits 4: about 60, still far below the bytes.
K1_OPS_PER_POSITION_WIDE = 60


def bound_ms(nbytes, ops, peak_ops):
    """The roofline bound: the larger of bytes over the card's memory rate
    and operations over its peak rate; (ms, which)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@functools.lru_cache(maxsize=1)
def strains_codes(alphabet, fasta):
    """The strains workload's chromosomes joined with one N, encoded: the
    positions the graph stage takes on the timed pass (16,000,015)."""
    sep = np.array([ord("N")], np.uint8)
    return alphabet.encode(np.concatenate(
        [x for r in bench_strains(alphabet, fasta) for x in (r.seq, sep)][:-1]))


def k1_sets(torch, dev, alphabet, construct, fasta):
    """K1's input sets, each at full size: 2^24 random positions with 2,000
    N runs at k = 15, 25 and 31 and, two limbs, 33, 45 and 61; the strains
    workload's joined positions at k=15; an N every other position (k=25
    and 61); random bytes as codes2 (code bits set under N) over the k=25
    set's validity map.  {label: (codes2, nmask, n, k)} on the card."""
    n = 1 << 24
    rng = np.random.default_rng(1)

    def up(codes):
        pk_h, nm_h = construct.pack_codes_host(codes)
        return torch.from_numpy(pk_h).to(dev), torch.from_numpy(nm_h).to(dev)

    sets = {}
    for k in (15, 25, 31, 33, 45, 61):
        codes = rng.integers(0, 4, size=n).astype(np.uint8)
        for lo in rng.integers(0, n, size=2000):
            codes[lo : lo + int(rng.integers(1, 500))] = alphabet.BAD_CODE
        sets[f"k={k} random"] = (*up(codes), n, k)
    joined = strains_codes(alphabet, fasta)
    sets["strains k=15"] = (*up(joined), len(joined), 15)
    dense = rng.integers(0, 4, size=n).astype(np.uint8)
    dense[1::2] = alphabet.BAD_CODE
    sets["N every other k=25"] = (*up(dense), n, 25)
    sets["N every other k=61"] = (*sets["N every other k=25"][:2], n, 61)
    garbage = torch.from_numpy(rng.integers(0, 256, size=n // 4).astype(np.uint8)).to(dev)
    sets["random bytes k=25"] = (garbage, sets["k=25 random"][1], n, 25)
    return sets


def k1_vs_plain(torch, kernels, sets, peak_ops):
    """K1 against its plain version on each input set, launched twice in a
    row, exact, with its time, the plain version's, its bound (the packed
    codes and the validity map in, one or two int64 key limbs and an int32
    word out per position, each once, against K1_OPS_PER_POSITION(_WIDE)
    operations) and the time the card takes to write those outputs alone
    (torch's fill of tensors of their size).  A copy of this script put into an older
    checkout times that checkout's kernel on the same inputs.  Returns
    {label: dict of err, ms, plain_ms, bound_ms, bound_by}."""
    out = {}
    for label, (codes2, nmask, n, k) in sets.items():
        want = kernels.front_half_plain(codes2, nmask, n, k)
        want = (*want[0], want[1])
        limbs = 1 if k <= kernels.ONE_LIMB_MAX_K else 2
        check(len(want) == limbs + 1, f"front_half_plain gave {len(want) - 1} limbs ({label})")
        err = 0
        for _twice in range(2):
            got = kernels.front_half(codes2, nmask, n, k)
            got = (*got[0], got[1])
            torch.cuda.synchronize()
            check(len(got) == len(want), f"front_half gave {len(got) - 1} limbs ({label})")
            err = max(err, *(int((a - b).abs().max()) for a, b in zip(got, want)))
        check(err == 0, f"front_half differs from its plain version ({label})")
        ms = cuda_ms(torch, lambda: kernels.front_half(codes2, nmask, n, k), 20)
        plain_ms = cuda_ms(torch, lambda: kernels.front_half_plain(codes2, nmask, n, k), 3)
        fill_ms = cuda_ms(torch, lambda: [t.fill_(1) for t in got], 20)
        ops = K1_OPS_PER_POSITION if limbs == 1 else K1_OPS_PER_POSITION_WIDE
        bound, by = bound_ms(-(-n // 4) + -(-n // 8) + (8 * limbs + 4) * n, ops * n, peak_ops)
        print(f"front_half {label}: equal, {limbs} key limb(s), {n} positions, "
              f"{int((want[0] != kernels.INVALID_CANON).sum())} valid windows | "
              f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | bound {bound:.4f} ms by {by} "
              f"= {100 * bound / ms:.4f}% of the kernel's time | outputs' fill alone "
              f"{fill_ms:.4f} ms")
        out[label] = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by}
        del want, got
    return out


def compare_kernels(torch, dev, alphabet, construct, kernels, fasta, peak_ops):
    """Phase 3's K1 part: K1 equal to its plain version on its ten input
    sets, and the graph stage's sort of the k=25 set's keys (one stable
    pass) and of the k=33 set's (two stable passes, construct.sort_keys).
    Returns k1_vs_plain's results."""
    sets = k1_sets(torch, dev, alphabet, construct, fasta)
    k1 = k1_vs_plain(torch, kernels, sets, peak_ops)
    for k in (25, 33):
        codes2, nmask, n, _k = sets[f"k={k} random"]
        keys = kernels.front_half(codes2, nmask, n, k)[0]
        sort_ms = cuda_ms(torch, lambda: construct.sort_keys(list(keys)), 10)
        print(f"graph sort of 2^24 keys at k={k}: {len(keys)} stable torch.sort pass(es) "
              f"{sort_ms:.4f} ms")
    return k1


def sorted_rows(torch, construct, keys, packed):
    """K2's input: the rows sorted by key (stable, lexicographic over the
    limbs), as the graph stage has them."""
    keys_s, order = construct.sort_keys(list(keys))
    return keys_s, packed[order], order.to(torch.int32)


def k2_row_sets(torch, dev, alphabet, construct, kernels, fasta):
    """K2's row sets, each at full size: k=25 rows of 2^24 random positions
    with N runs; the poly-A stress (one class of ~10^6 rows, spanning
    hundreds of tiles, and a poly-C and an N stretch); the first set's words
    and positions as one class and as 2^24 distinct keys; the strains
    workload's own rows (16 x 1 Mbp joined with N, k=15); and with two-limb
    keys: the random positions' rows at k=33 and 61, the k=33 rows' classes
    keyed with hi equal throughout (classes split on lo alone) and with lo
    equal throughout (on hi alone), and the poly-A stress at k=45.
    {label: rows}."""
    n = 1 << 24
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    for lo in rng.integers(0, n, size=2000):
        codes[lo : lo + int(rng.integers(1, 500))] = alphabet.BAD_CODE
    poly = rng.integers(0, 4, size=n).astype(np.uint8)
    poly[1000 : 1000 + 1_000_000] = 0  # poly-A: one class of ~10^6 rows
    poly[5_000_000 : 5_000_000 + 100_000] = 1  # poly-C
    poly[9_000_000 : 9_000_000 + 300_000] = alphabet.BAD_CODE
    joined = strains_codes(alphabet, fasta)

    def rows_of(c, k):
        pk_h, nm_h = construct.pack_codes_host(c)
        keys, packed = kernels.front_half(torch.from_numpy(pk_h).to(dev),
                                          torch.from_numpy(nm_h).to(dev), len(c), k)
        return sorted_rows(torch, construct, keys, packed)

    sets = {"k=25 random": rows_of(codes, 25), "poly-A stress": rows_of(poly, 25)}
    _keys_s, packed_s, pos_s = sets["k=25 random"]
    sets["one class"] = ((torch.zeros(n, dtype=torch.int64, device=dev),), packed_s, pos_s)
    sets["all distinct"] = ((torch.arange(n, dtype=torch.int64, device=dev),), packed_s, pos_s)
    sets["strains k=15"] = rows_of(joined, 15)
    sets["k=33 random"] = rows_of(codes, 33)
    sets["k=61 random"] = rows_of(codes, 61)
    (hi_s, lo_s), packed_s, pos_s = sets["k=33 random"]
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    cls = torch.cumsum(start, 0) - 1  # each row's class, dense
    zero = torch.zeros_like(cls)
    sets["k=33 classes, hi equal"] = ((zero, cls), packed_s, pos_s)
    sets["k=33 classes, lo equal"] = ((cls, zero), packed_s, pos_s)
    sets["poly-A stress k=45"] = rows_of(poly, 45)
    return sets


def k2_vs_plain(torch, kernels, sets, peak_ops):
    """K2 against its plain version on each row set, launched twice in a row,
    exact, with its time, the plain version's and its bound (21 B per row:
    key 8 + word 4 + position 4 in, flag 1 + first 4 out, each once; 29 B
    with a second key limb).  A
    copy of this script put into an older checkout times that checkout's
    kernel on the same rows.  Returns {label: dict of err, ms, plain_ms,
    bound_ms, bound_by}."""
    out = {}
    for label, rows in sets.items():
        n, limbs = rows[1].shape[0], len(rows[0])
        want = kernels.class_analysis_plain(*rows)
        err = 0
        for _twice in range(2):
            got = kernels.class_analysis(*rows)
            torch.cuda.synchronize()
            err = max(err, int((got[0].int() - want[0].int()).abs().max()),
                      int((got[1] - want[1]).abs().max()))
        check(err == 0, f"class_analysis differs from its plain version ({label})")
        ms = cuda_ms(torch, lambda: kernels.class_analysis(*rows), 20)
        plain_ms = cuda_ms(torch, lambda: kernels.class_analysis_plain(*rows), 3)
        bound, by = bound_ms((13 + 8 * limbs) * n, 0, peak_ops)
        print(f"class_analysis {label}: equal, {limbs} key limb(s), {n} rows, "
              f"{int(want[0].sum())} junction rows | "
              f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | bound {bound:.4f} ms by {by} "
              f"= {100 * bound / ms:.4f}% of the kernel's time")
        out[label] = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by}
    return out


def poa_blocks(cases, kind, rng):
    """Seeded POA blocks of one K3 bucket: (blocks, planner keywords)."""
    if kind == "unbanded":  # L = 1024, full-width windows
        return [cases.rand_block(rng, int(rng.integers(700, 1000)), 3, mut=0.05)
                for _ in range(16)], {"band": False}
    if kind == "banded":  # L = 4096, banded windows
        return [cases.rand_block(rng, int(rng.integers(3000, 4000)), 3, mut=0.03)
                for _ in range(8)], {"band_min": 64}
    if kind == "tie_heavy":  # low complexity, L = 4096: ties everywhere
        return [cases.tie_heavy_block(rng, 300) for _ in range(8)], {"band_min": 64}
    if kind in ("wide", "wider"):
        # B 1, unbanded, each from its own seed: L = W = 8192, eight columns
        # per thread; L = W = 16384, two chunks of 8192 columns
        n = 8100 if kind == "wide" else 8300
        return [cases.rand_block(np.random.default_rng(n), n, 2, mut=0.03)], {"band": False}
    # far_pred (a predecessor 2,400 ranks back), many_preds (seven slots),
    # odd_w (B 1, W = L + 1 = 4097, few ranks): tests/torch_cases.py's cases
    blocks, band_min = cases.poa_case(kind, 16 if kind == "odd_w" else 8)
    return blocks, {"band_min": band_min}


K3_BUCKETS = ("unbanded", "banded", "tie_heavy", "far_pred", "many_preds", "odd_w", "wide",
              "wider")


def k3_work(torch, align_kernels, args):
    """What one K3 dispatch has to do: (ranks in use per block, cells,
    32-bit integer operations, bytes).  Cells are ranks in use x W; a cell
    costs 4 operations per valid predecessor slot (two window compares, two
    steps of the running first arg-max) and 12 more (substitution compare
    and select, diagonal add, gap add, match compare and select, three scan
    steps, insertion compare, two direction-byte selects); bytes are the
    seven inputs and the four outputs once each (H and dirs are scratch)."""
    seq0p, seq_len, node_char, pred_idx, pred_ok, sink_mask, n_max, W, P, off = args
    B = seq0p.shape[0]
    used = align_kernels._ranks_used(pred_ok)
    in_use = torch.arange(n_max, device=used.device)[None, :] < used[:, None]
    slots = int((pred_ok.sum(dim=2) * in_use).sum())
    ranks = int(used.sum())
    ops = W * (4 * slots + 12 * ranks)
    nbytes = sum(t.numel() * t.element_size() for t in
                 (seq0p, seq_len, node_char, pred_idx, pred_ok, sink_mask, off))
    nbytes += 2 * B * P * 4 + 2 * B * 4
    return used, ranks * W, ops, nbytes


def ring_hit_share(torch, align_kernels, args, depth):
    """Share of the dispatch's predecessor-row reads (ranks in use, real
    predecessors) that lie at most `depth` ranks back: what K3's
    shared-memory ring of that depth serves."""
    pred_idx, pred_ok, n_max = args[3], args[4], args[6]
    used = align_kernels._ranks_used(pred_ok)
    ranks = torch.arange(n_max, device=used.device)
    real = pred_ok & (pred_idx < n_max) & (ranks[None, :] < used[:, None])[:, :, None]
    back = ranks[None, :, None] - pred_idx
    return float((real & (back <= depth)).sum()) / max(1, int(real.sum()))


def k3_sweep(torch, align_kernels, args, want):
    """K3 at every number of columns per thread that fits the dispatch's
    window, and at the chosen one with the ring off and at 1 and 4 rows,
    each exact against `want`: one line per launch shape."""
    W = args[7]
    chosen = align_kernels.launch_config(W)
    shapes = [align_kernels.launch_config(W, cols) for cols in (1, 2, 4, 8)
              if W <= cols * align_kernels.MAX_THREADS]
    if chosen["depth"] > 0:  # the ring off, and at other depths
        shapes += [{**chosen, "depth": depth} for depth in (0, 1, 4)]
    for cfg in shapes:
        for _warm_then_timed in range(2):
            parts = []
            got = align_kernels.poa_dp_tb(*args, split_ms=parts, config=cfg)
        same = all(bool((a == b).all()) for a, b in zip(got, want))
        check(same, f"poa_dp_tb differs from its plain version at {cfg}")
        print(f"  sweep {cfg}: equal | pre-pass {parts[0]:.4f} | DP {parts[1]:.4f} | "
              f"traceback {parts[2]:.4f} ms")


def k3_vs_plain(torch, align_kernels, args, label, peak_ops, want=None, reps=3):
    """K3 against its plain version on one dispatch's arguments, exact
    (`want`: the plain version's outputs where they were kept from an
    earlier run), with its time, its parts, its bound and its chain floor;
    returns a dict with the max abs error, the kernel's ms, the plain ms
    (None with `want`) and the bound."""
    check(args is not None, f"no K3 dispatch to check ({label})")
    seq0p, n_max, W = args[0], args[6], args[7]
    got = align_kernels.poa_dp_tb(*args)
    torch.cuda.synchronize()
    plain_ms = None
    if want is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = align_kernels.poa_dp_tb_plain(*args)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    check(err == 0, f"poa_dp_tb differs from its plain version ({label})")
    ms = cuda_ms(torch, lambda: align_kernels.poa_dp_tb(*args), reps)
    parts = []
    align_kernels.poa_dp_tb(*args, split_ms=parts)
    used, cells, ops, nbytes = k3_work(torch, align_kernels, args)
    bound, by = bound_ms(nbytes, ops, peak_ops)
    cfg = align_kernels.launch_config(W)
    ranks, steps = int(used.max()), int(want[2].max())
    share = ring_hit_share(torch, align_kernels, args, cfg["depth"])
    plain = "kept from the recording" if plain_ms is None else f"{plain_ms:.4f} ms"
    print(f"poa_dp_tb {label}: equal | B {seq0p.shape[0]} L {seq0p.shape[1] - 1 - W} "
          f"n_max {n_max} W {W} {cfg} ranks used {ranks} | kernel {ms:.4f} ms | plain {plain}")
    print(f"  parts: pre-pass {parts[0]:.4f} ms | DP {parts[1]:.4f} ms = "
          f"{parts[1] * 1e3 / ranks:.4f} us per rank in use | traceback {parts[2]:.4f} ms = "
          f"{parts[2] * 1e3 / max(1, steps):.4f} us per step ({steps} steps) | whole "
          f"{ms * 1e3 / ranks:.4f} us per rank | ring depth {cfg['depth']} serves "
          f"{100 * share:.4f}% of predecessor reads")
    print(f"  bound {bound:.4f} ms by {by} ({cells} cells, {ops} int32 operations, "
          f"{nbytes} bytes) = {100 * bound / ms:.4f}% of the kernel's time")
    step_us = cuda_ms(torch, lambda: align_kernels.chain_probe(cfg["threads"], 20000), 3) / 20
    print(f"  chain floor {ranks * step_us / 1e3:.4f} ms = {ranks} ranks x {step_us:.4f} us (one "
          f"shared-memory round trip and one barrier of {cfg['threads']} threads) = "
          f"{100 * ranks * step_us / 1e3 / ms:.4f}% of the kernel's time")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


def bucket_args(torch, dev, cases, device_poa, poa_ref, kind, rng):
    """K3's arguments on the card for one seeded bucket: each block's last
    copy aligned to the graph of the others, assembled by the engine's own
    device_poa.assemble_round."""
    blocks, plan_kw = poa_blocks(cases, kind, rng)
    plan = functools.partial(device_poa._plan_windows, **plan_kw)
    arrays, n_max, W, P, s0s = cases.poa_round(
        blocks, poa_ref.PoaGraph, device_poa._extract_arrays, plan)
    banded = sum(s is not None for s in s0s)
    if kind in ("unbanded", "banded", "odd_w", "wide", "wider"):
        check(banded == (len(blocks) if kind == "banded" else 0),
              f"{kind}: {banded} of {len(blocks)} blocks banded")
    if kind in ("wide", "wider"):
        check(W == (8192 if kind == "wide" else 16384), f"{kind}: W {W}")
    if kind == "odd_w":
        check(W % 2 == 1 and len(blocks) == 1, f"odd_w: W {W}, B {len(blocks)}")
    t = [torch.from_numpy(a).to(dev) for a in arrays]
    return (*t[:6], n_max, W, P, t[6])


def compare_poa(torch, dev, cases, device_poa, poa_ref, align_kernels, peak_ops,
                kinds=K3_BUCKETS, sweep=False):
    """Phase 4: K3 against its plain version on the seeded buckets; returns
    the max abs error.  With `sweep`, each bucket also runs at the other
    launch shapes."""
    rng = np.random.default_rng(21)
    err = 0
    for kind in kinds:
        args = bucket_args(torch, dev, cases, device_poa, poa_ref, kind, rng)
        if kind == "wider":
            check(align_kernels.launch_config(args[7])["depth"] == 0,
                  "wider: the window does not run in chunks")
        err = max(err, k3_vs_plain(torch, align_kernels, args, kind, peak_ops)["err"])
        if kind in ("tie_heavy", "many_preds", "odd_w"):
            # the same bucket with the window cut into chunks of 96 columns
            chunked = {"cols": 1, "threads": 96, "depth": 0}
            want = align_kernels.poa_dp_tb(*args)
            got = align_kernels.poa_dp_tb(*args, config=chunked)
            check(all(bool((a == b).all()) for a, b in zip(got, want)),
                  f"poa_dp_tb in chunks differs ({kind})")
            print(f"  in chunks {chunked}: equal")
        if sweep:
            k3_sweep(torch, align_kernels, args, align_kernels.poa_dp_tb(*args))
    return err


def k3_time(torch, dev, cases, device_poa, poa_ref, align_kernels, kinds):
    """--k3-time KIND[,KIND...]: K3's wrapper alone on seeded buckets that
    have a seed of their own (K3_BUCKETS[3:]), exact against the plain
    version, with its ms and us per rank in use.  It passes the wrapper
    its positional arguments and nothing else, so a copy of this script put
    into an older checkout times that checkout's kernel on the same inputs."""
    for kind in kinds:
        check(kind in K3_BUCKETS[3:], f"--k3-time takes {K3_BUCKETS[3:]}, not {kind!r}")
        args = bucket_args(torch, dev, cases, device_poa, poa_ref, kind, None)
        got = align_kernels.poa_dp_tb(*args)
        want = align_kernels.poa_dp_tb_plain(*args)
        check(all(bool((a == b).all()) for a, b in zip(got, want)),
              f"poa_dp_tb differs from its plain version ({kind})")
        ms = cuda_ms(torch, lambda: align_kernels.poa_dp_tb(*args), 3)
        ranks = int(align_kernels._ranks_used(args[4]).max())
        print(f"poa_dp_tb {kind}: equal | B {args[0].shape[0]} n_max {args[6]} W {args[7]} "
              f"ranks used {ranks} | kernel {ms:.4f} ms = {ms * 1e3 / ranks:.4f} us per rank")


class LargestDispatch:
    """While active, wraps the K3 wrapper that the device engine calls and
    keeps the arguments of the run's largest dispatch (by n_max, then W),
    so that K3 can be held against its plain version at the main path's own
    shapes afterwards.  The wrapper it calls still counts each launch."""

    def __init__(self, align_kernels):
        self.mod, self.args = align_kernels, None

    def __enter__(self):
        real = self.real = self.mod.poa_dp_tb

        def record(*args):
            out = real(*args)
            if self.args is None or args[6:8] > self.args[6:8]:
                self.args = args
            return out

        self.mod.poa_dp_tb = record
        return self

    def __exit__(self, *exc):
        self.mod.poa_dp_tb = self.real


def maf_body(path):
    with open(path) as f:
        return [l for l in f.read().splitlines() if not l.startswith("# cmd=")]


def align_counts(metrics):
    """The alignment stage's counters: dispatches, blocks, re-runs, native
    routing, and the device engine's seconds per phase (poa_*_s)."""
    keys = ("poa_dispatches", "poa_blocks_dispatched", "poa_band_pass2",
            "poa_band_full", "poa_native_routed", "poa_native_redo")
    counts = {k: int(metrics.counters.get(k, 0)) for k in keys}
    counts.update(sorted((k, v) for k, v in metrics.counters.items()
                         if k.startswith("poa_") and k.endswith("_s")))
    return counts


def golden_mafs(torch, cli, metrics, kernels, align_kernels, out_dir):
    """Phase 7: returns the launches of K1, K2 and K3 in the device-engine
    run and the arguments of that run's K3 dispatch."""
    golden = maf_body(os.path.join(EXAMPLES, "sibeliaz_out", "alignment.maf"))
    fas = [os.path.join(EXAMPLES, "genome1.fa"), os.path.join(EXAMPLES, "genome2.fa")]
    launches = 0
    for engine in ("native", "tpu"):
        out = os.path.join(out_dir, engine)
        metrics.timings.clear()
        metrics.counters.clear()
        kernels.reset_launches()
        align_kernels.reset_launches()
        with LargestDispatch(align_kernels) as rec:
            wall = run_cli(cli, ["-k", "15", "--align-engine", engine, "-o", out, *fas])
        launches = {**kernels.LAUNCHES, **align_kernels.LAUNCHES}
        align_s = {t["stage"]: t["seconds"] for t in metrics.timings}["align"]
        counts = align_counts(metrics)
        check(maf_body(os.path.join(out, "alignment.maf")) == golden,
              f"examples/ MAF ({engine} engine) differs from the golden")
        if engine == "tpu":
            check(all(launches[name] > 0 for name in MONOLITHIC_KERNELS + ("poa_dp_tb",)),
                  f"a kernel was not launched on the CLI path: {launches}")
            check(counts["poa_blocks_dispatched"] == 11 and counts["poa_native_redo"] == 0
                  and counts["poa_native_routed"] == 0,
                  f"not every examples/ block went through the card: {counts}")
        print(f"examples/ --align-engine {engine}: MAF byte-equal to the golden | align "
              f"{align_s:.4f} s | CLI wall {wall:.4f} s | launches {launches} | {counts}")
    return launches, rec.args


def large_alignment(torch, large_fa, fasta, pipeline, Config, msa, metrics, kernels,
                    align_kernels, out_dir, engines=("native", "tpu")):
    """Phase 8: the POA engines on every block of examples/large (k=25) at
    the CLI's budget (no -f), MSAs compared through the MAF they write;
    returns the launches of K1 and K2 (finding the blocks) and K3 (the
    device engine's run) and the arguments of K3's largest dispatch."""
    recs = fasta.read_many(large_fa)
    seqs, names = [r.seq for r in recs], [r.name for r in recs]
    threads = os.cpu_count() or 1
    kernels.reset_launches()
    res = pipeline.find_blocks(seqs, names, Config(k=25, threads=4), device="cuda")
    graph_launches = dict(kernels.LAUNCHES)
    os.makedirs(out_dir, exist_ok=True)
    bodies = {}
    for engine in engines:
        metrics.counters.clear()
        align_kernels.reset_launches()
        path = os.path.join(out_dir, f"{engine}.maf")
        t0 = time.time()
        with LargestDispatch(align_kernels) as rec:
            overflow = msa.align_blocks_to_maf(res.blocks, seqs, names, path, threads=threads,
                                               engine=engine, device="cuda")
        secs = time.time() - t0
        check(not overflow, f"{engine} engine overflowed blocks {overflow[:10]}")
        bodies[engine] = maf_body(path)
        print(f"examples/large --align-engine {engine}: {res.blocks_found} blocks | align "
              f"{secs:.4f} s | poa_dp_tb launches {align_kernels.LAUNCHES['poa_dp_tb']} | "
              f"{align_counts(metrics)}")
    if len(engines) == 2:
        check(bodies["native"] == bodies["tpu"],
              "examples/large: device-engine MSAs differ from the native engine's")
        print(f"examples/large: the device engine's MSAs equal the native engine's on all "
              f"{res.blocks_found} blocks")
    return {**graph_launches, **align_kernels.LAUNCHES}, rec.args


def run_cli(cli, argv):
    t0 = time.time()
    rc = cli.run(argv)
    check(rc == 0, f"CLI {argv} returned {rc}")
    return time.time() - t0


def print_ptxas(report):
    """One line per kernel of nvcc's -Xptxas -v report: registers, shared
    memory, stack and spills."""
    kernel = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"\d+([a-z_]+_kernel)((?:L[ib]\d+E|I)*)", mangled)
            args = re.findall(r"L[ib](\d+)E", m.group(2)) if m else []
            if m is None:
                kernel = mangled
            elif m.group(1) == "poa_dp_kernel" and len(args) == 3:
                shape = {"10": "chunked", "01": "whole", "00": "ragged"}
                kernel = f"{m.group(1)}<{args[0]}, {shape[args[1] + args[2]]}>"
            elif m.group(1) == "round_append_kernel" and len(args) == 1:
                kernel = f"{m.group(1)}<{args[0]} key limb(s)>"
            elif m.group(1) in ("class_tile_kernel", "front_half_kernel") and len(args) == 2:
                loads = {"class_tile_kernel": "16-byte", "front_half_kernel": "word"}[m.group(1)]
                kernel = (f"{m.group(1)}<{args[0]} key limb(s), "
                          f"{loads if args[1] == '1' else 'byte'} loads>")
            else:
                kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            spill = ""
        elif "bytes stack frame" in line:
            spill = line.strip()
        elif "Used" in line and kernel:
            print(f"  {kernel}: {line.split(':', 1)[1].strip()} | {spill}")
            kernel = None


def regenerate_large(alphabet, fasta, out_dir):
    """examples/large's two FASTA files, rebuilt from the seed and checked."""
    large_fa = []
    for g, recs in enumerate(build_large(alphabet, fasta), start=1):
        path = os.path.join(out_dir, f"genome{g}.fa")
        fasta.write_fasta(path, recs)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        check(digest == LARGE_SHA[f"genome{g}.fa"], f"genome{g}.fa digest {digest}")
        large_fa.append(path)
    print("examples/large inputs regenerated; SHA-256 digests match")
    return large_fa


def synth_pair(alphabet, seed, length):
    """benchmarks/run_configs.py::synth's recipe for two genomes of one
    chromosome each (chromosome-k25-1g's shape: a random ancestor, each copy
    with 1% substitutions, no inversion), drawn as uint8 with the
    substitution sites by count, so that the host holds O(length) bytes and
    no float per position."""
    rng = np.random.default_rng(seed)
    ancestor = alphabet.decode(rng.integers(0, 4, size=length, dtype=np.uint8))
    seqs = []
    for _g in range(2):
        s = ancestor.copy()
        sites = rng.integers(0, length, size=int(rng.binomial(length, 0.01)))
        s[sites] = alphabet.decode(rng.integers(0, 4, size=len(sites), dtype=np.uint8))
        seqs.append(s)
    return seqs


def round_append_vs_plain(torch, kernels, chunks, r0, n_rounds, G, cap, kernel=None):
    """K4 (or `kernel`, a function of K4's arguments) and its plain version
    over the same chunks ((keys, packed, gpos0) on the card, appended in
    turn), each into its own G x cap buffers filled with -7, one run after
    the other: the max abs difference over the buffers, cursors and flag,
    and K4's cursors.  Only the first R rows of each round (R: K4's largest
    cursor, at most cap) are kept for the comparison; a run that wrote a row
    past them fails the check (its error is the written value's distance
    from -7), so that buffers of a full-size plan's cap need not be held
    twice."""
    limbs, dev = len(chunks[0][0]), chunks[0][1].device
    runs, err = [], 0
    for fn in (kernel or kernels.round_append, kernels.round_append_plain):
        bufs = [torch.full((G, cap), -7, dtype=torch.int64, device=dev) for _ in range(limbs + 1)]
        cursors = torch.zeros(G, dtype=torch.int64, device=dev)
        overflow = torch.zeros(1, dtype=torch.int32, device=dev)
        for keys, packed, gpos0 in chunks:
            fn(keys, packed, gpos0, r0, n_rounds, tuple(bufs[:limbs]), bufs[limbs], cursors,
               overflow)
        torch.cuda.synchronize()
        if not runs:
            rows = min(cap, int(cursors.max()))
        for b in bufs:
            tail = b[:, rows:]
            if bool((tail != -7).any()):
                err = max(err, int((tail[tail != -7] + 7).abs().max()))
        runs.append(([b[:, :rows].clone() for b in bufs], cursors, overflow.long()))
        del bufs
    (heads_a, *rest_a), (heads_b, *rest_b) = runs
    err = max(err, *(int((a - b).abs().max()) for a, b in zip(heads_a + rest_a,
                                                                heads_b + rest_b)
                     if a.numel()))
    return err, runs[0][1]


def k4_hand_laid(torch, dev, kernels, cases):
    """K4 against its plain version on hand-laid chunks of T - 1, 3T, T + 5
    and 11T + 3 rows (T = the kernel's tile): every kind of round_rows, one
    and two limbs, one round of one, G = 8 of 8 and 64 of 100 (the kinds
    that lay a round out by tiles lay the pass's first round).  Returns the
    max abs error."""
    T = kernels.K4_TILE_ROWS
    err = 0
    for kind in cases.ROUND_ROW_KINDS:
        for limbs in (1, 2):
            for r0, n_rounds, G in ((0, 1, 1), (0, 8, 8), (30, 100, 64)):
                chunks, gpos0 = [], 1
                for c, m in enumerate((T - 1, 3 * T, T + 5, 11 * T + 3)):
                    keys, packed = cases.round_rows(kind, m, limbs, seed=c, hot=r0, tile=T)
                    chunks.append((tuple(torch.from_numpy(x).to(dev) for x in keys),
                                   torch.from_numpy(packed).to(dev), gpos0))
                    gpos0 += m
                e, _cur = round_append_vs_plain(torch, kernels, chunks, r0, n_rounds, G, gpos0)
                check(e == 0, f"round_append differs from its plain version ({kind}, "
                              f"{limbs} limb(s), G={G})")
                err = max(err, e)
    print(f"round_append on hand-laid chunks: equal ({len(cases.ROUND_ROW_KINDS)} kinds x one "
          f"and two limbs x G 1, 8, 64)")
    return err


# K4's timed shapes (r0, n_rounds, G): G=1 (round 3 of 8), G=8 of 8, G=2 of
# 8 from round 2 (the shape of examples/large's streamed passes) and G=4 of
# 4 (the 2 x 1.1 Gbp pass at one limb, the strains' -f 1 pass at two)
K4_SHAPES = ((3, 8, 1), (0, 8, 8), (2, 8, 2), (0, 4, 4))
def k4_inputs(torch, dev, alphabet, construct, kernels):
    """K4's full-size input: K1's outputs for a 2^22-position chunk of random
    codes with N runs (k=25: one limb; k=33: two), as the streamed stage
    hands them over (window offsets 1..2^22).  {limbs: (keys, packed)}."""
    m = 1 << 22
    rng = np.random.default_rng(4)
    out = {}
    for limbs, k in ((1, 25), (2, 33)):
        codes = rng.integers(0, 4, size=m + k + 2).astype(np.uint8)
        for lo in rng.integers(0, m, size=500):
            codes[lo : lo + int(rng.integers(1, 500))] = alphabet.BAD_CODE
        pk_h, nm_h = construct.pack_codes_host(codes)
        keys, packed = kernels.front_half(torch.from_numpy(pk_h).to(dev),
                                          torch.from_numpy(nm_h).to(dev), m + k + 2, k)
        out[limbs] = (tuple(x[1 : m + 1] for x in keys), packed[1 : m + 1])
    return out


def k4_bound(m, kept, limbs, peak_ops):
    """K4's bound: every row's keys read once, each kept row's word read and
    its keys and payload written once; operations: the hash, modulo and keep
    test a row, the rank and payload a kept row.  (ms, which)."""
    ops = (K4_OPS_PER_ROW if limbs == 1 else K4_OPS_PER_ROW_WIDE) * m + K4_OPS_PER_KEPT_ROW * kept
    return bound_ms(m * 8 * limbs + kept * (8 * limbs + 12), ops, peak_ops)


def k4_timing_buffers(torch, dev, G, limbs, per_launch, reps):
    """Round buffers with room for a warm-up and `reps` launches that keep at
    most `per_launch` rows a round, and zeroed cursors and flag."""
    room = int((reps + 2) * per_launch * 1.05)
    bufs = [torch.empty((G, room), dtype=torch.int64, device=dev) for _ in range(limbs + 1)]
    return bufs, torch.zeros(G, dtype=torch.int64, device=dev), \
        torch.zeros(1, dtype=torch.int32, device=dev)


def k4_full_size(torch, dev, alphabet, construct, streamed, kernels, peak_ops, ns):
    """K4 on k4_inputs' chunks in the four K4_SHAPES, G=1 and G=8 of 8 into
    buffers with room for two chunks, G=2 of 8 (examples/large's streamed
    passes) and G=4 of 4 (2 x 1.1 Gbp at one limb, the strains' -f 1 pass at
    two) each with the cap that streamed.plan gives that run (ns: its
    positions).  Exact against the plain version over two chunks in a row;
    then its time over 20 launches into buffers with room for all of them,
    the plain version's, and the bound (k4_bound).  Returns {label: dict}."""
    m = 1 << 22
    out = {}
    torch.cuda.empty_cache()
    for limbs, (keys, packed) in k4_inputs(torch, dev, alphabet, construct, kernels).items():
        k = 25 if limbs == 1 else 33
        g4_path = "2 x 1.1 Gbp" if limbs == 1 else "strains -k 33 -n -f 1"
        paths = (None, None, f"examples/large streamed k={k}", g4_path)
        for (r0, n_rounds, G), path in zip(K4_SHAPES, paths):
            label = f"{limbs} limb(s) G={G} of {n_rounds}"
            cap = 2 * m if path is None else streamed.plan(ns[path], k, 1 << 22, 1.25, None,
                                                           n_rounds).cap
            err, cursors = round_append_vs_plain(
                torch, kernels, [(keys, packed, 1), (keys, packed, 1 + m)], r0, n_rounds, G, cap)
            check(err == 0, f"round_append differs from its plain version ({label}, cap {cap})")
            kept = int(cursors.sum()) // 2
            reps = 20
            bufs, cur, ovf = k4_timing_buffers(torch, dev, G, limbs, int(cursors.max()) // 2, reps)
            ms = cuda_ms(torch, lambda: kernels.round_append(
                keys, packed, 1, r0, n_rounds, tuple(bufs[:limbs]), bufs[limbs], cur, ovf), reps,
                ahead=True)
            check(int(ovf) == 0, f"round_append timing overflowed ({label})")
            del bufs
            pbufs = [torch.empty((G, m), dtype=torch.int64, device=dev)
                     for _ in range(limbs + 1)]
            plain_ms = cuda_ms(torch, lambda: (cur.zero_(), kernels.round_append_plain(
                keys, packed, 1, r0, n_rounds, tuple(pbufs[:limbs]), pbufs[limbs], cur, ovf)), 3)
            del pbufs
            bound, by = k4_bound(m, kept, limbs, peak_ops)
            print(f"round_append {label} (round {r0} on, cap {cap}"
                  f"{'' if path is None else ': ' + path}), 2^22 rows of K1's k={k} outputs: "
                  f"equal, {kept} kept | kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | bound "
                  f"{bound:.4f} ms by {by} = {100 * bound / ms:.4f}% of the kernel's time")
            out[label] = {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                          "bound_by": by, "kept": kept, "r0": r0, "cap": cap, "path": path}
    return out


def build_older_k4(cudabuild, kernels, out_dir, older):
    """An older version of csrc/round_append.cu (with the same C interface),
    built alone into a shared library with nvcc and bound as the port's
    library is; its -Xptxas -v report printed.  A function of K4's
    arguments that launches its kernel."""
    lib = os.path.join(out_dir, "k4_older.so")
    proc = subprocess.run([cudabuild._nvcc(), *cudabuild.NVCC_FLAGS, "-shared", "-o", lib, older],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"K4 {older} did not build:\n{proc.stderr}")
    print(f"K4 {older}:")
    print_ptxas(proc.stderr)
    bound = cudabuild.bind(ctypes.CDLL(lib), ("sz_round_scratch_bytes", "sz_round_append"))
    return functools.partial(kernels.round_append_launch, bound)


def k4_time(torch, dev, alphabet, construct, kernels, cudabuild, peak_ops, out_dir, older):
    """--k4-time [OLDER.cu]: K4's wrapper (and an older version of
    csrc/round_append.cu, where given) against the plain version, exact,
    over two of k4_inputs' chunks in a row, in the four K4_SHAPES and at
    G = 64 of 64, one and two limbs; then in each shape their times over 20
    launches, in turns: older, wrapper, wrapper, older."""
    print("K4 (the port's library):")
    print_ptxas(cudabuild.build()[1])
    fns = {"wrapper": kernels.round_append}
    if older:
        fns[f"older kernel {older}"] = build_older_k4(cudabuild, kernels, out_dir, older)
    order = [*fns][::-1] + [*fns]
    m, reps = 1 << 22, 20
    for limbs, (keys, packed) in k4_inputs(torch, dev, alphabet, construct, kernels).items():
        for r0, n_rounds, G in K4_SHAPES + ((0, 64, 64),):
            label = f"{limbs} limb(s) G={G} of {n_rounds}"
            chunks = [(keys, packed, 1), (keys, packed, 1 + m)]
            cap = min(2 * m, 4 * m // G)
            cursors = None
            for name, fn in fns.items():
                e, cur = round_append_vs_plain(torch, kernels, chunks, r0, n_rounds, G, cap,
                                               kernel=fn)
                check(e == 0, f"K4 {name} differs from the plain version ({label})")
                cursors = cur if cursors is None else cursors
            kept = int(cursors.sum()) // 2
            times = {}
            for name in order:
                fn = fns[name]
                bufs, cur, ovf = k4_timing_buffers(torch, dev, G, limbs,
                                                   int(cursors.max()) // 2, reps)
                times.setdefault(name, []).append(cuda_ms(torch, lambda: fn(
                    keys, packed, 1, r0, n_rounds, tuple(bufs[:limbs]), bufs[limbs], cur, ovf),
                    reps, ahead=True))
                check(int(ovf) == 0, f"K4 {name} timing overflowed ({label})")
                del bufs
            bound, by = k4_bound(m, kept, limbs, peak_ops)
            print(f"round_append {label} (round {r0} on), 2^22 rows, {kept} kept, every build "
                  f"equal to the plain version | bound {bound:.4f} ms by {by} | "
                  + " | ".join(f"{name} " + " / ".join(f"{t:.4f}" for t in ts) + " ms = "
                               + " / ".join(f"{100 * bound / t:.2f}" for t in ts) + "%"
                               for name, ts in times.items()))


def streamed_counts(metrics, kernels):
    """The streamed stage's passes, rounds, rounds a pass, retries and stage
    seconds, and the launches of the run."""
    c = metrics.counters
    stages = {}
    for t in metrics.timings:
        if t["stage"].startswith("graph_"):
            stages[t["stage"]] = stages.get(t["stage"], 0.0) + t["seconds"]
    return ({key: int(c.get(key, -1)) for key in ("graph_passes", "graph_rounds",
                                                  "graph_rounds_per_pass", "graph_round_retries",
                                                  "graph_host_rounds", "graph_positions",
                                                  "graph_junctions")},
            stages, dict(kernels.LAUNCHES))


def fresh_run(torch, metrics, kernels):
    """Counts and peaks to zero before a main-path run; returns the bytes
    allocated at its start."""
    metrics.timings.clear()
    metrics.counters.clear()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def all_launched(launches, label):
    check(all(launches[name] > 0 for name in ("front_half", "class_analysis", "round_append")),
          f"a kernel of the streamed stage was not launched ({label}): {launches}")


def epilogue_peak(torch, streamed, seqs, k):
    """One round's epilogue on the card (round 0 of 8, one buffer): its peak
    allocated bytes over the live rows, against the constant the plan uses."""
    n = 1 + sum(len(s) + 1 for s in seqs)
    p = streamed.plan(n, k, 1 << 22, 1.25, None, 8)
    codes2, nmask = streamed._upload(seqs, n, k, p.chunk, torch.device("cuda"))
    buf_keys, buf_payload, live, overflowed = streamed._scan_pass(codes2, nmask, n, k, p, 0, 1)
    check(not overflowed, "epilogue measurement: round 0 overflowed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    streamed._junction_rows([buf[0, : live[0]] for buf in buf_keys], buf_payload[0, : live[0]])
    per_row = (torch.cuda.max_memory_allocated() - before) / live[0]
    limit = p.epilogue_bytes
    check(per_row <= limit, f"epilogue peak {per_row:.2f} B/row at k={k}, above {limit}")
    print(f"one round's epilogue at k={k}: {live[0]} live rows, peak {per_row:.2f} B/row "
          f"(plan's constant {limit})")
    return per_row


def joined_positions(recs):
    """Positions of the streamed stage's joined genome: a leading N, one
    after each sequence."""
    return 1 + sum(len(r.seq) + 1 for r in recs)


def streamed_large(torch, recs, pipeline, Config, streamed, kernels, metrics, goldens, label):
    """Phase 10b: examples/large (its records) through the pipeline at a
    budget that holds 2 of its 8 round buffers (4 passes), at k=25 and
    k=33.  Returns the launches per k."""
    seqs, names = [r.seq for r in recs], [r.name for r in recs]
    n = joined_positions(recs)
    launches = {}
    for k, golden in goldens.items():
        p8 = streamed.plan(n, k, 1 << 22, 1.25, None, 8)
        budget = p8.fixed_bytes + p8.cap * (p8.epilogue_bytes + 2 * p8.row_bytes)
        p = streamed.plan(n, k, 1 << 22, 1.25, budget)
        check((p.n_rounds, p.G) == (8, 2), f"examples/large k={k}: plan {p}")
        mem0 = fresh_run(torch, metrics, kernels)
        t0 = time.time()
        res = pipeline.find_blocks(seqs, names, Config(k=k, threads=4,
                                                       memory_budget_bytes=budget),
                                   device="cuda")
        secs = time.time() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        counts, stages, launched = streamed_counts(metrics, kernels)
        digest = hashlib.sha256(res.gff.encode()).hexdigest()
        check(digest == golden, f"examples/large k={k} streamed GFF SHA-256 {digest}")
        check(counts["graph_passes"] == 4 and counts["graph_rounds"] == 8
              and counts["graph_round_retries"] == 0, f"examples/large k={k}: {counts}")
        all_launched(launched, f"examples/large k={k}")
        check(peak <= budget, f"examples/large k={k}: peak {peak} B over the budget {budget}")
        print(f"examples/large k={k} streamed, budget {budget} B: GFF SHA-256 equal to the "
              f"golden ({res.blocks_found} blocks) in {secs:.2f} s | {counts} | peak {peak} B "
              f"= {peak / n:.2f} B/position | launches {launched} | "
              + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
        launches[k] = launched
        epilogue_peak(torch, streamed, seqs, k)
    return launches


def streamed_cli_strains(torch, cli, metrics, kernels, bench_fa, monolithic_gff, out_dir,
                         label):
    """Phase 10c: the strains with -k 33 -n -f 1 (82 B/position x 16 Mbp
    over 1 GB): the streamed stage, and phase 9's monolithic GFF."""
    fresh_run(torch, metrics, kernels)
    wall = run_cli(cli, ["-k", "33", "-n", "-f", "1", "-o", out_dir, bench_fa])
    counts, stages, launched = streamed_counts(metrics, kernels)
    check("graph_scan" in stages, "-f 1 did not route the strains to the streamed stage")
    check(counts["graph_rounds"] == 4 and counts["graph_rounds_per_pass"] == 4,
          f"strains -k 33 -n -f 1: {counts}, not the G=4 of 4 shape K4 was timed at")
    all_launched(launched, "strains -k 33 -n -f 1")
    with open(os.path.join(out_dir, "blocks_coords.gff"), "rb") as f, \
            open(monolithic_gff, "rb") as g:
        check(f.read() == g.read(), "strains -k 33 -f 1: GFF differs from the monolithic run's")
    print(f"strains -k 33 -n -f 1: GFF byte-equal to the monolithic run's | CLI wall "
          f"{wall:.4f} s | {counts} | launches {launched} | "
          + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
    return launched


def streamed_full_size(torch, alphabet, construct, streamed, kernels, metrics, label):
    """Phase 10d: 2 x 512 Mbp at k=25 streamed (a budget of 8 rounds, 2 a
    pass) against the monolithic stage at the card's free memory; then
    2 x 1.1 Gbp at k=25, past 2^31 positions, at the card's free memory.
    Returns the launches of both streamed runs."""
    launches = {}
    seqs = synth_pair(alphabet, 8, PAIR_512M)
    n = 1 + sum(len(s) + 1 for s in seqs)
    torch.cuda.empty_cache()
    mem0 = fresh_run(torch, metrics, kernels)
    t0 = time.time()
    mono = construct.build_junctions(seqs, 25, "cuda")
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    _counts, stages, _launched = streamed_counts(metrics, kernels)
    check("graph_scan" not in stages,
          "2 x 512 Mbp did not run the monolithic stage at the card's free memory")
    print(f"2 x 512 Mbp k=25 monolithic: {secs:.2f} s | junctions "
          f"{sum(len(r.pos) for r in mono)} | peak {peak / (n - 2):.2f} B/position | "
          + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
    p8 = streamed.plan(n, 25, 1 << 22, 1.25, None, 8)
    budget = p8.fixed_bytes + p8.cap * (p8.epilogue_bytes + 2 * p8.row_bytes)
    for name, seqs_, budget_ in (("2 x 512 Mbp", seqs, budget), ("2 x 1.1 Gbp", None, None)):
        if seqs_ is None:
            del seqs, mono
            seqs_ = synth_pair(alphabet, 11, PAIR_1100M)
            n = 1 + sum(len(s) + 1 for s in seqs_)
            check(n > 1 << 31, f"{name}: {n} positions")
        torch.cuda.empty_cache()
        mem0 = fresh_run(torch, metrics, kernels)
        t0 = time.time()
        got = construct.build_junctions(seqs_, 25, "cuda", memory_budget_bytes=budget_)
        secs = time.time() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        counts, stages, launched = streamed_counts(metrics, kernels)
        check("graph_scan" in stages and counts["graph_round_retries"] == 0,
              f"{name}: {counts}")
        all_launched(launched, name)
        if budget_ is not None:
            check(counts["graph_passes"] == 4, f"{name}: {counts}")
            check(peak <= budget_, f"{name}: peak {peak} B over the budget {budget_}")
            for a, b in zip(mono, got):
                check(np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids),
                      f"{name}: streamed records differ from the monolithic ones")
            same = "records equal to the monolithic ones"
        else:
            # no monolithic run holds 2.2e9 positions: the records' own
            # invariants, and both copies of the ancestor with junctions
            per_chr = [len(r.pos) for r in got]
            ids = np.abs(np.concatenate([r.ids for r in got]))
            check(all(bool((np.diff(r.pos.astype(np.int64)) > 0).all()) for r in got)
                  and ids.min() == 1 and ids.max() == len(np.unique(ids)),
                  f"{name}: records out of order or ids not dense")
            check(min(per_chr) > 0.9 * max(per_chr), f"{name}: junctions per copy {per_chr}")
            del ids
            same = f"junctions per copy {per_chr}"
        print(f"{name} k=25 streamed{'' if budget_ is None else f', budget {budget_} B'}: "
              f"{same} in {secs:.2f} s | {counts} | peak {peak} B = {peak / n:.4f} B/position | "
              f"launches {launched} | " + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items())
              + f" {label}")
        launches[name] = launched
        del got
    return launches


def host_available_gb():
    """The host's available memory, GB (/proc/meminfo's MemAvailable)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 1e6
    raise RuntimeError("chip_smoke: no MemAvailable in /proc/meminfo")


def same_records(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x.pos, y.pos) and np.array_equal(x.ids, y.ids) for x, y in zip(a, b))


def streamed_past_2_32(torch, construct, kernels, metrics, seqs, label):
    """Phase 10e: examples/large's eight chromosomes, one of 2^32 N and the
    eight again (4.32e9 positions, the second copy wholly past 2^32) through
    construct.build_junctions, which routes them to the resident rounds.
    Doubling every occurrence keeps each class's extension sets and boundary
    bits, each class's first occurrence stays in the first copy (so the ids
    keep their ranks), and the N chromosome has no valid window: both
    copies' records must equal the monolithic records of examples/large
    alone, and the filler's must be empty.  Returns the launches."""
    name = "examples/large, 2^32 N, examples/large"
    mono = construct.build_junctions(seqs, 25, "cuda")
    big = [*seqs, np.full(FILLER_N, ord("N"), np.uint8), *seqs]
    n = 1 + sum(len(s) + 1 for s in big)
    second = 1 + sum(len(s) + 1 for s in big[: len(seqs) + 1])  # the second copy's start
    check(second > 1 << 32, f"{name}: the second copy starts at {second}")
    avail = host_available_gb()
    torch.cuda.empty_cache()
    mem0 = fresh_run(torch, metrics, kernels)
    t0 = time.time()
    got = construct.build_junctions(big, 25, "cuda")
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - mem0
    counts, stages, launched = streamed_counts(metrics, kernels)
    check("graph_scan" in stages and counts["graph_positions"] == n
          and counts["graph_round_retries"] == 0 and counts["graph_host_rounds"] == -1,
          f"{name}: {counts}")
    all_launched(launched, name)
    check(same_records(got[: len(seqs)], mono) and same_records(got[len(seqs) + 1 :], mono)
          and len(got[len(seqs)].pos) == 0,
          f"{name}: the copies' records differ from the monolithic examples/large records")
    print(f"{name} k=25: {n} positions (second copy from {second}), both copies' records "
          f"equal to the monolithic ones ({sum(len(r.pos) for r in mono)} junctions a copy), "
          f"the filler's empty, in {secs:.2f} s | host memory available before: {avail:.1f} GB "
          f"| {counts} | peak {peak} B = {peak / n:.4f} B/position | launches {launched} | "
          + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
    return launched


def streamed_outgrown_class(torch, construct, streamed, kernels, metrics, seqs, label):
    """Phase 10f: examples/large and a 24 Mbp (CATTC)n array as a ninth
    chromosome, k=25.  Each of the array's five classes holds ~4.8 M rows,
    more than a round's floor of min(chunk, n // 8) = 4,194,304, so the
    resident rounds from 8 overflow up to 512 and hand over to the
    host-bucketed rounds; then the host-bucketed rounds alone at 512 rounds
    (K4 not launched).  Both against the monolithic records of the same
    input.  Returns the launches of both."""
    unit = SATELLITE_UNIT
    seqs = [*seqs, np.frombuffer(unit * (SATELLITE_BP // len(unit)), np.uint8).copy()]
    mono = construct.build_junctions(seqs, 25, "cuda")
    grown = SATELLITE_ROUNDS * streamed.MAX_ROUND_GROWTH
    launches = {}
    for name, run in (
            ("class outgrowing every round", lambda: streamed.build_junctions_streamed_resident(
                seqs, 25, "cuda", n_rounds=SATELLITE_ROUNDS)),
            ("host-bucketed rounds", lambda: streamed.build_junctions_streamed(
                seqs, 25, "cuda", n_rounds=grown))):
        torch.cuda.empty_cache()
        mem0 = fresh_run(torch, metrics, kernels)
        t0 = time.time()
        got = run()
        secs = time.time() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        counts, stages, launched = streamed_counts(metrics, kernels)
        n = counts["graph_positions"]
        check(counts["graph_host_rounds"] == grown
              and launched["front_half"] > 0 and launched["class_analysis"] > 0,
              f"{name}: {counts}, launches {launched}")
        if name == "host-bucketed rounds":
            check(launched["round_append"] == 0 and "graph_scan" not in stages,
                  f"{name}: the resident rounds ran: launches {launched}")
        else:
            check(launched["round_append"] > 0 and counts["graph_round_retries"] == 6,
                  f"{name}: {counts}, launches {launched}")
        check(same_records(got, mono), f"{name}: records differ from the monolithic ones")
        print(f"examples/large + {SATELLITE_BP // 10**6} Mbp ({unit.decode()})n k=25, {name}: "
              f"records equal to the monolithic ones ({sum(len(r.pos) for r in got)} "
              f"junctions) in {secs:.2f} s | {counts} | peak {peak} B = {peak / n:.4f} "
              f"B/position | launches {launched} | "
              + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items()) + f" {label}")
        launches[name] = launched
    return launches


def streamed_phase(torch, dev, mods, tmp_dir, large_fa, large_golden, bench_fa, mono_k33_gff,
                   peak_ops, label):
    """Phase 10: returns K4's max abs error on the hand-laid chunks, its
    full-size results, and the launches of each streamed main path."""
    (cases, cli, pipeline, _device_poa, _msa, _poa_ref, kernels, _align_kernels, Config,
     alphabet, fasta, metrics) = mods
    from sibeliaz_tpu_torch.graph import construct, streamed

    phase(f"10 streamed graph stage {label}")
    large_recs = fasta.read_many(large_fa)
    ns = {"examples/large streamed k=25": joined_positions(large_recs),
          "examples/large streamed k=33": joined_positions(large_recs),
          "strains -k 33 -n -f 1": joined_positions(fasta.read_many([bench_fa])),
          "2 x 1.1 Gbp": 1 + 2 * (PAIR_1100M + 1)}
    k4_err = k4_hand_laid(torch, dev, kernels, cases)
    k4 = k4_full_size(torch, dev, alphabet, construct, streamed, kernels, peak_ops, ns)
    large = streamed_large(torch, large_recs, pipeline, Config, streamed, kernels, metrics,
                           {25: large_golden, 33: LARGE_K33_GFF_SHA}, label)
    strains = streamed_cli_strains(torch, cli, metrics, kernels, bench_fa, mono_k33_gff,
                                   os.path.join(tmp_dir, "strains_f1"), label)
    full = streamed_full_size(torch, alphabet, construct, streamed, kernels, metrics, label)
    large_seqs = [r.seq for r in large_recs]
    past = streamed_past_2_32(torch, construct, kernels, metrics, large_seqs, label)
    outgrown = streamed_outgrown_class(torch, construct, streamed, kernels, metrics, large_seqs,
                                       label)
    return k4_err, k4, {"examples/large streamed k=25": large[25],
                        "examples/large streamed k=33": large[33],
                        "strains -k 33 -n -f 1": strains,
                        "2 x 512 Mbp streamed": full["2 x 512 Mbp"],
                        "2 x 1.1 Gbp streamed": full["2 x 1.1 Gbp"],
                        "past 2^32 positions": past,
                        "class outgrowing every round": outgrown["class outgrowing every round"],
                        "host-bucketed rounds": outgrown["host-bucketed rounds"]}


def int32_peak():
    """The card's peak 32-bit integer rate, operations per second: 132 SMs x
    64 int32 lanes x the highest SM clock nvidia-smi reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    print(f"int32 peak: {SMS} SMs x {INT32_LANES_PER_SM} lanes x {mhz:.0f} MHz = "
          f"{SMS * INT32_LANES_PER_SM * mhz * 1e6 / 1e12:.4f} T operations/s; "
          f"device memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    return SMS * INT32_LANES_PER_SM * mhz * 1e6


K3_ARG_NAMES = ("seq0p", "seq_len", "node_char", "pred_idx", "pred_ok", "sink_mask", "off")
K3_OUT_NAMES = ("out_r", "out_i", "tcount", "best_sc")


def k3_replay(torch, dev, mods, directory, peak_ops, tmp_dir):
    """The development loop of K3 (--k3-replay DIR): hold the kernel against
    the plain version's outputs on the two main-path dispatches and time it,
    without the minutes of host Python and plain DP that produce them.  The
    first run records both dispatches and the plain outputs into DIR as
    .npz files; later runs load them.  Both, and the smaller seeded
    buckets, also run at every other launch shape (columns per thread, ring
    depth), which is how launch_config's choices were made."""
    (cases, cli, pipeline, device_poa, msa, poa_ref, kernels, align_kernels, Config,
     alphabet, fasta, metrics) = mods
    os.makedirs(directory, exist_ok=True)
    paths = {n: os.path.join(directory, n + ".npz") for n in ("examples", "large")}
    if not all(os.path.exists(q) for q in paths.values()):
        phase("recording the main path's K3 dispatches")
        _n, ex_args = golden_mafs(torch, cli, metrics, kernels, align_kernels,
                                  os.path.join(tmp_dir, "maf"))
        large_fa = regenerate_large(alphabet, fasta, tmp_dir)
        _n, large_args = large_alignment(
            torch, large_fa, fasta, pipeline, Config, msa, metrics, kernels,
            align_kernels, os.path.join(tmp_dir, "large_maf"), engines=("tpu",))
        for name, args in (("examples", ex_args), ("large", large_args)):
            want = align_kernels.poa_dp_tb_plain(*args)
            arrays = dict(zip(K3_ARG_NAMES, (*args[:6], args[9])))
            arrays.update(zip(K3_OUT_NAMES, want))
            np.savez_compressed(paths[name], dims=np.asarray(args[6:9]),
                                **{k: v.cpu().numpy() for k, v in arrays.items()})
            print(f"recorded {paths[name]}: {os.path.getsize(paths[name])} bytes")
    phase("K3 on the recorded main-path dispatches")
    for name, path in paths.items():
        z = np.load(path)
        t = {k: torch.from_numpy(z[k]).to(dev) for k in K3_ARG_NAMES + K3_OUT_NAMES}
        n_max, W, P = (int(x) for x in z["dims"])
        args = (*(t[k] for k in K3_ARG_NAMES[:6]), n_max, W, P, t["off"])
        want = [t[k] for k in K3_OUT_NAMES]
        k3_vs_plain(torch, align_kernels, args, f"recorded {name} dispatch", peak_ops,
                    want=want, reps=5)
        for depth in (1, 2, 4, 8, 16):
            print(f"  a ring of depth {depth} would serve "
                  f"{100 * ring_hit_share(torch, align_kernels, args, depth):.4f}%")
        k3_sweep(torch, align_kernels, args, want)
    phase("K3 on the seeded buckets")
    compare_poa(torch, dev, cases, device_poa, poa_ref, align_kernels, peak_ops,
                kinds=K3_BUCKETS[:6], sweep=True)


def main(argv):
    import torch

    replay_dir = time_kinds = None
    k2_time = argv == ["--k2-time"]
    k1_time = argv == ["--k1-time"]
    k4_time_args = argv[1:] if argv[:1] == ["--k4-time"] and len(argv) <= 2 else None
    if argv[:1] == ["--k3-replay"] and len(argv) == 2:
        replay_dir = argv[1]
    elif argv[:1] == ["--k3-time"] and len(argv) == 2:
        time_kinds = argv[1].split(",")
    elif argv and not (k2_time or k1_time or k4_time_args is not None):
        print("usage: python3 chip_smoke.py [--k3-replay DIR | --k3-time KIND[,KIND...] | "
              "--k2-time | --k1-time | --k4-time [OLDER_ROUND_APPEND.cu]]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_cases
    from sibeliaz_tpu_torch import cli, pipeline
    from sibeliaz_tpu_torch.align import device_poa, msa, poa_ref
    from sibeliaz_tpu_torch.align import kernels as align_kernels
    from sibeliaz_tpu_torch.config import Config
    from sibeliaz_tpu_torch.core import alphabet
    from sibeliaz_tpu_torch.graph import construct, kernels, oracle
    from sibeliaz_tpu_torch.io import fasta
    from sibeliaz_tpu_torch.lcb import engine
    from sibeliaz_tpu_torch.utils import cudabuild
    from sibeliaz_tpu_torch.utils.metrics import GLOBAL as metrics

    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory()

    phase("1 device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {name} | {smi}")
    label = f"({smi})"
    peak_ops = int32_peak()

    if time_kinds is not None:
        k3_time(torch, dev, torch_cases, device_poa, poa_ref, align_kernels, time_kinds)
        print(smi)
        return 0
    if k1_time:
        sets = k1_sets(torch, dev, alphabet, construct, fasta)
        k1_vs_plain(torch, kernels, sets, peak_ops)
        print(smi)
        return 0
    if k2_time:
        k2_vs_plain(torch, kernels, k2_row_sets(torch, dev, alphabet, construct, kernels, fasta),
                    peak_ops)
        print(smi)
        return 0
    if k4_time_args is not None:
        k4_time(torch, dev, alphabet, construct, kernels, cudabuild, peak_ops, tmp.name,
                k4_time_args[0] if k4_time_args else None)
        tmp.cleanup()
        print(smi)
        return 0

    phase("2 build")
    t0 = time.time()
    lib_path, ptxas = cudabuild.build()
    print(f"kernels built in {time.time() - t0:.1f} s: {os.path.relpath(lib_path, REPO)}")
    print_ptxas(ptxas)
    t0 = time.time()
    engine.ensure_built()
    print(f"native LCB engine built in {time.time() - t0:.1f} s")
    t0 = time.time()
    msa.ensure_built()
    print(f"native POA engine built in {time.time() - t0:.1f} s")

    mods = (torch_cases, cli, pipeline, device_poa, msa, poa_ref, kernels, align_kernels, Config,
            alphabet, fasta, metrics)
    if replay_dir is not None:
        k3_replay(torch, dev, mods, replay_dir, peak_ops, tmp.name)
        tmp.cleanup()
        print(smi)
        return 0
    phase(f"3 kernels vs plain versions, n = 2^24 {label}")
    k1 = compare_kernels(torch, dev, alphabet, construct, kernels, fasta, peak_ops)
    k2 = k2_vs_plain(torch, kernels, k2_row_sets(torch, dev, alphabet, construct, kernels,
                                                 fasta), peak_ops)

    phase(f"4 POA kernel vs its plain version {label}")
    k3_err = compare_poa(torch, dev, torch_cases, device_poa, poa_ref, align_kernels,
                         peak_ops)
    phase("5 small graphs vs the oracle")
    cases = 0
    for seed, n_prob in ((0, 0.0), (1, 0.02), (2, 0.0), (3, 0.01), (4, 0.0), (5, 0.05)):
        for k in (3, 9, 15, 25, 31, 33, 45, 61):
            seqs = random_genomes(alphabet, np.random.default_rng(seed), 3, 50, 400, n_prob)
            got = construct.build_junctions(seqs, k, dev)
            want = oracle.enumerate_junctions(seqs, k)
            for a, b in zip(got, want):
                check(np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids),
                      f"graph differs from the oracle: seed {seed}, k={k}")
            cases += 1
    rng = np.random.default_rng(7)
    base = random_genomes(alphabet, rng, 2, 500, 800)[0]
    related = [base, mutate(alphabet, rng, base, 0.01),
               alphabet.reverse_complement(mutate(alphabet, rng, base, 0.005))]
    rng = np.random.default_rng(11)
    unit = alphabet.decode(rng.integers(0, 4, size=40).astype(np.uint8))
    repeat = [np.concatenate([unit] * 6 + [alphabet.reverse_complement(unit)] * 2)]
    for seqs, k in ((related, 11), (repeat, 9)):
        for a, b in zip(construct.build_junctions(seqs, k, dev),
                        oracle.enumerate_junctions(seqs, k)):
            check(np.array_equal(a.pos, b.pos) and np.array_equal(a.ids, b.ids),
                  f"graph differs from the oracle at k={k}")
        cases += 1
    print(f"{cases} graphs equal to the oracle")

    phase(f"6 golden GFFs through the CLI, k=15, 25 and 33 {label}")
    ex_out = os.path.join(tmp.name, "examples")
    run_cli(cli, ["-k", "15", "-n", "-o", ex_out,
                  os.path.join(EXAMPLES, "genome1.fa"), os.path.join(EXAMPLES, "genome2.fa")])
    with open(os.path.join(ex_out, "blocks_coords.gff"), "rb") as f, open(
        os.path.join(EXAMPLES, "sibeliaz_out", "blocks_coords.gff"), "rb"
    ) as g:
        check(f.read() == g.read(), "examples/ GFF differs from the golden")
    print("examples/ k=15: GFF byte-equal to the golden (11 blocks)")

    large_fa = regenerate_large(alphabet, fasta, tmp.name)
    with open(os.path.join(EXAMPLES, "large", "sibeliaz_out", "blocks_coords.gff"), "rb") as g:
        large_golden = hashlib.sha256(g.read()).hexdigest()
    # k=25 against the committed golden; k=33 (two-limb keys through both
    # kernels and the two-pass sort) against the JAX package's GFF
    large_launches_by_k = {}
    for k, golden, whose, peak_limit in (
            (25, large_golden, "the committed golden's", PEAK_B_PER_POSITION),
            (33, LARGE_K33_GFF_SHA, "the JAX package's", PEAK_B_PER_POSITION_WIDE)):
        metrics.timings.clear()
        metrics.counters.clear()
        kernels.reset_launches()
        align_kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        out = os.path.join(tmp.name, f"large_k{k}")
        secs = run_cli(cli, ["-k", str(k), "-n", "-t", "4", "-o", out, *large_fa])
        counts = {**kernels.LAUNCHES, **align_kernels.LAUNCHES}
        peak = (torch.cuda.max_memory_allocated() - mem0) / metrics.counters["graph_positions"]
        with open(os.path.join(out, "blocks_coords.gff"), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        check(digest == golden, f"examples/large k={k} GFF SHA-256 {digest}, not {whose}")
        check(counts["front_half"] > 0 and counts["class_analysis"] > 0
              and counts["poa_dp_tb"] == 0 and counts["round_append"] == 0,
              f"launches of the -k {k} -n run: {counts}")
        check(round(peak, 1) <= peak_limit,
              f"peak {peak:.1f} B/position at k={k}, above {peak_limit}")
        stages = {t["stage"]: t["seconds"] for t in metrics.timings}
        print(f"examples/large k={k}: GFF SHA-256 equal to {whose} "
              f"({int(metrics.counters['blocks_found'])} blocks) in {secs:.2f} s | launches "
              f"{counts} | peak {peak:.1f} B/position (limit {peak_limit}) | "
              + " | ".join(f"{s} {v:.4f} s" for s, v in stages.items() if s.startswith("graph_"))
              + f" {label}")
        large_launches_by_k[k] = counts

    phase(f"7 golden MAFs through the CLI, both POA engines {label}")
    maf_launches, ex_args = golden_mafs(torch, cli, metrics, kernels, align_kernels,
                                        os.path.join(tmp.name, "maf"))
    k3_main = k3_vs_plain(torch, align_kernels, ex_args, "examples/ dispatch", peak_ops)

    phase(f"8 examples/large alignment: device engine vs native {label}")
    large_launches, large_args = large_alignment(
        torch, large_fa, fasta, pipeline, Config, msa, metrics, kernels, align_kernels,
        os.path.join(tmp.name, "large_maf"))
    k3_large = k3_vs_plain(torch, align_kernels, large_args,
                           "examples/large largest dispatch", peak_ops)
    del ex_args, large_args

    phase(f"9 timed pass: 16 x 1 Mbp strains, k=15 twice, then k=33 {label}")
    strains = bench_strains(alphabet, fasta)
    bench_fa = os.path.join(tmp.name, "strains.fa")
    fasta.write_fasta(bench_fa, strains)
    mbp = sum(len(r.seq) for r in strains) / 1e6
    for p, k in ((1, 15), (2, 15), (3, 33)):  # pass 3: two-limb keys, two sort passes
        metrics.timings.clear()
        metrics.counters.clear()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        wall = run_cli(cli, ["-k", str(k), "-n", "-o", os.path.join(tmp.name, f"bench{p}"),
                             bench_fa])
        peak = (torch.cuda.max_memory_allocated() - mem0) / metrics.counters["graph_positions"]
        st = {t["stage"]: t["seconds"] for t in metrics.timings}
        graph = sum(v for s, v in st.items() if s.startswith("graph_"))
        lcb = st["junction_table"] + st["lcb_engine"] + st["trim_and_render"]
        check(all(kernels.LAUNCHES[name] > 0 for name in MONOLITHIC_KERNELS),
              f"a kernel was not launched: {kernels.LAUNCHES}")
        print(f"pass {p}, k={k}: " + " | ".join(f"{s} {v:.4f} s" for s, v in st.items()))
        print(f"pass {p}, k={k}: graph {graph:.4f} s | lcb+out {lcb:.4f} s | graph+lcb "
              f"{graph + lcb:.4f} s | CLI wall {wall:.4f} s | {mbp / wall:.3f} input Mbp/s | "
              f"junctions {int(metrics.counters['graph_junctions'])} | "
              f"blocks {int(metrics.counters['blocks_found'])} | peak {peak:.1f} B/position | "
              f"launches {kernels.LAUNCHES} {label}")

    k4_err, k4, stream_paths = streamed_phase(
        torch, dev, mods, tmp.name, large_fa, large_golden, bench_fa,
        os.path.join(tmp.name, "bench3", "blocks_coords.gff"), peak_ops, label)
    tmp.cleanup()

    src = "sibeliaz_tpu_torch/csrc/"
    # launches per main path: the -n CLI runs (examples/large at k=25 and
    # k=33, phase 6), the default CLI run with the device POA engine on
    # examples/ (phase 7), and the same two stages on examples/large through
    # the library (phase 8)
    # and the streamed stage's (phase 10): examples/large through the
    # pipeline at k=25 and k=33, the strains' -k 33 -n -f 1 CLI run, the
    # two full-size inputs, the input past 2^32 positions, and the class
    # that outgrows every round (the hand-over, and the host-bucketed
    # rounds alone)
    paths = {"examples/large -n": large_launches_by_k[25],
             "examples/large -k 33 -n": large_launches_by_k[33],
             "examples/ --align-engine tpu": maf_launches,
             "examples/large --align-engine tpu": large_launches,
             **stream_paths}

    def by_path(kernel):
        return {path: counts.get(kernel, 0) for path, counts in paths.items()}

    def by_limbs(results):
        """The times of K1's or K2's one-limb instance (the k=25 path's) and
        its two-limb instance (the k=33 path's), on 2^24 random positions."""
        return {str(limbs): {"set": s, **{key: results[s][key] for key in
                                          ("ms", "plain_ms", "bound_ms", "bound_by")}}
                for limbs, s in ((1, "k=25 random"), (2, "k=33 random"))}

    k1_main, k2_main = k1["k=25 random"], k2["k=25 random"]
    # K4's "ms": the shape of the examples/large streamed passes (G=2 of 8)
    k4_shape = "1 limb(s) G=2 of 8"
    k4_main = k4[k4_shape]

    summary = {"kernels": [
        {"name": "front_half", "route": "cuda", "source": src + "front_half.cu",
         "replaces": "sibeliaz_tpu/graph/pallas_kernels.py:170",
         "launches": paths["examples/large -n"]["front_half"],
         "launches_by_path": by_path("front_half"),
         "max_abs_err": max(r["err"] for r in k1.values()),
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
         "by_limbs": by_limbs(k1), "library_ms": None},
        {"name": "class_analysis", "route": "cuda", "source": src + "class_analysis.cu",
         "replaces": "sibeliaz_tpu/graph/construct.py:450",
         "launches": paths["examples/large -n"]["class_analysis"],
         "launches_by_path": by_path("class_analysis"),
         "max_abs_err": max(r["err"] for r in k2.values()),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
         "by_limbs": by_limbs(k2), "library_ms": None},
        {"name": "poa_dp_tb", "route": "cuda", "source": src + "poa_dp_tb.cu",
         "replaces": "sibeliaz_tpu/align/tpu_poa.py:206",
         "launches": maf_launches["poa_dp_tb"],
         "launches_by_path": by_path("poa_dp_tb"),
         "max_abs_err": max(k3_err, k3_main["err"], k3_large["err"]),
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"],
         "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
         "library_ms": None},
        {"name": "round_append", "route": "cuda", "source": src + "round_append.cu",
         "replaces": "sibeliaz_tpu/graph/streamed.py:331",
         "launches": paths["examples/large streamed k=25"]["round_append"],
         "launches_by_path": by_path("round_append"),
         "max_abs_err": max(k4_err, *(r["err"] for r in k4.values())),
         "ms": k4_main["ms"], "plain_ms": k4_main["plain_ms"],
         "bound_ms": k4_main["bound_ms"], "bound_by": k4_main["bound_by"],
         "shape": k4_shape, "by_shape": k4, "library_ms": None},
    ]}
    print()
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
